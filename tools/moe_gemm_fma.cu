// The grouped expert GEMM as it was before its ring redesign (the kernel
// of src/repro_torch/kernels/csrc/moe_gemm.cu up to its 16-deep register
// staging), kept as the yardstick of the shipped kernel's rounding:
// chip_smoke.py and tests/test_torch_cuda.py build it beside the shipped
// kernel (kernels/build.py load_variant, with csrc/ on the include path) and
// hold the shipped kernel's outputs bitwise equal to its outputs, and
// tools/attention_sweep.py times it as a variant.  Nothing on the main path
// uses it.  Same C entry point as moe_gemm.cu.
//
// (E, C, d) @ (E, d, f) -> (E, C, f): for each expert e, out[e] = x[e] @
// w[e], accumulated in f32 over d and written once in x's dtype (bf16 or
// f32), every ragged edge masked.  One block per (expert, 128-column f
// tile, C tile of 16, 32 or 64 rows, chosen from C so a decode call
// computes no dead rows).  A loop over d stages a 16-deep X slice and W
// slice through shared memory (as f32), read from device memory with
// 16-byte loads where the row is aligned and whole, element by element
// with zero fill at a ragged edge; the next slice is fetched into registers
// while the current one is multiplied.  Each thread keeps a 4 x 8 tile of
// f32 accumulators in registers and writes it once.  Every output element
// is one thread's fused multiply-add chain over d in ascending order, so
// the result does not depend on C or on the tiling.
#include "common.cuh"

namespace {

constexpr int kBF = 128;  // output columns per block
constexpr int kBD = 16;   // depth (d) per staged slice
constexpr int kTR = 4;    // output rows per thread
constexpr int kTX = 16;   // threads across the 128 columns (2 x 4 each)

struct GemmArgs {
  const void* x;  // (E, C, d), d stride 1
  long long x_se, x_sc;
  const void* w;  // (E, d, f), f stride 1
  long long w_se, w_sd;
  void* out;  // (E, C, f), f stride 1
  long long o_se, o_sc;
  int C, d, f;
  int x_vec, w_vec;  // 1: rows start on 16-byte boundaries
};

// n valid elements (<= 0: none) of one 16-byte chunk at p, zero filled.
template <typename T>
__device__ __forceinline__ uint4 load_chunk(const T* p, int n, int vec) {
  constexpr int N = 16 / sizeof(T);
  uint4 v = make_uint4(0u, 0u, 0u, 0u);
  if (vec && n >= N) {
    v = __ldg(reinterpret_cast<const uint4*>(p));
  } else {
    T* e = reinterpret_cast<T*>(&v);
#pragma unroll
    for (int i = 0; i < N; ++i)
      if (i < n) e[i] = p[i];
  }
  return v;
}

template <typename T, int BC>
__global__ void __launch_bounds__(kTX * BC / kTR) moe_gemm_kernel(GemmArgs a) {
  constexpr int kThreads = kTX * BC / kTR;
  constexpr int N = 16 / static_cast<int>(sizeof(T));  // elements a chunk
  constexpr int kWChunks = kBD * kBF / N;
  constexpr int kNW = kWChunks / kThreads;  // W chunks a thread
  constexpr int kXChunks = BC * kBD / N;    // <= kThreads
  static_assert(kWChunks % kThreads == 0 && kXChunks <= kThreads, "tiling");

  const int f0 = blockIdx.x * kBF, c0 = blockIdx.y * BC, e = blockIdx.z;
  const int tid = threadIdx.x, tx = tid % kTX, ty = tid / kTX;
  const T* xb = static_cast<const T*>(a.x) + e * a.x_se;
  const T* wb = static_cast<const T*>(a.w) + e * a.w_se;

  __shared__ __align__(16) float xs[kBD][BC + 4];  // transposed X slice
  __shared__ __align__(16) float ws[kBD][kBF];

  uint4 wr[kNW];
  uint4 xr = make_uint4(0u, 0u, 0u, 0u);

  auto fetch = [&](int d0) {
#pragma unroll
    for (int i = 0; i < kNW; ++i) {
      const int j = tid + i * kThreads;
      const int k = j / (kBF / N), c = (j % (kBF / N)) * N;
      const int dk = d0 + k, fc = f0 + c;
      wr[i] = load_chunk(wb + dk * a.w_sd + fc, dk < a.d ? a.f - fc : 0,
                         a.w_vec);
    }
    if (tid < kXChunks) {
      const int r = tid / (kBD / N), k = (tid % (kBD / N)) * N;
      const int row = c0 + r, dk = d0 + k;
      xr = load_chunk(xb + row * a.x_sc + dk, row < a.C ? a.d - dk : 0,
                      a.x_vec);
    }
  };
  auto stage = [&]() {
#pragma unroll
    for (int i = 0; i < kNW; ++i) {
      const int j = tid + i * kThreads;
      const int k = j / (kBF / N), c = (j % (kBF / N)) * N;
      const T* v = reinterpret_cast<const T*>(&wr[i]);
#pragma unroll
      for (int t = 0; t < N; t += 4)
        *reinterpret_cast<float4*>(&ws[k][c + t]) =
            make_float4(rt::to_f(v[t]), rt::to_f(v[t + 1]),
                        rt::to_f(v[t + 2]), rt::to_f(v[t + 3]));
    }
    if (tid < kXChunks) {
      const int r = tid / (kBD / N), k = (tid % (kBD / N)) * N;
      const T* v = reinterpret_cast<const T*>(&xr);
#pragma unroll
      for (int t = 0; t < N; ++t) xs[k + t][r] = rt::to_f(v[t]);
    }
  };

  float acc[kTR][8];
#pragma unroll
  for (int r = 0; r < kTR; ++r)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[r][c] = 0.f;

  fetch(0);
  stage();
  __syncthreads();
  for (int d0 = 0; d0 < a.d; d0 += kBD) {
    const bool more = d0 + kBD < a.d;
    if (more) fetch(d0 + kBD);  // in flight while this slice multiplies
#pragma unroll
    for (int k = 0; k < kBD; ++k) {
      const float4 xv = *reinterpret_cast<const float4*>(&xs[k][ty * kTR]);
      const float4 w0 = *reinterpret_cast<const float4*>(&ws[k][tx * 4]);
      const float4 w1 =
          *reinterpret_cast<const float4*>(&ws[k][kBF / 2 + tx * 4]);
      const float xv_[kTR] = {xv.x, xv.y, xv.z, xv.w};
      const float wv[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
      for (int r = 0; r < kTR; ++r)
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[r][c] = fmaf(xv_[r], wv[c], acc[r][c]);
    }
    __syncthreads();
    if (more) {
      stage();
      __syncthreads();
    }
  }

  T* ob = static_cast<T*>(a.out) + e * a.o_se;
#pragma unroll
  for (int r = 0; r < kTR; ++r) {
    const int row = c0 + ty * kTR + r;
    if (row >= a.C) continue;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int col = f0 + (c < 4 ? tx * 4 + c : kBF / 2 + tx * 4 + c - 4);
      if (col < a.f) ob[row * a.o_sc + col] = rt::from_f<T>(acc[r][c]);
    }
  }
}

template <typename T>
void launch_bc(const GemmArgs& a, int E, cudaStream_t st) {
  const unsigned fx = (a.f + kBF - 1) / kBF;
  if (a.C <= 16) {
    moe_gemm_kernel<T, 16><<<dim3(fx, 1, E), kTX * 16 / kTR, 0, st>>>(a);
  } else if (a.C <= 32) {
    moe_gemm_kernel<T, 32><<<dim3(fx, 1, E), kTX * 32 / kTR, 0, st>>>(a);
  } else {
    moe_gemm_kernel<T, 64>
        <<<dim3(fx, (a.C + 63) / 64, E), kTX * 64 / kTR, 0, st>>>(a);
  }
}

}  // namespace

extern "C" int moe_gemm_launch(int dtype, int E, int C, int d, int f,
                               const void* x, long long x_se, long long x_sc,
                               const void* w, long long w_se, long long w_sd,
                               void* out, long long o_se, long long o_sc,
                               int x_vec, int w_vec, void* stream) {
  if (E < 1 || E > 65535 || C < 1 || d < 1 || f < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const GemmArgs a{x, x_se, x_sc, w, w_se, w_sd, out, o_se, o_sc,
                   C, d, f, x_vec, w_vec};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) launch_bc<float>(a, E, st);
  else launch_bc<__nv_bfloat16>(a, E, st);
  return static_cast<int>(cudaGetLastError());
}
