// A bf16 tensor-core variant of the grouped expert GEMM
// (src/repro_torch/kernels/csrc/moe_gemm.cu), kept for
// tools/attention_sweep.py's moe section, which builds it in place of
// moe_gemm.cu in a copy of the kernel sources (build/sweep/) with the same
// C entry point.  bf16 only: f32 is refused.
//
// mma.sync.m16n8k16 bf16 with f32 accumulators, X as the 16-row operand by
// ldmatrix, W by ldmatrix.trans, W and X slices streamed through a
// kStages-deep cp.async.cg ring (kStages - 1 slices, 24 KB of W a block, in
// flight).  kFreshDepth sets the accumulation form: each kFreshDepth deep of
// products lands in a zeroed fragment that is added to the f32 sum with
// round-to-nearest, or (0) all go straight into the sum.  It is faster than
// the shipped kernel but moves the MoE serve's tokens past its check's
// margin in every form (PERF.md).  Like the shipped kernel, each
// output element is a sum over d in one fixed order whatever C.
#include "attn_mma.cuh"

namespace {

constexpr int kBF = 128;  // output columns per block

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

constexpr int kStages = 4;  // slices in the ring
constexpr int kDepth = 32;  // depth (d) of a slice
// moe_mma_kernel: depth of d whose products land in a zeroed fragment
// before it is added to the f32 sum with round-to-nearest (0: straight into
// the sum, where the tensor cores truncate)
constexpr int kFreshDepth = 16;
constexpr int kFreshSteps = kFreshDepth > 0 ? kFreshDepth / 16 : 1;
constexpr int kLdW = kBF + 8;     // padded W slice row (bf16): ldmatrix rows
constexpr int kLdX = kDepth + 8;  //   start in distinct 4-bank groups
static_assert(kDepth % 16 == 0 && kFreshDepth % 16 == 0 &&
                  kDepth / 16 % kFreshSteps == 0 && kFreshDepth <= kDepth,
              "16-deep k-steps");

// n valid bf16 (<= 0: none, >= 8: all) of the 16-byte chunk at src into
// dst, zero filled: by cp.async where the row is 16-byte aligned (vec), else
// element by element
__device__ __forceinline__ void chunk(__nv_bfloat16* dst,
                                      const __nv_bfloat16* src, int n,
                                      int vec) {
  n = max(0, min(8, n));
  if (vec) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     am::smem_u32(dst)),
                 "l"(src), "r"(2 * n)
                 : "memory");
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i)
      dst[i] = i < n ? src[i] : __float2bfloat16(0.f);
  }
}

// the ring's W slices, then its X slices (dynamic shared memory)
__host__ __device__ constexpr int ring_w_bytes() {
  return kStages * kDepth * kLdW * 2;
}
template <int BC>
__host__ __device__ constexpr int ring_bytes() {
  return ring_w_bytes() + kStages * BC * kLdX * 2;
}

// Slice kt (depth [kt kDepth, (kt + 1) kDepth)) of expert e's W at columns
// [f0, f0 + kBF) and X at rows [c0, c0 + BC) into ring stage kt % kStages,
// zero past d, f and C.
template <int BC>
__device__ __forceinline__ void issue_slice(__nv_bfloat16 (*ws)[kDepth][kLdW],
                                            __nv_bfloat16 (*xs)[BC][kLdX],
                                            const GemmArgs& a, int e, int f0,
                                            int c0, int kt) {
  constexpr int NT = 128;
  using bf16 = __nv_bfloat16;
  const int st = kt % kStages, d0 = kt * kDepth, vec = a.x_vec && a.w_vec;
  const bf16* xb = static_cast<const bf16*>(a.x) + e * a.x_se;
  const bf16* wb = static_cast<const bf16*>(a.w) + e * a.w_se;
  for (int idx = threadIdx.x; idx < kDepth * kBF / 8; idx += NT) {
    const int k = idx / (kBF / 8), c = idx % (kBF / 8) * 8;
    const int dk = d0 + k, fc = f0 + c;
    const bool ok = dk < a.d && fc < a.f;
    chunk(&ws[st][k][c], ok ? wb + dk * a.w_sd + fc : wb,
          ok ? a.f - fc : 0, vec);
  }
  for (int idx = threadIdx.x; idx < BC * kDepth / 8; idx += NT) {
    const int r = idx / (kDepth / 8), k = idx % (kDepth / 8) * 8;
    const int row = c0 + r, dk = d0 + k;
    const bool ok = row < a.C && dk < a.d;
    chunk(&xs[st][r][k], ok ? xb + row * a.x_sc + dk : xb,
          ok ? a.d - dk : 0, vec);
  }
}

template <int BC>
__global__ void __launch_bounds__(128) moe_mma_kernel(GemmArgs a) {
  constexpr int kM = BC / 16;  // 16-row tiles of the C tile
  const int f0 = blockIdx.x * kBF, c0 = blockIdx.y * BC, e = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  extern __shared__ __align__(16) unsigned char smem[];
  auto ws = reinterpret_cast<__nv_bfloat16(*)[kDepth][kLdW]>(smem);
  auto xs = reinterpret_cast<__nv_bfloat16(*)[BC][kLdX]>(smem + ring_w_bytes());

  float acc[kM][4][4];
#pragma unroll
  for (int m = 0; m < kM; ++m)
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[m][n][i] = 0.f;

  const int nk = (a.d + kDepth - 1) / kDepth;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) issue_slice<BC>(ws, xs, a, e, f0, c0, s);
    am::commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    am::wait<kStages - 2>();
    __syncthreads();  // slice kt landed; slice kt - 1's readers are done
    if (kt + kStages - 1 < nk)
      issue_slice<BC>(ws, xs, a, e, f0, c0, kt + kStages - 1);
    am::commit();
    const int st = kt % kStages;
    uint32_t b[kDepth / 16][2][4];  // the warp's 32 columns: n-tiles (0, 1),
#pragma unroll                      // (2, 3) of each 16-deep k-step
    for (int kk = 0; kk < kDepth / 16; ++kk)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        am::ldsm_x4_t(b[kk][h],
                  &ws[st][kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8]
                     [warp * 32 + h * 16 + (lane >> 4) * 8]);
#pragma unroll
    for (int m = 0; m < kM; ++m) {
      uint32_t x[kDepth / 16][4];
#pragma unroll
      for (int kk = 0; kk < kDepth / 16; ++kk)
        am::ldsm_x4(x[kk],
                &xs[st][m * 16 + (lane & 15)][kk * 16 + (lane >> 4) * 8]);
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        float t[4] = {0.f, 0.f, 0.f, 0.f};
        float(&p)[4] = kFreshDepth ? t : acc[m][n];
#pragma unroll
        for (int kk = 0; kk < kDepth / 16; ++kk) {
          am::mma(p, x[kk], b[kk][n >> 1][(n & 1) * 2],
              b[kk][n >> 1][(n & 1) * 2 + 1]);
          if (kFreshDepth && (kk + 1) % kFreshSteps == 0) {
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              acc[m][n][i] += t[i];
              t[i] = 0.f;
            }
          }
        }
      }
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");

  // lane (g, t) holds rows g, g + 8 of each 16-row tile at columns 2t, 2t + 1
  // of each of its 8-column tiles
  __nv_bfloat16* ob = static_cast<__nv_bfloat16*>(a.out) + e * a.o_se;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int m = 0; m < kM; ++m)
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = c0 + m * 16 + g + (i >> 1) * 8;
        const int col = f0 + warp * 32 + n * 8 + 2 * t + (i & 1);
        if (row < a.C && col < a.f)
          ob[row * a.o_sc + col] = __float2bfloat16(acc[m][n][i]);
      }
}

template <int BC>
cudaError_t launch_mma(const GemmArgs& a, int E, cudaStream_t st) {
  static const cudaError_t attr =
      ring_bytes<BC>() <= 48 * 1024
          ? cudaSuccess
          : cudaFuncSetAttribute(moe_mma_kernel<BC>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 ring_bytes<BC>());
  if (attr != cudaSuccess) return attr;
  const dim3 grid((a.f + kBF - 1) / kBF, (a.C + BC - 1) / BC, E);
  moe_mma_kernel<BC><<<grid, 128, ring_bytes<BC>(), st>>>(a);
  return cudaGetLastError();
}

cudaError_t launch_bf16(const GemmArgs& a, int E, cudaStream_t st) {
  if (a.C <= 16) return launch_mma<16>(a, E, st);
  if (a.C <= 32) return launch_mma<32>(a, E, st);
  if (a.C <= 48) return launch_mma<48>(a, E, st);
  return launch_mma<64>(a, E, st);
}

}  // namespace

extern "C" int moe_gemm_launch(int dtype, int E, int C, int d, int f,
                               const void* x, long long x_se, long long x_sc,
                               const void* w, long long w_se, long long w_sd,
                               void* out, long long o_se, long long o_sc,
                               int x_vec, int w_vec, void* stream) {
  if (dtype == 0 || E < 1 || E > 65535 || C < 1 || d < 1 || f < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const GemmArgs a{x, x_se, x_sc, w, w_se, w_sd, out, o_se, o_sc,
                   C, d, f, x_vec, w_vec};
  return static_cast<int>(launch_bf16(a, E, static_cast<cudaStream_t>(stream)));
}
