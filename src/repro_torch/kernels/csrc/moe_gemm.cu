// Grouped expert GEMM of the MoE FFN: (E, C, d) @ (E, d, f) -> (E, C, f).
//
// Replaces the Pallas TPU kernel repro/kernels/moe_gemm.py (moe_gemm,
// _moe_gemm_kernel): for each expert e, out[e] = x[e] @ w[e], accumulated in
// f32 over d and written once in x's dtype (bf16 or f32).  The TPU kernel
// asserts that C, d and f divide its blocks; the serving path does not give
// divisible sizes (decode capacity is the row count, 1..16; a 512-token
// prefill bucket gets capacity 42), so this kernel masks every ragged edge.
//
// What bounds it on the card: at the serving path's shapes (E = 60 experts,
// d = 2048, f = 1408) every call reads all expert weights, 346 MB in bf16,
// which takes 0.103 ms at 3.35 TB/s, while its 2*E*C*d*f operations take
// 0.006 ms (C = 16) to 0.015 ms (C = 42) at the bf16 tensor-core rate: bytes
// bound it.  This kernel runs the products on the CUDA cores in f32
// (67 TFLOP/s), where C = 16 needs 0.08 ms and C = 42 0.22 ms of arithmetic,
// so the CUDA-core rate, not the bytes, bounds it at prefill.
//
// The sum's rounding is part of the served result.  Each output element is
// one f32 fused multiply-add chain over d in ascending order: at the
// 512-token prefill bucket (C 42) that is bit-equal to the plain version
// (torch's f32 GEMM on the card), and every output is bit-equal to the
// kernel this one replaced (tools/moe_gemm_fma.cu, which chip_smoke.py and
// the tests hold it to).  A bf16 tensor-core kernel (tools/moe_gemm_mma.cu)
// is faster, but its rounding moves qwen2-moe-a2.7b's near-tie router and
// its served tokens past the token check's margin (PERF.md), so it is not
// used.
//
// Design: one block per (expert, 128-column f tile, C tile).  The weights
// stream through a kStages-deep ring in shared memory as they are stored
// (bf16 or f32), kDepth deep a slice, by 16-byte cp.async copies issued
// kStages - 1 slices ahead, with the X slice beside them: one barrier a
// slice, and (kStages - 1) x 8 KB of bf16 weights in flight a block.  A
// warp owns R rows of the C tile and 32 CW columns of the f tile, a lane
// CW columns of all R rows, so each weight is read from shared memory and
// widened to f32 (a shift) by one lane of each row group, in registers, a
// step ahead of its products.  Each slice's X rows are widened once by
// each warp into its own transposed f32 copy, read back as broadcasts.
// The same pass marks the rows whose slice is all zeros: most rows of a
// decode call are (16 rows of capacity hold ~1 token an expert), and a
// warp with at most kSparseRows live rows in a slice, and fewer than half
// its R, runs only those, row by row (a row alone costs about a third of
// an 8-row step's instructions, so more live rows run faster together).
// Skipping
// a zero row skips fmaf(+-0, w, acc) == acc (any finite w; up to the sign
// of a zero sum), so the result is the same bits.  The C tile's rows come
// from C (launch_c) so a decode call computes no dead row groups; C past 64
// takes more C tiles.
//
// Measured (PERF.md): a single row streams at torch.bmm's time, and a
// decode call as served (about C/15 live rows an expert) runs 1.4x faster
// than the replaced kernel; with most rows live the f32 products, not the
// stream, bound it (the two overlap poorly).  There the replaced kernel's
// f32 weight tiles, 4 rows x 8 columns a thread, take fewer instructions a
// product, and win at C 9-15, so those C run them (moe_tile_kernel, the
// replaced kernel's code at its 16-row tile): the serve's decode calls
// have power-of-2 rows (C 1-16, few live), its prefill pieces of T tokens
// C = int(T 4/60 1.25) = 2, 5, 10, 21, 42 rows, most of them live.
// Weights by TMA bulk copies on mbarriers streamed slower than these
// cp.async copies, and deeper slices or more stages lost occupancy.
// A dense call at C 16 runs 1.1x slower than the replaced kernel; no
// serve makes one.
#include "common.cuh"

namespace {

constexpr int kBF = 128;        // output columns per block
constexpr int kStages = 4;      // slices in the ring
constexpr int kDepth = 32;      // depth (d) of a slice
constexpr int kSparseRows = 2;  // most live rows a warp runs one by one

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

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// n valid elements (<= 0: none) of the 16-byte chunk at src into dst, zero
// filled: by cp.async where the row is 16-byte aligned (vec), else element
// by element
template <typename T>
__device__ __forceinline__ void chunk(T* dst, const T* src, int n, int vec) {
  constexpr int N = 16 / static_cast<int>(sizeof(T));
  n = max(0, min(N, n));
  if (vec) {
    asm volatile(
        "cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
        "l"(src), "r"(n * static_cast<int>(sizeof(T)))
        : "memory");
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) dst[i] = i < n ? src[i] : rt::from_f<T>(0.f);
  }
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N committed groups of this thread are in flight
template <int N>
__device__ __forceinline__ void wait_ring() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The lane's CW (2 or 4) consecutive weights: as stored (wload), and
// widened to f32 (widen; a bf16 widens by a shift), so a loop can read a
// step ahead and widen at use
template <int CW>
struct WCols {
  float v[CW];
};
template <typename T, int CW>
struct WRaw {
  static constexpr int kWords = (CW * static_cast<int>(sizeof(T)) + 3) / 4;
  unsigned w[kWords];
};
template <typename T, int CW>
__device__ __forceinline__ WRaw<T, CW> wload(const T* p) {
  WRaw<T, CW> r;
  constexpr int kBytes = CW * static_cast<int>(sizeof(T));
  if constexpr (kBytes == 4) {
    r.w[0] = *reinterpret_cast<const unsigned*>(p);
  } else if constexpr (kBytes == 8) {
    const uint2 t = *reinterpret_cast<const uint2*>(p);
    r.w[0] = t.x;
    r.w[1] = t.y;
  } else {
    const uint4 t = *reinterpret_cast<const uint4*>(p);
    r.w[0] = t.x;
    r.w[1] = t.y;
    r.w[2] = t.z;
    r.w[3] = t.w;
  }
  return r;
}
template <typename T, int CW>
__device__ __forceinline__ WCols<CW> widen(const WRaw<T, CW>& r) {
  WCols<CW> c;
#pragma unroll
  for (int j = 0; j < CW; ++j) {
    if constexpr (sizeof(T) == 4)
      c.v[j] = __uint_as_float(r.w[j]);
    else
      c.v[j] = __uint_as_float(j % 2 == 0 ? r.w[j / 2] << 16
                                          : r.w[j / 2] & 0xffff0000u);
  }
  return c;
}

// Rows of a C tile's X slice a warp widens: R rounded up to quads, and the
// padded row of its transposed f32 copy (rows 8 lanes apart in distinct
// banks)
template <int R>
struct XCfg {
  static constexpr int R4 = (R + 3) / 4 * 4;
  static constexpr int Q = R4 / 4;
  static constexpr int XS = R4 + 4;
};

// warps across the f tile at CW columns a lane
template <int CW>
__host__ __device__ constexpr int col_warps() {
  return kBF / (32 * CW);
}

// The ring (W, then X slices) and the warps' f32 X copies
template <typename T, int R, int G, int CW>
__host__ __device__ constexpr int ring_bytes() {
  return kStages * (kDepth * kBF + G * R * kDepth) *
             static_cast<int>(sizeof(T)) +
         col_warps<CW>() * G * kDepth * XCfg<R>::XS *
             static_cast<int>(sizeof(float));
}

// Slice kt (depth [kt kDepth, (kt + 1) kDepth)) of expert e's W at columns
// [f0, f0 + kBF) and of X at rows [c0, c0 + G R) into ring stage
// kt % kStages, zero past d, f and C.
template <typename T, int R, int G, int NT>
__device__ __forceinline__ void issue(T* ws, T* xs, const GemmArgs& a,
                                      const T* wb, const T* xb, int f0,
                                      int c0, int kt) {
  constexpr int N = 16 / static_cast<int>(sizeof(T));
  const int st = kt % kStages, d0 = kt * kDepth;
  T* wsl = ws + st * kDepth * kBF;
  T* xsl = xs + st * G * R * kDepth;
  for (int idx = threadIdx.x; idx < kDepth * kBF / N; idx += NT) {
    const int k = idx / (kBF / N), c = idx % (kBF / N) * N;
    const int dk = d0 + k, fc = f0 + c;
    const bool ok = dk < a.d && fc < a.f;
    chunk(wsl + k * kBF + c, ok ? wb + dk * a.w_sd + fc : wb,
          ok ? a.f - fc : 0, a.w_vec);
  }
  for (int idx = threadIdx.x; idx < G * R * kDepth / N; idx += NT) {
    const int r = idx / (kDepth / N), k = idx % (kDepth / N) * N;
    const int row = c0 + r, dk = d0 + k;
    const bool ok = row < a.C && dk < a.d;
    chunk(xsl + r * kDepth + k, ok ? xb + row * a.x_sc + dk : xb,
          ok ? a.d - dk : 0, a.x_vec);
  }
}

// Block (f tile, C tile, expert) of CWS G warps (CWS = 128 / (32 CW)):
// warp CWS g + h owns rows [g R, (g + 1) R) of the C tile and columns
// [32 CW h, 32 CW (h + 1)) of the f tile, lane l CW of them from 32 CW h +
// CW l.
template <typename T, int R, int G, int CW>
__global__ void __launch_bounds__(32 * col_warps<CW>() * G)
    moe_ring_kernel(GemmArgs a) {
  using X = XCfg<R>;
  constexpr int Q = X::Q, XS = X::XS, CWS = col_warps<CW>(), NT = 32 * CWS * G;
  // live rows of a slice run one by one: at most kSparseRows, below R / 2
  constexpr int kLive = (R - 1) / 2 < kSparseRows ? (R - 1) / 2 : kSparseRows;
  const int f0 = blockIdx.x * kBF, c0 = blockIdx.y * G * R, e = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int grp = warp / CWS;
  const int col = warp % CWS * 32 * CW + CW * lane;
  extern __shared__ __align__(16) unsigned char smem[];
  T* ws = reinterpret_cast<T*>(smem);  // [kStages][kDepth][kBF]
  T* xs = ws + kStages * kDepth * kBF;  // [kStages][G R][kDepth]
  float* xt = reinterpret_cast<float*>(xs + kStages * G * R * kDepth) +
              warp * kDepth * XS;  // the warp's [kDepth][XS] f32 copy
  const T* wb = static_cast<const T*>(a.w) + e * a.w_se;
  const T* xb = static_cast<const T*>(a.x) + e * a.x_se;

  float acc[R][CW];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int j = 0; j < CW; ++j) acc[r][j] = 0.f;

  const int nk = (a.d + kDepth - 1) / kDepth;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) issue<T, R, G, NT>(ws, xs, a, wb, xb, f0, c0, s);
    commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    wait_ring<kStages - 2>();
    __syncthreads();  // slice kt landed; slice kt - 1's readers are done
    if (kt + kStages - 1 < nk)
      issue<T, R, G, NT>(ws, xs, a, wb, xb, f0, c0, kt + kStages - 1);
    commit();
    const int st = kt % kStages;
    const T* wsl = ws + st * kDepth * kBF + col;
    const T* xsl = xs + (st * G + grp) * R * kDepth;

    // the warp's rows of the X slice, widened and transposed, and the
    // rows with a nonzero element
    unsigned live = 0;
    for (int i = lane; i < kDepth * Q; i += 32) {
      const int k = i % kDepth, q = i / kDepth;
      float v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = 4 * q + j;
        v[j] = r < R ? rt::to_f(xsl[r * kDepth + k]) : 0.f;
        live |= static_cast<unsigned>(v[j] != 0.f) << r;
      }
      *reinterpret_cast<float4*>(xt + k * XS + 4 * q) =
          make_float4(v[0], v[1], v[2], v[3]);
    }
    live = __reduce_or_sync(0xffffffffu, live);
    __syncwarp();

    if (__popc(live) <= kLive) {
      // few live rows: each alone, the zero rows skipped
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (!(live >> r & 1u)) continue;
#pragma unroll 8
        for (int k = 0; k < kDepth; ++k) {
          const float xr = xt[k * XS + r];
          const WCols<CW> wv = widen(wload<T, CW>(wsl + k * kBF));
#pragma unroll
          for (int j = 0; j < CW; ++j)
            acc[r][j] = fmaf(xr, wv.v[j], acc[r][j]);
        }
      }
    } else {
      // every row, the next step's x and weights read while this step's
      // products run (the weights widened only at use)
      float xv[2][4 * Q];
      WRaw<T, CW> wr[2];
      auto read = [&](int k, int buf) {
#pragma unroll
        for (int q = 0; q < Q; ++q) {
          const float4 t =
              *reinterpret_cast<const float4*>(xt + k * XS + 4 * q);
          xv[buf][4 * q] = t.x;
          xv[buf][4 * q + 1] = t.y;
          xv[buf][4 * q + 2] = t.z;
          xv[buf][4 * q + 3] = t.w;
        }
        wr[buf] = wload<T, CW>(wsl + k * kBF);
      };
      read(0, 0);
#pragma unroll
      for (int k = 0; k < kDepth; ++k) {
        if (k + 1 < kDepth) read(k + 1, (k + 1) & 1);
        const WCols<CW> wv = widen(wr[k & 1]);
#pragma unroll
        for (int r = 0; r < R; ++r)
#pragma unroll
          for (int j = 0; j < CW; ++j)
            acc[r][j] = fmaf(xv[k & 1][r], wv.v[j], acc[r][j]);
      }
    }
  }
  wait_ring<0>();

  T* ob = static_cast<T*>(a.out) + e * a.o_se;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int row = c0 + grp * R + r;
    if (row >= a.C) continue;
#pragma unroll
    for (int j = 0; j < CW; ++j) {
      const int cc = f0 + col + j;
      if (cc < a.f) ob[row * a.o_sc + cc] = rt::from_f<T>(acc[r][j]);
    }
  }
}

template <typename T, int R, int G, int CW>
cudaError_t launch(const GemmArgs& a, int E, cudaStream_t st) {
  constexpr int bytes = ring_bytes<T, R, G, CW>();
  // the ring's size, and shared memory for as many blocks an SM as fit
  static rt::PerDevice smem_set;
  const cudaError_t attr = smem_set.get([&] {
    const cudaError_t e = cudaFuncSetAttribute(
        moe_ring_kernel<T, R, G, CW>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    return e != cudaSuccess ? e
                            : cudaFuncSetAttribute(
                                  moe_ring_kernel<T, R, G, CW>,
                                  cudaFuncAttributePreferredSharedMemoryCarveout,
                                  cudaSharedmemCarveoutMaxShared);
  });
  if (attr != cudaSuccess) return attr;
  const dim3 grid((a.f + kBF - 1) / kBF, (a.C + G * R - 1) / (G * R), E);
  moe_ring_kernel<T, R, G, CW>
      <<<grid, 32 * col_warps<CW>() * G, bytes, st>>>(a);
  return cudaGetLastError();
}

// The replaced kernel's 16-row tile (tools/moe_gemm_fma.cu at BC 16): 64
// threads, each 4 rows x 8 columns, 16-deep slices staged in shared memory
// as f32 and fetched into registers a slice ahead.  Each output is the
// same ascending fmaf chain as the ring's.
constexpr int kTD = 16;  // depth (d) per staged slice
constexpr int kTR = 4;   // output rows per thread
constexpr int kTX = 16;  // threads across the 128 columns (2 x 4 each)
constexpr int kTC = 16;  // rows of the tile
constexpr int kTT = kTX * kTC / kTR;  // threads

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

template <typename T>
__global__ void __launch_bounds__(kTT) moe_tile_kernel(GemmArgs a) {
  constexpr int N = 16 / static_cast<int>(sizeof(T));  // elements a chunk
  constexpr int kWChunks = kTD * kBF / N;
  constexpr int kNW = kWChunks / kTT;       // W chunks a thread
  constexpr int kXChunks = kTC * kTD / N;  // <= kTT
  static_assert(kWChunks % kTT == 0 && kXChunks <= kTT, "tiling");

  const int f0 = blockIdx.x * kBF, e = blockIdx.z;
  const int tid = threadIdx.x, tx = tid % kTX, ty = tid / kTX;
  const T* xb = static_cast<const T*>(a.x) + e * a.x_se;
  const T* wb = static_cast<const T*>(a.w) + e * a.w_se;

  __shared__ __align__(16) float xs[kTD][kTC + 4];  // transposed X slice
  __shared__ __align__(16) float ws[kTD][kBF];

  uint4 wr[kNW];
  uint4 xr = make_uint4(0u, 0u, 0u, 0u);

  auto fetch = [&](int d0) {
#pragma unroll
    for (int i = 0; i < kNW; ++i) {
      const int j = tid + i * kTT;
      const int k = j / (kBF / N), c = (j % (kBF / N)) * N;
      const int dk = d0 + k, fc = f0 + c;
      wr[i] = load_chunk(wb + dk * a.w_sd + fc, dk < a.d ? a.f - fc : 0,
                         a.w_vec);
    }
    if (tid < kXChunks) {
      const int r = tid / (kTD / N), k = (tid % (kTD / N)) * N;
      const int dk = d0 + k;
      xr = load_chunk(xb + r * a.x_sc + dk, r < a.C ? a.d - dk : 0,
                      a.x_vec);
    }
  };
  auto stage = [&]() {
#pragma unroll
    for (int i = 0; i < kNW; ++i) {
      const int j = tid + i * kTT;
      const int k = j / (kBF / N), c = (j % (kBF / N)) * N;
      const T* v = reinterpret_cast<const T*>(&wr[i]);
#pragma unroll
      for (int t = 0; t < N; t += 4)
        *reinterpret_cast<float4*>(&ws[k][c + t]) =
            make_float4(rt::to_f(v[t]), rt::to_f(v[t + 1]),
                        rt::to_f(v[t + 2]), rt::to_f(v[t + 3]));
    }
    if (tid < kXChunks) {
      const int r = tid / (kTD / N), k = (tid % (kTD / N)) * N;
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
  for (int d0 = 0; d0 < a.d; d0 += kTD) {
    const bool more = d0 + kTD < a.d;
    if (more) fetch(d0 + kTD);  // in flight while this slice multiplies
#pragma unroll
    for (int k = 0; k < kTD; ++k) {
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
    const int row = ty * kTR + r;
    if (row >= a.C) continue;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int col = f0 + (c < 4 ? tx * 4 + c : kBF / 2 + tx * 4 + c - 4);
      if (col < a.f) ob[row * a.o_sc + col] = rt::from_f<T>(acc[r][c]);
    }
  }
}

template <typename T>
cudaError_t launch_tile(const GemmArgs& a, int E, cudaStream_t st) {
  moe_tile_kernel<T><<<dim3((a.f + kBF - 1) / kBF, 1, E), kTT, 0, st>>>(a);
  return cudaGetLastError();
}

// The kernel and layout from C (the forms measured fastest at the serve's
// occupancy, PERF.md): the ring with R rows a warp in G groups at CW
// columns a lane; up to 8 rows, one group of the fewest rows (a power of
// two) that holds C; C 9-15 (a prefill piece, most rows live) the
// replaced kernel's 16-row tile; C 16 (a decode pool, few rows live) and
// past it, groups of 8 rows, up to 64 rows a C tile, at four columns a
// lane for C 17-24.
template <typename T>
cudaError_t launch_c(const GemmArgs& a, int E, cudaStream_t st) {
  if (a.C <= 1) return launch<T, 1, 1, 2>(a, E, st);
  if (a.C <= 2) return launch<T, 2, 1, 2>(a, E, st);
  if (a.C <= 4) return launch<T, 4, 1, 2>(a, E, st);
  if (a.C <= 8) return launch<T, 8, 1, 2>(a, E, st);
  if (a.C < 16) return launch_tile<T>(a, E, st);
  if (a.C == 16) return launch<T, 8, 2, 2>(a, E, st);
  if (a.C <= 24) return launch<T, 8, 3, 4>(a, E, st);
  if (a.C <= 32) return launch<T, 8, 4, 2>(a, E, st);
  if (a.C <= 48) return launch<T, 8, 6, 2>(a, E, st);
  return launch<T, 8, 8, 2>(a, E, st);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, w and out).  Strides in elements;
// the last axis of each has stride 1.  x_vec / w_vec: 1 when every row of
// x / w starts on a 16-byte boundary.  Returns cudaGetLastError() after the
// launch, or the error of raising the kernel's shared-memory limit (0 =
// launched).
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
  const cudaError_t err = dtype == 0 ? launch_c<float>(a, E, st)
                                     : launch_c<__nv_bfloat16>(a, E, st);
  return static_cast<int>(err);
}
