// Tiles shared by the contiguous flash-attention forward
// (flash_attention.cu) and its backward (flash_attention_bwd.cu): 32-row
// query and key tiles staged in f32 in shared memory, the reference's masks
// and its test for skipping a fully masked tile, and the register
// microtiles each thread computes on the CUDA cores.
#pragma once

#include "common.cuh"

namespace fa {

constexpr int kT = 32;  // rows of a query tile and of a key tile

// Per head_dim: threads a block, the padded row of a tile (+1: the rows a
// warp reads at one column fall in distinct banks), the score microtile
// (SR query rows x 4 key columns a thread) and the accumulator microtile
// (4 tile rows x CQ head_dim columns a thread).
template <int HD>
struct Cfg {
  static constexpr int NT = HD > 128 ? 256 : 128;
  static constexpr int LD = HD + 1;
  static constexpr int PLD = kT + 1;
  static constexpr int SR = kT * kT / (NT * 4);
  static constexpr int CG = NT / 8;  // column groups of the accumulator
  static constexpr int CQ = HD / CG;
  static_assert(SR >= 1 && CQ >= 1 && NT / CG * 4 == kT, "tile shape");
};

// A query at index i sees key j (positions pos_base + i and pos_base + j:
// the offset cancels) when causal allows it and it lies inside the window.
__device__ __forceinline__ bool pair_ok(int i, int j, int causal,
                                        int window) {
  return (!causal || j <= i) && (window <= 0 || j > i - window);
}

// The reference kernel's test (repro/kernels/flash_attention.py,
// _flash_kernel): a key tile of BK rows starting at k0 meets a query tile
// of BQ rows starting at q0 unless it lies wholly above the diagonal or
// wholly out of the window.  The forward takes it at its 32-row tiles, the
// backward at its own.
template <int BQ = kT, int BK = kT>
__device__ __forceinline__ bool tile_needed(int q0, int k0, int causal,
                                            int window) {
  bool run = true;
  if (causal) run = k0 <= q0 + BQ - 1;
  if (window > 0) run = run && (k0 + BK - 1 > q0 - window);
  return run;
}

// Rows [0, n) of a (kT, HD) tile from global memory (row stride ss,
// head_dim stride 1) into dst[kT][LD] as f32 times mul; rows n.. are zero.
// Consecutive threads read consecutive head_dim elements.
template <typename T, int HD>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          long long ss, int n, float mul) {
  using C = Cfg<HD>;
  for (int idx = threadIdx.x; idx < kT * HD; idx += C::NT) {
    const int r = idx / HD, d = idx % HD;
    dst[r * C::LD + d] =
        r < n ? rt::to_f(src[(long long)r * ss + d]) * mul : 0.f;
  }
}

// s[x][c] = sum_d a[i][d] b[j][d] for the thread's score microtile: rows
// i = (t / 8) * SR + x, columns j = t % 8 + 8 c.  With DP, also
// dp[x][c] = sum_d a2[i][d] b2[j][d] in the same pass.
template <int HD, bool DP>
__device__ __forceinline__ void score_tile(
    const float* a, const float* b, const float* a2, const float* b2,
    float (&s)[Cfg<HD>::SR][4], float (&dp)[Cfg<HD>::SR][4]) {
  using C = Cfg<HD>;
  const int r0 = (threadIdx.x / 8) * C::SR, c0 = threadIdx.x % 8;
#pragma unroll
  for (int x = 0; x < C::SR; ++x)
#pragma unroll
    for (int c = 0; c < 4; ++c) s[x][c] = dp[x][c] = 0.f;
#pragma unroll 4
  for (int d = 0; d < HD; ++d) {
    float av[C::SR], bv[4];
#pragma unroll
    for (int x = 0; x < C::SR; ++x) av[x] = a[(r0 + x) * C::LD + d];
#pragma unroll
    for (int c = 0; c < 4; ++c) bv[c] = b[(c0 + 8 * c) * C::LD + d];
#pragma unroll
    for (int x = 0; x < C::SR; ++x)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[x][c] += av[x] * bv[c];
    if (DP) {
#pragma unroll
      for (int x = 0; x < C::SR; ++x) av[x] = a2[(r0 + x) * C::LD + d];
#pragma unroll
      for (int c = 0; c < 4; ++c) bv[c] = b2[(c0 + 8 * c) * C::LD + d];
#pragma unroll
      for (int x = 0; x < C::SR; ++x)
#pragma unroll
        for (int c = 0; c < 4; ++c) dp[x][c] += av[x] * bv[c];
    }
  }
}

// The thread's score rows and columns (as score_tile computes them).
template <int HD>
__device__ __forceinline__ int score_row(int x) {
  return (threadIdx.x / 8) * Cfg<HD>::SR + x;
}
__device__ __forceinline__ int score_col(int c) {
  return threadIdx.x % 8 + 8 * c;
}

// The thread's accumulator rows (4 consecutive tile rows) and columns.
template <int HD>
__device__ __forceinline__ int acc_row(int s) {
  return (threadIdx.x / Cfg<HD>::CG) * 4 + s;
}
template <int HD>
__device__ __forceinline__ int acc_col(int u) {
  return threadIdx.x % Cfg<HD>::CG + Cfg<HD>::CG * u;
}

// Raise a kernel's dynamic shared-memory limit (needed past 48 KB), once.
template <typename K>
cudaError_t allow_smem(K kernel, int bytes) {
  return bytes <= 48 * 1024
             ? cudaSuccess
             : cudaFuncSetAttribute(
                   kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

}  // namespace fa
