// Masks shared by the contiguous flash-attention forward
// (flash_attention.cu) and its backward (flash_attention_bwd.cu): the
// reference's masks and its test for skipping a fully masked tile (the
// forward keeps the reference's 32-row tiles for it).
#pragma once

#include "common.cuh"

namespace fa {

constexpr int kT = 32;  // rows of the reference's query and key tiles

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

// Raise a kernel's dynamic shared-memory limit (needed past 48 KB), once.
template <typename K>
cudaError_t allow_smem(K kernel, int bytes) {
  return bytes <= 48 * 1024
             ? cudaSuccess
             : cudaFuncSetAttribute(
                   kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

}  // namespace fa
