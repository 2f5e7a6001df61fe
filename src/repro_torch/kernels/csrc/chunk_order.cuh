// Chunk-order bookkeeping of the chunked scans (rwkv6_scan.cu,
// rglru_scan.cu): a launch whose blocks each own one chunk of the sequence
// (and one tile of the other axes), publish what their chunk contributes to
// the carried state, and fold the earlier chunks' contributions in chunk
// order.
//
// A block takes its tile from a device counter (take_tile), so the tiles of
// chunk c are taken only after every tile of the chunks before it: a block
// only ever waits for blocks that started before it, and are running or
// done, whatever the hardware's block order.  No deadlock.  The counter is
// never reset: the tiles of earlier launches on the stream are tile_base.
// Each (tile of the other axes, chunk) has a flag, set to the launch's epoch
// once its contribution is in the scratch (publish); a later chunk's block
// waits until the flags of every earlier chunk hold the epoch (wait_for).
// Epochs grow by one a launch, so no flag needs clearing between launches.
// The wrapper keeps the counter, the tiles taken and the flags
// (kernels/ops.py _ChunkSync), one set per kernel, device and stream: two
// launches in flight on two streams never share a counter or a flag.
#pragma once

#include <cuda_runtime.h>

namespace chunk_order {

// The block's tile: the counter's value less the tiles of earlier launches.
// Every thread of the block calls it; it ends with the threads in step.
__device__ __forceinline__ int take_tile(unsigned long long* tiles,
                                         long long tile_base) {
  __shared__ int tile_s;
  if (threadIdx.x == 0)
    tile_s = static_cast<int>(atomicAdd(tiles, 1ull) - tile_base);
  __syncthreads();
  return tile_s;
}

// After the block's threads have written their contribution (with __stcg,
// to L2): make it visible, then set the chunk's flag to epoch.
__device__ __forceinline__ void publish(int* flag, int epoch) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) atomicExch(flag, epoch);
}

// Wait until flags[0, n) all hold epoch (one thread a flag), then read the
// contributions behind them with __ldcg.  Ends with the threads in step.
__device__ __forceinline__ void wait_for(const int* flags, int n, int epoch) {
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    const volatile int* f = flags + j;
    while (*f != epoch) {
    }
  }
  __threadfence();
  __syncthreads();
}

}  // namespace chunk_order
