// Shared helpers of the attention kernels: element conversions and warp
// reductions.  Plain C interface kernels, built by kernels/build.py with
// nvcc for sm_90a and loaded through ctypes.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace rt {

// Masked scores are -1e30, not -inf, as in the reference kernels: a row
// with no valid slot then averages V (finite) instead of producing NaN.
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f(int8_t x) {
  return static_cast<float>(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// Slot validity shared by both kernels: an empty slot (-1), a slot past the
// query's position and, with a window (> 0), a slot that fell out of it are
// masked.
__device__ __forceinline__ bool slot_ok(int sp, int cur, int window) {
  return sp >= 0 && sp <= cur && (window <= 0 || sp > cur - window);
}

}  // namespace rt
