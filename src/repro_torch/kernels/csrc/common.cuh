// Shared helpers of the attention kernels: element conversions and warp
// reductions.  Plain C interface kernels, built by kernels/build.py with
// nvcc for sm_90a and loaded through ctypes.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

namespace rt {

// A launch-time setting that binds to the calling thread's current device
// (cudaFuncSetAttribute): run once for each device a kernel is launched on,
// at its first launch there, and its result kept.  A launch path holds one
// as a function-local static.  Once per process would leave a second GPU
// (a stage-decoupled prefill lane) without the attribute, and a launch past
// 48 KB of shared memory there refused.
class PerDevice {
 public:
  template <typename F>
  cudaError_t get(F set) {
    int dev = 0;
    const cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return e;
    if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
    std::call_once(once_[dev], [&] { result_[dev] = set(); });
    return result_[dev];
  }

 private:
  static constexpr int kMaxDevices = 64;
  std::once_flag once_[kMaxDevices];
  cudaError_t result_[kMaxDevices] = {};
};

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
