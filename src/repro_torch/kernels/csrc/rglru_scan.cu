// RG-LRU linear recurrence (Griffin / RecurrentGemma).
//
// Replaces the Pallas TPU kernel repro/kernels/rglru_scan.py (rglru_scan,
// _rglru_kernel): for each row b and channel w,
//   a_t = exp(a_log_t),  h_t = a_t h_{t-1} + sqrt(1 - a_t^2) (gate_t x_t),
// from h_{-1} = h0[b, w] (f32), writing h_t in x's dtype and h_S-1 in f32.
//
// What bounds it on the card: bytes.  Each element is read once (x and
// gate in bf16 or f32, a_log in f32) and h written once, against ~10
// operations, so the recurrence is a stream far below the ridge.  The TPU
// kernel tiled W by 512 lanes and walked S in 128-step chunks to keep a
// chunk resident in VMEM; that has no meaning here.  One thread owns one
// (row, channel) and keeps h in a register for the whole sequence.
// Neighbouring threads own neighbouring channels, so every load and store
// of a step is coalesced across W.  The loads do not depend on h, so each
// thread fetches kAhead steps into registers before it runs them: the
// sequential dependency is one FMA chain, not a chain of memory latencies.
// Grid: ceil(W / 256) x B blocks of 256 threads.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kAhead = 8;  // steps fetched ahead into registers

struct RglruArgs {
  const void* x;
  long long x_sb, x_ss;
  const float* a;
  long long a_sb, a_ss;
  const void* g;
  long long g_sb, g_ss;
  const float* h0;
  long long h0_sb;
  void* out;
  float* hf;
  int B, S, W;
};

template <typename T>
__global__ void __launch_bounds__(kThreads) rglru_kernel(RglruArgs p) {
  const int w = blockIdx.x * kThreads + threadIdx.x, b = blockIdx.y;
  if (w >= p.W) return;
  const T* __restrict__ xb = static_cast<const T*>(p.x) + b * p.x_sb + w;
  const T* __restrict__ gb = static_cast<const T*>(p.g) + b * p.g_sb + w;
  const float* __restrict__ ab = p.a + b * p.a_sb + w;
  T* __restrict__ ob =
      static_cast<T*>(p.out) + ((long long)b * p.S) * p.W + w;
  float h = p.h0[b * p.h0_sb + w];
  for (int t0 = 0; t0 < p.S; t0 += kAhead) {
    float xs[kAhead], as[kAhead], gs[kAhead];
#pragma unroll
    for (int i = 0; i < kAhead; ++i) {
      const long long t = t0 + i;
      if (t < p.S) {
        xs[i] = rt::to_f(xb[t * p.x_ss]);
        gs[i] = rt::to_f(gb[t * p.g_ss]);
        as[i] = ab[t * p.a_ss];
      }
    }
#pragma unroll
    for (int i = 0; i < kAhead; ++i) {
      const long long t = t0 + i;
      if (t < p.S) {
        const float a = expf(as[i]);
        const float beta = sqrtf(fmaxf(1.f - a * a, 0.f));
        h = a * h + beta * (gs[i] * xs[i]);
        ob[t * p.W] = rt::from_f<T>(h);
      }
    }
  }
  p.hf[(long long)b * p.W + w] = h;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, gate and out).  a_log and h0 are
// float32.  Strides are in elements; the W stride of every input is 1.  out
// is a contiguous (B, S, W) tensor, h_final a contiguous (B, W) float32
// tensor.  Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int rglru_scan_launch(int dtype, int B, int S, int W,
                                 const void* x, long long x_sb,
                                 long long x_ss, const void* a_log,
                                 long long a_sb, long long a_ss,
                                 const void* gate, long long g_sb,
                                 long long g_ss, const void* h0,
                                 long long h0_sb, void* out, void* h_final,
                                 void* stream) {
  if (B < 1 || S < 1 || W < 1 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  RglruArgs p{x,    x_sb, x_ss, static_cast<const float*>(a_log),
              a_sb, a_ss, gate, g_sb,
              g_ss, static_cast<const float*>(h0), h0_sb, out,
              static_cast<float*>(h_final), B, S, W};
  const dim3 grid((W + kThreads - 1) / kThreads, B);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    rglru_kernel<float><<<grid, kThreads, 0, st>>>(p);
  else
    rglru_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}
