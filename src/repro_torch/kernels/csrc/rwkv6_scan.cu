// WKV6 recurrence (RWKV-6 "Finch") with a carried (D, D) state.
//
// Replaces the Pallas TPU kernel repro/kernels/rwkv6_scan.py (rwkv6_scan,
// _wkv6_kernel), and with its state0 argument the continuation wrapper
// repro/kernels/ops.py rwkv6_apply: for each row b and head h, from
// S = state0[b, h] (zeros when absent),
//   o_t[e] = sum_d r_t[d] (S[d, e] + u[d] k_t[d] v_t[e])
//   S[d, e] <- exp(w_t[d]) S[d, e] + k_t[d] v_t[e]
// writing o in r's dtype and the final S in f32.
//
// What bounds it on the card: bytes for a decode step (the D x D f32 state
// is read and written once per (row, head), 32 KB at D = 64, against ~4 D^2
// operations), and for a prefill chunk the sequential dependency over S:
// ~6 D^2 operations a token per (row, head), which is far below either
// peak, but every token waits for the previous one.  The TPU kernel
// reformulated the recurrence in 32-token chunks (pairwise decay ratios in
// log space) so the MXU could run it as matrix products; this kernel runs
// the recurrence's own sequential definition, the form the reference's
// oracle uses.  One block of D threads owns one (row, head); thread e holds
// column e of the state in D registers, so the state never leaves the SM.
// Each token's r, k, exp(w) and u k are staged once in shared memory
// (double-buffered: one barrier a token) and read by every thread as
// broadcasts; the next token's inputs are fetched into registers while the
// current one is computed.  Left for later work: chunked (tensor-core)
// prefill and splitting a head's columns over several blocks when B * H is
// small.
#include "common.cuh"

namespace {

struct WkvArgs {
  const void* r;
  long long r_sb, r_sh, r_ss;
  const void* k;
  long long k_sb, k_sh, k_ss;
  const void* v;
  long long v_sb, v_sh, v_ss;
  const float* w;
  long long w_sb, w_sh, w_ss;
  const float* u;
  long long u_sb, u_sh;
  const float* s0;
  long long s0_sb, s0_sh, s0_sd;
  void* out;
  long long o_sb, o_sh, o_ss;
  float* s_out;
  int H, S;
};

template <typename T, int D>
__global__ void __launch_bounds__(D) wkv6_kernel(WkvArgs a) {
  const int h = blockIdx.x, b = blockIdx.y, e = threadIdx.x;
  __shared__ float r_s[2][D], k_s[2][D], w_s[2][D], uk_s[2][D];
  float s[D];
  if (a.s0 != nullptr) {
    const float* s0 = a.s0 + b * a.s0_sb + h * a.s0_sh + e;
#pragma unroll
    for (int d = 0; d < D; ++d) s[d] = s0[d * a.s0_sd];
  } else {
#pragma unroll
    for (int d = 0; d < D; ++d) s[d] = 0.f;
  }
  const T* rb = static_cast<const T*>(a.r) + b * a.r_sb + h * a.r_sh + e;
  const T* kb = static_cast<const T*>(a.k) + b * a.k_sb + h * a.k_sh + e;
  const T* vb = static_cast<const T*>(a.v) + b * a.v_sb + h * a.v_sh + e;
  const float* wb = a.w + b * a.w_sb + h * a.w_sh + e;
  T* ob = static_cast<T*>(a.out) + b * a.o_sb + h * a.o_sh + e;
  const float ue = a.u[b * a.u_sb + h * a.u_sh + e];

  float rn = rt::to_f(rb[0]), kn = rt::to_f(kb[0]), vn = rt::to_f(vb[0]),
        wn = wb[0];
  for (int t = 0; t < a.S; ++t) {
    const int buf = t & 1;
    const float vt = vn;
    r_s[buf][e] = rn;
    k_s[buf][e] = kn;
    w_s[buf][e] = expf(wn);
    uk_s[buf][e] = ue * kn;
    if (t + 1 < a.S) {  // the next token's inputs, in flight meanwhile
      const long long t1 = t + 1;
      rn = rt::to_f(rb[t1 * a.r_ss]);
      kn = rt::to_f(kb[t1 * a.k_ss]);
      vn = rt::to_f(vb[t1 * a.v_ss]);
      wn = wb[t1 * a.w_ss];
    }
    // every thread is past the previous token's reads of this buffer
    // (they came before its write to the other buffer and this barrier)
    __syncthreads();
    float o = 0.f, ruk = 0.f;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      const float rd = r_s[buf][d];
      o += rd * s[d];
      ruk += rd * uk_s[buf][d];
      s[d] = w_s[buf][d] * s[d] + k_s[buf][d] * vt;
    }
    ob[(long long)t * a.o_ss] = rt::from_f<T>(o + ruk * vt);
  }
  float* so = a.s_out + ((long long)b * a.H + h) * D * D + e;
#pragma unroll
  for (int d = 0; d < D; ++d) so[d * D] = s[d];
}

template <typename T>
void launch_d(int D, dim3 grid, cudaStream_t st, const WkvArgs& a) {
  switch (D) {
    case 32: wkv6_kernel<T, 32><<<grid, 32, 0, st>>>(a); break;
    case 64: wkv6_kernel<T, 64><<<grid, 64, 0, st>>>(a); break;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (r, k, v and out).  w_log, u, state0
// and the state out are float32.  Layouts: r/k/v/w_log/out (B, H, S, D),
// u (B, H, D) (broadcast strides may be 0), state0 (B, H, D, D) or null
// (zeros); strides in elements, the D stride of each is 1.  The state out
// is a contiguous (B, H, D, D) tensor.  Returns cudaGetLastError() after
// the launch (0 = launched).
extern "C" int rwkv6_scan_launch(
    int dtype, int D, int B, int H, int S, const void* r, long long r_sb,
    long long r_sh, long long r_ss, const void* k, long long k_sb,
    long long k_sh, long long k_ss, const void* v, long long v_sb,
    long long v_sh, long long v_ss, const void* w_log, long long w_sb,
    long long w_sh, long long w_ss, const void* u, long long u_sb,
    long long u_sh, const void* state0, long long s0_sb, long long s0_sh,
    long long s0_sd, void* out, long long o_sb, long long o_sh,
    long long o_ss, void* state_out, void* stream) {
  if ((D != 32 && D != 64) || B < 1 || H < 1 || S < 1 || B > 65535 ||
      H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  WkvArgs a{r,     r_sb,  r_sh,  r_ss, k,     k_sb,  k_sh,  k_ss,
            v,     v_sb,  v_sh,  v_ss, static_cast<const float*>(w_log),
            w_sb,  w_sh,  w_ss,  static_cast<const float*>(u),
            u_sb,  u_sh,  static_cast<const float*>(state0),
            s0_sb, s0_sh, s0_sd, out,  o_sb,  o_sh,  o_ss,
            static_cast<float*>(state_out), H, S};
  const dim3 grid(H, B);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    launch_d<float>(D, grid, st, a);
  else
    launch_d<__nv_bfloat16>(D, grid, st, a);
  return static_cast<int>(cudaGetLastError());
}
