// Contiguous causal / windowed GQA flash attention, backward (FA2 form).
//
// The gradient of flash_attention.cu's function.  The Pallas TPU kernel it
// follows (repro/kernels/flash_attention.py, flash_attention) has no VJP:
// the JAX trainer differentiates its jnp attention with XLA.  Here the
// kernel is on the training path, so its backward is a kernel too.  From
// q, K, V, out, the forward's f32 row log-sum-exp (lse) and d_out, with
// delta_i = sum_d d_out_id out_id (the wrapper's one reduction):
//   P = exp(scale q K^T - lse) on valid pairs (the forward's masks), 0 off,
//   dV = P^T d_out,   dS = P o (d_out V^T - delta),
//   dK = scale dS^T q (summed over the G query heads of a kv head),
//   dQ = scale dS K.
// Two kernels, neither with atomics, so a run is bit-equal to the next:
//   dK/dV: one block per (32-key tile, kv head, row) loops over the G query
//     heads of the group and, for each, the 32-query tiles that meet the
//     key tile (the forward's skipping test), accumulating dK and dV in
//     registers;
//   dQ:    one block per (32-query tile, query head, row) loops over the key
//     tiles that meet it, accumulating dQ in registers.
// Both recompute S and dP = d_out V^T in one pass over head_dim.
//
// What bounds it on the card: 10 hd operations a valid pair and head (S,
// dP, dV, dK, dQ), 32.2 GFLOP at the training shape against ~0.1 GB of f32
// tensors: operations.  This first version runs them in f32 on the CUDA
// cores; each block's dK/dV or dQ stays in registers and its tiles in
// shared memory.  Left for later work: tensor-core tiles, TMA pipelining.
#include "flash_common.cuh"

namespace {

using fa::Cfg;
using fa::kT;

struct BwdArgs {
  const void* q;
  long long q_sb, q_sh, q_ss;
  const void* k;
  long long k_sb, k_sh, k_ss;
  const void* v;
  long long v_sb, v_sh, v_ss;
  const void* dout;
  long long do_sb, do_sh, do_ss;
  const float* lse;    // (B, Hq, Sq) contiguous
  const float* delta;  // (B, Hq, Sq) contiguous
  void* dq;
  long long dq_sb, dq_sh, dq_ss;
  void* dk;
  long long dk_sb, dk_sh, dk_ss;
  void* dv;
  long long dv_sb, dv_sh, dv_ss;
  int Hq, Sq, Skv, G, causal, window;
  float scale;
};

// four (kT, LD) tiles, two (kT, PLD) score tiles, lse and delta rows
template <int HD>
constexpr int bwd_smem_floats() {
  return 4 * kT * Cfg<HD>::LD + 2 * kT * Cfg<HD>::PLD + 2 * kT;
}

// P and dS of one (query tile, key tile) pair into p_s / ds_s (either may
// be null), from the tiles in shared memory: q_s pre-scaled, do_s, k_s,
// v_s, and the query rows' lse and delta.
template <int HD>
__device__ __forceinline__ void probs_and_dscores(
    const float* q_s, const float* do_s, const float* k_s, const float* v_s,
    const float* lse_s, const float* dl_s, float* p_s, float* ds_s, int q0,
    int nq, int k0, int nk, int causal, int window) {
  using C = Cfg<HD>;
  float sc[C::SR][4], dp[C::SR][4];
  fa::score_tile<HD, true>(q_s, k_s, do_s, v_s, sc, dp);
#pragma unroll
  for (int x = 0; x < C::SR; ++x) {
    const int i = fa::score_row<HD>(x);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int j = fa::score_col(c);
      const bool ok = i < nq && j < nk &&
                      fa::pair_ok(q0 + i, k0 + j, causal, window);
      const float p = ok ? expf(sc[x][c] - lse_s[i]) : 0.f;
      if (p_s != nullptr) p_s[i * C::PLD + j] = p;
      ds_s[i * C::PLD + j] = p * (dp[x][c] - dl_s[i]);
    }
  }
}

template <typename T, int HD>
__device__ __forceinline__ void load_rows(float* lse_s, float* dl_s,
                                          const BwdArgs& a, int b, int h,
                                          int q0, int nq) {
  const int t = threadIdx.x;
  if (t < kT) {
    const long long row = ((long long)b * a.Hq + h) * a.Sq + q0 + t;
    lse_s[t] = t < nq ? a.lse[row] : 0.f;
    dl_s[t] = t < nq ? a.delta[row] : 0.f;
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(Cfg<HD>::NT) flash_dkdv_kernel(BwdArgs a) {
  using C = Cfg<HD>;
  const int k0 = blockIdx.x * kT, hk = blockIdx.y, b = blockIdx.z;
  const int nk = min(kT, a.Skv - k0);
  extern __shared__ __align__(16) float smem[];
  float* k_s = smem;
  float* v_s = k_s + kT * C::LD;
  float* q_s = v_s + kT * C::LD;
  float* do_s = q_s + kT * C::LD;
  float* p_s = do_s + kT * C::LD;
  float* ds_s = p_s + kT * C::PLD;
  float* lse_s = ds_s + kT * C::PLD;
  float* dl_s = lse_s + kT;

  fa::load_tile<T, HD>(k_s, static_cast<const T*>(a.k) + b * a.k_sb
                       + hk * a.k_sh + (long long)k0 * a.k_ss, a.k_ss, nk,
                       1.f);
  fa::load_tile<T, HD>(v_s, static_cast<const T*>(a.v) + b * a.v_sb
                       + hk * a.v_sh + (long long)k0 * a.v_ss, a.v_ss, nk,
                       1.f);
  float dk[4][C::CQ], dv[4][C::CQ];
#pragma unroll
  for (int s = 0; s < 4; ++s)
#pragma unroll
    for (int u = 0; u < C::CQ; ++u) dk[s][u] = dv[s][u] = 0.f;

  for (int g = 0; g < a.G; ++g) {
    const int h = hk * a.G + g;
    const T* qb = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
    const T* ob = static_cast<const T*>(a.dout) + b * a.do_sb + h * a.do_sh;
    for (int q0 = 0; q0 < a.Sq; q0 += kT) {
      if (!fa::tile_needed(q0, k0, a.causal, a.window)) continue;
      const int nq = min(kT, a.Sq - q0);
      __syncthreads();  // the previous query tile's readers are done
      fa::load_tile<T, HD>(q_s, qb + (long long)q0 * a.q_ss, a.q_ss, nq,
                           a.scale);
      fa::load_tile<T, HD>(do_s, ob + (long long)q0 * a.do_ss, a.do_ss, nq,
                           1.f);
      load_rows<T, HD>(lse_s, dl_s, a, b, h, q0, nq);
      __syncthreads();
      probs_and_dscores<HD>(q_s, do_s, k_s, v_s, lse_s, dl_s, p_s, ds_s, q0,
                            nq, k0, nk, a.causal, a.window);
      __syncthreads();
      // dV[j] += sum_i P[i][j] dO[i];  dK[j] += sum_i dS[i][j] (scale q[i])
      for (int i = 0; i < nq; ++i) {
        float pv[4], dsv[4];
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          pv[s] = p_s[i * C::PLD + fa::acc_row<HD>(s)];
          dsv[s] = ds_s[i * C::PLD + fa::acc_row<HD>(s)];
        }
#pragma unroll
        for (int u = 0; u < C::CQ; ++u) {
          const float o = do_s[i * C::LD + fa::acc_col<HD>(u)];
          const float qq = q_s[i * C::LD + fa::acc_col<HD>(u)];
#pragma unroll
          for (int s = 0; s < 4; ++s) {
            dv[s][u] += pv[s] * o;
            dk[s][u] += dsv[s] * qq;
          }
        }
      }
    }
  }
  T* dkb = static_cast<T*>(a.dk) + b * a.dk_sb + hk * a.dk_sh;
  T* dvb = static_cast<T*>(a.dv) + b * a.dv_sb + hk * a.dv_sh;
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    const int j = fa::acc_row<HD>(s);
    if (j >= nk) continue;
#pragma unroll
    for (int u = 0; u < C::CQ; ++u) {
      const int c = fa::acc_col<HD>(u);
      dkb[(long long)(k0 + j) * a.dk_ss + c] = rt::from_f<T>(dk[s][u]);
      dvb[(long long)(k0 + j) * a.dv_ss + c] = rt::from_f<T>(dv[s][u]);
    }
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(Cfg<HD>::NT) flash_dq_kernel(BwdArgs a) {
  using C = Cfg<HD>;
  const int q0 = blockIdx.x * kT, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / a.G;
  const int nq = min(kT, a.Sq - q0);
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;
  float* do_s = q_s + kT * C::LD;
  float* k_s = do_s + kT * C::LD;
  float* v_s = k_s + kT * C::LD;
  float* ds_s = v_s + kT * C::LD;
  float* lse_s = ds_s + 2 * kT * C::PLD;  // the layout of the dK/dV kernel
  float* dl_s = lse_s + kT;

  fa::load_tile<T, HD>(q_s, static_cast<const T*>(a.q) + b * a.q_sb
                       + h * a.q_sh + (long long)q0 * a.q_ss, a.q_ss, nq,
                       a.scale);
  fa::load_tile<T, HD>(do_s, static_cast<const T*>(a.dout) + b * a.do_sb
                       + h * a.do_sh + (long long)q0 * a.do_ss, a.do_ss, nq,
                       1.f);
  load_rows<T, HD>(lse_s, dl_s, a, b, h, q0, nq);
  const T* kb = static_cast<const T*>(a.k) + b * a.k_sb + hk * a.k_sh;
  const T* vb = static_cast<const T*>(a.v) + b * a.v_sb + hk * a.v_sh;
  float dq[4][C::CQ];
#pragma unroll
  for (int s = 0; s < 4; ++s)
#pragma unroll
    for (int u = 0; u < C::CQ; ++u) dq[s][u] = 0.f;

  for (int k0 = 0; k0 < a.Skv; k0 += kT) {
    if (!fa::tile_needed(q0, k0, a.causal, a.window)) continue;
    const int nk = min(kT, a.Skv - k0);
    __syncthreads();  // the previous key tile's readers are done
    fa::load_tile<T, HD>(k_s, kb + (long long)k0 * a.k_ss, a.k_ss, nk, 1.f);
    fa::load_tile<T, HD>(v_s, vb + (long long)k0 * a.v_ss, a.v_ss, nk, 1.f);
    __syncthreads();
    probs_and_dscores<HD>(q_s, do_s, k_s, v_s, lse_s, dl_s, nullptr, ds_s,
                          q0, nq, k0, nk, a.causal, a.window);
    __syncthreads();
    // dQ[i] += sum_j dS[i][j] K[j]   (scaled at the end)
    for (int j = 0; j < nk; ++j) {
      float dsv[4];
#pragma unroll
      for (int s = 0; s < 4; ++s)
        dsv[s] = ds_s[fa::acc_row<HD>(s) * C::PLD + j];
#pragma unroll
      for (int u = 0; u < C::CQ; ++u) {
        const float kk = k_s[j * C::LD + fa::acc_col<HD>(u)];
#pragma unroll
        for (int s = 0; s < 4; ++s) dq[s][u] += dsv[s] * kk;
      }
    }
  }
  T* dqb = static_cast<T*>(a.dq) + b * a.dq_sb + h * a.dq_sh;
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    const int i = fa::acc_row<HD>(s);
    if (i >= nq) continue;
#pragma unroll
    for (int u = 0; u < C::CQ; ++u)
      dqb[(long long)(q0 + i) * a.dq_ss + fa::acc_col<HD>(u)] =
          rt::from_f<T>(dq[s][u] * a.scale);
  }
}

template <typename T, int HD>
cudaError_t launch(int B, int Hkv, cudaStream_t st, const BwdArgs& a) {
  constexpr int kSmem = bwd_smem_floats<HD>() * sizeof(float);
  static const cudaError_t attr1 =
      fa::allow_smem(flash_dkdv_kernel<T, HD>, kSmem);
  static const cudaError_t attr2 =
      fa::allow_smem(flash_dq_kernel<T, HD>, kSmem);
  if (attr1 != cudaSuccess) return attr1;
  if (attr2 != cudaSuccess) return attr2;
  const dim3 g_kv((a.Skv + kT - 1) / kT, Hkv, B);
  flash_dkdv_kernel<T, HD><<<g_kv, Cfg<HD>::NT, kSmem, st>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 g_q((a.Sq + kT - 1) / kT, a.Hq, B);
  flash_dq_kernel<T, HD><<<g_q, Cfg<HD>::NT, kSmem, st>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_hd(int hd, int B, int Hkv, cudaStream_t st,
                      const BwdArgs& a) {
  switch (hd) {
    case 32: return launch<T, 32>(B, Hkv, st, a);
    case 64: return launch<T, 64>(B, Hkv, st, a);
    case 128: return launch<T, 128>(B, Hkv, st, a);
    default: return launch<T, 256>(B, Hkv, st, a);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, K, V, d_out and the gradients).
// Layouts as the forward's: q/d_out/dq (B, Hq, Sq, hd); K/V/dK/dV (B, Hkv,
// Skv, hd), Hq = G Hkv; strides in elements, the head_dim stride 1; lse and
// delta (B, Hq, Sq) f32 contiguous.  window <= 0 means none.  Launches the
// dK/dV kernel, then the dQ kernel.  Returns cudaGetLastError() after the
// launches, or the error of raising a kernel's shared-memory limit (0 =
// launched).
extern "C" int flash_attention_bwd_launch(
    int dtype, int hd, int B, int Hq, int Sq, int Skv, int G, int causal,
    int window, float scale, const void* q, long long q_sb, long long q_sh,
    long long q_ss, const void* k, long long k_sb, long long k_sh,
    long long k_ss, const void* v, long long v_sb, long long v_sh,
    long long v_ss, const void* dout, long long do_sb, long long do_sh,
    long long do_ss, const void* lse, const void* delta, void* dq,
    long long dq_sb, long long dq_sh, long long dq_ss, void* dk,
    long long dk_sb, long long dk_sh, long long dk_ss, void* dv,
    long long dv_sb, long long dv_sh, long long dv_ss, void* stream) {
  if ((hd != 32 && hd != 64 && hd != 128 && hd != 256) || G < 1 || B < 1 ||
      Hq < 1 || Hq % G != 0 || Sq < 1 || Skv < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  BwdArgs a{q,     q_sb,  q_sh,  q_ss,  k,     k_sb,  k_sh,  k_ss,
            v,     v_sb,  v_sh,  v_ss,  dout,  do_sb, do_sh, do_ss,
            static_cast<const float*>(lse), static_cast<const float*>(delta),
            dq,    dq_sb, dq_sh, dq_ss, dk,    dk_sb, dk_sh, dk_ss,
            dv,    dv_sb, dv_sh, dv_ss, Hq,    Sq,    Skv,   G,
            causal, window, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      dtype == 0 ? launch_hd<float>(hd, B, Hq / G, st, a)
                 : launch_hd<__nv_bfloat16>(hd, B, Hq / G, st, a);
  return static_cast<int>(err);
}
