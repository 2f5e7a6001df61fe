// Contiguous causal / windowed GQA flash attention, forward.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py
// (flash_attention, _flash_kernel): for each row b, query head h and query
// i of q (B, Hq, Sq, hd) against K/V (B, Hkv, Skv, hd),
//   out = softmax_j(q_i . k_j / sqrt(hd) masked) @ V   over kv head h // G,
// where key j is valid when j <= i (causal) and j > i - window (a window).
// Query and key positions both start at the reference's pos_base, so the
// offset cancels in the masks.  It also writes, when asked, the f32 row
// log-sum-exp of the scaled scores, which the backward
// (flash_attention_bwd.cu) recomputes the probabilities from.
//
// What bounds it on the card: at the training shape (B 2, 24/8 heads of
// 128, S 1024, causal) the valid pairs need 12.9 GFLOP against 67 MB of
// f32 q/k/v/out, far above the ridge, so operations bound it.  This first
// version computes them in f32 on the CUDA cores: one block per (32-query
// tile, query head, row) walks the 32-key tiles, staging each in shared
// memory, skips the tiles the reference's test finds fully masked (so a
// causal row reads about half of K/V, a windowed one only its window), and
// carries the online-softmax state (m, l, acc) in shared memory and
// registers.  Each thread register-blocks an SR x 4 score microtile and a
// 4 x CQ output microtile, so one value read from shared memory feeds
// several FMAs.  Left for later work: tensor-core tiles (wgmma), TMA
// pipelining and sharing a K/V tile among the G query heads of a group.
#include "flash_common.cuh"

namespace {

using fa::Cfg;
using fa::kT;

struct FwdArgs {
  const void* q;
  long long q_sb, q_sh, q_ss;
  const void* k;
  long long k_sb, k_sh, k_ss;
  const void* v;
  long long v_sb, v_sh, v_ss;
  void* out;
  long long o_sb, o_sh, o_ss;
  float* lse;  // (B, Hq, Sq) contiguous, or null
  int Hq, Sq, Skv, G, causal, window;
  float scale;
};

template <int HD>
constexpr int fwd_smem_floats() {
  return 3 * kT * Cfg<HD>::LD + kT * Cfg<HD>::PLD + 3 * kT;
}

template <typename T, int HD>
__global__ void __launch_bounds__(Cfg<HD>::NT) flash_fwd_kernel(FwdArgs a) {
  using C = Cfg<HD>;
  constexpr int kWarps = C::NT / 32;
  const int q0 = blockIdx.x * kT, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / a.G;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nq = min(kT, a.Sq - q0);

  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;                 // [kT][LD], pre-scaled
  float* k_s = q_s + kT * C::LD;     // [kT][LD]
  float* v_s = k_s + kT * C::LD;     // [kT][LD]
  float* p_s = v_s + kT * C::LD;     // [kT][PLD] scores, then probabilities
  float* m_s = p_s + kT * C::PLD;    // running max
  float* l_s = m_s + kT;             // running sum
  float* c_s = l_s + kT;             // this tile's correction

  const T* qb = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh
      + (long long)q0 * a.q_ss;
  const T* kb = static_cast<const T*>(a.k) + b * a.k_sb + hk * a.k_sh;
  const T* vb = static_cast<const T*>(a.v) + b * a.v_sb + hk * a.v_sh;
  fa::load_tile<T, HD>(q_s, qb, a.q_ss, nq, a.scale);
  if (tid < kT) {
    m_s[tid] = rt::kNegInf;
    l_s[tid] = 0.f;
  }
  float acc[4][C::CQ];
#pragma unroll
  for (int s = 0; s < 4; ++s)
#pragma unroll
    for (int u = 0; u < C::CQ; ++u) acc[s][u] = 0.f;

  for (int k0 = 0; k0 < a.Skv; k0 += kT) {
    if (!fa::tile_needed(q0, k0, a.causal, a.window)) continue;
    const int nk = min(kT, a.Skv - k0);
    __syncthreads();  // the previous tile's readers are done
    fa::load_tile<T, HD>(k_s, kb + (long long)k0 * a.k_ss, a.k_ss, nk, 1.f);
    fa::load_tile<T, HD>(v_s, vb + (long long)k0 * a.v_ss, a.v_ss, nk, 1.f);
    __syncthreads();
    float sc[C::SR][4], unused[C::SR][4];
    fa::score_tile<HD, false>(q_s, k_s, nullptr, nullptr, sc, unused);
#pragma unroll
    for (int x = 0; x < C::SR; ++x) {
      const int i = fa::score_row<HD>(x);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int j = fa::score_col(c);
        // out of range: no weight at all; masked: the reference's -1e30
        float s = -INFINITY;
        if (i < nq && j < nk)
          s = fa::pair_ok(q0 + i, k0 + j, a.causal, a.window) ? sc[x][c]
                                                              : rt::kNegInf;
        p_s[i * C::PLD + j] = s;
      }
    }
    __syncthreads();
    // online softmax, one warp per query row, one key a lane (kT == 32)
    for (int r = warp; r < kT; r += kWarps) {
      const float s = p_s[r * C::PLD + lane];
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, rt::warp_max(s));
      const float p = expf(s - m_new);
      p_s[r * C::PLD + lane] = p;
      const float sum = rt::warp_sum(p);
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        c_s[r] = corr;
        l_s[r] = l_s[r] * corr + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const float corr = c_s[fa::acc_row<HD>(s)];
#pragma unroll
      for (int u = 0; u < C::CQ; ++u) acc[s][u] *= corr;
    }
    for (int j = 0; j < nk; ++j) {
      float pv[4];
#pragma unroll
      for (int s = 0; s < 4; ++s) pv[s] = p_s[fa::acc_row<HD>(s) * C::PLD + j];
#pragma unroll
      for (int u = 0; u < C::CQ; ++u) {
        const float vv = v_s[j * C::LD + fa::acc_col<HD>(u)];
#pragma unroll
        for (int s = 0; s < 4; ++s) acc[s][u] += pv[s] * vv;
      }
    }
  }
  __syncthreads();
  T* ob = static_cast<T*>(a.out) + b * a.o_sb + h * a.o_sh;
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    const int r = fa::acc_row<HD>(s);
    if (r >= nq) continue;
    const float inv = 1.f / fmaxf(l_s[r], 1e-30f);
#pragma unroll
    for (int u = 0; u < C::CQ; ++u)
      ob[(long long)(q0 + r) * a.o_ss + fa::acc_col<HD>(u)] =
          rt::from_f<T>(acc[s][u] * inv);
  }
  if (a.lse != nullptr && tid < nq) {
    // a row that met no tile has no probabilities: +inf gives them 0
    const float l = l_s[tid];
    a.lse[((long long)b * a.Hq + h) * a.Sq + q0 + tid] =
        l > 0.f ? m_s[tid] + logf(l) : INFINITY;
  }
}

template <typename T, int HD>
cudaError_t launch(dim3 grid, cudaStream_t st, const FwdArgs& a) {
  constexpr int kSmem = fwd_smem_floats<HD>() * sizeof(float);
  static const cudaError_t attr =
      fa::allow_smem(flash_fwd_kernel<T, HD>, kSmem);
  if (attr != cudaSuccess) return attr;
  flash_fwd_kernel<T, HD><<<grid, Cfg<HD>::NT, kSmem, st>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_hd(int hd, dim3 grid, cudaStream_t st, const FwdArgs& a) {
  switch (hd) {
    case 32: return launch<T, 32>(grid, st, a);
    case 64: return launch<T, 64>(grid, st, a);
    case 128: return launch<T, 128>(grid, st, a);
    default: return launch<T, 256>(grid, st, a);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, K, V and out).  Layouts: q/out
// (B, Hq, Sq, hd); K/V (B, Hkv, Skv, hd), Hq = G Hkv; strides in elements,
// the head_dim stride 1; lse (B, Hq, Sq) f32 contiguous, or null.  window
// <= 0 means none.  Returns cudaGetLastError() after the launch, or the
// error of raising the kernel's shared-memory limit (0 = launched).
extern "C" int flash_attention_launch(
    int dtype, int hd, int B, int Hq, int Sq, int Skv, int G, int causal,
    int window, float scale, const void* q, long long q_sb, long long q_sh,
    long long q_ss, const void* k, long long k_sb, long long k_sh,
    long long k_ss, const void* v, long long v_sb, long long v_sh,
    long long v_ss, void* out, long long o_sb, long long o_sh,
    long long o_ss, void* lse, void* stream) {
  if ((hd != 32 && hd != 64 && hd != 128 && hd != 256) || G < 1 || B < 1 ||
      Hq < 1 || Sq < 1 || Skv < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  FwdArgs a{q,   q_sb, q_sh, q_ss, k,  k_sb,   k_sh,
            k_ss, v,   v_sb, v_sh, v_ss, out, o_sb,
            o_sh, o_ss, static_cast<float*>(lse), Hq, Sq, Skv, G,
            causal, window, scale};
  const dim3 grid((Sq + kT - 1) / kT, Hq, B);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = dtype == 0
                              ? launch_hd<float>(hd, grid, st, a)
                              : launch_hd<__nv_bfloat16>(hd, grid, st, a);
  return static_cast<int>(err);
}
