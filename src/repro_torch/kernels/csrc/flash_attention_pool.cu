// Chunked-prefill GQA attention of a C-token chunk against pool ring rows.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py
// (flash_attention_pool, _flash_pool_kernel): for each row b, query head h
// and chunk token i,
//   out = softmax_j(q_i . K_j / sqrt(hd) masked) @ V   over kv head h // G,
// where ring slot j is valid when 0 <= pos_kv[b, j] <= pos_q[b, i] (and
// > pos_q[b, i] - window).  Causality, ring wrap and empty slots all come
// from the position masks, so no tile can be skipped by its index range
// (slot order is not position order), as in the TPU kernel.  Int8 K/V are
// dequantised in the kernel by their per-(kv head, slot) f32 scale.
//
// What bounds it on the card: for the serving path's chunks (C = 128..512
// against a 2048-slot ring, hd = 128, G = 3) the work is G*C FLOPs per bf16
// K/V byte (384..1536), above the H100's ~295 FLOP/byte ridge, so
// operations bound it; this first version runs them on the CUDA cores in
// f32, not on the tensor cores.  The design keeps
// the TPU kernel's flash structure: one block per (row, query head, 16-query
// tile) loops over 32-slot K/V tiles staged (dequantised, f32) in shared
// memory, carrying the online-softmax state, so device-memory traffic is
// O(ring) per query tile, and each thread register-blocks its scores over
// several query rows so a K element read from shared memory feeds several
// FMAs.  Left for later work: wgmma/mma.sync tensor-core tiles, TMA
// pipelining, and sharing one K/V tile among the G query heads of a group.
#include "common.cuh"

namespace {

constexpr int kBQ = 16;  // queries per block
constexpr int kBK = 32;  // ring slots per tile

struct PoolArgs {
  const void* q;
  long long q_sb, q_sh, q_ss;
  const void* k;
  long long k_sb, k_sh, k_ss;
  const void* v;
  long long v_sb, v_sh, v_ss;
  const float* ks;
  long long ks_sb, ks_sh, ks_ss;
  const float* vs;
  long long vs_sb, vs_sh, vs_ss;
  const int* pq;
  long long pq_sb, pq_ss;
  const int* pk;
  long long pk_sb, pk_ss;
  void* out;
  long long o_sb, o_sh, o_ss;
  int Sq, S, G, window;
  float scale;
};

// Block (HD threads) = one (query tile, query head, row).  Thread t owns
// output column t of every query in the tile.
template <typename T, typename KV, int HD>
__global__ void __launch_bounds__(HD) flash_pool_kernel(PoolArgs a) {
  constexpr int kWarps = HD / 32;
  constexpr int kRowStep = HD / kBK;        // score rows covered per pass
  constexpr int kRowsPer = kBQ / kRowStep;  // score rows per thread
  const int q0 = blockIdx.x * kBQ, hq = blockIdx.y, b = blockIdx.z;
  const int hk = hq / a.G;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nq = min(kBQ, a.Sq - q0);
  const bool quant = a.ks != nullptr;

  __shared__ float q_s[kBQ][HD];
  __shared__ float k_s[kBK][HD + 1];  // +1: conflict-free column reads
  __shared__ float v_s[kBK][HD];
  __shared__ float p_s[kBQ][kBK];
  __shared__ int pk_s[kBK];
  __shared__ int pq_s[kBQ];
  __shared__ float m_s[kBQ], l_s[kBQ], c_s[kBQ];

  const T* qb = static_cast<const T*>(a.q) + b * a.q_sb + hq * a.q_sh;
  for (int r = 0; r < kBQ; ++r)
    q_s[r][tid] = r < nq
        ? rt::to_f(qb[(long long)(q0 + r) * a.q_ss + tid]) * a.scale : 0.f;
  if (tid < kBQ) {
    pq_s[tid] = tid < nq ? a.pq[b * a.pq_sb + (long long)(q0 + tid) * a.pq_ss]
                         : -1;
    m_s[tid] = rt::kNegInf;
    l_s[tid] = 0.f;
  }
  const KV* kb = static_cast<const KV*>(a.k) + b * a.k_sb + hk * a.k_sh;
  const KV* vb = static_cast<const KV*>(a.v) + b * a.v_sb + hk * a.v_sh;
  const float* ksb = quant ? a.ks + b * a.ks_sb + hk * a.ks_sh : nullptr;
  const float* vsb = quant ? a.vs + b * a.vs_sb + hk * a.vs_sh : nullptr;
  const int* pkb = a.pk + b * a.pk_sb;

  float acc[kBQ];
#pragma unroll
  for (int r = 0; r < kBQ; ++r) acc[r] = 0.f;

  const int j_own = tid % kBK, r_own = tid / kBK;
  for (int t0 = 0; t0 < a.S; t0 += kBK) {
    const int n = min(kBK, a.S - t0);
    for (int j = 0; j < n; ++j) {
      const long long slot = t0 + j;
      const float ksc = quant ? ksb[slot * a.ks_ss] : 1.f;
      const float vsc = quant ? vsb[slot * a.vs_ss] : 1.f;
      k_s[j][tid] = rt::to_f(kb[slot * a.k_ss + tid]) * ksc;
      v_s[j][tid] = rt::to_f(vb[slot * a.v_ss + tid]) * vsc;
    }
    if (tid < n) pk_s[tid] = pkb[(long long)(t0 + tid) * a.pk_ss];
    __syncthreads();
    // scores: thread owns slot j_own of rows r_own + t * kRowStep
    if (j_own < n) {
      float sc[kRowsPer];
#pragma unroll
      for (int t = 0; t < kRowsPer; ++t) sc[t] = 0.f;
#pragma unroll 8
      for (int i = 0; i < HD; ++i) {
        const float kk = k_s[j_own][i];
#pragma unroll
        for (int t = 0; t < kRowsPer; ++t)
          sc[t] += q_s[r_own + t * kRowStep][i] * kk;
      }
      const int pk = pk_s[j_own];
#pragma unroll
      for (int t = 0; t < kRowsPer; ++t) {
        const int r = r_own + t * kRowStep;
        p_s[r][j_own] = rt::slot_ok(pk, pq_s[r], a.window) ? sc[t] : rt::kNegInf;
      }
    }
    __syncthreads();
    // online softmax, one warp per query row (kBK == 32: one slot a lane)
    for (int r = warp; r < kBQ; r += kWarps) {
      const float s = lane < n ? p_s[r][lane] : -INFINITY;
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, rt::warp_max(s));
      const float p = lane < n ? expf(s - m_new) : 0.f;
      if (lane < n) p_s[r][lane] = p;
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
    for (int r = 0; r < kBQ; ++r) acc[r] *= c_s[r];
    for (int j = 0; j < n; ++j) {
      const float vv = v_s[j][tid];
#pragma unroll
      for (int r = 0; r < kBQ; ++r) acc[r] += p_s[r][j] * vv;
    }
    __syncthreads();
  }
  T* ob = static_cast<T*>(a.out) + b * a.o_sb + hq * a.o_sh;
  for (int r = 0; r < nq; ++r)
    ob[(long long)(q0 + r) * a.o_ss + tid] =
        rt::from_f<T>(acc[r] / fmaxf(l_s[r], 1e-30f));
}

template <typename T, typename KV>
void launch_hd(int hd, dim3 grid, cudaStream_t st, const PoolArgs& a) {
  switch (hd) {
    case 32: flash_pool_kernel<T, KV, 32><<<grid, 32, 0, st>>>(a); break;
    case 64: flash_pool_kernel<T, KV, 64><<<grid, 64, 0, st>>>(a); break;
    case 128: flash_pool_kernel<T, KV, 128><<<grid, 128, 0, st>>>(a); break;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, out, and K/V unless kv_int8).
// Layouts: q/out (B, Hq, Sq, hd); K/V (B, Hkv, S, hd); scales (B, Hkv, S);
// pos_q (B, Sq); pos_kv (B, S).  Strides are in elements; the head_dim
// stride of q, K, V and out is 1.  Returns cudaGetLastError() after the
// launch (0 = launched).
extern "C" int flash_attention_pool_launch(
    int dtype, int kv_int8, int hd, int B, int Hq, int Sq, int S, int G,
    int window, float scale, const void* q, long long q_sb, long long q_sh,
    long long q_ss, const void* k, long long k_sb, long long k_sh,
    long long k_ss, const void* v, long long v_sb, long long v_sh,
    long long v_ss, const void* ks, long long ks_sb, long long ks_sh,
    long long ks_ss, const void* vs, long long vs_sb, long long vs_sh,
    long long vs_ss, const void* pq, long long pq_sb, long long pq_ss,
    const void* pk, long long pk_sb, long long pk_ss, void* out,
    long long o_sb, long long o_sh, long long o_ss, void* stream) {
  if ((hd != 32 && hd != 64 && hd != 128) || G < 1 || S < 1 || Sq < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  PoolArgs a{q,  q_sb,  q_sh,  q_ss,  k,     k_sb,  k_sh,  k_ss,
             v,  v_sb,  v_sh,  v_ss,  static_cast<const float*>(ks),
             ks_sb, ks_sh, ks_ss, static_cast<const float*>(vs),
             vs_sb, vs_sh, vs_ss, static_cast<const int*>(pq),
             pq_sb, pq_ss, static_cast<const int*>(pk), pk_sb, pk_ss,
             out, o_sb, o_sh, o_ss, Sq, S, G, window, scale};
  const dim3 grid((Sq + kBQ - 1) / kBQ, Hq, B);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    if (kv_int8) launch_hd<float, int8_t>(hd, grid, st, a);
    else launch_hd<float, float>(hd, grid, st, a);
  } else {
    if (kv_int8) launch_hd<__nv_bfloat16, int8_t>(hd, grid, st, a);
    else launch_hd<__nv_bfloat16, __nv_bfloat16>(hd, grid, st, a);
  }
  return static_cast<int>(cudaGetLastError());
}
