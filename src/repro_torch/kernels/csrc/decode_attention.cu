// Single-token GQA decode attention over the slot-pool KV ring.
//
// Replaces the Pallas TPU kernel repro/kernels/decode_attention.py
// (decode_attention, _decode_kernel): for each row b and query head h,
//   out = softmax_j(q . K_j / sqrt(hd) masked) @ V
// over the first S ring slots, where slot j is valid when
//   0 <= slot_pos[b, j] <= cur_pos[b]  (and > cur_pos[b] - window).
// Int8 K/V are dequantised in the kernel by their per-(slot, kv head) f32
// scale, so the device-memory stream stays one byte an element.
//
// What bounds it on the card: bytes.  A decode step reads the whole live
// ring prefix of every row once and does G FLOPs per bf16 K/V byte read (3
// for llama3.2-3b), far below the H100's ~295 FLOP/byte ridge.  The design answers that with the TPU
// kernel's layout: one block per (row, kv head) holds all G query heads of
// the group, so each K/V row is read from device memory once per group,
// not once per query head.  The TPU grid's sequential kv axis (which
// carried m/l/acc in VMEM) becomes a loop over ring tiles inside the block,
// with the f32 online-softmax state in shared memory and registers.  Each
// tile (8 KB of K and 8 KB of V) is fetched with 16-byte vector loads into
// registers one tile ahead — the next tile's loads are in flight while the
// current one is scored from shared memory — so the block keeps memory
// busy instead of waiting on one load at a time.  Left for later work:
// split-KV across blocks (only B*Hkv blocks run at once), and TMA.
#include "common.cuh"

namespace {

constexpr int kGMax = 16;  // query heads per kv head the kernel takes

struct DecodeArgs {
  const void* q;
  long long q_sb, q_sh;
  const void* k;
  long long k_sb, k_ss, k_sh;
  const void* v;
  long long v_sb, v_ss, v_sh;
  const float* ks;
  long long ks_sb, ks_ss, ks_sh;
  const float* vs;
  long long vs_sb, vs_ss, vs_sh;
  const int* sp;
  long long sp_sb, sp_ss;
  const int* cur;
  long long cur_sb;
  void* out;
  long long o_sb, o_sh;
  int S, G, window;
  float scale;
};

// Block (HD threads) = one (kv head, row).  Thread t owns output column t
// of every query head in the group.  A tile holds 64 / sizeof(KV) ring
// slots up to hd 128 (32 of bf16, 64 of int8, 16 of f32: 8 KB of K and 8 KB
// of V at hd = 128), so each thread moves four 16-byte vectors of each per
// tile; at hd 256 it holds half as many slots (the same 8 KB, two vectors a
// thread), which keeps the 16 query heads' f32 rows (16 KB) and the tile
// within the 48 KB of static shared memory.
template <typename T, typename KV, int HD>
__global__ void __launch_bounds__(HD) decode_kernel(DecodeArgs a) {
  constexpr int kWarps = HD / 32;
  constexpr int kPer = HD / 32;                  // K-row elements a lane scores
  constexpr int kVec = 16 / sizeof(KV);          // elements per 16-byte vector
  constexpr int kTile = (HD >= 256 ? 32 : 64) / sizeof(KV);  // slots a tile
  constexpr int kRowVecs = HD / kVec;            // vectors per K/V row
  constexpr int kLoads = kTile * kRowVecs / HD;  // vectors per thread (4, 2)
  constexpr int kSlots = (kTile + HD - 1) / HD;  // slot scalars per thread
  static_assert(kTile <= 64, "softmax covers two slots a lane");
  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int G = a.G, S = a.S;
  const bool quant = a.ks != nullptr;

  __shared__ float q_s[kGMax][HD];
  __shared__ float p_s[kGMax][kTile];
  __shared__ __align__(16) KV k_s[kTile * HD];
  __shared__ __align__(16) KV v_s[kTile * HD];
  __shared__ float ksc_s[kTile], vsc_s[kTile];
  __shared__ int sp_s[kTile];
  __shared__ float m_s[kGMax], l_s[kGMax], c_s[kGMax];

  const T* qb = static_cast<const T*>(a.q) + b * a.q_sb;
  for (int g = 0; g < G; ++g)
    q_s[g][tid] = rt::to_f(qb[(long long)(h * G + g) * a.q_sh + tid]) * a.scale;
  if (tid < G) {
    m_s[tid] = rt::kNegInf;
    l_s[tid] = 0.f;
  }
  const int cur = a.cur[b * a.cur_sb];
  const KV* kb = static_cast<const KV*>(a.k) + b * a.k_sb + h * a.k_sh;
  const KV* vb = static_cast<const KV*>(a.v) + b * a.v_sb + h * a.v_sh;
  const int* spb = a.sp + b * a.sp_sb;

  // one tile ahead in registers: K/V vectors, and the slots' positions and
  // scales (slot tid + s * HD of the tile)
  uint4 kr[kLoads], vr[kLoads];
  int spr[kSlots];
  float ksr[kSlots], vsr[kSlots];
#pragma unroll
  for (int i = 0; i < kLoads; ++i) kr[i] = vr[i] = make_uint4(0, 0, 0, 0);
#pragma unroll
  for (int s = 0; s < kSlots; ++s) {
    spr[s] = -1;
    ksr[s] = vsr[s] = 1.f;
  }
  auto fetch = [&](int t0) {
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      const int idx = tid + i * HD, j = idx / kRowVecs, c = idx % kRowVecs;
      const long long slot = t0 + j;
      if (slot < S) {
        kr[i] = *reinterpret_cast<const uint4*>(kb + slot * a.k_ss + c * kVec);
        vr[i] = *reinterpret_cast<const uint4*>(vb + slot * a.v_ss + c * kVec);
      }
    }
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      const int jj = tid + s * HD;
      const long long slot = t0 + jj;
      if (jj < kTile && slot < S) {
        spr[s] = spb[slot * a.sp_ss];
        if (quant) {
          ksr[s] = a.ks[b * a.ks_sb + slot * a.ks_ss + h * a.ks_sh];
          vsr[s] = a.vs[b * a.vs_sb + slot * a.vs_ss + h * a.vs_sh];
        }
      }
    }
  };

  float acc[kGMax];
#pragma unroll
  for (int g = 0; g < kGMax; ++g) acc[g] = 0.f;
  fetch(0);

  for (int t0 = 0; t0 < S; t0 += kTile) {
    const int n = min(kTile, S - t0);
    __syncthreads();  // the previous tile's readers are done
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      reinterpret_cast<uint4*>(k_s)[tid + i * HD] = kr[i];
      reinterpret_cast<uint4*>(v_s)[tid + i * HD] = vr[i];
    }
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      const int jj = tid + s * HD;
      if (jj < kTile) {
        sp_s[jj] = spr[s];
        ksc_s[jj] = ksr[s];
        vsc_s[jj] = vsr[s];
      }
    }
    __syncthreads();
    if (t0 + kTile < S) fetch(t0 + kTile);  // in flight while we compute
    // scores: each warp takes whole slots, every lane kPer elements
    for (int j = warp; j < n; j += kWarps) {
      const KV* krow = k_s + j * HD;
      const float ksc = ksc_s[j];
      float kv[kPer];
#pragma unroll
      for (int i = 0; i < kPer; ++i) kv[i] = rt::to_f(krow[lane + 32 * i]) * ksc;
      const bool ok = rt::slot_ok(sp_s[j], cur, a.window);
#pragma unroll
      for (int g = 0; g < kGMax; ++g) {
        if (g < G) {
          float part = 0.f;
#pragma unroll
          for (int i = 0; i < kPer; ++i) part += q_s[g][lane + 32 * i] * kv[i];
          part = rt::warp_sum(part);
          if (lane == 0) p_s[g][j] = ok ? part : rt::kNegInf;
        }
      }
    }
    __syncthreads();
    // online softmax, one warp per query head
    for (int g = warp; g < G; g += kWarps) {
      const float s0 = lane < n ? p_s[g][lane] : -INFINITY;
      const float s1 = lane + 32 < n ? p_s[g][lane + 32] : -INFINITY;
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, rt::warp_max(fmaxf(s0, s1)));
      const float p0 = lane < n ? expf(s0 - m_new) : 0.f;
      const float p1 = lane + 32 < n ? expf(s1 - m_new) : 0.f;
      if (lane < n) p_s[g][lane] = p0;
      if (lane + 32 < n) p_s[g][lane + 32] = p1;
      const float sum = rt::warp_sum(p0 + p1);
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        c_s[g] = corr;
        l_s[g] = l_s[g] * corr + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();
    // context: thread tid accumulates column tid of every head in the group
#pragma unroll
    for (int g = 0; g < kGMax; ++g)
      if (g < G) acc[g] *= c_s[g];
    for (int j = 0; j < n; ++j) {
      const float vv = rt::to_f(v_s[j * HD + tid]) * vsc_s[j];
#pragma unroll
      for (int g = 0; g < kGMax; ++g)
        if (g < G) acc[g] += p_s[g][j] * vv;
    }
  }
  T* ob = static_cast<T*>(a.out) + b * a.o_sb;
#pragma unroll
  for (int g = 0; g < kGMax; ++g)
    if (g < G)
      ob[(long long)(h * G + g) * a.o_sh + tid] =
          rt::from_f<T>(acc[g] / fmaxf(l_s[g], 1e-30f));
}

template <typename T, typename KV>
void launch_hd(int hd, dim3 grid, cudaStream_t st, const DecodeArgs& a) {
  switch (hd) {
    case 32: decode_kernel<T, KV, 32><<<grid, 32, 0, st>>>(a); break;
    case 64: decode_kernel<T, KV, 64><<<grid, 64, 0, st>>>(a); break;
    case 128: decode_kernel<T, KV, 128><<<grid, 128, 0, st>>>(a); break;
    case 256: decode_kernel<T, KV, 256><<<grid, 256, 0, st>>>(a); break;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, out, and K/V unless kv_int8).
// Strides are in elements; the head_dim stride of q, K, V and out is 1, and
// K/V rows start on 16-byte boundaries (checked by the wrapper).  Returns
// cudaGetLastError() after the launch (0 = launched).
extern "C" int decode_attention_launch(
    int dtype, int kv_int8, int hd, int B, int Hkv, int S, int G, int window,
    float scale, const void* q, long long q_sb, long long q_sh, const void* k,
    long long k_sb, long long k_ss, long long k_sh, const void* v,
    long long v_sb, long long v_ss, long long v_sh, const void* ks,
    long long ks_sb, long long ks_ss, long long ks_sh, const void* vs,
    long long vs_sb, long long vs_ss, long long vs_sh, const void* sp,
    long long sp_sb, long long sp_ss, const void* cur, long long cur_sb,
    void* out, long long o_sb, long long o_sh, void* stream) {
  if ((hd != 32 && hd != 64 && hd != 128 && hd != 256) || G < 1 ||
      G > kGMax || S < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  DecodeArgs a{q,  q_sb,  q_sh,  k,     k_sb,  k_ss,  k_sh,
               v,  v_sb,  v_ss,  v_sh,  static_cast<const float*>(ks),
               ks_sb, ks_ss, ks_sh, static_cast<const float*>(vs),
               vs_sb, vs_ss, vs_sh, static_cast<const int*>(sp),
               sp_sb, sp_ss, static_cast<const int*>(cur), cur_sb,
               out, o_sb, o_sh, S, G, window, scale};
  const dim3 grid(Hkv, B);
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
