// Tensor-core pieces shared by the serving attention kernels
// (decode_attention.cu, flash_attention_pool.cu) for bf16 queries over bf16
// or int8 K/V: cp.async copies (16-byte rows, 4-byte per-slot scalars, zero
// filled past the ring's end), ldmatrix and mma.sync.m16n8k16 (bf16 in, f32
// accumulation), the int8 -> bf16 tile conversion, one warp's flash step
// over a K/V tile held in shared memory, and the merge of a ring split
// across blocks.
//
// A warp owns 16 query rows.  In the m16n8k16 fragments, lane (g = lane / 4,
// t = lane % 4) holds rows g and g + 8 of the scores and of the output
// accumulator, at columns 2t and 2t + 1 of every 8-wide column tile.  Tiles
// in shared memory are row-major with rows padded by 8 bf16 (16 bytes), so
// the 8 rows an ldmatrix reads start in 8 distinct 4-bank groups.
#pragma once

#include <climits>
#include <type_traits>

#include "common.cuh"

namespace am {

using bf16 = __nv_bfloat16;
constexpr float kLog2e = 1.4426950408889634f;

// padded shared-memory row of a bf16 tile of head_dim HD
template <int HD>
__host__ __device__ constexpr int ld() {
  return HD + 8;
}

__host__ __device__ constexpr int align16(int bytes) {
  return (bytes + 15) / 16 * 16;
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, or 16 zero bytes when !ok (src is not read)
__device__ __forceinline__ void cp16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

// 4 bytes global -> shared, or zero when !ok
__device__ __forceinline__ void cp4(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N committed groups of this thread are in flight
template <int N>
__device__ __forceinline__ void wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// d += a (16x16 bf16, row) * b (16x8 bf16, col), f32 accumulation
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += t in f32, rounded to nearest (see warp_tile's PV product)
__device__ __forceinline__ void add4(float (&d)[4], const float (&t)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) d[e] += t[e];
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// (x, y) as three bf16 pairs whose sum is (x, y) to 2^-27 relative: each
// part is the bf16 rounding of what the parts before it leave out
__device__ __forceinline__ void split_bf16(float x, float y,
                                           uint32_t (&part)[3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
    part[i] = *reinterpret_cast<const uint32_t*>(&h);
    x -= __low2float(h);
    y -= __high2float(h);
  }
}

// Rows [0, n_ok) of a BK-slot K and V tile from global memory (slot stride
// k_ss / v_ss elements, rows 16-byte aligned) into shared memory, rows n_ok..
// zero filled: bf16 into padded rows (ld<HD>()), int8 into packed HD-byte
// rows for to_bf16.  Issued by all NT threads of the block.
template <typename KV, int HD, int BK, int NT>
__device__ __forceinline__ void load_kv(KV* k_dst, KV* v_dst, const KV* kb,
                                        long long k_ss, const KV* vb,
                                        long long v_ss, int t0, int n_ok) {
  constexpr int kVec = 16 / sizeof(KV);
  constexpr int kChunks = HD / kVec;
  constexpr int kLd = std::is_same<KV, int8_t>::value ? HD : ld<HD>();
  static_assert(NT % kChunks == 0, "tile shape");
  // thread t copies column chunk t % kChunks of rows t / kChunks + i NT /
  // kChunks
  const int c = (threadIdx.x % kChunks) * kVec, j0 = threadIdx.x / kChunks;
#pragma unroll
  for (int i = 0; i < (BK * kChunks + NT - 1) / NT; ++i) {
    const int j = j0 + i * (NT / kChunks);
    if (BK * kChunks % NT != 0 && j >= BK) break;
    const bool ok = j < n_ok;
    const long long slot = ok ? t0 + j : 0;
    cp16(k_dst + j * kLd + c, kb + slot * k_ss + c, ok);
    cp16(v_dst + j * kLd + c, vb + slot * v_ss + c, ok);
  }
}

// A tile's per-slot positions (and, for int8 K/V, scales), zero past n_ok.
template <int BK, int NT>
__device__ __forceinline__ void load_slots(int* pk_dst, float* ks_dst,
                                           float* vs_dst, const int* pkb,
                                           long long pk_ss, const float* ksb,
                                           long long ks_ss, const float* vsb,
                                           long long vs_ss, int t0,
                                           int n_ok) {
  static_assert(BK <= NT, "one slot a thread");
  const int j = threadIdx.x;
  if (j < BK) {
    const bool ok = j < n_ok;
    const long long slot = ok ? t0 + j : 0;
    cp4(pk_dst + j, pkb + slot * pk_ss, ok);
    if (ksb != nullptr) {
      cp4(ks_dst + j, ksb + slot * ks_ss, ok);
      cp4(vs_dst + j, vsb + slot * vs_ss, ok);
    }
  }
}

// int8 rows [BK][HD] -> bf16 padded rows [BK][ld<HD>()]: exact (|x| <= 127).
template <int HD, int BK, int NT>
__device__ __forceinline__ void to_bf16(bf16* dst, const int8_t* src) {
  constexpr int kChunks = HD / 16;
#pragma unroll
  for (int i = 0; i < (BK * kChunks + NT - 1) / NT; ++i) {
    const int idx = threadIdx.x + i * NT;
    if (BK * kChunks % NT != 0 && idx >= BK * kChunks) break;
    const int j = idx / kChunks, c = (idx % kChunks) * 16;
    const int4 raw = *reinterpret_cast<const int4*>(src + j * HD + c);
    const int8_t* x = reinterpret_cast<const int8_t*>(&raw);
    uint32_t w[8];
#pragma unroll
    for (int e = 0; e < 8; ++e)
      w[e] = pack_bf16(static_cast<float>(x[2 * e]),
                       static_cast<float>(x[2 * e + 1]));
    uint4* d = reinterpret_cast<uint4*>(dst + j * ld<HD>() + c);
    d[0] = make_uint4(w[0], w[1], w[2], w[3]);
    d[1] = make_uint4(w[4], w[5], w[6], w[7]);
  }
}

// The query positions of a warp's 16 rows, as the mask reads them: a slot
// at position sp is valid for held row r (g + 8 r) when lo[r] < sp <=
// pq[r], lo = max(-1, pq - window) (-1 without a window: empty slots are
// -1).  The warp's least pq and largest lo decide whether a whole tile is
// valid for every row.
struct RowPos {
  int pq[2], lo[2];
  int pq_min, lo_max;
  __device__ __forceinline__ void init(int pq0, int pq1, int window) {
    pq[0] = pq0;
    pq[1] = pq1;
#pragma unroll
    for (int r = 0; r < 2; ++r)
      lo[r] = window > 0 ? max(-1, pq[r] - window) : -1;
    pq_min = min(pq[0], pq[1]);
    lo_max = max(lo[0], lo[1]);
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      pq_min = min(pq_min, __shfl_xor_sync(0xffffffffu, pq_min, o));
      lo_max = max(lo_max, __shfl_xor_sync(0xffffffffu, lo_max, o));
    }
  }
};

// The online-softmax state of a warp's 16 rows: the unnormalised output
// accumulator, and per held row the running max m (of the scaled scores, in
// natural units) and this lane's part of the running sum l (summed over the
// row's four lanes at the end, see quad_sum).
template <int HD>
struct Rows {
  float o[HD / 8][4];
  float m[2], l[2];
  __device__ __forceinline__ void init() {
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
    m[0] = m[1] = rt::kNegInf;
    l[0] = l[1] = 0.f;
  }
};

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// One warp's flash step over NS slots of a tile: slots [slot0, slot0 + NS)
// of k_s / v_s (bf16, padded rows), against the 16 query rows at q_s.
// Scores are q.k in f32 times k_scale (int8) times `scale`, as the plain
// version scales after the product; a slot at or past n_ok (outside the
// ring or the split) gets -inf and so no weight, a masked slot -1e30, as in
// the reference.  For int8 the V scale is folded into P before the PV
// product (l sums the unscaled P).
template <int HD, int NS, bool QUANT>
__device__ __forceinline__ void warp_tile(Rows<HD>& st, const bf16* q_s,
                                          const bf16* k_s, const bf16* v_s,
                                          int slot0, const int* pk_s,
                                          const float* ks_s, const float* vs_s,
                                          int n_ok, const RowPos& pos,
                                          float scale) {
  static_assert(NS % 16 == 0 && HD % 16 == 0, "m16n8k16 tiles");
  constexpr int LD = ld<HD>();
  const int lane = threadIdx.x & 31, t4 = lane & 3;
  float s[NS / 8][4];
#pragma unroll
  for (int j = 0; j < NS / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
  // S = Q K^T: A from the q rows, B from K rows (slot-major = "col")
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    uint32_t a[4];
    ldsm_x4(a, q_s + (lane & 15) * LD + kk * 16 + (lane >> 4) * 8);
#pragma unroll
    for (int n2 = 0; n2 < NS / 16; ++n2) {
      uint32_t b[4];
      ldsm_x4(b, k_s + (slot0 + n2 * 16 + (lane & 7) + (lane >> 4) * 8) * LD +
                     kk * 16 + ((lane >> 3) & 1) * 8);
      mma(s[2 * n2], a, b[0], b[1]);
      mma(s[2 * n2 + 1], a, b[2], b[3]);
    }
  }
  // scale and mask; the rows' new max.  The lane's slot positions (columns
  // slot0 + 8 j + 2 t + {0, 1}) are read once for both its rows; a tile
  // inside the ring whose positions every row of the warp sees needs no
  // mask (warp-uniform: the quad's lanes cover the tile's columns)
  int2 sp[NS / 8];
  int sp_min = INT_MAX, sp_max = INT_MIN;
#pragma unroll
  for (int j = 0; j < NS / 8; ++j) {
    sp[j] = *reinterpret_cast<const int2*>(pk_s + slot0 + j * 8 + 2 * t4);
    sp_min = min(sp_min, min(sp[j].x, sp[j].y));
    sp_max = max(sp_max, max(sp[j].x, sp[j].y));
  }
#pragma unroll
  for (int o = 1; o < 4; o <<= 1) {
    sp_min = min(sp_min, __shfl_xor_sync(0xffffffffu, sp_min, o));
    sp_max = max(sp_max, __shfl_xor_sync(0xffffffffu, sp_max, o));
  }
  const bool ragged = slot0 + NS > n_ok;
  const bool whole = !ragged && sp_min > pos.lo_max && sp_max <= pos.pq_min;
  float mx[2] = {st.m[0], st.m[1]};
#pragma unroll
  for (int j = 0; j < NS / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = slot0 + j * 8 + 2 * t4 + (e & 1), r = e >> 1;
      float x = s[j][e];
      if (QUANT) x *= ks_s[c];
      x *= scale;
      if (!whole) {
        const int p = (e & 1) ? sp[j].y : sp[j].x;
        const bool ok = static_cast<unsigned>(p - pos.lo[r] - 1) <
                        static_cast<unsigned>(pos.pq[r] - pos.lo[r]);
        x = ok ? x : rt::kNegInf;
        if (ragged && c >= n_ok) x = -INFINITY;
      }
      s[j][e] = x;
      mx[r] = fmaxf(mx[r], x);
    }
  // (x - m) before the product: a masked row's -1e30 - -1e30 is exactly 0
  // (a fused x * log2e - m * log2e would not be)
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = quad_max(mx[r]);
    const float corr = exp2f((st.m[r] - mx[r]) * kLog2e);
    st.m[r] = mx[r];
    st.l[r] *= corr;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      st.o[j][2 * r] *= corr;
      st.o[j][2 * r + 1] *= corr;
    }
  }
#pragma unroll
  for (int j = 0; j < NS / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = exp2f((s[j][e] - mx[e >> 1]) * kLog2e);
      st.l[e >> 1] += p;
      s[j][e] = QUANT ? p * vs_s[slot0 + j * 8 + 2 * t4 + (e & 1)] : p;
    }
  // O += P V: P from the score fragments, B from V rows by ldmatrix.trans.
  // P goes in as three bf16 parts (split_bf16), each product exact, so P
  // keeps f32's precision: with P in one bf16 part (2^-9) or two (2^-18)
  // the output's error from float64 was several times the plain version's
  // f32 error, enough to move served tokens of qwen2-moe-a2.7b's near-tie
  // router past the token check's margin (PERF.md).  The products
  // of each 16 slots land in a fresh accumulator t, added to O with
  // round-to-nearest: the tensor cores add into their accumulator with
  // truncation, which over a row's whole ring biased the output toward zero
#pragma unroll
  for (int kt = 0; kt < NS / 16; ++kt) {
    uint32_t a[4][3];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      split_bf16(s[2 * kt + (i >> 1)][2 * (i & 1)],
                 s[2 * kt + (i >> 1)][2 * (i & 1) + 1], a[i]);
    const bf16* vrow =
        v_s + (slot0 + kt * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
        (lane >> 4) * 8;
#pragma unroll
    for (int dt = 0; dt < HD / 16; ++dt) {
      uint32_t b[4];
      ldsm_x4_t(b, vrow + dt * 16);
      float t0[4] = {0.f, 0.f, 0.f, 0.f}, t1[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int c = 2; c >= 0; --c) {  // smallest part first
        const uint32_t ap[4] = {a[0][c], a[1][c], a[2][c], a[3][c]};
        mma(t0, ap, b[0], b[1]);
        mma(t1, ap, b[2], b[3]);
      }
      add4(st.o[2 * dt], t0);
      add4(st.o[2 * dt + 1], t1);
    }
  }
}

// The merge of a split ring.  Block (i, h, b) = output row (b, h, i) of
// (B, H, Sq, hd), from the f32 partials of its n splits, m and l at row
// ((b H + h) Sq + i) n + s and acc beside them with hd columns:
//   out = sum_s e^{m_s - m*} acc_s / sum_s e^{m_s - m*} l_s,  m* = max_s m_s,
// the splits summed in order, so a call gives the same bits every time.
template <typename T>
__global__ void merge_kernel(const float* pm, const float* pl,
                             const float* pacc, int n, int hd, void* out,
                             long long o_sb, long long o_sh, long long o_ss) {
  const int i = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const long long base =
      ((static_cast<long long>(b) * gridDim.y + h) * gridDim.x + i) * n;
  float M = -INFINITY;
  for (int s = 0; s < n; ++s) M = fmaxf(M, pm[base + s]);
  for (int d = threadIdx.x; d < hd; d += blockDim.x) {
    float num = 0.f, den = 0.f;
    for (int s = 0; s < n; ++s) {
      const float w = exp2f((pm[base + s] - M) * kLog2e);
      num += w * pacc[(base + s) * hd + d];
      den += w * pl[base + s];
    }
    static_cast<T*>(out)[b * o_sb + h * o_sh + i * o_ss + d] =
        rt::from_f<T>(num / fmaxf(den, 1e-30f));
  }
}

// Raise a kernel's dynamic shared-memory limit (needed past 48 KB).
template <typename K>
cudaError_t allow_smem(K kernel, int bytes) {
  return bytes <= 48 * 1024
             ? cudaSuccess
             : cudaFuncSetAttribute(
                   kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

}  // namespace am
