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
// against a 2048-slot ring, G = 3 at hd 128, G = 16 at hd 256) the work is
// G*C FLOPs per bf16 K/V byte (384..8192), above the H100's ~295 FLOP/byte
// ridge, so operations bound it, and only the tensor cores reach that
// bound.  The design, for bf16 queries (every serving call):
//   * one block per (64-row tile, ring split, kv head, row) whose rows are
//     packed (query, head-in-group) pairs, rho = i * G + g over the chunk's
//     C * G pairs (4 warps x 16 rows), so each K/V tile is read from memory
//     once per group, not once per query head, at G = 1, 3 and 16 alike;
//   * QK^T and PV on mma.sync.m16n8k16 (bf16, f32 accumulation), fragments
//     by ldmatrix from padded shared-memory rows; scores scaled by
//     1/sqrt(hd) in f32 after the product, online softmax in f32 registers;
//     the position mask costs a range test an element, and nothing on the
//     tiles every row of a warp sees whole (most of a long ring);
//   * 64-slot K/V tiles (32 at hd 256) double-buffered by cp.async, one
//     barrier a tile; int8 tiles are converted to bf16 in shared memory
//     (exact), the K scale multiplies the f32 scores, the V scale is folded
//     into P; P enters PV as three bf16 parts, and each tile's PV products
//     are added to the output with round-to-nearest, so the output carries
//     f32's error (anything coarser moved served tokens of
//     qwen2-moe-a2.7b's near-tie router past the token check's margin);
//   * a block's tile loop is bound by its warps' latency, not by loads, so
//     a chunk of few row tiles (the pow-2 sub-chunks: 1 row tile at C 16)
//     splits the ring across blocks (ops.pool_splits, shapes only), which
//     write f32 partials that am::merge_kernel combines in a fixed order.
// f32 queries (the small f32 serves and the card tests' 1e-4 checks) keep
// the first port's CUDA-core kernel: one block per (16-query tile, query
// head, row) over 32-slot f32 tiles in dynamic shared memory.
// Left for later work: wgmma with TMA and warp specialisation, which would
// also let a block hold more rows and so cut the L2 traffic of re-reading
// the ring per 64 rows.
#include "attn_mma.cuh"

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
  float* pm;    // bf16 kernel, n_split > 1: partials (B, Hq, Sq, n_split)
  float* pl;    // (B, Hq, Sq, n_split)
  float* pacc;  // (B, Hq, Sq, n_split, hd)
  int Sq, S, G, window, n_split;
  float scale;
};

// A block's shared memory, carved from the dynamic allocation.
template <int HD>
struct PoolSmem {
  float q[kBQ][HD];
  float k[kBK][HD + 1];  // +1: conflict-free column reads
  float v[kBK][HD];
  float p[kBQ][kBK];
  int pk[kBK];
  int pq[kBQ];
  float m[kBQ], l[kBQ], c[kBQ];
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

  extern __shared__ __align__(16) unsigned char smem[];
  PoolSmem<HD>& sm = *reinterpret_cast<PoolSmem<HD>*>(smem);
  auto& q_s = sm.q;
  auto& k_s = sm.k;
  auto& v_s = sm.v;
  auto& p_s = sm.p;
  auto& pk_s = sm.pk;
  auto& pq_s = sm.pq;
  auto& m_s = sm.m;
  auto& l_s = sm.l;
  auto& c_s = sm.c;

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

template <typename T, typename KV, int HD>
cudaError_t launch(dim3 grid, cudaStream_t st, const PoolArgs& a) {
  constexpr int kSmem = sizeof(PoolSmem<HD>);
  // raising the dynamic limit is needed once per kernel and device, past
  // 48 KB only
  static rt::PerDevice smem_set;
  const cudaError_t attr = smem_set.get(
      [&] { return am::allow_smem(flash_pool_kernel<T, KV, HD>, kSmem); });
  if (attr != cudaSuccess) return attr;
  flash_pool_kernel<T, KV, HD><<<grid, HD, kSmem, st>>>(a);
  return cudaGetLastError();
}

template <typename T, typename KV>
cudaError_t launch_hd(int hd, dim3 grid, cudaStream_t st,
                      const PoolArgs& a) {
  switch (hd) {
    case 32: return launch<T, KV, 32>(grid, st, a);
    case 64: return launch<T, KV, 64>(grid, st, a);
    case 128: return launch<T, KV, 128>(grid, st, a);
    default: return launch<T, KV, 256>(grid, st, a);
  }
}

// ---- bf16 queries: tensor cores, GQA-packed rows ------------------------
constexpr int kNT = 128;  // 4 warps

template <typename KV, int HD>
struct MmaLayout {
  static constexpr bool kQuant = std::is_same<KV, int8_t>::value;
  static constexpr int kRows = kNT / 32 * 16;  // packed rows: 16 a warp
  static constexpr int kBK = HD >= 256 ? 32 : 64;  // ring slots a tile
  // tiles in the ring: 3 and 4 measured no faster (PERF.md)
  static constexpr int kStages = 2;
  static constexpr int kLd = am::ld<HD>();
  static constexpr int kTileBytes = kQuant ? kBK * HD : kBK * kLd * 2;
  static constexpr int kQ = 0;                          // bf16 [rows][LD]
  static constexpr int kPq = kQ + kRows * kLd * 2;      // int [rows]
  static constexpr int kPk = kPq + kRows * 4;           // int [stages][BK]
  static constexpr int kKs = kPk + kStages * kBK * 4;   // f32 [stages][BK]
  static constexpr int kVs = kKs + kStages * kBK * 4;   // f32 [stages][BK]
  static constexpr int kRing = am::align16(kVs + kStages * kBK * 4);
  static constexpr int kConv = kRing + 2 * kStages * kTileBytes;  // int8
  static constexpr int kBytes = kConv + (kQuant ? 2 * kBK * kLd * 2 : 0);
};

// Two blocks an SM: their shared memory allows no more, and the bound lets
// the compiler spend up to 255 registers a thread.
template <typename KV, int HD>
__global__ void __launch_bounds__(kNT, 2) pool_mma_kernel(PoolArgs a) {
  using L = MmaLayout<KV, HD>;
  using am::bf16;
  constexpr int LD = L::kLd, BK = L::kBK, kRows = L::kRows, ST = L::kStages;
  // block (row tile, split): rows [r0, r0 + kRows) over ring tiles
  // [z T / n, (z + 1) T / n) of the T tiles, as the decode kernel splits
  const int z = blockIdx.x % a.n_split;
  const int r0 = blockIdx.x / a.n_split * kRows, h = blockIdx.y,
            b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int G = a.G, n_rows = a.Sq * G;
  const long long T = (a.S + BK - 1) / BK;
  const int first = static_cast<int>(z * T / a.n_split);
  const int nt = static_cast<int>((z + 1) * T / a.n_split) - first;

  extern __shared__ __align__(16) unsigned char smem[];
  bf16* q_s = reinterpret_cast<bf16*>(smem + L::kQ);
  int* pq_s = reinterpret_cast<int*>(smem + L::kPq);
  int* pk_s = reinterpret_cast<int*>(smem + L::kPk);
  float* ks_s = reinterpret_cast<float*>(smem + L::kKs);
  float* vs_s = reinterpret_cast<float*>(smem + L::kVs);
  auto k_ring = [&](int st) {
    return reinterpret_cast<KV*>(smem + L::kRing + (2 * st) * L::kTileBytes);
  };
  auto v_ring = [&](int st) {
    return reinterpret_cast<KV*>(smem + L::kRing +
                                 (2 * st + 1) * L::kTileBytes);
  };
  bf16* k_conv = reinterpret_cast<bf16*>(smem + L::kConv);
  bf16* v_conv = k_conv + BK * LD;

  // the block's packed rows rho = r0 + r: query i = rho / G, head h G + g;
  // rows past the chunk's C G are zero and take no position (-1: masked)
  const bf16* qb = static_cast<const bf16*>(a.q) + b * a.q_sb;
  for (int idx = tid; idx < kRows * (HD / 8); idx += kNT) {
    const int r = idx / (HD / 8), c = (idx % (HD / 8)) * 8, rho = r0 + r;
    const bool ok = rho < n_rows;
    const long long off = ok ? (long long)(h * G + rho % G) * a.q_sh +
                                   (long long)(rho / G) * a.q_ss
                             : 0;
    am::cp16(q_s + r * LD + c, qb + off + c, ok);
  }
  for (int r = tid; r < kRows; r += kNT) {
    const int rho = r0 + r;
    pq_s[r] = rho < n_rows
                  ? a.pq[b * a.pq_sb + (long long)(rho / G) * a.pq_ss]
                  : -1;
  }
  const KV* kb = static_cast<const KV*>(a.k) + b * a.k_sb + h * a.k_sh;
  const KV* vb = static_cast<const KV*>(a.v) + b * a.v_sb + h * a.v_sh;
  const float* ksb = L::kQuant ? a.ks + b * a.ks_sb + h * a.ks_sh : nullptr;
  const float* vsb = L::kQuant ? a.vs + b * a.vs_sb + h * a.vs_sh : nullptr;
  const int* pkb = a.pk + b * a.pk_sb;
  auto load = [&](int t) {
    const int st = t % ST, t0 = (first + t) * BK, n_ok = min(BK, a.S - t0);
    am::load_kv<KV, HD, BK, kNT>(k_ring(st), v_ring(st), kb, a.k_ss, vb,
                                 a.v_ss, t0, n_ok);
    am::load_slots<BK, kNT>(pk_s + st * BK, ks_s + st * BK, vs_s + st * BK,
                            pkb, a.pk_ss, ksb, a.ks_ss, vsb, a.vs_ss, t0,
                            n_ok);
  };
#pragma unroll
  for (int t = 0; t < ST - 1; ++t) {
    if (t < nt) load(t);
    am::commit();
  }

  am::Rows<HD> rows;
  rows.init();
  am::RowPos pos;
  for (int t = 0; t < nt; ++t) {
    am::wait<ST - 2>();
    __syncthreads();  // tile t (and q) landed; every warp is done with t - 1
    if (t == 0) pos.init(pq_s[warp * 16 + g], pq_s[warp * 16 + g + 8],
                         a.window);
    if (t + ST - 1 < nt) load(t + ST - 1);
    am::commit();
    const int st = t % ST, n_ok = min(BK, a.S - (first + t) * BK);
    const bf16* k_t;
    const bf16* v_t;
    if constexpr (L::kQuant) {
      am::to_bf16<HD, BK, kNT>(k_conv, k_ring(st));
      am::to_bf16<HD, BK, kNT>(v_conv, v_ring(st));
      __syncthreads();
      k_t = k_conv;
      v_t = v_conv;
    } else {
      k_t = k_ring(st);
      v_t = v_ring(st);
    }
    am::warp_tile<HD, BK, L::kQuant>(rows, q_s + warp * 16 * LD, k_t, v_t, 0,
                                     pk_s + st * BK, ks_s + st * BK,
                                     vs_s + st * BK, n_ok, pos, a.scale);
  }
  bf16* ob = static_cast<bf16*>(a.out) + b * a.o_sb;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float l = am::quad_sum(rows.l[r]);
    const int rho = r0 + warp * 16 + g + 8 * r;
    if (rho >= n_rows) continue;
    if (a.pm != nullptr) {  // this split's partials of the row
      const long long i =
          ((static_cast<long long>(b) * gridDim.y * G + h * G + rho % G) *
               a.Sq + rho / G) * a.n_split + z;
      if (t4 == 0) {
        a.pm[i] = rows.m[r];
        a.pl[i] = l;
      }
      float* prow = a.pacc + i * HD + 2 * t4;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j)
        *reinterpret_cast<float2*>(prow + j * 8) =
            make_float2(rows.o[j][2 * r], rows.o[j][2 * r + 1]);
      continue;
    }
    const float inv = 1.f / fmaxf(l, 1e-30f);
    bf16* orow = ob + (long long)(h * G + rho % G) * a.o_sh +
                 (long long)(rho / G) * a.o_ss;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(orow + j * 8 + 2 * t4) =
          __floats2bfloat162_rn(rows.o[j][2 * r] * inv,
                                rows.o[j][2 * r + 1] * inv);
  }
}

template <typename KV, int HD>
cudaError_t launch_mma(int B, int Hkv, cudaStream_t st, const PoolArgs& a) {
  using L = MmaLayout<KV, HD>;
  constexpr int kSmem = L::kBytes;
  if (a.n_split > (a.S + L::kBK - 1) / L::kBK)
    return cudaErrorInvalidValue;
  const dim3 grid((a.Sq * a.G + L::kRows - 1) / L::kRows * a.n_split, Hkv,
                  B);
  static rt::PerDevice smem_set;
  const cudaError_t attr = smem_set.get(
      [&] { return am::allow_smem(pool_mma_kernel<KV, HD>, kSmem); });
  if (attr != cudaSuccess) return attr;
  pool_mma_kernel<KV, HD><<<grid, kNT, kSmem, st>>>(a);
  return cudaGetLastError();
}

template <typename KV>
cudaError_t launch_mma_hd(int hd, int B, int Hkv, cudaStream_t st,
                          const PoolArgs& a) {
  switch (hd) {
    case 32: return launch_mma<KV, 32>(B, Hkv, st, a);
    case 64: return launch_mma<KV, 64>(B, Hkv, st, a);
    case 128: return launch_mma<KV, 128>(B, Hkv, st, a);
    default: return launch_mma<KV, 256>(B, Hkv, st, a);
  }
}

}  // namespace

// dtype: 0 = float32 (CUDA cores), 1 = bfloat16 (tensor cores) for q and
// out, and K/V unless kv_int8.  Layouts: q/out (B, Hq, Sq, hd); K/V (B, Hkv,
// S, hd); scales (B, Hkv, S); pos_q (B, Sq); pos_kv (B, S).  Strides are in
// elements; the head_dim stride of q, K, V and out is 1, and the rows of q,
// K and V start on 16-byte boundaries (checked by the wrapper).  bf16 only:
// with n_split > 1 the ring's tiles are split across blocks, which write
// the partials pm, pl (B, Hq, Sq, n_split) and pacc (B, Hq, Sq, n_split,
// hd), contiguous f32, merged into out by am::merge_kernel.  Returns
// cudaGetLastError() after the launches, or the error of raising a kernel's
// shared-memory limit (0 = launched).
extern "C" int flash_attention_pool_launch(
    int dtype, int kv_int8, int hd, int B, int Hq, int Sq, int S, int G,
    int window, int n_split, float scale, const void* q, long long q_sb,
    long long q_sh, long long q_ss, const void* k, long long k_sb,
    long long k_sh, long long k_ss, const void* v, long long v_sb,
    long long v_sh, long long v_ss, const void* ks, long long ks_sb,
    long long ks_sh, long long ks_ss, const void* vs, long long vs_sb,
    long long vs_sh, long long vs_ss, const void* pq, long long pq_sb,
    long long pq_ss, const void* pk, long long pk_sb, long long pk_ss,
    void* out, long long o_sb, long long o_sh, long long o_ss, void* pm,
    void* pl, void* pacc, void* stream) {
  if ((hd != 32 && hd != 64 && hd != 128 && hd != 256) || G < 1 || S < 1 ||
      Sq < 1 || Hq % G != 0 || n_split < 1 ||
      (n_split > 1) != (pm != nullptr) || (dtype == 0 && n_split != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  PoolArgs a{q,  q_sb,  q_sh,  q_ss,  k,     k_sb,  k_sh,  k_ss,
             v,  v_sb,  v_sh,  v_ss,  static_cast<const float*>(ks),
             ks_sb, ks_sh, ks_ss, static_cast<const float*>(vs),
             vs_sb, vs_sh, vs_ss, static_cast<const int*>(pq),
             pq_sb, pq_ss, static_cast<const int*>(pk), pk_sb, pk_ss,
             out, o_sb, o_sh, o_ss, static_cast<float*>(pm),
             static_cast<float*>(pl), static_cast<float*>(pacc),
             Sq, S, G, window, n_split, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    const dim3 grid((Sq + kBQ - 1) / kBQ, Hq, B);
    err = kv_int8 ? launch_hd<float, int8_t>(hd, grid, st, a)
                  : launch_hd<float, float>(hd, grid, st, a);
  } else {
    err = kv_int8 ? launch_mma_hd<int8_t>(hd, B, Hq / G, st, a)
                  : launch_mma_hd<__nv_bfloat16>(hd, B, Hq / G, st, a);
  }
  if (err != cudaSuccess || n_split == 1) return static_cast<int>(err);
  am::merge_kernel<__nv_bfloat16><<<dim3(Sq, Hq, B), hd, 0, st>>>(
      a.pm, a.pl, a.pacc, n_split, hd, out, o_sb, o_sh, o_ss);
  return static_cast<int>(cudaGetLastError());
}
