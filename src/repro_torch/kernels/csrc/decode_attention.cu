// Single-token GQA decode attention over the slot-pool KV ring, split-KV.
//
// Replaces the Pallas TPU kernel repro/kernels/decode_attention.py
// (decode_attention, _decode_kernel): for each row b and query head h,
//   out = softmax_j(q . K_j / sqrt(hd) masked) @ V
// over the first S ring slots, where slot j is valid when
//   0 <= slot_pos[b, j] <= cur_pos[b]  (and > cur_pos[b] - window).
// Int8 K/V are dequantised in the kernel by their per-(slot, kv head) f32
// scale, so the device-memory stream stays one byte an element.
//
// What bounds it on the card: bytes.  A decode step reads the live ring
// prefix of every row once and does about G FLOPs per bf16 K/V byte (3 for
// llama3.2-3b, 16 for recurrentgemma-9b), below the H100's ~295 FLOP/byte
// ridge.  Reaching the bytes bound needs the whole card streaming, with
// ~25 KB in flight per SM.  The design:
//   * split-KV (flash-decoding): the grid is (kv head, row, split), each
//     block scoring the G query heads of its group (so a K/V row is read
//     once per group) over one contiguous run of 64-slot tiles, and writing
//     f32 partials (running max m, sum l, unnormalised accumulator) when
//     there is more than one split.  am::merge_kernel, one block per
//     (query head, row), combines them in a fixed order, so a call gives
//     the same bits every time.  The split count comes from the wrapper
//     (ops.decode_splits, shapes only: one full round of resident blocks
//     where the partials' traffic allows it; more only add merge traffic).
//     At recurrentgemma's MQA (Hkv 1) that is 8 blocks a row: one a row
//     would leave 116 of the 132 SMs idle at 16 rows.
//   * bf16 queries (every serving call): a 4-warp block streams its tiles
//     through a 3-stage cp.async ring (2 at head_dim 256) of padded bf16 rows;
//     each warp takes 16 slots of a tile and scores the group's heads as
//     the 16 rows of an mma.sync.m16n8k16 A operand (rows past G are
//     zero), QK^T and PV on the tensor cores with f32 accumulation, the
//     online softmax in f32 registers.  The four warps' states are merged
//     in shared memory at the end.  One barrier a tile (two for int8, whose
//     tile is converted to bf16 in shared memory: int8 values are exact in
//     bf16, the K scale multiplies the f32 scores, the V scale is folded
//     into P).  P enters PV as three bf16 parts, and each tile's PV
//     products are added to the output with round-to-nearest, so the
//     output carries f32's error, as the plain version's does (see
//     attn_mma.cuh's warp_tile).
//   * f32 queries (the small f32 serves and the card tests' 1e-4 checks):
//     the CUDA-core kernel of the first port, taken to a slot range, f32
//     throughout.
// Left for later work: TMA loads and wgmma.
#include "attn_mma.cuh"

namespace {

constexpr int kGMax = 16;   // query heads per kv head the kernel takes
constexpr int kTile = 64;   // ring slots a split is made of (ops.DECODE_TILE)
constexpr int kWarps = 4;   // tensor-core kernel: 16 slots of a tile a warp
constexpr int kNT = 32 * kWarps;

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
  float* pm;    // partials (B, Hq, n_split), or null: write out
  float* pl;    // (B, Hq, n_split)
  float* pacc;  // (B, Hq, n_split, hd)
  int S, G, window, n_split;
  float scale;
};

// Slots [lo, hi) of split z: tiles [z T / n, (z + 1) T / n) of the T
// 64-slot tiles of the first S slots (ref.split_bounds).
__device__ __forceinline__ void split_range(const DecodeArgs& a, int z,
                                            int& lo, int& hi) {
  const long long T = (a.S + kTile - 1) / kTile;
  lo = static_cast<int>(z * T / a.n_split) * kTile;
  hi = min(a.S, static_cast<int>((z + 1) * T / a.n_split) * kTile);
}

// One output (or partial) row element: the merged state of query head hq.
template <typename T>
__device__ __forceinline__ void emit(const DecodeArgs& a, int b, int hq,
                                     int d, int hd, float m, float l,
                                     float acc) {
  if (a.pm != nullptr) {
    const long long i =
        (static_cast<long long>(b) * gridDim.x * a.G + hq) * a.n_split +
        blockIdx.z;
    if (d == 0) {
      a.pm[i] = m;
      a.pl[i] = l;
    }
    a.pacc[i * hd + d] = acc;
  } else {
    static_cast<T*>(a.out)[b * a.o_sb + hq * a.o_sh + d] =
        rt::from_f<T>(acc / fmaxf(l, 1e-30f));
  }
}

// ---- f32 queries: CUDA cores ------------------------------------------------
// Block (HD threads) = one (kv head, row, split).  Thread t owns output
// column t of every query head in the group.  A tile holds 64 / sizeof(KV)
// ring slots up to hd 128 (16 of f32, 64 of int8: 8 KB of K and 8 KB of V
// at hd = 128), half as many at hd 256; the next tile's 16-byte vectors are
// loaded into registers while the current one is scored from shared memory.
template <typename T, typename KV, int HD>
__global__ void __launch_bounds__(HD) decode_kernel(DecodeArgs a) {
  constexpr int kWarpsF = HD / 32;
  constexpr int kPer = HD / 32;                  // K-row elements a lane scores
  constexpr int kVec = 16 / sizeof(KV);          // elements per 16-byte vector
  constexpr int kTileF = (HD >= 256 ? 32 : 64) / sizeof(KV);  // slots a tile
  constexpr int kRowVecs = HD / kVec;            // vectors per K/V row
  constexpr int kLoads = kTileF * kRowVecs / HD;  // vectors per thread
  constexpr int kSlots = (kTileF + HD - 1) / HD;  // slot scalars per thread
  static_assert(kTileF <= 64 && kTile % kTileF == 0, "tile shape");
  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int G = a.G;
  const bool quant = a.ks != nullptr;
  int lo, hi;
  split_range(a, blockIdx.z, lo, hi);

  __shared__ float q_s[kGMax][HD];
  __shared__ float p_s[kGMax][kTileF];
  __shared__ __align__(16) KV k_s[kTileF * HD];
  __shared__ __align__(16) KV v_s[kTileF * HD];
  __shared__ float ksc_s[kTileF], vsc_s[kTileF];
  __shared__ int sp_s[kTileF];
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
      if (slot < hi) {
        kr[i] = *reinterpret_cast<const uint4*>(kb + slot * a.k_ss + c * kVec);
        vr[i] = *reinterpret_cast<const uint4*>(vb + slot * a.v_ss + c * kVec);
      }
    }
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      const int jj = tid + s * HD;
      const long long slot = t0 + jj;
      if (jj < kTileF && slot < hi) {
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
  fetch(lo);

  for (int t0 = lo; t0 < hi; t0 += kTileF) {
    const int n = min(kTileF, hi - t0);
    __syncthreads();  // the previous tile's readers are done
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      reinterpret_cast<uint4*>(k_s)[tid + i * HD] = kr[i];
      reinterpret_cast<uint4*>(v_s)[tid + i * HD] = vr[i];
    }
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      const int jj = tid + s * HD;
      if (jj < kTileF) {
        sp_s[jj] = spr[s];
        ksc_s[jj] = ksr[s];
        vsc_s[jj] = vsr[s];
      }
    }
    __syncthreads();
    if (t0 + kTileF < hi) fetch(t0 + kTileF);  // in flight while we compute
    // scores: each warp takes whole slots, every lane kPer elements
    for (int j = warp; j < n; j += kWarpsF) {
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
    for (int g = warp; g < G; g += kWarpsF) {
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
#pragma unroll
  for (int g = 0; g < kGMax; ++g)
    if (g < G) emit<T>(a, b, h * G + g, tid, HD, m_s[g], l_s[g], acc[g]);
}

// ---- bf16 queries: tensor cores ---------------------------------------------
template <typename KV, int HD>
struct DecLayout {
  static constexpr bool kQuant = std::is_same<KV, int8_t>::value;
  static constexpr int kStages = HD >= 256 ? 2 : 3;
  static constexpr int kLd = am::ld<HD>();
  // a stage's K and V tile: padded bf16 rows, or packed int8 rows
  static constexpr int kTileBytes = kQuant ? kTile * HD : kTile * kLd * 2;
  static constexpr int kQ = 0;                                  // bf16 [16][LD]
  static constexpr int kWm = am::align16(kQ + 16 * kLd * 2);     // f32 [4][16]
  static constexpr int kWl = kWm + kWarps * 16 * 4;              // f32 [4][16]
  static constexpr int kPk = kWl + kWarps * 16 * 4;       // int [stages][64]
  static constexpr int kKs = kPk + kStages * kTile * 4;   // f32 [stages][64]
  static constexpr int kVs = kKs + kStages * kTile * 4;   // f32 [stages][64]
  static constexpr int kRing = am::align16(kVs + kStages * kTile * 4);
  static constexpr int kConv = kRing + 2 * kStages * kTileBytes;  // int8 only
  static constexpr int kConvBytes = kQuant ? 2 * kTile * kLd * 2 : 0;
  // after the loop the ring holds the warps' accumulators, f32 [4][16][HD]
  static constexpr int kRedBytes = kWarps * 16 * HD * 4;
  static constexpr int kBytes =
      kRing + (2 * kStages * kTileBytes + kConvBytes > kRedBytes
                   ? 2 * kStages * kTileBytes + kConvBytes
                   : kRedBytes);
};

template <typename KV, int HD>
__global__ void __launch_bounds__(kNT) decode_mma_kernel(DecodeArgs a) {
  using L = DecLayout<KV, HD>;
  using am::bf16;
  constexpr int LD = L::kLd, ST = L::kStages;
  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int G = a.G;
  int lo, hi;
  split_range(a, blockIdx.z, lo, hi);
  const int nt = (hi - lo + kTile - 1) / kTile;

  extern __shared__ __align__(16) unsigned char smem[];
  bf16* q_s = reinterpret_cast<bf16*>(smem + L::kQ);
  float* wm = reinterpret_cast<float*>(smem + L::kWm);
  float* wl = reinterpret_cast<float*>(smem + L::kWl);
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
  bf16* v_conv = k_conv + kTile * LD;

  // the group's G query heads as rows 0..G-1 of the A operand, the rest 0
  const bf16* qb = static_cast<const bf16*>(a.q) + b * a.q_sb;
  for (int i = tid; i < 16 * HD; i += kNT) {
    const int r = i / HD, d = i % HD;
    q_s[r * LD + d] = r < G ? qb[(long long)(h * G + r) * a.q_sh + d]
                            : __float2bfloat16(0.f);
  }
  const int cur = a.cur[b * a.cur_sb];
  const KV* kb = static_cast<const KV*>(a.k) + b * a.k_sb + h * a.k_sh;
  const KV* vb = static_cast<const KV*>(a.v) + b * a.v_sb + h * a.v_sh;
  const float* ksb = L::kQuant ? a.ks + b * a.ks_sb + h * a.ks_sh : nullptr;
  const float* vsb = L::kQuant ? a.vs + b * a.vs_sb + h * a.vs_sh : nullptr;
  const int* spb = a.sp + b * a.sp_sb;
  auto load = [&](int t) {
    const int st = t % ST, t0 = lo + t * kTile, n_ok = min(kTile, hi - t0);
    am::load_kv<KV, HD, kTile, kNT>(k_ring(st), v_ring(st), kb, a.k_ss, vb,
                                    a.v_ss, t0, n_ok);
    am::load_slots<kTile, kNT>(pk_s + st * kTile, ks_s + st * kTile,
                               vs_s + st * kTile, spb, a.sp_ss, ksb, a.ks_ss,
                               vsb, a.vs_ss, t0, n_ok);
  };
#pragma unroll
  for (int t = 0; t < ST - 1; ++t) {
    if (t < nt) load(t);
    am::commit();
  }

  am::Rows<HD> rows;
  rows.init();
  am::RowPos pos;
  pos.init(cur, cur, a.window);
  for (int t = 0; t < nt; ++t) {
    am::wait<ST - 2>();
    __syncthreads();  // tile t landed; every warp is done with tile t - 1
    if (t + ST - 1 < nt) load(t + ST - 1);
    am::commit();
    const int st = t % ST, n_ok = min(kTile, hi - (lo + t * kTile));
    const bf16* k_t;
    const bf16* v_t;
    if constexpr (L::kQuant) {
      am::to_bf16<HD, kTile, kNT>(k_conv, k_ring(st));
      am::to_bf16<HD, kTile, kNT>(v_conv, v_ring(st));
      __syncthreads();
      k_t = k_conv;
      v_t = v_conv;
    } else {
      k_t = k_ring(st);
      v_t = v_ring(st);
    }
    am::warp_tile<HD, 16, L::kQuant>(rows, q_s, k_t, v_t, warp * 16,
                                     pk_s + st * kTile, ks_s + st * kTile,
                                     vs_s + st * kTile, n_ok, pos, a.scale);
  }
  am::wait<0>();
  __syncthreads();  // the ring is free: it takes the warps' accumulators

  // merge the four warps' states (each over its own 16 slots of every tile)
  float* red = reinterpret_cast<float*>(smem + L::kRing);
#pragma unroll
  for (int r = 0; r < 2; ++r) rows.l[r] = am::quad_sum(rows.l[r]);
  if (t4 == 0) {
    wm[warp * 16 + g] = rows.m[0];
    wm[warp * 16 + g + 8] = rows.m[1];
    wl[warp * 16 + g] = rows.l[0];
    wl[warp * 16 + g + 8] = rows.l[1];
  }
  __syncthreads();
  float f[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float M = wm[g + 8 * r];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) M = fmaxf(M, wm[w * 16 + g + 8 * r]);
    f[r] = exp2f((rows.m[r] - M) * am::kLog2e);
  }
#pragma unroll
  for (int j = 0; j < HD / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      red[(warp * 16 + g + 8 * (e >> 1)) * HD + j * 8 + 2 * t4 + (e & 1)] =
          rows.o[j][e] * f[e >> 1];
  __syncthreads();
  for (int i = tid; i < G * HD; i += kNT) {
    const int r = i / HD, d = i % HD;
    float M = wm[r];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) M = fmaxf(M, wm[w * 16 + r]);
    float l = 0.f, acc = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      l += wl[w * 16 + r] * exp2f((wm[w * 16 + r] - M) * am::kLog2e);
      acc += red[(w * 16 + r) * HD + d];
    }
    emit<bf16>(a, b, h * G + r, d, HD, M, l, acc);
  }
}

template <typename KV>
cudaError_t launch_f32(int hd, dim3 grid, cudaStream_t st,
                       const DecodeArgs& a) {
  switch (hd) {
    case 32: decode_kernel<float, KV, 32><<<grid, 32, 0, st>>>(a); break;
    case 64: decode_kernel<float, KV, 64><<<grid, 64, 0, st>>>(a); break;
    case 128: decode_kernel<float, KV, 128><<<grid, 128, 0, st>>>(a); break;
    default: decode_kernel<float, KV, 256><<<grid, 256, 0, st>>>(a); break;
  }
  return cudaGetLastError();
}

template <typename KV, int HD>
cudaError_t launch_mma(dim3 grid, cudaStream_t st, const DecodeArgs& a) {
  constexpr int kSmem = DecLayout<KV, HD>::kBytes;
  static rt::PerDevice smem_set;
  const cudaError_t attr = smem_set.get(
      [&] { return am::allow_smem(decode_mma_kernel<KV, HD>, kSmem); });
  if (attr != cudaSuccess) return attr;
  decode_mma_kernel<KV, HD><<<grid, kNT, kSmem, st>>>(a);
  return cudaGetLastError();
}

template <typename KV>
cudaError_t launch_bf16(int hd, dim3 grid, cudaStream_t st,
                        const DecodeArgs& a) {
  switch (hd) {
    case 32: return launch_mma<KV, 32>(grid, st, a);
    case 64: return launch_mma<KV, 64>(grid, st, a);
    case 128: return launch_mma<KV, 128>(grid, st, a);
    default: return launch_mma<KV, 256>(grid, st, a);
  }
}

}  // namespace

// dtype: 0 = float32 (CUDA cores), 1 = bfloat16 (tensor cores) for q and
// out, and K/V unless kv_int8.  Strides are in elements; the head_dim stride
// of q, K, V and out is 1, and K/V rows start on 16-byte boundaries (checked
// by the wrapper).  Grid (Hkv, B, n_split).  With pm null, n_split must be 1
// and the kernel writes out; otherwise it writes the partials pm, pl (B, Hq,
// n_split) and pacc (B, Hq, n_split, hd), contiguous f32, and, when out is
// not null, am::merge_kernel writes out from them.  Returns cudaGetLastError()
// after the launches (0 = launched).
extern "C" int decode_attention_launch(
    int dtype, int kv_int8, int hd, int B, int Hkv, int S, int G, int window,
    int n_split, float scale, const void* q, long long q_sb, long long q_sh,
    const void* k, long long k_sb, long long k_ss, long long k_sh,
    const void* v, long long v_sb, long long v_ss, long long v_sh,
    const void* ks, long long ks_sb, long long ks_ss, long long ks_sh,
    const void* vs, long long vs_sb, long long vs_ss, long long vs_sh,
    const void* sp, long long sp_sb, long long sp_ss, const void* cur,
    long long cur_sb, void* out, long long o_sb, long long o_sh, void* pm,
    void* pl, void* pacc, void* stream) {
  const int tiles = (S + kTile - 1) / kTile;
  if ((hd != 32 && hd != 64 && hd != 128 && hd != 256) || G < 1 ||
      G > kGMax || S < 1 || n_split < 1 || n_split > tiles ||
      (pm == nullptr && (n_split != 1 || out == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  DecodeArgs a{q,  q_sb,  q_sh,  k,     k_sb,  k_ss,  k_sh,
               v,  v_sb,  v_ss,  v_sh,  static_cast<const float*>(ks),
               ks_sb, ks_ss, ks_sh, static_cast<const float*>(vs),
               vs_sb, vs_ss, vs_sh, static_cast<const int*>(sp),
               sp_sb, sp_ss, static_cast<const int*>(cur), cur_sb,
               out, o_sb, o_sh, static_cast<float*>(pm),
               static_cast<float*>(pl), static_cast<float*>(pacc),
               S, G, window, n_split, scale};
  const dim3 grid(Hkv, B, n_split);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = kv_int8 ? launch_f32<int8_t>(hd, grid, st, a)
                  : launch_f32<float>(hd, grid, st, a);
  else
    err = kv_int8 ? launch_bf16<int8_t>(hd, grid, st, a)
                  : launch_bf16<__nv_bfloat16>(hd, grid, st, a);
  if (err != cudaSuccess || pm == nullptr || out == nullptr)
    return static_cast<int>(err);
  const dim3 mgrid(1, Hkv * G, B);
  if (dtype == 0)
    am::merge_kernel<float><<<mgrid, hd, 0, st>>>(
        a.pm, a.pl, a.pacc, n_split, hd, out, o_sb, o_sh, 0);
  else
    am::merge_kernel<__nv_bfloat16><<<mgrid, hd, 0, st>>>(
        a.pm, a.pl, a.pacc, n_split, hd, out, o_sb, o_sh, 0);
  return static_cast<int>(cudaGetLastError());
}
