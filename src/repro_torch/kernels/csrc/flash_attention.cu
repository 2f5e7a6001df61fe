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
// (flash_attention_bwd.cu) recomputes the probabilities from.  Which keys
// a query meets follows the reference's tile test at 32-query and 32-key
// tiles: a key of a tile the test skips carries no weight, an invalid key
// of a tile it keeps the reference's -1e30, so a query with no valid key
// (only where Sq > Skv + window - 1) averages V over the keys of its kept
// tiles, and one whose tiles were all skipped gets out 0 and lse +inf.
//
// What bounds it on the card: at the training shape (B 2, 24/8 heads of
// 128, S 1024, causal) the valid pairs need 12.9 GFLOP against 67 MB of
// f32 q/k/v/out, far above the ridge, so operations bound it.  Training is
// f32, and an f32 product on the CUDA cores peaks at 67 TFLOP/s, so both
// products, S = q K^T and O += P V, run on the tensor cores as 3xTF32
// (flash_mma.cuh, as the backward): three TF32 mma.sync each, at f32's
// precision, each k-step through a fresh fragment added to the sum with
// round-to-nearest.  One block of four warps per (64-query tile, query
// head, row), the last (heaviest under the causal mask) query tiles issued
// first; each warp owns 16 query rows, their scores and their output in
// registers, so the online softmax runs in registers: row max and sum are
// quad shuffles, the score accumulator becomes P as the A operand of PV
// without leaving the registers, and no barrier runs per row.  The query
// tile stays in shared memory as f32, split into TF32 parts as the
// fragments are read; the key and value tiles arrive by cp.async into a
// staging tile while the previous tile is multiplied and are split once
// into (hi, lo) pairs, since every warp reads them.  They hold 16 rows, so
// two blocks fit an SM (80 KB of shared memory at head_dim 128; 32-row
// tiles, one block an SM, took 1.57x the time: PERF.md).  The key tiles
// the test skips are never loaded (a causal row reads about half of K/V, a
// windowed one only its window).  At head_dim 256 a block holds 32 rows:
// two warps share each 16 rows and split their 256 output columns.  bf16
// inputs take the same path, converted exactly to f32 as they are loaded.
#include "flash_mma.cuh"

namespace {

using fm::acc_product;
using fm::kLog2e;
using fm::kScoreDepth;
using fm::rows_step;

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
  int vec;  // 1: f32 q, K, V rows on 16-byte boundaries (cp.async)
};

// Per head_dim: threads a block (four warps), query rows a block holds (16
// a warp up to head_dim 128, 32 at 256, where two warps share each 16 rows
// and split the columns), output columns a warp, rows of a streamed key
// tile, and the shared memory: the query tile (f32), the streamed K and V
// tiles staged as they arrive (f32) and split ((hi, lo) pairs).
template <int HD>
struct Cfg {
  static constexpr int NT = 128;
  static constexpr int RW = HD > 128 ? 32 : 64;
  static constexpr int WR = RW / 16;
  static constexpr int AW = HD * WR / (NT / 32);
  static constexpr int BS = 16;
  static constexpr int kSmemBytes =
      (RW * HD + 2 * BS * HD) * 4 + 2 * BS * HD * 8;
  static_assert(NT / 32 % WR == 0 && AW % 8 == 0 && fa::kT % BS == 0 &&
                    RW % fa::kT == 0,
                "tiles");
};

// The reference's -1e30 for an invalid key of a kept tile, in the log2
// units the softmax runs in
constexpr float kMaskedLog2 = rt::kNegInf * kLog2e;

template <typename T, int HD>
__global__ void __launch_bounds__(Cfg<HD>::NT) flash_fwd_kernel(FwdArgs a) {
  using C = Cfg<HD>;
  constexpr int RW = C::RW, BS = C::BS, AW = C::AW, NT = C::NT;
  constexpr int kT = fa::kT;
  const int h = blockIdx.x, b = blockIdx.y, hk = h / a.G;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * RW;  // the last tiles first
  const int nq = min(RW, a.Sq - q0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wr = (warp % C::WR) * 16, wc = (warp / C::WR) * AW;
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;
  float* k_raw = q_s + RW * HD;  // the next key tile as it arrives
  float* v_raw = k_raw + BS * HD;
  float2* k2 = reinterpret_cast<float2*>(v_raw + BS * HD);  // split
  float2* v2 = k2 + BS * HD;

  fm::load_tile<T, HD, RW, NT>(
      q_s, static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh +
               (long long)q0 * a.q_ss, a.q_ss, nq, a.vec);
  // the key tiles whose 32-key tile the reference's test keeps for one of
  // the block's 32-query tiles: [lo, hi) (an interval under the causal and
  // window masks)
  auto kept = [&](int k0) {
    return fa::tile_needed<RW, kT>(q0, k0 - k0 % kT, a.causal, a.window);
  };
  int lo = 0;
  while (lo < a.Skv && !kept(lo)) lo += BS;
  int hi = lo;
  while (hi < a.Skv && kept(hi)) hi += BS;

  const T* kb = static_cast<const T*>(a.k) + b * a.k_sb + hk * a.k_sh;
  const T* vb = static_cast<const T*>(a.v) + b * a.v_sb + hk * a.v_sh;
  auto issue = [&](int k0) {
    const int nk = min(BS, a.Skv - k0);
    fm::load_raw<T, HD, BS, NT>(k_raw, kb + (long long)k0 * a.k_ss, a.k_ss,
                                nk, a.vec);
    fm::load_raw<T, HD, BS, NT>(v_raw, vb + (long long)k0 * a.v_ss, a.v_ss,
                                nk, a.vec);
  };
  if (lo < hi) issue(lo);
  am::commit();  // with the query tile

  // the lane's rows i0 + g and i0 + g + 8: running max (log2 units) and
  // the lane's part of the running sum (its columns; the quad's parts are
  // added at the end)
  const int i0 = q0 + wr, qt = i0 - i0 % kT;  // the warp's 32-query tile
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float acc[AW / 8][4];
#pragma unroll
  for (int n = 0; n < AW / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  const float sl2 = a.scale * kLog2e;

  for (int k0 = lo; k0 < hi; k0 += BS) {
    am::wait<0>();  // this thread's copies of the tile landed
    fm::split_own<HD, BS, NT>(k2, k_raw);
    fm::split_own<HD, BS, NT>(v2, v_raw);
    __syncthreads();  // the split tiles (and the query tile) are whole
    if (k0 + BS < hi) issue(k0 + BS);  // over the chunks this thread split
    am::commit();
    // S = q K^T: rows queries, columns keys
    float s[BS / 8][4];
#pragma unroll
    for (int n = 0; n < BS / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
    static_assert(HD % kScoreDepth == 0, "score k-steps");
    for (int kk = 0; kk < HD; kk += kScoreDepth)
      rows_step<HD, BS>(s, q_s, k2, wr, kk);
    // scaled to log2 units and masked; no mask where every pair of the
    // warp's rows is valid
    const bool whole = i0 + 15 < a.Sq && k0 + BS <= a.Skv &&
                       (!a.causal || k0 + BS - 1 <= i0) &&
                       (a.window <= 0 || k0 > i0 + 15 - a.window);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < BS / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e] * sl2;
        if (!whole) {
          const int i = i0 + g + (e >> 1) * 8;
          const int j = k0 + n * 8 + 2 * t + (e & 1);
          if (i >= a.Sq || j >= a.Skv ||
              !fa::tile_needed(qt, j - j % kT, a.causal, a.window))
            x = -INFINITY;  // no weight at all
          else if (!fa::pair_ok(i, j, a.causal, a.window))
            x = kMaskedLog2;
        }
        s[n][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    // online softmax over the quad's 4 lanes of each row
    float corr[2], base[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = am::quad_max(mx[r]);
      base[r] = mx[r] == -INFINITY ? 0.f : mx[r];  // a row with no weight yet
      corr[r] = exp2f(m[r] - base[r]);
      m[r] = mx[r];
      l[r] *= corr[r];
    }
#pragma unroll
    for (int n = 0; n < BS / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(s[n][e] - base[e >> 1]);
        s[n][e] = p;
        l[e >> 1] += p;
      }
#pragma unroll
    for (int n = 0; n < AW / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] *= corr[e >> 1];
    acc_product<HD, BS, AW>(acc, s, v2, wc);  // O += P V
    __syncthreads();  // the split tiles are free
  }
  am::wait<0>();

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] = am::quad_sum(l[r]);
    inv[r] = l[r] > 0.f ? 1.f / l[r] : 0.f;
  }
  T* ob = static_cast<T*>(a.out) + b * a.o_sb + h * a.o_sh;
#pragma unroll
  for (int n = 0; n < AW / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = i0 + g + (e >> 1) * 8;
      if (i < a.Sq)
        ob[(long long)i * a.o_ss + wc + n * 8 + 2 * t + (e & 1)] =
            rt::from_f<T>(acc[n][e] * inv[e >> 1]);
    }
  if (a.lse != nullptr && wc == 0 && t == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = i0 + g + 8 * r;
      // a row that met no tile has no probabilities: +inf gives them 0
      if (i < a.Sq)
        a.lse[((long long)b * a.Hq + h) * a.Sq + i] =
            l[r] > 0.f ? m[r] * (1.f / kLog2e) + logf(l[r]) : INFINITY;
    }
  }
}

template <typename T, int HD>
cudaError_t launch(int B, cudaStream_t st, const FwdArgs& a) {
  using C = Cfg<HD>;
  static rt::PerDevice smem_set;
  const cudaError_t attr = smem_set.get(
      [&] { return fa::allow_smem(flash_fwd_kernel<T, HD>, C::kSmemBytes); });
  if (attr != cudaSuccess) return attr;
  // the query tiles on the slowest grid axis: issued in order
  const dim3 grid(a.Hq, B, (a.Sq + C::RW - 1) / C::RW);
  flash_fwd_kernel<T, HD><<<grid, C::NT, C::kSmemBytes, st>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_hd(int hd, int B, cudaStream_t st, const FwdArgs& a) {
  switch (hd) {
    case 32: return launch<T, 32>(B, st, a);
    case 64: return launch<T, 64>(B, st, a);
    case 128: return launch<T, 128>(B, st, a);
    default: return launch<T, 256>(B, st, a);
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
      Hq < 1 || Hq % G != 0 || Sq < 1 || Skv < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  FwdArgs a{q,   q_sb, q_sh, q_ss, k,  k_sb,   k_sh,
            k_ss, v,   v_sb, v_sh, v_ss, out, o_sb,
            o_sh, o_ss, static_cast<float*>(lse), Hq, Sq, Skv, G,
            causal, window, scale, 0};
  a.vec = dtype == 0 && fm::rows16(q, q_sb, q_sh, q_ss) &&
          fm::rows16(k, k_sb, k_sh, k_ss) &&
          fm::rows16(v, v_sb, v_sh, v_ss);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = dtype == 0
                              ? launch_hd<float>(hd, B, st, a)
                              : launch_hd<__nv_bfloat16>(hd, B, st, a);
  return static_cast<int>(err);
}
