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
//   dK/dV: a cluster of two blocks per (key tile, kv head, row) shares
//     the sequence of (query head of the group, 16-query tile that meets the
//     key tile: the forward's skipping test at these tile sizes), each block
//     taking one half and accumulating dK and dV in registers; the second
//     block's sums reach the first through distributed shared memory and
//     are added in that order.  Halving the sequence halves the longest
//     block, where under the causal mask the first key tiles do 16x the
//     work of the last; the key tiles are issued in order, heaviest first;
//   dQ:    one block per (query tile, query head, row) loops over the
//     16-key tiles that meet it, accumulating dQ in registers; the last
//     (heaviest) query tiles are issued first.
// Each recomputes S and dP = d_out V^T for its pair of tiles.
//
// What bounds it on the card: 10 hd operations a valid pair and head (S,
// dP, dV, dK, dQ), 32.2 GFLOP at the training shape against ~0.1 GB of f32
// tensors: operations.  The training path is f32, and an f32 product on
// the CUDA cores peaks at 67 TFLOP/s; so every product runs on the tensor
// cores as 3xTF32 (flash_mma.cuh): three TF32 mma.sync each, at f32's
// precision, 495/3 TFLOP/s at the card's peak.  Four warps a block, each
// owning 16 of the block's 64 rows and their dK and dV (or dQ) in
// registers; the block's own rows stay in shared memory as f32, split into
// TF32 parts as the fragments are read; the streamed tiles arrive by
// cp.async into a staging tile while the previous tile is multiplied, and
// are split once into (hi, lo) pairs, since every warp reads them.  At
// head_dim 256 a block holds 32 rows: two warps share each 16 rows and
// split their 256 accumulator columns.  bf16 inputs take the same path,
// converted exactly to f32 as they are loaded.
#include <cooperative_groups.h>

#include "flash_mma.cuh"

namespace {

namespace cg = cooperative_groups;

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
  int vec;  // 1: f32 q, K, V, d_out rows on 16-byte boundaries (cp.async)
};

// Per head_dim: threads a block (four warps), rows a block holds (keys in
// the dK/dV kernel, queries in the dQ kernel; 16 a warp up to head_dim
// 128, 32 at 256, where two warps share each 16 rows and split the
// columns), accumulator columns a warp, rows of a streamed tile, and the
// shared memory: the block's own two tiles (f32), the two streamed tiles
// staged as they arrive (f32) and split ((hi, lo) pairs), and two buffers
// of the streamed lse and delta (dK/dV kernel).
template <int HD>
struct Cfg {
  static constexpr int NT = 128;
  static constexpr int RW = HD > 128 ? 32 : 64;
  static constexpr int WR = RW / 16;
  static constexpr int AW = HD * WR / (NT / 32);
  static constexpr int BS = 16;
  static constexpr int kSmemBytes =
      (2 * RW * HD + 2 * BS * HD) * 4 + 2 * BS * HD * 8 + 4 * BS * 4;
  static_assert(NT / 32 % WR == 0 && AW % 8 == 0 && BS % 8 == 0, "tiles");
};

using fm::acc_product;
using fm::kLog2e;
using fm::kScoreDepth;
using fm::rows_step;

// s = X Y^T and dp = X2 Y2^T for a warp's 16 rows of the block's tiles X,
// X2 against the BS rows of the pre-split streamed tiles Y, Y2
template <int HD, int BS>
__device__ __forceinline__ void scores(float (&s)[BS / 8][4],
                                       float (&dp)[BS / 8][4], const float* x,
                                       const float2* y, const float* x2,
                                       const float2* y2, int wr) {
#pragma unroll
  for (int n = 0; n < BS / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
  static_assert(HD % kScoreDepth == 0, "score k-steps");
  for (int kk = 0; kk < HD; kk += kScoreDepth) {
    rows_step<HD, BS>(s, x, y, wr, kk);
    rows_step<HD, BS>(dp, x2, y2, wr, kk);
  }
}

template <typename T, int HD>
__global__ void __cluster_dims__(2, 1, 1) __launch_bounds__(Cfg<HD>::NT)
    flash_dkdv_kernel(BwdArgs a) {
  using C = Cfg<HD>;
  constexpr int RW = C::RW, BS = C::BS, AW = C::AW, NT = C::NT;
  cg::cluster_group cluster = cg::this_cluster();
  const int half = cluster.block_rank();  // blockIdx.x % 2
  const int hk = blockIdx.x / 2, b = blockIdx.y, k0 = blockIdx.z * RW;
  const int nk = min(RW, a.Skv - k0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wr = (warp % C::WR) * 16, wc = (warp / C::WR) * AW;
  extern __shared__ __align__(16) float smem[];
  float* k_s = smem;
  float* v_s = k_s + RW * HD;
  float* q_raw = v_s + RW * HD;  // the next query tile as it arrives
  float* do_raw = q_raw + BS * HD;
  float2* q2 = reinterpret_cast<float2*>(do_raw + BS * HD);  // split
  float2* do2 = q2 + BS * HD;
  float* lse_s = reinterpret_cast<float*>(do2 + BS * HD);  // two buffers
  float* dl_s = lse_s + 2 * BS;

  fm::load_tile<T, HD, RW, NT>(
      k_s, static_cast<const T*>(a.k) + b * a.k_sb + hk * a.k_sh +
               (long long)k0 * a.k_ss, a.k_ss, nk, a.vec);
  fm::load_tile<T, HD, RW, NT>(
      v_s, static_cast<const T*>(a.v) + b * a.v_sb + hk * a.v_sh +
               (long long)k0 * a.v_ss, a.v_ss, nk, a.vec);
  // the query tiles that meet the key tile: [lo, hi) (an interval under
  // the causal and window masks)
  int lo = 0;
  while (lo < a.Sq && !fa::tile_needed<BS, RW>(lo, k0, a.causal, a.window))
    lo += BS;
  int hi = lo;
  while (hi < a.Sq && fa::tile_needed<BS, RW>(hi, k0, a.causal, a.window))
    hi += BS;
  // this block's half of the group's (head, query tile) sequence
  const int nt = (hi - lo) / BS, mid = (a.G * nt + 1) / 2;
  const int first = half ? mid : 0, total = half ? a.G * nt : mid;

  // query tile `it` of the group's (head, tile) sequence: q and d_out into
  // the staging tiles, lse and delta into buffer it & 1
  auto issue = [&](int it) {
    const int buf = it & 1, h = hk * a.G + it / nt, q0 = lo + it % nt * BS;
    const int nq = min(BS, a.Sq - q0);
    fm::load_raw<T, HD, BS, NT>(q_raw, static_cast<const T*>(a.q) +
                                           b * a.q_sb + h * a.q_sh +
                                           (long long)q0 * a.q_ss,
                                a.q_ss, nq, a.vec);
    fm::load_raw<T, HD, BS, NT>(do_raw, static_cast<const T*>(a.dout) +
                                            b * a.do_sb + h * a.do_sh +
                                            (long long)q0 * a.do_ss,
                                a.do_ss, nq, a.vec);
    const int i = threadIdx.x;
    if (i < BS) {
      const long long row =
          ((long long)b * a.Hq + h) * a.Sq + q0 + (i < nq ? i : 0);
      am::cp4(lse_s + buf * BS + i, a.lse + row, i < nq);
      am::cp4(dl_s + buf * BS + i, a.delta + row, i < nq);
    }
  };
  if (first < total) issue(first);
  am::commit();  // with the key tile

  float dk[AW / 8][4], dv[AW / 8][4];
#pragma unroll
  for (int n = 0; n < AW / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;

  for (int it = first; it < total; ++it) {
    am::wait<0>();  // this thread's copies of tile it landed
    fm::split_own<HD, BS, NT>(q2, q_raw);
    fm::split_own<HD, BS, NT>(do2, do_raw);
    __syncthreads();  // the split tiles (and lse, the key tile) are whole
    if (it + 1 < total) issue(it + 1);  // over the chunks this thread split
    am::commit();
    const int buf = it & 1, q0 = lo + it % nt * BS;
    const float* ls = lse_s + buf * BS;
    const float* dls = dl_s + buf * BS;
    // S^T = K q^T and dP^T = V d_out^T: rows keys, columns queries
    float s[BS / 8][4], dp[BS / 8][4];
    scores<HD, BS>(s, dp, k_s, q2, v_s, do2, wr);
    // P^T and dS^T; no mask where every pair of the warp's rows is valid
    const int j0 = k0 + wr;
    const bool whole = j0 + 15 < a.Skv && q0 + BS <= a.Sq &&
                       (!a.causal || j0 + 15 <= q0) &&
                       (a.window <= 0 || j0 > q0 + BS - 1 - a.window);
#pragma unroll
    for (int n = 0; n < BS / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int il = n * 8 + 2 * t + (e & 1), i = q0 + il;
        const int j = j0 + g + (e >> 1) * 8;
        const bool ok = whole || (i < a.Sq && j < a.Skv &&
                                  fa::pair_ok(i, j, a.causal, a.window));
        const float x = (s[n][e] * a.scale - ls[il]) * kLog2e;
        const float p = ok ? exp2f(x) : 0.f;
        dp[n][e] = p * (dp[n][e] - dls[il]);
        s[n][e] = p;
      }
    acc_product<HD, BS, AW>(dv, s, do2, wc);  // dV += P^T d_out
    acc_product<HD, BS, AW>(dk, dp, q2, wc);  // dK += dS^T q
    __syncthreads();  // the split tiles and lse buffer are free
  }
  am::wait<0>();
  __syncthreads();  // every copy landed, every warp is done with the key tile

  // the second half's dK and dV go to its shared memory (over the key tile),
  // and the first half adds them to its own
  // in that order and writes the sums: no atomics, the same bits every run
  constexpr int kAcc = AW / 8 * 4;  // accumulators a thread, of dK and of dV
  static_assert(2 * kAcc * NT <= 2 * RW * HD, "partials fit the key tile");
  if (half) {
#pragma unroll
    for (int n = 0; n < AW / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        k_s[(n * 4 + e) * NT + threadIdx.x] = dk[n][e];
        k_s[(kAcc + n * 4 + e) * NT + threadIdx.x] = dv[n][e];
      }
  }
  cluster.sync();  // (a) the partials are written
  if (!half) {
    const float* other = cluster.map_shared_rank(k_s, 1);
    T* dkb = static_cast<T*>(a.dk) + b * a.dk_sb + hk * a.dk_sh;
    T* dvb = static_cast<T*>(a.dv) + b * a.dv_sb + hk * a.dv_sh;
#pragma unroll
    for (int n = 0; n < AW / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = k0 + wr + g + (e >> 1) * 8;
        const int c = wc + n * 8 + 2 * t + (e & 1);
        const float sk = dk[n][e] + other[(n * 4 + e) * NT + threadIdx.x];
        const float sv =
            dv[n][e] + other[(kAcc + n * 4 + e) * NT + threadIdx.x];
        if (j < a.Skv) {
          dkb[(long long)j * a.dk_ss + c] = rt::from_f<T>(sk * a.scale);
          dvb[(long long)j * a.dv_ss + c] = rt::from_f<T>(sv);
        }
      }
  }
  cluster.sync();  // (b) the first half is done reading
}

template <typename T, int HD>
__global__ void __launch_bounds__(Cfg<HD>::NT) flash_dq_kernel(BwdArgs a) {
  using C = Cfg<HD>;
  constexpr int RW = C::RW, BS = C::BS, AW = C::AW, NT = C::NT;
  const int h = blockIdx.x, b = blockIdx.y, hk = h / a.G;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * RW;  // the last tiles first
  const int nq = min(RW, a.Sq - q0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wr = (warp % C::WR) * 16, wc = (warp / C::WR) * AW;
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;
  float* do_s = q_s + RW * HD;
  float* k_raw = do_s + RW * HD;  // the next key tile as it arrives
  float* v_raw = k_raw + BS * HD;
  float2* k2 = reinterpret_cast<float2*>(v_raw + BS * HD);  // split
  float2* v2 = k2 + BS * HD;

  fm::load_tile<T, HD, RW, NT>(
      q_s, static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh +
               (long long)q0 * a.q_ss, a.q_ss, nq, a.vec);
  fm::load_tile<T, HD, RW, NT>(
      do_s, static_cast<const T*>(a.dout) + b * a.do_sb + h * a.do_sh +
                (long long)q0 * a.do_ss, a.do_ss, nq, a.vec);
  // lse and delta of the lane's two rows
  const int i0 = q0 + wr;
  float lse_r[2], dl_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = i0 + g + 8 * r;
    const long long row = ((long long)b * a.Hq + h) * a.Sq + i;
    lse_r[r] = i < a.Sq ? a.lse[row] : 0.f;
    dl_r[r] = i < a.Sq ? a.delta[row] : 0.f;
  }
  // the key tiles that meet the query tile: [lo, hi)
  int lo = 0;
  while (lo < a.Skv && !fa::tile_needed<RW, BS>(q0, lo, a.causal, a.window))
    lo += BS;
  int hi = lo;
  while (hi < a.Skv && fa::tile_needed<RW, BS>(q0, hi, a.causal, a.window))
    hi += BS;
  const int total = (hi - lo) / BS;

  const T* kb = static_cast<const T*>(a.k) + b * a.k_sb + hk * a.k_sh;
  const T* vb = static_cast<const T*>(a.v) + b * a.v_sb + hk * a.v_sh;
  auto issue = [&](int it) {
    const int k0 = lo + it * BS, nk = min(BS, a.Skv - k0);
    fm::load_raw<T, HD, BS, NT>(k_raw, kb + (long long)k0 * a.k_ss, a.k_ss,
                                nk, a.vec);
    fm::load_raw<T, HD, BS, NT>(v_raw, vb + (long long)k0 * a.v_ss, a.v_ss,
                                nk, a.vec);
  };
  if (total > 0) issue(0);
  am::commit();  // with the query tile

  float dq[AW / 8][4];
#pragma unroll
  for (int n = 0; n < AW / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[n][e] = 0.f;

  for (int it = 0; it < total; ++it) {
    am::wait<0>();
    fm::split_own<HD, BS, NT>(k2, k_raw);
    fm::split_own<HD, BS, NT>(v2, v_raw);
    __syncthreads();
    if (it + 1 < total) issue(it + 1);
    am::commit();
    const int k0 = lo + it * BS;
    // S = q K^T and dP = d_out V^T: rows queries, columns keys
    float s[BS / 8][4], dp[BS / 8][4];
    scores<HD, BS>(s, dp, q_s, k2, do_s, v2, wr);
    const bool whole = i0 + 15 < a.Sq && k0 + BS <= a.Skv &&
                       (!a.causal || k0 + BS - 1 <= i0) &&
                       (a.window <= 0 || k0 > i0 + 15 - a.window);
#pragma unroll
    for (int n = 0; n < BS / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1, i = i0 + g + 8 * r;
        const int j = k0 + n * 8 + 2 * t + (e & 1);
        const bool ok = whole || (i < a.Sq && j < a.Skv &&
                                  fa::pair_ok(i, j, a.causal, a.window));
        const float x = (s[n][e] * a.scale - lse_r[r]) * kLog2e;
        const float p = ok ? exp2f(x) : 0.f;
        s[n][e] = p * (dp[n][e] - dl_r[r]);  // dS
      }
    acc_product<HD, BS, AW>(dq, s, k2, wc);  // dQ += dS K
    __syncthreads();
  }
  am::wait<0>();

  T* dqb = static_cast<T*>(a.dq) + b * a.dq_sb + h * a.dq_sh;
#pragma unroll
  for (int n = 0; n < AW / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = i0 + g + (e >> 1) * 8;
      if (i < a.Sq)
        dqb[(long long)i * a.dq_ss + wc + n * 8 + 2 * t + (e & 1)] =
            rt::from_f<T>(dq[n][e] * a.scale);
    }
}

template <typename T, int HD>
cudaError_t launch(int B, int Hkv, cudaStream_t st, const BwdArgs& a) {
  using C = Cfg<HD>;
  constexpr int kSmem = C::kSmemBytes;
  static rt::PerDevice smem_set1, smem_set2;
  const cudaError_t attr1 = smem_set1.get(
      [&] { return fa::allow_smem(flash_dkdv_kernel<T, HD>, kSmem); });
  const cudaError_t attr2 = smem_set2.get(
      [&] { return fa::allow_smem(flash_dq_kernel<T, HD>, kSmem); });
  if (attr1 != cudaSuccess) return attr1;
  if (attr2 != cudaSuccess) return attr2;
  // the key (query) tiles on the slowest grid axis: issued in order
  const dim3 g_kv(2 * Hkv, B, (a.Skv + C::RW - 1) / C::RW);
  flash_dkdv_kernel<T, HD><<<g_kv, C::NT, kSmem, st>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 g_q(a.Hq, B, (a.Sq + C::RW - 1) / C::RW);
  flash_dq_kernel<T, HD><<<g_q, C::NT, kSmem, st>>>(a);
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
            causal, window, scale, 0};
  a.vec = dtype == 0 && fm::rows16(q, q_sb, q_sh, q_ss) &&
          fm::rows16(k, k_sb, k_sh, k_ss) &&
          fm::rows16(v, v_sb, v_sh, v_ss) &&
          fm::rows16(dout, do_sb, do_sh, do_ss);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      dtype == 0 ? launch_hd<float>(hd, B, Hq / G, st, a)
                 : launch_hd<__nv_bfloat16>(hd, B, Hq / G, st, a);
  return static_cast<int>(err);
}
