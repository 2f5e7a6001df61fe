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
// operations), and for a prefill the sequential dependency over the
// tokens: ~6 D^2 operations a token per (row, head), far below either
// peak, but token by token every step waits for the previous one, and B H
// (32 for one rwkv6-1.6b row) blocks leave most of the card's 132 SMs idle.
// So, as the TPU kernel, a prefill goes in chunks of 32 tokens in the
// stable pairwise log-space form: with L the inclusive cumulative sum of w
// within the chunk (so L_{t-1} is the exclusive one), from the chunk's
// start state S0,
//   o_t = (r_t e^{L_{t-1}}) S0 + sum_{s<t} (sum_d r_t k_s e^{L_{t-1} - L_s})
//         v_s + (sum_d r_t u k_t) v_t,
//   S_end = e^{L_T} S0 + U,   U = sum_s (k_s e^{L_T - L_s})^T v_s,
// where every exponent is <= 0 (w is a log decay): no positive cumulative
// sum is exponentiated, which with strongly negative w would overflow f32
// within a chunk.  The chunks depend on each other only through S0, and a
// chunk's S0 is the earlier chunks' (U, e^{L_T}) folded in order into
// state0.  So wkv6_kernel runs one block per (chunk, head, row): each
// computes its chunk's pairwise weights and (U, e^{L_T}), publishes the
// pair (all but the last chunk) with a flag, waits for the earlier chunks'
// flags, folds their pairs into S0 (every block of a head folds the same
// pairs in the same order, so the carried state is the same bits in each)
// and writes its outputs; the last chunk's block writes the final state.
// A block takes its tile from an atomic counter in chunk order, so it only
// ever waits for blocks that started before it: no deadlock, whatever the
// hardware's block order (chunk_order.cuh, shared with rglru_scan.cu).  A
// 512-token prefill of one row runs 32 x 16 blocks, not 32; its sequential
// part is a fold of at most 15 D x D pairs, not 512 dependent token steps;
// and one launch does it all (a separate kernel for the pairs cost its own
// time and a launch gap, PERF.md).
// Shared memory holds the chunk's r, k, v and L (rows padded by 4 floats:
// rows 8 apart fall in distinct banks), S0 and the T x T pairwise weights;
// 8 D threads a block.  A weight takes two threads, each summing every
// other d, so the 528 weights of a chunk spread evenly.  Everything is f32
// on the CUDA cores (~0.5 GFLOP and 16 M exponentials at S 512, B H 32).
// Ragged last chunks are masked by their token count, not padded.  A
// decode step (S = 1) takes wkv6_step_kernel: one block per (head, row),
// each thread writing its part of the new state as soon as its part of the
// old one has arrived, one barrier for the output's sum over d.
#include "chunk_order.cuh"
#include "common.cuh"

namespace {

constexpr int kT = 32;  // tokens a chunk
constexpr float kLog2e = 1.4426950408889634f;

struct WkvArgs {
  const void* r;
  long long r_sb, r_sh, r_ss;
  const void* k;
  long long k_sb, k_sh, k_ss;
  const void* v;
  long long v_sb, v_sh, v_ss;
  const float* w;
  long long w_sb, w_sh, w_ss;
  const void* u;
  long long u_sb, u_sh;
  const float* s0;
  long long s0_sb, s0_sh, s0_sd;
  void* out;
  long long o_sb, o_sh, o_ss;
  float* s_out;
  // (B H, nc - 1, D D + D): each chunk but the last's U (D x D) and
  // e^{L_T} (D), or null when there is one chunk
  float* part;
  // with nc > 1: the tile counter (the tiles of earlier launches are
  // tile_base), and a flag per (row, head, chunk), set to epoch once the
  // chunk's pair is in part
  unsigned long long* tiles;
  long long tile_base;
  int* flags;
  int epoch;
  int H, S, nc, R;  // R: rows of a chunk tile, min(kT, S)
  int u_f32;        // 1: u is float32, 0: u has r's dtype
  int s0_vec;       // 1: state0's rows start on 16-byte boundaries
};

// Element off of u, in f32
template <typename T>
__device__ __forceinline__ float u_at(const WkvArgs& a, long long off) {
  return a.u_f32 ? static_cast<const float*>(a.u)[off]
                 : rt::to_f(static_cast<const T*>(a.u)[off]);
}

// Columns [c, c + 4) of state0's row d of (row b, head h), or zeros
__device__ __forceinline__ float4 state0_quad(const WkvArgs& a, int b, int h,
                                              int d, int c) {
  if (a.s0 == nullptr) return make_float4(0.f, 0.f, 0.f, 0.f);
  const float* p = a.s0 + b * a.s0_sb + h * a.s0_sh + d * a.s0_sd + c;
  return a.s0_vec ? *reinterpret_cast<const float4*>(p)
                  : make_float4(p[0], p[1], p[2], p[3]);
}

// 2^x, to f32's precision; 0 where it would be subnormal
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Per D and NT threads a block: the padded row of a chunk tile; 4-column
// quads of a row; row groups and state rows a thread (it owns quad tid % Q
// of rows SR (tid / Q) + j); segments of the cumulative sum (thread tid
// sums rows [RS (tid / D), RS (tid / D + 1)) of column tid % D); threads a
// row of the pairwise weights (TPR / 2 columns at a time, two threads each).
template <int D, int NT = 8 * D>
struct Cfg {
  static constexpr int LD = D + 4;
  static constexpr int Q = D / 4;
  static constexpr int RG = NT / Q;
  static constexpr int SR = D / RG;
  static constexpr int NSEG = NT / D;
  static constexpr int RS = kT / NSEG;
  static constexpr int TPR = NT / kT;
  static_assert(D % RG == 0 && kT % NSEG == 0 && TPR % 2 == 0, "shape");
};

template <int D>
__host__ __device__ constexpr int part_floats() {
  return D * D + D;
}

// Shared memory of wkv6_kernel at R rows a chunk tile: r, k, v, w then L,
// S0, u, and the pairwise weights (whose space first holds the segment
// sums, doubles)
template <int D>
__host__ __device__ constexpr int smem_floats(int R) {
  return 4 * R * Cfg<D>::LD + D * D + D +
         (R * (R + 1) > 2 * Cfg<D>::NSEG * D ? R * (R + 1)
                                              : 2 * Cfg<D>::NSEG * D);
}

// Rows [0, n) of a chunk tile from global memory (row stride ss, unit
// column stride) into dst[..][ld] as f32.
template <typename T, int D>
__device__ __forceinline__ void load_rows(float* dst, int ld, const T* src,
                                          long long ss, int n) {
  for (int idx = threadIdx.x; idx < n * D; idx += 8 * D) {
    const int t = idx / D, d = idx % D;
    dst[t * ld + d] = rt::to_f(src[t * ss + d]);
  }
}

// In place over rows [0, n): w into its inclusive cumulative sum L in log2
// units, summed in double and rounded once to f32.  By NSEG segments of RS
// rows: each segment's sum into seg, then each segment's running sum from
// the sum of the segments before it.  Starts and ends with the block's
// threads in step.  (L kept to f32 is the reference's own arithmetic: its
// chunked form, as the Pallas kernel and the model's plain path, takes
// differences of f32 cumulative sums.  Where strong decays earlier in a
// chunk push L far below 0, such a difference loses f32's precision to
// the rounding of L (PERF.md); tools/rwkv6_scan_pair_l.cu keeps L as a
// pair of floats, at f32's precision there.)
template <int D>
__device__ __forceinline__ void cumsum(float* l, double* seg, int n) {
  using C = Cfg<D>;
  constexpr double kLog2eD = 1.4426950408889634;
  const int d = threadIdx.x % D, sg = threadIdx.x / D;
  const int t0 = sg * C::RS, t1 = min(t0 + C::RS, n);
  __syncthreads();  // w is whole
  double acc = 0.0;
  for (int t = t0; t < t1; ++t) acc += l[t * C::LD + d];
  seg[sg * D + d] = acc;
  __syncthreads();
  acc = 0.0;
  for (int g = 0; g < sg; ++g) acc += seg[g * D + d];
  for (int t = t0; t < t1; ++t) {
    acc += l[t * C::LD + d];
    l[t * C::LD + d] = static_cast<float>(acc * kLog2eD);
  }
  __syncthreads();
}

// One block per (chunk, head, row), in tiles taken in chunk order: the
// chunk's pair (U, e^{L_T}), its start state, its outputs, and for the last
// chunk the final state
template <typename T, int D>
__global__ void __launch_bounds__(8 * D) wkv6_kernel(WkvArgs a) {
  using C = Cfg<D>;
  constexpr int LD = C::LD, Q = C::Q, SR = C::SR, TPR = C::TPR;
  constexpr int NT = 8 * D;
  const int tid = threadIdx.x, q = tid % Q, d0 = SR * (tid / Q);
  const int tile = a.nc > 1 ? chunk_order::take_tile(a.tiles, a.tile_base)
                            : blockIdx.x;
  const int BH = gridDim.x / a.nc, bh = tile % BH, c = tile / BH;
  const int h = bh % a.H, b = bh / a.H;
  const bool last = c == a.nc - 1;
  const int R = a.R, n = min(kT, a.S - c * kT);
  extern __shared__ __align__(16) float smem[];
  float* r_s = smem;          // r, then r e^{L_{t-1}}
  float* k_s = r_s + R * LD;  // k, then k e^{L_T - L}
  float* v_s = k_s + R * LD;
  float* l_s = v_s + R * LD;  // w, then L (log2 units)
  float* s_s = l_s + R * LD;  // S0 (D x D)
  float* u_s = s_s + D * D;
  float* p_s = u_s + D;  // pairwise weights (R x R + 1)
  double* seg = reinterpret_cast<double*>(p_s);  // the cumsum's, before P

  const long long t0 = (long long)c * kT;
  load_rows<T, D>(r_s, LD, static_cast<const T*>(a.r) + b * a.r_sb +
                               h * a.r_sh + t0 * a.r_ss, a.r_ss, n);
  load_rows<T, D>(k_s, LD, static_cast<const T*>(a.k) + b * a.k_sb +
                               h * a.k_sh + t0 * a.k_ss, a.k_ss, n);
  load_rows<T, D>(v_s, LD, static_cast<const T*>(a.v) + b * a.v_sb +
                               h * a.v_sh + t0 * a.v_ss, a.v_ss, n);
  load_rows<float, D>(l_s, LD, a.w + b * a.w_sb + h * a.w_sh + t0 * a.w_ss,
                      a.w_ss, n);
  if (tid < D) u_s[tid] = u_at<T>(a, b * a.u_sb + h * a.u_sh + tid);
  cumsum<D>(l_s, seg, n);  // also: the tiles and u are whole
  // L_{t-1} (0 at t = 0) at (t, d)
  auto before = [&](int t, int d) {
    return t > 0 ? l_s[(t - 1) * LD + d] : 0.f;
  };

  // pairwise weights P[t][s], s <= t: sum_d r_t k_s e^{L_{t-1} - L_s}
  // below the diagonal, the bonus sum_d r_t u k_t on it.  Threads 2 i and
  // 2 i + 1 share the weights of row t = tid / TPR, columns s = (tid / 2) %
  // (TPR / 2) + (TPR / 2) j, each summing the d of its parity.
  {
    constexpr int SL = TPR / 2, J = kT / SL;
    const int hf = tid & 1, sl = (tid >> 1) % SL, t = tid / TPR;
    float acc[J];
#pragma unroll
    for (int j = 0; j < J; ++j) acc[j] = 0.f;
    if (t < n) {
      // row t's r and L_{t-1} (read where s < t, so t >= 1) once a d, for
      // all the thread's columns
      const float* rrow = r_s + t * LD;
      const float* prow = l_s + (t - 1) * LD;
#pragma unroll 4
      for (int d = hf; d < D; d += 2) {
        const float rv = rrow[d], x = prow[d];
#pragma unroll
        for (int j = 0; j < J; ++j) {
          const int o = (sl + SL * j) * LD + d;
          if (sl + SL * j < t) acc[j] += rv * k_s[o] * ex2(x - l_s[o]);
        }
      }
#pragma unroll
      for (int j = 0; j < J; ++j)
        if (sl + SL * j == t)
          for (int d = hf; d < D; d += 2)
            acc[j] += rrow[d] * u_s[d] * k_s[t * LD + d];
    }
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int s2 = sl + SL * j;
      const float x = acc[j] + __shfl_xor_sync(0xffffffffu, acc[j], 1);
      if (hf == 0 && t < n && s2 <= t) p_s[t * (R + 1) + s2] = x;
    }
  }
  __syncthreads();  // r, k and L are read
  for (int idx = tid; idx < n * D; idx += NT) {
    const int t = idx / D, d = idx % D;
    r_s[t * LD + d] *= ex2(before(t, d));
    k_s[t * LD + d] *= ex2(l_s[(n - 1) * LD + d] - l_s[t * LD + d]);
  }
  __syncthreads();

  // the chunk's pair: the thread's quad of U at its rows, and e^{L_T}
  float4 u[SR];
#pragma unroll
  for (int j = 0; j < SR; ++j) u[j] = make_float4(0.f, 0.f, 0.f, 0.f);
  static_assert(SR == 2 || SR == 1, "state rows a thread");
  for (int t = 0; t < n; ++t) {
    const float4 vv =
        *reinterpret_cast<const float4*>(v_s + t * LD + 4 * q);
    float kd[SR];
    if constexpr (SR == 2) {
      const float2 x = *reinterpret_cast<const float2*>(k_s + t * LD + d0);
      kd[0] = x.x;
      kd[SR - 1] = x.y;
    } else {
      kd[0] = k_s[t * LD + d0];
    }
#pragma unroll
    for (int j = 0; j < SR; ++j) {
      const float kk = kd[j];
      u[j].x += kk * vv.x;
      u[j].y += kk * vv.y;
      u[j].z += kk * vv.z;
      u[j].w += kk * vv.w;
    }
  }
  float* part_bh = a.part + (long long)bh * (a.nc - 1) * part_floats<D>();
  int* flags_bh = a.flags + (long long)bh * a.nc;
  if (!last) {  // publish the pair: data, fence, barrier, flag
    float* p = part_bh + (long long)c * part_floats<D>();
#pragma unroll
    for (int j = 0; j < SR; ++j)
      __stcg(reinterpret_cast<float4*>(p + (d0 + j) * D + 4 * q), u[j]);
    if (tid < D) __stcg(p + D * D + tid, ex2(before(n, tid)));
    chunk_order::publish(flags_bh + c, a.epoch);
  }

  // S0: state0 with the earlier chunks' pairs folded in, in order, once
  // their flags are up; the thread holds quad q of rows d0 + j
  chunk_order::wait_for(flags_bh, c, a.epoch);
  float4 s[SR];
#pragma unroll
  for (int j = 0; j < SR; ++j) s[j] = state0_quad(a, b, h, d0 + j, 4 * q);
#pragma unroll 4
  for (int j2 = 0; j2 < c; ++j2) {
    const float* p = part_bh + (long long)j2 * part_floats<D>();
#pragma unroll
    for (int j = 0; j < SR; ++j) {
      const float dec = __ldcg(p + D * D + d0 + j);
      const float4 uu =
          __ldcg(reinterpret_cast<const float4*>(p + (d0 + j) * D + 4 * q));
      s[j].x = dec * s[j].x + uu.x;
      s[j].y = dec * s[j].y + uu.y;
      s[j].z = dec * s[j].z + uu.z;
      s[j].w = dec * s[j].w + uu.w;
    }
  }
#pragma unroll
  for (int j = 0; j < SR; ++j)
    *reinterpret_cast<float4*>(s_s + (d0 + j) * D + 4 * q) = s[j];
  __syncthreads();

  // o_t = (r_t e^{L_{t-1}}) S0 + sum_{s<=t} P[t][s] v_s: the thread's quad
  // of rows tid / Q + RG j
  T* ob = static_cast<T*>(a.out) + b * a.o_sb + h * a.o_sh;
  for (int t = tid / Q; t < n; t += C::RG) {
    float4 o0 = make_float4(0.f, 0.f, 0.f, 0.f), o1 = o0;
    const float* rrow = r_s + t * LD;
#pragma unroll 8
    for (int d = 0; d < D; d += 2) {
      const float2 rd = *reinterpret_cast<const float2*>(rrow + d);
      const float4 sa =
          *reinterpret_cast<const float4*>(s_s + d * D + 4 * q);
      const float4 sb =
          *reinterpret_cast<const float4*>(s_s + (d + 1) * D + 4 * q);
      o0.x += rd.x * sa.x;
      o0.y += rd.x * sa.y;
      o0.z += rd.x * sa.z;
      o0.w += rd.x * sa.w;
      o1.x += rd.y * sb.x;
      o1.y += rd.y * sb.y;
      o1.z += rd.y * sb.z;
      o1.w += rd.y * sb.w;
    }
    for (int s2 = 0; s2 <= t; ++s2) {
      const float p = p_s[t * (R + 1) + s2];
      const float4 vv =
          *reinterpret_cast<const float4*>(v_s + s2 * LD + 4 * q);
      o0.x += p * vv.x;
      o0.y += p * vv.y;
      o0.z += p * vv.z;
      o0.w += p * vv.w;
    }
    T* op = ob + (t0 + t) * a.o_ss + 4 * q;
    op[0] = rt::from_f<T>(o0.x + o1.x);
    op[1] = rt::from_f<T>(o0.y + o1.y);
    op[2] = rt::from_f<T>(o0.z + o1.z);
    op[3] = rt::from_f<T>(o0.w + o1.w);
  }
  if (!last) return;
  // S_end = e^{L_T} S0 + U
  float* so = a.s_out + (long long)bh * D * D;
#pragma unroll
  for (int j = 0; j < SR; ++j) {
    const int d = d0 + j;
    const float dec = ex2(before(n, d));
    *reinterpret_cast<float4*>(so + d * D + 4 * q) =
        make_float4(dec * s[j].x + u[j].x, dec * s[j].y + u[j].y,
                    dec * s[j].z + u[j].z, dec * s[j].w + u[j].w);
  }
}

// One decode step (S = 1) per (head, row), 4 D threads: thread tid holds
// quad q = tid % Q of state rows SR (tid / Q) + j, writes their new values
// as soon as the old ones arrive, and adds their parts of r S and of the
// bonus r u k; one barrier, then row group 0 sums the parts.
template <typename T, int D>
__global__ void __launch_bounds__(4 * D) wkv6_step_kernel(WkvArgs a) {
  using C = Cfg<D, 4 * D>;
  constexpr int Q = C::Q, RG = C::RG, SR = C::SR;
  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, q = tid % Q, g = tid / Q;
  __shared__ float4 po_s[RG][Q];
  __shared__ float pb_s[RG];
  const T* rb = static_cast<const T*>(a.r) + b * a.r_sb + h * a.r_sh;
  const T* kb = static_cast<const T*>(a.k) + b * a.k_sb + h * a.k_sh;
  const T* vb = static_cast<const T*>(a.v) + b * a.v_sb + h * a.v_sh;
  const float* wb = a.w + b * a.w_sb + h * a.w_sh;
  const float4 vq =
      make_float4(rt::to_f(vb[4 * q]), rt::to_f(vb[4 * q + 1]),
                  rt::to_f(vb[4 * q + 2]), rt::to_f(vb[4 * q + 3]));
  float* so = a.s_out + ((long long)b * a.H + h) * D * D;
  float4 po = make_float4(0.f, 0.f, 0.f, 0.f);
  float pb = 0.f;
#pragma unroll
  for (int j = 0; j < SR; ++j) {
    const int d = SR * g + j;
    const float4 s = state0_quad(a, b, h, d, 4 * q);
    const float rd = rt::to_f(rb[d]), kd = rt::to_f(kb[d]);
    const float dec = exp2f(wb[d] * kLog2e);
    po.x += rd * s.x;
    po.y += rd * s.y;
    po.z += rd * s.z;
    po.w += rd * s.w;
    pb += rd * u_at<T>(a, b * a.u_sb + h * a.u_sh + d) * kd;
    *reinterpret_cast<float4*>(so + d * D + 4 * q) =
        make_float4(dec * s.x + kd * vq.x, dec * s.y + kd * vq.y,
                    dec * s.z + kd * vq.z, dec * s.w + kd * vq.w);
  }
  po_s[g][q] = po;
  if (q == 0) pb_s[g] = pb;
  __syncthreads();
  if (g != 0) return;
  float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
  float bonus = 0.f;
  for (int i = 0; i < RG; ++i) {
    const float4 x = po_s[i][q];
    o.x += x.x;
    o.y += x.y;
    o.z += x.z;
    o.w += x.w;
    bonus += pb_s[i];
  }
  T* op = static_cast<T*>(a.out) + b * a.o_sb + h * a.o_sh + 4 * q;
  op[0] = rt::from_f<T>(o.x + bonus * vq.x);
  op[1] = rt::from_f<T>(o.y + bonus * vq.y);
  op[2] = rt::from_f<T>(o.z + bonus * vq.z);
  op[3] = rt::from_f<T>(o.w + bonus * vq.w);
}

template <typename T, int D>
cudaError_t launch(int B, cudaStream_t st, const WkvArgs& a) {
  if (a.S == 1) {
    wkv6_step_kernel<T, D><<<dim3(a.H, B), 4 * D, 0, st>>>(a);
    return cudaGetLastError();
  }
  constexpr int kMax = smem_floats<D>(kT) * sizeof(float);
  static rt::PerDevice smem_set;
  const cudaError_t attr = smem_set.get([&] {
    return cudaFuncSetAttribute(
        wkv6_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, kMax);
  });
  if (attr != cudaSuccess) return attr;
  wkv6_kernel<T, D><<<a.nc * a.H * B, 8 * D,
                      smem_floats<D>(a.R) * sizeof(float), st>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(int D, int B, cudaStream_t st, const WkvArgs& a) {
  return D == 32 ? launch<T, 32>(B, st, a) : launch<T, 64>(B, st, a);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (r, k, v and out).  w_log, state0 and
// the state out are float32, u float32 (u_f32 1) or r's dtype (0).
// Layouts: r/k/v/w_log/out (B, H, S, D), u (B, H, D) (broadcast strides may
// be 0), state0 (B, H, D, D) or null (zeros), its rows on 16-byte
// boundaries if s0_vec; strides in elements, the D stride of each is 1.
// The state out is a contiguous (B, H, D, D) tensor.  With S > 32: part a
// contiguous f32 scratch of B H (ceil(S / 32) - 1) (D D + D) floats,
// 16-byte aligned; tiles a counter that earlier launches advanced by
// tile_base in all (each launch by its B H ceil(S / 32) blocks); flags B H
// ceil(S / 32) ints, none of them equal to epoch (> 0) before the launch.
// Returns cudaGetLastError() after the launch, or the error of raising the
// kernel's shared-memory limit (0 = launched).
extern "C" int rwkv6_scan_launch(
    int dtype, int D, int B, int H, int S, const void* r, long long r_sb,
    long long r_sh, long long r_ss, const void* k, long long k_sb,
    long long k_sh, long long k_ss, const void* v, long long v_sb,
    long long v_sh, long long v_ss, const void* w_log, long long w_sb,
    long long w_sh, long long w_ss, const void* u, long long u_sb,
    long long u_sh, const void* state0, long long s0_sb, long long s0_sh,
    long long s0_sd, void* out, long long o_sb, long long o_sh,
    long long o_ss, void* state_out, void* part, void* tiles,
    long long tile_base, void* flags, int epoch, int u_f32, int s0_vec,
    void* stream) {
  const int nc = (S + kT - 1) / kT;
  if ((D != 32 && D != 64) || B < 1 || H < 1 || S < 1 ||
      (long long)nc * B * H > 0x7fffffffLL ||
      (nc > 1 && (part == nullptr || tiles == nullptr || flags == nullptr ||
                  epoch <= 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  WkvArgs a{r,     r_sb,  r_sh,  r_ss, k,     k_sb,  k_sh,  k_ss,
            v,     v_sb,  v_sh,  v_ss, static_cast<const float*>(w_log),
            w_sb,  w_sh,  w_ss,  u,    u_sb,  u_sh,
            static_cast<const float*>(state0),
            s0_sb, s0_sh, s0_sd, out,  o_sb,  o_sh,  o_ss,
            static_cast<float*>(state_out), static_cast<float*>(part),
            static_cast<unsigned long long*>(tiles), tile_base,
            static_cast<int*>(flags), epoch, H, S, nc, S < kT ? S : kT,
            u_f32, s0_vec};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = dtype == 0
                              ? launch_d<float>(D, B, st, a)
                              : launch_d<__nv_bfloat16>(D, B, st, a);
  return static_cast<int>(err);
}
