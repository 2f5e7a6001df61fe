// RG-LRU linear recurrence (Griffin / RecurrentGemma).
//
// Replaces the Pallas TPU kernel repro/kernels/rglru_scan.py (rglru_scan,
// _rglru_kernel): for each row b and channel w,
//   a_t = exp(a_log_t),  h_t = a_t h_{t-1} + sqrt(1 - a_t^2) (gate_t x_t),
// from h_{-1} = h0[b, w] (f32), writing h_t in x's dtype and h_S-1 in f32.
//
// What bounds it on the card: bytes.  Each element is read once (x and
// gate in bf16 or f32, a_log in f32) and h written once, against ~10
// operations, so the recurrence is a stream far below the ridge.  The TPU
// kernel tiled W by 512 lanes and walked S in 128-step chunks, carrying h in
// VMEM from one grid step to the next; blocks here run in parallel and in
// no order.  One thread a channel walking all of S gave a 512-token prefill
// of one row 16 blocks on 132 SMs and ~64 memory latencies in series
// (PERF.md).  So S is cut into chunks of kL tokens and W into tiles of kTW
// channels, with one block per (chunk, channel tile, row), one thread a
// channel:
//   1. the thread loads its chunk's x, gate and a_log (all loads issued
//      before any is used) and keeps a_t and u_t = sqrt(1 - a_t^2)(g_t x_t)
//      in registers;
//   2. all but the last chunk reduce it to the pair (A = prod a_t, b = the
//      chunk's h from 0) and publish it (chunk_order.cuh);
//   3. the carry into the chunk is h0 with the earlier chunks' pairs folded
//      in chunk order, h <- A h + b (every block of a (row, tile) folds the
//      same pairs in the same order);
//   4. the thread runs its chunk again from the carry with the plain
//      version's own step, h = a_t h + u_t, from its registers, and writes
//      h_t; the last chunk writes h_final.
// A 512-token prefill of one row at W 4096 runs 32 x 32 blocks in
// one launch, and its longest chain is 16 steps, a fold of 31 pairs and 16
// steps.  A prod a_t that underflows to 0 (strong decays) is harmless: the
// carry's true weight is below f32's range.  S <= kL (a decode step) is one
// chunk: no pairs, no wait.  Whole chunks (all but a ragged last one) run
// without per-step tests, so every load issues up front.  Measured
// (PERF.md): chunks of 16 beat 8 and 32 at S 128-512 (tools/
// attention_sweep.py builds those by patching kL); two or four channels a
// thread (vector loads) were slower, and the fold of the earlier pairs and
// the chunk-order wait are what a 512-token prefill spends above its loads.
#include "chunk_order.cuh"
#include "common.cuh"

namespace {

constexpr int kL = 16;     // tokens a chunk (ops.RGLRU_CHUNK)
constexpr int kTW = 128;   // channels a block, one a thread (ops.RGLRU_TILE_W)
constexpr int kFold = 16;  // earlier chunks' pairs loaded at a time

struct RglruArgs {
  const void* x;
  long long x_sb, x_ss;
  const float* a;
  long long a_sb, a_ss;
  const void* g;
  long long g_sb, g_ss;
  const float* h0;
  long long h0_sb;
  void* out;
  float* hf;
  // (B, nc - 1, W): each chunk but the last's (A, b), or null when nc == 1
  float2* part;
  // with nc > 1: the tile counter (the tiles of earlier launches are
  // tile_base) and a flag per (row, channel tile, chunk)
  unsigned long long* tiles;
  long long tile_base;
  int* flags;
  int epoch;
  int B, S, W, nc, nw;  // nw: channel tiles
};

// Steps [0, n) of the thread's chunk (all L when kFull): a_t and u_t =
// sqrt(1 - a_t^2)(g_t x_t), every load issued before the arithmetic
template <typename T, int L, bool kFull>
__device__ __forceinline__ void load_chunk(const T* xb, long long x_ss,
                                           const T* gb, long long g_ss,
                                           const float* ab, long long a_ss,
                                           int n, float (&av)[L],
                                           float (&uv)[L]) {
#pragma unroll
  for (int i = 0; i < L; ++i) {
    float x = 0.f, g = 0.f, al = 0.f;
    if (kFull || i < n) {
      x = rt::to_f(xb[i * x_ss]);
      g = rt::to_f(gb[i * g_ss]);
      al = ab[i * a_ss];
    }
    av[i] = al;
    uv[i] = g * x;
  }
#pragma unroll
  for (int i = 0; i < L; ++i) {
    if (kFull || i < n) {
      const float a = expf(av[i]);
      const float beta = sqrtf(fmaxf(1.f - a * a, 0.f));
      av[i] = a;
      uv[i] = beta * uv[i];
    }
  }
}

// Steps [0, n) of the chunk from the carry h, each h_t written to ob
template <typename T, int L, bool kFull>
__device__ __forceinline__ float run_chunk(float h, const float (&av)[L],
                                           const float (&uv)[L], int n,
                                           T* ob, long long o_ss, bool ok) {
#pragma unroll
  for (int i = 0; i < L; ++i) {
    if (kFull || i < n) {
      h = av[i] * h + uv[i];
      if (ok) ob[i * o_ss] = rt::from_f<T>(h);
    }
  }
  return h;
}

// One block per (chunk, channel tile, row), in tiles taken in chunk order;
// one thread a channel
template <typename T, int L>
__global__ void __launch_bounds__(kTW) rglru_chunk_kernel(RglruArgs p) {
  const int tile = p.nc > 1 ? chunk_order::take_tile(p.tiles, p.tile_base)
                            : static_cast<int>(blockIdx.x);
  const int per = p.nw * p.B;
  const int c = tile / per, bw = tile % per, b = bw / p.nw;
  const int w = (bw % p.nw) * kTW + threadIdx.x;
  const bool ok = w < p.W;
  const long long t0 = static_cast<long long>(c) * L;
  const int n = min(L, p.S - static_cast<int>(t0));
  float h = ok ? p.h0[b * p.h0_sb + w] : 0.f;  // in flight with the chunk

  // 1. the chunk's a_t and u_t (a whole chunk without per-step tests)
  const T* xb = static_cast<const T*>(p.x) + b * p.x_sb + t0 * p.x_ss + w;
  const T* gb = static_cast<const T*>(p.g) + b * p.g_sb + t0 * p.g_ss + w;
  const float* ab = p.a + b * p.a_sb + t0 * p.a_ss + w;
  float av[L], uv[L];
  if (ok && n == L)
    load_chunk<T, L, true>(xb, p.x_ss, gb, p.g_ss, ab, p.a_ss, n, av, uv);
  else if (ok)
    load_chunk<T, L, false>(xb, p.x_ss, gb, p.g_ss, ab, p.a_ss, n, av, uv);

  // 2. all but the last chunk: its pair, published
  const bool last = c == p.nc - 1;
  int* flags = p.flags + static_cast<long long>(bw) * p.nc;
  const long long part_b = static_cast<long long>(b) * (p.nc - 1) * p.W + w;
  if (!last) {  // a whole chunk
    float A = 1.f, hb = 0.f;
#pragma unroll
    for (int i = 0; i < L; ++i) {
      hb = av[i] * hb + uv[i];
      A *= av[i];
    }
    if (ok) __stcg(p.part + part_b + static_cast<long long>(c) * p.W,
                   make_float2(A, hb));
    chunk_order::publish(flags + c, p.epoch);
  }

  // 3. the carry: h0 with the earlier chunks' pairs folded in, in order,
  // kFold pairs loaded at a time
  if (c > 0) {
    chunk_order::wait_for(flags, c, p.epoch);
    if (ok) {
      const float2* pp = p.part + part_b;
      for (int j0 = 0; j0 < c; j0 += kFold) {
        float2 q[kFold];
#pragma unroll
        for (int j = 0; j < kFold; ++j)
          if (j0 + j < c) q[j] = __ldcg(pp + static_cast<long long>(j0 + j) *
                                                 p.W);
#pragma unroll
        for (int j = 0; j < kFold; ++j)
          if (j0 + j < c) h = q[j].x * h + q[j].y;
      }
    }
  }

  // 4. the chunk again from the carry, step by step
  T* ob = static_cast<T*>(p.out) + (b * static_cast<long long>(p.S) + t0) *
                                       p.W + w;
  h = n == L ? run_chunk<T, L, true>(h, av, uv, n, ob, p.W, ok)
             : run_chunk<T, L, false>(h, av, uv, n, ob, p.W, ok);
  if (last && ok) p.hf[static_cast<long long>(b) * p.W + w] = h;
}

template <typename T, int L>
cudaError_t launch(const RglruArgs& p, cudaStream_t st) {
  rglru_chunk_kernel<T, L><<<p.nc * p.nw * p.B, kTW, 0, st>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_l(int L, const RglruArgs& p, cudaStream_t st) {
  if (L == 1) return launch<T, 1>(p, st);
  if (L == 8) return launch<T, 8>(p, st);
  return launch<T, kL>(p, st);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, gate and out).  a_log and h0 are
// float32.  Strides are in elements; the W stride of every input is 1.  out
// is a contiguous (B, S, W) tensor, h_final a contiguous (B, W) float32
// tensor.  With S > kL (nc = ceil(S / kL) chunks, nw = ceil(W / kTW)
// channel tiles; the caller sizes part and flags by ops.RGLRU_CHUNK and
// ops.RGLRU_TILE_W, which equal them): part a
// contiguous f32 scratch of B (nc - 1) W pairs, 8-byte aligned; tiles a
// counter that earlier launches advanced by tile_base in all (each launch
// by its nc nw B blocks); flags B nw nc ints, none of them equal to epoch
// (> 0) before the launch.  Returns cudaGetLastError() after the launch (0
// = launched).
extern "C" int rglru_scan_launch(int dtype, int B, int S, int W,
                                 const void* x, long long x_sb,
                                 long long x_ss, const void* a_log,
                                 long long a_sb, long long a_ss,
                                 const void* gate, long long g_sb,
                                 long long g_ss, const void* h0,
                                 long long h0_sb, void* out, void* h_final,
                                 void* part, void* tiles, long long tile_base,
                                 void* flags, int epoch, void* stream) {
  if (B < 1 || S < 1 || W < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int nc = (S + kL - 1) / kL, nw = (W + kTW - 1) / kTW;
  if (static_cast<long long>(nc) * nw * B > 0x7fffffffLL ||
      (nc > 1 && (part == nullptr || tiles == nullptr || flags == nullptr ||
                  epoch <= 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  const RglruArgs p{x,     x_sb,  x_ss, static_cast<const float*>(a_log),
                    a_sb,  a_ss,  gate, g_sb,
                    g_ss,  static_cast<const float*>(h0),
                    h0_sb, out,   static_cast<float*>(h_final),
                    static_cast<float2*>(part),
                    static_cast<unsigned long long*>(tiles), tile_base,
                    static_cast<int*>(flags), epoch, B, S, W, nc, nw};
  // one chunk (a decode step, a short prompt piece): the shortest unrolled
  // chunk that holds it
  const int L = nc > 1 ? kL : S == 1 ? 1 : S <= 8 ? 8 : kL;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = dtype == 0 ? launch_l<float>(L, p, st)
                                     : launch_l<__nv_bfloat16>(L, p, st);
  return static_cast<int>(err);
}
