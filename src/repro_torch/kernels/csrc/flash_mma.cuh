// f32-precision matrix products on the tensor cores (3xTF32) for the
// contiguous flash-attention kernels: f32 tiles in shared memory, fed by
// cp.async (attn_mma.cuh's copies), read as mma.sync.m16n8k8 tf32
// fragments.
//
// 3xTF32.  TF32 keeps 10 of f32's 23 mantissa bits, so one TF32 product
// is good to about 3 decimal digits.  Each f32 operand x is split as hi =
// tf32(x), lo = tf32(x - hi) (both rounded to nearest), and a product a.b
// is taken as lo_a hi_b + hi_a lo_b + hi_a hi_b: the dropped lo_a lo_b is
// 2^-22 of a.b, so the product keeps f32's precision at three tensor-core
// products.  Each k-step's products land in a zeroed fragment that is then
// added to the f32 sum with round-to-nearest (add_rn): the tensor cores add
// into their accumulator with truncation, which over a long reduction
// biases the sum toward zero (PERF.md).  Operands that a
// block reads many times (its streamed tiles) are split once, as they
// arrive, into (hi, lo) pairs in shared memory (split_own).
//
// Fragments (lane = 4 g + t): A (16 x 8, row) holds a0 (g, t), a1 (g + 8,
// t), a2 (g, t + 4), a3 (g + 8, t + 4); B (8 x 8, col) holds b0 (k t, n g)
// and b1 (k t + 4, n g); the accumulator (16 x 8) holds (g, 2t), (g, 2t +
// 1), (g + 8, 2t), (g + 8, 2t + 1).  An accumulator becomes the A operand of
// the next product without a shuffle by renumbering its k: slot t is column
// 2t and slot t + 4 column 2t + 1, so the B operand of that product reads
// rows 2t and 2t + 1 (acc_as_a, b_rows2).
//
// A block's own tiles are f32, row-major with rows of HD floats and no
// padding, their 4-float chunks permuted within each 32-float block by row
// (swz): the A fragment loads, 8 rows x 4 columns, hit 32 distinct banks.
// Pre-split tiles permute their pairs the same way (swz2) for the B loads,
// 8 rows x 4 columns (b_rows) or 4 rows x 8 columns (b_rows2, rows 2t and
// 2t + 1).
#pragma once

#include <type_traits>

#include "attn_mma.cuh"
#include "flash_common.cuh"

namespace fm {

// Element (r, c) of a swizzled tile with rows of HD floats: column c's
// 4-float chunk moves within its 32-float block by a row-dependent xor.
template <int HD>
__device__ __forceinline__ int swz(int r, int c) {
  static_assert(HD % 32 == 0, "rows of whole 32-float blocks");
  return r * HD + (c ^ ((((r ^ (r >> 2)) & 3) << 3) | (r & 4)));
}

// rows of p (row strides s) start on 16-byte boundaries, in f32: the
// tiles may be copied by cp.async
inline bool rows16(const void* p, long long sb, long long sh,
                   long long ss) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && sb % 4 == 0 &&
         sh % 4 == 0 && ss % 4 == 0;
}

// Rows [0, n) of an R x HD tile from global memory (row stride ss, unit
// column stride) into a swizzled f32 tile, rows n.. zero.  With vec (f32
// source, rows 16-byte aligned) by cp.async; else by loads converted to f32
// (exact from bf16) and stored by the threads.  Issued by all NT threads.
template <typename T, int HD, int R, int NT>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          long long ss, int n, bool vec) {
  constexpr int kChunks = R * HD / 4;
  for (int idx = threadIdx.x; idx < kChunks; idx += NT) {
    const int r = idx / (HD / 4), c = (idx % (HD / 4)) * 4;
    const bool ok = r < n;
    float* d = dst + swz<HD>(r, c);
    if constexpr (std::is_same<T, float>::value) {
      if (vec) {
        am::cp16(d, src + (ok ? r : 0) * ss + c, ok);
        continue;
      }
    }
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (ok) {
      const T* p = src + r * ss + c;
      v = make_float4(rt::to_f(p[0]), rt::to_f(p[1]), rt::to_f(p[2]),
                      rt::to_f(p[3]));
    }
    *reinterpret_cast<float4*>(d) = v;
  }
}

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x as hi + lo, both TF32
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

// d += a (16x8 tf32, row) * b (8x8 tf32, col), f32 accumulation
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// An A fragment split into its TF32 parts
struct A3 {
  uint32_t hi[4], lo[4];
  __device__ __forceinline__ void set(float x0, float x1, float x2,
                                      float x3) {
    split(x0, hi[0], lo[0]);
    split(x1, hi[1], lo[1]);
    split(x2, hi[2], lo[2]);
    split(x3, hi[3], lo[3]);
  }
};

// A B fragment split into its TF32 parts
struct B3 {
  uint32_t hi[2], lo[2];
  __device__ __forceinline__ void set(float2 x0, float2 x1) {
    hi[0] = __float_as_uint(x0.x);
    lo[0] = __float_as_uint(x0.y);
    hi[1] = __float_as_uint(x1.x);
    lo[1] = __float_as_uint(x1.y);
  }
};

// t += a b at f32 precision: three TF32 products, the cross terms first
__device__ __forceinline__ void mma3(float (&t)[4], const A3& a,
                                     const B3& b) {
  mma_tf32(t, a.lo, b.hi[0], b.hi[1]);
  mma_tf32(t, a.hi, b.lo[0], b.lo[1]);
  mma_tf32(t, a.hi, b.hi[0], b.hi[1]);
}

// d += t with round-to-nearest: a k-step's fresh fragment into the sum
__device__ __forceinline__ void add_rn(float (&d)[4], const float (&t)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) d[e] += t[e];
}

// The A fragment of rows [r0, r0 + 16) and columns [c0, c0 + 8) of a
// swizzled tile (r0 and c0 multiples of 8)
template <int HD>
__device__ __forceinline__ void a_tile(A3& a, const float* s, int r0,
                                       int c0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r = r0 + g, c = c0 + t;
  a.set(s[swz<HD>(r, c)], s[swz<HD>(r + 8, c)], s[swz<HD>(r, c + 4)],
        s[swz<HD>(r + 8, c + 4)]);
}

// Element (r, c) of a pre-split tile (hi, lo pairs, rows of HD pairs):
// column c's 4-pair chunk moves within its 16-pair block by a
// row-dependent xor, so the B fragment loads (8-byte, a half warp at a
// time) hit 16 distinct bank pairs
template <int HD>
__device__ __forceinline__ int swz2(int r, int c) {
  return r * HD + (c ^ (((r ^ (r >> 2)) & 3) << 2));
}

// Rows [0, n) of an R x HD tile from global memory into a plain row-major
// f32 staging tile (chunk i of 4 floats at raw + 4 i), rows n.. zero: by
// cp.async with vec, else converted to f32 by the threads.  Thread x
// copies chunks x, x + NT, ...: the chunks split_own converts.
template <typename T, int HD, int R, int NT>
__device__ __forceinline__ void load_raw(float* raw, const T* src,
                                         long long ss, int n, bool vec) {
  for (int idx = threadIdx.x; idx < R * HD / 4; idx += NT) {
    const int r = idx / (HD / 4), c = (idx % (HD / 4)) * 4;
    const bool ok = r < n;
    if constexpr (std::is_same<T, float>::value) {
      if (vec) {
        am::cp16(raw + 4 * idx, src + (ok ? r : 0) * ss + c, ok);
        continue;
      }
    }
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (ok) {
      const T* p = src + r * ss + c;
      v = make_float4(rt::to_f(p[0]), rt::to_f(p[1]), rt::to_f(p[2]),
                      rt::to_f(p[3]));
    }
    *reinterpret_cast<float4*>(raw + 4 * idx) = v;
  }
}

// The thread's own staged chunks (load_raw's, landed) split into (hi, lo)
// pairs of a pre-split tile
template <int HD, int R, int NT>
__device__ __forceinline__ void split_own(float2* dst, const float* raw) {
  for (int idx = threadIdx.x; idx < R * HD / 4; idx += NT) {
    const int r = idx / (HD / 4), c = (idx % (HD / 4)) * 4;
    const float4 v = *reinterpret_cast<const float4*>(raw + 4 * idx);
    const float x[4] = {v.x, v.y, v.z, v.w};
    uint32_t h[4], l[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) split(x[e], h[e], l[e]);
    float4* d = reinterpret_cast<float4*>(dst + swz2<HD>(r, c));
    d[0] = make_float4(__uint_as_float(h[0]), __uint_as_float(l[0]),
                       __uint_as_float(h[1]), __uint_as_float(l[1]));
    d[1] = make_float4(__uint_as_float(h[2]), __uint_as_float(l[2]),
                       __uint_as_float(h[3]), __uint_as_float(l[3]));
  }
}

// The B fragment (k = column, n = row) of rows [n0, n0 + 8) and columns
// [c0, c0 + 8) of a pre-split tile: for S = X Y^T with Y's rows in the tile
template <int HD>
__device__ __forceinline__ void b_rows(B3& b, const float2* s, int n0,
                                       int c0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r = n0 + g, c = c0 + t;
  b.set(s[swz2<HD>(r, c)], s[swz2<HD>(r, c + 4)]);
}

// The B fragment (k = row, n = column) of rows [k0, k0 + 8) and columns
// [n0, n0 + 8) of a pre-split tile, in acc_as_a's k order: slot t is row
// 2t, slot t + 4 row 2t + 1
template <int HD>
__device__ __forceinline__ void b_rows2(B3& b, const float2* s, int k0,
                                        int n0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r = k0 + 2 * t, c = n0 + g;
  b.set(s[swz2<HD>(r, c)], s[swz2<HD>(r + 1, c)]);
}

// An accumulator (16 x 8) as the A operand of the next product, its k
// renumbered as b_rows2 reads B
__device__ __forceinline__ void acc_as_a(A3& a, const float (&c)[4]) {
  a.set(c[0], c[2], c[1], c[3]);
}

// head_dim depth of the score products (S, and dP in the backward) that
// share one fresh fragment: 32 halves the 16-deep step's round-to-nearest
// adds, at a precision within 1.5x of the plain f32 version's (PERF.md)
constexpr int kScoreDepth = 32;
constexpr float kLog2e = 1.4426950408889634f;

// acc += X Y^T over head_dim [kk, kk + kScoreDepth): X a block tile's warp
// rows [wr, wr + 16), Y the BS rows of a pre-split streamed tile, through a
// fresh fragment (add_rn)
template <int HD, int BS>
__device__ __forceinline__ void rows_step(float (&acc)[BS / 8][4],
                                          const float* x, const float2* y,
                                          int wr, int kk) {
  A3 a[kScoreDepth / 8];
#pragma unroll
  for (int j = 0; j < kScoreDepth / 8; ++j)
    a_tile<HD>(a[j], x, wr, kk + 8 * j);
#pragma unroll
  for (int n = 0; n < BS / 8; ++n) {
    float t[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int j = 0; j < kScoreDepth / 8; ++j) {
      B3 bb;
      b_rows<HD>(bb, y, n * 8, kk + 8 * j);
      mma3(t, a[j], bb);
    }
    add_rn(acc[n], t);
  }
}

// acc += C Y: C the warp's 16 x BS product (accumulator fragments), Y the
// pre-split streamed tile's BS rows at the warp's AW columns [wc, wc + AW),
// each 16 rows of Y through a fresh fragment
template <int HD, int BS, int AW>
__device__ __forceinline__ void acc_product(float (&acc)[AW / 8][4],
                                            const float (&c)[BS / 8][4],
                                            const float2* y, int wc) {
  static_assert(BS % 16 == 0, "16-row k-steps");
  A3 a[BS / 8];
#pragma unroll
  for (int kq = 0; kq < BS / 8; ++kq) acc_as_a(a[kq], c[kq]);
#pragma unroll
  for (int n = 0; n < AW / 8; ++n)
#pragma unroll
    for (int k2 = 0; k2 < BS / 16; ++k2) {
      float t[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int kq = 2 * k2; kq < 2 * k2 + 2; ++kq) {
        B3 bb;
        b_rows2<HD>(bb, y, kq * 8, wc + n * 8);
        mma3(t, a[kq], bb);
      }
      add_rn(acc[n], t);
    }
}

}  // namespace fm
