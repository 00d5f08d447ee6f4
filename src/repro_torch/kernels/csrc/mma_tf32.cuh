// Split-TF32 tensor-core products and asynchronous tile copies shared by
// the flash-attention forward (flash_attention.cu) and backward
// (flash_attention_bwd.cu); the reasons for each choice are in those
// files' header comments.
//
// Both kernels run a CTA of 8 warps that owns 64 rows (4 m16 blocks, two
// warps each) and walks W-row tiles of the other side, double-buffered.
// Operand tiles lie in shared memory as float32, row-major, at the row
// stride mma_stride(width); mma.sync m16n8k8 .tf32 takes each float32
// operand split into big + small, and an accumulator tile is the A operand
// of the next product through the k8-slot permutation of frag_a_from_c.
#pragma once

#include <type_traits>

#include "tiles.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kOwn = 64;                 // rows a CTA owns
constexpr int kBlocks = kOwn / 16;       // m16 blocks of them; 2 warps each

// Shared row stride (floats) of an operand tile: the width padded to whole
// k8 steps, plus 4, an odd multiple of 4 words (conflict-free fragments).
__host__ __device__ __forceinline__ int mma_stride(int width) {
  return (width + 7) / 8 * 8 + 4;
}

// ---- split-TF32 tensor-core products --------------------------------------

// x as big = tf32(x), rounded to nearest (ties away from zero, as
// cvt.rna.tf32.f32 but in two integer operations: the inputs are finite),
// and small = x - big, exact in float32, whose low 13 bits the tensor cores
// drop as they read it. An exact x (bf16 input) is its own big part and has
// no small part.
template <bool kExact>
__device__ __forceinline__ void split(float x, uint32_t& big, uint32_t& small) {
  if (kExact) {
    big = __float_as_uint(x);
    small = 0u;
  } else {
    big = (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
    small = __float_as_uint(x - __uint_as_float(big));
  }
}

struct FragA { uint32_t big[4], small[4]; };
struct FragB { uint32_t big[2], small[2]; };

__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a b in split TF32: the small products first, none for an exact side.
template <bool kAExact, bool kBExact>
__device__ __forceinline__ void mma3(float (&c)[4], const FragA& a, const FragB& b) {
  if (!kAExact) mma(c, a.small, b.big);
  if (!kBExact) mma(c, a.big, b.small);
  mma(c, a.big, b.big);
}

// hi + lo += x: hi takes the rounded sum and lo gathers its rounding
// error (Dekker's fast two-sum, exact where |hi| >= |x|).
__device__ __forceinline__ void fast_two_sum_add(float& hi, float& lo, float x) {
  const float s = hi + x;
  lo += x - (s - hi);
  hi = s;
}

// A (16 x 8) from a row-major [row][k] shared tile: rows m0 + g and
// m0 + g + 8, columns k0 + t and k0 + t + 4.
template <bool kExact>
__device__ __forceinline__ FragA frag_a(const float* s, int stride, int m0,
                                        int k0, int g, int t) {
  FragA f;
  const float* p = s + (m0 + g) * stride + k0 + t;
  split<kExact>(p[0], f.big[0], f.small[0]);
  split<kExact>(p[8 * stride], f.big[1], f.small[1]);
  split<kExact>(p[4], f.big[2], f.small[2]);
  split<kExact>(p[8 * stride + 4], f.big[3], f.small[3]);
  return f;
}

// B (8 x 8) of a product X Y^T from the row-major [n][k] shared tile Y:
// Y[n0 + g][k0 + t] and Y[n0 + g][k0 + t + 4].
template <bool kExact>
__device__ __forceinline__ FragB frag_b_rows(const float* s, int stride, int n0,
                                             int k0, int g, int t) {
  FragB f;
  const float* p = s + (n0 + g) * stride + k0 + t;
  split<kExact>(p[0], f.big[0], f.small[0]);
  split<kExact>(p[4], f.big[1], f.small[1]);
  return f;
}

// B (8 x 8) of a product X Y from the row-major [k][n] shared tile Y, in
// the k8 slots of frag_a_from_c: Y[k0 + 2t][n0 + g] and Y[k0 + 2t + 1][n0 + g].
template <bool kExact>
__device__ __forceinline__ FragB frag_b_cols(const float* s, int stride, int k0,
                                             int n0, int g, int t) {
  FragB f;
  const float* p = s + (k0 + 2 * t) * stride + n0 + g;
  split<kExact>(p[0], f.big[0], f.small[0]);
  split<kExact>(p[stride], f.big[1], f.small[1]);
  return f;
}

// A (16 x 8) from an accumulator tile c (rows g, g + 8; columns 2t, 2t + 1)
// whose 8 columns are the k8 step: slot t holds column 2t, slot t + 4
// column 2t + 1.
__device__ __forceinline__ FragA frag_a_from_c(const float (&c)[4]) {
  FragA f;
  split<false>(c[0], f.big[0], f.small[0]);
  split<false>(c[2], f.big[1], f.small[1]);
  split<false>(c[1], f.big[2], f.small[2]);
  split<false>(c[3], f.big[3], f.small[3]);
  return f;
}

// k8 steps of S and dP summed from zero before they join the running sum
// by a compensated add (see flash_attention_bwd.cu's header comment).
constexpr int kChunk = 2;

// d += the NS n8 tiles (walked rows n0 ...) of one chunk (columns k0 ...
// of `width`) of the product A B^T, A the owned rows m0 .. m0 + 16 of sa,
// B the walked rows of sb.
template <int NS, bool kExact>
__device__ __forceinline__ void score_chunk(float (&d)[NS][4], const float* sa,
                                            int sa_stride, int m0, const float* sb,
                                            int sb_stride, int n0, int k0, int width,
                                            int g, int t) {
#pragma unroll
  for (int u = 0; u < kChunk; ++u) {
    const int kk = k0 + 8 * u;
    if (kk < width) {
      const FragA a = frag_a<kExact>(sa, sa_stride, m0, kk, g, t);
#pragma unroll
      for (int n = 0; n < NS; ++n)
        mma3<kExact, kExact>(d[n], a,
                             frag_b_rows<kExact>(sb, sb_stride, n0 + n * 8, kk, g, t));
    }
  }
}

template <int NS>
__device__ __forceinline__ void join_chunk(float (&c)[NS][4], float (&lo)[NS][4],
                                           const float (&d)[NS][4]) {
#pragma unroll
  for (int n = 0; n < NS; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) fast_two_sum_add(c[n][i], lo[n][i], d[n][i]);
}

// ---- asynchronous tile copies ---------------------------------------------

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src)
               : "memory");
}
// N = 1 or 2 floats (4 or 8 bytes; cp.async.cg takes 16 only)
template <int N>
__device__ __forceinline__ void cp_async_small(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d), "l"(src),
               "n"(4 * N)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Copy rows [0, nrows) of a float32 (rows, width) tile in units of N
// floats (width a multiple of N, source and rows N-float aligned).
template <int N>
__device__ __forceinline__ void copy_units(const float* __restrict__ src, int nrows,
                                           int width, float* dst, int stride) {
  const int per = width / N, n = nrows * per;
  for (int c = threadIdx.x; c < n; c += blockDim.x) {
    const int r = c / per, col = (c - r * per) * N;
    if constexpr (N == 4)
      cp_async16(dst + r * stride + col, src + (size_t)r * width + col);
    else
      cp_async_small<N>(dst + r * stride + col, src + (size_t)r * width + col);
  }
}

// Start copying rows [0, nrows) of a contiguous (rows, width) tile into
// shared memory at row stride `stride`: float32 by cp.async in the widest
// unit every row start allows (16 bytes where the tile starts 16-byte
// aligned and the width is a multiple of 4, as at c = 200; 8 bytes for an
// even width such as c = 150, whose 600-byte rows start 8-byte aligned;
// else 4), completed by the caller's commit and wait; bfloat16 converted
// synchronously.
template <typename T>
__device__ void load_rows(const T* __restrict__ src, int nrows, int width,
                          float* dst, int stride) {
  if constexpr (std::is_same<T, float>::value) {
    const uintptr_t a = reinterpret_cast<uintptr_t>(src);
    if ((a & 15) == 0 && width % 4 == 0)
      copy_units<4>(src, nrows, width, dst, stride);
    else if ((a & 7) == 0 && width % 2 == 0)
      copy_units<2>(src, nrows, width, dst, stride);
    else
      copy_units<1>(src, nrows, width, dst, stride);
  } else {
    load_tile<T>(src, nrows, width, dst, stride);
  }
}

// Zero `n4` float4s of shared memory (padding columns and rows past the
// end are read by the fragments and must hold finite values).
__device__ __forceinline__ void zero_shared(float4* s, int n4) {
  for (int i = threadIdx.x; i < n4; i += blockDim.x)
    s[i] = make_float4(0.f, 0.f, 0.f, 0.f);
}

// Owned rows' mask fields in shared memory, [3][kOwn]: index (-1 past the
// end), time, segment id.
__device__ __forceinline__ void load_owned_meta(int* s_own, int r0, int n,
                                                const int* times, const int* seg,
                                                size_t base) {
  if (threadIdx.x < kOwn) {
    const int i = r0 + threadIdx.x;
    const bool live = i < n;
    s_own[threadIdx.x] = live ? i : -1;
    s_own[kOwn + threadIdx.x] = (times && live) ? times[base + i] : 0;
    s_own[2 * kOwn + threadIdx.x] = (seg && live) ? seg[base + i] : 0;
  }
}

// Whether the mask admits any pair of (the CTA's owned rows) x (walked rows
// w0 .. w0 + W of length n_walk), and in `all` whether it admits every one.
// Each thread tests one walked row against W / 4 owned rows.
// kOwnedIsQ: the owned rows are queries (forward, dq) or keys (dk/dv).
template <int W, bool kOwnedIsQ>
__device__ __forceinline__ bool tile_admits(const Mask& mk, const int* s_own,
                                            int w0, int n_walk, const int* times,
                                            const int* seg, size_t base,
                                            bool& all) {
  const int j = w0 + threadIdx.x % W;
  const bool in = j < n_walk;
  const int jt = (times && in) ? times[base + j] : 0;
  const int js = (seg && in) ? seg[base + j] : 0;
  bool any_ok = false, all_ok = in;
  for (int o = threadIdx.x / W; o < kOwn; o += kThreads / W) {
    const int oi = s_own[o], ot = s_own[kOwn + o], os = s_own[2 * kOwn + o];
    const bool ok = in && oi >= 0 &&
                    (kOwnedIsQ ? admitted(mk, oi, j, ot, jt, os, js)
                               : admitted(mk, j, oi, jt, ot, js, os));
    any_ok = any_ok || ok;
    all_ok = all_ok && ok;
  }
  if (!__syncthreads_or(any_ok)) return false;
  all = __syncthreads_and(all_ok);
  return true;
}

// Write a 16 x 8 accumulator tile (rows r0 + g, r0 + g + 8 of `n` rows;
// columns c0 + 2t, c0 + 2t + 1 of `width`) to a row-major output, the two
// columns of a row in one store where the width is even (so that each
// warp store fills whole 32-byte sectors), one at a time where it is odd
// (a pair would straddle rows and lose its alignment).
template <typename T>
__device__ __forceinline__ void store_tile(T* out, const float (&c)[4], int r0,
                                           int n, int c0, int width, int g, int t) {
  const int col = c0 + 2 * t;
  if (col >= width) return;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + g + 8 * h;
    if (row < n) {
      T* p = out + (size_t)row * width + col;
      if (width % 2 == 0) {
        if constexpr (std::is_same<T, float>::value)
          *reinterpret_cast<float2*>(p) = make_float2(c[2 * h], c[2 * h + 1]);
        else
          *reinterpret_cast<__nv_bfloat162*>(p) =
              __floats2bfloat162_rn(c[2 * h], c[2 * h + 1]);
      } else {
        p[0] = from_f<T>(c[2 * h]);
        if (col + 1 < width) p[1] = from_f<T>(c[2 * h + 1]);
      }
    }
  }
}

// ---- rows wider than 256: output column windows ---------------------------
//
// A row wider than kMaxWindow columns does not fit the register-resident
// accumulators. The launch then runs ceil(width / kMaxWindow) balanced
// passes; pass p accumulates and writes only the output columns
// [d0, d0 + dw) of the D-wide outputs (dq, dk) and [v0, v0 + vw) of the
// Dv-wide ones (out, dv). Every pass recomputes the scores S (and dP) over
// the whole rows in the same order, so the passes' softmax statistics
// agree bitwise. Where S's operands come from is the kernels' template
// argument kWin, picked by the launch from what fits shared memory:
constexpr int kWinNone = 0;    // rows up to kMaxWindow: every column, one pass
constexpr int kWinStaged = 1;  // whole rows staged in shared memory, as kWinNone,
                               // the output's own operand (V, or K / Q / dO of
                               // the backward's products) read at its window
constexpr int kWinOwned = 2;   // the backward: the owned rows' whole rows
                               // staged, the walked rows' read from device memory
constexpr int kWinGlobal = 3;  // every S operand read from device memory
                               // (score_chunk_g): any width
constexpr int kMaxWindow = 256;

struct Win {
  int d0, dw, v0, vw;
};

__host__ __device__ __forceinline__ int window_passes(int D, int Dv) {
  const int w = D > Dv ? D : Dv;
  return (w + kMaxWindow - 1) / kMaxWindow;
}

// Pass p of `passes` balanced windows over both widths.
__host__ __device__ __forceinline__ Win window_of(int p, int passes, int D, int Dv) {
  return Win{p * D / passes, (p + 1) * D / passes - p * D / passes,
             p * Dv / passes, (p + 1) * Dv / passes - p * Dv / passes};
}

// A (16 x 8) as frag_a, from a row-major (n, width) array in device
// memory: zero past its n rows and its width.
template <bool kExact, typename T>
__device__ __forceinline__ FragA frag_a_g(const T* __restrict__ a, int n, int width,
                                          int m0, int k0, int g, int t) {
  FragA f;
  const int c0 = k0 + t, c1 = c0 + 4;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = m0 + g + 8 * h;
    const T* p = a + (size_t)r * width;
    const bool in = r < n;
    split<kExact>(in && c0 < width ? to_f(p[c0]) : 0.f, f.big[h], f.small[h]);
    split<kExact>(in && c1 < width ? to_f(p[c1]) : 0.f, f.big[2 + h], f.small[2 + h]);
  }
  return f;
}

// B (8 x 8) as frag_b_rows, from a row-major (n, width) array in device
// memory: zero past its n rows and its width.
template <bool kExact, typename T>
__device__ __forceinline__ FragB frag_b_rows_g(const T* __restrict__ b, int n, int width,
                                               int n0, int k0, int g, int t) {
  FragB f;
  const int r = n0 + g, c0 = k0 + t, c1 = c0 + 4;
  const T* p = b + (size_t)r * width;
  const bool in = r < n;
  split<kExact>(in && c0 < width ? to_f(p[c0]) : 0.f, f.big[0], f.small[0]);
  split<kExact>(in && c1 < width ? to_f(p[c1]) : 0.f, f.big[1], f.small[1]);
  return f;
}

// score_chunk with both operands read from device memory: A rows m0 ..
// m0 + 16 of the (an, width) array a, B rows n0 ... of the (bn, width)
// array b.
template <int NS, bool kAExact, bool kBExact, typename TA, typename TB>
__device__ __forceinline__ void score_chunk_g(float (&d)[NS][4], const TA* a, int an,
                                              int m0, const TB* b, int bn, int n0,
                                              int k0, int width, int g, int t) {
#pragma unroll
  for (int u = 0; u < kChunk; ++u) {
    const int kk = k0 + 8 * u;
    if (kk < width) {
      const FragA fa = frag_a_g<kAExact>(a, an, width, m0, kk, g, t);
#pragma unroll
      for (int n = 0; n < NS; ++n)
        mma3<kAExact, kBExact>(d[n], fa,
                               frag_b_rows_g<kBExact>(b, bn, width, n0 + n * 8, kk, g, t));
    }
  }
}

// score_chunk with A from shared memory (rows m0 .. m0 + 16 of sa) and B
// from device memory (rows n0 ... of the (bn, width) array b).
template <int NS, bool kAExact, bool kBExact, typename TB>
__device__ __forceinline__ void score_chunk_sg(float (&d)[NS][4], const float* sa,
                                               int sa_stride, int m0, const TB* b,
                                               int bn, int n0, int k0, int width,
                                               int g, int t) {
#pragma unroll
  for (int u = 0; u < kChunk; ++u) {
    const int kk = k0 + 8 * u;
    if (kk < width) {
      const FragA fa = frag_a<kAExact>(sa, sa_stride, m0, kk, g, t);
#pragma unroll
      for (int n = 0; n < NS; ++n)
        mma3<kAExact, kBExact>(d[n], fa,
                               frag_b_rows_g<kBExact>(b, bn, width, n0 + n * 8, kk, g, t));
    }
  }
}

// Copy columns [0, width) of rows [0, nrows) of a row-major array of row
// stride ld (a window of wider rows) into shared memory at row stride
// `stride`: float32 into float32 by cp.async (8-byte units where every
// row start allows them, else 4; the caller commits and waits), any other
// case an element a thread, synchronously (TS float converts).
template <typename T, typename TS>
__device__ void load_window(const T* __restrict__ src, int nrows, int width, int ld,
                            TS* dst, int stride) {
  if constexpr (std::is_same<T, float>::value && std::is_same<TS, float>::value) {
    const bool pairs = ((reinterpret_cast<uintptr_t>(src) & 7) == 0) &&
                       ((reinterpret_cast<uintptr_t>(dst) & 7) == 0) && ld % 2 == 0 &&
                       stride % 2 == 0 && width % 2 == 0;
    const int unit = pairs ? 2 : 1, per = width / unit, n = nrows * per;
    for (int c = threadIdx.x; c < n; c += blockDim.x) {
      const int r = c / per, col = (c - r * per) * unit;
      if (pairs)
        cp_async_small<2>(dst + r * stride + col, src + (size_t)r * ld + col);
      else
        cp_async_small<1>(dst + r * stride + col, src + (size_t)r * ld + col);
    }
  } else {
    const int n = nrows * width;
    for (int e = threadIdx.x; e < n; e += blockDim.x) {
      const int r = e / width, c = e - r * width;
      if constexpr (std::is_same<TS, float>::value)
        dst[r * stride + c] = to_f(src[(size_t)r * ld + c]);
      else
        dst[r * stride + c] = src[(size_t)r * ld + c];
    }
  }
}

// The shared memory a CTA of the current device may opt into.
inline size_t max_shared_bytes() {
  int dev = 0, bytes = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return (size_t)bytes;
}

// store_tile into a column window: columns c0 + 2t, c0 + 2t + 1 (where <
// width) of rows of stride ld, a column at a time.
template <typename T>
__device__ __forceinline__ void store_tile_window(T* out, const float (&c)[4], int r0,
                                                  int n, int c0, int width, int ld,
                                                  int g, int t) {
  const int col = c0 + 2 * t;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + g + 8 * h;
    if (row < n) {
      T* p = out + (size_t)row * ld + col;
      if (col < width) p[0] = from_f<T>(c[2 * h]);
      if (col + 1 < width) p[1] = from_f<T>(c[2 * h + 1]);
    }
  }
}

// The m16 block of warp w: w for w < 4, 7 - w for the second warp of each
// block. A scheduler runs warps w and w + 4, so each pairs a block near
// the top of the owned rows with one near the bottom; where the mask
// cuts a tile diagonally, a warp with no admitted pair skips the tile and
// leaves its scheduler to the other.
__device__ __forceinline__ int mirrored_block(int warp) {
  return warp < kBlocks ? warp : 2 * kBlocks - 1 - warp;
}

// The accumulators' n8 tiles (NT) are compile-time: one instantiation per
// width bucket, the widest walking 16-row tiles to stay in shared memory.
// The sim arch's float32 width, c = 200, also gets its widths and strides
// at compile time (constant fragment offsets, no divisions in the copies).
#define DISPATCH_WIDTH(launch, ...)                                            \
  do {                                                                         \
    if constexpr (std::is_same<T, float>::value)                               \
      if (D == 200 && Dv == 200) return launch<T, 25, 32, 200>(__VA_ARGS__);   \
    const int nt = ((D > Dv ? D : Dv) + 7) / 8;                                \
    if (nt <= 8) return launch<T, 8, 32, 0>(__VA_ARGS__);                      \
    if (nt <= 16) return launch<T, 16, 32, 0>(__VA_ARGS__);                    \
    if (nt <= 25) return launch<T, 25, 32, 0>(__VA_ARGS__);                    \
    if (nt <= 32) return launch<T, 32, 16, 0>(__VA_ARGS__);                    \
    return cudaErrorInvalidValue;                                              \
  } while (0)

}  // namespace
