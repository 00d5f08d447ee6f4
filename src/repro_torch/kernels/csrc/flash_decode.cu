// Split-K ragged online-softmax decode over a layer-stacked K/V cache, on
// the tensor cores.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_decode.py:
// _decode_kernel (:115, pallas_call at :364) and its split combine
// _combine_splits (:212). A few new query rows of each (batch row, kv
// head) attend the live prefix of the cache, up to the row's cursor
// kv_length[b]; masks: block-causal k_time <= q_time where times are given
// (never an index-causal term), segment q_seg == k_seg && k_seg >= 0, GQA
// h // group. A query row with no live key gives exactly 0.
//
// A sliding window and a score softcap (gemma2's local and every layer;
// the Pallas kernel has neither, the reference decodes gemma2 in XLA):
// a key is kept where k_time > q_time - window, as the flash kernels and
// the reference's chunked path keep it, and the scaled score becomes
// softcap * tanh(s / softcap) before the running max. They are the
// template flag kWinCap: the instances without it are the ones this kernel
// had before, so a launch with neither compiles and computes as it did.
// With it, the CTA of several blocks also tests the window before it loads
// a tile (a tile wholly below every row's window is skipped); the one-block
// CTA walks every tile to the cursor and masks. Taken at widths up to 200
// (the NT = 25 instances, generic width).
//
// Bound on Hopper: bytes. A rollout tick (64 slots x 8 heads x 12 query
// rows against 312 live rows, c = 200, float32 cache) moves 255.6 MB of K
// and V for 3 GFLOP: 0.076 ms at 3.35 TB/s. The prefill (144 query rows
// against 144 keys) moves 118 MB. So the design reads each live K/V row
// from device memory as few times as it can and keeps enough bytes in
// flight, and runs the products on the tensor cores so that the arithmetic
// stays off the critical path:
//   * A CTA owns every query row of one (batch row, kv head, key split):
//     the group's q heads x Sq rows, in m16 blocks. Up to 16 rows (the
//     tick: 12) a CTA is one block and its 8 warps each take 8 keys of a
//     64-key tile; more rows go in CTAs of up to 4 blocks whose two warps
//     each take 16 keys of a 32-key tile, the blocks dealt evenly (the
//     prefill's 144 rows as 3 CTAs of 48, not 64 + 64 + 16: 1.11x faster
//     at the prefill on an H100, benchmarks/torch_flash_ab.py). So each
//     K/V tile is read once per row tile, not once per 16 query rows of
//     each q head (the CUDA-core design before this one read the
//     prefill's 9 times).
//   * K/V tiles land in a ring of 2 (float32) or 3 (bf16, int8) shared
//     buffers by cp.async, with their keys' mask fields and int8 scales;
//     each step waits for its tile, passes one barrier (which also frees
//     the buffer of the tile before) and issues the tile kStages - 1 ahead
//     into that buffer before computing. float32 rows land at the padded
//     stride mma_stride(width); bf16 and int8 rows keep their own width
//     where it is an odd multiple of 8 (c = 200), so a tile is one
//     contiguous run, copied flat in 16-byte chunks (an int8 row is 200 B,
//     not a multiple of 16). Nothing is converted on the way in: the
//     fragment readers widen bf16 and int8 to float32 as they read, and
//     both are exact in TF32. The (L, B, Hkv, S, c) cache is addressed in
//     place at `layer`; no per-layer slice is copied, and no row past the
//     cursor is read.
//   * S = Q K^T and O += P V on the tensor cores, mma.sync m16n8k8 .tf32 in
//     split TF32 (mma_tf32.cuh): float32 operands as big + small, S summed
//     in compensated chunks of two k8 steps (one TF32 product on S misses
//     the float32 tolerance, tests/test_torch_tf32.py). A bf16 or int8 K/V
//     operand has no small part. int8's per-row scales multiply S by
//     column (k_scale) and P by row (v_scale) after and before the
//     products, each through a select, so that a NaN scale past the cursor
//     never meets a product.
//   * 0 * NaN: the products read every row of a tile, so each warp zeroes,
//     before its P V, the V rows of its keys that no query row of the CTA
//     reaches (rows past the cursor included; a stale row there may hold
//     any bits). Garbage in K only reaches S entries the mask replaces.
//   * A CTA of several blocks tests the mask on all pairs of a tile before
//     loading it (one ballot a warp, one barrier) and skips a tile it
//     admits nowhere (block-causal prefill rows above the diagonal); the
//     test gives the reach of the tile's keys. A one-block CTA (the tick)
//     loads every tile up to the cursor with one barrier a tile, and each
//     warp finds the reach of its keys from its own mask by ballots, its
//     rows being all the CTA's; with the keys' fields staged in shared
//     memory that made the tick 1.09-1.12x (float32) and 1.24-1.28x
//     (int8) faster on an H100 (benchmarks/torch_flash_ab.py). A warp none of whose
//     pairs is admitted skips the tile's products.
//   * The warps of a block keep their own (m, l, O) over their keys and
//     merge them once, at the end, in a fixed order through shared memory,
//     each warp taking some of the output's 8-column tiles. With one split
//     the kernel writes the normalised rows itself; with more, each split
//     writes its (m, l, O) partial and combine_kernel, one warp a row,
//     joins them in split order. Every sum runs in a fixed order: the
//     decode is bitwise repeatable. num_splits = None takes one split
//     wherever the (row tile, kv head, batch row) CTAs already give every
//     SM one; two splits at the tick were 1.1x slower on an H100.
//   * Shared memory at c = 200, float32: Q 13,056 B (tick) / 52,224 B
//     (prefill), the ring 208,896 B / 104,448 B, the keys' fields 2 KB /
//     1 KB: one CTA of 8 warps an SM.
//   * Rows wider than 256 (se2_fourier at head_dim >= 36: c >= 300): the
//     launch runs ceil(width / 256) balanced column windows of O (300 as
//     2 x 150), each recomputing S over the whole rows and writing its
//     columns of out, or of the split partials, which combine_kernel joins
//     once over the whole rows. Every pass computes the same m and l. Q
//     and the ring's K stay whole beside V's window where they fit (to
//     about 500 columns in float32, kWinStaged); wider, every pass reads
//     them from device memory (kWinGlobal).
//   * Any row width from 1 to 256 (se2_fourier caches c = 50 head_dim / 6,
//     c = 150 at head_dim 18). Rows are copied in the widest cp.async unit
//     that every row start allows: 16 bytes at c = 200 float32, 8 bytes at
//     c = 150 float32 (600-byte rows), 4 bytes at c = 150 bf16 (300-byte
//     rows). cp.async moves no unit under 4 bytes, so an int8 or bf16 row
//     whose bytes are not a multiple of 4 (c = 150 int8: 150 bytes) is
//     copied synchronously in 2- or 1-byte units; that costs latency at
//     those widths only. The output's pairs of columns are written in one
//     store for even widths and one at a time for odd ones, and the split
//     combine takes a column a lane where the width is not a multiple of 4.
//     The k8 padding columns of Q and K stay zero as before.
//   * The query is float32 or bfloat16 (the bf16 model's), a compile-time
//     type (TQ), converted as it lands; the output takes the query's type,
//     as the reference's does. Both query loads compute each element's
//     address from its (q head, row), as the float32 one always has: with
//     a flat run's address instead, ptxas spilled registers in the 4-block
//     c = 200 instances.
// Measured on an H100, neither shape runs at its byte bound: with its
// loads switched off the first version of this kernel kept 72% (tick) and
// 93% (prefill) of its time, in the products and the per-tile walk
// (PERF.md).
#include "mma_tf32.cuh"

namespace {

// A decode CTA: kWarps warps own MB m16 blocks of query rows; the
// kWarps / MB warps of a block each take 8 NS keys of every W-key tile.
template <int MB, int NS>
struct Cfg {
  static constexpr int kRows = 16 * MB;
  static constexpr int kWPB = kWarps / MB;
  static constexpr int kKeys = 8 * NS;
  static constexpr int W = kWPB * kKeys;
};

// Shared row stride (elements) of a K or V tile of T. float32 as the flash
// kernels; bf16 / int8 the width rounded to 8 and then to an odd multiple
// of 8, which keeps the fragment reads free of bank conflicts and leaves
// c = 200 unpadded.
template <typename T>
__host__ __device__ __forceinline__ int kv_stride(int width) {
  if (std::is_same<T, float>::value) return mma_stride(width);
  const int w8 = (width + 7) / 8 * 8;
  return w8 % 16 ? w8 : w8 + 8;
}

// One operand element as big + small, a bf16 or int8 element exactly big.
template <typename T>
__device__ __forceinline__ void split_t(T x, uint32_t& big, uint32_t& small) {
  if constexpr (std::is_same<T, float>::value) {
    split<false>(x, big, small);
  } else {
    big = __float_as_uint(to_f(x));
    small = 0u;
  }
}

// frag_b_rows / frag_b_cols of mma_tf32.cuh over a shared tile of T.
template <typename T>
__device__ __forceinline__ FragB kv_rows(const T* s, int stride, int n0, int k0,
                                         int g, int t) {
  FragB f;
  const T* p = s + (n0 + g) * stride + k0 + t;
  split_t(p[0], f.big[0], f.small[0]);
  split_t(p[4], f.big[1], f.small[1]);
  return f;
}
template <typename T>
__device__ __forceinline__ FragB kv_cols(const T* s, int stride, int k0, int n0,
                                         int g, int t) {
  FragB f;
  const T* p = s + (k0 + 2 * t) * stride + n0 + g;
  split_t(p[0], f.big[0], f.small[0]);
  split_t(p[stride], f.big[1], f.small[1]);
  return f;
}

template <int N>
__device__ __forceinline__ void cp_async_n(char* dst, const char* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  if constexpr (N == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d), "l"(src),
                 "n"(N)
                 : "memory");
}

template <int N>
__device__ __forceinline__ void copy_chunks(const char* s, char* d, int nrows,
                                            int row_bytes, int stride_bytes) {
  const int per = row_bytes / N, n = nrows * per;
  for (int c = threadIdx.x; c < n; c += blockDim.x) {
    const int r = c / per, x = (c - r * per) * N;
    cp_async_n<N>(d + r * stride_bytes + x, s + (size_t)r * row_bytes + x);
  }
}

// Copy rows of U-byte units synchronously, a unit a thread at a time
// (cp.async moves 4, 8 or 16 bytes only; no buffers, so the main loop's
// registers stay the accumulators').
template <typename U>
__device__ __forceinline__ void copy_units_sync(const char* s, char* d, int nrows,
                                                int row_bytes, int stride_bytes) {
  const int per = row_bytes / (int)sizeof(U), n = nrows * per;
  const U* src = reinterpret_cast<const U*>(s);
  for (int c = threadIdx.x; c < n; c += blockDim.x) {
    const int r = c / per;
    reinterpret_cast<U*>(d + r * stride_bytes)[c - r * per] = src[c];
  }
}

// Start copying rows [0, nrows) of a contiguous (rows, width) tile of T
// into shared memory at row stride `stride` by cp.async, in the widest
// chunks both sides allow; the caller commits and waits. Rows that lie in
// shared memory as in device memory are one flat run (widths that are
// multiples of 8). A bf16 or int8 row whose bytes are not a multiple of 4
// (c = 150 int8, or an odd width) is copied synchronously, 2 or 1 bytes a
// unit; the ring's barrier before the tile is computed covers those
// stores as it covers the cp.async ones.
template <typename T>
__device__ __forceinline__ void copy_rows(const T* src, int nrows, int width,
                                          T* dst, int stride) {
  const char* s = reinterpret_cast<const char*>(src);
  char* d = reinterpret_cast<char*>(dst);
  const int rb = width * (int)sizeof(T), sb = stride * (int)sizeof(T);
  const uintptr_t base = reinterpret_cast<uintptr_t>(s) | reinterpret_cast<uintptr_t>(d);
  if (stride == width) {
    const int n = nrows * rb;
    int done = 0;
    if ((base & 15) == 0) {
      copy_chunks<16>(s, d, 1, n / 16 * 16, 0);
      done = n / 16 * 16;
    }
    copy_chunks<4>(s + done, d + done, 1, n - done, 0);
    return;
  }
  const uintptr_t al = base | (uintptr_t)rb | (uintptr_t)sb;
  if ((al & 15) == 0)
    copy_chunks<16>(s, d, nrows, rb, sb);
  else if ((al & 7) == 0)
    copy_chunks<8>(s, d, nrows, rb, sb);
  else if (sizeof(T) == 4 || (al & 3) == 0)   // float32 rows: always
    copy_chunks<4>(s, d, nrows, rb, sb);
  else if constexpr (sizeof(T) < 4) {
    if ((al & 1) == 0)
      copy_units_sync<uint16_t>(s, d, nrows, rb, sb);
    else
      copy_units_sync<uint8_t>(s, d, nrows, rb, sb);
  }
}

// Write columns col, col + 1 (where < width) of an output row of T: a
// pair in one store where the width is even, one at a time where it is odd.
template <typename T>
__device__ __forceinline__ void store_pair(T* row, int col, int width, float a,
                                           float b) {
  if (col >= width) return;
  T* p = row + col;
  if (width % 2 == 0) {
    if constexpr (std::is_same<T, float>::value)
      *reinterpret_cast<float2*>(p) = make_float2(a, b);
    else
      *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
  } else {
    p[0] = from_f<T>(a);
    if (col + 1 < width) p[1] = from_f<T>(b);
  }
}

// Columns col, col + 1 (where < width) of a row window, a column at a time.
template <typename T>
__device__ __forceinline__ void store_window(T* row, int col, int width, float a,
                                             float b) {
  if (col < width) row[col] = from_f<T>(a);
  if (col + 1 < width) row[col + 1] = from_f<T>(b);
}

// The warp of block `blk` that takes key slice `slice` (mirrored_block's
// inverse for 4 blocks).
template <int MB>
__device__ __forceinline__ int warp_of(int blk, int slice) {
  if constexpr (MB == 1) return slice;
  else return slice == 0 ? blk : 2 * kBlocks - 1 - blk;
}

// One CTA per (row tile, split) x kv head x batch row. Rows of the CTA:
// r0 .. r_end of the group's R (q head, query) rows, q head major; the
// m16 blocks of R are dealt evenly over the ceil(blocks / MB) row tiles
// (the prefill's 9 blocks as 3 + 3 + 3, not 4 + 4 + 1).
template <typename T, typename TQ, int MB, int NS, int NT, int kStages, int kWidth,
          int kWin, bool kWinCap>
__global__ void __launch_bounds__(kThreads, 1)
decode_kernel(const TQ* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const float* __restrict__ k_scale,
              const float* __restrict__ v_scale, const int* __restrict__ kv_length,
              const int* __restrict__ q_times, const int* __restrict__ k_times,
              const int* __restrict__ q_seg, const int* __restrict__ k_seg,
              TQ* __restrict__ out, float* __restrict__ o_part,
              float* __restrict__ m_part, float* __restrict__ l_part, int B,
              int Hq, int Hkv, int Sq, int S, int D_arg, int Dv_arg, int layer,
              int num_splits, int tiles_per_split, float scale, Win win,
              int window, float softcap) {
  using C = Cfg<MB, NS>;
  constexpr int W = C::W, kRows = C::kRows, kWPB = C::kWPB, kWords = (W + 31) / 32;
  constexpr bool kExact = !std::is_same<T, float>::value;
  constexpr bool kQuant = std::is_same<T, int8_t>::value;
  const int D = kWidth ? kWidth : D_arg, Dv = kWidth ? kWidth : Dv_arg;
  // the output columns this launch writes: all, or a window (mma_tf32.cuh;
  // with kWinGlobal Q and K stay in device memory and the ring holds V's
  // window only)
  constexpr bool kStaged = kWin != kWinGlobal;
  const int Do = kWin ? win.vw : Dv;
  const int qs = kStaged ? mma_stride(D) : 0, ks = kStaged ? kv_stride<T>(D) : 0;
  const int vs = kv_stride<T>(Do);
  const int slot = W * (ks + vs);            // elements of one ring buffer
  extern __shared__ float4 smem4[];
  float* s_q = reinterpret_cast<float*>(smem4);                   // [kRows][qs]
  T* s_ring = reinterpret_cast<T*>(s_q + kRows * qs);             // kStages x (K, V)
  int* s_own = reinterpret_cast<int*>(s_ring + kStages * slot);   // [3][kRows]
  uint32_t* s_bal = reinterpret_cast<uint32_t*>(s_own + 3 * kRows);  // [2][kWarps]
  int* s_meta = reinterpret_cast<int*>(s_bal + 2 * kWarps);      // kStages x [4][W]

  const int rt = blockIdx.x / num_splits, split = blockIdx.x % num_splits;
  const int hk = blockIdx.y, b = blockIdx.z;
  const int group = Hq / Hkv, R = group * Sq;
  const int blocks = (R + 15) / 16, row_tiles = (blocks + MB - 1) / MB;
  const int rows_per = (blocks + row_tiles - 1) / row_tiles * 16;
  const int r0 = rt * rows_per, r_end = min(R, r0 + rows_per);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int blk = MB == 1 ? 0 : mirrored_block(warp);
  const int j_off = (MB == 1 ? warp : warp / kBlocks) * C::kKeys;

  // A width off the k8 step: the padding columns of Q and K that the
  // tensor cores read are zeroed. (Rows past the live ones may hold any
  // bits: their scores are masked and their P is 0 by a select.)
  if (kStaged && D % 8) {
    zero_shared(smem4, kRows * qs / 4);
    const int pad = 8 - D % 8, n = kStages * W * pad;
    for (int e = threadIdx.x; e < n; e += kThreads) {
      const int r = e / pad;
      char* p = reinterpret_cast<char*>(s_ring + (r / W) * slot + (r % W) * ks + D + e % pad);
      for (int x = 0; x < (int)sizeof(T); ++x) p[x] = 0;
    }
    __syncthreads();
  }
  {
    // a float32 query lands by cp.async, a bf16 one converted as it loads
    const int nrow = kStaged ? r_end - r0 : 0;
    if constexpr (std::is_same<TQ, float>::value) {
      // 16-byte copies where the rows allow them (widths that are multiples
      // of 4), else 4-byte ones
      const bool al16 = (reinterpret_cast<uintptr_t>(q) & 15) == 0 && D % 4 == 0;
      const int unit = al16 ? 4 : 1, per = D / unit;
      for (int c = threadIdx.x; c < nrow * per; c += kThreads) {
        const int r = c / per, col = (c - r * per) * unit, row = r0 + r;
        const float* src = q + ((size_t)(b * Hq + hk * group + row / Sq) * Sq + row % Sq) * D + col;
        if (al16) cp_async16(s_q + r * qs + col, src);
        else cp_async_small<1>(s_q + r * qs + col, src);
      }
    } else {                                 // bf16: an element a thread
      for (int c = threadIdx.x; c < nrow * D; c += kThreads) {
        const int r = c / D, col = c - r * D, row = r0 + r;
        s_q[r * qs + col] = to_f(
            q[((size_t)(b * Hq + hk * group + row / Sq) * Sq + row % Sq) * D + col]);
      }
    }
    cp_async_commit();
    if (threadIdx.x < kRows) {
      const int row = r0 + threadIdx.x, qi = row % Sq;
      const bool live = row < r_end;
      s_own[threadIdx.x] = live ? row : -1;
      s_own[kRows + threadIdx.x] = (q_times && live) ? q_times[(size_t)b * Sq + qi] : 0;
      s_own[2 * kRows + threadIdx.x] = (q_seg && live) ? q_seg[(size_t)b * Sq + qi] : 0;
    }
    cp_async_wait<0>();
    __syncthreads();
  }

  // this thread's accumulator rows: g and g + 8 of the warp's block
  bool row_ok[2];
  int row_t[2], row_s[2];
  float m[2], l[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int o = blk * 16 + g + 8 * r;
    row_ok[r] = s_own[o] >= 0;
    row_t[r] = s_own[kRows + o];
    row_s[r] = s_own[2 * kRows + o];
    m[r] = kNegInf;
    l[r] = 0.f;
  }
  float acc[NT][4] = {};

  const int kv_end = max(0, min(kv_length[b], S));
  const size_t head = ((size_t)layer * B + b) * Hkv + hk;   // (layer, b, hk)
  const T* kh = k + head * S * D;
  const T* vh = v + head * S * Dv;
  const float* ksh = kQuant ? k_scale + head * S : nullptr;
  const float* vsh = kQuant ? v_scale + head * S : nullptr;
  const int* kt_b = k_times ? k_times + (size_t)b * S : nullptr;
  const int* ks_b = k_seg ? k_seg + (size_t)b * S : nullptr;
  const int tile_lo = split * tiles_per_split;
  const int tile_hi = min(tile_lo + tiles_per_split, (kv_end + W - 1) / W);

  // Whether the mask admits a pair of (the CTA's rows) x (key tile kt);
  // reach gets the tile's keys some row admits, 32 a word. One barrier.
  // (A one-block CTA tests nothing: its warps' own rows are all its rows,
  // and each warp finds the reach of its keys itself.)
  int tests = 0;
  auto test = [&](int kt, uint32_t (&reach)[kWords]) {
    const int j = kt * W + threadIdx.x % W;
    const bool in = j < kv_end;
    const int jt = (kt_b && in) ? kt_b[j] : 0, js = (ks_b && in) ? ks_b[j] : 0;
    bool any = false;
    if (in)
      for (int o = threadIdx.x / W; o < kRows; o += kThreads / W) {
        bool ok = s_own[o] >= 0;
        if (kt_b) ok = ok && jt <= s_own[kRows + o];
        if constexpr (kWinCap)
          if (window > 0) ok = ok && jt > s_own[kRows + o] - window;
        if (ks_b) ok = ok && js == s_own[2 * kRows + o] && js >= 0;
        any = any || ok;
      }
    const uint32_t bal = __ballot_sync(0xffffffffu, any);
    uint32_t* sb = s_bal + (tests++ & 1) * kWarps;
    if (lane == 0) sb[warp] = bal;
    __syncthreads();
    bool live = false;
#pragma unroll
    for (int w = 0; w < kWords; ++w) reach[w] = 0u;
#pragma unroll
    for (int u = 0; u < kWarps; ++u) {
      uint32_t x = sb[u];
      if constexpr (W < 32) {                // a warp tests 32 / W row groups
#pragma unroll
        for (int sh = W; sh < 32; sh += W) x |= x >> sh;
        reach[0] |= x & ((1u << W) - 1);
      } else {
        reach[(u * 32 % W) / 32] |= x;
      }
    }
#pragma unroll
    for (int w = 0; w < kWords; ++w) live = live || reach[w] != 0u;
    return live;
  };
  auto next_live = [&](int kt, uint32_t (&reach)[kWords]) {
    if constexpr (MB > 1)
      while (kt < tile_hi && !test(kt, reach)) ++kt;
    return kt;
  };
  // K, V and the keys' mask fields and int8 scales of tile kt into ring
  // buffer sl (the fields of keys past the cursor are never read)
  auto issue = [&](int kt, int sl) {
    T* sk = s_ring + sl * slot;
    const int k0 = kt * W, nk = min(W, kv_end - k0);
    if constexpr (kStaged) copy_rows<T>(kh + (size_t)k0 * D, nk, D, sk, ks);
    if constexpr (kWin != kWinNone)
      load_window<T>(vh + (size_t)k0 * Dv + win.v0, nk, Do, Dv, sk + W * ks, vs);
    else
      copy_rows<T>(vh + (size_t)k0 * Dv, nk, Dv, sk + W * ks, vs);
    if ((int)threadIdx.x < nk) {
      char* mt = reinterpret_cast<char*>(s_meta + sl * 4 * W + threadIdx.x);
      const int j = k0 + threadIdx.x;
      if (kt_b) cp_async_n<4>(mt, reinterpret_cast<const char*>(kt_b + j));
      if (ks_b) cp_async_n<4>(mt + 4 * W, reinterpret_cast<const char*>(ks_b + j));
      if constexpr (kQuant) {
        cp_async_n<4>(mt + 8 * W, reinterpret_cast<const char*>(ksh + j));
        cp_async_n<4>(mt + 12 * W, reinterpret_cast<const char*>(vsh + j));
      }
    }
  };

  auto compute = [&](int kt, const uint32_t (&reach)[kWords], int sl) {
    const T* sk = s_ring + sl * slot;
    T* sv = s_ring + sl * slot + W * ks;
    const int* mt = s_meta + sl * 4 * W;
    // the mask on this warp's 16 x kKeys pairs, and int8's scales of its
    // keys (0 past the cursor, by a select)
    bool ok[NS][4], live = false;
    float kscl[NS][2], vscl[NS][2];
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int x = j_off + n * 8 + 2 * t + h, j = kt * W + x;
        const bool in = j < kv_end;
        const int jt = (kt_b && in) ? mt[x] : 0, js = (ks_b && in) ? mt[W + x] : 0;
        if constexpr (kQuant) {
          kscl[n][h] = in ? __int_as_float(mt[2 * W + x]) : 0.f;
          vscl[n][h] = in ? __int_as_float(mt[3 * W + x]) : 0.f;
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          bool o_k = in && row_ok[r];
          if (kt_b) o_k = o_k && jt <= row_t[r];
          if constexpr (kWinCap)
            if (window > 0) o_k = o_k && jt > row_t[r] - window;
          if (ks_b) o_k = o_k && js == row_s[r] && js >= 0;
          ok[n][2 * r + h] = o_k;
          live = live || o_k;
        }
      }
    if (!__any_sync(0xffffffffu, live)) return;
    if constexpr (!kQuant) {
      // zero the V rows of this warp's keys that no row of the CTA reaches
      uint32_t mine = 0u;
      if constexpr (MB == 1) {               // the warp's rows are the CTA's
#pragma unroll
        for (int n = 0; n < NS; ++n)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            uint32_t x = __ballot_sync(0xffffffffu, ok[n][h] || ok[n][2 + h]);
            x |= x >> 16;                    // bit t: a lane of quad column t
            x |= x >> 8;
            x |= x >> 4;
            x = (x & 1u) | (x & 2u) << 1 | (x & 4u) << 2 | (x & 8u) << 3;
            mine |= x << (n * 8 + h);        // key n * 8 + 2t + h
          }
      } else {
        uint32_t word = reach[0];
        if constexpr (kWords > 1)
          if (j_off >= 32) word = reach[1];
        mine = word >> (j_off % 32);
      }
      constexpr uint32_t kMine = C::kKeys == 32 ? 0xffffffffu : (1u << C::kKeys) - 1;
      uint32_t dead = ~mine & kMine;
      const int words = (Do * (int)sizeof(T) + 3) / 4;  // into the padding
      while (dead) {
        const int r = __ffs(dead) - 1;
        dead &= dead - 1;
        uint32_t* row = reinterpret_cast<uint32_t*>(sv + (j_off + r) * vs);
        for (int x = lane; x < words; x += 32) row[x] = 0u;
      }
      __syncwarp();
    }
    // S = Q K^T in compensated chunks
    float s[NS][4] = {}, lo[NS][4] = {};
    for (int c0 = 0; c0 < D; c0 += 8 * kChunk) {
      float d[NS][4] = {};
      if constexpr (kWin == kWinGlobal) {
        score_chunk_g<NS, false, kExact>(
            d, q + ((size_t)(b * Hq + hk * group) * Sq + r0) * D, r_end - r0, blk * 16,
            kh + (size_t)kt * W * D, kv_end - kt * W, j_off, c0, D, g, t);
      } else {
#pragma unroll
        for (int u = 0; u < kChunk; ++u) {
          const int kk = c0 + 8 * u;
          if (kk < D) {
            const FragA a = frag_a<false>(s_q, qs, blk * 16, kk, g, t);
#pragma unroll
            for (int n = 0; n < NS; ++n)
              mma3<false, kExact>(d[n], a, kv_rows<T>(sk, ks, j_off + n * 8, kk, g, t));
          }
        }
      }
      join_chunk<NS>(s, lo, d);
    }
    // scaled, masked scores; the rows' max over the warp's keys
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = kNegInf;
        if (ok[n][e]) {
          x = s[n][e] + lo[n][e];
          if constexpr (kQuant) x *= kscl[n][e % 2];
          x *= scale;
          if constexpr (kWinCap)
            if (softcap > 0.f) x = tanhf(x / softcap) * softcap;
        }
        s[n][e] = x;
        mx[e / 2] = fmaxf(mx[e / 2], x);
      }
    float alpha[2];
    bool rose = false;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      rose = rose || m_new > m[r];
      alpha[r] = expf(m[r] - m_new);         // exactly 1 where the max held
      l[r] *= alpha[r];
      m[r] = m_new;
    }
    if (__any_sync(0xffffffffu, rose)) {
#pragma unroll
      for (int c = 0; c < NT; ++c)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[c][i] *= alpha[i / 2];
    }
#pragma unroll
    for (int n = 0; n < NS; ++n)             // S becomes P (times v_scale)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = ok[n][e] ? expf(s[n][e] - m[e / 2]) : 0.f;
        l[e / 2] += p;
        s[n][e] = kQuant ? (ok[n][e] ? p * vscl[n][e % 2] : 0.f) : p;
      }
    FragA a[NS];                             // O += P V, a tile at a time
#pragma unroll
    for (int n = 0; n < NS; ++n) a[n] = frag_a_from_c(s[n]);
#pragma unroll
    for (int c = 0; c < NT; ++c) {
      if (c * 8 < Do) {
        float d[4] = {};
#pragma unroll
        for (int n = 0; n < NS; ++n)
          mma3<false, kExact>(d, a[n], kv_cols<T>(sv, vs, j_off + n * 8, c * 8, g, t));
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[c][i] += d[i];
      }
    }
  };

  // the ring: tile_at[s] is the live tile s places ahead (>= tile_hi: none)
  int tile_at[kStages];
  uint32_t reach_at[kStages][kWords];
  int kt = tile_lo;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    kt = next_live(kt, reach_at[s]);
    tile_at[s] = kt;
    if (kt < tile_hi) issue(kt++, s);
    cp_async_commit();
  }
  for (int i = 0; tile_at[0] < tile_hi; ++i) {
    cp_async_wait<kStages - 2>();
    // tile i in place, and every warp done with tile i - 1, whose buffer
    // (its K, V, keys' fields and the V rows zeroed there) the tile
    // kStages - 1 ahead now takes
    __syncthreads();
    kt = next_live(kt, reach_at[kStages - 1]);
    tile_at[kStages - 1] = kt;
    if (kt < tile_hi) issue(kt++, (i + kStages - 1) % kStages);
    cp_async_commit();
    compute(tile_at[0], reach_at[0], i % kStages);
#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) {
      tile_at[s] = tile_at[s + 1];
#pragma unroll
      for (int w = 0; w < kWords; ++w) reach_at[s][w] = reach_at[s + 1][w];
    }
  }

  // the warps' (m, l, O) meet in the freed shared memory; each warp joins
  // some (block, 8-column tile) items, its block's warps in key order
  cp_async_wait<0>();
  __syncthreads();
  const int nd = (Do + 7) / 8;
  float4* red = smem4;                       // [kWarps][nd][32]
  float4* red_ml = red + kWarps * nd * 32;   // [kWarps][32]
#pragma unroll
  for (int c = 0; c < NT; ++c)
    if (c < nd)
      red[(warp * nd + c) * 32 + lane] = make_float4(acc[c][0], acc[c][1], acc[c][2], acc[c][3]);
  red_ml[warp * 32 + lane] = make_float4(m[0], m[1], l[0], l[1]);
  __syncthreads();
  for (int item = warp; item < MB * nd; item += kWarps) {
    const int mb = item / nd, c = item % nd;
    float m_fin[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int u = 0; u < kWPB; ++u) {
      const float4 ml = red_ml[warp_of<MB>(mb, u) * 32 + lane];
      m_fin[0] = fmaxf(m_fin[0], ml.x);
      m_fin[1] = fmaxf(m_fin[1], ml.y);
    }
    float lr[2] = {0.f, 0.f}, o[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int u = 0; u < kWPB; ++u) {
      const int w = warp_of<MB>(mb, u);
      const float4 ml = red_ml[w * 32 + lane];
      const float a0 = expf(ml.x - m_fin[0]), a1 = expf(ml.y - m_fin[1]);
      lr[0] += ml.z * a0;
      lr[1] += ml.w * a1;
      const float4 x = red[(w * nd + c) * 32 + lane];
      o[0] += x.x * a0;
      o[1] += x.y * a0;
      o[2] += x.z * a1;
      o[3] += x.w * a1;
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {            // the quad's shares of l
      lr[r] += __shfl_xor_sync(0xffffffffu, lr[r], 1);
      lr[r] += __shfl_xor_sync(0xffffffffu, lr[r], 2);
    }
    const int col = c * 8 + 2 * t;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r0 + mb * 16 + g + 8 * r;
      if (row >= r_end) continue;
      const size_t bh = (size_t)b * Hq + hk * group + row / Sq;
      const int qi = row % Sq;
      if (num_splits == 1) {
        // what combine_kernel makes of one split, without its launch
        const float inv = 1.f / fmaxf(lr[r], 1e-30f);
        if constexpr (kWin != kWinNone)
          store_window(out + (bh * Sq + qi) * Dv + win.v0, col, Do, o[2 * r] * inv,
                       o[2 * r + 1] * inv);
        else
          store_pair(out + (bh * Sq + qi) * Dv, col, Dv, o[2 * r] * inv,
                     o[2 * r + 1] * inv);
      } else {
        const size_t prow = (bh * num_splits + split) * Sq + qi;
        if constexpr (kWin != kWinNone)
          store_window(o_part + prow * Dv + win.v0, col, Do, o[2 * r], o[2 * r + 1]);
        else
          store_pair(o_part + prow * Dv, col, Dv, o[2 * r], o[2 * r + 1]);
        if (c == 0 && t == 0) {
          m_part[prow] = m_fin[r];
          l_part[prow] = lr[r];
        }
      }
    }
  }
}

// One warp a query row: every split rescaled to the global row max and
// summed in split order, then normalised. A row with no live key has
// l == 0 and O == 0 in every split and comes out as exact zeros.
constexpr int kCombineWarps = 8;
__global__ void __launch_bounds__(kCombineWarps * 32)
combine_kernel(const float* __restrict__ o_part, const float* __restrict__ m_part,
               const float* __restrict__ l_part, void* __restrict__ out, int rows,
               int Sq, int Dv, int num_splits, int out_bf16) {
  const int row = blockIdx.x * kCombineWarps + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (row >= rows) return;
  const size_t base = (size_t)(row / Sq) * num_splits * Sq + row % Sq;  // split 0
  float m_g = kNegInf;
  for (int sp = 0; sp < num_splits; ++sp) m_g = fmaxf(m_g, m_part[base + (size_t)sp * Sq]);
  float l_g = 0.f;
  for (int sp = 0; sp < num_splits; ++sp) {
    const size_t p = base + (size_t)sp * Sq;
    l_g += l_part[p] * expf(m_part[p] - m_g);
  }
  const float inv = 1.f / fmaxf(l_g, 1e-30f);
  if (Dv % 4 || out_bf16) {                  // a column a lane
    for (int c = lane; c < Dv; c += 32) {
      float o = 0.f;
      for (int sp = 0; sp < num_splits; ++sp) {
        const size_t p = base + (size_t)sp * Sq;
        o += o_part[p * Dv + c] * expf(m_part[p] - m_g);
      }
      if (out_bf16)
        static_cast<__nv_bfloat16*>(out)[(size_t)row * Dv + c] = __float2bfloat16(o * inv);
      else
        static_cast<float*>(out)[(size_t)row * Dv + c] = o * inv;
    }
    return;
  }
  const int d4 = Dv / 4;
  float4* o4 = reinterpret_cast<float4*>(static_cast<float*>(out) + (size_t)row * Dv);
  for (int c = lane; c < d4; c += 32) {
    float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int sp = 0; sp < num_splits; ++sp) {
      const size_t p = base + (size_t)sp * Sq;
      const float w = expf(m_part[p] - m_g);
      const float4 x = reinterpret_cast<const float4*>(o_part + p * Dv)[c];
      o.x += x.x * w;
      o.y += x.y * w;
      o.z += x.z * w;
      o.w += x.w * w;
    }
    o4[c] = make_float4(o.x * inv, o.y * inv, o.z * inv, o.w * inv);
  }
}

// Shared bytes of a CTA: Q, the ring, the owned rows' mask fields, the
// tile test's ballots; at least what the final merge takes.
// D is 0 with kWinGlobal (no Q or K in shared memory); Dv the window's.
template <typename T, int MB, int NS, int kStages>
size_t smem_bytes(int D, int Dv) {
  using C = Cfg<MB, NS>;
  const size_t main = sizeof(float) * C::kRows * (D ? mma_stride(D) : 0) +
                      sizeof(T) * kStages * C::W * ((D ? kv_stride<T>(D) : 0) + kv_stride<T>(Dv)) +
                      sizeof(int) * (3 * C::kRows + 2 * kWarps + kStages * 4 * C::W);
  const size_t merge = sizeof(float4) * kWarps * 32 * ((Dv + 7) / 8 + 1);
  return main > merge ? main : merge;
}

template <int N>
using Int = std::integral_constant<int, N>;

// Calls f(MB, NS, NT, kWidth) (Int constants) with the CTA shape for
// `rows` = group x Sq query rows a kv head and the widths: up to 16 rows,
// one block walking 64-key tiles; more, CTAs of up to 4 blocks walking
// 32-key tiles; widths past 200 (NT > 25 column tiles), 4 blocks and
// 16-key tiles at every row count. c = 200 is compiled as a constant.
template <typename F>
auto with_cta_shape(int rows, int D, int Dv, F&& f) {
  const int nt = ((D > Dv ? D : Dv) + 7) / 8;
  const bool c200 = D == 200 && Dv == 200;
  if (nt > 25) return f(Int<4>{}, Int<1>{}, Int<32>{}, Int<0>{});
  if (rows <= 16)
    return c200 ? f(Int<1>{}, Int<1>{}, Int<25>{}, Int<200>{})
                : f(Int<1>{}, Int<1>{}, Int<25>{}, Int<0>{});
  return c200 ? f(Int<4>{}, Int<2>{}, Int<25>{}, Int<200>{})
              : f(Int<4>{}, Int<2>{}, Int<25>{}, Int<0>{});
}

// The split count a launch runs: num_splits <= 0 picks enough (row tile,
// split) CTAs to give each of sm_count SMs one; any count is held to
// [1, key tiles of the cache].
int num_splits_for(int B, int Hq, int Hkv, int Sq, int S, int D, int Dv,
                   int num_splits, int sm_count) {
  const int rows = Hq / Hkv * Sq;
  return with_cta_shape(rows, D, Dv, [&](auto mb, auto ns, auto, auto) {
    using C = Cfg<decltype(mb)::value, decltype(ns)::value>;
    const int tiles = (S + C::W - 1) / C::W;
    int n = num_splits;
    if (n <= 0) {
      const int base = B * Hkv * ((rows + C::kRows - 1) / C::kRows);
      n = (sm_count + base - 1) / (base > 0 ? base : 1);
    }
    n = n > tiles ? tiles : n;
    return n < 1 ? 1 : n;
  });
}

// One launch of every column window (one for widths up to kMaxWindow,
// window_passes(D, Dv) for wider rows: kWin != kWinNone), then the split
// combine over the whole rows.
template <typename T, typename TQ, int MB, int NS, int NT, int kWidth,
          int kWin = kWinNone, bool kWinCap = false>
cudaError_t launch_cfg(const void* q, const void* k, const void* v,
                       const float* k_scale, const float* v_scale,
                       const int* kv_length, const int* q_times, const int* k_times,
                       const int* q_seg, const int* k_seg, float* o_part,
                       float* m_part, float* l_part, void* out, int B, int Hq,
                       int Hkv, int Sq, int S, int D, int Dv, int layer,
                       int num_splits, float scale, int q_bf16, int window,
                       float softcap, cudaStream_t stream) {
  constexpr int kStages = std::is_same<T, float>::value ? 2 : 3;
  using C = Cfg<MB, NS>;
  auto kernel = decode_kernel<T, TQ, MB, NS, NT, kStages, kWidth, kWin, kWinCap>;
  const int row_tiles = (Hq / Hkv * Sq + C::kRows - 1) / C::kRows;
  const int tiles = (S + C::W - 1) / C::W;
  const int tiles_per_split = (tiles + num_splits - 1) / num_splits;
  const dim3 grid((unsigned)(row_tiles * num_splits), Hkv, B);
  const int passes = kWin ? window_passes(D, Dv) : 1;
  cudaError_t err = cudaSuccess;
  for (int p = 0; p < passes; ++p) {
    const Win win = kWin ? window_of(p, passes, D, Dv) : Win{0, D, 0, Dv};
    const size_t smem = smem_bytes<T, MB, NS, kStages>(kWin == kWinGlobal ? 0 : D, win.vw);
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
    kernel<<<grid, kThreads, smem, stream>>>(
        (const TQ*)q, (const T*)k, (const T*)v, k_scale, v_scale, kv_length, q_times,
        k_times, q_seg, k_seg, (TQ*)out, o_part, m_part, l_part, B, Hq, Hkv, Sq, S, D,
        Dv, layer, num_splits, tiles_per_split, scale, win, window, softcap);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (num_splits == 1) return err;
  const int rows = B * Hq * Sq;
  combine_kernel<<<(rows + kCombineWarps - 1) / kCombineWarps, kCombineWarps * 32, 0,
                   stream>>>(o_part, m_part, l_part, out, rows, Sq, Dv, num_splits, q_bf16);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, const float* k_scale,
                   const float* v_scale, const int* kv_length, const int* q_times,
                   const int* k_times, const int* q_seg, const int* k_seg,
                   float* o_part, float* m_part, float* l_part, void* out, int B,
                   int Hq, int Hkv, int Sq, int S, int D, int Dv, int layer,
                   int num_splits, float scale, int q_bf16, int window, float softcap,
                   cudaStream_t stream) {
  num_splits = num_splits_for(B, Hq, Hkv, Sq, S, D, Dv, num_splits < 1 ? 1 : num_splits, 0);
  if (window > 0 || softcap > 0.f) {         // the kWinCap instances
    if (D > 200 || Dv > 200) return cudaErrorInvalidValue;
    auto go = [&](auto tq, auto mb, auto ns) {
      return launch_cfg<T, decltype(tq), decltype(mb)::value, decltype(ns)::value, 25, 0,
                        kWinNone, true>(
          q, k, v, k_scale, v_scale, kv_length, q_times, k_times, q_seg, k_seg, o_part,
          m_part, l_part, out, B, Hq, Hkv, Sq, S, D, Dv, layer, num_splits, scale, q_bf16,
          window, softcap, stream);
    };
    const bool one = Hq / Hkv * Sq <= 16;    // with_cta_shape's choice
    if (q_bf16)
      return one ? go(__nv_bfloat16{}, Int<1>{}, Int<1>{})
                 : go(__nv_bfloat16{}, Int<4>{}, Int<2>{});
    return one ? go(float{}, Int<1>{}, Int<1>{}) : go(float{}, Int<4>{}, Int<2>{});
  }
  if (D > kMaxWindow || Dv > kMaxWindow) {   // with_cta_shape's (4, 1, 32) shape
    // whole Q and K rows staged where they fit beside the widest V window
    constexpr int kStages = std::is_same<T, float>::value ? 2 : 3;
    const int passes = window_passes(D, Dv);
    const bool staged = smem_bytes<T, 4, 1, kStages>(
                            D, window_of(passes - 1, passes, D, Dv).vw) <= max_shared_bytes();
    auto go = [&](auto tq, auto mode) {
      return launch_cfg<T, decltype(tq), 4, 1, 32, 0, decltype(mode)::value>(
          q, k, v, k_scale, v_scale, kv_length, q_times, k_times, q_seg, k_seg, o_part,
          m_part, l_part, out, B, Hq, Hkv, Sq, S, D, Dv, layer, num_splits, scale, q_bf16,
          -1, 0.f, stream);
    };
    if (q_bf16)
      return staged ? go(__nv_bfloat16{}, Int<kWinStaged>{})
                    : go(__nv_bfloat16{}, Int<kWinGlobal>{});
    return staged ? go(float{}, Int<kWinStaged>{}) : go(float{}, Int<kWinGlobal>{});
  }
  return with_cta_shape(Hq / Hkv * Sq, D, Dv, [&](auto mb, auto ns, auto nt, auto width) {
    auto go = [&](auto tq) {
      return launch_cfg<T, decltype(tq), decltype(mb)::value, decltype(ns)::value,
                        decltype(nt)::value, decltype(width)::value>(
          q, k, v, k_scale, v_scale, kv_length, q_times, k_times, q_seg, k_seg, o_part,
          m_part, l_part, out, B, Hq, Hkv, Sq, S, D, Dv, layer, num_splits, scale, q_bf16,
          -1, 0.f, stream);
    };
    return q_bf16 ? go(__nv_bfloat16{}) : go(float{});
  });
}

}  // namespace

extern "C" {

// q (B, Hq, Sq, D) float32 (q_bf16 0) or bfloat16 (1); k (L, B, Hkv, S, D),
// v (L, B, Hkv, S, Dv) of the cache type (0 float32, 1 bfloat16, 2 int8)
// read at `layer`; k_scale, v_scale (L, B, Hkv, S) f32 for int8, else
// null; kv_length (B,) int32; times / segment ids int32 or null.
// num_splits is held to [1, key tiles] (flash_decode_num_splits). Scratch
// o_part (B, Hq, splits, Sq, Dv), m_part, l_part (B, Hq, splits, Sq) f32 for
// at least that many splits (unread with one split); out (B, Hq, Sq, Dv) of
// q's type. Any widths; past 256 columns the launch runs balanced column
// windows of at most 256. window > 0 keeps keys with k_time > q_time - window
// (times required); softcap > 0 caps the scaled scores; either takes widths
// up to 200 (cudaErrorInvalidValue past them). Returns cudaGetLastError()
// after the launches.
int flash_decode_launch(const void* q, const void* k, const void* v,
                        const void* k_scale, const void* v_scale,
                        const void* kv_length, const void* q_times,
                        const void* k_times, const void* q_seg, const void* k_seg,
                        void* o_part, void* m_part, void* l_part, void* out, int B,
                        int Hq, int Hkv, int Sq, int S, int D, int Dv, int layer,
                        int num_splits, int cache_dtype, int q_bf16, float scale,
                        int window, float softcap, void* stream) {
  if (B == 0 || Sq == 0) return 0;
#define ARGS q, k, v, (const float*)k_scale, (const float*)v_scale, \
    (const int*)kv_length, (const int*)q_times, (const int*)k_times,             \
    (const int*)q_seg, (const int*)k_seg, (float*)o_part, (float*)m_part,        \
    (float*)l_part, out, B, Hq, Hkv, Sq, S, D, Dv, layer, num_splits, scale,     \
    q_bf16, window, softcap, (cudaStream_t)stream
  switch (cache_dtype) {
    case 0: return (int)launch<float>(ARGS);
    case 1: return (int)launch<__nv_bfloat16>(ARGS);
    case 2: return (int)launch<int8_t>(ARGS);
  }
#undef ARGS
  return (int)cudaErrorInvalidValue;
}

// The split count flash_decode_launch runs for these shapes and num_splits
// (<= 0: enough CTAs to give each of sm_count SMs one).
int flash_decode_num_splits(int B, int Hq, int Hkv, int Sq, int S, int D, int Dv,
                            int num_splits, int sm_count) {
  return num_splits_for(B, Hq, Hkv, Sq, S, D, Dv, num_splits, sm_count);
}

const char* flash_decode_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
