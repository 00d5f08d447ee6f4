// Flash-attention forward on the tensor cores: online softmax over key
// tiles, with the log-sum-exp rows the backward recomputes probabilities
// from.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py:
// _fwd_kernel (:44, pallas_call at :170). It computes
// out = softmax(mask(softcap(scale * Q K^T))) V and lse = m + log(max(l,
// 1e-30)) per query row; a row with no admitted key gives out = 0 and
// lse = -1e30, so the backward gives it P = 0.
//
// Bound on Hopper: bytes, once the products run on the tensor cores. At the
// sim arch's training shape (32 scenes x 8 heads x 336 tokens, c = 200,
// float32) the mask admits 1,743,704 (q, k) pairs a head over the 32
// scenes, 2 (D + Dv) = 800 FLOP each: 11.2 GFLOP, 0.068 ms at the rate of
// float32-accurate tensor-core products (495 / 3 TFLOP/s), against 0.28 GB
// of q, k, v and out, 0.082 ms at 3.35 TB/s. On the CUDA cores (67
// TFLOP/s) the products alone would take 0.17 ms.
//
// What the design does about it (the helpers are in mma_tf32.cuh, shared
// with flash_attention_bwd.cu, whose header gives the reasons at length):
//   * Both products run on the tensor cores in split TF32: mma.sync m16n8k8
//     .tf32, each float32 operand split in registers into big = tf32(x) and
//     small = x - big, a product taken as small*big + big*small + big*big
//     (bf16 inputs are exact in TF32: their small products are skipped).
//     Emulated on the CPU at the sim width (tests/test_torch_tf32.py), one
//     TF32 product on P V misses the float32 output tolerance, and one on
//     S misses the lse tolerance the backward relies on.
//   * S = Q K^T is summed over its k8 steps in chunks of two, each from
//     zero, joined by a compensated add: the tensor cores truncate as they
//     accumulate, and a long sum in one accumulator drifts (the backward
//     missed its tolerance that way).
//   * P V needs no transposed copy: the S accumulator tile, after the exp,
//     is the A operand as it lies in registers once its k8 slots are
//     permuted (frag_a_from_c), and V is read at rows 2t and 2t + 1
//     (frag_b_cols). Shared rows have the stride round_up(width, 8) + 4,
//     which keeps both fragment reads free of bank conflicts.
//   * A CTA of 8 warps owns 64 query rows (4 blocks of 16) and walks 32-key
//     tiles (16 keys when a width exceeds 200). Two warps share a block,
//     each taking half of every key tile, so each K/V tile feeds 64 rows
//     and no warp recomputes another's S. Each keeps its own running
//     (m, l, O) over its keys; the two meet once, at the end, in a fixed
//     order through shared memory, so each output row has one writer and
//     the forward is bitwise repeatable. O is 16 rows x Dv, 4 ceil(Dv / 8)
//     registers a thread: 100 at c = 200.
//   * Online softmax on the accumulator layout: a thread holds rows g and
//     g + 8 of its block; a row's max is taken over the 4 threads of a
//     quad with two shuffles; each thread sums its own share of l, and the
//     quad's shares meet at the end. O is rescaled only on a tile where a
//     row's max rises in some row of the warp; exp is taken once per
//     admitted pair, and a masked pair gives P = 0 exactly.
//   * Key tiles are double-buffered: the next tile the mask reaches is
//     found (a CTA-wide test on its pairs, which also skips a tile the mask
//     rejects whole before anything of it is loaded) and its float32 copy
//     issued (cp.async.cg, 16 bytes) before the current one is computed.
//     bf16 tiles go through load_tile, converting, synchronously. A tile
//     the mask admits whole skips the per-element mask; a warp none of
//     whose 16 x 16 pairs is admitted skips its products on that tile. Q
//     is copied the same way at the start, while the owned rows' mask
//     fields load (2% faster at the training shape on an H100 than a
//     synchronous copy, benchmarks/torch_flash_ab.py).
//   * The merge scales O by one reciprocal of l a row: with an IEEE
//     division an element the kernel took 10% longer at the training shape
//     (benchmarks/torch_flash_ab.py).
//   * What the tensor cores read past the data is zero: the Q rows past Sq,
//     the k8 padding columns of a width that is not a multiple of 8, and
//     the rows past Sk of a ragged last key tile (which would otherwise
//     hold an earlier tile's rows). P = 0 times a stale NaN is NaN.
//   * Rows wider than 256 (se2_fourier at head_dim >= 36: c >= 300): O would
//     not fit the registers, so the launch runs ceil(width / 256) balanced
//     column windows (mma_tf32.cuh: 300 as 2 x 150). Each pass recomputes S
//     over the whole rows and writes its columns of out; all passes compute
//     the same m and l, and the first writes lse. Q and K stay whole in
//     shared memory beside V's window where they fit (up to about 500
//     columns, kWinStaged), else every pass reads them from device memory
//     (kWinGlobal). Widths up to 256 launch as before, one pass through the
//     instances below.
//   * Any row width from 1 to 256 (se2_fourier's c = 50 head_dim / 6:
//     c = 150 at head_dim 18). A float32 row of a width that is not a
//     multiple of 4 does not start 16-byte aligned (a c = 150 row is 600
//     bytes), so load_rows copies it by 8-byte cp.async.ca where the width
//     is even and by 4-byte ones where it is odd; the 16-byte copies stay
//     for widths that are multiples of 4, whose instances (c = 200) are
//     compiled as before. A bf16 tile is one flat run and load_tile reads
//     it in 16- or 4-byte chunks, or element by element where its start is
//     only 2-byte aligned. store_tile writes a row's pair of columns in one
//     store for even widths and one at a time for odd ones.
//   * The float32 c = 200 case is compiled with its widths and strides as
//     constants, as in the backward, where that made dq and dk/dv 1.3x
//     faster (benchmarks/torch_flash_ab.py).
//   * Shared memory, c = 200 (stride 204): Q 52,224 B, K and V in two
//     buffers 104,448 B, the tiles' and owned rows' mask fields 1.3 KB:
//     157,952 B of the 232,448 a CTA may use, one CTA of 8 warps an SM (255
//     registers a thread at most). The final merge reuses it.
// Conventions of the reference: scale applies before the tanh softcap; with
// times, the causal and window comparisons use them in place of indices.
#include "mma_tf32.cuh"

namespace {

// One CTA per (batch row, q head, 64 query rows); warp w takes the query
// block mirrored_block(w) and the half w / 4 of every key tile.
template <typename T, int NT, int W, int kWidth, int kWin>
__global__ void __launch_bounds__(kThreads, 1)
fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
           const T* __restrict__ v, const int* __restrict__ q_times,
           const int* __restrict__ k_times, const int* __restrict__ q_seg,
           const int* __restrict__ k_seg, T* __restrict__ out,
           float* __restrict__ lse, int Hq, int Hkv, int Sq, int Sk, int D_arg,
           int Dv_arg, float scale, float softcap, Mask mk, Win win) {
  constexpr bool kExact = !std::is_same<T, float>::value;
  const int D = kWidth ? kWidth : D_arg, Dv = kWidth ? kWidth : Dv_arg;
  // the output columns this launch writes: all, or a window (mma_tf32.cuh;
  // with kWinGlobal Q and K stay in device memory, none in shared memory)
  constexpr bool kStaged = kWin != kWinGlobal;
  const int Do = kWin ? win.vw : Dv;
  constexpr int kHalf = W / 2;               // keys of a tile a warp takes
  constexpr int kNS = kHalf / 8;             // its n8 tiles of S
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int qs = kStaged ? mma_stride(D) : 0, vs = mma_stride(Do);
  const int walk = W * (qs + vs);            // floats of one K/V buffer
  float* s_q = smem;                         // [kOwn][qs]
  float* s_walk = s_q + kOwn * qs;           // 2 x (K [W][qs], V [W][vs])
  int* s_meta = reinterpret_cast<int*>(s_walk + 2 * walk);  // 2 x [2][W]
  int* s_own = s_meta + 4 * W;               // [3][kOwn]

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int blk = mirrored_block(warp), j_half = (warp / kBlocks) * kHalf;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int q0 = blockIdx.x * kOwn;
  const size_t bh = (size_t)b * Hq + h, head = (size_t)b * Hkv + hk;
  const T* kh = k + head * Sk * D;
  const T* vh = v + head * Sk * Dv;

  zero_shared(smem4, (int)(reinterpret_cast<float*>(s_own + 3 * kOwn) - smem) / 4);
  __syncthreads();
  if constexpr (kStaged) load_rows<T>(q + (bh * Sq + q0) * D, min(kOwn, Sq - q0), D, s_q, qs);
  cp_async_commit();
  load_owned_meta(s_own, q0, Sq, q_times, q_seg, (size_t)b * Sq);
  cp_async_wait<0>();
  __syncthreads();                           // Q and the owned rows in place

  // this thread's accumulator rows: g and g + 8 of the warp's block, with
  // their running max (the same over a quad) and this thread's share of l
  int row_i[2], row_t[2], row_s[2];
  float m[2], l[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int o = blk * 16 + g + 8 * r;
    row_i[r] = q0 + o;
    row_t[r] = s_own[kOwn + o];
    row_s[r] = s_own[2 * kOwn + o];
    m[r] = kNegInf;
    l[r] = 0.f;
  }
  float acc[NT][4] = {};

  const int ntiles = (Sk + W - 1) / W;
  bool all = false;
  auto next_live = [&](int kt) {             // first admitted tile >= kt
    while (kt < ntiles && !tile_admits<W, true>(mk, s_own, kt * W, Sk, k_times,
                                                k_seg, (size_t)b * Sk, all))
      ++kt;
    return kt;
  };
  auto issue = [&](int kt, int buf) {        // start loading key tile kt
    float* sk = s_walk + buf * walk;
    float* sv = sk + W * qs;
    const int k0 = kt * W, nk = min(W, Sk - k0);
    if constexpr (kStaged) load_rows<T>(kh + (size_t)k0 * D, nk, D, sk, qs);
    if constexpr (kWin != kWinNone)
      load_window<T>(vh + (size_t)k0 * Dv + win.v0, nk, Do, Dv, sv, vs);
    else
      load_rows<T>(vh + (size_t)k0 * Dv, nk, Dv, sv, vs);
    cp_async_commit();
    if (nk < W) {                            // ragged last tile: zero the rest
      zero_shared(reinterpret_cast<float4*>(sk + nk * qs), (W - nk) * qs / 4);
      zero_shared(reinterpret_cast<float4*>(sv + nk * vs), (W - nk) * vs / 4);
    }
    if (threadIdx.x < W) {
      int* mt = s_meta + buf * 2 * W;
      const int j = k0 + threadIdx.x;
      mt[threadIdx.x] = (k_times && j < Sk) ? k_times[(size_t)b * Sk + j] : 0;
      mt[W + threadIdx.x] = (k_seg && j < Sk) ? k_seg[(size_t)b * Sk + j] : 0;
    }
  };

  int kt = next_live(0);
  if (kt < ntiles) issue(kt, 0);
  for (int buf = 0; kt < ntiles; buf ^= 1) {
    const bool full = all;                   // the mask admits tile kt whole
    const int kn = next_live(kt + 1);        // its test is a barrier: buf ^ 1 is free
    if (kn < ntiles) {
      issue(kn, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();                         // tile kt in place

    const float* sk = s_walk + buf * walk;
    const float* sv = sk + W * qs;
    const int* mt = s_meta + buf * 2 * W;
    // the mask on this warp's 16 x kHalf pairs; a warp none of whose pairs
    // is admitted has nothing to add
    bool ok[kNS][4], live = full;
#pragma unroll
    for (int n = 0; n < kNS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e / 2, jl = j_half + n * 8 + 2 * t + e % 2, j = kt * W + jl;
        ok[n][e] = full || (row_i[r] < Sq && j < Sk &&
                            admitted(mk, row_i[r], j, row_t[r], mt[jl], row_s[r], mt[W + jl]));
        live = live || ok[n][e];
      }
    if (!__any_sync(0xffffffffu, live)) {
      kt = kn;
      continue;
    }
    // S = Q K^T in compensated chunks
    float s[kNS][4] = {}, lo[kNS][4] = {};
    for (int k0 = 0; k0 < D; k0 += 8 * kChunk) {
      float d[kNS][4] = {};
      if constexpr (kWin == kWinGlobal)
        score_chunk_g<kNS, kExact, kExact>(d, q + (bh * Sq + q0) * D, Sq - q0, blk * 16,
                                           kh + (size_t)kt * W * D, Sk - kt * W, j_half,
                                           k0, D, g, t);
      else
        score_chunk<kNS, kExact>(d, s_q, qs, blk * 16, sk, qs, j_half, k0, D, g, t);
      join_chunk<kNS>(s, lo, d);
    }
    // scaled, capped and masked scores; the rows' max over the tile
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int n = 0; n < kNS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = kNegInf;
        if (ok[n][e]) {
          x = (s[n][e] + lo[n][e]) * scale;
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
    for (int n = 0; n < kNS; ++n)            // S becomes P
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = ok[n][e] ? expf(s[n][e] - m[e / 2]) : 0.f;
        s[n][e] = p;
        l[e / 2] += p;
      }
    FragA a[kNS];                            // O += P V, a tile at a time
#pragma unroll
    for (int n = 0; n < kNS; ++n) a[n] = frag_a_from_c(s[n]);
#pragma unroll
    for (int c = 0; c < NT; ++c) {
      if (c * 8 < Do) {
        float d[4] = {};
#pragma unroll
        for (int n = 0; n < kNS; ++n)
          mma3<false, kExact>(d, a[n], frag_b_cols<kExact>(sv, vs, j_half + n * 8, c * 8, g, t));
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[c][i] += d[i];
      }
    }
    kt = kn;
  }

  // the two halves' (m, l, O) meet in the freed shared memory, in a fixed
  // order: the second warp of each block hands its state to the first
  cp_async_wait<0>();
  __syncthreads();
  const int nd = (Do + 7) / 8;
  float4* red = reinterpret_cast<float4*>(smem);  // [kBlocks][nd][32]
  float4* red_ml = red + kBlocks * nd * 32;        // [kBlocks][32]
  if (j_half) {
#pragma unroll
    for (int c = 0; c < NT; ++c)
      if (c < nd)
        red[(blk * nd + c) * 32 + lane] =
            make_float4(acc[c][0], acc[c][1], acc[c][2], acc[c][3]);
    red_ml[blk * 32 + lane] = make_float4(m[0], m[1], l[0], l[1]);
  }
  __syncthreads();
  if (j_half) return;
  const float4 other = red_ml[blk * 32 + lane];
  const float m_o[2] = {other.x, other.y}, l_o[2] = {other.z, other.w};
  float a_self[2], a_other[2], inv_l[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float m_fin = fmaxf(m[r], m_o[r]);
    a_self[r] = expf(m[r] - m_fin);
    a_other[r] = expf(m_o[r] - m_fin);
    float lr = l[r] * a_self[r] + l_o[r] * a_other[r];
    lr += __shfl_xor_sync(0xffffffffu, lr, 1);   // the quad's shares
    lr += __shfl_xor_sync(0xffffffffu, lr, 2);
    lr = fmaxf(lr, 1e-30f);
    inv_l[r] = 1.f / lr;                     // a multiply an element, not a division
    if (t == 0 && row_i[r] < Sq && (kWin == kWinNone || win.v0 == 0))
      lse[bh * Sq + row_i[r]] = m_fin + logf(lr);
  }
  T* o = out + bh * Sq * Dv;
#pragma unroll
  for (int c = 0; c < NT; ++c) {
    if (c < nd) {
      const float4 x = red[(blk * nd + c) * 32 + lane];
      const float xo[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
        acc[c][i] = (acc[c][i] * a_self[i / 2] + xo[i] * a_other[i / 2]) * inv_l[i / 2];
      if constexpr (kWin != kWinNone)
        store_tile_window<T>(o + win.v0, acc[c], q0 + blk * 16, Sq, c * 8, Do, Dv, g, t);
      else
        store_tile<T>(o, acc[c], q0 + blk * 16, Sq, c * 8, Dv, g, t);
    }
  }
}

// Shared bytes of a CTA: Q, K/V twice, the key tiles' mask fields (2 x 2
// ints a row) and the owned rows' (3 ints); at least what the final merge
// takes (O and (m, l) of the 4 second warps).
// D is 0 with kWinGlobal (no Q or K in shared memory); Dv the window's.
template <int W>
size_t smem_bytes(int D, int Dv) {
  const size_t qs = D ? mma_stride(D) : 0, vs = mma_stride(Dv);
  const size_t main = sizeof(float) * (kOwn * qs + 2 * W * (qs + vs) + 4 * W + 3 * kOwn);
  const size_t merge = sizeof(float4) * kBlocks * 32 * ((Dv + 7) / 8 + 1);
  return main > merge ? main : merge;
}

// One launch of every column window: one for widths up to kMaxWindow,
// window_passes(D, Dv) for wider rows (kWin != kWinNone).
template <typename T, int NT, int W, int kWidth, int kWin = kWinNone>
cudaError_t launch_tiles(const void* q, const void* k, const void* v,
                         const int* q_times, const int* k_times, const int* q_seg,
                         const int* k_seg, void* out, float* lse, int B, int Hq,
                         int Hkv, int Sq, int Sk, int D, int Dv, float scale,
                         float softcap, Mask mk, cudaStream_t stream) {
  const int passes = kWin ? window_passes(D, Dv) : 1;
  for (int p = 0; p < passes; ++p) {
    const Win win = kWin ? window_of(p, passes, D, Dv) : Win{0, D, 0, Dv};
    const size_t smem = smem_bytes<W>(kWin == kWinGlobal ? 0 : D, win.vw);
    cudaError_t err = cudaFuncSetAttribute(
        fwd_kernel<T, NT, W, kWidth, kWin>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((unsigned)((Sq + kOwn - 1) / kOwn), Hq, B);
    fwd_kernel<T, NT, W, kWidth, kWin><<<grid, kThreads, smem, stream>>>(
        (const T*)q, (const T*)k, (const T*)v, q_times, k_times, q_seg, k_seg,
        (T*)out, lse, Hq, Hkv, Sq, Sk, D, Dv, scale, softcap, mk, win);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, const int* q_times,
                   const int* k_times, const int* q_seg, const int* k_seg,
                   void* out, float* lse, int B, int Hq, int Hkv, int Sq, int Sk,
                   int D, int Dv, float scale, float softcap, Mask mk,
                   cudaStream_t stream) {
  if (D > kMaxWindow || Dv > kMaxWindow) {
    // whole Q and K rows staged where they fit beside the widest V window
    const int passes = window_passes(D, Dv);
    const bool staged = smem_bytes<16>(D, window_of(passes - 1, passes, D, Dv).vw) <=
                        max_shared_bytes();
    return staged ? launch_tiles<T, 32, 16, 0, kWinStaged>(
                        q, k, v, q_times, k_times, q_seg, k_seg, out, lse, B, Hq, Hkv,
                        Sq, Sk, D, Dv, scale, softcap, mk, stream)
                  : launch_tiles<T, 32, 16, 0, kWinGlobal>(
                        q, k, v, q_times, k_times, q_seg, k_seg, out, lse, B, Hq, Hkv,
                        Sq, Sk, D, Dv, scale, softcap, mk, stream);
  }
  DISPATCH_WIDTH(launch_tiles, q, k, v, q_times, k_times, q_seg, k_seg, out, lse,
                 B, Hq, Hkv, Sq, Sk, D, Dv, scale, softcap, mk, stream);
}

}  // namespace

extern "C" {

// q (B, Hq, Sq, D), k (B, Hkv, Sk, D), v (B, Hkv, Sk, Dv) of one type
// (0 float32, 1 bfloat16); times / segment ids (B, S) int32 or null;
// out (B, Hq, Sq, Dv) of the same type; lse (B, Hq, Sq) float32. window < 0
// means none; softcap <= 0 means none. Any widths; past 256 columns the
// launch runs balanced column windows of at most 256.
// Returns cudaGetLastError().
int flash_attention_launch(const void* q, const void* k, const void* v,
                           const void* q_times, const void* k_times,
                           const void* q_seg, const void* k_seg, void* out,
                           void* lse, int B, int Hq, int Hkv, int Sq, int Sk,
                           int D, int Dv, int causal, int window, float softcap,
                           float scale, int dtype, void* stream) {
  if (B == 0 || Hq == 0 || Sq == 0) return 0;
  const Mask mk{causal, window, q_times != nullptr, q_seg != nullptr};
#define ARGS q, k, v, (const int*)q_times, (const int*)k_times, (const int*)q_seg, \
    (const int*)k_seg, out, (float*)lse, B, Hq, Hkv, Sq, Sk, D, Dv, scale,       \
    softcap, mk, (cudaStream_t)stream
  switch (dtype) {
    case 0: return (int)launch<float>(ARGS);
    case 1: return (int)launch<__nv_bfloat16>(ARGS);
  }
#undef ARGS
  return (int)cudaErrorInvalidValue;
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
