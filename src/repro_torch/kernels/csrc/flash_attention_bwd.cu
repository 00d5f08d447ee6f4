// Flash-attention backward on the tensor cores: dq, and dk/dv, recomputed
// from the forward's log-sum-exp rows.
//
// Replaces the Pallas TPU kernels src/repro/kernels/flash_attention_bwd.py:
// _dq_kernel (:132, entry flash_attention_dq_launch) and _dkv_kernel (:181,
// entry flash_attention_dkv_launch). The row term delta = sum(dO * O) comes
// from the caller, as in the reference.
//
// For every (q, k) pair the mask admits, both recompute P = exp(S - lse),
// dP = dO V^T and dS = P (dP - delta) * softcap' * scale, where
// softcap' = 1 - tanh^2; then dQ = dS K (dq), dV = P^T dO and dK = dS^T Q
// (dk/dv). Rows that no key admits (segment -1) get P = 0, so zero
// gradients.
//
// Bound on Hopper: operations. At the sim arch's training shape (32 scenes
// x 8 heads x 336 tokens, c = 200, float32) the mask admits 1,743,704 (q, k)
// pairs a head over the 32 scenes (48.3%). dq costs 2 (2D + Dv) = 1200 FLOP
// a pair (S, dP, dS K), 16.7 GFLOP; dk/dv 2 (2D + 2Dv) = 1600 (S, dP,
// P^T dO, dS^T Q), 22.3 GFLOP. Float32-accurate products on the tensor
// cores run at a third of the TF32 rate, 495 / 3 = 165 TFLOP/s: 0.10 and
// 0.14 ms. On the CUDA cores (67 TFLOP/s) they would take 0.25 and 0.33 ms.
//
// What the design does about it:
//   * Every product runs on the tensor cores in split TF32, as PyTorch's own
//     float32 attention does: mma.sync m16n8k8 .tf32 with f32 accumulation,
//     each f32 operand x split in registers into big = tf32(x) and
//     small = x - big (three instructions), and a product taken as
//     small*big + big*small + big*big. One TF32 product alone misses the
//     float32 gradient tolerances. bf16 inputs are exact in TF32, so their
//     small parts are zero and those products are skipped.
//   * S and dP are summed in chunks of two k8 steps, each from zero, joined
//     by a compensated add. The tensor cores align an mma's terms to the
//     largest and truncate, so a sum kept in one accumulator drifts, and
//     the cancelling sums of dS K, P^T dO and dS^T Q magnify any error of
//     S and dP: with the whole sum in one accumulator, dq missed the
//     tolerance at the train shape; in chunks of two it stays well inside.
//   * mma.sync, not wgmma: for .tf32, wgmma takes A and B only K-major, and
//     three of the five products (dS K, P^T dO, dS^T Q) contract over the
//     row axis of a tile stored [rows][c]. With mma.sync each thread loads
//     its own fragment, so a transposed operand costs index arithmetic only.
//     No product goes through a transposed copy either: an accumulator tile
//     (rows g, g+8; columns 2t, 2t+1) is the A operand of the next product
//     as it lies in registers once the k8 slots are permuted (slot t holds
//     column 2t, slot t+4 column 2t+1), and the B operand is read at rows
//     2t and 2t+1 to match. Shared rows have the stride
//     round_up(width, 8) + 4, an odd multiple of 4 words, which keeps both
//     the direct (row g, column t) and the permuted (row 2t, column g)
//     fragment reads free of bank conflicts; the contraction is zero-padded
//     to a multiple of 8. Rows wider than 256 run as ceil(width / 256)
//     balanced column windows of dq, dk and dv (mma_tf32.cuh), each pass
//     recomputing S and dP over the whole rows: with whole rows on both
//     sides in shared memory where they fit (kWinStaged), else the owned
//     rows' whole rows in shared memory and the walked rows read from
//     device memory, the walked tiles holding the windows of K (dq) or of
//     Q and dO (dk/dv) (kWinOwned: c = 300), else every S and dP operand
//     from device memory (kWinGlobal). Any width from 1 to 256 is taken: the copies and
//     stores of mma_tf32.cuh pick their unit by the rows' alignment (see
//     flash_attention.cu's header).
//   * A CTA of 8 warps owns 64 rows (4 blocks of 16) and walks 32-row tiles
//     of the other side (16 rows when a width exceeds 200). dq: two warps
//     share a block of 16 query rows, each taking half of every key tile,
//     so neither recomputes the other's S and dP; their dQ partial sums
//     meet once, at the end, in a fixed order. dk/dv: of the two warps of a
//     block of 16 keys, one computes S^T and dV = P^T dO, the other dP^T and
//     dK = dS^T Q, and P * softcap' * scale goes from the first to the
//     second through shared memory (one __syncthreads a tile). An
//     accumulator is 16 rows x the width, 4 ceil(width / 8) registers a
//     thread: 100 at c = 200.
//   * Walked tiles are double-buffered: the next tile the mask reaches is
//     found and its float32 copy issued (cp.async.cg, 16 bytes) before the
//     current one is computed. bf16 tiles go through load_tile, converting,
//     synchronously.
//   * Before a tile is loaded the CTA tests the mask on all of its pairs
//     (__syncthreads_or) and skips a tile no pair of which is admitted
//     (with block-causal times, those wholly above the diagonal); a tile
//     the mask admits whole skips the per-element mask.
//   * The sim arch's float32 width, c = 200, is compiled with its widths
//     and strides as constants; other widths take them at run time. At the
//     training shape on an H100 the constants make dq and dk/dv about 1.3x
//     faster than the run-time-width kernels of the same bucket
//     (benchmarks/torch_flash_ab.py).
//   * Shared memory, c = 200 (stride 204): the owned pair 104,448 B, the
//     walked pair in two buffers 104,448 B, the mask's rows 1.3 KB; dk/dv
//     adds 8 KB of P * softcap' * scale. 210,176 B (dq) and 218,880 B
//     (dk/dv) of the 232,448 a CTA may use: one CTA of 8 warps an SM.
//   * Each dQ / dK / dV row has one writer and every sum runs in a fixed
//     order: no atomics, and the backward is bitwise repeatable.
#include "mma_tf32.cuh"

namespace {

// P and P * softcap' * scale of one admitted pair from its raw Q.K.
__device__ __forceinline__ void probs(float qk, float lse, float scale,
                                      float softcap, float& p, float& pd) {
  float s = qk * scale, dcap = 1.f;
  if (softcap > 0.f) {
    const float th = tanhf(s / softcap);
    s = th * softcap;
    dcap = 1.f - th * th;
  }
  p = expf(s - lse);
  pd = p * dcap * scale;
}

// ---- dq --------------------------------------------------------------------

// One CTA per (batch row, q head, 64 query rows); warp w takes the query
// block w % 4 and the half w / 4 of every key tile, and walks the key tiles
// in order, keeping its dQ partial sum (16 rows x D) in registers.
template <typename T, int NT, int W, int kWidth, int kWin>
__global__ void __launch_bounds__(kThreads, 1)
dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, const T* __restrict__ dout,
          const float* __restrict__ lse, const float* __restrict__ delta,
          const int* __restrict__ q_times, const int* __restrict__ k_times,
          const int* __restrict__ q_seg, const int* __restrict__ k_seg,
          T* __restrict__ dq, int Hq, int Hkv, int Sq, int Sk, int D_arg,
          int Dv_arg, float scale, float softcap, Mask mk, Win win) {
  constexpr bool kExact = !std::is_same<T, float>::value;
  const int D = kWidth ? kWidth : D_arg, Dv = kWidth ? kWidth : Dv_arg;
  // the dq columns this launch writes: all, or a window (mma_tf32.cuh).
  // Whole Q and dO rows stay in shared memory unless kWinGlobal; whole K
  // and V tiles unless the walked rows are read from device memory, when
  // K's tile holds the window only and there is no V tile.
  constexpr bool kOwnStaged = kWin != kWinGlobal;
  constexpr bool kWalkStaged = kWin == kWinNone || kWin == kWinStaged;
  const int Do = kWin ? win.dw : D;
  constexpr int kHalf = W / 2;               // keys of a tile a warp takes
  constexpr int kNS = kHalf / 8;             // its n8 tiles of S and dP
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int qs = kOwnStaged ? mma_stride(D) : 0, vs = kOwnStaged ? mma_stride(Dv) : 0;
  const int ks = mma_stride(kWalkStaged ? D : Do);  // K tile
  const int vw = kWalkStaged ? mma_stride(Dv) : 0;  // V tile
  const int walk = W * (ks + vw);            // floats of one K/V buffer
  float* s_q = smem;                         // [kOwn][qs]
  float* s_do = s_q + kOwn * qs;             // [kOwn][vs]
  float* s_walk = s_do + kOwn * vs;          // 2 x (K [W][ks], V [W][vw])
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
  const int nq = min(kOwn, Sq - q0);
  if constexpr (kOwnStaged) {
    load_tile<T>(q + (bh * Sq + q0) * D, nq, D, s_q, qs);
    load_tile<T>(dout + (bh * Sq + q0) * Dv, nq, Dv, s_do, vs);
  }
  load_owned_meta(s_own, q0, Sq, q_times, q_seg, (size_t)b * Sq);

  // this thread's accumulator rows: g and g + 8 of the warp's block
  int row_i[2], row_t[2], row_s[2];
  float row_lse[2], row_delta[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    row_i[r] = q0 + blk * 16 + g + 8 * r;
    const bool ok = row_i[r] < Sq;
    row_t[r] = (q_times && ok) ? q_times[(size_t)b * Sq + row_i[r]] : 0;
    row_s[r] = (q_seg && ok) ? q_seg[(size_t)b * Sq + row_i[r]] : 0;
    row_lse[r] = ok ? lse[bh * Sq + row_i[r]] : 0.f;
    row_delta[r] = ok ? delta[bh * Sq + row_i[r]] : 0.f;
  }
  float acc[NT][4] = {};
  __syncthreads();                           // owned tiles and rows in place

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
    const int k0 = kt * W, nk = min(W, Sk - k0);
    if constexpr (kWalkStaged) {
      load_rows<T>(kh + (size_t)k0 * D, nk, D, sk, ks);
      load_rows<T>(vh + (size_t)k0 * Dv, nk, Dv, sk + W * ks, vw);
    } else {
      load_window<T>(kh + (size_t)k0 * D + win.d0, nk, Do, D, sk, ks);
    }
    cp_async_commit();
    if (threadIdx.x < W) {
      int* m = s_meta + buf * 2 * W;
      const int j = k0 + threadIdx.x;
      m[threadIdx.x] = (k_times && j < Sk) ? k_times[(size_t)b * Sk + j] : 0;
      m[W + threadIdx.x] = (k_seg && j < Sk) ? k_seg[(size_t)b * Sk + j] : 0;
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
    const float* sv = sk + W * ks;
    const int* m = s_meta + buf * 2 * W;
    // the mask on this warp's 16 x 16 pairs; a warp none of whose pairs is
    // admitted has nothing to add
    bool ok[kNS][4], live = full;
#pragma unroll
    for (int n = 0; n < kNS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e / 2, jl = j_half + n * 8 + 2 * t + e % 2, j = kt * W + jl;
        ok[n][e] = full || (row_i[r] < Sq && j < Sk &&
                            admitted(mk, row_i[r], j, row_t[r], m[jl], row_s[r], m[W + jl]));
        live = live || ok[n][e];
      }
    if (!__any_sync(0xffffffffu, live)) {
      kt = kn;
      continue;
    }
    // S = Q K^T and dP = dO V^T, side by side
    float s[kNS][4] = {}, dp[kNS][4] = {}, s_lo[kNS][4] = {}, dp_lo[kNS][4] = {};
    for (int k0 = 0; k0 < D || k0 < Dv; k0 += 8 * kChunk) {
      float ds_[kNS][4] = {}, dd_[kNS][4] = {};
      const size_t r0 = bh * Sq + q0, j0 = (size_t)kt * W;
      if constexpr (kWin == kWinGlobal) {
        score_chunk_g<kNS, kExact, kExact>(ds_, q + r0 * D, Sq - q0, blk * 16, kh + j0 * D,
                                           Sk - kt * W, j_half, k0, D, g, t);
        score_chunk_g<kNS, kExact, kExact>(dd_, dout + r0 * Dv, Sq - q0, blk * 16,
                                           vh + j0 * Dv, Sk - kt * W, j_half, k0, Dv, g, t);
      } else if constexpr (kWin == kWinOwned) {
        score_chunk_sg<kNS, kExact, kExact>(ds_, s_q, qs, blk * 16, kh + j0 * D,
                                            Sk - kt * W, j_half, k0, D, g, t);
        score_chunk_sg<kNS, kExact, kExact>(dd_, s_do, vs, blk * 16, vh + j0 * Dv,
                                            Sk - kt * W, j_half, k0, Dv, g, t);
      } else {
        score_chunk<kNS, kExact>(ds_, s_q, qs, blk * 16, sk, ks, j_half, k0, D, g, t);
        score_chunk<kNS, kExact>(dd_, s_do, vs, blk * 16, sv, vw, j_half, k0, Dv, g, t);
      }
      join_chunk<kNS>(s, s_lo, ds_);
      join_chunk<kNS>(dp, dp_lo, dd_);
    }
#pragma unroll
    for (int n = 0; n < kNS; ++n) {          // S becomes dS
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e / 2;
        float ds = 0.f;
        if (ok[n][e]) {
          float p, pd;
          probs(s[n][e] + s_lo[n][e], row_lse[r], scale, softcap, p, pd);
          ds = pd * ((dp[n][e] + dp_lo[n][e]) - row_delta[r]);
        }
        s[n][e] = ds;
      }
    }
    FragA a[kNS];                            // dQ += dS K, a tile at a time
#pragma unroll
    for (int n = 0; n < kNS; ++n) a[n] = frag_a_from_c(s[n]);
    // K's columns of the window: at d0 of a whole tile
    const float* skw = sk;
    if constexpr (kWin == kWinStaged) skw += win.d0;
#pragma unroll
    for (int c = 0; c < NT; ++c) {
      if (c * 8 < Do) {
        float d[4] = {};
#pragma unroll
        for (int n = 0; n < kNS; ++n)
          mma3<false, kExact>(d, a[n], frag_b_cols<kExact>(skw, ks, j_half + n * 8, c * 8, g, t));
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[c][i] += d[i];
      }
    }
    kt = kn;
  }

  // the two halves' partial sums meet in the freed Q tile, in a fixed order
  cp_async_wait<0>();
  __syncthreads();
  float4* red = reinterpret_cast<float4*>(s_q);   // [kBlocks][ceil(Do / 8)][32]
  const int nd = (Do + 7) / 8;
  if (j_half) {
#pragma unroll
    for (int c = 0; c < NT; ++c)
      if (c < nd)
        red[(blk * nd + c) * 32 + lane] =
            make_float4(acc[c][0], acc[c][1], acc[c][2], acc[c][3]);
  }
  __syncthreads();
  if (!j_half) {
    T* out = dq + bh * Sq * D;
#pragma unroll
    for (int c = 0; c < NT; ++c) {
      if (c < nd) {
        const float4 o = red[(blk * nd + c) * 32 + lane];
        acc[c][0] += o.x;
        acc[c][1] += o.y;
        acc[c][2] += o.z;
        acc[c][3] += o.w;
        if constexpr (kWin != kWinNone)
          store_tile_window<T>(out + win.d0, acc[c], q0 + blk * 16, Sq, c * 8, Do, D, g, t);
        else
          store_tile<T>(out, acc[c], q0 + blk * 16, Sq, c * 8, D, g, t);
      }
    }
  }
}

// ---- dk/dv -----------------------------------------------------------------

// One CTA per (batch row, kv head, 64 keys) walks every (q head of the GQA
// group, W-row q tile) in a fixed order. Of the two warps of a key block,
// w < 4 computes S^T and dV = P^T dO, w >= 4 computes dP^T and dK = dS^T Q.
template <typename T, int NT, int W, int kWidth, int kWin>
__global__ void __launch_bounds__(kThreads, 1)
dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
           const T* __restrict__ v, const T* __restrict__ dout,
           const float* __restrict__ lse, const float* __restrict__ delta,
           const int* __restrict__ q_times, const int* __restrict__ k_times,
           const int* __restrict__ q_seg, const int* __restrict__ k_seg,
           T* __restrict__ dk, T* __restrict__ dv, int Hq, int Hkv, int Sq,
           int Sk, int D_arg, int Dv_arg, float scale, float softcap, Mask mk,
           Win win) {
  constexpr bool kExact = !std::is_same<T, float>::value;
  const int D = kWidth ? kWidth : D_arg, Dv = kWidth ? kWidth : Dv_arg;
  // the dk and dv columns this launch writes: all, or windows (mma_tf32.cuh).
  // Whole K and V rows stay in shared memory unless kWinGlobal; whole Q and
  // dO tiles unless the walked rows are read from device memory, when the
  // tiles hold the windows of Q and dO only.
  constexpr bool kOwnStaged = kWin != kWinGlobal;
  constexpr bool kWalkStaged = kWin == kWinNone || kWin == kWinStaged;
  const int Dko = kWin ? win.dw : D, Dvo = kWin ? win.vw : Dv;
  constexpr int kNS = W / 8;                 // n8 tiles of S^T and dP^T
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int ks = mma_stride(kWalkStaged ? D : Dko);   // Q tile
  const int vs = mma_stride(kWalkStaged ? Dv : Dvo);  // dO tile
  const int ko = kOwnStaged ? mma_stride(D) : 0, vo = kOwnStaged ? mma_stride(Dv) : 0;
  const int walk = W * (ks + vs);            // floats of one Q/dO buffer
  float* s_k = smem;                         // [kOwn][ko]
  float* s_v = s_k + kOwn * ko;              // [kOwn][vo]
  float* s_walk = s_v + kOwn * vo;           // 2 x (Q [W][ks], dO [W][vs])
  float4* s_pd = reinterpret_cast<float4*>(s_walk + 2 * walk);  // [kBlocks][kNS][32]
  float* s_meta = reinterpret_cast<float*>(s_pd + kBlocks * kNS * 32);
  // 2 x [4][W]: lse, delta (float), times, segment ids (int)
  int* s_own = reinterpret_cast<int*>(s_meta + 8 * W);  // [3][kOwn]

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int blk = mirrored_block(warp);
  const bool dv_warp = warp < kBlocks;
  const int hk = blockIdx.y, b = blockIdx.z;
  const int group = Hq / Hkv;
  const int k0 = blockIdx.x * kOwn;
  const size_t head = (size_t)b * Hkv + hk;

  zero_shared(smem4, (int)(reinterpret_cast<float*>(s_own + 3 * kOwn) - smem) / 4);
  __syncthreads();
  const int nk = min(kOwn, Sk - k0);
  if constexpr (kOwnStaged) {
    load_tile<T>(k + (head * Sk + k0) * D, nk, D, s_k, ko);
    load_tile<T>(v + (head * Sk + k0) * Dv, nk, Dv, s_v, vo);
  }
  load_owned_meta(s_own, k0, Sk, k_times, k_seg, (size_t)b * Sk);

  // this thread's accumulator rows: keys g and g + 8 of the warp's block
  int key_j[2], key_t[2], key_s[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    key_j[r] = k0 + blk * 16 + g + 8 * r;
    const bool ok = key_j[r] < Sk;
    key_t[r] = (k_times && ok) ? k_times[(size_t)b * Sk + key_j[r]] : 0;
    key_s[r] = (k_seg && ok) ? k_seg[(size_t)b * Sk + key_j[r]] : 0;
  }
  float acc[NT][4] = {};                     // dV (dv warps) or dK
  __syncthreads();                           // owned tiles and rows in place

  const int nqt = (Sq + W - 1) / W, ntiles = group * nqt;
  bool all = false;
  auto next_live = [&](int wt) {             // first admitted tile >= wt
    while (wt < ntiles && !tile_admits<W, false>(mk, s_own, (wt % nqt) * W, Sq,
                                                 q_times, q_seg, (size_t)b * Sq, all))
      ++wt;
    return wt;
  };
  auto issue = [&](int wt, int buf) {        // start loading tile wt
    const size_t bh = (size_t)b * Hq + hk * group + wt / nqt;
    const int q0 = (wt % nqt) * W, nq = min(W, Sq - q0);
    float* sq = s_walk + buf * walk;
    if constexpr (kWalkStaged) {
      load_rows<T>(q + (bh * Sq + q0) * D, nq, D, sq, ks);
      load_rows<T>(dout + (bh * Sq + q0) * Dv, nq, Dv, sq + W * ks, vs);
    } else {
      load_window<T>(q + (bh * Sq + q0) * D + win.d0, nq, Dko, D, sq, ks);
      load_window<T>(dout + (bh * Sq + q0) * Dv + win.v0, nq, Dvo, Dv, sq + W * ks, vs);
    }
    cp_async_commit();
    if (threadIdx.x < W) {
      float* m = s_meta + buf * 4 * W;
      int* mi = reinterpret_cast<int*>(m);
      const int i = q0 + threadIdx.x;
      const bool live = i < Sq;
      m[threadIdx.x] = live ? lse[bh * Sq + i] : 0.f;
      m[W + threadIdx.x] = live ? delta[bh * Sq + i] : 0.f;
      mi[2 * W + threadIdx.x] = (q_times && live) ? q_times[(size_t)b * Sq + i] : 0;
      mi[3 * W + threadIdx.x] = (q_seg && live) ? q_seg[(size_t)b * Sq + i] : 0;
    }
  };

  int wt = next_live(0);
  if (wt < ntiles) issue(wt, 0);
  for (int buf = 0; wt < ntiles; buf ^= 1) {
    const bool full = all;                   // the mask admits tile wt whole
    const int wn = next_live(wt + 1);        // its test is a barrier: buf ^ 1 is free
    if (wn < ntiles) {
      issue(wn, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();                         // tile wt in place

    const float* sq = s_walk + buf * walk;
    const float* sdo = sq + W * ks;
    const float* m = s_meta + buf * 4 * W;
    const int* mi = reinterpret_cast<const int*>(m);
    const int q0 = (wt % nqt) * W;
    // the mask on the block's 16 x W pairs; a block none of whose pairs is
    // admitted has nothing to add (both of its warps see the same)
    bool ok[kNS][4], live = full;
#pragma unroll
    for (int n = 0; n < kNS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e / 2, il = n * 8 + 2 * t + e % 2, i = q0 + il;
        ok[n][e] = full || (key_j[r] < Sk && i < Sq &&
                            admitted(mk, i, key_j[r], mi[2 * W + il], key_t[r],
                                     mi[3 * W + il], key_s[r]));
        live = live || ok[n][e];
      }
    live = __any_sync(0xffffffffu, live);
    // S^T = K Q^T (dv warps) or dP^T = V dO^T
    float s[kNS][4] = {}, lo[kNS][4] = {};
    if (live) {
      const int width = dv_warp ? D : Dv;
      if constexpr (!kWalkStaged) {
        const size_t bh = (size_t)b * Hq + hk * group + wt / nqt;
        const T* ga = dv_warp ? k + (head * Sk + k0) * D : v + (head * Sk + k0) * Dv;
        const T* gb = dv_warp ? q + (bh * Sq + q0) * D : dout + (bh * Sq + q0) * Dv;
        const float* sa = dv_warp ? s_k : s_v;
        const int sa_stride = dv_warp ? ko : vo;
        for (int c0 = 0; c0 < width; c0 += 8 * kChunk) {
          float d[kNS][4] = {};
          if constexpr (kWin == kWinOwned)
            score_chunk_sg<kNS, kExact, kExact>(d, sa, sa_stride, blk * 16, gb, Sq - q0, 0,
                                                c0, width, g, t);
          else
            score_chunk_g<kNS, kExact, kExact>(d, ga, Sk - k0, blk * 16, gb, Sq - q0, 0,
                                               c0, width, g, t);
          join_chunk<kNS>(s, lo, d);
        }
      } else {
        const float* sa = dv_warp ? s_k : s_v;
        const float* sb = dv_warp ? sq : sdo;
        const int stride = dv_warp ? ks : vs;
        for (int k0 = 0; k0 < width; k0 += 8 * kChunk) {
          float d[kNS][4] = {};
          score_chunk<kNS, kExact>(d, sa, stride, blk * 16, sb, stride, 0, k0, width, g, t);
          join_chunk<kNS>(s, lo, d);
        }
      }
    }
    if (live && dv_warp) {
#pragma unroll
      for (int n = 0; n < kNS; ++n) {        // S^T becomes P^T; P softcap' scale out
        float pd[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int il = n * 8 + 2 * t + e % 2;
          float p = 0.f;
          pd[e] = 0.f;
          if (ok[n][e]) probs(s[n][e] + lo[n][e], m[il], scale, softcap, p, pd[e]);
          s[n][e] = p;
        }
        s_pd[(blk * kNS + n) * 32 + lane] = make_float4(pd[0], pd[1], pd[2], pd[3]);
      }
    }
    __syncthreads();                         // P softcap' scale in place
    if (!live) {
      wt = wn;
      continue;
    }
    if (!dv_warp) {
#pragma unroll
      for (int n = 0; n < kNS; ++n) {        // dP^T becomes dS^T
        const float4 pd = s_pd[(blk * kNS + n) * 32 + lane];
        const int il = n * 8 + 2 * t;
        s[n][0] = pd.x * ((s[n][0] + lo[n][0]) - m[W + il]);
        s[n][1] = pd.y * ((s[n][1] + lo[n][1]) - m[W + il + 1]);
        s[n][2] = pd.z * ((s[n][2] + lo[n][2]) - m[W + il]);
        s[n][3] = pd.w * ((s[n][3] + lo[n][3]) - m[W + il + 1]);
      }
    }
    // dV += P^T dO or dK += dS^T Q, a tile at a time
    FragA a[kNS];
#pragma unroll
    for (int n = 0; n < kNS; ++n) a[n] = frag_a_from_c(s[n]);
    // dO's or Q's columns of the window: at v0 or d0 of a whole tile
    const float* sb = dv_warp ? sdo : sq;
    if constexpr (kWin == kWinStaged) sb += dv_warp ? win.v0 : win.d0;
    const int sb_stride = dv_warp ? vs : ks, width = dv_warp ? Dvo : Dko;
#pragma unroll
    for (int c = 0; c < NT; ++c) {
      if (c * 8 < width) {
        float d[4] = {};
#pragma unroll
        for (int n = 0; n < kNS; ++n)
          mma3<false, kExact>(d, a[n], frag_b_cols<kExact>(sb, sb_stride, n * 8, c * 8, g, t));
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[c][i] += d[i];
      }
    }
    wt = wn;
  }
  cp_async_wait<0>();

  T* out = dv_warp ? dv + head * Sk * Dv : dk + head * Sk * D;
  const int width = dv_warp ? Dvo : Dko;
#pragma unroll
  for (int c = 0; c < NT; ++c) {
    if (c * 8 < width) {
      if constexpr (kWin != kWinNone)
        store_tile_window<T>(out + (dv_warp ? win.v0 : win.d0), acc[c], k0 + blk * 16, Sk,
                             c * 8, width, dv_warp ? Dv : D, g, t);
      else
        store_tile<T>(out, acc[c], k0 + blk * 16, Sk, c * 8, width, g, t);
    }
  }
}

// ---- launches ----------------------------------------------------------------

#define KERNEL_PARAMS                                                          \
  const void *q, const void *k, const void *v, const void *dout,               \
      const float *lse, const float *delta, const int *q_times,                \
      const int *k_times, const int *q_seg, const int *k_seg
#define KERNEL_ARGS                                                            \
  (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, delta, q_times,  \
      k_times, q_seg, k_seg

// Shared bytes of a CTA: the owned pair, the walked pair twice, dk/dv's
// P softcap' scale, the walked rows' mask fields (2 x 2 ints a row for dq,
// 2 x 4 words for dk/dv) and the owned rows' (3 ints).
// Shared bytes of a CTA: the owned rows' tiles (`own` floats a row), the
// walked tiles twice (`walk` floats a row), dk/dv's P softcap' scale, the
// walked rows' mask fields (2 x 2 ints a row for dq, 2 x 4 words for dk/dv)
// and the owned rows' (3 ints); at least what dq's final merge of
// `merge_cols` columns takes.
template <int W>
size_t smem_bytes(int own, int walk, bool dkv, int merge_cols) {
  const size_t main = sizeof(float) * ((size_t)kOwn * own + 2 * W * walk +
                                       (dkv ? kOwn * W + 8 * W : 4 * W) + 3 * kOwn);
  const size_t merge = dkv ? 0 : sizeof(float4) * kBlocks * 32 * ((merge_cols + 7) / 8);
  return main > merge ? main : merge;
}

// The shared bytes of a window mode (mma_tf32.cuh) for window w: whole rows
// of both widths owned and walked, or only the windows of the walked rows.
template <int W>
size_t smem_for(int win_mode, bool dkv, int D, int Dv, const Win& w) {
  const int whole = mma_stride(D) + mma_stride(Dv);
  const int own = win_mode == kWinGlobal ? 0 : whole;
  const int walk = win_mode == kWinNone || win_mode == kWinStaged
                       ? whole
                       : mma_stride(w.dw) + (dkv ? mma_stride(w.vw) : 0);
  return smem_bytes<W>(own, walk, dkv, win_mode ? w.dw : D);
}

// One launch of every column window: one for widths up to kMaxWindow,
// window_passes(D, Dv) for wider rows (kWin != kWinNone).
template <typename T, int NT, int W, int kWidth, int kWin = kWinNone>
cudaError_t launch_dq_tiles(KERNEL_PARAMS, void* dq, int B, int Hq, int Hkv,
                            int Sq, int Sk, int D, int Dv, float scale,
                            float softcap, Mask mk, cudaStream_t stream) {
  const int passes = kWin ? window_passes(D, Dv) : 1;
  for (int p = 0; p < passes; ++p) {
    const Win win = kWin ? window_of(p, passes, D, Dv) : Win{0, D, 0, Dv};
    const size_t smem = smem_for<W>(kWin, false, D, Dv, win);
    cudaError_t err = cudaFuncSetAttribute(
        dq_kernel<T, NT, W, kWidth, kWin>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((unsigned)((Sq + kOwn - 1) / kOwn), Hq, B);
    dq_kernel<T, NT, W, kWidth, kWin><<<grid, kThreads, smem, stream>>>(
        KERNEL_ARGS, (T*)dq, Hq, Hkv, Sq, Sk, D, Dv, scale, softcap, mk, win);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

template <typename T, int NT, int W, int kWidth, int kWin = kWinNone>
cudaError_t launch_dkv_tiles(KERNEL_PARAMS, void* dk, void* dv, int B, int Hq,
                             int Hkv, int Sq, int Sk, int D, int Dv, float scale,
                             float softcap, Mask mk, cudaStream_t stream) {
  const int passes = kWin ? window_passes(D, Dv) : 1;
  for (int p = 0; p < passes; ++p) {
    const Win win = kWin ? window_of(p, passes, D, Dv) : Win{0, D, 0, Dv};
    const size_t smem = smem_for<W>(kWin, true, D, Dv, win);
    cudaError_t err = cudaFuncSetAttribute(
        dkv_kernel<T, NT, W, kWidth, kWin>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((unsigned)((Sk + kOwn - 1) / kOwn), Hkv, B);
    dkv_kernel<T, NT, W, kWidth, kWin><<<grid, kThreads, smem, stream>>>(
        KERNEL_ARGS, (T*)dk, (T*)dv, Hq, Hkv, Sq, Sk, D, Dv, scale, softcap, mk, win);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// Rows past kMaxWindow: the first window mode whose widest window fits the
// card's shared memory, staged before owned before global.
int wide_mode(bool dkv, int D, int Dv) {
  const int passes = window_passes(D, Dv);
  const Win widest = window_of(passes - 1, passes, D, Dv);
  const size_t limit = max_shared_bytes();
  const int modes[2] = {kWinStaged, kWinOwned};
  for (int mode : modes)
    if (smem_for<16>(mode, dkv, D, Dv, widest) <= limit) return mode;
  return kWinGlobal;
}

#define WIDE_LAUNCH(dkv, launch, ...)                                          \
  do {                                                                         \
    switch (wide_mode(dkv, D, Dv)) {                                           \
      case kWinStaged: return launch<T, 32, 16, 0, kWinStaged>(__VA_ARGS__);   \
      case kWinOwned: return launch<T, 32, 16, 0, kWinOwned>(__VA_ARGS__);     \
      default: return launch<T, 32, 16, 0, kWinGlobal>(__VA_ARGS__);           \
    }                                                                          \
  } while (0)

template <typename T>
cudaError_t launch_dq(KERNEL_PARAMS, void* dq, int B, int Hq, int Hkv, int Sq,
                      int Sk, int D, int Dv, float scale, float softcap, Mask mk,
                      cudaStream_t stream) {
  if (D > kMaxWindow || Dv > kMaxWindow)
    WIDE_LAUNCH(false, launch_dq_tiles, q, k, v, dout, lse, delta, q_times, k_times, q_seg,
                k_seg, dq, B, Hq, Hkv, Sq, Sk, D, Dv, scale, softcap, mk, stream);
  DISPATCH_WIDTH(launch_dq_tiles, q, k, v, dout, lse, delta, q_times, k_times,
                 q_seg, k_seg, dq, B, Hq, Hkv, Sq, Sk, D, Dv, scale, softcap, mk,
                 stream);
}

template <typename T>
cudaError_t launch_dkv(KERNEL_PARAMS, void* dk, void* dv, int B, int Hq, int Hkv,
                       int Sq, int Sk, int D, int Dv, float scale, float softcap,
                       Mask mk, cudaStream_t stream) {
  if (D > kMaxWindow || Dv > kMaxWindow)
    WIDE_LAUNCH(true, launch_dkv_tiles, q, k, v, dout, lse, delta, q_times, k_times, q_seg,
                k_seg, dk, dv, B, Hq, Hkv, Sq, Sk, D, Dv, scale, softcap, mk, stream);
  DISPATCH_WIDTH(launch_dkv_tiles, q, k, v, dout, lse, delta, q_times, k_times,
                 q_seg, k_seg, dk, dv, B, Hq, Hkv, Sq, Sk, D, Dv, scale, softcap,
                 mk, stream);
}

}  // namespace

extern "C" {

// q (B, Hq, Sq, D), k (B, Hkv, Sk, D), v (B, Hkv, Sk, Dv), dout
// (B, Hq, Sq, Dv) of one type (0 float32, 1 bfloat16); lse, delta
// (B, Hq, Sq) float32; times / segment ids (B, S) int32 or null; dq like q.
// window < 0 means none; softcap <= 0 means none. Any widths; past 256
// columns the launch runs balanced column windows of at most 256.
// Returns cudaGetLastError().
int flash_attention_dq_launch(const void* q, const void* k, const void* v,
                              const void* dout, const void* lse, const void* delta,
                              const void* q_times, const void* k_times,
                              const void* q_seg, const void* k_seg, void* dq, int B,
                              int Hq, int Hkv, int Sq, int Sk, int D, int Dv,
                              int causal, int window, float softcap, float scale,
                              int dtype, void* stream) {
  if (B == 0 || Hq == 0 || Sq == 0) return 0;
  const Mask mk{causal, window, q_times != nullptr, q_seg != nullptr};
#define ARGS q, k, v, dout, (const float*)lse, (const float*)delta,              \
    (const int*)q_times, (const int*)k_times, (const int*)q_seg,                 \
    (const int*)k_seg, dq, B, Hq, Hkv, Sq, Sk, D, Dv, scale, softcap, mk,        \
    (cudaStream_t)stream
  switch (dtype) {
    case 0: return (int)launch_dq<float>(ARGS);
    case 1: return (int)launch_dq<__nv_bfloat16>(ARGS);
  }
#undef ARGS
  return (int)cudaErrorInvalidValue;
}

// As flash_attention_dq_launch; writes dk (B, Hkv, Sk, D) and dv
// (B, Hkv, Sk, Dv) of the inputs' type.
int flash_attention_dkv_launch(const void* q, const void* k, const void* v,
                               const void* dout, const void* lse, const void* delta,
                               const void* q_times, const void* k_times,
                               const void* q_seg, const void* k_seg, void* dk,
                               void* dv, int B, int Hq, int Hkv, int Sq, int Sk,
                               int D, int Dv, int causal, int window, float softcap,
                               float scale, int dtype, void* stream) {
  if (B == 0 || Hkv == 0 || Sk == 0) return 0;
  const Mask mk{causal, window, q_times != nullptr, q_seg != nullptr};
#define ARGS q, k, v, dout, (const float*)lse, (const float*)delta,              \
    (const int*)q_times, (const int*)k_times, (const int*)q_seg,                 \
    (const int*)k_seg, dk, dv, B, Hq, Hkv, Sq, Sk, D, Dv, scale, softcap, mk,    \
    (cudaStream_t)stream
  switch (dtype) {
    case 0: return (int)launch_dkv<float>(ARGS);
    case 1: return (int)launch_dkv<__nv_bfloat16>(ARGS);
  }
#undef ARGS
  return (int)cudaErrorInvalidValue;
}

const char* flash_attention_bwd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
