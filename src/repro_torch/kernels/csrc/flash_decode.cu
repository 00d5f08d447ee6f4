// Split-K ragged online-softmax decode over a layer-stacked K/V cache.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_decode.py:
// _decode_kernel and its split combine _combine_splits.
//
// Bound on Hopper: bytes. A rollout tick at 64 slots reads each live cache
// row once per kv head, (c_k + c_v) = 400 values a row, for about 2 FLOP per
// value per query row; with 12 query rows that is ~6 FLOP/B in f32 (~24 in
// int8), well below the card's ridge for CUDA-core f32 arithmetic. So the
// design spends nothing it does not have to:
//   * one CTA per (batch row, q head, split, 16-row q tile); its loop over
//     32-key tiles stops at the row's cursor kv_length[b], so dead cache rows
//     cost no load and no arithmetic (the TPU kernel's clamped index map);
//   * the stacked (L, B, Hkv, S, c) cache is addressed in place at `layer`
//     through its strides; no per-layer slice is ever copied;
//   * K/V tiles are dequantized (bf16 -> f32, or int8 * per-row scale) once,
//     on the way into shared memory; all arithmetic is f32;
//   * each thread keeps 4 x 16 bytes of a tile in flight before storing any,
//     so an SM has the tens of KB outstanding that HBM latency asks for;
//   * each warp owns 4 query rows and each lane one key of the tile, so the
//     online-softmax max/sum reductions are warp shuffles; the p @ V update
//     walks only the keys some row of the warp can reach (a ballot), which
//     also keeps the reference's 0 * NaN guard: a value row no query can
//     reach is never read, whatever bit pattern it holds;
//   * each split writes its (m, l, acc) partial; a second small kernel
//     rescales the splits to the global max and normalises, giving 0 for a
//     row with no live key.
// Widths (200 at the sim arch) need not be powers of two: a tile's live rows
// are one contiguous run of the cache, copied as 16-byte chunks with several
// loads in flight per thread (D, Dv % 4 == 0, checked by the wrapper), and
// the score loop reads shared memory as float4.
#include "tiles.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kRowsPerWarp = 4;
constexpr int kTileQ = kWarps * kRowsPerWarp;  // 16 query rows per CTA
constexpr int kTileK = 32;                      // keys per tile = warp size
constexpr int kMaxCols = 8;                     // Dv <= 32 * kMaxCols

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
decode_kernel(const float* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const float* __restrict__ k_scale,
              const float* __restrict__ v_scale, const int* __restrict__ kv_length,
              const int* __restrict__ q_times, const int* __restrict__ k_times,
              const int* __restrict__ q_seg, const int* __restrict__ k_seg,
              float* __restrict__ o_part, float* __restrict__ m_part,
              float* __restrict__ l_part, int B, int Hq, int Hkv, int Sq, int S,
              int D, int Dv, int layer, int num_splits, int tiles_per_split,
              float scale) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int ks = lane_stride(D);
  float* s_q = smem;                          // [kTileQ][D]
  float* s_k = s_q + kTileQ * D;              // [kTileK][ks]
  float* s_v = s_k + kTileK * ks;             // [kTileK][Dv]
  int* s_kt = reinterpret_cast<int*>(s_v + kTileK * Dv);  // [kTileK]
  int* s_ks = s_kt + kTileK;                  // [kTileK]

  const int qt = blockIdx.x / num_splits, split = blockIdx.x % num_splits;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int q0 = qt * kTileQ;

  // this CTA's query tile, and the per-row masks' query-side terms
  const float* qb = q + ((size_t)(b * Hq + h) * Sq + q0) * D;
  const int nq = min(kTileQ, Sq - q0);
  for (int e = threadIdx.x; e < nq * D; e += blockDim.x) s_q[e] = qb[e];
  int row_t[kRowsPerWarp], row_s[kRowsPerWarp];
  bool row_ok[kRowsPerWarp];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int qi = q0 + warp * kRowsPerWarp + r;
    row_ok[r] = qi < Sq;
    row_t[r] = (q_times && row_ok[r]) ? q_times[b * Sq + qi] : 0;
    row_s[r] = (q_seg && row_ok[r]) ? q_seg[b * Sq + qi] : 0;
  }

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][kMaxCols];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < kMaxCols; ++c) acc[r][c] = 0.f;
  }

  const int kv_end = max(0, min(kv_length[b], S));
  const size_t head = ((size_t)layer * B + b) * Hkv + hk;   // (layer, b, hk)
  const T* kh = k + head * S * D;
  const T* vh = v + head * S * Dv;
  const float* ksh = k_scale ? k_scale + head * S : nullptr;
  const float* vsh = v_scale ? v_scale + head * S : nullptr;
  const int tile_lo = split * tiles_per_split;
  const int tile_hi = min(tile_lo + tiles_per_split, (kv_end + kTileK - 1) / kTileK);

  for (int tile = tile_lo; tile < tile_hi; ++tile) {
    const int k0 = tile * kTileK;
    const int nk = min(kTileK, kv_end - k0);   // live keys in this tile
    __syncthreads();                          // previous tile fully consumed
    load_tile<T>(kh + (size_t)k0 * D, nk, D, ksh ? ksh + k0 : nullptr, s_k, ks);
    load_tile<T>(vh + (size_t)k0 * Dv, nk, Dv, vsh ? vsh + k0 : nullptr, s_v, Dv);
    if (threadIdx.x < kTileK) {
      const int j = threadIdx.x;
      s_kt[j] = (k_times && j < nk) ? k_times[(size_t)b * S + k0 + j] : 0;
      s_ks[j] = (k_seg && j < nk) ? k_seg[(size_t)b * S + k0 + j] : 0;
    }
    __syncthreads();

    // scores: lane = key, 4 rows per warp, float4 shared-memory reads
    float s[kRowsPerWarp];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) s[r] = 0.f;
    const float4* kr = reinterpret_cast<const float4*>(s_k + lane * ks);
    const float4* qr = reinterpret_cast<const float4*>(
        s_q + warp * kRowsPerWarp * D);
    const int d4 = D / 4;
    for (int t = 0; t < d4; ++t) {
      const float4 kv = kr[t];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float4 qv = qr[r * d4 + t];
        s[r] = fmaf(qv.x, kv.x, s[r]);
        s[r] = fmaf(qv.y, kv.y, s[r]);
        s[r] = fmaf(qv.z, kv.z, s[r]);
        s[r] = fmaf(qv.w, kv.w, s[r]);
      }
    }
    bool any_row = false;
    float p[kRowsPerWarp];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      bool ok = row_ok[r] && lane < nk;
      if (k_times) ok = ok && s_kt[lane] <= row_t[r];
      if (k_seg) ok = ok && s_ks[lane] == row_s[r] && s_ks[lane] >= 0;
      any_row = any_row || ok;
      const float sc = ok ? s[r] * scale : kNegInf;
      const float m_new = fmaxf(m[r], warp_max(sc));
      const float alpha = expf(m[r] - m_new);
      p[r] = ok ? expf(sc - m_new) : 0.f;
      l[r] = l[r] * alpha + warp_sum(p[r]);
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < kMaxCols; ++c) acc[r][c] *= alpha;
    }
    // p @ V over the keys some row of this warp reaches
    unsigned reach = __ballot_sync(0xffffffffu, any_row);
    while (reach) {
      const int j = __ffs(reach) - 1;
      reach &= reach - 1;
      float pj[kRowsPerWarp];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) pj[r] = __shfl_sync(0xffffffffu, p[r], j);
      const float* vr = s_v + j * Dv;
#pragma unroll
      for (int c = 0; c < kMaxCols; ++c) {
        const int col = lane + 32 * c;
        if (col < Dv) {
          const float vv = vr[col];
#pragma unroll
          for (int r = 0; r < kRowsPerWarp; ++r) acc[r][c] += pj[r] * vv;
        }
      }
    }
  }

  // this split's partial (m, l, acc) for each live query row
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    if (!row_ok[r]) continue;
    const int qi = q0 + warp * kRowsPerWarp + r;
    const size_t row = ((size_t)(b * Hq + h) * num_splits + split) * Sq + qi;
#pragma unroll
    for (int c = 0; c < kMaxCols; ++c) {
      const int col = lane + 32 * c;
      if (col < Dv) o_part[row * Dv + col] = acc[r][c];
    }
    if (lane == 0) {
      m_part[row] = m[r];
      l_part[row] = l[r];
    }
  }
}

// Rescale every split to the global row max, sum, normalise. Rows with no
// live key end with l == 0 and acc == 0 and come out as exact zeros.
__global__ void combine_kernel(const float* __restrict__ o_part,
                               const float* __restrict__ m_part,
                               const float* __restrict__ l_part,
                               float* __restrict__ out, int Sq, int Dv,
                               int num_splits) {
  const size_t bh = blockIdx.y;   // b * Hq + h
  const int qi = blockIdx.x;
  float m_g = kNegInf;
  for (int sp = 0; sp < num_splits; ++sp)
    m_g = fmaxf(m_g, m_part[(bh * num_splits + sp) * Sq + qi]);
  float l_g = 0.f;
  for (int sp = 0; sp < num_splits; ++sp) {
    const size_t row = (bh * num_splits + sp) * Sq + qi;
    l_g += l_part[row] * expf(m_part[row] - m_g);
  }
  const float inv = 1.f / fmaxf(l_g, 1e-30f);
  for (int c = threadIdx.x; c < Dv; c += blockDim.x) {
    float o = 0.f;
    for (int sp = 0; sp < num_splits; ++sp) {
      const size_t row = (bh * num_splits + sp) * Sq + qi;
      o += o_part[row * Dv + c] * expf(m_part[row] - m_g);
    }
    out[(bh * Sq + qi) * Dv + c] = o * inv;
  }
}

template <typename T>
cudaError_t launch(const float* q, const void* k, const void* v, const float* k_scale,
                   const float* v_scale, const int* kv_length, const int* q_times,
                   const int* k_times, const int* q_seg, const int* k_seg,
                   float* o_part, float* m_part, float* l_part, float* out, int B,
                   int Hq, int Hkv, int Sq, int S, int D, int Dv, int layer,
                   int num_splits, float scale, cudaStream_t stream) {
  const int ks = lane_stride(D);
  const size_t smem = sizeof(float) * ((size_t)kTileQ * D + (size_t)kTileK * ks +
                                       (size_t)kTileK * Dv) +
                      sizeof(int) * 2 * kTileK;
  cudaError_t err = cudaFuncSetAttribute(
      decode_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int tiles = (S + kTileK - 1) / kTileK;
  const int tiles_per_split = (tiles + num_splits - 1) / num_splits;
  const dim3 grid((unsigned)(((Sq + kTileQ - 1) / kTileQ) * num_splits), Hq, B);
  decode_kernel<T><<<grid, kWarps * 32, smem, stream>>>(
      q, (const T*)k, (const T*)v, k_scale, v_scale, kv_length, q_times, k_times,
      q_seg, k_seg, o_part, m_part, l_part, B, Hq, Hkv, Sq, S, D, Dv, layer,
      num_splits, tiles_per_split, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  combine_kernel<<<dim3(Sq, B * Hq), 128, 0, stream>>>(o_part, m_part, l_part, out,
                                                        Sq, Dv, num_splits);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q (B, Hq, Sq, D) f32; k (L, B, Hkv, S, D), v (L, B, Hkv, S, Dv) of the
// cache type (0 float32, 1 bfloat16, 2 int8) read at `layer`; k_scale,
// v_scale (L, B, Hkv, S) f32 for int8, else null; kv_length (B,) int32;
// times / segment ids int32 or null. Scratch o_part (B, Hq, splits, Sq, Dv),
// m_part, l_part (B, Hq, splits, Sq) f32; out (B, Hq, Sq, Dv) f32.
// Returns cudaGetLastError() after the two launches.
int flash_decode_launch(const void* q, const void* k, const void* v,
                        const void* k_scale, const void* v_scale,
                        const void* kv_length, const void* q_times,
                        const void* k_times, const void* q_seg, const void* k_seg,
                        void* o_part, void* m_part, void* l_part, void* out, int B,
                        int Hq, int Hkv, int Sq, int S, int D, int Dv, int layer,
                        int num_splits, int cache_dtype, float scale, void* stream) {
  if (B == 0 || Sq == 0) return 0;
#define ARGS (const float*)q, k, v, (const float*)k_scale, (const float*)v_scale, \
    (const int*)kv_length, (const int*)q_times, (const int*)k_times,             \
    (const int*)q_seg, (const int*)k_seg, (float*)o_part, (float*)m_part,        \
    (float*)l_part, (float*)out, B, Hq, Hkv, Sq, S, D, Dv, layer, num_splits,    \
    scale, (cudaStream_t)stream
  switch (cache_dtype) {
    case 0: return (int)launch<float>(ARGS);
    case 1: return (int)launch<__nv_bfloat16>(ARGS);
    case 2: return (int)launch<int8_t>(ARGS);
  }
#undef ARGS
  return (int)cudaErrorInvalidValue;
}

const char* flash_decode_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
