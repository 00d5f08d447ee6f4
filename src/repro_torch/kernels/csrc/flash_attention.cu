// Flash-attention forward: online softmax over key tiles, with the
// log-sum-exp rows the backward recomputes probabilities from.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py:
// _fwd_kernel.
//
// Bound on Hopper: operations. At the sim arch's training shape (32 scenes
// x 8 heads x 336 tokens, c = 200, float32) the mask admits 59,328 of the
// 336^2 (q, k) pairs of a head, and each costs 2 (D + Dv) = 800 FLOP: about
// 12 GFLOP against 0.28 GB of q, k, v and out, some 44 FLOP/B, above the
// card's ~20 FLOP/B ridge for CUDA-core f32 arithmetic. The bound is
// ~0.18 ms at 67 TFLOP/s. This first version runs f32 FMAs on the CUDA
// cores (no tensor cores yet) and spends nothing on pairs the mask rejects:
//   * one CTA per (batch row, q head, 16-row q tile) owns the whole key loop
//     of its tile, so the running (m, l, acc) stay in registers: the loop
//     takes the place of the TPU kernel's sequential key grid axis;
//   * before a 32-key tile is loaded, the CTA checks the tile's times /
//     segment ids / indices against its rows (__syncthreads_or) and skips a
//     tile no pair of which is admitted: with block-causal times the key
//     loop of a q tile stops paying at the last time it can see;
//   * K/V tiles are contiguous runs copied as 16-byte chunks (widths need
//     not be powers of two) and converted to f32 on the way into shared
//     memory; each warp owns 4 query rows and each lane one key, so the
//     softmax reductions are warp shuffles;
//   * p @ V walks only the keys some row of the warp admits (a ballot), so
//     a value row no query can reach is never read.
// Conventions of the reference: scale applies before the tanh softcap; with
// times the causal and window comparisons use them in place of indices;
// lse = m + log(max(l, 1e-30)); a row with no admitted key gives 0.
#include "tiles.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kRowsPerWarp = 4;
constexpr int kTileQ = kWarps * kRowsPerWarp;  // 16 query rows per CTA
constexpr int kTileK = 32;                      // keys per tile = warp size
constexpr int kMaxCols = 8;                     // Dv <= 32 * kMaxCols

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
           const T* __restrict__ v, const int* __restrict__ q_times,
           const int* __restrict__ k_times, const int* __restrict__ q_seg,
           const int* __restrict__ k_seg, T* __restrict__ out,
           float* __restrict__ lse, int Hq, int Hkv, int Sq, int Sk, int D,
           int Dv, float scale, float softcap, Mask mk) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int ks = lane_stride(D);
  float* s_q = smem;                          // [kTileQ][D]
  float* s_k = s_q + kTileQ * D;              // [kTileK][ks]
  float* s_v = s_k + kTileK * ks;             // [kTileK][Dv]
  int* s_kt = reinterpret_cast<int*>(s_v + kTileK * Dv);  // [kTileK]
  int* s_ks = s_kt + kTileK;                  // [kTileK]

  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int q0 = blockIdx.x * kTileQ;
  const size_t bh = (size_t)b * Hq + h;

  load_tile<T>(q + (bh * Sq + q0) * D, min(kTileQ, Sq - q0), D, nullptr, s_q, D);
  int row_i[kRowsPerWarp], row_t[kRowsPerWarp], row_s[kRowsPerWarp];
  bool row_ok[kRowsPerWarp];
  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][kMaxCols];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    row_i[r] = q0 + warp * kRowsPerWarp + r;
    row_ok[r] = row_i[r] < Sq;
    row_t[r] = (q_times && row_ok[r]) ? q_times[(size_t)b * Sq + row_i[r]] : 0;
    row_s[r] = (q_seg && row_ok[r]) ? q_seg[(size_t)b * Sq + row_i[r]] : 0;
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < kMaxCols; ++c) acc[r][c] = 0.f;
  }

  const size_t head = (size_t)b * Hkv + hk;
  const T* kh = k + head * Sk * D;
  const T* vh = v + head * Sk * Dv;
  for (int k0 = 0; k0 < Sk; k0 += kTileK) {
    const int nk = min(kTileK, Sk - k0);
    __syncthreads();                          // previous tile fully consumed
    if (threadIdx.x < kTileK) {
      const int j = threadIdx.x;
      s_kt[j] = (k_times && j < nk) ? k_times[(size_t)b * Sk + k0 + j] : 0;
      s_ks[j] = (k_seg && j < nk) ? k_seg[(size_t)b * Sk + k0 + j] : 0;
    }
    __syncthreads();
    bool ok[kRowsPerWarp], any_row = false;
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      ok[r] = row_ok[r] && lane < nk &&
              admitted(mk, row_i[r], k0 + lane, row_t[r], s_kt[lane], row_s[r],
                       s_ks[lane]);
      any_row = any_row || ok[r];
    }
    if (!__syncthreads_or(any_row)) continue;  // no admitted pair: skip
    load_tile<T>(kh + (size_t)k0 * D, nk, D, nullptr, s_k, ks);
    load_tile<T>(vh + (size_t)k0 * Dv, nk, Dv, nullptr, s_v, Dv);
    __syncthreads();

    const float4* kr = reinterpret_cast<const float4*>(s_k + lane * ks);
    float p[kRowsPerWarp];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const float4* qr = reinterpret_cast<const float4*>(
          s_q + (warp * kRowsPerWarp + r) * D);
      float sc = kNegInf;
      if (ok[r]) {
        sc = dot4(qr, kr, D / 4) * scale;
        if (softcap > 0.f) sc = tanhf(sc / softcap) * softcap;
      }
      const float m_new = fmaxf(m[r], warp_max(sc));
      const float alpha = expf(m[r] - m_new);
      p[r] = ok[r] ? expf(sc - m_new) : 0.f;
      l[r] = l[r] * alpha + warp_sum(p[r]);
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < kMaxCols; ++c) acc[r][c] *= alpha;
    }
    // p @ V over the keys some row of this warp admits
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
          for (int r = 0; r < kRowsPerWarp; ++r) acc[r][c] = fmaf(pj[r], vv, acc[r][c]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    if (!row_ok[r]) continue;
    const float lc = fmaxf(l[r], 1e-30f);
    const size_t row = bh * Sq + row_i[r];
#pragma unroll
    for (int c = 0; c < kMaxCols; ++c) {
      const int col = lane + 32 * c;
      if (col < Dv) out[row * Dv + col] = from_f<T>(acc[r][c] / lc);
    }
    if (lane == 0) lse[row] = m[r] + logf(lc);
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, const int* q_times,
                   const int* k_times, const int* q_seg, const int* k_seg,
                   void* out, float* lse, int B, int Hq, int Hkv, int Sq, int Sk,
                   int D, int Dv, float scale, float softcap, Mask mk,
                   cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)kTileQ * D +
                                       (size_t)kTileK * lane_stride(D) +
                                       (size_t)kTileK * Dv) +
                      sizeof(int) * 2 * kTileK;
  cudaError_t err = cudaFuncSetAttribute(
      fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)((Sq + kTileQ - 1) / kTileQ), Hq, B);
  fwd_kernel<T><<<grid, kWarps * 32, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, q_times, k_times, q_seg, k_seg,
      (T*)out, lse, Hq, Hkv, Sq, Sk, D, Dv, scale, softcap, mk);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q (B, Hq, Sq, D), k (B, Hkv, Sk, D), v (B, Hkv, Sk, Dv) of one type
// (0 float32, 1 bfloat16); times / segment ids (B, S) int32 or null;
// out (B, Hq, Sq, Dv) of the same type; lse (B, Hq, Sq) float32. window < 0
// means none; softcap <= 0 means none. Returns cudaGetLastError().
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
