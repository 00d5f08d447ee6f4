// Flash-attention backward: dq, and dk/dv, recomputed from the forward's
// log-sum-exp rows.
//
// Replaces the Pallas TPU kernels src/repro/kernels/flash_attention_bwd.py:
// _dq_kernel (entry flash_attention_dq_launch) and _dkv_kernel (entry
// flash_attention_dkv_launch). The row term delta = sum(dO * O) comes from
// the caller, as in the reference.
//
// Both recompute, for every admitted (q, k) pair, P = exp(S - lse),
// dP = dO . V and dS = P (dP - delta) * softcap' * scale, where
// softcap' = 1 - tanh^2. Bound on Hopper: operations. At the sim arch's
// training shape (32 scenes x 8 heads x 336 tokens, c = 200, float32;
// 59,328 admitted pairs a head) dq costs 2 (2D + Dv) = 1200 FLOP a pair
// (S, dP, dS K), ~18 GFLOP, ~0.27 ms at 67 TFLOP/s; dk/dv costs
// 2 (2D + 2Dv) = 1600 (S, dP, P^T dO, dS^T Q), ~24 GFLOP, ~0.36 ms. This
// first version runs f32 FMAs on the CUDA cores and, like the forward,
// loads no tile in which the mask admits no pair.
//   * dq: one CTA per (batch row, q head, 16-row q tile); its loop over
//     32-key tiles keeps dQ in registers (the TPU kernel's sequential key
//     axis). Each warp owns 4 query rows and each lane one key for S and dP;
//     dS K then walks the keys some row admits, each lane 8 columns.
//   * dk/dv: one CTA per (batch row, kv head, 16-key tile) walks every
//     (q head of the GQA group, 32-row q tile) pair in a fixed order, so
//     each dK/dV row has exactly one writer: no atomics, and the backward
//     is bitwise repeatable. Each warp owns 4 keys and each lane one query
//     row for S and dP; P^T dO and dS^T Q walk the rows some key admits.
// Rows that no key admits (segment -1) get P = 0, so zero gradients.
#include "tiles.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kPerWarp = 4;                    // q rows (dq) / keys (dk/dv)
constexpr int kTileOwn = kWarps * kPerWarp;     // 16 rows a CTA owns
constexpr int kTileWalk = 32;                   // rows a CTA walks = warp size
constexpr int kMaxCols = 8;                     // D, Dv <= 32 * kMaxCols

// P and dS of one admitted pair from its raw dot products.
__device__ __forceinline__ void probs_and_ds(float qk, float dp, float lse,
                                             float delta, float scale,
                                             float softcap, float& p, float& ds) {
  float s = qk * scale, dcap = 1.f;
  if (softcap > 0.f) {
    const float t = tanhf(s / softcap);
    s = t * softcap;
    dcap = 1.f - t * t;
  }
  p = expf(s - lse);
  ds = p * (dp - delta) * dcap * scale;
}

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, const T* __restrict__ dout,
          const float* __restrict__ lse, const float* __restrict__ delta,
          const int* __restrict__ q_times, const int* __restrict__ k_times,
          const int* __restrict__ q_seg, const int* __restrict__ k_seg,
          T* __restrict__ dq, int Hq, int Hkv, int Sq, int Sk, int D, int Dv,
          float scale, float softcap, Mask mk) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int ks = lane_stride(D), vs = lane_stride(Dv);
  float* s_q = smem;                          // [kTileOwn][D]
  float* s_do = s_q + kTileOwn * D;           // [kTileOwn][Dv]
  float* s_k = s_do + kTileOwn * Dv;          // [kTileWalk][ks]
  float* s_v = s_k + kTileWalk * ks;          // [kTileWalk][vs]
  int* s_kt = reinterpret_cast<int*>(s_v + kTileWalk * vs);
  int* s_ks = s_kt + kTileWalk;

  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int q0 = blockIdx.x * kTileOwn;
  const size_t bh = (size_t)b * Hq + h;
  const int nq = min(kTileOwn, Sq - q0);

  load_tile<T>(q + (bh * Sq + q0) * D, nq, D, nullptr, s_q, D);
  load_tile<T>(dout + (bh * Sq + q0) * Dv, nq, Dv, nullptr, s_do, Dv);
  int row_i[kPerWarp], row_t[kPerWarp], row_s[kPerWarp];
  bool row_ok[kPerWarp];
  float row_lse[kPerWarp], row_delta[kPerWarp], acc[kPerWarp][kMaxCols];
#pragma unroll
  for (int r = 0; r < kPerWarp; ++r) {
    row_i[r] = q0 + warp * kPerWarp + r;
    row_ok[r] = row_i[r] < Sq;
    const size_t row = bh * Sq + row_i[r];
    row_t[r] = (q_times && row_ok[r]) ? q_times[(size_t)b * Sq + row_i[r]] : 0;
    row_s[r] = (q_seg && row_ok[r]) ? q_seg[(size_t)b * Sq + row_i[r]] : 0;
    row_lse[r] = row_ok[r] ? lse[row] : 0.f;
    row_delta[r] = row_ok[r] ? delta[row] : 0.f;
#pragma unroll
    for (int c = 0; c < kMaxCols; ++c) acc[r][c] = 0.f;
  }

  const size_t head = (size_t)b * Hkv + hk;
  const T* kh = k + head * Sk * D;
  const T* vh = v + head * Sk * Dv;
  for (int k0 = 0; k0 < Sk; k0 += kTileWalk) {
    const int nk = min(kTileWalk, Sk - k0);
    __syncthreads();                          // previous tile fully consumed
    if (threadIdx.x < kTileWalk) {
      const int j = threadIdx.x;
      s_kt[j] = (k_times && j < nk) ? k_times[(size_t)b * Sk + k0 + j] : 0;
      s_ks[j] = (k_seg && j < nk) ? k_seg[(size_t)b * Sk + k0 + j] : 0;
    }
    __syncthreads();
    bool ok[kPerWarp], any_row = false;
#pragma unroll
    for (int r = 0; r < kPerWarp; ++r) {
      ok[r] = row_ok[r] && lane < nk &&
              admitted(mk, row_i[r], k0 + lane, row_t[r], s_kt[lane], row_s[r],
                       s_ks[lane]);
      any_row = any_row || ok[r];
    }
    if (!__syncthreads_or(any_row)) continue;  // no admitted pair: skip
    load_tile<T>(kh + (size_t)k0 * D, nk, D, nullptr, s_k, ks);
    load_tile<T>(vh + (size_t)k0 * Dv, nk, Dv, nullptr, s_v, vs);
    __syncthreads();

    const float4* kr = reinterpret_cast<const float4*>(s_k + lane * ks);
    const float4* vr = reinterpret_cast<const float4*>(s_v + lane * vs);
    float ds[kPerWarp];
#pragma unroll
    for (int r = 0; r < kPerWarp; ++r) {
      ds[r] = 0.f;
      if (ok[r]) {
        const int i = warp * kPerWarp + r;
        const float qk = dot4(reinterpret_cast<const float4*>(s_q + i * D), kr, D / 4);
        const float dp = dot4(reinterpret_cast<const float4*>(s_do + i * Dv), vr, Dv / 4);
        float p;
        probs_and_ds(qk, dp, row_lse[r], row_delta[r], scale, softcap, p, ds[r]);
      }
    }
    // dQ += dS K over the keys some row of this warp admits
    unsigned reach = __ballot_sync(0xffffffffu, any_row);
    while (reach) {
      const int j = __ffs(reach) - 1;
      reach &= reach - 1;
      float dsj[kPerWarp];
#pragma unroll
      for (int r = 0; r < kPerWarp; ++r) dsj[r] = __shfl_sync(0xffffffffu, ds[r], j);
      const float* krow = s_k + j * ks;
#pragma unroll
      for (int c = 0; c < kMaxCols; ++c) {
        const int col = lane + 32 * c;
        if (col < D) {
          const float kv = krow[col];
#pragma unroll
          for (int r = 0; r < kPerWarp; ++r) acc[r][c] = fmaf(dsj[r], kv, acc[r][c]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kPerWarp; ++r) {
    if (!row_ok[r]) continue;
    const size_t row = bh * Sq + row_i[r];
#pragma unroll
    for (int c = 0; c < kMaxCols; ++c) {
      const int col = lane + 32 * c;
      if (col < D) dq[row * D + col] = from_f<T>(acc[r][c]);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
           const T* __restrict__ v, const T* __restrict__ dout,
           const float* __restrict__ lse, const float* __restrict__ delta,
           const int* __restrict__ q_times, const int* __restrict__ k_times,
           const int* __restrict__ q_seg, const int* __restrict__ k_seg,
           T* __restrict__ dk, T* __restrict__ dv, int Hq, int Hkv, int Sq,
           int Sk, int D, int Dv, float scale, float softcap, Mask mk) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int q_stride = lane_stride(D), do_stride = lane_stride(Dv);
  float* s_k = smem;                          // [kTileOwn][D]
  float* s_v = s_k + kTileOwn * D;            // [kTileOwn][Dv]
  float* s_q = s_v + kTileOwn * Dv;           // [kTileWalk][q_stride]
  float* s_do = s_q + kTileWalk * q_stride;   // [kTileWalk][do_stride]
  float* s_lse = s_do + kTileWalk * do_stride;  // [kTileWalk]
  float* s_delta = s_lse + kTileWalk;         // [kTileWalk]
  int* s_qt = reinterpret_cast<int*>(s_delta + kTileWalk);
  int* s_qs = s_qt + kTileWalk;

  const int hk = blockIdx.y, b = blockIdx.z;
  const int group = Hq / Hkv;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int k0 = blockIdx.x * kTileOwn;
  const size_t head = (size_t)b * Hkv + hk;
  const int nk = min(kTileOwn, Sk - k0);

  load_tile<T>(k + (head * Sk + k0) * D, nk, D, nullptr, s_k, D);
  load_tile<T>(v + (head * Sk + k0) * Dv, nk, Dv, nullptr, s_v, Dv);
  int key_j[kPerWarp], key_t[kPerWarp], key_s[kPerWarp];
  bool key_ok[kPerWarp];
  float acc_k[kPerWarp][kMaxCols], acc_v[kPerWarp][kMaxCols];
#pragma unroll
  for (int r = 0; r < kPerWarp; ++r) {
    key_j[r] = k0 + warp * kPerWarp + r;
    key_ok[r] = key_j[r] < Sk;
    key_t[r] = (k_times && key_ok[r]) ? k_times[(size_t)b * Sk + key_j[r]] : 0;
    key_s[r] = (k_seg && key_ok[r]) ? k_seg[(size_t)b * Sk + key_j[r]] : 0;
#pragma unroll
    for (int c = 0; c < kMaxCols; ++c) acc_k[r][c] = acc_v[r][c] = 0.f;
  }

  for (int hh = 0; hh < group; ++hh) {
    const size_t bh = (size_t)b * Hq + hk * group + hh;
    for (int q0 = 0; q0 < Sq; q0 += kTileWalk) {
      const int nq = min(kTileWalk, Sq - q0);
      __syncthreads();                        // previous tile fully consumed
      if (threadIdx.x < kTileWalk) {
        const int i = threadIdx.x;
        const bool live = i < nq;
        s_qt[i] = (q_times && live) ? q_times[(size_t)b * Sq + q0 + i] : 0;
        s_qs[i] = (q_seg && live) ? q_seg[(size_t)b * Sq + q0 + i] : 0;
        s_lse[i] = live ? lse[bh * Sq + q0 + i] : 0.f;
        s_delta[i] = live ? delta[bh * Sq + q0 + i] : 0.f;
      }
      __syncthreads();
      bool ok[kPerWarp], any_key = false;
#pragma unroll
      for (int r = 0; r < kPerWarp; ++r) {
        ok[r] = key_ok[r] && lane < nq &&
                admitted(mk, q0 + lane, key_j[r], s_qt[lane], key_t[r], s_qs[lane],
                         key_s[r]);
        any_key = any_key || ok[r];
      }
      if (!__syncthreads_or(any_key)) continue;  // no admitted pair: skip
      load_tile<T>(q + (bh * Sq + q0) * D, nq, D, nullptr, s_q, q_stride);
      load_tile<T>(dout + (bh * Sq + q0) * Dv, nq, Dv, nullptr, s_do, do_stride);
      __syncthreads();

      const float4* qr = reinterpret_cast<const float4*>(s_q + lane * q_stride);
      const float4* dr = reinterpret_cast<const float4*>(s_do + lane * do_stride);
      float p[kPerWarp], ds[kPerWarp];
#pragma unroll
      for (int r = 0; r < kPerWarp; ++r) {
        p[r] = ds[r] = 0.f;
        if (ok[r]) {
          const int j = warp * kPerWarp + r;
          const float qk = dot4(reinterpret_cast<const float4*>(s_k + j * D), qr, D / 4);
          const float dp = dot4(reinterpret_cast<const float4*>(s_v + j * Dv), dr, Dv / 4);
          probs_and_ds(qk, dp, s_lse[lane], s_delta[lane], scale, softcap, p[r], ds[r]);
        }
      }
      // dV += P^T dO and dK += dS^T Q over the rows some key of this warp admits
      unsigned reach = __ballot_sync(0xffffffffu, any_key);
      while (reach) {
        const int i = __ffs(reach) - 1;
        reach &= reach - 1;
        float pi[kPerWarp], dsi[kPerWarp];
#pragma unroll
        for (int r = 0; r < kPerWarp; ++r) {
          pi[r] = __shfl_sync(0xffffffffu, p[r], i);
          dsi[r] = __shfl_sync(0xffffffffu, ds[r], i);
        }
        const float* qrow = s_q + i * q_stride;
        const float* drow = s_do + i * do_stride;
#pragma unroll
        for (int c = 0; c < kMaxCols; ++c) {
          const int col = lane + 32 * c;
          if (col < Dv) {
            const float g = drow[col];
#pragma unroll
            for (int r = 0; r < kPerWarp; ++r) acc_v[r][c] = fmaf(pi[r], g, acc_v[r][c]);
          }
          if (col < D) {
            const float qv = qrow[col];
#pragma unroll
            for (int r = 0; r < kPerWarp; ++r) acc_k[r][c] = fmaf(dsi[r], qv, acc_k[r][c]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kPerWarp; ++r) {
    if (!key_ok[r]) continue;
    const size_t row = head * Sk + key_j[r];
#pragma unroll
    for (int c = 0; c < kMaxCols; ++c) {
      const int col = lane + 32 * c;
      if (col < D) dk[row * D + col] = from_f<T>(acc_k[r][c]);
      if (col < Dv) dv[row * Dv + col] = from_f<T>(acc_v[r][c]);
    }
  }
}

template <typename T>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* dout,
                      const float* lse, const float* delta, const int* q_times,
                      const int* k_times, const int* q_seg, const int* k_seg,
                      void* dq, int B, int Hq, int Hkv, int Sq, int Sk, int D,
                      int Dv, float scale, float softcap, Mask mk,
                      cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)kTileOwn * (D + Dv) +
                                       (size_t)kTileWalk * (lane_stride(D) +
                                                            lane_stride(Dv))) +
                      sizeof(int) * 2 * kTileWalk;
  cudaError_t err = cudaFuncSetAttribute(
      dq_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)((Sq + kTileOwn - 1) / kTileOwn), Hq, B);
  dq_kernel<T><<<grid, kWarps * 32, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, delta, q_times,
      k_times, q_seg, k_seg, (T*)dq, Hq, Hkv, Sq, Sk, D, Dv, scale, softcap, mk);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dkv(const void* q, const void* k, const void* v, const void* dout,
                       const float* lse, const float* delta, const int* q_times,
                       const int* k_times, const int* q_seg, const int* k_seg,
                       void* dk, void* dv, int B, int Hq, int Hkv, int Sq, int Sk,
                       int D, int Dv, float scale, float softcap, Mask mk,
                       cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)kTileOwn * (D + Dv) +
                                       (size_t)kTileWalk * (lane_stride(D) +
                                                            lane_stride(Dv) + 2)) +
                      sizeof(int) * 2 * kTileWalk;
  cudaError_t err = cudaFuncSetAttribute(
      dkv_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)((Sk + kTileOwn - 1) / kTileOwn), Hkv, B);
  dkv_kernel<T><<<grid, kWarps * 32, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, delta, q_times,
      k_times, q_seg, k_seg, (T*)dk, (T*)dv, Hq, Hkv, Sq, Sk, D, Dv, scale,
      softcap, mk);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q (B, Hq, Sq, D), k (B, Hkv, Sk, D), v (B, Hkv, Sk, Dv), dout
// (B, Hq, Sq, Dv) of one type (0 float32, 1 bfloat16); lse, delta
// (B, Hq, Sq) float32; times / segment ids (B, S) int32 or null; dq like q.
// window < 0 means none; softcap <= 0 means none. Returns cudaGetLastError().
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
