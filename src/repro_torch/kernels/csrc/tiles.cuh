// Tile helpers shared by the attention kernels (flash_decode.cu,
// flash_attention.cu, flash_attention_bwd.cu).
//
// A tile of consecutive rows of a row-major (rows, width) tensor is one
// contiguous run of device memory, whatever the width (200 at the sim arch,
// not a power of two). load_tile copies such a run into shared memory as
// 16-byte chunks, several in flight per thread, converting each element to
// float32 (bf16 -> f32, or int8 * per-row scale) and writing it at its row
// and column under a shared-memory row stride of the caller's choice.
#pragma once

#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f(int8_t v) { return (float)v; }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// Unpack one loaded chunk V of elements T starting at element e0 of a
// (rows, width) tile into shared memory, scaling with per-row scales.
template <typename T, typename V>
__device__ __forceinline__ void store_chunk(const V& raw, int e0, int width,
                                            const float* __restrict__ scale,
                                            float* dst, int stride) {
  constexpr int E = sizeof(V) / sizeof(T);
  T vals[E];
  memcpy(vals, &raw, sizeof(V));
  int row = e0 / width, col = e0 - row * width;
  float s = scale ? scale[row] : 1.f;
#pragma unroll
  for (int i = 0; i < E; ++i) {
    dst[row * stride + col] = to_f(vals[i]) * s;
    if (++col == width && i + 1 < E) {
      col = 0;
      ++row;
      s = scale ? scale[row] : 1.f;
    }
  }
}

// Copy the first n elements of a contiguous (rows, width) tile into shared
// memory (row stride `stride`) as chunks of type V, kUnroll chunks per
// thread in flight before any is stored, then the tail element by element.
constexpr int kUnroll = 4;
template <typename T, typename V>
__device__ void load_chunks(const T* __restrict__ src, int n, int width,
                            const float* __restrict__ scale, float* dst,
                            int stride) {
  constexpr int E = sizeof(V) / sizeof(T);
  const int nchunks = n / E;
  const V* src_v = reinterpret_cast<const V*>(src);
  for (int base = threadIdx.x; base < nchunks; base += kUnroll * blockDim.x) {
    V buf[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int c = base + u * blockDim.x;
      if (c < nchunks) buf[u] = __ldg(src_v + c);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int c = base + u * blockDim.x;
      if (c < nchunks) store_chunk<T, V>(buf[u], c * E, width, scale, dst, stride);
    }
  }
  for (int e = nchunks * E + threadIdx.x; e < n; e += blockDim.x) {
    const int row = e / width;
    dst[row * stride + e - row * width] = to_f(src[e]) * (scale ? scale[row] : 1.f);
  }
}

// Load rows [0, nrows) of a tile: 16-byte chunks where the tile start is
// 16-byte aligned (always at the sim arch's shapes), else 4-byte words
// (widths are multiples of 4 elements, checked by the wrappers).
template <typename T>
__device__ void load_tile(const T* __restrict__ src, int nrows, int width,
                          const float* __restrict__ scale, float* dst, int stride) {
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0)
    load_chunks<T, uint4>(src, nrows * width, width, scale, dst, stride);
  else
    load_chunks<T, uint32_t>(src, nrows * width, width, scale, dst, stride);
}

// Row stride (floats) of a shared tile whose rows are read one per lane as
// float4: the width rounded so that the reads of 8 consecutive lanes hit
// distinct bank groups, i.e. an odd number of 16-byte units. Widths are
// multiples of 4 (checked by the wrappers).
__host__ __device__ __forceinline__ int lane_stride(int width) {
  return 4 * ((width / 4) | 1);
}

// Dot product of a float4-aligned shared row with another, n4 float4s long.
__device__ __forceinline__ float dot4(const float4* a, const float4* b, int n4) {
  float s = 0.f;
  for (int t = 0; t < n4; ++t) {
    const float4 x = a[t], y = b[t];
    s = fmaf(x.x, y.x, s);
    s = fmaf(x.y, y.y, s);
    s = fmaf(x.z, y.z, s);
    s = fmaf(x.w, y.w, s);
  }
  return s;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// The attention mask of the flash kernels for query i and key j: causal
// (key <= query) and sliding window (key > query - window) compare times
// where the call gives them and indices otherwise; segment ids must match
// and be >= 0 (-1 marks padding).
struct Mask {
  int causal, window, use_times, use_seg;  // window < 0: none
};

__device__ __forceinline__ bool admitted(const Mask& mk, int qi, int kj, int qt,
                                         int kt, int qs, int ks) {
  const int r = mk.use_times ? qt : qi, c = mk.use_times ? kt : kj;
  bool ok = true;
  if (mk.causal) ok = ok && c <= r;
  if (mk.window >= 0) ok = ok && c > r - mk.window;
  if (mk.use_seg) ok = ok && qs == ks && ks >= 0;
  return ok;
}

}  // namespace
