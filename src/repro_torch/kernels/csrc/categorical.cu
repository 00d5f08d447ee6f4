// jax.random-exact categorical sampling of a rollout tick in one launch.
//
// No TPU kernel is replaced: the reference samples in XLA
// (src/repro/runtime/rollout.py:202-206, src/repro/runtime/sim_server.py:
// 357-360): per lane b, key_t = fold_in(key[b], t[b]), then
// categorical(key_t, logits[b]) over the last axis, i.e. Gumbel-max with
// noise -log(-log(u)) and u uniform over [tiny, 1) from the Threefry-2x32
// bits of the (A, K) shape (jax 0.9.0, jax_threefry_partitionable on:
// element i hashes the counters (i >> 32, i & 0xFFFFFFFF) and XORs the two
// output words). repro_torch/prng.py is the plain version, operation for
// operation.
//
// Bound on Hopper: neither bytes nor operations. A tick (64 lanes x 12
// agents x 63 actions) reads 194 KB of logits (0.06 us at 3.35 TB/s) and
// runs about 150 integer operations an element for the hash (7.3 M, 0.4 us
// at the int32 rate); the launch itself takes longer. What the kernel buys
// is the launch count: a plain PyTorch Threefry is some 300 tensor
// operations a tick on a path the host already bounds.
//
// Design: one warp a (lane, agent) row. Every thread of the warp folds the
// lane's step into its key (20 rounds, redundantly: cheaper than a
// shuffle's wait), then takes actions k = lane, lane + 32, ...: hash, the
// uniform as jax builds it (the top 23 bits as the mantissa of a float in
// [1, 2), minus 1, times (1 - tiny) == 1 in float32, plus tiny, at least
// tiny), the Gumbel noise with logf (no fast-math: the noise must round as
// the plain version's float32 log, which it can still miss by an ulp), plus
// the logit. The argmax runs over the warp by shuffles; a NaN score counts
// as the largest and ties go to the lowest index, as jnp.argmax breaks
// them. categorical_debug_launch also writes every element's bits, uniform
// and noise, for the checks against the plain version.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr float kTiny = 1.17549435e-38f;   // float32's smallest normal

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

// Threefry's rotation j of a round group of parity p: (13, 15, 26, 6),
// then (17, 29, 16, 24).
__host__ __device__ constexpr int rotation(int p, int j) {
  return p ? (j == 0 ? 17 : j == 1 ? 29 : j == 2 ? 16 : 24)
           : (j == 0 ? 13 : j == 1 ? 15 : j == 2 ? 26 : 6);
}

// Threefry-2x32, 20 rounds: (x1, x2) hashed under the key (k1, k2).
__device__ __forceinline__ void threefry2x32(uint32_t k1, uint32_t k2, uint32_t& x1,
                                             uint32_t& x2) {
  const uint32_t ks[3] = {k1, k2, k1 ^ k2 ^ 0x1BD11BDAu};
  x1 += ks[0];
  x2 += ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x1 += x2;
      x2 = rotl(x2, rotation(i % 2, j)) ^ x1;
    }
    x1 += ks[(i + 1) % 3];
    x2 += ks[(i + 2) % 3] + (uint32_t)(i + 1);
  }
}

// Whether (a, ia) beats (b, ib) in jnp.argmax's order.
__device__ __forceinline__ bool beats(float a, int ia, float b, int ib) {
  const bool na = a != a, nb = b != b;
  if (na || nb) return na && (!nb || ia < ib);
  return a > b || (a == b && ia < ib);
}

__global__ void __launch_bounds__(kWarps * 32)
categorical_kernel(const int64_t* __restrict__ keys, const int* __restrict__ steps,
                   const float* __restrict__ logits, int64_t* __restrict__ out,
                   int64_t* __restrict__ bits_out, float* __restrict__ unif_out,
                   float* __restrict__ noise_out, int B, int A, int K) {
  const int row = blockIdx.x * kWarps + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (row >= B * A) return;
  const int b = row / A, a = row - b * A;
  // fold_in(key, t): the key hashes the counters (0, uint32(t))
  uint32_t k1 = 0u, k2 = (uint32_t)steps[b];
  threefry2x32((uint32_t)keys[2 * b], (uint32_t)keys[2 * b + 1], k1, k2);
  const float* lg = logits + (size_t)row * K;
  float best = 0.f;
  int best_i = -1;
  for (int k = lane; k < K; k += 32) {
    const uint64_t i = (uint64_t)a * K + k;  // flat index in (A, K)
    uint32_t x1 = (uint32_t)(i >> 32), x2 = (uint32_t)i;
    threefry2x32(k1, k2, x1, x2);
    const uint32_t word = x1 ^ x2;
    const float f = __uint_as_float((word >> 9) | 0x3F800000u) - 1.f;
    const float u = fmaxf(kTiny, f + kTiny);
    const float g = -logf(-logf(u));
    const float s = g + lg[k];
    if (best_i < 0 || beats(s, k, best, best_i)) {
      best = s;
      best_i = k;
    }
    if (bits_out) {
      const size_t e = (size_t)row * K + k;
      bits_out[e] = (int64_t)word;
      unif_out[e] = u;
      noise_out[e] = g;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float s = __shfl_xor_sync(0xffffffffu, best, off);
    const int i = __shfl_xor_sync(0xffffffffu, best_i, off);
    if (i >= 0 && (best_i < 0 || beats(s, i, best, best_i))) {
      best = s;
      best_i = i;
    }
  }
  if (lane == 0) out[row] = best_i;
}

int launch(const void* keys, const void* steps, const void* logits, void* out,
           void* bits, void* unif, void* noise, int B, int A, int K, void* stream) {
  if (B == 0 || A == 0) return 0;
  if (K <= 0) return (int)cudaErrorInvalidValue;
  const int rows = B * A;
  categorical_kernel<<<(rows + kWarps - 1) / kWarps, kWarps * 32, 0,
                       (cudaStream_t)stream>>>(
      (const int64_t*)keys, (const int*)steps, (const float*)logits, (int64_t*)out,
      (int64_t*)bits, (float*)unif, (float*)noise, B, A, K);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// keys (B, 2) int64 holding the lanes' uint32 key words; steps (B,) int32;
// logits (B, A, K) float32; out (B, A) int64, the sampled action ids.
// Returns cudaGetLastError().
int categorical_launch(const void* keys, const void* steps, const void* logits,
                       void* out, int B, int A, int K, void* stream) {
  return launch(keys, steps, logits, out, nullptr, nullptr, nullptr, B, A, K, stream);
}

// As categorical_launch; also writes each element's 32-bit word (int64),
// uniform and Gumbel noise (float32), each (B, A, K).
int categorical_debug_launch(const void* keys, const void* steps, const void* logits,
                             void* out, void* bits, void* unif, void* noise, int B,
                             int A, int K, void* stream) {
  return launch(keys, steps, logits, out, bits, unif, noise, B, A, K, stream);
}

const char* categorical_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
