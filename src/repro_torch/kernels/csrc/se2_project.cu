// Fused SE(2) Fourier projection (paper Alg. 2) and its transpose.
//
// Two kernels, each with a forward and a transposed mode:
//   se2_k_kernel  forward     phi_k x: keys and values. Replaces the Pallas
//                             TPU kernel src/repro/kernels/se2_project.py:
//                             _k_kernel.
//                 transposed  phi_k^T g: the backward of keys and values,
//                             what JAX autodiff of SE2Fourier.transform_k /
//                             _expand_k (src/repro/core/encodings.py)
//                             computes.
//   se2_q_kernel  forward     phi_q^T x: queries. Replaces _q_kernel of the
//                             same file.
//                 transposed  phi_q g: SE2Fourier.untransform_out, which is
//                             also the backward of transform_q; the forward
//                             mode is in turn untransform_out's backward.
//
// Both projections are, per token, a map with two nonzeros an output
// column: out[h, t, col] = A[t, col] x[h, t, i0(col)] + B[t, col]
// x[h, t, i0(col) + 1], where i0(col) is the first of the pair the
// column's block and axis read (6b, 6b + 2, or 6b + 4 for the theta pair)
// and the tables A, B (c each) depend on the token's pose only:
//   k: (gx_i, -lx_i) for the top column i of the x axis, (lx_i, gx_i) for
//      the bottom one, the same with gy, ly for the y axis; (cos, -sin)
//      and (sin, cos) of theta for the theta pair;
//   q: (cos v g_i, sin v g_i) on top, (-sin v g_i, cos v g_i) below, per
//      axis (v = v_x, v_y, g_i the basis at theta); theta as for k.
// The transpose sums the same products the other way: out[h, t, 2p] =
// sum A[t, col] g[h, t, col], out[h, t, 2p + 1] = sum B[t, col] g[h, t, col]
// over the columns of pair p, in a fixed order: no atomics, so results are
// bitwise repeatable.
//
// Bound on Hopper: bytes. A row reads head_dim values (24 at the sim arch)
// and writes nb (4F + 2) (200), or the reverse; an output element costs two
// FMAs (forward) and the tables about 3 kFLOP a token (not a row: the H
// heads of a token share its pose), far below the card's ~20 FLOP/B f32
// ridge. What the design does about it:
//   * a CTA owns a tile of tokens (b, i) of one scene b and all heads of
//     its head group (all H heads unless the scene tiles alone would leave
//     SMs idle), so the tables are built once per token, not per head;
//   * "k" samples cos/sin(u_x), cos/sin(u_y) at F of the 2F quadrature
//     nodes: u at z_j + pi is -u at z_j, so the other F samples are the
//     same cosines and negated sines, and the projection onto the basis
//     sums F terms with the folded matrices P+- = proj[j] +- proj[j + F];
//   * rows of one head and tile are one contiguous span of memory, so every
//     read and write of a row tile walks that span in 4-element quads
//     aligned to the array (16-byte float4 for f32, 8 bytes for bf16), the
//     one or two ragged quads at a span's ends element by element: this
//     holds when c or head_dim is not a multiple of 4 (odd nb). f32 input
//     spans land in shared memory by cp.async, many 16-byte copies in
//     flight a thread, while the CTA builds its tables;
//   * forward: a quad's 4 outputs read A, B and the column's pair index as
//     one vector each and store at once; transposed: a CTA stages the g
//     rows of all its heads, then each output element sums its 2F products;
//   * the tile shrinks (from `rows` tokens, by halves) until the CTA's
//     shared memory fits 32 KB, so seven or eight CTAs share an SM (main
//     path: 8 tokens forward, 2 transposed; a 16-token forward tile, at
//     53 KB and four CTAs an SM, was slower on an H100);
//   * F and nb are template constants for the main path's (12, 4) (the
//     index arithmetic folds to multiplies and shifts); other widths run a
//     generic instantiation that reads them at run time;
//   * precise sincosf (no fast math): quadrature arguments reach
//     a * 60 * pos_scale; bf16 rounds once, at the store.
//
// Rows are (b, h, i) with R = B * H * n; the pose of token (b, i) is row
// b * n + i of pose (B * n, 3), read once per tile for all heads.
//
// Constants buffer (float32), built once per encoding by the wrapper:
//   [0, 2F) cos z_j | [2F, 4F) sin z_j | [4F, 4F + 2F*F) proj (2F, F)
//   | F frequencies | F odd flags | nb block scales | P+ (F, F) | P- (F, F)
// (the layout up to the block scales is the first design's, so both read
// one buffer).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr size_t kSmemTarget = 32 * 1024;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// 4 consecutive elements at an address aligned to 4 elements
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float v[4]) {
  const uint2 q = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&q.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&q.y));
  v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}
__device__ __forceinline__ void store4(float* p, const float v[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float v[4]) {
  __nv_bfloat162 a = __floats2bfloat162_rn(v[0], v[1]);
  __nv_bfloat162 b = __floats2bfloat162_rn(v[2], v[3]);
  uint2 q;
  q.x = *reinterpret_cast<uint32_t*>(&a);
  q.y = *reinterpret_cast<uint32_t*>(&b);
  *reinterpret_cast<uint2*>(p) = q;
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Visits `spans` spans of `len` elements of one device array, span s
// starting at element base + s * stride, in quads aligned to 4 elements of
// the array: fn(s, e, true) for a quad wholly inside span s (e its offset
// in the span), fn(s, e, false) for each element of a ragged quad at a
// span's ends. The quads are dealt to the CTA's threads in turn.
template <typename Fn>
__device__ __forceinline__ void for_quads(long long base, long long stride,
                                          int spans, int len, Fn&& fn) {
  const int per = len / 4 + 2;  // quads that can touch one span
  for (int k = threadIdx.x; k < spans * per; k += blockDim.x) {
    const int s = k / per;
    const long long start = base + s * stride;
    const int e = (int)(((start >> 2) + (k - s * per)) * 4 - start);
    if (e >= len) continue;
    if (e >= 0 && e + 4 <= len) {
      fn(s, e, true);
    } else {
      for (int u = max(e, 0); u < min(e + 4, len); ++u) fn(s, u, false);
    }
  }
}

// The CTA's tile: scene bb, tokens [i0, i0 + live), heads [h0, h0 + heads).
struct Tile {
  int bb, i0, live, h0, heads;
};

__device__ __forceinline__ Tile tile_of(int H, int n, int tt, int hpc) {
  const int tiles = (n + tt - 1) / tt;
  Tile t;
  t.bb = blockIdx.x / tiles;
  t.i0 = (blockIdx.x % tiles) * tt;
  t.live = min(tt, n - t.i0);
  t.h0 = blockIdx.y * hpc;
  t.heads = min(hpc, H - t.h0);
  return t;
}

// Element offset of (head h0 + s, token i0) in a (B, H, n, width) array.
__device__ __forceinline__ long long span_base(const Tile& t, int H, int n,
                                               int width) {
  return ((long long)(t.bb * H + t.h0) * n + t.i0) * width;
}

__host__ __device__ __forceinline__ int n_consts(int F, int nb) {
  return 4 * F + 2 * F * F + 2 * F + nb + 2 * F * F;
}

__host__ __device__ __forceinline__ int round4(int v) { return (v + 3) & ~3; }

// Shared memory, in floats, of a CTA's working set; every part starts on a
// 16-byte boundary.
struct Layout {
  int pose, scratch, a, b, i0, rows, row_stride, total;
};

__host__ __device__ __forceinline__ Layout layout(int mode, bool transposed,
                                                  int F, int nb, int tt,
                                                  int hpc) {
  const int d = 6 * nb, c = nb * (4 * F + 2);
  Layout l;
  l.pose = round4(n_consts(F, nb));
  l.scratch = l.pose + round4(3 * tt);
  // k: samples [tt][nb][4][F]; q: basis [tt][F], cos/sin v_x, v_y
  // [tt][nb][4], cos/sin theta [tt][2]
  l.a = l.scratch + round4(mode == 0 ? tt * nb * 4 * F
                                     : tt * F + tt * nb * 4 + 2 * tt);
  l.b = l.a + round4(tt * c);
  l.i0 = l.b + round4(tt * c);                // c bytes
  l.rows = l.i0 + round4((c + 3) / 4);
  l.row_stride = round4(tt * (transposed ? c : d));   // a head's rows
  l.total = l.rows + hpc * l.row_stride;
  return l;
}

// Stage the constants, the tile's poses and the pair index of every
// column, and start staging the tile's input spans of all heads (f32 by
// cp.async, which land while the tables are built: cp_async_wait_all and a
// barrier before they are read). Ends with a barrier.
template <typename T>
__device__ __forceinline__ void stage(const T* __restrict__ in,
                                      const float* __restrict__ pose,
                                      const float* __restrict__ consts,
                                      float* smem, const Layout& l,
                                      const Tile& t, int H, int n, int F,
                                      int nb, int width) {
  const int W = 4 * F + 2, c = nb * W;
  for (int e = threadIdx.x; e < n_consts(F, nb); e += blockDim.x)
    smem[e] = consts[e];
  const long long p0 = ((long long)t.bb * n + t.i0) * 3;
  for (int e = threadIdx.x; e < t.live * 3; e += blockDim.x)
    smem[l.pose + e] = pose[p0 + e];
  unsigned char* s_i0 = reinterpret_cast<unsigned char*>(smem + l.i0);
  for (int col = threadIdx.x; col < c; col += blockDim.x) {
    const int b = col / W, w = col - b * W;
    s_i0[col] = (unsigned char)(6 * b + (w < 4 * F ? 2 * (w / (2 * F)) : 4));
  }
  const long long base = span_base(t, H, n, width);
  for_quads(base, (long long)n * width, t.heads, t.live * width,
            [&](int s, int e, bool quad) {
              const T* src = in + base + s * (long long)n * width + e;
              float* dst = smem + l.rows + s * l.row_stride + e;
              if constexpr (sizeof(T) == 4) {
                if (quad && (e & 3) == 0) cp_async16(dst, (const float*)src);
                else if (quad) for (int u = 0; u < 4; ++u) dst[u] = to_f(src[u]);
                else *dst = to_f(*src);
              } else {
                if (quad) {
                  float v[4];
                  load4(src, v);
                  dst[0] = v[0]; dst[1] = v[1]; dst[2] = v[2]; dst[3] = v[3];
                } else {
                  *dst = to_f(*src);
                }
              }
            });
  __syncthreads();
}

// The "k" tables of the tile's tokens. Ends with a barrier.
__device__ __forceinline__ void k_tables(float* smem, const Layout& l,
                                         int live, int F, int nb) {
  const int W = 4 * F + 2, c = nb * W;
  const float* cz = smem;
  const float* sz = cz + 2 * F;
  const float* scales = smem + 4 * F + 2 * F * F + 2 * F;
  const float* p_plus = scales + nb;
  const float* p_minus = p_plus + F * F;
  const float* s_pose = smem + l.pose;
  float* s_samp = smem + l.scratch;     // [t][b][cos u_x, sin u_x, cos u_y, sin u_y][F]
  float* s_a = smem + l.a;
  float* s_b = smem + l.b;
  for (int e = threadIdx.x; e < live * nb * F; e += blockDim.x) {
    const int j = e % F, tb = e / F, b = tb % nb, t = tb / nb;
    const float a = scales[b];
    const float ax = a * s_pose[t * 3 + 0], ay = a * s_pose[t * 3 + 1];
    const float ux = ax * cz[j] + ay * sz[j];
    const float uy = -ax * sz[j] + ay * cz[j];
    float sx, cx, sy, cy;
    sincosf(ux, &sx, &cx);
    sincosf(uy, &sy, &cy);
    float* dst = s_samp + tb * 4 * F;
    dst[j] = cx;
    dst[F + j] = sx;
    dst[2 * F + j] = cy;
    dst[3 * F + j] = sy;
  }
  for (int e = threadIdx.x; e < live * nb; e += blockDim.x) {
    const int t = e / nb, o = t * c + (e % nb) * W + 4 * F;
    float st, ct;
    sincosf(s_pose[t * 3 + 2], &st, &ct);
    s_a[o] = ct;
    s_b[o] = -st;
    s_a[o + 1] = st;
    s_b[o + 1] = ct;
  }
  __syncthreads();
  // gx, lx, gy, ly: one F-term sum per (token, block, coefficient)
  for (int e = threadIdx.x; e < live * nb * 4 * F; e += blockDim.x) {
    const int i = e % F, tbk = e / F, kind = tbk & 3, tb = tbk >> 2;
    const float* smp = s_samp + tbk * F;
    const float* p = (kind & 1) ? p_minus : p_plus;
    float acc = 0.f;
#pragma unroll
    for (int j = 0; j < F; ++j) acc = fmaf(smp[j], p[j * F + i], acc);
    const int o = (tb / nb) * c + (tb % nb) * W + (kind >> 1) * 2 * F + i;
    if (kind & 1) {         // lambda: -lx on top (B), lx below (A)
      s_b[o] = -acc;
      s_a[o + F] = acc;
    } else {                // gamma: gx on top (A), gx below (B)
      s_a[o] = acc;
      s_b[o + F] = acc;
    }
  }
  __syncthreads();
}

// The "q" tables of the tile's tokens. Ends with a barrier.
__device__ __forceinline__ void q_tables(float* smem, const Layout& l,
                                         int tt, int live, int F, int nb) {
  const int W = 4 * F + 2, c = nb * W;
  const float* freqs = smem + 4 * F + 2 * F * F;
  const float* odd = freqs + F;
  const float* scales = odd + F;
  const float* s_pose = smem + l.pose;
  float* s_basis = smem + l.scratch;   // [tt][F]
  float* s_rot = s_basis + tt * F;     // [tt][nb][cos v_x, sin v_x, cos v_y, sin v_y]
  float* s_trig = s_rot + tt * nb * 4; // [tt][cos, sin theta]
  float* s_a = smem + l.a;
  float* s_b = smem + l.b;
  for (int e = threadIdx.x; e < live * F; e += blockDim.x) {
    const int t = e / F, i = e % F;
    const float z = s_pose[t * 3 + 2] * freqs[i];
    s_basis[e] = odd[i] != 0.f ? sinf(z) : cosf(z);
  }
  for (int e = threadIdx.x; e < live * nb; e += blockDim.x) {
    const int t = e / nb, b = e % nb;
    const float a = scales[b];
    const float ax = a * s_pose[t * 3 + 0], ay = a * s_pose[t * 3 + 1];
    float st, ct;
    sincosf(s_pose[t * 3 + 2], &st, &ct);
    const float vx = -ax * ct - ay * st;
    const float vy = ax * st - ay * ct;
    float svx, cvx, svy, cvy;
    sincosf(vx, &svx, &cvx);
    sincosf(vy, &svy, &cvy);
    float* dst = s_rot + e * 4;
    dst[0] = cvx;
    dst[1] = svx;
    dst[2] = cvy;
    dst[3] = svy;
    if (b == 0) {
      s_trig[2 * t] = ct;
      s_trig[2 * t + 1] = st;
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < live * c; e += blockDim.x) {
    const int t = e / c, col = e - t * c, b = col / W, w = col - b * W;
    if (w < 4 * F) {
      const int axis = w / (2 * F), r = w - axis * 2 * F;
      const bool bottom = r >= F;
      const float g = s_basis[t * F + (bottom ? r - F : r)];
      const float* rot = s_rot + (t * nb + b) * 4 + 2 * axis;
      s_a[e] = bottom ? -rot[1] * g : rot[0] * g;
      s_b[e] = bottom ? rot[0] * g : rot[1] * g;
    } else {
      const float ct = s_trig[2 * t], st = s_trig[2 * t + 1];
      s_a[e] = w == 4 * F ? ct : st;
      s_b[e] = w == 4 * F ? -st : ct;
    }
  }
  __syncthreads();
}

// Forward: out [heads][live][c] of the tile from the staged x rows.
template <typename T>
__device__ __forceinline__ void expand(T* __restrict__ out, const float* smem,
                                       const Layout& l, const Tile& t, int H,
                                       int n, int c, int d) {
  const float* s_a = smem + l.a;
  const float* s_b = smem + l.b;
  const unsigned char* s_i0 = reinterpret_cast<const unsigned char*>(smem + l.i0);
  const long long base = span_base(t, H, n, c);
  for_quads(base, (long long)n * c, t.heads, t.live * c,
            [&](int s, int e, bool quad) {
              T* dst = out + base + s * (long long)n * c + e;
              int r = e / c, col = e - r * c;
              const float* x = smem + l.rows + s * l.row_stride;
              if (quad && ((e | col) & 3) == 0 && col + 4 <= c) {
                const float4 a = *reinterpret_cast<const float4*>(s_a + e);
                const float4 b = *reinterpret_cast<const float4*>(s_b + e);
                const uchar4 i = *reinterpret_cast<const uchar4*>(s_i0 + col);
                const float* xr = x + r * d;
                const float v[4] = {a.x * xr[i.x] + b.x * xr[i.x + 1],
                                    a.y * xr[i.y] + b.y * xr[i.y + 1],
                                    a.z * xr[i.z] + b.z * xr[i.z + 1],
                                    a.w * xr[i.w] + b.w * xr[i.w + 1]};
                store4(dst, v);
                return;
              }
              float v[4];
              for (int u = 0; u < (quad ? 4 : 1); ++u) {
                const float* xr = x + r * d + s_i0[col];
                v[u] = s_a[r * c + col] * xr[0] + s_b[r * c + col] * xr[1];
                if (++col == c) { col = 0; ++r; }
              }
              if (quad) store4(dst, v);
              else *dst = from_f<T>(v[0]);
            });
}

// Transposed: out [heads][live][d] of the tile from the staged g rows.
template <typename T>
__device__ __forceinline__ void contract(T* __restrict__ out, const float* smem,
                                         const Layout& l, const Tile& t,
                                         int H, int n, int F, int nb) {
  const int W = 4 * F + 2, c = nb * W, d = 6 * nb;
  const long long base = span_base(t, H, n, d);
  const int per_head = t.live * d;
  for (int k = threadIdx.x; k < t.heads * per_head; k += blockDim.x) {
    const int s = k / per_head, e = k - s * per_head, r = e / d, j = e - r * d;
    const int b = j / 6, pair = (j - 6 * b) >> 1;
    const int start = b * W + (pair < 2 ? pair * 2 * F : 4 * F);
    const int len = pair < 2 ? 2 * F : 2;
    const float* tab = smem + ((j & 1) ? l.b : l.a) + r * c + start;
    const float* g = smem + l.rows + s * l.row_stride + r * c + start;
    float acc = 0.f;
    for (int m = 0; m < len; ++m) acc = fmaf(tab[m], g[m], acc);
    out[base + s * (long long)n * d + e] = from_f<T>(acc);
  }
}

template <int kMode, typename T, int kF, int kNB, bool kT>
__device__ __forceinline__ void project(const T* __restrict__ in,
                                        const float* __restrict__ pose,
                                        const float* __restrict__ consts,
                                        T* __restrict__ out, int H, int n,
                                        int F_, int nb_, int tt, int hpc) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int F = kF ? kF : F_, nb = kNB ? kNB : nb_;
  const int c = nb * (4 * F + 2), d = 6 * nb;
  const Layout l = layout(kMode, kT, F, nb, tt, hpc);
  const Tile t = tile_of(H, n, tt, hpc);
  stage(in, pose, consts, smem, l, t, H, n, F, nb, kT ? c : d);
  if constexpr (kMode == 0) k_tables(smem, l, t.live, F, nb);
  else q_tables(smem, l, tt, t.live, F, nb);
  cp_async_wait_all();
  __syncthreads();
  if constexpr (kT) contract(out, smem, l, t, H, n, F, nb);
  else expand(out, smem, l, t, H, n, c, d);
}

template <typename T, int kF, int kNB, bool kT>
__global__ void __launch_bounds__(kThreads)
se2_k_kernel(const T* __restrict__ in, const float* __restrict__ pose,
             const float* __restrict__ consts, T* __restrict__ out, int H,
             int n, int F, int nb, int tt, int hpc) {
  project<0, T, kF, kNB, kT>(in, pose, consts, out, H, n, F, nb, tt, hpc);
}

template <typename T, int kF, int kNB, bool kT>
__global__ void __launch_bounds__(kThreads)
se2_q_kernel(const T* __restrict__ in, const float* __restrict__ pose,
             const float* __restrict__ consts, T* __restrict__ out, int H,
             int n, int F, int nb, int tt, int hpc) {
  project<1, T, kF, kNB, kT>(in, pose, consts, out, H, n, F, nb, tt, hpc);
}

int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms <= 0) sms = 1;
  }
  return sms;
}

// Raise a kernel's dynamic shared memory limit to what a launch needs,
// once per kernel and size.
template <auto kKernel>
cudaError_t allow_smem(size_t bytes) {
  static size_t allowed = 48 * 1024;
  if (bytes <= allowed) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kKernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it, so no later launch reports it
    return err;
  }
  allowed = bytes;
  return cudaSuccess;
}

template <typename T, int kF, int kNB, bool kT>
cudaError_t launch(const void* in, const void* pose, const void* consts,
                   void* out, int B, int H, int n, int nb, int F, int mode,
                   int tt, cudaStream_t stream) {
  const auto bytes = [&](int tokens, int heads) {
    return sizeof(float) * layout(mode, kT, F, nb, tokens, heads).total;
  };
  while (tt > 1 && bytes(tt, H) > kSmemTarget) tt = (tt + 1) / 2;
  // one CTA per (scene, token tile); split the heads into groups while the
  // tiles alone fill less than one CTA an SM (the rollout's tick)
  const int tiles = (n + tt - 1) / tt;
  const long long ctas = (long long)B * tiles;
  int groups = 1;
  while (groups < H && ctas * groups < sm_count()) groups *= 2;
  groups = min(groups, H);
  const int hpc = (H + groups - 1) / groups;
  groups = (H + hpc - 1) / hpc;
  const size_t smem = bytes(tt, hpc);
  const dim3 grid((unsigned)ctas, (unsigned)groups);
  auto kernel = mode == 0 ? se2_k_kernel<T, kF, kNB, kT>
                          : se2_q_kernel<T, kF, kNB, kT>;
  const cudaError_t err = mode == 0
      ? allow_smem<se2_k_kernel<T, kF, kNB, kT>>(smem)
      : allow_smem<se2_q_kernel<T, kF, kNB, kT>>(smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, stream>>>(
      (const T*)in, (const float*)pose, (const float*)consts, (T*)out, H, n,
      F, nb, tt, hpc);
  return cudaGetLastError();
}

template <bool kT>
int dispatch(const void* in, const void* pose, const void* consts, void* out,
             long long R, int H, int n, int d, int nb, int F, int mode,
             int dtype, int tt, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (R == 0) return 0;
  // the pair index of a column is one byte: 6 nb - 2 < 256
  if (d != 6 * nb || nb > 42 || F < 1 || H <= 0 || n <= 0 ||
      R % ((long long)H * n) != 0 || tt <= 0 || (mode != 0 && mode != 1) ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const int B = (int)(R / ((long long)H * n));
  const bool main_widths = F == 12 && nb == 4;
  if (dtype == 0)
    return (int)(main_widths
        ? launch<float, 12, 4, kT>(in, pose, consts, out, B, H, n, nb, F, mode, tt, s)
        : launch<float, 0, 0, kT>(in, pose, consts, out, B, H, n, nb, F, mode, tt, s));
  return (int)(main_widths
      ? launch<__nv_bfloat16, 12, 4, kT>(in, pose, consts, out, B, H, n, nb, F, mode, tt, s)
      : launch<__nv_bfloat16, 0, 0, kT>(in, pose, consts, out, B, H, n, nb, F, mode, tt, s));
}

}  // namespace

extern "C" {

// Forward: x (R, d) with R = B * H * n rows in (b, h, i) order, pose
// (B * n, 3) f32, out (R, nb * (4F + 2)) of x's type; mode 0 = key/value
// (phi_k x), 1 = query (phi_q^T x); dtype 0 = float32, 1 = bfloat16; rows =
// tokens a CTA owns at most. x and out 16-byte aligned. Returns
// cudaGetLastError().
int se2_project_launch(const void* x, const void* pose, const void* consts,
                       void* out, long long R, int H, int n, int d, int nb,
                       int F, int mode, int dtype, int rows, void* stream) {
  return dispatch<false>(x, pose, consts, out, R, H, n, d, nb, F, mode, dtype,
                         rows, stream);
}

// Transposed: g (R, nb * (4F + 2)) in, out (R, d); mode 0 = phi_k^T g,
// 1 = phi_q g (untransform_out). The other arguments as above.
int se2_project_t_launch(const void* g, const void* pose, const void* consts,
                         void* out, long long R, int H, int n, int d, int nb,
                         int F, int mode, int dtype, int rows, void* stream) {
  return dispatch<true>(g, pose, consts, out, R, H, n, d, nb, F, mode, dtype,
                        rows, stream);
}

const char* se2_project_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
