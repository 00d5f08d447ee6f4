// Fused SE(2) Fourier query / key-value projection (paper Alg. 2).
//
// Replaces the Pallas TPU kernels src/repro/kernels/se2_project.py:_k_kernel
// (mode "k", also serves values) and :_q_kernel (mode "q").
//
// Bound on Hopper: bytes. A token row reads head_dim inputs (24 floats at
// the sim arch) plus a pose shared across heads, and writes 4F + 2 floats
// per 6-wide block (200 floats): ~0.9 KB a row against ~10 kFLOP of
// arithmetic, far below the card's ~20 FLOP/B f32 ridge. The design keeps
// every intermediate on chip and makes both streams coalesced:
//   * one CTA owns a tile of `rows` consecutive token rows; it stages the
//     tile's inputs and the quadrature constants in shared memory;
//   * phase 1 evaluates the transcendental pieces once per (row, block):
//     k mode samples cos/sin(u_x), cos/sin(u_y) at the 2F nodes, q mode the
//     basis g_i(theta) and the rotated pairs;
//   * phase 2 gives each thread one output element at a time, so
//     consecutive threads write consecutive addresses of the (rows, c)
//     output tile, which is contiguous in device memory.
// The pose of token (b, i) is read by index for every head h: row
// r = (b * H + h) * n + i reads pose row b * n + i, no per-head copy.
//
// Constants buffer (float32), built once per encoding by the wrapper:
//   [0, 2F) cos z_j | [2F, 4F) sin z_j | [4F, 4F + 2F*F) proj (2F, F)
//   | F frequencies | F odd flags | nb block scales
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// Stage the tile's inputs, poses and the constants; returns the number of
// live rows in this tile.
template <typename T>
__device__ int stage(const T* __restrict__ x, const float* __restrict__ pose,
                     const float* __restrict__ consts, float* s_x, float* s_pose,
                     float* s_const, int n_const, long long R, int H, int n,
                     int d, int rows) {
  const long long row0 = (long long)blockIdx.x * rows;
  const int live = (int)min((long long)rows, R - row0);
  for (int e = threadIdx.x; e < live * d; e += blockDim.x)
    s_x[e] = to_f(x[row0 * d + e]);
  for (int e = threadIdx.x; e < live * 3; e += blockDim.x) {
    const long long r = row0 + e / 3;
    const long long bh = r / n, i = r % n, b = bh / H;
    s_pose[e] = pose[(b * n + i) * 3 + e % 3];
  }
  for (int e = threadIdx.x; e < n_const; e += blockDim.x) s_const[e] = consts[e];
  __syncthreads();
  return live;
}

template <typename T>
__global__ void se2_k_kernel(const T* __restrict__ x, const float* __restrict__ pose,
                             const float* __restrict__ consts, T* __restrict__ out,
                             long long R, int H, int n, int d, int nb, int F,
                             int rows) {
  extern __shared__ float smem[];
  const int F2 = 2 * F, W = 4 * F + 2, c = nb * W;
  const int n_const = 4 * F + F2 * F + 2 * F + nb;
  float* s_const = smem;
  float* s_x = s_const + n_const;
  float* s_pose = s_x + rows * d;
  float* s_samp = s_pose + rows * 3;  // [rows][nb][4][2F]
  const int live = stage(x, pose, consts, s_x, s_pose, s_const, n_const, R, H,
                         n, d, rows);
  const float* cz = s_const;
  const float* sz = s_const + F2;
  const float* proj = s_const + 2 * F2;
  const float* scales = s_const + 2 * F2 + F2 * F + 2 * F;

  // phase 1: quadrature samples of cos/sin(u_x), cos/sin(u_y)
  for (int e = threadIdx.x; e < live * nb * F2; e += blockDim.x) {
    const int j = e % F2, rb = e / F2, b = rb % nb, r = rb / nb;
    const float a = scales[b];
    const float ax = a * s_pose[r * 3 + 0], ay = a * s_pose[r * 3 + 1];
    const float ux = ax * cz[j] + ay * sz[j];
    const float uy = -ax * sz[j] + ay * cz[j];
    float* dst = s_samp + (size_t)rb * 4 * F2;
    float sx, cx, sy, cy;
    sincosf(ux, &sx, &cx);
    sincosf(uy, &sy, &cy);
    dst[j] = cx;
    dst[F2 + j] = sx;
    dst[2 * F2 + j] = cy;
    dst[3 * F2 + j] = sy;
  }
  __syncthreads();

  // phase 2: one output element per thread per step, coalesced stores
  const long long row0 = (long long)blockIdx.x * rows;
  for (int e = threadIdx.x; e < live * c; e += blockDim.x) {
    const int r = e / c, col = e % c, b = col / W, w = col % W;
    const float* xk = s_x + r * d + 6 * b;
    float val;
    if (w < 4 * F) {
      const int axis = w / F2;           // 0: x pair, 1: y pair
      const int i = w % F;
      const bool bottom = (w % F2) >= F;
      const float* sc = s_samp + ((size_t)(r * nb + b) * 4 + 2 * axis) * F2;
      float gamma = 0.f, lam = 0.f;
      for (int j = 0; j < F2; ++j) {
        gamma += sc[j] * proj[j * F + i];
        lam += sc[F2 + j] * proj[j * F + i];
      }
      const float k0 = xk[2 * axis], k1 = xk[2 * axis + 1];
      val = bottom ? lam * k0 + gamma * k1 : gamma * k0 - lam * k1;
    } else {
      float st, ct;
      sincosf(s_pose[r * 3 + 2], &st, &ct);
      val = (w == 4 * F) ? ct * xk[4] - st * xk[5] : st * xk[4] + ct * xk[5];
    }
    out[row0 * c + e] = from_f<T>(val);
  }
}

template <typename T>
__global__ void se2_q_kernel(const T* __restrict__ x, const float* __restrict__ pose,
                             const float* __restrict__ consts, T* __restrict__ out,
                             long long R, int H, int n, int d, int nb, int F,
                             int rows) {
  extern __shared__ float smem[];
  const int F2 = 2 * F, W = 4 * F + 2, c = nb * W;
  const int n_const = 4 * F + F2 * F + 2 * F + nb;
  float* s_const = smem;
  float* s_x = s_const + n_const;
  float* s_pose = s_x + rows * d;
  float* s_basis = s_pose + rows * 3;   // [rows][F]
  float* s_pair = s_basis + rows * F;   // [rows][nb][6]
  const int live = stage(x, pose, consts, s_x, s_pose, s_const, n_const, R, H,
                         n, d, rows);
  const float* freqs = s_const + 2 * F2 + F2 * F;
  const float* odd = freqs + F;
  const float* scales = odd + F;

  // phase 1a: basis g_i(theta) per row
  for (int e = threadIdx.x; e < live * F; e += blockDim.x) {
    const int r = e / F, i = e % F;
    const float z = s_pose[r * 3 + 2] * freqs[i];
    s_basis[e] = odd[i] != 0.f ? sinf(z) : cosf(z);
  }
  // phase 1b: rotated pairs rho(-v_x)(q0, q1), rho(-v_y)(q2, q3),
  // rho(theta)(q4, q5) per (row, block)
  for (int e = threadIdx.x; e < live * nb; e += blockDim.x) {
    const int r = e / nb, b = e % nb;
    const float a = scales[b];
    const float ax = a * s_pose[r * 3 + 0], ay = a * s_pose[r * 3 + 1];
    float st, ct;
    sincosf(s_pose[r * 3 + 2], &st, &ct);
    const float vx = -ax * ct - ay * st;
    const float vy = ax * st - ay * ct;
    float svx, cvx, svy, cvy;
    sincosf(vx, &svx, &cvx);
    sincosf(vy, &svy, &cvy);
    const float* q = s_x + r * d + 6 * b;
    float* dst = s_pair + e * 6;
    dst[0] = q[0] * cvx + q[1] * svx;
    dst[1] = -q[0] * svx + q[1] * cvx;
    dst[2] = q[2] * cvy + q[3] * svy;
    dst[3] = -q[2] * svy + q[3] * cvy;
    dst[4] = q[4] * ct - q[5] * st;
    dst[5] = q[4] * st + q[5] * ct;
  }
  __syncthreads();

  const long long row0 = (long long)blockIdx.x * rows;
  for (int e = threadIdx.x; e < live * c; e += blockDim.x) {
    const int r = e / c, col = e % c, b = col / W, w = col % W;
    const float* pr = s_pair + (r * nb + b) * 6;
    const float val = (w < 4 * F) ? pr[w / F] * s_basis[r * F + w % F]
                                  : pr[4 + (w - 4 * F)];
    out[row0 * c + e] = from_f<T>(val);
  }
}

constexpr int kThreads = 256;

template <typename T>
cudaError_t launch(const void* x, const void* pose, const void* consts, void* out,
                   long long R, int H, int n, int d, int nb, int F, int mode,
                   int rows, cudaStream_t stream) {
  const int F2 = 2 * F;
  const int n_const = 4 * F + F2 * F + 2 * F + nb;
  const int per_row = d + 3 + (mode == 0 ? nb * 4 * F2 : F + nb * 6);
  const size_t smem = sizeof(float) * ((size_t)n_const + (size_t)rows * per_row);
  const dim3 grid((unsigned)((R + rows - 1) / rows));
  if (mode == 0) {
    cudaFuncSetAttribute(se2_k_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
    se2_k_kernel<T><<<grid, kThreads, smem, stream>>>(
        (const T*)x, (const float*)pose, (const float*)consts, (T*)out, R, H, n,
        d, nb, F, rows);
  } else {
    cudaFuncSetAttribute(se2_q_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
    se2_q_kernel<T><<<grid, kThreads, smem, stream>>>(
        (const T*)x, (const float*)pose, (const float*)consts, (T*)out, R, H, n,
        d, nb, F, rows);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x (R, d) with R = B * H * n rows in (b, h, i) order, pose (B * n, 3) f32,
// out (R, nb * (4F + 2)) of x's type. mode 0 = key/value, 1 = query;
// dtype 0 = float32, 1 = bfloat16. Returns cudaGetLastError().
int se2_project_launch(const void* x, const void* pose, const void* consts,
                       void* out, long long R, int H, int n, int d, int nb,
                       int F, int mode, int dtype, int rows, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (R == 0) return 0;
  if (dtype == 0)
    return (int)launch<float>(x, pose, consts, out, R, H, n, d, nb, F, mode, rows, s);
  return (int)launch<__nv_bfloat16>(x, pose, consts, out, R, H, n, d, nb, F, mode,
                                    rows, s);
}

const char* se2_project_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
