// Kernel B5: one octave of the AKAZE detector.
//
// Replaces the TPU kernel slam_tpu/ops/pallas_kernels.py:akaze_octave_batch
// (body _akaze_kernel). For each image f with its Perona-Malik contrast
// k[f], read from device memory so the caller never syncs with the host:
//   L     `steps` explicit PM-g2 diffusion steps (akaze.diffuse):
//           gx, gy = centred differences of L,
//           g      = 1 / (1 + (gx^2 + gy^2) / k^2),
//           L     += tau * ((g gx)[x] - (g gx)[x-1] + (g gy)[y] - (g gy)[y-1]);
//   resp  sigma^4 det(Hessian of L) with central second differences
//         (akaze._hessian_response);
//   nms   resp where it is the max of its 5x5 window, -inf elsewhere.
// Diffusion and the Hessian wrap at the image edge, as jnp.roll does: the
// kernel reads its halo at (y mod H, x mod W) of the image itself, so no
// padded canvas is built. NMS reads outside the image as -inf, as
// features.nms does (the TPU kernel wrapped there too). So all three
// outputs match the plain version over the whole image.
//
// Halo: one step reads 2 pixels behind and 1 ahead on each axis (the
// centred gradient feeds a backward difference of the flux), the Hessian
// 1 and the NMS 2 more. So a tile needs 2 steps + 3 pixels on the top
// and left and steps + 3 on the bottom and right: 15 and 9 for 6 steps.
//
// What bounds it on the H100: device memory. One read and three writes
// per pixel: ~0.48 GB per octave-0 call at (64, 376, 1241), ~0.14 ms at
// 3.35 TB/s. The halo'd tile is recomputed by every CTA: for 6 steps a
// 32x32 tile diffuses a 56x56 region, ~3x redundant arithmetic (~40 flops
// per region pixel and step), still below the card's float32 rate.
//
// Design: one CTA per (image, 32x32 output tile), 256 threads as 8 rows of
// 32. The halo'd region stays in shared memory for every step: a flux
// pass writes (g gx, g gy) beside it, a barrier, the update pass, a
// barrier. Each step shrinks the valid part of the region by 2 on the
// top and left and by 1 on the bottom and right, which the halo covers.
// The response goes into the flux buffer, and the three outputs are
// written once. Shared memory is 3 (32 + 3 steps + 6)^2 floats: 37.6 KB
// for 6 steps, and at most 33 steps fit the card's 227 KB.

#include <cuda_runtime.h>
#include <math.h>

#include "launch.cuh"

namespace {

constexpr int TILE = 32;              // output tile side
constexpr int NT = 256;               // 8 rows of 32 threads
constexpr int S = TILE + 4;           // response region side (NMS halo 2)
constexpr int MAX_SMEM = 232448;      // shared memory a block can use

__host__ __device__ constexpr int region(int steps) {
  return TILE + 3 * steps + 6;
}

__host__ __device__ constexpr size_t smem_bytes(int steps) {
  return (size_t)3 * region(steps) * region(steps) * sizeof(float);
}

__device__ __forceinline__ int wrap(int v, int n) {
  v %= n;
  return v < 0 ? v + n : v;
}

__global__ void __launch_bounds__(NT)
akaze_octave_kernel(const float* __restrict__ img, const float* __restrict__ kf,
                    float* __restrict__ Lout, float* __restrict__ resp,
                    float* __restrict__ nms, int H, int W, int steps,
                    float tau, float sigma4) {
  extern __shared__ float smem[];
  const int R = region(steps);
  const int back = 2 * steps + 3;     // halo on the top and left
  float* s_L = smem;                  // R x R diffused region
  float* s_fx = s_L + R * R;          // R x R flux g gx; later the response
  float* s_fy = s_fx + R * R;         // R x R flux g gy
  const int f = blockIdx.z;
  const int y0 = blockIdx.y * TILE;
  const int x0 = blockIdx.x * TILE;
  const int ty = threadIdx.x / 32, tx = threadIdx.x % 32;
  const size_t plane = (size_t)H * W;
  const float* im = img + f * plane;
  const float k = kf[f];
  const float k2 = k * k;

  // region (i, j) <-> image ((y0 - back + i) mod H, (x0 - back + j) mod W)
  for (int i = ty; i < R; i += NT / 32) {
    const float* row = im + (size_t)wrap(y0 - back + i, H) * W;
    for (int j = tx; j < R; j += 32)
      s_L[i * R + j] = row[wrap(x0 - back + j, W)];
  }
  __syncthreads();

  for (int s = 0; s < steps; ++s) {
    // flux where both centred differences are inside the region
    for (int i = ty + 1; i < R - 1; i += NT / 32) {
      for (int j = tx + 1; j < R - 1; j += 32) {
        const float* c = s_L + i * R + j;
        const float gx = 0.5f * (c[1] - c[-1]);
        const float gy = 0.5f * (c[R] - c[-R]);
        const float g = 1.f / (1.f + (gx * gx + gy * gy) / k2);
        s_fx[i * R + j] = g * gx;
        s_fy[i * R + j] = g * gy;
      }
    }
    __syncthreads();
    // update where the backward flux differences are inside the region
    for (int i = ty + 2; i < R - 1; i += NT / 32) {
      for (int j = tx + 2; j < R - 1; j += 32) {
        const int e = i * R + j;
        const float div = (s_fx[e] - s_fx[e - 1]) + (s_fy[e] - s_fy[e - R]);
        s_L[e] = s_L[e] + tau * div;
      }
    }
    __syncthreads();
  }

  // response: (p, q) <-> image (y0 - 2 + p, x0 - 2 + q), -inf outside (the
  // NMS window's outside)
  float* s_r = s_fx;
  for (int p = ty; p < S; p += NT / 32) {
    for (int q = tx; q < S; q += 32) {
      const int y = y0 - 2 + p, x = x0 - 2 + q;
      float r = -INFINITY;
      if (y >= 0 && y < H && x >= 0 && x < W) {
        const float* c = s_L + (back - 2 + p) * R + (back - 2 + q);
        const float lxx = (c[1] - 2.f * c[0]) + c[-1];
        const float lyy = (c[R] - 2.f * c[0]) + c[-R];
        const float lxy =
            0.25f * (((c[R + 1] - c[R - 1]) - c[-R + 1]) + c[-R - 1]);
        r = sigma4 * (lxx * lyy - lxy * lxy);
      }
      s_r[p * S + q] = r;
    }
  }
  __syncthreads();

  for (int a = ty; a < TILE; a += NT / 32) {
    const int y = y0 + a, x = x0 + tx;
    if (y >= H || x >= W) continue;
    const float c = s_r[(a + 2) * S + (tx + 2)];
    float m = -INFINITY;
#pragma unroll
    for (int u = 0; u < 5; ++u)
#pragma unroll
      for (int v = 0; v < 5; ++v) m = fmaxf(m, s_r[(a + u) * S + (tx + v)]);
    const size_t o = f * plane + (size_t)y * W + x;
    Lout[o] = s_L[(back + a) * R + (back + tx)];
    resp[o] = c;
    nms[o] = c >= m ? c : -INFINITY;
  }
}

}  // namespace

// The most diffusion steps one launch takes (its region fits the shared
// memory of one block).
extern "C" int slam_akaze_max_steps() {
  int s = 0;
  while (smem_bytes(s + 1) <= MAX_SMEM) ++s;
  return s;
}

// Plain C entry point (loaded with ctypes). img (F, H, W) float32 and k
// (F,) float32 in; L, resp, nms (F, H, W) float32 out; all contiguous on
// device `device`. 0 <= steps <= slam_akaze_max_steps(). Launches on
// `stream` and returns the launch's cudaError_t (0 on success).
extern "C" int slam_akaze_octave(const float* img, const float* k, float* L,
                                 float* resp, float* nms, int F, int H, int W,
                                 int steps, float tau, float sigma4,
                                 int device, void* stream) {
  if (F <= 0 || H <= 0 || W <= 0 || steps < 0 ||
      steps > slam_akaze_max_steps())
    return (int)cudaErrorInvalidValue;
  const slam::DeviceScope scope(device);
  cudaError_t err = scope.error();
  if (err != cudaSuccess) return (int)err;
  static slam::SmemOnce smem_once;  // to the most steps
  err = smem_once(akaze_octave_kernel, device,
                  smem_bytes(slam_akaze_max_steps()));
  if (err != cudaSuccess) return (int)err;
  const size_t smem = smem_bytes(steps);
  dim3 grid((W + TILE - 1) / TILE, (H + TILE - 1) / TILE, F);
  akaze_octave_kernel<<<grid, NT, smem, (cudaStream_t)stream>>>(
      img, k, L, resp, nms, H, W, steps, tau, sigma4);
  return (int)cudaGetLastError();
}
