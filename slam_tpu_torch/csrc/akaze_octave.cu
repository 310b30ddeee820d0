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
// padded canvas is built, and an image smaller than the halo wraps more
// than once. NMS reads outside the image as -inf, as features.nms does
// (the TPU kernel wrapped there too). So all three outputs match the plain
// version over the whole image.
//
// Halo: one step reads 2 pixels behind and 1 ahead on each axis (the
// centred gradient feeds a backward difference of the flux), the Hessian
// 1 and the NMS 2 more. So a tile needs 2 steps + 3 pixels on the top
// and left and steps + 3 on the bottom and right: 15 and 9 for 6 steps.
//
// What bounds it on the H100. By bytes, device memory: one read and three
// writes per pixel, ~0.48 GB per octave-0 call at (64, 376, 1241), ~0.14 ms
// at 3.35 TB/s. In practice shared-memory traffic and the schedulers' rate: the
// halo'd tile is diffused again by every CTA, and a design with a flux pass
// and an update pass per step over the whole region moves ~244 four-byte
// values per output pixel through shared memory and divides twice per
// region pixel and step (half of its cycles are the flux passes). This
// design fights those, not the bytes.
//
// Design: one CTA of 12 warps per (image, 72 x 64 output tile); the halo'd
// region, (72 + 3 steps + 6) x (64 + 3 steps + 6), lives in two
// shared-memory buffers (ping-pong): 2 x 96 x 88 floats = 67,584 B for 6
// steps, 3 CTAs an SM; at most slam_akaze_max_steps() steps fit one block's
// 227 KB. A step is one fused pass and one barrier: a thread marches down a
// column of the old buffer carrying L's three rows and the flux above it
// (g gy of the row before) in registers, reads L's left and right
// neighbours from shared memory, takes the flux on its left (g gx of the
// column before) from the lane beside it by a shuffle, and writes only the
// new L into the other buffer: 3 reads, 1 write and 1 shuffle per pixel
// and step where the two-pass design had 9 reads and 3 writes. A warp
// covers 31 updated columns (lane 0 computes flux only, for lane 1) and a
// segment of the rows (its first row's upper flux is computed again). Step
// n of S updates only rows and columns [2n, R - 1 - n], what the later
// steps, the Hessian and the NMS still read: 8.7 pixel-steps per output
// pixel at 6 steps where the whole 56 x 56 region of a 32 x 32 tile took
// 18.4. g is one approximate reciprocal, 1 / (1 + s / k^2) with 1 / k^2
// computed once (k >= 1e-4, so neither 1 / k^2 nor the sum overflows). The
// Hessian marches down columns the same way (3 reads per pixel), and the
// 5x5 NMS is separable: a row maximum of 5 reads, the column maximum in
// registers. steps == 6, what the frontend passes, is a compile-time
// instantiation (constant strides, unrolled steps); every other count runs
// the same code with run-time sizes. Counted at 6 steps: 43 shared-memory
// accesses and shuffles per output pixel in the steps, 2 in the load, 5 in
// the Hessian and 8 in the outputs, ~58 in all, and steps + 2 barriers.
//
// Registers, from nvcc -Xptxas -v for sm_90a (no spills): 51 a thread for
// the 6-step instantiation, 56 for the run-time one, at 384 threads; 67,584
// B of shared memory at 6 steps; 3 blocks an SM.

#include <cuda_runtime.h>
#include <math.h>

#include "launch.cuh"

namespace {

constexpr int TW = 72;                // output tile width
constexpr int TH = 64;                // output tile height
constexpr int NW = 12;                // warps per CTA
constexpr int NT = 32 * NW;
constexpr int LOAD_ROWS = 8;          // rows and columns a thread loads
constexpr int LOAD_COLS = 3;          // before it stores them
constexpr int SW = TW + 4;            // response region (NMS halo 2)
constexpr int SH = TH + 4;
constexpr int MAX_SMEM = 232448;      // shared memory a block can use
constexpr unsigned FULL = 0xffffffffu;

__host__ __device__ constexpr int region_w(int steps) {
  return TW + 3 * steps + 6;
}

__host__ __device__ constexpr int region_h(int steps) {
  return TH + 3 * steps + 6;
}

__host__ __device__ constexpr size_t smem_bytes(int steps) {
  return (size_t)2 * region_w(steps) * region_h(steps) * sizeof(float);
}

static_assert(SW * SH <= region_w(0) * region_h(0),
              "the response region fits one buffer");

__device__ __forceinline__ int wrap(int v, int n) {
  v %= n;
  return v < 0 ? v + n : v;
}

// The PM-g2 conductivity times the doubled gradient, (g hx, g hy) with
// hx = 2 gx, hy = 2 gy the plain differences of L: g = 1 / (1 + (gx^2 +
// gy^2) / k^2) = 1 / (1 + (hx^2 + hy^2) q) with q = 1 / (4 k^2). Scaling by
// a power of two is exact, so the halves are folded into q and tau and
// every rounding stays where the plain version has it.
__device__ __forceinline__ void flux(float hx, float hy, float q, float& fx,
                                     float& fy) {
  const float g = __fdividef(1.f, fmaf(hx * hx + hy * hy, q, 1.f));
  fx = g * hx;
  fy = g * hy;
}

// STEPS >= 0: that many steps, sizes known to the compiler; STEPS < 0: the
// run-time count `steps_rt`.
template <int STEPS>
__global__ void __launch_bounds__(NT, 3)
akaze_octave_kernel(const float* __restrict__ img, const float* __restrict__ kf,
                    float* __restrict__ Lout, float* __restrict__ resp,
                    float* __restrict__ nms, int H, int W, int steps_rt,
                    float tau, float sigma4) {
  extern __shared__ float smem[];
  const int steps = STEPS >= 0 ? STEPS : steps_rt;
  const int RW = region_w(steps), RH = region_h(steps);
  const int back = 2 * steps + 3;     // halo on the top and left
  float* A = smem;                    // the region before a step
  float* B = smem + RW * RH;          // and after it; later the response
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int f = blockIdx.z;
  const int y0 = blockIdx.y * TH;
  const int x0 = blockIdx.x * TW;
  const size_t plane = (size_t)H * W;
  const float* im = img + f * plane;
  const float k = kf[f];
  const float q = 0.25f / (k * k);
  const float half_tau = 0.5f * tau;

  // region (i, j) <-> image ((y0 - back + i) mod H, (x0 - back + j) mod W):
  // a warp takes every NW-th row and a lane every 32nd column; LOAD_ROWS x
  // LOAD_COLS loads are in flight per thread before the first is stored
  // (the whole region at 6 steps)
  {
    auto wrapped = [](int v, int n) {  // one wrap without a division
      if (v < 0) v += n;
      if (v >= n) v -= n;
      return (unsigned)v < (unsigned)n ? v : wrap(v, n);
    };
    for (int j0 = lane; j0 < RW; j0 += 32 * LOAD_COLS) {
      for (int i0 = warp; i0 < RH; i0 += NW * LOAD_ROWS) {
        float v[LOAD_COLS][LOAD_ROWS];
#pragma unroll
        for (int c = 0; c < LOAD_COLS; ++c) {
          const int j = j0 + 32 * c;
          const float* col = im + wrapped(x0 - back + j, W);
#pragma unroll
          for (int u = 0; u < LOAD_ROWS; ++u) {
            const int i = i0 + u * NW;
            if (j < RW && i < RH)
              v[c][u] = col[(size_t)wrapped(y0 - back + i, H) * W];
          }
        }
#pragma unroll
        for (int c = 0; c < LOAD_COLS; ++c) {
#pragma unroll
          for (int u = 0; u < LOAD_ROWS; ++u) {
            const int i = i0 + u * NW, j = j0 + 32 * c;
            if (j < RW && i < RH) A[i * RW + j] = v[c][u];
          }
        }
      }
    }
  }
  __syncthreads();  // load

  // step n updates rows and columns [2n, R - 1 - n] from A into B
#pragma unroll (STEPS > 0 ? STEPS : 1)
  for (int n = 1; n <= steps; ++n) {
    const int lo = 2 * n;
    const int wn = RW - 3 * n, hn = RH - 3 * n;
    const int ncg = (wn + 30) / 31;   // column groups of 31 updated columns
    const int nseg = NW / ncg;        // row segments
    const int cg = warp % ncg, seg = warp / ncg;
    if (seg < nseg) {
      const int seg_rows = (hn + nseg - 1) / nseg;
      const int i0 = lo + seg * seg_rows;
      const int i1 = min(i0 + seg_rows, lo + hn);
      const int j = lo - 1 + 31 * cg + lane;   // lane 0: flux only
      const bool stores = lane > 0 && j < lo + wn;
      const float* a = A + min(j, RW - 2);
      float* b = B + j;
      float up, c = a[(i0 - 2) * RW], dn = a[(i0 - 1) * RW];
      float fx, fy, fy_up = 0.f;
      // i0 - 1: only the flux below it; then the segment's rows
      for (int i = i0 - 1; i < i1; ++i) {
        up = c;
        c = dn;
        dn = a[(i + 1) * RW];
        flux(a[i * RW + 1] - a[i * RW - 1], dn - up, q, fx, fy);
        const float fx_left = __shfl_up_sync(FULL, fx, 1);
        const float div = (fx - fx_left) + (fy - fy_up);
        if (stores && i >= i0) b[i * RW] = c + half_tau * div;
        fy_up = fy;
      }
    }
    float* t = A;
    A = B;
    B = t;
    __syncthreads();  // diffusion steps
  }

  // response: (p, q) <-> image (y0 - 2 + p, x0 - 2 + q), -inf outside (the
  // NMS window's outside); a thread marches down column q of a row segment
  float* s_r = B;
  {
    constexpr int ncg = (SW + 31) / 32, nseg = NW / ncg;
    constexpr int seg_rows = (SH + nseg - 1) / nseg;
    const int q = 32 * (warp % ncg) + lane, seg = warp / ncg;
    const int p0 = seg * seg_rows, p1 = min(p0 + seg_rows, SH);
    const int x = x0 - 2 + q;
    if (seg < nseg && q < SW) {
      const float* a = A + (back - 2) * RW + (back - 2) + q;
      float u[3], c[3], d[3];
#pragma unroll
      for (int t = 0; t < 3; ++t) {
        c[t] = a[(p0 - 1) * RW + t - 1];
        d[t] = a[p0 * RW + t - 1];
      }
      for (int p = p0; p < p1; ++p) {
#pragma unroll
        for (int t = 0; t < 3; ++t) {
          u[t] = c[t];
          c[t] = d[t];
          d[t] = a[(p + 1) * RW + t - 1];
        }
        const int y = y0 - 2 + p;
        const float lxx = (c[2] - 2.f * c[1]) + c[0];
        const float lyy = (d[1] - 2.f * c[1]) + u[1];
        const float lxy = 0.25f * (((d[2] - d[0]) - u[2]) + u[0]);
        s_r[p * SW + q] = y >= 0 && y < H && x >= 0 && x < W
                              ? sigma4 * (lxx * lyy - lxy * lxy)
                              : -INFINITY;
      }
    }
  }
  __syncthreads();  // Hessian response

  // outputs: a thread marches down output column b of a row segment with
  // the row maxima of the 5 response rows around it in registers
  {
    constexpr int ncg = (TW + 31) / 32, nseg = NW / ncg;
    constexpr int seg_rows = (TH + nseg - 1) / nseg;
    const int bcol = 32 * (warp % ncg) + lane, seg = warp / ncg;
    const int a0 = seg * seg_rows;
    const int a1 = min(min(a0 + seg_rows, TH), H - y0);
    const int x = x0 + bcol;
    if (seg < nseg && bcol < TW && x < W) {
      auto row_max = [&](int p) {
        const float* r = s_r + p * SW + bcol;
        return fmaxf(fmaxf(fmaxf(r[0], r[1]), fmaxf(r[2], r[3])), r[4]);
      };
      float m[4];
#pragma unroll
      for (int t = 0; t < 4; ++t) m[t] = row_max(a0 + t);
      for (int a = a0; a < a1; ++a) {
        const float m4 = row_max(a + 4);
        const float mm = fmaxf(fmaxf(fmaxf(m[0], m[1]), fmaxf(m[2], m[3])),
                               m4);
        const float c = s_r[(a + 2) * SW + bcol + 2];
        const size_t o = f * plane + (size_t)(y0 + a) * W + x;
        Lout[o] = A[(back + a) * RW + back + bcol];
        resp[o] = c;
        nms[o] = c >= mm ? c : -INFINITY;
        m[0] = m[1];
        m[1] = m[2];
        m[2] = m[3];
        m[3] = m4;
      }
    }
  }
}

template <int STEPS>
cudaError_t launch(const float* img, const float* k, float* L, float* resp,
                   float* nms, int F, int H, int W, int steps, float tau,
                   float sigma4, int device, size_t smem_most, void* stream) {
  static slam::SmemOnce smem_once;  // to the most this instantiation takes
  const cudaError_t err =
      smem_once(akaze_octave_kernel<STEPS>, device, smem_most);
  if (err != cudaSuccess) return err;
  dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, F);
  akaze_octave_kernel<STEPS><<<grid, NT, smem_bytes(steps),
                               (cudaStream_t)stream>>>(
      img, k, L, resp, nms, H, W, steps, tau, sigma4);
  return cudaGetLastError();
}

}  // namespace

// The most diffusion steps one launch takes (its two buffers fit the
// shared memory of one block).
extern "C" int slam_akaze_max_steps() {
  int s = 0;
  while (smem_bytes(s + 1) <= MAX_SMEM) ++s;
  return s;
}

// Which path a launch with `steps` steps takes: 1 the compile-time
// instantiation (steps == 6), 0 the run-time one.
extern "C" int slam_akaze_static_path(int steps) { return steps == 6; }

// Plain C entry point (loaded with ctypes). img (F, H, W) float32 and k
// (F,) float32 in; L, resp, nms (F, H, W) float32 out; all contiguous on
// device `device`; F <= 65535. 0 <= steps <= slam_akaze_max_steps().
// Launches on `stream` and returns the launch's cudaError_t (0 on success).
extern "C" int slam_akaze_octave(const float* img, const float* k, float* L,
                                 float* resp, float* nms, int F, int H, int W,
                                 int steps, float tau, float sigma4,
                                 int device, void* stream) {
  if (F <= 0 || F > 65535 || H <= 0 || W <= 0 || steps < 0 ||
      steps > slam_akaze_max_steps())
    return (int)cudaErrorInvalidValue;
  const slam::DeviceScope scope(device);
  if (scope.error() != cudaSuccess) return (int)scope.error();
  if (slam_akaze_static_path(steps))
    return (int)launch<6>(img, k, L, resp, nms, F, H, W, steps, tau, sigma4,
                          device, smem_bytes(6), stream);
  return (int)launch<-1>(img, k, L, resp, nms, F, H, W, steps, tau, sigma4,
                         device, smem_bytes(slam_akaze_max_steps()), stream);
}
