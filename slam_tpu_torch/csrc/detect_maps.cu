// Kernel B1: fused detection maps for the Harris detector.
//
// Replaces the TPU kernel slam_tpu/ops/pallas_kernels.py:detect_maps_batch
// (body _detect_maps_kernel). One pass over each image computes the ten
// per-pixel channels the detector needs:
//   resp  Harris response: Sobel gradients, Gaussian (sigma 1.5, r 2)
//         structure tensor, det - k tr^2;
//   nms   resp where it is the max of its 5x5 window, -inf elsewhere;
//   maps  8 orientation channels: Gaussian (sigma 1.0, r 2) blur, Sobel,
//         magnitude and atan2f, soft 8-bin split, 4x4 box sum with XLA
//         SAME even padding (rows and columns [p-1, p+2]).
// Edge semantics follow the plain version (features.harris_response,
// features.nms, features.orientation_cell_maps): every convolution stage
// reads its own input as zero outside the image, and NMS reads outside as
// -inf. So the kernel matches its plain version over the whole image,
// where the TPU kernel's zero canvas differed within 4-6 px of the edge.
//
// What bounds it on the H100: device memory. Each pixel is read once
// (plus a 5-px halo) and ten float32 channels are written: at the
// frontend's shape, 64 images of 376x1241, that is ~1.2 GB of writes per
// chunk against ~0.12 GB of reads, ~0.4 ms at 3.35 TB/s. The arithmetic
// (~200 flops per pixel) is far below the card's float32 rate.
//
// Design: one CTA per (image, 32x32 output tile), 256 threads. The
// image tile with its 5-px halo is staged once in shared memory; every
// stage (Sobel, separable blurs, NMS max, atan2 binning, separable box
// sums) runs out of shared memory, so intermediates never touch device
// memory; the only global traffic is the halo'd input read and the ten
// coalesced output rows per tile row. Shared memory is one 42 KB buffer
// whose Harris-phase regions are reused by the orientation phase.
// atan2f replaces the polynomial the TPU needed (Mosaic had no atan2).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int TILE = 32;             // output tile side
constexpr int HALO = 5;              // Sobel 1 + Gaussian 2 + NMS 2
constexpr int R = TILE + 2 * HALO;   // 42: staged image region side
constexpr int G = TILE + 8;          // 40: Harris gradient region side
constexpr int S = TILE + 4;          // 36: Harris response region side
constexpr int OH = TILE + 6;         // 38: orientation blur region side
constexpr int OC = TILE + 3;         // 35: orientation channel region side
constexpr int NT = 256;

// shared-memory layout (floats). Harris phase:
constexpr int OFF_IMG = 0;                       // R x R image region
constexpr int OFF_GX = OFF_IMG + R * R;          // G x G
constexpr int OFF_GY = OFF_GX + G * G;           // G x G
constexpr int OFF_HXX = OFF_GY + G * G;          // G x S (row blurs)
constexpr int OFF_HYY = OFF_HXX + G * S;
constexpr int OFF_HXY = OFF_HYY + G * S;
constexpr int OFF_RESP = OFF_HXY + G * S;        // S x S response
constexpr int SMEM_FLOATS = OFF_RESP + S * S;    // 10580 floats
// orientation phase (reuses everything after the image region):
constexpr int OFF_BH = OFF_IMG + R * R;          // R x OH row blur
constexpr int OFF_BV = OFF_BH + R * OH;          // OH x OH blur
constexpr int OFF_M0 = OFF_BV + OH * OH;         // OC x OC weight, bin b0
constexpr int OFF_M1 = OFF_M0 + OC * OC;         // OC x OC weight, bin b0+1
constexpr int OFF_B0 = OFF_M1 + OC * OC;         // OC x OC bin index
constexpr int OFF_VBOX = OFF_B0 + OC * OC;       // TILE x OC column sums
static_assert(OFF_VBOX + TILE * OC <= SMEM_FLOATS, "orientation layout");

struct Taps {
  float h[5];  // Gaussian sigma 1.5 (structure tensor)
  float o[5];  // Gaussian sigma 1.0 (orientation blur)
};

__device__ __forceinline__ bool inside(int y, int x, int H, int W) {
  return y >= 0 && y < H && x >= 0 && x < W;
}

__global__ void __launch_bounds__(NT)
detect_maps_kernel(const float* __restrict__ img, float* __restrict__ resp,
                   float* __restrict__ nms, float* __restrict__ maps,
                   int H, int W, float k, Taps taps) {
  __shared__ float buf[SMEM_FLOATS];
  const int f = blockIdx.z;
  const int y0 = blockIdx.y * TILE;
  const int x0 = blockIdx.x * TILE;
  const int tid = threadIdx.x;
  const size_t plane = (size_t)H * W;
  const float* im = img + f * plane;

  // image region: (i, j) <-> image (y0 - 5 + i, x0 - 5 + j), zero outside
  float* s_img = buf + OFF_IMG;
  for (int idx = tid; idx < R * R; idx += NT) {
    const int y = y0 - HALO + idx / R, x = x0 - HALO + idx % R;
    s_img[idx] = inside(y, x, H, W) ? im[(size_t)y * W + x] : 0.f;
  }
  __syncthreads();

  // ---- Harris branch ------------------------------------------------------
  // gradients: (p, q) <-> image (y0 - 4 + p, x0 - 4 + q), zero outside
  float* s_gx = buf + OFF_GX;
  float* s_gy = buf + OFF_GY;
  for (int idx = tid; idx < G * G; idx += NT) {
    const int p = idx / G, q = idx % G;
    float gx = 0.f, gy = 0.f;
    if (inside(y0 - 4 + p, x0 - 4 + q, H, W)) {
      const float* c = s_img + (p + 1) * R + (q + 1);
      gx = ((c[-R + 1] - c[-R - 1]) + 2.f * (c[1] - c[-1])
            + (c[R + 1] - c[R - 1])) * 0.125f;
      gy = ((c[R - 1] - c[-R - 1]) + 2.f * (c[R] - c[-R])
            + (c[R + 1] - c[-R + 1])) * 0.125f;
    }
    s_gx[idx] = gx;
    s_gy[idx] = gy;
  }
  __syncthreads();

  // row blur of the gradient products: (p, q) centered on gradient col q+2
  float* s_hxx = buf + OFF_HXX;
  float* s_hyy = buf + OFF_HYY;
  float* s_hxy = buf + OFF_HXY;
  for (int idx = tid; idx < G * S; idx += NT) {
    const int p = idx / S, q = idx % S;
    float sxx = 0.f, syy = 0.f, sxy = 0.f;
#pragma unroll
    for (int t = 0; t < 5; ++t) {
      const float a = s_gx[p * G + q + t], b = s_gy[p * G + q + t];
      sxx += taps.h[t] * (a * a);
      syy += taps.h[t] * (b * b);
      sxy += taps.h[t] * (a * b);
    }
    s_hxx[idx] = sxx;
    s_hyy[idx] = syy;
    s_hxy[idx] = sxy;
  }
  __syncthreads();

  // column blur + response: (p, q) <-> image (y0 - 2 + p, x0 - 2 + q),
  // -inf outside (the NMS window's outside)
  float* s_r = buf + OFF_RESP;
  for (int idx = tid; idx < S * S; idx += NT) {
    const int p = idx / S, q = idx % S;
    float sxx = 0.f, syy = 0.f, sxy = 0.f;
#pragma unroll
    for (int t = 0; t < 5; ++t) {
      sxx += taps.h[t] * s_hxx[(p + t) * S + q];
      syy += taps.h[t] * s_hyy[(p + t) * S + q];
      sxy += taps.h[t] * s_hxy[(p + t) * S + q];
    }
    const float det = sxx * syy - sxy * sxy;
    const float tr = sxx + syy;
    s_r[idx] = inside(y0 - 2 + p, x0 - 2 + q, H, W) ? det - k * tr * tr
                                                    : -INFINITY;
  }
  __syncthreads();

  for (int idx = tid; idx < TILE * TILE; idx += NT) {
    const int a = idx / TILE, b = idx % TILE;
    const int y = y0 + a, x = x0 + b;
    if (!inside(y, x, H, W)) continue;
    const float c = s_r[(a + 2) * S + (b + 2)];
    float m = -INFINITY;
#pragma unroll
    for (int u = 0; u < 5; ++u)
#pragma unroll
      for (int v = 0; v < 5; ++v) m = fmaxf(m, s_r[(a + u) * S + (b + v)]);
    resp[f * plane + (size_t)y * W + x] = c;
    nms[f * plane + (size_t)y * W + x] = c >= m ? c : -INFINITY;
  }
  __syncthreads();  // the orientation phase reuses the Harris regions

  // ---- orientation branch -------------------------------------------------
  // row blur: (i, q) <-> image row y0 - 5 + i, col x0 - 3 + q
  float* s_bh = buf + OFF_BH;
  for (int idx = tid; idx < R * OH; idx += NT) {
    const int i = idx / OH, q = idx % OH;
    float s = 0.f;
#pragma unroll
    for (int t = 0; t < 5; ++t) s += taps.o[t] * s_img[i * R + q + t];
    s_bh[idx] = s;
  }
  __syncthreads();
  // column blur: (p, q) <-> image (y0 - 3 + p, x0 - 3 + q), zero outside
  float* s_bv = buf + OFF_BV;
  for (int idx = tid; idx < OH * OH; idx += NT) {
    const int p = idx / OH, q = idx % OH;
    float s = 0.f;
#pragma unroll
    for (int t = 0; t < 5; ++t) s += taps.o[t] * s_bh[(p + t) * OH + q];
    s_bv[idx] = inside(y0 - 3 + p, x0 - 3 + q, H, W) ? s : 0.f;
  }
  __syncthreads();
  // Sobel, magnitude, soft bins: (c, d) <-> image (y0 - 1 + c, x0 - 1 + d)
  float* s_m0 = buf + OFF_M0;
  float* s_m1 = buf + OFF_M1;
  int* s_b0 = reinterpret_cast<int*>(buf + OFF_B0);
  const float kPi = 3.14159265358979323846f;
  const float kTwoPi = 6.28318530717958647692f;
  for (int idx = tid; idx < OC * OC; idx += NT) {
    const int c = idx / OC, d = idx % OC;
    float m0 = 0.f, m1 = 0.f;
    int b0 = 0;
    if (inside(y0 - 1 + c, x0 - 1 + d, H, W)) {
      const float* z = s_bv + (c + 2) * OH + (d + 2);
      const float gx = ((z[-OH + 1] - z[-OH - 1]) + 2.f * (z[1] - z[-1])
                        + (z[OH + 1] - z[OH - 1])) * 0.125f;
      const float gy = ((z[OH - 1] - z[-OH - 1]) + 2.f * (z[OH] - z[-OH])
                        + (z[OH + 1] - z[-OH + 1])) * 0.125f;
      const float mag = sqrtf(gx * gx + gy * gy + 1e-12f);
      const float bin_f = (atan2f(gy, gx) + kPi) / kTwoPi * 8.f;
      const float fl = floorf(bin_f);
      const float w1 = bin_f - fl;
      b0 = (((int)fl) % 8 + 8) % 8;
      m0 = mag * (1.f - w1);
      m1 = mag * w1;
    }
    s_m0[idx] = m0;
    s_m1[idx] = m1;
    s_b0[idx] = b0;
  }
  __syncthreads();
  // per channel: column sums over ch rows [a, a+3] (image rows y-1..y+2),
  // then row sums over cols [b, b+3] (image cols x-1..x+2)
  float* s_vbox = buf + OFF_VBOX;
  for (int o = 0; o < 8; ++o) {
    for (int idx = tid; idx < TILE * OC; idx += NT) {
      const int a = idx / OC, d = idx % OC;
      float s = 0.f;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int e = (a + u) * OC + d;
        const int b0 = s_b0[e];
        s += (b0 == o ? s_m0[e] : 0.f) + (((b0 + 1) & 7) == o ? s_m1[e] : 0.f);
      }
      s_vbox[idx] = s;
    }
    __syncthreads();
    float* out = maps + ((size_t)f * 8 + o) * plane;
    for (int idx = tid; idx < TILE * TILE; idx += NT) {
      const int a = idx / TILE, b = idx % TILE;
      const int y = y0 + a, x = x0 + b;
      if (!inside(y, x, H, W)) continue;
      const float* v = s_vbox + a * OC + b;
      out[(size_t)y * W + x] = ((v[0] + v[1]) + v[2]) + v[3];
    }
    __syncthreads();
  }
}

}  // namespace

// Plain C entry point (loaded with ctypes). img (F, H, W) float32 in;
// resp, nms (F, H, W) and maps (F, 8, H, W) float32 out, all contiguous on
// the current device. taps_h / taps_o: 5 host floats each. Launches on
// `stream` and returns the launch's cudaError_t (0 on success).
extern "C" int slam_detect_maps(const float* img, float* resp, float* nms,
                                float* maps, int F, int H, int W, float k,
                                const float* taps_h, const float* taps_o,
                                void* stream) {
  if (F <= 0 || H <= 0 || W <= 0) return (int)cudaErrorInvalidValue;
  Taps taps;
  for (int t = 0; t < 5; ++t) {
    taps.h[t] = taps_h[t];
    taps.o[t] = taps_o[t];
  }
  dim3 grid((W + TILE - 1) / TILE, (H + TILE - 1) / TILE, F);
  detect_maps_kernel<<<grid, NT, 0, (cudaStream_t)stream>>>(
      img, resp, nms, maps, H, W, k, taps);
  return (int)cudaGetLastError();
}
