// Kernels B1, B3 and B4: the Harris and descriptor maps of the detectors.
//
// Replaces three TPU kernels of slam_tpu/ops/pallas_kernels.py, all built
// there from the same stage bodies, and here from one template
// maps_kernel<HARRIS, ORIENT>:
//   B1 detect_maps_batch           (_detect_maps_kernel): both phases;
//   B4 harris_response_batch       (_harris_kernel):      Harris phase only;
//   B3 orientation_cell_maps_batch (_orient_kernel):      orientation only.
// The phases compute, per pixel:
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
// What bounds it on the H100. By bytes, device memory: each pixel is read
// once and up to ten float32 planes are written, ~1.3 GB per chunk of 64
// images of 376x1241 for B1, ~0.39 ms at 3.35 TB/s. In practice the
// schedulers' rate and the traffic between threads: a design that
// stages every intermediate of a 32x32 tile in shared memory moves ~257
// four-byte values per output pixel through it (the 4x4 box sums alone,
// redone for each of the 8 channels, 57% of that) behind 24 barriers per
// tile, and runs at a quarter of the bytes bound. This design fights that,
// not the bytes.
//
// Design: a block of 256 threads owns 256 image columns side by side (at
// most 246 output columns and the 5-column halo of Sobel 1 + Gaussian 2 +
// NMS 2 on each side) and marches down a chunk of rows, one image row per
// iteration. A thread holds its column's sliding windows in registers: the
// last image rows for the Sobel taps, 4 rows of the row-blurred gradient
// products and of the orientation blur for the vertical 5-tap blurs, the
// row maxima for the separable 5x5 NMS (row max, then column max: exact in
// any order), and the last 3 rows' 8-channel vectors, so that a pixel's
// soft-binned vector is built once and the 8 column sums of a row come from
// registers. Only the horizontal taps cross threads, through one line of
// shared memory per exchanged value: the image row, the two gradients, the
// response, the blurred row and the 8 column sums, 13 writes and 42 reads
// per thread and row, ~61 per output pixel with the halo and the rows a
// chunk repeats (B4 4 + 16, B3 10 + 28). Every stage reads the line that
// the stage before it wrote one iteration earlier, so the stages lag each
// other by one more row (output row = input row - 8), the lines are kept
// twice, and one barrier per iteration does for the whole block: 4 per
// 1024 output pixels. Sums keep the order of the staged design (taps left
// to right and top to bottom, box sums ((v0 + v1) + v2) + v3, rows then
// columns), so no running sum drifts. A warp stores 32 consecutive floats
// of each plane straight from registers. The blocks of a row are of equal
// width, and the rows are cut into the number of chunks that makes the
// grid's waves times a chunk's iterations least (a chunk repeats the 13
// rows above it). atan2 is a polynomial without a division's slow path.
// Tried and dropped: one warp per 22-column strip exchanging by shuffles
// with no barrier (5 of 16 lanes are halo, and its stores cover no whole
// sectors unless staged, which cost a third more work per row).
//
// Registers, from nvcc -Xptxas -v for sm_90a (no spills): B1 128, B3 116,
// B4 79 at 256 threads; shared memory 27,040, 20,800 and 8,320 B; 2, 2 and
// 3 blocks an SM.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>

#include <type_traits>

#include "launch.cuh"

namespace {

constexpr int HALO = 5;               // Sobel 1 + Gaussian 2 + NMS 2
constexpr int WARPS = 8;
constexpr int NT = 32 * WARPS;        // a block's columns, halo included
constexpr int SPAN = NT - 2 * HALO;   // of which it stores at most these
constexpr int PAD = 2;                // a line's cells before and after
constexpr int LINE = NT + 2 * PAD;
constexpr int LAG = 13;               // iterations before a chunk's first row
constexpr int MIN_ROWS = 32;          // fewest output rows of a chunk

struct Taps {
  float h[5];  // Gaussian sigma 1.5 (structure tensor)
  float o[5];  // Gaussian sigma 1.0 (orientation blur)
};

// Sobel taps / 8 on rows a (above), b (center: only its outer columns are
// read), c (below), each {x - 1, x, x + 1}
__device__ __forceinline__ void sobel(const float (&a)[3], const float (&b)[3],
                                      const float (&c)[3], float& gx,
                                      float& gy) {
  gx = ((a[2] - a[0]) + 2.f * (b[2] - b[0]) + (c[2] - c[0])) * 0.125f;
  gy = ((c[0] - a[0]) + 2.f * (c[1] - a[1]) + (c[2] - a[2])) * 0.125f;
}

// The windows are rings: the value an iteration t makes lies in slot t & 3
// (t & 1 of a ring of two), and the row loop is unrolled by four with the
// phase PH = t & 3 a compile-time value, so every slot is a fixed register
// and nothing is moved to shift a window.

// 5 taps over a ring's 4 rows (oldest first) and the new one
template <int PH>
__device__ __forceinline__ float blur5(const float (&t)[5],
                                       const float (&w)[4], float v) {
  float s = 0.f;
#pragma unroll
  for (int u = 0; u < 4; ++u) s += t[u] * w[(PH + u) & 3];
  return s + t[4] * v;
}

// atan2(y, x) in (-pi, pi], within 4e-7: the octant's ratio by an
// approximate division, its arctangent by the odd polynomial of Cephes'
// atanf on [0, tan(pi / 8)], above that through (t - 1) / (t + 1). No
// branch and no call, where atan2f has two divisions with slow paths.
__device__ __forceinline__ float atan2_poly(float y, float x) {
  const float ax = fabsf(x), ay = fabsf(y);
  const float t = __fdividef(fminf(ax, ay), fmaxf(fmaxf(ax, ay), 1e-37f));
  const bool big = t > 0.41421356237f;
  const float u = big ? __fdividef(t - 1.f, t + 1.f) : t;
  const float z = u * u;
  float a = (((8.05374449538e-2f * z - 1.38776856032e-1f) * z
              + 1.99777106478e-1f) * z - 3.33329491539e-1f) * z * u + u;
  a = big ? a + 0.78539816339744830962f : a;
  a = ay > ax ? 1.57079632679489661923f - a : a;
  a = x < 0.f ? 3.14159265358979323846f - a : a;
  return y < 0.f ? -a : a;
}

template <bool HARRIS, bool ORIENT>
__global__ void __launch_bounds__(NT, 2)
maps_kernel(const float* __restrict__ img, float* __restrict__ resp,
            float* __restrict__ nms, float* __restrict__ maps, int H, int W,
            int rows, int pitch, float k, Taps taps) {
  static_assert(HARRIS || ORIENT, "a variant runs at least one phase");
  // the lines of one row that the threads exchange: the image, then the
  // gradients and the response, then the blurred image and the 8 channels'
  // column sums
  constexpr int L_GX = 1, L_GY = 2, L_R = 3;
  constexpr int L_BV = HARRIS ? 4 : 1, L_CS = L_BV + 1;
  constexpr int NL = 1 + (HARRIS ? 3 : 0) + (ORIENT ? 9 : 0);
  extern __shared__ float lines[];            // [2][NL][LINE]
  const int q = threadIdx.x;                  // the thread's column here
  const int ys = blockIdx.y * rows;           // output rows [ys, ys + nrows)
  const int nrows = min(rows, H - ys);
  const int x0 = blockIdx.x * pitch;          // output columns [x0, x0 + pitch)
  const int x = x0 - HALO + q;                // the thread's image column
  const bool col_in = x >= 0 && x < W;
  const bool stores = q >= HALO && q < HALO + pitch && x < W;
  // a warp whose columns all lie past the halo only keeps the barriers
  const int q0 = q & ~31;
  const bool active = q0 < pitch + 2 * HALO && x0 - HALO + q0 < W + HALO;
  const int plane = H * W;
  const float* im = img + (size_t)blockIdx.z * plane;
  float* out_r = HARRIS ? resp + (size_t)blockIdx.z * plane : nullptr;
  float* out_n = HARRIS ? nms + (size_t)blockIdx.z * plane : nullptr;
  float* out_m = ORIENT ? maps + (size_t)blockIdx.z * 8 * plane : nullptr;
  // row y of this thread's column, at im[off], zero outside the image
  auto row_in = [&](int y) { return col_in && (unsigned)y < (unsigned)H; };
  auto load = [&](int y, int off) {
    return row_in(y) ? __ldg(im + off) : 0.f;
  };

  for (int i = q; i < 2 * NL * LINE; i += NT) lines[i] = 0.f;

  // the rings; iteration t takes in image row yi = ys - 5 + t and makes
  // output row j = t - 13 of the chunk
  float prev = 0.f;                    // image row yi-1
  float irow[2][3] = {};               // image rows yi-3, yi-2 at x-1..x+1
  float pgx = 0.f, pgy = 0.f;          // gradients, row yi-3
  float hxx[4] = {}, hyy[4] = {}, hxy[4] = {};  // row blurs, rows yi-7..yi-4
  float rv[4] = {};                    // response, rows yi-9..yi-6
  float rm[4] = {};                    // row maxima, rows yi-10..yi-7
  float bh[4] = {};                    // orientation row blur, yi-5..yi-2
  float pbv = 0.f;                     // blurred image, row yi-4
  float brow[2][3] = {};               // blur rows yi-6, yi-5 at x-1..x+1
  float vw[4][8] = {};                 // channel vectors, rows yi-9..yi-6
  float pcs[8] = {};                   // column sums of output row yi-8
  int in_off = (ys - HALO) * W + x;    // of the next load
  float n0 = load(ys - HALO, in_off);
  float n1 = load(ys - HALO + 1, in_off += W);
  int out_off = (ys - LAG) * W + x;    // of this iteration's output
  __syncthreads();  // lines zeroed

  auto step = [&](auto phase, int t) {
    constexpr int PH = decltype(phase)::value;   // t & 3
    constexpr int P2 = PH & 1, Q2 = P2 ^ 1;      // rings of two: t-2, t-1
    // this iteration's lines, and those of the one before it
    float* wr = lines + P2 * (NL * LINE) + PAD + q;
    const float* rd = lines + Q2 * (NL * LINE) + PAD + q;
    const int yi = ys - HALO + t;
    const int j = t - LAG;
    const bool emit = stores && j >= 0 && j < nrows;
    const float cur = n0;
    n0 = n1;
    n1 = load(yi + 2, in_off += W);
    wr[0] = cur;
    float res_c, res_n, box[8];          // this iteration's outputs
    const float ic[3] = {rd[-1], prev, rd[1]};   // image row yi-1

    if constexpr (HARRIS) {
      // gradients of row yi-2, zero outside the image
      float gx, gy;
      sobel(irow[P2], irow[Q2], ic, gx, gy);
      const bool in2 = row_in(yi - 2);
      gx = in2 ? gx : 0.f;
      gy = in2 ? gy : 0.f;
      wr[L_GX * LINE] = gx;
      wr[L_GY * LINE] = gy;
      // row blur of the gradient products, row yi-3
      const float* ga = rd + L_GX * LINE;
      const float* gb = rd + L_GY * LINE;
      const float a5[5] = {ga[-2], ga[-1], pgx, ga[1], ga[2]};
      const float b5[5] = {gb[-2], gb[-1], pgy, gb[1], gb[2]};
      float sxx = 0.f, syy = 0.f, sxy = 0.f;
#pragma unroll
      for (int u = 0; u < 5; ++u) {
        sxx += taps.h[u] * (a5[u] * a5[u]);
        syy += taps.h[u] * (b5[u] * b5[u]);
        sxy += taps.h[u] * (a5[u] * b5[u]);
      }
      // column blur and response, row yi-5; -inf outside (the NMS
      // window's outside)
      const float cxx = blur5<PH>(taps.h, hxx, sxx);
      const float cyy = blur5<PH>(taps.h, hyy, syy);
      const float cxy = blur5<PH>(taps.h, hxy, sxy);
      const float det = cxx * cyy - cxy * cxy;
      const float tr = cxx + cyy;
      const float r = row_in(yi - 5) ? det - k * tr * tr : -INFINITY;
      wr[L_R * LINE] = r;
      // 5x5 max around row yi-8: row maximum of row yi-6, then the
      // maximum over rows yi-10 .. yi-6
      const float* ra = rd + L_R * LINE;
      const float m = fmaxf(fmaxf(fmaxf(ra[-2], ra[-1]), fmaxf(ra[1], ra[2])),
                            rv[(PH + 3) & 3]);
      const float mm = fmaxf(fmaxf(fmaxf(rm[0], rm[1]), fmaxf(rm[2], rm[3])),
                             m);
      res_c = rv[(PH + 1) & 3];
      res_n = res_c >= mm ? res_c : -INFINITY;
      pgx = gx;
      pgy = gy;
      hxx[PH] = sxx;
      hyy[PH] = syy;
      hxy[PH] = sxy;
      rv[PH] = r;
      rm[PH] = m;
    }

    if constexpr (ORIENT) {
      // row blur of image row yi-1
      const float i5[5] = {rd[-2], ic[0], prev, ic[2], rd[2]};
      float s = 0.f;
#pragma unroll
      for (int u = 0; u < 5; ++u) s += taps.o[u] * i5[u];
      // column blur, row yi-3, zero outside the image
      const float bv = row_in(yi - 3) ? blur5<PH>(taps.o, bh, s) : 0.f;
      wr[L_BV * LINE] = bv;
      // Sobel, magnitude and soft bins of row yi-5, zero outside
      const float* ba = rd + L_BV * LINE;
      const float bc[3] = {ba[-1], pbv, ba[1]};  // blur row yi-4
      float gx, gy;
      sobel(brow[P2], brow[Q2], bc, gx, gy);
      const float kPi = 3.14159265358979323846f;
      const float kBinsPerRad = 8.f / 6.28318530717958647692f;
      const float sq = gx * gx + gy * gy + 1e-12f;
      const float mag = sq * rsqrtf(sq);
      const float bin_f = (atan2_poly(gy, gx) + kPi) * kBinsPerRad;
      const float fl = floorf(bin_f);
      const float w1 = bin_f - fl;
      const bool in5 = row_in(yi - 5);
      const int b0 = ((int)fl) & 7;
      const float m0 = in5 ? mag * (1.f - w1) : 0.f;
      const float m1 = in5 ? mag * w1 : 0.f;
      // per channel: the pixel's value (row yi-5: m0 in bin b0, m1 in the
      // bin after it) and the column sum over rows yo-1 .. yo+2 = yi-8 ..
      // yi-5 of output row yo = yi-7; then, of the row before it, the row
      // sum over the columns x-1 .. x+2
      bool is_b0[8];
#pragma unroll
      for (int ch = 0; ch < 8; ++ch) is_b0[ch] = b0 == ch;
#pragma unroll
      for (int ch = 0; ch < 8; ++ch) {
        const float v = is_b0[ch] ? m0 : (is_b0[(ch + 7) & 7] ? m1 : 0.f);
        const float cs = ((vw[(PH + 1) & 3][ch] + vw[(PH + 2) & 3][ch])
                          + vw[(PH + 3) & 3][ch]) + v;
        wr[(L_CS + ch) * LINE] = cs;
        const float* ca = rd + (L_CS + ch) * LINE;
        box[ch] = ((ca[-1] + pcs[ch]) + ca[1]) + ca[2];
        vw[PH][ch] = v;
        pcs[ch] = cs;
      }
      bh[PH] = s;
      pbv = bv;
#pragma unroll
      for (int u = 0; u < 3; ++u) brow[P2][u] = bc[u];
    }

    if (emit) {
      if constexpr (HARRIS) {
        out_r[out_off] = res_c;
        out_n[out_off] = res_n;
      }
      if constexpr (ORIENT) {
#pragma unroll
        for (int ch = 0; ch < 8; ++ch) out_m[ch * plane + out_off] = box[ch];
      }
    }
#pragma unroll
    for (int u = 0; u < 3; ++u) irow[P2][u] = ic[u];
    prev = cur;
    out_off += W;
  };
  using std::integral_constant;

  // four iterations a turn; one barrier an iteration: it makes this
  // iteration's lines readable and frees the other buffer's for the next.
  // Iterations past the chunk's last row store nothing. A warp outside
  // the image keeps the barriers' count and does nothing else.
  const int turns = (nrows + LAG + 3) / 4;
  if (active) {
    for (int t = 0; t < 4 * turns; t += 4) {
      step(integral_constant<int, 0>{}, t);
      __syncthreads();  // lines of iteration t written
      step(integral_constant<int, 1>{}, t + 1);
      __syncthreads();  // of t + 1
      step(integral_constant<int, 2>{}, t + 2);
      __syncthreads();  // of t + 2
      step(integral_constant<int, 3>{}, t + 3);
      __syncthreads();  // of t + 3
    }
  } else {
    for (int t = 0; t < 4 * turns; ++t) __syncthreads();  // idle warp
  }
}

Taps make_taps(const float* taps_h, const float* taps_o) {
  Taps taps;
  for (int t = 0; t < 5; ++t) {
    taps.h[t] = taps_h ? taps_h[t] : 0.f;
    taps.o[t] = taps_o ? taps_o[t] : 0.f;
  }
  return taps;
}

template <bool HARRIS, bool ORIENT>
int launch(const float* img, float* resp, float* nms, float* maps, int F,
           int H, int W, float k, const float* taps_h, const float* taps_o,
           int device, void* stream) {
  if (F <= 0 || F > 65535 || H <= 0 || W <= 0 ||
      (8 * (size_t)H + 2 * LAG) * W > (size_t)INT_MAX)  // offsets: int
    return (int)cudaErrorInvalidValue;
  const slam::DeviceScope scope(device);
  if (scope.error() != cudaSuccess) return (int)scope.error();
  // two buffers of the lines the variant exchanges
  constexpr size_t smem = (size_t)2 * (1 + (HARRIS ? 3 : 0)
      + (ORIENT ? 9 : 0)) * LINE * sizeof(float);
  // the blocks the card runs at once, asked once per device
  static int slots[64] = {};
  int& at_once = slots[device & 63];
  if (at_once == 0) {
    int sms = 0, per_sm = 0;
    cudaError_t err = cudaDeviceGetAttribute(
        &sms, cudaDevAttrMultiProcessorCount, device);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, maps_kernel<HARRIS, ORIENT>, NT, smem);
    if (err != cudaSuccess) return (int)err;
    at_once = max(1, sms * per_sm);
  }
  // columns in blocks of equal width, at most SPAN each
  const int nblocks = (W + SPAN - 1) / SPAN;
  const int pitch = (W + nblocks - 1) / nblocks;
  // rows in chunks of equal height, at least MIN_ROWS each: the count that
  // makes waves x iterations least
  int nchunks = 1;
  long long least = 0;
  for (int n = 1; n <= (H + MIN_ROWS - 1) / MIN_ROWS; ++n) {
    const long long blocks = (long long)F * nblocks * n;
    const long long waves = (blocks + at_once - 1) / at_once;
    const long long cost = waves * ((H + n - 1) / n + LAG);
    if (n == 1 || cost < least) {
      least = cost;
      nchunks = n;
    }
  }
  const int rows = (H + nchunks - 1) / nchunks;
  dim3 grid(nblocks, (H + rows - 1) / rows, F);
  maps_kernel<HARRIS, ORIENT><<<grid, NT, smem, (cudaStream_t)stream>>>(
      img, resp, nms, maps, H, W, rows, pitch, k, make_taps(taps_h, taps_o));
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points (loaded with ctypes). Every tensor is float32,
// contiguous, on device `device`: img (F, H, W) in, F <= 65535; resp, nms
// (F, H, W) and maps (F, 8, H, W) out. taps_h / taps_o: 5 host floats
// each (the Gaussian taps of the structure tensor and of the orientation
// blur). Each launches on `stream` and returns the launch's cudaError_t
// (0 on success).

// B1: both phases.
extern "C" int slam_detect_maps(const float* img, float* resp, float* nms,
                                float* maps, int F, int H, int W, float k,
                                const float* taps_h, const float* taps_o,
                                int device, void* stream) {
  return launch<true, true>(img, resp, nms, maps, F, H, W, k, taps_h, taps_o,
                            device, stream);
}

// B4: the Harris phase (resp, nms).
extern "C" int slam_harris_response(const float* img, float* resp, float* nms,
                                    int F, int H, int W, float k,
                                    const float* taps_h, int device,
                                    void* stream) {
  return launch<true, false>(img, resp, nms, nullptr, F, H, W, k, taps_h,
                             nullptr, device, stream);
}

// B3: the orientation phase (maps).
extern "C" int slam_orientation_maps(const float* img, float* maps, int F,
                                     int H, int W, const float* taps_o,
                                     int device, void* stream) {
  return launch<false, true>(img, nullptr, nullptr, maps, F, H, W, 0.f,
                             nullptr, taps_o, device, stream);
}
