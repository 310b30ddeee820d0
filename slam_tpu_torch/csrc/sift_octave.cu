// Kernel B8: one octave of the SIFT (difference-of-Gaussians) scale space.
//
// Replaces no TPU kernel: the JAX package computes its SIFT scale space
// in plain jnp (slam_tpu/ops/sift.py), and the port's first version ran
// it as ~200 torch ops an octave (ops/sift.py: gaussian_pyramid_octave,
// _octave_response, features.nms and the scale parabola), whose
// intermediates went through device memory. From one octave's base image
// (level 0, the octave's sigma0 image) and the host's float32 taps of the
// intervals + 2 incremental blurs, per pixel of every image of the batch:
//   resp  the largest |DoG| over intervals 1..intervals that is a 3x3x3
//         extremum (non-strict: >= the 3x3 max of its own level and both
//         neighbours, or <= the min), above the contrast and passing
//         Lowe's edge test (det > 0 and tr^2 < thr det on the DoG's
//         Hessian); 0 where none passes;
//   nms   resp where it is the max of its 5x5 window (-inf outside the
//         image), -inf elsewhere;
//   s     the continuous interval ii + di: ii the winning interval (the
//         first on ties, 0 where none), di the parabola through the DoGs
//         at ii - 1, ii, ii + 1 (clamped to the ladder, 0 where the
//         curvature is within 1e-12), clipped to +-0.5;
//   next  (every octave but the last) level `intervals` at even rows and
//         columns: the next octave's base, (ceil(H/2), ceil(W/2)).
// Each blur is a horizontal pass, then a vertical pass, each tap sum a
// chain of fused multiply-adds in tap order, in float32, every sample
// outside the image read as 0 at the input of each 1-D pass (XLA SAME,
// features._conv2d_same). The gates round as the plain version's separate
// torch ops do (no contraction). One difference from the plain version:
// its window maxima read -inf outside the image and its edge test wraps
// there (torch.roll); here the DoG outside the image reads 0 in both.
// That changes the response only on the image's outer 1-pixel frame and
// the NMS map within 3 pixels of the edge; nothing downstream reads those
// pixels (select_keypoints keeps keypoints at least 4 pixels inside, and
// its subpixel fit and the scale gather read pixels at least 3 inside).
//
// What bounds it on the H100. By bytes, device memory: the base read once,
// resp, nms and s written and a quarter plane for the next base, ~2.70 GB
// per frontend chunk of 64 images over SIFT's five octaves (752x2482 down
// to 47x156), 0.81 ms at 3.35 TB/s; by operations the blurs' 134
// multiply-adds a pixel (radii 4, 5, 6, 7, 9) and 5 subtractions, 0.65 ms
// at 67 TFLOP/s. The intermediates (six Gaussian levels, five DoGs, the
// masks) dwarf both, so no level touches device memory; in practice the
// schedulers' rate and shared-memory traffic bound it.
//
// Design: a block of 384 threads (256 at 5 intervals) owns as many
// adjacent image columns, of which all but the halo on each side (3 + the
// sum of the radii, 34 columns at 3 intervals) are its output columns,
// and marches down the image one row per iteration, a thread per column
// (a line buffer: the vertical halo is paid once per column strip, not
// once per tile). A thread keeps each blur's vertical window (2 r + 1
// horizontally blurred rows of its column) in registers. In an iteration
// every level j reads the row of level j that the block wrote into a line
// of shared memory the iteration before, sums its 2 r + 1 horizontal taps,
// pushes the sum into its window and sums the window's vertical taps: a
// new row of level j + 1, which it writes into the next line. So level
// j + 1 lags level j by r + 1 rows, the levels' sums of one iteration do
// not depend on each other, and one barrier per iteration orders it all
// (the lines are kept twice, by the iteration's parity). A thread keeps
// the rows of levels 1..intervals + 1 its column still needs for the DoGs
// in rings of shared memory of its own (the top level lags level j by the
// rest of the radii and of the levels), reads level 0 again from device
// memory, and forms the DoGs of the top level's newest row. The 3x3x3
// extremum and the edge test read the neighbours' DoGs of the row before
// from shared memory (the DoGs' 3x3 windows stay in registers), one row
// behind; the 5x5 NMS reads the responses of the row before, three rows
// behind. A warp none of whose pixels passes the contrast gate skips the
// extremum, and one none of whose pixels passes the contrast and the
// extremum at an interval skips its edge test. The main loop is unrolled
// by 3 rows: the windows move by 3 rows once per pass (2 r + 3 registers
// each), and the 3-row windows are addressed by the row's phase, so no
// row's values are moved between registers. The taps are kernel
// parameters that the multiply-adds read from the constant bank. The
// ladder (radii and length) is a template parameter, one instantiation
// for each of cv2's ladders at sigma0 1.6 and 2 to 5 intervals; the taps
// come from the host. Tried and dropped, at the first octave: 2-D tiles
// of 64 rows, each recomputing the vertical halo (1.8x slower); per
// level, a horizontal and a vertical pass over a band of 8 rows of a
// 64-column strip with 12 barriers a band (3.9x slower).
//
// Registers and shared memory, from nvcc -Xptxas -v for sm_90a (no
// spills): printed by chip_smoke.py's build log (PERF.md section 6).

#include <cuda_runtime.h>
#include <math.h>

#include <type_traits>

#include "launch.cuh"

namespace {

constexpr int OUT_HALO = 3;   // extremum and edge test 1, NMS 2
constexpr int LPAD = 16;      // a line's cells before and after, >= a radius
constexpr int MAX_NB = 7;     // blurs: intervals + 2, intervals 2..5
constexpr int MAX_TAPS = 2 * 14 + 1;
constexpr int MAX_SMEM = 232448;  // shared memory a block can use
constexpr unsigned FULL = 0xffffffffu;

// cv2's ladder at sigma0 1.6 (ops/sift.py's blur_ladder): the radius of
// blur j at `intervals` I.
__host__ __device__ constexpr int radius(int I, int j) {
  return I == 2   ? (j == 0 ? 5 : j == 1 ? 7 : j == 2 ? 10 : 14)
         : I == 3 ? (j == 0 ? 4 : j == 1 ? 5 : j == 2 ? 6 : j == 3 ? 7 : 9)
         : I == 4 ? (j == 0 ? 3 : j <= 2 ? 4 : j == 3 ? 5 : j == 4 ? 6 : 7)
                  : (j <= 1 ? 3 : j <= 3 ? 4 : j <= 5 ? 5 : 6);
}

// rows level j lags level 0 by in the blurs' windows
__host__ __device__ constexpr int lag(int I, int j) {
  int s = 0;
  for (int m = 0; m < j; ++m) s += radius(I, m);
  return s;
}

__host__ __device__ constexpr int nthreads(int I) { return I >= 5 ? 256 : 384; }

// the rows of level j (1..I + 1) a thread keeps for the DoGs: from the
// iteration that makes a row to the one that makes the top level's
__host__ __device__ constexpr int depth(int I, int j) {
  return (lag(I, I + 2) - lag(I, j)) + (I + 2 - j) + 1;
}

// rows an unrolled pass of the main loop takes: the windows move by U
// rows at its end, and the 3-row windows of the extremum and the NMS are
// addressed by the row's phase in it
constexpr int U = 3;

// offset of blur j's vertical window (2 r + U rows) in a thread's
// registers
__host__ __device__ constexpr int woff(int I, int j) {
  int s = 0;
  for (int m = 0; m < j; ++m) s += 2 * radius(I, m) + U;
  return s;
}

// shared memory, in floats: the lines of levels 0..I + 1 (two each), the
// rings of levels 1..I + 1, the DoG lines (two), the response lines (two)
__host__ __device__ constexpr int line_pitch(int I) {
  return nthreads(I) + 2 * LPAD;
}
__host__ __device__ constexpr int ring_off(int I, int j) {
  int s = 2 * (I + 2) * line_pitch(I);
  for (int m = 1; m < j; ++m) s += depth(I, m) * nthreads(I);
  return s;
}
__host__ __device__ constexpr int dog_pitch(int I) { return nthreads(I) + 2; }
__host__ __device__ constexpr int dog_off(int I) { return ring_off(I, I + 2); }
__host__ __device__ constexpr int resp_pitch(int I) { return nthreads(I) + 4; }
__host__ __device__ constexpr int resp_off(int I) {
  return dog_off(I) + 2 * (I + 2) * dog_pitch(I);
}
__host__ __device__ constexpr int smem_floats(int I) {
  return resp_off(I) + 2 * resp_pitch(I);
}

struct Taps {
  float t[MAX_NB][MAX_TAPS];  // blur j's 2 r + 1 taps
};

// The blurs of one iteration, level J on: blur J's horizontal taps over
// the line of level J that the last iteration wrote (row ys + i - 1 -
// lag - J), pushed into its window at row P of the unrolled pass, and the
// window's vertical taps: level J + 1 at row ys + i - lag(J + 1) - (J + 1),
// 0 outside the image, into lv[J + 1] and, below the top level, this
// iteration's line of level J + 1. The window moves by U rows after the
// pass's last row.
template <int I, int J, int P>
__device__ __forceinline__ void blur_levels(float* sm, float* win,
                                            const Taps& tp, int cur, int prv,
                                            int tid, int i, int ys, int H,
                                            bool col_in, float* lv) {
  if constexpr (J < I + 2) {
    constexpr int R = radius(I, J);
    constexpr int OFF = woff(I, J) + P;
    constexpr int LP = line_pitch(I);
    const float* ln = sm + (2 * J + prv) * LP + LPAD + tid - R;
    float h = tp.t[J][0] * ln[0];
#pragma unroll
    for (int k = 1; k <= 2 * R; ++k) h = fmaf(tp.t[J][k], ln[k], h);
    win[OFF + 2 * R] = h;
    float v = tp.t[J][0] * win[OFF];
#pragma unroll
    for (int k = 1; k <= 2 * R; ++k) v = fmaf(tp.t[J][k], win[OFF + k], v);
    if constexpr (P == U - 1) {
#pragma unroll
      for (int k = 0; k < 2 * R; ++k)
        win[woff(I, J) + k] = win[woff(I, J) + k + U];
    }
    const int y = ys + i - lag(I, J + 1) - (J + 1);
    v = col_in && y >= 0 && y < H ? v : 0.f;
    lv[J + 1] = v;
    if constexpr (J + 1 < I + 2) sm[(2 * (J + 1) + cur) * LP + LPAD + tid] = v;
    blur_levels<I, J + 1, P>(sm, win, tp, cur, prv, tid, i, ys, H, col_in,
                             lv);
  }
}

// Levels J..I + 1 at the DoG's row, each from its own ring: the row made
// depth - 1 iterations ago lies in the slot after this iteration's,
// slot[J] (i mod depth), which takes this iteration's level J.
template <int I, int J>
__device__ __forceinline__ void ring_levels(float* sm, int tid, int* slot,
                                            const float* lv, float* G) {
  if constexpr (J < I + 2) {
    constexpr int D = depth(I, J);
    float* ring = sm + ring_off(I, J) + tid;
    const int w = slot[J], r = w + 1 == D ? 0 : w + 1;
    G[J] = ring[r * nthreads(I)];
    ring[w * nthreads(I)] = lv[J];
    slot[J] = r;
    ring_levels<I, J + 1>(sm, tid, slot, lv, G);
  }
}

template <int I>
__global__ void __launch_bounds__(nthreads(I), 1)
sift_octave_kernel(const float* __restrict__ base, float* __restrict__ resp,
                   float* __restrict__ nms, float* __restrict__ sout,
                   float* __restrict__ next, int H, int W, float contrast,
                   float edge_thr, const __grid_constant__ Taps tp) {
  constexpr int NB = I + 2;            // blurs; DoGs 0..NB - 1
  constexpr int NT = nthreads(I);
  constexpr int L = lag(I, NB);
  constexpr int HALO = OUT_HALO + L;
  constexpr int OUT = NT - 2 * HALO;   // output columns of a block
  constexpr int DP = dog_pitch(I), RP = resp_pitch(I);
  static_assert(OUT > 0 && OUT % 2 == 0, "blocks start on even columns");
  extern __shared__ __align__(16) float sm[];
  const int tid = threadIdx.x;
  const int f = blockIdx.z;
  const int x0 = blockIdx.x * OUT;
  const int x = x0 - HALO + tid;
  const size_t plane = (size_t)H * W;
  const float* img = base + f * plane;
  const bool col_in = x >= 0 && x < W;
  const bool out_col = tid >= HALO && tid < HALO + OUT && x < W;
  for (int k = tid; k < smem_floats(I); k += NT) sm[k] = 0.f;
  __syncthreads();  // zeros

  auto base_at = [&](int y) {
    return col_in && y >= 0 && y < H ? __ldg(img + (size_t)y * W + x) : 0.f;
  };
  // level 0's row at iteration i is ys + i; the top level's (and the
  // DoGs') ys + i - L - NB; the extremum's 2 rows above it, the NMS's 5
  const int ys = -OUT_HALO - L;
  const int iters = H + 2 * L + NB + 8;
  float win[woff(I, NB)];
#pragma unroll
  for (int k = 0; k < woff(I, NB); ++k) win[k] = 0.f;
  // the DoGs of this column at the extremum's rows e - 1, e, e + 1, and
  // the middle DoGs' neighbours there (x - 1, x + 1); the outer DoGs' 3-
  // column maxima and minima; level `intervals` at rows e - 1, e, e + 1;
  // the response at rows m, m + 1, m + 2 and the 5-column maxima of the
  // responses at rows m - 2 .. m + 1 (m the NMS's row); each ring's slot
  // for this iteration
  float own[NB][3], nb[NB][3][2], rmx[2][3], rmn[2][3], gi[3], rh[3], rm5[4];
#pragma unroll
  for (int k = 0; k < NB; ++k) {
#pragma unroll
    for (int r = 0; r < 3; ++r) own[k][r] = nb[k][r][0] = nb[k][r][1] = 0.f;
  }
#pragma unroll
  for (int r = 0; r < 3; ++r)
    rmx[0][r] = rmx[1][r] = rmn[0][r] = rmn[1][r] = 0.f;
  gi[0] = gi[1] = gi[2] = 0.f;
  rh[0] = rh[1] = rh[2] = -INFINITY;
#pragma unroll
  for (int r = 0; r < 4; ++r) rm5[r] = -INFINITY;
  float g0n = base_at(ys), z0n = base_at(ys - L - NB);
  int slot[NB];
#pragma unroll
  for (int j = 0; j < NB; ++j) slot[j] = 0;

  // one row: iteration i, the P-th of its unrolled pass (i mod U == P).
  // The 3-row windows hold the row made at iteration i' in slot i' mod 3:
  // the extremum's rows e - 1, e, e + 1 (made at i - 3, i - 2, i - 1) in
  // slots P, P + 1, P + 2 (mod 3), and this row's values go into slot P
  auto row = [&](const int i, auto phase) {
    constexpr int P = decltype(phase)::value;
    const int cur = i & 1, prv = cur ^ 1;
    const float g0 = g0n, z0 = z0n;
    g0n = base_at(ys + i + 1);
    z0n = base_at(ys + i + 1 - L - NB);
    sm[cur * line_pitch(I) + LPAD + tid] = g0;
    float lv[NB + 1];
    blur_levels<I, 0, P>(sm, win, tp, cur, prv, tid, i, ys, H, col_in, lv);

    // the DoGs of the top level's new row t, this column
    const int t = ys + i - L - NB;
    float G[NB + 1];
    G[0] = z0;
    ring_levels<I, 1>(sm, tid, slot, lv, G);
    G[NB] = lv[NB];
    float* dl_cur = sm + dog_off(I) + cur * NB * DP + 1 + tid;
    const float* dl_prv = sm + dog_off(I) + prv * NB * DP + 1 + tid;
    float dnew[NB];
#pragma unroll
    for (int k = 0; k < NB; ++k) {
      dnew[k] = G[k + 1] - G[k];
      dl_cur[k * DP] = dnew[k];
    }

    // the extremum's row e = t - 2: its row below, t - 1, from the
    // neighbours' DoG lines of the last iteration
#pragma unroll
    for (int k = 0; k < NB; ++k) {
      const float l = dl_prv[k * DP - 1], r = dl_prv[k * DP + 1];
      if (k == 0 || k == NB - 1) {
        const int o = k == 0 ? 0 : 1;
        rmx[o][(P + 2) % 3] = fmaxf(fmaxf(l, own[k][(P + 2) % 3]), r);
        rmn[o][(P + 2) % 3] = fminf(fminf(l, own[k][(P + 2) % 3]), r);
      } else {
        nb[k][(P + 2) % 3][0] = l;
        nb[k][(P + 2) % 3][1] = r;
      }
    }
    // the contrast gate first: a warp none of whose pixels passes it at
    // any interval has no response and skips the other gates
    bool cand = false;
#pragma unroll
    for (int ii = 1; ii < NB - 1; ++ii)
      cand |= fabsf(own[ii][(P + 1) % 3]) > contrast;
    float best_r = -INFINITY;
    int best = 0;
    if (__any_sync(FULL, cand)) {
      float mx[NB], mn[NB];
#pragma unroll
      for (int k = 0; k < NB; ++k) {
        if (k == 0 || k == NB - 1) {
          const int o = k == 0 ? 0 : 1;
          mx[k] = fmaxf(fmaxf(rmx[o][0], rmx[o][1]), rmx[o][2]);
          mn[k] = fminf(fminf(rmn[o][0], rmn[o][1]), rmn[o][2]);
        } else {
          float a = own[k][0], b = own[k][0];
#pragma unroll
          for (int r = 0; r < 3; ++r) {
            a = fmaxf(fmaxf(a, own[k][r]), fmaxf(nb[k][r][0], nb[k][r][1]));
            b = fminf(fminf(b, own[k][r]), fminf(nb[k][r][0], nb[k][r][1]));
          }
          mx[k] = a;
          mn[k] = b;
        }
      }
#pragma unroll
      for (int ii = 1; ii < NB - 1; ++ii) {
        // the DoG's 3x3 window: rows e - 1, e, e + 1; columns x - 1, x,
        // x + 1
        auto d = [&](int r, int c) {
          return c == 1 ? own[ii][(P + r) % 3] : nb[ii][(P + r) % 3][c >> 1];
        };
        const float dc = d(1, 1);
        const float ad = fabsf(dc);
        bool pass = ad > contrast &&
                    (dc >= fmaxf(fmaxf(mx[ii - 1], mx[ii]), mx[ii + 1]) ||
                     dc <= fminf(fminf(mn[ii - 1], mn[ii]), mn[ii + 1]));
        if (!__any_sync(FULL, pass)) continue;
        // Lowe's edge test, each operation rounded as its own torch op
        const float d2 = __fmul_rn(2.f, dc);
        const float dxx = __fadd_rn(__fsub_rn(d(1, 2), d2), d(1, 0));
        const float dyy = __fadd_rn(__fsub_rn(d(2, 1), d2), d(0, 1));
        const float dxy = __fmul_rn(
            0.25f, __fsub_rn(__fsub_rn(__fadd_rn(d(2, 2), d(0, 0)), d(2, 0)),
                             d(0, 2)));
        const float tr = __fadd_rn(dxx, dyy);
        const float det = __fsub_rn(__fmul_rn(dxx, dyy), __fmul_rn(dxy, dxy));
        const bool edge =
            det > 0.f && __fmul_rn(tr, tr) < __fmul_rn(edge_thr, det);
        const float rv = pass && edge ? ad : -INFINITY;
        if (rv > best_r) best = ii;
        best_r = fmaxf(best_r, rv);
      }
    }
    const int e = t - 2;
    const float rv = best > 0 ? best_r : 0.f;
    const float rr = col_in && e >= 0 && e < H ? rv : -INFINITY;
    sm[resp_off(I) + cur * RP + 2 + tid] = rr;
    if (out_col && e >= 0 && e < H) {
      // the scale parabola at the winning interval
      const int ip = max(best - 1, 0), in = min(best + 1, NB - 1);
      float dcs = 0.f, dps = 0.f, dns = 0.f;
#pragma unroll
      for (int k = 0; k < NB; ++k) {
        const float v = own[k][(P + 1) % 3];
        if (k == best) dcs = v;
        if (k == ip) dps = v;
        if (k == in) dns = v;
      }
      const float denom = __fadd_rn(__fsub_rn(dns, __fmul_rn(2.f, dcs)), dps);
      float di = 0.f;
      if (fabsf(denom) > 1e-12f)
        di = __fdiv_rn(__fmul_rn(-0.5f, __fsub_rn(dns, dps)), denom);
      di = fminf(fmaxf(di, -0.5f), 0.5f);
      const size_t o = f * plane + (size_t)e * W + x;
      resp[o] = rv;
      sout[o] = __fadd_rn((float)best, di);
      if (next != nullptr && !(e & 1) && !(x & 1)) {
        const int Wn = (W + 1) >> 1;
        next[f * ((size_t)((H + 1) >> 1) * Wn) + (size_t)(e >> 1) * Wn +
             (x >> 1)] = gi[(P + 1) % 3];
      }
    }

    // NMS at row m = e - 3: the responses' 5-column maxima at rows m - 2
    // .. m + 2, the newest (row e - 1) from the last iteration's line, and
    // the response at m, made at iteration i - 3 (slot P)
    {
      const float* rl = sm + resp_off(I) + prv * RP + tid;
      const float rm =
          fmaxf(fmaxf(fmaxf(rl[0], rl[1]), fmaxf(rl[2], rl[3])), rl[4]);
      const int m = e - 3;
      if (out_col && m >= 0 && m < H) {
        const float mm =
            fmaxf(fmaxf(fmaxf(rm5[0], rm5[1]), fmaxf(rm5[2], rm5[3])), rm);
        nms[f * plane + (size_t)m * W + x] = rh[P] >= mm ? rh[P] : -INFINITY;
      }
      rm5[0] = rm5[1];
      rm5[1] = rm5[2];
      rm5[2] = rm5[3];
      rm5[3] = rm;
      rh[P] = rr;
    }

    // this row into slot P of the 3-row windows
#pragma unroll
    for (int k = 0; k < NB; ++k) own[k][P] = dnew[k];
    gi[P] = G[I];
    __syncthreads();  // this iteration's lines
  };
  // the passes run past the last row needed by less than U rows, whose
  // outputs no condition above lets through
  for (int i = 0; i < iters; i += U) {
    row(i, std::integral_constant<int, 0>{});
    row(i + 1, std::integral_constant<int, 1>{});
    row(i + 2, std::integral_constant<int, 2>{});
  }
}

template <int I>
cudaError_t launch(const float* base, float* resp, float* nms, float* s,
                   float* next, int F, int H, int W, float contrast,
                   float edge_thr, const Taps& tp, int device, void* stream) {
  constexpr size_t bytes = (size_t)smem_floats(I) * sizeof(float);
  static_assert(bytes <= MAX_SMEM, "one block's shared memory");
  static slam::SmemOnce smem_once;
  const cudaError_t err = smem_once(sift_octave_kernel<I>, device, bytes);
  if (err != cudaSuccess) return err;
  constexpr int OUT = nthreads(I) - 2 * (OUT_HALO + lag(I, I + 2));
  dim3 grid((W + OUT - 1) / OUT, 1, F);
  sift_octave_kernel<I><<<grid, nthreads(I), bytes, (cudaStream_t)stream>>>(
      base, resp, nms, s, next, H, W, contrast, edge_thr, tp);
  return cudaGetLastError();
}

// 2..5 intervals if nb - 2 is one and rad is its ladder, else 0
int ladder_of(int nb, const int* rad) {
  const int I = nb - 2;
  if (I < 2 || I > 5) return 0;
  for (int j = 0; j < nb; ++j) {
    if (rad[j] != radius(I, j)) return 0;
  }
  return I;
}

}  // namespace

// Plain C entry point (loaded with ctypes). base (F, H, W) float32 in;
// resp, nms, s (F, H, W) and, unless null, next (F, ceil(H/2), ceil(W/2))
// float32 out; all contiguous on device `device`; F <= 65535. nb blurs of
// radii rad, taps their 2 r + 1 float32 taps each in turn; edge_thr =
// (r + 1)^2 / r of Lowe's ratio r. Launches on `stream` and returns the
// launch's cudaError_t (0 on success); cudaErrorInvalidValue, with no
// launch, for a ladder that is not cv2's at 2 to 5 intervals.
extern "C" int slam_sift_octave(const float* base, float* resp, float* nms,
                                float* s, float* next, int F, int H, int W,
                                int nb, const int* rad, const float* taps,
                                float contrast, float edge_thr, int device,
                                void* stream) {
  const int I = ladder_of(nb, rad);
  if (F <= 0 || F > 65535 || H <= 0 || W <= 0 || I == 0)
    return (int)cudaErrorInvalidValue;
  Taps tp = {};
  for (int j = 0; j < nb; ++j) {
    for (int k = 0; k < 2 * rad[j] + 1; ++k) tp.t[j][k] = *taps++;
  }
  const slam::DeviceScope scope(device);
  if (scope.error() != cudaSuccess) return (int)scope.error();
  switch (I) {
    case 2:
      return (int)launch<2>(base, resp, nms, s, next, F, H, W, contrast,
                            edge_thr, tp, device, stream);
    case 3:
      return (int)launch<3>(base, resp, nms, s, next, F, H, W, contrast,
                            edge_thr, tp, device, stream);
    case 4:
      return (int)launch<4>(base, resp, nms, s, next, F, H, W, contrast,
                            edge_thr, tp, device, stream);
    default:
      return (int)launch<5>(base, resp, nms, s, next, F, H, W, contrast,
                            edge_thr, tp, device, stream);
  }
}
