// Kernel B7: the reduced pose system of bundle adjustment, linearized at
// the windows' state and built from each window's observations.
//
// B7 replaces no TPU kernel. The JAX package builds this system in plain
// jnp (its "scatter" engine, slam_tpu/ops/ba.py), and so does the port's
// plain version (ops/ba.py: _linearize, _build_blocks, _damped_system,
// _back_substitute), which scatters every observation's terms into a
// dense (B, L, P) slot array, sums the slots and multiplies (6P x 3L)
// matrices that are mostly zero blocks. That step, 41 times per window
// batch, was the largest block of device time in every benchmark cell
// (PERF.md section 5); B7 does the same arithmetic on the observations
// alone.
//
// Per window b, with observation m (pose row p, landmark row l; a pair is
// observed at most once), slot[b, l, p] = m, or -1 where no observation
// of nonzero weight joins the pair. Kernel 1 linearizes each observation
// as _linearize does (its weighted residual r (3) and Jacobians Jp (3x6),
// Jl (3x3), Huber-reweighted when asked), then
//   Hll_l  = sum_p Jl^T Jl          g_l = sum_p Jl^T r
//   W_pl   = Jp^T Jl (6x3)          Hinv_l = inv3x3(Hll_l + lam I + eps_l I)
//   S_ij   = delta_ij (sum_l Jp^T Jp + lam I) - sum_l W_il Hinv_l W_jl^T
//   ghat_i = sum_l Jp^T r - sum_l W_il Hinv_l g_l
// (lam, one per window, only where given: the LM's damped system; the
// covariances' system passes none), then the gauge (pose 0's rows and
// columns times zero, its diagonal one, ghat's six rows times zero) and
// eps_s added to S's diagonal. inv3x3 is the adjugate over the
// determinant, a determinant under 1e-30 in magnitude taken as 1e-30, as
// ops/ba.py:_inv3x3. The second entry point gives the landmark steps
// from the pose step dp:
//   dl_l = -Hinv_l (g_l + sum_p W_pl^T dp_p).
//
// Design. Three kernels, no atomic sums: every sum is taken in one fixed
// order that depends only on the window's own observations, so runs
// repeat bit for bit and a window's results do not depend on the batch
// it is solved in. The work is a few MFLOP a window; what bounds the
// kernels is the latency of dependent reads (a landmark's slot row, then
// the observations it names), so each design keeps those chains short
// and many of them in flight.
//   1. schur_landmarks_kernel, one warp per (window, landmark): lane q
//      reads pose rows q and q + 32 of the slot row, and for each
//      observation its pose, measurement and weight; it linearizes, writes
//      the observation's Jp, r (for kernel 2) and W (18 floats, read by
//      kernels 2 and 3; lanes no slot names are left unwritten) and adds
//      its Hll and g_l terms, which a butterfly of shuffles sums over the
//      lanes (every lane gets the same bits); lane 0 inverts in registers
//      and writes Hinv and g_l.
//   2. schur_poses_kernel, one CTA per (pose row i, window b): thread
//      (jj, a) owns row a of S's block (i, i + jj), six sums over the
//      landmarks in ascending order. The CTA scans the landmarks in rounds
//      of PT, compacts those pose i observes (ballots), and stages them KS
//      at a time in dynamic shared memory with cp.async, in two rounds of
//      reads: the slot rows, Hinv_l, g_l and (l, i)'s Jp, r and W; then
//      W_jl of every other pose j > i that observes l (a warp a
//      landmark, a lane a pose), while V = W_il Hinv_l and a bit mask per
//      pose row of the staged landmarks it observes (shared-memory ORs)
//      are formed. Each thread adds V_il[a] . W_jl[c] for the landmarks
//      its pose j observes, walking its mask (so the lanes of a warp,
//      several j, each do useful work); 6 DR more threads sum the
//      diagonal block's Jp^T Jp, Jp^T r and V g, each row over DR
//      interleaved subsets, added in one fixed order at the end.
//      Only blocks j >= i are summed: each is written with its transpose
//      (the diagonal block from its upper triangle), so S is exactly
//      symmetric, as B6 and the covariances' LU read it.
//   3. schur_back_kernel, one warp per (window, landmark), as kernel 1:
//      the landmark step from dp.
// PERF.md section 6 has the bound and the times. Nothing is allocated
// here: the caller passes every output and scratch array, and all three
// kernels launch on the caller's stream, so a CUDA graph captures them.

#include <cuda_runtime.h>
#include <math.h>

#include "launch.cuh"

namespace {

constexpr int MAX_P = 36;  // pose rows: 6 x 36 = 216 <= B6's largest N
constexpr int PT = 256;    // threads of a pose-row CTA (>= 6 x MAX_P)
constexpr int KS = 32;     // landmarks staged at once by a pose-row CTA
constexpr int LW = 4;      // warps per CTA of the per-landmark kernels
constexpr int DR = 6;      // threads summing each row of the diagonal terms
constexpr unsigned FULL = 0xffffffffu;

static_assert(6 * MAX_P + 6 * DR <= PT,
              "a pose-row CTA holds a thread per S row and the diagonal's");
static_assert(KS == 32, "a staged landmark is a bit of a 32-bit mask");
static_assert(MAX_P <= 64, "a warp holds two pose rows a lane");

// shared memory of a pose-row CTA for windows of P pose rows, in 4-byte
// words: W of the staged landmarks' observing poses (KS x P x 18), their
// slots (KS x P), V, Jp (KS x 18 each), Hinv (KS x 9), r and g (KS x 3
// each), this round's landmarks and their lanes (PT each), a count per
// warp, per pose row the staged landmarks it observes (MAX_P bit masks),
// and the diagonal block's partial sums (DR x 6 x 8)
__host__ __device__ constexpr int pose_smem_words(int P) {
  return KS * P * 18 + KS * P + KS * (18 + 18 + 9 + 3 + 3) + 2 * PT +
         PT / 32 + MAX_P + DR * 48;
}

// 4 bytes global -> shared, asynchronously (cp.async.wait_all waits)
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}

// 8 bytes global -> shared, asynchronously (both addresses 8-byte aligned)
__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// sum over the warp's lanes, every lane left with the same bits: at each
// step lanes x and x ^ s add the same two values
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int s = 16; s >= 1; s >>= 1) v += __shfl_xor_sync(FULL, v, s);
  return v;
}

// Hinv = inv3x3 of the symmetric (h00 h01 h02; . h11 h12; . . h22), the
// adjugate over the determinant (ops/ba.py:_inv3x3's order of terms)
__device__ __forceinline__ void inv3x3_sym(float a, float b, float c,
                                           float e, float f, float i,
                                           float* out) {
  const float d = b, g = c, h = f;
  const float co00 = e * i - f * h, co01 = c * h - b * i,
              co02 = b * f - c * e;
  const float co10 = f * g - d * i, co11 = a * i - c * g,
              co12 = c * d - a * f;
  const float co20 = d * h - e * g, co21 = b * g - a * h,
              co22 = a * e - b * d;
  const float det = a * co00 + b * co10 + c * co20;
  const float inv_det = 1.0f / (fabsf(det) < 1e-30f ? 1e-30f : det);
  out[0] = co00 * inv_det;
  out[1] = co01 * inv_det;
  out[2] = co02 * inv_det;
  out[3] = co10 * inv_det;
  out[4] = co11 * inv_det;
  out[5] = co12 * inv_det;
  out[6] = co20 * inv_det;
  out[7] = co21 * inv_det;
  out[8] = co22 * inv_det;
}

// One observation's weighted residual and Jacobians, ops/ba.py's
// _linearize: the camera-frame point Xc = R X + t of landmark X from pose
// T (4x4, row-major), its stereo projection (ops/stereo.py: project, the
// depth's inverse with |z| < 1e-9 taken as 1e-9), r = (project - meas) w,
// with huber > 0 reweighted by sqrt(huber / max(|r|, huber)); J_lm = JR w
// and J_pose = [-JR hat(X) | JR] w, with JR = (d project / d Xc) R.
__device__ __forceinline__ void linearize(const float* T, const float* X,
                                          const float* z, float w,
                                          const float* calib, float huber,
                                          float* jp, float* jl, float* e) {
  const float fx = calib[0], fy = calib[1], cx = calib[2], cy = calib[3],
              bl = calib[4];
  float xc[3];
#pragma unroll
  for (int q = 0; q < 3; ++q)
    xc[q] = T[4 * q] * X[0] + T[4 * q + 1] * X[1] + T[4 * q + 2] * X[2] +
            T[4 * q + 3];
  const float iz = 1.0f / (fabsf(xc[2]) < 1e-9f ? 1e-9f : xc[2]);
  e[0] = (fx * xc[0] * iz + cx - z[0]) * w;
  e[1] = (fx * (xc[0] - bl) * iz + cx - z[1]) * w;
  e[2] = (fy * xc[1] * iz + cy - z[2]) * w;
  float we = w;
  if (huber > 0.f) {
    const float nrm = sqrtf(e[0] * e[0] + e[1] * e[1] + e[2] * e[2]);
    const float hw = sqrtf(huber / fmaxf(nrm, huber));
#pragma unroll
    for (int q = 0; q < 3; ++q) e[q] *= hw;
    we = w * hw;
  }
  const float iz2 = iz * iz;
  const float jproj[9] = {fx * iz, 0.f, -fx * xc[0] * iz2,
                          fx * iz, 0.f, -fx * (xc[0] - bl) * iz2,
                          0.f,     fy * iz, -fy * xc[1] * iz2};
  float jr[9];
#pragma unroll
  for (int q = 0; q < 3; ++q)
#pragma unroll
    for (int c = 0; c < 3; ++c)
      jr[q * 3 + c] = jproj[q * 3] * T[c] + jproj[q * 3 + 1] * T[4 + c] +
                      jproj[q * 3 + 2] * T[8 + c];
  // hat(X) = (0 -X2 X1; X2 0 -X0; -X1 X0 0)
  const float hx[9] = {0.f, -X[2], X[1], X[2], 0.f, -X[0], -X[1], X[0], 0.f};
#pragma unroll
  for (int q = 0; q < 3; ++q)
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float rot = -(jr[q * 3] * hx[c] + jr[q * 3 + 1] * hx[3 + c] +
                          jr[q * 3 + 2] * hx[6 + c]);
      jp[q * 6 + c] = rot * we;
      jp[q * 6 + 3 + c] = jr[q * 3 + c] * we;
      jl[q * 3 + c] = jr[q * 3 + c] * we;
    }
}

// 1. Per observation its residual and Jacobians (Jp and r written for
// kernel 2, and W); per landmark Hll, g_l, Hinv. One warp per (window,
// landmark): lane q holds pose rows q and q + 32, their terms added in
// that order, then summed over the lanes by warp_sum.
__global__ void __launch_bounds__(32 * LW) schur_landmarks_kernel(
    const float* __restrict__ poses, const float* __restrict__ points,
    const float* __restrict__ meas, const float* __restrict__ w,
    const float* __restrict__ calib, float huber,
    const int* __restrict__ slot, const float* __restrict__ lam, float eps_l,
    int B, int L, int P, int M, float* __restrict__ Jp,
    float* __restrict__ r, float* __restrict__ Hinv, float* __restrict__ gl,
    float* __restrict__ W) {
  const int t = blockIdx.x * LW + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (t >= B * L) return;  // the whole warp
  const int b = t / L;
  const int* row = slot + (size_t)t * P;
  const size_t obs0 = (size_t)b * M;
  const float X[3] = {points[(size_t)t * 3], points[(size_t)t * 3 + 1],
                      points[(size_t)t * 3 + 2]};
  float h[9] = {};  // Hll 00 01 02 11 12 22, then g
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const int p = lane + 32 * q;
    const int m = p < P ? row[p] : -1;
    if (m < 0) continue;
    const size_t o = obs0 + m;
    float jp[18], j[9], e[3];
    linearize(poses + ((size_t)b * P + p) * 16, X, meas + o * 3, w[o],
              calib, huber, jp, j, e);
    // Jp's and W's rows start on 8-byte boundaries
    float2* Jp2 = reinterpret_cast<float2*>(Jp + o * 18);
#pragma unroll
    for (int x = 0; x < 9; ++x) Jp2[x] = make_float2(jp[2 * x], jp[2 * x + 1]);
#pragma unroll
    for (int x = 0; x < 3; ++x) r[o * 3 + x] = e[x];
    // each observation's terms summed over its 3 rows, then added
    h[0] += j[0] * j[0] + j[3] * j[3] + j[6] * j[6];
    h[1] += j[0] * j[1] + j[3] * j[4] + j[6] * j[7];
    h[2] += j[0] * j[2] + j[3] * j[5] + j[6] * j[8];
    h[3] += j[1] * j[1] + j[4] * j[4] + j[7] * j[7];
    h[4] += j[1] * j[2] + j[4] * j[5] + j[7] * j[8];
    h[5] += j[2] * j[2] + j[5] * j[5] + j[8] * j[8];
#pragma unroll
    for (int c = 0; c < 3; ++c)
      h[6 + c] += j[c] * e[0] + j[3 + c] * e[1] + j[6 + c] * e[2];
    float wm[18];
#pragma unroll
    for (int a = 0; a < 6; ++a)
#pragma unroll
      for (int c = 0; c < 3; ++c)
        wm[a * 3 + c] = jp[a] * j[c] + jp[6 + a] * j[3 + c] +
                        jp[12 + a] * j[6 + c];
    float2* W2 = reinterpret_cast<float2*>(W + o * 18);
#pragma unroll
    for (int x = 0; x < 9; ++x) W2[x] = make_float2(wm[2 * x], wm[2 * x + 1]);
  }
#pragma unroll
  for (int x = 0; x < 9; ++x) h[x] = warp_sum(h[x]);
  float d0 = h[0], d1 = h[3], d2 = h[5];
  if (lam != nullptr) {
    const float lb = lam[b];
    d0 += lb;
    d1 += lb;
    d2 += lb;
  }
  d0 += eps_l;
  d1 += eps_l;
  d2 += eps_l;
  if (lane == 0) {
    float hi[9];
    inv3x3_sym(d0, h[1], h[2], d1, h[4], d2, hi);
#pragma unroll
    for (int x = 0; x < 9; ++x) Hinv[(size_t)t * 9 + x] = hi[x];
#pragma unroll
    for (int x = 0; x < 3; ++x) gl[(size_t)t * 3 + x] = h[6 + x];
  }
}

// 2. S and ghat, one CTA per (pose row i, window b); dynamic shared
// memory of pose_smem_words(P) words. Rows of 18 floats (W, Jp) start on
// 8-byte boundaries in both memories, so they move in 8-byte copies.
__global__ void __launch_bounds__(PT) schur_poses_kernel(
    const float* __restrict__ Jp, const float* __restrict__ r,
    const int* __restrict__ slot, const float* __restrict__ Hinv,
    const float* __restrict__ gl, const float* __restrict__ W,
    const float* __restrict__ lam, float eps_s, int L, int P, int M,
    float* __restrict__ S, float* __restrict__ ghat) {
  constexpr int NW = PT / 32;
  extern __shared__ float smem[];
  float* s_w = smem;                        // [KS][P][18]: W_{i + jj, l}
  int* s_slot = (int*)(s_w + KS * P * 18);  // [KS][P]: slot[b, l, i + jj]
  float* s_v = (float*)(s_slot + KS * P);   // [KS][18]: W_il Hinv_l
  float* s_jp = s_v + KS * 18;              // [KS][18]: Jp of (l, i)
  float* s_hinv = s_jp + KS * 18;           // [KS][9]
  float* s_r = s_hinv + KS * 9;             // [KS][3]
  float* s_g = s_r + KS * 3;                // [KS][3]
  int* s_list = (int*)(s_g + KS * 3);       // [PT]: landmarks pose i sees
  int* s_mi = s_list + PT;                  // [PT]: their lanes
  int* s_count = s_mi + PT;                 // [NW]: per warp
  unsigned* s_mask = (unsigned*)(s_count + NW);  // [MAX_P]
  float* s_diag = (float*)(s_mask + MAX_P);  // [DR][6][8]: Hpp row, gp, vg

  const int i = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const unsigned below = (1u << lane) - 1u;  // the lanes before this one
  const int nj = P - i;  // pose blocks j = i .. P - 1
  const int jj = tid / 6, a = tid - 6 * jj;
  const bool active = jj < nj;
  // threads 6 MAX_P .. + 6 DR - 1 sum the diagonal block's own terms:
  // row ad, the staged landmarks k = dr mod DR
  const int dt = tid - 6 * MAX_P, ad = dt / DR, dr = dt - DR * ad;
  const bool diag = dt >= 0 && dt < 6 * DR;
  const int* slot_b = slot + (size_t)b * L * P;
  const size_t obs0 = (size_t)b * M;
  const size_t lm0 = (size_t)b * L;
  float u[6] = {};    // sum_l V_il[a] . W_{i + jj, l}[c]
  float hpp[6] = {};  // diag: sum_l (Jp^T Jp)[ad][c], l = dr mod DR
  float gp = 0.f, vg = 0.f;

  for (int base = 0; base < L; base += PT) {
    // the landmarks of this round that pose i observes, ascending
    const int l = base + tid;
    const int mi = l < L ? slot_b[(size_t)l * P + i] : -1;
    const unsigned mask = __ballot_sync(FULL, mi >= 0);
    if (lane == 0) s_count[warp] = __popc(mask);
    __syncthreads();
    int before = 0, n = 0;
#pragma unroll
    for (int q = 0; q < NW; ++q) {
      before += q < warp ? s_count[q] : 0;
      n += s_count[q];
    }
    if (mi >= 0) {
      const int k = before + __popc(mask & below);
      s_list[k] = l;
      s_mi[k] = mi;
    }
    __syncthreads();
    for (int k0 = 0; k0 < n; k0 += KS) {
      const int kn = min(KS, n - k0);
      for (int j = tid; j < nj; j += PT)
        s_mask[j] = j == 0 ? (kn == 32 ? FULL : (1u << kn) - 1u) : 0u;
      // a warp a landmark: the slots of poses i.., the landmark's Hinv
      // and g, and (l, i)'s Jp, r and W, all at once
      for (int k = warp; k < kn; k += NW) {
        const int lk = s_list[k0 + k];
        const size_t lm = lm0 + lk, m = obs0 + s_mi[k0 + k];
        for (int j = lane; j < nj; j += 32)
          cp_async4(s_slot + k * P + j, slot_b + (size_t)lk * P + i + j);
        if (lane < 9)
          cp_async8(s_jp + k * 18 + 2 * lane, Jp + m * 18 + 2 * lane);
        else if (lane < 18)
          cp_async8(s_w + k * P * 18 + 2 * (lane - 9),
                    W + m * 18 + 2 * (lane - 9));
        else if (lane < 27)
          cp_async4(s_hinv + k * 9 + lane - 18, Hinv + lm * 9 + lane - 18);
        else if (lane < 30)
          cp_async4(s_g + k * 3 + lane - 27, gl + lm * 3 + lane - 27);
        if (lane < 3) cp_async4(s_r + k * 3 + lane, r + m * 3 + lane);
      }
      cp_async_wait_all();
      __syncthreads();
      // a warp a landmark: W of every other observing pose j > i (lane
      // j), the bit of the landmark in pose row j's mask, and V = W_il
      // Hinv_l while those are in flight
      for (int k = warp; k < kn; k += NW) {
        for (int j = 1 + lane; j < nj; j += 32) {
          const int m = s_slot[k * P + j];
          if (m < 0) continue;
          atomicOr(s_mask + j, 1u << k);
          float* dst = s_w + (k * P + j) * 18;
          const float* src = W + (obs0 + m) * 18;
#pragma unroll
          for (int x = 0; x < 9; ++x) cp_async8(dst + 2 * x, src + 2 * x);
        }
        if (lane < 18) {
          const int ra = lane / 3, c = lane - 3 * ra;
          const float* w = s_w + k * P * 18 + ra * 3;
          const float* hi = s_hinv + k * 9;
          s_v[k * 18 + lane] = w[0] * hi[c] + w[1] * hi[3 + c] +
                               w[2] * hi[6 + c];
        }
      }
      cp_async_wait_all();
      __syncthreads();
      if (active) {
        // only the landmarks pose i + jj observes, ascending (the lanes of
        // a warp, several jj, each take their own next one)
        for (unsigned mk = s_mask[jj]; mk != 0u; mk &= mk - 1u) {
          const int k = __ffs(mk) - 1;
          const float* v = s_v + k * 18 + a * 3;
          const float v0 = v[0], v1 = v[1], v2 = v[2];
          const float2* w2 =
              reinterpret_cast<const float2*>(s_w + (k * P + jj) * 18);
          float w[18];
#pragma unroll
          for (int x = 0; x < 9; ++x) {
            const float2 t = w2[x];
            w[2 * x] = t.x;
            w[2 * x + 1] = t.y;
          }
#pragma unroll
          for (int c = 0; c < 6; ++c)
            u[c] += v0 * w[c * 3] + v1 * w[c * 3 + 1] + v2 * w[c * 3 + 2];
        }
      } else if (diag) {
        for (int k = dr; k < kn; k += DR) {
          const float* J = s_jp + k * 18;
          const float* e = s_r + k * 3;
          const float* g = s_g + k * 3;
          const float* v = s_v + k * 18 + ad * 3;
#pragma unroll
          for (int c = 0; c < 6; ++c)
            hpp[c] += J[ad] * J[c] + J[6 + ad] * J[6 + c] +
                      J[12 + ad] * J[12 + c];
          gp += J[ad] * e[0] + J[6 + ad] * e[1] + J[12 + ad] * e[2];
          vg += v[0] * g[0] + v[1] * g[1] + v[2] * g[2];
        }
      }
      __syncthreads();
    }
    __syncthreads();  // s_count and s_list are rewritten next round
  }
  if (diag) {
    float* d = s_diag + (dr * 6 + ad) * 8;
#pragma unroll
    for (int c = 0; c < 6; ++c) d[c] = hpp[c];
    d[6] = gp;
    d[7] = vg;
  }
  __syncthreads();
  if (!active) return;
  const int N = 6 * P, j = i + jj, row = 6 * i + a;
  float* Sb = S + (size_t)b * N * N;
  // the partial sums in one fixed order
  float dsum[8];
#pragma unroll
  for (int x = 0; x < 8; ++x) {
    dsum[x] = s_diag[a * 8 + x];
#pragma unroll
    for (int q = 1; q < DR; ++q) dsum[x] += s_diag[(q * 6 + a) * 8 + x];
  }

#pragma unroll
  for (int c = 0; c < 6; ++c) {
    if (jj == 0 && c < a) continue;  // the diagonal block's upper triangle
    const int col = 6 * j + c;
    float v;
    if (jj == 0) {
      float hd = dsum[c];
      if (c == a && lam != nullptr) hd += lam[b];
      v = hd - u[c];
    } else {
      v = 0.f - u[c];
    }
    if (i == 0) v = v * 0.f + (row == col ? 1.f : 0.f);  // the gauge
    if (row == col && eps_s != 0.f) v += eps_s;
    Sb[(size_t)row * N + col] = v;
    Sb[(size_t)col * N + row] = v;
  }
  if (jj == 0) {
    float gh = dsum[6] - dsum[7];
    if (i == 0) gh *= 0.f;
    ghat[(size_t)b * N + row] = gh;
  }
}

// 3. dl_l = -Hinv_l (g_l + sum_p W_pl^T dp_p), one warp per (window,
// landmark) as in kernel 1
__global__ void __launch_bounds__(32 * LW) schur_back_kernel(
    const int* __restrict__ slot, const float* __restrict__ W,
    const float* __restrict__ Hinv, const float* __restrict__ gl,
    const float* __restrict__ dp, int B, int L, int P, int M,
    float* __restrict__ dl) {
  const int t = blockIdx.x * LW + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (t >= B * L) return;  // the whole warp
  const int b = t / L;
  const int* row = slot + (size_t)t * P;
  const size_t obs0 = (size_t)b * M;
  const float* d = dp + (size_t)b * 6 * P;
  float s[3] = {};
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const int p = lane + 32 * q;
    const int m = p < P ? row[p] : -1;
    if (m < 0) continue;
    const float* w = W + (obs0 + m) * 18;
    const float* dpp = d + 6 * p;
#pragma unroll
    for (int x = 0; x < 3; ++x) {
      float tx = w[x] * dpp[0];
#pragma unroll
      for (int q2 = 1; q2 < 6; ++q2) tx += w[q2 * 3 + x] * dpp[q2];
      s[x] += tx;
    }
  }
#pragma unroll
  for (int x = 0; x < 3; ++x) s[x] = warp_sum(s[x]);
  if (lane == 0) {
    float v[3];
#pragma unroll
    for (int x = 0; x < 3; ++x) v[x] = gl[(size_t)t * 3 + x] + s[x];
    const float* H = Hinv + (size_t)t * 9;
#pragma unroll
    for (int c = 0; c < 3; ++c)
      dl[(size_t)t * 3 + c] =
          -(H[c * 3] * v[0] + H[c * 3 + 1] * v[1] + H[c * 3 + 2] * v[2]);
  }
}

bool sizes_ok(int B, int L, int P, int M) {
  return B > 0 && B <= 65535 && L > 0 && M > 0 && P > 0 && P <= MAX_P &&
         (long long)B * L <= 0x7fffffffLL;
}

int landmark_blocks(int B, int L) { return (B * L + LW - 1) / LW; }

}  // namespace

// The most pose rows one window may have (a pose-row CTA holds a thread
// for each row of its block row).
extern "C" int slam_schur_max_poses() { return MAX_P; }

// Plain C entry point (loaded with ctypes). In, all contiguous float32 /
// int32 on device `device`: the windows' state poses (B, P, 4, 4), points
// (B, L, 3), meas (B, M, 3), w (B, M), calib (5,) (fx, fy, cx, cy,
// baseline), huber (0: none), slot (B, L, P), lam (B,) or null. Out: Jp
// (B, M, 3, 6), r (B, M, 3), W (B, M, 6, 3) (the lanes no slot names are
// not written), Hinv (B, L, 3, 3), gl (B, L, 3), S (B, 6P, 6P), ghat
// (B, 6P). Launches two kernels on `stream`; returns the launches'
// cudaError_t (0 on success).
extern "C" int slam_schur_reduce(const float* poses, const float* points,
                                 const float* meas, const float* w,
                                 const float* calib, float huber,
                                 const int* slot, const float* lam,
                                 float eps_l, float eps_s, int B, int L,
                                 int P, int M, float* Jp, float* r,
                                 float* W, float* Hinv, float* gl, float* S,
                                 float* ghat, int device, void* stream) {
  if (!sizes_ok(B, L, P, M)) return (int)cudaErrorInvalidValue;
  const slam::DeviceScope scope(device);
  cudaError_t err = scope.error();
  if (err != cudaSuccess) return (int)err;
  static slam::SmemOnce smem;
  err = smem(schur_poses_kernel, device,
             pose_smem_words(MAX_P) * sizeof(float));
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  schur_landmarks_kernel<<<landmark_blocks(B, L), 32 * LW, 0, s>>>(
      poses, points, meas, w, calib, huber, slot, lam, eps_l, B, L, P, M, Jp,
      r, Hinv, gl, W);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  schur_poses_kernel<<<dim3(P, B), PT, pose_smem_words(P) * sizeof(float),
                       s>>>(Jp, r, slot, Hinv, gl, W, lam, eps_s, L, P, M,
                            S, ghat);
  return (int)cudaGetLastError();
}

// The landmark steps: slot, W, Hinv and gl as slam_schur_reduce left them,
// dp (B, 6P) in, dl (B, L, 3) out. One launch on `stream`.
extern "C" int slam_schur_back(const int* slot, const float* W,
                               const float* Hinv, const float* gl,
                               const float* dp, int B, int L, int P, int M,
                               float* dl, int device, void* stream) {
  if (!sizes_ok(B, L, P, M)) return (int)cudaErrorInvalidValue;
  const slam::DeviceScope scope(device);
  cudaError_t err = scope.error();
  if (err != cudaSuccess) return (int)err;
  schur_back_kernel<<<landmark_blocks(B, L), 32 * LW, 0,
                      (cudaStream_t)stream>>>(slot, W, Hinv, gl, dp, B, L, P,
                                              M, dl);
  return (int)cudaGetLastError();
}
