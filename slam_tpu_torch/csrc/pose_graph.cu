// Kernel B9: the dense pose graph's Levenberg-Marquardt system and step
// (ops/pose_graph.py: optimize and the covariances' _covariance_full).
//
// B9 replaces no TPU kernel. The JAX package linearizes the pose graph
// with jax.jacfwd and assembles the normal equations in plain jnp
// (slam_tpu/ops/pose_graph.py), and so does the port's plain version
// (ops/pose_graph.py: _edge_res_jac, forward-mode derivatives over 12
// copies of every edge, _assemble, _precondition), which launches ~670
// small torch kernels an LM iteration. The work is a few hundred kFLOP
// an iteration; launches bound it, and B9 is three of them.
//
// Nodes X (T_w2c, float32 4x4), edge e = (i, j) with Zinv = Z^-1, the
// 6x6 sqrt-information S and the weight w (0 on padded edges):
//   xi  = log(Zinv Xj Xi^-1)  (twist [w, v], se3.se3_log's branches:
//         the small-angle, near-pi and Taylor ones, at its float32
//         thresholds)
//   r   = w S xi,  J = w S Jr^-1(xi) Ad(Xi)  (d r / d right perturbation
//         of Xj; that of Xi is -J)
//   P_e = J^T J,  q_e = J^T r,  c_e = r . r
// Jr^-1 of SE(3) in [w, v] order is [[A, 0], [-A Q A, A]], with A = I +
// W/2 + k W^2 (k of se3_log's V^-1) and Q Barfoot's Q(-v, -w) (its three
// coefficients by Taylor series below theta^2 = 1e-3). Per node n:
//   H_nn = sum_e P_e over the edges touching n (twice for a self edge)
//   H_nm = -sum_e P_e over the edges joining n and m
//   g_n  = sum_e q_e over the edges whose second node is n
//          - sum_e q_e over the edges whose first node is n
// then _precondition's masks and Jacobi scaling: Hm = H m m^T +
// diag(1 - m), d = 1 / sqrt(max(diag Hm, 1e-12)), and the LM system
//   A = Hm (d d^T) + lam I,  rhs = d g m,  cost = c / 2 (sum over edges),
// with lam read from device memory. The step retracts every node by
// -(d x), x the solution of A x = rhs, evaluates the trial cost and
// applies optimize's accept rule (finite and below cost (1 - 1e-3)):
// nodes, cost and lam are written in place.
//
// Design. Every per-edge quantity is computed in float64 from the float32
// state, and every sum is taken in one fixed order (edge index order, or
// a fixed tree over a block), with no atomics: runs repeat bit for bit,
// as _assemble's docstring requires of the plain version. Three kernels,
// all on the caller's stream and allocating nothing, so that a CUDA graph
// captures them and an LM iteration makes no host read:
//   1. pg_nodes_kernel, one block per node: the block scans the edges in
//      chunks of NT, compacts the ones touching its node (ballots, index
//      order kept), linearizes each (one thread an edge) and sums the
//      node's diagonal block and gradient in float64 in index order. It
//      writes the rounded diagonal block, d and rhs; the block of an
//      edge's first node also writes its P_e and c_e for kernel 2.
//   2. pg_rows_kernel, one block per block-row, and one more for the
//      cost: it numbers the node's neighbours in the order their first
//      edge appears, sums each off-diagonal block from the P_e of the
//      edges joining the pair in index order, and writes its six rows of
//      A whole (every entry once; zeros outside the neighbours' blocks),
//      exactly symmetric (each entry scaled by the product d_a d_b). The
//      extra block sums the c_e in kernel 3's order.
//   3. pg_step_kernel, one block: the retraction into a scratch copy of
//      the nodes, the trial cost over the edges, the accept rule, and the
//      accepted nodes copied back.
// PERF.md section 6 has the times.

#include <cuda_runtime.h>
#include <math.h>

#include "launch.cuh"

namespace {

constexpr int NT = 128;     // threads of a node block and a row block
constexpr int STEP_T = NT;  // threads of the step's block (the cost's tree)
constexpr int MAX_NB = 64;  // neighbours' off-diagonal blocks summed a round
constexpr int MAX_N = 16384;  // nodes: kernel 2 holds two ints a node
constexpr unsigned FULL = 0xffffffffu;

// se3.py's float32 constants, as the float32 values its comparisons use
constexpr double kEps = (double)1e-8f;          // _EPS
constexpr double kEps2 = (double)1e-16f;        // _EPS * _EPS
constexpr double kSmall2 = (double)1e-3f;       // _SMALL_THETA2
constexpr double kSmallAngle = (double)1e-5f;   // so3_log's theta < 1e-5
constexpr double kNearPi = (double)(-1.0f + 1e-6f);  // cos_t < -1 + 1e-6

// index of (a, b) in the upper triangle of a symmetric 6x6, row by row
__host__ __device__ constexpr int tri(int a, int b) {
  return a <= b ? a * 6 - (a * (a - 1)) / 2 + (b - a)
                : b * 6 - (b * (b - 1)) / 2 + (a - b);
}

__device__ __forceinline__ void hat(const double* v, double* H) {
  H[0] = 0.0;   H[1] = -v[2]; H[2] = v[1];
  H[3] = v[2];  H[4] = 0.0;   H[5] = -v[0];
  H[6] = -v[1]; H[7] = v[0];  H[8] = 0.0;
}

// C = A B, 3x3 row-major
__device__ __forceinline__ void mm3(const double* A, const double* B,
                                    double* C) {
#pragma unroll
  for (int a = 0; a < 3; ++a)
#pragma unroll
    for (int b = 0; b < 3; ++b)
      C[3 * a + b] = A[3 * a] * B[b] + A[3 * a + 1] * B[3 + b] +
                     A[3 * a + 2] * B[6 + b];
}

__device__ __forceinline__ void load_rt(const float* T, double* R,
                                        double* t) {
#pragma unroll
  for (int q = 0; q < 3; ++q) {
#pragma unroll
    for (int c = 0; c < 3; ++c) R[3 * q + c] = T[4 * q + c];
    t[q] = T[4 * q + 3];
  }
}

// (R, t) of Zinv (Xj Xi^-1), ops/pose_graph.py's order of products
__device__ void edge_transform(const float* Xi, const float* Xj,
                               const float* Zi, double* R, double* t) {
  double Ri[9], ti[3], Rj[9], tj[3], Rz[9], tz[3], MR[9], Mt[3];
  load_rt(Xi, Ri, ti);
  load_rt(Xj, Rj, tj);
  load_rt(Zi, Rz, tz);
#pragma unroll
  for (int a = 0; a < 3; ++a)
#pragma unroll
    for (int b = 0; b < 3; ++b)
      MR[3 * a + b] = Rj[3 * a] * Ri[3 * b] + Rj[3 * a + 1] * Ri[3 * b + 1] +
                      Rj[3 * a + 2] * Ri[3 * b + 2];
#pragma unroll
  for (int a = 0; a < 3; ++a)
    Mt[a] = tj[a] - (MR[3 * a] * ti[0] + MR[3 * a + 1] * ti[1] +
                     MR[3 * a + 2] * ti[2]);
  mm3(Rz, MR, R);
#pragma unroll
  for (int a = 0; a < 3; ++a)
    t[a] = Rz[3 * a] * Mt[0] + Rz[3 * a + 1] * Mt[1] + Rz[3 * a + 2] * Mt[2] +
           tz[a];
}

// se3.se3_log of (R, t): the twist xi = [w, v], and the coefficient k of
// V^-1 = I - W/2 + k W^2 with theta^2 = |w|^2 (the Jacobian reuses both)
__device__ void se3_log(const double* R, const double* t, double* xi,
                        double* k_out, double* theta2_out) {
  const double cos_t = fmin(fmax((R[0] + R[4] + R[8] - 1.0) * 0.5, -1.0), 1.0);
  const double theta = acos(cos_t);
  const double anti[3] = {R[7] - R[5], R[2] - R[6], R[3] - R[1]};
  double w[3];
  if (theta < kSmallAngle) {
#pragma unroll
    for (int q = 0; q < 3; ++q) w[q] = anti[q] * 0.5;
  } else if (cos_t < kNearPi) {
    // the axis from the largest diagonal entry of R + I (the first of
    // equal ones, as torch.argmax)
    const double d[3] = {R[0] + 1.0, R[4] + 1.0, R[8] + 1.0};
    int k = 0;
    if (d[1] > d[k]) k = 1;
    if (d[2] > d[k]) k = 2;
    const double col[3] = {R[k] + (k == 0), R[3 + k] + (k == 1),
                           R[6 + k] + (k == 2)};
    const double n =
        sqrt(col[0] * col[0] + col[1] * col[1] + col[2] * col[2]) + kEps;
#pragma unroll
    for (int q = 0; q < 3; ++q) w[q] = col[q] / n * theta;
  } else {
    const double s = sin(theta);
    const double f = 0.5 * theta / (fabs(s) < kEps ? 1.0 : s);
#pragma unroll
    for (int q = 0; q < 3; ++q) w[q] = anti[q] * f;
  }
  const double th2 = w[0] * w[0] + w[1] * w[1] + w[2] * w[2];
  double k;
  if (th2 < kSmall2) {
    k = 1.0 / 12.0 + th2 / 720.0;
  } else {
    const double th = sqrt(th2 + kEps2);
    const double sh = sin(0.5 * th);
    k = (1.0 - 0.5 * th * cos(0.5 * th) / (fabs(sh) < kEps ? 1.0 : sh)) / th2;
  }
  double W[9], W2[9], Vi[9];
  hat(w, W);
  mm3(W, W, W2);
#pragma unroll
  for (int q = 0; q < 9; ++q)
    Vi[q] = (q % 4 == 0 ? 1.0 : 0.0) - 0.5 * W[q] + k * W2[q];
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    xi[q] = w[q];
    xi[3 + q] = Vi[3 * q] * t[0] + Vi[3 * q + 1] * t[1] + Vi[3 * q + 2] * t[2];
  }
  *k_out = k;
  *theta2_out = th2;
}

// r = w S xi; returns r . r. Kernel 1 and the step both call it.
__device__ __forceinline__ double residual(const float* S, float w,
                                           const double* xi, double* r) {
  double c = 0.0;
#pragma unroll
  for (int a = 0; a < 6; ++a) {
    double s = 0.0;
#pragma unroll
    for (int q = 0; q < 6; ++q) s += (double)S[6 * a + q] * xi[q];
    r[a] = (double)w * s;
    c += r[a] * r[a];
  }
  return c;
}

// c_e of edge e at the nodes X
__device__ double edge_cost(const float* X, long long i, long long j,
                            const float* Zi, const float* S, float w) {
  double R[9], t[3], xi[6], r[6], k, th2;
  edge_transform(X + 16 * i, X + 16 * j, Zi, R, t);
  se3_log(R, t, xi, &k, &th2);
  return residual(S, w, xi, r);
}

// J = w S Jr^-1(xi) Ad(Xi), 6x6 row-major
__device__ void edge_jacobian(const float* Xi, const float* S, float w,
                              const double* xi, double k, double th2,
                              double* J) {
  double c1, c2, c3;
  if (th2 < kSmall2) {
    c1 = 1.0 / 6.0 - th2 / 120.0 + th2 * th2 / 5040.0;
    c2 = 1.0 / 24.0 - th2 / 720.0 + th2 * th2 / 40320.0;
    c3 = 1.0 / 120.0 - th2 / 2520.0 + th2 * th2 / 120960.0;
  } else {
    const double th = sqrt(th2), s = sin(th), c = cos(th);
    c1 = (th - s) / (th2 * th);
    c2 = (th2 + 2.0 * c - 2.0) / (2.0 * th2 * th2);
    c3 = (2.0 * th - 3.0 * s + th * c) / (2.0 * th2 * th2 * th);
  }
  double W[9], W2[9], A[9];
  hat(xi, W);
  mm3(W, W, W2);
#pragma unroll
  for (int q = 0; q < 9; ++q)
    A[q] = (q % 4 == 0 ? 1.0 : 0.0) + 0.5 * W[q] + k * W2[q];
  // Q(-v, -w): Ph = hat(-w) = -W, Uh = hat(-v)
  const double mv[3] = {-xi[3], -xi[4], -xi[5]};
  double Ph[9], Uh[9], PU[9], UP[9], PUP[9], PPU[9], UPP[9], PUPP[9],
      PPUP[9], Q[9];
#pragma unroll
  for (int q = 0; q < 9; ++q) Ph[q] = -W[q];
  hat(mv, Uh);
  mm3(Ph, Uh, PU);
  mm3(Uh, Ph, UP);
  mm3(PU, Ph, PUP);
  mm3(Ph, PU, PPU);
  mm3(UP, Ph, UPP);
  mm3(PUP, Ph, PUPP);
  mm3(Ph, PUP, PPUP);
#pragma unroll
  for (int q = 0; q < 9; ++q)
    Q[q] = 0.5 * Uh[q] + c1 * (PU[q] + UP[q] + PUP[q]) +
           c2 * (PPU[q] + UPP[q] - 3.0 * PUP[q]) + c3 * (PUPP[q] + PPUP[q]);
  // B = -A Q A; Ad(Xi) = [[R, 0], [hat(t) R, R]]
  double AQ[9], B[9], Ri[9], ti[3], Th[9], TR[9], AR[9], BR[9], ATR[9];
  mm3(A, Q, AQ);
  mm3(AQ, A, B);
  load_rt(Xi, Ri, ti);
  hat(ti, Th);
  mm3(Th, Ri, TR);
  mm3(A, Ri, AR);
  mm3(B, Ri, BR);
  mm3(A, TR, ATR);
  // M = Jr^-1 Ad = [[AR, 0], [ATR - BR, AR]] (B's sign folded in here)
  double L[9];
#pragma unroll
  for (int q = 0; q < 9; ++q) L[q] = ATR[q] - BR[q];
#pragma unroll
  for (int a = 0; a < 6; ++a) {
    const float* s = S + 6 * a;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const double left = s[0] * AR[c] + s[1] * AR[3 + c] + s[2] * AR[6 + c] +
                          s[3] * L[c] + s[4] * L[3 + c] + s[5] * L[6 + c];
      const double right = s[3] * AR[c] + s[4] * AR[3 + c] + s[5] * AR[6 + c];
      J[6 * a + c] = (double)w * left;
      J[6 * a + 3 + c] = (double)w * right;
    }
  }
}

// se3.retract(T, delta) = T se3_exp(delta), in float64, rounded
__device__ void retract(const float* T, const float* delta, float* out) {
  double w[3] = {delta[0], delta[1], delta[2]};
  double v[3] = {delta[3], delta[4], delta[5]};
  const double th2 = w[0] * w[0] + w[1] * w[1] + w[2] * w[2];
  const double th = sqrt(th2 + kEps2);
  double a, b, c;
  if (th2 < kSmall2) {
    a = 1.0 - th2 / 6.0;
    b = 0.5 - th2 / 24.0;
    c = 1.0 / 6.0 - th2 / 120.0;
  } else {
    const double s = sin(th), sh = sin(0.5 * th);
    a = s / th;
    b = 2.0 * sh * sh / th2;
    c = (th - s) / (th2 * th);
  }
  double W[9], W2[9], Re[9], V[9], te[3], R0[9], t0[3];
  hat(w, W);
  mm3(W, W, W2);
#pragma unroll
  for (int q = 0; q < 9; ++q) {
    const double eye = q % 4 == 0 ? 1.0 : 0.0;
    Re[q] = eye + a * W[q] + b * W2[q];
    V[q] = eye + b * W[q] + c * W2[q];
  }
#pragma unroll
  for (int q = 0; q < 3; ++q)
    te[q] = V[3 * q] * v[0] + V[3 * q + 1] * v[1] + V[3 * q + 2] * v[2];
  load_rt(T, R0, t0);
#pragma unroll
  for (int q = 0; q < 3; ++q) {
#pragma unroll
    for (int col = 0; col < 3; ++col)
      out[4 * q + col] =
          (float)(R0[3 * q] * Re[col] + R0[3 * q + 1] * Re[3 + col] +
                  R0[3 * q + 2] * Re[6 + col]);
    out[4 * q + 3] = (float)(R0[3 * q] * te[0] + R0[3 * q + 1] * te[1] +
                             R0[3 * q + 2] * te[2] + t0[q]);
  }
  out[12] = 0.f;
  out[13] = 0.f;
  out[14] = 0.f;
  out[15] = 1.f;
}

// Each flagged thread's position among the block's flagged threads in
// thread order, and their count. Ends with a barrier; the caller puts one
// between the positions' use and the next call.
__device__ __forceinline__ int compact(bool flag, int* warp_counts,
                                       int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned bal = __ballot_sync(FULL, flag);
  if (lane == 0) warp_counts[warp] = __popc(bal);
  __syncthreads();
  int off = 0, n = 0;
  for (int q = 0; q < NT / 32; ++q) {
    const int c = warp_counts[q];
    off += q < warp ? c : 0;
    n += c;
  }
  *total = n;
  return off + __popc(bal & ((1u << lane) - 1u));
}

// the sum of v over the block's NT threads: a fixed tree (sh holds NT)
__device__ double block_sum(double v, double* sh) {
  sh[threadIdx.x] = v;
  __syncthreads();
#pragma unroll
  for (int s = NT / 2; s > 0; s >>= 1) {
    if ((int)threadIdx.x < s) sh[threadIdx.x] += sh[threadIdx.x + s];
    __syncthreads();
  }
  return sh[0];
}

// the edges' cost terms, each thread's in index order, then the tree
__device__ double cost_sum(const double* ce, int E, double* sh) {
  double v = 0.0;
  for (int e = threadIdx.x; e < E; e += NT) v += ce[e];
  return block_sum(v, sh);
}

__global__ void __launch_bounds__(NT) pg_nodes_kernel(
    const float* __restrict__ nodes, const long long* __restrict__ ei,
    const long long* __restrict__ ej, const float* __restrict__ Zinv,
    const float* __restrict__ S, const float* __restrict__ wE,
    const float* __restrict__ mask, int E, double* __restrict__ Pe,
    double* __restrict__ ce, float* __restrict__ diag,
    float* __restrict__ dscale, float* __restrict__ rhs) {
  const int i = blockIdx.x;
  const int tid = threadIdx.x;
  __shared__ double terms[NT][27];  // P (upper triangle), q
  __shared__ int role[NT];          // bit 0: the edge's first node, 1: second
  __shared__ int warp_counts[NT / 32];
  __shared__ float hd[6], gd[6];
  // thread t < 36 sums H_ii[t / 6][t % 6], 36 <= t < 42 g_i[t - 36]
  double acc = 0.0;
  for (int base = 0; base < E; base += NT) {
    const int e = base + tid;
    int ro = 0;
    if (e < E) ro = (ei[e] == i ? 1 : 0) | (ej[e] == i ? 2 : 0);
    int n;
    const int pos = compact(ro != 0, warp_counts, &n);
    if (ro != 0) {
      // the incident edge's linearization, one thread an edge
      double R[9], t[3], xi[6], r[6], k, th2, J[36];
      edge_transform(nodes + 16 * ei[e], nodes + 16 * ej[e], Zinv + 16 * e, R,
                     t);
      se3_log(R, t, xi, &k, &th2);
      const double c = residual(S + 36 * e, wE[e], xi, r);
      edge_jacobian(nodes + 16 * ei[e], S + 36 * e, wE[e], xi, k, th2, J);
      double* out = terms[pos];
#pragma unroll
      for (int a = 0; a < 6; ++a) {
#pragma unroll
        for (int b = a; b < 6; ++b) {
          double p = 0.0;
#pragma unroll
          for (int q = 0; q < 6; ++q) p += J[6 * q + a] * J[6 * q + b];
          out[tri(a, b)] = p;
        }
        double g = 0.0;
#pragma unroll
        for (int q = 0; q < 6; ++q) g += J[6 * q + a] * r[q];
        out[21 + a] = g;
      }
      role[pos] = ro;
      if (ro & 1) {  // the edge's first node writes its terms for kernel 2
#pragma unroll
        for (int q = 0; q < 21; ++q) Pe[(size_t)e * 21 + q] = out[q];
        ce[e] = c;
      }
    }
    __syncthreads();
    if (tid < 36) {
      const int x = tri(tid / 6, tid % 6);
      for (int m = 0; m < n; ++m) {
        acc += terms[m][x];
        if (role[m] == 3) acc += terms[m][x];
      }
    } else if (tid < 42) {
      for (int m = 0; m < n; ++m) {
        if (role[m] & 2) acc += terms[m][21 + tid - 36];
        if (role[m] & 1) acc -= terms[m][21 + tid - 36];
      }
    }
    __syncthreads();
  }
  if (tid < 36) {
    const float h = (float)acc;
    diag[(size_t)i * 36 + tid] = h;
    if (tid % 7 == 0) hd[tid / 7] = h;
  } else if (tid < 42) {
    gd[tid - 36] = (float)acc;
  }
  __syncthreads();
  if (tid < 6) {
    const float m = mask[6 * i + tid];
    const float h = hd[tid] * m * m + (1.0f - m);
    const float d = 1.0f / sqrtf(fmaxf(h, 1e-12f));
    dscale[6 * i + tid] = d;
    rhs[6 * i + tid] = d * gd[tid] * m;
  }
}

__global__ void __launch_bounds__(NT) pg_rows_kernel(
    const long long* __restrict__ ei, const long long* __restrict__ ej,
    const float* __restrict__ mask, const float* __restrict__ lam,
    const double* __restrict__ Pe, const double* __restrict__ ce,
    const float* __restrict__ diag, const float* __restrict__ dscale, int N,
    int E, float* __restrict__ A, float* __restrict__ cost) {
  __shared__ double sh[NT];
  if ((int)blockIdx.x == N) {  // the cost block
    const double c = cost_sum(ce, E, sh);
    if (threadIdx.x == 0) *cost = (float)(0.5 * c);
    return;
  }
  extern __shared__ int smem[];
  int* slot = smem;        // N: a node's neighbour number, or -1
  int* nb_node = smem + N;  // N: the node of each neighbour number
  __shared__ double acc[MAX_NB * 36];
  __shared__ int other[NT], edge[NT], warp_counts[NT / 32];
  __shared__ int n_nb;
  const int i = blockIdx.x;
  const int tid = threadIdx.x;
  const size_t row_len = 6 * (size_t)N;
  for (int j = tid; j < N; j += NT) slot[j] = -1;
  if (tid == 0) n_nb = 0;
  __syncthreads();
  // the neighbours, numbered in the order their first edge appears
  for (int base = 0; base < E; base += NT) {
    const int e = base + tid;
    bool off = false;
    long long o = 0;
    if (e < E) {
      const long long a = ei[e], b = ej[e];
      off = (a == i) != (b == i);
      o = a == i ? b : a;
    }
    int n;
    const int pos = compact(off, warp_counts, &n);
    if (off) other[pos] = (int)o;
    __syncthreads();
    if (tid == 0) {
      for (int m = 0; m < n; ++m)
        if (slot[other[m]] < 0) {
          slot[other[m]] = n_nb;
          nb_node[n_nb++] = other[m];
        }
    }
    __syncthreads();
  }
  const int K = n_nb;
  const float lam_v = *lam;
  // the off-diagonal blocks, MAX_NB neighbours a round; thread (grp, x)
  // owns entry x of the neighbours numbered grp mod GR
  constexpr int GR = NT / 36;
  const int x = tid % 36, grp = tid / 36;
  for (int r0 = 0; r0 < K; r0 += MAX_NB) {
    for (int q = tid; q < MAX_NB * 36; q += NT) acc[q] = 0.0;
    __syncthreads();
    for (int base = 0; base < E; base += NT) {
      const int e = base + tid;
      bool off = false;
      long long o = 0;
      if (e < E) {
        const long long a = ei[e], b = ej[e];
        off = (a == i) != (b == i);
        o = a == i ? b : a;
      }
      int n;
      const int pos = compact(off, warp_counts, &n);
      if (off) {
        other[pos] = (int)o;
        edge[pos] = e;
      }
      __syncthreads();
      if (grp < GR) {
        const int xt = tri(x / 6, x % 6);
        for (int m = 0; m < n; ++m) {
          const int s = slot[other[m]] - r0;
          if (s >= 0 && s < MAX_NB && s % GR == grp)
            acc[s * 36 + x] -= Pe[(size_t)edge[m] * 21 + xt];
        }
      }
      __syncthreads();
    }
    const int kr = min(MAX_NB, K - r0);
    for (int q = tid; q < kr * 36; q += NT) {
      const int s = q / 36, a = (q % 36) / 6, b = q % 6;
      const int j = nb_node[r0 + s];
      const float h = (float)acc[q] * mask[6 * i + a] * mask[6 * j + b];
      A[(6 * (size_t)i + a) * row_len + 6 * (size_t)j + b] =
          h * (dscale[6 * i + a] * dscale[6 * j + b]);
    }
    __syncthreads();
  }
  // the diagonal block and the zeros, every other entry of the six rows
  for (int a = 0; a < 6; ++a) {
    float* row = A + (6 * (size_t)i + a) * row_len;
    for (int col = tid; col < 6 * N; col += NT) {
      const int j = col / 6, b = col % 6;
      float v = 0.0f;
      if (j == i) {
        const float ma = mask[6 * i + a], mb = mask[6 * i + b];
        const float h = diag[(size_t)i * 36 + 6 * a + b] * ma * mb +
                        (a == b ? 1.0f - ma : 0.0f);
        v = h * (dscale[6 * i + a] * dscale[6 * i + b]) +
            (a == b ? lam_v : 0.0f);
      } else if (slot[j] >= 0) {
        continue;
      }
      row[col] = v;
    }
  }
}

__global__ void __launch_bounds__(STEP_T) pg_step_kernel(
    float* __restrict__ nodes, const float* __restrict__ x,
    const float* __restrict__ dscale, float* __restrict__ cost,
    float* __restrict__ lam, const long long* __restrict__ ei,
    const long long* __restrict__ ej, const float* __restrict__ Zinv,
    const float* __restrict__ S, const float* __restrict__ wE, int N, int E,
    float* __restrict__ trial, double* __restrict__ ce) {
  __shared__ double sh[NT];
  __shared__ int ok_s;
  const int tid = threadIdx.x;
  for (int n = tid; n < N; n += NT) {
    float delta[6];
#pragma unroll
    for (int q = 0; q < 6; ++q) delta[q] = -(dscale[6 * n + q] * x[6 * n + q]);
    retract(nodes + 16 * n, delta, trial + 16 * n);
  }
  __syncthreads();
  for (int e = tid; e < E; e += NT)
    ce[e] = edge_cost(trial, ei[e], ej[e], Zinv + 16 * e, S + 36 * e, wE[e]);
  __syncthreads();
  const double c = cost_sum(ce, E, sh);
  if (tid == 0) {
    const float new_cost = (float)(0.5 * c);
    const float old = *cost, l = *lam;
    const bool ok = isfinite(new_cost) && new_cost < old * (float)(1.0 - 1e-3);
    *cost = ok ? new_cost : old;
    *lam = ok ? fmaxf(l / 3.0f, 1e-9f) : fminf(l * 5.0f, 1e4f);
    ok_s = ok;
  }
  __syncthreads();
  if (ok_s)
    for (int q = tid; q < 16 * N; q += NT) nodes[q] = trial[q];
}

bool sizes_ok(int N, int E) {
  return N > 0 && N <= MAX_N && E >= 0 && E <= 0x7fffffff / 36;
}

}  // namespace

// The most nodes B9 takes (kernel 2 holds two ints a node in shared
// memory).
extern "C" int slam_pg_max_nodes() { return MAX_N; }

// Plain C entry point (loaded with ctypes). In, all contiguous on device
// `device`: nodes (N, 4, 4), Zinv (E, 4, 4), S (E, 6, 6), wE (E,), mask
// (6N,) float32, ei, ej (E,) int64, lam (1,) float32. Out: A (6N, 6N),
// rhs, dscale (6N,), cost (1,) float32; scratch: diag (N, 36) float32,
// Pe (E, 21), ce (E,) float64. Launches kernels 1 and 2 on `stream`;
// returns the launches' cudaError_t (0 on success).
extern "C" int slam_pg_system(const float* nodes, const long long* ei,
                              const long long* ej, const float* Zinv,
                              const float* S, const float* wE,
                              const float* mask, const float* lam, int N,
                              int E, float* A, float* rhs, float* dscale,
                              float* cost, float* diag, double* Pe,
                              double* ce, int device, void* stream) {
  if (!sizes_ok(N, E)) return (int)cudaErrorInvalidValue;
  const slam::DeviceScope scope(device);
  cudaError_t err = scope.error();
  if (err != cudaSuccess) return (int)err;
  static slam::SmemOnce smem;
  err = smem(pg_rows_kernel, device, 2 * MAX_N * sizeof(int));
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  pg_nodes_kernel<<<N, NT, 0, s>>>(nodes, ei, ej, Zinv, S, wE, mask, E, Pe,
                                   ce, diag, dscale, rhs);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  pg_rows_kernel<<<N + 1, NT, 2 * N * sizeof(int), s>>>(
      ei, ej, mask, lam, Pe, ce, diag, dscale, N, E, A, cost);
  return (int)cudaGetLastError();
}

// The step: nodes (N, 4, 4), cost (1,) and lam (1,) float32 updated in
// place from x and dscale (6N,) float32 and the edges as above; scratch:
// trial (N, 4, 4) float32, ce (E,) float64. One launch on `stream`.
extern "C" int slam_pg_step(float* nodes, const float* x, const float* dscale,
                            float* cost, float* lam, const long long* ei,
                            const long long* ej, const float* Zinv,
                            const float* S, const float* wE, int N, int E,
                            float* trial, double* ce, int device,
                            void* stream) {
  if (!sizes_ok(N, E)) return (int)cudaErrorInvalidValue;
  const slam::DeviceScope scope(device);
  const cudaError_t err = scope.error();
  if (err != cudaSuccess) return (int)err;
  pg_step_kernel<<<1, STEP_T, 0, (cudaStream_t)stream>>>(
      nodes, x, dscale, cost, lam, ei, ej, Zinv, S, wE, N, E, trial, ce);
  return (int)cudaGetLastError();
}
