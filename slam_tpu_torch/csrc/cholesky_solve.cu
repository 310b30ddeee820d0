// Kernel B6: batched Cholesky solve of bundle adjustment's reduced pose
// systems.
//
// Replaces the TPU kernel slam_tpu/ops/pallas_kernels.py:cholesky_solve_lanes
// (body _chol_lanes_kernel). For each system b of the batch:
//   S[b] = L L^T   right-looking Cholesky of the SPD (N, N) matrix, of
//                  which only the lower triangle is read;
//   L y = g[b]     forward substitution;
//   L^T x = y      backward substitution; x[b] is written.
// A pivot that is not positive, or not finite, fails the system: its row
// of x is all NaN and the other rows are unaffected (torch.linalg.
// cholesky_ex reports such a system in `info`, and the port's plain
// version turns that into NaN; the TPU kernel clamps the pivot to 1e-30
// and returns a finite x instead). S is read and never written.
//
// What bounds it on the H100: neither device memory nor arithmetic. At
// (64, 144, 144) it moves 5.4 MB (1.6 us at 3.35 TB/s) and does ~1.0
// MFLOP per system (67 MFLOP, 1 us at 67 TFLOP/s float32). Its floor is
// the chain of 3N dependent steps each CTA walks (N factorization steps,
// N forward, N backward), each ended by a barrier, with little work per
// step towards the end of each chain.
//
// Design (right first; the TPU kernel's lanes layout existed only for the
// TPU's 128-lane vector unit and is not carried over): one CTA of 256
// threads per system. The whole matrix lives in dynamic shared memory
// with a row stride of N + 1 (an odd stride, so walking a column hits 32
// different banks), beside four N-vectors: 85.8 KB at N = 144.
//   factorization step j: every thread reads the pivot (so a failure is
//     one uniform branch); column j below the diagonal is scaled, into
//     the matrix and into a contiguous copy c; barrier; the 8 warps update
//     the trailing lower triangle A[i][k] -= c[i] c[k], one row per warp
//     at a time with the lanes along the row; barrier. The diagonal of L
//     is kept only as its inverse, dinv.
//   substitutions, column by column: once y_j is known, every thread
//     updates its y_i -= L_ij y_j, so no step needs a reduction across
//     threads; one barrier per step.
// Left for later work: a packed triangle, several systems per CTA,
// warp-level reductions, and fusing the landmark back-substitution.

#include <cuda_runtime.h>
#include <math.h>
#include <math_constants.h>

namespace {

constexpr int NT = 256;           // threads per CTA (8 warps)
constexpr int WARPS = NT / 32;
constexpr int MAX_SMEM = 232448;  // shared memory a block can use

// the matrix at row stride n + 1, then c, dinv, y and z
__host__ __device__ constexpr size_t smem_bytes(int n) {
  return ((size_t)n * (n + 1) + 4 * (size_t)n) * sizeof(float);
}

__global__ void __launch_bounds__(NT)
    cholesky_solve_kernel(const float* __restrict__ S,
                          const float* __restrict__ g, float* __restrict__ x,
                          int n) {
  extern __shared__ float smem[];
  const int ld = n + 1;
  float* A = smem;           // lower triangle becomes L (its diagonal unused)
  float* c = A + n * ld;     // column j of L, contiguous
  float* dinv = c + n;       // 1 / L_jj
  float* y = dinv + n;       // forward right-hand side, updated in place
  float* z = y + n;          // L^-1 g, then the backward right-hand side
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const float* Sb = S + (size_t)blockIdx.x * n * n;
  const float* gb = g + (size_t)blockIdx.x * n;
  float* xb = x + (size_t)blockIdx.x * n;

  for (int e = tid; e < n * n; e += NT) A[(e / n) * ld + e % n] = Sb[e];
  for (int i = tid; i < n; i += NT) y[i] = gb[i];
  __syncthreads();

  for (int j = 0; j < n; ++j) {
    const float d = A[j * ld + j];
    if (!(d > 0.f && d < INFINITY)) {  // the same value in every thread
      for (int i = tid; i < n; i += NT) xb[i] = CUDART_NAN_F;
      return;
    }
    const float inv = 1.f / sqrtf(d);
    for (int i = j + 1 + tid; i < n; i += NT) {
      const float v = A[i * ld + j] * inv;
      A[i * ld + j] = v;
      c[i] = v;
    }
    if (tid == 0) dinv[j] = inv;
    __syncthreads();
    for (int i = j + 1 + warp; i < n; i += WARPS) {
      const float ci = c[i];
      float* row = A + i * ld;
      for (int k = j + 1 + lane; k <= i; k += 32) row[k] -= ci * c[k];
    }
    __syncthreads();
  }

  // L y = g: y_j final at step j, then pushed into the rows below
  for (int j = 0; j < n; ++j) {
    const float yj = y[j] * dinv[j];
    if (tid == 0) z[j] = yj;
    for (int i = j + 1 + tid; i < n; i += NT) y[i] -= A[i * ld + j] * yj;
    __syncthreads();
  }
  // L^T x = z: x_j final at step j, then pushed into the rows above
  for (int j = n - 1; j >= 0; --j) {
    const float xj = z[j] * dinv[j];
    if (tid == 0) xb[j] = xj;
    for (int i = tid; i < j; i += NT) z[i] -= A[j * ld + i] * xj;
    __syncthreads();
  }
}

}  // namespace

// The largest N one launch takes (its matrix fits the shared memory of
// one block).
extern "C" int slam_cholesky_max_n() {
  int n = 0;
  while (smem_bytes(n + 1) <= MAX_SMEM) ++n;
  return n;
}

// Plain C entry point (loaded with ctypes). S (B, N, N) and g (B, N)
// float32 in, x (B, N) float32 out; all contiguous on the current device.
// 1 <= N <= slam_cholesky_max_n(). Launches on `stream` and returns the
// launch's cudaError_t (0 on success).
extern "C" int slam_cholesky_solve(const float* S, const float* g, float* x,
                                   int B, int n, void* stream) {
  if (B <= 0 || n <= 0 || n > slam_cholesky_max_n())
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(n);
  cudaError_t err = cudaFuncSetAttribute(
      cholesky_solve_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  cholesky_solve_kernel<<<B, NT, smem, (cudaStream_t)stream>>>(S, g, x, n);
  return (int)cudaGetLastError();
}
