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
// (64, 144, 144) it moves 2.75 MB (S's lower triangle, g and x: 0.82 us
// at 3.35 TB/s) and does ~1.0 MFLOP per system (66 MFLOP, 0.99 us at
// 67 TFLOP/s float32). What is left
// is the dependent chain inside each system: N pivots, each needing the
// one before, and the barriers between the phases that feed them. The N
// pivot steps of the diagonal blocks, one warp's work, are the largest
// part (half of a CTA's cycles at N = 144, scripts/probe_kernels_cuda.py),
// then the substitutions' 2N steps, then the trailing updates.
//
// Design: blocked, with the chain cut into NB = 32 wide blocks and the
// sequential part inside a block kept in one warp, where it needs no
// barrier. One CTA per system, so the batch (16 to 64 systems on the
// path) spreads over that many SMs and no CTA waits on another; packing
// several systems into a CTA would leave more of the 132 SMs idle and
// shorten no chain. The matrix lives in dynamic shared memory at an odd
// row stride (a column walk hits 32 banks). Per block of columns
// [kb, kb + nb):
//   1. warp 0 factors the diagonal block in registers (factor_diag: lane
//      i holds row i, pivots by shuffle, columns through a broadcast
//      buffer), checks every pivot and writes L11, its transpose (for
//      vector reads) and 1 / L_jj; barrier;
//   2. if a pivot failed, the whole CTA writes NaN and returns (the flag
//      is read after the barrier, so no thread leaves early);
//   3. the panel: one thread per row below the block solves its row of
//      L21 L11^T = A21 in registers, 32 steps, and writes it to the
//      matrix and to a transposed panel buffer; barrier;
//   4. the trailing update A22 -= L21 L21^T over the lower triangle in
//      4x4 register tiles, each a 32-long sum of float4 outer products
//      from the panel buffer; barrier.
// Three barriers a block (13 for N = 144). The substitutions go block
// by block the same way: warp 0 solves the block's triangle with
// shuffles, barrier, every thread applies the block to its row of the
// remaining right-hand side, barrier (9 each at N = 144; 32 in all with
// the load's, where one barrier per pivot step would take 4N). The
// loops of the sequential parts stay rolled: unrolled, the code outgrows
// the instruction cache, and a launch that runs it once (the 12 x 12
// case) pays for every miss. float32 FMA only: the scene's reduced systems
// are ill-conditioned (relative errors 3e-4 to 5e-4 against float64), so
// TF32 tensor cores, with ~3 digits, are out.
// For N <= 32 (the loop-closure mini-bundle's 12 x 12) the same code runs
// as one warp per system: one block, and every barrier is a __syncwarp.
// The dynamic shared memory attribute is set once per kernel and device
// (launch.cuh).
// Left for later work: fusing the landmark back-substitution
// (ops/ba.py:_back_substitute) into the same launch.

#include <cuda_runtime.h>
#include <math.h>
#include <math_constants.h>

#include "launch.cuh"

namespace {

constexpr int NB = 32;            // block width: one warp's lanes
constexpr int NT = 256;           // threads per CTA for N > NB (8 warps)
constexpr int MAX_SMEM = 232448;  // shared memory a block can use
constexpr unsigned FULL = 0xffffffffu;

__host__ __device__ constexpr int row_stride(int n) { return n | 1; }
__host__ __device__ constexpr int panel_stride(int n) {
  return (n + 3) & ~3;
}
// floats of the matrix, rounded up so the buffers after it stay 16-byte
// aligned for float4 reads
__host__ __device__ constexpr int matrix_floats(int n) {
  return (n * row_stride(n) + 3) & ~3;
}

// the matrix, the transposed panel (NB rows), L11's transpose (NB x NB),
// a column of L11, 1 / L_jj, the right-hand side, and the failure flag
__host__ __device__ constexpr size_t smem_bytes(int n) {
  return ((size_t)matrix_floats(n) + (size_t)NB * panel_stride(n) +
          (size_t)NB * NB + NB + 2 * (size_t)n + 4) * sizeof(float);
}

template <int T>
__device__ __forceinline__ void barrier() {
  if constexpr (T == 32) {
    __syncwarp();
  } else {
    __syncthreads();
  }
}

// Factor the diagonal block (rows [0, nb) of Ab, row stride ld, in
// place) in one warp, right-looking: lane i holds its row in registers,
// r[m] = its entry in column k + m, shifted down one place per step so
// that every register index is static while the step loop stays rolled
// (unrolled, this code outgrows the instruction cache, and a launch that
// runs it once pays for every miss). Step k: the pivot is lane k's r[0]
// (a shuffle), lane i > k forms L_ik = r[0] / sqrt(pivot) and stores it
// in its row and at col[i - k], and, once the warp has written col,
// updates its entries in columns k + 1 .. i from col read as eight
// broadcast float4 (31 shuffles a step cost several times as much). No
// step needs more than a __syncwarp. 1 / sqrt is the MUFU reciprocal
// square root (within 2 ulp), as the chain runs through one pivot per
// step. On return Ab holds L11 below the diagonal and dinv_b[i] =
// 1 / L_ii. Returns false if a pivot was not positive or not finite (the
// same in every lane).
__device__ __forceinline__ bool factor_diag(float* Ab, int ld, float* dinv_b,
                                            float* col, int nb, int lane) {
  const bool mine = lane < nb;
  float* row = Ab + lane * ld;  // read and written by lanes < nb only
  float r[NB];
#pragma unroll
  for (int m = 0; m < NB; ++m) r[m] = mine && m <= lane ? row[m] : 0.f;
  bool ok = true;
  // lane-dependent conditions are selects, never branches: a divergent
  // branch per register would cost more than the update it guards
  for (int k = 0; k < nb; ++k) {
    const float d = __shfl_sync(FULL, r[0], k);
    ok &= (d > 0.f) & (d < INFINITY);
    const float inv = rsqrtf(d);
    const float l = lane > k ? r[0] * inv : 0.f;
    if (lane == k) dinv_b[k] = inv;
    if (mine && lane > k) row[k] = l;
    if (lane > k) col[lane - k] = l;  // col[m] = L_{k+m, k}
    __syncwarp();
#pragma unroll
    for (int m = 0; m < NB; m += 4) {
      const float4 v = *reinterpret_cast<const float4*>(col + m);
      const float c[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (m + q > 0) r[m + q] -= (k + m + q <= lane ? l : 0.f) * c[q];
    }
    __syncwarp();  // col is written again in the next step (and the warp
                   // meets its next shuffle converged)
#pragma unroll
    for (int m = 0; m + 1 < NB; ++m) r[m] = r[m + 1];
    r[NB - 1] = 0.f;
  }
  return ok;
}

// 4 bytes global -> shared, asynchronously
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}

template <int T>
__global__ void __launch_bounds__(T)
    cholesky_solve_kernel(const float* __restrict__ S,
                          const float* __restrict__ g, float* __restrict__ x,
                          int n) {
  extern __shared__ __align__(16) float smem[];
  const int ld = row_stride(n), ldp = panel_stride(n);
  float* A = smem;             // lower triangle; L below the diagonal
  float* P = A + matrix_floats(n);  // P[k * ldp + i] = L[i][kb + k]
  float* Lt = P + NB * ldp;    // Lt[j * NB + i] = L[kb + i][kb + j]
  float* col = Lt + NB * NB;   // one column of L11, in factor_diag
  float* dinv = col + NB;      // 1 / L_jj
  float* y = dinv + n;         // right-hand side, solved in place
  int* failed = reinterpret_cast<int*>(y + n);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float* Sb = S + (size_t)blockIdx.x * n * n;

  // the lower triangle only, and g: every copy in flight at once
  for (int i = warp; i < n; i += T / 32)
    for (int j = lane; j <= i; j += 32)
      cp_async4(A + i * ld + j, Sb + i * n + j);
  for (int i = tid; i < n; i += T)
    cp_async4(y + i, g + (size_t)blockIdx.x * n + i);
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  if (tid == 0) *failed = 0;
  if (tid < NB) col[tid] = 0.f;  // entries no step writes are read as 0
  barrier<T>();

  for (int kb = 0; kb < n; kb += NB) {
    const int nb = min(NB, n - kb);
    // 1. the diagonal block, in warp 0
    if (warp == 0) {
      const bool ok =
          factor_diag(A + kb * ld + kb, ld, dinv + kb, col, nb, lane);
      for (int j = 0; kb + NB < n && j < NB; ++j)  // L11^T for the panel
        Lt[j * NB + lane] =
            j < lane && lane < nb ? A[(kb + lane) * ld + kb + j] : 0.f;
      if (!ok && lane == 0) *failed = 1;
    }
    barrier<T>();
    // 2. a failed pivot fails the system, uniformly
    if (*failed) {
      for (int i = tid; i < n; i += T)
        x[(size_t)blockIdx.x * n + i] = CUDART_NAN_F;
      return;
    }
    const int r0 = kb + NB;  // first row below the block (nb == NB here)
    if (r0 >= n) break;
    // 3. the panel: row i of L21 solves L21 L11^T = A21
    for (int i = r0 + tid; i < n; i += T) {
      float v[NB];
#pragma unroll
      for (int j = 0; j < NB; ++j) v[j] = A[i * ld + kb + j];
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        v[j] *= dinv[kb + j];
        const float4* col = reinterpret_cast<const float4*>(Lt + j * NB);
#pragma unroll
        for (int m4 = (j + 1) / 4; m4 < NB / 4; ++m4) {
          const float4 c = col[m4];
          const float cs[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
          for (int q = 0; q < 4; ++q)
            if (4 * m4 + q > j) v[4 * m4 + q] -= v[j] * cs[q];
        }
      }
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        A[i * ld + kb + j] = v[j];
        P[j * ldp + i] = v[j];
      }
    }
    barrier<T>();
    // 4. trailing update of the lower triangle, 4x4 tiles
    const int tiles = (n - r0 + 3) / 4;
    for (int t = tid; t < tiles * (tiles + 1) / 2; t += T) {
      int ti = (int)((sqrtf(8.f * t + 1.f) - 1.f) * 0.5f);
      while (ti * (ti + 1) / 2 > t) --ti;
      while ((ti + 1) * (ti + 2) / 2 <= t) ++ti;
      const int tj = t - ti * (ti + 1) / 2;
      const int ri = r0 + 4 * ti, ci = r0 + 4 * tj;
      float acc[4][4] = {};
#pragma unroll 8
      for (int k = 0; k < NB; ++k) {
        const float4 a = *reinterpret_cast<const float4*>(P + k * ldp + ri);
        const float4 b = *reinterpret_cast<const float4*>(P + k * ldp + ci);
        const float av[4] = {a.x, a.y, a.z, a.w};
        const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int p = 0; p < 4; ++p)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[p][q] += av[p] * bv[q];
      }
#pragma unroll
      for (int p = 0; p < 4; ++p)
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (ri + p < n && ci + q <= ri + p)
            A[(ri + p) * ld + ci + q] -= acc[p][q];
    }
    barrier<T>();
  }

  // L y = g, block by block
  for (int kb = 0; kb < n; kb += NB) {
    const int nb = min(NB, n - kb);
    if (warp == 0) {
      const float* Li = A + (kb + min(lane, nb - 1)) * ld + kb;  // row
      float yi = lane < nb ? y[kb + lane] : 0.f;
      for (int k = 0; k < nb; ++k) {  // selects, no divergent branches
        const float yk = __shfl_sync(FULL, yi, k) * dinv[kb + k];
        const float upd = yi - Li[k] * yk;
        yi = lane == k ? yk : (lane > k ? upd : yi);
      }
      if (lane < nb) y[kb + lane] = yi;
    }
    barrier<T>();
    if (kb + nb < n) {
      for (int i = kb + nb + tid; i < n; i += T) {
        float s = y[i];
#pragma unroll 8
        for (int k = 0; k < NB; ++k) s -= A[i * ld + kb + k] * y[kb + k];
        y[i] = s;
      }
      barrier<T>();
    }
  }
  // L^T x = y, block by block from the last
  for (int kb = (n - 1) / NB * NB; kb >= 0; kb -= NB) {
    const int nb = min(NB, n - kb);
    if (warp == 0) {
      const int li = min(lane, nb - 1);  // this lane's column
      float zi = lane < nb ? y[kb + lane] : 0.f;
      for (int k = nb - 1; k >= 0; --k) {  // selects, no divergent branches
        const float xk = __shfl_sync(FULL, zi, k) * dinv[kb + k];
        const float upd = zi - A[(kb + k) * ld + kb + li] * xk;
        zi = lane == k ? xk : (lane < k ? upd : zi);
      }
      if (lane < nb) y[kb + lane] = zi;
    }
    barrier<T>();
    if (kb > 0) {
      for (int i = tid; i < kb; i += T) {
        float s = y[i];
#pragma unroll 8
        for (int k = 0; k < nb; ++k) s -= A[(kb + k) * ld + i] * y[kb + k];
        y[i] = s;
      }
      barrier<T>();
    }
  }
  for (int i = tid; i < n; i += T) x[(size_t)blockIdx.x * n + i] = y[i];
}

int max_n_once() {
  int n = 0;
  while (smem_bytes(n + 1) <= MAX_SMEM) ++n;
  return n;
}

}  // namespace

// The largest N one launch takes (its matrix and buffers fit the shared
// memory of one block).
extern "C" int slam_cholesky_max_n() {
  static const int n = max_n_once();
  return n;
}

// Plain C entry point (loaded with ctypes). S (B, N, N) and g (B, N)
// float32 in, x (B, N) float32 out; all contiguous on device `device`.
// 1 <= N <= slam_cholesky_max_n(). Launches on `stream` and returns the
// launch's cudaError_t (0 on success).
extern "C" int slam_cholesky_solve(const float* S, const float* g, float* x,
                                   int B, int n, int device, void* stream) {
  if (B <= 0 || n <= 0 || n > slam_cholesky_max_n())
    return (int)cudaErrorInvalidValue;
  const slam::DeviceScope scope(device);
  cudaError_t err = scope.error();
  if (err != cudaSuccess) return (int)err;
  static slam::SmemOnce smem_warp, smem_cta;
  const size_t smem = smem_bytes(n);
  cudaStream_t s = (cudaStream_t)stream;
  if (n <= NB) {
    err = smem_warp(cholesky_solve_kernel<32>, device, smem_bytes(NB));
    if (err == cudaSuccess)
      cholesky_solve_kernel<32><<<B, 32, smem, s>>>(S, g, x, n);
  } else {
    err = smem_cta(cholesky_solve_kernel<NT>, device,
                   smem_bytes(slam_cholesky_max_n()));
    if (err == cudaSuccess)
      cholesky_solve_kernel<NT><<<B, NT, smem, s>>>(S, g, x, n);
  }
  return (int)(err == cudaSuccess ? cudaGetLastError() : err);
}
