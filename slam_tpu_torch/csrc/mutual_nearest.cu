// Kernel B2: one-pass mutual nearest neighbours of descriptor sets.
//
// Replaces the TPU kernel slam_tpu/ops/pallas_kernels.py:mutual_nearest
// (body _mutual_kernel). For each pair b of a batch, with A (Ka, D) and
// B (Kb, D) descriptors in bf16:
//   d[i, j] = 2 - 2 <A_i, B_j>             (bf16 products, f32 sums)
//           + 1e30 if (x_j - x_i, |y_j - y_i|) falls outside the guided
//             window (dx_min, dx_max, dy_max), when a window is given;
//   row  i: min_j d[i, j] + pen_b[j]   and its lowest argmin j;
//   col  j: min_i d[i, j] + pen_a[i]   and its lowest argmin i;
// with pen = 0 for valid keypoints and 1e30 for invalid ones. The K x K
// distance matrix is never stored. The cross check and the distance gate
// stay in the wrapper (ops/matching.py).
//
// What bounds it on the H100: neither memory nor the tensor cores at the
// frontend's shapes (32 pairs of 2048 x 2048 x 128): the products are
// 34 GFLOP of bf16 (~35 us at the card's dense rate) and the inputs
// 33 MB, but the epilogue reads every one of the 134M distances twice
// from shared memory, with the window test, for the two reductions. The
// epilogue's instruction count is the limit.
//
// Design: one CTA (4 warps) per (pair, 64-row tile of A). The A tile stays
// in shared memory; the CTA loops over 64-column tiles of B staged in
// shared memory, forms the 64x64 similarity tile with WMMA bf16 fragments
// (f32 accumulate) into shared memory, and runs both reductions from
// there: the row minimum is carried in registers across column tiles
// (strictly-less updates in column order keep the lowest index), and the
// column minimum across the CTAs of a pair goes through a 64-bit atomicMin
// on (order-preserving float key << 32 | row index) in a scratch buffer,
// which also keeps the lowest row index on ties, as jnp.argmin does. A
// small second kernel unpacks the scratch into column distance and index.
// Any Ka and Kb are taken; ragged tiles are masked.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;

constexpr int BM = 64;   // rows of A per CTA
constexpr int BN = 64;   // columns (rows of B) per tile
constexpr int NT = 128;  // 4 warps
constexpr int LDC = BN + 4;
constexpr float BIG = 1e30f;

struct Window {
  int on;
  float dx_min, dx_max, dy_max;
};

// order-preserving map float -> uint32 (and back); -0 is folded to +0 so
// equal distances compare equal, as they do in float
__device__ __forceinline__ unsigned int f2key(float f) {
  if (f == 0.f) f = 0.f;
  const unsigned int u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float key2f(unsigned int k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

__device__ __forceinline__ bool outside_window(const Window& w, float dx,
                                               float dy) {
  return dx < w.dx_min || dx > w.dx_max || dy > w.dy_max;
}

__global__ void __launch_bounds__(NT)
mutual_kernel(const __nv_bfloat16* __restrict__ A,
              const __nv_bfloat16* __restrict__ Bd,
              const float* __restrict__ pen_a, const float* __restrict__ pen_b,
              const float* __restrict__ xya, const float* __restrict__ xyb,
              int Ka, int Kb, int D, Window win, float* __restrict__ rdist,
              long long* __restrict__ ridx,
              unsigned long long* __restrict__ colbest) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int lds = D + 8;  // bf16 row stride: 16-byte rows, fewer conflicts
  __nv_bfloat16* sA = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sB = sA + BM * lds;
  float* sC = reinterpret_cast<float*>(sB + BN * lds);
  float* sPa = sC + BM * LDC;
  float* sXa = sPa + BM;
  float* sYa = sXa + BM;
  float* sPb = sYa + BM;
  float* sXb = sPb + BN;
  float* sYb = sXb + BN;

  const int pair = blockIdx.y;
  const int r0 = blockIdx.x * BM;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const __nv_bfloat16* Ap = A + (size_t)pair * Ka * D;
  const __nv_bfloat16* Bp = Bd + (size_t)pair * Kb * D;
  const int vpr = D / 8;  // 16-byte vectors per descriptor

  for (int v = tid; v < BM * vpr; v += NT) {
    const int r = v / vpr, c = v % vpr;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < Ka)
      val = reinterpret_cast<const uint4*>(Ap + (size_t)(r0 + r) * D)[c];
    *reinterpret_cast<uint4*>(sA + r * lds + c * 8) = val;
  }
  if (tid < BM) {
    const int r = r0 + tid;
    const bool ok = r < Ka;
    sPa[tid] = ok ? pen_a[(size_t)pair * Ka + r] : BIG;
    sXa[tid] = (ok && win.on) ? xya[((size_t)pair * Ka + r) * 2] : 0.f;
    sYa[tid] = (ok && win.on) ? xya[((size_t)pair * Ka + r) * 2 + 1] : 0.f;
  }

  float row_best = INFINITY;
  long long row_idx = 0;
  const int my = tid >> 1;  // row (row pass) or column (column pass)
  const int half = tid & 1;

  for (int c0 = 0; c0 < Kb; c0 += BN) {
    __syncthreads();  // the previous tile's epilogue is done with sB / sC
    for (int v = tid; v < BN * vpr; v += NT) {
      const int r = v / vpr, c = v % vpr;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (c0 + r < Kb)
        val = reinterpret_cast<const uint4*>(Bp + (size_t)(c0 + r) * D)[c];
      *reinterpret_cast<uint4*>(sB + r * lds + c * 8) = val;
    }
    if (tid < BN) {
      const int c = c0 + tid;
      const bool ok = c < Kb;
      sPb[tid] = ok ? pen_b[(size_t)pair * Kb + c] : BIG;
      sXb[tid] = (ok && win.on) ? xyb[((size_t)pair * Kb + c) * 2] : 0.f;
      sYb[tid] = (ok && win.on) ? xyb[((size_t)pair * Kb + c) * 2 + 1] : 0.f;
    }
    __syncthreads();

    // 64x64 similarity tile: warp w owns rows [16w, 16w + 16)
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[BN / 16];
#pragma unroll
    for (int j = 0; j < BN / 16; ++j) wmma::fill_fragment(acc[j], 0.f);
    for (int kk = 0; kk < D; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> fa;
      wmma::load_matrix_sync(fa, sA + warp * 16 * lds + kk, lds);
#pragma unroll
      for (int j = 0; j < BN / 16; ++j) {
        // B^T as a col-major 16x16 block: element (k, n) at sB[n*lds + k]
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::col_major> fb;
        wmma::load_matrix_sync(fb, sB + j * 16 * lds + kk, lds);
        wmma::mma_sync(acc[j], fa, fb, acc[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < BN / 16; ++j)
      wmma::store_matrix_sync(sC + warp * 16 * LDC + j * 16, acc[j], LDC,
                              wmma::mem_row_major);
    __syncthreads();

    // row pass: thread pair (2r, 2r+1) scans columns [0, 32) / [32, 64)
    {
      const float xa = sXa[my], ya = sYa[my];
      float best = INFINITY;
      long long bi = 0;
      for (int c = half * 32; c < half * 32 + 32; ++c) {
        if (c0 + c >= Kb) break;
        float base = 2.f - 2.f * sC[my * LDC + c];
        if (win.on && outside_window(win, sXb[c] - xa, fabsf(sYb[c] - ya)))
          base = base + BIG;
        const float d = base + sPb[c];
        if (d < best) {
          best = d;
          bi = c0 + c;
        }
      }
      const float ob = __shfl_xor_sync(0xffffffffu, best, 1);
      const long long oi = __shfl_xor_sync(0xffffffffu, bi, 1);
      if (ob < best || (ob == best && oi < bi)) {
        best = ob;
        bi = oi;
      }
      if (best < row_best) {  // strictly less: earlier tiles win ties
        row_best = best;
        row_idx = bi;
      }
    }
    // column pass: thread pair (2c, 2c+1) scans rows [0, 32) / [32, 64)
    {
      const float xb = sXb[my], yb = sYb[my];
      float best = INFINITY;
      int bi = 0x7fffffff;
      for (int r = half * 32; r < half * 32 + 32; ++r) {
        if (r0 + r >= Ka) break;
        float base = 2.f - 2.f * sC[r * LDC + my];
        if (win.on && outside_window(win, xb - sXa[r], fabsf(yb - sYa[r])))
          base = base + BIG;
        const float d = base + sPa[r];
        if (d < best) {
          best = d;
          bi = r0 + r;
        }
      }
      const float ob = __shfl_xor_sync(0xffffffffu, best, 1);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, 1);
      if (ob < best || (ob == best && oi < bi)) {
        best = ob;
        bi = oi;
      }
      if (half == 0 && c0 + my < Kb && bi != 0x7fffffff) {
        const unsigned long long packed =
            ((unsigned long long)f2key(best) << 32) | (unsigned int)bi;
        atomicMin(colbest + (size_t)pair * Kb + c0 + my, packed);
      }
    }
  }
  if (half == 0 && r0 + my < Ka) {
    rdist[(size_t)pair * Ka + r0 + my] = row_best;
    ridx[(size_t)pair * Ka + r0 + my] = row_idx;
  }
}

__global__ void unpack_columns(const unsigned long long* __restrict__ packed,
                               float* __restrict__ cdist,
                               long long* __restrict__ cidx, size_t n) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const unsigned long long p = packed[i];
  cidx[i] = (long long)(p & 0xffffffffull);
  cdist[i] = key2f((unsigned int)(p >> 32));
}

}  // namespace

// Plain C entry point (loaded with ctypes). a (B, Ka, D), b (B, Kb, D)
// bf16; pen_a (B, Ka), pen_b (B, Kb) float32; xya (B, Ka, 2), xyb
// (B, Kb, 2) float32, read only when use_window != 0. colbest (B, Kb)
// uint64 scratch, every word set to all ones by the caller. Outputs:
// rdist (B, Ka) f32, ridx (B, Ka) int64, cdist (B, Kb) f32, cidx (B, Kb)
// int64. D must be a positive multiple of 16, at most 256. Launches on
// `stream`; returns the first launch error as cudaError_t (0 on success).
extern "C" int slam_mutual_nearest(
    const void* a, const void* b, const float* pen_a, const float* pen_b,
    const float* xya, const float* xyb, int B, int Ka, int Kb, int D,
    int use_window, float dx_min, float dx_max, float dy_max,
    unsigned long long* colbest, float* rdist, long long* ridx, float* cdist,
    long long* cidx, void* stream) {
  if (B <= 0 || Ka <= 0 || Kb <= 0 || D <= 0 || D % 16 != 0 || D > 256)
    return (int)cudaErrorInvalidValue;
  const int lds = D + 8;
  const size_t smem = (size_t)(BM + BN) * lds * sizeof(__nv_bfloat16) +
                      (size_t)BM * LDC * sizeof(float) +
                      (size_t)3 * (BM + BN) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      mutual_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  Window win{use_window, dx_min, dx_max, dy_max};
  cudaStream_t s = (cudaStream_t)stream;
  dim3 grid((Ka + BM - 1) / BM, B);
  mutual_kernel<<<grid, NT, smem, s>>>(
      reinterpret_cast<const __nv_bfloat16*>(a),
      reinterpret_cast<const __nv_bfloat16*>(b), pen_a, pen_b, xya, xyb, Ka,
      Kb, D, win, rdist, ridx, colbest);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t n = (size_t)B * Kb;
  unpack_columns<<<(unsigned int)((n + 255) / 256), 256, 0, s>>>(
      colbest, cdist, cidx, n);
  return (int)cudaGetLastError();
}
