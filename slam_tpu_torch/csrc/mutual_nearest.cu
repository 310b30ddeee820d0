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
// with pen = 0 for valid keypoints and 1e30 for invalid ones (read from
// the bool masks here). The K x K distance matrix is never stored. The
// cross check and the distance gate stay in the wrapper (ops/matching.py).
//
// What bounds it on the H100: at the frontend's shapes (32 pairs of
// 2048 x 2048 x 128) the products are 34 GFLOP of bf16, ~35 us at the
// card's dense rate, and the inputs 33 MB (~10 us). Neither is what the
// kernel waits on. Measured on an H100 with scripts/probe_kernels_cuda.py
// (copies of this source with parts of the epilogue cut out), the kernel
// takes ~0.27 ms of device time and ~0.31 ms by events, and the load and
// mma.sync main loop alone ~0.115 ms by events: the epilogue (the window
// test, two strict-less updates and the key merges for each of the 134M
// distances) is the larger part, the column reduction ~0.06 ms of it,
// the row reduction ~0.02 ms. The main loop itself runs at ~3.3x the
// MMA's time; what holds it there is not measured. wgmma would shorten
// only the main loop (ROADMAP.md queue D).
//
// Design: one CTA of 8 warps per (pair, 128-row tile of A). The A tile
// stays in shared memory; the CTA walks 64-column tiles of B through a
// double-buffered cp.async ring (the next tile loads while this one is
// multiplied and reduced). Warp (wm, wn) owns rows [32 wm, 32 wm + 32) x
// columns [32 wn, 32 wn + 32) of each 128 x 64 tile: 2 x 4 m16n8k16
// fragments, 32 accumulators a thread. The epilogue reads the distances
// from those registers, where each thread knows its rows and columns from
// the fragment layout, and evaluates the window test once per distance
// for both reductions:
//   rows: each thread keeps, for its 4 rows, the minimum over the columns
//     it sees, in increasing column order with strict-less updates (the
//     lowest column wins ties), across all tiles; at the end the 4 lanes
//     of a quad and the two column warps merge (distance, column) keys;
//   columns: each thread takes the minimum over its 4 rows, then the 8
//     lanes sharing a column set reduce-scatter packed keys (order-
//     preserving float key << 32 | row) with three xor shuffles, then the
//     4 row warps merge through shared memory, and one 64-bit atomicMin
//     per column per CTA carries the minimum across the CTAs of a pair;
//     the packed key keeps the lowest row on ties, as jnp.argmin does.
// Rows and columns past Ka and Kb get an infinite penalty, so they never
// win. A small second kernel unpacks the column keys into distance and
// index. Any Ka and Kb; D a multiple of 16 up to 256.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "launch.cuh"

namespace {

constexpr int BM = 128;  // rows of A per CTA
constexpr int BN = 64;   // columns (rows of B) per tile
constexpr int NT = 256;  // 8 warps: 4 along the rows x 2 along the columns
constexpr float BIG = 1e30f;
constexpr unsigned FULL = 0xffffffffu;

struct Window {
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

__device__ __forceinline__ unsigned long long pack(float d, unsigned int i) {
  return ((unsigned long long)f2key(d) << 32) | i;
}

__device__ __forceinline__ unsigned long long umin64(unsigned long long a,
                                                     unsigned long long b) {
  return a < b ? a : b;
}

__device__ __forceinline__ unsigned long long shfl_xor64(unsigned long long v,
                                                         int m) {
  const unsigned lo = __shfl_xor_sync(FULL, (unsigned)v, m);
  const unsigned hi = __shfl_xor_sync(FULL, (unsigned)(v >> 32), m);
  return ((unsigned long long)hi << 32) | lo;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared, zero-filled when !ok
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4],
                                            const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// cp.async `rows` descriptors of D bf16 from src (row r0 of a set of K)
// to shared memory at row stride lds, zeros past K
__device__ __forceinline__ void load_rows(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src, int r0,
                                          int rows, int K, int D, int lds) {
  const int vpr = D / 8;  // 16-byte vectors per descriptor
  for (int v = threadIdx.x; v < rows * vpr; v += NT) {
    const int r = v / vpr, c = v % vpr;
    const bool ok = r0 + r < K;
    cp_async16(dst + r * lds + c * 8,
               src + (size_t)(ok ? r0 + r : 0) * D + c * 8, ok);
  }
}

// shared memory of one CTA at descriptor width D: A's tile, two stages of
// B's, the column metadata of both stages, the column and row merge
// buffers
__host__ __device__ constexpr size_t smem_bytes(int D) {
  return (size_t)(BM + 2 * BN) * (D + 8) * sizeof(__nv_bfloat16) +
         (size_t)2 * 3 * BN * sizeof(float) +
         (size_t)(4 * BN + 2 * BM) * sizeof(unsigned long long);
}

template <bool WIN>
__global__ void __launch_bounds__(NT)
    mutual_kernel(const __nv_bfloat16* __restrict__ A,
                  const __nv_bfloat16* __restrict__ Bd,
                  const unsigned char* __restrict__ valid_a,
                  const unsigned char* __restrict__ valid_b,
                  const float* __restrict__ xya, const float* __restrict__ xyb,
                  int Ka, int Kb, int D, Window win, float* __restrict__ rdist,
                  long long* __restrict__ ridx,
                  unsigned long long* __restrict__ colbest) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int lds = D + 8;  // bf16 row stride: conflict-free ldmatrix rows
  __nv_bfloat16* sA = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sB = sA + BM * lds;  // two stages of BN rows
  float* sMeta = reinterpret_cast<float*>(sB + 2 * BN * lds);  // [2][3][BN]
  unsigned long long* sCol =
      reinterpret_cast<unsigned long long*>(sMeta + 2 * 3 * BN);  // [4][BN]
  unsigned long long* sRow = sCol + 4 * BN;                       // [2][BM]

  const int pair = blockIdx.y;
  const int r0 = blockIdx.x * BM;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp & 3, wn = warp >> 2;
  const int g = lane >> 2, t = lane & 3;
  const __nv_bfloat16* Ap = A + (size_t)pair * Ka * D;
  const __nv_bfloat16* Bp = Bd + (size_t)pair * Kb * D;
  const unsigned char* vb = valid_b + (size_t)pair * Kb;
  const float* xb_p = xyb + (size_t)pair * Kb * 2;
  const int n_tiles = (Kb + BN - 1) / BN;

  // column metadata of a tile: loaded to registers early, stored late
  float m_pen = 0.f, m_x = 0.f, m_y = 0.f;
  auto meta_load = [&](int c0) {
    if (tid < BN) {
      const int c = c0 + tid;
      const bool ok = c < Kb;
      m_pen = ok ? (vb[c] ? 0.f : BIG) : INFINITY;
      if (WIN) {
        m_x = ok ? xb_p[2 * c] : 0.f;
        m_y = ok ? xb_p[2 * c + 1] : 0.f;
      }
    }
  };
  auto meta_store = [&](int stage) {
    if (tid < BN) {
      float* m = sMeta + stage * 3 * BN;
      m[tid] = m_pen;
      m[BN + tid] = m_x;
      m[2 * BN + tid] = m_y;
    }
  };

  // this thread's rows: wm*32 + mi*16 + h*8 + g, in increasing order
  float pa[4], xa[4], ya[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int r = r0 + wm * 32 + q * 8 + g;
    const bool ok = r < Ka;
    const size_t o = (size_t)pair * Ka + (ok ? r : 0);
    pa[q] = ok ? (valid_a[o] ? 0.f : BIG) : INFINITY;
    xa[q] = (WIN && ok) ? xya[2 * o] : 0.f;
    ya[q] = (WIN && ok) ? xya[2 * o + 1] : 0.f;
  }
  float rbest[4];
  unsigned ridx_[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    rbest[q] = INFINITY;
    ridx_[q] = 0u;
  }

  load_rows(sA, Ap, r0, BM, Ka, D, lds);
  load_rows(sB, Bp, 0, BN, Kb, D, lds);
  cp_commit();
  meta_load(0);
  meta_store(0);

  // ldmatrix row addresses of this lane (see the fragment layouts of
  // mma.m16n8k16): A matrices (rows 0-7 | 8-15) x (k 0-7 | 8-15), B
  // matrices (k 0-7 | 8-15) x (columns 0-7 | 8-15)
  const int a_row = wm * 32 + (lane & 7) + ((lane >> 3) & 1) * 8;
  const int a_k = (lane >> 4) * 8;
  const int b_row = wn * 32 + (lane & 7) + (lane >> 4) * 8;
  const int b_k = ((lane >> 3) & 1) * 8;

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int c0 = tile * BN, stage = tile & 1;
    if (tile + 1 < n_tiles) {
      load_rows(sB + (stage ^ 1) * BN * lds, Bp, c0 + BN, BN, Kb, D, lds);
      meta_load(c0 + BN);
    }
    cp_commit();
    cp_wait<1>();     // this tile's rows (and, at tile 0, A's) have landed
    __syncthreads();  // ... for every thread, with this tile's metadata

    float acc[2][4][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;
    const __nv_bfloat16* sBs = sB + stage * BN * lds;
#pragma unroll 2
    for (int k0 = 0; k0 < D; k0 += 16) {
      unsigned af[2][4], bf[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        ldmatrix_x4(af[mi], sA + (a_row + mi * 16) * lds + k0 + a_k);
#pragma unroll
      for (int np = 0; np < 2; ++np)
        ldmatrix_x4(bf[np], sBs + (b_row + np * 16) * lds + k0 + b_k);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
          mma_bf16(acc[mi][ni], af[mi], bf[ni >> 1][(ni & 1) * 2],
                   bf[ni >> 1][(ni & 1) * 2 + 1]);
    }

    // epilogue: this thread's columns wn*32 + ni*8 + 2t + e, in
    // increasing order (slot s = 2 ni + e)
    const float* m = sMeta + stage * 3 * BN;
    float pb[8], xb[8], yb[8];
#pragma unroll
    for (int s = 0; s < 8; ++s) {
      const int c = wn * 32 + (s >> 1) * 8 + 2 * t + (s & 1);
      pb[s] = m[c];
      xb[s] = WIN ? m[BN + c] : 0.f;
      yb[s] = WIN ? m[2 * BN + c] : 0.f;
    }
    float cbest[8];
    unsigned cidx[8];
#pragma unroll
    for (int s = 0; s < 8; ++s) {
      cbest[s] = INFINITY;
      cidx[s] = 0xffffffffu;
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {  // row q: fragment mi = q / 2, half q % 2
      const unsigned row = (unsigned)(r0 + wm * 32 + q * 8 + g);
#pragma unroll
      for (int s = 0; s < 8; ++s) {
        // 2 - 2 a.b in one rounding (2 a.b is exact), as torch rounds it
        float base =
            fmaf(-2.f, acc[q >> 1][s >> 1][(q & 1) * 2 + (s & 1)], 2.f);
        if (WIN) {
          const float dx = xb[s] - xa[q];
          const float dy = fabsf(yb[s] - ya[q]);
          if (dx < win.dx_min || dx > win.dx_max || dy > win.dy_max)
            base = base + BIG;
        }
        const float dr = base + pb[s];
        if (dr < rbest[q]) {
          rbest[q] = dr;
          ridx_[q] = (unsigned)(c0 + wn * 32 + (s >> 1) * 8 + 2 * t + (s & 1));
        }
        const float dc = base + pa[q];
        if (dc < cbest[s]) {
          cbest[s] = dc;
          cidx[s] = row;
        }
      }
    }
    // columns: reduce-scatter over the 8 lanes of equal t (xor 16, 8, 4);
    // lane (g, t) ends with slot g
    unsigned long long key[8];
#pragma unroll
    for (int s = 0; s < 8; ++s) key[s] = pack(cbest[s], cidx[s]);
    {
      const bool hi = (g >> 2) & 1;
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const unsigned long long send = hi ? key[s] : key[s + 4];
        const unsigned long long keep = hi ? key[s + 4] : key[s];
        key[s] = umin64(keep, shfl_xor64(send, 16));
      }
    }
    {
      const bool hi = (g >> 1) & 1;
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        const unsigned long long send = hi ? key[s] : key[s + 2];
        const unsigned long long keep = hi ? key[s + 2] : key[s];
        key[s] = umin64(keep, shfl_xor64(send, 8));
      }
    }
    {
      const bool hi = g & 1;
      const unsigned long long send = hi ? key[0] : key[1];
      const unsigned long long keep = hi ? key[1] : key[0];
      key[0] = umin64(keep, shfl_xor64(send, 4));
    }
    sCol[wm * BN + wn * 32 + (g >> 1) * 8 + 2 * t + (g & 1)] = key[0];
    if (tile + 1 < n_tiles) meta_store(stage ^ 1);
    __syncthreads();  // sCol complete; every read of this stage done
    if (tid < BN && c0 + tid < Kb) {
      const unsigned long long k =
          umin64(umin64(sCol[tid], sCol[BN + tid]),
                 umin64(sCol[2 * BN + tid], sCol[3 * BN + tid]));
      if ((unsigned)k != 0xffffffffu)
        atomicMin(colbest + (size_t)pair * Kb + c0 + tid, k);
    }
  }

  // rows: merge the quad (xor 1, 2), then the two column warps
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    unsigned long long k = pack(rbest[q], ridx_[q]);
    k = umin64(k, shfl_xor64(k, 1));
    k = umin64(k, shfl_xor64(k, 2));
    if (t == 0) sRow[wn * BM + wm * 32 + q * 8 + g] = k;
  }
  __syncthreads();
  if (tid < BM && r0 + tid < Ka) {
    const unsigned long long k = umin64(sRow[tid], sRow[BM + tid]);
    rdist[(size_t)pair * Ka + r0 + tid] = key2f((unsigned)(k >> 32));
    ridx[(size_t)pair * Ka + r0 + tid] = (long long)(k & 0xffffffffull);
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
// bf16; valid_a (B, Ka), valid_b (B, Kb) bool (one byte each); xya
// (B, Ka, 2), xyb (B, Kb, 2) float32, read only when use_window != 0.
// colbest (B, Kb) uint64 scratch (set to all ones here). Outputs: rdist
// (B, Ka) f32, ridx (B, Ka) int64, cdist (B, Kb) f32, cidx (B, Kb) int64.
// All on device `device`. D must be a positive multiple of 16, at most
// 256. Launches on `stream`; returns the first error as cudaError_t (0 on
// success).
extern "C" int slam_mutual_nearest(
    const void* a, const void* b, const void* valid_a, const void* valid_b,
    const float* xya, const float* xyb, int B, int Ka, int Kb, int D,
    int use_window, float dx_min, float dx_max, float dy_max,
    unsigned long long* colbest, float* rdist, long long* ridx, float* cdist,
    long long* cidx, int device, void* stream) {
  if (B <= 0 || Ka <= 0 || Kb <= 0 || D <= 0 || D % 16 != 0 || D > 256)
    return (int)cudaErrorInvalidValue;
  const slam::DeviceScope scope(device);
  cudaError_t err = scope.error();
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  const size_t n = (size_t)B * Kb;
  err = cudaMemsetAsync(colbest, 0xff, n * sizeof(*colbest), s);
  if (err != cudaSuccess) return (int)err;
  static slam::SmemOnce smem_win, smem_all;  // to the largest D
  err = use_window ? smem_win(mutual_kernel<true>, device, smem_bytes(256))
                   : smem_all(mutual_kernel<false>, device, smem_bytes(256));
  if (err != cudaSuccess) return (int)err;
  const Window win{dx_min, dx_max, dy_max};
  const dim3 grid((Ka + BM - 1) / BM, B);
  const auto* A = static_cast<const __nv_bfloat16*>(a);
  const auto* Bd = static_cast<const __nv_bfloat16*>(b);
  const auto* va = static_cast<const unsigned char*>(valid_a);
  const auto* vb = static_cast<const unsigned char*>(valid_b);
  if (use_window)
    mutual_kernel<true><<<grid, NT, smem_bytes(D), s>>>(
        A, Bd, va, vb, xya, xyb, Ka, Kb, D, win, rdist, ridx, colbest);
  else
    mutual_kernel<false><<<grid, NT, smem_bytes(D), s>>>(
        A, Bd, va, vb, xya, xyb, Ka, Kb, D, win, rdist, ridx, colbest);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  unpack_columns<<<(unsigned int)((n + 255) / 256), 256, 0, s>>>(
      colbest, cdist, cidx, n);
  return (int)cudaGetLastError();
}
