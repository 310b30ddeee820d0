// A device-clock stamp: one thread writes the card's global timer
// (%globaltimer, nanoseconds) into slot i of an int64 buffer.
//
// It replaces no TPU kernel. It was added to time the parts of a CUDA
// graph, where no host clock can reach: the frontend's chunk graph
// (models/frontend.py _chunk) stamps before its features, after them and
// after its poses, and the host reads the stamps with the chunk's other
// outputs. It makes no host read and no synchronisation, so it is safe
// inside a capture, and stream order places it between the kernels before
// and after it. It moves 8 bytes: launch latency bounds it.

#include <cuda_runtime.h>

#include "launch.cuh"

namespace {

__global__ void stamp_kernel(long long* __restrict__ buf, int i) {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  buf[i] = (long long)t;
}

}  // namespace

// Plain C entry point (loaded with ctypes). buf: int64 on device `device`,
// with at least i + 1 slots. Launches one thread on `stream`; returns the
// first error as cudaError_t (0 on success).
extern "C" int slam_stamp(long long* buf, int i, int device, void* stream) {
  if (i < 0) return (int)cudaErrorInvalidValue;
  const slam::DeviceScope scope(device);
  const cudaError_t err = scope.error();
  if (err != cudaSuccess) return (int)err;
  stamp_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(buf, i);
  return (int)cudaGetLastError();
}
