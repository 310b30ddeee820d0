// Host-side launch helpers shared by the kernels' C entry points.
//
// Every entry point takes the device of its tensors and selects it with a
// DeviceScope, so the Python wrappers need no device context; a kernel
// with more dynamic shared memory than the default 48 KB raises its limit
// once per device with a SmemOnce.

#pragma once

#include <cuda_runtime.h>

namespace slam {

// Makes `device` current for one entry point's launches and restores the
// caller's device when it goes out of scope.
class DeviceScope {
 public:
  explicit DeviceScope(int device) : device_(device) {
    err_ = cudaGetDevice(&prev_);
    if (err_ == cudaSuccess && prev_ != device_) err_ = cudaSetDevice(device_);
  }
  ~DeviceScope() {
    if (err_ == cudaSuccess && prev_ != device_) cudaSetDevice(prev_);
  }
  DeviceScope(const DeviceScope&) = delete;
  DeviceScope& operator=(const DeviceScope&) = delete;
  cudaError_t error() const { return err_; }

 private:
  int device_;
  int prev_ = 0;
  cudaError_t err_;
};

// cudaFuncSetAttribute(kernel, max dynamic shared memory, bytes) once per
// device: one static instance per kernel, given the most any launch of it
// asks for.
class SmemOnce {
 public:
  template <typename K>
  cudaError_t operator()(K* kernel, int device, size_t bytes) {
    const unsigned long long bit = 1ull << (device & 63);
    if (done_ & bit) return cudaSuccess;
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err == cudaSuccess) done_ |= bit;
    return err;
  }

 private:
  unsigned long long done_ = 0;  // one bit per device
};

}  // namespace slam
