// The launch side shared by every C entry point of the kernel library.
//
// Each entry point takes the index of the device its tensors live on and
// launches there, on the stream it is given (the caller's current stream
// of that device). The Python wrappers no longer enter a device context
// around every call; the entry point switches the device only when the
// thread's current one is another, and switches it back after the launch.
// A kernel that takes more than 48 KB of dynamic shared memory opts in
// first (`allow_shared`).

#pragma once

#include <cuda_runtime.h>

namespace bithtm {

// What one Hopper block may opt in to (ops/kernels.py MAX_SHARED_BYTES).
constexpr size_t kMaxShared = 232448;

// Lets `kernel` take `smem` bytes of dynamic shared memory (needed above
// 48 KB). Returns a cudaError_t as int (0 = success).
template <typename Kernel>
int allow_shared(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

class DeviceGuard {
 public:
  explicit DeviceGuard(int device) {
    int current = 0;
    err_ = cudaGetDevice(&current);
    if (err_ == cudaSuccess && current != device) {
      err_ = cudaSetDevice(device);
      if (err_ == cudaSuccess) restore_ = current;
    }
  }
  ~DeviceGuard() {
    if (restore_ >= 0) cudaSetDevice(restore_);
  }
  DeviceGuard(const DeviceGuard&) = delete;
  DeviceGuard& operator=(const DeviceGuard&) = delete;

  // cudaError_t as int: 0 once the device is current.
  int error() const { return (int)err_; }

 private:
  cudaError_t err_ = cudaSuccess;
  int restore_ = -1;
};

}  // namespace bithtm
