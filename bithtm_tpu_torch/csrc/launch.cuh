// The launch side shared by every C entry point of the kernel library.
//
// Each entry point takes the index of the device its tensors live on and
// launches there, on the stream it is given (the caller's current stream
// of that device). The Python wrappers no longer enter a device context
// around every call; the entry point switches the device only when the
// thread's current one is another, and switches it back after the launch.
// A kernel that takes more than 48 KB of dynamic shared memory opts in
// first (`allow_shared`), once for each size on each device: a launch
// captured into a CUDA graph (`models/graph.py`, after a warm-up launch)
// then makes no runtime call but the launch itself.

#pragma once

#include <cuda_runtime.h>

#include <mutex>

namespace bithtm {

// What one Hopper block may opt in to (ops/kernels.py MAX_SHARED_BYTES).
constexpr size_t kMaxShared = 232448;

// Lets `kernel` take `smem` bytes of dynamic shared memory (needed above
// 48 KB) on the current device, unless an earlier call allowed as much.
// Returns a cudaError_t as int (0 = success).
template <typename Kernel>
int allow_shared(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  struct Entry {
    const void* kernel;
    int device;
    size_t smem;
  };
  constexpr int kEntries = 64;
  static std::mutex mu;
  static Entry allowed[kEntries];
  static int used = 0;
  int device = 0;
  if (cudaError_t err = cudaGetDevice(&device)) return (int)err;
  const void* key = reinterpret_cast<const void*>(kernel);
  std::lock_guard<std::mutex> lock(mu);
  for (int i = 0; i < used && i < kEntries; ++i)
    if (allowed[i].kernel == key && allowed[i].device == device &&
        allowed[i].smem >= smem)
      return 0;
  int err = (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == 0) allowed[used++ % kEntries] = Entry{key, device, smem};
  return err;
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
