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
#include <type_traits>

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

// The streaming multiprocessors of the current device (cached for each
// device), or 0 where the query fails.
inline int sm_count() {
  constexpr int kDevices = 64;
  static std::mutex mu;
  static int sms[kDevices] = {};
  int device = 0;
  if (cudaGetDevice(&device) != cudaSuccess) return 0;
  std::lock_guard<std::mutex> lock(mu);
  if (device < kDevices && sms[device]) return sms[device];
  int n = 0;
  if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, device) !=
      cudaSuccess)
    return 0;
  if (device < kDevices) sms[device] = n;
  return n;
}

// The blocks of `threads` threads and `smem` bytes of dynamic shared
// memory that one SM of the current device holds at once (the occupancy
// query, cached for each kernel, device and size), into *per_sm. Returns
// a cudaError_t as int.
template <typename Kernel>
int resident_blocks(Kernel kernel, int threads, size_t smem, int* per_sm) {
  struct Entry {
    const void* kernel;
    int device, threads;
    size_t smem;
    int per_sm;
  };
  constexpr int kEntries = 64;
  static std::mutex mu;
  static Entry cache[kEntries];
  static int used = 0;
  int device = 0;
  if (cudaError_t err = cudaGetDevice(&device)) return (int)err;
  const void* key = reinterpret_cast<const void*>(kernel);
  std::lock_guard<std::mutex> lock(mu);
  for (int i = 0; i < used && i < kEntries; ++i) {
    const Entry& e = cache[i];
    if (e.kernel == key && e.device == device && e.threads == threads &&
        e.smem == smem) {
      *per_sm = e.per_sm;
      return 0;
    }
  }
  if (smem > 48 * 1024) {
    if (int err = (int)cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem))
      return err;
  }
  int n = 0;
  if (cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, kernel, threads, smem))
    return (int)err;
  cache[used++ % kEntries] = Entry{key, device, threads, smem, n};
  *per_sm = n;
  return 0;
}

// Run-time choices to template arguments: each calls f with a
// std::integral_constant of the value chosen (read it in f as
// decltype(arg)::value) and returns what f returns, a cudaError_t as int.
template <class F>
int with_bool(bool flag, F&& f) {
  return flag ? f(std::true_type{}) : f(std::false_type{});
}

// 4 where n is a multiple of 4 (16-byte vector loads), else 1.
template <class F>
int with_vec(int n, F&& f) {
  return n % 4 == 0 ? f(std::integral_constant<int, 4>{})
                    : f(std::integral_constant<int, 1>{});
}

// The packed activity's bytes a value (1: u8, 2: bf16, 4: float32); any
// other count is refused.
template <class F>
int with_bytes(int bytes, F&& f) {
  switch (bytes) {
    case 1: return f(std::integral_constant<int, 1>{});
    case 2: return f(std::integral_constant<int, 2>{});
    case 4: return f(std::integral_constant<int, 4>{});
  }
  return (int)cudaErrorInvalidValue;
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
