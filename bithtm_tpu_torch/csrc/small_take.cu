// Small-table lookup of the index-keyed growth selection, for NVIDIA
// Hopper (sm_90a).
//
// Replaces small_table_take_tpu (bithtm_tpu/ops/pallas_kernels.py:885,
// body _small_take_kernel :872): the decode list index -> candidate cell
// of the growth keys above 2^16 cells (bithtm_tpu/ops/active_set.py
// take_small_table). Plain PyTorch version:
// bithtm_tpu_torch/ops/active_set.py (take_small_table_ref).
//
// Per stream b and index i of its n indices:
//   out[b, i] = table[b, idx[b, i]]   if 0 <= idx[b, i] < Wc, else 0
// A sentinel key decodes to an index >= Wc whenever Wc is not a power of
// two, so no index is trusted: the kernel never reads outside the table.
//
// Design. The TPU kernel rode the table as (Wc/128, 128) sublane rows and
// did one lane gather per 128-wide chunk, because Mosaic has no general
// gather. Here each block stages its stream's table (Wc <= 2048 words,
// at most 8 KB) in shared memory and then looks up a contiguous run of the
// stream's indices, one shared-memory load each, with 16-byte int4 index
// loads and stores where the run is aligned. The grid is (index blocks, B).
//
// Bound: bytes, 8 a lookup (idx 4 in, out 4) plus the table. At the 16K
// tuned caps (B=64, L=336, kk=32, Wc=384) that is 5.6 MB, about 1.7 us at
// the H100's 3.35 TB/s, and the kernel takes about 3 us on the device.
// What bounds a call is the host: the wrapper's checks, the output's
// allocation and the ctypes call take longer than the kernel, so the
// device waits on the next launch. The wrappers therefore pass the device
// index and the raw current stream straight through (launch.cuh) instead
// of entering a device context and building a stream object each call.

#include <cuda_runtime.h>
#include <stdint.h>

#include "launch.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxTable = 2048;          // ops/kernels.py MAX_SMALL_TABLE
constexpr int kIdxPerBlock = 4096;

__device__ __forceinline__ int lookup(const int* tab, int i, int Wc) {
  return static_cast<unsigned>(i) < static_cast<unsigned>(Wc) ? tab[i] : 0;
}

template <int VEC>
__global__ void __launch_bounds__(kThreads) small_take_kernel(
    const int* __restrict__ table, const int* __restrict__ idx,
    int* __restrict__ out, int Wc, int n) {
  __shared__ int tab[kMaxTable];
  const int b = blockIdx.y;
  for (int i = threadIdx.x; i < Wc; i += blockDim.x)
    tab[i] = table[(size_t)b * Wc + i];
  __syncthreads();

  const int s0 = blockIdx.x * kIdxPerBlock;
  const int len = min(kIdxPerBlock, n - s0);
  if (len <= 0) return;
  const size_t base = (size_t)b * n + s0;
  for (int s = threadIdx.x * VEC; s < len; s += blockDim.x * VEC) {
    const size_t i = base + s;
    if constexpr (VEC == 4) {
      const int4 k = *reinterpret_cast<const int4*>(idx + i);
      *reinterpret_cast<int4*>(out + i) =
          make_int4(lookup(tab, k.x, Wc), lookup(tab, k.y, Wc),
                    lookup(tab, k.z, Wc), lookup(tab, k.w, Wc));
    } else {
      out[i] = lookup(tab, idx[i], Wc);
    }
  }
}

}  // namespace

// table (B, Wc) int32 with Wc <= 2048, idx (B, n) int32 -> out (B, n)
// int32. Launches on the given stream of the given device, allocates
// nothing and returns cudaGetLastError() after the launch (0 = success).
extern "C" int small_table_take(const int* table, const int* idx, int* out,
                                int B, int Wc, int n, int device,
                                void* stream) {
  if (Wc < 1 || Wc > kMaxTable) return (int)cudaErrorInvalidValue;
  bithtm::DeviceGuard guard(device);
  if (int err = guard.error()) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dim3 grid((n + kIdxPerBlock - 1) / kIdxPerBlock, B);
  const bool aligned = n % 4 == 0 &&
                       reinterpret_cast<uintptr_t>(idx) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (aligned)
    small_take_kernel<4><<<grid, kThreads, 0, s>>>(table, idx, out, Wc, n);
  else
    small_take_kernel<1><<<grid, kThreads, 0, s>>>(table, idx, out, Wc, n);
  return (int)cudaGetLastError();
}
