// The active-cell bitmap shared by every kernel of the port.
//
// HTM activates exactly A columns per step; a stream's active cells come
// as cols (A,) column ids and bits (A, W) per-column cell masks (32-bit
// words, W = ceil(D/32)). Every kernel asks, per table word, "is this
// presynaptic cell active?". Each block builds its stream's active set as
// a bitmap in shared memory, one bit per cell at index c*D + d (C*D bits:
// 8 KB at 2048x32, 128 KB at 16384x64; any D works, not only multiples of
// 32), and answers with one shared-memory load per word.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace bithtm {

constexpr int kThreads = 256;

__device__ __forceinline__ void build_bitmap(
    uint32_t* bm, int n_words, const int* cols, const int* bits,
    int A, int W, int C, int D) {
  for (int i = threadIdx.x; i < n_words; i += blockDim.x) bm[i] = 0u;
  __syncthreads();
  for (int t = threadIdx.x; t < A * D; t += blockDim.x) {
    const int a = t / D;
    const int d = t - a * D;
    const int col = cols[a];
    const uint32_t word = static_cast<uint32_t>(bits[a * W + (d >> 5)]);
    if (col >= 0 && col < C && ((word >> (d & 31)) & 1u)) {
      const int cell = col * D + d;
      atomicOr(&bm[cell >> 5], 1u << (cell & 31));
    }
  }
  __syncthreads();
}

// Is cell (any int) in the bitmap of n_cells cells? Out of range: no.
__device__ __forceinline__ bool cell_active(const uint32_t* bm, int cell,
                                            int n_cells) {
  return cell >= 0 && cell < n_cells && ((bm[cell >> 5] >> (cell & 31)) & 1u);
}

// Bytes of the bitmap of C*D cells.
inline size_t bitmap_bytes(int C, int D) {
  return (((size_t)C * D + 31) / 32) * sizeof(uint32_t);
}

// Lets `kernel` take `smem` bytes of dynamic shared memory (needed above
// 48 KB). Returns a cudaError_t as int (0 = success).
template <typename Kernel>
int allow_shared(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

}  // namespace bithtm
