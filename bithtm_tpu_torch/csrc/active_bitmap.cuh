// The active-cell bitmap shared by every kernel of the port, and the
// row-range schedule of the kernels that read it.
//
// HTM activates exactly A columns per step; a stream's active cells come
// as cols (A,) column ids and bits (A, W) per-column cell masks (32-bit
// words, W = ceil(D/32)). Every kernel asks, per table word, "is this
// presynaptic cell active?". A block builds its stream's active set as
// a bitmap in shared memory, one bit per cell at index c*D + d (C*D bits:
// 8 KB at 2048x32, 128 KB at 16384x64; any D works, not only multiples of
// 32), and answers with one shared-memory load per word.
//
// The bitmap is what a block pays before it streams a single word, and at
// 16384x64 it is large: 32,768 words to zero and A*D = 20,992 cells to
// set, with room for one block an SM. So the kernels that stream a
// (B, rows, ...) table run a range grid (`range_grid`: kWaves times as
// many blocks as fit on the card at once) and give each block one
// contiguous range of the B*rows flattened rows (`walk_rows`). A block
// builds the
// bitmap of the stream its first row belongs to and rebuilds it only
// where its range crosses into the next stream: a range of n rows builds
// at most ceil(n / rows) + 1 bitmaps, where a grid of fixed-size row
// blocks built one per block.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

#include "launch.cuh"

namespace bithtm {

constexpr int kThreads = 256;
// Block size of a range-grid kernel where the bitmap leaves room for
// fewer than kMinResidentThreads threads an SM at kThreads a block.
constexpr int kWideThreads = 1024;
constexpr int kMinResidentThreads = 1024;
// Waves of resident blocks a range grid launches: one wave splits the rows
// statically and the slowest SM sets the time (slower at 2048x32 on an
// H100 than a grid of small blocks); with eight the hardware balances the
// last wave, and a block's range still crosses at most one stream at both
// geometries.
constexpr int kWaves = 8;

// Zeroes the n_words words of bm (16-byte aligned), 16 bytes a store.
__device__ __forceinline__ void zero_bitmap(uint32_t* bm, int n_words) {
  const int n4 = n_words >> 2;
  uint4* bm4 = reinterpret_cast<uint4*>(bm);
  for (int i = threadIdx.x; i < n4; i += blockDim.x)
    bm4[i] = make_uint4(0u, 0u, 0u, 0u);
  for (int i = (n4 << 2) + threadIdx.x; i < n_words; i += blockDim.x)
    bm[i] = 0u;
}

// Builds one stream's bitmap of C*D cells in bm (n_words words, 16-byte
// aligned). Starts and ends with every thread of the block in step, so
// the caller may read bm right after; before a rebuild the caller makes
// sure no thread still reads the old bitmap. atomicOr, not a store: a
// state's cols may repeat (an initial state holds A zeros).
__device__ __forceinline__ void build_bitmap(
    uint32_t* bm, int n_words, const int* cols, const int* bits,
    int A, int W, int C, int D) {
  zero_bitmap(bm, n_words);
  __syncthreads();
  if ((D & 31) == 0) {
    // a column's D cells are W whole bitmap words: one OR a word
    for (int t = threadIdx.x; t < A * W; t += blockDim.x) {
      const int a = t / W;
      const int col = cols[a];
      const uint32_t word = static_cast<uint32_t>(bits[t]);
      if (word != 0u && col >= 0 && col < C)
        atomicOr(&bm[col * W + (t - a * W)], word);
    }
  } else {
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
  }
  __syncthreads();
}

// Is cell (any int) in the bitmap of n_cells cells? Out of range: no.
__device__ __forceinline__ bool cell_active(const uint32_t* bm, int cell,
                                            int n_cells) {
  return cell >= 0 && cell < n_cells && ((bm[cell >> 5] >> (cell & 31)) & 1u);
}

// This block's rows [r0, r1) of n_rows: n_rows / gridDim.x each, one more
// for the first n_rows % gridDim.x blocks. A block past the rows gets an
// empty range.
__device__ __forceinline__ void block_rows(long long n_rows, long long* r0,
                                           long long* r1) {
  const long long q = n_rows / gridDim.x;
  const long long rem = n_rows % gridDim.x;
  const long long blk = blockIdx.x;
  *r0 = blk * q + (blk < rem ? blk : rem);
  *r1 = *r0 + q + (blk < rem ? 1 : 0);
}

// Walks this block's range of the B*rows flattened rows of a (B, rows,
// ...) table, one stream at a time: builds stream b's bitmap (from cols
// (B, A) and bits (B, A, W)), then calls body(b, lo, hi) for the stream's
// rows [lo, hi) of the range, as indices into the stream (0 <= lo < hi
// <= rows). Every loop bound is the same for the whole block, so the
// barriers inside are reached by every thread.
template <class Body>
__device__ __forceinline__ void walk_rows(
    uint32_t* bm, int B, int rows, const int* cols, const int* bits, int A,
    int W, int C, int D, Body&& body) {
  long long r, r1;
  block_rows((long long)B * rows, &r, &r1);
  const int n_words = (C * D + 31) >> 5;
  bool first = true;
  while (r < r1) {
    const int b = static_cast<int>(r / rows);
    const long long stream0 = (long long)b * rows;
    const long long hi = r1 < stream0 + rows ? r1 : stream0 + rows;
    if (!first) __syncthreads();  // no thread still reads the last bitmap
    build_bitmap(bm, n_words, cols + (size_t)b * A, bits + (size_t)b * A * W,
                 A, W, C, D);
    body(b, static_cast<int>(r - stream0), static_cast<int>(hi - stream0));
    r = hi;
    first = false;
  }
}

// Bytes of the bitmap of C*D cells.
inline size_t bitmap_bytes(int C, int D) {
  return (((size_t)C * D + 31) / 32) * sizeof(uint32_t);
}

struct Grid {
  int blocks = 0;
  int threads = 0;
};

// The range grid of a kernel compiled at two block sizes, `narrow`
// (kThreads) and `wide` (kWideThreads), holding `smem` bytes of bitmap:
// the narrow block where kMinResidentThreads or more of its threads fit
// on an SM, else the wide one, so that one block an SM (the 128 KB
// bitmap) still keeps enough loads in flight; and kWaves x (SMs x
// resident blocks an SM) blocks. Queried once per (kernel, device, smem)
// and cached; the cache holds kEntries pairs (the four table and word
// kernels' variants at two or three bitmap sizes fill about 14) and a
// miss only queries again. The caller has made `device` current. Returns
// a cudaError_t as int (0 = success).
template <typename Kernel>
int range_grid(Kernel narrow, Kernel wide, size_t smem, int device,
                    Grid* grid) {
  struct Entry {
    const void* kernel;
    int device;
    size_t smem;
    Grid grid;
  };
  constexpr int kEntries = 32;
  static std::mutex mu;
  static Entry cache[kEntries];
  static int used = 0;
  const void* key = reinterpret_cast<const void*>(narrow);
  std::lock_guard<std::mutex> lock(mu);
  for (int i = 0; i < used && i < kEntries; ++i) {
    const Entry& e = cache[i];
    if (e.kernel == key && e.device == device && e.smem == smem) {
      *grid = e.grid;
      return 0;
    }
  }
  // the opt-in is the kernel's, not the launch's: allow the most any
  // bitmap may take, so that no later size lowers what a cached one needs
  if (int err = allow_shared(narrow, smem > 48 * 1024 ? kMaxShared : smem))
    return err;
  if (int err = allow_shared(wide, smem > 48 * 1024 ? kMaxShared : smem))
    return err;
  int sms = 0, per_sm = 0;
  cudaError_t err =
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, narrow,
                                                        kThreads, smem);
  if (err != cudaSuccess) return (int)err;
  Grid g;
  g.threads = kThreads;
  if (per_sm * kThreads < kMinResidentThreads) {
    g.threads = kWideThreads;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, wide,
                                                        kWideThreads, smem);
    if (err != cudaSuccess) return (int)err;
  }
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  g.blocks = kWaves * sms * per_sm;
  cache[used % kEntries] = Entry{key, device, smem, g};
  ++used;
  *grid = g;
  return 0;
}

}  // namespace bithtm
