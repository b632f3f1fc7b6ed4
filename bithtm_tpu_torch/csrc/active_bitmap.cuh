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
//
// Past the shared memory a block may hold (C*D > 8 * 232,448 cells: 32K x
// 64 and wider, or a column shard of such a model), the bitmap lives in
// global memory instead: one pass (`build_bitmaps_kernel`, a block a
// stream) builds every stream's bitmap of C*D/8 bytes into a scratch
// buffer that the wrapper allocates (256 KB a stream at 32768x64, 16 MB
// at B=64, which the H100's 50 MB L2 holds), and the kernels read it
// through the read-only cache (`cell_active<true>`). `walk_rows<true>`
// then builds nothing: a block only moves to the next stream's bitmap.
// The shared-memory path stays as it was for every shape at or under the
// limit.

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
// GLOBAL: bm lies in global memory, written by an earlier kernel, and is
// read through the read-only cache; else it lies in shared memory.
template <bool GLOBAL = false>
__device__ __forceinline__ bool cell_active(const uint32_t* bm, int cell,
                                            int n_cells) {
  if (cell < 0 || cell >= n_cells) return false;
  const uint32_t word = GLOBAL ? __ldg(bm + (cell >> 5)) : bm[cell >> 5];
  return (word >> (cell & 31)) & 1u;
}

// Words from one stream's bitmap to the next in a global scratch buffer:
// the bitmap's words rounded up to 16 bytes, so that each starts aligned.
__host__ __device__ __forceinline__ size_t bitmap_stride(int C, int D) {
  return (((size_t)C * D + 31) / 32 + 3) / 4 * 4;
}

// Builds stream blockIdx.x's bitmap of C*D cells at bms + b * stride
// (bitmap_stride(C, D) words a stream): the global-memory path. Static:
// each source that includes this header has its own copy.
static __global__ void __launch_bounds__(1024) build_bitmaps_kernel(
    uint32_t* __restrict__ bms, const int* __restrict__ cols,
    const int* __restrict__ bits, int A, int W, int C, int D) {
  const size_t b = blockIdx.x;
  build_bitmap(bms + b * bitmap_stride(C, D),
               static_cast<int>(((size_t)C * D + 31) >> 5), cols + b * A,
               bits + b * A * W, A, W, C, D);
}

// Launches build_bitmaps_kernel over B streams on `stream`. Returns a
// cudaError_t as int (0 = success).
inline int build_bitmaps(uint32_t* bms, const int* cols, const int* bits,
                         int B, int A, int W, int C, int D,
                         cudaStream_t stream) {
  if (B > 0)
    build_bitmaps_kernel<<<B, 1024, 0, stream>>>(bms, cols, bits, A, W, C, D);
  return (int)cudaGetLastError();
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
// ...) table, one stream at a time: builds stream b's bitmap in the
// shared bm (from cols (B, A) and bits (B, A, W)), or with GLOBAL takes
// stream b's from the bitmaps that build_bitmaps wrote at bm, then calls
// body(bm_b, b, lo, hi) with that bitmap for the stream's rows [lo, hi)
// of the range, as indices into the stream (0 <= lo < hi <= rows). Every
// loop bound is the same for the whole block, so the barriers inside are
// reached by every thread.
template <bool GLOBAL, class Body>
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
    const uint32_t* bm_b = bm;
    if constexpr (GLOBAL) {
      bm_b = bm + (size_t)b * bitmap_stride(C, D);
    } else {
      if (!first) __syncthreads();  // no thread still reads the last bitmap
      build_bitmap(bm, n_words, cols + (size_t)b * A,
                   bits + (size_t)b * A * W, A, W, C, D);
    }
    body(bm_b, b, static_cast<int>(r - stream0),
         static_cast<int>(hi - stream0));
    r = hi;
    first = false;
  }
}

// Bytes of the bitmap of C*D cells.
inline size_t bitmap_bytes(int C, int D) {
  return (((size_t)C * D + 31) / 32) * sizeof(uint32_t);
}

// The packed activity of a slot, v = 0, 1 or 1 + scale, in the type that
// ops/active_set.py `act_dtype` gives K, held as its bits: u8 (BYTES 1)
// at K <= 125, bf16 (2) at K = 126-127 and float32 (4) from K = 128.
// Every value is exact in each type, and the top 16 bits of a float32
// with 8 significant bits or fewer are its bf16 (129 = 0x4301).
template <int BYTES>
struct Act;
template <>
struct Act<1> {
  using T = uint8_t;
  __device__ __forceinline__ static T value(int v) {
    return static_cast<T>(v);
  }
  __device__ __forceinline__ static bool nonzero(T x) { return x != 0; }
};
template <>
struct Act<2> {
  using T = uint16_t;
  __device__ __forceinline__ static T value(int v) {
    return static_cast<T>(__float_as_uint(static_cast<float>(v)) >> 16);
  }
  // != 0 as a value: -0.0 is zero and NaN is not, as torch's `!= 0`
  __device__ __forceinline__ static bool nonzero(T x) {
    return (x & 0x7fffu) != 0;
  }
};
template <>
struct Act<4> {
  using T = uint32_t;
  __device__ __forceinline__ static T value(int v) {
    return __float_as_uint(static_cast<float>(v));
  }
  __device__ __forceinline__ static bool nonzero(T x) {
    return (x & 0x7fffffffu) != 0;
  }
};

// Four values of T loaded or stored as one vector: 4 bytes (as uchar4),
// 8 or 16.
template <typename T>
struct alignas(4 * sizeof(T)) Quad {
  T e[4];
};

struct Grid {
  int blocks = 0;
  int threads = 0;
};

// The range grid of a kernel compiled at two block sizes, `narrow`
// (kThreads) and `wide` (kWideThreads), holding `smem` bytes of bitmap:
// the narrow block where kMinResidentThreads or more of its threads fit
// on an SM, else the wide one, so that one block an SM (the 128 KB
// bitmap) still keeps enough loads in flight; and `waves` (default
// kWaves) x (SMs x resident blocks an SM) blocks. Queried once per
// (kernel, device, smem) and cached; the cache holds kEntries pairs (the
// four table and word kernels' variants at two or three bitmap sizes
// fill about 14, `serving_counts`' about 8 more) and a miss only
// queries again. The caller has made `device` current. Returns
// a cudaError_t as int (0 = success).
template <typename Kernel>
int range_grid(Kernel narrow, Kernel wide, size_t smem, int device,
               Grid* grid, int waves = kWaves) {
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
  g.blocks = waves * sms * per_sm;
  cache[used % kEntries] = Entry{key, device, smem, g};
  ++used;
  *grid = g;
  return 0;
}

}  // namespace bithtm
