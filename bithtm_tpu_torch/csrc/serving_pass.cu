// Word-table activation passes, for NVIDIA Hopper (sm_90a).
//
// Replaces three Pallas kernels of bithtm_tpu/ops/pallas_kernels.py:
//   serving_activation <- serving_activation_tpu (pallas_kernels.py:835,
//                         body _serving_act_kernel :810): the forward pass
//                         over a compact serving table (ops/serving.py)
//   act_frozen         <- synapse_activation_frozen_tpu
//                         (pallas_kernels.py:772, body _act_frozen_kernel
//                         :739): the forward pass over the frozen word
//                         table (ops/active_set.py pack_frozen_table)
//   synapse_activation <- synapse_activation_tpu (pallas_kernels.py:661,
//                         body _act_kernel :341): the activity-only 0/1
//                         mask over a synapse cell table
// Plain PyTorch versions: bithtm_tpu_torch/ops/serving.py
// (serving_activation_ref) and bithtm_tpu_torch/ops/active_set.py
// (synapse_activation_frozen_ref, synapse_activation_ref).
//
// Per table word w of stream b:
//   serving_activation: w = cell << 5 | g (-1 = empty lane)
//       out = (w >= 0 && cell active) ? g + 1 : 0                  (u8)
//   act_frozen: w = cell (bits 0-23) | connected << 24 (-1 = dead slot)
//       out = (w >= 0 && cell active) ? (connected ? 1 + scale : 1) : 0
//   synapse_activation: w = presynaptic cell (< 0 = free slot)
//       out = cell active ? 1 : 0                                  (u8)
//
// Bound: bytes, 5 per word (4 in, 1 out), plus the active set. At B=256
// a serving table of R = 2048*M + E rows moves 0.34 GB per step for M=1
// (about 0.10 ms at the H100's 3.35 TB/s); at 16384x64, B=64, the
// learned table (R = 16384) moves 0.67 GB (0.20 ms). The frozen table at
// C=2048, J=256 moves 0.67 GB (about 0.20 ms), against act_conn's 9
// B/slot; synapse_activation moves as much as act_frozen over a table of
// the same size (1.34 GB, 0.40 ms, at 16384x64, B=64, J=256).
//
// Design. All three are elementwise over a stream's words, with the same
// question as table_pass.cu: is the presynaptic cell in this stream's
// active set? A block holds that set as a shared-memory bitmap
// (active_bitmap.cuh) and streams words with 16-byte int4 loads and
// uchar4 stores where a row's width is a multiple of 4, one word a load
// elsewhere.
//
// serving_activation and synapse_activation run the row-range schedule
// of table_pass.cu (`range_grid`, `walk_rows` in active_bitmap.cuh): one
// contiguous range of the B*R flattened rows a block (a serving row is
// 128 words, a synapse row J; a serving table's main and extension rows
// are rows alike, so one launch covers both), the bitmap rebuilt only
// where the range crosses into the next stream, over eight waves of
// resident blocks (at 16384x64, B=64: 1,056 blocks of about 993 rows, at
// most 2 builds each). 1024 threads where the bitmap leaves one
// 256-thread block an SM, each with eight groups of 4 words in flight
// (128 KB of loads an SM), else 256 threads with two groups (64 KB an SM
// at eight blocks). A word moves about half the bytes of a table slot,
// so a range streams half as long behind each bitmap build and the
// latency of its first loads; the word passes keep more groups in flight
// than table_pass.cu (two and one), which left them short of their bound
// on the card.
//
// Their first schedule gave each block 16,384 words of one stream (grid
// (word blocks, B), 256 threads) and built the bitmap in every block: at
// 16384x64 that is 8,192 blocks for a serve and 16,384 for
// synapse_activation, each zeroing 32,768 words before streaming 80 KB,
// with one block and about 4 KB of loads in flight an SM: 0.98 and 1.69
// ms on an H100, against bounds of 0.20 and 0.40. act_frozen keeps that
// schedule (`word_pass_kernel`): at the bench shapes it streams at 86% of
// its bound.
//
// The paths past the main path's shapes, chosen by the wrapper from the
// shapes (ops/kernels.py): all three kernels read a bitmap built once
// into global memory where column_dim*D > 1,859,584 cells (GLOBAL;
// active_bitmap.cuh); act_frozen writes the packed activity in the type
// of `act_dtype` (BYTES: u8, bf16 or float32, as table_pass.cu) and, past
// 65,535 streams, folds the stream into grid x (FOLD: grid (word blocks x
// B)) where the grid's y extent would not hold them.

#include "active_bitmap.cuh"
#include "launch.cuh"

namespace {

using bithtm::Act;
using bithtm::build_bitmap;
using bithtm::cell_active;
using bithtm::kThreads;
using bithtm::Quad;

constexpr int kWordsPerBlock = 16384;  // act_frozen's block
constexpr int kServingWidth = 128;     // words a serving row
constexpr int kServingGBits = 5;   // ops/serving.py SERVING_G_BITS
constexpr int kFrozenCellBits = 24;  // ops/active_set.py FROZEN_CELL_BITS

// Each op maps a word to its value (an int that fits the output type).
struct ServingWord {
  template <bool GLOBAL>
  __device__ __forceinline__ int at(const uint32_t* bm, int w,
                                    int n_cells) const {
    if (w < 0) return 0;
    const int g = w & ((1 << kServingGBits) - 1);
    return cell_active<GLOBAL>(bm, w >> kServingGBits, n_cells) ? g + 1 : 0;
  }
};

struct FrozenWord {
  int scale;
  template <bool GLOBAL>
  __device__ __forceinline__ int at(const uint32_t* bm, int w,
                                    int n_cells) const {
    if (w < 0) return 0;
    const int cell = w & ((1 << kFrozenCellBits) - 1);
    const bool conn = (w >> kFrozenCellBits) == 1;
    return cell_active<GLOBAL>(bm, cell, n_cells) ? (conn ? 1 + scale : 1)
                                                  : 0;
  }
};

struct ActivityWord {
  template <bool GLOBAL>
  __device__ __forceinline__ int at(const uint32_t* bm, int w,
                                    int n_cells) const {
    return cell_active<GLOBAL>(bm, w, n_cells) ? 1 : 0;
  }
};

// The frozen pass (act_frozen): out[b, i] = op(bm_b, words[b, i]) for
// i < n, the n words of stream b; a block of kWordsPerBlock words of one
// stream, each block building its stream's bitmap (or, GLOBAL, reading
// it from bms). The block's stream is blockIdx.y, or with FOLD blockIdx.x
// / blocks_per_stream.
template <int VEC, bool GLOBAL, bool FOLD, int BYTES>
__global__ void __launch_bounds__(kThreads) word_pass_kernel(
    const int* __restrict__ words, const int* __restrict__ cols,
    const int* __restrict__ bits, const uint32_t* __restrict__ bms,
    typename Act<BYTES>::T* __restrict__ out, int n, int blocks_per_stream,
    int A, int W, int C, int D, FrozenWord op) {
  using T = typename Act<BYTES>::T;
  extern __shared__ __align__(16) uint32_t smem_bm[];
  const size_t b = FOLD ? blockIdx.x / blocks_per_stream : blockIdx.y;
  const int bx = FOLD ? blockIdx.x - (int)(b * blocks_per_stream)
                      : (int)blockIdx.x;
  const int n_cells = C * D;
  const uint32_t* bm = smem_bm;
  if constexpr (GLOBAL) {
    bm = bms + b * bithtm::bitmap_stride(C, D);
  } else {
    build_bitmap(smem_bm, (n_cells + 31) >> 5, cols + b * A,
                 bits + b * A * W, A, W, C, D);
  }

  const int s0 = bx * kWordsPerBlock;
  const int len = min(kWordsPerBlock, n - s0);
  if (len <= 0) return;
  const size_t base = b * n + s0;
  for (int s = threadIdx.x * VEC; s < len; s += blockDim.x * VEC) {
    const size_t i = base + s;
    if constexpr (VEC == 4) {
      const int4 w = *reinterpret_cast<const int4*>(words + i);
      Quad<T> v;
      v.e[0] = Act<BYTES>::value(op.template at<GLOBAL>(bm, w.x, n_cells));
      v.e[1] = Act<BYTES>::value(op.template at<GLOBAL>(bm, w.y, n_cells));
      v.e[2] = Act<BYTES>::value(op.template at<GLOBAL>(bm, w.z, n_cells));
      v.e[3] = Act<BYTES>::value(op.template at<GLOBAL>(bm, w.w, n_cells));
      *reinterpret_cast<Quad<T>*>(out + i) = v;
    } else {
      out[i] = Act<BYTES>::value(op.template at<GLOBAL>(bm, words[i],
                                                        n_cells));
    }
  }
}

template <int VEC, bool GLOBAL, bool FOLD, int BYTES>
int launch_frozen(const int* words, const int* cols, const int* bits,
                  uint32_t* bms, void* out, int B, int n, int A, int W,
                  int C, int D, FrozenWord op, cudaStream_t stream) {
  auto kernel = word_pass_kernel<VEC, GLOBAL, FOLD, BYTES>;
  size_t smem = 0;
  if constexpr (GLOBAL) {
    if (int err = bithtm::build_bitmaps(bms, cols, bits, B, A, W, C, D,
                                        stream))
      return err;
  } else {
    smem = bithtm::bitmap_bytes(C, D);
    if (smem > bithtm::kMaxShared) return (int)cudaErrorInvalidValue;
    if (int err = bithtm::allow_shared(kernel, smem)) return err;
  }
  const int per_stream = (n + kWordsPerBlock - 1) / kWordsPerBlock;
  const dim3 grid = FOLD ? dim3((unsigned)((size_t)per_stream * B), 1)
                         : dim3(per_stream, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      words, cols, bits, bms, static_cast<typename Act<BYTES>::T*>(out), n,
      per_stream, A, W, C, D, op);
  return (int)cudaGetLastError();
}

// The row-range word pass: out[b, r, j] = op(bm_b, words[b, r, j]) for
// the rows r of each stream b in this block's range of the B*rows
// flattened rows of width words each. VEC (4 or 1) divides width.
template <class Op, int VEC, int THREADS, bool GLOBAL>
__global__ void __launch_bounds__(THREADS) word_range_kernel(
    const int* __restrict__ words, const int* __restrict__ cols,
    const int* __restrict__ bits, uint32_t* __restrict__ bms,
    uint8_t* __restrict__ out, int B, int rows, int width, int A, int W,
    int C, int D, Op op) {
  // groups of VEC words a thread keeps in flight: eight in a wide block,
  // which runs alone on its SM; two where several narrow blocks share it
  constexpr int kUnroll = THREADS == bithtm::kWideThreads ? 8 : 2;
  extern __shared__ __align__(16) uint32_t smem_bm[];
  const int n_cells = C * D;
  bithtm::walk_rows<GLOBAL>(GLOBAL ? bms : smem_bm, B, rows, cols, bits, A,
                            W, C, D,
                            [&](const uint32_t* bm, int b, int lo, int hi) {
    // the stream's words [lo*width, hi*width), as offsets from its first
    const size_t base = (size_t)b * rows * width;
    const int end = hi * width;
    for (int s0 = lo * width + threadIdx.x * VEC; s0 < end;
         s0 += THREADS * VEC * kUnroll) {
      int w[kUnroll][VEC];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int s = s0 + u * THREADS * VEC;
        if (s >= end) break;
        if constexpr (VEC == 4) {
          const int4 w4 = *reinterpret_cast<const int4*>(words + base + s);
          w[u][0] = w4.x; w[u][1] = w4.y; w[u][2] = w4.z; w[u][3] = w4.w;
        } else {
          w[u][0] = words[base + s];
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int s = s0 + u * THREADS * VEC;
        if (s >= end) break;
        if constexpr (VEC == 4) {
          *reinterpret_cast<uchar4*>(out + base + s) = make_uchar4(
              op.template at<GLOBAL>(bm, w[u][0], n_cells),
              op.template at<GLOBAL>(bm, w[u][1], n_cells),
              op.template at<GLOBAL>(bm, w[u][2], n_cells),
              op.template at<GLOBAL>(bm, w[u][3], n_cells));
        } else {
          out[base + s] = op.template at<GLOBAL>(bm, w[u][0], n_cells);
        }
      }
    }
  });
}

template <class Op, int VEC, bool GLOBAL>
int grid_for(int C, int D, int device, bithtm::Grid* grid) {
  return bithtm::range_grid(
      word_range_kernel<Op, VEC, bithtm::kThreads, GLOBAL>,
      word_range_kernel<Op, VEC, bithtm::kWideThreads, GLOBAL>,
      GLOBAL ? 0 : bithtm::bitmap_bytes(C, D), device, grid);
}

template <class Op, int VEC, bool GLOBAL>
int launch_range(const int* words, const int* cols, const int* bits,
                 uint32_t* bms, uint8_t* out, int B, int rows, int width,
                 int A, int W, int C, int D, Op op, int device,
                 cudaStream_t stream) {
  bithtm::DeviceGuard guard(device);
  if (int err = guard.error()) return err;
  bithtm::Grid g;
  if (int err = grid_for<Op, VEC, GLOBAL>(C, D, device, &g)) return err;
  size_t smem = 0;
  if constexpr (GLOBAL) {
    if (int err = bithtm::build_bitmaps(bms, cols, bits, B, A, W, C, D,
                                        stream))
      return err;
  } else {
    smem = bithtm::bitmap_bytes(C, D);
    if (smem > bithtm::kMaxShared) return (int)cudaErrorInvalidValue;
  }
  if (g.threads == bithtm::kWideThreads)
    word_range_kernel<Op, VEC, bithtm::kWideThreads, GLOBAL>
        <<<g.blocks, g.threads, smem, stream>>>(
            words, cols, bits, bms, out, B, rows, width, A, W, C, D, op);
  else
    word_range_kernel<Op, VEC, bithtm::kThreads, GLOBAL>
        <<<g.blocks, g.threads, smem, stream>>>(
            words, cols, bits, bms, out, B, rows, width, A, W, C, D, op);
  return (int)cudaGetLastError();
}

// launch_range with the bitmap in global memory where bms is not null.
template <class Op, int VEC>
int launch_range_any(const int* words, const int* cols, const int* bits,
                     uint32_t* bms, uint8_t* out, int B, int rows, int width,
                     int A, int W, int C, int D, Op op, int device,
                     cudaStream_t stream) {
  return bithtm::with_bool(bms != nullptr, [&](auto global) {
    return launch_range<Op, VEC, decltype(global)::value>(
        words, cols, bits, bms, out, B, rows, width, A, W, C, D, op, device,
        stream);
  });
}

}  // namespace

// Each entry point launches on the given stream of the given device,
// allocates nothing and returns cudaGetLastError() after the launch (0 =
// success). Tables are contiguous and 16-byte aligned, with fewer than
// 2^31 words a stream; cols (B, A) and bits (B, A, W) int32, as in
// table_pass.cu. bitmaps: null for the shared-memory bitmap, else a
// scratch of B * bitmap_stride(C, D) words (16-byte aligned) that
// receives every stream's bitmap first (active_bitmap.cuh).

// rows (B, R, 128) int32 serving words -> out (B, R, 128) u8.
extern "C" int serving_activation(const int* rows, const int* cols,
                                  const int* bits, uint32_t* bitmaps,
                                  uint8_t* out, int B, int R, int A, int W,
                                  int C, int D, int device, void* stream) {
  return launch_range_any<ServingWord, 4>(
      rows, cols, bits, bitmaps, out, B, R, kServingWidth, A, W, C, D,
      ServingWord{}, device, static_cast<cudaStream_t>(stream));
}

// word (B, C, J) int32 frozen words -> v_out (B, C, J), the packed
// activity in act_bytes bytes a value (1: u8, 2: bf16, 4: float32);
// fold != 0 puts the streams in grid x (B > 65,535).
extern "C" int act_frozen(const int* word, const int* cols, const int* bits,
                          uint32_t* bitmaps, void* v_out, int B, int C,
                          int J, int A, int W, int D, int scale,
                          int act_bytes, int fold, int device,
                          void* stream) {
  bithtm::DeviceGuard guard(device);
  if (int err = guard.error()) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n = C * J;
  const FrozenWord op{scale};
  return bithtm::with_vec(n, [&](auto vec) {
    return bithtm::with_bool(bitmaps != nullptr, [&](auto global) {
      return bithtm::with_bool(fold != 0, [&](auto folded) {
        return bithtm::with_bytes(act_bytes, [&](auto bytes) {
          return launch_frozen<decltype(vec)::value, decltype(global)::value,
                               decltype(folded)::value,
                               decltype(bytes)::value>(
              word, cols, bits, bitmaps, v_out, B, n, A, W, C, D, op, s);
        });
      });
    });
  });
}

// syn (B, R, J) int32 presynaptic cells -> out (B, R, J) u8 0/1, over the
// bitmap of C*D cells.
extern "C" int synapse_activation(const int* syn, const int* cols,
                                  const int* bits, uint32_t* bitmaps,
                                  uint8_t* out, int B, int R, int J, int A,
                                  int W, int C, int D, int device,
                                  void* stream) {
  return bithtm::with_vec(J, [&](auto vec) {
    return launch_range_any<ActivityWord, decltype(vec)::value>(
        syn, cols, bits, bitmaps, out, B, R, J, A, W, C, D, ActivityWord{},
        device, static_cast<cudaStream_t>(stream));
  });
}

// The grid that serving_activation (serving != 0: rows of 128 words, J
// unused) or synapse_activation (rows of J words) launches over a bitmap
// of C*D cells in global memory (global != 0) or shared memory on
// `device`: blocks and threads a block. Returns a cudaError_t as int (0
// = success).
extern "C" int word_pass_grid(int serving, int C, int J, int D, int global,
                              int device, int* blocks, int* threads) {
  bithtm::DeviceGuard guard(device);
  if (int err = guard.error()) return err;
  bithtm::Grid g;
  const int err = bithtm::with_bool(global != 0, [&](auto glob) {
    constexpr bool G = decltype(glob)::value;
    if (serving) return grid_for<ServingWord, 4, G>(C, D, device, &g);
    return bithtm::with_vec(J, [&](auto vec) {
      return grid_for<ActivityWord, decltype(vec)::value, G>(C, D, device,
                                                             &g);
    });
  });
  *blocks = g.blocks;
  *threads = g.threads;
  return err;
}
