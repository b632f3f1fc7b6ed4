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
// Design. All three are elementwise over a stream's words, with the same
// question as table_pass.cu: is the presynaptic cell in this stream's
// active set? Each block builds that set as a shared-memory bitmap
// (active_bitmap.cuh) and then streams a contiguous run of the stream's
// words with 16-byte int4 loads and uchar4 stores. The grid is
// (word blocks, B); a serving table's main and extension rows are one
// run of R*128 words, so one launch covers both.
//
// Bound: bytes, 5 per word (4 in, 1 out). At B=256 a serving table of
// R = 2048*M + E rows moves 0.34 GB per step for M=1 (about 0.10 ms at
// the H100's 3.35 TB/s); the frozen table at C=2048, J=256 moves 0.67 GB
// (about 0.20 ms), against act_conn's 9 B/slot; synapse_activation moves
// as much as act_frozen over a table of the same size.

#include "active_bitmap.cuh"
#include "launch.cuh"

namespace {

using bithtm::build_bitmap;
using bithtm::cell_active;
using bithtm::kThreads;

constexpr int kWordsPerBlock = 16384;
constexpr int kServingGBits = 5;   // ops/serving.py SERVING_G_BITS
constexpr int kFrozenCellBits = 24;  // ops/active_set.py FROZEN_CELL_BITS

struct ServingWord {
  __device__ __forceinline__ uint8_t operator()(const uint32_t* bm, int w,
                                                int n_cells) const {
    if (w < 0) return 0;
    const int g = w & ((1 << kServingGBits) - 1);
    return cell_active(bm, w >> kServingGBits, n_cells)
               ? static_cast<uint8_t>(g + 1) : 0;
  }
};

struct FrozenWord {
  int scale;
  __device__ __forceinline__ uint8_t operator()(const uint32_t* bm, int w,
                                                int n_cells) const {
    if (w < 0) return 0;
    const int cell = w & ((1 << kFrozenCellBits) - 1);
    const bool conn = (w >> kFrozenCellBits) == 1;
    return cell_active(bm, cell, n_cells)
               ? static_cast<uint8_t>(conn ? 1 + scale : 1) : 0;
  }
};

struct ActivityWord {
  __device__ __forceinline__ uint8_t operator()(const uint32_t* bm, int w,
                                                int n_cells) const {
    return cell_active(bm, w, n_cells) ? 1 : 0;
  }
};

// out[b, i] = op(bm_b, words[b, i]) for i < n, the n words of stream b.
template <class Op, int VEC>
__global__ void __launch_bounds__(kThreads) word_pass_kernel(
    const int* __restrict__ words, const int* __restrict__ cols,
    const int* __restrict__ bits, uint8_t* __restrict__ out, int n, int A,
    int W, int C, int D, Op op) {
  extern __shared__ __align__(16) uint32_t bm[];
  const int b = blockIdx.y;
  const int n_cells = C * D;
  build_bitmap(bm, (n_cells + 31) >> 5, cols + (size_t)b * A,
               bits + (size_t)b * A * W, A, W, C, D);

  const int s0 = blockIdx.x * kWordsPerBlock;
  const int len = min(kWordsPerBlock, n - s0);
  if (len <= 0) return;
  const size_t base = (size_t)b * n + s0;
  for (int s = threadIdx.x * VEC; s < len; s += blockDim.x * VEC) {
    const size_t i = base + s;
    if constexpr (VEC == 4) {
      const int4 w = *reinterpret_cast<const int4*>(words + i);
      *reinterpret_cast<uchar4*>(out + i) =
          make_uchar4(op(bm, w.x, n_cells), op(bm, w.y, n_cells),
                      op(bm, w.z, n_cells), op(bm, w.w, n_cells));
    } else {
      out[i] = op(bm, words[i], n_cells);
    }
  }
}

template <class Op, int VEC>
int launch(const int* words, const int* cols, const int* bits, uint8_t* out,
           int B, int n, int A, int W, int C, int D, Op op, int device,
           cudaStream_t stream) {
  bithtm::DeviceGuard guard(device);
  if (int err = guard.error()) return err;
  const size_t smem = bithtm::bitmap_bytes(C, D);
  auto kernel = word_pass_kernel<Op, VEC>;
  if (int err = bithtm::allow_shared(kernel, smem)) return err;
  dim3 grid((n + kWordsPerBlock - 1) / kWordsPerBlock, B);
  kernel<<<grid, kThreads, smem, stream>>>(words, cols, bits, out, n, A, W,
                                           C, D, op);
  return (int)cudaGetLastError();
}

}  // namespace

// Each entry point launches on the given stream of the given device,
// allocates nothing and returns cudaGetLastError() after the launch (0 =
// success). cols (B, A) and bits (B, A, W) int32, as in table_pass.cu.

// rows (B, R, 128) int32 serving words -> out (B, R, 128) u8.
extern "C" int serving_activation(const int* rows, const int* cols,
                                  const int* bits, uint8_t* out, int B,
                                  int R, int A, int W, int C, int D,
                                  int device, void* stream) {
  return launch<ServingWord, 4>(rows, cols, bits, out, B, R * 128, A, W, C,
                                D, ServingWord{}, device,
                                static_cast<cudaStream_t>(stream));
}

// word (B, C, J) int32 frozen words -> v_out (B, C, J) u8.
extern "C" int act_frozen(const int* word, const int* cols, const int* bits,
                          uint8_t* v_out, int B, int C, int J, int A, int W,
                          int D, int scale, int device, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n = C * J;
  if (n % 4 == 0)
    return launch<FrozenWord, 4>(word, cols, bits, v_out, B, n, A, W, C, D,
                                 FrozenWord{scale}, device, s);
  return launch<FrozenWord, 1>(word, cols, bits, v_out, B, n, A, W, C, D,
                               FrozenWord{scale}, device, s);
}

// syn (B, R, J) int32 presynaptic cells -> out (B, R, J) u8 0/1, over the
// bitmap of C*D cells.
extern "C" int synapse_activation(const int* syn, const int* cols,
                                  const int* bits, uint8_t* out, int B,
                                  int R, int J, int A, int W, int C, int D,
                                  int device, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n = R * J;
  if (n % 4 == 0)
    return launch<ActivityWord, 4>(syn, cols, bits, out, B, n, A, W, C, D,
                                   ActivityWord{}, device, s);
  return launch<ActivityWord, 1>(syn, cols, bits, out, B, n, A, W, C, D,
                                 ActivityWord{}, device, s);
}
