// Full-table pass of the temporal memory, for NVIDIA Hopper (sm_90a).
//
// Replaces the two Pallas kernels of bithtm_tpu/ops/pallas_kernels.py
// that the learning and inference steps run:
//   table_update  <- table_update_tpu (pallas_kernels.py:489, body
//                    _table_kernel :400): punishment + implicit death +
//                    activation + connected activity, perm updated in place
//   act_conn      <- synapse_activation_conn_tpu (pallas_kernels.py:698,
//                    body _act_conn_kernel :375): the same activity over a
//                    read-only table
// Plain PyTorch versions: bithtm_tpu_torch/ops/active_set.py
// (table_update_ref, synapse_activation_conn_ref).
//
// Per synapse slot (b, c, j), with g = j / K:
//   perm' = perm - punishment   if bit g of pun_word[b, c] is set and
//                               act_prev[b, c, j] != 0   (table_update)
//   act   = syn >= 0 && perm' >= 0 && cell syn is in stream b's active set
//   v     = act ? (perm' >= threshold ? 1 + scale : 1) : 0      (u8)
//
// Design. The TPU kernel answered "is the presynaptic cell active?" with
// a salted hash over the A active columns, because Mosaic has no cheap
// gather. Here each block first builds its stream's active cells as a
// bitmap in shared memory (active_bitmap.cuh), then answers membership
// with one shared-memory load per slot. The grid is (row blocks of C, B);
// each thread walks its rows with 4-slot vector loads when J % 4 == 0.
//
// Bound: bytes. table_update moves 14 B/slot (syn 4, perm 4 in + 4 out,
// act_prev 1, v 1) and act_conn 9 B/slot (syn 4, perm 4, v 1); at
// B=256, C=2048, J=256 that is 1.88 GB and 1.21 GB per step, about
// 0.56 ms and 0.36 ms at the H100's 3.35 TB/s. The bitmap build costs
// C*D/32 word stores plus A*D bit tests per block, small against the
// rows each block streams.

#include "active_bitmap.cuh"

namespace {

using bithtm::build_bitmap;
using bithtm::kThreads;

constexpr int kSlotsPerBlock = 16384;

__device__ __forceinline__ uint8_t slot_value(
    const uint32_t* bm, int syn, float p, int n_cells, float threshold,
    int scale) {
  const bool act = p >= 0.0f && bithtm::cell_active(bm, syn, n_cells);
  return act ? static_cast<uint8_t>(p >= threshold ? 1 + scale : 1) : 0;
}

// PUNISH selects table_update (punish, write perm) over act_conn.
template <bool PUNISH, int VEC>
__global__ void __launch_bounds__(kThreads) table_pass_kernel(
    const int* __restrict__ syn, float* __restrict__ perm,
    const uint8_t* __restrict__ act_prev, const int* __restrict__ pun_word,
    const int* __restrict__ cols, const int* __restrict__ bits,
    uint8_t* __restrict__ v_out, int C, int J, int A, int W, int D, int K,
    int rows_per_block, float punishment, float threshold, int scale) {
  extern __shared__ uint32_t bm[];
  const int b = blockIdx.y;
  const int n_cells = C * D;
  build_bitmap(bm, (n_cells + 31) >> 5, cols + (size_t)b * A,
               bits + (size_t)b * A * W, A, W, C, D);

  const int row0 = blockIdx.x * rows_per_block;
  const int rows = min(rows_per_block, C - row0);
  if (rows <= 0) return;
  const size_t base = ((size_t)b * C + row0) * J;
  const int n = rows * J;
  for (int s = threadIdx.x * VEC; s < n; s += blockDim.x * VEC) {
    const size_t i = base + s;
    const int c = row0 + s / J;
    const int j0 = s % J;
    int sy[VEC];
    float p[VEC];
    uint8_t ap[VEC];
    uint8_t v[VEC];
    if constexpr (VEC == 4) {
      const int4 s4 = *reinterpret_cast<const int4*>(syn + i);
      const float4 p4 = *reinterpret_cast<const float4*>(perm + i);
      sy[0] = s4.x; sy[1] = s4.y; sy[2] = s4.z; sy[3] = s4.w;
      p[0] = p4.x; p[1] = p4.y; p[2] = p4.z; p[3] = p4.w;
      if constexpr (PUNISH) {
        const uchar4 a4 = *reinterpret_cast<const uchar4*>(act_prev + i);
        ap[0] = a4.x; ap[1] = a4.y; ap[2] = a4.z; ap[3] = a4.w;
      }
    } else {
      sy[0] = syn[i];
      p[0] = perm[i];
      if constexpr (PUNISH) ap[0] = act_prev[i];
    }
    if constexpr (PUNISH) {
      const uint32_t pw =
          static_cast<uint32_t>(pun_word[(size_t)b * C + c]);
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const int g = (j0 + e) / K;
        if (((pw >> g) & 1u) && ap[e] != 0) p[e] = __fsub_rn(p[e], punishment);
      }
    }
#pragma unroll
    for (int e = 0; e < VEC; ++e)
      v[e] = slot_value(bm, sy[e], p[e], n_cells, threshold, scale);
    if constexpr (VEC == 4) {
      if constexpr (PUNISH)
        *reinterpret_cast<float4*>(perm + i) =
            make_float4(p[0], p[1], p[2], p[3]);
      *reinterpret_cast<uchar4*>(v_out + i) =
          make_uchar4(v[0], v[1], v[2], v[3]);
    } else {
      if constexpr (PUNISH) perm[i] = p[0];
      v_out[i] = v[0];
    }
  }
}

template <bool PUNISH, int VEC>
int launch(const int* syn, float* perm, const uint8_t* act_prev,
           const int* pun_word, const int* cols, const int* bits,
           uint8_t* v_out, int B, int C, int J, int A, int W, int D, int K,
           float punishment, float threshold, int scale,
           cudaStream_t stream) {
  const size_t smem = bithtm::bitmap_bytes(C, D);
  auto kernel = table_pass_kernel<PUNISH, VEC>;
  if (int err = bithtm::allow_shared(kernel, smem)) return err;
  int rows_per_block = kSlotsPerBlock / J;
  if (rows_per_block < 1) rows_per_block = 1;
  if (rows_per_block > C) rows_per_block = C;
  dim3 grid((C + rows_per_block - 1) / rows_per_block, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      syn, perm, act_prev, pun_word, cols, bits, v_out, C, J, A, W, D, K,
      rows_per_block, punishment, threshold, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// Each entry point launches on the given stream, allocates nothing and
// returns cudaGetLastError() after the launch (0 = success). Tables are
// contiguous (B, C, J); cols (B, A) and bits (B, A, W) int32.
extern "C" int table_update(const int* syn, float* perm,
                            const uint8_t* act_prev, const int* pun_word,
                            const int* cols, const int* bits,
                            uint8_t* v_out, int B, int C, int J, int A,
                            int W, int D, int K, float punishment,
                            float threshold, int scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (J % 4 == 0)
    return launch<true, 4>(syn, perm, act_prev, pun_word, cols, bits, v_out,
                           B, C, J, A, W, D, K, punishment, threshold,
                           scale, s);
  return launch<true, 1>(syn, perm, act_prev, pun_word, cols, bits, v_out,
                         B, C, J, A, W, D, K, punishment, threshold, scale,
                         s);
}

extern "C" int act_conn(const int* syn, const float* perm, const int* cols,
                        const int* bits, uint8_t* v_out, int B, int C,
                        int J, int A, int W, int D, int K, float threshold,
                        int scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* p = const_cast<float*>(perm);  // read only: PUNISH is false
  if (J % 4 == 0)
    return launch<false, 4>(syn, p, nullptr, nullptr, cols, bits, v_out, B,
                            C, J, A, W, D, K, 0.0f, threshold, scale, s);
  return launch<false, 1>(syn, p, nullptr, nullptr, cols, bits, v_out, B, C,
                          J, A, W, D, K, 0.0f, threshold, scale, s);
}
