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
// Bound: bytes. The function reads syn 4, perm 4 and act_prev 1 B a slot
// and writes v 1 B a slot and the punished permanences; act_conn reads
// syn and perm and writes v, 9 B a slot. The first schedule wrote every
// permanence back (14 B a slot). At B=256, C=2048, J=256 and at B=64,
// C=16384, J=256 alike (268M slots), 10 B a slot is 2.68 GB, 0.80 ms at
// the H100's 3.35 TB/s, and 9 B a slot 0.72 ms.
//
// Design. The TPU kernel answered "is the presynaptic cell active?" with
// a salted hash over the A active columns, because Mosaic has no cheap
// gather. Here a block holds its stream's active cells as a bitmap in
// shared memory (active_bitmap.cuh) and answers with one shared-memory
// load a slot.
//
// The first schedule gave each block 16,384 slots of one stream (grid
// (row blocks of C, B), 256 threads) and built the bitmap in every
// block. At 16384x64 that is 16,384 blocks, each zeroing 32,768 words and
// setting 20,992 cells (one atomicOr a bit) before streaming 229 KB; the
// 128 KB bitmap leaves one block an SM, so the card ran about 124 waves
// in which the build cost about as much as the streaming, and 8 warps an
// SM kept about 9 KB of loads in flight where Little's law at 3.35 TB/s
// asks for about 25 KB: 4.75 ms on an H100 for the learned 16K state.
//
// This schedule (`range_grid`, `walk_rows` in active_bitmap.cuh): one
// contiguous range of the B*C flattened rows a block, the bitmap rebuilt
// only where the range crosses into the next stream, over eight waves of
// resident blocks (at 16384x64: 1,056 blocks of about 993 rows, at most
// 2 builds each, against 16,384 builds); 1024 threads where the bitmap
// leaves one 256-thread block an SM, each thread with two groups of 4
// slots in flight (about 72 KB of loads an SM), else 256 threads with one
// group and as many blocks an SM as fit; a build of one atomicOr a word
// where D % 32 == 0 (A*W operations, not A*D); and a permanence written
// back only where its group of slots was punished.

// Two more paths, chosen by the wrapper from the shapes (ops/kernels.py):
//   - past the shared memory a block may hold (column_dim*D > 1,859,584
//     cells), the bitmap of each stream is built once into global memory
//     and read through the read-only cache (GLOBAL; active_bitmap.cuh);
//   - the packed activity v and act_prev in the type ops/active_set.py
//     `act_dtype` gives K (BYTES: u8 at K <= 125, bf16 at K = 126-127,
//     float32 from K = 128), as the plain versions hold it.
// The shared-memory u8 kernel at the main path's shapes is the one it was.
//
// In place. The step passes its activity buffer as both act_prev and
// v_out (ops/kernels.py table_update_cuda): the new activity replaces the
// previous one, and the step copies no (B, C, J) table. Each thread loads
// the act_prev values of its groups before it stores a v at the same
// index, and no other thread touches that index (the row ranges of the
// blocks are disjoint, and on the GLOBAL path the bitmap is built by a
// launch before), so the two pointers may alias: neither is __restrict__.

#include "active_bitmap.cuh"
#include "launch.cuh"

namespace {

using bithtm::Act;
using bithtm::cell_active;
using bithtm::Quad;

template <bool GLOBAL, int BYTES>
__device__ __forceinline__ typename Act<BYTES>::T slot_value(
    const uint32_t* bm, int syn, float p, int n_cells, float threshold,
    int scale) {
  const bool act = p >= 0.0f && cell_active<GLOBAL>(bm, syn, n_cells);
  return Act<BYTES>::value(act ? (p >= threshold ? 1 + scale : 1) : 0);
}

// PUNISH selects table_update (punish, write perm) over act_conn. GLOBAL:
// bms holds every stream's bitmap (build_bitmaps), else the block builds
// them in shared memory. BYTES: the activity type (Act).
template <bool PUNISH, int VEC, int THREADS, bool GLOBAL, int BYTES>
__global__ void __launch_bounds__(THREADS) table_pass_kernel(
    const int* __restrict__ syn, float* __restrict__ perm,
    const typename Act<BYTES>::T* act_prev,
    const int* __restrict__ pun_word, const int* __restrict__ cols,
    const int* __restrict__ bits, uint32_t* __restrict__ bms,
    typename Act<BYTES>::T* v_out, int B, int C,
    int column_dim, int J, int A, int W, int D, int K, float punishment,
    float threshold, int scale) {
  using T = typename Act<BYTES>::T;
  // groups of VEC slots a thread keeps in flight: two in a wide block,
  // which runs alone on its SM; one where several narrow blocks share it
  constexpr int kUnroll = THREADS == bithtm::kWideThreads ? 2 : 1;
  extern __shared__ __align__(16) uint32_t smem_bm[];
  const int n_cells = column_dim * D;
  bithtm::walk_rows<GLOBAL>(GLOBAL ? bms : smem_bm, B, C, cols, bits, A, W,
                            column_dim, D,
                            [&](const uint32_t* bm, int b, int lo, int hi) {
    // the stream's slots [lo*J, hi*J), as offsets from its first slot
    const size_t base = (size_t)b * C * J;
    const int* pw_row = pun_word + (size_t)b * C;
    const int end = hi * J;
    for (int s0 = lo * J + threadIdx.x * VEC; s0 < end;
         s0 += THREADS * VEC * kUnroll) {
      int sy[kUnroll][VEC];
      float p[kUnroll][VEC];
      T ap[kUnroll][VEC];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int s = s0 + u * THREADS * VEC;
        if (s >= end) break;
        const size_t i = base + s;
        if constexpr (VEC == 4) {
          const int4 s4 = *reinterpret_cast<const int4*>(syn + i);
          const float4 p4 = *reinterpret_cast<const float4*>(perm + i);
          sy[u][0] = s4.x; sy[u][1] = s4.y; sy[u][2] = s4.z; sy[u][3] = s4.w;
          p[u][0] = p4.x; p[u][1] = p4.y; p[u][2] = p4.z; p[u][3] = p4.w;
          if constexpr (PUNISH) {
            const Quad<T> a4 = *reinterpret_cast<const Quad<T>*>(act_prev + i);
#pragma unroll
            for (int e = 0; e < 4; ++e) ap[u][e] = a4.e[e];
          }
        } else {
          sy[u][0] = syn[i];
          p[u][0] = perm[i];
          if constexpr (PUNISH) ap[u][0] = act_prev[i];
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int s = s0 + u * THREADS * VEC;
        if (s >= end) break;
        const size_t i = base + s;
        const int c = s / J;       // VEC divides J: one row per group
        const int j0 = s - c * J;
        bool punished = false;  // perm is written back only if it changed
        if constexpr (PUNISH) {
          const uint32_t pw = static_cast<uint32_t>(pw_row[c]);
#pragma unroll
          for (int e = 0; e < VEC; ++e) {
            const int g = (j0 + e) / K;
            if (((pw >> g) & 1u) && Act<BYTES>::nonzero(ap[u][e])) {
              p[u][e] = __fsub_rn(p[u][e], punishment);
              punished = true;
            }
          }
        }
        Quad<T> v;
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          v.e[e] = slot_value<GLOBAL, BYTES>(bm, sy[u][e], p[u][e], n_cells,
                                             threshold, scale);
        if constexpr (VEC == 4) {
          if (punished)
            *reinterpret_cast<float4*>(perm + i) =
                make_float4(p[u][0], p[u][1], p[u][2], p[u][3]);
          *reinterpret_cast<Quad<T>*>(v_out + i) = v;
        } else {
          if (punished) perm[i] = p[u][0];
          v_out[i] = v.e[0];
        }
      }
    }
  });
}

template <bool PUNISH, int VEC, bool GLOBAL, int BYTES>
int grid_for(int C, int D, int device, bithtm::Grid* grid) {
  return bithtm::range_grid(
      table_pass_kernel<PUNISH, VEC, bithtm::kThreads, GLOBAL, BYTES>,
      table_pass_kernel<PUNISH, VEC, bithtm::kWideThreads, GLOBAL, BYTES>,
      GLOBAL ? 0 : bithtm::bitmap_bytes(C, D), device, grid);
}

template <bool PUNISH, int VEC, bool GLOBAL, int BYTES>
int launch(const int* syn, float* perm, const void* act_prev,
           const int* pun_word, const int* cols, const int* bits,
           uint32_t* bms, void* v_out, int B, int C, int column_dim, int J,
           int A, int W, int D, int K, float punishment, float threshold,
           int scale, int device, cudaStream_t stream) {
  using T = typename Act<BYTES>::T;
  bithtm::DeviceGuard guard(device);
  if (int err = guard.error()) return err;
  bithtm::Grid g;
  if (int err = grid_for<PUNISH, VEC, GLOBAL, BYTES>(column_dim, D, device,
                                                     &g))
    return err;
  size_t smem = 0;
  if constexpr (GLOBAL) {
    if (int err = bithtm::build_bitmaps(bms, cols, bits, B, A, W, column_dim,
                                        D, stream))
      return err;
  } else {
    smem = bithtm::bitmap_bytes(column_dim, D);
    if (smem > bithtm::kMaxShared) return (int)cudaErrorInvalidValue;
  }
  const T* ap = static_cast<const T*>(act_prev);
  T* v = static_cast<T*>(v_out);
  if (g.threads == bithtm::kWideThreads)
    table_pass_kernel<PUNISH, VEC, bithtm::kWideThreads, GLOBAL, BYTES>
        <<<g.blocks, g.threads, smem, stream>>>(
            syn, perm, ap, pun_word, cols, bits, bms, v, B, C, column_dim, J,
            A, W, D, K, punishment, threshold, scale);
  else
    table_pass_kernel<PUNISH, VEC, bithtm::kThreads, GLOBAL, BYTES>
        <<<g.blocks, g.threads, smem, stream>>>(
            syn, perm, ap, pun_word, cols, bits, bms, v, B, C, column_dim, J,
            A, W, D, K, punishment, threshold, scale);
  return (int)cudaGetLastError();
}

// The instantiation for (J % 4 == 0, a global bitmap, the activity's
// bytes), each picked at run time.
template <bool PUNISH>
int dispatch(const int* syn, float* perm, const void* act_prev,
             const int* pun_word, const int* cols, const int* bits,
             uint32_t* bms, void* v_out, int B, int C, int column_dim, int J,
             int A, int W, int D, int K, float punishment, float threshold,
             int scale, int act_bytes, int device, cudaStream_t s) {
  return bithtm::with_vec(J, [&](auto vec) {
    return bithtm::with_bool(bms != nullptr, [&](auto global) {
      return bithtm::with_bytes(act_bytes, [&](auto bytes) {
        return launch<PUNISH, decltype(vec)::value, decltype(global)::value,
                      decltype(bytes)::value>(
            syn, perm, act_prev, pun_word, cols, bits, bms, v_out, B, C,
            column_dim, J, A, W, D, K, punishment, threshold, scale, device,
            s);
      });
    });
  });
}

template <bool PUNISH>
int grid_dispatch(int C, int J, int D, int global, int act_bytes, int device,
                  bithtm::Grid* g) {
  return bithtm::with_vec(J, [&](auto vec) {
    return bithtm::with_bool(global != 0, [&](auto glob) {
      return bithtm::with_bytes(act_bytes, [&](auto bytes) {
        return grid_for<PUNISH, decltype(vec)::value, decltype(glob)::value,
                        decltype(bytes)::value>(C, D, device, g);
      });
    });
  });
}

}  // namespace

// Each entry point launches on the given stream of the given device,
// allocates nothing and returns cudaGetLastError() after the launch (0 =
// success). Tables are contiguous (B, C, J) with C*J < 2^31, 16-byte
// aligned; cols (B, A) and bits (B, A, W) int32. The bitmap spans
// column_dim*D cells: column_dim is C for a whole table, and the global
// column count for a column shard of C rows (a model-parallel rank's),
// whose synapses may target cells of any shard. bitmaps: null for the
// shared-memory bitmap, else a scratch of B * bitmap_stride(column_dim,
// D) words (16-byte aligned) that receives every stream's bitmap first.
// act_prev and v_out hold the packed activity in act_bytes bytes a value
// (1: u8, 2: bf16, 4: float32); they may be one buffer (in place).
extern "C" int table_update(const int* syn, float* perm,
                            const void* act_prev, const int* pun_word,
                            const int* cols, const int* bits,
                            uint32_t* bitmaps, void* v_out, int B, int C,
                            int column_dim, int J, int A, int W, int D,
                            int K, float punishment, float threshold,
                            int scale, int act_bytes, int device,
                            void* stream) {
  return dispatch<true>(syn, perm, act_prev, pun_word, cols, bits, bitmaps,
                        v_out, B, C, column_dim, J, A, W, D, K, punishment,
                        threshold, scale, act_bytes, device,
                        static_cast<cudaStream_t>(stream));
}

extern "C" int act_conn(const int* syn, const float* perm, const int* cols,
                        const int* bits, uint32_t* bitmaps, void* v_out,
                        int B, int C, int column_dim, int J, int A, int W,
                        int D, int K, float threshold, int scale,
                        int act_bytes, int device, void* stream) {
  float* p = const_cast<float*>(perm);  // read only: PUNISH is false
  return dispatch<false>(syn, p, nullptr, nullptr, cols, bits, bitmaps,
                         v_out, B, C, column_dim, J, A, W, D, K, 0.0f,
                         threshold, scale, act_bytes, device,
                         static_cast<cudaStream_t>(stream));
}

// The grid that table_update (punish != 0) or act_conn launches for a
// table of rows of J slots over a bitmap of C*D cells on `device`, with
// the bitmap in global memory (global != 0) or shared memory and the
// activity in act_bytes bytes a value: blocks and threads a block.
// Returns a cudaError_t as int (0 = success).
extern "C" int table_pass_grid(int punish, int C, int J, int D, int global,
                               int act_bytes, int device, int* blocks,
                               int* threads) {
  bithtm::DeviceGuard guard(device);
  if (int err = guard.error()) return err;
  bithtm::Grid g;
  const int err =
      punish ? grid_dispatch<true>(C, J, D, global, act_bytes, device, &g)
             : grid_dispatch<false>(C, J, D, global, act_bytes, device, &g);
  *blocks = g.blocks;
  *threads = g.threads;
  return err;
}
