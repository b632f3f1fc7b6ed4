// The free-slot fill of the TM's synapse growth, for NVIDIA Hopper
// (sm_90a).
//
// Stands for the end of the JAX package's _grow and the fill half of
// _select_and_fill (bithtm_tpu/models/temporal_memory.py:350-498 and
// :221-347: free_rank, the one-hot gather of the chosen cells, the
// scatters of the grown rows back, the permanence write, the counts),
// which XLA fuses into a few passes over the compacted rows. The TPU
// package has no Pallas kernel for it. Plain PyTorch version:
// bithtm_tpu_torch/models/temporal_memory.py (grow_fill_ref).
//
// Per stream b and row l of the growing-row list (grow_pass.cu: lidx,
// lvalid, chosen, n_chosen; the row's K slots syn[b, lidx[l]]):
//   free       = the row's slots with syn < 0, ranked in slot order
//   slot k     takes chosen[l, free_rank[k]] where free_rank[k] <
//              n_chosen[l]: syn = that cell, perm = permanence_initial,
//              wrote = 1 (wrote is zero elsewhere: the caller zeroes it)
//   counts[0]  += the slots written (min(n_free, n_chosen) a row)
//   counts[1]  += max(n_chosen - n_free, 0) over the valid rows
// syn and perm are updated in place; the counts are integer atomics,
// exact in any order (grow_select zeroes both rows of counts).
//
// Bound: bytes. The list (lidx, lvalid, n_chosen: 9 bytes a row) once,
// for each row that takes a cell its K slots and its n_chosen cells, and
// 9 bytes for each slot written (syn, perm, wrote). At the bench (B=256,
// L=88, K=64) that is a few MB, about 1-2 us at 3.35 TB/s.
//
// Design. A warp takes a row, 8 warps a block, the grid B x groups of
// rows as in grow_select, enough blocks to fill the card. A warp first
// reads the list entries of up to 32 of its rows at once (one load a
// lane), and skips the rows that take nothing, so a row costs one load
// round: its slots, with its chosen cells read beside them (path
// "shfl": kk <= 32, one cell a lane, passed to the slot by a shuffle;
// path "load": wider rows, each written slot reads its cell). A ballot
// over each 32 slots ranks the free ones. The warps' counts meet in
// shared memory, then one atomic a block and count.

#include <cuda_runtime.h>
#include <stdint.h>

#include "launch.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 8;

template <bool kShfl>
__global__ void __launch_bounds__(kWarps * 32) grow_fill_kernel(
    int* __restrict__ syn, float* __restrict__ perm,
    uint8_t* __restrict__ wrote, const int* __restrict__ lidx,
    const uint8_t* __restrict__ lvalid, const int* __restrict__ chosen,
    const int* __restrict__ n_chosen, int* __restrict__ counts, int B,
    int R, int K, int L, int kk, float perm_init, int rows_per_block,
    int groups) {
  __shared__ int sums[2];
  const int b = blockIdx.x / groups;
  const int group = blockIdx.x - b * groups;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nw = blockDim.x >> 5;
  const int row0 = group * rows_per_block;
  const int row_end = min(L, row0 + rows_per_block);
  const long long bL = (long long)b * L;
  const unsigned below = (1u << lane) - 1u;
  if (threadIdx.x < 2) sums[threadIdx.x] = 0;
  __syncthreads();

  int grown = 0, over = 0;  // lane 0's sums over the warp's rows
  for (int j0 = 0;; j0 += 32) {
    const int q0 = row0 + warp + j0 * nw;
    if (q0 >= row_end) break;
    const int ql = q0 + lane * nw;
    int r_l = 0, n_l = 0;
    if (ql < row_end && lvalid[bL + ql]) {
      r_l = lidx[bL + ql];
      n_l = n_chosen[bL + ql];
    }
    // the rows of the batch that take a cell
    for (unsigned take = __ballot_sync(kFull, n_l > 0); take;
         take &= take - 1) {
      const int j = __ffs(take) - 1;
      const int r = __shfl_sync(kFull, r_l, j);
      const int n = __shfl_sync(kFull, n_l, j);
      const int* cells = chosen + (bL + q0 + j * nw) * kk;
      const int cell_l = kShfl && lane < kk ? cells[lane] : 0;
      const long long slot = ((long long)b * R + r) * K;
      int ranked = 0;
      for (int k0 = 0; k0 < K; k0 += 32) {
        const int k = k0 + lane;
        const bool free = k < K && syn[slot + k] < 0;
        const unsigned ballot = __ballot_sync(kFull, free);
        const int fr = ranked + __popc(ballot & below);
        ranked += __popc(ballot);
        const int cell = kShfl ? __shfl_sync(kFull, cell_l, fr & 31) : 0;
        if (free && fr < n) {
          syn[slot + k] = kShfl ? cell : cells[fr];
          perm[slot + k] = perm_init;
          wrote[slot + k] = 1;
        }
      }
      if (lane == 0) {
        grown += min(ranked, n);
        over += max(n - ranked, 0);
      }
    }
  }
  if (lane == 0 && (grown | over)) {
    atomicAdd(&sums[0], grown);
    atomicAdd(&sums[1], over);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    if (sums[0]) atomicAdd(counts + b, sums[0]);
    if (sums[1]) atomicAdd(counts + B + b, sums[1]);
  }
}

template <bool kShfl>
int launch(int* syn, float* perm, uint8_t* wrote, const int* lidx,
           const uint8_t* lvalid, const int* chosen, const int* n_chosen,
           int* counts, int B, int R, int K, int L, int kk, float perm_init,
           cudaStream_t stream) {
  // as grow_select: enough blocks for every SM to hold 2048 threads, at
  // most 32 rows a warp
  const int sms = bithtm::sm_count();
  const long long want = (long long)(sms > 0 ? sms : 132) * 8;
  const long long most = (L + kWarps - 1) / kWarps;
  long long g = (want + B - 1) / B;
  int groups = (int)(g < most ? g : most);
  if (groups < 1) groups = 1;
  int rpw = ((L + groups - 1) / groups + kWarps - 1) / kWarps;
  if (rpw < 1) rpw = 1;
  if (rpw > 32) rpw = 32;
  const int rows = rpw * kWarps;
  groups = L > rows ? (L + rows - 1) / rows : 1;
  const long long blocks = (long long)B * groups;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  grow_fill_kernel<kShfl><<<(unsigned)blocks, kWarps * 32, 0, stream>>>(
      syn, perm, wrote, lidx, lvalid, chosen, n_chosen, counts, B, R, K, L,
      kk, perm_init, rows, groups);
  return (int)cudaGetLastError();
}

}  // namespace

// syn (B, R, K) int32 and perm (B, R, K) float32, updated in place; wrote
// (B, R, K) bool, zero on entry; lidx (B, L) int32, lvalid (B, L) bool,
// chosen (B, L, kk) int32 and n_chosen (B, L) int32, the selection;
// counts (4, B) int32, rows 0 and 1 zero on entry (grow_select). Launches
// on the given stream of the given device, allocates nothing and returns
// cudaGetLastError() after the launch (0 = success).
extern "C" int grow_fill(int* syn, float* perm, void* wrote, const int* lidx,
                         const void* lvalid, const int* chosen,
                         const int* n_chosen, int* counts, int B, int R,
                         int K, int L, int kk, float perm_init, int device,
                         void* stream) {
  if (B < 0 || R < 1 || K < 1 || L < 0 || kk < 1)
    return (int)cudaErrorInvalidValue;
  if ((long long)B * L == 0) return 0;
  bithtm::DeviceGuard guard(device);
  if (int err = guard.error()) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  uint8_t* w = static_cast<uint8_t*>(wrote);
  const uint8_t* lv = static_cast<const uint8_t*>(lvalid);
  return bithtm::with_bool(kk <= 32, [&](auto shfl) {
    return launch<decltype(shfl)::value>(syn, perm, w, lidx, lv, chosen,
                                         n_chosen, counts, B, R, K, L, kk,
                                         perm_init, s);
  });
}
