// Growth-candidate selection of the TM's synapse growth, for NVIDIA
// Hopper (sm_90a).
//
// Stands for the selection half of the JAX package's _grow and
// _select_and_fill (bithtm_tpu/models/temporal_memory.py:350-498 and
// :221-347, methods sortfill_packed_cell and sortfill_packed_idx), which
// XLA runs as a compare tensor, a sort of packed keys and a slice. The
// TPU package has no Pallas kernel for it. Plain PyTorch version:
// bithtm_tpu_torch/models/temporal_memory.py (grow_select_ref), which
// builds a (B, L, samp, Wc) compare tensor for the existing targets and
// sorts int64 keys, since torch's CPU sort has no uint32.
//
// Per stream b and row l of the compacted growing-segment list (lidx,
// lvalid; the row's K slots are syn[b, lidx[l]] and act[b, lidx[l]]):
//   potential = the row's active live slots (act && syn >= 0)
//   n_grow    = lvalid ? min(max(samp - potential, 0),
//                            min(n_eff[b], samp)) : 0
//   targets   = the first samp active live slots' cells where samp < K,
//               else every slot's cell (-1: none)
//   valid[i]  = candidate i is in the list (cand_valid) and no target
//               is its cell
//   key[i]    = cell form (up to 2^16 cells, bits = cell bits):
//                 ((rnd >>> (bits + 1)) << bits) | cand[i]
//               index form (above, bits = index bits of Wc):
//                 ((rnd >>> (bits + 2)) << bits) | i
//   n_chosen  = min(n_grow, count of valid)
//   chosen    = the n_chosen smallest valid keys, ascending: the cells
//               (key & low bits) in the cell form, the keys themselves
//               in the index form (take_small_table decodes them after).
// Keys compare as uint32: an index-form key is below 2^30, a cell-form
// key below 2^31, so both orders are the plain version's. Valid keys
// never tie (their low bits differ). Past n_chosen, chosen holds the
// sentinel's decode (cell form: the low bits of 0xFFFFFFFF; index form:
// 0x7FFFFFFF), which the fill never writes into a slot.
//
// The candidate list is the compacted previous winner cells: its valid
// entries come first and ascend (prev_cols is sorted), so "is this target
// a candidate?" is a binary search over the list in shared memory, and a
// target marks every equal entry. No (samp, Wc) compare is built.
//
// Bound: bytes. A growing row reads its n_cand random words and its K
// slots (5 bytes a slot), every row its list entry and writes kk + 1
// words, every stream its candidate list. At the bench (B=256, L=88,
// Wc=128, K=64, kk=32) that is at most 11.5 + 7.2 + 3.1 + 0.2 MB, about
// 7 us at the H100's 3.35 TB/s; rows that do not grow read no random
// words. The selection is a few integer operations a candidate and round.
//
// Design. A warp takes a row (kWarps rows a block, one stream a block),
// so a row's work needs no block barrier. The block first stages the
// stream's candidate list in shared memory and counts its valid entries
// (__syncthreads_count). A row whose n_grow is 0 (no growth, or an
// invalid list entry) writes its fill and stops: it reads no random
// words. Else its lanes read the K slots 32 at a time: a ballot gives the
// potential, and the active slots' ranks, so the first samp targets are
// known without a compaction. The lanes write the row's keys into the
// warp's shared-memory row, mark each target's candidate with the
// sentinel, count the valid keys and then pick the n_chosen smallest by
// successive minima: each round every lane takes the least of its keys
// above the last one picked and __reduce_min_sync gives the next key, so
// the output comes out sorted with no sort (n_chosen <= samp rounds of
// n_cand / 32 reads a lane). Path "smem" keeps the keys in shared
// memory, 4 * Wc bytes a row beside the 4 * Wc of the list (up to 4 rows
// a block, at least one: Wc <= 29,056); path "global" (wider lists)
// keeps them in a global scratch of the same (B, L, Wc) shape as rnd and
// searches the list where it lies. The grid is one-dimensional, B x
// ceil(L / rows a block) blocks, so B has no limit of its own.

#include <cuda_runtime.h>
#include <stdint.h>

#include "launch.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr uint32_t kSentinel = 0xffffffffu;
constexpr int kWarps = 4;  // rows a block, one warp a row

// The first i in [0, n) with list[i] >= t, for an ascending list.
__device__ __forceinline__ int lower_bound(const int* list, int n, int t) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (list[mid] < t)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

template <bool kCell, bool kSmem>
__global__ void __launch_bounds__(kWarps * 32) grow_select_kernel(
    const int* __restrict__ syn, const uint8_t* __restrict__ act,
    const int* __restrict__ lidx, const uint8_t* __restrict__ lvalid,
    const int* __restrict__ cand, const uint8_t* __restrict__ cand_valid,
    const int* __restrict__ n_eff, const int* __restrict__ rnd,
    int* __restrict__ chosen, int* __restrict__ n_chosen,
    uint32_t* __restrict__ scratch, int R, int K, int L, int Wc,
    int cand_stride, int samp, int kk, int bits, int rows_per_block,
    int groups) {
  extern __shared__ uint32_t smem[];
  const long long b = blockIdx.x / groups;
  const int group = blockIdx.x - (int)(b * groups);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int* cand_b = cand + b * cand_stride;
  const uint8_t* valid_b = cand_valid + b * Wc;

  // the stream's candidate list (staged on the smem path) and its valid
  // count: valid entries come first
  int* staged = reinterpret_cast<int*>(smem);
  int n_cand = 0;
  for (int i0 = 0; i0 < Wc; i0 += blockDim.x) {
    const int i = i0 + threadIdx.x;
    bool v = false;
    if (i < Wc) {
      v = valid_b[i] != 0;
      if constexpr (kSmem) staged[i] = cand_b[i];
    }
    n_cand += __syncthreads_count(v);
  }
  const int* list = kSmem ? staged : cand_b;

  const int l = group * rows_per_block + warp;
  if (l >= L) return;
  const long long row = b * L + l;
  int* out = chosen + row * kk;
  const uint32_t low = (1u << bits) - 1u;
  const int fill = kCell ? (int)low : 0x7fffffff;

  // the row's potential (active live slots), 32 slots a round
  const bool valid_row = lvalid[row] != 0;
  int r = lidx[row];
  r = r < 0 ? 0 : (r >= R ? R - 1 : r);
  const int* syn_r = syn + ((long long)b * R + r) * K;
  const uint8_t* act_r = act + ((long long)b * R + r) * K;
  int potential = 0;
  if (valid_row) {
    for (int k0 = 0; k0 < K; k0 += 32) {
      const int k = k0 + lane;
      const bool av = k < K && act_r[k] != 0 && syn_r[k] >= 0;
      potential += __popc(__ballot_sync(kFull, av));
    }
  }
  int n_grow = 0;
  if (valid_row) {
    const int cap = min(n_eff[b], samp);
    n_grow = min(max(samp - potential, 0), cap);
  }
  if (n_grow <= 0) {
    for (int i = lane; i < kk; i += 32) out[i] = fill;
    if (lane == 0) n_chosen[row] = 0;
    return;
  }

  uint32_t* keys;
  if constexpr (kSmem)
    keys = smem + Wc + (long long)warp * Wc;
  else
    keys = scratch + row * Wc;
  const int* rnd_r = rnd + row * Wc;
  for (int i = lane; i < n_cand; i += 32) {
    const uint32_t bits_r = static_cast<uint32_t>(__ldg(rnd_r + i));
    keys[i] = kCell ? ((bits_r >> (bits + 1)) << bits) |
                          static_cast<uint32_t>(list[i])
                    : ((bits_r >> (bits + 2)) << bits) |
                          static_cast<uint32_t>(i);
  }
  __syncwarp();

  // existing targets: every slot's cell where samp >= K, else the first
  // samp active live slots' (ranked by ballot)
  const unsigned below = (1u << lane) - 1u;
  int ranked = 0;
  for (int k0 = 0; k0 < K; k0 += 32) {
    const int k = k0 + lane;
    const int s = k < K ? syn_r[k] : -1;
    const bool av = k < K && act_r[k] != 0 && s >= 0;
    const unsigned ballot = __ballot_sync(kFull, av);
    const int rank = ranked + __popc(ballot & below);
    ranked += __popc(ballot);
    if (s >= 0 && (samp >= K || (av && rank < samp))) {
      for (int i = lower_bound(list, n_cand, s); i < n_cand && list[i] == s;
           ++i)
        keys[i] = kSentinel;
    }
  }
  __syncwarp();

  int n_valid = 0;
  for (int i = lane; i < n_cand; i += 32) n_valid += keys[i] != kSentinel;
  n_valid = __reduce_add_sync(kFull, n_valid);
  const int m = min(n_grow, n_valid);

  // the m smallest keys by successive minima, in ascending order
  uint32_t last = 0;
  for (int j = 0; j < m; ++j) {
    uint32_t best = kSentinel;
    for (int i = lane; i < n_cand; i += 32) {
      const uint32_t key = keys[i];
      if ((j == 0 || key > last) && key < best) best = key;
    }
    best = __reduce_min_sync(kFull, best);
    if (lane == 0) out[j] = kCell ? (int)(best & low) : (int)best;
    last = best;
  }
  for (int i = m + lane; i < kk; i += 32) out[i] = fill;
  if (lane == 0) n_chosen[row] = m;
}

// Rows a block on the smem path: the list and a key row each take 4 * Wc
// bytes, up to kWarps rows.
int smem_rows(int Wc) {
  const long long fit = bithtm::kMaxShared / (4LL * Wc) - 1;
  return (int)(fit < kWarps ? fit : kWarps);
}

template <bool kCell, bool kSmem>
int launch(const int* syn, const uint8_t* act, const int* lidx,
           const uint8_t* lvalid, const int* cand, const uint8_t* cand_valid,
           const int* n_eff, const int* rnd, int* chosen, int* n_chosen,
           uint32_t* scratch, int B, int R, int K, int L, int Wc,
           int cand_stride, int samp, int kk, int bits,
           cudaStream_t stream) {
  int rows = kSmem ? smem_rows(Wc) : kWarps;
  if (rows < 1) return (int)cudaErrorInvalidValue;
  if (rows > L) rows = L;
  const int groups = (L + rows - 1) / rows;
  const long long blocks = (long long)B * groups;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const size_t smem = kSmem ? 4 * (size_t)Wc * (1 + rows) : 0;
  auto kernel = grow_select_kernel<kCell, kSmem>;
  if (int err = bithtm::allow_shared(kernel, smem)) return err;
  kernel<<<(unsigned)blocks, rows * 32, smem, stream>>>(
      syn, act, lidx, lvalid, cand, cand_valid, n_eff, rnd, chosen,
      n_chosen, scratch, R, K, L, Wc, cand_stride, samp, kk, bits, rows,
      groups);
  return (int)cudaGetLastError();
}

}  // namespace

// syn (B, R, K) int32 and act (B, R, K) bool rows; lidx (B, L) int32 and
// lvalid (B, L) bool, the growing rows; cand (B, Wc) int32, rows
// cand_stride words apart (the compacted list is a view), and cand_valid
// (B, Wc) bool, the candidate list (valid entries first, ascending);
// n_eff (B,) int32; rnd (B, L, Wc) int32 random words -> chosen (B, L,
// kk) int32 and n_chosen (B, L) int32, kk = min(samp, Wc). cell_form
// selects the key form, bits its low bits; global_keys the path whose
// keys live in scratch (B, L, Wc) (else None). Launches on the given
// stream of the given device, allocates nothing and returns
// cudaGetLastError() after the launch (0 = success).
extern "C" int grow_select(const int* syn, const void* act, const int* lidx,
                           const void* lvalid, const int* cand,
                           const void* cand_valid, const int* n_eff,
                           const int* rnd, int* chosen, int* n_chosen,
                           void* scratch, int B, int R, int K, int L,
                           int Wc, int cand_stride, int samp, int bits,
                           int cell_form, int global_keys, int device,
                           void* stream) {
  if (B < 0 || R < 1 || K < 1 || L < 0 || Wc < 1 ||
      (cand_stride < Wc && B > 1) || samp < 1 || bits < 1 ||
      bits + (cell_form ? 1 : 2) > 31 || (global_keys && !scratch) ||
      (!global_keys && smem_rows(Wc) < 1))
    return (int)cudaErrorInvalidValue;
  if ((long long)B * L == 0) return 0;
  const int kk = samp < Wc ? samp : Wc;
  bithtm::DeviceGuard guard(device);
  if (int err = guard.error()) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* a = static_cast<const uint8_t*>(act);
  const uint8_t* lv = static_cast<const uint8_t*>(lvalid);
  const uint8_t* cv = static_cast<const uint8_t*>(cand_valid);
  uint32_t* sc = static_cast<uint32_t*>(scratch);
  return bithtm::with_bool(cell_form != 0, [&](auto cell) {
    return bithtm::with_bool(global_keys == 0, [&](auto in_smem) {
      return launch<decltype(cell)::value, decltype(in_smem)::value>(
          syn, a, lidx, lv, cand, cv, n_eff, rnd, chosen, n_chosen, sc, B, R,
          K, L, Wc, cand_stride, samp, kk, bits, s);
    });
  });
}
