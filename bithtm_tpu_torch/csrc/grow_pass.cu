// Growth-candidate selection of the TM's synapse growth, with the lists
// it selects from, for NVIDIA Hopper (sm_90a).
//
// Stands for the JAX package's _grow up to its fill, and the selection
// half of _select_and_fill (bithtm_tpu/models/temporal_memory.py:350-498
// and :221-347, methods sortfill_packed_cell and sortfill_packed_idx),
// which XLA runs as two rank/one-hot compactions, a compare tensor, a
// sort of packed keys and a slice. The TPU package has no Pallas kernel
// for it. Plain PyTorch version: bithtm_tpu_torch/models/
// temporal_memory.py (grow_select_ref). The fill is learn_rows
// (learn_pass.cu).
//
// Per stream b (A previous active columns cols, their (A, W) winner
// words bits, the R learning flags learn of the active rows):
//   n_winners  = the set bits of bits; n_eff = min(n_winners, Wc)
//   cand       = the first Wc winner cells cols[a]*D + d (bit d < D of
//                column a's words), ascending, 0 past the n_cand valid
//   lidx       = the slot ids of the first L learning flags, ascending,
//                R past them; lvalid = the list entry is one; lpos[r] =
//                row r's place in the list, -1 where it has none
//   counts     = (0, 0, n_winners - n_eff, the flags past L), a row each
//                of (4, B); learn_rows (learn_pass.cu) adds n_grown and
//                overflow to rows 0 and 1
// and per row l of the list (its K slots syn[b, lidx[l]], act[b, ...],
// read where they lie: row r = a*G + g is segment g of column
// row_cols[b, a] of the (B, Ct, G*K) tables, or of column a of gathered
// rows where row_cols is null; a row of a new segment, fresh[b, r], reads
// as empty. act is the packed activity in its own type, nonzero where
// active. Where fresh is given these are the rows before the step's stale
// cleanup, new-segment reset and death, which change only slots with act
// = 0 (a stale slot's activity is 0, and only an inactive slot dies) or
// rows that read as empty; and every live slot that targets a candidate
// is active (the candidates are previous active cells, and the activity
// was computed on this table), so the active live slots are the targets
// whatever samp, and the selection is the one on the updated rows):
//   potential  = the row's active live slots (act && syn >= 0)
//   n_grow     = lvalid ? min(max(samp - potential, 0), min(n_eff, samp))
//                       : 0
//   targets    = the first samp active live slots' cells where samp < K
//                or the rows are read before the learning pass (fresh
//                given), else every live slot's cell
//   valid[i]   = i < n_cand and no target is cand[i]
//   key[i]     = cell form (up to 2^16 cells, bits = cell bits):
//                  ((rnd >>> (bits + 1)) << bits) | cand[i]
//                index form (above, bits = index bits of Wc):
//                  ((rnd >>> (bits + 2)) << bits) | i
//   n_chosen   = min(n_grow, count of valid)
//   chosen     = the n_chosen smallest valid keys, ascending: the cells
//                (key & low bits) in the cell form, the keys themselves
//                in the index form (take_small_table decodes them).
// A valid key is below 2^31 and keys compare as uint32, so the order is
// the plain version's; valid keys never tie (their low bits differ).
// Past n_chosen, chosen holds the sentinel's decode (cell form: the low
// bits of 0xFFFFFFFF; index form: 0x7FFFFFFF), which learn_rows never
// writes into a slot.
//
// Bound: bytes. Each stream's winner words, columns and flags once, and
// for each growing row its K slots (syn and activity: 5 bytes a slot at
// u8) and the random words of its valid candidates; the outputs once.
// At the bench (B=256, L=88, Wc=128, K=64) about 11 MB, 3.3 us at the
// H100's 3.35 TB/s; at the 16K tuned caps (B=64, L=336, Wc=384) about
// 26 MB, 7.8 us. The selection is a few integer operations a key.
//
// What held the kernel it replaces back (PERF.md section 6, measured by
// scripts/grow_variants.py: copies of the source with one stage cut, in
// a CUDA graph of 20): its rounds of successive warp minima, 44-62% of
// its time; the per-target searches 0-7%, the random-word loads 0-9%, the
// staging of the list for 4 rows nothing. The design here:
//  - Selection by rank, with no round trip per output. While a warp
//    builds a row's keys it counts those below a guess of the m-th
//    smallest (the keys are random above their low bits, so the guess,
//    from the valid count, usually brackets m..32 keys); otherwise rounds
//    alternate an interpolated guess and the midpoint (any keys: at most
//    31 rounds). The keys below the bound move to the front of the row in
//    place (ballot compaction), each lane ranks one of them by 32
//    shuffles and stores its cell at its rank: kk outputs in one store.
//  - The row's random words are copied into its key row (cp.async, 16
//    bytes where the row allows) before its slots are read, and the
//    targets of its first 128 slots are looked up while the copy is in
//    flight, in a hash table of the list (one or two shared-memory probes
//    where the binary search took log2(Wc) dependent ones; a binary
//    search where the table does not fit); a row's slots are read once.
//    Targets are struck out by an atomic exchange, which keeps the counts
//    exact when two slots hold one cell.
//  - The prologue is the block's own: one block-wide prefix sum a round
//    over 8 flags and 4 winner words a thread gives the growing rows of
//    its range (staged in shared memory) and the candidate list, so
//    nothing runs before the kernel; a block holds 8 warps x up to 32
//    rows, and the grid as many blocks as the card holds at once.
// What holds it now (the same script on this source, PERF.md): the
// prologue and the rows' loads (about half its time at the bench and the
// 16K tuned caps), then the keys' build and selection; a row is a few
// hundred warp instructions, and the SM's issue rate, not the bytes,
// bounds the kernel.
// Paths: "smem" keeps the list and a key row a warp in shared memory
// (up to 8 warps; at least one while 8 * Wc <= 232,448 bytes), and the
// list's hash table of 2^bits >= 2 * Wc words where it fits; "global"
// (wider lists) keeps the list in cand and the keys in a (B, L, Wc)
// scratch, one block a stream. The grid is one-dimensional, B x groups
// of rows, so B has no limit of its own.

#include <cuda_runtime.h>
#include <stdint.h>

#include "launch.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr uint32_t kSentinel = 0xffffffffu;    // an invalid key
constexpr uint32_t kValidBelow = 0x80000000u;  // every valid key is below
constexpr int kWarps = 8;                       // warps a block, at most
constexpr int kScanWords = 64;    // the prologue's scan scratch

// The exclusive prefix sum of v over the block (every thread calls it),
// and the block's total; scratch holds a word a warp.
__device__ uint64_t block_scan(uint64_t v, uint64_t* scratch,
                               uint64_t& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  uint64_t x = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const uint64_t y = __shfl_up_sync(kFull, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) scratch[warp] = x;
  __syncthreads();
  if (warp == 0) {
    uint64_t s = lane < nw ? scratch[lane] : 0;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const uint64_t y = __shfl_up_sync(kFull, s, d);
      if (lane >= d) s += y;
    }
    if (lane < nw) scratch[lane] = s;
  }
  __syncthreads();
  total = scratch[nw - 1];
  const uint64_t before = warp > 0 ? scratch[warp - 1] : 0;
  __syncthreads();
  return before + x - v;
}

__device__ __forceinline__ void cp_async4(uint32_t* dst, const int* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async16(uint32_t* dst, const int* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The row's n random words into its key row, in flight until
// cp_async_wait_all (vec: 16-byte copies, Wc % 4 == 0).
__device__ __forceinline__ void fetch_rnd(uint32_t* keys, const int* rnd_r,
                                          int n, bool vec, int lane) {
  if (vec) {
    for (int c = lane; 4 * c < n; c += 32)
      cp_async16(keys + 4 * c, rnd_r + 4 * c);
  } else {
    for (int i = lane; i < n; i += 32) cp_async4(keys + i, rnd_r + i);
  }
}

// The keys of keys[0, n) below t, over the warp.
__device__ __forceinline__ int count_below(const uint32_t* keys, int n,
                                           uint32_t t, int lane) {
  int c = 0;
#pragma unroll 4
  for (int i = lane; i < n; i += 32) c += keys[i] < t;
  return __reduce_add_sync(kFull, c);
}

// The m = min(n_grow, valid) smallest valid keys of keys[0, n), ascending,
// decoded into out[0, m); returns m. c_valid keys are valid, c_guess of
// them below guess. cap (>= kk) bounds the keys the rank sort takes: 32
// (one a lane, ranked by shuffles) where kk <= 32. Reorders keys.
template <bool kCell>
__device__ int select_row(uint32_t* keys, int n, int n_grow, int c_valid,
                          uint32_t guess, int c_guess, int cap, int* out,
                          uint32_t low, int lane) {
  const int m = min(n_grow, c_valid);
  if (m == 0) return 0;
  // a value window [lo, hi) with count(< lo) = c_lo < m <= c_hi =
  // count(< hi), narrowed until at most cap keys lie below hi. The first
  // bound is the guess counted while the keys were built (keys spread
  // evenly: done, usually); then rounds alternate a guess from the counts
  // and the midpoint (any keys: at most 31 such rounds)
  uint32_t lo = 0, hi = kValidBelow;
  int c_lo = 0, c_hi = c_valid;
  if (c_hi > cap) {
    if (c_guess >= m) {
      hi = guess;
      c_hi = c_guess;
    } else {
      lo = guess;
      c_lo = c_guess;
    }
  }
  for (bool interpolate = true; c_hi > cap; interpolate = !interpolate) {
    uint32_t mid = lo + ((hi - lo) >> 1);
    if (interpolate) {
      const int want = (m + cap) >> 1;  // c_lo < m <= want <= cap < c_hi
      mid = lo + (uint32_t)((uint64_t)(hi - lo) * (uint64_t)(want - c_lo) /
                            (uint64_t)(c_hi - c_lo));
      if (mid <= lo) mid = lo + 1;
      if (mid >= hi) mid = hi - 1;
    }
    const int c = count_below(keys, n, mid, lane);
    if (c >= m) {
      hi = mid;
      c_hi = c;
    } else {
      lo = mid;
      c_lo = c;
    }
  }
  // the c_hi keys below hi to the front, in place, 128 at a time: a key
  // moves to an index at most its own, and a round's lanes read their
  // four keys before any lane writes
  const unsigned below = (1u << lane) - 1u;
  int base = 0;
  for (int i0 = 0; i0 < n && base < c_hi; i0 += 128) {
    uint32_t k4[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = i0 + 32 * u + lane;
      k4[u] = i < n ? keys[i] : kSentinel;
    }
    __syncwarp();
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const unsigned sel = __ballot_sync(kFull, k4[u] < hi);
      if (k4[u] < hi) keys[base + __popc(sel & below)] = k4[u];
      base += __popc(sel);
    }
  }
  __syncwarp();
  // each candidate's rank among them is its place in the output
  if (cap <= 32) {
    const uint32_t key = lane < c_hi ? keys[lane] : kSentinel;
    int rank = 0;
#pragma unroll
    for (int i = 0; i < 32; ++i) rank += __shfl_sync(kFull, key, i) < key;
    if (lane < c_hi && rank < m)
      out[rank] = kCell ? (int)(key & low) : (int)key;
  } else {
    for (int j = lane; j < c_hi; j += 32) {
      const uint32_t key = keys[j];
      int rank = 0;
#pragma unroll 8
      for (int i = 0; i < c_hi; ++i) rank += keys[i] < key;
      if (rank < m) out[rank] = kCell ? (int)(key & low) : (int)key;
    }
  }
  return m;
}

// The number of list[0, n) entries below t (n < 2 * top, top a power of
// two), for the targets of the first `groups` of four, interleaved and
// without branches.
__device__ __forceinline__ void lower_bounds(const int* list, int n, int top,
                                             int groups, const int (&t)[4],
                                             int (&pos)[4]) {
#pragma unroll
  for (int u = 0; u < 4; ++u) pos[u] = 0;
  for (int step = top; step; step >>= 1) {
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (u < groups) {
        const int p = pos[u] + step;
        const int v = list[min(p, n) - 1];
        pos[u] = p <= n && v < t[u] ? p : pos[u];
      }
    }
  }
}

// Whether value k of an activity row of ebytes-byte values is not 0 (the
// bits below the sign: -0.0 reads as 0).
__device__ __forceinline__ bool act_nz(const uint8_t* act_r, int k,
                                       int ebytes) {
  if (ebytes == 1) return act_r[k] != 0;
  if (ebytes == 2)
    return (reinterpret_cast<const uint16_t*>(act_r)[k] & 0x7fffu) != 0;
  return (reinterpret_cast<const uint32_t*>(act_r)[k] & 0x7fffffffu) != 0;
}

__device__ __forceinline__ uint32_t hash_cell(int t, int bits) {
  return (static_cast<uint32_t>(t) * 0x9E3779B1u) >> (32 - bits);
}

// Enters list entry i (cell t) in the hash table of 2^bits words (entry
// i + 1, 0 empty; open addressing).
__device__ __forceinline__ void hash_insert(uint32_t* table, int bits, int t,
                                            int i) {
  const uint32_t mask = (1u << bits) - 1u;
  for (uint32_t h = hash_cell(t, bits);
       atomicCAS(table + h, 0u, static_cast<uint32_t>(i + 1)) != 0u;
       h = (h + 1) & mask) {
  }
}

// The index of cell t in list[0, n) (ascending, distinct), or -1: a probe
// of the hash table where there is one (bits > 0), else a binary search.
__device__ __forceinline__ int find_cell(const int* list,
                                         const uint32_t* table, int bits,
                                         int n, int t) {
  if (bits) {
    const uint32_t mask = (1u << bits) - 1u;
    for (uint32_t h = hash_cell(t, bits);; h = (h + 1) & mask) {
      const uint32_t e = table[h];
      if (e == 0u) return -1;
      if (list[e - 1] == t) return static_cast<int>(e) - 1;
    }
  }
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (list[mid] < t)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo < n && list[lo] == t ? lo : -1;
}

// Strikes key i out (an atomic exchange, so that a key struck twice counts
// once): returns whether it was valid, and lowers c_guess where it lay
// below guess.
__device__ __forceinline__ int strike(uint32_t* keys, int i, uint32_t guess,
                                      int& c_guess) {
  const uint32_t old = atomicExch(keys + i, kSentinel);
  c_guess -= old < guess;
  return old != kSentinel;
}

// One growing row: its keys (in keys[0, n_cand)), its targets struck out,
// its selection into out; returns n_chosen. The row's first 128 slots are
// read once, their targets searched while its random words are in flight;
// an empty row (a new segment's) reads none. all_live: every live slot
// is a target (samp >= K on updated rows), else the first samp active
// live slots.
template <bool kCell, bool kSmem>
__device__ int grow_row(const int* syn_r, const uint8_t* act_r, int ebytes,
                        bool empty, bool all_live, const int* rnd_r,
                        const int* list, const uint32_t* table,
                        int hash_bits, uint32_t* keys, int n_cand, int K,
                        int samp, int cap_grow, int cap, int bits, bool vec,
                        int* out, int lane) {
  if constexpr (kSmem) fetch_rnd(keys, rnd_r, n_cand, vec, lane);
  const int Kr = empty ? 0 : K;  // the slots read
  // existing targets: every live slot's cell (all_live), else the first
  // samp active live slots' (ranked by ballot)
  const unsigned below = (1u << lane) - 1u;
  int s[4], pos[4], ranked = 0;
  bool target[4];
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int k = 32 * u + lane;
    s[u] = k < Kr ? syn_r[k] : -1;
    const bool av = k < Kr && act_nz(act_r, k, ebytes) && s[u] >= 0;
    const unsigned ballot = __ballot_sync(kFull, av);
    const int rank = ranked + __popc(ballot & below);
    target[u] = s[u] >= 0 && (all_live || (av && rank < samp));
    ranked += __popc(ballot);
  }
  const int ranked128 = ranked;
  for (int k0 = 128; k0 < Kr; k0 += 32) {
    const int k = k0 + lane;
    ranked += __popc(__ballot_sync(
        kFull, k < Kr && act_nz(act_r, k, ebytes) && syn_r[k] >= 0));
  }
  const int n_grow = min(max(samp - ranked, 0), cap_grow);
  if (n_grow == 0 || n_cand == 0) {
    if constexpr (kSmem) cp_async_wait_all();
    return 0;
  }
  // each target's index in the list (-1: not a candidate)
  if (hash_bits) {
#pragma unroll
    for (int u = 0; u < 4; ++u)
      pos[u] = target[u] ? find_cell(list, table, hash_bits, n_cand, s[u])
                         : -1;
  } else {
    const int top = 1 << (31 - __clz(n_cand));
    lower_bounds(list, n_cand, top, (min(K, 128) + 31) >> 5, s, pos);
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (!(target[u] && pos[u] < n_cand && list[pos[u]] == s[u])) pos[u] = -1;
  }
  // a guess of the m-th smallest valid key, for keys spread evenly below
  // key_top among about n_cand - (targets found) valid ones
  int hits = 0;
#pragma unroll
  for (int u = 0; u < 4; ++u) hits += pos[u] >= 0;
  const uint32_t key_top = kCell ? kValidBelow : kValidBelow >> 1;
  const int n_valid = max(n_cand - __reduce_add_sync(kFull, hits), 1);
  const int want = (min(n_grow, n_valid) + cap) >> 1;
  const uint32_t guess =
      want >= n_valid ? kValidBelow
                      : (uint32_t)((uint64_t)key_top * want / n_valid);
  if constexpr (kSmem) {
    cp_async_wait_all();
    __syncwarp();
  }

  // the keys, counting those below the guess, then the targets struck out
  // (an exchange: a cell two slots target counts once)
  int c_guess = 0;
  for (int i = lane; i < n_cand; i += 32) {
    const uint32_t raw =
        kSmem ? keys[i] : static_cast<uint32_t>(__ldg(rnd_r + i));
    const uint32_t key = kCell ? ((raw >> (bits + 1)) << bits) |
                                     static_cast<uint32_t>(list[i])
                               : ((raw >> (bits + 2)) << bits) |
                                     static_cast<uint32_t>(i);
    keys[i] = key;
    c_guess += key < guess;
  }
  __syncwarp();
  int struck = 0;
#pragma unroll
  for (int u = 0; u < 4; ++u)
    if (pos[u] >= 0) struck += strike(keys, pos[u], guess, c_guess);
  ranked = ranked128;
  for (int k0 = 128; k0 < Kr; k0 += 32) {  // slots past 128, searched alone
    const int k = k0 + lane;
    const int t = k < Kr ? syn_r[k] : -1;
    const bool av = k < Kr && act_nz(act_r, k, ebytes) && t >= 0;
    const unsigned ballot = __ballot_sync(kFull, av);
    const int rank = ranked + __popc(ballot & below);
    if (t >= 0 && (all_live || (av && rank < samp))) {
      const int i = find_cell(list, table, hash_bits, n_cand, t);
      if (i >= 0) struck += strike(keys, i, guess, c_guess);
    }
    ranked += __popc(ballot);
  }
  __syncwarp();
  const int c_valid = n_cand - __reduce_add_sync(kFull, struck);
  c_guess = __reduce_add_sync(kFull, c_guess);
  return select_row<kCell>(keys, n_cand, n_grow, c_valid, guess, c_guess,
                           cap, out, (1u << bits) - 1u, lane);
}

template <bool kCell, bool kSmem>
__global__ void __launch_bounds__(kWarps * 32) grow_select_kernel(
    const int* __restrict__ syn, const uint8_t* __restrict__ act,
    int ebytes, const int* __restrict__ row_cols, int Ct, int G,
    const uint8_t* __restrict__ fresh, const uint8_t* __restrict__ learn,
    const int* __restrict__ cols, const int* __restrict__ bits,
    const int* __restrict__ rnd, int* __restrict__ chosen,
    int* __restrict__ n_chosen, int* lidx, uint8_t* __restrict__ lvalid,
    int* __restrict__ lpos, int* cand, int* __restrict__ counts,
    uint32_t* __restrict__ scratch, int B, int R, int K, int A, int D,
    int L, int Wc, int samp, int kk, int key_bits, int rows_per_block,
    int groups, int vec, int hash_bits) {
  extern __shared__ uint32_t smem[];
  const int b = blockIdx.x / groups;
  const int group = blockIdx.x - b * groups;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nw = blockDim.x >> 5;
  const int row0 = group * rows_per_block;
  const int row_end = min(L, row0 + rows_per_block);
  const long long bL = (long long)b * L;
  // shared memory (smem path): a key row a warp, whose start holds the
  // prologue's scan scratch and the block's slot ids before any row runs,
  // then the list
  const long long key_words = kSmem ? (long long)nw * Wc : 0;
  const long long rows_words =
      key_words > kScanWords + rows_per_block ? key_words
                                              : kScanWords + rows_per_block;
  uint64_t* scan = reinterpret_cast<uint64_t*>(smem);
  int* staged = reinterpret_cast<int*>(smem) + kScanWords;
  int* list = kSmem ? reinterpret_cast<int*>(smem + rows_words)
                    : cand + (long long)b * Wc;
  // the list's hash table (smem path, where it fits), after the list
  uint32_t* table = smem + rows_words + Wc;
  if (hash_bits)
    for (int i = threadIdx.x; i < (1 << hash_bits); i += blockDim.x)
      table[i] = 0u;

  // 1. the prologue, one scan a round over 8 learning flags and 4 winner
  // words a thread: the growing rows (the first L flags; this block's
  // rows [row0, row_end) take their slot ids) and the candidate list (the
  // first Wc winner cells). The scan carries the flags (bits 0-11), the
  // winner bits below D (bits 12-31) and all winner bits (bits 32-63).
  const uint8_t* learn_b = learn + (long long)b * R;
  const int W = (D + 31) >> 5;
  const int* bits_b = bits + (long long)b * A * W;
  const int* cols_b = cols + (long long)b * A;
  const int per_flags = 8 * blockDim.x, per_words = 4 * blockDim.x;
  const int rounds = max((R + per_flags - 1) / per_flags,
                         (A * W + per_words - 1) / per_words);
  int n_learn = 0, n_list = 0, n_win = 0;
  for (int round = 0; round < rounds; ++round) {
    const int f0 = round * per_flags + 8 * threadIdx.x;
    const int w0 = round * per_words + 4 * threadIdx.x;
    unsigned f = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (f0 + j < R && learn_b[f0 + j]) f |= 1u << j;
    uint32_t word[4];
    int base[4], in_d = 0, all = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int i = w0 + j;
      word[j] = 0;
      base[j] = 0;
      if (i < A * W) {
        const int a = i / W, w = i - a * W;
        const uint32_t v = static_cast<uint32_t>(bits_b[i]);
        const int nd = D - 32 * w;
        word[j] = nd < 32 ? v & ((1u << nd) - 1u) : v;
        base[j] = cols_b[a] * D + 32 * w;
        in_d += __popc(word[j]);
        all += __popc(v);
      }
    }
    uint64_t total;
    const uint64_t pre = block_scan(
        (uint64_t)__popc(f) | ((uint64_t)in_d << 12) | ((uint64_t)all << 32),
        scan, total);
    int rank = n_learn + (int)(pre & 0xfff);
    if (group == 0) {  // every row's place in the list, or -1
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (f0 + j < R) {
          const int at = rank + __popc(f & ((1u << j) - 1u));
          lpos[(long long)b * R + f0 + j] =
              (f >> j) & 1u && at < L ? at : -1;
        }
      }
    }
    for (; f; f &= f - 1, ++rank) {
      if (rank >= row0 && rank < row_end) {
        const int slot = f0 + __ffs(f) - 1;
        lidx[bL + rank] = slot;
        if constexpr (kSmem) staged[rank - row0] = slot;
      }
    }
    int pos = n_list + (int)((pre >> 12) & 0xfffff);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      for (uint32_t v = word[j]; v && pos < Wc; v &= v - 1, ++pos)
        list[pos] = base[j] + __ffs(v) - 1;
    n_learn += (int)(total & 0xfff);
    n_list += (int)((total >> 12) & 0xfffff);
    n_win += (int)(total >> 32);
  }
  for (int q = row0 + threadIdx.x; q < row_end; q += blockDim.x) {
    lvalid[bL + q] = q < n_learn;
    if (q >= n_learn) lidx[bL + q] = R;
  }
  const int valid_end = min(row_end, n_learn);
  const int n_cand = min(n_list, Wc), n_eff = min(n_win, Wc);
  __syncthreads();  // the list, the slot ids and (global path) cand
  if (hash_bits)
    for (int i = threadIdx.x; i < n_cand; i += blockDim.x)
      hash_insert(table, hash_bits, list[i], i);
  if (group == 0) {
    for (int i = threadIdx.x; i < Wc; i += blockDim.x)
      if (kSmem || i >= n_cand)
        cand[(long long)b * Wc + i] = i < n_cand ? list[i] : 0;
    if (threadIdx.x == 0) {
      counts[b] = 0;
      counts[B + b] = 0;
      counts[2 * B + b] = n_win - n_eff;
      counts[3 * B + b] = max(n_learn - L, 0);
    }
  }

  // 2. the rows, a warp a row; lane j holds the slot id of the warp's
  // j-th row of a batch of 32
  const uint32_t low = (1u << key_bits) - 1u;
  const int fill = kCell ? (int)low : 0x7fffffff;
  const int cap_grow = min(n_eff, samp), cap = kk <= 32 ? 32 : kk;
  uint32_t* keys_s = smem + (long long)warp * Wc;
  int r_lane = R;  // the smem path's rows fit one batch (32 a warp)
  if (row0 + warp + lane * nw < valid_end) {
    const int ql = row0 + warp + lane * nw;
    r_lane = kSmem ? staged[ql - row0] : __ldcg(lidx + bL + ql);
  }
  if constexpr (kSmem) __syncthreads();  // the key rows free, the table
                                         // complete
  for (int j0 = 0;; j0 += 32) {
    const int q0 = row0 + warp + j0 * nw;
    if (q0 >= row_end) break;
    if (j0 > 0) {
      const int ql = q0 + lane * nw;
      r_lane = ql < valid_end ? __ldcg(lidx + bL + ql) : R;
    }
    for (int j = 0; j < 32; ++j) {
      const int q = q0 + j * nw;
      if (q >= row_end) break;
      const int r = __shfl_sync(kFull, r_lane, j);
      const long long row = bL + q;
      int* out = chosen + row * kk;
      int m = 0;
      if (r < R && cap_grow > 0) {
        // row r = a*G + g: segment g of its column in the tables
        const int a = r / G, g = r - a * G;
        const int col = row_cols ? row_cols[(long long)b * (R / G) + a] : a;
        const long long slot = (((long long)b * Ct + col) * G + g) * K;
        m = grow_row<kCell, kSmem>(
            syn + slot, act + slot * ebytes, ebytes,
            fresh && fresh[(long long)b * R + r], samp >= K && !fresh,
            rnd + row * Wc, list, table, hash_bits,
            kSmem ? keys_s : scratch + row * Wc, n_cand, K, samp, cap_grow,
            cap, key_bits, vec != 0, out, lane);
      }
      for (int i = m + lane; i < kk; i += 32) out[i] = fill;
      if (lane == 0) n_chosen[row] = m;
      __syncwarp();  // the key row is free for the next row
    }
  }
}

// Warps a block on the smem path: the list and a key row a warp take
// 4 * Wc bytes each, up to kWarps warps (0: the list is too wide).
int smem_warps(int Wc) {
  const long long fit = bithtm::kMaxShared / (4LL * Wc) - 1;
  return (int)(fit < kWarps ? fit : kWarps);
}

template <bool kCell, bool kSmem>
int launch(const int* syn, const uint8_t* act, int ebytes,
           const int* row_cols, int Ct, int G, const uint8_t* fresh,
           const uint8_t* learn, const int* cols, const int* bits,
           const int* rnd, int* chosen, int* n_chosen, int* lidx,
           uint8_t* lvalid, int* lpos, int* cand, int* counts,
           uint32_t* scratch, int B, int R, int K, int A, int D, int L,
           int Wc, int samp, int kk, int key_bits, cudaStream_t stream) {
  const int nw = kSmem ? smem_warps(Wc) : kWarps;
  if (nw < 1) return (int)cudaErrorInvalidValue;
  auto kernel = grow_select_kernel<kCell, kSmem>;
  // the smem path splits a stream's rows into groups, as many blocks as
  // the card holds at once (a block's list and slot ids are its own), at
  // most 32 rows a warp, and keeps a hash table of the list, 2^hash_bits
  // >= 2 * Wc words, where it fits; the global path keeps a stream in one
  // block (its list is the block's cand row)
  const long long key_words = kSmem ? (long long)nw * Wc : 0;
  const long long most_words =
      key_words > kScanWords + 32 * nw ? key_words : kScanWords + 32 * nw;
  int hash_bits = 0;
  if (kSmem) {
    int hb = 1;
    while ((1LL << hb) < 2LL * Wc) ++hb;
    if (4 * (most_words + Wc + (1LL << hb)) <= (long long)bithtm::kMaxShared)
      hash_bits = hb;
  }
  const long long table_words = hash_bits ? 1LL << hash_bits : 0;
  int groups = 1, rpw = (L + nw - 1) / nw;
  if (kSmem) {
    int per_sm = 0;
    if (int err = bithtm::resident_blocks(
            kernel, nw * 32, 4 * (size_t)(most_words + Wc + table_words),
            &per_sm))
      return err;
    const long long want =
        (long long)bithtm::sm_count() * (per_sm > 0 ? per_sm : 1);
    const long long most = (L + nw - 1) / nw;
    const long long g = (want + B - 1) / B;
    groups = (int)(g < most ? g : most);
    if (groups < 1) groups = 1;
    rpw = ((L + groups - 1) / groups + nw - 1) / nw;
    if (rpw > 32) rpw = 32;
  }
  if (rpw < 1) rpw = 1;
  const int rows = rpw * nw;
  groups = L > rows ? (L + rows - 1) / rows : 1;
  const long long blocks = (long long)B * groups;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const long long rows_words = key_words > kScanWords + rows
                                   ? key_words
                                   : kScanWords + rows;
  const size_t smem = kSmem ? 4 * (size_t)(rows_words + Wc + table_words)
                            : 4 * (size_t)kScanWords;
  const int vec = Wc % 4 == 0 && reinterpret_cast<uintptr_t>(rnd) % 16 == 0;
  if (int err = bithtm::allow_shared(kernel, smem)) return err;
  kernel<<<(unsigned)blocks, nw * 32, smem, stream>>>(
      syn, act, ebytes, row_cols, Ct, G, fresh, learn, cols, bits, rnd,
      chosen, n_chosen, lidx, lvalid, lpos, cand, counts, scratch, B, R, K, A,
      D, L, Wc, samp, kk, key_bits, rows, groups, vec, hash_bits);
  return (int)cudaGetLastError();
}

}  // namespace

// syn (B, Ct, G*K) int32 and act (B, Ct, G*K) activity tables of
// act_bytes bytes a value (1: bool or u8, 2: bf16, 4: float32); row_cols
// (B, R/G) int32, the column of each of the R = (R/G)*G rows' group, or
// null for tables of gathered rows (Ct = R/G); fresh (B, R) bool, the
// rows that read as empty, given where the rows are read before the
// step's learning pass, or null; learn (B, R) bool, the learning
// flags; cols (B, A) int32 and bits (B, A, ceil(D/32)) int32, the
// previous active columns and winner words; rnd (B, L, Wc) int32 random
// words -> chosen (B, L, kk) and n_chosen (B, L) int32, kk = min(samp,
// Wc); lidx (B, L) int32 and lvalid (B, L) bool; lpos (B, R) int32; cand
// (B, Wc) int32; counts (4, B) int32. cell_form selects the key form,
// key_bits its low bits; global_keys the path whose keys live in scratch
// (B, L, Wc) (else None). Launches on the given stream of the given
// device, allocates nothing and returns cudaGetLastError() after the
// launch (0 = success).
extern "C" int grow_select(const int* syn, const void* act, int act_bytes,
                           const int* row_cols, int Ct, int G,
                           const void* fresh, const void* learn,
                           const int* cols, const int* bits, const int* rnd,
                           int* chosen, int* n_chosen, int* lidx,
                           void* lvalid, int* lpos, int* cand, int* counts,
                           void* scratch, int B, int R, int K, int A, int D,
                           int L, int Wc, int samp, int key_bits,
                           int cell_form, int global_keys, int device,
                           void* stream) {
  if (B < 0 || R < 1 || K < 1 || A < 0 || D < 1 || L < 0 || Wc < 1 ||
      samp < 1 || key_bits < 1 || key_bits + (cell_form ? 1 : 2) > 31 ||
      G < 1 || R % G || Ct < 1 || (!row_cols && Ct != R / G) ||
      (act_bytes != 1 && act_bytes != 2 && act_bytes != 4) ||
      (global_keys && !scratch) || (!global_keys && smem_warps(Wc) < 1))
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  const int kk = samp < Wc ? samp : Wc;
  bithtm::DeviceGuard guard(device);
  if (int err = guard.error()) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* a = static_cast<const uint8_t*>(act);
  const uint8_t* fr = static_cast<const uint8_t*>(fresh);
  const uint8_t* lf = static_cast<const uint8_t*>(learn);
  uint8_t* lv = static_cast<uint8_t*>(lvalid);
  uint32_t* sc = static_cast<uint32_t*>(scratch);
  return bithtm::with_bool(cell_form != 0, [&](auto cell) {
    return bithtm::with_bool(global_keys == 0, [&](auto in_smem) {
      return launch<decltype(cell)::value, decltype(in_smem)::value>(
          syn, a, act_bytes, row_cols, Ct, G, fr, lf, cols, bits, rnd,
          chosen, n_chosen, lidx, lv, lpos, cand, counts, sc, B, R, K, A, D,
          L, Wc, samp, kk, key_bits, s);
    });
  });
}
