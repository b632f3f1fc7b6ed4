// The temporal memory's column decisions, for NVIDIA Hopper (sm_90a).
//
// Stands for the JAX package's _winner_selection, the flags of _learn and
// _allocate (bithtm_tpu/models/temporal_memory.py:106, :501, :164) and the
// bit packs of the step's active and winner cells (bithtm_tpu/ops/
// active_set.py:85), which XLA fuses into a few passes over (A, G), (A, D)
// and (A, G, D) arrays. The TPU package has no Pallas kernel for them.
// Plain PyTorch version: bithtm_tpu_torch/models/temporal_memory.py
// (column_decide_ref, which runs _winner_selection, _allocate and the
// flag lines of _learn as torch ops).
//
// Per stream b and active column a (column c = cols[b, a], or a itself
// where cols is null: a column shard's gathered rows, Ct = A), from the
// previous prediction words pred (B, W, Ct) at c, the owners o[g] =
// seg_cell[b, c, g] (D: unallocated), the row counts pot, conn and live
// (B, A, G) of row_counts, the draws u_seg (B, A, G) and u_least (B, A, D)
// and has_prev = step[b] > 0:
//   burst = no predicted cell; the activity words pred | burst
//   mode >= 1 (winner): seg_j[g] = pot[g] >= theta_m ? pot[g] + u_seg[g]
//     : 0; cell_max[d] = max(0, seg_j of the segments d owns); score[d] =
//     max_d cell_max >= theta_m ? cell_max[d] : -(owned[d] + u_least[d]);
//     winner = pred | (burst & d == the first argmax of score)
//   mode 2 (learning): the learning flags of _learn, the unaccounted
//     cells (winner & cell_max < eps & has_prev) and _allocate's rank
//     pairing: the i-th unaccounted cell, ascending, takes the eligible
//     slot of rank i by key (recyclable: live < theta_m, g + G *
//     unallocated; with evict, a mature non-matching slot 2G + live * G
//     + g); the new owners are written over seg_cell in place.
// Outputs: the activity and winner words (B, A, W), bits past D zero;
// col_burst (B, A); learn and new_seg (B, A * G) bool (mode 2); the
// per-stream counts (n, B) int32: bursting columns, active cells, winner
// cells and, in mode 2, new, learning, dropped new and evicted segments.
// Every float operation is the plain version's own: one rounded add
// (__fadd_rn, never an FMA), one rounded subtraction, compares and an
// exact negation; the first index wins a tie.
//
// Bound: bytes, and at these sizes latency. A column reads its W
// prediction words, G owners, 3 G counts, G + D draws and writes 2 W
// words, 2 G flags and its owners: at the bench (B=256, A=41, G=4, D=32)
// about 2.6 MB a step, 0.0008 ms at the H100's 3.35 TB/s; a warp's chain
// of dependent loads, shuffles and ballots sets the time instead.
//
// Design. A warp takes a column at a time: lane g holds segment g (G <=
// 32) and, word by word, lane i cell 32 w + i. The step's work is a few
// hundred warp instructions a column over 10,496 (bench) to 20,992 (16K)
// columns, so the SMs' issue, not the bytes, sets the time: each
// exchange between lanes is one warp instruction, and the per-cell values
// are never formed (the cells' maxima met in shared memory by the
// segment lanes' atomics, and __match_any_sync for the owners' lanes,
// measured slower: PERF.md). Every float operation stays the plain
// version's:
//   - the column max: one __reduce_max_sync over the bits of the owned
//     segments' seg_j (each >= 0)
//   - only a bursting column picks a winner: where the column matches,
//     the lowest owner whose seg_j is the column max (one
//     __reduce_min_sync; cell 0 where that max is 0); else the largest
//     order-preserving key of -(owned + u) (-0.0 keyed as +0.0, as the
//     float compare finds them equal; no key is 0) and its lowest cell:
//     the unowned cells' keys -(0 + u) word by word (a cell lane finds
//     its owners by G shuffles of the segment lanes' owners), one
//     __reduce_max_sync, the lowest lane holding it (a ballot and __ffs
//     a word); an owned cell's key, from
//     its segment lanes (its owned count G shuffles of the owners, u a
//     shuffle), only where -(1 + u) reaches that best, as -(n + u) falls
//     with n >= 1 (never with draws in [0, 1) and an unowned cell)
//   - a winner cell is unaccounted where no segment it owns has seg_j >=
//     eps (its cell max is below eps; eps > 0): the same G shuffles, each
//     owner tagged with that flag, then a ballot
//   - seg_best counts only for a segment of the bursting winner where
//     the column matches, whose cell max is then the column max: no
//     owner's max is formed
//   - the eligible slots' ranks: recyclable slots key by g + G *
//     unallocated, so two ballots and popcounts rank them; with evict, a
//     mature non-matching slot keys past them by (live, g), ranked by G
//     shuffles, taken only where the column's unaccounted cells reach
//     those slots
//   - the words and the counts: ballots and popcounts.
// A warp reads the indices of its columns at once, a lane each; each
// column's loads are then issued together, one round of latency.
// (Issuing a column's loads before the work on the one before cost
// registers past the cap of 32, whose spills made it slower: PERF.md.)
// The grid: a block of up to 32 warps takes a stream, or a range of its
// columns where the streams alone would leave SMs idle ("split": `split`
// blocks a stream, from ops/kernels.py `decide_split`; at 16K, B=64 and
// A=328, four blocks a stream take 82 columns each, 2-3 a warp, where
// one block a stream left 68 of the 132 SMs idle and its warps walked
// 10-11 columns each). The warps' totals meet in shared memory; a stream
// with one block writes its counts once. The blocks of a split stream
// meet without a cluster and without a zeroed buffer: each adds its
// totals to the stream's entry of a device array (g_meet, zero when the
// library loads) with one atomic a count, then takes a ticket; the last
// block, by its ticket, reads the totals out with atomicExch, which
// leaves them zero, and resets the ticket. That keeps the meeting inside
// the one launch, where atomics into the counts would need a kernel
// earlier in the step to zero them for every mode (an earlier cluster of
// up to 8 blocks a stream, which met in distributed shared memory,
// measured slower than a block a stream; PERF.md). Launches on one device
// meet in g_meet in stream order: two launches of the split path may not
// run at once on two streams of one device.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "launch.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxWarps = 32;
constexpr int kCounts = 7;
// blocks of 1,024 threads two an SM: at most 32 registers a thread
constexpr int kMinBlocks = 2;
// the streams a split launch takes (ops/kernels.py DECIDE_SPLIT_STREAMS)
constexpr int kSplitStreams = 1024;

// The split streams' meeting place: each stream's summed counts and its
// ticket, zero between launches.
__device__ int g_meet[kSplitStreams][kCounts + 1];

struct Decide {
  const int* pred;     // (B, W, Ct)
  int* seg_cell;       // (B, Ct, G)
  const int* cols;     // (B, A) or null
  const int* pot;      // (B, A, G)
  const int* conn;     // (B, A, G)
  const int* live;     // (B, A, G)
  const float* u_seg;  // (B, A, G)
  const float* u_least;  // (B, A, D)
  const int* step;     // (B,)
  int* act_bits;       // (B, A, W)
  int* winner_bits;    // (B, A, W)
  uint8_t* learn;      // (B, A * G)
  uint8_t* new_seg;    // (B, A * G)
  uint8_t* col_burst;  // (B, A)
  int* counts;         // (n, B)
  int B, Ct, A, G, D, W, theta_m, theta_a;
  float eps;
  bool evict;
  int split;           // blocks a stream
  int per;             // columns a block: ceil(A / split)
};

// Larger value, larger key; -0.0 keys as +0.0 (the float compare finds
// them equal). No key is 0.
__device__ __forceinline__ unsigned order_key(float v) {
  unsigned u = __float_as_uint(v);
  if ((u << 1) == 0) u = 0;
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// m with its n lowest set bits cleared: the position of its n-th set bit.
__device__ __forceinline__ int nth_set(unsigned m, int n) {
  for (int i = 0; i < n; ++i) m &= m - 1;
  return __ffs(m) - 1;
}

// Whether cell 32 w + lane is owned by one of the G segment lanes (bit
// 0) and by one whose seg_j reaches eps (bit 1): G shuffles of the
// segment lanes' tags (the owner, bit 30 that flag; -1 unowned). Every
// lane calls it, never behind a short-circuit that a lane past D would
// skip. (One __reduce_or_sync a word in its place hung the warp where D
// is not a multiple of 32.)
__device__ __forceinline__ int owned_cell(int tag, int G, int w, int lane) {
  const int d = 32 * w + lane;
  int own = 0;
  for (int g = 0; g < G; ++g) {
    const int t = __shfl_sync(kFull, tag, g);
    if (t >= 0 && (t & ~(1 << 30)) == d) own |= 1 | (t >> 30) << 1;
  }
  return own;
}

// One column of stream b; lane 0 adds the column's counts to the warp's
// totals (sums: registers, or in learning mode shared memory).
// With NW > 0 (W == NW) the prediction words and the cells' draws are
// read once into registers; with NW == 0 (any W) where asked.
template <int MODE, int NW>
__device__ __forceinline__ void decide_column(const Decide& p, int b, int a,
                                              int col, int lane,
                                              bool has_prev, int* sums) {
  const int G = p.G, D = p.D, W = NW > 0 ? NW : p.W;
  const long long ba = (long long)b * p.A + a;
  const unsigned last = D % 32 ? (1u << (D % 32)) - 1u : kFull;
  const unsigned below = (1u << lane) - 1u;
  const bool seg = lane < G;
  const int* pw = p.pred + (long long)b * W * p.Ct + col;
  const float* ul = p.u_least + ba * D;
  int* owner_at = p.seg_cell + ((long long)b * p.Ct + col) * G + lane;

  // every load of the column at once
  int pot = 0, conn = 0, live = 0, o = D;
  float us = 0.0f;
  if (MODE >= 1 && seg) {
    pot = __ldg(p.pot + ba * G + lane);
    us = __ldg(p.u_seg + ba * G + lane);
    if (MODE == 2) {
      conn = __ldg(p.conn + ba * G + lane);
      live = __ldg(p.live + ba * G + lane);
    }
    o = *owner_at;  // written below: not through the read-only path
  }
  unsigned words[NW > 0 ? NW : 1];
  float u[NW > 0 ? NW : 1];
#pragma unroll
  for (int w = 0; w < NW; ++w) {
    words[w] = (unsigned)__ldg(pw + (long long)w * p.Ct);
    u[w] = MODE >= 1 && 32 * w + lane < D ? __ldg(ul + 32 * w + lane)
                                          : 0.0f;
  }
  auto word = [&](int w) -> unsigned {
    if constexpr (NW > 0) {
      return words[w];
    } else {
      return (unsigned)__ldg(pw + (long long)w * p.Ct);
    }
  };
  auto draw = [&](int w) -> float {
    if constexpr (NW > 0) {
      return u[w];
    } else {
      return 32 * w + lane < D ? __ldg(ul + 32 * w + lane) : 0.0f;
    }
  };

  const bool owned = MODE >= 1 && seg && o >= 0 && o < D;
  const bool match = MODE >= 1 && seg && pot >= p.theta_m;
  const float sj = match ? __fadd_rn((float)pot, us) : 0.0f;
  // a segment lane's owner, tagged in bit 30 where its seg_j reaches eps
  // (a cell owning such a segment has a cell max >= eps); -1 unowned
  const int tag = owned ? o | (int)!(sj < p.eps) << 30 : -1;
  bool burst = true;
#pragma unroll
  for (int w = 0; w < W; ++w)
    burst &= (word(w) & (w == W - 1 ? last : kFull)) == 0;
  // a bursting column's winner: the first argmax of the bursting score
  int best_d = D;
  float col_max = 0.0f;
  if (MODE >= 1 && burst) {
    col_max = __int_as_float(
        __reduce_max_sync(kFull, owned ? __float_as_int(sj) : 0));
    if (col_max >= (float)p.theta_m) {
      best_d = col_max > 0.0f
                   ? __reduce_min_sync(kFull, owned && sj == col_max ? o
                                                                     : INT_MAX)
                   : 0;
    } else {
      // score -(owned + u): the unowned cells' -(0 + u), word by word
      unsigned keys[NW > 0 ? NW : 1];
      unsigned best = 0;
#pragma unroll
      for (int w = 0; w < W; ++w) {
        // every lane shuffles (no short-circuit past a lane's cells)
        const int own = owned_cell(tag, G, w, lane);
        const bool unowned = 32 * w + lane < D && !(own & 1);
        const unsigned k =
            unowned ? order_key(-__fadd_rn(0.0f, draw(w))) : 0u;
        if constexpr (NW > 0) keys[w] = k;
        best = max(best, k);
      }
      best = __reduce_max_sync(kFull, best);
      // an owned cell's key from its segment lanes, where one owned
      // count could reach the best (-(n + u) falls as n grows, n >= 1)
      float uo = 0.0f;
      if constexpr (NW > 0) {
#pragma unroll
        for (int w = 0; w < NW; ++w) {
          const float v = __shfl_sync(kFull, u[w], o & 31);
          if ((o >> 5) == w) uo = v;
        }
      } else {
        if (owned) uo = __ldg(ul + o);
      }
      best_d = INT_MAX;
      if (__any_sync(kFull,
                     owned && order_key(-__fadd_rn(1.0f, uo)) >= best)) {
        int n = 0;  // the segments with this lane's owner
        for (int g = 0; g < G; ++g) {
          const int og = __shfl_sync(kFull, owned ? o : -1, g);
          n += owned && og == o;
        }
        const unsigned key_o =
            owned ? order_key(-__fadd_rn((float)n, uo)) : 0u;
        best = __reduce_max_sync(kFull, max(best, key_o));
        best_d = __reduce_min_sync(kFull,
                                   owned && key_o == best ? o : INT_MAX);
      }
      int first = INT_MAX;  // the lowest unowned cell holding the best
#pragma unroll
      for (int w = 0; w < W; ++w) {
        unsigned k;
        if constexpr (NW > 0) {
          k = keys[w];
        } else {
          const int own = owned_cell(tag, G, w, lane);
          const bool unowned = 32 * w + lane < D && !(own & 1);
          k = unowned ? order_key(-__fadd_rn(0.0f, draw(w))) : 0u;
        }
        const unsigned h = __ballot_sync(kFull, k == best);
        if (h && first == INT_MAX) first = 32 * w + __ffs(h) - 1;
      }
      best_d = min(best_d, first);
    }
  }

  // word by word: the words, the owners' flags and the unaccounted cells
  // (winner cells that own no segment with seg_j >= eps)
  const bool none_unacc = !(has_prev && 0.0f < p.eps);
  bool owner_pred = false, owner_win = false;
  int n_unacc = 0, n_act = 0, n_win = 0;
  unsigned un[NW > 0 ? NW : 1];
#pragma unroll
  for (int w = 0; w < W; ++w) {
    const int d = 32 * w + lane;
    const bool valid = d < D;
    const unsigned wd = word(w);
    const bool pred = valid && ((wd >> lane) & 1u);
    const bool win = MODE >= 1 && (pred || (burst && d == best_d));
    const unsigned act_w = __ballot_sync(kFull, valid && (pred || burst));
    const unsigned win_w = __ballot_sync(kFull, win);
    if (lane == 0) {
      p.act_bits[ba * W + w] = (int)act_w;
      p.winner_bits[ba * W + w] = (int)win_w;
    }
    n_act += __popc(act_w);
    n_win += __popc(win_w);
    if (MODE == 2) {
      unsigned un_w = 0;
      if (!none_unacc) {
        const int own = owned_cell(tag, G, w, lane);
        un_w = __ballot_sync(kFull, win && !(own & 2));
      }
      if (owned && (o >> 5) == w) {
        owner_pred = (wd >> (o & 31)) & 1u;
        owner_win = (win_w >> (o & 31)) & 1u;
      }
      if constexpr (NW > 0) un[w] = un_w;
      n_unacc += __popc(un_w);
    }
  }

  int n_new = 0, n_learn = 0, n_evicted = 0;
  if (MODE == 2) {
    // the eligible slots' ranks (keys are distinct)
    const bool recyclable = seg && live < p.theta_m;
    const bool unalloc = o >= D;
    const bool evictable = p.evict && seg && !match && !recyclable;
    const unsigned ra = __ballot_sync(kFull, recyclable && !unalloc);
    const unsigned ru = __ballot_sync(kFull, recyclable && unalloc);
    const unsigned ev = __ballot_sync(kFull, evictable);
    const int n_rec = __popc(ra) + __popc(ru);
    int er = !recyclable ? n_rec
             : unalloc   ? __popc(ra) + __popc(ru & below)
                         : __popc(ra & below);
    if (ev && n_unacc > n_rec) {
      const int key = live * G + lane;
      for (int g = 0; g < G; ++g) {
        const int kg = __shfl_sync(kFull, key, g);
        er += evictable && ((ev >> g) & 1u) && kg < key;
      }
    }
    const bool eligible = recyclable || evictable;
    // the er-th unaccounted cell, ascending, takes an eligible slot
    bool fresh = false;
    int new_owner = 0, before = 0;
#pragma unroll
    for (int w = 0; w < W; ++w) {
      unsigned un_w;
      if constexpr (NW > 0) {
        un_w = un[w];
      } else {
        const int d = 32 * w + lane;
        const bool pred = d < D && ((word(w) >> lane) & 1u);
        un_w = 0;
        if (!none_unacc) {
          const int own = owned_cell(tag, G, w, lane);
          un_w = __ballot_sync(kFull,
                               (pred || (burst && d == best_d)) && !(own & 2));
        }
      }
      const int r = er - before;
      if (eligible && r >= 0 && r < __popc(un_w)) {
        fresh = true;
        new_owner = 32 * w + nth_set(un_w, r);
      }
      before += __popc(un_w);
    }
    // seg_best counts only where the owner is the bursting column's
    // winner but not predicted, and the column matches: then the owner's
    // cell max is the column max (in a column that does not match, no
    // matching segment has an owner)
    const bool active_seg = match && conn >= p.theta_a;
    const bool seg_best =
        match && fabsf(__fsub_rn(sj, col_max)) < p.eps;
    const bool learn =
        (match && owner_win && (active_seg || (!owner_pred && seg_best)) &&
         has_prev) ||
        fresh;
    if (seg) {
      p.learn[ba * G + lane] = learn;
      p.new_seg[ba * G + lane] = fresh;
      if (fresh) *owner_at = new_owner;
    }
    n_new = __popc(__ballot_sync(kFull, fresh));
    n_learn = __popc(__ballot_sync(kFull, seg && learn));
    n_evicted = __popc(__ballot_sync(kFull, fresh && evictable));
  }
  if (lane == 0) {
    p.col_burst[ba] = burst;
    sums[0] += burst;
    sums[1] += n_act;
    sums[2] += n_win;
    if (MODE == 2) {
      sums[3] += n_new;
      sums[4] += n_learn;
      sums[5] += n_unacc - n_new;
      sums[6] += n_evicted;
    }
  }
}

// Warp w's columns a0 + w, a0 + w + warps, ... below a1, up to 32 at a
// time: their indices read at once, a lane each (no division: each warp
// would issue it).
template <int MODE, int NW>
__device__ __forceinline__ void walk_columns(const Decide& p, int b, int a0,
                                             int a1, int warp, int warps,
                                             int lane, bool has_prev,
                                             int* sums) {
  for (int c0 = a0 + warp; c0 < a1; c0 += 32 * warps) {
    const int mine = c0 + lane * warps;
    const int cv = mine >= a1 ? 0
                   : p.cols   ? __ldg(p.cols + (long long)b * p.A + mine)
                              : mine;
#pragma unroll 1
    for (int k = 0; k < 32 && c0 + k * warps < a1; ++k)
      decide_column<MODE, NW>(p, b, c0 + k * warps,
                              __shfl_sync(kFull, cv, k), lane, has_prev,
                              sums);
  }
}

// Block (b, y) of stream b takes the stream's columns [a0, a1) = [y *
// per, ...), warp w the columns a0 + w, a0 + w + warps, ... (a grid of
// (B, split): no division in the prologue, whose instructions every warp
// issues)
template <int MODE, int NW>
__global__ void __launch_bounds__(kMaxWarps * 32, kMinBlocks)
    column_decide_kernel(Decide p) {
  __shared__ int warp_sums[kMaxWarps][kCounts];
  __shared__ bool last_block;
  const int b = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  const int a0 = blockIdx.y * p.per, a1 = min(p.A, a0 + p.per);
  const bool has_prev = MODE == 2 && __ldg(p.step + b) > 0;
  constexpr int nc = MODE == 2 ? kCounts : 3;
  if constexpr (MODE == 2) {
    // seven totals: in shared memory, where registers would spill
    if (lane < nc) warp_sums[warp][lane] = 0;
    __syncwarp();
    walk_columns<MODE, NW>(p, b, a0, a1, warp, warps, lane, has_prev,
                           warp_sums[warp]);
  } else {
    int sums[3] = {};
    walk_columns<MODE, NW>(p, b, a0, a1, warp, warps, lane, has_prev, sums);
    if (lane == 0)
#pragma unroll
      for (int k = 0; k < nc; ++k) warp_sums[warp][k] = sums[k];
  }
  __syncthreads();
  int total = 0;
  if (threadIdx.x < nc)
    for (int v = 0; v < warps; ++v) total += warp_sums[v][threadIdx.x];
  if (p.split == 1) {
    if (threadIdx.x < nc) p.counts[(long long)threadIdx.x * p.B + b] = total;
    return;
  }
  // a split stream: add the totals, then the last block reads them out
  if (threadIdx.x < nc && total) atomicAdd(&g_meet[b][threadIdx.x], total);
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    last_block = atomicAdd(&g_meet[b][kCounts], 1) == p.split - 1;
  __syncthreads();
  if (last_block) {
    if (threadIdx.x < nc)
      p.counts[(long long)threadIdx.x * p.B + b] =
          atomicExch(&g_meet[b][threadIdx.x], 0);
    if (threadIdx.x == 0) atomicExch(&g_meet[b][kCounts], 0);
  }
}

template <int MODE, int NW>
int launch_decide(const Decide& p, cudaStream_t s) {
  const int threads = 32 * (p.per < kMaxWarps ? p.per : kMaxWarps);
  const dim3 grid((unsigned)p.B, (unsigned)p.split);
  column_decide_kernel<MODE, NW><<<grid, threads, 0, s>>>(p);
  return (int)cudaGetLastError();
}

template <int MODE>
int launch_mode(const Decide& p, cudaStream_t s) {
  switch (p.W) {
    case 1: return launch_decide<MODE, 1>(p, s);
    case 2: return launch_decide<MODE, 2>(p, s);
    default: return launch_decide<MODE, 0>(p, s);
  }
}

}  // namespace

// pred (B, W, Ct) int32, the previous prediction words; seg_cell (B, Ct,
// G) int32, the owners (in mode 2 the new owners are written over it);
// cols (B, A) int32, the active columns, or null for gathered rows (Ct =
// A); pot, conn and live (B, A, G) int32, the row counts (conn and live
// mode 2 only, pot from mode 1); u_seg (B, A, G) and u_least (B, A, D)
// float32 draws (mode >= 1); step (B,) int32 (mode 2) -> act_bits and
// winner_bits (B, A, W) int32, W = ceil(D / 32); col_burst (B, A) bool;
// learn and new_seg (B, A * G) bool (mode 2); counts (3 or, in mode 2, 7,
// B) int32. mode: 0 bursting only (no winner: the winner words are 0), 1
// winner selection, 2 learning decisions; evict: the "evict" allocation
// policy; split: the blocks a stream (1, or up to A at up to
// kSplitStreams streams). Launches on the given stream of the given device, allocates
// nothing and returns cudaGetLastError() after the launch (0 = success).
extern "C" int column_decide(const int* pred, int* seg_cell, const int* cols,
                             const int* pot, const int* conn, const int* live,
                             const float* u_seg, const float* u_least,
                             const int* step, int* act_bits, int* winner_bits,
                             void* col_burst, void* learn, void* new_seg,
                             int* counts, int B, int Ct, int A, int G, int D,
                             int mode, int theta_m, int theta_a, float eps,
                             int evict, int split, int device,
                             void* stream) {
  if (B < 0 || A < 0 || Ct < 1 || G < 1 || G > 32 || D < 1 || mode < 0 ||
      mode > 2 || (!cols && Ct != A) || !(act_bits && winner_bits &&
      col_burst && counts) || (mode >= 1 && !(seg_cell && pot && u_seg &&
      u_least)) || (mode == 2 && !(conn && live && step && learn && new_seg))
      || split < 1 || split > 65535 ||
      (split > 1 && (B > kSplitStreams || split > A)))
    return (int)cudaErrorInvalidValue;
  if ((long long)B * A == 0) return 0;
  bithtm::DeviceGuard guard(device);
  if (int err = guard.error()) return err;
  const Decide p{pred, seg_cell, cols, pot, conn, live, u_seg, u_least, step,
                 act_bits, winner_bits, static_cast<uint8_t*>(learn),
                 static_cast<uint8_t*>(new_seg),
                 static_cast<uint8_t*>(col_burst), counts, B, Ct, A, G, D,
                 (D + 31) / 32, theta_m, theta_a, eps, evict != 0, split,
                 (A + split - 1) / split};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case 0: return launch_mode<0>(p, s);
    case 1: return launch_mode<1>(p, s);
    default: return launch_mode<2>(p, s);
  }
}
