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
// of dependent loads and shuffles sets the time instead.
//
// Design. A block takes a stream and its warps (up to 32) its columns,
// a warp a column: lane g holds segment g (G <= 32) and, word by word,
// lane i cell 32 w + i. The per-cell max and count come from the
// segment lanes by shuffles, once a word (kept in registers up to two
// words a column, D <= 64); the first argmax is a warp reduce of (score,
// index), the lower index winning a tie; the words are ballots; the
// unaccounted cells' ranks are popcounts of a ballot, and the eligible
// slots' ranks of their keys shuffles over the segment lanes. A warp
// issues every load that does not need its column's index before it
// reads the index. The warps' totals meet in shared memory and the
// block writes its stream's counts once: no atomics and no zeroing
// launch. At most 32 registers a thread, so that two blocks of 1,024
// threads share an SM. What holds it back is each warp's chain of
// dependent loads and shuffles, and at 16K (B=64, A=328) a batch of 64
// blocks, up to 11 columns a warp; spreading a stream over a cluster of
// up to 8 blocks that met in distributed shared memory measured slower
// at both shapes (PERF.md).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "launch.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxWarps = 32;
constexpr int kCounts = 7;

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
};

// The max of 0.0 and seg_j of the segments that cell d owns, and how many
// segments it owns (segment g' on lane g'); none for a lane past the D
// cells (an unallocated segment's owner is D).
__device__ __forceinline__ float cell_max(int o, float sj, int G, int D,
                                          int d, int* owned) {
  float m = 0.0f;
  int n = 0;
  for (int g = 0; g < G; ++g) {
    const int og = __shfl_sync(kFull, o, g);
    const float s = __shfl_sync(kFull, sj, g);
    if (og == d && d < D) {
      m = fmaxf(m, s);
      ++n;
    }
  }
  *owned = n;
  return m;
}

// A column's cells, word by word: with NW > 0 (W == NW) each word's
// cell max, owned count and draw kept in registers, computed once; with
// NW == 0 (any W) recomputed where asked.
template <int NW>
struct Cells {
  float m[NW > 0 ? NW : 1], u[NW > 0 ? NW : 1];
  int n[NW > 0 ? NW : 1];

  __device__ __forceinline__ void load_draws(const float* u_least, int D,
                                             int lane) {
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const int d = 32 * w + lane;
      u[w] = d < D ? __ldg(u_least + d) : 0.0f;
    }
  }
  __device__ __forceinline__ void fill(int o, float sj, int G, int D,
                                       int lane) {
#pragma unroll
    for (int w = 0; w < NW; ++w)
      m[w] = cell_max(o, sj, G, D, 32 * w + lane, &n[w]);
  }
  __device__ __forceinline__ float max_at(int w, int o, float sj, int G,
                                          int D, int lane, int* owned) {
    if constexpr (NW > 0) {
      *owned = n[w];
      return m[w];
    } else {
      return cell_max(o, sj, G, D, 32 * w + lane, owned);
    }
  }
  __device__ __forceinline__ float draw_at(int w, const float* u_least,
                                           int d) {
    if constexpr (NW > 0) {
      return u[w];
    } else {
      return __ldg(u_least + d);
    }
  }
};

// m with its n lowest set bits cleared: the position of its n-th set bit.
__device__ __forceinline__ int nth_set(unsigned m, int n) {
  for (int i = 0; i < n; ++i) m &= m - 1;
  return __ffs(m) - 1;
}

// One column of one stream; the warp's running totals in sums (lane 0).
template <int MODE, int NW>
__device__ __forceinline__ void decide_column(const Decide& p, int b, int a,
                                              int lane, int* sums) {
  const int G = p.G, D = p.D, W = NW > 0 ? NW : p.W;
  const long long ba = (long long)b * p.A + a;
  const unsigned last = D % 32 ? (1u << (D % 32)) - 1u : kFull;
  const bool seg = lane < G;

  // the loads that need no column index first: the segment lanes'
  // counts and draw, the cells' draws
  int pot = 0, conn = 0, live = 0;
  float us = 0.0f;
  Cells<NW> cells;
  if (MODE >= 1) {
    if (seg) {
      pot = __ldg(p.pot + ba * G + lane);
      us = __ldg(p.u_seg + ba * G + lane);
      if (MODE == 2) {
        conn = __ldg(p.conn + ba * G + lane);
        live = __ldg(p.live + ba * G + lane);
      }
    }
    cells.load_draws(p.u_least + ba * D, D, lane);
  }
  const int col = p.cols ? __ldg(p.cols + ba) : a;
  const int* pw = p.pred + (long long)b * W * p.Ct + col;
  const long long at = ((long long)b * p.Ct + col) * G + lane;
  // the owner (written below: not through the read-only path)
  const int o = MODE >= 1 && seg ? p.seg_cell[at] : D;
  const bool match = MODE >= 1 && seg && pot >= p.theta_m;
  const float sj = match ? __fadd_rn((float)pot, us) : 0.0f;

  bool burst = true;
#pragma unroll
  for (int w = 0; w < W; ++w)
    burst &= (__ldg(pw + (long long)w * p.Ct) & (w == W - 1 ? last : kFull))
             == 0;

  // the first argmax of the bursting score
  int best_d = D;
  if (MODE >= 1) {
    cells.fill(o, sj, G, D, lane);
    float col_max = 0.0f;
#pragma unroll
    for (int w = 0; w < W; ++w) {
      int n;
      col_max = fmaxf(col_max, cells.max_at(w, o, sj, G, D, lane, &n));
    }
    for (int off = 16; off; off >>= 1)
      col_max = fmaxf(col_max, __shfl_xor_sync(kFull, col_max, off));
    const bool col_matching = col_max >= (float)p.theta_m;
    float best = -INFINITY;
#pragma unroll
    for (int w = 0; w < W; ++w) {
      const int d = 32 * w + lane;
      int n;
      const float m = cells.max_at(w, o, sj, G, D, lane, &n);
      if (d < D) {
        const float score =
            col_matching
                ? m
                : -__fadd_rn((float)n,
                             cells.draw_at(w, p.u_least + ba * D, d));
        if (best_d == D || score > best) {
          best = score;
          best_d = d;
        }
      }
    }
    for (int off = 16; off; off >>= 1) {
      const float v = __shfl_xor_sync(kFull, best, off);
      const int i = __shfl_xor_sync(kFull, best_d, off);
      if (i != D && (best_d == D || v > best || (v == best && i < best_d))) {
        best = v;
        best_d = i;
      }
    }
  }

  // mode 2: the eligible slots' ranks by key (keys are distinct)
  const bool has_prev = MODE == 2 && __ldg(p.step + b) > 0;
  bool eligible = false, evictable = false;
  int er = 0;
  if (MODE == 2) {
    const bool recyclable = live < p.theta_m;
    int key = lane + G * (o >= D);
    if (p.evict) {
      evictable = seg && !match && !recyclable;
      if (!recyclable) key = 2 * G + live * G + lane;
    }
    eligible = seg && (recyclable || evictable);
    for (int g = 0; g < G; ++g) {
      const int kg = __shfl_sync(kFull, key, g);
      const bool eg = __shfl_sync(kFull, eligible, g);
      er += eg && kg < key;
    }
  }

  // word by word: the words, the owners' flags and the allocation
  const int oc = o < 0 ? 0 : o;
  bool owner_pred = false, owner_win = false, fresh = false;
  float owner_max = 0.0f;
  int new_owner = 0, n_unacc = 0, n_act = 0, n_win = 0;
#pragma unroll
  for (int w = 0; w < W; ++w) {
    const int d = 32 * w + lane;
    const bool valid = d < D;
    const unsigned word = __ldg(pw + (long long)w * p.Ct);
    const bool pred = valid && ((word >> lane) & 1u);
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
      int n;
      const float m = cells.max_at(w, o, sj, G, D, lane, &n);
      const unsigned un_w = __ballot_sync(kFull, win && m < p.eps &&
                                                     has_prev);
      const float at_owner = __shfl_sync(kFull, m, oc & 31);
      if (o < D && (oc >> 5) == w) {
        owner_pred = (word >> (oc & 31)) & 1u;
        owner_win = (win_w >> (oc & 31)) & 1u;
        owner_max = at_owner;
      }
      const int r = er - n_unacc;
      if (eligible && r >= 0 && r < __popc(un_w)) {
        fresh = true;
        new_owner = 32 * w + nth_set(un_w, r);
      }
      n_unacc += __popc(un_w);
    }
  }

  int n_new = 0, n_learn = 0, n_evicted = 0;
  if (MODE == 2) {
    const bool active_seg = match && conn >= p.theta_a;
    const bool seg_best =
        match && fabsf(__fsub_rn(sj, owner_max)) < p.eps;
    const bool learn =
        (match && owner_win && (active_seg || (!owner_pred && seg_best)) &&
         has_prev) ||
        fresh;
    if (seg) {
      p.learn[ba * G + lane] = learn;
      p.new_seg[ba * G + lane] = fresh;
      if (fresh) p.seg_cell[at] = new_owner;
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

// A block a stream; warp w takes columns w, w + warps, ...
template <int MODE, int NW>
__global__ void __launch_bounds__(kMaxWarps * 32, 2)
    column_decide_kernel(Decide p) {
  __shared__ int warp_sums[kMaxWarps][kCounts];
  const int b = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  int sums[kCounts] = {};
  for (int a = warp; a < p.A; a += warps)
    decide_column<MODE, NW>(p, b, a, lane, sums);
  constexpr int n = MODE == 2 ? kCounts : 3;
  if (lane == 0)
#pragma unroll
    for (int k = 0; k < n; ++k) warp_sums[warp][k] = sums[k];
  __syncthreads();
  if (threadIdx.x < n) {
    int total = 0;
    for (int v = 0; v < warps; ++v) total += warp_sums[v][threadIdx.x];
    p.counts[(long long)threadIdx.x * p.B + b] = total;
  }
}

template <int MODE, int NW>
int launch_decide(const Decide& p, cudaStream_t s) {
  const int threads = 32 * (p.A < kMaxWarps ? p.A : kMaxWarps);
  column_decide_kernel<MODE, NW><<<p.B, threads, 0, s>>>(p);
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
// policy. Launches on the given stream of the given device, allocates
// nothing and returns cudaGetLastError() after the launch (0 = success).
extern "C" int column_decide(const int* pred, int* seg_cell, const int* cols,
                             const int* pot, const int* conn, const int* live,
                             const float* u_seg, const float* u_least,
                             const int* step, int* act_bits, int* winner_bits,
                             void* col_burst, void* learn, void* new_seg,
                             int* counts, int B, int Ct, int A, int G, int D,
                             int mode, int theta_m, int theta_a, float eps,
                             int evict, int device, void* stream) {
  if (B < 0 || A < 0 || Ct < 1 || G < 1 || G > 32 || D < 1 || mode < 0 ||
      mode > 2 || (!cols && Ct != A) || !(act_bits && winner_bits &&
      col_burst && counts) || (mode >= 1 && !(seg_cell && pot && u_seg &&
      u_least)) || (mode == 2 && !(conn && live && step && learn && new_seg)))
    return (int)cudaErrorInvalidValue;
  if ((long long)B * A == 0) return 0;
  bithtm::DeviceGuard guard(device);
  if (int err = guard.error()) return err;
  const Decide p{pred, seg_cell, cols, pot, conn, live, u_seg, u_least, step,
                 act_bits, winner_bits, static_cast<uint8_t*>(learn),
                 static_cast<uint8_t*>(new_seg),
                 static_cast<uint8_t*>(col_burst), counts, B, Ct, A, G, D,
                 (D + 31) / 32, theta_m, theta_a, eps, evict != 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case 0: return launch_mode<0>(p, s);
    case 1: return launch_mode<1>(p, s);
    default: return launch_mode<2>(p, s);
  }
}
