// The compact serving table's forward pass to its counts, or to the
// step's matching and prediction words, in one kernel, for NVIDIA Hopper
// (sm_90a).
//
// Stands for the JAX package's serving_counts (bithtm_tpu/ops/serving.py
// :205, whose activation is the Pallas kernel serving_activation_tpu,
// pallas_kernels.py:835, then a count per segment and the extension rows
// folded in by a one-hot contraction, which XLA fuses), and in its flags
// form also for what tm_step's compact branch does with the counts
// (bithtm_tpu/models/temporal_memory.py:864-881: the two thresholds,
// prediction_words, ops/active_set.py:108, and the matching word, :923).
// Plain PyTorch versions: bithtm_tpu_torch/ops/serving.py
// (serving_counts_ref, serving_flags_ref), today's chain of
// serving_activation_ref, a u8 sum per segment, the M main rows' sum, the
// extension rows' scatter-add, the thresholds, prediction_words and
// pack_bits_ref.
//
// The table (ops/serving.py): rows (B, C*M + E, 128) int32 words w =
// cell << 5 | g (-1: an empty lane); column c owns the main rows c*M ..
// c*M + M - 1 and every extension row e (at row C*M + e) with
// ext_col[b, e] == c (C, or any value outside [0, C): unused), in any
// order. count[b, c, g] = the words of column c's rows whose cell is in
// the stream's active set and whose segment field is g (< G). The flags
// form writes no counts but
//   matching_word[b, c]      bit g where count >= theta_m
//   prediction[b, w, c]      bit d where a segment g with count >= theta_a
//                            is owned by cell seg_cell[b, c, g] = 32 w + d
//                            (an owner outside [0, D), such as the
//                            unallocated D, never lands)
//
// Bound: bytes. The words are read once (4 B each), with ext_col,
// seg_cell and the active set, and the outputs written once: on the
// learned bench table (B=256, C=2048, M=1, E=0, G=4, D=32) that is 268 MB
// of words + 8.4 MB of owners + 2 x 2.1 MB of words out, about 0.084 ms at
// the H100's 3.35 TB/s; at 16384 x 64 (B=64, M=1, E=0, W=2) 537 MB + 16.8
// + 4.2 + 8.4 MB, about 0.17 ms. A word costs a handful of integer
// operations and one shared-memory load, far below any peak rate.
//
// Design. Work goes to columns, not rows: a warp takes kCols neighbouring
// columns at once and reads each one's rows 16 bytes a lane (a row of
// 128 words is one 512-byte warp load); the next columns' rows are loaded
// as soon as these have been looked up, so they are in flight while
// these are summed and stored. Each lane tallies its four words in byte
// fields of NR = ceil(G/4) registers (segment g in byte g & 3 of register
// g >> 2: one funnel shift and one add a word and register), and one
// __reduce_add_sync a register sums a row over the warp (a row holds 128
// words, so a byte holds at most 128 and does not carry into the next);
// a row with no active word anywhere in the warp skips the sums. The
// warp's lanes are laid out as (column, segment) pairs, 4·NR lanes a
// column (kCols·4·NR <= 32; fewer columns at once where G passes 8), and
// lane (u, g) keeps only its own count, column u's segment g, in a
// 32-bit register across the column's rows (a count can pass 255). So
// the owners are one coalesced load a group, read before the rows'
// sums; the matching words of the group are one ballot; and a column's
// prediction words meet by log2(4·NR) shuffles over its lanes, words 0
// and 1 side by side, lane (u, 0) storing column u's words (kCols
// neighbouring words a store).
//
// Extension rows: a column's warp reads the stream's E entries of ext_col
// 32 at a time (E is 0 on the learned bench and 16K tables, 8 or more
// where a column spills, and ext_col sits in L1 after the first column)
// and a ballot gives the entries whose owner is one of its columns; each
// such row is counted like a main row and added to its column's lanes.
// No (B, C, G) scratch, no second launch, and any order of the extension
// rows.
//
// The active set: the shared-memory bitmap of active_bitmap.cuh, or past
// 1,859,584 cells the global-memory one (GLOBAL), under the row-range
// schedule of serving_pass.cu (`range_grid`, `walk_rows`) with columns as
// its rows: a block takes a contiguous range of the B*C flattened
// columns and builds a stream's bitmap only where its range enters that
// stream. One wave of resident blocks (kRangeWaves), not the word passes'
// eight: a block builds its bitmap before its first load, and fewer
// blocks build fewer bitmaps (at 16384 x 64, B=64: 132 blocks of 1,024
// threads and about 7,900 columns each; `scripts/grow_variants.py
// --kernel serving_counts` times eight and two waves, two and eight
// columns a warp, and the sums not skipped). The grid has no y extent,
// so B has no limit. The serving_activation kernel stays for callers of
// the activation itself.

#include "active_bitmap.cuh"
#include "launch.cuh"

namespace {

using bithtm::cell_active;

constexpr int kServingWidth = 128;  // words a serving row
constexpr int kServingGBits = 5;    // ops/serving.py SERVING_G_BITS
constexpr int kCols = 4;  // columns a warp counts at once, G <= 4
// waves of resident blocks in the range grid: one, not the word passes'
// kWaves, since each block builds its bitmap again
constexpr int kRangeWaves = 1;
constexpr unsigned kAll = 0xffffffffu;

// Adds one row's words to the lane's tally of NR registers: a word w =
// cell << 5 | g whose cell is active adds 1 to byte g & 3 of register
// g >> 2. An empty lane (-1) has a negative cell, never active; a
// segment field at or past G lands in a byte that no lane reads as a
// segment below G, or in no register (the funnel shift of a count by
// 8g - 32r bits past 31, or below 0 as an unsigned, gives 0).
template <int NR, bool GLOBAL>
__device__ __forceinline__ void tally(const uint32_t* bm, int4 q,
                                      int n_cells, unsigned (&acc)[NR]) {
  const int words[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int w = words[i];
    const unsigned on = cell_active<GLOBAL>(bm, w >> kServingGBits, n_cells);
    const unsigned at = (w & ((1 << kServingGBits) - 1)) << 3;
#pragma unroll
    for (int r = 0; r < NR; ++r)
      acc[r] += __funnelshift_lc(0u, on, at - 32u * r);
  }
}

__device__ __forceinline__ int4 load_row(const int* row, int lane) {
  return __ldg(reinterpret_cast<const int4*>(row) + lane);
}

// counts (FLAGS false) or matching_word and prediction (FLAGS true) of
// the columns in this block's range of the B*C flattened columns.
template <int NR, int THREADS, bool GLOBAL, bool FLAGS>
__global__ void __launch_bounds__(THREADS) serving_count_kernel(
    const int* __restrict__ rows, const int* __restrict__ ext_col,
    const int* __restrict__ cols, const int* __restrict__ bits,
    const int* __restrict__ seg_cell, uint32_t* __restrict__ bms,
    int* __restrict__ counts, int* __restrict__ matching_word,
    int* __restrict__ prediction, int B, int R, int E, int M, int A, int W,
    int C, int D, int G, int theta_m, int theta_a) {
  // lanes a column (its segments' counts, 4 a register) and the columns
  // a warp counts at once
  constexpr int kSeg = 4 * NR;
  constexpr int kc = kCols * kSeg <= 32 ? kCols : 32 / kSeg;
  constexpr int stride = THREADS / 32 * kc;
  extern __shared__ __align__(16) uint32_t smem_bm[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  // this lane's column of the warp's kc and its segment
  const int u_l = lane / kSeg, g_l = lane % kSeg;
  const int n_cells = C * D;
  bithtm::walk_rows<GLOBAL>(GLOBAL ? bms : smem_bm, B, C, cols, bits, A, W,
                            C, D,
                            [&](const uint32_t* bm, int b, int lo, int hi) {
    const int* table = rows + (size_t)b * R * kServingWidth;
    const int* ext = ext_col + (size_t)b * E;
    const size_t col0 = (size_t)b * C;
    // main row m of columns c .. c + kc - 1 (empty lanes past hi)
    auto load = [&](int4 (&q)[kc], int c, int m) {
#pragma unroll
      for (int u = 0; u < kc; ++u)
        q[u] = c + u < hi ? load_row(table + ((size_t)(c + u) * M + m) *
                                                 kServingWidth, lane)
                          : make_int4(-1, -1, -1, -1);
    };
    // lane (u_l, g_l)'s byte of the warp's sum of the tallies of row u
    auto pick = [&](const unsigned (&acc)[NR], int u, unsigned& mine) {
#pragma unroll
      for (int r = 0; r < NR; ++r) {
        const unsigned sum = __reduce_add_sync(kAll, acc[r]);
        if (u == u_l && r == g_l >> 2) mine = sum;
      }
    };
    int4 q[kc];
    if (lo + warp * kc < hi && M > 0) load(q, lo + warp * kc, 0);
    for (int c0 = lo + warp * kc; c0 < hi; c0 += stride) {
      // lane (u_l, g_l) counts segment g_l of column c0 + u_l
      const bool seg = u_l < kc && g_l < G && c0 + u_l < hi;
      const int cell =
          FLAGS && seg ? __ldg(seg_cell + (col0 + c0 + u_l) * G + g_l) : -1;
      int cnt = 0;
      for (int m = 0; m < M; ++m) {
        unsigned acc[kc][NR];
        bool any = false;
#pragma unroll
        for (int u = 0; u < kc; ++u) {
#pragma unroll
          for (int r = 0; r < NR; ++r) acc[u][r] = 0u;
          tally<NR, GLOBAL>(bm, q[u], n_cells, acc[u]);
#pragma unroll
          for (int r = 0; r < NR; ++r) any |= acc[u][r] != 0u;
        }
        // the next rows in flight while these are summed and stored
        const int next = m + 1 < M ? c0 : c0 + stride;
        if (next < hi) load(q, next, m + 1 < M ? m + 1 : 0);
        if (__any_sync(kAll, any)) {
          unsigned mine = 0u;
#pragma unroll
          for (int u = 0; u < kc; ++u) pick(acc[u], u, mine);
          cnt += (mine >> ((g_l & 3) << 3)) & 0xffu;
        }
      }
      // the extension rows of these columns, in whatever order they lie
      for (int e0 = 0; e0 < E; e0 += 32) {
        const int owner = e0 + lane < E ? __ldg(ext + e0 + lane) : -1;
        const int at = owner - c0;
        unsigned hits = __ballot_sync(kAll, owner < hi && at >= 0 && at < kc);
        while (hits) {
          const int src = __ffs(hits) - 1;
          hits &= hits - 1;
          unsigned acc[NR];
#pragma unroll
          for (int r = 0; r < NR; ++r) acc[r] = 0u;
          tally<NR, GLOBAL>(bm,
                            load_row(table + ((size_t)C * M + e0 + src) *
                                                 kServingWidth, lane),
                            n_cells, acc);
          unsigned mine = 0u;
          pick(acc, __shfl_sync(kAll, at, src), mine);
          cnt += (mine >> ((g_l & 3) << 3)) & 0xffu;
        }
      }
      // lane (u, 0) stores column c0 + u's words
      const bool lead = g_l == 0 && u_l < kc && c0 + u_l < hi;
      if constexpr (FLAGS) {
        const unsigned match = __ballot_sync(kAll, seg && cnt >= theta_m);
        if (lead)
          matching_word[col0 + c0 + u_l] = static_cast<int>(
              kSeg == 32 ? match : (match >> (u_l * kSeg)) &
                                       ((1u << (kSeg & 31)) - 1u));
        // a column's prediction words meet by log2(kSeg) shuffles over
        // its lanes, words 0 and 1 side by side
        const bool fire = seg && cnt >= theta_a && cell >= 0 && cell < D;
        const unsigned hit = fire ? 1u << (cell & 31) : 0u;
        const int word_of = cell >> 5;
        unsigned b0 = word_of == 0 ? hit : 0u;
        unsigned b1 = word_of == 1 ? hit : 0u;
#pragma unroll
        for (int o = 1; o < kSeg; o <<= 1) {
          b0 |= __shfl_xor_sync(kAll, b0, o);
          b1 |= __shfl_xor_sync(kAll, b1, o);
        }
        int* pred = prediction + (size_t)b * W * C + c0 + u_l;
        if (lead) {
          pred[0] = static_cast<int>(b0);
          if (W > 1) pred[C] = static_cast<int>(b1);
        }
        for (int w = 2; w < W; ++w) {
          unsigned bw = word_of == w ? hit : 0u;
#pragma unroll
          for (int o = 1; o < kSeg; o <<= 1)
            bw |= __shfl_xor_sync(kAll, bw, o);
          if (lead) pred[(size_t)w * C] = static_cast<int>(bw);
        }
      } else {
        if (seg) counts[(col0 + c0 + u_l) * G + g_l] = cnt;
      }
    }
  });
}

template <int NR, bool GLOBAL, bool FLAGS>
int grid_for(int C, int D, int device, bithtm::Grid* grid) {
  return bithtm::range_grid(
      serving_count_kernel<NR, bithtm::kThreads, GLOBAL, FLAGS>,
      serving_count_kernel<NR, bithtm::kWideThreads, GLOBAL, FLAGS>,
      GLOBAL ? 0 : bithtm::bitmap_bytes(C, D), device, grid, kRangeWaves);
}

// Calls f with the registers of byte fields that G segments take (1, 2,
// 4 or 8), as a std::integral_constant.
template <class F>
int with_regs(int G, F&& f) {
  if (G <= 4) return f(std::integral_constant<int, 1>{});
  if (G <= 8) return f(std::integral_constant<int, 2>{});
  if (G <= 16) return f(std::integral_constant<int, 4>{});
  return f(std::integral_constant<int, 8>{});
}

template <int NR, bool GLOBAL, bool FLAGS>
int launch(const int* rows, const int* ext_col, const int* cols,
           const int* bits, const int* seg_cell, uint32_t* bms, int* counts,
           int* matching_word, int* prediction, int B, int R, int E, int M,
           int A, int W, int C, int D, int G, int theta_m, int theta_a,
           int device, cudaStream_t stream) {
  bithtm::Grid g;
  if (int err = grid_for<NR, GLOBAL, FLAGS>(C, D, device, &g)) return err;
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
    serving_count_kernel<NR, bithtm::kWideThreads, GLOBAL, FLAGS>
        <<<g.blocks, g.threads, smem, stream>>>(
            rows, ext_col, cols, bits, seg_cell, bms, counts, matching_word,
            prediction, B, R, E, M, A, W, C, D, G, theta_m, theta_a);
  else
    serving_count_kernel<NR, bithtm::kThreads, GLOBAL, FLAGS>
        <<<g.blocks, g.threads, smem, stream>>>(
            rows, ext_col, cols, bits, seg_cell, bms, counts, matching_word,
            prediction, B, R, E, M, A, W, C, D, G, theta_m, theta_a);
  return (int)cudaGetLastError();
}

}  // namespace

// rows (B, R, 128) int32 serving words, R = C*M + E, 16-byte aligned;
// ext_col (B, E) int32; cols (B, A) and bits (B, A, W) int32, W =
// ceil(D/32), the active set; bitmaps null for the shared-memory bitmap,
// else a scratch of B * bitmap_stride(C, D) words (active_bitmap.cuh).
// Counts form (seg_cell null): counts (B, C, G) int32. Flags form
// (seg_cell (B, C, G) int32 not null): matching_word (B, C) and
// prediction (B, W, C) int32, counts null. 1 <= G <= 32. Launches on the
// given stream of the given device, allocates nothing and returns
// cudaGetLastError() after the launch (0 = success).
extern "C" int serving_counts(const int* rows, const int* ext_col,
                              const int* cols, const int* bits,
                              const int* seg_cell, uint32_t* bitmaps,
                              int* counts, int* matching_word,
                              int* prediction, int B, int R, int E, int A,
                              int W, int C, int D, int G, int theta_m,
                              int theta_a, int device, void* stream) {
  const bool flags = seg_cell != nullptr;
  if (B < 0 || C < 1 || D < 1 || G < 1 || G > 32 || E < 0 || R < E ||
      (R - E) % C != 0 || reinterpret_cast<uintptr_t>(rows) % 16 != 0 ||
      (flags ? !matching_word || !prediction || counts
             : !counts || matching_word || prediction))
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  const int M = (R - E) / C;
  bithtm::DeviceGuard guard(device);
  if (int err = guard.error()) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return with_regs(G, [&](auto regs) {
    return bithtm::with_bool(bitmaps != nullptr, [&](auto global) {
      return bithtm::with_bool(flags, [&](auto form) {
        return launch<decltype(regs)::value, decltype(global)::value,
                      decltype(form)::value>(
            rows, ext_col, cols, bits, seg_cell, bitmaps, counts,
            matching_word, prediction, B, R, E, M, A, W, C, D, G, theta_m,
            theta_a, device, s);
      });
    });
  });
}

// The grid that serving_counts launches for G segments over a bitmap of
// C*D cells in global memory (global != 0) or shared memory, in its
// flags form (flags != 0) or counts form, on `device`: blocks and
// threads a block. Returns a cudaError_t as int (0 = success).
extern "C" int serving_counts_grid(int C, int D, int G, int global,
                                   int flags, int device, int* blocks,
                                   int* threads) {
  bithtm::DeviceGuard guard(device);
  if (int err = guard.error()) return err;
  bithtm::Grid g;
  const int err = with_regs(G, [&](auto regs) {
    return bithtm::with_bool(global != 0, [&](auto glob) {
      return bithtm::with_bool(flags != 0, [&](auto form) {
        return grid_for<decltype(regs)::value, decltype(glob)::value,
                        decltype(form)::value>(C, D, device, &g);
      });
    });
  });
  *blocks = g.blocks;
  *threads = g.threads;
  return err;
}
