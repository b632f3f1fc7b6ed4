"""What holds a kernel back: variants of its source timed in turns.

`ncu` and `nsys` do not run where the card is, so a kernel's time is
taken apart by timing variants of it: copies of its source, each with
one part cut out or changed by a text patch, built with nvcc into
libraries of their own and called through the tree's own wrapper at the
main paths' geometries: ``--kernel grow_select`` (`csrc/grow_pass.cu`,
`VARIANTS`, on `testing.grow_inputs`), ``learn_rows``
(`csrc/learn_pass.cu`, `LEARN_VARIANTS`, on `testing.learn_inputs` and
its selection, the tables restored before each replay, since the pass
writes in place), ``seg_flags`` (`csrc/count_pass.cu`,
`FLAG_VARIANTS`: `seg_counts`' flags form, and its counts form on the
same activity as "reference") or ``column_decide``
(`csrc/decide_pass.cu`, `DECIDE_VARIANTS`: the learning mode, or the
mode a shape names, on `testing.decide_inputs`, a learning mode's owners
updated by each call) or
``sp_select`` (`csrc/select_pass.cu`, `SELECT_VARIANTS`, on
`testing.select_inputs`) or ``sp_rows`` (`csrc/sp_pass.cu`,
`ROWS_VARIANTS`, on int16 and float32 tables, each of the 20 calls of a
graph at its own disjoint columns) or ``serving_counts`` (`csrc/
serving_count_pass.cu`, `SERVING_VARIANTS`: the flags form on
`testing.serving_inputs` at the learned tables' share of active words,
and `serving_activation` over the same rows as "reference") or
``anomaly_likelihood`` / ``seasonal_zscore`` (`csrc/anomaly_pass.cu`,
`STAGE_VARIANTS`, at the cases of `testing.LIKELIHOOD_CASES` /
`testing.ZSCORE_CASES`, e.g. ``--shapes bench``). A variant
whose patch does not match the
source is reported as not applicable. Variants that cut a part out give
wrong results; they are timed, never checked. Each variant's ms a call
is the median of ``--rounds`` rounds, the variants in turns within a
round, each a CUDA graph of 20 calls replayed 10 times (CUDA events).
``--ptxas`` prints each build's registers, shared memory and spills
(`nvcc -Xptxas -v`).

Run on the card from the root of the tree to study (whose package is
the one imported):

  python -m bithtm_tpu_torch.scripts.grow_variants [--kernel learn_rows]
      [--ptxas] [--shapes bench,16k_tuned] [--rounds 5] [--variants a,b]

Prints one JSON line: {shape: {variant: ms}}.
"""

from __future__ import annotations

import argparse
import ctypes
import itertools
import json
import shutil
import statistics
import subprocess

import torch

from .. import testing
from ..config import TMConfig, make_htm_config
from ..models import spatial_pooler as psp
from ..models import temporal_memory as ptm
from ..ops import active_set as pas
from ..ops import kernels
from ..ops import regularization as preg
from ..ops.overlap import padded_input_dim

# B, C, D, A, G, K, Wc, L, samp (chip_smoke.py GROW_MAIN)
SHAPES = {
    "bench": (256, 2048, 32, 41, 4, 64, 128, 88, 32),
    "16k_tuned": (64, 16384, 64, 328, 4, 64, 384, 336, 32),
    "16k_auto": (64, 16384, 64, 328, 4, 64, 768, 824, 32),
}

# name: [(text in the source, its replacement)]. The first six are the
# suspects of the earlier kernel, which selected by successive warp
# minima (one warp a row, rows of a block behind one staging of the
# list); the rest cut the stages of the kernel that replaced it.
_MINIMA = ("  uint32_t last = 0;\n  for (int j = 0; j < m; ++j) {",
           "  uint32_t last = 0;\n"
           "  for (int i = lane; i < m; i += 32) out[i] = (int)keys[i];\n"
           "  for (int j = 0; j < 0; ++j) {")
_RND = ("bits_r = static_cast<uint32_t>(__ldg(rnd_r + i))",
        "bits_r = static_cast<uint32_t>(i * 2654435761u)")
_SEARCH = ("for (int i = lower_bound(list, n_cand, s);",
           "for (int i = n_cand;")
VARIANTS = {
    "base": [],
    # (a) the serial rounds of successive minima: the m smallest keys
    # written unsorted, with no round
    "no_minima": [_MINIMA],
    # (b) the row's dependent loads: no random words read
    "no_rnd_loads": [_RND],
    # (c) the staging: 16 rows a block behind one staging, not 4
    "rows16": [("constexpr int kWarps = 4;", "constexpr int kWarps = 16;")],
    # (d) the per-target binary searches: none
    "no_search": [_SEARCH],
    # what is left with (a), (b) and (d) cut
    "no_minima_rnd_search": [_MINIMA, _RND, _SEARCH],
    # the kernel that replaced it: the prologue alone (no row work); the
    # prologue and the rows' loads (no keys, targets or selection); no
    # selection; no target lookups; binary searches for the targets (no
    # hash table); no first bound from the guess
    "new_prologue_only": [("      if (r < R && cap_grow > 0) {",
                           "      if (false) {")],
    "new_loads_only": [("  if (n_grow == 0 || n_cand == 0) {",
                        "  if (true) {")],
    "new_no_select": [(
        "  return select_row<kCell>(keys, n_cand, n_grow, c_valid, guess, "
        "c_guess,\n                           cap, out, (1u << bits) - 1u, "
        "lane);", "  return 0;")],
    "new_no_search": [(
        "      pos[u] = target[u] ? find_cell(list, table, hash_bits, n_cand, "
        "s[u])\n                         : -1;", "      pos[u] = -1;")],
    "new_bsearch": [("      hash_bits = hb;", "      hash_bits = 0;")],
    "new_no_guess": [("  if (c_hi > cap) {\n    if (c_guess >= m) {",
                      "  if (false) {\n    if (c_guess >= m) {")],
}


# `learn_rows` (its "v16" path, which the bench and 16K take): the body
# emptied at the same grid (a launch's floor); the earlier schedule (a
# warp a row behind a block prologue, now the "scalar" path); the
# write-back cut; every vector stored, changed or not; the fill cut (no
# row takes a cell); the next column's header read before this column's
# work, not after it; a warp a column, not a run of them; 8 warps a
# block, not 4 (at most 64 registers a thread); at most 64 registers a
# thread, not 128
LEARN_VARIANTS = {
    "base": [],
    "empty": [("  if (q0 >= q1) return;\n  const int J = G * K;",
               "  if (q0 >= q1 || B > 0) return;\n  const int J = G * K;")],
    "scalar": [("  if (vec)\n    return bithtm::with_bool(kk <= 32",
                "  if (false)\n    return bithtm::with_bool(kk <= 32")],
    "no_stores": [("      if (in) {\n        const long long at = cur.base "
                   "+ k;", "      if (false) {\n        const long long at "
                   "= cur.base + k;")],
    "store_all": [("          if ((schg >> (4 * v)) & 0xfu)",
                   "          if (true)"),
                  ("          if ((pchg >> (4 * v)) & 0xfu)",
                   "          if (true)")],
    "no_fill": [("    const int n_row =\n        h.l >= 0 ? __ldg(n_chosen "
                 "+ (long long)b * L + h.l) : 0;", "    const int n_row = 0;")],
    "ahead": [("    const ColHead cur = h;\n",
               "    const ColHead cur = h;\n    if (q + 1 < q1)\n"
               "      h = col_head(cols, learn, fresh, lpos, q + 1, nb, na, "
               "Ct, G, K, lane);\n"),
              ("    if (q + 1 < q1)\n      h = col_head(cols, learn, fresh, "
               "lpos, q + 1, nb, na, Ct, G, K, lane);\n  }", "  }")],
    "one_column_a_warp": [("  const long long chunk = (n_pairs + slots - 1) "
                           "/ (slots > 0 ? slots : 1);",
                           "  const long long chunk = 1;")],
    "warps_8": [("constexpr int kColWarps = 4;",
                 "constexpr int kColWarps = 8;")],
    "regs_64": [("constexpr int kColMinBlocks = 4;",
                 "constexpr int kColMinBlocks = 8;")],
}
# `seg_counts`' flags form (the shuffle path the bench and 16K take): no
# prediction words; no owner cells read; no matching word stored; all
# three (what is left is the count kernel's loop and sums)
_NO_PRED = ("if (lead) matching_word[col] = static_cast<int>(word);\n"
            "      if (prediction) {",
            "if (lead) matching_word[col] = static_cast<int>(word);\n"
            "      if (false) {")
_NO_CELL = ("      cell[u] = sub == 0 && seg[u] < nseg ? __ldg(seg_cell + seg[u]) "
            ": -1;\n    }\n    segment_sums",
            "      cell[u] = -1;\n    }\n    segment_sums")
_NO_WORD = ("      if (lead) matching_word[col] = static_cast<int>(word);",
            "")
FLAG_VARIANTS = {
    "base": [],
    "no_pred": [_NO_PRED],
    "no_cell": [_NO_CELL],
    "no_word": [_NO_WORD],
    "sums_only": [_NO_PRED, _NO_CELL, _NO_WORD],
}
# `column_decide`: the body emptied at the same grid (a launch's floor);
# one block a stream, not split (the earlier grid); at least two blocks a
# stream (the bench's 41 columns a warp each); split over twice the
# blocks; the bursting columns' key argmax cut (the matching column's min
# reduce kept); the evictable slots' ranks cut; the body emptied at the
# kernel's first line, and the split streams' meeting cut (the launch
# floor's parts); no cap of 32 registers a thread (one block of 1,024
# threads an SM); the split grid met by a cluster, not a ticket. (The clusters of 8-32-warp
# blocks a stream, met in distributed shared memory, were variants of the
# kernel this one replaced.)
DECIDE_VARIANTS = {
    "base": [],
    "empty": [("  const bool has_prev = MODE == 2 && __ldg(p.step + b) > 0;",
               "  if (p.B > 0) return;\n"
               "  const bool has_prev = MODE == 2 && __ldg(p.step + b) > 0;")],
    "one_block_a_stream": [("evict != 0, split,\n"
                            "                 (A + split - 1) / split};",
                            "evict != 0, 1, A};")],
    "split_2_at_least": [("evict != 0, split,\n"
                          "                 (A + split - 1) / split};",
                          "evict != 0, max(split, min(A, 2)),\n"
                          "                 (A + max(split, min(A, 2)) - 1) "
                          "/ max(split, min(A, 2))};")],
    "split_x2": [("evict != 0, split,\n"
                  "                 (A + split - 1) / split};",
                  "evict != 0, split > 1 ? min(A, 2 * split) : 1,\n"
                  "                 (A + (split > 1 ? min(A, 2 * split) : 1) "
                  "- 1) / (split > 1 ? min(A, 2 * split) : 1)};")],
    "no_key_argmax": [("    if (col_max >= (float)p.theta_m) {",
                       "    if (true) {")],
    "no_evict_ranks": [("    if (ev && n_unacc > n_rec) {",
                        "    if (false) {")],
    "empty_top": [("    column_decide_kernel(Decide p) {\n",
                   "    column_decide_kernel(Decide p) {\n"
                   "  if (p.B > 0) return;\n")],
    "no_meet": [("  // a split stream: add the totals, then the last block "
                 "reads them out\n", "  if (p.B > 0) return;\n")],
    "no_register_cap": [("constexpr int kMinBlocks = 2;",
                         "constexpr int kMinBlocks = 1;")],
    # the split grid met by a cluster a stream in distributed shared
    # memory (block 0 sums the blocks' totals), not by the ticket
    "cluster": [
        ('#include "launch.cuh"',
         '#include "launch.cuh"\n#include <cooperative_groups.h>'),
        ("  if (threadIdx.x < nc && total) atomicAdd(&g_meet[b][threadIdx.x]"
         ", total);\n  __threadfence();\n  __syncthreads();\n"
         "  if (threadIdx.x == 0)\n"
         "    last_block = atomicAdd(&g_meet[b][kCounts], 1) == p.split - 1;"
         "\n  __syncthreads();\n  if (last_block) {",
         "  __shared__ int block_total[kCounts];\n"
         "  if (threadIdx.x < nc) block_total[threadIdx.x] = total;\n"
         "  cooperative_groups::cluster_group cl =\n"
         "      cooperative_groups::this_cluster();\n  cl.sync();\n"
         "  if (cl.block_rank() == 0 && threadIdx.x < nc) {\n"
         "    int t = 0;\n    for (int r = 0; r < p.split; ++r)\n"
         "      t += *cl.map_shared_rank(&block_total[threadIdx.x], r);\n"
         "    p.counts[(long long)threadIdx.x * p.B + b] = t;\n  }\n"
         "  cl.sync();\n  if (false) {"),
        ("  column_decide_kernel<MODE, NW><<<grid, threads, 0, s>>>(p);",
         "  cudaLaunchConfig_t cfg = {};\n  cfg.gridDim = grid;\n"
         "  cfg.blockDim = dim3(threads);\n  cfg.stream = s;\n"
         "  cudaLaunchAttribute attr[1];\n"
         "  attr[0].id = cudaLaunchAttributeClusterDimension;\n"
         "  attr[0].val.clusterDim.x = 1;\n"
         "  attr[0].val.clusterDim.y = p.split;\n"
         "  attr[0].val.clusterDim.z = 1;\n  cfg.attrs = attr;\n"
         "  cfg.numAttrs = 1;\n"
         "  cudaLaunchKernelEx(&cfg, column_decide_kernel<MODE, NW>, p);")],
}
# `sp_select`: the float64 exp as float32 `__expf` (wrong bits); the
# winners placed by the LSD sort past 128 of them (16K's 328 too), or at
# any count (the bench's 41 too); the places cut; their count's loop not
# unrolled; a block a stream where a warp a stream takes the streams
# (65,536 streams of 64 columns), or a warp a stream up to 512 columns
# (the anomaly stack's 256 of 512 columns); the lists in global memory
# sorted by the stream's one block, not a cluster of 8; 512 threads of 4
# columns at the bench's 2,048, not 256 of 8; a block a stream at 16K,
# not a cluster of two
SELECT_VARIANTS = {
    "base": [],
    "f32_exp": [("(float)exp((double)__fmul_rn(scale, duty))",
                 "__expf(__fmul_rn(scale, duty))")],
    "lsd_past_128": [("constexpr int kRankMax = 512;",
                      "constexpr int kRankMax = 128;")],
    "lsd_always": [("constexpr int kRankMax = 512;",
                    "constexpr int kRankMax = 0;")],
    "no_places": [
        ("#pragma unroll 4\n      for (int j = part; j < A; j += parts) r += "
         "list[j] > pair;", "      r = part ? 0 : first + k * step;"),
        ("lsd_sort<kCluster>(list, list + A, A, diff, counts, sh)", "list")],
    "no_warp_grid": [("  const bool warp = A <= kWarpList && C <= "
                      "kWarpCols;", "  const bool warp = false;")],
    "warp_grid_to_512": [("constexpr int kWarpCols = 128;",
                          "constexpr int kWarpCols = 512;")],
    "rank_rolled": [("#pragma unroll 4\n      for (int j = part; j < A; "
                     "j += parts)", "      for (int j = part; j < A; "
                     "j += parts)")],
    "sort_one_block": [("constexpr int kSortBlocks = 8;",
                        "constexpr int kSortBlocks = 1;")],
    "threads_512": [(
        "  if (C <= 256 * 8) return launch<256, 8>(p, B, smem, s);",
        "  if (C <= 256 * 4) return launch<256, 8>(p, B, smem, s);\n"
        "  if (C <= 512 * 4) return launch<512, 4>(p, B, smem, s);")],
    "no_cluster": [("  if (C <= kSplitBlocks * kMaxThreads * 8 && B <= "
                    "kSplitStreams && !lsd)",
                    "  if (false)")],
}
# `sp_rows`: the input staging cut; the first-claim marks cut; the row
# stores cut; the packed bytes' store cut; the update's arithmetic cut (a
# compare kept); runs of any size or of at most 24 units, not 48; a ring of
# 32 KB or 128 KB a block, not 64 KB (2 or 8 units in flight a warp in
# int16); half or twice the blocks a launch
_RING = ("constexpr int kRingBytes = 64 * 1024;",)
_FILL = ("constexpr int kFillBlocks = 264;",)
ROWS_VARIANTS = {
    "base": [],
    "no_staging": [("  for (int w = threadIdx.x; w < n_xs; w += kThreads) {",
                    "  for (int w = threadIdx.x; w < 0; w += kThreads) {")],
    "no_claims": [("    for (int a = threadIdx.x; a < A; a += kThreads) {\n"
                   "      const int c = __ldg(cb + a);",
                   "    for (int a = threadIdx.x; a < 0; a += kThreads) {\n"
                   "      const int c = __ldg(cb + a);")],
    "no_stores": [("        *reinterpret_cast<typename Quad<T>::V*>(row + "
                   "(size_t)j * S) = q.v;\n", "")],
    "no_pack": [("      *reinterpret_cast<uint32_t*>(pack + ((size_t)b * C + c)"
                 " * S +\n                                   t * kUnitBytes + "
                 "w) = packed;", "")],
    "no_math": [("          q[e] = op.add(q[e], d, &conn);",
                 "          conn = q[e] > d;")],
    "run_units_any": [("constexpr int kRunUnits = 48;",
                       "constexpr int kRunUnits = 1 << 30;")],
    "run_units_24": [("constexpr int kRunUnits = 48;",
                      "constexpr int kRunUnits = 24;")],
    "ring_32k": [(_RING[0], "constexpr int kRingBytes = 32 * 1024;")],
    "ring_128k": [(_RING[0], "constexpr int kRingBytes = 128 * 1024;")],
    "fill_132": [(_FILL[0], "constexpr int kFillBlocks = 132;")],
    "fill_528": [(_FILL[0], "constexpr int kFillBlocks = 528;")],
}
# `serving_counts` (flags form): eight or two waves of blocks in the range
# grid, not one; two or eight columns a warp at once, not four; the sums
# of rows with no active word not skipped
SERVING_VARIANTS = {
    "base": [],
    "waves8": [("constexpr int kRangeWaves = 1;",
                "constexpr int kRangeWaves = 8;")],
    "waves2": [("constexpr int kRangeWaves = 1;",
                "constexpr int kRangeWaves = 2;")],
    "cols2": [("constexpr int kCols = 4;", "constexpr int kCols = 2;")],
    "cols8": [("constexpr int kCols = 4;", "constexpr int kCols = 8;")],
    "no_skip": [("if (__any_sync(kAll, any)) {", "if (true) {")],
}
# the anomaly stages (`anomaly_likelihood`, `seasonal_zscore`), the
# design's choices: lanes a step (a warp a step at every window, not a
# thread up to 4,096 slots; a thread a step at every T, not a warp a
# step up to 8 steps); steps a block (a lane block's warps 4 or 16,
# not 8: tiles of 128 or 512 steps; a warp block's at most 8 steps, not
# 16; a short series' 1 warp, not 4) and the blocks a stream (the warp
# path's aim of 132 or 1,056 blocks, not 264); the EMA producer (its
# chain before the sums, not beside them; the chain cut); and what a step
# costs: a thread's or a warp's sums cut, the windows' rebuild from the
# inputs cut, the new ring's write cut, erff cut, the median cut (wrong
# results, timed)
STAGE_VARIANTS = {
    "base": [],
    "warp_steps": [("constexpr int kLaneWindow = 4096;",
                    "constexpr int kLaneWindow = 0;")],
    "no_wide": [("constexpr int kWideSteps = 8;",
                 "constexpr int kWideSteps = 0;")],
    "lane_warps_4": [("constexpr int kLaneWarps = 8;",
                      "constexpr int kLaneWarps = 4;")],
    "lane_warps_16": [("constexpr int kLaneWarps = 8;",
                       "constexpr int kLaneWarps = 16;")],
    "warp_steps_8": [("constexpr int kWarpSteps = 16;",
                      "constexpr int kWarpSteps = 8;")],
    "fill_132": [("constexpr int kFillBlocks = 264;",
                  "constexpr int kFillBlocks = 132;")],
    "fill_1056": [("constexpr int kFillBlocks = 264;",
                   "constexpr int kFillBlocks = 1056;")],
    "serial_ema": [("        shorts[i] = sm;\n      }\n",
                    "        shorts[i] = sm;\n      }\n"
                    "    if (!kWide) __syncthreads();\n")],
    "no_ema": [("sm = __fmaf_rn(s, one_minus, __fmul_rn(m, count0 > -t ? sm"
                " : s));", "sm = s;"),
               ("sm = __fmaf_rn(s, one_minus, __fmul_rn(m, count0 > -(t + i)"
                " ? sm : s));", "sm = s;")],
    "no_sums": [("  for (int c6 = 0; c6 < n; c6 += 4096) {",
                 "  for (int c6 = 0; c6 < 0; c6 += 4096) {")],
    "no_fill": [("if (u - first >= 0 && u - first < split) vals[u - first]"
                 " = v;", "if (false) vals[u - first] = v;"),
                ("vals[h] = first + h < T ? score.series(first + h) : 0.0f;",
                 "vals[h] = 0.0f;"),
                ("vals[h] = first + h < tau0 ? res.carried(first + h) : 0.0f;",
                 "vals[h] = 0.0f;"),
                ("if (s >= tau0 && s < end) vals[h] = res.fresh(s);",
                 "if (false) vals[h] = 0.0f;")],
    "no_erf": [("erff(__fdiv_rn(z, kSqrt2))", "z")],
    "wide_warps_1": [("constexpr int kWideWarps = 4;",
                      "constexpr int kWideWarps = 1;")],
    "no_new_ring": [("ring_out[b * W + j] = vals[T - 1 - wrap(last - j, W) -"
                     " first];", "ring_out[b * W + j] = 0.0f;")],
    "no_warp_sums": [("const int rounds = (n + 511) / 512;",
                      "const int rounds = 0;")],
    "no_median": [("const float med = median([&](int a) { return "
                   "value(s - a * P); }, k);", "const float med = 0.0f;")],
}
# B, C, I, A, the permanence type (chip_smoke.py SP_ROWS_MAIN)
ROWS_SHAPES = {
    "bench": (256, 2048, 1000, 41, "int16"),
    "16k_tuned": (64, 16384, 1000, 328, "int16"),
    "anomaly": (256, 512, 352, 16, "float32"),
}
# kernel: (source, variants, shapes)
STUDIES = {
    "grow_select": ("grow_pass.cu", VARIANTS, SHAPES),
    "learn_rows": ("learn_pass.cu", LEARN_VARIANTS, SHAPES),
    "seg_flags": ("count_pass.cu", FLAG_VARIANTS,     # B, C, G, K, D
                  {"bench": (256, 2048, 4, 64, 32),
                   "16k_tuned": (64, 16384, 4, 64, 64)}),
    "column_decide": ("decide_pass.cu", DECIDE_VARIANTS,
                      # B, C, D, A, G, K[, the mode: "learn" if none]
                      {"bench": (256, 2048, 32, 41, 4, 64),
                       "16k_tuned": (64, 16384, 64, 328, 4, 64),
                       "bench_winner": (256, 2048, 32, 41, 4, 64, "winner"),
                       "16k_winner": (64, 16384, 64, 328, 4, 64, "winner"),
                       "bench_burst": (256, 2048, 32, 41, 4, 64, "burst"),
                       "16k_burst": (64, 16384, 64, 328, 4, 64, "burst"),
                       "anomaly": (256, 512, 8, 16, 8, 48),
                       "anomaly_winner": (256, 512, 8, 16, 8, 48, "winner"),
                       "anomaly_burst": (256, 512, 8, 16, 8, 48, "burst")}),
    "sp_select": ("select_pass.cu", SELECT_VARIANTS,  # B, C, A
                  {"bench": (256, 2048, 41),
                   "16k_tuned": (64, 16384, 328),
                   "16k_b8": (8, 16384, 328),
                   "16k_b32": (32, 16384, 328),
                   "c250_a1": (2, 250, 1),
                   "anomaly": (256, 512, 16),
                   "streams": (65_536, 64, 5),
                   "global_list": (2, 30_000, 30_000)}),
    "serving_counts": ("serving_count_pass.cu", SERVING_VARIANTS,
                       # B, C, D, A, G, M, E
                       {"bench": (256, 2048, 32, 41, 4, 1, 0),
                        "16k_tuned": (64, 16384, 64, 328, 4, 1, 0)}),
    "sp_rows": ("sp_pass.cu", ROWS_VARIANTS, ROWS_SHAPES),
    # the cases of `testing.LIKELIHOOD_CASES` / `testing.ZSCORE_CASES`
    "anomaly_likelihood": ("anomaly_pass.cu", STAGE_VARIANTS,
                           testing.LIKELIHOOD_CASES),
    "seasonal_zscore": ("anomaly_pass.cu", STAGE_VARIANTS,
                        testing.ZSCORE_CASES),
}


def build(name: str, patches, flags, ptxas: bool,
          source: str = "grow_pass.cu") -> tuple[str, object]:
    """The variant's library path and its nvcc process (None where a
    patch does not match)."""
    src = (kernels.CSRC / source).read_text()
    for old, new in patches:
        if old not in src:
            return "", None
        src = src.replace(old, new)
    out = kernels.BUILD_DIR / "variants" / source.split(".")[0] / name
    out.mkdir(parents=True, exist_ok=True)
    for header in kernels.HEADERS:
        shutil.copy(kernels.CSRC / header, out / header)
    (out / source).write_text(src)
    lib = out / "libvariant.so"
    cmd = [kernels._nvcc(), *flags, *(["-Xptxas", "-v"] if ptxas else []),
           "-shared", "-o", str(lib), str(out / source)]
    return str(lib), subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True)


def graph_ms(fn, n: int = 20, reps: int = 10, restore=None) -> float:
    """ms a call of ``fn`` in a CUDA graph of n calls (CUDA events over
    ``reps`` replays after one; with ``restore``, called before each
    replay outside the events, each replay timed alone)."""
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(n):
            fn()
    g.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if restore is None:
        start.record()
        for _ in range(reps):
            g.replay()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / (n * reps)
    total = 0.0
    for _ in range(reps):
        restore()
        torch.cuda.synchronize()
        start.record()
        g.replay()
        end.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(end)
    return total / (n * reps)


def study_calls(kernel: str, geo: tuple, dev) -> tuple:
    """The wrapper call a variant is timed on at ``geo``, the restore
    before each replay (or None), the `CudaKernel` whose bound function
    each variant's library replaces, and a reference call timed beside
    the variants with the tree's own library (or None)."""
    if kernel == "grow_select":
        x = testing.grow_inputs(sum(geo), *geo, device=dev)
        return (lambda: kernels.grow_select_cuda(**x)), None, \
            kernels.GROW_SELECT, None
    if kernel == "seg_flags":
        B, C, G, K, D = geo
        g = torch.Generator(device=dev).manual_seed(sum(geo))
        act = torch.rand((B, C, G * K), generator=g, device=dev) < 0.5
        conn = act & (torch.rand((B, C, G * K), generator=g,
                                 device=dev) < 0.4)
        v = pas.pack_act_conn(act, conn, K)
        cell = torch.randint(0, D + 1, (B, C, G), generator=g, device=dev,
                             dtype=torch.int32)
        return (lambda: kernels.seg_flags_cuda(v, cell, K, K // 2, K // 5,
                                               D)), None, kernels.SEG_COUNTS, \
            (lambda: kernels.seg_counts_cuda(v, G, K))
    if kernel == "serving_counts":
        # the learned tables' share of active words, about 0.5%: no lane
        # aimed at the active set, a third empty
        B, C, D, A, G, M, E = geo
        x = testing.serving_inputs(sum(geo), *geo, device=dev, empty=0.35,
                                   hit=0.0)
        args = (x["rows"], x["ext_col"], x["cols"], x["bits"])
        return (lambda: kernels.serving_flags_cuda(
            *args, x["seg_cell"], C, D, 10, 13)), None, \
            kernels.SERVING_COUNTS, (lambda: kernels.serving_activation_cuda(
                x["rows"], x["cols"], x["bits"], C, D))
    if kernel == "sp_select":
        B, C, A = geo
        ov, duty = testing.select_inputs(sum(geo), B, C, device=dev)
        args = (A, testing.SELECT_INTENSITY, A / C, testing.SELECT_MOMENTUM)
        return (lambda: preg.sp_select(ov, duty, *args)), None, \
            kernels.SP_SELECT, None
    if kernel == "sp_rows":
        # 20 sets of A columns a stream, no column in two sets: each call
        # of a graph of 20 finds its rows out of the L2 cache (the work
        # does not depend on the values: no restore)
        B, C, I, A, dtype = geo
        cfg = make_htm_config(I, C, 4, active_columns=A, sp_overrides={
            "permanence_dtype": dtype}).sp
        g = torch.Generator(device=dev).manual_seed(B + C + I + A)
        shape = (B, C, padded_input_dim(I))
        if dtype == "int16":
            perm = torch.randint(-300, 300, shape, generator=g, device=dev,
                                 dtype=torch.int16)
        else:
            perm = (torch.rand(shape, generator=g, device=dev) - 0.5) * 0.2
        conn = torch.zeros(shape[:2] + (shape[2] // 8,), dtype=torch.uint8,
                           device=dev)
        x = torch.rand((B, I), generator=g, device=dev) < 0.2
        n = max(1, min(20, C // A))
        order = torch.argsort(torch.rand((B, C), generator=g, device=dev),
                              dim=1)[:, :n * A].reshape(B, n, A)
        sets = itertools.cycle([c.to(torch.int32).contiguous()
                                for c in order.unbind(1)])
        steps = psp.hebbian_steps(cfg)
        return (lambda: kernels.sp_rows_cuda(perm, conn, x, next(sets),
                                             *steps)), None, \
            kernels.SP_ROWS, None
    if kernel == "anomaly_likelihood":
        from ..encoders import AnomalyLikelihoodState, anomaly_likelihood_steps

        T, B, W, R, carried = geo
        st, x = testing.likelihood_inputs(sum(map(int, geo)), *geo,
                                          device=dev)
        st = None if st is None else AnomalyLikelihoodState(*st)
        return (lambda: anomaly_likelihood_steps(st, x, 0.7, R, W)), None, \
            kernels.ANOMALY_LIKELIHOOD, None
    if kernel == "seasonal_zscore":
        from ..encoders import SeasonalZScoreState, seasonal_zscore_steps

        T, B, P, W, lags, carried, f64 = geo
        st, x = testing.zscore_inputs(sum(map(int, geo)), *geo, device=dev)
        st = None if st is None else SeasonalZScoreState(*st)
        return (lambda: seasonal_zscore_steps(st, x, P, 1e-6, W, lags)), \
            None, kernels.SEASONAL_ZSCORE, None
    if kernel == "column_decide":
        B, C, D, A, G, K, *mode = geo
        cfg = TMConfig(column_dim=C, cell_dim=D, active_columns=A,
                       segments_per_column=G, synapse_capacity=K)
        x = testing.decide_inputs(sum(geo[:6]), cfg, B, device=dev)
        args = testing.decide_args(cfg, x, *mode)
        return (lambda: ptm.column_decide(*args)), None, \
            kernels.COLUMN_DECIDE, None
    x = testing.learn_inputs(sum(geo), *geo, device=dev)
    s = x["select"]
    sel = ptm.grow_select_ref(**s)
    cells = sel.chosen
    if not s["cell_form"]:
        cells = pas.take_small_table_ref(sel.cand_cell, cells,
                                         (1 << s["key_bits"]) - 1)
    syn, perm = s["syn_rows"].clone(), x["perm"].clone()
    counts = sel.counts.clone()

    def restore():
        syn.copy_(s["syn_rows"])
        perm.copy_(x["perm"])
        counts.copy_(sel.counts)

    return (lambda: kernels.learn_rows_cuda(
        syn, perm, s["act_rows"], x["cols"], x["learn"], x["new_seg"],
        sel.lpos, cells, sel.n_chosen, counts, x["increment"],
        x["decrement"], x["permanence_initial"])), restore, \
        kernels.LEARN_ROWS, None


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(
        prog="python -m bithtm_tpu_torch.scripts.grow_variants",
        description=__doc__.split("\n")[0])
    p.add_argument("--kernel", default="grow_select", choices=list(STUDIES))
    p.add_argument("--shapes", default="bench,16k_tuned")
    p.add_argument("--variants", default=None,
                   help="comma-separated (default: every variant)")
    p.add_argument("--rounds", type=int, default=5)
    p.add_argument("--ptxas", action="store_true")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("grow_variants times the card only: no CUDA device "
                         "(torch.cuda.is_available() is false)")
    dev = torch.device("cuda")
    source, variants, shapes = STUDIES[args.kernel]
    names = (args.variants or ",".join(variants)).split(",")
    procs = {n: build(n, variants[n], kernels.NVCC_FLAGS, args.ptxas,
                      source) for n in names}
    libs = {}
    for n, (lib, proc) in procs.items():
        if proc is None:
            print(f"variant {n}: not applicable to this source")
            continue
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on variant {n}:\n{log}")
        if args.ptxas:
            print(f"variant {n} (ptxas):\n" + "\n".join(
                line for line in log.splitlines()
                if "registers" in line or "spill" in line
                or "Compiling entry" in line))
        libs[n] = ctypes.CDLL(lib)
    out = {}
    library = kernels._library
    kernel = None
    try:
        for shape in args.shapes.split(","):
            geo = shapes[shape]
            call, restore, kernel, reference = study_calls(args.kernel, geo,
                                                           dev)
            times = {n: [] for n in libs}
            if reference is not None:
                times["reference"] = []
            for r in range(args.rounds):
                order = list(libs)[r % len(libs):] + list(libs)[
                    :r % len(libs)]
                for n in order:
                    kernels._library = lambda lib=libs[n]: lib
                    kernel._fn = None
                    times[n].append(graph_ms(call, restore=restore))
                if reference is not None:
                    kernels._library = library
                    kernel._fn = None
                    times["reference"].append(graph_ms(reference))
            out[shape] = {n: statistics.median(t) for n, t in times.items()}
            print(f"{shape} {geo}: " + ", ".join(
                f"{n} {ms:.4f}" for n, ms in out[shape].items())
                  + " ms a call in a graph of 20")
            del call, restore, reference
            torch.cuda.empty_cache()
    finally:
        kernels._library = library
        if kernel is not None:
            kernel._fn = None
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
