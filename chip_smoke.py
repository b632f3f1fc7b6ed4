"""Smoke run of the PyTorch port on one NVIDIA GPU: `python3 chip_smoke.py`.

Builds the CUDA kernels from `bithtm_tpu_torch/csrc`, checks each one
against its plain PyTorch version (bench shapes; `small_table_take` at
the 16K x 64 shapes with its index mask, and at Wc = 2049 and 4096;
`sp_update_pack` also with inactive rows past the rail and -0.0;
`sp_overlap` and `seg_counts`, the SP overlap and the per-segment count
decode, also at the 16K x 64 shapes and in a CUDA graph of 20 calls,
where `seg_counts` must be no slower than the int32 sum, and its flags
form, which also writes the matching word and the prediction words, at
those shapes, K = 125-128 and D = 8, 33, 48, 64; `grow_select`,
`row_counts`, `learn_rows` and `pack_bits`, the growth's lists and
selection read from the tables, the active rows' counts, the learning
pass over the active rows (cleanup, update, death and the fill, in
place) and the bit pack, in the phase `check_grow_and_pack` at the
bench, 16K x 64 (tuned and auto caps), reference-stack and anomaly
shapes, each in a CUDA graph of 20 calls, and on every path their
wrappers report; `sp_rows`, the SP's update of its active rows and
their connected words in place, in the phase `check_sp_rows` at the SP
of every learning path (bench, 16K x 64, the B=1 reference stack, both
anomaly-stack layers), at 65,536 streams, rows of 40 tiles and past the
first-claim bitmaps' 65,536 columns, on tables whose rows hold values
past the rail and -0.0 and with a column listed twice, timed on
disjoint columns a call, also in a CUDA graph; `sp_select`, the SP's
boost, top-A inhibition and duty-cycle EMA, in the phase
`check_sp_select` at the SP of every path (bench, 16K x 64 (a cluster of
two blocks a stream), anomaly, the B=1 reference), on tie-heavy streams,
-0.0, C off a multiple of 4, A = 1 and A = C, the keys read again from
global memory, a warp a stream (65,536 streams; ties), the LSD sort of the
winners in shared memory and, by a cluster of eight blocks a stream, in
global memory (A = 12,000 and A = C = 30,000), every row also in a CUDA
graph of 20 beside `torch.topk` in one (`check_boost` holds its factor
to the CPU's); `serving_counts`, the
compact serving table's counts and, in its flags form, the packed
serving step's matching and prediction words, in one pass over the
table, both forms in the phase `check_serving_counts` at G = 1, 8 and
32, two prediction words a column, M = 2 and 3, no extension rows,
extension rows in column order, empty lanes, the global bitmap and
65,537 streams, and on the learned bench and 16K serving tables (in
`run_serving` and `run_16k`, also in a CUDA graph of 20);
`anomaly_likelihood` and `seasonal_zscore`, the anomaly pipeline's two
stages over a whole (T, B) series in one launch each, in the phase
`check_anomaly_stages` at the anomaly benchmark's shapes (1,440 steps,
B=256), one step from a carried mid-ring state, a window off a multiple
of 32 with exclude 0, count saturating and t crossing L and L + W, one
stream, 65,537 streams, 5 lags and rings past shared memory (the
"global" path), the new state bit for bit and L and z within the CPU
tests' tolerances, each also in a CUDA graph of 20, each public call of
the stages one device kernel under the profiler;
`column_decide`,
the TM's column decisions (the winner selection, `_learn`'s flags and
`_allocate`, with the active and winner cells' words), in the phase
`check_column_decide` on the calls that eager steps from the learned
states made (bench, 16K x 64, the reference stack at B=1 and B=256, the
anomaly stack and the fuzz geometries, each learning, inferring with
winners and serving), at the columns and on gathered rows; `table_update`,
which writes its activity over its `act_prev`, against its plain
version and its out-of-place form, each on its own copy, and timed on
a fresh copy a call), with
its time, its plain version's, its bound and where one exists a single
PyTorch call's (the table kernels and the row-range word kernels with
the grid their launcher chose; `small_table_take` with its wrapper's
host issue, stage by stage, its call site old and new, and its device
time); checks that the port learns
and that its CUDA run agrees bit for bit with its CPU run on a small
input, then drives the main path: the bench configuration (2048 columns
x 32 cells, G=4 x K=64, int16 SP, B=256 streams) through `htm_scan`, 768
learning steps then inference, and checks that every kernel of that path
was launched once a step (the table kernel, `sp_overlap`, `sp_select`,
`column_decide`, `seg_counts` and at learning `row_counts`,
`grow_select`, `learn_rows` and `sp_rows`; a packed serving step
`serving_counts` in place of the table pass and `seg_counts`, and no
step `serving_activation` or `pack_bits`;
`testing.step_launches` gives every count this
script holds a run to), that the metrics are in range, that the graph
learned to predict and that the state invariants hold. Then serves the
next 64 steps from the learned state three ways (`htm_serve_scan` over
the synapse tables, over a compact serving table, and the scan over the
frozen word table), checks that they predict alike and launch only
their own kernel, and that serve -> `resume_learning` -> learn equals
learning after the unpacked serve. Then drives the entry points
that no scan calls (`sp_update_pack` against `sp_step`'s learning,
`synapse_activation` against the state's own activity,
`serving_activation` against its plain version, and an inference step
with a `distal_forward` hook, whose matching word `pack_bits` packs,
against the stock step), holds the SP's
boost on the card against the CPU's (seeded and learned duty cycles,
ROADMAP fault k), measures the
steady window (the last 128 learning steps) three times from one
snapshot with the same draws, times the phases of a step and profiles 16
of its steps on the device.

Then, with the bench state freed, the 16K x 64 path (16384 columns x 64
cells, A=328, B=64): `htm_scan_autocap` under the tuned caps of
`bench.py` (Wc=384, L=336) over 512 learning steps in chunks of 128,
with the index-keyed growth selection and its `small_table_take` decode
launched once a step, then inference and serving packed and unpacked
(each form launching only its own kernel), and the table and serving
kernels held against their plain versions and timed at that geometry on
the learned state.

Then `bithtm_tpu_torch.parallel` (`run_parallel`), each sharded run held
bit for bit in every leaf and metric to the single-process run with the
same draws: (a) the model axis at 16K x 64, the first 16 learned streams
on a 1 x 2 mesh (8,192 columns a rank) over two worker processes on this
card under gloo, 16 learning + 8 serving steps, with each rank's kernel
launches, ms/step, exchange bytes and ms a step and peak memory, and
`table_update`/`act_conn` on a column shard held and timed; (b) the data
axis at the bench configuration, the main path's state on a 2 x 1 mesh,
32 learning steps with no exchange; (c) NCCL in this process, a 1 x 1
mesh and a one-rank column shard.

Then the single-stream reference API at 1000 -> 2048x32 (the oracle
gate, B=1 learning through the wrapper with a checkpoint restored, the
CLI), and last the NAB-style pipeline at BASELINE configuration 3 (352
inputs from the scalar and time-of-day encoders -> 512 columns x 8
cells, A=16, G=8, K=48; `run_anomaly`): the anomaly benchmark's 8 tasks
x 32 seeds as B=256 streams (the encoders on the card equal to the
CPU's, one 1,440-step learning scan launching `table_update` once a
step, the likelihood and z-score on the card one kernel launch each
and within tolerance of the CPU's, mean F1 >= 0.9 on the spike and
frequency-change tasks), a
two-layer stack at B=256 (both layers learn, two table kernels a step,
`stack_scan` equal to a loop of `stack_step`), the sequence-prediction
and anomaly-detection example scripts, and a scan fed by
`prefetch_to_device` equal to the direct one; `table_update` and
`act_conn` are also held bit-equal and timed at that table (D=8, the
bitmap build's per-cell branch).

Beside those: `check_paths` holds every path the kernels take past the
main path's shapes bit-equal to the plain versions and times it (the
packed activity in bf16 and float32 at K = 126-128, the global-memory
bitmap at 32,768 x 64 and one column past the shared-memory limit and
on a column shard, 65,536 streams folded into grid x for `act_frozen`,
`sp_update_pack` and `sp_overlap`, `seg_counts` on u8, bf16 and float32
activity at K = 125-128, `sp_update_pack` past its shared memory); `run_fuzz_on_card` runs the 22 config-fuzz
geometries through `tm_step` on the card and the CPU with the same
draws, bit-equal; `run_parity` runs `scripts.parity_check` (tiny, mid,
bisect, `--sp`, and `full --from_state` on two streams of the learned
bench state); `run_profile` runs `scripts.profile_step` at bench
learning (device ms a step by call site, within 10% of the graph's
busy); `run_soaks` carries the learned 16K state on to step 2,048
under `htm_scan_autocap` and runs `soak_evict_pressure` and
`soak_fast_stack` (2,000 x 256, held to the JAX record). Each kernel's
row in the `kernels` line lists the paths checked.

Every entry point above replays its step's CUDA graph (the port's
default on the card, `bithtm_tpu_torch/models/graph.py`); the launch
counts count a graph's kernels once a replay. Beside each path, its loop
(`graph.eager()`) and its graph run from the same learned state with
`loop_vs_graph`: bit-equal in every leaf and metric, the same launches
and generator state, then three timed runs of each in turns and a
device profile of each (ms/step, device busy, launches a step, busy
share): at the bench configuration 64 learning, 16 inference and 64
serving steps of each form (`run_graph_bench`), at 16K 128 learning
steps under `htm_scan_autocap` and a forced escalation, a B=1 wrapper
epoch (`wrapper_vs_loop`), 128 anomaly learning steps and 64 stack
learning steps. `small_table_take`, `torch.gather` and `table_update` at
B=1 are also timed inside a CUDA graph (`graph_ms`).

Prints the card's name and power limit, the step times, the phase
times, the profile, a JSON line of per-kernel results, a JSON line of
the loop-against-graph numbers, and as the last
line `{"ok": true, "device": {...}}`. Any
failure raises and exits non-zero; without a GPU it exits non-zero
before printing a result.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import itertools
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

import bithtm_tpu_torch as bt
from bithtm_tpu_torch.models import graph as bgraph
from bithtm_tpu_torch.models import spatial_pooler as psp
from bithtm_tpu_torch.models import temporal_memory as ptm
from bithtm_tpu_torch.models.htm import _scan_impl, _step_metrics
from bithtm_tpu_torch.ops import active_set as pas
from bithtm_tpu_torch.ops import kernels
from bithtm_tpu_torch.ops import regularization as preg
from bithtm_tpu_torch.ops import serving as psv
from bithtm_tpu_torch.ops.bitops import popcount32
from bithtm_tpu_torch.ops.overlap import (input_words, overlaps, pack_input,
                                          overlaps_ref, padded_input_dim)
from bithtm_tpu_torch.parallel import mesh as pmesh
from bithtm_tpu_torch import encoders as penc
from bithtm_tpu_torch import testing
from bithtm_tpu_torch.testing import serving_rows, table_inputs
from bithtm_tpu_torch.testing import step_launches as steps
from bithtm_tpu_torch.utils.profiling import device_events, warm_profile

BENCH = dict(input_dim=1000, column_dim=2048, cell_dim=32,
             segments_per_column=4, synapse_capacity=64,
             sp_overrides={"permanence_dtype": "int16"})
BATCH = 256
# bench.py runs T=384 learning steps; the smoke runs twice that, so that
# each of the 100 patterns repeats often enough for its segments to be
# reinforced past the connection threshold and to predict
LEARN_STEPS, INFER_STEPS = 768, 16
# serving steps after the main path, and learning steps after resuming
SERVE_STEPS, RESUME_STEPS = 64, 8
# learning steps between two host timings; the last WINDOW learning
# steps are the timed steady window
WINDOW = 128
REPEATS = 3     # runs of that window (the main run and replays)
PROFILED_STEPS = 16
ENTRY_STEPS = 4  # SP steps that check sp_update_pack against sp_step
# the small drive-recipe config: 64 inputs, 64 columns, 4 cells, A=4
SMALL = dict(input_dim=64, column_dim=64, cell_dim=4, active_columns=4,
             segment_activation_threshold=2, segment_matching_threshold=2,
             segment_sampling_synapses=8)
# the scaled geometry of docs/PERFORMANCE.md ("Scaled config: 16K columns
# x 64 cells", BASELINE.json configs[4]) with the bench's fast stack, at
# its per-chip batch; tuned caps of bench.py --winner_capacity 384
# --growth_capacity 336
GEOM_16K = dict(input_dim=1000, column_dim=16384, cell_dim=64,
                segments_per_column=4, synapse_capacity=64,
                sp_overrides={"permanence_dtype": "int16"})
BATCH_16K = 64
TUNED_16K = dict(winner_capacity=384, growth_capacity=336)
LEARN_16K, CHUNK_16K, INFER_16K, SERVE_16K = 512, 128, 16, 32
# loop against graph from a learned state: steps of each path
GRAPH_LEARN, GRAPH_INFER, GRAPH_SERVE = 64, 16, 64   # bench
GRAPH_16K, GRAPH_ESCALATE = 128, 32   # 16K under autocap; forced escalation
GRAPH_ANOMALY, GRAPH_STACK = 128, 64
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
F32_OPS_PER_S = 67e12      # H100 SXM float32 rate outside the tensor cores
REPO = os.path.dirname(os.path.abspath(__file__))
SOURCES = {
    "table_update": "bithtm_tpu_torch/csrc/table_pass.cu",
    "act_conn": "bithtm_tpu_torch/csrc/table_pass.cu",
    "serving_activation": "bithtm_tpu_torch/csrc/serving_pass.cu",
    "act_frozen": "bithtm_tpu_torch/csrc/serving_pass.cu",
    "synapse_activation": "bithtm_tpu_torch/csrc/serving_pass.cu",
    "small_table_take": "bithtm_tpu_torch/csrc/small_take.cu",
    "sp_update_pack": "bithtm_tpu_torch/csrc/sp_pass.cu",
    "sp_rows": "bithtm_tpu_torch/csrc/sp_pass.cu",
    "sp_overlap": "bithtm_tpu_torch/csrc/overlap_pass.cu",
    "seg_counts": "bithtm_tpu_torch/csrc/count_pass.cu",
    "grow_select": "bithtm_tpu_torch/csrc/grow_pass.cu",
    "row_counts": "bithtm_tpu_torch/csrc/learn_pass.cu",
    "learn_rows": "bithtm_tpu_torch/csrc/learn_pass.cu",
    "column_decide": "bithtm_tpu_torch/csrc/decide_pass.cu",
    "pack_bits": "bithtm_tpu_torch/csrc/pack_pass.cu",
    "sp_select": "bithtm_tpu_torch/csrc/select_pass.cu",
    "serving_counts": "bithtm_tpu_torch/csrc/serving_count_pass.cu",
    "anomaly_likelihood": "bithtm_tpu_torch/csrc/anomaly_pass.cu",
    "seasonal_zscore": "bithtm_tpu_torch/csrc/anomaly_pass.cu",
}
REPLACES = {
    "table_update": "bithtm_tpu/ops/pallas_kernels.py:489",
    "act_conn": "bithtm_tpu/ops/pallas_kernels.py:698",
    "serving_activation": "bithtm_tpu/ops/pallas_kernels.py:835",
    "act_frozen": "bithtm_tpu/ops/pallas_kernels.py:772",
    "synapse_activation": "bithtm_tpu/ops/pallas_kernels.py:661",
    "small_table_take": "bithtm_tpu/ops/pallas_kernels.py:885",
    "sp_update_pack": "bithtm_tpu/ops/pallas_kernels.py:598",
    # no Pallas kernel: the JAX functions that XLA fuses into one pass
    "sp_overlap": "bithtm_tpu/ops/overlap.py:85",
    "sp_rows": "bithtm_tpu/models/spatial_pooler.py:81",
    "seg_counts": "bithtm_tpu/ops/active_set.py:588",
    "grow_select": "bithtm_tpu/models/temporal_memory.py:350",
    "row_counts": "bithtm_tpu/models/temporal_memory.py:106",
    "learn_rows": "bithtm_tpu/models/temporal_memory.py:501",
    # `_winner_selection`, `_allocate` and `_learn`'s decisions
    "column_decide": "bithtm_tpu/models/temporal_memory.py:106,164,501",
    "pack_bits": "bithtm_tpu/ops/active_set.py:85",
    # `boost`, `duty_cycle_update` and `k_winners`
    "sp_select": "bithtm_tpu/ops/regularization.py:20,28,37",
    # `serving_counts` (its activation the Pallas serving kernel, :835)
    # and the compact branch of `tm_step` after it
    "serving_counts": "bithtm_tpu/ops/serving.py:205",
    # the anomaly stages' updates, which the JAX package runs as a lax.scan
    "anomaly_likelihood": "bithtm_tpu/encoders.py:171",
    "seasonal_zscore": "bithtm_tpu/encoders.py:255,291",
}


def require(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def only(**counts) -> dict:
    """A launch-count dict: the given counts, every other kernel 0."""
    return {k.name: counts.get(k.name, 0) for k in kernels.KERNELS}


def gpu_line(dev: torch.device) -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()
    return smi[dev.index or 0]


def gpu_info(dev: torch.device) -> dict:
    print(gpu_line(dev))
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}")
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}


def cuda_ms(fn, n: int = 20, warm: int = 3) -> float:
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def fresh(t: torch.Tensor, n: int = 23):
    """A callable that hands out n copies of ``t`` in turn: each of the 3
    warm-up and 20 timed calls of `cuda_ms` gets a copy that no call has
    written yet. `table_update` writes its activity over ``act_prev``,
    so a timed loop that passed one tensor would punish by the last
    call's activity; with copies each call does the work of the first.
    Give the kernel and its plain version a `fresh` each."""
    copies = itertools.cycle([t.clone() for _ in range(n)])
    return lambda: next(copies)


def table_update_in_place(syn, perm, act_prev, pun_word, cols, bits, D: int,
                          K: int, pun: float, thr: float, what: str,
                          **shard) -> tuple[torch.Tensor, torch.Tensor]:
    """`table_update_cuda` and `table_update_ref`, each on its own copies
    of ``perm`` and ``act_prev``: both return the ``act_prev`` they were
    given, holding the activity, and agree bit for bit with each other
    and with the kernel's out-of-place form (act_prev and v_out two
    buffers, the entry point called directly). Returns (activity,
    punished permanences) of the plain version."""
    p_ref, p_k, p_o = perm.clone(), perm.clone(), perm.clone()
    a_ref, a_k = act_prev.clone(), act_prev.clone()
    v_ref = pas.table_update_ref(syn, p_ref, a_ref, pun_word, cols, bits, D,
                                 K, pun, thr, **shard)
    v_k = kernels.table_update_cuda(syn, p_k, a_k, pun_word, cols, bits, D,
                                    K, pun, thr, **shard)
    B, C, J = syn.shape
    column_dim = shard.get("column_dim", C)
    out = torch.empty_like(act_prev)
    _scratch, bm_p = kernels._bitmap_scratch(kernels.TABLE_UPDATE.path[0], B,
                                             column_dim, D, syn.device)
    dev = syn.get_device()
    kernels.TABLE_UPDATE.bind()(
        syn.data_ptr(), p_o.data_ptr(), act_prev.data_ptr(),
        pun_word.data_ptr(), cols.data_ptr(), bits.data_ptr(), bm_p,
        out.data_ptr(), B, C, column_dim, J, cols.shape[-1], bits.shape[-1],
        D, K, pun, thr, pas.act_scale(K), act_prev.element_size(), dev,
        kernels._stream(dev))
    torch.cuda.synchronize()
    require(v_ref is a_ref and v_k is a_k,
            f"table_update writes its activity over act_prev at {what}")
    require(same_bits(v_k, v_ref) and same_bits(p_k, p_ref),
            f"table_update == plain at {what}, bit for bit")
    require(same_bits(v_k, out) and same_bits(p_k, p_o),
            f"table_update in place == its out-of-place form at {what}")
    return v_ref, p_ref


def kernel_row(name: str, kernel, plain, moved: int, at: str,
               library=None, **extra) -> dict:
    """Times of a kernel call, its plain version and the library call
    (CUDA events, 20 calls after 3), and its bound: ``moved`` bytes (each
    input read once, each output written once; an in-place output only
    where it changes) over the card's memory rate. The kernels do a few
    integer operations a byte, far below any peak rate, so bytes bound
    them all. Every caller has required the kernel's output to equal the
    plain version's bit for bit, so the error is 0. ``extra`` fields
    (the launch grid, host issue) join the row and its printed line."""
    row = {"ms": cuda_ms(kernel), "plain_ms": cuda_ms(plain),
           "max_abs_err": 0.0, "bound_ms": 1e3 * moved / HBM_BYTES_PER_S,
           "bound_by": "bytes",
           "library_ms": None if library is None else cuda_ms(library),
           "at": at, **extra}
    lib = ("none" if library is None
           else f"{row['library_ms']:.4f} ms")
    more = "".join(f", {k} {v}" for k, v in extra.items())
    print(f"kernel {name}: {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} "
          f"ms, bound {row['bound_ms']:.4f} ms ({moved / 1e6:.1f} MB), "
          f"library call {lib}, at {at}{more}; bit-equal")
    return row


def table_grid(punish: bool, syn, D: int) -> str:
    """The row-range grid `table_update` (``punish``) or `act_conn`
    launches for ``syn``'s (B, C, J) table: blocks x threads."""
    _, C, J = syn.shape
    blocks, threads, _ = kernels.table_pass_grid(punish, C, J, D,
                                                 syn.get_device())
    return f"{blocks}x{threads}"


def word_grid(serving: bool, table, C: int, D: int) -> str:
    """The row-range grid `serving_activation` (``serving``, a (B, R,
    128) table) or `synapse_activation` (a (B, R, J) table) launches over
    C*D cells: blocks x threads."""
    blocks, threads, _ = kernels.word_pass_grid(serving, C, table.shape[-1],
                                                D, table.get_device())
    return f"{blocks}x{threads}"


def check_kernels(dev) -> dict:
    """Each kernel against its plain version, bit-equal, with the times
    and bound of `kernel_row`: the table and serving kernels and
    `synapse_activation` at the bench shapes, `sp_update_pack` at the
    bench SP shapes in int16 (the bench's) and float32, `small_table_take`
    at the 16K shapes under the tuned and the auto caps."""
    B, C, D = BATCH, BENCH["column_dim"], BENCH["cell_dim"]
    G, K = BENCH["segments_per_column"], BENCH["synapse_capacity"]
    A = round(0.02 * C)
    x = table_inputs(0, B, C, G, K, D, A, device=dev)
    thr, pun = 0.5, 0.01
    args = (x["syn"], x["act_prev"], x["pun_word"], x["cols"], x["bits"])
    syn, act_prev, pun_word, cols, bits = args
    at = f"B={B} C={C} G={G} K={K} D={D} A={A}"

    v_ref, p_ref = table_update_in_place(syn, x["perm"], act_prev,
                                         pun_word, cols, bits, D, K, pun,
                                         thr, at)
    c_ref = pas.synapse_activation_conn_ref(syn, x["perm"], cols, bits, D,
                                            thr, K)
    c_k = kernels.act_conn_cuda(syn, x["perm"], cols, bits, D, thr, K)
    # the step's form: into the state's activity buffer
    c_out = torch.full_like(act_prev, 7)
    c_into = kernels.act_conn_cuda(syn, x["perm"], cols, bits, D, thr, K,
                                   out=c_out)
    a_ref = pas.synapse_activation_ref(syn, cols, bits, C, D)
    a_k = kernels.synapse_activation_cuda(syn, cols, bits, C, D)
    torch.cuda.synchronize()
    require(bool((v_ref > 1).any()) and bool((p_ref != x["perm"]).any()),
            "the bench-shape inputs exercise connected and punished slots")
    require(torch.equal(c_k, c_ref), "act_conn v == plain")
    require(c_into is c_out and torch.equal(c_out, c_ref),
            "act_conn into a buffer == plain")
    require(torch.equal(a_k, a_ref), "synapse_activation == plain")
    require(torch.equal((a_ref != 0) & (x["perm"] >= 0), c_ref != 0),
            "synapse_activation on live slots == act_conn's activity")
    punished = int((p_ref != x["perm"]).sum())

    word = pas.pack_frozen_table(syn, x["perm"], thr)
    # a serving table of one main row a column and 8 extension rows
    rows = serving_rows(0, B, C + 8, C, D, G, device=dev)
    f_ref = pas.synapse_activation_frozen_ref(word, cols, bits, D, K)
    f_k = kernels.act_frozen_cuda(word, cols, bits, D, K)
    f_out = torch.full_like(act_prev, 7)
    f_into = kernels.act_frozen_cuda(word, cols, bits, D, K, out=f_out)
    s_ref = psv.serving_activation_ref(rows, cols, bits, C, D)
    s_k = kernels.serving_activation_cuda(rows, cols, bits, C, D)
    torch.cuda.synchronize()
    require(bool((f_ref > 1).any()) and bool((s_ref > 0).any()),
            "the bench-shape inputs exercise active and connected words")
    require(torch.equal(f_k, f_ref), "act_frozen v == plain")
    require(f_into is f_out and torch.equal(f_out, f_ref),
            "act_frozen into a buffer == plain")
    require(torch.equal(f_ref, c_ref), "act_frozen plain == act_conn plain")
    require(torch.equal(s_k, s_ref), "serving_activation == plain")

    p = x["perm"].clone()
    act_k, act_p = fresh(act_prev), fresh(act_prev)
    out = {
        "table_update": kernel_row(
            "table_update",
            lambda: kernels.table_update_cuda(syn, p, act_k(), pun_word,
                                              cols, bits, D, K, pun, thr),
            lambda: pas.table_update_ref(syn, p, act_p(), pun_word, cols,
                                         bits, D, K, pun, thr),
            nbytes(syn, x["perm"], act_prev, pun_word, cols, bits, v_ref)
            + 4 * punished, at, grid=table_grid(True, syn, D)),
        "act_conn": kernel_row(
            "act_conn",
            lambda: kernels.act_conn_cuda(syn, x["perm"], cols, bits, D, thr,
                                          K),
            lambda: pas.synapse_activation_conn_ref(syn, x["perm"], cols,
                                                    bits, D, thr, K),
            nbytes(syn, x["perm"], cols, bits, c_ref), at,
            grid=table_grid(False, syn, D)),
        "serving_activation": kernel_row(
            "serving_activation",
            lambda: kernels.serving_activation_cuda(rows, cols, bits, C, D),
            lambda: psv.serving_activation_ref(rows, cols, bits, C, D),
            nbytes(rows, cols, bits, s_ref),
            f"B={B} R={C + 8} rows of 128 D={D} A={A}",
            grid=word_grid(True, rows, C, D)),
        "act_frozen": kernel_row(
            "act_frozen",
            lambda: kernels.act_frozen_cuda(word, cols, bits, D, K),
            lambda: pas.synapse_activation_frozen_ref(word, cols, bits, D,
                                                      K),
            nbytes(word, cols, bits, f_ref), at),
        "synapse_activation": kernel_row(
            "synapse_activation",
            lambda: kernels.synapse_activation_cuda(syn, cols, bits, C, D),
            lambda: pas.synapse_activation_ref(syn, cols, bits, C, D),
            nbytes(syn, cols, bits, a_ref), at,
            grid=word_grid(False, syn, C, D)),
    }
    del x, p, p_ref, v_ref, c_ref, c_k, a_ref, a_k, word, rows, act_k, act_p
    del f_ref, f_k, s_ref, s_k, c_out, c_into, f_out, f_into
    out["sp_update_pack"] = check_sp_update_pack(dev)
    out.update(check_overlap_and_counts(dev))
    out["small_table_take"] = check_small_table_take(dev)
    out["reference_stack"] = check_reference_kernels(dev)
    out["anomaly_stack"] = check_anomaly_kernels(dev)
    return out


def overlap_inputs(B: int, C: int, I: int, dev, seed: int):
    """A (B, C, input_words(I)) u8 connected table of random bytes and
    (B, I) bool inputs at the bench's density 0.2."""
    g = torch.Generator(device=dev).manual_seed(seed)
    conn = torch.randint(0, 256, (B, C, input_words(I)), generator=g,
                         device=dev, dtype=torch.uint8)
    return conn, torch.rand((B, I), generator=g, device=dev) < 0.2


def count_inputs(B: int, C: int, G: int, K: int, dev, seed: int):
    """A (B, C, G*K) packed activity (`pack_act_conn`, in `act_dtype(K)`)
    with half the slots active and two in five of those connected."""
    g = torch.Generator(device=dev).manual_seed(seed)
    act = torch.rand((B, C, G * K), generator=g, device=dev) < 0.5
    conn = act & (torch.rand((B, C, G * K), generator=g, device=dev) < 0.4)
    return pas.pack_act_conn(act, conn, K)


def overlap_row(B: int, C: int, I: int, dev, want_path: tuple,
                graph: bool = True) -> dict:
    """`sp_overlap` at (B, C, I) against `overlaps_ref`, bit for bit, with
    `kernel_row`'s times and bound (the table and the inputs read once,
    the counts written once) and, with ``graph``, its ms a call in a CUDA
    graph of 20. torch has no popcount, so no single PyTorch call
    computes the overlap: no library time."""
    conn, x = overlap_inputs(B, C, I, dev, B + C + I)
    want = overlaps_ref(conn, x)
    got = kernels.sp_overlap_cuda(conn, x)
    torch.cuda.synchronize()
    require(torch.equal(got, want) and bool((want > 0).any()),
            f"sp_overlap == plain at B={B} C={C} I={I}")
    require(kernels.SP_OVERLAP.path == want_path,
            f"sp_overlap at B={B} takes {want_path}, got "
            f"{kernels.SP_OVERLAP.path}")
    row = kernel_row(f"sp_overlap [{'+'.join(want_path)}]",
                     lambda: kernels.sp_overlap_cuda(conn, x),
                     lambda: overlaps_ref(conn, x), nbytes(conn, x, want),
                     f"B={B} C={C} I={I} S={input_words(I)}",
                     path=list(want_path))
    if graph:
        row["graph_ms"] = graph_ms(lambda: kernels.sp_overlap_cuda(conn, x))
        print(f"  sp_overlap in a CUDA graph of 20 calls: "
              f"{row['graph_ms']:.4f} ms a call; no library call")
    return row


def counts_row(B: int, C: int, G: int, K: int, dev,
               graph: bool = True) -> dict:
    """`seg_counts` at (B, C, G, K) against `seg_counts_packed_ref`, bit
    for bit, with `kernel_row`'s times and bound (the activity read once,
    both counts written once); its library call is the int32 sum over the
    segment's slots (without the decode). With ``graph``, both in a CUDA
    graph of 20, where the kernel must be no slower than the sum."""
    v = count_inputs(B, C, G, K, dev, B + C + G + K)
    pot, con = pas.seg_counts_packed_ref(v, G, K)
    kp, kc = kernels.seg_counts_cuda(v, G, K)
    torch.cuda.synchronize()
    act = kernels._act_name(K)
    at = f"B={B} C={C} G={G} K={K} {act}"
    require(torch.equal(kp, pot) and torch.equal(kc, con)
            and bool((con > 0).any()), f"seg_counts == plain at {at}")
    require(kernels.SEG_COUNTS.path == (act,),
            f"seg_counts at K={K} takes ({act},), got "
            f"{kernels.SEG_COUNTS.path}")

    def library():
        return v.view(B, C, G, K).sum(-1, dtype=torch.int32)

    row = kernel_row(f"seg_counts [{act}]",
                     lambda: kernels.seg_counts_cuda(v, G, K),
                     lambda: pas.seg_counts_packed_ref(v, G, K),
                     nbytes(v, pot, con), at, library=library, path=[act])
    if graph:
        row["graph_ms"] = graph_ms(lambda: kernels.seg_counts_cuda(v, G, K))
        row["library_graph_ms"] = graph_ms(library)
        require(row["graph_ms"] <= row["library_graph_ms"],
                f"seg_counts no slower than the int32 sum in a CUDA graph "
                f"at {at}")
        print(f"  seg_counts in a CUDA graph of 20 calls: "
              f"{row['graph_ms']:.4f} ms a call, the int32 sum "
              f"{row['library_graph_ms']:.4f}")
    return row


def flags_row(B: int, C: int, G: int, K: int, D: int, dev,
              graph: bool = True) -> dict:
    """The flags form of `seg_counts` at (B, C, G, K) with owner cells
    over D cells a column, against `seg_counts_flags_ref` bit for bit
    (the matching word and the prediction words; the word alone in a
    second call, as `tm_resume` asks), with `kernel_row`'s times and bound (the activity and
    the owners read once, the words written once; thresholds K/2 and
    K/5, where about half the segments pass each). No PyTorch call
    computes the flags or packs bits: no library time. With ``graph``,
    its ms a call in a CUDA graph of 20."""
    v = count_inputs(B, C, G, K, dev, B + C + G + K + D)
    g = torch.Generator(device=dev).manual_seed(D)
    seg_cell = torch.randint(0, D + 1, (B, C, G), generator=g, device=dev,
                             dtype=torch.int32)
    th = (K // 2, K // 5)
    act = kernels._act_name(K)
    at = f"B={B} C={C} G={G} K={K} D={D} {act}"
    words = pas.seg_counts_flags_ref(v, seg_cell, K, *th, D)
    got = kernels.seg_flags_cuda(v, seg_cell, K, *th, D)
    word = kernels.seg_flags_cuda(v, seg_cell, K, *th, D, prediction=False)
    torch.cuda.synchronize()
    require(torch.equal(got[0], words[0]) and torch.equal(got[1], words[1])
            and torch.equal(word[0], words[0]) and word[1] is None
            and bool((words[0] != 0).any()) and bool((words[1] != 0).any()),
            f"seg_counts flags form == plain at {at}")
    require(kernels.SEG_COUNTS.path == (act, "flags"),
            f"seg_counts flags at K={K} takes ({act}, flags), got "
            f"{kernels.SEG_COUNTS.path}")
    row = kernel_row(f"seg_counts [{act}+flags]",
                     lambda: kernels.seg_flags_cuda(v, seg_cell, K, *th, D),
                     lambda: pas.seg_counts_flags_ref(v, seg_cell, K, *th,
                                                      D),
                     nbytes(v, seg_cell, *words), at,
                     path=[act, "flags"])
    if graph:
        row["graph_ms"] = graph_ms(
            lambda: kernels.seg_flags_cuda(v, seg_cell, K, *th, D))
        print(f"  seg_counts flags form in a CUDA graph of 20 calls: "
              f"{row['graph_ms']:.4f} ms a call; no library call")
    return row


def check_overlap_and_counts(dev) -> dict:
    """`sp_overlap` and `seg_counts` at the bench shapes (B=256, C=2048,
    I=1000, G=4, K=64, D=32), each row with the 16K x 64 shapes' row
    (B=64, C=16384, D=64) under "16k". The `seg_counts` row is its flags
    form, which the step launches, with the counts form (the decode of
    `seg_counts_packed`, for callers that read the counts) under
    "counts_form"."""
    I, G, K = (BENCH[k] for k in ("input_dim", "segments_per_column",
                                  "synapse_capacity"))
    out = {}
    for tag, B, C, D in (
            ("bench", BATCH, BENCH["column_dim"], BENCH["cell_dim"]),
            ("16k", BATCH_16K, GEOM_16K["column_dim"],
             GEOM_16K["cell_dim"])):
        rows = {"sp_overlap": overlap_row(B, C, I, dev, ("grid_y",)),
                "seg_counts": flags_row(B, C, G, K, D, dev)}
        rows["seg_counts"]["counts_form"] = counts_row(B, C, G, K, dev)
        torch.cuda.empty_cache()
        for name, row in rows.items():
            if tag == "bench":
                out[name] = row
            else:
                out[name]["16k"] = row
    return out


# `grow_select`, `row_counts` and `learn_rows` at the main paths'
# geometries (tag: B, C, D, A, G, K, Wc, L, samp; the bench, the 16K tuned
# and auto caps, the reference and the anomaly stacks) and past them (samp
# = K, K = 125 and 128, Wc = 2049, one key row a block, keys in global
# memory in both forms, kk past 32)
GROW_MAIN = {
    "bench": (BATCH, 2048, 32, 41, 4, 64, 128, 88, 32),
    "16k tuned": (BATCH_16K, 16384, 64, 328, 4, 64, 384, 336, 32),
    "16k auto": (BATCH_16K, 16384, 64, 328, 4, 64, 768, 824, 32),
    "reference stack": (BATCH, 2048, 32, 41, 8, 48, 128, 88, 32),
    "anomaly stack": (BATCH, 512, 8, 16, 8, 48, 128, 64, 32),
}
GROW_PATHS = {
    "samp=K": (64, 2048, 32, 41, 2, 32, 128, 88, 32),
    # K = 125: u8 activity off 16-byte vectors (`learn_rows` "scalar")
    "K=125": (64, 2048, 32, 41, 2, 125, 128, 88, 32),
    "K=128": (64, 2048, 32, 41, 2, 128, 128, 88, 32),
    "Wc=2049": (16, 4096, 32, 128, 2, 64, 2049, 128, 32),
    "one key row a block": (2, 4096, 32, 1024, 1, 16, 20_000, 16, 32),
    "global, cell": (2, 2048, 32, 2048, 1, 16, 29_057, 8, 32),
    "global, index": (2, 4096, 32, 1024, 1, 16, 29_057, 8, 32),
    # kk = 40: `learn_rows` reads each written slot's cell ("load")
    "samp=40": (16, 2048, 32, 41, 4, 48, 700, 40, 40),
}
# `pack_bits` at the main paths' (B, rows, D): the matching flags (B, C,
# G) of a `distal_forward` step; then the cells (B, A, D) that the steps
# packed before `column_decide` wrote their words, and D = 1, 33, 48
PACK_MAIN = {
    "bench": (BATCH, 2048, 4), "16k": (BATCH_16K, 16384, 4),
    "reference stack": (BATCH, 2048, 8), "anomaly stack": (BATCH, 512, 8),
}
PACK_PATHS = {"bench cells": (BATCH, 41, 32),
              "16k cells": (BATCH_16K, 328, 64),
              "anomaly cells": (BATCH, 16, 8), "D=1": (64, 1000, 1),
              "D=33": (64, 1000, 33), "D=48": (64, 1000, 48)}


def grow_row(geo: tuple, dev, graph: bool = True) -> tuple[dict, ...]:
    """`grow_select` at ``geo`` on a learning step's tables
    (`testing.learn_inputs`: the rows read where they lie, before the
    learning pass, new segments empty) against `grow_select_ref` (every
    output equal, chosen up to n_chosen), then `row_counts` on the same
    tables (`counts_rows_row`) and `learn_rows` on that selection
    (`learn_row`), with `kernel_row`'s times and bound for `grow_select`:
    each stream's winner words, columns and flags, the random words of
    the rows that grow (their valid candidates only), the K slots (syn
    and activity) of every valid row and the outputs, each once. Its
    library call is `torch.topk(largest=False)` over the same masked
    keys. With ``graph``, the kernel's and the library's ms a call in a
    CUDA graph of 20. Returns (the `grow_select` row, the `row_counts`
    row, the `learn_rows` row)."""
    B, C, D, A, G, K, Wc, L, samp = geo
    x = testing.learn_inputs(sum(geo), *geo, device=dev)
    s = x["select"]
    want = ptm.grow_select_ref(**s)
    got = ptm.GrowSelection(*kernels.grow_select_cuda(**s))
    torch.cuda.synchronize()
    at = f"B={B} C={C} D={D} A={A} G={G} K={K} Wc={Wc} L={L} samp={samp}"
    require(testing.same_choice(got, want) and bool((want[1] > 0).any()),
            f"grow_select == plain at {at}")
    path = kernels._grow_keys(s["cell_form"], Wc)
    require(kernels.GROW_SELECT.path == path, f"grow_select at {at} takes "
            f"{path}, got {kernels.GROW_SELECT.path}")
    keys, n_grow, n_cand = grow_keys(s, want)
    kk = min(samp, Wc)
    slot = 4 + s["act_rows"].element_size()
    moved = (4 * int(((n_grow > 0) * n_cand[:, None]).sum())
             + slot * K * int(want.lvalid.sum())
             + nbytes(s["prev_winner_bits"], s["prev_cols"], s["learn_rows"],
                      s["new_seg"], s["row_cols"])
             + nbytes(*want))

    def library():
        return torch.topk(keys, kk, dim=-1, largest=False)

    row = kernel_row(f"grow_select [{'+'.join(path)}]",
                     lambda: kernels.grow_select_cuda(**s),
                     lambda: ptm.grow_select_ref(**s), moved, at,
                     library=library, path=list(path),
                     growing_rows=int((n_grow > 0).sum()))
    if graph:
        row["graph_ms"] = graph_ms(lambda: kernels.grow_select_cuda(**s))
        row["library_graph_ms"] = graph_ms(library)
        print(f"  grow_select in a CUDA graph of 20 calls: "
              f"{row['graph_ms']:.4f} ms a call, torch.topk "
              f"{row['library_graph_ms']:.4f}")
    del keys
    return (row, counts_rows_row(x, G, at, graph),
            learn_row(x, want, at, graph))


def grow_keys(s: dict, sel) -> tuple:
    """The masked growth keys of `grow_select`'s arguments ``s`` (on the
    tables, before the learning pass) at the lists of its selection
    ``sel`` (the form's sentinel where invalid), each row's n_grow and
    each stream's candidate count."""
    Wc = s["rnd"].shape[-1]
    R = s["learn_rows"].shape[1]
    fresh = s["new_seg"][..., None]
    syn = torch.where(fresh, -1, ptm._active_rows(s["syn_rows"],
                                                  s["row_cols"], R))
    act = (ptm._active_rows(s["act_rows"], s["row_cols"], R) != 0) & ~fresh
    n_cand = torch.clamp(popcount32(s["prev_winner_bits"]).sum(
        (1, 2), dtype=torch.int32), max=Wc)
    cand_valid = torch.arange(Wc, device=n_cand.device) < n_cand[:, None]
    pkey, valid, n_grow = ptm.growth_keys_ref(
        syn, act, sel.lidx, sel.lvalid, sel.cand_cell, cand_valid, n_cand,
        s["rnd"], s["samp"], s["key_bits"], s["cell_form"], raw=True)
    keys = torch.where(valid, pkey, (1 << 32) - 1 if s["cell_form"]
                       else ptm.PACKED_IDX_SENTINEL)
    return keys, n_grow, n_cand.to(torch.int64)


def counts_rows_row(x: dict, G: int, at: str, graph: bool) -> dict:
    """`row_counts` on the tables of ``x`` at its active columns against
    `row_counts_ref`, the three counts equal, with `kernel_row`'s times
    and bound: the active rows' slots (syn, perm and activity) and the
    columns read once, the three (B, A, G) counts written once; no
    PyTorch call computes them: no library time."""
    s = x["select"]
    args = (s["syn_rows"], x["perm"], s["act_rows"], x["cols"], G)
    want = ptm.row_counts_ref(*args)
    got = kernels.row_counts_cuda(*args)
    torch.cuda.synchronize()
    require(all(torch.equal(a, b) for a, b in zip(got, want))
            and bool((want[2] > 0).any()) and bool((want[0] > 0).any()),
            f"row_counts == plain at {at}")
    act = kernels._act_name(s["syn_rows"].shape[-1] // G)
    require(kernels.ROW_COUNTS.path == (act, "table"),
            f"row_counts at {at} takes ({act}, table), got "
            f"{kernels.ROW_COUNTS.path}")
    slot = 8 + s["act_rows"].element_size()
    row = kernel_row(f"row_counts [{act}+table]",
                     lambda: kernels.row_counts_cuda(*args),
                     lambda: ptm.row_counts_ref(*args),
                     slot * want[0].numel() * (s["syn_rows"].shape[-1] // G)
                     + nbytes(x["cols"], *want), at, path=[act, "table"])
    if graph:
        row["graph_ms"] = graph_ms(lambda: kernels.row_counts_cuda(*args))
        print(f"  row_counts in a CUDA graph of 20 calls: "
              f"{row['graph_ms']:.4f} ms a call")
    return row


def fresh_ms(calls, restore, graph: bool = False, reps: int = 5) -> float:
    """ms a call of an in-place function, each of ``calls`` on its own
    copy of the inputs, which ``restore()`` resets: CUDA events around
    each call (its launch included), or with ``graph`` around replays of
    a CUDA graph of the calls; the resets run outside the events."""
    restore()
    for call in calls[:3]:
        call()
    restore()
    torch.cuda.synchronize()
    if not graph:
        ev = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in calls]
        for (start, end), call in zip(ev, calls):
            start.record()
            call()
            end.record()
        torch.cuda.synchronize()
        return sum(s.elapsed_time(e) for s, e in ev) / len(calls)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for call in calls:
            call()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    total = 0.0
    for _ in range(reps):
        restore()
        torch.cuda.synchronize()
        start.record()
        g.replay()
        end.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(end)
    del g
    return total / (len(calls) * reps)


def disjoint_cols(B: int, C: int, A: int, n: int, dev, seed: int) -> list:
    """n sets of A sorted columns a stream, no column in two sets."""
    g = torch.Generator(device=dev).manual_seed(seed)
    order = torch.argsort(torch.rand((B, C), generator=g, device=dev),
                          dim=1)[:, :n * A].reshape(B, n, A)
    return [c.sort(-1).values.to(torch.int32).contiguous()
            for c in order.unbind(1)]


def learn_row(x: dict, sel, at: str, graph: bool) -> dict:
    """`learn_rows` on the selection ``sel`` of ``x`` (the index-form
    keys decoded first, as `_learn` does) against `learn_rows_ref` on
    fresh copies of the tables, at the active columns and on gathered
    rows, with and without the mask: the synapse and permanence tables
    (bit for bit), the mask and the counts equal, and cells written.
    Timed on up to 20 calls (`fresh_ms`), each on its own copy of the
    active rows, put at its own columns of one copy of the tables (the
    rows are restored between runs), plain and, with ``graph``, in a
    CUDA graph of 20. Bound: the active rows' slots (syn, perm and
    activity) read once, the syn and perm slots that change written once,
    the columns, flags and list places of the rows, the list entries of
    the rows in the list and the cells written read once; no PyTorch call
    computes the pass: no library time."""
    s = x["select"]
    cells = sel.chosen
    if not s["cell_form"]:
        cells = pas.take_small_table_ref(sel.cand_cell, cells,
                                         (1 << s["key_bits"]) - 1)
    syn0, perm0, act0, cols = s["syn_rows"], x["perm"], s["act_rows"], \
        x["cols"]
    hyper = (x["increment"], x["decrement"], x["permanence_initial"])
    lists = (x["learn"], x["new_seg"], sel.lpos, cells, sel.n_chosen)
    for gathered in (False, True):
        for mask in (False, True):
            out = []
            for learn in (ptm.learn_rows_ref, kernels.learn_rows_cuda):
                syn, perm, act, c = (syn0.clone(), perm0.clone(), act0,
                                     sel.counts.clone())
                where = cols
                if gathered:
                    syn, perm, act = (ptm._rows(t, cols)
                                      for t in (syn, perm, act))
                    where = None
                w = learn(syn, perm, act, where, *lists, c, *hyper, mask)
                out.append((syn, perm.view(torch.int32), c)
                           + (() if w is None else (w,)))
            torch.cuda.synchronize()
            (s1, p1, c1, *w1), (s2, p2, c2, *w2) = out
            require(torch.equal(s1, s2) and torch.equal(p1, p2)
                    and torch.equal(c1, c2)
                    and all(torch.equal(a, b) for a, b in zip(w1, w2))
                    and int(c1[ptm.N_GROWN].sum()) > 0,
                    f"learn_rows == plain at {at}, "
                    f"{'gathered rows' if gathered else 'the columns'}"
                    f"{', mask' if mask else ''}")
            K = syn0.shape[-1] // (x["learn"].shape[1] // cols.shape[1])
            path = (kernels._act_name(K), "rows" if gathered else "table",
                    kernels._fill_path(cells.shape[-1]),
                    kernels._learn_loads(K))
            require(kernels.LEARN_ROWS.path == path, f"learn_rows at {at} "
                    f"takes {path}, got {kernels.LEARN_ROWS.path}")
    # the main path's call: at the columns, no mask
    path = list(kernels.LEARN_ROWS.path[:1]) + ["table"] + [
        kernels._fill_path(cells.shape[-1]), kernels.LEARN_ROWS.path[3]]
    syn1, perm1 = syn0.clone(), perm0.clone()
    c1 = sel.counts.clone()
    ptm.learn_rows_ref(syn1, perm1, act0, cols, *lists, c1, *hyper)
    B, C, J = syn0.shape
    A, R = cols.shape[1], x["learn"].shape[1]
    K = J // (R // A)
    in_list = sel.lpos >= 0
    moved = (B * R * K * (8 + act0.element_size())
             + 4 * int((syn1 != syn0).sum())
             + 4 * int((perm1.view(torch.int32)
                        != perm0.view(torch.int32)).sum())
             + nbytes(cols, x["learn"], x["new_seg"], sel.lpos)
             + 4 * int(in_list.sum())
             + 4 * int(c1[ptm.N_GROWN].sum()) + 8 * B)
    changed = int((syn1 != syn0).sum())
    del syn1, perm1
    n = max(1, min(20, C // A))
    sets = disjoint_cols(B, C, A, n, syn0.device, C + A)
    syn_w, perm_w, act_w = syn0.clone(), perm0.clone(), act0.clone()
    rows = [ptm._rows(t, cols) for t in (syn0, perm0, act0)]
    for where in sets:
        ptm._put_rows(act_w, where, rows[2])
    counts = [sel.counts.clone() for _ in sets]

    def restore():
        for where, c in zip(sets, counts):
            ptm._put_rows(syn_w, where, rows[0])
            ptm._put_rows(perm_w, where, rows[1])
            c.copy_(sel.counts)

    def calls(learn):
        return [lambda where=where, c=c: learn(syn_w, perm_w, act_w, where,
                                               *lists, c, *hyper)
                for where, c in zip(sets, counts)]

    row = {"ms": fresh_ms(calls(kernels.learn_rows_cuda), restore),
           "plain_ms": fresh_ms(calls(ptm.learn_rows_ref), restore),
           "max_abs_err": 0.0, "bound_ms": 1e3 * moved / HBM_BYTES_PER_S,
           "bound_by": "bytes", "library_ms": None, "at": at,
           "path": path, "calls": n, "slots_changed": changed}
    if graph:
        row["graph_ms"] = fresh_ms(calls(kernels.learn_rows_cuda), restore,
                                   graph=True)
    print(f"kernel learn_rows [{'+'.join(path)}]: {row['ms']:.4f} ms, "
          f"plain {row['plain_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
          f"({moved / 1e6:.1f} MB), library call none, at {at}"
          + (f"; in a CUDA graph of {n} calls {row['graph_ms']:.4f} ms a "
             f"call" if graph else "") + "; bit-equal at the columns and "
          f"on gathered rows, with and without the mask")
    del syn_w, perm_w, act_w, rows
    return row


def pack_row(shape: tuple, dev, graph: bool = True) -> dict:
    """`pack_bits` of a (B, rows, D) bool tensor (density 0.3) against
    `pack_bits_ref`, bit for bit, with `kernel_row`'s times and bound (the
    bools read once, the words written once) and, with ``graph``, its ms
    a call in a CUDA graph of 20. No PyTorch call packs bits into words
    (torch has no bit-pack operator and no uint32 sum): no library
    time."""
    g = torch.Generator(device=dev).manual_seed(sum(shape))
    mask = torch.rand(shape, generator=g, device=dev) < 0.3
    want = pas.pack_bits_ref(mask)
    got = kernels.pack_bits_cuda(mask)
    torch.cuda.synchronize()
    at = "B={} rows={} D={}".format(*shape)
    require(torch.equal(got, want), f"pack_bits == plain at {at}")
    path = (kernels._pack_path(shape[-1]),)
    require(kernels.PACK_BITS.path == path, f"pack_bits at {at} takes "
            f"{path}, got {kernels.PACK_BITS.path}")
    row = kernel_row(f"pack_bits [{path[0]}]",
                     lambda: kernels.pack_bits_cuda(mask),
                     lambda: pas.pack_bits_ref(mask), nbytes(mask, want),
                     at, path=list(path))
    if graph:
        row["graph_ms"] = graph_ms(lambda: kernels.pack_bits_cuda(mask))
        print(f"  pack_bits in a CUDA graph of 20 calls: "
              f"{row['graph_ms']:.4f} ms a call; no library call (torch "
              f"has no bit pack)")
    return row


def check_grow_and_pack(dev) -> tuple[dict, dict]:
    """`grow_select`, `row_counts`, `learn_rows` and `pack_bits` held
    bit-equal to their plain versions and timed (`grow_row`, `pack_row`)
    at the main paths' geometries, each also in a CUDA graph of 20 calls,
    and on every path the wrappers report. The geometries' caps are the
    configurations' own. Returns ({kernel: the bench row, the other main
    rows under their tags}, {kernel: {case: row}} of every row, for the
    paths)."""
    for tag, cfg in (("bench", bt.make_htm_config(**BENCH).tm),
                     ("16k tuned", bt.make_htm_config(**GEOM_16K,
                                                      **TUNED_16K).tm),
                     ("16k auto", bt.make_htm_config(**GEOM_16K).tm)):
        _, C, D, A, G, K, Wc, L, samp = GROW_MAIN[tag]
        require((C, D, A, G, K, Wc, L, samp) == (
            cfg.column_dim, cfg.cell_dim, cfg.active_columns,
            cfg.segments_per_column, cfg.synapse_capacity,
            cfg.resolved_winner_capacity, cfg.resolved_growth_capacity,
            cfg.segment_sampling_synapses), f"GROW_MAIN[{tag}] is the "
            f"configuration's geometry")
    names = ("grow_select", "row_counts", "learn_rows")
    rows = {name: {} for name in (*names, "pack_bits")}
    for geos, graph in ((GROW_MAIN, True), (GROW_PATHS, False)):
        for tag, geo in geos.items():
            for name, row in zip(names, grow_row(geo, dev, graph)):
                rows[name][tag] = row
            torch.cuda.empty_cache()
    for tag, shape in PACK_MAIN.items():
        rows["pack_bits"][tag] = pack_row(shape, dev)
    for tag, shape in PACK_PATHS.items():
        rows["pack_bits"][tag] = pack_row(shape, dev, graph=False)
    torch.cuda.empty_cache()
    main = {}
    for name, by_tag in rows.items():
        main[name] = dict(by_tag["bench"])
        main[name].update({tag: row for tag, row in by_tag.items()
                           if tag in (PACK_MAIN if name == "pack_bits"
                                      else GROW_MAIN) and tag != "bench"})
    return main, rows


# `column_decide`'s arguments as the learned states give them
# (`record_decisions`): (tag, mode, "table") -> the arguments of its last
# call there
DECIDE_CALLS: dict = {}
# the tags timed; the fuzz geometries' calls are held equal only
DECIDE_TIMED = ("bench", "16k", "reference B=1", "reference B=256",
                "anomaly stack")


def _clone(v):
    if isinstance(v, torch.Tensor):
        return v.clone()
    if isinstance(v, bt.Draws):
        return bt.Draws(*(t.clone() for t in v))
    return v


@contextlib.contextmanager
def recording(tag: str):
    """Inside it, each `column_decide` call of `tm_step` keeps a copy of
    its arguments in DECIDE_CALLS under (``tag``, its mode, "table"),
    then runs."""
    real = ptm.column_decide

    def record(*args):
        where = "rows" if args[3] is None else "table"
        DECIDE_CALLS[(tag, args[-1], where)] = tuple(map(_clone, args))
        return real(*args)

    ptm.column_decide = record
    try:
        yield
    finally:
        ptm.column_decide = real


def record_decisions(tag: str, cfg, state, x, step=None) -> None:
    """Three eager steps from copies of a learned ``state`` on the input
    rows ``x`` (B, I), recording their column decisions' arguments: a
    learning step, an inference step with winner cells and one without
    (a serving step's bursting-only decisions). ``step(cfg, state,
    learning, compute_winner)`` runs a step (default `htm_step` on
    ``x`` with draws of a seeded generator)."""
    def htm(cfg, st, learning, winners):
        gen = torch.Generator(device=x.device).manual_seed(x.shape[0])
        bt.htm_step(cfg, st, x, learning, winners, dense_outputs=False,
                    draws=bt.TorchDraws(cfg.tm, x.shape[0], x.device, gen))

    for learning, winners in ((True, True), (False, True), (False, False)):
        with bgraph.eager(), recording(tag):
            (step or htm)(cfg, copy.deepcopy(state), learning, winners)
    torch.cuda.synchronize()


def tile_state(state, n: int):
    """A B=1 HTMState repeated into n streams."""
    def tile(part):
        return type(part)(**{f.name: getattr(part, f.name).expand(
            n, *getattr(part, f.name).shape[1:]).contiguous()
            for f in dataclasses.fields(part)})

    return bt.HTMState(sp=tile(state.sp), tm=tile(state.tm))


def decide_bytes(args, dec) -> int:
    """`column_decide`'s bound in bytes: the prediction words at the
    columns and the columns, by mode the owners, counts and draws of the
    active rows and the steps, each read once; its outputs written once,
    and the owners that change."""
    cfg, pred, owners, cols, pot, conn, live, draws, step, mode = args
    B, A, W = dec.act_bits.shape
    moved = 4 * B * A * W + (0 if cols is None else nbytes(cols))
    if mode != "burst":
        moved += 4 * pot.numel() + nbytes(pot, draws.u_seg, draws.u_least)
    if mode == "learn":
        moved += nbytes(conn, live, step) + 4 * int(dec.counts[3].sum())
    return moved + nbytes(*(t for t in dec if t is not None))


def check_column_decide() -> tuple[dict, dict]:
    """`column_decide` against `column_decide_ref` on every call recorded
    (DECIDE_CALLS: the learned states' rows and draws at the bench, 16K,
    the reference stack at B=1 and B=256, the anomaly stack and the fuzz
    geometries, in each mode), at the columns and on the rows gathered
    there: every output and the new owners bit for bit, each side on its
    own copy of the owners, on the path its wrapper reports. At the
    DECIDE_TIMED tags, its time (CUDA events over 20 calls and in a CUDA
    graph of 20, on one copy of the owners, which the first call of a
    learning mode updates, so the later calls decide on the owners it
    left) beside the plain version's and its bound (`decide_bytes`); no
    PyTorch call computes the decisions: no library time. Returns ({the
    bench learning row, the other timed rows under their cases}, {case:
    row} of every check)."""
    for tag in DECIDE_TIMED:
        for mode in kernels.DECIDE_MODES:
            require((tag, mode, "table") in DECIDE_CALLS,
                    f"column_decide recorded at {tag}, {mode}")
    rows = {}
    for (tag, mode, _), table_args in sorted(DECIDE_CALLS.items()):
        for where, args in (("table", table_args),
                            ("rows", testing.gathered_decide_args(
                                table_args))):
            outs = []
            for decide in (ptm.column_decide_ref, ptm.column_decide):
                a = list(args)
                a[2] = _clone(args[2])
                outs.append((*decide(*a), a[2]))
            torch.cuda.synchronize()
            case = f"{tag}, {mode}" + (", rows" if where == "rows" else "")
            require(all((g is None) == (w is None) and (
                g is None or torch.equal(g, w))
                for g, w in zip(outs[1], outs[0])),
                f"column_decide == plain at {case}")
            B, A, _ = outs[0][0].shape
            grid = "split" if kernels.decide_split(B, A) > 1 else "stream"
            require(kernels.COLUMN_DECIDE.path == (mode, where, grid),
                    f"column_decide at {case} takes ({mode}, {where}, "
                    f"{grid}), got {kernels.COLUMN_DECIDE.path}")
            if tag not in DECIDE_TIMED or where == "rows":
                rows[case] = {"path": [mode, where, grid]}
                continue
            dec = ptm.ColumnDecisions(*outs[0][:6])
            B, A, _ = dec.act_bits.shape
            cfg = args[0]
            at = (f"{tag}: B={B} A={A} G={cfg.segments_per_column} "
                  f"D={cfg.cell_dim}, {mode}")
            a_k, a_p = list(args), list(args)
            a_k[2], a_p[2] = _clone(args[2]), _clone(args[2])
            row = kernel_row(f"column_decide [{mode}+{where}+{grid}]",
                             lambda: ptm.column_decide(*a_k),
                             lambda: ptm.column_decide_ref(*a_p),
                             decide_bytes(args, dec), at,
                             path=[mode, where, grid])
            row["graph_ms"] = graph_ms(lambda: ptm.column_decide(*a_k))
            print(f"  column_decide in a CUDA graph of 20 calls: "
                  f"{row['graph_ms']:.4f} ms a call; "
                  + ", ".join(f"{k} {int(v.sum())}" for k, v in zip(
                      ptm.DECIDE_COUNTS, dec.counts)))
            rows[case] = row
    print(f"column_decide == plain, bit for bit, at {len(rows)} cases: "
          + "; ".join(rows))
    main = dict(rows["bench, learn"])
    main.update({case: row for case, row in rows.items()
                 if "ms" in row and case != "bench, learn"})
    return main, rows


def sp_inputs(cfg, B: int, g: torch.Generator, dev):
    """An SP permanence table as `sp_init` draws it (padding lanes at the
    rail), the Hebbian delta of a density-0.2 input and A active columns
    per stream."""
    C, I = cfg.column_dim, cfg.input_dim
    I_pad = padded_input_dim(I)
    perm = torch.randn((B, C, I_pad), generator=g, device=dev) \
        * cfg.permanence_std + cfg.permanence_mean
    if cfg.quantized:
        perm = torch.round(perm / cfg.permanence_quantum).to(torch.int16)
        perm[..., I:] = -32000
    else:
        perm[..., I:] = -1e9
    x = torch.rand((B, I), generator=g, device=dev) < 0.2
    delta, thr = psp.hebbian_delta(cfg, x, I_pad)
    cols = torch.rand((B, C), generator=g, device=dev).topk(
        cfg.active_columns, -1).indices.to(torch.int32)
    return perm, delta, cols, thr


def with_edges(perm: torch.Tensor) -> torch.Tensor:
    """A copy of an SP permanence table whose every row holds values that
    change without learning: int16 lanes 0-7 at 32767 and 8-15 at -32768
    (past the +-32000 rail, so the clip moves them), float32 lanes 0-15
    at -0.0 (p + 0 * d is +0.0 where d >= 0, stays -0.0 where d < 0)."""
    edge = perm.clone()
    if edge.dtype == torch.int16:
        edge[..., :8], edge[..., 8:16] = 32767, -32768
    else:
        edge[..., :16] = -0.0
    return edge


def inactive_rows_changed(before, after, cols) -> int:
    """How many rows outside the (B, A) active columns changed a bit."""
    changed = (before.view(torch.uint8) != after.view(torch.uint8)).reshape(
        *before.shape[:2], -1).any(-1)
    return int((changed & ~pas.column_mask_from_cols(
        cols, before.shape[1])).sum())


def check_sp_update_pack(dev) -> dict:
    """`sp_update_pack` against its plain version at the bench SP shapes
    (B=256, C=2048, I_pad=1024), int16 (the bench's dtype, the row
    returned) and float32 (printed), on the `sp_init`-like table (timed)
    and on one whose inactive rows change too (`with_edges`: past the
    rail, -0.0). Its bound counts the permanences read once, the active
    rows written and the connected table written (every row
    re-packed)."""
    cfg16 = bt.make_htm_config(**BENCH).sp
    rows = {}
    for cfg in (cfg16, dataclasses.replace(cfg16,
                                           permanence_dtype="float32")):
        g = torch.Generator(device=dev).manual_seed(5)
        perm, delta, cols, thr = sp_inputs(cfg, BATCH, g, dev)
        p_ref, p_k = perm.clone(), perm.clone()
        _, pack_ref = psp.sp_update_pack_ref(p_ref, delta, cols, thr)
        _, pack_k = kernels.sp_update_pack_cuda(p_k, delta, cols, thr)
        torch.cuda.synchronize()
        require(torch.equal(p_k.view(torch.uint8), p_ref.view(torch.uint8))
                and torch.equal(pack_k, pack_ref),
                f"sp_update_pack {perm.dtype} == plain, bit for bit")
        require(bool(pack_ref.any()) and not bool(torch.equal(p_ref, perm)),
                "the SP inputs connect and learn")
        unmoved = inactive_rows_changed(perm, p_ref, cols) == 0
        B, C, I_pad = perm.shape
        written = B * cfg.active_columns * I_pad * perm.element_size()
        p = perm.clone()
        rows[perm.dtype] = kernel_row(
            f"sp_update_pack {str(perm.dtype).split('.')[1]}",
            lambda: kernels.sp_update_pack_cuda(p, delta, cols, thr),
            lambda: psp.sp_update_pack_ref(p, delta, cols, thr),
            nbytes(perm, delta, cols, pack_ref) + written,
            f"B={B} C={C} I_pad={I_pad} A={cfg.active_columns} "
            f"{str(perm.dtype).split('.')[1]}")
        del p, p_ref, p_k, pack_ref, pack_k
        # as many tables live as above, so that the check adds no peak
        edge = with_edges(perm)
        e_ref, e_k = edge.clone(), edge.clone()
        _, epack_ref = psp.sp_update_pack_ref(e_ref, delta, cols, thr)
        _, epack_k = kernels.sp_update_pack_cuda(e_k, delta, cols, thr)
        torch.cuda.synchronize()
        require(torch.equal(e_k.view(torch.uint8), e_ref.view(torch.uint8))
                and torch.equal(epack_k, epack_ref),
                f"sp_update_pack {perm.dtype} == plain, bit for bit, with "
                f"inactive rows that change")
        moved = inactive_rows_changed(edge, e_ref, cols)
        require(moved > 0 and unmoved,
                "with_edges changes inactive rows, the plain table none")
        print(f"sp_update_pack {perm.dtype}: bit-equal with {moved} inactive "
              f"rows changed (past the rail or -0.0)")
        del perm, edge, e_ref, e_k, epack_ref, epack_k
    return rows[torch.int16]


# `sp_rows` at the SP of every learning path (tag: B, C, I, A, the
# permanence type): the bench, 16K x 64, the B=1 reference stack, the
# anomaly stack's two layers (352 and 512 x 8 = 4,096 inputs); then past
# them: 65,536 streams (grid x), rows of 40 tiles, and past the
# first-claim bitmaps' 65,536 columns
SP_ROWS_MAIN = {
    "bench": (BATCH, 2048, 1000, 41, "int16"),
    "16k": (BATCH_16K, 16384, 1000, 328, "int16"),
    "reference B=1": (1, 2048, 1000, 41, "float32"),
    "anomaly": (BATCH, 512, 352, 16, "float32"),
    "stack layer 2": (BATCH, 512, 4096, 16, "float32"),
}
SP_ROWS_PATHS = {
    "B=65536": (65_536, 2, 1000, 1, "int16"),
    "two tiles int16": (2, 64, 40_000, 5, "int16"),
    "two tiles float32": (2, 64, 40_000, 5, "float32"),
    "scan claims": (1, 65_537, 1000, 41, "int16"),
}


def sp_rows_grid(B: int, I_pad: int, A: int) -> str:
    """The grid `sp_rows` launches (`kernels.sp_rows_runs`, csrc/
    sp_pass.cu `RowGrid`): a block of 256 threads a run of one stream's
    units (128 packed bytes of a row)."""
    tiles, per, runs = kernels.sp_rows_runs(B, I_pad, A)
    return (f"{runs}x{B}" if B <= kernels.MAX_GRID_Y else f"{runs * B}") \
        + f" blocks of 256, {per} units a block, {tiles} a row"


def sp_rows_row(tag: str, geo: tuple, dev) -> dict:
    """`sp_rows` at ``geo`` against `sp_rows_ref`, each on its own copy:
    on an `sp_init`-like table and its connected words, on one whose
    every row holds values that change without learning (`with_edges`,
    and the padding lanes too), and with a column listed twice. Both
    tables bit-equal, rows outside the active columns unchanged, the
    path the shapes choose. Timed on up to 20 calls (`fresh_ms`), each on
    its own disjoint set of columns, so that no call finds its rows in
    the L2 cache (their work does not depend on the values: no restore),
    plain and in a CUDA graph of 20. Bound: the active
    rows read and written once, their packed rows written, the inputs
    and columns read; no PyTorch call updates, clips and packs rows: no
    library time."""
    B, C, I, A, dtype = geo
    cfg = bt.make_htm_config(I, C, 4, active_columns=A, sp_overrides={
        "permanence_dtype": dtype}).sp
    g = torch.Generator(device=dev).manual_seed(B + C + I)
    perm, _, cols, thr = sp_inputs(cfg, B, g, dev)
    conn = pack_input(perm >= thr)
    x = torch.rand((B, I), generator=g, device=dev) < 0.2
    steps_ = psp.hebbian_steps(cfg)
    at = f"B={B} C={C} I={I} I_pad={perm.shape[-1]} A={A} {dtype}, {tag}"
    dup = cols.clone()
    if A > 2:
        dup[:, -1] = dup[:, 1]
    edge = with_edges(perm)
    edge[..., I:] = -0.0 if dtype == "float32" else 32767
    for table, where, what in ((perm, cols, "sp_init-like"),
                               (edge, cols, "with_edges"),
                               (edge, dup, "a column listed twice")):
        want = psp.sp_rows_ref(cfg, table.clone(), conn.clone(), x, where)
        got = kernels.sp_rows_cuda(table.clone(), conn.clone(), x, where,
                                   *steps_)
        torch.cuda.synchronize()
        inactive = ~pas.column_mask_from_cols(where, C)
        require(same_bits(got[0], want[0]) and same_bits(got[1], want[1]),
                f"sp_rows == plain at {at}, {what}, bit for bit")
        require(same_bits(want[0][inactive], table[inactive])
                and same_bits(want[1][inactive], conn[inactive])
                and not torch.equal(want[0], table),
                f"sp_rows at {at}, {what}: the active rows learn, the "
                f"others keep their bits")
        del want, got, inactive
    path = ("grid_x_streams" if B > kernels.MAX_GRID_Y else "grid_y",
            "scan" if C > kernels.SP_ROWS_BITMAP_COLUMNS else "bitmap")
    require(kernels.SP_ROWS.path == path, f"sp_rows at {at} takes {path}, "
            f"got {kernels.SP_ROWS.path}")
    del edge, dup
    I_pad = perm.shape[-1]
    moved = (B * A * (2 * I_pad * perm.element_size() + I_pad // 8)
             + nbytes(x, cols))
    n = max(1, min(20, C // A))
    sets = disjoint_cols(B, C, A, n, dev, C + A)

    def calls(fn):
        return [lambda where=where: fn(perm, conn, x, where)
                for where in sets]

    kernel = calls(lambda *a: kernels.sp_rows_cuda(*a, *steps_))
    plain = calls(lambda *a: psp.sp_rows_ref(cfg, *a))
    row = {"ms": fresh_ms(kernel, lambda: None),
           "plain_ms": fresh_ms(plain, lambda: None), "max_abs_err": 0.0,
           "bound_ms": 1e3 * moved / HBM_BYTES_PER_S, "bound_by": "bytes",
           "library_ms": None, "at": at, "path": list(path), "calls": n,
           "grid": sp_rows_grid(B, I_pad, A)}
    row["graph_ms"] = fresh_ms(kernel, lambda: None, graph=True)
    print(f"kernel sp_rows [{'+'.join(path)}]: {row['ms']:.4f} ms, plain "
          f"{row['plain_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
          f"({moved / 1e6:.1f} MB), library call none, at {at}, grid "
          f"{row['grid']}, {n} calls on disjoint columns; in a CUDA graph "
          f"of {n}: {row['graph_ms']:.4f} ms a call; bit-equal")
    return row


def check_sp_rows(dev) -> tuple[dict, dict]:
    """`sp_rows`, the SP's update of its active rows (`sp_rows_row`), at
    the SP of every learning path and on the paths past them, each also
    in a CUDA graph of 20 calls. Returns (the bench row, the other main
    rows under their tags; {case: row} of every row)."""
    bench = bt.make_htm_config(**BENCH).sp
    require(SP_ROWS_MAIN["bench"][1:4] == (
        bench.column_dim, bench.input_dim, bench.active_columns),
        "SP_ROWS_MAIN['bench'] is the configuration's SP")
    rows = {}
    for geos in (SP_ROWS_MAIN, SP_ROWS_PATHS):
        for tag, geo in geos.items():
            rows[tag] = sp_rows_row(tag, geo, dev)
            torch.cuda.empty_cache()
    main = dict(rows["bench"])
    main.update({tag: row for tag, row in rows.items()
                 if tag in SP_ROWS_MAIN and tag != "bench"})
    return main, rows


# `sp_select` at the SP of every path (tag: B, C, A, the inputs'
# kind of `testing.select_inputs`): the bench (and the reference stack at
# B=256), 16K x 64, the anomaly stack's two layers (512 columns, A=16)
# and the single-stream reference; past them: tie-heavy streams (the first
# step: every duty cycle 0, overlaps 0-3) at the bench and 16K, negative
# overlaps with -0.0, C off a multiple of 4, A = 1 and A = C, the keys in
# global memory (C past 16,384), a warp a stream (65,536 streams of 64
# columns; ties at 128 columns, in about half the streams more than 32
# equal keys at the A-th value), a block a stream past 64 winners at 512
# columns, a cluster of two blocks a stream off a multiple of 4 columns
# with ties, and the winners placed by the LSD sort (past 512 of them),
# its lists in shared memory and in global memory (A = 12,000, and A = C
# = 30,000: a cluster of eight blocks a stream)
SELECT_MAIN = {
    "bench": (BATCH, 2048, 41, "random"),
    "16k": (BATCH_16K, 16384, 328, "random"),
    "anomaly": (BATCH, 512, 16, "random"),
    "reference B=1": (1, 2048, 41, "random"),
}
SELECT_PATHS = {
    "bench ties": (BATCH, 2048, 41, "ties"),
    "16k ties": (BATCH_16K, 16384, 328, "ties"),
    "negative": (BATCH, 2048, 41, "negative"),
    "C=37": (2, 37, 5, "random"),
    "C=250 A=1": (2, 250, 1, "random"),
    "C=250 A=C": (2, 250, 250, "ties"),
    "global keys": (4, 20_000, 400, "random"),
    "global list": (2, 30_000, 30_000, "random"),
    "B=65536": (65_536, 64, 5, "random"),
    "warp ties": (BATCH, 128, 10, "ties"),
    "C=512 A=65": (BATCH, 512, 65, "random"),
    "cluster C=9001 ties": (2, 9001, 180, "ties"),
    "lsd smem": (4, 4096, 1000, "random"),
    "lsd smem ties": (2, 9001, 2000, "ties"),
    "lsd global": (2, 30_000, 12_000, "random"),
}


def sp_select_row(tag: str, geo: tuple, dev) -> dict:
    """`sp_select` at ``geo`` through its dispatcher against
    `sp_select_ref` on the card, on the same inputs: the boosted values,
    the winners in order, the mask and the new duty cycles bit for bit,
    one launch, the path the shapes choose. Timed (CUDA events over 20
    calls, and in a CUDA graph of 20) beside the plain version, its bound
    (the overlaps and duty cycles read once, the four outputs written
    once) and `torch.topk(boosted, A)`, the nearest PyTorch call (a top-A
    with no tie order, no boost and no EMA), also in a graph of 20."""
    B, C, A, kind = geo
    ov, duty = testing.select_inputs(B + C + A, B, C, kind, device=dev)
    args = (A, testing.SELECT_INTENSITY, A / C, testing.SELECT_MOMENTUM)
    before = kernels.SP_SELECT.launches
    got = preg.sp_select(ov, duty, *args)
    n = kernels.SP_SELECT.launches - before
    want = preg.sp_select_ref(ov, duty, *args)
    torch.cuda.synchronize()
    at = f"B={B} C={C} A={A} {kind}, {tag}"
    require(n == 1, f"sp_select at {at} launches its kernel once, got {n}")
    require(all(same_bits(g, w) for g, w in zip(got, want)),
            f"sp_select == plain at {at}, bit for bit")
    path = kernels._select_path(B, C, A)
    require(kernels.SP_SELECT.path == path, f"sp_select at {at} takes "
            f"{path}, got {kernels.SP_SELECT.path}")
    boosted = want[0]
    if kind == "negative":
        require(bool(((boosted == 0) & torch.signbit(boosted)).any()),
                f"-0.0 among the boosted values at {at}")
    if kind == "ties" and A < C:
        top = torch.sort(boosted, -1, descending=True).values
        require(bool((top[:, A - 1] == top[:, A]).all()),
                f"every stream's top-A boundary is a tie at {at}")
    del got, want
    moved = nbytes(ov, duty) + 2 * nbytes(boosted) + B * C + 4 * B * A
    row = kernel_row(f"sp_select [{'+'.join(path)}]",
                     lambda: preg.sp_select(ov, duty, *args),
                     lambda: preg.sp_select_ref(ov, duty, *args), moved, at,
                     library=lambda: torch.topk(boosted, A), path=list(path))
    row["graph_ms"] = graph_ms(lambda: preg.sp_select(ov, duty, *args))
    row["library_graph_ms"] = graph_ms(lambda: torch.topk(boosted, A))
    print(f"  sp_select in a CUDA graph of 20 calls: "
          f"{row['graph_ms']:.4f} ms a call; torch.topk "
          f"{row['library_graph_ms']:.4f}")
    return row


def check_sp_select(dev) -> tuple[dict, dict]:
    """`sp_select`, the SP's boost, top-A inhibition and duty-cycle EMA
    (`sp_select_row`), at the SP of every path and on the paths past
    them, each also in a CUDA graph of 20 calls beside `torch.topk` in
    one (the rows where the kernel is the slower printed). Returns (the
    bench row, the other main rows under their tags; {case: row} of every
    row)."""
    bench = bt.make_htm_config(**BENCH).sp
    require(SELECT_MAIN["bench"][1:3] == (bench.column_dim,
                                          bench.active_columns)
            and (bench.boosting_intensity, bench.duty_cycle_momentum) == (
                testing.SELECT_INTENSITY, testing.SELECT_MOMENTUM),
            "SELECT_MAIN['bench'] is the configuration's SP")
    rows = {}
    for geos in (SELECT_MAIN, SELECT_PATHS):
        for tag, geo in geos.items():
            rows[tag] = sp_select_row(tag, geo, dev)
            torch.cuda.empty_cache()
    slower = {tag: (round(row["graph_ms"], 4),
                    round(row["library_graph_ms"], 4))
              for tag, row in rows.items()
              if row["graph_ms"] > row["library_graph_ms"]}
    print(f"sp_select rows slower in a CUDA graph than torch.topk in one "
          f"(ms, ms): {json.dumps(slower)}")
    main = dict(rows["bench"])
    main.update({tag: row for tag, row in rows.items()
                 if tag in SELECT_MAIN and tag != "bench"})
    return main, rows


# the anomaly stages (`testing.LIKELIHOOD_CASES`, `testing.ZSCORE_CASES`):
# the benchmark's momentum and eps; the plain versions loop T steps of
# eager torch ops, so a case of STAGE_SLOW_T steps or more is timed in
# one call after one (the kernel always over 20, and in a graph of 20)
STAGE_MOMENTUM, STAGE_EPS = 0.7, 1e-6
STAGE_SLOW_T = 100
STAGE_UNIFORM = (400, BATCH, 300, 24)  # T, B, W, R of the uniform scores


def stage_ops(kind: str, state, T: int, B: int, W: int, more: int) -> int:
    """The float32 operations the reference's sums take over the slots
    that enter them in this run, from the state's count (likelihood) or
    position (z-score) and the steps: the likelihood 6 a slot of the
    estimate (the masked sum, the difference, its square, the masked sum
    again; ``more`` = R), the z-score 5 a live residual (the two masked
    sums and the square) and lags^2 compares for the median (``more`` =
    lags), and about 20 a stream-step around them."""
    t = np.arange(T)[:, None]
    at = (np.zeros(B, np.int64) if state is None
          else state[2].cpu().numpy().astype(np.int64))
    if kind == "likelihood":
        n = np.clip(np.minimum(at + t + 1, W) - max(more, 0), 0, None)
        return int(6 * n.sum() + 20 * T * B)
    n = np.clip(at + t, 0, W)
    return int(5 * n.sum() + (20 + more * more) * T * B)


def stage_row(kind: str, tag: str, case: tuple, dev) -> dict:
    """One anomaly stage kernel (`anomaly_likelihood` or `seasonal_zscore`)
    through its dispatcher against its plain version on the card, on the
    same inputs: one launch, the path from the shapes, the new state bit
    for bit, the state passed in unchanged, L within LIK_TOL or z within
    2e-6 + 1e-6|z|. Timed by CUDA events and in a CUDA graph of 20 calls
    beside the plain version; its bound the larger of its bytes (the
    series and state read once, the new state and outputs written once)
    over the memory rate and `stage_ops` over the float32 rate."""
    if kind == "likelihood":
        T, B, W, R, carried = case
        st, x = testing.likelihood_inputs(sum(map(int, case)), T, B, W, R,
                                          carried, dev)
        state = None if st is None else bt.AnomalyLikelihoodState(*st)
        start = state or bt.anomaly_likelihood_init(W, B, dev)
        kobj, floats, at = (kernels.ANOMALY_LIKELIHOOD, W,
                            f"T={T} B={B} W={W} R={R}")

        def kernel():
            return penc.anomaly_likelihood_steps(state, x, STAGE_MOMENTUM,
                                                 R, window=W)

        def plain():
            return penc.anomaly_likelihood_steps_ref(start, x,
                                                     STAGE_MOMENTUM, R)

        def within(got, want):
            return (got - want).abs() <= LIK_TOL
        ops = stage_ops(kind, st, T, B, W, R)
    else:
        T, B, P, W, lags, carried, f64 = case
        st, x = testing.zscore_inputs(sum(map(int, case)), T, B, P, W, lags,
                                      carried, f64, dev)
        state = None if st is None else bt.SeasonalZScoreState(*st)
        start = state or bt.seasonal_zscore_init(P, W, lags, B, dev)
        floats = lags * P + W
        kobj, at = (kernels.SEASONAL_ZSCORE,
                    f"T={T} B={B} P={P} W={W} lags={lags} "
                    f"{'f64' if f64 else 'f32'}")

        def kernel():
            return penc.seasonal_zscore_steps(state, x, P, STAGE_EPS, W,
                                              lags)

        def plain():
            return penc.seasonal_zscore_steps_ref(start, x, P, STAGE_EPS)

        def within(got, want):
            return (got - want).abs() <= z_tol(want)
        ops = stage_ops(kind, st, T, B, W, lags)
    at = f"{at}{' carried' if carried else ''}, {tag}"
    kept = None if st is None else [t.clone() for t in st]
    before = kobj.launches
    got_st, got = kernel()
    n = kobj.launches - before
    want_st, want = plain()
    torch.cuda.synchronize()
    require(n == 1, f"{kobj.name} at {at} launches its kernel once, got {n}")
    path = (kernels._ring(floats), kernels._series_name(x))
    require(kobj.path == path, f"{kobj.name} at {at} takes {path}, got "
            f"{kobj.path}")
    require(all(same_bits(g, w) for g, w in zip(got_st, want_st)),
            f"{kobj.name} state == plain at {at}, bit for bit")
    require(kept is None or all(same_bits(a, b) for a, b in zip(st, kept)),
            f"{kobj.name} leaves the state passed in unchanged at {at}")
    ok = within(got, want)
    err = float((got - want).abs().max()) if got.numel() else 0.0
    require(bool(ok.all()), f"{kobj.name} within tolerance of plain at "
            f"{at}: max |d| {err}")
    moved = nbytes(x, *([] if st is None else st), *want_st, want)
    bound = (1e3 * moved / HBM_BYTES_PER_S, 1e3 * ops / F32_OPS_PER_S)
    row = {"ms": cuda_ms(kernel), "graph_ms": graph_ms(kernel),
           "plain_ms": (cuda_ms(plain, 1, 1) if T >= STAGE_SLOW_T
                        else cuda_ms(plain)),
           "max_abs_err": err, "bound_ms": max(bound),
           "bound_by": "bytes" if bound[0] >= bound[1] else "operations",
           "library_ms": None, "at": at, "path": list(path)}
    print(f"kernel {kobj.name} [{'+'.join(path)}]: {row['ms']:.4f} ms, in "
          f"a CUDA graph of 20 {row['graph_ms']:.4f} ms, plain "
          f"{row['plain_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
          f"({row['bound_by']}: {moved / 1e6:.2f} MB, {ops / 1e6:.1f} M "
          f"float32 operations), library call none, at {at}; state "
          f"bit-equal, max |d| {err!r}")
    return row


def stage_calls_launch_one_kernel(dev) -> None:
    """Each public call of the stages on card tensors, under
    `torch.profiler`, issues one device kernel, its stage's, and no torch
    op, and adds one to that kernel's launch count:
    `anomaly_likelihood_update` and `seasonal_zscore_update` (a (B,)
    float32 tensor), `likelihood_series` and `seasonal_zscore` (a float64
    series, as the benchmark passes it). A profile that recorded no
    device work at all is a session the profiler lost (the counts show
    the launch) and is taken again, up to PROFILE_ATTEMPTS sessions, as
    `device_profile` does."""
    from bithtm_tpu_torch.examples import likelihood_series

    T, B, W, R, _ = testing.LIKELIHOOD_CASES["bench"]
    _, scores = testing.likelihood_inputs(1, T, B, W, R, False, dev)
    _, values = testing.zscore_inputs(2, *testing.ZSCORE_CASES["bench"][:5],
                                      False, True, dev)
    lst = bt.anomaly_likelihood_init(W, B, dev)
    zst = bt.seasonal_zscore_init(24, 96, 3, B, dev)
    row = values[0].float()
    lik_k, z_k = kernels.ANOMALY_LIKELIHOOD, kernels.SEASONAL_ZSCORE
    calls = {
        "anomaly_likelihood_update": ("likelihood_kernel", lik_k, lambda:
                                      bt.anomaly_likelihood_update(
                                          lst, scores[0], STAGE_MOMENTUM,
                                          R)),
        "likelihood_series": ("likelihood_kernel", lik_k,
                              lambda: likelihood_series(
                                  scores, W, STAGE_MOMENTUM, R)),
        "seasonal_zscore_update": ("zscore_kernel", z_k, lambda:
                                   bt.seasonal_zscore_update(zst, row, 24)),
        "seasonal_zscore": ("zscore_kernel", z_k, lambda: bt.seasonal_zscore(
            values, 24, window=96)),
    }
    seen = {}
    for name, (kernel, kobj, fn) in calls.items():
        fn()
        torch.cuda.synchronize()
        for attempt in range(1, PROFILE_ATTEMPTS + 1):
            counts = kernels.launch_counts()
            with warm_profile(dev) as prof:
                fn()
            after = kernels.launch_counts()
            moved = {k: after[k] - counts[k] for k in after
                     if after[k] != counts[k]}
            require(moved == {kobj.name: 1},
                    f"{name} on the card launches its stage's kernel once "
                    f"and no other of the port's: {moved}")
            ran = [e.name for e in device_events(prof)
                   if not e.name.startswith(("Memcpy", "Memset"))]
            if ran:
                break
            print(f"  {name}, profile {attempt}: the profiler recorded no "
                  f"device work; profiling again")
        seen[name] = ran
        require(len(ran) == 1 and kernel in ran[0],
                f"{name} on the card runs one kernel, its stage's: {ran}")
    print("anomaly stages, device kernels a call: " + json.dumps(
        {k: [n[:60] for n in v] for k, v in seen.items()}))


def check_anomaly_stages(dev) -> tuple[dict, dict, dict]:
    """The anomaly stages' kernels against their plain versions on the
    card (`stage_row`) at every case of `testing.LIKELIHOOD_CASES` and
    `testing.ZSCORE_CASES`: the anomaly benchmark's shapes (T = 1,440, B =
    256), one step from a carried mid-ring state, a window off a multiple
    of 32 and exclude 0, count saturating and t crossing L and L + W, one
    stream, 65,537 streams, 5 lags and rings in global memory; each public
    call one kernel (`stage_calls_launch_one_kernel`); and, not held to a
    tolerance, the likelihood on uniform scores (not the k/16 an HTM
    step gives), where float32 sums in any two orders move L by up to
    about the tolerance: the kernel against the plain version on the card,
    and the plain version on the card against the CPU's. Returns (the
    likelihood's bench row, the z-score's; {kernel: {case: row}})."""
    print(f"anomaly stages on {gpu_line(dev)}: each kernel against its "
          f"plain version on the card")
    rows = {"anomaly_likelihood": {}, "seasonal_zscore": {}}
    for tag, case in testing.LIKELIHOOD_CASES.items():
        rows["anomaly_likelihood"][tag] = stage_row("likelihood", tag, case,
                                                    dev)
        torch.cuda.empty_cache()
    for tag, case in testing.ZSCORE_CASES.items():
        rows["seasonal_zscore"][tag] = stage_row("zscore", tag, case, dev)
        torch.cuda.empty_cache()
    stage_calls_launch_one_kernel(dev)
    T, B, W, R = STAGE_UNIFORM
    rng = np.random.RandomState(11)
    u = torch.from_numpy(rng.uniform(0, 0.25, (T, B)).astype(np.float32))
    u[rng.rand(T, B) < 0.02] = 1.0
    got = penc.anomaly_likelihood_steps(None, u.to(dev), STAGE_MOMENTUM, R,
                                        window=W)[1].cpu()
    card = penc.anomaly_likelihood_steps_ref(
        bt.anomaly_likelihood_init(W, B, dev), u.to(dev), STAGE_MOMENTUM,
        R)[1].cpu()
    host = penc.anomaly_likelihood_steps_ref(
        bt.anomaly_likelihood_init(W, B, "cpu"), u, STAGE_MOMENTUM, R)[1]
    print(f"likelihood on uniform scores (T={T} B={B} W={W} R={R}; not held "
          f"to LIK_TOL {LIK_TOL}): kernel - plain on the card max |dL| "
          f"{float((got - card).abs().max())!r}, kernel - CPU "
          f"{float((got - host).abs().max())!r}, plain on the card - CPU "
          f"{float((card - host).abs().max())!r}")
    return (dict(rows["anomaly_likelihood"]["bench"]),
            dict(rows["seasonal_zscore"]["bench"]), rows)


# `serving_counts` past the learned tables of the main paths (tag: B, C,
# D, A, G, M, E, `testing.serving_inputs` keywords): one segment a column,
# eight and 32 (each byte-field tally), two prediction words a column (D =
# 64) with two main rows, no extension rows, extension rows in column
# order, lanes nearly all empty with an empty stream, the global bitmap
# and 65,537 streams
SERVING_PATHS = {
    "G=1": (64, 2048, 32, 41, 1, 1, 8, {}),
    "G=8": (64, 2048, 32, 41, 8, 1, 8, {}),
    "G=32 M=3": (16, 1024, 32, 41, 32, 3, 8, {}),
    "W=2 M=2": (16, 4096, 64, 82, 4, 2, 16, {}),
    "E=0": (64, 2048, 32, 41, 4, 1, 0, {}),
    "ordered": (64, 2048, 32, 41, 4, 1, 64, {"ordered": True}),
    "empty": (16, 2048, 32, 41, 4, 1, 8, {"empty": 0.97,
                                          "empty_stream": True}),
    "global bitmap": (4, 32_768, 64, 656, 4, 1, 8, {}),
    "B=65537": (65_537, 4, 32, 2, 4, 1, 8, {}),
}


def serving_counts_row(x: dict, C: int, D: int, th: tuple, at: str,
                       graph: bool = True) -> dict:
    """`serving_counts` over the compact table ``x`` (rows, ext_col, cols,
    bits, seg_cell) through its dispatchers against the plain versions on
    the card: the flags form's matching and prediction words at the
    thresholds ``th`` and the counts form's counts, bit for bit, one
    launch each, the path the shapes choose. Timed (CUDA events over 20
    calls, and with ``graph`` in a CUDA graph of 20) beside the plain
    version and its bound (the words, ext_col, the active set and, in
    the flags form, the owners read once; the outputs written once);
    the counts form's row under "counts_form". No PyTorch call computes
    either: no library time."""
    tab = psv.ServingTable(x["rows"], x["ext_col"])
    G = x["seg_cell"].shape[-1]
    flags = (tab, x["cols"], x["bits"], x["seg_cell"], C, D, *th)
    counts = (tab, x["cols"], x["bits"], C, D, G)
    n0 = kernels.SERVING_COUNTS.launches
    got_f = psv.serving_flags(*flags)
    path_f = kernels.SERVING_COUNTS.path
    got_c = psv.serving_counts(*counts)
    path_c = kernels.SERVING_COUNTS.path
    n = kernels.SERVING_COUNTS.launches - n0
    want_f = psv.serving_flags_ref(*flags)
    want_c = psv.serving_counts_ref(*counts)
    torch.cuda.synchronize()
    require(n == 2, f"serving_counts at {at} launches its kernel once a "
            f"form, got {n}")
    require(same_bits(got_f[0], want_f[0]) and same_bits(got_f[1], want_f[1])
            and same_bits(got_c, want_c),
            f"serving_counts == plain at {at}, both forms, bit for bit")
    path = (kernels._bitmap(C, D), "flags", kernels._segment_regs(G))
    require(path_f == path and path_c == (path[0], "counts", path[2]),
            f"serving_counts at {at} takes {path}, got {path_f}, {path_c}")
    require(bool((want_c > 0).any()), f"some counts at {at}")
    inputs = nbytes(x["rows"], x["ext_col"], x["cols"], x["bits"])
    blocks, threads, _ = kernels.serving_counts_grid(
        True, C, D, G, x["rows"].get_device())
    row = kernel_row(f"serving_counts [{'+'.join(path)}]",
                     lambda: psv.serving_flags(*flags),
                     lambda: psv.serving_flags_ref(*flags),
                     inputs + nbytes(x["seg_cell"], *want_f), at,
                     path=list(path), grid=f"{blocks}x{threads}")
    form = kernel_row(f"serving_counts [{path[0]}+counts+{path[2]}]",
                      lambda: psv.serving_counts(*counts),
                      lambda: psv.serving_counts_ref(*counts),
                      inputs + nbytes(want_c), at,
                      path=[path[0], "counts", path[2]])
    if graph:
        row["graph_ms"] = graph_ms(lambda: psv.serving_flags(*flags))
        form["graph_ms"] = graph_ms(lambda: psv.serving_counts(*counts))
        print(f"  serving_counts in a CUDA graph of 20 calls: flags form "
              f"{row['graph_ms']:.4f} ms a call, counts form "
              f"{form['graph_ms']:.4f}; no library call")
    row["counts_form"] = form
    return row


def learned_table_row(cfg, tm, tab, what: str) -> dict:
    """`serving_counts_row` on a learned state's own serving table
    ``tab``, its last active set, owners and thresholds, in a CUDA graph
    too. (The learned bench and 16K tables have no extension rows:
    SERVING_PATHS holds them, in and out of column order.)"""
    C, D = cfg.column_dim, cfg.cell_dim
    B, R, _ = tab.rows.shape
    E = tab.ext_col.shape[1]
    return serving_counts_row(
        dict(rows=tab.rows, ext_col=tab.ext_col, cols=tm.active_cols,
             bits=tm.active_bits, seg_cell=tm.seg_cell), C, D,
        (cfg.segment_matching_threshold, cfg.segment_activation_threshold),
        f"B={B} R={R} (M={(R - E) // C}, E={E}) D={D} "
        f"G={cfg.segments_per_column}, {what}")


def check_serving_counts(dev) -> dict:
    """`serving_counts` at SERVING_PATHS (`serving_counts_row`, timed with
    events only), thresholds at the counts' median and one below.
    Returns {case: row}; the learned tables' rows come from `run_serving`
    and `run_16k`."""
    rows = {}
    for tag, (B, C, D, A, G, M, E, kw) in SERVING_PATHS.items():
        x = testing.serving_inputs(B + C + G + M + E, B, C, D, A, G, M, E,
                                   device=dev, **kw)
        counts = psv.serving_counts_ref(psv.ServingTable(
            x["rows"], x["ext_col"]), x["cols"], x["bits"], C, D, G)
        theta_a = max(1, int(counts[counts > 0].float().median()))
        del counts
        rows[tag] = serving_counts_row(
            x, C, D, (theta_a - 1, theta_a),
            f"B={B} C={C} M={M} E={E} D={D} G={G} A={A}, {tag}",
            graph=False)
        del x
        torch.cuda.empty_cache()
    return rows


def growth_keys(Wc: int, shape, g: torch.Generator, dev):
    """Index-keyed growth keys over a list of Wc candidates, as `_grow`
    makes them above 2^16 cells: random bits above the list index, 15%
    of them the sentinel 0x7FFFFFFF, whose index bits decode to >= Wc
    where Wc is not a power of two. Returns (keys, the index mask)."""
    bits = max(1, (Wc - 1).bit_length())
    hi = torch.randint(0, 1 << (30 - bits), shape, generator=g, device=dev,
                       dtype=torch.int32)
    idx = torch.randint(0, Wc, shape, generator=g, device=dev,
                        dtype=torch.int32)
    keys = (hi << bits) | idx
    u = torch.rand(shape, generator=g, device=dev)
    return torch.where(u < 0.15, 0x7FFFFFFF, keys), (1 << bits) - 1


def check_small_table_take(dev) -> dict:
    """`small_table_take` against its plain version at the 16K shapes
    (B=64, kk=32) under the tuned caps (L=336, Wc=384: the row returned,
    the 16K path's own) and the auto caps (L=824, Wc=768), and, for
    bit-equality only, at Wc = 2049 and 4096. The table is a strided view
    (rows Wc + 1 words apart), as `_grow`'s candidate list is. Checked:
    growth keys decoded with their index mask, into a new tensor and in
    place of the keys (the call `_grow` makes), and unmasked indices with
    15% sentinel-decoded ones (>= Wc) and 10% negative ones. The timed
    call is the masked decode in place. The library call is
    `torch.gather` over the contiguous table at the decoded indices
    clamped into it and widened to int64 outside the timed call, without
    the mask or the zeroing of the out-of-range ones: less work than the
    kernel's, so its time is a lower bound on a library call's. The call
    site is timed old (the list made contiguous, `keys & mask`, then the
    take) against new (the masked take in place). The kernel is quicker
    on the device than the wrapper issues it, so each row also holds the
    wrapper's host issue a call (`host_issue_us`, stage by stage) and the
    kernel's own device time under torch.profiler, taken after every host
    timing: a profiler session slows the host timings that follow it."""
    B, kk = BATCH_16K, 32
    rows, calls = {}, {}
    for L, Wc in ((336, 384), (824, 768), (336, 2049), (336, 4096)):
        g = torch.Generator(device=dev).manual_seed(Wc)
        table = torch.randint(0, 1 << 20, (B, Wc + 1), generator=g,
                              device=dev, dtype=torch.int32)[:, :Wc]
        keys, low = growth_keys(Wc, (B, L, kk), g, dev)
        idx = torch.randint(0, Wc, (B, L, kk), generator=g, device=dev,
                            dtype=torch.int32)
        u = torch.rand((B, L, kk), generator=g, device=dev)
        idx = torch.where(u < 0.15, max(low, Wc),
                          torch.where(u < 0.25, -1, idx))
        want = pas.take_small_table_ref(table, keys, low)
        got = kernels.small_table_take_cuda(table, keys, low)
        decoded = keys.clone()
        got_p = kernels.small_table_take_cuda(table, decoded, low,
                                              in_place=True)
        want_i = pas.take_small_table_ref(table, idx)
        got_i = kernels.small_table_take_cuda(table, idx)
        torch.cuda.synchronize()
        require(torch.equal(got, want) and got_p is decoded
                and torch.equal(decoded, want)
                and torch.equal(want, pas.take_small_table_ref(
                    table.contiguous(), keys & low))
                and bool((want != 0).any())
                and (bool(((keys & low) >= Wc).any()) or low < Wc),
                f"small_table_take(keys, mask), new and in place, == plain "
                f"at L={L}, Wc={Wc}")
        require(torch.equal(got_i, want_i) and bool((idx >= Wc).any()),
                f"small_table_take(indices) == plain at L={L}, Wc={Wc}")
        print(f"small_table_take at L={L}, Wc={Wc}: masked growth keys (new "
              f"tensor and in place) and raw indices bit-equal to the plain "
              f"version")
        if Wc > 768:
            continue
        dense = table.contiguous()
        flat = (keys & low).clamp(0, Wc - 1).reshape(B, -1).long()
        buf = keys.clone()
        calls[Wc] = (lambda t=table, k=buf, m=low:
                     kernels.small_table_take_cuda(t, k, m, True))
        split = host_issue_us(table, keys, low, buf, flat)
        print(f"small_table_take host issue at L={L}, Wc={Wc} (us a call, "
              f"perf_counter over {HOST_CALLS} calls, no synchronize): "
              + ", ".join(f"{k} {v:.3f}" for k, v in split.items()))
        site = {"old": cuda_ms(lambda: kernels.small_table_take_cuda(
                    table.contiguous(), keys & low)),
                "new": cuda_ms(calls[Wc])}
        print(f"small_table_take call site at Wc={Wc} (CUDA events, ms a "
              f"call): contiguous list + keys & mask + take "
              f"{site['old']:.4f}, masked take in place {site['new']:.4f}")
        rows[Wc] = kernel_row(
            "small_table_take", calls[Wc],
            lambda: pas.take_small_table_ref(table, keys, low),
            nbytes(dense, keys, want), f"B={B} L={L} kk={kk} Wc={Wc}",
            library=lambda: torch.gather(dense, 1, flat),
            host_issue_us=split["wrapper, in place"],
            library_host_issue_us=split["library call"],
            call_site_old_ms=site["old"], call_site_new_ms=site["new"])
        rows[Wc]["_dense_flat"] = (dense, flat)
    for Wc, call in calls.items():
        # inside a CUDA graph no host issue separates the calls
        dense = rows[Wc].pop("_dense_flat")
        rows[Wc]["graph_ms"] = graph_ms(call)
        rows[Wc]["library_graph_ms"] = graph_ms(
            lambda d=dense: torch.gather(d[0], 1, d[1]))
        print(f"small_table_take at Wc={Wc} inside a CUDA graph of 20 calls: "
              f"{rows[Wc]['graph_ms']:.4f} ms a call, torch.gather "
              f"{rows[Wc]['library_graph_ms']:.4f}")
    for Wc, call in calls.items():
        rows[Wc]["device_ms"] = profiled_ms(call, "small_take_kernel")
        print(f"small_table_take at Wc={Wc}: {rows[Wc]['device_ms']:.4f} ms "
              f"on the device (torch.profiler), {rows[Wc]['ms']:.4f} ms a "
              f"call by events ({rows[Wc]['library_ms']:.4f} for "
              f"torch.gather), {rows[Wc]['host_issue_us']:.3f} us of host "
              f"issue ({rows[Wc]['library_host_issue_us']:.3f} for "
              f"torch.gather)")
    return rows[384]


HOST_CALLS = 1000


def host_issue_us(table, keys, mask: int, buf, flat) -> dict:
    """The host time of `small_table_take_cuda` a call, in us, and of
    each stage of it (perf_counter over HOST_CALLS calls, no synchronize):
    the loop alone, the one-pass checks of the wrapper, the raw stream
    handle, the ctypes call alone (launching the kernel), the whole
    wrapper decoding ``buf`` in place (the call `_grow` makes) and into a
    new tensor; the allocation that the in-place call skips
    (`torch.empty_like`) and `torch.empty` with the device index; the old
    call site (the list made contiguous, `keys & mask`, then the
    wrapper); and the library call, `torch.gather` over ``flat``."""
    dev = table.get_device()
    B, Wc = table.shape
    n = keys.numel() // B
    row = table.stride(0)
    fn = kernels.SMALL_TABLE_TAKE.bind()
    ptrs = (table.data_ptr(), row, buf.data_ptr(), buf.data_ptr())
    stream = kernels._stream(dev)
    dense = table.contiguous()

    def checks():
        # the wrapper's own checks, as it runs them
        shape, kshape = table.shape, keys.shape
        if (len(shape) != 2 or len(kshape) < 2 or kshape[0] != shape[0]
                or shape[1] < 1 or not -(1 << 31) <= mask < 1 << 31):
            raise ValueError
        kernels._stream_words(keys.numel() // shape[0])
        r, lane = table.stride()
        d = table.get_device()
        if (d < 0 or keys.get_device() != d or table.dtype != torch.int32
                or keys.dtype != torch.int32 or lane != 1
                or not (shape[1] <= r < 1 << 31 or shape[0] == 1)
                or not keys.is_contiguous()):
            raise ValueError

    stages = {
        "loop": lambda: None,
        "checks": checks,
        "raw stream": lambda: kernels._stream(dev),
        "ctypes call": lambda: fn(*ptrs, B, Wc, n, mask, dev, stream),
        "wrapper, in place": lambda: kernels.small_table_take_cuda(
            table, buf, mask, True),
        "wrapper, new tensor": lambda: kernels.small_table_take_cuda(
            table, keys, mask),
        "allocation (empty_like)": lambda: torch.empty_like(keys),
        "allocation (torch.empty, device index)": lambda: torch.empty(
            keys.shape, dtype=torch.int32, device=dev),
        "old call site": lambda: kernels.small_table_take_cuda(
            table.contiguous(), keys & mask),
        "library call": lambda: torch.gather(dense, 1, flat),
    }
    us = {}
    for name, f in stages.items():
        for _ in range(10):
            f()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(HOST_CALLS):
            f()
        us[name] = 1e6 * (time.perf_counter() - t0) / HOST_CALLS
        torch.cuda.synchronize()
    return us


def profiled_ms(fn, kernel: str, n: int = 200) -> float:
    """Device ms a launch of ``kernel`` over n calls of ``fn`` under
    torch.profiler (the mean over the launches it records)."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA], acc_events=True) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    times = [e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA
             and kernel in e.name]
    require(len(times) >= n // 2, f"the profiler saw {len(times)} of {n} "
            f"{kernel} launches")
    return sum(times) / len(times) / 1e3


class DrawsOn:
    """Production draws made on one device and handed to another, so a
    CPU run and a CUDA run take the same random numbers."""

    def __init__(self, inner, dev):
        self.inner, self.dev = inner, dev

    def step(self, need=True):
        d = self.inner.step(need)
        return None if d is None else bt.Draws(*(t.to(self.dev) for t in d))


def small_inputs(T, B, seed):
    rng = np.random.RandomState(seed)
    pats = rng.rand(5, SMALL["input_dim"]) < 0.2
    t = np.arange(T)
    return torch.from_numpy(pats[(t[:, None] + np.arange(B)[None]) % 5])


def check_learning(dev) -> None:
    """The drive recipe on the card: bursting falls and correct
    predictions rise over the epochs."""
    cfg = bt.make_htm_config(**SMALL)
    B, T = 4, 60
    gen = torch.Generator(device=dev).manual_seed(1)
    state = bt.htm_init_batch(cfg, B, gen, dev)
    state, m = bt.htm_scan(cfg, state, small_inputs(T, B, 0).to(dev), True,
                           draws=bt.TorchDraws(cfg.tm, B, dev, gen))
    burst = m["bursting"].float().mean(1).cpu()
    correct = m["correct"].float().mean(1).cpu()
    print(f"learning check: bursting {burst[:5].mean():.2f} -> "
          f"{burst[-5:].mean():.2f}, correct {correct[:5].mean():.2f} -> "
          f"{correct[-5:].mean():.2f} of {cfg.sp.active_columns}")
    require(burst[-5:].mean() < burst[:5].mean(), "bursting falls")
    require(correct[-5:].mean() > correct[:5].mean(), "correct rises")


def check_cpu_agreement(dev) -> None:
    """The same small run on the CPU (plain versions) and on the card
    (kernels, D=4), with the same draws and boosting on: every state leaf
    and metric equal (the boost factor rounds alike on both devices,
    ROADMAP fault k)."""
    cfg = bt.make_htm_config(**SMALL)
    require(cfg.sp.boosting_intensity > 0, "the agreement run boosts")
    B, n_learn, n_inf = 4, 40, 8
    x = small_inputs(n_learn + n_inf, B, 1)
    results = []
    for where in ("cpu", dev):
        gen = torch.Generator().manual_seed(2)
        state = bt.htm_init_batch(cfg, B, gen, "cpu")
        state = bt.htm_state_from_numpy(bt.htm_state_to_numpy(state), where)
        draws = DrawsOn(bt.TorchDraws(cfg.tm, B, "cpu", gen), where)
        xs = x.to(where)
        state, m1 = bt.htm_scan(cfg, state, xs[:n_learn], True, draws=draws)
        state, m2 = bt.htm_scan(cfg, state, xs[n_learn:], False,
                                draws=draws)
        results.append((bt.htm_state_to_numpy(state),
                        {k: v.cpu() for k, v in {**m1, **{
                            f"inf_{k}": v for k, v in m2.items()}}.items()}))
    (s_cpu, m_cpu), (s_gpu, m_gpu) = results
    for part in ("sp", "tm"):
        for name, arr in s_cpu[part].items():
            require(np.array_equal(arr, s_gpu[part][name]),
                    f"CPU and CUDA runs agree on {part}.{name}")
    for k in m_cpu:
        require(torch.equal(m_cpu[k], m_gpu[k]),
                f"CPU and CUDA runs agree on metric {k}")
    require(int(m_cpu["inf_correct"].sum()) > 0, "the small run learned")
    print(f"CPU/CUDA agreement: {n_learn} learning + {n_inf} inference "
          f"steps, B={B}, boosting intensity {cfg.sp.boosting_intensity}, "
          f"every state leaf and metric equal")


def check_boost(dev, sp, xs) -> None:
    """ROADMAP fault k: the SP's boost factor, boosted overlaps and
    k-winner sets on the card (the `sp_select` kernel, the factor as the
    boosted value of an overlap of 1) against the CPU (its plain version)
    from the same inputs, at the bench shapes (B=256, C=2048, A=41,
    boosting intensity 0.3, density 41/2048), held to fault g's contract
    (`testing.boost_agreement`): duty cycles drawn from a seeded
    generator (uniform in [0, 3 x density], 10% at 0) with binomial
    overlaps, and the learned state's own duty cycles with the overlaps
    of its next input. Prints how many values are 0, 1 and 2 ulp apart
    and how many streams are near-ties."""
    cfg = bt.make_htm_config(**BENCH).sp
    B, C, A = BATCH, cfg.column_dim, cfg.active_columns
    rng = np.random.default_rng(7)
    duty = rng.random((B, C), dtype=np.float32) * np.float32(3 * cfg.density)
    duty[rng.random((B, C)) < 0.1] = 0.0
    cases = {
        "seeded duty cycles": (torch.from_numpy(duty), torch.from_numpy(
            rng.binomial(200, 0.1, (B, C)).astype(np.int32))),
        "learned duty cycles": (sp.duty_cycle.cpu(), overlaps(
            sp.connected, xs[0]).cpu()),
    }
    for name, (d, ov) in cases.items():
        got = testing.boost_agreement(d, ov, cfg.boosting_intensity,
                                      cfg.density, A, dev)
        print(f"boost on the card (sp_select) vs the CPU, {name} (B={B}, "
              f"C={C}, A={A}, "
              f"intensity {cfg.boosting_intensity}): factor ulps "
              f"{got['factor_ulps']}, boosted ulps {got['boosted_ulps']} of "
              f"{got['values']} values; {got['near_ties']} of {got['streams']}"
              f" streams near-ties (top-k gap <= 4 ulp); k-winner sets differ "
              f"in {got['sets_differ']} other streams and "
              f"{got['sets_differ_at_near_ties']} near-tie streams, order in "
              f"{got['order_differs']}")
        require(got["ok"], f"the card keeps fault g's contract on the boost "
                f"({name})")


def check_tm_invariants(tm) -> None:
    """`bithtm_tpu/utils/checks.py:42-47`, restated: no NaN permanence,
    a live permanence has a target, a free target has perm -1."""
    perm, syn = tm.synapse_perm, tm.synapse_cell
    require(not bool(torch.isnan(perm).any()), "no NaN permanence")
    require(not bool(((perm >= 0) & (syn < 0)).any()),
            "perm >= 0 implies syn >= 0")
    require(bool((perm[syn < 0] == -1.0).all()), "syn < 0 implies perm == -1")


def bench_inputs(cfg, B: int, T: int, dev) -> torch.Tensor:
    """(T, B, I) inputs as bench.py builds them: 100 patterns at
    density 0.2, repeated, with 5% of the bits flipped each step."""
    rng = np.random.RandomState(0)
    patterns = rng.rand(100, B, cfg.input_dim) < 0.2
    return torch.from_numpy(patterns[np.arange(T) % 100]
                            ^ (rng.rand(T, B, cfg.input_dim) < 0.05)).to(dev)


def timed_scan(cfg, state, xs, learning: bool, draws):
    """`htm_scan` with the host time of the run, synchronized at both
    ends."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, m = bt.htm_scan(cfg, state, xs, learning, detailed_metrics=False,
                           draws=draws)
    torch.cuda.synchronize()
    return state, m, time.perf_counter() - t0


class Start:
    """A state (and the state of the generator its draws come from) that
    several runs of one path start from. A run of the loop takes a copy;
    a run of the graph restores the start into the buffers the graph run
    before it returned (`keep`), so that only the first graph run
    captures."""

    def __init__(self, state, gen=None, make_draws=None):
        self.state = copy.deepcopy(state)
        self.gen = (None if gen is None
                    else torch.Generator(device=gen.device))
        self.gen_state = None if gen is None else gen.get_state()
        self.draws = None if make_draws is None else make_draws(self.gen)
        self.held = None

    def restore(self, into_held: bool = True):
        if self.gen is not None:
            self.gen.set_state(self.gen_state)
        held, state = self.held, self.state
        if into_held and held is not None:
            self.held = None
            state = bgraph.restore_into(held, self.state)
        return copy.deepcopy(state) if state is self.state else state

    def keep(self, state) -> None:
        self.held = state


class Snapshot(Start):
    """The state and generator at the start of the steady window, with
    the window's inputs, to run its steps again with the same draws."""

    def __init__(self, cfg, state, gen, xs):
        super().__init__(state, gen, lambda g: bt.TorchDraws(
            cfg.tm, state.batch, g.device, g))
        self.cfg, self.xs = cfg, xs


def same_tree(a, b) -> bool:
    """Two pytrees of tensors (states, metric dicts) equal bit for bit,
    leaf for leaf, in structure and dtype."""
    (sa, la), (sb, lb) = bgraph.flatten(a), bgraph.flatten(b)
    return sa == sb and all(x.dtype == y.dtype and torch.equal(x, y)
                            for x, y in zip(la, lb))


def loop_vs_graph(what: str, start: Start, fn, n: int,
                  timed: bool = True) -> dict:
    """One path, ``fn(state, k) -> (state, metrics)`` over its first k of
    n steps drawing from ``start.draws``, run from ``start`` by the loop
    (`graph.eager()`) and by graph replays, each with the launch counts
    set to 0 just before and read just after: the two must agree in every
    leaf and metric, launch the same kernels and leave the generator
    alike. With ``timed``, then REPEATS runs of each in turns (the graph's
    restored into its buffers: replays only; host time, synchronized,
    the start's copy outside it) and a `torch.profiler` run of the first
    PROFILED_STEPS steps of each: ms/step (median), device busy and
    kernel launches a step and the busy share. Returns those numbers,
    the launches and the first graph run's ms/step (its capture
    included)."""
    def prepare(mode):
        st = start.restore(into_held=mode == "graph")
        torch.cuda.synchronize()
        return st

    def execute(mode, st, k=n):
        with bgraph.eager() if mode == "loop" else contextlib.nullcontext():
            st, m = fn(st, k)
        if mode == "graph":
            start.keep(st)
        return st, m

    def run(mode):
        st = prepare(mode)
        t0 = time.perf_counter()
        st, m = execute(mode, st)
        torch.cuda.synchronize()
        return st, m, time.perf_counter() - t0

    got = {}
    for mode in ("loop", "graph"):
        kernels.reset_launch_counts()
        st, m, sec = run(mode)
        got[mode] = (st, m, kernels.launch_counts(),
                     None if start.gen is None else start.gen.get_state(),
                     sec)
    (s_l, m_l, n_l, g_l, _), (s_g, m_g, n_g, g_g, first_s) = (got["loop"],
                                                              got["graph"])
    require(same_tree(s_g, s_l) and same_tree(m_g, m_l),
            f"{what}: the graph's replays == the loop, every leaf and "
            f"metric")
    require(n_g == n_l and any(n_g.values()),
            f"{what}: the replays launch the loop's kernels, got {n_g} "
            f"against {n_l}")
    require(g_l is None or torch.equal(g_g, g_l),
            f"{what}: the generator ends where the loop leaves it")
    out = {"launches": {k: v for k, v in n_g.items() if v},
           "graph_first_run_ms_per_step": 1e3 * first_s / n}
    del got, s_l, m_l, s_g, m_g
    if not timed:
        print(f"{what}: graph == loop over {n} steps in every leaf and "
              f"metric; launches {out['launches']}")
        return out
    runs = {"loop": [], "graph": []}
    for _ in range(REPEATS):
        for mode in runs:
            runs[mode].append(1e3 * run(mode)[2] / n)
    k = min(n, PROFILED_STEPS)
    for mode in runs:
        st = prepare(mode)
        print(f"  profile of {k} steps of {what}, {mode}, top device ops:")
        busy, n_launch = device_profile(lambda: execute(mode, st, k), k, 3)
        med = statistics.median(runs[mode])
        out[mode] = {"ms_per_step": med, "runs": runs[mode],
                     "device_busy_ms_per_step": busy,
                     "launches_per_step": n_launch,
                     "busy_share": busy / med}
        del st
    print(f"{what}: graph == loop over {n} steps in every leaf and metric, "
          f"launches {out['launches']}; ms/step (median of {REPEATS}; "
          f"device busy; launches a step; busy share): " + "; ".join(
              f"{mode} {out[mode]['ms_per_step']:.3f} ("
              + ", ".join(f"{t:.3f}" for t in runs[mode])
              + f"; {out[mode]['device_busy_ms_per_step']:.3f}; "
              f"{out[mode]['launches_per_step']:.1f}; "
              f"{out[mode]['busy_share']:.3f})" for mode in runs)
          + f"; the first graph run {out['graph_first_run_ms_per_step']:.3f}"
          f" ms/step (capture included)")
    return out


def graph_ms(fn, n: int = 20, reps: int = 10) -> float:
    """ms a call of ``fn`` inside a CUDA graph of n calls (CUDA events
    over ``reps`` replays after one): the device time of a call with no
    host issue between calls."""
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
    start.record()
    for _ in range(reps):
        g.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (n * reps)
    del g
    return ms


def run_main_path(dev):
    """The bench configuration through `htm_scan`: LEARN_STEPS learning
    steps, timed on the host every WINDOW steps (step 0 alone and
    untimed), then INFER_STEPS inference steps over the learned graph.
    Returns the launch counts of that run, a snapshot at the start of
    the steady window (the last WINDOW learning steps), the median
    ms/step of REPEATS runs of that window, and the learned state with
    its generator and the SERVE_STEPS inputs that follow."""
    cfg = bt.make_htm_config(**BENCH)
    B, A = BATCH, cfg.sp.active_columns
    seq = bench_inputs(cfg, B, LEARN_STEPS + INFER_STEPS + SERVE_STEPS, dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    state = bt.htm_init_batch(cfg, B, gen, dev)
    draws = bt.TorchDraws(cfg.tm, B, dev, gen)
    bounds = [0, 1, *range(WINDOW, LEARN_STEPS + 1, WINDOW)]
    require(bounds[-1] == LEARN_STEPS, "LEARN_STEPS is a multiple of WINDOW")
    torch.cuda.synchronize()
    # the peak of this path, not of the kernel checks before it
    torch.cuda.reset_peak_memory_stats()

    kernels.reset_launch_counts()
    chunks = []
    for a, b in zip(bounds, bounds[1:]):
        if b == LEARN_STEPS:
            snap = Snapshot(cfg, state, gen, seq[a:b])
        state, m, s = timed_scan(cfg, state, seq[a:b], True, draws)
        chunks.append((a, b, s, m))
    state, m_inf, infer_s = timed_scan(
        cfg, state, seq[LEARN_STEPS:LEARN_STEPS + INFER_STEPS], False, draws)
    launches = kernels.launch_counts()

    require(launches == steps(table_update=LEARN_STEPS, act_conn=INFER_STEPS),
            f"one launch per step of each kernel, got {launches}")
    print("main path launches by path: " + json.dumps(kernels.path_counts()))
    m_learn = {k: torch.cat([c[3][k] for c in chunks]) for k in chunks[0][3]}
    for phase, m, n in (("learning", m_learn, LEARN_STEPS),
                        ("inference", m_inf, INFER_STEPS)):
        for k, v in m.items():
            require(tuple(v.shape) == (n, B), f"{phase} {k} shape")
            require(bool(torch.isfinite(v.float()).all()),
                    f"{phase} {k} finite")
        for k in ("bursting", "correct", "incorrect", "tm_bursting_columns"):
            require(bool(((m[k] >= 0) & (m[k] <= A)).all()),
                    f"{phase} {k} in [0, A]")
        require(bool((m["tm_active_cells"] <= A * cfg.cell_dim).all()),
                f"{phase} active cells <= A*D")
    for k in ("tm_dropped_new_segments", "tm_dropped_synapses",
              "tm_dropped_winner_candidates", "tm_dropped_growth_segments",
              "tm_evicted_segments"):
        require(k in m_learn and bool((m_learn[k] >= 0).all()),
                f"{k} reported")
    check_tm_invariants(state.tm)

    def mean(m, k):
        return m[k].double().mean().item()

    print(f"main path on {torch.cuda.get_device_name(0)}: bench config, "
          f"B={B}, A={A}; per stream and step: ms/step of the batch, "
          f"bursting, correct and incorrect columns, new, reinforced and "
          f"evicted segments")
    for a, b, s, m in chunks + [(LEARN_STEPS, LEARN_STEPS + INFER_STEPS,
                                 infer_s, m_inf)]:
        learn = b <= LEARN_STEPS
        seg = (f" new {mean(m, 'tm_new_segments'):.3f} reinforced "
               f"{mean(m, 'tm_learning_segments') - mean(m, 'tm_new_segments'):.3f}"
               f" evicted {mean(m, 'tm_evicted_segments'):.3f}"
               if learn else "")
        print(f"  {'learning' if learn else 'inference'} steps {a}-{b}: "
              f"{1e3 * s / (b - a):.3f} ms/step; bursting "
              f"{mean(m, 'bursting'):.2f} correct {mean(m, 'correct'):.2f} "
              f"incorrect {mean(m, 'incorrect'):.2f};{seg}")
    win_m = chunks[-1][3]
    require(mean(win_m, "correct") > A / 2 and mean(m_inf, "correct") > A / 2,
            "after learning, most active columns were predicted (the "
            "reinforcement and prediction branches ran at bench width)")
    win_ms = [1e3 * chunks[-1][2] / WINDOW]
    # the replays' graph captured before they are timed (two steps)
    snap.keep(timed_scan(cfg, snap.restore(), snap.xs[:2], True,
                         snap.draws)[0])
    for _ in range(REPEATS - 1):
        st, m, s = timed_scan(cfg, snap.restore(), snap.xs, True,
                              snap.draws)
        require(all(torch.equal(m[k], win_m[k]) for k in win_m),
                "a replay of the steady window reproduces its metrics")
        win_ms.append(1e3 * s / WINDOW)
        snap.keep(st)
        del st
    med = statistics.median(win_ms)
    perf = {
        "learning_ms_per_step": med,
        "learning_steps_per_s": 1e3 / med,
        "learning_stream_steps_per_s": B * 1e3 / med,
        "learning_window_ms_per_step_runs": win_ms,
        "learning_ms_per_step_after_step_0":
            1e3 * sum(c[2] for c in chunks[1:]) / (LEARN_STEPS - 1),
        "inference_ms_per_step": 1e3 * infer_s / INFER_STEPS,
        "streams": B,
        "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30,
    }
    print(f"steady window: learning steps {LEARN_STEPS - WINDOW}-"
          f"{LEARN_STEPS}, {REPEATS} runs (the main run and replays with "
          f"the same draws, metrics equal): "
          + ", ".join(f"{t:.3f}" for t in win_ms)
          + f" ms/step; median {med:.3f} ms/step, {1e3 / med:.2f} steps/s, "
          f"{B * 1e3 / med:.1f} stream-steps/s")
    print("main path metrics: " + json.dumps(perf))
    return launches, snap, med, (state, gen, seq[LEARN_STEPS + INFER_STEPS:])


def differing_leaves(a, b) -> list[str]:
    return [f"{part}.{f.name}" for part in ("sp", "tm")
            for f in dataclasses.fields(getattr(a, part))
            if not torch.equal(getattr(getattr(a, part), f.name),
                               getattr(getattr(b, part), f.name))]


def run_serving(cfg, state, gen, xs) -> dict:
    """Serve len(xs) steps from the learned state three ways, each from a
    copy of it: `htm_serve_scan` over the synapse tables (unpacked), over
    a compact serving table (packed) and `_scan_impl` over the frozen
    word table (frozen). Each form runs with the launch counts set to 0
    just before it and read just after: one launch a step of its own
    kernel and none of the others. The three give equal metrics and
    predictions, the frozen run the unpacked run's state in every leaf.
    Then `resume_learning` on the packed state (one `act_conn` launch)
    gives the unpacked state in every leaf, and RESUME_STEPS learning
    steps from one generator snapshot leave both equal. The forms' times
    (graph against loop) are `run_graph_bench`'s. Before the runs,
    `serving_counts` is held to its plain versions and timed on the
    learned table (`learned_table_row`). Returns (the launch counts of
    the packed and frozen runs' own kernels, the `serving_counts` row)."""
    dev = state.tm.step.device
    B, N, A = state.batch, len(xs), cfg.sp.active_columns
    C, K = cfg.tm.column_dim, cfg.tm.synapse_capacity
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tab = bt.make_serving_table(cfg.tm, state.tm)
    word = bt.pack_frozen_table(state.tm.synapse_cell, state.tm.synapse_perm,
                                cfg.tm.permanence_threshold,
                                num_cells=cfg.tm.num_cells)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    E = tab.ext_col.shape[1]
    M = (tab.rows.shape[1] - E) // C
    mib = {"serving table": (tab.rows.numel() + tab.ext_col.numel()) * 4,
           "frozen words": word.numel() * 4,
           "syn + perm": state.tm.synapse_cell.numel() * 8}
    print(f"serving table at B={B}: M={M} main row(s) a column, E={E} "
          f"extension rows ({int((tab.ext_col < C).sum())} used over the "
          f"streams), built with the frozen words in {build_s:.3f} s; "
          + ", ".join(f"{k} {v / 2**20:.1f} MiB" for k, v in mib.items()))

    # the kernels at the learned table's own shapes, against plain
    tm = state.tm
    require(torch.equal(
        kernels.serving_activation_cuda(tab.rows, tm.active_cols,
                                        tm.active_bits, C, cfg.tm.cell_dim),
        psv.serving_activation_ref(tab.rows, tm.active_cols, tm.active_bits,
                                   C, cfg.tm.cell_dim)),
        "serving_activation == plain on the learned table")
    require(torch.equal(
        kernels.act_frozen_cuda(word, tm.active_cols, tm.active_bits,
                                cfg.tm.cell_dim, K),
        pas.synapse_activation_frozen_ref(word, tm.active_cols,
                                          tm.active_bits, cfg.tm.cell_dim,
                                          K)),
        "act_frozen == plain on the learned table")
    counts_row = learned_table_row(cfg.tm, tm, tab,
                                   "the learned bench serving table")

    forms = {
        "unpacked": (lambda st: bt.htm_serve_scan(
            cfg, st, xs, detailed_metrics=False), "act_conn"),
        "packed": (lambda st: bt.htm_serve_scan(
            cfg, st, xs, serving_table=tab), "serving_counts"),
        "frozen": (lambda st: _scan_impl(
            cfg, st, xs, False, False, False, frozen_word=word),
            "act_frozen"),
    }
    out, launches = {}, {}
    for name, (fn, kernel) in forms.items():
        st = copy.deepcopy(state)
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        out[name] = fn(st)
        launches[name] = kernels.launch_counts()
        require(launches[name] == steps(**{kernel: N}),
                f"{name} serving launches {kernel}, sp_overlap, sp_select, "
                f"column_decide and (but packed) seg_counts once a step and "
                f"no other kernel, got {launches[name]}")
    s_u, m_u = out["unpacked"]
    for name, (st, m) in out.items():
        require(set(m) == set(m_u) and all(torch.equal(m[k], m_u[k])
                                           for k in m_u),
                f"{name} serving metrics == unpacked")
        require(torch.equal(st.tm.prediction, s_u.tm.prediction),
                f"{name} serving prediction == unpacked")
    diff = differing_leaves(out["frozen"][0], s_u)
    require(not diff, f"frozen serving leaves == unpacked, differ: {diff}")
    correct = m_u["correct"].double().mean().item()
    require(correct > A / 2, "the served graph predicts")

    s_p = out["packed"][0]
    require(not torch.equal(s_p.tm.synapse_act, s_u.tm.synapse_act),
            "packed serving leaves synapse_act stale")
    kernels.reset_launch_counts()
    s_r = bt.resume_learning(cfg, s_p)
    resumed = kernels.launch_counts()
    require(resumed == steps(act_conn=1, sp_steps=0, column_decide=0),
            f"resume_learning launches act_conn and seg_counts (flags) "
            f"once, got "
            f"{resumed}")
    diff = differing_leaves(s_r, s_u)
    require(not diff, f"resumed leaves == unpacked-served, differ: {diff}")
    snap = gen.get_state()
    learned = []
    for st in (s_r, s_u):
        g = torch.Generator(device=dev)
        g.set_state(snap)
        learned.append(bt.htm_scan(cfg, st, xs[:RESUME_STEPS], True,
                                   detailed_metrics=False,
                                   draws=bt.TorchDraws(cfg.tm, B, dev, g)))
    (s_a, m_a), (s_b, m_b) = learned
    diff = differing_leaves(s_a, s_b)
    require(not diff and all(torch.equal(m_a[k], m_b[k]) for k in m_b),
            f"serve packed -> resume -> learn == serve unpacked -> learn, "
            f"differ: {diff}")
    del out, learned, s_u, s_p, s_r, s_a, s_b
    print(f"serving {N} steps at B={B}: unpacked, packed and frozen word "
          f"give equal metrics and predictions (correct {correct:.2f} of "
          f"{A}), frozen == unpacked in every leaf; launches {launches}; "
          f"packed -> resume_learning (act_conn x1) -> {RESUME_STEPS} "
          f"learning steps == unpacked -> learning, every leaf and metric")

    return {"serving_counts": launches["packed"]["serving_counts"],
            "act_frozen": launches["frozen"]["act_frozen"]}, counts_row


def run_graph_bench(cfg, state, gen, xs) -> dict:
    """Loop against graph at the bench configuration (B=256) from the
    learned state, with `loop_vs_graph`: GRAPH_LEARN learning steps,
    GRAPH_INFER inference steps and GRAPH_SERVE serving steps of each
    form (unpacked, over a compact serving table, over the frozen word
    table), each bit-equal to the loop and timed against it."""
    B = state.batch
    start = Start(state, gen, lambda g: bt.TorchDraws(cfg.tm, B, g.device,
                                                       g))
    out = {
        "learning": loop_vs_graph(
            "bench learning", start, lambda st, k: bt.htm_scan(
                cfg, st, xs[:k], True, detailed_metrics=False,
                draws=start.draws), GRAPH_LEARN),
        "inference": loop_vs_graph(
            "bench inference", start, lambda st, k: bt.htm_scan(
                cfg, st, xs[:k], False, detailed_metrics=False,
                draws=start.draws), GRAPH_INFER),
    }
    del start
    tab = bt.make_serving_table(cfg.tm, state.tm)
    word = bt.pack_frozen_table(state.tm.synapse_cell, state.tm.synapse_perm,
                                cfg.tm.permanence_threshold,
                                num_cells=cfg.tm.num_cells)
    forms = {
        "unpacked": lambda st, k: bt.htm_serve_scan(cfg, st, xs[:k],
                                                    detailed_metrics=False),
        "packed": lambda st, k: bt.htm_serve_scan(cfg, st, xs[:k],
                                                  serving_table=tab),
        "frozen": lambda st, k: _scan_impl(cfg, st, xs[:k], False, False,
                                           False, frozen_word=word),
    }
    for name, fn in forms.items():
        out[f"serving_{name}"] = loop_vs_graph(
            f"bench serving {name}", Start(state), fn, GRAPH_SERVE)
    return out


def distal_forward_stock(cfg, state, active_cols, act_bits):
    """A `distal_forward` hook of `tm_step` that computes what the stock
    forward pass does: the activity (`act_conn`) and the counts of the
    `seg_counts` decode's counts form; `tm_step` then takes the
    thresholds, `prediction_words` and the matching word's `pack_bits`
    itself."""
    act = pas.synapse_activation_conn(
        state.synapse_cell, state.synapse_perm, active_cols, act_bits,
        cfg.cell_dim, cfg.permanence_threshold, cfg.synapse_capacity)
    return (act, *pas.seg_counts_packed(act, cfg.segments_per_column,
                                        cfg.synapse_capacity))


def run_entry_points(cfg, state, xs) -> dict:
    """The entry points that no scan calls, on the learned bench state,
    with the launch counts set to 0 just before and read just after:
    ENTRY_STEPS learning steps of `sp_step` on a copy of the SP state
    (its `sp_rows` kernel), each held against `hebbian_delta` +
    `sp_update_pack` over the whole table from the step's starting
    permanences (the same permanences and the connected bits of every
    row); `synapse_activation` over the learned synapse table, whose
    activity on live slots must be the state's own (the last forward
    pass's); `serving_activation` over the learned compact serving table
    against its plain version; and an inference `htm_step` with a
    `distal_forward` hook (`distal_forward_stock`), the one step that
    packs its matching word with `pack_bits`, equal to the stock
    inference step in its prediction, matching word and metrics.
    Returns the launch counts."""
    sp, tm = copy.deepcopy(state.sp), state.tm
    C, D = cfg.tm.column_dim, cfg.tm.cell_dim
    tab = bt.make_serving_table(cfg.tm, tm)
    x = xs[ENTRY_STEPS]
    stock = bt.htm_step(cfg, copy.deepcopy(state), x, learning=False,
                        compute_winner=False, detailed_metrics=False,
                        dense_outputs=False)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    for x_sp in xs[:ENTRY_STEPS]:
        before = sp.permanence.clone()
        sp, out = bt.sp_step(cfg.sp, sp, x_sp, True)
        delta, thr = psp.hebbian_delta(cfg.sp, x_sp, before.shape[-1])
        perm, pack = psp.sp_update_pack(before, delta, out.active_columns,
                                        thr)
        require(torch.equal(perm, sp.permanence)
                and torch.equal(pack, sp.connected),
                "sp_update_pack == the learning of sp_step")
        del before, perm, pack
    act = pas.synapse_activation(tm.synapse_cell, tm.active_cols,
                                 tm.active_bits, C, D)
    served = psv.serving_activation(tab.rows, tm.active_cols, tm.active_bits,
                                    C, D)
    hooked = bt.htm_step(cfg, copy.deepcopy(state), x, learning=False,
                         compute_winner=False, detailed_metrics=False,
                         dense_outputs=False,
                         distal_forward=distal_forward_stock)
    launches = kernels.launch_counts()
    require(torch.equal((act != 0) & (tm.synapse_perm >= 0),
                        tm.synapse_act != 0),
            "synapse_activation on live slots == the state's activity")
    require(torch.equal(served, psv.serving_activation_ref(
        tab.rows, tm.active_cols, tm.active_bits, C, D))
        and bool((served > 0).any()),
        "serving_activation == plain on the learned serving table")
    (s_h, o_h), (s_s, o_s) = hooked, stock
    require(torch.equal(s_h.tm.prediction, s_s.tm.prediction)
            and torch.equal(s_h.tm.matching_word, s_s.tm.matching_word)
            and all(torch.equal(o_h.metrics[k], o_s.metrics[k])
                    for k in o_s.metrics),
            "a distal_forward step == the stock inference step")
    require(launches == only(sp_update_pack=ENTRY_STEPS,
                             sp_overlap=ENTRY_STEPS + 1,
                             sp_rows=ENTRY_STEPS,
                             sp_select=ENTRY_STEPS + 1, synapse_activation=1,
                             serving_activation=1, act_conn=1, seg_counts=1,
                             column_decide=1, pack_bits=1),
            f"the entry points launch their kernels, got {launches}")
    print(f"entry points on the learned bench state: {ENTRY_STEPS} SP "
          f"learning steps == sp_update_pack over the whole table; "
          f"synapse_activation == the state's activity on live slots "
          f"({int((act != 0).sum())} active slots); serving_activation == "
          f"plain ({int((served != 0).sum())} active words); a "
          f"distal_forward step == the stock step; launches {launches}")
    del tab, served, hooked, stock
    return launches


def time_phases(snap: Snapshot, xs) -> None:
    """The phases of `htm_step` over len(xs) learning steps: the host
    time each takes to issue its work (no synchronization inside the
    step) and the span it covers on the stream (CUDA events), per step."""
    cfg = snap.cfg
    state, draws = snap.restore(), snap.draws
    names = ("draws", "sp_step", "tm_step", "metrics")
    host, events = dict.fromkeys(names, 0.0), []
    torch.cuda.synchronize()
    for x in xs:
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
        t = [time.perf_counter()]
        ev[0].record()
        d = draws.step(True)
        t.append(time.perf_counter())
        ev[1].record()
        sp_state, sp_out = bt.sp_step(cfg.sp, state.sp, x, True)
        t.append(time.perf_counter())
        ev[2].record()
        tm_state, tm_out = bt.tm_step(
            cfg.tm, state.tm, d, sp_out.active_columns, True, True,
            detailed_metrics=False, col_active=sp_out.active_mask,
            dense_outputs=False)
        t.append(time.perf_counter())
        ev[3].record()
        _step_metrics(cfg, sp_out, tm_out)
        t.append(time.perf_counter())
        ev[4].record()
        state = bt.HTMState(sp=sp_state, tm=tm_state)
        for i, name in enumerate(names):
            host[name] += t[i + 1] - t[i]
        events.append(ev)
    torch.cuda.synchronize()
    n = len(xs)
    span = {name: sum(ev[i].elapsed_time(ev[i + 1]) for ev in events) / n
            for i, name in enumerate(names)}
    print(f"phases over {n} steady learning steps (ms/step, host issue / "
          f"stream span): " + "; ".join(
              f"{k} {1e3 * host[k] / n:.3f} / {span[k]:.3f}" for k in names))


# the device names of the port's own kernels (csrc/*.cu)
PORT_KERNELS = ("table_pass_kernel", "word_range_kernel", "word_pass_kernel",
                "small_take_kernel", "sp_update_pack_kernel",
                "sp_overlap_kernel", "seg_counts_kernel",
                "seg_flags", "grow_select_kernel",
                "row_counts_kernel", "learn_rows_kernel",
                "column_decide_kernel", "pack_ballot_kernel",
                "pack_vec_kernel")


PROFILE_ATTEMPTS = 3  # `device_profile`'s sessions while one sees no work


def device_profile(run, n: int, top: int) -> tuple[float, float]:
    """torch.profiler over ``run()``, which takes n steps, after a
    warm-up phase (`warm_profile`: a session's first launches go
    unrecorded): prints the top device ops a step, then the port's own
    kernels outside the top, and returns (device busy ms, kernel
    launches) a step. A session that recorded no device work at all (on
    an H100 a run of this script once lost a whole graph profile) is
    run again, up to PROFILE_ATTEMPTS sessions, as
    `scripts/profile_step.py` profiles again on lost launches."""
    for attempt in range(1, PROFILE_ATTEMPTS + 1):
        with warm_profile(torch.device("cuda", torch.cuda.current_device())
                          ) as prof:
            run()
        events = device_events(prof)
        if events:
            break
        print(f"  profile {attempt}: the profiler recorded no device work; "
              f"profiling again")
    per_op: dict[str, list] = {}
    for e in events:
        c = per_op.setdefault(e.name, [0, 0.0])
        c[0] += 1
        c[1] += e.time_range.elapsed_us() / 1e3
    busy = sum(c[1] for c in per_op.values()) / n
    launches = sum(c[0] for name, c in per_op.items()
                   if not name.startswith(("Memcpy", "Memset"))) / n
    require(busy > 0, "the profiler saw device time")
    ranked = sorted(per_op.items(), key=lambda kv: -kv[1][1])
    for i, (name, (count, ms)) in enumerate(ranked):
        if i < top or any(k in name for k in PORT_KERNELS):
            print(f"  {ms / n:8.3f} ms/step  {count / n:6.1f}/step  "
                  f"{name[:100]}")
    return busy, launches


def run_16k(dev) -> tuple[dict, dict, tuple, dict, tuple]:
    """The 16K x 64 path at full width, B=64, on the bench input recipe:
    `htm_scan_autocap` under the tuned caps over LEARN_16K learning steps
    in chunks of CHUNK_16K, then INFER_16K inference steps and SERVE_16K
    serving steps unpacked and packed, REPEATS runs of each in turns
    (equal metrics and predictions, each form launching only its own
    kernel, once a step; the median time and a device profile of each).
    Requires `small_table_take` and `table_update` once per learning step
    run (a chunk re-run after an escalation runs its steps again), grown
    synapses, no counted cap drop in the produced trajectory, the state
    invariants and bursting falling from the first chunk to the last;
    then holds the table kernels, `serving_activation` and
    `serving_counts` over the learned serving table and
    `synapse_activation` against their plain versions on the learned
    state and times them (`kernel_row`, with the grid of each row-range
    kernel; `serving_counts` also in a CUDA graph). Returns (launch
    counts of the learning run, the kernel rows at this geometry, the
    first PAR_16K_BATCH streams of the learned state as host leaves with
    the caps in force, the graph-against-loop numbers, and a copy of the
    learned state with its generator, config and step for `run_soaks`)."""
    cfg = bt.make_htm_config(**GEOM_16K)
    B, A, T = BATCH_16K, cfg.sp.active_columns, LEARN_16K
    C, D, K = cfg.tm.column_dim, cfg.tm.cell_dim, cfg.tm.synapse_capacity
    seq = bench_inputs(cfg, B, T + INFER_16K + SERVE_16K, dev)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(16)
    state = bt.htm_init_batch(cfg, B, gen, dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    chunks = []
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    state, m, info = bt.htm_scan_autocap(
        cfg, state, seq[:T], tuned=TUNED_16K, chunk=CHUNK_16K,
        draws=bt.TorchDraws(cfg.tm, B, dev, gen),
        on_chunk=lambda *a: chunks.append(a))
    launches = kernels.launch_counts()
    learning_peak = torch.cuda.max_memory_allocated() / 2**30
    esc = info["escalated_at_step"]
    run = T + (0 if esc is None else min(CHUNK_16K, T - esc))
    require(launches == steps(table_update=run, small_table_take=run),
            f"table_update, small_table_take, sp_overlap and seg_counts "
            f"once per learning step "
            f"({run} run), got {launches}")
    require(all(int(m[k].sum()) == 0 for k in bt.CAP_DROP_METRICS),
            "no counted cap drop in the produced trajectory")
    require(int(m["tm_grown_synapses"].sum()) > 0, "synapses grew")
    for k, v in m.items():
        require(tuple(v.shape) == (T, B) and bool(torch.isfinite(
            v.float()).all()), f"16K learning {k}: (T, B), finite")
    check_tm_invariants(state.tm)
    record_decisions("16k", dataclasses.replace(
        cfg, tm=dataclasses.replace(cfg.tm, **TUNED_16K)), state, seq[T])

    def mean(m, k, a=0, b=None):
        return m[k][a:b].double().mean().item()

    first = mean(m, "bursting", 0, CHUNK_16K)
    last = mean(m, "bursting", T - CHUNK_16K)
    require(last < first, "bursting falls from the first chunk to the last")
    print(f"16K x 64 on {torch.cuda.get_device_name(0)}: {C} columns x {D} "
          f"cells, A={A}, B={B}, tuned caps {TUNED_16K}, chunk "
          f"{CHUNK_16K}; state built in {init_s:.2f} s; escalated_at_step "
          f"{esc}, tuned_drops {info['tuned_drops']}; launches {launches}")
    for t_0, s, escalated, drops in chunks:
        t_1 = min(t_0 + CHUNK_16K, T)
        print(f"  learning steps {t_0}-{t_1}: {1e3 * s / (t_1 - t_0):.3f} "
              f"ms/step{' (escalated, re-run)' if escalated else ''}; "
              f"drops {drops}; bursting {mean(m, 'bursting', t_0, t_1):.2f} "
              f"correct {mean(m, 'correct', t_0, t_1):.2f} of {A}; winner "
              f"cells {mean(m, 'tm_winner_cells', t_0, t_1):.1f}, grown "
              f"{mean(m, 'tm_grown_synapses', t_0, t_1):.1f}, learning "
              f"segments {mean(m, 'tm_learning_segments', t_0, t_1):.1f}")

    kernels.reset_launch_counts()
    state, m_inf, infer_s = timed_scan(cfg, state, seq[T:T + INFER_16K],
                                       False, bt.TorchDraws(cfg.tm, B, dev,
                                                            gen))
    require(kernels.launch_counts() == steps(act_conn=INFER_16K),
            "16K inference launches act_conn, sp_overlap and seg_counts "
            "once a step")

    serve_xs = seq[T + INFER_16K:]
    tab = bt.make_serving_table(cfg.tm, state.tm)
    forms = {"unpacked": ({"detailed_metrics": False}, "act_conn"),
             "packed": ({"serving_table": tab}, "serving_counts")}
    served, runs = {}, {name: [] for name in forms}
    # each form's graph captured (two steps) before the timed runs, which
    # restore the learned state into its buffers
    starts = {name: Start(state) for name in forms}
    for name, (kw, _) in forms.items():
        starts[name].keep(bt.htm_serve_scan(
            cfg, starts[name].restore(), serve_xs[:2], **kw)[0])
    for rep in range(REPEATS):
        for name, (kw, kernel) in forms.items():
            st = starts[name].restore()
            torch.cuda.synchronize()
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            st, ms = bt.htm_serve_scan(cfg, st, serve_xs, **kw)
            torch.cuda.synchronize()
            runs[name].append(1e3 * (time.perf_counter() - t0) / SERVE_16K)
            got = kernels.launch_counts()
            require(got == steps(**{kernel: SERVE_16K}),
                    f"16K {name} serving launches {kernel} and the SP's and "
                    f"counts' kernels once a step, got {got}")
            if rep == 0:
                served[name] = (st.tm.prediction.clone(), ms)
            starts[name].keep(st)
            del st
    (p_u, m_u), (p_p, m_p) = served["unpacked"], served["packed"]
    require(torch.equal(p_u, p_p) and set(m_u) == set(m_p)
            and all(torch.equal(m_u[k], m_p[k]) for k in m_u),
            "16K serving: packed == unpacked in metrics and predictions")
    E = tab.ext_col.shape[1]
    perf = {
        "learning_ms_per_step_chunks": [1e3 * c[1] / min(CHUNK_16K, T - c[0])
                                        for c in chunks],
        "escalated_at_step": esc,
        "inference_ms_per_step": 1e3 * infer_s / INFER_16K,
        **{f"serving_{name}_ms_per_step": statistics.median(r)
           for name, r in runs.items()},
        **{f"serving_{name}_ms_per_step_runs": r for name, r in runs.items()},
        "serving_table_rows": tab.rows.shape[1], "serving_table_ext": E,
        "streams": B,
        "learning_peak_memory_gib": learning_peak,
        "peak_memory_gib": torch.cuda.max_memory_allocated() / 2**30,
    }
    print(f"  inference {INFER_16K} steps: {perf['inference_ms_per_step']:.3f}"
          f" ms/step, correct {mean(m_inf, 'correct'):.2f} of {A}; serving "
          f"{SERVE_16K} steps, median of {REPEATS} runs in turns (the first "
          f"checked): " + ", ".join(
              f"{name} {statistics.median(r):.3f} ("
              + ", ".join(f"{t:.3f}" for t in r) + ")"
              for name, r in runs.items())
          + f" ms/step (table R={tab.rows.shape[1]}, E={E}), equal "
          f"predictions, correct {mean(m_u, 'correct'):.2f}")
    del served, p_u, p_p
    for name, (kw, _) in forms.items():
        st = starts[name].restore()
        print(f"profile of {SERVE_16K} 16K {name} serving steps, top device "
              f"ops:")
        busy, n_launch = device_profile(
            lambda: bt.htm_serve_scan(cfg, st, serve_xs, **kw), SERVE_16K, 5)
        med = perf[f"serving_{name}_ms_per_step"]
        print(f"  device busy {busy:.3f} ms/step, {n_launch:.1f} kernel "
              f"launches/step, busy share {busy / med:.3f} of the median "
              f"{med:.3f} ms/step")
        perf[f"serving_{name}_device_busy_ms_per_step"] = busy
        del st
    del starts

    # loop against graph under autocap from the learned state: the tuned
    # caps' chunk, then a forced escalation (a growth list of 8 drops)
    start = Start(state, gen, lambda g: bt.TorchDraws(cfg.tm, B, g.device,
                                                       g))
    infos = []

    def autocap(st, xs, tuned, chunk):
        st, m, info = bt.htm_scan_autocap(cfg, st, xs, tuned=tuned,
                                          chunk=chunk, draws=start.draws)
        infos.append(info)
        return st, m

    perf["graph_vs_loop"] = loop_vs_graph(
        "16K learning under autocap", start,
        lambda st, k: autocap(st, seq[:k], TUNED_16K, CHUNK_16K),
        GRAPH_16K)
    infos.clear()
    perf["graph_vs_loop_escalation"] = loop_vs_graph(
        "16K forced escalation", start,
        lambda st, k: autocap(st, seq[:k], {"growth_capacity": 8},
                              GRAPH_ESCALATE // 2), GRAPH_ESCALATE,
        timed=False)
    require(len(infos) == 2 and infos[0] == infos[1]
            and infos[0]["escalated_at_step"] == 0,
            f"the forced escalation escalates at step 0, alike in the loop "
            f"and the graph: {infos}")
    del start

    tm = state.tm
    cols, bits = tm.active_cols, tm.active_bits
    thr, pun = cfg.tm.permanence_threshold, cfg.tm.permanence_punishment
    # the punishment words of a learning step whose active set is this one
    pun_word = torch.where(pas.column_mask_from_cols(cols, C), 0,
                           tm.matching_word)
    at = f"B={B} C={C} G={cfg.tm.segments_per_column} K={K} D={D} A={A}, " \
         f"the learned 16K state"
    # each side on its own copies: the state's activity stays as it is
    v_ref, p_ref = table_update_in_place(
        tm.synapse_cell, tm.synapse_perm, tm.synapse_act, pun_word, cols,
        bits, D, K, pun, thr, at)
    c_ref = pas.synapse_activation_conn_ref(tm.synapse_cell, tm.synapse_perm,
                                            cols, bits, D, thr, K)
    c_k = kernels.act_conn_cuda(tm.synapse_cell, tm.synapse_perm, cols, bits,
                                D, thr, K)
    a_ref = pas.synapse_activation_ref(tm.synapse_cell, cols, bits, C, D)
    a_k = kernels.synapse_activation_cuda(tm.synapse_cell, cols, bits, C, D)
    s_ref = psv.serving_activation_ref(tab.rows, cols, bits, C, D)
    s_k = kernels.serving_activation_cuda(tab.rows, cols, bits, C, D)
    torch.cuda.synchronize()
    require(torch.equal(c_k, c_ref) and torch.equal(c_ref, tm.synapse_act),
            "act_conn == plain == the state's activity at 16K")
    require(torch.equal(a_k, a_ref), "synapse_activation == plain at 16K")
    require(torch.equal(s_k, s_ref) and bool((s_ref > 0).any()),
            "serving_activation == plain on the learned 16K serving table")
    punished = int((p_ref != tm.synapse_perm).sum())
    p = tm.synapse_perm.clone()
    act_k, act_p = fresh(tm.synapse_act), fresh(tm.synapse_act)
    rows = {
        "table_update": kernel_row(
            "table_update", lambda: kernels.table_update_cuda(
                tm.synapse_cell, p, act_k(), pun_word, cols, bits, D, K, pun,
                thr),
            lambda: pas.table_update_ref(tm.synapse_cell, p, act_p(),
                                         pun_word, cols, bits, D, K, pun,
                                         thr),
            nbytes(tm.synapse_cell, tm.synapse_perm, tm.synapse_act,
                   pun_word, cols, bits, v_ref)
            + 4 * punished, at, grid=table_grid(True, tm.synapse_cell, D)),
        "act_conn": kernel_row(
            "act_conn", lambda: kernels.act_conn_cuda(
                tm.synapse_cell, tm.synapse_perm, cols, bits, D, thr, K),
            lambda: pas.synapse_activation_conn_ref(
                tm.synapse_cell, tm.synapse_perm, cols, bits, D, thr, K),
            nbytes(tm.synapse_cell, tm.synapse_perm, cols, bits, c_ref), at,
            grid=table_grid(False, tm.synapse_cell, D)),
        "synapse_activation": kernel_row(
            "synapse_activation", lambda: kernels.synapse_activation_cuda(
                tm.synapse_cell, cols, bits, C, D),
            lambda: pas.synapse_activation_ref(tm.synapse_cell, cols, bits,
                                               C, D),
            nbytes(tm.synapse_cell, cols, bits, a_ref), at,
            grid=word_grid(False, tm.synapse_cell, C, D)),
        "serving_activation": kernel_row(
            "serving_activation", lambda: kernels.serving_activation_cuda(
                tab.rows, cols, bits, C, D),
            lambda: psv.serving_activation_ref(tab.rows, cols, bits, C, D),
            nbytes(tab.rows, cols, bits, s_ref),
            f"B={B} R={tab.rows.shape[1]} rows of 128 D={D} A={A}, the "
            f"learned 16K serving table",
            grid=word_grid(True, tab.rows, C, D)),
    }
    rows["serving_counts"] = learned_table_row(
        cfg.tm, tm, tab, "the learned 16K serving table")
    perf["peak_memory_gib"] = torch.cuda.max_memory_allocated() / 2**30
    del p, p_ref, v_ref, c_ref, c_k, a_ref, a_k, pun_word, act_k, act_p
    del tab, s_ref, s_k

    # where a learning step's time goes: phases and a device profile of
    # PROFILED_STEPS more steps, under the caps in force
    caps = {} if esc is not None else TUNED_16K
    snap = Snapshot(dataclasses.replace(
        cfg, tm=dataclasses.replace(cfg.tm, **caps)), state, gen,
        serve_xs[:PROFILED_STEPS])
    # the learned streams the parallel phase continues from
    learned = (host_leaves(state, slice(0, PAR_16K_BATCH)), caps)
    # and the whole learned state, which `run_soaks` carries on
    carry_gen = torch.Generator(device=dev)
    carry_gen.set_state(gen.get_state())
    carry = (copy.deepcopy(state), carry_gen, cfg, T + INFER_16K)
    del state, tm
    time_phases(snap, snap.xs)
    print("16K metrics: " + json.dumps(perf))
    print("16K kernels: " + json.dumps(rows))
    return launches, rows, learned, {
        "learning": perf["graph_vs_loop"],
        "escalation": perf["graph_vs_loop_escalation"]}, carry


# ---- the parallel phase: `bithtm_tpu_torch.parallel` over worker
# processes on the one card (gloo all_reduce on CUDA tensors; NCCL
# refuses two ranks on one device), then NCCL in this process

# (a) the model axis at 16K x 64: the first PAR_16K_BATCH learned streams
# on a 1 x 2 mesh (8,192 columns a rank), PAR_16K_LEARN learning then
# PAR_16K_SERVE serving steps; (b) the data axis at the bench
# configuration: the main path's state on a 2 x 1 mesh (128 streams a
# rank), PAR_BENCH_LEARN learning steps; (c) NCCL, one rank
PAR_16K_BATCH, PAR_16K_LEARN, PAR_16K_SERVE = 16, 16, 8
PAR_BENCH_LEARN = 32
PAR_NCCL_BATCH, PAR_NCCL_LEARN, PAR_NCCL_SERVE = 4, 4, 2
PAR_SEED = 909           # the draw generator every rank and the reference seed
PAR_TIMEOUT = 300        # seconds a worker group, and a collective, may take
PAR_EXCHANGE_REPS = 10   # timed replays of a step's collectives


def host_leaves(state, rows=slice(None)) -> dict:
    """``state``'s leaves (`mesh.state_leaves`) at the streams ``rows``,
    as host copies."""
    return {k: t[rows].to("cpu", copy=True)
            for k, t in pmesh.state_leaves(state).items()}


def state_on(leaves: dict, dev):
    """The state of a `mesh.state_leaves` dict, as copies on ``dev``."""
    return pmesh.state_from_leaves({k: t.to(dev, copy=True)
                                    for k, t in leaves.items()})


def bit_differing_leaves(a: dict, b: dict) -> list[str]:
    """The leaves of two leaf dicts that differ in any bit (-0.0 is not
    0.0 here, as it is to `torch.equal`)."""
    def raw(t):
        return t.contiguous().view(-1).view(torch.uint8)
    return [k for k in a if a[k].shape != b[k].shape
            or not torch.equal(raw(a[k]), raw(b[k]))]


def par_config(job: dict):
    cfg = bt.make_htm_config(**job["config"])
    return dataclasses.replace(
        cfg, tm=dataclasses.replace(cfg.tm, **job["caps"]))


def par_run(cfg, state, xs, n_learn: int, learn_step, serve_step,
            timed: bool = False):
    """``n_learn`` learning steps, then serving steps over the rest of
    ``xs``: (state, host metrics a step, host ms a step (synchronized)
    when ``timed``, launch counts of the learning and the serving
    steps)."""
    metrics, ms, counts = [], [], []
    kernels.reset_launch_counts()
    for t, x in enumerate(xs):
        if t == n_learn:
            counts.append(kernels.launch_counts())
            kernels.reset_launch_counts()
        if timed:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        state, m = (learn_step if t < n_learn else serve_step)(state, x)
        if timed:
            torch.cuda.synchronize()
            ms.append(1e3 * (time.perf_counter() - t0))
        metrics.append({k: v.cpu() for k, v in m.items()})
    counts.append(kernels.launch_counts())
    return state, metrics, ms, counts


def single_steps(cfg, B: int, dev, shard=None):
    """The learning and serving steps of one process with the draws the
    ranks make (the global batch from a generator seeded PAR_SEED);
    ``shard``: through a column shard."""
    draws = bt.TorchDraws(cfg.tm, B, dev,
                          torch.Generator(device=dev).manual_seed(PAR_SEED))

    def learn(st, x):
        st, out = bt.htm_step(cfg, st, x, True, draws=draws,
                              dense_outputs=False, shard=shard)
        return st, out.metrics

    def serve(st, x):
        st, out = bt.htm_step(cfg, st, x, False, False, draws=draws,
                              dense_outputs=False, shard=shard)
        return st, out.metrics

    return learn, serve


def draws_ms(cfg, B: int, dev) -> float:
    """CUDA-event ms of one learning step's draws for B streams."""
    draws = bt.TorchDraws(cfg.tm, B, dev,
                          torch.Generator(device=dev).manual_seed(PAR_SEED))
    return cuda_ms(draws.step)


def exchange_ms(traffic: dict, steps: int, group, dev) -> float:
    """Device-synchronized ms a step of the collectives ``steps`` steps
    made (``traffic``: bytes -> calls), replayed as all_reduces of those
    sizes after a warm-up."""
    bufs = [torch.zeros(n, dtype=torch.uint8, device=dev)
            for n, c in traffic.items() for _ in range(c // steps)]
    for b in bufs:
        torch.distributed.all_reduce(b, group=group)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(PAR_EXCHANGE_REPS):
        for b in bufs:
            torch.distributed.all_reduce(b, group=group)
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / PAR_EXCHANGE_REPS


def parallel_worker(job_path: str, rank: str, port: str) -> None:
    """One rank of a parallel job (`run_parallel`): joins a gloo group on
    the card, takes its shard of the job's state, steps it with the
    `parallel.mesh` steps, times its steps and its exchange, and saves
    its final shard and metrics."""
    from bithtm_tpu_torch.parallel import distributed as pdist

    with open(job_path) as f:
        job = json.load(f)
    rank = int(rank)
    n_data, n_model = job["mesh"]
    dev = torch.device(job["device"])
    pdist.initialize(f"localhost:{port}", n_data * n_model, rank,
                     backend="gloo", timeout=PAR_TIMEOUT)
    mesh = pmesh.make_mesh(n_data, n_model, device=dev)
    cfg = par_config(job)
    full = pmesh.state_from_leaves(torch.load(job["state"], mmap=True,
                                              weights_only=True))
    B = full.batch
    state = pmesh.shard_batched_state(full, mesh)
    del full
    n_learn = job["learn"]
    xs = bench_inputs(cfg, B, n_learn + job["serve"], dev)[
        :, pdist.local_data_slice(B, mesh)]
    draws = bt.TorchDraws(cfg.tm, B, dev,
                          torch.Generator(device=dev).manual_seed(PAR_SEED))
    shard = mesh.column_shard(cfg.tm.column_dim)
    if shard is not None:  # gloo's first CUDA collectives are slow
        warm = torch.zeros(1 << 20, dtype=torch.uint8, device=dev)
        for _ in range(3):
            torch.distributed.all_reduce(warm, group=shard.group)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    steps = (pmesh.sharded_step(cfg, mesh, True, draws),
             pmesh.sharded_serve_step(cfg, mesh))
    summary = {"rank": rank, "mesh": [mesh.data_index, mesh.model_index],
               "streams": xs.shape[1]}
    metrics = []
    for phase, part, n in (("learn", xs[:n_learn], n_learn),
                           ("serve", xs[n_learn:], 0)):
        state, m, ms, counts = par_run(cfg, state, part, n, *steps,
                                       timed=True)
        traffic = dict(shard.traffic) if shard is not None else {}
        if shard is not None:
            shard.traffic.clear()
        metrics += m
        summary.update({
            f"{phase}_ms": ms, f"{phase}_launches": counts[-1],
            f"{phase}_exchange_bytes_per_step":
                sum(k * c for k, c in traffic.items()) / max(len(part), 1),
            f"{phase}_collectives_per_step":
                sum(traffic.values()) / max(len(part), 1),
            f"{phase}_exchange_ms_per_step":
                exchange_ms(traffic, len(part), shard.group, dev)
                if traffic else 0.0})
    summary["peak_memory_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
    torch.save({"state": host_leaves(state), "metrics": metrics},
               os.path.join(job["out"], f"rank{rank}.pt"))
    print("PARALLEL_RANK " + json.dumps(summary), flush=True)
    torch.distributed.destroy_process_group()


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def spawn_ranks(job: dict, tmp: str) -> list[dict]:
    """Runs the ranks of ``job`` as worker processes of this script (the
    kernels are built already, so none runs nvcc; `testing.run_ranks`:
    all are killed if one fails or the group outlasts PAR_TIMEOUT).
    Returns each rank's summary and final shard."""
    n = job["mesh"][0] * job["mesh"][1]
    path = os.path.join(tmp, f"{job['name']}.json")
    with open(path, "w") as f:
        json.dump(job, f)
    port = free_port()
    logs = os.path.join(tmp, job["name"])
    os.makedirs(logs, exist_ok=True)
    rcs, outs = testing.run_ranks(
        [[sys.executable, os.path.abspath(__file__), "--parallel-worker",
          path, str(r), str(port)] for r in range(n)], logs, PAR_TIMEOUT,
        cwd=REPO)
    if any(rcs):
        for r, out in enumerate(outs):
            print(f"--- {job['name']} rank {r} (rc {rcs[r]}):\n{out[-3000:]}")
        raise RuntimeError(f"check failed: the {job['name']} ranks exited "
                           f"with {rcs}")
    ranks = []
    for r, out in enumerate(outs):
        line = [ln for ln in out.splitlines()
                if ln.startswith("PARALLEL_RANK ")]
        require(len(line) == 1, f"{job['name']} rank {r} reported")
        got = torch.load(os.path.join(job["out"], f"rank{r}.pt"),
                         weights_only=True)
        ranks.append({**json.loads(line[0].split(" ", 1)[1]), **got})
    return ranks


def check_parallel_run(what: str, job: dict, ranks: list[dict],
                       ref_leaves: dict, ref_metrics: list[dict]) -> None:
    """Every leaf of the gathered shards and every metric of every rank
    equal to the single-process run, bit for bit."""

    n_data, n_model = job["mesh"]
    full = pmesh.assemble_batched_state(
        [pmesh.state_from_leaves(r["state"]) for r in ranks], n_data,
        n_model)
    bad = bit_differing_leaves(host_leaves(full), ref_leaves)
    require(not bad, f"{what}: the gathered shards equal the single-process "
            f"state in every leaf, bit for bit (differ: {bad})")
    for t, ref in enumerate(ref_metrics):
        for k, v in ref.items():
            for m in range(n_model):
                got = torch.cat([ranks[d * n_model + m]["metrics"][t][k]
                                 for d in range(n_data)])
                require(torch.equal(got.view(torch.uint8) if
                                    got.dtype == torch.float32 else got,
                                    v.view(torch.uint8) if
                                    v.dtype == torch.float32 else v),
                        f"{what}: metric {k} of step {t} on model rank {m} "
                        f"== the single-process run's")


def print_ranks(what: str, ranks: list[dict]) -> None:
    for r in ranks:
        learn, serve = r["learn_ms"], r["serve_ms"]
        line = (f"  rank {r['rank']} (data {r['mesh'][0]}, model "
                f"{r['mesh'][1]}, {r['streams']} streams): learning "
                f"{statistics.median(learn[1:]):.3f} ms/step (median of steps "
                f"1-{len(learn) - 1}; step 0 {learn[0]:.3f}), exchange "
                f"{r['learn_exchange_bytes_per_step'] / 1e6:.3f} MB in "
                f"{r['learn_collectives_per_step']:.0f} all_reduce, "
                f"{r['learn_exchange_ms_per_step']:.3f} ms a step")
        if serve:
            line += (f"; serving {statistics.median(serve):.3f} ms/step, "
                     f"exchange {r['serve_exchange_bytes_per_step'] / 1e6:.3f}"
                     f" MB in {r['serve_collectives_per_step']:.0f} "
                     f"all_reduce, {r['serve_exchange_ms_per_step']:.3f} ms "
                     f"a step")
        line += (f"; launches learning {r['learn_launches']}, serving "
                 f"{r['serve_launches']}; peak memory "
                 f"{r['peak_memory_gib']:.2f} GiB")
        print(line)


def shard_table_rows(dev, leaves: dict, cfg) -> dict:
    """`table_update` and `act_conn` on model rank 0's column shard of the
    learned 16K streams (the first C/2 rows, ``column_dim`` C): bit-equal
    to their plain versions and to the whole-table result's rows, with
    the times and bound of `kernel_row`."""
    C, D, K = cfg.tm.column_dim, cfg.tm.cell_dim, cfg.tm.synapse_capacity
    half = C // 2
    thr, pun = cfg.tm.permanence_threshold, cfg.tm.permanence_punishment
    syn = leaves["tm.synapse_cell"].to(dev)
    perm = leaves["tm.synapse_perm"].to(dev)
    act = leaves["tm.synapse_act"].to(dev)
    cols = leaves["tm.active_cols"].to(dev)
    bits = leaves["tm.active_bits"].to(dev)
    pun_word = torch.where(pas.column_mask_from_cols(cols, C), 0,
                           leaves["tm.matching_word"].to(dev))
    p_full = perm.clone()
    v_full = kernels.table_update_cuda(syn, p_full, act.clone(), pun_word,
                                       cols, bits, D, K, pun, thr)
    c_full = kernels.act_conn_cuda(syn, perm, cols, bits, D, thr, K)
    s_syn, s_perm, s_act = (t[:, :half].contiguous() for t in (syn, perm,
                                                               act))
    s_pun = pun_word[:, :half].contiguous()
    B = syn.shape[0]
    at = (f"B={B}, a column shard of {half} rows over column_dim={C}, D={D}, "
          f"K={K}, the learned 16K streams")
    v_ref, p_ref = table_update_in_place(s_syn, s_perm, s_act, s_pun, cols,
                                         bits, D, K, pun, thr, at,
                                         column_dim=C)
    c_ref = pas.synapse_activation_conn_ref(s_syn, s_perm, cols, bits, D, thr,
                                            K, column_dim=C)
    c_k = kernels.act_conn_cuda(s_syn, s_perm, cols, bits, D, thr, K,
                                column_dim=C)
    torch.cuda.synchronize()
    other = s_syn >= half * D
    require(bool((other & (v_ref > 0)).any()),
            "the shard's synapses reach active cells of the other shard")
    require(torch.equal(v_ref, v_full[:, :half]) and torch.equal(
        p_ref.view(torch.int32), p_full[:, :half].contiguous().view(
            torch.int32)), "table_update on a column shard == the whole "
            "table's rows")
    require(torch.equal(c_k, c_ref) and torch.equal(c_k, c_full[:, :half]),
            "act_conn on a column shard == plain == the whole table's rows")
    punished = int((p_ref != s_perm).sum())
    p = s_perm.clone()
    act_k, act_p = fresh(s_act), fresh(s_act)
    rows = {
        "table_update": kernel_row(
            "table_update (column shard)", lambda: kernels.table_update_cuda(
                s_syn, p, act_k(), s_pun, cols, bits, D, K, pun, thr,
                column_dim=C),
            lambda: pas.table_update_ref(s_syn, p, act_p(), s_pun, cols,
                                         bits, D, K, pun, thr, column_dim=C),
            nbytes(s_syn, s_perm, s_act, s_pun, cols, bits, v_ref)
            + 4 * punished, at, grid=table_grid(True, syn, D)),
        "act_conn": kernel_row(
            "act_conn (column shard)", lambda: kernels.act_conn_cuda(
                s_syn, s_perm, cols, bits, D, thr, K, column_dim=C),
            lambda: pas.synapse_activation_conn_ref(
                s_syn, s_perm, cols, bits, D, thr, K, column_dim=C),
            nbytes(s_syn, s_perm, cols, bits, c_ref), at,
            grid=table_grid(False, syn, D)),
    }
    return rows


def check_nccl(dev, leaves: dict, cfg) -> None:
    """(c) NCCL in this process: a 1 x 1 mesh (`initialize` picks NCCL for
    a card) runs `sharded_step` / `sharded_serve_step`, and the same state
    runs the column-shard step with a one-rank shard, whose every
    exchange goes through NCCL; both equal the unsharded steps, bit for
    bit, in every leaf and metric."""
    from bithtm_tpu_torch.ops.shard import ColumnShard
    from bithtm_tpu_torch.parallel import distributed as pdist

    B, L, S = PAR_NCCL_BATCH, PAR_NCCL_LEARN, PAR_NCCL_SERVE
    sub = {k: v[:B] for k, v in leaves.items()}
    xs = bench_inputs(cfg, B, L + S, dev)
    st, ref_m, _, _ = par_run(cfg, state_on(sub, dev), xs, L,
                              *single_steps(cfg, B, dev))
    ref = host_leaves(st)
    del st
    pdist.initialize(f"localhost:{free_port()}", 1, 0, device=dev,
                     timeout=PAR_TIMEOUT)
    try:
        backend = torch.distributed.get_backend()
        require(backend == "nccl", f"initialize picks NCCL on a card, got "
                f"{backend}")
        mesh = pmesh.make_mesh(1, 1, device=dev)
        draws = bt.TorchDraws(cfg.tm, B, dev, torch.Generator(
            device=dev).manual_seed(PAR_SEED))
        shard = ColumnShard(torch.distributed.group.WORLD, 0, 1,
                            cfg.tm.column_dim)
        runs = {
            "the 1 x 1 mesh": (
                pmesh.shard_batched_state(pmesh.state_from_leaves(sub),
                                          mesh),
                pmesh.sharded_step(cfg, mesh, True, draws),
                pmesh.sharded_serve_step(cfg, mesh)),
            "the one-rank column shard": (state_on(sub, dev),
                                          *single_steps(cfg, B, dev, shard)),
        }
        for what, (st, learn, serve) in runs.items():
            st, m, _, _ = par_run(cfg, st, xs, L, learn, serve)
            bad = bit_differing_leaves(host_leaves(st), ref)
            require(not bad and all(torch.equal(a[k], b[k])
                                    for a, b in zip(m, ref_m) for k in b),
                    f"{what} under NCCL == the unsharded steps ({bad})")
        calls = sum(shard.traffic.values())
        require(calls > 0, "the one-rank shard's exchanges ran through NCCL")
        print(f"(c) NCCL, one rank on {torch.cuda.get_device_name(0)}: a 1 x "
              f"1 mesh and a one-rank column shard ({calls} NCCL all_reduce "
              f"in {L + S} steps), {L} learning + {S} serving steps of "
              f"{B} learned 16K streams, each == the unsharded steps in "
              f"every leaf and metric")
    finally:
        torch.distributed.destroy_process_group()


def run_parallel(dev, learned16, bench_path: str, tmp: str) -> dict:
    """`bithtm_tpu_torch.parallel` on the card, each sharded run against
    the single-process run of the same steps with the same draws (the
    global batch from a generator seeded PAR_SEED):

    (a) the model axis at full width: 16K x 64 (A=328, fast stack, the
        16K run's caps) on a 1 x 2 mesh, 8,192 columns a rank, from the
        first PAR_16K_BATCH streams of the learned 16K state, so that
        growth, punishment and eviction run: PAR_16K_LEARN learning and
        PAR_16K_SERVE serving steps over two worker processes sharing the
        card under gloo; `table_update` once a learning step,
        `small_table_take` once a learning step and `act_conn` once a
        serving step on each rank; every leaf of the gathered shards and
        every metric equal, bit for bit; each rank's ms/step, its
        exchange's bytes and ms a step and its peak memory. Beside it,
        `table_update` and `act_conn` on a column shard of that state
        (`shard_table_rows`);
    (b) the data axis at the bench configuration: the main path's state
        (B=256) on a 2 x 1 mesh, 128 streams a rank, PAR_BENCH_LEARN
        learning steps, equal bit for bit, with no exchange in a step;
    (c) NCCL in this process (`check_nccl`).

    Returns the shard rows of the two table kernels."""
    leaves16, caps = learned16
    print(f"parallel phase on {gpu_line(dev)}: ranks are worker processes "
          f"on this one card under gloo (all_reduce on CUDA tensors)")
    cfg16 = dataclasses.replace(bt.make_htm_config(**GEOM_16K), tm=dataclasses
                                .replace(bt.make_htm_config(**GEOM_16K).tm,
                                         **caps))
    rows = shard_table_rows(dev, leaves16, cfg16)
    path16 = os.path.join(tmp, "state16.pt")
    torch.save(leaves16, path16)
    for what, job, ref_state in (
            ("(a) 16K x 64, 1 x 2 model mesh",
             dict(name="model16k", mesh=[1, 2], config=GEOM_16K, caps=caps,
                  state=path16, learn=PAR_16K_LEARN, serve=PAR_16K_SERVE),
             lambda: state_on(leaves16, dev)),
            ("(b) bench configuration, 2 x 1 data mesh",
             dict(name="databench", mesh=[2, 1], config=BENCH, caps={},
                  state=bench_path, learn=PAR_BENCH_LEARN, serve=0),
             lambda: state_on(torch.load(bench_path, mmap=True,
                                         weights_only=True), dev))):
        job.update(out=tmp, device=str(dev))
        cfg = par_config(job)
        st = ref_state()
        B = st.batch
        xs = bench_inputs(cfg, B, job["learn"] + job["serve"], dev)
        st, ref_m, ref_ms, ref_counts = par_run(
            cfg, st, xs, job["learn"], *single_steps(cfg, B, dev),
            timed=True)
        ref = host_leaves(st)
        del st
        torch.cuda.empty_cache()
        summed = {k: int(sum(int(m[k].sum()) for m in ref_m[:job["learn"]]))
                  for k in ("tm_grown_synapses", "tm_punished_segments",
                            "tm_evicted_segments", "tm_new_segments")}
        t0 = time.perf_counter()
        ranks = spawn_ranks(job, tmp)
        group_s = time.perf_counter() - t0
        check_parallel_run(what, job, ranks, ref, ref_m)
        n_model = job["mesh"][1]
        # a column shard's SP writes back its own rows without `sp_rows`
        # and selects its columns with the torch chain, without `sp_select`
        whole = {} if n_model == 1 else {"sp_rows": 0, "sp_select": 0}
        want = dict(ref_counts[0], **whole)
        for r in ranks:
            require(r["learn_launches"] == want,
                    f"{what}: rank {r['rank']} launches each kernel as the "
                    f"unsharded step does while learning, `sp_rows` and "
                    f"`sp_select` only where the SP is whole "
                    f"({r['learn_launches']} vs {want})")
            if job["serve"]:
                require(r["serve_launches"] == dict(
                    steps(act_conn=job["serve"]), **whole),
                        f"{what}: rank {r['rank']} launches act_conn, "
                        f"sp_overlap, seg_counts, column_decide and, where "
                        f"the SP is whole, sp_select once a serving step "
                        f"and nothing else")
            if n_model == 1:
                require(r["learn_collectives_per_step"] == 0,
                        f"{what}: no exchange during a data-parallel step")
        if n_model > 1:
            require(ref_counts[0] == steps(table_update=job["learn"],
                                           small_table_take=job["learn"]),
                    f"{what}: table_update and small_table_take once a "
                    f"learning step, got {ref_counts[0]}")
            require(summed["tm_grown_synapses"] > 0
                    and summed["tm_punished_segments"] > 0,
                    f"{what}: growth and punishment ran ({summed})")
        print(f"{what}: {job['learn']} learning + {job['serve']} serving "
              f"steps of {B} streams; the gathered shards == the single-"
              f"process run in every leaf and every metric of every rank, "
              f"bit for bit; the single process (all {B} streams, all "
              f"columns) learning "
              f"{statistics.median(ref_ms[1:job['learn']]):.3f} ms/step"
              + (f", serving {statistics.median(ref_ms[job['learn']:]):.3f}"
                 f" ms/step" if job["serve"] else "")
              + f" (medians, step 0 apart); the worker group "
              f"{group_s:.1f} s from spawn to exit; over the learning steps "
              f"{summed}")
        print_ranks(what, ranks)
        if n_model == 1:
            # a data rank draws the whole batch and keeps its rows
            own = B // job["mesh"][0]
            print(f"{what}: the draws of a learning step take "
                  f"{draws_ms(cfg, B, dev):.4f} ms for the global batch of "
                  f"{B} streams that each rank draws, "
                  f"{draws_ms(cfg, own, dev):.4f} ms for a rank's own {own}")
        print(f"{what} ranks: " + json.dumps(
            [{k: v for k, v in r.items() if k not in ("state", "metrics")}
             for r in ranks]))
        del ranks, ref
    check_nccl(dev, leaves16, cfg16)
    return rows


def table_kernel_rows(dev, C: int, D: int, G: int, K: int, A: int,
                      batches, what: str) -> dict:
    """`table_update` and `act_conn` against their plain versions at
    ``what``'s table (C columns of G*K slots over C*D cells, A active
    columns) at each batch of ``batches``: bit-equal, with the times and
    bound of `kernel_row` and the grid each launched."""
    thr, pun = 0.5, 0.01
    rows = {}
    for B in batches:
        x = table_inputs(B + 48, B, C, G, K, D, A, device=dev)
        syn, act_prev, pun_word = x["syn"], x["act_prev"], x["pun_word"]
        cols, bits, perm = x["cols"], x["bits"], x["perm"]
        at = f"B={B} C={C} G={G} K={K} D={D} A={A}, {what}"
        v_ref, p_ref = table_update_in_place(syn, perm, act_prev, pun_word,
                                             cols, bits, D, K, pun, thr, at)
        c_ref = pas.synapse_activation_conn_ref(syn, perm, cols, bits, D,
                                                thr, K)
        c_k = kernels.act_conn_cuda(syn, perm, cols, bits, D, thr, K)
        torch.cuda.synchronize()
        require(bool((v_ref > 1).any()) and bool((p_ref != perm).any()),
                f"the inputs of {what} at B={B} exercise connected and "
                f"punished slots")
        require(torch.equal(c_k, c_ref), f"act_conn == plain at {what}, B={B}")
        punished = int((p_ref != perm).sum())
        p = perm.clone()
        act_k, act_p = fresh(act_prev), fresh(act_prev)
        rows[f"table_update B={B}"] = kernel_row(
            "table_update",
            lambda: kernels.table_update_cuda(syn, p, act_k(), pun_word,
                                              cols, bits, D, K, pun, thr),
            lambda: pas.table_update_ref(syn, p, act_p(), pun_word, cols,
                                         bits, D, K, pun, thr),
            nbytes(syn, perm, act_prev, pun_word, cols, bits, v_ref)
            + 4 * punished, at, grid=table_grid(True, syn, D))
        if B == 1:
            # the single-stream step's launch, without host issue between
            # calls: inside a CUDA graph of 20, each call on its own copy
            # of act_prev, restored before each replay (`fresh_ms`)
            acts = [act_prev.clone() for _ in range(20)]
            rows[f"table_update B={B}"]["graph_ms"] = fresh_ms(
                [lambda a=a: kernels.table_update_cuda(
                    syn, p, a, pun_word, cols, bits, D, K, pun, thr)
                 for a in acts],
                lambda: [a.copy_(act_prev) for a in acts], graph=True)
            del acts
            print(f"kernel table_update at B=1 inside a CUDA graph of 20 "
                  f"calls: {rows[f'table_update B={B}']['graph_ms']:.4f} ms "
                  f"a call")
        rows[f"act_conn B={B}"] = kernel_row(
            "act_conn",
            lambda: kernels.act_conn_cuda(syn, perm, cols, bits, D, thr, K),
            lambda: pas.synapse_activation_conn_ref(syn, perm, cols, bits, D,
                                                    thr, K),
            nbytes(syn, perm, cols, bits, c_ref), at,
            grid=table_grid(False, syn, D))
        del x, syn, act_prev, pun_word, cols, bits, perm, p, p_ref
        del v_ref, c_ref, c_k, act_k, act_p
    print(f"{what} kernels: " + json.dumps(rows))
    return rows


def check_reference_kernels(dev) -> dict:
    """The two table kernels at the reference stack's table (G=8, K=48,
    J=384, the `act_scale(48)` u8 packing; C=2048, D=32, A=41) at B=1,
    the single-stream API's batch, and B=256."""
    return table_kernel_rows(dev, 2048, 32, 8, 48, 41, (1, BATCH),
                             "the reference stack")


def check_anomaly_kernels(dev) -> dict:
    """The two table kernels at the anomaly configuration's table (512
    columns x 8 cells, G=8, K=48, A=16) at B=256: D=8 takes the bitmap
    build's per-cell branch (`active_bitmap.cuh`), which the bench and
    16K shapes do not."""
    C, D, A = ANOMALY_WIDTH
    return table_kernel_rows(dev, C, D, 8, 48, A, (ANOMALY_BATCH,),
                             "the anomaly stack")


# ---- the kernels' paths past the first design's limits (ROADMAP fault
# q): each shape launches the same hand-written kernel on another path,
# chosen from the shapes, held bit-equal to the plain version and timed

PATH_KS = (126, 127, 128)      # bf16, bf16 and float32 packed activity
COUNT_KS = (125, 126, 127, 128)  # seg_counts: u8, bf16, bf16, float32
FLAG_DS = (8, 33, 48, 64)      # the flags form's cells a column (D=8: G=8)
PATH_KS_AT = (64, 2048, 32, 2, 41)   # B, C, D, G, A of those tables
GLOBAL_CS = (32_768, 29_057)   # 2,097,152 cells; one column past the limit
GLOBAL_AT = (4, 64, 4, 64)     # B, D, G, K of the global-bitmap tables
WIDE_B = 65_536                # streams past the grid's y extent
GMEM_SP = (2, 64, 59_392)      # B, C, I_pad: 4 * I_pad > 232,448 bytes


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal dtype, shape and bits."""
    return (a.dtype == b.dtype and a.shape == b.shape
            and torch.equal(a.contiguous().view(torch.uint8),
                            b.contiguous().view(torch.uint8)))


def path_row(kernel: kernels.CudaKernel, want: tuple, fn, plain, moved: int,
             at: str) -> dict:
    """`kernel_row` of a call on a path past the first design's limits:
    the wrapper must report ``want``."""
    require(kernel.path == want, f"{kernel.name} at {at} takes the path "
            f"{want}, got {kernel.path}")
    row = kernel_row(f"{kernel.name} [{'+'.join(want)}]", fn, plain, moved,
                     at)
    row["path"] = list(want)
    return row


def check_table_paths(dev, B, C, D, G, K, A, what, column_rows=None):
    """`table_update` and `act_conn` (and, on a whole table, the word
    kernels) at one table, against their plain versions, bit for bit.
    ``column_rows``: the table is a column shard of its first rows over
    all C columns (`table_update` only). Returns the rows by kernel."""
    thr, pun = 0.5, 0.01
    x = table_inputs(C + K, B, C, G, K, D, A, device=dev)
    cols, bits = x["cols"], x["bits"]
    R = C if column_rows is None else column_rows
    syn, perm = x["syn"][:, :R].contiguous(), x["perm"][:, :R].contiguous()
    act_prev = x["act_prev"][:, :R].contiguous()
    pun_word = x["pun_word"][:, :R].contiguous()
    shard = {} if column_rows is None else {"column_dim": C}
    bitmap = "smem" if C * D <= kernels.MAX_BITMAP_CELLS else "global"
    act = {torch.uint8: "u8", torch.bfloat16: "bf16",
           torch.float32: "f32"}[pas.act_dtype(K)]
    at = (f"B={B} C={C} G={G} K={K} D={D} A={A}" if column_rows is None
          else f"B={B}, rows {R} of C={C}, G={G} K={K} D={D} A={A}")
    v_ref, p_ref = table_update_in_place(syn, perm, act_prev, pun_word, cols,
                                         bits, D, K, pun, thr, what, **shard)
    require(bool((v_ref > 1).any()) and bool((p_ref != perm).any()),
            f"the inputs at {what} exercise connected and punished slots")
    punished = int((p_ref != perm).sum())
    want = (bitmap, act)
    p = perm.clone()
    act_k, act_p = fresh(act_prev), fresh(act_prev)
    rows = {"table_update": path_row(
        kernels.TABLE_UPDATE, want,
        lambda: kernels.table_update_cuda(syn, p, act_k(), pun_word, cols,
                                          bits, D, K, pun, thr, **shard),
        lambda: pas.table_update_ref(syn, p, act_p(), pun_word, cols, bits,
                                     D, K, pun, thr, **shard),
        nbytes(syn, perm, act_prev, pun_word, cols, bits, v_ref)
        + 4 * punished, at)}
    del p, p_ref, v_ref, act_k, act_p
    if column_rows is not None:
        return rows
    c_ref = pas.synapse_activation_conn_ref(syn, perm, cols, bits, D, thr, K)
    c_k = kernels.act_conn_cuda(syn, perm, cols, bits, D, thr, K)
    word = pas.pack_frozen_table(syn, perm, thr)
    f_ref = pas.synapse_activation_frozen_ref(word, cols, bits, D, K)
    f_k = kernels.act_frozen_cuda(word, cols, bits, D, K)
    torch.cuda.synchronize()
    require(same_bits(c_k, c_ref), f"act_conn == plain at {what}")
    require(same_bits(f_k, f_ref) and same_bits(f_ref, c_ref),
            f"act_frozen == plain == act_conn at {what}")
    rows["act_conn"] = path_row(
        kernels.ACT_CONN, want,
        lambda: kernels.act_conn_cuda(syn, perm, cols, bits, D, thr, K),
        lambda: pas.synapse_activation_conn_ref(syn, perm, cols, bits, D,
                                                thr, K),
        nbytes(syn, perm, cols, bits, c_ref), at)
    rows["act_frozen"] = path_row(
        kernels.ACT_FROZEN, (*want, "grid_y"),
        lambda: kernels.act_frozen_cuda(word, cols, bits, D, K),
        lambda: pas.synapse_activation_frozen_ref(word, cols, bits, D, K),
        nbytes(word, cols, bits, f_ref), at)
    del c_ref, c_k, f_ref, f_k, word
    if bitmap == "smem":
        return rows
    a_ref = pas.synapse_activation_ref(syn, cols, bits, C, D)
    a_k = kernels.synapse_activation_cuda(syn, cols, bits, C, D)
    srows = serving_rows(C, B, C + 8, C, D, G, device=dev)
    s_ref = psv.serving_activation_ref(srows, cols, bits, C, D)
    s_k = kernels.serving_activation_cuda(srows, cols, bits, C, D)
    torch.cuda.synchronize()
    require(same_bits(a_k, a_ref) and bool(a_ref.any()),
            f"synapse_activation == plain at {what}")
    require(same_bits(s_k, s_ref) and bool(s_ref.any()),
            f"serving_activation == plain at {what}")
    rows["synapse_activation"] = path_row(
        kernels.SYNAPSE_ACTIVATION, ("global",),
        lambda: kernels.synapse_activation_cuda(syn, cols, bits, C, D),
        lambda: pas.synapse_activation_ref(syn, cols, bits, C, D),
        nbytes(syn, cols, bits, a_ref), at)
    rows["serving_activation"] = path_row(
        kernels.SERVING_ACTIVATION, ("global",),
        lambda: kernels.serving_activation_cuda(srows, cols, bits, C, D),
        lambda: psv.serving_activation_ref(srows, cols, bits, C, D),
        nbytes(srows, cols, bits, s_ref),
        f"B={B} R={C + 8} rows of 128 D={D} A={A}")
    return rows


def check_sp_paths(dev, B, C, I_pad, quantized: bool) -> dict:
    """`sp_update_pack` at (B, C, I_pad) against its plain version, bit
    for bit, on random permanences (int16 units or float32), deltas and
    one active column in four a stream."""
    g = torch.Generator(device=dev).manual_seed(B + C + I_pad)
    if quantized:
        perm = torch.randint(-3000, 3000, (B, C, I_pad), generator=g,
                             device=dev, dtype=torch.int16)
        delta = torch.randint(-100, 100, (B, I_pad), generator=g,
                              device=dev, dtype=torch.int32)
        thr = 1000
    else:
        perm = torch.rand((B, C, I_pad), generator=g, device=dev)
        delta = torch.rand((B, I_pad), generator=g, device=dev) * 0.2 - 0.1
        thr = 0.5
    A = max(1, C // 4)
    cols = torch.rand((B, C), generator=g, device=dev).topk(
        A, -1).indices.to(torch.int32)
    p_ref, p_k = perm.clone(), perm.clone()
    _, pack_ref = psp.sp_update_pack_ref(p_ref, delta, cols, thr)
    _, pack_k = kernels.sp_update_pack_cuda(p_k, delta, cols, thr)
    torch.cuda.synchronize()
    dtype = str(perm.dtype).split(".")[1]
    at = f"B={B} C={C} I_pad={I_pad} A={A} {dtype}"
    require(same_bits(p_k, p_ref) and same_bits(pack_k, pack_ref)
            and bool(pack_ref.any()) and not torch.equal(p_ref, perm),
            f"sp_update_pack == plain at {at}, bit for bit")
    want = (kernels._delta(C, I_pad), kernels._streams(B))
    written = B * A * I_pad * perm.element_size()
    p = perm.clone()
    return path_row(kernels.SP_UPDATE_PACK, want,
                    lambda: kernels.sp_update_pack_cuda(p, delta, cols, thr),
                    lambda: psp.sp_update_pack_ref(p, delta, cols, thr),
                    nbytes(perm, delta, cols, pack_ref) + written, at)


def check_paths(dev) -> dict:
    """Every path that the kernels of the first design refused (ROADMAP
    fault q), held bit-equal to the plain versions and timed:
    `table_update`, `act_conn` and `act_frozen` at K = 126, 127 and 128
    (bf16, bf16, float32); the five bitmap kernels with the global bitmap
    at 32,768 x 64 and one column past the limit, B=4; `table_update` on
    a column shard of 32,768 columns; `act_frozen`, `sp_update_pack` and
    `sp_overlap` at B = 65,536 with C=2; `seg_counts` on u8, bf16 and
    float32 activity at K = 125-128, and its flags form there and at D =
    8 (G = 8), 33, 48 and 64; `sp_update_pack` past its shared
    memory (I_pad = 59,392, C=64, B=2). Returns {kernel: {case: row}}."""
    out: dict[str, dict] = {k.name: {} for k in kernels.KERNELS}

    def add(case: str, rows: dict) -> None:
        for name, row in rows.items():
            out[name][case] = row

    B, C, D, G, A = PATH_KS_AT
    for K in PATH_KS:
        add(f"K={K}", check_table_paths(dev, B, C, D, G, K, A, f"K={K}"))
        torch.cuda.empty_cache()
    Bg, D, G, K = GLOBAL_AT
    for C in GLOBAL_CS:
        A = round(0.02 * C)
        add(f"global C={C}", check_table_paths(dev, Bg, C, D, G, K, A,
                                               f"{C}x{D}, global bitmap"))
        torch.cuda.empty_cache()
    C = GLOBAL_CS[0]
    add("column shard", check_table_paths(
        dev, Bg, C, D, G, K, round(0.02 * C), "a column shard",
        column_rows=C // 2))
    # B = 65,536 streams of 2 columns: act_frozen and sp_update_pack fold
    # the streams into grid x
    x = table_inputs(7, WIDE_B, 2, 4, 64, 32, 1, device=dev)
    word = pas.pack_frozen_table(x["syn"], x["perm"], 0.5)
    cols, bits = x["cols"], x["bits"]
    f_ref = pas.synapse_activation_frozen_ref(word, cols, bits, 32, 64)
    f_k = kernels.act_frozen_cuda(word, cols, bits, 32, 64)
    torch.cuda.synchronize()
    require(same_bits(f_k, f_ref) and bool((f_ref > 1).any()),
            f"act_frozen == plain at B={WIDE_B}")
    add("B=65536", {"act_frozen": path_row(
        kernels.ACT_FROZEN, ("smem", "u8", "grid_x_streams"),
        lambda: kernels.act_frozen_cuda(word, cols, bits, 32, 64),
        lambda: pas.synapse_activation_frozen_ref(word, cols, bits, 32, 64),
        nbytes(word, cols, bits, f_ref), f"B={WIDE_B} C=2 G=4 K=64 D=32 A=1"),
        "sp_update_pack": check_sp_paths(dev, WIDE_B, 2, 1024, True),
        "sp_overlap": overlap_row(WIDE_B, 2, BENCH["input_dim"], dev,
                                  ("grid_x_streams",), graph=False)})
    del x, word, cols, bits, f_ref, f_k
    B, C, D, G, _ = PATH_KS_AT
    for K in COUNT_KS:
        add(f"K={K}", {"seg_counts": counts_row(B, C, G, K, dev,
                                                graph=False)})
        add(f"K={K} flags", {"seg_counts": flags_row(B, C, G, K, D, dev,
                                                     graph=False)})
    for D in FLAG_DS:
        add(f"D={D} flags", {"seg_counts": flags_row(
            B, C, 8 if D == 8 else G, 64, D, dev, graph=False)})
    B, C, I_pad = GMEM_SP
    add("gmem delta int16", {"sp_update_pack": check_sp_paths(
        dev, B, C, I_pad, True)})
    add("gmem delta float32", {"sp_update_pack": check_sp_paths(
        dev, B, C, I_pad, False)})
    torch.cuda.empty_cache()
    return {k: v for k, v in out.items() if v}


# ---- the port's verification tools on the card: the config-fuzz
# geometries, full-step oracle parity, the profile by call site, the
# soaks (bithtm_tpu_torch/scripts)

# parity_check's fresh sizes and their steps; the learned bench state's
# streams, learning and inference steps for --from_state
PARITY_SIZES = (("tiny", 80), ("mid", 60), ("bisect", 40))
PARITY_FROM_STATE = (2, 24, 4)
PROFILE_ARGS = ["--fast", "--batch", str(BATCH), "--trace_steps", "16",
                "--warmup_steps", "384"]
PROFILE_16K_ARGS = ["--fast", "--batch", str(BATCH_16K), "--column_dim",
                    "16384", "--cell_dim", "64", "--trace_steps", "16",
                    "--warmup_steps", "256"]
# the kernels a learning step launches in the range `_learn/_grow`, at
# most: `grow_select`, with the index form's `small_table_take` at 16K,
# and one to spare; the range `_learn/learn_rows` launches `learn_rows`
# alone
GROW_RANGE_LAUNCHES = {"bench": 2, "16k": 3}
SOAK_16K_TO = 2048      # the step the learned 16K state is carried on to
SOAK_16K_CHUNK = 256
SOAK_EVICT = ["--steps", "1024", "--batch", "64", "--window", "256"]
SOAK_FAST = ["--batch", str(BATCH), "--chunks", "10"]   # 2,000 steps


def run_fuzz_on_card(dev) -> dict:
    """The 22 config-fuzz geometries (`testing.FUZZ_CASES`, the JAX
    test's list) through `tm_step` at B=2 on the CPU and on the card with
    the same draws (made on the CPU, `DrawsOn`) and the same columns,
    every state leaf and every step's metrics bit-equal; prints each
    case's kernel launches by path (K=126-128 take the bf16 and f32
    activity)."""
    out = {}
    for name, overrides, steps in testing.FUZZ_CASES:
        cfg = testing.fuzz_config(**overrides)
        results = []
        for where in ("cpu", dev):
            gen = torch.Generator().manual_seed(testing.fuzz_seed(name))
            draws = DrawsOn(bt.TorchDraws(cfg, 2, "cpu", gen), where)
            rng = np.random.RandomState(testing.fuzz_seed(name))
            state = bt.tm_init(cfg, 2, where)
            metrics = []
            kernels.reset_launch_counts()
            for _ in range(steps):
                cols = torch.from_numpy(testing.fuzz_cols(cfg, 2, rng))
                state, tm_out = bt.tm_step(cfg, state, draws.step(),
                                           cols.to(where), True)
                metrics.append({k: v.cpu() for k, v in
                                tm_out.metrics.items()})
            results.append((bt.htm_state_to_numpy(bt.HTMState(
                sp=bt.SPState(*[torch.zeros(1)] * 3), tm=state))["tm"],
                metrics, kernels.path_counts()))
            if where == dev:
                # the column decisions on the learned state, for
                # `check_column_decide`
                step_cols = cols.to(dev)
                record_decisions(
                    f"fuzz {name}", cfg, state, step_cols,
                    lambda c, st, learning, winners: bt.tm_step(
                        c, st, draws.step(), step_cols, learning, winners))
        (s_cpu, m_cpu, _), (s_gpu, m_gpu, paths) = results
        diff = [k for k in s_cpu if not np.array_equal(
            s_cpu[k].view(np.uint8), s_gpu[k].view(np.uint8))]
        diff += [k for k in m_cpu[0] if not all(
            torch.equal(a[k], b[k]) for a, b in zip(m_cpu, m_gpu))]
        require(not diff, f"fuzz {name}: the card == the CPU, differing "
                f"{diff}")
        require(paths.get("table_update"), f"fuzz {name}: table_update "
                f"launched on the card")
        act = pas.act_dtype(cfg.synapse_capacity)
        require(str(s_gpu["synapse_act"].dtype) == (
            "float32" if act == torch.bfloat16 else str(act).split(".")[1]),
            f"fuzz {name}: the activity in {act}")
        out[name] = {"steps": steps, "paths": paths}
        print(f"fuzz {name}: {steps} steps at B=2, the card == the CPU in "
              f"every leaf and metric; launches by path {json.dumps(paths)}")
    return out


def run_parity(dev, learned_bench, tmp: str) -> dict:
    """`scripts.parity_check` on the card: each fresh size of
    PARITY_SIZES and ``--sp``, then ``full --from_state`` on the first
    streams of the learned bench state (``learned_bench``: the state and
    its next inputs), learning then inference steps, every decision of
    every step judged."""
    from bithtm_tpu_torch.scripts import parity_check
    from bithtm_tpu_torch.utils import checkpoint

    out = {size: parity_check.run_tm_parity(size, steps, dev)
           for size, steps in PARITY_SIZES}
    out["sp"] = parity_check.run_sp_parity(dev)
    streams, learn, infer = PARITY_FROM_STATE
    state, xs = learned_bench
    path = os.path.join(tmp, "bench_learned")
    checkpoint.save(path, state_on(host_leaves(state, slice(0, streams)),
                                   "cpu"))
    np.save(os.path.join(tmp, "bench_next.npy"),
            xs[:learn + infer, :streams].cpu().numpy())
    kernels.reset_launch_counts()
    out["full_from_state"] = parity_check.main([
        "--size", "full", "--from_state", path, "--inputs",
        os.path.join(tmp, "bench_next.npy"), "--streams", str(streams),
        "--steps", str(learn), "--inference_steps", str(infer)])["tm"]
    launches = kernels.launch_counts()
    require(launches["table_update"] == learn
            and launches["act_conn"] == infer,
            f"the from-state run launches table_update once a learning "
            f"step and act_conn once an inference step, got {launches}")
    got = out["full_from_state"]
    require(got["learning_segments"] > got["new_segments"]
            and got["punished_segments"] > 0 and got["correct"] > 0,
            "the learned state's segments are reinforced and punished, "
            "and predict")
    print("parity on the card: " + json.dumps(
        {k: {f: v[f] for f in ("port_s", "oracle_s") if f in v}
         for k, v in out.items() if isinstance(v, dict)}))
    return out


def run_profile(graph_launches: float) -> dict:
    """`scripts.profile_step` at bench learning (fast stack, B=256) over
    16 loop steps from a state warmed 384 steps: each call site's device
    ms and launches a step, its sum within 10% of the graph's busy a step
    (the script raises otherwise); printed beside the kernel launches a
    step of the main path's graph (``graph_launches``, from
    `run_graph_bench`). Then at 16K x 64 (B=64, tuned caps, warmed 256
    steps). At both, the range `_learn/_grow` launches at most
    GROW_RANGE_LAUNCHES kernels a step, `_learn/learn_rows` one,
    `tm_step.column_decide` one, `column_decide`, `sp_step.update`
    at most one, `sp_rows`, and `sp_step.select` one, `sp_select`.
    Returns the bench profile, the
    16K one under "16k"."""
    from bithtm_tpu_torch.scripts import profile_step

    out = profile_step.main(PROFILE_ARGS)
    print(f"profile: ranges {out['ranges_ms']:.3f} ms a step of the loop's "
          f"{out['loop_busy_ms']:.3f} busy and the graph's "
          f"{out['graph_busy_ms']:.3f}; the graph launches "
          f"{out['graph_launches']:.1f} kernels a step here and "
          f"{graph_launches:.1f} on the main path's learned state")
    torch.cuda.empty_cache()
    out["16k"] = profile_step.main(PROFILE_16K_ARGS)
    torch.cuda.empty_cache()
    for tag, prof in (("bench", out), ("16k", out["16k"])):
        site = "tm_step._learn/_grow"
        n = prof["launches"][site]
        require(n <= GROW_RANGE_LAUNCHES[tag], f"{site} launches {n} "
                f"kernels a {tag} learning step, at most "
                f"{GROW_RANGE_LAUNCHES[tag]}")
        pass_site = "tm_step._learn/learn_rows"
        require(prof["launches"][pass_site] == 1, f"{pass_site} launches "
                f"learn_rows alone, got {prof['launches'][pass_site]}")
        # at most one launch a step: the ranges attribute a kernel by
        # its time, and one of 16 can fall outside (0.9375)
        decide_site = "tm_step.column_decide"
        require(prof["launches"][decide_site] == 1 and all(
            "column_decide_kernel" in op for op, _ in prof["top"][decide_site]),
            f"{decide_site} launches column_decide alone, got "
            f"{prof['launches'][decide_site]}: {prof['top'][decide_site]}")
        sp_site = "sp_step.update"
        require(prof["launches"][sp_site] <= 1 and all(
            "sp_rows_kernel" in op for op, _ in prof["top"][sp_site]),
            f"{sp_site} launches sp_rows alone, got "
            f"{prof['launches'][sp_site]}: {prof['top'][sp_site]}")
        select_site = "sp_step.select"
        require(prof["launches"][select_site] == 1 and all(
            "sp_select_kernel" in op for op, _ in prof["top"][select_site]),
            f"{select_site} launches sp_select alone, got "
            f"{prof['launches'][select_site]}: {prof['top'][select_site]}")
        print(f"profile {tag}: {site} {prof['sites'][site]:.3f} ms and "
              f"{n:.1f} launches a step; {pass_site} "
              f"{prof['sites'][pass_site]:.3f} ms; {decide_site} "
              f"{prof['sites'][decide_site]:.3f} ms; {select_site} "
              f"{prof['sites'][select_site]:.3f} ms")
    return out


def run_soaks(dev, carry16) -> dict:
    """The soaks on the card: the learned 16K state (``carry16``: state,
    generator, config and the step it stands at) carried on to
    SOAK_16K_TO under `htm_scan_autocap` from the tuned caps, with no
    dropped candidate in the banked run; `soak_evict_pressure` at 1,024
    steps x B=64 with zero dropped allocations; `soak_fast_stack` at
    2,000 steps x 256 streams, held to the JAX record."""
    from bithtm_tpu_torch.scripts import (soak_16k_autocap,
                                          soak_evict_pressure,
                                          soak_fast_stack)

    state, gen, cfg, at = carry16
    B = state.batch
    xs = bench_inputs(cfg, B, SOAK_16K_TO, dev)[at:]
    _, soak16 = soak_16k_autocap.run_soak(
        cfg, state, xs, TUNED_16K, SOAK_16K_CHUNK,
        bt.TorchDraws(cfg.tm, B, dev, gen), start_step=at)
    del state, xs
    require(not any(soak16["banked_drops"].values()),
            f"the 16K state carried to step {SOAK_16K_TO} drops no "
            f"candidate in the banked run: {soak16['banked_drops']}")
    print(f"16K carried on from step {at} to {SOAK_16K_TO}: "
          f"escalated_at_step {soak16['escalated_at_step']}, banked drops "
          f"{soak16['banked_drops']}, end to end "
          f"{soak16['end_to_end_ms_per_step']:.3f} ms/step")
    torch.cuda.empty_cache()
    evict = soak_evict_pressure.main(SOAK_EVICT)
    require(all(w["drops"] == 0 for w in evict["windows"]),
            "soak_evict_pressure drops no allocation")
    fast = soak_fast_stack.main(SOAK_FAST)
    return {"16k": soak16, "evict_pressure": evict, "fast_stack": fast}


# the single-stream reference API at the README's defaults (1000 inputs,
# 2048 columns x 32 cells: A=41, G=8, K=48, float32 SP, evict), on
# example.py's input recipe (density 0.2, 5% noise)
REFERENCE = dict(input_dim=1000, column_dim=2048, cell_dim=32)
# B=1 learning through the wrapper: epochs of example.py's 100 patterns
# (a synapse grows at 0.21 and connects at 0.5 after three reinforcements,
# so a pattern is first predicted on its fifth visit), a checkpoint after
# SAVE_EPOCHS of them, then inference steps
B1_EPOCHS, B1_PATTERNS, B1_SAVE_EPOCHS, B1_INFER = 6, 100, 5, 16
# the oracle gate: learning then inference steps on the learned B=1
# state, where segments grow, are reinforced and are punished (from a
# fresh state, 24 learning steps over 6 patterns grew segments and
# reinforced none)
ORACLE_LEARN, ORACLE_INFER = 24, 4
CLI_ARGS = ["--epochs", "1", "--input_patterns", "20", "--batch", "4",
            "--scan", "--quiet"]


def wrapper_vs_loop(learned, gen_state, xs, dev) -> dict:
    """One epoch of `process` through a B=1 reference-API wrapper from
    the learned state and generator state, by the loop (`graph.eager()`)
    and by graph replays (two wrappers built alike): every output,
    `last_metrics` value, the final state and the launches equal; then
    REPEATS epochs of each in turns (the graph wrapper's state restored
    into its buffers) and a profile of PROFILED_STEPS more steps: ms/step,
    device busy, launches a step, busy share."""
    n = len(xs)
    wrappers = {mode: bt.HierarchicalTemporalMemory(**REFERENCE, seed=1,
                                                    device=dev)
                for mode in ("loop", "graph")}

    def prepare(mode):
        w = wrappers[mode]
        st = (bgraph.restore_into(w._state, learned) if mode == "graph"
              else learned)
        if st is learned:
            w.state = learned
        w.generator.set_state(gen_state)
        torch.cuda.synchronize()
        return w

    def epoch(mode, w, k=n):
        got = []
        with bgraph.eager() if mode == "loop" else contextlib.nullcontext():
            for x in xs[:k]:
                got.append((*w.process(x), w.last_metrics))
        return got

    def run(mode):
        w = prepare(mode)
        t0 = time.perf_counter()
        got = epoch(mode, w)
        torch.cuda.synchronize()
        return got, time.perf_counter() - t0

    checked = {}
    for mode in wrappers:
        kernels.reset_launch_counts()
        got, _ = run(mode)
        checked[mode] = (got, kernels.launch_counts(),
                         copy.deepcopy(wrappers[mode].state))
    (g_l, n_l, s_l), (g_g, n_g, s_g) = checked["loop"], checked["graph"]
    require(all(a[2] == b[2] for a, b in zip(g_l, g_g)),
            "B=1 wrapper: the graph's last_metrics == the loop's, every step")
    require(same_tree([a[:2] for a in g_g], [a[:2] for a in g_l])
            and same_tree(s_g, s_l),
            "B=1 wrapper: the graph's outputs and state == the loop's")
    require(n_g == n_l == steps(table_update=n),
            f"B=1 wrapper: table_update once a step in both, got {n_g} and "
            f"{n_l}")
    del checked, g_l, g_g, s_l, s_g
    runs = {mode: [] for mode in wrappers}
    for _ in range(REPEATS):
        for mode in runs:
            runs[mode].append(1e3 * run(mode)[1] / n)
    out = {"launches": {"table_update": n}}
    for mode in runs:
        w = prepare(mode)
        print(f"  profile of {PROFILED_STEPS} B=1 wrapper steps, {mode}, top "
              f"device ops:")
        busy, n_launch = device_profile(
            lambda: epoch(mode, w, PROFILED_STEPS), PROFILED_STEPS, 3)
        med = statistics.median(runs[mode])
        out[mode] = {"ms_per_step": med, "runs": runs[mode],
                     "device_busy_ms_per_step": busy,
                     "launches_per_step": n_launch,
                     "busy_share": busy / med}
    print(f"B=1 wrapper epoch ({n} steps): graph == loop in every output, "
          f"metric and leaf; ms/step (median of {REPEATS}; device busy; "
          f"launches a step; busy share): " + "; ".join(
              f"{mode} {out[mode]['ms_per_step']:.3f} ("
              + ", ".join(f"{t:.3f}" for t in runs[mode])
              + f"; {out[mode]['device_busy_ms_per_step']:.3f}; "
              f"{out[mode]['launches_per_step']:.1f}; "
              f"{out[mode]['busy_share']:.3f})" for mode in runs))
    return out


def run_reference_api(dev) -> dict:
    """The single-stream reference API on the card at the README's
    defaults (`HierarchicalTemporalMemory(1000, 2048, 32)`), each part
    with the launch counts set to 0 just before it and read just after:

    (a) B=1 learning through the wrapper: B1_EPOCHS epochs of 100
        patterns (ms/step each, host time, synchronized), then B1_INFER
        inference steps; `table_update` once a learning step, `act_conn`
        once an inference step, no other kernel; bursting falls. Then the
        last epoch again from the learned state by the loop and by the
        graph (`wrapper_vs_loop`).
    (b) checkpoints: saved after B1_SAVE_EPOCHS epochs of (a), restored
        into a fresh wrapper that runs the rest: every leaf and metric
        equal to (a)'s uninterrupted run.
    (c) the oracle gate: `example.oracle_checked_run` (the CLI's
        `--oracle`) from (a)'s learned state, the oracle built from it,
        ORACLE_LEARN learning then ORACLE_INFER inference steps of the
        next epoch, every step judged by the port's NumPy oracle; the
        same launch rule; segments grown, reinforced and punished.
    (d) the CLI: `python -m bithtm_tpu_torch.example` with CLI_ARGS and a
        checkpoint, then again resuming from it: rc 0, the timesteps/s
        line.

    Also prints the small drive recipe's metrics through the wrapper.
    Returns the launch counts of (a) and (c)."""
    from bithtm_tpu_torch import example
    from bithtm_tpu_torch.utils import checkpoint

    cfg = bt.make_htm_config(**REFERENCE)
    A, I = cfg.sp.active_columns, cfg.input_dim
    require((A, cfg.tm.segments_per_column, cfg.tm.synapse_capacity,
             cfg.sp.permanence_dtype, cfg.tm.allocation_policy)
            == (41, 8, 48, "float32", "evict"),
            "the README's defaults are the reference stack")
    out = {}

    # (a) B=1 learning through the wrapper, with (b)'s checkpoint
    rng = np.random.RandomState(1)
    pats = rng.rand(B1_PATTERNS, I) < 0.2
    T = B1_EPOCHS * B1_PATTERNS
    xs = torch.from_numpy(example.noisy_inputs(
        rng, pats, B1_EPOCHS + 1, 0.05)).to(dev)
    htm = bt.HierarchicalTemporalMemory(**REFERENCE, seed=1, device=dev)
    tmp = tempfile.TemporaryDirectory(prefix=".smoke_", dir=REPO)
    ckpt = os.path.join(tmp.name, "b1")
    metrics, epoch_ms = [], []
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    for epoch in range(B1_EPOCHS):
        if epoch == B1_SAVE_EPOCHS:
            checkpoint.save(ckpt, htm.state, htm.generator)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for x in xs[epoch * B1_PATTERNS:(epoch + 1) * B1_PATTERNS]:
            htm.process(x)
            metrics.append(htm.last_metrics)
        torch.cuda.synchronize()
        epoch_ms.append(1e3 * (time.perf_counter() - t0) / B1_PATTERNS)
    learned = copy.deepcopy(htm.state)
    learned_gen = htm.generator.get_state()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    infer = []
    for x in xs[T:T + B1_INFER]:
        htm.process(x, learning=False)
        infer.append(htm.last_metrics)
    torch.cuda.synchronize()
    infer_ms = 1e3 * (time.perf_counter() - t0) / B1_INFER
    out["b1"] = kernels.launch_counts()
    require(out["b1"] == steps(table_update=T, act_conn=B1_INFER),
            f"B=1 learning launches table_update once a learning step and "
            f"act_conn once an inference step, got {out['b1']}")
    record_decisions("reference B=1", cfg, learned, xs[T][None])
    record_decisions("reference B=256", cfg, tile_state(learned, BATCH),
                     xs[T][None].expand(BATCH, -1).contiguous())
    torch.cuda.empty_cache()

    def epoch_mean(k, e):
        return statistics.mean(m[k] for m in
                               metrics[e * B1_PATTERNS:(e + 1) * B1_PATTERNS])

    burst = [epoch_mean("bursting", e) for e in range(B1_EPOCHS)]
    correct = [epoch_mean("correct", e) for e in range(B1_EPOCHS)]
    require(burst[-1] < burst[0] and correct[-1] > correct[0],
            f"B=1 learning: bursting falls and correct rises over the "
            f"epochs: {burst}, {correct}")
    print(f"B=1 learning through HierarchicalTemporalMemory({I}, "
          f"{cfg.column_dim}, {cfg.cell_dim}) (A={A}, G=8, K=48, float32 "
          f"SP), {B1_PATTERNS} patterns: "
          + "; ".join(f"epoch {e}: {epoch_ms[e]:.3f} ms/step, bursting "
                      f"{burst[e]:.2f}, correct {correct[e]:.2f}"
                      for e in range(B1_EPOCHS))
          + f"; inference {infer_ms:.3f} ms/step, correct "
          f"{statistics.mean(m['correct'] for m in infer):.2f} of {A}; "
          f"launches {out['b1']}")

    # (b) restore into a fresh wrapper and run the rest
    fresh = bt.HierarchicalTemporalMemory(**REFERENCE, seed=99,
                                          device=dev)
    fresh.state = checkpoint.restore(ckpt, fresh.state, fresh.generator)
    T0 = B1_SAVE_EPOCHS * B1_PATTERNS
    for t in range(T0, T):
        fresh.process(xs[t])
        require(fresh.last_metrics == metrics[t],
                f"the restored wrapper's step {t} metrics == the "
                f"uninterrupted run's")
    diff = differing_leaves(fresh.state, learned)
    require(not diff, f"restored -> {T - T0} steps == uninterrupted, "
            f"every leaf; differ: {diff}")
    print(f"checkpoint: saved after step {T0} on the card, restored into a "
          f"fresh wrapper, {T - T0} more steps: every leaf and metric equal "
          f"to the uninterrupted run")

    out["wrapper_graph_vs_loop"] = wrapper_vs_loop(
        learned, learned_gen, xs[T - B1_PATTERNS:T], dev)

    # (c) the oracle gate, on the learned state and the next epoch
    n = ORACLE_LEARN + ORACLE_INFER
    sums: dict[str, int] = {}

    def add(t, tm_out):
        for k, v in tm_out.metrics.items():
            sums[k] = sums.get(k, 0) + int(v.sum())

    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    gate = example.oracle_checked_run(
        cfg, xs[T:T + n].cpu().numpy(),
        [True] * ORACLE_LEARN + [False] * ORACLE_INFER, 2, dev, add,
        state=learned)
    out["oracle"] = kernels.launch_counts()
    require(out["oracle"] == steps(table_update=ORACLE_LEARN,
                                   act_conn=ORACLE_INFER),
            f"the oracle gate launches table_update once a learning step "
            f"and act_conn once an inference step, got {out['oracle']}")
    reinforced = sums["tm_learning_segments"] - sums["tm_new_segments"]
    require(sums["tm_grown_synapses"] > 0 and reinforced > 0
            and sums["tm_punished_segments"] > 0,
            f"the gate grows, reinforces and punishes segments: {sums}")
    print(f"oracle gate on {torch.cuda.get_device_name(0)} at {I} -> "
          f"{cfg.column_dim}x{cfg.cell_dim} (A={A}, G=8, K=48, float32 SP), "
          f"from the state learned over {T} steps: {gate['steps']} steps "
          f"({ORACLE_LEARN} learning, {ORACLE_INFER} inference), every step "
          f"bit-exact against the port's BAMI oracle; port steps "
          f"{gate['port_s']:.2f} s, oracle {gate['oracle_s']:.2f} s "
          f"({gate['oracle_s'] / gate['steps']:.2f} s a step, building it "
          f"included); grown {sums['tm_grown_synapses']} synapses, new "
          f"{sums['tm_new_segments']}, reinforced {reinforced}, punished "
          f"{sums['tm_punished_segments']} segments, predicted cells "
          f"{sums['tm_predicted_cells']}; launches {out['oracle']}")
    del htm, fresh, learned

    # the small drive recipe through the wrapper
    small = bt.HierarchicalTemporalMemory(
        64, 64, 4, active_columns=4, segment_activation_threshold=2,
        segment_matching_threshold=2, segment_sampling_synapses=8,
        device=dev)
    pats = np.random.RandomState(0).rand(5, 64) < 0.2
    per_epoch = []
    for _ in range(6):
        for p in pats:
            small.process(p)
        per_epoch.append(dict(small.last_metrics))
    print("drive recipe HierarchicalTemporalMemory(64, 64, 4, A=4), 6 "
          "epochs of 5 patterns, the last step of each: " + "; ".join(
              f"bursting {m['bursting']} correct {m['correct']} incorrect "
              f"{m['incorrect']}" for m in per_epoch))
    require(per_epoch[-1]["bursting"] < per_epoch[0]["bursting"]
            and per_epoch[-1]["correct"] > per_epoch[0]["correct"],
            "the drive recipe learns: bursting falls, correct rises")

    # (d) the CLI, then resuming from its checkpoint
    cli = [sys.executable, "-m", "bithtm_tpu_torch.example", *CLI_ARGS,
           "--checkpoint", os.path.join(tmp.name, "cli")]
    for run in ("first", "resumed"):
        t0 = time.perf_counter()
        res = subprocess.run(cli, cwd=REPO, capture_output=True, text=True,
                             timeout=300)
        line = [s for s in res.stdout.splitlines() if "timesteps/s" in s]
        require(res.returncode == 0 and len(line) == 1
                and (run == "first") != ("resumed from" in res.stdout),
                f"the CLI ({run}) runs on the card: rc {res.returncode}, "
                f"{res.stdout[-500:]} {res.stderr[-1500:]}")
        print(f"CLI {run}: python -m bithtm_tpu_torch.example "
              f"{' '.join(CLI_ARGS)} --checkpoint DIR: rc 0 in "
              f"{time.perf_counter() - t0:.1f} s, {line[0]}")
    tmp.cleanup()
    return out


# BASELINE.json configuration 3 ("batched multi-stream sequence
# prediction / anomaly scoring, NAB-style encoders") at the width of
# examples/anomaly_benchmark.py:160-168: ScalarEncoder(-2.2, 2.2, 256, 17)
# + CyclicEncoder(24, 96, 9) -> 352 inputs, 512 columns x 8 cells, A=16,
# G=8, K=48, float32 SP; its 8 tasks x 32 seeds are B=256 streams, the
# bench's batch
ANOMALY_WIDTH = (512, 8, 16)   # columns, cells, active columns
ANOMALY_SEEDS = 32
ANOMALY_BATCH = 8 * ANOMALY_SEEDS
# the stack: two such layers (352 -> 512x8 -> 512x8) over the spike trace
STACK_LEARN, STACK_INFER, STACK_CHECK = 360, 16, 16
PREFETCH_STEPS, PREFETCH_CHUNK = 64, 16
# the example scripts, each in a process of its own
EXAMPLE_RUNS = (["sequence_prediction"], ["anomaly_detection", "--seeds", "1"])
LIK_TOL = 2.4e-7  # |dL|, the CPU tests' tolerance (erf, sums)


def z_tol(z: torch.Tensor) -> torch.Tensor:
    return 2e-6 + 1e-6 * z.abs()


def alert_decisions_agree(lik, z, lik_cpu, z_cpu, fire, fire_cpu) -> int:
    """The card's alert decisions equal the CPU's, except where a
    likelihood or |z| lies within its tolerance of the threshold (those
    are printed). Returns the count of such steps."""
    thr_lik = np.float32(1 - 10 ** -5.0)
    near = ((np.abs(lik_cpu - thr_lik) <= LIK_TOL)
            | (np.abs(np.abs(z_cpu) - 5.0) <= 2e-6 + 1e-6 * 5.0))
    differ = fire != fire_cpu
    for t, b in np.argwhere(near)[:20]:
        print(f"step {t} stream {b}: a score within tolerance of its "
              f"threshold (L {lik[t, b]!r} / {lik_cpu[t, b]!r}, z "
              f"{z[t, b]!r} / {z_cpu[t, b]!r}), decision "
              f"{'differs' if differ[t, b] else 'equal'}")
    require(not (differ & ~near).any(),
            f"the card's alert decisions == the CPU's away from the "
            f"thresholds ({int(differ.sum())} differ)")
    return int(near.sum())


def run_anomaly(dev) -> dict:
    """BASELINE configuration 3 on the card, each part with the launch
    counts set to 0 just before it and read just after:

    (a) anomaly scoring: the 8 tasks of `make_task` x ANOMALY_SEEDS seeds
        as B=256 streams (`bithtm_tpu_torch.examples.anomaly_benchmark`):
        the encoders on the card (equal to the CPU's bit for bit), one
        1,440-step `htm_scan(learning=True)` launching `table_update`
        once a step and nothing else, the likelihood (window 300,
        momentum 0.7, exclude 24) and `seasonal_zscore` (window 96) on
        the card, one launch of `anomaly_likelihood` and one of
        `seasonal_zscore` and nothing else, within the CPU tests'
        tolerances of the CPU's on the same scores and values (timed
        beside the parent's loop of eager ops, the plain versions on the
        card), alerts and window scores per stream on the host: mean F1
        >= 0.9 on spike and freq_change.
    (b) the stack 352 -> 512x8 -> 512x8 at B=256 over the spike trace:
        STACK_LEARN learning steps (two `table_update` a step, both
        layers' bursting falls), STACK_INFER inference steps (two
        `act_conn` a step), and from the initial state a `stack_scan` of
        STACK_CHECK steps equal to a loop of `stack_step` in every leaf.
    (c) `python -m bithtm_tpu_torch.examples.sequence_prediction` and
        `... anomaly_detection --seeds 1`, each rc 0 with its assert.
    (d) an `htm_scan` fed by `prefetch_to_device` in chunks equal to the
        scan over the whole tensor, every leaf and metric.

    Prints wall time, ms/step, launches a step and the busy share of
    (a) and (b). Returns the launch counts of (a), its stages and (b)
    and the stages' seconds."""
    from bithtm_tpu_torch.examples import anomaly_benchmark as ab
    from bithtm_tpu_torch.examples import likelihood_series, nlog10
    from bithtm_tpu_torch.utils.data import prefetch_to_device

    out = {}
    C, D, A = ANOMALY_WIDTH
    cfg = ab.make_config()
    require((cfg.input_dim, cfg.sp.column_dim, cfg.tm.cell_dim,
             cfg.sp.active_columns, cfg.tm.segments_per_column,
             cfg.tm.synapse_capacity, cfg.sp.permanence_dtype)
            == (352, C, D, A, 8, 48, "float32"),
            "the anomaly configuration is 352 -> 512x8, A=16, G=8, K=48, "
            "float32 SP")

    # (a) anomaly scoring at B=256
    values, windows, fp_only = ab.suite(ab.TASKS, ANOMALY_SEEDS)
    T, B = values.shape
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    x = ab.encode(values, dev)
    torch.cuda.synchronize()
    enc_s = time.perf_counter() - t0
    x_cpu = ab.encode(values, "cpu")
    require(torch.equal(x.cpu(), x_cpu),
            f"the encoders on the card == the CPU's, bit for bit: "
            f"{int((x.cpu() != x_cpu).sum())} bits differ")
    gen = torch.Generator(device=dev).manual_seed(0)
    state = bt.htm_init_batch(cfg, B, gen, dev)
    draws = bt.TorchDraws(cfg.tm, B, dev, gen)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    state, metrics = bt.htm_scan(cfg, state, x, True, detailed_metrics=False,
                                 draws=draws)
    torch.cuda.synchronize()
    scan_s = time.perf_counter() - t0
    out["anomaly"] = kernels.launch_counts()
    record_decisions("anomaly stack", cfg, state, x[-1])
    require(out["anomaly"] == steps(table_update=T),
            f"the anomaly scan launches table_update, sp_overlap and "
            f"seg_counts once a step and no other kernel, got "
            f"{out['anomaly']}")
    raw = metrics["anomaly"]
    require(bool(torch.isfinite(raw).all()) and bool((raw >= 0).all())
            and bool((raw <= 1).all()), "raw anomaly scores in [0, 1]")
    vals = torch.from_numpy(values)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    lik = likelihood_series(raw, ab.LIK_WINDOW, ab.LIK_MOMENTUM, ab.PERIOD)
    z = bt.seasonal_zscore(vals.to(dev), ab.PERIOD, window=4 * ab.PERIOD)
    torch.cuda.synchronize()
    stage_s = time.perf_counter() - t0
    out["stages"] = kernels.launch_counts()
    require(out["stages"] == only(anomaly_likelihood=1, seasonal_zscore=1),
            f"the stages launch one anomaly_likelihood and one "
            f"seasonal_zscore and nothing else, got {out['stages']}")
    # the parent's stages: the loop of eager torch ops (the plain
    # versions) on the card, on the same scores and values
    t0 = time.perf_counter()
    penc.anomaly_likelihood_steps_ref(
        bt.anomaly_likelihood_init(ab.LIK_WINDOW, B, dev), raw,
        ab.LIK_MOMENTUM, ab.PERIOD)
    penc.seasonal_zscore_steps_ref(
        bt.seasonal_zscore_init(ab.PERIOD, 4 * ab.PERIOD, 3, B, dev),
        vals.to(dev), ab.PERIOD)
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - t0
    lik_cpu = likelihood_series(raw.cpu(), ab.LIK_WINDOW, ab.LIK_MOMENTUM,
                                ab.PERIOD)
    z_cpu = bt.seasonal_zscore(vals, ab.PERIOD, window=4 * ab.PERIOD)
    dl = float((lik.cpu() - lik_cpu).abs().max())
    dz = (z.cpu() - z_cpu).abs()
    require(dl <= LIK_TOL, f"likelihood on the card within {LIK_TOL} of "
            f"the CPU's: {dl}")
    require(bool((dz <= z_tol(z_cpu)).all()),
            f"z on the card within 2e-6 + 1e-6|z| of the CPU's: max "
            f"{float(dz.max())}")
    nlog, z_host = nlog10(lik), z.cpu().numpy()
    fire = ab.detections(nlog, z_host, 5.0, 5.0)
    fire_cpu = ab.detections(nlog10(lik_cpu), z_cpu.numpy(), 5.0, 5.0)
    n_near = alert_decisions_agree(lik.cpu().numpy(), z_host,
                                   lik_cpu.numpy(), z_cpu.numpy(), fire,
                                   fire_cpu)
    t0 = time.perf_counter()
    results = ab.score_streams(fire, windows, fp_only)
    host_s = time.perf_counter() - t0
    print(f"anomaly suite on {torch.cuda.get_device_name(0)}, 8 tasks x "
          f"{ANOMALY_SEEDS} seeds = B={B}, T={T}, 352 -> {C}x{D} (A={A}, "
          f"G=8, K=48, float32 SP); per task, mean over seeds (alert: "
          f"L >= 0.99999 or |z| >= 5 after step "
          f"{ab.PROBATION_CYCLES * ab.PERIOD}):")
    table = ab.task_table(ab.TASKS, ANOMALY_SEEDS, results)
    f1 = {name: f for name, _, _, f, _ in table}
    print(f"anomaly scan: {scan_s:.2f} s, {1e3 * scan_s / T:.3f} ms/step, "
          f"launches {out['anomaly']}; encoders {1e3 * enc_s:.1f} ms, "
          f"likelihood + z on the card {1e3 * stage_s:.2f} ms in one launch "
          f"each (the parent's loop of eager ops, the plain versions on the "
          f"card: {loop_s:.2f} s; max |dL| {dl!r}, "
          f"max |dz| {float(dz.max())!r} against the CPU; {n_near} "
          f"decisions within tolerance of a threshold), alerts and scores "
          f"on the host {1e3 * host_s:.1f} ms")
    out["stage_s"], out["stage_loop_s"] = stage_s, loop_s
    require(f1["spike"] >= 0.9 and f1["freq_change"] >= 0.9,
            f"mean F1 >= 0.9 on spike and freq_change: {f1}")
    start = Start(state, gen, lambda g: bt.TorchDraws(cfg.tm, B, g.device,
                                                       g))
    out["anomaly_graph_vs_loop"] = loop_vs_graph(
        "anomaly learning", start, lambda st, k: bt.htm_scan(
            cfg, st, x[:k], True, detailed_metrics=False,
            draws=start.draws), GRAPH_ANOMALY)
    del start, state, x, x_cpu, metrics, raw, lik, z, lik_cpu, z_cpu

    # (b) the stack at B=256 over the spike trace
    scfg = bt.make_stack_config(cfg.input_dim, [(C, D), (C, D)],
                                **ab.OPTIONS)
    spike, _, _ = ab.make_task("spike", np.random.RandomState(7000))
    n = STACK_LEARN + STACK_INFER
    xs = ab.encode(np.repeat(spike[:n, None], B, 1), dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    state = bt.stack_init(scfg, B, gen, dev)
    snap, gen_state = copy.deepcopy(state), gen.get_state()
    draws = bt.stack_draws(scfg, B, dev, gen)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    state, m_learn = bt.stack_scan(scfg, state, xs[:STACK_LEARN], True,
                                   draws)
    torch.cuda.synchronize()
    learn_s = time.perf_counter() - t0
    out["stack_learn"] = kernels.launch_counts()
    require(out["stack_learn"] == steps(table_update=2 * STACK_LEARN),
            f"stack learning launches table_update twice a step, got "
            f"{out['stack_learn']}")
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    state, m_inf = bt.stack_scan(
        scfg, state, xs[STACK_LEARN:STACK_LEARN + STACK_INFER], False, draws)
    torch.cuda.synchronize()
    infer_s = time.perf_counter() - t0
    out["stack_infer"] = kernels.launch_counts()
    require(out["stack_infer"] == steps(act_conn=2 * STACK_INFER),
            f"stack inference launches act_conn twice a step, got "
            f"{out['stack_infer']}")
    burst = {k: m_learn[f"L{k}_bursting"].float().mean(1).cpu()
             for k in (0, 1)}
    for k, b in burst.items():
        require(float(b[-10:].mean()) < float(b[:10].mean()) / 3,
                f"layer {k} learns: bursting {float(b[:10].mean())} -> "
                f"{float(b[-10:].mean())}")
    print(f"stack {cfg.input_dim} -> {C}x{D} -> {C}x{D} at B={B} over the "
          f"spike trace: {STACK_LEARN} learning steps {learn_s:.2f} s "
          f"({1e3 * learn_s / STACK_LEARN:.3f} ms/step), bursting "
          + ", ".join(f"L{k} {float(b[:10].mean()):.2f} -> "
                      f"{float(b[-10:].mean()):.2f}"
                      for k, b in burst.items())
          + f" of {A}; {STACK_INFER} inference steps "
          f"{1e3 * infer_s / STACK_INFER:.3f} ms/step, correct "
          f"{float(m_inf['L0_correct'].float().mean()):.2f} / "
          f"{float(m_inf['L1_correct'].float().mean()):.2f}; launches "
          f"{out['stack_learn']} / {out['stack_infer']}")
    start = Start(state, gen, lambda g: bt.stack_draws(scfg, B, dev, g))
    out["stack_graph_vs_loop"] = loop_vs_graph(
        "stack learning", start, lambda st, k: bt.stack_scan(
            scfg, st, xs[:k], True, start.draws), GRAPH_STACK)
    del start, state, m_learn, m_inf
    s_loop = copy.deepcopy(snap)
    gen.set_state(gen_state)
    draws = bt.stack_draws(scfg, B, dev, gen)
    for x_t in xs[:STACK_CHECK]:
        s_loop, _ = bt.stack_step(scfg, s_loop, x_t, True, draws)
    gen.set_state(gen_state)
    s_scan, _ = bt.stack_scan(scfg, snap, xs[:STACK_CHECK], True,
                              bt.stack_draws(scfg, B, dev, gen))
    for k, (a, b) in enumerate(zip(s_loop, s_scan, strict=True)):
        diff = differing_leaves(a, b)
        require(not diff, f"stack_scan == a loop of stack_step, layer {k}: "
                f"{diff}")
    print(f"stack_scan of {STACK_CHECK} steps == a loop of stack_step, "
          f"every leaf of both layers")
    del s_loop, s_scan, snap, xs
    torch.cuda.empty_cache()

    # (c) the example scripts, side by side (both are host-bound)
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-m", f"bithtm_tpu_torch.examples.{argv[0]}",
         *argv[1:]], cwd=REPO, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for argv in EXAMPLE_RUNS]
    try:
        for argv, proc in zip(EXAMPLE_RUNS, procs):
            stdout, stderr = proc.communicate(timeout=600)
            name = " ".join(argv)
            require(proc.returncode == 0,
                    f"{name}: rc {proc.returncode}, {stdout[-1500:]} "
                    f"{stderr[-1500:]}")
            lines = stdout.strip().splitlines()
            print(f"python -m bithtm_tpu_torch.examples.{name}: rc 0, done "
                  f"{time.perf_counter() - t0:.1f} s after both started; "
                  + " | ".join(s.strip() for s in lines[-4:]))
    finally:
        for proc in procs:
            proc.kill()
            proc.wait()

    # (d) a prefetch-fed scan against the direct scan
    values = values[:PREFETCH_STEPS]
    host = ab.encode(values, "cpu").numpy()
    gen = torch.Generator(device=dev).manual_seed(2)
    s0 = bt.htm_init_batch(cfg, B, gen, dev)
    gen_state = gen.get_state()
    direct, m_direct = bt.htm_scan(cfg, copy.deepcopy(s0),
                                   torch.from_numpy(host).to(dev), True,
                                   detailed_metrics=False,
                                   draws=bt.TorchDraws(cfg.tm, B, dev, gen))
    gen.set_state(gen_state)
    draws = bt.TorchDraws(cfg.tm, B, dev, gen)
    state, parts = s0, []
    for chunk in prefetch_to_device(
            (host[i:i + PREFETCH_CHUNK]
             for i in range(0, PREFETCH_STEPS, PREFETCH_CHUNK)), 2, dev):
        require(chunk.device == dev, "prefetched chunks lie on the card")
        state, m = bt.htm_scan(cfg, state, chunk, True,
                               detailed_metrics=False, draws=draws)
        parts.append(m)
    diff = differing_leaves(state, direct) + [
        k for k, v in m_direct.items()
        if not torch.equal(torch.cat([m[k] for m in parts]), v)]
    require(not diff, f"the prefetch-fed scan == the direct scan: {diff}")
    print(f"prefetch: {PREFETCH_STEPS} steps at B={B} in chunks of "
          f"{PREFETCH_CHUNK} through prefetch_to_device == one scan over "
          f"the whole tensor, every leaf and metric")
    return out


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA GPU; "
                         "torch.cuda.is_available() is false")
    if sys.argv[1:2] == ["--parallel-worker"]:
        parallel_worker(*sys.argv[2:5])
        return
    dev = torch.device("cuda", 0)
    device = gpu_info(dev)
    began = clock = time.perf_counter()
    phases = {}

    def phase(name: str) -> None:
        nonlocal clock
        now = time.perf_counter()
        phases[name] = round(now - clock, 1)
        print(f"phase {name}: {phases[name]} s")
        clock = now

    kernels.build(force=True)
    print(f"kernels built from {', '.join(sorted(set(SOURCES.values())))} "
          f"in {time.perf_counter() - clock:.2f} s")
    phase("build")

    checks = check_kernels(dev)
    main_paths = {k.name: set(k.path) for k in kernels.KERNELS}
    path_rows = check_paths(dev)
    print("kernel paths: " + json.dumps(path_rows))
    phase("check_kernels")
    grow_pack, grow_pack_paths = check_grow_and_pack(dev)
    checks.update(grow_pack)
    path_rows.update(grow_pack_paths)
    phase("check_grow_and_pack")
    checks["sp_rows"], path_rows["sp_rows"] = check_sp_rows(dev)
    phase("check_sp_rows")
    checks["sp_select"], path_rows["sp_select"] = check_sp_select(dev)
    phase("check_sp_select")
    path_rows["serving_counts"] = check_serving_counts(dev)
    phase("check_serving_counts")
    check_learning(dev)
    check_cpu_agreement(dev)
    launches, snap, _, (state, gen, serve_xs) = run_main_path(dev)
    record_decisions("bench", snap.cfg, state, serve_xs[0])
    phase("run_main_path")
    fuzz = run_fuzz_on_card(dev)
    phase("run_fuzz_on_card")
    tmp = tempfile.TemporaryDirectory(prefix=".smoke_", dir=REPO)
    bench_path = os.path.join(tmp.name, "bench.pt")
    torch.save(host_leaves(state), bench_path)
    parity = run_parity(dev, (state, serve_xs), tmp.name)
    phase("run_parity")
    served, checks["serving_counts"] = run_serving(snap.cfg, state, gen,
                                                   serve_xs)
    launches.update(served)
    phase("run_serving")
    graph_paths = {"bench": run_graph_bench(snap.cfg, state, gen, serve_xs)}
    phase("run_graph_bench")
    profile = run_profile(
        graph_paths["bench"]["learning"]["graph"]["launches_per_step"])
    phase("run_profile")
    entry = run_entry_points(snap.cfg, state, serve_xs)
    check_boost(dev, state.sp, serve_xs)
    launches.update({k: entry[k] for k in (
        "sp_update_pack", "synapse_activation", "serving_activation",
        "pack_bits")})
    del state
    time_phases(snap, snap.xs[:PROFILED_STEPS])
    del snap
    torch.cuda.empty_cache()
    phase("entry points, boost, phases, profile")
    launches_16k, rows_16k, learned16, graph_paths["16k"], carry16 = \
        run_16k(dev)
    launches["small_table_take"] = launches_16k["small_table_take"]
    checks["serving_counts"]["16k"] = rows_16k["serving_counts"]
    torch.cuda.empty_cache()
    phase("run_16k")
    soaks = run_soaks(dev, carry16)
    del carry16
    torch.cuda.empty_cache()
    phase("run_soaks")
    shard_rows = run_parallel(dev, learned16, bench_path, tmp.name)
    print(f"parallel phase: {time.perf_counter() - clock:.1f} s; kernels on "
          f"a column shard: " + json.dumps(shard_rows))
    del learned16
    tmp.cleanup()
    torch.cuda.empty_cache()
    phase("run_parallel")
    graph_paths["b1"] = run_reference_api(dev)["wrapper_graph_vs_loop"]
    torch.cuda.empty_cache()
    phase("run_reference_api")
    anomaly = run_anomaly(dev)
    graph_paths["anomaly"] = anomaly["anomaly_graph_vs_loop"]
    graph_paths["stack"] = anomaly["stack_graph_vs_loop"]
    launches.update({k: anomaly["stages"][k]
                     for k in ("anomaly_likelihood", "seasonal_zscore")})
    phase("run_anomaly")
    (checks["anomaly_likelihood"], checks["seasonal_zscore"],
     stage_rows) = check_anomaly_stages(dev)
    path_rows.update(stage_rows)
    torch.cuda.empty_cache()
    phase("check_anomaly_stages")
    checks["column_decide"], path_rows["column_decide"] = \
        check_column_decide()
    DECIDE_CALLS.clear()
    torch.cuda.empty_cache()
    phase("check_column_decide")
    print("graph vs loop: " + json.dumps(graph_paths))
    print("tools: " + json.dumps({
        "fuzz": {k: v["paths"] for k, v in fuzz.items()},
        "parity": {k: {f: v.get(f) for f in ("port_s", "oracle_s")}
                   for k, v in parity.items() if k != "sp"},
        "profile": {tag: {k: prof[k] for k in (
            "sites", "launches", "ranges_ms", "loop_busy_ms",
            "graph_busy_ms", "graph_launches")}
            for tag, prof in (("bench", profile), ("16k", profile["16k"]))},
        "soaks": {"16k": {k: soaks["16k"][k] for k in (
            "escalated_at_step", "banked_drops", "end_to_end_ms_per_step",
            "tuned_steady_ms_per_step", "safe_steady_ms_per_step")},
            "evict_pressure": [(w["step"], w["evicted_per_step"],
                                w["drops"], w["streams_at_full"],
                                w["ms_per_step"])
                               for w in soaks["evict_pressure"]["windows"]],
            "fast_stack": soaks["fast_stack"].get("record")}}))
    print(f"phases (s): {json.dumps(phases)}; total "
          f"{time.perf_counter() - began:.1f} s")

    paths = {name: sorted(main_paths[name].union(*(
        [*row["path"], *row.get("counts_form", {}).get("path", ())]
        for row in path_rows.get(name, {}).values())))
        for name in REPLACES}
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": SOURCES[name],
         "replaces": REPLACES[name], "launches": launches[name],
         **checks[name], "paths": paths[name]} for name in REPLACES]}))
    print(json.dumps({"ok": True, "device": device}))


if __name__ == "__main__":
    main()
