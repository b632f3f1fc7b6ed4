"""Synthetic inputs for checking the forward passes (`table_update`,
`synapse_activation_conn`, `synapse_activation_frozen`,
`serving_activation`, the compact serving table's counts and flags:
`serving_inputs`) and their CUDA kernels against their plain
versions, made with numpy from a seed at any shape; the check of the
SP's boost on one device against the CPU (`boost_agreement`); the
growth selection's inputs at a TM geometry (`grow_inputs`,
`same_choice`);
the anomaly stages' states and series (`likelihood_inputs`,
`zscore_inputs`, at the cases `LIKELIHOOD_CASES` and `ZSCORE_CASES`);
`run_ranks`, which runs the ranks of a multi-process check as processes
with a deadline; `step_launches`, the kernel launches HTM steps make;
and the config-fuzz geometries (`FUZZ_CASES`,
`fuzz_config`), the port's copy of `tests/test_parity_fuzz.py`'s list,
which `tests/test_torch_parity_fuzz.py` holds equal to it."""

from __future__ import annotations

import os
import subprocess
import time

import numpy as np
import torch

from .config import TMConfig
from .ops import kernels
from .ops.active_set import act_dtype, act_scale, pack_bits
from .ops.regularization import sp_select
from .ops.serving import SERVING_G_BITS


def table_inputs(seed: int, B: int, C: int, G: int, K: int, D: int, A: int,
                 device="cpu", threshold: float = 0.5) -> dict:
    """A filled (B, C, G*K) synapse table and a (B, A) active set: live
    and free slots, stale dead slots (syn >= 0, perm < 0), permanences
    near 0 that a punishment of 0.01-0.03 kills, targets biased toward
    the active cells, packed previous activity (`act_scale` encoding at
    ``threshold``, in `act_dtype(K)`), and punished segments outside the
    active columns.

    Returns tensors on ``device``: syn, perm, act_prev, pun_word, cols,
    bits (int32 words) and seg_cell (owners in [0, D], D = none)."""
    rng = np.random.default_rng(seed)
    J, N = G * K, C * D

    def u(*shape):
        return rng.random(shape, dtype=np.float32)

    cols = np.sort(np.argsort(u(B, C), axis=1)[:, :A], axis=1).astype(
        np.int32)
    rows = u(B, A, D) < 0.4
    live = u(B, C, J) < 0.6
    a_idx = rng.integers(0, A, (B, C * J))
    near = (np.take_along_axis(cols, a_idx, 1).reshape(B, C, J) * D
            + rng.integers(0, D, (B, C, J), dtype=np.int32))
    far = rng.integers(0, N, (B, C, J), dtype=np.int32)
    syn = np.where(live, np.where(u(B, C, J) < 0.3, near, far), -1)
    perm = np.where(live, u(B, C, J), np.float32(-1.0))
    perm = np.where(live & (u(B, C, J) < 0.1), u(B, C, J) * 0.02, perm)
    stale = live & (u(B, C, J) < 0.03)
    perm = np.where(stale, np.float32(-0.005), perm).astype(np.float32)
    act = live & (u(B, C, J) < 0.3)
    act_prev = np.where(act, np.where(perm >= threshold,
                                      1 + act_scale(K), 1), 0)
    pun = u(B, C, G) < 0.3
    pun_word = (pun.astype(np.int32) << np.arange(G, dtype=np.int32)).sum(
        -1, dtype=np.int32)
    np.put_along_axis(pun_word, cols.astype(np.int64), 0, axis=1)
    seg_cell = rng.integers(0, D + 1, (B, C, G), dtype=np.int32)
    out = dict(syn=syn.astype(np.int32), perm=perm,
               act_prev=act_prev.astype(np.int32), pun_word=pun_word,
               cols=cols, seg_cell=seg_cell)
    t = {k: torch.from_numpy(v).to(device) for k, v in out.items()}
    t["act_prev"] = t["act_prev"].to(act_dtype(K))
    t["bits"] = pack_bits(torch.from_numpy(rows)).to(device)
    return t


def serving_rows(seed: int, B: int, R: int, C: int, D: int, G: int,
                 device="cpu", empty: float = 0.4) -> torch.Tensor:
    """(B, R, 128) int32 compact serving words ``cell << 5 | g`` over C*D
    cells and G segments, with a share ``empty`` of the lanes -1."""
    rng = np.random.default_rng(seed)
    cell = rng.integers(0, C * D, (B, R, 128), dtype=np.int32)
    g = rng.integers(0, G, (B, R, 128), dtype=np.int32)
    words = np.where(rng.random((B, R, 128)) < empty, -1,
                     (cell << SERVING_G_BITS) | g).astype(np.int32)
    return torch.from_numpy(words).to(device)


def serving_inputs(seed: int, B: int, C: int, D: int, A: int, G: int,
                   M: int, E: int, device="cpu", empty: float = 0.4,
                   hit: float = 0.5, ordered: bool = False,
                   empty_stream: bool = False) -> dict:
    """The arguments of `serving_counts` / `serving_flags` with numpy from
    ``seed``: a compact serving table of B streams, C columns of M main
    rows and E extension rows (``rows`` (B, C*M + E, 128), ``ext_col``
    (B, E)), a (B, A) active set at 40% of its columns' cells, and owners
    ``seg_cell`` (B, C, G) in [0, D] (a fifth the unallocated D). A
    share ``empty`` of the lanes is -1 and of the others a share ``hit``
    targets an active cell, so that segment counts fall on both sides of
    thresholds near their median. A quarter of the extension rows are
    unused (ext_col = C); the others belong to random columns, the first
    two to one column, in random order (``ordered``: in column order, as
    `pack_serving_rows` writes them). ``empty_stream``: the last
    stream's lanes are all empty."""
    rng = np.random.default_rng(seed)
    R, N = C * M + E, C * D
    cols = np.sort(np.argsort(rng.random((B, C)), axis=1)[:, :A], axis=1)
    act = rng.random((B, A, D)) < 0.4
    # each stream's active cells, padded with random ones to A*D
    cells = cols[..., None] * D + np.arange(D)
    pool = np.where(act, cells, rng.integers(0, N, (B, A, D))).reshape(B, -1)
    pool = np.take_along_axis(pool, np.argsort(~act.reshape(B, -1), 1), 1)
    n_act = np.maximum(act.reshape(B, -1).sum(1), 1)
    pick = (rng.random((B, R * 128)) * n_act[:, None]).astype(np.int64)
    cell = np.where(rng.random((B, R * 128)) < hit,
                    np.take_along_axis(pool, pick, 1),
                    rng.integers(0, N, (B, R * 128))).reshape(B, R, 128)
    g = rng.integers(0, G, (B, R, 128))
    words = np.where(rng.random((B, R, 128)) < empty, -1,
                     (cell << SERVING_G_BITS) | g)
    if empty_stream:
        words[-1] = -1
    ext_col = np.where(rng.random((B, E)) < 0.75, rng.integers(0, C, (B, E)),
                       C)
    if E >= 2:
        ext_col[:, 1] = ext_col[:, 0] = rng.integers(0, C, B)
    if ordered:
        ext_col = np.sort(ext_col, 1)
    seg_cell = np.where(rng.random((B, C, G)) < 0.2, D,
                        rng.integers(0, D, (B, C, G)))

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x, np.int32)).to(device)

    return dict(rows=t(words), ext_col=t(ext_col), cols=t(cols),
                bits=pack_bits(torch.from_numpy(act)).to(device),
                seg_cell=t(seg_cell))


def grow_inputs(seed: int, B: int, C: int, D: int, A: int, G: int, K: int,
                Wc: int, L: int, samp: int, device="cpu") -> dict:
    """The arguments of `grow_select` (`models/temporal_memory.py`) at a
    TM geometry, with numpy from ``seed``: A sorted previous active
    columns a stream with 0.5-4 winner cells a column (so some streams
    pass Wc), learning flags on 5-60% of the A*G rows (some pass L),
    synapse rows whose live share varies by row and whose targets are
    half candidates (nine in ten active) and half random cells, so that
    some rows reach samp and grow nothing, and random words."""
    from .models.temporal_memory import growth_key_form

    rng = np.random.default_rng(seed)
    R = A * G

    def t(x, dtype=None):
        return torch.from_numpy(np.ascontiguousarray(x, dtype)).to(device)

    cols = np.sort(np.argsort(rng.random((B, C)), axis=1)[:, :A], axis=1)
    winners = rng.random((B, A, D)) < rng.uniform(0.5, 4.0, (B, 1, 1)) / D
    grid_cell = (cols[..., None] * D + np.arange(D)).reshape(B, A * D)
    cand = [g[w.reshape(-1)][:Wc] for g, w in zip(grid_cell, winners)]
    n_cand = np.array([len(c) for c in cand])
    live = rng.random((B, R, K)) < rng.uniform(0.1, 1.0, (B, R, 1))
    pick = rng.random((B, R * K)) * np.maximum(n_cand, 1)[:, None]
    to_cand = (rng.random((B, R, K)) < 0.5) & (n_cand > 0)[:, None, None]
    target = np.where(
        to_cand,
        np.stack([np.append(c, 0)[p.astype(np.int64)]
                  for c, p in zip(cand, pick)]).reshape(B, R, K),
        rng.integers(0, C * D, (B, R, K)))
    act = live & (rng.random((B, R, K)) < np.where(to_cand, 0.9, 0.5))
    learn = rng.random((B, R)) < rng.uniform(0.05, 0.6, (B, 1))
    cell_form, key_bits = growth_key_form(C * D, Wc)
    return dict(
        syn_rows=t(np.where(live, target, -1), np.int32), act_rows=t(act),
        learn_rows=t(learn), prev_cols=t(cols, np.int32),
        prev_winner_bits=pack_bits(torch.from_numpy(winners)).to(device),
        rnd=t(rng.integers(-(1 << 31), 1 << 31, (B, L, Wc), dtype=np.int32)),
        cell_dim=D, samp=samp, key_bits=key_bits, cell_form=cell_form)


def learn_inputs(seed: int, B: int, C: int, D: int, A: int, G: int, K: int,
                 Wc: int, L: int, samp: int, device="cpu") -> dict:
    """The arguments of a learning step's `grow_select` and `learn_rows`
    (`models/temporal_memory.py`) at a TM geometry, with numpy from
    ``seed``: (B, C, G*K) synapse tables whose A active columns a stream
    hold `grow_inputs`' rows (the other columns random), with stale slots
    (syn >= 0, perm < 0, no activity), live slots with no activity a
    decrement kills, permanences of +0.0 and -0.0, the packed activity in
    `act_dtype(K)` (connected at perm >= 0.5; as the table pass writes
    it, every live slot that targets a previous winner cell is active),
    learning flags with a few new segments among them (every new segment
    learns, as `_learn` sets it) and the previous step's columns, winner
    words and random words.

    Returns {"select": `grow_select`'s keyword arguments (the tables'
    rows at ``row_cols``, ``new_seg``), "perm": the (B, C, G*K) float32
    permanences, "cols", "learn", "new_seg", "increment", "decrement",
    "permanence_initial"}."""
    x = grow_inputs(seed, B, C, D, A, G, K, Wc, L, samp, device="cpu")
    rng = np.random.default_rng(seed + 1)
    R, J = A * G, G * K

    def u(*shape):
        return rng.random(shape, dtype=np.float32)

    cols = np.sort(np.argsort(u(B, C), axis=1)[:, :A], axis=1)
    live = u(B, C, J) < 0.5
    syn = np.where(live, rng.integers(0, C * D, (B, C, J)), -1)
    act = live & (u(B, C, J) < 0.3)
    rows = (np.arange(B)[:, None], cols)
    syn[rows] = x["syn_rows"].numpy().reshape(B, A, J)
    act[rows] = x["act_rows"].numpy().reshape(B, A, J)
    live = syn >= 0
    # as the table pass leaves it: a live slot that targets a previous
    # winner cell (a previous active cell) is active
    words = x["prev_winner_bits"].numpy().view(np.uint32)
    d = np.arange(D)
    won = (words[..., d // 32] >> (d % 32).astype(np.uint32)) & 1 != 0
    is_winner = np.zeros((B, C * D), bool)
    np.put_along_axis(is_winner, (x["prev_cols"].numpy()[..., None] * D
                                  + d).reshape(B, -1)[:, :],
                      won.reshape(B, -1), axis=1)
    hit = np.take_along_axis(is_winner, np.maximum(syn, 0).reshape(B, -1),
                             1).reshape(syn.shape)
    act |= live & hit
    perm = np.where(live, u(B, C, J), np.float32(-1.0))
    # stale slots, slots a decrement kills, and +-0.0, all inactive but
    # the zeros, half of which are active
    kind = u(B, C, J)
    idle = live & ~act
    perm = np.where(idle & (kind < 0.03), np.float32(-0.005), perm)
    perm = np.where(idle & (kind >= 0.03) & (kind < 0.1), u(B, C, J) * 0.05,
                    perm)
    zero = live & (kind >= 0.1) & (kind < 0.12)
    perm = np.where(zero, np.where(u(B, C, J) < 0.5, np.float32(0.0),
                                   np.float32(-0.0)), perm)
    act &= ~(perm < 0)
    scale = act_scale(K)
    packed = np.where(act, np.where(perm >= 0.5, 1 + scale, 1), 0)
    learn = x["learn_rows"].numpy()
    new_seg = learn & (rng.random((B, R)) < 0.05)
    new_seg[np.arange(B), learn.argmax(1)] |= learn.any(1)  # one at least

    def t(v, dtype=None):
        return torch.from_numpy(np.ascontiguousarray(v, dtype)).to(device)

    sel = {k: (v.to(device) if isinstance(v, torch.Tensor) else v)
           for k, v in x.items()}
    sel.update(syn_rows=t(syn, np.int32),
               act_rows=t(packed, np.int32).to(act_dtype(K)),
               row_cols=t(cols, np.int32), new_seg=t(new_seg))
    return {"select": sel, "perm": t(perm, np.float32),
            "cols": sel["row_cols"], "learn": sel["learn_rows"],
            "new_seg": sel["new_seg"], "increment": 0.1003,
            "decrement": 0.0997, "permanence_initial": 0.21}


def decide_inputs(seed: int, cfg: TMConfig, B: int, device="cpu",
                  ties: bool = False, first_steps: int = 1) -> dict:
    """A TM state and one step's columns and draws for the column
    decisions (`temporal_memory.column_decide`) at ``cfg``, with numpy
    from ``seed``. Each column of each stream is one of three kinds: its
    G segments drawn at random (live, active and connected counts, owners
    or unallocated), crowded (every slot live and active: matching, so no
    slot is eligible under either policy) or sparse (every segment
    recyclable, below the matching threshold, some unallocated). Half the
    columns hold a prediction of about half their cells (more unaccounted
    cells than a column has slots), the rest burst; some slots are stale
    (syn >= 0, perm < 0, inactive). The first ``first_steps`` streams are
    at step 0, the others past it. With ``ties``, the draws take the
    values 0.0 and 0.5 only, so scores tie exactly.

    Returns {"state": a `TMState` on ``device``, "cols": (B, A) int32
    sorted, "draws": `rng.Draws` (B, A, G), (B, A, D) and (B, L, Wc)}."""
    from .rng import Draws
    from .state import TMState

    rng = np.random.default_rng(seed)
    C, D, A, G, K = (cfg.column_dim, cfg.cell_dim, cfg.active_columns,
                     cfg.segments_per_column, cfg.synapse_capacity)
    m = cfg.segment_matching_threshold
    W, J = (D + 31) // 32, G * K

    def u(*shape):
        return rng.random(shape, dtype=np.float32)

    kind = rng.integers(0, 3, (B, C, 1))
    live_n = np.where(kind == 1, K, np.where(
        kind == 2, rng.integers(0, max(m, 1), (B, C, G)),
        rng.integers(0, K + 1, (B, C, G))))
    act_n = np.where(kind == 1, live_n,
                     (u(B, C, G) * (live_n + 1)).astype(np.int64))
    conn_n = (u(B, C, G) * (act_n + 1)).astype(np.int64)
    k = np.arange(K)
    live = (k < live_n[..., None]).reshape(B, C, J)
    act = (k < act_n[..., None]).reshape(B, C, J)
    conn = (k < conn_n[..., None]).reshape(B, C, J)
    stale = live & ~act & (u(B, C, J) < 0.1)
    syn = np.where(live, rng.integers(0, C * D, (B, C, J)), -1)
    perm = np.where(live, np.where(conn, 0.5 + 0.5 * u(B, C, J),
                                   0.5 * u(B, C, J)), np.float32(-1.0))
    perm = np.where(stale, np.float32(-0.005), perm).astype(np.float32)
    scale = act_scale(K)
    packed = np.where(act, np.where(conn, 1 + scale, 1), 0)
    owner = rng.integers(0, D, (B, C, G))
    unalloc = u(B, C, G) < np.where(kind == 2, 0.5, 0.15)
    seg_cell = np.where(unalloc & (kind != 1), D, owner)
    cells = (u(B, C, W * 32) < 0.5) & (np.arange(W * 32) < D)
    cells &= u(B, C, 1) < 0.5
    words = (cells.reshape(B, C, W, 32).astype(np.uint64)
             << np.arange(32, dtype=np.uint64)).sum(-1)
    prediction = words.astype(np.uint32).view(np.int32).transpose(0, 2, 1)
    step = np.where(np.arange(B) < first_steps, 0,
                    rng.integers(1, 1000, B))

    def columns():
        return np.sort(np.argsort(u(B, C), axis=1)[:, :A], axis=1)

    prev = columns()
    prev_bits = (rng.integers(0, 1 << 31, (B, A, W))
                 & rng.integers(0, 1 << 31, (B, A, W)))
    if D % 32:
        prev_bits[..., -1] &= (1 << (D % 32)) - 1
    winner_bits = prev_bits & rng.integers(0, 1 << 31, (B, A, W))
    L, Wc = cfg.resolved_growth_capacity, cfg.resolved_winner_capacity
    u_seg, u_least = u(B, A, G), u(B, A, D)
    if ties:
        u_seg = np.floor(2 * u_seg) / 2
        u_least = np.floor(2 * u_least) / 2

    def t(v, dtype):
        return torch.from_numpy(np.ascontiguousarray(v, dtype)).to(device)

    state = TMState(
        synapse_cell=t(syn, np.int32), synapse_perm=t(perm, np.float32),
        seg_cell=t(seg_cell, np.int32), active_cols=t(prev, np.int32),
        active_bits=t(prev_bits, np.int32),
        winner_bits=t(winner_bits, np.int32),
        synapse_act=t(packed, np.int32).to(act_dtype(K)),
        prediction=t(prediction, np.int32),
        matching_word=torch.zeros((B, C), dtype=torch.int32, device=device),
        step=t(step, np.int32))
    rnd = rng.integers(-(1 << 31), 1 << 31, (B, L, Wc))
    return {"state": state, "cols": t(columns(), np.int32),
            "draws": Draws(t(u_seg, np.float32), t(u_least, np.float32),
                           t(rnd, np.int32))}


def decide_args(cfg: TMConfig, x: dict, mode: str = "learn") -> tuple:
    """`temporal_memory.column_decide`'s arguments for ``x``
    (`decide_inputs`) in ``mode``: the state's prediction words and a
    copy of its owners (a learning mode writes the new owners over it) at
    its columns, the columns' `row_counts_ref` counts, the draws and the
    streams' steps."""
    from .models.temporal_memory import row_counts_ref

    s, cols = x["state"], x["cols"]
    pot, conn, live = row_counts_ref(s.synapse_cell, s.synapse_perm,
                                     s.synapse_act, cols,
                                     cfg.segments_per_column)
    return (cfg, s.prediction, s.seg_cell.clone(), cols, pot, conn, live,
            x["draws"], s.step, mode)


def gathered_decide_args(args: tuple) -> tuple:
    """`column_decide`'s arguments at the columns -> on the rows gathered
    there, as a column shard's step gathers them: the prediction words
    and the owners of the columns, no columns."""
    from .models.temporal_memory import _rows

    cfg, pred, owners, cols, *rest = args
    B, W = pred.shape[:2]
    pred = pred.gather(2, cols.long()[:, None, :].expand(
        B, W, cols.shape[1])).contiguous()
    return (cfg, pred, None if owners is None else _rows(owners, cols), None,
            *rest)


def same_choice(got: tuple, want: tuple) -> bool:
    """Two `grow_select` results agree: n_chosen, the lists and the counts
    equal, and chosen equal up to n_chosen (past it only the kernel's fill
    is defined)."""
    (c1, n1, *rest1), (c2, n2, *rest2) = got, want
    if c1.shape != c2.shape or not torch.equal(n1, n2) or not all(
            torch.equal(a, b) for a, b in zip(rest1, rest2)):
        return False
    upto = torch.arange(c1.shape[-1], device=c1.device) < n1[..., None]
    return torch.equal(torch.where(upto, c1, 0), torch.where(upto, c2, 0))


# the kernels that run a step's distal forward pass, one of them a step
STEP_KERNELS = ("table_update", "act_conn", "act_frozen",
                "serving_counts")


def step_launches(sp_steps: int | None = None, **counts) -> dict:
    """The launch count of every kernel (`kernels.launch_counts`'s keys)
    after HTM steps that launched the given kernels ``counts``, every
    other kernel 0: beside them one `sp_overlap` and one `sp_select` (the
    boost, inhibition and duty-cycle EMA) a step (``sp_steps``, by
    default one for each launch of a kernel of STEP_KERNELS, as a step
    runs the SP once), one `column_decide` a step (the column decisions,
    which also write the active and winner cells' words), one
    `seg_counts` after each kernel that writes the packed activity (all
    of STEP_KERNELS but `serving_counts`, the packed serving step's one
    kernel after the SP, which writes the matching and prediction words
    from the compact table itself: no `serving_activation`, `pack_bits`
    or `seg_counts`), and one `row_counts`, one `grow_select`, one
    `learn_rows` and one `sp_rows` (the SP's update of its active rows) a
    learning step (each `table_update`). No step launches `pack_bits`:
    every step's matching word comes from `seg_counts`' or
    `serving_counts`' flags form. A count given in ``counts`` overrides
    its default (a `tm_resume` launches one `act_conn`, one `seg_counts`
    and no `column_decide`; a column shard's SP updates its rows without
    `sp_rows` and selects its columns without `sp_select`)."""
    n = sum(counts.get(k, 0) for k in STEP_KERNELS)
    learning = counts.get("table_update", 0)
    serving = counts.get("serving_counts", 0)
    sp = n if sp_steps is None else sp_steps
    counts = {"sp_overlap": sp,
              "sp_select": sp,
              "column_decide": n,
              "seg_counts": n - serving,
              "row_counts": learning,
              "grow_select": learning,
              "learn_rows": learning,
              "sp_rows": learning,
              **counts}
    return {k.name: counts.get(k.name, 0) for k in kernels.KERNELS}


def float_ulps(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """|a - b| in float32 units in the last place, elementwise: the
    distance of the two values in the ordered int32 view of the format
    (+0.0 and -0.0 are 0 apart). Returns int64."""
    def ordered(x):
        i = x.contiguous().view(torch.int32).to(torch.int64)
        return torch.where(i < 0, -(i & 0x7FFFFFFF), i)

    return (ordered(a) - ordered(b)).abs()


def boost_agreement(duty_cycle: torch.Tensor, overlaps: torch.Tensor,
                    intensity: float, density: float, k: int,
                    device) -> dict:
    """The SP's boost factor, boosted overlaps and k winners as
    `sp_select` computes them on ``device`` (the kernel on the card) and on
    the CPU (its plain version: `boost_factor`, `boost`, `k_winners`) from
    the same (B, C) float32 duty cycles and int32 overlaps (the factor as
    the boosted value of an overlap of 1), held to the contract of ROADMAP
    fault g: the factors
    within 1 ulp, the boosted overlaps within 2, and the same k-winner
    set in every stream whose top-k boundary gap (between the k-th and
    the (k+1)-th boosted value on the CPU) exceeds 4 ulp. Returns the
    counts: values 0, 1, 2 and more ulp apart, near-tie streams (gap <= 4
    ulp), streams whose sets differ outside and at near ties, streams
    whose winner order differs, and ``ok``."""
    got = []
    for where in ("cpu", device):
        duty, ov = duty_cycle.to(where), overlaps.to(where)
        factor = sp_select(torch.ones_like(ov), duty, k, intensity, density,
                           0.0)[0]
        boosted, idx, mask, _ = sp_select(ov, duty, k, intensity, density,
                                          0.0)
        got.append([t.cpu() for t in (factor, boosted, idx, mask)])
    (f_c, v_c, i_c, m_c), (f_d, v_d, i_d, m_d) = got
    top = torch.sort(v_c, dim=-1, descending=True).values
    near = float_ulps(top[:, k - 1], top[:, k]) <= 4
    differ = (m_c != m_d).any(-1)

    def hist(u, most):
        out = {str(i): int((u == i).sum()) for i in range(most + 1)}
        out[f">{most}"] = int((u > most).sum())
        return out

    out = {
        "values": v_c.numel(),
        "factor_ulps": hist(float_ulps(f_c, f_d), 1),
        "boosted_ulps": hist(float_ulps(v_c, v_d), 2),
        "streams": v_c.shape[0],
        "near_ties": int(near.sum()),
        "sets_differ": int((differ & ~near).sum()),
        "sets_differ_at_near_ties": int((differ & near).sum()),
        "order_differs": int((i_c != i_d).any(-1).sum()),
    }
    out["ok"] = (out["factor_ulps"][">1"] == 0
                 and out["boosted_ulps"][">2"] == 0
                 and out["sets_differ"] == 0)
    return out


# the SP's defaults (config.SPConfig): boosting intensity, duty-cycle momentum
SELECT_INTENSITY, SELECT_MOMENTUM = 0.3, 0.99


def select_inputs(seed: int, B: int, C: int, kind: str = "random",
                  device="cpu") -> tuple[torch.Tensor, torch.Tensor]:
    """(B, C) int32 overlaps and float32 duty cycles for the SP's column
    selection (`regularization.sp_select`), from a generator seeded with
    ``seed`` on ``device``. "random": duty cycles uniform in [0, 0.06]
    (one in ten 0) and overlaps binomial(200, 0.1) as a bench step's;
    "ties": every duty cycle 0 (the first step) and overlaps 0-3, so that
    each stream's top-A boundary falls inside a run of equal values;
    "negative": overlaps in [-40, 40] (an overlap hook's), every seventh
    column's duty cycle 1e4, whose factor is 0 and value -0.0 where its
    overlap is negative."""
    g = torch.Generator(device=device).manual_seed(seed)
    duty = torch.rand((B, C), generator=g, device=device) * 0.06
    duty[torch.rand((B, C), generator=g, device=device) < 0.1] = 0.0
    if kind == "ties":
        duty.zero_()
        ov = torch.randint(0, 4, (B, C), generator=g, device=device)
    elif kind == "negative":
        ov = torch.randint(-40, 41, (B, C), generator=g, device=device)
        duty[:, ::7] = 1e4
    else:
        ov = torch.binomial(torch.full((B, C), 200.0, device=device),
                            torch.full((B, C), 0.1, device=device),
                            generator=g)
    return ov.to(torch.int32), duty


# The anomaly stages' kernels against their plain versions on the card
# (`chip_smoke.check_anomaly_stages`, tests/test_torch_cuda.py): the
# anomaly benchmark's shapes (examples/anomaly_benchmark.py: 1,440 steps,
# 8 tasks x 32 seeds, the likelihood's window 300 and exclude 24, the
# z-score's period 24, window 96, 3 lags, its values in float64 as the
# benchmark passes them), a step from a carried mid-ring state, a window
# off a multiple of 32 with exclude 0 (count saturating, the gates
# crossed), one stream, 65,537 streams, rings past shared memory
# (`kernels._ring`: the "global" path) and 5 lags.
# likelihood: name -> (T, B, W, R, carried)
LIKELIHOOD_CASES = {
    "bench": (1440, 256, 300, 24, False),
    "T=1 carried": (1, 256, 300, 24, True),
    "W=75 exclude 0": (300, 64, 75, 0, False),
    "B=1": (400, 1, 300, 24, False),
    "B=65,537 carried": (40, 65_537, 40, 10, True),
    "global ring carried": (60, 4, 60_000, 24, True),
}
# z-score: name -> (T, B, P, W, lags, carried, float64 values)
ZSCORE_CASES = {
    "bench": (1440, 256, 24, 96, 3, False, True),
    "T=1 carried": (1, 256, 24, 96, 3, True, True),
    "W=50 f32": (200, 64, 12, 50, 3, False, False),
    "5 lags": (200, 16, 6, 40, 5, False, False),
    "B=1": (300, 1, 24, 96, 3, False, True),
    "B=65,537 carried": (40, 65_537, 4, 20, 3, True, False),
    "global ring carried": (60, 4, 24, 58_100, 3, True, False),
}
ANOMALY_A = 16  # the anomaly benchmark's active columns: scores k / 16


def likelihood_inputs(seed: int, T: int, B: int, W: int, R: int,
                      carried: bool, device="cpu") -> tuple:
    """(state or None, (T, B) float32 scores) for the likelihood. The
    scores take the values an HTM step gives at A = 16 active columns,
    k * f32(1/16): steady streams of low scores with bursts and single
    spikes. A carried state holds such scores in its ring, pos anywhere
    in [0, W), count anywhere in [0, W] (stream 0 one step from
    saturating, stream 1 one step from the warm-up gate R + 10, stream 2
    saturated) and any short mean."""
    rng = np.random.RandomState(seed)
    unit = np.float32(1.0 / ANOMALY_A)

    def scores(*shape):
        k = rng.binomial(3, 0.3, shape)
        k = np.where(rng.rand(*shape) < 0.03, ANOMALY_A, k)
        return k.astype(np.float32) * unit

    x = scores(T, B)
    for b in range(min(B, 64)):
        at = rng.randint(0, max(T - 10, 1))
        x[at:at + rng.randint(3, 20), b] = unit * rng.randint(8, 17)
    state = None
    if carried:
        count = rng.randint(0, W + 1, B).astype(np.int32)
        count[:3] = (W - 1, R + 9, W)[:B]
        state = tuple(torch.from_numpy(a).to(device) for a in (
            scores(B, W), rng.randint(0, W, B).astype(np.int32), count,
            rng.uniform(0, 1, B).astype(np.float32)))
    return state, torch.from_numpy(x).to(device)


def zscore_inputs(seed: int, T: int, B: int, P: int, W: int, lags: int,
                  carried: bool, f64: bool, device="cpu") -> tuple:
    """(state or None, (T, B) values) for the seasonal z-score: a sine of
    period P with noise, drift, a spike and a level shift, in float64
    where ``f64``. A carried state holds such values and residuals, its
    pos anywhere in [0, L + W + T) (stream 0 one step before L, stream 1
    one before L + W)."""
    rng = np.random.RandomState(seed)
    L = lags * P
    t = np.arange(T)[:, None] + rng.randint(0, P, B)
    v = (np.sin(2 * np.pi * t / P) + rng.normal(0, 0.1, (T, B))
         + np.linspace(0, 0.5, T)[:, None])
    v[T // 2, ::7] += 1.9
    v[2 * T // 3:, 1::5] += 0.4
    state = None
    if carried:
        pos = rng.randint(0, L + W + T, B).astype(np.int32)
        pos[:2] = (L - 1, L + W - 1)[:B]
        state = tuple(torch.from_numpy(a).to(device) for a in (
            rng.normal(0, 1, (B, L)).astype(np.float32),
            rng.normal(0, 0.3, (B, W)).astype(np.float32), pos))
    return state, torch.from_numpy(v if f64 else v.astype(np.float32)).to(
        device)


def run_ranks(commands: list[list[str]], log_dir: str, timeout: float,
              until=None, cwd: str | None = None
              ) -> tuple[list, list[str]]:
    """Starts one process a rank (``commands[r]``, output to
    ``log_dir/rank<r>.log``) and waits until every one has exited, one
    has failed, ``until(outputs)`` holds (``outputs``: each rank's output
    so far) or ``timeout`` seconds have passed; then kills every process
    still running (SIGKILL) and reaps it. Returns (each rank's return
    code, negative where it was killed; each rank's output)."""
    paths = [os.path.join(log_dir, f"rank{r}.log")
             for r in range(len(commands))]

    def outputs():
        out = []
        for path in paths:
            with open(path, errors="replace") as f:
                out.append(f.read())
        return out

    procs = []
    try:
        for cmd, path in zip(commands, paths):
            with open(path, "w") as log:
                procs.append(subprocess.Popen(cmd, stdout=log,
                                              stderr=subprocess.STDOUT,
                                              cwd=cwd))
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            codes = [p.poll() for p in procs]
            if (all(c is not None for c in codes)
                    or any(c not in (None, 0) for c in codes)
                    or (until is not None and until(outputs()))):
                break
            time.sleep(0.1)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            p.wait()
    return [p.returncode for p in procs], outputs()


# the config-fuzz geometries of tests/test_parity_fuzz.py, each on a
# dispatch or encoding boundary of the step: cell_dim off the 32-bit
# word, K across the packed activity's dtype lines (u8 to K=125, bf16 at
# 126-127, float32 from 128), lane-unfriendly J = G*K, column_dim % 8 !=
# 0, A at the JAX matchers' crossovers, tight pools under both policies
FUZZ_BASE = dict(
    column_dim=64, cell_dim=4, active_columns=6, segments_per_column=4,
    synapse_capacity=12, segment_activation_threshold=2,
    segment_matching_threshold=2, segment_sampling_synapses=4,
    # incommensurate constants: no permanence lands exactly on 0.0
    permanence_initial=0.2137, permanence_increment=0.1003,
    permanence_decrement=0.0997, permanence_punishment=0.0251)

# (name, config overrides, steps)
FUZZ_CASES = [
    ("D3_W1_partial", dict(cell_dim=3), 60),
    ("D24_W1_partial", dict(cell_dim=24), 50),
    ("D33_W2_minimal", dict(cell_dim=33), 50),
    ("D48_W2_partial", dict(cell_dim=48, column_dim=48,
                            active_columns=5), 50),
    ("D64_W2_full", dict(cell_dim=64, column_dim=32), 40),
    ("K125_last_u8", dict(synapse_capacity=125, segments_per_column=2,
                          segment_sampling_synapses=6), 40),
    ("K126_first_bf16", dict(synapse_capacity=126, segments_per_column=2,
                             segment_sampling_synapses=6), 40),
    ("K127_last_bf16", dict(synapse_capacity=127, segments_per_column=2,
                            segment_sampling_synapses=6), 40),
    ("K128_first_f32", dict(synapse_capacity=128, segments_per_column=2,
                            segment_sampling_synapses=6), 40),
    ("J120_G3K40", dict(segments_per_column=3, synapse_capacity=40), 50),
    ("J66_G2K33", dict(segments_per_column=2, synapse_capacity=33,
                       segment_sampling_synapses=5), 50),
    ("C37_fallback", dict(column_dim=37, active_columns=5), 60),
    ("C250_fallback", dict(column_dim=250, active_columns=9), 40),
    ("A47_hash_edge", dict(column_dim=128, active_columns=47), 30),
    ("A48_chain_edge", dict(column_dim=128, active_columns=48), 30),
    ("A63_chain_edge", dict(column_dim=192, active_columns=63), 30),
    ("A64_bisect_edge", dict(column_dim=192, active_columns=64), 30),
    ("D5_G1_recycle", dict(cell_dim=5, segments_per_column=1), 60),
    ("D7_G2_evict", dict(cell_dim=7, segments_per_column=2,
                         allocation_policy="evict", synapse_capacity=9,
                         segment_sampling_synapses=3), 60),
    ("D7_G2_reference", dict(cell_dim=7, segments_per_column=2,
                             allocation_policy="reference",
                             synapse_capacity=9,
                             segment_sampling_synapses=3), 60),
    ("C44_D36_odd_both", dict(column_dim=44, cell_dim=36,
                              active_columns=7), 50),
    ("K13_prime_slots", dict(synapse_capacity=13,
                             segment_sampling_synapses=5), 50),
]


def fuzz_config(**overrides) -> TMConfig:
    """The port's TMConfig of a fuzz case: `FUZZ_BASE` with
    ``overrides``."""
    return TMConfig(**{**FUZZ_BASE, **overrides})


def fuzz_seed(name: str) -> int:
    """A fuzz case's seed: fixed by its name, distinct between cases."""
    return sum(ord(ch) * 131 ** i for i, ch in enumerate(name)) % 10_000


def fuzz_cols(cfg: TMConfig, B: int, rng: np.random.RandomState
              ) -> np.ndarray:
    """One step's (B, A) sorted active columns, each stream A distinct
    columns drawn from ``rng`` (the oracle tests' columns)."""
    return np.stack([np.sort(rng.choice(cfg.column_dim,
                                        size=cfg.active_columns,
                                        replace=False))
                     for _ in range(B)]).astype(np.int32)
