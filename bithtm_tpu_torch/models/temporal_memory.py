"""Batched TemporalMemory step.

Counterpart of `bithtm_tpu/models/temporal_memory.py` (reference
`networks.py:91-128`, `projections.py:245-293`), written out over a
leading stream axis B instead of vmapped. The order of one step:

  1. bursting from the previous prediction        (`networks.py:96-97`)
  2. winner-cell selection, with jittered ties     (`networks.py:100-104`)
  3. learning in the A active-column rows: permanence update and death,
     segment allocation, synapse growth            (`networks.py:106-113`)
  4. activation (predicted | bursting)             (`networks.py:115-119`)
  5. the full-table pass: punishment of matching segments in inactive
     columns and the forward activity -> next prediction
     (`networks.py:121-127`); `ops.active_set.table_update` runs it
     through the CUDA kernel on the card.

Steps 1-2, step 4's words and the decisions of step 3 (the learning
flags and the segment allocation) are one pass over the active columns,
`column_decide` (the `column_decide` kernel on the card), between the
active rows' counts (`row_counts`) and the rows' own passes
(`grow_select`, `learn_rows`).

Growth picks its random candidates by one packed integer key a
candidate: the cell id below the random bits up to 2^16 cells, the
candidate's list index above (16K x 64), decoded after the selection by
`take_small_table` (the `small_table_take` kernel on the card).

Inference runs step 5 as a forward pass only, over the synapse tables,
a frozen word table (`frozen_word=`) or a compact serving table
(`serving_table=`); `tm_resume` re-derives the carries a compact serving
run leaves stale.

Random draws come from a provider (`rng.py`), so the tests can replay
the JAX draws. The synapse tables are updated in place: the state
passed in is consumed, as the JAX scan donates its carry.

Rows are written back with plain scatters where the JAX step uses
clipped takes, dropped scatters and a one-hot dot (TPU workarounds);
scatters that the JAX step drops go to a padding row that is sliced off,
so no index is written twice.

Under a column shard (`ops/shard.py`: a model-parallel rank holds C/n
columns of every C-indexed leaf) every rank takes the rows of the A
active columns from their owners in one exchange, runs steps 1-4 on the
same rows with the same draws (so every decision is the unsharded
step's), writes back only the rows it owns, runs the full-table pass on
its own rows over the global cell space, and counts the metrics that sum
over C on its own columns (`htm_step` sums them across the group).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from ..config import TMConfig
from ..ops.active_set import (
    _on_device,
    argmax_onehot,
    column_mask_from_cols,
    compact_first_k,
    pack_bits,
    pack_bits_ref,
    percell_max,
    percell_sum,
    prediction_dense,
    prediction_words,
    rank_ascending,
    seg_counts_flags,
    seg_counts_packed_rows,
    synapse_activation_conn,
    synapse_activation_frozen,
    table_update,
    take_percell,
    take_small_table,
    unpack_bits,
)
from ..ops.bitops import lsr32, popcount32
from ..ops.serving import ServingTable, serving_flags
from ..ops.shard import ColumnShard
from ..rng import Draws
from ..state import TMState
from ..utils.profiling import site

# the index-keyed growth key (above 2^16 cells) holds the candidate's
# list index below bit 30; invalid keys sort last
PACKED_IDX_SENTINEL = 0x7FFFFFFF
# the metrics that sum over the columns: a column shard's tm_step counts
# its own columns and `htm_step` sums them across the model group (the
# others are counted in active-column space, the same on every rank)
COLUMN_SUMS = ("tm_punished_segments", "tm_punished_columns",
               "tm_predicted_cells", "tm_matching_segments",
               "tm_pool_occupancy")


class TMOutput(NamedTuple):
    """Per-step observables (`networks.py:39-46`). The dense (B, N)
    masks are built only on request (`dense_outputs`); `htm_scan` reads
    only `prev_col_prediction` and `bursting_columns`."""

    active_mask: torch.Tensor | None       # (B, N) bool
    winner_mask: torch.Tensor | None       # (B, N) bool
    prediction: torch.Tensor | None        # (B, N) bool, for the next step
    prev_prediction: torch.Tensor | None   # (B, N) bool, this step's input
    prev_col_prediction: torch.Tensor      # (B, C) bool any cell predicted
    bursting_columns: torch.Tensor         # (B, C) bool
    metrics: dict


class TMDebug(NamedTuple):
    """The decision trace of a step (`tm_step(return_debug=True)`), for
    the oracle (`bithtm_tpu_torch/oracle`): every choice that depends on
    a random draw, per stream. All False on a step that does not learn."""

    winner_mask: torch.Tensor        # (B, N) bool
    learning_segments: torch.Tensor  # (B, C, G) bool, new ones included
    punished_segments: torch.Tensor  # (B, C, G) bool
    new_segments: torch.Tensor       # (B, C, G) bool, allocated this step
    grown_mask: torch.Tensor         # (B, C, G, K) bool, slots grown
    synapse_cell: torch.Tensor       # (B, C, G, K) int32 after the step
    seg_cell: torch.Tensor           # (B, C, G) int32 after the step


def _rows(table: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """(B, C, ...) table at (B, A) columns -> (B, A, ...)."""
    idx = cols.long().reshape(*cols.shape, *([1] * (table.dim() - 2)))
    return table.gather(1, idx.expand(*cols.shape, *table.shape[2:]))


def _put_rows(table: torch.Tensor, cols: torch.Tensor,
              rows: torch.Tensor) -> torch.Tensor:
    """Write (B, A, ...) rows into the (B, C, ...) table in place at the
    (distinct) columns ``cols``."""
    idx = cols.long().reshape(*cols.shape, *([1] * (table.dim() - 2)))
    return table.scatter_(1, idx.expand_as(rows), rows)


def _dense(cols: torch.Tensor, rows: torch.Tensor,
           column_dim: int) -> torch.Tensor:
    """(B, A) cols + (B, A, ...) rows -> (B, C, ...) zero elsewhere."""
    out = rows.new_zeros((rows.shape[0], column_dim, *rows.shape[2:]))
    return _put_rows(out, cols, rows)


def _winner_selection(cfg: TMConfig, draws: Draws, pred_rows, pot_rows,
                      segcell_rows):
    """Steps 1-2 in active-column space (`temporal_memory.py:106-161`),
    from the (B, A, G) potential of the active rows (`row_counts`) and
    their owner cells. Returns (col_burst (B, A), winner_rows (B, A, D),
    cell_max_j (B, A, D), seg_j (B, A, G))."""
    D = cfg.cell_dim
    col_burst = ~pred_rows.any(-1)
    match_rows = pot_rows >= cfg.segment_matching_threshold

    # jittered best matching segment per cell (networks.py:73-82)
    seg_j = torch.where(match_rows,
                        pot_rows.to(torch.float32) + draws.u_seg, 0.0)
    cell_max_j = percell_max(segcell_rows, seg_j, D, 0.0)
    col_matching = cell_max_j.amax(-1) >= cfg.segment_matching_threshold

    # jittered least-used cell (networks.py:84-89)
    seg_count = percell_sum(segcell_rows, torch.ones_like(segcell_rows),
                            D).to(torch.float32)
    least_j = seg_count + draws.u_least

    # a bursting column picks exactly one winner (networks.py:102-104)
    burst_score = torch.where(col_matching[..., None], cell_max_j,
                              -least_j)
    winner_rows = pred_rows | (col_burst[..., None]
                               & argmax_onehot(burst_score))
    return col_burst, winner_rows, cell_max_j, seg_j


def _allocate(cfg: TMConfig, segcell_rows, syn_count, match_rows, unacc):
    """Segment allocation for unaccounted winner cells, by deterministic
    rank pairing (`temporal_memory.py:164-218`): eligible slots ordered
    recyclable-allocated, then unallocated, then (policy "evict") mature
    non-matching slots by ascending live count ``syn_count`` (B, A, G),
    the live slots after the stale cleanup (`row_counts`); the i-th
    unaccounted cell takes the i-th slot. Returns (new_seg (B, A, G),
    new_owner (B, A, G), n_dropped (B,), n_evicted (B,))."""
    D, G = cfg.cell_dim, cfg.segments_per_column
    recyclable = syn_count < cfg.segment_matching_threshold
    unallocated = segcell_rows >= D
    g = torch.arange(G, dtype=torch.int32, device=syn_count.device)
    key = g + G * unallocated.to(torch.int32)
    if cfg.allocation_policy == "evict":
        evictable = ~match_rows & ~recyclable
        key = torch.where(recyclable, key, 2 * G + syn_count * G + g)
        eligible = recyclable | evictable
    else:
        evictable = torch.zeros_like(recyclable)
        eligible = recyclable
    # rank among eligible slots by ascending key (keys are distinct)
    elig_rank = torch.where(
        eligible,
        ((key[..., :, None] > key[..., None, :])
         & eligible[..., None, :]).sum(-1, dtype=torch.int32),
        -1)
    un_rank = torch.where(unacc, rank_ascending(unacc), -2)      # (B, A, D)
    assign = (eligible[..., :, None] & unacc[..., None, :]
              & (elig_rank[..., :, None] == un_rank[..., None, :]))
    new_seg = assign.any(-1)
    d = torch.arange(D, dtype=torch.int32, device=syn_count.device)
    new_owner = (assign * d).sum(-1, dtype=torch.int32)
    n_dropped = (unacc.sum((1, 2), dtype=torch.int32)
                 - assign.sum((1, 2, 3), dtype=torch.int32))
    n_evicted = (new_seg & evictable).sum((1, 2), dtype=torch.int32)
    return new_seg, new_owner, n_dropped, n_evicted


# the per-stream counts of `column_decide`, in the order of its counts'
# rows: the first three in every mode, all seven in a learning step
DECIDE_COUNTS = ("tm_bursting_columns", "tm_active_cells", "tm_winner_cells",
                 "tm_new_segments", "tm_learning_segments",
                 "tm_dropped_new_segments", "tm_evicted_segments")


class ColumnDecisions(NamedTuple):
    """What `column_decide` gives the step: the activity words (predicted
    | bursting) and the winner words (B, A, W) int32, the bursting columns
    (B, A) bool, the learning and new-segment flags (B, A*G) bool (a
    learning step's, else None) and the per-stream counts of
    DECIDE_COUNTS, (7 or 3, B) int32."""

    act_bits: torch.Tensor
    winner_bits: torch.Tensor
    col_burst: torch.Tensor
    learn: torch.Tensor | None
    new_seg: torch.Tensor | None
    counts: torch.Tensor


def column_decide_ref(cfg: TMConfig, prediction, seg_cell, cols, pot, conn,
                      live, draws: Draws | None, step,
                      mode: str) -> ColumnDecisions:
    """Plain version of the `column_decide` kernel: steps 1-2 and the
    decisions of step 3 in active-column space, from the previous
    prediction words ``prediction`` (B, W, Ct) and the owners ``seg_cell``
    (B, Ct, G) at the (B, A) columns ``cols``, or of gathered rows
    (``cols`` None, Ct = A), the active rows' `row_counts` ``pot``,
    ``conn`` and ``live`` (B, A, G), the ``draws`` and the streams'
    ``step`` (B,). ``mode`` (`kernels.DECIDE_MODES`): "burst", the
    bursting columns and the activity only (no winner cells); "winner",
    `_winner_selection` too; "learn", also `_learn`'s flags and
    `_allocate` (`temporal_memory.py:106-218`, `:501-596`), the new owners
    written over ``seg_cell`` in place (a no-op on step 0,
    `projections.py:258-259`). Returns `ColumnDecisions`."""
    D = cfg.cell_dim
    B = prediction.shape[0]
    if cols is None:
        pred_words, segcell_rows = prediction, seg_cell
    else:
        W, A = prediction.shape[1], cols.shape[1]
        pred_words = prediction.gather(
            2, cols.long()[:, None, :].expand(B, W, A))
        segcell_rows = None if mode == "burst" else _rows(seg_cell, cols)
    pred_rows = unpack_bits(pred_words.transpose(1, 2), D)      # (B, A, D)
    if mode == "burst":
        col_burst = ~pred_rows.any(-1)
        winner_rows = torch.zeros_like(pred_rows)
    else:
        col_burst, winner_rows, cell_max_j, seg_j = _winner_selection(
            cfg, draws, pred_rows, pot, segcell_rows)
    # activation: predicted cells + whole bursting columns
    act_rows = pred_rows | col_burst[..., None]
    counts = [col_burst.sum(-1, dtype=torch.int32),
              act_rows.sum((1, 2), dtype=torch.int32),
              winner_rows.sum((1, 2), dtype=torch.int32)]
    learn = new_seg = None
    if mode == "learn":
        has_prev = (step > 0)[:, None, None]
        match_rows = pot >= cfg.segment_matching_threshold
        active_seg_rows = match_rows & (
            conn >= cfg.segment_activation_threshold)
        owner_pred = take_percell(pred_rows, segcell_rows, D, False)
        owner_winner = take_percell(winner_rows, segcell_rows, D, False)
        owner_max = take_percell(cell_max_j, segcell_rows, D, 0.0)
        seg_best = match_rows & ((seg_j - owner_max).abs() < cfg.epsilon)
        learn = (match_rows & owner_winner
                 & (active_seg_rows | (~owner_pred & seg_best)) & has_prev)
        # segment allocation for unaccounted winners (recycle first)
        unacc = winner_rows & (cell_max_j < cfg.epsilon) & has_prev
        new_seg, new_owner, n_dropped, n_evicted = _allocate(
            cfg, segcell_rows, live, match_rows, unacc)
        segcell_rows = torch.where(new_seg, new_owner, segcell_rows)
        learn = learn | new_seg
        if cols is None:
            seg_cell.copy_(segcell_rows)
        else:
            _put_rows(seg_cell, cols, segcell_rows)
        counts += [new_seg.sum((1, 2), dtype=torch.int32),
                   learn.sum((1, 2), dtype=torch.int32), n_dropped,
                   n_evicted]
        learn, new_seg = learn.reshape(B, -1), new_seg.reshape(B, -1)
    return ColumnDecisions(pack_bits_ref(act_rows), pack_bits_ref(winner_rows),
                           col_burst, learn, new_seg, torch.stack(counts))


def column_decide(cfg: TMConfig, prediction, seg_cell, cols, pot, conn,
                  live, draws: Draws | None, step,
                  mode: str) -> ColumnDecisions:
    """The column decisions of a step: the `column_decide` kernel for
    CUDA tensors, the plain version for CPU tensors (arguments and
    results as `column_decide_ref`'s)."""
    if _on_device("column_decide", prediction) == "cuda":
        from ..ops.kernels import column_decide_cuda

        u_seg, u_least = ((None, None) if draws is None else
                          (draws.u_seg.contiguous(),
                           draws.u_least.contiguous()))
        return ColumnDecisions(*column_decide_cuda(
            prediction, seg_cell, cols, pot, conn, live, u_seg, u_least,
            step, cfg.cell_dim, mode, cfg.segment_matching_threshold,
            cfg.segment_activation_threshold, cfg.epsilon,
            cfg.allocation_policy == "evict"))
    return column_decide_ref(cfg, prediction, seg_cell, cols, pot, conn,
                             live, draws, step, mode)


def _select_keys(pkey, valid, n_grow, samp: int, index_form: bool):
    """The selection of `_select_and_fill`: per row, the kk = min(samp,
    Wc) smallest keys, ascending, invalid keys replaced by the sentinel,
    and n_chosen = min(n_grow, the valid count). The cell-form keys sort
    as int64 against the sentinel 2^32 - 1 (a valid key is below 2^31 and
    may be exactly 0x7FFFFFFF at 2^16 cells, so an int32 sort against
    0xFFFFFFFF, which reads as -1, would put the invalid keys first; torch's
    CPU sort has no uint32). The index-form keys are int32 below 2^30
    with the sentinel 0x7FFFFFFF; valid keys are distinct (the index sits
    in the low bits), so the kk smallest of `torch.topk` are the keys the
    JAX split-block sort selects, in the same order, and sentinels tie
    but are equal values. Returns (sorted keys (B, L, kk), n_chosen (B,
    L))."""
    kk = min(samp, pkey.shape[-1])
    n_chosen = torch.minimum(n_grow, valid.sum(-1, dtype=torch.int32))
    if not index_form:
        keys = torch.where(valid, pkey, (1 << 32) - 1)
        return torch.sort(keys, dim=-1).values[..., :kk], n_chosen
    keys = torch.where(valid, pkey, PACKED_IDX_SENTINEL)
    return torch.topk(keys, kk, dim=-1, largest=False,
                      sorted=True).values, n_chosen


def _fill(chosen_cell, n_chosen, free):
    """The free-slot fill: slot k of a row takes the free_rank[k]-th
    chosen cell where free_rank[k] < n_chosen. Returns (gathered (B, L,
    K), wrote_l (B, L, K))."""
    free_rank = rank_ascending(free)                            # (B, L, K)
    pick = free_rank.clamp(0, chosen_cell.shape[-1] - 1).long()
    gathered = chosen_cell.gather(-1, pick)
    wrote_l = free & (free_rank < n_chosen[..., None])
    return gathered, wrote_l


def _select_and_fill(pkey, valid, n_grow, free, samp: int, low_bits: int,
                     cand_cell=None):
    """`_select_and_fill` (`temporal_memory.py:221-347`): per row, the
    ``n_grow`` smallest valid keys, written into the first free slots.

    Without ``cand_cell``, `sortfill_packed_cell`: the low ``low_bits``
    bits of a key are the cell, and the keys are int64 (`_select_keys`).
    With ``cand_cell`` (B, Wc), `sortfill_packed_idx`: the low bits are
    the candidate's list index, decoded to its cell by `take_small_table`
    in place of the keys, which masks them itself and reads the list
    where it lies (one launch on the card, no copy); the keys are int32.
    Sentinel keys decode to cells that land only in slots ``wrote_l``
    never writes.

    ``n_valid`` counts the mask. Returns (gathered (B, L, K), wrote_l
    (B, L, K), n_chosen (B, L))."""
    low = (1 << low_bits) - 1
    sorted_key, n_chosen = _select_keys(pkey, valid, n_grow, samp,
                                        cand_cell is not None)
    if cand_cell is None:
        chosen_cell = (sorted_key & low).to(torch.int32)
    else:
        chosen_cell = take_small_table(cand_cell, sorted_key, low,
                                       in_place=True)
    gathered, wrote_l = _fill(chosen_cell, n_chosen, free)
    return gathered, wrote_l, n_chosen


def growth_key_form(n_cells: int, Wc: int) -> tuple[bool, int]:
    """The growth key's form and low bits: the cell id with >= 15 random
    bits above it up to 2^16 cells (True, cell bits), else the
    candidate's list index, random bits in [idx_bits, 29] (False, index
    bits of Wc)."""
    cell_bits = max(1, (n_cells - 1).bit_length())
    if 31 - cell_bits >= 15:
        return True, cell_bits
    return False, max(1, (Wc - 1).bit_length())


def growth_keys_ref(syn_rows, act_rows, lidx, lvalid, cand_cell,
                    cand_valid, n_winners_eff, rnd, samp: int,
                    key_bits: int, cell_form: bool, raw: bool = False):
    """The packed growth keys of `grow_select_ref` (JAX `_grow`,
    `temporal_memory.py:350-498`): per growing row, the (B, L, Wc) keys
    (int64 in the cell form, int32 in the index form), which of them are
    valid (in the list and not already a target of the row) and the
    row's n_grow (B, L). Arguments as `grow_select_ref`'s; ``raw``: the
    rows are read before the learning pass, so the existing targets are
    the active live slots whatever samp. That equals JAX's every live
    slot at samp >= K only where ``act_rows`` is the activity that the
    previous table pass computed on these tables (see
    `grow_select_ref`)."""
    B, R, K = syn_rows.shape
    L, Wc = lidx.shape[-1], cand_cell.shape[-1]
    take = lidx.long().clamp(max=R - 1)[..., None].expand(B, L, K)
    syn_l = syn_rows.gather(1, take)                            # clipped
    act_l = act_rows.gather(1, take)
    live_l = syn_l >= 0
    row_potential = (act_l & live_l).sum(-1, dtype=torch.int32)  # (B, L)
    n_grow = torch.where(
        lvalid,
        torch.minimum(torch.clamp(samp - row_potential, min=0),
                      torch.clamp(n_winners_eff, max=samp)[:, None]),
        0)

    # existing targets: only active live synapses can target a candidate,
    # and only rows with potential < samp grow, so the first samp active
    # targets suffice (temporal_memory.py:425-449)
    if samp < K or raw:
        act_valid = act_l & live_l
        r_act = rank_ascending(act_valid)
        r_act = torch.where(act_valid & (r_act < samp), r_act, samp)
        syn_cmp = torch.full((B, L, samp + 1), -1, dtype=torch.int32,
                             device=syn_rows.device)
        syn_cmp.scatter_(-1, r_act.long(), syn_l)
        syn_cmp = syn_cmp[..., :samp]
    else:
        syn_cmp = syn_l
    existing = (syn_cmp[..., :, None]
                == cand_cell[:, None, None, :]).any(-2)          # (B, L, Wc)
    valid = cand_valid[:, None, :] & ~existing
    # random bits above what identifies the candidate (logical shifts:
    # rnd carries 32 bits in int32)
    if cell_form:
        pkey = ((lsr32(rnd, key_bits + 1).to(torch.int64) << key_bits)
                | cand_cell[:, None, :].to(torch.int64))
    else:
        pkey = ((lsr32(rnd, key_bits + 2) << key_bits)
                | torch.arange(Wc, dtype=torch.int32, device=rnd.device))
    return pkey, valid, n_grow


class GrowSelection(NamedTuple):
    """What `grow_select` gives `learn_rows`: the selection (chosen (B,
    L, kk) int32, kk = min(samp, Wc): the cells, or the index-form keys,
    of each row's n_chosen smallest keys, ascending, defined up to
    n_chosen (B, L) int32), the lists it selected from (lidx (B, L)
    int32, the growing rows' slot ids, the row count R past the valid
    ones; lvalid (B, L) bool; lpos (B, R) int32, each row's place in the
    list, -1 where it has none; cand_cell (B, Wc) int32, the candidates,
    0 past the valid ones) and counts (4, B) int32: 0 and 0 (`learn_rows`
    adds the slots grown and the overflow), the winners past Wc and the
    growing rows past L."""

    chosen: torch.Tensor
    n_chosen: torch.Tensor
    lidx: torch.Tensor
    lvalid: torch.Tensor
    lpos: torch.Tensor
    cand_cell: torch.Tensor
    counts: torch.Tensor


# the rows of GrowSelection.counts, in `_grow`'s order
N_GROWN, OVERFLOW, WINNERS_DROPPED, GROWTH_DROPPED = range(4)


def _active_rows(table: torch.Tensor, cols, R: int) -> torch.Tensor:
    """The R = A*G active rows (B, R, K) of a (B, Ct, G*K) table: at the
    (B, A) columns ``cols``, or the table's own rows where ``cols`` is
    None (gathered rows, Ct = A)."""
    rows = table if cols is None else _rows(table, cols)
    return rows.reshape(rows.shape[0], R, -1)


def grow_select_ref(syn_rows, act_rows, learn_rows, prev_cols,
                    prev_winner_bits, rnd, cell_dim: int, samp: int,
                    key_bits: int, cell_form: bool, row_cols=None,
                    new_seg=None) -> GrowSelection:
    """Plain version of the `grow_select` kernel, `_grow` up to its fill:
    for the R active rows of a (B, Ct, J) synapse table ``syn_rows``
    (int32, -1 free) and its activity ``act_rows`` (bool or the packed
    activity; nonzero = active), at the (B, R/G) columns ``row_cols`` or
    the table's own rows where it is None (a (B, R, K) table of rows),
    the rows of ``new_seg`` (B, R) read as empty, the (B, R) bool learning
    flags ``learn_rows``, the (B, A) previous active columns
    ``prev_cols`` (ascending) and their (B, A, W) int32 winner words, and
    (B, L, Wc) int32 random words ``rnd``: the candidate list (the first
    Wc previous winner cells, ascending), the growing rows (the first L
    learning flags) and, for each, n_grow = clip(samp - active potential,
    0, min(samp, n_winners capped at Wc)) candidates it does not already
    target, the n_grow smallest by packed key (``cell_form`` with
    ``key_bits`` cell bits, else the index form). Returns
    `GrowSelection`.

    With ``new_seg`` the rows are the table's before the step's stale
    cleanup and death: those change only slots with no activity (a stale
    slot's activity is 0, and death follows a decrement, which only an
    inactive slot takes), and only active live slots count here: where
    samp >= K, where JAX counts every live slot as a target, too, since
    every live slot that targets a candidate (a previous active cell) is
    active in the activity computed on the same table.

    Precondition: ``act_rows`` is that activity, the one the previous
    step's table pass (or `tm_resume`) wrote for these tables and the
    previous active cells. A state served from a compact table
    (`htm_serve_scan` with a ``serving_table``) carries a stale activity,
    so it must go through `resume_learning` before it learns, as in the
    JAX package; without it the selection may differ from JAX's."""
    R = learn_rows.shape[1]
    syn_rows = _active_rows(syn_rows, row_cols, R)
    act_rows = _active_rows(act_rows, row_cols, R) != 0
    if new_seg is not None:
        syn_rows = torch.where(new_seg[..., None], -1, syn_rows)
        act_rows = act_rows & ~new_seg[..., None]
    B = syn_rows.shape[0]
    A = prev_cols.shape[1]
    L, Wc = rnd.shape[1:]
    D, dev = cell_dim, syn_rows.device
    n_winners = popcount32(prev_winner_bits).sum((1, 2), dtype=torch.int32)
    grid_cell = (prev_cols[..., None] * D
                 + torch.arange(D, dtype=torch.int32, device=dev)
                 ).reshape(B, A * D)
    grid_valid = unpack_bits(prev_winner_bits, D).reshape(B, A * D)
    cand_cell, cand_valid = compact_first_k(grid_valid, grid_cell, Wc)
    n_winners_eff = torch.clamp(n_winners, max=Wc)
    slots = torch.arange(R, dtype=torch.int32, device=dev).expand(B, R)
    lidx, lvalid = compact_first_k(learn_rows, slots, L)
    lidx = torch.where(lvalid, lidx, R)
    rank = rank_ascending(learn_rows)
    lpos = torch.where(learn_rows & (rank < L), rank, -1)
    pkey, valid, n_grow = growth_keys_ref(
        syn_rows, act_rows, lidx, lvalid, cand_cell, cand_valid,
        n_winners_eff, rnd, samp, key_bits, cell_form,
        raw=new_seg is not None)
    chosen, n_chosen = _select_keys(pkey, valid, n_grow, samp,
                                    not cell_form)
    if cell_form:
        chosen = (chosen & ((1 << key_bits) - 1)).to(torch.int32)
    zero = torch.zeros_like(n_winners)
    counts = torch.stack([
        zero, zero, n_winners - n_winners_eff,
        learn_rows.sum(-1, dtype=torch.int32)
        - lvalid.sum(-1, dtype=torch.int32)])
    return GrowSelection(chosen, n_chosen, lidx, lvalid, lpos,
                         cand_cell.contiguous(), counts)


def grow_select(syn_rows, act_rows, learn_rows, prev_cols,
                prev_winner_bits, rnd, cell_dim: int, samp: int,
                key_bits: int, cell_form: bool, row_cols=None,
                new_seg=None) -> GrowSelection:
    """`_grow`'s lists and selection: the `grow_select` kernel for CUDA
    tensors, the plain version for CPU tensors (arguments and results as
    `grow_select_ref`'s; chosen is defined up to n_chosen)."""
    args = (syn_rows, act_rows, learn_rows, prev_cols, prev_winner_bits,
            rnd, cell_dim, samp, key_bits, cell_form, row_cols, new_seg)
    if _on_device("grow_select", syn_rows) == "cuda":
        from ..ops.kernels import grow_select_cuda

        return GrowSelection(*grow_select_cuda(*args))
    return grow_select_ref(*args)


def row_counts_ref(syn, perm, act, cols, num_segments: int
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the `row_counts` kernel: the (B, A, G) int32
    counts of the active rows of the (B, Ct, G*K) synapse tables (syn,
    perm and the packed activity act) at the (B, A) columns ``cols``, or
    of gathered rows (``cols`` None, Ct = A): the potential and connected
    counts (the exact decode of the activity, `seg_counts_packed_rows`)
    and the live count, the slots with syn >= 0 and not perm < 0 (those
    live after the stale cleanup). Returns (potential, connected,
    live)."""
    B, Ct = syn.shape[:2]
    A = Ct if cols is None else cols.shape[1]
    R = A * num_segments
    syn_r, perm_r, act_r = (_active_rows(t, cols, R).reshape(
        B, A, num_segments, -1) for t in (syn, perm, act))
    potential, connected = seg_counts_packed_rows(act_r, act_r.shape[-1])
    live = ((syn_r >= 0) & ~(perm_r < 0.0)).sum(-1, dtype=torch.int32)
    return potential, connected, live


def row_counts(syn, perm, act, cols, num_segments: int
               ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The active rows' (potential, connected, live) counts: the
    `row_counts` kernel for CUDA tensors, the plain version for CPU
    tensors (arguments and results as `row_counts_ref`'s)."""
    if _on_device("row_counts", syn) == "cuda":
        from ..ops.kernels import row_counts_cuda

        return row_counts_cuda(syn, perm, act, cols, num_segments)
    return row_counts_ref(syn, perm, act, cols, num_segments)


def learn_rows_ref(syn, perm, act, cols, learn, new_seg, lpos, chosen,
                   n_chosen, counts, increment: float, decrement: float,
                   permanence_initial: float, want_mask: bool = False):
    """Plain version of the `learn_rows` kernel: the learning pass over
    the R = A*G active rows of the (B, Ct, G*K) synapse tables ``syn``
    (int32) and ``perm`` (float32), updated in place, at the (B, A)
    columns ``cols`` or of gathered rows (``cols`` None, Ct = A), with
    the packed activity ``act`` of the same rows (`_learn`, JAX
    `temporal_memory.py:501-643`): the stale slots (perm < 0) and the
    rows of ``new_seg`` (B, R) emptied to (-1, -1.0); perm += (learn &
    syn >= 0) * (act != 0 ? increment : -decrement), a float32 add of
    delta or of +-0.0 on every row; live slots with perm < 0 killed; then
    `_grow`'s fill: slot k of the row at list place l = ``lpos`` (B, R)
    (-1: none) takes chosen[l, free_rank[k]] where the slot is free and
    free_rank[k] < n_chosen[l], at ``permanence_initial``, and rows
    `N_GROWN` and `OVERFLOW` of ``counts`` gain the slots written and
    sum(max(n_chosen - free slots, 0)). Returns the (B, R, K) bool mask
    of the slots grown with ``want_mask``, else None."""
    B, Ct, J = syn.shape
    R = learn.shape[1]
    A = Ct if cols is None else cols.shape[1]
    syn_r, perm_r = (_active_rows(t, cols, R) for t in (syn, perm))
    act_r = _active_rows(act, cols, R) != 0
    empty = (perm_r < 0.0) | new_seg[..., None]
    syn_r = torch.where(empty, -1, syn_r)
    perm_r = torch.where(empty, -1.0, perm_r)
    live = syn_r >= 0
    delta = torch.where(act_r, increment, -decrement).to(torch.float32)
    perm_r = perm_r + (learn[..., None] & live) * delta
    dead = live & (perm_r < 0.0)
    syn_r = torch.where(dead, -1, syn_r)
    perm_r = torch.where(dead, -1.0, perm_r)

    free = syn_r < 0
    at = lpos.clamp(min=0).long()
    cells = chosen.gather(1, at[..., None].expand(B, R, chosen.shape[-1]))
    n = torch.where(lpos >= 0, n_chosen.gather(1, at), 0)
    gathered, wrote = _fill(cells, n, free)
    syn_r = torch.where(wrote, gathered, syn_r)
    perm_r = perm_r.masked_fill(wrote, permanence_initial)
    counts[N_GROWN] += wrote.sum((1, 2), dtype=torch.int32)
    counts[OVERFLOW] += torch.clamp(
        n - free.sum(-1, dtype=torch.int32), min=0).sum(-1,
                                                         dtype=torch.int32)
    if cols is None:
        syn.copy_(syn_r.reshape(B, Ct, J))
        perm.copy_(perm_r.reshape(B, Ct, J))
    else:
        _put_rows(syn, cols, syn_r.reshape(B, A, J))
        _put_rows(perm, cols, perm_r.reshape(B, A, J))
    return wrote if want_mask else None


def learn_rows(syn, perm, act, cols, learn, new_seg, lpos, chosen, n_chosen,
               counts, increment: float, decrement: float,
               permanence_initial: float, want_mask: bool = False):
    """The learning pass over the active rows, in place: the `learn_rows`
    kernel for CUDA tensors, the plain version for CPU tensors (arguments
    and results as `learn_rows_ref`'s)."""
    args = (syn, perm, act, cols, learn, new_seg, lpos, chosen, n_chosen,
            counts, increment, decrement, permanence_initial, want_mask)
    if _on_device("learn_rows", syn) == "cuda":
        from ..ops.kernels import learn_rows_cuda

        return learn_rows_cuda(*args)
    return learn_rows_ref(*args)


def _learn(cfg: TMConfig, state: TMState, tables, put, draws: Draws,
           active_cols, dec: ColumnDecisions, return_debug: bool = False):
    """Step 3 minus punishment and the decisions, in active-column row
    space (`temporal_memory.py:501-643`, `projections.py:257-293`), on
    the learning and new-segment flags of `column_decide` ``dec``.
    ``tables`` = (syn, perm, act, cols): the state's synapse tables and
    the active columns, or, under a column shard, the rows gathered from
    their owners and None, which ``put(table, cols, rows)`` writes back
    into the state's own tables. `grow_select` picks each growing row's
    candidates from the rows where they lie, and `learn_rows` runs the
    stale cleanup, the new segments' reset, the permanence update, death
    and the fill in one pass over the rows, in place. Returns (metrics,
    debug): ``debug`` is None unless ``return_debug``, else the (B, C,
    G) ``learning_segments`` and ``new_segments`` and the (B, C, G, K)
    ``grown_mask``."""
    C, D, G, K = (cfg.column_dim, cfg.cell_dim, cfg.segments_per_column,
                  cfg.synapse_capacity)
    B, A = active_cols.shape
    syn, perm, act, cols = tables
    with site("tm_step._learn/_grow"):
        cell_form, key_bits = growth_key_form(C * D, draws.rnd.shape[-1])
        sel = grow_select(syn, act, dec.learn, state.active_cols,
                          state.winner_bits, draws.rnd, D,
                          cfg.segment_sampling_synapses, key_bits, cell_form,
                          row_cols=cols, new_seg=dec.new_seg)
        chosen = sel.chosen
        if not cell_form:
            # the index-form keys -> cells, in place
            chosen = take_small_table(sel.cand_cell, chosen,
                                      (1 << key_bits) - 1, in_place=True)
    with site("tm_step._learn/learn_rows"):
        wrote = learn_rows(syn, perm, act, cols, dec.learn, dec.new_seg,
                           sel.lpos, chosen, sel.n_chosen, sel.counts,
                           cfg.permanence_increment,
                           cfg.permanence_decrement,
                           cfg.permanence_initial, want_mask=return_debug)
        if cols is None:
            # a column shard writes back the rows it owns
            put(state.synapse_cell, active_cols, syn)
            put(state.synapse_perm, active_cols, perm)
    n_grown, overflow, winners_dropped, growth_dropped = sel.counts
    n_new, n_learning, n_dropped, n_evicted = dec.counts[3:]

    metrics = {
        "tm_new_segments": n_new,
        "tm_grown_synapses": n_grown,
        "tm_learning_segments": n_learning,
        "tm_dropped_new_segments": n_dropped,
        "tm_evicted_segments": n_evicted,
        "tm_dropped_synapses": overflow,
        "tm_dropped_winner_candidates": winners_dropped,
        "tm_dropped_growth_segments": growth_dropped,
    }
    debug = None
    if return_debug:
        debug = dict(
            learning_segments=_dense(active_cols,
                                     dec.learn.reshape(B, A, G), C),
            new_segments=_dense(active_cols, dec.new_seg.reshape(B, A, G),
                                C),
            grown_mask=_dense(active_cols, wrote.reshape(B, A, G, K), C))
    return metrics, debug


def _check_forward_options(learning: bool, compute_winner: bool,
                           detailed_metrics: bool, frozen_word,
                           serving_table, distal_forward=None) -> None:
    """The guards of `temporal_memory.py:759-784`."""
    if distal_forward is not None and (
            learning or frozen_word is not None or serving_table is not None):
        raise ValueError(
            "distal_forward substitutes the inference forward pass only "
            "(the learning path fuses its forward into the punish/death "
            "table kernel — substitute the whole step via the "
            "temporal_memory= hook to change learning-mode semantics); "
            "it also cannot combine with frozen_word/serving_table")
    if serving_table is not None:
        if learning or compute_winner:
            raise ValueError(
                "serving_table is a serving-only fast path: it needs "
                "learning=False and compute_winner=False (winner "
                "selection reads the full activity table the compact "
                "form drops)")
        if frozen_word is not None:
            raise ValueError("pass either serving_table or frozen_word, "
                             "not both")
        if detailed_metrics:
            raise ValueError(
                "serving_table computes connected-only counts; "
                "tm_matching_segments would undercount — pass "
                "detailed_metrics=False")
    if frozen_word is not None and learning:
        raise ValueError("frozen_word is an inference-only fast path; "
                         "learning mutates the tables it snapshots")


def tm_resume(cfg: TMConfig, state: TMState) -> TMState:
    """Re-derive the carries a compact serving run leaves stale
    (`temporal_memory.py:684-710`): ``synapse_act`` and ``matching_word``
    from the frozen tables and the state's own previous active set, as
    the unpacked inference forward pass would have left them. No input is
    consumed and no step is taken; one `act_conn` and one `seg_counts`
    (flags form) launch on the card."""
    K = cfg.synapse_capacity
    act_now = synapse_activation_conn(
        state.synapse_cell, state.synapse_perm, state.active_cols,
        state.active_bits, cfg.cell_dim, cfg.permanence_threshold, K)
    matching_word, _ = seg_counts_flags(
        act_now, state.seg_cell, K, cfg.segment_matching_threshold,
        cfg.segment_activation_threshold, cfg.cell_dim, prediction=False)
    return dataclasses.replace(state, synapse_act=act_now,
                               matching_word=matching_word)


def tm_segment_observables(cfg: TMConfig, state: TMState) -> dict:
    """The per-segment forward observables of a post-step state
    (`temporal_memory.py:646-681`): decoded from the packed activity the
    last forward pass cached, the potential and connected-active synapse
    counts of every segment wrt the previous step's active cells, and
    the matching and active masks they give. Returns ``{"potential",
    "connected_active", "matching", "active"}`` as (..., C, G)
    tensors."""
    G, K = cfg.segments_per_column, cfg.synapse_capacity
    act = state.synapse_act
    potential, connected = seg_counts_packed_rows(
        act.reshape(*act.shape[:-1], G, K), K)
    matching = potential >= cfg.segment_matching_threshold
    active = matching & (connected >= cfg.segment_activation_threshold)
    return {"potential": potential, "connected_active": connected,
            "matching": matching, "active": active}


def tm_step(cfg: TMConfig, state: TMState, draws: Draws | None,
            active_cols: torch.Tensor, learning: bool = True,
            compute_winner: bool = True, detailed_metrics: bool = True,
            col_active: torch.Tensor | None = None,
            dense_outputs: bool = True,
            frozen_word: torch.Tensor | None = None,
            serving_table: ServingTable | None = None,
            return_debug: bool = False, epsilon: float | None = None,
            distal_forward=None, shard: ColumnShard | None = None):
    """One TM timestep for B streams (`temporal_memory.py:713-996`).
    Returns (state, `TMOutput`), and the step's `TMDebug` third with
    ``return_debug``.

    ``shard``: the state holds this rank's columns of a model-parallel
    group (`ops/shard.py`); the C-indexed leaves and ``col_active`` are
    the rank's columns, ``active_cols`` global ids. The step runs the
    stock forward pass (no ``frozen_word``, ``serving_table`` or
    ``distal_forward``) and returns no dense outputs and no debug trace,
    as the JAX sharded step returns metrics; ``prev_col_prediction`` and
    the metrics of `COLUMN_SUMS` count the rank's columns (`htm_step`
    sums them across the group).

    ``active_cols`` (B, A) is the SP's top-k list in any order (sorted
    here). ``draws`` holds this step's random numbers (`rng.Draws`); it
    may be None when neither ``learning`` nor ``compute_winner`` is set.
    ``col_active`` optionally passes the matching (B, C) mask. With
    ``dense_outputs=False`` the (B, N) masks of `TMOutput` are None.
    ``epsilon`` overrides ``cfg.epsilon`` (the tie tolerance of the
    best-matching segment) for this call.

    ``distal_forward(cfg, state, active_cols (B, A), act_bits (B, A, W))
    -> (act_now, potential, connected)`` (inference only) replaces the
    forward pass over the synapse tables: the packed activity (B, C, G*K)
    and the (B, C, G) per-segment counts; the thresholds and the
    prediction stay built in.

    ``frozen_word`` (inference only): a `pack_frozen_table` (B, C, J)
    word table of this state's synapse tables; the forward pass reads it
    instead of syn + perm, with bit-equal results.

    ``serving_table`` (needs ``learning=False``, ``compute_winner=False``
    and ``detailed_metrics=False``): a `make_serving_table` compact table
    of this state. Predictions and metrics are bit-equal to the unpacked
    path; the carried ``synapse_act`` passes through unchanged (stale)
    and ``matching_word`` holds the connected-only matching flags, until
    `tm_resume` re-derives both."""
    _check_forward_options(learning, compute_winner, detailed_metrics,
                           frozen_word, serving_table, distal_forward)
    if shard is not None and (
            dense_outputs or return_debug or frozen_word is not None
            or serving_table is not None or distal_forward is not None):
        raise ValueError(
            "a column-sharded tm_step runs the stock forward pass and "
            "returns metrics only: pass dense_outputs=False and no "
            "return_debug, frozen_word, serving_table or distal_forward")
    if epsilon is not None and epsilon != cfg.epsilon:
        cfg = dataclasses.replace(cfg, epsilon=float(epsilon))
    C, D, G, K = (cfg.column_dim, cfg.cell_dim, cfg.segments_per_column,
                  cfg.synapse_capacity)
    B, A = active_cols.shape
    if (learning or compute_winner) and draws is None:
        raise ValueError("a learning or winner-computing step needs draws")
    with site("tm_step.prepare"):
        active_cols = torch.sort(active_cols.to(torch.int32), dim=-1).values

        prev_prediction = state.prediction                      # (B, W, C)
        need_rows = learning or compute_winner
        if shard is None:
            # the active rows, the prediction words and the owners are
            # read where they lie
            tables = (state.synapse_cell, state.synapse_perm,
                      state.synapse_act, active_cols)
            pred_src, owners, where = (prev_prediction, state.seg_cell,
                                       active_cols)
            put = _put_rows
            if col_active is None:
                col_active = column_mask_from_cols(active_cols, C)
        else:
            # the active rows this step reads, from their owners at once
            leaves = ((("synapse_act", "seg_cell") if need_rows else ())
                      + (("synapse_cell", "synapse_perm")
                         if learning else ()))
            pred_src, *got = shard.rows(
                active_cols,
                [prev_prediction, *(getattr(state, n) for n in leaves)],
                [2] + [1] * len(leaves))
            got = dict(zip(leaves, got))
            tables = (got.get("synapse_cell"), got.get("synapse_perm"),
                      got.get("synapse_act"), None)
            owners, where = got.get("seg_cell"), None
            put = shard.put_rows
            if col_active is None:
                col_active = shard.column_mask(active_cols)

    pot = conn = live = None
    with site("tm_step.row_counts"):
        if learning:
            # the active rows' counts, decoded once for both phases
            pot, conn, live = row_counts(*tables, G)
        elif compute_winner:
            act, cols = tables[2:]
            act_rows = act if cols is None else _rows(act, cols)
            pot, _ = seg_counts_packed_rows(act_rows.reshape(B, A, G, K), K)
    # steps 1-2 and the decisions of step 3, with the activity and winner
    # words (a learning step writes the new owners over `owners`)
    with site("tm_step.column_decide"):
        mode = "learn" if learning else "winner" if compute_winner \
            else "burst"
        dec = column_decide(cfg, pred_src, owners, where, pot, conn, live,
                            draws, state.step, mode)
    act_bits = dec.act_bits

    debug = None
    if learning:
        with site("tm_step._learn"):
            learn_metrics, debug = _learn(cfg, state, tables, put, draws,
                                          active_cols, dec, return_debug)
            if shard is not None:
                # a column shard writes back the owners it holds
                put(state.seg_cell, active_cols, owners)
        seg_cell = state.seg_cell
        # punish the matching segments of inactive columns
        # (projections.py:269,290-293), fused into the table pass
        with site("tm_step.punish"):
            pun_word = torch.where(
                col_active | (state.step <= 0)[:, None], 0,
                state.matching_word)
        perm_full, act_now, matching_word, prediction = table_update(
            state.synapse_cell, state.synapse_perm, state.synapse_act,
            pun_word, active_cols, act_bits, seg_cell, D,
            cfg.permanence_punishment, cfg.permanence_threshold,
            cfg.segment_matching_threshold,
            cfg.segment_activation_threshold, column_dim=C)
        with site("tm_step.punish"):
            if detailed_metrics:
                learn_metrics["tm_punished_segments"] = popcount32(
                    pun_word).sum(-1, dtype=torch.int32)
                learn_metrics["tm_punished_columns"] = (pun_word != 0).sum(
                    -1, dtype=torch.int32)
            if return_debug:
                g = torch.arange(G, dtype=torch.int32,
                                 device=pun_word.device)
                debug["punished_segments"] = (
                    (pun_word[..., None] >> g) & 1) != 0
    elif serving_table is not None:
        # compact serving forward: connected-only counts. seg_active is
        # exact (connected-active >= theta_a implies potential >= theta_a
        # >= theta_m); matching holds the connected-matching flags
        perm_full, seg_cell, learn_metrics = (
            state.synapse_perm, state.seg_cell, {})
        with site("tm_step.serving_counts"):
            # the counts' thresholds as the matching word and the
            # prediction words, in the table pass itself
            matching_word, prediction = serving_flags(
                serving_table, active_cols, act_bits, seg_cell, C, D,
                cfg.segment_matching_threshold,
                cfg.segment_activation_threshold)
        act_now = state.synapse_act                   # passed through, stale
    else:
        # inference: the tables are frozen; only the forward pass runs
        perm_full, seg_cell, learn_metrics = (
            state.synapse_perm, state.seg_cell, {})
        if distal_forward is not None:
            act_now, potential, connected = distal_forward(
                cfg, state, active_cols, act_bits)
            with site("tm_step.prediction_words"):
                matching = potential >= cfg.segment_matching_threshold
                seg_active = matching & (
                    connected >= cfg.segment_activation_threshold)
                prediction = prediction_words(seg_cell, seg_active, D)
                matching_word = pack_bits(matching)[..., 0]       # G <= 32
        else:
            with site("tm_step.table_pass"):
                # into the state's activity buffer, as the learning
                # step's table pass writes it
                if frozen_word is not None:
                    act_now = synapse_activation_frozen(
                        frozen_word, active_cols, act_bits, D, K,
                        out=state.synapse_act)
                else:
                    act_now = synapse_activation_conn(
                        state.synapse_cell, perm_full, active_cols,
                        act_bits, D, cfg.permanence_threshold, K,
                        column_dim=C, out=state.synapse_act)
            with site("tm_step.count_decode"):
                # the counts' thresholds, matching word and prediction
                # words in the decode's own pass
                matching_word, prediction = seg_counts_flags(
                    act_now, seg_cell, K, cfg.segment_matching_threshold,
                    cfg.segment_activation_threshold, D)

    with site("tm_step.outputs"):
        new_state = TMState(
            synapse_cell=state.synapse_cell,
            synapse_perm=perm_full,
            seg_cell=seg_cell,
            active_cols=active_cols,
            active_bits=act_bits,
            winner_bits=dec.winner_bits,
            synapse_act=act_now,
            prediction=prediction,
            matching_word=matching_word,
            step=state.step + 1,
        )

        metrics = {**dict(zip(DECIDE_COUNTS[:3], dec.counts)),
                   **learn_metrics}
        if detailed_metrics:
            metrics.update(
                tm_predicted_cells=popcount32(prediction).sum(
                    (1, 2), dtype=torch.int32),
                tm_matching_segments=popcount32(matching_word).sum(
                    -1, dtype=torch.int32),
                tm_pool_occupancy=(seg_cell < D).sum((1, 2),
                                                     dtype=torch.int32),
            )
        N = C * D
        dense = {k: None for k in ("active_mask", "winner_mask", "prediction",
                                   "prev_prediction")}
        if dense_outputs or return_debug:
            dense["winner_mask"] = _dense(
                active_cols, unpack_bits(dec.winner_bits, D), C).reshape(B, N)
        if dense_outputs:
            dense.update(
                active_mask=_dense(active_cols, unpack_bits(act_bits, D),
                                   C).reshape(B, N),
                prediction=prediction_dense(prediction, D).reshape(B, N),
                prev_prediction=prediction_dense(prev_prediction,
                                                 D).reshape(B, N),
            )
        out = TMOutput(
            prev_col_prediction=(prev_prediction != 0).any(-2),
            bursting_columns=_dense(active_cols, dec.col_burst, C),
            metrics=metrics,
            **dense,
        )
    if not return_debug:
        return new_state, out
    if debug is None:   # no learning: no decision was made
        debug = dict(
            learning_segments=torch.zeros_like(seg_cell, dtype=torch.bool),
            punished_segments=torch.zeros_like(seg_cell, dtype=torch.bool),
            new_segments=torch.zeros_like(seg_cell, dtype=torch.bool),
            grown_mask=torch.zeros_like(new_state.synapse_cell,
                                        dtype=torch.bool).reshape(B, C, G, K))
    return new_state, out, TMDebug(
        winner_mask=dense["winner_mask"],
        synapse_cell=new_state.synapse_cell.reshape(B, C, G, K).clone(),
        seg_cell=seg_cell, **debug)
