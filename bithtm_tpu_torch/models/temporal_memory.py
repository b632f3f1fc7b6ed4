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
    percell_max,
    percell_sum,
    prediction_dense,
    prediction_words,
    rank_ascending,
    seg_counts_packed,
    seg_counts_packed_rows,
    synapse_activation_conn,
    synapse_activation_frozen,
    table_update,
    take_percell,
    take_small_table,
    unpack_bits,
)
from ..ops.bitops import lsr32, popcount32
from ..ops.serving import ServingTable, serving_counts
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


def _winner_selection(cfg: TMConfig, take, draws: Draws, active_cols,
                      pred_rows):
    """Steps 1-2 in active-column space (`temporal_memory.py:106-161`);
    ``take(leaf)`` gives a C-indexed state leaf's rows at the active
    columns. Returns (col_burst (B, A), winner_rows (B, A, D), cell_max_j
    (B, A, D), seg_j (B, A, G))."""
    D, G, K = cfg.cell_dim, cfg.segments_per_column, cfg.synapse_capacity
    B, A = active_cols.shape
    col_burst = ~pred_rows.any(-1)

    # per-segment potential at the active rows, re-derived from the
    # activity the previous forward pass cached (the table is unchanged)
    pot_rows, _ = seg_counts_packed_rows(
        take("synapse_act").reshape(B, A, G, K), K)
    match_rows = pot_rows >= cfg.segment_matching_threshold
    segcell_rows = take("seg_cell")

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


def _allocate(cfg: TMConfig, segcell_rows, syn_rows, match_rows, unacc):
    """Segment allocation for unaccounted winner cells, by deterministic
    rank pairing (`temporal_memory.py:164-218`): eligible slots ordered
    recyclable-allocated, then unallocated, then (policy "evict") mature
    non-matching slots by ascending live count; the i-th unaccounted cell
    takes the i-th slot. Returns (new_seg (B, A, G), new_owner
    (B, A, G), n_dropped (B,), n_evicted (B,))."""
    D, G = cfg.cell_dim, cfg.segments_per_column
    syn_count = (syn_rows >= 0).sum(-1, dtype=torch.int32)      # (B, A, G)
    recyclable = syn_count < cfg.segment_matching_threshold
    unallocated = segcell_rows >= D
    g = torch.arange(G, dtype=torch.int32, device=syn_rows.device)
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
    d = torch.arange(D, dtype=torch.int32, device=syn_rows.device)
    new_owner = (assign * d).sum(-1, dtype=torch.int32)
    n_dropped = (unacc.sum((1, 2), dtype=torch.int32)
                 - assign.sum((1, 2, 3), dtype=torch.int32))
    n_evicted = (new_seg & evictable).sum((1, 2), dtype=torch.int32)
    return new_seg, new_owner, n_dropped, n_evicted


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
                    key_bits: int, cell_form: bool):
    """The packed growth keys of `grow_select_ref` (JAX `_grow`,
    `temporal_memory.py:350-498`): per growing row, the (B, L, Wc) keys
    (int64 in the cell form, int32 in the index form), which of them are
    valid (in the list and not already a target of the row) and the
    row's n_grow (B, L). Arguments as `grow_select_ref`'s."""
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
    if samp < K:
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
    """What `grow_select` gives `_grow`: the selection (chosen (B, L, kk)
    int32, kk = min(samp, Wc): the cells, or the index-form keys, of each
    row's n_chosen smallest keys, ascending, defined up to n_chosen (B, L)
    int32), the lists it selected from (lidx (B, L) int32, the growing
    rows' slot ids, the row count R past the valid ones; lvalid (B, L)
    bool; cand_cell (B, Wc) int32, the candidates, 0 past the valid ones)
    and counts (4, B) int32: 0 and 0 (`grow_fill` adds the slots grown
    and the overflow), the winners past Wc and the growing rows past
    L."""

    chosen: torch.Tensor
    n_chosen: torch.Tensor
    lidx: torch.Tensor
    lvalid: torch.Tensor
    cand_cell: torch.Tensor
    counts: torch.Tensor


# the rows of GrowSelection.counts, in `_grow`'s order
N_GROWN, OVERFLOW, WINNERS_DROPPED, GROWTH_DROPPED = range(4)


def grow_select_ref(syn_rows, act_rows, learn_rows, prev_cols,
                    prev_winner_bits, rnd, cell_dim: int, samp: int,
                    key_bits: int, cell_form: bool) -> GrowSelection:
    """Plain version of the `grow_select` kernel, `_grow` up to its fill:
    for (B, R, K) synapse rows ``syn_rows`` (int32, -1 free) and their bool
    activity ``act_rows``, the (B, R) bool learning flags ``learn_rows``,
    the (B, A) previous active columns ``prev_cols`` (ascending) and their
    (B, A, W) int32 winner words, and (B, L, Wc) int32 random words
    ``rnd``: the candidate list (the first Wc previous winner cells,
    ascending), the growing rows (the first L learning flags) and, for
    each, n_grow = clip(samp - active potential, 0, min(samp, n_winners
    capped at Wc)) candidates it does not already target, the n_grow
    smallest by packed key (``cell_form`` with ``key_bits`` cell bits,
    else the index form). Returns `GrowSelection`."""
    B, R, _ = syn_rows.shape
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
    pkey, valid, n_grow = growth_keys_ref(
        syn_rows, act_rows, lidx, lvalid, cand_cell, cand_valid,
        n_winners_eff, rnd, samp, key_bits, cell_form)
    chosen, n_chosen = _select_keys(pkey, valid, n_grow, samp,
                                    not cell_form)
    if cell_form:
        chosen = (chosen & ((1 << key_bits) - 1)).to(torch.int32)
    zero = torch.zeros_like(n_winners)
    counts = torch.stack([
        zero, zero, n_winners - n_winners_eff,
        learn_rows.sum(-1, dtype=torch.int32)
        - lvalid.sum(-1, dtype=torch.int32)])
    return GrowSelection(chosen, n_chosen, lidx, lvalid,
                         cand_cell.contiguous(), counts)


def grow_select(syn_rows, act_rows, learn_rows, prev_cols,
                prev_winner_bits, rnd, cell_dim: int, samp: int,
                key_bits: int, cell_form: bool) -> GrowSelection:
    """`_grow`'s lists and selection: the `grow_select` kernel for CUDA
    tensors, the plain version for CPU tensors (arguments and results as
    `grow_select_ref`'s; chosen is defined up to n_chosen)."""
    args = (syn_rows, act_rows, learn_rows, prev_cols, prev_winner_bits,
            rnd, cell_dim, samp, key_bits, cell_form)
    if _on_device("grow_select", syn_rows) == "cuda":
        from ..ops.kernels import grow_select_cuda

        return GrowSelection(*grow_select_cuda(*args))
    return grow_select_ref(*args)


def grow_fill_ref(syn_rows, perm_rows, lidx, lvalid, chosen, n_chosen,
                  counts, permanence_initial: float) -> torch.Tensor:
    """Plain version of the `grow_fill` kernel, `_grow`'s fill: slot k of
    growing row l (``lidx``, ``lvalid``) takes chosen[l, free_rank[k]]
    where the row is valid, the slot is free (``syn_rows`` < 0) and
    free_rank[k] < n_chosen[l]; those slots of the (B, R, K) ``syn_rows`` and
    ``perm_rows`` are written in place (the cell, ``permanence_initial``),
    and rows `N_GROWN` and `OVERFLOW` of ``counts`` gain the slots
    written and sum(max(n_chosen - free slots, 0)) over the valid rows.
    Returns the (B, R, K) bool mask of the slots written."""
    B, R, K = syn_rows.shape
    L = lidx.shape[1]
    lidx = lidx.long()
    take = lidx.clamp(max=R - 1)[..., None].expand(B, L, K)      # clipped
    free = syn_rows.gather(1, take) < 0
    gathered, wrote_l = _fill(chosen, n_chosen, free)
    wrote_l &= lvalid[..., None]
    # invalid rows land in a padding row that is sliced off
    idx = lidx[..., None].expand(B, L, K)
    wrote = syn_rows.new_zeros((B, R + 1, K), dtype=torch.bool).scatter_(
        1, idx, wrote_l)[:, :R]
    cells = syn_rows.new_zeros((B, R + 1, K)).scatter_(
        1, idx, gathered)[:, :R]
    syn_rows.copy_(torch.where(wrote, cells, syn_rows))
    perm_rows.masked_fill_(wrote, permanence_initial)
    n_free = free.sum(-1, dtype=torch.int32)
    counts[N_GROWN] += wrote_l.sum((1, 2), dtype=torch.int32)
    counts[OVERFLOW] += (torch.clamp(n_chosen - n_free, min=0)
                         * lvalid).sum(-1, dtype=torch.int32)
    return wrote.contiguous()


def grow_fill(syn_rows, perm_rows, lidx, lvalid, chosen, n_chosen, counts,
              permanence_initial: float) -> torch.Tensor:
    """`_grow`'s fill: the `grow_fill` kernel for CUDA tensors, the plain
    version for CPU tensors (arguments and results as
    `grow_fill_ref`'s)."""
    args = (syn_rows, perm_rows, lidx, lvalid, chosen, n_chosen, counts,
            permanence_initial)
    if _on_device("grow_fill", syn_rows) == "cuda":
        from ..ops.kernels import grow_fill_cuda

        return grow_fill_cuda(*args)
    return grow_fill_ref(*args)


def _grow(cfg: TMConfig, rnd, syn_rows, perm_rows, learn_rows,
          act_prev_rows, prev_cols, prev_winner_bits):
    """Synapse growth toward the previous winner cells
    (`temporal_memory.py:350-498`, `projections.py:111-161`): each
    learning segment grows clip(samp - active potential, 0,
    min(samp, n_winners)) random candidates that it does not already
    target, into its free slots. `grow_select` builds the candidate list
    and the L-wide list of growing segments and picks each row's
    candidates, `take_small_table` decodes the index-form keys (above
    2^16 cells) and `grow_fill` writes them into the free slots, as JAX's
    `_grow` compacts and `_select_and_fill` selects, decodes and fills.
    ``syn_rows`` and ``perm_rows`` (B, A, G, K) are updated in place.
    Returns (syn_rows, perm_rows, wrote (B, A, G, K) the slots grown,
    n_grown, overflow, n_winners_dropped, n_growth_dropped), counts
    (B,)."""
    C, D, G, K = (cfg.column_dim, cfg.cell_dim, cfg.segments_per_column,
                  cfg.synapse_capacity)
    B, A = prev_cols.shape
    syn_flat = syn_rows.reshape(B, A * G, K)
    perm_flat = perm_rows.reshape(B, A * G, K)
    cell_form, key_bits = growth_key_form(C * D, rnd.shape[-1])
    sel = grow_select(syn_flat, act_prev_rows.reshape(B, A * G, K),
                      learn_rows.reshape(B, A * G), prev_cols,
                      prev_winner_bits, rnd, D,
                      cfg.segment_sampling_synapses, key_bits, cell_form)
    chosen = sel.chosen
    if not cell_form:
        # the index-form keys -> cells, in place
        chosen = take_small_table(sel.cand_cell, chosen,
                                  (1 << key_bits) - 1, in_place=True)
    wrote = grow_fill(syn_flat, perm_flat, sel.lidx, sel.lvalid, chosen,
                      sel.n_chosen, sel.counts, cfg.permanence_initial)
    shape = (B, A, G, K)
    return (syn_flat.view(shape), perm_flat.view(shape), wrote.view(shape),
            *sel.counts)


def _learn(cfg: TMConfig, state: TMState, take, put, draws: Draws,
           active_cols, pred_rows, winner_rows, cell_max_j, seg_j,
           return_debug: bool = False):
    """Step 3 minus punishment, in active-column row space
    (`temporal_memory.py:501-643`, `projections.py:257-293`). A no-op on
    step 0 (`projections.py:258-259`). ``take(leaf)`` gives a C-indexed
    leaf's rows at the active columns, ``put(table, cols, rows)`` writes
    rows back in place. Writes the rows back into
    ``state.synapse_cell`` / ``state.synapse_perm`` in place and returns
    (seg_cell, metrics, debug): ``debug`` is None unless
    ``return_debug``, else the (B, C, G) ``learning_segments`` and
    ``new_segments`` and the (B, C, G, K) ``grown_mask``."""
    D, G, K = cfg.cell_dim, cfg.segments_per_column, cfg.synapse_capacity
    B, A = active_cols.shape
    has_prev = (state.step > 0)[:, None, None]

    segcell_rows = take("seg_cell")
    syn_rows = take("synapse_cell").reshape(B, A, G, K)
    perm_rows = take("synapse_perm").reshape(B, A, G, K)
    # slots killed by punishment keep a stale target; clean them here
    stale = perm_rows < 0.0
    syn_rows = torch.where(stale, -1, syn_rows)
    perm_rows = torch.where(stale, -1.0, perm_rows)
    act_prev_raw = take("synapse_act").reshape(B, A, G, K)
    act_prev_rows = act_prev_raw != 0
    pot_rows, conn_rows = seg_counts_packed_rows(act_prev_raw, K)
    match_rows = pot_rows >= cfg.segment_matching_threshold
    active_seg_rows = match_rows & (
        conn_rows >= cfg.segment_activation_threshold)

    owner_pred = take_percell(pred_rows, segcell_rows, D, False)
    owner_winner = take_percell(winner_rows, segcell_rows, D, False)
    owner_max = take_percell(cell_max_j, segcell_rows, D, 0.0)
    seg_best = match_rows & ((seg_j - owner_max).abs() < cfg.epsilon)
    learn_rows = (match_rows & owner_winner
                  & (active_seg_rows | (~owner_pred & seg_best))
                  & has_prev)

    # segment allocation for unaccounted winners (recycle first)
    unacc = winner_rows & (cell_max_j < cfg.epsilon) & has_prev
    with site("tm_step._learn/_allocate"):
        new_seg, new_owner, n_dropped, n_evicted = _allocate(
            cfg, segcell_rows, syn_rows, match_rows, unacc)
    segcell_rows = torch.where(new_seg, new_owner, segcell_rows)
    syn_rows = torch.where(new_seg[..., None], -1, syn_rows)
    perm_rows = torch.where(new_seg[..., None], -1.0, perm_rows)
    learn_rows = learn_rows | new_seg

    # permanence update and death on learning rows
    live_rows = syn_rows >= 0
    delta = torch.where(act_prev_rows, cfg.permanence_increment,
                        -cfg.permanence_decrement).to(torch.float32)
    perm_rows = perm_rows + (learn_rows[..., None] & live_rows) * delta
    dead_rows = live_rows & (perm_rows < 0.0)
    syn_rows = torch.where(dead_rows, -1, syn_rows)
    perm_rows = torch.where(dead_rows, -1.0, perm_rows)

    with site("tm_step._learn/_grow"):
        (syn_rows, perm_rows, wrote, n_grown, overflow, winners_dropped,
         growth_dropped) = _grow(cfg, draws.rnd, syn_rows, perm_rows,
                                 learn_rows, act_prev_rows,
                                 state.active_cols, state.winner_bits)

    # write the rows back (the punishment pass touches only other columns)
    put(state.synapse_cell, active_cols, syn_rows.reshape(B, A, -1))
    put(state.synapse_perm, active_cols, perm_rows.reshape(B, A, -1))
    seg_cell = put(state.seg_cell.clone(), active_cols, segcell_rows)

    metrics = {
        "tm_new_segments": new_seg.sum((1, 2), dtype=torch.int32),
        "tm_grown_synapses": n_grown,
        "tm_learning_segments": learn_rows.sum((1, 2), dtype=torch.int32),
        "tm_dropped_new_segments": n_dropped,
        "tm_evicted_segments": n_evicted,
        "tm_dropped_synapses": overflow,
        "tm_dropped_winner_candidates": winners_dropped,
        "tm_dropped_growth_segments": growth_dropped,
    }
    debug = None
    if return_debug:
        C = cfg.column_dim
        debug = dict(learning_segments=_dense(active_cols, learn_rows, C),
                     new_segments=_dense(active_cols, new_seg, C),
                     grown_mask=_dense(active_cols, wrote, C))
    return seg_cell, metrics, debug


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
    consumed and no step is taken; one `act_conn` launch on the card."""
    G, K = cfg.segments_per_column, cfg.synapse_capacity
    act_now = synapse_activation_conn(
        state.synapse_cell, state.synapse_perm, state.active_cols,
        state.active_bits, cfg.cell_dim, cfg.permanence_threshold, K)
    potential, _ = seg_counts_packed(act_now, G, K)
    matching = potential >= cfg.segment_matching_threshold
    return dataclasses.replace(state, synapse_act=act_now,
                               matching_word=pack_bits(matching)[..., 0])


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
        W = prev_prediction.shape[1]
        if shard is None:
            pred_words = prev_prediction.gather(
                2, active_cols.long()[:, None, :].expand(B, W, A))

            def take(leaf):
                return _rows(getattr(state, leaf), active_cols)

            put = _put_rows
            if col_active is None:
                col_active = column_mask_from_cols(active_cols, C)
        else:
            # the active rows this step reads, from their owners at once
            leaves = ((("synapse_act", "seg_cell")
                       if learning or compute_winner else ())
                      + (("synapse_cell", "synapse_perm")
                         if learning else ()))
            pred_words, *got = shard.rows(
                active_cols,
                [prev_prediction, *(getattr(state, n) for n in leaves)],
                [2] + [1] * len(leaves))
            take = dict(zip(leaves, got)).__getitem__
            put = shard.put_rows
            if col_active is None:
                col_active = shard.column_mask(active_cols)
        pred_rows = unpack_bits(pred_words.transpose(1, 2), D)  # (B, A, D)

    with site("tm_step.winner_selection"):
        if learning or compute_winner:
            col_burst, winner_rows, cell_max_j, seg_j = _winner_selection(
                cfg, take, draws, active_cols, pred_rows)
        else:
            col_burst = ~pred_rows.any(-1)
            winner_rows = torch.zeros_like(pred_rows)

    # activation: predicted cells + whole bursting columns
    with site("tm_step.activation"):
        act_rows = pred_rows | col_burst[..., None]
        act_bits = pack_bits(act_rows)                          # (B, A, W)

    debug = None
    if learning:
        with site("tm_step._learn"):
            seg_cell, learn_metrics, debug = _learn(
                cfg, state, take, put, draws, active_cols, pred_rows,
                winner_rows, cell_max_j, seg_j, return_debug)
        # punish the matching segments of inactive columns
        # (projections.py:269,290-293), fused into the table pass
        with site("tm_step.punish"):
            pun_word = torch.where(
                col_active | (state.step <= 0)[:, None], 0,
                state.matching_word)
        (perm_full, act_now, _, _, matching, _,
         prediction) = table_update(
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
            conn_cnt = serving_counts(serving_table, active_cols, act_bits, C,
                                      D, G)                         # (B, C, G)
        with site("tm_step.prediction_words"):
            matching = conn_cnt >= cfg.segment_matching_threshold
            seg_active = conn_cnt >= cfg.segment_activation_threshold
            prediction = prediction_words(seg_cell, seg_active, D)
        act_now = state.synapse_act                   # passed through, stale
    else:
        # inference: the tables are frozen; only the forward pass runs
        perm_full, seg_cell, learn_metrics = (
            state.synapse_perm, state.seg_cell, {})
        if distal_forward is not None:
            act_now, potential, connected = distal_forward(
                cfg, state, active_cols, act_bits)
        else:
            with site("tm_step.table_pass"):
                if frozen_word is not None:
                    act_now = synapse_activation_frozen(
                        frozen_word, active_cols, act_bits, D, K)
                else:
                    act_now = synapse_activation_conn(
                        state.synapse_cell, perm_full, active_cols,
                        act_bits, D, cfg.permanence_threshold, K,
                        column_dim=C)
            with site("tm_step.count_decode"):
                potential, connected = seg_counts_packed(act_now, G, K)
        with site("tm_step.prediction_words"):
            matching = potential >= cfg.segment_matching_threshold
            seg_active = matching & (
                connected >= cfg.segment_activation_threshold)
            prediction = prediction_words(seg_cell, seg_active, D)

    with site("tm_step.outputs"):
        new_state = TMState(
            synapse_cell=state.synapse_cell,
            synapse_perm=perm_full,
            seg_cell=seg_cell,
            active_cols=active_cols,
            active_bits=act_bits,
            winner_bits=pack_bits(winner_rows),
            synapse_act=act_now,
            prediction=prediction,
            matching_word=pack_bits(matching)[..., 0],  # G <= 32
            step=state.step + 1,
        )

        metrics = {
            "tm_bursting_columns": col_burst.sum(-1, dtype=torch.int32),
            "tm_active_cells": act_rows.sum((1, 2), dtype=torch.int32),
            "tm_winner_cells": winner_rows.sum((1, 2), dtype=torch.int32),
            **learn_metrics,
        }
        if detailed_metrics:
            metrics.update(
                tm_predicted_cells=popcount32(prediction).sum(
                    (1, 2), dtype=torch.int32),
                tm_matching_segments=matching.sum((1, 2), dtype=torch.int32),
                tm_pool_occupancy=(seg_cell < D).sum((1, 2),
                                                     dtype=torch.int32),
            )
        N = C * D
        dense = {k: None for k in ("active_mask", "winner_mask", "prediction",
                                   "prev_prediction")}
        if dense_outputs or return_debug:
            dense["winner_mask"] = _dense(active_cols, winner_rows,
                                          C).reshape(B, N)
        if dense_outputs:
            dense.update(
                active_mask=_dense(active_cols, act_rows, C).reshape(B, N),
                prediction=prediction_dense(prediction, D).reshape(B, N),
                prev_prediction=prediction_dense(prev_prediction,
                                                 D).reshape(B, N),
            )
        out = TMOutput(
            prev_col_prediction=(prev_prediction != 0).any(-2),
            bursting_columns=_dense(active_cols, col_burst, C),
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
