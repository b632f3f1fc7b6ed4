"""Batched SpatialPooler step.

Counterpart of `bithtm_tpu/models/spatial_pooler.py` (reference
`networks.py:26-35`): overlaps -> boosting -> global inhibition -> (when
learning) the Hebbian update of the A active rows; the duty-cycle EMA
updates whether or not the model learns (`networks.py:33`). With the
built-in boosting and inhibition, the boost, the inhibition and the EMA
are one call, `regularization.sp_select` (the CUDA kernel of the same
name on the card, the torch chain on the CPU); a hook or a column shard
keeps the chain's ops.

The permanence and connected tables are updated in place: the state
passed in is consumed, as the JAX scan donates its carry.

Under a column shard (`ops/shard.py`, a model-parallel rank holding C/n
columns) only the inhibition crosses the column axis: the boosted
overlaps are exchanged into the (B, C) array before `k_winners`, and the
rest (overlap, boost, Hebbian rows, duty EMA) runs on the rank's own
columns, as torch ops.

The learning step updates the A active rows only (the JAX step's
sparse-row form): `sp_rows`, the CUDA kernel of the same name
(`ops/kernels.py`) on the card and its plain version `sp_rows_ref`, the
gather, update and scatter of the rows, on the CPU. A column shard and
a `proximal_update` hook keep their own update. `sp_update_pack` is the
fused update + re-pack of the whole table, an entry point of its own
with the CUDA kernel of the same name and its plain version
`sp_update_pack_ref`, which no step dispatches.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import torch

from ..config import SPConfig
from ..ops.active_set import _on_device, column_mask_from_cols
from ..ops.overlap import overlaps as _overlaps, pack_input
from ..ops.regularization import (boost, duty_cycle_update, k_winners,
                                  sp_select)
from ..ops.shard import ColumnShard
from ..state import SPState
from ..utils.profiling import site


class SPOutput(NamedTuple):
    """Under a column shard the (B, C) fields hold the rank's columns
    only; ``active_columns`` holds global ids."""

    active_columns: torch.Tensor    # (B, A) int32 top-k, descending value
    active_mask: torch.Tensor       # (B, C) bool
    overlaps: torch.Tensor          # (B, C) int32
    boosted_overlaps: torch.Tensor  # (B, C) f32


def hebbian_delta(cfg: SPConfig, input_bits: torch.Tensor, I_pad: int
                  ) -> tuple[torch.Tensor, int | float]:
    """The per-input Hebbian delta (`projections.py:23-24`: delta =
    x * (inc + dec) - dec) of (B, I) inputs, (B, I_pad): int32 units on
    an int16 table, float32 otherwise; padding lanes get 0 and stay at
    the rail. Returns (delta, connected threshold in the table's
    units)."""
    B, I = input_bits.shape[0], cfg.input_dim
    x = torch.zeros((B, I_pad), dtype=torch.int32, device=input_bits.device)
    x[:, :I] = input_bits.to(torch.int32)
    in_range = torch.arange(I_pad, device=input_bits.device) < I
    if cfg.quantized:
        inc = cfg.to_units(cfg.permanence_increment)
        dec = cfg.to_units(cfg.permanence_decrement)
        delta = torch.where(in_range, x * (inc + dec) - dec, 0)
        return delta, cfg.to_units(cfg.permanence_threshold)
    xf = x.to(torch.float32)
    delta = xf * (cfg.permanence_increment + cfg.permanence_decrement) \
        - cfg.permanence_decrement
    return torch.where(in_range, delta, 0.0), cfg.permanence_threshold


@functools.cache
def hebbian_steps(cfg: SPConfig) -> tuple[int | float, int | float,
                                          int | float]:
    """(the delta of an active input lane, of an inactive one, the
    connected threshold), in the table's units: `hebbian_delta`'s own
    expression evaluated on the host for one active and one inactive
    input, so that the `sp_rows` kernel adds exactly the plain version's
    values."""
    two = dataclasses.replace(cfg, input_dim=2)
    delta, thr = hebbian_delta(two, torch.tensor([[True, False]]), 2)
    d_on, d_off = delta[0].tolist()
    return d_on, d_off, thr


def _hebbian_rows(cfg: SPConfig, rows: torch.Tensor,
                  input_bits: torch.Tensor):
    """Hebbian update of gathered rows (B, A, I_pad) toward the inputs.
    Returns (rows', threshold)."""
    delta, thr = hebbian_delta(cfg, input_bits, rows.shape[-1])
    if cfg.quantized:
        # exact integer units; the clip saturates a chronically
        # reinforced synapse at the rail instead of wrapping int16
        rows = (rows.to(torch.int32) + delta[:, None]).clamp(
            -32000, 32000).to(torch.int16)
        return rows, thr
    return rows + delta[:, None], thr


def sp_rows_ref(cfg: SPConfig, permanence: torch.Tensor,
                connected: torch.Tensor, input_bits: torch.Tensor,
                active_cols: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the `sp_rows` kernel: the Hebbian update of the
    (B, A) ``active_cols`` rows of the (B, C, I_pad) ``permanence``
    toward the (B, I) ``input_bits`` (`_hebbian_rows`) and the strided
    pack of their connected bits into the (B, C, I_pad/8) ``connected``,
    in place (gather, update, scatter: the JAX step's sparse-row form);
    every other row keeps its bits. A column listed twice is written
    twice with the same row. Returns (permanence, connected)."""
    idx = active_cols.long()
    rows = permanence.gather(
        1, idx[:, :, None].expand(-1, -1, permanence.shape[-1]))
    rows, thr = _hebbian_rows(cfg, rows, input_bits)
    for table, new in ((permanence, rows),
                       (connected, pack_input(rows >= thr))):
        table.scatter_(1, idx[:, :, None].expand(-1, -1, new.shape[-1]),
                       new)
    return permanence, connected


def sp_rows(cfg: SPConfig, permanence: torch.Tensor, connected: torch.Tensor,
            input_bits: torch.Tensor, active_cols: torch.Tensor
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """The learning step's update of the active rows and their connected
    words, in place: the `sp_rows` kernel for CUDA tensors, the plain
    version for CPU tensors (arguments and results as `sp_rows_ref`'s)."""
    if _on_device("sp_rows", permanence) == "cuda":
        from ..ops.kernels import sp_rows_cuda

        return sp_rows_cuda(permanence, connected, input_bits, active_cols,
                            *hebbian_steps(cfg))
    return sp_rows_ref(cfg, permanence, connected, input_bits, active_cols)


def sp_update_pack_ref(permanence: torch.Tensor, delta_row: torch.Tensor,
                       active_cols: torch.Tensor, threshold
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the `sp_update_pack` kernel: every row of the
    (B, C, I_pad) ``permanence`` (int16 units or float32) becomes
    perm + act * delta_row, act = 1 on the (B, A) ``active_cols`` and 0
    elsewhere (int16: widened to int32 and clipped to +-32000), in
    place; returns (permanence, connected (B, C, I_pad/8) u8 of every
    row in `pack_input`'s strided layout). The arithmetic of the TPU
    kernel (`pallas_kernels.py:549-595`), so the float32 path multiplies
    by act before it adds."""
    act = column_mask_from_cols(active_cols, permanence.shape[1])[..., None]
    if permanence.dtype == torch.int16:
        p = (permanence.to(torch.int32) + act * delta_row.to(torch.int32)
             [:, None]).clamp(-32000, 32000).to(torch.int16)
    else:
        p = permanence + act.to(torch.float32) * delta_row[:, None]
    permanence.copy_(p)
    return permanence, pack_input(p >= threshold)


def sp_update_pack(permanence: torch.Tensor, delta_row: torch.Tensor,
                   active_cols: torch.Tensor, threshold
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """The SP's Hebbian update of the active rows and the re-pack of
    every row's connected bits in one pass (the fused form of the
    learning half of `sp_step`, which does not call it, as the JAX step
    does not dispatch its kernel): the `sp_update_pack` kernel for CUDA
    tensors, the plain version for CPU tensors. ``delta_row`` and
    ``threshold`` come from `hebbian_delta`."""
    if _on_device("sp_update_pack", permanence) == "cuda":
        from ..ops.kernels import sp_update_pack_cuda

        return sp_update_pack_cuda(permanence, delta_row, active_cols,
                                   threshold)
    return sp_update_pack_ref(permanence, delta_row, active_cols, threshold)


def sp_step(cfg: SPConfig, state: SPState, input_bits: torch.Tensor,
            learning: bool, boosting=None, inhibition=None, overlap=None,
            proximal_update=None, shard: ColumnShard | None = None
            ) -> tuple[SPState, SPOutput]:
    """One SP timestep for B streams: ``input_bits`` is (B, I) bool.

    The component hooks of `spatial_pooler.py:39-61`, with the stream
    axis; None selects the built-in rule:

      boosting(cfg, overlaps (B, C) i32, duty_cycle (B, C) f32) -> (B, C) f32
      inhibition(cfg, boosted (B, C) f32) -> ((B, A) i32 cols, (B, C) mask)
      overlap(cfg, state, input_bits (B, I) bool) -> (B, C) overlaps
      proximal_update(cfg, state, input_bits, active_columns (B, A) i32)
          -> (permanence, connected)  # the state's new tables

    ``shard``: the state holds this rank's columns of a model-parallel
    group (no hooks, as the JAX sharded step takes none): the boosted
    overlaps are exchanged before the inhibition, and the rank writes
    back the Hebbian rows it owns (`ColumnShard.put_rows`)."""
    if shard is not None and any(h is not None for h in (
            boosting, inhibition, overlap, proximal_update)):
        raise ValueError("the column-sharded SP step takes no hooks")
    with site("sp_step.overlap"):
        if overlap is None:
            ov = _overlaps(state.connected, input_bits)
        else:
            ov = overlap(cfg, state, input_bits)
    with site("sp_step.select"):
        boosted, active_columns, active_mask, duty = _select(
            cfg, ov, state.duty_cycle, boosting, inhibition, shard)
    with site("sp_step.update"):
        permanence, connected = _update(cfg, state, input_bits, learning,
                                        active_columns, proximal_update,
                                        shard)
    new_state = SPState(permanence=permanence, connected=connected,
                        duty_cycle=duty)
    return new_state, SPOutput(active_columns, active_mask, ov, boosted)


def _select(cfg: SPConfig, ov, duty_cycle, boosting, inhibition, shard):
    """`sp_step`'s boost, inhibition and duty-cycle EMA: (boosted, (B, A)
    columns, (B, C) mask, new duty cycles). `sp_select` with the built-in
    rules; a hook replaces its own part of the chain, and a column shard
    exchanges the boosted overlaps before the inhibition."""
    if boosting is None and inhibition is None and shard is None:
        return sp_select(ov, duty_cycle, cfg.active_columns,
                         cfg.boosting_intensity, cfg.density,
                         cfg.duty_cycle_momentum)
    if boosting is None:
        boosted = boost(ov, duty_cycle, cfg.boosting_intensity, cfg.density)
    else:
        boosted = boosting(cfg, ov, duty_cycle)
    active_columns, active_mask = _inhibit(cfg, boosted, inhibition, shard)
    duty = duty_cycle_update(duty_cycle, active_mask,
                             cfg.duty_cycle_momentum)
    return boosted, active_columns, active_mask, duty


def _inhibit(cfg: SPConfig, boosted, inhibition, shard):
    """`sp_step`'s global inhibition: ((B, A) columns, (B, C) mask)."""
    if shard is not None:
        # the global inhibition, over every rank's columns in global order
        active_columns, active_mask = k_winners(
            shard.gather_columns(boosted), cfg.active_columns)
        return active_columns, active_mask[:, shard.lo:shard.hi]
    if inhibition is None:
        return k_winners(boosted, cfg.active_columns)
    return inhibition(cfg, boosted)


def _update(cfg: SPConfig, state: SPState, input_bits, learning: bool,
            active_columns, proximal_update, shard):
    """`sp_step`'s learning: the new (permanence, connected) tables."""
    permanence, connected = state.permanence, state.connected
    if learning and proximal_update is not None:
        permanence, connected = proximal_update(cfg, state, input_bits,
                                                active_columns)
    elif learning and shard is None:
        permanence, connected = sp_rows(cfg, permanence, connected,
                                        input_bits, active_columns)
    elif learning:
        # the rank's rows among the active columns, written back by it
        idx, _ = shard.local(active_columns)
        rows = permanence.gather(
            1, idx[:, :, None].expand(-1, -1, permanence.shape[-1]))
        rows, thr = _hebbian_rows(cfg, rows, input_bits)
        for table, new in ((permanence, rows),
                           (connected, pack_input(rows >= thr))):
            shard.put_rows(table, active_columns, new)
    return permanence, connected
