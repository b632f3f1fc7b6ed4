"""Batched SpatialPooler step.

Counterpart of `bithtm_tpu/models/spatial_pooler.py` (reference
`networks.py:26-35`): overlaps -> boosting -> global inhibition -> (when
learning) the Hebbian update of the A active rows; the duty-cycle EMA
updates whether or not the model learns (`networks.py:33`).

The permanence and connected tables are updated in place: the state
passed in is consumed, as the JAX scan donates its carry.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import SPConfig
from ..ops.overlap import overlaps as _overlaps, pack_input
from ..ops.regularization import boost, duty_cycle_update, k_winners
from ..state import SPState


class SPOutput(NamedTuple):
    active_columns: torch.Tensor    # (B, A) int32 top-k, descending value
    active_mask: torch.Tensor       # (B, C) bool
    overlaps: torch.Tensor          # (B, C) int32
    boosted_overlaps: torch.Tensor  # (B, C) f32


def _hebbian_rows(cfg: SPConfig, rows: torch.Tensor,
                  input_bits: torch.Tensor):
    """Hebbian update of gathered rows (B, A, I_pad) toward the inputs
    (`projections.py:23-24`: delta = x * (inc + dec) - dec); padding
    lanes get delta 0 and stay at the rail. Returns (rows', threshold)."""
    B, _, I_pad = rows.shape
    I = cfg.input_dim
    x = torch.zeros((B, I_pad), dtype=torch.int32, device=rows.device)
    x[:, :I] = input_bits.to(torch.int32)
    in_range = (torch.arange(I_pad, device=rows.device) < I)[None, None]
    if cfg.quantized:
        # exact integer units; the clip saturates a chronically
        # reinforced synapse at the rail instead of wrapping int16
        inc = cfg.to_units(cfg.permanence_increment)
        dec = cfg.to_units(cfg.permanence_decrement)
        delta = torch.where(in_range, (x * (inc + dec) - dec)[:, None], 0)
        rows = (rows.to(torch.int32) + delta).clamp(-32000, 32000).to(
            torch.int16)
        return rows, cfg.to_units(cfg.permanence_threshold)
    xf = x.to(torch.float32)
    delta = xf * (cfg.permanence_increment + cfg.permanence_decrement) \
        - cfg.permanence_decrement
    delta = torch.where(in_range, delta[:, None], 0.0)
    return rows + delta, cfg.permanence_threshold


def sp_step(cfg: SPConfig, state: SPState, input_bits: torch.Tensor,
            learning: bool) -> tuple[SPState, SPOutput]:
    """One SP timestep for B streams: ``input_bits`` is (B, I) bool."""
    ov = _overlaps(state.connected, input_bits)
    boosted = boost(ov, state.duty_cycle, cfg.boosting_intensity,
                    cfg.density)
    active_columns, active_mask = k_winners(boosted, cfg.active_columns)

    permanence, connected = state.permanence, state.connected
    if learning:
        idx = active_columns.long()
        rows = permanence.gather(
            1, idx[:, :, None].expand(-1, -1, permanence.shape[-1]))
        rows, thr = _hebbian_rows(cfg, rows, input_bits)
        permanence.scatter_(
            1, idx[:, :, None].expand(-1, -1, rows.shape[-1]), rows)
        packed = pack_input(rows >= thr)
        connected.scatter_(
            1, idx[:, :, None].expand(-1, -1, packed.shape[-1]), packed)

    duty = duty_cycle_update(state.duty_cycle, active_mask,
                             cfg.duty_cycle_momentum)
    new_state = SPState(permanence=permanence, connected=connected,
                        duty_cycle=duty)
    return new_state, SPOutput(active_columns, active_mask, ov, boosted)
