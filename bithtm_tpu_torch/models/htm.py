"""HierarchicalTemporalMemory: the batched step and its T-step scan.

Counterpart of `bithtm_tpu/models/htm.py` (reference
`networks.py:146-149`): SP then TM for B independent streams at once.
`htm_scan` is a Python loop over the time axis; the state is updated in
place (the JAX scan donates its carry), so the state passed in is
consumed.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import HTMConfig
from ..rng import TorchDraws
from ..state import HTMState
from .spatial_pooler import SPOutput, sp_step
from .temporal_memory import TMOutput, tm_step


class HTMOutput(NamedTuple):
    sp: SPOutput
    tm: TMOutput
    metrics: dict


def _step_metrics(cfg: HTMConfig, sp_out: SPOutput, tm_out: TMOutput
                  ) -> dict:
    """The per-step metrics of the example loop (`example.py:50-57`),
    per stream (B,):
    correct = previously predicted columns that became active, incorrect
    = the rest of the previously predicted, plus the anomaly score."""
    prev_col_pred = tm_out.prev_col_prediction
    corrects = (prev_col_pred & sp_out.active_mask).sum(-1,
                                                        dtype=torch.int32)
    incorrects = prev_col_pred.sum(-1, dtype=torch.int32) - corrects
    burstings = tm_out.bursting_columns.sum(-1, dtype=torch.int32)
    return {
        "bursting": burstings,
        "correct": corrects,
        "incorrect": incorrects,
        "anomaly": burstings.to(torch.float32) / cfg.sp.active_columns,
        **tm_out.metrics,
    }


def htm_step(cfg: HTMConfig, state: HTMState, input_bits: torch.Tensor,
             learning: bool = True, compute_winner: bool = True,
             detailed_metrics: bool = True, draws=None,
             dense_outputs: bool = True) -> tuple[HTMState, HTMOutput]:
    """One timestep of B streams: ``input_bits`` is (B, I) bool.
    ``draws`` is a draw provider (`rng.TorchDraws` on the state's device
    when None); it is stepped once per call, as the JAX step splits its
    key once per step."""
    B = state.batch
    if input_bits.shape != (B, cfg.input_dim):
        raise ValueError(f"htm_step expects ({B}, {cfg.input_dim}) inputs, "
                         f"got {tuple(input_bits.shape)}")
    if draws is None:
        draws = TorchDraws(cfg.tm, B, state.tm.step.device)
    step_draws = draws.step(need=learning or compute_winner)
    sp_state, sp_out = sp_step(cfg.sp, state.sp, input_bits, learning)
    tm_state, tm_out = tm_step(
        cfg.tm, state.tm, step_draws, sp_out.active_columns, learning,
        compute_winner, detailed_metrics=detailed_metrics,
        col_active=sp_out.active_mask, dense_outputs=dense_outputs)
    return (HTMState(sp=sp_state, tm=tm_state),
            HTMOutput(sp_out, tm_out, _step_metrics(cfg, sp_out, tm_out)))


def htm_scan(cfg: HTMConfig, state: HTMState, inputs: torch.Tensor,
             learning: bool = True, compute_winner: bool = True,
             detailed_metrics: bool = True, draws=None
             ) -> tuple[HTMState, dict]:
    """Run a (T, B, I) input sequence through the recurrence. Returns
    (final state, {metric: (T, B) tensor}). Only the outputs the metrics
    read are built (no dense (B, N) masks)."""
    B = state.batch
    if inputs.dim() != 3 or tuple(inputs.shape[1:]) != (B, cfg.input_dim):
        raise ValueError(f"htm_scan expects (T, {B}, {cfg.input_dim}) "
                         f"inputs, got {tuple(inputs.shape)}")
    if draws is None:
        draws = TorchDraws(cfg.tm, B, state.tm.step.device)
    per_step: dict[str, list] = {}
    for x in inputs:
        state, out = htm_step(cfg, state, x, learning, compute_winner,
                              detailed_metrics, draws, dense_outputs=False)
        for k, v in out.metrics.items():
            per_step.setdefault(k, []).append(v)
    return state, {k: torch.stack(v) for k, v in per_step.items()}
