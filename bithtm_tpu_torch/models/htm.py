"""HierarchicalTemporalMemory: the batched step and its T-step scan.

Counterpart of `bithtm_tpu/models/htm.py` (reference
`networks.py:146-149`): SP then TM for B independent streams at once.
`htm_scan` runs the step over the time axis: on the card as replays of
the step's CUDA graph (`models/graph.py`, the counterpart of the JAX
scan's `jax.jit`), on the CPU and inside `graph.eager()` as a Python
loop. The state passed in is consumed, as the JAX scan donates its
carry. `htm_serve_scan` is the serving scan (learning off, no winner
cells, optionally over a compact serving table); both share `_scan_impl`.
`htm_scan_autocap` runs `htm_scan` in chunks under tuned list widths and
widens them on the first counted drop. `resume_learning` makes a state
served from a compact table safe to learn from again. `htm_step(...,
shard=)` is the step of a model-parallel rank that holds a column shard
(`parallel/mesh.py` drives it, eagerly). `htm_step_batch` is
`htm_step` under the JAX package's name for its batched step.
"""

from __future__ import annotations

import copy
import dataclasses
import functools
import time
from typing import NamedTuple

import torch

from ..config import HTMConfig
from ..ops.shard import ColumnShard
from ..rng import TorchDraws
from ..state import HTMState
from ..utils.profiling import site
from . import graph
from .spatial_pooler import SPOutput, sp_step
from .temporal_memory import COLUMN_SUMS, TMOutput, tm_resume, tm_step


class HTMOutput(NamedTuple):
    sp: SPOutput
    tm: TMOutput
    metrics: dict


@functools.cache
def _f32_reciprocal(n: int) -> float:
    """1/n rounded to float32: XLA divides by a constant as a product
    with this reciprocal (ROADMAP fault i)."""
    return (torch.tensor(1.0, dtype=torch.float32) / n).item()


def _step_metrics(cfg: HTMConfig, sp_out: SPOutput, tm_out: TMOutput,
                  shard: ColumnShard | None = None) -> dict:
    """The per-step metrics of the example loop (`example.py:50-57`),
    per stream (B,):
    correct = previously predicted columns that became active, incorrect
    = the rest of the previously predicted, plus the anomaly score, and
    the TM's metrics. Under a column shard the column masks are the
    rank's columns, so correct, the predicted count and the TM's
    `COLUMN_SUMS` are summed across its group, in one collective;
    bursting counts active columns, the same on every rank."""
    prev_col_pred = tm_out.prev_col_prediction
    corrects = (prev_col_pred & sp_out.active_mask).sum(-1,
                                                        dtype=torch.int32)
    predicted = prev_col_pred.sum(-1, dtype=torch.int32)
    tm_metrics = dict(tm_out.metrics)
    if shard is not None:
        summed = [k for k in COLUMN_SUMS if k in tm_metrics]
        corrects, predicted, *sums = shard.sum(
            [corrects, predicted, *(tm_metrics[k] for k in summed)])
        tm_metrics.update(zip(summed, sums))
    incorrects = predicted - corrects
    burstings = tm_out.bursting_columns.sum(-1, dtype=torch.int32)
    return {
        "bursting": burstings,
        "correct": corrects,
        "incorrect": incorrects,
        "anomaly": burstings.to(torch.float32) * _f32_reciprocal(
            cfg.sp.active_columns),
        **tm_metrics,
    }


def htm_step(cfg: HTMConfig, state: HTMState, input_bits: torch.Tensor,
             learning: bool = True, compute_winner: bool = True,
             detailed_metrics: bool = True, draws=None,
             dense_outputs: bool = True, frozen_word=None,
             serving_table=None, boosting=None, inhibition=None,
             temporal_memory=None, overlap=None, proximal_update=None,
             distal_forward=None, shard: ColumnShard | None = None
             ) -> tuple[HTMState, HTMOutput]:
    """One timestep of B streams: ``input_bits`` is (B, I) bool.
    ``draws`` is a draw provider (`rng.TorchDraws` on the state's device
    when None); it is stepped once per call, as the JAX step splits its
    key once per step. ``frozen_word`` and ``serving_table`` select the
    inference forward of `tm_step`.

    The component hooks of `htm.py:48-88`: ``boosting``, ``inhibition``,
    ``overlap`` and ``proximal_update`` go to `sp_step`,
    ``distal_forward`` to `tm_step` (inference only), and
    ``temporal_memory`` replaces `tm_step` itself:

      temporal_memory(tm_cfg, tm_state, draws, active_cols (B, A),
                      learning, compute_winner) -> (tm_state, TMOutput)

    with this step's draws (None where the step draws nothing) in place
    of the JAX key. A host-side TM plugs in through
    `host_hooks.HostTemporalMemory`.

    ``shard`` (`ops/shard.py`): the state holds this rank's columns of a
    model-parallel group; the step then takes no hooks, no inference
    table and no dense outputs (`sp_step`, `tm_step`), as the JAX
    sharded step takes none."""
    B = state.batch
    if input_bits.shape != (B, cfg.input_dim):
        raise ValueError(f"htm_step expects ({B}, {cfg.input_dim}) inputs, "
                         f"got {tuple(input_bits.shape)}")
    if (frozen_word is not None or serving_table is not None
            or distal_forward is not None) and temporal_memory is not None:
        raise ValueError(
            "frozen_word/serving_table/distal_forward configure the "
            "built-in tm_step; a temporal_memory hook would silently "
            "ignore them — pass them to the hook yourself instead")
    if shard is not None and temporal_memory is not None:
        raise ValueError("the column-sharded step takes no temporal_memory "
                         "hook")
    if draws is None:
        draws = TorchDraws(cfg.tm, B, state.tm.step.device)
    with site("htm_step.draws"):
        step_draws = draws.step(need=learning or compute_winner)
    sp_state, sp_out = sp_step(cfg.sp, state.sp, input_bits, learning,
                               boosting=boosting, inhibition=inhibition,
                               overlap=overlap,
                               proximal_update=proximal_update, shard=shard)
    if temporal_memory is None:
        # the SP's mask is the stock k_winners one only without an
        # inhibition hook; a hook's mask feeds the duty cycle alone
        tm_state, tm_out = tm_step(
            cfg.tm, state.tm, step_draws, sp_out.active_columns, learning,
            compute_winner, detailed_metrics=detailed_metrics,
            col_active=sp_out.active_mask if inhibition is None else None,
            dense_outputs=dense_outputs, frozen_word=frozen_word,
            serving_table=serving_table, distal_forward=distal_forward,
            shard=shard)
    else:
        tm_state, tm_out = temporal_memory(
            cfg.tm, state.tm, step_draws, sp_out.active_columns, learning,
            compute_winner)
    with site("htm_step.metrics"):
        metrics = _step_metrics(cfg, sp_out, tm_out, shard)
    return (HTMState(sp=sp_state, tm=tm_state),
            HTMOutput(sp_out, tm_out, metrics))


def htm_step_batch(cfg: HTMConfig, state: HTMState,
                   input_bits: torch.Tensor, learning: bool = True,
                   compute_winner: bool = True,
                   detailed_metrics: bool = True, frozen_word=None,
                   serving_table=None) -> tuple[HTMState, HTMOutput]:
    """The JAX package's batched step (`htm.py:133-153`, a `vmap` of its
    single-stream step) under its name and signature: the port's
    `htm_step` is batched already, with draws from the state's device's
    default generator."""
    return htm_step(cfg, state, input_bits, learning, compute_winner,
                    detailed_metrics, frozen_word=frozen_word,
                    serving_table=serving_table)


def _scan_step(cfg: HTMConfig, learning: bool, compute_winner: bool,
               detailed_metrics: bool, state: HTMState, x: torch.Tensor,
               consts, draws) -> tuple[HTMState, dict]:
    """The step a scan runs, with its metrics as its output; ``consts``
    is (frozen_word, serving_table)."""
    frozen_word, serving_table = consts
    state, out = htm_step(cfg, state, x, learning, compute_winner,
                          detailed_metrics, draws, dense_outputs=False,
                          frozen_word=frozen_word,
                          serving_table=serving_table)
    return state, out.metrics


def _scan_impl(cfg: HTMConfig, state: HTMState, inputs: torch.Tensor,
               learning: bool, compute_winner: bool, detailed_metrics: bool,
               draws=None, frozen_word=None, serving_table=None
               ) -> tuple[HTMState, dict]:
    """The scan shared by `htm_scan` and `htm_serve_scan`, so that the
    serving scan cannot drift from the standard one: replays of the
    step's graph (`graph.scan`) where `graph.replays` says so, else the
    loop."""
    B = state.batch
    if inputs.dim() != 3 or tuple(inputs.shape[1:]) != (B, cfg.input_dim):
        raise ValueError(f"htm_scan expects (T, {B}, {cfg.input_dim}) "
                         f"inputs, got {tuple(inputs.shape)}")
    if draws is None:
        draws = TorchDraws(cfg.tm, B, state.tm.step.device)
    step = functools.partial(_scan_step, cfg, learning, compute_winner,
                             detailed_metrics)
    consts = (frozen_word, serving_table)
    if inputs.shape[0] and graph.replays(state.tm.step, draws):
        return graph.scan(("htm_scan", cfg, learning, compute_winner,
                           detailed_metrics), step, state, inputs, consts,
                          draws)
    per_step: dict[str, list] = {}
    for x in inputs:
        state, m = step(state, x, consts, draws)
        for k, v in m.items():
            per_step.setdefault(k, []).append(v)
    return state, {k: torch.stack(v) for k, v in per_step.items()}


def htm_scan(cfg: HTMConfig, state: HTMState, inputs: torch.Tensor,
             learning: bool = True, compute_winner: bool = True,
             detailed_metrics: bool = True, draws=None
             ) -> tuple[HTMState, dict]:
    """Run a (T, B, I) input sequence through the recurrence. Returns
    (final state, {metric: (T, B) tensor}). Only the outputs the metrics
    read are built (no dense (B, N) masks). On the card each step is a
    replay of its captured graph and the state returned is the graph's
    buffers (`models/graph.py`: the state passed in belongs to the
    call)."""
    return _scan_impl(cfg, state, inputs, learning, compute_winner,
                      detailed_metrics, draws)


CAP_DROP_METRICS = ("tm_dropped_winner_candidates",
                    "tm_dropped_growth_segments")


def _cap_drops(metrics: dict) -> int:
    """The counted winner/growth cap drops of a chunk: one host read."""
    return int(sum(metrics[k].sum(dtype=torch.int64)
                   for k in CAP_DROP_METRICS if k in metrics))


def htm_scan_autocap(cfg: HTMConfig, state: HTMState, inputs: torch.Tensor,
                     *, tuned: dict, safe: dict | None = None,
                     chunk: int = 256, learning: bool = True,
                     compute_winner: bool = True,
                     detailed_metrics: bool = False, on_chunk=None,
                     draws=None) -> tuple[HTMState, dict, dict]:
    """Chunked `htm_scan` under the ``tuned`` list widths
    (``winner_capacity`` / ``growth_capacity`` overrides), widened on the
    first counted drop (`htm.py:225-315`).

    The widths are per-step scratch, not state, so a config with other
    caps resumes from the same state (on the card, the same graph
    buffers: the tuned config's graph replays, and the safe config's is
    captured on escalation). Before each tuned chunk the state and the
    draw provider's generator state are copied; if the chunk counts any
    drop of `CAP_DROP_METRICS`, both are restored (the state copied back
    into the buffers it left, `graph.restore_into`), the config
    escalates to the ``safe`` overrides (default: the config's own auto
    caps) and the same chunk runs again, with the same random stream,
    so the trajectory up to the escalation is the tuned one and the rest
    the safe one. The draw provider is rebuilt for the config in force
    (``draws.with_config``: the growth draws are (L, Wc) of that
    config); ``draws`` defaults to a `TorchDraws` on the state's device
    and its default generator.

    Returns ``(state, metrics, info)``: metrics {name: (T, B)} over all
    chunks, as `htm_scan` returns them; ``info`` holds
    ``escalated_at_step`` (None if the tuned caps held), ``tuned_drops``
    (the drops of the discarded chunk) and ``chunks``. Each chunk reads
    one scalar on the host. ``on_chunk(start_step, seconds, escalated,
    drops)`` is called after each produced chunk.

    One deliberate difference from the JAX function: ``drops`` is the
    count of the chunk as produced, under whichever caps ran it, where
    JAX reports the discarded tuned run's count for the escalating chunk
    and 0 for every later one. A safe chunk that drops is reported, not
    hidden. The JAX ``unroll`` has no meaning
    here (a step is one graph replay or one loop iteration)."""
    def with_caps(overrides):
        return dataclasses.replace(
            cfg, tm=dataclasses.replace(cfg.tm, **overrides))

    cfg_tuned, cfg_safe = with_caps(tuned), with_caps(safe or {})
    if draws is None:
        draws = TorchDraws(cfg_tuned.tm, state.batch, state.tm.step.device)
    draws = draws.with_config(cfg_tuned.tm)
    active_cfg = cfg_tuned
    per_chunk: list[dict] = []
    escalated_at, tuned_drops = None, 0
    for t0 in range(0, inputs.shape[0], chunk):
        xs = inputs[t0:t0 + chunk]
        wall0 = time.perf_counter()
        tuned_now = active_cfg is cfg_tuned
        if tuned_now:
            saved = copy.deepcopy(state), draws.get_state()
        new_state, m = htm_scan(active_cfg, state, xs, learning,
                                compute_winner, detailed_metrics, draws)
        drops = _cap_drops(m)
        escalated_now = tuned_now and drops > 0
        if escalated_now:
            # discard the dropping chunk, re-run it under the safe caps
            tuned_drops, escalated_at = drops, t0
            active_cfg = cfg_safe
            state = graph.restore_into(new_state, saved[0])
            gen_state = saved[1]
            draws = draws.with_config(cfg_safe.tm)
            draws.set_state(gen_state)
            new_state, m = htm_scan(active_cfg, state, xs, learning,
                                    compute_winner, detailed_metrics, draws)
            drops = _cap_drops(m)
        state = new_state
        per_chunk.append(m)
        if on_chunk is not None:
            if state.tm.step.is_cuda:
                torch.cuda.synchronize(state.tm.step.device)
            on_chunk(t0, time.perf_counter() - wall0, escalated_now, drops)
    metrics = {k: torch.cat([m[k] for m in per_chunk]) for k in per_chunk[0]}
    info = {"escalated_at_step": escalated_at, "tuned_drops": tuned_drops,
            "chunks": len(per_chunk)}
    return state, metrics, info


def htm_serve_scan(cfg: HTMConfig, state: HTMState, inputs: torch.Tensor,
                   compute_winner: bool = False,
                   detailed_metrics: bool | None = None,
                   serving_table=None, draws=None) -> tuple[HTMState, dict]:
    """The serving scan (`htm.py:339-380`): `htm_scan` with learning off
    and no winner cells by default; bit-equal to ``htm_scan(...,
    learning=False, compute_winner=False)``.

    With ``serving_table`` (a `make_serving_table` table of this state)
    the forward pass reads connected synapses only; predictions and
    metrics stay bit-equal, while the final state's ``synapse_act`` and
    ``matching_word`` are stale until `resume_learning`. It needs
    ``compute_winner=False``; ``detailed_metrics`` defaults to False
    with a table and True without."""
    if detailed_metrics is None:
        detailed_metrics = serving_table is None
    return _scan_impl(cfg, state, inputs, False, compute_winner,
                      detailed_metrics, draws, serving_table=serving_table)


def resume_learning(cfg: HTMConfig, state: HTMState) -> HTMState:
    """Make a state served from a compact table safe to learn from again
    (`htm.py:318-336`): `tm_resume` re-derives ``synapse_act`` and
    ``matching_word``, so serve -> resume -> learn is bit-equal to having
    served unpacked. A no-op on a state that never served packed."""
    return HTMState(sp=state.sp, tm=tm_resume(cfg.tm, state.tm))
