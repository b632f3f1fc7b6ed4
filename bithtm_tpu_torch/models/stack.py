"""Multi-level HTM hierarchy.

Counterpart of `bithtm_tpu/models/stack.py`: layer k's SpatialPooler
pools over layer k-1's active-cell SDR, so higher layers form
increasingly abstract, temporally stable representations.

`StackConfig` is a tuple of per-layer `HTMConfig`s validated to chain
dimensionally; the state is a tuple of `HTMState`s; `stack_step` runs
the layers bottom-up, `stack_scan` runs it over T: on the card as
replays of its captured graph (`models/graph.py`, as the JAX
`stack_scan` is jitted), on the CPU and inside `graph.eager()` as a
Python loop. Each
layer draws from its own provider, as each JAX layer splits its own key:
``draws`` is a tuple with one provider a layer (`stack_draws` makes them
from one generator). Like `htm_scan`, both update the layers' tables in
place, so the state passed in is consumed.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Sequence

import torch

from ..config import make_htm_config
from ..rng import TorchDraws
from ..state import htm_init_batch
from . import graph
from .htm import htm_step


class StackConfig(NamedTuple):
    layers: tuple  # tuple[HTMConfig, ...]


class StackOutput(NamedTuple):
    layers: tuple  # tuple[HTMOutput, ...] bottom-up
    metrics: dict  # per-layer metrics, keys prefixed "L{k}_"


def make_stack_config(input_dim: int, layer_dims: Sequence[tuple],
                      **common) -> StackConfig:
    """layer_dims: [(column_dim, cell_dim), ...] bottom-up. Layer k>0
    pools over layer k-1's num_cells-wide active-cell SDR."""
    layers = []
    in_dim = input_dim
    for column_dim, cell_dim in layer_dims:
        cfg = make_htm_config(in_dim, column_dim, cell_dim, **common)
        layers.append(cfg)
        in_dim = cfg.tm.num_cells
    return StackConfig(layers=tuple(layers))


def stack_init(cfg: StackConfig, batch: int = 1,
               generator: torch.Generator | None = None, device=None):
    """B streams of every layer, bottom-up, each layer's SP drawn from
    ``generator`` in turn (None: the device's default generator); on
    ``device`` (None: the generator's device, else the card)."""
    return tuple(htm_init_batch(c, batch, generator, device)
                 for c in cfg.layers)


def stack_draws(cfg: StackConfig, batch: int, device,
                generator: torch.Generator | None = None) -> tuple:
    """One `TorchDraws` a layer, all drawing from ``generator`` (None:
    the device's default generator)."""
    return tuple(TorchDraws(c.tm, batch, device, generator)
                 for c in cfg.layers)


def stack_step(cfg: StackConfig, state, input_bits: torch.Tensor,
               learning: bool = True, draws=None):
    """One timestep of B streams ((B, input_dim) bool) through all
    layers bottom-up. The active-cell mask of layer k
    (temporal-context-bearing) is layer k+1's input SDR, so every layer
    but the last builds its dense outputs; the last layer's masks are
    None, as in `htm_scan`."""
    if draws is None:
        draws = stack_draws(cfg, state[0].batch, state[0].tm.step.device)
    new_states, outputs, metrics = [], [], {}
    x = input_bits
    last = len(cfg.layers) - 1
    for k, (layer_cfg, layer_state, layer_draws) in enumerate(
            zip(cfg.layers, state, draws, strict=True)):
        layer_state, out = htm_step(layer_cfg, layer_state, x, learning,
                                    draws=layer_draws,
                                    dense_outputs=k < last)
        new_states.append(layer_state)
        outputs.append(out)
        for name, v in out.metrics.items():
            metrics[f"L{k}_{name}"] = v
        x = out.tm.active_mask
    return tuple(new_states), StackOutput(tuple(outputs), metrics)


def _stack_scan_step(cfg: StackConfig, learning: bool, state, x, consts,
                     draws):
    """The step `stack_scan` runs, with its metrics as its output."""
    state, out = stack_step(cfg, state, x, learning, draws)
    return state, out.metrics


def stack_scan(cfg: StackConfig, state, inputs: torch.Tensor,
               learning: bool = True, draws=None):
    """`stack_step` over a (T, B, input_dim) sequence. Returns (final
    state, {metric: (T, B) tensor}); on the card the state returned is
    the graph's buffers (the state passed in belongs to the call)."""
    if draws is None:
        draws = stack_draws(cfg, state[0].batch, state[0].tm.step.device)
    step = functools.partial(_stack_scan_step, cfg, learning)
    if inputs.shape[0] and graph.replays(state[0].tm.step, draws):
        return graph.scan(("stack_scan", cfg, learning), step, state,
                          inputs, draws=draws)
    per_step: dict[str, list] = {}
    for x in inputs:
        state, m = step(state, x, None, draws)
        for k, v in m.items():
            per_step.setdefault(k, []).append(v)
    return state, {k: torch.stack(v) for k, v in per_step.items()}
