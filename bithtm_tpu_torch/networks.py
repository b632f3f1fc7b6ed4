"""Object-style wrappers mirroring the reference public API.

Counterpart of `bithtm_tpu/networks.py` (reference `networks.py:7-149`):
stateful classes with `.process(...)` over the port's batched step at
B=1, so a user of the reference can switch with little friction:

    htm = HierarchicalTemporalMemory(1000, 2048, 32)
    sp_out, tm_out = htm.process(input_bits)

Each wrapper owns a B=1 state, a `torch.Generator` seeded from ``seed``
and a draw provider on its device (the card unless ``device="cpu"``).
On the card `process` replays the step's CUDA graph, captured at the
first call of each flag set (`models/graph.py`; the JAX wrappers call
jitted steps): the hooks, torch functions on device tensors, are
captured with the step, and the outputs returned are copies, which the
next replay does not overwrite. A hook that calls the host
(`host_hooks.HostTemporalMemory`) runs the step's loop, as the CPU and
`graph.eager()` do. The port's step consumes the state it is given, so a
wrapper keeps the returned state as its own, and assigning ``.state``
stores a copy: a caller's state is never updated behind its back.
Outputs drop the stream axis. For throughput use the functional API
(`htm_scan` over many streams).
"""

from __future__ import annotations

import copy
import functools

import numpy as np
import torch

from .config import SPConfig, make_htm_config, make_tm_config
from .models import graph
from .models.htm import htm_step
from .models.spatial_pooler import SPOutput, sp_step
from .models.temporal_memory import TMOutput, tm_step
from .rng import TorchDraws
from .state import htm_init, sp_init, tm_init


def _unbatch(out):
    """A step output (NamedTuple of (1, ...) tensors, metrics dict) with
    the stream axis dropped."""
    fields = {}
    for name, v in out._asdict().items():
        if isinstance(v, dict):
            fields[name] = {k: t[0] for k, t in v.items()}
        else:
            fields[name] = None if v is None else v[0]
    return type(out)(**fields)


class _Stateful:
    """The state a wrapper owns: assigning it stores a copy."""

    @property
    def state(self):
        return self._state

    @state.setter
    def state(self, value):
        self._state = copy.deepcopy(value)

    def _input(self, input_bits) -> torch.Tensor:
        if isinstance(input_bits, torch.Tensor):
            x = input_bits.to(self.device, torch.bool)
        else:
            x = torch.from_numpy(np.asarray(input_bits, bool)).to(self.device)
        return x.reshape(1, -1)


def _sp_graph_step(cfg, learning, hooks, state, x, consts, draws):
    return sp_step(cfg, state, x, learning, *hooks)


def _tm_graph_step(cfg, learning, compute_winner, epsilon, state, cols,
                   consts, draws):
    return tm_step(cfg, state, draws.step(need=learning or compute_winner),
                   cols, learning=learning, compute_winner=compute_winner,
                   epsilon=epsilon)


def _htm_graph_step(cfg, learning, compute_winner, hooks, state, x, consts,
                    draws):
    boosting, inhibition, temporal_memory, overlap, proximal_update, \
        distal_forward = hooks
    return htm_step(cfg, state, x, learning, compute_winner, draws=draws,
                    boosting=boosting, inhibition=inhibition,
                    temporal_memory=temporal_memory, overlap=overlap,
                    proximal_update=proximal_update,
                    distal_forward=distal_forward)


def _generator(device, seed: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


class SpatialPooler(_Stateful):
    """Stateful wrapper over `sp_step` (reference `networks.py:7-35`).
    ``boosting`` / ``inhibition`` / ``overlap`` / ``proximal_update``
    are the component hooks of `sp_step`, with the stream axis."""

    def __init__(self, input_dim, column_dim, active_columns, seed=0,
                 boosting=None, inhibition=None, overlap=None,
                 proximal_update=None, device="cuda", **overrides):
        self.config = SPConfig(input_dim=input_dim, column_dim=column_dim,
                               active_columns=active_columns, **overrides)
        self.active_columns = active_columns
        self.boosting = boosting
        self.inhibition = inhibition
        self.overlap = overlap
        self.proximal_update = proximal_update
        self.device = torch.device(device)
        self.generator = _generator(self.device, seed)
        self._state = sp_init(self.config, 1, self.generator, self.device)

    def process(self, input_bits, learning=True) -> SPOutput:
        x = self._input(input_bits)
        hooks = (self.boosting, self.inhibition, self.overlap,
                 self.proximal_update)
        step = functools.partial(_sp_graph_step, self.config, learning,
                                 hooks)
        if graph.replays(x, hooks=hooks):
            self._state, out = graph.step(
                ("sp_process", self.config, learning, hooks), step,
                self._state, x)
        else:
            self._state, out = step(self._state, x, None, None)
        return _unbatch(out)


class TemporalMemory(_Stateful):
    """Stateful wrapper over `tm_step` (reference `networks.py:38-128`)."""

    def __init__(self, column_dim, cell_dim, active_columns=None, seed=0,
                 device="cuda", **overrides):
        if active_columns is None:
            active_columns = round(column_dim * 0.02)
        self.config = make_tm_config(column_dim, cell_dim, active_columns,
                                     **overrides)
        self.device = torch.device(device)
        self.generator = _generator(self.device, seed)
        self.draws = TorchDraws(self.config, 1, self.device, self.generator)
        self._state = tm_init(self.config, 1, self.device)

    def process(self, sp_output, learning=True, return_winner_cell=True,
                epsilon=None) -> TMOutput:
        """``sp_output``: an `SPOutput` (of `SpatialPooler.process`) or
        the (A,) active columns. ``epsilon`` overrides the config's
        tie-equality tolerance for this call (reference
        `networks.py:91`)."""
        cols = torch.as_tensor(getattr(sp_output, "active_columns",
                                       sp_output)).to(self.device,
                                                      torch.int32)
        cols = cols.reshape(1, -1)
        step = functools.partial(_tm_graph_step, self.config, learning,
                                 return_winner_cell, epsilon)
        if graph.replays(cols, self.draws):
            self._state, out = graph.step(
                ("tm_process", self.config, learning, return_winner_cell,
                 epsilon), step, self._state, cols, draws=self.draws)
        else:
            self._state, out = step(self._state, cols, None, self.draws)
        return _unbatch(out)


class HierarchicalTemporalMemory(_Stateful):
    """Stateful wrapper over `htm_step` (reference `networks.py:131-149`).

    ``boosting`` / ``inhibition`` / ``overlap`` / ``proximal_update`` /
    ``distal_forward`` / ``temporal_memory`` are the component hooks of
    `htm_step` (with the stream axis); for host code, such as a NumPy
    TM, wrap it in `host_hooks.HostTemporalMemory`. ``last_metrics``
    holds the last step's metrics as plain ints and floats."""

    def __init__(self, input_dim, column_dim, cell_dim, active_columns=None,
                 seed=0, boosting=None, inhibition=None,
                 temporal_memory=None, overlap=None, proximal_update=None,
                 distal_forward=None, device="cuda", **tm_overrides):
        self.config = make_htm_config(input_dim, column_dim, cell_dim,
                                      active_columns, **tm_overrides)
        self.column_dim = column_dim
        self.cell_dim = cell_dim
        self.active_columns = self.config.sp.active_columns
        self.boosting = boosting
        self.inhibition = inhibition
        self.temporal_memory = temporal_memory
        self.overlap = overlap
        self.proximal_update = proximal_update
        self.distal_forward = distal_forward
        self.device = torch.device(device)
        self.generator = _generator(self.device, seed)
        self.draws = TorchDraws(self.config.tm, 1, self.device,
                                self.generator)
        self._state = htm_init(self.config, self.generator, self.device)
        self.last_metrics = {}

    def process(self, input_bits, learning=True, return_winner_cell=True
                ) -> tuple[SPOutput, TMOutput]:
        x = self._input(input_bits)
        hooks = (self.boosting, self.inhibition, self.temporal_memory,
                 self.overlap, self.proximal_update, self.distal_forward)
        step = functools.partial(_htm_graph_step, self.config, learning,
                                 return_winner_cell, hooks)
        if graph.replays(x, self.draws, hooks):
            self._state, out = graph.step(
                ("htm_process", self.config, learning, return_winner_cell,
                 hooks), step, self._state, x, draws=self.draws)
        else:
            self._state, out = step(self._state, x, None, self.draws)
        # one host read for all metrics (int32 and float32 are exact in
        # float64)
        m = out.metrics
        host = torch.stack([v[0].double() for v in m.values()]).tolist()
        self.last_metrics = {k: x if m[k].is_floating_point() else int(x)
                             for k, x in zip(m, host)}
        return _unbatch(out.sp), _unbatch(out.tm)
