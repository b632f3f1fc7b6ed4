"""Object-style wrappers mirroring the reference public API.

Counterpart of `bithtm_tpu/networks.py` (reference `networks.py:7-149`):
stateful classes with `.process(...)` over the port's batched step at
B=1, so a user of the reference can switch with little friction:

    htm = HierarchicalTemporalMemory(1000, 2048, 32)
    sp_out, tm_out = htm.process(input_bits)

Each wrapper owns a B=1 state, a `torch.Generator` seeded from ``seed``
and a draw provider on its device (the card unless ``device="cpu"``).
The port's step consumes the state it is given, so a wrapper keeps the
returned state as its own, and assigning ``.state`` stores a copy: a
caller's state is never updated behind its back. Outputs drop the
stream axis. For throughput use the functional API (`htm_scan` over
many streams).
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from .config import SPConfig, make_htm_config, make_tm_config
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
        self._state, out = sp_step(
            self.config, self._state, self._input(input_bits), learning,
            boosting=self.boosting, inhibition=self.inhibition,
            overlap=self.overlap, proximal_update=self.proximal_update)
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
        draws = self.draws.step(need=learning or return_winner_cell)
        self._state, out = tm_step(
            self.config, self._state, draws, cols.reshape(1, -1),
            learning=learning, compute_winner=return_winner_cell,
            epsilon=epsilon)
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
        self._state, out = htm_step(
            self.config, self._state, self._input(input_bits), learning,
            return_winner_cell, draws=self.draws, boosting=self.boosting,
            inhibition=self.inhibition,
            temporal_memory=self.temporal_memory, overlap=self.overlap,
            proximal_update=self.proximal_update,
            distal_forward=self.distal_forward)
        # one host read for all metrics (int32 and float32 are exact in
        # float64)
        m = out.metrics
        host = torch.stack([v[0].double() for v in m.values()]).tolist()
        self.last_metrics = {k: x if m[k].is_floating_point() else int(x)
                             for k, x in zip(m, host)}
        return _unbatch(out.sp), _unbatch(out.tm)
