"""Random draws of the temporal memory, behind one provider object.

Each step of the JAX package draws, per stream, two uniform tie-break
jitters and the growth priorities (`temporal_memory.py:141,152,455`).
The port takes all three from a provider's `step()`, so the tests can
replay the JAX draws exactly while production draws from a
`torch.Generator`. A provider is called once per HTM step; ``need`` is
False when the step draws nothing (inference without winner cells).
`htm_scan_autocap` also needs ``with_config`` (the same random stream
drawing at another config's list widths) and ``get_state`` /
``set_state`` (to replay a chunk). A provider that draws on the card
can be captured in a step's CUDA graph (`models/graph.py`): it says
``capturable = True``, names what it draws with ``graph_key()`` and
registers its generator with the graph (``register_with``), so that
every replay draws what the loop draws; ``get_state`` / ``set_state``
stay right between replays. Other providers run the loop.

`RowDraws` hands a data-parallel rank its rows of a provider that draws
the whole batch, so that B streams split over ranks draw what they draw
in one process.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .config import TMConfig


class Draws(NamedTuple):
    u_seg: torch.Tensor    # (B, A, G) f32 uniform in [0, 1)
    u_least: torch.Tensor  # (B, A, D) f32 uniform in [0, 1)
    rnd: torch.Tensor      # (B, L, Wc) int32 carrying 32 random bits


class TorchDraws:
    """Production provider: draws on ``device`` from ``generator``
    (None: the device's default generator, seeded by
    `torch.manual_seed`)."""

    capturable = True

    def __init__(self, cfg: TMConfig, batch: int, device,
                 generator: torch.Generator | None = None):
        self.cfg = cfg
        self.batch = batch
        self.device = torch.device(device)
        self.generator = generator

    def with_config(self, cfg: TMConfig) -> TorchDraws:
        """The same generator drawing for ``cfg``: the growth draws are
        (L, Wc) of the config in force."""
        return TorchDraws(cfg, self.batch, self.device, self.generator)

    def _gen(self) -> torch.Generator:
        if self.generator is not None:
            return self.generator
        if self.device.type == "cuda":
            index = self.device.index
            if index is None:
                index = torch.cuda.current_device()
            return torch.cuda.default_generators[index]
        return torch.default_generator

    def get_state(self) -> torch.Tensor:
        """The generator's state, to replay the draws that follow."""
        return self._gen().get_state()

    def graph_key(self) -> tuple:
        """What a captured step draws: the same key draws the same."""
        return (self.cfg, self.batch, self.device, self.generator)

    def register_with(self, graph) -> None:
        """Registers a generator of its own with a CUDA graph before its
        capture (the device's default generator is registered already),
        so that each replay advances it as a step of the loop does."""
        if self.generator is not None:
            graph.register_generator_state(self.generator)

    def set_state(self, state: torch.Tensor) -> None:
        self._gen().set_state(state)

    def step(self, need: bool = True) -> Draws | None:
        if not need:
            return None
        cfg, B, g = self.cfg, self.batch, self.generator
        A, D, G = (cfg.active_columns, cfg.cell_dim,
                   cfg.segments_per_column)
        L, Wc = cfg.resolved_growth_capacity, cfg.resolved_winner_capacity
        kw = dict(generator=g, device=self.device)
        return Draws(
            u_seg=torch.rand((B, A, G), dtype=torch.float32, **kw),
            u_least=torch.rand((B, A, D), dtype=torch.float32, **kw),
            rnd=torch.randint(-(1 << 31), 1 << 31, (B, L, Wc),
                              dtype=torch.int32, **kw),
        )


class RowDraws:
    """The ``rows`` (a slice of the stream axis) of every draw of
    ``draws``, a provider of the global batch. Each rank of a data
    row holds one, over a provider built alike on every rank (same
    config, batch and generator seed), so that a rank's streams draw
    the numbers they draw in the single-process run: a rank draws the
    whole batch and keeps its rows. Replays through the inner provider's
    ``get_state`` / ``set_state``."""

    def __init__(self, draws, rows: slice):
        self.draws = draws
        self.rows = rows

    def with_config(self, cfg: TMConfig) -> RowDraws:
        return RowDraws(self.draws.with_config(cfg), self.rows)

    def get_state(self):
        return self.draws.get_state()

    def set_state(self, state) -> None:
        self.draws.set_state(state)

    def step(self, need: bool = True) -> Draws | None:
        d = self.draws.step(need)
        return None if d is None else Draws(*(t[self.rows] for t in d))
