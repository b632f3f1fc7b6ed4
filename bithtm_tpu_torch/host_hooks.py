"""Host-side component substitution: a plain Python TM in the TM slot.

Counterpart of `bithtm_tpu/host_hooks.py`. The reference's composition
root takes an arbitrary Python object for its temporal-memory slot
(`networks.py:134,144`), and its example swaps in a pure-Python TM
(`example.py:7-12`). JAX calls the host TM inside its compiled step as
an `io_callback`; a CUDA graph cannot call Python, so the adapter says
``capturable = False`` and a wrapper that holds it runs the step's loop
(`models/graph.py`), calling the host code as it is, between the SP and
the metrics:

    def my_tm(active_columns, learning):      # plain NumPy, stateful
        ...
        return active_cells, winner_cells, prediction   # (N,) bools

    htm = HierarchicalTemporalMemory(
        1000, 2048, 32, temporal_memory=HostTemporalMemory(my_tm))

It reads the SP's active columns back to the host every step, so it is a
correctness and integration tool (differential testing, prototyping a TM
rule in NumPy), not a throughput path. Single stream only: host state
does not batch, exactly like the reference's stateful classes.
"""

from __future__ import annotations

import numpy as np
import torch

from .models.temporal_memory import TMOutput


class HostTemporalMemory:
    """Adapter: a host Python TM as an `htm_step` ``temporal_memory=``
    hook.

    ``step_fn(active_columns, learning) -> (active, winner, prediction)``
    runs on the host with NumPy inputs: ``active_columns`` is the SP's
    (A,) int32 top-k column list; the three returns are (N,)-shaped
    0/1-coercible cell masks (N = column_dim * cell_dim), matching the
    reference `TemporalMemory.State` triple (`networks.py:39-46`). State
    belongs to ``step_fn`` (closure or bound object).

    The adapter supplies the wrapper contract on top: it remembers the
    previous prediction (the loop metrics' correct/incorrect inputs,
    `example.py:55-57`), derives bursting columns (active columns with no
    previously predicted cell, `networks.py:96-97`), and leaves the
    carried TMState untouched. Outputs carry the stream axis (B = 1) on
    the device of the active columns.
    """

    capturable = False   # runs Python on the host each step

    def __init__(self, step_fn):
        self._fn = step_fn
        self._prev_prediction = None

    def reset(self):
        self._prev_prediction = None

    def __call__(self, cfg, state, draws, active_cols, learning,
                 compute_winner):
        if active_cols.shape[0] != 1:
            raise ValueError(
                f"HostTemporalMemory is single-stream (host state does not "
                f"batch); got {active_cols.shape[0]} streams")
        C, D = cfg.column_dim, cfg.cell_dim
        N = C * D
        ac = active_cols[0].cpu().numpy()
        prev = self._prev_prediction
        if prev is None:
            prev = np.zeros((N,), bool)
        active, winner, pred = self._fn(ac, learning)
        active = np.asarray(active, bool).reshape(N)
        winner = np.asarray(winner, bool).reshape(N)
        pred = np.asarray(pred, bool).reshape(N)
        self._prev_prediction = pred
        burst = np.zeros((C,), bool)
        burst[ac] = ~prev.reshape(C, D)[ac].any(axis=-1)

        def dev(a):
            return torch.from_numpy(np.ascontiguousarray(a)[None]).to(
                active_cols.device)

        def count(a):
            return torch.tensor([int(a.sum())], dtype=torch.int32,
                                device=active_cols.device)

        out = TMOutput(
            active_mask=dev(active),
            winner_mask=dev(winner),
            prediction=dev(pred),
            prev_prediction=dev(prev),
            prev_col_prediction=dev(prev.reshape(C, D).any(axis=-1)),
            bursting_columns=dev(burst),
            metrics={
                "tm_bursting_columns": count(burst),
                "tm_active_cells": count(active),
                "tm_winner_cells": count(winner),
            },
        )
        return state, out
