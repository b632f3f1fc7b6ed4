"""State conversion between the JAX package and the port, via numpy.

`htm_state_from_numpy` takes a JAX `HTMState` handed over as numpy
arrays: either a nested mapping ``{"sp": {leaf: array}, "tm": {...}}``
or any object whose ``sp`` / ``tm`` attributes carry the leaves (a JAX
state itself works, since ``np.asarray`` reads its arrays; its random
key is not read). A single-stream state becomes a batch of one.
`htm_state_to_numpy` is the inverse and returns the nested mapping with
the JAX dtypes (uint32 words restored through a view), copied, so a
round trip is bit-equal and a later step does not change it.
`serving_table_from_numpy` / `serving_table_to_numpy` do the same for a
compact serving table (`ops.serving.ServingTable`),
`named_state_from_numpy` / `named_state_to_numpy` for the readout's
`ClassifierState` and the two anomaly-stage states, and
`stack_state_from_numpy` / `stack_state_to_numpy` for a stack's tuple of
layer states.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Mapping

import numpy as np
import torch

from .encoders import AnomalyLikelihoodState, SeasonalZScoreState
from .ops.serving import ServingTable
from .readout import ClassifierState
from .state import HTMState, SPState, TMState

# leaves the JAX package stores as uint32 and the port as int32
U32_LEAVES = frozenset({"active_bits", "winner_bits", "prediction"})


def _get(obj, name):
    return obj[name] if isinstance(obj, Mapping) else getattr(obj, name)


def _leaf_to_torch(name: str, x, batched: bool, device) -> torch.Tensor:
    a = np.asarray(x)
    if name in U32_LEAVES:
        a = a.view(np.int32)
    if not batched:
        a = a[None]
    return torch.from_numpy(np.array(a, order="C")).to(device)  # a copy


def _leaf_to_numpy(name: str, t: torch.Tensor) -> np.ndarray:
    # a copy even of a CPU tensor: a step updates the tables in place
    a = t.detach().to("cpu", copy=True).numpy()
    return a.view(np.uint32) if name in U32_LEAVES else a


def htm_state_from_numpy(tree, device="cuda") -> HTMState:
    """JAX `HTMState` leaves (numpy) -> port `HTMState` on ``device``."""
    sp, tm = _get(tree, "sp"), _get(tree, "tm")
    batched = np.asarray(_get(tm, "step")).ndim == 1

    def build(cls, src):
        return cls(**{
            f.name: _leaf_to_torch(f.name, _get(src, f.name), batched,
                                   device)
            for f in dataclasses.fields(cls)
        })

    return HTMState(sp=build(SPState, sp), tm=build(TMState, tm))


def htm_state_to_numpy(state: HTMState) -> dict:
    """Port `HTMState` -> ``{"sp": {leaf: array}, "tm": {...}}`` with the
    JAX package's dtypes and a leading stream axis."""
    return {
        part: {f.name: _leaf_to_numpy(f.name, getattr(sub, f.name))
               for f in dataclasses.fields(sub)}
        for part, sub in (("sp", state.sp), ("tm", state.tm))
    }


def serving_table_from_numpy(table, device="cuda") -> ServingTable:
    """JAX `ServingTable` (``rows``, ``ext_col``: attributes or mapping
    keys, numpy-readable) -> port `ServingTable` on ``device``; a
    single-stream table becomes a batch of one."""
    rows = np.asarray(_get(table, "rows"))
    batched = rows.ndim == 3
    return ServingTable(*(
        _leaf_to_torch(name, _get(table, name), batched, device)
        for name in ServingTable._fields))


def serving_table_to_numpy(table: ServingTable) -> dict:
    """Port `ServingTable` -> ``{"rows": (B, R, 128), "ext_col": (B, E)}``
    int32 arrays."""
    return {name: _leaf_to_numpy(name, getattr(table, name))
            for name in ServingTable._fields}


# a leaf of each NamedTuple state and its rank in a single-stream state
_UNBATCHED_RANK = {ClassifierState: ("weights", 2),
                   AnomalyLikelihoodState: ("pos", 0),
                   SeasonalZScoreState: ("pos", 0)}


def named_state_from_numpy(cls, tree, device="cuda"):
    """A JAX `ClassifierState`, `AnomalyLikelihoodState` or
    `SeasonalZScoreState` (attributes or mapping keys, numpy-readable) ->
    the port's ``cls`` on ``device``; a single-stream state becomes a
    batch of one."""
    name, rank = _UNBATCHED_RANK[cls]
    batched = np.asarray(_get(tree, name)).ndim == rank + 1
    return cls(*(_leaf_to_torch(f, _get(tree, f), batched, device)
                 for f in cls._fields))


def named_state_to_numpy(state) -> dict:
    """A port `ClassifierState` or anomaly-stage state -> ``{leaf:
    array}`` with a leading stream axis, copied."""
    return {f: _leaf_to_numpy(f, getattr(state, f)) for f in state._fields}


def stack_state_from_numpy(layers, device="cuda") -> tuple:
    """A JAX stack's tuple of layer `HTMState`s -> the port's tuple."""
    return tuple(htm_state_from_numpy(s, device) for s in layers)


def stack_state_to_numpy(layers) -> tuple:
    """A port stack's tuple of layer states -> a tuple of nested
    mappings (`htm_state_to_numpy`)."""
    return tuple(htm_state_to_numpy(s) for s in layers)
