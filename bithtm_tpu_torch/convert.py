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
from .ops.active_set import act_dtype
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
    bf16 = a.dtype.itemsize == 2 and a.dtype.name in ("bfloat16", "void16")
    if bf16:  # numpy has no bf16 of its own: move the bits as int16
        a = a.view(np.int16)
    if not batched:
        a = a[None]
    t = torch.from_numpy(np.array(a, order="C")).to(device)  # a copy
    return t.view(torch.bfloat16) if bf16 else t


def _leaf_to_numpy(name: str, t: torch.Tensor) -> np.ndarray:
    # a copy even of a CPU tensor: a step updates the tables in place;
    # numpy has no bf16, so a bf16 leaf (the packed activity at K = 126
    # and 127, whose values 0, 1 and 129 are exact) leaves as float32
    if t.dtype == torch.bfloat16:
        t = t.float()
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

    tm = build(TMState, tm)
    # the packed activity in the port's type for K (a float32 leaf of
    # `htm_state_to_numpy` at K = 126 or 127 goes back to bf16)
    G = tm.seg_cell.shape[-1]
    K = tm.synapse_act.shape[-1] // G if G else 0
    tm = dataclasses.replace(
        tm, synapse_act=tm.synapse_act.to(act_dtype(K)) if K else
        tm.synapse_act)
    return HTMState(sp=build(SPState, sp), tm=tm)


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
