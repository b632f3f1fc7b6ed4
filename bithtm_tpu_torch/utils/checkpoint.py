"""Checkpoint / resume of a port state, in the JAX package's npz format.

Counterpart of `bithtm_tpu/utils/checkpoint.py`'s npz backend: ``save``
writes ``<path>/state.npz`` with one entry a leaf, named as the JAX
package names them (``sp/permanence``, ``tm/synapse_cell``, ...), with
its dtypes (uint32 words). The draw generator's state, which takes the
place of the JAX random key, goes in a ``generator`` entry of its own.
``restore`` also reads a checkpoint the JAX package wrote with its npz
backend, whose leaves are one unbatched stream, or a batch; it ignores
the JAX ``key``. (Orbax is JAX-only; no orbax checkpoint is read.)
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from ..convert import U32_LEAVES
from ..state import HTMState

GENERATOR = "generator"


def _items(state: HTMState):
    for part in ("sp", "tm"):
        sub = getattr(state, part)
        for f in dataclasses.fields(sub):
            yield f"{part}/{f.name}", f.name, getattr(sub, f.name)


def _to_numpy(name: str, t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:  # npz keeps bf16 as raw 2-byte voids
        return t.detach().view(torch.int16).cpu().numpy().view("V2")
    a = t.detach().cpu().numpy()
    return a.view(np.uint32) if name in U32_LEAVES else a


def save(path: str, state: HTMState,
         generator: torch.Generator | None = None) -> None:
    """Save ``state`` (and ``generator``'s state) to ``<path>/state.npz``;
    ``path`` is created as a directory."""
    os.makedirs(path, exist_ok=True)
    items = {key: _to_numpy(name, t) for key, name, t in _items(state)}
    if generator is not None:
        items[GENERATOR] = generator.get_state().numpy()
    np.savez_compressed(os.path.join(path, "state.npz"), **items)


def restore(path: str, like: HTMState,
            generator: torch.Generator | None = None) -> HTMState:
    """A state restored from ``<path>/state.npz`` with the structure,
    shapes, dtypes and device of ``like``; a single-stream (unbatched)
    checkpoint of the JAX package becomes a batch of one. With
    ``generator``, its state is set from the checkpoint's, if it has
    one."""
    npz = os.path.join(path, "state.npz")
    if not os.path.exists(npz):
        raise FileNotFoundError(f"no checkpoint at {path}")
    data = np.load(npz)
    parts = {"sp": {}, "tm": {}}
    for key, name, ref in _items(like):
        arr = data[key]
        if arr.dtype.kind == "V":
            t = torch.from_numpy(arr.view(np.int16).copy()).view(ref.dtype)
        else:
            if name in U32_LEAVES:
                arr = arr.view(np.int32)
            t = torch.from_numpy(np.array(arr))
        if t.dim() == ref.dim() - 1:
            t = t[None]
        if tuple(t.shape) != tuple(ref.shape) or t.dtype != ref.dtype:
            raise ValueError(
                f"checkpoint leaf {key}: {tuple(t.shape)} {t.dtype}, the "
                f"state holds {tuple(ref.shape)} {ref.dtype}")
        parts[key.split("/")[0]][name] = t.to(ref.device)
    if generator is not None and GENERATOR in data:
        generator.set_state(torch.from_numpy(data[GENERATOR]))
    return HTMState(sp=type(like.sp)(**parts["sp"]),
                    tm=type(like.tm)(**parts["tm"]))
