"""Multi-process execution: process-group set-up, per-process feeding,
restart.

Counterpart of `bithtm_tpu/parallel/distributed.py` on
`torch.distributed`. Every process calls `initialize`, builds the same
(data x model) mesh (`mesh.make_mesh`) and runs `mesh.sharded_step` on
its own shard. HTM's stream axis is embarrassingly parallel, so the
layout to prefer across hosts is data-parallel over every rank: no
traffic during a step, each process feeding its own streams
(`local_data_slice`), with the model axis kept inside the fast links of
one host for configurations whose tables outgrow one card.

The backend follows the device: NCCL for ranks on cards, gloo for ranks
on the CPU. gloo also runs `all_reduce` on CUDA tensors, the only
collective the step uses, so several ranks can share one card under
gloo, which NCCL refuses.

Restart (fault tolerance): the whole model is the state and the draw
generator, so recovery is checkpoint and restore. Each process saves its
OWN shard and its generator's state, ``utils.checkpoint.save(path_of_rank,
local_state, generator)``; on any worker failure the job restarts, every
process builds a fresh mesh, makes a local shard of the right shapes
(``like``: `shard_batched_state` of an initial state, or a state of the
local shapes) and restores into it, ``utils.checkpoint.restore(
path_of_rank, like=local, generator=generator)``, then steps on. A data
rank draws the whole batch and keeps its rows (`rng.RowDraws`), so every
generator holds the same state and the resumed run is the uninterrupted
one bit for bit (`tests/test_torch_multiprocess.py`, the kill-and-restore
drills).
"""

from __future__ import annotations

import datetime

import numpy as np
import torch
import torch.distributed as dist

from .mesh import MODEL_AXIS, Mesh


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None, backend: str | None = None,
               device="cuda", timeout: float | None = None) -> None:
    """Join the default process group. ``coordinator_address``
    ("host:port" of rank 0's store, or a "tcp://" URL) with
    ``num_processes`` and ``process_id``; with no address, the standard
    variables MASTER_ADDR, MASTER_PORT, WORLD_SIZE and RANK. ``backend``
    defaults to NCCL for a ``device`` on a card and gloo for the CPU.
    ``timeout`` (seconds) bounds every collective; a collective that
    fails or times out raises."""
    if backend is None:
        backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    kw = {}
    if timeout is not None:
        kw["timeout"] = datetime.timedelta(seconds=timeout)
    if coordinator_address is None:
        dist.init_process_group(backend, init_method="env://", **kw)
        return
    if num_processes is None or process_id is None:
        raise ValueError("a coordinator address needs num_processes and "
                         "process_id")
    url = (coordinator_address if coordinator_address.startswith("tcp://")
           else f"tcp://{coordinator_address}")
    dist.init_process_group(backend, init_method=url,
                            world_size=num_processes, rank=process_id, **kw)


def local_batch_slice(global_batch: int) -> slice:
    """The streams of a global batch that this process feeds when the
    batch is split over every rank in rank order (the whole batch where
    no process group is initialized)."""
    if dist.is_initialized():
        n, i = dist.get_world_size(), dist.get_rank()
    else:
        n, i = 1, 0
    if global_batch % n:
        raise ValueError(f"a batch of {global_batch} streams does not "
                         f"split over {n} processes")
    per = global_batch // n
    return slice(i * per, (i + 1) * per)


def local_data_slice(global_batch: int, mesh: Mesh) -> slice:
    """The streams this process feeds on a (data x model) ``mesh`` whose
    stream axis is split over data only: the model ranks of a data row
    feed the same rows."""
    return mesh.data_rows(global_batch)


def make_global_array(local_np, mesh: Mesh, spec: tuple) -> torch.Tensor:
    """This process's part of a sharded array, on its device (the
    data-loading path). The port has no global array object: every rank
    holds its shard, so this returns the shard. ``local_np`` holds this
    process's data rows (as JAX's process-local data does), whole along
    the other dimensions; ``spec`` names the mesh axis of each dimension
    (`mesh.batched_state_specs`), and a dimension on the model axis is
    cut to this rank's columns. uint32 words become int32 with the same
    bits, as the port's state carries them."""
    a = np.asarray(local_np)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    t = torch.from_numpy(np.ascontiguousarray(a))
    index = []
    for axis, n in zip(spec, t.shape):
        if axis == MODEL_AXIS:
            if n % mesh.n_model:
                raise ValueError(f"a dimension of {n} does not split over "
                                 f"{mesh.n_model} model ranks")
            w = n // mesh.n_model
            index.append(slice(mesh.model_index * w,
                               (mesh.model_index + 1) * w))
        else:
            index.append(slice(None))
    return t[tuple(index)].to(mesh.device, copy=True).contiguous()
