"""The rank grid, the state layout and the sharded steps.

Counterpart of `bithtm_tpu/parallel/mesh.py` on `torch.distributed`. One
rank is one process with one device (a card, or the CPU where the
caller asks for it), and the ranks form an (n_data, n_model) grid in
rank order, as `make_mesh` lays out JAX's devices:

  * **data axis**: independent streams. Every leaf's leading stream axis
    is split over the data rows; a step exchanges nothing across them.
  * **model axis**: inside a data row, rank m owns the columns [m*C/n,
    (m+1)*C/n) of every C-indexed leaf (`batched_state_specs`), for
    configurations whose tables outgrow one card (the 16K x 64 scaled
    configuration). The A-sized active-set leaves are replicated.

JAX jits the unchanged step with sharding annotations and GSPMD inserts
the collectives. PyTorch has no GSPMD, and its DTensor sees through
neither the port's CUDA kernels nor its sorts and scatters, so the step
names the three places where the column axis is crossed
(`ops/shard.py`): the boosted overlaps before the global inhibition,
the rows of the A active columns that every TM decision reads, and the
metrics that sum over the columns. Every rank of a model group then runs
the active-column part of the step on the same rows with the same draws,
writes back the rows it owns and runs the full-table kernels on its own
rows, so the result is the unsharded step's, bit for bit. The exchange
grows with B*A*G*K, not with C.
"""

from __future__ import annotations

import dataclasses
import os

import torch
import torch.distributed as dist

from ..models.htm import htm_step
from ..ops.shard import ColumnShard
from ..rng import RowDraws, TorchDraws
from ..state import HTMState, SPState, TMState

DATA_AXIS = "data"
MODEL_AXIS = "model"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place in an (n_data, n_model) grid of ranks, its
    device, and the process group of its data row's model ranks (None
    where n_model is 1)."""

    n_data: int
    n_model: int
    rank: int
    device: torch.device
    model_group: object = None
    _shards: dict = dataclasses.field(default_factory=dict, repr=False,
                                      compare=False)

    @property
    def data_index(self) -> int:
        return self.rank // self.n_model

    @property
    def model_index(self) -> int:
        return self.rank % self.n_model

    def data_rows(self, global_batch: int) -> slice:
        """This rank's streams of a ``global_batch`` split over data."""
        if global_batch % self.n_data:
            raise ValueError(f"a batch of {global_batch} streams does not "
                             f"split over {self.n_data} data rows")
        per = global_batch // self.n_data
        return slice(self.data_index * per, (self.data_index + 1) * per)

    def column_shard(self, column_dim: int) -> ColumnShard | None:
        """This rank's shard of ``column_dim`` columns (one object per
        width, so its ``traffic`` adds up over steps); None where n_model
        is 1: the rank holds every column and a step exchanges nothing."""
        if self.n_model == 1:
            return None
        if column_dim not in self._shards:
            self._shards[column_dim] = ColumnShard(
                self.model_group, self.model_index, self.n_model, column_dim)
        return self._shards[column_dim]


def make_mesh(n_data: int | None = None, n_model: int = 1,
              device=None) -> Mesh:
    """The mesh of every rank of the default process group
    (`distributed.initialize`), or of this process alone where none is
    initialized. Defaults to all ranks on data. Every rank must call it
    with the same grid: it creates one process group a data row.
    ``device`` defaults to the card of index rank mod the cards this
    host sees; pass "cpu" to run the ranks on the CPU."""
    if dist.is_initialized():
        world, rank = dist.get_world_size(), dist.get_rank()
    else:
        world, rank = 1, 0
    if n_data is None:
        n_data = world // n_model
    if n_data * n_model != world:
        raise ValueError(f"a {n_data}x{n_model} mesh needs "
                         f"{n_data * n_model} ranks, there are {world}")
    if device is None:
        cards = torch.cuda.device_count()
        if cards == 0:
            raise RuntimeError("make_mesh: no CUDA device; pass "
                               "device='cpu' to run the mesh on the CPU")
        local = int(os.environ.get("LOCAL_RANK", rank))
        device = torch.device("cuda", local % cards)
    group = None
    if n_model > 1:
        for d in range(n_data):
            g = dist.new_group(list(range(d * n_model, (d + 1) * n_model)))
            if d == rank // n_model:
                group = g
    return Mesh(n_data, n_model, rank, torch.device(device), group)


def batched_state_specs() -> dict[str, tuple]:
    """For each leaf of a batched `HTMState` ("part.leaf"), the mesh axis
    that splits each of its dimensions (None: not split). Streams over
    data; the column axis C, which fronts the SP tables and the TM's
    per-column segment pool, over model; the A-sized active-set lists
    and the step counter replicated over model (JAX
    `batched_state_specs`, which also holds the key the port has not)."""
    d, m = DATA_AXIS, MODEL_AXIS
    return {
        "sp.permanence": (d, m, None),      # (B, C, I_pad)
        "sp.connected": (d, m, None),       # (B, C, S)
        "sp.duty_cycle": (d, m),            # (B, C)
        "tm.synapse_cell": (d, m, None),    # (B, C, G*K)
        "tm.synapse_perm": (d, m, None),    # (B, C, G*K)
        "tm.seg_cell": (d, m, None),        # (B, C, G)
        "tm.active_cols": (d, None),        # (B, A)
        "tm.active_bits": (d, None, None),  # (B, A, W)
        "tm.winner_bits": (d, None, None),  # (B, A, W)
        "tm.synapse_act": (d, m, None),     # (B, C, G*K)
        "tm.prediction": (d, None, m),      # (B, W, C) packed
        "tm.matching_word": (d, m),         # (B, C)
        "tm.step": (d,),                    # (B,)
    }


def state_leaves(state: HTMState) -> dict:
    """The leaves of ``state`` by their `batched_state_specs` names (the
    tensors themselves)."""
    return {f"{part}.{f.name}": getattr(getattr(state, part), f.name)
            for part in ("sp", "tm")
            for f in dataclasses.fields(getattr(state, part))}


def state_from_leaves(leaves: dict) -> HTMState:
    """The state of a `state_leaves` dict (the tensors themselves)."""
    parts = {"sp": {}, "tm": {}}
    for key, t in leaves.items():
        part, name = key.split(".")
        parts[part][name] = t
    return HTMState(sp=SPState(**parts["sp"]), tm=TMState(**parts["tm"]))


def _index(spec: tuple, shape, mesh: Mesh, axes=(DATA_AXIS, MODEL_AXIS)):
    """The slices of a leaf of ``shape`` that ``mesh``'s rank holds,
    splitting only the mesh axes in ``axes``."""
    out = []
    for axis, n in zip(spec, shape):
        if axis not in axes:
            out.append(slice(None))
            continue
        parts, i = ((mesh.n_data, mesh.data_index) if axis == DATA_AXIS
                    else (mesh.n_model, mesh.model_index))
        if n % parts:
            raise ValueError(f"a dimension of {n} does not split over "
                             f"{parts} {axis} ranks")
        out.append(slice(i * n // parts, (i + 1) * n // parts))
    return tuple(out)


def shard_batched_state(state: HTMState, mesh: Mesh) -> HTMState:
    """This rank's shard of a full batched state, as copies on the
    mesh's device (`batched_state_specs`). Every process builds the same
    full state from the same seed (or restores the same checkpoint) and
    keeps its part, as JAX's `make_array_from_callback` path does."""
    specs = batched_state_specs()
    return state_from_leaves({
        key: t[_index(specs[key], t.shape, mesh)].to(
            mesh.device, copy=True).contiguous()
        for key, t in state_leaves(state).items()})


def assemble_batched_state(shards: list[HTMState], n_data: int,
                           n_model: int) -> HTMState:
    """The full state from every rank's shard (rank order, on one
    device): the inverse of `shard_batched_state`. Raises if a leaf
    replicated over model differs between the ranks of a data row."""
    if len(shards) != n_data * n_model:
        raise ValueError(f"{len(shards)} shards for a {n_data}x{n_model} "
                         f"mesh")
    specs = batched_state_specs()
    per_rank = [state_leaves(s) for s in shards]
    out = {}
    for key, spec in specs.items():
        rows = []
        for d in range(n_data):
            group = [per_rank[d * n_model + m][key] for m in range(n_model)]
            if MODEL_AXIS in spec:
                rows.append(torch.cat(group, spec.index(MODEL_AXIS)))
                continue
            for m, t in enumerate(group[1:], 1):
                if not torch.equal(t, group[0]):
                    raise ValueError(f"{key} is replicated over model but "
                                     f"differs between model ranks 0 and "
                                     f"{m} of data row {d}")
            rows.append(group[0])
        out[key] = torch.cat(rows, 0)
    return state_from_leaves(out)


def _step_fn(cfg, mesh: Mesh, draws, **kw):
    shard = mesh.column_shard(cfg.tm.column_dim)
    local = None

    def step(state: HTMState, x: torch.Tensor):
        nonlocal local
        if local is None:
            batch = x.shape[0] * mesh.n_data
            inner = draws
            if inner is None:
                inner = TorchDraws(cfg.tm, batch, mesh.device)
            local = RowDraws(inner, mesh.data_rows(batch))
        state, out = htm_step(cfg, state, x, draws=local, dense_outputs=False,
                              shard=shard, **kw)
        return state, out.metrics

    return step


def sharded_step(cfg, mesh: Mesh, learning: bool = True, draws=None):
    """The batched learning (or inference) step of one rank of ``mesh``:
    ``step(state, x) -> (state, metrics)`` over this rank's shard
    (`shard_batched_state`) and its data row's inputs x (B/n_data, I)
    (`distributed.local_data_slice`); metrics (B/n_data,) per stream,
    the same on every model rank. The carry's layout out is its layout
    in, and the state passed in is consumed (its tables update in place,
    as JAX donates the carry).

    ``draws``: a provider of the global batch's draws (`rng.py`), built
    alike on every rank (same config, batch and generator seed); each
    rank keeps its rows (`rng.RowDraws`), so the streams draw what they
    draw in one process. Default: `TorchDraws` for the global batch on
    the mesh's device with the device's default generator (seed it
    alike on every rank, `torch.manual_seed`)."""
    return _step_fn(cfg, mesh, draws, learning=learning)


def sharded_serve_step(cfg, mesh: Mesh, draws=None):
    """The serving step of one rank (`htm_serve_scan` semantics: learning
    off, winner pass off; `mesh.py:120-150`): model-parallel serving for
    configurations whose tables outgrow one card. Bit-equal to the
    unsharded serving step; draws nothing::

        step = sharded_serve_step(cfg, mesh)
        state, metrics = step(state, x)
    """
    return _step_fn(cfg, mesh, draws, learning=False, compute_winner=False)
