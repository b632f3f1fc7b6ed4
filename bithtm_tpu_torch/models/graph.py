"""The compile layer: one step captured as a CUDA graph and replayed.

Counterpart of the JAX package's `jax.jit(..., donate_argnums=...)`
around its scans and wrapper steps (`models/htm.py` `htm_scan` and
`htm_serve_scan`, `models/stack.py` `stack_scan`, `networks.py`
`_jit_htm_step`, `_jit_sp_step` and `_jit_tm_step`). A JAX scan is one
compiled device program; here one step of it is captured as a CUDA
graph at a fixed config, batch, flags and device, and a scan of T steps
is T replays, each of which costs the host one `CUDAGraph.replay()`.

The captured function is "step into buffers" (`_Graph.step_into_buffers`):
it reads the state from static buffers and input row ``t`` of a static
(rows, ...) input block, runs the step, writes every output leaf into
row ``t`` of a static (rows, ...) output block and every new state leaf
back into its buffer (`copy_`), and increments ``t``, a counter on the
device. A scan copies its inputs in and its outputs out once a block of
`ROWS` steps. On the CPU the same function runs eagerly, step by step;
the entry points run their plain loop there (the caller asked for the
CPU), and `runner_eager()` routes them through this runner, which is
how the CPU tests reach it.

Before its capture a graph runs the step once on a scratch copy of the
state, so that every lazy set-up (the kernel library, a kernel's
shared-memory opt-in, cached constants) happens outside the capture, and
restores the draw providers' generator states: capture consumes no step
and no draw. Replays draw what the loop draws: the draw providers'
generators are registered with the graph (`TorchDraws.register_with`),
and their `get_state`/`set_state` stay right between replays. Launch
counts (`ops/kernels.py` `launch_counts`) count the kernels a graph
captured once a replay, and nothing for the warm-up or the capture.

Donation, as JAX's `donate_argnums`: the state passed in belongs to the
call. The buffers form a lineage: a state that is not a lineage's is
copied into new buffers (one `copy_` a leaf), and the state returned is
the buffers themselves (fresh tensor objects over them). Passing that
state back copies nothing; a leaf of it that was replaced is copied in.
Another state of the same shapes starts its own lineage, so a state
returned earlier is never overwritten behind its holder's back. A
lineage and its graphs live while the state last returned from it does.

`eager()` plays `jax.disable_jit`'s part: inside it every entry point
runs its plain loop. Inside `runner_eager()` the entry points run the
"step into buffers" runner eagerly on any device: the CPU tests' way to
it, and on the card the graph's work op by op, which
`scripts/profile_step` attributes to host ranges. A hook or draw
provider that calls the host during the step cannot be captured: it says ``capturable = False`` (a hook; the
default is True) or does not say ``capturable = True`` (a draw provider),
and the entry point then runs its loop on the card too. A capture or a
replay that fails raises.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import threading
import weakref
from typing import Any, NamedTuple

import torch

from ..ops import kernels
from ..utils.profiling import site

ROWS = 128  # steps a scan's input and output blocks hold (a step: 1)

_mode = threading.local()


@contextlib.contextmanager
def _set_mode(mode: str):
    prev = getattr(_mode, "value", None)
    _mode.value = mode
    try:
        yield
    finally:
        _mode.value = prev


def eager():
    """Inside this context every entry point runs its plain loop, the
    step's ops issued one by one from the host (`jax.disable_jit`)."""
    return _set_mode("eager")


def runner_eager():
    """Inside this context the entry points run the "step into buffers"
    runner eagerly on any device: on the CPU how the tests reach it, on
    the card the graph's work op by op, with the buffers' copies under the
    range `graph.buffers`, so that a profiler's host ranges see all of it
    (`scripts/profile_step`)."""
    return _set_mode("runner")


def providers(draws) -> list:
    """The draw providers of ``draws``: one, a tuple of them (the stack's
    one a layer) or None."""
    if draws is None:
        return []
    return list(draws) if isinstance(draws, tuple) else [draws]


def replays(tensor: torch.Tensor, draws=None, hooks=()) -> bool:
    """Whether an entry point on ``tensor``'s device runs the runner: on
    the card outside `eager()`, where every hook and draw provider can be
    captured; on any device inside `runner_eager()`. A hook that calls the
    host says ``capturable = False``; a draw provider that draws on the
    card says ``capturable = True``."""
    mode = getattr(_mode, "value", None)
    if mode == "eager" or not all(getattr(h, "capturable", True)
                                  for h in hooks if h is not None):
        return False
    if mode == "runner":
        return True
    return tensor.is_cuda and all(getattr(p, "capturable", False)
                                  for p in providers(draws))


# ---- pytrees of tensors: dataclasses, NamedTuples, tuples, dicts


_LEAF = "leaf"


class _Node(NamedTuple):
    kind: type
    names: tuple | None
    children: tuple


class _Const(NamedTuple):
    value: Any


def flatten(tree) -> tuple[Any, list[torch.Tensor]]:
    """(spec, tensor leaves) of a pytree; anything not a tensor or a
    container (None, numbers) is part of the spec."""
    leaves: list[torch.Tensor] = []
    return _flatten(tree, leaves), leaves


def _flatten(tree, leaves):
    if isinstance(tree, torch.Tensor):
        leaves.append(tree)
        return _LEAF
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        names = tuple(f.name for f in dataclasses.fields(tree))
        values = [getattr(tree, n) for n in names]
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        names, values = tree._fields, list(tree)
    elif isinstance(tree, (tuple, list)):
        names, values = None, list(tree)
    elif isinstance(tree, dict):
        names, values = tuple(tree), list(tree.values())
    else:
        return _Const(tree)
    return _Node(type(tree), names,
                 tuple(_flatten(v, leaves) for v in values))


def unflatten(spec, leaves):
    it = iter(leaves)
    tree = _build(spec, it)
    if next(it, None) is not None:
        raise ValueError("more leaves than the spec holds")
    return tree


def _build(spec, it):
    if spec is _LEAF:
        return next(it)
    if isinstance(spec, _Const):
        return spec.value
    kids = [_build(c, it) for c in spec.children]
    if spec.kind is dict:
        return dict(zip(spec.names, kids))
    if spec.names is None:
        return spec.kind(kids)
    if dataclasses.is_dataclass(spec.kind):
        return spec.kind(**dict(zip(spec.names, kids)))
    return spec.kind(*kids)


def _signature(leaves) -> tuple:
    return tuple((tuple(t.shape), t.dtype, t.device) for t in leaves)


def _is(t: torch.Tensor, buf: torch.Tensor) -> bool:
    """Whether ``t`` is ``buf``'s memory, viewed as ``buf`` views it."""
    return (t.device == buf.device and t.data_ptr() == buf.data_ptr()
            and t.shape == buf.shape and t.stride() == buf.stride()
            and t.dtype == buf.dtype)


def _write_back(bufs: list, new: list) -> None:
    """Each new leaf into its buffer, skipping a leaf that is its buffer.
    A leaf that shares memory with any buffer is cloned before the first
    copy, so that no copy reads a buffer that an earlier copy of the same
    write-back has overwritten."""
    held = {b.untyped_storage().data_ptr() for b in bufs}
    staged = []
    for b, n in zip(bufs, new, strict=True):
        if _is(n, b):
            continue
        if n.shape != b.shape or n.dtype != b.dtype:
            raise ValueError(f"a step changed a state leaf from "
                             f"{tuple(b.shape)} {b.dtype} to "
                             f"{tuple(n.shape)} {n.dtype}")
        if (n.device == b.device
                and n.untyped_storage().data_ptr() in held):
            n = n.clone()
        staged.append((b, n))
    for b, n in staged:
        b.copy_(n)


# ---- lineages: the static state buffers and the graphs over them

_LINEAGES: dict[tuple, _Lineage] = {}
# lineages released during a capture, freed after it: destroying a
# graph while another is being captured invalidates that capture
_HELD: list | None = None


def _release(key: tuple, handout: int) -> None:
    lineage = _LINEAGES.get(key)
    if lineage is not None and lineage.handout == handout:
        del _LINEAGES[key]
        if _HELD is not None:
            _HELD.append(lineage)


class _Lineage:
    """The static buffers of a state, the constants and the graphs
    captured over them, sharing one memory pool."""

    def __init__(self, spec, leaves: list):
        self.spec, self.sig = spec, _signature(leaves)
        self.device = leaves[0].device
        self.bufs = [t.detach().clone(memory_format=torch.contiguous_format)
                     for t in leaves]
        self.key = (str(self.device), self.bufs[0].data_ptr())
        self.pool = (torch.cuda.graph_pool_handle()
                     if self.device.type == "cuda" else None)
        self.graphs: dict = {}
        self.consts: dict = {}
        self.handout = 0

    def hand_out(self):
        """The state over the buffers, as fresh tensor objects; the
        lineage lives while the first of them does."""
        views = [b.detach() for b in self.bufs]
        self.handout += 1
        weakref.finalize(views[0], _release, self.key, self.handout)
        return unflatten(self.spec, views)

    def const_buffers(self, consts):
        """The lineage's copy of read-only step arguments (a serving
        table, a frozen word table): copied in where the caller's tensor
        is another than last time or was written since."""
        spec, leaves = flatten(consts)
        key = (spec, _signature(leaves))
        entry = self.consts.get(key)
        if entry is None:
            entry = self.consts[key] = (
                [t.detach().clone(memory_format=torch.contiguous_format)
                 for t in leaves], [None] * len(leaves))
        bufs, seen = entry
        for i, (b, t) in enumerate(zip(bufs, leaves)):
            if seen[i] is None or seen[i][0]() is not t \
                    or seen[i][1] != t._version:
                if seen[i] is not None:
                    b.copy_(t)
                seen[i] = (weakref.ref(t), t._version)
        return key, unflatten(spec, bufs)


def lineage_of(state) -> _Lineage:
    """The lineage ``state`` belongs to (its first leaf is a lineage's
    first buffer, with the same shapes), its replaced leaves copied in;
    else a new lineage holding a copy of it."""
    spec, leaves = flatten(state)
    if not leaves:
        raise ValueError("a state holds at least one tensor")
    first = leaves[0]
    lineage = _LINEAGES.get((str(first.device), first.data_ptr()))
    if (lineage is not None and lineage.spec == spec
            and lineage.sig == _signature(leaves)):
        _write_back(lineage.bufs, leaves)
        return lineage
    lineage = _Lineage(spec, leaves)
    _LINEAGES[lineage.key] = lineage
    return lineage


def restore_into(state, saved):
    """``saved`` as the state to run from next: copied into ``state``'s
    buffers where ``state`` is a lineage's state (each leaf its buffer),
    so that its graphs keep their buffers; else ``saved`` itself."""
    spec, leaves = flatten(state)
    lineage = _LINEAGES.get((str(leaves[0].device), leaves[0].data_ptr()))
    if (lineage is None or lineage.spec != spec
            or not all(map(_is, leaves, lineage.bufs))):
        return saved
    _write_back(lineage.bufs, flatten(saved)[1])
    return state


_STREAMS: dict[torch.device, torch.cuda.Stream] = {}


def _capture_stream(device: torch.device) -> torch.cuda.Stream:
    """The stream every graph of ``device`` captures on: graphs that
    share a memory pool capture on one stream."""
    if device not in _STREAMS:
        _STREAMS[device] = torch.cuda.Stream(device)
    return _STREAMS[device]


def _path_counts() -> dict:
    """Each kernel's launches by path, a copy."""
    return {k: dict(k.paths) for k in kernels.KERNELS}


class _Graph:
    """One step over a lineage's buffers at a fixed key: the input and
    output blocks, the counter, and on the card the captured graph and
    the kernel launches it holds. It holds the lineage's buffers, not
    the lineage, so that a lineage is freed with its last state."""

    def __init__(self, lineage: _Lineage, step, x_spec, x_leaves: list,
                 consts, draws, rows: int, capture: bool):
        self.capture = capture
        self.spec, self.bufs = lineage.spec, lineage.bufs
        self.device, self.pool = lineage.device, lineage.pool
        self.step, self.consts, self.draws = step, consts, draws
        self.x_spec = x_spec
        self.x_bufs = [torch.zeros((rows, *x.shape[1:]), dtype=x.dtype,
                                   device=self.device) for x in x_leaves]
        self.t = torch.zeros(1, dtype=torch.int64, device=self.device)
        self.out_spec = None
        self.out_bufs: list = []
        self.graph = None
        self.launches: list = []

    def step_into_buffers(self) -> None:
        """The captured function: one step from the buffers into them."""
        with site("graph.buffers"):
            x = unflatten(self.x_spec, [b.index_select(0, self.t)[0]
                                        for b in self.x_bufs])
        new_state, out = self.step(unflatten(self.spec, self.bufs), x,
                                   self.consts, self.draws)
        new_spec, new_leaves = flatten(new_state)
        out_spec, out_leaves = flatten(out)
        if new_spec != self.spec or out_spec != self.out_spec:
            raise ValueError("a step changed its state or output structure "
                             "between calls")
        with site("graph.buffers"):
            for b, v in zip(self.out_bufs, out_leaves):
                b.index_copy_(0, self.t, v.unsqueeze(0))
            _write_back(self.bufs, new_leaves)
            self.t.add_(1)

    def build(self) -> None:
        """Warm up on a scratch copy of the state from input row 0,
        allocate the output blocks, and on the card capture the step.
        Leaves the draw providers' generators and the launch counts as
        they were."""
        before = _path_counts()
        try:
            gens = [(p, p.get_state()) for p in providers(self.draws)]
            scratch = unflatten(self.spec, [b.clone() for b in self.bufs])
            x = unflatten(self.x_spec, [b[0] for b in self.x_bufs])
            _, out = self.step(scratch, x, self.consts, self.draws)
            for p, s in gens:
                p.set_state(s)
            del scratch
            self.out_spec, out_leaves = flatten(out)
            rows = self.x_bufs[0].shape[0]
            self.out_bufs = [torch.empty((rows, *v.shape), dtype=v.dtype,
                                         device=self.device)
                             for v in out_leaves]
            if self.capture:
                self._capture()
        finally:
            for k in kernels.KERNELS:
                k.paths = before[k]

    def _capture(self) -> None:
        """Captures `step_into_buffers` on the device's capture stream,
        with Python's cycle collector off and released lineages held, so
        that no graph is destroyed during the capture. Unlike
        `torch.cuda.graph` it neither synchronizes nor empties the
        allocator's cache. One thing does run on the capture stream:
        `capture_begin` resets the device-side seed and offset that the
        replays of every graph registered with the same generator read,
        so the capture stream first waits for the current stream (whose
        replays of another graph may still be running), and the current
        stream then waits for the capture stream (whose reset must land
        before the next replay sets them)."""
        global _HELD
        collecting = gc.isenabled()
        gc.disable()
        _HELD = []
        capture = _capture_stream(self.device)
        current = torch.cuda.current_stream(self.device)
        capture.wait_stream(current)
        try:
            with torch.cuda.device(self.device), torch.cuda.stream(capture):
                graph = torch.cuda.CUDAGraph()
                for p in providers(self.draws):
                    p.register_with(graph)
                mid = _path_counts()
                graph.capture_begin(pool=self.pool,
                                    capture_error_mode="thread_local")
                try:
                    self.step_into_buffers()
                except BaseException:
                    with contextlib.suppress(RuntimeError):
                        graph.capture_end()
                    raise
                graph.capture_end()
                after = _path_counts()
            current.wait_stream(capture)
        finally:
            held, _HELD = _HELD, None
            if collecting:
                gc.enable()
            del held
        self.launches = [(k, path, n - mid[k].get(path, 0))
                         for k in kernels.KERNELS
                         for path, n in after[k].items()
                         if n > mid[k].get(path, 0)]
        self.graph = graph

    def run(self, n: int) -> None:
        """n steps from row 0: n replays of the captured graph, each
        counting the launches it holds; else n eager calls."""
        self.t.zero_()
        if not self.capture:
            for _ in range(n):
                self.step_into_buffers()
            return
        for _ in range(n):
            self.graph.replay()
            for k, path, c in self.launches:
                k.paths[path] = k.paths.get(path, 0) + c


def scan(key, step, state, xs, consts=None, draws=None):
    """Run ``step(state, x, consts, draws) -> (state, out)`` over the T
    rows of ``xs`` (a pytree of (T, ...) tensors) from ``state``, through
    the graph of ``key`` (captured on first use). Returns (the lineage's
    state, ``out``'s leaves stacked over T). ``key`` names the step and
    its static arguments; the graph's key adds the shapes of the state,
    inputs and constants, the draw providers' keys and the block rows."""
    lineage = lineage_of(state)
    x_spec, x_leaves = flatten(xs)
    T = x_leaves[0].shape[0]
    if T == 0:
        raise ValueError("a scan takes at least one step")
    rows = ROWS if T > 1 else 1   # one graph for any scan length
    const_key, const_bufs = lineage.const_buffers(consts)
    dev = lineage.device
    capture = (dev.type == "cuda"
               and getattr(_mode, "value", None) != "runner")
    draws_key = tuple(p.graph_key() if capture else None
                      for p in providers(draws))
    x_sig = tuple((tuple(x.shape[1:]), x.dtype) for x in x_leaves)
    full_key = (key, x_spec, x_sig, const_key, draws_key, rows, capture)
    graph = lineage.graphs.get(full_key)
    if graph is None:
        graph = lineage.graphs[full_key] = _Graph(
            lineage, step, x_spec, x_leaves, const_bufs, draws, rows,
            capture)
    if not capture:
        graph.draws = draws   # an eager runner runs the provider it is given
    results = None
    for t0 in range(0, T, rows):
        n = min(rows, T - t0)
        for b, x in zip(graph.x_bufs, x_leaves):
            b[:n].copy_(x[t0:t0 + n])
        if graph.out_spec is None:
            try:
                graph.build()
            except BaseException:
                del lineage.graphs[full_key]
                raise
        graph.run(n)
        if results is None:
            results = [torch.empty((T, *b.shape[1:]), dtype=b.dtype,
                                   device=dev) for b in graph.out_bufs]
        for r, b in zip(results, graph.out_bufs):
            r[t0:t0 + n].copy_(b[:n])
    return lineage.hand_out(), unflatten(graph.out_spec, results)


def step(key, fn, state, x, consts=None, draws=None):
    """One step of ``fn`` (as `scan` takes it) on ``x``: `scan` over a
    single row, returning (state, out) without the time axis."""
    state, out = scan(key, fn, state, _map(lambda t: t.unsqueeze(0), x),
                      consts, draws)
    return state, _map(lambda t: t[0], out)


def _map(fn, tree):
    spec, leaves = flatten(tree)
    return unflatten(spec, [fn(t) for t in leaves])
