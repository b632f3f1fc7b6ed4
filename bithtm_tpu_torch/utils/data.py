"""Host-side data pipeline: prefetch input chunks to the card.

Counterpart of `bithtm_tpu/utils/data.py`. `prefetch_to_device` runs the
producer in a background thread and keeps `buffer_size` chunks in
flight, so a scan consumes one chunk while the next one copies. On the
card each chunk goes from pinned host memory to the device on a side
stream; the consumer's stream waits for that copy before it sees the
tensor. `noisy_pattern_chunks` is the reference example's synthetic
workload as a generator.
"""

from __future__ import annotations

import queue
import threading
import time
import warnings
from typing import Iterable, Iterator

import numpy as np
import torch


def _tree_map(fn, tree):
    """``fn`` over the leaves of nested tuples, lists and dicts."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _host_tensor(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(x))


class _Copy:
    """A chunk copied to the card on a side stream, with the event that
    marks the copy's end."""

    def __init__(self, chunk, device: torch.device, stream):
        with torch.cuda.stream(stream):
            self.tree = _tree_map(
                lambda x: _host_tensor(x).pin_memory().to(
                    device, non_blocking=True), chunk)
        self.event = torch.cuda.Event()
        self.event.record(stream)

    def take(self, device: torch.device):
        """The chunk, safe to use on the consumer's current stream."""
        current = torch.cuda.current_stream(device)
        current.wait_event(self.event)

        def keep(t):
            # the block was allocated on the side stream: tell the
            # caching allocator that the current stream uses it too
            t.record_stream(current)
            return t

        return _tree_map(keep, self.tree)


def prefetch_to_device(chunks: Iterable, buffer_size: int = 2,
                       device=None) -> Iterator:
    """Iterate `chunks` (numpy arrays or tensors, or tuples, lists and
    dicts of them), transferring each from a background thread and
    keeping up to `buffer_size` chunks in flight. Yields tensors on
    ``device`` in order; with ``device=None`` (or "cpu") CPU tensors.
    A device that cannot be reached raises at the consumer: there is no
    fallback to the CPU.

    Producer exceptions re-raise at the consumer; iteration stops
    cleanly when the producer is exhausted.
    """
    dev = torch.device("cpu" if device is None else device)
    on_card = dev.type == "cuda"
    if on_card and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    q: queue.Queue = queue.Queue(maxsize=buffer_size)
    stop = object()
    abandoned = threading.Event()

    def put(item) -> bool:
        # bounded put that gives up if the consumer abandoned iteration,
        # so the thread (and its queued buffers) never leak
        while not abandoned.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def producer():
        try:
            side = None
            if on_card:
                torch.cuda.set_device(dev)
                side = torch.cuda.Stream(dev)
            for c in chunks:
                item = (_Copy(c, dev, side) if on_card
                        else _tree_map(_host_tensor, c))
                if not put(item):
                    return
            put(stop)
        except BaseException as e:  # surface in consumer
            put(e)

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is stop:
                return
            if isinstance(item, BaseException):
                raise item
            yield item.take(dev) if on_card else item
    finally:
        # consumer done or bailed early: release the producer and
        # interleave draining with short joins until the thread is
        # gone. Draining unblocks a producer stuck on a full queue, and
        # only after the thread has exited can no further q.put race the
        # final drain. If the producer is wedged inside the caller's
        # iterator or a hung transfer, give up after a bounded deadline
        # and abandon the daemon thread rather than hang the consumer's
        # generator-close forever.
        abandoned.set()
        deadline = time.monotonic() + 5.0
        while t.is_alive() and time.monotonic() < deadline:
            try:
                q.get_nowait()
            except queue.Empty:
                pass
            t.join(timeout=0.05)
        if t.is_alive():
            warnings.warn(
                "prefetch_to_device: producer thread did not exit within "
                "5s of consumer teardown (blocked in the chunks iterator "
                "or a device transfer); abandoning the daemon thread.",
                stacklevel=2,
            )
        while True:
            try:
                q.get_nowait()
            except queue.Empty:
                break


def noisy_pattern_chunks(
    rng: np.random.RandomState,
    patterns: np.ndarray,          # (P, I) bool base patterns
    chunk_steps: int,
    num_chunks: int,
    batch: int | None = None,      # None = single stream
    noise: float = 0.05,
) -> Iterator[np.ndarray]:
    """The reference example's workload (`example.py:34,52`): cycle the
    pattern sequence, XOR-ing per-step Bernoulli noise; yields
    [T, I] (or [T, B, I]) bool chunks."""
    P, I = patterns.shape
    pos = 0
    for _ in range(num_chunks):
        idx = (pos + np.arange(chunk_steps)) % P
        pos = (pos + chunk_steps) % P
        base = patterns[idx]                        # (T, I)
        if batch is None:
            out = base ^ (rng.rand(chunk_steps, I) < noise)
        else:
            out = base[:, None, :] ^ (
                rng.rand(chunk_steps, batch, I) < noise
            )
        yield out
