"""Host-timed B=1 wrapper epochs and `pack_bits` graph times, for
comparing two trees of the port on one card.

One copy of this script times whichever `bithtm_tpu_torch` comes first
on the path, so two trees are compared by running it in turns, each with
its tree's root on ``PYTHONPATH`` (parent, change, change, parent):

  PYTHONPATH=<tree> python <this file> --part wrapper
  PYTHONPATH=<tree> python <this file> --part pack

``--part wrapper``: the README's reference stack through the B=1
`HierarchicalTemporalMemory` wrapper on the card (its graph replays),
``--epochs`` epochs of ``--patterns`` noisy patterns, the ms a step of
each (host clock, synchronized), then the last epoch ``--repeats`` more
times from the learned state restored into the wrapper's buffers, and
the device kernels (memory copies and sets left out) and device busy
ms a step over ``--profile_steps`` steps of it (torch.profiler). ``--part pack``: `pack_bits` at the main paths'
(B, rows, D), its ms a call in a CUDA graph of 20 calls (CUDA events),
where the tree has the kernel. Prints one JSON line.
"""

from __future__ import annotations

import argparse
import copy
import json
import time

import numpy as np
import torch

import bithtm_tpu_torch as bt
from bithtm_tpu_torch import example
from bithtm_tpu_torch.models import graph
from bithtm_tpu_torch.ops import kernels

REFERENCE = dict(input_dim=1000, column_dim=2048, cell_dim=32)
# the active and winner cells (B, A, D) and the matching flags (B, C, G)
# of bench learning, 16K learning and the reference and anomaly stacks
PACK_SHAPES = ((256, 2048, 4), (256, 41, 32), (64, 16384, 4),
               (64, 328, 64), (256, 2048, 8), (256, 512, 8), (256, 16, 8))


def wrapper_epochs(args, dev) -> dict:
    rng = np.random.RandomState(args.seed)
    pats = rng.rand(args.patterns, REFERENCE["input_dim"]) < 0.2
    xs = torch.from_numpy(example.noisy_inputs(
        rng, pats, args.epochs, 0.05)).to(dev)
    htm = bt.HierarchicalTemporalMemory(**REFERENCE, seed=args.seed,
                                        device=dev)
    n = args.patterns

    def epoch(e: int) -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for x in xs[e * n:(e + 1) * n]:
            htm.process(x)
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0) / n

    epoch_ms = [epoch(e) for e in range(args.epochs - 1)]
    learned = copy.deepcopy(htm.state)
    gen = htm.generator.get_state()

    def restore():
        if graph.restore_into(htm.state, learned) is learned:
            htm.state = learned
        htm.generator.set_state(gen)

    last = []
    for _ in range(args.repeats):
        restore()
        last.append(epoch(args.epochs - 1))
    restore()
    steps = min(args.profile_steps, n)
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for x in xs[(args.epochs - 1) * n:][:steps]:
            htm.process(x)
        torch.cuda.synchronize()
    device = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    launches = sum(not e.name.startswith(("Memcpy", "Memset"))
                   for e in device)
    busy = sum(e.time_range.elapsed_us() for e in device) / 1e3
    return {"epoch_ms": epoch_ms, "last_epoch_ms": last,
            "launches_a_step": launches / steps,
            "busy_ms_a_step": busy / steps}


def graph_ms(fn, n: int = 20, reps: int = 50) -> float:
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(n):
            fn()
    g.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        g.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (n * reps)


def pack_times(dev) -> dict:
    if not hasattr(kernels, "pack_bits_cuda"):
        return {}
    g = torch.Generator(device=dev).manual_seed(0)
    out = {}
    for shape in PACK_SHAPES:
        mask = torch.rand(shape, generator=g, device=dev) < 0.3
        ms = graph_ms(lambda: kernels.pack_bits_cuda(mask))
        out["x".join(map(str, shape))] = {
            "ms": ms, "path": list(kernels.PACK_BITS.path)}
    return out


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--part", choices=("wrapper", "pack"), required=True)
    p.add_argument("--epochs", type=int, default=6)
    p.add_argument("--patterns", type=int, default=100)
    p.add_argument("--repeats", type=int, default=3)
    p.add_argument("--profile_steps", type=int, default=16)
    p.add_argument("--seed", type=int, default=1)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("wrapper_ab times the card; no CUDA device")
    dev = torch.device("cuda")
    res = {"tree": bt.__file__.rsplit("/bithtm_tpu_torch/", 1)[0],
           "part": args.part}
    res.update(wrapper_epochs(args, dev) if args.part == "wrapper"
               else pack_times(dev))
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()
