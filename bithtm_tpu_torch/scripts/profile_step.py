"""Device time of the HTM step by call site, on the card.

Counterpart of the JAX package's `scripts/profile_step.py`, which reads
per-op device time a step out of a `jax.profiler` trace. Here the step's
call sites carry `torch.profiler.record_function` ranges
(`utils.profiling.site`: `sp_step`'s overlap, selection (the boost,
inhibition and duty cycle: `sp_select`) and update; `tm_step`'s
preparation, row counts, column decisions (`column_decide`), `_learn`
with its `_grow` and `learn_rows`,
punishment, table pass, count decode, the compact serving table's
counts and words (`serving_counts`), prediction words (a
`distal_forward` hook's) and outputs;
`htm_step`'s draws and metrics;
the graph runner's `graph.buffers`).
A CUDA graph's replay carries no host ranges, so ``--trace_steps`` steps
of the graph's own runner run eagerly (`graph.runner_eager()`: the
captured function op by op, one step a call, the copies between the
step and the graph's buffers under the range `graph.buffers`) are
profiled with the ranges on; each range's device ms a step is the time
of the kernels launched inside it, and its launches a step their
count. The same steps replayed as the
scan's graph (the port's default on the card) are profiled too, and
the ranges' sum is held to within 10% of the graph's device busy a step
(the graph's ms a step, host clock, the median of three runs, is
reported beside it):
the eager runner launches the graph's kernels, so its ranges attribute
the graph's time. The ranges launch nothing and change no value.

``--serve`` profiles `htm_serve_scan` over the synapse tables (the
unpacked form); with ``--serve_table packed`` over a compact serving
table (`make_serving_table` of the warmed state), with ``--serve_table
frozen`` the serving scan over the frozen word table
(`pack_frozen_table`).

On the CPU (``--device cpu``) the ranges' host time is reported instead,
under ``"time": "cpu"``, and there is no graph.

Run: python -m bithtm_tpu_torch.scripts.profile_step [--fast] [--batch
256] [--trace_steps 8] [--inference | --serve [--serve_table
packed|frozen]] [--column_dim 16384 --cell_dim 64] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import copy
import json
import statistics
import time

import numpy as np
import torch

from .. import (htm_init_batch, htm_scan, htm_serve_scan, make_htm_config,
                make_serving_table, pack_frozen_table)
from ..models import graph
from ..models.htm import _scan_impl
from ..rng import TorchDraws
from ..utils.profiling import call_sites, device_events, warm_profile
from . import add_device, pick_device, synchronize

# bench.py's tuned list widths at 16384 x 64 (`--winner_capacity 384
# --growth_capacity 336`)
TUNED_16K = dict(winner_capacity=384, growth_capacity=336)
TOLERANCE = 0.10   # the ranges' sum against the graph's busy
PROFILE_ATTEMPTS = 3   # profiles of the steps, while one drops a kernel


def make_config(args):
    overrides = {}
    if args.fast:
        overrides = dict(segments_per_column=4, synapse_capacity=64,
                         sp_overrides={"permanence_dtype": "int16"})
    caps = {}
    if (args.column_dim, args.cell_dim) == (16384, 64):
        caps = dict(TUNED_16K)
    for name in ("winner_capacity", "growth_capacity"):
        if getattr(args, name):
            caps[name] = getattr(args, name)
    return make_htm_config(input_dim=args.input_dim,
                           column_dim=args.column_dim,
                           cell_dim=args.cell_dim, **overrides, **caps)


def graph_busy(run, steps: int, dev: torch.device) -> tuple[float, float]:
    """(device busy ms, kernel launches) a step of ``run()``, which runs
    ``steps`` steps, from `torch.profiler`'s device events
    (`warm_profile`)."""
    with warm_profile(dev) as prof:
        run()
    busy = launches = 0.0
    for e in device_events(prof):
        busy += e.time_range.elapsed_us() / 1e3
        launches += not e.name.startswith(("Memcpy", "Memset"))
    return busy / steps, launches / steps


SITE_PREFIXES = ("sp_step.", "tm_step.", "htm_step.", "graph.")


def _kernels_by_site(events) -> dict[str, list]:
    """{range: [(kernel, ms)]}: each device kernel goes to every range
    open on the host when its launch call ran (the CUDA runtime event
    that shares the kernel's correlation id), nested ranges included.
    The host launch, not the profiler's link of a kernel to an aten op,
    is what finds the kernels launched through ctypes."""
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    ranges, launched_at = [], {}
    for e in events:
        if e.device_type != cpu:
            continue
        if e.name.startswith(SITE_PREFIXES):
            ranges.append((e.time_range.start, e.time_range.end, e.name))
        elif e.name.startswith("cuda"):
            launched_at[e.id] = e.time_range.start
    out: dict[str, list] = {name: [] for _, _, name in ranges}
    for e in events:
        t = launched_at.get(e.id)
        if (e.device_type != cuda or t is None
                or e.name.startswith(SITE_PREFIXES + ("ProfilerStep",))):
            continue
        for s0, s1, name in ranges:
            if s0 <= t <= s1:
                out[name].append((e.name, e.time_range.elapsed_us() / 1e3))
    return out


def lost_launches(events) -> int:
    """Kernel launches on the host (`cudaLaunchKernel`) that have no
    device event of the same correlation id: kernels the profiler
    dropped."""
    cpu = torch.autograd.DeviceType.CPU
    launched = {e.id for e in events if e.device_type == cpu
                and e.name.startswith("cudaLaunchKernel")}
    ran = {e.id for e in events if e.device_type != cpu}
    return len(launched - ran)


def profile_sites(step, steps: int, dev: torch.device, top: int,
                  warmup=None) -> dict:
    """Runs ``warmup()``, then ``step(t)`` for t < ``steps``, with the
    call-site ranges on, under `torch.profiler`, whose warm-up phase
    takes ``warmup()`` and drops its events (`warm_profile`); on the
    card again, up to PROFILE_ATTEMPTS times, while the profile lacks a
    launched kernel (`lost_launches`: the warm-up phase makes that rare,
    not impossible), so ``warmup()`` must also start the steps' lineage
    over. Returns {range: {"ms": a step, "top": [(op, ms a step)]}} with
    device time on the card (`_kernels_by_site`) and host time on the
    CPU, and "launches": the kernels a step launched in it on the card
    (memory copies and sets left out, as `graph_busy` counts them; None
    on the CPU); and the device ms a step no range holds (None on the
    CPU)."""
    for attempt in range(1, PROFILE_ATTEMPTS + 1):
        with call_sites(), warm_profile(dev, warmup) as prof:
            for t in range(steps):
                step(t)
        events = prof.events()
        lost = lost_launches(events) if dev.type == "cuda" else 0
        if not lost:
            break
        print(f"# profile {attempt}: the profiler dropped {lost} of the "
              f"steps' kernels; profiling them again")
    if dev.type == "cuda":
        launched = _kernels_by_site(events)
        per_site = {name: (sum(ms for _, ms in ks), ks)
                    for name, ks in launched.items()}
        total = sum(e.time_range.elapsed_us() / 1e3
                    for e in device_events(prof, SITE_PREFIXES))
    else:
        per_site = {}
        for e in events:
            if (e.device_type == torch.autograd.DeviceType.CPU
                    and e.name.startswith(SITE_PREFIXES)):
                ms, _ = per_site.get(e.name, (0.0, []))
                per_site[e.name] = (ms + e.cpu_time_total / 1e3, [])
        total = None
    out = {}
    for name, (ms, ks) in sorted(per_site.items(),
                                 key=lambda kv: -kv[1][0]):
        ops: dict[str, float] = {}
        for op, k_ms in ks:
            ops[op] = ops.get(op, 0.0) + k_ms
        ranked = sorted(ops.items(), key=lambda kv: -kv[1])[:top]
        launches = (sum(not op.startswith(("Memcpy", "Memset"))
                        for op, _ in ks) / steps
                    if dev.type == "cuda" else None)
        out[name] = {"ms": ms / steps, "launches": launches, "top": [
            (op[:90], k_ms / steps) for op, k_ms in ranked]}
    return out, None if total is None else total / steps


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(
        prog="python -m bithtm_tpu_torch.scripts.profile_step",
        description=__doc__.split("\n")[0])
    p.add_argument("--batch", type=int, default=256)
    p.add_argument("--trace_steps", type=int, default=8)
    p.add_argument("--warmup_steps", type=int, default=0,
                   help="learning steps before the profiled ones "
                        "(default: --trace_steps)")
    p.add_argument("--input_dim", type=int, default=1000)
    p.add_argument("--column_dim", type=int, default=2048)
    p.add_argument("--cell_dim", type=int, default=32)
    p.add_argument("--fast", action="store_true",
                   help="throughput preset (G=4/K=64 + int16 SP)")
    p.add_argument("--inference", action="store_true")
    p.add_argument("--serve", action="store_true",
                   help="profile htm_serve_scan (learning and the winner "
                        "pass off)")
    p.add_argument("--serve_table", choices=("packed", "frozen"),
                   help="with --serve: serve from a compact serving table "
                        "(packed) or the frozen word table (frozen) "
                        "instead of the synapse tables")
    p.add_argument("--detailed_metrics", action="store_true",
                   help="include the full-table occupancy metrics")
    p.add_argument("--winner_capacity", type=int, default=0)
    p.add_argument("--growth_capacity", type=int, default=0)
    p.add_argument("--top", type=int, default=3,
                   help="ops shown inside each range")
    p.add_argument("--seed", type=int, default=0)
    add_device(p)
    args = p.parse_args(argv)
    if args.serve_table and not args.serve:
        p.error("--serve_table needs --serve")
    dev = pick_device(args.device)
    cfg = make_config(args)
    B, T = args.batch, args.trace_steps
    warm = args.warmup_steps or T
    rng = np.random.RandomState(args.seed)
    seq = torch.from_numpy(rng.rand(warm + T, B, args.input_dim)
                           < 0.2).to(dev)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    state = htm_init_batch(cfg, B, gen, dev)
    draws = TorchDraws(cfg.tm, B, dev, gen)
    learn = not (args.inference or args.serve)
    state, _ = htm_scan(cfg, state, seq[:warm], True, draws=draws)
    xs = seq[warm:]
    start, gen_start = copy.deepcopy(state), gen.get_state()
    table = word = None
    if args.serve_table == "packed":
        table = make_serving_table(cfg.tm, state.tm)
    elif args.serve_table == "frozen":
        word = pack_frozen_table(state.tm.synapse_cell,
                                 state.tm.synapse_perm,
                                 cfg.tm.permanence_threshold,
                                 num_cells=cfg.tm.num_cells)

    def scan(st, x=xs):
        if word is not None:
            return _scan_impl(cfg, st, x, False, False,
                              args.detailed_metrics, draws,
                              frozen_word=word)
        if args.serve:
            return htm_serve_scan(cfg, st, x, serving_table=table,
                                  detailed_metrics=args.detailed_metrics,
                                  draws=draws)
        return htm_scan(cfg, st, x, learn,
                        detailed_metrics=args.detailed_metrics, draws=draws)

    busy = launches = graph_ms = None
    if dev.type == "cuda":
        held = scan(copy.deepcopy(start))[0]     # captures the graph
        runs = []
        for _ in range(3):   # the graph's ms a step, host clock
            gen.set_state(gen_start)
            held = graph.restore_into(held, start)
            synchronize(dev)
            t0 = time.perf_counter()
            held = scan(held)[0]
            synchronize(dev)
            runs.append(1e3 * (time.perf_counter() - t0) / T)
        graph_ms = statistics.median(runs)
        gen.set_state(gen_start)
        held = graph.restore_into(held, start)
        box = {}
        busy, launches = graph_busy(
            lambda: box.setdefault("state", scan(held)), T, dev)
        del box, held
    with graph.runner_eager():
        # the runner's warm-up step, in the profiler's warm-up phase, on
        # the lineage the profiled steps then start over on
        live = {}

        def warmup():
            gen.set_state(gen_start)
            live["state"] = scan(copy.deepcopy(start), xs[:1])[0]
            gen.set_state(gen_start)
            live["state"] = graph.restore_into(live["state"], start)

        def step(t):
            live["state"] = scan(live["state"], xs[t:t + 1])[0]

        sites, loop_busy = profile_sites(step, T, dev, args.top, warmup)
    top_level = {k: v for k, v in sites.items() if "/" not in k}
    total = sum(v["ms"] for v in top_level.values())
    mode = "serve" if args.serve else ("learning" if learn else "inference")
    if args.serve_table:
        mode += f" {args.serve_table}"
    out = {"config": f"{args.column_dim}x{args.cell_dim}", "fast": args.fast,
           "batch": B, "steps": T, "mode": mode,
           "time": "device" if dev.type == "cuda" else "cpu",
           "sites": {k: v["ms"] for k, v in sites.items()},
           "launches": {k: v["launches"] for k, v in sites.items()},
           "top": {k: v["top"] for k, v in sites.items()},
           "ranges_ms": total, "loop_busy_ms": loop_busy,
           "graph_busy_ms": busy, "graph_launches": launches,
           "graph_ms_per_step": graph_ms}
    print(f"# config: fast={args.fast} B={B} steps={T} "
          f"{args.column_dim}x{args.cell_dim} mode={mode}; "
          f"{out['time']} ms a step by call site (loop, ranges on)")
    for name, site in sites.items():
        ops = "; ".join(f"{op} {ms:.3f}" for op, ms in site["top"])
        indent = "    " if "/" in name else "  "
        n = ("" if site["launches"] is None
             else f"{site['launches']:6.1f} launches  ")
        print(f"{indent}{site['ms']:8.3f} ms/step  {n}{name:28s} {ops}")
    print(f"# ranges sum {total:.3f} ms/step", end="")
    if loop_busy is not None:
        print(f"; the loop's device busy {loop_busy:.3f} ms/step "
              f"({loop_busy - total:.3f} outside the ranges)", end="")
    if busy is not None:
        out["ranges_vs_busy"] = total / busy
        print(f"; graph busy {busy:.3f} ms/step, {launches:.1f} kernel "
              f"launches a step; ranges / busy {total / busy:.3f}; graph "
              f"{graph_ms:.3f} ms/step (host clock, median of 3 runs)")
        if abs(total - busy) > TOLERANCE * busy:
            raise RuntimeError(
                f"the ranges sum to {total:.3f} ms a step, more than "
                f"{TOLERANCE:.0%} from the graph's busy {busy:.3f} ms")
    else:
        print()
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
