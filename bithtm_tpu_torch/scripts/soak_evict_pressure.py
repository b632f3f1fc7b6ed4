"""Deployment-scale soak of ``allocation_policy="evict"`` under
sustained column-pool pressure.

Counterpart of the JAX package's `scripts/soak_evict_pressure.py`, with
its defaults: the TM at 2048 x 32 (A=41, G=4, K=64); per stream, N=6
rotating context patterns each followed by one shared pattern S, so
that S's columns must host one segment per context in a pool of G=4
that cannot hold them all. The static pool must keep recovering by
evicting the weakest stale segment, without dropping an allocation and
without slowing down.

Each window of ``--window`` steps is one scan of `tm_step` (a CUDA graph
replay a step on the card, `models.graph.scan`; the loop on the CPU).
It reports, per window: evictions a step, dropped allocations and
synapses, the share of S's columns predicted before each S step (mean,
max, and the streams that reach all of them), bursting on S and ms a
step (host clock around the synchronized window).

Healthy result: zero dropped allocations in every window, an eviction
rate that stays put, the shared pattern predicted in full again in
every window, and flat ms a step. `check` holds a run to the first three
(the rate of the last window within `RATE_BAND` of the second's) and
the run reports the time ratio.

Run: python -m bithtm_tpu_torch.scripts.soak_evict_pressure [--steps
10240] [--batch 32] [--window 1024] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import functools
import json
import time

import numpy as np
import torch

from .. import TMConfig
from ..models import graph
from ..models.temporal_memory import tm_step
from ..rng import TorchDraws
from ..state import tm_init
from . import add_device, pick_device, synchronize

C, D, A, G = 2048, 32, 41, 4
RATE_BAND = (0.5, 2.0)   # last window's evictions a step / the second's
WARM_STEPS = 1024        # steps by which the shared pattern is predicted


def _window_step(cfg: TMConfig, state, cols, consts, draws):
    """One learning step on (B, A) ``cols``, with the count of them the
    state predicted before it."""
    W = state.prediction.shape[1]
    pred = (state.prediction.gather(
        2, cols.long()[:, None, :].expand(-1, W, -1)) != 0).any(1).sum(
            -1, dtype=torch.int32)
    state, out = tm_step(cfg, state, draws.step(), cols, True,
                         detailed_metrics=False, dense_outputs=False)
    m = out.metrics
    return state, {"pred": pred, "bursting": m["tm_bursting_columns"],
                   "drops": m["tm_dropped_new_segments"],
                   "evicted": m["tm_evicted_segments"],
                   "syn_drops": m["tm_dropped_synapses"]}


def run_window(cfg: TMConfig, state, cols_seq, draws):
    step = functools.partial(_window_step, cfg)
    if graph.replays(state.step, draws):
        return graph.scan(("soak_evict_pressure", cfg), step, state,
                          cols_seq, None, draws)
    out: dict[str, list] = {}
    for cols in cols_seq:
        state, m = step(state, cols, None, draws)
        for k, v in m.items():
            out.setdefault(k, []).append(v)
    return state, {k: torch.stack(v) for k, v in out.items()}


def pressure_sequence(B: int, N: int, T: int, seed: int = 11
                      ) -> np.ndarray:
    """(T, B, A) int32: per stream N disjoint context column sets and one
    shared set S; even steps a context (t // 2 % N), odd steps S."""
    rng = np.random.RandomState(seed)
    cols_all = np.stack([rng.choice(C, size=(N + 1) * A,
                                    replace=False).reshape(N + 1, A)
                         for _ in range(B)])
    cols_all.sort(axis=-1)
    ctxs, shared = cols_all[:, :N], cols_all[:, N]
    seq = np.empty((T, B, A), np.int32)
    for t in range(T):
        seq[t] = ctxs[:, (t // 2) % N] if t % 2 == 0 else shared
    return seq


def run(steps: int, batch: int, contexts: int, window: int, policy: str,
        dev: torch.device) -> dict:
    cfg = TMConfig(column_dim=C, cell_dim=D, active_columns=A,
                   segments_per_column=G, synapse_capacity=64,
                   allocation_policy=policy)
    B, W = batch, window
    if steps % W or W % 2:
        raise ValueError("--steps must be a multiple of an even --window")
    seq = torch.from_numpy(pressure_sequence(B, contexts, steps)).to(dev)
    state = tm_init(cfg, B, dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    draws = TorchDraws(cfg, B, dev, gen)
    print(f"# policy={policy} {C}x{D} G={G} N={contexts} B={B} T={steps}",
          flush=True)
    windows = []
    for w in range(steps // W):
        synchronize(dev)
        t0 = time.perf_counter()
        state, m = run_window(cfg, state, seq[w * W:(w + 1) * W], draws)
        synchronize(dev)
        dt = time.perf_counter() - t0
        m = {k: v.cpu().numpy() for k, v in m.items()}
        s_pred = m["pred"][1::2] / A              # (W/2, B): before S
        row = {"step": (w + 1) * W,
               "evicted_per_step": float(m["evicted"].sum()) / W,
               "drops": int(m["drops"].sum()),
               "syn_drops": int(m["syn_drops"].sum()),
               "s_pred_mean": float(s_pred.mean()),
               "s_pred_max": float(s_pred.max()),
               "streams_at_full": float((m["pred"][1::2] == A).any(0)
                                        .mean()),
               "burst_s": float(m["bursting"][1::2].mean()),
               "ms_per_step": 1e3 * dt / W}
        windows.append(row)
        print(f"steps {row['step']:6d}: evicted/step "
              f"{row['evicted_per_step']:6.1f}  drops {row['drops']}  "
              f"syn_drops {row['syn_drops']}  S-pred mean "
              f"{row['s_pred_mean']:.3f} max {row['s_pred_max']:.3f}  "
              f"streams@full {row['streams_at_full']:.2f}  burst(S) "
              f"{row['burst_s']:5.1f}/{A}  {row['ms_per_step']:.3f} ms/step",
              flush=True)
    first, last = windows[0]["ms_per_step"], windows[-1]["ms_per_step"]
    print(f"# ms a step first -> last window: {first:.3f} -> {last:.3f} "
          f"({last / first:.2f}x; on the card the first window captures "
          f"the graph)", flush=True)
    return {"policy": policy, "batch": B, "steps": steps, "window": W,
            "contexts": contexts, "windows": windows,
            "device": (torch.cuda.get_device_name(dev)
                       if dev.type == "cuda" else "cpu")}


def check(report: dict) -> None:
    """Zero dropped allocations in every window; the shared pattern
    predicted in full (by some stream) within `WARM_STEPS` steps, and
    again in every window after the first that did; with three windows or
    more, the last window's eviction rate within `RATE_BAND` of the
    second's."""
    ws = report["windows"]
    bad = [w["step"] for w in ws if w["drops"]]
    if bad:
        raise RuntimeError(f"dropped allocations in the windows ending at "
                           f"{bad}")
    full = [i for i, w in enumerate(ws) if w["streams_at_full"] > 0]
    if not full and report["steps"] >= WARM_STEPS:
        raise RuntimeError(f"no stream predicted the shared pattern in full "
                           f"in {report['steps']} steps")
    lost = [w["step"] for w in ws[full[0] + 1:]
            if w["streams_at_full"] == 0] if full else []
    if lost:
        raise RuntimeError(f"no stream predicted the shared pattern in full "
                           f"again in the windows ending at {lost}")
    if len(ws) >= 3 and ws[1]["evicted_per_step"] > 0:
        ratio = ws[-1]["evicted_per_step"] / ws[1]["evicted_per_step"]
        if not RATE_BAND[0] <= ratio <= RATE_BAND[1]:
            raise RuntimeError(f"the eviction rate moved {ratio:.2f}x from "
                               f"the second window to the last")


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(
        prog="python -m bithtm_tpu_torch.scripts.soak_evict_pressure",
        description=__doc__.split("\n")[0])
    p.add_argument("--steps", type=int, default=10240,
                   help="total steps (context/shared pairs = steps/2)")
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--contexts", type=int, default=6,
                   help="rotating contexts per stream (> G forces "
                        "eviction)")
    p.add_argument("--window", type=int, default=1024)
    p.add_argument("--policy", default="evict",
                   choices=("evict", "reference"))
    add_device(p)
    args = p.parse_args(argv)
    report = run(args.steps, args.batch, args.contexts, args.window,
                 args.policy, pick_device(args.device))
    if args.policy == "evict":
        check(report)
    print(json.dumps(report))
    return report


if __name__ == "__main__":
    main()
