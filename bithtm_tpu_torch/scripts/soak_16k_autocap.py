"""16K x 64 learning soak under `htm_scan_autocap`.

Counterpart of the JAX package's `scripts/soak_16k_autocap.py`, with its
defaults: 16384 columns x 64 cells, the fast stack, B=64, 2,048 steps in
chunks of 256, starting from the tuned list widths ``--tuned Wc:L``
(448:384) and widening to the configuration's own (auto) caps on the
first counted drop, the dropping chunk run again under them, so that
the banked trajectory drops no candidate. Inputs: 100 patterns a
stream at density 0.2 with 5% of the bits flipped each step.

It reports each chunk's ms a step (host clock around the chunk, which
holds the escalated chunk's two runs and the safe config's capture),
its drops and whether it escalated, then ``escalated_at_step``, the
banked run's drops and the end-to-end average; the steady-state means
leave out each config's first chunk once: the tuned run's first (its
capture) and the escalated chunk (the safe config's capture).

`run_soak` also carries a learned state on from ``start_step`` (the
inputs then are the same recipe's steps from there).

Run: python -m bithtm_tpu_torch.scripts.soak_16k_autocap [--steps 2048]
[--chunk 256] [--tuned 448:384] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from .. import (CAP_DROP_METRICS, htm_init_batch, htm_scan_autocap,
                make_htm_config)
from ..rng import TorchDraws
from . import add_device, pick_device


def soak_config(column_dim: int, cell_dim: int, input_dim: int):
    return make_htm_config(input_dim=input_dim, column_dim=column_dim,
                           cell_dim=cell_dim, segments_per_column=4,
                           synapse_capacity=64,
                           sp_overrides={"permanence_dtype": "int16"})


def soak_inputs(B: int, I: int, T: int, patterns: int = 100
                ) -> np.ndarray:
    """(T, B, I) bool: ``patterns`` patterns a stream at density 0.2 in
    order, with 5% of the bits flipped each step (seeded)."""
    rng = np.random.RandomState(0)
    pats = rng.rand(patterns, B, I) < 0.2
    return pats[np.arange(T) % patterns] ^ (rng.rand(T, B, I) < 0.05)


def run_soak(cfg, state, xs: torch.Tensor, tuned: dict, chunk: int,
             draws, start_step: int = 0) -> tuple:
    """``xs`` through `htm_scan_autocap` from ``state`` (at step
    ``start_step``) in chunks of ``chunk``. Returns (state, report)."""
    B, T = state.batch, xs.shape[0]
    rows = []

    def on_chunk(t0, secs, escalated, drops):
        n = min(chunk, T - t0)
        rows.append({"step": start_step + t0, "steps": n,
                     "ms_per_step": 1e3 * secs / n,
                     "stream_steps_per_s": B * n / secs,
                     "escalated": escalated, "drops": drops})
        print(f"  chunk @{start_step + t0:5d}: {secs:6.2f} s = "
              f"{1e3 * secs / n:7.3f} ms/step, {B * n / secs:9,.0f} "
              f"stream-steps/s, drops {drops}"
              + ("  << escalated (the chunk ran again under the safe "
                 "caps; its time holds both runs)" if escalated else ""),
              flush=True)

    wall0 = time.perf_counter()
    state, metrics, info = htm_scan_autocap(cfg, state, xs, tuned=tuned,
                                            chunk=chunk, on_chunk=on_chunk,
                                            draws=draws)
    wall = time.perf_counter() - wall0
    esc = info["escalated_at_step"]
    banked = {k: int(metrics[k].sum()) for k in CAP_DROP_METRICS
              + ("tm_dropped_new_segments",) if k in metrics}
    tuned_rows = [r for r in rows if esc is None or r["step"] - start_step
                  < esc][1:]
    safe_rows = ([] if esc is None else
                 [r for r in rows if r["step"] - start_step > esc])
    report = {
        "batch": B, "steps": T, "start_step": start_step, "chunks": rows,
        "escalated_at_step": None if esc is None else start_step + esc,
        "tuned_drops": info["tuned_drops"], "banked_drops": banked,
        "end_to_end_ms_per_step": 1e3 * wall / T,
        "end_to_end_stream_steps_per_s": B * T / wall,
        "tuned_steady_ms_per_step": (float(np.mean(
            [r["ms_per_step"] for r in tuned_rows])) if tuned_rows
            else None),
        "safe_steady_ms_per_step": (float(np.mean(
            [r["ms_per_step"] for r in safe_rows])) if safe_rows else None),
        "bursting_last": float(metrics["bursting"][-1].double().mean()),
        "correct_last": float(metrics["correct"][-1].double().mean()),
    }
    print(f"# escalated_at_step={report['escalated_at_step']} "
          f"tuned_drops_observed={info['tuned_drops']} (discarded chunk)")
    print(f"# banked trajectory drops: {banked}")
    print(f"# end-to-end: {report['end_to_end_ms_per_step']:.3f} ms/step, "
          f"{report['end_to_end_stream_steps_per_s']:,.0f} stream-steps/s "
          f"over {T} steps (captures included)")
    for k in ("tuned", "safe"):
        v = report[f"{k}_steady_ms_per_step"]
        if v is not None:
            print(f"# {k} steady state: {v:.3f} ms/step")
    print(f"# last step: bursting {report['bursting_last']:.2f}, correct "
          f"{report['correct_last']:.2f}", flush=True)
    return state, report


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(
        prog="python -m bithtm_tpu_torch.scripts.soak_16k_autocap",
        description=__doc__.split("\n")[0])
    p.add_argument("--column_dim", type=int, default=16384)
    p.add_argument("--cell_dim", type=int, default=64)
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--input_dim", type=int, default=1000)
    p.add_argument("--steps", type=int, default=2048)
    p.add_argument("--chunk", type=int, default=256)
    p.add_argument("--tuned", type=str, default="448:384",
                   help="Wc:L tuned starting caps")
    p.add_argument("--patterns", type=int, default=100)
    add_device(p)
    args = p.parse_args(argv)
    dev = pick_device(args.device)
    wc, gl = (int(x) for x in args.tuned.split(":"))
    cfg = soak_config(args.column_dim, args.cell_dim, args.input_dim)
    B = args.batch
    print(f"# tuned Wc={wc} L={gl}; safe (auto) "
          f"Wc={cfg.tm.resolved_winner_capacity} "
          f"L={cfg.tm.resolved_growth_capacity}", flush=True)
    xs = torch.from_numpy(soak_inputs(B, args.input_dim, args.steps,
                                      args.patterns)).to(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    state = htm_init_batch(cfg, B, gen, dev)
    _, report = run_soak(cfg, state, xs,
                         dict(winner_capacity=wc, growth_capacity=gl),
                         args.chunk, TorchDraws(cfg.tm, B, dev, gen))
    report["config"] = f"{args.column_dim}x{args.cell_dim}"
    report["tuned"] = {"winner_capacity": wc, "growth_capacity": gl}
    report["device"] = (torch.cuda.get_device_name(dev)
                        if dev.type == "cuda" else "cpu")
    print(json.dumps(report))
    return report


if __name__ == "__main__":
    main()
