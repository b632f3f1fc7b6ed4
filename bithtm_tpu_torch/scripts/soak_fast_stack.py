"""Convergence soak of the bench fast stack (G=4/K=64 + int16 SP) on the
reference's noisy-pattern workload.

Counterpart of the JAX package's `scripts/soak_fast_stack.py`, with its
defaults: 2,000 steps x 256 streams at 2048 x 32 in chunks of 200, 100
patterns shared by the streams, 5% of the bits flipped each step, the
"evict" allocation policy; ``--column_dim``/``--cell_dim``/``--batch``
scale it. Each chunk is one `htm_scan` (a CUDA graph replay a step on
the card). A chunk reports bursting, correct and incorrect columns (mean
over the streams at its last step), the drop counters and evictions
(`utils.metrics_log.capacity_health`), the pool occupancy and ms a step
(host clock around the synchronized scan).

Healthy result: bursting falls to about 0 and correct rises to about A,
with zero drops of any kind. At the default configuration the run is
held to the JAX package's record (`docs/PERFORMANCE.md`: 0.13 bursting
and 40.9 of 41 correct after 2,000 steps, zero drops) within
`RECORD_TOLERANCE`: the port draws other random numbers, so its
trajectory is another sample of the same process.

Run: python -m bithtm_tpu_torch.scripts.soak_fast_stack [--batch 256]
[--chunks 10] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from .. import htm_init_batch, htm_scan, make_htm_config
from ..rng import TorchDraws
from ..utils.metrics_log import capacity_health
from . import add_device, pick_device, synchronize

CHUNK = 200
JAX_RECORD = {"bursting": 0.13, "correct": 40.9}
# the port's final chunk against the record: bursting at most 0.37 above
# it and correct at most 0.4 below it (of 41 columns)
RECORD_TOLERANCE = {"bursting": 0.37, "correct": 0.4}


def run(args, dev: torch.device) -> dict:
    cfg = make_htm_config(input_dim=1000, column_dim=args.column_dim,
                          cell_dim=args.cell_dim, segments_per_column=4,
                          synapse_capacity=64,
                          allocation_policy=args.allocation_policy,
                          sp_overrides={"permanence_dtype": "int16"})
    B, T, P = args.batch, args.chunk, args.patterns
    rng = np.random.RandomState(7)
    patterns = rng.rand(P, 1000) < 0.2
    gen = torch.Generator(device=dev).manual_seed(0)
    state = htm_init_batch(cfg, B, gen, dev)
    draws = TorchDraws(cfg.tm, B, dev, gen)
    drops: dict[str, int] = {}
    chunks = []
    for chunk in range(args.chunks):
        t0 = time.perf_counter()
        idx = (np.arange(T) + chunk * T) % P
        noise = rng.rand(T, B, 1000) < 0.05
        seq = torch.from_numpy(patterns[idx][:, None, :] ^ noise).to(dev)
        synchronize(dev)
        t1 = time.perf_counter()
        state, m = htm_scan(cfg, state, seq, True, draws=draws)
        synchronize(dev)
        t2 = time.perf_counter()
        health = capacity_health(m, pool_slots=cfg.tm.segment_capacity,
                                 scan=True)
        for k, v in health.items():
            if isinstance(v, int):
                drops[k] = drops.get(k, 0) + v
        last = {k: float(m[k][-1].double().mean())
                for k in ("bursting", "correct", "incorrect")}
        row = {"step": (chunk + 1) * T, **last,
               "dropped": sum(v for k, v in health.items()
                              if k.startswith("tm_dropped_")),
               "evicted": health.get("tm_evicted_segments", 0),
               "pool_occupancy_frac": health.get("pool_occupancy_frac"),
               "ms_per_step": 1e3 * (t2 - t1) / T,
               "gen_s": t1 - t0}
        chunks.append(row)
        print(f"step {row['step']}: bursting={last['bursting']:.2f} "
              f"correct={last['correct']:.1f} "
              f"incorrect={last['incorrect']:.1f} dropped={row['dropped']} "
              f"evicted={row['evicted']} occupancy="
              f"{row['pool_occupancy_frac']:.3f} "
              f"{row['ms_per_step']:.3f} ms/step (inputs "
              f"{row['gen_s']:.1f} s)", flush=True)
    out = {"config": f"{args.column_dim}x{args.cell_dim}", "batch": B,
           "steps": args.chunks * T, "chunks": chunks, "drops": drops,
           "device": (torch.cuda.get_device_name(dev)
                      if dev.type == "cuda" else "cpu")}
    print(f"total drops over {args.chunks * T} steps x {B} streams: "
          f"{drops}", flush=True)
    at_record = ((args.column_dim, args.cell_dim, B, args.chunks * T,
                  args.allocation_policy) == (2048, 32, 256, 2000, "evict"))
    if at_record:
        final = chunks[-1]
        out["record"] = {"jax": JAX_RECORD, "port": {
            k: final[k] for k in JAX_RECORD}}
        ok = (final["bursting"] <= JAX_RECORD["bursting"]
              + RECORD_TOLERANCE["bursting"]
              and final["correct"] >= JAX_RECORD["correct"]
              - RECORD_TOLERANCE["correct"]
              and not any(v for k, v in drops.items()
                          if k.startswith("tm_dropped_")))
        print(f"against the JAX record (bursting {JAX_RECORD['bursting']}, "
              f"correct {JAX_RECORD['correct']} of 41, zero drops): "
              f"bursting {final['bursting']:.3f}, correct "
              f"{final['correct']:.2f}", flush=True)
        if not ok:
            raise RuntimeError("the soak does not reach the JAX record: "
                               + json.dumps(out["record"]))
    return out


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(
        prog="python -m bithtm_tpu_torch.scripts.soak_fast_stack",
        description=__doc__.split("\n")[0])
    p.add_argument("--allocation_policy", default="evict",
                   choices=("reference", "evict"))
    p.add_argument("--column_dim", type=int, default=2048)
    p.add_argument("--cell_dim", type=int, default=32)
    p.add_argument("--batch", type=int, default=256)
    p.add_argument("--chunks", type=int, default=10,
                   help="chunks of --chunk steps each (default 2000 total)")
    p.add_argument("--chunk", type=int, default=CHUNK)
    p.add_argument("--patterns", type=int, default=100)
    add_device(p)
    args = p.parse_args(argv)
    out = run(args, pick_device(args.device))
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
