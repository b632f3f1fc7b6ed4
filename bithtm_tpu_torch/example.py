"""The port's CLI, mirroring the JAX package's `example.py` (and
the reference benchmark loop): random bool patterns, per-step XOR noise,
per-step bursting / correct / incorrect column metrics, total wall-clock.

    python -m bithtm_tpu_torch.example [--cpu] [--batch B] [--scan]
        [--oracle] [--checkpoint DIR] [--log FILE] ...

Runs on the card unless ``--cpu`` is given (and fails without one).
``--batch`` runs B independent streams on the same inputs, ``--scan``
each epoch as one `htm_scan`, ``--oracle`` a single stream with the
NumPy oracle in lockstep (every step compared), ``--checkpoint`` resumes
from and saves to a directory, ``--log`` appends per-step metrics to a
JSONL file.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from .config import config_to_dict, make_htm_config
from .models.htm import htm_scan, htm_step
from .models.spatial_pooler import sp_step
from .models.temporal_memory import tm_step
from .oracle import OracleTM, extract_decisions, oracle_from_state, tm_stream
from .rng import TorchDraws
from .state import htm_init, htm_init_batch


def oracle_checked_run(cfg, xs, learning, seed: int = 0, device="cuda",
                       on_step=None, state=None) -> dict:
    """One stream through `sp_step` and `tm_step(return_debug=True)`
    with the port's NumPy oracle in lockstep: every step, the oracle
    adopts the step's random decisions, validates them against the legal
    candidate sets, re-derives their consequences, and the whole TM state
    (cell sets, segment sets, synapse tables with permanences) is
    compared bit for bit. ``xs`` is a sequence of (I,) bool inputs,
    ``learning`` a bool for each. An inference step computes winner cells
    and takes them as its only decision. ``on_step(t, tm_out)`` is called
    after each comparison. ``state``: a B=1 state to go on from (it is
    consumed), with the oracle built from it (`oracle_from_state`);
    None starts a fresh one from ``seed``, which also seeds the draws.
    Raises `oracle.ParityError` on the first difference; returns the
    step count and the seconds spent in the port's steps and in the
    oracle (building it included)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    draws = TorchDraws(cfg.tm, 1, device, gen)
    t0 = time.perf_counter()
    if state is None:
        state = htm_init(cfg, gen, device)
        oracle = OracleTM(cfg.tm)
    else:
        oracle = oracle_from_state(cfg.tm, state.tm, 0)
    sp_state, tm_state = state.sp, state.tm
    port_s, oracle_s = 0.0, time.perf_counter() - t0
    for t, (x, learn) in enumerate(zip(xs, learning)):
        t0 = time.perf_counter()
        x = torch.as_tensor(np.asarray(x, bool)).to(device).reshape(1, -1)
        sp_state, sp_out = sp_step(cfg.sp, sp_state, x, learn)
        tm_state, tm_out, debug = tm_step(
            cfg.tm, tm_state, draws.step(), sp_out.active_columns, learn,
            return_debug=True)
        cols = sp_out.active_columns[0].cpu().numpy()
        # on an inference step the trace holds the winner cells alone
        decisions = extract_decisions(debug, 0)
        host = tm_stream(tm_state, 0)
        t1 = time.perf_counter()
        oracle.step(cols, decisions, learning=learn)
        oracle.compare(host)
        t2 = time.perf_counter()
        port_s += t1 - t0
        oracle_s += t2 - t1
        if on_step is not None:
            on_step(t, tm_out)
    return {"steps": len(xs), "port_s": port_s, "oracle_s": oracle_s}


def noisy_inputs(rng, inputs, epochs: int, noise: float) -> np.ndarray:
    """(epochs * P, I) inputs: the P patterns in order each epoch, each
    step XOR a fresh noise mask, drawn from ``rng`` step by step."""
    return np.stack([p ^ (rng.rand(inputs.shape[1]) < noise)
                     for _ in range(epochs) for p in inputs])


def run_oracle_checked(args, cfg, inputs, device) -> None:
    rng = np.random.RandomState(args.seed)
    xs = noisy_inputs(rng, inputs, args.epochs, args.input_noise_probability)
    P = len(inputs)

    def report(t, tm_out):
        if not args.quiet:
            m = tm_out.metrics
            print(f"epoch {t // P}, pattern {t % P}: parity OK — bursting "
                  f"{int(m['tm_bursting_columns'][0])}, predicted cells "
                  f"{int(m['tm_predicted_cells'][0])}")

    start = time.time()
    res = oracle_checked_run(cfg, xs, [True] * len(xs), args.seed, device,
                             report)
    print(f"{time.time() - start:.1f} seconds: {res['steps']} steps, every "
          f"step verified bit-exact against the BAMI oracle.")


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="python -m bithtm_tpu_torch.example")
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--input_patterns", type=int, default=100)
    p.add_argument("--input_dim", type=int, default=1000)
    p.add_argument("--input_density", type=float, default=0.2)
    p.add_argument("--input_noise_probability", type=float, default=0.05)
    p.add_argument("--column_dim", type=int, default=2048)
    p.add_argument("--cell_dim", type=int, default=32)
    p.add_argument("--active_columns", type=int, default=None,
                   help="default: round(0.02 * column_dim)")
    p.add_argument("--activation_threshold", type=int, default=15)
    p.add_argument("--matching_threshold", type=int, default=15)
    p.add_argument("--sampling_synapses", type=int, default=32)
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--scan", action="store_true",
                   help="run each epoch as one htm_scan")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (default: the card)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--checkpoint", type=str, default=None,
                   help="directory to save final state / resume from")
    p.add_argument("--oracle", action="store_true",
                   help="run the NumPy BAMI oracle TM in lockstep and "
                        "verify the full state bit-exactly every step "
                        "(single stream, no --scan)")
    p.add_argument("--allocation_policy", default="evict",
                   choices=("reference", "evict"),
                   help="segment-pool overflow behavior (see README "
                        "'Pool capacity semantics')")
    p.add_argument("--log", type=str, default=None,
                   help="append per-step metrics to this JSONL file")
    p.add_argument("--quiet", action="store_true")
    return p.parse_args(argv)


def main(argv=None) -> None:
    args = parse_args(argv)
    if args.cpu:
        device = torch.device("cpu")
    elif torch.cuda.is_available():
        device = torch.device("cuda")
    else:
        raise SystemExit("bithtm_tpu_torch.example runs on a CUDA GPU and "
                         "torch.cuda.is_available() is false; pass --cpu")

    cfg = make_htm_config(
        args.input_dim, args.column_dim, args.cell_dim,
        args.active_columns,
        segment_activation_threshold=args.activation_threshold,
        segment_matching_threshold=args.matching_threshold,
        segment_sampling_synapses=args.sampling_synapses,
        allocation_policy=args.allocation_policy,
    )
    rng = np.random.RandomState(args.seed)
    inputs = rng.rand(args.input_patterns, args.input_dim) < args.input_density

    if args.oracle:
        run_oracle_checked(args, cfg, inputs, device)
        return

    B, I = args.batch, args.input_dim
    gen = torch.Generator(device=device).manual_seed(args.seed)
    state = htm_init_batch(cfg, B, gen, device)
    draws = TorchDraws(cfg.tm, B, device, gen)

    if args.checkpoint:
        from .utils.checkpoint import restore, save

        if os.path.exists(args.checkpoint):
            state = restore(args.checkpoint, state, generator=gen)
            print(f"resumed from {args.checkpoint}")

    logger = None
    if args.log:
        from .utils.metrics_log import JsonlLogger

        logger = JsonlLogger(args.log, config=config_to_dict(cfg))

    def streams(x: np.ndarray) -> torch.Tensor:
        """(..., I) inputs, the same for each of the B streams."""
        return torch.from_numpy(np.ascontiguousarray(np.broadcast_to(
            x[..., None, :], (*x.shape[:-1], B, I)))).to(device)

    start = time.time()
    for epoch in range(args.epochs):
        if args.scan:
            noise = rng.rand(args.input_patterns, I) \
                < args.input_noise_probability
            state, metrics = htm_scan(cfg, state, streams(inputs ^ noise),
                                      True, draws=draws)
            if logger is not None:
                host_m = {k: v.cpu().numpy() for k, v in metrics.items()}
                logger.write(host_m, epoch=epoch)
                logger.write_capacity(host_m, scan=True, epoch=epoch,
                                      pool_slots=cfg.tm.segment_capacity)
            if not args.quiet:
                m = {k: int(v.sum()) for k, v in metrics.items()
                     if k in ("bursting", "correct", "incorrect")}
                print(f"epoch {epoch}: bursting {m['bursting']}, "
                      f"correct {m['correct']}, "
                      f"incorrect {m['incorrect']}")
        else:
            epoch_metrics = []  # per-step host metrics for capacity agg
            for i, pattern in enumerate(inputs):
                noisy = pattern ^ (rng.rand(I) < args.input_noise_probability)
                state, out = htm_step(cfg, state, streams(noisy), True,
                                      draws=draws)
                if logger is not None:
                    host_m = {k: v.cpu().numpy()
                              for k, v in out.metrics.items()}
                    logger.write(host_m, epoch=epoch)
                    epoch_metrics.append(host_m)
                if not args.quiet:
                    m = {k: int(out.metrics[k].sum())
                         for k in ("bursting", "correct", "incorrect")}
                    print(f"epoch {epoch}, pattern {i}: "
                          f"bursting columns: {m['bursting']}, "
                          f"correct columns: {m['correct']}, "
                          f"incorrect columns: {m['incorrect']}")
            if logger is not None and epoch_metrics:
                # stack [T]-wise so capacity_health owns the counter
                # classification (sums drops, takes latest occupancy)
                stacked = {k: np.stack([m[k] for m in epoch_metrics])
                           for k in epoch_metrics[0]}
                logger.write_capacity(stacked, scan=True, epoch=epoch,
                                      pool_slots=cfg.tm.segment_capacity)

    if device.type == "cuda":
        torch.cuda.synchronize(device)
    elapsed = time.time() - start
    total_steps = args.epochs * args.input_patterns * B
    print(f"{elapsed} seconds. "
          f"({total_steps / elapsed:,.0f} aggregate timesteps/s)")

    if args.checkpoint:
        save(args.checkpoint, state, generator=gen)
        print(f"saved checkpoint to {args.checkpoint}")


if __name__ == "__main__":
    main()
