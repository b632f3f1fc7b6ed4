"""Full-step oracle parity of the port on the card (or the CPU).

Counterpart of the JAX package's `scripts/tpu_parity_check.py`. The CPU
tests judge the port's step at toy shapes; this runs the complete TM
step (`tm_step(return_debug=True)`, the hand-written kernels included
on the card) at the sizes below and compares every step bit for bit
against the port's NumPy oracle (`bithtm_tpu_torch.oracle`), which
adopts the step's random decisions, checks each against the legal
candidates and re-derives everything else.

Sizes:
  tiny (default) C=32, D=4, A=5, scaled-down thresholds; fast smoke.
  mid     C=512, D=32, A=41, the reference's thresholds 15/15/32 and
          G=8/K=48 pools, driven by a repeating 6-pattern cycle with
          occasional noise, so that matching and active segments,
          reinforcement and punishment all fire at A=41.
  full    the bench configuration's TM (2048 x 32, the fast stack G=4,
          K=64, A=41): the tables and kernels behind the bench numbers.
  bisect  C=4096, D=64, A=82: A >= 64 (the JAX package's bisection
          matcher) and a two-word cell bitmask, the form of the 16K x 64
          configuration.

The fresh runs mix learning and inference steps (every fifth step from
the fourth on infers). ``--sp`` also runs the production SP step
(`sp_step`) for 30 learning steps at 1000 -> 2048 against a NumPy model
of it, int16 bit-exact and float32 within 1e-5. ``--from_state PATH``
starts from a learned HTM state instead (a checkpoint directory of
`utils.checkpoint.save`, at the bench fast stack of ``--size``): the
oracle of each of its first ``--streams`` streams is built from the
state (`oracle_from_state`), and ``--steps`` learning steps then
``--inference_steps`` inference steps of the whole HTM step (SP and TM,
inputs from ``--inputs`` or the bench recipe) are judged, where
segments are reinforced and punished, not only grown.

Run: python -m bithtm_tpu_torch.scripts.parity_check [--size
tiny|mid|full|bisect] [--steps N] [--sp] [--from_state PATH [--inputs
X.npy] [--streams 2] [--inference_steps 4]] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from .. import HTMConfig, SPConfig, TMConfig, sp_init, sp_step
from ..convert import htm_state_from_numpy
from ..models.temporal_memory import tm_step
from ..oracle import (OracleTM, ParityError, extract_decisions,
                      oracle_from_state, tm_stream)
from ..rng import TorchDraws
from ..state import HTMState, tm_init
from . import add_device, pick_device, synchronize

DEFAULT_STEPS = {"tiny": 80, "mid": 60, "full": 40, "bisect": 40}


def make_cfg(size: str) -> TMConfig:
    """The TM configuration of a size (`tpu_parity_check.py` make_cfg)."""
    if size == "tiny":
        return TMConfig(
            column_dim=32, cell_dim=4, active_columns=5,
            segments_per_column=4, synapse_capacity=32,
            segment_activation_threshold=2, segment_matching_threshold=2,
            segment_sampling_synapses=4,
            permanence_initial=0.2137, permanence_increment=0.1003,
            permanence_decrement=0.0997, permanence_punishment=0.0251)
    if size == "mid":
        return TMConfig(
            column_dim=512, cell_dim=32, active_columns=41,
            segments_per_column=8, synapse_capacity=48,
            segment_activation_threshold=15, segment_matching_threshold=15,
            segment_sampling_synapses=32)
    if size == "bisect":
        return TMConfig(
            column_dim=4096, cell_dim=64, active_columns=82,
            segments_per_column=4, synapse_capacity=64,
            segment_activation_threshold=15, segment_matching_threshold=15,
            segment_sampling_synapses=32)
    if size != "full":
        raise ValueError(f"unknown size {size!r}")
    return TMConfig(
        column_dim=2048, cell_dim=32, active_columns=41,
        segments_per_column=4, synapse_capacity=64,
        segment_activation_threshold=15, segment_matching_threshold=15,
        segment_sampling_synapses=32)


def make_cols_fn(cfg: TMConfig, size: str, rng: np.random.RandomState):
    """Step t -> the (A,) sorted active columns: random at tiny, else a
    repeating cycle of 6 patterns with a one-column swap on a fifth of
    the steps."""
    if size == "tiny":
        return lambda t: np.sort(rng.choice(
            cfg.column_dim, cfg.active_columns, replace=False)).astype(
                np.int32)
    patterns = [np.sort(np.random.RandomState(100 + i).choice(
        cfg.column_dim, size=cfg.active_columns, replace=False)).astype(
            np.int32) for i in range(6)]

    def cols_fn(t):
        base = patterns[t % len(patterns)]
        if rng.rand() < 0.2:
            base = base.copy()
            repl = rng.randint(cfg.column_dim)
            if repl not in base:
                base[rng.randint(len(base))] = repl
                base = np.sort(base)
        return base

    return cols_fn


def judge(oracles, cols: np.ndarray, debug, tm_state, learning: bool,
          t: int) -> float:
    """Each stream's oracle adopts the step's decisions and compares the
    stream's state; returns the seconds it took. Raises `ParityError`
    naming the step and stream."""
    t0 = time.perf_counter()
    for b, oracle in enumerate(oracles):
        oracle.step(cols[b], extract_decisions(debug, b), learning=learning)
        try:
            oracle.compare(tm_stream(tm_state, b))
        except ParityError as e:
            raise ParityError(f"step {t} stream {b}: {e}") from e
    return time.perf_counter() - t0


def run_tm_parity(size: str, steps: int, dev: torch.device,
                  seed: int = 42) -> dict:
    """The TM step of ``size`` from an empty pool, one stream, mixed
    learning and inference steps, judged every step."""
    cfg = make_cfg(size)
    gen = torch.Generator(device=dev).manual_seed(seed)
    draws = TorchDraws(cfg, 1, dev, gen)
    state = tm_init(cfg, 1, dev)
    oracles = [OracleTM(cfg)]
    cols_fn = make_cols_fn(cfg, size, np.random.RandomState(seed))
    port_s = oracle_s = 0.0
    learned = 0
    for t in range(steps):
        cols = cols_fn(t)[None]
        learning = t % 5 != 3
        t0 = time.perf_counter()
        state, _, debug = tm_step(cfg, state, draws.step(),
                                  torch.from_numpy(cols).to(dev), learning,
                                  return_debug=True)
        synchronize(dev)
        port_s += time.perf_counter() - t0
        oracle_s += judge(oracles, cols, debug, state, learning, t)
        learned += int(debug.learning_segments.sum())
    out = {"size": size, "steps": steps, "streams": 1,
           "column_dim": cfg.column_dim, "cell_dim": cfg.cell_dim,
           "active_columns": cfg.active_columns,
           "segments": f"{cfg.segments_per_column}x{cfg.synapse_capacity}",
           "pool_occupancy": int((state.seg_cell < cfg.cell_dim).sum()),
           "learning_segments": learned, "port_s": port_s,
           "oracle_s": oracle_s}
    print(f"{dev.type} TM parity [{size}: C={cfg.column_dim} "
          f"D={cfg.cell_dim} A={cfg.active_columns} "
          f"G={cfg.segments_per_column}/K={cfg.synapse_capacity} "
          f"thr={cfg.segment_matching_threshold}]: "
          f"{steps} mixed learning/inference steps bit-exact vs the oracle "
          f"(pool occupancy {out['pool_occupancy']} segments; port "
          f"{port_s:.2f} s, oracle {oracle_s:.2f} s)", flush=True)
    return out


def sp_model_step(cfg: SPConfig, perm: np.ndarray, duty: np.ndarray,
                  x: np.ndarray, units) -> tuple:
    """One learning step of the NumPy SP model over the unpadded (C, I)
    permanences (int64 units or float64): overlaps, boost, top-k with
    ties to the lowest index, Hebbian update of the winners, duty cycle.
    The boost factor is the port's: the float32 argument's exp in
    float64, rounded once. Returns (overlaps, active (sorted), perm,
    duty)."""
    inc, dec, thr = units
    overlaps = ((perm >= thr) & x).sum(axis=1)
    arg = np.float32(-(cfg.boosting_intensity / cfg.density)) * duty
    factor = np.exp(arg.astype(np.float64)).astype(np.float32)
    boosted = factor * overlaps.astype(np.float32)
    order = np.lexsort((np.arange(len(boosted)), -boosted))
    active = np.sort(order[:cfg.active_columns])
    perm = perm.copy()
    perm[active] += x * (inc + dec) - dec
    if cfg.quantized:
        perm = np.clip(perm, -32000, 32000)
    duty = duty * np.float32(cfg.duty_cycle_momentum)
    duty[active] += np.float32(1.0 - cfg.duty_cycle_momentum)
    return overlaps, active, perm, duty


def run_sp_parity(dev: torch.device, steps: int = 30) -> dict:
    """The production `sp_step` at 1000 -> 2048 (A=41) against the NumPy
    model, both permanence dtypes: int16 bit-exact, float32 within
    1e-5."""
    out = {}
    for dtype in ("int16", "float32"):
        cfg = SPConfig(input_dim=1000, column_dim=2048, active_columns=41,
                       permanence_dtype=dtype)
        I = cfg.input_dim
        state = sp_init(cfg, 1, torch.Generator(device=dev).manual_seed(7),
                        dev)
        if cfg.quantized:
            perm = state.permanence[0, :, :I].cpu().numpy().astype(np.int64)
            units = (cfg.to_units(cfg.permanence_increment),
                     cfg.to_units(cfg.permanence_decrement),
                     cfg.to_units(cfg.permanence_threshold))
        else:
            perm = state.permanence[0, :, :I].cpu().numpy().astype(
                np.float64)
            units = (cfg.permanence_increment, cfg.permanence_decrement,
                     cfg.permanence_threshold)
        duty = np.zeros(cfg.column_dim, np.float32)
        rng = np.random.RandomState(11)
        for t in range(steps):
            x = rng.rand(I) < 0.2
            state, sp_out = sp_step(cfg, state,
                                    torch.from_numpy(x[None]).to(dev), True)
            overlaps, active, perm, duty = sp_model_step(cfg, perm, duty, x,
                                                         units)
            got = state.permanence[0, :, :I].cpu().numpy()
            ok = (np.array_equal(sp_out.overlaps[0].cpu().numpy(), overlaps)
                  and np.array_equal(np.sort(
                      sp_out.active_columns[0].cpu().numpy()), active))
            if cfg.quantized:
                ok = ok and np.array_equal(got.astype(np.int64), perm)
            else:
                ok = ok and np.allclose(got, perm, rtol=0, atol=1e-5)
            if not ok:
                raise ParityError(f"SP {dtype} step {t}: the port's step "
                                  f"differs from the NumPy model")
        out[dtype] = steps
        print(f"{dev.type} SP parity [{dtype}, 2048x1000]: {steps} learning "
              f"steps " + ("bit-exact" if cfg.quantized else "within 1e-5")
              + " vs the NumPy model", flush=True)
    return out


def bench_inputs(I: int, B: int, T: int, seed: int = 0) -> np.ndarray:
    """(T, B, I) bool inputs of the bench recipe: 100 patterns a stream
    at density 0.2, in order, with 5% of the bits flipped each step."""
    rng = np.random.RandomState(seed)
    patterns = rng.rand(100, B, I) < 0.2
    return patterns[np.arange(T) % 100] ^ (rng.rand(T, B, I) < 0.05)


def load_state(path: str, streams: int, dev: torch.device) -> HTMState:
    """The first ``streams`` streams of the HTM state a checkpoint
    directory (`utils.checkpoint.save`) holds, on ``dev``."""
    with np.load(os.path.join(path, "state.npz")) as npz:
        tree = {"sp": {}, "tm": {}}
        for key in npz.files:
            part, _, name = key.partition("/")
            if part in tree:
                tree[part][name] = npz[key][:streams]
    return htm_state_from_numpy(tree, dev)


def run_from_state(size: str, path: str, learn_steps: int,
                   infer_steps: int, streams: int, dev: torch.device,
                   inputs: str | None = None, seed: int = 42,
                   input_dim: int = 1000) -> dict:
    """The whole HTM step (``sp_step`` then ``tm_step``) from a learned
    state, ``learn_steps`` learning then ``infer_steps`` inference steps
    over ``streams`` streams, each judged every step by an oracle built
    from the state. The SP's permanence type (int16 or float32) is the
    state's."""
    tm = make_cfg(size)
    t0 = time.perf_counter()
    state = load_state(path, streams, dev)
    sp_dtype = str(state.sp.permanence.dtype).removeprefix("torch.")
    cfg = HTMConfig(sp=SPConfig(input_dim=input_dim,
                                column_dim=tm.column_dim,
                                active_columns=tm.active_columns,
                                permanence_dtype=sp_dtype), tm=tm)
    if state.tm.synapse_cell.shape[1:] != (
            tm.column_dim, tm.segments_per_column * tm.synapse_capacity):
        raise ValueError(f"{path} holds no state of the {size} size")
    oracles = [oracle_from_state(cfg.tm, state.tm, b)
               for b in range(streams)]
    oracle_s = time.perf_counter() - t0
    T = learn_steps + infer_steps
    xs = (np.load(inputs)[:T, :streams] if inputs
          else bench_inputs(input_dim, streams, T))
    if xs.shape != (T, streams, input_dim):
        raise ValueError(f"inputs must be ({T}, {streams}, {input_dim}), "
                         f"got {xs.shape}")
    gen = torch.Generator(device=dev).manual_seed(seed)
    draws = TorchDraws(cfg.tm, streams, dev, gen)
    sp_state, tm_state = state.sp, state.tm
    port_s = 0.0
    counts = {"learning_segments": 0, "new_segments": 0,
              "punished_segments": 0, "correct": 0}
    for t in range(T):
        learning = t < learn_steps
        t1 = time.perf_counter()
        x = torch.from_numpy(np.asarray(xs[t], bool)).to(dev)
        sp_state, sp_out = sp_step(cfg.sp, sp_state, x, learning)
        tm_state, tm_out, debug = tm_step(
            cfg.tm, tm_state, draws.step(), sp_out.active_columns, learning,
            return_debug=True)
        synchronize(dev)
        port_s += time.perf_counter() - t1
        cols = torch.sort(sp_out.active_columns, -1).values.cpu().numpy()
        oracle_s += judge(oracles, cols, debug, tm_state, learning, t)
        for k in ("learning_segments", "new_segments", "punished_segments"):
            counts[k] += int(getattr(debug, k).sum())
        counts["correct"] += int((tm_out.prev_col_prediction
                                  & sp_out.active_mask).sum())
    out = {"size": size, "from_state": True, "sp_dtype": sp_dtype,
           "streams": streams,
           "learning_steps": learn_steps, "inference_steps": infer_steps,
           **counts, "port_s": port_s, "oracle_s": oracle_s}
    print(f"{dev.type} HTM parity from a learned state [{size}: "
          f"C={tm.column_dim} D={tm.cell_dim} A={tm.active_columns} "
          f"G={tm.segments_per_column}/K={tm.synapse_capacity}, {sp_dtype} "
          f"SP], {streams} streams: {learn_steps} learning + {infer_steps} "
          f"inference steps bit-exact vs the oracle; reinforced or grown "
          f"segments {counts['learning_segments']}, new "
          f"{counts['new_segments']}, punished "
          f"{counts['punished_segments']}, correct columns "
          f"{counts['correct']}; port {port_s:.2f} s, oracle "
          f"{oracle_s:.2f} s", flush=True)
    return out


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(
        prog="python -m bithtm_tpu_torch.scripts.parity_check",
        description=__doc__.split("\n")[0])
    p.add_argument("--size", choices=tuple(DEFAULT_STEPS), default="tiny")
    p.add_argument("--steps", type=int, default=0,
                   help="default: 80 (tiny) / 60 (mid) / 40 (full, "
                        "bisect); with --from_state 24 learning steps")
    p.add_argument("--sp", action="store_true",
                   help="also check the SP step against its NumPy model")
    p.add_argument("--from_state", default="",
                   help="a checkpoint directory of a learned HTM state")
    p.add_argument("--inputs", default="",
                   help="with --from_state: a (T, B, I) bool .npy")
    p.add_argument("--streams", type=int, default=2)
    p.add_argument("--inference_steps", type=int, default=4)
    p.add_argument("--input_dim", type=int, default=1000)
    p.add_argument("--seed", type=int, default=42)
    add_device(p)
    args = p.parse_args(argv)
    dev = pick_device(args.device)
    if args.from_state:
        out = {"tm": run_from_state(
            args.size, args.from_state, args.steps or 24,
            args.inference_steps, args.streams, dev, args.inputs or None,
            args.seed, args.input_dim)}
    else:
        out = {"tm": run_tm_parity(
            args.size, args.steps or DEFAULT_STEPS[args.size], dev,
            args.seed)}
    if args.sp:
        out["sp"] = run_sp_parity(dev)
    out["device"] = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                     else "cpu")
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
