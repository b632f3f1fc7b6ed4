"""Adversarial anomaly benchmark on the port: the encoder -> HTM ->
likelihood -> window-scoring stack on data designed to make it fail
(the JAX package's `examples/anomaly_benchmark.py`, with the same tasks,
flags, defaults and configuration).

Eight tasks, each a scalar stream with NAB-style ground-truth windows
and a probation period:

  spike          clean seasonal + one point spike (the easy baseline)
  freq_change    behavior change: frequency doubles (easy baseline #2)
  noisy_spike    the same point spike buried in sigma=0.12 noise
  level_shift    a subtle +0.35 mean shift that never leaves the normal
                 value range
  noise_regime   variance change sigma 0.04 -> 0.30, mean unchanged
  contextual     one period replayed half a period out of phase: only
                 the (value, time) pairing is anomalous
  drift_fp       a slow linear drift (NOT an anomaly) plus one real
                 spike: non-stationarity as false-positive pressure
  clean_fp       an anomaly-free noisy trace: every alert is a false
                 positive

Scoring is window-level precision / recall / F1 over --seeds runs
(alert = likelihood >= 0.99999 OR |seasonal windowed z-score| >= 5,
after probation; episodes merged at half a period). The two *_fp tasks
report false-positive counts.

The port runs every (task, seed) trace as one stream of a single batched
`htm_scan`: B = tasks x seeds streams, stream ``i * seeds + s`` the
task ``i`` at seed ``s`` (data from ``RandomState(7000 + 13 * s)``), the
model's state and draws from one `torch.Generator` seeded 0.

Run: python -m bithtm_tpu_torch.examples.anomaly_benchmark [--cpu]
[--seeds N] [--tasks spike,clean_fp,...]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..config import make_htm_config
from ..encoders import (CyclicEncoder, ScalarEncoder, alert_episodes,
                        concat, score_alert_windows, seasonal_zscore)
from ..models.htm import htm_scan
from ..rng import TorchDraws
from ..state import htm_init_batch
from . import example_device, likelihood_series, nlog10

PERIOD = 24
CYCLES = 60
PROBATION_CYCLES = 35
# the likelihood post-processor's settings
LIK_WINDOW, LIK_MOMENTUM = 300, 0.7


def _base(t):
    return np.sin(2 * np.pi * t / PERIOD)


def make_task(name, rng):
    """Returns (values (T,), windows [(s,e)], fp_only: bool)."""
    T = CYCLES * PERIOD
    t = np.arange(T)
    v = _base(t)
    w = []
    fp_only = False
    if name == "spike":
        at = 45 * PERIOD + PERIOD // 2
        v[at] = 1.5
        w = [(at - PERIOD // 2, at + PERIOD // 2)]
    elif name == "freq_change":
        ch = 50 * PERIOD
        v[ch:] = np.sin(2 * np.pi * t[ch:] / (PERIOD / 2))
        w = [(ch, ch + 3 * PERIOD)]
    elif name == "noisy_spike":
        v = v + rng.normal(0, 0.12, T)
        at = 45 * PERIOD + PERIOD // 2
        v[at] = 1.45
        w = [(at - PERIOD // 2, at + PERIOD // 2)]
    elif name == "level_shift":
        ch = 46 * PERIOD
        v = v + rng.normal(0, 0.05, T)
        v[ch:] += 0.35
        w = [(ch, ch + 3 * PERIOD)]
    elif name == "noise_regime":
        ch = 48 * PERIOD
        noise = rng.normal(0, 0.04, T)
        noise[ch:] = rng.normal(0, 0.30, T - ch)
        v = v + noise
        w = [(ch, ch + 3 * PERIOD)]
    elif name == "contextual":
        at = 45 * PERIOD
        # replay one period half a period out of phase: values stay in
        # range, only the value-vs-time-of-day pairing is wrong
        v[at:at + PERIOD] = _base(t[at:at + PERIOD] + PERIOD // 2)
        v = v + rng.normal(0, 0.03, T)
        w = [(at, at + PERIOD)]
    elif name == "drift_fp":
        v = v + np.linspace(0.0, 0.6, T) + rng.normal(0, 0.03, T)
        at = 45 * PERIOD + PERIOD // 2
        v[at] = 1.9
        w = [(at - PERIOD // 2, at + PERIOD // 2)]
    elif name == "clean_fp":
        v = v + rng.normal(0, 0.05, T)
        w = []
        fp_only = True
    else:
        raise ValueError(name)
    return v, w, fp_only


TASKS = ("spike", "freq_change", "noisy_spike", "level_shift",
         "noise_regime", "contextual", "drift_fp", "clean_fp")


def suite(tasks, seeds: int):
    """The traces of every (task, seed), task-major: values (T, B)
    float64, and per stream its windows and whether it is fp-only."""
    values, windows, fp_only = [], [], []
    for name in tasks:
        for seed in range(seeds):
            rng = np.random.RandomState(7000 + 13 * seed)
            v, w, fp = make_task(name, rng)
            values.append(v)
            windows.append(w)
            fp_only.append(fp)
    return np.stack(values, axis=1), windows, fp_only


def encoders():
    return (ScalarEncoder(-2.2, 2.2, size=256, active_bits=17),
            CyclicEncoder(float(PERIOD), size=96, active_bits=9))


# the model's options besides its widths (512 columns x 8 cells)
OPTIONS = dict(active_columns=16, segment_activation_threshold=8,
               segment_matching_threshold=8, segment_sampling_synapses=16,
               sp_overrides={"boosting_intensity": 0.05})


def make_config():
    value_enc, time_enc = encoders()
    return make_htm_config(value_enc.size + time_enc.size, 512, 8,
                           **OPTIONS)


def encode(values: np.ndarray, device) -> torch.Tensor:
    """(T, B) values -> (T, B, 352) bool input SDRs on ``device``: the
    value and the time of day (the step index) of every stream."""
    value_enc, time_enc = encoders()
    T, B = values.shape
    t = time_enc(torch.arange(T, dtype=torch.float32, device=device))
    return concat(value_enc(torch.from_numpy(values).to(device)),
                  t[:, None, :].expand(T, B, t.shape[-1]))


def detections(nlog: np.ndarray, z: np.ndarray | None, alert_nlog10: float,
               z_alert: float) -> np.ndarray:
    """(T, B) bool: a detector fired after probation."""
    fire = nlog >= alert_nlog10
    if z is not None and z_alert > 0:
        fire = fire | (np.abs(z) >= z_alert)
    probation = PROBATION_CYCLES * PERIOD
    return fire & (np.arange(len(nlog)) >= probation)[:, None]


def score_streams(fire: np.ndarray, windows, fp_only) -> list[dict]:
    """Each stream's alerts (merged at half a period) scored against its
    windows."""
    results = []
    for b in range(fire.shape[1]):
        r = score_alert_windows(alert_episodes(
            np.flatnonzero(fire[:, b]), merge_gap=PERIOD // 2), windows[b])
        r["fp_only"] = fp_only[b]
        results.append(r)
    return results


def run(tasks, seeds: int, device, alert_nlog10: float = 5.0,
        z_alert: float = 5.0, z_window: int = 4 * PERIOD) -> list[dict]:
    """The whole suite as one batched scan; each stream's window score."""
    values, windows, fp_only = suite(tasks, seeds)
    x = encode(values, device)
    cfg = make_config()
    B = x.shape[1]
    gen = torch.Generator(device=device).manual_seed(0)
    state = htm_init_batch(cfg, B, gen, device)
    _, metrics = htm_scan(cfg, state, x, True, detailed_metrics=False,
                          draws=TorchDraws(cfg.tm, B, device, gen))
    nlog = nlog10(likelihood_series(metrics["anomaly"], LIK_WINDOW,
                                    LIK_MOMENTUM, PERIOD))
    z = None
    if z_alert > 0:
        # seasonal-residual windowed z-score side detector: catches the
        # point/level anomalies that chronic noise or drift hide from
        # the likelihood model
        z = seasonal_zscore(torch.from_numpy(values).to(device), PERIOD,
                            window=z_window).cpu().numpy()
    return score_streams(detections(nlog, z, alert_nlog10, z_alert),
                         windows, fp_only)


def task_table(tasks, seeds: int, results: list[dict]) -> list[tuple]:
    """Per task: (name, mean precision, recall, F1 — None for an fp-only
    task — and the false alerts of each seed); prints a line a task."""
    table = []
    for i, name in enumerate(tasks):
        per_seed = results[i * seeds:(i + 1) * seeds]
        fps = [r["fp"] for r in per_seed]
        if per_seed[0]["fp_only"]:
            table.append((name, None, None, None, fps))
            print(f"{name:13s} FP alerts/seed: {fps}  (anomaly-free "
                  f"trace; any alert is false)")
            continue
        pr, rc, f1 = (float(np.mean([r[k] for r in per_seed]))
                      for k in ("precision", "recall", "f1"))
        table.append((name, pr, rc, f1, fps))
        print(f"{name:13s} precision {pr:.2f} recall {rc:.2f} F1 {f1:.2f} "
              f"(FP/seed {fps})")
    return table


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m bithtm_tpu_torch.examples.anomaly_benchmark")
    p.add_argument("--cpu", action="store_true")
    p.add_argument("--seeds", type=int, default=3)
    p.add_argument("--alert_nlog10", type=float, default=5.0,
                   help="likelihood alert threshold as -log10(1 - L); "
                        "5.0 = the NAB standard 0.99999")
    p.add_argument("--z_alert", type=float, default=5.0,
                   help="side-detector threshold on |seasonal windowed "
                        "z-score|; 0 disables the stage")
    p.add_argument("--z_window", type=int, default=4 * PERIOD)
    p.add_argument("--tasks", default=",".join(TASKS))
    args = p.parse_args(argv)
    device = example_device(args.cpu, p.prog)

    tasks = args.tasks.split(",")
    results = run(tasks, args.seeds, device, args.alert_nlog10,
                  args.z_alert, args.z_window)
    table = task_table(tasks, args.seeds, results)
    print("\n| task | precision | recall | F1 |")
    print("|---|---|---|---|")
    for name, pr, rc, f1, fps in table:
        if pr is None:
            print(f"| {name} | — | — | FP/seed {fps} |")
        else:
            print(f"| {name} | {pr:.2f} | {rc:.2f} | {f1:.2f} |")


if __name__ == "__main__":
    main()
