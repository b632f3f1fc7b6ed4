"""End-to-end streaming anomaly detection with a NAB-style task score, on
the port (the JAX package's `examples/anomaly_detection.py`, with the
same signal, flags, defaults, configuration and assert).

A periodic scalar signal with timestamps is encoded to SDRs, streamed
through a learning HTM, and scored with the Numenta anomaly pipeline:
raw score (fraction of active columns not predicted) -> anomaly
*likelihood* (Gaussian tail probability of the short-term mean score
under the stream's own running distribution) -> thresholded alerts.

The script injects two anomalies — a point spike and a behavior
change — and reports the NAB-style *task-level* score: alerts are
matched against ground-truth anomaly windows, and window-level
precision / recall / F1 are printed per seed and aggregated. Seed ``s``
seeds the `torch.Generator` of the model's state and draws.

Run: python -m bithtm_tpu_torch.examples.anomaly_detection [--cpu]
[--seeds N]
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..config import make_htm_config
from ..encoders import (CyclicEncoder, ScalarEncoder, alert_episodes,
                        concat, score_alert_windows)
from ..models.htm import htm_scan
from ..rng import TorchDraws
from ..state import htm_init
from . import example_device, likelihood_series, nlog10


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m bithtm_tpu_torch.examples.anomaly_detection")
    p.add_argument("--cpu", action="store_true")
    p.add_argument("--seeds", type=int, default=5)
    p.add_argument("--alert_nlog10", type=float, default=2.0,
                   help="alert when -log10(1 - likelihood) >= this "
                        "(2.0 == likelihood 0.99)")
    p.add_argument("--log", default=None, help="JSONL metrics path")
    args = p.parse_args(argv)
    device = example_device(args.cpu, p.prog)

    period = 24
    value_enc = ScalarEncoder(-1.5, 1.5, size=256, active_bits=17)
    time_enc = CyclicEncoder(float(period), size=96, active_bits=9)
    cfg = make_htm_config(
        input_dim=value_enc.size + time_enc.size,
        column_dim=512, cell_dim=8, active_columns=16,
        segment_activation_threshold=8, segment_matching_threshold=8,
        segment_sampling_synapses=16,
        sp_overrides={"boosting_intensity": 0.05},
    )

    # signal: clean cycles, a point spike at cycle 45, then a frequency
    # change for the last 10 cycles
    t = np.arange(60 * period)
    values = np.sin(2 * np.pi * t / period)
    change = 50 * period
    values[change:] = np.sin(2 * np.pi * t[change:] / (period / 2))
    spike_at = 45 * period + period // 2
    values[spike_at] = 1.5                               # point anomaly

    # ground-truth anomaly windows (NAB marks a tolerance window around
    # each labeled anomaly) + probation period (model still learning)
    windows = [
        (spike_at - period // 2, spike_at + period // 2),
        (change, change + 3 * period),
    ]
    probation = 35 * period

    x = concat(value_enc(torch.from_numpy(values).to(device)),
               time_enc(torch.from_numpy(t).to(device, torch.float32)))

    results = []
    logger = None
    if args.log:
        from ..utils.metrics_log import JsonlLogger

        logger = JsonlLogger(args.log)

    for seed in range(args.seeds):
        t0 = time.perf_counter()
        gen = torch.Generator(device=device).manual_seed(seed)
        state = htm_init(cfg, gen, device)
        state, metrics = htm_scan(cfg, state, x[:, None], True,
                                  detailed_metrics=False,
                                  draws=TorchDraws(cfg.tm, 1, device, gen))
        raw = metrics["anomaly"]
        nlog = nlog10(likelihood_series(raw, 300, 0.7, period))[:, 0]
        detect = np.flatnonzero(
            (nlog >= args.alert_nlog10) & (np.arange(len(nlog)) >= probation)
        )
        episodes = alert_episodes(detect, merge_gap=period // 2)
        r = score_alert_windows(episodes, windows)
        r["alerts"] = [(int(a), int(b)) for a, b in episodes]
        results.append(r)
        print(f"seed {seed}: alerts at {r['alerts']} -> "
              f"TP {r['tp']}/{len(windows)} windows, FP {r['fp']} | "
              f"precision {r['precision']:.2f} recall {r['recall']:.2f} "
              f"F1 {r['f1']:.2f} ({len(t)} steps in "
              f"{time.perf_counter() - t0:.1f} s on {device.type})")
        if logger is not None:
            raw_host = raw[:, 0].cpu().numpy()
            for step in range(len(raw_host)):
                logger.write({"seed": seed, "value": float(values[step]),
                              "anomaly": float(raw_host[step]),
                              "nlog10_likelihood": float(nlog[step])})

    if logger is not None:
        logger.close()

    f1 = np.array([r["f1"] for r in results])
    rec = np.array([r["recall"] for r in results])
    prec = np.array([r["precision"] for r in results])
    print(f"\ntask score over {args.seeds} seeds "
          f"(spike + behavior-change windows, alert threshold "
          f"likelihood >= {1 - 10 ** -args.alert_nlog10:.2f}):")
    print(f"  precision {prec.mean():.2f} +/- {prec.std():.2f}   "
          f"recall {rec.mean():.2f} +/- {rec.std():.2f}   "
          f"F1 {f1.mean():.2f} +/- {f1.std():.2f}")
    if not f1.mean() >= 0.9:
        raise SystemExit(f"anomaly task score regressed: F1 {f1.mean()}")
    print("anomaly detection works.")


if __name__ == "__main__":
    main()
