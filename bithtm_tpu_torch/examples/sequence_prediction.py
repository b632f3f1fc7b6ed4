"""End-to-end sequence forecasting on the port: encoder -> HTM -> SDR
classifier (the JAX package's `examples/sequence_prediction.py`, with the
same melody, configuration and assert).

A repeating melody of scalar values streams through a learning HTM; the
online softmax readout decodes the TM's *predictive* cells into a
forecast of the next value, one step ahead. Prints forecast accuracy
per training phase — near-random at first, near-perfect once the
sequence is learned. The model's state and draws come from a
`torch.Generator` seeded 0.

Run: python -m bithtm_tpu_torch.examples.sequence_prediction [--cpu]
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..config import make_htm_config
from ..encoders import ScalarEncoder
from ..models.htm import htm_step
from ..readout import (bucket_value, bucketize, classifier_init,
                       classifier_predict, classifier_update)
from ..rng import TorchDraws
from ..state import htm_init
from . import example_device


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m bithtm_tpu_torch.examples.sequence_prediction")
    p.add_argument("--cpu", action="store_true")
    args = p.parse_args(argv)
    device = example_device(args.cpu, p.prog)

    melody = [0.0, 2.0, 4.0, 5.0, 4.0, 2.0, 0.0, 7.0]  # repeating sequence
    lo, hi, buckets = 0.0, 7.0, 8
    enc = ScalarEncoder(lo, hi, size=256, active_bits=17)
    cfg = make_htm_config(
        input_dim=enc.size, column_dim=512, cell_dim=8, active_columns=16,
        segment_activation_threshold=8, segment_matching_threshold=8,
        segment_sampling_synapses=16,
        sp_overrides={"boosting_intensity": 0.0},
    )
    gen = torch.Generator(device=device).manual_seed(0)
    state = htm_init(cfg, gen, device)
    draws = TorchDraws(cfg.tm, 1, device, gen)
    cls = classifier_init(cfg.tm.num_cells, buckets, 1, device)

    t0 = time.perf_counter()
    prev_pred = None
    hits = []
    for epoch in range(40):
        ok = 0
        for v in melody:
            value = torch.tensor([v], device=device)
            target = bucketize(value, lo, hi, buckets)
            if prev_pred is not None:
                probs = classifier_predict(cls, prev_pred)
                forecast = float(bucket_value(probs.argmax(-1), lo, hi,
                                              buckets)[0])
                ok += abs(forecast - v) < 0.5
                cls = classifier_update(cls, prev_pred, target)
            state, out = htm_step(cfg, state, enc(value), True, draws=draws)
            prev_pred = out.tm.prediction
        hits.append(ok / len(melody))
    steps = 40 * len(melody)
    print(f"{steps} steps in {time.perf_counter() - t0:.1f} s on "
          f"{device.type}")
    print("next-value forecast accuracy per 5-epoch phase:")
    acc = np.asarray(hits).reshape(-1, 5).mean(axis=1)
    print("  " + " ".join(f"{a:.2f}" for a in acc))
    if not acc[-1] > 0.9:
        raise SystemExit(f"sequence prediction regressed: {acc}")
    print("sequence prediction works.")


if __name__ == "__main__":
    main()
