"""The JAX package's example scripts on the port, with their flags,
defaults, configurations and asserts:

    python -m bithtm_tpu_torch.examples.anomaly_detection [--cpu] [--seeds N]
    python -m bithtm_tpu_torch.examples.anomaly_benchmark [--cpu] [--seeds N]
    python -m bithtm_tpu_torch.examples.sequence_prediction [--cpu]

Each runs on the card unless ``--cpu`` is given, and fails without one.
"""

from __future__ import annotations

import numpy as np
import torch

from ..encoders import anomaly_likelihood_steps


def example_device(cpu: bool, prog: str) -> torch.device:
    """The CPU with ``--cpu``, else the card; no card and no ``--cpu``
    exits with an error."""
    if cpu:
        return torch.device("cpu")
    if torch.cuda.is_available():
        return torch.device("cuda")
    raise SystemExit(f"{prog} runs on a CUDA GPU and "
                     f"torch.cuda.is_available() is false; pass --cpu")


def likelihood_series(scores: torch.Tensor, window: int,
                      short_momentum: float,
                      exclude_recent: int) -> torch.Tensor:
    """`anomaly_likelihood_update` over (T, B) raw scores from a fresh
    state, on their device: the (T, B) likelihoods. On the card one
    launch of the `anomaly_likelihood` kernel, on the CPU the loop of
    the update (`encoders.anomaly_likelihood_steps`)."""
    _, lik = anomaly_likelihood_steps(None, scores, short_momentum,
                                      exclude_recent, window)
    return lik


def nlog10(likelihood: torch.Tensor) -> np.ndarray:
    """-log10(1 - L) on the host, as the JAX examples compute it."""
    return -np.log10(np.maximum(1.0 - likelihood.cpu().numpy(), 1e-12))
