"""SDR readout: decode HTM cell states back into value predictions.

Counterpart of `bithtm_tpu/readout.py`: the classic HTM "SDR
classifier", an online multinomial logistic regression from a cell SDR
to value buckets, trained with plain SGD one step behind the prediction
(predict at t from the cells at t, learn at t+1 when the actual bucket
arrives). Batch-native: the weights carry a leading stream axis B, and
a batch of SDRs is (B, features). The product is a plain batched float32
`torch.matmul`; its sums round otherwise than XLA's dot, within the
tolerance of `tests/test_torch_readout.py`.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .encoders import _div, _on, _unit_position


class ClassifierState(NamedTuple):
    weights: torch.Tensor   # (B, buckets, features) float32


def classifier_init(features: int, buckets: int, batch: int = 1,
                    device=None) -> ClassifierState:
    return ClassifierState(weights=torch.zeros(
        (batch, buckets, features), dtype=torch.float32,
        device=_on(None, device)))


def classifier_predict(state: ClassifierState,
                       sdr: torch.Tensor) -> torch.Tensor:
    """(B, features) bool SDRs -> (B, buckets) probability
    distributions."""
    x = sdr.to(torch.float32)
    logits = torch.matmul(state.weights, x[..., None])[..., 0]
    return torch.softmax(logits, dim=-1)


def classifier_update(state: ClassifierState, sdr: torch.Tensor,
                      target_bucket,
                      learning_rate: float = 0.1) -> ClassifierState:
    """One online SGD step of cross-entropy toward the observed bucket
    ((B,) ints). A bucket outside [0, buckets) has no one-hot bit, as
    `jax.nn.one_hot` gives it, so only the probabilities are pushed
    down."""
    x = sdr.to(torch.float32)
    probs = classifier_predict(state, sdr)
    buckets = state.weights.shape[1]
    target = torch.as_tensor(target_bucket, device=x.device)
    onehot = (torch.arange(buckets, device=x.device)
              == target.reshape(-1, 1)).to(torch.float32)
    grad = (probs - onehot)[..., :, None] * x[..., None, :]
    return ClassifierState(weights=state.weights - learning_rate * grad)


def bucketize(value, minimum: float, maximum: float, buckets: int,
              device=None) -> torch.Tensor:
    """Map scalars to their bucket index over [minimum, maximum], int32
    (the `ScalarEncoder`'s float32 division and half-to-even rounding)."""
    v = _unit_position(value, minimum, maximum, device)
    return torch.round(v * (buckets - 1)).to(torch.int32)


def bucket_value(bucket: torch.Tensor, minimum: float, maximum: float,
                 buckets: int) -> torch.Tensor:
    """Center value of a bucket (inverse of `bucketize`), float32."""
    return minimum + _div(bucket.to(torch.float32), buckets - 1) * (
        maximum - minimum)
