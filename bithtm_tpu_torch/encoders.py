"""SDR encoders and the NAB-style anomaly stages.

Counterpart of `bithtm_tpu/encoders.py`: the scalar, cyclic, category
and datetime encoders map values with any leading axes to bool SDRs that
feed `htm_step` / `htm_scan`; the anomaly likelihood and the seasonal
windowed z-score post-process a stream of raw anomaly scores and values
with a leading stream axis B (B=1 is the single stream); alert merging
and window scoring are host Python on the finished series.

An encoder's output lies on the values' device when they are a tensor,
else on ``device`` (the card unless ``device="cpu"``). The arithmetic
repeats the JAX package's float32 steps: the scalar encoder divides (it
does not multiply by a reciprocal) and rounds half to even, so an
encoding is bit-equal to the JAX package's. The likelihood's `erf` and
its float32 sums round otherwise than XLA's, within the tolerances of
`tests/test_torch_encoders.py`.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch

from .ops.regularization import _fma_f32


def _on(value, device) -> torch.device:
    """The device of an op's output: ``device`` if given, else the
    values' own if they are a tensor, else the card."""
    if device is not None:
        return torch.device(device)
    if isinstance(value, torch.Tensor):
        return value.device
    return torch.device("cuda")


def _f32(value, device=None) -> torch.Tensor:
    """``value`` as a float32 tensor, rounded once from its own type."""
    dev = _on(value, device)
    if isinstance(value, torch.Tensor):
        return value.to(dev, torch.float32)
    return torch.as_tensor(np.asarray(value), device=dev).to(torch.float32)


def _div(x: torch.Tensor, c: float) -> torch.Tensor:
    """x / c, a correctly rounded float32 division on every device.
    PyTorch's CUDA kernel multiplies by the reciprocal of a Python
    scalar divisor, which rounds otherwise on some values, so the
    divisor goes in as a tensor on x's device."""
    return x / torch.full((), c, dtype=x.dtype, device=x.device)


def _unit_position(value, minimum: float, maximum: float,
                   device=None) -> torch.Tensor:
    """clip((v - min) / (max - min), 0, 1) in float32, a division as in
    the JAX package (its product with the reciprocal rounds otherwise)."""
    v = _div(_f32(value, device) - minimum, maximum - minimum)
    return v.clamp(0.0, 1.0)


@dataclasses.dataclass(frozen=True)
class ScalarEncoder:
    """Classic HTM scalar encoder: a contiguous run of `active_bits` ones
    whose position slides linearly with the value over [minimum, maximum]
    (clipped). Overlap between two encodings decays linearly with value
    distance — the HTM similarity contract."""

    minimum: float
    maximum: float
    size: int = 400
    active_bits: int = 21

    @property
    def buckets(self) -> int:
        return self.size - self.active_bits + 1

    def __call__(self, value, device=None) -> torch.Tensor:
        v = _unit_position(value, self.minimum, self.maximum, device)
        start = torch.round(v * (self.buckets - 1)).to(torch.int32)
        i = torch.arange(self.size, dtype=torch.int32, device=v.device)
        s = start[..., None]
        return (i >= s) & (i < s + self.active_bits)


@dataclasses.dataclass(frozen=True)
class CyclicEncoder:
    """Scalar encoder on a circle (hour-of-day, day-of-week): the active
    run wraps, so maximum and minimum encode adjacently."""

    period: float
    size: int = 128
    active_bits: int = 11

    def __call__(self, value, device=None) -> torch.Tensor:
        phase = torch.remainder(_f32(value, device), self.period)
        start = torch.floor(_div(phase, self.period)
                            * self.size).to(torch.int32)
        i = torch.arange(self.size, dtype=torch.int32, device=phase.device)
        off = torch.remainder(i - start[..., None], self.size)
        return off < self.active_bits


@dataclasses.dataclass(frozen=True)
class CategoryEncoder:
    """Disjoint one-hot blocks of `active_bits` per category: no overlap
    between distinct categories."""

    categories: int
    active_bits: int = 15

    @property
    def size(self) -> int:
        return self.categories * self.active_bits

    def __call__(self, index, device=None) -> torch.Tensor:
        dev = _on(index, device)
        idx = torch.as_tensor(index, device=dev).to(dev, torch.int32)
        i = torch.arange(self.size, dtype=torch.int32, device=dev)
        s = (idx * self.active_bits)[..., None]
        return (i >= s) & (i < s + self.active_bits)


@dataclasses.dataclass(frozen=True)
class DateTimeEncoder:
    """NAB-style timestamp context: cyclic hour-of-day + day-of-week.
    Input is integer seconds-since-epoch (or any consistent origin): a
    numpy array, a Python int or float, or a tensor.

    The phase reduction happens on the host in int64 (exact for any
    timestamp): reducing current-era epoch values in float32 would
    quantize them to its 128-second ulp, aliasing nearby minutes, and
    int32 would overflow in 2038."""

    hour_size: int = 128
    hour_bits: int = 11
    weekday_size: int = 64
    weekday_bits: int = 9

    @property
    def size(self) -> int:
        return self.hour_size + self.weekday_size

    def __call__(self, epoch_seconds, device=None) -> torch.Tensor:
        dev = _on(epoch_seconds, device)
        if isinstance(epoch_seconds, torch.Tensor):
            epoch_seconds = epoch_seconds.cpu().numpy()
        t = np.asarray(epoch_seconds).astype(np.int64)
        day_phase = (t % 86400).astype(np.float32)
        week_phase = (t % (7 * 86400)).astype(np.float32)
        hour = CyclicEncoder(86400.0, self.hour_size,
                             self.hour_bits)(day_phase, dev)
        # epoch day 0 (1970-01-01) was a Thursday; weekday phase only
        # needs consistency, not calendar alignment
        wday = CyclicEncoder(7 * 86400.0, self.weekday_size,
                             self.weekday_bits)(week_phase, dev)
        return torch.cat([hour, wday], dim=-1)


def concat(*sdrs: torch.Tensor) -> torch.Tensor:
    """Concatenate encoder outputs into one input SDR."""
    return torch.cat(sdrs, dim=-1)


def anomaly_score(prev_predicted_columns: np.ndarray,
                  active_columns: np.ndarray) -> float:
    """NAB/Numenta raw anomaly score: fraction of currently active
    columns that were NOT predicted by the previous step. The in-step
    `metrics['anomaly']` (bursting / active_columns) is the same
    quantity computed on the device."""
    active = np.asarray(active_columns, bool)
    pred = np.asarray(prev_predicted_columns, bool)
    n_active = active.sum()
    if n_active == 0:
        return 0.0
    return float((active & ~pred).sum() / n_active)


# ---- anomaly likelihood (serving-side post-processing) -----------------
# Production anomaly detection (the NAB protocol) thresholds the
# *likelihood*: the Gaussian tail probability of the recent short-term
# mean score under the stream's own running score distribution.


class AnomalyLikelihoodState(NamedTuple):
    scores: torch.Tensor      # (B, W) f32 ring buffer of raw scores
    pos: torch.Tensor         # (B,) int32 next write position
    count: torch.Tensor       # (B,) int32 scores seen (saturates at W)
    short_mean: torch.Tensor  # (B,) f32 EMA of recent scores


def anomaly_likelihood_init(window: int = 500, batch: int = 1,
                            device=None) -> AnomalyLikelihoodState:
    dev = _on(None, device)
    return AnomalyLikelihoodState(
        scores=torch.zeros((batch, window), dtype=torch.float32,
                           device=dev),
        pos=torch.zeros((batch,), dtype=torch.int32, device=dev),
        count=torch.zeros((batch,), dtype=torch.int32, device=dev),
        short_mean=torch.zeros((batch,), dtype=torch.float32, device=dev),
    )


def anomaly_likelihood_update(
    state: AnomalyLikelihoodState,
    score,
    short_momentum: float = 0.9,
    exclude_recent: int = 10,
) -> tuple[AnomalyLikelihoodState, torch.Tensor]:
    """Push one raw anomaly score a stream ((B,)); returns (new_state,
    likelihood (B,) in [0, 1]). Likelihood ~0.5 for in-distribution
    scores, -> 1 when the recent short-term mean sits far in the upper
    tail of the stream's own running score distribution. Threshold
    around 0.99999 for NAB-style alerts (``-log10(1 - L) >= 5``).

    The distribution is estimated EXCLUDING the newest
    ``exclude_recent`` samples (the Numenta construction), so an anomaly
    burst does not contaminate the baseline it is judged against. Until
    enough history exists the likelihood is held at 0.5 (undecided).
    The state passed in is not changed."""
    B, W = state.scores.shape
    R = exclude_recent
    if W < R + 10:
        raise ValueError(
            f"anomaly-likelihood window ({W}) must be at least "
            f"exclude_recent + 10 ({R + 10}); otherwise the warm-up "
            f"gate never opens and the likelihood stays 0.5 forever"
        )
    dev = state.scores.device
    score = _f32(score, dev).expand(B)
    scores = state.scores.scatter(1, state.pos.long()[:, None],
                                  score[:, None])
    pos = torch.remainder(state.pos + 1, W)  # no int32 wrap drift
    count = torch.clamp(state.count + 1, max=W)
    # XLA contracts the JAX package's ``m * prev + (1 - m) * score``
    # into fma(1 - m, score, m * prev); the port rounds it once alike
    # (ROADMAP faults f and o)
    prev = torch.where(state.count > 0, state.short_mean, score)
    short = _fma_f32(score, 1.0 - short_momentum, short_momentum * prev)

    # age 0 = newest; estimate over samples older than R
    slot = torch.arange(W, dtype=torch.int32, device=dev)
    age = torch.remainder(pos[:, None] - 1 - slot, W)
    est = (age >= R) & (age < count[:, None])
    n = est.sum(-1).clamp(min=1).to(torch.float32)
    mean = torch.where(est, scores, 0.0).sum(-1) / n
    var = torch.where(est, (scores - mean[:, None]) ** 2, 0.0).sum(-1) / n
    std = torch.sqrt(torch.clamp(var, min=1e-8))
    # Gaussian upper-tail CDF of the short-term mean
    z = (short - mean) / std
    likelihood = 0.5 * (1.0 + torch.erf(_div(z, math.sqrt(2.0))))
    likelihood = torch.where(count >= R + 10, likelihood, 0.5)
    return (
        AnomalyLikelihoodState(scores=scores, pos=pos, count=count,
                               short_mean=short),
        likelihood,
    )


# ---- windowed z-score residual stage (pre-encoder / side detector) -----
# r[t] = v[t] - median(v[t - period], ...) cancels seasonality and slow
# drift; a causal windowed z-score of r flags the point and level
# anomalies that chronic noise or drift hide from the likelihood
# (`examples/anomaly_benchmark.py` unions it with the likelihood alerts).


class SeasonalZScoreState(NamedTuple):
    lag: torch.Tensor    # (B, lags * period) ring of raw values
    resid: torch.Tensor  # (B, window) ring of residuals
    pos: torch.Tensor    # (B,) int32 step counter


def seasonal_zscore_init(period: int, window: int = 96, lags: int = 3,
                         batch: int = 1, device=None
                         ) -> SeasonalZScoreState:
    if lags < 1 or lags % 2 == 0:
        raise ValueError(f"lags must be odd >= 1, got {lags} (the "
                         f"seasonal baseline is a median over lags)")
    dev = _on(None, device)
    return SeasonalZScoreState(
        lag=torch.zeros((batch, lags * period), dtype=torch.float32,
                        device=dev),
        resid=torch.zeros((batch, window), dtype=torch.float32, device=dev),
        pos=torch.zeros((batch,), dtype=torch.int32, device=dev),
    )


def seasonal_zscore_update(
    state: SeasonalZScoreState, value, period: int,
    eps: float = 1e-6,
) -> tuple[SeasonalZScoreState, torch.Tensor]:
    """Streaming form of `seasonal_zscore`: push one value a stream
    ((B,)), get its z (B,).

    The seasonal baseline is the MEDIAN of the last `lags` same-phase
    values (``v[t - period], v[t - 2*period], ...``): a single anomalous
    cycle cannot move it, which kills the "seasonal echo" false alert
    one period after a spike. The median of an odd count is one of the
    values, so it is exact. The state passed in is not changed."""
    B, L = state.lag.shape
    W = state.resid.shape[1]
    k = L // period
    v = _f32(value, state.lag.device).expand(B)
    t = state.pos
    seas = torch.stack([
        state.lag.gather(1, torch.remainder(t - (i + 1) * period,
                                            L).long()[:, None])[:, 0]
        for i in range(k)], dim=-1)
    r = torch.where(t >= L, v - seas.median(dim=-1).values, 0.0)
    # stats over the current ring BEFORE inserting r (ages 1..window)
    n = torch.clamp(t, 1, W).to(torch.float32)
    live = (torch.arange(W, device=t.device)[None]
            < torch.clamp(t, max=W)[:, None])
    s1 = torch.where(live, state.resid, 0.0).sum(-1)
    s2 = torch.where(live, state.resid * state.resid, 0.0).sum(-1)
    mean = s1 / n
    var = torch.clamp(s2 / n - mean * mean, min=eps)
    z = torch.where(t >= L + W, (r - mean) / torch.sqrt(var), 0.0)
    return SeasonalZScoreState(
        lag=state.lag.scatter(1, torch.remainder(t, L).long()[:, None],
                              v[:, None]),
        resid=state.resid.scatter(1, torch.remainder(t, W).long()[:, None],
                                  r[:, None]),
        pos=t + 1,
    ), z


def seasonal_zscore(values, period: int, window: int = 96,
                    lags: int = 3, eps: float = 1e-6,
                    device=None) -> torch.Tensor:
    """Causal windowed z-score of the seasonal residual, whole-array,
    over the leading (time) axis of ``values`` ((T,) or (T, B)).

    ``r[t] = v[t] - median(v[t - period], ..., v[t - lags*period])``;
    ``z[t]`` standardizes ``r[t]`` against the mean/std of the
    PRECEDING ``window`` residuals (excluding ``r[t]`` itself, so a
    spike cannot deflate its own z). The first
    ``lags * period + window`` steps emit 0 (insufficient history).
    A loop of `seasonal_zscore_update`, so the streaming form is
    bit-identical by construction."""
    v = _f32(values, device)
    flat = v.reshape(v.shape[0], -1)
    st = seasonal_zscore_init(period, window, lags, flat.shape[1], v.device)
    out = []
    for x in flat:
        st, z = seasonal_zscore_update(st, x, period, eps)
        out.append(z)
    return torch.stack(out).reshape(v.shape)


# ---- alerting + task-level scoring (host-side, NAB protocol) -----------


def alert_episodes(detect_steps, merge_gap: int):
    """Merge sorted detection step indices into (start, end) alerts.

    ``detect_steps`` is an ascending iterable of step indices where the
    detector fired (e.g. ``np.flatnonzero(nlog >= threshold)``);
    consecutive detections closer than ``merge_gap`` steps belong to
    the same alert episode."""
    episodes: list[list[int]] = []
    for s in detect_steps:
        s = int(s)
        if episodes and s - episodes[-1][1] <= merge_gap:
            episodes[-1][1] = s
        else:
            episodes.append([s, s])
    return [(a, b) for a, b in episodes]


def score_alert_windows(episodes, windows):
    """NAB-style window-level confusion for a set of alerts.

    ``episodes`` are (start, end) alerts (see `alert_episodes`);
    ``windows`` are (start, end) ground-truth anomaly windows. A window
    counts as detected iff at least one alert overlaps it; an alert
    overlapping no window is a false positive. Returns a dict with
    ``tp`` / ``fp`` / ``fn`` / ``precision`` / ``recall`` / ``f1``."""
    tp_windows = 0
    matched = [False] * len(episodes)
    for w0, w1 in windows:
        hit = False
        for i, (a0, a1) in enumerate(episodes):
            if a0 <= w1 and a1 >= w0:
                matched[i] = True
                hit = True
        tp_windows += hit
    fp = matched.count(False)
    fn = len(windows) - tp_windows
    precision = tp_windows / max(tp_windows + fp, 1)
    recall = tp_windows / max(len(windows), 1)
    f1 = (2 * precision * recall / (precision + recall)
          if precision + recall else 0.0)
    return dict(tp=tp_windows, fp=fp, fn=fn, precision=precision,
                recall=recall, f1=f1)
