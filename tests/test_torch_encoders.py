"""The port's encoders and anomaly stages: the contracts of
`tests/test_encoders.py` on the port alone, then parity with the JAX
package on inputs made from a seed with numpy.

Tolerances: the encoders, `bucketize`, the HTM anomaly score under
replayed draws, `alert_episodes` and `score_alert_windows` are
bit-equal. The likelihood is held to |dL| <= 2.4e-7 (4 ulp at 1.0):
`torch.erf` and XLA's `erf` differ by up to 5 ulp and the float32 sums
run in another order. The z-score is held to |dz| <= 2e-6 + 1e-6 |z|
(float32 sums in another order). Alert decisions on the tested traces
are equal; a score within the tolerance of a threshold is printed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bithtm_tpu import encoders as jenc
from bithtm_tpu import htm_init as jax_htm_init
from bithtm_tpu import htm_scan as jax_htm_scan
from bithtm_tpu import make_htm_config as jax_make_htm_config
from bithtm_tpu import readout as jread

import bithtm_tpu_torch as bt
from bithtm_tpu_torch.convert import (htm_state_from_numpy,
                                      named_state_from_numpy,
                                      named_state_to_numpy)
from bithtm_tpu_torch.encoders import (CategoryEncoder, CyclicEncoder,
                                       DateTimeEncoder, ScalarEncoder,
                                       anomaly_score, concat)

from .test_torch_htm import ReplayDraws, copy_keys

LIK_TOL = 2.4e-7


def z_tol(z):
    return 2e-6 + 1e-6 * np.abs(z)


def cpu(x):
    return torch.as_tensor(np.asarray(x))


# ---- the contracts of tests/test_encoders.py, on the port --------------


def test_scalar_encoder_sparsity_and_locality():
    enc = ScalarEncoder(0.0, 100.0, size=200, active_bits=15)
    a, b, c = (enc(v, "cpu").numpy() for v in (10.0, 11.0, 90.0))
    assert a.sum() == b.sum() == c.sum() == 15
    assert (a & b).sum() > 10        # near values share most bits
    assert (a & c).sum() == 0        # far values share none
    # clipping
    assert torch.equal(enc(-5.0, "cpu"), enc(0.0, "cpu"))
    assert torch.equal(enc(500.0, "cpu"), enc(100.0, "cpu"))


def test_scalar_encoder_batched():
    enc = ScalarEncoder(0.0, 1.0, size=64, active_bits=5)
    out = enc(torch.tensor([[0.0, 0.5], [1.0, 0.25]]))
    assert out.shape == (2, 2, 64) and out.device.type == "cpu"
    assert (out.sum(-1) == 5).all()


def test_cyclic_encoder_wraps():
    enc = CyclicEncoder(24.0, size=48, active_bits=5)
    late = enc(23.9, "cpu")
    early = enc(0.1, "cpu")
    assert late.sum() == early.sum() == 5
    assert (late & early).sum() >= 3   # adjacent across the wrap


def test_category_encoder_disjoint():
    enc = CategoryEncoder(4, active_bits=6)
    outs = [enc(i, "cpu") for i in range(4)]
    for i in range(4):
        assert outs[i].sum() == 6
        for j in range(i + 1, 4):
            assert (outs[i] & outs[j]).sum() == 0


def test_datetime_encoder_shape():
    enc = DateTimeEncoder()
    out = enc(torch.tensor([0.0, 3600.0 * 5]))
    assert out.shape == (2, enc.size)
    assert (out.sum(-1) == enc.hour_bits + enc.weekday_bits).all()


def test_anomaly_score():
    act = np.zeros(10, bool)
    act[:4] = True
    pred = np.zeros(10, bool)
    pred[:2] = True
    assert anomaly_score(pred, act) == 0.5
    assert anomaly_score(act, act) == 0.0
    assert anomaly_score(np.zeros(10, bool), act) == 1.0


# the pipeline of test_nab_style_anomaly_pipeline (128 columns x 8 cells)
NAB_VALUE = (-1.2, 1.2, 160, 13)
NAB_TIME = (8.0, 64, 7)
NAB_CFG = dict(column_dim=128, cell_dim=8, active_columns=6,
               segment_activation_threshold=3, segment_matching_threshold=3,
               segment_sampling_synapses=12,
               sp_overrides={"boosting_intensity": 0.05})
NAB_T = 8 * 30


def nab_inputs(value_enc, time_enc, values, steps, device="cpu"):
    """(T, 1, I) inputs of one stream."""
    return concat(value_enc(cpu(values), device),
                  time_enc(cpu(steps).float(), device))[:, None]


def test_nab_style_anomaly_pipeline():
    """A periodic scalar stream: anomaly falls as the model learns the
    cycle, then spikes when the signal breaks pattern."""
    value_enc, time_enc = ScalarEncoder(*NAB_VALUE), CyclicEncoder(*NAB_TIME)
    cfg = bt.make_htm_config(value_enc.size + time_enc.size, **NAB_CFG)
    t = np.arange(NAB_T)
    x = nab_inputs(value_enc, time_enc, np.sin(2 * np.pi * t / 8.0), t)
    gen = torch.Generator().manual_seed(0)
    state = bt.htm_init(cfg, gen, "cpu")
    draws = bt.TorchDraws(cfg.tm, 1, "cpu", gen)
    state, metrics = bt.htm_scan(cfg, state, x, True, draws=draws)
    anomaly = metrics["anomaly"][:, 0].numpy()
    assert anomaly[:8].mean() > 0.9          # everything novel at first
    assert anomaly[-16:].mean() < 0.3        # cycle learned

    # break the pattern: constant outlier values
    x2 = nab_inputs(value_enc, time_enc, np.full(8, 1.2), np.arange(8))
    state, m2 = bt.htm_scan(cfg, state, x2, True, draws=draws)
    assert m2["anomaly"][1:].mean() > 0.5


def test_datetime_encoder_minute_resolution_current_era():
    # float32 phase reduction would quantize current-era epochs to its
    # 128s ulp; with minute-wide buckets a one-minute step must move
    # the encoding, including for float (f64) inputs
    enc = DateTimeEncoder(hour_size=1440, hour_bits=21)  # 60s buckets
    base = 1_755_000_000
    a = enc(base, "cpu")
    b = enc(base + 60, "cpu")         # one minute later
    c = enc(float(base + 60), "cpu")  # same, as a float timestamp
    assert not torch.equal(a, b)
    assert torch.equal(b, c)
    # 32-bit-overflow era (year 2040) still works
    _ = enc(2_220_000_000, "cpu")


def likelihoods(scores, window, momentum=0.9, exclude=10, state=None):
    """The port's streaming likelihood over (T, B) scores."""
    st = state or bt.anomaly_likelihood_init(window, scores.shape[1], "cpu")
    out = []
    for s in scores:
        st, lik = bt.anomaly_likelihood_update(st, s, momentum, exclude)
        out.append(lik)
    return st, torch.stack(out)


def test_anomaly_likelihood_flags_regime_change():
    """Steady noisy scores keep the likelihood moderate; a sustained jump
    drives it into the alert tail."""
    rng = np.random.RandomState(0)
    steady = rng.uniform(0.0, 0.2, 300).astype(np.float32)
    burst = rng.uniform(0.8, 1.0, 30).astype(np.float32)
    seq = cpu(np.concatenate([steady, burst]))[:, None]
    state, liks = likelihoods(seq, 200)
    liks = liks[:, 0].numpy()
    assert (liks[:19] == 0.5).all()          # undecided warm-up
    assert liks[150:300].max() < 0.999       # steady regime: no alert
    # burst onset alerts hard; the estimator then adapts as the burst
    # scores enter its own window (alert is a peak, not a plateau)
    assert liks[300:320].max() > 0.99999
    # recovers statefully: feeding steady scores again decays it
    _, liks2 = likelihoods(cpu(steady[:150])[:, None], 200, state=state)
    assert liks2[-1, 0] < 0.999
    with pytest.raises(ValueError, match="exclude_recent"):
        bt.anomaly_likelihood_update(bt.anomaly_likelihood_init(19, 1,
                                                                "cpu"), 0.5)


def test_alert_episodes_and_window_scoring():
    """Detections merge into alerts by gap, alerts score against
    ground-truth windows at the window level."""
    eps = bt.alert_episodes([5, 6, 8, 20, 23, 40], merge_gap=3)
    assert eps == [(5, 8), (20, 23), (40, 40)]
    assert bt.alert_episodes([], merge_gap=3) == []

    windows = [(0, 10), (30, 35)]
    r = bt.score_alert_windows(eps, windows)
    assert (r["tp"], r["fp"], r["fn"]) == (1, 2, 1)
    assert r["precision"] == 1 / 3 and r["recall"] == 0.5
    assert abs(r["f1"] - 0.4) < 1e-12

    r2 = bt.score_alert_windows([(2, 4), (31, 31)], windows)
    assert (r2["tp"], r2["fp"], r2["fn"]) == (2, 0, 0)
    assert r2["f1"] == 1.0

    r3 = bt.score_alert_windows([], windows)
    assert (r3["tp"], r3["fp"], r3["fn"]) == (0, 0, 2)
    assert r3["f1"] == 0.0


def drift_spike_trace():
    P, T = 24, 1200
    t = np.arange(T)
    rng = np.random.RandomState(0)
    v = np.sin(2 * np.pi * t / P) + rng.normal(0, 0.12, T) \
        + np.linspace(0, 0.6, T)  # noise + drift, like the bench tasks
    at = 40 * P + P // 2
    v[at] = 1.9
    return v, P, at


def test_seasonal_zscore_spike_no_echo_and_drift_immune():
    """Fires on a point spike buried in noise, not one period later, and
    not on slow linear drift."""
    v, P, at = drift_spike_trace()
    z = bt.seasonal_zscore(cpu(v), P, window=4 * P).numpy()
    assert abs(z[at]) >= 5.0, z[at]
    assert abs(z[at + P]) < 5.0 and abs(z[at + 2 * P]) < 5.0
    rest = np.abs(np.delete(z, at))
    assert rest.max() < 5.0, rest.max()


def test_seasonal_zscore_streaming_matches_array_and_gates():
    P, W, T = 12, 36, 300
    rng = np.random.RandomState(3)
    v = np.sin(2 * np.pi * np.arange(T) / P) + rng.normal(0, 0.1, T)
    z_arr = bt.seasonal_zscore(cpu(v), P, window=W).numpy()
    st = bt.seasonal_zscore_init(P, window=W, device="cpu")
    z_stream = []
    for x in v:
        st, z = bt.seasonal_zscore_update(st, x, P)
        z_stream.append(z[0].item())
    # a loop of the streaming form: bit-identical
    np.testing.assert_array_equal(z_arr, np.asarray(z_stream, np.float32))
    assert (z_arr[: 3 * P + W] == 0).all()
    assert (z_arr[3 * P + W:] != 0).any()
    with pytest.raises(ValueError, match="odd"):
        bt.seasonal_zscore_init(P, window=W, lags=2, device="cpu")


# ---- parity with the JAX package ---------------------------------------

# the scalar ranges of the examples and tests: anomaly_detection,
# anomaly_benchmark, sequence_prediction, test_nab_style_anomaly_pipeline,
# test_readout
SCALAR = [(-1.5, 1.5, 256, 17), (-2.2, 2.2, 256, 17), (0.0, 7.0, 256, 17),
          (-1.2, 1.2, 160, 13), (0.0, 5.0, 128, 11)]


@pytest.mark.parametrize("lo,hi,size,bits", SCALAR)
def test_scalar_encoder_and_bucketize_match_jax(lo, hi, size, bits):
    """Bit-equal at random values and at every rounding midpoint (where
    half-to-even decides) and centre of the encoder's buckets."""
    jax_enc, port_enc = (jenc.ScalarEncoder(lo, hi, size, bits),
                         ScalarEncoder(lo, hi, size, bits))
    n = jax_enc.buckets - 1
    k = np.arange(jax_enc.buckets, dtype=np.float64)
    rng = np.random.RandomState(size + bits)
    span = hi - lo
    values = np.concatenate([
        rng.uniform(lo - 0.2 * span, hi + 0.2 * span, 20000),
        lo + (k + 0.5) / n * span, lo + k / n * span]).astype(np.float32)
    np.testing.assert_array_equal(port_enc(cpu(values)).numpy(),
                                  np.asarray(jax_enc(jnp.asarray(values))))
    for buckets in (8, n + 1):
        got = bt.bucketize(cpu(values), lo, hi, buckets)
        want = np.asarray(jread.bucketize(jnp.asarray(values), lo, hi,
                                          buckets))
        np.testing.assert_array_equal(got.numpy(), want)
        assert got.dtype == torch.int32
        idx = np.arange(buckets, dtype=np.int32)
        np.testing.assert_array_equal(
            bt.bucket_value(cpu(idx), lo, hi, buckets).numpy(),
            np.asarray(jread.bucket_value(jnp.asarray(idx), lo, hi,
                                          buckets)))


def test_cyclic_category_datetime_match_jax():
    rng = np.random.RandomState(5)
    phases = np.concatenate([
        rng.uniform(-1e3, 1e3, 50000), rng.uniform(-1e6, 1e6, 50000),
        np.arange(-48, 48, 0.25)]).astype(np.float32)
    for period, size, bits in ((24.0, 96, 9), (8.0, 64, 7), (7.0, 48, 5)):
        np.testing.assert_array_equal(
            CyclicEncoder(period, size, bits)(cpu(phases)).numpy(),
            np.asarray(jenc.CyclicEncoder(period, size, bits)(
                jnp.asarray(phases))))
    idx = rng.randint(0, 9, (50, 3))
    np.testing.assert_array_equal(
        CategoryEncoder(9, 4)(cpu(idx)).numpy(),
        np.asarray(jenc.CategoryEncoder(9, 4)(jnp.asarray(idx))))
    epochs = np.concatenate([rng.randint(0, 2**31 - 1, 500),
                             rng.randint(1_700_000_000, 2_300_000_000, 500)])
    for enc_args in ((), (1440, 21)):
        j, p = jenc.DateTimeEncoder(*enc_args), DateTimeEncoder(*enc_args)
        np.testing.assert_array_equal(p(epochs, "cpu").numpy(),
                                      np.asarray(j(epochs)))
        np.testing.assert_array_equal(p(cpu(epochs)).numpy(),
                                      np.asarray(j(epochs)))
        np.testing.assert_array_equal(p(int(epochs[-1]), "cpu").numpy(),
                                      np.asarray(j(int(epochs[-1]))))


def regime_scores(B, T, seed):
    """(T, B) float32 raw scores: noisy steady regimes with bursts."""
    rng = np.random.RandomState(seed)
    s = rng.uniform(0.0, 0.25, (T, B))
    for b in range(B):
        at = rng.randint(T // 3, T - 20)
        s[at:at + rng.randint(3, 20), b] = rng.uniform(0.6, 1.0)
    s[rng.rand(T, B) < 0.02] = 1.0
    return s.astype(np.float32)


def jax_likelihoods(scores, window, momentum, exclude, state=None):
    """`jax.vmap` over streams of a scan of JAX's update: (T, B)."""
    def one(st, s):
        return jax.lax.scan(
            lambda c, x: jenc.anomaly_likelihood_update(c, x, momentum,
                                                        exclude), st, s)

    if state is None:
        state = jax.vmap(lambda _: jenc.anomaly_likelihood_init(window))(
            jnp.arange(scores.shape[1]))
    st, lik = jax.jit(jax.vmap(one, in_axes=(0, 1), out_axes=(0, 1)))(
        state, jnp.asarray(scores))
    return st, np.asarray(lik)


def test_anomaly_likelihood_matches_jax():
    """B=6 streams: the port against a `jax.vmap` of JAX's scan, from
    fresh states, then on from JAX's state half-way (converted)."""
    B, T, W, mom, R = 6, 700, 200, 0.7, 24
    scores = regime_scores(B, T, 11)
    half = T // 2
    jst, jlik = jax_likelihoods(scores[:half], W, mom, R)
    _, jlik2 = jax_likelihoods(scores[half:], W, mom, R, jst)
    pst, plik = likelihoods(cpu(scores[:half]), W, mom, R)
    st = named_state_from_numpy(bt.AnomalyLikelihoodState, jst, "cpu")
    for name, got in named_state_to_numpy(pst).items():
        # the ring, position and count are exact; the EMA rounds alike
        np.testing.assert_array_equal(got, np.asarray(getattr(jst, name)),
                                      err_msg=name)
    _, plik2 = likelihoods(cpu(scores[half:]), W, mom, R, st)
    want = np.concatenate([jlik, jlik2])
    got = torch.cat([plik, plik2]).numpy()
    err = np.abs(got - want)
    assert err.max() <= LIK_TOL, (err.max(), np.unravel_index(err.argmax(),
                                                              err.shape))
    assert (want[:R + 9] == 0.5).all() and (got[:R + 9] == 0.5).all()
    assert want.max() > 0.99999          # the bursts reach the alert tail


def test_seasonal_zscore_matches_jax():
    """(T, B) values: the whole-array z against a `jax.vmap` of JAX's,
    then the streaming form from JAX's state half-way (converted)."""
    P, W, T, B = 24, 96, 900, 4
    rng = np.random.RandomState(4)
    t = np.arange(T)
    v = (np.sin(2 * np.pi * t / P)[:, None] + rng.normal(0, 0.1, (T, B))
         + np.linspace(0, 0.5, T)[:, None])
    v[500, 1] = 1.9
    v[600:, 2] += 0.4
    want = np.asarray(jax.vmap(
        lambda x: jenc.seasonal_zscore(x, P, window=W), 1, 1)(
            jnp.asarray(v)))
    got = bt.seasonal_zscore(cpu(v), P, window=W).numpy()
    assert np.all(np.abs(got - want) <= z_tol(want)), np.abs(got - want).max()
    assert np.abs(want).max() >= 5       # the spike and the shift fire

    half = T // 2
    jst = jax.vmap(lambda _: jenc.seasonal_zscore_init(P, W))(jnp.arange(B))
    step = jax.jit(jax.vmap(
        lambda st, x: jenc.seasonal_zscore_update(st, x, P)))
    vf = jnp.asarray(v, jnp.float32)
    for x in vf[:half]:
        jst, _ = step(jst, x)
    st = named_state_from_numpy(bt.SeasonalZScoreState, jst, "cpu")
    for i in range(half, T):
        jst, jz = step(jst, vf[i])
        st, pz = bt.seasonal_zscore_update(st, cpu(v[i]), P)
        jz = np.asarray(jz)
        assert np.all(np.abs(pz.numpy() - jz) <= z_tol(jz)), i
    for name, got in named_state_to_numpy(st).items():
        np.testing.assert_array_equal(got, np.asarray(getattr(jst, name)),
                                      err_msg=name)


def near(values, threshold, tol):
    return np.flatnonzero(np.abs(values - threshold) <= tol)


def test_nab_pipeline_matches_jax():
    """The pipeline of `test_nab_style_anomaly_pipeline` (128 x 8) from
    JAX's state (converted) with its draws replayed: the anomaly scores
    bit-equal, the likelihood and z within tolerance, the alerts
    equal."""
    P, thr_nlog, thr_z = 8, 2.0, 5.0
    value_enc, time_enc = ScalarEncoder(*NAB_VALUE), CyclicEncoder(*NAB_TIME)
    jvalue, jtime = jenc.ScalarEncoder(*NAB_VALUE), jenc.CyclicEncoder(
        *NAB_TIME)
    I = value_enc.size + time_enc.size
    jcfg = jax_make_htm_config(I, **NAB_CFG)
    pcfg = bt.make_htm_config(I, **NAB_CFG)
    t = np.arange(NAB_T + 16)
    values = np.sin(2 * np.pi * t / P)
    values[NAB_T:NAB_T + 8] = 1.2         # the pattern breaks
    jx = np.asarray(jenc.concat(
        jvalue(jnp.asarray(values)), jtime(jnp.asarray(t, jnp.float32))))
    px = nab_inputs(value_enc, time_enc, values, t)
    np.testing.assert_array_equal(px[:, 0].numpy(), jx)

    jstate = jax_htm_init(jax.random.key(0), jcfg)
    pstate = htm_state_from_numpy(jstate, "cpu")
    draws = ReplayDraws(pcfg.tm, copy_keys(jstate.key[None]))
    _, jm = jax_htm_scan(jcfg, jstate, jnp.asarray(jx), True)
    _, pm = bt.htm_scan(pcfg, pstate, px, True, draws=draws)
    j_raw = np.asarray(jm["anomaly"])
    np.testing.assert_array_equal(pm["anomaly"][:, 0].numpy(), j_raw)
    assert j_raw[NAB_T - 16:NAB_T].mean() < 0.3
    assert j_raw[NAB_T + 1:NAB_T + 8].mean() > 0.5

    _, jlik = jax_likelihoods(j_raw[:, None], 64, 0.7, P)
    _, plik = likelihoods(pm["anomaly"], 64, 0.7, P)
    jz = np.asarray(jenc.seasonal_zscore(jnp.asarray(values), P, window=32))
    pz = bt.seasonal_zscore(cpu(values), P, window=32).numpy()
    jlik, plik = jlik[:, 0], plik[:, 0].numpy()
    assert np.abs(plik - jlik).max() <= LIK_TOL
    assert np.all(np.abs(pz - jz) <= z_tol(jz))

    thr_lik = np.float32(1 - 10 ** -thr_nlog)
    for name, steps in (("likelihood", near(jlik, thr_lik, LIK_TOL)),
                        ("z", near(np.abs(jz), thr_z, z_tol(thr_z)))):
        for s in steps:  # shown, not hidden: a decision a tolerance away
            print(f"step {s}: {name} within tolerance of its threshold")

    def alerts(lik, z):
        nlog = -np.log10(np.maximum(1.0 - lik, 1e-12))
        fire = (nlog >= thr_nlog) | (np.abs(z) >= thr_z)
        return bt.alert_episodes(np.flatnonzero(fire), merge_gap=P // 2)

    j_eps, p_eps = (jenc.alert_episodes(np.flatnonzero(
        (-np.log10(np.maximum(1.0 - jlik, 1e-12)) >= thr_nlog)
        | (np.abs(jz) >= thr_z)), merge_gap=P // 2), alerts(plik, pz))
    assert p_eps == j_eps and p_eps, (p_eps, j_eps)
    windows = [(NAB_T - 2, NAB_T + 10)]
    assert (bt.score_alert_windows(p_eps, windows)
            == jenc.score_alert_windows(j_eps, windows))
