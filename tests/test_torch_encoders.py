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


# ---- the anomaly stages' kernels (csrc/anomaly_pass.cu): the dispatchers
# on the CPU, their plain versions, and a numpy model of the kernels'
# summation order against JAX's scan


def launches():
    from bithtm_tpu_torch.ops import kernels

    return kernels.launch_counts()


def test_anomaly_stage_dispatchers_take_the_plain_version_on_the_cpu():
    """On CPU tensors the streaming updates, `likelihood_series`,
    `seasonal_zscore` and both `_steps` dispatchers run the plain version:
    no launch. The `_steps` names stay out of the public surface, which is
    the JAX package's."""
    from bithtm_tpu_torch.encoders import (anomaly_likelihood_steps,
                                           seasonal_zscore_steps)
    from bithtm_tpu_torch.examples import likelihood_series

    rng = np.random.RandomState(21)
    scores = cpu(rng.uniform(0, 0.3, (40, 3)).astype(np.float32))
    values = cpu(rng.normal(0, 1, (40, 3)))          # float64
    before = launches()
    st = bt.anomaly_likelihood_init(30, 3, "cpu")
    st, _ = bt.anomaly_likelihood_update(st, scores[0], 0.7, 5)
    st, _ = bt.anomaly_likelihood_update(st, 0.25, 0.7, 5)
    likelihood_series(scores, 30, 0.7, 5)
    anomaly_likelihood_steps(st, scores, 0.7, 5)
    zs = bt.seasonal_zscore_init(4, 10, batch=3, device="cpu")
    zs, _ = bt.seasonal_zscore_update(zs, values[0], 4)
    bt.seasonal_zscore(values, 4, window=10)
    seasonal_zscore_steps(zs, values, 4)
    assert launches() == before
    assert not any(name.endswith("_steps") or name.endswith("_steps_ref")
                   for name in bt.__all__)
    with pytest.raises(ValueError, match="exclude_recent"):
        anomaly_likelihood_steps(None, scores, 0.7, 25, window=30)
    with pytest.raises(ValueError, match="odd"):
        seasonal_zscore_steps(None, values, 4, window=10, lags=2)


@pytest.mark.parametrize("carried", [False, True])
def test_anomaly_steps_refs_equal_the_update_loops(carried):
    """`anomaly_likelihood_steps_ref` and `seasonal_zscore_steps_ref` (the
    kernels' plain versions) equal the loop of the streaming updates bit
    for bit, from a fresh state and from a carried one (converted from
    JAX's state mid-ring); from a fresh state so do `likelihood_series`
    and `seasonal_zscore`."""
    from bithtm_tpu_torch.encoders import (anomaly_likelihood_steps_ref,
                                           seasonal_zscore_steps_ref)
    from bithtm_tpu_torch.examples import likelihood_series

    B, T, W, R, P, ZW = 4, 120, 70, 8, 6, 20
    scores = regime_scores(B, T, 22)
    rng = np.random.RandomState(23)
    values = (np.sin(2 * np.pi * np.arange(T) / P)[:, None]
              + rng.normal(0, 0.1, (T, B))).astype(np.float32)
    if carried:
        jst, _ = jax_likelihoods(regime_scores(B, 95, 24), W, 0.7, R)
        lst = named_state_from_numpy(bt.AnomalyLikelihoodState, jst, "cpu")
        zj = jax.vmap(lambda _: jenc.seasonal_zscore_init(P, ZW))(
            jnp.arange(B))
        step = jax.jit(jax.vmap(
            lambda st, x: jenc.seasonal_zscore_update(st, x, P)))
        for x in jnp.asarray(rng.normal(0, 1, (45, B)), jnp.float32):
            zj, _ = step(zj, x)
        zst = named_state_from_numpy(bt.SeasonalZScoreState, zj, "cpu")
        assert 0 < int(lst.pos[0]) < W and int(zst.pos[0]) == 45
    else:
        lst = bt.anomaly_likelihood_init(W, B, "cpu")
        zst = bt.seasonal_zscore_init(P, ZW, batch=B, device="cpu")
    st, want = lst, []
    for s in cpu(scores):
        st, lik = bt.anomaly_likelihood_update(st, s, 0.7, R)
        want.append(lik)
    got_st, got = anomaly_likelihood_steps_ref(lst, cpu(scores), 0.7, R)
    assert torch.equal(got, torch.stack(want))
    for a, b in zip(got_st, st):
        assert torch.equal(a, b)
    zt, zwant = zst, []
    for x in cpu(values):
        zt, z = bt.seasonal_zscore_update(zt, x, P)
        zwant.append(z)
    zgot_st, zgot = seasonal_zscore_steps_ref(zst, cpu(values), P)
    assert torch.equal(zgot, torch.stack(zwant))
    for a, b in zip(zgot_st, zt):
        assert torch.equal(a, b)
    if not carried:
        assert torch.equal(likelihood_series(cpu(scores), W, 0.7, R), got)
        assert torch.equal(bt.seasonal_zscore(cpu(values), P, window=ZW),
                           zgot)


def _fours(x: np.ndarray) -> np.ndarray:
    """The sums of x's last axis in blocks of 4 (zeros padding the last),
    each summed from zero in turn."""
    pad = -x.shape[-1] % 4
    if pad:
        x = np.concatenate([x, np.zeros(x.shape[:-1] + (pad,), x.dtype)],
                           -1)
    x = x.reshape(x.shape[:-1] + (-1, 4))
    s = np.zeros(x.shape[:-1], np.float32)
    for j in range(4):
        s = s + x[..., j]
    return s


def tree_sum(vals: np.ndarray) -> np.ndarray:
    """The kernels' sum of a step's terms in turn along the last axis
    (csrc/anomaly_pass.cu `tree_sum`): a tree of fours six levels deep,
    each sum of four taken from zero in turn, then the trees of 4,096
    terms in turn. Zeros past a window's last term change no partial
    sum, so the windows of several streams pad to one length."""
    x = np.asarray(vals, np.float32)
    for _ in range(6):
        x = _fours(x)
    s = np.zeros(x.shape[:-1], np.float32)
    for j in range(x.shape[-1]):
        s = s + x[..., j]
    return s


def order_sum(vals: np.ndarray, W: int) -> np.ndarray:
    """The kernels' sum of (B, n) float32 terms a stream, oldest last (a
    step's window in age order), on the path a W-slot window takes
    (`kernels._steps`): "lane", one thread's `tree_sum`; "warp", lane l
    taking the terms l, l + 32, ... in `tree_sum`'s order, then lane i
    adding lane i ^ d's total for d = 16, 8, 4, 2, 1."""
    from bithtm_tpu_torch.ops import kernels

    if kernels._steps(W) == "lane":
        return tree_sum(vals)
    B, n = vals.shape
    vals = np.concatenate([vals, np.zeros((B, -n % 32), np.float32)], 1)
    tot = tree_sum(vals.reshape(B, -1, 32).transpose(0, 2, 1))
    for d in (16, 8, 4, 2, 1):
        tot = tot + tot[:, np.arange(32) ^ d]
    return tot[:, 0]


def model_likelihood(state: dict, scores, m: float, R: int):
    """numpy model of the `anomaly_likelihood` kernel: its rounding step
    by step (the EMA by the port's one-rounding `_fma_f32`, the product
    m * prev alone), its sums over the ages R .. count' - 1 in
    `order_sum`'s order, and `torch.erf` standing for the card's `erff`.
    Returns (state, (T, B) L)."""
    from bithtm_tpu_torch.ops.regularization import _fma_f32

    f32 = np.float32
    ring = np.array(state["scores"], np.float32)
    pos, count = (np.array(state[k], np.int32) for k in ("pos", "count"))
    short = np.array(state["short_mean"], np.float32)
    B, W = ring.shape
    lo, out, rows = max(R, 0), [], np.arange(B)
    ages = np.arange(lo, W)
    for s in np.asarray(scores, np.float32):
        ring[rows, pos] = s
        newpos = (pos + 1) % W
        nc = np.minimum(count + 1, W)
        prev = np.where(count > 0, short, s)
        short = _fma_f32(torch.from_numpy(s), 1.0 - m, torch.from_numpy(
            f32(m) * prev)).numpy()
        nf = np.maximum(nc - lo, 1).astype(np.float32)
        win = ring[rows[:, None], (newpos[:, None] - 1 - ages) % W]
        est = ages < nc[:, None]
        mean = order_sum(np.where(est, win, f32(0)), W) / nf
        d = win - mean[:, None]
        var = order_sum(np.where(est, d * d, f32(0)), W) / nf
        sd = np.sqrt(np.where(var < f32(1e-8), f32(1e-8), var))
        q = ((short - mean) / sd) / f32(np.sqrt(2.0))
        lik = f32(0.5) * (f32(1) + torch.erf(torch.from_numpy(q)).numpy())
        out.append(np.where(nc >= R + 10, lik, f32(0.5)))
        pos, count = newpos.astype(np.int32), nc.astype(np.int32)
    return (dict(scores=ring, pos=pos, count=count, short_mean=short),
            np.stack(out))


def model_zscore(state: dict, values, P: int, eps: float = 1e-6):
    """numpy model of the `seasonal_zscore` kernel: the median of the k
    lags, each operation rounded as the kernel rounds it, the two sums
    over the ages 1 .. min(t, W) in `order_sum`'s order. Returns (state,
    (T, B) z)."""
    f32 = np.float32
    lag = np.array(state["lag"], np.float32)
    resid = np.array(state["resid"], np.float32)
    t = np.array(state["pos"], np.int32)
    B, L = lag.shape
    W, k, rows, out = resid.shape[1], L // P, np.arange(B), []
    ages = np.arange(1, W + 1)
    for v in np.asarray(values, np.float32):
        idx = (t[:, None] - P * np.arange(1, k + 1)) % L
        med = np.sort(lag[rows[:, None], idx], axis=1)[:, (k - 1) // 2]
        r = np.where(t >= L, v - med, f32(0))
        win = resid[rows[:, None], (t[:, None] - ages) % W]
        live = ages <= np.minimum(t, W)[:, None]
        nf = np.clip(t, 1, W).astype(np.float32)
        mean = order_sum(np.where(live, win, f32(0)), W) / nf
        dv = order_sum(np.where(live, win * win, f32(0)), W) / nf \
            - mean * mean
        var = np.where(dv < f32(eps), f32(eps), dv)
        out.append(np.where(t >= L + W, (r - mean) / np.sqrt(var), f32(0)))
        lag[rows, t % L] = v
        resid[rows, t % W] = r
        t = t + 1
    return dict(lag=lag, resid=resid, pos=t), np.stack(out)


def jax_state(st) -> dict:
    return {k: np.asarray(v) for k, v in st._asdict().items()}


def tree_sum_warp(vals: np.ndarray) -> np.ndarray:
    """The kernels' `tree_sum_warp` (a warp a step, for a short series):
    in each round lane l sums the group of 16 terms l + 32 round as
    `tree_sum` does, and the warp adds the groups up by shuffles: 4 lanes
    a run of 64, 16 lanes a run of 256, a round's two halves and the next
    round's (1,024), four of those (4,096), then those in turn."""
    x = np.asarray(vals, np.float32)
    n = x.shape[-1]
    zero = np.zeros(x.shape[:-1], np.float32)
    rounds = -(-n // 512)
    total, s6, s5 = zero, zero, zero
    for r in range(rounds):
        g = []  # the lanes' groups of 16
        for lane in range(32):
            c = 16 * (lane + 32 * r)
            g.append(_fours(_fours(np.concatenate(
                [x[..., c:min(c + 16, n)],
                 np.zeros(x.shape[:-1] + (16 - max(0, min(16, n - c)),),
                          np.float32)], -1)))[..., 0])
        s3 = [zero + g[4 * (lane // 4)] + g[4 * (lane // 4) + 1]
              + g[4 * (lane // 4) + 2] + g[4 * (lane // 4) + 3]
              for lane in range(32)]
        s4 = [zero + s3[16 * (lane // 16)] + s3[16 * (lane // 16) + 4]
              + s3[16 * (lane // 16) + 8] + s3[16 * (lane // 16) + 12]
              for lane in range(32)]
        if r % 2 == 0:
            s5 = zero
        s5 = s5 + s4[0] + s4[16]
        if r % 2 == 1 or r == rounds - 1:
            if r % 8 < 2:
                s6 = zero
            s6 = s6 + s5
            if r % 8 >= 6 or r == rounds - 1:
                total = total + s6
    return total


@pytest.mark.parametrize("n", [1, 20, 64, 65, 276, 1000, 1024, 4096,
                               5000])
def test_the_warp_sum_of_a_short_series_keeps_the_tree_order(n):
    """A warp a step (the lane path's form for T <= 8) adds a window's runs
    of 64 in `tree_sum`'s order: bit-equal to one thread's `tree_sum`, so
    a T = 1 update equals the same step of a long series."""
    rng = np.random.RandomState(n)
    vals = (rng.uniform(0, 1, (64, n)) * 10.0 ** rng.randint(
        -3, 3, (64, n))).astype(np.float32)
    np.testing.assert_array_equal(tree_sum_warp(vals), tree_sum(vals))


def carried_likelihood(B: int, W: int, seed: int) -> dict:
    """A saturated likelihood state of W regime scores a stream, pos
    mid-ring (the state a long history leaves, without its scan)."""
    rng = np.random.RandomState(seed)
    pos = rng.randint(1, W, B).astype(np.int32)
    return dict(scores=regime_scores(B, W, seed).T.copy(), pos=pos,
                count=np.full(B, W, np.int32),
                short_mean=rng.uniform(0, 0.2, B).astype(np.float32))


# W, R, carried; the last two the largest window of each path: the lane
# path's (kernels.ANOMALY_LANE_WINDOW) and the warp path's largest on the
# card (testing.LIKELIHOOD_CASES "global ring carried")
@pytest.mark.parametrize("W,R,carried", [(75, 0, False), (75, 24, True),
                                         (128, 10, True), (4096, 24, True),
                                         (60_000, 24, True)])
def test_likelihood_kernel_order_meets_the_jax_tolerance(W, R, carried):
    """The `anomaly_likelihood` kernel's summation order (the numpy model)
    keeps L within LIK_TOL of JAX's scan of the update, and the ring, pos,
    count and short_mean bit-equal to JAX's state, before the card runs
    it: W off a multiple of 32, exclude 0, count saturating, from a fresh
    state and from JAX's state carried mid-ring, and each path's order at
    the largest window it takes (a saturated state made directly)."""
    big = W > 1000
    B, T = (3, 64) if big else (6, 200)
    scores = regime_scores(B, T, 30 + W + R)
    jst0 = None
    if carried:
        if big:
            start = carried_likelihood(B, W, 31)
            jst0 = jenc.AnomalyLikelihoodState(
                *(jnp.asarray(start[k]) for k in ("scores", "pos", "count",
                                                  "short_mean")))
        else:
            jst0, _ = jax_likelihoods(regime_scores(B, W + 37, 31), W, 0.7,
                                      R)
            start = jax_state(jst0)
        assert 0 < start["pos"][0] < W and start["count"][0] == W
    else:
        start = {k: np.asarray(v) for k, v in bt.anomaly_likelihood_init(
            W, B, "cpu")._asdict().items()}
    jst, want = jax_likelihoods(scores, W, 0.7, R, jst0)
    got_st, got = model_likelihood(start, scores, 0.7, R)
    for name, arr in jax_state(jst).items():
        np.testing.assert_array_equal(got_st[name], arr, err_msg=name)
    err = np.abs(got - want)
    assert err.max() <= LIK_TOL, (err.max(), np.unravel_index(err.argmax(),
                                                              err.shape))
    assert (got == 0.5).any() != carried and want.max() > 0.99


def seasonal_values(T: int, B: int, P: int, seed: int) -> np.ndarray:
    """(T, B) float32: a sine of period P with noise and drift, a spike
    at step 300 of stream 1 and a level shift from step 330 of stream 2
    (where T reaches them)."""
    rng = np.random.RandomState(seed)
    t = np.arange(T)
    v = (np.sin(2 * np.pi * t / P)[:, None] + rng.normal(0, 0.1, (T, B))
         + np.linspace(0, 0.5 * T / 400, T)[:, None]).astype(np.float32)
    if T > 330:
        v[300, 1] = 1.9
        v[330:, 2] += 0.4
    return v


# P, W, lags, carried; the last two the largest window of each path (the
# warp path's testing.ZSCORE_CASES "global ring carried")
@pytest.mark.parametrize("P,W,lags,carried", [(8, 40, 3, False),
                                              (6, 50, 5, False),
                                              (24, 96, 3, True),
                                              (24, 4096, 3, True),
                                              (24, 58_100, 3, True)])
def test_zscore_kernel_order_meets_the_jax_tolerance(P, W, lags, carried):
    """The `seasonal_zscore` kernel's order (the numpy model) keeps z
    within 2e-6 + 1e-6|z| of JAX's update, and lag, resid and pos
    bit-equal to JAX's state: t crossing L and L + W from a fresh state
    (W off a multiple of 32, 3 and 5 lags), the benchmark's widths from
    JAX's state carried past L + W, and each path's order at the largest
    window it takes (from a state past L + W made directly: lags of the
    same sine, residuals of its noise)."""
    big = W > 1000
    B, T = (3, 64) if big else (5, 200)
    L = lags * P
    jst = jax.vmap(lambda _: jenc.seasonal_zscore_init(P, W, lags))(
        jnp.arange(B))
    step = jax.jit(jax.vmap(
        lambda st, x: jenc.seasonal_zscore_update(st, x, P)))
    if big:
        rng = np.random.RandomState(W)
        pos = L + W + rng.randint(0, 5 * W, B)
        lags_at = pos[:, None] - L + np.arange(L)  # the ring's last L steps
        lag = np.zeros((B, L), np.float32)
        np.put_along_axis(lag, lags_at % L, np.sin(
            2 * np.pi * lags_at / P).astype(np.float32), 1)
        start = dict(lag=lag, pos=pos.astype(np.int32),
                     resid=rng.normal(0, 0.1, (B, W)).astype(np.float32))
        jst = jenc.SeasonalZScoreState(
            *(jnp.asarray(start[k]) for k in ("lag", "resid", "pos")))
        v = seasonal_values(T, B, P, 40 + W)
        v += np.sin(2 * np.pi * pos / P)[None] - v[:1]  # in phase
        v[T // 2, 1] += 1.9
        first = 0
    else:
        v = seasonal_values(400, B, P, 40 + W)
        first = 200 if carried else 0
        for x in jnp.asarray(v[:first]):
            jst, _ = step(jst, x)
        start = jax_state(jst)
    want = []
    for x in jnp.asarray(v[first:first + T]):
        jst, z = step(jst, x)
        want.append(np.asarray(z))
    want = np.stack(want)
    got_st, got = model_zscore(start, v[first:first + T], P)
    for name, arr in jax_state(jst).items():
        np.testing.assert_array_equal(got_st[name], arr, err_msg=name)
    assert np.all(np.abs(got - want) <= z_tol(want)), \
        np.abs(got - want).max()
    assert (want != 0).any() and (carried or (want[:lags * P + W] == 0).all())


# ---- how the kernels rebuild a step's window (csrc/anomaly_pass.cu): a
# numpy model of each path's index arithmetic, which reads only the
# inputs (the series, the carried rings) and the tile in shared memory or
# the warp path's ring in global memory, held equal at every step to the
# ring the plain version keeps step by step


def _ring_slot(s: int, W: int) -> int:
    """The kernel's `s < 0 ? s + W : s` for s in (-W, W)."""
    return s + W if s < 0 else s


def rebuild_likelihood(state: dict, scores: np.ndarray, R: int, m: float,
                       path: str, tile: int, blocks: int = 1):
    """The `anomaly_likelihood` kernel's windows: for each step (a list
    over t) and stream, the scores of ages lo .. count' - 1 in turn (the
    terms of its sums), the step's own score and its short mean as the
    producer warp carries the EMA over the tiles (the warp path's
    ``blocks`` blocks a stream each taking every ``blocks``-th tile of
    ``tile`` steps); and the new ring, pos and count."""
    from bithtm_tpu_torch.ops.regularization import _fma_f32

    ring_in = np.asarray(state["scores"], np.float32)
    B, W = ring_in.shape
    T, lo = len(scores), max(R, 0)
    wins = [[None] * B for _ in range(T)]
    out = np.zeros_like(ring_in)
    pos_out = np.zeros(B, np.int32)
    count_out = np.zeros(B, np.int32)

    def ema(sm, s, t, count0):
        prev = sm if count0 > -t else s
        return _fma_f32(torch.tensor([s]), 1.0 - m, torch.tensor(
            [np.float32(m) * prev])).numpy()[0]

    for b in range(B):
        pos0, count0 = int(state["pos"][b]) % W, int(state["count"][b])

        def carried(u):
            return ring_in[b, _ring_slot(pos0 + u, W)]

        def score(u):
            return scores[u, b] if u >= 0 else carried(u)

        def count_after(t):
            return W if count0 >= W - t - 1 else count0 + t + 1

        last = pos0 + T - 1
        if path == "lane":
            sm, first = np.float32(state["short_mean"][b]), 0
            for t0 in range(0, T, tile):
                first = t0 - W + 1
                H = W - 1 + tile
                split = min(H, max(-first, 0))
                vals = np.array([scores[first + h, b] if split <= h and
                                 first + h < T else 0.0 for h in range(H)],
                                np.float32)
                for j in range(W):  # the carried ring in slot order
                    u = j - pos0 if j - pos0 < 0 else j - pos0 - W
                    if 0 <= u - first < split:
                        vals[u - first] = ring_in[b, j]
                for i in range(min(tile, T - t0)):
                    t = t0 + i
                    sm = ema(sm, vals[W - 1 + i], t, count0)
                    n = max(count_after(t) - lo, 0)
                    wins[t][b] = (np.array([vals[t - first - lo - k]
                                            for k in range(n)], np.float32),
                                  vals[W - 1 + i], sm)
            for j in range(W):
                u = T - 1 - (last - j) % W
                out[b, j] = vals[u - first] if T > 0 else score(u)
        else:
            for g in range(blocks):
                sm, at = np.float32(state["short_mean"][b]), 0
                for t0 in range(g * tile, T, blocks * tile):
                    for t in range(at, t0 + min(tile, T - t0)):
                        sm = ema(sm, scores[t, b], t, count0)
                        if t < t0:
                            continue
                        n = max(count_after(t) - lo, 0)
                        win = [None] * n
                        for lane in range(min(n, 32)):
                            ul = t - lo - lane
                            for q in range((n - lane + 31) // 32):
                                win[lane + 32 * q] = score(ul - 32 * q)
                        wins[t][b] = (np.array(win, np.float32),
                                      scores[t, b], sm)
                    at = t0 + min(tile, T - t0)
            for j in range(W):
                out[b, j] = score(T - 1 - (last - j) % W)
        pos_out[b] = (pos0 + T) % W if T > 0 else state["pos"][b]
        count_out[b] = count0 if T == 0 else count_after(T - 1)
    return wins, dict(scores=out, pos=pos_out, count=count_out)


def rebuild_zscore(state: dict, values: np.ndarray, P: int, path: str,
                   tile: int, blocks: int = 1):
    """The `seasonal_zscore` kernel's windows: for each step and stream,
    the residuals of ages 1 .. min(t, W) in turn and the step's own
    residual (the lane path from its tiles' residuals in shared memory,
    the warp path's ``blocks`` blocks each from the inputs); and the new
    lag ring, residual ring and pos."""
    lag_in = np.asarray(state["lag"], np.float32)
    resid_in = np.asarray(state["resid"], np.float32)
    B, L = lag_in.shape
    W, T, k = resid_in.shape[1], len(values), L // P
    wins = [[None] * B for _ in range(T)]
    lag_out, resid_out = np.zeros_like(lag_in), np.zeros_like(resid_in)
    pos_out = np.zeros(B, np.int32)
    for b in range(B):
        tau0 = int(state["pos"][b])
        end = tau0 + T

        def value(s):
            return values[s - tau0, b] if s >= tau0 else lag_in[b, s % L]

        def carried(s):
            return resid_in[b, s % W]

        def fresh(s):
            if s < L:
                return np.float32(0)
            lags = np.sort([value(s - a * P) for a in range(1, k + 1)])
            return np.float32(value(s) - lags[(k - 1) // 2])

        def res(s):
            return carried(s) if s < tau0 else fresh(s)

        for j in range(L):
            lag_out[b, j] = value(end - 1 - (end - 1 - j) % L)
        if path == "lane":
            first = 0
            for t0 in range(0, T, tile):
                start = tau0 + t0
                first = start - W
                vals = np.zeros(W + tile, np.float32)
                for h in range(W + tile):
                    s = first + h
                    if h < W and s < tau0:
                        vals[h] = carried(s)
                    elif tau0 <= s < end:
                        vals[h] = fresh(s)
                for i in range(min(tile, T - t0)):
                    t = start + i
                    live = W if t >= W else max(t, 0)
                    wins[t0 + i][b] = (
                        np.array([vals[t - 1 - first - q]
                                  for q in range(live)], np.float32),
                        vals[t - first])
            for j in range(W):
                s = end - 1 - (end - 1 - j) % W
                resid_out[b, j] = vals[s - first] if T > 0 else res(s)
        else:
            for g in range(blocks):
                for t0 in range(g * tile, T, blocks * tile):
                    for w in range(min(tile, T - t0)):
                        t = tau0 + t0 + w
                        live = W if t >= W else max(t, 0)
                        win = [None] * live
                        for lane in range(min(live, 32)):
                            ul = t - 1 - lane
                            for q in range((live - lane + 31) // 32):
                                win[lane + 32 * q] = res(ul - 32 * q)
                        wins[t0 + w][b] = (np.array(win, np.float32),
                                           res(t))
            for j in range(W):
                resid_out[b, j] = res(end - 1 - (end - 1 - j) % W)
        pos_out[b] = end
    return wins, dict(lag=lag_out, resid=resid_out, pos=pos_out)


# path, W, R, T, the tile (the lane path's threads on the steps, or the
# warp path's warps), the warp path's blocks a stream, the start: None
# fresh, else (pos, count) a stream of a carried ring (one saturating,
# one crossing the gate R + 10)
LIK_REBUILDS = {
    "lane, mid-ring, count saturating, tile < W, T off the tile": (
        "lane", 75, 24, 100, 32, 1, ((40, 72), (3, 30), (74, 75))),
    "lane, exclude 0, fresh": ("lane", 40, 0, 70, 64, 1, None),
    "lane, W < 32": ("lane", 20, 5, 50, 32, 1, ((7, 18), (19, 12), (0, 20))),
    "lane, a warp a step (T <= 8), tiles of 4": (
        "lane", 75, 24, 7, 4, 1, ((40, 72), (3, 30), (74, 75))),
    "warp, mid-ring, count saturating, 3 blocks": (
        "warp", 75, 24, 37, 4, 3, ((40, 72), (3, 30), (74, 75))),
    "warp, exclude 0, fresh, W < 32": ("warp", 20, 0, 45, 16, 1, None),
    "warp, W off 32, a block a step": (
        "warp", 40, 10, 50, 1, 50, ((39, 38), (5, 19), (0, 40))),
}


@pytest.mark.parametrize("case", list(LIK_REBUILDS))
def test_likelihood_kernel_rebuilds_each_window_from_its_inputs(case):
    """Each path's index arithmetic (the numpy model `rebuild_likelihood`)
    gives every step the very scores, in age order, that the plain
    version's ring holds at ages lo .. count' - 1 after that step writes,
    the EMA the step's own score and the plain version's short mean
    however the tiles fall over the blocks; and the new state the plain
    version's: a carried mid-ring start, count saturating and crossing
    the warm-up gate, exclude 0, W off a multiple of 32 and below it, T
    not a multiple of the tile, a tile shorter than W."""
    from bithtm_tpu_torch.encoders import _likelihood_step

    path, W, R, T, tile, blocks, start = LIK_REBUILDS[case]
    B, lo = 3, max(R, 0)
    scores = (regime_scores(B, T, W + T) if T > 40 else np.random.RandomState(
        T).randint(0, 17, (T, B)).astype(np.float32) / np.float32(16))
    st = bt.anomaly_likelihood_init(W, B, "cpu")
    if start is not None:
        pos, count = (np.array(c, np.int32) for c in zip(*start))
        ring = np.random.RandomState(W).randint(0, 17, (B, W)) / 16
        st = st._replace(scores=cpu(ring.astype(np.float32)),
                         pos=cpu(pos), count=cpu(count))
    state = {k: v.numpy() for k, v in st._asdict().items()}
    wins, got = rebuild_likelihood(state, scores, R, 0.7, path, tile,
                                   blocks)
    for t in range(T):
        st, _ = _likelihood_step(st, cpu(scores[t]), 0.7, R)
        ring, p, c, sm = (x.numpy() for x in (st.scores, st.pos, st.count,
                                              st.short_mean))
        for b in range(B):
            ages = np.arange(lo, c[b])
            want = ring[b, (p[b] - 1 - ages) % W]
            win, own, short = wins[t][b]
            np.testing.assert_array_equal(win, want, err_msg=f"{t} {b}")
            assert own == scores[t, b] and short == sm[b], (t, b)
    for name in ("scores", "pos", "count"):
        np.testing.assert_array_equal(got[name], getattr(st, name).numpy(),
                                      err_msg=name)


# path, P, W, lags, T, the tile, the warp path's blocks a stream, the
# start: None fresh, else each stream's pos (one crossing L, one crossing
# L + W, one past both)
Z_REBUILDS = {
    "lane, fresh, t crossing L and L + W, W < 32": (
        "lane", 4, 20, 3, 100, 32, 1, None),
    "lane, carried, 5 lags, tile < W, T off the tile": (
        "lane", 6, 50, 5, 90, 32, 1, (27, 75, 300)),
    "lane, W off 32, carried": ("lane", 12, 75, 3, 70, 64, 1,
                                (33, 109, 500)),
    "lane, a warp a step (T <= 8), tiles of 4": (
        "lane", 6, 50, 5, 7, 4, 1, (27, 75, 300)),
    "warp, fresh, 3 blocks": ("warp", 4, 20, 3, 45, 4, 3, None),
    "warp, carried, 5 lags": ("warp", 6, 50, 5, 37, 16, 1, (27, 75, 300)),
}


@pytest.mark.parametrize("case", list(Z_REBUILDS))
def test_zscore_kernel_rebuilds_each_window_from_its_inputs(case):
    """Each path's index arithmetic (the numpy model `rebuild_zscore`:
    every residual from the series and its lags, or the carried rings)
    gives every step the residuals, in age order, that the plain
    version's ring holds at ages 1 .. min(t, W) before that step writes,
    and the residual the step writes; and the new state the plain
    version's: t crossing L and L + W, 3 and 5 lags, a carried start, W
    off a multiple of 32 and below it, T not a multiple of the tile, a
    tile shorter than W."""
    from bithtm_tpu_torch.encoders import _zscore_step

    path, P, W, lags, T, tile, blocks, start = Z_REBUILDS[case]
    B, L = 3, lags * P
    values = seasonal_values(T, B, P, W + T)
    st = bt.seasonal_zscore_init(P, W, lags, B, "cpu")
    if start is not None:
        rng = np.random.RandomState(W)
        st = st._replace(
            lag=cpu(rng.normal(0, 1, (B, L)).astype(np.float32)),
            resid=cpu(rng.normal(0, 0.3, (B, W)).astype(np.float32)),
            pos=cpu(np.array(start, np.int32)))
    state = {k: v.numpy() for k, v in st._asdict().items()}
    wins, got = rebuild_zscore(state, values, P, path, tile, blocks)
    for t in range(T):
        pos = st.pos.numpy()
        ring = st.resid.numpy()
        st, _ = _zscore_step(st, cpu(values[t]), P, 1e-6)
        for b in range(B):
            ages = np.arange(1, min(max(pos[b], 0), W) + 1)
            win, own = wins[t][b]
            np.testing.assert_array_equal(win, ring[b, (pos[b] - ages) % W],
                                          err_msg=f"{t} {b}")
            assert own == st.resid.numpy()[b, pos[b] % W]
    for name in ("lag", "resid", "pos"):
        np.testing.assert_array_equal(got[name], getattr(st, name).numpy(),
                                      err_msg=name)
