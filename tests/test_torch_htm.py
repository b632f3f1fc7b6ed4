"""Parity of the PyTorch port's SP, TM and HTM scan with the JAX package.

Both packages start from the same state (a JAX state converted with
`bithtm_tpu_torch.convert`) and take the same inputs, made with numpy
from a seed. The port's random draws are replayed from the JAX keys
(`ReplayDraws`), following the JAX split structure: `key, sub =
split(key)` per HTM step (htm.py:101), `k_select, k_grow = split(sub)`
(temporal_memory.py:793), `k_seg, k_least = split(k_select)` (:120).

Contract: every state leaf, output and metric bit-equal, except the
SP's boost: `torch.exp` and XLA's `exp` round differently, so the boost
factor may differ by 1 ulp, and the boosted overlap (factor times an
integer overlap, rounded again) by 2 ulp. Every compared step first
checks, on the JAX boosted values, that no near-tie sits at the top-k
boundary, so a seed whose active set would depend on those ulps fails
loudly.
"""

import functools
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bithtm_tpu import htm_init_batch as jax_htm_init_batch
from bithtm_tpu import htm_scan as jax_htm_scan
from bithtm_tpu import make_htm_config as jax_make_htm_config
from bithtm_tpu.models.spatial_pooler import sp_step as jax_sp_step
from bithtm_tpu.models.temporal_memory import tm_step as jax_tm_step
from bithtm_tpu.ops.regularization import boost_factor as jax_boost_factor

import bithtm_tpu_torch as bt
from bithtm_tpu_torch.convert import htm_state_from_numpy, htm_state_to_numpy
from bithtm_tpu_torch.models.spatial_pooler import sp_step
from bithtm_tpu_torch.models.temporal_memory import tm_step
from bithtm_tpu_torch.ops.regularization import boost_factor
from bithtm_tpu_torch.rng import Draws

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SMALL = dict(input_dim=64, column_dim=64, cell_dim=4, active_columns=4,
             segment_activation_threshold=2, segment_matching_threshold=2,
             segment_sampling_synapses=8)


def make_configs(**kw):
    return jax_make_htm_config(**kw), bt.make_htm_config(**kw)


@functools.partial(jax.jit, static_argnums=(0,))
def _replay(tm_cfg, subkeys):
    A, D = tm_cfg.active_columns, tm_cfg.cell_dim
    G = tm_cfg.segments_per_column
    L, Wc = tm_cfg.resolved_growth_capacity, tm_cfg.resolved_winner_capacity

    def one(sub):
        k_select, k_grow = jax.random.split(sub)
        k_seg, k_least = jax.random.split(k_select)
        return (jax.random.uniform(k_seg, (A, G), jnp.float32),
                jax.random.uniform(k_least, (A, D), jnp.float32),
                jax.random.bits(k_grow, (L, Wc), jnp.uint32))

    return jax.vmap(one)(subkeys)


def draws_from_subkeys(tm_cfg, subkeys) -> Draws:
    """The draws JAX `tm_step` makes from its (B,) per-stream keys."""
    u_seg, u_least, rnd = (np.array(x) for x in _replay(tm_cfg, subkeys))
    return Draws(torch.from_numpy(u_seg), torch.from_numpy(u_least),
                 torch.from_numpy(rnd.view(np.int32)))


class ReplayDraws:
    """Draw provider that recomputes the JAX draws of `htm_step` from a
    batched JAX key, advancing it once per step as `htm_step` does."""

    def __init__(self, tm_cfg, keys):
        self.tm_cfg = tm_cfg
        self.keys = keys

    def with_config(self, tm_cfg):
        """The same key stream drawing at ``tm_cfg``'s list widths, as
        the JAX step draws at the config in force."""
        return ReplayDraws(tm_cfg, self.keys)

    def get_state(self):
        return self.keys

    def set_state(self, keys):
        self.keys = keys

    def step(self, need: bool = True):
        pair = jax.vmap(jax.random.split)(self.keys)
        self.keys, sub = pair[:, 0], pair[:, 1]
        return draws_from_subkeys(self.tm_cfg, sub) if need else None


def copy_keys(keys):
    return jax.random.wrap_key_data(jnp.array(jax.random.key_data(keys)))


def assert_no_near_tie(boosted, overlaps, duty, k, step):
    """At the top-k boundary of each stream, the k-th and (k+1)-th
    boosted values (JAX) must differ by more than 4 ulp (each may move
    by 2 in the port), unless every
    value within 4 ulp of them is computed exactly alike by both
    libraries (same overlap and duty, or no `exp` rounding at all:
    overlap 0 or duty 0)."""
    for b in range(boosted.shape[0]):
        v = boosted[b]
        order = np.lexsort((np.arange(v.size), -v))
        hi, lo = v[order[k - 1]], v[order[k]]
        ulp = np.spacing(np.float32(max(abs(hi), abs(lo))))
        if hi - lo > 4 * ulp:
            continue
        band = np.nonzero((v >= lo - 4 * ulp) & (v <= hi + 4 * ulp))[0]
        keys = {("exact", float(v[i])) if overlaps[b, i] == 0
                or duty[b, i] == 0 else (int(overlaps[b, i]),
                                         float(duty[b, i]))
                for i in band}
        assert len(keys) == 1, (
            f"step {step} stream {b}: near-tie at the top-k boundary "
            f"({hi!r} vs {lo!r}); pick another seed")


def assert_tree_equal(jax_tree, port_tree, what):
    for part in ("sp", "tm"):
        for name, got in port_tree[part].items():
            want = np.asarray(getattr(getattr(jax_tree, part), name))
            np.testing.assert_array_equal(
                got, want, err_msg=f"{what}: {part}.{name}")
            assert got.dtype == want.dtype, (part, name)


def assert_metrics_equal(jax_metrics, port_metrics, what):
    assert set(jax_metrics) == set(port_metrics), what
    for k, v in jax_metrics.items():
        np.testing.assert_array_equal(port_metrics[k].numpy(),
                                      np.asarray(v), err_msg=f"{what}: {k}")


# ---- SP --------------------------------------------------------------


_jax_boost_factor = jax.jit(jax_boost_factor, static_argnums=(1, 2))


@functools.partial(jax.jit, static_argnums=(0, 3))
def _jax_sp_batch(cfg, state, x, learning):
    return jax.vmap(lambda s, xi: jax_sp_step(cfg, s, xi, learning))(
        state, x)


@pytest.mark.parametrize("dtype", ["float32", "int16"])
def test_sp_step_matches_jax(dtype):
    """Overlaps, permanences, connected words and duty cycles
    bit-equal; boost factors within 1 ulp and boosted overlaps within
    2; active sets equal."""
    jcfg, pcfg = make_configs(input_dim=200, column_dim=96, cell_dim=4,
                              active_columns=7,
                              sp_overrides={"permanence_dtype": dtype})
    B = 3
    jfull = jax_htm_init_batch(jax.random.key(5), jcfg, B)
    jstate, pstate = jfull.sp, htm_state_from_numpy(jfull, "cpu").sp
    rng = np.random.RandomState(3)
    for t in range(25):
        x = rng.rand(B, 200) < 0.2
        learning = t % 4 != 3
        duty = np.array(jstate.duty_cycle)
        jstate, jout = _jax_sp_batch(jcfg.sp, jstate, jnp.asarray(x),
                                     learning)
        pstate, pout = sp_step(pcfg.sp, pstate, torch.from_numpy(x),
                               learning)
        jb = np.asarray(jout.boosted_overlaps)
        assert_no_near_tie(jb, np.asarray(jout.overlaps), duty, 7, t)
        np.testing.assert_array_equal(pout.overlaps.numpy(),
                                      np.asarray(jout.overlaps))
        c = pcfg.sp
        np.testing.assert_array_max_ulp(
            boost_factor(torch.from_numpy(duty), c.boosting_intensity,
                         c.density).numpy(),
            np.asarray(_jax_boost_factor(duty, c.boosting_intensity,
                                         c.density)), maxulp=1)
        np.testing.assert_array_max_ulp(pout.boosted_overlaps.numpy(), jb,
                                        maxulp=2)
        np.testing.assert_array_equal(pout.active_columns.numpy(),
                                      np.asarray(jout.active_columns))
        np.testing.assert_array_equal(pout.active_mask.numpy(),
                                      np.asarray(jout.active_mask))
        for name in ("permanence", "connected", "duty_cycle"):
            np.testing.assert_array_equal(
                getattr(pstate, name).numpy(),
                np.asarray(getattr(jstate, name)), err_msg=name)


# ---- TM --------------------------------------------------------------


@functools.partial(jax.jit, static_argnums=(0, 4, 5))
def _jax_tm_batch(cfg, state, keys, cols, learning, compute_winner):
    return jax.vmap(lambda s, k, c: jax_tm_step(
        cfg, s, k, c, learning, compute_winner))(state, keys, cols)


TM_OUTPUTS = ("active_mask", "winner_mask", "prediction", "prev_prediction",
              "prev_col_prediction", "bursting_columns")


@pytest.mark.parametrize("policy,punishment", [
    ("evict", 0.01), ("reference", 0.01), ("evict", 0.12)])
def test_tm_step_matches_jax(policy, punishment):
    """Learning under both allocation policies, then inference with and
    without winner cells: every TM state leaf, output and metric
    bit-equal at every step. Two segment slots per column and column
    sets drawn from 12 columns put the pool under pressure, so the
    eviction (or drop) branch runs; a strong punishment kills synapses
    in inactive columns, leaving stale targets that learning cleans."""
    jcfg, pcfg = make_configs(**SMALL, segments_per_column=2,
                              allocation_policy=policy,
                              permanence_punishment=punishment)
    B, A = 3, 4
    jfull = jax_htm_init_batch(jax.random.key(1), jcfg, B)
    pfull = htm_state_from_numpy(jfull, "cpu")
    jtm, ptm = jfull.tm, pfull.tm
    rng = np.random.RandomState(0)
    colsets = np.stack([rng.choice(12, A, replace=False) for _ in range(10)])
    phases = [(True, True)] * 40 + [(False, True)] * 5 + [(False, False)] * 5
    totals = {}
    for t, (learning, compute_winner) in enumerate(phases):
        cols = np.stack([rng.permutation(colsets[(t + 3 * b) % 10])
                         for b in range(B)]).astype(np.int32)
        keys = jax.random.split(jax.random.key(100 + t), B)
        jtm, jout = _jax_tm_batch(jcfg.tm, jtm, keys, jnp.asarray(cols),
                                  learning, compute_winner)
        ptm, pout = tm_step(pcfg.tm, ptm,
                            draws_from_subkeys(pcfg.tm, keys),
                            torch.from_numpy(cols), learning,
                            compute_winner)
        what = f"step {t}"
        got = htm_state_to_numpy(bt.HTMState(sp=pfull.sp, tm=ptm))["tm"]
        for name, arr in got.items():
            np.testing.assert_array_equal(
                arr, np.asarray(getattr(jtm, name)), err_msg=f"{what}: {name}")
        for name in TM_OUTPUTS:
            np.testing.assert_array_equal(
                getattr(pout, name).numpy(), np.asarray(getattr(jout, name)),
                err_msg=f"{what}: {name}")
        assert_metrics_equal(jout.metrics, pout.metrics, what)
        for k, v in pout.metrics.items():
            totals[k] = totals.get(k, 0) + int(v.sum())
        totals["stale"] = totals.get("stale", 0) + int(
            ((got["synapse_cell"] >= 0) & (got["synapse_perm"] < 0)).sum())
    assert totals["tm_grown_synapses"] > 0
    pressure = ("tm_evicted_segments" if policy == "evict"
                else "tm_dropped_new_segments")
    assert totals[pressure] > 0, totals
    if punishment > 0.1:
        assert totals["stale"] > 0, totals


# ---- the slice as a whole --------------------------------------------


def _assert_sp_trajectory_untied(jcfg, sp_state, x, n_learn):
    """The near-tie check of the SP steps `htm_scan` will take."""
    for t in range(x.shape[0]):
        duty = np.asarray(sp_state.duty_cycle)
        sp_state, out = _jax_sp_batch(jcfg.sp, sp_state, jnp.asarray(x[t]),
                                      t < n_learn)
        assert_no_near_tie(np.asarray(out.boosted_overlaps),
                           np.asarray(out.overlaps), duty,
                           jcfg.sp.active_columns, t)


@pytest.mark.parametrize("variant", ["default", "fast_stack"])
def test_htm_scan_matches_jax(variant):
    """JAX `htm_scan` against the port's `htm_scan`: 30 learning steps,
    then 6 inference steps, three streams; every state leaf and every
    metric bit-equal. ``fast_stack`` is the bench's G=4, K=64 table with
    int16 SP permanences, at the small widths."""
    kw = dict(SMALL)
    if variant == "fast_stack":
        kw.update(segments_per_column=4, synapse_capacity=64,
                  sp_overrides={"permanence_dtype": "int16"})
    jcfg, pcfg = make_configs(**kw)
    B, n_learn, n_inf = 3, 30, 6
    rng = np.random.RandomState(11)
    pats = rng.rand(5, 64) < 0.2
    t = np.arange(n_learn + n_inf)
    x = pats[(t[:, None] + np.arange(B)[None, :]) % 5]         # (T, B, I)

    jstate = jax_htm_init_batch(jax.random.key(2), jcfg, B)
    pstate = htm_state_from_numpy(jstate, "cpu")
    draws = ReplayDraws(pcfg.tm, copy_keys(jstate.key))
    _assert_sp_trajectory_untied(jcfg, jstate.sp, x, n_learn)

    jstate, jm_learn = jax_htm_scan(jcfg, jstate, jnp.asarray(x[:n_learn]),
                                    True, 1)
    jstate, jm_inf = jax_htm_scan(jcfg, jstate, jnp.asarray(x[n_learn:]),
                                  False, 1)
    pstate, pm_learn = bt.htm_scan(pcfg, pstate,
                                   torch.from_numpy(x[:n_learn]), True,
                                   draws=draws)
    pstate, pm_inf = bt.htm_scan(pcfg, pstate,
                                 torch.from_numpy(x[n_learn:]), False,
                                 draws=draws)
    assert_metrics_equal(jm_learn, pm_learn, "learning")
    assert_metrics_equal(jm_inf, pm_inf, "inference")
    assert_tree_equal(jstate, htm_state_to_numpy(pstate), "final state")
    assert pm_inf["correct"].sum() > 0  # the graph learned something


def test_port_learns_with_torch_generator():
    """The drive recipe on the port alone, with production draws from a
    `torch.Generator`: bursting falls and correct predictions rise."""
    cfg = bt.make_htm_config(**SMALL)
    gen = torch.Generator().manual_seed(0)
    state = bt.htm_init_batch(cfg, 4, gen, "cpu")
    pats = torch.from_numpy(np.random.RandomState(0).rand(5, 64) < 0.2)
    x = pats[torch.arange(60) % 5][:, None, :].expand(60, 4, 64)
    state, m = bt.htm_scan(cfg, state, x, True,
                           draws=bt.TorchDraws(cfg.tm, 4, "cpu", gen))
    first, last = slice(0, 5), slice(55, 60)
    assert m["bursting"][last].float().mean() < m["bursting"][first].float(
    ).mean()
    assert m["correct"][last].float().mean() > m["correct"][first].float(
    ).mean()


def test_port_imports_without_jax():
    """The port imports with `jax` and `bithtm_tpu` blocked: the package,
    its kernels, the wrappers, the oracle, the utilities, the CLI, the
    encoders, the readout, the stack, the example scripts and the
    parallel package."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['bithtm_tpu'] = None\n"
        "import bithtm_tpu_torch, bithtm_tpu_torch.ops.kernels\n"
        "import bithtm_tpu_torch.networks, bithtm_tpu_torch.oracle\n"
        "import bithtm_tpu_torch.host_hooks, bithtm_tpu_torch.example\n"
        "import bithtm_tpu_torch.utils.checks\n"
        "import bithtm_tpu_torch.utils.checkpoint\n"
        "import bithtm_tpu_torch.utils.metrics_log\n"
        "import bithtm_tpu_torch.encoders, bithtm_tpu_torch.readout\n"
        "import bithtm_tpu_torch.models.stack\n"
        "import bithtm_tpu_torch.utils.data\n"
        "import bithtm_tpu_torch.utils.profiling\n"
        "import bithtm_tpu_torch.examples\n"
        "import bithtm_tpu_torch.examples.anomaly_detection\n"
        "import bithtm_tpu_torch.examples.anomaly_benchmark\n"
        "import bithtm_tpu_torch.examples.sequence_prediction\n"
        "import bithtm_tpu_torch.parallel.mesh\n"
        "import bithtm_tpu_torch.parallel.distributed\n"
        "bad = [m for m, v in sys.modules.items() if v is not None and\n"
        "       (m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'bithtm_tpu'))]\n"
        "assert not bad, bad\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_port_exports_every_jax_name_but_htm_step_batch():
    """`bithtm_tpu_torch.__all__` holds every name of `bithtm_tpu.__all__`,
    `htm_step_batch` too (`htm_step` under the JAX name: the port's step
    is batched), and besides them exactly the port's own names: the draw
    providers (the JAX state holds a key), the converters, and what the
    JAX package exports from its submodules only. Each resolves."""
    import bithtm_tpu

    port_only = {
        "AnomalyLikelihoodState", "CAP_DROP_METRICS", "Draws",
        "SeasonalZScoreState", "ServingTable", "TMDebug", "TorchDraws",
        "concat", "htm_state_from_numpy", "htm_state_to_numpy",
        "make_serving_table", "pack_frozen_table",
        "serving_table_from_numpy", "serving_table_to_numpy",
        "stack_draws", "take_small_table"}
    assert set(bithtm_tpu.__all__) | port_only == set(bt.__all__)
    assert not set(bithtm_tpu.__all__) & port_only
    for name in bt.__all__:
        assert getattr(bt, name) is not None, name
