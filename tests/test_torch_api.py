"""The port's single-stream reference API against the JAX package: the
`networks` wrappers, the component hooks, `HostTemporalMemory`, the
per-segment observables and the dense decoders, and the SP cases of
`tests/test_sp.py`.

The wrappers start from the JAX wrapper's state (converted) and replay
its draws (`ReplayDraws` of `tests/test_torch_htm.py`), so every state
leaf, output and metric must be equal, except the boost: fault g's rule
(the factor within 1 ulp of XLA's `exp`, the boosted overlap within 2,
no near-tie at the top-k boundary).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bithtm_tpu as jb
from bithtm_tpu import networks as jnet
from bithtm_tpu.models import temporal_memory as jtm
from bithtm_tpu.ops import active_set as jas

import bithtm_tpu_torch as bt
from bithtm_tpu_torch import networks as pnet
from bithtm_tpu_torch.convert import U32_LEAVES, htm_state_from_numpy
from bithtm_tpu_torch.ops import active_set as pas
from bithtm_tpu_torch.ops.overlap import unpack_connected
from bithtm_tpu_torch.ops.regularization import k_winners
from bithtm_tpu_torch.state import sp_init

from .test_torch_htm import ReplayDraws, assert_no_near_tie, copy_keys

SMALL = dict(active_columns=4, segment_activation_threshold=2,
             segment_matching_threshold=2, segment_sampling_synapses=8)


def T(x):
    return torch.from_numpy(np.array(x))


def leaves_to_torch(jax_part, cls):
    """A JAX single-stream SPState/TMState -> the port's, batch of one."""
    out = {}
    for f in dataclasses.fields(cls):
        a = np.asarray(getattr(jax_part, f.name))
        if f.name in U32_LEAVES:
            a = a.view(np.int32)
        out[f.name] = torch.from_numpy(np.array(a)[None])
    return cls(**out)


def batched_key(key):
    return copy_keys(key[None])


def assert_leaves_equal(jax_part, port_part, what):
    for f in dataclasses.fields(port_part):
        got = getattr(port_part, f.name)[0].numpy()
        want = np.asarray(getattr(jax_part, f.name))
        if f.name in U32_LEAVES:
            want = want.view(np.int32)
        np.testing.assert_array_equal(got, want, err_msg=f"{what}: {f.name}")


def assert_sp_out_equal(jout, pout, duty, k, what):
    """Overlaps, active columns and mask equal; boosted values within
    fault g's 2 ulp, with no near-tie at the boundary."""
    jb_ = np.asarray(jout.boosted_overlaps)
    assert_no_near_tie(jb_[None], np.asarray(jout.overlaps)[None],
                       np.asarray(duty)[None], k, what)
    np.testing.assert_array_equal(pout.overlaps.numpy(),
                                  np.asarray(jout.overlaps), err_msg=what)
    np.testing.assert_array_max_ulp(pout.boosted_overlaps.numpy(), jb_,
                                    maxulp=2)
    np.testing.assert_array_equal(pout.active_columns.numpy(),
                                  np.asarray(jout.active_columns),
                                  err_msg=what)
    np.testing.assert_array_equal(pout.active_mask.numpy(),
                                  np.asarray(jout.active_mask), err_msg=what)


TM_OUTPUTS = ("active_mask", "winner_mask", "prediction", "prev_prediction",
              "prev_col_prediction", "bursting_columns")


def assert_tm_out_equal(jout, pout, what):
    for name in TM_OUTPUTS:
        np.testing.assert_array_equal(getattr(pout, name).numpy(),
                                      np.asarray(getattr(jout, name)),
                                      err_msg=f"{what}: {name}")
    assert set(pout.metrics) == set(jout.metrics), what
    for k, v in jout.metrics.items():
        np.testing.assert_array_equal(pout.metrics[k].numpy(), np.asarray(v),
                                      err_msg=f"{what}: {k}")


# ---- the wrappers against bithtm_tpu.networks -------------------------


# 14 learning steps, then inference with and without winner cells
PHASES = [(True, True)] * 14 + [(False, True)] * 3 + [(False, False)] * 3


@pytest.mark.parametrize("stack", ["reference", "fast"])
def test_htm_wrapper_matches_jax(stack):
    """`HierarchicalTemporalMemory` from the JAX wrapper's state and
    draws: every state leaf, output and `last_metrics` value equal over
    20 steps, learning and inference."""
    kw = dict(SMALL)
    if stack == "fast":
        kw.update(segments_per_column=4, synapse_capacity=64,
                  sp_overrides={"permanence_dtype": "int16"})
    ref = jnet.HierarchicalTemporalMemory(64, 64, 4, seed=3, **kw)
    port = pnet.HierarchicalTemporalMemory(64, 64, 4, seed=3, device="cpu",
                                           **kw)
    port.state = htm_state_from_numpy(ref.state, "cpu")
    port.draws = ReplayDraws(port.config.tm, batched_key(ref.state.key))
    pats = np.random.RandomState(7).rand(5, 64) < 0.2
    for t, (learning, winner) in enumerate(PHASES):
        x = pats[t % 5]
        duty = np.asarray(ref.state.sp.duty_cycle)
        jsp, jtm_out = ref.process(x, learning, winner)
        psp, ptm_out = port.process(x, learning, winner)
        what = f"step {t}"
        assert_sp_out_equal(jsp, psp, duty, ref.active_columns, what)
        assert_tm_out_equal(jtm_out, ptm_out, what)
        assert_leaves_equal(ref.state.sp, port.state.sp, what)
        assert_leaves_equal(ref.state.tm, port.state.tm, what)
        assert set(port.last_metrics) == set(ref.last_metrics)
        for k, v in ref.last_metrics.items():
            got = port.last_metrics[k]
            assert type(got) is (float if np.asarray(v).dtype.kind == "f"
                                 else int), k
            assert got == v.item(), (what, k)
    assert sum(port.last_metrics[k] for k in ("correct", "bursting")) > 0


def test_sp_and_tm_wrappers_match_jax():
    """`SpatialPooler` and `TemporalMemory` from the JAX wrappers'
    states and draws, the TM with a per-call epsilon on some steps."""
    jsp = jnet.SpatialPooler(64, 64, 4, seed=1)
    psp = pnet.SpatialPooler(64, 64, 4, seed=1, device="cpu")
    psp.state = leaves_to_torch(jsp.state, bt.SPState)
    jtmw = jnet.TemporalMemory(64, 4, **SMALL, seed=2)
    ptmw = pnet.TemporalMemory(64, 4, **SMALL, seed=2, device="cpu")
    ptmw.state = leaves_to_torch(jtmw.state, bt.TMState)
    ptmw.draws = ReplayDraws(ptmw.config, batched_key(jtmw.key))
    pats = np.random.RandomState(2).rand(5, 64) < 0.2
    for t in range(20):
        x = pats[t % 5]
        learning = t < 15
        duty = np.asarray(jsp.state.duty_cycle)
        jo, po = jsp.process(x, learning), psp.process(x, learning)
        assert_sp_out_equal(jo, po, duty, 4, f"step {t}")
        assert_leaves_equal(jsp.state, psp.state, f"SP step {t}")
        eps = 1e-6 if t % 3 == 0 else None
        jt = jtmw.process(jo, learning, epsilon=eps)
        pt = ptmw.process(po, learning, epsilon=eps)
        assert_tm_out_equal(jt, pt, f"step {t}")
        assert_leaves_equal(jtmw.state, ptmw.state, f"TM step {t}")


def test_wrapper_owns_its_state():
    """Assigning a state stores a copy: the caller's tensors do not
    change when the wrapper learns."""
    a = pnet.HierarchicalTemporalMemory(64, 64, 4, device="cpu", **SMALL)
    b = pnet.HierarchicalTemporalMemory(64, 64, 4, device="cpu", **SMALL)
    b.state = a.state
    before = a.state.tm.synapse_cell.clone()
    x = np.random.RandomState(0).rand(64) < 0.2
    for _ in range(3):
        b.process(x)
    assert torch.equal(a.state.tm.synapse_cell, before)
    assert not torch.equal(b.state.tm.synapse_cell, before)
    assert b.state.batch == 1 and b.last_metrics["tm_grown_synapses"] >= 0


# ---- component hooks (tests/test_injection.py) ------------------------


def identity_boosting(cfg, overlaps, duty_cycle):
    return overlaps.to(torch.float32)


def halfwise_inhibition(cfg, boosted):
    """Local inhibition: top-k/2 within each half of the column range."""
    C, k = cfg.column_dim, cfg.active_columns // 2
    lo, _ = k_winners(boosted[:, :C // 2], k)
    hi, _ = k_winners(boosted[:, C // 2:], k)
    cols = torch.cat([lo, hi + C // 2], -1)
    return cols, pas.column_mask_from_cols(cols, C)


def tagged_tm(cfg, state, draws, active_cols, learning, compute_winner):
    new_state, out = bt.tm_step(cfg, state, draws, active_cols, learning,
                                compute_winner)
    return new_state, out._replace(metrics={
        **out.metrics, "custom_tm_called": torch.ones(1, dtype=torch.int32)})


def halved_overlap(cfg, state, input_bits):
    from bithtm_tpu_torch.ops.overlap import overlaps

    return overlaps(state.connected, input_bits) // 2


def frozen_proximal_update(cfg, state, input_bits, active_columns):
    return state.permanence, state.connected


def passthrough_distal_forward(cfg, state, active_cols, act_bits):
    act = pas.synapse_activation_conn(
        state.synapse_cell, state.synapse_perm, active_cols, act_bits,
        cfg.cell_dim, cfg.permanence_threshold, cfg.synapse_capacity)
    pot, conn = pas.seg_counts_packed(act, cfg.segments_per_column,
                                      cfg.synapse_capacity)
    return act, pot, conn


def _input(seed=0, dim=64):
    return np.random.RandomState(seed).rand(dim) < 0.2


def htm(**kw):
    return pnet.HierarchicalTemporalMemory(64, 64, 4, device="cpu",
                                           **{**SMALL, **kw})


def test_custom_inhibition_and_boosting_through_the_wrappers():
    sp = pnet.SpatialPooler(64, 64, 8, inhibition=halfwise_inhibition,
                            device="cpu")
    cols = sp.process(_input()).active_columns.numpy()
    assert (cols < 32).sum() == 4 and (cols >= 32).sum() == 4
    sp = pnet.SpatialPooler(64, 64, 8, boosting=identity_boosting,
                            device="cpu")
    out = sp.process(_input())
    assert torch.equal(out.boosted_overlaps, out.overlaps.float())
    h = htm(active_columns=8, inhibition=halfwise_inhibition)
    for t in range(4):
        cols = h.process(_input(t))[0].active_columns.numpy()
        assert (cols < 32).sum() == 4 and (cols >= 32).sum() == 4


def test_custom_temporal_memory_through_htm_wrapper():
    h = htm(temporal_memory=tagged_tm)
    h.process(_input())
    assert h.last_metrics["custom_tm_called"] == 1


def test_custom_overlap_and_proximal_update():
    ref = pnet.SpatialPooler(64, 64, 8, device="cpu")
    sp = pnet.SpatialPooler(64, 64, 8, overlap=halved_overlap, device="cpu")
    x = _input()
    assert torch.equal(sp.process(x).overlaps, ref.process(x).overlaps // 2)
    # end to end: the HTM keeps learning on top of the custom overlap
    h, r = htm(overlap=halved_overlap), htm()
    pats = np.random.RandomState(0).rand(5, 64) < 0.2
    assert torch.equal(h.process(pats[0])[0].overlaps,
                       r.process(pats[0])[0].overlaps // 2)
    for _ in range(5):
        for p in pats:
            h.process(p)
    assert h.last_metrics["bursting"] <= 1
    assert h.last_metrics["correct"] >= 3
    sp = pnet.SpatialPooler(64, 64, 8, proximal_update=frozen_proximal_update,
                            device="cpu")
    before = sp.state.permanence.clone()
    sp.process(x, learning=True)
    assert torch.equal(sp.state.permanence, before)
    before = ref.state.permanence.clone()
    ref.process(x, learning=True)
    assert not torch.equal(ref.state.permanence, before)


def test_custom_distal_forward_inference_parity_and_guards():
    """A pass-through `distal_forward` is bit-identical to the built-in
    inference; with learning, or with a `temporal_memory` hook, it
    raises JAX's errors."""
    h = htm()
    pats = np.random.RandomState(1).rand(5, 64) < 0.2
    for _ in range(4):
        for p in pats:
            h.process(p)
    hooked = htm(distal_forward=passthrough_distal_forward)
    hooked.state = h.state
    for p in pats:
        _, want = h.process(p, learning=False, return_winner_cell=False)
        _, got = hooked.process(p, learning=False, return_winner_cell=False)
        assert torch.equal(got.prediction, want.prediction)
    with pytest.raises(ValueError, match="inference forward pass only"):
        hooked.process(pats[0], learning=True)
    both = htm(distal_forward=passthrough_distal_forward,
               temporal_memory=tagged_tm)
    with pytest.raises(ValueError, match="temporal_memory hook would"):
        both.process(pats[0], learning=False)


def test_epsilon_per_call():
    """A per-call epsilon is the config's for that call only: a wrapper
    that passes 0.5 on odd steps (and its own value, a no-op, on even
    ones) steps as one configured with 0.5 that passes the default on
    even steps, from the same seed."""
    sp = pnet.SpatialPooler(64, 32, 4, device="cpu")
    a = pnet.TemporalMemory(32, 4, **SMALL, device="cpu")
    b = pnet.TemporalMemory(32, 4, **SMALL, device="cpu", epsilon=0.5)
    pats = np.random.RandomState(4).rand(3, 64) < 0.3
    learned = 0
    for t in range(24):
        out = sp.process(pats[t % 3])
        a.process(out, epsilon=0.5 if t % 2 else a.config.epsilon)
        got = b.process(out, epsilon=None if t % 2 else a.config.epsilon)
        learned += int(got.metrics["tm_learning_segments"])
        for f in dataclasses.fields(a.state):
            assert torch.equal(getattr(a.state, f.name),
                               getattr(b.state, f.name)), (t, f.name)
    assert learned > 0


# ---- the host TM hook (tests/test_host_hooks.py) ----------------------


class RepeatPredictorTM:
    """Activates every cell of each active column, marks cell 0 the
    winner, predicts a repeat of the current activity."""

    def __init__(self, column_dim, cell_dim):
        self.C, self.D = column_dim, cell_dim
        self.calls = []

    def __call__(self, active_columns, learning):
        self.calls.append((np.array(active_columns), bool(learning)))
        active = np.zeros((self.C, self.D), bool)
        active[active_columns] = True
        winner = np.zeros((self.C, self.D), bool)
        winner[active_columns, 0] = True
        return active.reshape(-1), winner.reshape(-1), active.reshape(-1)


def test_host_tm_substitution_golden():
    C, D, A = 96, 4, 5
    host_tm = RepeatPredictorTM(C, D)
    h = pnet.HierarchicalTemporalMemory(
        128, C, D, active_columns=A, seed=3, device="cpu",
        temporal_memory=bt.HostTemporalMemory(host_tm))
    rng = np.random.RandomState(0)
    x, y = rng.rand(128) < 0.3, rng.rand(128) < 0.3
    prev_cols, prev_pred = None, np.zeros((C * D,), bool)
    for t, inp in enumerate([x, x, x, y, x]):
        sp_out, tm_out = h.process(inp, learning=True)
        cols = np.sort(sp_out.active_columns.numpy())
        assert len(host_tm.calls) == t + 1
        called_cols, called_learning = host_tm.calls[t]
        assert np.array_equal(np.sort(called_cols), cols)
        assert called_learning is True
        active = np.zeros((C, D), bool)
        active[cols] = True
        winner = np.zeros((C, D), bool)
        winner[cols, 0] = True
        assert np.array_equal(tm_out.active_mask.numpy(), active.reshape(-1))
        assert np.array_equal(tm_out.winner_mask.numpy(), winner.reshape(-1))
        assert np.array_equal(tm_out.prediction.numpy(), active.reshape(-1))
        assert np.array_equal(tm_out.prev_prediction.numpy(), prev_pred)
        prev_pred_cols = set() if prev_cols is None else set(prev_cols)
        expect_burst = np.array([c in cols and c not in prev_pred_cols
                                 for c in range(C)])
        assert np.array_equal(tm_out.bursting_columns.numpy(), expect_burst)
        m = h.last_metrics
        assert m["bursting"] == expect_burst.sum()
        expect_correct = len(prev_pred_cols & set(cols.tolist()))
        assert m["correct"] == expect_correct
        assert m["incorrect"] == len(prev_pred_cols) - expect_correct
        assert m["tm_active_cells"] == A * D
        assert m["tm_winner_cells"] == A
        prev_cols, prev_pred = cols.tolist(), active.reshape(-1)


def test_host_tm_reset_and_single_stream():
    C, D, A = 64, 2, 4
    adapter = bt.HostTemporalMemory(RepeatPredictorTM(C, D))
    h = pnet.HierarchicalTemporalMemory(64, C, D, active_columns=A,
                                        device="cpu",
                                        temporal_memory=adapter)
    x = np.random.RandomState(1).rand(64) < 0.3
    h.process(x)
    h.process(x)
    assert h.last_metrics["bursting"] == 0
    adapter.reset()
    _, tm_out = h.process(x)
    assert h.last_metrics["bursting"] == A
    assert not tm_out.prev_prediction.any()
    cfg = bt.make_htm_config(64, C, D, A)
    state = bt.htm_init_batch(cfg, 2, torch.Generator(), "cpu")
    with pytest.raises(ValueError, match="single-stream"):
        bt.htm_step(cfg, state, torch.zeros((2, 64), dtype=torch.bool),
                    temporal_memory=adapter)


def test_host_tm_learns_a_cycle():
    """A NumPy first-order sequence memory in the TM slot learns a
    4-pattern cycle: bursting falls and correct rises."""
    C, D = 64, 4
    N = C * D
    transitions, last = {}, [None]

    def numpy_tm(active_cols, learning):
        cols = tuple(sorted(int(c) for c in active_cols))
        active, winner, pred = (np.zeros(N, bool) for _ in range(3))
        for c in cols:
            active[c * D] = winner[c * D] = True
        if learning and last[0] is not None:
            transitions[last[0]] = cols
        for c in transitions.get(cols, ()):
            pred[c * D] = True
        last[0] = cols
        return active, winner, pred

    h = pnet.HierarchicalTemporalMemory(
        128, C, D, active_columns=4, device="cpu",
        temporal_memory=bt.HostTemporalMemory(numpy_tm))
    pats = np.random.RandomState(0).rand(4, 128) < 0.15
    per_epoch = []
    for _ in range(4):
        corrects = burstings = 0
        for p in pats:
            h.process(p)
            corrects += h.last_metrics["correct"]
            burstings += h.last_metrics["bursting"]
        per_epoch.append((corrects, burstings))
    assert per_epoch[0][1] == 16
    assert per_epoch[-1][0] > per_epoch[0][0]
    assert per_epoch[-1][1] < per_epoch[0][1]


# ---- observables and decoders -----------------------------------------


def test_segment_observables_and_decoders_match_jax():
    """`tm_segment_observables` on a batched learned state, and
    `prediction_dense` / `dense_from_compact`, against JAX."""
    jcfg = jb.make_htm_config(64, 64, 4, **SMALL)
    pcfg = bt.make_htm_config(64, 64, 4, **SMALL)
    jstate = jb.htm_init_batch(jax.random.key(0), jcfg, 3)
    pats = np.random.RandomState(0).rand(12, 3, 64) < 0.2
    jstate, _ = jb.htm_scan(jcfg, jstate, jnp.asarray(pats), True)
    pstate = htm_state_from_numpy(jstate, "cpu")
    want = jtm.tm_segment_observables(jcfg.tm, jstate.tm)
    got = bt.tm_segment_observables(pcfg.tm, pstate.tm)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    assert got["matching"].any()
    D = pcfg.tm.cell_dim
    np.testing.assert_array_equal(
        pas.prediction_dense(pstate.tm.prediction, D).numpy(),
        np.asarray(jax.vmap(lambda w: jas.prediction_dense(w, D))(
            jstate.tm.prediction)))
    np.testing.assert_array_equal(
        pas.dense_from_compact(pstate.tm.active_cols, pstate.tm.active_bits,
                               64, D).numpy(),
        np.asarray(jax.vmap(lambda c, b: jas.dense_from_compact(
            c, b, 64, D))(jstate.tm.active_cols, jstate.tm.active_bits)))
    rng = np.random.RandomState(1)
    words = rng.randint(0, 2**32, (3, 2, 17), dtype=np.uint64).astype(
        np.uint32)
    np.testing.assert_array_equal(
        pas.prediction_dense_host(torch.from_numpy(words.view(np.int32)), 40),
        jas.prediction_dense_host(words, 40))
    mw = rng.randint(-2**31, 2**31, (3, 17), dtype=np.int64).astype(np.int32)
    np.testing.assert_array_equal(pas.matching_dense_host(mw, 32),
                                  jas.matching_dense_host(mw, 32))


# ---- the hook-free SP (tests/test_sp.py) ------------------------------


def numpy_sp_step(cfg, perm, duty, x, learning):
    """The reference semantics in NumPy (`tests/test_sp.py`)."""
    weight = perm >= cfg.permanence_threshold
    overlaps = (weight & x).sum(axis=1)
    factor = np.exp(-(cfg.boosting_intensity / cfg.density) * duty)
    boosted = factor.astype(np.float32) * overlaps.astype(np.float32)
    order = np.lexsort((np.arange(len(boosted)), -boosted))
    active = np.sort(order[: cfg.active_columns])
    if learning:
        perm = perm.copy()
        perm[active] += x * (cfg.permanence_increment
                             + cfg.permanence_decrement) \
            - cfg.permanence_decrement
    duty = duty * cfg.duty_cycle_momentum
    duty[active] += 1.0 - cfg.duty_cycle_momentum
    return perm, duty, overlaps, active


def test_sp_matches_numpy_trajectory():
    cfg = bt.SPConfig(input_dim=80, column_dim=96, active_columns=7)
    I = cfg.input_dim
    state = sp_init(cfg, 1, torch.Generator().manual_seed(0), "cpu")
    pad0 = state.permanence[0, :, I:].clone()
    perm = state.permanence[0, :, :I].double().numpy()
    duty = np.zeros(cfg.column_dim, np.float32)
    rng = np.random.RandomState(1)
    for t in range(30):
        x = rng.rand(I) < 0.25
        learning = t % 3 != 2
        state, out = bt.sp_step(cfg, state, T(x[None]), learning)
        perm, duty, overlaps, active = numpy_sp_step(cfg, perm, duty, x,
                                                     learning)
        np.testing.assert_array_equal(out.overlaps[0].numpy(), overlaps)
        np.testing.assert_array_equal(
            np.sort(out.active_columns[0].numpy()), active)
        np.testing.assert_allclose(state.permanence[0, :, :I].numpy(), perm,
                                   atol=1e-5)
        assert torch.equal(state.permanence[0, :, I:], pad0)
        np.testing.assert_allclose(state.duty_cycle[0].numpy(), duty,
                                   atol=1e-5)
        assert torch.equal(unpack_connected(state.connected, I),
                           state.permanence[..., :I]
                           >= cfg.permanence_threshold)


def test_sp_inference_and_boosting():
    """Inference leaves the permanences and moves the duty cycle; a busy
    column loses to a quiet one with the same overlap."""
    cfg = bt.SPConfig(input_dim=80, column_dim=96, active_columns=7)
    state = sp_init(cfg, 1, torch.Generator().manual_seed(2), "cpu")
    before = state.permanence.clone()
    x = T(np.random.RandomState(0).rand(1, 80) < 0.3)
    new, _ = bt.sp_step(cfg, state, x, False)
    assert torch.equal(new.permanence, before)
    assert new.duty_cycle.any()
    duty = torch.zeros(1, 96)
    duty[:, :50] = 0.5
    state = dataclasses.replace(state, duty_cycle=duty)
    _, out = bt.sp_step(cfg, state, torch.ones(1, 80, dtype=torch.bool),
                        False)
    assert (out.active_columns >= 50).all()


def test_quantized_sp_integer_exact_trajectory():
    cfg = bt.SPConfig(input_dim=80, column_dim=96, active_columns=7,
                      permanence_dtype="int16")
    inc, dec = (cfg.to_units(cfg.permanence_increment),
                cfg.to_units(cfg.permanence_decrement))
    state = sp_init(cfg, 1, torch.Generator().manual_seed(5), "cpu")
    I = cfg.input_dim
    perm = state.permanence[0, :, :I].numpy().astype(np.int64)
    duty = np.zeros(cfg.column_dim, np.float32)
    rng = np.random.RandomState(3)
    for t in range(30):
        x = rng.rand(I) < 0.25
        state, out = bt.sp_step(cfg, state, T(x[None]), True)
        overlaps = ((perm >= 0) & x).sum(axis=1)
        factor = np.exp(-(cfg.boosting_intensity / cfg.density) * duty)
        boosted = factor.astype(np.float32) * overlaps.astype(np.float32)
        order = np.lexsort((np.arange(len(boosted)), -boosted))
        active = np.sort(order[: cfg.active_columns])
        perm[active] += x * (inc + dec) - dec
        duty = duty * cfg.duty_cycle_momentum
        duty[active] += 1.0 - cfg.duty_cycle_momentum
        np.testing.assert_array_equal(out.overlaps[0].numpy(), overlaps)
        np.testing.assert_array_equal(
            np.sort(out.active_columns[0].numpy()), active)
        np.testing.assert_array_equal(
            state.permanence[0, :, :I].numpy().astype(np.int64), perm)
        assert state.permanence.dtype == torch.int16


def test_quantized_sp_rejects_offgrid_and_saturates():
    cfg = bt.SPConfig(input_dim=8, column_dim=8, active_columns=1,
                      permanence_dtype="int16", permanence_increment=0.0033)
    state = sp_init(cfg, 1, torch.Generator(), "cpu")
    with pytest.raises(ValueError):
        bt.sp_step(cfg, state, torch.zeros(1, 8, dtype=torch.bool), True)
    cfg = bt.SPConfig(input_dim=8, column_dim=8, active_columns=8,
                      permanence_dtype="int16")
    state = sp_init(cfg, 1, torch.Generator().manual_seed(1), "cpu")
    x = T(np.eye(8, dtype=bool)[:1])
    perm0 = state.permanence[0, :, :8].numpy().astype(np.int64)
    for _ in range(40):
        state, _ = bt.sp_step(cfg, state, x, True)
    p = state.permanence[0, :, :8].numpy().astype(np.int64)
    assert (p <= 32000).all() and (p >= -32000 + perm0.min()).all()
    state = dataclasses.replace(
        state, permanence=torch.full_like(state.permanence, 31999),
        connected=torch.full_like(state.connected, 255))
    state, _ = bt.sp_step(cfg, state, x, True)
    assert state.permanence.max() == 32000 and (state.permanence > 0).all()
