"""The port's multi-level stack: the contracts of `tests/test_stack.py`
on the port alone, then `stack_scan` against the JAX package's from the
same layer states (converted) with each layer's draws replayed from its
JAX key: every leaf and metric bit-equal."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import torch

from bithtm_tpu.models import stack as jstack

import bithtm_tpu_torch as bt
from bithtm_tpu_torch.convert import (stack_state_from_numpy,
                                      stack_state_to_numpy)

from .test_torch_htm import ReplayDraws, copy_keys

COMMON = dict(active_columns=4, segment_activation_threshold=2,
              segment_matching_threshold=2, segment_sampling_synapses=8,
              sp_overrides={"boosting_intensity": 0.05})
LAYERS = [(64, 4), (48, 4)]


def make_cfg():
    return bt.make_stack_config(input_dim=64, layer_dims=LAYERS, **COMMON)


def test_dimensional_chaining():
    cfg = make_cfg()
    assert cfg.layers[0].input_dim == 64
    assert cfg.layers[1].input_dim == cfg.layers[0].tm.num_cells


def test_stack_learns_both_layers():
    cfg = make_cfg()
    gen = torch.Generator().manual_seed(0)
    state = bt.stack_init(cfg, 1, gen, "cpu")
    rng = np.random.RandomState(0)
    pats = rng.rand(5, 64) < 0.2
    seq = torch.from_numpy(np.tile(pats, (15, 1)))[:, None]
    state, metrics = bt.stack_scan(cfg, state, seq, True,
                                   bt.stack_draws(cfg, 1, "cpu", gen))
    b0 = metrics["L0_bursting"][:, 0].float().numpy()
    b1 = metrics["L1_bursting"][:, 0].float().numpy()
    # both layers converge: late bursting far below early
    assert b0[-10:].mean() < b0[:10].mean() / 3
    assert b1[-10:].mean() < b1[:10].mean() / 3


def test_stack_single_step_and_scan_agree():
    cfg = make_cfg()
    rng = np.random.RandomState(1)
    seq = torch.from_numpy(rng.rand(6, 2, 64) < 0.2)
    gen = torch.Generator().manual_seed(3)
    s_scan = bt.stack_init(cfg, 2, gen, "cpu")
    s_loop = copy.deepcopy(s_scan)
    gen_state = gen.get_state()
    s_scan, m_scan = bt.stack_scan(cfg, s_scan, seq, True,
                                   bt.stack_draws(cfg, 2, "cpu", gen))
    gen.set_state(gen_state)
    draws = bt.stack_draws(cfg, 2, "cpu", gen)
    for t, x in enumerate(seq):
        s_loop, out = bt.stack_step(cfg, s_loop, x, True, draws)
        assert set(out.metrics) == set(m_scan)
        for k, v in out.metrics.items():
            assert torch.equal(v, m_scan[k][t]), (t, k)
    assert out.layers[0].tm.active_mask.shape == (2, 256)
    assert out.layers[1].tm.active_mask is None
    for got, want in zip(stack_state_to_numpy(s_loop),
                         stack_state_to_numpy(s_scan)):
        for part in ("sp", "tm"):
            for name, a in got[part].items():
                np.testing.assert_array_equal(a, want[part][name],
                                              err_msg=f"{part}.{name}")


def test_stack_scan_matches_jax():
    """The 64 -> (64, 4), (48, 4) stack from JAX's layer states: 30
    learning then 6 inference steps, every leaf and metric equal."""
    jcfg = jstack.make_stack_config(input_dim=64, layer_dims=LAYERS,
                                    **COMMON)
    pcfg = make_cfg()
    jstate = jstack.stack_init(jax.random.key(4), jcfg)
    pstate = stack_state_from_numpy(jstate, "cpu")
    draws = tuple(ReplayDraws(c.tm, copy_keys(s.key[None]))
                  for c, s in zip(pcfg.layers, jstate))
    rng = np.random.RandomState(2)
    pats = rng.rand(5, 64) < 0.2
    x = pats[np.arange(36) % 5] ^ (rng.rand(36, 64) < 0.05)
    jstate, jm1 = jstack.stack_scan(jcfg, jstate, jnp.asarray(x[:30]), True)
    jstate, jm2 = jstack.stack_scan(jcfg, jstate, jnp.asarray(x[30:]),
                                    False)
    px = torch.from_numpy(x)[:, None]
    pstate, pm1 = bt.stack_scan(pcfg, pstate, px[:30], True, draws)
    pstate, pm2 = bt.stack_scan(pcfg, pstate, px[30:], False, draws)
    for jm, pm in ((jm1, pm1), (jm2, pm2)):
        assert set(jm) == set(pm)
        for k, v in jm.items():
            np.testing.assert_array_equal(pm[k][:, 0].numpy(), np.asarray(v),
                                          err_msg=k)
    for k, (jlayer, player) in enumerate(
            zip(jstate, stack_state_to_numpy(pstate))):
        for part in ("sp", "tm"):
            for name, got in player[part].items():
                want = np.asarray(getattr(getattr(jlayer, part), name))
                np.testing.assert_array_equal(got[0], want,
                                              err_msg=f"L{k} {part}.{name}")
    assert int(pm2["L0_correct"].sum()) > 0  # the bottom layer predicts
