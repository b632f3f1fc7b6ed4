"""The column decisions' plain version (`column_decide_ref`, the torch
chain of `_winner_selection`, `_learn`'s flags and `_allocate`, which the
`column_decide` kernel replaces on the card) against the jitted JAX
functions on the CPU, on small synthetic states (`testing.decide_inputs`)
made with numpy from a seed: more unaccounted cells than eligible slots
under both policies, columns with no eligible slot, a batch that mixes
step 0 and later steps, exact ties in the bursting score, D off the
32-bit word and G = 1, and the winner-only and bursting-only modes
against JAX's inference steps. The draws are the test's own: JAX's
`jax.random.uniform` hands them out while its functions are traced.
Every output is compared exactly: words, owners, flags and counts. The
kernel itself runs only on the card (`tests/test_torch_cuda.py`,
`chip_smoke.py` `check_column_decide`).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bithtm_tpu import TMConfig as JaxTMConfig
from bithtm_tpu.models import temporal_memory as jax_tm
from bithtm_tpu.models.temporal_memory import tm_step as jax_tm_step
from bithtm_tpu.ops import active_set as jas
from bithtm_tpu.state import TMState as JaxTMState

import bithtm_tpu_torch as bt
from bithtm_tpu_torch import testing
from bithtm_tpu_torch.models import temporal_memory as ptm
from bithtm_tpu_torch.ops import kernels
from bithtm_tpu_torch.ops.active_set import act_scale

B = 4

# name: (config overrides on `testing.FUZZ_BASE`, `decide_inputs`
# options): both policies with more unaccounted cells than slots (G=2,
# D=8), columns with no eligible slot, step 0 beside later steps, ties,
# D=33 at G=1
CASES = {
    "drops_reference": (dict(segments_per_column=2, cell_dim=8,
                             allocation_policy="reference"), {}),
    "drops_evict": (dict(segments_per_column=2, cell_dim=8,
                         allocation_policy="evict"), {}),
    "mixed_steps": (dict(allocation_policy="evict"), dict(first_steps=2)),
    "score_ties": (dict(cell_dim=6, allocation_policy="reference"),
                   dict(ties=True)),
    "D33_G1": (dict(cell_dim=33, segments_per_column=1,
                    allocation_policy="evict"), {}),
}


def jax_state(state) -> JaxTMState:
    """The JAX TMState (batched, on the CPU) of a port TMState."""
    leaves = bt.htm_state_to_numpy(bt.HTMState(
        sp=bt.SPState(*[torch.zeros(1)] * 3), tm=state))["tm"]
    return JaxTMState(**{k: jnp.asarray(v) for k, v in leaves.items()})


def jax_decisions(jcfg, x, monkeypatch):
    """JAX `_winner_selection` and `_learn` (jitted, over the B streams)
    on ``x``'s state and columns, with ``x``'s draws as their uniforms.
    Returns (pred_rows, (col_burst, winner_rows, cell_max, seg_j),
    (seg_cell, metrics, debug)) as numpy."""
    draws = []

    def uniform(key, shape, dtype=jnp.float32, *args, **kw):
        return draws.pop(0)

    monkeypatch.setattr(jax.random, "uniform", uniform)
    C, D = jcfg.column_dim, jcfg.cell_dim

    def one(s, key, c, u_seg, u_least):
        draws[:] = [u_seg, u_least]
        pred_rows = jas.unpack_bits(jnp.swapaxes(
            jnp.take(s.prediction, c, axis=-1), -1, -2), D)
        sel = jax_tm._winner_selection(jcfg, s, key, c, pred_rows)
        learned = jax_tm._learn(jcfg, s, key, c,
                                jas.column_mask_from_cols(c, C), pred_rows,
                                *sel[1:])
        return pred_rows, sel, learned[2:]

    keys = jax.random.split(jax.random.PRNGKey(3), B)
    d = x["draws"]
    return jax.device_get(jax.jit(jax.vmap(one))(
        jax_state(x["state"]), keys, jnp.asarray(x["cols"].numpy()),
        jnp.asarray(d.u_seg.numpy()), jnp.asarray(d.u_least.numpy())))


def port_decisions(cfg, x, mode="learn"):
    """`column_decide_ref` on ``x`` at its columns (the owners written in
    place into its state), with `row_counts_ref`'s counts."""
    s = x["state"]
    pot, conn, live = ptm.row_counts_ref(s.synapse_cell, s.synapse_perm,
                                         s.synapse_act, x["cols"],
                                         cfg.segments_per_column)
    return ptm.column_decide_ref(cfg, s.prediction, s.seg_cell, x["cols"],
                                 pot, conn, live, x["draws"], s.step, mode)


def words(rows) -> np.ndarray:
    """JAX `pack_bits` of (B, A, D) bools, as the port's int32 words."""
    return np.asarray(jas.pack_bits(jnp.asarray(rows))).view(np.int32)


@pytest.mark.parametrize("case", CASES)
def test_column_decide_ref_matches_jax(case, monkeypatch):
    """`column_decide_ref` in its learning mode against JAX
    `_winner_selection` and `_learn` with the same uniforms: the bursting
    columns, the activity and winner words (JAX `pack_bits`), the new
    owners, the learning and new segments and every count; nothing
    launches. Each case holds what it is about."""
    overrides, opts = CASES[case]
    cfg = testing.fuzz_config(**overrides)
    jcfg = JaxTMConfig(**dataclasses.asdict(cfg))
    x = testing.decide_inputs(testing.fuzz_seed(case), cfg, B, **opts)
    owners = ptm._rows(x["state"].seg_cell, x["cols"])
    pred_rows, sel, (seg_cell, metrics, debug) = jax_decisions(jcfg, x,
                                                               monkeypatch)
    col_burst, winner_rows = np.asarray(sel[0]), np.asarray(sel[1])
    act_rows = np.asarray(pred_rows) | col_burst[..., None]

    before = kernels.launch_counts()
    dec = port_decisions(cfg, x)
    assert kernels.launch_counts() == before
    np.testing.assert_array_equal(dec.col_burst.numpy(), col_burst)
    np.testing.assert_array_equal(dec.winner_bits.numpy(), words(winner_rows))
    np.testing.assert_array_equal(dec.act_bits.numpy(), words(act_rows))
    np.testing.assert_array_equal(x["state"].seg_cell.numpy(), seg_cell)
    A, G = cfg.active_columns, cfg.segments_per_column
    for flags, k in ((dec.learn, "learning_segments"),
                     (dec.new_seg, "new_segments")):
        dense = ptm._dense(x["cols"], flags.reshape(B, A, G),
                           cfg.column_dim)
        np.testing.assert_array_equal(dense.numpy(), debug[k], err_msg=k)
    want = [col_burst.sum(-1), act_rows.sum((1, 2)),
            winner_rows.sum((1, 2))] + [
        metrics[k] for k in ptm.DECIDE_COUNTS[3:]]
    np.testing.assert_array_equal(dec.counts.numpy(), np.stack(want))

    counts = dict(zip(ptm.DECIDE_COUNTS, dec.counts.numpy()))
    assert counts["tm_new_segments"].sum() > 0
    assert counts["tm_learning_segments"].sum() > counts[
        "tm_new_segments"].sum()
    if case.startswith("drops"):
        assert counts["tm_dropped_new_segments"].sum() > 0
        assert (counts["tm_evicted_segments"].sum() > 0) == (
            cfg.allocation_policy == "evict")
    if case == "mixed_steps":
        assert not counts["tm_learning_segments"][:2].any()
        assert not counts["tm_new_segments"][:2].any()
        assert counts["tm_learning_segments"][2:].all()
    if case == "score_ties":
        # bursting columns whose score ties at its maximum
        cell_max = np.asarray(sel[2])
        owned = (owners.numpy()[..., None] == np.arange(cfg.cell_dim)).sum(-2)
        score = np.where(cell_max.max(-1, keepdims=True)
                         >= cfg.segment_matching_threshold, cell_max,
                         -(owned + x["draws"].u_least.numpy()))
        top = (score == score.max(-1, keepdims=True)).sum(-1)
        assert ((top > 1) & col_burst).any()


def test_column_with_no_eligible_slot_drops_every_cell(monkeypatch):
    """A column whose every slot is live and matching (no slot recyclable
    or evictable under either policy) allocates nothing: each of its
    unaccounted cells is dropped, as JAX drops it."""
    for policy in ("reference", "evict"):
        cfg = testing.fuzz_config(segments_per_column=2, cell_dim=8,
                                  allocation_policy=policy)
        jcfg = JaxTMConfig(**dataclasses.asdict(cfg))
        x = testing.decide_inputs(11, cfg, B)
        s = x["state"]
        cols = x["cols"]
        # every active column crowded: all slots live and active
        rows = ptm._rows(s.synapse_cell, cols)
        full = torch.arange(cfg.column_dim * cfg.cell_dim,
                            dtype=torch.int32)[:rows.shape[-1]]
        ptm._put_rows(s.synapse_cell, cols, full.expand_as(rows).clone())
        ptm._put_rows(s.synapse_perm, cols, torch.full(rows.shape, 0.7))
        ptm._put_rows(s.synapse_act, cols, torch.full(
            rows.shape, 1 + act_scale(cfg.synapse_capacity),
            dtype=s.synapse_act.dtype))
        ptm._put_rows(s.seg_cell, cols, torch.zeros(
            (B, cols.shape[1], cfg.segments_per_column), dtype=torch.int32))
        _, _, (seg_cell, metrics, _) = jax_decisions(jcfg, x, monkeypatch)
        dec = port_decisions(cfg, x)
        np.testing.assert_array_equal(s.seg_cell.numpy(), seg_cell)
        counts = dict(zip(ptm.DECIDE_COUNTS, dec.counts.numpy()))
        for k in ptm.DECIDE_COUNTS[3:]:
            np.testing.assert_array_equal(counts[k], metrics[k], err_msg=k)
        assert counts["tm_new_segments"].sum() == 0
        assert counts["tm_dropped_new_segments"].sum() > 0


@pytest.mark.parametrize("compute_winner", [True, False])
def test_inference_decisions_match_jax(compute_winner):
    """The winner-only and bursting-only modes through `tm_step`
    (learning off) against the JAX inference step with and without
    winners, on the same synthetic state, columns and JAX draws: the
    active and winner words, the bursting columns and their counts; the
    two modes agree with the learning mode's first outputs."""
    cfg = testing.fuzz_config(cell_dim=33, allocation_policy="evict")
    jcfg = JaxTMConfig(**dataclasses.asdict(cfg))
    x = testing.decide_inputs(5, cfg, B)
    A, D, G = cfg.active_columns, cfg.cell_dim, cfg.segments_per_column
    L, Wc = cfg.resolved_growth_capacity, cfg.resolved_winner_capacity
    keys = jax.random.split(jax.random.PRNGKey(9), B)

    def jax_draws(key):
        k_select, k_grow = jax.random.split(key)
        k_seg, k_least = jax.random.split(k_select)
        return (jax.random.uniform(k_seg, (A, G)),
                jax.random.uniform(k_least, (A, D)),
                jax.random.bits(k_grow, (L, Wc), jnp.uint32))

    d = [np.array(v) for v in jax.vmap(jax_draws)(keys)]
    draws = bt.Draws(torch.from_numpy(d[0]), torch.from_numpy(d[1]),
                     torch.from_numpy(d[2].view(np.int32)))
    cols = x["cols"].numpy()
    want_state, want_out = jax.device_get(jax.jit(jax.vmap(
        lambda s, k, c: jax_tm_step(jcfg, s, k, c, False,
                                    compute_winner)))(
        jax_state(x["state"]), keys, jnp.asarray(cols)))
    before = kernels.launch_counts()
    got_state, got_out = bt.tm_step(cfg, x["state"], draws,
                                    torch.from_numpy(cols), False,
                                    compute_winner)
    assert kernels.launch_counts() == before
    for leaf in ("active_bits", "winner_bits"):
        np.testing.assert_array_equal(
            getattr(got_state, leaf).numpy(),
            np.asarray(getattr(want_state, leaf)).view(np.int32))
    np.testing.assert_array_equal(got_out.bursting_columns.numpy(),
                                  want_out.bursting_columns)
    for k in ptm.DECIDE_COUNTS[:3]:
        np.testing.assert_array_equal(got_out.metrics[k].numpy(),
                                      want_out.metrics[k], err_msg=k)
    assert (int(got_out.metrics["tm_winner_cells"].sum()) > 0) == \
        compute_winner
    y = testing.decide_inputs(5, cfg, B)
    y["draws"] = draws
    mode = "winner" if compute_winner else "burst"
    part, full = port_decisions(cfg, y, mode), port_decisions(cfg, y)
    assert part.learn is None and part.new_seg is None
    assert torch.equal(part.act_bits, full.act_bits)
    assert torch.equal(part.col_burst, full.col_burst)
    assert torch.equal(part.counts[0:2], full.counts[0:2])
    assert torch.equal(part.winner_bits, full.winner_bits
                       if compute_winner else torch.zeros_like(
                           full.winner_bits))
