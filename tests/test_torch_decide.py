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


# ---- the kernel's new reductions, emulated in numpy (csrc/decide_pass.cu)

def order_key(v: np.ndarray) -> np.ndarray:
    """`order_key`: float32 -> uint32, larger value larger key, -0.0
    keyed as +0.0."""
    u = v.astype(np.float32).view(np.uint32).copy()
    u[(u << np.uint32(1)) == 0] = 0
    return np.where(u & np.uint32(0x80000000), ~u,
                    u | np.uint32(0x80000000)).astype(np.uint32)


def emulate_column_decide(cfg, args) -> tuple:
    """The kernel's column decisions, its way, in segment space: the
    column max a max of the owned segments' seg_j bits; a matching
    bursting column's winner the lowest owner at that max, else the
    largest order-preserving key of -(owned + u) and its lowest cell, an
    unowned cell's key -(0 + u), an owned cell's from its segments (its
    owned count the segments with its owner) only where -(1 + u) could
    reach the unowned cells' best; a winner unaccounted where no segment
    it owns has seg_j >= eps; seg_best against the column max (the
    bursting winner's cell max where it counts); the recyclable slots
    ranked by two ballots' popcounts, the evictable ones by (live, g)
    only where the unaccounted cells reach them; the unaccounted cells
    assigned word by word; each stream's counts summed over its blocks'
    column ranges (`kernels.decide_split`), as the split grid meets
    them. Returns (act words, winner words, col_burst, learn, new_seg,
    counts, new owners at the columns) as numpy."""
    _, pred, owners, cols, pot, conn, live, draws, step, mode = args
    G, D = cfg.segments_per_column, cfg.cell_dim
    m_th, a_th = cfg.segment_matching_threshold, \
        cfg.segment_activation_threshold
    eps = np.float32(cfg.epsilon)
    B, W, _ = pred.shape
    A = cols.shape[1]
    big = np.iinfo(np.int32).max
    ix = (np.arange(B)[:, None], cols.numpy())
    words_ = pred.numpy().transpose(0, 2, 1)[ix].view(np.uint32)  # (B,A,W)
    o = owners.numpy()[ix].copy()                                 # (B,A,G)
    pot, conn, live = pot.numpy(), conn.numpy(), live.numpy()
    u_seg = draws.u_seg.numpy()
    u_least = draws.u_least.numpy()
    has_prev = (step.numpy() > 0)[:, None]
    d = np.arange(D)
    bits = (words_[..., d // 32] >> (d % 32).astype(np.uint32)) & 1
    pred_rows = bits.astype(bool)                                 # (B,A,D)
    burst = ~pred_rows.any(-1)

    owned = (o >= 0) & (o < D)
    match = pot >= m_th
    sj = np.where(match, pot.astype(np.float32) + u_seg,
                  np.float32(0)).astype(np.float32)
    sj_bits = np.where(owned, sj.view(np.int32), 0)
    peers = owned[..., :, None] & owned[..., None, :] & (
        o[..., :, None] == o[..., None, :])                       # (B,A,G,G)
    owns = owned[..., None] & (o[..., None] == d)                 # (B,A,G,D)
    col_max = sj_bits.max(-1).view(np.float32)
    lowest = np.where(owned & (sj == col_max[..., None]), o, big).min(-1)
    best_m = np.where(col_max > 0, lowest, 0)
    key_u = np.where(owns.any(-2), 0, order_key(-(np.float32(0) + u_least)))
    u_o = np.take_along_axis(u_least, np.clip(o, 0, D - 1), -1)
    need = (owned & (order_key(-(np.float32(1) + u_o))
                     >= key_u.max(-1, keepdims=True))).any(-1)
    key_o = np.where(owned & need[..., None],
                     order_key(-(peers.sum(-1).astype(np.float32) + u_o)),
                     0).astype(np.uint32)
    top = np.maximum(key_o.max(-1), key_u.max(-1))
    first_u = np.where((key_u == top[..., None]).any(-1),
                       (key_u == top[..., None]).argmax(-1), big)
    best_k = np.minimum(
        np.where(owned & (key_o == top[..., None]), o, big).min(-1), first_u)
    best = np.where(col_max >= np.float32(m_th), best_m, best_k)
    win = (pred_rows | (burst[..., None] & (d == best[..., None]))
           if mode != "burst" else np.zeros_like(pred_rows))
    act = pred_rows | burst[..., None]

    def pack(rows):
        out = np.zeros((B, A, W), np.uint32)
        for w in range(W):
            for i in range(min(32, D - 32 * w)):
                out[..., w] |= rows[..., 32 * w + i].astype(np.uint32) << \
                    np.uint32(i)
        return out.view(np.int32)

    counts = [burst, act.sum(-1), win.sum(-1)]
    learn = new_seg = None
    if mode == "learn":
        hot = (owns & ~(sj < eps)[..., None]).any(-2)
        un = win & ~hot & has_prev[..., None] & (np.float32(0) < eps)
        n_unacc = un.sum(-1)
        recyclable = live < m_th
        unalloc = o >= D
        evictable = (cfg.allocation_policy == "evict") & ~match & ~recyclable
        ra, ru = recyclable & ~unalloc, recyclable & unalloc
        n_rec = ra.sum(-1, keepdims=True) + ru.sum(-1, keepdims=True)
        er = np.where(~recyclable, n_rec, np.where(
            unalloc, ra.sum(-1, keepdims=True) + np.cumsum(ru, -1) - ru,
            np.cumsum(ra, -1) - ra))
        need = evictable.any(-1) & (n_unacc > n_rec[..., 0])
        ekey = live * G + np.arange(G)
        below = (evictable[..., None, :]
                 & (ekey[..., None, :] < ekey[..., :, None])).sum(-1)
        er = np.where(need[..., None] & evictable, er + below, er)
        eligible = recyclable | evictable
        fresh = np.zeros((B, A, G), bool)
        new_owner = np.zeros((B, A, G), np.int32)
        before = np.zeros((B, A, 1), np.int64)
        for w in range(W):
            un_w = un[..., 32 * w:32 * (w + 1)]
            r = er - before
            got = eligible & (r >= 0) & (r < un_w.sum(-1, keepdims=True))
            for b, a, g in zip(*np.nonzero(got)):
                fresh[b, a, g] = True
                new_owner[b, a, g] = 32 * w + np.flatnonzero(
                    un_w[b, a])[r[b, a, g]]
            before = before + un_w.sum(-1, keepdims=True)
        oc = np.clip(o, 0, D - 1)
        take = np.take_along_axis
        owner_pred = owned & take(pred_rows, oc, -1)
        owner_win = owned & take(win, oc, -1)
        # the kernel forms the column max in bursting columns alone
        cm = np.where(burst, col_max, np.float32(0))[..., None]
        seg_best = match & (np.abs(sj - cm) < eps)
        learn = (match & owner_win & ((match & (conn >= a_th))
                                      | (~owner_pred & seg_best))
                 & has_prev[..., None]) | fresh
        o = np.where(fresh, new_owner, o)
        counts += [fresh.sum(-1), learn.sum(-1), n_unacc - fresh.sum(-1),
                   (fresh & evictable).sum(-1)]
        learn, new_seg = learn.reshape(B, -1), fresh.reshape(B, -1)
    split = kernels.decide_split(B, A)
    per = -(-A // split)
    blocks = [np.stack([c[:, i:i + per].sum(-1) for c in counts])
              for i in range(0, A, per)]
    return (pack(act), pack(win), burst, learn, new_seg,
            np.sum(blocks, 0).astype(np.int32), o)


# name: (config overrides, `decide_inputs` options, zero draws): G = 1,
# 2, 4 and 32 at D = 32, 33 and 64 under both policies, ties, every draw
# 0 (-0.0 scores), a stream split over blocks (A = 130 at B = 4)
EMULATED = {
    "G1_D32_evict": (dict(segments_per_column=1, cell_dim=32,
                          allocation_policy="evict"), {}, False),
    "G2_D33_reference": (dict(segments_per_column=2, cell_dim=33,
                              allocation_policy="reference"), {}, False),
    "G4_D64_evict": (dict(segments_per_column=4, cell_dim=64,
                          allocation_policy="evict"), {}, False),
    "G32_D33_evict": (dict(segments_per_column=32, cell_dim=33,
                           synapse_capacity=4, allocation_policy="evict"),
                      {}, False),
    "G2_D8_drops": (dict(segments_per_column=2, cell_dim=8,
                         allocation_policy="evict"), {}, False),
    "ties_D64_reference": (dict(segments_per_column=4, cell_dim=64,
                                allocation_policy="reference"),
                           dict(ties=True), False),
    "zero_draws_D32": (dict(segments_per_column=4, cell_dim=32,
                            allocation_policy="evict"), {}, True),
    "split_A130": (dict(segments_per_column=2, cell_dim=32,
                        column_dim=256, active_columns=130,
                        allocation_policy="evict"),
                   dict(first_steps=2), False),
}


@pytest.mark.parametrize("case", EMULATED)
def test_kernel_reductions_match_the_plain_version(case):
    """The kernel's reductions (`emulate_column_decide`) against
    `column_decide_ref` on `testing.decide_inputs`, in each mode: the
    words, the bursting columns, the flags, the counts (met across the
    split grid's blocks) and the new owners exactly."""
    overrides, opts, zero = EMULATED[case]
    cfg = testing.fuzz_config(**overrides)
    x = testing.decide_inputs(len(case), cfg, B, **opts)
    if zero:
        x["draws"] = type(x["draws"])(*(torch.zeros_like(t)
                                        for t in x["draws"]))
    for mode in kernels.DECIDE_MODES:
        args = testing.decide_args(cfg, x, mode)
        got = emulate_column_decide(cfg, args)
        want = ptm.column_decide_ref(*args)
        ix = (torch.arange(B)[:, None], x["cols"].long())
        for g, w in zip(got, (*want, args[2][ix])):
            assert (g is None) == (w is None)
            assert g is None or np.array_equal(g, w.numpy()), mode
        if mode == "learn":
            assert int(want.counts[3].sum()) > 0
