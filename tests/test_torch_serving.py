"""The serving path of the PyTorch port against the JAX package, on the
CPU: the frozen word table, the compact serving table and its forward
pass, `htm_serve_scan` (unpacked, packed and frozen word) and
`resume_learning`.

Inputs are made with numpy from a seed. The plain versions
(`synapse_activation_frozen_ref`, `serving_activation_ref`) are checked
against the JAX XLA forms and against the Pallas kernels in interpret
mode; the CUDA kernels run only on the card (tests/test_torch_cuda.py,
`python3 chip_smoke.py`). Tolerance: exact equality throughout — every
compared value is an integer, a bit pattern, or a float the two
packages compute with the same single roundings.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bithtm_tpu import htm_init_batch as jax_htm_init_batch
from bithtm_tpu import htm_scan as jax_htm_scan
from bithtm_tpu import htm_serve_scan as jax_htm_serve_scan
from bithtm_tpu import resume_learning as jax_resume_learning
from bithtm_tpu.models.htm import _scan_impl as jax_scan_impl
from bithtm_tpu.ops import active_set as jas
from bithtm_tpu.ops import serving as jsv
from bithtm_tpu.ops.pallas_kernels import (serving_activation_tpu,
                                           synapse_activation_frozen_tpu)

import bithtm_tpu_torch as bt
from bithtm_tpu_torch.models.htm import _scan_impl
from bithtm_tpu_torch.ops import active_set as pas
from bithtm_tpu_torch.ops import kernels
from bithtm_tpu_torch.ops import serving as psv

from .test_serving import _naive_counts
from .test_torch_htm import (SMALL, ReplayDraws, _jax_sp_batch,
                             assert_metrics_equal, assert_no_near_tie,
                             assert_tree_equal, copy_keys, make_configs)


def _active_set(rng, B, C, D, A):
    """(B, A) sorted cols, (B, A, D) bool rows, port and JAX bits."""
    cols = np.sort(np.stack([rng.choice(C, A, replace=False)
                             for _ in range(B)]), 1).astype(np.int32)
    rows = rng.rand(B, A, D) < 0.5
    bits = pas.pack_bits(torch.from_numpy(rows))
    return cols, rows, bits, jnp.asarray(bits.numpy().view(np.uint32))


# ---- (a) the frozen word ---------------------------------------------


@pytest.mark.parametrize("D,A,K", [(4, 3, 8), (40, 3, 8), (32, 6, 8),
                                   (32, 6, 32)])
def test_frozen_word_matches_jax(D, A, K):
    """`pack_frozen_table` equals JAX's; `synapse_activation_frozen`
    (plain version on the CPU) equals JAX `synapse_activation_frozen`,
    the Pallas kernel in interpret mode, and the port's
    `synapse_activation_conn` on the unpacked table. The shapes of
    tests/test_pallas.py, with stale dead slots (syn >= 0, perm < 0)."""
    rng = np.random.RandomState(D + A + K)
    B, C, G = 2, 16, 4
    syn = rng.randint(-1, C * D, size=(B, C, G * K)).astype(np.int32)
    perm = np.where(syn >= 0, rng.rand(B, C, G * K).astype(np.float32)
                    * 1.2 - 0.2, -1.0).astype(np.float32)
    cols, _, bits, jbits = _active_set(rng, B, C, D, A)
    tsyn, tperm, tcols = map(torch.from_numpy, (syn, perm, cols))

    word = pas.pack_frozen_table(tsyn, tperm, 0.5)
    np.testing.assert_array_equal(word.numpy(), np.asarray(
        jas.pack_frozen_table(jnp.asarray(syn), jnp.asarray(perm), 0.5)))
    assert ((tsyn >= 0) & (word < 0)).any(), "stale slots pack dead"
    got = pas.synapse_activation_frozen(word, tcols, bits, D, K)
    assert torch.equal(got, pas.synapse_activation_conn(tsyn, tperm, tcols,
                                                        bits, D, 0.5, K))
    assert (got > 1).any()
    want = jax.vmap(jas.synapse_activation_frozen, (0, 0, 0, None, None))(
        jnp.asarray(word.numpy()), jnp.asarray(cols), jbits, D, K)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(
        synapse_activation_frozen_tpu(jnp.asarray(word[0].numpy()),
                                      jnp.asarray(cols[0]), jbits[0], D, K,
                                      block=8, interpret=True)))


def test_frozen_word_cell_id_guards():
    """Both checks of JAX `pack_frozen_table`: the geometry with
    ``num_cells``, the table's largest id without it."""
    syn = torch.tensor([[[0, 5, -1, 1 << 24]]], dtype=torch.int32)
    perm = torch.full(syn.shape, 0.7)
    assert pas.frozen_word_supported(2048, 32)
    assert not pas.frozen_word_supported(1 << 20, 32)
    with pytest.raises(ValueError, match="num_cells"):
        pas.pack_frozen_table(syn, perm, 0.5, num_cells=(1 << 24) + 1)
    with pytest.raises(ValueError, match="exceeds the 24-bit"):
        pas.pack_frozen_table(syn, perm, 0.5)
    word = pas.pack_frozen_table(syn[..., :3], perm[..., :3], 0.5,
                                 num_cells=1 << 24)
    assert word.tolist() == [[[1 << 24, 5 | 1 << 24, -1]]]


# ---- (b) the compact forward pass ------------------------------------


@pytest.mark.parametrize("A", [41, 50])
def test_serving_activation_matches_jax(A):
    """`serving_activation` (plain version) equals JAX
    `serving_activation_xla` and `serving_activation_tpu` in interpret
    mode (hash matcher at A=41, compare chain at A=50), with empty (-1)
    lanes, as tests/test_pallas.py."""
    rng = np.random.RandomState(A)
    B, C, D, G, R = 2, 512, 32, 4, 520
    cell = rng.randint(0, C * D, size=(B, R, 128)).astype(np.int32)
    g = rng.randint(0, G, size=(B, R, 128)).astype(np.int32)
    words = (cell << psv.SERVING_G_BITS) | g
    words[rng.rand(B, R, 128) < 0.4] = -1
    cols, _, bits, jbits = _active_set(rng, B, C, D, A)
    got = psv.serving_activation(torch.from_numpy(words),
                                 torch.from_numpy(cols), bits, C, D)
    assert got.dtype == torch.uint8 and (got > 0).any()
    for b in range(B):
        want = np.asarray(jsv.serving_activation_xla(
            jnp.asarray(words[b]), jnp.asarray(cols[b]), jbits[b], D))
        np.testing.assert_array_equal(got[b].numpy(), want)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(
        serving_activation_tpu(jnp.asarray(words[0]), jnp.asarray(cols[0]),
                               jbits[0], D, block=8, interpret=True)))


# ---- (c) make_serving_table and serving_counts -----------------------


def _spilling_tables(C, D, G, K, seed):
    """Two streams of sparse random tables; only stream 0 has the dense
    columns of tests/test_serving.py (all 256 slots connected in column 5,
    200 in column 17, column 30 dead everywhere)."""
    rng = np.random.RandomState(seed)
    J, N = G * K, C * D
    syn = rng.randint(-1, N, size=(2, C, J)).astype(np.int32)
    perm = (rng.rand(2, C, J) * 1.2 - 0.5).astype(np.float32)
    syn[0, 5] = rng.randint(0, N, size=J)
    perm[0, 5] = 0.9
    syn[0, 17] = rng.randint(0, N, size=J)
    perm[0, 17] = 0.9
    perm[0, 17, 200:] = -1.0
    perm[0, 30] = -1.0
    return syn, perm


def _tm(syn, perm, to_torch=False):
    f = torch.from_numpy if to_torch else jnp.asarray
    return types.SimpleNamespace(synapse_cell=f(syn), synapse_perm=f(perm))


def test_make_serving_table_matches_jax():
    """Batched at B=2, where only one stream spills: rows and ext_col
    bit-equal to JAX's (which vmaps the pack), the unused extension rows
    of the other stream owned by column C; `serving_counts` equals JAX's
    per stream and the naive NumPy count; the table survives the
    converters' round trip."""
    C, D, G, K, A = 256, 16, 4, 64, 9
    jcfg, pcfg = make_configs(input_dim=32, column_dim=C, cell_dim=D,
                              active_columns=A, segments_per_column=G,
                              synapse_capacity=K)
    syn, perm = _spilling_tables(C, D, G, K, 3)
    jtab = jsv.make_serving_table(jcfg.tm, _tm(syn, perm))
    ptab = psv.make_serving_table(pcfg.tm, _tm(syn, perm, True))
    got = bt.serving_table_to_numpy(ptab)
    np.testing.assert_array_equal(got["rows"], np.asarray(jtab.rows))
    np.testing.assert_array_equal(got["ext_col"], np.asarray(jtab.ext_col))
    assert ptab.rows.is_contiguous() and ptab.ext_col.is_contiguous()
    E = got["ext_col"].shape[1]
    assert E >= 2 and (got["ext_col"][0] < C).sum() >= 2
    assert (got["ext_col"][1] == C).all()
    back = bt.serving_table_from_numpy(jtab, "cpu")
    assert all(torch.equal(a, b) for a, b in zip(back, ptab))

    thr = pcfg.tm.permanence_threshold
    for seed in range(3):
        rng = np.random.RandomState(100 + seed)
        cols, rows, bits, jbits = _active_set(rng, 2, C, D, A)
        counts = psv.serving_counts(ptab, torch.from_numpy(cols), bits, C, D,
                                    G)
        for b in range(2):
            want = np.asarray(jsv.serving_counts(
                jsv.ServingTable(jtab.rows[b], jtab.ext_col[b]),
                jnp.asarray(cols[b]), jbits[b], C, D, G))
            np.testing.assert_array_equal(counts[b].numpy(), want)
            if seed:
                continue
            cells = {int(cols[b, a]) * D + d for a in range(A)
                     for d in range(D) if rows[b, a, d]}
            np.testing.assert_array_equal(
                counts[b].numpy(), _naive_counts(syn[b], perm[b], thr, K,
                                                 cells))


# ---- (d) the p99 width selection (ROADMAP fault h) -------------------


def _p99_cases():
    rng = np.random.RandomState(0)
    # q*(n-1) is 262152.99 exactly, 262153 in float32: the exact
    # percentile is 128.99 (width 128), float32's is 129 (width 256)
    n = 264802
    edge = np.zeros(n, np.int32)
    edge[262152], edge[262153:] = 128, 129
    bench = rng.binomial(256, 0.3, size=256 * 2048).astype(np.int32)
    small = [rng.randint(0, rng.randint(1, 400), size=rng.randint(1, 3000))
             for _ in range(20)]
    # two order statistics whose interpolation rounds differently with
    # and without XLA's fused multiply-add
    fused = []
    for n, lv, hv in ((2, 100, 101), (3, 100, 101), (4, 135, 185),
                      (5, 100, 103), (6, 100, 103), (7, 100, 101)):
        x = np.zeros(n, np.int32)
        x[n - 2], x[n - 1] = lv, hv
        fused.append(x)
    return [edge, bench, *small, *fused]


def test_percentile99_matches_jax_bit_for_bit():
    """`percentile99` equals ``jnp.percentile(x, 99.0)`` in every bit:
    at the index-rounding edge, at the bench's n = B*C = 524288, and on
    random vectors. The edge case is where a float64 percentile would
    pick another table width than the JAX package."""
    for i, x in enumerate(_p99_cases()):
        want = np.float32(jnp.percentile(jnp.asarray(x, jnp.float32), 99.0))
        got = psv.percentile99(torch.from_numpy(x))
        assert np.float32(got) == want and got == float(want), (i, got, want)
    assert np.percentile(_p99_cases()[0].astype(np.float64), 99.0) < 129


@pytest.mark.parametrize("tail,width,ext", [((128, 128), 128, 8),
                                            ((128, 129), 128, 8),
                                            ((129, 129), 256, 0)])
def test_serving_table_width_at_128(tail, width, ext):
    """Counts whose p99 lands exactly on 128, just above it, and on
    129: the port's table has JAX's width, extension rows and words.
    Two streams of 64 columns: the sorted counts put p99 between the
    126th and 127th of 128; the largest column (200) always spills."""
    C, D, G, K = 64, 4, 4, 64
    rng = np.random.RandomState(sum(tail))
    counts = rng.randint(0, 100, size=2 * C)
    order = np.argsort(counts)
    counts[order[-3:]] = (*tail, 200)
    counts = counts.reshape(2, C)
    J = G * K
    syn = rng.randint(0, C * D, size=(2, C, J)).astype(np.int32)
    slot_rank = np.argsort(rng.rand(2, C, J), -1).argsort(-1)
    perm = np.where(slot_rank < counts[..., None], 0.9,
                    rng.rand(2, C, J) * 0.4).astype(np.float32)
    jcfg, pcfg = make_configs(input_dim=32, column_dim=C, cell_dim=D,
                              active_columns=4, segments_per_column=G,
                              synapse_capacity=K)
    jtab = jsv.make_serving_table(jcfg.tm, _tm(syn, perm))
    ptab = psv.make_serving_table(pcfg.tm, _tm(syn, perm, True))
    np.testing.assert_array_equal(ptab.rows.numpy(), np.asarray(jtab.rows))
    np.testing.assert_array_equal(ptab.ext_col.numpy(),
                                  np.asarray(jtab.ext_col))
    assert tuple(ptab.ext_col.shape) == (2, ext)
    assert ptab.rows.is_contiguous() and ptab.ext_col.is_contiguous()
    assert ptab.rows.shape[1] == C * width // 128 + ext


# ---- (e) the slice end to end ----------------------------------------


SERVE_CFG = dict(SMALL, sp_overrides={"permanence_dtype": "int16"})
B_SERVE, N_TRAIN, N_SERVE, N_LEARN = 3, 40, 11, 9


def _assert_untied(jcfg, sp_state, x, learning):
    """The near-tie check of tests/test_torch_htm.py over SP steps with
    the given learning flags."""
    for t, learn in enumerate(learning):
        duty = np.asarray(sp_state.duty_cycle)
        sp_state, out = _jax_sp_batch(jcfg.sp, sp_state, jnp.asarray(x[t]),
                                      learn)
        assert_no_near_tie(np.asarray(out.boosted_overlaps),
                           np.asarray(out.overlaps), duty,
                           jcfg.sp.active_columns, t)


@pytest.fixture(scope="module")
def trained():
    """A JAX state after N_TRAIN learning steps, with the serve and
    learn sequences that follow it."""
    jcfg, pcfg = make_configs(**SERVE_CFG)
    rng = np.random.RandomState(7)
    pats = rng.rand(5, B_SERVE, 64) < 0.2
    train = pats[np.arange(N_TRAIN) % 5]
    serve = pats[np.arange(N_SERVE) % 5]
    learn = pats[(np.arange(N_LEARN) + 2) % 5]
    state = jax_htm_init_batch(jax.random.key(0), jcfg, B_SERVE)
    state, _ = jax_htm_scan(jcfg, state, jnp.asarray(train), True, 1)
    _assert_untied(jcfg, state.sp, np.concatenate([serve, learn]),
                   [False] * N_SERVE + [True] * N_LEARN)
    return jcfg, pcfg, state, serve, learn


def _copy(jstate):
    return jax.tree.map(jnp.copy, jstate)


def _serve_jax(jcfg, jstate, serve, form):
    x = jnp.asarray(serve)
    if form == "unpacked":
        return jax_htm_serve_scan(jcfg, _copy(jstate), x, 1)
    if form == "packed":
        tab = jsv.make_serving_table(jcfg.tm, jstate.tm)
        return jax_htm_serve_scan(jcfg, _copy(jstate), x, 1,
                                  serving_table=tab)
    fw = jas.pack_frozen_table(jstate.tm.synapse_cell,
                               jstate.tm.synapse_perm,
                               jcfg.tm.permanence_threshold)
    return jax_scan_impl(jcfg, _copy(jstate), x, False, 1, False, True,
                         frozen_word=fw)


def _serve_port(pcfg, jstate, serve, form):
    state = bt.htm_state_from_numpy(jstate, "cpu")
    draws = ReplayDraws(pcfg.tm, copy_keys(jstate.key))
    x = torch.from_numpy(serve)
    if form == "unpacked":
        return bt.htm_serve_scan(pcfg, state, x, draws=draws) + (draws,)
    if form == "packed":
        tab = bt.make_serving_table(pcfg.tm, state.tm)
        return bt.htm_serve_scan(pcfg, state, x, serving_table=tab,
                                 draws=draws) + (draws,)
    fw = bt.pack_frozen_table(state.tm.synapse_cell, state.tm.synapse_perm,
                              pcfg.tm.permanence_threshold,
                              num_cells=pcfg.tm.num_cells)
    return _scan_impl(pcfg, state, x, False, False, True, draws,
                      frozen_word=fw) + (draws,)


@pytest.mark.parametrize("form", ["unpacked", "packed", "frozen"])
def test_serve_scan_matches_jax(trained, form):
    """The port's serving scan equals JAX's in every state leaf (the
    stale ``synapse_act`` / ``matching_word`` of the packed form
    included) and every metric; the packed and frozen forms predict as
    the unpacked one, and the frozen form leaves the same state."""
    jcfg, pcfg, jstate, serve, _ = trained
    jgot, jm = _serve_jax(jcfg, jstate, serve, form)
    pgot, pm, _ = _serve_port(pcfg, jstate, serve, form)
    assert_metrics_equal(jm, pm, form)
    assert_tree_equal(jgot, bt.htm_state_to_numpy(pgot), form)
    assert int(pm["correct"].sum()) > 0
    if form != "unpacked":
        ref, ref_m, _ = _serve_port(pcfg, jstate, serve, "unpacked")
        for k in pm:
            assert torch.equal(pm[k], ref_m[k]), k
        assert torch.equal(pgot.tm.prediction, ref.tm.prediction)
        if form == "frozen":
            assert_tree_equal(jgot, bt.htm_state_to_numpy(ref), "frozen")


def test_port_serving_table_matches_jax_on_trained_state(trained):
    jcfg, pcfg, jstate, _, _ = trained
    jtab = jsv.make_serving_table(jcfg.tm, jstate.tm)
    ptab = bt.make_serving_table(pcfg.tm,
                                 bt.htm_state_from_numpy(jstate, "cpu").tm)
    got = bt.serving_table_to_numpy(ptab)
    np.testing.assert_array_equal(got["rows"], np.asarray(jtab.rows))
    np.testing.assert_array_equal(got["ext_col"], np.asarray(jtab.ext_col))
    assert (got["rows"] >= 0).any()


def test_serve_resume_learn_matches_jax(trained):
    """Packed serve -> `resume_learning` -> learning, with replayed
    draws, equals JAX's in every leaf and metric, and equals the port's
    unpacked serve -> learning (tests/test_serving.py:145-186)."""
    jcfg, pcfg, jstate, serve, learn = trained
    jgot, _ = _serve_jax(jcfg, jstate, serve, "packed")
    jgot = jax_resume_learning(jcfg, jgot)
    jgot, jm = jax_htm_scan(jcfg, jgot, jnp.asarray(learn), True, 1)

    results = []
    for form in ("packed", "unpacked"):
        state, _, draws = _serve_port(pcfg, jstate, serve, form)
        if form == "packed":
            state = bt.resume_learning(pcfg, state)
        results.append(bt.htm_scan(pcfg, state, torch.from_numpy(learn),
                                   True, draws=draws))
    (pgot, pm), (ref, ref_m) = results
    assert_metrics_equal(jm, pm, "resume then learn")
    assert_tree_equal(jgot, bt.htm_state_to_numpy(pgot), "resume then learn")
    assert_tree_equal(jgot, bt.htm_state_to_numpy(ref), "unpacked then learn")
    for k in pm:
        assert torch.equal(pm[k], ref_m[k]), k


def test_resume_learning_noop_on_unserved_state(trained):
    jcfg, pcfg, jstate, _, _ = trained
    state = bt.htm_state_from_numpy(jstate, "cpu")
    want = bt.htm_state_to_numpy(state)
    resumed = bt.resume_learning(pcfg,
                                 bt.htm_state_from_numpy(jstate, "cpu"))
    assert_tree_equal(jstate, bt.htm_state_to_numpy(resumed), "resumed")
    for name in ("synapse_act", "matching_word"):
        np.testing.assert_array_equal(want["tm"][name],
                                      getattr(resumed.tm, name).numpy())


# ---- (f) the contract guards and the dispatch rules ------------------


def test_serving_contract_guards():
    """tests/test_serving.py:211-236 on the port, plus the frozen-word
    guards of `tm_step` (temporal_memory.py:766-776)."""
    cfg = bt.make_htm_config(input_dim=32, column_dim=32, cell_dim=4,
                             active_columns=4, segment_activation_threshold=2,
                             segment_matching_threshold=2,
                             segment_sampling_synapses=4)
    gen = torch.Generator().manual_seed(1)
    state = bt.htm_init_batch(cfg, 2, gen, "cpu")
    tab = bt.make_serving_table(cfg.tm, state.tm)
    assert tuple(tab.rows.shape) == (2, 32, 128)
    assert tuple(tab.ext_col.shape) == (2, 0)
    fw = bt.pack_frozen_table(state.tm.synapse_cell, state.tm.synapse_perm,
                              cfg.tm.permanence_threshold)
    x = torch.zeros((2, 32), dtype=torch.bool)
    cases = [
        ("serving-only", dict(learning=True, serving_table=tab)),
        ("serving-only", dict(learning=False, compute_winner=True,
                              serving_table=tab)),
        ("detailed_metrics", dict(learning=False, compute_winner=False,
                                  detailed_metrics=True, serving_table=tab)),
        ("not both", dict(learning=False, compute_winner=False,
                          detailed_metrics=False, serving_table=tab,
                          frozen_word=fw)),
        ("inference-only", dict(learning=True, frozen_word=fw)),
    ]
    for match, kw in cases:
        with pytest.raises(ValueError, match=match):
            bt.htm_step(cfg, state, x, **kw)
    bad = dataclasses.replace(cfg.tm, segment_matching_threshold=3)
    with pytest.raises(ValueError, match="matching"):
        bt.make_serving_table(bad, state.tm)
    _, m = bt.htm_serve_scan(cfg, state, x[None], serving_table=tab)
    assert "bursting" in m and "tm_pool_occupancy" not in m


def test_serving_dispatch_raises_off_cpu_and_cuda():
    """A `meta` tensor (neither CPU nor CUDA) raises in both new
    dispatchers; nothing falls back to the plain version."""
    C, D, G, A = 16, 4, 4, 3
    rows = torch.zeros((1, C, 128), dtype=torch.int32, device="meta")
    tab = bt.ServingTable(rows, torch.zeros((1, 0), dtype=torch.int32,
                                            device="meta"))
    cols = torch.zeros((1, A), dtype=torch.int32, device="meta")
    bits = torch.zeros((1, A, 1), dtype=torch.int32, device="meta")
    with pytest.raises(RuntimeError, match="not supported"):
        psv.serving_counts(tab, cols, bits, C, D, G)
    with pytest.raises(RuntimeError, match="not supported"):
        pas.synapse_activation_frozen(
            torch.zeros((1, C, 32), dtype=torch.int32, device="meta"), cols,
            bits, D, 8)


def test_serving_cuda_wrappers_reject_cpu_tensors():
    """The new kernel wrappers check their inputs before building or
    launching anything."""
    rng = np.random.RandomState(0)
    cols, _, bits, _ = _active_set(rng, 1, 16, 4, 3)
    cols = torch.from_numpy(cols)
    before = kernels.launch_counts()
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.serving_activation_cuda(
            torch.zeros((1, 16, 128), dtype=torch.int32), cols, bits, 16, 4)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.act_frozen_cuda(torch.zeros((1, 16, 32), dtype=torch.int32),
                                cols, bits, 4, 8)
    assert kernels.launch_counts() == before
