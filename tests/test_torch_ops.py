"""The PyTorch port's config, converter and ops against the JAX package.

Inputs are made with numpy from a seed and go through the JAX function
and its counterpart in the port; results must be equal (bit for bit:
these ops are integer or exact). Batched port ops are compared with the
JAX op vmapped over the stream axis where the JAX op is single-stream.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bithtm_tpu as jb
from bithtm_tpu.models import temporal_memory as jax_tm
from bithtm_tpu.ops import active_set as jas
from bithtm_tpu.ops import overlap as jov
from bithtm_tpu.ops import regularization as jreg

import bithtm_tpu_torch as bt
from bithtm_tpu_torch.models import temporal_memory as ptm
from bithtm_tpu_torch.ops import active_set as pas
from bithtm_tpu_torch.ops import bitops
from bithtm_tpu_torch.ops import overlap as pov
from bithtm_tpu_torch.ops import regularization as preg


def T(x):
    return torch.from_numpy(np.array(x))


def assert_eq(got: torch.Tensor, want, what=""):
    want = np.asarray(want)
    if want.dtype == np.uint32:
        want = want.view(np.int32)
    np.testing.assert_array_equal(got.numpy(), want, err_msg=what)


# ---- config and converter --------------------------------------------

CONFIGS = [
    dict(input_dim=1000, column_dim=2048, cell_dim=32),
    dict(input_dim=1000, column_dim=2048, cell_dim=32, segments_per_column=4,
         synapse_capacity=64, sp_overrides={"permanence_dtype": "int16"}),
    dict(input_dim=64, column_dim=64, cell_dim=4, active_columns=4,
         segment_activation_threshold=2, segment_matching_threshold=2,
         segment_sampling_synapses=8, allocation_policy="reference"),
    dict(input_dim=300, column_dim=16384, cell_dim=64, winner_capacity=96,
         growth_capacity=40),
    # chip_smoke.py's 16K x 64 path: A=328, auto caps Wc=768, L=824
    dict(input_dim=1000, column_dim=16384, cell_dim=64, segments_per_column=4,
         synapse_capacity=64, sp_overrides={"permanence_dtype": "int16"}),
]


@pytest.mark.parametrize("kw", CONFIGS)
def test_config_matches_jax(kw):
    jcfg, pcfg = jb.make_htm_config(**kw), bt.make_htm_config(**kw)
    jd, pd = jb.config_to_dict(jcfg), bt.config_to_dict(pcfg)
    assert pd == jd
    for part in ("sp", "tm"):  # same fields, same order
        assert list(pd[part]) == list(jd[part])
    assert bt.config_from_dict(jd) == pcfg
    for name in ("resolved_winner_capacity", "resolved_growth_capacity",
                 "num_cells", "segment_capacity", "cell_words"):
        assert getattr(pcfg.tm, name) == getattr(jcfg.tm, name), name


@pytest.mark.parametrize("batched", [False, True])
def test_convert_round_trip(batched):
    """JAX state -> port -> numpy is bit-equal, dtypes included; a
    single-stream state becomes a batch of one."""
    jcfg = jb.make_htm_config(**CONFIGS[2])
    if batched:
        jstate = jb.htm_init_batch(jax.random.key(0), jcfg, 3)
    else:
        jstate = jb.htm_init(jax.random.key(0), jcfg)
    # non-trivial leaves: random bit patterns, the high bit of the
    # uint32 words included
    rng = np.random.RandomState(0)

    def rand_like(a):
        a = np.asarray(a)
        if a.dtype == np.uint32:
            return rng.randint(0, 2**32, a.shape, dtype=np.uint64).astype(
                np.uint32)
        if a.dtype == np.float32:
            return rng.randn(*a.shape).astype(np.float32)
        info = np.iinfo(a.dtype)
        return rng.randint(info.min, info.max, a.shape).astype(a.dtype)

    jstate = jstate.replace(
        sp=jax.tree.map(rand_like, jstate.sp),
        tm=jax.tree.map(rand_like, jstate.tm))
    pstate = bt.htm_state_from_numpy(jstate, "cpu")
    assert pstate.batch == (3 if batched else 1)
    back = bt.htm_state_to_numpy(pstate)
    for part in ("sp", "tm"):
        for f in dataclasses.fields(getattr(jstate, part)):
            want = np.asarray(getattr(getattr(jstate, part), f.name))
            got = back[part][f.name]
            if not batched:
                got = got[0]
            assert got.dtype == want.dtype, f.name
            np.testing.assert_array_equal(got, want, err_msg=f.name)
    assert back["tm"]["prediction"].dtype == np.uint32
    assert pstate.tm.prediction.dtype == torch.int32
    # and port -> numpy -> port again
    again = bt.htm_state_from_numpy(back, "cpu")
    for f in dataclasses.fields(again.tm):
        assert torch.equal(getattr(again.tm, f.name),
                           getattr(pstate.tm, f.name))


# ---- bit operations --------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1])
def test_popcount(seed):
    rng = np.random.RandomState(seed)
    w = rng.randint(0, 2**32, size=(7, 33), dtype=np.uint64).astype(
        np.uint32)
    w[0, :4] = [0, 0xFFFFFFFF, 0x80000000, 1]
    assert_eq(bitops.popcount32(T(w.view(np.int32))),
              np.bitwise_count(w).astype(np.int32))
    u8 = rng.randint(0, 256, size=(5, 40)).astype(np.uint8)
    assert_eq(bitops.popcount_u8(T(u8)), np.bitwise_count(u8).astype(
        np.int32))


@pytest.mark.parametrize("s", [0, 1, 9, 17, 31])
def test_logical_shift_and_wrap(s):
    rng = np.random.RandomState(s)
    w = rng.randint(0, 2**32, size=64, dtype=np.uint64).astype(np.uint32)
    w[:2] = [0xFFFFFFFF, 0x80000000]
    assert_eq(bitops.lsr32(T(w.view(np.int32)), s), w >> np.uint32(s))
    wide = rng.randint(-2**40, 2**40, size=64, dtype=np.int64)
    assert_eq(bitops.wrap_u32(T(wide)),
              (wide & 0xFFFFFFFF).astype(np.uint32))


# ---- SP ops ----------------------------------------------------------


OVERLAP_SHAPES = [  # B, C, input_dim
    pytest.param((3, 17, 64), id="64"),
    pytest.param((3, 17, 200), id="200"),
    pytest.param((3, 17, 1000), id="1000"),
    pytest.param((3, 17, 1031), id="1031"),
    # B=1, C off a multiple of 32, and S = 128, 256 and 384 bytes
    (1, 40, 1000),
    (2, 33, 1031),
    (1, 70, 2500),
    (4, 1, 2500),
]


@pytest.mark.parametrize("shape", OVERLAP_SHAPES)
def test_pack_input_and_overlaps(shape):
    """The strided pack and the overlap (the dispatcher on the CPU and
    its plain version `overlaps_ref`, the `sp_overlap` kernel's) equal
    JAX's bit for bit."""
    B, C, input_dim = shape
    rng = np.random.RandomState(input_dim + 7 * B + C)
    x = rng.rand(B, input_dim) < 0.3
    conn = rng.rand(B, C, input_dim) < 0.4
    assert pov.input_words(input_dim) == jov.input_words(input_dim)
    assert pov.padded_input_dim(input_dim) == jov.padded_input_dim(
        input_dim)
    packed = pov.pack_input(T(conn))
    assert_eq(packed, jov.pack_input(jnp.asarray(conn)))
    assert_eq(pov.unpack_connected(packed, input_dim), conn)
    want = jax.vmap(jov.overlaps)(jov.pack_input(jnp.asarray(conn)),
                                  jnp.asarray(x))
    assert_eq(pov.overlaps(packed, T(x)), want)
    assert_eq(pov.overlaps_ref(packed, T(x)), want)


@pytest.mark.parametrize("k", [1, 4, 7])
def test_k_winners_ties_go_to_lowest_index(k):
    """Heavy ties: the port picks the same columns in the same order as
    `lax.top_k` (lowest index first among equals)."""
    rng = np.random.RandomState(k)
    v = rng.randint(0, 4, size=(5, 40)).astype(np.float32)
    v[0] = 1.0  # all tied
    idx, mask = preg.k_winners(T(v), k)
    jidx, jmask = jax.vmap(lambda r: jreg.k_winners(r, k))(jnp.asarray(v))
    assert_eq(idx, jidx)
    assert_eq(mask, jmask)
    assert_eq(idx[0], np.arange(k, dtype=np.int32))


@pytest.mark.parametrize("seed", [0, 1])
def test_boost_agreement_counts_ulps_against_jax(seed):
    """`testing.float_ulps` counts the ulps between float32 values (signed
    zeros 0 apart, across zero the sum of both sides), and
    `testing.boost_agreement`, the card check of ROADMAP fault k, finds
    no difference between the CPU and itself on bench-like duty cycles,
    whose factors lie within 1 ulp of JAX's."""
    from bithtm_tpu_torch.testing import boost_agreement, float_ulps

    def f32(bits):
        # from bit patterns: a float32 literal of a subnormal reads as 0
        # in a process that flushes denormals
        return T(np.array(bits, np.uint32).view(np.float32))

    # 1.0, +0.0, -0.0, 3e-38 and -1e-45, and the next float32 above each
    x = [0x3F800000, 0x00000000, 0x80000000, 0x01234567, 0x80000001]
    up = [0x3F800001, 0x00000001, 0x00000001, 0x01234568, 0x80000000]
    assert float_ulps(f32(up), f32(x)).tolist() == [1, 1, 1, 1, 1]
    assert float_ulps(f32([0x00000000, 0x00000001]),
                      f32([0x80000000, 0x80000001])).tolist() == [0, 2]
    cfg = bt.make_htm_config(1000, 2048, 32).sp
    rng = np.random.default_rng(seed)
    duty = rng.random((8, 2048), dtype=np.float32) * np.float32(
        3 * cfg.density)
    ov = rng.binomial(200, 0.1, (8, 2048)).astype(np.int32)
    got = boost_agreement(T(duty), T(ov), cfg.boosting_intensity,
                          cfg.density, cfg.active_columns, "cpu")
    assert got["ok"] and got["factor_ulps"]["0"] == got["values"], got
    assert got["boosted_ulps"]["0"] == got["values"], got
    assert got["sets_differ"] == got["order_differs"] == 0, got
    factor = preg.boost_factor(T(duty), cfg.boosting_intensity, cfg.density)
    # machine-independent: the float32 argument's exp in float64, rounded
    # once (numpy), which is what the port returns on every device
    arg = np.float32(-(cfg.boosting_intensity / cfg.density)) * duty
    exact = np.exp(arg.astype(np.float64)).astype(np.float32)
    off = float_ulps(factor, T(exact))
    assert int(off.max()) == 0, (
        f"{int((off != 0).sum())} of {off.numel()} factors differ from "
        f"exp rounded once, first at {int(off.flatten().argmax())}")
    # XLA's float32 exp against it (ROADMAP fault g: within 1 ulp)
    want = np.asarray(jreg.boost_factor(jnp.asarray(duty),
                                        cfg.boosting_intensity, cfg.density))
    ulps = float_ulps(factor, T(want))
    at = int(ulps.flatten().argmax())
    hist = {int(u): int(n) for u, n in zip(*np.unique(ulps.numpy(),
                                                      return_counts=True))}
    assert int(ulps.max()) <= 1, (
        f"XLA's exp vs exp rounded once, ulps: {hist}; largest gap "
        f"{int(ulps.max())} at flat index {at}: duty "
        f"{duty.reshape(-1)[at]!r}, XLA {want.reshape(-1)[at]!r}, port "
        f"{factor.reshape(-1)[at].item()!r}")


# ---- active-set ops --------------------------------------------------


@pytest.mark.parametrize("K", [8, 48, 63, 64, 100, 125, 126, 200])
def test_act_scale_dtype_and_pack(K):
    assert pas.act_scale(K) == jas.act_scale(K)
    want_dtype = jnp.dtype(jas.act_dtype(K)).name
    assert str(pas.act_dtype(K)).split(".")[-1] == want_dtype
    rng = np.random.RandomState(K)
    act = rng.rand(4, 50) < 0.5
    conn = act & (rng.rand(4, 50) < 0.5)
    got = pas.pack_act_conn(T(act), T(conn), K)
    want = np.asarray(jas.pack_act_conn(jnp.asarray(act), jnp.asarray(conn),
                                        K)).astype(np.float32)
    np.testing.assert_array_equal(got.to(torch.float32).numpy(), want)


@pytest.mark.parametrize("D", [1, 4, 31, 32, 33, 64, 70])
def test_pack_unpack_bits_and_prediction_words(D):
    rng = np.random.RandomState(D)
    mask = rng.rand(3, 5, D) < 0.5
    mask[0, 0] = True  # bit 31 set: the word is negative as int32
    assert pas.cell_words(D) == jas.cell_words(D)
    packed = pas.pack_bits(T(mask))
    assert_eq(packed, jas.pack_bits(jnp.asarray(mask)))
    assert_eq(pas.unpack_bits(packed, D), mask)
    C, G = 9, 5
    seg_cell = rng.randint(0, D + 1, size=(3, C, G)).astype(np.int32)
    seg_active = rng.rand(3, C, G) < 0.6
    assert_eq(pas.prediction_words(T(seg_cell), T(seg_active), D),
              jas.prediction_words(jnp.asarray(seg_cell),
                                   jnp.asarray(seg_active), D))


def test_column_mask_from_cols():
    rng = np.random.RandomState(0)
    cols = np.stack([rng.choice(50, 7, replace=False) for _ in range(4)])
    cols = cols.astype(np.int32)
    assert_eq(pas.column_mask_from_cols(T(cols), 50),
              jax.vmap(lambda c: jas.column_mask_from_cols(c, 50))(
                  jnp.asarray(cols)))


def to_torch(a: np.ndarray) -> torch.Tensor:
    """A numpy array of JAX's, bfloat16 included (exact through float32)."""
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return T(a)


# K=64: scale 65; 125: the last u8 K; 126, 127: bf16; 128: float32
@pytest.mark.parametrize("G,K", [(4, 64), (8, 48), (3, 7), (2, 125),
                                 (2, 126), (2, 127), (2, 128)])
def test_seg_counts_packed(G, K):
    rng = np.random.RandomState(G * K)
    B, C = 2, 6
    act = rng.rand(B, C, G * K) < 0.5
    conn = act & (rng.rand(B, C, G * K) < 0.4)
    packed = np.asarray(jas.pack_act_conn(jnp.asarray(act),
                                          jnp.asarray(conn), K))
    v = to_torch(packed)
    assert v.dtype == pas.act_dtype(K)
    jpot, jcon = jax.vmap(lambda p: jas.seg_counts_packed(p, G, K))(
        jnp.asarray(packed))
    for fn in (pas.seg_counts_packed, pas.seg_counts_packed_ref):
        pot, con = fn(v, G, K)
        assert_eq(pot, np.asarray(jpot).astype(np.int32))
        assert_eq(con, np.asarray(jcon).astype(np.int32))
    rows = packed.reshape(B, C, G, K)
    rpot, rcon = pas.seg_counts_packed_rows(to_torch(rows), K)
    jrpot, jrcon = jas.seg_counts_packed_rows(jnp.asarray(rows), K)
    assert_eq(rpot, np.asarray(jrpot).astype(np.int32))
    assert_eq(rcon, np.asarray(jrcon).astype(np.int32))


@pytest.mark.parametrize("k", [1, 5, 16, 40])
def test_compact_first_k(k):
    rng = np.random.RandomState(k)
    valid = rng.rand(4, 30) < 0.4
    valid[0] = False
    valid[1] = True
    values = rng.randint(-5, 1000, size=(4, 30)).astype(np.int32)
    out, ok = pas.compact_first_k(T(valid), T(values), k)
    jout, jok = jax.vmap(lambda v, x: jas.compact_first_k(v, x, k))(
        jnp.asarray(valid), jnp.asarray(values))
    assert_eq(out, jout)
    assert_eq(ok, jok)


def test_percell_reductions_and_take():
    rng = np.random.RandomState(3)
    D, G = 5, 6
    seg_cell = rng.randint(0, D + 1, size=(3, 4, G)).astype(np.int32)
    fv = rng.rand(3, 4, G).astype(np.float32)
    iv = rng.randint(0, 9, size=(3, 4, G)).astype(np.int32)
    sc, jsc = T(seg_cell), jnp.asarray(seg_cell)
    assert_eq(pas.percell_max(sc, T(fv), D, 0.0),
              jas.percell_max(jsc, jnp.asarray(fv), D, 0.0))
    assert_eq(pas.percell_sum(sc, T(iv), D),
              jas.percell_sum(jsc, jnp.asarray(iv), D))
    cell_f = rng.rand(3, 4, D).astype(np.float32)
    cell_b = rng.rand(3, 4, D) < 0.5
    assert_eq(pas.take_percell(T(cell_f), sc, D, 0.0),
              jas.take_percell(jnp.asarray(cell_f), jsc, D, 0.0))
    assert_eq(pas.take_percell(T(cell_b), sc, D, False),
              jas.take_percell(jnp.asarray(cell_b), jsc, D, False))


def test_rank_ascending_and_argmax_onehot():
    rng = np.random.RandomState(4)
    mask = rng.rand(3, 4, 20) < 0.5
    assert_eq(pas.rank_ascending(T(mask)),
              jas.rank_ascending(jnp.asarray(mask)))
    v = rng.randint(0, 3, size=(3, 4, 6)).astype(np.float32)  # ties
    got = pas.argmax_onehot(T(v))
    assert_eq(got, jas.argmax_onehot(jnp.asarray(v)))
    assert (got.sum(-1) == 1).all()


# ---- the growth key at 2^16 cells ------------------------------------


def test_growth_key_sentinel_does_not_collide():
    """At 2048 x 32 the largest valid growth key is 0x7FFFFFFF (random
    bits all ones above cell 65535). The JAX step sorts uint32 keys
    against the sentinel 0xFFFFFFFF; in int32 that sentinel is -1 and
    would sort first. The port sorts int64 keys and must choose exactly
    what the JAX selection chooses."""
    cell_bits = 16
    assert ((0xFFFFFFFF >> (cell_bits + 1)) << cell_bits) | 65535 \
        == 0x7FFFFFFF
    L, Wc, K, samp = 2, 6, 8, 4
    cand = np.array([3, 70, 9000, 65535, 12, 40000], np.int32)
    rnd = np.array([[0x12345678, 0x9ABCDEF0, 0x0F0F0F0F, 0xFFFFFFFF,
                     0x7FFFFFFF, 0x00000001],
                    [0xFFFFFFFF, 0xFFFFFFFE, 0, 0x80000000, 0xC0000000,
                     0xFFFF0000]], np.uint32)
    valid = np.array([[True, False, True, True, False, True],
                      [False, True, True, True, True, False]])
    ukey = ((rnd >> np.uint32(cell_bits + 1)) << np.uint32(cell_bits)) \
        | cand.astype(np.uint32)
    assert ukey[0, 3] == 0x7FFFFFFF
    jkey = np.where(valid, ukey, np.uint32(0xFFFFFFFF))
    free = np.array([[True, False, True, True, True, False, True, True],
                     [False, True, True, False, True, True, True, True]])
    n_grow = np.array([4, 3], np.int32)
    jg, jw, jn = jax_tm._select_and_fill(
        jnp.asarray(jkey), jnp.asarray(n_grow), jnp.asarray(cand),
        jnp.asarray(free), samp, "sortfill_packed_cell",
        idx_bits=cell_bits)
    pkey = ((bitops.lsr32(T(rnd.view(np.int32)), cell_bits + 1).long()
             << cell_bits) | T(cand).long())
    pg, pw, pn = ptm._select_and_fill(pkey[None], T(valid)[None],
                                      T(n_grow)[None], T(free)[None], samp,
                                      cell_bits)
    assert_eq(pn[0], jn)
    assert_eq(pw[0], jw)
    jw = np.asarray(jw)
    assert_eq(pg[0][pw[0]], np.asarray(jg)[jw])
    assert 65535 in pg[0][pw[0]].tolist()
    # what an int32 sort of the same keys would have done
    s32 = np.sort(jkey.view(np.int32), axis=-1)
    assert s32[0, 0] == -1


@pytest.mark.parametrize("threads", ["one", "worker"])
@pytest.mark.parametrize("flush", [False, True],
                         ids=["denormals", "flush_denormal"])
def test_boost_factor_is_exp_rounded_once_whatever_the_threads(threads,
                                                                flush):
    """ROADMAP fault g: the CPU factor is numpy's float64 `exp` of the
    float32 argument rounded once, bit for bit, under one thread and
    under the worker's count, with and without denormal flushing, at
    sizes that leave vector tails, 20 calls each. This holds the CPU
    path to its routing; `test_boost_agreement_counts_ulps_against_jax`
    holds the factor to JAX."""
    cfg = bt.make_htm_config(1000, 2048, 32).sp
    rng = np.random.default_rng(17)
    scale = np.float32(-(cfg.boosting_intensity / cfg.density))
    cases = []
    for size in (2047, 2048, 16383):
        duty = rng.random(size, dtype=np.float32) * np.float32(
            3 * cfg.density)
        exact = np.exp((scale * duty).astype(np.float64)).astype(np.float32)
        cases.append((duty, exact.view(np.uint32)))
    workers = torch.get_num_threads()
    try:
        torch.set_num_threads(1 if threads == "one" else workers)
        torch.set_flush_denormal(flush)
        for duty, want in cases:
            for call in range(20):
                got = preg.boost_factor(T(duty), cfg.boosting_intensity,
                                        cfg.density).numpy().view(np.uint32)
                assert np.array_equal(got, want), (
                    f"{int((got != want).sum())} of {want.size} factors "
                    f"differ at call {call}")
    finally:
        torch.set_num_threads(workers)
        torch.set_flush_denormal(False)


@pytest.mark.parametrize("K", [126, 128])
def test_convert_carries_wide_packed_activity(K):
    """At K=126 (bf16 activity) and K=128 (float32): a JAX state's
    `synapse_act` becomes the port's leaf of `act_dtype(K)` with the same
    values, and back through numpy (float32, numpy having no bf16) it
    converts to the same port state again."""
    jcfg = jb.make_htm_config(64, 64, 4, active_columns=4,
                              segments_per_column=2, synapse_capacity=K)
    jstate = jb.htm_init_batch(jax.random.key(0), jcfg, 2)
    rng = np.random.RandomState(K)
    scale = pas.act_scale(K)
    act = rng.choice([0, 1, 1 + scale], size=jstate.tm.synapse_act.shape)
    jstate = jstate.replace(tm=jstate.tm.replace(
        synapse_act=jnp.asarray(act, jstate.tm.synapse_act.dtype)))
    pstate = bt.htm_state_from_numpy(jstate, "cpu")
    assert pstate.tm.synapse_act.dtype == pas.act_dtype(K)
    np.testing.assert_array_equal(pstate.tm.synapse_act.float().numpy(),
                                  act)
    back = bt.htm_state_from_numpy(bt.htm_state_to_numpy(pstate), "cpu")
    assert back.tm.synapse_act.dtype == pas.act_dtype(K)
    assert torch.equal(back.tm.synapse_act, pstate.tm.synapse_act)
