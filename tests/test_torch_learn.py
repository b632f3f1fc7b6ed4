"""The port's learning pass over the active rows (`row_counts_ref`,
`learn_rows_ref`, and through them `_learn`) and the flags form of the
count decode (`seg_counts_flags_ref`) against the JAX package, on the
CPU.

`_learn` runs on one state converted from a JAX state that the JAX step
has learned, with JAX's own decisions and draws (the winner selection's
outputs and the growth's random words from the same keys), so every
comparison is exact: the synapse tables, the owners, every metric and
the debug masks. Then the argument that lets `grow_select` read the rows
before the learning pass: its selection on the raw rows, new segments
empty, equals its selection on the rows the pass updates. The kernels
themselves run only on the card (`tests/test_torch_cuda.py`,
`chip_smoke.py` `check_grow_and_pack`). One intra-op thread, as the
scripts' tests: the test runner's workers share the cores.
"""

import ctypes
import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bithtm_tpu import TMConfig as JaxTMConfig
from bithtm_tpu.models import temporal_memory as jax_tm
from bithtm_tpu.models.temporal_memory import tm_step as jax_tm_step
from bithtm_tpu.ops import active_set as jas
from bithtm_tpu.state import tm_init as jax_tm_init

import bithtm_tpu_torch as bt
from bithtm_tpu_torch import testing
from bithtm_tpu_torch.convert import _leaf_to_torch
from bithtm_tpu_torch.models import temporal_memory as ptm
from bithtm_tpu_torch.ops import active_set as pas
from bithtm_tpu_torch.ops import kernels
from bithtm_tpu_torch.rng import Draws
from bithtm_tpu_torch.state import TMState

B = 2


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# name: (config overrides on `testing.FUZZ_BASE`, warm-up steps, the
# period of a repeating sequence of columns or None for random columns):
# both allocation policies, G = 1-2, K = 125-128 (u8, bf16, float32
# activity), D off the 32-bit word, and the index-form growth keys above
# 2^16 cells
LEARN_CASES = {
    "recycle_G1_K125": (dict(segments_per_column=1, synapse_capacity=125,
                             segment_sampling_synapses=6), 40, None),
    "evict_G2_K126": (dict(segments_per_column=2, synapse_capacity=126,
                           segment_sampling_synapses=6,
                           allocation_policy="evict"), 40, None),
    "recycle_G2_K127": (dict(segments_per_column=2, synapse_capacity=127,
                             segment_sampling_synapses=6), 40, None),
    "evict_G1_K128": (dict(segments_per_column=1, synapse_capacity=128,
                           segment_sampling_synapses=6,
                           allocation_policy="evict"), 40, None),
    "evict_G2_D33": (dict(cell_dim=33, segments_per_column=2,
                          allocation_policy="evict", synapse_capacity=9,
                          segment_sampling_synapses=3), 60, None),
    # 1025 x 64 = 65,600 cells; a sequence of 5 column sets recurs, so
    # its segments are reinforced and still grow
    "index_form": (dict(column_dim=1025, cell_dim=64, active_columns=40,
                        segments_per_column=2, synapse_capacity=16), 12, 5),
}


def jax_learned_state(jcfg, cfg, steps: int, seed: int, period=None):
    """B streams of the JAX step learned over ``steps`` steps of random
    columns (`testing.fuzz_cols`; with ``period``, a sequence of that
    many column sets, repeated), and the next step's keys and columns."""
    state = jax.tree.map(lambda x: jnp.stack([x] * B), jax_tm_init(jcfg))
    step = jax.jit(jax.vmap(lambda s, k, c: jax_tm_step(jcfg, s, k, c)[0]))
    rng = np.random.RandomState(seed)
    key = jax.random.PRNGKey(seed)
    sequence = [testing.fuzz_cols(cfg, B, rng) for _ in range(period or 0)]
    for t in range(steps + 1):
        key, sub = jax.random.split(key)
        keys = jax.random.split(sub, B)
        cols = (sequence[t % period] if period
                else testing.fuzz_cols(cfg, B, rng))
        if t < steps:
            state = step(state, keys, cols)
    return state, keys, cols


def port_tm_state(jstate) -> TMState:
    """The port's TMState of a batched JAX TMState, on the CPU (the
    packed activity in the port's type)."""
    tm = TMState(**{f.name: _leaf_to_torch(f.name, getattr(jstate, f.name),
                                           True, "cpu")
                    for f in dataclasses.fields(TMState)})
    G = tm.seg_cell.shape[-1]
    K = tm.synapse_act.shape[-1] // G
    return dataclasses.replace(tm, synapse_act=tm.synapse_act.to(
        pas.act_dtype(K)))


@pytest.mark.parametrize("case", LEARN_CASES)
def test_learn_matches_jax(case):
    """The port's column decisions and `_learn` (`row_counts_ref`,
    `column_decide_ref`, then `grow_select_ref` on the rows where they lie
    and `learn_rows_ref` in place) against JAX `_winner_selection` and
    `_learn` on one learned state, with JAX's draws: the port's winner
    selection on `row_counts`' potential equals JAX's; `column_decide_ref`
    gives JAX's bursting columns, the JAX `pack_bits` of its winner and
    active cells, their counts, and (through `_allocate` and `_learn`'s
    flags) its owners, learning and new segments and their metrics; then
    the synapse tables (permanences bit for bit), every metric and the
    debug masks equal."""
    overrides, steps, period = LEARN_CASES[case]
    cfg = testing.fuzz_config(**overrides)
    jcfg = JaxTMConfig(**dataclasses.asdict(cfg))
    jstate, keys, cols = jax_learned_state(jcfg, cfg, steps,
                                           testing.fuzz_seed(case), period)
    C, D, G = cfg.column_dim, cfg.cell_dim, cfg.segments_per_column
    L, Wc = cfg.resolved_growth_capacity, cfg.resolved_winner_capacity

    def jax_one(s, key, c):
        c = jnp.sort(c)
        k_select, k_grow = jax.random.split(key)
        pred_rows = jas.unpack_bits(jnp.swapaxes(
            jnp.take(s.prediction, c, axis=-1), -1, -2), D)
        col_active = jas.column_mask_from_cols(c, C)
        sel = jax_tm._winner_selection(jcfg, s, k_select, c, pred_rows)
        learned = jax_tm._learn(jcfg, s, k_grow, c, col_active, pred_rows,
                                *sel[1:])
        k_seg, k_least = jax.random.split(k_select)
        draws = (jax.random.uniform(k_seg, (cfg.active_columns, G)),
                 jax.random.uniform(k_least, (cfg.active_columns, D)),
                 jax.random.bits(k_grow, (L, Wc), jnp.uint32))
        return pred_rows, sel, learned, draws

    pred_rows, sel, learned, draws = jax.device_get(
        jax.jit(jax.vmap(jax_one))(jstate, keys, cols))
    syn_full, perm_full, seg_cell, metrics, debug = learned
    col_burst, winner_rows = np.asarray(sel[0]), np.asarray(sel[1])
    act_rows = np.asarray(pred_rows) | col_burst[..., None]

    state = port_tm_state(jstate)
    t = torch.from_numpy
    active = torch.sort(t(cols), dim=-1).values
    pred = t(np.array(pred_rows))
    draw = Draws(*(t(np.array(d)) for d in draws[:2]),
                 t(np.array(draws[2]).view(np.int32)))
    pot, conn, live = ptm.row_counts(state.synapse_cell, state.synapse_perm,
                                     state.synapse_act, active, G)
    segcell_rows = ptm._rows(state.seg_cell, active)
    winner = ptm._winner_selection(cfg, draw, pred, pot, segcell_rows)
    for got, want in zip(winner, sel):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    before = kernels.launch_counts()
    dec = ptm.column_decide_ref(cfg, state.prediction, state.seg_cell,
                                active, pot, conn, live, draw, state.step,
                                "learn")
    np.testing.assert_array_equal(dec.col_burst.numpy(), col_burst)
    for got, rows in ((dec.winner_bits, winner_rows),
                      (dec.act_bits, act_rows)):
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(jas.pack_bits(jnp.asarray(rows))).view(
                np.int32))
    np.testing.assert_array_equal(
        dec.counts[:3].numpy(),
        [col_burst.sum(-1), act_rows.sum((1, 2)), winner_rows.sum((1, 2))])
    tables = (state.synapse_cell, state.synapse_perm, state.synapse_act,
              active)
    got_metrics, got_debug = ptm._learn(
        cfg, state, tables, ptm._put_rows, draw, active, dec,
        return_debug=True)
    assert kernels.launch_counts() == before
    np.testing.assert_array_equal(state.synapse_cell.numpy(), syn_full)
    np.testing.assert_array_equal(state.synapse_perm.numpy().view(np.int32),
                                  np.asarray(perm_full).view(np.int32))
    np.testing.assert_array_equal(state.seg_cell.numpy(), seg_cell)
    assert set(got_metrics) == set(metrics)
    for k, v in metrics.items():
        np.testing.assert_array_equal(got_metrics[k].numpy(), v, err_msg=k)
    for k in ("learning_segments", "new_segments", "grown_mask"):
        np.testing.assert_array_equal(
            got_debug[k].numpy().reshape(np.asarray(debug[k]).shape),
            debug[k], err_msg=k)
    assert int(metrics["tm_grown_synapses"].sum()) > 0
    assert int(metrics["tm_learning_segments"].sum()) > int(
        metrics["tm_new_segments"].sum()) > 0


@pytest.mark.parametrize("case", ["evict_G2_K126", "index_form"])
def test_learn_on_gathered_rows_matches_the_tables(case):
    """`_learn` on rows gathered from the tables (a column shard's mode:
    `learn_rows` and `grow_select` with no columns, the rows written back
    by ``put``) equals `_learn` at the columns of the tables: the same
    tables, owners, metrics and masks."""
    overrides, steps, period = LEARN_CASES[case]
    cfg = testing.fuzz_config(**overrides)
    jcfg = JaxTMConfig(**dataclasses.asdict(cfg))
    jstate, _, cols = jax_learned_state(jcfg, cfg, steps,
                                        testing.fuzz_seed(case), period)
    G, L, Wc = (cfg.segments_per_column, cfg.resolved_growth_capacity,
                cfg.resolved_winner_capacity)
    active = torch.sort(torch.from_numpy(cols), dim=-1).values
    gen = torch.Generator().manual_seed(7)
    A, D = cfg.active_columns, cfg.cell_dim
    draw = Draws(torch.rand((B, A, G), generator=gen),
                 torch.rand((B, A, D), generator=gen),
                 torch.randint(-(1 << 31), 1 << 31, (B, L, Wc),
                               generator=gen, dtype=torch.int64).to(
                                   torch.int32))
    out = []
    for gathered in (False, True):
        state = port_tm_state(jstate)
        tables = (state.synapse_cell, state.synapse_perm, state.synapse_act)
        pred, owners, where = state.prediction, state.seg_cell, active
        if gathered:
            tables = (*(ptm._rows(x, active) for x in tables), None)
            pred = state.prediction.gather(2, active.long()[:, None, :].expand(
                B, state.prediction.shape[1], A))
            owners, where = ptm._rows(state.seg_cell, active), None
        else:
            tables = (*tables, active)
        pot, conn, live = ptm.row_counts(*tables, G)
        dec = ptm.column_decide(cfg, pred, owners, where, pot, conn, live,
                                draw, state.step, "learn")
        res = ptm._learn(cfg, state, tables, ptm._put_rows, draw, active,
                         dec, return_debug=True)
        if gathered:
            ptm._put_rows(state.seg_cell, active, owners)
        out.append((state.synapse_cell, state.synapse_perm.view(torch.int32),
                    state.seg_cell, res[0], res[1], dec))
    (s1, p1, c1, m1, d1, e1), (s2, p2, c2, m2, d2, e2) = out
    assert torch.equal(s1, s2) and torch.equal(p1, p2)
    assert torch.equal(c1, c2)
    assert all(torch.equal(m1[k], m2[k]) for k in m1)
    assert all(torch.equal(d1[k], d2[k]) for k in d1)
    assert all(torch.equal(a, b) for a, b in zip(e1, e2))
    assert int(m1["tm_grown_synapses"].sum()) > 0


# B, C, D, A, G, K, Wc, L, samp of the argument's states: the bench
# geometry, samp = K, G = 1-8, K = 125-128, D = 33 and the index form
ARG_GEOMS = [(3, 2048, 32, 41, 4, 64, 128, 88, 32),
             (3, 2048, 32, 41, 2, 32, 128, 88, 32),
             (2, 512, 8, 16, 8, 48, 128, 64, 32),
             (2, 600, 33, 20, 1, 125, 200, 20, 6),
             (2, 600, 5, 20, 2, 126, 60, 40, 127),
             (2, 600, 7, 20, 2, 128, 60, 40, 6),
             (2, 4096, 32, 41, 2, 16, 200, 40, 16)]


@pytest.mark.parametrize("geo", ARG_GEOMS)
def test_grow_select_reads_the_rows_before_the_pass(geo):
    """The argument that lets `grow_select` read its rows where they lie,
    before the learning pass: on seeded states with stale slots, slots a
    decrement kills, +-0.0 and new segments (`testing.learn_inputs`, whose
    activity is the table pass's: a stale slot inactive, every live slot
    that targets a previous winner active), `grow_select_ref` on the raw
    rows, new segments empty, equals `grow_select_ref` on the rows after
    `learn_rows_ref`'s cleanup, reset, update and death (no row in the
    list, so nothing grows), in every output, chosen included."""
    x = testing.learn_inputs(sum(geo), *geo)
    s = x["select"]
    raw = ptm.grow_select_ref(**s)
    syn, perm = s["syn_rows"].clone(), x["perm"].clone()
    counts = raw.counts.clone()
    ptm.learn_rows_ref(syn, perm, s["act_rows"], x["cols"], x["learn"],
                       x["new_seg"], torch.full_like(raw.lpos, -1),
                       raw.chosen, raw.n_chosen, counts, x["increment"],
                       x["decrement"], x["permanence_initial"])
    assert torch.equal(counts, raw.counts)          # nothing grew
    updated = ptm.grow_select_ref(**{**s, "syn_rows": syn, "new_seg": None})
    for got, want in zip(raw, updated):
        assert torch.equal(got, want)
    # the states hold what the argument is about
    rows = ptm._active_rows(s["syn_rows"], x["cols"], x["learn"].shape[1])
    after = ptm._active_rows(syn, x["cols"], x["learn"].shape[1])
    stale = (ptm._active_rows(x["perm"], x["cols"], x["learn"].shape[1])
             < 0) & (rows >= 0)
    died = (rows >= 0) & (after < 0) & ~stale & ~x["new_seg"][..., None]
    assert bool(stale.any()) and bool(died.any())
    assert bool(x["new_seg"].any()) and int(raw.n_chosen.sum()) > 0


# B, C, G, K, D of the flags form's plain version against JAX
FLAG_CASES = [(2, 40, 4, 64, 32), (2, 30, 8, 48, 8), (2, 25, 1, 125, 33),
              (2, 25, 2, 126, 48), (2, 25, 3, 127, 5), (2, 20, 2, 128, 64),
              (2, 20, 32, 4, 70)]


@pytest.mark.parametrize("shape", FLAG_CASES)
def test_seg_counts_flags_ref_matches_jax(shape):
    """The flags form's plain version (and its dispatcher on the CPU):
    the matching word equals `pack_bits_ref` of the matching flags and
    JAX `pack_bits`, the prediction words equal `prediction_words` and
    JAX `prediction_words`; asked for no prediction, it gives the same
    word alone; nothing launches."""
    Bf, C, G, K, D = shape
    rng = np.random.default_rng(sum(shape))
    act = rng.random((Bf, C, G * K)) < 0.5
    conn = act & (rng.random((Bf, C, G * K)) < 0.4)
    v = pas.pack_act_conn(torch.from_numpy(act), torch.from_numpy(conn), K)
    seg_cell = torch.from_numpy(rng.integers(0, D + 1, (Bf, C, G),
                                             dtype=np.int32))
    th = (K // 2, K // 5)
    pot, con = pas.seg_counts_packed_ref(v, G, K)
    matching = pot >= th[0]
    active = matching & (con >= th[1])
    before = kernels.launch_counts()
    for fn in (pas.seg_counts_flags_ref, pas.seg_counts_flags):
        word, pred = fn(v, seg_cell, K, *th, D)
        assert torch.equal(word, pas.pack_bits_ref(matching)[..., 0])
        assert torch.equal(pred, pas.prediction_words(seg_cell, active, D))
        alone, none = fn(v, seg_cell, K, *th, D, prediction=False)
        assert none is None and torch.equal(alone, word)
    assert kernels.launch_counts() == before
    jword = np.asarray(jas.pack_bits(jnp.asarray(matching.numpy())))
    np.testing.assert_array_equal(word.numpy(), jword[..., 0].view(np.int32))
    jpred = jax.vmap(lambda s, a: jas.prediction_words(s, a, D))(
        jnp.asarray(seg_cell.numpy()), jnp.asarray(active.numpy()))
    np.testing.assert_array_equal(pred.numpy(),
                                  np.asarray(jpred).view(np.int32))
    assert bool(matching.any()) and bool(active.any())


@pytest.mark.parametrize("case", ["D33_W2_minimal", "K127_last_bf16",
                                  "D7_G2_evict"])
def test_step_words_match_jax_leaves(case):
    """A learning step's `matching_word` and `prediction` leaves (the
    flags form after the table pass) and an inference step's (after
    `act_conn`) equal the JAX step's on the same state, columns and
    draws; `tm_resume`'s matching word equals JAX `tm_resume`'s."""
    overrides = dict(next(c[1] for c in testing.FUZZ_CASES if c[0] == case))
    cfg = testing.fuzz_config(**overrides)
    jcfg = JaxTMConfig(**dataclasses.asdict(cfg))
    jstate, keys, cols = jax_learned_state(jcfg, cfg, 30,
                                           testing.fuzz_seed(case))
    L, Wc = cfg.resolved_growth_capacity, cfg.resolved_winner_capacity
    A, D, G = cfg.active_columns, cfg.cell_dim, cfg.segments_per_column

    def jax_draws(key):
        k_select, k_grow = jax.random.split(key)
        k_seg, k_least = jax.random.split(k_select)
        return (jax.random.uniform(k_seg, (A, G)),
                jax.random.uniform(k_least, (A, D)),
                jax.random.bits(k_grow, (L, Wc), jnp.uint32))

    draws = [np.array(d) for d in jax.vmap(jax_draws)(keys)]
    draw = Draws(torch.from_numpy(draws[0]), torch.from_numpy(draws[1]),
                 torch.from_numpy(draws[2].view(np.int32)))
    for learning in (True, False):
        want = jax.device_get(jax.jit(jax.vmap(
            lambda s, k, c: jax_tm_step(jcfg, s, k, c, learning)[0]))(
                jstate, keys, cols))
        got, _ = bt.tm_step(cfg, port_tm_state(jstate), draw,
                            torch.from_numpy(cols), learning)
        np.testing.assert_array_equal(got.matching_word.numpy(),
                                      np.asarray(want.matching_word))
        np.testing.assert_array_equal(
            got.prediction.numpy(), np.asarray(want.prediction).view(
                np.int32))
    resumed = jax.device_get(jax.vmap(
        lambda s: jax_tm.tm_resume(jcfg, s))(jstate))
    got = ptm.tm_resume(cfg, port_tm_state(jstate))
    np.testing.assert_array_equal(got.matching_word.numpy(),
                                  np.asarray(resumed.matching_word))


def test_entry_points_take_what_ctypes_passes():
    """Each C entry point's parameters, by type, are its ctypes argument
    types: a pointer as c_void_p, an int as c_int, a float as c_float, a
    long long as c_longlong (a wrong type would cut a pointer or pass a
    float as bits, which no count of arguments shows)."""
    every = "".join((kernels.CSRC / n).read_text() for n in kernels.SOURCES)

    def ctype(param: str):
        kind = param.strip().rsplit(None, 1)[0]
        if "*" in param:
            return ctypes.c_void_p
        return {"int": ctypes.c_int, "float": ctypes.c_float,
                "long long": ctypes.c_longlong}[kind.replace("const ", "")]

    for name, argtypes in kernels._ARGTYPES.items():
        params = re.search(rf'extern "C" int {name}\(([^)]*)\)',
                           every).group(1).split(",")
        assert [ctype(p) for p in params] == argtypes, name
    assert {"row_counts", "learn_rows"} <= set(kernels._ARGTYPES)
    assert "grow_fill" not in kernels._ARGTYPES


def test_learn_step_gathers_no_synapse_rows():
    """An unsharded learning step reads the active rows where they lie:
    outside the kernels' plain versions (`row_counts`, `column_decide`,
    `grow_select` and `learn_rows`, which stand for kernels that read and
    write the tables in place), no (B, A, G*K) row copy of
    `synapse_cell` or `synapse_perm` is gathered or scattered back, and
    no (B, A, G) row copy of the owners (`column_decide` reads them and
    writes the new ones in place)."""
    cfg = testing.fuzz_config()
    state = bt.tm_init(cfg, B, "cpu")
    draws = bt.TorchDraws(cfg, B, "cpu", torch.Generator().manual_seed(1))
    rng = np.random.RandomState(1)
    seen, inside = [], []
    real = {n: getattr(ptm, n) for n in ("_rows", "_put_rows", "row_counts",
                                         "column_decide", "grow_select",
                                         "learn_rows")}

    def record(what):
        def call(table, *args):
            if not inside:
                seen.append((what, tuple(table.shape), table.dtype))
            return real[what](table, *args)
        return call

    def kernel(name):
        def call(*args, **kw):
            inside.append(name)
            try:
                return real[name](*args, **kw)
            finally:
                inside.pop()
        return call

    J = cfg.segments_per_column * cfg.synapse_capacity
    for name in ("_rows", "_put_rows"):
        setattr(ptm, name, record(name))
    for name in ("row_counts", "column_decide", "grow_select", "learn_rows"):
        setattr(ptm, name, kernel(name))
    try:
        for _ in range(6):
            cols = torch.from_numpy(testing.fuzz_cols(cfg, B, rng))
            state, out = bt.tm_step(cfg, state, draws.step(), cols, True)
    finally:
        for name, fn in real.items():
            setattr(ptm, name, fn)
    assert not [s for s in seen if s[1][-1] == J], seen
    owners = ((B, cfg.column_dim, cfg.segments_per_column), torch.int32)
    assert not [s for s in seen if s[1:] == owners], seen
    assert inside == [] and seen
    assert int(out.metrics["tm_grown_synapses"].sum()) > 0


# ---- `learn_rows`' paths, emulated in numpy (csrc/learn_pass.cu)

def _row_pass(s, p, a, learn_r, empty_r):
    """The update and death of slots (numpy, float32), as the kernel
    orders them: stale or a new segment's slots emptied, perm += (learn
    & live) * delta, live slots with perm < 0 killed."""
    s, p = s.copy(), p.astype(np.float32)
    gone = (p < 0) | empty_r
    s, p = np.where(gone, -1, s), np.where(gone, np.float32(-1), p)
    live = s >= 0
    delta = np.where(a, np.float32(0.1), np.float32(-0.05))
    p = (p + (learn_r & live).astype(np.float32) * delta).astype(np.float32)
    dead = live & (p < 0)
    return np.where(dead, -1, s), np.where(dead, np.float32(-1), p)


def emulate_learn_rows(x: dict, sel) -> tuple:
    """`learn_rows` on `testing.learn_inputs` ``x`` and its selection
    ``sel`` (cell form), the kernel's way, column by column: the "v16"
    path (u8, K a multiple of 8) in rounds of 256 slots, 8 a lane, each
    free slot ranked by the lane's exclusive count within its row (a scan
    over the lanes, the row's first lane subtracted, plus the row's
    count carried from the round before) and the popcount of the lane's
    free slots before it; else the "scalar" path, a row at a time in
    32-slot chunks ranked by ballots, the row's last chunk cut at K.
    Returns (syn, perm bits, the grown mask (B, R, K), counts)."""
    s = x["select"]
    syn = s["syn_rows"].numpy().copy()
    perm = x["perm"].numpy().copy()
    act = (s["act_rows"] != 0).numpy()
    cols = x["cols"].numpy()
    learn, fresh = x["learn"].numpy(), x["new_seg"].numpy()
    lpos, chosen = sel.lpos.numpy(), sel.chosen.numpy()
    n_chosen = sel.n_chosen.numpy()
    counts = sel.counts.numpy().copy()
    Bn, _, J = syn.shape
    R = learn.shape[1]
    A = cols.shape[1]
    G = R // A
    K = J // G
    v16 = s["act_rows"].dtype == torch.uint8 and K % 8 == 0
    assert v16 == (kernels._learn_loads(K) == "v16")
    wrote = np.zeros((Bn, R, K), bool)
    x_inc = np.float32(x["increment"])
    assert x_inc == np.float32(0.1) and np.float32(x["decrement"]) == \
        np.float32(0.05)
    for b in range(Bn):
        for a in range(A):
            c = cols[b, a]
            rows = a * G + np.arange(G)
            l = lpos[b, rows]
            n = np.where(l >= 0, n_chosen[b, np.maximum(l, 0)], 0)
            s0, p0 = syn[b, c].copy(), perm[b, c].copy()
            s1, p1 = s0.copy(), p0.copy()
            grew = np.zeros(J, bool)
            free_total = np.zeros(G, np.int64)
            if v16:
                carry, carry_row = 0, -1
                for k0 in range(0, J, 256):
                    k = k0 + 8 * np.arange(32)
                    inn = k < J
                    g = np.where(inn, k // K, 0)
                    slots = np.minimum(k[:, None] + np.arange(8), J - 1)
                    ns, npm = _row_pass(s0[slots], p0[slots],
                                        act[b, c][slots],
                                        learn[b, rows][g][:, None],
                                        fresh[b, rows][g][:, None])
                    free = (ns < 0) & inn[:, None]
                    cnt = free.sum(1)
                    excl = np.cumsum(cnt) - cnt
                    start = np.where(g * K > k0, (g * K - k0) // 8, 0)
                    rank0 = excl - excl[start] + np.where(g == carry_row,
                                                          carry, 0)
                    last = min(31, (J - k0) // 8 - 1)
                    carry, carry_row = rank0[last] + cnt[last], g[last]
                    ends = inn & (k + 8 == (g + 1) * K)
                    free_total[g[ends]] = rank0[ends] + cnt[ends]
                    fr = rank0[:, None] + np.cumsum(free, 1) - free
                    grow = free & (fr < n[g][:, None])
                    cells = chosen[b, np.maximum(l[g], 0)[:, None],
                                   np.minimum(fr, chosen.shape[2] - 1)]
                    ns = np.where(grow, cells, ns)
                    npm = np.where(grow, np.float32(x["permanence_initial"]),
                                   npm)
                    at = slots[inn]
                    s1[at], p1[at] = ns[inn], npm[inn]
                    grew[at] = grow[inn]
            else:
                for gi in range(G):
                    ranked = 0
                    for k0 in range(0, K, 32):
                        k = k0 + np.arange(32)
                        inn = k < K
                        at = gi * K + np.minimum(k, K - 1)
                        ns, npm = _row_pass(s0[at], p0[at], act[b, c][at],
                                            learn[b, rows[gi]],
                                            fresh[b, rows[gi]])
                        free = (ns < 0) & inn
                        fr = ranked + np.cumsum(free) - free
                        ranked += int(free.sum())
                        grow = free & (fr < n[gi])
                        cells = chosen[b, max(l[gi], 0),
                                       np.minimum(fr, chosen.shape[2] - 1)]
                        ns = np.where(grow, cells, ns)
                        npm = np.where(grow,
                                       np.float32(x["permanence_initial"]),
                                       npm)
                        s1[at[inn]], p1[at[inn]] = ns[inn], npm[inn]
                        grew[at[inn]] = grow[inn]
                    free_total[gi] = ranked
            syn[b, c], perm[b, c] = s1, p1
            wrote[b, rows] = grew.reshape(G, K)
            counts[ptm.N_GROWN, b] += int(np.where(
                l >= 0, np.minimum(free_total, n), 0).sum())
            counts[ptm.OVERFLOW, b] += int(np.maximum(
                n - free_total, 0).sum())
    return syn, perm.view(np.int32), wrote, counts


# B, C, D, A, G, K, Wc, L, samp: the bench (one round a column), the
# reference stack's G = 8, K = 48 (rows across two rounds), G = 32 of K =
# 8 (a lane a row), and the tails of the scalar path at K = 125 (u8) and
# 127 (bf16)
EMULATED_GEOMS = [(2, 2048, 32, 41, 4, 64, 128, 88, 32),
                  (2, 2048, 32, 41, 8, 48, 128, 88, 32),
                  (2, 1024, 32, 20, 32, 8, 128, 88, 8),
                  (2, 2048, 32, 20, 2, 125, 128, 88, 32),
                  (2, 2048, 32, 20, 2, 127, 128, 88, 32)]


@pytest.mark.parametrize("geo", EMULATED_GEOMS)
def test_learn_rows_paths_match_the_plain_version(geo):
    """`emulate_learn_rows` (the kernel's vector path where the wrapper
    takes it, else its scalar path) against `learn_rows_ref` on
    `testing.learn_inputs` and its selection: the tables bit for bit,
    the mask of the slots grown and the counts."""
    x = testing.learn_inputs(sum(geo), *geo)
    x["increment"], x["decrement"] = 0.1, 0.05
    s = x["select"]
    sel = ptm.grow_select_ref(**s)
    got = emulate_learn_rows(x, sel)
    syn, perm, counts = s["syn_rows"].clone(), x["perm"].clone(), \
        sel.counts.clone()
    wrote = ptm.learn_rows_ref(syn, perm, s["act_rows"], x["cols"],
                               x["learn"], x["new_seg"], sel.lpos,
                               sel.chosen, sel.n_chosen, counts, 0.1, 0.05,
                               x["permanence_initial"], want_mask=True)
    want = (syn.numpy(), perm.view(torch.int32).numpy(), wrote.numpy(),
            counts.numpy())
    for g, w in zip(got, want):
        assert np.array_equal(g, w)
    assert int(counts[ptm.N_GROWN].sum()) > 0
