"""The port's growth selection and fill (`grow_select_ref`, the fill of
`learn_rows_ref`, and through them JAX `_grow`) and bit pack
(`pack_bits_ref`) against the JAX package, and the wrappers of their CUDA
kernels (`grow_select`, `learn_rows`, `pack_bits`) on the CPU.

Inputs are made with numpy from a seed. The random words of the growth
come from JAX keys (`jax.random.bits`), as `tests/test_torch_htm.py`
replays them, so the port and JAX draw the same bits. Every comparison
is exact. The kernels themselves run only on the card
(`tests/test_torch_cuda.py`, `chip_smoke.py` `check_grow_and_pack`).
`tests/test_torch_learn.py` holds the whole row pass, `learn_rows_ref`,
to JAX `_learn`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bithtm_tpu import make_htm_config as jax_make_htm_config
from bithtm_tpu.models import temporal_memory as jax_tm
from bithtm_tpu.ops import active_set as jas

import bithtm_tpu_torch as bt
from bithtm_tpu_torch import testing
from bithtm_tpu_torch.models import temporal_memory as ptm
from bithtm_tpu_torch.ops import active_set as pas
from bithtm_tpu_torch.ops import kernels

# B, A, G, K, D, L of the growth tests; C picks the key form: 256 x 32 =
# 8,192 cells take the cell form, 4096 x 32 = 131,072 the index form
B, A, G, K, D, L = 2, 80, 2, 16, 32, 24
FORM_C = {"cell": 256, "index": 4096}
WIDTHS = (4, 128, 384, 700, 2049)


def configs(C: int, Wc: int, samp: int):
    kw = dict(input_dim=64, column_dim=C, cell_dim=D, active_columns=A,
              segments_per_column=G, synapse_capacity=K,
              segment_sampling_synapses=samp,
              segment_activation_threshold=min(samp, 4),
              segment_matching_threshold=min(samp, 3),
              winner_capacity=Wc, growth_capacity=L)
    return jax_make_htm_config(**kw).tm, bt.make_htm_config(**kw).tm


def grow_rows(seed: int, C: int):
    """`_grow`'s inputs for B streams: stream 0 has dense winners (about
    2,300 candidates) and more learning segments than L; stream 1 sparse
    winners and fewer learning segments than L (invalid list rows). Row
    activity varies, so some rows reach samp potential."""
    rng = np.random.default_rng(seed)
    cols = np.stack([np.sort(rng.choice(C, A, replace=False))
                     for _ in range(B)]).astype(np.int32)
    density = np.array([0.9, 0.1])[:, None, None, None]
    winners = rng.random((B, A, D)) < density[..., 0]
    live = rng.random((B, A, G, K)) < rng.uniform(0.2, 1.0, (B, A, G, 1))
    # half the live targets are candidates (mostly active), as after
    # growth toward earlier winners
    grid = cols[..., None] * D + np.arange(D)
    cand = np.take_along_axis(grid.reshape(B, -1),
                              rng.integers(0, A * D, (B, A * G * K)), 1)
    to_cand = rng.random((B, A, G, K)) < 0.5
    syn = np.where(live, np.where(to_cand, cand.reshape(B, A, G, K),
                                  rng.integers(0, C * D, (B, A, G, K))), -1)
    act = live & (rng.random((B, A, G, K))
                  < np.where(to_cand, 0.9, 0.6))
    learn = rng.random((B, A, G)) < np.array([0.3, 0.05])[:, None, None]
    return dict(
        syn_rows=syn.astype(np.int32),
        perm_rows=np.where(live, rng.random((B, A, G, K)), -1.0).astype(
            np.float32),
        learn_rows=learn, act_prev_rows=act, prev_cols=cols,
        prev_winner_bits=np.asarray(jas.pack_bits(jnp.asarray(winners))))


def port_grow(cfg, rnd, syn_rows, perm_rows, learn_rows, act_prev_rows,
              prev_cols, prev_winner_bits):
    """JAX `_grow`'s outputs from the port's growth: `grow_select` and
    the fill of `learn_rows` (the index-form keys decoded between them,
    as `_learn` runs them) on `_grow`'s (B, A, G, K) rows, which are
    already cleaned, reset and updated: `learn_rows` takes them as
    gathered rows with no new segment and a zero increment and
    decrement, so that it only fills (perm + 0.0 * +-0.0 is perm for
    every perm but -0.0, which these rows do not hold). Returns (syn,
    perm, wrote, n_grown, overflow, n_winners_dropped,
    n_growth_dropped)."""
    B, A, G, K = syn_rows.shape
    C, D = cfg.column_dim, cfg.cell_dim
    assert not bool(torch.signbit(perm_rows[perm_rows == 0]).any())
    cell_form, key_bits = ptm.growth_key_form(C * D, rnd.shape[-1])
    syn = syn_rows.reshape(B, A, G * K).clone()
    perm = perm_rows.reshape(B, A, G * K).clone()
    act = act_prev_rows.reshape(B, A, G * K).to(torch.uint8)
    learn = learn_rows.reshape(B, A * G)
    sel = ptm.grow_select(syn, act, learn, prev_cols, prev_winner_bits, rnd,
                          D, cfg.segment_sampling_synapses, key_bits,
                          cell_form)
    chosen = sel.chosen
    if not cell_form:
        chosen = pas.take_small_table(sel.cand_cell, chosen,
                                      (1 << key_bits) - 1, in_place=True)
    # the packed activity's type at K, which learn_rows reads
    act = act.to(pas.act_dtype(K))
    wrote = ptm.learn_rows(syn, perm, act, None, learn,
                           torch.zeros_like(learn), sel.lpos, chosen,
                           sel.n_chosen, sel.counts, 0.0, 0.0,
                           cfg.permanence_initial, want_mask=True)
    shape = (B, A, G, K)
    return (syn.view(shape), perm.view(shape), wrote.view(shape),
            *sel.counts)


# every width in both forms with samp < K; samp = K at four of them
GROW_CASES = ([(Wc, form, "samp<K") for Wc in WIDTHS for form in FORM_C]
              + [(4, "index", "samp=K"), (128, "cell", "samp=K"),
                 (700, "index", "samp=K"), (2049, "cell", "samp=K")])


@pytest.mark.parametrize("Wc,form,samp", GROW_CASES)
def test_grow_matches_jax(Wc, form, samp):
    """The port's growth (`port_grow`: `grow_select` and the fill of
    `learn_rows`, their plain versions on the CPU) against JAX `_grow` in
    both key forms, with samp < K and samp = K, at every listed candidate
    width: all seven outputs equal, for rows that grow, rows at samp
    potential (n_grow = 0) and invalid list rows."""
    n_samp = 6 if samp == "samp<K" else K
    jcfg, pcfg = configs(FORM_C[form], Wc, n_samp)
    assert ptm.growth_key_form(pcfg.column_dim * D, Wc)[0] == (
        form == "cell")
    x = grow_rows(Wc + n_samp, FORM_C[form])
    keys = jax.random.split(jax.random.PRNGKey(Wc), B)
    rnd = np.stack([np.asarray(jax.random.bits(k, (L, Wc), jnp.uint32))
                    for k in keys]).view(np.int32)
    want = jax.device_get(jax.jit(jax.vmap(
        lambda *a: jax_tm._grow(jcfg, *a)))(keys, *(
            x[n] for n in ("syn_rows", "perm_rows", "learn_rows",
                           "act_prev_rows", "prev_cols",
                           "prev_winner_bits"))))
    t = {k: torch.from_numpy(np.array(v)) for k, v in x.items()}
    t["prev_winner_bits"] = t["prev_winner_bits"].view(torch.int32)
    got = port_grow(pcfg, torch.from_numpy(rnd), **t)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)
    assert int(got[3].sum()) > 0                      # synapses grew


def numpy_keys(x: dict, sel):
    """The growth keys of `grow_select`'s inputs ``x`` at the lists of its
    selection ``sel``, built in numpy from the JAX step's definition
    (`temporal_memory.py:400-480`): uint32 keys with the invalid ones at
    the form's sentinel, and each row's n_grow."""
    syn, act = x["syn_rows"].numpy(), x["act_rows"].numpy()
    lidx, lvalid = sel.lidx.numpy(), sel.lvalid.numpy()
    cand = sel.cand_cell.numpy()
    rnd = x["rnd"].numpy().view(np.uint32)
    samp, bits, cell = x["samp"], x["key_bits"], x["cell_form"]
    Bx, R, Kx = syn.shape
    Lx, Wc = lidx.shape[1], cand.shape[1]
    n_eff = np.minimum(np.unpackbits(
        x["prev_winner_bits"].numpy().view(np.uint8), axis=-1).reshape(
            Bx, -1).sum(-1), Wc)[:, None]
    cvalid = np.arange(Wc) < n_eff
    rows = np.minimum(lidx, R - 1)
    syn_l = np.take_along_axis(syn, rows[..., None], 1)      # (B, L, K)
    act_l = np.take_along_axis(act, rows[..., None], 1) & (syn_l >= 0)
    potential = act_l.sum(-1)
    n_grow = np.where(lvalid, np.minimum(np.maximum(samp - potential, 0),
                                         np.minimum(n_eff, samp)), 0)
    if samp < Kx:   # the first samp active live targets
        targets = np.where(act_l & (np.cumsum(act_l, -1) <= samp), syn_l,
                           -1)
    else:
        targets = syn_l
    existing = (targets[..., :, None] == cand[:, None, None, :]).any(-2)
    valid = cvalid[:, None, :] & ~existing
    if cell:
        key = ((rnd >> np.uint32(bits + 1)) << np.uint32(bits)) \
            | cand[:, None, :].astype(np.uint32)
        sent = np.uint32(0xFFFFFFFF)
    else:
        key = ((rnd >> np.uint32(bits + 2)) << np.uint32(bits)) \
            | np.arange(Wc, dtype=np.uint32)
        sent = np.uint32(0x7FFFFFFF)
    return np.where(valid, key, sent), n_grow.astype(np.int32)


@pytest.mark.parametrize("form,Wc", [("cell", 128), ("cell", 700),
                                     ("index", 384), ("index", 2049)])
def test_grow_select_ref_matches_jax_select_and_fill(form, Wc):
    """`grow_select_ref` against JAX `_select_and_fill` (methods
    `sortfill_packed_cell` and `sortfill_packed_idx`) on the same keys,
    built in numpy from `grow_select`'s inputs (`testing.grow_inputs`):
    with every slot free, JAX's r-th filled slot holds the r-th chosen
    cell, so n_chosen and the chosen cells agree (the index form's keys
    decoded against the candidate list)."""
    C = {"cell": 2048, "index": 16384}[form]
    x = testing.grow_inputs(Wc, 3, C, 32, 41, 4, 32, Wc, 40, 24)
    assert x["cell_form"] == (form == "cell")
    sel = ptm.grow_select_ref(**x)
    chosen, n_chosen = sel.chosen, sel.n_chosen
    if not x["cell_form"]:
        chosen = pas.take_small_table_ref(
            sel.cand_cell, chosen, (1 << x["key_bits"]) - 1)
    keys, n_grow = numpy_keys(x, sel)
    kk = chosen.shape[-1]
    free = jnp.ones((keys.shape[1], kk), bool)
    method = ("sortfill_packed_cell" if x["cell_form"]
              else "sortfill_packed_idx")
    pri = keys if x["cell_form"] else keys.view(np.int32)
    jg, _, jn = jax.device_get(jax.jit(jax.vmap(
        lambda p, n, c: jax_tm._select_and_fill(
            p, n, c, free, x["samp"], method, idx_bits=x["key_bits"])))(
        pri, n_grow, sel.cand_cell.numpy()))
    np.testing.assert_array_equal(n_chosen.numpy(), jn)
    upto = np.arange(kk) < jn[..., None]
    np.testing.assert_array_equal(np.where(upto, chosen.numpy(), 0),
                                  np.where(upto, jg, 0))
    assert int(n_chosen.sum()) > 0 and bool((n_chosen == 0).any())


# (Wc, L) against the two streams of `grow_rows` (about 2,300 and 260
# winner cells, about 48 and 8 learning rows of A*G = 160): below both,
# above both, and between them
PROLOGUE_CASES = {"Wc, L below": (4, 4), "Wc, L above": (3000, 200),
                  "Wc, L between": (700, 24)}


@pytest.mark.parametrize("case", PROLOGUE_CASES)
def test_grow_select_ref_lists_match_jax(case):
    """The lists `grow_select_ref` builds, held to JAX `_grow`'s
    intermediates (`temporal_memory.py:376-395`) on the same inputs: the
    candidate list and its validity (`compact_first_k` of the winner
    cells; the port's validity is the first n_winners_eff entries, 0
    past them), the growing rows' slot ids and validity (the padding row
    A*G past them), n_winners - n_winners_eff and the learning rows past
    L, with the winner count and the learning count on both sides of
    Wc and L."""
    Wc, Lc = PROLOGUE_CASES[case]
    _, pcfg = configs(FORM_C["cell"], Wc, 6)
    x = grow_rows(Wc + Lc, FORM_C["cell"])
    rnd = np.zeros((B, Lc, Wc), np.int32)
    sel = ptm.grow_select_ref(
        torch.from_numpy(x["syn_rows"].reshape(B, A * G, K)),
        torch.from_numpy(x["act_prev_rows"].reshape(B, A * G, K)),
        torch.from_numpy(x["learn_rows"].reshape(B, A * G)),
        torch.from_numpy(x["prev_cols"]),
        torch.from_numpy(np.array(x["prev_winner_bits"]).view(np.int32)),
        torch.from_numpy(rnd), D, 6, *ptm.growth_key_form(
            pcfg.column_dim * D, Wc))

    def jax_lists(cols, words, learn):
        grid_cell = (cols[:, None] * D + jnp.arange(D)).reshape(A * D)
        grid_valid = jas.unpack_bits(words, D).reshape(A * D)
        cand, cvalid = jas.compact_first_k(grid_valid, grid_cell, Wc)
        n_winners = jax.lax.population_count(words).sum().astype(jnp.int32)
        lidx, lvalid = jas.compact_first_k(
            learn.reshape(A * G), jnp.arange(A * G, dtype=jnp.int32), Lc)
        return (cand, cvalid, jnp.where(lvalid, lidx, A * G), lvalid,
                n_winners - jnp.minimum(n_winners, Wc),
                learn.sum(dtype=jnp.int32) - lvalid.sum(dtype=jnp.int32))

    cand, cvalid, lidx, lvalid, w_drop, g_drop = jax.device_get(
        jax.jit(jax.vmap(jax_lists))(x["prev_cols"], x["prev_winner_bits"],
                                     x["learn_rows"]))
    n_eff = np.minimum(cvalid.sum(-1), Wc)[:, None]
    np.testing.assert_array_equal(np.arange(Wc) < n_eff, cvalid)
    np.testing.assert_array_equal(sel.cand_cell.numpy(),
                                  np.where(cvalid, cand, 0))
    np.testing.assert_array_equal(sel.lidx.numpy(), lidx)
    np.testing.assert_array_equal(sel.lvalid.numpy(), lvalid)
    np.testing.assert_array_equal(sel.counts.numpy(), np.stack(
        [np.zeros(B, np.int32), np.zeros(B, np.int32), w_drop, g_drop]))
    n_win = cvalid.sum(-1) + w_drop
    n_learn = lvalid.sum(-1) + g_drop
    above = {"Wc, L below": [False, False], "Wc, L above": [True, True],
             "Wc, L between": [False, True]}[case]
    assert (n_win < Wc).tolist() == (n_learn < Lc).tolist() == above


def old_fill(syn_rows, perm_rows, lidx, lvalid, chosen, n_chosen,
             permanence_initial):
    """The fill `_grow` ran as torch ops before a kernel took it: `_fill` on the
    gathered rows, the rows scattered back through a padding row, the
    mask scattered alike, the permanences set where written, and the
    counts reduced. Returns (syn, perm, wrote, n_grown, overflow)."""
    B, R, K = syn_rows.shape
    L = lidx.shape[1]
    lidx = lidx.long()
    take = lidx.clamp(max=R - 1)[..., None].expand(B, L, K)
    syn_l = syn_rows.gather(1, take)
    free = syn_l < 0
    gathered, wrote_l = ptm._fill(chosen, n_chosen, free)
    new_syn_l = torch.where(wrote_l, gathered, syn_l)
    idx = lidx[..., None].expand(B, L, K)
    syn_pad = torch.cat([syn_rows, syn_rows.new_full((B, 1, K), -1)], 1)
    syn = syn_pad.scatter_(1, idx, new_syn_l)[:, :R]
    wrote = torch.zeros((B, R + 1, K), dtype=torch.bool).scatter_(
        1, idx, wrote_l)[:, :R]
    perm = torch.where(wrote, permanence_initial, perm_rows)
    n_free = free.sum(-1, dtype=torch.int32)
    overflow = (torch.clamp(n_chosen - n_free, min=0) * lvalid).sum(
        -1, dtype=torch.int32)
    return syn, perm, wrote, wrote_l.sum((1, 2), dtype=torch.int32), overflow


# rows with every slot live, rows offered more cells than free slots,
# rows invalid past each stream's list, and all three at random
FILL_CASES = ("no free slot", "overflow", "invalid rows", "mixed")


def list_places(lidx, lvalid, R: int) -> torch.Tensor:
    """`grow_select`'s lpos from its lidx and lvalid: each row's place in
    the list, -1 where it has none."""
    Bl, L = lidx.shape
    lpos = torch.full((Bl, R + 1), -1, dtype=torch.int32)
    at = torch.where(lvalid, lidx, R).long()
    lpos.scatter_(1, at, torch.arange(L, dtype=torch.int32).expand(Bl, L))
    return lpos[:, :R].contiguous()


@pytest.mark.parametrize("case", FILL_CASES)
def test_learn_rows_fill_matches_the_old_fill(case):
    """The fill of `learn_rows_ref` (in place, counts added to rows 0
    and 1), on rows that neither learn nor hold a stale slot, against the
    scatter path the kernels replaced (`old_fill`): the synapse and
    permanence rows, the mask of the slots written, the slots grown and
    the overflow equal, and rows 2 and 3 of the counts untouched."""
    Bf, R, Kf, Lf, kk = 3, 12, 16, 6, 5
    rng = np.random.default_rng(FILL_CASES.index(case))
    live_share = {"no free slot": 1.0, "overflow": 0.85,
                  "invalid rows": 0.5, "mixed": 0.6}[case]
    live = rng.random((Bf, R, Kf)) < live_share
    syn = np.where(live, rng.integers(0, 4096, (Bf, R, Kf)), -1)
    perm = np.where(live, rng.random((Bf, R, Kf)), -1.0)
    lidx = np.sort(np.stack([rng.choice(R, Lf, replace=False)
                             for _ in range(Bf)]), -1)
    n_valid = {"invalid rows": [2, 0, 4]}.get(
        case, [Lf, Lf, Lf] if case != "mixed" else [Lf, 3, 1])
    lvalid = np.arange(Lf) < np.array(n_valid)[:, None]
    lidx = np.where(lvalid, lidx, R)
    n_chosen = np.where(lvalid, rng.integers(1, kk + 1, (Bf, Lf)), 0)
    if case == "overflow":
        n_chosen = np.where(lvalid, kk, 0)
    chosen = rng.integers(0, 4096, (Bf, Lf, kk))
    t = {k: torch.from_numpy(np.ascontiguousarray(v, d)) for k, v, d in (
        ("syn", syn, np.int32), ("perm", perm, np.float32),
        ("lidx", lidx, np.int32), ("chosen", chosen, np.int32),
        ("n_chosen", n_chosen, np.int32))}
    lv = torch.from_numpy(lvalid)
    want = old_fill(t["syn"], t["perm"], t["lidx"], lv, t["chosen"],
                    t["n_chosen"], 0.21)
    counts = torch.tensor([[0] * Bf, [0] * Bf, [7] * Bf, [9] * Bf],
                          dtype=torch.int32)
    s, p = t["syn"].clone(), t["perm"].clone()
    none = torch.zeros((Bf, R), dtype=torch.bool)
    act = torch.zeros((Bf, R, Kf), dtype=torch.uint8)
    wrote = ptm.learn_rows_ref(s, p, act, None, none, none,
                               list_places(t["lidx"], lv, R), t["chosen"],
                               t["n_chosen"], counts, 0.1, 0.1, 0.21,
                               want_mask=True)
    for got, w in zip((s, p, wrote, counts[0], counts[1]), want):
        assert torch.equal(got, w)
    assert torch.equal(counts[2:], torch.tensor([[7] * Bf, [9] * Bf],
                                                dtype=torch.int32))
    if case == "no free slot":
        assert not bool(wrote.any())
    elif case == "overflow":
        assert int(counts[1].sum()) > 0 and bool(wrote.any())
    else:
        assert bool(wrote.any())


@pytest.mark.parametrize("D", [1, 4, 8, 32, 33, 64])
def test_pack_bits_ref_matches_jax(D):
    """`pack_bits_ref`, and `pack_bits` on CPU tensors, against JAX
    `pack_bits`: the same words, bit for bit (JAX's uint32 as int32),
    zeros past D; nothing launches."""
    rng = np.random.default_rng(D)
    mask = rng.random((3, 5, D)) < 0.4
    want = np.asarray(jas.pack_bits(jnp.asarray(mask))).view(np.int32)
    before = kernels.launch_counts()
    for fn in (pas.pack_bits_ref, pas.pack_bits):
        np.testing.assert_array_equal(fn(torch.from_numpy(mask)).numpy(),
                                      want)
    assert kernels.launch_counts() == before


def _view(*shape, dtype=torch.int32):
    """A CPU tensor of ``shape`` holding one element: a wrapper must
    choose its path from the shape before it reads a tensor."""
    return torch.zeros((1,) * len(shape), dtype=dtype).expand(*shape)


def _grow_call(Wc: int, cell_form: bool, bits: int = 10, samp: int = 8,
               syn=(2, 8, 16), words=(2, 4, 1)):
    """`grow_select_cuda` on CPU views: B=2 streams of R=8 rows of K=16
    slots, A=4 columns of D=32 cells, L=4 rows of Wc random words."""
    Bv, Lv = 2, 4
    return lambda: kernels.grow_select_cuda(
        _view(*syn), _view(Bv, 8, 16, dtype=torch.bool),
        _view(Bv, 8, dtype=torch.bool), _view(Bv, 4), _view(*words),
        _view(Bv, Lv, Wc), 32, samp, bits, cell_form)


def _learn_call(kk: int, n_chosen=(2, 4), K: int = 16, cols: bool = False):
    """`learn_rows_cuda` on CPU views: B=2 streams of 8 rows (4 columns
    of G=2 segments) of K slots, gathered or (``cols``) at 4 of 6
    columns of the tables; L=4 growing rows of kk chosen cells."""
    Ct = 6 if cols else 4
    return lambda: kernels.learn_rows_cuda(
        _view(2, Ct, 2 * K), _view(2, Ct, 2 * K, dtype=torch.float32),
        _view(2, Ct, 2 * K, dtype=pas.act_dtype(K)),
        _view(2, 4) if cols else None, _view(2, 8, dtype=torch.bool),
        _view(2, 8, dtype=torch.bool), _view(2, 8), _view(2, 4, kk),
        _view(*n_chosen), _view(4, 2), 0.1, 0.1, 0.21)


def _decide_call(mode: str, cols: bool = True, D: int = 32, B: int = 2,
                 A: int = 4):
    """`column_decide_cuda` on CPU views: B=2 streams, A=4 active columns
    of A + 2 (``cols``) or gathered, G=2 segments of D cells."""
    Ct, W = (A + 2 if cols else A), (D + 31) // 32
    return lambda: kernels.column_decide_cuda(
        _view(B, W, Ct), _view(B, Ct, 2), _view(B, A) if cols else None,
        _view(B, A, 2), _view(B, A, 2), _view(B, A, 2),
        _view(B, A, 2, dtype=torch.float32),
        _view(B, A, D, dtype=torch.float32), _view(B), D, mode, 2, 3, 1e-8,
        True)


@pytest.mark.parametrize("call,kernel,path", [
    (_grow_call(128, True), "grow_select", ("cell", "smem")),
    (_grow_call(768, False), "grow_select", ("index", "smem")),
    # a list and one key row fill a block at Wc = 29,056
    (_grow_call(29_056, True), "grow_select", ("cell", "smem")),
    (_grow_call(29_057, True), "grow_select", ("cell", "global")),
    (_grow_call(29_057, False), "grow_select", ("index", "global")),
    (lambda: kernels.pack_bits_cuda(_view(2, 3, 32, dtype=torch.bool)),
     "pack_bits", ("ballot",)),
    (lambda: kernels.pack_bits_cuda(_view(2, 3, 64, dtype=torch.bool)),
     "pack_bits", ("ballot",)),
    (lambda: kernels.pack_bits_cuda(_view(2, 3, 48, dtype=torch.bool)),
     "pack_bits", ("v8",)),
    (lambda: kernels.pack_bits_cuda(_view(2, 3, 8, dtype=torch.bool)),
     "pack_bits", ("v8",)),
    (lambda: kernels.pack_bits_cuda(_view(2, 3, 4, dtype=torch.bool)),
     "pack_bits", ("v4",)),
    (lambda: kernels.pack_bits_cuda(_view(2, 3, 33, dtype=torch.bool)),
     "pack_bits", ("v1",)),
    (_learn_call(32), "learn_rows", ("u8", "rows", "shfl", "v16")),
    (_learn_call(33), "learn_rows", ("u8", "rows", "load", "v16")),
    (_learn_call(8, cols=True), "learn_rows",
     ("u8", "table", "shfl", "v16")),
    (_learn_call(8, K=126), "learn_rows", ("bf16", "rows", "shfl", "scalar")),
    (_learn_call(40, K=128, cols=True), "learn_rows",
     ("f32", "table", "load", "scalar")),
    (_decide_call("learn"), "column_decide", ("learn", "table", "stream")),
    (_decide_call("winner", cols=False, D=33), "column_decide",
     ("winner", "rows", "stream")),
    (_decide_call("burst", D=8), "column_decide",
     ("burst", "table", "stream")),
    # u8 activity with K off a multiple of 8, and the reference stacks' K
    (_learn_call(8, K=60), "learn_rows", ("u8", "rows", "shfl", "scalar")),
    (_learn_call(8, K=125, cols=True), "learn_rows",
     ("u8", "table", "shfl", "scalar")),
    (_learn_call(40, K=48, cols=True), "learn_rows",
     ("u8", "table", "load", "v16")),
    # a stream split over blocks where the streams leave SMs idle; not
    # where they fill them, nor past the meeting place's streams
    (_decide_call("learn", B=2, A=200), "column_decide",
     ("learn", "table", "split")),
    (_decide_call("winner", cols=False, B=64, A=328), "column_decide",
     ("winner", "rows", "split")),
    (_decide_call("learn", B=256, A=200), "column_decide",
     ("learn", "table", "stream")),
    (_decide_call("burst", B=1025, A=2000), "column_decide",
     ("burst", "table", "stream")),
])
def test_grow_and_pack_choose_a_path_from_shapes(call, kernel, path):
    """`grow_select` reports its key form and where its keys live,
    `learn_rows` the activity's type, where it reads its rows and how it
    reads its cells, `column_decide` its mode and where it reads its
    rows, and `pack_bits` its loads, from the shapes alone
    (`CudaKernel.path`): the
    tensors here are CPU views of one element, which the wrapper then
    refuses as off the card. Nothing launches."""
    k = next(k for k in kernels.KERNELS if k.name == kernel)
    k.path = ()
    before = kernels.launch_counts()
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        call()
    assert k.path == path
    assert kernels.launch_counts() == before


@pytest.mark.parametrize("B,A,split", [
    (256, 41, 1), (64, 328, 4), (1, 41, 1), (256, 16, 1), (2, 64, 1),
    (2, 65, 2), (2, 20_000, 132), (132, 2000, 2), (133, 2000, 1),
    (1024, 65, 1), (1025, 65, 1), (0, 5, 1)])
def test_decide_split_fills_the_card_from_shapes(B, A, split):
    """`column_decide`'s blocks a stream: one where the streams fill
    DECIDE_FILL_BLOCKS (the bench, 256 x 41) or two columns a warp cover
    the stream (B=1, A=41); at 16K (64 x 328) four, 82 columns a block;
    never more than the blocks to fill nor one a 64 columns."""
    assert kernels.decide_split(B, A) == split


@pytest.mark.parametrize("bad", ["key bits", "samp", "cand rows",
                                 "syn rank"])
def test_grow_select_cuda_checks_shapes_first(bad):
    """`grow_select_cuda` refuses bad geometry before it reports a path:
    key bits that leave no random bit, samp 0, candidate rows whose
    winner words do not span D (two words a column at D=32) and rows
    that are not (B, R, K)."""
    call, match = {
        "key bits": (_grow_call(128, False, bits=30), "key bits"),
        "samp": (_grow_call(128, True, samp=0), "samp"),
        "cand rows": (_grow_call(128, True, words=(2, 4, 2)),
                      "winner words"),
        "syn rank": (_grow_call(128, True, syn=(2, 8)), "must be")}[bad]
    kernels.GROW_SELECT.path = ()
    before = kernels.launch_counts()
    with pytest.raises(ValueError, match=match):
        call()
    assert kernels.GROW_SELECT.path == ()
    assert kernels.launch_counts() == before


@pytest.mark.parametrize("bad", ["list rows", "cells"])
def test_learn_rows_cuda_checks_shapes_first(bad):
    """`learn_rows_cuda` refuses chosen counts that are not (B, L) and
    rows of no chosen cell before it reports a path."""
    call = {"list rows": _learn_call(8, n_chosen=(2, 5)),
            "cells": _learn_call(0)}[bad]
    kernels.LEARN_ROWS.path = ()
    before = kernels.launch_counts()
    with pytest.raises(ValueError, match="learn_rows needs"):
        call()
    assert kernels.LEARN_ROWS.path == ()
    assert kernels.launch_counts() == before


def test_grow_select_dispatch_runs_the_plain_version_on_the_cpu():
    """`grow_select` and `learn_rows` on CPU tensors are `grow_select_ref`
    and `learn_rows_ref`, at the bench geometry on the tables; nothing
    launches."""
    x = testing.learn_inputs(5, 2, 2048, 32, 41, 4, 64, 128, 88, 32)
    s = x["select"]
    before = kernels.launch_counts()
    got = ptm.grow_select(**s)
    want = ptm.grow_select_ref(**s)
    assert testing.same_choice(got, want)
    assert torch.equal(got.chosen, want.chosen)
    filled = []
    for learn in (ptm.learn_rows, ptm.learn_rows_ref):
        syn, p, c = s["syn_rows"].clone(), x["perm"].clone(), \
            want.counts.clone()
        w = learn(syn, p, s["act_rows"], x["cols"], x["learn"],
                  x["new_seg"], want.lpos, want.chosen, want.n_chosen, c,
                  x["increment"], x["decrement"], x["permanence_initial"],
                  want_mask=True)
        filled.append((syn, p, w, c))
    for a, b in zip(*filled):
        assert torch.equal(a, b)
    assert bool(filled[0][2].any())
    assert kernels.launch_counts() == before


def test_step_launches_count_growth_and_packs():
    """A learning step launches one `row_counts`, one `grow_select` and
    one `learn_rows`, every step one `column_decide` (which writes the
    active and winner cells' words) and no step a `pack_bits` (the
    matching flags come from `seg_counts`' flags form, and a packed
    serving step's from `serving_counts`'; `testing.step_launches`,
    which the card's checks compare exactly); a `tm_resume` decides and
    packs nothing."""
    got = testing.step_launches(table_update=5, act_conn=2, act_frozen=1,
                                serving_counts=4)
    assert got["grow_select"] == got["learn_rows"] == got["row_counts"] == 5
    assert got["column_decide"] == 12
    assert got["pack_bits"] == 0
    assert got["seg_counts"] == 8 and got["serving_counts"] == 4
    assert "grow_fill" not in got
    resumed = testing.step_launches(act_conn=1, sp_steps=0, column_decide=0)
    assert (resumed["pack_bits"], resumed["column_decide"],
            resumed["seg_counts"], resumed["grow_select"],
            resumed["learn_rows"]) == (0, 0, 1, 0, 0)
    assert set(got) == {k.name for k in kernels.KERNELS}


def test_grow_and_pack_sources_name_what_they_replace():
    """The three sources are built with the others, name the JAX functions
    they stand for, and bind entry points ending in (device, stream)."""
    src = {n: (kernels.CSRC / n).read_text()
           for n in ("grow_pass.cu", "learn_pass.cu", "pack_pass.cu")}
    assert set(src) <= set(kernels.SOURCES)
    assert not (kernels.CSRC / "grow_fill.cu").exists()
    assert "bithtm_tpu/models/temporal_memory.py:350-498" in src[
        "grow_pass.cu"]
    assert "bithtm_tpu/models/temporal_memory.py:501-643" in src[
        "learn_pass.cu"]
    for name in ("grow_pass.cu", "learn_pass.cu"):
        assert ":350-498" in src[name] and ":221-347" in src[name]
    assert "bithtm_tpu/ops/active_set.py:85" in src["pack_pass.cu"]
    for name, file in (("grow_select", "grow_pass.cu"),
                       ("row_counts", "learn_pass.cu"),
                       ("learn_rows", "learn_pass.cu"),
                       ("pack_bits", "pack_pass.cu")):
        assert f'extern "C" int {name}(' in src[file]
        assert kernels._ARGTYPES[name][-2:] == [kernels._I, kernels._VP]
