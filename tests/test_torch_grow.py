"""The port's growth selection (`grow_select_ref`, and through it `_grow`)
and bit pack (`pack_bits_ref`) against the JAX package, and the
wrappers of their CUDA kernels (`grow_select`, `pack_bits`) on the CPU.

Inputs are made with numpy from a seed. The random words of the growth
come from JAX keys (`jax.random.bits`), as `tests/test_torch_htm.py`
replays them, so the port and JAX draw the same bits. Every comparison
is exact. The kernels themselves run only on the card
(`tests/test_torch_cuda.py`, `chip_smoke.py` `check_grow_and_pack`).
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


# every width in both forms with samp < K; samp = K at four of them
GROW_CASES = ([(Wc, form, "samp<K") for Wc in WIDTHS for form in FORM_C]
              + [(4, "index", "samp=K"), (128, "cell", "samp=K"),
                 (700, "index", "samp=K"), (2049, "cell", "samp=K")])


@pytest.mark.parametrize("Wc,form,samp", GROW_CASES)
def test_grow_matches_jax(Wc, form, samp):
    """The port's `_grow` (its selection `grow_select_ref` on the CPU)
    against JAX `_grow` in both key forms, with samp < K and samp = K,
    at every listed candidate width: all seven outputs equal, for rows
    that grow, rows at samp potential (n_grow = 0) and invalid list
    rows."""
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
    got = ptm._grow(pcfg, torch.from_numpy(rnd), **t)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)
    assert int(got[3].sum()) > 0                      # synapses grew


def numpy_keys(x: dict):
    """The growth keys of `grow_select`'s inputs, built in numpy from the
    JAX step's definition (`temporal_memory.py:400-480`): uint32 keys
    with the invalid ones at the form's sentinel, and each row's
    n_grow."""
    syn, act = x["syn_rows"].numpy(), x["act_rows"].numpy()
    lidx, lvalid = x["lidx"].numpy(), x["lvalid"].numpy()
    cand, cvalid = x["cand_cell"].numpy(), x["cand_valid"].numpy()
    rnd = x["rnd"].numpy().view(np.uint32)
    samp, bits, cell = x["samp"], x["key_bits"], x["cell_form"]
    Bx, R, Kx = syn.shape
    Lx, Wc = lidx.shape[1], cand.shape[1]
    rows = np.minimum(lidx, R - 1)
    syn_l = np.take_along_axis(syn, rows[..., None], 1)      # (B, L, K)
    act_l = np.take_along_axis(act, rows[..., None], 1) & (syn_l >= 0)
    potential = act_l.sum(-1)
    n_eff = x["n_winners_eff"].numpy()[:, None]
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
    chosen, n_chosen = ptm.grow_select_ref(**x)
    if not x["cell_form"]:
        chosen = pas.take_small_table_ref(
            x["cand_cell"], chosen, (1 << x["key_bits"]) - 1)
    keys, n_grow = numpy_keys(x)
    kk = chosen.shape[-1]
    free = jnp.ones((keys.shape[1], kk), bool)
    method = ("sortfill_packed_cell" if x["cell_form"]
              else "sortfill_packed_idx")
    pri = keys if x["cell_form"] else keys.view(np.int32)
    jg, _, jn = jax.device_get(jax.jit(jax.vmap(
        lambda p, n, c: jax_tm._select_and_fill(
            p, n, c, free, x["samp"], method, idx_bits=x["key_bits"])))(
        pri, n_grow, x["cand_cell"].numpy()))
    np.testing.assert_array_equal(n_chosen.numpy(), jn)
    upto = np.arange(kk) < jn[..., None]
    np.testing.assert_array_equal(np.where(upto, chosen.numpy(), 0),
                                  np.where(upto, jg, 0))
    assert int(n_chosen.sum()) > 0 and bool((n_chosen == 0).any())


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


def _grow_call(Wc: int, cell_form: bool, bits: int = 10):
    Bv, R, Kv, Lv = 2, 8, 16, 4
    return lambda: kernels.grow_select_cuda(
        _view(Bv, R, Kv), _view(Bv, R, Kv, dtype=torch.bool), _view(Bv, Lv),
        _view(Bv, Lv, dtype=torch.bool), torch.zeros((Bv, Wc),
                                                     dtype=torch.int32),
        _view(Bv, Wc, dtype=torch.bool), _view(Bv), _view(Bv, Lv, Wc), 8,
        bits, cell_form)


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
])
def test_grow_and_pack_choose_a_path_from_shapes(call, kernel, path):
    """`grow_select` reports its key form and where its keys live, and
    `pack_bits` its loads, from the shapes alone (`CudaKernel.path`): the
    tensors here are CPU views of one element, which the wrapper then
    refuses as off the card. Nothing launches."""
    k = next(k for k in kernels.KERNELS if k.name == kernel)
    k.path = ()
    before = kernels.launch_counts()
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        call()
    assert k.path == path
    assert kernels.launch_counts() == before


@pytest.mark.parametrize("bad", ["key bits", "samp", "cand rows",
                                 "syn rank"])
def test_grow_select_cuda_checks_shapes_first(bad):
    """`grow_select_cuda` refuses bad geometry before it reports a path:
    key bits that leave no random bit, samp 0, overlapping candidate
    rows (a row stride below Wc, as a broadcast list has) and rows that
    are not (B, R, K)."""
    args = {"key bits": (_grow_call(128, False, bits=30), "key bits"),
            "samp": (lambda: kernels.grow_select_cuda(
                _view(2, 8, 16), _view(2, 8, 16, dtype=torch.bool),
                _view(2, 4), _view(2, 4, dtype=torch.bool),
                torch.zeros((2, 128), dtype=torch.int32),
                _view(2, 128, dtype=torch.bool), _view(2),
                _view(2, 4, 128), 0, 10, True), "samp"),
            "cand rows": (lambda: kernels.grow_select_cuda(
                _view(2, 8, 16), _view(2, 8, 16, dtype=torch.bool),
                _view(2, 4), _view(2, 4, dtype=torch.bool), _view(2, 128),
                _view(2, 128, dtype=torch.bool), _view(2),
                _view(2, 4, 128), 8, 10, True), "not overlap"),
            "syn rank": (lambda: kernels.grow_select_cuda(
                _view(2, 8), _view(2, 8, dtype=torch.bool), _view(2, 4),
                _view(2, 4, dtype=torch.bool),
                torch.zeros((2, 128), dtype=torch.int32),
                _view(2, 128, dtype=torch.bool), _view(2),
                _view(2, 4, 128), 8, 10, True), "must be")}
    call, match = args[bad]
    kernels.GROW_SELECT.path = ()
    before = kernels.launch_counts()
    with pytest.raises(ValueError, match=match):
        call()
    assert kernels.GROW_SELECT.path == ()
    assert kernels.launch_counts() == before


def test_grow_select_dispatch_runs_the_plain_version_on_the_cpu():
    """`grow_select` on CPU tensors is `grow_select_ref`, with the
    compacted list's strided view as `_grow` passes it; nothing
    launches."""
    x = testing.grow_inputs(5, 2, 2048, 32, 41, 4, 64, 128, 88, 32)
    assert x["cand_cell"].stride() == (129, 1)
    before = kernels.launch_counts()
    got = ptm.grow_select(**x)
    assert kernels.launch_counts() == before
    assert testing.same_choice(got, ptm.grow_select_ref(**x))
    assert torch.equal(got[0], ptm.grow_select_ref(**x)[0])


def test_step_launches_count_growth_and_packs():
    """A learning step launches one `grow_select`, and every step three
    `pack_bits` (active cells, winner cells, matching flags;
    `testing.step_launches`, which the card's checks compare exactly); a
    `tm_resume` packs once."""
    got = testing.step_launches(table_update=5, act_conn=2, act_frozen=1,
                                serving_activation=4)
    assert got["grow_select"] == 5
    assert got["pack_bits"] == 3 * 12 == testing.STEP_PACKS * 12
    resumed = testing.step_launches(act_conn=1, sp_steps=0, pack_bits=1)
    assert (resumed["pack_bits"], resumed["seg_counts"],
            resumed["grow_select"]) == (1, 1, 0)
    assert set(got) == {k.name for k in kernels.KERNELS}


def test_grow_and_pack_sources_name_what_they_replace():
    """The two sources are built with the others, name the JAX functions
    they stand for, and bind entry points ending in (device, stream)."""
    src = {n: (kernels.CSRC / n).read_text()
           for n in ("grow_pass.cu", "pack_pass.cu")}
    assert set(src) <= set(kernels.SOURCES)
    assert "bithtm_tpu/models/temporal_memory.py:350-498" in \
        src["grow_pass.cu"]
    assert "bithtm_tpu/ops/active_set.py:85" in src["pack_pass.cu"]
    for name, file in (("grow_select", "grow_pass.cu"),
                       ("pack_bits", "pack_pass.cu")):
        assert f'extern "C" int {name}(' in src[file]
        assert kernels._ARGTYPES[name][-2:] == [kernels._I, kernels._VP]
