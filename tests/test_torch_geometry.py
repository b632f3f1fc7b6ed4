"""The large-geometry path of the PyTorch port against the JAX package,
on the CPU: the index-keyed growth selection above 2^16 cells
(`sortfill_packed_idx`) with its `take_small_table` decode, full
learning scans at more than 2^16 cells, `htm_scan_autocap`, and the two
entry points with kernels of their own, `synapse_activation` and
`sp_update_pack`.

Inputs are made with numpy from a seed; the port's draws replay the JAX
keys (`ReplayDraws`), also across an autocap escalation. The plain
versions are checked against the JAX XLA forms and the Pallas kernels in
interpret mode; the CUDA kernels run only on the card
(tests/test_torch_cuda.py, `python3 chip_smoke.py`). Tolerance: exact
equality throughout. The scans run with boosting off, so that no `exp`
rounding (ROADMAP fault f) enters the SP's choices.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bithtm_tpu import htm_init_batch as jax_htm_init_batch
from bithtm_tpu import htm_scan as jax_htm_scan
from bithtm_tpu.models.htm import htm_scan_autocap as jax_htm_scan_autocap
from bithtm_tpu.models.temporal_memory import (
    _select_and_fill as jax_select_and_fill)
from bithtm_tpu.ops import active_set as jas
from bithtm_tpu.ops.overlap import pack_input as jax_pack_input
from bithtm_tpu.ops.pallas_kernels import (small_table_take_tpu,
                                           sp_update_pack_tpu,
                                           synapse_activation_tpu)

import bithtm_tpu_torch as bt
from bithtm_tpu_torch.models import spatial_pooler as psp
from bithtm_tpu_torch.models import temporal_memory as ptm
from bithtm_tpu_torch.ops import active_set as pas
from bithtm_tpu_torch.ops import kernels

from .test_torch_htm import (ReplayDraws, assert_metrics_equal,
                             assert_tree_equal, copy_keys, make_configs)

SENTINEL = 0x7FFFFFFF


# ---- take_small_table ------------------------------------------------


@pytest.mark.parametrize("Wc,masked", [
    (1, False), (129, False), (384, False), (700, False), (768, False),
    # growth keys and their index mask, as `_grow` passes them; above
    # 2048 JAX has no Pallas kernel, only its compare-select-reduce
    (384, True), (2049, True), (4096, True)])
def test_take_small_table_matches_jax(Wc, masked):
    """Port (plain version and dispatcher) vs JAX `take_small_table`
    (its compare-select-reduce on the CPU) and, up to Wc = 2048,
    `small_table_take_tpu` in interpret mode: with in-range,
    sentinel-decoded (>= Wc) and negative indices, or (``masked``) with
    index-keyed growth keys decoded as `take_small_table(table, keys,
    low)` against JAX's `take_small_table(table, keys & low)`: 0 outside
    [0, Wc) in all four."""
    rng = np.random.RandomState(Wc + masked)
    B, L, kk = 2, 13, 7
    table = rng.randint(0, 1 << 20, size=(B, Wc)).astype(np.int32)
    idx = rng.randint(0, Wc, size=(B, L, kk)).astype(np.int32)
    bits = max(1, (Wc - 1).bit_length())
    low = (1 << bits) - 1
    odd = rng.rand(B, L, kk)
    if masked:
        hi = rng.randint(0, 1 << (30 - bits), size=(B, L, kk))
        keys = ((hi << bits) | idx).astype(np.int32)
        keys[odd < 0.15] = SENTINEL
        mask = low
        idx = keys & low
    else:
        idx[odd < 0.15] = low                  # a sentinel key's index
        idx[(odd >= 0.15) & (odd < 0.25)] = -rng.randint(1, 300)
        idx[:, 0, 0] = Wc                      # just past the table
        keys, mask = idx, -1
    t = torch.from_numpy
    got = pas.take_small_table_ref(t(table), t(keys), mask)
    assert torch.equal(got, pas.take_small_table(t(table), t(keys), mask))
    want = np.stack([np.asarray(jas.take_small_table(
        jnp.asarray(table[b]), jnp.asarray(idx[b]))) for b in range(B)])
    np.testing.assert_array_equal(got.numpy(), want)
    inside = (idx >= 0) & (idx < Wc)
    assert (got.numpy()[~inside] == 0).all() and inside.any()
    assert (~inside).any() or low < Wc
    if Wc > 16 * 128:
        return
    for b in range(B):
        flat = np.zeros(1024, np.int32)
        flat[:L * kk] = idx[b].reshape(-1)
        kern = np.asarray(small_table_take_tpu(
            jnp.asarray(table[b]), jnp.asarray(flat.reshape(8, 128)),
            interpret=True)).reshape(-1)[:L * kk]
        np.testing.assert_array_equal(got[b].numpy().reshape(-1), kern)


# ---- the index-keyed growth selection --------------------------------


def test_select_and_fill_packed_idx_matches_jax():
    """The port's index-keyed `_select_and_fill` (`torch.topk` over int32
    keys, sentinel 0x7FFFFFFF, `take_small_table` decode) against JAX
    `_select_and_fill(..., "sortfill_packed_idx")`, as
    tests/test_tm_parity.py:352-397 draws them: Wc 384 and 700 take the
    JAX split-block selection, the rest its full sort. The written slots,
    their cells and the chosen counts are equal."""
    rng = np.random.RandomState(7)
    for Wc in (4, 16, 130, 384, 700):
        L = int(rng.randint(1, 12))
        K = int(rng.randint(3, 20))
        samp = int(rng.randint(1, 34))
        idx_bits = max(1, (Wc - 1).bit_length())
        hi = rng.randint(0, 1 << (30 - idx_bits), size=(L, Wc))
        key = ((hi << idx_bits) | np.arange(Wc)).astype(np.int32)
        key[rng.rand(L, Wc) < 0.3] = np.int32(SENTINEL)
        cells = rng.randint(0, 1 << 20, size=Wc).astype(np.int32)
        n_grow = rng.randint(0, min(samp, Wc) + 1, size=L).astype(np.int32)
        free = rng.rand(L, K) < 0.5
        jg, jw, jn = jax.device_get(jax_select_and_fill(
            jnp.asarray(key), jnp.asarray(n_grow), jnp.asarray(cells),
            jnp.asarray(free), samp, "sortfill_packed_idx",
            idx_bits=idx_bits))
        t = torch.from_numpy
        pg, pw, pn = ptm._select_and_fill(
            t(key)[None], t(key != SENTINEL)[None], t(n_grow)[None],
            t(free)[None], samp, idx_bits, t(cells)[None])
        np.testing.assert_array_equal(pw[0].numpy(), jw)
        np.testing.assert_array_equal(pn[0].numpy(), jn)
        np.testing.assert_array_equal(np.where(jw, pg[0].numpy(), 0),
                                      np.where(jw, jg, 0))
        assert jw.any() or not n_grow.any()


def _drive(jcfg, pcfg, B, x, n_learn, seed):
    """JAX `htm_scan` and the port's on the same state, inputs and
    draws: n_learn learning steps, then inference. Returns both final
    states and metrics."""
    jstate = jax_htm_init_batch(jax.random.key(seed), jcfg, B)
    pstate = bt.htm_state_from_numpy(jstate, "cpu")
    draws = ReplayDraws(pcfg.tm, copy_keys(jstate.key))
    jstate, jm_l = jax_htm_scan(jcfg, jstate, jnp.asarray(x[:n_learn]),
                                True, 1)
    jstate, jm_i = jax_htm_scan(jcfg, jstate, jnp.asarray(x[n_learn:]),
                                False, 1)
    pstate, pm_l = bt.htm_scan(pcfg, pstate, torch.from_numpy(x[:n_learn]),
                               True, draws=draws)
    pstate, pm_i = bt.htm_scan(pcfg, pstate, torch.from_numpy(x[n_learn:]),
                               False, draws=draws)
    return (jstate, jm_l, jm_i), (pstate, pm_l, pm_i)


BIG = dict(input_dim=64, active_columns=16, segments_per_column=2,
           synapse_capacity=16, segment_activation_threshold=2,
           segment_matching_threshold=2, segment_sampling_synapses=8,
           sp_overrides={"boosting_intensity": 0.0})


@pytest.mark.parametrize("geometry,caps", [
    ((4096, 32), {}),                         # Wc = 128, full sort
    ((4096, 32), {"winner_capacity": 384}),   # JAX: split selection
    ((2048, 64), {}),                         # two bitmask words
    # JAX: the compare-select-reduce decode above 16*128 candidates
    ((4096, 32), {"winner_capacity": 2049}),
])
def test_learning_scan_above_2_16_cells_matches_jax(geometry, caps,
                                                    monkeypatch):
    """A learning scan at 2^17 cells, where the growth key holds the
    candidate's list index: every state leaf and metric equal to JAX,
    and each learning step decodes its keys through `take_small_table`
    once."""
    C, D = geometry
    jcfg, pcfg = make_configs(column_dim=C, cell_dim=D, **BIG, **caps)
    assert pcfg.tm.num_cells > 1 << 16
    calls = []
    real = ptm.take_small_table

    def counted(table, keys, mask=-1, in_place=False):
        calls.append(tuple(keys.shape))
        return real(table, keys, mask, in_place)

    monkeypatch.setattr(ptm, "take_small_table", counted)
    B, n_learn, n_inf = 2, 12, 4
    rng = np.random.RandomState(C + D)
    pats = rng.rand(5, 64) < 0.2
    t = np.arange(n_learn + n_inf)
    x = pats[(t[:, None] + np.arange(B)[None, :]) % 5]
    (js, jm_l, jm_i), (ps, pm_l, pm_i) = _drive(jcfg, pcfg, B, x, n_learn,
                                                C + D)
    assert_metrics_equal(jm_l, pm_l, "learning")
    assert_metrics_equal(jm_i, pm_i, "inference")
    assert_tree_equal(js, bt.htm_state_to_numpy(ps), "final state")
    L, Wc = pcfg.tm.resolved_growth_capacity, pcfg.tm.resolved_winner_capacity
    kk = min(pcfg.tm.segment_sampling_synapses, Wc)
    assert calls == [(B, L, kk)] * n_learn
    assert int(pm_l["tm_grown_synapses"].sum()) > 0


# ---- htm_scan_autocap ------------------------------------------------


AUTOCAP = dict(input_dim=128, column_dim=96, cell_dim=8, active_columns=24,
               segments_per_column=4, synapse_capacity=16,
               segment_activation_threshold=3, segment_matching_threshold=3,
               segment_sampling_synapses=6)


def _autocap_both(tuned, safe, T, chunk, seed):
    """`htm_scan_autocap` of both packages from one JAX state (B=2), the
    port replaying the JAX draws. Returns (JAX (state, metrics, info,
    on_chunk calls), port (the same))."""
    jcfg, pcfg = make_configs(**AUTOCAP)
    rng = np.random.RandomState(seed)
    pats = rng.rand(4, 2, 128) < 0.2
    seq = pats[np.arange(T) % 4]
    jstate = jax_htm_init_batch(jax.random.key(seed), jcfg, 2)
    pstate = bt.htm_state_from_numpy(jstate, "cpu")
    draws = ReplayDraws(pcfg.tm, copy_keys(jstate.key))
    j_calls, p_calls = [], []
    jout = jax_htm_scan_autocap(
        jcfg, jstate, jnp.asarray(seq), tuned=tuned, safe=safe,
        chunk=chunk, unroll=1,
        on_chunk=lambda *a: j_calls.append(a[:1] + a[2:]))
    pout = bt.htm_scan_autocap(
        pcfg, pstate, torch.from_numpy(seq), tuned=tuned, safe=safe,
        chunk=chunk, draws=draws,
        on_chunk=lambda *a: p_calls.append(a[:1] + a[2:]))
    return (*jout, j_calls), (*pout, p_calls)


def _assert_autocap_equal(j, p):
    (js, jm, jinfo, _), (ps, pm, pinfo, _) = j, p
    assert jinfo == pinfo
    assert set(jm) == set(pm)
    for k in jm:
        np.testing.assert_array_equal(pm[k].numpy(), jm[k], err_msg=k)
    assert_tree_equal(js, bt.htm_state_to_numpy(ps), "final state")


@pytest.mark.parametrize("tuned,chunk,T,escalates", [
    (dict(growth_capacity=8), 4, 24, True),    # bootstrap overflows L=8
    (dict(growth_capacity=96), 5, 12, False),  # caps that hold
])
def test_htm_scan_autocap_matches_jax(tuned, chunk, T, escalates):
    """The two cases of tests/test_pool_pressure.py:177-253, port vs
    JAX: the same escalation step, metrics and every state leaf, the
    escalated chunk re-run with the JAX draws of the safe config; the
    produced trajectory is drop-free on the cap counters."""
    j, p = _autocap_both(tuned, None, T, chunk, 5 if escalates else 6)
    _assert_autocap_equal(j, p)
    info, m = p[2], p[1]
    assert (info["escalated_at_step"] is not None) == escalates
    assert (info["tuned_drops"] > 0) == escalates
    assert info["chunks"] == -(-T // chunk)
    for k in bt.CAP_DROP_METRICS:
        assert int(m[k].sum()) == 0
    assert [c[1] for c in p[3]] == [c[1] for c in j[3]]


def test_htm_scan_autocap_counts_safe_chunk_drops():
    """Safe caps that still drop: the trajectory and every leaf equal
    JAX's, but where JAX reports 0 drops for each chunk after the
    escalating one, the port reports every chunk's counted drops as
    produced (the one deliberate difference, ROADMAP "Faults")."""
    j, p = _autocap_both(dict(growth_capacity=8), dict(growth_capacity=12),
                         24, 4, 5)
    _assert_autocap_equal(j, p)
    (_, pm, info, p_calls), j_calls = p, j[3]
    esc = info["escalated_at_step"]
    assert esc is not None
    drops = sum(pm[k] for k in bt.CAP_DROP_METRICS).sum(1)
    want = [(t0, int(drops[t0:t0 + 4].sum())) for t0 in range(0, 24, 4)]
    assert [(c[0], c[2]) for c in p_calls] == want
    safe = [c for c in p_calls if c[0] >= esc]
    assert any(c[2] > 0 for c in safe)
    assert all(c[2] == 0 for c in j_calls if c[0] > esc)


# ---- synapse_activation ----------------------------------------------


@pytest.mark.parametrize("D", [4, 33, 64])
def test_synapse_activation_matches_jax(D):
    """`synapse_activation_ref` (and the dispatcher on the CPU) against
    JAX `synapse_activation_xla` and `synapse_activation_tpu` in
    interpret mode, with free slots and ids outside the cell space."""
    rng = np.random.RandomState(D)
    B, C, J, A = 2, 16, 32, 3
    N = C * D
    syn = rng.randint(-2, N + 3, size=(B, C, J)).astype(np.int32)
    cols = np.stack([np.sort(rng.choice(C, A, replace=False))
                     for _ in range(B)]).astype(np.int32)
    rows = rng.rand(B, A, D) < 0.5
    bits = pas.pack_bits(torch.from_numpy(rows))
    t = torch.from_numpy
    got = pas.synapse_activation_ref(t(syn), t(cols), bits, C, D)
    assert got.dtype == torch.uint8
    assert torch.equal(got, pas.synapse_activation(t(syn), t(cols), bits, C,
                                                   D))
    jbits = jnp.asarray(bits.numpy().view(np.uint32))
    for b in range(B):
        want = np.asarray(jas.synapse_activation_xla(
            jnp.asarray(syn[b]), jnp.asarray(cols[b]), jbits[b], D))
        np.testing.assert_array_equal(got[b].numpy(), want)
        kern = np.asarray(synapse_activation_tpu(
            jnp.asarray(syn[b]), jnp.asarray(cols[b]), jbits[b], D,
            block=8, interpret=True), np.float32)
        np.testing.assert_array_equal(got[b].numpy(), kern)
    assert got.any() and not got.all()


# ---- sp_update_pack --------------------------------------------------


@pytest.mark.parametrize("quantized", [True, False])
@pytest.mark.parametrize("edges", [False, True])
def test_sp_update_pack_matches_pallas_interpret(quantized, edges):
    """`sp_update_pack_ref` against `sp_update_pack_tpu` in interpret
    mode, per stream, mirroring tests/test_pallas.py:95-134: active rows
    updated (int16 saturating at +-32000), every row re-packed. With
    ``edges``, every row also holds values that change without learning:
    int16 past the rail (the clip moves them), float32 -0.0 (p + 0 * d is
    +0.0 where d >= 0)."""
    rng = np.random.RandomState(3)
    B, C, I_pad, I = 2, 16, 1024, 1000
    lane = np.arange(I_pad)
    x = rng.rand(B, I) < 0.3
    cols = np.stack([np.sort(rng.choice(C, 5, replace=False))
                     for _ in range(B)]).astype(np.int32)
    xp = np.pad(x, ((0, 0), (0, I_pad - I)))
    if quantized:
        perm = rng.randint(-200, 200, size=(B, C, I_pad)).astype(np.int16)
        perm[:, :, I:] = -32000
        perm[:, :3, :8] = 31998            # saturates at the rail
        if edges:
            perm[:, :, 8:16], perm[:, :, 16:24] = 32767, -32768
        delta = np.where(lane < I, xp * 9 - 3, 0).astype(np.int32)
        thr = 0
    else:
        perm = (rng.rand(B, C, I_pad).astype(np.float32) - 0.5) * 0.2
        perm[:, :, I:] = -1e9
        if edges:
            perm[:, :, :64] = -0.0
        delta = np.where(lane < I, xp * 0.045 - 0.015, 0.0).astype(
            np.float32)
        thr = 0.0
    got_perm, got_pack = _sp_update_pack_cpu(perm, delta, cols, thr)
    for b in range(B):
        want_perm, want_pack = sp_update_pack_tpu(
            jnp.asarray(perm[b]), jnp.asarray(delta[b]), jnp.asarray(cols[b]),
            thr, quantized, block=8, interpret=True)
        np.testing.assert_array_equal(got_perm[b].numpy(),
                                      np.asarray(want_perm))
        np.testing.assert_array_equal(got_pack[b].numpy(),
                                      np.asarray(want_pack))
        np.testing.assert_array_equal(got_pack[b].numpy(), np.asarray(
            jax_pack_input(jnp.asarray(np.asarray(want_perm) >= thr))))
    bits = got_perm.numpy().view(np.uint8) != perm.view(np.uint8)
    changed = bits.reshape(B, C, -1).any(-1)
    assert changed[np.arange(B)[:, None], cols].all()
    assert changed.sum() == (B * C if edges else B * 5)
    if quantized:
        assert (got_perm.numpy() == 32000).any()
    if edges and not quantized:
        signs = np.signbit(got_perm.numpy()[:, :, :64])
        assert signs.any() and not signs.all()


def _sp_update_pack_cpu(perm, delta, cols, thr):
    """The dispatcher on CPU tensors: in place, the plain version."""
    p = torch.from_numpy(perm.copy())
    out = psp.sp_update_pack(p, torch.from_numpy(delta),
                             torch.from_numpy(cols), thr)
    assert out[0] is p
    return out


@pytest.mark.parametrize("dtype", ["int16", "float32"])
def test_sp_update_pack_equals_sp_step_learning(dtype):
    """`hebbian_delta` + `sp_update_pack` over the whole table equals
    the learning half of `sp_step` (which updates the active rows only):
    the same permanences, and the connected table of every row."""
    hcfg = bt.make_htm_config(200, 96, 4, active_columns=7,
                              sp_overrides={"permanence_dtype": dtype})
    cfg = hcfg.sp
    state = bt.htm_init_batch(hcfg, 3, torch.Generator().manual_seed(4),
                              "cpu").sp
    rng = np.random.RandomState(4)
    for _ in range(4):
        x = torch.from_numpy(rng.rand(3, 200) < 0.2)
        before = state.permanence.clone()
        state, out = bt.sp_step(cfg, state, x, True)
        delta, thr = psp.hebbian_delta(cfg, x, before.shape[-1])
        perm, pack = psp.sp_update_pack(before, delta, out.active_columns,
                                        thr)
        assert torch.equal(perm, state.permanence)
        assert torch.equal(pack, state.connected)


# ---- dispatch ----------------------------------------------------------


def _meta_call(fn):
    z = torch.zeros((2, 8, 1024), dtype=torch.int16, device="meta")
    i = torch.zeros((2, 4), dtype=torch.int32, device="meta")
    if fn == "take_small_table":
        return pas.take_small_table(i, i[..., None])
    if fn == "synapse_activation":
        return pas.synapse_activation(i[..., None], i, i[..., None], 8, 4)
    return psp.sp_update_pack(z, z[:, 0].int(), i, 0)


@pytest.mark.parametrize("fn", ["take_small_table", "synapse_activation",
                                "sp_update_pack"])
def test_new_dispatchers_raise_off_cpu_and_cuda(fn):
    """A `meta` tensor raises; nothing falls back to the plain version."""
    with pytest.raises(RuntimeError, match="not supported"):
        _meta_call(fn)


def test_new_cuda_wrappers_reject_cpu_tensors():
    """The wrappers check their inputs before building or launching."""
    before = kernels.launch_counts()
    i = torch.zeros((2, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.small_table_take_cuda(i, i[..., None])
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.synapse_activation_cuda(torch.zeros((2, 8, 4),
                                                    dtype=torch.int32),
                                        i, i[..., None], 8, 4)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.sp_update_pack_cuda(
            torch.zeros((2, 8, 1024), dtype=torch.int16),
            torch.zeros((2, 1024), dtype=torch.int32), i, 0)
    with pytest.raises(ValueError, match=r"table must be \(B, Wc\)"):
        kernels.small_table_take_cuda(
            torch.zeros((4096,), dtype=torch.int32), i[..., None])
    assert kernels.launch_counts() == before
