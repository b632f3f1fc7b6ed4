"""The CUDA kernels of the PyTorch port against their plain versions, on
the card. No JAX here, so the file runs where the GPU is:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

(`--noconftest`: tests/conftest.py imports jax.) Every test skips where
`torch.cuda.is_available()` is false.
"""

import dataclasses
import types

import numpy as np
import pytest
import torch

import bithtm_tpu_torch as bt
from bithtm_tpu_torch.models import spatial_pooler as psp
from bithtm_tpu_torch.models import temporal_memory as ptm
from bithtm_tpu_torch.ops import active_set as pas
from bithtm_tpu_torch.ops import kernels
from bithtm_tpu_torch.ops import overlap as pov
from bithtm_tpu_torch.ops import regularization as preg
from bithtm_tpu_torch.ops import serving as psv
from bithtm_tpu_torch import testing
from bithtm_tpu_torch.testing import (boost_agreement, serving_rows,
                                      table_inputs)
from bithtm_tpu_torch.testing import step_launches as steps

SHAPES = [  # B, C, G, K, D, A
    (2, 64, 4, 64, 32, 5),    # the bench's G, K, D
    (3, 40, 8, 48, 4, 6),     # the reference stack's G, K; D=4
    (2, 30, 3, 7, 33, 4),     # two bitmask words; J % 4 != 0, C*J % 4 != 0
    (1, 16, 2, 16, 70, 3),    # three words
    (1, 8192, 1, 8, 64, 9),   # a 64 KB bitmap: shared memory opt-in
    (1, 16384, 1, 8, 64, 20),  # the 16K x 64 geometry's 128 KB bitmap
    # the row ranges of the table and word kernels' grid
    # (csrc/active_bitmap.cuh range_grid, walk_rows; thousands of blocks
    # at small bitmaps):
    (300, 7, 2, 8, 4, 3),     # a row or none a block, some across a stream
    (30000, 2, 2, 8, 4, 1),   # each range across several streams
    (5, 16384, 1, 8, 64, 20),  # ranges across streams, 128 KB bitmap
    (3, 16384, 1, 7, 64, 20),  # J % 4 != 0 under the 128 KB bitmap
    # the reference stack (G=8, K=48: J=384, u8 packing at act_scale(48))
    # at the single-stream API's B=1 and at B=256
    (1, 2048, 8, 48, 32, 41),
    (256, 2048, 8, 48, 32, 41),
]


def launched(before: dict) -> dict:
    """The launches of each kernel since ``before``."""
    return {k: v - before[k] for k, v in kernels.launch_counts().items()}


def only(**counts) -> dict:
    return {k.name: counts.get(k.name, 0) for k in kernels.KERNELS}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU "
                    "mode); chip_smoke.py runs them at the bench shapes")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES)
def test_kernels_match_plain(shape, cuda):
    B, C, G, K, D, A = shape
    x = table_inputs(sum(shape), *shape, device=cuda)
    p_ref, p_k = x["perm"].clone(), x["perm"].clone()
    before = kernels.launch_counts()
    v_ref = pas.table_update_ref(x["syn"], p_ref, x["act_prev"].clone(),
                                 x["pun_word"], x["cols"], x["bits"], D, K,
                                 0.01, 0.5)
    v_k = kernels.table_update_cuda(x["syn"], p_k, x["act_prev"].clone(),
                                    x["pun_word"], x["cols"], x["bits"], D,
                                    K, 0.01, 0.5)
    c_ref = pas.synapse_activation_conn_ref(x["syn"], x["perm"], x["cols"],
                                            x["bits"], D, 0.5, K)
    c_k = kernels.act_conn_cuda(x["syn"], x["perm"], x["cols"], x["bits"],
                                D, 0.5, K)
    torch.cuda.synchronize()
    assert torch.equal(v_k, v_ref)
    assert torch.equal(p_k.view(torch.int32), p_ref.view(torch.int32))
    assert torch.equal(c_k, c_ref)
    assert (v_ref > 1).any() and (p_ref != x["perm"]).any()
    assert launched(before) == only(table_update=1, act_conn=1)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,repeat", [
    ((2, 64, 4, 64, 32, 5), "duplicates"),
    ((3, 2048, 4, 64, 64, 16), "duplicates"),
    ((2, 64, 4, 64, 32, 5), "initial"),
])
def test_table_kernels_take_repeated_cols(shape, repeat, cuda):
    """D % 32 == 0 (the word-at-a-time bitmap build) with repeated active
    columns: half of each stream's columns repeat its first one with the
    same cell words, or, as an initial state holds, every column is 0
    with no active cell. Both kernels equal their plain versions."""
    B, C, G, K, D, A = shape
    x = table_inputs(sum(shape) + 4, *shape, device=cuda)
    cols, bits = x["cols"].clone(), x["bits"].clone()
    if repeat == "duplicates":
        cols[:, A // 2:] = cols[:, :1]
        bits[:, A // 2:] = bits[:, :1]
    else:
        cols.zero_()
        bits.zero_()
    p_ref, p_k = x["perm"].clone(), x["perm"].clone()
    v_ref = pas.table_update_ref(x["syn"], p_ref, x["act_prev"].clone(),
                                 x["pun_word"], cols, bits, D, K, 0.01, 0.5)
    v_k = kernels.table_update_cuda(x["syn"], p_k, x["act_prev"].clone(),
                                    x["pun_word"], cols, bits, D, K, 0.01,
                                    0.5)
    c_ref = pas.synapse_activation_conn_ref(x["syn"], x["perm"], cols, bits,
                                            D, 0.5, K)
    c_k = kernels.act_conn_cuda(x["syn"], x["perm"], cols, bits, D, 0.5, K)
    torch.cuda.synchronize()
    assert torch.equal(v_k, v_ref) and torch.equal(c_k, c_ref)
    assert torch.equal(p_k.view(torch.int32), p_ref.view(torch.int32))
    assert bool((v_ref != 0).any()) == (repeat == "duplicates")


@pytest.mark.cuda
@pytest.mark.parametrize("middle", [
    (1, 8192, 1, 8, 64, 9),     # a 64 KB bitmap
    (2, 2048, 4, 64, 32, 41),   # the bench's 8 KB bitmap
])
def test_table_kernels_alternate_bitmap_sizes(middle, cuda):
    """A 128 KB, a smaller and again a 128 KB bitmap in one process,
    through the table kernels, the word kernels and `act_frozen`: the
    launchers cache each size's grid, and no size lowers the shared
    memory another needs."""
    for shape in ((1, 16384, 1, 8, 64, 20), middle, (2, 16384, 1, 8, 64, 20)):
        B, C, G, K, D, A = shape
        x = table_inputs(sum(shape) + 5, *shape, device=cuda)
        cols, bits = x["cols"], x["bits"]
        p_ref, p_k = x["perm"].clone(), x["perm"].clone()
        v_ref = pas.table_update_ref(x["syn"], p_ref, x["act_prev"].clone(),
                                     x["pun_word"], cols, bits, D, K, 0.01,
                                     0.5)
        v_k = kernels.table_update_cuda(x["syn"], p_k, x["act_prev"].clone(),
                                        x["pun_word"], cols, bits, D, K,
                                        0.01, 0.5)
        c_k = kernels.act_conn_cuda(x["syn"], x["perm"], cols, bits, D, 0.5,
                                    K)
        word = pas.pack_frozen_table(x["syn"], x["perm"], 0.5)
        rows = serving_rows(sum(shape) + 6, B, C + 8, C, D, G, device=cuda)
        got = (kernels.act_frozen_cuda(word, cols, bits, D, K),
               kernels.serving_activation_cuda(rows, cols, bits, C, D),
               kernels.synapse_activation_cuda(x["syn"], cols, bits, C, D))
        want = (pas.synapse_activation_frozen_ref(word, cols, bits, D, K),
                psv.serving_activation_ref(rows, cols, bits, C, D),
                pas.synapse_activation_ref(x["syn"], cols, bits, C, D))
        torch.cuda.synchronize()
        assert torch.equal(v_k, v_ref)
        assert torch.equal(p_k.view(torch.int32), p_ref.view(torch.int32))
        assert torch.equal(c_k, pas.synapse_activation_conn_ref(
            x["syn"], x["perm"], cols, bits, D, 0.5, K))
        for name, g, w in zip(("act_frozen", "serving_activation",
                               "synapse_activation"), got, want):
            assert torch.equal(g, w), (name, shape)


@pytest.mark.cuda
def test_kernels_launch_on_the_current_stream(cuda):
    """`table_update`, `act_conn`, `small_table_take`,
    `serving_activation` and `synapse_activation` launched under
    ``torch.cuda.stream(side)`` run on ``side``: their inputs are written
    there only after a spin of about 20 ms, so a launch on any other
    stream would read the -1s left before it."""
    B, C, G, K, D, A = SHAPES[0]
    x = table_inputs(11, *SHAPES[0], device=cuda)
    rows = serving_rows(11, B, C, C, D, G, device=cuda)
    rows_late = torch.full_like(rows, -1)
    g = torch.Generator(device=cuda).manual_seed(11)
    table = torch.randint(0, 1 << 20, (B, 384), generator=g, device=cuda,
                          dtype=torch.int32)
    idx = torch.randint(0, 384, (B, 336, 32), generator=g, device=cuda,
                        dtype=torch.int32)
    syn, idx_late = torch.full_like(x["syn"], -1), torch.full_like(idx, -1)
    p_k = torch.full_like(x["perm"], -1.0)
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        torch.cuda._sleep(40_000_000)
        syn.copy_(x["syn"])
        p_k.copy_(x["perm"])
        idx_late.copy_(idx)
        rows_late.copy_(rows)
        v_k = kernels.table_update_cuda(syn, p_k, x["act_prev"].clone(),
                                        x["pun_word"], x["cols"], x["bits"],
                                        D, K, 0.01, 0.5)
        c_k = kernels.act_conn_cuda(syn, x["perm"], x["cols"], x["bits"], D,
                                    0.5, K)
        t_k = kernels.small_table_take_cuda(table, idx_late)
        s_k = kernels.serving_activation_cuda(rows_late, x["cols"],
                                              x["bits"], C, D)
        a_k = kernels.synapse_activation_cuda(syn, x["cols"], x["bits"], C,
                                              D)
    side.synchronize()
    p_ref = x["perm"].clone()
    v_ref = pas.table_update_ref(x["syn"], p_ref, x["act_prev"].clone(),
                                 x["pun_word"], x["cols"], x["bits"], D, K,
                                 0.01, 0.5)
    c_ref = pas.synapse_activation_conn_ref(x["syn"], x["perm"], x["cols"],
                                            x["bits"], D, 0.5, K)
    torch.cuda.synchronize()
    assert torch.equal(v_k, v_ref) and torch.equal(c_k, c_ref)
    assert torch.equal(p_k.view(torch.int32), p_ref.view(torch.int32))
    assert torch.equal(t_k, pas.take_small_table_ref(table, idx))
    assert torch.equal(s_k, psv.serving_activation_ref(rows, x["cols"],
                                                       x["bits"], C, D))
    assert torch.equal(a_k, pas.synapse_activation_ref(x["syn"], x["cols"],
                                                       x["bits"], C, D))
    assert bool((v_ref > 1).any()) and bool((t_k != 0).any())
    assert bool((s_k != 0).any()) and bool((a_k != 0).any())


@pytest.mark.cuda
def test_dispatch_launches_the_kernel(cuda):
    """On CUDA tensors the dispatchers go through the kernels."""
    x = table_inputs(3, *SHAPES[0], device=cuda)
    before = kernels.launch_counts()
    pas.table_update(x["syn"], x["perm"], x["act_prev"], x["pun_word"],
                     x["cols"], x["bits"], x["seg_cell"], 32, 0.01, 0.5, 3,
                     2)
    pas.synapse_activation_conn(x["syn"], x["perm"], x["cols"], x["bits"],
                                32, 0.5, 64)
    after = kernels.launch_counts()
    assert after["table_update"] == before["table_update"] + 1
    assert after["act_conn"] == before["act_conn"] + 1


@pytest.mark.cuda
@pytest.mark.parametrize("bad", ["dtype", "shape", "contiguity", "K"])
def test_wrapper_rejects_bad_inputs(bad, cuda):
    x = table_inputs(4, *SHAPES[0], device=cuda)
    D, K = 32, 64
    if bad == "dtype":
        x["perm"] = x["perm"].double()
    elif bad == "shape":
        x["cols"] = x["cols"][:, :-1]
        x["bits"] = x["bits"][:, :-2]
    elif bad == "contiguity":
        x["syn"] = x["syn"].transpose(1, 2).contiguous().transpose(1, 2)
    else:
        K = 200
    with pytest.raises((TypeError, ValueError)):
        kernels.act_conn_cuda(x["syn"], x["perm"], x["cols"], x["bits"], D,
                              0.5, K)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,R", [(s, s[1] + 8) for s in SHAPES] + [
    # streams of one to three serving rows, more streams than the row
    # ranges of the grid: every range crosses several streams
    ((9000, 3, 2, 8, 4, 1), 1),
    ((20000, 3, 2, 8, 4, 1), 3),
    ((3, 16384, 1, 8, 64, 20), 16384),  # main rows only, 128 KB bitmap
])
def test_serving_kernels_match_plain(shape, R, cuda):
    """`act_frozen` and `serving_activation` against their plain versions
    (a serving table of R rows: 8 extension rows below C main rows, or
    fewer rows than columns), one launch each; the frozen words also
    give `act_conn`'s activity."""
    B, C, G, K, D, A = shape
    x = table_inputs(sum(shape) + 1, *shape, device=cuda)
    cols, bits = x["cols"], x["bits"]
    word = pas.pack_frozen_table(x["syn"], x["perm"], 0.5)
    rows = serving_rows(sum(shape) + 2, B, R, C, D, G, device=cuda)
    before = kernels.launch_counts()
    f_ref = pas.synapse_activation_frozen_ref(word, cols, bits, D, K)
    f_k = kernels.act_frozen_cuda(word, cols, bits, D, K)
    s_ref = psv.serving_activation_ref(rows, cols, bits, C, D)
    s_k = kernels.serving_activation_cuda(rows, cols, bits, C, D)
    torch.cuda.synchronize()
    assert torch.equal(f_k, f_ref)
    assert torch.equal(f_ref, pas.synapse_activation_conn_ref(
        x["syn"], x["perm"], cols, bits, D, 0.5, K))
    assert torch.equal(s_k, s_ref)
    assert (f_ref > 1).any() and (s_ref > 0).any()
    assert launched(before) == only(serving_activation=1, act_frozen=1)


@pytest.mark.cuda
@pytest.mark.parametrize("spill", [False, True])
def test_serving_dispatch_launches_the_kernels(spill, cuda):
    """On CUDA tensors `serving_counts` (the `serving_counts` kernel's
    counts form, with no `serving_activation`) and
    `synapse_activation_frozen` go through the kernels, and agree with
    the same calls on the CPU (the plain versions); with ``spill`` three
    dense columns fill extension rows, without it the table has none."""
    shape = B, C, G, K, D, A = (2, 512, 4, 64, 32, 5)
    x = table_inputs(5, *shape, device=cuda)
    perm = x["perm"].clone()
    if spill:
        perm[0, :3] = 0.9
        x["syn"][0, :3] = x["syn"][0, :3].abs()
    cfg = types.SimpleNamespace(
        segment_matching_threshold=2, segment_activation_threshold=2,
        permanence_threshold=0.5, synapse_capacity=K, column_dim=C,
        cell_dim=D)
    tm = types.SimpleNamespace(synapse_cell=x["syn"], synapse_perm=perm)
    tab = psv.make_serving_table(cfg, tm)
    E = tab.ext_col.shape[1]
    assert (E == 8 and (tab.ext_col < C).sum() >= 3) if spill else E == 0
    word = pas.pack_frozen_table(x["syn"], perm, 0.5)
    before = kernels.launch_counts()
    counts = psv.serving_counts(tab, x["cols"], x["bits"], C, D, G)
    v = pas.synapse_activation_frozen(word, x["cols"], x["bits"], D, K)
    after = kernels.launch_counts()
    assert after["serving_counts"] == before["serving_counts"] + 1
    assert after["serving_activation"] == before["serving_activation"]
    assert after["act_frozen"] == before["act_frozen"] + 1
    cpu = psv.ServingTable(*(t.cpu() for t in tab))
    assert torch.equal(counts.cpu(), psv.serving_counts(
        cpu, x["cols"].cpu(), x["bits"].cpu(), C, D, G))
    assert torch.equal(v.cpu(), pas.synapse_activation_frozen(
        word.cpu(), x["cols"].cpu(), x["bits"].cpu(), D, K))


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,bad", [
    (k, b) for k in ("act_frozen", "serving_activation")
    for b in ("dtype", "shape", "contiguity", "align")
] + [("serving_activation", "bitmap")])
def test_serving_wrappers_reject_bad_inputs(kernel, bad, cuda):
    B, C, G, K, D, A = SHAPES[0]
    x = table_inputs(6, *SHAPES[0], device=cuda)
    cols, bits = x["cols"], x["bits"]
    if kernel == "act_frozen":
        t = pas.pack_frozen_table(x["syn"], x["perm"], 0.5)
    else:
        t = serving_rows(6, B, C, C, D, G, device=cuda)
    if bad == "dtype":
        t = t.long()
    elif bad == "shape":
        cols = cols[:, :-1]
    elif bad == "contiguity":
        t = t.transpose(1, 2).contiguous().transpose(1, 2)
    elif bad == "align":
        flat = torch.empty(t.numel() + 1, dtype=torch.int32, device=cuda)
        t = flat[1:].view(t.shape)
    else:
        # a 4 MB active-cell bitmap: no longer refused, it takes the
        # global-memory bitmap and agrees with the plain version
        C = 1 << 20
        got = kernels.serving_activation_cuda(t, cols, bits, C, D)
        assert kernels.SERVING_ACTIVATION.path == ("global",)
        assert torch.equal(got, psv.serving_activation_ref(t, cols, bits,
                                                           C, D))
        return
    with pytest.raises((TypeError, ValueError)):
        if kernel == "act_frozen":
            kernels.act_frozen_cuda(t, cols, bits, D, K)
        else:
            kernels.serving_activation_cuda(t, cols, bits, C, D)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES)
def test_synapse_activation_matches_plain(shape, cuda):
    """`synapse_activation` against its plain version over the table of
    `table_inputs` with ids outside the cell space added, one launch;
    where a slot is live its activity is `act_conn`'s."""
    B, C, G, K, D, A = shape
    x = table_inputs(sum(shape) + 3, *shape, device=cuda)
    syn = x["syn"].clone()
    syn.view(-1)[::7] = C * D + 5
    syn.view(-1)[3::11] = -9
    before = kernels.launch_counts()
    got = kernels.synapse_activation_cuda(syn, x["cols"], x["bits"], C, D)
    want = pas.synapse_activation_ref(syn, x["cols"], x["bits"], C, D)
    torch.cuda.synchronize()
    assert launched(before) == only(synapse_activation=1)
    assert torch.equal(got, want) and got.any()
    v = pas.synapse_activation_conn_ref(x["syn"], x["perm"], x["cols"],
                                        x["bits"], D, 0.5, K)
    act = kernels.synapse_activation_cuda(x["syn"], x["cols"], x["bits"], C,
                                          D)
    assert torch.equal((act != 0) & (x["perm"] >= 0), v != 0)


@pytest.mark.cuda
@pytest.mark.parametrize("B,R", [(3, 0), (0, 5)])
def test_word_kernels_take_empty_tables(B, R, cuda):
    """`serving_activation` and `synapse_activation` over a table without
    words return an empty u8 output of its shape, launch nothing, and
    where there are streams equal their plain versions."""
    x = table_inputs(12, max(B, 1), *SHAPES[0][1:], device=cuda)
    C, D = SHAPES[0][1], SHAPES[0][4]
    cols, bits = x["cols"][:B], x["bits"][:B]
    rows = torch.zeros((B, R, 128), dtype=torch.int32, device=cuda)
    syn = torch.zeros((B, R, 6), dtype=torch.int32, device=cuda)
    before = kernels.launch_counts()
    s_k = kernels.serving_activation_cuda(rows, cols, bits, C, D)
    a_k = kernels.synapse_activation_cuda(syn, cols, bits, C, D)
    assert launched(before) == only()
    assert s_k.shape == rows.shape and a_k.shape == syn.shape
    assert s_k.dtype == a_k.dtype == torch.uint8
    if B:
        assert torch.equal(s_k, psv.serving_activation_ref(rows, cols, bits,
                                                           C, D))
        assert torch.equal(a_k, pas.synapse_activation_ref(syn, cols, bits,
                                                           C, D))


@pytest.mark.cuda
def test_word_pass_grid(cuda):
    """The word kernels' row-range grid (`kernels.word_pass_grid`): under
    the 128 KB bitmap of 16384x64, 1,024-thread blocks, one an SM, over
    eight waves; under the 8 KB bitmap of 2048x32, 256-thread blocks,
    at least four an SM, over eight waves."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    for serving, J in ((True, 128), (False, 256), (False, 7)):
        assert kernels.word_pass_grid(serving, 16384, J, 64) == (
            8 * sms, 1024, ("smem",))
        blocks, threads, _ = kernels.word_pass_grid(serving, 2048, J, 32)
        assert threads == 256 and blocks % (8 * sms) == 0
        assert blocks >= 8 * sms * 4


@pytest.mark.cuda
@pytest.mark.parametrize("B,Wc,L,kk", [
    (64, 768, 824, 32),    # the 16K auto caps
    (64, 384, 336, 32),    # the 16K tuned caps
    (2, 129, 13, 7),       # n % 4 != 0: the scalar path
    (3, 2048, 5, 16),
    (3, 2049, 5, 16),      # wider than the first design's 2048 words
    (2, 4096, 9, 32),
    (2, 60000, 7, 16),     # wider than a block stages: the read-only cache
    (1, 1, 4, 4),
])
@pytest.mark.parametrize("masked", [False, True])
def test_small_table_take_matches_plain(B, Wc, L, kk, masked, cuda):
    """`small_table_take` against its plain version, one launch a call:
    growth keys decoded with their index mask (random bits above the
    index, 15% the sentinel 0x7FFFFFFF) from a strided view of the table
    (rows Wc + 1 words apart, as `_grow`'s candidate list), into a new
    tensor and in place of the keys; or raw indices with sentinel-decoded
    (>= Wc), negative and in-range ones."""
    g = torch.Generator(device=cuda).manual_seed(Wc + L)
    table = torch.randint(0, 1 << 20, (B, Wc + masked), generator=g,
                          device=cuda, dtype=torch.int32)[:, :Wc]
    idx = torch.randint(0, Wc, (B, L, kk), generator=g, device=cuda,
                        dtype=torch.int32)
    bits = max(1, (Wc - 1).bit_length())
    low = (1 << bits) - 1
    u = torch.rand((B, L, kk), generator=g, device=cuda)
    if masked:
        hi = torch.randint(0, 1 << (30 - bits), (B, L, kk), generator=g,
                           device=cuda, dtype=torch.int32)
        keys, mask = torch.where(u < 0.15, 0x7FFFFFFF, (hi << bits) | idx), low
    else:
        keys = torch.where(u < 0.15, max(low, Wc),
                           torch.where(u < 0.25, -7, idx))
        mask = -1
    before = kernels.launch_counts()
    got = kernels.small_table_take_cuda(table, keys, mask)
    torch.cuda.synchronize()
    assert launched(before) == only(small_table_take=1)
    want = pas.take_small_table_ref(table, keys, mask)
    assert torch.equal(got, want)
    assert torch.equal(pas.take_small_table(table, keys, mask), want)
    if masked:
        assert torch.equal(want, pas.take_small_table_ref(table, keys & mask))
        before = kernels.launch_counts()
        assert pas.take_small_table(table, keys, mask, in_place=True) is keys
        torch.cuda.synchronize()
        assert launched(before) == only(small_table_take=1)
        assert torch.equal(keys, want)


def _grow_and_learn(x: dict, where, want_mask: bool = True) -> list:
    """`grow_select`, the index-form decode and `learn_rows` on copies of
    `testing.learn_inputs`' tables on ``where`` (CPU or card), as `_learn`
    runs them. Returns the selection, the tables, the mask and the
    counts, on the CPU."""
    s = {k: (v.to(where) if isinstance(v, torch.Tensor) else v)
         for k, v in x["select"].items()}
    s["syn_rows"] = s["syn_rows"].clone()
    perm = x["perm"].to(where, copy=True)
    sel = ptm.grow_select(**s)
    chosen = sel.chosen
    if not s["cell_form"]:
        chosen = pas.take_small_table(sel.cand_cell, chosen,
                                      (1 << s["key_bits"]) - 1,
                                      in_place=True)
    wrote = ptm.learn_rows(s["syn_rows"], perm, s["act_rows"],
                           s["row_cols"], s["learn_rows"], s["new_seg"],
                           sel.lpos, chosen, sel.n_chosen, sel.counts,
                           x["increment"], x["decrement"],
                           x["permanence_initial"], want_mask=want_mask)
    return [t.cpu() for t in (*sel[1:], s["syn_rows"], perm,
                              *(() if wrote is None else (wrote,)))]


@pytest.mark.cuda
@pytest.mark.parametrize("Wc", [2049, 4096])
def test_grow_matches_cpu_above_2048_candidates(Wc, cuda):
    """`grow_select`, its decode and `learn_rows` above 2^16 cells (4096
    x 32, the index-keyed selection) with a candidate list wider than
    2048 words, on the card and on the CPU from the same tables and
    draws: every output equal, each kernel launched once."""
    x = testing.learn_inputs(Wc, 2, 4096, 32, 80, 2, 16, Wc, 40, 8)
    outs = []
    for where in ("cpu", cuda):
        before = kernels.launch_counts()
        outs.append(_grow_and_learn(x, where))
        on_card = int(where != "cpu")
        assert launched(before) == only(small_table_take=on_card,
                                        grow_select=on_card,
                                        learn_rows=on_card)
    for got, want in zip(*outs[::-1]):
        assert torch.equal(got, want)
    assert bool(outs[0][-1].any())               # synapses grew


# B, C, D, A, G, K, Wc, L, samp of `grow_select` on the card: the bench
# and 16K geometries (cell and index keys), samp = K, K = 128, narrow and
# odd widths, one key row a block, keys in global memory in both forms
GROW_GEOMS = [
    (4, 2048, 32, 41, 4, 64, 128, 88, 32),
    (2, 16384, 64, 328, 4, 64, 768, 824, 32),
    (3, 2048, 32, 41, 2, 32, 128, 88, 32),
    (3, 2048, 32, 41, 2, 128, 128, 88, 32),
    (3, 2048, 32, 41, 4, 64, 4, 40, 32),
    (3, 4096, 32, 41, 4, 64, 130, 40, 32),
    (2, 2048, 32, 41, 4, 48, 700, 40, 40),
    (2, 4096, 32, 128, 2, 64, 2049, 128, 32),
    (1, 4096, 32, 1024, 1, 16, 20_000, 16, 32),
    (1, 2048, 32, 2048, 1, 16, 29_057, 8, 32),
    (1, 4096, 32, 1024, 1, 16, 29_057, 8, 32),
]


@pytest.mark.cuda
@pytest.mark.parametrize("tables", [False, True])
@pytest.mark.parametrize("geo", GROW_GEOMS)
def test_grow_select_matches_plain(geo, tables, cuda):
    """`grow_select` against `grow_select_ref` on the same CUDA tensors:
    gathered rows (`testing.grow_inputs`) or, with ``tables``, the rows
    where they lie in the tables, before the learning pass, new segments
    empty (`testing.learn_inputs`): n_chosen, the lists and the chosen
    cells or keys up to n_chosen equal, on the path its wrapper reports;
    the dispatcher launches the kernel once."""
    x = (testing.learn_inputs(sum(geo), *geo, device=cuda)["select"]
         if tables else testing.grow_inputs(sum(geo), *geo, device=cuda))
    want = ptm.grow_select_ref(**x)
    before = kernels.launch_counts()
    got = ptm.grow_select(**x)
    torch.cuda.synchronize()
    assert launched(before) == only(grow_select=1)
    assert kernels.GROW_SELECT.path == kernels._grow_keys(x["cell_form"],
                                                          geo[6])
    assert testing.same_choice(got, want)
    assert bool((want[1] > 0).any())


# `column_decide` on the card: (config overrides on `testing.FUZZ_BASE`,
# B, ties): the bench's D, G and A (two columns a warp past 32), D=33 (two
# words), the anomaly stack's D=8 with G=8, D=64 with A=70, G=1 under
# "reference" with ties, G=32, D=70 (three words: the cells recomputed
# a word at a time)
DECIDE_GEOMS = [
    (dict(column_dim=2048, cell_dim=32, active_columns=41,
          segments_per_column=4, synapse_capacity=64), 16, False),
    (dict(cell_dim=33, segments_per_column=2), 8, False),
    (dict(column_dim=512, cell_dim=8, active_columns=16,
          segments_per_column=8, synapse_capacity=48), 16, False),
    (dict(column_dim=1024, cell_dim=64, active_columns=70,
          synapse_capacity=16), 4, False),
    (dict(cell_dim=6, segments_per_column=1, allocation_policy="reference"),
     8, True),
    (dict(cell_dim=40, segments_per_column=32, synapse_capacity=4), 4,
     False),
    (dict(cell_dim=70, segments_per_column=3), 4, False),
    # split over blocks: 16K's A=328 at D=64 (six blocks a stream at B=4),
    # an uneven split (A=130 in three), and ties
    (dict(column_dim=2048, cell_dim=64, active_columns=328,
          segments_per_column=4, synapse_capacity=16), 4, False),
    (dict(column_dim=512, cell_dim=33, active_columns=130,
          segments_per_column=2), 2, False),
    (dict(column_dim=1024, cell_dim=32, active_columns=200,
          segments_per_column=4, synapse_capacity=16), 3, True),
]


@pytest.mark.cuda
@pytest.mark.parametrize("geo", DECIDE_GEOMS)
def test_column_decide_matches_plain(geo, cuda):
    """`column_decide` against `column_decide_ref` on the same inputs
    (`testing.decide_inputs`: random, crowded and sparse columns, step 0
    beside later steps), in each mode, at the columns and on gathered
    rows: the words, the bursting columns, the flags, the counts and the
    new owners bit for bit, on the path its wrapper reports; the
    dispatcher launches the kernel once."""
    overrides, B, ties = geo
    cfg = testing.fuzz_config(**overrides)
    x = testing.decide_inputs(sum(B * v for v in overrides.values()
                                  if isinstance(v, int)), cfg, B,
                              device=cuda, ties=ties)
    for mode in kernels.DECIDE_MODES:
        for gathered in (False, True):
            out = []
            for on_card in (False, True):
                args = testing.decide_args(cfg, x, mode)
                if gathered:
                    args = testing.gathered_decide_args(args)
                before = kernels.launch_counts()
                decide = ptm.column_decide if on_card else \
                    ptm.column_decide_ref
                dec = decide(*args)
                torch.cuda.synchronize()
                assert launched(before) == only(column_decide=int(on_card))
                out.append((*dec, args[2]))
            B, A = dec.act_bits.shape[:2]
            assert kernels.COLUMN_DECIDE.path == (
                mode, "rows" if gathered else "table",
                "split" if kernels.decide_split(B, A) > 1 else "stream")
            for got, want in zip(out[1], out[0]):
                assert (got is None) == (want is None)
                assert got is None or torch.equal(got, want)
    counts = dict(zip(ptm.DECIDE_COUNTS, out[0][5]))
    assert int(counts["tm_new_segments"].sum()) > 0
    assert int(counts["tm_dropped_new_segments"].sum()) > 0


def _bits(t: torch.Tensor) -> torch.Tensor:
    """A float32 tensor's bits (so that -0.0 and 0.0 differ), else t."""
    return t.view(torch.int32) if t.dtype == torch.float32 else t


# `learn_rows` also past the vector path's shapes: K = 125 (u8) and 127
# (bf16), whose columns leave 16-byte vectors, K = 120 (a round of 240
# slots), K = 40 at G = 8 (rows across two rounds) and G = 32 of K = 8
LEARN_GEOMS = GROW_GEOMS + [
    (3, 2048, 32, 41, 2, 125, 128, 88, 32),
    (3, 2048, 32, 41, 2, 127, 128, 88, 32),
    (3, 2048, 32, 41, 2, 120, 128, 88, 32),
    (3, 2048, 32, 41, 8, 40, 128, 88, 32),
    (2, 1024, 32, 41, 32, 8, 128, 88, 8),
]


@pytest.mark.cuda
@pytest.mark.parametrize("want_mask", [False, True])
@pytest.mark.parametrize("geo", LEARN_GEOMS)
def test_learn_rows_matches_plain(geo, want_mask, cuda):
    """`learn_rows` against `learn_rows_ref` on copies of the same tables
    and the same selection (`grow_select_ref` on `testing.learn_inputs`,
    the index-form keys decoded): the synapse and permanence tables
    (stale slots, new segments, the update with its +-0.0, death and the
    fill), the mask of the slots grown and the counts equal, on the path
    its wrapper reports, at the columns and on gathered rows; the
    dispatcher launches the kernel once. `row_counts` against
    `row_counts_ref` on the same tables."""
    x = testing.learn_inputs(sum(geo), *geo, device=cuda)
    s = x["select"]
    sel = ptm.grow_select_ref(**s)
    cells = sel.chosen
    if not s["cell_form"]:
        cells = pas.take_small_table_ref(sel.cand_cell, cells,
                                         (1 << s["key_bits"]) - 1)
    B, A = x["cols"].shape
    for gathered in (False, True):
        out = []
        for on_card in (False, True):
            syn, perm = s["syn_rows"].clone(), x["perm"].clone()
            cols = x["cols"]
            if gathered:
                syn, perm = ptm._rows(syn, cols), ptm._rows(perm, cols)
                act, cols = ptm._rows(s["act_rows"], cols), None
            else:
                act = s["act_rows"]
            c = sel.counts.clone()
            before = kernels.launch_counts()
            learn = ptm.learn_rows if on_card else ptm.learn_rows_ref
            w = learn(syn, perm, act, cols, x["learn"], x["new_seg"],
                      sel.lpos, cells, sel.n_chosen, c, x["increment"],
                      x["decrement"], x["permanence_initial"], want_mask)
            torch.cuda.synchronize()
            assert launched(before) == only(learn_rows=int(on_card))
            out.append((syn, perm, c) + (() if w is None else (w,)))
        assert kernels.LEARN_ROWS.path == (
            kernels._act_name(geo[5]), "rows" if gathered else "table",
            kernels._fill_path(cells.shape[-1]),
            kernels._learn_loads(geo[5]))
        for got, want in zip(out[1], out[0]):   # -0.0 apart from 0.0
            assert torch.equal(_bits(got), _bits(want))
        assert int(out[0][2][ptm.N_GROWN].sum()) > 0
    G = geo[4]
    counts = [f(s["syn_rows"], x["perm"], s["act_rows"], x["cols"], G)
              for f in (ptm.row_counts, ptm.row_counts_ref)]
    assert kernels.ROW_COUNTS.path == (kernels._act_name(geo[5]), "table")
    for got, want in zip(*counts):
        assert torch.equal(got, want)


# B, C, G, K, D of the flags form: the bench and 16K geometries, G = 1-8,
# K = 125-128 (u8, bf16, float32), D off the word and past it (D = 100:
# four words a column on the shuffle path)
FLAG_SHAPES = [(3, 2048, 4, 64, 32), (2, 1000, 4, 64, 64),
               (3, 300, 8, 48, 8), (2, 300, 1, 125, 33),
               (2, 200, 2, 126, 48), (2, 200, 3, 127, 5),
               (2, 200, 2, 128, 64), (2, 100, 8, 128, 70),
               (2, 50, 32, 4, 40), (2, 77, 5, 13, 1), (2, 300, 4, 64, 100)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", FLAG_SHAPES)
def test_seg_counts_flags_match_plain(shape, cuda):
    """The flags form of `seg_counts` equals `seg_counts_flags_ref` bit
    for bit (matching word and prediction words), in one launch on its
    path; without the prediction it writes the word alone."""
    B, C, G, K, D = shape
    v = _count_inputs(B, C, G, K, K + C, cuda)
    g = torch.Generator(device=cuda).manual_seed(C)
    seg_cell = torch.randint(0, D + 1, (B, C, G), generator=g, device=cuda,
                             dtype=torch.int32)
    th = (2, 3)
    for prediction in (True, False):
        before = kernels.launch_counts()
        got = pas.seg_counts_flags(v, seg_cell, K, *th, D, prediction)
        assert launched(before) == only(seg_counts=1)
        assert kernels.SEG_COUNTS.path == (kernels._act_name(K), "flags")
        want = pas.seg_counts_flags_ref(v, seg_cell, K, *th, D, prediction)
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            assert (a is None) == (b is None)
            assert a is None or torch.equal(a, b)
    assert bool((want[0] != 0).any())


@pytest.mark.cuda
@pytest.mark.parametrize("D", [1, 4, 8, 32, 33, 48, 64, 70])
def test_pack_bits_matches_plain(D, cuda):
    """`pack_bits` against `pack_bits_ref` at every path (ballot, v8,
    v4, v1), bit for bit; the dispatcher launches the kernel once,
    also for a non-contiguous input, which it makes contiguous."""
    g = torch.Generator(device=cuda).manual_seed(D)
    mask = torch.rand((5, 300, D), generator=g, device=cuda) < 0.4
    want = pas.pack_bits_ref(mask)
    before = kernels.launch_counts()
    got = pas.pack_bits(mask)
    torch.cuda.synchronize()
    assert launched(before) == only(pack_bits=1)
    assert kernels.PACK_BITS.path == (kernels._pack_path(D),)
    assert torch.equal(got, want)
    strided = mask.transpose(0, 1)
    assert torch.equal(pas.pack_bits(strided), pas.pack_bits_ref(strided))
    assert torch.equal(kernels.pack_bits_cuda(mask[:0]),
                       pas.pack_bits_ref(mask[:0]))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.int16, torch.float32])
@pytest.mark.parametrize("B,C,I_pad,A", [(2, 96, 1024, 7),
                                         (3, 2048, 1024, 41),
                                         (1, 40, 2048, 5)])
@pytest.mark.parametrize("edges", [False, True])
def test_sp_update_pack_matches_plain(dtype, B, C, I_pad, A, edges, cuda):
    """`sp_update_pack` against its plain version, both dtypes, with
    rows near the int16 rail that learn; with ``edges``, every row also
    holds values that change without learning (int16 past the +-32000
    rail, float32 -0.0), so the kernel must store vectors of inactive
    rows too. The dispatcher launches the kernel once."""
    g = torch.Generator(device=cuda).manual_seed(C + A)
    if dtype == torch.int16:
        perm = torch.randint(-300, 300, (B, C, I_pad), generator=g,
                             device=cuda, dtype=torch.int16)
        perm[:, :3, :16] = 31990
        delta = torch.randint(-3, 7, (B, I_pad), generator=g, device=cuda,
                              dtype=torch.int32) * 3
        thr = 0
    else:
        perm = (torch.rand((B, C, I_pad), generator=g, device=cuda) - 0.5) \
            * 0.2
        delta = (torch.rand((B, I_pad), generator=g, device=cuda) - 0.3) \
            * 0.05
        thr = 0.01
    cols = torch.stack([torch.randperm(C, generator=g, device=cuda)[:A]
                        for _ in range(B)]).int()
    cols[:, 0] = torch.arange(B, device=cuda)   # a railed row learns
    if edges and dtype == torch.int16:
        perm[:, :, 16:24], perm[:, :, 24:32] = 32767, -32768
    elif edges:
        perm[:, :, :32] = -0.0
    start, p_ref = perm.clone(), perm.clone()
    want_perm, want_pack = psp.sp_update_pack_ref(p_ref, delta, cols, thr)
    before = kernels.launch_counts()
    got_perm, got_pack = psp.sp_update_pack(perm, delta, cols, thr)
    torch.cuda.synchronize()
    assert launched(before) == only(sp_update_pack=1)
    assert got_perm is perm
    assert torch.equal(got_perm.view(torch.uint8),
                       want_perm.view(torch.uint8))
    assert torch.equal(got_pack, want_pack) and got_pack.any()
    if edges:
        inactive = ~pas.column_mask_from_cols(cols, C)
        changed = (want_perm.view(torch.uint8)
                   != start.view(torch.uint8)).reshape(B, C, -1).any(-1)
        assert changed[inactive].any()


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,bad", [
    ("small_table_take", "rank"), ("small_table_take", "dtype"),
    ("sp_update_pack", "dtype"), ("sp_update_pack", "align"),
    ("sp_update_pack", "threshold")])
def test_new_wrappers_reject_bad_inputs(kernel, bad, cuda):
    table = torch.zeros((2, 64), dtype=torch.int32, device=cuda)
    if bad == "rank":
        table = table[0]
    idx = torch.zeros((2, 8, 4), dtype=torch.int32, device=cuda)
    perm = torch.zeros((2, 8, 1024), dtype=torch.int16, device=cuda)
    delta = torch.zeros((2, 1024), dtype=torch.int32, device=cuda)
    cols = torch.zeros((2, 3), dtype=torch.int32, device=cuda)
    thr = 0.5 if bad == "threshold" else 0
    if bad == "dtype":
        idx, delta = idx.long(), delta.float()
    elif bad == "align":
        flat = torch.empty(perm.numel() + 1, dtype=torch.int16, device=cuda)
        perm = flat[1:].view(perm.shape)
    before = kernels.launch_counts()
    with pytest.raises((TypeError, ValueError)):
        if kernel == "small_table_take":
            kernels.small_table_take_cuda(table, idx)
        else:
            kernels.sp_update_pack_cuda(perm, delta, cols, thr)
    assert launched(before) == only()


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [0, 1])
def test_boost_keeps_the_contract_on_the_card(seed, cuda):
    """ROADMAP fault k at the bench shapes (B=256, C=2048, A=41,
    intensity 0.3, density 41/2048): the boost factor on the card within
    1 ulp of the CPU's, the boosted overlap within 2, and the same
    k-winner set in every stream whose top-k gap exceeds 4 ulp."""
    cfg = bt.make_htm_config(1000, 2048, 32).sp
    rng = np.random.default_rng(seed)
    B, C = 256, cfg.column_dim
    duty = rng.random((B, C), dtype=np.float32) * np.float32(3 * cfg.density)
    duty[rng.random((B, C)) < 0.1] = 0.0
    ov = rng.binomial(200, 0.1, (B, C)).astype(np.int32)
    got = boost_agreement(torch.from_numpy(duty), torch.from_numpy(ov),
                          cfg.boosting_intensity, cfg.density,
                          cfg.active_columns, cuda)
    assert got["ok"], got
    assert got["near_ties"] < B


@pytest.mark.cuda
def test_oracle_gate_on_the_card(cuda):
    """The single-stream step on the card at the reference stack's G=8,
    K=48 and float32 SP, judged every step by the port's NumPy oracle
    (`example.oracle_checked_run`, the CLI's ``--oracle``): learning
    launches `table_update` once a step, inference `act_conn`, nothing
    else."""
    from bithtm_tpu_torch import example

    cfg = bt.make_htm_config(200, 256, 8, 10, segment_activation_threshold=4,
                             segment_matching_threshold=4,
                             segment_sampling_synapses=8)
    rng = np.random.RandomState(0)
    xs = example.noisy_inputs(rng, rng.rand(4, 200) < 0.2, 5, 0.05)
    learning = [True] * 16 + [False] * 4
    before = kernels.launch_counts()
    res = example.oracle_checked_run(cfg, xs, learning, 0, cuda)
    assert res["steps"] == 20
    assert launched(before) == steps(table_update=16, act_conn=4)


@pytest.mark.cuda
def test_prefetch_and_encoders_on_the_card(cuda):
    """The encoders on the card equal the CPU's bit for bit; the
    likelihood and z on the card lie within the CPU tests' tolerances of
    the CPU's; chunks prefetched to the card arrive in order and equal,
    and a scan fed by them equals the scan over the whole tensor, every
    leaf and metric."""
    import copy

    from bithtm_tpu_torch.examples import likelihood_series
    from bithtm_tpu_torch.utils.data import prefetch_to_device

    rng = np.random.RandomState(0)
    v = torch.from_numpy(rng.uniform(-3, 3, (96, 32)).astype(np.float32))
    for enc in (bt.ScalarEncoder(-2.2, 2.2, 256, 17),
                bt.CyclicEncoder(24.0, 96, 9)):
        assert torch.equal(enc(v.to(cuda)).cpu(), enc(v))
    epochs = rng.randint(1_700_000_000, 2_300_000_000, 64)
    dt = bt.DateTimeEncoder()
    assert torch.equal(dt(epochs, cuda).cpu(), dt(epochs, "cpu"))

    scores = torch.from_numpy(rng.uniform(0, 0.3, (200, 8)).astype(
        np.float32))
    scores[150:160] = 1.0
    lik_cpu = likelihood_series(scores, 100, 0.7, 24)
    before = kernels.launch_counts()
    lik_gpu = likelihood_series(scores.to(cuda), 100, 0.7, 24).cpu()
    assert (lik_gpu - lik_cpu).abs().max() <= 2.4e-7
    z_cpu = bt.seasonal_zscore(v, 8, window=24)
    z_gpu = bt.seasonal_zscore(v.to(cuda), 8, window=24).cpu()
    assert bool(((z_gpu - z_cpu).abs() <= 2e-6 + 1e-6 * z_cpu.abs()).all())
    # each stage one launch of its kernel (csrc/anomaly_pass.cu)
    assert launched(before) == only(anomaly_likelihood=1, seasonal_zscore=1)

    cfg = bt.make_htm_config(64, 64, 4, 4, segment_activation_threshold=2,
                             segment_matching_threshold=2,
                             segment_sampling_synapses=8)
    pats = rng.rand(5, 64) < 0.2
    xs = pats[np.arange(48) % 5][:, None] ^ (rng.rand(48, 3, 64) < 0.05)
    chunks = [xs[i:i + 16] for i in range(0, 48, 16)]
    got = list(prefetch_to_device(iter(chunks), 2, cuda))
    assert all(g.is_cuda for g in got)
    assert all(torch.equal(g.cpu(), torch.from_numpy(c))
               for g, c in zip(got, chunks, strict=True))
    gen = torch.Generator(device=cuda).manual_seed(1)
    s0 = bt.htm_init_batch(cfg, 3, gen, cuda)
    gen_state = gen.get_state()
    direct, m_direct = bt.htm_scan(cfg, copy.deepcopy(s0),
                                   torch.from_numpy(xs).to(cuda), True,
                                   draws=bt.TorchDraws(cfg.tm, 3, cuda, gen))
    gen.set_state(gen_state)
    draws = bt.TorchDraws(cfg.tm, 3, cuda, gen)
    state, parts = s0, []
    for x in prefetch_to_device(iter(chunks), 2, cuda):
        state, m = bt.htm_scan(cfg, state, x, True, draws=draws)
        parts.append(m)
    for k, val in m_direct.items():
        assert torch.equal(torch.cat([m[k] for m in parts]), val), k
    a, b = bt.htm_state_to_numpy(state), bt.htm_state_to_numpy(direct)
    for part in ("sp", "tm"):
        for name, arr in a[part].items():
            np.testing.assert_array_equal(arr, b[part][name])


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [
    (3, 2048, 4, 64, 32, 41),    # the bench's table: an 8 KB bitmap
    (2, 16384, 1, 8, 64, 328),   # the 16K x 64 cell space: 128 KB
])
def test_table_kernels_on_a_column_shard(shape, cuda):
    """`table_update_cuda` and `act_conn_cuda` on a column shard (a
    quarter of the rows, ``column_dim`` the whole table's columns), whose
    presynaptic cells lie mostly in the other shards: equal to their
    plain versions and to the whole table's result at those rows."""
    B, C, G, K, D, A = shape
    x = table_inputs(sum(shape) + 9, *shape, device=cuda)
    cols, bits = x["cols"], x["bits"]
    rows = slice(C // 4, C // 2)
    syn, perm, act, pun = (x[k][:, rows].contiguous()
                           for k in ("syn", "perm", "act_prev", "pun_word"))
    p_full = x["perm"].clone()
    v_full = pas.table_update_ref(x["syn"], p_full, x["act_prev"].clone(),
                                  x["pun_word"], cols, bits, D, K, 0.01, 0.5)
    c_full = pas.synapse_activation_conn_ref(x["syn"], x["perm"], cols, bits,
                                             D, 0.5, K)
    p_ref, p_k = perm.clone(), perm.clone()
    before = kernels.launch_counts()
    v_ref = pas.table_update_ref(syn, p_ref, act.clone(), pun, cols, bits, D,
                                 K, 0.01, 0.5, column_dim=C)
    v_k = kernels.table_update_cuda(syn, p_k, act.clone(), pun, cols, bits,
                                    D, K, 0.01, 0.5, column_dim=C)
    c_ref = pas.synapse_activation_conn_ref(syn, perm, cols, bits, D, 0.5, K,
                                            column_dim=C)
    c_k = kernels.act_conn_cuda(syn, perm, cols, bits, D, 0.5, K,
                                column_dim=C)
    torch.cuda.synchronize()
    assert launched(before) == only(table_update=1, act_conn=1)
    assert torch.equal(v_k, v_ref) and torch.equal(v_ref, v_full[:, rows])
    assert torch.equal(p_k.view(torch.int32), p_ref.view(torch.int32))
    assert torch.equal(p_ref, p_full[:, rows])
    assert torch.equal(c_k, c_ref) and torch.equal(c_ref, c_full[:, rows])
    live = syn >= 0
    elsewhere = live & ((syn < rows.start * D) | (syn >= rows.stop * D))
    assert elsewhere.sum() > live.sum() // 2
    assert (elsewhere & (v_ref > 0)).any()


@pytest.mark.cuda
def test_model_parallel_step_on_the_card(cuda, tmp_path):
    """Two ranks on the card (worker processes, gloo on CUDA tensors) run
    a 1 x 2 model mesh: four learning and two serving steps equal the
    unsharded steps in every leaf (shards gathered) and every metric."""
    from .test_torch_multiprocess import load_tree, run_job

    kw = dict(input_dim=128, column_dim=512, cell_dim=32, active_columns=10,
              segments_per_column=4, synapse_capacity=16,
              segment_activation_threshold=3, segment_matching_threshold=3,
              segment_sampling_synapses=8)
    cfg = bt.make_htm_config(**kw)
    B, L, S = 4, 4, 2
    rng = np.random.RandomState(3)
    learn, serve = rng.rand(L, B, 128) < 0.2, rng.rand(S, B, 128) < 0.2
    np.savez(tmp_path / "inputs.npz", learn=learn, serve=serve)
    run_job([dict(name="card", mesh=[1, 2], config=kw, batch=B, init_seed=1,
                  draw_seed=2, inputs=str(tmp_path / "inputs.npz"),
                  device="cuda:0", out=str(tmp_path / "card"))],
            2, str(tmp_path), timeout=180)

    state = bt.htm_init_batch(cfg, B, torch.Generator().manual_seed(1), "cpu")
    state = bt.htm_state_from_numpy(bt.htm_state_to_numpy(state), cuda)
    draws = bt.TorchDraws(cfg.tm, B, cuda,
                          torch.Generator(device=cuda).manual_seed(2))
    ms = []
    for t, x in enumerate(np.concatenate([learn, serve])):
        state, out = bt.htm_step(cfg, state, torch.from_numpy(x).to(cuda),
                                 t < L, t < L, draws=draws,
                                 dense_outputs=False)
        ms.append(out.metrics)
    want = bt.htm_state_to_numpy(state)
    shards = [load_tree(str(tmp_path / f"card_rank{r}.npz")) for r in (0, 1)]
    from bithtm_tpu_torch.parallel.mesh import batched_state_specs

    for key, spec in batched_state_specs().items():
        part, name = key.split(".")
        got = [s[part][name] for s in shards]
        got = (np.concatenate(got, spec.index("model")) if "model" in spec
               else got[0])
        np.testing.assert_array_equal(got.view(np.uint8),
                                      want[part][name].view(np.uint8), key)
    for r in (0, 1):
        for phase, steps in (("learn", ms[:L]), ("serve", ms[L:])):
            for k in steps[0]:
                np.testing.assert_array_equal(
                    shards[r][phase][k],
                    torch.stack([m[k] for m in steps]).cpu().numpy(),
                    f"rank {r} {phase} {k}")


# ---- the compile layer: graph replays against the loop ----------------

GRAPH_CFG = dict(input_dim=128, column_dim=256, cell_dim=8,
                 active_columns=10, segments_per_column=4,
                 synapse_capacity=64, segment_activation_threshold=3,
                 segment_matching_threshold=3, segment_sampling_synapses=8,
                 sp_overrides={"permanence_dtype": "int16"})


def _leaves(state) -> dict:
    return {f"{part}.{f.name}": getattr(getattr(state, part), f.name)
            for part in ("sp", "tm")
            for f in dataclasses.fields(getattr(state, part))}


def _assert_same(a, b, what):
    if isinstance(a, dict):
        assert list(a) == list(b), what
        for k in a:
            assert torch.equal(a[k], b[k]), f"{what}: {k}"
    elif isinstance(a, tuple):
        for i, (x, y) in enumerate(zip(a, b, strict=True)):
            _assert_same(x, y, f"{what}[{i}]")
    elif a is None:
        assert b is None, what
    elif isinstance(a, torch.Tensor):
        assert torch.equal(a, b), what
    else:
        _assert_same(_leaves(a), _leaves(b), what)


def _card_sequence(T, B, I, seed, dev):
    rng = np.random.RandomState(seed)
    pats = rng.rand(7, B, I) < 0.2
    return torch.from_numpy(pats[np.arange(T) % 7]).to(dev)


def _scan_paths(cfg, B, dev, seeded):
    """Learning (150 steps: two input blocks), inference, and serving in
    the three forms from copies of the learned state; returns each
    path's (state, metrics, launches, generator state after it)."""
    import copy

    from bithtm_tpu_torch.models.htm import _scan_impl

    torch.manual_seed(3)
    gen = torch.Generator(device=dev).manual_seed(4) if seeded else None
    state = bt.htm_init_batch(cfg, B, torch.Generator(device=dev)
                              .manual_seed(5), dev)
    draws = bt.TorchDraws(cfg.tm, B, dev, gen)
    xs = _card_sequence(180, B, cfg.input_dim, 0, dev)
    out = {}

    def run(name, fn, st):
        before = kernels.launch_counts()
        st, m = fn(st)
        torch.cuda.synchronize()
        # a copy: the next run consumes the state (on the card, the same
        # graph buffers)
        out[name] = (copy.deepcopy(st), m, launched(before),
                     draws.get_state())
        return st

    state = run("learning", lambda s: bt.htm_scan(cfg, s, xs[:150], True,
                                                  draws=draws), state)
    state = run("inference", lambda s: bt.htm_scan(
        cfg, s, xs[150:160], False, draws=draws), state)
    tab = bt.make_serving_table(cfg.tm, state.tm)
    word = bt.pack_frozen_table(state.tm.synapse_cell, state.tm.synapse_perm,
                                cfg.tm.permanence_threshold,
                                num_cells=cfg.tm.num_cells)
    serve = xs[160:]
    run("unpacked", lambda s: bt.htm_serve_scan(cfg, s, serve),
        copy.deepcopy(state))
    run("packed", lambda s: bt.htm_serve_scan(cfg, s, serve,
                                              serving_table=tab),
        copy.deepcopy(state))
    run("frozen", lambda s: _scan_impl(cfg, s, serve, False, False, False,
                                       frozen_word=word),
        copy.deepcopy(state))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("seeded", [False, True])
def test_graph_replays_equal_the_loop(seeded, cuda):
    """`htm_scan` (learning, inference) and `htm_serve_scan` (unpacked,
    packed, frozen) replaying their graphs equal the loop in every leaf,
    metric and launch count (each kernel once a replayed step) and leave
    the generator where the loop leaves it, under the device's default
    generator and a seeded one."""
    from bithtm_tpu_torch.models import graph

    cfg = bt.make_htm_config(**GRAPH_CFG)
    with graph.eager():
        loop = _scan_paths(cfg, 4, cuda, seeded)
    replay = _scan_paths(cfg, 4, cuda, seeded)
    want = {"learning": steps(table_update=150),
            "inference": steps(act_conn=10), "unpacked": steps(act_conn=20),
            "packed": steps(serving_counts=20),
            "frozen": steps(act_frozen=20)}
    for name, (s, m, n, g) in replay.items():
        ls, lm, ln, lg = loop[name]
        _assert_same(s, ls, name)
        _assert_same(m, lm, name)
        assert n == ln == want[name], name
        assert torch.equal(g, lg), name
    assert int(replay["inference"][1]["correct"].sum()) > 0


@pytest.mark.cuda
def test_autocap_graph_escalates_like_the_loop(cuda):
    """An escalating `htm_scan_autocap` on the card: the tuned graph's
    dropping chunk restored into its buffers and re-run by the safe
    config's graph, with the tuned chunk's draws, equals the loop."""
    from bithtm_tpu_torch.models import graph

    kw = dict(input_dim=128, column_dim=96, cell_dim=8, active_columns=24,
              segments_per_column=4, synapse_capacity=16,
              segment_activation_threshold=3, segment_matching_threshold=3,
              segment_sampling_synapses=6)
    cfg = bt.make_htm_config(**kw)
    xs = _card_sequence(24, 2, 128, 5, cuda)

    def run():
        gen = torch.Generator(device=cuda).manual_seed(9)
        state = bt.htm_init_batch(cfg, 2, gen, cuda)
        draws = bt.TorchDraws(cfg.tm, 2, cuda, gen)
        before = kernels.launch_counts()
        s, m, info = bt.htm_scan_autocap(
            cfg, state, xs, tuned=dict(growth_capacity=8), chunk=4,
            draws=draws)
        torch.cuda.synchronize()
        return s, m, info, launched(before), gen.get_state()

    with graph.eager():
        loop = run()
    replay = run()
    assert replay[2] == loop[2] and loop[2]["escalated_at_step"] is not None
    _assert_same(replay[0], loop[0], "state")
    _assert_same(replay[1], loop[1], "metrics")
    assert replay[3] == loop[3]
    assert torch.equal(replay[4], loop[4])


@pytest.mark.cuda
def test_stack_graph_equals_the_loop(cuda):
    """`stack_scan` replaying its graph (two `htm_step`s and the dense
    layer-0 output a step) equals the loop, two table kernels a learning
    step and two `act_conn` an inference step. Six runs, each capturing
    its inference graph right behind its learning replays, the two
    graphs sharing one generator: a capture once reset the generator's
    device-side offset under replays still running, and about every
    third run then grew other synapses."""
    from bithtm_tpu_torch.models import graph

    cfg = bt.make_stack_config(128, [(256, 8), (128, 8)], active_columns=10,
                               segment_activation_threshold=3,
                               segment_matching_threshold=3,
                               segment_sampling_synapses=8)
    xs = _card_sequence(40, 3, 128, 6, cuda)

    def run():
        gen = torch.Generator(device=cuda).manual_seed(2)
        state = bt.stack_init(cfg, 3, gen, cuda)
        draws = bt.stack_draws(cfg, 3, cuda, gen)
        before = kernels.launch_counts()
        s, m1 = bt.stack_scan(cfg, state, xs[:32], True, draws)
        n1 = launched(before)
        s, m2 = bt.stack_scan(cfg, s, xs[32:], False, draws)
        torch.cuda.synchronize()
        return s, m1, m2, n1, launched(before)

    with graph.eager():
        loop = run()
    for _ in range(6):
        replay = run()
        for a, b, what in zip(replay[:3], loop[:3],
                              ("state", "learn", "infer")):
            _assert_same(a, b, what)
        assert replay[3] == loop[3] == steps(table_update=64)
        assert replay[4] == loop[4] == steps(table_update=64, act_conn=16)


@pytest.mark.cuda
def test_wrappers_replay_equal_the_loop(cuda):
    """The three wrappers' `process` at B=1 replaying their graphs equal
    the loop in every output, `last_metrics` value and leaf; a wrapper
    holding `HostTemporalMemory` runs the loop and captures nothing."""
    from bithtm_tpu_torch import networks as pnet
    from bithtm_tpu_torch.models import graph

    pats = np.random.RandomState(1).rand(5, 128) < 0.2
    kw = {k: v for k, v in GRAPH_CFG.items()
          if k not in ("input_dim", "column_dim", "cell_dim")}

    def run():
        htm = pnet.HierarchicalTemporalMemory(128, 256, 8, seed=1,
                                              device=cuda, **kw)
        sp = pnet.SpatialPooler(128, 256, 10, seed=2, device=cuda)
        tm = pnet.TemporalMemory(256, 8, 10, seed=3, device=cuda,
                                 segment_activation_threshold=3,
                                 segment_matching_threshold=3,
                                 segment_sampling_synapses=8)
        outs = []
        for t in range(24):
            learning = t < 18
            o = htm.process(pats[t % 5], learning, t % 3 != 2)
            s = sp.process(pats[t % 5], learning)
            m = tm.process(s, learning, epsilon=1e-6 if t % 4 == 0 else None)
            outs.append((o, dict(htm.last_metrics), s, m))
        torch.cuda.synchronize()
        return htm.state, sp.state, tm.state, outs

    with graph.eager():
        loop = run()
    replay = run()
    _assert_same(replay[0], loop[0], "htm state")
    for name, a, b in (("sp state", replay[1], loop[1]),
                       ("tm state", replay[2], loop[2])):
        for f in dataclasses.fields(a):
            assert torch.equal(getattr(a, f.name), getattr(b, f.name)), \
                (name, f.name)
    for t, ((o, mt, s, m), (lo, lmt, ls, lm)) in enumerate(
            zip(replay[3], loop[3])):
        assert mt == lmt, t
        _assert_same(tuple(o[0]) + tuple(o[1]), tuple(lo[0]) + tuple(lo[1]),
                     f"htm out {t}")
        _assert_same(tuple(s), tuple(ls), f"sp out {t}")
        _assert_same(tuple(m), tuple(lm), f"tm out {t}")

    host = pnet.HierarchicalTemporalMemory(
        128, 256, 8, device=cuda, temporal_memory=bt.HostTemporalMemory(
            lambda cols, learning: (np.zeros(2048, bool),) * 3), **kw)
    n = len(graph._LINEAGES)
    host.process(pats[0])
    assert len(graph._LINEAGES) == n, "the host TM was captured"


@pytest.mark.cuda
def test_capture_makes_no_host_sync(cuda, monkeypatch):
    """Every captured step, run under `torch.cuda.set_sync_debug_mode(
    "error")`, synchronizes nothing: learning, inference, the serving
    forms, the stack and a wrapper step capture without a raise."""
    from bithtm_tpu_torch import networks as pnet
    from bithtm_tpu_torch.models import graph

    real = graph._Graph.step_into_buffers
    captured = []

    def strict(self):
        if not torch.cuda.is_current_stream_capturing():
            return real(self)
        torch.cuda.set_sync_debug_mode("error")
        try:
            real(self)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        captured.append(self)

    monkeypatch.setattr(graph._Graph, "step_into_buffers", strict)
    cfg = bt.make_htm_config(**GRAPH_CFG)
    _scan_paths(cfg, 2, cuda, True)
    stack_cfg = bt.make_stack_config(128, [(256, 8), (128, 8)],
                                     active_columns=10)
    bt.stack_scan(stack_cfg, bt.stack_init(stack_cfg, 2, device=cuda),
                  _card_sequence(3, 2, 128, 1, cuda))
    kw = {k: v for k, v in GRAPH_CFG.items()
          if k not in ("input_dim", "column_dim", "cell_dim")}
    htm = pnet.HierarchicalTemporalMemory(128, 256, 8, device=cuda, **kw)
    htm.process(np.ones(128, bool))
    assert len(captured) == 7


@pytest.mark.cuda
def test_profiler_sees_one_kernel_a_replayed_step(cuda):
    """A `torch.profiler` trace of 8 replayed learning steps holds 8
    launches of `table_update`'s kernel, 8 of `sp_overlap`'s, 8 of
    `seg_counts`' (its flags form, `seg_flags_*kernel` on the card) and 8
    each of `row_counts`', `grow_select`'s and `learn_rows`', as the
    launch counts say."""
    cfg = bt.make_htm_config(**GRAPH_CFG)
    gen = torch.Generator(device=cuda).manual_seed(0)
    state = bt.htm_init_batch(cfg, 4, gen, cuda)
    draws = bt.TorchDraws(cfg.tm, 4, cuda, gen)
    xs = _card_sequence(16, 4, 128, 2, cuda)
    state, _ = bt.htm_scan(cfg, state, xs[:8], True, draws=draws)
    torch.cuda.synchronize()
    before = kernels.launch_counts()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        state, _ = bt.htm_scan(cfg, state, xs[8:], True, draws=draws)
        torch.cuda.synchronize()
    seen = {name: sum(1 for e in prof.events()
                      if e.device_type == torch.autograd.DeviceType.CUDA
                      and name in e.name)
            for name in ("table_pass_kernel", "sp_overlap_kernel",
                         "seg_flags", "row_counts_kernel",
                         "grow_select_kernel", "learn_rows_kernel")}
    assert launched(before) == steps(table_update=8)
    assert seen == dict.fromkeys(seen, 8)


# the paths the kernels take past the shapes of their first design
# (ops/kernels.py): (B, C, G, K, D, A) and the path the table kernels take
PATH_SHAPES = {
    "K126 bf16": ((2, 64, 2, 126, 32, 5), ("smem", "bf16")),
    "K127 bf16, J % 4 != 0": ((2, 64, 2, 127, 32, 5), ("smem", "bf16")),
    "K128 f32": ((2, 64, 2, 128, 32, 5), ("smem", "f32")),
    # one column past the shared-memory bitmap at D=64
    "global bitmap": ((2, 29_057, 1, 8, 64, 20), ("global", "u8")),
    "global bitmap, K128, J % 4 != 0 rows": ((1, 29_057, 1, 129, 64, 20),
                                             ("global", "f32")),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(PATH_SHAPES))
def test_kernel_paths_match_plain(case, cuda):
    """`table_update`, `act_conn`, `act_frozen` and, past the bitmap
    limit, `serving_activation` and `synapse_activation` on each path
    (the packed activity in bf16 or float32, the global-memory bitmap),
    bit-equal to their plain versions, reporting the path they took."""
    shape, path = PATH_SHAPES[case]
    B, C, G, K, D, A = shape
    x = table_inputs(sum(shape), *shape, device=cuda)
    cols, bits = x["cols"], x["bits"]
    p_ref, p_k = x["perm"].clone(), x["perm"].clone()
    v_ref = pas.table_update_ref(x["syn"], p_ref, x["act_prev"].clone(),
                                 x["pun_word"], cols, bits, D, K, 0.01, 0.5)
    v_k = kernels.table_update_cuda(x["syn"], p_k, x["act_prev"].clone(),
                                    x["pun_word"], cols, bits, D, K, 0.01,
                                    0.5)
    assert kernels.TABLE_UPDATE.path == path
    c_k = kernels.act_conn_cuda(x["syn"], x["perm"], cols, bits, D, 0.5, K)
    word = pas.pack_frozen_table(x["syn"], x["perm"], 0.5)
    f_k = kernels.act_frozen_cuda(word, cols, bits, D, K)
    assert kernels.ACT_FROZEN.path == (*path, "grid_y")
    torch.cuda.synchronize()
    assert v_k.dtype == pas.act_dtype(K) and torch.equal(v_k, v_ref)
    assert torch.equal(p_k.view(torch.int32), p_ref.view(torch.int32))
    c_ref = pas.synapse_activation_conn_ref(x["syn"], x["perm"], cols, bits,
                                            D, 0.5, K)
    assert torch.equal(c_k, c_ref)
    assert torch.equal(f_k, pas.synapse_activation_frozen_ref(word, cols,
                                                              bits, D, K))
    assert (v_ref > 1).any() and (p_ref != x["perm"]).any()
    if path[0] == "global":
        rows = serving_rows(sum(shape) + 1, B, C + 8, C, D, G, device=cuda)
        s_k = kernels.serving_activation_cuda(rows, cols, bits, C, D)
        a_k = kernels.synapse_activation_cuda(x["syn"], cols, bits, C, D)
        assert kernels.SERVING_ACTIVATION.path == ("global",)
        assert kernels.SYNAPSE_ACTIVATION.path == ("global",)
        torch.cuda.synchronize()
        assert torch.equal(s_k, psv.serving_activation_ref(rows, cols, bits,
                                                           C, D))
        assert torch.equal(a_k, pas.synapse_activation_ref(x["syn"], cols,
                                                           bits, C, D))
        # a column shard of the first rows over all C columns
        R = C // 3
        sh = {k: x[k][:, :R].contiguous()
              for k in ("syn", "perm", "act_prev", "pun_word")}
        p_ref, p_k = sh["perm"].clone(), sh["perm"].clone()
        v_ref = pas.table_update_ref(sh["syn"], p_ref, sh["act_prev"].clone(),
                                     sh["pun_word"], cols, bits, D, K, 0.01,
                                     0.5, column_dim=C)
        v_k = kernels.table_update_cuda(sh["syn"], p_k, sh["act_prev"].clone(),
                                        sh["pun_word"], cols, bits, D, K,
                                        0.01, 0.5, column_dim=C)
        assert kernels.TABLE_UPDATE.path == path
        torch.cuda.synchronize()
        assert torch.equal(v_k, v_ref)
        assert torch.equal(p_k.view(torch.int32), p_ref.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["act_frozen streams", "sp streams",
                                  "sp gmem int16", "sp gmem float32"])
def test_stream_and_delta_paths_match_plain(case, cuda):
    """Past 65,535 streams `act_frozen` and `sp_update_pack` fold the
    streams into grid x; past its shared memory `sp_update_pack` reads
    the delta row and the column bitmap from global memory. Each is
    bit-equal to its plain version."""
    g = torch.Generator(device=cuda).manual_seed(31)
    if case == "act_frozen streams":
        x = table_inputs(31, 65_536, 2, 1, 8, 4, 1, device=cuda)
        word = pas.pack_frozen_table(x["syn"], x["perm"], 0.5)
        got = kernels.act_frozen_cuda(word, x["cols"], x["bits"], 4, 8)
        assert kernels.ACT_FROZEN.path == ("smem", "u8", "grid_x_streams")
        want = pas.synapse_activation_frozen_ref(word, x["cols"], x["bits"],
                                                 4, 8)
        torch.cuda.synchronize()
        assert torch.equal(got, want) and (want > 1).any()
        return
    B, C, I_pad = (65_536, 2, 1024) if case == "sp streams" else (
        2, 64, 59_392)
    if case.endswith("float32"):
        perm = torch.rand((B, C, I_pad), generator=g, device=cuda)
        delta = torch.rand((B, I_pad), generator=g, device=cuda) - 0.5
        thr = 0.5
    else:
        perm = torch.randint(-3000, 3000, (B, C, I_pad), generator=g,
                             device=cuda, dtype=torch.int16)
        delta = torch.randint(-100, 100, (B, I_pad), generator=g,
                              device=cuda, dtype=torch.int32)
        thr = 1000
    cols = torch.rand((B, C), generator=g, device=cuda).topk(
        max(1, C // 4), -1).indices.to(torch.int32)
    p_ref, p_k = perm.clone(), perm.clone()
    _, pack_ref = psp.sp_update_pack_ref(p_ref, delta, cols, thr)
    _, pack_k = kernels.sp_update_pack_cuda(p_k, delta, cols, thr)
    assert kernels.SP_UPDATE_PACK.path == (
        ("smem_delta", "grid_x_streams") if case == "sp streams"
        else ("gmem_delta", "grid_y"))
    torch.cuda.synchronize()
    assert torch.equal(pack_k, pack_ref) and pack_ref.any()
    assert torch.equal(p_k.view(torch.uint8), p_ref.view(torch.uint8))
    assert not torch.equal(p_ref, perm)


# ---- the SP overlap and the per-segment count decode (csrc/overlap_pass.cu,
# csrc/count_pass.cu)

OVERLAP_SHAPES = [  # B, C, input_dim
    (2, 64, 1000),       # S = 128, the bench's input
    (1, 37, 1031),       # B=1, C off a multiple of 32, S = 256
    (3, 130, 2500),      # S = 384, a ragged last row block
    (2, 5, 64),          # fewer inputs than a row's bytes
    (2, 3, 40_000),      # S = 5,120: x staged in two tiles
    (256, 2048, 1000),   # the bench's shapes
    (64, 16384, 1000),   # the 16K x 64 shapes
]
COUNT_SHAPES = [  # B, C, G, K
    (2, 64, 4, 64),      # the bench's G, K: scale 65, 16-byte vectors
    (3, 40, 8, 48),      # the reference stack's: three vectors a segment
    (2, 30, 3, 7),       # one byte a load
    (2, 7, 2, 124),      # 4-byte words
    (2, 64, 2, 125),     # the last u8 K
    (2, 64, 2, 126),     # bf16, 4-byte words
    (2, 64, 2, 127),     # bf16, one value a load
    (2, 64, 2, 128),     # float32
    (2, 5, 1, 300),      # float32, 75 vectors over 32 lanes
    (256, 2048, 4, 64),  # the bench's shapes
    (64, 16384, 4, 64),  # the 16K x 64 shapes
]


def _overlap_inputs(B, C, I, seed, dev):
    g = torch.Generator(device=dev).manual_seed(seed)
    conn = torch.randint(0, 256, (B, C, pov.input_words(I)), generator=g,
                         device=dev, dtype=torch.uint8)
    return conn, torch.rand((B, I), generator=g, device=dev) < 0.3


def _count_inputs(B, C, G, K, seed, dev):
    g = torch.Generator(device=dev).manual_seed(seed)
    act = torch.rand((B, C, G * K), generator=g, device=dev) < 0.5
    conn = act & (torch.rand((B, C, G * K), generator=g, device=dev) < 0.4)
    return pas.pack_act_conn(act, conn, K)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", OVERLAP_SHAPES)
def test_sp_overlap_matches_plain(shape, cuda):
    """`sp_overlap` (which packs the inputs itself) equals `overlaps_ref`
    bit for bit, in one launch."""
    B, C, I = shape
    conn, x = _overlap_inputs(B, C, I, I + C, cuda)
    before = kernels.launch_counts()
    got = kernels.sp_overlap_cuda(conn, x)
    assert launched(before) == only(sp_overlap=1)
    want = pov.overlaps_ref(conn, x)
    torch.cuda.synchronize()
    assert torch.equal(got, want) and bool((want > 0).any())
    assert kernels.SP_OVERLAP.path == ("grid_y",)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", COUNT_SHAPES)
def test_seg_counts_matches_plain(shape, cuda):
    """`seg_counts` equals `seg_counts_packed_ref` bit for bit on u8, bf16
    and float32 activity, in one launch on the path of its type."""
    B, C, G, K = shape
    v = _count_inputs(B, C, G, K, K + C, cuda)
    before = kernels.launch_counts()
    pot, con = kernels.seg_counts_cuda(v, G, K)
    assert launched(before) == only(seg_counts=1)
    rp, rc = pas.seg_counts_packed_ref(v, G, K)
    torch.cuda.synchronize()
    assert torch.equal(pot, rp) and torch.equal(con, rc)
    assert bool((rc > 0).any()) and bool((rp > 0).any())
    assert kernels.SEG_COUNTS.path == (kernels._act_name(K),)


@pytest.mark.cuda
def test_overlap_and_counts_fold_streams_into_grid_x(cuda):
    """65,536 streams, past the grid's y extent: `sp_overlap` folds them
    into grid x; `seg_counts`' grid strides over every segment."""
    B = 65_536
    conn, x = _overlap_inputs(B, 2, 1000, 1, cuda)
    got = kernels.sp_overlap_cuda(conn, x)
    assert kernels.SP_OVERLAP.path == ("grid_x_streams",)
    v = _count_inputs(B, 2, 2, 64, 2, cuda)
    pot, con = kernels.seg_counts_cuda(v, 2, 64)
    rp, rc = pas.seg_counts_packed_ref(v, 2, 64)
    torch.cuda.synchronize()
    assert torch.equal(got, pov.overlaps_ref(conn, x))
    assert torch.equal(pot, rp) and torch.equal(con, rc)


@pytest.mark.cuda
def test_overlap_and_counts_launch_on_the_current_stream(cuda):
    """`sp_overlap` and `seg_counts` launched under
    ``torch.cuda.stream(side)`` run on ``side``: their inputs are written
    there only after a spin of about 20 ms."""
    conn, x = _overlap_inputs(4, 300, 1000, 3, cuda)
    v = _count_inputs(4, 300, 4, 64, 4, cuda)
    conn_late, x_late = torch.zeros_like(conn), torch.zeros_like(x)
    v_late = torch.zeros_like(v)
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        torch.cuda._sleep(40_000_000)
        conn_late.copy_(conn)
        x_late.copy_(x)
        v_late.copy_(v)
        got = kernels.sp_overlap_cuda(conn_late, x_late)
        pot, con = kernels.seg_counts_cuda(v_late, 4, 64)
    side.synchronize()
    rp, rc = pas.seg_counts_packed_ref(v, 4, 64)
    torch.cuda.synchronize()
    assert torch.equal(got, pov.overlaps_ref(conn, x))
    assert torch.equal(pot, rp) and torch.equal(con, rc)
    assert bool((got > 0).any()) and bool((rc > 0).any())


@pytest.mark.cuda
def test_overlap_and_count_dispatch_launch_each_kernel_once(cuda):
    """On CUDA tensors `overlaps` and `seg_counts_packed` launch their
    kernels once a call, and `table_update`'s dispatcher its kernel and
    the count decode's flags form once each; the results equal the
    CPU's."""
    conn, x = _overlap_inputs(3, 100, 1000, 5, cuda)
    v = _count_inputs(3, 100, 4, 64, 6, cuda)
    before = kernels.launch_counts()
    ov = pov.overlaps(conn, x)
    assert launched(before) == only(sp_overlap=1)
    before = kernels.launch_counts()
    pot, con = pas.seg_counts_packed(v, 4, 64)
    assert launched(before) == only(seg_counts=1)
    t = table_inputs(3, *SHAPES[0], device=cuda)
    before = kernels.launch_counts()
    out = pas.table_update(t["syn"], t["perm"], t["act_prev"],
                           t["pun_word"], t["cols"], t["bits"],
                           t["seg_cell"], 32, 0.01, 0.5, 3, 2)
    assert launched(before) == only(table_update=1, seg_counts=1)
    assert torch.equal(ov.cpu(), pov.overlaps(conn.cpu(), x.cpu()))
    rp, rc = pas.seg_counts_packed(v.cpu(), 4, 64)
    assert torch.equal(pot.cpu(), rp) and torch.equal(con.cpu(), rc)
    word, pred = pas.seg_counts_flags(out[1].cpu(), t["seg_cell"].cpu(), 64,
                                      3, 2, 32)
    assert torch.equal(out[2].cpu(), word) and torch.equal(out[3].cpu(),
                                                           pred)


@pytest.mark.cuda
@pytest.mark.parametrize("bad", ["dtype", "contiguity", "alignment"])
def test_overlap_and_count_wrappers_reject_bad_inputs(bad, cuda):
    """A wrong type, a strided view or a table off a 16-byte boundary
    raises before anything launches."""
    conn, x = _overlap_inputs(2, 8, 1000, 7, cuda)
    v = _count_inputs(2, 8, 4, 64, 8, cuda)
    if bad == "dtype":
        calls = (lambda: kernels.sp_overlap_cuda(conn, x.to(torch.uint8)),
                 lambda: kernels.seg_counts_cuda(v.to(torch.int32), 4, 64))
        err = TypeError
    elif bad == "contiguity":
        wide = torch.zeros((2, 2000), dtype=torch.bool, device=cuda)
        calls = (lambda: kernels.sp_overlap_cuda(conn, wide[:, ::2]),
                 lambda: kernels.seg_counts_cuda(
                     torch.zeros((2, 16, 256), dtype=torch.uint8,
                                 device=cuda)[:, ::2], 4, 64))
        err = ValueError
    else:
        flat = torch.zeros(conn.numel() + 16, dtype=torch.uint8, device=cuda)
        flat_v = torch.zeros(v.numel() + 16, dtype=torch.uint8, device=cuda)
        calls = (lambda: kernels.sp_overlap_cuda(
                     flat[1:1 + conn.numel()].view(conn.shape), x),
                 lambda: kernels.seg_counts_cuda(
                     flat_v[1:1 + v.numel()].view(v.shape), 4, 64))
        err = ValueError
    before = kernels.launch_counts()
    for call in calls:
        with pytest.raises(err):
            call()
    assert launched(before) == only()


# ---- the SP's update of its active rows (csrc/sp_pass.cu sp_rows) and
# the step's activity written in place

SP_ROWS_SHAPES = {  # B, C, I, A, permanence dtype
    "bench": (256, 2048, 1000, 41, torch.int16),
    "16k": (64, 16384, 1000, 328, torch.int16),
    "reference B=1": (1, 2048, 1000, 41, torch.float32),
    "anomaly": (256, 512, 352, 16, torch.float32),
    "stack layer 2": (256, 512, 4096, 16, torch.float32),
    "two tiles": (2, 64, 40_000, 5, torch.int16),
    "two tiles f32": (2, 64, 40_000, 5, torch.float32),
    "streams": (65_536, 2, 1000, 1, torch.int16),
    # a run of units spanning tiles of several rows (B=1: 264 runs)
    "runs across tiles": (1, 64, 40_000, 7, torch.float32),
    # past the first-claim bitmaps: each unit checks the entries before it
    "scan claims": (1, 65_537, 1000, 41, torch.int16),
}


def _sp_rows_inputs(B, C, I, A, dtype, seed, dev, duplicate=True):
    """Tables with values that change without learning in every row
    (int16 past the rail, float32 -0.0, also on padding lanes), rows at
    the rail that learn, a density-0.2 input and A columns a stream, one
    of them listed twice where A > 2."""
    g = torch.Generator(device=dev).manual_seed(seed)
    I_pad = pov.padded_input_dim(I)
    if dtype == torch.int16:
        perm = torch.randint(-300, 300, (B, C, I_pad), generator=g,
                             device=dev, dtype=torch.int16)
        perm[..., I:] = -32000
        perm[..., :4], perm[..., 4:8] = 32000, -32000
        perm[..., 8:16], perm[..., 16:24] = 32767, -32768
    else:
        perm = (torch.rand((B, C, I_pad), generator=g, device=dev) - 0.5) \
            * 0.2
        perm[..., :16] = -0.0
        perm[..., I:] = -0.0
    conn = torch.randint(0, 256, (B, C, I_pad // 8), generator=g,
                         device=dev, dtype=torch.uint8)
    x = torch.rand((B, I), generator=g, device=dev) < 0.2
    cols = torch.rand((B, C), generator=g, device=dev).topk(
        A, -1).indices.to(torch.int32)
    if duplicate and A > 2:
        cols[:, -1] = cols[:, 1]
    return perm, conn, x, cols


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(SP_ROWS_SHAPES))
def test_sp_rows_matches_plain(case, cuda):
    """`sp_rows` == `sp_rows_ref` bit for bit on both tables at the
    bench, 16K, reference-stack, anomaly and stack shapes, a row wider
    than a block's tile and 65,536 streams, with a column listed twice;
    rows outside the active columns keep every bit."""
    B, C, I, A, dtype = SP_ROWS_SHAPES[case]
    cfg = bt.make_htm_config(I, C, 4, active_columns=A, sp_overrides={
        "permanence_dtype": "int16" if dtype == torch.int16 else "float32"})
    perm, conn, x, cols = _sp_rows_inputs(B, C, I, A, dtype, C + A, cuda)
    p_ref, c_ref = perm.clone(), conn.clone()
    psp.sp_rows_ref(cfg.sp, p_ref, c_ref, x, cols)
    before = kernels.launch_counts()
    got = psp.sp_rows(cfg.sp, perm.clone(), conn.clone(), x, cols)
    torch.cuda.synchronize()
    assert launched(before) == only(sp_rows=1)
    assert kernels.SP_ROWS.path == (
        "grid_x_streams" if B > 65_535 else "grid_y",
        "scan" if C > 65_536 else "bitmap")
    assert torch.equal(got[0].view(torch.uint8), p_ref.view(torch.uint8))
    assert torch.equal(got[1], c_ref)
    inactive = ~pas.column_mask_from_cols(cols, C)
    assert torch.equal(p_ref.view(torch.uint8)[inactive],
                       perm.view(torch.uint8)[inactive])
    assert torch.equal(c_ref[inactive], conn[inactive])
    assert not torch.equal(p_ref, perm)


@pytest.mark.cuda
@pytest.mark.parametrize("B,C,A", [(8, 300, 200), (64, 16384, 328),
                                   (2, 65_537, 60)])
def test_sp_rows_skips_repeats_and_ids_out_of_range(B, C, A, cuda):
    """Columns drawn with replacement (repeats within a block and across
    a stream's blocks) and ids outside [0, C): `sp_rows` updates each
    listed row once and skips the others, as the plain version does with
    each bad id replaced by a repeat of the stream's first column."""
    cfg = bt.make_htm_config(1000, C, 4, active_columns=A)
    perm, conn, x, _ = _sp_rows_inputs(B, C, 1000, 1, torch.float32, C + A,
                                       cuda)
    g = torch.Generator(device=cuda).manual_seed(A)
    cols = torch.randint(0, min(C, 3 * A), (B, A), generator=g, device=cuda,
                         dtype=torch.int32)
    cols[:, 3::7] = -1
    cols[:, 5::11] = C
    good = torch.where((cols >= 0) & (cols < C), cols, cols[:, :1])
    p_ref, c_ref = perm.clone(), conn.clone()
    psp.sp_rows_ref(cfg.sp, p_ref, c_ref, x, good)
    got = kernels.sp_rows_cuda(perm.clone(), conn.clone(), x, cols,
                               *psp.hebbian_steps(cfg.sp))
    torch.cuda.synchronize()
    assert torch.equal(got[0].view(torch.uint8), p_ref.view(torch.uint8))
    assert torch.equal(got[1], c_ref)


@pytest.mark.cuda
@pytest.mark.parametrize("A", [0, 1])
def test_sp_rows_takes_no_or_one_column(A, cuda):
    """No active column leaves the tables as they were and launches
    nothing; one column at B=1 equals the plain version."""
    cfg = bt.make_htm_config(1000, 64, 4, active_columns=1)
    perm, conn, x, cols = _sp_rows_inputs(1, 64, 1000, 1, torch.float32, A,
                                          cuda)
    cols = cols[:, :A].contiguous()
    p, c = perm.clone(), conn.clone()
    p_ref, c_ref = perm.clone(), conn.clone()
    psp.sp_rows_ref(cfg.sp, p_ref, c_ref, x, cols)
    before = kernels.launch_counts()
    kernels.sp_rows_cuda(p, c, x, cols, *psp.hebbian_steps(cfg.sp))
    torch.cuda.synchronize()
    assert launched(before) == only(sp_rows=A)
    assert torch.equal(p.view(torch.int32), p_ref.view(torch.int32))
    assert torch.equal(c, c_ref)
    assert torch.equal(p.view(torch.int32), perm.view(torch.int32)) == (A == 0)


@pytest.mark.cuda
def test_sp_step_launches_sp_rows_once_a_learning_step(cuda):
    """A learning `sp_step` launches `sp_overlap`, `sp_select` and
    `sp_rows` once each and equals the CPU's step; an inference step
    launches no `sp_rows`; a column shard's step keeps its own update (no
    `sp_rows`)."""
    hcfg = bt.make_htm_config(1000, 2048, 32, active_columns=41,
                              sp_overrides={"permanence_dtype": "int16"})
    state = bt.htm_init_batch(hcfg, 4, torch.Generator().manual_seed(2),
                              "cpu").sp
    x = torch.rand((4, 1000), generator=torch.Generator().manual_seed(3)) \
        < 0.2
    on = dataclasses.replace(state, **{
        f.name: getattr(state, f.name).to(cuda)
        for f in dataclasses.fields(state)})
    before = kernels.launch_counts()
    got, _ = psp.sp_step(hcfg.sp, on, x.to(cuda), True)
    torch.cuda.synchronize()
    assert launched(before) == only(sp_overlap=1, sp_rows=1, sp_select=1)
    want, _ = psp.sp_step(hcfg.sp, state, x, True)
    for f in dataclasses.fields(want):
        assert torch.equal(getattr(got, f.name).cpu(),
                           getattr(want, f.name)), f.name
    before = kernels.launch_counts()
    psp.sp_step(hcfg.sp, got, x.to(cuda), False)
    torch.cuda.synchronize()
    assert launched(before) == only(sp_overlap=1, sp_select=1)


def _table_update_into(x, act_prev, v_out, D, K, path_global):
    """The `table_update` entry point with separate act_prev and v_out
    buffers (the out-of-place form the wrapper no longer takes)."""
    syn, perm = x["syn"], x["perm"]
    B, C, J = syn.shape
    A, W = x["cols"].shape[-1], x["bits"].shape[-1]
    dev = syn.get_device()
    _scratch, bm_p = kernels._bitmap_scratch(
        "global" if path_global else "smem", B, C, D, syn.device)
    kernels.TABLE_UPDATE.bind()(
        syn.data_ptr(), perm.data_ptr(), act_prev.data_ptr(),
        x["pun_word"].data_ptr(), x["cols"].data_ptr(),
        x["bits"].data_ptr(), bm_p, v_out.data_ptr(), B, C, C, J, A, W, D,
        K, 0.01, 0.5, pas.act_scale(K), act_prev.element_size(), dev,
        kernels._stream(dev))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [
    (256, 2048, 4, 64, 32, 41),   # the bench's
    (64, 2048, 2, 126, 32, 41),   # bf16 activity
    (64, 2048, 2, 128, 32, 41),   # float32 activity
    (2, 7, 2, 8, 4, 3),           # J % 4 != 0
    (4, 32_768, 1, 64, 64, 20),   # the global bitmap
])
def test_table_update_in_place_equals_out_of_place(shape, cuda):
    """`table_update_cuda` writes the activity over ``act_prev`` and
    returns it; the result, and the punished permanences, equal the
    kernel's out-of-place form (separate buffers) on a copy and the
    plain version, which writes in place too. `act_conn` and
    `act_frozen` with ``out`` fill the buffer given with what they
    return otherwise."""
    B, C, G, K, D, A = shape
    x = table_inputs(sum(shape), *shape, device=cuda)
    act = x["act_prev"].clone()
    p_k = x["perm"].clone()
    v = kernels.table_update_cuda(x["syn"], p_k, act, x["pun_word"],
                                  x["cols"], x["bits"], D, K, 0.01, 0.5)
    assert v is act
    out_of_place = torch.empty_like(act)
    y = dict(x, perm=x["perm"].clone())
    _table_update_into(y, x["act_prev"], out_of_place, D, K,
                       kernels.TABLE_UPDATE.path[0] == "global")
    p_ref, a_ref = x["perm"].clone(), x["act_prev"].clone()
    v_ref = pas.table_update_ref(x["syn"], p_ref, a_ref, x["pun_word"],
                                 x["cols"], x["bits"], D, K, 0.01, 0.5)
    torch.cuda.synchronize()
    assert v_ref is a_ref
    assert torch.equal(act, out_of_place) and torch.equal(act, v_ref)
    assert torch.equal(p_k.view(torch.int32), y["perm"].view(torch.int32))
    assert torch.equal(p_k.view(torch.int32), p_ref.view(torch.int32))
    assert not torch.equal(act, x["act_prev"])
    buf = torch.full_like(act, 7)
    c = kernels.act_conn_cuda(x["syn"], x["perm"], x["cols"], x["bits"], D,
                              0.5, K, out=buf)
    assert c is buf and torch.equal(c, kernels.act_conn_cuda(
        x["syn"], x["perm"], x["cols"], x["bits"], D, 0.5, K))
    word = pas.pack_frozen_table(x["syn"], x["perm"], 0.5)
    buf = torch.full_like(act, 7)
    f = kernels.act_frozen_cuda(word, x["cols"], x["bits"], D, K, out=buf)
    torch.cuda.synchronize()
    assert f is buf and torch.equal(f, pas.synapse_activation_frozen_ref(
        word, x["cols"], x["bits"], D, K))


@pytest.mark.cuda
@pytest.mark.parametrize("learning", [True, False])
def test_loop_step_writes_the_state_buffers_on_the_card(learning, cuda):
    """On the card a loop step writes the activity (and, learning, the
    owners) into the buffers of the state it was given, and one
    learning step launches one `sp_rows`."""
    from bithtm_tpu_torch.models import graph as bgraph

    cfg = bt.make_htm_config(64, 64, 4, active_columns=4,
                             segment_activation_threshold=2,
                             segment_matching_threshold=2,
                             segment_sampling_synapses=8)
    gen = torch.Generator(device=cuda).manual_seed(9)
    state = bt.htm_init_batch(cfg, 2, gen, cuda)
    xs = torch.rand((4, 2, 64), generator=gen, device=cuda) < 0.2
    draws = bt.TorchDraws(cfg.tm, 2, cuda, gen)
    with bgraph.eager():
        state, _ = bt.htm_scan(cfg, state, xs, True, draws=draws)
        act, seg_cell = state.tm.synapse_act, state.tm.seg_cell
        before = kernels.launch_counts()
        new, _ = bt.htm_scan(cfg, state, xs[:2], learning, draws=draws)
    torch.cuda.synchronize()
    assert new.tm.synapse_act is act
    assert new.tm.seg_cell is seg_cell
    want = (steps(table_update=2) if learning else steps(act_conn=2))
    assert launched(before) == want
    assert want["sp_rows"] == (2 if learning else 0)


# ---- the SP's column selection (csrc/select_pass.cu sp_select): B, C, A
# and the inputs' kind (`testing.select_inputs`) at the SP of each path,
# tie-heavy streams, -0.0, C off a multiple of 4, A = 0, 1 and C, each
# thread count and key count, the keys and the winners' list in global
# memory, and 65,536 streams

SELECT_SHAPES = {
    "bench": (256, 2048, 41, "random"),
    "16k": (64, 16384, 328, "random"),
    "anomaly": (256, 512, 16, "random"),
    "reference B=1": (1, 2048, 41, "random"),
    "bench ties": (8, 2048, 41, "ties"),
    "16k ties": (2, 16384, 328, "ties"),
    "negative": (8, 2048, 41, "negative"),
    "C=37": (3, 37, 5, "random"),
    "C=250 A=1": (2, 250, 1, "random"),
    "C=250 A=C": (2, 250, 250, "ties"),
    "C=37 A=0": (2, 37, 0, "random"),
    "C=1999": (3, 1999, 40, "ties"),
    "C=4096": (2, 4096, 80, "random"),
    "C=9001": (2, 9001, 180, "ties"),
    "global keys": (2, 20_000, 400, "random"),
    "global keys ties": (2, 20_000, 400, "ties"),
    "global list": (1, 30_000, 30_000, "random"),
    "B=65536": (65_536, 64, 5, "random"),
    # a warp a stream: several streams a block, C off a multiple of 32,
    # 64 winners, ties (in about half the streams more than 32 equal keys
    # at the A-th value) and -0.0
    "warp C=64": (300, 64, 5, "random"),
    "warp ties": (2048, 128, 40, "ties"),
    "warp A=64": (2048, 100, 64, "random"),
    "warp negative": (2048, 120, 12, "negative"),
    # past 64 winners or 128 columns: a block a stream
    "C=512 A=65": (4, 512, 65, "ties"),
    "C=129": (4, 129, 16, "ties"),
    # the winners placed by the LSD radix sort: lists in shared memory,
    # in global memory, ties
    "lsd smem": (2, 4096, 1000, "random"),
    "lsd smem ties": (2, 9001, 2000, "ties"),
    "lsd global": (2, 30_000, 12_000, "random"),
    "lsd global ties": (1, 20_000, 15_000, "ties"),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(SELECT_SHAPES))
def test_sp_select_matches_plain(case, cuda):
    """`sp_select` on the card (one launch of its kernel, on the path its
    shapes choose) == `sp_select_ref` on the card, bit for bit: the
    boosted values, the winners in order, the mask and the new duty
    cycles; the duty cycles given keep their values."""
    B, C, A, kind = SELECT_SHAPES[case]
    ov, duty = testing.select_inputs(B + C + A, B, C, kind, device=cuda)
    args = (A, testing.SELECT_INTENSITY, max(A, 1) / C,
            testing.SELECT_MOMENTUM)
    kept = duty.clone()
    before = kernels.launch_counts()
    got = preg.sp_select(ov, duty, *args)
    want = preg.sp_select_ref(ov, duty, *args)
    torch.cuda.synchronize()
    assert launched(before) == only(sp_select=1)
    assert kernels.SP_SELECT.path == kernels._select_path(B, C, A)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g.view(torch.uint8), w.view(torch.uint8))
    assert torch.equal(duty, kept)


@pytest.mark.cuda
@pytest.mark.parametrize("bad", ["dtype", "shape", "k", "align"])
def test_sp_select_rejects_bad_inputs(bad, cuda):
    """The `sp_select` wrapper raises on int64 overlaps, duty cycles of
    another shape, more winners than columns and a misaligned tensor,
    and launches nothing."""
    ov, duty = testing.select_inputs(1, 2, 64, device=cuda)
    k = 5
    if bad == "dtype":
        ov = ov.long()
    elif bad == "shape":
        duty = duty[:, :32].contiguous()
    elif bad == "k":
        k = 65
    else:
        flat = torch.empty(ov.numel() + 1, dtype=torch.int32, device=cuda)
        ov = flat[1:].view(ov.shape)
    before = kernels.launch_counts()
    with pytest.raises((TypeError, ValueError)):
        kernels.sp_select_cuda(ov, duty, k, *preg.select_scalars(
            0.3, 5 / 64, 0.99))
    assert launched(before) == only()


# ---- the compact serving table's counts and words (csrc/
# serving_count_pass.cu serving_counts): B, C, D, A, G, M, E and
# `testing.serving_inputs` keywords; the bench and 16K tables' shapes, D =
# 8, 33, 64, G = 1, 8, 32, M = 2, 3, no extension rows, extension rows in
# column order and out of it, empty lanes and an empty stream, 1,024
# threads a block (the 128 KB bitmap), the global bitmap and 65,537
# streams

SERVING_SHAPES = {
    "bench": (16, 2048, 32, 41, 4, 1, 8, {}),
    "16k": (4, 16384, 64, 328, 4, 1, 8, {}),
    "D8": (8, 512, 8, 16, 8, 1, 8, {}),
    "D33 M2": (4, 250, 33, 9, 4, 2, 16, {}),
    "G1": (4, 300, 32, 9, 1, 1, 8, {}),
    "G32 M3": (3, 100, 32, 5, 32, 3, 8, {}),
    "E0": (4, 256, 32, 9, 4, 1, 0, {}),
    "ordered": (4, 256, 32, 9, 4, 1, 40, {"ordered": True}),
    "empty": (3, 256, 32, 9, 4, 1, 8, {"empty": 0.95,
                                       "empty_stream": True}),
    "global bitmap": (2, 32_768, 64, 300, 4, 1, 8, {}),
    "B=65537": (65_537, 4, 32, 2, 4, 1, 8, {}),
}


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["flags", "counts"])
@pytest.mark.parametrize("case", list(SERVING_SHAPES))
def test_serving_counts_match_plain(case, form, cuda):
    """`serving_counts` on the card (one launch of its kernel, on the path
    its shapes choose) == the plain versions on the card, bit for bit:
    the counts, or the matching and prediction words at theta_m one below
    theta_a and at theta_m = theta_a."""
    B, C, D, A, G, M, E, kw = SERVING_SHAPES[case]
    x = testing.serving_inputs(B + C + G + M + E, B, C, D, A, G, M, E,
                               device=cuda, **kw)
    tab = psv.ServingTable(x["rows"], x["ext_col"])
    args = (x["cols"], x["bits"])
    want = psv.serving_counts_ref(tab, *args, C, D, G)
    path = (kernels._bitmap(C, D), form, kernels._segment_regs(G))
    if form == "counts":
        before = kernels.launch_counts()
        got = psv.serving_counts(tab, *args, C, D, G)
        torch.cuda.synchronize()
        assert launched(before) == only(serving_counts=1)
        assert kernels.SERVING_COUNTS.path == path
        assert torch.equal(got, want)
        assert bool((want > 0).any())
        return
    theta_a = max(1, int(want[want > 0].float().median()))
    for theta_m in (theta_a - 1, theta_a):
        th = (theta_m, theta_a)
        ref = psv.serving_flags_ref(tab, *args, x["seg_cell"], C, D, *th)
        before = kernels.launch_counts()
        got = psv.serving_flags(tab, *args, x["seg_cell"], C, D, *th)
        torch.cuda.synchronize()
        assert launched(before) == only(serving_counts=1)
        assert kernels.SERVING_COUNTS.path == path
        assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
        assert bool((ref[0] != 0).any()) and bool((ref[1] != 0).any())


@pytest.mark.cuda
@pytest.mark.parametrize("bad", ["dtype", "ext_col", "seg_cell", "align",
                                 "rows"])
def test_serving_counts_rejects_bad_inputs(bad, cuda):
    """The `serving_counts` wrappers raise on int64 words, an ext_col of
    another stream count, owners of another shape, misaligned rows and a
    table whose rows do not fit C columns, and launch nothing."""
    x = testing.serving_inputs(1, 2, 64, 32, 5, 4, 1, 8, device=cuda)
    C = 64
    if bad == "dtype":
        x["rows"] = x["rows"].long()
    elif bad == "ext_col":
        x["ext_col"] = x["ext_col"][:1]
    elif bad == "seg_cell":
        x["seg_cell"] = x["seg_cell"][:, :32].contiguous()
    elif bad == "align":
        flat = torch.empty(x["rows"].numel() + 1, dtype=torch.int32,
                           device=cuda)
        x["rows"] = flat[1:].view(x["rows"].shape)
    else:
        C = 63
    before = kernels.launch_counts()
    with pytest.raises((TypeError, ValueError)):
        kernels.serving_flags_cuda(x["rows"], x["ext_col"], x["cols"],
                                   x["bits"], x["seg_cell"], C, 32, 2, 3)
    assert launched(before) == only()


# ---- the anomaly stages (csrc/anomaly_pass.cu) against their plain
# versions on the card, at the cases of chip_smoke.check_anomaly_stages
# (`testing.LIKELIHOOD_CASES`, `testing.ZSCORE_CASES`): the states bit
# for bit, L within 2.4e-7 and z within 2e-6 + 1e-6|z| (the sums' order,
# erff; tests/test_torch_encoders.py models the kernels' sums against
# JAX)


def _same_state(got, want) -> bool:
    return all(a.dtype == b.dtype and torch.equal(a, b)
               for a, b in zip(got, want, strict=True))


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(testing.LIKELIHOOD_CASES))
def test_anomaly_likelihood_kernel_matches_plain(case, cuda):
    from bithtm_tpu_torch import encoders as enc

    T, B, W, R, carried = testing.LIKELIHOOD_CASES[case]
    st, x = testing.likelihood_inputs(7, T, B, W, R, carried, cuda)
    state = None if st is None else bt.AnomalyLikelihoodState(*st)
    kept = None if st is None else [t.clone() for t in st]
    start = state or bt.anomaly_likelihood_init(W, B, cuda)
    want_st, want = enc.anomaly_likelihood_steps_ref(start, x, 0.7, R)
    before = kernels.launch_counts()
    got_st, got = enc.anomaly_likelihood_steps(state, x, 0.7, R, window=W)
    torch.cuda.synchronize()
    assert launched(before) == only(anomaly_likelihood=1)
    assert kernels.ANOMALY_LIKELIHOOD.path == (kernels._ring(W), "f32")
    assert _same_state(got_st, want_st)
    assert float((got - want).abs().max()) <= 2.4e-7
    assert bool((want != 0.5).any())
    if kept is not None:  # the state passed in is not changed
        assert _same_state(st, kept)


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(testing.ZSCORE_CASES))
def test_seasonal_zscore_kernel_matches_plain(case, cuda):
    from bithtm_tpu_torch import encoders as enc

    T, B, P, W, lags, carried, f64 = testing.ZSCORE_CASES[case]
    st, x = testing.zscore_inputs(8, T, B, P, W, lags, carried, f64, cuda)
    state = None if st is None else bt.SeasonalZScoreState(*st)
    kept = None if st is None else [t.clone() for t in st]
    start = state or bt.seasonal_zscore_init(P, W, lags, B, cuda)
    want_st, want = enc.seasonal_zscore_steps_ref(start, x, P)
    before = kernels.launch_counts()
    got_st, got = enc.seasonal_zscore_steps(state, x, P, window=W,
                                            lags=lags)
    torch.cuda.synchronize()
    assert launched(before) == only(seasonal_zscore=1)
    assert kernels.SEASONAL_ZSCORE.path == (
        kernels._ring(lags * P + W), "f64" if f64 else "f32")
    assert _same_state(got_st, want_st)
    assert bool(((got - want).abs() <= 2e-6 + 1e-6 * want.abs()).all())
    if kept is not None:
        assert _same_state(st, kept)


@pytest.mark.cuda
def test_streaming_anomaly_updates_launch_one_kernel(cuda):
    """`anomaly_likelihood_update` and `seasonal_zscore_update` on the card
    are one launch each (T = 1), for a (B,) tensor and a Python scalar,
    and a loop of them equals the series call bit for bit."""
    from bithtm_tpu_torch.examples import likelihood_series

    st, x = testing.likelihood_inputs(9, 60, 8, 40, 10, False, cuda)
    state, liks = bt.anomaly_likelihood_init(40, 8, cuda), []
    for s in x:
        before = kernels.launch_counts()
        state, lik = bt.anomaly_likelihood_update(state, s, 0.7, 10)
        assert launched(before) == only(anomaly_likelihood=1)
        liks.append(lik)
    assert torch.equal(torch.stack(liks), likelihood_series(x, 40, 0.7, 10))
    before = kernels.launch_counts()
    bt.anomaly_likelihood_update(state, 0.25, 0.7, 10)
    assert launched(before) == only(anomaly_likelihood=1)
    _, v = testing.zscore_inputs(9, 80, 8, 6, 20, 3, False, False, cuda)
    zst, zs = bt.seasonal_zscore_init(6, 20, 3, 8, cuda), []
    for row in v:
        before = kernels.launch_counts()
        zst, z = bt.seasonal_zscore_update(zst, row, 6)
        assert launched(before) == only(seasonal_zscore=1)
        zs.append(z)
    assert torch.equal(torch.stack(zs), bt.seasonal_zscore(v, 6, window=20))
    before = kernels.launch_counts()
    bt.seasonal_zscore_update(zst, 0.5, 6)
    assert launched(before) == only(seasonal_zscore=1)
