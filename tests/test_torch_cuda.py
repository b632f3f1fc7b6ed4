"""The CUDA kernels of the PyTorch port against their plain versions, on
the card. No JAX here, so the file runs where the GPU is:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

(`--noconftest`: tests/conftest.py imports jax.) Every test skips where
`torch.cuda.is_available()` is false.
"""

import types

import pytest
import torch

from bithtm_tpu_torch.ops import active_set as pas
from bithtm_tpu_torch.ops import kernels
from bithtm_tpu_torch.ops import serving as psv
from bithtm_tpu_torch.testing import serving_rows, table_inputs

SHAPES = [  # B, C, G, K, D, A
    (2, 64, 4, 64, 32, 5),    # the bench's G, K, D
    (3, 40, 8, 48, 4, 6),     # the reference stack's G, K; D=4
    (2, 30, 3, 7, 33, 4),     # two bitmask words; J % 4 != 0, C*J % 4 != 0
    (1, 16, 2, 16, 70, 3),    # three words
    (1, 8192, 1, 8, 64, 9),   # a 64 KB bitmap: shared memory opt-in
]


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
    v_ref = pas.table_update_ref(x["syn"], p_ref, x["act_prev"],
                                 x["pun_word"], x["cols"], x["bits"], D, K,
                                 0.01, 0.5)
    v_k = kernels.table_update_cuda(x["syn"], p_k, x["act_prev"],
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
    after = kernels.launch_counts()
    assert {k: after[k] - before[k] for k in after} == {
        "table_update": 1, "act_conn": 1, "serving_activation": 0,
        "act_frozen": 0}


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
@pytest.mark.parametrize("shape", SHAPES)
def test_serving_kernels_match_plain(shape, cuda):
    """`act_frozen` and `serving_activation` against their plain versions
    (the serving table with 8 extension rows below its C main rows), one
    launch each; the frozen words also give `act_conn`'s activity."""
    B, C, G, K, D, A = shape
    x = table_inputs(sum(shape) + 1, *shape, device=cuda)
    cols, bits = x["cols"], x["bits"]
    word = pas.pack_frozen_table(x["syn"], x["perm"], 0.5)
    rows = serving_rows(sum(shape) + 2, B, C + 8, C, D, G, device=cuda)
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
    after = kernels.launch_counts()
    assert {k: after[k] - before[k] for k in after} == {
        "table_update": 0, "act_conn": 0, "serving_activation": 1,
        "act_frozen": 1}


@pytest.mark.cuda
@pytest.mark.parametrize("spill", [False, True])
def test_serving_dispatch_launches_the_kernels(spill, cuda):
    """On CUDA tensors `serving_counts` and `synapse_activation_frozen`
    go through the kernels, and agree with the same calls on the CPU
    (the plain versions); with ``spill`` three dense columns fill
    extension rows, without it the table has none."""
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
    assert after["serving_activation"] == before["serving_activation"] + 1
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
        C = 1 << 20  # a 4 MB active-cell bitmap
    with pytest.raises((TypeError, ValueError)):
        if kernel == "act_frozen":
            kernels.act_frozen_cuda(t, cols, bits, D, K)
        else:
            kernels.serving_activation_cuda(t, cols, bits, C, D)
