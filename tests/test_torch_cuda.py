"""The CUDA kernels of the PyTorch port against their plain versions, on
the card. No JAX here, so the file runs where the GPU is:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

(`--noconftest`: tests/conftest.py imports jax.) Every test skips where
`torch.cuda.is_available()` is false.
"""

import pytest
import torch

from bithtm_tpu_torch.ops import active_set as pas
from bithtm_tpu_torch.ops import kernels
from bithtm_tpu_torch.testing import table_inputs

SHAPES = [  # B, C, G, K, D, A
    (2, 64, 4, 64, 32, 5),    # the bench's G, K, D
    (3, 40, 8, 48, 4, 6),     # the reference stack's G, K; D=4
    (2, 30, 3, 7, 33, 4),     # two bitmask words; J % 4 != 0
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
        "table_update": 1, "act_conn": 1}


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
