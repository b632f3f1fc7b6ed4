"""The full-table pass of the PyTorch port on the CPU: plain versions
against the JAX package, and the dispatch rules.

`table_update_ref` and `synapse_activation_conn_ref` are checked against
JAX `table_update_xla` / `synapse_activation_conn` (its XLA path on the
CPU) and against the Pallas kernel `table_update_tpu` run in interpret
mode on the salted-hash matcher shape of tests/test_pallas.py. The CUDA
kernels run only on the card: tests/test_torch_cuda.py and
`python3 chip_smoke.py` compare them with these plain versions.
"""

import ctypes
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bithtm_tpu.ops import active_set as jas
from bithtm_tpu.ops.pallas_kernels import table_update_tpu

import bithtm_tpu_torch as bt
from bithtm_tpu_torch.models import spatial_pooler as psp
from bithtm_tpu_torch.ops import active_set as pas
from bithtm_tpu_torch.ops import kernels
from bithtm_tpu_torch.ops import overlap as pov
from bithtm_tpu_torch.testing import table_inputs

SHAPES = [  # B, C, G, K, D, A
    (2, 64, 4, 64, 32, 5),
    (3, 40, 8, 48, 4, 6),
    (2, 30, 3, 7, 33, 4),
    (1, 16, 2, 16, 70, 3),
]


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_table_pass_matches_jax(shape):
    """`table_update` (plain version + the flags form) holds JAX
    `table_update_xla`'s seven outputs: the permanences, the activity and
    the prediction words as they are, the potential and connected counts
    as `seg_counts_packed` of the activity, the matching and active flags
    through the matching word; and `synapse_activation_conn` equals JAX
    `synapse_activation_conn` (vmapped over the streams)."""
    B, C, G, K, D, A = shape
    x = table_inputs(sum(shape), *shape)
    n = {k: v.numpy() for k, v in x.items()}
    args = (0.01, 0.5, 3, 2)  # punishment, threshold, theta_m, theta_a
    perm, act_prev = x["perm"].clone(), x["act_prev"].clone()
    got = pas.table_update(x["syn"], perm, act_prev, x["pun_word"],
                           x["cols"], x["bits"], x["seg_cell"], D, *args)
    assert got[0] is perm  # punished in place
    assert got[1] is act_prev  # the activity written over the previous
    conn = pas.synapse_activation_conn(x["syn"], x["perm"], x["cols"],
                                       x["bits"], D, 0.5, K)
    bits = jnp.asarray(n["bits"].view(np.uint32))
    want = jax.jit(jax.vmap(
        lambda s, p, a, w, c, bb, sc: jas.table_update_xla(
            s, p, a, w, c, bb, sc, D, *args)))(
        n["syn"], n["perm"], n["act_prev"], n["pun_word"], n["cols"], bits,
        n["seg_cell"])
    perm_, act, word, pred = got
    pot, con = pas.seg_counts_packed(act, G, K)
    matching = torch.from_numpy(pas.matching_dense_host(word, G))
    got = (perm_, act, pot, con, matching, matching & (con >= args[3]),
           pred)
    for i, (g, w) in enumerate(zip(got, want)):
        w = np.asarray(w)
        w = w.view(np.int32) if w.dtype == np.uint32 else w
        np.testing.assert_array_equal(g.numpy(), w.astype(g.numpy().dtype),
                                      err_msg=f"output {i}")
    want_conn = jax.jit(jax.vmap(
        lambda s, p, c, bb: jas.synapse_activation_conn(
            s, p, c, bb, D, 0.5, K)))(n["syn"], n["perm"], n["cols"], bits)
    np.testing.assert_array_equal(conn.numpy(), np.asarray(want_conn))


def test_plain_table_update_matches_pallas_interpret():
    """Against the TPU kernel itself (interpret mode) on the hash-matcher
    shape of tests/test_pallas.py (C=512, G=4, K=64, A=41, D=32)."""
    B, C, G, K, D, A = 1, 512, 4, 64, 32, 41
    x = table_inputs(7, B, C, G, K, D, A, threshold=0.05)
    n = {k: v[0].numpy() for k, v in x.items()}
    perm = x["perm"].clone()
    v = pas.table_update_ref(x["syn"], perm, x["act_prev"].clone(),
                             x["pun_word"], x["cols"], x["bits"], D, K, 0.03,
                             0.05)
    want_perm, want_v = table_update_tpu(
        jnp.asarray(n["syn"]), jnp.asarray(n["perm"]),
        jnp.asarray(n["act_prev"]), jnp.asarray(n["pun_word"]),
        jnp.asarray(n["cols"]), jnp.asarray(n["bits"].view(np.uint32)),
        D, K, 0.03, 0.05, block=128, interpret=True)
    np.testing.assert_array_equal(perm[0].numpy(), np.asarray(want_perm))
    np.testing.assert_array_equal(v[0].numpy(), np.asarray(want_v))
    assert (v != 0).any() and (perm != x["perm"]).any()


@pytest.mark.parametrize("fn", ["table_update", "synapse_activation_conn",
                                "overlaps", "seg_counts_packed"])
def test_dispatch_raises_off_cpu_and_cuda(fn):
    """A tensor that is neither on the CPU nor on CUDA (a `meta` tensor
    here) raises; nothing falls back to the plain version."""
    B, C, G, K, D, A = SHAPES[0]
    meta = {k: v.to("meta") for k, v in table_inputs(0, *SHAPES[0]).items()}
    with pytest.raises(RuntimeError, match="not supported"):
        if fn == "table_update":
            pas.table_update(meta["syn"], meta["perm"], meta["act_prev"],
                             meta["pun_word"], meta["cols"], meta["bits"],
                             meta["seg_cell"], D, 0.01, 0.5, 3, 2)
        elif fn == "synapse_activation_conn":
            pas.synapse_activation_conn(meta["syn"], meta["perm"],
                                        meta["cols"], meta["bits"], D, 0.5,
                                        K)
        elif fn == "overlaps":
            pov.overlaps(torch.zeros((B, C, 128), dtype=torch.uint8,
                                     device="meta"),
                         torch.zeros((B, 1000), dtype=torch.bool,
                                     device="meta"))
        else:
            pas.seg_counts_packed(meta["act_prev"], G, K)


def test_cuda_wrappers_reject_cpu_tensors():
    """The kernel wrappers check their inputs before building or
    launching anything."""
    x = table_inputs(0, *SHAPES[0])
    before = kernels.launch_counts()
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.table_update_cuda(x["syn"], x["perm"], x["act_prev"],
                                  x["pun_word"], x["cols"], x["bits"], 32,
                                  64, 0.01, 0.5)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.act_conn_cuda(x["syn"], x["perm"], x["cols"], x["bits"], 32,
                              0.5, 64)
    assert kernels.launch_counts() == before


@pytest.mark.parametrize("wrapper", [
    "serving_activation", "act_frozen", "synapse_activation",
    "small_table_take", "sp_update_pack", "sp_rows", "sp_overlap",
    "seg_counts"])
def test_every_wrapper_rejects_cpu_tensors(wrapper):
    """The other eight wrappers, too, raise on CPU tensors before they
    build or launch anything."""
    B, C, G, K, D, A = SHAPES[0]
    x = table_inputs(1, *SHAPES[0])
    calls = {
        "serving_activation": lambda: kernels.serving_activation_cuda(
            torch.zeros((B, C, 128), dtype=torch.int32), x["cols"],
            x["bits"], C, D),
        "act_frozen": lambda: kernels.act_frozen_cuda(
            x["syn"], x["cols"], x["bits"], D, K),
        "synapse_activation": lambda: kernels.synapse_activation_cuda(
            x["syn"], x["cols"], x["bits"], C, D),
        "small_table_take": lambda: kernels.small_table_take_cuda(
            torch.zeros((B, 64), dtype=torch.int32),
            torch.zeros((B, 8, 4), dtype=torch.int32)),
        "sp_update_pack": lambda: kernels.sp_update_pack_cuda(
            torch.zeros((B, 8, 1024), dtype=torch.int16),
            torch.zeros((B, 1024), dtype=torch.int32), x["cols"], 0),
        "sp_rows": lambda: kernels.sp_rows_cuda(
            torch.zeros((B, 8, 1024), dtype=torch.int16),
            torch.zeros((B, 8, 128), dtype=torch.uint8),
            torch.zeros((B, 1000), dtype=torch.bool), x["cols"], 6, -3, 0),
        "sp_overlap": lambda: kernels.sp_overlap_cuda(
            torch.zeros((B, C, 128), dtype=torch.uint8),
            torch.zeros((B, 1000), dtype=torch.bool)),
        "seg_counts": lambda: kernels.seg_counts_cuda(x["act_prev"], G, K),
    }
    before = kernels.launch_counts()
    with pytest.raises(ValueError, match="CUDA tensor"):
        calls[wrapper]()
    assert kernels.launch_counts() == before


def test_entry_points_take_device_and_stream():
    """Every kernel's C entry point ends with (int device, void* stream)
    and takes as many arguments as its ctypes argument types list; the
    library's hash covers every header of `csrc/`."""
    every = "".join((kernels.CSRC / name).read_text()
                    for name in kernels.SOURCES)
    for name, argtypes in kernels._ARGTYPES.items():
        params = re.search(rf'extern "C" int {name}\(([^)]*)\)',
                           every).group(1)
        assert re.search(r"int device,\s*void\* stream$", params.strip()), \
            name
        assert len(argtypes) == params.count(",") + 1, name
        assert argtypes[-2:] == [ctypes.c_int, ctypes.c_void_p], name
    assert set(kernels.HEADERS) == {
        p.name for p in kernels.CSRC.glob("*.cuh")}


def test_table_entry_points_take_column_dim():
    """`table_update` and `act_conn` take the bitmap's column count right
    after the table's rows (a column shard's rows differ from it), and
    their ctypes argument types carry one more int than the kernels of
    a whole table did. Their pointers end with the bitmap scratch and the
    output."""
    src = (kernels.CSRC / "table_pass.cu").read_text()
    for name, n_ptr in (("table_update", 8), ("act_conn", 6)):
        params = re.search(rf'extern "C" int {name}\(([^)]*)\)',
                           src).group(1)
        names = [p.split()[-1].lstrip("*") for p in params.split(",")]
        assert names[n_ptr:n_ptr + 3] == ["B", "C", "column_dim"], names
        assert kernels._ARGTYPES[name][n_ptr:n_ptr + 8] == [ctypes.c_int] * 8


@pytest.mark.parametrize("name", ["table_pass_grid", "word_pass_grid",
                                  "serving_counts_grid"])
def test_grid_queries_match_their_signatures(name):
    """Each row-range grid query is named in the sources with the C
    parameter types its ctypes argument types give, and stays out of
    the launched kernels' table."""
    every = "".join((kernels.CSRC / n).read_text() for n in kernels.SOURCES)
    params = re.search(rf'extern "C" int {name}\(([^)]*)\)', every).group(1)
    ctype = {"int": ctypes.c_int, "int*": ctypes.POINTER(ctypes.c_int)}
    got = [ctype[p.strip().rsplit(None, 1)[0].replace(" ", "")]
           for p in params.split(",")]
    assert got == kernels._GRID_ARGTYPES[name]
    assert name not in kernels._ARGTYPES


def test_cuda_source_names_both_entry_points():
    """Every bound kernel has its C entry point in one of the sources,
    and each source names the TPU kernels it replaces."""
    src = {name: (kernels.CSRC / name).read_text()
           for name in kernels.SOURCES}
    every = "".join(src.values())
    for name in kernels._ARGTYPES:
        assert re.search(rf'extern "C" int {name}\(', every), name
    assert set(kernels._ARGTYPES) == {k.name for k in kernels.KERNELS}
    for name, lines in (("table_pass.cu", (489, 698)),
                        ("serving_pass.cu", (835, 772, 661)),
                        ("small_take.cu", (885,)),
                        ("sp_pass.cu", (598,))):
        for line in lines:
            assert f"pallas_kernels.py:{line}" in src[name], (name, line)
    # the two kernels with no Pallas counterpart name the JAX function
    # that XLA fuses into one pass
    assert "bithtm_tpu/ops/overlap.py:85" in src["overlap_pass.cu"]
    assert "bithtm_tpu/ops/active_set.py:588" in src["count_pass.cu"]
    # serving_counts: the JAX serving_counts, whose activation is the
    # Pallas serving kernel
    assert "bithtm_tpu/ops/serving.py\n// :205" in src[
        "serving_count_pass.cu"]
    assert "pallas_kernels.py:835" in src["serving_count_pass.cu"]
    # sp_rows: the JAX step's sparse-row update, which has none either
    assert "bithtm_tpu/models/spatial_pooler.py:81" in src["sp_pass.cu"]
    for name in kernels.SOURCES:
        assert ('#include "active_bitmap.cuh"' in src[name]) == (
            name in ("table_pass.cu", "serving_pass.cu", "sp_pass.cu",
                     "serving_count_pass.cu"))
    assert Path(kernels.library_path()).parent == kernels.BUILD_DIR


# ---- the paths the wrappers choose from shapes (README.md, port
# section) and the one limit left -------------------------------------


def _view(*shape, dtype=torch.int32):
    """A CPU tensor of ``shape`` that holds one element: the wrappers
    must choose their path from its shape before they read it."""
    return torch.zeros((1,) * len(shape), dtype=dtype).expand(*shape)


def _active(B, A=3, W=1):
    return _view(B, A), _view(B, A, W)


def _act_conn_k(K, C=4, D=32):
    """`act_conn` over (1, C, K) rows of one segment of K slots."""
    return lambda: kernels.act_conn_cuda(
        _view(1, C, K), _view(1, C, K, dtype=torch.float32),
        *_active(1, W=(D + 31) // 32), D, 0.5, K)


# name: (call, the kernel whose path it reports, that path); a path of
# None is the one limit left, which still raises
PATH_CALLS = {
    # C*D = 58,113 * 32 cells, one column past the bitmap's 1,859,584
    "bitmap, table pass": (lambda: kernels.act_conn_cuda(
        _view(1, 58_113, 64), _view(1, 58_113, 64, dtype=torch.float32),
        *_active(1), 32, 0.5, 64), "act_conn", ("global", "u8")),
    "bitmap, serving rows": (lambda: kernels.serving_activation_cuda(
        _view(1, 4, 128), *_active(1, W=2), 32_768, 64),
        "serving_activation", ("global",)),
    "bitmap, synapse_activation": (lambda: kernels.synapse_activation_cuda(
        _view(1, 4, 8), *_active(1, W=2), 32_768, 64),
        "synapse_activation", ("global",)),
    "streams, act_frozen": (lambda: kernels.act_frozen_cuda(
        _view(65_536, 2, 64), *_active(65_536), 32, 64), "act_frozen",
        ("smem", "u8", "grid_x_streams")),
    "streams, sp_update_pack": (lambda: kernels.sp_update_pack_cuda(
        _view(65_536, 2, 1024, dtype=torch.int16), _view(65_536, 1024),
        _view(65_536, 3), 0), "sp_update_pack",
        ("smem_delta", "grid_x_streams")),
    "streams, sp_rows": (lambda: kernels.sp_rows_cuda(
        _view(65_536, 2, 1024, dtype=torch.int16),
        _view(65_536, 2, 128, dtype=torch.uint8),
        _view(65_536, 1000, dtype=torch.bool), _view(65_536, 3), 6, -3, 0),
        "sp_rows", ("grid_x_streams", "bitmap")),
    "streams below, sp_rows": (lambda: kernels.sp_rows_cuda(
        _view(65_535, 2, 2048, dtype=torch.float32),
        _view(65_535, 2, 256, dtype=torch.uint8),
        _view(65_535, 1500, dtype=torch.bool), _view(65_535, 3), 0.03,
        -0.015, 0.0), "sp_rows", ("grid_y", "bitmap")),
    # past 65,536 columns: no first-claim bitmaps
    "claims, sp_rows": (lambda: kernels.sp_rows_cuda(
        _view(1, 65_537, 1024, dtype=torch.int16),
        _view(1, 65_537, 128, dtype=torch.uint8),
        _view(1, 1000, dtype=torch.bool), _view(1, 3), 6, -3, 0),
        "sp_rows", ("grid_y", "scan")),
    # a warp a stream; the LSD sort's lists past 160 KiB; the keys read
    # again past 16,384 columns
    "warp, sp_select": (lambda: kernels.sp_select_cuda(
        _view(65_536, 64), _view(65_536, 64, dtype=torch.float32), 5,
        -15.0, 0.99, 0.01), "sp_select", ("warp", "smem", "rank")),
    "lists, sp_select": (lambda: kernels.sp_select_cuda(
        _view(2, 30_000), _view(2, 30_000, dtype=torch.float32), 12_000,
        -15.0, 0.99, 0.01), "sp_select", ("global", "global", "cluster_lsd")),
    "keys, sp_select": (lambda: kernels.sp_select_cuda(
        _view(2, 16_385), _view(2, 16_385, dtype=torch.float32), 5,
        -15.0, 0.99, 0.01), "sp_select", ("global", "smem", "rank")),
    "shared memory, sp_update_pack": (lambda: kernels.sp_update_pack_cuda(
        _view(1, 1_827_000, 1024, dtype=torch.int16), _view(1, 1024),
        _view(1, 3), 0), "sp_update_pack", ("gmem_delta", "grid_y")),
    "stream words": (lambda: kernels.small_table_take_cuda(
        _view(1, 384), _view(1, 1 << 15, (1 << 15) + 1)),
        "small_table_take", None),
    # a column shard of 4 rows over 58,113 columns: the bitmap spans the
    # global cell space, not the table's rows
    "bitmap, column shard": (lambda: kernels.table_update_cuda(
        _view(1, 4, 64), _view(1, 4, 64, dtype=torch.float32),
        _view(1, 4, 64, dtype=torch.uint8), _view(1, 4), *_active(1), 32,
        64, 0.01, 0.5, column_dim=58_113), "table_update", ("global", "u8")),
    "packed K": (_act_conn_k(126), "act_conn", ("smem", "bf16")),
    # the activity's type on both sides of each act_dtype line
    "K125": (_act_conn_k(125), "act_conn", ("smem", "u8")),
    "K126": (_act_conn_k(126), "act_conn", ("smem", "bf16")),
    "K127": (_act_conn_k(127), "act_conn", ("smem", "bf16")),
    "K128": (_act_conn_k(128), "act_conn", ("smem", "f32")),
    # exactly MAX_BITMAP_CELLS = 58,112 * 32 cells, and one cell past it
    "bitmap at the limit": (_act_conn_k(64, C=58_112, D=32), "act_conn",
                            ("smem", "u8")),
    "bitmap one cell past": (_act_conn_k(64, C=371_917, D=5), "act_conn",
                             ("global", "u8")),
    # the SP overlap folds 65,536 streams into grid x
    "streams, sp_overlap": (lambda: kernels.sp_overlap_cuda(
        _view(65_536, 2, 128, dtype=torch.uint8),
        _view(65_536, 1000, dtype=torch.bool)), "sp_overlap",
        ("grid_x_streams",)),
    "streams below, sp_overlap": (lambda: kernels.sp_overlap_cuda(
        _view(65_535, 2, 128, dtype=torch.uint8),
        _view(65_535, 1000, dtype=torch.bool)), "sp_overlap", ("grid_y",)),
    # the compact serving pass: the bitmap, the form and the tally's
    # registers from the shapes (G on both sides of each line), rows C*M
    # + E of any M
    "bitmap, serving counts": (lambda: kernels.serving_counts_cuda(
        _view(1, 4 * 32_768 + 8, 128), _view(1, 8), *_active(1, W=2),
        32_768, 64, 4), "serving_counts", ("global", "counts", "g4")),
    **{f"serving flags G{G}": (
        lambda G=G: kernels.serving_flags_cuda(
            _view(2, 3 * 64, 128), _view(2, 0), *_active(2),
            _view(2, 64, G), 64, 32, 2, 3),
        "serving_counts", ("smem", "flags", name))
       for G, name in ((1, "g4"), (4, "g4"), (5, "g8"), (8, "g8"),
                       (9, "g16"), (16, "g16"), (17, "g32"), (32, "g32"))},
    "serving words": (lambda: kernels.serving_counts_cuda(
        _view(1, (1 << 23) + 1, 128), _view(1, 1), *_active(1), 1 << 23, 4,
        4), "serving_counts", None),
    # the anomaly stages take a step with a thread up to a window of
    # ANOMALY_LANE_WINDOW (4,096) slots, with a warp past it (the rings
    # of 58,112 floats and more that once left shared memory among them),
    # whatever the lag ring; the series is read as float32 or float64
    **{f"{tag} {W}, anomaly_likelihood": (
        lambda W=W: kernels.anomaly_likelihood_cuda(
            None, _view(3, 2, dtype=torch.float32), W, 0.7, 24),
        "anomaly_likelihood", (steps, "f32"))
       for tag, W, steps in (("window", 4096, "lane"),
                             ("window", 4097, "warp"),
                             ("ring", 58_112, "warp"),
                             ("ring", 58_113, "warp"))},
    **{f"{tag} {24 * 3 + W}, seasonal_zscore": (
        lambda W=W: kernels.seasonal_zscore_cuda(
            None, _view(3, 2, dtype=torch.float64), 24, 72, W, 1e-6),
        "seasonal_zscore", (steps, "f64"))
       for tag, W, steps in (("window", 4096, "lane"),
                             ("window", 4097, "warp"),
                             ("ring", 58_040, "warp"),
                             ("ring", 58_041, "warp"))},
    # the count decode reads the activity in its type on both sides of
    # each act_dtype line
    **{f"counts K{K}": (
        lambda K=K: kernels.seg_counts_cuda(
            _view(1, 4, 2 * K, dtype=pas.act_dtype(K)), 2, K),
        "seg_counts", (name,))
       for K, name in ((125, "u8"), (126, "bf16"), (127, "bf16"),
                       (128, "f32"))},
}


@pytest.mark.parametrize("case", list(PATH_CALLS))
def test_card_limits_choose_a_path_from_shapes(case):
    """Each shape past a limit of the kernels' first design takes a path
    of the same kernel, which the wrapper reports (`CudaKernel.path`)
    from the shapes alone: the tensors here are CPU views of one element,
    which the wrapper then refuses as off the card, so it has read none
    of them before it chose. Only the stream-words limit still raises.
    Nothing launches."""
    call, name, path = PATH_CALLS[case]
    kernel = next(k for k in kernels.KERNELS if k.name == name)
    kernel.path = ()
    before = kernels.launch_counts()
    if path is None:
        with pytest.raises(ValueError, match="stream-words limit"):
            call()
    else:
        with pytest.raises(ValueError, match="must be a CUDA tensor"):
            call()
        assert kernel.path == path
    assert kernels.launch_counts() == before
    assert kernels.MAX_BITMAP_CELLS == 1_859_584


@pytest.mark.parametrize("bad", ["S", "rank", "J", "K"])
def test_overlap_and_count_wrappers_check_shapes(bad):
    """`sp_overlap_cuda` takes rows of `input_words(I)` bytes and
    `seg_counts_cuda` rows of G*K values: other shapes raise before any
    tensor is read or anything launches."""
    calls = {
        "S": lambda: kernels.sp_overlap_cuda(
            _view(2, 3, 256, dtype=torch.uint8),
            _view(2, 1000, dtype=torch.bool)),
        "rank": lambda: kernels.sp_overlap_cuda(
            _view(2, 3, 128, dtype=torch.uint8),
            _view(2, 1, 1000, dtype=torch.bool)),
        "J": lambda: kernels.seg_counts_cuda(
            _view(2, 3, 130, dtype=torch.uint8), 2, 64),
        "K": lambda: kernels.seg_counts_cuda(
            _view(2, 3, 0, dtype=torch.uint8), 2, 0),
    }
    before = kernels.launch_counts()
    with pytest.raises(ValueError, match="S=|must be|segments"):
        calls[bad]()
    assert kernels.launch_counts() == before


def test_step_launches_count_the_overlap_and_the_decode():
    """An HTM step launches its table kernel, one `sp_overlap`, one
    `sp_select` and, after
    every kernel that writes the packed activity, one `seg_counts`, and
    a learning step one `sp_rows`; a packed serving step's one kernel
    after the SP is `serving_counts`, with no `seg_counts`,
    `serving_activation` or `pack_bits` (`testing.step_launches`, which
    the card's checks compare exactly); on CPU tensors the dispatchers
    launch nothing."""
    from bithtm_tpu_torch.testing import step_launches

    got = step_launches(table_update=5, act_conn=2, small_table_take=5)
    assert set(got) == {k.name for k in kernels.KERNELS}
    assert got["sp_overlap"] == got["seg_counts"] == 7
    assert step_launches(serving_counts=4)["seg_counts"] == 0
    assert step_launches(serving_counts=4)["sp_overlap"] == 4
    assert step_launches(serving_counts=4)["serving_activation"] == 0
    assert step_launches(serving_counts=4)["pack_bits"] == 0
    assert step_launches(act_conn=1, sp_steps=0)["sp_overlap"] == 0
    assert got["sp_select"] == got["sp_overlap"] == 7
    assert step_launches(act_conn=1, sp_steps=0)["sp_select"] == 0
    assert got["sp_rows"] == 5
    assert step_launches(act_conn=3)["sp_rows"] == 0
    assert step_launches(table_update=2, sp_rows=0)["sp_rows"] == 0
    before = kernels.launch_counts()
    x = table_inputs(2, *SHAPES[0])
    pas.seg_counts_packed(x["act_prev"], SHAPES[0][2], SHAPES[0][3])
    pov.overlaps(torch.zeros((2, 3, 128), dtype=torch.uint8),
                 torch.ones((2, 1000), dtype=torch.bool))
    sp = bt.make_htm_config(1000, 3, 4, active_columns=2).sp
    psp.sp_rows(sp, torch.zeros((2, 3, 1024)),
                torch.zeros((2, 3, 128), dtype=torch.uint8),
                torch.ones((2, 1000), dtype=torch.bool),
                torch.tensor([[0, 2], [1, 0]], dtype=torch.int32))
    assert kernels.launch_counts() == before


def test_anomaly_stage_wrappers_check_series_and_name_the_jax_functions():
    """`anomaly_pass.cu` names the JAX updates it stands for; the stage
    wrappers take a (T, B) float32 or float64 series of any strides and a
    period within the lag ring, and raise before anything launches
    otherwise."""
    src = (kernels.CSRC / "anomaly_pass.cu").read_text()
    assert "bithtm_tpu/encoders.py:171, :255" in src
    assert '#include "launch.cuh"' in src
    assert f"kLaneWindow = {kernels.ANOMALY_LANE_WINDOW};" in src
    before = kernels.launch_counts()
    with pytest.raises(ValueError, match=r"\(T, B\)"):
        kernels.anomaly_likelihood_cuda(None, _view(3, dtype=torch.float32),
                                        40, 0.7, 10)
    with pytest.raises(TypeError, match="float32 or float64"):
        kernels.seasonal_zscore_cuda(None, _view(3, 2, dtype=torch.int32),
                                     4, 12, 20, 1e-6)
    with pytest.raises(ValueError, match="period"):
        kernels.seasonal_zscore_cuda(None, _view(3, 2, dtype=torch.float32),
                                     13, 12, 20, 1e-6)
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        kernels.seasonal_zscore_cuda(None, _view(3, 2, dtype=torch.float32),
                                     4, 12, 20, 1e-6)
    assert kernels.launch_counts() == before
