"""The compact serving table's counts and the serving step's words
(`serving_counts`, `serving_flags`) on the CPU.

The plain versions of the `serving_counts` kernel (`serving_counts_ref`,
and `serving_flags_ref`, its flags form) are held to the JAX package's
`serving_counts` (XLA on the CPU, and on one stream with the Pallas
`serving_activation_tpu` in interpret mode, the activation it takes on a
TPU), then to JAX's thresholds, `prediction_words` and matching word as
its `tm_step` takes them from the counts: bit for bit, at D = 8, 32, 33
and 64, G = 1, 4, 8 and 32, M = 1, 2 and 3, no extension rows, a
spilling table from `make_serving_table`, empty lanes and an empty
stream, extension rows out of column order, unallocated owners, and
theta_m < theta_a and theta_m = theta_a. A numpy emulation of the
kernel's algorithm (byte-field tallies summed over a warp's row, a warp's
columns taken kCols at once within a block's range, the extension rows
found by a ballot over ext_col) is held to the plain version bit for bit.
The kernel itself runs only on the card: tests/test_torch_cuda.py and
`python3 chip_smoke.py`. Tolerance: none, every value is an integer.
"""

import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bithtm_tpu.ops import active_set as jas
from bithtm_tpu.ops import pallas_kernels as jpk
from bithtm_tpu.ops import serving as jsv

import bithtm_tpu_torch as bt
from bithtm_tpu_torch import testing
from bithtm_tpu_torch.ops import kernels
from bithtm_tpu_torch.ops import serving as psv
from bithtm_tpu_torch.utils.profiling import call_sites

from .test_torch_serving import _spilling_tables

# name: (B, C, D, A, G, M, E, serving_inputs keywords)
CASES = {
    "D8": (2, 48, 8, 6, 4, 1, 8, {}),
    "D32 E0": (2, 64, 32, 5, 4, 1, 0, {}),
    "D33 M2": (2, 40, 33, 4, 8, 2, 8, {}),
    "D64": (2, 32, 64, 3, 4, 1, 16, {}),
    "G1": (2, 64, 32, 5, 1, 1, 8, {}),
    "G8 M3": (2, 32, 32, 4, 8, 3, 8, {"ordered": True}),
    "G32": (2, 24, 32, 4, 32, 2, 8, {}),
    "empty lanes": (3, 32, 16, 4, 4, 1, 8, {"empty": 0.9,
                                            "empty_stream": True}),
}
# theta_m = theta_a, and theta_m below theta_a
THETAS = ("equal", "below")


def _inputs(case: str) -> dict:
    B, C, D, A, G, M, E, kw = CASES[case]
    x = testing.serving_inputs(sum(map(ord, case)), B, C, D, A, G, M, E,
                               **kw)
    return dict(x, C=C, D=D, G=G)


def _table(x):
    return psv.ServingTable(x["rows"], x["ext_col"])


def _thresholds(counts: torch.Tensor, kind: str) -> tuple[int, int]:
    """theta_a at the counts' median (at least 1), so that segments fall
    on both sides, and theta_m equal to it or two below."""
    theta_a = max(1, int(counts.float().median()))
    return (theta_a if kind == "equal" else theta_a - 2), theta_a


@functools.partial(jax.jit, static_argnums=(4, 5, 6))
def _jax_serving_counts(rows, ext_col, cols, bits, C, D, G):
    return jax.vmap(jsv.serving_counts, (0, 0, 0, None, None, None))(
        jsv.ServingTable(rows, ext_col), cols, bits, C, D, G)


def _jax_counts(x) -> np.ndarray:
    """JAX `serving_counts` of every stream, (B, C, G)."""
    return np.asarray(_jax_serving_counts(
        *(jnp.asarray(x[k].numpy()) for k in ("rows", "ext_col", "cols")),
        jnp.asarray(x["bits"].numpy().view(np.uint32)), x["C"], x["D"],
        x["G"]))


@functools.partial(jax.jit, static_argnums=(2,))
def _jax_step_words(counts, seg_cell, D, theta_m, theta_a):
    G = counts.shape[-1]
    word = jnp.sum((counts >= theta_m).astype(jnp.int32)
                   << jnp.arange(G, dtype=jnp.int32), axis=-1,
                   dtype=jnp.int32)
    pred = jax.vmap(jas.prediction_words, (0, 0, None))(
        seg_cell, counts >= theta_a, D)
    return word, pred


def _jax_words(counts: np.ndarray, seg_cell: np.ndarray, D: int,
               theta_m: int, theta_a: int):
    """JAX `tm_step`'s compact branch from the (B, C, G) counts: the
    matching word (its sum of shifted flags) and the prediction words,
    as int32."""
    word, pred = _jax_step_words(jnp.asarray(counts), jnp.asarray(seg_cell),
                                 D, theta_m, theta_a)
    return np.asarray(word), np.asarray(pred).view(np.int32)


@pytest.mark.parametrize("theta", THETAS)
@pytest.mark.parametrize("case", list(CASES))
def test_serving_refs_match_jax(case, theta):
    """`serving_counts_ref` equals JAX `serving_counts` on every stream;
    `serving_flags_ref` equals JAX's thresholds, `prediction_words` and
    matching word of those counts, and the public dispatchers give the
    plain versions' results on the CPU."""
    x = _inputs(case)
    tab = _table(x)
    counts = psv.serving_counts_ref(tab, x["cols"], x["bits"], x["C"],
                                    x["D"], x["G"])
    th = _thresholds(counts, theta)
    word, pred = psv.serving_flags_ref(tab, x["cols"], x["bits"],
                                       x["seg_cell"], x["C"], x["D"], *th)
    assert counts.dtype == word.dtype == pred.dtype == torch.int32
    assert (counts > 0).any() or case == "empty lanes"
    want = _jax_counts(x)
    np.testing.assert_array_equal(counts.numpy(), want)
    w_word, w_pred = _jax_words(want, x["seg_cell"].numpy(), x["D"], *th)
    np.testing.assert_array_equal(word.numpy(), w_word)
    np.testing.assert_array_equal(pred.numpy(), w_pred)
    assert torch.equal(psv.serving_counts(tab, x["cols"], x["bits"], x["C"],
                                          x["D"], x["G"]), counts)
    got = psv.serving_flags(tab, x["cols"], x["bits"], x["seg_cell"],
                            x["C"], x["D"], *th)
    assert torch.equal(got[0], word) and torch.equal(got[1], pred)
    if case == "empty lanes":
        assert not counts[-1].any() and not pred[-1].any()
        assert (word[-1] == 0).all() == (th[0] > 0)


def test_serving_counts_ref_matches_pallas_interpret(monkeypatch):
    """On one stream JAX `serving_counts` as a TPU runs it (its main rows
    through the Pallas `serving_activation_tpu`, here in interpret mode)
    equals `serving_counts_ref`, extension rows out of order included."""
    x = dict(testing.serving_inputs(7, 1, 16, 8, 3, 4, 1, 8), C=16, D=8,
             G=4)
    counts = psv.serving_counts_ref(_table(x), x["cols"], x["bits"], x["C"],
                                    x["D"], x["G"])
    assert (counts > 0).any() and (x["ext_col"] < x["C"]).any()
    pallas = jpk.serving_activation_tpu
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    monkeypatch.setattr(jpk, "serving_activation_tpu",
                        lambda *a, **k: pallas(*a, **k, interpret=True))
    want = jsv.serving_counts(
        jsv.ServingTable(*(jnp.asarray(x[k][0].numpy())
                           for k in ("rows", "ext_col"))),
        jnp.asarray(x["cols"][0].numpy()),
        jnp.asarray(x["bits"][0].numpy().view(np.uint32)), x["C"], x["D"],
        x["G"])
    np.testing.assert_array_equal(counts[0].numpy(), np.asarray(want))


@pytest.mark.parametrize("shuffle", [False, True])
def test_spilling_table_counts_and_words_match_jax(shuffle):
    """A learned-like table from `make_serving_table` (only one stream
    spills into extension rows) and, with ``shuffle``, its extension
    rows permuted with their owners: counts and words equal JAX's."""
    C, D, G, K, A = 256, 16, 4, 64, 9
    syn, perm = _spilling_tables(C, D, G, K, 3)
    cfg = bt.make_htm_config(input_dim=32, column_dim=C, cell_dim=D,
                             active_columns=A, segments_per_column=G,
                             synapse_capacity=K)
    tab = psv.make_serving_table(cfg.tm, types.SimpleNamespace(
        synapse_cell=torch.from_numpy(syn), synapse_perm=torch.from_numpy(
            perm)))
    E = tab.ext_col.shape[1]
    assert E >= 2 and (tab.ext_col[0] < C).sum() >= 2
    rows, ext_col = tab.rows.clone(), tab.ext_col.clone()
    if shuffle:
        order = torch.from_numpy(np.random.default_rng(5).permutation(E))
        rows[:, C:] = rows[:, C + order]
        ext_col = ext_col[:, order]
        assert not bool((ext_col[0].diff() >= 0).all())
    y = testing.serving_inputs(11, 2, C, D, A, G, 1, 0)
    x = dict(rows=rows, ext_col=ext_col, cols=y["cols"], bits=y["bits"],
             seg_cell=y["seg_cell"], C=C, D=D, G=G)
    counts = psv.serving_counts_ref(_table(x), x["cols"], x["bits"], C, D, G)
    th = _thresholds(counts[0][counts[0] > 0], "below")
    word, pred = psv.serving_flags_ref(_table(x), x["cols"], x["bits"],
                                       x["seg_cell"], C, D, *th)
    assert (pred != 0).any() and (word != 0).any()
    want = _jax_counts(x)
    np.testing.assert_array_equal(counts.numpy(), want)
    w_word, w_pred = _jax_words(want, x["seg_cell"].numpy(), D, *th)
    np.testing.assert_array_equal(word.numpy(), w_word)
    np.testing.assert_array_equal(pred.numpy(), w_pred)


# ---- the kernel's algorithm, emulated -----------------------------------

K_COLS = 4  # serving_count_pass.cu kCols


def _regs(G: int) -> int:
    """The tally's registers a row (NR)."""
    return next(n for n in (1, 2, 4, 8) if G <= 4 * n)


def _cols(G: int) -> int:
    """The columns a warp counts at once (`cols_of(NR)`)."""
    NR = _regs(G)
    return K_COLS if NR <= 2 else max(1, K_COLS * 2 // NR)


def _row_count(words: np.ndarray, active: np.ndarray, G: int) -> np.ndarray:
    """One warp's count of a row of 128 words, lane l holding segment l:
    each lane's four words of an active cell tallied in byte fields of
    NR registers (segment g in byte g & 3 of register g >> 2, nowhere for
    a register past NR; a segment past G is not tested), summed over the
    lanes in uint32 as `__reduce_add_sync` does (a byte that overflowed
    would carry into the next), then lane l's byte."""
    NR = _regs(G)
    cell, g = words >> 5, words & 31
    hit = (words >= 0) & active[np.clip(cell, 0, active.size - 1)] \
        & (cell < active.size)
    acc = np.zeros((32, NR), np.uint32)
    for lane, i in np.argwhere(hit.reshape(32, 4)):
        s = g[lane * 4 + i]
        if s >> 2 < NR:
            acc[lane, s >> 2] += np.uint32(1) << np.uint32(8 * (s & 3))
    total = acc.sum(0, dtype=np.uint64).astype(np.uint32)
    lanes = np.arange(32)
    mine = np.where(lanes >> 2 < NR, total[np.minimum(lanes >> 2, NR - 1)], 0)
    return ((mine >> (8 * (lanes & 3))) & 0xFF).astype(np.int64)


def _kernel_emulation(x, theta_m: int, theta_a: int, n_ranges: int, seed):
    """The kernel's columns-to-words pass in numpy: each stream's C
    columns cut into ``n_ranges`` random block ranges [lo, hi), a warp
    taking `_cols(G)` columns from lo at a time, their M main rows, then
    the extension rows whose owner a ballot over ext_col finds in [c0,
    hi) and below c0 + `_cols(G)`. Returns (counts, matching word,
    prediction)."""
    rows, ext_col = x["rows"].numpy(), x["ext_col"].numpy()
    cols, bits = x["cols"].numpy(), x["bits"].numpy().view(np.uint32)
    seg_cell = x["seg_cell"].numpy()
    C, D, G = x["C"], x["D"], x["G"]
    B, R, _ = rows.shape
    E = ext_col.shape[1]
    M, W, kc = (R - E) // C, (D + 31) // 32, _cols(G)
    rng = np.random.default_rng(seed)
    counts = np.zeros((B, C, G), np.int64)
    word = np.zeros((B, C), np.int64)
    pred = np.zeros((B, W, C), np.int64)
    for b in range(B):
        active = np.zeros(C * D, bool)
        d = np.arange(D)
        on = (bits[b][:, d // 32] >> (d % 32).astype(np.uint32)) & 1 != 0
        active[(cols[b][:, None] * D + d)[on]] = True
        cuts = np.sort(rng.choice(np.arange(1, C), n_ranges - 1,
                                  replace=False)) if n_ranges > 1 else []
        for lo, hi in zip([0, *cuts], [*cuts, C]):
            for c0 in range(lo, hi, kc):
                cnt = np.zeros((kc, 32), np.int64)
                for m in range(M):
                    for u in range(kc):
                        if c0 + u < hi:
                            cnt[u] += _row_count(rows[b, (c0 + u) * M + m],
                                                 active, G)
                for e0 in range(0, E, 32):
                    owner = ext_col[b, e0:e0 + 32]
                    at = owner - c0
                    for src in np.flatnonzero((owner < hi) & (at >= 0)
                                              & (at < kc)):
                        cnt[at[src]] += _row_count(
                            rows[b, C * M + e0 + src], active, G)
                for u in range(min(kc, hi - c0)):
                    c, n = c0 + u, cnt[u, :G]
                    counts[b, c] = n
                    word[b, c] = int(np.sum((n >= theta_m).astype(np.int64)
                                            << np.arange(G)))
                    cell = seg_cell[b, c]
                    fire = (n >= theta_a) & (cell >= 0) & (cell < D)
                    for w in range(W):
                        lit = fire & (cell >> 5 == w)
                        pred[b, w, c] = int(np.bitwise_or.reduce(
                            np.where(lit, 1 << (cell & 31), 0)))
    wrap = (lambda v: torch.from_numpy(
        ((v + (1 << 31)) % (1 << 32) - (1 << 31)).astype(np.int32)))
    return wrap(counts), wrap(word), wrap(pred)


@pytest.mark.parametrize("case", ["D33 M2", "G32", "G1", "empty lanes"])
def test_kernel_emulation_matches_plain(case):
    """The kernel's algorithm in numpy (`_kernel_emulation`, block ranges
    that cut the columns off a multiple of a warp's columns) equals the
    plain versions' counts and words bit for bit."""
    x = _inputs(case)
    counts = psv.serving_counts_ref(_table(x), x["cols"], x["bits"], x["C"],
                                    x["D"], x["G"])
    th = _thresholds(counts, "below")
    word, pred = psv.serving_flags_ref(_table(x), x["cols"], x["bits"],
                                       x["seg_cell"], x["C"], x["D"], *th)
    got = _kernel_emulation(x, *th, n_ranges=3, seed=len(case))
    assert torch.equal(got[0], counts)
    assert torch.equal(got[1], word) and torch.equal(got[2], pred)


def test_kernel_emulation_byte_fields_hold_a_full_row():
    """Rows whose 128 words are all active and of one segment (a byte
    field reaches 128, the most a row can give) and columns whose count
    passes 255 over M = 3 rows and two extension rows: the emulation,
    which carries a byte that overflows, still equals the plain
    version."""
    C, D, G, M, E = 8, 32, 8, 3, 2
    x = testing.serving_inputs(4, 1, C, D, 4, G, M, E, empty=0.0)
    cell = int(x["cols"][0, 0]) * D + int(torch.nonzero(
        x["bits"][0, 0] != 0)[0]) * 32
    cell += int(torch.nonzero((x["bits"][0, 0, 0] >> torch.arange(32)) & 1)
                [0])
    rows = x["rows"].clone()
    rows[0, :C * M] = (cell << 5) | 7          # every main word: segment 7
    rows[0, C * M:] = (cell << 5) | 3
    x.update(rows=rows, ext_col=torch.tensor([[2, 2]], dtype=torch.int32),
             C=C, D=D, G=G)
    counts = psv.serving_counts_ref(_table(x), x["cols"], x["bits"], C, D, G)
    assert int(counts[0, 0, 7]) == 128 * M and int(counts[0, 2, 3]) == 256
    got = _kernel_emulation(x, 1, 300, n_ranges=2, seed=0)
    assert torch.equal(got[0], counts)


@pytest.mark.parametrize("G", [3, 6])
def test_kernel_emulation_drops_segments_past_g(G):
    """Words whose segment field is at or past G, which the plain version
    and JAX count nowhere: the kernel's tally, which does not test the
    field, puts them in bytes that only lanes at or past G read, or in
    no register; the emulation still equals the plain version."""
    x = dict(testing.serving_inputs(9, 2, 16, 8, 3, G, 1, 8, hit=0.9),
             C=16, D=8, G=G)
    rows = x["rows"].clone()
    live = rows >= 0
    field = torch.randint(G, 32, rows.shape, generator=torch.Generator()
                          .manual_seed(G), dtype=torch.int32)
    past = live & (torch.rand(rows.shape) < 0.3)
    x["rows"] = torch.where(past, (rows & ~31) | field, rows)
    counts = psv.serving_counts_ref(_table(x), x["cols"], x["bits"], 16, 8,
                                    G)
    th = _thresholds(counts, "below")
    word, pred = psv.serving_flags_ref(_table(x), x["cols"], x["bits"],
                                       x["seg_cell"], 16, 8, *th)
    got = _kernel_emulation(x, *th, n_ranges=2, seed=G)
    assert torch.equal(got[0], counts)
    assert torch.equal(got[1], word) and torch.equal(got[2], pred)


# ---- the step and the dispatch --------------------------------------------


def test_serving_step_calls_serving_flags_under_one_site():
    """A packed serving step runs the compact forward and its words under
    the one site `tm_step.serving_counts`; the site
    `tm_step.prediction_words` is the `distal_forward` branch's alone."""
    cfg = bt.make_htm_config(input_dim=32, column_dim=32, cell_dim=4,
                             active_columns=4, segment_activation_threshold=2,
                             segment_matching_threshold=2,
                             segment_sampling_synapses=4)
    state = bt.htm_init_batch(cfg, 2, torch.Generator().manual_seed(1),
                              "cpu")
    tab = bt.make_serving_table(cfg.tm, state.tm)
    x = torch.zeros((1, 2, 32), dtype=torch.bool)
    with call_sites(), torch.profiler.profile() as prof:
        bt.htm_serve_scan(cfg, state, x, serving_table=tab)
    names = {e.name for e in prof.events()}
    assert "tm_step.serving_counts" in names
    assert "tm_step.prediction_words" not in names


def test_serving_flags_dispatch_and_wrappers_refuse_early():
    """A `meta` tensor (neither CPU nor CUDA) raises in both dispatchers;
    the CUDA wrappers refuse CPU tensors and a table that does not fit C
    columns, G past 32 or G = 0, before anything launches."""
    C, D, G, A = 16, 4, 4, 3
    meta = dict(device="meta", dtype=torch.int32)
    tab = psv.ServingTable(torch.zeros((1, C, 128), **meta),
                           torch.zeros((1, 0), **meta))
    cols, bits = torch.zeros((1, A), **meta), torch.zeros((1, A, 1), **meta)
    seg_cell = torch.zeros((1, C, G), **meta)
    with pytest.raises(RuntimeError, match="not supported"):
        psv.serving_flags(tab, cols, bits, seg_cell, C, D, 2, 2)
    with pytest.raises(RuntimeError, match="not supported"):
        psv.serving_counts(tab, cols, bits, C, D, G)
    x = _inputs("D8")
    before = kernels.launch_counts()
    args = (x["rows"], x["ext_col"], x["cols"], x["bits"])
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.serving_counts_cuda(*args, x["C"], x["D"], x["G"])
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.serving_flags_cuda(*args, x["seg_cell"], x["C"], x["D"], 2,
                                   3)
    for bad_c, bad_g in ((x["C"] + 1, x["G"]), (x["C"], 33), (x["C"], 0)):
        with pytest.raises(ValueError, match="does not fit"):
            kernels.serving_counts_cuda(*args, bad_c, x["D"], bad_g)
    assert kernels.launch_counts() == before
