"""The SP's column selection (`sp_select`: boost, top-A inhibition and the
duty-cycle EMA) on the CPU.

`sp_select_ref` (the plain version of the `sp_select` kernel) is held to
the JAX package's `boost`, `k_winners` and `duty_cycle_update` under the
contract of ROADMAP fault g (`testing.boost_agreement`): factors within 1
ulp, boosted overlaps within 2, the same winners in the same order in
every stream with no near tie (two of its top A + 1 values 1-4 ulp
apart), and the new duty cycles bit-equal. The cases: C = 37, 250 and
2048, A = 1 and A = C, every duty cycle 0 (every value tied), zero
overlaps, and negative overlaps from an overlap hook. A numpy emulation
of the kernel's algorithm (the radix select over order-preserving keys,
the winners in column order, their places by rank) is held to the plain
version bit for bit, -0.0 included. `sp_step` with the built-in rules
equals JAX `sp_step` over learning steps. The kernel itself runs only on
the card: tests/test_torch_cuda.py and `python3 chip_smoke.py`.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bithtm_tpu import htm_init_batch as jax_htm_init_batch
from bithtm_tpu import make_htm_config as jax_make_htm_config
from bithtm_tpu.models.spatial_pooler import sp_step as jax_sp_step
from bithtm_tpu.ops import regularization as jreg

import bithtm_tpu_torch as bt
from bithtm_tpu_torch.convert import htm_state_from_numpy
from bithtm_tpu_torch.models import spatial_pooler as psp
from bithtm_tpu_torch.ops import kernels
from bithtm_tpu_torch.ops import regularization as preg
from bithtm_tpu_torch.testing import float_ulps
from bithtm_tpu_torch.utils.profiling import call_sites

INTENSITY, DENSITY, MOMENTUM = 0.3, 41 / 2048, 0.99

# B, C, A, inputs: "random" duty cycles in [0, 3 density] (10% at 0) and
# binomial overlaps; "zero duty" every duty cycle 0 (the first step: each
# boosted value is its overlap, ties everywhere); "zero overlaps" half the
# overlaps 0; "few values" every duty cycle 0 and overlaps 0-3 (a quarter
# of the columns share each value); "two values" every duty cycle 0 and overlaps
# 0-1 (half the columns share each value); "negative" overlaps in [-40, 40]
# (an overlap hook's), some duty cycles so large that the factor is 0 and
# the value -0.0
CASES = {
    "C=37": (3, 37, 5, "random"),
    "C=250 A=1": (2, 250, 1, "random"),
    "C=250 A=C": (2, 250, 250, "random"),
    "C=2048": (4, 2048, 41, "random"),
    "zero duty": (3, 250, 12, "zero duty"),
    "zero overlaps": (3, 250, 12, "zero overlaps"),
    "negative": (3, 250, 12, "negative"),
    "zero duty A=C": (2, 37, 37, "zero duty"),
    # past a block of equal keys at the A-th value: four passes, then the
    # k-th lowest column among them
    "ties past a block": (2, 2048, 41, "few values"),
    # a warp a stream past 32 equal keys at the A-th value (some 64 of 128
    # columns share it), at its 64 winners, and with -0.0
    "warp ties past a warp": (2, 128, 40, "two values"),
    "warp A=64": (3, 100, 64, "random"),
    "warp few values": (4, 128, 40, "few values"),
    "warp negative": (3, 120, 12, "negative"),
    # past 512 winners: places by the LSD radix sort, distinct keys and
    # ties (passes skipped where every winner shares the byte)
    "lsd": (2, 2048, 600, "random"),
    "lsd ties": (2, 2048, 900, "few values"),
    # past 160 KiB of lists: sorted by a cluster of 8 blocks
    "cluster lsd": (1, 12_000, 10_500, "zero duty"),
}


def _inputs(B: int, C: int, kind: str, seed: int):
    rng = np.random.default_rng(seed)
    duty = rng.random((B, C), dtype=np.float32) * np.float32(3 * DENSITY)
    duty[rng.random((B, C)) < 0.1] = 0.0
    ov = rng.binomial(60, 0.1, (B, C)).astype(np.int32)
    if kind == "zero duty":
        duty[:] = 0.0
    elif kind in ("few values", "two values"):
        duty[:] = 0.0
        ov = rng.integers(0, 4 if kind == "few values" else 2,
                          (B, C)).astype(np.int32)
    elif kind == "zero overlaps":
        ov[rng.random((B, C)) < 0.5] = 0
    elif kind == "negative":
        ov = rng.integers(-40, 41, (B, C)).astype(np.int32)
        duty[:, ::7] = np.float32(1e4)   # factor exp(-1.5e5) = 0
    return ov, duty


@functools.partial(jax.jit, static_argnums=(2,))
def _jax_chain(ov, duty, k):
    boosted = jreg.boost(ov, duty, INTENSITY, DENSITY)
    idx, mask = jax.vmap(lambda r: jreg.k_winners(r, k))(boosted)
    return (jreg.boost_factor(duty, INTENSITY, DENSITY), boosted, idx,
            mask, jreg.duty_cycle_update(duty, mask, MOMENTUM))


def _near_ties(boosted: torch.Tensor, k: int) -> torch.Tensor:
    """Streams two of whose k + 1 largest values are 1-4 ulp apart: there
    the 1-2 ulp between the port's and XLA's values may reorder them."""
    top = torch.sort(boosted, dim=-1, descending=True).values
    top = top[:, :k + 1]
    gaps = float_ulps(top[:, 1:], top[:, :-1])
    return ((gaps > 0) & (gaps <= 4)).any(-1)


@pytest.mark.parametrize("case", list(CASES))
def test_sp_select_ref_matches_jax(case):
    """Factor within 1 ulp of JAX's, boosted within 2, the winners and
    their order equal outside near ties, the duty cycles bit-equal where
    the masks agree (every stream of these cases but near ties)."""
    B, C, A, kind = CASES[case]
    ov, duty = _inputs(B, C, kind, seed=C + A)
    boosted, cols, mask, new_duty = preg.sp_select_ref(
        torch.from_numpy(ov), torch.from_numpy(duty), A, INTENSITY,
        DENSITY, MOMENTUM)
    factor = preg.sp_select_ref(torch.ones((B, C), dtype=torch.int32),
                                torch.from_numpy(duty), A, INTENSITY,
                                DENSITY, MOMENTUM)[0]
    j_factor, j_boosted, j_idx, j_mask, j_duty = (
        torch.from_numpy(np.array(t)) for t in _jax_chain(
            jnp.asarray(ov), jnp.asarray(duty), A))
    assert int(float_ulps(factor, j_factor).max()) <= 1
    assert int(float_ulps(boosted, j_boosted).max()) <= 2
    assert cols.dtype == torch.int32 and mask.dtype == torch.bool
    assert tuple(cols.shape) == (B, A) and tuple(mask.shape) == (B, C)
    clear = ~_near_ties(boosted, A)
    if kind != "random":
        assert bool(clear.all())
    assert bool(clear.any())
    assert torch.equal(cols[clear], j_idx[clear].to(torch.int32))
    assert torch.equal(mask[clear], j_mask[clear])
    agree = (mask == j_mask).all(-1)
    assert torch.equal(new_duty[agree].view(torch.int32),
                       j_duty[agree].view(torch.int32))
    assert torch.equal(mask, torch.zeros_like(mask).scatter_(
        1, cols.long(), True))


def _order_keys(v: np.ndarray) -> np.ndarray:
    """csrc/select_pass.cu `order_key`: larger value, larger key; -0.0 as
    +0.0."""
    u = v.view(np.uint32).copy()
    u[(u << np.uint32(1)) == 0] = 0
    return np.where(u & np.uint32(0x80000000), ~u,
                    u | np.uint32(0x80000000)).astype(np.uint32)


def _pairs(key: np.ndarray) -> np.ndarray:
    """csrc/select_pass.cu `pair_of`: (key, ~column), distinct, in the
    stable descending sort's order."""
    return (key.astype(np.uint64) << np.uint64(32)) | (
        ~np.arange(len(key), dtype=np.uint32)).astype(np.uint64)


def _threshold(key: np.ndarray, A: int, threads: int) -> int:
    """The kernel's radix select of the A-th largest pair: 8-bit passes
    from the top; a bin that wins whole gives its lowest key, a bin of at
    most ``threads`` keys the k-th largest of its pairs, and after four
    passes the k-th lowest column of the equal keys left."""
    prefix = pmask = 0
    k = A
    for shift in (24, 16, 8, 0):
        part = (key & np.uint32(pmask)) == prefix
        hist = np.bincount((key[part] >> shift) & 255, minlength=256)[::-1]
        above = np.concatenate([[0], np.cumsum(hist)])[:-1]
        t = int(np.nonzero((above < k) & (above + hist >= k))[0][0])
        k, count = k - int(above[t]), int(hist[t])
        prefix |= (255 - t) << shift
        pmask |= 0xFF << shift
        if count == k:
            return prefix << 32
        inside = (key & np.uint32(pmask)) == prefix
        if count <= threads:
            return int(np.sort(_pairs(key)[inside])[::-1][k - 1])
    return int(_pairs(key)[np.nonzero(key == prefix)[0][k - 1]])


def _lsd_places(listed: np.ndarray, warps: int,
                blocks: int = 1) -> np.ndarray:
    """csrc/select_pass.cu `lsd_sort` on the winners' pairs in column
    order: 8-bit passes from the key's lowest byte, a pass skipped where
    every key shares its byte; in a pass each of the cluster's ``blocks``
    takes a run of the pairs and each of its warps a run of whole 32-pair
    slots of it, counts its digits, the (digit, block, warp) counts are
    scanned digit-major (largest digit first), then by block and warp,
    and each pair goes to its entry's next place, in slot and lane order.
    Returns the pairs in their places."""
    n = len(listed)
    keys = (listed >> np.uint64(32)).astype(np.uint32)
    diff = int(np.bitwise_or.reduce(keys, initial=0)
               ^ np.bitwise_and.reduce(keys, initial=0xFFFFFFFF))
    per = -(-n // blocks)
    owner = np.zeros(n, np.int64)   # the (block, warp) entry of a pair
    for blk in range(blocks):
        lo, hi = min(n, blk * per), min(n, (blk + 1) * per)
        chunk = -(-(hi - lo) // (32 * warps)) * 32
        owner[lo:hi] = blk * warps + np.arange(hi - lo) // max(chunk, 1)
    src = listed.copy()
    for shift in (0, 8, 16, 24):
        if not (diff >> shift) & 0xFF:
            continue
        bins = 255 - ((src >> np.uint64(32 + shift)) & np.uint64(255)).astype(
            np.int64)
        counts = np.zeros((blocks * warps, 256), np.int64)
        np.add.at(counts, (owner, bins), 1)
        first = np.concatenate([[0], np.cumsum(counts.T.ravel())])[:-1]
        first = first.reshape(256, blocks * warps).T.copy()
        dst = np.zeros_like(src)
        for i in range(n):
            dst[first[owner[i], bins[i]]] = src[i]
            first[owner[i], bins[i]] += 1
        src = dst
    return src


def _kernel_emulation(ov, duty, A: int):
    """The `sp_select` kernel's algorithm in numpy, stream by stream: the
    boost in float32 with a float64 exp; the path from the shapes
    (`kernels._select_path`); the threshold (`_threshold`, at 32 keys a
    warp on the warp path, else at the block's 256 threads up to 2,048
    columns, 1,024 past them, as many over a cluster's two blocks; A = C:
    every pair); the winners, the pairs
    at or above it, listed in column order; each winner's place the count
    of pairs above it ("rank") or its place after the LSD sort ("lsd",
    "cluster_lsd": `_lsd_places` over one block or eight); the EMA as one
    FMA (`_fma_f32`)."""
    scale, momentum, one_minus = preg.select_scalars(INTENSITY, DENSITY,
                                                     MOMENTUM)
    factor = np.exp((np.float32(scale) * duty).astype(np.float64)).astype(
        np.float32)
    boosted = factor * ov.astype(np.float32)
    B, C = ov.shape
    grid, _, places = kernels._select_path(B, C, A)
    threads = 32 if grid == "warp" else 256 if C <= 2048 else 1024
    cols = np.zeros((B, A), np.int32)
    mask = np.zeros((B, C), bool)
    for b in range(B):
        key = _order_keys(boosted[b])
        if A:
            pairs = _pairs(key)
            threshold = 0 if A == C else _threshold(key, A, threads)
            won = pairs >= np.uint64(threshold)
            mask[b] = won
            listed = pairs[won]
            if places == "rank":
                rank = (listed[None, :] > listed[:, None]).sum(1)
                cols[b, rank] = np.nonzero(won)[0]
            else:
                placed = _lsd_places(listed, threads // 32,
                                     8 if places == "cluster_lsd" else 1)
                cols[b] = ~(placed & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    t = torch.from_numpy
    new_duty = preg._fma_f32(t(duty), momentum,
                             t(mask).to(torch.float32) * one_minus)
    return boosted, cols, mask, new_duty.numpy()


@pytest.mark.parametrize("case", list(CASES))
def test_kernel_algorithm_matches_plain_version(case):
    """The kernel's design, emulated, equals `sp_select_ref` bit for bit:
    the boosted values, the winners in order, the mask and the duty
    cycles, through ties, A = 1, A = C and -0.0."""
    B, C, A, kind = CASES[case]
    ov, duty = _inputs(B, C, kind, seed=3 * C + A)
    want = preg.sp_select_ref(torch.from_numpy(ov), torch.from_numpy(duty),
                              A, INTENSITY, DENSITY, MOMENTUM)
    got = _kernel_emulation(ov, duty, A)
    if kind == "two values":   # more than 32 equal keys at the A-th value
        assert ((ov == 1).sum(-1) >= max(A, 33)).all()
    if kind == "negative":
        assert (np.signbit(got[0]) & (got[0] == 0)).any()
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.view(np.uint8) if g.dtype != bool
                                      else g, w.numpy().view(np.uint8)
                                      if g.dtype != bool else w.numpy())


def test_select_scalars_are_the_chains_float32_roundings():
    """The kernel's scalars are the chain's own: the boost's factor
    argument, the EMA's momentum and its 1 - momentum, each a Python
    value rounded once to float32."""
    scale, m, om = preg.select_scalars(INTENSITY, DENSITY, MOMENTUM)
    duty = torch.tensor([0.0125, 0.5, 3e-5], dtype=torch.float32)
    assert torch.equal(torch.tensor(scale, dtype=torch.float32) * duty,
                       -(INTENSITY / DENSITY) * duty)
    assert (m, om) == (float(np.float32(MOMENTUM)),
                       float(np.float32(1.0 - MOMENTUM)))


@pytest.mark.parametrize("B,C,A,want", [
    (2, 37, 5, ("warp", "smem", "rank")),
    (2, 128, 64, ("warp", "smem", "rank")),
    (2, 128, 65, ("regs", "smem", "rank")),
    (2047, 512, 16, ("regs", "smem", "rank")),
    (2048, 512, 16, ("regs", "smem", "rank")),
    (65_536, 64, 5, ("warp", "smem", "rank")),
    (65_536, 513, 5, ("regs", "smem", "rank")),
    (256, 2048, 41, ("regs", "smem", "rank")),
    (64, 16384, 328, ("cluster", "smem", "rank")),
    (132, 8193, 512, ("cluster", "smem", "rank")),
    (133, 16384, 328, ("regs", "smem", "rank")),
    (64, 8192, 328, ("regs", "smem", "rank")),
    (64, 16384, 513, ("regs", "smem", "lsd")),
    (4, 16384, 10_240, ("regs", "smem", "lsd")),     # 160 KiB of lists
    (4, 16384, 10_241, ("regs", "global", "cluster_lsd")),
    (4, 16385, 1, ("global", "smem", "rank")),
    (4, 20_000, 400, ("global", "smem", "rank")),
    (2, 30_000, 2_740, ("global", "smem", "lsd")),
    (2, 30_000, 2_741, ("global", "smem", "lsd")),
    (2, 30_000, 30_000, ("global", "global", "cluster_lsd")),
    (2, 32_768, 1, ("global", "smem", "rank")),
    (2, 32_769, 1, ("global", "smem", "rank")),
])
def test_select_path_from_shapes(B, C, A, want):
    """`sp_select`'s path from B, C and A alone: a warp a stream up to 64
    winners and 128 columns, at any count of streams; two blocks a stream
    past 8,192 columns at up to 132 streams and 512 winners; else a block
    with its keys in registers up to 16,384 columns, else read again from
    the boosted values; the winners placed by counting up to 512 of them,
    else by the LSD sort, whose two lists stay in shared memory up to 160
    KiB, else in global memory, sorted by a cluster of 8 blocks a
    stream."""
    assert kernels._select_path(B, C, A) == want


def test_lsd_places_are_the_stable_descending_sort():
    """The LSD sort's places (`_lsd_places`, at 1 to 32 warps, in one
    block or a cluster of 8) equal a stable sort of the column-ordered
    pairs by key, descending: value down, column up, through keys equal
    in some bytes and in all."""
    rng = np.random.default_rng(11)
    for n, spread in ((1, 3), (31, 3), (600, 2**8), (2049, 2**20),
                      (700, 2**32 - 1)):
        key = rng.integers(0, spread, n, dtype=np.uint64) * np.uint64(
            0x01010101 if spread == 3 else 1)
        key = np.minimum(key, np.uint64(0xFFFFFFFF))
        pairs = (key << np.uint64(32)) | (~np.arange(
            n, dtype=np.uint32)).astype(np.uint64)
        want = pairs[np.argsort(-key.astype(np.int64), kind="stable")]
        for warps, blocks in ((1, 1), (8, 1), (32, 1), (32, 8), (1, 8)):
            np.testing.assert_array_equal(
                _lsd_places(pairs, warps, blocks), want)


@pytest.mark.parametrize("dtype", ["int16", "float32"])
@pytest.mark.parametrize("C", [37, 64])
def test_sp_step_matches_jax(dtype, C):
    """`sp_step` with the built-in boost and inhibition (`sp_select` on
    the CPU) equals JAX `sp_step` over 6 learning steps and an inference
    step from one converted state: the active columns in order, the mask,
    the overlaps, the boosted overlaps within 2 ulp, and the permanences,
    connected words and duty cycles bit for bit. The duty cycles grow
    from 0, so the boost takes effect."""
    kw = dict(input_dim=200, column_dim=C, cell_dim=4, active_columns=5,
              sp_overrides={"permanence_dtype": dtype})
    jcfg, pcfg = jax_make_htm_config(**kw), bt.make_htm_config(**kw)
    B = 3
    jfull = jax_htm_init_batch(jax.random.key(C), jcfg, B)
    jstate, pstate = jfull.sp, htm_state_from_numpy(jfull, "cpu").sp
    steps = {learn: jax.jit(jax.vmap(
        lambda s, xi, learn=learn: jax_sp_step(jcfg.sp, s, xi, learn)))
        for learn in (True, False)}
    rng = np.random.RandomState(C)
    for t in range(7):
        learn = t < 6
        x = rng.rand(B, 200) < 0.2
        jstate, jout = steps[learn](jstate, jnp.asarray(x))
        pstate, pout = psp.sp_step(pcfg.sp, pstate, torch.from_numpy(x),
                                   learn)
        for name in ("active_columns", "active_mask", "overlaps"):
            np.testing.assert_array_equal(getattr(pout, name).numpy(),
                                          np.asarray(getattr(jout, name)),
                                          err_msg=f"{t} {name}")
        assert int(float_ulps(pout.boosted_overlaps, torch.from_numpy(
            np.array(jout.boosted_overlaps))).max()) <= 2
        for f in dataclasses.fields(pstate):
            np.testing.assert_array_equal(
                getattr(pstate, f.name).numpy(),
                np.asarray(getattr(jstate, f.name)), err_msg=f"{t} {f.name}")
    assert bool((pstate.duty_cycle > 0).any())


def test_sp_select_dispatch_runs_the_plain_version_on_the_cpu():
    """On CPU tensors `sp_select` is `sp_select_ref` and launches nothing;
    it leaves the duty cycles it was given as they were; `sp_step` runs
    it under the one call site `sp_step.select`; a `meta` tensor
    raises."""
    ov, duty = _inputs(2, 64, "random", seed=5)
    ov, duty = torch.from_numpy(ov), torch.from_numpy(duty)
    before_duty = duty.clone()
    launches = kernels.launch_counts()
    got = preg.sp_select(ov, duty, 4, INTENSITY, DENSITY, MOMENTUM)
    want = preg.sp_select_ref(ov, duty, 4, INTENSITY, DENSITY, MOMENTUM)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert torch.equal(duty, before_duty) and got[3] is not duty
    assert kernels.launch_counts() == launches
    with pytest.raises(RuntimeError, match="not supported"):
        preg.sp_select(ov.to("meta"), duty.to("meta"), 4, INTENSITY,
                       DENSITY, MOMENTUM)
    hcfg = bt.make_htm_config(200, 64, 4, active_columns=4)
    state = bt.htm_init_batch(hcfg, 2, torch.Generator().manual_seed(3),
                              "cpu").sp
    x = torch.from_numpy(np.random.RandomState(0).rand(2, 200) < 0.2)
    with call_sites(), torch.profiler.profile() as prof:
        psp.sp_step(hcfg.sp, state, x, False)
    names = {e.name for e in prof.events()}
    assert "sp_step.select" in names
    assert not names & {"sp_step.boost", "sp_step.k_winners",
                        "sp_step.duty_cycle"}
