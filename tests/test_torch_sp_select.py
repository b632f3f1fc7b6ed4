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
# overlaps 0; "few values" every duty cycle 0 and overlaps 0-3 (some 500
# columns share each value); "negative" overlaps in [-40, 40] (an overlap
# hook's), some duty cycles so large that the factor is 0 and the value -0.0
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
}


def _inputs(B: int, C: int, kind: str, seed: int):
    rng = np.random.default_rng(seed)
    duty = rng.random((B, C), dtype=np.float32) * np.float32(3 * DENSITY)
    duty[rng.random((B, C)) < 0.1] = 0.0
    ov = rng.binomial(60, 0.1, (B, C)).astype(np.int32)
    if kind == "zero duty":
        duty[:] = 0.0
    elif kind == "few values":
        duty[:] = 0.0
        ov = rng.integers(0, 4, (B, C)).astype(np.int32)
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


def _kernel_emulation(ov, duty, A: int):
    """The `sp_select` kernel's algorithm in numpy, stream by stream: the
    boost in float32 with a float64 exp; the threshold (`_threshold`, at
    the kernel's 256 threads a block up to 2,048 columns, else 1,024);
    the winners, the pairs at or above it; each winner's place the count
    of pairs above it; the EMA as one FMA (`_fma_f32`)."""
    scale, momentum, one_minus = preg.select_scalars(INTENSITY, DENSITY,
                                                     MOMENTUM)
    factor = np.exp((np.float32(scale) * duty).astype(np.float64)).astype(
        np.float32)
    boosted = factor * ov.astype(np.float32)
    B, C = ov.shape
    cols = np.zeros((B, A), np.int32)
    mask = np.zeros((B, C), bool)
    for b in range(B):
        key = _order_keys(boosted[b])
        if A:
            pairs = _pairs(key)
            won = pairs >= np.uint64(_threshold(key, A,
                                                 256 if C <= 2048 else 1024))
            mask[b] = won
            listed = pairs[won]
            rank = (listed[None, :] > listed[:, None]).sum(1)
            cols[b, rank] = np.nonzero(won)[0]
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


@pytest.mark.parametrize("C,A,want", [
    (37, 5, ("regs", "smem")),
    (2048, 41, ("regs", "smem")),
    (16384, 328, ("regs", "smem")),
    (16384, 16384, ("regs", "smem")),    # 128 KB of pairs
    (16385, 1, ("global", "smem")),
    (30000, 30000, ("global", "global")),
])
def test_select_path_from_shapes(C, A, want):
    """`sp_select`'s path from C and A alone: the keys in registers up to
    16,384 columns a stream, the winners' pairs in shared memory up to
    200 KiB."""
    assert kernels._select_path(C, A) == want


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
