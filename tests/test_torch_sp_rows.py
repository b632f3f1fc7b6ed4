"""The SP's update of its active rows (`sp_rows`) and the step's activity
written in place, on the CPU.

`sp_rows_ref` (the plain version of the `sp_rows` kernel) is held to the
learning half of JAX `sp_step`, whose columns an `inhibition` hook
fixes, on tables whose values sit at and past the int16 rail and at
-0.0 (inactive rows, and padding lanes of active rows): every row of
both tables bit-equal, inactive rows unchanged. A numpy emulation of the
kernel's arithmetic (the two deltas of `hebbian_steps`, each row updated
once) is held to the plain version, duplicates included. The table pass
writes its activity over ``act_prev``, and a loop step leaves the
state's activity in the buffer it was given. The kernel itself runs only
on the card: tests/test_torch_cuda.py and `python3 chip_smoke.py`.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bithtm_tpu import make_htm_config as jax_make_htm_config
from bithtm_tpu.models.spatial_pooler import sp_step as jax_sp_step
from bithtm_tpu.state import SPState as JaxSPState

import bithtm_tpu_torch as bt
from bithtm_tpu_torch.models import spatial_pooler as psp
from bithtm_tpu_torch.ops import kernels
from bithtm_tpu_torch.ops.overlap import padded_input_dim
from bithtm_tpu_torch.state import SPState

# B, C, I, A: I_pad 1024 and 2048, one stream, and a column listed twice
CASES = {
    "bench-like": (3, 64, 1000, 5),
    "wide": (2, 48, 1500, 4),
    "one stream": (1, 40, 200, 6),
    "duplicates": (2, 32, 300, 6),
}


def _tables(dtype: str, B: int, C: int, I: int, A: int, seed: int):
    """Permanences with edge values, a (B, I) input and (B, A) columns
    (numpy): int16 rows at +-32000 and past the rail (+-32767/-32768),
    float32 -0.0 in every row and in the padding lanes of every row;
    the "duplicates" columns repeat within a stream."""
    rng = np.random.RandomState(seed)
    I_pad = padded_input_dim(I)
    if dtype == "int16":
        perm = rng.randint(-40, 40, size=(B, C, I_pad)).astype(np.int16)
        perm[..., 0:3] = 32000
        perm[..., 3:6] = -32000
        perm[..., 6], perm[..., 7] = 32767, -32768
        perm[..., I:] = -32000
        perm[:, 1::2, I:I + 2] = 32767    # padding lanes past the rail
    else:
        perm = (rng.randn(B, C, I_pad) * 0.05).astype(np.float32)
        perm[..., 0:8] = -0.0
        perm[..., I:] = -0.0
        perm[:, ::2, I:] = -1e9
    conn = rng.randint(0, 256, size=(B, C, I_pad // 8)).astype(np.uint8)
    x = rng.rand(B, I) < 0.3
    cols = np.stack([rng.choice(C, A, replace=False) for _ in range(B)])
    return perm, conn, x, cols.astype(np.int32)


def _jax_learning_half(jcfg, perm, conn, x, cols):
    """JAX `sp_step` with learning, its columns fixed by an inhibition
    hook, over each stream: the new (permanence, connected)."""
    C = perm.shape[1]

    def one(p, c, xi, ci):
        state = JaxSPState(permanence=p, connected=c,
                           duty_cycle=jnp.zeros(C, jnp.float32))
        mask = jnp.zeros(C, bool).at[ci].set(True)
        new, _ = jax_sp_step(jcfg, state, xi, True,
                             inhibition=lambda cfg, boosted: (ci, mask))
        return new.permanence, new.connected

    got = jax.jit(jax.vmap(one))(perm, conn, x, cols)
    return tuple(np.asarray(t) for t in got)


def _configs(dtype: str, I: int, C: int, A: int):
    kw = dict(input_dim=I, column_dim=C, cell_dim=4, active_columns=A,
              sp_overrides={"permanence_dtype": dtype})
    return jax_make_htm_config(**kw).sp, bt.make_htm_config(**kw).sp


def _bits(a: np.ndarray) -> np.ndarray:
    return a.view(np.uint8)


@pytest.mark.parametrize("dtype", ["int16", "float32"])
@pytest.mark.parametrize("case", list(CASES))
def test_sp_rows_ref_matches_jax_learning_half(case, dtype):
    """`sp_rows_ref` == JAX `sp_step`'s learning half, bit for bit, on
    both tables; rows outside the active columns keep every bit, values
    past the rail and -0.0 included. In place: it returns the tables it
    was given."""
    B, C, I, A = CASES[case]
    perm, conn, x, cols = _tables(dtype, B, C, I, A, seed=len(case))
    if case == "duplicates":
        cols[:, 3] = cols[:, 1]
        cols[0, 5] = cols[0, 0]
    jcfg, pcfg = _configs(dtype, I, C, A)
    want_perm, want_conn = _jax_learning_half(jcfg, perm, conn, x, cols)
    p, c = torch.from_numpy(perm.copy()), torch.from_numpy(conn.copy())
    got = psp.sp_rows_ref(pcfg, p, c, torch.from_numpy(x),
                          torch.from_numpy(cols))
    assert got[0] is p and got[1] is c
    np.testing.assert_array_equal(_bits(p.numpy()), _bits(want_perm))
    np.testing.assert_array_equal(c.numpy(), want_conn)
    active = np.zeros((B, C), bool)
    np.put_along_axis(active, cols.astype(np.int64), True, axis=1)
    np.testing.assert_array_equal(_bits(p.numpy())[~active],
                                  _bits(perm)[~active])
    np.testing.assert_array_equal(c.numpy()[~active], conn[~active])
    assert not np.array_equal(_bits(p.numpy())[active], _bits(perm)[active])


def _kernel_emulation(perm, conn, x, cols, d_on, d_off, thr):
    """The `sp_rows` kernel's arithmetic in numpy (csrc/sp_pass.cu): each
    stream's listed columns once, at their first place; lane i gets d_on
    where x[i], d_off where not, 0 past I; int16 widened, added and
    clipped, float32 added once; the row's strided pack written."""
    perm, conn = perm.copy(), conn.copy()
    B, C, I_pad = perm.shape
    I, S = x.shape[1], I_pad // 8
    lane = np.arange(I_pad)
    for b in range(B):
        xp = np.zeros(I_pad, bool)
        xp[:I] = x[b]
        for a, c in enumerate(cols[b]):
            if c in cols[b, :a]:
                continue
            if perm.dtype == np.int16:
                d = np.where(lane < I, np.where(xp, d_on, d_off), 0)
                row = np.clip(perm[b, c].astype(np.int32) + d, -32000, 32000)
                perm[b, c] = row.astype(np.int16)
            else:
                d = np.where(lane < I, np.where(xp, np.float32(d_on),
                                                np.float32(d_off)),
                             np.float32(0.0)).astype(np.float32)
                perm[b, c] = perm[b, c] + d
            on = (perm[b, c] >= np.asarray(thr, perm.dtype)).reshape(8, S)
            conn[b, c] = (on.astype(np.uint8) << np.arange(8)[:, None]
                          ).sum(0).astype(np.uint8)
    return perm, conn


@pytest.mark.parametrize("dtype", ["int16", "float32"])
@pytest.mark.parametrize("case", ["bench-like", "wide", "duplicates"])
def test_kernel_arithmetic_matches_plain_version(case, dtype):
    """The kernel's design, emulated: the two deltas `hebbian_steps`
    evaluates on the host, each listed row updated once, equal
    `sp_rows_ref` bit for bit, duplicates and edge values included."""
    B, C, I, A = CASES[case]
    perm, conn, x, cols = _tables(dtype, B, C, I, A, seed=7 + len(case))
    if case == "duplicates":
        cols[:, 4] = cols[:, 2]
    _, pcfg = _configs(dtype, I, C, A)
    want = _kernel_emulation(perm, conn, x, cols, *psp.hebbian_steps(pcfg))
    p, c = torch.from_numpy(perm.copy()), torch.from_numpy(conn.copy())
    psp.sp_rows(pcfg, p, c, torch.from_numpy(x), torch.from_numpy(cols))
    np.testing.assert_array_equal(_bits(p.numpy()), _bits(want[0]))
    np.testing.assert_array_equal(c.numpy(), want[1])


def _unit_update(perm, conn, x, b, c, t, d_on, d_off, thr):
    """One unit of the kernel, in place: tile t (128 packed bytes) of row
    c of stream b, its 8 slices of 128 lanes updated as
    `_kernel_emulation` updates a lane, and its packed bytes written."""
    S = perm.shape[-1] // 8
    I = x.shape[1]
    lanes = (np.arange(8)[:, None] * S + t * 128 + np.arange(128)).ravel()
    on = np.zeros(len(lanes), bool)
    on[lanes < I] = x[b, lanes[lanes < I]]
    if perm.dtype == np.int16:
        d = np.where(lanes < I, np.where(on, d_on, d_off), 0)
        perm[b, c, lanes] = np.clip(perm[b, c, lanes].astype(np.int32) + d,
                                    -32000, 32000).astype(np.int16)
    else:
        d = np.where(lanes < I, np.where(on, np.float32(d_on),
                                         np.float32(d_off)), np.float32(0.0))
        perm[b, c, lanes] = perm[b, c, lanes] + d.astype(np.float32)
    bit = (perm[b, c, lanes] >= np.asarray(thr, perm.dtype)).reshape(8, 128)
    conn[b, c, t * 128:(t + 1) * 128] = (
        bit.astype(np.uint8) << np.arange(8)[:, None]).sum(0).astype(np.uint8)


def _grid_units(B: int, C: int, I_pad: int, cols: np.ndarray, claims: str):
    """csrc/sp_pass.cu `sp_rows`' grid in numpy: the (stream, column,
    tile) of every unit that updates a row. A stream's units run
    tile-major (unit u: tile u // A, entry u % A), cut into the runs of
    `kernels.sp_rows_runs`, a block each. A block marks every entry's
    column (claims "bitmap": a column marked twice is repeated; "scan":
    every column might be); a unit whose entry is out of range, or whose
    column is repeated and listed by an earlier entry, updates nothing."""
    A = cols.shape[1]
    tiles, per, runs = kernels.sp_rows_runs(B, I_pad, A)
    units = []
    for b in range(B):
        for run in range(runs):
            u0, u1 = run * per, min(A * tiles, (run + 1) * per)
            assert (u1 - 1) // A - u0 // A < 49   # the staged input
            seen, repeated = set(), set()
            for c in cols[b]:
                if 0 <= c < C:
                    (repeated if c in seen else seen).add(int(c))
            for u in range(u0, u1):
                t, r = divmod(u, A)
                c = int(cols[b, r])
                if not 0 <= c < C:
                    continue
                if (claims == "scan" or c in repeated) and c in cols[b, :r]:
                    continue
                units.append((b, c, t))
    return units


# B, C, I, A: a unit a block (264 runs over one stream), four runs a stream
# (64 streams), rows of three tiles, and rows of 64 tiles in runs of 48
# units across them
GRID_CASES = {
    "a unit a block": (1, 64, 1000, 20),
    "four runs a stream": (64, 100, 300, 40),
    "three tiles": (2, 40, 3000, 9),
    "runs across 64-tile rows": (2, 100, 65_000, 100),
}


@pytest.mark.parametrize("claims", ["bitmap", "scan"])
@pytest.mark.parametrize("case", list(GRID_CASES))
def test_kernel_grid_updates_every_listed_row_once(case, claims):
    """`sp_rows`' grid and first claims, emulated, on columns drawn with
    replacement (repeats within a run and across a stream's runs) and
    ids outside [0, C): every tile of every listed row is updated by
    exactly one unit, and nothing else; where the tables are small, the
    units' updates equal `sp_rows_ref` (each bad id replaced by a repeat
    of the stream's first column) bit for bit, in int16 and float32."""
    B, C, I, A = GRID_CASES[case]
    I_pad = padded_input_dim(I)
    rng = np.random.RandomState(A + C)
    cols = rng.randint(0, min(C, 2 * A), size=(B, A)).astype(np.int32)
    cols[:, 3::7] = -1
    cols[:, 5::11] = C
    units = _grid_units(B, C, I_pad, cols, claims)
    tiles = I_pad // 1024
    count = np.zeros((B, C, tiles), np.int64)
    np.add.at(count, tuple(np.array(units).T), 1)
    listed = np.zeros((B, C), bool)
    for b in range(B):
        listed[b, cols[b][(cols[b] >= 0) & (cols[b] < C)]] = True
    np.testing.assert_array_equal(count, np.repeat(
        listed[..., None].astype(np.int64), tiles, axis=2))
    if B * C * I_pad > 1 << 23:
        return
    good = np.where((cols >= 0) & (cols < C), cols, cols[:, :1])
    for dtype in ("int16", "float32"):
        perm, conn, x, _ = _tables(dtype, B, C, I, A, seed=B + C)
        _, pcfg = _configs(dtype, I, C, A)
        steps = psp.hebbian_steps(pcfg)
        got_p, got_c = perm.copy(), conn.copy()
        for b, c, t in units:
            _unit_update(got_p, got_c, x, b, c, t, *steps)
        p, c = torch.from_numpy(perm.copy()), torch.from_numpy(conn.copy())
        psp.sp_rows_ref(pcfg, p, c, torch.from_numpy(x),
                        torch.from_numpy(good))
        np.testing.assert_array_equal(_bits(got_p), _bits(p.numpy()))
        np.testing.assert_array_equal(got_c, c.numpy())


@pytest.mark.parametrize("B,I_pad,A,want", [
    (256, 1024, 41, (1, 41, 1)),      # the bench: a stream a block
    (64, 1024, 328, (1, 47, 7)),      # 16K: runs of at most 48 units
    (1, 1024, 41, (1, 1, 41)),        # one stream: a unit a run
    (256, 4096, 16, (4, 32, 2)),      # the stack's second layer
    (2, 40_960, 5, (40, 2, 100)),     # two streams of 40-tile rows
    (65_536, 1024, 1, (1, 1, 1)),     # streams past the grid's y extent
    (300, 65_536, 2, (64, 43, 3)),    # 64-tile rows
    (300, 65_536, 200, (64, 48, 267)),
])
def test_sp_rows_runs_from_shapes(B, I_pad, A, want):
    """`sp_rows`' runs from the shapes alone: (tiles a row, units a run,
    runs a stream): about 264 blocks a launch, or runs of at most 48
    units where that makes more."""
    assert kernels.sp_rows_runs(B, I_pad, A) == want


@pytest.mark.parametrize("C,want", [(2048, "bitmap"), (65_536, "bitmap"),
                                    (65_537, "scan")])
def test_sp_rows_claims_from_shapes(C, want):
    """The first-claim bitmaps in shared memory up to 65,536 columns."""
    assert kernels._row_claims(C) == want


@pytest.mark.parametrize("dtype", ["int16", "float32"])
@pytest.mark.parametrize("steps", [(0.03, 0.015), (0.1, 0.0), (0.015, 0.05)])
def test_hebbian_steps_are_hebbian_deltas_values(dtype, steps):
    """The wrapper's two deltas and threshold are `hebbian_delta`'s: its
    row is d_on on active lanes, d_off on inactive ones and 0 past I,
    bit for bit, in the table's units."""
    inc, dec = steps
    cfg = bt.make_htm_config(
        300, 16, 4, active_columns=3,
        sp_overrides={"permanence_dtype": dtype,
                      "permanence_increment": inc,
                      "permanence_decrement": dec}).sp
    x = torch.from_numpy(np.random.RandomState(1).rand(2, 300) < 0.5)
    delta, thr = psp.hebbian_delta(cfg, x, 1024)
    d_on, d_off, thr_steps = psp.hebbian_steps(cfg)
    want = torch.zeros_like(delta)
    want[:, :300] = torch.where(x, torch.tensor(d_on, dtype=delta.dtype),
                                torch.tensor(d_off, dtype=delta.dtype))
    assert torch.equal(delta.view(torch.int32), want.view(torch.int32))
    assert thr_steps == thr


def _duplicate_hook(cfg, boosted):
    """k winners, with the first column listed again in place of the
    last: the scatter writes one row twice."""
    cols, mask = psp.k_winners(boosted, cfg.active_columns)
    cols = cols.clone()
    cols[:, -1] = cols[:, 0]
    return cols, psp.column_mask_from_cols(cols, boosted.shape[-1])


def _jax_duplicate_hook(cfg, boosted):
    from bithtm_tpu.ops.regularization import k_winners

    cols, _ = k_winners(boosted, cfg.active_columns)
    cols = cols.at[-1].set(cols[0])
    return cols, jnp.zeros(boosted.shape[-1], bool).at[cols].set(True)


@pytest.mark.parametrize("dtype", ["int16", "float32"])
def test_sp_step_with_duplicate_columns_matches_jax(dtype):
    """`sp_step` under an inhibition hook that lists a column twice
    equals JAX's over 6 learning steps: permanences, connected words,
    duty cycles and the active columns."""
    from bithtm_tpu import htm_init_batch as jax_htm_init_batch
    from bithtm_tpu_torch.convert import htm_state_from_numpy

    jcfg = jax_make_htm_config(input_dim=200, column_dim=64, cell_dim=4,
                               active_columns=5,
                               sp_overrides={"permanence_dtype": dtype})
    pcfg = bt.make_htm_config(input_dim=200, column_dim=64, cell_dim=4,
                              active_columns=5,
                              sp_overrides={"permanence_dtype": dtype})
    B = 2
    jfull = jax_htm_init_batch(jax.random.key(11), jcfg, B)
    jstate, pstate = jfull.sp, htm_state_from_numpy(jfull, "cpu").sp
    step = jax.jit(jax.vmap(lambda s, xi: jax_sp_step(
        jcfg.sp, s, xi, True, inhibition=_jax_duplicate_hook)))
    rng = np.random.RandomState(2)
    for t in range(6):
        x = rng.rand(B, 200) < 0.2
        jstate, jout = step(jstate, jnp.asarray(x))
        pstate, pout = psp.sp_step(pcfg.sp, pstate, torch.from_numpy(x),
                                   True, inhibition=_duplicate_hook)
        np.testing.assert_array_equal(pout.active_columns.numpy(),
                                      np.asarray(jout.active_columns))
        assert (pout.active_columns[:, 0] == pout.active_columns[:, -1]).all()
        for name in ("permanence", "connected", "duty_cycle"):
            np.testing.assert_array_equal(
                getattr(pstate, name).numpy(),
                np.asarray(getattr(jstate, name)), err_msg=f"{t} {name}")


def test_sp_rows_dispatch_runs_the_plain_version_on_the_cpu():
    """On CPU tensors `sp_step`'s learning dispatches the plain version
    and launches nothing; a `meta` tensor raises."""
    hcfg = bt.make_htm_config(200, 32, 4, active_columns=3)
    state = bt.htm_init_batch(hcfg, 2, torch.Generator().manual_seed(3),
                              "cpu").sp
    before = kernels.launch_counts()
    x = torch.from_numpy(np.random.RandomState(0).rand(2, 200) < 0.2)
    new, out = psp.sp_step(hcfg.sp, state, x, True)
    assert new.permanence is state.permanence
    assert new.connected is state.connected
    assert kernels.launch_counts() == before
    meta = SPState(*(t.to("meta") for t in dataclasses.astuple(state)))
    with pytest.raises(RuntimeError, match="not supported"):
        psp.sp_rows(hcfg.sp, meta.permanence, meta.connected,
                    x.to("meta"), out.active_columns.to("meta"))


def _learned_state():
    """The drive recipe's small config after 4 epochs of 5 patterns on
    two streams: segments exist, and the activity has live slots."""
    cfg = bt.make_htm_config(64, 64, 4, active_columns=4,
                             segment_activation_threshold=2,
                             segment_matching_threshold=2,
                             segment_sampling_synapses=8)
    gen = torch.Generator().manual_seed(9)
    state = bt.htm_init_batch(cfg, 2, gen, "cpu")
    pats = np.random.RandomState(4).rand(5, 2, 64) < 0.2
    xs = torch.from_numpy(np.concatenate([pats] * 4))
    draws = bt.TorchDraws(cfg.tm, 2, "cpu", gen)
    state, _ = bt.htm_scan(cfg, state, xs, True, draws=draws)
    return cfg, state, xs, draws


@pytest.mark.parametrize("mode", ["learning", "inference", "frozen"])
def test_loop_step_keeps_the_activity_in_its_buffer(mode):
    """A loop `htm_scan` leaves its returned state's `synapse_act` (and,
    learning, `seg_cell`) in the tensors of the state it was given: the
    table pass, `act_conn` and `act_frozen` write into them. The values
    are the step's own: the activity equals `act_conn` of the returned
    tables and active set."""
    from bithtm_tpu_torch.ops import active_set as pas

    from bithtm_tpu_torch.models.htm import _scan_impl

    learning = mode == "learning"
    cfg, state, xs, draws = _learned_state()
    act, seg_cell = state.tm.synapse_act, state.tm.seg_cell
    if mode == "frozen":
        word = pas.pack_frozen_table(state.tm.synapse_cell,
                                     state.tm.synapse_perm,
                                     cfg.tm.permanence_threshold)
        new, _ = _scan_impl(cfg, state, xs[:3], False, False, True,
                            frozen_word=word)
    else:
        new, _ = bt.htm_scan(cfg, state, xs[:3], learning, draws=draws)
    assert new.tm.synapse_act is act
    if learning:
        assert new.tm.seg_cell is seg_cell
    K = cfg.tm.synapse_capacity
    want = pas.synapse_activation_conn_ref(
        new.tm.synapse_cell, new.tm.synapse_perm, new.tm.active_cols,
        new.tm.active_bits, cfg.tm.cell_dim, cfg.tm.permanence_threshold, K)
    assert torch.equal(new.tm.synapse_act, want)
    assert bool((want != 0).any())
