"""The port's compile layer (`bithtm_tpu_torch/models/graph.py`) on the
CPU, where its "step into buffers" function runs eagerly.

Inside `graph.runner_eager()` the entry points (`htm_scan`,
`htm_serve_scan`, `htm_scan_autocap`, `stack_scan`, the wrappers'
`process`) run a CPU state through the same runner whose graph they
replay on the card: static state buffers, a (rows, ...) input block read
at a counter, outputs written at the counter, every new leaf copied back
into its buffer. Each path is held bit-equal in every state leaf and
metric to the JAX package on the same numpy-seeded inputs and the JAX
draws (the JAX-parity tests of the other files, run under the context)
and to the port's own loop (`graph.eager()`). Then the runner's own
contracts: donation (a state passed back copies nothing in), lineages
(another state never overwrites one returned earlier), the write-back
of aliasing leaves, the warm-up that consumes no draw, and the mirrors
of `tests/test_htm.py`'s scan, stream-independence and convergence
tests.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bithtm_tpu import htm_init_batch as jax_htm_init_batch
from bithtm_tpu import htm_scan as jax_htm_scan
from bithtm_tpu import htm_step_batch as jax_htm_step_batch
from bithtm_tpu.ops import active_set as jas
from bithtm_tpu.ops import serving as jsv

import bithtm_tpu_torch as bt
from bithtm_tpu_torch import networks as pnet
from bithtm_tpu_torch.models import graph
from bithtm_tpu_torch.utils.profiling import call_sites

from . import test_torch_api as api
from . import test_torch_geometry as geometry
from . import test_torch_htm as th
from . import test_torch_serving as serving
from . import test_torch_stack as stack
from .test_torch_serving import trained  # noqa: F401 (a fixture)

SMALL = th.SMALL
FAST = dict(SMALL, segments_per_column=4, synapse_capacity=64,
            sp_overrides={"permanence_dtype": "int16"})


def leaves(state) -> dict:
    return {f"{part}.{f.name}": getattr(getattr(state, part), f.name)
            for part in ("sp", "tm")
            for f in dataclasses.fields(getattr(state, part))}


def assert_states_equal(a, b, what):
    la, lb = leaves(a), leaves(b)
    for k in la:
        assert torch.equal(la[k], lb[k]), f"{what}: {k}"
        assert la[k].dtype == lb[k].dtype, f"{what}: {k}"


def assert_dicts_equal(a: dict, b: dict, what):
    assert list(a) == list(b), what
    for k in a:
        assert torch.equal(a[k], b[k]), f"{what}: {k}"


def sequence(T, B, seed, I=64):
    rng = np.random.RandomState(seed)
    pats = rng.rand(5, I) < 0.2
    t = np.arange(T)
    return torch.from_numpy(pats[(t[:, None] + np.arange(B)[None]) % 5])


# ---- every path against JAX, through the runner -----------------------


def test_learning_through_buffers_matches_jax(trained):  # noqa: F811
    """`htm_scan` learning through the runner: the serving tests'
    training run (40 steps, B=3, int16 SP) from JAX's initial state with
    JAX's draws, equal to JAX's `htm_scan` in every leaf and metric."""
    jcfg, pcfg, jstate, _, _ = trained
    B, T = serving.B_SERVE, serving.N_TRAIN
    pats = np.random.RandomState(7).rand(5, B, 64) < 0.2
    train = pats[np.arange(T) % 5]     # the fixture's training inputs
    j0 = jax_htm_init_batch(jax.random.key(0), jcfg, B)
    p0 = bt.htm_state_from_numpy(j0, "cpu")
    draws = th.ReplayDraws(pcfg.tm, th.copy_keys(j0.key))
    jgot, jm = jax_htm_scan(jcfg, j0, jnp.asarray(train), True, 1)
    with graph.runner_eager():
        pgot, pm = bt.htm_scan(pcfg, p0, torch.from_numpy(train), True,
                               draws=draws)
    th.assert_metrics_equal(jm, pm, "learning")
    th.assert_tree_equal(jgot, bt.htm_state_to_numpy(pgot), "learning")
    th.assert_tree_equal(jstate, bt.htm_state_to_numpy(pgot), "fixture")


@pytest.mark.parametrize("form", ["unpacked", "packed", "frozen"])
def test_serving_forms_through_buffers_match_jax(trained, form):  # noqa: F811
    """`htm_serve_scan` unpacked and over a serving table, and the scan
    over a frozen word table, through the runner: JAX's leaves (the
    packed form's stale ones included) and metrics, and the unpacked
    form's predictions."""
    with graph.runner_eager():
        serving.test_serve_scan_matches_jax(trained, form)


def test_autocap_through_buffers_matches_jax():
    """`htm_scan_autocap` through the runner, escalating: JAX's
    escalation step, metrics and leaves; the escalated chunk restored
    into the tuned graph's buffers and re-run by the safe config's graph
    with the JAX draws of the safe config."""
    with graph.runner_eager():
        geometry.test_htm_scan_autocap_matches_jax(
            dict(growth_capacity=8), 4, 24, True)


def test_stack_through_buffers_matches_jax():
    """`stack_scan` of the two-layer stack through the runner, 30
    learning then 6 inference steps: every leaf and metric of JAX's."""
    with graph.runner_eager():
        stack.test_stack_scan_matches_jax()


def test_htm_wrapper_through_buffers_matches_jax():
    """A B=1 wrapper epoch and more (20 `process` calls, learning and
    inference, with and without winner cells) through the runner: every
    output, leaf and `last_metrics` value of the JAX wrapper's."""
    with graph.runner_eager():
        api.test_htm_wrapper_matches_jax("reference")


@pytest.mark.parametrize("form", ["unpacked", "packed", "frozen"])
def test_htm_step_batch_matches_jax(trained, form):  # noqa: F811
    """`htm_step_batch` under the JAX signature: an inference step
    without winner cells (it draws nothing) from the trained state, in
    each forward form, equal to JAX's in every leaf and metric."""
    jcfg, pcfg, jstate, serve, _ = trained
    x = serve[0]
    kw_j, kw_p = {}, {}
    pstate = bt.htm_state_from_numpy(jstate, "cpu")
    if form == "packed":
        kw_j["serving_table"] = jsv.make_serving_table(jcfg.tm, jstate.tm)
        kw_p["serving_table"] = bt.make_serving_table(pcfg.tm, pstate.tm)
    if form == "frozen":
        kw_j["frozen_word"] = jas.pack_frozen_table(
            jstate.tm.synapse_cell, jstate.tm.synapse_perm,
            jcfg.tm.permanence_threshold)
        kw_p["frozen_word"] = bt.pack_frozen_table(
            pstate.tm.synapse_cell, pstate.tm.synapse_perm,
            pcfg.tm.permanence_threshold, num_cells=pcfg.tm.num_cells)
    step = jax.jit(jax_htm_step_batch, static_argnums=(0, 3, 4, 5))
    jgot, jout = step(jcfg, jstate, jnp.asarray(x), False, False, False,
                      **kw_j)
    pgot, pout = bt.htm_step_batch(pcfg, pstate, torch.from_numpy(x), False,
                                   False, False, **kw_p)
    th.assert_metrics_equal(jout.metrics, pout.metrics, form)
    th.assert_tree_equal(jgot, bt.htm_state_to_numpy(pgot), form)


# ---- every path against the port's loop ---------------------------------


def _both(run):
    """``run()`` inside `graph.eager()` and inside
    `graph.runner_eager()`."""
    with graph.eager():
        loop = run()
    with graph.runner_eager():
        buffers = run()
    return loop, buffers


@pytest.mark.parametrize("cfg_kw", [SMALL, FAST])
def test_scans_through_buffers_equal_the_loop(cfg_kw):
    """Learning (40 steps, more than one input block at 16 rows),
    inference with winner cells, and serving in the three forms, from
    one seeded torch.Generator: every leaf, metric and the generator's
    state after each run equal to the loop's."""
    cfg = bt.make_htm_config(**cfg_kw)
    B = 3
    x = sequence(60, B, 0)

    def run():
        gen = torch.Generator().manual_seed(5)
        state = bt.htm_init_batch(cfg, B, gen, "cpu")
        draws = bt.TorchDraws(cfg.tm, B, "cpu", gen)
        out = []
        state, m = bt.htm_scan(cfg, state, x[:40], True, draws=draws)
        out.append((m, gen.get_state()))
        state, m = bt.htm_scan(cfg, state, x[40:46], False, draws=draws)
        out.append((m, gen.get_state()))
        tab = bt.make_serving_table(cfg.tm, state.tm)
        word = bt.pack_frozen_table(state.tm.synapse_cell,
                                    state.tm.synapse_perm,
                                    cfg.tm.permanence_threshold,
                                    num_cells=cfg.tm.num_cells)
        served = []
        for kw in ({}, {"serving_table": tab}):
            s, m = bt.htm_serve_scan(cfg, bt.htm_state_from_numpy(
                bt.htm_state_to_numpy(state), "cpu"), x[46:], **kw)
            served.append((s, m))
        from bithtm_tpu_torch.models.htm import _scan_impl
        served.append(_scan_impl(cfg, state, x[46:], False, False, False,
                                 frozen_word=word))
        return out, served

    old_rows = graph.ROWS
    graph.ROWS = 16
    try:
        (loop_out, loop_served), (buf_out, buf_served) = _both(run)
    finally:
        graph.ROWS = old_rows
    for (ml, gl), (mb, gb) in zip(loop_out, buf_out):
        assert_dicts_equal(ml, mb, "scan metrics")
        assert torch.equal(gl, gb), "the generator's state"
    for (sl, ml), (sb, mb) in zip(loop_served, buf_served):
        assert_dicts_equal(ml, mb, "serving metrics")
        assert_states_equal(sl, sb, "served state")
    assert int(loop_served[0][1]["correct"].sum()) > 0


def test_runner_eager_equals_the_loop_and_ranges_its_copies():
    """`graph.runner_eager()` runs the "step into buffers" runner eagerly
    on any device (on the card, what `scripts/profile_step` profiles: the
    graph's work op by op). A learning scan through it equals the loop in
    every leaf and metric and in the generator's state, and under
    `call_sites()` the copies between the step and the buffers run under
    the range `graph.buffers`, beside the step's own ranges."""
    cfg = bt.make_htm_config(**SMALL)
    B = 2
    x = sequence(8, B, 1)

    def run():
        gen = torch.Generator().manual_seed(3)
        state = bt.htm_init_batch(cfg, B, gen, "cpu")
        draws = bt.TorchDraws(cfg.tm, B, "cpu", gen)
        state, m = bt.htm_scan(cfg, state, x, True, draws=draws)
        return state, m, gen.get_state()

    with graph.eager():
        loop = run()
    with graph.runner_eager(), call_sites(), torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        runner = run()
    assert_states_equal(loop[0], runner[0], "runner state")
    assert_dicts_equal(loop[1], runner[1], "runner metrics")
    assert torch.equal(loop[2], runner[2]), "the generator's state"
    names = {e.name for e in prof.events()}
    assert {"graph.buffers", "tm_step._learn/_grow"} <= names


def test_autocap_escalation_through_buffers_equals_the_loop():
    """An escalating `htm_scan_autocap` with production draws: the
    restore of the dropping chunk into the buffers and the safe re-run
    give the loop's leaves, metrics, info and generator state."""
    cfg = bt.make_htm_config(**geometry.AUTOCAP)
    x = sequence(24, 2, 3, I=128)

    def run():
        gen = torch.Generator().manual_seed(9)
        state = bt.htm_init_batch(cfg, 2, gen, "cpu")
        draws = bt.TorchDraws(cfg.tm, 2, "cpu", gen)
        s, m, info = bt.htm_scan_autocap(
            cfg, state, x, tuned=dict(growth_capacity=8), chunk=4,
            draws=draws)
        return s, m, info, gen.get_state()

    (sl, ml, il, gl), (sb, mb, ib, gb) = _both(run)
    assert il == ib and il["escalated_at_step"] is not None
    assert_dicts_equal(ml, mb, "autocap metrics")
    assert_states_equal(sl, sb, "autocap state")
    assert torch.equal(gl, gb)


def test_stack_through_buffers_equals_the_loop():
    cfg = stack.make_cfg()
    x = sequence(20, 2, 4)

    def run():
        gen = torch.Generator().manual_seed(1)
        state = bt.stack_init(cfg, 2, gen, "cpu")
        draws = bt.stack_draws(cfg, 2, "cpu", gen)
        s, m1 = bt.stack_scan(cfg, state, x[:16], True, draws)
        s, m2 = bt.stack_scan(cfg, s, x[16:], False, draws)
        return s, m1, m2

    (sl, *ml), (sb, *mb) = _both(run)
    for a, b in zip(ml, mb):
        assert_dicts_equal(a, b, "stack metrics")
    for k, (a, b) in enumerate(zip(sl, sb)):
        assert_states_equal(a, b, f"layer {k}")


def test_wrapper_epoch_through_buffers_equals_the_loop():
    """An HTM wrapper at B=1 (seeded as a user seeds it): two epochs of
    five patterns learning, then inference without winner cells; every
    output and `last_metrics` value, and the final state."""
    pats = np.random.RandomState(3).rand(5, 64) < 0.2

    def run():
        htm = pnet.HierarchicalTemporalMemory(seed=4, device="cpu",
                                              **SMALL)
        outs = []
        for t in range(15):
            learning = t < 10
            sp, tm = htm.process(pats[t % 5], learning, learning)
            outs.append((sp, tm, dict(htm.last_metrics)))
        return htm.state, outs

    (sl, ol), (sb, ob) = _both(run)
    assert_states_equal(sl, sb, "wrapper state")
    for (spl, tml, mtl), (spb, tmb, mtb) in zip(ol, ob):
        assert mtl == mtb
        for a, b in ((spl, spb), (tml, tmb)):
            for name, v in a._asdict().items():
                w = getattr(b, name)
                if isinstance(v, dict):
                    assert_dicts_equal(v, w, name)
                else:
                    assert (v is None and w is None) or torch.equal(v, w), \
                        name


def test_wrapper_outputs_survive_the_next_step():
    """The outputs `process` returns are copies: the next step, which
    writes the runner's output block again, leaves them as they were."""
    htm = pnet.HierarchicalTemporalMemory(device="cpu", **SMALL)
    pats = np.random.RandomState(0).rand(2, 64) < 0.2
    with graph.runner_eager():
        _, tm0 = htm.process(pats[0])
        kept = tm0.active_mask.clone()
        htm.process(pats[1])
    assert torch.equal(tm0.active_mask, kept)


def test_host_tm_runs_the_loop():
    """`HostTemporalMemory` calls the host each step, so it is not
    capturable: a wrapper holding it runs the loop, never the runner."""
    assert bt.HostTemporalMemory.capturable is False
    x = torch.zeros(1, 64, dtype=torch.bool)
    hook = bt.HostTemporalMemory(lambda cols, learning: (0, 0, 0))
    with graph.runner_eager():
        assert graph.replays(x)
        assert not graph.replays(x, hooks=(None, hook))
    with graph.eager():
        assert not graph.replays(x)
    assert not graph.replays(x)  # the CPU runs the loop by default


def test_draw_providers_declare_capture():
    """Only a provider that draws on the card is captured on the card:
    `TorchDraws` says so; a provider that does not runs the loop."""
    cfg = bt.make_htm_config(**SMALL)
    d = bt.TorchDraws(cfg.tm, 2, "cpu")
    assert d.capturable and d.graph_key() == (cfg.tm, 2, d.device, None)
    assert not getattr(th.ReplayDraws(cfg.tm, None), "capturable", False)


# ---- donation, lineages and the write-back ------------------------------


def _toy_step(state, x, consts, draws):
    """A step whose new leaves alias the old ones crosswise: (a, b) ->
    (b, a + x), and b's new value is a view of a's buffer."""
    a, b = state
    return (b, a + x), {"sum": a.sum(-1)}


def test_write_back_of_crossed_leaves():
    """A new leaf that is another leaf's buffer is copied before that
    buffer is overwritten: (a, b) -> (b, a + x) over four steps, through
    two input blocks, equals the plain recurrence."""
    a0 = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    b0 = -a0
    xs = torch.ones(4, 2, 3)
    old_rows = graph.ROWS
    graph.ROWS = 3
    try:
        (a, b), out = graph.scan(("toy",), _toy_step, (a0.clone(),
                                                       b0.clone()), xs)
    finally:
        graph.ROWS = old_rows
    pa, pb, sums = a0, b0, []
    for x in xs:
        sums.append(pa.sum(-1))
        pa, pb = pb, pa + x
    assert torch.equal(a, pa) and torch.equal(b, pb)
    assert torch.equal(out["sum"], torch.stack(sums))


def test_write_back_skips_the_buffer_and_clones_overlaps():
    bufs = [torch.arange(8.0), torch.zeros(8)]
    new = [bufs[0], bufs[0].flip(0)]     # itself; a view of buffer 0
    graph._write_back(bufs, new)
    assert torch.equal(bufs[1], torch.arange(8.0).flip(0))
    shifted = torch.arange(9.0)
    bufs = [shifted[:8].clone(), torch.zeros(3)]
    storage = torch.arange(9.0)
    bufs[0] = storage[:8]
    graph._write_back(bufs, [storage[1:9], torch.ones(3)])
    assert torch.equal(bufs[0], torch.arange(1.0, 9.0))
    with pytest.raises(ValueError, match="changed a state leaf"):
        graph._write_back([torch.zeros(3)], [torch.zeros(4)])


def test_donation_copies_nothing_for_a_returned_state(monkeypatch):
    """The first call copies the state into new buffers; passing the
    returned state back copies no leaf in and returns the same buffers;
    a replaced leaf is the one copy; the lineage is freed with the
    state last returned."""
    cfg = bt.make_htm_config(**SMALL)
    x = sequence(6, 2, 1)
    gen = torch.Generator().manual_seed(0)
    state = bt.htm_init_batch(cfg, 2, gen, "cpu")
    draws = bt.TorchDraws(cfg.tm, 2, "cpu", gen)
    copies = []
    real = graph._write_back

    def counting(bufs, new):
        copies.append(sum(not graph._is(n, b) for b, n in zip(bufs, new)))
        real(bufs, new)

    n0 = len(graph._LINEAGES)
    with graph.runner_eager():
        s1, _ = bt.htm_scan(cfg, state, x[:3], True, draws=draws)
        assert len(graph._LINEAGES) == n0 + 1
        ptrs = [t.data_ptr() for t in leaves(s1).values()]
        monkeypatch.setattr(graph, "_write_back", counting)
        s2, _ = bt.htm_scan(cfg, s1, x[3:4], True, draws=draws)
        assert copies[0] == 0, "the returned state was copied in"
        assert [t.data_ptr() for t in leaves(s2).values()] == ptrs
        copies.clear()
        s3 = bt.HTMState(sp=s2.sp, tm=dataclasses.replace(
            s2.tm, step=s2.tm.step.clone()))
        s3, _ = bt.htm_scan(cfg, s3, x[4:5], True, draws=draws)
        assert copies[0] == 1, "one replaced leaf, one copy"
        assert len(graph._LINEAGES) == n0 + 1
    del s1, s2, s3
    assert len(graph._LINEAGES) == n0


def test_another_state_never_overwrites_a_returned_one():
    """Two states of the same shapes run through the same step keep
    separate buffers: the state returned first keeps its values while
    the second runs, and each equals its own loop run."""
    cfg = bt.make_htm_config(**SMALL)
    x = sequence(8, 2, 2)

    def init(seed):
        gen = torch.Generator().manual_seed(seed)
        return (bt.htm_init_batch(cfg, 2, gen, "cpu"),
                bt.TorchDraws(cfg.tm, 2, "cpu", gen))

    with graph.runner_eager():
        sa, da = init(1)
        sa, _ = bt.htm_scan(cfg, sa, x, True, draws=da)
        kept = {k: v.clone() for k, v in leaves(sa).items()}
        sb, db = init(2)
        sb, _ = bt.htm_scan(cfg, sb, x, True, draws=db)
    for k, v in leaves(sa).items():
        assert torch.equal(v, kept[k]), k
    with graph.eager():
        la, dla = init(1)
        la, _ = bt.htm_scan(cfg, la, x, True, draws=dla)
    assert_states_equal(sa, la, "first lineage")


def test_warm_up_consumes_no_draw():
    """A graph's first call warms the step up on a scratch copy and
    restores the generator: its first step draws what the loop's first
    step draws."""
    cfg = bt.make_htm_config(**SMALL)
    x = sequence(1, 2, 5)

    def run():
        gen = torch.Generator().manual_seed(6)
        state = bt.htm_init_batch(cfg, 2, gen, "cpu")
        s, m = bt.htm_scan(cfg, state, x, True,
                           draws=bt.TorchDraws(cfg.tm, 2, "cpu", gen))
        return s, m, gen.get_state()

    (sl, ml, gl), (sb, mb, gb) = _both(run)
    assert_states_equal(sl, sb, "one step")
    assert_dicts_equal(ml, mb, "one step")
    assert torch.equal(gl, gb)


# ---- tests/test_htm.py, for the port through the runner -----------------


class PerStreamDraws:
    """Draws of each stream from a generator of its own, so that a
    stream draws the same alone and in a batch."""

    def __init__(self, tm_cfg, gens):
        self.inner = [bt.TorchDraws(tm_cfg, 1, "cpu", g) for g in gens]

    def get_state(self):
        return [d.get_state() for d in self.inner]

    def set_state(self, states):
        for d, s in zip(self.inner, states):
            d.set_state(s)

    def step(self, need=True):
        got = [d.step(need) for d in self.inner]
        if not need:
            return None
        return bt.Draws(*(torch.cat(parts) for parts in zip(*got)))


def test_scan_equals_python_loop():
    """The runner's scan equals a Python loop of `htm_step` (the JAX
    test's jitted step) in the bursting metric and every TM leaf."""
    cfg = bt.make_htm_config(**SMALL)
    seq = torch.from_numpy(np.random.RandomState(1).rand(12, 1, 64) < 0.2)

    def init():
        gen = torch.Generator().manual_seed(7)
        return (bt.htm_init(cfg, gen, "cpu"),
                bt.TorchDraws(cfg.tm, 1, "cpu", gen))

    state_a, draws = init()
    loop = []
    for x in seq:
        state_a, out = bt.htm_step(cfg, state_a, x, True, draws=draws)
        loop.append(out.metrics["bursting"])
    state_b, draws = init()
    with graph.runner_eager():
        state_b, metrics = bt.htm_scan(cfg, state_b, seq, True, draws=draws)
    assert torch.equal(metrics["bursting"], torch.stack(loop))
    assert_states_equal(state_a, state_b, "scan vs loop")


def test_batched_streams_are_independent():
    """Stream 1 of a batched run through the runner equals a solo run of
    that stream from its own state and draws."""
    cfg = bt.make_htm_config(**SMALL)
    B = 3
    gens = [torch.Generator().manual_seed(40 + b) for b in range(B)]
    batch = bt.htm_init_batch(cfg, B, torch.Generator().manual_seed(42),
                              "cpu")
    solo = bt.HTMState(*(type(p)(**{k: v[1:2].clone() for k, v in
                                    vars(p).items()})
                         for p in (batch.sp, batch.tm)))
    seq = torch.from_numpy(np.random.RandomState(2).rand(8, B, 64) < 0.2)
    solo_gen = torch.Generator().manual_seed(41)
    with graph.runner_eager():
        final_batch, _ = bt.htm_scan(cfg, batch, seq, True,
                                     draws=PerStreamDraws(cfg.tm, gens))
        final_solo, _ = bt.htm_scan(cfg, solo, seq[:, 1:2], True,
                                    draws=PerStreamDraws(cfg.tm,
                                                         [solo_gen]))
    for k, v in leaves(final_solo).items():
        assert torch.equal(leaves(final_batch)[k][1:2], v), k


def test_learning_converges():
    """Bursting falls and correct predictions rise on a repeated
    sequence, through the wrapper's B=1 step on the runner."""
    htm = pnet.HierarchicalTemporalMemory(device="cpu", **SMALL)
    pats = np.random.RandomState(0).rand(6, 64) < 0.2
    epochs = []
    with graph.runner_eager():
        for _ in range(10):
            burst = correct = 0
            for p in pats:
                htm.process(p)
                burst += htm.last_metrics["bursting"]
                correct += htm.last_metrics["correct"]
            epochs.append((burst, correct))
    assert epochs[-1][0] < epochs[0][0], "bursting should fall"
    assert epochs[-1][1] > epochs[0][1], "corrects should rise"
    assert epochs[-1][1] >= 3 * len(pats)
