"""The port's mesh on the CPU against the JAX package's: the sharded
learning and serving steps of `bithtm_tpu_torch.parallel.mesh`, run by
gloo worker processes (tests/test_torch_multiprocess.py run as a
script, one process a rank, no JAX), equal JAX's `sharded_step` /
`sharded_serve_step` on the conftest's 8 virtual devices in every leaf
(the shards gathered) and every metric of every rank, bit for bit.
The mirror of tests/test_parallel.py; the port's draws are the JAX
keys' draws, replayed (`ReplayDraws`) into an npz that the workers
read.

Also the column-shard seam of the table pass: the plain versions on a
shard of the rows with the global ``column_dim`` equal the whole table's
result at those rows.
"""

import dataclasses
import socket

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from bithtm_tpu import htm_init_batch as jax_htm_init_batch
from bithtm_tpu import make_htm_config as jax_make_htm_config
from bithtm_tpu.models.htm import htm_scan as jax_htm_scan
from bithtm_tpu.parallel import mesh as jmesh

import bithtm_tpu_torch as bt
from bithtm_tpu_torch.ops import active_set as pas
from bithtm_tpu_torch.ops.shard import ColumnShard
from bithtm_tpu_torch.parallel import distributed as pdist
from bithtm_tpu_torch.parallel import mesh as pmesh
from bithtm_tpu_torch.parallel.distributed import local_batch_slice
from bithtm_tpu_torch.state import SPState, TMState
from bithtm_tpu_torch.testing import table_inputs

from .test_torch_htm import ReplayDraws, copy_keys
from .test_torch_multiprocess import assert_run_equal, run_job, save_tree

SMALL = dict(input_dim=64, column_dim=64, cell_dim=4, active_columns=4,
             segment_activation_threshold=2, segment_matching_threshold=2,
             segment_sampling_synapses=8)
# the multiword fast-stack geometry of test_parallel.py (D=64: W=2)
MULTIWORD = dict(input_dim=128, column_dim=512, cell_dim=64,
                 active_columns=10, segments_per_column=4,
                 synapse_capacity=64, segment_activation_threshold=3,
                 segment_matching_threshold=3, segment_sampling_synapses=8,
                 sp_overrides={"permanence_dtype": "int16"})
TIMEOUT = 120  # seconds a group of workers may take


def _tree(state) -> dict:
    """A JAX state's leaves as numpy, under the port's part/leaf names."""
    host = jax.device_get(state)
    return {part: {f.name: np.asarray(getattr(getattr(host, part), f.name))
                   for f in dataclasses.fields(cls)}
            for part, cls in (("sp", SPState), ("tm", TMState))}


def _jax_run(cfg, kw, mesh_shape, state, learn, serve, tmp, name):
    """JAX's sharded steps over ``learn`` then ``serve`` (T, B, I) inputs
    on a mesh of ``mesh_shape`` over the first virtual devices; writes the
    port run's files (the starting state, the replayed draws, the inputs)
    and returns (its spec, the final JAX tree, the JAX metrics)."""
    n = mesh_shape[0] * mesh_shape[1]
    mesh = jmesh.make_mesh(*mesh_shape, devices=jax.devices()[:n])
    save_tree(tmp / f"{name}_state.npz", _tree(state))
    replay = ReplayDraws(cfg.tm, copy_keys(state.key))
    draws = [replay.step() for _ in learn]
    if draws:
        np.savez(tmp / f"{name}_draws.npz",
                 **{k: np.stack([getattr(d, k).numpy() for d in draws])
                    for k in ("u_seg", "u_least", "rnd")})
    np.savez(tmp / f"{name}_inputs.npz", learn=learn, serve=serve)
    sharded = jmesh.shard_batched_state(state, mesh)
    metrics = {"learn": [], "serve": []}
    for phase, xs, step in (
            ("learn", learn, jmesh.sharded_step(cfg, mesh, learning=True)),
            ("serve", serve, jmesh.sharded_serve_step(cfg, mesh))):
        for x in xs:
            sharded, m = step(sharded, jnp.asarray(x))
            metrics[phase].append(jax.device_get(m))
    spec = dict(name=name, mesh=list(mesh_shape), config=kw,
                state=str(tmp / f"{name}_state.npz"),
                inputs=str(tmp / f"{name}_inputs.npz"),
                out=str(tmp / name))
    if draws:
        spec["draws"] = str(tmp / f"{name}_draws.npz")
    return spec, _tree(sharded), metrics


@pytest.fixture(scope="module")
def mesh_2x2(tmp_path_factory):
    """The three 2 data x 2 model cases of test_parallel.py, run by one
    group of four workers: the sharded step (B=4, 6 steps), the carry
    layout (B=8, 3 steps) and serving after 10 learning steps (B=4, 5
    steps)."""
    tmp = tmp_path_factory.mktemp("mesh_2x2")
    cfg = jax_make_htm_config(**SMALL)
    I = cfg.input_dim
    rng = np.random.RandomState(0)
    learn = np.stack([rng.rand(4, I) < 0.2 for _ in range(6)])
    cases = {"step": _jax_run(cfg, SMALL, (2, 2),
                              jax_htm_init_batch(jax.random.key(0), cfg, 4),
                              learn, learn[:0], tmp, "step")}
    rng = np.random.RandomState(1)
    learn = np.stack([rng.rand(8, I) < 0.2 for _ in range(3)])
    cases["layout"] = _jax_run(cfg, SMALL, (2, 2),
                               jax_htm_init_batch(jax.random.key(1), cfg, 8),
                               learn, learn[:0], tmp, "layout")
    cases["layout"][0]["layout_stable"] = True
    rng = np.random.RandomState(7)
    train = jnp.asarray(rng.rand(10, 4, I) < 0.2)
    serve = np.stack([rng.rand(4, I) < 0.2 for _ in range(5)])
    trained, _ = jax_htm_scan(
        cfg, jax_htm_init_batch(jax.random.key(6), cfg, 4), train, True)
    cases["serve"] = _jax_run(cfg, SMALL, (2, 2), trained, serve[:0], serve,
                              tmp, "serve")
    run_job([c[0] for c in cases.values()], 4, str(tmp), TIMEOUT)
    return cases


@pytest.fixture(scope="module")
def mesh_1x4(tmp_path_factory):
    """The multiword case on a 1 data x 4 model mesh: 128 columns a
    rank, B=2, 4 steps."""
    tmp = tmp_path_factory.mktemp("mesh_1x4")
    cfg = jax_make_htm_config(**MULTIWORD)
    rng = np.random.RandomState(2)
    learn = np.stack([rng.rand(2, cfg.input_dim) < 0.2 for _ in range(4)])
    case = _jax_run(cfg, MULTIWORD, (1, 4),
                    jax_htm_init_batch(jax.random.key(3), cfg, 2), learn,
                    learn[:0], tmp, "multiword")
    run_job([case[0]], 4, str(tmp), TIMEOUT)
    return case


def test_sharded_step_matches_jax(mesh_2x2):
    """2 data x 2 model, B=4: six learning steps == JAX's sharded step."""
    assert_run_equal(*mesh_2x2["step"])


def test_model_parallel_multiword_matches_jax(mesh_1x4):
    """1 x 4 model ranks at 512 x 64 (two cell words, the fast stack,
    int16 SP): four learning steps == JAX's sharded step."""
    assert_run_equal(*mesh_1x4)


def test_sharded_carry_layout_stable(mesh_2x2):
    """2 x 2, B=8: each step's output shard feeds the next with the
    layout it came in (the worker checks every leaf's shape), and three
    steps == JAX's."""
    spec, tree, metrics = mesh_2x2["layout"]
    assert spec["layout_stable"]
    assert_run_equal(spec, tree, metrics)
    burst = np.stack([m["bursting"] for m in metrics["learn"]])
    assert burst.shape == (3, 8) and (burst >= 0).all()


def test_local_batch_slice_single_process():
    s = local_batch_slice(32)
    assert (s.start, s.stop) == (0, 32)  # no process group: every stream


def test_sharded_serve_matches_jax(mesh_2x2):
    """Model-parallel serving (learning and the winner pass off) on 2 x 2
    after 10 JAX learning steps: five steps == JAX's sharded serve
    step."""
    assert_run_equal(*mesh_2x2["serve"])


@pytest.mark.parametrize("detailed_metrics", [True, False])
def test_one_rank_column_shard_matches_unsharded(detailed_metrics):
    """`htm_step` through the column shard of a one-rank gloo group
    (every exchange and the sum of the column counts run as collectives)
    == the unsharded step in every leaf and metric, bit for bit: four
    learning then two serving steps, with and without the detailed
    metrics."""
    cfg = bt.make_htm_config(**SMALL)
    B = 3
    xs = torch.from_numpy(
        np.random.RandomState(4).rand(6, B, cfg.input_dim) < 0.2)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    pdist.initialize(f"localhost:{port}", 1, 0, backend="gloo",
                     device="cpu", timeout=60)
    try:
        shard = ColumnShard(dist.group.WORLD, 0, 1, cfg.tm.column_dim)
        runs = []
        for sh in (None, shard):
            state = bt.htm_init_batch(cfg, B, torch.Generator().manual_seed(
                0), "cpu")
            draws = bt.TorchDraws(cfg.tm, B, "cpu",
                                  torch.Generator().manual_seed(1))
            metrics = []
            for t, x in enumerate(xs):
                state, out = bt.htm_step(
                    cfg, state, x, t < 4, t < 4, draws=draws,
                    detailed_metrics=detailed_metrics, dense_outputs=False,
                    shard=sh)
                metrics.append(out.metrics)
            runs.append((pmesh.state_leaves(state), metrics))
    finally:
        dist.destroy_process_group()
    (want, want_m), (got, got_m) = runs
    # a step: the boosted overlaps, the active rows and one sum
    assert sum(shard.traffic.values()) == 3 * len(xs)
    for k, v in want.items():
        assert torch.equal(got[k].view(torch.uint8), v.view(torch.uint8)), k
    for t, (a, b) in enumerate(zip(got_m, want_m)):
        assert a.keys() == b.keys()
        for k in b:
            assert torch.equal(a[k], b[k]), (t, k)
    assert ("tm_predicted_cells" in want_m[0]) == detailed_metrics


SHARD_SHAPES = [  # B, C, G, K, D, A
    (2, 64, 4, 64, 32, 5),
    (3, 40, 8, 48, 4, 6),
]


@pytest.mark.parametrize("shape", SHARD_SHAPES)
def test_plain_table_update_on_a_column_shard(shape):
    """`table_update_ref` on the rows [C/4, C/2) with ``column_dim`` C ==
    the whole table's activity and punished permanences at those rows,
    though most presynaptic cells lie in the other rows."""
    B, C, G, K, D, A = shape
    x = table_inputs(sum(shape) + 1, *shape)
    rows = slice(C // 4, C // 2)
    p_full = x["perm"].clone()
    v_full = pas.table_update_ref(x["syn"], p_full, x["act_prev"].clone(),
                                  x["pun_word"], x["cols"], x["bits"], D, K,
                                  0.01, 0.5)
    syn = x["syn"][:, rows].contiguous()
    perm = x["perm"][:, rows].clone()
    v = pas.table_update_ref(syn, perm, x["act_prev"][:, rows],
                             x["pun_word"][:, rows], x["cols"], x["bits"], D,
                             K, 0.01, 0.5, column_dim=C)
    assert torch.equal(v, v_full[:, rows])
    assert torch.equal(perm.view(torch.int32),
                       p_full[:, rows].contiguous().view(torch.int32))
    elsewhere = (syn >= 0) & ((syn < rows.start * D) | (syn >= rows.stop * D))
    assert (elsewhere & (v > 0)).any()


@pytest.mark.parametrize("shape", SHARD_SHAPES)
def test_plain_act_conn_on_a_column_shard(shape):
    """`synapse_activation_conn_ref` on the rows [C/4, C/2) with
    ``column_dim`` C == the whole table's activity at those rows."""
    B, C, G, K, D, A = shape
    x = table_inputs(sum(shape) + 2, *shape)
    rows = slice(C // 4, C // 2)
    full = pas.synapse_activation_conn_ref(x["syn"], x["perm"], x["cols"],
                                           x["bits"], D, 0.5, K)
    got = pas.synapse_activation_conn(
        x["syn"][:, rows].contiguous(), x["perm"][:, rows].contiguous(),
        x["cols"], x["bits"], D, 0.5, K, column_dim=C)
    assert torch.equal(got, full[:, rows])
    assert (got > 1).any()
