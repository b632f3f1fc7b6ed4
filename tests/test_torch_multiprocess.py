"""Multi-process drills of the port's mesh on the CPU, the mirror of
tests/test_multiprocess.py. A rank here is one process (this file run
as a script, below; gloo), so JAX's processes of two virtual
devices each are two ranks each: JAX's 2 processes x 2 devices are 4
ranks, its 4 x 2 are 8. Every drill is held to an uninterrupted
single-process run of the port with the same global draws (a CPU
generator from one seed: each rank draws the whole batch and keeps its
rows), bit for bit in every leaf and metric:

  * data parallel over 4 ranks, then a 2 data x 2 model mesh (each
    model pair across two processes);
  * elastic recovery: two ranks checkpoint their shards and generators
    at step 3, are SIGKILLed while stepping on, and fresh processes on a
    fresh mesh restore and continue to step 5;
  * the wide drill: the same over 8 ranks, then a 2 data x 4 model mesh
    learning and serving.

The ranks are this file run as a script:

    python tests/test_torch_multiprocess.py JOB.json RANK PORT

It joins a gloo process group of the job's ranks at localhost:PORT and
runs the job's runs in order. A run names a mesh, a config
(`make_htm_config` keywords), a full starting state (an npz of its
leaves, or the port's initial state from a seed), the draws of the
global batch (an npz of one array a draw over the steps, or a generator
seed), the inputs of the global batch (an npz: ``learn`` and ``serve``
steps) and a device; it may restore this rank's shard and generator
from a checkpoint, save them after some learning steps (then, with
``loop``, step on until killed), and saves this rank's final shard and
its learning and serving metrics to ``<out>_rank<r>.npz``. A rank
imports no JAX: tests/test_torch_parallel.py drives the same workers
and compares with the JAX package in its own process, and
tests/test_torch_cuda.py runs them on the card.
"""

import json
import os
import socket
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import bithtm_tpu_torch as bt  # noqa: E402
from bithtm_tpu_torch.convert import (htm_state_from_numpy,  # noqa: E402
                                      htm_state_to_numpy)
from bithtm_tpu_torch.parallel import distributed as pdist  # noqa: E402
from bithtm_tpu_torch.parallel import mesh as pmesh  # noqa: E402
from bithtm_tpu_torch.rng import Draws  # noqa: E402
from bithtm_tpu_torch.testing import run_ranks  # noqa: E402
from bithtm_tpu_torch.utils import checkpoint  # noqa: E402

WORKER = os.path.abspath(__file__)


def load_tree(path: str) -> dict:
    """An npz of "part/leaf" arrays -> {"sp": {...}, "tm": {...}, ...}
    (a run's metrics under "learn" and "serve", (T, B) a metric)."""
    tree = {}
    with np.load(path) as data:
        for key in data.files:
            part, name = key.split("/")
            tree.setdefault(part, {})[name] = data[key]
    return tree


def save_tree(path: str, tree: dict, **extra) -> None:
    np.savez(path, **{f"{part}/{name}": arr for part, sub in tree.items()
                      for name, arr in sub.items()}, **extra)


class NpzDraws:
    """Replays recorded draws of the global batch, one step a call."""

    def __init__(self, data: dict, t: int = 0):
        self.data, self.t = data, t

    def with_config(self, cfg):
        return self

    def get_state(self):
        return self.t

    def set_state(self, t) -> None:
        self.t = t

    def step(self, need: bool = True):
        if not need:
            return None
        d = Draws(*(torch.from_numpy(self.data[k][self.t])
                    for k in ("u_seg", "u_least", "rnd")))
        self.t += 1
        return d


def run(spec: dict, rank: int) -> None:
    dev = torch.device(spec.get("device", "cpu"))
    mesh = pmesh.make_mesh(*spec["mesh"], device=dev)
    cfg = bt.make_htm_config(**spec["config"])
    if "state" in spec:
        full = htm_state_from_numpy(load_tree(spec["state"]), "cpu")
    else:
        full = bt.htm_init_batch(cfg, spec["batch"], torch.Generator(
            ).manual_seed(spec["init_seed"]), "cpu")
    B = full.batch
    state = pmesh.shard_batched_state(full, mesh)
    del full
    gen = draws = None  # a serving run draws nothing
    if "draws" in spec:
        with np.load(spec["draws"]) as data:
            draws = NpzDraws({k: data[k] for k in data.files},
                             spec.get("start", 0))
    elif "draw_seed" in spec:
        gen = torch.Generator(device=dev).manual_seed(spec["draw_seed"])
        draws = bt.TorchDraws(cfg.tm, B, dev, gen)
    if "restore" in spec:
        state = checkpoint.restore(
            os.path.join(spec["restore"], f"rank{rank}"), state, gen)
    rows = pdist.local_data_slice(B, mesh)
    with np.load(spec["inputs"]) as data:
        learn = torch.from_numpy(data["learn"][:, rows]).to(dev)
        serve = (torch.from_numpy(data["serve"][:, rows]).to(dev)
                 if "serve" in data.files else learn[:0])
    learn_step = pmesh.sharded_step(cfg, mesh, True, draws)
    serve_step = pmesh.sharded_serve_step(cfg, mesh)
    shapes = {(part, k): v.shape for part, sub in
              htm_state_to_numpy(state).items() for k, v in sub.items()}
    metrics = {"learn": [], "serve": []}
    save = spec.get("checkpoint")
    t = spec.get("start", 0)
    while t < len(learn):
        state, m = learn_step(state, learn[t])
        metrics["learn"].append(m)
        t += 1
        if save is not None and t == save["after"]:
            checkpoint.save(os.path.join(save["dir"], f"rank{rank}"), state,
                            gen)
            print("CKPT_SAVED", flush=True)
            if save.get("loop"):  # work on until the test kills us
                while True:
                    state, _ = learn_step(state, learn[t % len(learn)])
                    t += 1
    for x in serve:
        state, m = serve_step(state, x)
        metrics["serve"].append(m)
    tree = htm_state_to_numpy(state)
    if spec.get("layout_stable"):  # the carry's layout out == in
        got = {(part, k): v.shape for part, sub in tree.items()
               for k, v in sub.items()}
        if got != shapes:
            raise RuntimeError(f"the carry's layout changed: {shapes} -> "
                               f"{got}")
    save_tree(f"{spec['out']}_rank{rank}.npz", tree, **{
        f"{phase}/{k}": torch.stack([m[k] for m in ms]).cpu().numpy()
        for phase, ms in metrics.items() for k in (ms[0] if ms else {})})
    print(f"RUN_DONE {spec['name']} rank={rank}", flush=True)


def run_job(runs: list[dict], world: int, tmp_dir: str,
            timeout: float = 120.0, until=None) -> tuple[list, list[str]]:
    """Runs ``world`` ranks of this script over ``runs`` (`run_ranks`:
    every process killed at the deadline, at the first failure or once
    ``until(outputs)`` holds), on a free port, and once more if that
    attempt fails (the port may be taken between its choice and its
    use). Returns (return codes, outputs) of the attempt that did not
    fail; raises with the outputs' ends if both failed."""
    for _ in range(2):
        work = tempfile.mkdtemp(dir=tmp_dir)
        path = os.path.join(work, "job.json")
        with open(path, "w") as f:
            json.dump({"world": world, "runs": runs, "timeout": timeout}, f)
        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        rcs, outs = run_ranks(
            [[sys.executable, WORKER, path, str(r), str(port)]
             for r in range(world)], work, timeout, until)
        if (until is not None and until(outs)) or all(rc == 0 for rc in rcs):
            return rcs, outs
    raise AssertionError(f"ranks exited with {rcs}:\n" + "\n---\n".join(
        out[-2000:] for out in outs))


def _bits(a) -> np.ndarray:
    return np.ascontiguousarray(a).view(np.uint8)


def assert_run_equal(spec: dict, want_tree: dict, want_metrics: dict
                     ) -> None:
    """Every leaf of a run's gathered shards == ``want_tree`` (numpy
    leaves in the JAX package's dtypes) and every metric of every rank ==
    ``want_metrics`` ({"learn"/"serve": [{name: (B,) array}] a step}),
    bit for bit."""
    n_data, n_model = spec["mesh"]
    shards = [load_tree(f"{spec['out']}_rank{r}.npz")
              for r in range(n_data * n_model)]
    full = htm_state_to_numpy(pmesh.assemble_batched_state(
        [htm_state_from_numpy(s, "cpu") for s in shards], n_data, n_model))
    for part, sub in want_tree.items():
        for name, want in sub.items():
            got = full[part][name]
            assert got.dtype == want.dtype and got.shape == want.shape, name
            np.testing.assert_array_equal(_bits(got), _bits(want),
                                          err_msg=f"{part}.{name}")
    for phase, steps in want_metrics.items():
        for k in (steps[0] if steps else {}):
            want = np.stack([np.asarray(m[k]) for m in steps])
            for m in range(n_model):
                got = np.concatenate([shards[d * n_model + m][phase][k]
                                      for d in range(n_data)], axis=1)
                assert got.dtype == want.dtype, (phase, k)
                np.testing.assert_array_equal(
                    _bits(got), _bits(want),
                    err_msg=f"{phase} {k} model rank {m}")


def main() -> None:
    job_path, rank, port = sys.argv[1], int(sys.argv[2]), sys.argv[3]
    with open(job_path) as f:
        job = json.load(f)
    torch.set_num_threads(1)
    pdist.initialize(f"localhost:{port}", job["world"], rank,
                     backend="gloo", timeout=job.get("timeout", 120))
    try:
        for spec in job["runs"]:
            run(spec, rank)
    finally:
        torch.distributed.destroy_process_group()



CFG = dict(input_dim=64, column_dim=64, cell_dim=4, active_columns=4,
           segments_per_column=4, segment_activation_threshold=2,
           segment_matching_threshold=2, segment_sampling_synapses=8)
DRAW_SEED = 11
TIMEOUT = 120  # seconds a group of workers may take


def _inputs(path, B: int, learn: int, serve: int = 0, seed=None) -> str:
    """Global inputs: learning step t from RandomState(1000 + t) as in
    tests/test_multiprocess.py, or all steps from RandomState(seed)."""
    rng = None if seed is None else np.random.RandomState(seed)

    def one(t):
        r = rng if rng is not None else np.random.RandomState(1000 + t)
        return r.rand(B, CFG["input_dim"]) < 0.2

    xs = np.stack([one(t) for t in range(learn + serve)])
    np.savez(path, learn=xs[:learn], serve=xs[learn:])
    return str(path)


def _single_process(B: int, init_seed: int, inputs: str, steps=None):
    """The uninterrupted single-process port run of a job's inputs:
    (final tree, {"learn"/"serve": metrics a step})."""
    cfg = bt.make_htm_config(**CFG)
    state = bt.htm_init_batch(cfg, B, torch.Generator().manual_seed(
        init_seed), "cpu")
    draws = bt.TorchDraws(cfg.tm, B, "cpu",
                          torch.Generator().manual_seed(DRAW_SEED))
    metrics = {"learn": [], "serve": []}
    with np.load(inputs) as data:
        for phase, xs in (("learn", data["learn"][:steps]),
                          ("serve", data["serve"])):
            for x in xs:
                state, out = bt.htm_step(cfg, state, torch.from_numpy(x),
                                         phase == "learn",
                                         phase == "learn", draws=draws,
                                         dense_outputs=False)
                metrics[phase].append({k: v.numpy()
                                       for k, v in out.metrics.items()})
    return bt.htm_state_to_numpy(state), metrics


def _run(name, mesh, B, init_seed, inputs, tmp, **extra):
    return dict(name=name, mesh=mesh, config=CFG, batch=B,
                init_seed=init_seed, draw_seed=DRAW_SEED, inputs=inputs,
                out=str(tmp / name), **extra)


def _killed_after_checkpoint(runs, world, tmp):
    """Runs ``world`` ranks until every one has saved its checkpoint and
    stepped on for a second, then SIGKILLs them all (`run_job`'s
    ``until``): a real, uncoordinated failure in the middle of work."""
    seen = []

    def until(outs):
        if not all("CKPT_SAVED" in out for out in outs):
            return False
        seen.append(time.monotonic())
        return seen[-1] - seen[0] > 1.0

    rcs, _ = run_job(runs, world, str(tmp), TIMEOUT, until)
    assert all(rc is not None and rc < 0 for rc in rcs), rcs  # killed


def test_data_parallel_then_model_mesh(tmp_path):
    """4 data-parallel ranks feed their own streams (B=8, 3 steps), then
    the same ranks form a 2 x 2 mesh (B=4, 2 steps); both equal the
    single-process run."""
    dp = _run("dp", [4, 1], 8, 0, _inputs(tmp_path / "dp.npz", 8, 3),
              tmp_path)
    mp = _run("mp", [2, 2], 4, 1, _inputs(tmp_path / "mp.npz", 4, 2, seed=5),
              tmp_path)
    run_job([dp, mp], 4, str(tmp_path), TIMEOUT)
    assert_run_equal(dp, *_single_process(8, 0, dp["inputs"]))
    assert_run_equal(mp, *_single_process(4, 1, mp["inputs"]))


def _restart_drill(tmp_path, world: int, extra_runs=()):
    """Checkpoint at step 3, SIGKILL, restore into fresh processes on a
    fresh mesh, continue to step 5: equal to the uninterrupted run."""
    B = 2 * world
    ckpt = tmp_path / "ckpt"
    inputs = _inputs(tmp_path / "in.npz", B, 5)
    _killed_after_checkpoint(
        [_run("before", [world, 1], B, 0, inputs, tmp_path,
              checkpoint={"dir": str(ckpt), "after": 3, "loop": True})],
        world, tmp_path)
    resumed = _run("resumed", [world, 1], B, 0, inputs, tmp_path,
                   restore=str(ckpt), start=3)
    run_job([resumed, *extra_runs], world, str(tmp_path), TIMEOUT)
    tree, metrics = _single_process(B, 0, inputs)
    # the resumed run's metrics are those of steps 3 and 4
    assert_run_equal(resumed, tree, {"learn": metrics["learn"][3:],
                                     "serve": []})


def test_elastic_recovery_restart_resumes_bitexact(tmp_path):
    """Two data-parallel ranks (B=8): the restart drill."""
    _restart_drill(tmp_path, 2)


def test_wide_drill(tmp_path):
    """Eight data-parallel ranks (B=16): the restart drill; then the
    restored processes form a 2 data x 4 model mesh whose model axis
    spans four processes, and learn (2 steps) and serve (2 steps) equal
    to the single-process run."""
    wide = _run("wide", [2, 4], 4, 7,
                _inputs(tmp_path / "wide.npz", 4, 2, 2, seed=9), tmp_path)
    _restart_drill(tmp_path, 8, [wide])
    assert_run_equal(wide, *_single_process(4, 7, wide["inputs"]))


if __name__ == "__main__":
    main()
