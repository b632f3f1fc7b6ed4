"""The port's CLI (`python -m bithtm_tpu_torch.example`), checkpoints
and state checks.

The CLI runs as a user runs it, at `tests/test_cli.py`'s tiny sizes on
the CPU: with the port's oracle in lockstep, and as a batched scan with
a metrics log and a checkpoint that a second run resumes. Checkpoints
resume bit-identically and read the JAX package's npz checkpoints; the
state checks hold through a run and catch a broken state, as the JAX
package's do on the same streams.
"""

import json
import os
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bithtm_tpu as jb
from bithtm_tpu.utils import checkpoint as jax_checkpoint
from bithtm_tpu.utils import checks as jax_checks

import bithtm_tpu_torch as bt
from bithtm_tpu_torch.utils import checkpoint, checks
from bithtm_tpu_torch.utils.metrics_log import capacity_health, summarize

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TINY = ["--input_dim", "64", "--column_dim", "64", "--cell_dim", "4",
        "--activation_threshold", "2", "--matching_threshold", "2",
        "--sampling_synapses", "8", "--input_patterns", "3"]

SMALL = dict(input_dim=64, column_dim=64, cell_dim=4, active_columns=4,
             segment_activation_threshold=2, segment_matching_threshold=2,
             segment_sampling_synapses=8)


def run(args, timeout=300):
    r = subprocess.run(
        [sys.executable, "-m", "bithtm_tpu_torch.example", *args], cwd=REPO,
        capture_output=True, text=True, timeout=timeout)
    assert r.returncode == 0, (r.stdout[-2000:], r.stderr[-2000:])
    return r.stdout + r.stderr


def test_cli_oracle_differential():
    out = run(["--cpu", "--oracle", "--epochs", "3", *TINY])
    assert "verified bit-exact against the BAMI oracle" in out
    assert out.count("parity OK") == 9


def test_oracle_checked_run_goes_on_from_a_state():
    """`example.oracle_checked_run` from a learned state: the oracle built
    from it (`oracle_from_state`) judges every further step, learning
    (segments reinforced, not only grown) and inference."""
    from bithtm_tpu_torch import example

    cfg = bt.make_htm_config(**SMALL)
    gen = torch.Generator().manual_seed(6)
    rng = np.random.RandomState(6)
    xs = example.noisy_inputs(rng, rng.rand(3, 64) < 0.2, 8, 0.05)
    state, _ = bt.htm_scan(cfg, bt.htm_init(cfg, gen, "cpu"),
                           torch.from_numpy(xs[:15, None]), True,
                           draws=bt.TorchDraws(cfg.tm, 1, "cpu", gen))
    sums = {}

    def add(t, tm_out):
        for k, v in tm_out.metrics.items():
            sums[k] = sums.get(k, 0) + int(v.sum())

    res = example.oracle_checked_run(cfg, xs[15:], [True] * 6 + [False] * 3,
                                     7, "cpu", add, state=state)
    assert res["steps"] == 9
    assert sums["tm_learning_segments"] > sums["tm_new_segments"], sums
    assert sums["tm_predicted_cells"] > 0, sums


def test_cli_scan_batch_log_checkpoint_resume(tmp_path):
    log, ckpt = tmp_path / "metrics.jsonl", tmp_path / "ckpt"
    out = run(["--cpu", "--scan", "--batch", "2", "--epochs", "2", *TINY,
               "--log", str(log), "--checkpoint", str(ckpt), "--quiet"])
    assert "timesteps/s" in out and "saved checkpoint" in out
    lines = [json.loads(line) for line in log.read_text().splitlines()]
    assert lines[0]["event"] == "config"
    steps = [line for line in lines if "bursting" in line]
    assert len(steps) == 2 and all(line["bursting"] >= 0 for line in steps)
    assert [line["status"] for line in lines
            if line.get("event") == "capacity"] == ["ok", "ok"]
    assert os.path.exists(ckpt / "state.npz")
    out = run(["--cpu", "--batch", "2", "--epochs", "1", *TINY,
               "--checkpoint", str(ckpt)])
    assert f"resumed from {ckpt}" in out
    assert out.count("bursting columns") == 3


def test_cli_needs_a_gpu_without_cpu_flag():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    r = subprocess.run([sys.executable, "-m", "bithtm_tpu_torch.example",
                        "--epochs", "1", *TINY], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0 and "pass --cpu" in r.stderr
    assert "timesteps/s" not in r.stdout


def _scan(cfg, state, xs, gen):
    return bt.htm_scan(cfg, state, torch.from_numpy(xs), True,
                       draws=bt.TorchDraws(cfg.tm, state.batch, "cpu", gen))


@pytest.mark.parametrize("batch", [1, 3])
def test_checkpoint_resumes_bit_identically(tmp_path, batch):
    """Save mid-stream with the generator, restore into a fresh state and
    generator: the next steps equal the uninterrupted run's in every
    leaf and metric."""
    cfg = bt.make_htm_config(**SMALL)
    rng = np.random.RandomState(0)
    seq = rng.rand(20, batch, 64) < 0.2
    gen = torch.Generator().manual_seed(1)
    state, _ = _scan(cfg, bt.htm_init_batch(cfg, batch, gen, "cpu"),
                     seq[:10], gen)
    checkpoint.save(str(tmp_path), state, generator=gen)
    fresh = torch.Generator().manual_seed(99)
    restored = checkpoint.restore(
        str(tmp_path), bt.htm_init_batch(cfg, batch, fresh, "cpu"),
        generator=fresh)
    checks.assert_trees_bit_equal(restored, state)
    a, ma = _scan(cfg, state, seq[10:], gen)
    b, mb = _scan(cfg, restored, seq[10:], fresh)
    checks.assert_trees_bit_equal(b, a, mb, ma)
    with pytest.raises(FileNotFoundError):
        checkpoint.restore(str(tmp_path / "none"), a)


@pytest.mark.parametrize("batched", [False, True])
def test_jax_npz_checkpoint_restores_into_the_port(tmp_path, batched):
    """A checkpoint of the JAX package's npz backend (single stream or a
    batch) restores into the port equal to the converted state, leaf
    for leaf; the JAX key is ignored. The port's checkpoint uses the
    same leaf names and dtypes."""
    jcfg, pcfg = jb.make_htm_config(**SMALL), bt.make_htm_config(**SMALL)
    seq = np.random.RandomState(3).rand(8, 64) < 0.2
    if batched:
        jstate = jb.htm_init_batch(jax.random.key(2), jcfg, 2)
        seq = np.stack([seq, ~seq], 1)
    else:
        jstate = jb.htm_init(jax.random.key(2), jcfg)
    jstate, _ = jb.htm_scan(jcfg, jstate, jnp.asarray(seq), True)
    jax_checkpoint.save(str(tmp_path / "jax"), jstate, backend="npz")
    like = bt.htm_init_batch(pcfg, 2 if batched else 1, torch.Generator(),
                             "cpu")
    got = checkpoint.restore(str(tmp_path / "jax"), like)
    checks.assert_trees_bit_equal(got, bt.htm_state_from_numpy(jstate,
                                                              "cpu"))
    checkpoint.save(str(tmp_path / "port"), got)
    ours = np.load(tmp_path / "port" / "state.npz")
    theirs = np.load(tmp_path / "jax" / "state.npz")
    assert set(theirs.files) - set(ours.files) == {"key"}
    for k in ours.files:
        want = theirs[k] if batched else theirs[k][None]
        assert ours[k].dtype == want.dtype, k
        np.testing.assert_array_equal(ours[k], want, err_msg=k)


def test_state_checks_through_a_run():
    """`validate_state` passes every stream through learning and
    inference, as the JAX package's checks pass the same streams, and
    names what a broken state breaks."""
    cfg = bt.make_htm_config(**SMALL, segments_per_column=2)
    gen = torch.Generator().manual_seed(4)
    state = bt.htm_init_batch(cfg, 2, gen, "cpu")
    seq = np.random.RandomState(4).rand(40, 2, 64) < 0.2
    for t0 in range(0, 40, 10):
        state, m = bt.htm_scan(cfg, state, torch.from_numpy(seq[t0:t0 + 10]),
                               t0 < 30,
                               draws=bt.TorchDraws(cfg.tm, 2, "cpu", gen))
        checks.validate_state(cfg, state)
        if t0 < 30:
            grown = summarize(m)["tm_grown_synapses"]
        tree = bt.htm_state_to_numpy(state)
        for b in range(2):
            jax_checks.validate_state(cfg, types.SimpleNamespace(
                sp=types.SimpleNamespace(
                    **{k: v[b] for k, v in tree["sp"].items()}),
                tm=types.SimpleNamespace(
                    **{k: v[b] for k, v in tree["tm"].items()})))
    assert grown > 0 and "tm_grown_synapses" not in summarize(m)
    health = capacity_health(m, pool_slots=cfg.tm.segment_capacity,
                             scan=True)
    assert health["status"] == "ok" and health["pool_occupancy"] > 0
    broken = bt.htm_state_to_numpy(state)
    live = np.argwhere(broken["tm"]["synapse_perm"][1] >= 0)[0]
    broken["tm"]["synapse_perm"][(1, *live)] = np.nan
    with pytest.raises(checks.StateInvariantError, match="NaN permanence"):
        checks.validate_state(cfg, broken)
    broken = bt.htm_state_to_numpy(state)
    broken["sp"]["duty_cycle"][0, 0] = 2.0
    with pytest.raises(checks.StateInvariantError, match="duty cycle"):
        checks.validate_state(cfg, broken)
    other = bt.htm_state_from_numpy(bt.htm_state_to_numpy(state), "cpu")
    other.tm.prediction[0, 0, 0] ^= 1
    with pytest.raises(AssertionError, match="tm/prediction"):
        checks.assert_trees_bit_equal(other, state)
