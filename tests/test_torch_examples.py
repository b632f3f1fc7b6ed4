"""The port's example scripts (`bithtm_tpu_torch.examples`): they need
the card unless `--cpu` is given, and the anomaly benchmark's traces and
input SDRs equal the JAX script's. The scripts themselves run at full
width on the card (`chip_smoke.py` `run_anomaly`); on this CPU a run
takes minutes."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bithtm_tpu import encoders as jenc
from examples import anomaly_benchmark as jbench

from bithtm_tpu_torch.examples import anomaly_benchmark as pbench

EXAMPLES = ("anomaly_detection", "anomaly_benchmark", "sequence_prediction")


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_needs_the_card_without_cpu(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mod = importlib.import_module(f"bithtm_tpu_torch.examples.{name}")
    with pytest.raises(SystemExit, match="pass --cpu"):
        mod.main([])


def test_anomaly_benchmark_suite_matches_jax():
    """Every task's trace, windows and kind bit-equal to the JAX
    script's `make_task`; the batched suite task-major; the input SDRs
    of the port's `encode` equal the JAX script's encoders."""
    seeds = 2
    values, windows, fp_only = pbench.suite(pbench.TASKS, seeds)
    assert pbench.TASKS == jbench.TASKS
    for i, name in enumerate(jbench.TASKS):
        for seed in range(seeds):
            v, w, fp = jbench.make_task(
                name, np.random.RandomState(7000 + 13 * seed))
            b = i * seeds + seed
            np.testing.assert_array_equal(values[:, b], v, err_msg=name)
            assert windows[b] == w and fp_only[b] == fp
    x = pbench.encode(values[:, ::5], "cpu")
    t = np.arange(values.shape[0])
    for b in range(x.shape[1]):
        want = jenc.concat(
            jenc.ScalarEncoder(-2.2, 2.2, size=256, active_bits=17)(
                jnp.asarray(values[:, 5 * b])),
            jenc.CyclicEncoder(float(jbench.PERIOD), size=96,
                               active_bits=9)(jnp.asarray(t, jnp.float32)))
        np.testing.assert_array_equal(x[:, b].numpy(), np.asarray(want))
    assert pbench.make_config().input_dim == x.shape[-1] == 352
