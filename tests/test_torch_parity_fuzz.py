"""Config-fuzz oracle parity of the port: the 22 geometries of
`tests/test_parity_fuzz.py`, each on a dispatch or encoding boundary of
the step, through the port's `tm_step` on the CPU with its own draws,
every step of both streams judged by the JAX package's `OracleTM`
(`tests/test_torch_oracle.py` `run_port_parity`).

The cases are the JAX test's own list (`FUZZ_CASES`, imported); the
package keeps a copy for the card (`bithtm_tpu_torch.testing`, which
`chip_smoke.py` runs), held equal to it here so that the two cannot
drift. Each case runs three quarters of the JAX test's steps, which
keeps the file near 20 s on one CPU core.
"""

import dataclasses

import pytest

from bithtm_tpu_torch import testing
from bithtm_tpu_torch.ops.active_set import act_dtype

from .test_parity_fuzz import FUZZ_CASES, _cfg
from .test_torch_oracle import run_port_parity


def port_steps(steps: int) -> int:
    return steps * 3 // 4


def test_port_copy_of_the_fuzz_cases_equals_the_jax_list():
    """The package's copy names the same cases, overrides and steps, and
    builds each config with the same fields as the JAX test's."""
    assert testing.FUZZ_CASES == FUZZ_CASES
    for name, overrides, _ in FUZZ_CASES:
        want = dataclasses.asdict(_cfg(**overrides))
        got = dataclasses.asdict(testing.fuzz_config(**overrides))
        assert got == {k: want[k] for k in got}, name
    seeds = [testing.fuzz_seed(name) for name, _, _ in FUZZ_CASES]
    assert len(set(seeds)) == len(seeds)


@pytest.mark.parametrize("name,overrides,steps", FUZZ_CASES,
                         ids=[c[0] for c in FUZZ_CASES])
def test_port_parity_fuzz(name, overrides, steps):
    cfg = testing.fuzz_config(**overrides)
    state, _, totals = run_port_parity(cfg, port_steps(steps),
                                       testing.fuzz_seed(name))
    assert state.synapse_act.dtype == act_dtype(cfg.synapse_capacity)
    assert totals["tm_grown_synapses"] > 0, totals
    assert totals["tm_learning_segments"] > 0, totals
