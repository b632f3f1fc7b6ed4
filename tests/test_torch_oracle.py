"""The port's TM step judged by the NumPy oracle under its own draws.

The oracle (`bithtm_tpu/oracle/bami.py`) adopts the random decisions a
step made (winner tie-breaks, new-segment slots, grown targets), checks
each against the legal candidates, re-derives everything else and
compares the whole state bit for bit. The port's `tm_step` runs with its
own `TorchDraws` at B=2, one oracle a stream, so these tests hold the
port to the semantics without replaying JAX's draws. The cases mirror
`tests/test_tm_parity.py`. The port's copy of the oracle
(`bithtm_tpu_torch/oracle`) is held to the original on the same
decisions.
"""

import dataclasses
import types

import numpy as np
import pytest
import torch

from bithtm_tpu.oracle import bami as jax_bami
from bithtm_tpu.oracle import transplant as jax_transplant

import bithtm_tpu_torch as bt
from bithtm_tpu_torch import oracle as port_oracle
from bithtm_tpu_torch import testing
from bithtm_tpu_torch.convert import htm_state_to_numpy
from bithtm_tpu_torch.state import tm_init

B = 2


def make_cfg(k_active=5, **kw):
    """`tests/test_tm_parity.py` `make_cfg`, for the port's TMConfig."""
    base = dict(
        column_dim=32, cell_dim=4, active_columns=k_active,
        segments_per_column=4, synapse_capacity=12,
        segment_activation_threshold=2, segment_matching_threshold=2,
        segment_sampling_synapses=4,
        # incommensurate constants: no permanence lands exactly on 0.0
        permanence_initial=0.2137, permanence_increment=0.1003,
        permanence_decrement=0.0997, permanence_punishment=0.0251,
    )
    base.update(kw)
    return bt.TMConfig(**base)


def stream_view(tm_state, b):
    """Stream ``b`` of the port's TM state as the JAX oracle reads it:
    the numpy leaves of `htm_state_to_numpy`, uint32 words included."""
    sp = bt.SPState(*[torch.zeros(1)] * 3)   # not read
    tm = htm_state_to_numpy(bt.HTMState(sp=sp, tm=tm_state))["tm"]
    return types.SimpleNamespace(**{k: v[b] for k, v in tm.items()})


def debug_view(debug, b):
    """Stream ``b`` of a `TMDebug` as numpy, for the JAX bridge."""
    return types.SimpleNamespace(**{k: v[b].numpy()
                                    for k, v in debug._asdict().items()})


def step_cols(cfg, rng):
    return testing.fuzz_cols(cfg, B, rng)


def run_port_parity(cfg, steps, seed, learn_schedule=None):
    """The port's step at B=2 with its own draws, each stream judged by
    the JAX package's `OracleTM` through its `extract_decisions`.
    Returns the state, the oracles and the summed metrics."""
    gen = torch.Generator().manual_seed(seed)
    draws = bt.TorchDraws(cfg, B, "cpu", gen)
    state = tm_init(cfg, B, "cpu")
    oracles = [jax_bami.OracleTM(cfg) for _ in range(B)]
    rng = np.random.RandomState(seed)
    totals = {}
    for t in range(steps):
        cols = step_cols(cfg, rng)
        learning = True if learn_schedule is None else learn_schedule(t)
        state, out, debug = bt.tm_step(cfg, state, draws.step(),
                                       torch.from_numpy(cols), learning,
                                       return_debug=True)
        for b, oracle in enumerate(oracles):
            # an inference step's trace holds the winner cells alone
            decisions = jax_transplant.extract_decisions(
                debug_view(debug, b))
            oracle.step(cols[b], decisions, learning=learning)
            try:
                oracle.compare(stream_view(state, b))
            except jax_bami.ParityError as e:
                raise AssertionError(f"step {t} stream {b}: {e}") from e
        for k, v in out.metrics.items():
            totals[k] = totals.get(k, 0) + int(v.sum())
    return state, oracles, totals


# name: (cfg overrides, steps, seed, learn schedule); the cases of
# tests/test_tm_parity.py, with fewer steps
CASES = {
    "full_learning": (dict(), 100, 0, None),
    "tight_pool_recycling": (dict(segments_per_column=1), 80, 2, None),
    "evict_policy": (dict(segments_per_column=2, allocation_policy="evict"),
                     80, 12, None),
    "evict_small_capacity": (dict(allocation_policy="evict",
                                  synapse_capacity=8,
                                  segment_sampling_synapses=4), 60, 13,
                             None),
    "reference_policy_pressure": (dict(segments_per_column=2,
                                       allocation_policy="reference"),
                                  80, 12, None),
    "mixed_inference": (dict(), 60, 3, lambda t: t % 3 != 1),
    "tiny_synapse_capacity": (dict(synapse_capacity=5,
                                   segment_sampling_synapses=4), 60, 4,
                              None),
    "tiny_growth_capacity": (dict(growth_capacity=2), 60, 14, None),
    "tiny_winner_capacity": (dict(winner_capacity=3), 60, 7, None),
    "multiword_bitmask": (dict(k_active=4, column_dim=16, cell_dim=40,
                               segments_per_column=2), 50, 6, None),
    "single_cell_columns": (dict(k_active=4, column_dim=24, cell_dim=1,
                                 segments_per_column=3), 60, 8, None),
    "single_active_column": (dict(k_active=1, column_dim=16, cell_dim=4,
                                  segment_activation_threshold=1,
                                  segment_matching_threshold=1,
                                  segment_sampling_synapses=2), 60, 9,
                             None),
    "exact_cell_word_boundary": (dict(k_active=3, column_dim=8, cell_dim=32,
                                      segments_per_column=2), 50, 10, None),
    "all_columns_active": (dict(k_active=8, column_dim=8, cell_dim=4,
                                segments_per_column=4), 50, 11, None),
}


@pytest.mark.parametrize("name", list(CASES))
def test_port_step_passes_the_jax_oracle(name):
    kw, steps, seed, schedule = CASES[name]
    cfg = make_cfg(**kw)
    _, _, totals = run_port_parity(cfg, steps, seed, schedule)
    assert totals["tm_grown_synapses"] > 0
    assert totals["tm_learning_segments"] > totals["tm_new_segments"] > 0, \
        totals
    if name in ("evict_policy", "evict_small_capacity", "tight_pool_recycling"):
        assert totals["tm_evicted_segments"] > 0, totals
    if name == "reference_policy_pressure":
        assert totals["tm_dropped_new_segments"] > 0, totals
    if name == "all_columns_active":
        assert totals["tm_punished_segments"] == 0, totals
    elif name != "single_active_column":
        assert totals["tm_punished_segments"] > 0, totals
    if name == "tiny_growth_capacity":
        assert totals["tm_dropped_growth_segments"] > 0, totals
    if name == "tiny_winner_capacity":
        assert totals["tm_dropped_winner_candidates"] > 0, totals


def oracle_fields(o):
    return (o.owner, o.synapses, o.active_cells, o.winner_cells,
            o.predicted_cells, o.potential, o.matching, o.active_segments,
            o.step_count)


def test_port_oracle_copy_equals_the_original():
    """The port's oracle and bridge against the JAX package's: the same
    decisions from each bridge, both oracles stepped by them hold equal
    states, and both pass the port's state every step, learning and
    inference."""
    cfg = make_cfg(segments_per_column=2)
    gen = torch.Generator().manual_seed(21)
    draws = bt.TorchDraws(cfg, B, "cpu", gen)
    state = tm_init(cfg, B, "cpu")
    pairs = [(jax_bami.OracleTM(cfg), port_oracle.OracleTM(cfg))
             for _ in range(B)]
    rng = np.random.RandomState(21)
    for t in range(60):
        cols = step_cols(cfg, rng)
        learning = t % 4 != 3
        state, _, debug = bt.tm_step(cfg, state, draws.step(),
                                     torch.from_numpy(cols), learning,
                                     return_debug=True)
        for b, (jo, po) in enumerate(pairs):
            want = jax_transplant.extract_decisions(debug_view(debug, b))
            got = port_oracle.extract_decisions(debug, b)
            assert dataclasses.asdict(got) == dataclasses.asdict(want)
            jo.step(cols[b], want, learning=learning)
            po.step(cols[b], got, learning=learning)
            assert oracle_fields(po) == oracle_fields(jo), (t, b)
            jo.compare(stream_view(state, b))
            po.compare(port_oracle.tm_stream(state, b))
    bad = port_oracle.tm_stream(state, 0)
    live = tuple(np.argwhere(bad.synapse_perm >= 0)[0])
    bad.synapse_perm[live] += np.float32(0.5)
    with pytest.raises(port_oracle.ParityError):
        pairs[0][1].compare(bad)


def test_oracle_from_state_midstream():
    """`oracle_from_state` on each stream of a batched state equals the
    JAX bridge's oracle of that stream, passes the state, and keeps
    judging the port's steps from there on."""
    cfg = make_cfg()
    state, _, _ = run_port_parity(cfg, steps=30, seed=5)
    gen = torch.Generator().manual_seed(55)
    draws = bt.TorchDraws(cfg, B, "cpu", gen)
    oracles = []
    for b in range(B):
        po = port_oracle.oracle_from_state(cfg, state, b)
        jo = jax_transplant.oracle_from_state(cfg, stream_view(state, b))
        assert oracle_fields(po) == oracle_fields(jo)
        po.compare(port_oracle.tm_stream(state, b))
        oracles.append(po)
    rng = np.random.RandomState(56)
    for t in range(15):
        cols = step_cols(cfg, rng)
        state, _, debug = bt.tm_step(cfg, state, draws.step(),
                                     torch.from_numpy(cols), True,
                                     return_debug=True)
        for b, po in enumerate(oracles):
            po.step(cols[b], port_oracle.extract_decisions(debug, b))
            po.compare(port_oracle.tm_stream(state, b))
