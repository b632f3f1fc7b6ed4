"""The port's data pipeline and phase timer on the CPU: the prefetch
and `PhaseTimer` contracts of `tests/test_utils.py`, a prefetch-fed
scan equal to the direct one, and the synthetic workload equal to the
JAX package's."""

import copy
import os
import time

import numpy as np
import pytest
import torch

from bithtm_tpu.utils import data as jdata

import bithtm_tpu_torch as bt
from bithtm_tpu_torch.convert import htm_state_to_numpy
from bithtm_tpu_torch.utils.data import (noisy_pattern_chunks,
                                         prefetch_to_device)
from bithtm_tpu_torch.utils.profiling import PhaseTimer, trace

SMALL = dict(input_dim=64, column_dim=64, cell_dim=4, active_columns=4,
             segment_activation_threshold=2, segment_matching_threshold=2,
             segment_sampling_synapses=8)


def test_prefetch_pipeline_feeds_scan():
    cfg = bt.make_htm_config(**SMALL)
    rng = np.random.RandomState(0)
    pats = rng.rand(5, cfg.input_dim) < 0.2
    chunks = noisy_pattern_chunks(np.random.RandomState(1), pats,
                                  chunk_steps=10, num_chunks=4, batch=1)
    gen = torch.Generator().manual_seed(0)
    state = bt.htm_init(cfg, gen, "cpu")
    draws = bt.TorchDraws(cfg.tm, 1, "cpu", gen)
    n = 0
    for chunk in prefetch_to_device(chunks):
        assert chunk.shape == (10, 1, cfg.input_dim)
        assert chunk.device.type == "cpu"
        state, metrics = bt.htm_scan(cfg, state, chunk, True, draws=draws)
        n += 1
    assert n == 4
    assert int(state.tm.step) == 40


def test_prefetch_propagates_producer_errors():
    def bad():
        yield np.zeros(3)
        raise ValueError("boom")

    it = prefetch_to_device(bad())
    next(it)
    with pytest.raises(ValueError):
        list(it)


def test_prefetch_early_exit_releases_producer():
    produced = []

    def gen():
        for i in range(100):
            produced.append(i)
            yield np.full(4, i)

    it = prefetch_to_device(gen(), buffer_size=2)
    next(it)
    it.close()  # consumer abandons early
    time.sleep(0.5)
    n = len(produced)
    time.sleep(0.3)
    assert len(produced) == n  # producer stopped, not blocked-and-leaked
    assert n < 100


def test_prefetch_fed_scan_equals_direct_scan():
    """B=3 streams, 24 steps in chunks of 8 through the prefetcher (with
    tuple chunks): every state leaf and metric equal to one scan over
    the whole (T, B, I) tensor."""
    cfg = bt.make_htm_config(**SMALL)
    rng = np.random.RandomState(3)
    pats = rng.rand(5, cfg.input_dim) < 0.2
    xs = np.concatenate(list(noisy_pattern_chunks(rng, pats, 8, 3, 3)))
    gen = torch.Generator().manual_seed(5)
    s0 = bt.htm_init_batch(cfg, 3, gen, "cpu")
    gen_state = gen.get_state()
    direct, m_direct = bt.htm_scan(cfg, copy.deepcopy(s0),
                                   torch.from_numpy(xs), True,
                                   draws=bt.TorchDraws(cfg.tm, 3, "cpu", gen))
    gen.set_state(gen_state)
    draws = bt.TorchDraws(cfg.tm, 3, "cpu", gen)
    state, per_chunk = s0, []
    for x, t in prefetch_to_device((xs[i:i + 8], i) for i in range(0, 24, 8)):
        assert int(t) == len(per_chunk) * 8
        state, m = bt.htm_scan(cfg, state, x, True, draws=draws)
        per_chunk.append(m)
    for k, v in m_direct.items():
        assert torch.equal(torch.cat([m[k] for m in per_chunk]), v), k
    got, want = htm_state_to_numpy(state), htm_state_to_numpy(direct)
    for part in ("sp", "tm"):
        for name, a in got[part].items():
            np.testing.assert_array_equal(a, want[part][name])


def test_noisy_pattern_chunks_match_jax():
    pats = np.random.RandomState(0).rand(7, 32) < 0.2
    for batch in (None, 4):
        for a, b in zip(noisy_pattern_chunks(np.random.RandomState(1), pats,
                                             5, 3, batch),
                        jdata.noisy_pattern_chunks(np.random.RandomState(1),
                                                   pats, 5, 3, batch),
                        strict=True):
            np.testing.assert_array_equal(a, b)


def test_phase_timer_and_trace(tmp_path):
    t = PhaseTimer()
    for _ in range(2):
        with t.phase("x"):
            y = torch.ones((8, 8)) * 2
    assert float(y.sum()) == 128.0
    assert t.counts == {"x": 2} and t.totals["x"] > 0
    assert "x:" in t.report() and "(2 calls)" in t.report()
    with trace(str(tmp_path)):
        torch.ones(4).sum()
    assert any(f.endswith(".json") for f in os.listdir(tmp_path))
