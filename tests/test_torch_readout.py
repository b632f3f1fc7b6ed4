"""The port's SDR readout: the contracts of `tests/test_readout.py` on
the port alone, then the classifier against the JAX package's from the
same SDRs. Weights and probabilities are held to |d| <= 1e-6: the
batched float32 product sums in another order than XLA's dot, and XLA
contracts the update into fused multiply-adds."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from bithtm_tpu import readout as jread

import bithtm_tpu_torch as bt
from bithtm_tpu_torch.convert import (named_state_from_numpy,
                                      named_state_to_numpy)

TOL = 1e-6


def test_classifier_learns_mapping():
    # direct check: distinct SDRs -> distinct buckets
    rng = np.random.RandomState(0)
    sdrs = torch.from_numpy(rng.rand(4, 64) < 0.2)
    state = bt.classifier_init(64, 4, device="cpu")
    for _ in range(50):
        for b in range(4):
            state = bt.classifier_update(state, sdrs[b][None], b)
    for b in range(4):
        probs = bt.classifier_predict(state, sdrs[b][None])
        assert int(probs.argmax(-1)) == b


def test_htm_sequence_prediction_pipeline():
    """Repeating value sequence: after training, the classifier applied
    to the TM's predictive cells recovers the next value."""
    values = [1.0, 3.0, 5.0, 2.0, 4.0, 0.0]
    buckets = 8
    enc = bt.ScalarEncoder(0.0, 5.0, size=128, active_bits=11)
    cfg = bt.make_htm_config(
        input_dim=enc.size, column_dim=128, cell_dim=8, active_columns=6,
        segment_activation_threshold=3, segment_matching_threshold=3,
        segment_sampling_synapses=12,
        sp_overrides={"boosting_intensity": 0.02},
    )
    gen = torch.Generator().manual_seed(0)
    state = bt.htm_init(cfg, gen, "cpu")
    draws = bt.TorchDraws(cfg.tm, 1, "cpu", gen)
    cls = bt.classifier_init(cfg.tm.num_cells, buckets, device="cpu")

    prev_pred_cells = None
    correct = []
    for epoch in range(30):
        for v in values:
            value = torch.tensor([v])
            target = bt.bucketize(value, 0.0, 5.0, buckets)
            if prev_pred_cells is not None:
                # learn: last step's predictive cells -> this value
                cls = bt.classifier_update(cls, prev_pred_cells, target)
                if epoch >= 25:
                    probs = bt.classifier_predict(cls, prev_pred_cells)
                    got = bt.bucket_value(probs.argmax(-1), 0.0, 5.0,
                                          buckets)
                    correct.append(abs(float(got[0]) - v) < 0.5)
            state, out = bt.htm_step(cfg, state, enc(value), True,
                                     draws=draws)
            prev_pred_cells = out.tm.prediction
    assert np.mean(correct) > 0.8, np.mean(correct)


def test_classifier_matches_jax():
    """B=3 streams of 400 SGD steps over 4,096 features and 8 buckets
    (noisy prototypes of the buckets), converted half-way, with an
    out-of-range bucket (8 or -1, which `jax.nn.one_hot` maps to a zero
    row) on 3% of the steps: within 1e-6 of a `jax.vmap` of JAX's
    classifier."""
    B, F, K, T = 3, 4096, 8, 400
    rng = np.random.RandomState(9)
    protos = rng.rand(K, F) < 0.05
    target = rng.randint(0, K, (T, B))
    sdrs = protos[target] ^ (rng.rand(T, B, F) < 0.01)
    odd = rng.rand(T, B) < 0.03
    target[odd] = np.where(rng.rand(odd.sum()) < 0.5, -1, K)
    assert (target == -1).any() and (target == K).any()
    update = jax.jit(jax.vmap(lambda s, x, y: jread.classifier_update(
        s, x, y, 0.1)))
    predict = jax.jit(jax.vmap(jread.classifier_predict))
    jstate = jax.vmap(lambda _: jread.classifier_init(F, K))(jnp.arange(B))
    pstate = bt.classifier_init(F, K, B, "cpu")
    for t in range(T):
        if t == T // 2:
            np.testing.assert_allclose(
                named_state_to_numpy(pstate)["weights"],
                np.asarray(jstate.weights), rtol=0, atol=TOL)
            pstate = named_state_from_numpy(bt.ClassifierState, jstate,
                                            "cpu")
        x = jnp.asarray(sdrs[t])
        jstate = update(jstate, x, jnp.asarray(target[t]))
        pstate = bt.classifier_update(pstate, torch.from_numpy(sdrs[t]),
                                      torch.from_numpy(target[t]), 0.1)
    np.testing.assert_allclose(pstate.weights.numpy(),
                               np.asarray(jstate.weights), rtol=0, atol=TOL)
    probe = sdrs[-1]
    np.testing.assert_allclose(
        bt.classifier_predict(pstate, torch.from_numpy(probe)).numpy(),
        np.asarray(predict(jstate, jnp.asarray(probe))), rtol=0, atol=TOL)
    # single-stream JAX state converts to a batch of one
    one = named_state_from_numpy(bt.ClassifierState,
                                 jread.classifier_init(F, K), "cpu")
    assert one.weights.shape == (1, K, F)
