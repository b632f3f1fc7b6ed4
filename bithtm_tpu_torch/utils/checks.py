"""State-invariant validation, the out-of-band auditor of a state.

Counterpart of `bithtm_tpu/utils/checks.py`: `validate_state` re-derives
every structural invariant of a state on the host and raises with a
precise message; call it in tests or between training epochs. The
port's states are batched, so each stream is checked on its own, as the
JAX package checks a single-stream state, over the numpy leaves of
`convert.htm_state_to_numpy`.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Mapping

import numpy as np
import torch

from ..convert import htm_state_to_numpy
from ..ops.overlap import unpack_connected
from ..oracle.transplant import tm_stream


class StateInvariantError(AssertionError):
    pass


def validate_tm_state(cfg, tm) -> None:
    """Check every structural invariant of one stream's TMState (numpy
    leaves, as `oracle.tm_stream` gives them)."""
    C, D, G, K = (cfg.column_dim, cfg.cell_dim, cfg.segments_per_column,
                  cfg.synapse_capacity)
    N = C * D
    syn = np.asarray(tm.synapse_cell).reshape(C, G, K)
    perm = np.asarray(tm.synapse_perm).reshape(C, G, K)
    seg_cell = np.asarray(tm.seg_cell)

    def fail(msg):
        raise StateInvariantError(msg)

    if not ((seg_cell >= 0) & (seg_cell <= D)).all():
        fail("seg_cell out of [0, D] range")
    # a slot is live iff perm >= 0; slots with syn >= 0 but perm < 0 are
    # stale punishment-death victims awaiting row-space cleanup (the
    # implicit-death convention, see TMState docstring). Stale ids were
    # once valid targets, so the range check covers them too.
    live = (syn >= 0) & (perm >= 0.0)
    if not (syn[syn >= 0] < N).all():
        fail("synapse target cell out of range")
    if np.isnan(perm).any():
        fail("NaN permanence")
    if not (syn[perm >= 0.0] >= 0).all():
        fail("live permanence on a free (syn == -1) slot")
    if not (perm[syn < 0] == -1.0).all():
        fail("free slot with non-sentinel permanence")
    # synapses may only live on allocated segments
    unalloc = seg_cell == D
    if live[unalloc].any():
        fail("live synapse on unallocated segment slot")
    # no duplicate targets within a segment
    for c, g in zip(*np.nonzero(live.any(-1))):
        targets = syn[c, g][live[c, g]]
        if len(np.unique(targets)) != len(targets):
            fail(f"duplicate synapse targets in segment ({c},{g})")
    # compact active set: column ids in range, sorted
    cols = np.asarray(tm.active_cols)
    if not ((cols >= 0) & (cols < C)).all():
        fail("active_cols out of range")
    if not (np.diff(cols) >= 0).all():
        fail("active_cols not sorted")
    # cached forward activity must equal the post-step table's
    # activation wrt the carried compact active set — an exact per-entry
    # re-derivation of the packed value v = act + scale*conn
    # (`ops.active_set.act_scale`)
    bits = np.asarray(tm.active_bits).view(np.uint32)  # (A, W)
    d = np.arange(D)
    rows = (bits[:, d // 32] >> (d % 32).astype(np.uint32)) & 1  # (A, D)
    dense = np.zeros((C, D), bool)
    dense[cols] = rows != 0
    active_cell = dense.reshape(-1)                    # (N,)
    from ..ops.active_set import act_scale

    scale = act_scale(K)
    v = np.asarray(tm.synapse_act, np.float32).reshape(C, G, K)
    expect_act = live & active_cell[np.clip(syn, 0, N - 1)]
    expect_conn = expect_act & (perm >= cfg.permanence_threshold)
    expect_v = np.where(
        expect_act, np.where(expect_conn, 1.0 + scale, 1.0), 0.0
    ).astype(np.float32)
    if not (v == expect_v).all():
        fail("synapse_act inconsistent with the table + active set")
    act = v != 0
    # the carried matching_word must equal the flags derived from that
    # activity (the same derivation the step uses at its active rows)
    from ..ops.active_set import matching_dense_host, prediction_dense_host

    pot = act.sum(-1)
    match = matching_dense_host(tm.matching_word, G)
    if not (match == (pot >= cfg.segment_matching_threshold)).all():
        fail("matching_word inconsistent with cached synapse_act")
    # the carried packed prediction must equal the forward pass
    # re-derived from the table + cached activity: a segment predicts
    # its owner cell iff it is matching AND has >= activation_threshold
    # connected (perm >= theta) active synapses
    conn_cnt = (act & (perm >= cfg.permanence_threshold)).sum(-1)  # (C, G)
    seg_active = (
        (pot >= cfg.segment_matching_threshold)
        & (conn_cnt >= cfg.segment_activation_threshold)
    )
    pred_cell = np.zeros((C, D), bool)
    for c, g in zip(*np.nonzero(seg_active)):
        if seg_cell[c, g] < D:
            pred_cell[c, seg_cell[c, g]] = True
    got_pred = prediction_dense_host(tm.prediction, D)  # (C, D)
    if not (got_pred == pred_cell).all():
        fail("packed prediction inconsistent with table + synapse_act")


def validate_state(cfg, state) -> None:
    """Validate every stream of an HTMState (the port's, or the mapping
    of `convert.htm_state_to_numpy`): SP and TM invariants."""
    if not isinstance(state, Mapping):
        state = htm_state_to_numpy(state)
    sp = state["sp"]
    for b in range(np.asarray(state["tm"]["step"]).shape[0]):
        validate_tm_state(cfg.tm, tm_stream(state["tm"], b))
        perm = np.asarray(sp["permanence"][b])
        conn = np.asarray(sp["connected"][b])
        if perm.dtype.kind == "f" and np.isnan(perm).any():
            raise StateInvariantError("NaN SP permanence")
        thr = (cfg.sp.to_units(cfg.sp.permanence_threshold)
               if cfg.sp.quantized else cfg.sp.permanence_threshold)
        got = unpack_connected(torch.from_numpy(conn), perm.shape[-1])
        if not (got.numpy() == (perm >= thr)).all():
            raise StateInvariantError("SP connected cache inconsistent")
        duty = np.asarray(sp["duty_cycle"][b])
        if not ((duty >= 0.0) & (duty <= 1.0)).all():
            raise StateInvariantError("SP duty cycle out of [0, 1]")


def _leaves(tree, prefix: str = "") -> dict:
    """The tensor and array leaves of a state (dataclasses, mappings)
    under their '/'-joined names."""
    if dataclasses.is_dataclass(tree):
        tree = {f.name: getattr(tree, f.name)
                for f in dataclasses.fields(tree)}
    if isinstance(tree, Mapping):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def _numpy(x) -> np.ndarray:
    return x.detach().cpu().numpy() if hasattr(x, "detach") else np.asarray(x)


def assert_trees_bit_equal(got, want, got_metrics=None, want_metrics=None):
    """Assert two states are **bit-equal**, leaf by leaf, with the same
    leaf names; optionally two metric dicts key by key."""
    g, w = _leaves(got), _leaves(want)
    if list(g) != list(w):
        raise StateInvariantError(f"leaves differ: {list(g)} vs {list(w)}")
    for name in g:
        a, b = _numpy(g[name]), _numpy(w[name])
        if a.dtype != b.dtype:
            raise StateInvariantError(
                f"leaf {name}: dtype {a.dtype} vs {b.dtype}")
        np.testing.assert_array_equal(  # bits: -0.0 != 0.0, NaN == NaN
            np.ascontiguousarray(np.atleast_1d(a)).view(np.uint8),
            np.ascontiguousarray(np.atleast_1d(b)).view(np.uint8),
            err_msg=f"leaf {name}")
    if got_metrics is not None:
        for k in want_metrics:
            np.testing.assert_array_equal(
                _numpy(got_metrics[k]), _numpy(want_metrics[k]),
                err_msg=f"metric {k}")
