"""Bridge between the port's TM step and the NumPy oracle.

A copy of `bithtm_tpu/oracle/transplant.py` for one stream of the port's
batched step: `extract_decisions` reads stream ``b`` of a `TMDebug`,
`oracle_from_state` stream ``b`` of a state, and `tm_stream` gives the
numpy view of one stream that `OracleTM.compare` reads (the leaves of
`convert.htm_state_to_numpy`, with the JAX package's dtypes).
"""

from __future__ import annotations

import dataclasses
import types
from collections.abc import Mapping

import numpy as np

from ..convert import U32_LEAVES
from .bami import OracleDecisions, OracleTM, bits_to_cell_set


def _host(x, b: int) -> np.ndarray:
    """Stream ``b`` of a batched tensor or array, as a numpy copy (a
    step updates the port's tables in place)."""
    x = x[b]
    return np.array(x.cpu().numpy() if hasattr(x, "cpu") else x)


def tm_stream(tm_state, b: int = 0) -> types.SimpleNamespace:
    """Stream ``b`` of a batched TMState (the port's, or the ``"tm"``
    mapping of `convert.htm_state_to_numpy`) as numpy leaves under their
    TMState names, the uint32 words viewed as uint32."""
    if isinstance(tm_state, Mapping):
        items = tm_state.items()
    else:
        items = ((f.name, getattr(tm_state, f.name))
                 for f in dataclasses.fields(tm_state))
    leaves = {}
    for name, x in items:
        a = _host(x, b)
        leaves[name] = (a.view(np.uint32) if name in U32_LEAVES
                        and a.dtype == np.int32 else a)
    return types.SimpleNamespace(**leaves)


def extract_decisions(debug, b: int = 0) -> OracleDecisions:
    """Convert stream ``b`` of a `TMDebug` into OracleDecisions.

    Slot ids are global (c * G + g, matching the oracle's flattening of
    the per-column pool); cells are global ids.
    """
    winner_mask = _host(debug.winner_mask, b)
    winner = set(np.nonzero(winner_mask)[0].tolist())

    learning_cg = _host(debug.learning_segments, b)         # (C, G)
    G = learning_cg.shape[1]
    learning = set(
        (int(c) * G + int(g))
        for c, g in zip(*np.nonzero(learning_cg))
    )

    new_cg = _host(debug.new_segments, b)                   # (C, G)
    seg_cell = _host(debug.seg_cell, b)                     # (C, G)
    D = winner_mask.shape[0] // new_cg.shape[0]
    new_segments = [
        (int(c) * G + int(g), int(c) * D + int(seg_cell[c, g]))
        for c, g in zip(*np.nonzero(new_cg))
    ]

    grown_mask = _host(debug.grown_mask, b)                 # (C, G, K)
    cell_tab = _host(debug.synapse_cell, b)                 # (C, G, K)
    grown = {}
    cs, gs, ks = np.nonzero(grown_mask)
    for c, g, k in zip(cs.tolist(), gs.tolist(), ks.tolist()):
        grown.setdefault(c * G + g, set()).add(int(cell_tab[c, g, k]))
    return OracleDecisions(
        winner_cells=winner,
        learning_segments=learning,
        new_segments=new_segments,
        grown=grown,
    )


def oracle_from_state(cfg, tm_state, b: int = 0) -> OracleTM:
    """Build an oracle mid-stream from stream ``b`` of a batched TMState
    (the analogue of `copy_custom`, `reference_implementations.py:48-88`)."""
    tm_state = tm_stream(tm_state, b)
    o = OracleTM(cfg)
    C, D, G = cfg.column_dim, cfg.cell_dim, cfg.segments_per_column
    seg_cell = tm_state.seg_cell
    cell_tab = tm_state.synapse_cell.reshape(C, G, -1)
    perm_tab = tm_state.synapse_perm.reshape(C, G, -1)
    K = cell_tab.shape[-1]
    for s in range(cfg.segment_capacity):
        c, g = divmod(s, G)
        if seg_cell[c, g] < D:
            o.owner[s] = int(c * D + seg_cell[c, g])
            # dead iff perm < 0 (implicit punishment death leaves stale
            # target ids behind, see TMState docstring)
            o.synapses[s] = {
                int(cell_tab[c, g, k]): float(perm_tab[c, g, k])
                for k in range(K)
                if cell_tab[c, g, k] >= 0 and perm_tab[c, g, k] >= 0
            }

    o.active_cells = bits_to_cell_set(
        tm_state.active_cols, tm_state.active_bits, D
    )
    o.winner_cells = bits_to_cell_set(
        tm_state.active_cols, tm_state.winner_bits, D
    )
    from ..ops.active_set import prediction_dense_host

    o.predicted_cells = set(
        np.nonzero(
            prediction_dense_host(tm_state.prediction, D).reshape(-1)
        )[0].tolist()
    )
    # per-segment forward state re-derived from the cached activity +
    # permanences (the carried matching_word packs the matching bits —
    # audited against this same derivation by `utils.checks`)
    act = (tm_state.synapse_act != 0).reshape(C, G, K)
    pot = act.sum(-1)                                      # (C, G)
    conn = (act & (perm_tab >= cfg.permanence_threshold)).sum(-1)
    matching = pot >= cfg.segment_matching_threshold
    seg_active = matching & (conn >= cfg.segment_activation_threshold)
    o.potential = pot.reshape(-1).tolist()
    o.matching = set(np.nonzero(matching.reshape(-1))[0].tolist())
    o.active_segments = set(np.nonzero(seg_active.reshape(-1))[0].tolist())
    o.step_count = int(tm_state.step)
    return o
