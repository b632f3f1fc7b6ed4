"""Clean-room NumPy oracle for the TemporalMemory step.

A copy of `bithtm_tpu/oracle/bami.py` for the port, which imports
nothing of the JAX package: the same loop-based implementation of the
BAMI temporal memory semantics (SURVEY.md §2), used purely as a
differential-test bed. Its host decoders are the port's
(`bithtm_tpu_torch/ops/active_set.py`); nothing else differs.

The oracle **consumes the step's RNG-dependent decisions** (winner
tie-breaks, new-segment slot assignment, grown-synapse targets),
*validates* each decision against the set of legal candidates, then
re-derives every deterministic consequence independently. Comparing the
resulting state to the step's state is then a bit-exact check of
active/winner/predicted cell sets and the entire synapse table. It judges
a step under that step's own draws, so it runs wherever the step runs.

State here is slot-indexed exactly like the port's pool so tables compare
directly: segment slot s has an owner cell and a dict {presynaptic cell
-> permanence}. It reads one stream: `transplant.tm_stream` views one
stream of a batched state with the JAX package's dtypes.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np


@dataclasses.dataclass
class OracleDecisions:
    """RNG-dependent choices extracted from one tm_step (TMDebug)."""

    winner_cells: set            # set[int]
    learning_segments: set       # set[int] slot ids (incl. new ones)
    new_segments: list           # list[(slot, cell)] in assignment order
    grown: dict                  # slot -> set[int] grown presynaptic cells


class ParityError(AssertionError):
    pass


def bits_to_cell_set(cols, bits, cell_dim):
    """Decode the compact (cols, bits) active-set encoding into a set of
    global cell ids (shared by OracleTM.compare and oracle_from_state)."""
    cells = set()
    cols = np.asarray(cols)
    bits = np.asarray(bits)
    for a in range(cols.shape[0]):
        for w in range(bits.shape[1]):
            word = int(bits[a, w])
            for b in range(32):
                d = w * 32 + b
                if d < cell_dim and (word >> b) & 1:
                    cells.add(int(cols[a]) * cell_dim + d)
    return cells



class OracleTM:
    """Loop-based TM with injected decisions.

    cfg is a TMConfig (only plain python fields are read).
    """

    def __init__(self, cfg):
        self.cfg = cfg
        self.C = cfg.column_dim
        self.D = cfg.cell_dim
        self.N = cfg.num_cells
        self.G = cfg.segments_per_column
        self.S = cfg.segment_capacity  # C * G; slot s belongs to column s // G
        # slot -> owner cell (None = unallocated)
        self.owner = [None] * self.S
        # slot -> {cell: permanence}
        self.synapses = [dict() for _ in range(self.S)]

        # recurrent state
        self.active_cells = set()
        self.winner_cells = set()
        self.predicted_cells = set()
        self.potential = [0] * self.S        # potential counts
        self.matching = set()                # slot ids
        self.active_segments = set()
        self.step_count = 0

    # ---- helpers -------------------------------------------------------

    def cell_segments(self, cell):
        # a cell's segments lie in its column's G slots
        c = cell // self.D
        return [s for s in range(c * self.G, (c + 1) * self.G)
                if self.owner[s] == cell]

    def column_cells(self, column):
        return range(column * self.D, (column + 1) * self.D)

    def cell_max_potential(self, cell):
        """Max potential over the cell's matching segments (0 if none)."""
        best = 0
        for s in self.cell_segments(cell):
            if s in self.matching:
                best = max(best, self.potential[s])
        return best

    # ---- one timestep --------------------------------------------------

    def step(self, active_columns, decisions: OracleDecisions,
             learning=True):
        cfg = self.cfg
        active_columns = set(int(c) for c in active_columns)
        has_prev = self.step_count > 0

        # 1. bursting (networks.py:96-97 semantics)
        bursting = set()
        for c in active_columns:
            if not any(cell in self.predicted_cells
                       for cell in self.column_cells(c)):
                bursting.add(c)

        # 2. validate winner decisions (semantics 6)
        expected_fixed = set()
        for c in active_columns:
            for cell in self.column_cells(c):
                if cell in self.predicted_cells:
                    expected_fixed.add(cell)
        chosen = decisions.winner_cells - expected_fixed
        if not expected_fixed <= decisions.winner_cells:
            raise ParityError("predicted cells missing from winners")
        for c in active_columns - bursting:
            if any(cell in chosen for cell in self.column_cells(c)):
                raise ParityError(f"extra winner in non-bursting column {c}")
        for c in bursting:
            col_winners = [cell for cell in self.column_cells(c)
                           if cell in chosen]
            if len(col_winners) != 1:
                raise ParityError(
                    f"bursting column {c} has {len(col_winners)} winners"
                )
            w = col_winners[0]
            col_max = max(self.cell_max_potential(cell)
                          for cell in self.column_cells(c))
            if col_max >= cfg.segment_matching_threshold:
                # best-matching candidates: cells achieving the column max
                cand = [cell for cell in self.column_cells(c)
                        if self.cell_max_potential(cell) == col_max]
            else:
                # least-used candidates
                counts = {cell: len(self.cell_segments(cell))
                          for cell in self.column_cells(c)}
                mn = min(counts.values())
                cand = [cell for cell, n in counts.items() if n == mn]
            if w not in cand:
                raise ParityError(
                    f"winner {w} not a legal candidate in column {c}"
                )
        winners = set(decisions.winner_cells)

        new_segment_slots = []
        if learning and has_prev:
            self._learn(active_columns, winners, decisions)
        elif learning and not has_prev:
            # First step: reference update() early-returns on prev
            # distal state None (projections.py:258-259).
            if decisions.learning_segments or decisions.new_segments:
                raise ParityError("learning happened on step 0")

        # 4. activation (semantics 7)
        new_active = set()
        for c in active_columns:
            if c in bursting:
                new_active.update(self.column_cells(c))
            else:
                for cell in self.column_cells(c):
                    if cell in self.predicted_cells:
                        new_active.add(cell)

        # 5. forward pass (semantics 12)
        self.potential = [0] * self.S
        self.matching = set()
        self.active_segments = set()
        predicted = set()
        for s in range(self.S):
            if self.owner[s] is None:
                continue
            pot = 0
            conn = 0
            for cell, perm in self.synapses[s].items():
                if cell in new_active:
                    pot += 1
                    if perm >= cfg.permanence_threshold:
                        conn += 1
            self.potential[s] = pot
            if pot >= cfg.segment_matching_threshold:
                self.matching.add(s)
                if conn >= cfg.segment_activation_threshold:
                    self.active_segments.add(s)
                    predicted.add(self.owner[s])

        self.active_cells = new_active
        self.winner_cells = winners
        self.predicted_cells = predicted
        self.step_count += 1
        return {
            "bursting_columns": bursting,
            "active_cells": set(new_active),
            "winner_cells": set(winners),
            "predicted_cells": set(predicted),
        }

    # ---- learning ------------------------------------------------------

    def _learn(self, active_columns, winners, decisions):
        cfg = self.cfg
        prev_active = self.active_cells
        # growth candidates: previous winners, truncated to the static
        # winner_capacity by ascending cell id (the JAX step's compact
        # candidate list; overflow dropped + counted there)
        prev_winners = sorted(self.winner_cells)[
            : cfg.resolved_winner_capacity
        ]

        # learning segment set (semantics 8): matching segments of winner
        # cells that were active OR (cell unpredicted AND best-matching).
        mandatory = set()
        optional_by_cell = {}
        for s in self.matching:
            cell = self.owner[s]
            if cell not in winners:
                continue
            if s in self.active_segments:
                mandatory.add(s)
            elif cell not in self.predicted_cells:
                optional_by_cell.setdefault(cell, []).append(s)

        claimed = decisions.learning_segments - set(
            slot for slot, _ in decisions.new_segments
        )
        if not mandatory <= claimed:
            raise ParityError("missing mandatory learning segments")
        extra = claimed - mandatory
        # each extra must be a best-matching candidate of an unpredicted
        # winner cell, exactly one per such cell
        seen_cells = set()
        for s in extra:
            cell = self.owner[s]
            cands = optional_by_cell.get(cell, [])
            best = max(self.potential[c] for c in cands) if cands else None
            if s not in cands or self.potential[s] != best:
                raise ParityError(f"segment {s} is not best-matching")
            if cell in seen_cells:
                raise ParityError(f"two best-matching segments for {cell}")
            seen_cells.add(cell)
        # every unpredicted winner cell WITH matching segments must learn one
        for cell, cands in optional_by_cell.items():
            if cands and cell not in seen_cells:
                raise ParityError(f"cell {cell} skipped its best-matching")

        # punished segments (semantics 8): matching segments owned by
        # cells of non-active columns.
        punished = set()
        for s in self.matching:
            if self.owner[s] // self.D not in active_columns:
                punished.add(s)

        # new segments (semantics 9): winner cells without matching
        # segments. The pool is per-column (slot s hosts only cells of
        # column s // G); within a column the assignment is fully
        # deterministic: eligible slots (synapse count below the
        # matching threshold — `add_output`'s recycle rule,
        # `projections.py:80`) ordered allocated-recyclable-first then
        # unallocated, ascending slot; unaccounted cells ascending; the
        # i-th cell takes the i-th slot, overflow dropped.
        unaccounted = sorted(
            cell for cell in winners if self.cell_max_potential(cell) == 0
        )
        expected_assign = set()
        for c in sorted({cell // self.D for cell in unaccounted}):
            cells = [cell for cell in unaccounted if cell // self.D == c]
            recyclable = [
                s for s in range(c * self.G, (c + 1) * self.G)
                if len(self.synapses[s]) < cfg.segment_matching_threshold
            ]
            recyclable.sort(
                key=lambda s: s + self.S * (self.owner[s] is None)
            )
            slots = recyclable
            if getattr(cfg, "allocation_policy", "reference") == "evict":
                # third tier: mature non-matching slots, weakest first
                # (ascending live-synapse count, ascending slot) —
                # mirrors `_allocate`'s evict keys exactly
                evictable = [
                    s for s in range(c * self.G, (c + 1) * self.G)
                    if s not in set(recyclable) and s not in self.matching
                ]
                evictable.sort(key=lambda s: (len(self.synapses[s]), s))
                slots = recyclable + evictable
            expected_assign.update(zip(slots, cells))
        got = set(decisions.new_segments)
        if got != expected_assign:
            raise ParityError(
                f"segment allocation mismatch: {sorted(got)} vs "
                f"{sorted(expected_assign)}"
            )
        learning = set(claimed)
        for slot, cell in got:
            self.owner[slot] = cell
            self.synapses[slot] = {}
            learning.add(slot)
        if learning != decisions.learning_segments:
            raise ParityError("learning segment set mismatch")

        # permanence update + death (semantics 11) — disjoint sets.
        # float32 arithmetic to bit-match the JAX table update (one f32
        # add of +inc / -dec / -punishment per synapse).
        f32 = np.float32
        for s in learning:
            syn = self.synapses[s]
            for cell in list(syn):
                if cell in prev_active:
                    syn[cell] = float(f32(syn[cell]) + f32(cfg.permanence_increment))
                else:
                    syn[cell] = float(f32(syn[cell]) + f32(-cfg.permanence_decrement))
                if syn[cell] < 0.0:
                    del syn[cell]
        for s in punished:
            syn = self.synapses[s]
            for cell in list(syn):
                if cell in prev_active:
                    syn[cell] = float(f32(syn[cell]) + f32(-cfg.permanence_punishment))
                    if syn[cell] < 0.0:
                        del syn[cell]

        # synapse growth (semantics 10): toward prev winners, up to
        # sampling - active_potential, never duplicating targets.
        # The JAX step compacts the growing segments to the static
        # L = resolved_growth_capacity list by ascending global slot id
        # (temporal_memory._grow's nonzero(..., size=L) over the flat
        # (sorted-active-col, slot) order); learning segments past the
        # cap skip growth entirely (counted in
        # tm_dropped_growth_segments) — mirror that here.
        L = getattr(cfg, "resolved_growth_capacity", None) or len(learning)
        fits_growth_list = set(sorted(learning)[:L])
        for s in learning:
            grown = decisions.grown.get(s, set())
            syn = self.synapses[s]
            if s not in fits_growth_list:
                if grown:
                    raise ParityError(
                        f"segment {s}: grew past the growth-list cap"
                    )
                continue
            active_pot = sum(1 for cell in syn if cell in prev_active)
            n_grow = max(
                0,
                min(
                    cfg.segment_sampling_synapses - active_pot,
                    min(cfg.segment_sampling_synapses, len(prev_winners)),
                ),
            )
            candidates = [w for w in prev_winners if w not in syn]
            expected_n = min(n_grow, len(candidates))
            free = cfg.synapse_capacity - len(syn)
            if len(grown) != min(expected_n, free):
                raise ParityError(
                    f"segment {s}: grew {len(grown)}, expected "
                    f"{min(expected_n, free)}"
                )
            for cell in grown:
                if cell not in candidates:
                    raise ParityError(
                        f"segment {s}: illegal growth target {cell}"
                    )
                syn[cell] = float(np.float32(cfg.permanence_initial))
        for s, grown in decisions.grown.items():
            if grown and s not in learning:
                raise ParityError(f"non-learning segment {s} grew synapses")

    # ---- comparison ----------------------------------------------------

    def compare(self, tm_state, out=None, atol=1e-5):
        """Bit-exact comparison against one stream's TMState (numpy).

        Slot s in the per-column pool is (c, g) = divmod(s, G); its
        owner is global cell c * D + seg_cell[c, g] (sentinel D =
        unallocated). The compact active/winner sets are expanded from
        the (cols, bits) encoding.
        """
        import numpy as np

        C, D, G = self.C, self.D, self.G
        seg_cell = np.asarray(tm_state.seg_cell)                  # (C, G)
        cell_tab = np.asarray(tm_state.synapse_cell).reshape(C, G, -1)
        perm_tab = np.asarray(tm_state.synapse_perm).reshape(C, G, -1)
        K = cell_tab.shape[-1]

        for s in range(self.S):
            c, g = divmod(s, G)
            o = self.owner[s]
            jax_alloc = seg_cell[c, g] < D
            if (o is not None) != bool(jax_alloc):
                raise ParityError(f"slot {s} allocation mismatch")
            if o is not None and o != c * D + seg_cell[c, g]:
                raise ParityError(
                    f"slot {s} owner {c * D + seg_cell[c, g]} != {o}"
                )
            jax_syn = {}
            for k in range(K):
                # dead iff perm < 0: punishment death leaves the stale
                # target id in synapse_cell (implicit-death convention,
                # see TMState docstring) — skip those slots
                if cell_tab[c, g, k] >= 0 and perm_tab[c, g, k] >= 0:
                    t = int(cell_tab[c, g, k])
                    if t in jax_syn:
                        raise ParityError(f"slot {s} duplicate synapse {t}")
                    jax_syn[t] = float(perm_tab[c, g, k])
            if set(jax_syn) != set(self.synapses[s]):
                raise ParityError(
                    f"slot {s} synapse targets {sorted(jax_syn)} != "
                    f"{sorted(self.synapses[s])}"
                )
            for t, p in self.synapses[s].items():
                if not math.isclose(p, jax_syn[t], abs_tol=atol):
                    raise ParityError(
                        f"slot {s} syn {t} perm {jax_syn[t]} != {p}"
                    )

        def bits_to_set(cols, bits):
            return bits_to_cell_set(cols, bits, D)

        def check_set(name, got, expected):
            if got != expected:
                raise ParityError(
                    f"{name}: jax-only={sorted(got - expected)[:8]} "
                    f"oracle-only={sorted(expected - got)[:8]}"
                )

        check_set(
            "active_cells",
            bits_to_set(tm_state.active_cols, tm_state.active_bits),
            self.active_cells,
        )
        check_set(
            "winner_cells",
            bits_to_set(tm_state.active_cols, tm_state.winner_bits),
            self.winner_cells,
        )
        from ..ops.active_set import prediction_dense_host

        pred = prediction_dense_host(tm_state.prediction, D).reshape(-1)
        check_set(
            "prediction",
            set(int(i) for i in np.nonzero(pred)[0]),
            self.predicted_cells,
        )
        # per-segment forward state: matching comes from the carried
        # packed word; potential / active are re-derived from the cached
        # activity + permanences (the same derivation the JAX step uses
        # at its active rows) — still a real check of the JAX-computed
        # activation against the oracle's tracking
        act_cgk = (np.asarray(tm_state.synapse_act) != 0).reshape(
            cell_tab.shape
        )
        pot_cg = act_cgk.sum(-1)                       # (C, G)
        conn_cg = (
            act_cgk & (perm_tab >= self.cfg.permanence_threshold)
        ).sum(-1)
        from ..ops.active_set import matching_dense_host

        match = matching_dense_host(tm_state.matching_word, G).reshape(-1)
        check_set(
            "matching",
            set(int(i) for i in np.nonzero(match)[0]),
            self.matching,
        )
        seg_act = (
            match.reshape(pot_cg.shape)
            & (conn_cg >= self.cfg.segment_activation_threshold)
        ).reshape(-1)
        check_set(
            "active_segments",
            set(int(i) for i in np.nonzero(seg_act)[0]),
            self.active_segments,
        )
        pot = pot_cg.reshape(-1)
        for s in range(self.S):
            if self.owner[s] is not None and pot[s] != self.potential[s]:
                raise ParityError(
                    f"slot {s} potential {pot[s]} != {self.potential[s]}"
                )
