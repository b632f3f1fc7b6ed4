"""Static configuration of the PyTorch port.

A jax-free counterpart of `bithtm_tpu/config.py`: the same frozen
dataclasses, fields, defaults, validation and resolved capacities, so a
config serialized by either package (`config_to_dict`) loads in the
other. The JAX package's module cannot be imported here because its
package `__init__` imports jax.
"""

from __future__ import annotations

import dataclasses
import warnings


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class SPConfig:
    """SpatialPooler hyperparameters (reference `projections.py:7-10`,
    `regularizations.py:5-7`).

    ``permanence_dtype="int16"`` stores permanences as integer multiples
    of ``permanence_quantum``: the Hebbian update is exact integer
    arithmetic and only the Gaussian init is quantized."""

    input_dim: int
    column_dim: int
    active_columns: int

    permanence_mean: float = 0.0
    permanence_std: float = 0.1
    permanence_threshold: float = 0.0
    permanence_increment: float = 0.03
    permanence_decrement: float = 0.015

    boosting_intensity: float = 0.3
    duty_cycle_momentum: float = 0.99

    permanence_dtype: str = "float32"
    permanence_quantum: float = 0.005

    def __post_init__(self):
        if not (0 < self.active_columns <= self.column_dim):
            raise ValueError(
                f"active_columns={self.active_columns} must be in "
                f"[1, column_dim={self.column_dim}]"
            )
        if self.input_dim <= 0 or self.column_dim <= 0:
            raise ValueError("input_dim and column_dim must be positive")
        if self.permanence_dtype not in ("float32", "int16"):
            raise ValueError(
                f"permanence_dtype must be 'float32' or 'int16', got "
                f"{self.permanence_dtype!r}"
            )
        if self.permanence_quantum <= 0:
            raise ValueError("permanence_quantum must be positive")

    @property
    def density(self) -> float:
        return self.active_columns / self.column_dim

    @property
    def quantized(self) -> bool:
        return self.permanence_dtype == "int16"

    def to_units(self, value: float) -> int:
        """Quantize a permanence-scale constant to integer units."""
        q = round(value / self.permanence_quantum)
        if abs(q * self.permanence_quantum - value) >= 1e-9:
            raise ValueError(
                f"{value} is not a multiple of permanence_quantum "
                f"{self.permanence_quantum}"
            )
        return q


@dataclasses.dataclass(frozen=True)
class TMConfig:
    """TemporalMemory hyperparameters (reference `projections.py:205-223`)
    plus the static pool capacities: G segment slots per column, K
    synapse slots per segment, and the per-step list widths Wc (growth
    candidates) and L (growing segments); 0 selects the auto width."""

    column_dim: int
    cell_dim: int
    active_columns: int

    segments_per_column: int = 8
    synapse_capacity: int = 48
    winner_capacity: int = 0
    growth_capacity: int = 0

    permanence_initial: float = 0.21
    permanence_threshold: float = 0.5
    permanence_increment: float = 0.1
    permanence_decrement: float = 0.1
    permanence_punishment: float = 0.01

    segment_activation_threshold: int = 15
    segment_matching_threshold: int = 15
    segment_sampling_synapses: int = 32

    # "evict": a winner cell whose column has no recyclable slot evicts
    # the weakest non-matching mature slot; "reference": the allocation
    # is dropped and counted (see bithtm_tpu/config.py for the full
    # rationale)
    allocation_policy: str = "evict"

    epsilon: float = 1e-8

    def __post_init__(self):
        if not (0 < self.active_columns <= self.column_dim):
            raise ValueError(
                f"active_columns={self.active_columns} must be in "
                f"[1, column_dim={self.column_dim}]"
            )
        if self.cell_dim <= 0 or self.segments_per_column <= 0:
            raise ValueError("cell_dim and segments_per_column must be "
                             "positive")
        if self.segments_per_column > 32:
            # the punished-segment mask is one i32 bit per slot per column
            raise ValueError(
                f"segments_per_column={self.segments_per_column} "
                f"exceeds the supported maximum of 32"
            )
        if self.synapse_capacity <= 0 or \
                self.segment_sampling_synapses <= 0:
            raise ValueError("synapse_capacity and "
                             "segment_sampling_synapses must be positive")
        if self.winner_capacity < 0 or self.growth_capacity < 0:
            raise ValueError("winner_capacity/growth_capacity "
                             "must be >= 0 (0 = auto)")
        if self.synapse_capacity < self.segment_sampling_synapses:
            warnings.warn(
                f"bithtm_tpu_torch: synapse_capacity="
                f"{self.synapse_capacity} < segment_sampling_synapses="
                f"{self.segment_sampling_synapses}: new segments can "
                f"never grow the full sample; growth clips to capacity.",
                stacklevel=3,
            )
        if self.allocation_policy not in ("reference", "evict"):
            raise ValueError(
                f"allocation_policy must be 'reference' or 'evict', got "
                f"{self.allocation_policy!r}"
            )

    @property
    def num_cells(self) -> int:
        return self.column_dim * self.cell_dim

    @property
    def segment_capacity(self) -> int:
        """Total pool slots S = C * G; global slot id = c * G + g."""
        return self.column_dim * self.segments_per_column

    @property
    def cell_words(self) -> int:
        """32-bit words per per-column cell bitmask."""
        return (self.cell_dim + 31) // 32

    @property
    def resolved_winner_capacity(self) -> int:
        """Width Wc of the growth-candidate list (previous winner cells,
        ascending cell id; overflow dropped and counted)."""
        if self.winner_capacity:
            return self.winner_capacity
        return min(self.active_columns * self.cell_dim,
                   max(128, _round_up(2 * self.active_columns, 128)))

    @property
    def resolved_growth_capacity(self) -> int:
        """Width L of the per-step growing-segment list (overflow dropped
        and counted in `tm_dropped_growth_segments`)."""
        if self.growth_capacity:
            return self.growth_capacity
        mult = 5 if self.active_columns >= 128 else 4  # halves of A
        return min(self.active_columns * self.segments_per_column,
                   max(64, _round_up(mult * self.active_columns // 2, 8)))


@dataclasses.dataclass(frozen=True)
class HTMConfig:
    sp: SPConfig
    tm: TMConfig

    @property
    def input_dim(self) -> int:
        return self.sp.input_dim

    @property
    def column_dim(self) -> int:
        return self.sp.column_dim

    @property
    def cell_dim(self) -> int:
        return self.tm.cell_dim


def make_tm_config(column_dim: int, cell_dim: int, active_columns: int,
                   **overrides) -> TMConfig:
    return TMConfig(column_dim=column_dim, cell_dim=cell_dim,
                    active_columns=active_columns, **overrides)


def config_to_dict(cfg: HTMConfig) -> dict:
    """Serialize an HTMConfig (same layout as the JAX package's)."""
    return {
        "sp": dataclasses.asdict(cfg.sp),
        "tm": dataclasses.asdict(cfg.tm),
    }


def config_from_dict(d: dict) -> HTMConfig:
    """Inverse of `config_to_dict`."""
    tm = dict(d["tm"])
    tm.pop("punish_capacity", None)  # knob removed from older configs
    return HTMConfig(sp=SPConfig(**d["sp"]), tm=TMConfig(**tm))


def make_htm_config(input_dim: int, column_dim: int, cell_dim: int,
                    active_columns: int | None = None, *,
                    sp_overrides: dict | None = None,
                    **tm_overrides) -> HTMConfig:
    """active_columns defaults to round(0.02 * column_dim), as in the
    reference (`networks.py:136-137`)."""
    if active_columns is None:
        active_columns = round(column_dim * 0.02)
    sp = SPConfig(input_dim=input_dim, column_dim=column_dim,
                  active_columns=active_columns, **(sp_overrides or {}))
    tm = make_tm_config(column_dim, cell_dim, active_columns,
                        **tm_overrides)
    return HTMConfig(sp=sp, tm=tm)
