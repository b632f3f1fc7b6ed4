"""Model state: dataclasses of tensors with a leading stream axis B.

Counterpart of `bithtm_tpu/state.py`, with the same leaf names, shapes
(plus B) and bit patterns, so states convert 1:1 (`convert.py`). The
JAX package's uint32 bitmask words (`active_bits`, `winner_bits`,
`prediction`) are carried as int32 with the same bits. The state holds
no random key: draws come from a provider (`rng.py`).

The learning step updates the synapse tables in place, as the JAX scan
does with its donated carry.
"""

from __future__ import annotations

import dataclasses

import torch

from .config import HTMConfig, SPConfig, TMConfig
from .ops.active_set import act_dtype
from .ops.overlap import pack_input, padded_input_dim


@dataclasses.dataclass
class SPState:
    """Proximal permanences, their packed connected bits, duty cycles."""

    permanence: torch.Tensor   # (B, C, I_pad) f32, or int16 units; lanes
                               # >= input_dim pinned at the negative rail
    connected: torch.Tensor    # (B, C, S) uint8, strided packing
    duty_cycle: torch.Tensor   # (B, C) f32


@dataclasses.dataclass
class TMState:
    """Per-column synapse pool and recurrent state (see
    `bithtm_tpu/state.py` TMState for the encodings)."""

    synapse_cell: torch.Tensor   # (B, C, G*K) int32, -1 free
    synapse_perm: torch.Tensor   # (B, C, G*K) f32, dead iff < 0
    seg_cell: torch.Tensor       # (B, C, G) int32, D = unallocated
    active_cols: torch.Tensor    # (B, A) int32
    active_bits: torch.Tensor    # (B, A, W) int32 (uint32 bits)
    winner_bits: torch.Tensor    # (B, A, W) int32 (uint32 bits)
    synapse_act: torch.Tensor    # (B, C, G*K) packed activity (u8 at K<=125)
    prediction: torch.Tensor     # (B, W, C) int32 (uint32 bits)
    matching_word: torch.Tensor  # (B, C) int32, bit g = segment g matching
    step: torch.Tensor           # (B,) int32


@dataclasses.dataclass
class HTMState:
    sp: SPState
    tm: TMState

    @property
    def batch(self) -> int:
        return self.tm.step.shape[0]


def sp_init(cfg: SPConfig, batch: int, generator: torch.Generator | None,
            device) -> SPState:
    """Gaussian proximal permanences N(mean, std^2) (`projections.py:16`),
    drawn with ``generator``; quantized to int16 units when configured.
    Padding lanes sit at the rail (-32000 units, or -1e9) and never
    connect."""
    C, I = cfg.column_dim, cfg.input_dim
    perm = torch.randn((batch, C, I), generator=generator, device=device,
                       dtype=torch.float32)
    perm = perm * cfg.permanence_std + cfg.permanence_mean
    pad = padded_input_dim(I) - I
    if cfg.quantized:
        perm = torch.round(perm / cfg.permanence_quantum).to(torch.int16)
        thr = cfg.to_units(cfg.permanence_threshold)
        rail = -32000
    else:
        thr = cfg.permanence_threshold
        rail = -1e9
    if pad:
        perm = torch.cat([perm, perm.new_full((batch, C, pad), rail)], -1)
    return SPState(
        permanence=perm,
        connected=pack_input(perm >= thr),
        duty_cycle=torch.zeros((batch, C), dtype=torch.float32,
                               device=device),
    )


def tm_init(cfg: TMConfig, batch: int, device) -> TMState:
    """Empty pool: no segments, no synapses."""
    C, D, G, K = (cfg.column_dim, cfg.cell_dim, cfg.segments_per_column,
                  cfg.synapse_capacity)
    A, W, B = cfg.active_columns, cfg.cell_words, batch

    def full(shape, value, dtype):
        return torch.full((B, *shape), value, dtype=dtype, device=device)

    return TMState(
        synapse_cell=full((C, G * K), -1, torch.int32),
        synapse_perm=full((C, G * K), -1.0, torch.float32),
        seg_cell=full((C, G), D, torch.int32),
        active_cols=full((A,), 0, torch.int32),
        active_bits=full((A, W), 0, torch.int32),
        winner_bits=full((A, W), 0, torch.int32),
        synapse_act=full((C, G * K), 0, act_dtype(K)),
        prediction=full((W, C), 0, torch.int32),
        matching_word=full((C,), 0, torch.int32),
        step=full((), 0, torch.int32),
    )


def htm_init_batch(cfg: HTMConfig, batch: int,
                   generator: torch.Generator | None = None,
                   device=None) -> HTMState:
    """A batch of independent streams on ``device`` (None: the
    generator's device, else the card); the SP init draws from
    ``generator`` (None: the device's default generator)."""
    if device is None:
        device = generator.device if generator is not None else "cuda"
    return HTMState(sp=sp_init(cfg.sp, batch, generator, device),
                    tm=tm_init(cfg.tm, batch, device))


def htm_init(cfg: HTMConfig, generator: torch.Generator | None = None,
             device=None) -> HTMState:
    """A single stream: `htm_init_batch` at B=1. The port's step is
    batched, so a single stream is a batch of one throughout."""
    return htm_init_batch(cfg, 1, generator, device)

