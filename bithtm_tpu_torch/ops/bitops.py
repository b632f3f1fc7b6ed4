"""Bit operations torch lacks: popcount, logical shifts, u32 wrapping.

The JAX package keeps bitmask words as uint32. torch has no uint32
shift on the CPU and no popcount, so the port carries those words as
int32 with the same bit pattern and does its bit arithmetic here.
"""

from __future__ import annotations

import torch

_POPCOUNT_U8 = torch.tensor([bin(i).count("1") for i in range(256)],
                            dtype=torch.int32)


def popcount_u8(x: torch.Tensor) -> torch.Tensor:
    """Per-byte popcount of a uint8 tensor (256-entry lookup) -> int32."""
    if x.dtype != torch.uint8:
        raise TypeError(f"popcount_u8 takes uint8, got {x.dtype}")
    return _POPCOUNT_U8.to(x.device)[x.long()]


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Per-word popcount of an int32 tensor holding 32-bit words (SWAR)
    -> int32 in [0, 32]. Runs on the words' unsigned value in int64, so
    no step can overflow a signed type."""
    if x.dtype != torch.int32:
        raise TypeError(f"popcount32 takes int32 words, got {x.dtype}")
    x = x.long() & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    x = x + (x >> 8)
    x = x + (x >> 16)
    return (x & 0x3F).to(torch.int32)


def lsr32(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int32-carried 32-bit words by 0 <= s < 32."""
    if not 0 <= s < 32:
        raise ValueError(f"shift {s} out of [0, 32)")
    if s == 0:
        return x
    return (x >> s) & ((1 << (32 - s)) - 1)


def wrap_u32(x: torch.Tensor) -> torch.Tensor:
    """int64 values (any range) -> int32 carrying their low 32 bits, as
    a uint32 sum that wraps would give."""
    x = x & 0xFFFFFFFF
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)
