"""Proximal overlap: the SpatialPooler's forward op.

Counterpart of `bithtm_tpu/ops/overlap.py`. The connection matrix is
cached bit-packed as uint8 with the same **strided** mapping (bit j of
word w holds input ``i = j*S + w``), so SP states convert 1:1 between
the packages. The overlap is a popcount of the AND with the packed
input, taken over 32-bit words (S is a multiple of 128 bytes): on a
CUDA tensor the hand-written `sp_overlap` kernel of `ops/kernels.py`
(`csrc/overlap_pass.cu`, which packs the input itself), on a CPU tensor
the plain version beside it (`overlaps_ref`).
"""

from __future__ import annotations

import torch

from .active_set import _on_device
from .bitops import popcount32


def input_words(input_dim: int) -> int:
    """uint8 words per packed input row, rounded up to a multiple of
    128 (the padding bits are always zero)."""
    return max(128, ((input_dim + 7) // 8 + 127) // 128 * 128)


def padded_input_dim(input_dim: int) -> int:
    """Physical width of the SP permanence table: 8 * input_words.
    Lanes >= input_dim sit at the negative rail and never update."""
    return 8 * input_words(input_dim)


def pack_input(bits: torch.Tensor) -> torch.Tensor:
    """(..., I) bool -> (..., S) uint8, strided: bit j of word w holds
    input ``i = j*S + w``."""
    I = bits.shape[-1]
    S = input_words(I)
    out = torch.zeros((*bits.shape[:-1], S), dtype=torch.int32,
                      device=bits.device)
    for j in range((I + S - 1) // S):
        sl = bits[..., j * S:min((j + 1) * S, I)].to(torch.int32)
        out[..., :sl.shape[-1]] |= sl << j
    return out.to(torch.uint8)


def unpack_connected(words: torch.Tensor, input_dim: int) -> torch.Tensor:
    """(..., S) uint8 -> (..., I) bool (inverse of `pack_input`)."""
    shifts = torch.arange(8, dtype=torch.int32, device=words.device)
    expanded = (words.to(torch.int32)[..., None, :] >> shifts[:, None]) & 1
    flat = expanded.reshape(*words.shape[:-1], words.shape[-1] * 8)
    return flat[..., :input_dim] != 0


def overlaps_ref(connected: torch.Tensor, input_bits: torch.Tensor
                 ) -> torch.Tensor:
    """Plain version of the `sp_overlap` kernel: (B, C, S) uint8 packed
    connections x (B, I) bool inputs -> (B, C) int32 overlap counts
    (`projections.py:20`: (weight & input).sum)."""
    x = pack_input(input_bits)                              # (B, S)
    # S is a multiple of 128 bytes, so the rows view as 32-bit words
    anded = (connected.view(torch.int32)
             & x.view(torch.int32)[:, None, :])             # (B, C, S/4)
    return popcount32(anded).sum(-1, dtype=torch.int32)


def overlaps(connected: torch.Tensor, input_bits: torch.Tensor
             ) -> torch.Tensor:
    """(B, C, S) uint8 packed connections x (B, I) bool inputs -> (B, C)
    int32 overlap counts: the `sp_overlap` kernel for CUDA tensors, the
    plain version for CPU tensors."""
    if _on_device("overlaps", connected) == "cuda":
        from .kernels import sp_overlap_cuda

        return sp_overlap_cuda(connected, input_bits)
    return overlaps_ref(connected, input_bits)
