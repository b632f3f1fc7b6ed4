"""Synthetic inputs for checking the forward passes (`table_update`,
`synapse_activation_conn`, `synapse_activation_frozen`,
`serving_activation`) and their CUDA kernels against their plain
versions: made with numpy from a seed, at any shape."""

from __future__ import annotations

import numpy as np
import torch

from .ops.active_set import act_scale, pack_bits
from .ops.serving import SERVING_G_BITS


def table_inputs(seed: int, B: int, C: int, G: int, K: int, D: int, A: int,
                 device="cpu", threshold: float = 0.5) -> dict:
    """A filled (B, C, G*K) synapse table and a (B, A) active set: live
    and free slots, stale dead slots (syn >= 0, perm < 0), permanences
    near 0 that a punishment of 0.01-0.03 kills, targets biased toward
    the active cells, packed previous activity (`act_scale` encoding at
    ``threshold``), and punished segments outside the active columns.

    Returns tensors on ``device``: syn, perm, act_prev, pun_word, cols,
    bits (int32 words) and seg_cell (owners in [0, D], D = none)."""
    rng = np.random.default_rng(seed)
    J, N = G * K, C * D

    def u(*shape):
        return rng.random(shape, dtype=np.float32)

    cols = np.sort(np.argsort(u(B, C), axis=1)[:, :A], axis=1).astype(
        np.int32)
    rows = u(B, A, D) < 0.4
    live = u(B, C, J) < 0.6
    a_idx = rng.integers(0, A, (B, C * J))
    near = (np.take_along_axis(cols, a_idx, 1).reshape(B, C, J) * D
            + rng.integers(0, D, (B, C, J), dtype=np.int32))
    far = rng.integers(0, N, (B, C, J), dtype=np.int32)
    syn = np.where(live, np.where(u(B, C, J) < 0.3, near, far), -1)
    perm = np.where(live, u(B, C, J), np.float32(-1.0))
    perm = np.where(live & (u(B, C, J) < 0.1), u(B, C, J) * 0.02, perm)
    stale = live & (u(B, C, J) < 0.03)
    perm = np.where(stale, np.float32(-0.005), perm).astype(np.float32)
    act = live & (u(B, C, J) < 0.3)
    act_prev = np.where(act, np.where(perm >= threshold,
                                      1 + act_scale(K), 1), 0)
    pun = u(B, C, G) < 0.3
    pun_word = (pun.astype(np.int32) << np.arange(G, dtype=np.int32)).sum(
        -1, dtype=np.int32)
    np.put_along_axis(pun_word, cols.astype(np.int64), 0, axis=1)
    seg_cell = rng.integers(0, D + 1, (B, C, G), dtype=np.int32)
    out = dict(syn=syn.astype(np.int32), perm=perm,
               act_prev=act_prev.astype(np.uint8), pun_word=pun_word,
               cols=cols, seg_cell=seg_cell)
    t = {k: torch.from_numpy(v).to(device) for k, v in out.items()}
    t["bits"] = pack_bits(torch.from_numpy(rows)).to(device)
    return t


def serving_rows(seed: int, B: int, R: int, C: int, D: int, G: int,
                 device="cpu", empty: float = 0.4) -> torch.Tensor:
    """(B, R, 128) int32 compact serving words ``cell << 5 | g`` over C*D
    cells and G segments, with a share ``empty`` of the lanes -1."""
    rng = np.random.default_rng(seed)
    cell = rng.integers(0, C * D, (B, R, 128), dtype=np.int32)
    g = rng.integers(0, G, (B, R, 128), dtype=np.int32)
    words = np.where(rng.random((B, R, 128)) < empty, -1,
                     (cell << SERVING_G_BITS) | g).astype(np.int32)
    return torch.from_numpy(words).to(device)
