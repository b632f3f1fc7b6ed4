"""Compact serving tables: the frozen-graph forward over connected
synapses only.

Counterpart of `bithtm_tpu/ops/serving.py`, batch-native over a leading
stream axis B. While the graph is frozen, only connected synapses (perm
>= threshold) can make a segment active, and when
``segment_matching_threshold <= segment_activation_threshold`` the
matching test is implied by the activation test, so the table keeps one
int32 word per connected synapse,

    word = (presynaptic cell id << 5) | segment slot g     (-1 = empty)

packed per column into `rows` (B, C*M + E, 128): column c owns the M
main rows c*M .. c*M+M-1; the E extension rows at the bottom take the
connected synapses of the rare columns that exceed 128*M, and
``ext_col[b, e]`` names the column that owns extension row e (C =
unused). `serving_counts` gives the per-(column, segment)
connected-active counts and `serving_flags`, which the serving step
calls, their thresholds as the matching word and the prediction words:
each one launch of the `serving_counts` kernel for CUDA tensors, the
plain versions (`serving_counts_ref`, `serving_flags_ref`) for CPU
tensors. The plain versions run the activation pass
(`serving_activation_ref`: one byte per word, g+1 where the cell is
active; the `serving_activation` kernel for a caller of the activation
itself) and decode the counts from it.
"""

from __future__ import annotations

from fractions import Fraction
from typing import NamedTuple

import numpy as np
import torch

from .active_set import (_on_device, cells_active, pack_bits_ref,
                         prediction_words)

SERVING_G_BITS = 5          # segment field of the packed word (G <= 32)
_SERVING_CELL_MAX = 1 << 26  # the cell id must fit bits 5..30


class ServingTable(NamedTuple):
    """Frozen compact serving table of B streams (see the module
    docstring); build it with `make_serving_table`.

    rows:    (B, C*M + E, 128) int32 packed words (-1 = empty)
    ext_col: (B, E) int32 owning column of each extension row (C = unused)
    """

    rows: torch.Tensor
    ext_col: torch.Tensor


def pack_serving_rows(syn_cell, syn_perm, perm_threshold: float,
                      synapses: int, column_dim: int, cell_dim: int,
                      width: int, ext_rows: int) -> ServingTable:
    """The pack of `make_serving_table` at a given main ``width`` (a
    multiple of 128) and ``ext_rows``; every stream's connected synapses
    must fit them (`make_serving_table` sizes both from the state).

    A column's connected slots keep their slot order (a stable sort on
    the slot key); its overflow chunk o (128 words from width + 128*o)
    lands in extension row (chunks of the stream's columns < c) + o."""
    B, C, J = syn_cell.shape
    if C != column_dim or width % 128 or width < 128:
        raise ValueError(f"pack_serving_rows: table of {C} columns for "
                         f"column_dim={column_dim}, width={width} (a "
                         f"positive multiple of 128)")
    if column_dim * cell_dim > _SERVING_CELL_MAX:
        raise ValueError(
            f"serving word packs the cell id into 26 bits; {column_dim} x "
            f"{cell_dim} cells exceed {_SERVING_CELL_MAX}")
    M = width // 128
    dev = syn_cell.device
    slot = torch.arange(J, dtype=torch.int32, device=dev)
    thr = torch.tensor(perm_threshold, dtype=torch.float32)
    conn = (syn_cell >= 0) & (syn_perm >= thr)
    word = torch.where(conn, (syn_cell << SERVING_G_BITS) | (slot // synapses),
                       -1)
    order = torch.sort(torch.where(conn, slot, J), dim=-1, stable=True)[1]
    packed = word.gather(-1, order)                   # connected first
    # overflow chunks a column can hold: its J slots past the main width
    n_chunk = min(ext_rows, max(0, -(-(J - width) // 128)))
    need = width + 128 * n_chunk
    if need > J:
        packed = torch.cat([packed, packed.new_full((B, C, need - J), -1)],
                           -1)
    # contiguous: the kernel reads the rows with 16-byte vector loads
    main = packed[..., :width].reshape(B, C * M, 128).contiguous()
    if ext_rows == 0:
        return ServingTable(main, torch.full((B, 0), column_dim,
                                             dtype=torch.int32, device=dev))

    n_conn = conn.sum(-1, dtype=torch.int32)                      # (B, C)
    n_chunks = (n_conn - width).clamp(min=0).add(127).div(
        128, rounding_mode="floor")
    start = torch.cumsum(n_chunks, -1, dtype=torch.int32) - n_chunks
    o = torch.arange(n_chunk, dtype=torch.int32, device=dev)
    row = start[..., None] + o                                 # (B, C, O)
    used = (o < n_chunks[..., None]) & (row < ext_rows)
    # unused chunks go to a padding row that is sliced off
    dest = torch.where(used, row, ext_rows).reshape(B, C * n_chunk).long()
    chunks = packed[..., width:need].reshape(B, C * n_chunk, 128)
    ext = torch.full((B, ext_rows + 1, 128), -1, dtype=torch.int32,
                     device=dev)
    ext.scatter_(1, dest[..., None].expand(B, C * n_chunk, 128), chunks)
    col = torch.arange(C, dtype=torch.int32, device=dev).repeat_interleave(
        n_chunk).expand(B, C * n_chunk)
    ext_col = torch.full((B, ext_rows + 1), column_dim, dtype=torch.int32,
                         device=dev).scatter_(1, dest, col)
    return ServingTable(torch.cat([main, ext[:, :ext_rows]], 1),
                        ext_col[:, :ext_rows].contiguous())


def _fma_f32(a: np.float32, b: np.float32, c: np.float32) -> np.float32:
    """a*b + c rounded once to float32 (round to nearest, ties to even)."""
    exact = Fraction(float(a)) * Fraction(float(b)) + Fraction(float(c))
    near = np.float32(float(exact))                   # within one ulp
    cands = (np.nextafter(near, np.float32(-np.inf)), near,
             np.nextafter(near, np.float32(np.inf)))
    return min(cands, key=lambda v: (abs(Fraction(float(v)) - exact),
                                     int(np.array(v).view(np.int32)) & 1))


def percentile99(counts: torch.Tensor) -> float:
    """``jnp.percentile(counts.astype(float32), 99.0)`` over all elements,
    bit for bit as the JAX package computes it on the CPU: linear
    interpolation between the two order statistics around q*(n-1), in
    float32, with XLA's folding of (q/100)*(n-1) into q*(0.01*(n-1)) and
    its fused multiply-add of the high term. A p99 that lands on a
    multiple of 128 selects the table's width, so a last-bit difference
    would change the table's shape (ROADMAP fault h)."""
    a = torch.sort(counts.flatten().to(torch.float32)).values
    n = a.numel()
    f32 = np.float32
    qn = f32(99.0) * (f32(0.01) * f32(n - 1))
    low, high = np.floor(qn), np.ceil(qn)
    hw = qn - low
    lw = f32(1.0) - hw
    lv = f32(a[int(min(max(low, 0), n - 1))].item())
    hv = f32(a[int(min(max(high, 0), n - 1))].item())
    return float(_fma_f32(hv, hw, lv * lw))


def make_serving_table(cfg, state_tm) -> ServingTable:
    """Freeze a TM state (`TMConfig`, `TMState` of B streams) into a
    compact serving table.

    The main width is 128*ceil(p99 / 128) of the connected counts of all
    streams and columns together (at least 128); the extension count is
    the largest number of overflow chunks of one stream, rounded up to a
    multiple of 8 (at least 8), or 0 when no column overflows. Requires
    ``segment_matching_threshold <= segment_activation_threshold``:
    otherwise pruning the non-connected synapses would change which
    segments match (use the unpacked serving path)."""
    if cfg.segment_matching_threshold > cfg.segment_activation_threshold:
        raise ValueError(
            "compact serving tables prune non-connected synapses, which "
            "is prediction-exact only when segment_matching_threshold "
            "<= segment_activation_threshold; got "
            f"{cfg.segment_matching_threshold} > "
            f"{cfg.segment_activation_threshold}")
    syn, perm = state_tm.synapse_cell, state_tm.synapse_perm
    thr = torch.tensor(cfg.permanence_threshold, dtype=torch.float32)
    n_conn = ((syn >= 0) & (perm >= thr)).sum(-1, dtype=torch.int32)
    p99 = int(percentile99(n_conn))
    width = 128 * max(1, -(-p99 // 128))
    if int(n_conn.max()) <= width:
        ext = 0
    else:
        chunks = (n_conn - width).clamp(min=0).add(127).div(
            128, rounding_mode="floor")
        ext = int(chunks.sum(-1).max())
        ext = max(8, -(-ext // 8) * 8)
    return pack_serving_rows(syn, perm, cfg.permanence_threshold,
                             cfg.synapse_capacity, cfg.column_dim,
                             cfg.cell_dim, width, ext)


def serving_activation_ref(rows, cols, bits, column_dim: int,
                           cell_dim: int) -> torch.Tensor:
    """Plain version of the `serving_activation` kernel: (B, R, 128)
    words -> uint8, g+1 where the word's presynaptic cell is active,
    else 0 (empty lanes give 0)."""
    live = rows >= 0
    cell = torch.where(live, rows >> SERVING_G_BITS, -1)
    act = cells_active(cell, cols, bits, column_dim, cell_dim) & live
    g = rows & ((1 << SERVING_G_BITS) - 1)
    return torch.where(act, g + 1, 0).to(torch.uint8)


def serving_activation(rows, cols, bits, column_dim: int,
                       cell_dim: int) -> torch.Tensor:
    """The `serving_activation` kernel for CUDA tensors, the plain
    version for CPU tensors."""
    if _on_device("serving_activation", rows) == "cuda":
        from .kernels import serving_activation_cuda

        return serving_activation_cuda(rows, cols, bits, column_dim,
                                       cell_dim)
    return serving_activation_ref(rows, cols, bits, column_dim, cell_dim)


def serving_counts_ref(table: ServingTable, cols, bits, column_dim: int,
                       cell_dim: int, num_segments: int) -> torch.Tensor:
    """Plain version of the `serving_counts` kernel: per-(column,
    segment) connected-active counts of B streams, the whole compact
    forward pass. Returns (B, C, G) int32.

    One activation pass over all R rows, main and extension; then
    count[b, r, g] = |{lanes of row r with value g+1}| (one u8 compare
    per g), the M main rows of a column summed, and the extension rows
    added to their columns with an int32 scatter-add (unused rows, with
    ext_col = C, land in a padding column that is sliced off)."""
    rows, ext_col = table.rows, table.ext_col
    B, R, _ = rows.shape
    E = ext_col.shape[-1]
    C, G = column_dim, num_segments
    M = (R - E) // C
    if C * M + E != R:
        raise ValueError(f"serving table of {R} rows and {E} extension "
                         f"rows does not fit {C} columns")
    act = serving_activation_ref(rows, cols, bits, column_dim, cell_dim)
    # a row's count is at most 128, so it is summed in u8: an int32 sum
    # would first cast each (B, R, 128) compare to int32
    cnt = torch.stack([(act == g + 1).view(torch.uint8).sum(
        -1, dtype=torch.uint8) for g in range(G)], -1).to(torch.int32)
    main = cnt[:, :C * M].reshape(B, C, M, G).sum(2, dtype=torch.int32)
    if E == 0:
        return main
    ext = main.new_zeros((B, C + 1, G)).scatter_add_(
        1, ext_col.long()[..., None].expand(B, E, G), cnt[:, C * M:])
    return main + ext[:, :C]


def serving_counts(table: ServingTable, cols, bits, column_dim: int,
                   cell_dim: int, num_segments: int) -> torch.Tensor:
    """(B, C, G) int32 connected-active counts of a compact serving
    table (arguments as `serving_counts_ref`'s): the `serving_counts`
    kernel's counts form for CUDA tensors, the plain version for CPU
    tensors."""
    args = (cols, bits, column_dim, cell_dim, num_segments)
    if _on_device("serving_counts", table.rows) == "cuda":
        from .kernels import serving_counts_cuda

        return serving_counts_cuda(table.rows, table.ext_col, *args)
    return serving_counts_ref(table, *args)


def serving_flags_ref(table: ServingTable, cols, bits, seg_cell,
                      column_dim: int, cell_dim: int,
                      matching_threshold: int, activation_threshold: int):
    """Plain version of the `serving_counts` kernel's flags form: the
    thresholds of `serving_counts_ref`'s counts as the compact serving
    step reads them. Returns (matching_word (B, C) int32, bit g where
    count >= ``matching_threshold`` (`pack_bits` of the flags, G <= 32);
    prediction (B, W, C) int32, `prediction_words` of the segments with
    count >= ``activation_threshold``, owned by ``seg_cell`` (B, C,
    G))."""
    counts = serving_counts_ref(table, cols, bits, column_dim, cell_dim,
                                seg_cell.shape[-1])
    matching = counts >= matching_threshold
    prediction = prediction_words(seg_cell, counts >= activation_threshold,
                                  cell_dim)
    return pack_bits_ref(matching)[..., 0], prediction


def serving_flags(table: ServingTable, cols, bits, seg_cell,
                  column_dim: int, cell_dim: int, matching_threshold: int,
                  activation_threshold: int):
    """The matching word and prediction words of a compact serving step
    (arguments and results as `serving_flags_ref`'s): one launch of the
    `serving_counts` kernel's flags form for CUDA tensors, the plain
    version for CPU tensors."""
    args = (cols, bits, seg_cell, column_dim, cell_dim, matching_threshold,
            activation_threshold)
    if _on_device("serving_flags", table.rows) == "cuda":
        from .kernels import serving_flags_cuda

        return serving_flags_cuda(table.rows, table.ext_col, *args)
    return serving_flags_ref(table, *args)
