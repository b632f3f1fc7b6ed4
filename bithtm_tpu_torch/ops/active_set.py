"""Compact active-set encoding and the full-table pass.

Counterpart of `bithtm_tpu/ops/active_set.py`. HTM activates exactly A
columns per step, so the active (and winner) cell sets are carried as

    cols: (B, A) int32     the active column ids
    bits: (B, A, W) int32  per-column cell bitmask (32-bit words), W = ceil(D/32)

Every function takes a leading stream axis B. The full-table pass
(`table_update`, `synapse_activation_conn`, `synapse_activation_frozen`
over a `pack_frozen_table` word table, and the activity-only
`synapse_activation`) asks, for every synapse slot, whether its
presynaptic cell is in that set; on a CUDA tensor it runs the
hand-written kernel of `ops/kernels.py`, on a CPU tensor the plain
version beside it (`table_update_ref`, `synapse_activation_conn_ref`,
`synapse_activation_frozen_ref`, `synapse_activation_ref`). The plain
versions gather from a dense (B, C*D) active-cell mask; the kernels
build the same mask as a bitmap in shared memory. `take_small_table`,
the index -> cell decode of the growth keys above 2^16 cells, and
`seg_counts_packed`, the per-segment count decode of the packed activity
those passes write (with its flags form `seg_counts_flags`, which also
gives the matching word and the prediction words), and `pack_bits`, the
bit pack of a serving step's matching flags, follow the same rule
(`small_table_take` kernel, `take_small_table_ref`; `seg_counts` kernel,
`seg_counts_packed_ref` and `seg_counts_flags_ref`; `pack_bits` kernel,
`pack_bits_ref`).
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.profiling import site
from .bitops import wrap_u32


def cell_words(cell_dim: int) -> int:
    return (cell_dim + 31) // 32


def act_scale(synapses: int) -> int:
    """Scale of the packed activity v = act + scale*conn (conn implies
    act, so v is 0, 1 or 1+scale); scale > synapses, so a per-segment sum
    r = potential + scale*connected decodes exactly. The smallest power
    of two above `synapses`, except synapses+1 where that keeps 1+scale
    within int8 (K=64 gives 65)."""
    s = 1 << synapses.bit_length()
    if s + 1 > 127 and synapses <= 125:
        return synapses + 1
    return s


def act_dtype(synapses: int) -> torch.dtype:
    """uint8 when 1+scale <= 127 (every shipped K), bf16 when the scale
    is bf16-exact, float32 above."""
    scale = act_scale(synapses)
    if 1 + scale <= 127:
        return torch.uint8
    return torch.bfloat16 if scale <= 128 else torch.float32


def pack_act_conn(act: torch.Tensor, conn: torch.Tensor,
                  synapses: int) -> torch.Tensor:
    """(bool act, bool conn) -> packed activity value (see act_scale)."""
    scale = act_scale(synapses)
    v = torch.where(act, torch.where(conn, 1 + scale, 1), 0)
    return v.to(act_dtype(synapses))


def pack_bits_ref(mask: torch.Tensor) -> torch.Tensor:
    """Plain version of the `pack_bits` kernel: (..., D) bool -> (..., W)
    int32 words (bit d of word d//32), an int64 weighted sum."""
    D = mask.shape[-1]
    W = cell_words(D)
    pad = W * 32 - D
    if pad:
        mask = torch.cat([mask, mask.new_zeros((*mask.shape[:-1], pad))],
                         dim=-1)
    m = mask.reshape(*mask.shape[:-1], W, 32).to(torch.int64)
    weights = torch.ones(32, dtype=torch.int64, device=mask.device) << \
        torch.arange(32, device=mask.device)
    return wrap_u32((m * weights).sum(-1))


def pack_bits(mask: torch.Tensor) -> torch.Tensor:
    """(..., D) bool -> (..., W) int32 words (bit d of word d//32): the
    `pack_bits` kernel for CUDA tensors (made contiguous), the plain
    version for CPU tensors."""
    if _on_device("pack_bits", mask) == "cuda":
        from .kernels import pack_bits_cuda

        return pack_bits_cuda(mask.contiguous())
    return pack_bits_ref(mask)


def unpack_bits(bits: torch.Tensor, cell_dim: int) -> torch.Tensor:
    """(..., W) int32 words -> (..., D) bool."""
    W = bits.shape[-1]
    shifts = torch.arange(32, dtype=torch.int32, device=bits.device)
    expanded = (bits[..., None] >> shifts) & 1                 # (..., W, 32)
    flat = expanded.reshape(*bits.shape[:-1], W * 32)
    return flat[..., :cell_dim] != 0


def prediction_words(seg_cell: torch.Tensor, seg_active: torch.Tensor,
                     cell_dim: int) -> torch.Tensor:
    """(B, C, G) owner cells + active flags -> (B, W, C) int32 packed
    per-cell prediction: bit d of word [b, w, c] is set iff some active
    segment of column c is owned by cell w*32 + d. The unallocated
    owner (seg_cell == cell_dim) never lands in a word. torch has no OR
    reduction, so the segment axis is OR-ed in a loop over G."""
    G = seg_cell.shape[-1]
    words = []
    for w in range(cell_words(cell_dim)):
        upper = min(32 * (w + 1), cell_dim)
        in_w = seg_active & (seg_cell >= 32 * w) & (seg_cell < upper)
        sft = (seg_cell - 32 * w).clamp(0, 31).to(torch.int64)
        bit = torch.where(in_w, torch.ones_like(sft) << sft, 0)
        acc = bit[..., 0]
        for g in range(1, G):
            acc = acc | bit[..., g]
        words.append(wrap_u32(acc))
    return torch.stack(words, dim=-2)


def prediction_dense(pred_words: torch.Tensor, cell_dim: int
                     ) -> torch.Tensor:
    """(..., W, C) packed prediction -> (..., C, D) dense bool."""
    return unpack_bits(pred_words.transpose(-1, -2), cell_dim)


def _host_u32(words) -> np.ndarray:
    """Host words as uint32: the port's int32 words (and a CPU tensor's)
    viewed with the same bits."""
    if isinstance(words, torch.Tensor):
        words = words.detach().cpu().numpy()
    words = np.asarray(words)
    return words.view(np.uint32) if words.dtype == np.int32 else words


def prediction_dense_host(pred_words, cell_dim: int) -> np.ndarray:
    """NumPy form of `prediction_dense` for host-side readers (the oracle
    bridge, the state checks): (..., W, C) words -> (..., C, D) bool."""
    words = _host_u32(pred_words)                      # (..., W, C)
    d = np.arange(cell_dim)
    sel = np.take(words, d // 32, axis=-2)             # (..., D, C)
    dense = (sel >> (d % 32).astype(np.uint32)[..., :, None]) & 1
    return np.swapaxes(dense, -1, -2).astype(bool)     # (..., C, D)


def matching_dense_host(matching_word, segments_per_column: int
                        ) -> np.ndarray:
    """NumPy form: (..., C) packed matching word -> (..., C, G) dense
    bool (bit g = segment g matching). The one host-side decoder of the
    carried `matching_word` (the oracle bridge and the state checks)."""
    word = _host_u32(matching_word)
    g = np.arange(segments_per_column).astype(np.uint32)
    return ((word[..., :, None] >> g) & 1) != 0


def dense_from_compact(cols: torch.Tensor, bits: torch.Tensor,
                       column_dim: int, cell_dim: int) -> torch.Tensor:
    """Compact (B, A) cols + (B, A, W) bits -> dense (B, C, D) bool."""
    rows = unpack_bits(bits, cell_dim)                          # (B, A, D)
    out = rows.new_zeros((rows.shape[0], column_dim, cell_dim))
    return out.scatter_(1, cols.long()[..., None].expand_as(rows), rows)


def column_mask_from_cols(cols: torch.Tensor, column_dim: int
                          ) -> torch.Tensor:
    """(..., A) column ids -> (..., C) bool mask."""
    out = torch.zeros((*cols.shape[:-1], column_dim), dtype=torch.bool,
                      device=cols.device)
    return out.scatter_(-1, cols.long(), True)


def active_cell_mask(cols: torch.Tensor, bits: torch.Tensor,
                     column_dim: int, cell_dim: int) -> torch.Tensor:
    """Compact (B, A) cols + (B, A, W) bits -> dense (B, C*D) bool mask
    of active cells, indexed by global cell id c*D + d."""
    return dense_from_compact(cols, bits, column_dim, cell_dim).reshape(
        cols.shape[0], column_dim * cell_dim)


def cells_active(cell: torch.Tensor, cols, bits, column_dim: int,
                 cell_dim: int) -> torch.Tensor:
    """(B, ...) cell ids -> bool of the same shape: the cell is in the
    stream's (cols, bits) active set over ``column_dim`` columns. Ids
    outside [0, C*D) are not. Every caller names the width: the table's
    rows for a whole table, the global column count for a column shard."""
    N = column_dim * cell_dim
    mask = active_cell_mask(cols, bits, column_dim, cell_dim)
    idx = cell.clamp(0, N - 1).reshape(cell.shape[0], -1).long()
    hit = mask.gather(1, idx).reshape(cell.shape)
    return hit & (cell >= 0) & (cell < N)


def _slot_active(syn: torch.Tensor, perm: torch.Tensor, cols, bits,
                 cell_dim: int, column_dim: int | None = None
                 ) -> torch.Tensor:
    """act[b, c, j]: slot is live (syn >= 0, perm >= 0) and its
    presynaptic cell is in the (cols, bits) active set of ``column_dim``
    columns (default: the table's own rows, syn.shape[1]; a column shard
    passes the global column count, since its synapses target cells of
    every shard)."""
    width = syn.shape[1] if column_dim is None else column_dim
    return cells_active(syn, cols, bits, width, cell_dim) & (perm >= 0.0)


def _into(out, v: torch.Tensor) -> torch.Tensor:
    """``v`` written into ``out`` (a state's activity buffer), or ``v``
    itself where there is none."""
    return v if out is None else out.copy_(v)


def synapse_activation_conn_ref(syn, perm, cols, bits, cell_dim: int,
                                perm_threshold: float, synapses: int,
                                column_dim: int | None = None, out=None
                                ) -> torch.Tensor:
    """Plain version of the `act_conn` kernel: packed activity
    v = act + scale*(perm >= threshold) over a read-only table, whose
    presynaptic cells lie in ``column_dim`` columns (`_slot_active`),
    written into ``out`` where given."""
    thr = torch.tensor(perm_threshold, dtype=torch.float32)
    act = _slot_active(syn, perm, cols, bits, cell_dim, column_dim)
    return _into(out, pack_act_conn(act, perm >= thr, synapses))


def table_update_ref(syn, perm, act_prev, pun_word, cols, bits,
                     cell_dim: int, synapses: int, punishment: float,
                     perm_threshold: float,
                     column_dim: int | None = None) -> torch.Tensor:
    """Plain version of the `table_update` kernel. Punishes in place:
    perm -= punishment where bit g = j // K of the column's ``pun_word``
    is set and ``act_prev != 0``; then writes the packed activity of the
    punished table over ``column_dim`` columns (`_slot_active`) over
    ``act_prev``, in place, and returns it. A slot is dead iff perm < 0,
    so a slot the punishment kills drops out of the activity without a
    syn write."""
    J = syn.shape[-1]
    g_lane = torch.arange(J, device=syn.device) // synapses
    pen = (((pun_word[:, :, None] >> g_lane) & 1) == 1) & (act_prev != 0)
    pun = torch.tensor(punishment, dtype=torch.float32)
    perm.copy_(torch.where(pen, perm - pun, perm))
    return synapse_activation_conn_ref(syn, perm, cols, bits, cell_dim,
                                       perm_threshold, synapses, column_dim,
                                       out=act_prev)


def _on_device(name: str, t: torch.Tensor) -> str:
    if t.device.type not in ("cpu", "cuda"):
        raise RuntimeError(
            f"{name}: tensors on {t.device} are not supported; the plain "
            f"version runs on the CPU and the kernel on CUDA")
    return t.device.type


def synapse_activation_conn(syn, perm, cols, bits, cell_dim: int,
                            perm_threshold: float, synapses: int,
                            column_dim: int | None = None, out=None
                            ) -> torch.Tensor:
    """Activation + connected activity over a frozen table (the
    inference forward): the `act_conn` kernel for CUDA tensors, the
    plain version for CPU tensors. ``column_dim`` (default: the table's
    rows) is the column count of the cell space, for a column shard;
    ``out``, where given, receives the activity (the step passes its
    state's buffer)."""
    args = (syn, perm, cols, bits, cell_dim, perm_threshold, synapses,
            column_dim, out)
    if _on_device("synapse_activation_conn", syn) == "cuda":
        from .kernels import act_conn_cuda

        return act_conn_cuda(*args)
    return synapse_activation_conn_ref(*args)


def synapse_activation_ref(syn, cols, bits, column_dim: int,
                           cell_dim: int) -> torch.Tensor:
    """Plain version of the `synapse_activation` kernel: (B, R, J) u8, 1
    where the slot's presynaptic cell is in the (cols, bits) active set;
    free slots (< 0) and ids outside [0, C*D) are not. Activity only, no
    permanence (JAX `synapse_activation_xla`, which returns bool, and
    its Pallas kernel, bf16 0/1)."""
    return cells_active(syn, cols, bits, column_dim, cell_dim).to(
        torch.uint8)


def synapse_activation(syn, cols, bits, column_dim: int,
                       cell_dim: int) -> torch.Tensor:
    """The activity-only 0/1 mask of every slot of a (B, R, J) synapse
    cell table: the `synapse_activation` kernel for CUDA tensors, the
    plain version for CPU tensors."""
    if _on_device("synapse_activation", syn) == "cuda":
        from .kernels import synapse_activation_cuda

        return synapse_activation_cuda(syn, cols, bits, column_dim,
                                       cell_dim)
    return synapse_activation_ref(syn, cols, bits, column_dim, cell_dim)


def take_small_table_ref(table: torch.Tensor, keys: torch.Tensor,
                         mask: int = -1, in_place: bool = False
                         ) -> torch.Tensor:
    """Plain version of the `small_table_take` kernel: out[b, ...] =
    table[b, k] with k = keys[b, ...] & mask, for table (B, Wc) and keys
    (B, ...) int32, 0 where k is outside [0, Wc) (as JAX
    `take_small_table(table, keys & mask)`'s compare-select-reduce and
    its zero-padded Pallas chunks give). ``mask`` -1 takes the keys as
    indices; ``in_place`` writes the result over ``keys``."""
    B, Wc = table.shape
    flat = keys.reshape(B, -1)
    if mask != -1:
        flat = flat & mask
    got = table.gather(1, flat.clamp(0, Wc - 1).long())
    res = torch.where((flat >= 0) & (flat < Wc), got, 0).reshape(keys.shape)
    return keys.copy_(res) if in_place else res


def take_small_table(table: torch.Tensor, keys: torch.Tensor,
                     mask: int = -1, in_place: bool = False
                     ) -> torch.Tensor:
    """Per-stream lookup in a shared table (B, Wc) of any width at the
    indices ``keys & mask``: the `small_table_take` kernel for CUDA
    tensors, the plain version for CPU tensors. Out-of-range indices
    give 0. ``in_place`` decodes over ``keys``."""
    if _on_device("take_small_table", table) == "cuda":
        from .kernels import small_table_take_cuda

        return small_table_take_cuda(table, keys, mask, in_place)
    return take_small_table_ref(table, keys, mask, in_place)


FROZEN_CELL_BITS = 24  # cell id field of the frozen serving word


def frozen_word_supported(column_dim: int, cell_dim: int) -> bool:
    """The frozen word packs the cell id into 24 bits."""
    return column_dim * cell_dim <= (1 << FROZEN_CELL_BITS)


def pack_frozen_table(syn_cell: torch.Tensor, syn_perm: torch.Tensor,
                      perm_threshold: float,
                      num_cells: int | None = None) -> torch.Tensor:
    """Pack a frozen (read-only) distal table for serving: one int32 per
    slot, cell id (bits 0-23) | connected (bit 24, perm >= threshold),
    -1 where the slot is dead or free (syn < 0 or perm < 0). While the
    graph is frozen the permanence compare does not change, so the
    forward pass reads 4 B a slot instead of syn + perm's 8.
    Elementwise: any leading axes.

    Cell ids must fit the 24-bit field: with ``num_cells`` (= C*D) the
    geometry is checked, without it the table's largest id."""
    limit = 1 << FROZEN_CELL_BITS
    if num_cells is not None:
        if num_cells > limit:
            raise ValueError(
                f"pack_frozen_table: num_cells={num_cells} exceeds the "
                f"frozen word's {FROZEN_CELL_BITS}-bit cell-id field (max "
                f"{limit}); the packed table would corrupt the connected "
                f"bit — use the unpacked serving path for this geometry")
    else:
        max_id = int(syn_cell.max()) if syn_cell.numel() else -1
        if max_id >= limit:
            raise ValueError(
                f"pack_frozen_table: cell id {max_id} exceeds the "
                f"{FROZEN_CELL_BITS}-bit field (max {limit - 1}); the packed "
                f"table would corrupt the connected bit — use the unpacked "
                f"serving path for this geometry")
    thr = torch.tensor(perm_threshold, dtype=torch.float32)
    live = (syn_cell >= 0) & (syn_perm >= 0.0)
    conn = (syn_perm >= thr).to(torch.int32)
    return torch.where(live, syn_cell | (conn << FROZEN_CELL_BITS), -1)


def synapse_activation_frozen_ref(frozen_word, cols, bits, cell_dim: int,
                                  synapses: int, out=None) -> torch.Tensor:
    """Plain version of the `act_frozen` kernel: the packed activity of
    `synapse_activation_conn_ref` over a `pack_frozen_table` word table
    (bit-equal to it on the table the words were packed from), written
    into ``out`` where given."""
    live = frozen_word >= 0
    cell = torch.where(live, frozen_word & ((1 << FROZEN_CELL_BITS) - 1), -1)
    # the cell space of the table's own rows: a frozen table is whole,
    # never a column shard
    act = cells_active(cell, cols, bits, frozen_word.shape[1], cell_dim)
    conn = (frozen_word >> FROZEN_CELL_BITS) == 1
    return _into(out, pack_act_conn(act & live, conn, synapses))


def synapse_activation_frozen(frozen_word, cols, bits, cell_dim: int,
                              synapses: int, out=None) -> torch.Tensor:
    """The inference forward over a frozen word table: the `act_frozen`
    kernel for CUDA tensors, the plain version for CPU tensors; ``out``
    as for `synapse_activation_conn`."""
    args = (frozen_word, cols, bits, cell_dim, synapses, out)
    if _on_device("synapse_activation_frozen", frozen_word) == "cuda":
        from .kernels import act_frozen_cuda

        return act_frozen_cuda(*args)
    return synapse_activation_frozen_ref(*args)


def _table_pass(syn, perm, act_prev, pun_word, cols, bits, cell_dim: int,
                synapses: int, punishment: float, perm_threshold: float,
                column_dim: int | None):
    """The `table_update` kernel for CUDA tensors, its plain version for
    CPU tensors: punishes ``perm`` in place, writes the packed activity
    over ``act_prev`` and returns it."""
    args = (syn, perm, act_prev, pun_word, cols, bits, cell_dim, synapses,
            punishment, perm_threshold, column_dim)
    with site("tm_step.table_pass"):
        if _on_device("table_update", syn) == "cuda":
            from .kernels import table_update_cuda

            return table_update_cuda(*args)
        return table_update_ref(*args)


def table_update(syn, perm, act_prev, pun_word, cols, bits, seg_cell,
                 cell_dim: int, punishment: float, perm_threshold: float,
                 matching_threshold: int, activation_threshold: int,
                 column_dim: int | None = None):
    """The full-table part of a learning TM step (JAX `table_update_xla`):
    punishment + implicit death + activation (the `table_update` kernel
    for CUDA tensors, the plain version for CPU tensors; perm is updated
    in place and the new activity is written over ``act_prev``, which
    the step's state holds), then the flags form of the count decode
    (`seg_counts_flags`), which gives the matching word and the
    prediction words in its own pass. JAX's per-segment leaves are
    functions of these: potential and connected are `seg_counts_packed`
    of the activity, matching the bits of the matching word. Every
    output is per row, so a column shard of the tables gives its rows of
    the whole-table result when ``column_dim`` names the global column
    count (default: the table's rows).

    Returns (perm', act packed (``act_prev`` itself), matching_word (B,
    C), prediction (B, W, C))."""
    G = seg_cell.shape[-1]
    K = syn.shape[-1] // G
    act = _table_pass(syn, perm, act_prev, pun_word, cols, bits, cell_dim, K,
                      punishment, perm_threshold, column_dim)
    with site("tm_step.count_decode"):
        word, prediction = seg_counts_flags(
            act, seg_cell, K, matching_threshold, activation_threshold,
            cell_dim)
    return perm, act, word, prediction


def seg_counts_packed_ref(packed: torch.Tensor, num_segments: int,
                          synapses: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the `seg_counts` kernel: (B, C, G*K) packed
    activity -> (potential, connected) int32 (B, C, G) per-segment
    counts, a (B, C, G, K) reshape-sum decoded exactly."""
    B, C, _ = packed.shape
    return seg_counts_packed_rows(
        packed.reshape(B, C, num_segments, synapses), synapses)


def seg_counts_packed(packed: torch.Tensor, num_segments: int,
                      synapses: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, C, G*K) packed activity -> (potential, connected) int32 (B, C,
    G) per-segment counts: the `seg_counts` kernel for CUDA tensors, the
    plain version for CPU tensors. The step reads only the counts'
    thresholds (`seg_counts_flags`); this is the decode for a caller that
    reads the counts themselves, such as a `distal_forward` hook of
    `tm_step`, which returns them."""
    if _on_device("seg_counts_packed", packed) == "cuda":
        from .kernels import seg_counts_cuda

        return seg_counts_cuda(packed, num_segments, synapses)
    return seg_counts_packed_ref(packed, num_segments, synapses)


def seg_counts_flags_ref(packed: torch.Tensor, seg_cell: torch.Tensor,
                         synapses: int, matching_threshold: int,
                         activation_threshold: int, cell_dim: int,
                         prediction: bool = True):
    """Plain version of the `seg_counts` kernel's flags form: the
    thresholds of the counts of the (B, C, G*K) packed activity
    (`seg_counts_packed_ref`), as the matching word (`pack_bits` of
    potential >= ``matching_threshold``) and the prediction words
    (`prediction_words` of the segments that match and have connected >=
    ``activation_threshold``, owned by ``seg_cell`` (B, C, G)). Returns
    (matching_word (B, C), prediction (B, W, C)), the prediction only
    with ``prediction`` (else None)."""
    G = seg_cell.shape[-1]
    potential, connected = seg_counts_packed_ref(packed, G, synapses)
    matching = potential >= matching_threshold
    pred = None
    if prediction:
        seg_active = matching & (connected >= activation_threshold)
        pred = prediction_words(seg_cell, seg_active, cell_dim)
    return pack_bits_ref(matching)[..., 0], pred


def seg_counts_flags(packed: torch.Tensor, seg_cell: torch.Tensor,
                     synapses: int, matching_threshold: int,
                     activation_threshold: int, cell_dim: int,
                     prediction: bool = True):
    """The flags form of the count decode: the `seg_counts` kernel for
    CUDA tensors, the plain version for CPU tensors (arguments and
    results as `seg_counts_flags_ref`'s)."""
    args = (packed, seg_cell, synapses, matching_threshold,
            activation_threshold, cell_dim, prediction)
    if _on_device("seg_counts_flags", packed) == "cuda":
        from .kernels import seg_flags_cuda

        return seg_flags_cuda(*args)
    return seg_counts_flags_ref(*args)


def seg_counts_packed_rows(act_rows: torch.Tensor, synapses: int
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """(..., K) packed activity rows -> (potential, connected) int32."""
    scale = act_scale(synapses)
    r = act_rows.to(torch.int32).sum(-1, dtype=torch.int32)
    connected = r // scale
    return r - scale * connected, connected


def compact_first_k(valid: torch.Tensor, values: torch.Tensor, k: int
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per row, the first k ``values[valid]`` in index order. Returns
    (out (B, k), out_valid (B, k)); out is 0 past the valid count.
    Entries past k land in a padding column that is sliced off."""
    B = valid.shape[0]
    rank = rank_ascending(valid)
    pos = torch.where(valid & (rank < k), rank, k).long()
    out = values.new_zeros((B, k + 1)).scatter_(1, pos, values)[:, :k]
    n = valid.sum(-1, dtype=torch.int32, keepdim=True)
    out_valid = torch.arange(k, device=valid.device) < n
    return out, out_valid


# ---- per-cell reductions over the segment axis. seg_cell holds the
# owner cell within its column; cell_dim marks an unallocated slot.


def percell_max(seg_cell: torch.Tensor, values: torch.Tensor,
                cell_dim: int, init) -> torch.Tensor:
    """(..., G) owners + (..., G) values -> (..., D) per-cell max."""
    d = torch.arange(cell_dim, device=seg_cell.device)
    onehot = seg_cell[..., None] == d                          # (..., G, D)
    return torch.where(onehot, values[..., None], init).amax(-2)


def percell_sum(seg_cell: torch.Tensor, values: torch.Tensor,
                cell_dim: int) -> torch.Tensor:
    """(..., G) owners + (..., G) values -> (..., D) per-cell sum."""
    d = torch.arange(cell_dim, device=seg_cell.device)
    onehot = seg_cell[..., None] == d
    return torch.where(onehot, values[..., None], 0).sum(-2,
                                                          dtype=values.dtype)


def take_percell(values: torch.Tensor, seg_cell: torch.Tensor,
                 cell_dim: int, fill) -> torch.Tensor:
    """values (..., D) at owners seg_cell (..., G) -> (..., G); the
    unallocated owner yields ``fill``."""
    picked = values.gather(-1, seg_cell.clamp(0, cell_dim - 1).long())
    return torch.where(seg_cell < cell_dim, picked, fill)


def rank_ascending(mask: torch.Tensor) -> torch.Tensor:
    """0-based rank of each True among Trues along the last axis."""
    return torch.cumsum(mask.to(torch.int32), dim=-1,
                        dtype=torch.int32) - 1


def argmax_onehot(values: torch.Tensor) -> torch.Tensor:
    """One-hot of the first argmax along the last axis."""
    idx = torch.argmax(values, dim=-1)
    d = torch.arange(values.shape[-1], device=values.device)
    return d == idx[..., None]
