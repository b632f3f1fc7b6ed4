"""The column shard of a model-parallel rank, and the exchanges its step
makes.

A model group of n ranks splits the C columns into n contiguous ranges
of C/n; rank i owns columns [i*C/n, (i+1)*C/n) of every C-indexed leaf
(`parallel/mesh.py` `batched_state_specs`). Everything of a step that is
per column runs on the owner's rows alone. Three things cross the
column axis, and each is one exchange here:

  * the SP's global inhibition takes a top-A over all C boosted
    overlaps: `gather_columns` assembles the (B, C) array in global
    column order, so every rank runs the same stable sort;
  * the TM decides in active-column row space: `rows` gathers the rows
    of the A active columns from their owners, so every rank holds the
    same (B, A, ...) rows and runs the same code on them; `put_rows`
    writes back only the rows a rank owns;
  * the metrics that sum over C: `sum`.

The collectives are `all_reduce` and nothing else, which gloo takes on
CUDA tensors too (two ranks on one card run under gloo; NCCL refuses
two ranks on one device). A gather is a SUM over a zero-filled buffer
in which each rank fills its own part, summed as bytes: x + 0 is x for
every byte, so the bits arrive unchanged, where a float sum would turn
-0.0 into +0.0. A collective that fails raises.
"""

from __future__ import annotations

import collections

import torch
import torch.distributed as dist

_ALIGN = 8  # byte offset of each part in an exchange buffer


class ColumnShard:
    """Rank ``index`` of the ``count`` ranks of the process ``group``
    that split ``column_dim`` columns; this rank owns [lo, hi).
    ``traffic`` counts the bytes of each collective (bytes -> calls)."""

    def __init__(self, group, index: int, count: int, column_dim: int):
        if count < 1 or not 0 <= index < count:
            raise ValueError(f"rank {index} of {count} model ranks")
        if column_dim % count:
            raise ValueError(f"{column_dim} columns do not split into "
                             f"{count} equal shards")
        self.group, self.index, self.count = group, index, count
        self.column_dim = column_dim
        self.width = column_dim // count
        self.lo = index * self.width
        self.hi = self.lo + self.width
        self.traffic: collections.Counter = collections.Counter()

    def _all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        self.traffic[t.numel() * t.element_size()] += 1
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=self.group)
        return t

    def local(self, cols: torch.Tensor):
        """(B, A) global column ids -> ((B, A) int64 local rows, clamped
        into [0, width), (B, A) bool owned here)."""
        rows = cols.long() - self.lo
        owned = (rows >= 0) & (rows < self.width)
        return rows.clamp(0, self.width - 1), owned

    def column_mask(self, cols: torch.Tensor) -> torch.Tensor:
        """`column_mask_from_cols` over this rank's columns: (B, A) global
        ids -> (B, width) bool; ids owned elsewhere land in a padding
        column that is sliced off."""
        rows, owned = self.local(cols)
        out = torch.zeros((cols.shape[0], self.width + 1), dtype=torch.bool,
                          device=cols.device)
        return out.scatter_(1, torch.where(owned, rows, self.width),
                            True)[:, :self.width]

    def sum(self, counts: list[torch.Tensor]) -> list[torch.Tensor]:
        """Sums of per-rank (B,) int32 counts over the group, in one
        collective."""
        return list(self._all_reduce(torch.stack(counts)).unbind(0))

    def exchange(self, parts: list[torch.Tensor]) -> list[torch.Tensor]:
        """Each part is zero but where this rank fills it; returns their
        byte-wise sums over the group (one collective): every part as
        filled by whichever rank filled each byte."""
        sizes = [p.numel() * p.element_size() for p in parts]
        offsets, total = [], 0
        for n in sizes:
            offsets.append(total)
            total += -(-n // _ALIGN) * _ALIGN
        buf = torch.zeros(total, dtype=torch.uint8, device=parts[0].device)
        views = [buf[o:o + n].view(p.dtype).view(p.shape)
                 for p, o, n in zip(parts, offsets, sizes)]
        for v, p in zip(views, parts):
            v.copy_(p)
        self._all_reduce(buf)
        return views

    def gather_columns(self, t: torch.Tensor) -> torch.Tensor:
        """(B, width) this rank's columns -> (B, C) every rank's, in
        global column order."""
        full = t.new_zeros((t.shape[0], self.column_dim))
        full[:, self.lo:self.hi] = t
        return self.exchange([full])[0]

    def rows(self, cols: torch.Tensor, tables: list[torch.Tensor],
             dims: list[int]) -> list[torch.Tensor]:
        """The entries of each local ``tables[i]`` (its column axis at
        ``dims[i]``) at the (B, A) global columns ``cols``, from their
        owners: the column axis becomes A, in one collective."""
        rows, owned = self.local(cols)
        parts = []
        for t, d in zip(tables, dims):
            shape = [1] * t.dim()
            shape[0], shape[d] = cols.shape
            size = list(t.shape)
            size[d] = cols.shape[1]
            got = t.gather(d, rows.view(shape).expand(size))
            parts.append(torch.where(owned.view(shape), got,
                                     torch.zeros((), dtype=t.dtype,
                                                 device=t.device)))
        return self.exchange(parts)

    def put_rows(self, table: torch.Tensor, cols: torch.Tensor,
                 new_rows: torch.Tensor) -> torch.Tensor:
        """Write the (B, A, ...) ``new_rows`` of the columns this rank
        owns into its (B, width, ...) ``table`` in place, in one scatter
        of fixed shape: an entry owned elsewhere writes the stream's
        first owned row again, with that row's new bits, and a stream
        that owns none of its columns writes its row 0 with the bits it
        holds, so that every repeated index carries the same value."""
        rows, owned = self.local(cols)
        B, A = cols.shape
        first = owned.to(torch.int32).argmax(-1, keepdim=True)
        src = torch.where(owned, torch.arange(A, device=cols.device), first)
        any_owned = owned.any(-1, keepdim=True)
        dst = torch.where(any_owned, rows.gather(1, src), 0)
        shape = (B, A, *([1] * (new_rows.dim() - 2)))
        vals = new_rows.gather(1, src.view(shape).expand_as(new_rows))
        vals = torch.where(any_owned.view(B, *([1] * (new_rows.dim() - 1))),
                           vals, table[:, :1].expand_as(new_rows))
        return table.scatter_(1, dst.view(shape).expand_as(new_rows), vals)
