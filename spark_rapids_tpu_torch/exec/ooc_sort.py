"""Out-of-core sort: spilled sorted runs and a bounded chunked merge.

Port of ``spark_rapids_tpu/exec/ooc_sort.py`` (``_Run``,
``OutOfCoreSorter``, ``_lex_min``). Each input batch is sorted and kept as
a run of fixed-size chunks in the spill catalog. Two runs merge chunk at a
time: concatenate the carried remainder with the next chunk of each run,
sort, and emit only the rows that sort at or below the smaller of the two
chunks' maxima, which no later chunk can displace; the rest is carried.
Peak device residency per merge is a few chunks whatever the run sizes;
log2(runs) passes. The carried remainder is cut to its row-count bucket
before the next step; the JAX package carries it at the capacity of the
merged batch, which doubles at every step of a merge.

The emit test compares the rows' sort operands (``exec/common.sort_operands``
without its liveness operand) word by word against the bound's. Those
tensors are what ``lexsort`` orders by, under torch's own comparison of
each operand (uint8 ranks, int32/int64 words, NaN-free float64 words with
descending keys negated or complemented, null rows zeroed behind their
rank), so the test and the sort agree on every order, direction and null
placement.
"""

from __future__ import annotations

from typing import Iterator, List, Optional, Sequence

import torch

from ..batch import ColumnarBatch, Schema, bucket_capacity
from ..memory import (BufferCatalog, SpillableBatch, acquire_with_retry,
                      register_with_retry)
from .common import compact, concat_batches, slice_batch, sort_operands
from .sort import SortOrder, sort_batch


class _Run:
    """A sorted run stored as spillable fixed-size chunks."""

    def __init__(self, catalog: BufferCatalog, schema: Schema):
        self.catalog = catalog
        self.schema = schema
        self.chunks: List[SpillableBatch] = []

    def append(self, batch: ColumnarBatch) -> None:
        # a registered handle starts unpinned (spillable); the registration
        # runs under the OOM retry loop
        self.chunks.append(register_with_retry(
            batch, self.schema, catalog=self.catalog, name="ooc_sort.run"))

    def close(self) -> None:
        for c in self.chunks:
            c.close()
        self.chunks = []


class OutOfCoreSorter:
    """Sorts any number of rows through a bounded device footprint."""

    def __init__(self, orders: Sequence[SortOrder], schema: Schema,
                 catalog: BufferCatalog, chunk_rows: int = 1 << 16):
        self.orders = list(orders)
        self.schema = schema
        self.catalog = catalog
        self.chunk_rows = chunk_rows

    # ------------------------------------------------------------------

    def _key_ops(self, batch: ColumnarBatch) -> List[torch.Tensor]:
        """The rows' sort operands, without the liveness operand."""
        cols = [o.child.eval(batch) for o in self.orders]
        return sort_operands(cols, [o.descending for o in self.orders],
                             [o.effective_nulls_first for o in self.orders],
                             batch.row_mask())[1:]

    def _key_rank_last(self, batch: ColumnarBatch) -> List[torch.Tensor]:
        """The operands of the last live row of a sorted batch (its largest
        key), as 0-d tensors on the device."""
        last = (batch.num_rows.to(torch.int64) - 1).clamp(min=0)
        return [op[last] for op in self._key_ops(batch)]

    def _split_kernel(self, merged: ColumnarBatch,
                      bound_words: Sequence[torch.Tensor]):
        """(emit, keep): the rows whose key sorts at or below the bound (they
        are globally placed) and the rest, each compacted in order."""
        cap, dev = merged.capacity, merged.device
        gt = torch.zeros(cap, dtype=torch.bool, device=dev)
        decided = torch.zeros(cap, dtype=torch.bool, device=dev)
        for op, bw in zip(self._key_ops(merged), bound_words):
            gt = gt | (~decided & (op > bw))
            decided = decided | (op != bw)
        live = merged.row_mask()
        return compact(merged, ~gt & live), compact(merged, gt & live)

    # ------------------------------------------------------------------

    def _append_chunked(self, run: _Run, batch: ColumnarBatch) -> None:
        """Re-chunk to ``chunk_rows`` so merge working sets stay bounded at
        every level of the tree."""
        cap = bucket_capacity(self.chunk_rows)
        if batch.capacity <= cap:
            run.append(batch)
            return
        n = int(batch.num_rows)
        for off in range(0, max(n, 1), cap):
            run.append(slice_batch(batch, off, cap, cap))

    def _sort(self, batch: ColumnarBatch) -> ColumnarBatch:
        return sort_batch(batch, self.orders)

    def make_run(self, batches: Iterator[ColumnarBatch]) -> List[_Run]:
        """Phase 1: sort each batch and keep it as a spillable run."""
        runs: List[_Run] = []
        for b in batches:
            run = _Run(self.catalog, self.schema)
            self._append_chunked(run, self._sort(b))
            runs.append(run)
        return runs

    def merge_two(self, a: _Run, b: _Run) -> _Run:
        """Chunked two-way merge with bounded device residency."""
        out = _Run(self.catalog, self.schema)
        ai = bi = 0
        buf: Optional[ColumnarBatch] = None   # carried unsafe remainder
        while ai < len(a.chunks) or bi < len(b.chunks):
            pieces = [buf] if buf is not None else []
            bounds = []
            if ai < len(a.chunks):
                ca = acquire_with_retry(a.chunks[ai], name="ooc_sort.merge")
                a.chunks[ai].done_with()
                ai += 1
                pieces.append(ca)
                bounds.append((self._key_rank_last(ca), ai >= len(a.chunks)))
            if bi < len(b.chunks):
                cb = acquire_with_retry(b.chunks[bi], name="ooc_sort.merge")
                b.chunks[bi].done_with()
                bi += 1
                pieces.append(cb)
                bounds.append((self._key_rank_last(cb), bi >= len(b.chunks)))
            cap = bucket_capacity(sum(p.capacity for p in pieces))
            merged = self._sort(concat_batches(pieces, cap)
                                if len(pieces) > 1 else pieces[0])
            if ai >= len(a.chunks) and bi >= len(b.chunks):
                self._append_chunked(out, merged)
                buf = None
                break
            # the safe bound: the smallest loaded chunk maximum among the
            # runs that still have chunks to load
            live_bounds = [words for words, exhausted in bounds
                           if not exhausted]
            if not live_bounds:
                self._append_chunked(out, merged)
                buf = None
                continue
            bound = live_bounds[0]
            for w in live_bounds[1:]:
                bound = _lex_min(bound, w)
            emit, keep = self._split_kernel(merged, bound)
            if int(emit.num_rows) > 0:
                self._append_chunked(out, emit)
            kept = int(keep.num_rows)
            # the carried rows at their own bucket: compaction keeps the
            # merged capacity, which would double with every step
            buf = (slice_batch(keep, 0, kept, bucket_capacity(kept))
                   if kept else None)
        if buf is not None:
            self._append_chunked(out, buf)
        a.close()
        b.close()
        return out

    def sort(self, batches: Iterator[ColumnarBatch]
             ) -> Iterator[ColumnarBatch]:
        """The rows of ``batches`` in order, one chunk at a time."""
        runs = self.make_run(batches)
        if not runs:
            return
        try:
            while len(runs) > 1:
                nxt: List[_Run] = []
                for i in range(0, len(runs) - 1, 2):
                    nxt.append(self.merge_two(runs[i], runs[i + 1]))
                if len(runs) % 2:
                    nxt.append(runs[-1])
                runs = nxt
            for sb in runs[0].chunks:
                yield acquire_with_retry(sb, name="ooc_sort.emit")
                sb.done_with()
        finally:
            for run in runs:
                run.close()


def _lex_min(a: Sequence[torch.Tensor],
             b: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Lexicographic minimum of two operand tuples (0-d tensors)."""
    a_lt = torch.zeros((), dtype=torch.bool, device=a[0].device)
    decided = torch.zeros_like(a_lt)
    for x, y in zip(a, b):
        a_lt = a_lt | (~decided & (x < y))
        decided = decided | (x != y)
    return [torch.where(a_lt, x, y) for x, y in zip(a, b)]
