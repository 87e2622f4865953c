"""Key batching: each partition cut into bounded batches of whole key
groups.

Port of ``spark_rapids_tpu/exec/key_batching.py`` (reference:
GpuKeyBatchingIterator.scala). The reference carries leftover rows between
batches so that a per-key operator (a window) never sees a key straddle two
batches and never holds an unbounded batch. Here, as in the JAX package,
the stream partition is sorted by the keys once (``lexsort`` over
``sort_operands``), the group starts come back to the host, and the cut
points fall on whole groups: each batch ends at the last group start that
keeps it at or under ``target_rows``, and a batch passes the target only
when one group alone does.

What this bounds is the downstream operator's working set per batch. The
batching sort itself holds the whole partition once, as the concatenation
it replaces did.
"""

from __future__ import annotations

from typing import Iterator, List, Optional, Sequence

import numpy as np
import torch

from ..batch import ColumnarBatch, Schema, bucket_capacity
from ..expressions.base import EvalContext, Expression, raw_eval
from .base import UnaryExec
from .basic import bind_all
from .common import (adjacent_equal_ops, concat_batches, gather, lexsort,
                     may_skip_null_lane, slice_batch, sort_operands)


class KeyBatchingExec(UnaryExec):
    """Re-chunk each input partition into batches that hold whole key
    groups and approach ``target_rows``. A downstream operator reads the
    guarantee from ``key_complete_for`` and runs batch by batch instead of
    concatenating the partition."""

    def __init__(self, keys: Sequence[Expression], child,
                 target_rows: int = 1 << 20,
                 ctx: Optional[EvalContext] = None):
        super().__init__(child, ctx)
        self.keys = bind_all(keys, child.output_schema)
        self.target_rows = target_rows

    @property
    def output_schema(self) -> Schema:
        return self.child.output_schema

    @property
    def key_complete_for(self) -> str:
        """The guarantee's identity: every batch holds whole groups of
        these (bound) keys."""
        return repr(list(self.keys))

    def _sort(self, batch: ColumnarBatch):
        """The batch sorted by the keys, and the first row of each group."""
        live = batch.row_mask()
        key_cols = [raw_eval(e, batch, self.ctx) for e in self.keys]
        k = len(key_cols)
        nullable = [not may_skip_null_lane(e) for e in self.keys]
        ops = sort_operands(key_cols, [False] * k, [True] * k, live,
                            nullable)
        perm = lexsort(ops)
        srt = gather(batch, perm, batch.num_rows)
        new_group = live & ~adjacent_equal_ops([w[perm] for w in ops])
        return srt, new_group

    def do_execute_partition(self, p: int) -> Iterator[ColumnarBatch]:
        batches = list(self.child.execute_partition(p))
        if not batches:
            return
        counts = [int(b.num_rows) for b in batches]
        total = sum(counts)
        if total == 0:
            return
        if len(batches) == 1:
            merged = batches[0]
        else:
            merged = concat_batches(batches, bucket_capacity(
                sum(b.capacity for b in batches)))
        del batches
        srt, new_group = self._sort(merged)
        if total <= self.target_rows:
            yield srt
            return
        for lo, hi in zip(*cut_points(new_group, total, self.target_rows)):
            yield slice_batch(srt, lo, hi - lo, bucket_capacity(hi - lo))


def cut_points(new_group: torch.Tensor, total: int, target_rows: int):
    """(starts, ends) of the batches: from each cut, the next is the last
    group start (or ``total``) at most ``target_rows`` rows on, or the next
    group start where a single group passes the target. One host copy of
    the group starts and a binary search per batch."""
    bounds = np.append(
        torch.nonzero(new_group).flatten().cpu().numpy()[1:], total)
    cuts: List[int] = [0]
    while total - cuts[-1] > target_rows:
        c = cuts[-1]
        i = int(np.searchsorted(bounds, c + target_rows, "right")) - 1
        if i < 0 or bounds[i] <= c:
            i = int(np.searchsorted(bounds, c, "right"))
        cuts.append(int(bounds[i]))
    cuts.append(total)
    return cuts[:-1], cuts[1:]
