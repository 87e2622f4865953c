"""Partitionings: hash, round robin, single and range.

Port of ``spark_rapids_tpu/shuffle/partitioning.py``. HashPartitioning must
give ``pmod(murmur3(row, seed=42), n)`` bit-exactly, or a mixed cluster would
route the same key to different reducers. RangePartitioning routes each row
by its sort key against ``num_partitions - 1`` bound rows that the exchange
samples from its materialized input (``ShuffleExchangeExec
._sample_range_bounds``); as in Spark's RangePartitioner, a key equal to a
bound stays in the earlier partition.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence

import torch

from ..batch import ColumnarBatch, DeviceColumn, Schema
from ..expressions.base import EvalContext, Expression, raw_eval
from ..expressions.hashing import partition_ids


class Partitioning:
    num_partitions: int

    def bind(self, schema: Schema) -> "Partitioning":
        return self

    def partition_ids(self, batch: ColumnarBatch,
                      ctx: EvalContext = EvalContext()) -> torch.Tensor:
        """int32[cap] target partition per row (live rows only meaningful)."""
        raise NotImplementedError


@dataclass
class HashPartitioning(Partitioning):
    exprs: Sequence[Expression]
    num_partitions: int = 8

    def bind(self, schema: Schema) -> "HashPartitioning":
        return HashPartitioning([e.bind(schema) for e in self.exprs],
                                self.num_partitions)

    def partition_ids(self, batch, ctx=EvalContext()):
        cols = [raw_eval(e, batch, ctx) for e in self.exprs]
        return partition_ids(cols, self.num_partitions)


@dataclass
class RoundRobinPartitioning(Partitioning):
    """Row i of every batch goes to ``(i + start) % num_partitions``."""

    num_partitions: int = 8
    start: int = 0

    def partition_ids(self, batch, ctx=EvalContext()):
        iota = torch.arange(batch.capacity, dtype=torch.int32,
                            device=batch.device)
        return (iota + self.start) % self.num_partitions


@dataclass
class SinglePartitioning(Partitioning):
    num_partitions: int = 1

    def partition_ids(self, batch, ctx=EvalContext()):
        return torch.zeros(batch.capacity, dtype=torch.int32,
                           device=batch.device)


@dataclass
class RangePartitioning(Partitioning):
    """Range partitioning on ``orders`` (``exec.sort.SortOrder``s) from
    bounds set once by ``set_bounds`` before the first ``partition_ids``.

    Keys and bounds compare as the rank-preserving words of
    ``exec.common.sort_operands`` (null rank first where a key is
    nullable), so a row's partition is the number of bounds it is strictly
    greater than, lexicographically."""

    orders: Sequence
    num_partitions: int = 8
    _bound_words: Optional[List[torch.Tensor]] = field(
        default=None, init=False, repr=False)

    def bind(self, schema: Schema) -> "RangePartitioning":
        return RangePartitioning([o.bind(schema) for o in self.orders],
                                 self.num_partitions)

    def key_columns(self, batch: ColumnarBatch,
                    ctx: EvalContext = EvalContext()) -> List[DeviceColumn]:
        return [o.child.eval(batch, ctx) for o in self.orders]

    def _norm_words(self, key_cols: Sequence[DeviceColumn],
                    live: torch.Tensor) -> List[torch.Tensor]:
        from ..exec.common import sort_operands
        # the leading liveness operand is dropped: bounds and rows share it
        return sort_operands(key_cols, [o.descending for o in self.orders],
                             [o.effective_nulls_first for o in self.orders],
                             live)[1:]

    def set_bounds(self, bound_cols: Sequence[DeviceColumn],
                   n_bounds: int) -> None:
        """``bound_cols`` hold the sorted bound rows, ``n_bounds`` of them
        (fewer than ``num_partitions - 1`` leaves the last partitions
        empty)."""
        live = torch.arange(bound_cols[0].capacity,
                            device=bound_cols[0].validity.device) < n_bounds
        self._bound_words = [w[:n_bounds]
                             for w in self._norm_words(bound_cols, live)]

    def partition_ids(self, batch, ctx=EvalContext()):
        assert self._bound_words is not None, "set_bounds first"
        words = self._norm_words(self.key_columns(batch, ctx),
                                 batch.row_mask())
        nb = self._bound_words[0].shape[0]
        gt = torch.zeros((batch.capacity, nb), dtype=torch.bool,
                         device=batch.device)
        decided = torch.zeros_like(gt)
        for w, bw in zip(words, self._bound_words):
            row, bound = w[:, None], bw[None, :]
            gt |= ~decided & (row > bound)
            decided |= row != bound
        # keys <= a bound stay in the earlier partition (Spark's lteq):
        # only strictly greater rows advance
        pid = gt.sum(dim=1, dtype=torch.int32)
        return pid.clamp(max=self.num_partitions - 1)
