"""The in-process shuffle and broadcast exchanges.

Port of ``ShuffleExchangeExec`` and ``BroadcastExchangeExec`` from
``spark_rapids_tpu/shuffle/exchange.py`` without their spill catalog, retry
loop and serializer (the memory-runtime slice). The write side streams the child one batch at a time: it computes
every row's target partition, cuts one piece per target partition with its
rows in input order, and shrinks each piece to its row-count bucket. The
read side concatenates a reducer's pieces into one batch.

Where the JAX package compacts once per target partition, the pieces here
come from one stable sort of the partition ids: the same rows in the same
order, for one sort per batch instead of one per partition.
"""

from __future__ import annotations

from typing import Iterator, List, Optional, Tuple

import torch

from ..batch import ColumnarBatch, Schema, bucket_capacity
from ..exec.base import Exec, UnaryExec
from ..exec.common import concat_all, concat_batches, gather
from ..expressions.base import EvalContext
from .partitioning import Partitioning


def partition_pieces(batch: ColumnarBatch, pids: torch.Tensor,
                     n: int) -> Iterator[Tuple[int, int, ColumnarBatch]]:
    """(partition, rows, piece) for each partition that gets rows; each
    piece holds its rows in input order at capacity bucket_capacity(rows)."""
    key = torch.where(batch.row_mask(), pids.to(torch.int64), n)
    perm = torch.sort(key, stable=True).indices      # dead rows last
    counts = torch.bincount(key, minlength=n + 1)[:n].tolist()
    last = perm.shape[0] - 1
    off = 0
    for p, rows in enumerate(counts):
        if rows:
            iota = torch.arange(bucket_capacity(rows), device=batch.device)
            idx = perm[(iota + off).clamp(max=last)]
            yield p, rows, gather(batch, idx, rows, iota < rows)
        off += rows


#: default ceiling of one broadcast relation, the JAX package's
#: ``spark.rapids.tpu.broadcast.maxBytes``
BROADCAST_MAX_BYTES = 1 << 30


class BroadcastTooLargeError(MemoryError):
    """A broadcast relation exceeded its byte ceiling: the build side must
    be shuffled instead. Not retryable."""


class BroadcastExchangeExec(UnaryExec):
    """The child's whole output as one batch, made once and served to every
    read (a broadcast join's build side). Raises ``BroadcastTooLargeError``
    when that batch passes ``max_bytes``."""

    def __init__(self, child: Exec, ctx: Optional[EvalContext] = None,
                 max_bytes: int = BROADCAST_MAX_BYTES):
        super().__init__(child, ctx)
        self.max_bytes = max_bytes
        self._cached: Optional[ColumnarBatch] = None

    @property
    def output_schema(self) -> Schema:
        return self.child.output_schema

    @property
    def num_partitions(self) -> int:
        return 1

    def do_execute_partition(self, p: int) -> Iterator[ColumnarBatch]:
        if self._cached is None:
            cached = concat_all(
                [b for cp in range(self.child.num_partitions)
                 for b in self.child.execute_partition(cp)],
                self.output_schema, self.device)
            if cached.size_bytes() > self.max_bytes:
                raise BroadcastTooLargeError(
                    f"broadcast relation is {cached.size_bytes()} bytes > "
                    f"max_bytes={self.max_bytes}; shuffle this build side "
                    f"instead")
            self._cached = cached
        yield self._cached


class ShuffleExchangeExec(UnaryExec):
    """All-to-all redistribution of rows by a partitioning."""

    def __init__(self, partitioning: Partitioning, child: Exec,
                 ctx: Optional[EvalContext] = None):
        super().__init__(child, ctx)
        self.partitioning = partitioning.bind(child.output_schema)
        self._materialized: Optional[List[List[Tuple[ColumnarBatch,
                                                     int]]]] = None

    @property
    def output_schema(self) -> Schema:
        return self.child.output_schema

    @property
    def num_partitions(self) -> int:
        return self.partitioning.num_partitions

    def _materialize(self) -> List[List[Tuple[ColumnarBatch, int]]]:
        if self._materialized is None:
            n = self.partitioning.num_partitions
            out: List[List[Tuple[ColumnarBatch, int]]] = [[] for _ in range(n)]
            for cp in range(self.child.num_partitions):
                for batch in self.child.execute_partition(cp):
                    pids = self.partitioning.partition_ids(batch, self.ctx)
                    for p, rows, piece in partition_pieces(batch, pids, n):
                        out[p].append((piece, rows))
            self._materialized = out
        return self._materialized

    def do_execute_partition(self, p: int) -> Iterator[ColumnarBatch]:
        entries = self._materialize()[p]
        if not entries:
            return
        if len(entries) == 1:
            yield entries[0][0]
            return
        cap = bucket_capacity(sum(rows for _, rows in entries))
        yield concat_batches([b for b, _ in entries], cap)
