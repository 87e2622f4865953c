"""The in-process shuffle and broadcast exchanges.

Port of ``ShuffleExchangeExec`` and ``BroadcastExchangeExec`` from
``spark_rapids_tpu/shuffle/exchange.py`` with their spill side. The write
side streams the child one batch at a time: each input batch is admitted
to the buffer catalog (``SpillableInput``), and under the retry loop
(halving the input on a repeated OOM) every row's target partition is
computed and one piece per target partition is cut, with its rows in input
order at its row-count bucket, and registered in the catalog, where it is
spillable until read. The read side pins a reducer's pieces under the retry
loop, concatenates them into one batch and closes them once that batch has
been consumed: each partition is read once (the AQE reader specs, which
may read a piece more than once, are not ported). ``spillBytes`` counts
what the catalog spilled while the write ran.

Where the JAX package compacts once per target partition, the pieces here
come from one stable sort of the partition ids: the same rows in the same
order, for one sort per batch instead of one per partition.

The broadcast relation is registered in the catalog too, spillable between
reads.
"""

from __future__ import annotations

from typing import Iterator, List, Optional, Tuple

from ..batch import ColumnarBatch, Schema, bucket_capacity
from ..exec.base import Exec, Metric, UnaryExec
from ..exec.common import concat_all, concat_batches, partition_pieces
from ..expressions.base import EvalContext
from ..memory.catalog import SpillableBatch
from ..memory.retry import (SpillableInput, acquire_with_retry,
                            split_input_halves, with_retry,
                            with_retry_no_split)
from .partitioning import Partitioning


#: default ceiling of one broadcast relation, the JAX package's
#: ``spark.rapids.tpu.broadcast.maxBytes``
BROADCAST_MAX_BYTES = 1 << 30


class BroadcastTooLargeError(MemoryError):
    """A broadcast relation exceeded its byte ceiling: the build side must
    be shuffled instead. Not retryable."""


class BroadcastExchangeExec(UnaryExec):
    """The child's whole output as one batch, made once, registered in the
    catalog and served to every read (a broadcast join's build side),
    spillable between reads. Raises ``BroadcastTooLargeError`` when that
    batch passes ``max_bytes``."""

    def __init__(self, child: Exec, ctx: Optional[EvalContext] = None,
                 max_bytes: int = BROADCAST_MAX_BYTES):
        super().__init__(child, ctx)
        self.max_bytes = max_bytes
        self._sb: Optional[SpillableBatch] = None

    @property
    def output_schema(self) -> Schema:
        return self.child.output_schema

    @property
    def num_partitions(self) -> int:
        return 1

    def do_execute_partition(self, p: int) -> Iterator[ColumnarBatch]:
        if self._sb is None:
            batches = [b for cp in range(self.child.num_partitions)
                       for b in self.child.execute_partition(cp)]

            def build() -> SpillableBatch:
                cached = concat_all(batches, self.output_schema, self.device)
                if cached.size_bytes() > self.max_bytes:
                    # not retryable: no spill shrinks the relation
                    raise BroadcastTooLargeError(
                        f"broadcast relation is {cached.size_bytes()} bytes "
                        f"> max_bytes={self.max_bytes}; shuffle this build "
                        f"side instead")
                return SpillableBatch(self.catalog, cached,
                                      self.output_schema)

            self._sb = with_retry_no_split(build, catalog=self.catalog,
                                           name=self.name)
            batches.clear()     # the catalog holds the only reference
        batch = acquire_with_retry(self._sb, name=self.name)
        try:
            yield batch
        finally:
            self._sb.done_with()        # spillable again between reads

    def do_close(self) -> None:
        if self._sb is not None:
            self._sb.close()
            self._sb = None


class ShuffleExchangeExec(UnaryExec):
    """All-to-all redistribution of rows by a partitioning, its pieces
    held in the buffer catalog."""

    def __init__(self, partitioning: Partitioning, child: Exec,
                 ctx: Optional[EvalContext] = None):
        super().__init__(child, ctx)
        self.partitioning = partitioning.bind(child.output_schema)
        self._materialized: Optional[
            List[List[Tuple[SpillableBatch, int]]]] = None
        self.metrics["spillBytes"] = Metric("spillBytes")

    @property
    def output_schema(self) -> Schema:
        return self.child.output_schema

    @property
    def num_partitions(self) -> int:
        return self.partitioning.num_partitions

    def _materialize(self) -> List[List[Tuple[SpillableBatch, int]]]:
        if self._materialized is not None:
            return self._materialized
        n = self.partitioning.num_partitions
        out: List[List[Tuple[SpillableBatch, int]]] = [[] for _ in range(n)]
        cat = self.catalog
        spill0 = cat.spilled_to_host + cat.spilled_to_disk
        in_schema = self.child.output_schema

        def write_body(item: SpillableInput):
            """One write attempt over one (possibly split) input: cut the
            pieces and register them. Transactional: an OOM mid-loop closes
            this attempt's pieces, so the retry starts clean."""
            b = item.acquire()
            staged: List[Tuple[int, SpillableBatch, int]] = []
            try:
                pids = self.partitioning.partition_ids(b, self.ctx)
                for p, rows, piece in partition_pieces(b, pids, n):
                    staged.append((p, SpillableBatch(cat, piece,
                                                     self.output_schema),
                                   rows))
            except BaseException:
                for _p, sb, _r in staged:
                    sb.close()
                raise
            finally:
                item.release()
            return staged

        try:
            for cp in range(self.child.num_partitions):
                for batch in self.child.execute_partition(cp):
                    # the input rides the catalog across retry boundaries;
                    # a repeated OOM halves it, and the halves cut to the
                    # same pieces in the same order
                    inp = SpillableInput.admit(batch, in_schema, cat,
                                               name=f"{self.name}.admit")
                    del batch           # the catalog holds it from here
                    for staged in with_retry(inp, write_body,
                                             split=split_input_halves,
                                             catalog=cat, name=self.name):
                        for p, sb, rows in staged:
                            out[p].append((sb, rows))
        except BaseException:
            # a failure mid-stream frees the pieces already staged
            for part in out:
                for sb, _rows in part:
                    sb.close()
            raise
        self.metrics["spillBytes"].add(
            cat.spilled_to_host + cat.spilled_to_disk - spill0)
        self._materialized = out
        return out

    def do_execute_partition(self, p: int) -> Iterator[ColumnarBatch]:
        entries = self._materialize()[p]
        if not entries:
            return
        cap = bucket_capacity(sum(rows for _, rows in entries))

        def assemble():
            """The pin loop, transactional: an OOM mid-loop unpins the
            pieces already pinned before it propagates."""
            pinned: List[SpillableBatch] = []
            try:
                got = []
                for sb, _ in entries:
                    got.append(sb.get())
                    pinned.append(sb)
                if len(got) == 1:
                    return got[0]
                return concat_batches(got, cap)
            except BaseException:
                for sb in pinned:
                    sb.done_with()
                raise

        batch = with_retry_no_split(assemble, catalog=self.catalog,
                                    name=f"{self.name}.read")
        try:
            yield batch
        finally:
            # the partition is read once: its pieces go with the read
            for sb, _ in entries:
                sb.close()

    def do_close(self) -> None:
        # partitions never read (a limit's early exit) still hold pieces;
        # SpillableBatch.close is idempotent
        if self._materialized is not None:
            for pieces in self._materialized:
                for sb, _ in pieces:
                    sb.close()
            self._materialized = None
