"""The in-process shuffle and broadcast exchanges, with adaptive reads.

Port of ``ShuffleExchangeExec``, ``coordinate_join_reads`` and
``BroadcastExchangeExec`` from ``spark_rapids_tpu/shuffle/exchange.py``
with their spill side. The write side streams the child one batch at a
time: each input batch is admitted to the buffer catalog
(``SpillableInput``), and under the retry loop (halving the input on a
repeated OOM) every row's target partition is computed and one piece per
target partition is cut, with its rows in input order at its row-count
bucket, and registered in the catalog, where it is spillable until read.
So there is one piece per input batch (or per half after an OOM split) per
partition that gets rows, as in the JAX package; the skew split cuts at
piece boundaries, so the two packages' reader layouts agree only because
their pieces do. A range partitioning first gathers the whole input and
samples its bounds from it (``_sample_range_bounds``).

The read side is laid out by reader specs (``ReadSpec``): a reader
partition is a list of (map partition, first piece, end piece) ranges.
Without AQE each map partition is one reader partition. An adaptive
exchange (``adaptive=True``) coalesces runs of adjacent thin partitions
toward ``target_rows`` once its map side has materialized
(``_coalesce_groups``), and a co-partitioned hash join lays out both of
its exchanges at once (``coordinate_join_reads``): groups by the two
sides' combined counts, and a stream partition over the skew threshold
split into piece ranges, each reading the whole matching build partition.
A read pins its pieces under the retry loop and concatenates them; a piece
is closed after the last read that references it, and stays registered
(unpinned, spillable) between reads before that. ``spillBytes`` counts
what the catalog spilled while the write ran. Every decision goes through
``adaptive.record_decision``.

Where the JAX package compacts once per target partition, the pieces here
come from one stable sort of the partition ids: the same rows in the same
order, for one sort per batch instead of one per partition.

The broadcast relation is registered in the catalog too, spillable between
reads. Not ported here: ``CachedShuffleExchangeExec`` and the wire export
(``serialized_partitions``), which come with the shuffle network plane.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Tuple

import torch

from ..adaptive import record_decision
from ..batch import ColumnarBatch, Schema, bucket_capacity
from ..config import ADAPTIVE_TARGET_ROWS, BROADCAST_LIMIT
from ..dictenc import unify_dict_batches
from ..exec.base import Exec, Metric, UnaryExec
from ..exec.common import (concat_all, concat_batches, gather_column,
                           lexsort, partition_pieces, sort_operands)
from ..expressions.base import EvalContext
from ..memory.catalog import SpillableBatch
from ..memory.retry import (SpillableInput, acquire_with_retry,
                            split_input_halves, with_retry,
                            with_retry_no_split)
from .partitioning import Partitioning, RangePartitioning

#: One reader partition: (map-output partition, piece_lo, piece_hi) piece
#: ranges (Spark AQE's CoalescedPartitionSpec spans whole partitions,
#: PartialReducerPartitionSpec takes a slice of one skewed partition)
ReadSpec = List[Tuple[int, int, int]]


def _coalesce_groups(counts: List[int], target_rows: int) -> List[List[int]]:
    """Greedy adjacent grouping of partitions, each group growing until the
    next partition would take it past ``target_rows``."""
    groups: List[List[int]] = []
    cur: List[int] = []
    cur_rows = 0
    for p, c in enumerate(counts):
        if cur and cur_rows + c > target_rows:
            groups.append(cur)
            cur, cur_rows = [], 0
        cur.append(p)
        cur_rows += c
    if cur:
        groups.append(cur)
    return groups or [[0]]


class BroadcastTooLargeError(MemoryError):
    """A broadcast relation exceeded its byte ceiling: the build side must
    be shuffled instead. Not retryable."""


class BroadcastExchangeExec(UnaryExec):
    """The child's whole output as one batch, made once, registered in the
    catalog and served to every read (a broadcast join's build side),
    spillable between reads. Raises ``BroadcastTooLargeError`` when that
    batch passes ``max_bytes``."""

    @property
    def produces_single_batch(self):
        return True

    def __init__(self, child: Exec, ctx: Optional[EvalContext] = None,
                 max_bytes: int = BROADCAST_LIMIT.default):
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
    held in the buffer catalog; with ``adaptive`` its reader partitions
    coalesce toward ``target_rows`` once the map side has materialized."""

    @property
    def produces_single_batch(self):
        return True

    def __init__(self, partitioning: Partitioning, child: Exec,
                 ctx: Optional[EvalContext] = None, adaptive: bool = False,
                 target_rows: int = ADAPTIVE_TARGET_ROWS.default):
        super().__init__(child, ctx)
        self.partitioning = partitioning.bind(child.output_schema)
        self.adaptive = adaptive
        self.target_rows = target_rows
        self._materialized: Optional[
            List[List[Tuple[SpillableBatch, int]]]] = None
        self._specs: Optional[List[ReadSpec]] = None
        #: reads left per (map partition, piece) under the current specs
        self._use_left: Optional[Dict[Tuple[int, int], int]] = None
        self.metrics["spillBytes"] = Metric("spillBytes")

    @property
    def output_schema(self) -> Schema:
        return self.child.output_schema

    @property
    def num_partitions(self) -> int:
        """The reader partitions: an adaptive exchange materializes its
        map side to count them."""
        if self._specs is not None:
            return len(self._specs)
        if self.adaptive:
            return len(self._reader_specs())
        return self.partitioning.num_partitions

    def partition_row_counts(self) -> List[int]:
        """Materialized rows per map-output partition (the statistics the
        reader layout is planned on)."""
        return [sum(rows for _, rows in pieces)
                for pieces in self._materialize()]

    def piece_row_counts(self, p: int) -> List[int]:
        return [rows for _, rows in self._materialize()[p]]

    def set_reader_specs(self, specs: List[ReadSpec]) -> None:
        """Fix the reader layout: solo (``_reader_specs``) or set by a join
        for both of its exchanges (``coordinate_join_reads``). A piece that
        several specs read (a replicated build piece) is closed after its
        last read."""
        self._materialize()
        use: Dict[Tuple[int, int], int] = {}
        for spec in specs:
            for mp, lo, hi in spec:
                for i in range(lo, hi):
                    use[(mp, i)] = use.get((mp, i), 0) + 1
        self._specs = specs
        self._use_left = use

    def _reader_specs(self) -> List[ReadSpec]:
        if self._specs is None:
            parts = self._materialize()
            if self.adaptive:
                counts = [sum(rows for _, rows in pieces)
                          for pieces in parts]
                groups = _coalesce_groups(counts, self.target_rows)
                if len(groups) < len(parts):
                    record_decision(
                        "coalesce",
                        f"solo exchange: {len(parts)} materialized "
                        f"partitions -> {len(groups)} reader partitions "
                        f"(targetRows={self.target_rows})",
                        n=len(parts) - len(groups))
            else:
                groups = [[p] for p in range(len(parts))]
            self.set_reader_specs(
                [[(p, 0, len(parts[p])) for p in g] for g in groups])
        return self._specs

    def _sample_range_bounds(self, batches: List[ColumnarBatch]) -> None:
        """Set the range partitioning's bounds from the whole input: sort
        its key rows and take the rows at ``(i + 1) * total // n`` for the
        ``n - 1`` bounds."""
        part: RangePartitioning = self.partitioning
        n = part.num_partitions
        keys = [ColumnarBatch(tuple(part.key_columns(b, self.ctx)),
                              b.num_rows) for b in batches]
        allk = concat_batches(keys, bucket_capacity(
            sum(kb.capacity for kb in keys)))
        live = allk.row_mask()
        ops = sort_operands(list(allk.columns),
                            [o.descending for o in part.orders],
                            [o.effective_nulls_first for o in part.orders],
                            live)
        perm = lexsort(ops)
        total = int(allk.num_rows)
        pos = ((torch.arange(n - 1, dtype=torch.int64, device=self.device)
                + 1) * total) // n
        at = perm[pos.clamp(0, allk.capacity - 1)]
        part.set_bounds([gather_column(c, at) for c in allk.columns], n - 1)

    def _materialize(self) -> List[List[Tuple[SpillableBatch, int]]]:
        if self._materialized is not None:
            return self._materialized
        n = self.partitioning.num_partitions
        out: List[List[Tuple[SpillableBatch, int]]] = [[] for _ in range(n)]
        cat = self.catalog
        spill0 = cat.spilled_to_host + cat.spilled_to_disk
        in_schema = self.child.output_schema
        if isinstance(self.partitioning, RangePartitioning):
            # the bounds need the whole input before any row is routed;
            # each batch then leaves the list as the catalog takes it
            batches = [b for cp in range(self.child.num_partitions)
                       for b in self.child.execute_partition(cp)]
            if batches:
                self._sample_range_bounds(batches)
            stream = (batches.pop(0) for _ in range(len(batches)))
        else:
            stream = (b for cp in range(self.child.num_partitions)
                      for b in self.child.execute_partition(cp))

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
            for batch in stream:
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
        spec = self._reader_specs()[p]
        parts = self._materialize()
        entries = [parts[mp][i] for mp, lo, hi in spec
                   for i in range(lo, hi)]
        if not entries:
            return
        cap = bucket_capacity(sum(rows for _, rows in entries))

        def assemble():
            """The pin loop, transactional: an OOM mid-loop unpins the
            pieces already pinned before it propagates, so a retry finds
            every piece unpinned and spillable."""
            pinned: List[SpillableBatch] = []
            try:
                got = []
                for sb, _ in entries:
                    got.append(sb.get())
                    pinned.append(sb)
                if len(got) == 1:
                    return got[0]
                # per-batch dictionaries unify onto one merged dictionary
                # (a device code remap between kernels), so the read keeps
                # string columns encoded across the concat
                return concat_batches(unify_dict_batches(got), cap)
            except BaseException:
                for sb in pinned:
                    sb.done_with()
                raise

        batch = with_retry_no_split(assemble, catalog=self.catalog,
                                    name=f"{self.name}.read")
        try:
            yield batch
        finally:
            # a piece goes after its last referencing read; before that it
            # is unpinned, spillable until the next read pins it again. A
            # generator abandoned after do_close finds no counts: close
            # is idempotent
            use = self._use_left
            for mp, lo, hi in spec:
                for i in range(lo, hi):
                    sb = parts[mp][i][0]
                    if use is None:
                        sb.close()
                        continue
                    use[(mp, i)] -= 1
                    if use[(mp, i)] <= 0:
                        sb.close()
                    else:
                        sb.done_with()

    def do_close(self) -> None:
        # partitions never read (a limit's early exit) still hold pieces;
        # SpillableBatch.close is idempotent
        if self._materialized is not None:
            for pieces in self._materialized:
                for sb, _ in pieces:
                    sb.close()
            self._materialized = None
        self._specs = None
        self._use_left = None


def coordinate_join_reads(stream: ShuffleExchangeExec,
                          build: ShuffleExchangeExec, target_rows: int,
                          skew_split_rows: Optional[int] = None) -> int:
    """Lay out the reader partitions of a co-partitioned join's two
    exchanges together (Spark AQE's ShufflePartitionsUtil and
    OptimizeSkewedJoin): groups come from the combined row counts, so both
    sides agree (coalescing each side by its own counts would break the
    co-partitioning). A stream partition over ``skew_split_rows`` is never
    coalesced; it is split into piece ranges of at most that many rows
    (a piece over it alone), each paired with the whole matching build
    partition. Returns the number of splits made."""
    sc = stream.partition_row_counts()
    bc = build.partition_row_counts()
    assert len(sc) == len(bc), (len(sc), len(bc))
    combined = [a + b for a, b in zip(sc, bc)]
    if skew_split_rows:
        # skewed partitions stand alone; only the thin runs between them
        # coalesce toward target_rows
        groups: List[List[int]] = []
        run: List[int] = []
        for p in range(len(combined)):
            if sc[p] > skew_split_rows:
                if run:
                    groups += [[run[i] for i in g] for g in _coalesce_groups(
                        [combined[i] for i in run], target_rows)]
                    run = []
                groups.append([p])
            else:
                run.append(p)
        if run:
            groups += [[run[i] for i in g] for g in _coalesce_groups(
                [combined[i] for i in run], target_rows)]
    else:
        groups = _coalesce_groups(combined, target_rows)
    if len(groups) < len(combined):
        record_decision(
            "coalesce",
            f"coordinated join exchanges: {len(combined)} materialized "
            f"partitions -> {len(groups)} reader partitions "
            f"(targetRows={target_rows})",
            n=len(combined) - len(groups))
    s_specs: List[ReadSpec] = []
    b_specs: List[ReadSpec] = []
    n_splits = 0
    for g in groups:
        if skew_split_rows and len(g) == 1 and sc[g[0]] > skew_split_rows:
            p = g[0]
            rows = stream.piece_row_counts(p)
            chunks: List[Tuple[int, int]] = []
            lo, cur = 0, 0
            for i, r in enumerate(rows):
                if cur and cur + r > skew_split_rows:
                    chunks.append((lo, i))
                    lo, cur = i, 0
                cur += r
            chunks.append((lo, len(rows)))
            np_build = len(build.piece_row_counts(p))
            if len(chunks) > 1:
                n_splits += len(chunks) - 1
                record_decision(
                    "skewSplit",
                    f"partition {p}: {sc[p]} stream rows > "
                    f"splitRows={skew_split_rows} -> {len(chunks)} "
                    f"piece-range reader partitions (build replicated)",
                    n=len(chunks) - 1)
            for c_lo, c_hi in chunks:
                s_specs.append([(p, c_lo, c_hi)])
                b_specs.append([(p, 0, np_build)])
        else:
            s_specs.append([(p, 0, len(stream.piece_row_counts(p)))
                            for p in g])
            b_specs.append([(p, 0, len(build.piece_row_counts(p)))
                            for p in g])
    stream.set_reader_specs(s_specs)
    build.set_reader_specs(b_specs)
    return n_splits
