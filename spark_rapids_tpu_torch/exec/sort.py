"""The sorts and the top-N.

Port of ``SortOrder``, ``sort_batch``, ``SortExec`` and
``TakeOrderedAndProjectExec`` from ``spark_rapids_tpu/exec/sort.py``. Every
sort key becomes rank-preserving operands (``exec/common.sort_operands``)
and ``lexsort`` orders the rows.

The global sort registers every input batch of every partition in the
spill catalog as it arrives; then all of them are pinned under the retry
loop and, when their capacities add up to at most ``max_rows``,
concatenated and sorted once, else merged through ``OutOfCoreSorter``
(``exec/ooc_sort.py``). The partition-local sort (``global_sort=False``)
sorts each batch of each partition on its own. The top-N sorts each input
batch and cuts it to the limit, then keeps the best ``limit`` rows of what
it has and the next batch's (a tournament), and projects them: one
partition, one batch.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, List, Optional, Sequence

from ..batch import ColumnarBatch, Schema, bucket_capacity
from ..expressions.base import EvalContext, Expression, raw_eval
from ..memory.catalog import SpillableBatch
from ..memory.retry import (acquire_with_retry, register_with_retry,
                            with_retry_no_split)
from .base import Exec, Metric, UnaryExec
from .basic import bind_all, schema_of
from .common import (concat_batches, gather, lexsort, slice_batch,
                     sort_operands)


@dataclass(frozen=True)
class SortOrder:
    """A sort key. Spark's defaults: ascending nulls first, descending
    nulls last."""

    child: Expression
    descending: bool = False
    nulls_first: Optional[bool] = None

    @property
    def effective_nulls_first(self) -> bool:
        if self.nulls_first is None:
            return not self.descending
        return self.nulls_first

    def bind(self, schema: Schema) -> "SortOrder":
        return SortOrder(self.child.bind(schema), self.descending,
                         self.nulls_first)


def asc(e: Expression) -> SortOrder:
    return SortOrder(e, False)


def desc(e: Expression) -> SortOrder:
    return SortOrder(e, True)


def sort_batch(batch: ColumnarBatch, orders: Sequence[SortOrder],
               ctx: EvalContext = EvalContext()) -> ColumnarBatch:
    """Stable in-core sort of one batch; dead rows stay last."""
    live = batch.row_mask()
    key_cols = [o.child.eval(batch, ctx) for o in orders]
    ops = sort_operands(key_cols, [o.descending for o in orders],
                        [o.effective_nulls_first for o in orders], live)
    return gather(batch, lexsort(ops), batch.num_rows, live)


class SortExec(UnaryExec):
    """A global sort (one partition out) or, with ``global_sort=False``, a
    sort of each batch of each partition."""

    def coalesce_goal_for_child(self, i):
        from .coalesce import TargetSize
        return TargetSize()

    @property
    def produces_single_batch(self):
        return self.global_sort

    def __init__(self, orders: Sequence[SortOrder], child: Exec,
                 global_sort: bool = True,
                 ctx: Optional[EvalContext] = None,
                 max_rows: int = 1 << 22):
        super().__init__(child, ctx)
        self.orders = [o.bind(child.output_schema) for o in orders]
        self.global_sort = global_sort
        self.max_rows = max_rows
        #: sorts that took the out-of-core merge (over ``max_rows``)
        self.metrics["oocSorts"] = Metric("oocSorts")

    @property
    def output_schema(self) -> Schema:
        return self.child.output_schema

    @property
    def num_partitions(self) -> int:
        return 1 if self.global_sort else self.child.num_partitions

    def _sort(self, batch: ColumnarBatch) -> ColumnarBatch:
        return sort_batch(batch, self.orders, self.ctx)

    def do_execute_partition(self, p: int) -> Iterator[ColumnarBatch]:
        if not self.global_sort:
            for b in self.child.execute_partition(p):
                yield self._sort(b)
            return
        cat = self.catalog
        schema = self.output_schema
        spillables: List[SpillableBatch] = []
        try:
            for cp in range(self.child.num_partitions):
                for b in self.child.execute_partition(cp):
                    # a registered handle starts unpinned (spillable)
                    spillables.append(register_with_retry(
                        b, schema, catalog=cat, name=self.name))
                    del b
            if not spillables:
                return
            if len(spillables) == 1:
                yield self._sort(acquire_with_retry(spillables[0],
                                                    name=self.name))
                spillables[0].done_with()
                return

            def acquire_all() -> List[ColumnarBatch]:
                got = []
                try:
                    for sb in spillables:
                        got.append(sb.get())
                except BaseException:
                    for i in range(len(got)):
                        spillables[i].done_with()
                    raise
                for sb in spillables:
                    sb.done_with()
                return got

            batches = with_retry_no_split(acquire_all, catalog=cat,
                                          name=self.name)
            total_cap = sum(b.capacity for b in batches)
            if total_cap > self.max_rows:
                from .ooc_sort import OutOfCoreSorter
                sorter = OutOfCoreSorter(self.orders, schema, cat)
                self.metrics["oocSorts"].add(1)
                yield from sorter.sort(iter(batches))
                return
            yield self._sort(concat_batches(batches,
                                            bucket_capacity(total_cap)))
        finally:
            for sb in spillables:
                sb.close()


class TakeOrderedAndProjectExec(UnaryExec):
    """ORDER BY ... LIMIT n (and a projection): each input batch sorted and
    cut to ``limit`` rows, a tournament across batches keeping the best
    ``limit`` of the best so far and the next candidate, and the
    projection over the winners. One partition, one batch."""

    def coalesce_goal_for_child(self, i):
        from .coalesce import TargetSize
        return TargetSize()

    @property
    def produces_single_batch(self):
        return True

    def __init__(self, limit: int, orders: Sequence[SortOrder],
                 project: Optional[Sequence[Expression]], child: Exec,
                 ctx: Optional[EvalContext] = None):
        super().__init__(child, ctx)
        self.limit = limit
        self.orders = [o.bind(child.output_schema) for o in orders]
        self.project = (bind_all(project, child.output_schema) if project
                        else None)
        self._schema = (schema_of(self.project) if self.project
                        else child.output_schema)

    @property
    def output_schema(self) -> Schema:
        return self._schema

    @property
    def num_partitions(self) -> int:
        return 1

    def _top(self, batch: ColumnarBatch) -> ColumnarBatch:
        """The batch's first ``limit`` rows in order, at the limit's
        bucket (or the batch's capacity, if smaller)."""
        s = sort_batch(batch, self.orders, self.ctx)
        return slice_batch(s, 0, self.limit,
                           bucket_capacity(min(self.limit, batch.capacity)))

    def do_execute_partition(self, p: int) -> Iterator[ColumnarBatch]:
        best: Optional[ColumnarBatch] = None
        for batch in self.child.execute():
            cand = self._top(batch)
            del batch
            best = cand if best is None else self._top(concat_batches(
                [best, cand], bucket_capacity(best.capacity
                                              + cand.capacity)))
        if best is None:
            return
        if self.project is None:
            yield best
            return
        yield ColumnarBatch(tuple(raw_eval(e, best, self.ctx)
                                  for e in self.project), best.num_rows)
