"""In-core sort.

Port of ``SortOrder``, ``sort_batch`` and ``SortExec`` from
``spark_rapids_tpu/exec/sort.py``. Every sort key becomes rank-preserving
operands (``exec/common.sort_operands``) and ``lexsort`` orders the rows;
the sort is global: it concatenates every input batch of every partition
and sorts them once. The partition-local sort and the out-of-core merge of
spilled runs come with later slices.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, List, Optional, Sequence

from ..batch import ColumnarBatch, Schema
from ..expressions.base import EvalContext, Expression
from .base import Exec, UnaryExec
from .common import concat_all, gather, lexsort, sort_operands


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
    def __init__(self, orders: Sequence[SortOrder], child: Exec,
                 ctx: Optional[EvalContext] = None):
        super().__init__(child, ctx)
        self.orders = [o.bind(child.output_schema) for o in orders]

    @property
    def output_schema(self) -> Schema:
        return self.child.output_schema

    @property
    def num_partitions(self) -> int:
        return 1

    def do_execute_partition(self, p: int) -> Iterator[ColumnarBatch]:
        batches: List[ColumnarBatch] = [
            b for cp in range(self.child.num_partitions)
            for b in self.child.execute_partition(cp)]
        if not batches:
            return
        yield sort_batch(concat_all(batches, self.output_schema, self.device),
                         self.orders, self.ctx)
