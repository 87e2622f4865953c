"""Basic operators: in-memory scan, project, filter and the limits.

Port of ``InMemoryScanExec``, ``ProjectExec``, ``FilterExec``,
``LocalLimitExec`` and ``GlobalLimitExec`` from
``spark_rapids_tpu/exec/basic.py``. The scan is the H2D boundary: an Arrow
table is cut into ``batch_rows`` chunks dealt round-robin to ``num_slices``
partitions, and a partition uploads only its own chunks, when it runs. Each
chunk's upload runs under the OOM retry loop (no split: the chunk count
fixes the round-robin), with the ``scan.h2d`` injection site.
"""

from __future__ import annotations

from typing import Iterator, List, Optional, Sequence

import pyarrow as pa
import torch

from ..batch import (ColumnarBatch, DeviceLike, Field, Schema, from_arrow,
                     resolve_device, schema_from_arrow)
from ..expressions.base import Alias, EvalContext, Expression, raw_eval
from ..memory.catalog import BufferCatalog
from ..memory.retry import maybe_inject, with_retry_no_split
from ..types import TypeKind
from .base import Exec, LeafExec, UnaryExec
from .common import compact, slice_batch


def output_name(e: Expression, i: int) -> str:
    if isinstance(e, Alias):
        return e.name
    return getattr(e, "name", "") or f"col{i}"


def bind_all(exprs: Sequence[Expression], schema: Schema) -> List[Expression]:
    return [e.bind(schema) for e in exprs]


def schema_of(exprs: Sequence[Expression]) -> Schema:
    return Schema([Field(output_name(e, i), e.dtype, e.nullable)
                   for i, e in enumerate(exprs)])


class InMemoryScanExec(LeafExec):
    """Leaf over an Arrow table (uploaded chunk by chunk as partitions run)
    or over batches already on a device (``schema`` then required).
    ``catalog`` is the buffer catalog of the tree above it (default: the
    device's process-wide one)."""

    def __init__(self, data, schema: Optional[Schema] = None,
                 batch_rows: Optional[int] = None, num_slices: int = 1,
                 device: DeviceLike = None,
                 ctx: EvalContext = EvalContext(),
                 catalog: Optional[BufferCatalog] = None):
        super().__init__(ctx)
        self._catalog = catalog
        self._num_slices = num_slices
        self._batch_rows = batch_rows
        if isinstance(data, pa.Table):
            self._table = data
            self._batches = None
            self._device = resolve_device(device)
            schema = schema or schema_from_arrow(data.schema)
        else:
            self._table = None
            self._batches = list(data)
            if schema is None:
                raise ValueError("schema required for device batches")
            self._device = (self._batches[0].device if self._batches
                            else resolve_device(device))
        self._schema = schema

    @property
    def output_schema(self) -> Schema:
        return self._schema

    @property
    def num_partitions(self) -> int:
        return self._num_slices

    @property
    def device(self) -> torch.device:
        return self._device

    def do_execute_partition(self, p: int) -> Iterator[ColumnarBatch]:
        if self._batches is not None:
            yield from self._batches[p::self._num_slices]
            return
        n = self._table.num_rows
        step = self._batch_rows or max(n, 1)
        # chunk i belongs to partition i % num_slices; an empty table is
        # one empty chunk, in partition 0
        for off in range(p * step, max(n, 1), step * self._num_slices):
            chunk = self._table.slice(off, step)
            yield with_retry_no_split(lambda c=chunk: self._h2d(c),
                                      catalog=self.catalog, name=self.name)

    def _h2d(self, chunk: pa.Table) -> ColumnarBatch:
        maybe_inject("scan.h2d")
        batch, _ = from_arrow(chunk, schema=self._schema,
                              device=self._device)
        return batch


class ProjectExec(UnaryExec):
    def __init__(self, exprs: Sequence[Expression], child: Exec,
                 ctx: Optional[EvalContext] = None):
        super().__init__(child, ctx)
        self.exprs = bind_all(exprs, child.output_schema)
        self._schema = schema_of(self.exprs)

    @property
    def output_schema(self) -> Schema:
        return self._schema

    def do_execute_partition(self, p: int) -> Iterator[ColumnarBatch]:
        for batch in self.child.execute_partition(p):
            cols = tuple(raw_eval(e, batch, self.ctx) for e in self.exprs)
            yield ColumnarBatch(cols, batch.num_rows)


class FilterExec(UnaryExec):
    """Keeps rows whose condition is true (a null condition drops the row),
    compacted to the front of the batch; the capacity stays."""

    def __init__(self, condition: Expression, child: Exec,
                 ctx: Optional[EvalContext] = None):
        super().__init__(child, ctx)
        self.condition = condition.bind(child.output_schema)
        if self.condition.dtype.kind is not TypeKind.BOOLEAN:
            raise TypeError(f"filter condition must be boolean, got "
                            f"{self.condition.dtype}")

    @property
    def output_schema(self) -> Schema:
        return self.child.output_schema

    def do_execute_partition(self, p: int) -> Iterator[ColumnarBatch]:
        for batch in self.child.execute_partition(p):
            c = self.condition.eval(batch, self.ctx)
            yield compact(batch, c.data & c.validity)


class LocalLimitExec(UnaryExec):
    """At most ``limit`` rows per partition. A limit is control flow: the
    rows each batch gave are read back to the host, one sync a batch."""

    def __init__(self, limit: int, child: Exec):
        super().__init__(child)
        self.limit = limit

    @property
    def output_schema(self) -> Schema:
        return self.child.output_schema

    def _take(self, batches: Iterator[ColumnarBatch]
              ) -> Iterator[ColumnarBatch]:
        remaining = self.limit
        for batch in batches:
            if remaining <= 0:
                return
            out = slice_batch(batch, 0, remaining)
            remaining -= int(out.num_rows)
            yield out

    def do_execute_partition(self, p: int) -> Iterator[ColumnarBatch]:
        yield from self._take(self.child.execute_partition(p))


class GlobalLimitExec(LocalLimitExec):
    """At most ``limit`` rows in all: drains the child's partitions in
    order into one."""

    @property
    def num_partitions(self) -> int:
        return 1

    def do_execute_partition(self, p: int) -> Iterator[ColumnarBatch]:
        yield from self._take(b for cp in range(self.child.num_partitions)
                              for b in self.child.execute_partition(cp))
