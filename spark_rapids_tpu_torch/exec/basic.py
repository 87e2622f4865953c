"""Basic operators: in-memory scan, project, filter, the limits, union,
range, sample and expand.

Port of ``spark_rapids_tpu/exec/basic.py``. The scan is the H2D boundary:
an Arrow table is cut into ``batch_rows`` chunks dealt round-robin to
``num_slices`` partitions, and a partition uploads only its own chunks,
when it runs. Each chunk's upload runs under the OOM retry loop (no split:
the chunk count fixes the round-robin), with the ``scan.h2d`` injection
site.

The ANSI contract: ``ProjectExec`` and ``FilterExec`` evaluate each batch
with a fresh error collector and raise ``ArithmeticException`` (or
``CapacityError`` for a ``CAPACITY_*`` kind) after the batch when a row was
reported. The counts are read back to the host only when a report was
made, which outside ANSI mode never happens.

``SampleExec`` draws the JAX package's threefry stream from (seed,
partition, batch ordinal) with ``expressions/math.py``'s helpers, so a
re-execution draws the same rows and both packages keep the same ones.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Sequence

import pyarrow as pa
import torch

from .. import types as T
from ..batch import (CapacityError, ColumnarBatch, DeviceColumn, DeviceLike,
                     Field, Schema, bucket_capacity, from_arrow,
                     resolve_device, rows_scalar, schema_from_arrow)
from ..expressions.base import Alias, EvalContext, Expression, raw_eval
from ..expressions.math import _MASK32, threefry2x32, uniform_doubles
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
    device's process-wide one). ``dict_conf`` (``dictenc.dict_conf``; the
    planner passes the Session's) decides whether a dictionary string
    column uploads as codes; None: the registry defaults."""

    def __init__(self, data, schema: Optional[Schema] = None,
                 batch_rows: Optional[int] = None, num_slices: int = 1,
                 device: DeviceLike = None,
                 ctx: EvalContext = EvalContext(),
                 catalog: Optional[BufferCatalog] = None,
                 dict_conf: Optional[tuple] = None):
        super().__init__(ctx)
        self._catalog = catalog
        self._dict_conf = dict_conf
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
                              device=self._device,
                              dict_conf=self._dict_conf)
        return batch


class ArithmeticException(ArithmeticError):
    """An ANSI-mode evaluation error (Spark's ArithmeticException)."""


def _sum_errors(ctx: EvalContext) -> Dict[str, torch.Tensor]:
    """kind -> the device count of rows reported under it."""
    return {k: torch.stack(v).sum() for k, v in ctx.errors.items()}


def _raise_ansi(errs: Dict[str, object]) -> None:
    """Raise for the first kind with a count above 0: ``CapacityError``
    for a ``CAPACITY_*`` kind, else ``ArithmeticException``. Counts are
    ints or device scalars; scalars are read in one transfer, and only
    when there is a kind to read."""
    if not errs:
        return
    counts = torch.stack([torch.as_tensor(c) for c in errs.values()])
    for kind, count in zip(errs, counts.tolist()):
        if count > 0:
            if kind.startswith("CAPACITY"):
                raise CapacityError(
                    f"[{kind}] {count} row(s) exceeded a fixed device "
                    f"budget; raise the budget or fall back to CPU")
            raise ArithmeticException(
                f"[{kind}] {count} row(s) failed (ANSI mode)")


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
        for i, batch in enumerate(self.child.execute_partition(p)):
            # the JAX package's seed: from the position, so that a
            # re-execution draws the same values
            ctx = EvalContext(self.ctx.ansi, {},
                              batch_seed=(p << 16) ^ (i & 0xFFFF))
            cols = tuple(raw_eval(e, batch, ctx) for e in self.exprs)
            _raise_ansi(_sum_errors(ctx))
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
            ctx = EvalContext(self.ctx.ansi, {})
            c = self.condition.eval(batch, ctx)
            _raise_ansi(_sum_errors(ctx))
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


class UnionExec(Exec):
    """The children's partitions one after another, unchanged."""

    def __init__(self, children: Sequence[Exec]):
        super().__init__(children)

    @property
    def output_schema(self) -> Schema:
        return self.children[0].output_schema

    @property
    def num_partitions(self) -> int:
        return sum(c.num_partitions for c in self.children)

    def do_execute_partition(self, p: int) -> Iterator[ColumnarBatch]:
        for c in self.children:
            if p < c.num_partitions:
                yield from c.execute_partition(p)
                return
            p -= c.num_partitions
        raise IndexError(p)


class RangeExec(LeafExec):
    """``id`` from ``start`` toward ``end`` by ``step`` (end excluded), in
    batches of at most ``batch_rows``, made on the device; no range still
    gives one empty batch."""

    def __init__(self, start: int, end: int, step: int = 1,
                 batch_rows: int = 1 << 20, name: str = "id",
                 device: DeviceLike = None):
        super().__init__()
        if step == 0:
            raise ValueError("step must not be 0")
        self.start, self.end, self.step = start, end, step
        self.batch_rows = batch_rows
        self._device = resolve_device(device)
        self._schema = Schema([Field(name, T.INT64, nullable=False)])

    @property
    def output_schema(self) -> Schema:
        return self._schema

    @property
    def device(self) -> torch.device:
        return self._device

    def do_execute_partition(self, p: int) -> Iterator[ColumnarBatch]:
        total = max(0, -(-(self.end - self.start) // self.step))
        emitted = 0
        while True:
            n = min(self.batch_rows, total - emitted)
            iota = torch.arange(bucket_capacity(max(n, 1)),
                                dtype=torch.int64, device=self._device)
            live = iota < n
            data = torch.where(
                live, iota * self.step + (self.start + emitted * self.step),
                0)
            yield ColumnarBatch((DeviceColumn(data, live, T.INT64),),
                                rows_scalar(n, self._device))
            emitted += n
            if emitted >= total:
                return


class SampleExec(UnaryExec):
    """Bernoulli row sample: each row is kept with probability
    ``fraction``, in input order. Batch ``i`` of partition ``p`` draws
    ``jax.random.uniform(fold_in(fold_in(PRNGKey(seed), p), i))`` as the
    JAX package does, in threefry on torch ops, so the kept rows are the
    JAX rows on the CPU and on the card alike."""

    def __init__(self, fraction: float, seed: int, child: Exec):
        super().__init__(child)
        self.fraction, self.seed = fraction, seed

    @property
    def output_schema(self) -> Schema:
        return self.child.output_schema

    def do_execute_partition(self, p: int) -> Iterator[ColumnarBatch]:
        seed = self.seed
        root = threefry2x32((seed >> 32) & _MASK32, seed & _MASK32, 0,
                            p & _MASK32)
        for i, batch in enumerate(self.child.execute_partition(p)):
            key = threefry2x32(*root, 0, i & _MASK32)
            u = uniform_doubles(key, batch.capacity, batch.device)
            yield compact(batch, u < self.fraction)


class ExpandExec(UnaryExec):
    """One output batch per projection per input batch (rollup, cube,
    grouping sets). A column is nullable if it is in any projection."""

    def __init__(self, projections: Sequence[Sequence[Expression]],
                 child: Exec, ctx: Optional[EvalContext] = None):
        super().__init__(child, ctx)
        self.projections = [bind_all(p, child.output_schema)
                            for p in projections]
        first = schema_of(self.projections[0])
        self._schema = Schema([
            Field(f.name, f.dtype, any(p[i].nullable
                                       for p in self.projections))
            for i, f in enumerate(first)])

    @property
    def output_schema(self) -> Schema:
        return self._schema

    def do_execute_partition(self, p: int) -> Iterator[ColumnarBatch]:
        for batch in self.child.execute_partition(p):
            for proj in self.projections:
                yield ColumnarBatch(tuple(e.eval(batch, self.ctx)
                                          for e in proj), batch.num_rows)
