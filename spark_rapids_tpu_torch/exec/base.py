"""Operator base classes.

Port of ``spark_rapids_tpu/exec/base.py``: a pull-based iterator of batches
per partition, with the operator metrics the iteration maintains (output
rows and batches, and ``opTime``, the host time spent inside the operator's
iterator including its children) and a profiler range per step. Operators
run eagerly: each torch op is enqueued on the device's current stream as
the iterator advances.

Every operator that holds batches between uses registers them in a buffer
catalog (``memory/catalog.py``): the one it was given, else its first
child's, and at a leaf the process-wide catalog of its device. ``close``
releases what the tree still holds once a query is over; ``collect``
calls it.
"""

from __future__ import annotations

import time
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import pyarrow as pa
import torch

from .. import types as T
from ..batch import ColumnarBatch, Schema, to_arrow
from ..expressions.base import EvalContext
from ..memory.catalog import BufferCatalog, device_budget


class Metric:
    """A counter. ``add_lazy`` keeps a device scalar without waiting for
    the device; it is read when the metric is."""

    def __init__(self, name: str):
        self.name = name
        self.value = 0
        self._lazy: List[torch.Tensor] = []

    def add(self, v) -> None:
        self.value += int(v)

    def add_lazy(self, device_scalar: torch.Tensor) -> None:
        self._lazy.append(device_scalar)

    def total(self) -> int:
        if self._lazy:
            self.value += sum(int(x) for x in self._lazy)
            self._lazy.clear()
        return self.value


class Exec:
    """A physical operator. Subclasses define ``output_schema`` and
    ``do_execute_partition(p) -> Iterator[ColumnarBatch]``."""

    def __init__(self, children: Sequence["Exec"] = (),
                 ctx: EvalContext = EvalContext()):
        self.children: Tuple[Exec, ...] = tuple(children)
        self.ctx = ctx
        self.metrics: Dict[str, Metric] = {
            n: Metric(n) for n in ("numOutputRows", "numOutputBatches",
                                   "opTime")}
        self._catalog: Optional[BufferCatalog] = None

    @property
    def output_schema(self) -> Schema:
        raise NotImplementedError(type(self).__name__)

    @property
    def num_partitions(self) -> int:
        """Narrow operators keep their child's count; exchanges set theirs."""
        return self.children[0].num_partitions if self.children else 1

    @property
    def device(self) -> torch.device:
        """The device the operator's batches live on (its leaf's)."""
        return self.children[0].device

    @property
    def catalog(self) -> BufferCatalog:
        """The buffer catalog this operator registers its held batches in:
        the one it was given, else its first child's, and at a leaf the
        process-wide catalog of its device."""
        if self._catalog is None:
            self._catalog = (self.children[0].catalog if self.children
                             else device_budget(self.device))
        return self._catalog

    def do_execute_partition(self, p: int) -> Iterator[ColumnarBatch]:
        raise NotImplementedError(type(self).__name__)

    def coalesce_goal_for_child(self, i: int):
        """The batch-size contract this operator declares for child ``i``:
        None (no requirement), ``TargetSize`` (feed me batches near the
        configured size) or ``RequireSingleBatch`` (I need the whole
        partition in one batch). The planner's transition pass
        (``plan/overrides.insert_coalesce_transitions``) inserts a
        ``CoalesceBatchesExec`` to meet a declared goal and verifies it."""
        return None

    @property
    def produces_single_batch(self) -> bool:
        """True when every partition of this operator yields at most one
        batch (meets ``RequireSingleBatch`` without a coalesce)."""
        return False

    def close(self) -> None:
        """Release the catalog handles the tree still holds once the query
        is over (children first); subclasses override ``do_close``."""
        for c in self.children:
            c.close()
        self.do_close()

    def do_close(self) -> None:
        pass

    def execute(self) -> Iterator[ColumnarBatch]:
        """Every partition's batches in order. Exchanges keep what they
        registered in the catalog until ``close``: ``collect`` closes the
        plan, and a caller who iterates ``execute`` or ``execute_partition``
        itself must call ``close`` when done."""
        for p in range(self.num_partitions):
            yield from self.execute_partition(p)

    def execute_partition(self, p: int) -> Iterator[ColumnarBatch]:
        """Iterate one partition, maintaining the operator's metrics. Each
        step runs in a profiler range named like the operator, so a
        ``torch.profiler`` trace attributes host and device time to it
        (children nest inside, as in ``opTime``)."""
        it = self.do_execute_partition(p)
        while True:
            t0 = time.perf_counter_ns()
            try:
                with torch.profiler.record_function(self.name):
                    batch = next(it)
            except StopIteration:
                self.metrics["opTime"].add(time.perf_counter_ns() - t0)
                return
            self.metrics["opTime"].add(time.perf_counter_ns() - t0)
            self.metrics["numOutputBatches"].add(1)
            self.metrics["numOutputRows"].add_lazy(batch.num_rows)
            yield batch

    @property
    def name(self) -> str:
        return type(self).__name__

    def exec_names(self) -> List[str]:
        """Operator names, root first (depth-first)."""
        return [self.name] + [n for c in self.children
                              for n in c.exec_names()]


class LeafExec(Exec):
    def __init__(self, ctx: EvalContext = EvalContext()):
        super().__init__((), ctx)

    @property
    def device(self) -> torch.device:
        raise NotImplementedError(type(self).__name__)


class UnaryExec(Exec):
    def __init__(self, child: Exec, ctx: Optional[EvalContext] = None):
        super().__init__((child,), ctx or child.ctx)

    @property
    def child(self) -> Exec:
        return self.children[0]


class BinaryExec(Exec):
    def __init__(self, left: Exec, right: Exec,
                 ctx: Optional[EvalContext] = None):
        super().__init__((left, right), ctx or left.ctx)

    @property
    def left(self) -> Exec:
        return self.children[0]

    @property
    def right(self) -> Exec:
        return self.children[1]


def assemble_result(tables, schema: Schema) -> pa.Table:
    """Concatenate per-batch tables (empty input keeps the schema)."""
    tables = list(tables)
    if not tables:
        return pa.table({f.name: pa.array([], type=T.to_arrow(f.dtype))
                         for f in schema})
    return pa.concat_tables(tables)


def iter_subplan_tables(plan: Exec):
    """Run a plan and yield one host Arrow table per output batch, in
    partition order (the "subplan produced" side of the collect seam)."""
    schema = plan.output_schema
    for b in plan.execute():
        yield to_arrow(b, schema)


def collect(plan: Exec) -> pa.Table:
    """Run a plan and pull the result to the host as one Arrow table, then
    close the plan, so the query leaves no handle in any catalog."""
    try:
        return assemble_result(iter_subplan_tables(plan),
                               plan.output_schema)
    finally:
        plan.close()
