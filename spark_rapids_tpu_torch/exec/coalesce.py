"""Batch coalescing.

Port of ``CoalesceBatchesExec`` with its goals ``TargetSize`` and
``RequireSingleBatch`` from ``spark_rapids_tpu/exec/coalesce.py``: under
``TargetSize`` batches of one partition concatenate until the next would
pass the byte target or the row limit; under ``RequireSingleBatch`` (a join's
build side) the whole partition becomes one batch. ``verify_coalesce_goals``
is the planner's check that every declared ``RequireSingleBatch`` is met.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, List

from ..batch import ColumnarBatch, Schema
from ..dictenc import unify_dict_batches
from .base import Exec, UnaryExec
from .common import concat_all


@dataclass(frozen=True)
class CoalesceGoal:
    pass


@dataclass(frozen=True)
class TargetSize(CoalesceGoal):
    """Accumulate up to this many bytes per output batch."""

    bytes: int = 512 << 20


@dataclass(frozen=True)
class RequireSingleBatch(CoalesceGoal):
    """The consumer needs all rows of a partition in one batch."""


class CoalesceBatchesExec(UnaryExec):
    def __init__(self, child: Exec, goal: CoalesceGoal = TargetSize(),
                 max_rows: int = 1 << 22):
        super().__init__(child)
        self.goal = goal
        self.max_rows = max_rows

    @property
    def output_schema(self) -> Schema:
        return self.child.output_schema

    @property
    def produces_single_batch(self) -> bool:
        return isinstance(self.goal, RequireSingleBatch) \
            or self.child.produces_single_batch

    def do_execute_partition(self, p: int) -> Iterator[ColumnarBatch]:
        pending: List[ColumnarBatch] = []
        pending_bytes = 0
        target = (self.goal.bytes if isinstance(self.goal, TargetSize)
                  else None)
        for batch in self.child.execute_partition(p):
            b = batch.size_bytes()
            # RequireSingleBatch (no target) never flushes mid-partition
            if target is not None and pending and (
                    pending_bytes + b > target
                    or sum(q.capacity for q in pending) + batch.capacity
                    > self.max_rows):
                yield self._flush(pending)
                pending, pending_bytes = [], 0
            pending.append(batch)
            pending_bytes += b
        if pending:
            yield self._flush(pending)

    def _flush(self, pending: List[ColumnarBatch]) -> ColumnarBatch:
        # per-batch string dictionaries unify onto one (a device code
        # remap), so the concat keeps the codes instead of decoding
        return concat_all(unify_dict_batches(pending), self.output_schema,
                          self.device)


class CoalesceGoalError(RuntimeError):
    """A declared coalesce goal is not met by the converted plan."""


def verify_coalesce_goals(plan: Exec) -> None:
    """Every child position whose parent declares ``RequireSingleBatch``
    must be served by a single-batch producer (a ``RequireSingleBatch``
    coalesce, or an operator that yields one batch per partition)."""
    for i, c in enumerate(plan.children):
        goal = plan.coalesce_goal_for_child(i)
        if isinstance(goal, RequireSingleBatch) and \
                not c.produces_single_batch:
            raise CoalesceGoalError(
                f"{plan.name} child {i} declares RequireSingleBatch but "
                f"{c.name} may emit multiple batches")
        verify_coalesce_goals(c)
