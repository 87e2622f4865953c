"""Hash aggregate as a sort-based segmented reduction.

Port of ``HashAggregateExec`` from ``spark_rapids_tpu/exec/aggregate.py``.
One sort by the grouping keys carries every aggregate input along; group
boundaries come from adjacent-equal sorted key words, group ids from their
running count, and every aggregate then reduces per group through the lane
contract of ``expressions/aggregates.py``.

Modes are Spark's: PARTIAL (update -> buffers), FINAL (merge buffers and
evaluate), COMPLETE (update, merge and evaluate). Between stages a batch
holds ``[group keys..., buffer columns...]`` in declaration order. Every
output batch keeps its input's capacity, as in the JAX package; where that
package chose among capacity tiers with ``lax.cond``, the group layout here
is sized from the observed group count.
"""

from __future__ import annotations

import enum
from typing import Iterator, List, Optional, Sequence, Tuple

import torch

from ..batch import ColumnarBatch, DeviceColumn, Field, Schema, rows_scalar
from ..expressions.aggregates import AggregateFunction, FastLanes, LaneResults
from ..expressions.base import (Alias, BoundReference, EvalContext,
                                Expression, raw_eval)
from .base import Exec, UnaryExec
from .basic import bind_all, output_name
from .common import (adjacent_equal_ops, concat_all, gather_columns,
                     lexsort, may_skip_null_lane, sort_operands)


class AggregateMode(enum.Enum):
    PARTIAL = "Partial"
    FINAL = "Final"
    COMPLETE = "Complete"


def _unalias(e: Expression) -> Tuple[AggregateFunction, str]:
    if isinstance(e, Alias):
        if not isinstance(e.child, AggregateFunction):
            raise TypeError(f"not an aggregate: {e!r}")
        return e.child, e.name
    if not isinstance(e, AggregateFunction):
        raise TypeError(f"not an aggregate: {e!r}")
    return e, type(e).__name__.lower()


def _pad_column(c: DeviceColumn, cap: int) -> DeviceColumn:
    """Zero/False-pad a column up to ``cap`` rows (a string column's byte
    matrix by whole rows, and its lengths)."""
    pad = cap - c.capacity
    if pad == 0:
        return c

    def pz(a):
        return None if a is None else torch.cat(
            [a, a.new_zeros((pad,) + a.shape[1:])])

    return DeviceColumn(pz(c.data), pz(c.validity), c.dtype, pz(c.lengths))


class HashAggregateExec(UnaryExec):
    def __init__(self, group_exprs: Sequence[Expression],
                 agg_exprs: Sequence[Expression], child: Exec,
                 mode: AggregateMode = AggregateMode.COMPLETE,
                 ctx: Optional[EvalContext] = None):
        super().__init__(child, ctx)
        self.mode = mode
        named = [_unalias(e) for e in agg_exprs]
        self.agg_names = [n for _, n in named]
        child_schema = child.output_schema
        if mode is not AggregateMode.FINAL:
            self.group_exprs = bind_all(group_exprs, child_schema)
            self.aggs = [a.bind(child_schema) for a, _ in named]
            self.key_fields = [Field(output_name(e, i), e.dtype, e.nullable)
                               for i, e in enumerate(self.group_exprs)]
        else:
            # buffer-layout input: keys by position, then buffers. The
            # aggregate functions must be bound against the pre-aggregation
            # schema; unbound ones are recovered from the PARTIAL stage
            self.aggs = [a for a, _ in named]
            if any(not c.resolved for a in self.aggs for c in a.children):
                src: Optional[Exec] = child
                while src is not None and \
                        not isinstance(src, HashAggregateExec):
                    src = src.children[0] if len(src.children) == 1 else None
                if src is None:
                    raise ValueError(
                        "FINAL-mode aggregate functions must be bound (or "
                        "the child chain must hold the PARTIAL stage)")
                self.aggs = list(src.aggs)
            nk = len(group_exprs)
            self.group_exprs = [BoundReference(i, f.dtype, f.nullable, f.name)
                                for i, f in enumerate(child_schema[:nk])]
            self.key_fields = list(child_schema[:nk])

        self.buffer_fields: List[Field] = [
            Field(f"{name}#{j}", bt, bn)
            for agg, name in zip(self.aggs, self.agg_names)
            for j, (bt, bn) in enumerate(zip(agg.buffer_types(),
                                             agg.buffer_nullable()))]
        if mode is AggregateMode.PARTIAL:
            self._schema = Schema(self.key_fields + self.buffer_fields)
        else:
            self._schema = Schema(self.key_fields + [
                Field(n, a.dtype, a.nullable)
                for a, n in zip(self.aggs, self.agg_names)])

        # update inputs: aggregates over the same bound column share one
        # sorted payload column
        self._upd_value_exprs: List[Expression] = []
        self._upd_per_agg: List[List[int]] = []
        index_of = {}
        for agg in self.aggs:
            idxs = []
            for c in agg.children:
                k = ("ref", c.ordinal) if isinstance(c, BoundReference) \
                    else id(c)
                if k not in index_of:
                    index_of[k] = len(self._upd_value_exprs)
                    self._upd_value_exprs.append(c)
                idxs.append(index_of[k])
            self._upd_per_agg.append(idxs)
        self._buf_per_agg: List[List[int]] = []
        off = 0
        for agg in self.aggs:
            nb = len(agg.buffer_types())
            self._buf_per_agg.append(list(range(off, off + nb)))
            off += nb

    @property
    def output_schema(self) -> Schema:
        return self._schema

    # ------------------------------------------------------------------
    # Kernels
    # ------------------------------------------------------------------

    def _group_kernel(self, batch: ColumnarBatch, merge: bool,
                      final: bool) -> ColumnarBatch:
        """One key sort carrying every input as payload, then the batched
        lane reductions over the sorted layout. Without keys (a global
        aggregate) the live rows form one group."""
        cap, dev = batch.capacity, batch.device
        in_live = batch.row_mask()
        nk = len(self.key_fields)
        if merge:
            key_cols = list(batch.columns[:nk])
            flat_vals = list(batch.columns[nk:])
            per_agg = self._buf_per_agg
            nullable = [f.nullable for f in self.key_fields]
            val_nullable = [f.nullable for f in self.buffer_fields]
        else:
            key_cols = [raw_eval(e, batch, self.ctx) for e in self.group_exprs]
            flat_vals = [e.eval(batch, self.ctx)
                         for e in self._upd_value_exprs]
            per_agg = self._upd_per_agg
            nullable = [not may_skip_null_lane(e) for e in self.group_exprs]
            val_nullable = [e.nullable for e in self._upd_value_exprs]

        key_ops = sort_operands(key_cols, [False] * nk, [True] * nk,
                                in_live, nullable)
        perm = lexsort(key_ops)
        n_live = int(in_live.sum())
        sorted_live = torch.arange(cap, device=dev) < n_live
        # provably non-null columns share ONE validity object (sorted_live),
        # which also shares their non-null-count lane downstream
        svals = [DeviceColumn(c.data[perm],
                              c.validity[perm] if nl else sorted_live,
                              c.dtype,
                              None if c.lengths is None else c.lengths[perm])
                 for c, nl in zip(flat_vals, val_nullable)]
        # the dead-row operand is not needed once live rows come first;
        # without keys every live row joins group 0
        eq = (adjacent_equal_ops([op[perm] for op in key_ops[1:]]) if nk
              else torch.arange(cap, device=dev) > 0)
        new_group = sorted_live & ~eq
        gid = torch.cumsum(new_group, 0) - 1
        starts = torch.nonzero(new_group).squeeze(1)
        # a global aggregate yields one row even over no live row
        count = starts.shape[0] if nk else 1

        lanes = FastLanes(sorted_live)
        finishers = []
        for agg, idxs in zip(self.aggs, per_agg):
            views = [svals[i] for i in idxs]
            finishers.append(agg.fast_merge(views, sorted_live, lanes)
                             if merge else
                             agg.fast_update(views, sorted_live, lanes))
        res = LaneResults(lanes, gid, n_live, count)
        live_slot = torch.ones(count, dtype=torch.bool, device=dev)
        out_cols = gather_columns(key_cols, perm[starts], live_slot)
        for agg, finish in zip(self.aggs, finishers):
            bufs = finish(res)
            if merge and final:
                out_cols.append(agg.evaluate(bufs, live_slot))
            else:
                out_cols.extend(bufs)
        return ColumnarBatch(tuple(_pad_column(c, cap) for c in out_cols),
                             rows_scalar(count, dev))

    def _update_kernel(self, batch: ColumnarBatch) -> ColumnarBatch:
        """input rows -> buffer-layout batch."""
        return self._group_kernel(batch, merge=False, final=False)

    def _merge_kernel(self, batch: ColumnarBatch,
                      final: bool) -> ColumnarBatch:
        """buffer-layout rows -> merged buffer rows (or final results)."""
        return self._group_kernel(batch, merge=True, final=final)

    # ------------------------------------------------------------------
    # Iterator
    # ------------------------------------------------------------------

    def do_execute_partition(self, p: int) -> Iterator[ColumnarBatch]:
        partials = [self._update_kernel(b)
                    if self.mode is not AggregateMode.FINAL else b
                    for b in self.child.execute_partition(p)]
        # a global aggregate over no input still yields one row
        if not partials and (self.key_fields or p != 0):
            return
        merged = concat_all(partials,
                            Schema(self.key_fields + self.buffer_fields),
                            self.device)
        yield self._merge_kernel(
            merged, final=self.mode is not AggregateMode.PARTIAL)
