"""Hash aggregate as a sort-based segmented reduction.

Port of ``HashAggregateExec`` from ``spark_rapids_tpu/exec/aggregate.py``.
One sort by the grouping keys carries every aggregate input along; group
boundaries come from adjacent-equal sorted key words, group ids from their
running count, and every aggregate then reduces per group through the lane
contract of ``expressions/aggregates.py``.

Modes are Spark's: PARTIAL (update -> buffers), FINAL (merge buffers and
evaluate), COMPLETE (update, merge and evaluate). An exec holding a
sort-sensitive aggregate (Percentile and its kin: COMPLETE only, one per
exec) concatenates its partition and runs one update over it, sorted by
(keys, value). ``_update_kernel(batch, mask)`` fuses an upstream filter:
rows outside the mask are dead rows of the key sort. Between stages a batch
holds ``[group keys..., buffer columns...]`` in declaration order. Every
output batch keeps its input's capacity, as in the JAX package; where that
package chose among capacity tiers with ``lax.cond``, the group layout here
is sized from the observed group count (two host reads). With
``static=True`` (the fused stage, which runs captured in a CUDA graph) the
kernel reads nothing back: groups are laid out at the input's capacity,
their starts come from a stable compaction and the group count stays a
device scalar.

The partials of a partition wait in the spill catalog, and no merge pins
more than ``max_result_rows`` of their capacity at once
(``_merge_and_emit``): partials over that budget merge in windows, pass by
pass, until they fit; a pass that shrinks them by less than a tenth (high
cardinality) hands them to the sort-based out-of-core merge, which streams
them in global key order through ``OutOfCoreSorter`` and merges chunk by
chunk, carrying the boundary group into the next chunk. The metrics
``windowedMergePasses`` and ``oocMerges`` count both. Merges add partial
sums in the same grouping as the JAX package's.
"""

from __future__ import annotations

import enum
from typing import Iterator, List, Optional, Sequence, Tuple

import torch

from ..batch import (MIN_CAPACITY, ColumnarBatch, DeviceColumn, Field,
                     Schema, bucket_capacity, empty_batch, map_lanes,
                     rows_scalar)
from ..config import AGG_MAX_RESULT_ROWS
from ..expressions.aggregates import AggregateFunction, FastLanes, LaneResults
from ..expressions.base import (Alias, BoundReference, EvalContext,
                                Expression, raw_eval, same_node)
from ..memory.catalog import SpillableBatch
from ..memory.retry import (acquire_with_retry, register_with_retry,
                            with_retry_no_split)
from .base import Exec, Metric, UnaryExec
from .basic import bind_all, output_name
from .common import (adjacent_equal_ops, compaction_indices, concat_all,
                     concat_batches, gather_columns, lexsort,
                     may_skip_null_lane, slice_batch, sort_operands)


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
    matrix by whole rows, and its lengths; a dictionary column's codes)."""
    pad = cap - c.capacity
    if pad == 0:
        return c
    return map_lanes(c, lambda a: torch.cat(
        [a, a.new_zeros((pad,) + a.shape[1:])]))


def _dead_past(c: DeviceColumn, live: torch.Tensor) -> DeviceColumn:
    """``c`` with the rows outside ``live`` dead: invalid, zero payload."""
    def dead(a):
        row = live.view((-1,) + (1,) * (a.dim() - 1))
        return torch.where(row, a, torch.zeros((), dtype=a.dtype,
                                               device=a.device))
    return map_lanes(c, dead)


def _sorted_view(c: DeviceColumn, perm: torch.Tensor,
                 shared_validity: Optional[torch.Tensor]) -> DeviceColumn:
    """``c`` permuted by the key sort; a provably non-null column takes
    ``shared_validity`` as its validity object. The view carries no
    dictionary: an aggregate's inputs arrive decoded."""
    out = map_lanes(c, lambda a: a[perm]).replace(dict_data=None,
                                                  dict_lengths=None)
    if shared_validity is not None:
        out = out.replace(validity=shared_validity)
    return out


class HashAggregateExec(UnaryExec):
    def coalesce_goal_for_child(self, i):
        from .coalesce import TargetSize
        return TargetSize()

    def __init__(self, group_exprs: Sequence[Expression],
                 agg_exprs: Sequence[Expression], child: Exec,
                 mode: AggregateMode = AggregateMode.COMPLETE,
                 ctx: Optional[EvalContext] = None,
                 max_result_rows: int = AGG_MAX_RESULT_ROWS.default):
        super().__init__(child, ctx)
        self.mode = mode
        self.max_result_rows = max_result_rows
        #: windowed merge passes, and hand-offs to the out-of-core merge
        for name in ("windowedMergePasses", "oocMerges"):
            self.metrics[name] = Metric(name)
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

        # percentile and its kin read each group's values in order: one
        # per exec, COMPLETE only, over the partition's rows sorted by
        # (keys, value)
        self.sort_sensitive = [a for a in self.aggs
                               if getattr(a, "requires_sorted_input", False)]
        if len(self.sort_sensitive) > 1:
            raise ValueError(
                "one sort-sensitive aggregate (percentile) per exec; the "
                "planner must split multi-percentile projections")
        if self.sort_sensitive and mode is not AggregateMode.COMPLETE:
            raise ValueError(
                f"{type(self.sort_sensitive[0]).__name__} supports "
                f"COMPLETE mode only (not decomposable)")

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
                      final: bool, mask: Optional[torch.Tensor] = None,
                      static: bool = False) -> ColumnarBatch:
        """One key sort carrying every input as payload, then the batched
        lane reductions over the sorted layout. Without keys (a global
        aggregate) the live rows form one group. Rows outside ``mask``
        are dead rows of the sort, like padding. A sort-sensitive
        aggregate's input joins the sort after the keys, ascending with
        nulls first; group boundaries stay the keys'. ``static``: no host
        read (see the module's docstring)."""
        cap, dev = batch.capacity, batch.device
        in_live = batch.row_mask()
        if mask is not None:
            in_live = in_live & mask
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
        sort_ops = key_ops
        if self.sort_sensitive and not merge:
            values = [flat_vals[i] for i in self._upd_per_agg[
                same_node(self.sort_sensitive[0], self.aggs)]]
            n = len(values)
            sort_ops = key_ops + sort_operands(values, [False] * n,
                                               [True] * n, in_live)[1:]
        perm = lexsort(sort_ops)
        live_rows = in_live.sum()
        n_live = cap if static else int(live_rows)
        sorted_live = torch.arange(cap, device=dev) < live_rows
        # provably non-null columns share ONE validity object (sorted_live),
        # which also shares their non-null-count lane downstream
        svals = [_sorted_view(c, perm, None if nl else sorted_live)
                 for c, nl in zip(flat_vals, val_nullable)]
        # the dead-row operand is not needed once live rows come first;
        # without keys every live row joins group 0
        eq = (adjacent_equal_ops([op[perm] for op in key_ops[1:]]) if nk
              else torch.arange(cap, device=dev) > 0)
        new_group = sorted_live & ~eq
        gid = torch.cumsum(new_group, 0) - 1
        if static:
            # every lane masks its rows with sorted_live, so the dead rows
            # may sit in any group: clamp them in range (-1 with no group)
            gid = gid.clamp(min=0)
            starts, n_groups = compaction_indices(new_group)
            count = cap
            group_live = (torch.arange(cap, device=dev)
                          < (n_groups if nk else 1))
        else:
            starts = torch.nonzero(new_group).squeeze(1)
            # a global aggregate yields one row even over no live row
            count = starts.shape[0] if nk else 1
            group_live = torch.ones(count, dtype=torch.bool, device=dev)

        lanes = FastLanes(sorted_live)
        finishers = []
        for agg, idxs in zip(self.aggs, per_agg):
            views = [svals[i] for i in idxs]
            finishers.append(agg.fast_merge(views, sorted_live, lanes)
                             if merge else
                             agg.fast_update(views, sorted_live, lanes))
        # a global aggregate over no live row has one group and no start
        group_starts = (starts if starts.shape[0] == count else
                        torch.zeros(count, dtype=torch.int64, device=dev))
        res = LaneResults(lanes, gid, n_live, count, group_starts)
        out_cols = gather_columns(key_cols, perm[group_starts], group_live)
        for agg, finish in zip(self.aggs, finishers):
            bufs = finish(res)
            if merge and final:
                out_cols.append(agg.evaluate(bufs, group_live))
            else:
                out_cols.extend(bufs)
        if static:
            return ColumnarBatch(
                tuple(_dead_past(c, group_live) for c in out_cols),
                group_live.sum(dtype=torch.int32))
        return ColumnarBatch(tuple(_pad_column(c, cap) for c in out_cols),
                             rows_scalar(count, dev))

    def _update_kernel(self, batch: ColumnarBatch,
                       mask: Optional[torch.Tensor] = None,
                       static: bool = False) -> ColumnarBatch:
        """input rows -> buffer-layout batch. ``mask`` fuses an upstream
        filter into the aggregation: rows outside it become dead rows of
        the key sort, with no compaction."""
        return self._group_kernel(batch, merge=False, final=False, mask=mask,
                                  static=static)

    def _merge_kernel(self, batch: ColumnarBatch, final: bool,
                      static: bool = False) -> ColumnarBatch:
        """buffer-layout rows -> merged buffer rows (or final results)."""
        return self._group_kernel(batch, merge=True, final=final,
                                  static=static)

    def _eval_buffers_kernel(self, batch: ColumnarBatch) -> ColumnarBatch:
        """Buffer-layout rows whose groups are already unique -> final
        results, without a merge pass."""
        nk = len(self.key_fields)
        group_live = batch.row_mask()
        out_cols = list(batch.columns[:nk])
        for agg, idxs in zip(self.aggs, self._buf_per_agg):
            out_cols.append(agg.evaluate([batch.columns[nk + i]
                                          for i in idxs], group_live))
        return ColumnarBatch(tuple(out_cols), batch.num_rows)

    # ------------------------------------------------------------------
    # Iterator
    # ------------------------------------------------------------------

    def do_execute_partition(self, p: int) -> Iterator[ColumnarBatch]:
        cat = self.catalog
        buf_schema = Schema(self.key_fields + self.buffer_fields)
        finalize = self.mode is not AggregateMode.PARTIAL
        if self.sort_sensitive:
            yield from self._sorted_partition(p)
            return
        entries: List[Tuple[SpillableBatch, int]] = []
        try:
            for batch in self.child.execute_partition(p):
                part = (batch if self.mode is AggregateMode.FINAL
                        else self._update_kernel(batch))
                # a registered handle starts unpinned (spillable); the
                # catalog holds the only reference to it from here
                entries.append((register_with_retry(
                    part, buf_schema, catalog=cat, name=self.name),
                    part.capacity))
                del batch, part
            if not entries:
                # a global aggregate over no input still yields one row
                if not self.key_fields and p == 0:
                    yield self._merge_kernel(
                        empty_batch(buf_schema, self.device), finalize)
                return
            yield from self._merge_and_emit(entries, finalize, buf_schema)
        finally:
            for sb, _ in entries:
                sb.close()

    def _sorted_partition(self, p: int) -> Iterator[ColumnarBatch]:
        """The sort-sensitive branch: no decomposition exists, so the
        partition's rows are concatenated and take one update, sorted by
        (keys, value), whose buffers are evaluated as they stand."""
        raw = list(self.child.execute_partition(p))
        if not raw:
            # a global aggregate over no input still yields one row
            if not self.key_fields and p == 0:
                yield self._eval_buffers_kernel(self._update_kernel(
                    empty_batch(self.child.output_schema, self.device)))
            return
        whole = concat_all(raw, self.child.output_schema, self.device)
        raw.clear()
        yield self._eval_buffers_kernel(self._update_kernel(whole))

    def _merge_and_emit(self, entries: List[Tuple[SpillableBatch, int]],
                        finalize: bool, buf_schema: Schema
                        ) -> Iterator[ColumnarBatch]:
        """Merge the partials without ever pinning more than
        ``max_result_rows`` of their capacity at once: windowed merge
        passes while they shrink, the sort-based out-of-core merge once a
        pass shrinks them by less than a tenth. ``entries`` is updated in
        place, so the caller closes the handles that are live."""
        cat = self.catalog

        def acquire_group(grp) -> List[ColumnarBatch]:
            """Pin a group transactionally: an OOM mid-loop unpins what
            this attempt pinned, so the retry starts from a spillable
            state."""
            got = []
            try:
                for sb, _ in grp:
                    got.append(sb.get())
            except BaseException:
                for j in range(len(got)):
                    grp[j][0].done_with()
                raise
            return got

        window = self.max_result_rows
        while True:
            total = sum(c for _, c in entries)
            if len(entries) == 1 or total <= window:
                def final_merge():
                    batches = acquire_group(entries)
                    merged = (batches[0] if len(batches) == 1 else
                              concat_batches(batches, bucket_capacity(total)))
                    for sb, _ in entries:
                        sb.done_with()
                    return merged
                merged = with_retry_no_split(final_merge, catalog=cat,
                                             name=self.name)
                yield self._merge_kernel(merged, finalize)
                return
            # one windowed merge pass
            self.metrics["windowedMergePasses"].add(1)
            new_entries: List[Tuple[SpillableBatch, int]] = []
            shrunk, i = 0, 0
            while i < len(entries):
                grp, cap_sum = [], 0
                while i < len(entries) and (
                        not grp or cap_sum + entries[i][1] <= window):
                    grp.append(entries[i])
                    cap_sum += entries[i][1]
                    i += 1
                if len(grp) == 1:
                    new_entries.append(grp[0])
                    continue

                def window_merge(grp=grp, cap_sum=cap_sum):
                    batches = acquire_group(grp)
                    merged = self._merge_kernel(
                        concat_batches(batches, bucket_capacity(cap_sum)),
                        False)
                    out_cap = bucket_capacity(max(int(merged.num_rows), 1))
                    if out_cap < merged.capacity:
                        merged = slice_batch(merged, 0, out_cap, out_cap)
                    for sb, _ in grp:
                        sb.done_with()
                    return merged

                merged = with_retry_no_split(window_merge, catalog=cat,
                                             name=self.name)
                for sb, _ in grp:
                    sb.close()
                nsb = register_with_retry(merged, buf_schema, catalog=cat,
                                          name=self.name)
                new_entries.append((nsb, merged.capacity))
                shrunk += cap_sum - merged.capacity
            entries[:] = new_entries
            if shrunk * 10 < total:
                # high cardinality: merging barely shrinks
                self.metrics["oocMerges"].add(1)
                yield from self._ooc_sorted_merge(entries, finalize,
                                                  buf_schema)
                return

    def _ooc_sorted_merge(self, entries: List[Tuple[SpillableBatch, int]],
                          finalize: bool, buf_schema: Schema
                          ) -> Iterator[ColumnarBatch]:
        """Sort-based out-of-core merge: the partials in global key order
        through the spilled chunked merge tree, then one bounded merge per
        chunk. Only the last group of a chunk can continue into the next,
        so it is carried; every other group is emitted."""
        from .ooc_sort import OutOfCoreSorter
        from .sort import SortOrder

        orders = [SortOrder(BoundReference(i, f.dtype, f.nullable, f.name))
                  for i, f in enumerate(self.key_fields)]
        chunk_rows = max(min(self.max_result_rows // 4, 1 << 16),
                         MIN_CAPACITY)
        sorter = OutOfCoreSorter(orders, buf_schema, self.catalog,
                                 chunk_rows=chunk_rows)

        def batches():
            for sb, _ in entries:
                b = acquire_with_retry(sb, name=self.name)
                sb.done_with()
                yield b

        carry: Optional[ColumnarBatch] = None
        for chunk in sorter.sort(batches()):
            if carry is not None:
                chunk = concat_batches([carry, chunk], bucket_capacity(
                    carry.capacity + chunk.capacity))
            merged = self._merge_kernel(chunk, False)
            n = int(merged.num_rows)
            if n == 0:
                carry = None
                continue
            carry = slice_batch(merged, n - 1, 1, MIN_CAPACITY)
            if n == 1:
                continue
            emit = slice_batch(merged, 0, n - 1, bucket_capacity(n - 1))
            yield self._eval_buffers_kernel(emit) if finalize else emit
        if carry is not None:
            yield self._eval_buffers_kernel(carry) if finalize else carry
