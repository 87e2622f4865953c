"""The window operator.

Port of ``spark_rapids_tpu/exec/window.py`` (reference: GpuWindowExec.scala
:1876, the running window :1534 and the double pass :1846). See
``expressions/window.py`` for the lowering: one sort of each batch by the
partition keys and then the order keys, then segmented scans. Every window
expression of the operator shares that layout.

The output is the child's columns and one column per window expression,
in the child's row order (each result is gathered back through the
inverse of the sort's permutation), as Spark's WindowExec gives it.

What XLA shares between the JAX package's expressions in one trace (the
inverse permutation, the partition and peer bounds, the partition ids,
the sorted order column) is computed once per batch here, on first use,
in a ``_Layout`` that each expression reads; the layout also carries the
batch and the permutation that the value-bounded RANGE rank needs, where
the JAX exec kept them on ``self`` for the length of a trace.
"""

from __future__ import annotations

from typing import Iterator, List, Optional, Sequence, Tuple

import torch

from .. import types as T
from ..batch import (ColumnarBatch, DeviceColumn, Field, Schema,
                     bucket_capacity, zip_lanes)
from ..dictenc import decode_column
from ..expressions.base import (Alias, EvalContext, Expression,
                                _align_string_widths, raw_eval)
from ..expressions.window import (CumeDist, LagLead, NthValue, NTile,
                                  PercentRank, Rank, RowNumber, WindowAgg,
                                  WindowExpression, WindowFrame,
                                  segment_ends, segment_starts,
                                  segmented_int_sum, segmented_scan,
                                  unsupported_frame_reason)
from ..types import TypeKind
from .base import Exec, UnaryExec
from .common import (adjacent_equal_ops, concat_batches, gather_column,
                     lexsort, orderable_words, sort_operands)


def _unalias(e: Expression) -> Tuple[WindowExpression, str]:
    if isinstance(e, Alias):
        return e.child, e.name
    return e, "window"


#: ROWS frames narrower than this fold shifted copies (exact for every op)
SHIFT_FOLD_ROWS = 64

#: value types whose Min and Max reduce on their data elementwise
_ELEMENTWISE_MINMAX = frozenset({
    TypeKind.BOOLEAN, TypeKind.INT8, TypeKind.INT16, TypeKind.INT32,
    TypeKind.INT64, TypeKind.DATE, TypeKind.TIMESTAMP, TypeKind.FLOAT32,
    TypeKind.FLOAT64})


def window_agg_unsupported_reason(agg: Expression) -> Optional[str]:
    """Why the device window cannot reduce this aggregate, or None. An
    average over a decimal must give Spark's decimal, which the double
    buffer cannot (the JAX aggregate's reason, word for word). Min and Max
    over a string reduce on value ranks; a DECIMAL128 value or result
    never gets here (the window's type signature refuses the column)."""
    name = type(agg).__name__
    if name not in ("Count", "Sum", "Average", "Min", "Max"):
        return f"window aggregate {name} has no device frame reduction"
    d = agg.children[0].dtype if agg.children else None
    if name == "Average" and d.kind is TypeKind.DECIMAL:
        p, s = d.precision, d.scale
        return (f"avg over decimal({p},{s}) must return Spark's "
                f"decimal({min(p + 4, 38)},{min(s + 4, 38)}) with "
                f"HALF_UP rounding; the device buffer is double")
    return None


class _Layout:
    """One batch sorted by the window spec, with the bounds every function
    reads; each is computed on first use and kept for the batch."""

    def __init__(self, batch: ColumnarBatch, perm: torch.Tensor,
                 head: torch.Tensor, tail: torch.Tensor,
                 peer_head: torch.Tensor, live: torch.Tensor):
        self.batch = batch
        self.perm = perm
        self.head = head
        self.tail = tail
        self.peer_head = peer_head
        self.live = live
        self.cap = batch.capacity
        self.iota = torch.arange(self.cap, device=batch.device)
        self._memo = {}

    def _get(self, name, make):
        v = self._memo.get(name)
        if v is None:
            v = self._memo[name] = make()
        return v

    @property
    def seg_start(self):
        return self._get("seg_start", lambda: segment_starts(self.head))

    @property
    def seg_end(self):
        return self._get("seg_end", lambda: segment_ends(self.tail))

    @property
    def seg_len(self):
        return self._get("seg_len", lambda: self.seg_end - self.seg_start + 1)

    @property
    def peer_start(self):
        return self._get("peer_start", lambda: segment_starts(self.peer_head))

    @property
    def peer_tail(self):
        return self._get("peer_tail", lambda: torch.cat(
            [self.peer_head[1:], torch.ones(1, dtype=torch.bool,
                                            device=self.head.device)])
            | self.tail)

    @property
    def peer_end(self):
        return self._get("peer_end", lambda: segment_ends(self.peer_tail))

    @property
    def pid(self):
        """The partition number of each sorted row (int64)."""
        return self._get("pid", lambda: torch.cumsum(self.head, 0))

    @property
    def inverse(self):
        """The sorted position of each input row."""
        def make():
            inv = torch.empty_like(self.perm)
            inv[self.perm] = self.iota
            return inv
        return self._get("inverse", make)

    def sorted_eval(self, e: Expression, ctx: EvalContext) -> DeviceColumn:
        key = ("sorted", id(e))
        return self._get(key, lambda: gather_column(
            raw_eval(e, self.batch, ctx), self.perm))


class WindowExec(UnaryExec):
    """Window expressions that share one partition and order spec (the
    planner makes one exec per ``DataFrame.window`` call; several specs
    chain execs, as the reference's GpuWindowExec does)."""

    def coalesce_goal_for_child(self, i):
        from .coalesce import TargetSize
        return TargetSize()

    def __init__(self, window_exprs: Sequence[Expression], child: Exec,
                 ctx: Optional[EvalContext] = None):
        super().__init__(child, ctx)
        named = [_unalias(e) for e in window_exprs]
        self.exprs = [w.bind(child.output_schema) for w, _ in named]
        self.names = [n for _, n in named]
        spec_keys = {(repr(w.spec.partition_keys), repr(w.spec.orders))
                     for w in self.exprs}
        if len(spec_keys) > 1:
            raise ValueError("one WindowExec handles one partition/order "
                             "spec; chain execs for multiple")
        self.spec = self.exprs[0].spec
        # frames the device cannot express fail here; the planner makes
        # them islands before it builds the exec (without this a bounded
        # RANGE frame would silently take ROWS semantics)
        for w in self.exprs:
            if isinstance(w.function, (WindowAgg, NthValue)):
                reason = unsupported_frame_reason(w.spec.frame, w.spec)
                if reason:
                    raise NotImplementedError(reason)
            if isinstance(w.function, WindowAgg):
                reason = window_agg_unsupported_reason(w.function.agg)
                if reason:
                    raise NotImplementedError(reason)
        fields = list(child.output_schema.fields)
        for w, n in zip(self.exprs, self.names):
            fields.append(Field(n, w.dtype, w.nullable))
        self._schema = Schema(fields)

    @property
    def output_schema(self) -> Schema:
        return self._schema

    # ------------------------------------------------------------------

    def _window_kernel(self, batch: ColumnarBatch) -> ColumnarBatch:
        spec = self.spec
        live = batch.row_mask()
        pkeys = [raw_eval(e, batch, self.ctx) for e in spec.partition_keys]
        okeys = [raw_eval(o.child, batch, self.ctx) for o in spec.orders]
        p_ops = sort_operands(pkeys, [False] * len(pkeys),
                              [True] * len(pkeys), live)
        o_ops = sort_operands(okeys, [o.descending for o in spec.orders],
                              [o.effective_nulls_first for o in spec.orders],
                              live)[1:]
        perm = lexsort(p_ops + o_ops)
        cap = batch.capacity
        iota = torch.arange(cap, device=batch.device)
        sorted_live = iota < batch.num_rows
        # partition and peer boundaries on the sorted key operands (the
        # first operand, the live lane, ends the last partition)
        same_part = adjacent_equal_ops([w[perm] for w in p_ops])
        head = sorted_live & ~same_part
        tail = sorted_live & torch.cat(
            [~same_part[1:] | ~sorted_live[1:],
             torch.ones(1, dtype=torch.bool, device=batch.device)])
        same_peer = same_part
        if o_ops:
            same_peer = same_part & adjacent_equal_ops(
                [w[perm] for w in o_ops])
        peer_head = sorted_live & ~same_peer
        lay = _Layout(batch, perm, head, tail, peer_head, sorted_live)
        out_cols = []
        for w in self.exprs:
            col = self._eval_window(w, lay)
            out_cols.append(gather_column(col, lay.inverse, live))
        return ColumnarBatch(batch.columns + tuple(out_cols), batch.num_rows)

    # ------------------------------------------------------------------

    def _eval_window(self, w: WindowExpression, lay: _Layout
                     ) -> DeviceColumn:
        fn = w.function
        live = lay.live
        if isinstance(fn, RowNumber):
            pos = lay.iota - lay.seg_start
            return DeviceColumn((pos + 1).to(torch.int32), live, T.INT32)
        if isinstance(fn, Rank):
            if fn.dense:
                v = segmented_int_sum(lay.peer_head, lay.seg_start)
            else:
                v = lay.peer_start - lay.seg_start + 1
            return DeviceColumn(v.to(torch.int32), live, T.INT32)
        if isinstance(fn, PercentRank):
            rank = lay.peer_start - lay.seg_start + 1
            n = lay.seg_len
            v = torch.where(n > 1, (rank - 1).double()
                            / (n - 1).clamp(min=1).double(), 0.0)
            return DeviceColumn(v, live, T.FLOAT64)
        if isinstance(fn, CumeDist):
            v = (lay.peer_end - lay.seg_start + 1).double() \
                / lay.seg_len.clamp(min=1).double()
            return DeviceColumn(v, live, T.FLOAT64)
        if isinstance(fn, NthValue):
            s = lay.sorted_eval(fn.child, self.ctx)
            lo, hi = self._frame_bounds(w.spec.frame, lay)
            idx = lo + fn.n - 1
            ok = (idx <= hi) & (idx >= lo) & live
            v = gather_column(s, idx.clamp(0, lay.cap - 1))
            return v.replace(validity=v.validity & ok)
        if isinstance(fn, NTile):
            pos = lay.iota - lay.seg_start
            n = lay.seg_len
            b = fn.buckets
            base, rem = n // b, n % b
            cut = rem * (base + 1)
            v = torch.where(pos < cut, pos // (base + 1).clamp(min=1),
                            rem + (pos - cut) // base.clamp(min=1)) + 1
            return DeviceColumn(v.to(torch.int32), live, T.INT32)
        if isinstance(fn, LagLead):
            return self._lag_lead(fn, lay)
        if isinstance(fn, WindowAgg):
            return self._eval_window_agg(fn, w.spec.frame, lay)
        raise NotImplementedError(type(fn).__name__)

    def _lag_lead(self, fn: LagLead, lay: _Layout) -> DeviceColumn:
        s = lay.sorted_eval(fn.child, self.ctx)
        off = fn.offset if fn.is_lag else -fn.offset
        src = lay.iota - off
        ix = src.clamp(0, lay.cap - 1)
        # the source row must be live too: padding rows carry the last
        # partition's number
        same = (src >= 0) & (src < lay.cap) & (lay.pid[ix] == lay.pid) \
            & lay.live[ix] & lay.live
        sv = gather_column(s, ix)
        sv = sv.replace(validity=sv.validity & same)
        if fn.default is None:
            return sv
        d = gather_column(raw_eval(fn.default, lay.batch, self.ctx),
                          lay.perm)
        if sv.is_dict or d.is_dict:
            sv, d = decode_column(sv), decode_column(d)
        if sv.dtype.kind is TypeKind.STRING:
            da, dd = _align_string_widths(sv, d)
            sv, d = sv.replace(data=da), d.replace(data=dd)
        use_d = ~same & lay.live

        def pick(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
            m = use_d.view((-1,) + (1,) * (a.dim() - 1))
            return torch.where(m, b.to(a.dtype), a)
        out = zip_lanes(sv, d, pick)
        return out.replace(validity=out.validity & lay.live)

    # ------------------------------------------------------------------
    # Aggregates over the frame
    # ------------------------------------------------------------------

    def _eval_window_agg(self, fn: WindowAgg, frame: WindowFrame,
                         lay: _Layout) -> DeviceColumn:
        agg = fn.agg
        name = type(agg).__name__
        col = (lay.sorted_eval(agg.children[0], self.ctx)
               if agg.children else None)
        live = lay.live
        if name == "Count":
            x = ((col.validity & live) if col is not None else live
                 ).to(torch.int64)
            v = self._frame_reduce(x, "sum", 0, frame, lay)
            return DeviceColumn(v, live, T.INT64)
        ok = col.validity & live
        n = self._frame_reduce(ok.to(torch.int64), "sum", 0, frame, lay)
        valid = (n > 0) & live
        if name in ("Sum", "Average"):
            floating = name == "Average" or agg.dtype.kind in (
                TypeKind.FLOAT32, TypeKind.FLOAT64)
            acc = torch.float64 if floating else torch.int64
            x = torch.where(ok, col.data, 0).to(acc)
            s = self._frame_reduce(x, "sum", 0, frame, lay)
            if name == "Average":
                v = s / n.clamp(min=1).double()
                return DeviceColumn(torch.where(valid, v, 0.0), valid,
                                    T.FLOAT64)
            return DeviceColumn(s.to(agg.dtype.storage_dtype), valid,
                                agg.dtype)
        if name in ("Min", "Max"):
            is_min = name == "Min"
            elementwise = col.dtype.kind in _ELEMENTWISE_MINMAX or (
                col.dtype.kind is TypeKind.DECIMAL and col.data.dim() == 1)
            if not elementwise or col.is_dict:
                return self._ranked_min_max(col, ok, valid, is_min, frame,
                                            lay)
            if col.dtype.kind is TypeKind.BOOLEAN:
                op = "and" if is_min else "or"
                fill = is_min
            elif col.dtype.is_fractional:
                # NaN is the greatest value (Spark): min skips it unless
                # every row is NaN (fmin, with NaN as its identity), max
                # takes it (maximum propagates it)
                op = "fmin" if is_min else "max"
                fill = float("nan") if is_min else float("-inf")
            else:
                info = torch.iinfo(col.data.dtype)
                op = "min" if is_min else "max"
                fill = info.max if is_min else info.min
            x = torch.where(ok, col.data, torch.full(
                (), fill, dtype=col.data.dtype, device=col.data.device))
            v = self._frame_reduce(x, op, fill, frame, lay)
            return DeviceColumn(torch.where(valid, v, torch.zeros_like(v)),
                                valid, agg.dtype)
        raise NotImplementedError(name)

    def _ranked_min_max(self, col: DeviceColumn, ok, valid, is_min: bool,
                        frame: WindowFrame, lay: _Layout) -> DeviceColumn:
        """Min or Max of a value without an elementwise order (a string, a
        dictionary code): each row's dense rank among the batch's values
        reduces over the frame, and the result gathers a row of that
        rank."""
        words = orderable_words(col)
        order = lexsort(list(words))
        new = adjacent_equal_ops([w[order] for w in words]).logical_not()
        rank = torch.empty_like(order)
        rank[order] = torch.cumsum(new, 0) - 1
        holder = torch.empty_like(order)
        holder[rank] = lay.iota          # a row of each rank
        fill = lay.cap if is_min else -1
        x = torch.where(ok, rank, fill)
        v = self._frame_reduce(x, "min" if is_min else "max", fill, frame,
                               lay)
        # a null row may hold the rank's bytes too: its data is the
        # value's, so the validity is the frame's alone
        out = gather_column(col, holder[v.clamp(0, lay.cap - 1)])
        return out.replace(validity=valid)

    _OPS = {"sum": torch.add, "min": torch.minimum, "max": torch.maximum,
            "fmin": torch.fmin, "and": torch.logical_and,
            "or": torch.logical_or}

    def _running(self, x, op: str, lay: _Layout):
        """The inclusive running reduction within each partition."""
        if op == "sum" and not x.is_floating_point():
            return segmented_int_sum(x, lay.seg_start)
        return segmented_scan(x, lay.head, self._OPS[op])

    def _frame_reduce(self, x, op: str, identity, frame: WindowFrame,
                      lay: _Layout) -> torch.Tensor:
        """``x`` reduced by ``op`` over each row's frame."""
        cap = lay.cap
        if frame.is_full_partition:
            return self._running(x, op, lay)[lay.seg_end.clamp(0, cap - 1)]
        if frame.is_running:
            run = self._running(x, op, lay)
            if frame.is_rows:
                return run
            # RANGE: every peer takes the running value at its last peer
            return run[lay.peer_end.clamp(0, cap - 1)]
        if frame.is_rows and frame.start is not None and \
                frame.end is not None and \
                frame.end - frame.start < SHIFT_FOLD_ROWS:
            # a narrow literal ROWS frame: fold shifted copies, in the
            # frame's row order (exact for every op, floats included)
            f = self._OPS[op]
            ident = torch.full((), identity, dtype=x.dtype, device=x.device)
            acc = ident.expand(cap)
            for o in range(frame.start, frame.end + 1):
                src = lay.iota + o
                ix = src.clamp(0, cap - 1)
                same = (src >= 0) & (src < cap) & (lay.pid[ix] == lay.pid)
                acc = f(acc, torch.where(same, x[ix], ident))
            return acc
        # the general path: each row's [lo, hi], then a prefix difference
        # (sums) or a sparse table (the idempotent ops)
        lo, hi = self._frame_bounds(frame, lay)
        return self._reduce_between(x, op, identity, lo, hi, lay)

    def _frame_bounds(self, frame: WindowFrame, lay: _Layout):
        """Each row's frame as absolute [lo, hi] in the sorted layout
        (hi < lo: empty). ROWS bounds are positions; a RANGE bound with an
        offset ranks the shifted order value into the layout."""
        if frame.is_rows:
            lo = lay.seg_start if frame.start is None \
                else torch.maximum(lay.iota + frame.start, lay.seg_start)
            hi = lay.seg_end if frame.end is None \
                else torch.minimum(lay.iota + frame.end, lay.seg_end)
            return lo, torch.maximum(hi, lo - 1)
        if frame.start is None:
            lo = lay.seg_start
        elif frame.start == 0:
            lo = lay.peer_start
        else:
            lo = self._range_rank(frame.start, True, lay)
        if frame.end is None:
            hi = lay.seg_end
        elif frame.end == 0:
            hi = lay.peer_end
        else:
            hi = self._range_rank(frame.end, False, lay)
        return lo, hi

    def _range_rank(self, delta: int, is_lo: bool, lay: _Layout):
        """Each row's shifted order value ranked among its partition's
        rows: lo = the first index whose value is at least v + delta, hi =
        the last at most v + delta. One stable merge sort of 2n entries by
        (partition, null rank, value words, tag); the bound entries keep
        their own order (values ascend within a partition), so the data
        entries before a bound number its merged position less its own
        index. A row with a null order value takes its peer group (the
        SQL standard's all-null frame)."""
        o = self.spec.orders[0]
        col = lay.sorted_eval(o.child, self.ctx)
        # a descending layout sorts the flipped words; Spark's descending
        # RANGE frame covers [v - end, v - start], so the bound is v - delta
        shifted = _sat_add(col.data, -delta if o.descending else delta)

        def words(data):
            ws = orderable_words(col.replace(data=data))
            if o.descending:
                ws = [-w if w.is_floating_point() else ~w for w in ws]
            return ws
        bound_words = words(shifted)
        data_words = words(col.data)
        nf = o.effective_nulls_first
        dev = col.data.device
        n_rank = torch.where(col.validity, 1, 0 if nf else 2).to(torch.uint8)
        pid = torch.where(lay.live, lay.pid, 1 << 62)
        # lo bounds sort before equal data (rank = data strictly below),
        # hi bounds after
        cap = lay.cap
        tag_data = torch.full((cap,), 1 if is_lo else 0, dtype=torch.uint8,
                              device=dev)
        tag_bound = 1 - tag_data
        lanes = [torch.cat([pid, pid]), torch.cat([n_rank, n_rank])]
        lanes += [torch.cat([a, b]) for a, b in zip(data_words, bound_words)]
        lanes.append(torch.cat([tag_data, tag_bound]))
        merged = lexsort(lanes)
        inv = torch.empty_like(merged)
        inv[merged] = torch.arange(2 * cap, device=dev)
        count_before = inv[cap:] - lay.iota
        pos = count_before if is_lo else count_before - 1
        return torch.where(col.validity, pos,
                           lay.peer_start if is_lo else lay.peer_end)

    def _reduce_between(self, x, op: str, identity, lo, hi, lay: _Layout):
        """``x`` reduced over [lo, hi] per row (the identity when hi < lo).
        Sums are a difference of the partition's running sums (float
        rounding stays within the partition); the idempotent ops read a
        doubling sparse table: op(T_j[lo], T_j[hi - 2^j + 1]) with j =
        floor(log2(hi - lo + 1))."""
        cap = lay.cap
        ident = torch.full((), identity, dtype=x.dtype, device=x.device)
        empty = hi < lo
        lo_c = lo.clamp(0, cap - 1)
        hi_c = hi.clamp(0, cap - 1)
        if op == "sum":
            run = self._running(x, op, lay)
            upper = run[hi_c]
            lower = torch.where(lo > lay.seg_start,
                                run[(lo - 1).clamp(0, cap - 1)],
                                torch.zeros_like(ident))
            return torch.where(empty, ident, upper - lower)
        f = self._OPS[op]
        levels = [x]
        d = 1
        while d < cap:
            top = levels[-1]
            levels.append(f(top, torch.cat([top[d:], ident.expand(d)])))
            d <<= 1
        table = torch.stack(levels).reshape(-1)
        length = (hi - lo + 1).clamp(min=1)
        j = torch.floor(torch.log2(length.double())).to(torch.int64)
        a = table[j * cap + lo_c]
        b = table[j * cap + (hi - (1 << j) + 1).clamp(0, cap - 1)]
        return torch.where(empty, ident, f(a, b))

    # ------------------------------------------------------------------

    def do_execute_partition(self, p: int) -> Iterator[ColumnarBatch]:
        # a window partition must lie whole in one batch: behind a
        # KeyBatchingExec on the same keys every batch holds whole groups
        # (reference: GpuKeyBatchingIterator), else the stream partition
        # concatenates into one batch
        guarantee = getattr(self.child, "key_complete_for", None)
        if guarantee is not None and \
                guarantee == repr(list(self.spec.partition_keys)):
            for batch in self.child.execute_partition(p):
                yield self._window_kernel(batch)
            return
        # the input batches wait in the spill catalog across the retry
        # boundary; the concatenation and the window re-run after an OOM
        # with the pins released (no split: a partition stays whole)
        from ..memory.retry import admit_all, with_retry_no_split
        cat = self.catalog
        inputs = admit_all(self.child.execute_partition(p),
                           self.child.output_schema, cat,
                           name=f"{self.name}.admit")
        if not inputs:
            return

        def assemble_and_run():
            got: List[ColumnarBatch] = []
            try:
                for item in inputs:
                    got.append(item.acquire())
                if len(got) == 1:
                    return self._window_kernel(got[0])
                cap = bucket_capacity(sum(b.capacity for b in got))
                return self._window_kernel(concat_batches(got, cap))
            finally:
                for j in range(len(got)):
                    inputs[j].release()

        try:
            yield with_retry_no_split(assemble_and_run, catalog=cat,
                                      name=self.name)
        finally:
            for item in inputs:
                item.close()


def _sat_add(x: torch.Tensor, d: int) -> torch.Tensor:
    """``x + d``, saturating at an integer type's bounds."""
    if x.is_floating_point():
        return x + d
    info = torch.iinfo(x.dtype)
    if d >= 0:
        return torch.where(x > info.max - d, info.max, x + d)
    return torch.where(x < info.min - d, info.min, x + d)
