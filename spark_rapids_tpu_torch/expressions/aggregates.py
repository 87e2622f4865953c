"""Aggregate functions with Spark semantics.

Port of ``spark_rapids_tpu/expressions/aggregates.py``: Sum, Count,
Average, Min, Max, the central moments (VarianceSamp, VariancePop,
StddevSamp, StddevPop), First, Last, Percentile, ApproxPercentile,
CollectList, CollectSet and PivotFirst. The
buffer model is Spark's: update turns input rows into per-group buffers,
merge combines buffers that landed in the same group, ``evaluate`` finishes
the result. Type widening follows Spark: sum(int) -> bigint, sum(double) ->
double, sum(decimal(p, s)) -> decimal(p + 10, s), avg and the moments ->
double (avg(decimal(p, s)) -> decimal(p + 4, s + 4), on the CPU), count ->
bigint (never null), min/max/first/last keep their input's type.

Update and merge run as the batched lane contract on the aggregate exec's
key-sorted layout, grouped or global: ``fast_update``/``fast_merge``
register reduction lanes on ``FastLanes`` (sums, and min/max lanes in the
value's own dtype) and return a finisher that reads the group results from
``LaneResults``, which also reduces on demand (the moments' second pass
over each group's mean, First/Last's row pick, the string Min/Max
narrowing). The JAX package's row-buffer ``update``/``merge`` are not
ported.

A decimal sum whose type has more than 18 digits (Spark's decimal(p + 10,
s) for p > 8, or any DECIMAL128 input) sums four 32-bit limbs a row
(``expressions/decimal128.py``): a limb lane on ``FastLanes``, one
``index_add_`` of ``[rows, 4]`` int64, beside the count of negative rows;
the finisher normalizes once and nulls a group whose sum overflows 128 bits
or passes the type's precision, as Spark's non-ANSI sum does. Its buffers
are (sum, count, overflow), as in the JAX package. Min and Max over limbs
take two reductions, the best hi word and then the best lo word among the
rows at that hi.

Where the JAX package rode int64 sums on three exact 22-bit float64 chunk
lanes and int64 min/max off the lanes (a TPU emulates 64-bit integers), the
card reduces int64 natively and exactly; the sum wraps mod 2^64, Spark's
non-ANSI overflow. Float64 lanes are summed per group (``index_add_``),
never as a difference of one batch-wide prefix sum, which would cancel
small groups against the running total.

Min and Max order doubles as Spark does: NaN above every other value, so a
group's max is NaN if any of its values is, and its min only if all are.
The JAX package reduces with ``jnp.minimum``/``jnp.maximum``, whose NaN
wins both. A string Min/Max narrows each group's candidates word by word
over the port's orderable words, as the JAX package does.

Percentile and ApproxPercentile are sort-sensitive: COMPLETE mode only,
over rows the exec sorts by (keys, value) with nulls first; the
interpolated percentile reads the group's k-th valid value at
``start + nulls + k``. ApproxPercentile answers exactly and ignores its
accuracy argument. First and Last take the first or last live row of a
group in the order the exec's stable key sort leaves, which is input order
within a batch; across batches and merges it is as non-deterministic as
Spark's. They pick every row lane of the row (a string's lengths, an
array's elements and ``data2``, a struct's children).

CollectList and CollectSet are sort-sensitive too (COMPLETE only, one per
exec, rows sorted by (keys, value)): each group's non-null values land in
a fixed-budget array of ``max_elems`` slots in value order (CollectSet
drops a value equal to the one before it), by one scatter to slot
``group * max_elems + position`` with positions from a running count. A
group of more values keeps its true length, and ``to_arrow`` refuses it
rather than truncate. PivotFirst keeps a First per pivot value and builds
the array with a per-element validity in ``data2``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import torch

from .. import types as T
from ..batch import DeviceColumn, map_lanes
from ..types import SqlType, TypeKind
from .base import Expression
from .decimal128 import (exceeds_digits, is_dec128, is_negative, lift64,
                         seg_minmax128, sum_overflow)


def group_sums(x: torch.Tensor, seg: torch.Tensor,
               num_groups: int) -> torch.Tensor:
    """Per-group sums of the rows of ``x`` (1-D or [rows, lanes]), row i
    going to group ``seg[i]``."""
    out = torch.zeros((num_groups,) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    return out.index_add_(0, seg, x)


def _ones(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.ones(n, dtype=torch.bool, device=like.device)


class FastLanes:
    """Collects reduction lanes during the aggregate's planning pass:
    float64 sum lanes, int64 sum lanes (integer sums and counts), DECIMAL128
    limb lanes ([rows, 4] int64, summed raw), and min/max lanes, each a
    value in its own dtype with the mask of the rows it reduces."""

    def __init__(self, live: torch.Tensor):
        self.live = live
        self.f64_lanes: List[torch.Tensor] = []
        self.i64_lanes: List[torch.Tensor] = []
        self.limb_lanes: List[torch.Tensor] = []
        self.extreme_lanes: List[Tuple[torch.Tensor, torch.Tensor, str]] = []
        self._count_cache: List[Tuple[Optional[torch.Tensor], int]] = []

    def sum_f64(self, x: torch.Tensor) -> int:
        self.f64_lanes.append(x.to(torch.float64))
        return len(self.f64_lanes) - 1

    def sum_int(self, x: torch.Tensor) -> int:
        self.i64_lanes.append(x.to(torch.int64))
        return len(self.i64_lanes) - 1

    def sum_limbs(self, x: torch.Tensor) -> int:
        """A lane of [rows, 4] limbs, summed limb by limb without carries
        (``decimal128.sum_overflow`` finishes it)."""
        self.limb_lanes.append(x)
        return len(self.limb_lanes) - 1

    def count(self, ok: Optional[torch.Tensor]) -> int:
        """Count of true rows; ok=None counts live rows. Aggregates whose
        mask is the same tensor share one lane."""
        key = None if ok is None or ok is self.live else ok
        for cached, idx in self._count_cache:
            if cached is key:
                return idx
        idx = self.sum_int(self.live if key is None else ok)
        self._count_cache.append((key, idx))
        return idx

    def extreme(self, x: torch.Tensor, ok: torch.Tensor, how: str) -> int:
        """A per-group ``amin`` or ``amax`` lane of ``x`` over the rows
        where ``ok``, in ``x``'s own dtype."""
        self.extreme_lanes.append((x, ok, how))
        return len(self.extreme_lanes) - 1


class LaneResults:
    """Group results of every registered lane, and per-group reductions on
    demand. Rows are key-sorted with the live rows first, so only the
    ``n_live`` prefix is reduced; ``seg`` is that prefix's group ids and
    ``starts`` each group's first sorted row."""

    def __init__(self, lanes: FastLanes, gid: torch.Tensor, n_live: int,
                 num_groups: int, starts: torch.Tensor):
        self.seg = gid[:n_live]
        self.n_live = n_live
        self.num_groups = num_groups
        self.starts = starts

        def summed(stack):
            if not stack:
                return None
            return self.group_sum(torch.stack(stack, dim=1))

        self._f64 = summed(lanes.f64_lanes)
        self._i64 = summed(lanes.i64_lanes)
        self._limbs = (self.group_sum(torch.cat(lanes.limb_lanes, dim=1))
                       if lanes.limb_lanes else None)
        self._extreme = [self.reduce(x, ok, how)
                         for x, ok, how in lanes.extreme_lanes]

    def sum_f64(self, ref: int) -> torch.Tensor:
        return self._f64[:, ref]

    def sum_int(self, ref: int) -> torch.Tensor:
        return self._i64[:, ref]

    def sum_limbs(self, ref: int) -> torch.Tensor:
        return self._limbs[:, 4 * ref:4 * ref + 4]

    def extreme(self, ref: int) -> torch.Tensor:
        return self._extreme[ref]

    def group_sum(self, x: torch.Tensor) -> torch.Tensor:
        """Per-group sums of the live prefix of ``x`` (1-D or [rows,
        lanes])."""
        return group_sums(x[:self.n_live], self.seg, self.num_groups)

    def per_row(self, per_group: torch.Tensor) -> torch.Tensor:
        """Each live row's value of a per-group tensor."""
        return per_group[self.seg]

    def reduce(self, x: torch.Tensor, ok: torch.Tensor,
               how: str) -> torch.Tensor:
        """Per-group ``amin``/``amax`` of ``x`` over the live rows where
        ``ok``; 0 for a group with none. Rows outside ``ok`` go to a slot
        past the groups, so no identity value is needed."""
        n = self.n_live
        seg = torch.where(ok[:n], self.seg, self.num_groups)
        out = x.new_zeros(self.num_groups + 1)
        return out.scatter_reduce_(0, seg, x[:n], how,
                                   include_self=False)[:self.num_groups]


@dataclass(frozen=True, eq=False)
class AggregateFunction(Expression):
    """Base. ``child`` is None for count(*)."""

    child: Optional[Expression] = None

    @property
    def children(self):
        return (self.child,) if self.child is not None else ()

    def with_children(self, c):
        return type(self)(c[0] if c else None)

    def buffer_types(self) -> List[SqlType]:
        raise NotImplementedError

    def buffer_nullable(self) -> List[bool]:
        return [True] * len(self.buffer_types())

    def evaluate(self, buffers: List[DeviceColumn],
                 group_live: torch.Tensor) -> DeviceColumn:
        raise NotImplementedError

    def fast_update(self, inputs: List[DeviceColumn], live: torch.Tensor,
                    B: FastLanes):
        raise NotImplementedError

    def fast_merge(self, buffers: List[DeviceColumn], live: torch.Tensor,
                   B: FastLanes):
        raise NotImplementedError


def _masked(col: DeviceColumn, live: torch.Tensor):
    ok = col.validity & live
    zero = torch.zeros((), dtype=col.data.dtype, device=col.data.device)
    return torch.where(ok, col.data, zero), ok


def _view_ok(col: DeviceColumn, live: torch.Tensor) -> torch.Tensor:
    # a non-nullable sorted view shares the live mask itself, which lets
    # FastLanes.count share one lane across aggregates
    return live if col.validity is live else col.validity & live


class Sum(AggregateFunction):
    """sum(x): null iff the group has no non-null input; integer sums wrap.
    A decimal(p, s) sums to Spark's decimal(min(p + 10, 38), s), the JAX
    package's type: the unscaled int64 while that type has at most 18
    digits (p <= 8), four limbs past that, where a group whose sum passes
    the type's precision is null (Spark's non-ANSI overflow)."""

    @property
    def dtype(self) -> SqlType:
        d = self.child.dtype
        if d.kind is TypeKind.DECIMAL:
            return T.decimal(min(d.precision + 10, 38), d.scale)
        return T.FLOAT64 if d.is_fractional else T.INT64

    @property
    def _is_dec128(self) -> bool:
        return is_dec128(self.dtype)

    def buffer_types(self):
        if self._is_dec128:
            # running limb sum, non-null count, overflow flag
            return [self.dtype, T.INT64, T.BOOLEAN]
        return [self.dtype, T.INT64]       # running sum, non-null count

    def evaluate(self, buffers, group_live):
        valid = buffers[0].validity & group_live
        if self._is_dec128:
            valid = valid & ~buffers[2].data
            return DeviceColumn(torch.where(valid[:, None], buffers[0].data,
                                            0), valid, self.dtype)
        return DeviceColumn(buffers[0].data, valid, self.dtype)

    @property
    def _is_f64(self) -> bool:
        return self.dtype.kind is T.TypeKind.FLOAT64

    def _lane(self, data, ok, B: FastLanes) -> int:
        if self._is_f64:
            return B.sum_f64(torch.where(ok, data.to(torch.float64), 0.0))
        zero = torch.zeros((), dtype=torch.int64, device=data.device)
        return B.sum_int(torch.where(ok, data.to(torch.int64), zero))

    def _finisher(self, ref, nref):
        def finish(res: LaneResults):
            n = res.sum_int(nref)
            s = res.sum_f64(ref) if self._is_f64 else res.sum_int(ref)
            return [DeviceColumn(s, n > 0, self.dtype),
                    DeviceColumn(n, _ones(n.shape[0], n), T.INT64)]
        return finish

    def _limb_lanes(self, data, ok, B: FastLanes) -> Tuple[int, int]:
        """(limb lane, negative-row count lane) of the rows where ``ok``;
        DECIMAL64 values widen to limbs first."""
        if data.dim() == 1:
            data = lift64(data)
        return (B.sum_limbs(torch.where(ok[:, None], data, 0)),
                B.sum_int(ok & is_negative(data)))

    def _limb_finisher(self, lref, negref, nref, oref=None):
        def finish(res: LaneResults):
            s, ovf = sum_overflow(res.sum_limbs(lref), res.sum_int(negref))
            # Spark's precision cap nulls before the 128-bit range does
            ovf = ovf | exceeds_digits(s, self.dtype.precision)
            if oref is not None:
                ovf = ovf | (res.sum_int(oref) > 0)
            n = res.sum_int(nref)
            one = _ones(n.shape[0], n)
            return [DeviceColumn(s, n > 0, self.dtype),
                    DeviceColumn(n, one, T.INT64),
                    DeviceColumn(ovf, one, T.BOOLEAN)]
        return finish

    def fast_update(self, inputs, live, B):
        ok = _view_ok(inputs[0], live)
        if self._is_dec128:
            return self._limb_finisher(*self._limb_lanes(inputs[0].data, ok,
                                                         B), B.count(ok))
        return self._finisher(self._lane(inputs[0].data, ok, B),
                              B.count(ok))

    def fast_merge(self, buffers, live, B):
        ok = buffers[0].validity & live
        ncnt = B.sum_int(_masked(buffers[1], live)[0])
        if self._is_dec128:
            # the partials' limbs, counts and overflow flags
            return self._limb_finisher(
                *self._limb_lanes(buffers[0].data, ok, B), ncnt,
                B.sum_int(live & buffers[2].data))
        return self._finisher(self._lane(buffers[0].data, ok, B), ncnt)


class Count(AggregateFunction):
    """count(x) / count(*): bigint, never null, 0 for empty groups."""

    @property
    def dtype(self):
        return T.INT64

    @property
    def nullable(self):
        return False

    def buffer_types(self):
        return [T.INT64]

    def buffer_nullable(self):
        return [False]

    def evaluate(self, buffers, group_live):
        zero = torch.zeros((), dtype=torch.int64,
                           device=group_live.device)
        return DeviceColumn(torch.where(group_live, buffers[0].data, zero),
                            group_live, T.INT64)

    def _finisher(self, ref):
        def finish(res: LaneResults):
            n = res.sum_int(ref)
            return [DeviceColumn(n, _ones(n.shape[0], n), T.INT64)]
        return finish

    def fast_update(self, inputs, live, B):
        ok = _view_ok(inputs[0], live) if inputs else None
        return self._finisher(B.count(ok))

    def fast_merge(self, buffers, live, B):
        return self._finisher(B.sum_int(_masked(buffers[0], live)[0]))


class Average(AggregateFunction):
    """avg(x) -> double; buffers are (sum: double, count: bigint). Over a
    decimal(p, s) Spark's type is decimal(min(p + 4, 38), min(s + 4, 38))
    with HALF_UP rounding, which the double buffer cannot give: tagging
    refuses it (as the JAX package's does), so it runs on the row
    interpreter, and the device update raises."""

    @property
    def dtype(self):
        d = self.child.dtype
        if d.kind is TypeKind.DECIMAL:
            return T.decimal(min(d.precision + 4, 38),
                                  min(d.scale + 4, 38))
        return T.FLOAT64

    def buffer_types(self):
        return [T.FLOAT64, T.INT64]

    def evaluate(self, buffers, group_live):
        n = buffers[1].data
        valid = (n > 0) & group_live
        avg = buffers[0].data / torch.where(n > 0, n, 1).to(torch.float64)
        return DeviceColumn(torch.where(valid, avg, 0.0), valid, T.FLOAT64)

    def _finisher(self, sref, nref):
        def finish(res: LaneResults):
            s, n = res.sum_f64(sref), res.sum_int(nref)
            return [DeviceColumn(s, n > 0, T.FLOAT64),
                    DeviceColumn(n, _ones(n.shape[0], n), T.INT64)]
        return finish

    def fast_update(self, inputs, live, B):
        col = inputs[0]
        if col.dtype.kind is TypeKind.DECIMAL:
            raise NotImplementedError(
                f"avg over {col.dtype} on the device: its decimal result "
                f"runs on the row interpreter (a CPU fallback island)")
        ok = _view_ok(col, live)
        sref = B.sum_f64(torch.where(ok, col.data.to(torch.float64), 0.0))
        return self._finisher(sref, B.count(ok))

    def fast_merge(self, buffers, live, B):
        sref = B.sum_f64(_masked(buffers[0], live)[0])
        nref = B.sum_int(_masked(buffers[1], live)[0])
        return self._finisher(sref, nref)


class _MinMax(AggregateFunction):
    """min(x) / max(x): the input's type; null iff the group has no
    non-null input. One buffer, merged as it was made."""

    _how = "amin"

    @property
    def dtype(self):
        return self.child.dtype

    def buffer_types(self):
        return [self.dtype]

    def evaluate(self, buffers, group_live):
        b = buffers[0]
        return DeviceColumn(b.data, b.validity & group_live, b.dtype,
                            b.lengths)

    def _string(self, col: DeviceColumn, ok: torch.Tensor, nref: int):
        """Each group's least (greatest) string: candidates narrow word by
        word over the orderable words (the byte words, then the length),
        and the group's first surviving row is gathered."""
        from ..exec.common import orderable_words
        words = orderable_words(col)
        is_min = self._how == "amin"

        def finish(res: LaneResults):
            n = res.n_live
            candidate = ok[:n]
            for w in words:
                key = (w if is_min else ~w)[:n].to(torch.int64)
                best = res.reduce(key, candidate, "amin")
                candidate = candidate & (key == res.per_row(best))
            rows = torch.arange(n, device=ok.device)
            pick = res.reduce(rows, candidate, "amin")
            valid = res.sum_int(nref) > 0
            return [DeviceColumn(
                torch.where(valid[:, None], col.data[pick], 0), valid,
                self.dtype, torch.where(valid, col.lengths[pick], 0))]
        return finish

    def _limbs(self, col: DeviceColumn, ok: torch.Tensor, nref: int):
        """Each group's least (greatest) DECIMAL128 value: the best hi
        word, then the best lo word among the rows at that hi."""
        def finish(res: LaneResults):
            n = res.n_live
            m = seg_minmax128(col.data[:n], ok[:n], res.seg, res.num_groups,
                              self._how == "amin", res.reduce)
            valid = res.sum_int(nref) > 0
            return [DeviceColumn(torch.where(valid[:, None], m, 0), valid,
                                 self.dtype)]
        return finish

    def _lanes(self, col: DeviceColumn, live, B: FastLanes):
        ok = _view_ok(col, live)
        nref = B.count(ok)
        if col.lengths is not None:
            return self._string(col, ok, nref)
        if col.data.dim() > 1:
            return self._limbs(col, ok, nref)
        kind = self.dtype.kind
        x = col.data.to(torch.int32) if kind is TypeKind.BOOLEAN else col.data
        nan = None
        if kind is TypeKind.FLOAT64:
            # Spark's order: NaN above every other value. Reduce the
            # numbers, and count the NaN rows beside them
            nan = torch.isnan(x) & ok
            nan_ref = B.count(nan)
            ok = ok & ~nan
        ref = B.extreme(x, ok, self._how)

        def finish(res: LaneResults):
            n = res.sum_int(nref)
            valid = n > 0
            m = res.extreme(ref)
            if nan is not None:
                n_nan = res.sum_int(nan_ref)
                # max: NaN if any value is; min: NaN if every value is
                to_nan = n_nan > 0 if self._how == "amax" else n_nan == n
                m = torch.where(to_nan, float("nan"), m)
            if kind is TypeKind.BOOLEAN:
                m = m > 0
            zero = torch.zeros((), dtype=m.dtype, device=m.device)
            return [DeviceColumn(torch.where(valid, m, zero), valid,
                                 self.dtype)]
        return finish

    def fast_update(self, inputs, live, B):
        return self._lanes(inputs[0], live, B)

    def fast_merge(self, buffers, live, B):
        return self._lanes(buffers[0], live, B)


class Min(_MinMax):
    _how = "amin"


class Max(_MinMax):
    _how = "amax"


class _CentralMoment(AggregateFunction):
    """The second central moment's buffers (n, mean, m2), all double: the
    update takes each group's mean, then its squared deviations (two
    passes); merges combine partials by Chan's pairwise formula,
    ``m2 = sum(m2_i) + sum(n_i * (mean_i - mean)^2)``."""

    @property
    def dtype(self):
        return T.FLOAT64

    def buffer_types(self):
        return [T.FLOAT64, T.FLOAT64, T.FLOAT64]      # n, mean, m2

    def _finish(self, n: torch.Tensor, m2: torch.Tensor):
        raise NotImplementedError

    def evaluate(self, buffers, group_live):
        n, m2 = buffers[0].data, buffers[2].data
        val, valid = self._finish(n, m2)
        valid = valid & group_live
        return DeviceColumn(torch.where(valid, val, 0.0), valid, T.FLOAT64)

    @staticmethod
    def _buffers(n, mean, m2):
        one = _ones(n.shape[0], n)
        return [DeviceColumn(n, one, T.FLOAT64),
                DeviceColumn(mean, one, T.FLOAT64),
                DeviceColumn(m2, one, T.FLOAT64)]

    def fast_update(self, inputs, live, B):
        col = inputs[0]
        ok = _view_ok(col, live)
        x = torch.where(ok, col.data.to(torch.float64), 0.0)
        nref, sref = B.count(ok), B.sum_f64(x)

        def finish(res: LaneResults):
            n = res.sum_int(nref).to(torch.float64)
            mean = res.sum_f64(sref) / torch.where(n > 0, n, 1.0)
            k = res.n_live
            dev = torch.where(ok[:k], x[:k] - res.per_row(mean), 0.0)
            return self._buffers(n, mean, res.group_sum(dev * dev))
        return finish

    def fast_merge(self, buffers, live, B):
        n, mean, m2 = (torch.where(live, b.data, 0.0) for b in buffers)
        nref, sref = B.sum_f64(n), B.sum_f64(n * mean)

        def finish(res: LaneResults):
            big_n = res.sum_f64(nref)
            gmean = res.sum_f64(sref) / torch.where(big_n > 0, big_n, 1.0)
            k = res.n_live
            d = mean[:k] - res.per_row(gmean)
            return self._buffers(big_n, gmean,
                                 res.group_sum(m2[:k] + n[:k] * d * d))
        return finish


class VarianceSamp(_CentralMoment):
    def _finish(self, n, m2):
        return m2 / torch.where(n > 1, n - 1, 1.0), n > 1


class VariancePop(_CentralMoment):
    def _finish(self, n, m2):
        return m2 / torch.where(n > 0, n, 1.0), n > 0


class StddevSamp(_CentralMoment):
    def _finish(self, n, m2):
        return torch.sqrt(m2 / torch.where(n > 1, n - 1, 1.0)), n > 1


class StddevPop(_CentralMoment):
    def _finish(self, n, m2):
        return torch.sqrt(m2 / torch.where(n > 0, n, 1.0)), n > 0


class First(AggregateFunction):
    """first(x) (ignoreNulls=False): the value of the group's first live
    row, null or not. Buffers (value, has_value); a partial without a
    value never wins a merge."""

    _how = "amin"

    @property
    def dtype(self):
        return self.child.dtype

    def buffer_types(self):
        return [self.dtype, T.BOOLEAN]       # value, has_value

    def evaluate(self, buffers, group_live):
        val, has = buffers
        return val.replace(validity=val.validity & has.data & group_live)

    def _pick(self, col: DeviceColumn, present: torch.Tensor, B: FastLanes):
        rows = torch.arange(present.shape[0], device=present.device)
        ref = B.extreme(rows, present, self._how)
        nref = B.count(present)

        def finish(res: LaneResults):
            has = res.sum_int(nref) > 0
            idx = res.extreme(ref)
            # every row lane of the picked row: a string's lengths, an
            # array's element lengths (data2), a struct's children
            val = map_lanes(col, lambda a: a[idx])
            return [val.replace(validity=val.validity & has),
                    DeviceColumn(has, _ones(has.shape[0], has), T.BOOLEAN)]
        return finish

    def fast_update(self, inputs, live, B):
        return self._pick(inputs[0], live, B)

    def fast_merge(self, buffers, live, B):
        return self._pick(buffers[0], live & buffers[1].data, B)


class Last(First):
    """last(x) (ignoreNulls=False): the group's last live row."""

    _how = "amax"


class Percentile(AggregateFunction):
    """percentile(x, percentage): the exact percentile, interpolated at
    ``percentage * (cnt - 1)`` between the group's sorted valid values;
    null for a group with no valid value. Not decomposable: COMPLETE mode
    only, over rows the exec sorts by (keys, value), nulls first."""

    supports_partial = False
    requires_sorted_input = True

    def __init__(self, child: Optional[Expression] = None,
                 percentage: float = 0.5):
        object.__setattr__(self, "child", child)
        object.__setattr__(self, "percentage", float(percentage))

    def with_children(self, c):
        return type(self)(c[0] if c else None, self.percentage)

    @property
    def dtype(self):
        return T.FLOAT64

    def buffer_types(self):
        return [T.FLOAT64]

    def evaluate(self, buffers, group_live):
        b = buffers[0]
        return DeviceColumn(b.data, b.validity & group_live, T.FLOAT64)

    def fast_update(self, inputs, live, B):
        col = inputs[0]
        ok = _view_ok(col, live)
        cnt_ref, rows_ref = B.count(ok), B.count(None)
        x = col.data.to(torch.float64)
        last = x.shape[0] - 1

        def finish(res: LaneResults):
            cnt = res.sum_int(cnt_ref)
            nulls = res.sum_int(rows_ref) - cnt
            r = self.percentage * (cnt - 1).clamp(min=0).to(torch.float64)
            lo, hi = torch.floor(r), torch.ceil(r)
            frac = r - lo
            base = res.starts + nulls
            v = ((1.0 - frac) * x[(base + lo.long()).clamp(0, last)]
                 + frac * x[(base + hi.long()).clamp(0, last)])
            valid = cnt > 0
            return [DeviceColumn(torch.where(valid, v, 0.0), valid,
                                 T.FLOAT64)]
        return finish

    def fast_merge(self, buffers, live, B):
        raise NotImplementedError(
            "percentile is not decomposable; COMPLETE mode only")


class ApproxPercentile(Percentile):
    """approx_percentile(x, percentage[, accuracy]), answered exactly: the
    exec sorts each group's values, so the exact percentile costs what a
    sketch would, and it meets any accuracy. ``accuracy`` is kept and
    ignored."""

    def __init__(self, child: Optional[Expression] = None,
                 percentage: float = 0.5, accuracy: int = 10000):
        super().__init__(child, percentage)
        object.__setattr__(self, "accuracy", accuracy)

    def with_children(self, c):
        return ApproxPercentile(c[0] if c else None, self.percentage,
                                self.accuracy)


class CollectList(AggregateFunction):
    """collect_list(x): nulls skipped (Spark), each group's elements in
    value order (Spark leaves the order undefined; sorted is
    deterministic). The result is a fixed-budget array of ``max_elems``
    elements a group; a group with more keeps its true length, and
    ``to_arrow`` refuses it loudly instead of truncating. COMPLETE only,
    over rows the exec sorts by (keys, value), like percentile."""

    supports_partial = False
    requires_sorted_input = True
    _dedupe = False

    def __init__(self, child: Optional[Expression] = None,
                 max_elems: int = 256):
        object.__setattr__(self, "child", child)
        object.__setattr__(self, "max_elems", int(max_elems))

    def with_children(self, c):
        return type(self)(c[0] if c else None, self.max_elems)

    @property
    def dtype(self):
        return T.array(self.child.dtype, self.max_elems)

    def buffer_types(self):
        return [self.dtype]

    def evaluate(self, buffers, group_live):
        b = buffers[0]
        return DeviceColumn(b.data, b.validity & group_live, self.dtype,
                            torch.where(group_live, b.lengths, 0),
                            data2=b.data2)

    def fast_update(self, inputs, live, B):
        col = inputs[0]
        ok_all = _view_ok(col, live)
        me = self.max_elems

        def finish(res: LaneResults):
            n, groups = res.n_live, res.num_groups
            seg = res.seg
            ok = ok_all[:n]
            if self._dedupe and n > 1:
                # rows sorted by (keys, value): drop a value equal to the
                # kept one before it in its group
                from ..exec.common import adjacent_equal_ops, orderable_words
                words = [w[:n] for w in orderable_words(
                    DeviceColumn(col.data[:n], ok, col.dtype,
                                 None if col.lengths is None
                                 else col.lengths[:n]))]
                dup = adjacent_equal_ops([seg] + words)
                prev_ok = torch.cat([ok.new_zeros(1), ok[:-1]])
                ok = ok & ~(dup & prev_ok)
            # a value's slot: its rank among its group's kept values; the
            # groups are consecutive runs, so the kept values of the
            # groups before it are an exclusive sum of the counts
            counts = res.group_sum(ok.to(torch.int32))
            before = torch.cumsum(counts, 0) - counts
            pos = torch.cumsum(ok, 0) - 1 - before[seg]
            target = torch.where(ok & (pos < me), seg * me + pos,
                                 groups * me)
            valid = torch.ones(groups, dtype=torch.bool, device=seg.device)

            def place(src, width):
                out = src.new_zeros((groups * me + 1,) + width)
                out[target] = src[:n]
                return out[:groups * me].reshape((groups, me) + width)

            data = place(col.data, tuple(col.data.shape[1:]))
            data2 = (None if col.lengths is None
                     else place(col.lengths, ()))
            return [DeviceColumn(data, valid, self.dtype, counts,
                                 data2=data2)]
        return finish

    def fast_merge(self, buffers, live, B):
        raise NotImplementedError("collect_* is COMPLETE-only")


class CollectSet(CollectList):
    """collect_set(x): the distinct elements, in value order."""

    _dedupe = True


class PivotFirst(AggregateFunction):
    """PivotFirst(value, pivot, pivot_values): per group, the first
    ``value`` of each literal pivot key, as one array the pivot projection
    indexes (reference: GpuPivotFirst). A missing combination is a null
    element: the array carries a per-element validity in a bool
    ``data2``, which element access reads."""

    def __init__(self, child: Optional[Expression] = None,
                 pivot: Optional[Expression] = None,
                 pivot_values: Tuple = ()):
        object.__setattr__(self, "child", child)
        object.__setattr__(self, "pivot", pivot)
        object.__setattr__(self, "pivot_values", tuple(pivot_values))

    @property
    def children(self):
        return (self.child, self.pivot)

    def with_children(self, c):
        return PivotFirst(c[0], c[1], self.pivot_values)

    @property
    def dtype(self):
        return T.array(self.child.dtype, max(len(self.pivot_values), 1))

    def buffer_types(self):
        return [self.child.dtype, T.BOOLEAN] * len(self.pivot_values)

    def _masks(self, pv: DeviceColumn, live: torch.Tensor):
        out = []
        for v in self.pivot_values:
            if v is None:
                out.append(live & ~pv.validity)
            elif pv.lengths is not None:
                # string keys: zero padding makes whole-row byte equality
                # string equality
                b = str(v).encode("utf-8")
                ml = pv.data.shape[1]
                row = torch.tensor(list(b[:ml]) + [0] * max(ml - len(b), 0),
                                   dtype=torch.uint8, device=pv.data.device)
                eq = (pv.data == row[None, :]).all(dim=1) & (len(b) <= ml)
                out.append(live & pv.validity & eq)
            else:
                out.append(live & pv.validity & (pv.data == v))
        return out

    def _picks(self, pairs, B: FastLanes):
        first = First(self.child)
        fins = [first._pick(val, present, B) for val, present in pairs]

        def finish(res: LaneResults):
            return [b for f in fins for b in f(res)]
        return finish

    def fast_update(self, inputs, live, B):
        val, pv = inputs
        return self._picks([(val, m) for m in self._masks(pv, live)], B)

    def fast_merge(self, buffers, live, B):
        k = len(self.pivot_values)
        return self._picks([(buffers[2 * i], live & buffers[2 * i + 1].data)
                            for i in range(k)], B)

    def evaluate(self, buffers, group_live):
        k = len(self.pivot_values)
        vals = [buffers[2 * i] for i in range(k)]
        has = [buffers[2 * i + 1] for i in range(k)]
        data = torch.stack([v.data for v in vals], dim=1)
        ev = torch.stack([v.validity & h.data for v, h in zip(vals, has)],
                         dim=1)
        zero = torch.zeros((), dtype=data.dtype, device=data.device)
        return DeviceColumn(torch.where(ev, data, zero), group_live,
                            self.dtype,
                            torch.where(group_live, k, 0).to(torch.int32),
                            data2=ev)
