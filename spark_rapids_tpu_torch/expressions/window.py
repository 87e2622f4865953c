"""Window specifications and functions.

Port of ``spark_rapids_tpu/expressions/window.py`` (reference:
GpuWindowExpression.scala's frame specs, GpuWindowExec.scala's running and
double-pass windows). The design is the JAX package's: one sorted layout
per batch (partition keys, then order keys) and every window shape lowered
to segmented scans and reductions (``exec/window.py``):

- UNBOUNDED PRECEDING to CURRENT ROW: a segmented inclusive scan;
- UNBOUNDED on both sides: the scan's value at the partition's last row;
- bounded ROWS frames: a shift fold for frames under 64 rows wide, else a
  prefix difference (sums) or a sparse table (min and max);
- RANGE frames: the running value at each row's last peer, or, with value
  offsets, bounds ranked into the layout by one merge sort.

The scan primitives are PyTorch's idiom where one call computes the same
thing: a segment's start is the ``cummax`` of ``where(head, iota, 0)``
(``segment_starts``), its end a flipped ``cummin`` (``segment_ends``), and
an int64 running sum a ``cumsum`` difference, exact and wrapping mod 2^64
as the JAX adds do (``segmented_int_sum``). Float sums and the other ops run
as ``segmented_scan``, the JAX package's log-step scan, so that rounding
stays within each partition: a global ``cumsum`` minus the prefix at the
partition's start would lose a small partition's low bits after a large
prefix.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Sequence, Tuple

import torch

from .. import types as T
from ..types import TypeKind
from .base import Expression


@dataclass(frozen=True)
class WindowFrame:
    """A ROWS or RANGE frame; bounds in Spark's terms: negative is
    preceding, None unbounded on that side, 0 the current row."""

    is_rows: bool = False
    start: Optional[int] = None   # None = UNBOUNDED PRECEDING
    end: Optional[int] = 0        # 0 = CURRENT ROW; None = UNBOUNDED FOLLOWING

    @property
    def is_running(self) -> bool:
        return self.start is None and self.end == 0

    @property
    def is_full_partition(self) -> bool:
        return self.start is None and self.end is None


DEFAULT_FRAME = WindowFrame(is_rows=False, start=None, end=0)
FULL_FRAME = WindowFrame(is_rows=False, start=None, end=None)

_RANGE_ORDER_KINDS = frozenset({
    TypeKind.INT8, TypeKind.INT16, TypeKind.INT32, TypeKind.INT64,
    TypeKind.DATE, TypeKind.TIMESTAMP, TypeKind.FLOAT32, TypeKind.FLOAT64})


def unsupported_frame_reason(frame: WindowFrame,
                             spec: Optional["WindowSpec"] = None
                             ) -> Optional[str]:
    """None if the device window supports this frame, else why not (the
    planner makes the node an island). Every ROWS frame is supported; a
    RANGE frame with value offsets needs Spark's own restriction: exactly
    one numeric, date or timestamp order key."""
    if frame.is_full_partition or frame.is_running or frame.is_rows:
        return None
    value_bounded = (frame.start is not None and frame.start != 0) or \
        (frame.end is not None and frame.end != 0)
    if not value_bounded or spec is None:
        return None
    if len(spec.orders) != 1:
        return ("value-bounded RANGE frames need exactly one order key "
                "(Spark's own analyzer restriction)")
    try:
        dtype = spec.orders[0].child.dtype
    except NotImplementedError:
        return None     # unbound (the planner's tag pass): the exec checks
    if dtype.kind not in _RANGE_ORDER_KINDS:
        return (f"value-bounded RANGE frames need a numeric/date order "
                f"key, got {dtype}")
    return None


@dataclass(frozen=True, eq=False)
class WindowSpec:
    """PARTITION BY, ORDER BY (``SortOrder``s) and the frame. Compared by
    identity: a spec holds expressions, whose ``==`` builds trees."""

    partition_keys: Tuple[Expression, ...] = ()
    orders: Tuple = ()
    frame: WindowFrame = DEFAULT_FRAME

    def bind(self, schema) -> "WindowSpec":
        return WindowSpec(
            tuple(e.bind(schema) for e in self.partition_keys),
            tuple(o.bind(schema) for o in self.orders),
            self.frame)


@dataclass(frozen=True, eq=False)
class WindowFunction(Expression):
    """Marker base: evaluated by ``WindowExec``, never by ``eval``."""

    @property
    def needs_order(self) -> bool:
        return False


@dataclass(frozen=True, eq=False)
class _OrderedInt(WindowFunction):
    @property
    def dtype(self):
        return T.INT32

    @property
    def nullable(self):
        return False

    @property
    def needs_order(self):
        return True


@dataclass(frozen=True, eq=False)
class RowNumber(_OrderedInt):
    pass


@dataclass(frozen=True, eq=False)
class Rank(_OrderedInt):
    dense: bool = False


@dataclass(frozen=True, eq=False)
class NTile(_OrderedInt):
    buckets: int = 1


@dataclass(frozen=True, eq=False)
class _OrderedDouble(WindowFunction):
    @property
    def dtype(self):
        return T.FLOAT64

    @property
    def nullable(self):
        return False

    @property
    def needs_order(self):
        return True


@dataclass(frozen=True, eq=False)
class PercentRank(_OrderedDouble):
    """(rank - 1) / (partition rows - 1), 0.0 in a one-row partition."""


@dataclass(frozen=True, eq=False)
class CumeDist(_OrderedDouble):
    """The position of the row's last peer / partition rows."""


@dataclass(frozen=True, eq=False)
class NthValue(WindowFunction):
    """nth_value(col, n): the frame's n-th row (1-based), null when the
    frame holds fewer than n rows (ignoreNulls unsupported, as in the
    reference)."""

    child: Expression = None
    n: int = 1

    @property
    def children(self):
        return (self.child,)

    def with_children(self, c):
        return NthValue(c[0], self.n)

    @property
    def dtype(self):
        return self.child.dtype

    @property
    def nullable(self):
        return True

    @property
    def needs_order(self):
        return True


@dataclass(frozen=True, eq=False)
class LagLead(WindowFunction):
    child: Expression = None
    offset: int = 1
    default: Optional[Expression] = None
    is_lag: bool = True

    @property
    def children(self):
        return (self.child,) + ((self.default,) if self.default is not None
                                else ())

    def with_children(self, c):
        return LagLead(c[0], self.offset,
                       c[1] if len(c) > 1 else None, self.is_lag)

    @property
    def dtype(self):
        return self.child.dtype

    @property
    def needs_order(self):
        return True


@dataclass(frozen=True, eq=False)
class WindowAgg(WindowFunction):
    """An aggregate function (Sum, Min, Max, Count, Average) over the
    frame. Its children are the aggregate's, so tagging walks past the
    aggregate node, as in the JAX package."""

    agg: Expression = None

    @property
    def children(self):
        return self.agg.children

    def with_children(self, c):
        return WindowAgg(self.agg.with_children(c))

    def bind(self, schema):
        return WindowAgg(self.agg.bind(schema))

    @property
    def dtype(self):
        return self.agg.dtype

    @property
    def nullable(self):
        return self.agg.nullable


@dataclass(frozen=True, eq=False)
class WindowExpression(Expression):
    """function OVER spec, aliased into a projection by ``WindowExec``."""

    function: WindowFunction = None
    spec: WindowSpec = WindowSpec()

    @property
    def children(self):
        return (self.function,)

    def bind(self, schema):
        f = self.function
        if f.children:
            f = f.bind(schema) if isinstance(f, WindowAgg) else \
                f.with_children([c.bind(schema) for c in f.children])
        return WindowExpression(f, self.spec.bind(schema))

    @property
    def dtype(self):
        return self.function.dtype

    @property
    def nullable(self):
        return self.function.nullable


def over(fn: WindowFunction, partition_by: Sequence[Expression] = (),
         order_by: Sequence = (), frame: Optional[WindowFrame] = None
         ) -> WindowExpression:
    if frame is None:
        frame = DEFAULT_FRAME if order_by else FULL_FRAME
    return WindowExpression(fn, WindowSpec(tuple(partition_by),
                                           tuple(order_by), frame))


# ---------------------------------------------------------------------------
# Segmented-scan primitives used by WindowExec
# ---------------------------------------------------------------------------

def segment_starts(head: torch.Tensor) -> torch.Tensor:
    """int64: the index of the last ``head`` row at or before each row
    (0 before the first)."""
    iota = torch.arange(head.shape[0], device=head.device)
    return torch.cummax(torch.where(head, iota, 0), 0).values


def segment_ends(tail: torch.Tensor) -> torch.Tensor:
    """int64: the index of the first ``tail`` row at or after each row
    (``len(tail)`` after the last)."""
    n = tail.shape[0]
    iota = torch.arange(n, device=tail.device)
    marked = torch.where(tail, iota, n).flip(0)
    return torch.cummin(marked, 0).values.flip(0)


def segmented_int_sum(x: torch.Tensor, seg_start: torch.Tensor
                      ) -> torch.Tensor:
    """The inclusive running int64 sum of ``x`` within each segment: a
    ``cumsum`` difference, wrapping mod 2^64 as the JAX adds do."""
    run = torch.cumsum(x.to(torch.int64), 0)
    before = torch.where(seg_start > 0, run[(seg_start - 1).clamp(min=0)],
                         torch.zeros((), dtype=torch.int64, device=x.device))
    return run - before


def segmented_scan(x: torch.Tensor, head: torch.Tensor,
                   op: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
                   reverse: bool = False) -> torch.Tensor:
    """Inclusive segmented scan of ``op`` that restarts at rows where
    ``head`` is True (with ``reverse``, runs from the end and restarts at
    ``head`` rows going backwards): the JAX package's Hillis-Steele scan,
    ceil(log2(n)) passes of shift, combine and select."""
    n = x.shape[0]
    if reverse:
        return segmented_scan(x.flip(0), head.flip(0), op).flip(0)
    v, f = x, head
    d = 1
    while d < n:
        nv = torch.where(f[d:], v[d:], op(v[:-d], v[d:]))
        nf = f[d:] | f[:-d]
        v = torch.cat([v[:d], nv])
        f = torch.cat([f[:d], nf])
        d <<= 1
    return v
