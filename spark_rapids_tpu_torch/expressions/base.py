"""Expression evaluation model.

Port of ``spark_rapids_tpu/expressions/base.py``: a bound expression's
``eval(batch)`` returns a ``DeviceColumn`` computed with torch ops on the
batch's device. Validity masks propagate explicitly; the default combinator
is the AND of the children's validities (Spark's null-intolerant
expressions). Trees are built unresolved with ``col("name")`` and resolved
against a schema with ``bind``.
"""

from __future__ import annotations

import datetime
import decimal
import functools
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .. import types as T
from ..batch import (ColumnarBatch, DeviceColumn, Schema, StringOverflowError,
                     empty_column)
from ..dictenc import decode_column
from ..types import SqlType, TypeKind


@dataclass(frozen=True)
class EvalContext:
    """Evaluation flags, and the collector of row errors.

    Under ANSI mode an expression reports the rows that must fail (integer
    overflow, division by zero) with ``report``, which appends a count to
    ``errors`` as a device scalar: nothing is read back while the
    expressions run. The operator that made the collector sums it and
    raises after the batch (``exec/basic.py`` ``_raise_ansi``); the fused
    stage reads it once with its other flags. Outside ANSI mode, and with
    no collector, ``report`` does nothing."""

    ansi: bool = False
    #: kind -> device counts of the rows reported; None collects nothing
    errors: Optional[Dict[str, List[torch.Tensor]]] = None
    #: a host int per (partition, batch) that stateless random expressions
    #: (``Rand``) fold into their key, so that batches draw different
    #: values while a re-execution draws the same; None where the operator
    #: gives none (as in the JAX package, only ``ProjectExec`` does)
    batch_seed: Optional[int] = None

    def report(self, bad: torch.Tensor, kind: str = "ARITHMETIC_OVERFLOW",
               always: bool = False) -> None:
        """``bad``: bool rows that must fail under ANSI. ``always`` reports
        whatever the ANSI flag says (fixed device budgets, ``CAPACITY_*``
        kinds, must fail loud in any mode)."""
        if (self.ansi or always) and self.errors is not None:
            self.errors.setdefault(kind, []).append(
                bad.sum(dtype=torch.int64))


@dataclass(frozen=True, eq=False)
class Expression:
    """Base class. Subclasses are frozen dataclasses; trees are immutable.

    ``==`` and ``!=`` build ``EqualTo`` and ``Not(EqualTo)`` trees, as the
    JAX package's do, so an expression never compares as a Python value:
    code that needs to know whether two nodes are the same uses ``is``
    (``same_node``), and an expression in a boolean context raises, so that
    a ``==`` or an ``in`` over expressions cannot pass silently. Hashing is
    by identity: dicts key on nodes."""

    @property
    def children(self) -> Tuple["Expression", ...]:
        return ()

    def with_children(self, children: Sequence["Expression"]) -> "Expression":
        raise NotImplementedError(type(self).__name__)

    @property
    def resolved(self) -> bool:
        return all(c.resolved for c in self.children)

    def bind(self, schema: Schema) -> "Expression":
        return self.with_children([c.bind(schema) for c in self.children]) \
            if self.children else self

    @property
    def dtype(self) -> SqlType:
        raise NotImplementedError(type(self).__name__)

    @property
    def nullable(self) -> bool:
        return any(c.nullable for c in self.children) if self.children else True

    def eval(self, batch: ColumnarBatch, ctx: EvalContext = EvalContext()
             ) -> DeviceColumn:
        raise NotImplementedError(type(self).__name__)

    # ---- sugar: operator overloads build unresolved trees ----
    def __add__(self, other):
        from .arithmetic import Add
        return Add(self, lit_if_needed(other))

    def __radd__(self, other):
        from .arithmetic import Add
        return Add(lit_if_needed(other), self)

    def __sub__(self, other):
        from .arithmetic import Subtract
        return Subtract(self, lit_if_needed(other))

    def __rsub__(self, other):
        from .arithmetic import Subtract
        return Subtract(lit_if_needed(other), self)

    def __mul__(self, other):
        from .arithmetic import Multiply
        return Multiply(self, lit_if_needed(other))

    def __rmul__(self, other):
        from .arithmetic import Multiply
        return Multiply(lit_if_needed(other), self)

    def __truediv__(self, other):
        from .arithmetic import Divide
        return Divide(self, lit_if_needed(other))

    def __mod__(self, other):
        from .arithmetic import Remainder
        return Remainder(self, lit_if_needed(other))

    def __neg__(self):
        from .arithmetic import UnaryMinus
        return UnaryMinus(self)

    def __and__(self, other):
        from .boolean import And
        return And(self, lit_if_needed(other))

    def __or__(self, other):
        from .boolean import Or
        return Or(self, lit_if_needed(other))

    def __invert__(self):
        from .comparison import Not
        return Not(self)

    def __eq__(self, other):  # type: ignore[override]
        from .comparison import EqualTo
        return EqualTo(self, lit_if_needed(other))

    def __ne__(self, other):  # type: ignore[override]
        from .comparison import EqualTo, Not
        return Not(EqualTo(self, lit_if_needed(other)))

    def __bool__(self):
        raise TypeError(
            f"{type(self).__name__} has no truth value: == builds EqualTo; "
            f"compare nodes with 'is'")

    def __lt__(self, other):
        from .comparison import LessThan
        return LessThan(self, lit_if_needed(other))

    def __le__(self, other):
        from .comparison import LessThanOrEqual
        return LessThanOrEqual(self, lit_if_needed(other))

    def __gt__(self, other):
        from .comparison import GreaterThan
        return GreaterThan(self, lit_if_needed(other))

    def __ge__(self, other):
        from .comparison import GreaterThanOrEqual
        return GreaterThanOrEqual(self, lit_if_needed(other))

    def __hash__(self):
        return object.__hash__(self)

    def alias(self, name: str) -> "Alias":
        return Alias(self, name)

    def cast(self, to: SqlType) -> "Expression":
        from .cast import Cast
        return Cast(self, to)

    def is_null(self) -> "Expression":
        from .comparison import IsNull
        return IsNull(self)

    def is_not_null(self) -> "Expression":
        from .comparison import IsNotNull
        return IsNotNull(self)


def same_node(a: Expression, seq) -> int:
    """The position of node ``a`` in ``seq`` by identity (``list.index``
    would build ``EqualTo`` trees); raises ``ValueError`` if absent."""
    for i, b in enumerate(seq):
        if b is a:
            return i
    raise ValueError(f"{a!r} is not in the sequence")


def lit_if_needed(v: Any) -> Expression:
    return v if isinstance(v, Expression) else Literal.of(v)


def resolve_stored_column(expr: Expression, batch: ColumnarBatch
                          ) -> Optional[DeviceColumn]:
    """The stored column a (possibly aliased) bare reference names, its
    dictionary encoding intact, without evaluating anything; None for a
    computed expression (a probe must not evaluate: that would run the
    child twice and report its ANSI errors twice)."""
    e = expr
    while isinstance(e, Alias):
        e = e.child
    if isinstance(e, BoundReference):
        return batch.columns[e.ordinal]
    return None


def raw_eval(expr: Expression, batch: ColumnarBatch,
             ctx: EvalContext = EvalContext()) -> DeviceColumn:
    """A (possibly aliased) bare column reference yields the stored column
    as it is, dictionary codes included, for the consumers that work on
    codes (group-by keys, hash partitioning, identity projections);
    anything else evaluates, and so decodes."""
    col = resolve_stored_column(expr, batch)
    return col if col is not None else expr.eval(batch, ctx)


# ---------------------------------------------------------------------------
# Leaves
# ---------------------------------------------------------------------------

@dataclass(frozen=True, eq=False)
class UnresolvedColumn(Expression):
    name: str

    @property
    def resolved(self):
        return False

    def bind(self, schema: Schema) -> "BoundReference":
        i = schema.index_of(self.name)
        f = schema[i]
        return BoundReference(i, f.dtype, f.nullable, f.name)

    def __repr__(self):
        return f"col({self.name!r})"


def col(name: str) -> UnresolvedColumn:
    return UnresolvedColumn(name)


@dataclass(frozen=True, eq=False)
class BoundReference(Expression):
    """Resolved input-column reference."""

    ordinal: int
    _dtype: SqlType
    _nullable: bool = True
    name: str = ""

    @property
    def resolved(self):
        return True

    @property
    def dtype(self):
        return self._dtype

    @property
    def nullable(self):
        return self._nullable

    def eval(self, batch, ctx=EvalContext()):
        col = batch.columns[self.ordinal]
        if col.dict_data is not None:
            # the decode point: an expression that reads string bytes sees
            # the padded matrix (one gather); consumers that work on codes
            # use raw_eval instead
            return decode_column(col)
        return col

    def __repr__(self):
        return f"input[{self.ordinal}, {self._dtype}]"


@dataclass(frozen=True, eq=False)
class Literal(Expression):
    """A scalar constant, evaluated to a column filled with it."""

    value: Any
    _dtype: SqlType

    @staticmethod
    def of(v: Any, dtype: Optional[SqlType] = None) -> "Literal":
        return Literal(v, dtype or _infer_literal_type(v))

    @property
    def resolved(self):
        return True

    @property
    def dtype(self):
        return self._dtype

    @property
    def nullable(self):
        return self.value is None

    def eval(self, batch, ctx=EvalContext()):
        cap, dev = batch.capacity, batch.device
        d = self._dtype
        if self.value is None:
            return empty_column(d, dev, cap)
        if d.kind is TypeKind.STRING:
            b = str(self.value).encode("utf-8")
            if len(b) > d.max_len:
                raise StringOverflowError(f"literal longer than {d.max_len}")
            # one row on the device, broadcast (a view) to every row
            data = _device_row(b, d.max_len, dev).expand(cap, d.max_len)
            return DeviceColumn(data, batch.row_mask(), d,
                                torch.full((cap,), len(b), dtype=torch.int32,
                                           device=dev))
        v = self.value
        if d.kind is TypeKind.DATE and isinstance(v, datetime.date):
            v = epoch_days(v)
        if d.kind is TypeKind.DECIMAL:
            v = unscaled(v, d.scale)
            if d.precision > T.MAX_LONG_DIGITS:
                # one row of limbs on the device, broadcast to every row
                data = _device_limbs(v, dev).expand(cap, 4)
                return DeviceColumn(data, batch.row_mask(), d)
        data = torch.full((cap,), v, dtype=d.storage_dtype, device=dev)
        return DeviceColumn(data, batch.row_mask(), d)

    def __repr__(self):
        return f"lit({self.value!r})"


@functools.lru_cache(maxsize=256)
def _device_row(value: bytes, max_len: int,
                device: torch.device) -> torch.Tensor:
    """A string literal's zero-padded bytes on the device, copied there
    once per value and device: a later evaluation makes no host copy, so it
    is safe inside a CUDA graph capture."""
    row = torch.zeros(max_len, dtype=torch.uint8)
    row[:len(value)] = torch.tensor(list(value), dtype=torch.uint8)
    return row.to(device)


def unscaled(v: Any, scale: int) -> int:
    """A decimal literal's unscaled int at ``scale``: its exact value (a
    ``Decimal``, int or string) times 10^scale, in a context wide enough
    not to round (the default one rounds at 28 digits)."""
    with decimal.localcontext() as cx:
        cx.prec = 80
        return int(decimal.Decimal(str(v)).scaleb(scale))


@functools.lru_cache(maxsize=256)
def _device_limbs(value: int, device: torch.device) -> torch.Tensor:
    """A DECIMAL128 literal's four limbs on the device, copied there once
    per value and device (capture-safe, as ``_device_row``)."""
    from .decimal128 import to_limbs_np
    return torch.from_numpy(to_limbs_np([value])[0]).to(device)


def _infer_literal_type(v: Any) -> SqlType:
    if isinstance(v, (bool, np.bool_)):
        return T.BOOLEAN
    if isinstance(v, np.integer):
        return T.INT32 if v.dtype == np.int32 else T.INT64
    if isinstance(v, int):
        return T.INT32 if -(2**31) <= v < 2**31 else T.INT64
    if isinstance(v, (float, np.floating)):
        return T.FLOAT64
    if isinstance(v, str):
        return T.string(max(8, len(v.encode("utf-8"))))
    if isinstance(v, datetime.date) and not isinstance(v, datetime.datetime):
        return T.DATE
    raise NotImplementedError(f"no literal type for {v!r} in the port yet")


def epoch_days(d: datetime.date) -> int:
    """A date as the days since 1970-01-01 that a DATE column stores."""
    return d.toordinal() - _EPOCH_ORDINAL


_EPOCH_ORDINAL = datetime.date(1970, 1, 1).toordinal()


def lit(v: Any, dtype: Optional[SqlType] = None) -> Literal:
    return Literal.of(v, dtype)


@dataclass(frozen=True, eq=False)
class Alias(Expression):
    child: Expression
    name: str

    @property
    def children(self):
        return (self.child,)

    def with_children(self, c):
        return Alias(c[0], self.name)

    @property
    def dtype(self):
        return self.child.dtype

    @property
    def nullable(self):
        return self.child.nullable

    def eval(self, batch, ctx=EvalContext()):
        return self.child.eval(batch, ctx)

    def __repr__(self):
        return f"{self.child!r} AS {self.name}"


# ---------------------------------------------------------------------------
# Shared helpers for subclasses
# ---------------------------------------------------------------------------

def and_validity(cols: Sequence[DeviceColumn]) -> torch.Tensor:
    v = cols[0].validity
    for c in cols[1:]:
        v = v & c.validity
    return v


def numeric_column(data: torch.Tensor, validity: torch.Tensor,
                   dtype: SqlType) -> DeviceColumn:
    """Zero the payload of invalid slots, so padding stays deterministic
    and NaN never leaks into reductions."""
    zero = torch.zeros((), dtype=data.dtype, device=data.device)
    return DeviceColumn(torch.where(validity, data, zero), validity, dtype)


def _align_string_widths(a: DeviceColumn, b: DeviceColumn
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Zero-pad the narrower byte matrix so two string columns of
    different max_len compare elementwise (padding bytes are 0x00, which
    sorts below any content byte)."""
    wa, wb = a.data.shape[1], b.data.shape[1]
    w = max(wa, wb)
    da = F.pad(a.data, (0, w - wa)) if wa < w else a.data
    db = F.pad(b.data, (0, w - wb)) if wb < w else b.data
    return da, db


def string_equal(a: DeviceColumn, b: DeviceColumn) -> torch.Tensor:
    da, db = _align_string_widths(a, b)
    return (da == db).all(dim=1) & (a.lengths == b.lengths)


def string_compare_lt(a: DeviceColumn, b: DeviceColumn) -> torch.Tensor:
    """UTF-8 byte-wise lexicographic a < b over padded matrices: the first
    differing byte decides, unsigned; equal bytes leave it to the lengths
    (a value may end in 0x00 bytes, which the padding cannot show)."""
    da, db = _align_string_widths(a, b)
    diff = da != db
    first = diff.to(torch.uint8).argmax(dim=1, keepdim=True)
    ab = da.gather(1, first)[:, 0]
    bb = db.gather(1, first)[:, 0]
    return torch.where(diff.any(dim=1), ab < bb, a.lengths < b.lengths)
