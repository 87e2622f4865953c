"""Comparison and null-test expressions.

Port of ``BinaryComparison`` (``EqualTo``, ``LessThan``,
``LessThanOrEqual``, ``GreaterThan``, ``GreaterThanOrEqual``),
``EqualNullSafe``, ``Not``, ``IsNull``, ``IsNotNull``, ``IsNaN`` and ``In`` from
``spark_rapids_tpu/expressions/comparison.py``, for the fixed-width kinds
and strings. A null on either side makes a comparison null (``<=>`` is never
null); the payload of null rows is False.

Doubles compare in Spark's order: NaN equals NaN and is greater than every
other value, and -0.0 equals 0.0. The JAX package compares them as IEEE
floats (NaN unequal to everything), so the two differ on NaN rows only.
A string column ``<op>`` literal, and ``In``, over a dictionary-encoded
column evaluate once per distinct dictionary entry and gather the result
through the codes (``_dict_pushdown``), as in the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from .. import types as T
from ..batch import ColumnarBatch, DeviceColumn, rows_scalar
from ..dictenc import dict_entries_column, gather_entries
from ..types import TypeKind
from .base import (EvalContext, Expression, Literal, and_validity,
                   resolve_stored_column, string_compare_lt, string_equal)

_OPS = {"eq": torch.eq, "lt": torch.lt, "le": torch.le,
        "gt": torch.gt, "ge": torch.ge}


def _bool_col(data: torch.Tensor, validity: torch.Tensor) -> DeviceColumn:
    return DeviceColumn(data & validity, validity, T.BOOLEAN)


def _compare_data(lc: DeviceColumn, rc: DeviceColumn, op: str
                  ) -> torch.Tensor:
    """Raw comparison payload, ignoring validity."""
    if lc.dtype.kind is TypeKind.STRING:
        eq = string_equal(lc, rc)
        if op == "eq":
            return eq
        lt = string_compare_lt(lc, rc)
        return {"lt": lt, "le": lt | eq, "gt": ~(lt | eq), "ge": ~lt}[op]
    if lc.dtype.is_fractional or rc.dtype.is_fractional:
        return _float_compare(lc.data.to(torch.float64),
                              rc.data.to(torch.float64), op)
    ls, rs = lc.dtype.scale, rc.dtype.scale
    if lc.data.dim() > 1 or rc.data.dim() > 1:      # DECIMAL128 limbs
        from .decimal128 import compare, lift64, rescale_up
        ld = lc.data if lc.data.dim() > 1 else lift64(lc.data)
        rd = rc.data if rc.data.dim() > 1 else lift64(rc.data)
        # align the scales first; tagging refuses gaps past 10^9
        # (decimal_cmp_unsupported_reason)
        if ls < rs:
            ld = rescale_up(ld, 10 ** (rs - ls))
        elif rs < ls:
            rd = rescale_up(rd, 10 ** (ls - rs))
        lt, eq = compare(ld, rd)
        return {"eq": eq, "lt": lt, "le": lt | eq,
                "gt": ~(lt | eq), "ge": ~lt}[op]
    if lc.dtype.kind is TypeKind.DECIMAL and \
            rc.dtype.kind is TypeKind.DECIMAL and ls != rs:
        # two DECIMAL64 of different scales align in int64; tagging
        # refuses the pairs whose rescale could overflow
        return _OPS[op](lc.data * 10 ** max(0, rs - ls),
                        rc.data * 10 ** max(0, ls - rs))
    # torch promotes mixed widths (int32 date vs int64 literal) itself
    return _OPS[op](lc.data, rc.data)


def decimal_cmp_unsupported_reason(lt, rt) -> Optional[str]:
    """Why the device cannot compare decimals of these two types, or None:
    different scales need a rescale of the narrower one, which must stay
    inside int64 for two DECIMAL64 and inside 10^9 and 38 digits for
    limbs (the JAX package's gate, word for word)."""
    if lt.kind is not TypeKind.DECIMAL or rt.kind is not TypeKind.DECIMAL:
        return None
    if lt.scale == rt.scale:
        return None
    diff = abs(lt.scale - rt.scale)
    small, big = (lt, rt) if lt.scale < rt.scale else (rt, lt)
    if small.precision <= 18 and big.precision <= 18:
        if small.precision + diff > 18:
            return (f"comparing {small} to {big} rescales past the int64 "
                    f"unscaled range")
        return None
    if diff > 9:
        return (f"comparing {small} to {big}: scale gap {diff} exceeds the "
                f"limb rescale budget (10^9)")
    if small.precision + diff > 38:
        return f"comparing {small} to {big} rescales past 38 digits"
    return None


def _float_compare(l: torch.Tensor, r: torch.Tensor, op: str
                   ) -> torch.Tensor:
    """Spark's double order: NaN == NaN, NaN above everything else; IEEE
    comparison already makes -0.0 == 0.0."""
    ln, rn = torch.isnan(l), torch.isnan(r)
    eq = (l == r) | (ln & rn)
    if op == "eq":
        return eq
    lt = (l < r) | (~ln & rn)
    gt = (l > r) | (ln & ~rn)
    return {"lt": lt, "le": lt | eq, "gt": gt, "ge": gt | eq}[op]


def _dict_pushdown(child: Expression, batch, eval_entries
                   ) -> Optional[DeviceColumn]:
    """When ``child`` is a (possibly aliased) bare reference to a
    dictionary-encoded string column: ``eval_entries(entries, ebatch)``
    over the [card] distinct entries, gathered through the codes; the
    predicate's cost drops from the rows to the entries. None otherwise
    (a computed child is never dict-encoded, and the probe evaluates
    nothing)."""
    if child.dtype.kind is not TypeKind.STRING:
        return None
    col = resolve_stored_column(child, batch)
    if col is None or col.dict_data is None:
        return None
    ents = dict_entries_column(col)
    ebatch = ColumnarBatch((ents,), rows_scalar(ents.capacity,
                                                ents.validity.device))
    emask = eval_entries(ents, ebatch)            # bool[card]
    return _bool_col(gather_entries(emask, col), col.validity)


@dataclass(frozen=True, eq=False)
class BinaryComparison(Expression):
    left: Expression
    right: Expression
    OP = "eq"

    @property
    def children(self):
        return (self.left, self.right)

    def with_children(self, c):
        return type(self)(c[0], c[1])

    @property
    def dtype(self):
        return T.BOOLEAN

    def device_unsupported_reason(self) -> Optional[str]:
        if self.left.resolved and self.right.resolved:
            return decimal_cmp_unsupported_reason(self.left.dtype,
                                                  self.right.dtype)
        return None

    def _dict_fast(self, batch, ctx):
        """A dictionary string column ``<op>`` a non-null literal: compare
        the entries, gather [card] booleans by code."""
        def side(child, litexpr, op):
            if not isinstance(litexpr, Literal) or litexpr.value is None:
                return None
            return _dict_pushdown(
                child, batch, lambda ents, eb: _compare_data(
                    ents, litexpr.eval(eb, ctx), op))

        r = side(self.left, self.right, self.OP)
        if r is not None:
            return r
        flipped = {"eq": "eq", "lt": "gt", "le": "ge",
                   "gt": "lt", "ge": "le"}[self.OP]
        return side(self.right, self.left, flipped)

    def eval(self, batch, ctx=EvalContext()):
        fast = self._dict_fast(batch, ctx)
        if fast is not None:
            return fast
        lc = self.left.eval(batch, ctx)
        rc = self.right.eval(batch, ctx)
        return _bool_col(_compare_data(lc, rc, self.OP),
                         and_validity([lc, rc]))

    def __repr__(self):
        return f"({self.left!r} {self.OP} {self.right!r})"


class EqualTo(BinaryComparison):
    OP = "eq"


class LessThan(BinaryComparison):
    OP = "lt"


class LessThanOrEqual(BinaryComparison):
    OP = "le"


class GreaterThan(BinaryComparison):
    OP = "gt"


class GreaterThanOrEqual(BinaryComparison):
    OP = "ge"


class EqualNullSafe(BinaryComparison):
    """``<=>``: null <=> null is true, null <=> value false; never null."""

    OP = "eq"

    @property
    def nullable(self):
        return False

    def eval(self, batch, ctx=EvalContext()):
        lc = self.left.eval(batch, ctx)
        rc = self.right.eval(batch, ctx)
        eq = _compare_data(lc, rc, "eq")
        both_null = ~lc.validity & ~rc.validity
        data = (lc.validity & rc.validity & eq) | both_null
        live = batch.row_mask()
        return DeviceColumn(data & live, live, T.BOOLEAN)


@dataclass(frozen=True, eq=False)
class Not(Expression):
    child: Expression

    @property
    def children(self):
        return (self.child,)

    def with_children(self, c):
        return Not(c[0])

    @property
    def dtype(self):
        return T.BOOLEAN

    def eval(self, batch, ctx=EvalContext()):
        c = self.child.eval(batch, ctx)
        return _bool_col(~c.data, c.validity)

    def __repr__(self):
        return f"NOT {self.child!r}"


@dataclass(frozen=True, eq=False)
class IsNull(Expression):
    child: Expression

    @property
    def children(self):
        return (self.child,)

    def with_children(self, c):
        return type(self)(c[0])

    @property
    def dtype(self):
        return T.BOOLEAN

    @property
    def nullable(self):
        return False

    def _test(self, validity: torch.Tensor) -> torch.Tensor:
        return ~validity

    def eval(self, batch, ctx=EvalContext()):
        c = self.child.eval(batch, ctx)
        live = batch.row_mask()
        return DeviceColumn(self._test(c.validity) & live, live, T.BOOLEAN)

    def __repr__(self):
        return f"isnull({self.child!r})"


class IsNotNull(IsNull):
    def _test(self, validity: torch.Tensor) -> torch.Tensor:
        return validity

    def __repr__(self):
        return f"isnotnull({self.child!r})"


@dataclass(frozen=True, eq=False)
class IsNaN(Expression):
    """isnan(x): true for a NaN double, false for any other value and for
    null (Spark's ``IsNaN`` is never null; the JAX device gives null)."""

    child: Expression

    @property
    def children(self):
        return (self.child,)

    def with_children(self, c):
        return IsNaN(c[0])

    @property
    def dtype(self):
        return T.BOOLEAN

    @property
    def nullable(self):
        return False

    def eval(self, batch, ctx=EvalContext()):
        c = self.child.eval(batch, ctx)
        nan = torch.isnan(c.data.to(torch.float64)) & c.validity
        return DeviceColumn(nan, batch.row_mask(), T.BOOLEAN)

    def __repr__(self):
        return f"isnan({self.child!r})"


@dataclass(frozen=True, eq=False)
class In(Expression):
    """value IN (literals...). Spark's three-valued logic: null if the value
    is null, or if nothing matches and the list holds a null."""

    child: Expression
    values: Tuple = ()

    @property
    def children(self):
        return (self.child,)

    def with_children(self, c):
        return In(c[0], self.values)

    @property
    def dtype(self):
        return T.BOOLEAN

    def eval(self, batch, ctx=EvalContext()):
        non_null = [v for v in self.values if v is not None]
        has_null_item = len(non_null) != len(self.values)

        def found_in(c, b):
            found = torch.zeros(b.capacity, dtype=torch.bool,
                                device=b.device)
            for v in non_null:
                litc = Literal.of(v, self.child.dtype).eval(b, ctx)
                found = found | _compare_data(c, litc, "eq")
            return found

        fast = _dict_pushdown(self.child, batch, found_in)
        if fast is not None:
            if has_null_item:
                return _bool_col(fast.data, fast.validity & fast.data)
            return fast
        c = self.child.eval(batch, ctx)
        found = found_in(c, batch)
        validity = c.validity & found if has_null_item else c.validity
        return _bool_col(found, validity)

    def __repr__(self):
        return f"{self.child!r} IN {self.values!r}"
