"""Arithmetic expressions with Spark semantics.

Port of ``spark_rapids_tpu/expressions/arithmetic.py``: ``Add``,
``Subtract``, ``Multiply``, ``Divide``, ``IntegralDivide``, ``Remainder``,
``Pmod``, ``UnaryMinus``, ``Abs``, ``BitwiseOp``, ``BitwiseNot`` and
``Shift``. Operands are cast to the common numeric type. Outside ANSI mode
integer overflow wraps in two's complement, as torch's integer ops do, and
a zero divisor gives null. Under ANSI mode the rows that overflow or divide
by zero are reported to the ``EvalContext`` (``ARITHMETIC_OVERFLOW``,
``DIVIDE_BY_ZERO``), and the operator raises after the batch.

Integer division and remainder truncate toward zero, as Java's ``/`` and
``%`` do. Torch's integer ``div`` and ``fmod`` raise on a zero divisor on
the CPU and trap on ``MIN / -1``, so a safe divisor (1) stands in for 0 and
-1, and a divisor of -1 takes the wrapping negation.

Where the JAX package departs from Spark, the port follows Spark:

- ``MIN div d`` and ``MIN % d`` for ``|d| >= 2``: the JAX package divides
  ``abs(MIN)``, which wraps to MIN, and its floor division then gives the
  wrong quotient (``MIN div 2 = +2^62`` there, ``-2^62`` in Java);
- ``pmod`` by a negative divisor: Spark's ``(r + n) % n`` can stay
  negative (``pmod(-7, -3) = -1``), the JAX package adds ``abs(n)`` (2);
- the ANSI overflow test of ``Multiply`` is exact here (Java's
  ``multiplyExact``); the JAX package's re-division misses ``MIN * -1``
  and reports ``-2^62 * 2``, whose product ``MIN`` fits;
- ANSI reports the JAX package leaves out: ``MIN div -1``, ``-MIN`` and
  ``abs(MIN)`` overflow, and ``%`` and ``pmod`` by zero divide by zero.

int8 and int16 operands wrap at their own width, as Java's narrowing of
the int result does; ``pmod`` computes ``(r + n) % n`` in int, as Java
promotes bytes and shorts. ``Shift`` promotes them to int.
``Multiply`` of decimals gives DECIMAL(min(p1 + p2 + 1, 38), s1 + s2) over
the unscaled product (an integral operand counts as precision 0, scale 0,
as in the JAX package). Other arithmetic on decimals adds unscaled values
as the JAX package does. A result of more than 18 digits has no device
arithmetic here, nor in the JAX package (its int64 product of two
DECIMAL64 columns typed decimal(31, 4) wraps): ``device_unsupported_reason``
refuses it, tagging makes the node an island, and the row interpreter
gives Spark's exact answer, the intent the JAX module states.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from .. import types as T
from ..types import SqlType, TypeKind
from .base import EvalContext, Expression, and_validity, numeric_column


def wide_decimal_reason(e: Expression) -> Optional[str]:
    """Why ``e``'s result has no device arithmetic: a decimal of more than
    18 digits (DECIMAL128 limbs compare, sort and sum on the card, but no
    arithmetic operator computes them). None for every other result."""
    if not all(c.resolved for c in e.children):
        return None
    d = e.dtype
    if d.kind is TypeKind.DECIMAL and d.precision > T.MAX_LONG_DIGITS:
        return (f"{type(e).__name__} returns {d}, past "
                f"{T.MAX_LONG_DIGITS} digits: DECIMAL128 arithmetic runs "
                f"on the row interpreter")
    return None


def _int_min(t: torch.Tensor) -> int:
    return torch.iinfo(t.dtype).min


def _safe_divisor(r: torch.Tensor, fractional: bool) -> torch.Tensor:
    """The divisor with 1 in place of 0 (and of -1 for integers, whose
    quotient by -1 is a negation and whose remainder by -1 is 0)."""
    if fractional:
        return torch.where(r == 0.0, 1.0, r)
    return torch.where((r == 0) | (r == -1), 1, r)


def _to_long(x: torch.Tensor) -> torch.Tensor:
    """Spark's non-ANSI cast to bigint: doubles truncate, NaN becomes 0 and
    values out of range saturate (a plain ``.to(int64)`` of NaN or
    infinity is undefined, and gives MIN on x86)."""
    if not x.is_floating_point():
        return x.to(torch.int64)
    lim = float(2 ** 63)
    y = torch.nan_to_num(x, nan=0.0).clamp(-lim, lim)
    out = y.to(torch.int64)
    return torch.where(y >= lim, torch.iinfo(torch.int64).max, out)


def _div_trunc(l: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Java's integer ``l / r`` (toward zero, ``MIN / -1 = MIN``); rows
    with ``r == 0`` give ``l``."""
    q = torch.div(l, _safe_divisor(r, False), rounding_mode="trunc")
    return torch.where(r == -1, torch.neg(l), q)


@dataclass(frozen=True, eq=False)
class BinaryArithmetic(Expression):
    left: Expression
    right: Expression

    SYMBOL = "?"

    @property
    def children(self):
        return (self.left, self.right)

    def with_children(self, c):
        return type(self)(c[0], c[1])

    @property
    def dtype(self) -> SqlType:
        return T.common_numeric_type(self.left.dtype, self.right.dtype)

    def device_unsupported_reason(self) -> Optional[str]:
        return wide_decimal_reason(self)

    def _operands(self, batch, ctx):
        """(left, right) in the result's storage dtype, their joint
        validity and the result type."""
        lc = self.left.eval(batch, ctx)
        rc = self.right.eval(batch, ctx)
        out = self.dtype
        return (lc.data.to(out.storage_dtype), rc.data.to(out.storage_dtype),
                and_validity([lc, rc]), out)

    def __repr__(self):
        return f"({self.left!r} {self.SYMBOL} {self.right!r})"


class Add(BinaryArithmetic):
    SYMBOL = "+"

    def eval(self, batch, ctx=EvalContext()):
        l, r, v, d = self._operands(batch, ctx)
        res = l + r
        if ctx.ansi and d.is_integral:
            # two's-complement overflow: the sign differs from both
            ctx.report((((l ^ res) & (r ^ res)) < 0) & v)
        return numeric_column(res, v, d)


class Subtract(BinaryArithmetic):
    SYMBOL = "-"

    def eval(self, batch, ctx=EvalContext()):
        l, r, v, d = self._operands(batch, ctx)
        res = l - r
        if ctx.ansi and d.is_integral:
            ctx.report((((l ^ r) & (l ^ res)) < 0) & v)
        return numeric_column(res, v, d)


class Multiply(BinaryArithmetic):
    SYMBOL = "*"

    @property
    def dtype(self):
        d = T.common_numeric_type(self.left.dtype, self.right.dtype)
        if d.kind is TypeKind.DECIMAL:
            ld, rd = self.left.dtype, self.right.dtype
            return T.decimal(min(ld.precision + rd.precision + 1, 38),
                             ld.scale + rd.scale)
        return d

    def eval(self, batch, ctx=EvalContext()):
        l, r, v, d = self._operands(batch, ctx)
        res = l * r
        if ctx.ansi and d.is_integral:
            # exact, as Java's multiplyExact: by -1 only MIN overflows;
            # otherwise the wrapped product re-divides to l iff it is exact
            bad = torch.where(r == -1, l == _int_min(l),
                              (r != 0) & (_div_trunc(res, r) != l))
            ctx.report(bad & v)
        return numeric_column(res, v, d)


class _DivisionFamily(BinaryArithmetic):
    @property
    def nullable(self):
        # a zero divisor nulls the result outside ANSI mode whatever the
        # children's nullability; a False here would let a sort drop the
        # key's null lane
        return True

    def _divisor_checked(self, batch, ctx):
        """Operands, with the rows of a zero divisor reported as
        DIVIDE_BY_ZERO under ANSI and taken out of the validity."""
        l, r, v, d = self._operands(batch, ctx)
        zero = r == 0
        if ctx.ansi:
            ctx.report(v & zero, "DIVIDE_BY_ZERO")
        return l, r, v & ~zero, d


class Divide(_DivisionFamily):
    """Spark ``/``: true division to DOUBLE; ``x / 0`` is null."""

    SYMBOL = "/"

    @property
    def dtype(self):
        return T.FLOAT64

    def eval(self, batch, ctx=EvalContext()):
        l, r, v, d = self._divisor_checked(batch, ctx)
        return numeric_column(l / _safe_divisor(r, True), v, d)


class IntegralDivide(_DivisionFamily):
    """Spark ``div``: integral division to BIGINT, toward zero; ``x div 0``
    is null. Under ANSI ``MIN div -1`` overflows, as Spark's check does."""

    SYMBOL = "div"

    @property
    def dtype(self):
        return T.INT64

    def _operands(self, batch, ctx):
        # double operands are cast to bigint first, as Spark's analyzer does
        lc = self.left.eval(batch, ctx)
        rc = self.right.eval(batch, ctx)
        return (_to_long(lc.data), _to_long(rc.data), and_validity([lc, rc]),
                self.dtype)

    def eval(self, batch, ctx=EvalContext()):
        l, r, v, d = self._divisor_checked(batch, ctx)
        if ctx.ansi:
            ctx.report(v & (l == _int_min(l)) & (r == -1))
        return numeric_column(_div_trunc(l, r), v, d)


class Remainder(_DivisionFamily):
    """Spark ``%``: the sign follows the dividend (Java ``%``, C ``fmod``);
    ``x % 0`` is null."""

    SYMBOL = "%"

    def eval(self, batch, ctx=EvalContext()):
        l, r, v, d = self._divisor_checked(batch, ctx)
        return numeric_column(
            torch.fmod(l, _safe_divisor(r, d.is_fractional)), v, d)


class Pmod(_DivisionFamily):
    """Spark ``pmod``: ``r = a % n; r < 0 ? (r + n) % n : r``, which is
    negative for some negative divisors, as in Spark."""

    SYMBOL = "pmod"

    def eval(self, batch, ctx=EvalContext()):
        l, r, v, d = self._divisor_checked(batch, ctx)
        if l.dtype in (torch.int8, torch.int16):
            # Java adds bytes and shorts as ints: r + n must not wrap
            l, r = l.to(torch.int32), r.to(torch.int32)
        safe = _safe_divisor(r, d.is_fractional)
        m = torch.fmod(l, safe)
        m = torch.where(m < 0, torch.fmod(m + r, safe), m)
        return numeric_column(m.to(d.storage_dtype), v, d)


@dataclass(frozen=True, eq=False)
class _Unary(Expression):
    child: Expression

    @property
    def children(self):
        return (self.child,)

    def with_children(self, c):
        return type(self)(c[0])

    @property
    def dtype(self):
        return self.child.dtype

    def device_unsupported_reason(self) -> Optional[str]:
        return wide_decimal_reason(self)


class UnaryMinus(_Unary):
    """``-x``; under ANSI ``-MIN`` overflows (Java's negateExact)."""

    def eval(self, batch, ctx=EvalContext()):
        c = self.child.eval(batch, ctx)
        if ctx.ansi and self.dtype.is_integral:
            ctx.report(c.validity & (c.data == _int_min(c.data)))
        return numeric_column(torch.neg(c.data), c.validity, self.dtype)

    def __repr__(self):
        return f"(- {self.child!r})"


class Abs(_Unary):
    """``abs(x)``; ``abs(MIN)`` wraps to MIN, and overflows under ANSI."""

    def eval(self, batch, ctx=EvalContext()):
        c = self.child.eval(batch, ctx)
        if ctx.ansi and self.dtype.is_integral:
            ctx.report(c.validity & (c.data == _int_min(c.data)))
        return numeric_column(torch.abs(c.data), c.validity, self.dtype)

    def __repr__(self):
        return f"abs({self.child!r})"


_BITWISE = {"and": torch.bitwise_and, "or": torch.bitwise_or,
            "xor": torch.bitwise_xor}


@dataclass(frozen=True, eq=False)
class BitwiseOp(Expression):
    left: Expression
    right: Expression
    op: str = "and"  # and | or | xor

    @property
    def children(self):
        return (self.left, self.right)

    def with_children(self, c):
        return BitwiseOp(c[0], c[1], self.op)

    @property
    def dtype(self):
        return T.common_numeric_type(self.left.dtype, self.right.dtype)

    def eval(self, batch, ctx=EvalContext()):
        lc = self.left.eval(batch, ctx)
        rc = self.right.eval(batch, ctx)
        d = self.dtype
        res = _BITWISE[self.op](lc.data.to(d.storage_dtype),
                                rc.data.to(d.storage_dtype))
        return numeric_column(res, and_validity([lc, rc]), d)

    def __repr__(self):
        return f"({self.left!r} {self.op} {self.right!r})"


class BitwiseNot(_Unary):
    def eval(self, batch, ctx=EvalContext()):
        c = self.child.eval(batch, ctx)
        return numeric_column(torch.bitwise_not(c.data), c.validity,
                              self.dtype)


@dataclass(frozen=True, eq=False)
class Shift(Expression):
    """shiftleft / shiftright / shiftrightunsigned, with Java's semantics:
    the amount is taken as an int and then modulo the value's bit width (32
    for int, 64 for bigint), so -1 shifts by 31 or 63 and 32 by 0 or 32."""

    left: Expression
    right: Expression
    op: str = "left"        # left | right | right_unsigned

    @property
    def children(self):
        return (self.left, self.right)

    def with_children(self, c):
        return Shift(c[0], c[1], self.op)

    @property
    def dtype(self):
        # Spark: an int or bigint result; narrower inputs are promoted to int
        if self.left.dtype.kind is TypeKind.INT64:
            return self.left.dtype
        return T.INT32

    def eval(self, batch, ctx=EvalContext()):
        lc = self.left.eval(batch, ctx)
        rc = self.right.eval(batch, ctx)
        v = lc.data.to(self.dtype.storage_dtype)
        width = v.element_size() * 8
        amt = (rc.data.to(torch.int32) & (width - 1)).to(v.dtype)
        if self.op == "left":
            out = torch.bitwise_left_shift(v, amt)
        elif self.op == "right":
            out = torch.bitwise_right_shift(v, amt)     # arithmetic
        elif self.op == "right_unsigned":
            # torch has no unsigned shift of int32/int64: shift
            # arithmetically, then clear the amt copies of the sign bit;
            # amt == 0 keeps v (its mask would need a shift by the width)
            keep = torch.bitwise_left_shift(
                torch.ones_like(v), width - amt.clamp(min=1)) - 1
            out = torch.where(amt == 0, v,
                              torch.bitwise_right_shift(v, amt) & keep)
        else:
            raise ValueError(f"unknown shift {self.op!r}")
        return numeric_column(out, and_validity([lc, rc]), self.dtype)
