"""Math expressions with Spark's semantics.

Port of ``spark_rapids_tpu/expressions/math.py`` (reference:
mathExpressions.scala). The Spark quirks it keeps:

- log, log10, log2 and log1p are NULL for input at or below their domain's
  edge (0, or -1 for log1p), not NaN; sqrt of a negative is NaN.
- round() is HALF_UP (Java BigDecimal): ``sign(x) * floor(|x| * 10^s +
  0.5) / 10^s``; only bround() rounds half to even (``torch.round``).
- floor and ceil of a double return BIGINT.

Two torch ops differ from XLA's and are not used as they are:
``torch.sign`` gives 0 for NaN and +0 for -0.0, where XLA keeps both, so
``_sign`` is written out; a float to integer conversion of NaN, an
infinity or a value out of range is undefined on CUDA, where XLA
truncates and saturates (NaN to 0), so ``float_to_int`` saturates first.

``Rand`` draws the JAX package's values bit for bit: threefry2x32 written
in int64 torch ops (each 32-bit word masked), the same key derivation
(``jax.random.key``, ``fold_in`` by the batch seed) and the same
bits-to-double step as ``jax.random.uniform``, so the card, the CPU and
the JAX package give one sequence. ``RaiseError`` reports its rows on the
error channel (``EvalContext.report``) with no host read.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, ClassVar, Dict, Tuple

import torch

from .. import types as T
from ..batch import DeviceColumn
from ..types import TypeKind
from .base import EvalContext, Expression, and_validity, numeric_column

_F64 = torch.float64


def _sign(x: torch.Tensor) -> torch.Tensor:
    """XLA's sign: -1, 0 or 1, with NaN and -0.0 kept as they are."""
    one = torch.ones((), dtype=x.dtype, device=x.device)
    return torch.where(x > 0, one, torch.where(x < 0, -one, x))


def float_to_int(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """XLA's float to integer conversion, the same on every device:
    truncated toward zero, NaN to 0, saturated at the type's range."""
    info = torch.iinfo(dtype)
    xf = x.to(_F64)
    t = torch.where(torch.isnan(xf), torch.zeros((), dtype=_F64,
                                                 device=x.device),
                    torch.trunc(xf))
    if dtype == torch.int64:
        two63 = 2.0 ** 63
        big, small = t >= two63, t < -two63
        safe = torch.where(big | small, torch.zeros_like(t), t)
        out = safe.to(torch.int64)
        out = torch.where(big, torch.full_like(out, info.max), out)
        return torch.where(small, torch.full_like(out, info.min), out)
    return t.clamp(float(info.min), float(info.max)).to(dtype)


def _cot(x):
    return 1.0 / torch.tan(x)


def _sec(x):
    return 1.0 / torch.cos(x)


def _csc(x):
    return 1.0 / torch.sin(x)


def _cbrt(x):
    return torch.copysign(torch.abs(x).pow(1.0 / 3.0), x)


@dataclass(frozen=True, eq=False)
class UnaryMath(Expression):
    """A double-valued unary math function, selected by name."""

    child: Expression
    fn: str = "sqrt"

    _FNS: ClassVar[Dict[str, Callable]] = {
        "sqrt": torch.sqrt, "exp": torch.exp, "expm1": torch.expm1,
        "sin": torch.sin, "cos": torch.cos, "tan": torch.tan,
        "asin": torch.asin, "acos": torch.acos, "atan": torch.atan,
        "sinh": torch.sinh, "cosh": torch.cosh, "tanh": torch.tanh,
        "asinh": torch.asinh, "acosh": torch.acosh, "atanh": torch.atanh,
        "cbrt": _cbrt, "rint": torch.round,
        "degrees": torch.rad2deg, "radians": torch.deg2rad,
        "cot": _cot, "sec": _sec, "csc": _csc,
    }
    #: functions whose input at or below the domain's edge is NULL (Spark)
    _NULL_ON_NONPOS: ClassVar[Dict[str, Callable]] = {
        "log": torch.log, "log10": torch.log10, "log2": torch.log2,
        "log1p": torch.log1p,
    }

    @property
    def children(self):
        return (self.child,)

    def with_children(self, c):
        return UnaryMath(c[0], self.fn)

    @property
    def dtype(self):
        return T.FLOAT64

    def eval(self, batch, ctx=EvalContext()):
        c = self.child.eval(batch, ctx)
        x = c.data.to(_F64)
        if self.fn in self._NULL_ON_NONPOS:
            lim = -1.0 if self.fn == "log1p" else 0.0
            ok = x > lim
            y = self._NULL_ON_NONPOS[self.fn](
                torch.where(ok, x, torch.ones_like(x)))
            return numeric_column(y, c.validity & ok, T.FLOAT64)
        return numeric_column(self._FNS[self.fn](x), c.validity, T.FLOAT64)

    def __repr__(self):
        return f"{self.fn}({self.child!r})"


@dataclass(frozen=True, eq=False)
class _Binary(Expression):
    """Two numeric operands as double, the result double, null where
    either is."""

    left: Expression
    right: Expression

    @property
    def children(self):
        return (self.left, self.right)

    def with_children(self, c):
        return type(self)(c[0], c[1])

    @property
    def dtype(self):
        return T.FLOAT64

    def _op(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def eval(self, batch, ctx=EvalContext()):
        l = self.left.eval(batch, ctx)
        r = self.right.eval(batch, ctx)
        y = self._op(l.data.to(_F64), r.data.to(_F64))
        return numeric_column(y, and_validity([l, r]), T.FLOAT64)


@dataclass(frozen=True, eq=False)
class Pow(_Binary):
    def _op(self, a, b):
        return torch.pow(a, b)


@dataclass(frozen=True, eq=False)
class Atan2(_Binary):
    def _op(self, a, b):
        return torch.atan2(a, b)


@dataclass(frozen=True, eq=False)
class Hypot(_Binary):
    """hypot(a, b) = sqrt(a^2 + b^2) without overflow in between
    (reference: GpuHypot)."""

    def _op(self, a, b):
        return torch.hypot(a, b)


@dataclass(frozen=True, eq=False)
class FloorCeil(Expression):
    child: Expression
    is_ceil: bool = False

    @property
    def children(self):
        return (self.child,)

    def with_children(self, c):
        return FloorCeil(c[0], self.is_ceil)

    @property
    def dtype(self):
        d = self.child.dtype
        return d if d.is_integral else T.INT64

    def eval(self, batch, ctx=EvalContext()):
        c = self.child.eval(batch, ctx)
        if self.child.dtype.is_integral:
            return c
        f = torch.ceil if self.is_ceil else torch.floor
        y = f(c.data.to(_F64))
        valid = c.validity & torch.isfinite(c.data)
        return numeric_column(float_to_int(y, torch.int64), valid, T.INT64)

    def __repr__(self):
        return f"{'ceil' if self.is_ceil else 'floor'}({self.child!r})"


@dataclass(frozen=True, eq=False)
class Round(Expression):
    """round(x, scale): HALF_UP; bround: HALF_EVEN (reference: GpuRound,
    GpuBRound)."""

    child: Expression
    scale: int = 0
    half_even: bool = False

    @property
    def children(self):
        return (self.child,)

    def with_children(self, c):
        return Round(c[0], self.scale, self.half_even)

    @property
    def dtype(self):
        d = self.child.dtype
        if d.kind is TypeKind.DECIMAL:
            return T.decimal(d.precision, min(d.scale, max(self.scale, 0)))
        return d

    def eval(self, batch, ctx=EvalContext()):
        c = self.child.eval(batch, ctx)
        d = self.child.dtype
        if d.is_integral and self.scale >= 0:
            return c
        x = c.data.to(_F64)
        p = 10.0 ** self.scale
        if self.half_even:
            y = torch.round(x * p) / p
        else:
            y = _sign(x) * torch.floor(torch.abs(x) * p + 0.5) / p
        if d.is_integral:
            return numeric_column(float_to_int(y, d.storage_dtype),
                                  c.validity, d)
        # a decimal keeps its storage and its column type, as in the JAX
        # package
        if not c.data.dtype.is_floating_point:
            return numeric_column(float_to_int(y, c.data.dtype), c.validity,
                                  d)
        return numeric_column(y.to(c.data.dtype), c.validity, d)


@dataclass(frozen=True, eq=False)
class Signum(Expression):
    child: Expression

    @property
    def children(self):
        return (self.child,)

    def with_children(self, c):
        return Signum(c[0])

    @property
    def dtype(self):
        return T.FLOAT64

    def eval(self, batch, ctx=EvalContext()):
        c = self.child.eval(batch, ctx)
        return numeric_column(_sign(c.data.to(_F64)), c.validity, T.FLOAT64)


@dataclass(frozen=True, eq=False)
class Logarithm(Expression):
    """log(base, x) = ln(x) / ln(base); NULL for a non-positive x or base
    (reference: GpuLogarithm). A base of 1 follows IEEE through the
    division (an infinity), as the JVM does."""

    base: Expression
    child: Expression

    @property
    def children(self):
        return (self.base, self.child)

    def with_children(self, c):
        return Logarithm(c[0], c[1])

    @property
    def dtype(self):
        return T.FLOAT64

    def eval(self, batch, ctx=EvalContext()):
        b = self.base.eval(batch, ctx)
        x = self.child.eval(batch, ctx)
        bd = b.data.to(_F64)
        xd = x.data.to(_F64)
        ok = (bd > 0.0) & (xd > 0.0)
        y = torch.log(torch.where(ok, xd, torch.ones_like(xd))) / \
            torch.log(torch.where(bd > 0.0, bd, torch.full_like(bd, 2.0)))
        return numeric_column(y, and_validity([b, x]) & ok, T.FLOAT64)


@dataclass(frozen=True, eq=False)
class NaNvl(Expression):
    """nanvl(a, b): b where a is NaN, else a (reference: GpuNaNvl); a null
    ``a`` stays null."""

    left: Expression
    right: Expression

    @property
    def children(self):
        return (self.left, self.right)

    def with_children(self, c):
        return NaNvl(c[0], c[1])

    @property
    def dtype(self):
        return T.FLOAT64 if self.left.dtype.kind is not TypeKind.FLOAT32 \
            or self.right.dtype.kind is not TypeKind.FLOAT32 else T.FLOAT32

    def eval(self, batch, ctx=EvalContext()):
        l = self.left.eval(batch, ctx)
        r = self.right.eval(batch, ctx)
        st = self.dtype.storage_dtype
        ld = l.data.to(st)
        rd = r.data.to(st)
        nan = torch.isnan(ld)
        data = torch.where(nan, rd, ld)
        validity = torch.where(nan & l.validity, r.validity, l.validity)
        return numeric_column(data, validity, self.dtype)


# ---------------------------------------------------------------------------
# Rand: jax.random's threefry2x32 and uniform(float64) in torch
# ---------------------------------------------------------------------------

_MASK32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_KS_PARITY = 0x1BD11BDA


def _rotl(v, r: int):
    return ((v << r) | (v >> (32 - r))) & _MASK32


def threefry2x32(k0: int, k1: int, x0, x1) -> Tuple:
    """Threefry-2x32 with 20 rounds (Salmon et al. 2011; ``jax.random``'s
    ``threefry2x32_p``) on 32-bit words held in ints or int64 tensors;
    returns the two output words."""
    ks = (k0, k1, k0 ^ k1 ^ _KS_PARITY)
    x0 = (x0 + ks[0]) & _MASK32
    x1 = (x1 + ks[1]) & _MASK32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _MASK32
    return x0, x1


def rand_key(seed: int, batch_seed) -> Tuple[int, int]:
    """``jax.random.key(seed & 0x7FFFFFFF)``, folded in with the batch seed
    where there is one (``jax.random.fold_in``): host ints."""
    key = (0, seed & 0x7FFFFFFF)
    if batch_seed is not None:
        key = threefry2x32(key[0], key[1], 0, int(batch_seed) & _MASK32)
    return key


def uniform_doubles(key: Tuple[int, int], n: int,
                    device) -> torch.Tensor:
    """``jax.random.uniform(key, (n,), float64)`` with
    ``jax_threefry_partitionable``: row i's 64 bits are threefry of the
    counter (0, i); their top 52 bits are the mantissa of a double in [1,
    2), less 1."""
    i = torch.arange(n, dtype=torch.int64, device=device)
    hi, lo = threefry2x32(key[0], key[1], torch.zeros_like(i), i)
    mantissa = (hi << 20) | (lo >> 12)
    one = 0x3FF0000000000000
    return (mantissa | one).view(_F64) - 1.0


@dataclass(frozen=True, eq=False)
class Rand(Expression):
    """rand(seed): uniform doubles in [0, 1), one per row position of each
    batch, a function of (seed, batch seed, position): a re-execution or an
    overflow retry draws the same values. The JAX package's rule is
    ``incompat`` (not Spark's XorShiftRandom sequence)."""

    seed: int = 0

    @property
    def children(self):
        return ()

    def with_children(self, c):
        return self

    @property
    def dtype(self):
        return T.FLOAT64

    @property
    def nullable(self):
        return False

    def eval(self, batch, ctx=EvalContext()):
        cap = batch.capacity
        u = uniform_doubles(rand_key(self.seed, ctx.batch_seed), cap,
                            batch.device)
        return numeric_column(u, torch.ones(cap, dtype=torch.bool,
                                            device=batch.device), T.FLOAT64)


@dataclass(frozen=True, eq=False)
class RaiseError(Expression):
    """raise_error(msg): the query fails when any live row evaluates it
    (reference: GpuRaiseError). The rows ride the error channel and the
    operator raises at its materialization point, so a fused stage stays
    free of host reads."""

    child: Expression

    @property
    def children(self):
        return (self.child,)

    def with_children(self, c):
        return RaiseError(c[0])

    @property
    def dtype(self):
        return T.NULL

    def eval(self, batch, ctx=EvalContext()):
        c = self.child.eval(batch, ctx)
        ctx.report(batch.row_mask() & c.validity, kind="USER_RAISED_ERROR",
                   always=True)
        cap, dev = batch.capacity, batch.device
        return DeviceColumn(torch.zeros(cap, dtype=torch.int8, device=dev),
                            torch.zeros(cap, dtype=torch.bool, device=dev),
                            T.NULL)
