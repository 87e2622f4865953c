"""Cast with Spark's non-ANSI semantics, the whole device matrix.

Port of ``spark_rapids_tpu/expressions/cast.py`` (reference: GpuCast.scala):

- an integral value to a narrower integral type wraps in two's complement
  (Java's ``(int) long``);
- float or double to an integral type truncates toward zero, saturates at
  the type's range and maps NaN to 0 (``math.float_to_int``: torch's own
  conversion of NaN, an infinity or a value out of range is undefined on
  CUDA and differs from the CPU's);
- numeric to boolean is ``x != 0``, boolean to numeric 1 or 0;
- timestamp (us) to date (days) floors, so a time before the epoch lands on
  the day before; a long to a timestamp counts seconds;
- string to an integral type parses ``[+-]digits[.digits]`` with the
  surrounding whitespace trimmed (out of range or malformed: null), string
  to date ``yyyy[-M[-d]]``; an integral type to a string of at least 20
  bytes, a date to one of at least 10.

``cast_supported`` names the pairs the device runs; any other pair (string
to double, double to string, ...) gets the JAX package's reason from
``device_unsupported_reason``, and tagging runs the cast on the row
interpreter. A string to float or double parse has a device kernel
(``string_to_double``) that the JAX package lacks; tagging runs it only
under the port's ``spark.rapids.tpu.sql.castStringToFloat.enabled`` (off by
default, as the reference's key of that name), since past 18 significant
digits or a decimal exponent beyond 22 it can be an ulp off. Under ANSI a
string that does not parse reports ``CAST_INVALID_INPUT`` on the error
channel.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from .. import types as T
from ..types import SqlType, TypeKind
from .base import EvalContext, Expression, numeric_column
from .math import float_to_int
from .strings import _first_true, _string_column, _table

_INT_RANGE = {
    TypeKind.INT8: (-(2**7), 2**7 - 1),
    TypeKind.INT16: (-(2**15), 2**15 - 1),
    TypeKind.INT32: (-(2**31), 2**31 - 1),
    TypeKind.INT64: (-(2**63), 2**63 - 1),
}

MICROS_PER_DAY = 86400_000_000

_I32, _I64, _F64 = torch.int32, torch.int64, torch.float64


def cast_supported(src: SqlType, dst: SqlType) -> bool:
    ok = {TypeKind.BOOLEAN, TypeKind.INT8, TypeKind.INT16, TypeKind.INT32,
          TypeKind.INT64, TypeKind.FLOAT32, TypeKind.FLOAT64,
          TypeKind.DATE, TypeKind.TIMESTAMP, TypeKind.DECIMAL}
    if src.kind in ok and dst.kind in ok:
        return True
    integral = {TypeKind.INT8, TypeKind.INT16, TypeKind.INT32,
                TypeKind.INT64}
    if src.kind is TypeKind.STRING:
        # the device parses integrals and dates (a float parse needs a
        # correctly rounded strtod: the CPU)
        return dst.kind in integral or dst.kind is TypeKind.DATE
    if dst.kind is TypeKind.STRING:
        return (src.kind in integral and dst.max_len >= 20) or \
            (src.kind is TypeKind.DATE and dst.max_len >= 10)
    return False


@dataclass(frozen=True, eq=False)
class Cast(Expression):
    child: Expression
    to: SqlType

    @property
    def children(self):
        return (self.child,)

    def with_children(self, c):
        return Cast(c[0], self.to)

    @property
    def dtype(self):
        return self.to

    @property
    def nullable(self):
        # a fallible conversion nulls the rows it cannot convert (non-ANSI);
        # declared statically, as the JAX package does
        return True

    @property
    def parses_float(self) -> bool:
        """A string to float or double parse: a device kernel that the
        planner runs only under
        ``spark.rapids.tpu.sql.castStringToFloat.enabled``
        (``string_to_double``)."""
        return self.child.resolved and \
            self.child.dtype.kind is TypeKind.STRING and self.to.is_fractional

    def device_unsupported_reason(self):
        if not self.child.resolved:
            return None
        if not cast_supported(self.child.dtype, self.to):
            return (f"cast {self.child.dtype} → {self.to} has no device "
                    f"kernel")
        return None

    def eval(self, batch, ctx=EvalContext()):
        c = self.child.eval(batch, ctx)
        src, dst = self.child.dtype, self.to
        if src.kind == dst.kind and src.kind is not TypeKind.DECIMAL:
            return c
        if src.kind is TypeKind.STRING:
            if dst.is_fractional:
                v, ok = string_to_double(c.data, c.lengths, c.validity)
                if ctx.ansi:
                    ctx.report(c.validity & ~ok, "CAST_INVALID_INPUT")
                return numeric_column(v.to(dst.storage_dtype), ok, dst)
            if dst.kind is TypeKind.DATE:
                days, ok = string_to_date(c.data, c.lengths, c.validity)
                if ctx.ansi:
                    ctx.report(c.validity & ~ok, "CAST_INVALID_INPUT")
                return numeric_column(days, ok, dst)
            v, ok = string_to_long(c.data, c.lengths, c.validity)
            if dst.kind is not TypeKind.INT64:
                # Spark nulls an out-of-range string cast
                # (UTF8String.toInt); it never wraps
                lo, hi = _INT_RANGE[dst.kind]
                ok = ok & (v >= lo) & (v <= hi)
            if ctx.ansi:
                ctx.report(c.validity & ~ok, "CAST_INVALID_INPUT")
            v = torch.where(ok, v, torch.zeros_like(v))
            return numeric_column(v.to(dst.storage_dtype), ok, dst)
        if dst.kind is TypeKind.STRING:
            if src.kind is TypeKind.DATE:
                mat, lengths = date_to_string(c.data, c.validity)
            else:
                mat, lengths = long_to_string(c.data.to(_I64), c.validity)
            ml = dst.max_len
            if mat.shape[1] < ml:
                mat = F.pad(mat, (0, ml - mat.shape[1]))
            return _string_column(mat, lengths, c.validity, ml)
        data, validity = _cast_data(c.data, c.validity, src, dst)
        if dst.kind is TypeKind.DECIMAL and ctx.ansi:
            # Spark raises for a value past the target's precision
            ctx.report(c.validity & ~validity, "NUMERIC_VALUE_OUT_OF_RANGE")
        return numeric_column(data, validity, dst)

    def __repr__(self):
        return f"cast({self.child!r} as {self.to})"


def _cast_data(x, validity, src: SqlType, dst: SqlType):
    sk, dk = src.kind, dst.kind

    # a decimal source: its unscaled value to float or to another scale
    if sk is TypeKind.DECIMAL:
        if dk is TypeKind.DECIMAL:
            shift = dst.scale - src.scale
            if shift >= 0:
                return _scale_up(x, validity, shift, dst.precision)
            y = _div_half_up(x, 10 ** (-shift))
            return y, validity & _fits(y, dst.precision)
        as_f = x.to(_F64) / (10.0 ** src.scale)
        return _cast_data(as_f, validity, T.FLOAT64, dst)

    if dk is TypeKind.DECIMAL:
        if src.is_fractional:
            # half to even, as jnp.round
            y = torch.round(x.to(_F64) * (10.0 ** dst.scale))
            ok = torch.isfinite(y) & (y.abs() < 10.0 ** dst.precision)
            y = torch.where(ok, y, torch.zeros_like(y))
            return float_to_int(y, _I64), validity & ok
        return _scale_up(x.to(_I64), validity, dst.scale, dst.precision)

    if dk is TypeKind.BOOLEAN:
        return x != 0, validity
    if sk is TypeKind.BOOLEAN:
        return x.to(dst.storage_dtype), validity

    if sk is TypeKind.TIMESTAMP and dk is TypeKind.DATE:
        return torch.div(x, MICROS_PER_DAY, rounding_mode="floor").to(_I32), \
            validity
    if sk is TypeKind.DATE and dk is TypeKind.TIMESTAMP:
        return x.to(_I64) * MICROS_PER_DAY, validity
    if dk in (TypeKind.DATE, TypeKind.TIMESTAMP) or \
            sk in (TypeKind.DATE, TypeKind.TIMESTAMP):
        # numeric <-> temporal: Spark reads a timestamp as seconds here
        if sk is TypeKind.TIMESTAMP:
            return _cast_data(torch.div(x, 1000_000, rounding_mode="floor"),
                              validity, T.INT64, dst)
        if dk is TypeKind.TIMESTAMP:
            return _convert(x, _I64) * 1000_000, validity
    if src.is_fractional and dk is TypeKind.INT64:
        # the JAX package clips below 2^63 (at 2^63 - 2^33) before it
        # converts, and saturates at 2^63 and above
        xf = x.to(_F64)
        x = torch.where(xf >= 2.0 ** 63, xf,
                        xf.clamp(max=2.0 ** 63 - 2.0 ** 33))
    return _convert(x, dst.storage_dtype), validity


def _convert(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x`` as ``dtype``, as XLA converts: a float to an integral type
    through the saturating ``float_to_int``, an integer narrowed with a
    two's-complement wrap, anything else by ``Tensor.to``."""
    if x.dtype.is_floating_point and not dtype.is_floating_point:
        return float_to_int(x, dtype)
    return x.to(dtype)


def _fits(y: torch.Tensor, precision: int) -> torch.Tensor:
    """|y| has at most ``precision`` digits (``precision`` <= 18, so
    ``10 ** precision`` is an int64)."""
    return (y > -(10 ** precision)) & (y < 10 ** precision)


def _scale_up(x: torch.Tensor, validity: torch.Tensor, shift: int,
              precision: int):
    """``x * 10 ** shift`` as a DECIMAL of ``precision`` digits: a row
    whose product would pass int64 or whose value has more than
    ``precision`` digits is null (Spark's ``changePrecision``)."""
    limit = (2 ** 63 - 1) // 10 ** shift
    ok = (x >= -limit) & (x <= limit)
    y = torch.where(ok, x, torch.zeros_like(x)) * (10 ** shift)
    return y, validity & ok & _fits(y, precision)


def _div_half_up(x: torch.Tensor, divisor: int) -> torch.Tensor:
    mag = torch.abs(x)
    q = torch.div(mag, divisor, rounding_mode="floor")
    r = mag - q * divisor
    q = q + (2 * r >= divisor).to(x.dtype)
    return torch.sign(x) * q


# ---------------------------------------------------------------------------
# String casts (reference: GpuCast.scala castStringToInt, castStringToDate,
# castToString): the padded byte matrix makes both directions rectangular
# ---------------------------------------------------------------------------

_MAX_INT_DIGITS = 19
_P10_I64 = np.asarray([10 ** i for i in range(_MAX_INT_DIGITS)], np.int64)


def _argmax_first(m: torch.Tensor) -> torch.Tensor:
    return _first_true(m).to(_I32)


def _trim_bounds(data, lengths):
    """(first, last, any_content, is_space, b, pos, in_str) for whitespace
    trimming over byte rows (UTF8String.trimAll's whitespace set)."""
    n, ml = data.shape
    pos = torch.arange(ml, dtype=_I32, device=data.device)[None, :]
    in_str = pos < lengths[:, None]
    b = torch.where(in_str, data, torch.zeros((), dtype=data.dtype,
                                              device=data.device))
    is_space = (b == 32) | ((b >= 9) & (b <= 13))    # \t \n \v \f \r
    content = in_str & ~is_space
    any_content = content.any(dim=1)
    first = _argmax_first(content)
    last = ml - 1 - _argmax_first(content.flip(1))
    return first, last, any_content, is_space, b, pos, in_str


def _byte_at(b, idx):
    return b.gather(1, idx.clamp(0, b.shape[1] - 1).to(_I64)[:, None])[:, 0]


def string_to_long(data, lengths, validity):
    """Parse ``[+-]?digits(.digits)?`` from byte rows (Spark's non-ANSI
    string to integral cast: whitespace around trimmed, the fraction
    truncated, anything else null). Returns (int64 values, ok)."""
    first, last, any_content, is_space, b, pos, in_str = \
        _trim_bounds(data, lengths)
    interior = (pos >= first[:, None]) & (pos <= last[:, None])
    ok = any_content & ~(interior & is_space).any(dim=1)
    first_b = _byte_at(b, first)
    has_sign = (first_b == ord("+")) | (first_b == ord("-"))
    neg = first_b == ord("-")
    digits_start = first + has_sign.to(_I32)
    # one optional '.': the digits after it are checked, then dropped
    is_dot = interior & (b == ord("."))
    n_dots = is_dot.sum(dim=1, dtype=_I32)
    dot_pos = torch.where(n_dots > 0, _argmax_first(is_dot), last + 1)
    int_end = torch.minimum(dot_pos - 1, last)       # last integer digit
    is_digit = (b >= ord("0")) & (b <= ord("9"))
    span = (pos >= digits_start[:, None]) & (pos <= last[:, None])
    has_frac_digits = (n_dots == 1) & (dot_pos < last)
    ok = ok & (n_dots <= 1) & ~(span & ~is_digit & ~is_dot).any(dim=1) & \
        ((int_end >= digits_start) | has_frac_digits)    # '.5' -> 0
    # at most 19 significant integer digits (leading zeros do not count)
    in_int_span = (pos >= digits_start[:, None]) & (pos <= int_end[:, None])
    nonzero = in_int_span & (b != ord("0"))
    any_nz = nonzero.any(dim=1)
    first_nz = _argmax_first(nonzero)
    n_digits = torch.where(any_nz, int_end - first_nz + 1,
                           torch.zeros_like(int_end))
    ok = ok & (n_digits <= _MAX_INT_DIGITS)
    exp = int_end[:, None] - pos
    in_int = span & (pos <= int_end[:, None]) & (exp < _MAX_INT_DIGITS)
    weight = _table(_P10_I64, data.device)[
        exp.clamp(0, _MAX_INT_DIGITS - 1).to(_I64)]
    dig = (b.to(_I64) - ord("0"))
    v = torch.where(in_int, dig * weight, torch.zeros_like(weight)).sum(dim=1)
    # a 19-digit magnitude can pass int64: the sum wraps negative exactly
    # then (every 19-digit value is below 2^64). Spark nulls it;
    # '-9223372036854775808' wraps onto itself and is valid
    i64_min = torch.iinfo(_I64).min
    ok = ok & ((v >= 0) | (neg & (v == i64_min)))
    v = torch.where(neg, -v, v)
    return v, ok & validity


#: significant digits a double parse keeps exactly (10^18 < 2^63)
_MAX_FLOAT_DIGITS = 18
#: exponent digits read (a longer exponent clamps: inf or 0)
_MAX_EXP_DIGITS = 5
_P10_F64 = np.asarray([10.0 ** i for i in range(23)], np.float64)


def _split(a: torch.Tensor):
    """Dekker's split of a double into two halves of 26 bits."""
    c = 134217729.0 * a
    hi = c - (c - a)
    return hi, a - hi


def _two_prod(a: torch.Tensor, b: torch.Tensor):
    """(a * b rounded, its exact error): the product as a double-double."""
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    return p, ((ah * bh - p) + ah * bl + al * bh) + al * bl


def _scaled_by_ten(m: torch.Tensor, q: torch.Tensor, device
                   ) -> torch.Tensor:
    """m * 10^q as a double, for an int64 m. For |q| <= 22 (10^|q| an
    exact double) in double-double arithmetic: m is split exactly into
    two doubles, the product or the quotient carries its error term, and
    one final rounding gives the nearest double unless the exact value
    lies within about 2^-100 (relative) of a tie. Past that, one product
    or quotient by a power of ten."""
    mh = m.to(_F64)
    ml = (m - mh.to(_I64)).to(_F64)         # m == mh + ml exactly
    p10 = _table(_P10_F64, device)
    pw = p10[q.abs().clamp(0, 22)]
    # m * 10^q
    p, e = _two_prod(mh, pw)
    up = p + (e + ml * pw)
    # m / 10^-q: the quotient, then the remainder's share
    hi = mh / pw
    hp, he = _two_prod(hi, pw)
    down = hi + (((mh - hp) - he) + ml) / pw
    ten = torch.full_like(mh, 10.0)
    far = torch.where(q >= 0, mh * torch.pow(ten, q.to(_F64)),
                      mh / torch.pow(ten, (-q).to(_F64)))
    return torch.where(q.abs() > 22, far, torch.where(q >= 0, up, down))


def _word_at(b, start, last, word: bytes) -> torch.Tensor:
    """Whether b[start:last + 1] is ``word``, ignoring ASCII case."""
    ok = (last - start + 1) == len(word)
    for i, ch in enumerate(word):
        ok = ok & ((_byte_at(b, start + i) | 0x20) == ch)
    return ok


def string_to_double(data, lengths, validity):
    """Parse ``[+-]?(digits[.digits]|.digits)([eE][+-]?digits)?`` and
    ``[+-]?(nan|inf|infinity)`` (any case; blanks around trimmed) from byte
    rows to float64; anything else is null. The significand's first 18
    digits make an exact int64 m, the rest and the exponent a decimal
    exponent q; for |q| <= 22 m * 10^q is rounded once from double-double
    arithmetic (``_scaled_by_ten``), which gives the nearest double, as
    Python's ``float`` does, but within about 2^-100 of a tie. Past 18
    digits or |q| > 22 the value can be an ulp or more off: hence the
    cast's own switch, as the reference's
    ``spark.rapids.sql.castStringToFloat.enabled``. Returns (values,
    ok)."""
    first, last, any_content, is_space, b, pos, in_str = \
        _trim_bounds(data, lengths)
    interior = (pos >= first[:, None]) & (pos <= last[:, None])
    ok = any_content & ~(interior & is_space).any(dim=1)
    first_b = _byte_at(b, first)
    has_sign = (first_b == ord("+")) | (first_b == ord("-"))
    neg = first_b == ord("-")
    start = first + has_sign.to(_I32)
    body = (pos >= start[:, None]) & (pos <= last[:, None])
    is_digit = (b >= ord("0")) & (b <= ord("9"))
    is_e = body & ((b == ord("e")) | (b == ord("E")))
    n_e = is_e.sum(dim=1, dtype=_I32)
    e_pos = torch.where(n_e > 0, _argmax_first(is_e), last + 1)
    mant = body & (pos < e_pos[:, None])
    expo = body & (pos > e_pos[:, None])
    is_dot = mant & (b == ord("."))
    n_dots = is_dot.sum(dim=1, dtype=_I32)
    dot = torch.where(n_dots > 0, _argmax_first(is_dot), e_pos)
    mdig = mant & is_digit
    # the exponent: an optional sign, then at least one digit
    e_first = e_pos + 1
    e_first_b = _byte_at(b, e_first)
    e_sign = (e_first_b == ord("+")) | (e_first_b == ord("-"))
    e_digits = expo & (pos >= (e_first + e_sign.to(_I32))[:, None])
    num_ok = (n_e <= 1) & (n_dots <= 1) & mdig.any(dim=1) \
        & ~(mant & ~is_digit & ~is_dot).any(dim=1) \
        & ((n_e == 0) | (e_digits.any(dim=1)
                         & ~(e_digits & ~is_digit).any(dim=1)))
    # the exponent's value from its last _MAX_EXP_DIGITS digits, clamped
    # where it has more
    e_rank = last[:, None] - pos
    e_w = _table(_P10_I64, data.device)[
        e_rank.clamp(0, _MAX_EXP_DIGITS - 1).to(_I64)]
    dig = b.to(_I64) - ord("0")
    e_in = e_digits & (e_rank < _MAX_EXP_DIGITS)
    ev = torch.where(e_in, dig * e_w, 0).sum(dim=1)
    e_first_nz = _argmax_first(e_digits & (b != ord("0")))
    e_long = (e_digits & (b != ord("0"))).any(dim=1) \
        & (last - e_first_nz + 1 > _MAX_EXP_DIGITS)
    ev = torch.where(e_long, 10 ** _MAX_EXP_DIGITS, ev)
    ev = torch.where(e_first_b == ord("-"), -ev, ev)
    # the significand: its first _MAX_FLOAT_DIGITS digits from the first
    # non-zero one, as an int64, and the place of the last kept digit
    sig = mdig & (pos >= _argmax_first(mdig & (b != ord("0")))[:, None]) \
        & (mdig & (b != ord("0"))).any(dim=1)[:, None]
    rank = sig.to(_I32).cumsum(dim=1, dtype=_I32)
    n_sig = rank[:, -1]
    kept = sig & (rank <= _MAX_FLOAT_DIGITS)
    n_kept = torch.clamp(n_sig, max=_MAX_FLOAT_DIGITS)
    w = _table(_P10_I64, data.device)[
        (n_kept[:, None] - rank).clamp(0, _MAX_INT_DIGITS - 1).to(_I64)]
    m = torch.where(kept, dig * w, 0).sum(dim=1)
    last_kept = torch.where(kept, pos, -1).amax(dim=1)
    place = torch.where(last_kept < dot, dot - last_kept - 1,
                        dot - last_kept).to(_I64)
    q = (place + ev).clamp(-400, 400)
    v = _scaled_by_ten(m, q, data.device)
    nan = _word_at(b, start, last, b"nan")
    inf = _word_at(b, start, last, b"inf") | \
        _word_at(b, start, last, b"infinity")
    v = torch.where(nan, float("nan"), torch.where(inf, float("inf"), v))
    v = torch.where(neg, -v, v)
    ok = ok & (num_ok | nan | inf) & validity
    return torch.where(ok, v, torch.zeros_like(v)), ok


def long_to_string(x, validity, max_len: int = 20):
    """int64 -> decimal digits and sign as padded byte rows and lengths.
    The digits come from the value's non-positive magnitude, which holds
    INT64_MIN, by truncating division: each output byte is a formula of
    its column, with no scatter."""
    neg = x < 0
    nm = torch.where(neg, x, -x)                 # -|x|, never overflows
    p10 = _table(_P10_I64, x.device)
    n_digits = (nm[:, None] <= -p10[None, :]).sum(dim=1, dtype=_I32)
    n_digits = n_digits.clamp(min=1)
    total = n_digits + neg.to(_I32)
    j = torch.arange(max_len, dtype=_I32, device=x.device)[None, :]
    pfr = total[:, None] - 1 - j                 # the digit's power
    w = p10[pfr.clamp(0, _MAX_INT_DIGITS - 1).to(_I64)]
    q = torch.div(nm[:, None], w, rounding_mode="trunc")
    dig = (-torch.fmod(q, 10)).to(torch.uint8) + ord("0")
    in_digits = (j >= neg.to(_I32)[:, None]) & (pfr >= 0)
    zero = torch.zeros((), dtype=torch.uint8, device=x.device)
    out = torch.where(in_digits, dig, zero)
    minus = torch.full((), ord("-"), dtype=torch.uint8, device=x.device)
    out = torch.where((j == 0) & neg[:, None], minus, out)
    return out, torch.where(validity, total, torch.zeros_like(total))


def string_to_date(data, lengths, validity):
    """Parse ``yyyy[-M[-d]]`` (Spark's string to date subset; anything
    after it: null). Returns (epoch days int32, ok)."""
    from .datetime import civil_from_days, days_from_civil
    first, last, any_content, is_space, b, pos, in_str = \
        _trim_bounds(data, lengths)
    in_str = in_str & (pos >= first[:, None]) & (pos <= last[:, None])
    b = torch.where(in_str, b, torch.zeros_like(b))
    start = first
    end = last + 1                              # exclusive
    is_digit = (b >= ord("0")) & (b <= ord("9"))
    is_dash = in_str & (b == ord("-")) & (pos > start[:, None])
    ok = validity & any_content
    dash_count = is_dash.sum(dim=1, dtype=_I32)
    d1 = torch.where(dash_count >= 1, _argmax_first(is_dash), end)
    after1 = is_dash & (pos > d1[:, None])
    d2 = torch.where(dash_count >= 2, _argmax_first(after1), end)
    p10 = _table(np.asarray([1, 10, 100, 1000, 10000], np.int32),
                 data.device)

    def field(lo, hi):          # the digits in [lo, hi)
        inside = (pos >= lo[:, None]) & (pos < hi[:, None])
        exp = hi[:, None] - 1 - pos
        w = p10[exp.clamp(0, 4).to(_I64)]
        v = torch.where(inside & (exp < 5), (b.to(_I32) - ord("0")) * w,
                        torch.zeros_like(w)).sum(dim=1, dtype=_I32)
        return v, hi - lo

    # every byte a digit but the (at most 2) separating dashes
    sep = (pos == d1[:, None]) | (pos == d2[:, None])
    ok = ok & ~(in_str & ~is_digit & ~sep).any(dim=1)
    y, yw = field(start, d1)
    m, mw = field(d1 + 1, d2)
    d, dw = field(d2 + 1, end)
    m = torch.where(dash_count >= 1, m, torch.ones_like(m))
    d = torch.where(dash_count >= 2, d, torch.ones_like(d))
    true = torch.ones_like(ok)
    # year 1 on only: Python's datetime.date has no year 0
    ok = ok & (dash_count <= 2) & (yw == 4) & (y >= 1) & \
        torch.where(dash_count >= 1, (mw >= 1) & (mw <= 2), true) & \
        torch.where(dash_count >= 2, (dw >= 1) & (dw <= 2), true) & \
        (m >= 1) & (m <= 12) & (d >= 1) & (d <= 31)
    days = days_from_civil(y, m, d)
    # the round trip rejects impossible dates (Feb 31 -> Mar 3)
    y2, m2, dd2 = civil_from_days(days.to(_I64))
    ok = ok & (y2 == y) & (m2 == m) & (dd2 == d)
    return torch.where(ok, days, torch.zeros_like(days)), ok


def date_to_string(days, validity):
    """Epoch days -> 'yyyy-MM-dd' byte rows (10 bytes)."""
    from .datetime import civil_from_days
    y, m, d = civil_from_days(days.to(_I64))

    def digit(v, p):
        return torch.remainder(torch.div(v, p, rounding_mode="floor"), 10)
    dash = torch.full_like(y, ord("-") - ord("0"))
    cols = [digit(y, 1000), digit(y, 100), digit(y, 10), digit(y, 1), dash,
            digit(m, 10), digit(m, 1), dash, digit(d, 10), digit(d, 1)]
    out = (torch.stack(cols, dim=1) + ord("0")).to(torch.uint8)
    ten = torch.full_like(y, 10)
    return out, torch.where(validity, ten, torch.zeros_like(ten))
