"""Row-wise CPU interpreter for logical plans.

Port of ``spark_rapids_tpu/plan/interpreter.py``, for the expressions and
operators the port has. It has two jobs, as CPU Spark has around the
reference plugin:

1. Fallback executor: a subtree that tagging refuses runs here, in a
   ``CpuFallbackExec`` island (``plan/overrides.py``).
2. Differential oracle: ``Session({"spark.rapids.tpu.sql.enabled":
   False})`` interprets the whole query here, and the tests hold the device
   Session against it.

It is independent of the device code on purpose: plain Python ints, floats
and ``decimal.Decimal`` with explicit two's-complement wrapping, row loops,
dict group-bys and a dict-keyed hash join. Slow and plainly correct.

``RowEvaluator`` dispatches on ``_eval_<ExpressionClass>``. A class without
a handler raises ``NotImplementedError`` naming ROADMAP item 7, which brings
the rest of the expressions with their device side (windows, generators,
collect_list/collect_set and pivot among them).

The interpreter agrees with the port's device path, row for row. Where the
JAX interpreter departs from it, this one follows the port (and Spark
where the port does): ``In`` reads its value list (the JAX handler reads
the expression's children, which hold the probe alone, and answers
false); ``Remainder`` and ``Pmod`` on integers are exact (the JAX handler
goes through ``math.fmod``, which rounds int64 operands above 2^53:
``(2**62 + 1) % 7`` is 4 there and 5 in Java); ``Pmod`` by a negative
divisor and ANSI overflow of ``div``, ``-`` and ``abs`` at MIN follow Java;
``isnan(null)`` is null, as both device paths give; a percentile orders
NaN last; ``Murmur3Hash`` hashes the SQL kinds (the JAX handler passes
types its scalar hash does not know, and raises); ``XxHash64`` is a scalar
Python XXH64, where the JAX handler calls its device kernel per value.
``tests/test_torch_interpreter.py`` pins each with both outputs.

Sample draws its rows with numpy from the seed, as the JAX interpreter
does; the device's Bernoulli draw is another sequence, so a sampled query
compares on its shape, not its rows.
"""

from __future__ import annotations

import datetime as _dt
import decimal as _dec
import math
import re
import struct
from typing import Any, Dict, List

import pyarrow as pa

from .. import types as T
from ..batch import Schema
from ..exec.join import JoinType
from ..expressions.base import Alias, Expression
from ..types import TypeKind
from . import logical as L

#: the item that brings every expression and operator without a handler
LATER_ITEM = "ROADMAP item 7"

_INT_BITS = {TypeKind.INT8: 8, TypeKind.INT16: 16, TypeKind.INT32: 32,
             TypeKind.INT64: 64}

_EPOCH = _dt.date(1970, 1, 1)
_EPOCH_TS = _dt.datetime(1970, 1, 1, tzinfo=_dt.timezone.utc)


#: Soundex's digit of each letter (Spark's UTF8String.soundex)
_SOUNDEX_CODES = {ch: code for letters, code in (
    ("BFPV", "1"), ("CGJKQSXZ", "2"), ("DT", "3"), ("L", "4"), ("MN", "5"),
    ("R", "6"), ("HW", "7")) for ch in letters}


def _later(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"CPU interpreter: {what} is not in the port yet ({LATER_ITEM})")


def _wrap(v: int, bits: int) -> int:
    v &= (1 << bits) - 1
    return v - (1 << bits) if v >= (1 << (bits - 1)) else v


def _to_f32(v: float) -> float:
    return struct.unpack("<f", struct.pack("<f", v))[0]


def _java_rem(a: int, b: int) -> int:
    """Java's integer ``a % b``: the sign follows the dividend; exact."""
    r = abs(a) % abs(b)
    return -r if a < 0 else r


def _java_div(a: int, b: int) -> int:
    """Java's integer ``a / b``, toward zero; exact."""
    q = abs(a) // abs(b)
    return -q if (a < 0) != (b < 0) else q


def _fmod(a: float, b: float) -> float:
    """C's ``fmod``, which the device computes: NaN where Python's
    ``math.fmod`` raises (an infinite dividend)."""
    try:
        return math.fmod(a, b)
    except ValueError:
        return math.nan


def _to_long(v) -> int:
    """Spark's non-ANSI cast to bigint (the port's ``_to_long``): a double
    truncates, NaN is 0, and values out of range saturate."""
    if isinstance(v, float):
        if math.isnan(v):
            return 0
        if v >= 2.0 ** 63:
            return (1 << 63) - 1
        if v <= -2.0 ** 63:
            return -(1 << 63)
    return int(v)


class AnsiError(ArithmeticError):
    """A row-level ANSI error (overflow or division by zero); the message
    starts with the error class, as the device's ``ArithmeticException``
    names it."""


def _overflow() -> AnsiError:
    return AnsiError("[ARITHMETIC_OVERFLOW] integer overflow (ANSI mode)")


def _div_zero() -> AnsiError:
    return AnsiError("[DIVIDE_BY_ZERO] division by zero (ANSI mode)")


def ordkey(v):
    """A total order over interpreter values: Spark's, with NaN above every
    double and equal to itself, -0.0 equal to 0.0, strings by their UTF-8
    bytes."""
    if isinstance(v, float) and math.isnan(v):
        return (1, 0.0)
    if isinstance(v, str):
        return (0, v.encode("utf-8"))
    return (0, v)


class _NegKey:
    """Inverts the order of a key (descending sorts)."""

    __slots__ = ("k",)

    def __init__(self, k):
        self.k = k

    def __lt__(self, other):
        return other.k < self.k

    def __eq__(self, other):
        return self.k == other.k


_NULL = object()     # the group and join key of a null value


# ---------------------------------------------------------------------------
# Scalar hashes: Spark's Murmur3_x86_32 and XXH64, over interpreter values
# ---------------------------------------------------------------------------

_M32 = 0xFFFFFFFF
_M64 = (1 << 64) - 1


def _rotl32(x: int, r: int) -> int:
    return ((x << r) | (x >> (32 - r))) & _M32


def _mix_h1(h1: int, k1: int) -> int:
    k1 = (k1 * 0xCC9E2D51) & _M32
    k1 = (_rotl32(k1, 15) * 0x1B873593) & _M32
    h1 = _rotl32(h1 ^ k1, 13)
    return (h1 * 5 + 0xE6546B64) & _M32


def _fmix32(h1: int, length: int) -> int:
    h1 ^= length
    h1 ^= h1 >> 16
    h1 = (h1 * 0x85EBCA6B) & _M32
    h1 ^= h1 >> 13
    h1 = (h1 * 0xC2B2AE35) & _M32
    return h1 ^ (h1 >> 16)


def murmur3_int(v: int, seed: int) -> int:
    return _wrap(_fmix32(_mix_h1(seed & _M32, v & _M32), 4), 32)


def murmur3_long(v: int, seed: int) -> int:
    v &= _M64
    h1 = _mix_h1(_mix_h1(seed & _M32, v & _M32), v >> 32)
    return _wrap(_fmix32(h1, 8), 32)


def murmur3_bytes(data: bytes, seed: int) -> int:
    """hashUnsafeBytes: 4-byte little-endian words, then each tail byte
    mixed as a signed int."""
    h1 = seed & _M32
    n = len(data)
    for i in range(0, n // 4 * 4, 4):
        h1 = _mix_h1(h1, int.from_bytes(data[i:i + 4], "little"))
    for b in data[n // 4 * 4:]:
        h1 = _mix_h1(h1, (b - 256 if b >= 128 else b) & _M32)
    return _wrap(_fmix32(h1, n), 32)


_XP1 = 0x9E3779B185EBCA87
_XP2 = 0xC2B2AE3D27D4EB4F
_XP3 = 0x165667B19E3779F9
_XP4 = 0x85EBCA77C2B2AE63
_XP5 = 0x27D4EB2F165667C5


def _rotl64(x: int, r: int) -> int:
    return ((x << r) | (x >> (64 - r))) & _M64


def _xx_round(acc: int, v: int) -> int:
    return (_rotl64((acc + v * _XP2) & _M64, 31) * _XP1) & _M64


def _xx_avalanche(h: int) -> int:
    h = ((h ^ (h >> 33)) * _XP2) & _M64
    h = ((h ^ (h >> 29)) * _XP3) & _M64
    return h ^ (h >> 32)


def xxhash64_int(v: int, seed: int) -> int:
    h = (seed + _XP5 + 4) & _M64
    h ^= ((v & _M32) * _XP1) & _M64
    return _xx_avalanche((_rotl64(h, 23) * _XP2 + _XP3) & _M64)


def xxhash64_long(v: int, seed: int) -> int:
    h = (seed + _XP5 + 8) & _M64
    h ^= _xx_round(0, v & _M64)
    return _xx_avalanche((_rotl64(h, 27) * _XP1 + _XP4) & _M64)


def xxhash64_bytes(data: bytes, seed: int) -> int:
    """XXH64.hashUnsafeBytes: 32-byte stripes through four accumulators,
    then 8-byte words, at most one 4-byte word and the tail bytes."""
    n, off = len(data), 0
    if n >= 32:
        v = [(seed + _XP1 + _XP2) & _M64, (seed + _XP2) & _M64, seed,
             (seed - _XP1) & _M64]
        while off <= n - 32:
            for j in range(4):
                w = int.from_bytes(data[off + 8 * j:off + 8 * j + 8],
                                   "little")
                v[j] = _xx_round(v[j], w)
            off += 32
        h = (_rotl64(v[0], 1) + _rotl64(v[1], 7) + _rotl64(v[2], 12)
             + _rotl64(v[3], 18)) & _M64
        for acc in v:
            h = ((h ^ _xx_round(0, acc)) * _XP1 + _XP4) & _M64
    else:
        h = (seed + _XP5) & _M64
    h = (h + n) & _M64
    while off <= n - 8:
        h ^= _xx_round(0, int.from_bytes(data[off:off + 8], "little"))
        h = (_rotl64(h, 27) * _XP1 + _XP4) & _M64
        off += 8
    if off <= n - 4:
        h ^= (int.from_bytes(data[off:off + 4], "little") * _XP1) & _M64
        h = (_rotl64(h, 23) * _XP2 + _XP3) & _M64
        off += 4
    while off < n:
        h ^= (data[off] * _XP5) & _M64
        h = (_rotl64(h, 11) * _XP1) & _M64
        off += 1
    return _xx_avalanche(h)


def _double_bits(v: float) -> int:
    """Java's doubleToLongBits as Spark hashes it: -0.0 as 0.0, every NaN
    canonical; a subnormal keeps its bits."""
    if math.isnan(v):
        return 0x7FF8000000000000
    return struct.unpack("<q", struct.pack("<d", v + 0.0 if v == 0 else v))[0]


def _float_bits(v: float) -> int:
    if math.isnan(v):
        return 0x7FC00000
    return struct.unpack("<i", struct.pack("<f", 0.0 if v == 0 else v))[0]


def _hash_value(v, dtype: T.SqlType, seed: int, int_fn, long_fn,
                bytes_fn) -> int:
    """One non-null value hashed as the device hashes its kind."""
    k = dtype.kind
    if k in (TypeKind.INT8, TypeKind.INT16, TypeKind.INT32):
        return int_fn(v, seed)
    if k is TypeKind.BOOLEAN:
        return int_fn(1 if v else 0, seed)
    if k is TypeKind.DATE:
        return int_fn((v - _EPOCH).days, seed)
    if k is TypeKind.FLOAT32:
        return int_fn(_float_bits(v), seed)
    if k is TypeKind.INT64:
        return long_fn(v, seed)
    if k is TypeKind.TIMESTAMP:
        return long_fn((v - _EPOCH_TS) // _dt.timedelta(microseconds=1),
                       seed)
    if k is TypeKind.DECIMAL:
        return long_fn(int(v.scaleb(dtype.scale)), seed)
    if k is TypeKind.FLOAT64:
        return long_fn(_double_bits(v), seed)
    if k is TypeKind.STRING:
        return bytes_fn(v.encode("utf-8"), seed)
    raise _later(f"hashing {dtype}")


# ---------------------------------------------------------------------------
# Expressions
# ---------------------------------------------------------------------------

class RowEvaluator:
    """Evaluates a bound expression tree against a row tuple."""

    def __init__(self, schema: Schema, ansi: bool = False):
        self.schema = schema
        self.ansi = ansi
        #: the handler of each expression class met so far
        self._handlers: Dict[type, Any] = {}

    def eval(self, e: Expression, row: tuple) -> Any:
        m = self._handlers.get(type(e))
        if m is None:
            m = getattr(self, "_eval_" + type(e).__name__, None)
            if m is None:
                raise _later(type(e).__name__)
            self._handlers[type(e)] = m
        return m(e, row)

    # ---- leaves ----
    def _eval_BoundReference(self, e, row):
        return row[e.ordinal]

    def _eval_Literal(self, e, row):
        v = e.value
        if isinstance(v, int) and not isinstance(v, bool):
            # epoch days or microseconds re-hydrate to the values a scan's
            # rows hold
            if e.dtype.kind is TypeKind.DATE:
                return _EPOCH + _dt.timedelta(days=v)
            if e.dtype.kind is TypeKind.TIMESTAMP:
                return _EPOCH_TS + _dt.timedelta(microseconds=v)
        return v

    def _eval_Alias(self, e, row):
        return self.eval(e.child, row)

    # ---- arithmetic ----
    def _two(self, e, row):
        return self.eval(e.left, row), self.eval(e.right, row)

    def _fit(self, v, e):
        """A result in the expression's type: integers checked under ANSI
        and wrapped, floats rounded to float32 where the type is."""
        k = e.dtype.kind
        if k in _INT_BITS:
            bits = _INT_BITS[k]
            v = int(v)
            if self.ansi and not -(1 << (bits - 1)) <= v < 1 << (bits - 1):
                raise _overflow()
            return _wrap(v, bits)
        if k is TypeKind.FLOAT32:
            return _to_f32(v)
        return v

    def _arith(self, e, row, fn):
        l, r = self._two(e, row)
        if l is None or r is None:
            return None
        return self._fit(fn(l, r), e)

    def _eval_Add(self, e, row):
        return self._arith(e, row, lambda a, b: a + b)

    def _eval_Subtract(self, e, row):
        return self._arith(e, row, lambda a, b: a - b)

    def _eval_Multiply(self, e, row):
        return self._arith(e, row, lambda a, b: a * b)

    def _nonzero(self, r) -> bool:
        """False (or an ANSI raise) for a zero divisor."""
        if r == 0:
            if self.ansi:
                raise _div_zero()
            return False
        return True

    def _eval_Divide(self, e, row):
        l, r = self._two(e, row)
        if l is None or r is None or not self._nonzero(r):
            return None
        return float(l) / float(r)

    def _eval_IntegralDivide(self, e, row):
        l, r = self._two(e, row)
        if l is None or r is None:
            return None
        if isinstance(l, _dec.Decimal) or isinstance(r, _dec.Decimal):
            if not self._nonzero(r):
                return None
            with _dec.localcontext() as cx:
                cx.prec = 60
                return _wrap(int(_dec.Decimal(l) / _dec.Decimal(r)), 64)
        l, r = _to_long(l), _to_long(r)
        if not self._nonzero(r):
            return None
        if self.ansi and l == -(1 << 63) and r == -1:
            raise _overflow()
        return _wrap(_java_div(l, r), 64)

    def _eval_Remainder(self, e, row):
        l, r = self._two(e, row)
        if l is None or r is None or not self._nonzero(r):
            return None
        if e.dtype.kind in _INT_BITS:
            return _wrap(_java_rem(int(l), int(r)), _INT_BITS[e.dtype.kind])
        if isinstance(l, float) or isinstance(r, float):
            return self._fit(_fmod(l, r), e)
        return l % r           # decimals: the sign follows the dividend

    def _eval_Pmod(self, e, row):
        l, r = self._two(e, row)
        if l is None or r is None or not self._nonzero(r):
            return None
        k = e.dtype.kind
        if k in _INT_BITS:
            # Java: r = a % n; r < 0 ? (r + n) % n : r, with r + n in int
            # for bytes and shorts and in the type's width otherwise
            l, r = int(l), int(r)
            m = _java_rem(l, r)
            if m < 0:
                m = _java_rem(_wrap(m + r, max(_INT_BITS[k], 32)), r)
            return _wrap(m, _INT_BITS[k])
        if isinstance(l, float) or isinstance(r, float):
            m = _fmod(l, r)
            if m < 0:
                m = _fmod(self._fit(m + r, e), r)
            return self._fit(m, e)
        m = l % r
        return (m + r) % r if m < 0 else m

    def _eval_UnaryMinus(self, e, row):
        v = self.eval(e.child, row)
        return None if v is None else self._fit(-v, e)

    def _eval_Abs(self, e, row):
        v = self.eval(e.child, row)
        return None if v is None else self._fit(abs(v), e)

    def _eval_BitwiseOp(self, e, row):
        l, r = self._two(e, row)
        if l is None or r is None:
            return None
        v = l & r if e.op == "and" else l | r if e.op == "or" else l ^ r
        return _wrap(v, _INT_BITS[e.dtype.kind])

    def _eval_BitwiseNot(self, e, row):
        v = self.eval(e.child, row)
        return None if v is None else _wrap(~v, _INT_BITS[e.dtype.kind])

    def _eval_Shift(self, e, row):
        """Java's shifts: the amount modulo the width (32 for int, 64 for
        bigint; narrower values promote to int)."""
        v, a = self._two(e, row)
        if v is None or a is None:
            return None
        width = _INT_BITS[e.dtype.kind]
        a %= width
        if e.op == "left":
            return _wrap(v << a, width)
        if e.op == "right":
            return v >> a
        return _wrap((v & ((1 << width) - 1)) >> a, width)

    # ---- comparison and boolean (three-valued) ----
    def _cmp(self, e, row, fn):
        l, r = self._two(e, row)
        if l is None or r is None:
            return None
        return fn(ordkey(l), ordkey(r))

    def _eval_EqualTo(self, e, row):
        l, r = self._two(e, row)
        if l is None or r is None:
            return None
        if type(l) is str and type(r) is str:
            return l == r       # equal strings are equal UTF-8 bytes
        return ordkey(l) == ordkey(r)

    def _eval_LessThan(self, e, row):
        return self._cmp(e, row, lambda a, b: a < b)

    def _eval_LessThanOrEqual(self, e, row):
        return self._cmp(e, row, lambda a, b: a <= b)

    def _eval_GreaterThan(self, e, row):
        return self._cmp(e, row, lambda a, b: a > b)

    def _eval_GreaterThanOrEqual(self, e, row):
        return self._cmp(e, row, lambda a, b: a >= b)

    def _eval_EqualNullSafe(self, e, row):
        l, r = self._two(e, row)
        if l is None or r is None:
            return l is None and r is None
        return ordkey(l) == ordkey(r)

    def _eval_Not(self, e, row):
        v = self.eval(e.child, row)
        return None if v is None else not v

    def _eval_IsNull(self, e, row):
        return self.eval(e.child, row) is None

    def _eval_IsNotNull(self, e, row):
        return self.eval(e.child, row) is not None

    def _eval_IsNaN(self, e, row):
        v = self.eval(e.child, row)
        return None if v is None else (isinstance(v, float)
                                       and math.isnan(v))

    def _eval_In(self, e, row):
        v = self.eval(e.child, row)
        if v is None:
            return None
        k = ordkey(v)
        if any(w is not None and ordkey(w) == k for w in e.values):
            return True
        return None if any(w is None for w in e.values) else False

    def _eval_And(self, e, row):
        l, r = self._two(e, row)
        if l is False or r is False:
            return False
        return None if l is None or r is None else True

    def _eval_Or(self, e, row):
        l, r = self._two(e, row)
        if l is True or r is True:
            return True
        return None if l is None or r is None else False

    # ---- cast: the integral widening the port's Cast binds ----
    def _eval_Cast(self, e, row):
        return self.eval(e.child, row)

    # ---- strings (independent str-based implementations) ----
    def _eval_StringPredicate(self, e, row):
        v = self.eval(e.child, row)
        p = self.eval(e.pattern, row)
        if v is None or p is None:
            return None
        if e.op == "contains":
            return p in v
        if e.op == "startswith":
            return v.startswith(p)
        return v.endswith(p)

    def _eval_Length(self, e, row):
        v = self.eval(e.children[0], row)
        return None if v is None else len(v)

    def _eval_OctetLength(self, e, row):
        s = self.eval(e.children[0], row)
        if s is None:
            return None
        nbytes = len(s.encode("utf-8"))
        return nbytes * 8 if e.bits else nbytes

    @staticmethod
    def _simple_case(v, upper: bool):
        """The device contract: simple single-char mapping where the
        counterpart stays in the same UTF-8 byte-length class (1/2/3
        bytes); everything else passes through."""
        out = []
        for ch in v:
            m = ch.upper() if upper else ch.lower()
            if len(m) == 1:
                c, r = ord(ch), ord(m)
                same = any(lo <= c < hi and lo <= r < hi for lo, hi in
                           ((0, 0x80), (0x80, 0x800), (0x800, 0x10000)))
                out.append(m if same else ch)
            else:
                out.append(ch)
        return "".join(out)

    def _eval_Upper(self, e, row):
        v = self.eval(e.children[0], row)
        return None if v is None else self._simple_case(v, True)

    def _eval_Lower(self, e, row):
        v = self.eval(e.children[0], row)
        return None if v is None else self._simple_case(v, False)

    def _eval_Substring(self, e, row):
        v = self.eval(e.child, row)
        p = self.eval(e.pos, row)
        ln = self.eval(e.length, row) if e.length is not None else None
        if v is None or p is None or (e.length is not None and ln is None):
            return None
        n = len(v)
        if p > 0:
            start = p - 1
        elif p < 0:
            start = max(n + p, 0) if n + p >= 0 else n
        else:
            start = 0
        want = ln if ln is not None else n
        return v[start: start + max(want, 0)]

    def _eval_Concat(self, e, row):
        parts = [self.eval(c, row) for c in e.children]
        if any(p is None for p in parts):
            return None
        return "".join(parts)

    def _eval_StringLocate(self, e, row):
        v = self.eval(e.child, row)
        p = self.eval(e.pattern, row)
        if v is None or p is None:
            return None
        return v.find(p) + 1

    def _eval_StringTrim(self, e, row):
        v = self.eval(e.children[0], row)
        if v is None:
            return None
        if e.side == "leading":
            return v.lstrip(" ")
        if e.side == "trailing":
            return v.rstrip(" ")
        return v.strip(" ")

    def _eval_StringPad(self, e, row):
        v = self.eval(e.child, row)
        t = self.eval(e.target_len, row)
        p = self.eval(e.pad, row)
        if v is None or t is None or p is None:
            return None
        t = max(t, 0)
        if len(v) >= t or not p:
            return v[:t] if len(v) > t else v
        fill = (p * t)[: t - len(v)]
        return fill + v if e.left else v + fill

    def _eval_StringRepeat(self, e, row):
        v = self.eval(e.child, row)
        t = self.eval(e.times, row)
        if v is None or t is None:
            return None
        return v * max(t, 0)

    def _eval_StringReplace(self, e, row):
        v = self.eval(e.child, row)
        s = self.eval(e.search, row)
        r = self.eval(e.replacement, row)
        if v is None or s is None or r is None:
            return None
        return v.replace(s, r) if s else v

    def _eval_Translate(self, e, row):
        s = self.eval(e.child, row)
        if s is None:
            return None
        mapping = {}
        for i, ch in enumerate(e.from_str):
            if ch in mapping:
                continue        # the first occurrence wins (Spark)
            mapping[ch] = e.to_str[i] if i < len(e.to_str) else None
        return "".join(mapping.get(ch, ch) for ch in s
                       if mapping.get(ch, ch) is not None)

    def _eval_Reverse(self, e, row):
        s = self.eval(e.children[0], row)
        return None if s is None else s[::-1]

    def _eval_Ascii(self, e, row):
        s = self.eval(e.children[0], row)
        if s is None:
            return None
        if not s:
            return 0
        cp = ord(s[0])
        if cp > 0xFFFF:     # Spark: the first UTF-16 code unit (surrogate)
            return 0xD800 + ((cp - 0x10000) >> 10)
        return cp

    def _eval_Chr(self, e, row):
        n = self.eval(e.children[0], row)
        if n is None:
            return None
        return "" if n < 0 else chr(int(n) % 256)

    def _eval_Levenshtein(self, e, row):
        a = self.eval(e.children[0], row)
        b = self.eval(e.children[1], row)
        if a is None or b is None:
            return None
        prev = list(range(len(b) + 1))
        for i, ca in enumerate(a):
            cur = [i + 1]
            for j, cb in enumerate(b):
                cur.append(min(prev[j + 1] + 1, cur[j] + 1,
                               prev[j] + (ca != cb)))
            prev = cur
        return prev[len(b)]

    def _eval_Soundex(self, e, row):
        s = self.eval(e.children[0], row)
        if s is None:
            return None
        if not s or not s[0].isascii() or not s[0].isalpha():
            return s
        out = s[0].upper()
        last = _SOUNDEX_CODES.get(out, "0")
        digits = []
        for ch in s[1:]:
            u = ch.upper()
            if not ("A" <= u <= "Z"):
                last = "-"      # non-letters reset the duplicate tracker
                continue
            code = _SOUNDEX_CODES.get(u, "0")
            if code in "123456" and code != last:
                digits.append(code)
                if len(digits) == 3:
                    break
            if code in "123456":
                last = code
            elif code == "0":       # vowels reset; H/W (7) keep last
                last = "-"
        return out + "".join(digits).ljust(3, "0")

    def _eval_SubstringIndex(self, e, row):
        v = self.eval(e.child, row)
        d = self.eval(e.delim, row)
        c = self.eval(e.count, row)
        if v is None or d is None or c is None:
            return None
        if c == 0 or not d:
            return ""
        parts = v.split(d)
        if c > 0:
            return d.join(parts[:c]) if len(parts) > c else v
        return d.join(parts[c:]) if len(parts) > -c else v

    def _eval_RLike(self, e, row):
        v = self.eval(e.children[0], row)
        if v is None:
            return None
        return re.search(e.pattern, v) is not None

    def _eval_Like(self, e, row):
        from ..expressions.regex import like_to_regex
        v = self.eval(e.children[0], row)
        if v is None:
            return None
        return re.search(like_to_regex(e.pattern), v, re.DOTALL) is not None

    # ---- hashes ----
    def _hash_row(self, e, row, int_fn, long_fn, bytes_fn, to_signed):
        h = e.seed
        for c in e.exprs:
            v = self.eval(c, row)
            if v is not None:
                h = to_signed(_hash_value(v, c.dtype, h, int_fn, long_fn,
                                          bytes_fn))
        return to_signed(h)

    def _eval_Murmur3Hash(self, e, row):
        return self._hash_row(e, row, murmur3_int, murmur3_long,
                              murmur3_bytes, lambda h: _wrap(h, 32))

    def _eval_XxHash64(self, e, row):
        return self._hash_row(e, row, xxhash64_int, xxhash64_long,
                              xxhash64_bytes, lambda h: _wrap(h, 64))


# ---------------------------------------------------------------------------
# Aggregates
# ---------------------------------------------------------------------------

def _agg_value(a, xs: List, n_rows: int):
    """One aggregate over one group: ``xs`` the child's value per row
    (``None`` for count(*)), ``n_rows`` the group's rows."""
    name = type(a).__name__
    if xs is None:
        if name == "Count":
            return n_rows
        raise _later(f"aggregate {name} without an input")
    nn = [x for x in xs if x is not None]
    if name == "Count":
        return len(nn)
    if name == "Sum":
        if not nn:
            return None
        d = a.dtype
        if d.kind is TypeKind.DECIMAL:
            with _dec.localcontext() as cx:
                cx.prec = 60
                s = sum(nn)
                if abs(int(s.scaleb(d.scale))) >= 10 ** d.precision:
                    return None           # Spark: an overflowing sum is null
                return s.quantize(_dec.Decimal(1).scaleb(-d.scale))
        if d.kind in _INT_BITS:
            return _wrap(sum(nn), 64)
        return float(sum(nn))
    if name == "Min":
        return min(nn, key=ordkey) if nn else None
    if name == "Max":
        return max(nn, key=ordkey) if nn else None
    if name == "Average":
        if not nn:
            return None
        d = a.dtype
        if d.kind is TypeKind.DECIMAL:
            with _dec.localcontext() as cx:
                cx.prec = 60
                return (sum(nn) / len(nn)).quantize(
                    _dec.Decimal(1).scaleb(-d.scale),
                    rounding=_dec.ROUND_HALF_UP)
        return float(sum(nn)) / len(nn)
    if name == "First":
        return xs[0] if xs else None
    if name == "Last":
        return xs[-1] if xs else None
    if name in ("Percentile", "ApproxPercentile"):
        if not nn:
            return None
        s = sorted(nn, key=ordkey)
        r = a.percentage * (len(s) - 1)
        lo, hi = int(math.floor(r)), int(math.ceil(r))
        frac = r - lo
        return (1 - frac) * float(s[lo]) + frac * float(s[hi])
    if name in ("StddevSamp", "VarianceSamp", "StddevPop", "VariancePop"):
        n = len(nn)
        samp = name.endswith("Samp")
        if n < (2 if samp else 1):
            return None
        vals = [float(x) for x in nn]
        mean = sum(vals) / n
        var = sum((x - mean) ** 2 for x in vals) / (n - 1 if samp else n)
        return math.sqrt(var) if name.startswith("Stddev") else var
    raise _later(f"aggregate {name}")


# ---------------------------------------------------------------------------
# Plans
# ---------------------------------------------------------------------------

def _pylist(c: pa.ChunkedArray) -> list:
    """A column's values as Python objects; a null-free integer, float or
    string column goes through numpy, which makes the same values faster."""
    t = c.type
    if c.null_count == 0 and (pa.types.is_integer(t) or
                              pa.types.is_floating(t) or
                              pa.types.is_string(t)):
        return c.to_numpy().tolist()
    return c.to_pylist()


def rows_of(table: pa.Table) -> List[tuple]:
    """A table's rows as tuples of Python values (dates as ``date``,
    timestamps as UTC ``datetime``, decimals as ``Decimal``)."""
    cols = [_pylist(c) for c in table.columns]
    return list(zip(*cols)) if cols else [()] * table.num_rows


def table_of(rows: List[tuple], schema: Schema) -> pa.Table:
    arrays = [pa.array([r[i] for r in rows], type=T.to_arrow(f.dtype))
              for i, f in enumerate(schema)]
    return pa.table(arrays, names=schema.names)


class Interpreter:
    """Executes a logical plan on the CPU, row by row."""

    def __init__(self, ansi: bool = False):
        self.ansi = ansi

    def execute(self, plan: L.LogicalPlan) -> pa.Table:
        return table_of(self._exec(plan), plan.schema())

    def _exec(self, p: L.LogicalPlan) -> List[tuple]:
        m = getattr(self, "_exec_" + type(p).__name__, None)
        if m is None:
            raise _later(f"operator {p.name}")
        return m(p)

    def _child(self, p):
        """The child's rows, and an evaluator and binder over its schema."""
        child = p.children[0]
        schema = child.schema()
        return (self._exec(child), RowEvaluator(schema, self.ansi),
                lambda e: e.bind(schema))

    def _exec_LogicalScan(self, p):
        if p.data is not None:
            return rows_of(p.data)
        t = p.source.read_all()
        return [] if t is None else rows_of(t)

    def _exec_LogicalRange(self, p):
        return [(i,) for i in range(p.start, p.end, p.step)]

    def _exec_LogicalProject(self, p):
        rows, ev, bind = self._child(p)
        exprs = [bind(e) for e in p.exprs]
        return [tuple(ev.eval(e, r) for e in exprs) for r in rows]

    def _exec_LogicalFilter(self, p):
        rows, ev, bind = self._child(p)
        cond = bind(p.condition)
        return [r for r in rows if ev.eval(cond, r) is True]

    def _exec_LogicalLimit(self, p):
        return self._exec(p.children[0])[:p.limit]

    def _exec_LogicalUnion(self, p):
        return [r for c in p.children for r in self._exec(c)]

    def _exec_LogicalSample(self, p):
        import numpy as np
        rows = self._exec(p.children[0])
        keep = np.random.default_rng(p.seed).random(len(rows)) < p.fraction
        return [r for r, k in zip(rows, keep) if k]

    def _exec_LogicalExpand(self, p):
        rows, ev, bind = self._child(p)
        out = []
        for proj in p.projections:
            bound = [bind(e) for e in proj]
            out.extend(tuple(ev.eval(e, r) for e in bound) for r in rows)
        return out

    def _exec_LogicalSort(self, p):
        rows, ev, bind = self._child(p)
        orders = [o.bind(p.children[0].schema()) for o in p.orders]

        def key(row):
            parts = []
            for o in orders:
                v = ev.eval(o.child, row)
                if v is None:
                    parts.append((0 if o.effective_nulls_first else 2, ()))
                else:
                    k = ordkey(v)
                    parts.append((1, _NegKey(k) if o.descending else k))
            return tuple(parts)

        return sorted(rows, key=key)

    def _exec_LogicalAggregate(self, p):
        rows, ev, bind = self._child(p)
        keys = [bind(e) for e in p.group_exprs]
        aggs = [bind(e.child if isinstance(e, Alias) else e)
                for e in p.agg_exprs]
        groups: Dict[tuple, tuple] = {}
        for r in rows:
            raw = tuple(ev.eval(e, r) for e in keys)
            k = tuple(_NULL if v is None else ordkey(v) for v in raw)
            g = groups.get(k)
            if g is None:
                g = groups[k] = (raw, [])
            g[1].append(r)
        if not keys and not groups:
            groups[()] = ((), [])
        out = []
        for raw, grp in groups.values():
            vals = []
            for a in aggs:
                if not a.children:
                    xs = None
                else:
                    xs = [ev.eval(a.child, r) for r in grp]
                vals.append(_agg_value(a, xs, len(grp)))
            out.append(raw + tuple(vals))
        return out

    def _exec_LogicalJoin(self, p):
        lc, rc = p.children
        lrows, rrows = self._exec(lc), self._exec(rc)
        ls, rs = lc.schema(), rc.schema()
        lev, rev = RowEvaluator(ls, self.ansi), RowEvaluator(rs, self.ansi)
        lk = [e.bind(ls) for e in p.left_keys]
        rk = [e.bind(rs) for e in p.right_keys]
        pair = Schema(list(ls.fields) + list(rs.fields))
        pev = RowEvaluator(pair, self.ansi)
        cond = p.condition.bind(pair) if p.condition is not None else None
        jt = p.join_type

        def key_of(ev, exprs, row):
            """The row's join key, or None if a part is null (a null key
            matches nothing)."""
            vals = [ev.eval(e, row) for e in exprs]
            if any(v is None for v in vals):
                return None
            return tuple(ordkey(v) for v in vals)

        # the build: right rows by key, in input order
        build: Dict[tuple, List[int]] = {}
        for j, r in enumerate(rrows):
            k = key_of(rev, rk, r)
            if k is not None:
                build.setdefault(k, []).append(j)
        matched_r = [False] * len(rrows)
        nl, nr = len(ls.fields), len(rs.fields)
        pairs_out = jt in (JoinType.INNER, JoinType.LEFT_OUTER,
                           JoinType.RIGHT_OUTER, JoinType.FULL_OUTER,
                           JoinType.CROSS)
        out = []
        for lrow in lrows:
            k = key_of(lev, lk, lrow)
            m = False
            for j in (build.get(k, ()) if k is not None else ()):
                rrow = rrows[j]
                if cond is not None and pev.eval(cond, lrow + rrow) \
                        is not True:
                    continue
                m = matched_r[j] = True
                if pairs_out:
                    out.append(lrow + rrow)
            if jt is JoinType.EXISTENCE:
                out.append(lrow + (m,))
            elif (jt is JoinType.LEFT_SEMI and m) or \
                    (jt is JoinType.LEFT_ANTI and not m):
                out.append(lrow)
            elif jt in (JoinType.LEFT_OUTER, JoinType.FULL_OUTER) and not m:
                out.append(lrow + (None,) * nr)
        if jt in (JoinType.RIGHT_OUTER, JoinType.FULL_OUTER):
            out.extend((None,) * nl + r
                       for j, r in enumerate(rrows) if not matched_r[j])
        return out

