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
the rest of the expressions with their device side (the Python UDFs);
``InterleaveBits`` and the window functions have no handler here, as in
the JAX package, and raise its message (``NO_HANDLER``): the window
operator computes the functions (``_window_values``, Spark's definitions
partition by partition, a value-bounded RANGE frame by a positional
scan). The map lambdas, ``zip_with`` and a standalone
``from_json`` have no handler here, as in the JAX package: tagging never
sends them to the CPU, and one that it refuses raises. Arrays are lists,
structs dicts and maps lists of (key, value) pairs; ``ordkey`` orders and
hashes the nested values, field by field and element by element.

The collection handlers follow the port's device where the JAX interpreter
departs from it: ``str_to_map`` keeps every entry, duplicate keys
included (the JAX handler builds a dict, which keeps the last), and
``sort_array``, ``array_min``/``array_max`` and ``array_contains`` order
and compare through ``ordkey`` (NaN greatest, equal to itself), as Spark
does.

The interpreter agrees with the port's device path, row for row. Where the
JAX interpreter departs from it, this one follows the port (and Spark
where the port does): ``In`` reads its value list (the JAX handler reads
the expression's children, which hold the probe alone, and answers
false); ``Remainder`` and ``Pmod`` on integers are exact (the JAX handler
goes through ``math.fmod``, which rounds int64 operands above 2^53:
``(2**62 + 1) % 7`` is 4 there and 5 in Java); ``Pmod`` by a negative
divisor and ANSI overflow of ``div``, ``-`` and ``abs`` at MIN follow Java;
a percentile orders NaN last; ``Murmur3Hash`` hashes the SQL kinds (the
JAX handler passes types its scalar hash does not know, and raises);
``XxHash64`` is a scalar Python XXH64, where the JAX handler calls its
device kernel per value. ``tests/test_torch_interpreter.py`` pins each
with both outputs. ``isnan(null)`` is false here, on the port's device,
in the JAX interpreter and in Spark; only the JAX device gives null.
Decimal arithmetic is exact here, at the result type's scale and null past
its precision, as in Spark: the JAX handlers compute in Python's default
28-digit context, which rounds a wide sum or product
(``tests/test_torch_decimal128.py`` pins both). A DECIMAL128 ``Murmur3Hash``
hashes ``BigInteger.toByteArray``'s bytes (``kernels.murmur3.hash_decimal``,
the oracle of the device's ``_hash_dec128``); ``XxHash64`` of a value past
18 digits raises ``OverflowError``, as both JAX paths do.

The scalar handlers (conditionals, math, the cast, dates and times) follow
the device the same way: ``least``/``greatest`` keep the first of two
values that compare false both ways (a NaN), where the JAX handler orders
NaN above every double; the log of NaN is null and exp, sinh and cosh
overflow to infinity (the JAX handler gives NaN for both); a double cast
to an integral type saturates (the JAX handler wraps it) and a string
parses as the device's parser does (ASCII digits, its whitespace set). The
math functions go through numpy's scalar functions, which give IEEE
results. Three departures of both devices from Spark stay with the
device, not here: a decimal in floor, ceil and round is read as its
unscaled integer; round of a double is HALF_UP on the double scaled by
10^s, where Spark rounds its decimal string (1.005 rounds to 1.0 there,
to 1.01 here); a double cast to a decimal rounds half to even without the
precision check. ``tests/test_torch_conditional_math.py`` and
``tests/test_torch_cast.py`` pin them. ``Rand`` draws the JAX
interpreter's one value per seed, not the device's sequence.

The string handlers follow the device the same way: ``initcap`` maps
ASCII letters only, and ``conv`` trims nothing and wraps its
accumulation mod 2^64 (the JAX handler maps every letter, trims, and
keeps every digit); ``tests/test_torch_strings_rest.py`` pins each.

The lambdas bind their variables by identity, as the JAX handlers do.
The set operations, ``array_remove`` and ``array_position`` compare
through ``ordkey`` (NaN one value, as on the device and in Spark; the JAX
handlers compare with ``==``). ``sequence`` with a step of 0 is null and
against its direction empty, as on both devices (Spark raises), and past
its budget raises, as the device does; ``array_repeat`` of a null value
is null, as on the device (Spark and the JAX handler give n nulls).
``get_json_object`` scans the document a byte at a time with the device's
rules, so a nested value comes back as its input span, blanks included,
and a string with a ``\\uXXXX`` escape is null, where the JAX handler
goes through ``json.loads`` and gives Jackson's compact JSON and the
decoded string, as Spark does.

Sample draws its rows with numpy from the seed, as the JAX interpreter
does; the device's Bernoulli draw is another sequence, so a sampled query
compares on its shape, not its rows.
"""

from __future__ import annotations

import bisect
import calendar
import datetime as _dt
import decimal as _dec
import math
import re
import struct
from typing import Any, Dict, List

import numpy as np
import pyarrow as pa

from .. import types as T
from ..batch import Schema
from ..exec.join import JoinType
from ..expressions.base import Alias, Expression
from ..kernels.murmur3 import (hash_decimal, murmur3_bytes, murmur3_int,
                               murmur3_long)
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


#: expressions the port has whose rows no handler computes, as in the JAX
#: interpreter (a window function is the window operator's to evaluate;
#: ``InterleaveBits`` runs on the device alone): they raise the JAX
#: interpreter's message
NO_HANDLER = frozenset({
    "InterleaveBits", "WindowExpression", "RowNumber", "Rank", "NTile",
    "PercentRank", "CumeDist", "NthValue", "LagLead", "WindowAgg"})


def _later(what: str) -> NotImplementedError:
    if what in NO_HANDLER:
        return NotImplementedError(f"CPU interpreter: {what}")
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
    bytes; a struct field by field, an array element by element (both
    hashable, so they group and join), a null inside them first."""
    if isinstance(v, float) and math.isnan(v):
        return (1, 0.0)
    if isinstance(v, str):
        return (0, v.encode("utf-8"))
    if isinstance(v, dict):
        return (0, tuple(_inner_key(x) for x in v.values()))
    if isinstance(v, (list, tuple)):
        return (0, tuple(_inner_key(x) for x in v))
    return (0, v)


def _inner_key(v):
    return (-1, 0) if v is None else ordkey(v)


def _map_pairs(m) -> list:
    """A map value's (key, value) pairs (Arrow gives maps as pair
    lists)."""
    return list(m.items()) if isinstance(m, dict) else list(m)


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
# Scalar hashes: Spark's XXH64 over interpreter values (Murmur3_x86_32's
# scalar twin is kernels/murmur3.py's)
# ---------------------------------------------------------------------------

_M32 = 0xFFFFFFFF
_M64 = (1 << 64) - 1

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
        with _dec.localcontext() as cx:
            cx.prec = 80        # the default context rounds at 28 digits
            unscaled = int(v.scaleb(dtype.scale))
        if dtype.precision <= T.MAX_LONG_DIGITS:
            return long_fn(unscaled, seed)
        if long_fn is murmur3_long:
            # BigInteger.toByteArray's bytes (the device's _hash_dec128)
            return hash_decimal(unscaled, dtype.precision, seed)
        # the JAX package's interpreter and device both raise here
        # (ROADMAP Queue 3, a cause shared by both packages)
        raise OverflowError(f"xxhash64 of {dtype}: a value past 18 digits "
                            f"does not fit the long XXH64 hashes")
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
        #: id(LambdaVariable) -> its value, while a lambda's body runs
        self._lambda_bindings: Dict[int, Any] = {}

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
        if isinstance(v, np.generic):
            # a numpy scalar (lit(np.int64(3))) as the Python value a scan's
            # rows hold: its comparisons give numpy bools, which a filter's
            # ``is True`` drops (the JAX handler keeps it, and its filter
            # passes no row)
            v = v.item()
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
        and wrapped, floats rounded to float32 where the type is, decimals
        at the type's scale and null past its precision (an overflow under
        ANSI), as Spark's non-ANSI decimal arithmetic is."""
        k = e.dtype.kind
        if k is TypeKind.DECIMAL and isinstance(v, _dec.Decimal):
            d = e.dtype
            with _dec.localcontext() as cx:
                cx.prec = 80
                q = v.quantize(_dec.Decimal(1).scaleb(-d.scale))
            if abs(q) >= _dec.Decimal(10) ** (d.precision - d.scale):
                if self.ansi:
                    raise _overflow()
                return None
            return q
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
        if isinstance(l, _dec.Decimal) or isinstance(r, _dec.Decimal):
            # exact: the default context rounds at 28 digits, and a
            # product of two decimals may have 77
            with _dec.localcontext() as cx:
                cx.prec = 80
                return self._fit(fn(l, r), e)
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
        return isinstance(v, float) and math.isnan(v)

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

    # ---- conditionals ----
    def _eval_If(self, e, row):
        c = self.eval(e.predicate, row)
        return self.eval(e.true_value if c is True else e.false_value, row)

    def _eval_CaseWhen(self, e, row):
        for cond, val in e.branches:
            if self.eval(cond, row) is True:
                return self.eval(val, row)
        return None if e.else_value is None else self.eval(e.else_value, row)

    def _eval_Coalesce(self, e, row):
        for c in e.exprs:
            v = self.eval(c, row)
            if v is not None:
                return v
        return None

    def _eval_LeastGreatest(self, e, row):
        # left to right, a value replacing the best only where it compares
        # strictly better: NaN never wins and never loses, as on the device
        best = None
        for c in e.exprs:
            v = self.eval(c, row)
            if v is None:
                continue
            if best is None or (v > best if e.greatest else v < best):
                best = v
        return best

    # ---- cast ----
    def _eval_Cast(self, e, row):
        v = self.eval(e.child, row)
        if v is None:
            return None
        src, to = e.child.dtype, e.to
        try:
            return _cast_value(v, src, to)
        except (ValueError, OverflowError, ArithmeticError):
            return None

    # ---- math (IEEE results through numpy's scalar functions) ----
    def _eval_UnaryMath(self, e, row):
        v = self.eval(e.child, row)
        if v is None:
            return None
        x = float(v)
        if e.fn in _LOG_EDGE:
            if not x > _LOG_EDGE[e.fn]:
                return None          # at or below the edge, and NaN: null
        return _np_call(_UNARY_MATH[e.fn], x)

    def _eval_Pow(self, e, row):
        return self._double2(e, row, np.power)

    def _eval_Atan2(self, e, row):
        return self._double2(e, row, np.arctan2)

    def _eval_Hypot(self, e, row):
        return self._double2(e, row, np.hypot)

    def _double2(self, e, row, fn):
        l, r = self._two(e, row)
        if l is None or r is None:
            return None
        return _np_call(fn, float(l), float(r))

    def _eval_FloorCeil(self, e, row):
        v = self.eval(e.child, row)
        if v is None:
            return None
        if e.child.dtype.is_integral:
            return v
        x = float(v)
        if not math.isfinite(x):
            return None
        return _saturate(math.ceil(x) if e.is_ceil else math.floor(x), 64)

    def _eval_Signum(self, e, row):
        v = self.eval(e.child, row)
        if v is None:
            return None
        x = float(v)
        if math.isnan(x) or x == 0:
            return x
        return math.copysign(1.0, x)

    def _eval_Round(self, e, row):
        v = self.eval(e.child, row)
        if v is None:
            return None
        if isinstance(v, float) and not math.isfinite(v):
            return v
        d = _dec.Decimal(repr(v) if isinstance(v, float) else v)
        mode = _dec.ROUND_HALF_EVEN if e.half_even else _dec.ROUND_HALF_UP
        with _dec.localcontext() as cx:
            cx.prec = 400           # every double's digits, and the scale's
            q = d.quantize(_dec.Decimal(1).scaleb(-e.scale), rounding=mode)
        if isinstance(v, float):
            return math.copysign(float(q), v) if q == 0 else float(q)
        if isinstance(v, _dec.Decimal):
            return q
        return _saturate(int(q), _INT_BITS[e.dtype.kind])

    def _eval_Logarithm(self, e, row):
        b = self.eval(e.base, row)
        x = self.eval(e.child, row)
        if b is None or x is None:
            return None
        b = float(b)
        x = float(x)
        if not (b > 0 and x > 0):
            return None
        return _np_call(lambda xs, bs: np.log(xs) / np.log(bs), x, b)

    def _eval_NaNvl(self, e, row):
        a = self.eval(e.left, row)
        if a is None:
            return None
        if not math.isnan(float(a)):
            return float(a)
        b = self.eval(e.right, row)
        return None if b is None else float(b)

    def _eval_Rand(self, e, row):
        # the JAX interpreter's: one value per seed, not the device's
        # threefry sequence (a documented incompat); the card's values are
        # held against the same torch code on the CPU instead
        import random
        return random.Random(e.seed).random()

    def _eval_RaiseError(self, e, row):
        v = self.eval(e.child, row)
        if v is not None:
            raise RuntimeError(f"[USER_RAISED_ERROR] {v}")
        return None

    # ---- datetime (independent: Python's datetime and calendar) ----
    def _eval_ExtractDatePart(self, e, row):
        v = self.eval(e.child, row)
        if v is None:
            return None
        p = e.part
        if p in ("hour", "minute", "second"):
            return getattr(v, p)
        d = v.date() if isinstance(v, _dt.datetime) else v
        if p == "year":
            return d.year
        if p == "month":
            return d.month
        if p == "day":
            return d.day
        if p == "quarter":
            return (d.month - 1) // 3 + 1
        if p == "dayofweek":
            return d.isoweekday() % 7 + 1   # Sunday = 1 ... Saturday = 7
        if p == "dayofyear":
            return d.timetuple().tm_yday
        if p == "weekofyear":
            return d.isocalendar()[1]
        raise ValueError(p)

    def _eval_DateAddSub(self, e, row):
        v = self.eval(e.child, row)
        n = self.eval(e.days, row)
        if v is None or n is None:
            return None
        return v + _dt.timedelta(days=-n if e.negate else n)

    def _eval_DateDiff(self, e, row):
        a = self.eval(e.end, row)
        b = self.eval(e.start, row)
        if a is None or b is None:
            return None
        return (a - b).days

    def _eval_AddMonths(self, e, row):
        v = self.eval(e.child, row)
        n = self.eval(e.months, row)
        if v is None or n is None:
            return None
        total = v.year * 12 + (v.month - 1) + n
        y, m = total // 12, total % 12 + 1
        return _dt.date(y, m, min(v.day, calendar.monthrange(y, m)[1]))

    def _eval_LastDay(self, e, row):
        v = self.eval(e.child, row)
        if v is None:
            return None
        return _dt.date(v.year, v.month,
                        calendar.monthrange(v.year, v.month)[1])

    def _eval_UnixTimestampConv(self, e, row):
        v = self.eval(e.child, row)
        if v is None:
            return None
        if not e.to_unix:
            return _EPOCH_TS + _dt.timedelta(seconds=v)
        if isinstance(v, _dt.datetime):
            return _micros(v) // 1_000_000          # floors, as the device
        return (v - _EPOCH).days * 86400

    def _eval_DateFormat(self, e, row):
        v = self.eval(e.child, row)
        return None if v is None else _format_datetime(v, e.fmt)

    def _eval_ParseDateTime(self, e, row):
        v = self.eval(e.child, row)
        if v is None:
            return None
        return _parse_datetime(v, e.fmt, e.out)

    def _eval_FromUnixtime(self, e, row):
        v = self.eval(e.child, row)
        if v is None:
            return None
        try:
            ts = _EPOCH_TS + _dt.timedelta(seconds=int(v))
        except OverflowError:
            return None     # outside years 1-9999: the device nulls too
        return _format_datetime(ts, e.fmt)

    def _eval_TruncDateTime(self, e, row):
        from ..expressions.datetime import _TRUNC_DATE_LEVELS, \
            _TRUNC_TS_LEVELS
        v = self.eval(e.child, row)
        if v is None:
            return None
        levels = _TRUNC_TS_LEVELS if e.to_timestamp else _TRUNC_DATE_LEVELS
        lvl = levels.get(e.level.lower())
        if lvl is None:
            return None
        d = v.date() if isinstance(v, _dt.datetime) else v
        if lvl == "year":
            out = _dt.date(d.year, 1, 1)
        elif lvl == "quarter":
            out = _dt.date(d.year, ((d.month - 1) // 3) * 3 + 1, 1)
        elif lvl == "month":
            out = _dt.date(d.year, d.month, 1)
        elif lvl == "week":
            out = d - _dt.timedelta(days=d.weekday())
        else:
            out = d
        if not e.to_timestamp:
            return out
        if lvl in ("hour", "minute", "second") and \
                isinstance(v, _dt.datetime):
            ts = v.replace(microsecond=0)
            if lvl in ("hour", "minute"):
                ts = ts.replace(second=0)
            if lvl == "hour":
                ts = ts.replace(minute=0)
            return ts
        return _dt.datetime(out.year, out.month, out.day,
                            tzinfo=_dt.timezone.utc)

    def _eval_MonthsBetween(self, e, row):
        a = self.eval(e.end, row)
        b = self.eval(e.start, row)
        if a is None or b is None:
            return None
        ya, ma, da, ha, mia, sa, _ = _civil_tuple(a)
        yb, mb, db, hb, mib, sb, _ = _civil_tuple(b)
        months = (ya - yb) * 12 + (ma - mb)
        la = calendar.monthrange(ya, ma)[1]
        lb = calendar.monthrange(yb, mb)[1]
        # matching days of the month give whole months, the time of day
        # ignored (Spark's DateTimeUtils.monthsBetween)
        if da == db or (da == la and db == lb):
            v = float(months)
        else:
            v = months + ((da - db) + ((ha * 3600 + mia * 60 + sa)
                                       - (hb * 3600 + mib * 60 + sb))
                          / 86400.0) / 31.0
        return round(v * 1e8) / 1e8 if e.round_off else v

    def _eval_NextDay(self, e, row):
        v = self.eval(e.child, row)
        if v is None:
            return None
        t = e._target()
        if t is None:
            return None
        if isinstance(v, _dt.datetime):
            v = v.date()            # the result is a DATE, as on the device
        return v + _dt.timedelta(days=(t - v.weekday() + 7) % 7 or 7)

    def _eval_UTCTimestampConv(self, e, row):
        from zoneinfo import ZoneInfo
        v = self.eval(e.child, row)
        if v is None:
            return None
        tz = ZoneInfo(e.tz)
        wall = v.replace(tzinfo=None)
        if not e.to_utc:
            # the UTC instant's wall clock in the zone
            local = v.astimezone(tz).replace(tzinfo=None)
            return local.replace(tzinfo=_dt.timezone.utc)
        # the zone's wall clock to its UTC instant (fold 0: the earlier
        # offset in an overlap, shifted forward through a gap)
        return wall.replace(tzinfo=tz).astimezone(_dt.timezone.utc)

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

    def _eval_InitCap(self, e, row):
        s = self.eval(e.child, row)
        if s is None:
            return None
        # the device maps ASCII letters only (the JAX handler maps every
        # letter Python can case)
        out, prev_space = [], True
        for ch in s:
            if ch.isascii():
                ch = ch.upper() if prev_space else ch.lower()
            out.append(ch)
            prev_space = ch == " "
        return "".join(out)

    def _eval_FormatNumber(self, e, row):
        v = self.eval(e.child, row)
        if v is None:
            return None
        d = e._d
        if d < 0:
            return None
        dec = v if isinstance(v, _dec.Decimal) else \
            _dec.Decimal(repr(v)) if isinstance(v, float) else \
            _dec.Decimal(int(v))
        q = dec.quantize(_dec.Decimal(1).scaleb(-d),
                         rounding=_dec.ROUND_HALF_EVEN)
        return f"{q:,.{d}f}"

    def _eval_RegexpExtract(self, e, row):
        s = self.eval(e.child, row)
        if s is None:
            return None
        m = re.search(e.pattern, s)
        if m is None:
            return ""
        g = m.group(e.idx)
        return g if g is not None else ""

    def _eval_RegexpReplace(self, e, row):
        s = self.eval(e.child, row)
        if s is None:
            return None

        def expand(m):
            # Java appendReplacement: $N group refs (the longest valid
            # group number wins), a backslash escapes the next char, a
            # group that did not take part gives ""
            out, i, r = [], 0, e.replacement
            while i < len(r):
                ch = r[i]
                if ch == "\\" and i + 1 < len(r):
                    out.append(r[i + 1])
                    i += 2
                    continue
                if ch == "$" and i + 1 < len(r) and r[i + 1].isdigit():
                    j, num, best, bj = i + 1, 0, None, i + 1
                    while j < len(r) and r[j].isdigit():
                        num = num * 10 + int(r[j])
                        j += 1
                        if num <= m.re.groups:
                            best, bj = num, j
                    if best is None:
                        raise IndexError(f"No group {num} in replacement")
                    out.append(m.group(best) or "")
                    i = bj
                    continue
                out.append(ch)
                i += 1
            return "".join(out)

        return re.sub(e.pattern, expand, s)

    def _eval_ConcatWs(self, e, row):
        sep = self.eval(e.sep, row)
        if sep is None:
            return None
        parts = [self.eval(c, row) for c in e.exprs]
        return sep.join(p for p in parts if p is not None)

    def _eval_Hex(self, e, row):
        v = self.eval(e.child, row)
        if v is None:
            return None
        if isinstance(v, str):
            return v.encode("utf-8").hex().upper()
        return format(v & ((1 << 64) - 1), "X")

    def _eval_Bin(self, e, row):
        v = self.eval(e.child, row)
        if v is None:
            return None
        return format(v & ((1 << 64) - 1), "b")

    def _eval_Conv(self, e, row):
        v = self.eval(e.child, row)
        fb = self.eval(e.from_base, row)
        tb = self.eval(e.to_base, row)
        if v is None or fb is None or tb is None:
            return None
        if not (2 <= fb <= 36 and 2 <= abs(tb) <= 36):
            return None
        # as the device: no trimming (Spark trims), and the accumulation
        # wraps mod 2^64 (Spark saturates); the JAX handler trims and
        # wraps only a negative input
        s = str(v)
        neg = s.startswith("-")
        if neg:
            s = s[1:]
        digits = "0123456789abcdefghijklmnopqrstuvwxyz"[:fb]
        mask = (1 << 64) - 1
        acc, any_d = 0, False
        for ch in s:
            k = digits.find(ch.lower()) if ch.isascii() else -1
            if k < 0:
                break
            acc = (acc * fb + k) & mask
            any_d = True
        if not any_d:
            return "0"
        if neg:
            acc = ((~acc) + 1) & mask
        sign = ""
        if tb < 0:
            if acc >= 1 << 63:
                acc = (1 << 64) - acc
                sign = "-"
            tb = -tb
        out = ""
        ds = "0123456789ABCDEFGHIJKLMNOPQRSTUVWXYZ"
        while acc:
            out = ds[acc % tb] + out
            acc //= tb
        return sign + (out or "0")

    def _eval_FindInSet(self, e, row):
        q = self.eval(e.child, row)
        s = self.eval(e.set, row)
        if q is None or s is None:
            return None
        if "," in q:
            return 0
        parts = s.split(",")
        return parts.index(q) + 1 if q in parts else 0

    def _eval_Empty2Null(self, e, row):
        v = self.eval(e.child, row)
        return None if v == "" else v

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

    # ---- split and str_to_map ----
    def _eval_StringSplit(self, e, row):
        s = self.eval(e.child, row)
        if s is None:
            return None
        # Java Pattern.split (Spark's contract): a zero-width match at the
        # start is skipped, limit > 0 caps the pieces, limit == 0 drops
        # trailing empty strings
        pieces, index, count = [], 0, 0
        for m in re.finditer(e.pattern, s):
            if e.limit > 0 and count >= e.limit - 1:
                break
            a, b = m.span()
            if a == b and a == 0 and index == 0:
                continue
            pieces.append(s[index:a])
            index = b
            count += 1
        pieces.append(s[index:])
        if e.limit == 0:
            while pieces and pieces[-1] == "":
                pieces.pop()
        return pieces

    def _eval_StringToMap(self, e, row):
        v = self.eval(e.child, row)
        if v is None:
            return None
        # every entry in order, duplicate keys kept (the device's layout;
        # a read takes the last); no kv delimiter: a NULL value
        out = []
        for entry in v.split(e.pair_delim):
            if e.kv_delim in entry:
                k, _, val = entry.partition(e.kv_delim)
                out.append((k, val))
            else:
                out.append((entry, None))
        return out

    # ---- collections (arrays as lists, structs as dicts, maps as lists
    # of (key, value) pairs) ----
    def _eval_CreateArray(self, e, row):
        return [self.eval(c, row) for c in e.elems]

    def _eval_Size(self, e, row):
        v = self.eval(e.child, row)
        return -1 if v is None else len(v)

    def _eval_ArrayContains(self, e, row):
        a = self.eval(e.arr, row)
        v = self.eval(e.value, row)
        if a is None or v is None:
            return None
        k = ordkey(v)
        if any(ordkey(x) == k for x in a if x is not None):
            return True
        # Spark's three-valued logic: not found with a null element: NULL
        return None if any(x is None for x in a) else False

    def _eval_ElementAt(self, e, row):
        a = self.eval(e.arr, row)
        i = self.eval(e.index, row)
        if a is None or i is None:
            return None
        pos = i - 1 if i > 0 else len(a) + i
        return a[pos] if 0 <= pos < len(a) else None

    def _eval_GetArrayItem(self, e, row):
        a = self.eval(e.arr, row)
        i = self.eval(e.index, row)
        if a is None or i is None:
            return None
        return a[i] if 0 <= i < len(a) else None

    def _eval_SortArray(self, e, row):
        a = self.eval(e.child, row)
        if a is None:
            return None
        # Spark: nulls first ascending, last descending; NaN greatest
        nulls = [x for x in a if x is None]
        vals = sorted((x for x in a if x is not None), key=ordkey,
                      reverse=not e.ascending)
        return nulls + vals if e.ascending else vals + nulls

    def _eval_ArrayMin(self, e, row):
        a = self.eval(e.child, row)
        if a is None:
            return None
        vals = [x for x in a if x is not None]
        return min(vals, key=ordkey) if vals else None

    def _eval_ArrayMax(self, e, row):
        a = self.eval(e.child, row)
        if a is None:
            return None
        vals = [x for x in a if x is not None]
        return max(vals, key=ordkey) if vals else None

    def _eval_CreateStruct(self, e, row):
        names = e.names or tuple(f"col{i + 1}" for i in range(len(e.elems)))
        return {n: self.eval(x, row) for n, x in zip(names, e.elems)}

    def _eval_GetStructField(self, e, row):
        v = self.eval(e.child, row)
        if v is None:
            return None
        return list(v.values())[e.ordinal]

    def _eval_MapKeys(self, e, row):
        m = self.eval(e.child, row)
        return None if m is None else [k for k, _ in _map_pairs(m)]

    def _eval_MapValues(self, e, row):
        m = self.eval(e.child, row)
        if m is None:
            return None
        # a null string value reads as "", as on the device, whose array
        # layout has no per-element validity
        null = "" if e.dtype.children[0].kind is TypeKind.STRING else None
        return [null if v is None else v for _, v in _map_pairs(m)]

    def _eval_GetMapValue(self, e, row):
        m = self.eval(e.map, row)
        k = self.eval(e.key, row)
        if m is None or k is None:
            return None
        out = None
        for pk, pv in _map_pairs(m):     # the last match wins
            if pk == k:
                out = pv
        return out

    def _eval_MapContainsKey(self, e, row):
        m = self.eval(e.map, row)
        k = self.eval(e.key, row)
        if m is None or k is None:
            return None
        return any(pk == k for pk, _ in _map_pairs(m))

    def _eval_MapFromArrays(self, e, row):
        ks = self.eval(e.keys, row)
        vs = self.eval(e.values, row)
        if ks is None or vs is None:
            return None
        if len(ks) != len(vs):
            if self.ansi:
                raise AnsiError("[MAP_KEY_VALUE_LENGTH_MISMATCH] "
                                "map_from_arrays (ANSI mode)")
            return None             # the device nulls the row
        return list(zip(ks, vs))

    # ---- lambdas (a variable reads its binding by identity) ----
    def _eval_LambdaVariable(self, e, row):
        return self._lambda_bindings[id(e)]

    def _with_bindings(self, bindings, expr, row):
        old = self._lambda_bindings
        self._lambda_bindings = {**old, **bindings}
        try:
            return self.eval(expr, row)
        finally:
            self._lambda_bindings = old

    def _over_elems(self, e, row):
        a = self.eval(e.arr, row)
        if a is None:
            return None, None
        return a, [self._with_bindings({id(e.var): x}, e.body, row)
                   for x in a]

    def _eval_TransformArray(self, e, row):
        return self._over_elems(e, row)[1]

    def _eval_FilterArray(self, e, row):
        a, keep = self._over_elems(e, row)
        return None if a is None else [x for x, k in zip(a, keep) if k]

    def _eval_ExistsArray(self, e, row):
        a, hits = self._over_elems(e, row)
        return None if a is None else any(bool(h) for h in hits)

    def _eval_ForallArray(self, e, row):
        a, hits = self._over_elems(e, row)
        return None if a is None else all(bool(h) for h in hits)

    def _eval_AggregateArray(self, e, row):
        a = self.eval(e.arr, row)
        acc = self.eval(e.zero, row)
        if a is None:
            return None
        for x in a:
            acc = self._with_bindings(
                {id(e.acc_var): acc, id(e.elem_var): x}, e.merge, row)
        return acc

    # ---- set operations and shaping (equality through ``ordkey``: NaN
    # is one value, as on the device and in Spark) ----
    def _two_arrays(self, e, row):
        a, b = self.eval(e.left, row), self.eval(e.right, row)
        return (None, None) if a is None or b is None else (a, b)

    def _eval_ArrayDistinct(self, e, row):
        a = self.eval(e.child, row)
        return None if a is None else _distinct(a)

    def _eval_ArrayUnion(self, e, row):
        a, b = self._two_arrays(e, row)
        return None if a is None else _distinct(list(a) + list(b))

    def _eval_ArrayIntersect(self, e, row):
        a, b = self._two_arrays(e, row)
        if a is None:
            return None
        keys = {ordkey(x) for x in b}
        return [x for x in _distinct(a) if ordkey(x) in keys]

    def _eval_ArrayExcept(self, e, row):
        a, b = self._two_arrays(e, row)
        if a is None:
            return None
        keys = {ordkey(x) for x in b}
        return [x for x in _distinct(a) if ordkey(x) not in keys]

    def _eval_ArraysOverlap(self, e, row):
        a, b = self._two_arrays(e, row)
        if a is None:
            return None
        keys = {ordkey(x) for x in b}
        return any(ordkey(x) in keys for x in a)

    def _eval_ArrayRemove(self, e, row):
        a = self.eval(e.child, row)
        v = self.eval(e.value, row)
        if a is None or v is None:
            return None
        return [x for x in a if ordkey(x) != ordkey(v)]

    def _eval_ArrayPosition(self, e, row):
        a = self.eval(e.child, row)
        v = self.eval(e.value, row)
        if a is None or v is None:
            return None
        keys = [ordkey(x) for x in a]
        return keys.index(ordkey(v)) + 1 if ordkey(v) in keys else 0

    def _eval_ArrayRepeat(self, e, row):
        v = self.eval(e.value, row)
        n = self.eval(e.count, row)
        if n is None or v is None:
            # a null value: a null array, as on the device (which holds
            # no null element; Spark gives n nulls)
            return None
        return [v] * max(n, 0)

    def _eval_ArraySlice(self, e, row):
        a = self.eval(e.child, row)
        s = self.eval(e.start, row)
        ln = self.eval(e.length, row)
        if a is None or s is None or ln is None:
            return None
        if s == 0:
            raise AnsiError("[SLICE_START_ZERO] slice start is 0")
        if ln < 0:
            raise AnsiError("[SLICE_NEGATIVE_LENGTH] slice length < 0")
        begin = s - 1 if s > 0 else len(a) + s
        return [] if begin < 0 else list(a[begin:begin + ln])

    def _eval_Sequence(self, e, row):
        lo = self.eval(e.start, row)
        hi = self.eval(e.stop, row)
        st = self.eval(e.step, row) if e.step is not None else \
            (1 if lo is not None and hi is not None and hi >= lo else -1)
        if lo is None or hi is None or st is None or st == 0:
            return None     # a step of 0: null, as on the device
        if (st > 0 and hi < lo) or (st < 0 and hi > lo):
            return []       # against the direction: empty, as there
        count = (hi - lo) // st + 1
        if count > e.max_elems:
            from ..batch import CapacityError
            raise CapacityError(
                f"[CAPACITY_sequence_max_elems] a sequence of {count} "
                f"elements exceeds the budget of {e.max_elems}")
        return [lo + i * st for i in range(count)]

    def _eval_Flatten(self, e, row):
        v = self.eval(e.child, row)
        if v is None:
            return None
        out = []
        for sub in v:
            if sub is None:
                return None
            out.extend(sub)
        return out

    def _eval_ReplicateRows(self, e, row):
        n = self.eval(e.n, row)
        return None if n is None else list(range(max(int(n), 0)))

    def _eval_GetJsonObject(self, e, row):
        from ..expressions.json import JsonPathUnsupported, parse_json_path
        v = self.eval(e.child, row)
        p = self.eval(e.path, row)
        if v is None or p is None:
            return None
        try:
            steps = parse_json_path(p)
        except JsonPathUnsupported:
            return None
        return _json_extract(v.encode("utf-8"), steps)


def _distinct(a) -> list:
    """First occurrences in order, equal through ``ordkey``."""
    seen, out = set(), []
    for x in a:
        k = ordkey(x)
        if k not in seen:
            seen.add(k)
            out.append(x)
    return out


# ---------------------------------------------------------------------------
# get_json_object, a byte at a time, with the device's semantics: a nested
# value is its input span, blanks included, and a string holding a \uXXXX
# escape is null (the JAX handler goes through json.loads and gives
# Jackson's compact output and the decoded string, as Spark does)
# ---------------------------------------------------------------------------

_JSON_WS = b" \t\n\r"
_JSON_ESC = {ord("n"): ord("\n"), ord("t"): ord("\t"), ord("r"): ord("\r"),
             ord("b"): ord("\b"), ord("f"): ord("\f")}


def _json_marks(b: bytes):
    """(unescaped quote, outside a string, depth) per byte."""
    quote, outside, depth = [], [], []
    run = quotes = d = 0
    for ch in b:
        q = ch == 0x22 and run % 2 == 0
        out = quotes % 2 == 0
        quote.append(q)
        outside.append(out)
        if out and not q:
            d += (ch in b"{[") - (ch in b"}]")
        depth.append(d)
        quotes += q
        run = run + 1 if ch == 0x5C else 0
    return quote, outside, depth


def _json_trim(b: bytes) -> bytes:
    return b.strip(_JSON_WS)


def _json_step(b: bytes, step):
    """(value, is_string) of one path step, or None."""
    quote, outside, depth = _json_marks(b)
    n = len(b)
    if isinstance(step, int):
        if not b or b[0] != 0x5B:
            return None
        elem, picked = 0, []
        for j in range(n):
            comma = (b[j] == 0x2C and outside[j] and not quote[j]
                     and depth[j] == 1)
            if 1 <= j < n - 1 and elem == step and not comma:
                picked.append(j)
            elem += comma
        if not picked:
            return None
        return _json_trim(b[picked[0]:picked[-1] + 1]), False

    def nonblank(i):
        while i < n and b[i] in _JSON_WS:
            i += 1
        return i

    pat = b'"' + step.encode("utf-8") + b'"'
    for s in range(n):
        if b.startswith(pat, s) and quote[s] and outside[s] \
                and depth[s] == 1:
            p = nonblank(s + len(pat))
            if p < n and b[p] == 0x3A:
                break
    else:
        return None
    vs = nonblank(p + 1)
    if vs >= n:
        return None
    vd = depth[vs]
    if b[vs] == 0x22:
        ends = [j for j in range(vs + 1, n) if quote[j]]
        return (b[vs + 1:ends[0]], True) if ends else None
    after = range(vs + 1, n)
    if b[vs] in b"{[":
        ends = [j for j in after if outside[j] and not quote[j]
                and b[j] in b"}]" and depth[j] == vd - 1]
        return (_json_trim(b[vs:ends[0] + 1]) if ends else b""), False
    ends = [j for j in after if outside[j] and not quote[j] and (
        (b[j] == 0x2C and depth[j] == vd)
        or (b[j] in b"}]" and depth[j] == vd - 1))]
    return _json_trim(b[vs:ends[0] if ends else n]), False


def _json_extract(doc: bytes, steps):
    if not steps:
        return _json_trim(doc).decode("utf-8", "replace")
    cur, is_str = doc, False
    for step in steps:
        got = _json_step(cur, step)
        if got is None:
            return None
        cur, is_str = got
        if cur == b"null" and not is_str:
            return None
    if is_str:
        out, run = bytearray(), 0
        for ch in cur:
            if run % 2 == 1:                # an escaped byte
                if ch == 0x75:
                    return None             # \uXXXX: no device decoder
                out.append(_JSON_ESC.get(ch, ch))
            elif ch != 0x5C:
                out.append(ch)
            run = run + 1 if ch == 0x5C else 0
        cur = bytes(out)
    return cur.decode("utf-8", "replace")


# ---------------------------------------------------------------------------
# Scalar helpers of the cast, math and datetime handlers
# ---------------------------------------------------------------------------

#: the whitespace the device's string casts trim (UTF8String.trimAll)
_CAST_SPACE = " \t\n\x0b\x0c\r"
_LONG_RE = re.compile(r"([+-]?)(\d*)(?:\.(\d*))?", re.ASCII)
_DATE_RE = re.compile(r"(\d{4})(?:-(\d{1,2})(?:-(\d{1,2}))?)?", re.ASCII)


def _saturate(v: int, bits: int) -> int:
    lo, hi = -(1 << (bits - 1)), (1 << (bits - 1)) - 1
    return max(lo, min(hi, v))


def _trunc_saturate(v: float, bits: int) -> int:
    """A double to an integral type as the device converts it: truncated,
    NaN to 0, saturated at the type's range."""
    if math.isnan(v):
        return 0
    if math.isinf(v):
        return _saturate(1 << 64 if v > 0 else -(1 << 64), bits)
    return _saturate(math.trunc(v), bits)


def _float_to_int(v: float, bits: int) -> int:
    """A double cast to an integral type: into bigint the value is first
    held below 2^63 - 2^33, as the JAX package's cast clips it."""
    if bits == 64 and v < 2.0 ** 63:
        v = min(v, 2.0 ** 63 - 2.0 ** 33)
    return _trunc_saturate(v, bits)


def _f32(v: float) -> float:
    """The float32 nearest ``v`` (an infinity past float32's range)."""
    with np.errstate(all="ignore"):
        return float(np.float32(v))


def _micros(v: _dt.datetime) -> int:
    if v.tzinfo is None:
        v = v.replace(tzinfo=_dt.timezone.utc)
    return (v - _EPOCH_TS) // _dt.timedelta(microseconds=1)


def _decimal_float(v: _dec.Decimal, src: T.SqlType) -> float:
    """A decimal as the device makes it a double: its unscaled value over
    10^scale, in floating point."""
    return float(int(v.scaleb(src.scale))) / (10.0 ** src.scale)


def _parse_long(s: str):
    """Spark's non-ANSI string to bigint, as the device parses it:
    ``[+-]digits[.digits]`` (ASCII digits) inside the trimmed
    whitespace, the fraction dropped, at most 19 significant digits, in
    range; else None."""
    m = _LONG_RE.fullmatch(s.strip(_CAST_SPACE))
    if m is None:
        return None
    sign, whole, frac = m.groups()
    if not whole and not frac:
        return None
    if len(whole.lstrip("0")) > 19:
        return None
    n = int(whole or "0")
    n = -n if sign == "-" else n
    return n if -(1 << 63) <= n < (1 << 63) else None


def _parse_date(s: str):
    """Spark's string to date, ``yyyy[-M[-d]]``, as the device parses it."""
    m = _DATE_RE.fullmatch(s.strip(_CAST_SPACE))
    if m is None:
        return None
    y, mo, d = (int(g) if g else 1 for g in m.groups())
    if y < 1:
        return None
    try:
        return _dt.date(y, mo, d)
    except ValueError:
        return None


def _parse_ts_string(s: str):
    """Spark's string to timestamp (the JAX interpreter's; the device has
    none): ``yyyy-M-d[ T][H:m:s[.fraction]][zone]``, the zone Z, UTC or
    ±HH[:MM], the result on the UTC timeline."""
    if not s:
        return None
    offset_min = 0
    zm = re.search(r"(Z|UTC|[+-]\d{1,2}(?::?\d{2})?)\s*$", s)
    # a numeric offset is a zone only after a time: else "-04" is the
    # day field of a bare date
    if zm and (zm.group(1) in ("Z", "UTC") or ":" in s[:zm.start()]):
        z = zm.group(1)
        if z not in ("Z", "UTC"):
            m2 = re.fullmatch(r"([+-])(\d{1,2})(?::?(\d{2}))?", z)
            sign = -1 if m2.group(1) == "-" else 1
            offset_min = sign * (int(m2.group(2)) * 60
                                 + int(m2.group(3) or 0))
        s = s[:zm.start()].strip()
    sep = "T" if "T" in s else " "
    date_part, _, time_part = s.partition(sep)
    parts = date_part.split("-")
    if not 1 <= len(parts) <= 3 or len(parts[0]) != 4 or \
            any(not p.isdigit() for p in parts):
        return None
    try:
        base = _dt.datetime(int(parts[0]),
                            int(parts[1]) if len(parts) > 1 else 1,
                            int(parts[2]) if len(parts) > 2 else 1,
                            tzinfo=_dt.timezone.utc)
    except ValueError:
        return None
    shift = _dt.timedelta(minutes=offset_min)
    if not time_part:
        return base - shift
    frac = 0
    if "." in time_part:
        time_part, _, fs = time_part.partition(".")
        if not fs.isdigit() or len(fs) > 9:
            return None
        frac = int(fs.ljust(6, "0")[:6])
    tp = time_part.split(":")
    if not 1 <= len(tp) <= 3 or any(not x.isdigit() for x in tp):
        return None
    try:
        return base.replace(hour=int(tp[0]),
                            minute=int(tp[1]) if len(tp) > 1 else 0,
                            second=int(tp[2]) if len(tp) > 2 else 0,
                            microsecond=frac) - shift
    except ValueError:
        return None


def _spark_string_of(v) -> str:
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, float):
        if math.isnan(v):
            return "NaN"
        if math.isinf(v):
            return "Infinity" if v > 0 else "-Infinity"
        return repr(v)
    if isinstance(v, _dt.date) and not isinstance(v, _dt.datetime):
        return v.isoformat()
    return str(v)


def _cast_value(v, src: T.SqlType, to: T.SqlType):
    """One non-null value cast from ``src`` to ``to``. The pairs the device
    casts give the device's answer (floats to integers saturate, integers
    wrap, strings parse as ``_parse_long`` and ``_parse_date``); the pairs
    only the CPU casts (a string to a double, timestamp or decimal; a
    double, boolean or timestamp to a string) follow the JAX
    interpreter."""
    k = to.kind
    if k in _INT_BITS:
        bits = _INT_BITS[k]
        if isinstance(v, bool):
            return int(v)
        if isinstance(v, str):
            n = _parse_long(v)
            # out of the target's range: null, never wrapped
            return n if n is not None and \
                -(1 << (bits - 1)) <= n < 1 << (bits - 1) else None
        if isinstance(v, _dt.datetime):
            return _wrap(_micros(v) // 1_000_000, bits)
        if isinstance(v, _dt.date):
            return _wrap((v - _EPOCH).days, bits)
        if isinstance(v, _dec.Decimal):
            v = _decimal_float(v, src)
        if isinstance(v, float):
            return _float_to_int(v, bits)
        return _wrap(int(v), bits)
    if k in (TypeKind.FLOAT64, TypeKind.FLOAT32):
        if isinstance(v, str):
            f = float(v.strip())
        elif isinstance(v, _dt.datetime):
            f = float(_micros(v) // 1_000_000)
        elif isinstance(v, _dt.date):
            f = float((v - _EPOCH).days)
        elif isinstance(v, _dec.Decimal):
            f = _decimal_float(v, src)
        elif isinstance(v, int) and not isinstance(v, bool) and \
                k is TypeKind.FLOAT32:
            return float(np.float32(np.int64(v)))     # one rounding
        else:
            f = float(v)
        return _f32(f) if k is TypeKind.FLOAT32 else f
    if k is TypeKind.BOOLEAN:
        if isinstance(v, _dt.datetime):
            return _micros(v) != 0
        if isinstance(v, _dt.date):
            return v != _EPOCH
        if isinstance(v, str):
            return bool(v)          # the JAX interpreter's
        return v != 0
    if k is TypeKind.DATE:
        if isinstance(v, _dt.datetime):
            return _EPOCH + _dt.timedelta(days=_micros(v) // 86_400_000_000)
        if isinstance(v, _dt.date):
            return v
        if isinstance(v, str):
            return _parse_date(v)
        return _EPOCH + _dt.timedelta(days=_cast_value(v, src, T.INT32))
    if k is TypeKind.TIMESTAMP:
        if isinstance(v, _dt.datetime):
            return v
        if isinstance(v, _dt.date):
            return _dt.datetime(v.year, v.month, v.day,
                                tzinfo=_dt.timezone.utc)
        if isinstance(v, bool):
            # Spark's booleanToTimestamp: 1 microsecond for true
            return _EPOCH_TS + _dt.timedelta(microseconds=int(v))
        if isinstance(v, str):
            return _parse_ts_string(v.strip())
        if isinstance(v, _dec.Decimal):
            v = _decimal_float(v, src)
        # a number counts seconds; a double truncates to whole seconds
        secs = _trunc_saturate(v, 64) if isinstance(v, float) else int(v)
        return _EPOCH_TS + _dt.timedelta(
            microseconds=_wrap(secs * 1_000_000, 64))
    if k is TypeKind.DECIMAL:
        if isinstance(v, str):
            d = _dec.Decimal(v.strip())
        elif isinstance(v, float):
            d = _dec.Decimal(repr(v))
        elif isinstance(v, _dec.Decimal):
            d = v
        elif isinstance(v, _dt.datetime):
            d = _dec.Decimal(_micros(v))
        elif isinstance(v, _dt.date):
            d = _dec.Decimal((v - _EPOCH).days)
        else:
            d = _dec.Decimal(int(v))
        q = d.quantize(_dec.Decimal(1).scaleb(-to.scale),
                       rounding=_dec.ROUND_HALF_UP)
        # Spark nulls a value past the target's precision
        if abs(q) >= _dec.Decimal(10) ** (to.precision - to.scale):
            return None
        return q
    if k is TypeKind.STRING:
        return _spark_string_of(v)
    raise _later(f"cast to {to}")


def _np_call(fn, *args) -> float:
    """``fn`` of doubles through numpy's scalar functions, IEEE results
    (infinities, NaN) and no warnings."""
    with np.errstate(all="ignore"):
        return float(fn(*[np.float64(a) for a in args]))


_UNARY_MATH = {
    "sqrt": np.sqrt, "exp": np.exp, "expm1": np.expm1, "sin": np.sin,
    "cos": np.cos, "tan": np.tan, "asin": np.arcsin, "acos": np.arccos,
    "atan": np.arctan, "sinh": np.sinh, "cosh": np.cosh, "tanh": np.tanh,
    "asinh": np.arcsinh, "acosh": np.arccosh, "atanh": np.arctanh,
    "cbrt": np.cbrt, "rint": np.rint, "degrees": np.degrees,
    "radians": np.radians,
    "cot": lambda x: 1.0 / np.tan(x), "sec": lambda x: 1.0 / np.cos(x),
    "csc": lambda x: 1.0 / np.sin(x),
    "log": np.log, "log10": np.log10, "log2": np.log2, "log1p": np.log1p,
}
#: the logarithms' domain edges: input at or below is null (Spark)
_LOG_EDGE = {"log": 0.0, "log10": 0.0, "log2": 0.0, "log1p": -1.0}


def _civil_tuple(v):
    if isinstance(v, _dt.datetime):
        return (v.year, v.month, v.day, v.hour, v.minute, v.second,
                v.microsecond // 1000)
    return (v.year, v.month, v.day, 0, 0, 0, 0)


_MONTH_NAMES = ["January", "February", "March", "April", "May", "June",
                "July", "August", "September", "October", "November",
                "December"]
_WEEKDAY_NAMES = ["Monday", "Tuesday", "Wednesday", "Thursday", "Friday",
                  "Saturday", "Sunday"]


def _format_datetime(v, fmt: str):
    """A Java SimpleDateFormat-style formatter over more directives than
    the device's fixed-width set (EEEE, a single d or M, AM/PM), so that a
    pattern the device refuses still formats on the CPU."""
    y, m, d, hh, mi, ss, ms = _civil_tuple(v)
    if not 1 <= y <= 9999:
        return None
    day = v.date() if isinstance(v, _dt.datetime) else v
    wd, doy = day.weekday(), day.timetuple().tm_yday
    out = []
    i = 0
    while i < len(fmt):
        ch = fmt[i]
        if ch == "'":
            j = fmt.find("'", i + 1)
            if j < 0:
                return None
            out.append("'" if j == i + 1 else fmt[i + 1:j])
            i = j + 1
            continue
        if not ch.isalpha():
            out.append(ch)
            i += 1
            continue
        j = i
        while j < len(fmt) and fmt[j] == ch:
            j += 1
        w = j - i
        if ch == "y":
            out.append(str(y % 100).zfill(2) if w == 2 else str(y).zfill(w))
        elif ch == "M":
            out.append(_MONTH_NAMES[m - 1] if w >= 4
                       else _MONTH_NAMES[m - 1][:3] if w == 3
                       else str(m).zfill(w))
        elif ch in "dHmsDQ":
            val = {"d": d, "H": hh, "m": mi, "s": ss, "D": doy,
                   "Q": (m - 1) // 3 + 1}[ch]
            out.append(str(val).zfill(w))
        elif ch == "h":
            out.append(str((hh % 12) or 12).zfill(w))
        elif ch == "S":
            out.append(str(ms * 1000).zfill(6)[:w])
        elif ch == "E":
            out.append(_WEEKDAY_NAMES[wd] if w >= 4
                       else _WEEKDAY_NAMES[wd][:3])
        elif ch == "a":
            out.append("AM" if hh < 12 else "PM")
        else:
            raise _later(f"datetime pattern directive {ch * w!r}")
        i = j
    return "".join(out)


def _parse_datetime(v: str, fmt: str, out: str):
    """to_date / to_timestamp / unix_timestamp on one string: a regex from
    the pattern, numeric directives of width 1 matching 1-2 digits and
    wider ones exactly that many (Spark's CORRECTED parser), so a pattern
    the device refuses still parses on the CPU."""
    pat, fields = [], []
    i = 0
    while i < len(fmt):
        ch = fmt[i]
        if ch == "'":
            j = fmt.find("'", i + 1)
            if j < 0:
                return None
            pat.append(re.escape("'" if j == i + 1 else fmt[i + 1:j]))
            i = j + 1
            continue
        if not ch.isalpha():
            pat.append(re.escape(ch))
            i += 1
            continue
        j = i
        while j < len(fmt) and fmt[j] == ch:
            j += 1
        w = j - i
        if ch in "yMdHms":
            pat.append(r"(\d{1,2})" if w == 1 else r"(\d{%d})" % w)
            fields.append(ch)
        elif ch == "S":
            pat.append(r"(\d{%d})" % w)
            fields.append(("S", w))
        else:
            raise _later(f"datetime parse directive {ch * w!r}")
        i = j
    mt = re.fullmatch("".join(pat), v, re.ASCII)
    if not mt:
        return None
    vals = {"y": 1970, "M": 1, "d": 1, "H": 0, "m": 0, "s": 0}
    micros = 0
    for gi, ch in enumerate(fields):
        raw = int(mt.group(gi + 1))
        if isinstance(ch, tuple):       # a fraction of w digits
            w = ch[1]
            micros = raw * 10 ** (6 - w) if w <= 6 else raw // 10 ** (w - 6)
        else:
            vals[ch] = raw
    y, m, d = vals["y"], vals["M"], vals["d"]
    if y < 1 or not (1 <= m <= 12 and 1 <= d <= calendar.monthrange(y, m)[1]):
        return None
    if vals["H"] > 23 or vals["m"] > 59 or vals["s"] > 59:
        return None
    if out == "date":
        return _dt.date(y, m, d)
    ts = _dt.datetime(y, m, d, vals["H"], vals["m"], vals["s"], micros,
                      tzinfo=_dt.timezone.utc)
    if out == "unix":
        return _micros(ts) // 1_000_000
    return ts


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
    if name in ("CollectList", "CollectSet"):
        # the device's order: value-sorted, nulls skipped
        s = sorted(nn, key=ordkey)
        if name == "CollectSet":
            s = [x for i, x in enumerate(s)
                 if i == 0 or ordkey(s[i - 1]) != ordkey(x)]
        return s
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


def _pivot_first(a, grp: List, ev) -> list:
    """PivotFirst over one group: for each pivot value, the value of the
    first row whose pivot equals it (a null pivot matches None)."""
    out = []
    for pv in a.pivot_values:
        hit = None
        for r in grp:
            p = ev.eval(a.pivot, r)
            if p == pv or (p is None and pv is None):
                hit = ev.eval(a.child, r)
                break
        out.append(hit)
    return out


# ---------------------------------------------------------------------------
# Plans
# ---------------------------------------------------------------------------

def _pylist(c: pa.ChunkedArray) -> list:
    """A column's values as Python objects; a null-free integer, float or
    string column goes through numpy, which makes the same values faster.
    A timestamp with a zone is built here, on the UTC timeline, from its
    microseconds: pyarrow's own conversion looks the zone up for every
    value, which on some hosts costs a module search each time."""
    t = c.type
    if pa.types.is_timestamp(t) and t.tz is not None:
        us = c.cast(pa.timestamp("us", tz=t.tz)).cast(pa.int64())
        return [None if v is None else
                _EPOCH_TS + _dt.timedelta(microseconds=v)
                for v in _pylist(us)]
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
                if type(a).__name__ == "PivotFirst":
                    vals.append(_pivot_first(a, grp, ev))
                    continue
                if not a.children:
                    xs = None
                else:
                    xs = [ev.eval(a.child, r) for r in grp]
                vals.append(_agg_value(a, xs, len(grp)))
            out.append(raw + tuple(vals))
        return out

    def _exec_LogicalGenerate(self, p):
        rows, ev, bind = self._child(p)
        g = bind(p.generator)
        is_map = g.dtype.kind is TypeKind.MAP
        pad = (None, None) if is_map else (None,)
        out = []
        for r in rows:
            arr = ev.eval(g, r)
            if arr is None or len(arr) == 0:
                if p.outer:     # explode_outer: null pos, key and value
                    out.append(r + (None,) + pad if p.pos else r + pad)
                continue
            if is_map:
                for i, (k, v) in enumerate(_map_pairs(arr)):
                    out.append(r + (i, k, v) if p.pos else r + (k, v))
            else:
                for i, v in enumerate(arr):
                    out.append(r + (i, v) if p.pos else r + (v,))
        return out

    def _exec_LogicalWindow(self, p):
        rows, ev, bind = self._child(p)
        cols, layouts = [], {}
        for e in p.window_exprs:
            w = bind(e.child if isinstance(e, Alias) else e)
            cols.append(self._window_values(w, rows, ev, layouts))
        return [r + tuple(c[i] for c in cols) for i, r in enumerate(rows)]

    @staticmethod
    def _window_layout(spec, rows, ev):
        """The rows' indices cut into partitions, each in the spec's order,
        and every row's order key."""

        def okey(r):
            parts = []
            for o in spec.orders:
                v = ev.eval(o.child, r)
                if v is None:
                    parts.append((0 if o.effective_nulls_first else 2, ()))
                else:
                    k = ordkey(v)
                    parts.append((1, _NegKey(k)) if o.descending else (1, k))
            return tuple(parts)

        def pkey(r):
            return tuple((0, ()) if v is None else (1, ordkey(v))
                         for v in (ev.eval(e, r) for e in spec.partition_keys))

        pk = [pkey(r) for r in rows]
        ok = [okey(r) for r in rows]
        order = sorted(range(len(rows)), key=lambda i: (pk[i], ok[i]))
        parts: List[List[int]] = []
        for i in order:
            if parts and pk[parts[-1][0]] == pk[i]:
                parts[-1].append(i)
            else:
                parts.append([i])
        return parts, ok

    def _window_values(self, w, rows, ev, layouts: dict) -> list:
        """One window expression's value for every row, in row order: the
        rows sorted by (partition, order) keys and cut into partitions
        (once a spec, kept in ``layouts``), and the function computed over
        each partition as Spark defines it."""
        spec = w.spec
        key = (repr(spec.partition_keys), repr(spec.orders))
        if key not in layouts:
            layouts[key] = self._window_layout(spec, rows, ev)
        parts, ok = layouts[key]
        out: List[Any] = [None] * len(rows)
        fn = w.function
        name = type(fn).__name__
        frame = spec.frame
        # a value-bounded RANGE frame reads the order values: once a
        # partition
        by_value = (not frame.is_rows and not frame.is_full_partition
                    and not frame.is_running and len(spec.orders) == 1)
        for part in parts:
            m = len(part)
            okeys = [ok[i] for i in part]
            ovals = ([ev.eval(spec.orders[0].child, rows[x]) for x in part]
                     if by_value and name in ("NthValue", "WindowAgg")
                     else None)
            if name == "RowNumber":
                for j, i in enumerate(part):
                    out[i] = j + 1
            elif name in ("Rank", "PercentRank"):
                rank = dense = 0
                for j, i in enumerate(part):
                    if j == 0 or okeys[j] != okeys[j - 1]:
                        rank = j + 1
                        dense += 1
                    if name == "PercentRank":
                        out[i] = 0.0 if m <= 1 else (rank - 1) / (m - 1)
                    else:
                        out[i] = dense if fn.dense else rank
            elif name == "NTile":
                base, rem = m // fn.buckets, m % fn.buckets
                cut = rem * (base + 1)
                for j, i in enumerate(part):
                    out[i] = (j // (base + 1) if j < cut
                              else rem + (j - cut) // max(base, 1)) + 1
            elif name == "CumeDist":
                last = m - 1
                for j in range(m - 1, -1, -1):
                    if j < m - 1 and okeys[j] != okeys[j + 1]:
                        last = j
                    out[part[j]] = (last + 1) / m
            elif name == "NthValue":
                for j, i in enumerate(part):
                    lo, hi = self._frame_lo_hi(frame, spec, j, m, okeys,
                                               ovals)
                    ix = lo + fn.n - 1
                    out[i] = ev.eval(fn.child, rows[part[ix]]) \
                        if lo <= ix <= hi else None
            elif name == "LagLead":
                for j, i in enumerate(part):
                    src = j - fn.offset if fn.is_lag else j + fn.offset
                    if 0 <= src < m:
                        out[i] = ev.eval(fn.child, rows[part[src]])
                    elif fn.default is not None:
                        out[i] = ev.eval(fn.default, rows[i])
            elif name == "WindowAgg":
                a = fn.agg
                xs = ([ev.eval(a.children[0], rows[i]) for i in part]
                      if a.children else None)
                for j, i in enumerate(part):
                    lo, hi = self._frame_lo_hi(frame, spec, j, m, okeys,
                                               ovals)
                    if lo > hi:
                        lo, hi = 0, -1
                    out[i] = _agg_value(
                        a, None if xs is None else xs[lo:hi + 1],
                        max(hi - lo + 1, 0))
            else:
                raise _later(name)
        return out

    @staticmethod
    def _frame_lo_hi(frame, spec, j, m, okeys, ovals):
        """[lo, hi]: row j's frame as positions in its sorted partition. A
        value-bounded RANGE frame compares the shifted value (``ovals``:
        the partition's order values) with the partition's sort keys
        (``okeys``): a null takes its nulls-first or -last rank and a null
        row's bound is null, as in Spark's RangeBoundOrdering frame scan,
        which makes null rows positional members of an unbounded side."""
        if frame.is_full_partition:
            return 0, m - 1
        if frame.is_running and not frame.is_rows:
            hi = j
            while hi + 1 < m and okeys[hi + 1] == okeys[j]:
                hi += 1
            return 0, hi
        if frame.is_rows:
            lo = 0 if frame.start is None else j + frame.start
            hi = m - 1 if frame.end is None else j + frame.end
            return max(lo, 0), min(hi, m - 1)
        if len(spec.orders) != 1:
            raise ValueError(
                "value-bounded RANGE frames need exactly one order key")
        o0 = spec.orders[0]
        k = ovals[j]

        def bound_key(delta):
            """The sort key of the row's value shifted by ``delta``: the
            partition's keys are sorted, so the frame is a binary search."""
            if k is None:
                return ((0 if o0.effective_nulls_first else 2, ()),)
            if isinstance(k, _dt.datetime):     # offsets in microseconds
                delta = _dt.timedelta(microseconds=delta)
            elif isinstance(k, _dt.date):       # offsets in days
                delta = _dt.timedelta(days=delta)
            b = ordkey(k - delta if o0.descending else k + delta)
            return ((1, _NegKey(b) if o0.descending else b),)

        lo = 0 if frame.start is None else \
            bisect.bisect_left(okeys, bound_key(frame.start))
        hi = m - 1 if frame.end is None else \
            bisect.bisect_right(okeys, bound_key(frame.end)) - 1
        return lo, hi

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

