"""SQL types and their device storage dtypes.

Port of ``spark_rapids_tpu/types.py`` (``TypeKind``, ``SqlType``, the storage
map, the numeric promotion and the Arrow mapping) for the flat kinds:
BOOLEAN, INT8, INT16, INT32, INT64, FLOAT32, FLOAT64, DECIMAL, STRING, DATE,
TIMESTAMP and NULL. Nullability lives in a separate validity mask, never in
the storage dtype. Dates are epoch days in int32, timestamps epoch
microseconds in int64 (Arrow ``timestamp("us", tz="UTC")``), a decimal of
up to 18 digits its unscaled value in int64, a decimal of 19 to 38 digits
its unscaled value as four 32-bit limbs in ``int64[rows, 4]``
(``expressions/decimal128.py``), and NULL an int8 column that is always
null. A string column is a fixed-width padded UTF-8 byte matrix
``uint8[rows, max_len]`` plus int32 byte lengths; ``max_len`` is part of the
type.

The nested kinds (ARRAY, STRUCT, MAP) are a later slice.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass

import numpy as np
import pyarrow as pa
import torch


class TypeKind(enum.Enum):
    BOOLEAN = "boolean"
    INT8 = "tinyint"
    INT16 = "smallint"
    INT32 = "int"
    INT64 = "bigint"
    FLOAT32 = "float"
    FLOAT64 = "double"
    DECIMAL = "decimal"
    STRING = "string"
    DATE = "date"
    TIMESTAMP = "timestamp"
    NULL = "void"


_INTEGRALS = {TypeKind.INT8, TypeKind.INT16, TypeKind.INT32, TypeKind.INT64}
_FRACTIONALS = {TypeKind.FLOAT32, TypeKind.FLOAT64}

#: the most digits a decimal stored in int64 may have; past it, limbs
MAX_LONG_DIGITS = 18
#: the most digits of any decimal (Spark's DecimalType.MAX_PRECISION)
MAX_DECIMAL_DIGITS = 38

#: torch storage dtype per kind
_STORAGE = {
    TypeKind.BOOLEAN: torch.bool,
    TypeKind.INT8: torch.int8,
    TypeKind.INT16: torch.int16,
    TypeKind.INT32: torch.int32,
    TypeKind.INT64: torch.int64,
    TypeKind.FLOAT32: torch.float32,
    TypeKind.FLOAT64: torch.float64,
    TypeKind.DECIMAL: torch.int64,
    TypeKind.STRING: torch.uint8,
    TypeKind.DATE: torch.int32,
    TypeKind.TIMESTAMP: torch.int64,
    TypeKind.NULL: torch.int8,
}

_NUMPY = {
    TypeKind.BOOLEAN: np.dtype(np.bool_),
    TypeKind.INT8: np.dtype(np.int8),
    TypeKind.INT16: np.dtype(np.int16),
    TypeKind.INT32: np.dtype(np.int32),
    TypeKind.INT64: np.dtype(np.int64),
    TypeKind.FLOAT32: np.dtype(np.float32),
    TypeKind.FLOAT64: np.dtype(np.float64),
    TypeKind.DECIMAL: np.dtype(np.int64),
    TypeKind.STRING: np.dtype(np.uint8),
    TypeKind.DATE: np.dtype(np.int32),
    TypeKind.TIMESTAMP: np.dtype(np.int64),
    TypeKind.NULL: np.dtype(np.int8),
}

_ARROW = {
    TypeKind.BOOLEAN: pa.bool_(),
    TypeKind.INT8: pa.int8(),
    TypeKind.INT16: pa.int16(),
    TypeKind.INT32: pa.int32(),
    TypeKind.INT64: pa.int64(),
    TypeKind.FLOAT32: pa.float32(),
    TypeKind.FLOAT64: pa.float64(),
    TypeKind.STRING: pa.string(),
    TypeKind.DATE: pa.date32(),
    TypeKind.TIMESTAMP: pa.timestamp("us", tz="UTC"),
    TypeKind.NULL: pa.null(),
}


@dataclass(frozen=True)
class SqlType:
    """A SQL data type. Hashable; static metadata beside the tensors."""

    kind: TypeKind
    #: decimals: digits and digits after the point
    precision: int = 0
    scale: int = 0
    #: strings: the most UTF-8 bytes a value may take on the device
    max_len: int = 0

    @property
    def is_integral(self) -> bool:
        return self.kind in _INTEGRALS

    @property
    def is_fractional(self) -> bool:
        return self.kind in _FRACTIONALS

    @property
    def is_numeric(self) -> bool:
        return (self.is_integral or self.is_fractional
                or self.kind is TypeKind.DECIMAL)

    @property
    def storage_dtype(self) -> torch.dtype:
        """Storage dtype of the payload (the byte matrix for strings)."""
        return _STORAGE[self.kind]

    def __str__(self) -> str:
        if self.kind is TypeKind.DECIMAL:
            return f"decimal({self.precision},{self.scale})"
        if self.kind is TypeKind.STRING and self.max_len:
            return f"string[{self.max_len}]"
        return self.kind.value


BOOLEAN = SqlType(TypeKind.BOOLEAN)
INT8 = SqlType(TypeKind.INT8)
INT16 = SqlType(TypeKind.INT16)
INT32 = SqlType(TypeKind.INT32)
INT64 = SqlType(TypeKind.INT64)
FLOAT32 = SqlType(TypeKind.FLOAT32)
FLOAT64 = SqlType(TypeKind.FLOAT64)
DATE = SqlType(TypeKind.DATE)
TIMESTAMP = SqlType(TypeKind.TIMESTAMP)
NULL = SqlType(TypeKind.NULL)


def decimal(precision: int, scale: int) -> SqlType:
    """DECIMAL(precision, scale) of up to 38 digits: its unscaled value in
    int64 up to 18 digits, in four 32-bit limbs past that."""
    if not 0 <= scale <= precision <= MAX_DECIMAL_DIGITS:
        raise ValueError(f"decimal({precision},{scale}) out of range")
    return SqlType(TypeKind.DECIMAL, precision=precision, scale=scale)


def string(max_len: int = 64) -> SqlType:
    return SqlType(TypeKind.STRING, max_len=max_len)


_NUM_ORDER = [TypeKind.INT8, TypeKind.INT16, TypeKind.INT32, TypeKind.INT64,
              TypeKind.FLOAT32, TypeKind.FLOAT64]

#: Spark's DecimalType.forType: the digits of each integral type
INTEGRAL_DIGITS = {TypeKind.INT8: 3, TypeKind.INT16: 5, TypeKind.INT32: 10,
                   TypeKind.INT64: 20}


def common_numeric_type(a: SqlType, b: SqlType) -> SqlType:
    """Tightest common numeric type for binary arithmetic (Spark promotion,
    the JAX package's rules): integral and floating kinds widen along
    int8 < int16 < int32 < int64 < float < double; two decimals keep the
    larger scale and the larger integer part; a decimal with an integral
    type takes that type's digits (``INTEGRAL_DIGITS``); a decimal with a
    float or double gives double."""
    if a.kind is TypeKind.DECIMAL or b.kind is TypeKind.DECIMAL:
        if a.kind is TypeKind.DECIMAL and b.kind is TypeKind.DECIMAL:
            scale = max(a.scale, b.scale)
            prec = max(a.precision - a.scale, b.precision - b.scale) + scale
            return decimal(prec, scale)
        dec, other = (a, b) if a.kind is TypeKind.DECIMAL else (b, a)
        if other.is_fractional:
            return FLOAT64
        if other.kind not in INTEGRAL_DIGITS:
            raise TypeError(f"no common numeric type for {a}, {b}")
        prec = (max(dec.precision - dec.scale, INTEGRAL_DIGITS[other.kind])
                + dec.scale)
        return decimal(prec, dec.scale)
    if not (a.is_numeric and b.is_numeric):
        raise TypeError(f"no common numeric type for {a}, {b}")
    ia, ib = _NUM_ORDER.index(a.kind), _NUM_ORDER.index(b.kind)
    return SqlType(_NUM_ORDER[max(ia, ib)])


def numpy_dtype(t: SqlType) -> np.dtype:
    return _NUMPY[t.kind]


def from_arrow(arrow_type: pa.DataType, max_len: int = 64) -> SqlType:
    """Map a pyarrow DataType to a SqlType; strings (and large strings) get
    ``max_len`` bytes, every timestamp unit and zone maps to TIMESTAMP (the
    upload converts to UTC microseconds), and a decimal128 to DECIMAL(p, s).
    Nested types are a later slice."""
    if pa.types.is_string(arrow_type) or pa.types.is_large_string(arrow_type):
        return string(max_len)
    if pa.types.is_decimal(arrow_type):
        return decimal(arrow_type.precision, arrow_type.scale)
    if pa.types.is_timestamp(arrow_type):
        return TIMESTAMP
    if pa.types.is_dictionary(arrow_type):
        # dictionary encoding is a property of a column (dictenc.py), not
        # a type: dictionary<string> types as its value type
        return from_arrow(arrow_type.value_type, max_len)
    for kind, at in _ARROW.items():
        if arrow_type == at:
            return SqlType(kind)
    raise NotImplementedError(
        f"arrow type {arrow_type} has no device layout in the port yet: "
        f"nested types come with the collections slice")


def to_arrow(t: SqlType) -> pa.DataType:
    if t.kind is TypeKind.DECIMAL:
        return pa.decimal128(t.precision, t.scale)
    return _ARROW[t.kind]
