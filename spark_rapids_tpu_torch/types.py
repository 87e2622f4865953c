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

The nested kinds keep the JAX package's fixed budgets: ARRAY and MAP carry
their element budget in ``max_len`` (``array(elem, max_elems)``,
``map_(key, value, max_elems)``) and their element types in ``children``;
a STRUCT carries its field types in ``children`` and their names in
``names``. Their device layouts are ``batch.py``'s.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Optional, Tuple

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
    ARRAY = "array"
    STRUCT = "struct"
    MAP = "map"


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
    #: strings: the most UTF-8 bytes a value may take on the device;
    #: arrays and maps: the most elements (entries) a row may hold
    max_len: int = 0
    #: nested kinds: the element types (array), key and value (map), or
    #: field types (struct)
    children: Tuple["SqlType", ...] = field(default_factory=tuple)
    #: struct field names, parallel to ``children``
    names: Tuple[str, ...] = field(default_factory=tuple)

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
    def is_string(self) -> bool:
        return self.kind is TypeKind.STRING

    @property
    def is_nested(self) -> bool:
        return self.kind in (TypeKind.ARRAY, TypeKind.STRUCT, TypeKind.MAP)

    @property
    def storage_dtype(self) -> torch.dtype:
        """Storage dtype of the payload (the byte matrix for strings)."""
        if self.kind not in _STORAGE:
            raise TypeError(f"no device storage for {self}")
        return _STORAGE[self.kind]

    def __str__(self) -> str:
        if self.kind is TypeKind.DECIMAL:
            return f"decimal({self.precision},{self.scale})"
        if self.kind is TypeKind.STRING and self.max_len:
            return f"string[{self.max_len}]"
        if self.kind is TypeKind.ARRAY:
            return f"array<{self.children[0]}>"
        if self.kind is TypeKind.MAP:
            return f"map<{self.children[0]},{self.children[1]}>"
        if self.kind is TypeKind.STRUCT:
            names = self.names or tuple(
                f"f{i}" for i in range(len(self.children)))
            inner = ", ".join(f"{n}: {c}"
                              for n, c in zip(names, self.children))
            return f"struct<{inner}>"
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


def array(elem: SqlType, max_elems: int = 256) -> SqlType:
    """array<elem> with a fixed element budget a row (``max_len``), the
    strategy strings take with their bytes."""
    return SqlType(TypeKind.ARRAY, max_len=max_elems, children=(elem,))


def struct(*fields: SqlType,
           names: Optional[Tuple[str, ...]] = None) -> SqlType:
    """struct<name: type, ...>: one set of lanes per field beside a struct
    validity lane (a null struct nulls every field)."""
    if names is None:
        names = tuple(f"f{i}" for i in range(len(fields)))
    if len(names) != len(fields):
        raise ValueError("struct names/fields length mismatch")
    return SqlType(TypeKind.STRUCT, children=tuple(fields),
                   names=tuple(names))


def map_(key: SqlType, value: SqlType, max_elems: int = 256) -> SqlType:
    """map<key,value> with a fixed entry budget: two zipped fixed-budget
    matrices (keys, values) sharing one lengths vector."""
    return SqlType(TypeKind.MAP, max_len=max_elems, children=(key, value))


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
    return _NUMPY.get(t.kind, np.dtype(np.uint8))


def from_arrow(arrow_type: pa.DataType, max_len: int = 64) -> SqlType:
    """Map a pyarrow DataType to a SqlType; strings (and large strings) get
    ``max_len`` bytes, every timestamp unit and zone maps to TIMESTAMP (the
    upload converts to UTC microseconds), a decimal128 to DECIMAL(p, s),
    and a list, struct or map to the nested kind of its children's types
    (arrays and maps with the default budget of 256)."""
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
    if pa.types.is_map(arrow_type):
        return map_(from_arrow(arrow_type.key_type, max_len),
                    from_arrow(arrow_type.item_type, max_len))
    if pa.types.is_list(arrow_type):
        return array(from_arrow(arrow_type.value_type, max_len))
    if pa.types.is_struct(arrow_type):
        return struct(*(from_arrow(f.type, max_len) for f in arrow_type),
                      names=tuple(f.name for f in arrow_type))
    for kind, at in _ARROW.items():
        if arrow_type == at:
            return SqlType(kind)
    raise NotImplementedError(
        f"arrow type {arrow_type} has no device layout in the port")


def to_arrow(t: SqlType) -> pa.DataType:
    if t.kind is TypeKind.DECIMAL:
        return pa.decimal128(t.precision, t.scale)
    if t.kind is TypeKind.ARRAY:
        return pa.list_(to_arrow(t.children[0]))
    if t.kind is TypeKind.MAP:
        return pa.map_(to_arrow(t.children[0]), to_arrow(t.children[1]))
    if t.kind is TypeKind.STRUCT:
        names = t.names or tuple(f"f{i}" for i in range(len(t.children)))
        return pa.struct([pa.field(n, to_arrow(c), nullable=True)
                          for n, c in zip(names, t.children)])
    return _ARROW[t.kind]
