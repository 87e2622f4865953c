"""SQL types and their device storage dtypes.

Port of ``spark_rapids_tpu/types.py`` (``TypeKind``, ``SqlType``, the storage
map and the Arrow mapping), cut to the kinds the port carries so far: INT32,
INT64, FLOAT64, BOOLEAN, DATE and STRING. Nullability lives in a separate
validity mask, never in the storage dtype; dates are epoch days in int32.
A string column is a fixed-width padded UTF-8 byte matrix
``uint8[rows, max_len]`` plus int32 byte lengths; ``max_len`` is part of the
type.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass

import numpy as np
import pyarrow as pa
import torch


class TypeKind(enum.Enum):
    BOOLEAN = "boolean"
    INT32 = "int"
    INT64 = "bigint"
    FLOAT64 = "double"
    DATE = "date"
    STRING = "string"


_INTEGRALS = {TypeKind.INT32, TypeKind.INT64}

#: torch storage dtype per kind
_STORAGE = {
    TypeKind.BOOLEAN: torch.bool,
    TypeKind.INT32: torch.int32,
    TypeKind.INT64: torch.int64,
    TypeKind.FLOAT64: torch.float64,
    TypeKind.DATE: torch.int32,
    TypeKind.STRING: torch.uint8,
}

_NUMPY = {
    TypeKind.BOOLEAN: np.dtype(np.bool_),
    TypeKind.INT32: np.dtype(np.int32),
    TypeKind.INT64: np.dtype(np.int64),
    TypeKind.FLOAT64: np.dtype(np.float64),
    TypeKind.DATE: np.dtype(np.int32),
    TypeKind.STRING: np.dtype(np.uint8),
}

_ARROW = {
    TypeKind.BOOLEAN: pa.bool_(),
    TypeKind.INT32: pa.int32(),
    TypeKind.INT64: pa.int64(),
    TypeKind.FLOAT64: pa.float64(),
    TypeKind.DATE: pa.date32(),
    TypeKind.STRING: pa.string(),
}


@dataclass(frozen=True)
class SqlType:
    """A SQL data type. Hashable; static metadata beside the tensors."""

    kind: TypeKind
    #: strings: the most UTF-8 bytes a value may take on the device
    max_len: int = 0

    @property
    def is_integral(self) -> bool:
        return self.kind in _INTEGRALS

    @property
    def is_fractional(self) -> bool:
        return self.kind is TypeKind.FLOAT64

    @property
    def is_numeric(self) -> bool:
        return self.is_integral or self.is_fractional

    @property
    def storage_dtype(self) -> torch.dtype:
        """Storage dtype of the payload (the byte matrix for strings)."""
        return _STORAGE[self.kind]

    def __str__(self) -> str:
        if self.kind is TypeKind.STRING and self.max_len:
            return f"string[{self.max_len}]"
        return self.kind.value


BOOLEAN = SqlType(TypeKind.BOOLEAN)
INT32 = SqlType(TypeKind.INT32)
INT64 = SqlType(TypeKind.INT64)
FLOAT64 = SqlType(TypeKind.FLOAT64)
DATE = SqlType(TypeKind.DATE)


def string(max_len: int = 64) -> SqlType:
    return SqlType(TypeKind.STRING, max_len=max_len)

_NUM_ORDER = [TypeKind.INT32, TypeKind.INT64, TypeKind.FLOAT64]


def common_numeric_type(a: SqlType, b: SqlType) -> SqlType:
    """Tightest common numeric type for binary arithmetic (Spark promotion)."""
    if not (a.is_numeric and b.is_numeric):
        raise TypeError(f"no common numeric type for {a}, {b}")
    ia, ib = _NUM_ORDER.index(a.kind), _NUM_ORDER.index(b.kind)
    return SqlType(_NUM_ORDER[max(ia, ib)])


def numpy_dtype(t: SqlType) -> np.dtype:
    return _NUMPY[t.kind]


def from_arrow(arrow_type: pa.DataType, max_len: int = 64) -> SqlType:
    """Map a pyarrow DataType to a SqlType; strings (and large strings) get
    ``max_len`` bytes. Other types are later slices."""
    if pa.types.is_string(arrow_type) or pa.types.is_large_string(arrow_type):
        return string(max_len)
    if pa.types.is_dictionary(arrow_type):
        raise NotImplementedError(
            f"arrow type {arrow_type}: dictionary-encoded columns come with "
            f"the dictionary-encoding slice (dictenc); decode them first")
    for kind, at in _ARROW.items():
        if arrow_type == at:
            return SqlType(kind)
    raise NotImplementedError(
        f"arrow type {arrow_type} has no device layout in the port yet: "
        f"decimals come with the decimal slice, other widths with the "
        f"expression-breadth slice")


def to_arrow(t: SqlType) -> pa.DataType:
    return _ARROW[t.kind]
