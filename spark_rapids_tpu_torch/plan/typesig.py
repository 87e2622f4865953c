"""TypeSig: per-operator supported-type signatures.

Port of ``spark_rapids_tpu/plan/typesig.py`` (reference: TypeChecks.scala's
``TypeSig`` algebra): each rule declares the SQL types it supports, and the
planner refuses a node whose types do not fit, with the reason recorded,
instead of failing at run time. The nested signatures are the JAX
package's: an array of scalars or strings, a map of scalars (or of
strings, ``StringToMap``'s layout), a struct of anything storable; a
nested element or map entry has no device layout.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import FrozenSet, Optional

from ..types import SqlType, TypeKind


@dataclass(frozen=True)
class TypeSig:
    kinds: FrozenSet[TypeKind] = frozenset()
    max_decimal_precision: int = 18     # DECIMAL64 on device
    max_string_bytes: int = 1 << 16     # padded-matrix budget
    notes: str = ""

    def __add__(self, other: "TypeSig") -> "TypeSig":
        return TypeSig(self.kinds | other.kinds,
                       max(self.max_decimal_precision,
                           other.max_decimal_precision),
                       max(self.max_string_bytes, other.max_string_bytes))

    def supports(self, t: SqlType) -> Optional[str]:
        """None if supported, else the human-readable reason it is not."""
        if t.kind not in self.kinds:
            return f"{t} is not supported"
        if t.kind is TypeKind.DECIMAL and \
                t.precision > self.max_decimal_precision:
            return (f"decimal precision {t.precision} exceeds device "
                    f"DECIMAL64 limit {self.max_decimal_precision}")
        if t.kind is TypeKind.STRING and t.max_len > self.max_string_bytes:
            return (f"string max_len {t.max_len} exceeds device budget "
                    f"{self.max_string_bytes}")
        if t.kind is TypeKind.ARRAY:
            # scalar elements: a 2D matrix; string elements: a 3D byte
            # tensor (split()'s layout); nested elements have no layout
            c = t.children[0]
            if c.kind in (TypeKind.ARRAY, TypeKind.STRUCT, TypeKind.MAP):
                return (f"{t} nested elements have no device layout")
        if t.kind is TypeKind.MAP:
            # string keys/values ride zero-padded [cap, E, ml] byte
            # tensors (StringToMap's layout); nested entries have no layout
            for c in t.children:
                if c.kind in (TypeKind.ARRAY, TypeKind.STRUCT,
                              TypeKind.MAP):
                    return (f"{t} nested map entries have no device "
                            f"layout")
        for c in t.children:
            r = self.supports(c)
            if r:
                return r
        return None


@dataclass(frozen=True)
class ParamSig:
    """One argument position's contract: admitted types and whether the
    argument must be a foldable literal. ``outer`` restricts the top-level
    kind separately from ``sig``."""

    name: str
    sig: "TypeSig"
    lit_required: bool = False
    outer: Optional["TypeSig"] = None

    def check(self, expr, dtype) -> Optional[str]:
        from ..expressions.base import Literal
        if self.lit_required and not isinstance(expr, Literal):
            return f"parameter '{self.name}' must be a literal"
        if self.outer is not None and dtype.kind not in self.outer.kinds:
            return f"parameter '{self.name}': {dtype} is not supported"
        r = self.sig.supports(dtype)
        if r:
            return f"parameter '{self.name}': {r}"
        return None


@dataclass(frozen=True)
class Params:
    """Positional parameter signatures for an expression rule: ``fixed``
    covers the leading arguments, ``repeat`` (if set) the rest."""

    fixed: tuple = ()
    repeat: Optional[ParamSig] = None

    def sig_for(self, i: int) -> Optional[ParamSig]:
        if i < len(self.fixed):
            return self.fixed[i]
        return self.repeat


def params(*fixed, repeat: Optional[ParamSig] = None) -> Params:
    return Params(tuple(fixed), repeat)


def p(name: str, sig: "TypeSig", lit: bool = False,
      outer: Optional["TypeSig"] = None) -> ParamSig:
    return ParamSig(name, sig, lit, outer)


def _sig(*kinds: TypeKind) -> TypeSig:
    return TypeSig(frozenset(kinds))


BOOLEAN = _sig(TypeKind.BOOLEAN)
INTEGRAL = _sig(TypeKind.INT8, TypeKind.INT16, TypeKind.INT32, TypeKind.INT64)
FP = _sig(TypeKind.FLOAT32, TypeKind.FLOAT64)
DECIMAL_64 = _sig(TypeKind.DECIMAL)
NUMERIC = INTEGRAL + FP + DECIMAL_64
STRING = _sig(TypeKind.STRING)
DATETIME = _sig(TypeKind.DATE, TypeKind.TIMESTAMP)
NULL = _sig(TypeKind.NULL)
ALL_BASIC = NUMERIC + BOOLEAN + STRING + DATETIME + NULL
ORDERABLE = ALL_BASIC       # everything basic sorts via key normalization
GROUPABLE = ALL_BASIC
#: fixed-budget arrays of scalar (or string) elements
ARRAY = _sig(TypeKind.ARRAY)
#: zipped key/value fixed-budget matrices
MAP = _sig(TypeKind.MAP)
#: one set of lanes per field plus a struct validity lane
STRUCT = _sig(TypeKind.STRUCT)
NESTED = _sig(TypeKind.ARRAY, TypeKind.STRUCT, TypeKind.MAP)
NONE = TypeSig()
#: DECIMAL128: four 32-bit limbs (``expressions/decimal128.py``). Adding
#: this sig raises a rule's decimal ceiling from DECIMAL64 to 38 digits
DECIMAL_128 = TypeSig(frozenset({TypeKind.DECIMAL}),
                      max_decimal_precision=38)
