"""Cast, as far as the planner inserts it.

Port of ``Cast`` from ``spark_rapids_tpu/expressions/cast.py`` for the one
use the planner makes of it: a join whose key pair mixes integral widths
casts the narrower key to the wider type (``plan/overrides.py``
``_convert_join``), as Spark's analysis does. Widening an integral value
is exact: the value keeps its sign and magnitude, and nulls stay null.

Every other source and target pair (narrowing, floating point, decimal,
dates, timestamps, strings) raises ``NotImplementedError`` when the cast is
bound; the rest of the cast matrix comes with ROADMAP item 7.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..types import SqlType, TypeKind
from .base import EvalContext, Expression, numeric_column

_INTEGRAL_ORDER = {TypeKind.INT8: 0, TypeKind.INT16: 1, TypeKind.INT32: 2,
                   TypeKind.INT64: 3}


def is_integral_widening(src: SqlType, dst: SqlType) -> bool:
    """``src`` to ``dst`` is an integral type to one at least as wide."""
    return (src.kind in _INTEGRAL_ORDER and dst.kind in _INTEGRAL_ORDER
            and _INTEGRAL_ORDER[src.kind] <= _INTEGRAL_ORDER[dst.kind])


@dataclass(frozen=True, eq=False)
class Cast(Expression):
    child: Expression
    to: SqlType

    @property
    def children(self):
        return (self.child,)

    def with_children(self, c):
        return Cast(c[0], self.to)

    def bind(self, schema) -> "Cast":
        bound = Cast(self.child.bind(schema), self.to)
        src = bound.child.dtype
        if not is_integral_widening(src, self.to):
            raise NotImplementedError(
                f"cast {src} -> {self.to} is not in the port yet: it "
                f"casts integral types to wider ones (ROADMAP item 7 "
                f"brings the rest of the cast matrix)")
        return bound

    @property
    def dtype(self):
        return self.to

    @property
    def nullable(self):
        # declared as the JAX package declares every cast
        return True

    def eval(self, batch, ctx=EvalContext()):
        c = self.child.eval(batch, ctx)
        if self.child.dtype.kind is self.to.kind:
            return c
        return numeric_column(c.data.to(self.to.storage_dtype), c.validity,
                              self.to)

    def __repr__(self):
        return f"cast({self.child!r} as {self.to})"
