"""Three-valued-logic AND/OR.

Port of ``spark_rapids_tpu/expressions/boolean.py`` (Spark's GpuAnd/GpuOr,
Kleene logic):

AND: false if either side is false (even if the other is null);
     null if neither is false and either is null.
OR:  true if either side is true (even if the other is null);
     null if neither is true and either is null.
"""

from __future__ import annotations

from dataclasses import dataclass

from .. import types as T
from ..batch import DeviceColumn
from .base import EvalContext, Expression


@dataclass(frozen=True, eq=False)
class BinaryLogic(Expression):
    left: Expression
    right: Expression

    @property
    def children(self):
        return (self.left, self.right)

    def with_children(self, c):
        return type(self)(c[0], c[1])

    @property
    def dtype(self):
        return T.BOOLEAN


class And(BinaryLogic):
    def eval(self, batch, ctx=EvalContext()):
        l = self.left.eval(batch, ctx)
        r = self.right.eval(batch, ctx)
        l_false = l.validity & ~l.data
        r_false = r.validity & ~r.data
        valid = (l.validity & r.validity) | l_false | r_false
        data = l.data & r.data & valid
        return DeviceColumn(data, valid & batch.row_mask(), T.BOOLEAN)

    def __repr__(self):
        return f"({self.left!r} AND {self.right!r})"


class Or(BinaryLogic):
    def eval(self, batch, ctx=EvalContext()):
        l = self.left.eval(batch, ctx)
        r = self.right.eval(batch, ctx)
        l_true = l.validity & l.data
        r_true = r.validity & r.data
        valid = (l.validity & r.validity) | l_true | r_true
        data = (l_true | r_true) & valid
        return DeviceColumn(data, valid & batch.row_mask(), T.BOOLEAN)

    def __repr__(self):
        return f"({self.left!r} OR {self.right!r})"
