"""Conditional expressions: if, CASE WHEN, coalesce, least and greatest.

Port of ``spark_rapids_tpu/expressions/conditional.py`` (reference:
conditionalExpressions.scala GpuIf, GpuCaseWhen, GpuCoalesce). Every
branch is evaluated and the rows pick between them with ``torch.where``,
as the JAX package's selects do: no host read, so a fused stage can
capture them in a CUDA graph.

The result takes the first value's type. Two string branches must have the
same byte width: the JAX package's select broadcasts the two byte
matrices and refuses two widths, and so does the port (``ValueError``);
``least``/``greatest`` over strings, which the JAX device cannot compare
either, raise likewise.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch

from ..batch import DeviceColumn
from ..types import TypeKind
from .base import EvalContext, Expression, Literal


def _select(pred: torch.Tensor, pred_valid: torch.Tensor, a: DeviceColumn,
            b: DeviceColumn) -> DeviceColumn:
    """Row-wise: ``a`` where the predicate is true, else ``b`` (a null
    predicate takes ``b``, as Spark's If does)."""
    take_a = pred & pred_valid
    validity = torch.where(take_a, a.validity, b.validity)
    if a.dtype.kind is TypeKind.STRING:
        wa, wb = a.data.shape[1], b.data.shape[1]
        if wa != wb:
            raise ValueError(
                f"conditional over string branches of {wa} and {wb} bytes: "
                f"the branches' byte matrices must have one width (the JAX "
                f"package's select refuses two as well)")
        data = torch.where(take_a[:, None], a.data, b.data)
        lengths = torch.where(take_a, a.lengths, b.lengths)
        return DeviceColumn(data, validity, a.dtype, lengths)
    return DeviceColumn(torch.where(take_a, a.data, b.data), validity,
                        a.dtype)


@dataclass(frozen=True, eq=False)
class If(Expression):
    predicate: Expression
    true_value: Expression
    false_value: Expression

    @property
    def children(self):
        return (self.predicate, self.true_value, self.false_value)

    def with_children(self, c):
        return If(c[0], c[1], c[2])

    @property
    def dtype(self):
        return self.true_value.dtype

    def eval(self, batch, ctx=EvalContext()):
        p = self.predicate.eval(batch, ctx)
        a = self.true_value.eval(batch, ctx)
        b = self.false_value.eval(batch, ctx)
        return _select(p.data, p.validity, a, b)

    def __repr__(self):
        return f"if({self.predicate!r}, {self.true_value!r}, " \
            f"{self.false_value!r})"


@dataclass(frozen=True, eq=False)
class CaseWhen(Expression):
    """CASE WHEN p1 THEN v1 ... ELSE e END; ``branches`` is ((p, v), ...)."""

    branches: Tuple[Tuple[Expression, Expression], ...]
    else_value: Expression = None  # type: ignore

    @property
    def children(self):
        cs = []
        for p, v in self.branches:
            cs += [p, v]
        if self.else_value is not None:
            cs.append(self.else_value)
        return tuple(cs)

    def with_children(self, c):
        n = len(self.branches)
        branches = tuple((c[2 * i], c[2 * i + 1]) for i in range(n))
        els = c[2 * n] if self.else_value is not None else None
        return CaseWhen(branches, els)

    @property
    def dtype(self):
        return self.branches[0][1].dtype

    def eval(self, batch, ctx=EvalContext()):
        els = self.else_value
        if els is None or (isinstance(els, Literal)
                           and els.dtype.kind is TypeKind.NULL):
            els = Literal.of(None, self.dtype)
        result = els.eval(batch, ctx)
        # folded right to left, so the first true predicate wins
        for p, v in reversed(self.branches):
            pc = p.eval(batch, ctx)
            vc = v.eval(batch, ctx)
            result = _select(pc.data, pc.validity, vc, result)
        return result

    def __repr__(self):
        parts = " ".join(f"WHEN {p!r} THEN {v!r}" for p, v in self.branches)
        return f"CASE {parts} ELSE {self.else_value!r} END"


@dataclass(frozen=True, eq=False)
class Coalesce(Expression):
    exprs: Tuple[Expression, ...]

    @property
    def children(self):
        return self.exprs

    def with_children(self, c):
        return Coalesce(tuple(c))

    @property
    def dtype(self):
        return self.exprs[0].dtype

    @property
    def nullable(self):
        return all(e.nullable for e in self.exprs)

    def eval(self, batch, ctx=EvalContext()):
        cols = [e.eval(batch, ctx) for e in self.exprs]
        result = cols[-1]
        for c in reversed(cols[:-1]):
            result = _select(c.validity, torch.ones_like(c.validity), c,
                             result)
        return result

    def __repr__(self):
        return f"coalesce({', '.join(map(repr, self.exprs))})"


@dataclass(frozen=True, eq=False)
class LeastGreatest(Expression):
    """least()/greatest(): nulls are skipped, and the result is null only
    where every value is (Spark). NaN compares false both ways, as in the
    JAX package: a NaN stays where it came first."""

    exprs: Tuple[Expression, ...]
    greatest: bool = False

    @property
    def children(self):
        return self.exprs

    def with_children(self, c):
        return LeastGreatest(tuple(c), self.greatest)

    @property
    def dtype(self):
        return self.exprs[0].dtype

    def eval(self, batch, ctx=EvalContext()):
        cols = [e.eval(batch, ctx) for e in self.exprs]
        if any(c.dtype.kind is TypeKind.STRING for c in cols):
            raise ValueError(
                "least/greatest over strings has no device path (the JAX "
                "package's row-wise compare refuses byte matrices too)")
        best = cols[0]
        for c in cols[1:]:
            if self.greatest:
                better = (c.data > best.data) & c.validity
            else:
                better = (c.data < best.data) & c.validity
            pick_c = (better & best.validity) | (c.validity & ~best.validity)
            best = _select(pick_c, torch.ones_like(pick_c), c, best)
        return best
