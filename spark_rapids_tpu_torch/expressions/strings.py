"""String predicates over fixed-width padded byte matrices.

Port of ``_window_match``, ``StringPredicate`` (contains, startswith,
endswith with a literal pattern) and the ``contains``/``startswith``/
``endswith`` helpers of ``spark_rapids_tpu/expressions/strings.py``. A
string column is ``uint8[rows, max_len]`` plus byte lengths, so search is a
shifted-window compare over every (row, start) pair at once: on a CUDA
tensor the hand-written kernel of ``kernels/string_search.py`` for every
pattern of 1 to ``max_len`` bytes, on a CPU tensor its plain version. The
rest of ``strings.py`` (substring, case mapping, concat, trim, locate,
replace, ...) comes with the expression-breadth slice.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from .. import types as T
from ..kernels.string_search import window_match
from .base import (EvalContext, Expression, Literal, lit_if_needed,
                   numeric_column)


def _window_match(data: torch.Tensor, lengths: torch.Tensor,
                  pat: bytes) -> torch.Tensor:
    """match[row, s] = pattern equals data[row, s:s+k] (k = len(pat))."""
    n, ml = data.shape
    k = len(pat)
    if k == 0:
        return torch.arange(ml, device=data.device)[None, :] \
            <= lengths[:, None]
    if k > ml:
        return torch.zeros((n, ml), dtype=torch.bool, device=data.device)
    return window_match(data.contiguous(), lengths.contiguous(), pat)


@dataclass(frozen=True, eq=False)
class StringPredicate(Expression):
    """contains / startswith / endswith with a literal pattern (Spark's
    GpuContains takes literal right-hand sides too)."""

    child: Expression
    pattern: Expression        # must be a Literal string
    op: str = "contains"       # contains | startswith | endswith

    @property
    def children(self):
        return (self.child, self.pattern)

    def with_children(self, c):
        return StringPredicate(c[0], c[1], self.op)

    @property
    def dtype(self):
        return T.BOOLEAN

    def _pat(self) -> bytes:
        if not isinstance(self.pattern, Literal):
            raise TypeError("string predicate pattern must be a literal")
        return str(self.pattern.value).encode("utf-8")

    def eval(self, batch, ctx=EvalContext()):
        c = self.child.eval(batch, ctx)
        p = self.pattern.eval(batch, ctx)
        validity = c.validity & p.validity
        pat = self._pat()
        k = len(pat)
        m = _window_match(c.data, c.lengths, pat)
        if self.op == "contains":
            r = m.any(dim=1) | (k == 0)
        elif self.op == "startswith":
            r = (m[:, 0] | (k == 0)) & (c.lengths >= k)
        elif self.op == "endswith":
            idx = (c.lengths - k).clamp(0, c.data.shape[1] - 1)
            r = (m.gather(1, idx[:, None].to(torch.int64))[:, 0]
                 | (k == 0)) & (c.lengths >= k)
        else:
            raise ValueError(f"unknown string predicate {self.op!r}")
        return numeric_column(r, validity, T.BOOLEAN)

    def __repr__(self):
        return f"{self.op}({self.child!r}, {self.pattern!r})"


def contains(e, pat):
    return StringPredicate(e, lit_if_needed(pat), "contains")


def startswith(e, pat):
    return StringPredicate(e, lit_if_needed(pat), "startswith")


def endswith(e, pat):
    return StringPredicate(e, lit_if_needed(pat), "endswith")
