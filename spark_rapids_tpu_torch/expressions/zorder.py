"""Z-order (Morton) keys for a clustered data layout.

Port of ``spark_rapids_tpu/expressions/zorder.py`` (reference:
sql-plugin/.../sql/rapids/zorder/, GpuInterleaveBits, used by Delta's
OPTIMIZE ZORDER BY). Interleaving the rank-preserving bits of the
clustering columns gives a space-filling-curve sort key; files written in
that order carry tight min/max statistics per column, so predicate
pushdown skips most of them.

The bit arithmetic runs on int64 with explicit masks: torch's uint64 has
no shift or bitwise kernels on CUDA in many builds. Each column's
rank-preserving 32-bit word sits in the low half of an int64; the key's
top bit lands in the sign, and flipping it makes signed order the
interleaving's unsigned order.

With one column the port's key is the column's 32-bit word (below the
flipped top bit); the JAX package asks for 64 bits of the 32-bit word and
raises ``OverflowError`` on its shift by 32 - 64.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch

from .. import types as T
from ..batch import DeviceColumn
from ..types import TypeKind
from .base import EvalContext, Expression, numeric_column

_U32 = 0xFFFFFFFF
_SIGN32 = 0x80000000


def orderable_u32(col: DeviceColumn) -> torch.Tensor:
    """int64 in [0, 2^32): a rank-preserving word of a numeric, date or
    boolean column, 0 for null (nulls lowest). A float or double rounds to
    float32 and orders by its bits (negative values inverted, positive
    ones with the sign bit set); an integer saturates into int32's range,
    which keeps the low bits of in-range values."""
    k = col.dtype.kind
    d = col.data
    if k in (TypeKind.FLOAT32, TypeKind.FLOAT64):
        u = d.to(torch.float32).view(torch.int32).to(torch.int64) & _U32
        v = torch.where(u & _SIGN32 != 0, ~u & _U32, u | _SIGN32)
    elif k is TypeKind.BOOLEAN:
        v = d.to(torch.int64)
    else:
        v = d.to(torch.int64).clamp(-(1 << 31), (1 << 31) - 1) + (1 << 31)
    return torch.where(col.validity, v.clamp(min=1), 0)


@dataclass(frozen=True, eq=False)
class InterleaveBits(Expression):
    """The Morton key of one to eight columns: each gives the top
    ``64 // k`` bits of its word (32 at most), bit-interleaved into one
    int64, column 0 the most significant of each group."""

    exprs: Tuple[Expression, ...]

    @property
    def children(self):
        return self.exprs

    def with_children(self, c):
        return InterleaveBits(tuple(c))

    @property
    def dtype(self):
        return T.INT64

    @property
    def nullable(self):
        return False

    def eval(self, batch, ctx=EvalContext()):
        cols = [e.eval(batch, ctx) for e in self.exprs]
        k = len(cols)
        if not 1 <= k <= 8:
            raise ValueError(f"interleave_bits takes 1 to 8 columns, got {k}")
        bits = min(64 // k, 32)
        out = torch.zeros(batch.capacity, dtype=torch.int64,
                          device=batch.device)
        for i, c in enumerate(cols):
            w = orderable_u32(c) >> (32 - bits)
            # bit b of column i (b from the word's least significant) lands
            # at b * k + (k - 1 - i)
            for b in range(bits):
                out |= ((w >> b) & 1) << (b * k + (k - 1 - i))
        out ^= torch.iinfo(torch.int64).min
        return numeric_column(out, batch.row_mask(), T.INT64)


def zorder_key(*exprs) -> InterleaveBits:
    return InterleaveBits(tuple(exprs))
