"""DECIMAL128: decimals of 19 to 38 digits as four 32-bit limbs.

Port of ``spark_rapids_tpu/expressions/decimal128.py``. A decimal of more
than 18 digits stores its unscaled value as ``int64[cap, 4]``: four 32-bit
two's-complement limbs, least significant first, each in [0, 2^32) in its
own int64 lane, so l3 carries the sign. The headroom above each limb makes
segment sums exact without carries until one normalization at the end:
2^31 rows of (2^32 - 1) still fit int64, and integer addition is exact in
any order, so ``index_add_`` on the card gives the CPU's limbs bit for bit.
Order and comparison collapse the limbs to an (hi, lo) int64 pair whose
lexicographic signed order is the 128-bit order (``order_key_pair``); the
port's sort words are signed int64, so ``orderable_words128`` is that pair
itself, where the JAX package flips both into uint64.

Scope, as in the JAX package: storage, comparisons, sort and group order,
sum, min, max, first and last, add, subtract, negate, abs and small
rescales (at most 10^9). Multiplication, division and wide rescales are
refused by tagging and run on the row interpreter.

The host side reads and writes the Arrow ``decimal128`` buffer directly:
16 little-endian bytes a value are four uint32 limbs already
(``arrow_words`` and ``widen_words``, ``limbs_to_arrow``); no Python
``Decimal`` per row.
Every limb product and shift below stays inside int64 (the sign of hi and
lo comes from a multiplication by 2^32 of a value in [-2^31, 2^31), never
from a shift into the sign bit).
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import pyarrow as pa
import torch

from ..types import MAX_LONG_DIGITS, SqlType, TypeKind

MASK32 = (1 << 32) - 1
_TWO31 = 1 << 31
_TWO32 = 1 << 32


def is_dec128(t: SqlType) -> bool:
    return t.kind is TypeKind.DECIMAL and t.precision > MAX_LONG_DIGITS


# ---------------------------------------------------------------------------
# Host side
# ---------------------------------------------------------------------------

def to_limbs_np(unscaled: Sequence[int]) -> np.ndarray:
    """Python ints (signed, up to 128 bits) -> int64[n, 4] limbs."""
    raw = b"".join((int(v) & ((1 << 128) - 1)).to_bytes(16, "little")
                   for v in unscaled)
    return np.frombuffer(raw, np.uint32).reshape(-1, 4).astype(np.int64)


def from_limbs_np(mat: np.ndarray) -> List[int]:
    """int64[n, 4] limbs -> signed Python ints."""
    raw = np.ascontiguousarray(np.asarray(mat, np.int64) & MASK32
                               ).astype(np.uint32).tobytes()
    return [int.from_bytes(raw[16 * i:16 * i + 16], "little", signed=True)
            for i in range(len(raw) // 16)]


def arrow_words(arr: pa.Array) -> np.ndarray:
    """The value buffer of an Arrow decimal128 array as it stands, viewed
    as int32[n, 4] (the limbs' bits; no copy). Null slots hold whatever
    Arrow left there."""
    n = len(arr)
    if n == 0:
        return np.zeros((0, 4), np.int32)
    words = np.frombuffer(arr.buffers()[1], np.int32,
                          count=4 * (arr.offset + n))[4 * arr.offset:]
    return words.reshape(n, 4)


def widen_words(words: torch.Tensor, validity: torch.Tensor
                ) -> torch.Tensor:
    """int64 limbs of ``arrow_words``' int32 words (each read unsigned),
    null rows 0; runs where ``words`` lies, so an upload moves 16 bytes a
    row and widens on the card."""
    limbs = words.to(torch.int64) & MASK32
    return torch.where(validity[:, None], limbs, 0)


def limbs_to_arrow(limbs: np.ndarray, dtype: SqlType,
                   validity: np.ndarray) -> pa.Array:
    """Limbs as an Arrow decimal128 array of ``dtype``: each row's limbs
    are its 16 little-endian bytes, null slots zero. A valid value of more
    digits than the precision raises, as ``pa.array`` does."""
    over = validity & exceeds_digits(torch.from_numpy(limbs),
                                     dtype.precision).numpy()
    if over.any():
        raise pa.ArrowInvalid(
            f"{int(over.sum())} value(s) exceed the precision of {dtype}, "
            f"e.g. unscaled {from_limbs_np(limbs[over][:1])[0]}")
    words = np.where(validity[:, None], limbs & MASK32, 0).astype(np.uint32)
    return pa.Array.from_buffers(
        pa.decimal128(dtype.precision, dtype.scale), limbs.shape[0],
        [None if validity.all() else
         pa.py_buffer(np.packbits(validity, bitorder="little").tobytes()),
         pa.py_buffer(np.ascontiguousarray(words).tobytes())])


# ---------------------------------------------------------------------------
# Device side
# ---------------------------------------------------------------------------

def _limbs_of(value: int, like: torch.Tensor) -> torch.Tensor:
    """One value's limbs as an int64[4] tensor on ``like``'s device."""
    return torch.from_numpy(to_limbs_np([value])[0]).to(like.device)


def normalize(limbs: torch.Tensor) -> torch.Tensor:
    """Carry-propagate limb lanes back into [0, 2^32); the result is the
    value mod 2^128 (two's complement kept). The carry is an arithmetic
    shift, right for negative lanes."""
    out = []
    carry = torch.zeros(limbs.shape[:-1], dtype=torch.int64,
                        device=limbs.device)
    for j in range(4):
        v = limbs[..., j] + carry
        out.append(v & MASK32)
        carry = v >> 32
    return torch.stack(out, dim=-1)


def _signed32(x: torch.Tensor) -> torch.Tensor:
    """A limb in [0, 2^32) as the int32 value with its bits, in int64."""
    return x - ((x >> 31) << 32)


def order_key_pair(data: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) int64 words whose lexicographic signed order is the 128-bit
    order: hi is the signed top half, lo the bottom half with its sign bit
    flipped (biased by 2^63), so that signed order is unsigned order. Both
    are a multiple of 2^32 of a value in [-2^31, 2^31) plus a limb, which
    spans int64 exactly, with no shift into the sign bit."""
    l0, l1, l2, l3 = (data[..., j] for j in range(4))
    hi = _signed32(l3) * _TWO32 + l2
    lo = (l1 - _TWO31) * _TWO32 + l0
    return hi, lo


def orderable_words128(data: torch.Tensor) -> List[torch.Tensor]:
    """The sort words of a limb column, most significant first, in the
    port's convention (``exec/common.py`` ``orderable_words``: signed
    int64 compared as they are): the (hi, lo) pair."""
    return list(order_key_pair(data))


def from_key_pair(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """The limbs of an (hi, lo) pair (``order_key_pair``'s inverse)."""
    return torch.stack([lo & MASK32, ((lo >> 32) + _TWO31) & MASK32,
                        hi & MASK32, (hi >> 32) & MASK32], dim=-1)


def compare(a: torch.Tensor, b: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(lt, eq) bool tensors for two limb tensors."""
    ah, al = order_key_pair(a)
    bh, bl = order_key_pair(b)
    lt = (ah < bh) | ((ah == bh) & (al < bl))
    eq = (ah == bh) & (al == bl)
    return lt, eq


def is_negative(data: torch.Tensor) -> torch.Tensor:
    return data[..., 3] >= _TWO31


def sum_overflow(summed: torch.Tensor, n_neg: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(limbs, overflow) of raw per-limb sums and each sum's count of
    negative inputs. Each input is its value mod 2^128, so the lane sum
    decodes right iff the dropped carry out of the top limb equals the
    adjustment the encoding implies: with N negative inputs and carry C,
    the true sum is U + 2^128 (C - N), which fits signed 128 bits iff
    (C - N, top bit of U) is (0, 0) or (-1, 1). Spark nulls the sum on
    overflow (non-ANSI)."""
    out = []
    carry = torch.zeros(summed.shape[:-1], dtype=torch.int64,
                        device=summed.device)
    for j in range(4):
        v = summed[..., j] + carry
        out.append(v & MASK32)
        carry = v >> 32
    limbs = torch.stack(out, dim=-1)
    d = carry - n_neg
    top = is_negative(limbs)
    ok = ((d == 0) & ~top) | ((d == -1) & top)
    return limbs, ~ok


def seg_sum128(data: torch.Tensor, live: torch.Tensor, seg: torch.Tensor,
               num_groups: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sum limbs [num_groups, 4], overflow bool [num_groups]) of the rows
    where ``live``, row i going to group ``seg[i]``: one ``index_add_`` of
    the four limbs and one of the negative rows, then ``sum_overflow``."""
    x = torch.where(live[:, None], data, 0)
    neg = (live & is_negative(data)).to(torch.int64)
    s = torch.zeros((num_groups, 4), dtype=torch.int64, device=data.device)
    s.index_add_(0, seg, x)
    n = torch.zeros(num_groups, dtype=torch.int64, device=data.device)
    n.index_add_(0, seg, neg)
    return sum_overflow(s, n)


Reduce = Callable[[torch.Tensor, torch.Tensor, str], torch.Tensor]


def _scatter_reduce(seg: torch.Tensor, num_groups: int) -> Reduce:
    def reduce(x, ok, how):
        s = torch.where(ok, seg, num_groups)
        out = x.new_zeros(num_groups + 1)
        return out.scatter_reduce_(0, s, x, how,
                                   include_self=False)[:num_groups]
    return reduce


def seg_minmax128(data: torch.Tensor, live: torch.Tensor, seg: torch.Tensor,
                  num_groups: int, take_min: bool,
                  reduce: Optional[Reduce] = None) -> torch.Tensor:
    """Per-group min or max of limb rows: the best hi first, then the best
    lo among the rows at that hi (two passes of ``reduce(x, ok, how)``, a
    per-group amin/amax over the rows where ``ok``; by default a scatter
    over ``seg``). A group with no live row gives the limbs of (0, 0),
    which the caller masks by its validity."""
    reduce = reduce or _scatter_reduce(seg, num_groups)
    how = "amin" if take_min else "amax"
    hi, lo = order_key_pair(data)
    h = reduce(hi, live, how)
    at_best = live & (hi == h[seg])
    l = reduce(lo, at_best, how)
    return from_key_pair(h, l)


def lift64(x: torch.Tensor) -> torch.Tensor:
    """int64 unscaled values -> limbs (sign-extended)."""
    x = x.to(torch.int64)
    ext = (x < 0).to(torch.int64) * MASK32
    return torch.stack([x & MASK32, (x >> 32) & MASK32, ext, ext], dim=-1)


def exceeds_digits(data: torch.Tensor, digits: int = 38) -> torch.Tensor:
    """|value| >= 10^digits: Spark's precision overflow test, which nulls a
    result that still fits 128 bits. |-2^127| wraps to itself, and its
    sign bit, impossible for an absolute value, marks it as past any
    precision."""
    mag = abs128(data)
    limit = _limbs_of(10 ** digits, data).expand(mag.shape)
    lt, _ = compare(mag, limit)
    return is_negative(mag) | ~lt


def add128(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return normalize(a + b)


def neg128(data: torch.Tensor) -> torch.Tensor:
    """Two's complement: the inverted limbs plus one."""
    inv = (~data) & MASK32
    one = torch.zeros_like(data)
    one[..., 0] = 1
    return normalize(inv + one)


def abs128(data: torch.Tensor) -> torch.Tensor:
    return torch.where(is_negative(data)[..., None], neg128(data), data)


def rescale_up(data: torch.Tensor, factor: int) -> torch.Tensor:
    """``data * factor`` for factor <= 10^9 (scale alignment): each limb
    product stays under int64 (2^32 * 10^9 < 2^62), and the carries can
    pass 32 bits, so two normalizations."""
    assert factor <= 10 ** 9
    return normalize(normalize(data * factor))
