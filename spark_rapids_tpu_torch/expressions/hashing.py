"""Spark-compatible Murmur3 x86_32 and XXH64 row hashing.

Port of ``spark_rapids_tpu/expressions/hashing.py`` for every flat kind.
HashPartitioning is only compatible with Spark if the
murmur3 hash is bit-exact with ``org.apache.spark.unsafe.hash.Murmur3_x86_32``:

- int8/int16/int32/boolean/date -> hashInt(v), the value widened to int
- bigint/timestamp/decimal(<= 18) -> hashLong(v): low word, then high word
  (a decimal hashes its unscaled long, as Spark does up to 18 digits)
- decimal(> 18) -> hashUnsafeBytes of ``BigInteger.toByteArray`` of the
  unscaled value: its minimal big-endian two's-complement bytes, 1 to 16
  of them (``_hash_dec128``, torch ops over the four limbs, as the JAX
  package's are XLA ops)
- float  -> hashInt(floatToIntBits(v)) with -0.0 taken as 0.0 and every
  NaN as the canonical 0x7FC00000
- double -> hashLong(doubleToLongBits(v)) with -0.0 taken as 0.0 and every
  NaN as the canonical 0x7FF8000000000000
- string -> Spark's hashUnsafeBytes: 4-byte little-endian words, then each
  tail byte mixed as a signed int, then fmix with the byte length
- several columns fold left: hash = hash(col_i, seed=hash_so_far), from 42
- a null value (and every row of a NULL column) leaves the running hash
  unchanged

Hashes are int32 tensors holding the uint32 bits. On a CUDA tensor every
``hashInt`` runs the kernel of ``kernels/murmur3.py``; int8 and int16 keys
are widened to a contiguous int32 tensor for it.

XXH64 (Spark's ``XxHash64``, seed 42) follows the same kinds with
``hashInt``/``hashLong``/``hashUnsafeBytes`` of XXH64. The JAX package
computes it in uint64; torch has no uint64 arithmetic, so it runs in int64:
sums and products wrap mod 2^64 as uint64 ones do, and every logical right
shift masks off the copies of the sign bit that the arithmetic shift brings
in. The JAX package has no kernel for it, nor does the port.

Where the JAX package departs from Spark, the port follows Spark: the JAX
package hashes a float's raw bits (``bitcast_convert_type``), so a NaN
other than 0x7FC00000 hashes differently there; and it flushes subnormal
doubles to 0.0.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence, Tuple, Union

import torch

from .. import types as T
from ..batch import ColumnarBatch, DeviceColumn
from ..dictenc import decode_column, dict_entries_column, gather_entries
from ..kernels.murmur3 import fmix, mix_h1, murmur3_int32, to_int32, u32
from ..types import TypeKind
from .base import EvalContext, Expression

DEFAULT_SEED = 42

#: Java's Double.doubleToLongBits of every NaN
CANONICAL_NAN_BITS = 0x7FF8000000000000
#: Java's Float.floatToIntBits of every NaN
CANONICAL_FLOAT_NAN_BITS = 0x7FC00000

Seed = Union[int, torch.Tensor]


def _seeds(seed: Seed, like: torch.Tensor) -> torch.Tensor:
    if isinstance(seed, torch.Tensor):
        return seed.to(torch.int32).expand(like.shape).contiguous()
    bits = seed & 0xFFFFFFFF
    signed = bits - (1 << 32) if bits >= 1 << 31 else bits
    return torch.full(like.shape, signed, dtype=torch.int32,
                      device=like.device)


def hash_int(v: torch.Tensor, seed: Seed) -> torch.Tensor:
    """Murmur3_x86_32.hashInt over an int32 tensor."""
    v = v.to(torch.int32).contiguous()
    ones = torch.ones(v.shape, dtype=torch.bool, device=v.device)
    return murmur3_int32(v, ones, _seeds(seed, v))


def hash_long(v: torch.Tensor, seed: Seed) -> torch.Tensor:
    """Murmur3_x86_32.hashLong over an int64 tensor."""
    v = v.to(torch.int64)
    h = mix_h1(u32(_seeds(seed, v)), v & 0xFFFFFFFF)
    h = mix_h1(h, (v >> 32) & 0xFFFFFFFF)
    return to_int32(fmix(h, 8))


def double_bits(x: torch.Tensor) -> torch.Tensor:
    """int64 IEEE-754 bits of float64 values as Spark hashes them: -0.0 as
    0.0, every NaN as ``CANONICAL_NAN_BITS``. The JAX package extracts the
    bits arithmetically (a TPU has no 64-bit bitcast); here they are a
    view of the same bytes."""
    x = torch.where(x == 0.0, 0.0, x.to(torch.float64))
    return torch.where(torch.isnan(x), CANONICAL_NAN_BITS,
                       x.view(torch.int64))


def float_bits(x: torch.Tensor) -> torch.Tensor:
    """int32 IEEE-754 bits of float32 values as Spark hashes them: -0.0 as
    0.0, every NaN as ``CANONICAL_FLOAT_NAN_BITS``."""
    x = torch.where(x == 0.0, 0.0, x.to(torch.float32))
    return torch.where(torch.isnan(x), CANONICAL_FLOAT_NAN_BITS,
                       x.view(torch.int32))


def _hash_string(col: DeviceColumn, seed: torch.Tensor) -> torch.Tensor:
    """Spark hashUnsafeBytes over a padded byte matrix and its lengths, in
    torch ops (the JAX package has no kernel for it either). A value of L
    bytes mixes its L // 4 whole words and then its L % 4 < 4 tail bytes,
    so three gathered tail positions cover every row."""
    data, lengths = col.data, col.lengths.to(torch.int64)
    ml = data.shape[1]
    h = u32(seed)
    words = data[:, :ml // 4 * 4].to(torch.int64).reshape(-1, ml // 4, 4)
    words = (words[..., 0] | (words[..., 1] << 8) | (words[..., 2] << 16)
             | (words[..., 3] << 24))
    for w in range(ml // 4):
        h = torch.where(lengths >= 4 * (w + 1), mix_h1(h, words[:, w]), h)
    tail0 = lengths // 4 * 4
    for t in range(3):
        pos = tail0 + t
        byte = data.gather(1, pos.clamp(max=ml - 1)[:, None])[:, 0]
        signed = u32(byte.view(torch.int8))      # sign-extended, as Java
        h = torch.where(pos < lengths, mix_h1(h, signed), h)
    return to_int32(fmix(h, lengths))


def _be_bytes(limbs: torch.Tensor) -> torch.Tensor:
    """int64[n, 16]: the 16 big-endian bytes of each row's four limbs
    (column 0 the most significant)."""
    cols = []
    for j in range(16):
        li, sh = (15 - j) // 4, 8 * ((15 - j) % 4)
        cols.append((limbs[:, li] >> sh) & 0xFF)
    return torch.stack(cols, dim=1)


def _hash_dec128(col: DeviceColumn, seed: torch.Tensor) -> torch.Tensor:
    """Spark's murmur3 of a DECIMAL128 value: hashUnsafeBytes over the
    minimal big-endian two's-complement bytes of its unscaled value
    (``BigInteger.toByteArray``), whose count is the row's own:
    ``bitLength // 8 + 1``, one byte for 0 and -1. The bit length is that
    of v, or of ~v (each limb xor 0xFFFFFFFF) when v is negative, read
    from the highest nonzero limb's exponent as a double (exact below
    2^53). The row's bytes are gathered to the front, then its 4-byte
    words and at most three tail bytes mix predicated per row. Bit for
    bit Spark's, as the JAX package's ``_hash_dec128``; the scalar oracle
    is ``kernels.murmur3.hash_decimal``."""
    limbs = col.data
    neg = (limbs[:, 3] >> 31) == 1
    w = torch.where(neg[:, None], limbs ^ 0xFFFFFFFF, limbs)
    exp = torch.frexp(w.to(torch.float64)).exponent.to(torch.int64)
    offset = torch.arange(4, device=limbs.device) * 32
    bits = torch.where(w != 0, exp + offset, 0).amax(dim=1)
    n = bits // 8 + 1                                # 1..16 bytes
    idx = (16 - n)[:, None] + torch.arange(16, device=limbs.device)
    seq = _be_bytes(limbs).gather(1, idx.clamp(max=15))
    h = u32(seed)
    nwords = n // 4
    for wd in range(4):
        k = (seq[:, 4 * wd] | (seq[:, 4 * wd + 1] << 8)
             | (seq[:, 4 * wd + 2] << 16) | (seq[:, 4 * wd + 3] << 24))
        h = torch.where(wd < nwords, mix_h1(h, k), h)
    for t in range(3):                  # the tail: n % 4 < 4 bytes
        pos = nwords * 4 + t
        b = seq.gather(1, pos.clamp(max=15)[:, None])[:, 0]
        signed = torch.where(b > 127, b - 256, b) & 0xFFFFFFFF
        h = torch.where(pos < n, mix_h1(h, signed), h)
    return to_int32(fmix(h, n))


#: the kinds whose values Spark hashes with hashInt, through the
#: ``murmur3_int32`` kernel
INT32_HASHED_KINDS = (TypeKind.INT8, TypeKind.INT16, TypeKind.INT32,
                      TypeKind.DATE, TypeKind.BOOLEAN, TypeKind.FLOAT32)


def int32_words(col: DeviceColumn) -> torch.Tensor:
    """The contiguous int32 words ``murmur3_int32`` hashes for a column of
    one of ``INT32_HASHED_KINDS``: the value widened, or a float's bits."""
    if col.dtype.kind is TypeKind.FLOAT32:
        return float_bits(col.data).contiguous()
    return col.data.to(torch.int32).contiguous()


def hash_column(col: DeviceColumn, seed: Seed) -> torch.Tensor:
    """Hash one column with the running per-row seed; nulls keep the seed.
    A dictionary column decodes: the seed differs from row to row here,
    so a per-entry hash does not apply (``murmur3_batch`` takes it at the
    leading position)."""
    k = col.dtype.kind
    seed = _seeds(seed, col.validity)
    if col.dict_data is not None:
        col = decode_column(col)
    if k is TypeKind.NULL:
        return seed
    if k in INT32_HASHED_KINDS:
        return murmur3_int32(int32_words(col), col.validity.contiguous(),
                             seed)
    if k is TypeKind.DECIMAL and col.data.dim() > 1:    # DECIMAL128
        return torch.where(col.validity, _hash_dec128(col, seed), seed)
    if k in (TypeKind.INT64, TypeKind.TIMESTAMP, TypeKind.DECIMAL):
        return torch.where(col.validity, hash_long(col.data, seed), seed)
    if k is TypeKind.FLOAT64:
        return torch.where(col.validity,
                           hash_long(double_bits(col.data), seed), seed)
    if k is TypeKind.STRING:
        return torch.where(col.validity, _hash_string(col, seed), seed)
    raise NotImplementedError(f"hashing {col.dtype} columns is not ported")


def murmur3_batch(cols: Sequence[DeviceColumn],
                  seed: int = DEFAULT_SEED) -> torch.Tensor:
    """Row hash across columns (Spark's Murmur3Hash expression), as int32.
    A dictionary string column at the leading position hashes each entry
    once under the constant seed and gathers by code: bit for bit the
    hash of the decoded bytes, at card / n of the mixing."""
    h: Seed = seed
    for i, c in enumerate(cols):
        if i == 0 and c.dict_data is not None:
            ents = dict_entries_column(c)
            eh = _hash_string(ents, _seeds(seed, ents.validity))
            h = torch.where(c.validity, gather_entries(eh, c),
                            _seeds(seed, c.validity))
        else:
            h = hash_column(c, h)
    return h


@dataclass(frozen=True, eq=False)
class Murmur3Hash(Expression):
    """hash(cols...): Spark's int row hash, seed 42, never null; the
    ``hashInt`` of an int32-sized kind runs the ``murmur3_int32`` kernel on
    the card."""

    exprs: Tuple[Expression, ...]
    seed: int = DEFAULT_SEED

    @property
    def children(self):
        return self.exprs

    def with_children(self, c):
        return Murmur3Hash(tuple(c), self.seed)

    @property
    def dtype(self):
        return T.INT32

    @property
    def nullable(self):
        return False

    def eval(self, batch: ColumnarBatch, ctx=EvalContext()):
        h = murmur3_batch([e.eval(batch, ctx) for e in self.exprs],
                          self.seed)
        if not isinstance(h, torch.Tensor):
            h = _seeds(h, batch.row_mask())
        return DeviceColumn(h, batch.row_mask(), T.INT32)

    def __repr__(self):
        return f"murmur3({', '.join(map(repr, self.exprs))})"


def partition_ids(cols: Sequence[DeviceColumn],
                  num_partitions: int) -> torch.Tensor:
    """Spark HashPartitioning: pmod(murmur3(row), n), a floor-mod."""
    return torch.remainder(murmur3_batch(cols), num_partitions)


# ---------------------------------------------------------------------------
# XXH64 in int64 arithmetic
# ---------------------------------------------------------------------------

def _s64(u: int) -> int:
    """A uint64 constant as the int64 with the same bits."""
    return u - (1 << 64) if u >= 1 << 63 else u


XP1 = _s64(0x9E3779B185EBCA87)
XP2 = _s64(0xC2B2AE3D27D4EB4F)
XP3 = _s64(0x165667B19E3779F9)
XP4 = _s64(0x85EBCA77C2B2AE63)
XP5 = _s64(0x27D4EB2F165667C5)


def shr64(x: torch.Tensor, r: int) -> torch.Tensor:
    """Logical ``x >>> r`` of int64 bits, 0 < r < 64."""
    return (x >> r) & ((1 << (64 - r)) - 1)


def rotl64(x: torch.Tensor, r: int) -> torch.Tensor:
    return (x << r) | shr64(x, 64 - r)


def _xx_avalanche(h: torch.Tensor) -> torch.Tensor:
    h = (h ^ shr64(h, 33)) * XP2
    h = (h ^ shr64(h, 29)) * XP3
    return h ^ shr64(h, 32)


def _xx_seeds(seed: Seed, like: torch.Tensor) -> torch.Tensor:
    if isinstance(seed, torch.Tensor):
        return seed.to(torch.int64).expand(like.shape)
    return torch.full(like.shape, _s64(seed & (2 ** 64 - 1)),
                      dtype=torch.int64, device=like.device)


def xxhash64_long(v: torch.Tensor, seed: torch.Tensor) -> torch.Tensor:
    """XXH64.hashLong(v, seed) over int64 values and seeds."""
    h = seed + (XP5 + 8)
    h = h ^ (rotl64(v.to(torch.int64) * XP2, 31) * XP1)
    return _xx_avalanche(rotl64(h, 27) * XP1 + XP4)


def xxhash64_int(v: torch.Tensor, seed: torch.Tensor) -> torch.Tensor:
    """XXH64.hashInt(v, seed): the int's 32 bits, zero-extended."""
    h = seed + (XP5 + 4)
    h = h ^ (u32(v.to(torch.int32)) * XP1)
    return _xx_avalanche(rotl64(h, 23) * XP2 + XP3)


def _xxhash64_string(col: DeviceColumn, seed: torch.Tensor) -> torch.Tensor:
    """XXH64.hashUnsafeBytes over a padded byte matrix: 32-byte stripes
    through four accumulators, then 8-byte words, at most one 4-byte word
    and the tail bytes (unsigned), then the avalanche."""
    data, lengths = col.data, col.lengths.to(torch.int64)
    n, ml = data.shape
    # little-endian words of the matrix, as Spark's getLong/getInt read
    w8 = data[:, :ml // 8 * 8].contiguous().view(torch.int64)
    w4 = u32(data[:, :ml // 4 * 4].contiguous().view(torch.int32))
    v = [seed + _s64((XP1 + XP2) % (1 << 64)), seed + XP2, seed.clone(),
         seed - XP1]
    for s in range(ml // 32):
        use = lengths >= (s + 1) * 32
        for j in range(4):
            nv = rotl64(v[j] + w8[:, 4 * s + j] * XP2, 31) * XP1
            v[j] = torch.where(use, nv, v[j])
    h = (rotl64(v[0], 1) + rotl64(v[1], 7) + rotl64(v[2], 12)
         + rotl64(v[3], 18))
    for acc in v:
        h = (h ^ (rotl64(acc * XP2, 31) * XP1)) * XP1 + XP4
    h = torch.where(lengths >= 32, h, seed + XP5) + lengths
    stripe_end = lengths // 32 * 32
    word_end = stripe_end + (lengths - stripe_end) // 8 * 8
    for i in range(ml // 8):
        o = 8 * i
        use = (o >= stripe_end) & (o + 8 <= lengths)
        k1 = rotl64(w8[:, i] * XP2, 31) * XP1
        h = torch.where(use, rotl64(h ^ k1, 27) * XP1 + XP4, h)
    int_end = word_end + (lengths - word_end) // 4 * 4
    for i in range(ml // 4):
        o = 4 * i
        use = (o == word_end) & (o + 4 <= lengths)
        h = torch.where(use, rotl64(h ^ (w4[:, i] * XP1), 23) * XP2 + XP3,
                        h)
    for o in range(ml):
        use = (o >= int_end) & (o < lengths)
        b = data[:, o].to(torch.int64)
        h = torch.where(use, rotl64(h ^ (b * XP5), 11) * XP1, h)
    return _xx_avalanche(h)


def xxhash64_column(col: DeviceColumn, seed: Seed) -> torch.Tensor:
    """XXH64 of one column with the running per-row seed (int64 bits);
    nulls keep the seed."""
    k = col.dtype.kind
    seed = _xx_seeds(seed, col.validity)
    if col.dict_data is not None:
        col = decode_column(col)
    if k is TypeKind.NULL:
        return seed
    if k is TypeKind.STRING:
        h = _xxhash64_string(col, seed)
    elif k is TypeKind.DECIMAL and col.data.dim() > 1:
        # tagging refuses XxHash64 over limbs (its rule is the JAX one,
        # ALL_BASIC): the row interpreter answers, as in the JAX package
        raise NotImplementedError(
            f"xxhash64 of {col.dtype} runs on the row interpreter")
    elif k in (TypeKind.INT64, TypeKind.TIMESTAMP, TypeKind.DECIMAL):
        h = xxhash64_long(col.data, seed)
    elif k is TypeKind.FLOAT64:
        h = xxhash64_long(double_bits(col.data), seed)
    elif k is TypeKind.FLOAT32:
        h = xxhash64_int(float_bits(col.data), seed)
    elif k in (TypeKind.INT8, TypeKind.INT16, TypeKind.INT32, TypeKind.DATE,
               TypeKind.BOOLEAN):
        h = xxhash64_int(col.data, seed)
    else:
        raise NotImplementedError(
            f"xxhash64 of {col.dtype} columns is not ported")
    return torch.where(col.validity, h, seed)


@dataclass(frozen=True, eq=False)
class XxHash64(Expression):
    """xxhash64(cols...): Spark's bigint row hash, seed 42, never null."""

    exprs: Tuple[Expression, ...]
    seed: int = DEFAULT_SEED

    @property
    def children(self):
        return self.exprs

    def with_children(self, c):
        return XxHash64(tuple(c), self.seed)

    @property
    def dtype(self):
        return T.INT64

    @property
    def nullable(self):
        return False

    def eval(self, batch: ColumnarBatch, ctx=EvalContext()):
        h: Seed = self.seed
        for e in self.exprs:
            h = xxhash64_column(e.eval(batch, ctx), h)
        if not isinstance(h, torch.Tensor):
            h = _xx_seeds(h, batch.row_mask())
        return DeviceColumn(h, batch.row_mask(), T.INT64)

    def __repr__(self):
        return f"xxhash64({', '.join(map(repr, self.exprs))})"
