"""Spark-compatible Murmur3 x86_32 row hashing.

Port of ``spark_rapids_tpu/expressions/hashing.py`` for the fixed-width
kinds and strings. HashPartitioning is only compatible with Spark if this is
bit-exact with ``org.apache.spark.unsafe.hash.Murmur3_x86_32``:

- int/boolean/date -> hashInt(v)
- long             -> hashLong(v): low word, then high word
- double           -> hashLong(doubleToLongBits(v)) with -0.0 taken as 0.0
  and every NaN as the canonical 0x7FF8000000000000
- string           -> Spark's hashUnsafeBytes: 4-byte little-endian words,
  then each tail byte mixed as a signed int, then fmix with the byte length
- several columns fold left: hash = hash(col_i, seed=hash_so_far), from 42
- a null value leaves the running hash unchanged

Hashes are int32 tensors holding the uint32 bits. On a CUDA tensor every
``hashInt`` runs the kernel of ``kernels/murmur3.py``.
"""

from __future__ import annotations

from typing import Sequence, Union

import torch

from ..batch import DeviceColumn
from ..kernels.murmur3 import fmix, mix_h1, murmur3_int32, to_int32, u32
from ..types import TypeKind

DEFAULT_SEED = 42

#: Java's Double.doubleToLongBits of every NaN
CANONICAL_NAN_BITS = 0x7FF8000000000000

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


def hash_column(col: DeviceColumn, seed: Seed) -> torch.Tensor:
    """Hash one column with the running per-row seed; nulls keep the seed."""
    k = col.dtype.kind
    seed = _seeds(seed, col.validity)
    if k in (TypeKind.INT32, TypeKind.DATE, TypeKind.BOOLEAN):
        return murmur3_int32(col.data.to(torch.int32).contiguous(),
                             col.validity.contiguous(), seed)
    if k is TypeKind.INT64:
        return torch.where(col.validity, hash_long(col.data, seed), seed)
    if k is TypeKind.FLOAT64:
        return torch.where(col.validity,
                           hash_long(double_bits(col.data), seed), seed)
    if k is TypeKind.STRING:
        return torch.where(col.validity, _hash_string(col, seed), seed)
    raise NotImplementedError(
        f"hashing {col.dtype} columns is not ported yet: decimals come with "
        f"the decimal slice")


def murmur3_batch(cols: Sequence[DeviceColumn],
                  seed: int = DEFAULT_SEED) -> torch.Tensor:
    """Row hash across columns (Spark's Murmur3Hash expression), as int32."""
    h: Seed = seed
    for c in cols:
        h = hash_column(c, h)
    return h


def partition_ids(cols: Sequence[DeviceColumn],
                  num_partitions: int) -> torch.Tensor:
    """Spark HashPartitioning: pmod(murmur3(row), n), a floor-mod."""
    return torch.remainder(murmur3_batch(cols), num_partitions)
