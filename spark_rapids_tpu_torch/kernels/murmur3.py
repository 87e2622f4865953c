"""Murmur3 ``hashInt`` row-hash kernel: the CUDA wrapper and its plain version.

Port of ``pallas_murmur3_int32`` (``spark_rapids_tpu/kernels/murmur3.py``):
Spark Murmur3_x86_32 over an int32 column with per-row seeds (the running
fold-left hash of ``expressions/hashing.py``); a null row passes its seed
through. The kernel is ``csrc/murmur3.cu``; ``murmur3_int32`` launches it
for CUDA tensors and runs ``murmur3_int32_plain`` for CPU tensors.

The plain version and the uint32 helpers compute in int64 masked to 32 bits:
torch has no general uint32 arithmetic, and ``>>`` on int32 is arithmetic,
not logical. Products are split into 16-bit halves so no int64 product
overflows.
"""

from __future__ import annotations

import ctypes
from typing import Union

import torch

M32 = 0xFFFFFFFF
C1 = 0xCC9E2D51
C2 = 0x1B873593
N = 0xE6546B64


def u32(t: torch.Tensor) -> torch.Tensor:
    """Bits of an int32 (or the low word of an int64) as int64 in [0, 2^32)."""
    return t.to(torch.int64) & M32


def to_int32(x: torch.Tensor) -> torch.Tensor:
    """int64 in [0, 2^32) -> the int32 with the same bits."""
    return (x - ((x >> 31) << 32)).to(torch.int32)


def mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for x in [0, 2^32) and a constant c < 2^32."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & M32


def rotl32(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & M32


def mix_k1(k1: torch.Tensor) -> torch.Tensor:
    return mul32(rotl32(mul32(k1, C1), 15), C2)


def mix_h1(h1: torch.Tensor, k1: torch.Tensor) -> torch.Tensor:
    h1 = rotl32(h1 ^ mix_k1(k1), 13)
    return (h1 * 5 + N) & M32


def fmix(h1: torch.Tensor,
         length: Union[int, torch.Tensor]) -> torch.Tensor:
    """Murmur3's finalizer; ``length`` is the hashed byte count, one int or
    a per-row tensor of counts (int64 in [0, 2^32))."""
    h1 = h1 ^ length
    h1 = mul32(h1 ^ (h1 >> 16), 0x85EBCA6B)
    h1 = mul32(h1 ^ (h1 >> 13), 0xC2B2AE35)
    return h1 ^ (h1 >> 16)


def murmur3_int32_plain(data: torch.Tensor, validity: torch.Tensor,
                        seeds: torch.Tensor) -> torch.Tensor:
    """hashInt per row in plain torch: int32[n], bool[n], int32[n] -> int32[n]."""
    s = u32(seeds)
    h = fmix(mix_h1(s, u32(data)), 4)
    return to_int32(torch.where(validity, h, s))


def _check(data, validity, seeds) -> None:
    for name, t, dt in (("data", data, torch.int32),
                        ("validity", validity, torch.bool),
                        ("seeds", seeds, torch.int32)):
        if t.dtype != dt or t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"murmur3_int32: {name} must be a contiguous "
                             f"1-D {dt} tensor, got {t.dtype} "
                             f"{tuple(t.shape)}")
        if t.device != data.device:
            raise ValueError("murmur3_int32: inputs on different devices")
    if not data.shape[0] == validity.shape[0] == seeds.shape[0]:
        raise ValueError("murmur3_int32: inputs differ in length")


_lib = None


def _kernel() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        from .build import load
        lib = load("murmur3")
        lib.murmur3_int32.argtypes = [ctypes.c_void_p] * 4 + [
            ctypes.c_int64, ctypes.c_void_p]
        lib.murmur3_int32.restype = ctypes.c_int
        _lib = lib
    return _lib


def murmur3_int32(data: torch.Tensor, validity: torch.Tensor,
                  seeds: torch.Tensor) -> torch.Tensor:
    """hashInt per row with per-row seeds; null rows keep their seed.

    CPU tensors take the plain version. CUDA tensors launch the kernel, and
    a launch that fails raises: there is no fallback."""
    _check(data, validity, seeds)
    if data.device.type == "cpu":
        return murmur3_int32_plain(data, validity, seeds)
    if data.device.type != "cuda":
        raise ValueError(f"murmur3_int32: no kernel for {data.device}")
    n = data.shape[0]
    out = torch.empty_like(data)
    if n == 0:
        return out
    lib = _kernel()
    with torch.cuda.device(data.device):
        stream = torch.cuda.current_stream(data.device).cuda_stream
        rc = lib.murmur3_int32(data.data_ptr(), validity.data_ptr(),
                               seeds.data_ptr(), out.data_ptr(), n, stream)
    if rc != 0:
        raise RuntimeError(f"murmur3_int32 kernel launch failed: CUDA "
                           f"error {rc}")
    murmur3_int32.launches += 1
    return out


#: kernel launches since the count was last set to 0
murmur3_int32.launches = 0


# ---------------------------------------------------------------------------
# Scalar Murmur3 over Python ints: the row interpreter's hashes, and the
# oracle of the DECIMAL128 hash
# ---------------------------------------------------------------------------

def _scalar_rotl(x: int, r: int) -> int:
    return ((x << r) | (x >> (32 - r))) & M32


def _scalar_mix(h1: int, k1: int) -> int:
    k1 = (_scalar_rotl((k1 * C1) & M32, 15) * C2) & M32
    h1 = _scalar_rotl(h1 ^ k1, 13)
    return (h1 * 5 + N) & M32


def _scalar_fmix(h1: int, length: int) -> int:
    h1 ^= length
    h1 = ((h1 ^ (h1 >> 16)) * 0x85EBCA6B) & M32
    h1 = ((h1 ^ (h1 >> 13)) * 0xC2B2AE35) & M32
    return h1 ^ (h1 >> 16)


def _signed32(h: int) -> int:
    return h - (1 << 32) if h >= 1 << 31 else h


def murmur3_int(v: int, seed: int) -> int:
    """Murmur3_x86_32.hashInt of one value (signed int32 result)."""
    return _signed32(_scalar_fmix(_scalar_mix(seed & M32, v & M32), 4))


def murmur3_long(v: int, seed: int) -> int:
    """Murmur3_x86_32.hashLong of one value (signed int32 result)."""
    v &= (1 << 64) - 1
    h1 = _scalar_mix(_scalar_mix(seed & M32, v & M32), v >> 32)
    return _signed32(_scalar_fmix(h1, 8))


def murmur3_bytes(data: bytes, seed: int) -> int:
    """hashUnsafeBytes: 4-byte little-endian words, then each tail byte
    mixed as a signed int (signed int32 result)."""
    h1 = seed & M32
    n = len(data)
    for i in range(0, n // 4 * 4, 4):
        h1 = _scalar_mix(h1, int.from_bytes(data[i:i + 4], "little"))
    for b in data[n // 4 * 4:]:
        h1 = _scalar_mix(h1, (b - 256 if b >= 128 else b) & M32)
    return _signed32(_scalar_fmix(h1, n))


def hash_decimal(unscaled: int, precision: int, seed: int) -> int:
    """Spark's Murmur3Hash of one decimal (the port's copy of
    ``spark_rapids_tpu/utils/murmur3.py``'s): the unscaled long up to 18
    digits, else hashUnsafeBytes over ``BigInteger.toByteArray()``, the
    minimal big-endian two's-complement bytes."""
    if precision <= 18:
        return murmur3_long(unscaled, seed)
    v = unscaled
    bit_length = v.bit_length() if v >= 0 else (-v - 1).bit_length()
    return murmur3_bytes(v.to_bytes(bit_length // 8 + 1, "big",
                                    signed=True), seed)
