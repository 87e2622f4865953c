"""Substring window-match kernel: the CUDA wrapper and its plain version.

Port of ``pallas_window_match`` (``_pallas_match_packed``, body
``_mk_kernel``) of ``spark_rapids_tpu/kernels/string_search.py``:
``match[row, s]`` is True where the k pattern bytes equal
``data[row, s:s+k]`` and ``s + k <= lengths[row]``, over a padded
``uint8[n, max_len]`` string matrix. The kernel is ``csrc/string_search.cu``;
``window_match`` launches it for CUDA tensors and runs
``window_match_plain`` for CPU tensors. It takes any ``max_len``, any n and
any ``1 <= k <= max_len``; the TPU kernel's 128-byte packing and its
``supports`` gate are not carried over.
"""

from __future__ import annotations

import ctypes
import functools

import torch


def window_match_plain(data: torch.Tensor, lengths: torch.Tensor,
                       pat: bytes) -> torch.Tensor:
    """The match matrix in plain torch: one rolled compare of the whole
    matrix per pattern byte (the JAX package's XLA form). Starts whose
    window runs past the value's length are masked, which also drops the
    bytes the roll wraps around."""
    n, ml = data.shape
    m = torch.ones((n, ml), dtype=torch.bool, device=data.device)
    for j, b in enumerate(pat):
        m &= torch.roll(data, -j, dims=1) == b
    starts = torch.arange(ml, device=data.device)
    return m & (starts[None, :] + len(pat) <= lengths[:, None])


def _check(data: torch.Tensor, lengths: torch.Tensor, pat: bytes) -> None:
    if data.dtype != torch.uint8 or data.dim() != 2 \
            or not data.is_contiguous():
        raise ValueError(f"window_match: data must be a contiguous 2-D "
                         f"uint8 tensor, got {data.dtype} "
                         f"{tuple(data.shape)}")
    if lengths.dtype != torch.int32 or lengths.dim() != 1 \
            or not lengths.is_contiguous():
        raise ValueError(f"window_match: lengths must be a contiguous 1-D "
                         f"int32 tensor, got {lengths.dtype} "
                         f"{tuple(lengths.shape)}")
    if lengths.device != data.device:
        raise ValueError("window_match: inputs on different devices")
    if lengths.shape[0] != data.shape[0]:
        raise ValueError("window_match: data and lengths differ in rows")
    if not 1 <= len(pat) <= data.shape[1]:
        raise ValueError(f"window_match: pattern of {len(pat)} bytes; the "
                         f"kernel takes 1 to max_len = {data.shape[1]}")


_lib = None


def _kernel() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        from .build import load
        lib = load("string_search")
        lib.window_match.argtypes = [ctypes.c_void_p] * 3 + [
            ctypes.c_int, ctypes.c_int, ctypes.c_int64, ctypes.c_void_p,
            ctypes.c_void_p]
        lib.window_match.restype = ctypes.c_int
        _lib = lib
    return _lib


@functools.lru_cache(maxsize=64)
def _device_pattern(pat: bytes, device: torch.device) -> torch.Tensor:
    """The pattern bytes on the device, copied there once per pattern."""
    return torch.tensor(list(pat), dtype=torch.uint8, device=device)


def window_match(data: torch.Tensor, lengths: torch.Tensor,
                 pat: bytes) -> torch.Tensor:
    """bool[n, max_len] match matrix of a pattern of 1 to max_len bytes.

    CPU tensors take the plain version. CUDA tensors launch the kernel, and
    a launch that fails raises: there is no fallback."""
    _check(data, lengths, pat)
    if data.device.type == "cpu":
        return window_match_plain(data, lengths, pat)
    if data.device.type != "cuda":
        raise ValueError(f"window_match: no kernel for {data.device}")
    n, ml = data.shape
    out = torch.empty((n, ml), dtype=torch.bool, device=data.device)
    if n == 0:
        return out
    if data.data_ptr() % 16:
        # the kernel moves 16-byte vectors: a view that starts mid-row
        # is copied to a fresh, aligned allocation
        data = data.clone()
    lib = _kernel()
    pattern = _device_pattern(bytes(pat), data.device)
    with torch.cuda.device(data.device):
        stream = torch.cuda.current_stream(data.device).cuda_stream
        rc = lib.window_match(data.data_ptr(), lengths.data_ptr(),
                              pattern.data_ptr(), len(pat), ml, n,
                              out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"window_match kernel launch failed: CUDA error "
                           f"{rc}")
    window_match.launches += 1
    return out


#: kernel launches since the count was last set to 0
window_match.launches = 0
