"""Framed, compressed batch format, and the packed host copy of a batch.

Port of ``spark_rapids_tpu/shuffle/serializer.py`` (``serialize_host``,
``deserialize_host``, ``batch_to_arrays``, ``_col_to_arrays`` /
``_col_from_arrays``, ``serialize_batch``, ``deserialize_batch``). The
frame layout is the JAX package's byte for byte, with the same CRC32 and
codecs, so a frame either package writes reads back on the other::

  magic 'RTPU' | u32 version | u32 crc32(body) | u32 narrays | i64 nrows
  per array:
    u32 name_len | name | u8 dtype_len | numpy dtype string | u8 ndim |
    i64 shape[ndim] | i64 raw_len | i64 payload_len | u8 codec | payload

Array names encode the lane: ``v{i}`` validity, ``d{i}`` data, ``l{i}``
string, array or map lengths and ``m{i}`` a map's values or an
``array<string>``'s element lengths of column i, a struct's children under
``{i}.{j}``, and for a dictionary column ``d{i}`` its codes with ``D{i}``
and ``e{i}`` its dictionary and entry lengths (the disk spill tier adds
``n``, the row count). Codecs: 0 none, 1 lz4, 2 zlib, 3 zstd. LZ4 and zstd run in the
port's host codec (``csrc/host_codec.cpp``, a copy of the JAX package's);
where it cannot be built a frame is written with zlib, as the JAX package
falls back, and zstd needs the system's libzstd.

``HostTable`` is the device-to-host side: every lane of a batch copied
into one host buffer, pinned when the batch is on a CUDA device, by
non-blocking copies followed by one recorded event. Nothing reads the
bytes before ``wait()`` has synchronized on that event; the device
tensors may be dropped as soon as the copies are enqueued, since the
caching allocator orders their reuse after the copies on the same stream.
The catalog's host tier holds ``HostTable``s; ``to_device`` copies one
back with non-blocking copies from its pinned buffer.

``serialized_partitions`` and ``iter_framed``, which feed the network
shuffle, come with that slice.
"""

from __future__ import annotations

import ctypes
import io
import struct
import warnings
import zlib
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..batch import ColumnarBatch, DeviceColumn, Schema, rows_scalar
from ..types import TypeKind

MAGIC = b"RTPU"
#: v2 added the envelope CRC32
VERSION = 2
_CODEC = {"none": 0, "lz4": 1, "zlib": 2, "zstd": 3}
_CODEC_R = {v: k for k, v in _CODEC.items()}
CODECS = ("none", "lz4", "zstd")
#: codec of frames written without one named
DEFAULT_CODEC = "lz4"

#: magic(4) + version(4) + crc(4): the body the CRC covers starts here
_HEADER_LEN = 12
#: byte alignment of each lane inside a HostTable buffer
_ALIGN = 64


class FrameChecksumError(RuntimeError):
    """The frame body does not match the CRC32 its envelope carries: the
    bytes were damaged between serialize and deserialize. A corrupt frame
    never decodes into rows."""


# ---------------------------------------------------------------------------
# Codecs
# ---------------------------------------------------------------------------

_codec_lib: Optional[ctypes.CDLL] = None
_codec_tried = False


def _codec() -> Optional[ctypes.CDLL]:
    """The host codec library, built at first use; None where it cannot
    be built (frames then compress with zlib)."""
    global _codec_lib, _codec_tried
    if not _codec_tried:
        _codec_tried = True
        try:
            from ..kernels.build import load
            lib = load("host_codec")
        except (RuntimeError, OSError):
            return None
        for fn in ("rtpu_lz4_compress", "rtpu_lz4_decompress",
                   "rtpu_zstd_compress", "rtpu_zstd_decompress"):
            getattr(lib, fn).restype = ctypes.c_int64
            getattr(lib, fn).argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                         ctypes.c_void_p, ctypes.c_int64]
        lib.rtpu_has_zstd.restype = ctypes.c_int32
        _codec_lib = lib
    return _codec_lib


def _ptr(buf) -> int:
    return np.frombuffer(buf, np.uint8).ctypes.data if len(buf) else 0


def compress(data, codec: Optional[str] = None) -> Tuple[bytes, str]:
    """``(payload, codec)`` of ``data`` (bytes or a byte memoryview)."""
    codec = codec or DEFAULT_CODEC
    if codec not in CODECS:
        raise ValueError(f"unsupported compression codec {codec!r}; pick "
                         f"one of {CODECS}")
    if codec == "none":
        return bytes(data), "none"
    lib = _codec()
    if lib is None:
        return zlib.compress(data, 1), "zlib"
    n = len(data)
    cap = n + n // 4 + 256
    dst = np.empty(cap, np.uint8)
    if codec == "zstd":
        if not lib.rtpu_has_zstd():
            raise ValueError("codec 'zstd' needs libzstd, which the host "
                             "codec was built without")
        got = lib.rtpu_zstd_compress(_ptr(data), n, dst.ctypes.data, cap)
        return (dst[:got].tobytes(), "zstd") if got >= 0 \
            else (bytes(data), "none")
    got = lib.rtpu_lz4_compress(_ptr(data), n, dst.ctypes.data, cap)
    if got < 0:
        return zlib.compress(data, 1), "zlib"
    return dst[:got].tobytes(), "lz4"


def decompress(payload: bytes, codec: str, out_size: int) -> bytes:
    if codec == "zlib":
        return zlib.decompress(payload)
    if codec == "none":
        return payload
    lib = _codec()
    if lib is None or (codec == "zstd" and not lib.rtpu_has_zstd()):
        raise RuntimeError(f"{codec} payload but no host codec for it")
    dst = np.empty(out_size, np.uint8)
    fn = (lib.rtpu_zstd_decompress if codec == "zstd"
          else lib.rtpu_lz4_decompress)
    got = fn(_ptr(payload), len(payload), dst.ctypes.data, out_size)
    if got != out_size:
        raise ValueError(f"{codec} decompress: got {got}, want {out_size}")
    return dst.tobytes()


# ---------------------------------------------------------------------------
# Frames of named host arrays
# ---------------------------------------------------------------------------

def _start_frame() -> io.BytesIO:
    """Open a frame with a zero CRC placeholder; _seal_frame patches it."""
    out = io.BytesIO()
    out.write(MAGIC)
    out.write(struct.pack("<II", VERSION, 0))
    return out


def _seal_frame(out: io.BytesIO) -> bytes:
    """Patch the envelope CRC32 in place, with no second copy of the
    frame."""
    buf = out.getbuffer()
    crc = zlib.crc32(buf[_HEADER_LEN:]) & 0xFFFFFFFF
    struct.pack_into("<I", buf, 8, crc)
    del buf
    return out.getvalue()


def _write_blob(out: io.BytesIO, raw, codec: Optional[str]) -> None:
    payload, codec = compress(raw, codec)
    if len(payload) >= len(raw):
        payload, codec = raw, "none"
    out.write(struct.pack("<qqB", len(raw), len(payload), _CODEC[codec]))
    out.write(payload)


def _read_blob(buf: memoryview, pos: int) -> Tuple[bytes, int]:
    raw_len, comp_len, codec = struct.unpack_from("<qqB", buf, pos)
    pos += 17
    payload = bytes(buf[pos: pos + comp_len])
    pos += comp_len
    return decompress(payload, _CODEC_R[codec], raw_len), pos


def serialize_host(arrays: Dict[str, np.ndarray], num_rows: int,
                   codec: Optional[str] = None) -> bytes:
    """Named host arrays -> one frame."""
    out = _start_frame()
    out.write(struct.pack("<Iq", len(arrays), num_rows))
    for name, arr in arrays.items():
        arr = np.asarray(arr)
        nb = name.encode()
        dt = arr.dtype.str.encode()
        out.write(struct.pack("<I", len(nb)))
        out.write(nb)
        out.write(struct.pack("<B", len(dt)))
        out.write(dt)
        out.write(struct.pack("<B", arr.ndim))
        for s in arr.shape:
            out.write(struct.pack("<q", s))
        _write_blob(out, np.ascontiguousarray(arr).reshape(-1).view(np.uint8)
                    .data if arr.size else b"", codec)
    return _seal_frame(out)


def deserialize_host(data: bytes) -> Tuple[Dict[str, np.ndarray], int]:
    """One frame -> its named arrays and row count. The CRC is checked on
    every read."""
    buf = memoryview(data)
    if bytes(buf[:4]) != MAGIC:
        raise ValueError("bad frame magic")
    version, crc = struct.unpack_from("<II", buf, 4)
    if version != VERSION:
        raise ValueError(f"frame version {version} != {VERSION}")
    if zlib.crc32(buf[_HEADER_LEN:]) & 0xFFFFFFFF != crc:
        raise FrameChecksumError(
            f"frame body fails its envelope CRC32 "
            f"({len(data) - _HEADER_LEN} bytes)")
    ncols, num_rows = struct.unpack_from("<Iq", buf, _HEADER_LEN)
    pos = _HEADER_LEN + 12
    arrays: Dict[str, np.ndarray] = {}
    for _ in range(ncols):
        (nlen,) = struct.unpack_from("<I", buf, pos)
        pos += 4
        name = bytes(buf[pos: pos + nlen]).decode()
        pos += nlen
        (dlen,) = struct.unpack_from("<B", buf, pos)
        pos += 1
        dt = bytes(buf[pos: pos + dlen]).decode()
        pos += dlen
        (ndim,) = struct.unpack_from("<B", buf, pos)
        pos += 1
        shape = list(struct.unpack_from(f"<{ndim}q", buf, pos))
        pos += 8 * ndim
        raw, pos = _read_blob(buf, pos)
        arrays[name] = np.frombuffer(raw, dtype=np.dtype(dt)).reshape(shape)
    return arrays, num_rows


# ---------------------------------------------------------------------------
# Batches <-> named lanes
# ---------------------------------------------------------------------------

def _col_to_arrays(c: DeviceColumn, key: str,
                   tensors: Dict[str, torch.Tensor]) -> None:
    """One column's lanes under their keys; a struct's children recurse
    as ``{key}.{j}`` (the schema drives the reassembly)."""
    tensors[f"v{key}"] = c.validity
    if c.is_struct:
        for j, kid in enumerate(c.data):
            _col_to_arrays(kid, f"{key}.{j}", tensors)
        return
    tensors[f"d{key}"] = c.data
    if c.lengths is not None:
        tensors[f"l{key}"] = c.lengths
    if c.data2 is not None:
        # a map's values, an array<string>'s element lengths
        tensors[f"m{key}"] = c.data2
    if c.dict_data is not None:
        # a dictionary column ships its dictionary beside the codes
        # (``d{key}`` above), not a padded byte matrix
        tensors[f"D{key}"] = c.dict_data
        tensors[f"e{key}"] = c.dict_lengths


def _lanes(batch: ColumnarBatch) -> Dict[str, torch.Tensor]:
    tensors: Dict[str, torch.Tensor] = {}
    for i, c in enumerate(batch.columns):
        _col_to_arrays(c, str(i), tensors)
    return tensors


def _host_tensor(a: np.ndarray) -> torch.Tensor:
    # frames decode into read-only buffers; the tensor is only copied from
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        return torch.from_numpy(np.ascontiguousarray(a))


def _col_from_arrays(dtype, key: str, arrays: Dict[str, object],
                     device: torch.device) -> DeviceColumn:
    """A column from its lanes (numpy arrays or host tensors)."""
    def lane(k):
        a = arrays[k]
        t = a if isinstance(a, torch.Tensor) else _host_tensor(a)
        return t.to(device, non_blocking=True)
    if dtype.kind is TypeKind.STRUCT:
        kids = tuple(_col_from_arrays(ct, f"{key}.{j}", arrays, device)
                     for j, ct in enumerate(dtype.children))
        return DeviceColumn(kids, lane(f"v{key}"), dtype)
    if f"D{key}" in arrays:
        return DeviceColumn(lane(f"d{key}"), lane(f"v{key}"), dtype, None,
                            lane(f"D{key}"), lane(f"e{key}"))
    lengths = lane(f"l{key}") if f"l{key}" in arrays else None
    data2 = lane(f"m{key}") if f"m{key}" in arrays else None
    return DeviceColumn(lane(f"d{key}"), lane(f"v{key}"), dtype, lengths,
                        data2=data2)


@dataclass(frozen=True)
class _Section:
    key: str
    dtype: torch.dtype
    shape: Tuple[int, ...]
    offset: int
    nbytes: int


class HostTable:
    """A batch's lanes and row count in one host buffer (pinned for a CUDA
    batch), copied by ``HostTable.pack``. Read it only after ``wait()``."""

    def __init__(self, buffer: torch.Tensor, sections: List[_Section],
                 event: Optional["torch.cuda.Event"]):
        self.buffer = buffer
        self.sections = sections
        self._event = event

    @staticmethod
    def pack(batch: ColumnarBatch) -> "HostTable":
        """Enqueue the copy of every lane (and ``n``, the row count) into
        one host buffer. On CUDA the copies are non-blocking into pinned
        memory, followed by one event; nothing waits here."""
        tensors = _lanes(batch)
        tensors["n"] = batch.num_rows.reshape(1)
        sections, off = [], 0
        for key, t in tensors.items():
            nbytes = t.numel() * t.element_size()
            sections.append(_Section(key, t.dtype, tuple(t.shape), off,
                                     nbytes))
            off += -(-nbytes // _ALIGN) * _ALIGN
        cuda = batch.device.type == "cuda"
        buf = torch.empty(max(off, 1), dtype=torch.uint8, pin_memory=cuda)
        for s in sections:
            if s.nbytes:
                HostTable._view(buf, s).copy_(tensors[s.key],
                                              non_blocking=cuda)
        event = None
        if cuda:
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(batch.device))
        return HostTable(buf, sections, event)

    @staticmethod
    def _view(buf: torch.Tensor, s: _Section) -> torch.Tensor:
        return buf[s.offset: s.offset + s.nbytes].view(s.dtype).view(s.shape)

    @staticmethod
    def from_arrays(arrays: Dict[str, np.ndarray],
                    pin: bool) -> "HostTable":
        """Pack named host arrays (a decoded frame) into one buffer."""
        sections, off = [], 0
        tensors = {k: _host_tensor(a) for k, a in arrays.items()}
        for key, t in tensors.items():
            nbytes = t.numel() * t.element_size()
            sections.append(_Section(key, t.dtype, tuple(t.shape), off,
                                     nbytes))
            off += -(-nbytes // _ALIGN) * _ALIGN
        buf = torch.empty(max(off, 1), dtype=torch.uint8, pin_memory=pin)
        for s in sections:
            if s.nbytes:
                HostTable._view(buf, s).copy_(tensors[s.key])
        return HostTable(buf, sections, None)

    def wait(self) -> "HostTable":
        """Block until the device-to-host copies have landed."""
        if self._event is not None:
            self._event.synchronize()
            self._event = None
        return self

    def tensors(self) -> Dict[str, torch.Tensor]:
        """Host tensor views into the buffer, by lane key."""
        return {s.key: self._view(self.buffer, s) for s in self.sections}

    def arrays(self) -> Dict[str, np.ndarray]:
        """Numpy views into the buffer, by lane key (waits for the copy)."""
        self.wait()
        return {k: t.numpy() for k, t in self.tensors().items()}

    def to_device(self, schema: Schema,
                  device: torch.device) -> ColumnarBatch:
        """The batch back on ``device``: one non-blocking copy per lane
        from the (pinned) buffer, which torch keeps alive until the copies
        are done."""
        t = self.tensors()
        cols = tuple(_col_from_arrays(f.dtype, str(i), t, device)
                     for i, f in enumerate(schema))
        n = t["n"].reshape(()).to(device, non_blocking=True)
        return ColumnarBatch(cols, n)

    def frame(self, codec: Optional[str] = None) -> bytes:
        """This table as one frame (the disk spill tier)."""
        arrays = self.arrays()
        return serialize_host(arrays, int(arrays["n"][0]), codec)


def batch_to_arrays(batch: ColumnarBatch) -> Dict[str, np.ndarray]:
    """D2H every lane of a batch, as numpy arrays under their keys: one
    packed copy through pinned memory, then a wait on its event."""
    arrays = HostTable.pack(batch).arrays()
    arrays.pop("n")
    return arrays


def serialize_batch(batch: ColumnarBatch, schema: Schema,
                    codec: Optional[str] = None) -> bytes:
    """Device batch -> one frame (one D2H staging pass)."""
    table = HostTable.pack(batch)
    arrays = table.arrays()
    n = int(arrays.pop("n")[0])
    return serialize_host(arrays, n, codec)


def deserialize_batch(data: bytes, schema: Schema,
                      device: Optional[torch.device] = None) -> ColumnarBatch:
    """One frame -> a batch on ``device`` (default: the CPU)."""
    dev = torch.device("cpu") if device is None else torch.device(device)
    arrays, num_rows = deserialize_host(data)
    cols = tuple(_col_from_arrays(f.dtype, str(i), arrays, dev)
                 for i, f in enumerate(schema))
    return ColumnarBatch(cols, rows_scalar(num_rows, dev))
