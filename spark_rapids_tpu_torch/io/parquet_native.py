"""Native parquet column-chunk decode (ctypes over ``csrc/rtpu_parquet.cpp``).

Port of ``spark_rapids_tpu/io/parquet_native.py``. The C++ library parses
the thrift footer once per file and decodes PLAIN / RLE_DICTIONARY pages
(SNAPPY, ZSTD where the build has libzstd, uncompressed) straight into flat
numpy buffers; this module assembles zero-copy arrow arrays from them. A
file or column outside the native subset raises ``_Unsupported`` inside,
and ``read_row_group_native`` returns None, so the caller reads that ROW
GROUP with pyarrow and mixed files keep the native path where they can.

The library builds from the package's source at first use
(``kernels/build.py``). A failed build or load raises: a missing decoder
is an error, never a quiet pyarrow fallback for every file.

A string column the scan asks for as a dictionary keeps its RLE_DICTIONARY
page codes (``_decode_column_codes``): per-row codes and the dictionary
page's values become a ``pa.DictionaryArray`` with no per-row bytes, which
the upload keeps as codes on the device (``dictenc.py``).
"""

from __future__ import annotations

import ctypes
import mmap
import struct
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np
import pyarrow as pa

_MAGIC = b"PAR1"

# parquet physical types
_PT_BOOLEAN, _PT_INT32, _PT_INT64 = 0, 1, 2
_PT_FLOAT, _PT_DOUBLE, _PT_BYTE_ARRAY = 4, 5, 6
_SUPPORTED_PT = {_PT_BOOLEAN, _PT_INT32, _PT_INT64, _PT_FLOAT, _PT_DOUBLE,
                 _PT_BYTE_ARRAY}
_CODEC_ZSTD = 6

_FIXED_NP = {_PT_BOOLEAN: np.uint8, _PT_INT32: np.int32,
             _PT_INT64: np.int64, _PT_FLOAT: np.float32,
             _PT_DOUBLE: np.float64}

_LIB_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
#: codecs the loaded library decodes: UNCOMPRESSED, SNAPPY and, where it
#: was built with libzstd, ZSTD
_CODECS: frozenset = frozenset()


def _lib() -> ctypes.CDLL:
    """The decoder library, built and typed on first use. Raises if it
    does not build or load."""
    global _LIB, _CODECS
    with _LIB_LOCK:
        if _LIB is not None:
            return _LIB
        from ..kernels import build
        lib = build.load("rtpu_parquet")
        u8p = ctypes.POINTER(ctypes.c_uint8)
        i64p = ctypes.POINTER(ctypes.c_int64)
        lib.rtpu_pq_has_zstd.restype = ctypes.c_int32
        lib.rtpu_pq_has_zstd.argtypes = []
        lib.rtpu_pq_footer_open.restype = ctypes.c_int64
        lib.rtpu_pq_footer_open.argtypes = [u8p, ctypes.c_int64]
        lib.rtpu_pq_footer_free.restype = None
        lib.rtpu_pq_footer_free.argtypes = [ctypes.c_int64]
        lib.rtpu_pq_num_rows.restype = ctypes.c_int64
        lib.rtpu_pq_num_rows.argtypes = [ctypes.c_int64]
        lib.rtpu_pq_num_columns.restype = ctypes.c_int32
        lib.rtpu_pq_num_columns.argtypes = [ctypes.c_int64]
        lib.rtpu_pq_num_row_groups.restype = ctypes.c_int32
        lib.rtpu_pq_num_row_groups.argtypes = [ctypes.c_int64]
        lib.rtpu_pq_rg_rows.restype = ctypes.c_int64
        lib.rtpu_pq_rg_rows.argtypes = [ctypes.c_int64, ctypes.c_int32]
        lib.rtpu_pq_col_name.restype = ctypes.c_int32
        lib.rtpu_pq_col_name.argtypes = [ctypes.c_int64, ctypes.c_int32,
                                         ctypes.c_char_p, ctypes.c_int32]
        lib.rtpu_pq_col_info.restype = ctypes.c_int32
        lib.rtpu_pq_col_info.argtypes = [ctypes.c_int64, ctypes.c_int32,
                                         i64p]
        lib.rtpu_pq_chunk_info.restype = ctypes.c_int32
        lib.rtpu_pq_chunk_info.argtypes = [ctypes.c_int64, ctypes.c_int32,
                                           ctypes.c_int32, i64p]
        lib.rtpu_pq_chunk_stats.restype = ctypes.c_int32
        lib.rtpu_pq_chunk_stats.argtypes = [ctypes.c_int64, ctypes.c_int32,
                                            ctypes.c_int32, u8p, u8p, i64p]
        lib.rtpu_pq_has_kv_key.restype = ctypes.c_int32
        lib.rtpu_pq_has_kv_key.argtypes = [ctypes.c_int64, ctypes.c_char_p]
        lib.rtpu_pq_decode_fixed.restype = ctypes.c_int64
        lib.rtpu_pq_decode_fixed.argtypes = [
            u8p, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int64, u8p, u8p]
        lib.rtpu_pq_decode_binary.restype = ctypes.c_int64
        lib.rtpu_pq_decode_binary.argtypes = [
            u8p, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int64, ctypes.POINTER(ctypes.c_int32), u8p,
            ctypes.c_int64, u8p]
        lib.rtpu_pq_decode_binary_codes.restype = ctypes.c_int64
        lib.rtpu_pq_decode_binary_codes.argtypes = [
            u8p, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int64, ctypes.POINTER(ctypes.c_int32), u8p,
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int64, u8p,
            ctypes.c_int64, i64p]
        _CODECS = frozenset({0, 1} | ({_CODEC_ZSTD}
                                      if lib.rtpu_pq_has_zstd() else set()))
        _LIB = lib
        return lib


def _u8(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


class NativeParquetFile:
    """One open file: mmap + parsed native footer. Thread-safe for
    concurrent row-group decode (the C++ side only reads)."""

    def __init__(self, path: str):
        self.path = path
        lib = _lib()
        self._lib = lib
        with open(path, "rb") as f:
            self._mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
        self._buf = np.frombuffer(self._mm, dtype=np.uint8)
        n = len(self._buf)
        if n < 12 or bytes(self._buf[-4:]) != _MAGIC:
            raise _Unsupported("not a parquet file")
        flen = int(np.frombuffer(self._buf[-8:-4].tobytes(),
                                 np.uint32)[0])
        if flen + 8 > n:
            raise _Unsupported("bad footer length")
        footer = np.ascontiguousarray(self._buf[n - 8 - flen:n - 8])
        h = lib.rtpu_pq_footer_open(_u8(footer), flen)
        if h < 0:
            raise _Unsupported(f"footer parse failed ({h})")
        self._h = h
        self.num_row_groups = lib.rtpu_pq_num_row_groups(h)
        self.num_rows = lib.rtpu_pq_num_rows(h)
        ncols = lib.rtpu_pq_num_columns(h)
        self.columns: Dict[str, int] = {}
        self._col_info: List[Tuple[int, int, bool, bool]] = []
        name_buf = ctypes.create_string_buffer(1 << 16)
        info = (ctypes.c_int64 * 4)()
        for c in range(ncols):
            rc = lib.rtpu_pq_col_name(h, c, name_buf, len(name_buf))
            if rc < 0:
                raise _Unsupported("column name overflow")
            lib.rtpu_pq_col_info(h, c, info)
            # (physical type, max_def, flat, is_decimal)
            self._col_info.append((int(info[0]), int(info[1]),
                                   bool(info[2]), bool(info[3])))
            # only FLAT leaves are addressable: the footer stores bare
            # leaf names, and a nested leaf sharing a top-level column's
            # name must not shadow it (stats pruning would read the
            # wrong chunk)
            if bool(info[2]):
                self.columns[name_buf.value.decode("utf-8")] = c

    def close(self):
        if getattr(self, "_h", None) is not None:
            self._lib.rtpu_pq_footer_free(self._h)
            self._h = None
        if getattr(self, "_mm", None) is not None:
            self._buf = None
            self._mm.close()
            self._mm = None

    def __del__(self):   # handles leak-free even without explicit close
        try:
            self.close()
        except Exception:
            pass

    def rg_rows(self, rg: int) -> int:
        return self._lib.rtpu_pq_rg_rows(self._h, rg)

    def chunk_stats(self, rg: int, name: str):
        """(min_bytes|None, max_bytes|None, null_count|None) raw
        PLAIN-encoded stat payloads for predicate pruning."""
        c = self.columns.get(name)
        if c is None:
            return None, None, None
        mn = (ctypes.c_uint8 * 16)()
        mx = (ctypes.c_uint8 * 16)()
        lens = (ctypes.c_int64 * 3)()
        mask = self._lib.rtpu_pq_chunk_stats(
            self._h, rg, c, ctypes.cast(mn, ctypes.POINTER(ctypes.c_uint8)),
            ctypes.cast(mx, ctypes.POINTER(ctypes.c_uint8)), lens)
        if mask < 0:
            return None, None, None
        return (bytes(mn[:lens[0]]) if mask & 1 else None,
                bytes(mx[:lens[1]]) if mask & 2 else None,
                int(lens[2]) if mask & 4 else None)

    def has_metadata_key(self, key) -> bool:
        if isinstance(key, str):
            key = key.encode("utf-8")
        return self._lib.rtpu_pq_has_kv_key(self._h, key) == 1

    def decoded_stats(self, rg: int, name: str):
        """(min, max) as python numbers for NUMERIC leaves, else None.
        Strings are skipped (footer stats may be truncated)."""
        c = self.columns.get(name)
        if c is None:
            return None
        ptype, _, _, is_decimal = self._col_info[c]
        if is_decimal:
            # decimal stats are UNSCALED ints; comparing them against
            # logical Decimal literals would wrongly prune matching groups
            return None
        mn, mx, _ = self.chunk_stats(rg, name)
        if mn is None or mx is None:
            return None
        try:
            if ptype == _PT_INT32 and len(mn) >= 4:
                return (int.from_bytes(mn[:4], "little", signed=True),
                        int.from_bytes(mx[:4], "little", signed=True))
            if ptype == _PT_INT64 and len(mn) >= 8:
                return (int.from_bytes(mn[:8], "little", signed=True),
                        int.from_bytes(mx[:8], "little", signed=True))
            if ptype == _PT_FLOAT and len(mn) >= 4:
                return (struct.unpack("<f", mn[:4])[0],
                        struct.unpack("<f", mx[:4])[0])
            if ptype == _PT_DOUBLE and len(mn) >= 8:
                return (struct.unpack("<d", mn[:8])[0],
                        struct.unpack("<d", mx[:8])[0])
        except (struct.error, ValueError):
            return None
        return None

    def _decode_column(self, rg: int, c: int, rows: int,
                       arrow_type) -> pa.Array:
        lib = self._lib
        ptype, max_def, flat, _ = self._col_info[c]
        if not flat or ptype not in _SUPPORTED_PT:
            raise _Unsupported(f"column layout (type={ptype}, flat={flat})")
        info = (ctypes.c_int64 * 5)()
        lib.rtpu_pq_chunk_info(self._h, rg, c, info)
        codec, start, clen, _nvals, total_un = (int(x) for x in info)
        if codec not in _CODECS:
            raise _Unsupported(f"codec {codec}")
        if start < 0 or start + clen > len(self._buf):
            raise _Unsupported("chunk bounds")
        chunk = self._buf[start:start + clen]
        validity = np.empty(rows, np.uint8)
        if ptype == _PT_BYTE_ARRAY:
            offsets = np.empty(rows + 1, np.int32)
            cap = max(total_un, 1)
            for _ in range(2):
                data = np.empty(cap, np.uint8)
                rc = lib.rtpu_pq_decode_binary(
                    _u8(chunk), clen, codec, max_def, rows,
                    offsets.ctypes.data_as(
                        ctypes.POINTER(ctypes.c_int32)),
                    _u8(data), cap, _u8(validity))
                if rc == -4:          # ERR_SPACE: retry at the real size
                    cap = int(offsets[rows])
                    continue
                break
            if rc < 0:
                raise _Unsupported(f"binary decode ({rc})")
            return _binary_array(arrow_type, rows, offsets, data, validity)
        values = np.empty(rows, _FIXED_NP[ptype])
        rc = lib.rtpu_pq_decode_fixed(
            _u8(chunk), clen, ptype, codec, max_def, rows,
            _u8(values.view(np.uint8)), _u8(validity))
        if rc < 0:
            raise _Unsupported(f"fixed decode ({rc})")
        return _fixed_array(arrow_type, rows, ptype, values, validity)

    def _decode_column_codes(self, rg: int, c: int,
                             rows: int) -> Optional[pa.DictionaryArray]:
        """An RLE_DICTIONARY chunk decoded KEEPING its page codes: the
        per-row codes and the dictionary page's values as a
        ``pa.DictionaryArray``, with no per-row bytes. None when the chunk
        is outside the codes subset (a PLAIN page after a dictionary
        overflow, a codec not built): the caller decodes to bytes."""
        lib = self._lib
        ptype, max_def, flat, _ = self._col_info[c]
        if not flat or ptype != _PT_BYTE_ARRAY:
            return None
        info = (ctypes.c_int64 * 5)()
        lib.rtpu_pq_chunk_info(self._h, rg, c, info)
        codec, start, clen, _nvals, total_un = (int(x) for x in info)
        if codec not in _CODECS or start < 0 or \
                start + clen > len(self._buf):
            return None
        chunk = self._buf[start:start + clen]
        codes = np.empty(rows, np.int32)
        validity = np.empty(rows, np.uint8)
        # the entry capacity starts at the cardinality budget (4 bytes an
        # entry): too small a guess costs a second decode of the chunk
        ents_cap = int(min(1 << 16, max(rows, 1)))
        bytes_cap = max(total_un, 1)
        dinfo = (ctypes.c_int64 * 2)()
        i32p = ctypes.POINTER(ctypes.c_int32)
        for _ in range(2):
            offsets = np.empty(ents_cap + 1, np.int32)
            dbytes = np.empty(bytes_cap, np.uint8)
            rc = lib.rtpu_pq_decode_binary_codes(
                _u8(chunk), clen, codec, max_def, rows,
                codes.ctypes.data_as(i32p), _u8(validity),
                offsets.ctypes.data_as(i32p), ents_cap, _u8(dbytes),
                bytes_cap, dinfo)
            if rc == -4:          # ERR_SPACE: retry at the real sizes
                ents_cap = max(int(dinfo[0]), 1)
                bytes_cap = max(int(dinfo[1]), 1)
                continue
            break
        if rc < 0:
            return None
        card = int(dinfo[0])
        values = pa.StringArray.from_buffers(
            card, pa.py_buffer(np.ascontiguousarray(offsets[:card + 1])),
            pa.py_buffer(np.ascontiguousarray(dbytes[:int(dinfo[1])])))
        indices = pa.Array.from_buffers(
            pa.int32(), rows, [_validity_buffer(validity),
                               pa.py_buffer(codes)])
        return pa.DictionaryArray.from_arrays(indices, values)

    def read_row_group(self, rg: int, columns: List[str],
                       arrow_schema: pa.Schema,
                       dict_columns: Optional[set] = None) -> pa.Table:
        """One row group as an Arrow table; the string columns in
        ``dict_columns`` as dictionaries where their chunks allow."""
        rows = self.rg_rows(rg)
        arrays, names = [], []
        for name in columns:
            c = self.columns.get(name)
            if c is None:
                raise _Unsupported(f"no such column {name!r}")
            at = arrow_schema.field(name).type
            if not _arrow_type_supported(at):
                raise _Unsupported(f"arrow type {at}")
            arr = None
            if dict_columns and name in dict_columns:
                arr = self._decode_column_codes(rg, c, rows)
            if arr is None:
                arr = self._decode_column(rg, c, rows, at)
            arrays.append(arr)
            names.append(name)
        return pa.table(arrays, names=names)


class _Unsupported(Exception):
    """A file, row group or column outside the native subset."""


def _arrow_type_supported(t) -> bool:
    return (pa.types.is_boolean(t) or pa.types.is_int32(t)
            or pa.types.is_int64(t) or pa.types.is_float32(t)
            or pa.types.is_float64(t) or pa.types.is_string(t)
            or pa.types.is_large_string(t) or pa.types.is_date32(t)
            or (pa.types.is_timestamp(t) and t.unit == "us"))


def _validity_buffer(validity: np.ndarray) -> Optional[pa.Buffer]:
    if validity.all():
        return None
    return pa.py_buffer(
        np.packbits(validity.view(bool), bitorder="little").tobytes())


def _fixed_array(arrow_type, rows: int, ptype: int, values: np.ndarray,
                 validity: np.ndarray) -> pa.Array:
    nulls = _validity_buffer(validity)
    if ptype == _PT_BOOLEAN:
        bits = pa.py_buffer(np.packbits(values.view(bool),
                                        bitorder="little").tobytes())
        return pa.Array.from_buffers(pa.bool_(), rows, [nulls, bits])
    return pa.Array.from_buffers(arrow_type, rows,
                                 [nulls, pa.py_buffer(values)])


def _binary_array(arrow_type, rows: int, offsets: np.ndarray,
                  data: np.ndarray, validity: np.ndarray) -> pa.Array:
    nulls = _validity_buffer(validity)
    used = int(offsets[rows])
    # int32 offsets force the small-string base; the cast below widens to
    # large_string when the file schema asks for it
    base = pa.string()
    arr = pa.Array.from_buffers(
        base, rows, [nulls, pa.py_buffer(offsets),
                     pa.py_buffer(np.ascontiguousarray(data[:used]))])
    if arrow_type != base:
        arr = arr.cast(arrow_type)
    return arr


# ---------------------------------------------------------------------------
# per-path file cache (footers parse once; decode is per row group). A file
# rewritten at the same path reads stale: write new files to a new path.
# ---------------------------------------------------------------------------

_CACHE: Dict[str, NativeParquetFile] = {}
_CACHE_LOCK = threading.Lock()
_FAILED: Dict[str, str] = {}
_MAX_CACHED = 64


def open_native(path: str) -> Optional[NativeParquetFile]:
    """The cached open file at ``path``, or None when its footer is outside
    the native subset. Raises if the decoder library cannot be built or
    loaded."""
    with _CACHE_LOCK:
        if path in _FAILED:
            return None
        f = _CACHE.get(path)
        if f is not None:
            return f
    try:
        f = NativeParquetFile(path)
    except _Unsupported as e:
        with _CACHE_LOCK:
            _FAILED[path] = str(e)
        return None
    with _CACHE_LOCK:
        if len(_CACHE) >= _MAX_CACHED:
            # FIFO-evict the OLDEST entry and let refcounting finalize it
            # (__del__ closes the mmap once no scan thread holds a view);
            # an eager close() here could rip the buffer out from under a
            # concurrent decode
            _CACHE.pop(next(iter(_CACHE)), None)
        _CACHE[path] = f
    return f


def read_row_group_native(path: str, rg: int, columns: List[str],
                          arrow_schema: pa.Schema) -> Optional[pa.Table]:
    """Native decode of one row group, or None when it is outside the
    native subset (the caller falls back to pyarrow)."""
    f = open_native(path)
    if f is None:
        return None
    try:
        return f.read_row_group(rg, columns, arrow_schema)
    except _Unsupported:
        return None
