"""Columnar data plane: device columns and batches.

Port of ``spark_rapids_tpu/batch.py`` for fixed-width and string columns.
The batch contract is unchanged, so intermediates compare array for array
with the JAX package: every column is a tensor of a power-of-two
``capacity`` rows plus a bool validity mask, ``num_rows`` is an int32
scalar tensor on the batch's device, and every row in
``[num_rows, capacity)`` is dead (invalid, zero payload). A string column's
payload is ``uint8[capacity, max_len]``, zero past each value's end, with
its byte lengths in ``int32[capacity]``; a null row has length 0 and no
bytes. A decimal of more than 18 digits holds four 32-bit limbs a row in
``int64[capacity, 4]`` (``expressions/decimal128.py``); every gather,
compaction, pad and concatenation keeps that trailing dimension. A dictionary-encoded string column (``dictenc.py``) holds int32
codes in ``data``, no ``lengths``, and its sorted distinct entries in
``dict_data``/``dict_lengths``.

Host interchange is Arrow. ``from_arrow`` is the H2D boundary, ``to_arrow``
the D2H one; ``batch_from_numpy`` rebuilds a batch from arrays taken out of
the JAX package, so a test can feed one of its intermediates to the port.
"""

from __future__ import annotations

import dataclasses
import warnings
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import pyarrow as pa
import torch

from . import types as T
from .types import SqlType, TypeKind

MIN_CAPACITY = 128

DeviceLike = Union[str, torch.device, None]


class StringOverflowError(ValueError):
    """A string exceeded its column's device ``max_len`` byte budget."""


class CapacityError(ValueError):
    """A fixed device budget was exceeded; the result would be silently
    truncated, so the host boundary fails loud instead."""


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller names
    another. Asking for CUDA where there is none raises; nothing continues
    quietly on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return dev


def bucket_capacity(n: int, minimum: int = MIN_CAPACITY) -> int:
    """Round a row count up to its capacity bucket (next power of two)."""
    if n <= minimum:
        return minimum
    return 1 << (n - 1).bit_length()


@dataclass(frozen=True)
class Field:
    name: str
    dtype: SqlType
    nullable: bool = True


@dataclass(frozen=True)
class Schema:
    fields: Tuple[Field, ...]

    def __init__(self, fields: Sequence[Field]):
        object.__setattr__(self, "fields", tuple(fields))

    def __len__(self):
        return len(self.fields)

    def __iter__(self):
        return iter(self.fields)

    def __getitem__(self, i):
        return self.fields[i]

    @property
    def names(self) -> List[str]:
        return [f.name for f in self.fields]

    def index_of(self, name: str) -> int:
        for i, f in enumerate(self.fields):
            if f.name == name:
                return i
        raise KeyError(f"column {name!r} not in schema {self.names}")

    def __str__(self):
        inner = ", ".join(f"{f.name}: {f.dtype}" for f in self.fields)
        return f"Schema({inner})"


@dataclass(frozen=True)
class DeviceColumn:
    """One column on the device: payload + validity, both [capacity] rows
    (+ byte lengths for strings, whose payload is [capacity, max_len]). A
    dictionary-encoded string column holds its codes in ``data`` and its
    dictionary in ``dict_data``/``dict_lengths``, which every row gather
    carries along untouched (their leading dimension is the card, not the
    capacity)."""

    data: torch.Tensor
    validity: torch.Tensor          # bool; False beyond num_rows
    dtype: SqlType = T.INT32
    lengths: Optional[torch.Tensor] = None      # int32[capacity], strings
    dict_data: Optional[torch.Tensor] = None    # uint8[card, max_len]
    dict_lengths: Optional[torch.Tensor] = None  # int32[card]

    @property
    def capacity(self) -> int:
        return self.validity.shape[0]

    @property
    def is_dict(self) -> bool:
        return self.dict_data is not None

    def replace(self, **changes) -> "DeviceColumn":
        """This column with some fields changed (the dictionary kept
        unless changed)."""
        return dataclasses.replace(self, **changes)

    def size_bytes(self) -> int:
        n = (self.data.numel() * self.data.element_size()
             + self.validity.numel())
        if self.lengths is not None:
            n += self.lengths.numel() * 4
        if self.dict_data is not None:
            n += self.dict_data.numel() + self.dict_lengths.numel() * 4
        return n


@dataclass(frozen=True)
class ColumnarBatch:
    """A batch of columns with a row-count scalar and a fixed capacity."""

    columns: Tuple[DeviceColumn, ...]
    num_rows: torch.Tensor          # int32 scalar on the batch's device

    @property
    def capacity(self) -> int:
        return self.columns[0].capacity if self.columns else 0

    @property
    def device(self) -> torch.device:
        return self.num_rows.device

    def row_mask(self) -> torch.Tensor:
        """bool[cap]: True for live (within num_rows) positions."""
        return torch.arange(self.capacity, dtype=torch.int32,
                            device=self.device) < self.num_rows

    def size_bytes(self) -> int:
        return sum(c.size_bytes() for c in self.columns)


def rows_scalar(n, device: torch.device) -> torch.Tensor:
    """A row count as the batch's int32 scalar tensor. A Python count is
    filled in on the device, not copied from the host, so the call is safe
    inside a CUDA graph capture."""
    if isinstance(n, torch.Tensor):
        return n.to(device=device, dtype=torch.int32)
    return torch.full((), n, dtype=torch.int32, device=device)


# ---------------------------------------------------------------------------
# Host -> device (the scan / H2D boundary)
# ---------------------------------------------------------------------------

def _host_tensor(values: np.ndarray) -> torch.Tensor:
    # Arrow hands out read-only buffers; the tensor is only ever copied
    # from, so torch's non-writable warning does not apply
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        return torch.from_numpy(values)


def _padded(values: np.ndarray, dtype: torch.dtype, capacity: int,
            device: torch.device) -> torch.Tensor:
    n = values.shape[0]
    if n > capacity:
        raise ValueError(f"{n} rows exceed capacity {capacity}")
    out = torch.zeros((capacity,) + values.shape[1:], dtype=dtype,
                      device=device)
    if n:
        out[:n].copy_(_host_tensor(values))
    return out


def _check_decimal(arr: pa.Array, dtype: SqlType) -> None:
    if not pa.types.is_decimal128(arr.type):
        raise NotImplementedError(
            f"arrow type {arr.type}: only decimal128 uploads")
    if arr.type.scale != dtype.scale:
        raise ValueError(f"decimal scale {arr.type.scale} does not match "
                         f"the column's {dtype}")


def _decimal_storage(arr: pa.Array, dtype: SqlType) -> np.ndarray:
    """The unscaled int64 values of an Arrow decimal128 array of at most 18
    digits: the low 8 bytes of each 16-byte little-endian value, read from
    the buffer as they stand (no Python ``Decimal`` per row, no float).
    Null slots, whose bytes Arrow leaves undefined, become 0. (Past 18
    digits ``column_from_arrow`` uploads the whole 16 bytes as limbs.)"""
    _check_decimal(arr, dtype)
    n = len(arr)
    if n == 0:
        return np.zeros(0, np.int64)
    words = np.frombuffer(arr.buffers()[1], dtype=np.int64,
                          count=2 * (arr.offset + n))[2 * arr.offset::2]
    if arr.null_count:
        return np.where(np.asarray(arr.is_valid()), words, 0)
    return words


def _scalar_storage(arr: pa.Array, dtype: SqlType) -> np.ndarray:
    """Arrow array -> numpy storage values; null slots become 0/False
    (validity carries nullness, and zeros keep NaN out of reductions).
    Decimals give their unscaled int64, timestamps their UTC epoch
    microseconds and NULL columns zeros."""
    if dtype.kind is TypeKind.DECIMAL:
        return _decimal_storage(arr, dtype)
    if dtype.kind is TypeKind.NULL:
        return np.zeros(len(arr), np.int8)
    if dtype.kind is TypeKind.DATE:
        arr = arr.view(pa.int32())
    elif dtype.kind is TypeKind.TIMESTAMP:
        arr = arr.cast(pa.timestamp("us", tz=arr.type.tz)).view(pa.int64())
    if arr.null_count:
        arr = arr.fill_null(False if dtype.kind is TypeKind.BOOLEAN else 0)
    return np.asarray(arr.to_numpy(zero_copy_only=False),
                      dtype=T.numpy_dtype(dtype))


def _validity(arr: pa.Array, capacity: int,
              device: torch.device) -> torch.Tensor:
    if arr.null_count:
        return _padded(np.asarray(arr.is_valid()), torch.bool, capacity,
                       device)
    return torch.arange(capacity, device=device) < len(arr)


def _string_offsets(arr: pa.Array, max_len: int
                    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(starts int32[n], lengths int32[n], chars uint8[]) of a string array:
    the Arrow offsets and character buffer as they are, with null rows at
    length 0. Raises ``StringOverflowError`` for a value over ``max_len``
    bytes, checked here on the host from the offsets alone."""
    if arr.type == pa.large_string():
        arr = arr.cast(pa.string())
    n = len(arr)
    if n == 0:
        return (np.zeros(0, np.int32), np.zeros(0, np.int32),
                np.zeros(0, np.uint8))
    bufs = arr.buffers()
    offsets = np.frombuffer(bufs[1], dtype=np.int32, count=n + 1,
                            offset=arr.offset * 4)
    lengths = np.diff(offsets)
    if arr.null_count:
        lengths = np.where(np.asarray(arr.is_valid()), lengths, 0)
    if int(lengths.max()) > max_len:
        raise StringOverflowError(
            f"string of {int(lengths.max())} bytes exceeds device max_len "
            f"{max_len}; re-bucket the column")
    first, last = int(offsets[0]), int(offsets[-1])
    chars = (np.frombuffer(bufs[2], dtype=np.uint8)[first:last]
             if bufs[2] is not None else np.zeros(0, np.uint8))
    return offsets[:-1] - np.int32(first), lengths.astype(np.int32), chars


def _matrix_from_offsets(starts: torch.Tensor, lengths: torch.Tensor,
                         chars: torch.Tensor, max_len: int) -> torch.Tensor:
    """The padded ``uint8[n, max_len]`` matrix of strings given by their
    start offsets into ``chars`` and their byte lengths, built on the
    tensors' device: byte j of row i is ``chars[starts[i] + j]`` below
    ``lengths[i]`` and 0 from there."""
    cols = torch.arange(max_len, device=chars.device)
    mask = cols[None, :] < lengths[:, None]
    if chars.numel() == 0:
        return torch.zeros(mask.shape, dtype=torch.uint8, device=chars.device)
    index = (starts.to(torch.int64)[:, None] + cols[None, :]).clamp_(
        max=chars.numel() - 1)
    return torch.where(mask, chars[index], 0)


def _string_column(arr: pa.Array, dtype: SqlType, capacity: int,
                   device: torch.device) -> DeviceColumn:
    """Upload a string array as the offsets and characters Arrow holds
    (about the strings' own bytes, not ``max_len`` a row) and build the
    padded matrix on the device."""
    n = len(arr)
    if n > capacity:
        raise ValueError(f"{n} rows exceed capacity {capacity}")
    starts, lengths, chars = _string_offsets(arr, dtype.max_len)
    data = torch.zeros((capacity, dtype.max_len), dtype=torch.uint8,
                       device=device)
    plen = _padded(lengths, torch.int32, capacity, device)
    if n:
        data[:n] = _matrix_from_offsets(
            _host_tensor(starts).to(device), plen[:n],
            _host_tensor(chars).to(device), dtype.max_len)
    return DeviceColumn(data, _validity(arr, capacity, device), dtype, plen)


def column_from_arrow(arr, dtype: SqlType, capacity: int,
                      device: torch.device, name: str = "",
                      dict_conf: Optional[tuple] = None) -> DeviceColumn:
    arr = arr.combine_chunks() if isinstance(arr, pa.ChunkedArray) else arr
    if pa.types.is_dictionary(arr.type):
        # the RLE_DICTIONARY hand-off: keep the codes and build the bytes
        # once per distinct value (dictenc.py); a column over a threshold,
        # or under dictEncoding.enabled=false, decodes with its reason
        if dtype.kind is TypeKind.STRING:
            from .dictenc import column_from_arrow_dictionary
            col = column_from_arrow_dictionary(arr, dtype, capacity, device,
                                               name, dict_conf)
            if col is not None:
                return col
        arr = arr.cast(arr.type.value_type)
    if dtype.kind is TypeKind.STRING:
        return _string_column(arr, dtype, capacity, device)
    validity = _validity(arr, capacity, device)
    if dtype.kind is TypeKind.DECIMAL and \
            dtype.precision > T.MAX_LONG_DIGITS:
        # DECIMAL128: the buffer's 16 bytes a row go up as they stand and
        # widen to limbs on the device
        from .expressions.decimal128 import arrow_words, widen_words
        _check_decimal(arr, dtype)
        words = _padded(arrow_words(arr), torch.int32, capacity, device)
        return DeviceColumn(widen_words(words, validity), validity, dtype)
    data = _padded(_scalar_storage(arr, dtype), dtype.storage_dtype,
                   capacity, device)
    return DeviceColumn(data, validity, dtype)


def schema_from_arrow(schema: pa.Schema, string_max_len: int = 64) -> Schema:
    return Schema([Field(f.name, T.from_arrow(f.type, string_max_len),
                         f.nullable)
                   for f in schema])


def from_arrow(table: pa.Table, capacity: Optional[int] = None,
               schema: Optional[Schema] = None, string_max_len: int = 64,
               device: DeviceLike = None,
               dict_conf: Optional[tuple] = None
               ) -> Tuple[ColumnarBatch, Schema]:
    """Build a device batch from an Arrow table.

    Without a schema, string columns get ``string_max_len`` bytes and
    nullability is tightened from the data: a null-free column becomes
    non-nullable, as in the JAX package, which lets the aggregate skip its
    validity payload lane. A dictionary string column stays codes under
    ``dict_conf`` (``dictenc.dict_conf``; default: the registry's)."""
    dev = resolve_device(device)
    if schema is None:
        schema = schema_from_arrow(table.schema, string_max_len)
        schema = Schema([Field(f.name, f.dtype,
                               f.nullable and table.column(i).null_count > 0)
                         for i, f in enumerate(schema)])
    n = table.num_rows
    cap = capacity or bucket_capacity(n)
    cols = tuple(column_from_arrow(table.column(i), f.dtype, cap, dev,
                                   f.name, dict_conf)
                 for i, f in enumerate(schema))
    return ColumnarBatch(cols, rows_scalar(n, dev)), schema


def batch_from_numpy(columns: Sequence[Tuple[np.ndarray, ...]],
                     num_rows: int, schema: Schema,
                     device: DeviceLike = None) -> ColumnarBatch:
    """Rebuild a batch from numpy arrays at full capacity, e.g. the arrays
    of a JAX package batch: ``(data, validity)`` per column, and
    ``(data, validity, lengths)`` for a string column."""
    dev = resolve_device(device)
    cols = []
    for arrays, f in zip(columns, schema):
        data, validity = arrays[0], arrays[1]
        d = torch.from_numpy(np.asarray(data, dtype=T.numpy_dtype(f.dtype)))
        v = torch.from_numpy(np.asarray(validity, dtype=np.bool_))
        lengths = None
        if f.dtype.kind is TypeKind.STRING:
            lengths = torch.from_numpy(
                np.asarray(arrays[2], dtype=np.int32)).to(dev)
        cols.append(DeviceColumn(d.to(dev), v.to(dev), f.dtype, lengths))
    return ColumnarBatch(tuple(cols), rows_scalar(num_rows, dev))


def empty_column(dtype: SqlType, device: torch.device,
                 capacity: int = MIN_CAPACITY) -> DeviceColumn:
    validity = torch.zeros(capacity, dtype=torch.bool, device=device)
    if dtype.kind is TypeKind.STRING:
        return DeviceColumn(
            torch.zeros((capacity, dtype.max_len), dtype=torch.uint8,
                        device=device), validity, dtype,
            torch.zeros(capacity, dtype=torch.int32, device=device))
    shape = (capacity, 4) if (dtype.kind is TypeKind.DECIMAL and
                              dtype.precision > T.MAX_LONG_DIGITS) \
        else (capacity,)
    return DeviceColumn(torch.zeros(shape, dtype=dtype.storage_dtype,
                                    device=device), validity, dtype)


def empty_batch(schema: Schema, device: torch.device,
                capacity: int = MIN_CAPACITY) -> ColumnarBatch:
    cols = tuple(empty_column(f.dtype, device, capacity) for f in schema)
    return ColumnarBatch(cols, rows_scalar(0, device))


# ---------------------------------------------------------------------------
# Device -> host (the collect boundary)
# ---------------------------------------------------------------------------

def _string_to_arrow(col: DeviceColumn, n: int,
                     validity: np.ndarray) -> pa.Array:
    """The live rows of a string column as an Arrow string array: offsets
    from the lengths, and the row-major bytes under each length, which are
    Arrow's character buffer as they stand. A dictionary column decodes
    here, on the host: the codes and the small dictionary come down, and
    per-row bytes never live on the device."""
    if col.dict_data is not None:
        dmat = col.dict_data.cpu().numpy()
        dlens = col.dict_lengths.cpu().numpy()
        codes = np.clip(col.data[:n].cpu().numpy(), 0, dmat.shape[0] - 1)
        mat = dmat[codes]
        lens = np.where(validity, dlens[codes], 0)
    else:
        lens = np.where(validity, col.lengths[:n].cpu().numpy(), 0)
        mat = col.data[:n].cpu().numpy()
    chars = mat[np.arange(mat.shape[1])[None, :] < lens[:, None]]
    offsets = np.zeros(n + 1, np.int32)
    np.cumsum(lens, out=offsets[1:])
    return pa.StringArray.from_buffers(
        n, pa.py_buffer(offsets.tobytes()), pa.py_buffer(chars.tobytes()),
        None if validity.all() else
        pa.py_buffer(np.packbits(validity, bitorder="little").tobytes()))


def _validity_buffer(validity: np.ndarray) -> Optional[pa.Buffer]:
    if validity.all():
        return None
    return pa.py_buffer(np.packbits(validity, bitorder="little").tobytes())


def _decimal_to_arrow(data: np.ndarray, dtype: SqlType,
                      validity: np.ndarray) -> pa.Array:
    """Unscaled int64 values as an Arrow decimal128 array, exactly: each
    value sign-extended to 16 little-endian bytes, null slots zero. A
    valid value of more digits than the type's precision raises, as
    ``pa.array`` does, rather than build an invalid array."""
    bound = 10 ** dtype.precision
    over = validity & ((data <= -bound) | (data >= bound))
    if over.any():
        raise pa.ArrowInvalid(
            f"{int(over.sum())} value(s) exceed the precision of {dtype}, "
            f"e.g. unscaled {int(data[over][0])}")
    words = np.empty((data.shape[0], 2), np.int64)
    words[:, 0] = np.where(validity, data, 0)
    words[:, 1] = words[:, 0] >> 63
    return pa.Array.from_buffers(T.to_arrow(dtype), data.shape[0],
                                 [_validity_buffer(validity),
                                  pa.py_buffer(words.tobytes())])


def to_arrow(batch: ColumnarBatch, schema: Schema) -> pa.Table:
    n = int(batch.num_rows)
    arrays = []
    for col, f in zip(batch.columns, schema):
        k = f.dtype.kind
        validity = col.validity[:n].cpu().numpy()
        if k is TypeKind.STRING:
            arrays.append(_string_to_arrow(col, n, validity))
            continue
        if k is TypeKind.NULL:
            arrays.append(pa.nulls(n))
            continue
        data = col.data[:n].cpu().numpy()
        if k is TypeKind.DECIMAL and data.ndim > 1:
            from .expressions.decimal128 import limbs_to_arrow
            arrays.append(limbs_to_arrow(data, f.dtype, validity))
            continue
        if k is TypeKind.DECIMAL:
            arrays.append(_decimal_to_arrow(data, f.dtype, validity))
            continue
        if k is TypeKind.DATE:
            data = data.astype("datetime64[D]")
        elif k is TypeKind.TIMESTAMP:
            data = data.astype("datetime64[us]")
        arrays.append(pa.array(data, type=T.to_arrow(f.dtype),
                               mask=~validity))
    return pa.table(arrays, names=schema.names)
