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
compaction, pad and concatenation keeps that trailing dimension. A
dictionary-encoded string column (``dictenc.py``) holds int32 codes in
``data``, no ``lengths``, and its sorted distinct entries in
``dict_data``/``dict_lengths``.

The nested kinds keep the JAX package's layouts. A STRUCT column holds a
tuple of child columns in ``data`` beside its own validity lane; a field of
a null struct is null, and a struct's leaves are never dictionary-encoded.
An ARRAY of scalars is ``data[capacity, max_elems]`` with its element
counts in ``lengths``; an ``array<string>`` is ``uint8[capacity, max_elems,
max_len]`` with each element's byte length in ``data2``. A MAP of scalars
keeps its keys in ``data`` and its values in ``data2``, sharing one
``lengths``. Elements are never null at the upload (``TypeError``, which
the planner turns into an island), a list past its budget raises
``CapacityError``, and every row primitive (gather, pad, concatenation,
the wire) carries ``data2`` and recurses into struct children
(``map_lanes``).

Host interchange is Arrow. ``from_arrow`` is the H2D boundary, ``to_arrow``
the D2H one; ``batch_from_numpy`` rebuilds a batch from arrays taken out of
the JAX package, so a test can feed one of its intermediates to the port.
"""

from __future__ import annotations

import dataclasses
import warnings
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence, Tuple, Union

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
    capacity). A STRUCT column holds a tuple of child columns in ``data``;
    ``data2`` is a map's values, an ``array<string>``'s element byte
    lengths, or a scalar array's per-element validity (``PivotFirst``)."""

    data: Union[torch.Tensor, Tuple["DeviceColumn", ...]]
    validity: torch.Tensor          # bool; False beyond num_rows
    dtype: SqlType = T.INT32
    lengths: Optional[torch.Tensor] = None      # int32[capacity]
    dict_data: Optional[torch.Tensor] = None    # uint8[card, max_len]
    dict_lengths: Optional[torch.Tensor] = None  # int32[card]
    data2: Optional[torch.Tensor] = None        # [capacity, max_elems, ...]

    @property
    def capacity(self) -> int:
        return self.validity.shape[0]

    @property
    def is_dict(self) -> bool:
        return self.dict_data is not None

    @property
    def is_struct(self) -> bool:
        return isinstance(self.data, tuple)

    def replace(self, **changes) -> "DeviceColumn":
        """This column with some fields changed (the dictionary kept
        unless changed)."""
        return dataclasses.replace(self, **changes)

    def size_bytes(self) -> int:
        if self.is_struct:
            return (sum(c.size_bytes() for c in self.data)
                    + self.validity.numel())
        n = (self.data.numel() * self.data.element_size()
             + self.validity.numel())
        if self.lengths is not None:
            n += self.lengths.numel() * 4
        if self.data2 is not None:
            n += self.data2.numel() * self.data2.element_size()
        if self.dict_data is not None:
            n += self.dict_data.numel() + self.dict_lengths.numel() * 4
        return n


def map_lanes(col: DeviceColumn,
              fn: Callable[[torch.Tensor], torch.Tensor]) -> DeviceColumn:
    """``col`` with ``fn`` applied to each of its row lanes (data,
    validity, lengths, data2; a struct's children recursively). The
    dictionary of a dictionary column rides along untouched."""
    if col.is_struct:
        return col.replace(data=tuple(map_lanes(c, fn) for c in col.data),
                           validity=fn(col.validity))
    return col.replace(
        data=fn(col.data), validity=fn(col.validity),
        lengths=None if col.lengths is None else fn(col.lengths),
        data2=None if col.data2 is None else fn(col.data2))


def mask_validity(col: DeviceColumn, mask: torch.Tensor) -> DeviceColumn:
    """AND ``mask`` into a column's validity, struct children included, so
    that a masked row reads as null at every level."""
    if col.is_struct:
        return col.replace(data=tuple(mask_validity(c, mask)
                                      for c in col.data),
                           validity=col.validity & mask)
    return col.replace(validity=col.validity & mask)


def zip_lanes(a: DeviceColumn, b: DeviceColumn,
              fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
              ) -> DeviceColumn:
    """A column of ``a``'s layout whose every row lane is ``fn`` of the
    matching lanes of ``a`` and ``b`` (struct children recursively)."""
    if a.is_struct:
        return a.replace(data=tuple(zip_lanes(x, y, fn)
                                    for x, y in zip(a.data, b.data)),
                         validity=fn(a.validity, b.validity))
    return a.replace(
        data=fn(a.data, b.data), validity=fn(a.validity, b.validity),
        lengths=None if a.lengths is None else fn(a.lengths, b.lengths),
        data2=None if a.data2 is None else fn(a.data2, b.data2))


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


def _list_layout(arr, dtype: SqlType, what: str
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """(validity bool[n], counts int32[n], mask bool[n, me], source index
    of each kept slot into the child buffers) of a list or map array; a
    list past the budget raises ``CapacityError``."""
    n = len(arr)
    validity = (np.asarray(arr.is_valid()) if arr.null_count
                else np.ones(n, dtype=bool))
    offsets = np.asarray(arr.offsets).astype(np.int64)
    counts = np.where(validity, np.diff(offsets), 0).astype(np.int32)
    me = dtype.max_len
    if counts.size and int(counts.max()) > me:
        raise CapacityError(
            f"{what} of {int(counts.max())} elements exceeds the device "
            f"budget of {me}; raise max_elems in the scan schema or fall "
            f"back to CPU")
    mask = np.arange(me)[None, :] < counts[:, None]
    src = (offsets[:-1, None] + np.arange(me)[None, :])[mask]
    return validity, counts, mask, src


def _elements(values: pa.Array, elem_t: SqlType, mask: np.ndarray,
              src: np.ndarray, n: int) -> Tuple[np.ndarray,
                                                Optional[np.ndarray]]:
    """The [n, me] (strings: [n, me, max_len] plus [n, me] byte lengths)
    element matrix of a list's child buffer, elements at ``src`` scattered
    into the ``mask`` slots, zero elsewhere."""
    me = mask.shape[1]
    if elem_t.kind is TypeKind.STRING:
        starts, lens, chars = _string_offsets(values, elem_t.max_len)
        mat = np.zeros((n, me, elem_t.max_len), np.uint8)
        el_lens = np.zeros((n, me), np.int32)
        if src.size:
            k_lens = lens[src]
            cols = np.arange(elem_t.max_len)[None, :]
            bmask = cols < k_lens[:, None]
            gather = np.minimum(starts[src].astype(np.int64)[:, None] + cols,
                                max(chars.size - 1, 0))
            mat[mask] = np.where(bmask, chars[gather] if chars.size else 0,
                                 0).astype(np.uint8)
            el_lens[mask] = k_lens
        return mat, el_lens
    flat = _scalar_storage(values, elem_t)
    mat = np.zeros((n, me) + flat.shape[1:], dtype=flat.dtype)
    mat[mask] = flat[src]
    return mat, None


def _list_column(arr, dtype: SqlType, capacity: int,
                 device: torch.device) -> DeviceColumn:
    """A list array as ``data[cap, me]`` (+ ``data2`` byte lengths for
    string elements) and ``lengths``, or a map array as keys in ``data``
    and values in ``data2``. Null and nested elements raise
    ``TypeError``, a list past the budget ``CapacityError``: the upload
    never truncates."""
    n = len(arr)
    if n > capacity:
        raise ValueError(f"{n} rows exceed capacity {capacity}")
    if dtype.kind is TypeKind.ARRAY:
        elem_t = dtype.children[0]
        if elem_t.is_nested:
            raise TypeError(
                f"array<{elem_t}> nested elements have no device layout; "
                f"the planner must fall back to CPU")
        validity, counts, mask, src = _list_layout(arr, dtype, "list")
        values = arr.values
        if values.null_count:
            raise TypeError(
                "arrays with null elements are outside the device subset "
                "(fixed-budget arrays hold non-null elements; CPU fallback)")
        if elem_t.kind is TypeKind.DECIMAL and \
                elem_t.precision > T.MAX_LONG_DIGITS:
            raise TypeError(f"array<{elem_t}> has no device layout")
        mat, el_lens = _elements(values, elem_t, mask, src, n)
        elem_dtype = elem_t.storage_dtype
        data2 = (None if el_lens is None else
                 _padded(el_lens, torch.int32, capacity, device))
    else:
        key_t, val_t = dtype.children
        for t in (key_t, val_t):
            if t.is_string or t.is_nested:
                raise TypeError(
                    f"map<{key_t},{val_t}> device layout is fixed-width "
                    f"scalars only; the planner must fall back to CPU")
        validity, counts, mask, src = _list_layout(arr, dtype, "map")
        if arr.keys.null_count or arr.items.null_count:
            raise TypeError(
                "maps with null keys/values are outside the device subset "
                "(fixed-budget matrices hold non-null entries; CPU fallback)")
        mat, _ = _elements(arr.keys, key_t, mask, src, n)
        vmat, _ = _elements(arr.items, val_t, mask, src, n)
        elem_dtype = key_t.storage_dtype
        data2 = _padded(vmat, val_t.storage_dtype, capacity, device)
    return DeviceColumn(_padded(mat, elem_dtype, capacity, device),
                        _padded(validity, torch.bool, capacity, device),
                        dtype, _padded(counts, torch.int32, capacity, device),
                        data2=data2)


def column_from_arrow(arr, dtype: SqlType, capacity: int,
                      device: torch.device, name: str = "",
                      dict_conf: Optional[tuple] = None,
                      allow_dict: bool = True) -> DeviceColumn:
    arr = arr.combine_chunks() if isinstance(arr, pa.ChunkedArray) else arr
    if pa.types.is_dictionary(arr.type) and not allow_dict:
        arr = arr.cast(arr.type.value_type)
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
    if dtype.kind is TypeKind.STRUCT:
        # one set of lanes per field beside the struct's validity; a field
        # of a null struct is null (one level down, as in the JAX
        # package: a deeper field reads null through its own struct), and
        # the leaves stay plain
        validity = _validity(arr, capacity, device)
        kids = []
        for i, ct in enumerate(dtype.children):
            # ``field`` gives the child as the struct's slice sees it
            kid = column_from_arrow(arr.field(i), ct, capacity,
                                    device, allow_dict=False)
            kids.append(kid.replace(validity=kid.validity & validity))
        return DeviceColumn(tuple(kids), validity, dtype)
    if dtype.kind in (TypeKind.ARRAY, TypeKind.MAP):
        return _list_column(arr, dtype, capacity, device)
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
    if dtype.kind is TypeKind.STRUCT:
        return DeviceColumn(tuple(empty_column(c, device, capacity)
                                  for c in dtype.children), validity, dtype)
    if dtype.kind in (TypeKind.ARRAY, TypeKind.MAP):
        me = dtype.max_len
        first = dtype.children[0]
        lengths = torch.zeros(capacity, dtype=torch.int32, device=device)
        if first.kind is TypeKind.STRING:
            shape = (capacity, me, first.max_len)
            data = torch.zeros(shape, dtype=torch.uint8, device=device)
            data2 = (torch.zeros((capacity, me), dtype=torch.int32,
                                 device=device)
                     if dtype.kind is TypeKind.ARRAY else
                     torch.zeros((capacity, me, dtype.children[1].max_len),
                                 dtype=torch.uint8, device=device))
        else:
            data = torch.zeros((capacity, me), dtype=first.storage_dtype,
                               device=device)
            data2 = (None if dtype.kind is TypeKind.ARRAY else
                     torch.zeros((capacity, me),
                                 dtype=dtype.children[1].storage_dtype,
                                 device=device))
        return DeviceColumn(data, validity, dtype, lengths, data2=data2)
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


def _flat_to_arrow(data: np.ndarray, dtype: SqlType,
                   validity: np.ndarray) -> pa.Array:
    """Storage values of a flat kind (scalars, limbs) as an Arrow array."""
    k = dtype.kind
    if k is TypeKind.NULL:
        return pa.nulls(data.shape[0])
    if k is TypeKind.DECIMAL and data.ndim > 1:
        from .expressions.decimal128 import limbs_to_arrow
        return limbs_to_arrow(data, dtype, validity)
    if k is TypeKind.DECIMAL:
        return _decimal_to_arrow(data, dtype, validity)
    if k is TypeKind.DATE:
        data = data.astype("datetime64[D]")
    elif k is TypeKind.TIMESTAMP:
        data = data.astype("datetime64[us]")
    return pa.array(data, type=T.to_arrow(dtype), mask=~validity)


def _strings_from_matrix(mat: np.ndarray, lens: np.ndarray,
                         validity: Optional[np.ndarray] = None) -> pa.Array:
    """A padded byte matrix and its lengths as an Arrow string array."""
    chars = mat[np.arange(mat.shape[1])[None, :] < lens[:, None]]
    offsets = np.zeros(lens.shape[0] + 1, np.int32)
    np.cumsum(lens, out=offsets[1:])
    return pa.StringArray.from_buffers(
        lens.shape[0], pa.py_buffer(offsets.tobytes()),
        pa.py_buffer(np.ascontiguousarray(chars).tobytes()),
        None if validity is None else _validity_buffer(validity))


def _list_offsets(counts: np.ndarray, validity: np.ndarray) -> pa.Array:
    """Arrow list offsets of these counts, null where the row is null
    (``from_arrays`` reads a null offset as a null list)."""
    offsets = np.zeros(counts.shape[0] + 1, np.int32)
    np.cumsum(counts, out=offsets[1:])
    if validity.all():
        return pa.array(offsets, pa.int32())
    return pa.array(offsets, pa.int32(),
                    mask=np.concatenate([~validity, [False]]))


def _col_to_arrow(col: DeviceColumn, dtype: SqlType, name: str,
                  n: int) -> pa.Array:
    """One device column's first ``n`` rows as one Arrow array (struct
    children, list elements and map entries recursively vectorized: no
    loop over rows)."""
    k = dtype.kind
    validity = col.validity[:n].cpu().numpy()
    if k is TypeKind.STRUCT:
        names = dtype.names or tuple(
            f"f{i}" for i in range(len(dtype.children)))
        kids = [_col_to_arrow(c, ct, f"{name}.{nm}", n)
                for c, ct, nm in zip(col.data, dtype.children, names)]
        return pa.StructArray.from_arrays(
            kids, names=list(names),
            mask=None if validity.all() else pa.array(~validity))
    if k is TypeKind.STRING:
        return _string_to_arrow(col, n, validity)
    if k in (TypeKind.ARRAY, TypeKind.MAP):
        mat = col.data[:n].cpu().numpy()
        counts = np.where(validity, col.lengths[:n].cpu().numpy(), 0)
        if counts.size and int(counts.max()) > mat.shape[1]:
            raise CapacityError(
                f"{k.value} column '{name}' holds a list of "
                f"{int(counts.max())} elements but the device budget is "
                f"{mat.shape[1]}; raise max_elems (collect_list/set) or "
                f"fall back to CPU")
        mask = np.arange(mat.shape[1])[None, :] < counts[:, None]
        offsets = _list_offsets(counts, validity)
        first = dtype.children[0]
        if k is TypeKind.MAP:
            d2 = col.data2[:n].cpu().numpy()
            keys = _elements_to_arrow(mat[mask], first, None)
            vals = _elements_to_arrow(d2[mask], dtype.children[1], None)
            return pa.MapArray.from_arrays(offsets, keys, vals)
        d2 = None if col.data2 is None else col.data2[:n].cpu().numpy()
        values = _elements_to_arrow(mat[mask], first,
                                    None if d2 is None else d2[mask])
        return pa.ListArray.from_arrays(offsets, values)
    return _flat_to_arrow(col.data[:n].cpu().numpy(), dtype, validity)


def _elements_to_arrow(flat: np.ndarray, elem_t: SqlType,
                       extra: Optional[np.ndarray]) -> pa.Array:
    """The live elements of a list (or a map's keys or values), one per
    row of ``flat``: scalars, or padded string bytes whose lengths are
    ``extra`` (the array layout) or their trailing zeros (the map layout
    of ``StringToMap``, whose null value starts with 0xFF). A bool
    ``extra`` is per-element validity (``PivotFirst``)."""
    if elem_t.kind is TypeKind.STRING:
        if extra is None:
            from .expressions.strings import string_elem_lengths
            null = flat[:, 0] == 0xFF if flat.shape[0] else \
                np.zeros(0, bool)
            lens = string_elem_lengths(torch.from_numpy(
                np.where(null[:, None], 0, flat).astype(np.uint8))).numpy()
            return _strings_from_matrix(flat, lens,
                                        ~null if null.any() else None)
        return _strings_from_matrix(flat, extra.astype(np.int32))
    valid = (extra.astype(bool) if extra is not None
             and extra.dtype == np.bool_ else np.ones(flat.shape[0], bool))
    return _flat_to_arrow(flat, elem_t, valid)


def to_arrow(batch: ColumnarBatch, schema: Schema) -> pa.Table:
    n = int(batch.num_rows)
    arrays = [_col_to_arrow(col, f.dtype, f.name, n)
              for col, f in zip(batch.columns, schema)]
    return pa.table(arrays, names=schema.names)
