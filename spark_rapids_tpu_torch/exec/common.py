"""Shared device primitives used by every operator.

Port of ``spark_rapids_tpu/exec/common.py``: row gathers, stable
compaction, concatenation (``concat_columns``, ``concat_batches``,
``concat_all``), slicing (``slice_batch``), and
the sort-key normalization with its multi-operand sort. Also
``partition_pieces``, the port's one-sort cut of a batch into per-target
pieces, which the exchange and the grace join share.

The JAX package orders rows with one lexicographic multi-operand
``jax.lax.sort``. ``torch.sort`` takes one key, so ``lexsort`` packs
adjacent narrow operands into int64 words and runs stable passes from the
least significant word up (an LSD sort); Q1's two int32 group keys take two
passes.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from .. import types as T
from ..batch import (ColumnarBatch, DeviceColumn, Schema, bucket_capacity,
                     empty_batch, map_lanes, mask_validity, rows_scalar)
from ..dictenc import decode_column
from ..types import TypeKind


# ---------------------------------------------------------------------------
# Gather / compact / concat
# ---------------------------------------------------------------------------

def gather_column(col: DeviceColumn, indices: torch.Tensor,
                  row_valid: Optional[torch.Tensor] = None) -> DeviceColumn:
    """Rows of ``col`` at ``indices``; slots outside ``row_valid`` are null
    (at every level of a struct). A dictionary column gathers its codes;
    the dictionary rides along. Every row lane is gathered: a map's
    values and an array's element lengths (``data2``) and a struct's
    children too."""
    idx = indices.clamp(0, col.capacity - 1)
    out = map_lanes(col, lambda a: a[idx])
    return out if row_valid is None else mask_validity(out, row_valid)


def gather_columns(cols: Sequence[DeviceColumn], indices: torch.Tensor,
                   row_valid: Optional[torch.Tensor] = None
                   ) -> List[DeviceColumn]:
    return [gather_column(c, indices, row_valid) for c in cols]


def gather(batch: ColumnarBatch, indices: torch.Tensor, num_rows,
           row_valid: Optional[torch.Tensor] = None) -> ColumnarBatch:
    cols = tuple(gather_columns(batch.columns, indices, row_valid))
    return ColumnarBatch(cols, rows_scalar(num_rows, batch.device))


def compaction_indices(keep: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(gather indices, kept count): kept rows first, in their order."""
    indices = torch.sort((~keep).to(torch.uint8), stable=True).indices
    return indices, keep.sum(dtype=torch.int32)


def compact(batch: ColumnarBatch, keep: torch.Tensor) -> ColumnarBatch:
    """Remove rows where ``keep`` is False."""
    indices, count = compaction_indices(keep & batch.row_mask())
    live = torch.arange(batch.capacity, device=batch.device) < count
    return gather(batch, indices, count, live)


def concat_columns(cols: Sequence[DeviceColumn], counts: Sequence[int],
                   capacity: int,
                   device: Optional[torch.device] = None) -> DeviceColumn:
    """One column of ``capacity`` rows on ``device`` (default: the first
    piece's): rows ``[0, counts[i])`` of piece i at offset
    ``sum(counts[:i])``, copied without a host wait (a peer copy for a
    piece on another card). Dictionary codes concatenate as they are where
    every piece shares one dictionary object (one upstream batch, or
    ``dictenc.unify_dict_batches`` before); otherwise the pieces decode."""
    first = cols[0]
    if first.is_struct:
        kids = tuple(concat_columns([c.data[j] for c in cols], counts,
                                    capacity, device)
                     for j in range(len(first.data)))
        validity = concat_columns(
            [DeviceColumn(c.validity, c.validity, T.BOOLEAN) for c in cols],
            counts, capacity, device).data
        return DeviceColumn(kids, validity, first.dtype)
    if any(c.dict_data is not None for c in cols):
        if first.dict_data is not None and all(
                c.dict_data is first.dict_data for c in cols) and (
                device is None or first.dict_data.device == device):
            out = concat_columns([c.replace(dict_data=None,
                                            dict_lengths=None)
                                  for c in cols], counts, capacity, device)
            return out.replace(dict_data=first.dict_data,
                               dict_lengths=first.dict_lengths)
        cols = [decode_column(c) for c in cols]
        first = cols[0]
    dev = device or first.data.device
    data = torch.zeros((capacity,) + tuple(first.data.shape[1:]),
                       dtype=first.data.dtype, device=dev)
    validity = torch.zeros(capacity, dtype=torch.bool, device=dev)
    lengths = (None if first.lengths is None
               else torch.zeros(capacity, dtype=first.lengths.dtype,
                                device=dev))
    data2 = (None if first.data2 is None
             else torch.zeros((capacity,) + tuple(first.data2.shape[1:]),
                              dtype=first.data2.dtype, device=dev))
    off = 0
    for c, n in zip(cols, counts):
        if n:
            data[off:off + n].copy_(c.data[:n], non_blocking=True)
            validity[off:off + n].copy_(c.validity[:n], non_blocking=True)
            if lengths is not None:
                lengths[off:off + n].copy_(c.lengths[:n], non_blocking=True)
            if data2 is not None:
                data2[off:off + n].copy_(c.data2[:n], non_blocking=True)
        off += n
    return DeviceColumn(data, validity, first.dtype, lengths, data2=data2)


def concat_batches(batches: Sequence[ColumnarBatch],
                   capacity: int) -> ColumnarBatch:
    """Live rows of each batch, one after another, in ``capacity`` rows."""
    counts = [int(b.num_rows) for b in batches]
    total = sum(counts)
    if total > capacity:
        raise ValueError(f"{total} rows exceed capacity {capacity}")
    cols = tuple(concat_columns([b.columns[i] for b in batches], counts,
                                capacity)
                 for i in range(len(batches[0].columns)))
    return ColumnarBatch(cols, rows_scalar(total, batches[0].device))


def concat_all(batches: Sequence[ColumnarBatch], schema: Schema,
               device: torch.device) -> ColumnarBatch:
    """The batches as one: an empty batch of ``schema`` for none, the batch
    itself for one, else their concatenation."""
    if not batches:
        return empty_batch(schema, device)
    if len(batches) == 1:
        return batches[0]
    return concat_batches(batches, bucket_capacity(
        sum(b.capacity for b in batches)))


def _int64_scalar(v, device: torch.device) -> torch.Tensor:
    """An int or scalar tensor as an int64 scalar on ``device``; an int is
    filled in on the device (no host copy, so capture-safe)."""
    if isinstance(v, torch.Tensor):
        return v.to(device=device, dtype=torch.int64)
    return torch.full((), v, dtype=torch.int64, device=device)


def slice_batch(batch: ColumnarBatch, start, count,
                capacity: Optional[int] = None) -> ColumnarBatch:
    """Rows ``[start, start + count)`` as a new batch of ``capacity`` rows
    (default: the input's). ``start`` and ``count`` are ints or scalar
    tensors; nothing is read back to the host."""
    cap = capacity or batch.capacity
    dev = batch.device
    start = _int64_scalar(start, dev)
    iota = torch.arange(cap, device=dev)
    n = torch.minimum(_int64_scalar(count, dev),
                      (batch.num_rows.to(torch.int64) - start).clamp(min=0))
    return gather(batch, iota + start, n, iota < n)


def partition_pieces(batch: ColumnarBatch, pids: torch.Tensor,
                     n: int) -> Iterator[Tuple[int, int, ColumnarBatch]]:
    """(partition, rows, piece) for each partition that gets rows; each
    piece holds its rows in input order at capacity bucket_capacity(rows)."""
    key = torch.where(batch.row_mask(), pids.to(torch.int64), n)
    perm = torch.sort(key, stable=True).indices      # dead rows last
    counts = torch.bincount(key, minlength=n + 1)[:n].tolist()
    last = perm.shape[0] - 1
    off = 0
    for p, rows in enumerate(counts):
        if rows:
            iota = torch.arange(bucket_capacity(rows), device=batch.device)
            idx = perm[(iota + off).clamp(max=last)]
            yield p, rows, gather(batch, idx, rows, iota < rows)
        off += rows


# ---------------------------------------------------------------------------
# Sort-key normalization
# ---------------------------------------------------------------------------

_SIGN_BIT = -(1 << 63)


def _string_words(data: torch.Tensor) -> torch.Tensor:
    """int64[n, ceil(max_len / 8)]: each 8 bytes of a padded string matrix
    as one big-endian word with its sign bit flipped, so signed order is the
    bytes' unsigned lexicographic order (torch sorts no uint64)."""
    n, ml = data.shape
    w = -(-ml // 8)
    padded = F.pad(data, (0, 8 * w - ml)) if ml % 8 else data
    big_endian = padded.reshape(n, w, 8).flip(-1).contiguous()
    return big_endian.view(torch.int64).reshape(n, w) ^ _SIGN_BIT


def orderable_words(col: DeviceColumn) -> List[torch.Tensor]:
    """Tensors whose lexicographic order under torch's own comparison is
    the column's SQL ascending order. Floats and doubles give a NaN-flag
    word first, so NaN ranks greatest (Spark), and compare as floats, so
    -0.0 == 0.0 (the JAX package orders float32 by its bits, -0.0 below
    0.0). Strings give their 8-byte words, whose zero padding orders "a"
    before "ab", then their length, which orders "a" before "a\x00".
    int8, int16 and NULL columns widen to int32; int32, date, int64,
    timestamp and decimal (unscaled, one scale per column) sort on their
    signed value; a DECIMAL128 column on its (hi, lo) limb words
    (``decimal128.orderable_words128``), whose equality is the limb rows'
    equality. A dictionary string column gives its int32 code: its
    dictionary is sorted in this same string order (``dictenc.py``
    invariant 2), so within one column code order is string order."""
    k = col.dtype.kind
    if col.dtype.is_nested:
        raise TypeError(f"{col.dtype} sort/partition keys have no device "
                        f"order (planner tags them for CPU fallback)")
    if k is TypeKind.STRING and col.dict_data is not None:
        return [col.data]
    if k is TypeKind.STRING:
        words = _string_words(col.data)
        return [words[:, i] for i in range(words.shape[1])] + [col.lengths]
    if k is TypeKind.BOOLEAN:
        return [col.data.to(torch.uint8)]
    if col.dtype.is_fractional:
        nan = torch.isnan(col.data)
        return [nan.to(torch.uint8), torch.where(nan, 0.0, col.data)]
    if col.data.dtype in (torch.int8, torch.int16):
        return [col.data.to(torch.int32)]
    if col.data.dim() > 1:
        from ..expressions.decimal128 import orderable_words128
        return orderable_words128(col.data)
    return [col.data]


def may_skip_null_lane(expr) -> bool:
    """True when a key expression provably never yields null rows: only a
    direct reference to a schema-non-nullable column."""
    from ..expressions.base import BoundReference
    return isinstance(expr, BoundReference) and not expr.nullable


def sort_operands(cols: Sequence[DeviceColumn], descending: Sequence[bool],
                  nulls_first: Sequence[bool], live: torch.Tensor,
                  nullable: Optional[Sequence[bool]] = None
                  ) -> List[torch.Tensor]:
    """Key operands of a multi-column sort, most significant first.

    Dead rows (beyond num_rows) always sort last, whatever the direction.
    A null-rank uint8 operand precedes each nullable column's words, whose
    null rows are zeroed so that null == null holds word by word."""
    ops: List[torch.Tensor] = [(~live).to(torch.uint8)]
    if nullable is None:
        nullable = [True] * len(cols)
    for col, desc, nf, nl in zip(cols, descending, nulls_first, nullable):
        if nl:
            rank = torch.where(col.validity, 1, 0 if nf else 2)
            ops.append(torch.where(live, rank, 3).to(torch.uint8))
        for w in orderable_words(col):
            if nl:
                w = torch.where(col.validity, w, torch.zeros_like(w))
            if desc:
                w = -w if w.is_floating_point() else ~w
            ops.append(w)
    return ops


def adjacent_equal_ops(ops: Sequence[torch.Tensor]) -> torch.Tensor:
    """eq[i] = row i equals row i-1 on every operand; eq[0] = False."""
    eq = torch.ones(ops[0].shape[0], dtype=torch.bool, device=ops[0].device)
    eq[0] = False
    for w in ops:
        eq[1:] &= w[1:] == w[:-1]
    return eq


#: bits an operand of this dtype takes when packed into an int64 sort word
_FIELD_BITS = {torch.uint8: 8, torch.int32: 32}


def lexsort(ops: Sequence[torch.Tensor]) -> torch.Tensor:
    """Stable permutation (int64) ordering rows by ``ops`` lexicographically,
    most significant first: the counterpart of ``jax.lax.sort`` over the
    operands plus an iota key.

    Adjacent uint8/int32 operands pack into one non-negative int64 word
    while they fit in 63 bits (int32 offset by 2^31); int64 and float64
    operands sort in a pass of their own. Passes run from the least
    significant word up, each a stable sort of the word permuted so far."""
    words: List[torch.Tensor] = []       # least significant first
    packed, bits = None, 0
    for w in reversed(ops):
        width = _FIELD_BITS.get(w.dtype)
        if width is None or (packed is not None and bits + width > 63):
            if packed is not None:
                words.append(packed)
            packed, bits = None, 0
        if width is None:
            words.append(w)
            continue
        field = w.to(torch.int64)
        if w.dtype == torch.int32:
            field = field + (1 << 31)
        packed = field if packed is None else packed | (field << bits)
        bits += width
    if packed is not None:
        words.append(packed)
    perm = None
    for word in words:
        key = word if perm is None else word[perm]
        order = torch.sort(key, stable=True).indices
        perm = order if perm is None else perm[order]
    return perm
