"""Dictionary-encoded string columns: the compressed data plane.

Port of ``spark_rapids_tpu/dictenc.py``. A dictionary-encoded STRING column
rides in the ordinary ``DeviceColumn``::

    data         int32[cap]        per-row code into the dictionary
    dict_data    uint8[card, ml]   distinct padded UTF-8 strings
    dict_lengths int32[card]       byte length per dictionary entry

with ``lengths`` None (per-row lengths are ``dict_lengths[codes]`` at
decode).

INVARIANTS (everything downstream relies on these):
  1. Only STRING columns are ever dict-encoded.
  2. Dictionary entries are DISTINCT ``(bytes, length)`` pairs in ascending
     byte-lexicographic order with the length as tiebreak: exactly the
     string order of ``exec.common.orderable_words`` (zero-padded 8-byte
     words, then the length). So within one column *code equality ==
     string equality* and *code order == string order*: group-by and sort
     keys compare one int32 lane instead of ``max_len/8 + 1`` words.
  3. Null rows carry code 0 with validity False.
  4. ``card`` is bucketed to a power of two (>= 8); padding entries are
     all-zero, and no live code references them.

Every gather through codes clamps them into ``[0, card)``, as the JAX
package's ``jnp.clip`` does: on CUDA an index out of range is a device-side
assert that poisons the context, not a clipped read.

Cross-batch sites (the exchange read, the coalesce) unify per-batch
dictionaries with a device code remap (``unify_dict_batches``), which
reads the small dictionaries to the host, so it never runs inside a
captured CUDA graph; any site that cannot prove a shared dictionary
decodes instead (one gather, bit for bit the padded-matrix form).
"""

from __future__ import annotations

import dataclasses
import threading
from typing import List, Optional, Sequence, Tuple

import numpy as np
import pyarrow as pa
import torch

from .batch import (ColumnarBatch, DeviceColumn, StringOverflowError,
                    _host_tensor, _validity)
from .types import SqlType, TypeKind

MIN_DICT_CAPACITY = 8


def bucket_card(card: int) -> int:
    """Dictionary capacity bucket (power of two, >= MIN_DICT_CAPACITY)."""
    if card <= MIN_DICT_CAPACITY:
        return MIN_DICT_CAPACITY
    return 1 << (card - 1).bit_length()


# ---------------------------------------------------------------------------
# fallback reason ring: cardinality is runtime information, so the reason
# records here and Session.dict_fallbacks() surfaces it
# ---------------------------------------------------------------------------

_FALLBACKS: dict = {}        # reason -> sequence number of its LAST record
_FALLBACK_SEQ = 0
_FALLBACK_CAP = 256          # reasons embed per-batch numbers: evict the
#                              oldest-recorded past the cap
_FALLBACK_LOCK = threading.Lock()


def record_fallback(reason: str) -> None:
    global _FALLBACK_SEQ
    with _FALLBACK_LOCK:
        _FALLBACK_SEQ += 1
        _FALLBACKS[reason] = _FALLBACK_SEQ
        if len(_FALLBACKS) > _FALLBACK_CAP:
            del _FALLBACKS[min(_FALLBACKS, key=_FALLBACKS.get)]


def fallback_mark() -> int:
    """Sequence watermark: reasons recorded after it show up in
    ``fallback_reasons(since=mark)``; a repeat of a reason moves it past
    the mark again."""
    with _FALLBACK_LOCK:
        return _FALLBACK_SEQ


def fallback_reasons(since: int = 0) -> List[str]:
    with _FALLBACK_LOCK:
        return [r for r, s in _FALLBACKS.items() if s > since]


def clear_fallbacks() -> None:
    with _FALLBACK_LOCK:
        _FALLBACKS.clear()


_MERGED_PIECES = 0


def merged_pieces() -> int:
    """Pieces whose codes ``unify_dict_columns`` remapped onto a merged
    dictionary in this process (a byte-identical dictionary is not a
    merge)."""
    return _MERGED_PIECES


def dict_conf(conf=None) -> Tuple[bool, int, float]:
    """(enabled, max_cardinality, max_cardinality_fraction) from a
    ``RapidsTpuConf``, a plain dict of settings or the registry
    defaults."""
    from .config import (DICT_ENCODING_ENABLED, DICT_MAX_CARDINALITY,
                         DICT_MAX_CARD_FRACTION, RapidsTpuConf)
    c = conf if isinstance(conf, RapidsTpuConf) else RapidsTpuConf(conf)
    return (bool(c.get(DICT_ENCODING_ENABLED.key)),
            int(c.get(DICT_MAX_CARDINALITY.key)),
            float(c.get(DICT_MAX_CARD_FRACTION.key)))


# ---------------------------------------------------------------------------
# host-side encode (np.unique gives the sorted-distinct invariant)
# ---------------------------------------------------------------------------

def _sort_keys(mat: np.ndarray, lengths: np.ndarray) -> np.ndarray:
    """Void-typed memcmp keys whose order is (bytes, length): the padded
    bytes (0x00 sorts below content), then the big-endian length, which
    breaks ties between strings that differ only in trailing NULs."""
    ml = mat.shape[1]
    be_len = np.ascontiguousarray(
        lengths.astype(">i4")).view(np.uint8).reshape(-1, 4)
    keyed = np.ascontiguousarray(np.concatenate([mat, be_len], axis=1))
    return keyed.view(np.dtype((np.void, ml + 4))).reshape(-1)


def encode_strings_np(mat: np.ndarray, lengths: np.ndarray,
                      validity: np.ndarray
                      ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(dict_mat[card, ml], dict_lens[card], codes[n]) from a padded byte
    matrix. The dictionary is sorted-distinct over VALID rows; null rows
    get code 0. ``card`` is the true cardinality (bucket separately)."""
    n, ml = mat.shape
    lengths = np.where(validity, lengths, 0).astype(np.int32)
    mat = np.where(validity[:, None], mat, 0).astype(np.uint8)
    if not validity.any():
        return (np.zeros((0, ml), np.uint8), np.zeros(0, np.int32),
                np.zeros(n, np.int32))
    keys = _sort_keys(mat, lengths)
    uniq, inv = np.unique(keys[validity], return_inverse=True)
    inv = inv.reshape(-1)
    # the first row of each distinct key represents it: written in
    # reverse, so the first occurrence lands last
    first = np.full(len(uniq), -1, np.int64)
    vidx = np.nonzero(validity)[0]
    first[inv[::-1]] = vidx[::-1]
    codes = np.zeros(n, np.int32)
    codes[validity] = inv.astype(np.int32)
    return mat[first], lengths[first], codes


def _pad_dict(dict_mat: np.ndarray, dict_lens: np.ndarray
              ) -> Tuple[np.ndarray, np.ndarray]:
    card = dict_mat.shape[0]
    cap = bucket_card(card)
    if cap == card:
        return dict_mat, dict_lens
    pm = np.zeros((cap, dict_mat.shape[1]), np.uint8)
    pm[:card] = dict_mat
    pl = np.zeros(cap, np.int32)
    pl[:card] = dict_lens
    return pm, pl


def _to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    return _host_tensor(np.ascontiguousarray(a)).to(device)


def _dict_column(codes: torch.Tensor, validity: torch.Tensor,
                 dtype: SqlType, dict_mat: np.ndarray,
                 dict_lens: np.ndarray) -> DeviceColumn:
    dev = codes.device
    return DeviceColumn(codes, validity, dtype, None,
                        _to_device(dict_mat, dev), _to_device(dict_lens, dev))


def encode_column(col: DeviceColumn,
                  max_card: Optional[int] = None) -> Optional[DeviceColumn]:
    """Host round trip encode of a PLAIN string column (a test and bench
    utility; the scan boundary encodes straight from Arrow). None when the
    true cardinality exceeds ``max_card``."""
    assert col.dtype.kind is TypeKind.STRING and col.dict_data is None
    dm, dl, codes = encode_strings_np(col.data.cpu().numpy(),
                                      col.lengths.cpu().numpy(),
                                      col.validity.cpu().numpy())
    if max_card is not None and dm.shape[0] > max_card:
        return None
    dm, dl = _pad_dict(dm, dl)
    return _dict_column(_to_device(codes, col.validity.device),
                        col.validity, col.dtype, dm, dl)


def encode_batch(batch: ColumnarBatch, schema,
                 max_card: Optional[int] = None) -> ColumnarBatch:
    """Encode every plain string column (a test and bench utility)."""
    cols = []
    for c, f in zip(batch.columns, schema):
        if f.dtype.kind is TypeKind.STRING and c.dict_data is None:
            c = encode_column(c, max_card) or c
        cols.append(c)
    return ColumnarBatch(tuple(cols), batch.num_rows)


# ---------------------------------------------------------------------------
# device-side decode (one gather; bit for bit the padded-matrix layout)
# ---------------------------------------------------------------------------

def _codes_index(col: DeviceColumn) -> torch.Tensor:
    """The column's codes clamped into the dictionary, as gather indices."""
    return col.data.clamp(0, col.dict_data.shape[0] - 1).to(torch.int64)


def decode_column(col: DeviceColumn) -> DeviceColumn:
    """Dict column -> plain padded-matrix column (capture-safe: no host
    read)."""
    if col.dict_data is None:
        return col
    idx = _codes_index(col)
    data = col.dict_data[idx]
    lengths = col.dict_lengths[idx]
    # invalid rows carry no bytes, as an uploaded plain column
    data = torch.where(col.validity[:, None], data, 0)
    lengths = torch.where(col.validity, lengths, 0)
    return DeviceColumn(data, col.validity, col.dtype, lengths)


def decode_batch(batch: ColumnarBatch) -> ColumnarBatch:
    if not any(c.dict_data is not None for c in batch.columns):
        return batch
    return ColumnarBatch(tuple(decode_column(c) for c in batch.columns),
                         batch.num_rows)


def dict_entries_column(col: DeviceColumn) -> DeviceColumn:
    """The dictionary itself as a [card]-row plain string column: the
    domain of a predicate or a hash evaluated once per DISTINCT value and
    then gathered through the codes (``gather_entries``)."""
    assert col.dict_data is not None
    card = col.dict_data.shape[0]
    return DeviceColumn(col.dict_data,
                        torch.ones(card, dtype=torch.bool,
                                   device=col.dict_data.device),
                        col.dtype, col.dict_lengths)


def gather_entries(per_entry: torch.Tensor, col: DeviceColumn
                   ) -> torch.Tensor:
    """``per_entry[codes]``: a [card] result of ``dict_entries_column``
    spread to the column's rows."""
    return per_entry[_codes_index(col)]


# ---------------------------------------------------------------------------
# cross-batch dictionary unification (device code remap)
# ---------------------------------------------------------------------------

def unify_dict_columns(cols: Sequence[DeviceColumn]
                       ) -> Optional[List[DeviceColumn]]:
    """Re-express dict columns (one logical column, per-batch
    dictionaries) over ONE merged sorted dictionary: a host merge of the
    small dictionaries, then one device gather a piece for the codes.
    None when a piece is not dict-encoded, or when the merged cardinality
    would pass the ``dictEncoding.maxCardinality`` registry default (the
    caller decodes). Reads the dictionaries to the host: never inside a
    captured graph.

    Bucket padding entries (all zero, length 0) read like a real "" entry,
    so the union may hold one phantom "" entry that no live code
    references: one entry of wire overhead, never a wrong row."""
    if not cols or any(c.dict_data is None for c in cols):
        return None
    first = cols[0].dict_data
    if len(cols) == 1 or all(c.dict_data is first for c in cols[1:]):
        return list(cols)
    mats = [c.dict_data.cpu().numpy() for c in cols]
    lens = [c.dict_lengths.cpu().numpy() for c in cols]
    if all(m.shape == mats[0].shape and np.array_equal(m, mats[0])
           and np.array_equal(l, lens[0])
           for m, l in zip(mats[1:], lens[1:])):
        # byte-identical dictionaries (every piece of one upstream batch
        # read back from the catalog carries its own copy): the codes
        # agree already; share ONE device object so concat keeps the codes
        return [dataclasses.replace(c, dict_data=cols[0].dict_data,
                                    dict_lengths=cols[0].dict_lengths)
                for c in cols]
    ml = max(m.shape[1] for m in mats)
    mats = [np.pad(m, ((0, 0), (0, ml - m.shape[1]))) if m.shape[1] < ml
            else m for m in mats]
    merged_keys = np.unique(np.concatenate(
        [_sort_keys(m, l) for m, l in zip(mats, lens)]))
    _, merge_max_card, _ = dict_conf()
    if len(merged_keys) > merge_max_card:
        record_fallback(
            f"merged dictionary cardinality {len(merged_keys)} across "
            f"{len(cols)} batches exceeds "
            f"spark.rapids.tpu.dictEncoding.maxCardinality="
            f"{merge_max_card}; decoding at the concat boundary instead")
        return None
    merged = merged_keys.view(np.uint8).reshape(len(merged_keys), ml + 4)
    merged_mat = np.ascontiguousarray(merged[:, :ml])
    merged_lens = np.ascontiguousarray(
        merged[:, ml:]).view(">i4").astype(np.int32).reshape(-1)
    pm, pl = _pad_dict(merged_mat, merged_lens)
    global _MERGED_PIECES
    with _FALLBACK_LOCK:
        _MERGED_PIECES += len(cols)
    dev = first.device
    dev_mat, dev_lens = _to_device(pm, dev), _to_device(pl, dev)
    out = []
    for c, m, l in zip(cols, mats, lens):
        remap = np.searchsorted(merged_keys, _sort_keys(m, l))
        remap = np.clip(remap, 0, max(len(merged_keys) - 1, 0))
        codes = gather_entries(_to_device(remap.astype(np.int32),
                                          c.data.device), c)
        out.append(DeviceColumn(codes, c.validity, c.dtype, None,
                                dev_mat, dev_lens))
    return out


def unify_dict_batches(batches: Sequence[ColumnarBatch]
                       ) -> List[ColumnarBatch]:
    """Per column position: unify when every piece is dict-encoded, decode
    when encodings are mixed, pass through otherwise. Called eagerly at
    the concat sites (the exchange read, ``CoalesceBatchesExec``), so
    ``concat_columns`` sees one shared dictionary object and keeps the
    codes."""
    if len(batches) <= 1:
        return list(batches)
    new_cols = [list(b.columns) for b in batches]
    for i in range(len(batches[0].columns)):
        cols = [b.columns[i] for b in batches]
        if any(c.dict_data is not None for c in cols):
            unified = unify_dict_columns(cols)
            if unified is None:
                unified = [decode_column(c) for c in cols]
            for bi, c in enumerate(unified):
                new_cols[bi][i] = c
    return [ColumnarBatch(tuple(cs), b.num_rows)
            for cs, b in zip(new_cols, batches)]


# ---------------------------------------------------------------------------
# arrow boundary (the scan hand-off: RLE_DICTIONARY page codes -> device)
# ---------------------------------------------------------------------------

def _strings_to_matrix(arr: pa.Array, max_len: int
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """(uint8[n, max_len], int32[n]) of a (small) string array on the host.
    A value over ``max_len`` bytes raises ``StringOverflowError``, as the
    plain upload does."""
    n = len(arr)
    if n == 0:
        return np.zeros((0, max_len), np.uint8), np.zeros(0, np.int32)
    if arr.type == pa.large_string():
        arr = arr.cast(pa.string())
    bufs = arr.buffers()
    offsets = np.frombuffer(bufs[1], dtype=np.int32, count=n + 1,
                            offset=arr.offset * 4).astype(np.int64)
    data = (np.frombuffer(bufs[2], dtype=np.uint8)
            if bufs[2] is not None else np.zeros(0, np.uint8))
    lengths = np.diff(offsets).astype(np.int32)
    if arr.null_count:
        lengths = np.where(np.asarray(arr.is_valid()), lengths, 0)
    if int(lengths.max()) > max_len:
        raise StringOverflowError(
            f"string of {int(lengths.max())} bytes exceeds device max_len "
            f"{max_len}; re-bucket the column")
    col_idx = np.arange(max_len, dtype=np.int64)[None, :]
    mask = col_idx < lengths[:, None]
    if not data.size:
        return np.zeros((n, max_len), np.uint8), lengths
    gather = np.minimum(offsets[:-1, None] + col_idx, data.size - 1)
    return np.where(mask, data[gather], 0).astype(np.uint8), lengths


def column_from_arrow_dictionary(arr, dtype: SqlType, capacity: int,
                                 device: torch.device, name: str = "",
                                 conf3: Optional[tuple] = None
                                 ) -> Optional[DeviceColumn]:
    """A dict-encoded device column from a ``pa.DictionaryArray``, with no
    per-row bytes: the byte matrix is built once per DISTINCT value and
    the codes go to the device as they are (canonicalized). None when the
    column must take the padded-matrix path (conf off, over a cardinality
    threshold, null dictionary entries), with the reason recorded."""
    enabled, max_card, max_frac = conf3 or dict_conf()
    n = len(arr)
    card = len(arr.dictionary)
    colname = f"column {name!r}: " if name else ""
    if not enabled:
        record_fallback(f"{colname}dictionary-encoded scan column decoded "
                        f"to padded bytes: "
                        f"spark.rapids.tpu.dictEncoding.enabled is false")
        return None
    if card > max_card:
        record_fallback(
            f"{colname}dictionary cardinality {card} exceeds "
            f"spark.rapids.tpu.dictEncoding.maxCardinality={max_card}; "
            f"falling back to the padded byte-matrix path")
        return None
    if n > 0 and card > max_frac * n:
        record_fallback(
            f"{colname}dictionary cardinality {card} exceeds "
            f"{max_frac:g} of {n} rows "
            f"(spark.rapids.tpu.dictEncoding.maxCardinalityFraction); "
            f"encoding would not shrink the column")
        return None
    if arr.dictionary.null_count:
        record_fallback(f"{colname}dictionary contains null entries; "
                        f"falling back to the padded byte-matrix path")
        return None
    dmat, dlens = _strings_to_matrix(arr.dictionary.cast(pa.string()),
                                     dtype.max_len)
    # canonicalize (invariant 2): an Arrow dictionary may repeat values
    # and need not be sorted; np.unique sorts and deduplicates, and the
    # codes remap through its inverse
    _, first_idx, inv = np.unique(_sort_keys(dmat, dlens),
                                  return_index=True, return_inverse=True)
    inv = inv.reshape(-1).astype(np.int32)
    dmat, dlens = dmat[first_idx], dlens[first_idx]
    validity = _validity(arr, capacity, device)
    idx_arr = arr.indices
    if idx_arr.null_count:
        idx_arr = idx_arr.fill_null(0)
    raw = np.asarray(idx_arr.to_numpy(zero_copy_only=False))
    if raw.dtype not in (np.int8, np.int16, np.int32, np.int64):
        raw = raw.astype(np.int64)
    codes = torch.zeros(capacity, dtype=torch.int32, device=device)
    if n and card:
        # the remap into the canonical order runs on the device: the
        # Arrow indices go up as they are, then one gather
        idx = _host_tensor(raw).to(device).to(torch.int64).clamp_(0, card - 1)
        codes[:n] = torch.where(validity[:n], _to_device(inv, device)[idx],
                                0)
    pm, pl = _pad_dict(dmat, dlens)
    return _dict_column(codes, validity, dtype, pm, pl)


def dictionary_encode_arrow(table: pa.Table) -> pa.Table:
    """``dictionary_encode`` every string column of an Arrow table: the
    form the RLE_DICTIONARY scan hand-off produces."""
    return pa.table(
        {c: (table[c].combine_chunks().dictionary_encode()
             if pa.types.is_string(table[c].type)
             or pa.types.is_large_string(table[c].type) else table[c])
         for c in table.column_names})


def dict_wire_bytes(batch: ColumnarBatch) -> Tuple[int, int]:
    """(encoded_bytes, raw_bytes) the batch's string lanes take on the
    wire, from the layout alone: ``raw`` is what the padded-matrix form
    ships, ``encoded`` what the current representation ships (the same
    when nothing is dict-encoded)."""
    enc = raw = 0
    for c in batch.columns:
        if c.dtype.kind is not TypeKind.STRING:
            continue
        cap = c.capacity
        ml = c.dtype.max_len
        raw += cap * ml + 4 * cap            # byte matrix + lengths
        if c.dict_data is not None:
            card = c.dict_data.shape[0]
            enc += 4 * cap + card * ml + 4 * card   # codes + dictionary
        else:
            enc += cap * ml + 4 * cap
    return enc, raw
