"""Joins: the sort-based hash join and the nested-loop join.

Port of ``JoinType``, ``_hash64``, ``_keys_equal``, ``_null_gather``,
``HashJoinExec`` and ``BroadcastNestedLoopJoinExec`` from
``spark_rapids_tpu/exec/join.py``. The hash join takes every join type but
CROSS, over a planned broadcast or over co-partitioned inputs:

1. BUILD: each build row gets a search word, the build side is sorted by it
   and materialized in that order; the sorted words are the hash table. A
   run-length table gives each word's duplicate count, and a build whose
   words are unique and contiguous (a primary key such as 1..n) is marked
   dense.
2. COUNT: each probe row finds its candidates: a binary search of the
   sorted words (``torch.searchsorted``), or on a dense build an offset and
   a range test. One transfer per probe batch brings the candidate total
   and the largest count to the host, to size the output.
3. EXPAND: output slot j finds its probe row by a search over the running
   candidate counts, gathers both sides and keeps verified pairs. A probe
   batch whose rows have at most one candidate each maps rows 1:1 instead.

The search word of a single int8, int16, int32, int64, date, timestamp or
boolean key is the key itself, so candidates are exact matches. Other keys take a 31-bit murmur3
row hash and every candidate is verified on the keys, so a hash collision
costs a candidate, never a wrong row.

Words are int64 here, where the JAX package sorts unsigned words: torch
sorts no uint64 and has no uint32 arithmetic. Dead and null-keyed build rows
take ``INT64_MAX`` and sort after the live rows with the same word, and
every search is clamped to the valid prefix, so a live key of ``INT64_MAX``
is still found. Hashes are uint32 values held in int64 with the JAX
package's sentinels (0xFFFFFFFF build, 0xFFFFFFFE probe). The dense path's
offset ``key - first`` can wrap in int64 when keys span more than 2^63; a
wrapped (negative) offset is out of range.

Memory discipline, as in the JAX package: the build side is admitted to
the spill catalog and built under the retry loop without a split; each
probe batch is admitted too and probed under the retry loop, halved on a
repeated OOM (a half-stream probes to the same pairs in the same stream
order). A build of more than ``max_build_rows`` rows in one partition takes
the grace join: both sides are cut into ``ceil(rows / max_build_rows)``
buckets by a murmur3 row hash with seed 77 (independent of the search
hash), the stream buckets wait in the catalog, and each bucket pair joins
through the probe loop above. The build buckets stay plain device batches,
outside the budget, as in the JAX package; here each is cut at its
row-count bucket by one sort (``partition_pieces``) where the JAX package
compacts at full capacity once per bucket. ``graceBuckets`` counts the
buckets.

``BroadcastNestedLoopJoinExec`` joins without keys, over a broadcast
build: every join type, the condition bound against the (left, right)
pair. Where the JAX package expands ``stream capacity x build capacity``
slots, the port reads each stream batch's live row count (one host read a
batch) and expands ``live stream rows x live build rows``, cut into build
tiles of at most ``max_tile_rows`` slots: the same rows without the
padding's slots (Q11's one-row build at the 128-row minimum capacity would
be 128 times the work), stream-major within a tile; tiles cut at other
sizes order the pairs differently across tiles.

The whole-stage fusion of ``exec/fuse.py`` runs the same kernels with no
host read: the build's dense flag and the 1:1 choice come in as the
branch its planning run took (``FusedStage._choose``), the candidate total
stays a device scalar, and the output is sized statically. It also uses
``_expand_masked``, the INNER expansion without its compaction, in front
of an aggregate.

Adaptive execution, as in the JAX package: over two shuffle exchanges, the
join's first look at its partitions (``num_partitions`` or a read) lays
out both exchanges' reader partitions together
(``shuffle.exchange.coordinate_join_reads``), with the skew split at
``skew_split_rows`` stream rows, suppressed for RIGHT and FULL outer joins
(their per-partition build tails need each build row probed in exactly one
reader partition). Before that, a build side that measures at most
``broadcast_switch_rows`` rows switches the join to a broadcast at run time
(never for RIGHT or FULL outer): the build exchange is read once, its
batches kept in a plain list outside the catalog's budget and probed by
every stream partition. ``close`` restores the planned mode, so a re-run
decides again from fresh statistics. The probe loop pre-splits a stream
batch over ``skew_split_rows`` rows through the retry loop's split
(``with_retry(presplit_rows=)``).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import torch

from .. import types as T
from ..adaptive import record_decision
from ..batch import (ColumnarBatch, DeviceColumn, Field, Schema,
                     bucket_capacity, empty_batch, rows_scalar, zip_lanes)
from ..config import JOIN_MAX_BUILD_ROWS
from ..dictenc import decode_column
from ..expressions.base import (BoundReference, EvalContext, Expression,
                                string_equal)
from ..expressions.hashing import murmur3_batch
from ..kernels.murmur3 import u32
from ..memory.catalog import SpillableBatch
from ..memory.retry import (SpillableInput, acquire_with_retry, admit_all,
                            register_with_retry, split_input_halves,
                            with_retry, with_retry_no_split)
from ..types import TypeKind
from .aggregate import _pad_column
from .base import BinaryExec, Exec, Metric
from .basic import bind_all
from .common import (compact, concat_all, gather_column, gather_columns,
                     lexsort, orderable_words, partition_pieces, slice_batch)


class JoinType(enum.Enum):
    INNER = "Inner"
    LEFT_OUTER = "LeftOuter"
    RIGHT_OUTER = "RightOuter"
    FULL_OUTER = "FullOuter"
    LEFT_SEMI = "LeftSemi"
    LEFT_ANTI = "LeftAnti"
    EXISTENCE = "Existence"   # left cols + exists flag (IN-subquery rewrite)
    CROSS = "Cross"


_SEMI_TYPES = (JoinType.LEFT_SEMI, JoinType.LEFT_ANTI, JoinType.EXISTENCE)
_BUILD_TAIL_TYPES = (JoinType.RIGHT_OUTER, JoinType.FULL_OUTER)
_STREAM_TAIL_TYPES = (JoinType.LEFT_OUTER, JoinType.FULL_OUTER)

#: key kinds probed on their own value, not on a hash
_EXACT_KINDS = (TypeKind.INT8, TypeKind.INT16, TypeKind.INT32,
                TypeKind.INT64, TypeKind.DATE, TypeKind.TIMESTAMP,
                TypeKind.BOOLEAN)

_WORD_MAX = torch.iinfo(torch.int64).max
#: hash sentinels: build rows with a null key, probe rows with a null key;
#: both above the 31-bit range of a real row hash
_HASH_BUILD_NULL = 0xFFFFFFFF
_HASH_PROBE_NULL = 0xFFFFFFFE

#: the largest candidate total of one probe batch, the JAX package's int32
#: offset range
_MAX_CANDIDATES = (1 << 31) - 1
#: murmur3 seed of the grace join's bucket hash (independent of ``_hash64``)
_GRACE_SEED = 77


def _hash64(cols: Sequence[DeviceColumn], valid: torch.Tensor) -> torch.Tensor:
    """The 31-bit murmur3 row hash (uint32 >> 1) in int64, and the build
    sentinel where ``valid`` is False. A 32-bit hash only adds candidates,
    which are verified on the keys."""
    h = u32(murmur3_batch(cols, 42)) >> 1
    return torch.where(valid, h, _HASH_BUILD_NULL)


def _keys_equal(a: Sequence[DeviceColumn],
                b: Sequence[DeviceColumn]) -> torch.Tensor:
    """Row-wise equality of two key lists as Spark's join sees them: a null
    key equals nothing, and double keys are normalized (NaN equals NaN,
    -0.0 equals 0.0), as their hash is. The JAX package compares doubles as
    IEEE floats, so its joins match no NaN key."""
    eq = None
    for x, y in zip(a, b):
        if x.lengths is not None:
            e = string_equal(x, y)
        elif x.data.is_floating_point():
            e = (x.data == y.data) | (torch.isnan(x.data)
                                      & torch.isnan(y.data))
        elif x.data.dim() > 1:          # DECIMAL128 limbs: whole rows
            e = (x.data == y.data).all(dim=1)
        else:
            e = x.data == y.data
        e = e & x.validity & y.validity
        eq = e if eq is None else eq & e
    return eq


def _null_gather(batch: ColumnarBatch, out_cap: int) -> List[DeviceColumn]:
    """All-null columns shaped like ``batch``'s at ``out_cap`` rows (the
    null side of an outer row)."""
    zero_idx = torch.zeros(out_cap, dtype=torch.int64, device=batch.device)
    none = torch.zeros(out_cap, dtype=torch.bool, device=batch.device)
    return [gather_column(c, zero_idx, none) for c in batch.columns]


def _pad_batch(batch: ColumnarBatch, cap: int) -> ColumnarBatch:
    if batch.capacity == cap:
        return batch
    return ColumnarBatch(tuple(_pad_column(c, cap) for c in batch.columns),
                         batch.num_rows)


def _append_rows(a: ColumnarBatch, b: ColumnarBatch,
                 cap: int) -> ColumnarBatch:
    """``a``'s live rows, then ``b``'s, in ``cap`` rows, placed on the
    device from the row-count scalars (no host read)."""
    iota = torch.arange(cap, device=a.device)
    na = a.num_rows.to(torch.int64)
    total = na + b.num_rows.to(torch.int64)
    from_a = iota < na
    live = iota < total
    ia = iota.clamp(max=a.capacity - 1)
    ib = (iota - na).clamp(0, b.capacity - 1)
    cols = []
    for ca, cb in zip(a.columns, b.columns):
        if (ca.dict_data is not None or cb.dict_data is not None) and \
                ca.dict_data is not cb.dict_data:
            # codes of two dictionaries do not mix: append the bytes
            ca, cb = decode_column(ca), decode_column(cb)
        ga, gb = gather_column(ca, ia), gather_column(cb, ib)

        def pick(x, y):
            row = from_a.view((-1,) + (1,) * (x.dim() - 1))
            return torch.where(live.view(row.shape), torch.where(row, x, y),
                               torch.zeros((), dtype=x.dtype,
                                           device=x.device))
        cols.append(zip_lanes(ga, gb, pick))
    return ColumnarBatch(tuple(cols), total.to(torch.int32))


@dataclasses.dataclass
class _BuildTable:
    """The build kernel's output: sorted words, the count of valid rows,
    per-position run lengths, the first word and the dense flag, a device
    bool (None where the probe is hashed)."""

    words: torch.Tensor
    n_valid: torch.Tensor
    runlen: torch.Tensor
    first: torch.Tensor
    dense: Optional[torch.Tensor]


class HashJoinExec(BinaryExec):
    """Equi-join; the left child streams, the right child builds."""

    def coalesce_goal_for_child(self, i):
        # the stream side wants sized batches; the build side is taken
        # whole (RequireSingleBatch)
        from .coalesce import RequireSingleBatch, TargetSize
        return TargetSize() if i == 0 else RequireSingleBatch()

    def __init__(self, left_keys: Sequence[Expression],
                 right_keys: Sequence[Expression], join_type: JoinType,
                 left: Exec, right: Exec,
                 condition: Optional[Expression] = None,
                 broadcast_build: bool = True,
                 ctx: Optional[EvalContext] = None,
                 max_build_rows: int = JOIN_MAX_BUILD_ROWS.default,
                 skew_split_rows: Optional[int] = None,
                 broadcast_switch_rows: Optional[int] = None):
        super().__init__(left, right, ctx)
        if join_type is JoinType.CROSS:
            raise ValueError("use BroadcastNestedLoopJoinExec for cross joins")
        # broadcast_build: the build side is replicated to every stream
        # partition. False: both children are hash-partitioned on the join
        # keys and partition p probes partition p.
        self.broadcast_build = broadcast_build
        self._planned_broadcast = broadcast_build
        self.max_build_rows = max_build_rows
        #: AQE: stream rows above which a partition splits (None: off)
        self.skew_split_rows = skew_split_rows
        #: AQE: measured build rows at or under which a shuffled join
        #: switches to a broadcast (None: off)
        self.broadcast_switch_rows = broadcast_switch_rows
        self._coordinated = False
        #: the runtime broadcast's build, read once from the exchange
        self._switch_build_cache: Optional[List[ColumnarBatch]] = None
        #: grace-join buckets over all partitions (0: no grace join ran)
        self.metrics["graceBuckets"] = Metric("graceBuckets")
        #: device bytes of the runtime broadcast's build, held outside the
        #: catalog's budget while the join runs (0: no switch)
        self.metrics["switchBuildBytes"] = Metric("switchBuildBytes")
        self.join_type = join_type
        self.left_keys = bind_all(left_keys, left.output_schema)
        self.right_keys = bind_all(right_keys, right.output_schema)
        for lk, rk in zip(self.left_keys, self.right_keys):
            if lk.dtype != rk.dtype:
                raise TypeError(f"join key type mismatch {lk.dtype} vs "
                                f"{rk.dtype}; planner must insert casts")

        lf, rf = left.output_schema.fields, right.output_schema.fields
        l_nullable = join_type in _BUILD_TAIL_TYPES
        r_nullable = join_type in _STREAM_TAIL_TYPES
        if join_type in (JoinType.LEFT_SEMI, JoinType.LEFT_ANTI):
            self._schema = left.output_schema
        elif join_type is JoinType.EXISTENCE:
            self._schema = Schema(list(lf) + [Field("exists", T.BOOLEAN,
                                                    False)])
        else:
            self._schema = Schema(
                [Field(f.name, f.dtype, f.nullable or l_nullable) for f in lf]
                + [Field(f.name, f.dtype, f.nullable or r_nullable)
                   for f in rf])
        self.condition = (condition.bind(self._pair_schema())
                          if condition is not None else None)
        # a single fixed-width key is probed on its own value: sorted keys
        # are the table and every candidate is a match
        self._exact_probe = (len(self.right_keys) == 1
                             and self.right_keys[0].dtype.kind
                             in _EXACT_KINDS)

    def _pair_schema(self) -> Schema:
        return Schema(list(self.left.output_schema.fields)
                      + list(self.right.output_schema.fields))

    @property
    def output_schema(self) -> Schema:
        return self._schema

    # ------------------------------------------------------------------
    # Kernels
    # ------------------------------------------------------------------

    def _probe_words(self, keys: Sequence[DeviceColumn], valid: torch.Tensor,
                     build_side: bool) -> torch.Tensor:
        """int64 search words: the key's orderable word (exact probe) or
        the verified 31-bit hash. Build rows that are not valid take the
        largest word so they sort last."""
        if self._exact_probe:
            w = orderable_words(keys[0])[0].to(torch.int64)
            return torch.where(valid, w, _WORD_MAX) if build_side else w
        h = _hash64(keys, valid)
        return h if build_side else torch.where(valid, h, _HASH_PROBE_NULL)

    def _key_cols(self, batch: ColumnarBatch, keys: Sequence[Expression]
                  ) -> Tuple[List[DeviceColumn], torch.Tensor]:
        cols = [e.eval(batch, self.ctx) for e in keys]
        valid = batch.row_mask()
        for c in cols:
            valid = valid & c.validity
        return cols, valid

    def _build_kernel(self, build: ColumnarBatch
                      ) -> Tuple[_BuildTable, ColumnarBatch]:
        """Sort the build side by search word and materialize it in that
        order, so expansion gathers build columns at sorted positions."""
        keys, valid = self._key_cols(build, self.right_keys)
        live = build.row_mask()
        cap, dev = build.capacity, build.device
        h = self._probe_words(keys, valid, build_side=True)
        iota = torch.arange(cap, device=dev)
        # valid-keyed rows by word, then live null-keyed rows (outer tails
        # need them), then dead padding: live rows stay a prefix
        rank = torch.where(valid, 0, torch.where(live, 1, 2)).to(torch.uint8)
        perm = lexsort([h, rank])
        sorted_h = h[perm].contiguous()
        n_valid = valid.sum()
        sorted_live = iota < build.num_rows
        sbuild = ColumnarBatch(
            tuple(gather_columns(build.columns, perm, sorted_live)),
            build.num_rows)
        # run length of the word at each position: the candidate count of
        # a probe that lands on a run start
        prev_ne = torch.ones(cap, dtype=torch.bool, device=dev)
        prev_ne[1:] = sorted_h[1:] != sorted_h[:-1]
        gid = torch.cumsum(prev_ne, 0) - 1
        run_start = torch.full((cap,), cap, dtype=torch.int64, device=dev)
        run_start.scatter_reduce_(0, gid, iota, "amin")
        nxt = torch.cat([run_start[1:], run_start.new_zeros(1)])
        n_runs = gid[-1] + 1
        run_len_g = torch.where(iota < n_runs - 1, nxt - run_start,
                                cap - run_start)
        # clamp runs that reach into the invalid tail [n_valid, cap)
        runlen = torch.minimum(run_len_g[gid], (n_valid - iota).clamp(min=0))
        # dense: unique words forming one contiguous range. Uniqueness is
        # part of it: {0, 2, 2} spans n - 1 too. The int64 difference may
        # wrap, which keeps equality with n - 1 exact mod 2^64.
        first = sorted_h[0]
        dense = None
        if self._exact_probe:
            # a one-element gather, not a 0-d index (which reads to the host)
            last_i = (n_valid - 1).clamp(min=0).view(1)
            dense = ((n_valid > 0) & (gid.gather(0, last_i)[0] + 1 == n_valid)
                     & (sorted_h.gather(0, last_i)[0] - first == n_valid - 1))
        return _BuildTable(sorted_h, n_valid, runlen, first, dense), sbuild

    def _count_kernel(self, stream: ColumnarBatch, table: _BuildTable,
                      dense: bool
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(lo, counts, offsets): each probe row's first candidate in the
        sorted build, its candidate count and the running count. ``dense``
        takes the offset path (the build's dense flag, read by the
        caller)."""
        keys, valid = self._key_cols(stream, self.left_keys)
        h = self._probe_words(keys, valid, build_side=False)
        if dense:
            # a unique contiguous build: position is key - first, presence
            # a range test. A key more than 2^63 above first wraps to a
            # negative offset, which the range test rejects.
            off = h - table.first
            in_r = (h >= table.first) & (off >= 0) & (off < table.n_valid)
            lo = torch.where(in_r, off, 0)
            counts = (valid & in_r).to(torch.int64)
        else:
            lo = torch.minimum(torch.searchsorted(table.words, h),
                               table.n_valid)
            last = table.words.shape[0] - 1
            at = lo.clamp(max=last)
            hit = (table.words[at] == h) & (lo < table.n_valid)
            counts = torch.where(valid & hit, table.runlen[at], 0)
        return lo, counts, torch.cumsum(counts, 0)

    def _side_gather(self, batch: ColumnarBatch, keys: Sequence[Expression],
                     idx: torch.Tensor, ok: torch.Tensor, need_keys: bool,
                     subst: Optional[Dict[int, DeviceColumn]] = None
                     ) -> Tuple[List[DeviceColumn], List[DeviceColumn]]:
        """One side's columns at ``idx`` (null outside ``ok``), and its key
        columns when ``need_keys``: a key that is a plain reference reuses
        its gathered column. ``subst`` gives columns already known by
        ordinal, which are not gathered."""
        subst = subst or {}
        cols = list(batch.columns)
        gathered_idx = [i for i in range(len(cols)) if i not in subst]
        extra, key_src = [], []
        if need_keys:
            for e in keys:
                if isinstance(e, BoundReference) and e.ordinal not in subst:
                    key_src.append(("col", e.ordinal))
                else:
                    key_src.append(("extra", len(extra)))
                    extra.append(e.eval(batch, self.ctx))
        g = gather_columns([cols[i] for i in gathered_idx] + extra, idx, ok)
        out_cols: List[Optional[DeviceColumn]] = [None] * len(cols)
        for j, i in enumerate(gathered_idx):
            out_cols[i] = g[j]
        for i, c in subst.items():
            out_cols[i] = c
        key_cols = [out_cols[i] if kind == "col"
                    else g[len(gathered_idx) + i] for kind, i in key_src]
        return out_cols, key_cols

    def _exact_subst(self, key_col_at_pairs: Optional[DeviceColumn],
                     pair_ok: torch.Tensor) -> Dict[int, DeviceColumn]:
        """Exact probe: the build key equals the probe key on every kept
        slot, so the build key column is the probe's, not a gather."""
        rk = self.right_keys[0] if self._exact_probe else None
        if not isinstance(rk, BoundReference) or key_col_at_pairs is None:
            return {}
        return {rk.ordinal: dataclasses.replace(
            key_col_at_pairs, validity=key_col_at_pairs.validity & pair_ok)}

    def _gather_pairs(self, stream: ColumnarBatch, build: ColumnarBatch,
                      lo: torch.Tensor, counts: torch.Tensor,
                      offsets: torch.Tensor, total, out_cap: int):
        """Candidate pairs at ``out_cap`` slots: both sides gathered, keys
        verified on the hash path, the condition applied. ``total``, the
        candidate count, is an int or a device scalar."""
        j = torch.arange(out_cap, device=stream.device)
        probe_row = torch.searchsorted(offsets, j, right=True).clamp(
            0, stream.capacity - 1)
        start = offsets[probe_row] - counts[probe_row]
        build_row = (lo[probe_row] + (j - start)).clamp(0, build.capacity - 1)
        in_range = j < total
        need_keys = not self._exact_probe
        s_cols, s_keys = self._side_gather(stream, self.left_keys,
                                           probe_row, in_range, need_keys)
        lk = self.left_keys[0]
        key_at_pairs = (s_cols[lk.ordinal] if self._exact_probe
                        and isinstance(lk, BoundReference) else None)
        b_cols, b_keys = self._side_gather(
            build, self.right_keys, build_row, in_range, need_keys,
            self._exact_subst(key_at_pairs, in_range))
        pair_ok = (in_range if self._exact_probe
                   else in_range & _keys_equal(s_keys, b_keys))
        if self.condition is not None:
            pairs = ColumnarBatch(tuple(s_cols + b_cols),
                                  rows_scalar(total, stream.device))
            c = self.condition.eval(pairs, self.ctx)
            pair_ok = pair_ok & c.data & c.validity
        return s_cols, b_cols, pair_ok, probe_row, build_row

    @staticmethod
    def _stream_matches(pair_ok: torch.Tensor, probe_row: torch.Tensor,
                        cap: int) -> torch.Tensor:
        """Verified pairs per stream row."""
        seg = torch.where(pair_ok, probe_row, cap)
        counts = torch.zeros(cap + 1, dtype=torch.int64,
                             device=pair_ok.device)
        return counts.index_add_(0, seg, pair_ok.to(torch.int64))[:cap]

    def _expand_kernel(self, stream, build, lo, counts, offsets, total: int,
                       unique: bool, matched_build: torch.Tensor,
                       out_cap: int):
        # at most one candidate per probe row: a 1:1 row mapping, no
        # search over the running counts and no pair compaction
        if (unique and self.condition is None
                and self.join_type in (JoinType.INNER, JoinType.LEFT_OUTER)
                and out_cap >= stream.capacity):
            return self._expand_unique(stream, build, lo, counts,
                                       matched_build, out_cap)
        return self._expand_general(stream, build, lo, counts, offsets,
                                    total, matched_build, out_cap)

    def _unique_probe_cols(self, stream, build, lo, counts):
        """Build columns gathered 1:1 at stream layout, and the verified
        pair mask."""
        matched = counts > 0
        build_row = lo.clamp(0, build.capacity - 1)
        if self._exact_probe:
            pair_ok = matched & stream.row_mask()
            key_col = (self.left_keys[0].eval(stream, self.ctx)
                       if isinstance(self.right_keys[0], BoundReference)
                       else None)
            b_cols, _ = self._side_gather(
                build, self.right_keys, build_row, matched, False,
                self._exact_subst(key_col, pair_ok))
        else:
            b_cols, b_keys = self._side_gather(build, self.right_keys,
                                               build_row, matched, True)
            s_keys = [e.eval(stream, self.ctx) for e in self.left_keys]
            pair_ok = (matched & stream.row_mask()
                       & _keys_equal(s_keys, b_keys))
        return b_cols, pair_ok

    def _expand_unique(self, stream, build, lo, counts, matched_build,
                       out_cap: int):
        b_cols, pair_ok = self._unique_probe_cols(stream, build, lo, counts)
        if self.join_type is JoinType.LEFT_OUTER:
            # every stream row stays; unmatched rows take a null build
            b_cols = [dataclasses.replace(c, validity=c.validity & pair_ok)
                      for c in b_cols]
            out = ColumnarBatch(stream.columns + tuple(b_cols),
                                stream.num_rows)
            target = bucket_capacity(out_cap + stream.capacity)
        else:
            out = compact(ColumnarBatch(stream.columns + tuple(b_cols),
                                        stream.num_rows), pair_ok)
            target = out_cap
        return _pad_batch(out, target), matched_build

    def _expand_general(self, stream, build, lo, counts, offsets, total: int,
                        matched_build_in: torch.Tensor, out_cap: int):
        s_cols, b_cols, pair_ok, probe_row, build_row = self._gather_pairs(
            stream, build, lo, counts, offsets, total, out_cap)
        pairs = compact(ColumnarBatch(tuple(s_cols + b_cols),
                                      rows_scalar(out_cap, stream.device)),
                        pair_ok)
        matched_build = matched_build_in
        if self.join_type in _BUILD_TAIL_TYPES:
            cap = build.capacity
            mark = torch.cat([matched_build_in,
                              matched_build_in.new_zeros(1)])
            mark.index_fill_(0, torch.where(pair_ok, build_row, cap), True)
            matched_build = mark[:cap]
        if self.join_type not in _STREAM_TAIL_TYPES:
            return pairs, matched_build
        matches = self._stream_matches(pair_ok, probe_row, stream.capacity)
        unmatched = stream.row_mask() & (matches == 0)
        u_batch = compact(ColumnarBatch(
            stream.columns + tuple(_null_gather(build, stream.capacity)),
            stream.num_rows), unmatched)
        out = _append_rows(pairs, u_batch,
                           bucket_capacity(out_cap + stream.capacity))
        return out, matched_build

    def _expand_masked(self, stream, build, lo, counts, offsets, total,
                       unique: bool, out_cap: int):
        """INNER expansion without the compaction: the pair batch at
        ``out_cap`` slots (every slot a row) and the mask of its verified
        pairs, for a consumer that tolerates dead rows in between, such as
        an aggregate, which key-sorts anyway (``_update_kernel(b, mask)``).
        ``unique`` (at most one candidate a probe row) maps rows 1:1."""
        if self.join_type is not JoinType.INNER:
            raise ValueError("_expand_masked serves INNER joins only")
        dev = stream.device
        if unique and out_cap >= stream.capacity:
            b_cols, pair_ok = self._unique_probe_cols(stream, build, lo,
                                                      counts)
            pairs = ColumnarBatch(stream.columns + tuple(b_cols),
                                  rows_scalar(stream.capacity, dev))
            if self.condition is not None:
                c = self.condition.eval(pairs, self.ctx)
                pair_ok = pair_ok & c.data & c.validity
            pad = out_cap - stream.capacity
            return (ColumnarBatch(_pad_batch(pairs, out_cap).columns,
                                  rows_scalar(out_cap, dev)),
                    torch.cat([pair_ok, pair_ok.new_zeros(pad)]))
        s_cols, b_cols, pair_ok, _, _ = self._gather_pairs(
            stream, build, lo, counts, offsets, total, out_cap)
        return (ColumnarBatch(tuple(s_cols + b_cols),
                              rows_scalar(out_cap, dev)), pair_ok)

    def _semi_kernel(self, stream, build, lo, counts, offsets, total,
                     out_cap: int) -> ColumnarBatch:
        if self._exact_probe and self.condition is None:
            # candidate counts are verified match counts on the exact path
            matches = counts
        else:
            _, _, pair_ok, probe_row, _ = self._gather_pairs(
                stream, build, lo, counts, offsets, total, out_cap)
            matches = self._stream_matches(pair_ok, probe_row,
                                           stream.capacity)
        if self.join_type is JoinType.LEFT_SEMI:
            return compact(stream, matches > 0)
        if self.join_type is JoinType.LEFT_ANTI:
            return compact(stream, stream.row_mask() & (matches == 0))
        exists = DeviceColumn(matches > 0, stream.row_mask(), T.BOOLEAN)
        return ColumnarBatch(stream.columns + (exists,), stream.num_rows)

    # ------------------------------------------------------------------
    # Iterator
    # ------------------------------------------------------------------

    def _maybe_coordinate(self) -> None:
        """Over two shuffle exchanges, once: try the runtime broadcast
        switch, else lay out both exchanges' reader partitions together
        (coalesce on the combined counts, skew split)."""
        if self.broadcast_build or self._coordinated:
            return
        self._coordinated = True
        from ..shuffle.exchange import (ShuffleExchangeExec,
                                        coordinate_join_reads)
        l, r = self.left, self.right
        if not (isinstance(l, ShuffleExchangeExec)
                and isinstance(r, ShuffleExchangeExec)):
            return
        if self._maybe_broadcast_switch(r):
            return
        if not (l.adaptive or r.adaptive or self.skew_split_rows):
            return
        split = self.skew_split_rows
        if self.join_type in _BUILD_TAIL_TYPES:
            # per-partition build tails stay right only while each build
            # row is probed in exactly one reader partition
            split = None
        coordinate_join_reads(l, r, l.target_rows, split)

    def _maybe_broadcast_switch(self, build_ex) -> bool:
        """The runtime shuffled -> broadcast switch: reading the build
        exchange's row counts materializes it; a build of at most
        ``broadcast_switch_rows`` rows is then replicated to every stream
        partition. Never for RIGHT or FULL outer joins. A replicated build
        probes the same pairs per stream partition as the co-partitioned
        layout does across partitions."""
        if (self.broadcast_switch_rows is None
                or self.join_type in _BUILD_TAIL_TYPES):
            return False
        build_rows = sum(build_ex.partition_row_counts())
        if build_rows > self.broadcast_switch_rows:
            return False
        record_decision(
            "broadcastSwitch",
            f"shuffled {self.join_type.name} join: build side measured "
            f"{build_rows} rows <= maxBuildRows="
            f"{self.broadcast_switch_rows} -> replicating build "
            f"(runtime broadcast)")
        self.broadcast_build = True
        return True

    def do_close(self) -> None:
        # the exchanges drop their pieces and reader specs on close: a
        # re-run must lay them out again, and decide the switch again
        self._coordinated = False
        self.broadcast_build = self._planned_broadcast
        self._switch_build_cache = None

    @property
    def num_partitions(self) -> int:
        self._maybe_coordinate()
        # with a replicated build, RIGHT/FULL outer need one matched-build
        # state over every stream row, so every stream partition folds
        # into one and the build tail is emitted once
        if self.broadcast_build and self.join_type in _BUILD_TAIL_TYPES:
            return 1
        return self.left.num_partitions

    def do_execute_partition(self, p: int) -> Iterator[ColumnarBatch]:
        self._maybe_coordinate()
        if self.broadcast_build and not self._planned_broadcast:
            # the runtime switch: the build is still a shuffle exchange,
            # read whole once (its pieces close after their read) and
            # kept for every stream partition; bounded by the switch's
            # row ceiling
            if self._switch_build_cache is None:
                self._switch_build_cache = [
                    b for cp in range(self.right.num_partitions)
                    for b in self.right.execute_partition(cp)]
                self.metrics["switchBuildBytes"].add(
                    sum(b.size_bytes() for b in self._switch_build_cache))
            build_batches = list(self._switch_build_cache)
        elif self.broadcast_build:
            build_batches = [b for cp in range(self.right.num_partitions)
                             for b in self.right.execute_partition(cp)]
        else:
            build_batches = list(self.right.execute_partition(p))
        if self.num_partitions == 1 and self.left.num_partitions > 1:
            stream_parts: Sequence[int] = range(self.left.num_partitions)
        else:
            stream_parts = (p,)
        stream_iter = (b for sp in stream_parts
                       for b in self.left.execute_partition(sp))
        build_rows = (int(torch.stack([b.num_rows for b in build_batches])
                          .sum()) if build_batches else 0)
        if build_rows > self.max_build_rows:
            yield from self._grace_join(build_batches, build_rows,
                                        stream_iter)
        else:
            yield from self._probe(build_batches, stream_iter)

    def _probe(self, build_batches: List[ColumnarBatch],
               stream_iter: Iterator[ColumnarBatch]
               ) -> Iterator[ColumnarBatch]:
        """The probe loop against one in-memory build table, under the
        retry discipline; ``build_batches`` is emptied once the catalog
        holds them. Each step runs in a profiler range of its own."""
        cat = self.catalog
        build_schema = self.right.output_schema
        build_inputs = admit_all(build_batches, build_schema, cat,
                                 name=f"{self.name}.build")
        build_batches.clear()       # the catalog holds them from here

        def build_body():
            got: List[ColumnarBatch] = []
            try:
                for binp in build_inputs:
                    got.append(binp.acquire())
                return self._build_kernel(concat_all(got, build_schema,
                                                     self.device))
            finally:
                for j in range(len(got)):
                    build_inputs[j].release()

        try:
            with torch.profiler.record_function("HashJoinExec.build"):
                table, sbuild = with_retry_no_split(
                    build_body, catalog=cat, name=f"{self.name}.build")
        finally:
            for binp in build_inputs:
                binp.close()
        # the offset path's choice, read to the host once per build
        dense = table.dense is not None and bool(table.dense)
        matched_build = torch.zeros(sbuild.capacity, dtype=torch.bool,
                                    device=sbuild.device)
        semi = self.join_type in _SEMI_TYPES

        def probe_body(item: SpillableInput):
            stream = item.acquire()
            try:
                with torch.profiler.record_function("HashJoinExec.count"):
                    lo, counts, offsets = self._count_kernel(stream, table,
                                                             dense)
                    # one transfer: the candidate total sizes the output,
                    # the largest count picks the 1:1 path
                    total, most = torch.stack([offsets[-1], counts.max()]
                                              ).tolist()
                if total > _MAX_CANDIDATES:
                    raise RuntimeError(
                        f"join candidate explosion: {total} pairs in one "
                        f"probe batch exceeds the int32 offset range; reduce "
                        f"the batch size or pre-aggregate the build side")
                out_cap = bucket_capacity(max(total, 1))
                with torch.profiler.record_function("HashJoinExec.expand"):
                    if semi:
                        return self._semi_kernel(stream, sbuild, lo, counts,
                                                 offsets, total,
                                                 out_cap), None
                    return self._expand_kernel(
                        stream, sbuild, lo, counts, offsets, total,
                        most <= 1, matched_build, out_cap)
            finally:
                item.release()

        stream_schema = self.left.output_schema
        for stream in stream_iter:
            inp = SpillableInput.admit(stream, stream_schema, cat,
                                       name=self.name)
            del stream          # the catalog holds it from here
            # the skew seam: a stream batch measured over the split rows
            # pre-splits through the retry loop's split
            for out, mb in with_retry(inp, probe_body,
                                      split=split_input_halves,
                                      catalog=cat, name=self.name,
                                      presplit_rows=self.skew_split_rows):
                if mb is not None:
                    matched_build = mb
                yield out
        if self.join_type in _BUILD_TAIL_TYPES:
            # build rows no probe matched, with a null stream side; the
            # matched state is in sorted build order, as is the tail
            unmatched = sbuild.row_mask() & ~matched_build
            null_left = _null_gather(
                empty_batch(self.left.output_schema, self.device, 1),
                sbuild.capacity)
            yield compact(ColumnarBatch(tuple(null_left) + sbuild.columns,
                                        sbuild.num_rows), unmatched)

    # ------------------------------------------------------------------
    # Grace-hash sub-partitioning
    # ------------------------------------------------------------------

    def _bucket_pids(self, batch: ColumnarBatch, keys: Sequence[Expression],
                     n_buckets: int) -> torch.Tensor:
        """Each row's bucket: pmod(murmur3(keys, seed 77), n_buckets)."""
        cols = [e.eval(batch, self.ctx) for e in keys]
        return torch.remainder(murmur3_batch(cols, _GRACE_SEED), n_buckets)

    def _cut_buckets(self, batch: ColumnarBatch, keys: Sequence[Expression],
                     n_buckets: int) -> List[Tuple[int, ColumnarBatch]]:
        """(bucket, piece) for each bucket ``batch`` has rows in, the rows
        in input order at their row-count bucket."""
        pids = self._bucket_pids(batch, keys, n_buckets)
        return [(s, piece) for s, _rows, piece
                in partition_pieces(batch, pids, n_buckets)]

    def _grace_join(self, build_batches: List[ColumnarBatch],
                    build_rows: int, stream_iter: Iterator[ColumnarBatch]
                    ) -> Iterator[ColumnarBatch]:
        """Cut both sides into ``ceil(build_rows / max_build_rows)`` buckets
        by the bucket hash of their keys (emptying ``build_batches``) and
        join each bucket pair through the probe loop. Stream buckets wait in the spill catalog, so device
        residency is the build buckets and one stream bucket's probe."""
        cat = self.catalog
        n_buckets = -(-build_rows // self.max_build_rows)
        self.metrics["graceBuckets"].add(n_buckets)
        sub_builds: List[List[ColumnarBatch]] = [[] for _ in range(n_buckets)]
        with torch.profiler.record_function("HashJoinExec.grace_split"):
            while build_batches:     # each build batch goes once it is cut
                for s, piece in self._cut_buckets(
                        build_batches.pop(0), self.right_keys, n_buckets):
                    sub_builds[s].append(piece)
        stream_schema = self.left.output_schema
        sub_stream: List[List[SpillableBatch]] = [[] for _ in
                                                  range(n_buckets)]
        try:
            for batch in stream_iter:
                with torch.profiler.record_function(
                        "HashJoinExec.grace_split"):
                    for s, piece in self._cut_buckets(batch, self.left_keys,
                                                      n_buckets):
                        sub_stream[s].append(register_with_retry(
                            piece, stream_schema, catalog=cat,
                            name=f"{self.name}.grace"))
            batch = piece = None    # the buckets hold the rows from here
            for s in range(n_buckets):
                def pieces(bucket=s):
                    for sp in sub_stream[bucket]:
                        out = acquire_with_retry(sp,
                                                 name=f"{self.name}.grace")
                        sp.done_with()
                        yield out
                builds, sub_builds[s] = sub_builds[s], []
                yield from self._probe(builds, pieces())
                for sp in sub_stream[s]:
                    sp.close()
        finally:
            for bucket in sub_stream:
                for sp in bucket:
                    sp.close()


def _trim(batch: ColumnarBatch) -> ColumnarBatch:
    """A compacted batch cut to its row count's bucket (one host read)."""
    n = int(batch.num_rows)
    cap = bucket_capacity(max(n, 1))
    return batch if cap >= batch.capacity else slice_batch(batch, 0, n, cap)


class BroadcastNestedLoopJoinExec(BinaryExec):
    """Cross or conditional nested-loop join: the left child streams, the
    right child's whole output is the build. Every stream row meets every
    build row in bounded tiles; the condition keeps pairs. RIGHT and FULL
    outer fold every stream partition into one, so that the build rows no
    pair kept are emitted once, at the end."""

    def coalesce_goal_for_child(self, i):
        from .coalesce import RequireSingleBatch, TargetSize
        return TargetSize() if i == 0 else RequireSingleBatch()

    def __init__(self, join_type: JoinType, left: Exec, right: Exec,
                 condition: Optional[Expression] = None,
                 ctx: Optional[EvalContext] = None,
                 max_tile_rows: int = 1 << 20):
        super().__init__(left, right, ctx)
        self.join_type = join_type
        self.max_tile_rows = max_tile_rows
        lf, rf = left.output_schema.fields, right.output_schema.fields
        l_nullable = join_type in _BUILD_TAIL_TYPES
        r_nullable = join_type in _STREAM_TAIL_TYPES
        if join_type in (JoinType.LEFT_SEMI, JoinType.LEFT_ANTI):
            self._schema = left.output_schema
        elif join_type is JoinType.EXISTENCE:
            self._schema = Schema(list(lf) + [Field("exists", T.BOOLEAN,
                                                    False)])
        else:
            self._schema = Schema(
                [Field(f.name, f.dtype, f.nullable or l_nullable) for f in lf]
                + [Field(f.name, f.dtype, f.nullable or r_nullable)
                   for f in rf])
        # the condition sees the (left, right) pair row, whatever the join
        # type projects out
        self.condition = (condition.bind(Schema(list(lf) + list(rf)))
                          if condition is not None else None)

    @property
    def output_schema(self) -> Schema:
        return self._schema

    @property
    def num_partitions(self) -> int:
        if self.join_type in _BUILD_TAIL_TYPES:
            return 1
        return self.left.num_partitions

    def _tiles(self, n_stream: int, n_build: int) -> Iterator[Tuple[int, int]]:
        """(offset, rows) of each build tile: at most ``max_tile_rows``
        slots against ``n_stream`` stream rows, at least one build row."""
        tile = max(self.max_tile_rows // max(n_stream, 1), 1)
        for off in range(0, n_build, tile):
            yield off, min(tile, n_build - off)

    def _tile_kernel(self, stream: ColumnarBatch, n_stream: int,
                     build: ColumnarBatch, off: int, rows: int,
                     want_pairs: bool):
        """Every (stream row, build row) pair of one tile, stream-major:
        the kept pairs compacted (when ``want_pairs``), each stream row's
        kept-pair count, and each build row's, at the build's capacity."""
        dev = stream.device
        slots = n_stream * rows
        cap = bucket_capacity(max(slots, 1))
        j = torch.arange(cap, device=dev)
        live = j < slots
        si = (j // rows).clamp(max=stream.capacity - 1)
        bi = (off + j % rows).clamp(max=build.capacity - 1)
        s_cols = gather_columns(stream.columns, si, live)
        b_cols = gather_columns(build.columns, bi, live)
        pairs = ColumnarBatch(tuple(s_cols + b_cols), rows_scalar(slots, dev))
        keep = live
        if self.condition is not None:
            c = self.condition.eval(pairs, self.ctx)
            keep = keep & c.data & c.validity
        hits = keep.to(torch.int64)
        s_m = torch.zeros(stream.capacity + 1, dtype=torch.int64, device=dev)
        s_m.index_add_(0, torch.where(keep, si, stream.capacity), hits)
        b_m = torch.zeros(build.capacity + 1, dtype=torch.int64, device=dev)
        b_m.index_add_(0, torch.where(keep, bi, build.capacity), hits)
        out = _trim(compact(pairs, keep)) if want_pairs else None
        return out, s_m[:stream.capacity], b_m[:build.capacity]

    def _stream_tail(self, stream: ColumnarBatch,
                     s_matched: torch.Tensor) -> Iterator[ColumnarBatch]:
        jt = self.join_type
        unmatched = stream.row_mask() & (s_matched == 0)
        if jt in _STREAM_TAIL_TYPES:
            null_right = _null_gather(
                empty_batch(self.right.output_schema, self.device, 1),
                stream.capacity)
            yield _trim(compact(ColumnarBatch(
                stream.columns + tuple(null_right), stream.num_rows),
                unmatched))
        elif jt is JoinType.LEFT_SEMI:
            yield compact(stream, s_matched > 0)
        elif jt is JoinType.LEFT_ANTI:
            yield compact(stream, unmatched)
        elif jt is JoinType.EXISTENCE:
            exists = DeviceColumn(s_matched > 0, stream.row_mask(),
                                  T.BOOLEAN)
            yield ColumnarBatch(stream.columns + (exists,), stream.num_rows)

    def do_execute_partition(self, p: int) -> Iterator[ColumnarBatch]:
        builds = [b for cp in range(self.right.num_partitions)
                  for b in self.right.execute_partition(cp)]
        jt = self.join_type
        pair_out = jt not in _SEMI_TYPES
        if jt in (JoinType.INNER, JoinType.CROSS):
            # no match state across build batches: each batch is a build
            # of its own, with no concatenation
            for stream in self.left.execute_partition(p):
                n_stream = int(stream.num_rows)
                for build in builds:
                    for off, rows in self._tiles(n_stream,
                                                 int(build.num_rows)):
                        out, _, _ = self._tile_kernel(stream, n_stream,
                                                      build, off, rows, True)
                        yield out
            return
        build = concat_all(builds, self.right.output_schema, self.device)
        builds.clear()
        n_build = int(build.num_rows)
        if self.num_partitions == 1 and self.left.num_partitions > 1:
            stream_parts: Sequence[int] = range(self.left.num_partitions)
        else:
            stream_parts = (p,)
        b_matched = torch.zeros(build.capacity, dtype=torch.int64,
                                device=self.device)
        for sp in stream_parts:
            for stream in self.left.execute_partition(sp):
                n_stream = int(stream.num_rows)
                s_matched = torch.zeros(stream.capacity, dtype=torch.int64,
                                        device=self.device)
                for off, rows in self._tiles(n_stream, n_build):
                    out, s_m, b_m = self._tile_kernel(
                        stream, n_stream, build, off, rows, pair_out)
                    s_matched += s_m
                    b_matched += b_m
                    if out is not None:
                        yield out
                yield from self._stream_tail(stream, s_matched)
        if jt in _BUILD_TAIL_TYPES:
            null_left = _null_gather(
                empty_batch(self.left.output_schema, self.device, 1),
                build.capacity)
            yield _trim(compact(ColumnarBatch(tuple(null_left)
                                              + build.columns,
                                              build.num_rows),
                                build.row_mask() & (b_matched == 0)))
