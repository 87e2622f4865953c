"""Parquet read/write with predicate + projection pushdown.

Port of ``spark_rapids_tpu/io/parquet.py`` (reference: GpuParquetScan.scala:96,
footer parse + row-group filtering :539-597 and rebase handling;
GpuParquetFileFormat.scala:163, the writer). Column chunks decode through
the port's own C++ decoder (``io/parquet_native.py``); a row group outside
its subset reads through pyarrow. The predicate pushes down as a pyarrow
mask or dataset filter, and footer min/max statistics prune row groups.
Pushdown is an optimization: the plan keeps its ``FilterExec`` above the
scan.
"""

from __future__ import annotations

import threading
from typing import List, Optional

import pyarrow as pa
import pyarrow.parquet as pq

from ..config import PARQUET_NATIVE_DECODE, RapidsTpuConf
from ..expressions import base as EB
from ..expressions import boolean as EBOOL
from ..expressions import comparison as EC
from ..expressions.base import Expression
from .parquet_native import _Unsupported, open_native
from .source import FileSource, _concat_normalized, reader_pool


def expression_to_arrow_filter(e: Expression):
    """Best-effort conversion of a predicate to a pyarrow compute
    expression; returns None when any part is unconvertible (the scan then
    filters post-read — pushdown is an optimization, never a semantics
    change, same contract as the reference's footer filter)."""
    import pyarrow.compute as pc
    try:
        return _convert(e, pc)
    except (NotImplementedError, AttributeError):
        return None


def _convert(e: Expression, pc):
    if isinstance(e, EB.UnresolvedColumn):
        return pc.field(e.name)
    if isinstance(e, EB.BoundReference):
        return pc.field(e.name)
    if isinstance(e, EB.Literal):
        return pc.scalar(e.value)
    if isinstance(e, EC.EqualTo):
        return _convert(e.children[0], pc) == _convert(e.children[1], pc)
    if isinstance(e, EC.LessThan):
        return _convert(e.children[0], pc) < _convert(e.children[1], pc)
    if isinstance(e, EC.LessThanOrEqual):
        return _convert(e.children[0], pc) <= _convert(e.children[1], pc)
    if isinstance(e, EC.GreaterThan):
        return _convert(e.children[0], pc) > _convert(e.children[1], pc)
    if isinstance(e, EC.GreaterThanOrEqual):
        return _convert(e.children[0], pc) >= _convert(e.children[1], pc)
    if isinstance(e, EC.Not):
        return ~_convert(e.children[0], pc)
    # IsNotNull subclasses IsNull in the port: test it first
    if isinstance(e, EC.IsNotNull):
        return ~_convert(e.children[0], pc).is_null()
    if isinstance(e, EC.IsNull):
        return _convert(e.children[0], pc).is_null()
    if isinstance(e, EBOOL.And):
        return _convert(e.children[0], pc) & _convert(e.children[1], pc)
    if isinstance(e, EBOOL.Or):
        return _convert(e.children[0], pc) | _convert(e.children[1], pc)
    if isinstance(e, EC.In):
        return _convert(e.child, pc).isin(list(e.values))
    raise NotImplementedError(type(e).__name__)


def predicate_mask(e: Expression, t: pa.Table):
    """Evaluate a pushed-down predicate DIRECTLY with pyarrow compute
    kernels (returns a boolean array), bypassing the acero expression
    engine — measurably faster on the post-decode filter hot path.
    Returns None when any node is outside the pushdown dialect (caller
    keeps the acero expression filter). Null semantics match acero's
    filter: Kleene and/or, comparisons yield null for null inputs, and
    Table.filter drops null-mask rows."""
    import pyarrow.compute as pc

    def val(x):
        if isinstance(x, (EB.UnresolvedColumn, EB.BoundReference)):
            return t.column(x.name)
        if isinstance(x, EB.Literal):
            return x.value
        raise NotImplementedError(type(x).__name__)

    def m(x):
        if isinstance(x, EBOOL.And):
            return pc.and_kleene(m(x.children[0]), m(x.children[1]))
        if isinstance(x, EBOOL.Or):
            return pc.or_kleene(m(x.children[0]), m(x.children[1]))
        if isinstance(x, EC.Not):
            return pc.invert(m(x.children[0]))
        if isinstance(x, EC.IsNotNull):
            return pc.is_valid(val(x.children[0]))
        if isinstance(x, EC.IsNull):
            return pc.is_null(val(x.children[0]))
        ops = {EC.EqualTo: pc.equal, EC.LessThan: pc.less,
               EC.LessThanOrEqual: pc.less_equal,
               EC.GreaterThan: pc.greater,
               EC.GreaterThanOrEqual: pc.greater_equal}
        fn = ops.get(type(x))
        if fn is not None:
            return fn(val(x.children[0]), val(x.children[1]))
        if isinstance(x, EC.In):
            return pc.is_in(val(x.child), value_set=pa.array(list(x.values)))
        raise NotImplementedError(type(x).__name__)

    try:
        return m(e)
    except (NotImplementedError, AttributeError, KeyError, pa.ArrowInvalid,
            pa.ArrowNotImplementedError, TypeError):
        return None


#: first proleptic-Gregorian day (1582-10-15) as days-since-epoch; values
#: below this in a legacy-Spark file carry hybrid-Julian calendar labels
GREGORIAN_CUTOVER_DAYS = -141427
#: footer key legacy Spark (2.x / 3.x LEGACY writes) stamps on files whose
#: datetimes use the hybrid calendar
LEGACY_DATETIME_KEY = b"org.apache.spark.legacyDateTime"
_US_PER_DAY = 86_400_000_000


class DatetimeRebaseError(ValueError):
    """EXCEPTION rebase mode hit an ancient datetime in a legacy file
    (Spark's SparkUpgradeException for parquet rebase)."""


def _julian_civil_from_days(z):
    """Julian-calendar (y, m, d) label for days-since-epoch (numpy)."""
    import numpy as np
    j = z.astype(np.int64) + 2440588          # julian day number at noon
    c = j + 32082
    d = (4 * c + 3) // 1461
    e = c - (1461 * d) // 4
    m = (5 * e + 2) // 153
    day = e - (153 * m + 2) // 5 + 1
    month = m + 3 - 12 * (m // 10)
    year = d - 4800 + m // 10
    return year, month, day


def _gregorian_days_from_civil(y, m, d):
    """Proleptic-Gregorian days-since-epoch for (y, m, d) (numpy; the
    vectorized Hinnant algorithm)."""
    import numpy as np
    y = y - (m <= 2)
    era = np.floor_divide(y, 400)
    yoe = y - era * 400
    mp = np.where(m > 2, m - 3, m + 9)
    doy = (153 * mp + 2) // 5 + d - 1
    doe = yoe * 365 + yoe // 4 - yoe // 100 + doy
    return (era * 146097 + doe - 719468).astype(np.int64)


def rebase_julian_to_gregorian_days(days):
    """Spark's LEGACY read rebase: keep the CALENDAR LABEL a legacy writer
    recorded (hybrid-Julian before the cutover) and re-encode it as
    proleptic-Gregorian days (reference: GpuParquetScan rebase handling /
    DateTimeRebaseUtils)."""
    import numpy as np
    days = np.asarray(days)
    ancient = days < GREGORIAN_CUTOVER_DAYS
    if not ancient.any():
        return days
    y, m, d = _julian_civil_from_days(days)
    return np.where(ancient, _gregorian_days_from_civil(y, m, d), days)


def _referenced_columns(e: Expression) -> List[str]:
    """Column names a predicate reads (order-preserving, deduped)."""
    out: List[str] = []

    def walk(x):
        if isinstance(x, (EB.UnresolvedColumn, EB.BoundReference)):
            if x.name not in out:
                out.append(x.name)
        for c in x.children:
            walk(c)
    walk(e)
    return out


def _rg_can_match(rg_md, names, pred, stats_for=None) -> bool:
    """Conservative footer min/max check: False ONLY when the predicate
    provably excludes every row of the group (reference:
    ParquetFileFilterHandler filterRowGroups). Anything unrecognized —
    computed operands, missing stats, cross-type comparisons — keeps the
    group. ``stats_for`` overrides the pyarrow metadata lookup (the
    native-footer path supplies its own)."""

    def _pyarrow_stats(name):
        try:
            j = names.index(name)
        except ValueError:
            return None
        st = rg_md.column(j).statistics
        if st is None or not st.has_min_max:
            return None
        return st.min, st.max

    stats_for = stats_for or _pyarrow_stats

    def check(e) -> bool:
        if isinstance(e, EBOOL.And):
            return check(e.children[0]) and check(e.children[1])
        if isinstance(e, EBOOL.Or):
            return check(e.children[0]) or check(e.children[1])
        if isinstance(e, (EC.EqualTo, EC.LessThan, EC.LessThanOrEqual,
                          EC.GreaterThan, EC.GreaterThanOrEqual)):
            l, r = e.children
            flip = False
            if isinstance(l, EB.Literal):
                l, r, flip = r, l, True
            if not (isinstance(l, (EB.UnresolvedColumn, EB.BoundReference))
                    and isinstance(r, EB.Literal)) or r.value is None:
                return True
            mm = stats_for(l.name)
            if mm is None:
                return True
            mn, mx = mm
            v = r.value
            try:
                if isinstance(e, EC.EqualTo):
                    return mn <= v <= mx
                lt = isinstance(e, EC.LessThan)
                le = isinstance(e, EC.LessThanOrEqual)
                gt = isinstance(e, EC.GreaterThan)
                if flip:   # lit OP col  ⇔  col (inverse OP) lit
                    lt, le, gt = gt, isinstance(e, EC.GreaterThanOrEqual), lt
                if lt:
                    return mn < v
                if le:
                    return mn <= v
                if gt:
                    return mx > v
                return mx >= v
            except TypeError:
                return True
        return True

    return check(pred)


class ParquetSource(FileSource):
    format_name = "parquet"

    def __init__(self, *a, rebase_mode: str = "EXCEPTION", **kw):
        # EXCEPTION (Spark's default) | CORRECTED | LEGACY — what to do
        # with pre-1582 dates/timestamps in files stamped with the legacy
        # hybrid-calendar footer key
        super().__init__(*a, **kw)
        #: row groups skipped by footer min/max stats vs the predicate
        self.row_groups_pruned = 0
        #: row groups read through pyarrow (outside the native subset, or
        #: native decode off); decode tasks count them from the pool
        self.row_groups_fallback = 0
        self._count_lock = threading.Lock()
        #: native C++ chunk decode (csrc/rtpu_parquet.cpp); per-row-group
        #: pyarrow fallback for anything outside the native subset
        self._native = True
        self._arrow_schemas: dict = {}
        self.rebase_mode = rebase_mode.upper()
        if self.rebase_mode not in ("EXCEPTION", "CORRECTED", "LEGACY"):
            raise ValueError(
                f"rebase_mode must be EXCEPTION, CORRECTED or LEGACY, "
                f"got {rebase_mode!r}")
        #: the predicate pushed to pyarrow and the footer statistics. None
        #: when it reads a floating-point column: those compare IEEE
        #: floats, where Spark and the port's FilterExec order NaN above
        #: every value and equal to itself, so pushing it down could drop
        #: rows the filter keeps. The FilterExec above the scan applies
        #: the predicate either way.
        self._pushed = self.predicate
        if self.predicate is not None:
            schema = self.infer_arrow_schema()
            if any(pa.types.is_floating(schema.field(c).type)
                   for c in _referenced_columns(self.predicate)
                   if c in schema.names):
                self._pushed = None

    def apply_conf(self, conf) -> None:
        if isinstance(conf, dict):
            conf = RapidsTpuConf(conf)
        super().apply_conf(conf)
        self._native = bool(conf.get(PARQUET_NATIVE_DECODE.key))

    def _note_fallback(self, row_groups: int) -> None:
        with self._count_lock:
            self.row_groups_fallback += row_groups

    def _arrow_schema(self, path: str) -> pa.Schema:
        schema = self._arrow_schemas.get(path)
        if schema is None:
            schema = pq.read_schema(path)
            self._arrow_schemas[path] = schema
        return schema

    def _native_read(self, path: str, rg: int, read_cols):
        """One row group through the native decoder, or None when it is
        outside the native subset (the caller reads it with pyarrow)."""
        if not self._native:
            return None
        nf = open_native(path)
        if nf is None:
            return None
        if self.rebase_mode != "CORRECTED" and \
                nf.has_metadata_key(LEGACY_DATETIME_KEY):
            # legacy hybrid-calendar files: the rebase pass keys off the
            # footer marker in the table's schema metadata, which the
            # native decode does not attach — take the pyarrow path
            return None
        schema = self._arrow_schema(path)
        cols = list(read_cols) if read_cols is not None else \
            list(schema.names)
        if any(c not in schema.names for c in cols):
            return None      # partition/virtual columns: pyarrow path
        try:
            # _dict_read_columns is empty on a scan with a predicate or
            # with the codes hand-off off: it owns those conditions
            dict_cols = set(self._dict_read_columns(path)) or None
            return nf.read_row_group(rg, cols, schema, dict_cols)
        except _Unsupported:
            return None      # outside the native subset: pyarrow fallback

    def infer_arrow_schema(self) -> pa.Schema:
        return pq.read_schema(self.files[0])

    def _dict_read_columns(self, path: str) -> List[str]:
        """The top-level string columns to read as dictionaries (their
        RLE_DICTIONARY codes kept through the decode). Empty when the
        session turns the hand-off off, or when the scan has a predicate:
        the host predicate over dictionary arrays is not guaranteed across
        pyarrow versions."""
        if not self._dict_scan or self.predicate is not None:
            return []
        return [f.name for f in self._arrow_schema(path)
                if pa.types.is_string(f.type)
                or pa.types.is_large_string(f.type)]

    def read_file(self, path: str) -> pa.Table:
        t = self._native_read_file(path)
        if t is not None:
            return t
        self._note_fallback(pq.ParquetFile(path).metadata.num_row_groups)
        filt = expression_to_arrow_filter(self._pushed) \
            if self._pushed is not None else None
        if filt is not None:
            import pyarrow.dataset as ds
            dataset = ds.dataset(path, format="parquet")
            t = dataset.to_table(columns=self.columns, filter=filt)
        else:
            t = pq.read_table(path, columns=self.columns,
                              read_dictionary=self._dict_read_columns(path))
        return rebase_legacy_datetimes(t, self.rebase_mode, path)

    def _native_read_file(self, path: str) -> Optional[pa.Table]:
        """Whole-file native decode for the PERFILE/COALESCING readers:
        every row group through the C++ decoder, predicate applied as a
        compute mask. None → pyarrow path."""
        if not self._native:
            return None
        nf = open_native(path)
        if nf is None or nf.num_row_groups == 0:
            return None
        # the predicate may reference columns outside the projection:
        # read them for the filter, drop them after (dataset-path parity)
        read_cols = self.columns
        if self._pushed is not None and self.columns is not None:
            extra = [c for c in _referenced_columns(self._pushed)
                     if c not in self.columns]
            if extra:
                read_cols = list(self.columns) + extra
        schema = self._arrow_schema(path)
        if read_cols is not None and \
                any(c not in schema.names for c in read_cols):
            return None      # partition/virtual columns: pyarrow path
        tables = []
        names = list(nf.columns.keys())
        pruned = 0           # applied to the metric only on SUCCESS — a
        # later native-subset fallback re-reads everything via pyarrow
        for rg in range(nf.num_row_groups):
            if self._pushed is not None and not _rg_can_match(
                    None, names, self._pushed,
                    stats_for=lambda n, rg=rg: nf.decoded_stats(rg, n)):
                pruned += 1
                continue
            t = self._native_read(path, rg, read_cols)
            if t is None:
                return None
            tables.append(t)
        self.row_groups_pruned += pruned
        if not tables:
            keep = read_cols if read_cols is not None else schema.names
            t = pa.table({c: pa.array([], type=schema.field(c).type)
                          for c in keep})
        else:
            t = _concat_normalized(tables)
        if self._pushed is not None:
            mask = predicate_mask(self._pushed, t)
            if mask is not None:
                t = t.filter(mask)
            else:
                filt = expression_to_arrow_filter(self._pushed)
                if filt is not None:
                    t = t.filter(filt)
        if read_cols is not self.columns and self.columns is not None:
            t = t.select(self.columns)
        return t

    def row_group_counts(self, path: str) -> List[int]:
        f = pq.ParquetFile(path)
        return [f.metadata.row_group(i).num_rows
                for i in range(f.metadata.num_row_groups)]

    # ------------------------------------------------------------------
    # Row-group-parallel decode (reference: GpuParquetScan footer
    # filterRowGroups + MultiFileCloudParquetPartitionReader): one
    # single-threaded task per ROW GROUP keeps the shared pool busy
    # without each task fanning out threads of its own.
    # ------------------------------------------------------------------

    def decode_tasks(self, files):
        filt = expression_to_arrow_filter(self._pushed) \
            if self._pushed is not None else None
        # the dataset path filters BEFORE projection: a predicate column
        # outside the projection must be read for the filter and dropped
        # after it
        read_cols = self.columns
        if filt is not None and self.columns is not None:
            extra = [c for c in _referenced_columns(self._pushed)
                     if c not in self.columns]
            if extra:
                read_cols = list(self.columns) + extra
        # footers fetched through the shared pool so slow storage doesn't
        # serialize N footer round trips before the first decode. With the
        # native decoder on, the C++ thrift footer parse replaces pyarrow
        # metadata; files the native parser cannot handle fall back to
        # pyarrow metadata per file.
        pool = reader_pool(self.num_threads)

        def footer_of(p):
            if self._native:
                nf = open_native(p)
                if nf is not None:
                    return nf
            return pq.ParquetFile(p, memory_map=True).metadata

        footers = list(pool.map(footer_of, files))
        tasks = []
        for path, md in zip(files, footers):
            native = not isinstance(md, pq.FileMetaData)
            if native:
                names = list(md.columns.keys())
                kvm_has_legacy = md.has_metadata_key(LEGACY_DATETIME_KEY)
            else:
                names = [md.schema.column(j).path
                         for j in range(md.num_columns)]
                kvm_has_legacy = LEGACY_DATETIME_KEY in (md.metadata or {})
            # legacy-rebase files: footer stats carry HYBRID-calendar
            # day/micro values while the decode path re-encodes them
            # proleptic-Gregorian (LEGACY mode) — raw stats vs rebased
            # literals would wrongly prune MATCHING groups (data loss),
            # so stats pruning is disabled for such files
            legacy = kvm_has_legacy and self.rebase_mode != "CORRECTED"
            for i in range(md.num_row_groups):
                if self._pushed is not None and not legacy:
                    if native:
                        keep = _rg_can_match(
                            None, names, self._pushed,
                            stats_for=lambda n, md=md, i=i:
                            md.decoded_stats(i, n))
                    else:
                        keep = _rg_can_match(md.row_group(i), names,
                                             self._pushed)
                    if not keep:
                        self.row_groups_pruned += 1
                        continue
                tasks.append((path, lambda path=path, i=i:
                              self._decode_row_group(path, i, filt,
                                                     read_cols)))
        return tasks

    def _decode_row_group(self, path: str, rg: int, filt,
                          read_cols) -> pa.Table:
        t = self._native_read(path, rg, read_cols)
        if t is None:
            self._note_fallback(1)
            # fresh reader per task: pq.ParquetFile is not documented
            # thread-safe for concurrent row-group reads; mmap open is cheap
            pf = pq.ParquetFile(path, memory_map=True)
            t = pf.read_row_group(rg, columns=read_cols, use_threads=False)
        t = rebase_legacy_datetimes(t, self.rebase_mode, path)
        if filt is not None:
            mask = predicate_mask(self._pushed, t)
            t = t.filter(filt if mask is None else mask)
            if read_cols is not self.columns:
                t = t.select(self.columns)
        # unconvertible predicates fall back to the engine's own
        # post-scan FilterExec (the plan keeps it)
        return t


def rebase_legacy_datetimes(t: pa.Table, rebase_mode: str,
                            path: str = "<table>") -> pa.Table:
    """Apply Spark's parquet datetime-rebase policy to a read table.
    Shared by every parquet decode path of the scan — the legacy footer
    key travels in the table's schema metadata, so no
    second footer parse is needed."""
    if rebase_mode == "CORRECTED":
        return t
    has_datetime = any(
        pa.types.is_date(f.type) or pa.types.is_timestamp(f.type)
        for f in t.schema)
    if not has_datetime:
        return t
    if LEGACY_DATETIME_KEY not in (t.schema.metadata or {}):
        return t        # modern writer: labels already proleptic
    import numpy as np
    import pyarrow.compute as pc
    cols = []
    changed = False
    for i, f in enumerate(t.schema):
        col = t.column(i)
        # fill_null BEFORE to_numpy: a nullable chunked array would
        # otherwise come back as float64, which both fails the cast
        # back and cannot hold pre-1582 microseconds exactly (> 2^53)
        if pa.types.is_date(f.type):
            mask = np.asarray(col.is_null())
            days = np.asarray(pc.fill_null(
                col.cast(pa.int32()).combine_chunks(), 0))
            ancient = (days < GREGORIAN_CUTOVER_DAYS) & ~mask
            if ancient.any():
                if rebase_mode == "EXCEPTION":
                    raise DatetimeRebaseError(
                        f"{path}: column {f.name} holds pre-1582 "
                        f"dates written by a legacy hybrid-calendar "
                        f"Spark; set rebase_mode to LEGACY (rebase) "
                        f"or CORRECTED (read as-is)")
                days = rebase_julian_to_gregorian_days(days)
                col = pa.chunked_array([pa.Array.from_pandas(
                    days.astype("int32"), mask=mask).cast(f.type)])
                changed = True
        elif pa.types.is_timestamp(f.type):
            mask = np.asarray(col.is_null())
            us = np.asarray(pc.fill_null(
                col.cast(pa.timestamp("us", tz=f.type.tz))
                .cast(pa.int64()).combine_chunks(), 0))
            day = np.floor_divide(us, _US_PER_DAY)
            ancient = (day < GREGORIAN_CUTOVER_DAYS) & ~mask
            if ancient.any():
                if rebase_mode == "EXCEPTION":
                    raise DatetimeRebaseError(
                        f"{path}: column {f.name} holds pre-1582 "
                        f"timestamps written by a legacy "
                        f"hybrid-calendar Spark; set rebase_mode to "
                        f"LEGACY or CORRECTED")
                tod = us - day * _US_PER_DAY
                day2 = rebase_julian_to_gregorian_days(day)
                us = day2 * _US_PER_DAY + tod
                # round-trip through us, then back to the ORIGINAL
                # field type (tz and unit preserved)
                col = pa.chunked_array([pa.Array.from_pandas(
                    us, mask=mask).cast(pa.timestamp(
                        "us", tz=f.type.tz)).cast(f.type)])
                changed = True
        cols.append(col)
    if not changed:
        return t
    # untouched columns keep their exact types: reuse the schema
    return pa.table(cols, schema=t.schema)


def write_parquet(table: pa.Table, path: str,
                  compression: str = "snappy",
                  row_group_rows: int = 1 << 20,
                  partition_by: Optional[List[str]] = None) -> List[str]:
    """Write a table (reference: GpuParquetFileFormat + partitioned
    GpuFileFormatDataWriter). Returns written file paths."""
    import os
    if partition_by:
        import pyarrow.dataset as ds
        ds.write_dataset(table, path, format="parquet",
                         partitioning=ds.partitioning(
                             pa.schema([table.schema.field(c)
                                        for c in partition_by]),
                             flavor="hive"),
                         existing_data_behavior="overwrite_or_ignore")
        return [os.path.join(dp, f) for dp, _, fs in os.walk(path)
                for f in fs if f.endswith(".parquet")]
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    pq.write_table(table, path, compression=compression,
                   row_group_size=row_group_rows)
    return [path]
