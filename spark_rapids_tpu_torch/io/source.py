"""FileSource base: file listing, projection/predicate pushdown, reader
strategies (reference: GpuMultiFileReader.scala / PartitionReaderFactory).

Port of ``spark_rapids_tpu/io/source.py``. Everything here is host work on
pyarrow tables; the upload to the device is the scan exec's
(``io/scan.py``), on the consumer's thread. ``share_key`` (the cross-query
scan-share registry's key) waits for the plan-sharing slice.
"""

from __future__ import annotations

import concurrent.futures as cf
import enum
import glob
import os
import threading
from typing import Iterator, List, Optional, Sequence

import pyarrow as pa

from .. import types as T
from ..batch import Field, Schema, schema_from_arrow
from ..config import (COALESCING_PARALLEL_FILES, DICT_ENCODING_ENABLED,
                      DICT_MAX_CARD_FRACTION, DICT_MAX_CARDINALITY,
                      DICT_SCAN_ENABLED, MT_READER_MAX_TASKS,
                      MULTITHREADED_READ_THREADS, PREFETCH_DEPTH,
                      PREFETCH_ENABLED, READER_BATCH_ROWS, RapidsTpuConf)
from ..expressions.base import Expression


class ReaderType(enum.Enum):
    PERFILE = "PERFILE"
    COALESCING = "COALESCING"
    MULTITHREADED = "MULTITHREADED"
    AUTO = "AUTO"


# Shared host decode pool (reference: MultiFileReaderThreadPool:123 — one
# pool per executor shared by all multi-file readers).
_POOL: Optional[cf.ThreadPoolExecutor] = None
_POOL_SIZE = 0
_POOL_LOCK = threading.Lock()


def bounded_map(pool, items, fn, window: int, force_parallel: bool = False):
    """Submit ``fn(item)`` over the pool keeping at most ``window`` tasks
    outstanding; yields (item, result) in input order — decoded output
    stays bounded on many-file scans.

    Single-core hosts run CPU-bound work inline: a thread pool cannot
    overlap anything there, and futures + GIL handoff measurably tax the
    decode hot loop (the reference sizes its multi-file pool to the
    executor's cores the same way). ``force_parallel`` keeps the pool for
    I/O-bound work (network fetches overlap even on one core)."""
    if not force_parallel and (
            window <= 1 or (os.cpu_count() or 1) <= 1):
        for item in items:
            yield item, fn(item)
        return
    from collections import deque
    pending = deque()
    it = iter(items)
    exhausted = False
    while pending or not exhausted:
        while not exhausted and len(pending) < window:
            try:
                item = next(it)
            except StopIteration:
                exhausted = True
                break
            pending.append((item, pool.submit(fn, item)))
        if pending:
            item, fut = pending.popleft()
            yield item, fut.result()


def undictionary_table(t: pa.Table) -> pa.Table:
    """Cast dictionary-typed columns back to their value type (the
    compressed-scan hand-off is per-file/per-row-group best effort, so
    concat sites normalize when pieces disagree on dictionary-ness)."""
    cols, changed = [], False
    for i, f in enumerate(t.schema):
        col = t.column(i)
        if pa.types.is_dictionary(f.type):
            col = col.cast(f.type.value_type)
            changed = True
        cols.append(col)
    return pa.table(cols, names=t.column_names) if changed else t


def _concat_normalized(tabs: List[pa.Table]) -> pa.Table:
    """pa.concat_tables, decoding dictionary columns first when the
    pieces' schemas disagree (file A kept RLE_DICTIONARY codes, file B's
    writer fell back to PLAIN pages — otherwise concat raises)."""
    if len(tabs) > 1 and any(t.schema != tabs[0].schema for t in tabs[1:]):
        tabs = [undictionary_table(t) for t in tabs]
    return pa.concat_tables(tabs)


def reader_pool(num_threads: int = 8) -> cf.ThreadPoolExecutor:
    """Shared executor-wide decode pool; grows (never shrinks) when a
    session asks for more width — the old pool finishes its queue and is
    collected."""
    global _POOL, _POOL_SIZE
    with _POOL_LOCK:
        if _POOL is None or num_threads > _POOL_SIZE:
            _POOL = cf.ThreadPoolExecutor(
                max_workers=max(num_threads, _POOL_SIZE),
                thread_name_prefix="multifile-read")
            _POOL_SIZE = max(num_threads, _POOL_SIZE)
        return _POOL


# ---------------------------------------------------------------------------
# Transparent path rewriting (reference: AlluxioUtils.scala:73 — s3:// paths
# rewritten to an alluxio:// cache cluster, with automount). Register
# prefix rules once; every scan then reads through the cache tier.
# ---------------------------------------------------------------------------

_PATH_RULES: List[tuple] = []


def register_path_rewrite(src_prefix: str, dst_prefix: str) -> None:
    _PATH_RULES.append((src_prefix, dst_prefix))


def clear_path_rewrites() -> None:
    _PATH_RULES.clear()


def rewrite_path(p: str) -> str:
    for src, dst in _PATH_RULES:
        if p.startswith(src):
            return dst + p[len(src):]
    return p


def expand_paths(paths) -> List[str]:
    if isinstance(paths, (str, os.PathLike)):
        paths = [paths]
    out: List[str] = []
    for p in paths:
        p = rewrite_path(str(p))
        if os.path.isdir(p):
            for root, _, files in os.walk(p):
                out.extend(os.path.join(root, f) for f in sorted(files)
                           if not f.startswith((".", "_")))
        elif any(ch in p for ch in "*?["):
            out.extend(sorted(glob.glob(p)))
        else:
            out.append(p)
    return out


#: hive default-partition marker (null partition value)
_HIVE_NULL = "__HIVE_DEFAULT_PARTITION__"


def _is_int(v: str) -> bool:
    try:
        int(v)
        return True
    except (TypeError, ValueError):
        return False


def hive_partition_values(path: str) -> dict:
    """`key=value` directory components of a path (hive layout). Values
    are %XX-unescaped (hive/Spark escape special chars when writing)."""
    from urllib.parse import unquote
    out = {}
    for comp in os.path.dirname(path).split(os.sep):
        if "=" in comp:
            k, _, v = comp.partition("=")
            if k:
                out[k] = None if v == _HIVE_NULL else unquote(v)
    return out


class FileSource:
    """A format + file list + pushed-down projection/predicate."""

    format_name = "file"

    #: synthetic column name for Spark's input_file_name() expression
    FILE_NAME_COL = "_input_file_name"

    def __init__(self, paths, schema: Optional[Schema] = None,
                 columns: Optional[List[str]] = None,
                 predicate: Optional[Expression] = None,
                 reader_type: ReaderType = ReaderType.AUTO,
                 batch_rows: Optional[int] = None,
                 num_threads: Optional[int] = None,
                 with_file_name: bool = False,
                 hive_partitions: bool = True):
        self.files = expand_paths(paths)
        if not self.files:
            raise FileNotFoundError(f"no files match {paths}")
        self.columns = columns
        self._requested_columns = columns
        self.predicate = predicate
        self.reader_type = reader_type
        # None = defaulted (a later apply_conf may override); an explicit
        # constructor argument always wins over session conf
        self._explicit_batch_rows = batch_rows is not None
        self._explicit_threads = num_threads is not None
        self.batch_rows = (batch_rows if batch_rows is not None
                           else READER_BATCH_ROWS.default)
        self.num_threads = (num_threads if num_threads is not None
                            else MULTITHREADED_READ_THREADS.default)
        self.with_file_name = with_file_name
        self._schema = schema
        # hive-layout partition columns (reference: partition-values
        # handling in GpuFileSourceScanExec): key=value path components
        # become constant columns; files_pruned counts DPP removals
        self.partition_schema: List[tuple] = []
        self._pvalues: dict = {}
        self.files_pruned = 0
        #: session-conf overrides (apply_conf); None = registry defaults
        self._mt_max_tasks: Optional[int] = None
        self._coalesce_par: Optional[int] = None
        self._prefetch_depth: Optional[int] = None
        self._dict_conf: Optional[tuple] = None
        self._dict_scan: Optional[bool] = None
        if hive_partitions:
            self._discover_hive_partitions()
            if self.columns and self.partition_schema:
                pnames = {nm for nm, _ in self.partition_schema}
                # file-level projection excludes partition columns (they
                # come from paths); appended partition fields honor the
                # request
                self.partition_schema = [
                    (nm, kind) for nm, kind in self.partition_schema
                    if nm in self.columns]
                self.columns = [c for c in self.columns
                                if c not in pnames] or None

    def _discover_hive_partitions(self) -> None:
        per_file = [hive_partition_values(f) for f in self.files]
        if not per_file or not per_file[0]:
            return
        names = [k for k in per_file[0]
                 if all(k in pv for pv in per_file)]
        for name in names:
            vals = [pv[name] for pv in per_file]
            typed = vals
            if all(v is None or _is_int(v) for v in vals):
                typed = [None if v is None else int(v) for v in vals]
                # Spark's partition inference yields IntegerType when every
                # value fits int32 (widening to int64 otherwise); matching
                # it keeps round-tripped schemas and join key dtypes stable
                kind = "int" if all(
                    v is None or -(1 << 31) <= v < (1 << 31)
                    for v in typed) else "int64"
            else:
                kind = "string"
            self.partition_schema.append((name, kind))
            self._pvalues[name] = dict(zip(self.files, typed))

    def apply_conf(self, conf) -> None:
        """Planner hook: honor the session's reader confs (thread count,
        batch rows, in-flight bounds) on this source. ``conf`` is a
        ``RapidsTpuConf`` or a plain dict of settings."""
        if isinstance(conf, dict):
            conf = RapidsTpuConf(conf)
        if not self._explicit_threads:
            self.num_threads = int(conf.get(MULTITHREADED_READ_THREADS.key))
        if not self._explicit_batch_rows:
            self.batch_rows = int(conf.get(READER_BATCH_ROWS.key))
        self._mt_max_tasks = int(conf.get(MT_READER_MAX_TASKS.key))
        self._coalesce_par = int(conf.get(COALESCING_PARALLEL_FILES.key))
        self._prefetch_depth = int(conf.get(PREFETCH_DEPTH.key)) \
            if conf.get(PREFETCH_ENABLED.key) else 0
        # (enabled, maxCardinality, maxCardinalityFraction), threaded to
        # the upload (batch.from_arrow) by the scan exec; _dict_scan asks
        # the readers to keep string columns' dictionary codes
        self._dict_conf = (bool(conf.get(DICT_ENCODING_ENABLED.key)),
                           int(conf.get(DICT_MAX_CARDINALITY.key)),
                           float(conf.get(DICT_MAX_CARD_FRACTION.key)))
        self._dict_scan = (self._dict_conf[0]
                           and bool(conf.get(DICT_SCAN_ENABLED.key)))

    def partition_value(self, name: str, path: str):
        return self._pvalues[name][path]

    def _decorate(self, t: pa.Table, path: str) -> pa.Table:
        """Attach partition-value and source-path columns (reference:
        partition values + GpuInputFileName resolved from the split),
        then restore the REQUESTED column order."""
        for name, kind in self.partition_schema:
            v = self._pvalues[name][path]
            typ = (pa.int32() if kind == "int" else
                   pa.int64() if kind == "int64" else pa.string())
            t = t.append_column(name, pa.array([v] * t.num_rows, typ))
        if self.with_file_name:
            t = t.append_column(
                self.FILE_NAME_COL,
                pa.array([path] * t.num_rows, pa.string()))
        if self._requested_columns:
            order = [c for c in self._requested_columns
                     if c in t.column_names]
            order += [c for c in t.column_names if c not in order]
            t = t.select(order)
        return t

    def estimated_bytes(self) -> Optional[int]:
        """On-disk size (planner build-side selection input)."""
        try:
            return sum(os.path.getsize(f) for f in self.files)
        except OSError:
            return None

    # ---- format hooks ----
    def infer_arrow_schema(self) -> pa.Schema:
        raise NotImplementedError

    def read_file(self, path: str) -> pa.Table:
        """Decode one file with pushdown applied."""
        raise NotImplementedError

    # ---- shared machinery ----
    def schema(self) -> Schema:
        if self._schema is None:
            s = self.infer_arrow_schema()
            if self.columns:
                s = pa.schema([s.field(c) for c in self.columns])
            for name, kind in self.partition_schema:
                s = s.append(pa.field(
                    name,
                    pa.int32() if kind == "int" else
                    pa.int64() if kind == "int64" else pa.string()))
            if self._requested_columns:
                names = [f.name for f in s]
                order = [c for c in self._requested_columns if c in names]
                order += [c for c in names if c not in order]
                s = pa.schema([s.field(c) for c in order])
            if self.with_file_name:
                # widen ONLY the synthetic path column, not every string
                ml = max((len(f.encode()) for f in self.files), default=64)
                base = schema_from_arrow(s)
                self._schema = Schema(
                    list(base.fields) +
                    [Field(self.FILE_NAME_COL, T.string(max(ml, 64)),
                           False)])
                return self._schema
            self._schema = schema_from_arrow(s)
        return self._schema

    def effective_reader(self) -> ReaderType:
        if self.reader_type is not ReaderType.AUTO:
            return self.reader_type
        # heuristic (reference GpuParquetScan.scala:276): many small files →
        # multithreaded prefetch; few files → coalescing
        return ReaderType.MULTITHREADED if len(self.files) > 2 \
            else ReaderType.COALESCING

    def read_all(self) -> pa.Table:
        tables = [self._decorate(self.read_file(f), f)
                  for f in self.files]
        return _concat_normalized(tables) if tables else None

    def prefetch_depth(self) -> int:
        """Effective prefetch look-ahead: session conf via apply_conf,
        registry defaults otherwise (0 = synchronous)."""
        if self._prefetch_depth is not None:
            return self._prefetch_depth
        if not PREFETCH_ENABLED.default:
            return 0
        return int(PREFETCH_DEPTH.default)

    def read_split(self, files: Sequence[str],
                   metrics=None) -> Iterator[pa.Table]:
        """Host-side table stream for a subset of files, by strategy,
        produced ``prefetch.depth`` batches ahead of the consumer on a
        background thread (reference: GpuMultiFileReader.scala:441
        prefetch) so decode overlaps the consumer's upload and compute.
        ``metrics`` (an exec's metric dict) receives overlapTime /
        prefetchWaitTime when present. depth=0 (or a single-core host)
        yields the decode generator itself — the synchronous path.

        MULTITHREADED skips the extra stage: its bounded_map window IS a
        decode-ahead pipeline (futures stay in flight between pulls), so
        a second handoff stage only costs there. PERFILE/COALESCING
        decode/concat on the consumer thread, which is exactly the serial
        work the prefetch stage hides."""
        it = self._decode_split(files)
        if self.effective_reader() is ReaderType.MULTITHREADED:
            return it
        from ..pipeline import prefetched
        # dedicated thread, NOT the shared reader pool: the producer holds
        # its worker for the whole scan, and the decode tasks it drives
        # submit into that same pool (pool-of-producers deadlock)
        return prefetched(it, self.prefetch_depth(),
                          metrics=metrics, name=f"{self.format_name}-scan")

    def _decode_split(self, files: Sequence[str]) -> Iterator[pa.Table]:
        """The undecorated decode stream (strategy dispatch)."""
        mode = self.effective_reader()
        if mode is ReaderType.PERFILE:
            for f in files:
                yield self._decorate(self.read_file(f), f)
        elif mode is ReaderType.COALESCING:
            # decode the split's files through the shared pool (bounded by
            # coalescing.numFilesParallel), concat, re-chunk to batch_rows
            # (reference: coalescing reader assembles row groups before H2D)
            par = max(self._coalesce_par or COALESCING_PARALLEL_FILES.default,
                      1)
            pool = reader_pool(self.num_threads)
            tabs = [self._decorate(t, f)
                    for f, t in bounded_map(pool, files, self.read_file,
                                            par)]
            if not tabs:
                return
            t = _concat_normalized(tabs)
            for off in range(0, max(t.num_rows, 1), self.batch_rows):
                yield t.slice(off, self.batch_rows)
                if t.num_rows == 0:
                    break
        else:  # MULTITHREADED: pipelined background decode
            pool = reader_pool(self.num_threads)
            tasks = self.decode_tasks(files)
            if tasks is None:
                tasks = [(f, (lambda f=f: self.read_file(f)))
                         for f in files]
            # windowed submission: maxTasksInFlight bounds queued decode
            # output so a many-file scan cannot hold the whole dataset in
            # host memory at once
            win = max(self._mt_max_tasks or MT_READER_MAX_TASKS.default, 1)
            for (f, _fn), raw in bounded_map(
                    pool, tasks, lambda task: task[1](), win):
                t = self._decorate(raw, f)
                for off in range(0, max(t.num_rows, 1), self.batch_rows):
                    yield t.slice(off, self.batch_rows)
                    if t.num_rows == 0:
                        break

    def decode_tasks(self, files: Sequence[str]):
        """Optional finer-than-file decode units for the MULTITHREADED
        reader: a list of (path, thunk) pairs, each thunk decoding ONE
        unit single-threaded (a parquet row group). None = per-file
        decode. Sub-file units keep the shared pool saturated without
        oversubscribing it with per-task thread fan-out (reference:
        MultiFileCloudParquetPartitionReader chunked reads)."""
        return None
