"""Configuration the port reads so far.

Port of the registry of ``spark_rapids_tpu/config.py`` (``ConfEntry`` and
``RapidsTpuConf``), holding only the keys that a conf dict sets today:
the retry policy, the OOM dump directory and the OOM injection, read by
``memory.retry.apply_session_conf``, and the file readers' keys, read by
``io.source.FileSource.apply_conf`` and ``io.parquet.ParquetSource``,
under the same ``spark.rapids.tpu.*`` names and defaults, so one conf dict
drives both packages.

The settings that the JAX package reads from a Session's conf (the planner
and the plugin) are plain constants here, with the JAX key's default:
operators and catalogs take them as their defaults, and their callers pass
other values as arguments. The planner slice turns them into keys.

One default differs in form: the spill directory is ``rapids_tpu_spill``
under the process's temporary directory (``tempfile.gettempdir()``), which
is the JAX package's ``/tmp/rapids_tpu_spill`` wherever ``TMPDIR`` is not
set.
"""

from __future__ import annotations

import os
import tempfile
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

_REGISTRY: Dict[str, "ConfEntry"] = {}

#: ``spark.rapids.tpu.memory.hbm.reserve``: device bytes held back from the
#: buffer catalog's budget for operator temporaries
HBM_RESERVE = 2 << 30
#: ``spark.rapids.tpu.memory.host.spillStorageSize``: host bytes for
#: spilled device buffers before they overflow to disk
HOST_SPILL_LIMIT = 4 << 30
#: ``spark.rapids.tpu.memory.spillDir``: the disk tier's directory
SPILL_DIR = os.path.join(tempfile.gettempdir(), "rapids_tpu_spill")
#: ``spark.rapids.tpu.sql.agg.maxResultRows``: row budget of one aggregate
#: merge; partials over it merge in windows and, when that stops shrinking
#: them, through the sort-based out-of-core merge
AGG_MAX_RESULT_ROWS = 1 << 22
#: ``spark.rapids.tpu.sql.join.maxBuildRows``: per-partition build-side
#: row budget; bigger builds grace-hash sub-partition both sides
JOIN_MAX_BUILD_ROWS = 1 << 22
#: ``spark.rapids.tpu.sql.adaptive.coalescePartitions.targetRows``: row
#: target of an adaptive exchange's reader partitions; adjacent thin
#: partitions coalesce toward it (``adaptive.enabled`` defaults to true in
#: the JAX package; here an entry point takes ``adaptive=``)
ADAPTIVE_TARGET_ROWS = 1 << 20
#: ``spark.rapids.tpu.sql.adaptive.skewJoin.splitRows``: stream rows above
#: which one partition of a co-partitioned join counts as skewed and splits
#: (``skewJoin.enabled`` defaults to true)
SKEW_SPLIT_ROWS = 1 << 21
#: ``spark.rapids.tpu.sql.adaptive.broadcastJoin.maxBuildRows``: measured
#: build rows at or under which a shuffled hash join switches to a
#: broadcast at run time (``broadcastJoin.enabled`` defaults to true)
ADAPTIVE_BROADCAST_MAX_BUILD_ROWS = 1 << 16


@dataclass
class ConfEntry:
    key: str
    default: Any
    doc: str
    conv: Callable[[str], Any]


def _entry(key: str, default, doc: str, conv) -> ConfEntry:
    if key in _REGISTRY:
        raise ValueError(f"duplicate conf {key}")
    e = ConfEntry(key, default, " ".join(doc.split()), conv)
    _REGISTRY[key] = e
    return e


def _bool(s) -> bool:
    return str(s).strip().lower() in ("true", "1")


OOM_DUMP_DIR = _entry(
    "spark.rapids.tpu.memory.oomDumpDir", "",
    "If set, dump the buffer-catalog state here when an allocation cannot "
    "be satisfied even after spilling.", str)
RETRY_ENABLED = _entry(
    "spark.rapids.tpu.retry.enabled", True,
    "OOM retry state machine: on a retryable device OOM an operator "
    "releases its pins, spills, backs off and re-runs, halving its input "
    "down to retry.splitFloorRows on a repeated OOM.", _bool)
RETRY_MAX_RETRIES = _entry(
    "spark.rapids.tpu.retry.maxRetries", 8,
    "Same-size re-attempts per work item before the OOM is final.", int)
RETRY_SPLIT_FLOOR_ROWS = _entry(
    "spark.rapids.tpu.retry.splitFloorRows", 1 << 10,
    "Inputs at or below this many rows are never split further.", int)
INJECT_OOM_MODE = _entry(
    "spark.rapids.tpu.test.injectOOM.mode", "",
    "Deterministic OOM fault injection at the instrumented allocation "
    "sites: empty/off, 'every-N', or 'random' / 'random-P'.", str)
INJECT_OOM_SEED = _entry(
    "spark.rapids.tpu.test.injectOOM.seed", 0,
    "RNG seed for injectOOM.mode=random.", int)
INJECT_OOM_SKIP_COUNT = _entry(
    "spark.rapids.tpu.test.injectOOM.skipCount", 0,
    "Exempt the first K allocation checks from injection.", int)
INJECT_OOM_OOM_COUNT = _entry(
    "spark.rapids.tpu.test.injectOOM.oomCount", 1,
    "Consecutive synthetic OOMs thrown per trigger.", int)

# the file readers' keys, read by FileSource.apply_conf and
# ParquetSource.apply_conf
MULTITHREADED_READ_THREADS = _entry(
    "spark.rapids.tpu.sql.multiThreadedRead.numThreads", 8,
    "Thread-pool size for the multithreaded multi-file reader.", int)
READER_BATCH_ROWS = _entry(
    "spark.rapids.tpu.sql.reader.batchSizeRows", 1 << 20,
    "Row target per decoded host batch a scan emits.", int)
MT_READER_MAX_TASKS = _entry(
    "spark.rapids.tpu.sql.format.multithreaded.maxTasksInFlight", 64,
    "Bound on decode tasks submitted to the shared reader pool at once; "
    "keeps many-file scans from queueing unbounded host memory.", int)
COALESCING_PARALLEL_FILES = _entry(
    "spark.rapids.tpu.sql.format.coalescing.numFilesParallel", 8,
    "Files decoded concurrently by the COALESCING reader before the "
    "concat.", int)
PREFETCH_ENABLED = _entry(
    "spark.rapids.tpu.prefetch.enabled", True,
    "Pipelined host prefetch (pipeline.py): the PERFILE and COALESCING "
    "scans decode batch N+1 on a background thread while batch N is "
    "uploaded and computed on. Disabling reproduces the synchronous path "
    "bit for bit; single-core hosts skip the thread handoff.", _bool)
PREFETCH_DEPTH = _entry(
    "spark.rapids.tpu.prefetch.depth", 2,
    "Bounded look-ahead of each prefetch stage (items buffered ahead of "
    "the consumer); 0 disables, as prefetch.enabled=false does.", int)
PARQUET_NATIVE_DECODE = _entry(
    "spark.rapids.tpu.sql.format.parquet.nativeDecode.enabled", True,
    "Decode parquet column chunks with the native C++ decoder "
    "(csrc/rtpu_parquet.cpp: thrift footer parse, PLAIN/RLE_DICTIONARY "
    "pages, SNAPPY and, where libzstd is present, ZSTD) instead of "
    "pyarrow; row groups outside the native subset (nested columns, "
    "INT96, other codecs, legacy-rebase files) fall back to pyarrow one "
    "by one.", _bool)
# recorded by the scan; until the dictionary-encoding slice the port
# decodes every string to bytes, which gives the same rows
DICT_ENCODING_ENABLED = _entry(
    "spark.rapids.tpu.dictEncoding.enabled", True,
    "Compressed execution for string columns (dictionary codes on the "
    "device). Results are the same either way.", _bool)
DICT_MAX_CARDINALITY = _entry(
    "spark.rapids.tpu.dictEncoding.maxCardinality", 1 << 16,
    "Distinct-value budget per dictionary-encoded string column.", int)
DICT_MAX_CARD_FRACTION = _entry(
    "spark.rapids.tpu.dictEncoding.maxCardinalityFraction", 0.5,
    "Dictionary cardinality must stay below this fraction of the batch's "
    "rows for encoding to be kept at the scan boundary.", float)
DICT_SCAN_ENABLED = _entry(
    "spark.rapids.tpu.dictEncoding.scan.enabled", True,
    "Ask the parquet readers to preserve dictionary pages of string "
    "columns. Only meaningful while dictEncoding.enabled is true.", _bool)


class RapidsTpuConf:
    """Typed view over a plain dict of settings, with registry defaults.
    Keys the port does not know yet are kept and ignored, so a conf dict
    written for the JAX package's Session drives the port too."""

    def __init__(self, settings: Optional[Dict[str, Any]] = None):
        self._settings = dict(settings or {})

    def get(self, key: str) -> Any:
        entry = _REGISTRY[key]
        if key in self._settings:
            raw = self._settings[key]
            return entry.conv(raw) if isinstance(raw, str) else raw
        return entry.default
