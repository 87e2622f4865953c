"""Configuration.

Port of the registry of ``spark_rapids_tpu/config.py`` (``ConfEntry`` and
``RapidsTpuConf``): every key of the JAX package, under the same
``spark.rapids.tpu.*`` names and defaults, so one conf dict drives both
packages. The port reads the planner's and the Session's switches
(``plan/``), the memory budget, the retry policy and the OOM injection
(``memory.retry.apply_session_conf``), the adaptive-execution knobs, and
the file readers' keys (``io.source.FileSource.apply_conf`` and
``io.parquet.ParquetSource``). Operators and catalogs take an entry's
``default`` where their caller passes nothing; the Session passes the
conf's value.

A key whose feature the port does not have yet carries ``later``, the
ROADMAP item that brings it; the Session raises ``NotImplementedError``
when such a key is set away from its default
(``plan.session.unsupported_conf``). A key outside the registry raises
``KeyError`` as the JAX package's does, but for the per-exec and
per-expression switches (``spark.rapids.tpu.sql.exec.<Name>`` and
``spark.rapids.tpu.sql.expression.<Name>``), which are not registered and
default to true (``RapidsTpuConf.is_op_enabled``).

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

@dataclass
class ConfEntry:
    key: str
    default: Any
    doc: str
    conv: Callable[[str], Any]
    #: the ROADMAP item that brings the feature this key drives, while the
    #: port lacks it ("": the port honours the key)
    later: str = ""


def _entry(key: str, default, doc: str, conv, later: str = "") -> ConfEntry:
    if key in _REGISTRY:
        raise ValueError(f"duplicate conf {key}")
    e = ConfEntry(key, default, " ".join(doc.split()), conv, later)
    _REGISTRY[key] = e
    return e


def _bool(s) -> bool:
    return str(s).strip().lower() in ("true", "1")


def parse_bytes(s) -> int:
    """A byte count: an int, or text with an optional k/m/g/t suffix."""
    if isinstance(s, (int, float)):
        return int(s)
    s = str(s).strip().lower()
    units = {"k": 1 << 10, "m": 1 << 20, "g": 1 << 30, "t": 1 << 40, "b": 1}
    for suffix in ("kb", "mb", "gb", "tb", "k", "m", "g", "t", "b"):
        if s.endswith(suffix):
            return int(float(s[: -len(suffix)]) * units[suffix[0]])
    return int(float(s))


# ---- the planner and the Session (plan/) ----

SQL_ENABLED = _entry(
    "spark.rapids.tpu.sql.enabled", True,
    "Master switch: when false every operator stays on the CPU, on the row "
    "interpreter (plan/interpreter.py): the differential tests' "
    "oracle.", _bool)
MODE = _entry(
    "spark.rapids.tpu.sql.mode", "executeontpu",
    "executeontpu or explainonly: explainonly plans as if the device were "
    "present (Session.last_plan) but executes on the row interpreter.",
    str)
INCOMPATIBLE_OPS = _entry(
    "spark.rapids.tpu.sql.incompatibleOps.enabled", False,
    "Enable operators whose results differ from Spark in corner cases "
    "(float aggregation order; float64 sums, averages and moments).", _bool)
ANSI_ENABLED = _entry(
    "spark.rapids.tpu.sql.ansi.enabled", False,
    "ANSI SQL mode: overflow and division by zero raise instead of "
    "null/wrap.", _bool)
BATCH_SIZE_BYTES = _entry(
    "spark.rapids.tpu.sql.batchSizeBytes", 512 << 20,
    "Target device batch size; the coalesce pass concatenates operator "
    "output batches up to this size.", parse_bytes)
BATCH_ROW_CAPACITY = _entry(
    "spark.rapids.tpu.sql.batchRowCapacity", 1 << 20,
    "Maximum rows per device batch. The planner reads it where a window "
    "without PARTITION BY needs its whole input in one batch: over more "
    "rows the window is an island.", int)
WINDOW_BATCH_ROWS = _entry(
    "spark.rapids.tpu.sql.window.batchRows", 1 << 20,
    "Row target for key-complete window batches: a window partition's "
    "rows are re-chunked on group-key boundaries so one batch never holds "
    "more than ~this many rows (reference: GpuKeyBatchingIterator).", int)
COALESCE_MAX_ROWS = _entry(
    "spark.rapids.tpu.sql.coalesce.maxRows", 1 << 22,
    "Row cap per coalesced output batch in CoalesceBatchesExec.", int)
FUSION_ENABLED = _entry(
    "spark.rapids.tpu.sql.fusion.enabled", True,
    "Whole-stage fusion: an eligible linear single-batch stage runs as one "
    "program, captured in a CUDA graph on the card (exec/fuse.py).", _bool)
CBO_ENABLED = _entry(
    "spark.rapids.tpu.sql.optimizer.enabled", False,
    "Enable the cost-based optimizer (plan/cbo.py): subtrees whose "
    "estimated device speedup does not cover the transition cost stay on "
    "the CPU.", _bool)
PARQUET_ENABLED = _entry(
    "spark.rapids.tpu.sql.format.parquet.enabled", True,
    "Accelerate parquet scans; a scan with this false is refused.", _bool)
REGEXP_ENABLED = _entry(
    "spark.rapids.tpu.sql.regexp.enabled", True,
    "Master switch for device regular expressions.", _bool)
FILECACHE_ENABLED = _entry(
    "spark.rapids.tpu.filecache.enabled", True,
    "Session.cache materializes a DataFrame; false keeps its logical "
    "plan.", _bool)
SHUFFLE_PARTITIONS = _entry(
    "spark.rapids.tpu.shuffle.partitions", 8,
    "Default number of shuffle partitions.", int)
SHUFFLE_MODE = _entry(
    "spark.rapids.tpu.shuffle.mode", "DEFAULT",
    "Shuffle manager mode: DEFAULT, MULTITHREADED, ICI or CACHED. The port "
    "has DEFAULT and ICI (the Session lowers planned queries onto a mesh, "
    "parallel/lowering.py); the others raise.", str)
MESH_DEVICES = _entry(
    "spark.rapids.tpu.mesh.devices", 0,
    "Shards of the ICI mesh's data axis (0: one per visible device of the "
    "Session's type). Shards past the visible cards share them, placed "
    "round-robin.", int)
BROADCAST_THRESHOLD = _entry(
    "spark.rapids.tpu.sql.autoBroadcastJoinThreshold", 10 << 20,
    "Max estimated build-side bytes for a broadcast hash join; larger (or "
    "unknown-size) builds shuffle both sides on the join keys.", int)
BROADCAST_LIMIT = _entry(
    "spark.rapids.tpu.broadcast.maxBytes", 1 << 30,
    "Maximum device bytes for one broadcast relation.", parse_bytes)
DPP_ENABLED = _entry(
    "spark.rapids.tpu.sql.dynamicPartitionPruning.enabled", True,
    "Prune hive-partitioned scan files at plan time using the distinct "
    "join-key values of a broadcast build side.", _bool)
AGG_MAX_RESULT_ROWS = _entry(
    "spark.rapids.tpu.sql.agg.maxResultRows", 1 << 22,
    "Row budget of one aggregate merge; partials over it merge in windows "
    "and, when that stops shrinking them, through the sort-based "
    "out-of-core merge.", int)
JOIN_MAX_BUILD_ROWS = _entry(
    "spark.rapids.tpu.sql.join.maxBuildRows", 1 << 22,
    "Per-partition build-side row budget; bigger builds grace-hash "
    "sub-partition both sides.", int)
ADAPTIVE_ENABLED = _entry(
    "spark.rapids.tpu.sql.adaptive.enabled", True,
    "Adaptive query execution at the exchanges: coalesce thin partitions, "
    "split skewed ones, switch a small build to a broadcast.", _bool)
ADAPTIVE_TARGET_ROWS = _entry(
    "spark.rapids.tpu.sql.adaptive.coalescePartitions.targetRows", 1 << 20,
    "Row target when coalescing adjacent small shuffle partitions.", int)
SKEW_JOIN_ENABLED = _entry(
    "spark.rapids.tpu.sql.adaptive.skewJoin.enabled", True,
    "Split a skewed stream-side partition of a co-partitioned join.",
    _bool)
SKEW_SPLIT_ROWS = _entry(
    "spark.rapids.tpu.sql.adaptive.skewJoin.splitRows", 1 << 21,
    "Stream-side rows above which one shuffle partition counts as skewed "
    "and is split.", int)
ADAPTIVE_BROADCAST_ENABLED = _entry(
    "spark.rapids.tpu.sql.adaptive.broadcastJoin.enabled", True,
    "Runtime shuffled-to-broadcast join switch.", _bool)
ADAPTIVE_BROADCAST_MAX_BUILD_ROWS = _entry(
    "spark.rapids.tpu.sql.adaptive.broadcastJoin.maxBuildRows", 1 << 16,
    "Measured build-side row total at or under which a shuffled hash join "
    "switches to broadcast at run time.", int)
ADAPTIVE_COST_ENABLED = _entry(
    "spark.rapids.tpu.sql.adaptive.costFeedback.enabled", False,
    "Cost-fed placement from measured wall times.", _bool,
    "ROADMAP item 8 (cost-fed placement, with the plan cache's "
    "fingerprint)")

# ---- the serving keys whose features the port does not have yet ----

SERVER_PLAN_CACHE_ENABLED = _entry(
    "spark.rapids.tpu.server.planCache.enabled", True,
    "Memoize planning per plan-shape fingerprint. Changes no result; the "
    "port plans afresh every time (Session.last_cache['plan']).", _bool)
SERVER_RESULT_CACHE_ENABLED = _entry(
    "spark.rapids.tpu.server.resultCache.enabled", False,
    "Serve repeated queries from a result cache.", _bool,
    "ROADMAP item 8 (the result cache)")
SHARING_ENABLED = _entry(
    "spark.rapids.tpu.server.sharing.enabled", False,
    "Cross-query work sharing.", _bool,
    "ROADMAP item 8 (cross-query work sharing)")
TRACE_ENABLED = _entry(
    "spark.rapids.tpu.trace.enabled", False,
    "Query tracing.", _bool, "ROADMAP item 8 (query tracing)")

# ---- the memory budget, read where a Session makes its catalog ----

HBM_RESERVE = _entry(
    "spark.rapids.tpu.memory.hbm.reserve", 2 << 30,
    "Device bytes held back from the buffer catalog's budget for operator "
    "temporaries.", parse_bytes)
HOST_SPILL_LIMIT = _entry(
    "spark.rapids.tpu.memory.host.spillStorageSize", 4 << 30,
    "Host bytes for spilled device buffers before they overflow to "
    "disk.", parse_bytes)
SPILL_DIR = _entry(
    "spark.rapids.tpu.memory.spillDir",
    os.path.join(tempfile.gettempdir(), "rapids_tpu_spill"),
    "The disk tier's directory.", str)

# ---- the retry policy and the OOM injection ----

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
# dictenc.py: string columns keep dictionary codes on the device, from
# the Parquet readers' codes hand-off and from dictionary Arrow input
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


# the port's own key (the JAX package has no device parse of a float):
# named after the reference's spark.rapids.sql.castStringToFloat.enabled
CAST_STRING_TO_FLOAT = _entry(
    "spark.rapids.tpu.sql.castStringToFloat.enabled", False,
    "Run a string to float or double cast on the device "
    "(expressions/cast.py string_to_double): the nearest double for at "
    "most 18 significant digits and a decimal exponent within 22 (but "
    "within about 2^-100 of a tie), possibly an ulp off past that. Off, "
    "the cast runs on the row interpreter, as in the JAX package.", _bool)
GENERATE_MAX_REPEAT = _entry(
    "spark.rapids.tpu.sql.generate.maxRepeat", 64,
    "Static per-row budget for ReplicateRows/explode fan-out on device.",
    int)


# ---- the JAX package's other keys ----
# Registered under the JAX names and defaults, so a conf written for the
# JAX Session reads whole here; each names the ROADMAP item that brings its
# feature. A conf that sets one away from its default is refused by the
# Session. Five keys have no item: the JAX package reads four of them
# nowhere (sql.explain, sql.stringMaxBytes, the Parquet reader.type and
# sql.test.allowedNonTpu), and the plan cache's size changes no result
# (the port plans afresh).

def _later(item: str, conv, *pairs) -> None:
    for key, default in pairs:
        _entry(f"spark.rapids.tpu.{key}", default,
               f"Not in the port yet: {item}.", conv, item)


for _key, _default, _conv in (
        ("sql.explain", "NONE", str),
        ("sql.stringMaxBytes", 64, int),
        ("sql.format.parquet.reader.type", "AUTO", str),
        ("sql.test.allowedNonTpu", "", str),
        ("server.planCache.maxEntries", 256, int)):
    _entry(f"spark.rapids.tpu.{_key}", _default,
           "Registered as in the JAX package; changes no result.", _conv)
del _key, _default, _conv

_ITEM7 = "ROADMAP item 7 (Python workers and UDFs)"
_ITEM8_PLUGIN = "ROADMAP item 8 (plugin.py and the metric levels)"
_ITEM8_NET = "ROADMAP item 8 (the shuffle network plane)"
_ITEM8_IO = "ROADMAP item 8 (I/O breadth)"
_ITEM8_SERVE = "ROADMAP item 8 (serving, tracing and the bridge)"
_later(_ITEM7, int, ("python.worker.processes", 4))
_later(_ITEM7, _bool, ("sql.udfCompiler.enabled", False))
_later(_ITEM8_PLUGIN, int, ("sql.concurrentTpuTasks", 2))
_later(_ITEM8_PLUGIN, float, ("memory.hbm.poolFraction", 0.85))
_later(_ITEM8_PLUGIN, _bool, ("memory.leakDetection", False))
_later(_ITEM8_PLUGIN, str, ("sql.metrics.level", "MODERATE"))
_later(_ITEM8_NET, int, ("shuffle.transport.retries", 3),
       ("shuffle.transport.windowBytes", 4 << 20),
       ("shuffle.transport.maxInFlightFetches", 4),
       ("shuffle.transport.connectTimeoutMs", 30000),
       ("shuffle.transport.ioTimeoutMs", 30000),
       ("shuffle.transport.retryBackoffMs", 10),
       ("shuffle.transport.retryBackoffMaxMs", 1000),
       ("shuffle.replicas", 0), ("shuffle.multiThreaded.writer.threads", 8),
       ("shuffle.multiThreaded.reader.threads", 8),
       ("shuffle.multiThreaded.maxBytesInFlight", 512 << 20),
       ("executorId", 0), ("shuffle.cached.heartbeatIntervalMs", 5000),
       ("shuffle.cached.heartbeatTimeoutMs", 30000),
       ("test.injectNet.seed", 0), ("test.injectNet.skipCount", 0),
       ("test.injectNet.delayMs", 20))
_later(_ITEM8_NET, _bool, ("shuffle.lineage.enabled", True))
_later(_ITEM8_NET, str, ("shuffle.cached.registry", ""),
       ("shuffle.compression.codec", "lz4"), ("test.injectNet.mode", ""),
       ("test.injectNet.faultKind", "drop"))
_later(_ITEM8_IO, _bool, *((f"sql.format.{f}.enabled", True)
                          for f in ("orc", "csv", "json", "avro",
                                    "hiveText")))
_later(_ITEM8_SERVE, int, ("server.maxSessions", 32),
       ("server.queryTimeoutMs", 0), ("server.retryAfterMs", 1000),
       ("server.concurrentCollects", 4), ("server.test.collectDelayMs", 0),
       ("server.fleet.workers", 2), ("server.fleet.vnodes", 64),
       ("server.fleet.tenant.maxConcurrent", 0),
       ("server.fleet.maxInflightPerWorker", 0),
       ("server.fleet.admissionTimeoutMs", 30000),
       ("server.fleet.drainTimeoutMs", 30000),
       ("server.fleet.spilloverQueueDepth", 8),
       ("server.fleet.workerRetries", 2),
       ("server.fleet.costSync.everyPlans", 0),
       ("server.sharing.waitTimeoutMs", 600000),
       ("bridge.defaultStringLen", 64), ("bridge.defaultArrayElems", 256),
       ("trace.maxSpansPerQuery", 2048),
       ("trace.costStore.maxFingerprints", 1024),
       ("server.trace.recorderEntries", 128),
       ("server.trace.slowQueryMs", 1000),
       ("sql.adaptive.costFeedback.minObservations", 1),
       ("sql.adaptive.costFeedback.exploreEvery", 16))
_later(_ITEM8_SERVE, parse_bytes,
       ("server.resultCache.maxBytes", 256 << 20),
       ("server.queryReserveBytes", 0),
       ("server.fleet.resultStore.maxBytes", 1 << 30),
       ("server.sharing.subplan.maxBytes", 128 << 20),
       ("server.sharing.scanShare.maxBytes", 256 << 20))
_later(_ITEM8_SERVE, _bool, ("server.sharing.inflight.enabled", True),
       ("server.sharing.subplan.enabled", True),
       ("server.sharing.scanShare.enabled", True),
       ("trace.costStore.enabled", True))
_later(_ITEM8_SERVE, float, ("trace.costStore.alpha", 0.2))
_later(_ITEM8_SERVE, str, ("server.fleet.tenantId", ""),
       ("server.fleet.tenant.weights", ""),
       ("server.fleet.resultStore.path", ""),
       ("bridge.acceptedSchemaVersions", "1"), ("trace.sink.path", ""))

#: prefixes of the per-operator switches, which are not registered
OP_SWITCH_PREFIXES = ("spark.rapids.tpu.sql.exec.",
                      "spark.rapids.tpu.sql.expression.")


class RapidsTpuConf:
    """Typed view over a plain dict of settings, with registry defaults.
    A key outside the registry and the per-operator switches raises
    ``KeyError``, as in the JAX package."""

    def __init__(self, settings: Optional[Dict[str, Any]] = None):
        self._settings = dict(settings or {})
        for k in self._settings:
            if k not in _REGISTRY and not k.startswith(OP_SWITCH_PREFIXES):
                raise KeyError(f"unknown config {k}")

    def get(self, key: str) -> Any:
        entry = _REGISTRY[key]
        if key in self._settings:
            raw = self._settings[key]
            return entry.conv(raw) if isinstance(raw, str) else raw
        return entry.default

    @property
    def sql_enabled(self) -> bool:
        return self.get(SQL_ENABLED.key)

    @property
    def batch_row_capacity(self) -> int:
        return self.get(BATCH_ROW_CAPACITY.key)

    @property
    def batch_size_bytes(self) -> int:
        return self.get(BATCH_SIZE_BYTES.key)

    @property
    def ansi(self) -> bool:
        return self.get(ANSI_ENABLED.key)

    @property
    def incompatible_ops(self) -> bool:
        return self.get(INCOMPATIBLE_OPS.key)

    def is_op_enabled(self, op_key: str, default: bool = True) -> bool:
        """The per-exec and per-expression switches
        (``spark.rapids.tpu.sql.exec.<Name>``,
        ``spark.rapids.tpu.sql.expression.<Name>``), true unless set."""
        v = self._settings.get(op_key, default)
        if isinstance(v, str):
            return v.strip().lower() in ("true", "1")
        return bool(v)

    def is_default(self, entry: ConfEntry) -> bool:
        """Whether the conf leaves ``entry`` at its default."""
        return self.get(entry.key) == entry.default

    def not_ported(self) -> Optional[str]:
        """Why the port cannot serve this conf (the first key set away from
        its default for a feature the port does not have yet, with the
        ROADMAP item that brings it); None if it can."""
        for key in self._settings:
            entry = _REGISTRY.get(key)
            if entry is not None and entry.later and \
                    not self.is_default(entry):
                return (f"{key}={self.get(key)} is not in the port yet: "
                        f"{entry.later}")
        return None
