"""Configuration the port reads so far.

Port of the registry of ``spark_rapids_tpu/config.py`` (``ConfEntry`` and
``RapidsTpuConf``), holding only the keys that a conf dict sets today:
the retry policy, the OOM dump directory and the OOM injection, read by
``memory.retry.apply_session_conf`` under the same ``spark.rapids.tpu.*``
names and defaults, so one conf dict drives both packages.

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
