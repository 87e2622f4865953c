"""Session: conf-scoped query execution and plan capture.

Port of ``spark_rapids_tpu/plan/session.py``: a Session holds one conf dict
(the JAX package's keys and defaults) and prepares a DataFrame one of three
ways, as the JAX Session does:

- ``"interpret"``: with ``sql.enabled=false`` the whole query runs on the
  row interpreter (the differential tests' oracle); with
  ``sql.mode=explainonly`` it is planned as for the device (``last_plan``)
  and then runs on the interpreter too;
- ``"fallback"``: tagging refused the root, so the plan is a
  ``CpuFallbackExec`` island, interpreted on the host with no device round
  trip for its result;
- ``"exec"``: a device plan, which may hold islands below its root. Under
  ``shuffle.mode=ICI`` it is first lowered onto a mesh
  (``parallel.lowering.try_lower_to_mesh``: one ``MeshStageExec``); a
  plan that does not lower keeps its host exchanges, and only then is
  fusion tried (fused where fusion is on and the stage qualifies,
  captured in a CUDA graph on the card).

The mesh (``_mesh``) has ``mesh.devices`` shards, or one per visible
device of the Session's type, placed round-robin on those devices from the
Session's own: on the CPU every shard sits on the CPU. Where the JAX
package keeps at most the visible devices (``jax.devices()[:n]``), the
port keeps ``n`` shards and places several on one card when ``n`` exceeds
the cards, as the JAX tests place 8 virtual devices on one CPU.

``collect`` installs the conf's retry and OOM injection settings and runs
the plan. ``last_plan`` is the physical tree the last query ran;
``explain``, ``metrics``, ``executed_exec_names``, ``fell_back`` and
``adaptive_decisions`` read it as the JAX package's do, islands and the
device children under them included.

The device is ``cuda`` unless the caller names another; asking for
``cuda`` where there is none raises. An island's result goes back to that
device, never to a default one.

What this Session does not have yet raises ``NotImplementedError`` when a
conf asks for it, naming the ROADMAP item that brings it
(``config.ConfEntry.later``): the result cache, work sharing, tracing,
cost-fed placement and the MULTITHREADED and CACHED shuffles (item 8),
among others.

The plan cache (on by default in the JAX package) changes no result; the
port plans afresh every time and says so in ``last_cache["plan"]``.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import pyarrow as pa

from ..batch import DeviceLike, resolve_device
from ..config import (FILECACHE_ENABLED, FUSION_ENABLED, HBM_RESERVE,
                      HOST_SPILL_LIMIT, MESH_DEVICES, MODE, SPILL_DIR,
                      RapidsTpuConf)
from ..memory.catalog import BufferCatalog, default_device_limit
from .interpreter import Interpreter
from .logical import DataFrame
from .overrides import CpuFallbackExec, ExplainMode, Overrides

#: the buffer catalog's counters ``metrics`` reports (``catalog.*``)
_CATALOG_COUNTERS = ("spilled_to_host", "spilled_to_disk", "unspilled")

#: what ``last_cache["plan"]`` says of every query
PLAN_CACHE_NOTE = "bypass: the port plans afresh (plan cache: ROADMAP item 8)"


def unsupported_conf(conf: RapidsTpuConf) -> Optional[str]:
    """Why the port cannot serve this conf yet (a key set away from its
    default for a feature the port does not have, naming the ROADMAP item
    that brings it, or a mode it does not know); None if it can."""
    why = conf.not_ported()
    if why is not None:
        return why
    mode = str(conf.get(MODE.key)).lower()
    if mode not in (MODE.default, "explainonly"):
        return f"{MODE.key} must be executeontpu or explainonly, got {mode!r}"
    return None


def _session_catalog(conf: RapidsTpuConf, device) -> Optional[BufferCatalog]:
    """A buffer catalog of the Session's own when the conf sets the memory
    budget's keys; None (the device's process-wide catalog) when it
    leaves them at their defaults."""
    if all(conf.is_default(e) for e in (HBM_RESERVE, HOST_SPILL_LIMIT,
                                        SPILL_DIR)):
        return None
    return BufferCatalog(
        default_device_limit(device, int(conf.get(HBM_RESERVE.key))),
        int(conf.get(HOST_SPILL_LIMIT.key)), str(conf.get(SPILL_DIR.key)))


class Session:
    def __init__(self, conf: Optional[Dict] = None,
                 device: DeviceLike = None):
        self.conf = RapidsTpuConf(conf)
        why = unsupported_conf(self.conf)
        if why is not None:
            raise NotImplementedError(why)
        from ..shuffle.manager import get_shuffle_manager
        get_shuffle_manager(self.conf)      # raises for a mode not ported
        self.device = resolve_device(device)
        #: the buffer catalog every scan of this Session registers in
        #: (None: the device's process-wide one)
        self.catalog = _session_catalog(self.conf, self.device)
        self.last_plan = None          # captured physical plan (exec tree)
        #: how the serving caches treated the last query
        self.last_cache: Dict[str, str] = {}
        #: host nanoseconds the last ``prepare`` took (tag, convert,
        #: coalesce pass, fusion)
        self.last_prepare_ns = 0
        from .. import adaptive
        self._adaptive_mark0 = adaptive.reason_mark()
        self._retry0 = self._adaptive0 = self._catalog0 = None
        from ..dictenc import fallback_mark
        # dict_fallbacks() reports the reasons recorded on this Session's
        # watch (the ring itself is process-wide)
        self._dict_fb_mark = fallback_mark()

    def with_conf(self, **kv) -> "Session":
        settings = dict(self.conf._settings)
        settings.update({k.replace("_", "."): v for k, v in kv.items()})
        return Session(settings, device=self.device)

    def _overrides(self) -> Overrides:
        return Overrides(self.conf, self.device, self.catalog)

    def prepare(self, df: DataFrame):
        """The planning pipeline: ``("interpret", None)`` when the query
        runs on the row interpreter (``sql.enabled=false``, or explain-only
        mode, which still plans ``last_plan``), ``("fallback", plan)`` for
        a plan whose root is a CPU island, else ``("exec", plan)``."""
        t0 = time.perf_counter_ns()
        self.last_cache["plan"] = PLAN_CACHE_NOTE
        try:
            if not self.conf.sql_enabled:
                self.last_plan = None
                return "interpret", None
            if str(self.conf.get(MODE.key)).lower() == "explainonly":
                # planned as if the device ran it; executed on the CPU
                self.last_plan = self._overrides().plan(df.plan)
                return "interpret", None
            return self._plan_fresh(df)
        finally:
            self.last_prepare_ns = time.perf_counter_ns() - t0

    def _plan_fresh(self, df: DataFrame):
        plan = self._overrides().plan(df.plan)
        self.last_plan = plan
        if isinstance(plan, CpuFallbackExec):
            # a CPU-topped plan stays on the host: no device round trip for
            # the top island's result
            return "fallback", plan
        from ..shuffle.manager import get_shuffle_manager
        if get_shuffle_manager(self.conf).wants_mesh_lowering:
            # ICI: the planned query as one stage over the mesh's shards
            # (exchanges between shards); a shape the lowering cannot
            # take keeps the host exchanges
            from ..parallel.lowering import try_lower_to_mesh
            lowered = try_lower_to_mesh(plan, self._mesh())
            if lowered is not None:
                self.last_plan = lowered
                return "exec", lowered
        if self.conf.get(FUSION_ENABLED.key):
            # whole-stage fusion: an eligible linear single-batch stage runs
            # as one program (a CUDA graph on the card); other shapes,
            # islands among them, keep the iterator path
            from ..exec.fuse import try_fuse_exec
            fused = try_fuse_exec(plan)
            if fused is not None:
                plan = fused
                self.last_plan = plan
        return "exec", plan

    def _mesh(self):
        """The one-axis row mesh: ``mesh.devices`` shards (0: one per
        visible device of the Session's type), round-robin from the
        Session's device."""
        from ..parallel.mesh import Mesh, visible_devices
        n = (int(self.conf.get(MESH_DEVICES.key))
             or len(visible_devices(self.device)))
        return Mesh.round_robin(n, self.device)

    def _catalog_counters(self) -> Dict[str, int]:
        from ..memory.catalog import device_budget
        cat = self.catalog or device_budget(self.device)
        return {k: getattr(cat, k) for k in _CATALOG_COUNTERS}

    def _watermark(self) -> None:
        """Snapshot the counter groups once per collect: the retry and
        adaptive ones are process-wide, and the catalog may be shared."""
        from .. import adaptive
        from ..memory.retry import metrics as _retry_metrics
        self._retry0 = _retry_metrics().snapshot()
        self._adaptive0 = adaptive.metrics().snapshot()
        self._adaptive_mark0 = adaptive.reason_mark()
        self._catalog0 = self._catalog_counters()

    def collect(self, df: DataFrame, _prepared=None) -> pa.Table:
        """Plan (unless ``_prepared``, a ``prepare`` result, is given),
        install the conf's retry and injection settings, run and pull the
        result to the host. The plan is closed whatever happens
        (``exec.collect``)."""
        self._watermark()
        kind, plan = _prepared if _prepared is not None \
            else self.prepare(df)
        if kind == "interpret":
            return Interpreter(ansi=self.conf.ansi).execute(df.plan)
        from ..exec.base import collect as collect_exec
        from ..memory.retry import apply_session_conf
        # process-wide, like the reference's per-executor retry state
        apply_session_conf(self.conf)
        if kind == "fallback":
            try:
                return plan.interpret()
            finally:
                plan.close()
        return collect_exec(plan)

    def cache(self, df: DataFrame) -> DataFrame:
        """Materialize as parquet-compressed cached partitions (reference:
        ParquetCachedBatchSerializer behind df.cache())."""
        if not self.conf.get(FILECACHE_ENABLED.key):
            return df      # caching disabled: keep the logical plan as-is
        from ..io.cache import CachedRelation
        from .logical import LogicalScan
        plan = self._overrides().plan(df.plan)
        cached = CachedRelation.build(plan)
        return DataFrame(LogicalScan((), source=cached,
                                     _schema=cached.schema))

    def write(self, df: DataFrame, path: str, format: str = "parquet",
              partition_by=None, bucket_by=None, compression="snappy",
              header: bool = True):
        """Execute and write task by task: each plan partition streams its
        batches into its own part files (``io.writer.write_plan``).
        ``bucket_by=(cols, n)`` routes rows with the shuffle's murmur3
        pmod. Returns ``WriteStats``."""
        from ..io.writer import write_plan
        plan = self._physical_plan(df)
        return write_plan(plan, path, fmt=format, compression=compression,
                          partition_by=partition_by or (),
                          bucket_by=bucket_by, header=header)

    def _physical_plan(self, df: DataFrame):
        """The tree a write runs: the device plan, or with ``sql.enabled``
        false a scan of the interpreter's result."""
        if not self.conf.sql_enabled:
            from ..exec import InMemoryScanExec
            return InMemoryScanExec(
                Interpreter(ansi=self.conf.ansi).execute(df.plan),
                device=self.device, catalog=self.catalog)
        plan = self._overrides().plan(df.plan)
        self.last_plan = plan
        return plan

    def write_parquet(self, df: DataFrame, path: str, partition_by=None,
                      **kw):
        return self.write(df, path, "parquet", partition_by=partition_by,
                          **kw)

    def explain(self, df: DataFrame,
                mode: ExplainMode = ExplainMode.ALL) -> str:
        return self._overrides().explain(df.plan, mode)

    # ---- plan capture ----
    def metrics(self) -> dict:
        """The last plan's operator metrics (``Exec.name.metric``, summed
        over the tree), and the retry and adaptive counters and the buffer
        catalog's spill counters since the last collect opened
        (``retry.*``, ``adaptive.*``, ``catalog.*``)."""
        if self.last_plan is None:
            return {}
        out: Dict[str, int] = {}

        def walk(e):
            for name, m in e.metrics.items():
                v = m.total()
                if v:
                    key = f"{e.name}.{name}"
                    out[key] = out.get(key, 0) + v
            for c in _exec_children(e):
                walk(c)
        walk(self.last_plan)

        def emit_deltas(prefix: str, snap: dict, base) -> None:
            if base is None:
                return
            for k, v in snap.items():
                delta = v - base.get(k, 0)
                if delta > 0:
                    out[f"{prefix}.{k}"] = delta

        from .. import adaptive
        from ..memory.retry import metrics as _retry_metrics
        emit_deltas("retry", _retry_metrics().snapshot(), self._retry0)
        emit_deltas("adaptive", adaptive.metrics().snapshot(),
                    self._adaptive0)
        emit_deltas("catalog", self._catalog_counters(), self._catalog0)
        return out

    def executed_exec_names(self) -> List[str]:
        """The last plan's operators, root first, the device children of
        its islands included."""
        names: List[str] = []

        def walk(e):
            names.append(e.name)
            for c in _exec_children(e):
                walk(c)

        if self.last_plan is not None:
            walk(self.last_plan)
        return names

    def fell_back(self) -> List[str]:
        """The islands of the last plan (``CpuFallback[<node>]``), root
        first."""
        return [n for n in self.executed_exec_names()
                if n.startswith("CpuFallback")]

    def adaptive_decisions(self) -> List[str]:
        """Reason tags of every adaptive decision taken since this
        session's last query opened (runtime coalesce, skew split,
        broadcast switch)."""
        from .. import adaptive
        return adaptive.reasons(since=self._adaptive_mark0)

    def dict_fallbacks(self) -> List[str]:
        """Why a dictionary string column took the padded byte-matrix path
        (conf off, a cardinality over its threshold, null dictionary
        entries, a merge past maxCardinality) since this Session was made:
        the fallback is never silent."""
        from ..dictenc import fallback_reasons
        return fallback_reasons(since=self._dict_fb_mark)


def _exec_children(e) -> List:
    """An operator's children, and the device children an island keeps."""
    return list(e.children) + list(getattr(e, "child_execs", ()))
