"""Task-scoped OOM retry: split-and-retry execution over spillable inputs.

Port of ``spark_rapids_tpu/memory/retry.py``:

- ``with_retry(input, body, split=...)`` runs ``body(input)``; on a
  retryable OOM it releases the pins the attempt took (catalog pin
  snapshot/restore), forces a synchronous spill, backs off and re-runs. A
  second OOM on the same input splits it in half (down to
  ``spark.rapids.tpu.retry.splitFloorRows``) and the halves re-enter the
  queue in order, so concatenated results are bit for bit the no-OOM
  output.
- ``presplit_inputs`` and ``with_retry(..., presplit_rows=n)``: the
  adaptive skew seam, which halves an input measured over ``n`` rows
  before its first attempt (``preSplitCount``).
- ``with_retry_no_split(body)``: the same loop for bodies whose input
  cannot be halved (final merges, builds, single acquires).
- ``SpillableInput``: a batch parked in the catalog across a retry
  boundary, unpinned (spillable) between attempts.
- ``OomInjector``: deterministic fault injection
  (``spark.rapids.tpu.test.injectOOM.{mode,seed,skipCount,oomCount}``) at
  the instrumented allocation sites, so every retry path runs on the CPU.
- A final OOM (retries spent, split floor reached) raises
  ``FinalOOMError`` after writing a state dump to
  ``spark.rapids.tpu.memory.oomDumpDir`` when set. It is never retried.

Retryable: the catalog's ``OutOfBudgetError`` (injected OOMs included),
``torch.OutOfMemoryError`` (a real allocation failure on the card), and
any error whose message carries one of the JAX package's
``RETRYABLE_OOM_MARKERS``. On a real ``torch.OutOfMemoryError`` the first
recovery spills; only when the retry fails again does recovery also call
``torch.cuda.empty_cache()``, returning the allocator's cached blocks
(counted in ``emptyCacheCount``).

Not ported here: the trace spans around the backoff (the tracing slice)
and the admission semaphore's hand-off across the backoff (``TpuSemaphore``
comes with the plugin and server slices; the loop takes ``semaphore=None``).
"""

from __future__ import annotations

import os
import random
import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import Callable, Dict, List, Optional

import torch

from .catalog import BufferCatalog, OutOfBudgetError, SpillableBatch

#: substrings that classify a runtime error as a retryable device OOM
RETRYABLE_OOM_MARKERS = ("RESOURCE_EXHAUSTED", "HBM OOM")


class InjectedOOMError(OutOfBudgetError):
    """Synthetic OOM from the fault-injection layer (test-only)."""


class FinalOOMError(MemoryError):
    """OOM that survived the retry state machine. Carries the oomDumpDir
    report path when one was written."""

    def __init__(self, msg: str, dump_path: Optional[str] = None):
        super().__init__(msg)
        self.dump_path = dump_path


def is_retryable_oom(exc: BaseException) -> bool:
    """True when the retry state machine should handle ``exc``."""
    if isinstance(exc, FinalOOMError):
        return False
    if isinstance(exc, (OutOfBudgetError, torch.OutOfMemoryError)):
        return True
    msg = str(exc)
    return any(m in msg for m in RETRYABLE_OOM_MARKERS)


# ---------------------------------------------------------------------------
# retry policy (session conf applied via apply_session_conf)
# ---------------------------------------------------------------------------

class _RetryPolicy:
    def __init__(self):
        self.enabled = True
        self.max_retries = 8
        self.split_floor_rows = 1 << 10
        self.dump_dir = ""


_POLICY = _RetryPolicy()
_POLICY_LOCK = threading.Lock()


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------

class RetryMetrics:
    """Process-wide retry counters; a caller reports the difference of two
    snapshots."""

    def __init__(self):
        self._lock = threading.Lock()
        self.retry_count = 0
        self.split_and_retry_count = 0
        self.retry_block_time_ns = 0
        self.spill_bytes_triggered = 0
        self.empty_cache_count = 0
        #: adaptive skew pre-splits: inputs cut to the skew row target
        #: before the first device attempt (``with_retry(presplit_rows=)``)
        self.pre_split_count = 0
        #: per-operator {name: [retries, splits]} for the OOM dump
        self.per_op: Dict[str, List[int]] = {}

    def note_retry(self, name: str) -> None:
        with self._lock:
            self.retry_count += 1
            self.per_op.setdefault(name, [0, 0])[0] += 1

    def note_split(self, name: str) -> None:
        with self._lock:
            self.split_and_retry_count += 1
            self.per_op.setdefault(name, [0, 0])[1] += 1

    def note_presplit(self, name: str) -> None:
        with self._lock:
            self.pre_split_count += 1
            self.per_op.setdefault(name, [0, 0])[1] += 1

    def note_block(self, ns: int) -> None:
        with self._lock:
            self.retry_block_time_ns += int(ns)

    def note_spill(self, nbytes: int) -> None:
        with self._lock:
            self.spill_bytes_triggered += int(nbytes)

    def note_empty_cache(self) -> None:
        with self._lock:
            self.empty_cache_count += 1

    def snapshot(self) -> Dict[str, int]:
        with self._lock:
            return {
                "retryCount": self.retry_count,
                "splitAndRetryCount": self.split_and_retry_count,
                "retryBlockTime": self.retry_block_time_ns,
                "retrySpillBytes": self.spill_bytes_triggered,
                "emptyCacheCount": self.empty_cache_count,
                "preSplitCount": self.pre_split_count,
            }


_METRICS = RetryMetrics()


def metrics() -> RetryMetrics:
    return _METRICS


# ---------------------------------------------------------------------------
# deterministic fault injection
# ---------------------------------------------------------------------------

class OomInjector:
    """Throws InjectedOOMError at instrumented allocation sites.

    Modes: ``""`` (off), ``every-N`` (every Nth eligible check fires),
    ``random`` (seeded probability 0.2 per check; ``random-0.35`` to set
    it). ``skip_count`` exempts the first K checks; ``oom_count`` throws
    that many consecutive OOMs per trigger on the triggering thread. Checks
    under an active retry re-attempt (``suppressed()``) never start a new
    trigger, so recovery terminates; pending consecutive OOMs still fire
    there. The first check after a trigger sequence is an uncounted free
    pass, so even ``every-1`` converges at sites that re-allocate outside
    a suppressed scope.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._tls = threading.local()
        self._gen = 0
        self.configure("")

    def configure(self, mode: str, seed: int = 0, skip_count: int = 0,
                  oom_count: int = 1) -> None:
        with self._lock:
            mode = (mode or "").strip().lower()
            self._mode = mode
            self._every = 0
            self._p = 0.0
            if mode.startswith("every-"):
                self._every = max(int(mode.split("-", 1)[1]), 1)
            elif mode.startswith("random"):
                self._p = float(mode.split("-", 1)[1]) \
                    if "-" in mode else 0.2
            elif mode not in ("", "off"):
                raise ValueError(f"unknown injectOOM.mode {mode!r}")
            self._rng = random.Random(seed)
            self._skip_left = max(int(skip_count), 0)
            self._oom_count = max(int(oom_count), 1)
            self._checks = 0
            self.injected = 0
            # invalidate every thread's pending/free state without
            # replacing the thread-local itself
            self._gen += 1

    @property
    def enabled(self) -> bool:
        return bool(self._every or self._p)

    @contextmanager
    def suppressed(self):
        """Scope for retry re-attempts: no new triggers fire inside."""
        self._tls.suppress = getattr(self._tls, "suppress", 0) + 1
        try:
            yield
        finally:
            self._tls.suppress = max(
                getattr(self._tls, "suppress", 1) - 1, 0)

    def check(self, site: str) -> None:
        """Allocation-site hook; raises InjectedOOMError when the schedule
        says this allocation fails."""
        if not self.enabled:
            return
        if getattr(self._tls, "gen", -1) != self._gen:
            self._tls.gen = self._gen
            self._tls.pending = 0
            self._tls.free = False
        pending = getattr(self._tls, "pending", 0)
        if pending > 0:
            self._tls.pending = pending - 1
            if self._tls.pending == 0:
                self._tls.free = True
            with self._lock:
                self.injected += 1
            raise InjectedOOMError(
                f"injected OOM at {site} (consecutive "
                f"{self._oom_count - pending + 1}/{self._oom_count})")
        if getattr(self._tls, "free", False):
            self._tls.free = False
            return
        if getattr(self._tls, "suppress", 0) > 0:
            return
        with self._lock:
            if self._skip_left > 0:
                self._skip_left -= 1
                return
            self._checks += 1
            n = self._checks
            fire = (self._every and n % self._every == 0) or \
                (self._p and self._rng.random() < self._p)
            if fire:
                self.injected += 1
        if fire:
            if self._oom_count > 1:
                self._tls.pending = self._oom_count - 1
            else:
                self._tls.free = True
            raise InjectedOOMError(f"injected OOM at {site} (check #{n})")


_INJECTOR = OomInjector()


def injector() -> OomInjector:
    return _INJECTOR


def maybe_inject(site: str) -> None:
    """Allocation-site hook; a cheap no-op while injection is off."""
    _INJECTOR.check(site)


@contextmanager
def oom_injection(mode: str, seed: int = 0, skip_count: int = 0,
                  oom_count: int = 1):
    """Enable injection inside the block; off again after it."""
    _INJECTOR.configure(mode, seed, skip_count, oom_count)
    try:
        yield _INJECTOR
    finally:
        _INJECTOR.configure("")


# ---------------------------------------------------------------------------
# conf plumbing
# ---------------------------------------------------------------------------

def apply_session_conf(conf) -> None:
    """Install a conf's retry and injection settings process-wide (a dict
    of ``spark.rapids.tpu.*`` keys or a ``RapidsTpuConf``)."""
    from ..config import (INJECT_OOM_MODE, INJECT_OOM_OOM_COUNT,
                          INJECT_OOM_SEED, INJECT_OOM_SKIP_COUNT,
                          OOM_DUMP_DIR, RETRY_ENABLED, RETRY_MAX_RETRIES,
                          RETRY_SPLIT_FLOOR_ROWS, RapidsTpuConf)
    if not isinstance(conf, RapidsTpuConf):
        conf = RapidsTpuConf(conf)
    with _POLICY_LOCK:
        _POLICY.enabled = bool(conf.get(RETRY_ENABLED.key))
        _POLICY.max_retries = int(conf.get(RETRY_MAX_RETRIES.key))
        _POLICY.split_floor_rows = int(conf.get(RETRY_SPLIT_FLOOR_ROWS.key))
        _POLICY.dump_dir = str(conf.get(OOM_DUMP_DIR.key) or "")
    _INJECTOR.configure(str(conf.get(INJECT_OOM_MODE.key)),
                        int(conf.get(INJECT_OOM_SEED.key)),
                        int(conf.get(INJECT_OOM_SKIP_COUNT.key)),
                        int(conf.get(INJECT_OOM_OOM_COUNT.key)))


@contextmanager
def retry_policy(**overrides):
    """Temporarily override retry policy fields (enabled, max_retries,
    split_floor_rows, dump_dir)."""
    old = {k: getattr(_POLICY, k) for k in overrides}
    with _POLICY_LOCK:
        for k, v in overrides.items():
            setattr(_POLICY, k, v)
    try:
        yield
    finally:
        with _POLICY_LOCK:
            for k, v in old.items():
                setattr(_POLICY, k, v)


# ---------------------------------------------------------------------------
# spillable retry input
# ---------------------------------------------------------------------------

class SpillableInput:
    """A batch parked in the spill catalog while it waits for (re-)use by
    a retry body; unpinned between attempts."""

    def __init__(self, sb: SpillableBatch, schema, catalog: BufferCatalog,
                 rows: int):
        self.sb = sb
        self.schema = schema
        self.catalog = catalog
        self.rows = int(rows)

    @classmethod
    def from_batch(cls, batch, schema, catalog: BufferCatalog,
                   rows: Optional[int] = None) -> "SpillableInput":
        """Register ``batch``. ``rows`` is its row count where the caller
        knows it already (else one host read of ``num_rows``)."""
        rows = int(batch.num_rows) if rows is None else rows
        return cls(SpillableBatch(catalog, batch, schema), schema, catalog,
                   rows)

    @classmethod
    def admit(cls, batch, schema, catalog: BufferCatalog,
              name: str = "admit") -> "SpillableInput":
        """``from_batch`` under the retry loop: registration reserves
        budget and is itself an instrumented allocation site."""
        return with_retry_no_split(
            lambda: cls.from_batch(batch, schema, catalog),
            catalog=catalog, name=name)

    def acquire(self):
        """Materialize on the device and pin; pair with release()."""
        return self.sb.get()

    def release(self) -> None:
        self.sb.done_with()

    def close(self) -> None:
        self.sb.close()

    def split(self, floor_rows: int) -> Optional[List["SpillableInput"]]:
        """Halve by rows. None when at the floor. Closes self on success:
        the halves own the rows."""
        n = self.rows
        if n <= max(int(floor_rows), 1) or n < 2:
            return None
        from ..batch import bucket_capacity
        from ..exec.common import slice_batch
        mid = n // 2
        b = self.acquire()
        try:
            left = slice_batch(b, 0, mid, bucket_capacity(mid))
            right = slice_batch(b, mid, n - mid, bucket_capacity(n - mid))
        finally:
            self.release()
        # register the halves transactionally: an OOM on the right half
        # closes the already-registered left half
        left_si = SpillableInput.from_batch(left, self.schema, self.catalog,
                                            mid)
        try:
            right_si = SpillableInput.from_batch(right, self.schema,
                                                 self.catalog, n - mid)
        except BaseException:
            left_si.close()
            raise
        self.close()
        return [left_si, right_si]


def admit_all(batches, schema, catalog: BufferCatalog,
              name: str = "admit") -> List[SpillableInput]:
    """``SpillableInput.admit`` over a sequence, transactionally: if a
    later admit raises, the already-admitted handles are closed first."""
    out: List[SpillableInput] = []
    try:
        for b in batches:
            out.append(SpillableInput.admit(b, schema, catalog, name=name))
    except BaseException:
        for si in out:
            si.close()
        raise
    return out


def split_input_halves(item):
    """Default split policy for with_retry: halve a SpillableInput down to
    spark.rapids.tpu.retry.splitFloorRows."""
    return item.split(_POLICY.split_floor_rows)


def split_host_table(t):
    """Split policy for host (pyarrow) tables at the upload boundary: half
    the rows need half the fresh device memory. Zero-copy slices, in row
    order, so the halves' device batches concatenate bit for bit to the
    unsplit upload; None at the split floor."""
    n = t.num_rows
    if n <= max(_POLICY.split_floor_rows, 1) or n < 2:
        return None
    mid = n // 2
    return [t.slice(0, mid), t.slice(mid)]


def presplit_inputs(inp, target_rows: int,
                    split: Callable = split_input_halves) -> List:
    """Adaptive pre-split: cut an input measured over ``target_rows`` rows
    into in-order chunks before the first device attempt, with the split
    policy the retry loop applies on OOM (so the chunks are the halves an
    OOM would have made, and the split floor still bounds the recursion).
    An input without a ``rows`` measure passes through."""
    work, out = deque([inp]), []
    while work:
        item = work.popleft()
        rows = getattr(item, "rows", None)
        if rows is not None and rows > target_rows:
            halves = split(item)
            if halves:
                _METRICS.note_presplit(getattr(item, "name", "presplit"))
                for h in reversed(halves):
                    work.appendleft(h)
                continue
        out.append(item)
    return out


# ---------------------------------------------------------------------------
# the retry state machine
# ---------------------------------------------------------------------------

def _recover(cat: BufferCatalog, pin_snapshot, attempt: int,
             exc: BaseException) -> None:
    """Between attempts: release the failed attempt's pins, force the
    store to spill, and back off. After a second real allocation failure
    the allocator's cached blocks are released as well."""
    cat.restore_pins(pin_snapshot)
    spill0 = cat.spilled_to_host + cat.spilled_to_disk
    cat.synchronous_spill(max(cat.device_used, 1))
    _METRICS.note_spill(cat.spilled_to_host + cat.spilled_to_disk - spill0)
    if (attempt >= 2 and isinstance(exc, torch.OutOfMemoryError)
            and torch.cuda.is_available()):
        torch.cuda.empty_cache()
        _METRICS.note_empty_cache()
    delay = min(0.001 * (1 << min(attempt, 6)), 0.05)
    t0 = time.perf_counter_ns()
    time.sleep(delay)
    _METRICS.note_block(time.perf_counter_ns() - t0)


def _close_item(item) -> None:
    close = getattr(item, "close", None)
    if close is not None:
        try:
            close()
        except Exception:
            pass


def _final_oom(exc: BaseException, cat: BufferCatalog, name: str,
               attempts: int) -> FinalOOMError:
    path = write_oom_dump(cat, op=name, exc=exc)
    suffix = f"; state dumped to {path}" if path else \
        " (set spark.rapids.tpu.memory.oomDumpDir for a state dump)"
    return FinalOOMError(
        f"{name}: device OOM survived {attempts} attempts (pins released, "
        f"store spilled, input at split floor): {exc}{suffix}", path)


def with_retry(inp, body: Callable, split: Optional[Callable] = None, *,
               catalog: BufferCatalog, name: str = "op",
               max_retries: Optional[int] = None, close_input: bool = True,
               presplit_rows: Optional[int] = None):
    """Generator: run ``body`` over ``inp`` and whatever ``split`` makes of
    it under OOM, yielding each result in input-row order.

    ``body`` must be re-runnable and must undo its own partial side effects
    (e.g. close staged catalog handles) before letting a retryable OOM
    propagate: the framework restores pins, not arbitrary state. Items are
    closed after use when ``close_input`` (and on any raise).

    ``presplit_rows`` (the join probe's skew seam): an input measuring over
    this many rows is split through the same machinery before its first
    attempt, so a hot partition that the shuffle statistics already
    measured never has to OOM its way down to a workable size."""
    cat = catalog
    if max_retries is None:
        max_retries = _POLICY.max_retries
    if presplit_rows and split is not None and _POLICY.enabled:
        work = deque(presplit_inputs(inp, presplit_rows, split))
    else:
        work = deque([inp])
    try:
        while work:
            item = work.popleft()
            attempt = 0
            while True:
                snap = cat.pin_snapshot()
                try:
                    if attempt == 0 or not _POLICY.enabled:
                        result = body(item)
                    else:
                        # re-attempts never start new injected triggers
                        with _INJECTOR.suppressed():
                            result = body(item)
                except BaseException as e:
                    # every failed attempt gives back the pins it took
                    cat.restore_pins(snap)
                    if not (_POLICY.enabled and is_retryable_oom(e)):
                        _close_item(item)
                        raise
                    attempt += 1
                    _METRICS.note_retry(name)
                    halves = None
                    if attempt >= 2 and split is not None:
                        # an OOM inside split() is one more failed attempt
                        try:
                            with _INJECTOR.suppressed():
                                halves = split(item)
                        except BaseException as se:
                            if not is_retryable_oom(se):
                                _close_item(item)
                                raise
                        if halves:
                            _METRICS.note_split(name)
                            for h in reversed(halves):
                                work.appendleft(h)
                            break   # halves are fresh items
                    if attempt > max_retries:
                        _close_item(item)
                        raise _final_oom(e, cat, name, attempt) from e
                    _recover(cat, snap, attempt, e)
                else:
                    if close_input:
                        _close_item(item)
                    yield result
                    break
    except BaseException:
        while work:                      # free queued spillable inputs
            _close_item(work.popleft())
        raise


class _NoInput:
    """Sentinel input for with_retry_no_split (nothing to close/split)."""

    def __repr__(self):
        return "<no-input>"


_NO_INPUT = _NoInput()


def with_retry_no_split(body: Callable, *, catalog: BufferCatalog,
                        name: str = "op",
                        max_retries: Optional[int] = None):
    """Run a no-argument ``body`` under the retry loop, without a split
    policy. Returns the body's result."""
    return next(with_retry(_NO_INPUT, lambda _i: body(), split=None,
                           catalog=catalog, name=name,
                           max_retries=max_retries, close_input=False))


def acquire_with_retry(sb: SpillableBatch, *, name: str = "acquire"):
    """Pin a spillable handle under the retry loop: the unspill path
    reserves device budget and can itself OOM."""
    return with_retry_no_split(sb.get, catalog=sb.catalog, name=name)


def register_with_retry(batch, schema, *, catalog: BufferCatalog,
                        name: str = "register",
                        priority: int = 0) -> SpillableBatch:
    """SpillableBatch registration under the retry loop."""
    return with_retry_no_split(
        lambda: SpillableBatch(catalog, batch, schema, priority),
        catalog=catalog, name=name)


# ---------------------------------------------------------------------------
# final-OOM state dump
# ---------------------------------------------------------------------------

def write_oom_dump(catalog: BufferCatalog, op: Optional[str] = None,
                   exc: Optional[BaseException] = None,
                   dump_dir: Optional[str] = None) -> Optional[str]:
    """Write the post-retry OOM report. Returns the path, or None when no
    dump dir is configured or the write fails (a dump never masks the
    original OOM)."""
    d = dump_dir if dump_dir is not None else _POLICY.dump_dir
    if not d:
        return None
    try:
        os.makedirs(d, exist_ok=True)
        path = os.path.join(
            d, f"oom-{os.getpid()}-{threading.get_ident()}-"
               f"{int(time.time() * 1000)}.txt")
        lines = ["=== spark-rapids-tpu OOM dump ==="]
        if op:
            lines.append(f"operator: {op}")
        if exc is not None:
            lines.append(f"error: {type(exc).__name__}: {exc}")
        lines += ["", "--- catalog tier occupancy ---",
                  catalog.tier_summary(), "",
                  "--- catalog entries (pinned handles marked) ---",
                  catalog.dump_state(), "",
                  "--- retry/split counts per operator ---"]
        snap = _METRICS.snapshot()
        lines.append(f"total: retries={snap['retryCount']} "
                     f"splits={snap['splitAndRetryCount']} "
                     f"blockTimeNs={snap['retryBlockTime']} "
                     f"spillBytes={snap['retrySpillBytes']}")
        for nm, (r, s) in sorted(_METRICS.per_op.items()):
            lines.append(f"  {nm}: retries={r} splits={s}")
        if torch.cuda.is_available():
            lines += ["", "--- device allocator ---",
                      f"memory_allocated={torch.cuda.memory_allocated()} "
                      f"memory_reserved={torch.cuda.memory_reserved()}"]
        with open(path, "w") as f:
            f.write("\n".join(lines) + "\n")
        return path
    except Exception:
        return None
