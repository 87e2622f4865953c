"""Tiered buffer catalog with reservation-triggered spill.

Port of ``spark_rapids_tpu/memory/catalog.py``: ``StorageTier``,
``OutOfBudgetError``, ``BufferCatalog``, ``SpillableBatch`` and
``device_budget``, with the JAX package's reservation design. The budget
counts the bytes of registered batches and explicit reservations; it is
not what torch's caching allocator holds, which can run above it (cached
free blocks, operator temporaries, batches no catalog holds). A
reservation that does not fit spills unpinned device entries, lowest
priority first, until it does.

Tiers:
  DEVICE - the batch's own tensors on its device
  HOST   - one ``HostTable`` per batch (``shuffle/serializer.py``): every
           lane in one host buffer, pinned for a CUDA batch, bounded by
           ``host_limit``
  DISK   - one frame file per batch under ``spill_dir``

A spill frees device memory only when the entry held the last references
to tensors that own their storage; a batch registered while something
else keeps its tensors (or a larger tensor they are views of) frees
nothing when it spills. Device-to-host copies are enqueued without a
wait; the host bytes are read (host-to-disk) only after the table's event.
Host buffers come from torch's caching host allocator, so a freed spill
buffer is reused by the next of its size class.

Spill priority: smaller value spills FIRST.
"""

from __future__ import annotations

import os
import threading
from dataclasses import dataclass
from enum import Enum
from typing import Dict, List, Optional

import torch

from ..batch import ColumnarBatch, DeviceLike, Schema, resolve_device
from ..config import HBM_RESERVE, HOST_SPILL_LIMIT, SPILL_DIR

#: the JAX package's default budget, kept for the CPU
CPU_DEVICE_LIMIT = 8 << 30

_maybe_inject = None


def _inject(site: str) -> None:
    """Late-bound hook into ``retry.maybe_inject`` (retry imports this
    module)."""
    global _maybe_inject
    if _maybe_inject is None:
        from .retry import maybe_inject
        _maybe_inject = maybe_inject
    _maybe_inject(site)


class StorageTier(Enum):
    DEVICE = 0
    HOST = 1
    DISK = 2


class OutOfBudgetError(MemoryError):
    pass


@dataclass
class _Entry:
    handle_id: int
    tier: StorageTier
    size: int
    priority: int
    device: torch.device
    batch: Optional[ColumnarBatch] = None          # DEVICE
    host: Optional[object] = None                  # HOST: HostTable
    path: Optional[str] = None                     # DISK
    schema: Optional[Schema] = None
    pinned: int = 0
    origin: Optional[str] = None                   # leak tracking: creator


class LeakError(RuntimeError):
    """Catalog handles outlived their owner."""


class DoubleReleaseError(RuntimeError):
    """release() on an unpinned handle."""


class BufferCatalog:
    def __init__(self, device_limit: int = CPU_DEVICE_LIMIT,
                 host_limit: int = HOST_SPILL_LIMIT.default,
                 spill_dir: str = SPILL_DIR.default,
                 track_leaks: bool = False):
        self.device_limit = device_limit
        self.host_limit = host_limit
        self.spill_dir = spill_dir
        self._entries: Dict[int, _Entry] = {}
        self._next = 0
        self._lock = threading.RLock()
        #: per-thread pin multiset {tid: {hid: count}}: the retry loop
        #: snapshots and restores a task's pins between attempts
        self._thread_pins: Dict[int, Dict[int, int]] = {}
        self.device_used = 0
        self.host_used = 0
        self.spilled_to_host = 0
        self.spilled_to_disk = 0
        #: bytes brought back from the host or disk tiers
        self.unspilled = 0
        # leak tracking: record who registered each handle (off by
        # default: capturing stacks costs time on the hot path)
        self.track_leaks = track_leaks

    # ------------------------------------------------------------------
    # registration / reservation
    # ------------------------------------------------------------------

    def register(self, batch: ColumnarBatch, schema: Schema,
                 priority: int = 0) -> int:
        size = batch.size_bytes()
        origin = None
        if self.track_leaks:
            import traceback
            # the closest non-catalog frame is the owner
            for f in reversed(traceback.extract_stack(limit=8)[:-1]):
                if "memory/catalog" not in f.filename:
                    origin = f"{f.filename}:{f.lineno} in {f.name}"
                    break
        with self._lock:
            self.reserve(size)
            hid = self._next
            self._next += 1
            self._entries[hid] = _Entry(hid, StorageTier.DEVICE, size,
                                        priority, batch.device, batch=batch,
                                        schema=schema, origin=origin)
            return hid

    def reserve(self, nbytes: int) -> None:
        """Ensure ``nbytes`` of device budget, spilling if necessary. Every
        reservation is an instrumented allocation site."""
        _inject("catalog.reserve")
        with self._lock:
            if self.device_used + nbytes <= self.device_limit:
                self.device_used += nbytes
                return
            need = self.device_used + nbytes - self.device_limit
            freed = self.synchronous_spill(need)
            if self.device_used + nbytes > self.device_limit:
                raise OutOfBudgetError(
                    f"cannot reserve {nbytes}b: used {self.device_used}b of "
                    f"{self.device_limit}b after spilling {freed}b")
            self.device_used += nbytes

    # ------------------------------------------------------------------
    # spill machinery
    # ------------------------------------------------------------------

    def synchronous_spill(self, need: int) -> int:
        """Spill unpinned device buffers in priority order until ``need``
        bytes are freed (or no candidates remain). Returns bytes freed."""
        freed = 0
        with self._lock:
            victims = sorted(
                [e for e in self._entries.values()
                 if e.tier is StorageTier.DEVICE and e.pinned == 0],
                key=lambda e: e.priority)
            for e in victims:
                if freed >= need:
                    break
                self._spill_to_host(e)
                freed += e.size
        return freed

    def _spill_to_host(self, e: _Entry) -> None:
        from ..shuffle.serializer import HostTable
        e.host = HostTable.pack(e.batch)
        e.batch = None          # the copies are enqueued: drop the tensors
        e.tier = StorageTier.HOST
        self.device_used = max(0, self.device_used - e.size)
        self.host_used += e.size
        self.spilled_to_host += e.size
        if self.host_used > self.host_limit:
            self._overflow_host_to_disk()

    def _overflow_host_to_disk(self) -> None:
        victims = sorted(
            [e for e in self._entries.values()
             if e.tier is StorageTier.HOST and e.pinned == 0],
            key=lambda e: e.priority)
        for e in victims:
            if self.host_used <= self.host_limit:
                break
            os.makedirs(self.spill_dir, exist_ok=True)
            path = os.path.join(self.spill_dir,
                                f"buf-{os.getpid()}-{id(self)}-"
                                f"{e.handle_id}.rtpu")
            with open(path, "wb") as f:
                f.write(e.host.frame())     # waits for the D2H copies
            e.path = path
            e.host = None
            e.tier = StorageTier.DISK
            self.host_used = max(0, self.host_used - e.size)
            self.spilled_to_disk += e.size

    # ------------------------------------------------------------------
    # access
    # ------------------------------------------------------------------

    def acquire(self, hid: int) -> ColumnarBatch:
        """Materialize a handle on its device (unspilling as needed) and
        pin it. Every pin is an instrumented allocation site."""
        _inject("catalog.acquire")
        with self._lock:
            e = self._entries[hid]
            if e.tier is not StorageTier.DEVICE:
                self.reserve(e.size)
                if e.tier is StorageTier.DISK:
                    from ..shuffle.serializer import (HostTable,
                                                      deserialize_host)
                    with open(e.path, "rb") as f:
                        arrays, _ = deserialize_host(f.read())
                    e.host = HostTable.from_arrays(
                        arrays, pin=e.device.type == "cuda")
                    os.remove(e.path)
                    e.path = None
                    e.tier = StorageTier.HOST
                    self.host_used += e.size
                e.batch = e.host.to_device(e.schema, e.device)
                self.host_used = max(0, self.host_used - e.size)
                self.unspilled += e.size
                e.host = None
                e.tier = StorageTier.DEVICE
            e.pinned += 1
            self._note_pin(hid, +1)
            return e.batch

    def release(self, hid: int) -> None:
        with self._lock:
            e = self._entries[hid]
            if e.pinned <= 0:
                raise DoubleReleaseError(
                    f"handle #{hid} released while unpinned"
                    + (f" (registered at {e.origin})" if e.origin else ""))
            e.pinned -= 1
            self._note_pin(hid, -1)

    def remove(self, hid: int) -> None:
        with self._lock:
            e = self._entries.pop(hid, None)
            if e is None:
                return
            for tp in self._thread_pins.values():
                tp.pop(hid, None)
            if e.tier is StorageTier.DEVICE:
                self.device_used = max(0, self.device_used - e.size)
            elif e.tier is StorageTier.HOST:
                self.host_used = max(0, self.host_used - e.size)
            elif e.path:
                try:
                    os.remove(e.path)
                except OSError:
                    pass

    def tier_of(self, hid: int) -> StorageTier:
        return self._entries[hid].tier

    # ------------------------------------------------------------------
    # per-thread pin accounting (retry support)
    # ------------------------------------------------------------------

    def _note_pin(self, hid: int, delta: int) -> None:
        """Record a pin/unpin against the calling thread (under _lock)."""
        tid = threading.get_ident()
        tp = self._thread_pins.setdefault(tid, {})
        c = tp.get(hid, 0) + delta
        if c <= 0:
            tp.pop(hid, None)
            if not tp:
                self._thread_pins.pop(tid, None)
        else:
            tp[hid] = c

    def pin_snapshot(self) -> Dict[int, int]:
        """The calling thread's current pin multiset {hid: count}."""
        with self._lock:
            return dict(self._thread_pins.get(threading.get_ident(), {}))

    def restore_pins(self, snapshot: Dict[int, int]) -> None:
        """Release every pin the calling thread took since ``snapshot`` (a
        failed retry attempt's pins), so held batches become spillable
        again. Pins the body released itself and removed handles are
        skipped."""
        with self._lock:
            current = dict(self._thread_pins.get(threading.get_ident(), {}))
            for hid, cnt in current.items():
                excess = cnt - snapshot.get(hid, 0)
                for _ in range(excess):
                    e = self._entries.get(hid)
                    if e is None or e.pinned <= 0:
                        break
                    e.pinned -= 1
                    self._note_pin(hid, -1)

    def total_pinned(self) -> int:
        """Sum of pin counts over all handles (0 = everything spillable)."""
        with self._lock:
            return sum(e.pinned for e in self._entries.values())

    def tier_summary(self) -> str:
        """One line per tier: entry count and registered bytes, plus the
        budget headroom."""
        with self._lock:
            per = {t: [0, 0] for t in StorageTier}
            pinned = 0
            for e in self._entries.values():
                per[e.tier][0] += 1
                per[e.tier][1] += e.size
                if e.pinned:
                    pinned += 1
            lines = [f"device_used={self.device_used}b of "
                     f"{self.device_limit}b; host_used={self.host_used}b "
                     f"of {self.host_limit}b; pinned_handles={pinned}; "
                     f"total_pins={self.total_pinned()}"]
            for t in StorageTier:
                lines.append(f"  {t.name}: {per[t][0]} entries, "
                             f"{per[t][1]}b")
            lines.append(f"  spilled_to_host={self.spilled_to_host}b "
                         f"spilled_to_disk={self.spilled_to_disk}b")
            return "\n".join(lines)

    # ------------------------------------------------------------------
    # leak detection
    # ------------------------------------------------------------------

    def leak_check(self) -> List[str]:
        """Describe every handle still registered: after a query closes
        its plan, a non-empty result is a leak."""
        with self._lock:
            return [
                f"#{e.handle_id} {e.tier.name} {e.size}b pinned={e.pinned}"
                + (f" from {e.origin}" if e.origin else "")
                for e in self._entries.values()]

    def assert_no_leaks(self) -> None:
        leaks = self.leak_check()
        if leaks:
            raise LeakError(
                f"{len(leaks)} catalog handle(s) leaked:\n  " +
                "\n  ".join(leaks))

    def dump_state(self) -> str:
        """OOM diagnostics: usage and every entry."""
        with self._lock:
            lines = [f"device_used={self.device_used} "
                     f"host_used={self.host_used}"]
            for e in self._entries.values():
                lines.append(f"  #{e.handle_id} {e.tier.name} {e.size}b "
                             f"prio={e.priority} pinned={e.pinned}")
            return "\n".join(lines)


class SpillableBatch:
    """Operator-facing wrapper: hold between uses, ``get()`` to touch,
    ``done_with()`` to unpin, ``close()`` when done."""

    def __init__(self, catalog: BufferCatalog, batch: ColumnarBatch,
                 schema: Schema, priority: int = 0):
        self.catalog = catalog
        self.schema = schema
        self.hid = catalog.register(batch, schema, priority)
        self._open = True

    def get(self) -> ColumnarBatch:
        assert self._open
        return self.catalog.acquire(self.hid)

    def done_with(self) -> None:
        """Release the pin so the batch becomes spillable again."""
        self.catalog.release(self.hid)

    def close(self) -> None:
        if self._open:
            self.catalog.remove(self.hid)
            self._open = False

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


_BUDGETS: Dict[str, BufferCatalog] = {}
_BUDGET_LOCK = threading.Lock()


def default_device_limit(dev: torch.device,
                         reserve: int = HBM_RESERVE.default) -> int:
    """The card's total memory less ``reserve``
    (``spark.rapids.tpu.memory.hbm.reserve``) on CUDA; the JAX package's
    8 GiB on the CPU."""
    if dev.type != "cuda":
        return CPU_DEVICE_LIMIT
    _, total = torch.cuda.mem_get_info(dev)
    return max(total - reserve, 0)


def device_budget(device: DeviceLike = None,
                  device_limit: Optional[int] = None,
                  host_limit: Optional[int] = None,
                  spill_dir: Optional[str] = None) -> BufferCatalog:
    """The process-wide catalog of ``device`` (default: ``cuda``), made at
    first use. An explicit ``device_limit`` wins over the default; the
    limits of a catalog that exists already stay as they are."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    key = str(dev)
    with _BUDGET_LOCK:
        cat = _BUDGETS.get(key)
        if cat is None:
            cat = BufferCatalog(
                device_limit or default_device_limit(dev),
                host_limit or HOST_SPILL_LIMIT.default,
                spill_dir or SPILL_DIR.default)
            _BUDGETS[key] = cat
        return cat
