"""Bounded producer/consumer pipeline (prefetch).

Port of ``spark_rapids_tpu/pipeline.py``. The scan side runs its producer
(host decode) ahead of the consumer (the upload and the device work)
through a bounded queue, so the next batch decodes while this one is on
the card. The upload and every CUDA call stay on the consumer's thread;
the producer touches host memory only. Contract:

- ``depth <= 0`` returns the source iterator unchanged: the synchronous
  path, bit for bit (``spark.rapids.tpu.prefetch.depth=0``).
- Single-core hosts skip the thread handoff (a thread cannot overlap
  CPU-bound work there, and the handoff taxes the loop).
- Producer exceptions are re-raised at the consumer, after every item
  produced before the failure has been consumed.
- Closing the iterator (consumer abort: limits, errors downstream)
  cancels the producer promptly, closes the source generator on the
  producer's thread and joins it. The DONE marker always lands, so the
  consumer never blocks on a dead producer.
- ``overlapTime``: producer work hidden behind the consumer (busy time
  minus the time the consumer waited on the queue); ``prefetchWaitTime``:
  the consumer's wait.
"""

from __future__ import annotations

import os
import queue
import threading
import time
from typing import Iterable, Iterator, Optional

_ITEM, _ERR, _DONE = 0, 1, 2

#: joins/cancellation must complete well inside this (seconds); a producer
#: stuck past it indicates a hung decode, not a pipeline bug
_JOIN_TIMEOUT_S = 30.0


def prefetched(source: Iterable, depth: int, pool=None, metrics=None,
               name: str = "prefetch", force_thread: bool = False):
    """Wrap ``source`` so it is produced ``depth`` items ahead of the
    consumer on a background thread. Returns the plain iterator (no
    thread, no queue) when depth<=0 or on single-core hosts —
    ``force_thread`` overrides the single-core policy for I/O-bound
    producers (and tests)."""
    if depth is None or depth <= 0:
        return iter(source)
    if not force_thread and (os.cpu_count() or 1) <= 1:
        return iter(source)
    return PrefetchIterator(source, depth, pool=pool, metrics=metrics,
                            name=name)


class PrefetchIterator:
    """Iterator over ``source`` produced ahead through a bounded queue.

    ``pool`` runs the producer on an executor instead of a dedicated
    thread. NOTE for pool users: the producer OCCUPIES one worker for the
    iterator's whole lifetime — a pool whose every worker is a producer
    that submits work back into the same pool deadlocks, which is why the
    scan side uses a dedicated thread and lets the decode tasks have the
    shared reader pool to themselves."""

    def __init__(self, source: Iterable, depth: int, pool=None,
                 metrics=None, name: str = "prefetch"):
        self._source = source
        self._q: queue.Queue = queue.Queue(maxsize=max(int(depth), 1))
        self._cancel = threading.Event()
        self._metrics = metrics if metrics is not None else {}
        self._busy_ns = 0       # producer time spent inside next(source)
        self._wait_ns = 0       # consumer time spent blocked on the queue
        self._finished = False
        self._future = None
        self._thread: Optional[threading.Thread] = None
        if pool is not None:
            self._future = pool.submit(self._run)
        else:
            self._thread = threading.Thread(
                target=self._run, name=f"{name}-producer", daemon=True)
            self._thread.start()

    # ---- producer side ----
    def _put(self, item) -> bool:
        """Blocking put that observes cancellation; False = cancelled."""
        while not self._cancel.is_set():
            try:
                self._q.put(item, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    def _run(self) -> None:
        it = iter(self._source)
        try:
            while not self._cancel.is_set():
                t0 = time.perf_counter_ns()
                try:
                    item = next(it)
                except StopIteration:
                    break
                except BaseException as e:   # re-raised at the consumer
                    self._busy_ns += time.perf_counter_ns() - t0
                    self._put((_ERR, e))
                    return
                self._busy_ns += time.perf_counter_ns() - t0
                if not self._put((_ITEM, item)):
                    break
        finally:
            if self._cancel.is_set():
                # consumer abort: release the source's resources (file
                # handles, nested pipelines) on the thread that drove it
                close = getattr(it, "close", None)
                if close is not None:
                    try:
                        close()
                    except Exception:
                        pass
            if not self._put((_DONE, None)):
                # cancelled with a full queue: make room so the marker
                # lands (close() is draining concurrently; benign race)
                try:
                    self._q.get_nowait()
                except queue.Empty:
                    pass
                try:
                    self._q.put_nowait((_DONE, None))
                except queue.Full:
                    pass

    def _producer_done(self) -> bool:
        if self._thread is not None:
            return not self._thread.is_alive()
        return self._future.done()

    def _join(self) -> None:
        if self._thread is not None:
            self._thread.join(timeout=_JOIN_TIMEOUT_S)
        else:
            try:
                self._future.result(timeout=_JOIN_TIMEOUT_S)
            except Exception:
                pass   # producer errors were already routed via _ERR

    # ---- consumer side ----
    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        if self._finished:
            raise StopIteration
        t0 = time.perf_counter_ns()
        tag, val = self._q.get()
        self._wait_ns += time.perf_counter_ns() - t0
        if tag == _ITEM:
            return val
        self._finish()
        if tag == _ERR:
            raise val
        raise StopIteration

    def _finish(self) -> None:
        if self._finished:
            return
        self._finished = True
        self._join()
        get = getattr(self._metrics, "get", None)
        if get is not None:
            m = get("overlapTime")
            if m is not None:
                m.add(max(self._busy_ns - self._wait_ns, 0))
            w = get("prefetchWaitTime")
            if w is not None:
                w.add(self._wait_ns)

    def close(self) -> None:
        """Consumer abort: cancel the producer, drain, join. Idempotent."""
        if self._finished:
            return
        self._cancel.set()
        # drain so a producer blocked on a full queue can observe the
        # cancel and exit; bounded in case the producer is hung mid-item
        deadline = time.monotonic() + _JOIN_TIMEOUT_S
        while not self._producer_done() and time.monotonic() < deadline:
            try:
                self._q.get(timeout=0.05)
            except queue.Empty:
                pass
        while True:   # leftover items + the DONE marker
            try:
                self._q.get_nowait()
            except queue.Empty:
                break
        self._finish()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        # abandoned mid-stream (consumer generator GC'd): stop the
        # producer rather than letting it fill the queue and park forever
        try:
            self.close()
        except Exception:
            pass


def close_iterator(it) -> None:
    """Close an iterator if it supports it (PrefetchIterator or
    generator) — the consumer-side finally-block helper."""
    close = getattr(it, "close", None)
    if close is not None:
        close()
