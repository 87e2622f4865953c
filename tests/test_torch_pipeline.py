"""The port's bounded prefetch pipeline (spark_rapids_tpu_torch/pipeline.py)
under the cases of tests/test_pipeline.py, and against the JAX package's
``prefetched``: the same item stream out of both.

The contract the scan side relies on: exceptions cross the thread
boundary, aborts cancel the producer promptly with no leaked threads,
depth=0 is the synchronous path bit for bit, and single-core hosts never
pay the thread handoff.
"""

import threading
import time

import pytest

from spark_rapids_tpu import pipeline as jax_pipeline
from spark_rapids_tpu_torch.pipeline import (PrefetchIterator, close_iterator,
                                            prefetched)


def _producer_threads():
    return [t for t in threading.enumerate()
            if t.name.endswith("-producer") and t.is_alive()]


def _assert_no_producer_threads():
    deadline = time.monotonic() + 5
    while _producer_threads() and time.monotonic() < deadline:
        time.sleep(0.01)
    assert not _producer_threads(), threading.enumerate()


def test_passthrough_order_and_completeness():
    it = prefetched(iter(range(1000)), depth=2, force_thread=True)
    assert list(it) == list(range(1000))
    _assert_no_producer_threads()


def test_depth_zero_is_the_source_iterator():
    """depth=0 must reproduce the synchronous path bit for bit — the
    wrapper returns the SOURCE iterator itself, not a thread pipeline."""
    src = iter(range(10))
    it = prefetched(src, depth=0)
    assert it is src
    assert list(it) == list(range(10))
    gen = (x * 2 for x in range(5))
    assert prefetched(gen, depth=0) is gen


def test_single_core_skips_thread_handoff(monkeypatch):
    """Matches the single-core inline policy in io/source.py: a thread
    cannot overlap CPU-bound work on one core."""
    import spark_rapids_tpu_torch.pipeline as P
    monkeypatch.setattr(P.os, "cpu_count", lambda: 1)
    src = iter(range(10))
    it = prefetched(src, depth=2)
    assert it is src
    # force_thread overrides (I/O-bound producers still overlap)
    it2 = prefetched(iter(range(10)), depth=2, force_thread=True)
    assert isinstance(it2, PrefetchIterator)
    assert list(it2) == list(range(10))


def test_producer_exception_reraised_at_consumer():
    class Boom(RuntimeError):
        pass

    def gen():
        yield 1
        yield 2
        raise Boom("decode failed")

    it = prefetched(gen(), depth=2, force_thread=True)
    got = []
    with pytest.raises(Boom, match="decode failed"):
        for x in it:
            got.append(x)
    # everything produced BEFORE the failure was delivered first
    assert got == [1, 2]
    _assert_no_producer_threads()
    # the iterator is cleanly finished afterwards
    assert list(it) == []


def test_consumer_abort_cancels_producer_promptly():
    produced = []
    release = threading.Event()

    def gen():
        for i in range(10_000):
            produced.append(i)
            yield i

    it = prefetched(gen(), depth=2, force_thread=True)
    assert next(it) == 0
    it.close()                      # consumer abort (limit early-exit)
    _assert_no_producer_threads()
    # bounded look-ahead: the producer ran at most depth+in-flight items
    # past what was consumed, never the whole stream
    assert len(produced) <= 8, len(produced)
    assert release.is_set() is False
    # close is idempotent and the iterator is finished
    it.close()
    assert list(it) == []


def test_abort_closes_the_source_generator():
    closed = threading.Event()

    def gen():
        try:
            for i in range(10_000):
                yield i
        finally:
            closed.set()

    it = prefetched(gen(), depth=2, force_thread=True)
    next(it)
    it.close()
    assert closed.wait(5), "source generator was not closed on abort"
    _assert_no_producer_threads()


def test_abort_while_producer_blocked_on_full_queue():
    """The queue is full and the producer is parked in put(): close()
    must still cancel and join it."""
    started = threading.Event()

    def gen():
        for i in range(100):
            started.set()
            yield i

    it = prefetched(gen(), depth=1, force_thread=True)
    assert started.wait(5)
    time.sleep(0.1)                 # let the producer fill the queue
    it.close()
    _assert_no_producer_threads()


def test_overlap_metrics_accumulate():
    class M:
        def __init__(self):
            self.value = 0

        def add(self, v):
            self.value += int(v)

    metrics = {"overlapTime": M(), "prefetchWaitTime": M()}

    def slow_gen():
        for i in range(5):
            time.sleep(0.01)        # producer work to hide
            yield i

    it = prefetched(slow_gen(), depth=2, metrics=metrics,
                    force_thread=True)
    for _ in it:
        time.sleep(0.02)            # consumer busy: producer overlaps
    assert metrics["overlapTime"].value > 0
    _assert_no_producer_threads()


def test_runs_on_executor_pool():
    import concurrent.futures as cf
    pool = cf.ThreadPoolExecutor(2, thread_name_prefix="test-pipeline")
    try:
        it = prefetched(iter(range(50)), depth=2, pool=pool,
                        force_thread=True)
        assert list(it) == list(range(50))
    finally:
        pool.shutdown()


def test_clean_shutdown_on_success_error_and_abort_paths():
    """The acceptance sweep: every termination path leaves no thread."""
    # success
    list(prefetched(iter(range(100)), 2, force_thread=True))
    # error
    def bad():
        yield 1
        raise ValueError("x")
    it = prefetched(bad(), 2, force_thread=True)
    with pytest.raises(ValueError):
        list(it)
    # abort
    it = prefetched(iter(range(1000)), 2, force_thread=True)
    next(it)
    it.close()
    _assert_no_producer_threads()


@pytest.mark.parametrize("depth", [0, 1, 2, 5])
@pytest.mark.parametrize("source", ["range", "tables", "raises"])
def test_same_stream_as_the_jax_prefetched(depth, source):
    """Both packages' ``prefetched`` give the same items in the same order,
    and the same error after them."""
    import pyarrow as pa

    def items():
        if source == "range":
            yield from range(300)
        elif source == "tables":
            for i in range(20):
                yield pa.table({"x": list(range(i, i + 7))})
        else:
            yield from range(5)
            raise KeyError("decode failed")

    def drain(impl):
        got = []
        it = impl.prefetched(items(), depth, force_thread=True)
        try:
            for x in it:
                got.append(x)
        except KeyError as e:
            got.append(("raised", str(e)))
        finally:
            close_iterator(it)
        return got

    import spark_rapids_tpu_torch.pipeline as port
    assert drain(port) == drain(jax_pipeline)
    _assert_no_producer_threads()


def test_close_iterator_closes_generators_and_skips_plain_iterators():
    closed = []

    def gen():
        try:
            yield 1
            yield 2
        finally:
            closed.append(True)

    g = gen()
    next(g)
    close_iterator(g)
    assert closed == [True]
    close_iterator(iter([1, 2]))       # no close(): nothing to do
