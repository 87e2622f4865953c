"""The chip run's profiling guard, on the CPU with the profiler and the
device calls replaced: ``chip_smoke.capture`` profiles a call again while
a sentinel kernel is missing from the device records, with twice the lead
when the first is missing and twice the pad when the last is, fails after
``PROFILE_TRIES`` tries, and keeps the records between the sentinels;
``profiled`` fails when the device did nothing there."""

import types

import pytest
import torch

import chip_smoke

CUDA = torch.autograd.DeviceType.CUDA
SENTINEL = "at::cuda::(anonymous namespace)::spin_kernel(long)"
COPY = "Memcpy HtoD (Pageable -> Device)"
FILL = "void at::native::vectorized_elementwise_kernel<4, FillFunctor<int>>"


def _event(name, start=0.0, end=1.0):
    """A raw record of the profiler's results (times in us)."""
    return types.SimpleNamespace(
        name=lambda: name, device_type=lambda: CUDA,
        start_ns=lambda: int(start * 1000),
        duration_ns=lambda: int((end - start) * 1000))


class _FakeProfile:
    """Stands for ``torch.profiler.profile``: session ``i`` records the
    events ``sessions[i]``."""

    def __init__(self, sessions):
        self._sessions = iter(sessions)
        self._events = None

    def __call__(self, activities):
        self._events = next(self._sessions)
        return self

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    @property
    def profiler(self):
        events = self._events
        return types.SimpleNamespace(kineto_results=types.SimpleNamespace(
            events=lambda: events))


@pytest.fixture
def session(monkeypatch):
    """``install(sessions)`` replaces the profiler; returns the host idle
    pads that ``capture`` slept, in order."""
    pads = []
    monkeypatch.setattr(chip_smoke.time, "sleep", pads.append)
    monkeypatch.setattr(torch.cuda, "_sleep", lambda cycles: None)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: None)
    monkeypatch.setitem(chip_smoke._window, "lead", 4)
    monkeypatch.setitem(chip_smoke._window, "pad", 0.02)

    def install(sessions):
        monkeypatch.setattr(torch.profiler, "profile",
                            _FakeProfile(sessions))
        return pads
    return install


def _full():
    """A session that kept every record: a lead kernel, the sentinels and
    the call's two overlapping copies between them, under the call's range
    that the profiler mirrors onto the device timeline."""
    return [_event(FILL, 0, 1), _event(SENTINEL, 2, 3), _event(COPY, 4, 6),
            _event(chip_smoke.CALL_RANGE, 4, 9), _event(COPY, 5, 9),
            _event(SENTINEL, 10, 11)]


def test_capture_keeps_the_records_between_the_sentinels(session):
    pads = session([_full()])
    _, wall_us, out, events = chip_smoke.capture(lambda: "done", "cpu")
    assert out == "done" and wall_us >= 0
    assert [e.name for e in events] == [COPY, COPY]
    assert pads == [0.02]
    assert chip_smoke._window == {"lead": 4, "pad": 0.02}


def test_a_lost_first_sentinel_doubles_the_lead(session):
    calls = []
    pads = session([_full()[2:], _full()])
    chip_smoke.capture(lambda: calls.append(1), "cpu")
    assert len(calls) == 2 and pads == [0.02, 0.02]
    # the lead stays grown for the next profiled call
    assert chip_smoke._window == {"lead": 8, "pad": 0.02}


def test_a_lost_last_sentinel_doubles_the_pad(session):
    pads = session([_full()[:-1], _full()])
    chip_smoke.capture(lambda: None, "cpu")
    assert pads == [0.02, 0.04]
    assert chip_smoke._window == {"lead": 4, "pad": 0.04}


def test_both_sentinels_lost_double_both(session):
    session([[_event(COPY)], [_event(COPY)], _full()])
    chip_smoke.capture(lambda: None, "cpu")
    assert chip_smoke._window == {"lead": 16, "pad": 0.08}


def test_capture_fails_after_its_tries(session):
    session([[_event(COPY)]] * chip_smoke.PROFILE_TRIES)
    with pytest.raises(RuntimeError, match="dropped a sentinel"):
        chip_smoke.capture(lambda: None, "cpu")


def test_capture_fails_on_records_outside_the_sentinels(session):
    early = [_event(FILL, 0, 1) for _ in range(5)]
    session([early + _full()[1:]])
    with pytest.raises(RuntimeError, match="outside its sentinels"):
        chip_smoke.capture(lambda: None, "cpu")


def test_profiled_counts_busy_time_between_the_sentinels(session):
    session([_full()])
    _, _, busy, events = chip_smoke.profiled(lambda: None, "cpu")
    assert busy == 5 and len(events) == 2


def test_profiled_fails_when_only_the_sentinels_ran(session):
    session([[_event(FILL, 0, 1), _event(SENTINEL, 2, 3),
              _event("FileSourceScanExec[parquet]", 3, 10),
              _event(SENTINEL, 10, 11)]])
    with pytest.raises(RuntimeError, match="no device activity"):
        chip_smoke.profiled(lambda: None, "cpu")
