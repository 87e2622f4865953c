"""Adaptive execution at the exchanges: its decisions, counted and tagged.

Port of the runtime half of ``spark_rapids_tpu/plan/adaptive.py``. After a
shuffle exchange materializes, its measured row counts drive three
decisions: runs of thin partitions coalesce (``shuffle/exchange.py``
``_coalesce_groups`` and ``coordinate_join_reads``), a skewed stream
partition of a co-partitioned join splits into piece ranges with its build
partition replicated, and a shuffled hash join whose build side measures
small switches to a broadcast at run time (``exec/join.py``). Every
decision goes through ``record_decision``, which counts the kind's metric
and tags the reason in a bounded process-wide ring; ``reason_mark`` and
``reasons(since=mark)`` read back what one query decided. The reason texts
are the JAX package's, word for word, so the two packages' decision lists
compare as they stand.

Not ported here: cost-fed planning (``advise`` and the observed-cost
store, with its ``costFed`` and ``explore`` kinds and counters), which
waits for the plan cache's fingerprint, and the zero-width
``adaptive.<kind>`` trace span of each decision, which waits for
``trace.py`` (both ROADMAP Queue 1 item 8).
"""

from __future__ import annotations

import threading
from typing import Dict, List


class AdaptiveMetrics:
    """Process-wide decision counters; a caller reports the difference of
    two snapshots."""

    def __init__(self):
        self._lock = threading.Lock()
        self.replans = 0
        self.coalesced_partitions = 0
        self.skew_splits = 0
        self.broadcast_switches = 0

    def note(self, name: str, n: int = 1) -> None:
        with self._lock:
            setattr(self, name, getattr(self, name) + n)

    def snapshot(self) -> Dict[str, int]:
        with self._lock:
            return {
                "replanCount": self.replans,
                "coalescedPartitionCount": self.coalesced_partitions,
                "skewSplitCount": self.skew_splits,
                "broadcastSwitchCount": self.broadcast_switches,
            }


_METRICS = AdaptiveMetrics()


def metrics() -> AdaptiveMetrics:
    return _METRICS


_REASON_LOCK = threading.Lock()
_REASONS: Dict[str, int] = {}     # reason -> sequence number of last record
_REASON_SEQ = 0
_REASON_CAP = 256

#: decision kind -> AdaptiveMetrics counter attribute
DECISION_KINDS: Dict[str, str] = {
    "coalesce": "coalesced_partitions",
    "skewSplit": "skew_splits",
    "broadcastSwitch": "broadcast_switches",
}



def record_decision(kind: str, reason: str, n: int = 1) -> None:
    """The one way an adaptive decision is taken: count the kind's metric
    (``n`` = partitions coalesced, splits made, or 1) and tag the reason,
    ``"<kind>: <reason>"``, in the process ring."""
    global _REASON_SEQ
    _METRICS.note(DECISION_KINDS[kind], n)
    _METRICS.note("replans")
    with _REASON_LOCK:
        _REASON_SEQ += 1
        _REASONS[f"{kind}: {reason}"] = _REASON_SEQ
        if len(_REASONS) > _REASON_CAP:
            del _REASONS[min(_REASONS, key=_REASONS.get)]


def reason_mark() -> int:
    """Sequence watermark: only decisions recorded after the mark show in
    ``reasons(since=mark)``. A repeat of an earlier reason re-sequences it
    (the latest wins)."""
    with _REASON_LOCK:
        return _REASON_SEQ


def reasons(since: int = 0) -> List[str]:
    """The decisions recorded after ``since``, oldest first."""
    with _REASON_LOCK:
        return sorted((r for r, s in _REASONS.items() if s > since),
                      key=lambda r: _REASONS[r])

