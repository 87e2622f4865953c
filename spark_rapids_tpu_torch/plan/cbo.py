"""Cost-based optimizer.

Port of ``spark_rapids_tpu/plan/cbo.py`` (reference:
CostBasedOptimizer.scala, off by default, ``spark.rapids.sql.optimizer.
enabled``): after tagging, each node that may run on the device gets a
score, its estimated rows over a per-operator speedup plus a fixed
overhead and the rows that cross from a child on the CPU; a node whose
device estimate is not below its CPU estimate (its rows) is tagged back to
the CPU, where it runs as a fallback island. Its only effect is to move
operators to the CPU.

The speedups, the per-row transition cost and the per-operator overhead
are the JAX package's, unchanged, so that one conf gives one tree in both
packages. They are not this card's numbers: nothing here has been measured
on the H100, and a calibration for it is open work.
"""

from __future__ import annotations

from typing import Dict, Optional

from ..config import CBO_ENABLED, RapidsTpuConf  # noqa: F401 (re-export)
from . import logical as L
from .overrides import PlanMeta

DEFAULT_SPEEDUP = 1.0
#: per-operator device speedup scores (the JAX package's)
OP_SPEEDUP: Dict[str, float] = {
    "Scan": 1.0,
    "Project": 2.5,
    "Filter": 2.5,
    "Aggregate": 1.5,
    "Join": 1.5,
    "Sort": 1.5,
    "Window": 1.5,
    "Limit": 1.0,
    "Union": 1.0,
    "Expand": 1.0,
    "Sample": 1.0,
    "Range": 1.5,
}

#: cost to move one row across the CPU/device boundary, in CPU row units
TRANSITION_COST_PER_ROW = 0.6

#: fixed cost of one device operator, in CPU row units: tiny inputs stay
#: on the CPU
KERNEL_OVERHEAD_ROWS = 5000.0


class CostBasedOptimizer:
    """Walks a tagged meta tree and tags back to the CPU the nodes whose
    device estimate does not beat their CPU estimate."""

    def __init__(self, conf: Optional[RapidsTpuConf] = None,
                 default_rows: float = 1e6):
        self.conf = conf or RapidsTpuConf()
        self.default_rows = default_rows

    def estimated_rows(self, node: L.LogicalPlan) -> float:
        if isinstance(node, L.LogicalScan):
            if node.data is not None:
                return float(node.data.num_rows)
            src = node.source
            if src is not None and hasattr(src, "files"):
                return float(len(src.files)) * 1e6
            return self.default_rows
        if isinstance(node, L.LogicalRange):
            return float(max(0, (node.end - node.start) // (node.step or 1)))
        if isinstance(node, L.LogicalFilter):
            return 0.5 * self.estimated_rows(node.children[0])
        if isinstance(node, L.LogicalAggregate):
            return 0.1 * self.estimated_rows(node.children[0])
        if isinstance(node, L.LogicalLimit):
            return float(node.limit)
        if isinstance(node, L.LogicalJoin):
            return max(self.estimated_rows(c) for c in node.children)
        if node.children:
            return sum(self.estimated_rows(c) for c in node.children)
        return self.default_rows

    def optimize(self, meta: PlanMeta) -> None:
        """The pass between tagging and conversion; the reason strings are
        the JAX package's word for word, so explain compares."""
        for c in meta.children:
            self.optimize(c)
        if not meta.can_run_on_tpu:
            return
        rows = self.estimated_rows(meta.node)
        speedup = OP_SPEEDUP.get(meta.node.name, DEFAULT_SPEEDUP)
        cpu_time = rows
        tpu_time = rows / speedup + KERNEL_OVERHEAD_ROWS
        # the transition from a child on the CPU; the one to a parent on
        # the CPU is left out, as in the JAX package
        boundary_rows = sum(self.estimated_rows(c.node)
                            for c in meta.children if not c.can_run_on_tpu)
        tpu_time += boundary_rows * TRANSITION_COST_PER_ROW
        if tpu_time >= cpu_time:
            meta.will_not_work(
                f"cost-based: est TPU time {tpu_time:.0f} >= CPU "
                f"{cpu_time:.0f} (rows={rows:.0f}, speedup={speedup})")
