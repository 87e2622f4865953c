"""Planner: logical plans, type gating, replacement rules, the Session.

Port of ``spark_rapids_tpu/plan``: the DataFrame API (``logical.py``),
type signatures (``typesig.py``), tagging, conversion, CPU fallback
islands and explain (``overrides.py``), the row interpreter
(``interpreter.py``), the cost-based optimizer (``cbo.py``) and the
Session (``session.py``). The plan and result caches, work sharing and
cost-fed placement come with ROADMAP item 8.
"""

from .logical import (DataFrame, LogicalAggregate, LogicalFilter,
                      LogicalJoin, LogicalLimit, LogicalPlan, LogicalProject,
                      LogicalRange, LogicalScan, LogicalSort, LogicalUnion,
                      range_, table)
from .interpreter import Interpreter
from .overrides import (CpuFallbackExec, ExplainMode, Overrides, PlanMeta,
                        plan_query)
from .session import Session

__all__ = [n for n in dir() if not n.startswith("_")]
