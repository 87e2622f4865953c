"""Planner: logical plans, type gating, replacement rules, the Session.

Port of the device side of ``spark_rapids_tpu/plan``: the DataFrame API
(``logical.py``), type signatures (``typesig.py``), tagging, conversion and
explain (``overrides.py``) and the Session (``session.py``). The CPU side
(the row interpreter and its fallback islands, the cost-based optimizer)
is the next slice of ROADMAP item 5: a node that tagging refuses raises
``NotOnDevice`` here.
"""

from .logical import (DataFrame, LogicalAggregate, LogicalFilter,
                      LogicalJoin, LogicalLimit, LogicalPlan, LogicalProject,
                      LogicalRange, LogicalScan, LogicalSort, LogicalUnion,
                      range_, table)
from .overrides import (ExplainMode, NotOnDevice, Overrides, PlanMeta,
                        plan_query)
from .session import Session

__all__ = [n for n in dir() if not n.startswith("_")]
