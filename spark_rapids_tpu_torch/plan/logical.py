"""Logical plan nodes and the DataFrame builder API.

Port of ``spark_rapids_tpu/plan/logical.py``: a tree of operator nodes
carrying unbound expression trees, the point where the planner
(``plan/overrides.py``) wraps, tags and converts them to the port's
physical operators.

A scan of an Arrow table declares the table's Arrow schema, string columns
64 bytes wide, as the JAX package's ``table()`` does.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import pyarrow as pa

from ..batch import Field as SField, Schema, schema_from_arrow
from ..exec.join import JoinType
from ..exec.sort import SortOrder
from ..expressions.base import Alias, Expression, col


@dataclass
class LogicalPlan:
    children: Tuple["LogicalPlan", ...] = ()

    @property
    def name(self) -> str:
        return type(self).__name__.replace("Logical", "")

    def schema(self) -> Schema:
        raise NotImplementedError(type(self).__name__)

    def tree_string(self, indent=0) -> str:
        s = "  " * indent + self.name + "\n"
        for c in self.children:
            s += c.tree_string(indent + 1)
        return s


@dataclass
class LogicalScan(LogicalPlan):
    """In-memory or file-backed source."""

    data: Optional[pa.Table] = None
    _schema: Optional[Schema] = None
    source: Optional[object] = None    # io-layer FileSource
    num_slices: int = 1
    batch_rows: Optional[int] = None   # scan batch granularity

    def schema(self) -> Schema:
        if self._schema is None:
            self._schema = schema_from_arrow(self.data.schema)
        return self._schema


@dataclass
class LogicalRange(LogicalPlan):
    start: int = 0
    end: int = 0
    step: int = 1

    def schema(self) -> Schema:
        from .. import types as T
        return Schema([SField("id", T.INT64, False)])


@dataclass
class LogicalProject(LogicalPlan):
    exprs: Sequence[Expression] = ()

    def schema(self) -> Schema:
        from ..exec.basic import bind_all, schema_of
        return schema_of(bind_all(self.exprs, self.children[0].schema()))


@dataclass
class LogicalFilter(LogicalPlan):
    condition: Expression = None

    def schema(self) -> Schema:
        return self.children[0].schema()


@dataclass
class LogicalAggregate(LogicalPlan):
    group_exprs: Sequence[Expression] = ()
    agg_exprs: Sequence[Expression] = ()   # AggregateFunction or Alias thereof

    def schema(self) -> Schema:
        from ..exec.basic import bind_all, output_name
        child_schema = self.children[0].schema()
        gs = bind_all(self.group_exprs, child_schema)
        fields = [SField(output_name(e, i), e.dtype, e.nullable)
                  for i, e in enumerate(gs)]
        for e in self.agg_exprs:
            a = e.child if isinstance(e, Alias) else e
            name = e.name if isinstance(e, Alias) else type(a).__name__.lower()
            b = a.bind(child_schema)
            fields.append(SField(name, b.dtype, b.nullable))
        return Schema(fields)


@dataclass
class LogicalJoin(LogicalPlan):
    left_keys: Sequence[Expression] = ()
    right_keys: Sequence[Expression] = ()
    join_type: JoinType = JoinType.INNER
    condition: Optional[Expression] = None

    def schema(self) -> Schema:
        l, r = self.children[0].schema(), self.children[1].schema()
        if self.join_type in (JoinType.LEFT_SEMI, JoinType.LEFT_ANTI):
            return l
        if self.join_type is JoinType.EXISTENCE:
            from .. import types as T
            return Schema(list(l.fields)
                          + [SField("exists", T.BOOLEAN, False)])
        ln = self.join_type in (JoinType.RIGHT_OUTER, JoinType.FULL_OUTER)
        rn = self.join_type in (JoinType.LEFT_OUTER, JoinType.FULL_OUTER)
        return Schema(
            [SField(f.name, f.dtype, f.nullable or ln) for f in l]
            + [SField(f.name, f.dtype, f.nullable or rn) for f in r])


@dataclass
class LogicalSort(LogicalPlan):
    orders: Sequence[SortOrder] = ()
    global_sort: bool = True

    def schema(self) -> Schema:
        return self.children[0].schema()


@dataclass
class LogicalLimit(LogicalPlan):
    limit: int = 0

    def schema(self) -> Schema:
        return self.children[0].schema()


@dataclass
class LogicalUnion(LogicalPlan):
    def schema(self) -> Schema:
        return self.children[0].schema()


@dataclass
class LogicalExpand(LogicalPlan):
    projections: Sequence[Sequence[Expression]] = ()

    def schema(self) -> Schema:
        from ..exec.basic import bind_all, schema_of
        return schema_of(bind_all(self.projections[0],
                                  self.children[0].schema()))


@dataclass
class LogicalWindow(LogicalPlan):
    window_exprs: Sequence[Expression] = ()   # WindowExpression or Alias

    def schema(self) -> Schema:
        child_schema = self.children[0].schema()
        fields = list(child_schema.fields)
        for i, e in enumerate(self.window_exprs):
            w = e.child if isinstance(e, Alias) else e
            name = e.name if isinstance(e, Alias) else f"window{i}"
            b = w.bind(child_schema)
            fields.append(SField(name, b.dtype, b.nullable))
        return Schema(fields)


@dataclass
class LogicalSample(LogicalPlan):
    fraction: float = 0.1
    seed: int = 0

    def schema(self) -> Schema:
        return self.children[0].schema()


@dataclass
class LogicalGenerate(LogicalPlan):
    """Lateral view: explode/posexplode of an array or map expression.
    Arrays yield one element column; maps yield Spark's (key, value)
    column pair."""

    generator: Expression = None
    outer: bool = False
    pos: bool = False
    elem_name: str = "col"
    pos_name: str = "pos"
    value_name: str = "value"    # maps only

    def schema(self) -> Schema:
        from .. import types as T
        from ..types import TypeKind
        child_schema = self.children[0].schema()
        g = self.generator.bind(child_schema)
        if g.dtype.kind not in (TypeKind.ARRAY, TypeKind.MAP):
            raise TypeError(f"explode expects an array or map generator, "
                            f"got {g.dtype}")
        fields = list(child_schema.fields)
        if self.pos:
            fields.append(SField(self.pos_name, T.INT32, self.outer))
        if g.dtype.kind is TypeKind.MAP:
            key_t, val_t = g.dtype.children
            fields.append(SField(self.elem_name, key_t, self.outer))
            fields.append(SField(self.value_name, val_t, self.outer))
        else:
            fields.append(SField(self.elem_name, g.dtype.children[0],
                                 self.outer))
        return Schema(fields)


# ---------------------------------------------------------------------------
# DataFrame builder (the pyspark.sql.DataFrame shape, minus Spark)
# ---------------------------------------------------------------------------

class DataFrame:
    def __init__(self, plan: LogicalPlan):
        self.plan = plan

    def select(self, *exprs) -> "DataFrame":
        exprs = [col(e) if isinstance(e, str) else e for e in exprs]
        return DataFrame(LogicalProject((self.plan,), exprs))

    def where(self, condition: Expression) -> "DataFrame":
        return DataFrame(LogicalFilter((self.plan,), condition))

    filter = where

    def group_by(self, *keys):
        keys = [col(k) if isinstance(k, str) else k for k in keys]
        return GroupedData(self.plan, keys)

    def agg(self, *aggs) -> "DataFrame":
        return GroupedData(self.plan, []).agg(*aggs)

    def join(self, other: "DataFrame", left_keys, right_keys,
             how: JoinType = JoinType.INNER,
             condition: Optional[Expression] = None) -> "DataFrame":
        lk = [col(k) if isinstance(k, str) else k for k in left_keys]
        rk = [col(k) if isinstance(k, str) else k for k in right_keys]
        return DataFrame(LogicalJoin((self.plan, other.plan), lk, rk, how,
                                     condition))

    def order_by(self, *orders) -> "DataFrame":
        from ..exec.sort import asc
        os_ = [o if isinstance(o, SortOrder)
               else asc(col(o) if isinstance(o, str) else o) for o in orders]
        return DataFrame(LogicalSort((self.plan,), os_))

    def limit(self, n: int) -> "DataFrame":
        return DataFrame(LogicalLimit((self.plan,), n))

    def union(self, other: "DataFrame") -> "DataFrame":
        return DataFrame(LogicalUnion((self.plan, other.plan)))

    def sample(self, fraction: float, seed: int = 0) -> "DataFrame":
        return DataFrame(LogicalSample((self.plan,), fraction, seed))

    def explode(self, expr, alias: str = "col", outer: bool = False,
                pos: bool = False, pos_alias: str = "pos",
                value_alias: str = "value") -> "DataFrame":
        """LATERAL VIEW [OUTER] explode/posexplode(expr) AS alias. An
        array generator yields one ``alias`` column; a map generator
        yields (alias, value_alias), which Spark names (key, value)."""
        e = col(expr) if isinstance(expr, str) else expr
        if alias == "col":
            from ..types import TypeKind
            try:
                if e.bind(self.plan.schema()).dtype.kind is TypeKind.MAP:
                    alias = "key"
            except Exception:
                pass
        df = DataFrame(LogicalGenerate((self.plan,), e, outer, pos,
                                       alias, pos_alias, value_alias))
        df.plan.schema()    # validate the generator type eagerly
        return df

    def window(self, *window_exprs) -> "DataFrame":
        """Append window-function columns (``select(fn.over(...))``);
        the expressions of one call share one partition and order spec."""
        return DataFrame(LogicalWindow((self.plan,), list(window_exprs)))

    def schema(self) -> Schema:
        return self.plan.schema()


class GroupedData:
    def __init__(self, plan: LogicalPlan, keys: List[Expression]):
        self.plan = plan
        self.keys = keys

    def agg(self, *aggs) -> DataFrame:
        return DataFrame(LogicalAggregate((self.plan,), self.keys, list(aggs)))


def table(data: pa.Table, num_slices: int = 1,
          batch_rows: Optional[int] = None) -> DataFrame:
    return DataFrame(LogicalScan((), data=data, num_slices=num_slices,
                                 batch_rows=batch_rows))


def range_(start: int, end: int, step: int = 1) -> DataFrame:
    return DataFrame(LogicalRange((), start, end, step))
