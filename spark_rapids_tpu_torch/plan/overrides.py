"""Replacement rules, tagging, conversion, explain.

Port of ``spark_rapids_tpu/plan/overrides.py`` (reference:
GpuOverrides.scala's rule registry, RapidsMeta.scala's tagging with
willNotWork reasons, GpuTransitionOverrides' exchange and coalesce
insertion). The flow is the JAX package's: wrap the logical plan in
``PlanMeta`` nodes, tag each against the conf switches, the type
signatures and the dtype hazards, then convert the tagged tree to the
port's operators, inserting hash exchanges, broadcasts and implicit key
casts, pruning partitions dynamically, and inserting coalesce transitions
where an operator declares a batch-size goal.

A node that tagging refuses (or that the cost-based optimizer moves, when
it is on) becomes a ``CpuFallbackExec`` island: it runs on the row
interpreter (``plan/interpreter.py``), its device children cross to it
through Arrow and its result goes back to the device the Session names.
Only tagging makes an island, and each shows in explain (``!`` lines with
their reasons), in the Session's ``fell_back()`` and in
``executed_exec_names()``; a device failure (a kernel that does not build
or launch, an OOM past the retry loop, an ANSI error) raises and is never
sent to the interpreter.

Reason strings are the JAX package's word for word, so that explain output
compares between the packages. A window average over a decimal
(``exec/window.py`` ``window_agg_unsupported_reason``) is an island with
the JAX aggregate's reason, where the JAX planner, whose tagging walks
past a window's aggregate node, lets it through to a device double read
as a decimal.
"""

from __future__ import annotations

import copy
import enum
import time
from dataclasses import dataclass
from typing import Dict, List, Optional

import pyarrow as pa
import torch

from ..batch import Schema, empty_batch, from_arrow
from ..config import (AGG_MAX_RESULT_ROWS, BROADCAST_LIMIT,
                      BROADCAST_THRESHOLD, CAST_STRING_TO_FLOAT, CBO_ENABLED,
                      COALESCE_MAX_ROWS, DPP_ENABLED, JOIN_MAX_BUILD_ROWS,
                      PARQUET_ENABLED, REGEXP_ENABLED, SHUFFLE_PARTITIONS,
                      WINDOW_BATCH_ROWS, RapidsTpuConf)
from ..exec import (BroadcastNestedLoopJoinExec, ExpandExec, FilterExec,
                    GlobalLimitExec, HashAggregateExec, HashJoinExec,
                    InMemoryScanExec, ProjectExec, RangeExec, SampleExec,
                    SortExec, UnionExec)
from ..exec.aggregate import AggregateMode
from ..exec.base import Exec, LeafExec, Metric
from ..exec.base import collect as collect_exec
from ..exec.join import JoinType
from ..expressions import base as EB
from ..expressions.base import Alias, EvalContext, Expression
from ..expressions.window import (WindowAgg, WindowExpression,
                                  unsupported_frame_reason)
from ..memory.catalog import BufferCatalog
from ..shuffle import (BroadcastExchangeExec, HashPartitioning,
                       SinglePartitioning)
from . import logical as L
from . import typesig as TS
from .typesig import TypeSig


class ExplainMode(enum.Enum):
    NONE = "NONE"
    ALL = "ALL"
    NOT_ON_TPU = "NOT_ON_TPU"


# ---------------------------------------------------------------------------
# Expression rules
# ---------------------------------------------------------------------------

@dataclass
class ExprRule:
    cls_name: str
    sig: TypeSig
    incompat: bool = False
    note: str = ""
    #: per-argument signatures; None checks every child against ``sig``
    params: Optional[TS.Params] = None

    @property
    def conf_key(self) -> str:
        return f"spark.rapids.tpu.sql.expression.{self.cls_name}"


def _expr_rules() -> Dict[str, ExprRule]:
    """The JAX package's rules, whole: they are keyed by class name, so
    the rules of expressions the port does not have yet wait unused."""
    rules = {}

    def r(name, sig, incompat=False, note="", params=None):
        rules[name] = ExprRule(name, sig, incompat, note, params)

    # passthroughs admit every type that has a device layout
    for n in ("BoundReference", "UnresolvedColumn", "Literal", "Alias"):
        r(n, TS.ALL_BASIC + TS.DECIMAL_128 + TS.ARRAY + TS.MAP + TS.STRUCT)
    for n in ("Add", "Subtract", "Multiply", "UnaryMinus", "Abs"):
        r(n, TS.NUMERIC)
    for n in ("Divide", "IntegralDivide", "Remainder", "Pmod"):
        r(n, TS.NUMERIC)
    for n in ("BitwiseOp", "BitwiseNot"):
        r(n, TS.INTEGRAL)
    for n in ("EqualTo", "EqualNullSafe", "LessThan", "LessThanOrEqual",
              "GreaterThan", "GreaterThanOrEqual"):
        r(n, TS.ALL_BASIC + TS.DECIMAL_128)
    r("In", TS.ALL_BASIC)
    for n in ("Not", "And", "Or"):
        r(n, TS.BOOLEAN + TS.ALL_BASIC)
    # validity-only kernels are type-agnostic: every device layout passes
    for n in ("IsNull", "IsNotNull"):
        r(n, TS.ALL_BASIC + TS.DECIMAL_128 + TS.ARRAY + TS.MAP + TS.STRUCT)
    r("IsNaN", TS.ALL_BASIC)
    r("If", TS.ALL_BASIC,
      params=TS.params(TS.p("predicate", TS.BOOLEAN),
                       TS.p("trueValue", TS.ALL_BASIC),
                       TS.p("falseValue", TS.ALL_BASIC)))
    for n in ("CaseWhen", "Coalesce", "LeastGreatest"):
        r(n, TS.ALL_BASIC)
    r("Cast", TS.ALL_BASIC)
    for n in ("UnaryMath", "Pow", "Atan2", "Signum"):
        r(n, TS.NUMERIC, incompat=True,
          note="XLA float transcendentals differ from JVM in final ULPs")
    r("Round", TS.NUMERIC)
    r("FloorCeil", TS.NUMERIC)
    r("Murmur3Hash", TS.ALL_BASIC)
    # strings
    for n in ("Upper", "Lower"):
        r(n, TS.ALL_BASIC, incompat=True,
          note="simple case mapping across ASCII + 2/3-byte planes "
               "(Latin, Greek, Cyrillic, Georgian, Cherokee, full-width); "
               "length-changing (ß→SS) and locale-special mappings pass "
               "through")
    for n in ("Length", "Concat",
              "StringPredicate", "StringTrim", "InitCap",
              "Reverse", "Ascii", "OctetLength",
              "Levenshtein", "Soundex"):
        r(n, TS.ALL_BASIC)
    r("Substring", TS.ALL_BASIC,
      params=TS.params(TS.p("str", TS.STRING), TS.p("pos", TS.INTEGRAL),
                       TS.p("len", TS.INTEGRAL)))
    r("StringLocate", TS.ALL_BASIC,
      params=TS.params(TS.p("str", TS.STRING), TS.p("substr", TS.STRING),
                       repeat=TS.p("start", TS.INTEGRAL)))
    r("StringPad", TS.ALL_BASIC,
      params=TS.params(TS.p("str", TS.STRING), TS.p("len", TS.INTEGRAL),
                       TS.p("pad", TS.STRING, lit=True)))
    r("StringRepeat", TS.ALL_BASIC,
      params=TS.params(TS.p("str", TS.STRING),
                       TS.p("repeatTimes", TS.INTEGRAL)))
    r("StringReplace", TS.ALL_BASIC,
      params=TS.params(TS.p("src", TS.STRING),
                       TS.p("search", TS.STRING, lit=True),
                       TS.p("replace", TS.STRING, lit=True)))
    r("Translate", TS.ALL_BASIC,
      params=TS.params(TS.p("input", TS.STRING)))
    r("FormatNumber", TS.ALL_BASIC,
      params=TS.params(TS.p("x", TS.NUMERIC)))
    r("Chr", TS.ALL_BASIC,
      params=TS.params(TS.p("input", TS.INTEGRAL)))
    # datetime
    for n in ("ExtractDatePart", "DateDiff",
              "LastDay", "UnixTimestampConv", "DateFormat", "FromUnixtime",
              "TruncDateTime", "MonthsBetween", "NextDay"):
        r(n, TS.DATETIME + TS.INTEGRAL)
    r("DateAddSub", TS.DATETIME + TS.INTEGRAL,
      params=TS.params(TS.p("startDate", TS.DATETIME),
                       TS.p("days", TS.INTEGRAL)))
    r("AddMonths", TS.DATETIME + TS.INTEGRAL,
      params=TS.params(TS.p("startDate", TS.DATETIME),
                       TS.p("numMonths", TS.INTEGRAL)))
    r("ParseDateTime", TS.STRING)
    r("InterleaveBits", TS.NUMERIC + TS.DATETIME + TS.BOOLEAN)
    r("RLike", TS.ALL_BASIC,
      note="DFA subset; unsupported constructs raise at plan build")
    r("Like", TS.ALL_BASIC)
    for n in ("RegexpExtract", "RegexpReplace", "StringSplit"):
        r(n, TS.ALL_BASIC + TS.ARRAY)
    # window
    for n in ("WindowExpression", "RowNumber", "Rank", "NTile", "LagLead",
              "WindowAgg", "NthValue", "PercentRank", "CumeDist"):
        r(n, TS.ALL_BASIC)
    # aggregates
    r("Count", TS.ALL_BASIC + TS.DECIMAL_128 + TS.ARRAY + TS.MAP
      + TS.STRUCT)
    for n in ("Min", "Max"):
        r(n, TS.ALL_BASIC + TS.DECIMAL_128)
    for n in ("First", "Last"):
        r(n, TS.ALL_BASIC + TS.DECIMAL_128 + TS.ARRAY + TS.MAP)
    r("Sum", TS.NUMERIC + TS.DECIMAL_128, incompat=False)
    r("Percentile", TS.NUMERIC + TS.DATETIME)
    r("ApproxPercentile", TS.NUMERIC + TS.DATETIME,
      note="answered exactly; sorted segments make exact as cheap as the sketch")
    for n in ("CollectList", "CollectSet"):
        r(n, TS.NUMERIC + TS.DATETIME + TS.BOOLEAN + TS.STRING)
    r("Average", TS.NUMERIC,
      note="float sums reassociate; parity kept by f64 accumulation")
    for n in ("StddevSamp", "StddevPop", "VarianceSamp", "VariancePop"):
        r(n, TS.FP)
    # collections and higher-order functions
    r("Size", TS.ALL_BASIC + TS.ARRAY + TS.MAP)
    for n in ("CreateArray", "ArrayContains",
              "SortArray", "ArrayMin", "ArrayMax",
              "LambdaVariable",
              "TransformArray", "FilterArray", "ExistsArray", "ForallArray",
              "AggregateArray"):
        r(n, TS.ALL_BASIC + TS.ARRAY)
    r("ElementAt", TS.ALL_BASIC + TS.ARRAY + TS.MAP,
      params=TS.params(TS.p("collection",
                            TS.ARRAY + TS.MAP + TS.ALL_BASIC,
                            outer=TS.ARRAY + TS.MAP),
                       TS.p("key", TS.ALL_BASIC)))
    r("GetArrayItem", TS.ALL_BASIC + TS.ARRAY,
      params=TS.params(TS.p("array", TS.ARRAY + TS.ALL_BASIC,
                            outer=TS.ARRAY),
                       TS.p("ordinal", TS.INTEGRAL)))
    for n in ("CreateStruct", "GetStructField"):
        r(n, TS.ALL_BASIC + TS.ARRAY + TS.MAP + TS.STRUCT
          + TS.DECIMAL_128)
    for n in ("MapKeys", "MapValues", "MapContainsKey",
              "MapFromArrays"):
        r(n, TS.ALL_BASIC + TS.ARRAY + TS.MAP)
    r("GetMapValue", TS.ALL_BASIC + TS.MAP,
      params=TS.params(TS.p("map", TS.MAP + TS.ALL_BASIC,
                            outer=TS.MAP),
                       TS.p("key", TS.ALL_BASIC)))
    r("Shift", TS.INTEGRAL,
      params=TS.params(TS.p("value", TS.INTEGRAL),
                       TS.p("amount", TS.INTEGRAL)))
    r("XxHash64", TS.ALL_BASIC)
    r("ConcatWs", TS.STRING, note="literal separator",
      params=TS.params(TS.p("sep", TS.STRING, lit=True),
                       repeat=TS.p("str", TS.STRING)))
    r("SubstringIndex", TS.STRING + TS.INTEGRAL,
      note="literal delimiter and count",
      params=TS.params(TS.p("str", TS.STRING),
                       TS.p("delim", TS.STRING, lit=True),
                       TS.p("count", TS.INTEGRAL, lit=True)))
    r("Hex", TS.INTEGRAL + TS.STRING)
    r("Bin", TS.INTEGRAL)
    r("Conv", TS.STRING + TS.INTEGRAL, note="literal bases 2..36")
    for n in ("ArrayDistinct", "ArrayUnion", "ArrayIntersect",
              "ArrayExcept", "ArraysOverlap", "ArrayRemove",
              "ArrayPosition", "ArraySlice"):
        r(n, TS.ALL_BASIC + TS.ARRAY)
    r("UTCTimestampConv", TS.DATETIME,
      note="literal zone id; 1900-2100 transition table (reference: "
           "GpuTimeZoneDB)")
    r("Hypot", TS.FP + TS.NUMERIC)
    r("ReplicateRows", TS.ALL_BASIC + TS.ARRAY)
    r("JsonTuple", TS.STRING,
      note="lowers to repeated get_json_object path extraction (the "
           "reference device impl does the same)")
    r("PivotFirst", TS.NUMERIC + TS.DATETIME + TS.BOOLEAN)
    r("NaNvl", TS.FP)
    r("Rand", TS.NUMERIC, incompat=True,
      note="counter-based threefry sequence, not Spark's XorShiftRandom; "
           "distribution matches and values are retry-deterministic")
    r("RaiseError", TS.ALL_BASIC)
    r("FindInSet", TS.STRING)
    r("Empty2Null", TS.STRING)
    r("StringToMap", TS.STRING + TS.MAP,
      note="literal single-byte delimiters; NULL map values render as "
           "empty strings through map_values (no per-element validity)")
    r("ArrayRepeat", TS.ALL_BASIC + TS.ARRAY,
      note="literal count (static element budget)",
      params=TS.params(TS.p("value", TS.ALL_BASIC),
                       TS.p("count", TS.INTEGRAL, lit=True)))
    r("Sequence", TS.INTEGRAL + TS.ARRAY,
      note="rows beyond the element budget fail loud (CAPACITY_sequence)",
      params=TS.params(repeat=TS.p("bound", TS.INTEGRAL)))
    # (TS.ARRAY alone in the JAX rule, whose check types the array of
    # arrays: the port's Flatten over array(...) has the arrays as its
    # children)
    r("Flatten", TS.ALL_BASIC + TS.ARRAY,
      note="flatten(array(...)) only; nested-array columns fall back")
    for n in ("TransformKeys", "TransformValues", "MapFilter"):
        r(n, TS.ALL_BASIC + TS.ARRAY + TS.MAP)
    r("ZipWith", TS.ALL_BASIC + TS.ARRAY,
      note="body must be provably non-null over the shorter side's padding")
    r("GetJsonObject", TS.STRING,
      note="literal $.a.b[i] paths; \\uXXXX escapes null the row",
      params=TS.params(TS.p("json", TS.STRING),
                       TS.p("path", TS.STRING, lit=True)))
    r("Logarithm", TS.NUMERIC,
      params=TS.params(TS.p("base", TS.NUMERIC), TS.p("x", TS.NUMERIC)))
    r("JsonToStructs", TS.STRING + TS.ALL_BASIC,
      note="device via field-projection rewrite to get_json_object")
    return rules


EXPR_RULES = _expr_rules()


# ---------------------------------------------------------------------------
# Meta wrappers (RapidsMeta analogue)
# ---------------------------------------------------------------------------

_HOST_ONLY_PREFIX = "input data requires host execution: "


def scan_host_only_reason(tbl) -> Optional[str]:
    """Data-dependent device gate for in-memory scans: arrays carrying NULL
    elements have no device layout. Tagged at plan time, so the reason is
    recorded instead of a type error at the upload."""
    for i, f in enumerate(tbl.schema):
        if not (pa.types.is_list(f.type) or pa.types.is_large_list(f.type)):
            continue
        for chunk in tbl.column(i).chunks:
            if chunk.values.null_count:
                return (f"{_HOST_ONLY_PREFIX}column {f.name!r} holds "
                        f"arrays with null elements, which are outside "
                        f"the device subset (fixed-budget element "
                        f"matrices are non-null); CPU fallback")
    return None


def propagate_host_only_data(meta: "PlanMeta") -> None:
    """A host-only-data reason on any scan marks the whole meta tree: the
    offending column cannot cross the upload boundary at any later
    operator either."""
    reasons: List[str] = []

    def collect(m: "PlanMeta") -> None:
        reasons.extend(r for r in m.reasons
                       if r.startswith(_HOST_ONLY_PREFIX))
        for c in m.children:
            collect(c)

    def apply(m: "PlanMeta") -> None:
        for r in reasons:
            m.will_not_work(r)
        for c in m.children:
            apply(c)

    collect(meta)
    if reasons:
        apply(meta)


class PlanMeta:
    def __init__(self, node: L.LogicalPlan, conf: RapidsTpuConf):
        self.node = node
        self.conf = conf
        self.children = [PlanMeta(c, conf) for c in node.children]
        self.reasons: List[str] = []

    # ---- tagging ----
    def will_not_work(self, reason: str) -> None:
        if reason not in self.reasons:
            self.reasons.append(reason)

    @property
    def can_run_on_tpu(self) -> bool:
        return not self.reasons

    def tag(self) -> None:
        for c in self.children:
            c.tag()
        if not self.conf.sql_enabled:
            self.will_not_work("spark.rapids.tpu.sql.enabled is false")
            return
        name = self.node.name
        exec_key = f"spark.rapids.tpu.sql.exec.{name}"
        if not self.conf.is_op_enabled(exec_key):
            self.will_not_work(f"{exec_key} is false")
        self._tag_expressions()
        self._tag_types()
        self._tag_node_specifics()

    def _expressions(self) -> List[Expression]:
        n = self.node
        if isinstance(n, L.LogicalProject):
            return list(n.exprs)
        if isinstance(n, L.LogicalFilter):
            return [n.condition]
        if isinstance(n, L.LogicalAggregate):
            return list(n.group_exprs) + list(n.agg_exprs)
        if isinstance(n, L.LogicalJoin):
            return list(n.left_keys) + list(n.right_keys) + (
                [n.condition] if n.condition is not None else [])
        if isinstance(n, L.LogicalSort):
            return [o.child for o in n.orders]
        if isinstance(n, L.LogicalExpand):
            return [e for p in n.projections for e in p]
        if isinstance(n, L.LogicalGenerate):
            return [n.generator]
        if isinstance(n, L.LogicalWindow):
            return list(n.window_exprs)
        return []

    def _tag_expressions(self) -> None:
        for e in self._expressions():
            self._tag_expr_tree(e)

    def _tag_expr_tree(self, e: Expression) -> None:
        name = type(e).__name__
        rule = EXPR_RULES.get(name)
        if rule is None:
            self.will_not_work(f"expression {name} is not supported on TPU")
        else:
            if not self.conf.is_op_enabled(rule.conf_key):
                self.will_not_work(f"{rule.conf_key} is false")
            if rule.incompat and not self.conf.incompatible_ops:
                self.will_not_work(
                    f"expression {name} is incompatible ({rule.note}); "
                    f"set spark.rapids.tpu.sql.incompatibleOps.enabled=true")
        for c in e.children:
            self._tag_expr_tree(c)

    def _tag_node_specifics(self) -> None:
        """Per-node tagging beyond TypeSig (the reference's per-meta
        tagForGpu overrides)."""
        n = self.node
        if isinstance(n, L.LogicalScan) and n.data is not None:
            reason = scan_host_only_reason(n.data)
            if reason is not None:
                self.will_not_work(reason)
        if isinstance(n, L.LogicalScan) and n.source is not None:
            # per-format enables; the port reads Parquet alone
            fmt = getattr(n.source, "format_name", None)
            key = {"parquet": PARQUET_ENABLED.key}.get(fmt)
            if key is not None and not self.conf.get(key):
                self.will_not_work(f"{key} is false")
        if isinstance(n, (L.LogicalSort, L.LogicalJoin, L.LogicalAggregate,
                          L.LogicalWindow)):
            # arrays, maps and structs ride through sort, join, aggregate
            # and window as payload; as keys they have no orderable or
            # hashable encoding on the device
            if isinstance(n, L.LogicalSort):
                keys = [o.child for o in n.orders]
            elif isinstance(n, L.LogicalAggregate):
                keys = list(n.group_exprs)
            elif isinstance(n, L.LogicalWindow):
                keys = []
                for e in n.window_exprs:
                    w = e.child if isinstance(e, Alias) else e
                    if isinstance(w, WindowExpression):
                        keys.extend(w.spec.partition_keys)
                        keys.extend(o.child for o in w.spec.orders)
            else:
                keys = list(n.left_keys) + list(n.right_keys)
            schemas = [c.schema() for c in n.children]
            for k in keys:
                for sch in schemas:
                    try:
                        kd = k.bind(sch).dtype
                    except Exception:
                        continue
                    if kd.is_nested:
                        self.will_not_work(
                            f"{kd} cannot be a sort/join key on device "
                            f"(no scalar ordering/hash encoding)")
                    break
        if isinstance(n, L.LogicalGenerate):
            from ..types import TypeKind
            try:
                g = n.generator.bind(n.children[0].schema())
                if g.dtype.kind not in (TypeKind.ARRAY, TypeKind.MAP):
                    self.will_not_work(
                        f"generator over {g.dtype} is not an array/map")
                else:
                    bad = any(c.is_nested for c in g.dtype.children)
                    # map entries must be scalars; array elements may also
                    # be strings (the 3D byte tensor layout)
                    if g.dtype.kind is TypeKind.MAP:
                        bad = bad or any(c.kind is TypeKind.STRING
                                         for c in g.dtype.children)
                    if bad:
                        self.will_not_work(
                            f"explode of {g.dtype}: no device layout for "
                            f"its element type")
            except Exception as ex:
                self.will_not_work(f"generator does not bind: {ex}")
        if isinstance(n, L.LogicalAggregate):
            # one sort-sensitive aggregate (percentile/collect) per exec:
            # each needs its own value-sorted layout
            raw = [e.child if isinstance(e, Alias) else e
                   for e in n.agg_exprs]
            sensitive = [a for a in raw
                         if getattr(a, "requires_sorted_input", False)]
            if len(sensitive) > 1:
                self.will_not_work(
                    f"{len(sensitive)} sort-sensitive aggregates "
                    f"(percentile/collect) in one aggregation; the device "
                    f"exec supports one value-sorted layout")
        if isinstance(n, L.LogicalWindow):
            self._tag_window(n)
        self._tag_dtype_hazards()

    def _tag_window(self, n: "L.LogicalWindow") -> None:
        """The frame check, the port's window-aggregate check, and the
        capacity gate: the device window needs a whole window partition in
        one batch, so a window without PARTITION BY over more rows than
        the largest batch has no device path (no streaming window, the
        reference's GpuWindowExec.scala:1534,1846): an island with the
        reason, not a cliff at run time."""
        from ..exec.window import window_agg_unsupported_reason
        unpartitioned = False
        schema = n.children[0].schema()
        for e in n.window_exprs:
            w = e.child if isinstance(e, Alias) else e
            if not isinstance(w, WindowExpression):
                continue
            if not w.spec.partition_keys:
                unpartitioned = True
            if isinstance(w.function, WindowAgg):
                reason = unsupported_frame_reason(w.spec.frame, w.spec)
                if reason:
                    self.will_not_work(reason)
                try:
                    agg = w.function.agg.bind(schema)
                except Exception:
                    continue
                reason = window_agg_unsupported_reason(agg)
                if reason:
                    self.will_not_work(reason)
        if unpartitioned:
            est = estimate_rows(n.children[0])
            cap = self.conf.batch_row_capacity
            if est is not None and est > cap:
                self.will_not_work(
                    f"window without PARTITION BY over ~{est} rows "
                    f"needs the whole input in one device batch, "
                    f"above batchRowCapacity={cap}; streaming "
                    f"windows are not implemented")

    # aggregates whose float64 accumulation the JAX package gates behind
    # incompatibleOps (its backend emulates f64 with f32 pairs). The card
    # computes float64 natively; the gate stays, so that one conf gives one
    # tree in both packages (an open question in ROADMAP).
    _F64_HAZARD_AGGS = ("Sum", "Average", "StddevSamp", "StddevPop",
                        "VarianceSamp", "VariancePop")

    def _tag_dtype_hazards(self) -> None:
        """Dtype-dependent gating TypeSig alone cannot express: the checks
        need bound expression types, so bind against the child schema."""
        from ..types import TypeKind
        n = self.node
        if not n.children:
            return
        try:
            child_schema = n.children[0].schema()
        except Exception:
            return
        for e in self._expressions():
            try:
                bound = e.bind(child_schema)
            except Exception:
                continue   # join right-keys etc. bind elsewhere
            self._check_dtype_tree(bound, TypeKind)

    _REGEX_EXPRS = ("RLike", "RegexpExtract", "RegexpReplace",
                    "StringSplit")

    def _check_dtype_tree(self, e: Expression, TypeKind) -> None:
        name = type(e).__name__
        unsupported = getattr(e, "device_unsupported_reason", None)
        reason = unsupported() if unsupported is not None else None
        if reason and getattr(e, "parses_float", False) and \
                self.conf.get(CAST_STRING_TO_FLOAT.key):
            reason = None       # the port's device parse, switched on
        if reason:
            self.will_not_work(reason)
        if name in self._REGEX_EXPRS:
            if not self.conf.get(REGEXP_ENABLED.key):
                self.will_not_work(
                    f"{REGEXP_ENABLED.key} is false (regex master switch)")
        # input-type gating against the expression's TypeSig
        rule = EXPR_RULES.get(name)
        if rule is not None:
            for i, c in enumerate(e.children):
                try:
                    cd = c.dtype
                except Exception:
                    continue
                ps = rule.params.sig_for(i) if rule.params else None
                if ps is not None:
                    r = ps.check(c, cd)
                else:
                    r = rule.sig.supports(cd)
                if r:
                    self.will_not_work(f"{name} input: {r}")
        child = e.children[0] if e.children else None
        if child is not None:
            try:
                kind = child.dtype.kind
            except Exception:
                kind = None
            if name == "Average" and kind is TypeKind.DECIMAL:
                p, s = child.dtype.precision, child.dtype.scale
                self.will_not_work(
                    f"avg over decimal({p},{s}) must return Spark's "
                    f"decimal({min(p + 4, 38)},{min(s + 4, 38)}) with "
                    f"HALF_UP rounding; the device buffer is double")
            if name in self._F64_HAZARD_AGGS and \
                    kind is TypeKind.FLOAT64 and \
                    not self.conf.incompatible_ops:
                self.will_not_work(
                    f"{name} over float64 is incompatible on backends that "
                    f"emulate f64 (f32-pair: ~48-bit mantissa, f32 exponent "
                    f"range — docs/tpu_compat.md); set "
                    f"spark.rapids.tpu.sql.incompatibleOps.enabled=true")
        for c in e.children:
            self._check_dtype_tree(c, TypeKind)

    def _tag_types(self) -> None:
        try:
            schema = self.node.schema()
        except NotImplementedError:
            raise      # a feature the port does not have yet, named
        except Exception as ex:   # unresolvable → planner cannot place it
            self.will_not_work(f"schema resolution failed: {ex}")
            return
        name = self.node.name
        sig = EXEC_SIGS.get(name, TS.ALL_BASIC)
        for f in schema:
            reason = sig.supports(f.dtype)
            if reason:
                self.will_not_work(f"column {f.name}: {reason}")

    # ---- explain ----
    def explain_line(self, mode: ExplainMode = ExplainMode.ALL,
                     indent: int = 0) -> str:
        mark = "*" if self.can_run_on_tpu else "!"
        line = "  " * indent + f"{mark}{self.node.name}"
        if self.reasons and mode is not ExplainMode.NONE:
            line += "  <-- cannot run on TPU because: " + \
                "; ".join(self.reasons)
        return line

    def explain(self, mode: ExplainMode, indent: int = 0) -> str:
        lines = [self.explain_line(mode, indent)]
        for c in self.children:
            lines.append(c.explain(mode, indent + 1))
        return "\n".join(lines)


EXEC_SIGS: Dict[str, TypeSig] = {
    "Scan": TS.ALL_BASIC + TS.ARRAY + TS.MAP + TS.STRUCT + TS.DECIMAL_128,
    "Project": TS.ALL_BASIC + TS.ARRAY + TS.MAP + TS.STRUCT
               + TS.DECIMAL_128,
    "Filter": TS.ALL_BASIC + TS.ARRAY + TS.MAP + TS.STRUCT
              + TS.DECIMAL_128,
    "Aggregate": TS.GROUPABLE + TS.ARRAY + TS.MAP + TS.DECIMAL_128,
    "Join": TS.ALL_BASIC + TS.ARRAY + TS.MAP + TS.STRUCT + TS.DECIMAL_128,
    "Sort": TS.ORDERABLE + TS.ARRAY + TS.MAP + TS.STRUCT + TS.DECIMAL_128,
    "Limit": TS.ALL_BASIC + TS.ARRAY + TS.MAP + TS.STRUCT
             + TS.DECIMAL_128,
    "Union": TS.ALL_BASIC + TS.ARRAY + TS.MAP + TS.STRUCT
             + TS.DECIMAL_128,
    "Range": TS.ALL_BASIC,
    "Expand": TS.ALL_BASIC + TS.ARRAY + TS.MAP + TS.STRUCT,
    "Sample": TS.ALL_BASIC + TS.ARRAY + TS.MAP + TS.STRUCT,
    "Window": TS.ALL_BASIC + TS.STRUCT,
    "Generate": TS.ALL_BASIC + TS.ARRAY + TS.MAP,
}


# ---------------------------------------------------------------------------
# CPU fallback islands
# ---------------------------------------------------------------------------

class CpuFallbackExec(LeafExec):
    """Runs one logical node on the row interpreter. Its device children
    cross to it through Arrow (``collect``); nested islands splice into one
    logical tree, so no device round trip runs between CPU operators (the
    reference's GpuColumnarToRowExec / GpuRowToColumnarExec boundary). The
    result goes back up through ``from_arrow`` onto ``device``, the
    Session's own.

    ``interpret`` records its host time in two metrics: ``collectTime``
    (the device children to Arrow) and ``interpretTime`` (the row loop),
    with ``numInputRows`` beside ``numOutputRows``."""

    def __init__(self, node: L.LogicalPlan, child_execs: List[Exec],
                 device: Optional[torch.device], ansi: bool = False):
        super().__init__()
        self.node = node
        self.child_execs = list(child_execs)
        self.ansi = ansi
        self._device = device
        self._schema = node.schema()
        for m in ("collectTime", "interpretTime", "numInputRows"):
            self.metrics[m] = Metric(m)

    @property
    def name(self) -> str:
        return f"CpuFallback[{self.node.name}]"

    @property
    def output_schema(self) -> Schema:
        return self._schema

    @property
    def device(self) -> torch.device:
        return self._device

    def exec_names(self) -> List[str]:
        return [self.name] + [n for c in self.child_execs
                              for n in c.exec_names()]

    def spliced_logical(self) -> L.LogicalPlan:
        """The island as one logical tree: nested islands splice in, and
        each device child becomes a scan of its collected rows."""
        children = []
        for ce in self.child_execs:
            if isinstance(ce, CpuFallbackExec):
                children.append(ce.spliced_logical())
                continue
            t0 = time.perf_counter_ns()
            tbl = collect_exec(ce)
            self.metrics["collectTime"].add(time.perf_counter_ns() - t0)
            self.metrics["numInputRows"].add(tbl.num_rows)
            children.append(L.LogicalScan((), data=tbl,
                                          _schema=ce.output_schema))
        return _with_children(self.node, children)

    def interpret(self) -> pa.Table:
        """Run the island on the host; its result as an Arrow table."""
        from .interpreter import Interpreter
        logical = self.spliced_logical()
        t0 = time.perf_counter_ns()
        out = Interpreter(ansi=self.ansi).execute(logical)
        self.metrics["interpretTime"].add(time.perf_counter_ns() - t0)
        return out

    def do_execute_partition(self, p: int):
        result = self.interpret()
        if result.num_rows == 0:
            yield empty_batch(self._schema, self._device)
            return
        batch, _ = from_arrow(result, schema=self._schema,
                              device=self._device)
        yield batch

    def close(self) -> None:
        for c in self.child_execs:
            c.close()
        self.do_close()


def _with_children(node: L.LogicalPlan, children) -> L.LogicalPlan:
    n = copy.copy(node)
    n.children = tuple(children)
    return n


# ---------------------------------------------------------------------------
# Conversion and the coalesce transitions
# ---------------------------------------------------------------------------

def insert_coalesce_transitions(plan: Exec, target_bytes: int,
                                max_rows: int = 1 << 22) -> Exec:
    """The post-conversion transition pass (reference:
    GpuTransitionOverrides): wrap a producer in ``CoalesceBatchesExec``
    wherever its consumer declares a coalesce goal the producer does not
    meet, then verify every ``RequireSingleBatch`` goal."""
    from ..exec.coalesce import (CoalesceBatchesExec, RequireSingleBatch,
                                 TargetSize, verify_coalesce_goals)

    # producers that can fragment a partition into many small batches;
    # TargetSize goals only insert a coalesce above these
    fragmenting = (FilterExec, HashJoinExec, BroadcastNestedLoopJoinExec)

    def rewrite(node: Exec) -> Exec:
        if isinstance(node, CpuFallbackExec):
            node.child_execs = [rewrite(c) for c in node.child_execs]
            return node
        new_children = []
        for i, c in enumerate(node.children):
            c = rewrite(c)
            goal = node.coalesce_goal_for_child(i)
            if isinstance(goal, RequireSingleBatch) and \
                    not c.produces_single_batch:
                c = CoalesceBatchesExec(c, goal, max_rows=max_rows)
            elif isinstance(goal, TargetSize) and \
                    isinstance(c, fragmenting):
                c = CoalesceBatchesExec(c, TargetSize(target_bytes),
                                        max_rows=max_rows)
            new_children.append(c)
        node.children = tuple(new_children)
        return node

    out = rewrite(plan)
    verify_coalesce_goals(out)
    return out


def estimate_bytes(node: L.LogicalPlan) -> Optional[int]:
    """Coarse logical size estimate for build-side selection. None =
    unknown, which the join planner treats as too big to broadcast."""
    if isinstance(node, L.LogicalScan):
        if node.data is not None:
            return node.data.nbytes
        est = getattr(node.source, "estimated_bytes", None)
        if callable(est):
            return est()
        return None
    if isinstance(node, L.LogicalRange):
        step = node.step or 1
        return 8 * max(0, (node.end - node.start) // step)
    if isinstance(node, L.LogicalJoin):
        a = estimate_bytes(node.children[0])
        b = estimate_bytes(node.children[1])
        return None if a is None or b is None else a + b
    if isinstance(node, L.LogicalUnion):
        total = 0
        for c in node.children:
            e = estimate_bytes(c)
            if e is None:
                return None
            total += e
        return total
    if len(node.children) == 1:
        # narrow operators: the child's size is an upper bound
        return estimate_bytes(node.children[0])
    return None


def estimate_rows(node: L.LogicalPlan) -> Optional[int]:
    """Coarse logical row-count upper bound. None = unknown; joins are
    unbounded (fan-out)."""
    if isinstance(node, L.LogicalScan):
        if node.data is not None:
            return getattr(node.data, "num_rows", None)
        return None
    if isinstance(node, L.LogicalRange):
        step = node.step or 1
        return max(0, (node.end - node.start + step - 1) // step) \
            if step > 0 else None
    if isinstance(node, L.LogicalLimit):
        child = estimate_rows(node.children[0])
        return node.limit if child is None else min(node.limit, child)
    if isinstance(node, L.LogicalUnion):
        total = 0
        for c in node.children:
            e = estimate_rows(c)
            if e is None:
                return None
            total += e
        return total
    if isinstance(node, (L.LogicalJoin, L.LogicalGenerate,
                         L.LogicalExpand)):
        return None
    if len(node.children) == 1:
        return estimate_rows(node.children[0])
    return None


class Overrides:
    """Tag, then convert. ``device`` is where the scans upload (``cuda``
    unless named), ``catalog`` the buffer catalog they register in (default:
    the device's process-wide one)."""

    def __init__(self, conf: Optional[RapidsTpuConf] = None,
                 device: Optional[torch.device] = None,
                 catalog: Optional[BufferCatalog] = None):
        self.conf = conf or RapidsTpuConf()
        self.device = device
        self.catalog = catalog
        self.last_meta: Optional[PlanMeta] = None

    def plan(self, logical: L.LogicalPlan) -> Exec:
        meta = PlanMeta(logical, self.conf)
        meta.tag()
        propagate_host_only_data(meta)
        if self.conf.get(CBO_ENABLED.key):
            from .cbo import CostBasedOptimizer
            CostBasedOptimizer(self.conf).optimize(meta)
        self.last_meta = meta
        converted = self._convert(meta)
        return insert_coalesce_transitions(
            converted, self.conf.batch_size_bytes,
            max_rows=int(self.conf.get(COALESCE_MAX_ROWS.key)))

    def explain(self, logical: L.LogicalPlan,
                mode: ExplainMode = ExplainMode.ALL) -> str:
        meta = PlanMeta(logical, self.conf)
        meta.tag()
        return meta.explain(mode)

    # ------------------------------------------------------------------

    def _convert(self, meta: PlanMeta) -> Exec:
        children = [self._convert(c) for c in meta.children]
        if not meta.can_run_on_tpu:
            return CpuFallbackExec(meta.node, children, self.device,
                                   ansi=self.conf.ansi)
        return self._to_exec(meta.node, children)

    def _ctx(self) -> EvalContext:
        return EvalContext(ansi=self.conf.ansi)

    def _shuffle_partitions(self) -> int:
        return self.conf.get(SHUFFLE_PARTITIONS.key)

    def _exchange(self, partitioning, child: Exec) -> Exec:
        from ..shuffle.manager import get_shuffle_manager
        return get_shuffle_manager(self.conf).create_exchange(
            partitioning, child)

    def _to_exec(self, n: L.LogicalPlan, ch: List[Exec]) -> Exec:
        if isinstance(n, L.LogicalScan):
            if n.source is not None:
                from ..io.cache import CachedRelation, InMemoryRelationExec
                if isinstance(n.source, CachedRelation):
                    return InMemoryRelationExec(n.source, device=self.device)
                from ..io.scan import FileSourceScanExec
                if hasattr(n.source, "apply_conf"):
                    n.source.apply_conf(self.conf)
                return FileSourceScanExec(n.source, n.num_slices,
                                          device=self.device,
                                          catalog=self.catalog)
            # the Session's dictEncoding.* reach the in-memory upload
            # too, not only the file scans
            from ..dictenc import dict_conf
            return InMemoryScanExec(n.data, schema=n._schema,
                                    num_slices=n.num_slices,
                                    batch_rows=n.batch_rows,
                                    device=self.device,
                                    catalog=self.catalog,
                                    dict_conf=dict_conf(self.conf))
        if isinstance(n, L.LogicalRange):
            return RangeExec(n.start, n.end, n.step, device=self.device)
        if isinstance(n, L.LogicalProject):
            return ProjectExec(n.exprs, ch[0], ctx=self._ctx())
        if isinstance(n, L.LogicalFilter):
            return FilterExec(n.condition, ch[0], ctx=self._ctx())
        if isinstance(n, L.LogicalLimit):
            return GlobalLimitExec(n.limit, ch[0])
        if isinstance(n, L.LogicalUnion):
            return UnionExec(ch)
        if isinstance(n, L.LogicalSample):
            return SampleExec(n.fraction, n.seed, ch[0])
        if isinstance(n, L.LogicalExpand):
            return ExpandExec(n.projections, ch[0])
        if isinstance(n, L.LogicalGenerate):
            from ..config import GENERATE_MAX_REPEAT
            from ..exec.generate import GenerateExec
            from ..expressions.collections import ReplicateRows
            gen = n.generator
            if isinstance(gen, ReplicateRows):
                gen = ReplicateRows(
                    gen.n, int(self.conf.get(GENERATE_MAX_REPEAT.key)))
            return GenerateExec(gen, ch[0], outer=n.outer,
                                pos=n.pos, elem_name=n.elem_name,
                                pos_name=n.pos_name,
                                value_name=n.value_name, ctx=self._ctx())
        if isinstance(n, L.LogicalSort):
            return SortExec(n.orders, ch[0], global_sort=n.global_sort)
        if isinstance(n, L.LogicalWindow):
            return self._convert_window(n, ch[0])
        if isinstance(n, L.LogicalAggregate):
            return self._convert_aggregate(n, ch[0])
        if isinstance(n, L.LogicalJoin):
            return self._convert_join(n, ch)
        raise NotImplementedError(type(n).__name__)

    def _convert_aggregate(self, n: L.LogicalAggregate, child: Exec) -> Exec:
        """Partial, hash exchange on the keys, final. Aggregates that cannot
        decompose (percentile) exchange raw rows by key and run COMPLETE."""
        agg_rows = int(self.conf.get(AGG_MAX_RESULT_ROWS.key))
        raw_aggs = [e.child if isinstance(e, Alias) else e
                    for e in n.agg_exprs]
        if any(not getattr(a, "supports_partial", True) for a in raw_aggs):
            if child.num_partitions > 1:
                if n.group_exprs:
                    child = self._exchange(
                        HashPartitioning(list(n.group_exprs),
                                         self._shuffle_partitions()), child)
                else:
                    child = self._exchange(SinglePartitioning(), child)
            return HashAggregateExec(n.group_exprs, n.agg_exprs, child,
                                     AggregateMode.COMPLETE,
                                     max_result_rows=agg_rows)
        partial = HashAggregateExec(n.group_exprs, n.agg_exprs, child,
                                    AggregateMode.PARTIAL,
                                    max_result_rows=agg_rows)
        if n.group_exprs and child.num_partitions > 1:
            key_cols = [EB.col(f.name) for f in partial.key_fields]
            ex = self._exchange(
                HashPartitioning(key_cols, self._shuffle_partitions()),
                partial)
        elif child.num_partitions > 1:
            ex = self._exchange(SinglePartitioning(), partial)
        else:
            ex = partial
        return HashAggregateExec(n.group_exprs, n.agg_exprs, ex,
                                 AggregateMode.FINAL,
                                 max_result_rows=agg_rows)

    def _convert_window(self, n: L.LogicalWindow, child: Exec) -> Exec:
        """A hash exchange on the partition keys (or one partition, for a
        window without them), then, with keys, a ``KeyBatchingExec`` that
        bounds the window's batches to whole key groups (reference:
        GpuKeyBatchingIterator feeding GpuWindowExec), under the
        ``WindowExec``."""
        from ..exec.key_batching import KeyBatchingExec
        from ..exec.window import WindowExec
        first = n.window_exprs[0]
        w = first.child if isinstance(first, Alias) else first
        pkeys = list(w.spec.partition_keys)
        if pkeys and child.num_partitions > 1:
            child = self._exchange(
                HashPartitioning(pkeys, self._shuffle_partitions()), child)
        elif child.num_partitions > 1:
            child = self._exchange(SinglePartitioning(), child)
        if pkeys:
            child = KeyBatchingExec(pkeys, child,
                                    self.conf.get(WINDOW_BATCH_ROWS.key))
        return WindowExec(n.window_exprs, child)

    def _maybe_dpp(self, stream: Exec, build: Exec, left_keys, right_keys,
                   join_type: JoinType) -> Optional[Exec]:
        """Dynamic partition pruning: when the stream side scans a
        hive-partitioned source and a join key is a partition column, run
        the (broadcast-sized) build side at plan time and drop the stream
        files whose partition value cannot match. Only join types that drop
        unmatched stream rows are eligible. Returns the build side's
        materialization, which the broadcast reuses, or None."""
        if not self.conf.get(DPP_ENABLED.key) or \
                isinstance(build, CpuFallbackExec):
            # an island's build is not run at plan time
            return None
        if join_type not in (JoinType.INNER, JoinType.LEFT_SEMI,
                             JoinType.RIGHT_OUTER):
            return None

        def _through_projections(name: str):
            """Walk the stream side down to a scan, tracking what ``name``
            refers to: a projection must pass the column through unchanged
            (a computed alias disables pruning)."""
            from ..exec.coalesce import CoalesceBatchesExec
            node, cur = stream, name
            while True:
                if isinstance(node, (FilterExec, CoalesceBatchesExec)):
                    node = node.children[0]
                    continue
                if isinstance(node, ProjectExec):
                    match = None
                    child_schema = node.children[0].output_schema
                    for i, f in enumerate(node.output_schema.fields):
                        if f.name == cur:
                            match = _expr_passthrough_name(
                                node.exprs[i], child_schema)
                            break
                    if match is None:
                        return None, None
                    cur = match
                    node = node.children[0]
                    continue
                return node, cur
        from ..exec.base import collect as _collect
        from ..expressions.cast import Cast
        from ..io.scan import FileSourceScanExec
        build_tbl = None
        for lk, rk in zip(left_keys, right_keys):
            # planner-inserted widening casts are transparent to pruning:
            # the partition values are python ints
            while isinstance(lk, Cast):
                lk = lk.child
            while isinstance(rk, Cast):
                rk = rk.child
            name = getattr(lk, "name", None)
            rk_name = getattr(rk, "name", None)
            if name is None or rk_name is None:
                continue
            node, scan_col = _through_projections(name)
            if not isinstance(node, FileSourceScanExec):
                continue
            if scan_col not in {nm for nm, _ in
                                getattr(node.source, "partition_schema",
                                        [])}:
                continue
            try:
                ordinal = build.output_schema.index_of(rk_name)
            except KeyError:
                continue
            if build_tbl is None:
                build_tbl = _collect(build)
            values = set(build_tbl.column(ordinal).to_pylist())
            values.discard(None)          # join keys never match null
            node.prune_partitions(scan_col, values)
        if build_tbl is None:
            return None
        return InMemoryScanExec(build_tbl, schema=build.output_schema,
                                device=build.device, catalog=self.catalog)

    def _broadcast(self, child: Exec) -> Exec:
        return BroadcastExchangeExec(
            child, max_bytes=self.conf.get(BROADCAST_LIMIT.key))

    def _convert_join(self, n: L.LogicalJoin, ch: List[Exec]) -> Exec:
        if n.join_type is JoinType.CROSS or not n.left_keys:
            # keyless joins keep their type: a conditional LEFT_OUTER with
            # no equi-keys is an outer nested-loop join
            return BroadcastNestedLoopJoinExec(
                n.join_type, ch[0], self._broadcast(ch[1]),
                condition=n.condition)
        threshold = self.conf.get(BROADCAST_THRESHOLD.key)
        max_build = self.conf.get(JOIN_MAX_BUILD_ROWS.key)
        build_bytes = estimate_bytes(n.children[1])
        stream_bytes = estimate_bytes(n.children[0])

        left_keys, right_keys = list(n.left_keys), list(n.right_keys)
        l, r = ch[0], ch[1]
        # implicit key casts (Spark inserts these during analysis): widen a
        # mismatched integral key pair to the wider side
        from .. import types as T
        from ..expressions.cast import Cast
        _INT_ORDER = {T.TypeKind.INT8: 0, T.TypeKind.INT16: 1,
                      T.TypeKind.INT32: 2, T.TypeKind.INT64: 3}
        for i, (lk, rk) in enumerate(zip(left_keys, right_keys)):
            lt = lk.bind(l.output_schema).dtype
            rt = rk.bind(r.output_schema).dtype
            if lt == rt or lt.kind not in _INT_ORDER or \
                    rt.kind not in _INT_ORDER:
                continue
            if _INT_ORDER[lt.kind] < _INT_ORDER[rt.kind]:
                left_keys[i] = Cast(lk, rt)
            else:
                right_keys[i] = Cast(rk, lt)
        swapped = False
        # build-side selection: INNER is symmetric, so build on the smaller
        # side when the estimate says the left one is smaller
        if n.join_type is JoinType.INNER and n.condition is None and \
                build_bytes is not None and stream_bytes is not None and \
                stream_bytes < build_bytes:
            l, r = r, l
            left_keys, right_keys = right_keys, left_keys
            build_bytes, stream_bytes = stream_bytes, build_bytes
            swapped = True

        if build_bytes is not None and build_bytes <= threshold:
            r = self._maybe_dpp(l, r, left_keys, right_keys,
                                n.join_type) or r
            join: Exec = HashJoinExec(
                left_keys, right_keys, n.join_type, l,
                self._broadcast(r), condition=n.condition,
                max_build_rows=max_build)
        else:
            # shuffled hash join: co-partition both sides on the join keys
            from ..config import (ADAPTIVE_BROADCAST_ENABLED,
                                  ADAPTIVE_BROADCAST_MAX_BUILD_ROWS,
                                  ADAPTIVE_ENABLED, SKEW_JOIN_ENABLED,
                                  SKEW_SPLIT_ROWS)
            skew = bswitch = None
            if self.conf.get(ADAPTIVE_ENABLED.key):
                if self.conf.get(SKEW_JOIN_ENABLED.key):
                    skew = self.conf.get(SKEW_SPLIT_ROWS.key)
                if self.conf.get(ADAPTIVE_BROADCAST_ENABLED.key):
                    bswitch = int(self.conf.get(
                        ADAPTIVE_BROADCAST_MAX_BUILD_ROWS.key))
            parts = self._shuffle_partitions()
            join = HashJoinExec(
                left_keys, right_keys, n.join_type,
                self._exchange(HashPartitioning(left_keys, parts), l),
                self._exchange(HashPartitioning(right_keys, parts), r),
                condition=n.condition, broadcast_build=False,
                max_build_rows=max_build, skew_split_rows=skew,
                broadcast_switch_rows=bswitch)
        if swapped:
            # restore the user-facing column order (left cols, right cols)
            nr = len(ch[1].output_schema.fields)
            refs = [EB.BoundReference(nr + i, f.dtype, f.nullable, f.name)
                    for i, f in enumerate(ch[0].output_schema.fields)]
            refs += [EB.BoundReference(i, f.dtype, f.nullable, f.name)
                     for i, f in enumerate(ch[1].output_schema.fields)]
            join = ProjectExec(refs, join)
        return join


def _expr_passthrough_name(expr, child_schema):
    """The child-schema column name an output expression passes through
    unchanged, else None (DPP safety: computed aliases disable pruning)."""
    e = expr
    if isinstance(e, Alias):
        e = e.child
    if isinstance(e, EB.BoundReference):
        try:
            return child_schema.fields[e.ordinal].name
        except IndexError:
            return None
    if isinstance(e, EB.UnresolvedColumn):
        return e.name
    return None


def plan_query(logical: L.LogicalPlan,
               conf: Optional[RapidsTpuConf] = None,
               device: Optional[torch.device] = None) -> Exec:
    return Overrides(conf, device).plan(logical)
