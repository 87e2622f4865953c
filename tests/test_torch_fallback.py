"""CPU fallback islands, the ``sql.enabled=false`` oracle, explain-only
mode and the cost-based optimizer in the port's Session, on the CPU.

- The five ``tests/test_planner.py`` cases that ROADMAP item 5 names, built
  with the port's DataFrames and held against the JAX Session: the same
  rows, the same ``fell_back()``, the same explain ``!`` lines.
- Average over a decimal as an island, TPC-H Q3 at SF 0.01 with
  ``EqualTo`` switched off, and a cost-based plan, each against the JAX
  Session.
- The port's own differential: ``Session()`` against
  ``Session({"spark.rapids.tpu.sql.enabled": False})`` on every
  differential case of ``test_planner.py``.
- No hidden host work: fusion never spans an island, an island's result
  goes to the Session's device, and a device failure raises instead of
  falling back."""

import decimal

import pyarrow as pa
import pytest
import torch

import spark_rapids_tpu.plan.cbo  # noqa: F401 (registers its conf key)
from spark_rapids_tpu.expressions.aggregates import Average as JAverage
from spark_rapids_tpu.plan import Session as JSession
from spark_rapids_tpu.plan import table as jtable
from spark_rapids_tpu.expressions import col as jcol
from spark_rapids_tpu_torch import entry
from spark_rapids_tpu_torch.exec import FusedStageExec
from spark_rapids_tpu_torch.expressions import col
from spark_rapids_tpu_torch.expressions.aggregates import Average
from spark_rapids_tpu_torch.plan import CpuFallbackExec, Session, table

from harness.asserts import assert_tables_equal
from harness.data_gen import DoubleGen, IntegerGen, gen_table
from test_torch_planner import JAX, PORT, T1, T2, _refused_lines
from test_torch_q3 import _jax_q3
from test_torch_session import node, unfused

ORACLE = {"spark.rapids.tpu.sql.enabled": False}
FILTER_OFF = {"spark.rapids.tpu.sql.exec.Filter": False}


def tree(e, depth=0):
    """``test_torch_session.tree``, into the device children of islands."""
    out = [(depth,) + node(e)]
    for c in list(e.children) + list(getattr(e, "child_execs", ())):
        out += tree(c, depth + 1)
    return out


def against_jax(make, conf, ordered=False):
    """Collect ``make(api)`` through the JAX Session and the port's under
    ``conf``: the same rows, ``fell_back()``, operator names and explain
    ``!`` lines. Returns (port Session, rows)."""
    jses = JSession(conf)
    want = jses.collect(make(JAX))
    ses = Session(conf, device="cpu")
    got = ses.collect(make(PORT))
    assert_tables_equal(got, want, ignore_order=not ordered)
    assert ses.fell_back() == jses.fell_back()
    assert ses.executed_exec_names() == jses.executed_exec_names()
    assert _refused_lines(ses.explain(make(PORT))) == \
        _refused_lines(jses.explain(make(JAX)))
    return ses, got


def oracle(make, conf=None):
    """The port's interpreter on the same query."""
    return Session({**(conf or {}), **ORACLE}, device="cpu").collect(
        make(PORT))


# ---------------------------------------------------------------------------
# the five cases ROADMAP item 5 names, and the two that waited for Pow
# ---------------------------------------------------------------------------

def _pow(a):
    from spark_rapids_tpu.expressions.math import Pow as JPow
    from spark_rapids_tpu_torch.expressions import Pow
    p = JPow if a is JAX else Pow
    return a.table(T1).select(p(a.col("d"), a.lit(2.0)).alias("p"))


def test_incompat_op_falls_back():
    """Pow is ``incompat`` (CUDA's libdevice, like XLA, differs from the
    JVM's StrictMath in the last ULPs): without incompatibleOps its
    Project runs on the interpreter, with the right rows."""
    ses, got = against_jax(_pow, {})
    assert ses.fell_back() == ["CpuFallback[Project]"]
    assert_tables_equal(got, oracle(_pow), ignore_order=True)


def test_incompat_op_runs_when_enabled():
    on = {"spark.rapids.tpu.sql.incompatibleOps.enabled": True}
    ses, got = against_jax(_pow, on)
    assert ses.fell_back() == []
    assert got.num_rows == T1.num_rows
    assert_tables_equal(got, oracle(_pow, on), ignore_order=True)


def test_exec_disabled_by_conf_falls_back():
    def q(a):
        return a.table(T1).where(a.col("v") > a.lit(0))
    ses, got = against_jax(q, FILTER_OFF)
    assert ses.fell_back() == ["CpuFallback[Filter]"]
    assert_tables_equal(got, oracle(q, FILTER_OFF), ignore_order=True)


def test_fallback_island_reads_tpu_children():
    """The Filter falls back; the Project above it and the scan below it
    stay on the device, and the island reads the scan through Arrow."""
    def q(a):
        return a.table(T1).where(a.col("v") > a.lit(0)).select(
            (a.col("v") * a.lit(2)).alias("x"))
    ses, got = against_jax(q, FILTER_OFF)
    names = ses.executed_exec_names()
    assert names == ["ProjectExec", "CpuFallback[Filter]",
                     "InMemoryScanExec"], names
    island = ses.last_plan.children[0]
    assert isinstance(island, CpuFallbackExec)
    assert island.metrics["numInputRows"].total() == T1.num_rows
    assert island.metrics["numOutputRows"].total() == got.num_rows
    assert_tables_equal(got, oracle(q))


def test_explain_shows_reasons():
    def q(a):
        return a.table(T1).where(a.col("v") > a.lit(0))
    out = Session(FILTER_OFF, device="cpu").explain(q(PORT))
    assert "!Filter" in out
    assert "spark.rapids.tpu.sql.exec.Filter is false" in out
    assert "*Scan" in out
    assert out == JSession(FILTER_OFF).explain(q(JAX))


def test_explainonly_mode_runs_cpu_but_plans():
    conf = {"spark.rapids.tpu.sql.mode": "explainonly"}

    def q(a):
        return a.table(T1).where(a.col("v") > a.lit(0))
    jses = JSession(conf)
    want = jses.collect(q(JAX))
    ses = Session(conf, device="cpu")
    assert ses.prepare(q(PORT)) == ("interpret", None)
    got = ses.collect(q(PORT))
    assert ses.last_plan is not None       # planned as for the device
    assert tree(ses.last_plan) == tree(jses.last_plan)
    assert_tables_equal(got, want)
    assert_tables_equal(got, oracle(q))


def test_float64_agg_incompat_gating():
    """Sum over float64 without incompatibleOps runs as an island in both
    packages (the JAX package's f64 hazard gate, kept so that one conf
    gives one tree); with it on, on the device."""
    t = gen_table([("k", IntegerGen(min_val=0, max_val=5)),
                   ("d", DoubleGen(no_nans=True))], n=200, seed=77)

    def q(a):
        return a.table(t).group_by("k").agg(a.Sum(a.col("d")).alias("s"))
    ses, got = against_jax(q, {})
    assert ses.fell_back() == ["CpuFallback[Aggregate]"]
    assert_tables_equal(got, oracle(q), ignore_order=True)
    on = {"spark.rapids.tpu.sql.incompatibleOps.enabled": True}
    ses, _ = against_jax(q, on)
    assert ses.fell_back() == []


# ---------------------------------------------------------------------------
# decimal average, Q3 with EqualTo off, the cost-based optimizer
# ---------------------------------------------------------------------------

def test_decimal_average_runs_as_an_island():
    """avg over decimal(5,2) is decimal(9,6) with HALF_UP rounding: tagged
    off the device in both packages, it runs on the interpreter, and its
    decimal result goes back up to a device sort."""
    D = decimal.Decimal
    t = pa.table({"k": pa.array([0, 0, 0, 1, 1, 2], pa.int32()),
                  "x": pa.array([D("1.00"), D("2.00"), D("2.00"), D("-0.01"),
                                 None, None], pa.decimal128(5, 2))})
    jses = JSession({})
    want = jses.collect(jtable(t).group_by("k").agg(
        JAverage(jcol("x")).alias("a")).order_by("k"))
    ses = Session({}, device="cpu")
    got = ses.collect(table(t).group_by("k").agg(
        Average(col("x")).alias("a")).order_by("k"))
    assert got.schema.field("a").type == pa.decimal128(9, 6)
    assert got.equals(want)
    assert got.column("a").to_pylist() == [D("1.666667"), D("-0.010000"),
                                           None]
    assert ses.fell_back() == jses.fell_back() == ["CpuFallback[Aggregate]"]
    assert ses.executed_exec_names()[0] == "SortExec"


def test_q3_with_equal_to_off_matches_the_jax_session():
    """TPC-H Q3 at SF 0.01 with ``sql.expression.EqualTo=false``: only the
    customer filter becomes an island; both joins, the aggregate, the
    exchanges, the sort and the limit stay on the device."""
    c, o, li = entry.tpch_q3_tables(0.01)
    conf = entry.session_conf(4, **{
        "spark.rapids.tpu.sql.expression.EqualTo": False})
    jses = JSession(conf)
    want = jses.collect(_jax_q3(c, o, li))
    ses = Session(conf, device="cpu")
    got = ses.collect(entry.q3_df(c, o, li, num_slices=2))
    assert ses.fell_back() == jses.fell_back() == ["CpuFallback[Filter]"]
    assert_tables_equal(got, want, ignore_order=False)
    assert_tables_equal(got, entry.q3_reference(c, o, li),
                        ignore_order=False)
    same = Session(entry.session_conf(4), device="cpu").collect(
        entry.q3_df(c, o, li, num_slices=2))
    assert got.equals(same)
    assert tree(unfused(ses.last_plan)) == tree(unfused(jses.last_plan))


def test_cost_based_optimizer_moves_a_tiny_plan_to_the_cpu():
    """With the optimizer on, every operator of a 300-row plan costs more
    on the device than its rows on the CPU (the JAX package's scores):
    nested islands splice into one interpreted tree, with no device round
    trip between them, and the plan is CPU-topped."""
    conf = {"spark.rapids.tpu.sql.optimizer.enabled": True}

    def q(a):
        return a.table(T2).where(a.col("w") > a.lit(10)).group_by("k2").agg(
            a.Count().alias("n"))
    ses, got = against_jax(q, conf)
    assert ses.fell_back() == ["CpuFallback[Aggregate]",
                               "CpuFallback[Filter]", "CpuFallback[Scan]"]
    kind, plan = ses.prepare(q(PORT))
    assert kind == "fallback" and isinstance(plan, CpuFallbackExec)
    assert_tables_equal(got, oracle(q), ignore_order=True)


# ---------------------------------------------------------------------------
# the port's own differential: the device Session against the interpreter
# ---------------------------------------------------------------------------

DIFFERENTIAL = [
    ("project_filter", lambda a: a.table(T1).where(a.col("v") > a.lit(0))
     .select((a.col("v") + a.col("k")).alias("x"),
             (a.col("v") % a.lit(7)).alias("m"), a.col("s")), False),
    ("aggregate", lambda a: a.table(T1, num_slices=3).group_by("k").agg(
        a.Sum(a.col("v")).alias("s"), a.Count(a.col("v")).alias("c"),
        a.Min(a.col("d")).alias("mn"), a.Max(a.col("d")).alias("mx"),
        a.Average(a.col("v")).alias("a")), False),
    ("global_aggregate", lambda a: a.table(T1).agg(
        a.Sum(a.col("v")).alias("s"), a.Count().alias("n")), False),
] + [(f"join_{how}", (lambda how: lambda a: a.table(T1).join(
    a.table(T2), ["k"], ["k2"], getattr(a.JoinType, how)))(how), False)
     for how in ("INNER", "LEFT_OUTER", "FULL_OUTER", "LEFT_SEMI",
                 "LEFT_ANTI")] + [
    ("sort_limit", lambda a: a.table(T1).order_by(
        a.asc(a.col("k")), a.desc(a.col("v"))).limit(50), True),
    ("union", lambda a: a.table(T2).union(a.table(T2)), False),
    ("chained", lambda a: a.table(T1).join(a.table(T2), ["k"], ["k2"])
     .where(a.col("w") > a.lit(5)).group_by("k")
     .agg(a.Sum(a.col("v")).alias("sv"), a.Count().alias("n"))
     .order_by("k"), True),
]


@pytest.mark.parametrize("case,make,ordered", DIFFERENTIAL,
                         ids=[d[0] for d in DIFFERENTIAL])
def test_device_session_equals_the_interpreter(case, make, ordered):
    got = Session(device="cpu").collect(make(PORT))
    assert_tables_equal(got, oracle(make), ignore_order=not ordered)


# ---------------------------------------------------------------------------
# no hidden host work
# ---------------------------------------------------------------------------

def test_fusion_never_spans_an_island():
    """A plan that would fuse keeps the iterator path whole when it holds
    an island, as the JAX Session's does; the device subtree under the
    island is not fused either."""
    t = pa.table({"a": pa.array(range(100), pa.int64())})

    def q(a):
        return a.table(t).where(a.col("a") < a.lit(50)).select(
            (a.col("a") * a.lit(2)).alias("a2"))
    fused = Session(device="cpu")
    fused.collect(q(PORT))
    assert isinstance(fused.last_plan, FusedStageExec)
    jses = JSession(FILTER_OFF)
    jses.collect(q(JAX))
    ses = Session(FILTER_OFF, device="cpu")
    got = ses.collect(q(PORT))
    assert type(jses.last_plan).__name__ != "FusedStageExec"
    assert not isinstance(ses.last_plan, FusedStageExec)
    assert "FusedStageExec" not in ses.executed_exec_names()
    assert got.column("a2").to_pylist() == list(range(0, 100, 2))


def test_island_result_goes_to_the_sessions_device():
    ses = Session(FILTER_OFF, device="cpu")
    kind, plan = ses.prepare(table(T1).where(col("v") > 0).select(col("k")))
    island = plan.children[0]
    assert isinstance(island, CpuFallbackExec)
    assert island.device == ses.device == torch.device("cpu")
    batch = next(island.execute())
    assert all(c.data.device == ses.device for c in batch.columns)


def test_a_device_failure_raises_and_never_falls_back(monkeypatch):
    """A failed kernel launch (the murmur3 kernel of a hash exchange)
    raises out of ``collect``, with or without an island above it, and so
    does a failure in any device child that an island collects: no error
    sends work to the interpreter."""
    from spark_rapids_tpu_torch.exec import basic
    from spark_rapids_tpu_torch.expressions import hashing

    def failed(*a, **kw):
        raise RuntimeError("CUDA error: launch failed (injected)")
    monkeypatch.setattr(hashing, "murmur3_int32", failed)
    df = (table(T1, num_slices=3).group_by("k")
          .agg(Average(col("v")).alias("a")).where(col("a") > 0))
    for conf in ({}, FILTER_OFF):
        ses = Session(conf, device="cpu")
        with pytest.raises(RuntimeError, match="launch failed"):
            ses.collect(df)
        assert ses.fell_back() == ([] if not conf
                                   else ["CpuFallback[Filter]"])
    monkeypatch.undo()
    monkeypatch.setattr(basic.InMemoryScanExec, "do_execute_partition",
                        failed)
    ses = Session(FILTER_OFF, device="cpu")
    with pytest.raises(RuntimeError, match="launch failed"):
        ses.collect(df)
    assert ses.fell_back() == ["CpuFallback[Filter]"]
