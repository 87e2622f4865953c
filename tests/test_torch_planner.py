"""The port's planner on the CPU against the JAX package's: the device
cases of ``test_planner.py`` (project and filter, aggregates, each join
type, sort and limit, union, a chained query, explain's reasons, the
coalesce transition), the two Session cases of ``test_fuse.py``,
``verify_coalesce_goals`` as ``test_coalesce_goals.py`` holds it, the five
cases of ``test_ansi.py``, the implicit key cast and dynamic partition
pruning. The same seeded tables go through the JAX Session and
``spark_rapids_tpu_torch.plan.Session(device="cpu")``; the physical trees
compare node for node (``test_torch_session.tree``) and the rows exactly
but for floats (rel 1e-6).

The conf gates: a node that tagging refuses runs as a CPU fallback
island with the reasons, ``fell_back()`` and rows of the JAX Session; the
CPU side's switches (``sql.enabled``, explain-only, the cost-based
optimizer) and the ICI shuffle (a mesh stage) work; each switch of a feature the port does not have yet
raises ``NotImplementedError`` naming its ROADMAP item; a key outside the
JAX registry raises ``KeyError``. The expression operators (``==``,
``!=``, ``.cast``, ``.is_null``, ``.is_not_null``) build the JAX trees."""

import pathlib
import subprocess
import sys

import numpy as np
import pyarrow as pa
import pyarrow.dataset as ds
import pytest
import torch

from spark_rapids_tpu import types as JT
from spark_rapids_tpu.exec.join import JoinType as JJoinType
from spark_rapids_tpu.exec.sort import asc as jasc
from spark_rapids_tpu.exec.sort import desc as jdesc
from spark_rapids_tpu.expressions import col as jcol
from spark_rapids_tpu.expressions import lit as jlit
from spark_rapids_tpu.expressions.aggregates import Average as JAverage
from spark_rapids_tpu.expressions.aggregates import Count as JCount
from spark_rapids_tpu.expressions.aggregates import Max as JMax
from spark_rapids_tpu.expressions.aggregates import Min as JMin
from spark_rapids_tpu.expressions.aggregates import Sum as JSum
from spark_rapids_tpu.io.scan import read_parquet as jread_parquet
from spark_rapids_tpu.plan import Session as JSession
from spark_rapids_tpu.plan import table as jtable
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.exec import (CoalesceBatchesExec, FusedStageExec,
                                         HashJoinExec, InMemoryScanExec,
                                         JoinType, RequireSingleBatch, asc,
                                         desc)
from spark_rapids_tpu_torch.exec.basic import ArithmeticException
from spark_rapids_tpu_torch.exec.coalesce import (CoalesceGoalError,
                                                  verify_coalesce_goals)
from spark_rapids_tpu_torch.expressions import EqualTo, col, lit
from spark_rapids_tpu_torch.expressions.aggregates import (Average, Count,
                                                           Max, Min, Sum)
from spark_rapids_tpu_torch.expressions.cast import Cast
from spark_rapids_tpu_torch.io import read_parquet
from spark_rapids_tpu_torch.plan import Session, table

from harness.asserts import assert_tables_equal
from harness.data_gen import (DoubleGen, IntegerGen, LongGen, StringGen,
                              gen_table)
from test_torch_session import tree, unfused

ROOT = pathlib.Path(__file__).resolve().parent.parent

T1 = gen_table([("k", IntegerGen(min_val=0, max_val=20)),
                ("v", LongGen(min_val=-1000, max_val=1000)),
                ("s", StringGen(max_len=8)),
                ("d", DoubleGen(no_nans=True))], n=600, seed=70)
T2 = gen_table([("k2", IntegerGen(min_val=0, max_val=25)),
                ("w", LongGen(min_val=0, max_val=50))], n=300, seed=71)


def both(make, conf=None, ordered=False):
    """Collect ``make(api)`` through the JAX Session and the port's, with
    the same conf; the trees compare node for node and the rows equal.
    ``api`` gives each package's table, col, lit, aggregates and join
    types. Returns (port Session, rows)."""
    conf = conf or {}
    jses = JSession(conf)
    want = jses.collect(make(JAX))
    ses = Session(conf, device="cpu")
    got = ses.collect(make(PORT))
    assert tree(unfused(ses.last_plan)) == tree(unfused(jses.last_plan))
    # the port fuses every stage the JAX package fuses, and also those
    # with a broadcast or a coalesce inside (exec/fuse.py)
    if type(jses.last_plan).__name__ == "FusedStageExec":
        assert isinstance(ses.last_plan, FusedStageExec)
    assert ses.fell_back() == [] == jses.fell_back()
    assert_tables_equal(got, want, ignore_order=not ordered)
    return ses, got


class _Api:
    def __init__(self, **kw):
        self.__dict__.update(kw)


JAX = _Api(table=jtable, col=jcol, lit=jlit, Sum=JSum, Count=JCount,
           Min=JMin, Max=JMax, Average=JAverage, JoinType=JJoinType,
           asc=jasc, desc=jdesc)
PORT = _Api(table=table, col=col, lit=lit, Sum=Sum, Count=Count, Min=Min,
            Max=Max, Average=Average, JoinType=JoinType, asc=asc, desc=desc)


# ---------------------------------------------------------------------------
# test_planner.py's device cases
# ---------------------------------------------------------------------------

def test_project_filter():
    both(lambda a: a.table(T1).where(a.col("v") > a.lit(0))
         .select((a.col("v") + a.col("k")).alias("x"),
                 (a.col("v") % a.lit(7)).alias("m"), a.col("s")))


def test_aggregate():
    both(lambda a: a.table(T1, num_slices=3).group_by("k")
         .agg(a.Sum(a.col("v")).alias("s"), a.Count(a.col("v")).alias("c"),
              a.Min(a.col("d")).alias("mn"), a.Max(a.col("d")).alias("mx"),
              a.Average(a.col("v")).alias("a")))


def test_global_aggregate():
    both(lambda a: a.table(T1).agg(a.Sum(a.col("v")).alias("s"),
                                   a.Count().alias("n")))


@pytest.mark.parametrize("how", ["INNER", "LEFT_OUTER", "FULL_OUTER",
                                 "LEFT_SEMI", "LEFT_ANTI"])
def test_join(how):
    ses, _ = both(lambda a: a.table(T1).join(a.table(T2), ["k"], ["k2"],
                                             getattr(a.JoinType, how)))
    # a broadcast join over one batch a side fuses in the port, but for
    # the join types that need state across batches
    assert isinstance(ses.last_plan, FusedStageExec) == (how != "FULL_OUTER")


def test_sort_limit():
    both(lambda a: a.table(T1).order_by(a.asc(a.col("k")),
                                        a.desc(a.col("v"))).limit(50),
         ordered=True)


def test_union():
    both(lambda a: a.table(T2).union(a.table(T2)))


def test_chained_query():
    def q(a):
        j = a.table(T1).join(a.table(T2), ["k"], ["k2"], a.JoinType.INNER)
        return (j.where(a.col("w") > a.lit(5))
                 .group_by("k")
                 .agg(a.Sum(a.col("v")).alias("sv"), a.Count().alias("n"))
                 .order_by("k"))
    both(q, ordered=True)


def test_explain_matches_the_jax_explain():
    conf = {"spark.rapids.tpu.sql.exec.Filter": False}
    out = Session(conf, device="cpu").explain(
        table(T1).where(col("v") > lit(0)))
    assert "!Filter" in out
    assert "spark.rapids.tpu.sql.exec.Filter is false" in out
    assert "*Scan" in out
    assert out == JSession(conf).explain(
        jtable(T1).where(jcol("v") > jlit(0)))


def test_coalesce_transition_inserted():
    t = gen_table([("k", IntegerGen(min_val=0, max_val=5)),
                   ("v", LongGen())], n=2000, seed=95)
    ses, _ = both(lambda a: a.table(t, num_slices=1, batch_rows=100)
                  .where(a.col("v") > a.lit(0))
                  .group_by("k").agg(a.Sum(a.col("v")).alias("s")))
    names = ses.executed_exec_names()
    assert "CoalesceBatchesExec" in names, names

    def walk(e):
        yield e
        for c in e.children:
            yield from walk(c)
    co = next(e for e in walk(ses.last_plan)
              if isinstance(e, CoalesceBatchesExec))
    # twenty hundred-row batches out of the filter merge into one
    assert co.child.metrics["numOutputBatches"].total() >= 20
    assert co.metrics["numOutputBatches"].total() == 1


# ---------------------------------------------------------------------------
# test_fuse.py's Session cases
# ---------------------------------------------------------------------------

def test_session_engages_fusion_for_linear_stage():
    t = pa.table({"a": np.arange(100, dtype=np.int64),
                  "b": np.arange(100, dtype=np.float64)})
    ses, got = both(lambda a: a.table(t).where(a.col("a") < a.lit(50))
                    .select((a.col("a") * a.lit(2)).alias("a2"),
                            a.col("b")))
    assert isinstance(ses.last_plan, FusedStageExec)
    assert got.column("a2").to_pylist() == list(range(0, 100, 2))


def test_session_fusion_disabled_by_conf():
    t = pa.table({"a": np.arange(10, dtype=np.int64)})
    ses, got = both(lambda a: a.table(t).where(a.col("a") < a.lit(5)),
                    conf={"spark.rapids.tpu.sql.fusion.enabled": False})
    assert not isinstance(ses.last_plan, FusedStageExec)
    assert got.column("a").to_pylist() == [0, 1, 2, 3, 4]


# ---------------------------------------------------------------------------
# test_coalesce_goals.py: the goal verification
# ---------------------------------------------------------------------------

def _big_table(n=2000, seed=5):
    rng = np.random.default_rng(seed)
    return pa.table({"k": rng.integers(0, 100, n).astype(np.int64),
                     "v": rng.integers(-1000, 1000, n).astype(np.int64)})


def test_verify_rejects_unmet_goal():
    left = InMemoryScanExec(_big_table(500), batch_rows=100, device="cpu")
    right = InMemoryScanExec(_big_table(500, seed=6), batch_rows=100,
                             device="cpu")
    join = HashJoinExec([col("k")], [col("k")], JoinType.INNER, left, right)
    with pytest.raises(CoalesceGoalError, match="RequireSingleBatch"):
        verify_coalesce_goals(join)
    fixed = HashJoinExec([col("k")], [col("k")], JoinType.INNER, left,
                         CoalesceBatchesExec(right, RequireSingleBatch()))
    verify_coalesce_goals(fixed)


def test_planner_satisfies_declared_goals():
    dim = pa.table({"d": np.arange(50, dtype=np.int64),
                    "name": [f"n{i}" for i in range(50)]})
    ses, _ = both(lambda a: a.table(_big_table(), batch_rows=256)
                  .join(a.table(dim), ["k"], ["d"], a.JoinType.LEFT_OUTER)
                  .order_by("k").limit(50))
    verify_coalesce_goals(ses.last_plan)


# ---------------------------------------------------------------------------
# test_ansi.py's five cases
# ---------------------------------------------------------------------------

ANSI = {"spark.rapids.tpu.sql.ansi.enabled": True}
OVERFLOW_T = pa.table({"a": pa.array([2**62, 2**62, 5], pa.int64()),
                       "b": pa.array([2**62, 1, 7], pa.int64())})
SAFE_T = pa.table({"a": pa.array([1, 2, 3], pa.int64()),
                   "b": pa.array([4, 5, 6], pa.int64())})
DIV_T = pa.table({"a": pa.array([1, 2, 3], pa.int64()),
                  "b": pa.array([1, 0, 2], pa.int64())})


@pytest.mark.parametrize("make,error", [
    (lambda a: a.table(OVERFLOW_T).select(
        (a.col("a") + a.col("b")).alias("s")), "ARITHMETIC_OVERFLOW"),
    (lambda a: a.table(OVERFLOW_T).select(
        (a.col("a") * a.lit(4)).alias("m")), "ARITHMETIC_OVERFLOW"),
    (lambda a: a.table(DIV_T).select(
        (a.col("a") / a.col("b")).alias("d")), "DIVIDE_BY_ZERO"),
], ids=["add_overflow", "multiply_overflow", "divide_by_zero"])
def test_ansi_errors_as_the_jax_session_raises(make, error):
    with pytest.raises(Exception, match=error):
        JSession(ANSI).collect(make(JAX))
    with pytest.raises(ArithmeticException, match=error):
        Session(ANSI, device="cpu").collect(make(PORT))


def test_ansi_safe_values_pass():
    both(lambda a: a.table(SAFE_T).select(
        (a.col("a") + a.col("b")).alias("s"),
        (a.col("a") * a.col("b")).alias("m")), conf=ANSI)


def test_non_ansi_wraps_silently():
    _, got = both(lambda a: a.table(OVERFLOW_T).select(
        (a.col("a") + a.col("b")).alias("s")))
    assert got.column("s").to_pylist()[0] == -(2 ** 63)


# ---------------------------------------------------------------------------
# implicit key casts and dynamic partition pruning
# ---------------------------------------------------------------------------

def test_mismatched_integral_keys_widen():
    fact = pa.table({"k": pa.array(np.arange(200) % 40, pa.int32()),
                     "v": np.arange(200, dtype=np.int64)})
    dim = pa.table({"dk": np.arange(0, 60, 2, dtype=np.int64),
                    "w": np.arange(30, dtype=np.int64)})
    ses, _ = both(lambda a: a.table(fact).join(a.table(dim), ["k"], ["dk"]))
    join = next(e for e in _walk(unfused(ses.last_plan))
                if isinstance(e, HashJoinExec))
    assert isinstance(join.left_keys[0], Cast)
    assert join.left_keys[0].dtype == T.INT64


def test_cast_outside_integral_widening_names_its_item():
    """Past integral widening the port now casts the JAX device matrix;
    a pair ``cast_supported`` refuses (double to string) tags its node to
    an island and names the JAX package's reason, as the JAX Session
    does."""
    from spark_rapids_tpu.expressions.cast import Cast as JCast
    t = pa.table({"x": np.arange(4, dtype=np.int64),
                  "f": np.arange(4, dtype=np.float64) / 2})
    ses = Session(device="cpu")
    got = ses.collect(table(t).select(Cast(col("x"), T.INT32).alias("y")))
    assert got.column("y").to_pylist() == [0, 1, 2, 3]
    assert ses.fell_back() == []
    jdf = jtable(t).select(JCast(jcol("f"), JT.string(24)).alias("s"))
    df = table(t).select(Cast(col("f"), T.string(24)).alias("s"))
    reason = "cast double → string[24] has no device kernel"
    assert reason in ses.explain(df)
    assert ses.explain(df) == JSession({}).explain(jdf)
    assert ses.collect(df).equals(JSession({}).collect(jdf))
    assert ses.fell_back() == ["CpuFallback[Project]"]


def _walk(e):
    yield e
    for c in e.children:
        yield from _walk(c)


def _hive_fact(tmp_path):
    t = pa.table({"d": np.repeat(np.arange(8, dtype=np.int32), 50),
                  "v": np.arange(400, dtype=np.int64)})
    ds.write_dataset(t, str(tmp_path), format="parquet",
                     partitioning=ds.partitioning(
                         pa.schema([("d", pa.int32())]), flavor="hive"))
    return str(tmp_path)


def test_dpp_prunes_the_files_the_jax_planner_prunes(tmp_path):
    path = _hive_fact(tmp_path)
    dim = pa.table({"dk": np.arange(8, dtype=np.int64),
                    "grp": np.asarray([0, 0, 1, 1, 2, 2, 3, 3], np.int64)})
    jfact = jread_parquet(path, num_slices=4)
    want = JSession({}).collect(jfact.join(
        jtable(dim).where(jcol("grp") == jlit(1)), ["d"], ["dk"]))
    fact = read_parquet(path, num_slices=4)
    ses = Session({}, device="cpu")
    got = ses.collect(fact.join(table(dim).where(EqualTo(col("grp"), lit(1))),
                                ["d"], ["dk"]))
    assert fact.plan.source.files_pruned == \
        jfact.plan.source.files_pruned == 6
    assert len(fact.plan.source.files) == 8
    assert got.num_rows == 100
    assert_tables_equal(got, want, ignore_order=True)


# ---------------------------------------------------------------------------
# the conf gates
# ---------------------------------------------------------------------------

def _refused_lines(explain: str):
    return [line.strip() for line in explain.splitlines()
            if line.strip().startswith("!")]


@pytest.mark.parametrize("conf,make", [
    ({"spark.rapids.tpu.sql.exec.Filter": False},
     lambda a: a.table(T1).where(a.col("v") > a.lit(0))),
    ({}, lambda a: a.table(T1).group_by("k").agg(
        a.Sum(a.col("d")).alias("s"))),
    ({"spark.rapids.tpu.sql.expression.Add": False},
     lambda a: a.table(T1).select((a.col("v") + a.col("k")).alias("x"))),
], ids=["exec_switch", "float64_sum", "expression_switch"])
def test_refused_node_raises_with_the_jax_reasons(conf, make):
    """A refused node no longer raises: it runs as a CPU fallback island,
    with the JAX explain's reasons, the JAX Session's ``fell_back()`` and
    its rows."""
    jses = JSession(conf)
    jax_refused = _refused_lines(jses.explain(make(JAX)))
    assert jax_refused
    ses = Session(conf, device="cpu")
    assert _refused_lines(ses.explain(make(PORT))) == jax_refused
    got = ses.collect(make(PORT))
    want = jses.collect(make(JAX))
    assert ses.fell_back() == jses.fell_back()
    assert len(ses.fell_back()) == len(jax_refused)
    assert_tables_equal(got, want, ignore_order=True)


def _cpu_side_switch_works(key, ses):
    """The query runs under the switch and gives the interpreter's rows;
    ``sql.enabled=false`` plans nothing, explain-only plans the device
    tree, and the cost-based optimizer moves this 300-row plan to the
    CPU."""
    df = table(T2).where(col("w") > lit(10)).select(col("k2"))
    got = ses.collect(df)
    want = Session({"spark.rapids.tpu.sql.enabled": False},
                   device="cpu").collect(df)
    assert_tables_equal(got, want, ignore_order=True)
    if key.endswith("sql.enabled"):
        assert ses.last_plan is None and ses.fell_back() == []
    elif key.endswith("sql.mode"):
        assert ses.last_plan is not None and ses.fell_back() == []
    else:
        assert ses.fell_back() == ["CpuFallback[Project]",
                                   "CpuFallback[Filter]",
                                   "CpuFallback[Scan]"]


def _ici_switch_works(conf):
    """The ICI Session runs a small group-by as one stage over 8 shards,
    with the JAX ICI Session's lowering and rows."""
    jses = JSession(conf)
    want = jses.collect(jtable(T2).group_by("k2").agg(
        JSum(jcol("w")).alias("s")))
    ses = Session(conf, device="cpu")
    got = ses.collect(table(T2).group_by("k2").agg(Sum(col("w")).alias("s")))
    assert ses.executed_exec_names() == ["MeshStageExec"]
    assert ses.last_plan.lowered == jses.last_plan.lowered
    assert_tables_equal(got, want, ignore_order=True)


@pytest.mark.parametrize("key,value,item", [
    ("spark.rapids.tpu.sql.enabled", False, "item 5"),
    ("spark.rapids.tpu.sql.mode", "explainonly", "item 5"),
    ("spark.rapids.tpu.sql.optimizer.enabled", True, "item 5"),
    ("spark.rapids.tpu.server.resultCache.enabled", True, "item 8"),
    ("spark.rapids.tpu.server.sharing.enabled", True, "item 8"),
    ("spark.rapids.tpu.trace.enabled", True, "item 8"),
    ("spark.rapids.tpu.sql.adaptive.costFeedback.enabled", True, "item 8"),
    ("spark.rapids.tpu.shuffle.mode", "MULTITHREADED", "item 8"),
    ("spark.rapids.tpu.shuffle.mode", "CACHED", "item 8"),
    ("spark.rapids.tpu.shuffle.mode", "ICI", "item 6"),
])
def test_switch_of_a_later_feature_raises(key, value, item):
    """Item 5's switches now work (its CPU side is in), and item 6's (the
    ICI shuffle); every other one still raises, naming its item."""
    if item == "item 5":
        _cpu_side_switch_works(key, Session({key: value}, device="cpu"))
        return
    if item == "item 6":
        _ici_switch_works({key: value, "spark.rapids.tpu.mesh.devices": 8})
        return
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
        Session({key: value}, device="cpu")


def test_unknown_conf_key_raises_and_jax_keys_are_known():
    """A key outside the JAX registry raises ``KeyError`` (a typo no
    longer runs silently); a registered JAX key is known, and set away
    from its default for a feature the port lacks it names the item."""
    with pytest.raises(KeyError, match="unknown config"):
        JSession({"spark.rapids.tpu.sql.metircs.level": "DEBUG"})
    with pytest.raises(KeyError, match="unknown config"):
        Session({"spark.rapids.tpu.sql.metircs.level": "DEBUG"},
                device="cpu")
    level = "spark.rapids.tpu.sql.metrics.level"
    for conf in ({level: "MODERATE"},
                 {"spark.rapids.tpu.shuffle.compression.codec": "lz4",
                  "spark.rapids.tpu.sql.exec.Whatever": True}):
        JSession(conf)
        ses = Session(conf, device="cpu")
        assert ses.collect(table(T2)).num_rows == T2.num_rows
    with pytest.raises(NotImplementedError, match="ROADMAP item 8"):
        Session({level: "DEBUG"}, device="cpu")


def _shape(e):
    """An expression tree as class names and literal values."""
    if hasattr(e, "value"):
        return ("lit", e.value)
    if type(e).__name__ == "UnresolvedColumn":
        return ("col", e.name)
    return (type(e).__name__,) + tuple(_shape(c) for c in e.children)


def test_expression_operators_build_the_jax_trees():
    """``==`` and ``!=`` build ``EqualTo`` and ``Not(EqualTo)``, and the
    helpers their nodes, as in the JAX package (before, ``==`` was the
    dataclass comparison and returned a bool)."""
    def exprs(a):
        return [a.col("k") == a.lit(3), a.col("k") != 3,
                a.col("k").cast(T.INT64 if a is PORT else JT.INT64),
                a.col("s").is_null(), a.col("s").is_not_null()]
    for p, j in zip(exprs(PORT), exprs(JAX)):
        assert _shape(p) == _shape(j)
    assert isinstance(col("k") == col("k"), EqualTo)
    with pytest.raises(TypeError, match="no truth value"):
        bool(col("k") == lit(3))
    both(lambda a: a.table(T1).where((a.col("k") == a.lit(3))
                                     | (a.col("k") != a.lit(5))
                                     & a.col("s").is_not_null()))


def test_plan_cache_switch_changes_nothing():
    t = pa.table({"a": np.arange(10, dtype=np.int64)})
    for on in (True, False):
        ses = Session({"spark.rapids.tpu.server.planCache.enabled": on},
                      device="cpu")
        assert ses.collect(table(t)).equals(t)
        assert ses.last_cache["plan"].startswith("bypass")


def test_memory_keys_give_the_session_a_catalog(tmp_path):
    ses = Session({"spark.rapids.tpu.memory.host.spillStorageSize": "1m",
                   "spark.rapids.tpu.memory.spillDir": str(tmp_path)},
                  device="cpu")
    assert ses.catalog.host_limit == 1 << 20
    assert ses.catalog.spill_dir == str(tmp_path)
    t = pa.table({"a": np.arange(10, dtype=np.int64)})
    ses.collect(table(t, num_slices=2).group_by("a").agg(
        Count().alias("n")))
    assert ses.last_plan.catalog is ses.catalog
    assert Session(device="cpu").catalog is None


def test_session_asks_for_cuda_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Session()


def test_planner_modules_load_no_jax():
    modules = ["spark_rapids_tpu_torch.plan",
               "spark_rapids_tpu_torch.plan.logical",
               "spark_rapids_tpu_torch.plan.typesig",
               "spark_rapids_tpu_torch.plan.overrides",
               "spark_rapids_tpu_torch.plan.session",
               "spark_rapids_tpu_torch.plan.interpreter",
               "spark_rapids_tpu_torch.plan.cbo",
               "spark_rapids_tpu_torch.shuffle.manager",
               "spark_rapids_tpu_torch.expressions.cast",
               "spark_rapids_tpu_torch.io.scan",
               "spark_rapids_tpu_torch.config",
               "spark_rapids_tpu_torch.entry"]
    code = ("import sys\n" + "".join(f"import {m}\n" for m in modules)
            + "bad = [m for m in sys.modules if m.split('.')[0] in\n"
              "       ('jax', 'jaxlib', 'flax', 'spark_rapids_tpu')]\n"
              "assert not bad, bad\nprint('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_cache_and_write_parquet_through_the_session(tmp_path):
    """``Session.cache`` keeps a planned DataFrame as Parquet blobs and
    ``Session.write_parquet`` writes one task by task; both read back as
    the query's rows, and the JAX Session's ``write_parquet`` writes the
    same rows."""
    df = (table(T2, num_slices=2).where(col("w") > lit(10))
          .select(col("k2"), (col("w") * lit(2)).alias("w2")))
    ses = Session(device="cpu")
    want = ses.collect(df)
    cached = ses.cache(df)
    assert_tables_equal(ses.collect(cached), want, ignore_order=True)
    stats = ses.write_parquet(df, str(tmp_path / "port"))
    assert stats.num_rows == want.num_rows and stats.num_tasks == 2
    jdf = (jtable(T2, num_slices=2).where(jcol("w") > jlit(10))
           .select(jcol("k2"), (jcol("w") * jlit(2)).alias("w2")))
    JSession({}).write_parquet(jdf, str(tmp_path / "jax"))
    for d in ("port", "jax"):
        got = ds.dataset(str(tmp_path / d)).to_table()
        assert_tables_equal(got, want, ignore_order=True)


def test_size_estimates_match_the_jax_planners(tmp_path):
    """``estimate_bytes`` and ``estimate_rows``, which pick the build side
    and the broadcast, give the JAX planner's numbers."""
    from spark_rapids_tpu.plan import overrides as JO
    from spark_rapids_tpu.plan.logical import range_ as jrange
    from spark_rapids_tpu_torch.plan import overrides as O
    from spark_rapids_tpu_torch.plan.logical import range_
    path = _hive_fact(tmp_path)

    def shapes(a, rng, read):
        scan = a.table(T1)
        return [scan.plan, scan.where(a.col("v") > a.lit(0)).plan,
                scan.limit(7).plan, a.table(T2).union(a.table(T2)).plan,
                scan.join(a.table(T2), ["k"], ["k2"]).plan,
                rng(0, 100, 3).plan, read(path).plan]
    port = shapes(PORT, range_, read_parquet)
    jax = shapes(JAX, jrange, jread_parquet)
    assert [O.estimate_bytes(p) for p in port] == \
        [JO.estimate_bytes(p) for p in jax]
    assert [O.estimate_rows(p) for p in port] == \
        [JO.estimate_rows(p) for p in jax]


def test_with_conf_derives_a_session():
    t = pa.table({"a": np.arange(10, dtype=np.int64)})
    ses = Session(device="cpu")
    off = ses.with_conf(spark_rapids_tpu_sql_fusion_enabled=False)
    assert off.device == ses.device
    assert off.conf.get("spark.rapids.tpu.sql.fusion.enabled") is False
    off.collect(table(t).where(col("a") < lit(5)))
    assert not isinstance(off.last_plan, FusedStageExec)


def test_metrics_report_this_collects_spills(tmp_path):
    """Under a small host budget of its own the Session's catalog spills
    to disk; ``metrics`` reports the bytes this collect spilled, then
    nothing for the next collect that spills none."""
    rng = np.random.default_rng(4)
    t = pa.table({"g": rng.integers(0, 50, 20000).astype(np.int32),
                  "v": rng.integers(0, 9, 20000).astype(np.int64)})
    ses = Session({"spark.rapids.tpu.memory.host.spillStorageSize": 1,
                   "spark.rapids.tpu.memory.spillDir": str(tmp_path)},
                  device="cpu")
    ses.catalog.device_limit = 256 << 10
    df = table(t, num_slices=4, batch_rows=5000).group_by("g").agg(
        Sum(col("v")).alias("s"))
    got = ses.collect(df)
    assert got.num_rows == 50
    m = ses.metrics()
    assert m.get("catalog.spilled_to_disk", 0) > 0, m
    assert m["HashAggregateExec.numOutputRows"] > 0
    ses.catalog.device_limit = 1 << 40
    ses.collect(df)
    assert "catalog.spilled_to_disk" not in ses.metrics()
