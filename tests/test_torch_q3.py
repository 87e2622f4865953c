"""The join slice as a whole: TPC-H Q3 through the port on the CPU against
the JAX Session running the same DataFrame (AQE off; once with every join
shuffled, once with the default broadcast threshold), against the JAX
planner's physical tree node for node, and against pyarrow. Keys compare
exactly, revenue within rel 1e-6 (the float64 sums add in different
orders). Each JAX collect runs once, in the one test that reads it."""

import pathlib
import subprocess
import sys

import numpy as np
import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu.exec.sort import SortOrder as JSortOrder
from spark_rapids_tpu.expressions import col as jcol
from spark_rapids_tpu.expressions import lit as jlit
from spark_rapids_tpu.expressions.aggregates import Sum as JSum
from spark_rapids_tpu.expressions.comparison import EqualTo as JEqualTo
from spark_rapids_tpu.expressions.comparison import GreaterThan as JGreater
from spark_rapids_tpu.expressions.comparison import LessThan as JLess
from spark_rapids_tpu.plan import Session, table
from spark_rapids_tpu_torch import entry
from spark_rapids_tpu_torch.exec import collect

ROOT = pathlib.Path(__file__).resolve().parent.parent
SF, SLICES, PARTITIONS = 0.001, 2, 4
REL_TOL = 1e-6

BASE_CONF = {"spark.rapids.tpu.sql.incompatibleOps.enabled": True,
             "spark.rapids.tpu.sql.adaptive.enabled": False,
             "spark.rapids.tpu.shuffle.partitions": PARTITIONS}
CONFS = {
    "shuffled": dict(BASE_CONF, **{
        "spark.rapids.tpu.sql.autoBroadcastJoinThreshold": 0}),
    "broadcast": BASE_CONF,
}


def _jax_q3(customer, orders, lineitem):
    """Q3 as a DataFrame of the JAX package, tables in the FROM order."""
    def scan(t):
        return table(t, num_slices=SLICES,
                     batch_rows=-(-t.num_rows // SLICES))
    day = entry.Q3_DATE
    return (scan(customer)
            .where(JEqualTo(jcol("c_mktsegment"), jlit(entry.Q3_SEGMENT)))
            .join(scan(orders).where(JLess(jcol("o_orderdate"), jlit(day))),
                  ["c_custkey"], ["o_custkey"])
            .join(scan(lineitem).where(JGreater(jcol("l_shipdate"),
                                                jlit(day))),
                  ["o_orderkey"], ["l_orderkey"])
            .group_by(*entry.Q3_KEYS)
            .agg(JSum(jcol("l_extendedprice")
                      * (jlit(1.0) - jcol("l_discount"))).alias("revenue"))
            .order_by(JSortOrder(jcol("revenue"), True),
                      JSortOrder(jcol("o_orderdate")))
            .limit(entry.Q3_LIMIT)
            .select(*entry.Q3_SELECT))


def _node(e):
    """What a tree node must agree on: exec class, join type, broadcast or
    co-partitioned build, partitioning keys, aggregate mode, limit and
    coalesce goal."""
    attrs = [type(e).__name__]
    if hasattr(e, "join_type"):
        attrs += [e.join_type.name, e.broadcast_build]
    part = getattr(e, "partitioning", None)
    if part is not None:
        attrs.append(tuple((k.ordinal, str(k.dtype)) for k in part.exprs))
        attrs.append(part.num_partitions)
    if hasattr(e, "mode"):
        attrs.append(e.mode.name)
    if hasattr(e, "limit"):
        attrs.append(e.limit)
    if hasattr(e, "goal"):
        attrs.append(type(e.goal).__name__)
    return tuple(attrs)


def _tree(e, depth=0):
    out = [(depth,) + _node(e)]
    for c in e.children:
        out += _tree(c, depth + 1)
    return out


def assert_q3_equal(got: pa.Table, want: pa.Table):
    """Keys exact, revenue within REL_TOL, row for row."""
    assert got.column_names == list(entry.Q3_SELECT)
    assert got.num_rows == want.num_rows
    for name in ("l_orderkey", "o_orderdate", "o_shippriority"):
        assert got.column(name).to_pylist() == want.column(name).to_pylist()
    g = got.column("revenue").to_numpy()
    w = want.column("revenue").to_numpy()
    np.testing.assert_allclose(g, w, rtol=REL_TOL, atol=0)


@pytest.fixture(scope="module")
def q3_tables():
    return entry.tpch_q3_tables(SF)


@pytest.mark.parametrize("mode", list(CONFS))
def test_q3_matches_jax_session_tree_and_pyarrow(q3_tables, mode):
    ses = Session(CONFS[mode])
    jax_result = ses.collect(_jax_q3(*q3_tables))
    broadcast = mode == "broadcast"
    plan = entry.q3_plan(*q3_tables, num_slices=SLICES,
                         shuffle_partitions=PARTITIONS, broadcast=broadcast,
                         device="cpu")
    assert _tree(plan) == _tree(ses.last_plan)
    got = collect(plan)
    assert got.schema == jax_result.schema == pa.schema([
        ("l_orderkey", pa.int64()), ("revenue", pa.float64()),
        ("o_orderdate", pa.date32()), ("o_shippriority", pa.int32())])
    assert got.num_rows == entry.Q3_LIMIT
    assert_q3_equal(got, jax_result)
    assert_q3_equal(got, entry.q3_reference(*q3_tables))
    joins = [n for n in _tree(plan) if n[1] == "HashJoinExec"]
    assert [n[2:4] for n in joins] == [("INNER", broadcast)] * 2


def test_q3_plan_is_the_jax_planners_shuffled_tree(q3_tables):
    """The shuffled tree, root first, as the JAX planner prints it."""
    plan = entry.q3_plan(*q3_tables, device="cpu")
    assert plan.exec_names() == [
        "ProjectExec", "GlobalLimitExec", "SortExec", "HashAggregateExec",
        "ShuffleExchangeExec", "HashAggregateExec", "ProjectExec",
        "HashJoinExec", "ShuffleExchangeExec", "FilterExec",
        "InMemoryScanExec", "ShuffleExchangeExec", "ProjectExec",
        "HashJoinExec", "ShuffleExchangeExec", "FilterExec",
        "InMemoryScanExec", "ShuffleExchangeExec", "FilterExec",
        "InMemoryScanExec"]


def _find(plan, name):
    found = []

    def walk(e):
        if e.name == name:
            found.append(e)
        for c in e.children:
            walk(c)
    walk(plan)
    return found


def test_q3_intermediate_counts_match_pyarrow(q3_tables):
    """Rows out of each filter, each join and the final aggregate against
    pyarrow over the same tables."""
    customer, orders, lineitem = q3_tables
    plan = entry.q3_plan(*q3_tables, num_slices=3, shuffle_partitions=5,
                         device="cpu")
    collect(plan)
    groups = entry.q3_groups_reference(*q3_tables)
    day = entry.Q3_DATE
    segs = customer.column("c_mktsegment").to_pylist()
    c_keys = {k for k, s in zip(customer.column("c_custkey").to_pylist(),
                                segs) if s == entry.Q3_SEGMENT}
    o_rows = [(k, c) for k, c, d in zip(
        orders.column("o_orderkey").to_pylist(),
        orders.column("o_custkey").to_pylist(),
        orders.column("o_orderdate").to_pylist()) if d < day]
    co_keys = {k for k, c in o_rows if c in c_keys}
    l_keys = [k for k, d in zip(lineitem.column("l_orderkey").to_pylist(),
                                lineitem.column("l_shipdate").to_pylist())
              if d > day]
    filters = [f.metrics["numOutputRows"].total()
               for f in _find(plan, "FilterExec")]
    assert sorted(filters) == sorted([len(l_keys), len(o_rows),
                                      len(c_keys)])
    outer, inner = _find(plan, "HashJoinExec")
    assert inner.metrics["numOutputRows"].total() == len(co_keys)
    assert outer.metrics["numOutputRows"].total() == sum(
        k in co_keys for k in l_keys)
    final = _find(plan, "HashAggregateExec")[0]
    assert final.metrics["numOutputRows"].total() == groups.num_rows > 10


@pytest.mark.parametrize("sf,slices,partitions,broadcast", [
    (0.0004, 1, 1, False), (0.002, 3, 5, False), (0.002, 4, 2, True),
    (0.0001, 2, 3, False)])
def test_q3_shapes_match_pyarrow(sf, slices, partitions, broadcast):
    tables = entry.tpch_q3_tables(sf, seed=int(sf * 1e4))
    got = entry.run_q3(*tables, num_slices=slices,
                       shuffle_partitions=partitions, broadcast=broadcast,
                       device="cpu")
    assert_q3_equal(got, entry.q3_reference(*tables))


def test_q3_tables_follow_the_spec():
    customer, orders, lineitem = entry.tpch_q3_tables(0.002, seed=1)
    assert customer.num_rows == 300 and orders.num_rows == 3000
    assert customer.column("c_custkey").to_pylist() == list(range(1, 301))
    assert set(customer.column("c_mktsegment").to_pylist()) == \
        set(entry.SEGMENTS)
    okeys = orders.column("o_orderkey").to_numpy()
    assert np.all((okeys - 1) % 32 < 8) and len(set(okeys)) == 3000
    ckeys = orders.column("o_custkey").to_numpy()
    assert ckeys.min() >= 1 and ckeys.max() <= 300
    assert np.all(ckeys % 3 != 0)
    days = orders.column("o_orderdate").cast(pa.int32()).to_numpy()
    assert days.min() >= entry.ORDERDATE_MIN
    assert days.max() <= entry.ORDERDATE_MAX
    assert set(orders.column("o_shippriority").to_pylist()) == {0}
    lines = np.unique(lineitem.column("l_orderkey").to_numpy(),
                      return_counts=True)[1]
    assert lines.min() >= 1 and lines.max() <= 7 and len(lines) == 3000
    by_key = dict(zip(okeys.tolist(), days.tolist()))
    ship = lineitem.column("l_shipdate").cast(pa.int32()).to_numpy()
    lag = ship - np.array([by_key[k] for k in
                           lineitem.column("l_orderkey").to_pylist()])
    assert lag.min() >= 1 and lag.max() <= 121
    disc = lineitem.column("l_discount").to_numpy()
    assert disc.min() >= 0 and disc.max() <= 0.10
    price = lineitem.column("l_extendedprice").to_numpy()
    assert price.min() >= 900 and price.max() <= 50 * 2099.99


@pytest.mark.parametrize("entry_point", ["run_q3", "q3_plan"])
def test_q3_entry_points_ask_for_cuda_by_default(monkeypatch, entry_point):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tables = entry.tpch_q3_tables(0.0001)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        getattr(entry, entry_point)(*tables)


def test_join_slice_modules_load_no_jax():
    modules = ["spark_rapids_tpu_torch.exec.join",
               "spark_rapids_tpu_torch.shuffle.exchange",
               "spark_rapids_tpu_torch.shuffle.partitioning",
               "spark_rapids_tpu_torch.adaptive",
               "spark_rapids_tpu_torch.types",
               "spark_rapids_tpu_torch.expressions.hashing",
               "spark_rapids_tpu_torch.memory.retry",
               "spark_rapids_tpu_torch.entry"]
    code = ("import sys\n" + "".join(f"import {m}\n" for m in modules)
            + "bad = [m for m in sys.modules if m.split('.')[0] in\n"
              "       ('jax', 'jaxlib', 'flax', 'spark_rapids_tpu')]\n"
              "assert not bad, bad\nprint('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
