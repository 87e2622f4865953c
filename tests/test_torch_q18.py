"""The memory-runtime slice as a whole: TPC-H Q18 through the port on the
CPU against pyarrow, against the JAX Session running the same DataFrame
(AQE off, every join shuffled, 2 shuffle partitions, a small
``maxBuildRows``) node for node and row for row while the port runs under a
small device budget, so its exchanges spill and its last join takes the
grace join, and clean against under injected OOMs, bit for bit. Every
column is exact: ``o_totalprice`` is read, not computed, and ``sum_qty``
adds whole numbers. Each ends with no pins and no handles in the catalog.

At these scale factors no order passes Q18's validation QUANTITY of 300
(58 do at SF1), so the runs use its ``quantity`` parameter at 200."""

import numpy as np
import pyarrow as pa
import pytest

from spark_rapids_tpu.exec.join import JoinType as JJoinType
from spark_rapids_tpu.exec.sort import SortOrder as JSortOrder
from spark_rapids_tpu.expressions import col as jcol
from spark_rapids_tpu.expressions import lit as jlit
from spark_rapids_tpu.expressions.aggregates import Sum as JSum
from spark_rapids_tpu.expressions.comparison import GreaterThan as JGreater
from spark_rapids_tpu.plan import Session, table
from spark_rapids_tpu_torch import entry
from spark_rapids_tpu_torch.exec import collect
from spark_rapids_tpu_torch.memory.retry import metrics, oom_injection

SF, SLICES, PARTITIONS, QUANTITY = 0.005, 8, 2, 200.0
#: lineitem holds ~30k rows at SF 0.005, ~15k a partition: 2 buckets
MAX_BUILD_ROWS = 9000
#: a device budget below what the exchanges register, above one
#: partition's read
BUDGET = 600_000

CONF = {"spark.rapids.tpu.sql.incompatibleOps.enabled": True,
        "spark.rapids.tpu.sql.adaptive.enabled": False,
        "spark.rapids.tpu.shuffle.partitions": PARTITIONS,
        "spark.rapids.tpu.sql.autoBroadcastJoinThreshold": 0,
        "spark.rapids.tpu.sql.join.maxBuildRows": MAX_BUILD_ROWS}


@pytest.fixture(scope="module")
def tables():
    return entry.tpch_q18_tables(SF)


def _plan(tables, **kw):
    args = dict(num_slices=SLICES, shuffle_partitions=PARTITIONS,
                device="cpu", quantity=QUANTITY)
    args.update(kw)
    return entry.q18_plan(*tables, **args)


def _jax_q18(customer, orders, lineitem):
    """Q18 as a DataFrame of the JAX package: the IN subquery as a semi
    join, tables in the FROM order."""
    def scan(t):
        return table(t, num_slices=SLICES,
                     batch_rows=-(-t.num_rows // SLICES))
    big = (scan(lineitem).group_by("l_orderkey")
           .agg(JSum(jcol("l_quantity")).alias("sq"))
           .where(JGreater(jcol("sq"), jlit(QUANTITY))))
    return (scan(customer)
            .join(scan(orders).join(big, ["o_orderkey"], ["l_orderkey"],
                                    JJoinType.LEFT_SEMI),
                  ["c_custkey"], ["o_custkey"])
            .join(scan(lineitem), ["o_orderkey"], ["l_orderkey"])
            .group_by(*entry.Q18_KEYS)
            .agg(JSum(jcol("l_quantity")).alias("sum_qty"))
            .order_by(JSortOrder(jcol("o_totalprice"), True),
                      JSortOrder(jcol("o_orderdate")))
            .limit(entry.Q18_LIMIT))


def _node(e):
    """Exec class, join type and build mode, partitioning keys and count,
    aggregate mode, limit, coalesce goal and sort keys."""
    attrs = [type(e).__name__]
    if hasattr(e, "join_type"):
        attrs += [e.join_type.name, e.broadcast_build, e.max_build_rows]
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
    if hasattr(e, "orders"):
        attrs.append(tuple((o.child.ordinal, o.descending)
                           for o in e.orders))
    attrs.append(tuple((f.name, str(f.dtype)) for f in e.output_schema))
    return tuple(attrs)


def _tree(e, depth=0):
    out = [(depth,) + _node(e)]
    for c in e.children:
        out += _tree(c, depth + 1)
    return out


def _execs(plan, name):
    found = [plan] if plan.name == name else []
    for c in plan.children:
        found += _execs(c, name)
    return found


def _assert_clean(cat):
    assert cat.total_pinned() == 0, cat.dump_state()
    assert not cat._entries, cat.leak_check()


def test_q18_matches_pyarrow(tables):
    # a catalog of its own: the process-wide one is shared with other tests
    plan = _plan(tables, device_limit=1 << 30)
    got = collect(plan)
    want = entry.q18_reference(*tables, quantity=QUANTITY)
    groups = entry.q18_groups_reference(*tables, quantity=QUANTITY)
    assert got.num_rows == entry.Q18_LIMIT < groups.num_rows
    assert got.equals(want)
    assert got.schema == pa.schema([
        ("c_name", pa.string()), ("c_custkey", pa.int64()),
        ("o_orderkey", pa.int64()), ("o_orderdate", pa.date32()),
        ("o_totalprice", pa.float64()), ("sum_qty", pa.float64())])
    final = _execs(plan, "HashAggregateExec")[0]
    assert final.metrics["numOutputRows"].total() == groups.num_rows
    _assert_clean(plan.catalog)


def test_q18_spills_and_grace_joins_to_the_jax_sessions_rows(tables):
    """The JAX planner's tree for the same DataFrame, node for node, and
    its rows, while the port's run spills under a small budget and its
    last join takes the grace join in both partitions."""
    ses = Session(CONF)
    want = ses.collect(_jax_q18(*tables))
    plan = _plan(tables, device_limit=BUDGET, max_build_rows=MAX_BUILD_ROWS)
    assert _tree(plan) == _tree(ses.last_plan)
    got = collect(plan)
    assert got.num_rows == entry.Q18_LIMIT
    assert got.equals(want)
    cat = plan.catalog
    assert cat.device_limit == BUDGET
    assert cat.spilled_to_host > 0
    joins = _execs(plan, "HashJoinExec")
    assert [j.join_type.name for j in joins] == ["INNER", "INNER",
                                                 "LEFT_SEMI"]
    # lineitem's ~15k rows a partition over 9000: 2 buckets a partition
    assert joins[0].metrics["graceBuckets"].total() == 2 * PARTITIONS
    assert all(j.metrics["graceBuckets"].total() == 0 for j in joins[1:])
    _assert_clean(cat)


def test_q18_under_injected_ooms_is_bit_identical(tables):
    """every-1: every allocation check fails once; the retry loop recovers
    each, to the clean run's table exactly."""
    clean_plan = _plan(tables, device_limit=BUDGET,
                       max_build_rows=MAX_BUILD_ROWS)
    clean = collect(clean_plan)
    _assert_clean(clean_plan.catalog)
    m0 = metrics().snapshot()
    with oom_injection("every-1") as inj:
        plan = _plan(tables, device_limit=BUDGET,
                     max_build_rows=MAX_BUILD_ROWS)
        injected = collect(plan)
        assert inj.injected > 0
    assert metrics().snapshot()["retryCount"] > m0["retryCount"]
    assert injected.equals(clean)
    _assert_clean(plan.catalog)


def test_q18_tables_keep_q3s_draws():
    """Q18's columns come from the same draws as Q3's, and Q3's columns
    do not move: o_totalprice is the sum of its lines' charges."""
    c3, o3, l3 = entry.tpch_q3_tables(0.002, seed=5)
    c, o, li = entry.tpch_q18_tables(0.002, seed=5)
    assert c.column("c_custkey").equals(c3.column("c_custkey"))
    for name in ("o_orderkey", "o_custkey", "o_orderdate"):
        assert o.column(name).equals(o3.column(name))
    assert li.column("l_orderkey").equals(l3.column("l_orderkey"))
    names = c.column("c_name").to_pylist()
    assert names[:2] == ["Customer#000000001", "Customer#000000002"]
    assert names[-1] == f"Customer#{c.num_rows:09d}"
    q = li.column("l_quantity").to_numpy()
    assert q.dtype == np.float64 and q.min() >= 1 and q.max() <= 50
    assert np.all(q == np.round(q))
    price = o.column("o_totalprice").to_numpy()
    ext = l3.column("l_extendedprice").to_numpy()
    disc = l3.column("l_discount").to_numpy()
    keys = li.column("l_orderkey").to_numpy()
    first = keys == o.column("o_orderkey").to_numpy()[0]
    tax_lo = (ext[first] * (1 - disc[first])).sum()
    assert tax_lo <= price[0] <= tax_lo * 1.08 + 1e-9
