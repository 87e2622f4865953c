"""TPC-H Q2 through the port on the CPU: the tree node for node against the
JAX Session's ``last_plan`` for the same DataFrame (AQE off, the broadcast
threshold set so that the joins that broadcast at SF100 broadcast here:
the ``nation`` and ``region`` builds), its rows against the JAX Session's
and against pyarrow, and where the port departs from the JAX package on
purpose: Min over a NaN, and a double join key of -0.0 or NaN.

Every column is exact: Q2 reads its values and compares a Min that is one
of its inputs. The JAX Session's ``table()`` takes no string width and
refuses a value over 64 bytes, so the comparison with it runs on tables
whose ``s_comment`` is cut to 64 bytes; the full-width tables are held
against pyarrow. The JAX Session runs once."""

import math

import jax
import numpy as np
import pyarrow as pa
import pyarrow.compute as pc
import pytest

from spark_rapids_tpu import exec as jexec
from spark_rapids_tpu.exec.join import JoinType as JJoinType
from spark_rapids_tpu.exec.sort import SortOrder as JSortOrder
from spark_rapids_tpu.expressions import col as jcol
from spark_rapids_tpu.expressions import lit as jlit
from spark_rapids_tpu.expressions.aggregates import Min as JMin
from spark_rapids_tpu.expressions.aggregates import Sum as JSum
from spark_rapids_tpu.expressions.boolean import And as JAnd
from spark_rapids_tpu.expressions.comparison import EqualTo as JEqualTo
from spark_rapids_tpu.expressions.comparison import GreaterThan as JGreater
from spark_rapids_tpu.expressions.strings import endswith as jendswith
from spark_rapids_tpu.plan import Session, table
from spark_rapids_tpu.shuffle.exchange import \
    BroadcastExchangeExec as JBroadcast
from spark_rapids_tpu_torch import entry
from spark_rapids_tpu_torch.exec import (HashAggregateExec, HashJoinExec,
                                         InMemoryScanExec, JoinType, collect)
from spark_rapids_tpu_torch.expressions import col
from spark_rapids_tpu_torch.expressions.aggregates import Min
from spark_rapids_tpu_torch.shuffle import (BroadcastExchangeExec,
                                            HashPartitioning,
                                            ShuffleExchangeExec)

SF, SLICES, PARTITIONS = 0.01, 2, 2
#: at SF 0.01 the nation and region builds (and their join) are under
#: 1,000 bytes, every supplier, part or partsupp input over: the joins
#: broadcast as at SF100 under the default 10 MiB
THRESHOLD = 1000
CONF = {"spark.rapids.tpu.sql.incompatibleOps.enabled": True,
        "spark.rapids.tpu.sql.adaptive.enabled": False,
        "spark.rapids.tpu.shuffle.partitions": PARTITIONS,
        "spark.rapids.tpu.sql.autoBroadcastJoinThreshold": THRESHOLD}


def cut_comments(supplier: pa.Table) -> pa.Table:
    """``s_comment`` cut to the JAX Session's 64-byte scan width."""
    i = supplier.schema.get_field_index("s_comment")
    return supplier.set_column(i, "s_comment", pc.utf8_slice_codeunits(
        supplier.column("s_comment"), 0, 64))


def jax_scan(t: pa.Table):
    return table(t, num_slices=SLICES, batch_rows=-(-t.num_rows // SLICES))


def jax_q2(part, supplier, partsupp, nation, region):
    """Q2 as a DataFrame of the JAX package: the decorrelated subquery
    (each part's least European cost, renamed) joined on two keys."""
    ps = partsupp.select(list(entry.Q2_COLUMNS["partsupp"]))

    def eu_suppliers():
        regions = jax_scan(region).where(
            JEqualTo(jcol("r_name"), jlit(entry.Q2_REGION)))
        nations = jax_scan(nation).join(regions, ["n_regionkey"],
                                        ["r_regionkey"]) \
            .select("n_nationkey", "n_name")
        return jax_scan(supplier).join(nations, ["s_nationkey"],
                                       ["n_nationkey"])

    mins = (jax_scan(ps).join(eu_suppliers().select("s_suppkey"),
                              ["ps_suppkey"], ["s_suppkey"])
            .group_by("ps_partkey")
            .agg(JMin(jcol("ps_supplycost")).alias("min_cost"))
            .select(jcol("ps_partkey").alias("m_partkey"), jcol("min_cost")))
    parts = jax_scan(part).where(JAnd(
        JEqualTo(jcol("p_size"), jlit(entry.Q2_SIZE)),
        jendswith(jcol("p_type"), entry.Q2_TYPE_SUFFIX)))
    return (parts.join(jax_scan(ps), ["p_partkey"], ["ps_partkey"])
            .join(eu_suppliers(), ["ps_suppkey"], ["s_suppkey"])
            .join(mins, ["p_partkey", "ps_supplycost"],
                  ["m_partkey", "min_cost"])
            .order_by(JSortOrder(jcol("s_acctbal"), True),
                      JSortOrder(jcol("n_name")), JSortOrder(jcol("s_name")),
                      JSortOrder(jcol("p_partkey")))
            .limit(entry.Q2_LIMIT)
            .select(*entry.Q2_SELECT))


def jax_q11(partsupp, supplier, nation, fraction):
    """Q11 as a DataFrame of the JAX package: the HAVING against the
    scalar subquery as a keyless join with the one-row global sum."""
    ps = partsupp.select(list(entry.Q11_COLUMNS["partsupp"]))
    s = supplier.select(list(entry.Q11_COLUMNS["supplier"]))
    n = nation.select(list(entry.Q11_COLUMNS["nation"]))

    def german_rows():
        nations = jax_scan(n).where(JEqualTo(jcol("n_name"),
                                             jlit(entry.Q11_NATION)))
        suppliers = jax_scan(s).join(nations, ["s_nationkey"],
                                     ["n_nationkey"]).select("s_suppkey")
        return jax_scan(ps).join(suppliers, ["ps_suppkey"], ["s_suppkey"])

    def value():
        return jcol("ps_supplycost") * jcol("ps_availqty")

    groups = german_rows().group_by("ps_partkey").agg(
        JSum(value()).alias("value"))
    total = german_rows().agg(JSum(value()).alias("total"))
    cond = JGreater(jcol("value"), jcol("total") * jlit(float(fraction)))
    return (groups.join(total, [], [], JJoinType.INNER, condition=cond)
            .select("ps_partkey", "value")
            .order_by(JSortOrder(jcol("value"), True)))


def node(e):
    """What a tree node must agree on: exec class, join type and build
    mode, partitioning keys and count, aggregate mode, limit, coalesce
    goal, sort keys, and the output columns' names and kinds (the port's
    supplier scan is wider than the JAX Session's)."""
    attrs = [type(e).__name__]
    if hasattr(e, "join_type"):
        attrs += [e.join_type.name, getattr(e, "broadcast_build", None)]
    for keys in ("left_keys", "right_keys"):
        if hasattr(e, keys):
            attrs.append(tuple((k.ordinal, k.dtype.kind.value)
                               for k in getattr(e, keys)))
    part = getattr(e, "partitioning", None)
    if part is not None:
        attrs.append(tuple((k.ordinal, k.dtype.kind.value)
                           for k in getattr(part, "exprs", ())))
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
    attrs.append(tuple((f.name, f.dtype.kind.value)
                       for f in e.output_schema))
    return tuple(attrs)


def tree(e, depth=0):
    out = [(depth,) + node(e)]
    for c in e.children:
        out += tree(c, depth + 1)
    return out


@pytest.fixture(scope="module")
def tables():
    return entry.tpch_q2_tables(SF)


@pytest.fixture(scope="module")
def jax_run(tables):
    """(the JAX Session's rows, its physical tree) for Q2 over the tables
    with ``s_comment`` cut to 64 bytes."""
    part, supplier, partsupp, nation, region = tables
    ses = Session(CONF)
    rows = ses.collect(jax_q2(part, cut_comments(supplier), partsupp,
                              nation, region))
    return rows, ses.last_plan


def _plan(tables, supplier=None):
    part, sup, partsupp, nation, region = tables
    return entry.q2_plan(part, sup if supplier is None else supplier,
                         partsupp, nation, region, SLICES, PARTITIONS,
                         device="cpu")


def test_q2_tree_matches_the_jax_planner(tables, jax_run):
    assert tree(_plan(tables)) == tree(jax_run[1])


def test_q2_matches_the_jax_session(tables, jax_run):
    got = collect(_plan(tables, cut_comments(tables[1])))
    want = jax_run[0]
    assert got.num_rows == want.num_rows > 0
    assert got.equals(want)


def test_q2_matches_pyarrow(tables):
    got = collect(_plan(tables))
    assert got.equals(entry.q2_reference(*tables))
    assert max(len(v) for v in got.column("s_comment").to_pylist()) > 64


def test_q2_limit_cuts_at_100():
    """At SF 0.25 more than 100 rows qualify: the sort and limit keep the
    first 100, as pyarrow does."""
    t = entry.tpch_q2_tables(0.25, seed=4)
    got = collect(entry.q2_plan(*t, num_slices=SLICES,
                                shuffle_partitions=PARTITIONS, device="cpu"))
    want = entry.q2_reference(*t)
    assert got.num_rows == want.num_rows == entry.Q2_LIMIT
    assert got.equals(want)


def test_q2_tables_follow_dbgen():
    part, supplier, partsupp, nation, region = entry.tpch_q2_tables(0.02, 7)
    n_part, n_supp = 4000, 200
    assert part.num_rows == n_part and partsupp.num_rows == 4 * n_part
    assert supplier.num_rows == n_supp
    assert (nation.num_rows, region.num_rows) == (25, 5)
    pk = partsupp.column("ps_partkey").to_numpy()
    sk = partsupp.column("ps_suppkey").to_numpy()
    # dbgen's formula gives each part four distinct suppliers
    pairs = set(zip(pk.tolist(), sk.tolist()))
    assert len(pairs) == partsupp.num_rows
    assert sk.min() >= 1 and sk.max() <= n_supp
    cost = partsupp.column("ps_supplycost").to_numpy()
    assert 1.0 <= cost.min() and cost.max() <= 1000.0
    assert np.allclose(cost * 100, np.round(cost * 100))
    phone = supplier.column("s_phone").to_pylist()
    nk = supplier.column("s_nationkey").to_pylist()
    assert all(p[:2] == str(10 + k) and len(p) == 15
               for p, k in zip(phone, nk))
    lens = pc.utf8_length(supplier.column("s_comment")).to_numpy()
    assert lens.min() >= 25 and lens.max() <= 100
    assert supplier.column("s_name").to_pylist()[0] == "Supplier#000000001"
    assert set(part.column("p_mfgr").to_pylist()) == {
        f"Manufacturer#{m}" for m in range(1, 6)}


def test_min_over_nan_follows_spark_in_q2(tables):
    """The subquery's Min over a cost of NaN: Spark (and the port, and
    pyarrow) skip it unless every cost is NaN, where the JAX package's
    Min is NaN. With a NaN among one qualifying part's European costs,
    the port's Q2 still equals pyarrow's."""
    part, supplier, partsupp, nation, region = tables
    want = entry.q2_reference(*tables)
    key = want.column("p_partkey")[0].as_py()
    cost = partsupp.column("ps_supplycost").to_numpy().copy()
    rows = np.flatnonzero(partsupp.column("ps_partkey").to_numpy() == key)
    best = want.column("s_name")[0].as_py()
    suppkey = int(best.split("#")[1])
    other = [r for r in rows
             if partsupp.column("ps_suppkey")[int(r)].as_py() != suppkey]
    cost[other[0]] = np.nan
    ps = partsupp.set_column(3, "ps_supplycost", pa.array(cost))
    t = (part, supplier, ps, nation, region)
    got = collect(_plan(t))
    assert got.equals(entry.q2_reference(*t))
    assert got.column("p_partkey")[0].as_py() == key
    # the same grouped Min in both packages over that part's four rows
    mine = ps.filter(pc.equal(ps.column("ps_partkey"), key))
    port = collect(HashAggregateExec(
        [col("ps_partkey")], [Min(col("ps_supplycost")).alias("m")],
        InMemoryScanExec(mine, device="cpu")))
    with jax.disable_jit():
        jax_rows = jexec.collect(jexec.HashAggregateExec(
            [jcol("ps_partkey")], [JMin(jcol("ps_supplycost")).alias("m")],
            jexec.InMemoryScanExec(mine), jexec.AggregateMode.COMPLETE))
    finite = np.nanmin(cost[rows])
    assert port.column("m").to_pylist() == [finite]
    assert math.isnan(jax_rows.column("m")[0].as_py())


@pytest.mark.parametrize("broadcast", [True, False],
                         ids=["broadcast", "co-partitioned"])
def test_double_join_key_follows_spark(broadcast):
    """Q2's (bigint, double) key pair: -0.0 joins 0.0 and NaN joins NaN,
    as Spark normalizes join keys; NaN never joins a number. The JAX
    package compares IEEE floats and joins no NaN."""
    nan = float("nan")
    left = pa.table({"k": pa.array([1, 2, 3, 4, 5], pa.int64()),
                     "c": [-0.0, nan, 1.0, nan, 2.5]})
    right = pa.table({"m": pa.array([1, 2, 3, 4, 5], pa.int64()),
                      "mc": [0.0, nan, nan, 2.0, 2.5],
                      "tag": ["a", "b", "c", "d", "e"]})
    lk, rk = [col("k"), col("c")], [col("m"), col("mc")]
    ls = InMemoryScanExec(left, device="cpu")
    rs = InMemoryScanExec(right, device="cpu")
    if broadcast:
        plan = HashJoinExec(lk, rk, JoinType.INNER, ls,
                            BroadcastExchangeExec(rs))
    else:
        plan = HashJoinExec(lk, rk, JoinType.INNER,
                            ShuffleExchangeExec(HashPartitioning(lk, 2), ls),
                            ShuffleExchangeExec(HashPartitioning(rk, 2), rs),
                            broadcast_build=False)
    got = collect(plan)
    assert sorted(got.column("tag").to_pylist()) == ["a", "b", "e"]
    with jax.disable_jit():
        jplan = jexec.HashJoinExec(
            [jcol("k"), jcol("c")], [jcol("m"), jcol("mc")],
            JJoinType.INNER, jexec.InMemoryScanExec(left),
            JBroadcast(jexec.InMemoryScanExec(right)))
        jrows = jexec.collect(jplan)
    assert sorted(jrows.column("tag").to_pylist()) == ["a", "e"]
