"""TPC-H Q9 through the port on the CPU: ``entry.q9_df`` through the
port's Session against the same query through the JAX Session (the same
executed operators, the same rows with the profit within rel 1e-6) and
against pyarrow; what the green filter and the joins keep against a Python
count; and the tables against the spec's domains.

The JAX Session runs once (a module fixture): its cost is the JAX compile
of the plan's five joins."""

import pyarrow as pa
import pyarrow.compute as pc
import pytest

from harness.asserts import assert_tables_equal
from spark_rapids_tpu.exec.sort import SortOrder as JSortOrder
from spark_rapids_tpu.expressions import col as jcol
from spark_rapids_tpu.expressions import lit as jlit
from spark_rapids_tpu.expressions.aggregates import Sum as JSum
from spark_rapids_tpu.expressions.datetime import year as jyear
from spark_rapids_tpu.expressions.strings import contains as jcontains
from spark_rapids_tpu.plan import Session, table
from spark_rapids_tpu_torch import entry
from spark_rapids_tpu_torch.plan import Session as TSession

SF, SLICES = 0.01, 2
CONF = entry.session_conf(SLICES)


def jax_q9(part, supplier, partsupp, lineitem, orders, nation):
    """``entry.q9_df`` written with the JAX package's classes."""
    def scan(t):
        return table(t, num_slices=SLICES,
                     batch_rows=-(-t.num_rows // SLICES))
    green = (scan(part).where(jcontains(jcol("p_name"), entry.Q9_COLOR))
             .select("p_partkey"))
    amount = jcol("l_extendedprice") * (jlit(1.0) - jcol("l_discount")) \
        - jcol("ps_supplycost") * jcol("l_quantity")
    return (scan(lineitem)
            .join(green, ["l_partkey"], ["p_partkey"])
            .join(scan(supplier), ["l_suppkey"], ["s_suppkey"])
            .join(scan(partsupp), ["l_suppkey", "l_partkey"],
                  ["ps_suppkey", "ps_partkey"])
            .join(scan(orders), ["l_orderkey"], ["o_orderkey"])
            .join(scan(nation), ["s_nationkey"], ["n_nationkey"])
            .select(jcol("n_name").alias("nation"),
                    jyear(jcol("o_orderdate")).alias("o_year"),
                    amount.alias("amount"))
            .group_by(*entry.Q9_KEYS)
            .agg(JSum(jcol("amount")).alias("sum_profit"))
            .order_by(JSortOrder(jcol("nation")),
                      JSortOrder(jcol("o_year"), True)))


@pytest.fixture(scope="module")
def q9_jax():
    tables = entry.tpch_q9_tables(SF)
    ses = Session(CONF)
    result = ses.collect(jax_q9(*tables))
    return tables, result, ses.executed_exec_names()


def test_q9_matches_jax_session_and_pyarrow(q9_jax):
    tables, jax_result, jax_names = q9_jax
    ses = TSession(CONF, device="cpu")
    got = ses.collect(entry.q9_df(*tables, SLICES))
    assert got.schema == pa.schema([("nation", pa.string()),
                                    ("o_year", pa.int32()),
                                    ("sum_profit", pa.float64())])
    assert ses.executed_exec_names() == jax_names
    assert jax_names.count("HashJoinExec") == 5
    assert ses.fell_back() == []
    assert got.num_rows > 150        # 25 nations x 7 years, nearly all
    # the ORDER BY is total: positions are compared, floats within 1e-6
    assert_tables_equal(got, jax_result, ignore_order=False)
    assert_tables_equal(got, entry.q9_reference(*tables), ignore_order=False)


def test_run_q9_matches_pyarrow_at_other_shapes():
    tables = entry.tpch_q9_tables(0.005, seed=9)
    got = entry.run_q9(*tables, 3, 5, device="cpu")
    assert_tables_equal(got, entry.q9_reference(*tables), ignore_order=False)


def test_q9_green_lines_against_a_python_count():
    """The lines Q9 sums are those whose part's name holds 'green': per
    nation and year, the count of summed lines against Python over the
    rows."""
    part, supplier, partsupp, lineitem, orders, nation = \
        entry.tpch_q9_tables(SF, seed=4)
    green = {k for k, n in zip(part.column("p_partkey").to_pylist(),
                               part.column("p_name").to_pylist())
             if "green" in n.split(" ")}
    nation_of = dict(zip(supplier.column("s_suppkey").to_pylist(),
                         supplier.column("s_nationkey").to_pylist()))
    names = nation.column("n_name").to_pylist()
    year_of = {k: d.year for k, d in zip(
        orders.column("o_orderkey").to_pylist(),
        orders.column("o_orderdate").to_pylist())}
    want = {}
    for ok, pk, sk in zip(*[lineitem.column(c).to_pylist() for c in
                            ("l_orderkey", "l_partkey", "l_suppkey")]):
        if pk in green:
            key = (names[nation_of[sk]], year_of[ok])
            want[key] = want.get(key, 0) + 1
    from spark_rapids_tpu_torch.expressions import col, contains, year
    from spark_rapids_tpu_torch.expressions.aggregates import Count
    df = (entry._df(lineitem, SLICES)
          .join(entry._df(part, SLICES)
                .where(contains(col("p_name"), entry.Q9_COLOR))
                .select("p_partkey"), ["l_partkey"], ["p_partkey"])
          .join(entry._df(supplier, SLICES), ["l_suppkey"], ["s_suppkey"])
          .join(entry._df(orders, SLICES), ["l_orderkey"], ["o_orderkey"])
          .join(entry._df(nation, SLICES), ["s_nationkey"], ["n_nationkey"])
          .select(col("n_name").alias("nation"),
                  year(col("o_orderdate")).alias("o_year"))
          .group_by("nation", "o_year").agg(Count().alias("n")))
    got = TSession(CONF, device="cpu").collect(df)
    assert {(r["nation"], r["o_year"]): r["n"] for r in got.to_pylist()} \
        == want
    assert sum(want.values()) > 1000


def test_q9_tables_follow_the_spec():
    part, supplier, partsupp, lineitem, orders, nation = \
        entry.tpch_q9_tables(0.05, seed=2)
    assert (part.num_rows, supplier.num_rows, partsupp.num_rows,
            nation.num_rows) == (10_000, 500, 40_000, 25)
    assert len(entry.P_NAME_WORDS) == len(set(entry.P_NAME_WORDS)) == 92
    words = [n.split(" ") for n in part.column("p_name").to_pylist()]
    assert all(len(w) == 5 == len(set(w)) for w in words)
    assert all(set(w) <= set(entry.P_NAME_WORDS) for w in words)
    assert max(pc.utf8_length(part.column("p_name")).to_pylist()) <= 55
    # every line's supplier is one of its part's four
    pairs = set(zip(partsupp.column("ps_partkey").to_pylist(),
                    partsupp.column("ps_suppkey").to_pylist()))
    assert all(p in pairs for p in zip(
        lineitem.column("l_partkey").to_pylist(),
        lineitem.column("l_suppkey").to_pylist()))
    assert len(pairs) == partsupp.num_rows
    # the part keys are drawn last: Q3's and Q18's columns do not move
    _, q3_orders, q3_li = entry.tpch_q3_tables(0.05, seed=2)
    _, _, q18_li = entry.tpch_q18_tables(0.05, seed=2)
    assert lineitem.column("l_orderkey").equals(q3_li.column("l_orderkey"))
    assert lineitem.column("l_quantity").equals(q18_li.column("l_quantity"))
    assert orders.column("o_orderdate").equals(
        q3_orders.column("o_orderdate"))
