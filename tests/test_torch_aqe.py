"""Adaptive execution at the exchanges, the port against the JAX package on
the CPU: for the same skewed inputs the reader specs that
``coordinate_join_reads`` lays out and the decision reasons equal the JAX
package's (coalesce, skew split, and the split suppressed for RIGHT and FULL
outer joins), the skew split and the runtime broadcast switch give the
static plan's rows bit for bit, the switch never fires for a RIGHT outer
join, ``presplit_inputs`` cuts before the first attempt, and a replicated
build piece stays in the catalog, spillable, until its last read. Then the
skew bench's three legs and TPC-H Q3 and Q18 under adaptive confs: each tree
equal to the JAX Session's ``last_plan`` under the same conf, node for node,
each decision list equal to the Session's, and each result equal to pyarrow.
Each JAX Session collect runs once, in a fixture of its own."""

import numpy as np
import pyarrow as pa
import pytest

from spark_rapids_tpu import exec as jexec
from spark_rapids_tpu.exec.join import JoinType as JJoinType
from spark_rapids_tpu.exec.sort import SortOrder as JSortOrder
from spark_rapids_tpu.expressions import col as jcol
from spark_rapids_tpu.expressions import lit as jlit
from spark_rapids_tpu.expressions.aggregates import Count as JCount
from spark_rapids_tpu.expressions.aggregates import Sum as JSum
from spark_rapids_tpu.expressions.comparison import EqualTo as JEqualTo
from spark_rapids_tpu.expressions.comparison import GreaterThan as JGreater
from spark_rapids_tpu.expressions.comparison import LessThan as JLess
from spark_rapids_tpu.plan import Session, table
from spark_rapids_tpu.plan import adaptive as jadaptive
from spark_rapids_tpu.shuffle import HashPartitioning as JHashPartitioning
from spark_rapids_tpu.shuffle import ShuffleExchangeExec as JExchange
from spark_rapids_tpu_torch import adaptive, entry
from spark_rapids_tpu_torch.batch import to_arrow
from spark_rapids_tpu_torch.exec import (HashJoinExec, InMemoryScanExec,
                                         JoinType, collect)
from spark_rapids_tpu_torch.expressions import col
from spark_rapids_tpu_torch.memory import BufferCatalog, SpillableInput
from spark_rapids_tpu_torch.memory.retry import (metrics, presplit_inputs,
                                                 split_input_halves,
                                                 with_retry)
from spark_rapids_tpu_torch.shuffle import (HashPartitioning,
                                            ShuffleExchangeExec)
from tests.harness.asserts import rows_of

K = "spark.rapids.tpu."


def _rows(plan):
    out = []
    for p in range(plan.num_partitions):
        for b in plan.execute_partition(p):
            out += rows_of(to_arrow(b, plan.output_schema))
    return sorted(out, key=lambda r: tuple((x is None, x or 0) for x in r))


# ---------------------------------------------------------------------------
# coordinate_join_reads: the reader specs and reasons of the JAX package
# ---------------------------------------------------------------------------

def _skew_inputs():
    """``tests/test_aqe_cbo.py``'s shape: 70% of 1,500 stream rows on key 7,
    a 40-row build."""
    rng = np.random.default_rng(171)
    n = 1500
    k = np.where(rng.random(n) < 0.7, 7,
                 rng.integers(0, 40, n)).astype(np.int64)
    left = pa.table({"k": k, "v": rng.integers(0, 9, n).astype(np.int64)})
    right = pa.table({"rk": np.arange(40, dtype=np.int64),
                      "w": rng.integers(0, 9, 40).astype(np.int64)})
    return left, right


def _port_join(how, left, right, catalog=None, **kw):
    lex = ShuffleExchangeExec(
        HashPartitioning([col("k")], 6),
        InMemoryScanExec(left, batch_rows=150, device="cpu",
                         catalog=catalog),
        adaptive=True, target_rows=400)
    rex = ShuffleExchangeExec(
        HashPartitioning([col("rk")], 6),
        InMemoryScanExec(right, batch_rows=10, device="cpu",
                         catalog=catalog),
        adaptive=True, target_rows=400)
    return HashJoinExec([col("k")], [col("rk")], how, lex, rex,
                        broadcast_build=False, **kw)


def _jax_join(how, left, right, **kw):
    lex = JExchange(JHashPartitioning([jcol("k")], 6),
                    jexec.InMemoryScanExec(left, batch_rows=150),
                    adaptive=True, target_rows=400)
    rex = JExchange(JHashPartitioning([jcol("rk")], 6),
                    jexec.InMemoryScanExec(right, batch_rows=10),
                    adaptive=True, target_rows=400)
    return jexec.HashJoinExec([jcol("k")], [jcol("rk")], JJoinType(how.value),
                              lex, rex, broadcast_build=False, **kw)


def _brute(left, right, how):
    lk, lv = left.column("k").to_pylist(), left.column("v").to_pylist()
    rk, rw = right.column("rk").to_pylist(), right.column("w").to_pylist()
    out, matched = [], set()
    for i, kk in enumerate(lk):
        hit = False
        for j, rr in enumerate(rk):
            if kk == rr:
                out.append((kk, lv[i], rr, rw[j]))
                matched.add(j)
                hit = True
        if not hit and how in (JoinType.LEFT_OUTER, JoinType.FULL_OUTER):
            out.append((kk, lv[i], None, None))
    if how in (JoinType.RIGHT_OUTER, JoinType.FULL_OUTER):
        out += [(None, None, rr, rw[j]) for j, rr in enumerate(rk)
                if j not in matched]
    return sorted(out, key=lambda r: tuple((x is None, x or 0) for x in r))


@pytest.mark.parametrize("how", [JoinType.INNER, JoinType.LEFT_OUTER,
                                 JoinType.RIGHT_OUTER, JoinType.FULL_OUTER],
                         ids=lambda j: j.name)
def test_reader_specs_and_reasons_match_jax(how):
    left, right = _skew_inputs()
    mark, jmark = adaptive.reason_mark(), jadaptive.reason_mark()
    m0, jm0 = adaptive.metrics().snapshot(), jadaptive.metrics().snapshot()
    join = _port_join(how, left, right, skew_split_rows=300)
    jjoin = _jax_join(how, left, right, skew_split_rows=300)
    assert join.num_partitions == jjoin.num_partitions
    # the decision counters move as the JAX package's do
    m1, jm1 = adaptive.metrics().snapshot(), jadaptive.metrics().snapshot()
    assert {k: v - m0[k] for k, v in m1.items()} == \
        {k: jm1[k] - jm0[k] for k in m1}
    assert join.left._specs == jjoin.left._specs
    assert join.right._specs == jjoin.right._specs
    assert adaptive.reasons(since=mark) == jadaptive.reasons(since=jmark)
    split = how in (JoinType.INNER, JoinType.LEFT_OUTER)
    b_origins = [mp for s in join.right._specs for mp, _, _ in s]
    # the build partition is replicated only where the split happened
    assert (len(b_origins) > len(set(b_origins))) == split
    assert any(r.startswith("skewSplit:") for r in
               adaptive.reasons(since=mark)) == split
    got = _rows(join)
    join.close()
    assert got == _brute(left, right, how)


@pytest.mark.parametrize("how", [JoinType.INNER, JoinType.LEFT_OUTER],
                         ids=lambda j: j.name)
def test_skew_split_bit_for_bit_under_a_spilling_budget(how):
    """The split layout gives the static layout's rows, and under a
    budget that spills, every replicated build piece comes back for each
    reader and leaves the catalog after its last read."""
    left, right = _skew_inputs()
    cat = BufferCatalog(100_000)
    join = _port_join(how, left, right, catalog=cat, skew_split_rows=300)
    n = join.num_partitions
    rex = join.right
    replicated = [key for key, uses in rex._use_left.items() if uses > 1]
    assert replicated
    got = []
    for p in range(n):
        for b in join.execute_partition(p):
            got += rows_of(to_arrow(b, join.output_schema))
        # a replicated piece stays registered until its last read
        for key in replicated:
            sb = rex._materialized[key[0]][key[1]][0]
            assert sb._open == (rex._use_left[key] > 0)
    assert cat.spilled_to_host > 0 and cat.unspilled > 0
    assert not cat._entries
    join.close()
    got.sort(key=lambda r: tuple((x is None, x or 0) for x in r))
    static = _port_join(how, left, right)
    static.left.adaptive = static.right.adaptive = False
    assert got == _rows(static) == _brute(left, right, how)


def test_runtime_broadcast_switch_and_close_restores_the_plan():
    left, right = _skew_inputs()
    join = _port_join(JoinType.INNER, left, right,
                      broadcast_switch_rows=100)
    for _ in range(2):       # a second run decides again
        mark = adaptive.reason_mark()
        got = _rows(join)
        reasons = adaptive.reasons(since=mark)
        assert join.broadcast_build
        assert reasons[0] == (
            "broadcastSwitch: shuffled INNER join: build side measured 40 "
            "rows <= maxBuildRows=100 -> replicating build (runtime "
            "broadcast)")
        join.close()
        assert not join.broadcast_build
        assert got == _brute(left, right, JoinType.INNER)


@pytest.mark.parametrize("how", [JoinType.RIGHT_OUTER, JoinType.FULL_OUTER],
                         ids=lambda j: j.name)
def test_broadcast_switch_never_fires_for_build_tails(how):
    left, right = _skew_inputs()
    join = _port_join(how, left, right, broadcast_switch_rows=100_000)
    mark = adaptive.reason_mark()
    got = _rows(join)
    assert not any(r.startswith("broadcastSwitch:")
                   for r in adaptive.reasons(since=mark))
    assert not join.broadcast_build
    join.close()
    assert got == _brute(left, right, how)


def test_presplit_cuts_oversized_input_before_first_attempt():
    class FakeInput:
        def __init__(self, lo, hi):
            self.lo, self.hi = lo, hi
            self.rows = hi - lo
            self.name = "fake"

        def split(self, floor_rows):
            if self.rows <= max(floor_rows, 1) or self.rows < 2:
                return None
            mid = self.lo + self.rows // 2
            return [FakeInput(self.lo, mid), FakeInput(mid, self.hi)]

    pre0 = metrics().snapshot()["preSplitCount"]
    out = presplit_inputs(FakeInput(0, 4000), 1000)
    assert len(out) >= 4 and all(c.rows <= 1000 for c in out)
    spans = [(c.lo, c.hi) for c in out]
    assert spans[0][0] == 0 and spans[-1][1] == 4000
    assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
    assert metrics().snapshot()["preSplitCount"] == pre0 + len(out) - 1
    small = FakeInput(0, 1000)
    assert presplit_inputs(small, 1000) == [small]


def test_with_retry_presplit_rows_keeps_row_order():
    from spark_rapids_tpu_torch.batch import from_arrow
    t = pa.table({"x": np.arange(5000, dtype=np.int64)})
    batch, schema = from_arrow(t, device="cpu")
    cat = BufferCatalog(1 << 30)
    inp = SpillableInput.from_batch(batch, schema, cat)
    pre0 = metrics().snapshot()["preSplitCount"]

    def body(item):
        b = item.acquire()
        try:
            return b.columns[0].data[:int(b.num_rows)].tolist()
        finally:
            item.release()

    parts = list(with_retry(inp, body, split=split_input_halves,
                            catalog=cat, name="t", presplit_rows=1500))
    assert len(parts) == 4 and max(map(len, parts)) <= 1500
    assert sum(parts, []) == list(range(5000))
    assert metrics().snapshot()["preSplitCount"] == pre0 + 3
    assert not cat._entries


# ---------------------------------------------------------------------------
# whole trees against the JAX Session
# ---------------------------------------------------------------------------

def _node(e):
    """Exec class, join type, build mode and AQE knobs, partitioning,
    exchange adaptivity, aggregate mode, limit and coalesce goal."""
    attrs = [type(e).__name__]
    if hasattr(e, "join_type"):
        attrs += [e.join_type.name, e.broadcast_build, e.skew_split_rows,
                  e.broadcast_switch_rows]
    part = getattr(e, "partitioning", None)
    if part is not None:
        attrs += [type(part).__name__, part.num_partitions, e.adaptive,
                  e.target_rows]
        attrs.append(tuple((k.ordinal, str(k.dtype))
                           for k in getattr(part, "exprs", ())))
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


def _session_run(conf, df):
    ses = Session(conf)
    mark = jadaptive.reason_mark()
    result = ses.collect(df)
    return result, ses.last_plan, jadaptive.reasons(since=mark)


def _port_run(plan_fn):
    mark = adaptive.reason_mark()
    plan = plan_fn()
    result = collect(plan)
    return result, plan, adaptive.reasons(since=mark)


SKEW = dict(rows=1024, keys=32, split_rows=128, slices=4, parts=4,
            target=300)


@pytest.fixture(scope="module")
def skew_tables():
    return entry.skew_tables(SKEW["rows"], SKEW["keys"])


def _skew_conf(leg):
    base = {K + "sql.autoBroadcastJoinThreshold": "0",
            K + "shuffle.partitions": str(SKEW["parts"]),
            K + "sql.adaptive.coalescePartitions.targetRows":
                str(SKEW["target"])}
    if leg == "static":
        return {**base, K + "sql.adaptive.enabled": "false"}
    conf = {**base, K + "sql.adaptive.enabled": "true",
            K + "sql.adaptive.skewJoin.splitRows": str(SKEW["split_rows"]),
            K + "sql.adaptive.broadcastJoin.enabled":
                str(leg == "adaptive_bcast").lower()}
    if leg == "adaptive_bcast":
        conf[K + "sql.adaptive.broadcastJoin.maxBuildRows"] = \
            str(max(SKEW["keys"], 1 << 16))
    return conf


@pytest.fixture(scope="module", params=entry.SKEW_LEGS)
def skew_leg(request, skew_tables):
    leg = request.param
    fact, dim = skew_tables
    slices = SKEW["slices"]
    df = (table(fact, num_slices=slices,
                batch_rows=max(1, fact.num_rows // slices))
          .join(table(dim), ["k"], ["dk"], JJoinType.INNER)
          .group_by("g")
          .agg(JSum(jcol("v")).alias("sv"), JSum(jcol("w")).alias("sw"),
               JCount().alias("c"))
          .order_by("g"))
    return leg, _session_run(_skew_conf(leg), df)


def test_skew_legs_match_the_jax_session(skew_tables, skew_leg):
    leg, (jresult, jplan, jreasons) = skew_leg
    fact, dim = skew_tables
    result, plan, reasons = _port_run(lambda: entry.skew_plan(
        fact, dim, leg, split_rows=SKEW["split_rows"],
        num_slices=SKEW["slices"], shuffle_partitions=SKEW["parts"],
        target_rows=SKEW["target"], device="cpu"))
    assert _tree(plan) == _tree(jplan)
    assert reasons == jreasons
    assert (leg == "static") == (reasons == [])
    assert result.equals(jresult)
    assert result.equals(entry.skew_reference(fact, dim))


Q3 = dict(sf=0.001, slices=2, parts=4, target=800, split=500, bswitch=50)


def _jax_q3(customer, orders, lineitem):
    def scan(t):
        return table(t, num_slices=Q3["slices"],
                     batch_rows=-(-t.num_rows // Q3["slices"]))
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


@pytest.fixture(scope="module")
def q3_run():
    tables = entry.tpch_q3_tables(Q3["sf"])
    conf = {K + "sql.incompatibleOps.enabled": True,
            K + "sql.adaptive.enabled": True,
            K + "sql.autoBroadcastJoinThreshold": 0,
            K + "shuffle.partitions": Q3["parts"],
            K + "sql.adaptive.coalescePartitions.targetRows": Q3["target"],
            K + "sql.adaptive.skewJoin.splitRows": Q3["split"],
            K + "sql.adaptive.broadcastJoin.maxBuildRows": Q3["bswitch"]}
    return tables, _session_run(conf, _jax_q3(*tables))


def test_q3_adaptive_matches_the_jax_session(q3_run):
    from tests.test_torch_q3 import assert_q3_equal
    tables, (jresult, jplan, jreasons) = q3_run
    result, plan, reasons = _port_run(lambda: entry.q3_plan(
        *tables, num_slices=Q3["slices"], shuffle_partitions=Q3["parts"],
        device="cpu", adaptive=True, target_rows=Q3["target"],
        skew_split_rows=Q3["split"], broadcast_switch_rows=Q3["bswitch"]))
    assert _tree(plan) == _tree(jplan)
    assert reasons == jreasons
    assert any(r.startswith("skewSplit:") for r in reasons)
    assert_q3_equal(result, jresult)
    assert_q3_equal(result, entry.q3_reference(*tables))


Q18 = dict(sf=0.005, slices=8, parts=2, quantity=200.0, max_build=9000)


def _jax_q18(customer, orders, lineitem):
    def scan(t):
        return table(t, num_slices=Q18["slices"],
                     batch_rows=-(-t.num_rows // Q18["slices"]))
    big = (scan(lineitem).group_by("l_orderkey")
           .agg(JSum(jcol("l_quantity")).alias("sq"))
           .where(JGreater(jcol("sq"), jlit(Q18["quantity"]))))
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


@pytest.fixture(scope="module")
def q18_run():
    tables = entry.tpch_q18_tables(Q18["sf"])
    conf = {K + "sql.incompatibleOps.enabled": True,
            K + "sql.adaptive.enabled": True,
            K + "shuffle.partitions": Q18["parts"],
            K + "sql.autoBroadcastJoinThreshold": 0,
            K + "sql.join.maxBuildRows": Q18["max_build"]}
    return tables, _session_run(conf, _jax_q18(*tables))


def test_q18_adaptive_matches_the_jax_session(q18_run):
    tables, (jresult, jplan, jreasons) = q18_run
    budget = 600_000
    result, plan, reasons = _port_run(lambda: entry.q18_plan(
        *tables, num_slices=Q18["slices"], shuffle_partitions=Q18["parts"],
        device_limit=budget, max_build_rows=Q18["max_build"], device="cpu",
        quantity=Q18["quantity"], adaptive=True))
    assert _tree(plan) == _tree(jplan)
    assert reasons == jreasons
    assert any(r.startswith("broadcastSwitch: shuffled LeftSemi") or
               r.startswith("broadcastSwitch: shuffled LEFT_SEMI")
               for r in reasons)
    assert result.equals(jresult)
    assert result.equals(entry.q18_reference(*tables, Q18["quantity"]))
    assert not plan.catalog._entries
