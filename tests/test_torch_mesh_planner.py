"""The port's ICI Session on the CPU against the JAX package's: the 11
cases of ``test_mesh_planner.py`` through
``Session({"spark.rapids.tpu.shuffle.mode": "ICI"}, device="cpu")`` and
the JAX Session under the same conf, 8 shards on each side (the port's
all on the CPU, the JAX package's planned over its 8 virtual CPU
devices). Each case's rows must equal the JAX Session's (floats within
rel 1e-6) and its lowering decision too: the same
``MeshStageExec.lowered`` list, or the host path in both.

Besides: the join -> aggregate -> sort chain under AQE off, lowered in
both with four exchanges, and TPC-H Q1 at SF 0.01 lowered whole under
``entry.session_conf``. In every case the JAX ICI Session plans and
lowers the query (``prepare``) and the JAX rows come from the JAX host
path under the same conf: no JAX ICI program is collected here (see
``both``)."""

import pyarrow as pa

from spark_rapids_tpu.exec.join import JoinType as JJoinType
from spark_rapids_tpu.exec.sort import asc as jasc
from spark_rapids_tpu.exec.sort import desc as jdesc
from spark_rapids_tpu.expressions import col as jcol
from spark_rapids_tpu.expressions import lit as jlit
from spark_rapids_tpu.expressions.aggregates import Count as JCount
from spark_rapids_tpu.expressions.aggregates import Max as JMax
from spark_rapids_tpu.expressions.aggregates import Min as JMin
from spark_rapids_tpu.expressions.aggregates import Sum as JSum
from spark_rapids_tpu.plan import Session as JSession
from spark_rapids_tpu.plan import table as jtable
from spark_rapids_tpu_torch import entry
from spark_rapids_tpu_torch.exec import JoinType, asc, desc
from spark_rapids_tpu_torch.expressions import col, lit
from spark_rapids_tpu_torch.expressions.aggregates import (Count, Max, Min,
                                                           Sum)
from spark_rapids_tpu_torch.parallel.lowering import MeshStageExec
from spark_rapids_tpu_torch.plan import Session, table

from harness.asserts import assert_rows_equal, assert_tables_equal, rows_of
from harness.data_gen import IntegerGen, LongGen, gen_table
from test_torch_session import _jax_q1

ICI = {"spark.rapids.tpu.shuffle.mode": "ICI",
       "spark.rapids.tpu.mesh.devices": 8}
NO_BROADCAST = dict(ICI)
NO_BROADCAST["spark.rapids.tpu.sql.autoBroadcastJoinThreshold"] = 0
NO_AQE = dict(NO_BROADCAST)
NO_AQE["spark.rapids.tpu.sql.adaptive.enabled"] = False

FACT = gen_table([("k", IntegerGen(min_val=0, max_val=40)),
                  ("g", IntegerGen(min_val=0, max_val=6)),
                  ("v", LongGen(min_val=-1000, max_val=1000))],
                 n=1200, seed=400)
DIM = gen_table([("dk", IntegerGen(min_val=0, max_val=40, null_prob=0.0)),
                 ("w", LongGen(min_val=0, max_val=9))], n=41, seed=401)


class _Api:
    def __init__(self, **kw):
        self.__dict__.update(kw)


JAX = _Api(table=jtable, col=jcol, lit=jlit, Sum=JSum, Count=JCount,
           Min=JMin, Max=JMax, JoinType=JJoinType, asc=jasc, desc=jdesc)
PORT = _Api(table=table, col=col, lit=lit, Sum=Sum, Count=Count, Min=Min,
            Max=Max, JoinType=JoinType, asc=asc, desc=desc)


def lowered(ses):
    """The stage's lowered list, or None on the host path."""
    plan = ses.last_plan
    return plan.lowered if type(plan).__name__ == "MeshStageExec" else None


def assert_sorted_equal(got, want, keys):
    """The same order on the sort keys ``keys``, and the same rows within
    each run of equal keys (ties may leave either package in any order)."""
    g, w = rows_of(got), rows_of(want)
    assert [tuple(r[i] for i in keys) for r in g] == \
        [tuple(r[i] for i in keys) for r in w]
    assert_rows_equal(g, w, ignore_order=True)


def host_conf(conf):
    """``conf`` with the host exchanges (``shuffle.mode=DEFAULT``)."""
    host = dict(conf)
    host["spark.rapids.tpu.shuffle.mode"] = "DEFAULT"
    return host


def both(make, conf, mesh: bool, sort_keys=None):
    """``make(api)`` through the JAX ICI Session and the port's under
    ``conf``: equal rows, and the same lowered list (``mesh``) or the host
    path in both. Returns (port Session, JAX Session).

    The JAX ICI Session plans and lowers (``prepare``); its rows come from
    the JAX Session under the same conf on the host exchanges, as in the
    Q1 case below: a JAX ICI collect on 8 virtual CPU devices can stall in
    XLA's CPU collective rendezvous when other processes load the host
    (pytest-xdist workers), and abort its worker."""
    jses = JSession(conf)
    jses.prepare(make(JAX))
    want = JSession(host_conf(conf)).collect(make(JAX))
    ses = Session(conf, device="cpu")
    got = ses.collect(make(PORT))
    assert lowered(ses) == lowered(jses)
    assert (lowered(ses) is not None) == mesh, lowered(ses)
    assert (ses.executed_exec_names() == ["MeshStageExec"]) == mesh
    if sort_keys is None:
        assert_tables_equal(got, want, ignore_order=True)
    else:
        assert_sorted_equal(got, want, sort_keys)
    return ses, jses


def test_planned_groupby_on_mesh():
    both(lambda a: a.table(FACT).group_by("k").agg(
        a.Sum(a.col("v")).alias("s"), a.Count(a.col("v")).alias("c"),
        a.Min(a.col("v")).alias("mn"), a.Max(a.col("v")).alias("mx")),
        ICI, mesh=True)


def test_planned_filter_project_groupby_on_mesh():
    both(lambda a: a.table(FACT)
         .where(a.col("v") > a.lit(0))
         .select(a.col("k"), (a.col("v") * a.lit(2)).alias("v2"))
         .group_by("k").agg(a.Sum(a.col("v2")).alias("s")), ICI, mesh=True)


def test_planned_global_agg_on_mesh():
    both(lambda a: a.table(FACT).group_by().agg(
        a.Sum(a.col("v")).alias("s"), a.Count().alias("c")), ICI, mesh=True)


def test_planned_join_groupby_on_mesh():
    ses, _ = both(lambda a: (a.table(FACT)
                             .join(a.table(DIM), ["k"], ["dk"],
                                   a.JoinType.INNER)
                             .group_by("g")
                             .agg(a.Sum(a.col("w")).alias("sw"),
                                  a.Count().alias("c"))), ICI, mesh=True)
    assert "mesh_broadcast(all_gather)" in ses.last_plan.lowered
    assert "mesh_exchange(all_to_all)" in ses.last_plan.lowered


def test_planned_left_outer_join_on_mesh():
    small_dim = gen_table([("dk", IntegerGen(min_val=0, max_val=20)),
                           ("w", LongGen())], n=15, seed=402)
    both(lambda a: a.table(FACT).join(a.table(small_dim), ["k"], ["dk"],
                                      a.JoinType.LEFT_OUTER), ICI, mesh=True)


def test_unsupported_plan_keeps_the_host_path():
    """A limit has no mesh lowering: the host exchanges answer, in both."""
    both(lambda a: a.table(FACT).order_by("v").limit(17), ICI, mesh=False,
         sort_keys=[2])


def test_mesh_join_overflow_retries():
    """300 x 40 pairs overflow the lean join capacity: the stage runs
    again at a doubled expansion and answers whole."""
    left = pa.table({"k": pa.array([1] * 300, pa.int32()),
                     "x": pa.array(range(300), pa.int64())})
    right = pa.table({"k2": pa.array([1] * 40, pa.int32()),
                      "y": pa.array(range(40), pa.int64())})
    ses, _ = both(lambda a: a.table(left).join(a.table(right), ["k"],
                                               ["k2"], a.JoinType.INNER),
                  ICI, mesh=True)
    assert ses.last_plan.attempts > 1


def test_planned_shuffled_join_on_mesh():
    ses, _ = both(lambda a: a.table(FACT).join(a.table(DIM), ["k"], ["dk"],
                                               a.JoinType.INNER),
                  NO_BROADCAST, mesh=True)
    assert ses.last_plan.lowered.count("mesh_exchange(all_to_all)") >= 2


def test_planned_shuffled_right_outer_join_on_mesh():
    ses, _ = both(lambda a: a.table(FACT).join(a.table(DIM), ["k"], ["dk"],
                                               a.JoinType.RIGHT_OUTER),
                  NO_BROADCAST, mesh=True)
    assert ses.last_plan.lowered.count("mesh_exchange(all_to_all)") >= 2


def _chain(a):
    return (a.table(FACT)
            .join(a.table(DIM), ["k"], ["dk"], a.JoinType.INNER)
            .group_by("g")
            .agg(a.Sum(a.col("v")).alias("sv"), a.Count().alias("c"))
            .order_by(a.desc(a.col("sv"))))


def _join_of(plan):
    if type(plan).__name__ == "HashJoinExec":
        return plan
    for c in plan.children:
        j = _join_of(c)
        if j is not None:
            return j
    return None


def test_planned_join_agg_sort_chain_keeps_host_path_under_aqe():
    """The JAX Session's default conf (AQE on) never lowers this chain,
    in either package: planning the aggregate above the shuffled join
    reads the join's ``num_partitions``, whose ``_maybe_coordinate``
    measures the 41-row build and switches the join to a runtime
    broadcast (``spark_rapids_tpu/exec/join.py:651``); the lowering then
    refuses a broadcast join without a broadcast exchange child. This is
    why the seed's ``test_planned_join_agg_sort_chain_on_mesh`` fails."""
    ses, jses = both(_chain, NO_BROADCAST, mesh=False, sort_keys=[1])
    # planned shuffled, switched by the time planning ends
    for s, api in ((ses, PORT), (jses, JAX)):
        s.prepare(_chain(api))
        join = _join_of(s.last_plan)
        assert join.broadcast_build and not join._planned_broadcast
        s.last_plan.close()


def test_planned_join_agg_sort_chain_on_mesh_without_aqe():
    """The q72 shape with AQE off: shuffled join, group-by and global
    sort, four chained exchanges in one stage."""
    ses, _ = both(_chain, NO_AQE, mesh=True, sort_keys=[1])
    assert ses.last_plan.lowered.count("mesh_exchange(all_to_all)") == 4
    assert "HashJoinExec(masked)" in ses.last_plan.lowered


def test_planned_global_sort_on_mesh():
    """Splitter-routed range exchange and local sorts: the order across
    shards is total."""
    both(lambda a: a.table(FACT).order_by(a.desc(a.col("v")),
                                          a.asc(a.col("k"))),
         NO_BROADCAST, mesh=True, sort_keys=[2, 0])


#: the JAX Session's lowering of TPC-H Q1 (its two exchanges: the
#: aggregate's murmur3 routing and the sort's splitter range exchange)
Q1_LOWERED = ["SortExec", "mesh_exchange(all_to_all)", "HashAggregateExec",
              "ShuffleExchangeExec", "HashAggregateExec",
              "mesh_exchange(all_to_all)", "CoalesceBatchesExec",
              "FilterExec", "InMemoryScanExec"]


def test_q1_lowers_whole_onto_the_mesh():
    """TPC-H Q1 at SF 0.01 (59,986 lineitem rows) in 8 slices under
    ``entry.session_conf`` with ICI: one ``MeshStageExec`` in both
    packages with the same lowered list; its rows equal the JAX Session's
    and the pyarrow oracle's.

    The JAX ICI Session plans and lowers the stage (``prepare``) and its
    rows come from the JAX Session under the same conf without ICI: a JAX
    ICI collect of this stage on 8 virtual CPU devices can stall in XLA's
    CPU collective rendezvous (an all-reduce of the JAX package's
    ``unstack_batches`` waited 40 s for its eighth thread and aborted the
    process), which no port code can reach."""
    t = entry.lineitem_table(59_986)
    conf = entry.session_conf(8, **ICI)
    jses = JSession(conf)
    jses.prepare(_jax_q1(t, 8))
    want = JSession(host_conf(conf)).collect(_jax_q1(t, 8))
    ses = Session(conf, device="cpu")
    got = ses.collect(entry.q1_df(t, 8))
    assert isinstance(ses.last_plan, MeshStageExec)
    assert ses.last_plan.lowered == lowered(jses) == Q1_LOWERED
    assert_tables_equal(got, want)
    assert_tables_equal(got, entry.q1_reference(t))


def test_ici_exchange_shape_as_jax():
    """The bench's fifth shape (``bench.bench_ici_exchange``'s draws and
    query at 4,096 fact rows) under the JAX default conf with ICI: a
    planned broadcast join and a group-by, lowered alike, equal rows."""
    fact, dim = entry.ici_exchange_tables(1 << 12)
    conf = entry.ici_conf(8)
    ses, _ = both(lambda a: (a.table(fact)
                             .join(a.table(dim), ["k"], ["dk"],
                                   a.JoinType.INNER)
                             .group_by("g")
                             .agg(a.Sum(a.col("v")).alias("sv"),
                                  a.Sum(a.col("w")).alias("sw"),
                                  a.Count().alias("c"))), conf, mesh=True)
    got = ses.collect(entry.ici_exchange_df(fact, dim)).sort_by("g")
    assert got.equals(entry.ici_exchange_reference(fact, dim))
    assert "mesh_broadcast(all_gather)" in ses.last_plan.lowered


def test_dryrun_multigpu_on_the_cpu():
    """``entry.dryrun_multigpu``: the dryrun's chain as one stage over 8
    CPU shards, four exchanges, the interpreter's groups."""
    out = entry.dryrun_multigpu(8, device="cpu")
    assert out["exchanges"] == 4 and out["groups"] == 6
    assert out["lowered"][:2] == ["SortExec", "mesh_exchange(all_to_all)"]
