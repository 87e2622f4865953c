"""The port's Session end to end on the CPU: each TPC-H path (Q1, the Q16
part stage, Q3, Q18, Q2, Q11) and each bench shape (q1_stage, hash_agg,
join_sort, parquet_scan), written as a port DataFrame (``entry.*_df``),
planned by ``spark_rapids_tpu_torch.plan.Session``. Its physical tree
equals the JAX Session's ``last_plan`` for the same DataFrame under the
same conf dict, node for node, and the hand-built ``entry.*_plan``; its
rows equal the hand-built tree's and the pyarrow oracle's (floats within
rel 1e-6: the packages add float64 values in different orders). Then the
five shapes of ``test_oom_differential.py`` under ``every-1`` injection
through the port's Session.

The JAX Session only plans (``prepare``): its rows for these DataFrames
are held against the hand-built trees in ``test_torch_q*.py``. The
join_sort stage is the one tree that differs at the root: the port fuses
it (``exec/fuse.py`` passes the broadcast and the coalesce through),
where the JAX package's fusion leaves it to the iterator path, so the
fused stage's tree is what compares."""

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc
import pyarrow.dataset as ds
import pytest

from spark_rapids_tpu.exec.sort import SortOrder as JSortOrder
from spark_rapids_tpu.expressions import col as jcol
from spark_rapids_tpu.expressions import lit as jlit
from spark_rapids_tpu.expressions.aggregates import Average as JAverage
from spark_rapids_tpu.expressions.aggregates import Count as JCount
from spark_rapids_tpu.expressions.aggregates import Sum as JSum
from spark_rapids_tpu.expressions.boolean import And as JAnd
from spark_rapids_tpu.expressions.comparison import EqualTo as JEqualTo
from spark_rapids_tpu.expressions.comparison import In as JIn
from spark_rapids_tpu.expressions.comparison import Not as JNot
from spark_rapids_tpu.expressions.strings import startswith as jstartswith
from spark_rapids_tpu.io.scan import read_parquet as jread_parquet
from spark_rapids_tpu.io.source import ReaderType as JReaderType
from spark_rapids_tpu.plan import Session as JSession
from spark_rapids_tpu.plan import table as jtable
from spark_rapids_tpu_torch import entry
from spark_rapids_tpu_torch.exec import FusedStageExec, collect
from spark_rapids_tpu_torch.expressions import col, lit
from spark_rapids_tpu_torch.expressions.aggregates import (Average, Count,
                                                           Sum)
from spark_rapids_tpu_torch.memory.catalog import device_budget
from spark_rapids_tpu_torch.memory.retry import injector
from spark_rapids_tpu_torch.plan import Session, table

from harness.asserts import assert_tables_equal
from test_torch_q2 import cut_comments, jax_q11, jax_q2
from test_torch_q3 import _jax_q3
from test_torch_q18 import _jax_q18

N = 4000


def node(e):
    """What a tree node must agree on: exec class and name, join type,
    build mode, join keys, partitioning keys and count, aggregate mode,
    limit, coalesce goal, sort keys, the scan's partitions and source, and
    the output columns' names and kinds."""
    attrs = [type(e).__name__, e.name]
    if hasattr(e, "join_type"):
        attrs += [e.join_type.name, getattr(e, "broadcast_build", None)]
    for keys in ("left_keys", "right_keys"):
        if hasattr(e, keys):
            attrs.append(tuple((type(k).__name__, getattr(k, "ordinal", None),
                                k.dtype.kind.value)
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
    if hasattr(e, "source"):
        attrs += [e.num_partitions, e.source.columns,
                  type(e.source.predicate).__name__,
                  e.source.effective_reader().value]
    attrs.append(tuple((f.name, f.dtype.kind.value)
                       for f in e.output_schema))
    return tuple(attrs)


def tree(e, depth=0):
    out = [(depth,) + node(e)]
    for c in e.children:
        out += tree(c, depth + 1)
    return out


def unfused(plan):
    """The tree a fused stage runs (either package's), else the plan."""
    return (plan.stage.plan if type(plan).__name__ == "FusedStageExec"
            else plan)


def jax_planned(conf, df):
    ses = JSession(conf)
    ses.prepare(df)
    return ses.last_plan


def _jscan(t, slices):
    return jtable(t, num_slices=slices, batch_rows=-(-t.num_rows // slices))


def _jax_q1(t, slices):
    disc = jcol("l_extendedprice") * (jlit(1.0) - jcol("l_discount"))
    return (_jscan(t, slices)
            .where(jcol("l_shipdate") <= jlit(entry.Q1_SHIPDATE_MAX))
            .group_by(*entry.Q1_KEYS)
            .agg(JSum(jcol("l_quantity")).alias("sum_qty"),
                 JSum(jcol("l_extendedprice")).alias("sum_base_price"),
                 JSum(disc).alias("sum_disc_price"),
                 JSum(disc * (jlit(1.0) + jcol("l_tax"))).alias("sum_charge"),
                 JAverage(jcol("l_quantity")).alias("avg_qty"),
                 JAverage(jcol("l_extendedprice")).alias("avg_price"),
                 JAverage(jcol("l_discount")).alias("avg_disc"),
                 JCount().alias("count_order"))
            .order_by(*[JSortOrder(jcol(k)) for k in entry.Q1_KEYS]))


def _jax_q16_part(t, slices):
    cond = JAnd(JAnd(JNot(JEqualTo(jcol("p_brand"), jlit(entry.Q16_BRAND))),
                     JNot(jstartswith(jcol("p_type"),
                                      entry.Q16_TYPE_PREFIX))),
                JIn(jcol("p_size"), entry.Q16_SIZES))
    return (_jscan(t, slices).where(cond)
            .group_by(*entry.Q16_KEYS)
            .agg(JCount().alias("part_cnt"))
            .order_by(JSortOrder(jcol("part_cnt"), True),
                      *[JSortOrder(jcol(k)) for k in entry.Q16_KEYS]))


def _jax_q1_stage(t):
    return (_jscan(t, 1)
            .where(jcol("l_shipdate") <= jlit(entry.Q1_SHIPDATE_MAX))
            .group_by(*entry.Q1_KEYS)
            .agg(JSum(jcol("l_quantity")).alias("sum_qty"),
                 JSum(jcol("l_extendedprice")).alias("sum_base_price"),
                 JSum(jcol("l_extendedprice")
                      * (jlit(1.0) - jcol("l_discount"))
                      ).alias("sum_disc_price"),
                 JAverage(jcol("l_quantity")).alias("avg_qty"),
                 JAverage(jcol("l_discount")).alias("avg_disc"),
                 JCount().alias("count_order")))


def _jax_hash_agg(t, slices):
    return (_jscan(t, slices).group_by(*entry.HASH_AGG_KEYS)
            .agg(JSum(jcol("ss_quantity")).alias("sq"),
                 JSum(jcol("ss_net_profit")).alias("sp"),
                 JAverage(jcol("ss_sales_price")).alias("ap"),
                 JCount().alias("c")))


def _jax_join_sort(stream, build):
    return (_jscan(stream, 1)
            .join(_jscan(build, 1), ["l_orderkey"], ["o_orderkey"])
            .order_by(JSortOrder(jcol("l_revenue"), True)))


def _jax_parquet_scan(paths):
    return jread_parquet(paths, columns=list(entry.PARQUET_SCAN_COLUMNS),
                         predicate=jcol("l_shipdate")
                         <= jlit(entry.Q1_SHIPDATE_MAX),
                         reader_type=JReaderType.MULTITHREADED)


def _by_key(keys):
    def sort(t):
        return t.sort_by([(k, "ascending") for k in keys])
    return sort


def _parquet_reference(paths):
    return ds.dataset(paths).to_table(
        columns=list(entry.PARQUET_SCAN_COLUMNS),
        filter=ds.field("l_shipdate") <= entry.Q1_SHIPDATE_MAX)


def _q1_stage_reference(t):
    f = t.filter(pc.less_equal(t.column("l_shipdate"),
                               entry.Q1_SHIPDATE_MAX))
    f = f.append_column("disc", pc.multiply(
        f.column("l_extendedprice"), pc.subtract(1.0, f.column("l_discount"))))
    g = f.group_by(list(entry.Q1_KEYS)).aggregate(
        [("l_quantity", "sum"), ("l_extendedprice", "sum"), ("disc", "sum"),
         ("l_quantity", "mean"), ("l_discount", "mean"),
         ("l_quantity", "count")])
    return pa.table([g.column(c) for c in
                     list(entry.Q1_KEYS) + ["l_quantity_sum",
                                            "l_extendedprice_sum",
                                            "disc_sum", "l_quantity_mean",
                                            "l_discount_mean",
                                            "l_quantity_count"]],
                    names=[f.name for f in _q1_stage_schema()])


def _q1_stage_schema():
    return entry.q1_stage_plan(entry.lineitem_table(8), "cpu").output_schema


class Case:
    """One path: its tables, the port DataFrame, the JAX DataFrame, the
    conf, the hand-built tree, the oracle and how rows compare."""

    def __init__(self, tables, df, jdf, conf, plan, reference,
                 order=None, exact=False):
        self.tables, self.df, self.jdf = tables, df, jdf
        self.conf, self.plan, self.reference = conf, plan, reference
        self.order, self.exact = order, exact


def _cases(tmp_dir):
    q3c = entry.tpch_q3_tables(0.001)
    q18c = entry.tpch_q18_tables(0.005)
    q2t = entry.tpch_q2_tables(0.01)
    q11t = (q2t[2], q2t[1], q2t[3])
    fraction = entry.q11_fraction(0.01)
    li = entry.lineitem_table(N)
    part = entry.part_table(N)
    sales = entry.hash_agg_table(N, 1000)
    stream, build = entry.join_sort_tables(4096, 512)
    paths = entry.parquet_files(entry.lineitem_table(6000, seed=8),
                                tmp_dir, 4)
    from test_torch_q2 import CONF as Q2_CONF
    from test_torch_q18 import CONF as Q18_CONF
    q3_conf = entry.session_conf(
        4, **{"spark.rapids.tpu.sql.autoBroadcastJoinThreshold": 0})
    return {
        "q1": Case(li, lambda: entry.q1_df(li, 4), lambda: _jax_q1(li, 4),
                   entry.session_conf(8),
                   lambda: entry.q1_plan(li, 4, 8, device="cpu"),
                   entry.q1_reference),
        "q16_part": Case(
            part, lambda: entry.q16_part_df(part, 4),
            lambda: _jax_q16_part(part, 4), entry.session_conf(8),
            lambda: entry.q16_part_plan(part, 4, 8, device="cpu"),
            entry.q16_part_reference, exact=True),
        "q3": Case(
            q3c, lambda: entry.q3_df(*q3c, 2), lambda: _jax_q3(*q3c),
            q3_conf,
            lambda: entry.q3_plan(*q3c, 2, 4, device="cpu"),
            lambda t: entry.q3_reference(*t)),
        "q18": Case(
            q18c, lambda: entry.q18_df(*q18c, 8, 200.0),
            lambda: _jax_q18(*q18c), Q18_CONF,
            lambda: entry.q18_plan(*q18c, 8, 2, max_build_rows=9000,
                                   device="cpu", quantity=200.0),
            lambda t: entry.q18_reference(*t, 200.0), exact=True),
        "q2": Case(
            q2t, lambda: entry.q2_df(*q2t, 2),
            lambda: jax_q2(q2t[0], cut_comments(q2t[1]), *q2t[2:]),
            Q2_CONF, lambda: entry.q2_plan(*q2t, 2, 2, device="cpu"),
            lambda t: entry.q2_reference(*t), exact=True),
        "q11": Case(
            q11t, lambda: entry.q11_df(*q11t, fraction, 2),
            lambda: jax_q11(*q11t, fraction), Q2_CONF,
            lambda: entry.q11_plan(*q11t, fraction, 2, 2, device="cpu"),
            lambda t: entry.q11_reference(*t, fraction),
            order=_by_key(["ps_partkey"])),
        "q1_stage": Case(
            li, lambda: entry.q1_stage_df(li), lambda: _jax_q1_stage(li),
            entry.session_conf(8),
            lambda: entry.q1_stage_plan(li, device="cpu"),
            _q1_stage_reference, order=_by_key(entry.Q1_KEYS)),
        "hash_agg": Case(
            sales, lambda: entry.hash_agg_df(sales, 3),
            lambda: _jax_hash_agg(sales, 3), entry.session_conf(8),
            lambda: entry.hash_agg_plan(sales, two_stage=True, num_slices=3,
                                        device="cpu"),
            entry.hash_agg_reference, order=_by_key(entry.HASH_AGG_KEYS)),
        "join_sort": Case(
            (stream, build), lambda: entry.join_sort_df(stream, build),
            lambda: _jax_join_sort(stream, build), entry.session_conf(8),
            lambda: entry.join_sort_plan(stream, build, device="cpu"),
            lambda t: entry.join_sort_reference(*t), exact=True),
        "parquet_scan": Case(
            paths, lambda: entry.parquet_scan_df(paths),
            lambda: _jax_parquet_scan(paths), entry.session_conf(8),
            lambda: entry.parquet_scan_plan(paths, device="cpu"),
            _parquet_reference, exact=True),
    }


@pytest.fixture(scope="module")
def cases(tmp_path_factory):
    return _cases(str(tmp_path_factory.mktemp("scan")))


PATHS = ["q1", "q16_part", "q3", "q18", "q2", "q11", "q1_stage", "hash_agg",
         "join_sort", "parquet_scan"]


def _same_rows(got, want, case):
    if case.order is not None:
        got, want = case.order(got), case.order(want)
    assert_tables_equal(got, want, approx_float=not case.exact)


@pytest.mark.parametrize("path", PATHS)
def test_session_plans_the_jax_tree_and_its_rows(cases, path):
    case = cases[path]
    ses = Session(case.conf, device="cpu")
    got = ses.collect(case.df())
    assert ses.fell_back() == []
    jplan = jax_planned(case.conf, case.jdf())
    hand = case.plan()
    assert tree(unfused(ses.last_plan)) == tree(unfused(jplan)) \
        == tree(unfused(hand))
    assert isinstance(ses.last_plan, FusedStageExec) == \
        (path == "join_sort")
    want = collect(hand)
    _same_rows(got, want, case)
    ref = case.reference(case.tables)
    if path == "join_sort":      # the oracle keeps one copy of the key
        got = got.select(ref.column_names)
    _same_rows(got, ref, case)
    assert ses.last_cache["plan"].startswith("bypass")
    assert ses.last_prepare_ns > 0


def test_join_sort_replays_its_fused_stage(cases):
    """A second collect of the same plan replays the stage; on the CPU
    the program runs eagerly, with the same rows."""
    case = cases["join_sort"]
    ses = Session(case.conf, device="cpu")
    kind, plan = ses.prepare(case.df())
    first = ses.collect(case.df(), _prepared=(kind, plan))
    again = collect(plan)
    assert first.equals(again)


# ---------------------------------------------------------------------------
# The five shapes of test_oom_differential.py under every-1, through the
# port's Session
# ---------------------------------------------------------------------------

OOM_N = 3000
EVERY1 = {"spark.rapids.tpu.test.injectOOM.mode": "every-1"}
F64_OK = {"spark.rapids.tpu.sql.incompatibleOps.enabled": True}


@pytest.fixture(autouse=True)
def _injection_off_after():
    yield
    injector().configure("")
    assert not injector().enabled


def _oom_shapes(tmp_dir):
    rng = np.random.default_rng(3)
    li = pa.table({
        "l_returnflag": rng.integers(0, 3, OOM_N).astype(np.int32),
        "l_linestatus": rng.integers(0, 2, OOM_N).astype(np.int32),
        "l_quantity": rng.integers(1, 51, OOM_N).astype(np.int64),
        "l_extendedprice": rng.uniform(1.0, 1e5, OOM_N),
        "l_shipdate": rng.integers(8000, 11000, OOM_N).astype(np.int32)})
    rng = np.random.default_rng(5)
    sales = pa.table({
        "ss_item_sk": rng.integers(0, 256, OOM_N).astype(np.int64),
        "ss_quantity": rng.integers(1, 100, OOM_N).astype(np.int64),
        "ss_sales_price": rng.uniform(0.5, 500.0, OOM_N)})
    rng = np.random.default_rng(9)
    fact = pa.table({"k": rng.integers(0, 64, OOM_N).astype(np.int64),
                     "v": rng.integers(-1000, 1000, OOM_N).astype(np.int64)})
    dim = pa.table({"dk": np.arange(64, dtype=np.int64),
                    "cls": np.arange(64, dtype=np.int64) % 7})
    rng = np.random.default_rng(13)
    import pyarrow.parquet as pq
    for i in range(3):
        pq.write_table(pa.table({
            "k": rng.integers(0, 1000, OOM_N // 3).astype(np.int64),
            "v": rng.uniform(-10.0, 10.0, OOM_N // 3)}),
            f"{tmp_dir}/part-{i}.parquet")
    rng = np.random.default_rng(11)
    ex = pa.table({"g": rng.integers(0, 64, OOM_N).astype(np.int32),
                   "v": rng.integers(-1000, 1000, OOM_N).astype(np.int64)})
    from spark_rapids_tpu_torch.exec import JoinType
    from spark_rapids_tpu_torch.io import read_parquet
    return {
        "q1_stage": (lambda: table(li, num_slices=2)
                     .where(col("l_shipdate") <= lit(10471))
                     .group_by("l_returnflag", "l_linestatus")
                     .agg(Sum(col("l_quantity")).alias("sq"),
                          Sum(col("l_extendedprice")).alias("sp"),
                          Count(col("l_quantity")).alias("n")), F64_OK),
        "hash_agg": (lambda: table(sales, num_slices=2).group_by("ss_item_sk")
                     .agg(Sum(col("ss_quantity")).alias("sq"),
                          Average(col("ss_sales_price")).alias("ap"),
                          Count(col("ss_quantity")).alias("n")), F64_OK),
        "join_sort": (lambda: table(fact, num_slices=2)
                      .join(table(dim), ["k"], ["dk"], JoinType.INNER)
                      .group_by("cls").agg(Sum(col("v")).alias("sv"))
                      .order_by("cls"), {}),
        "parquet_scan": (lambda: read_parquet(tmp_dir)
                         .where(col("k") > lit(100))
                         .select(col("k"), col("v")), {}),
        "exchange": (lambda: table(ex, num_slices=4).group_by("g")
                     .agg(Sum(col("v")).alias("sv"),
                          Count(col("g")).alias("n")),
                     {"spark.rapids.tpu.shuffle.partitions": 4}),
    }


@pytest.fixture(scope="module")
def oom_shapes(tmp_path_factory):
    return _oom_shapes(str(tmp_path_factory.mktemp("oom")))


@pytest.mark.oom_inject
@pytest.mark.parametrize("shape", ["q1_stage", "hash_agg", "join_sort",
                                   "parquet_scan", "exchange"])
def test_oom_every1_through_the_session(oom_shapes, shape):
    """Clean, then every allocation check failing once: bit-for-bit
    equal, retries recorded, no pin or handle left, nothing off the
    device."""
    df_fn, base = oom_shapes[shape]
    cat = device_budget("cpu")
    clean = Session(base, device="cpu").collect(df_fn())
    assert cat.total_pinned() == 0, cat.dump_state()
    entries0 = len(cat._entries)
    ses = Session(dict(base, **EVERY1), device="cpu")
    injected = ses.collect(df_fn())
    assert ses.fell_back() == []
    assert not isinstance(ses.last_plan, FusedStageExec)
    assert all(not n.startswith("CpuFallback")
               for n in ses.executed_exec_names())
    assert_tables_equal(injected, clean, ignore_order=True,
                        approx_float=False)
    m = ses.metrics()
    assert m.get("retry.retryCount", 0) > 0, m
    assert cat.total_pinned() == 0, cat.dump_state()
    assert len(cat._entries) == entries0, cat.dump_state()
