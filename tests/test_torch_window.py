"""The window operator and key batching (``expressions/window.py``,
``exec/window.py``, ``exec/key_batching.py``, ``LogicalWindow``) in the
port, against the JAX package on the CPU.

Each case runs the JAX Session once and the port's Session and its row
interpreter on the same seeded input; rows, types and ``fell_back()``
agree, floats within the harness tolerance (rel 1e-6). The cases:

- every case of ``tests/test_window.py``, with its parameters;
- the three window cases of ``tests/test_expressions_r4.py`` (percent_rank
  and cume_dist, nth_value, nth_value over a ROWS frame);
- the two window cases of ``tests/test_structs.py``;
- ``tests/test_coalesce_goals.py::test_multibatch_window_matches``;
- the port's own: the segmented scans against plain loops, a float
  running sum after a 1e16-scale partition (exact), the explain tree and
  operators beside the JAX ones, the two SF paths of ``entry.py`` at a
  small scale against their numpy references, and the places where the
  packages depart, each pinned with both outputs."""

import numpy as np
import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu.exec.sort import asc as jasc
from spark_rapids_tpu.exec.sort import desc as jdesc
from spark_rapids_tpu.expressions import col as jcol
from spark_rapids_tpu.expressions import lit as jlit
from spark_rapids_tpu.expressions import aggregates as JA
from spark_rapids_tpu.expressions import window as JW
from spark_rapids_tpu.expressions.collections import \
    GetStructField as JGetStructField
from spark_rapids_tpu.plan import Session as JSession
from spark_rapids_tpu.plan import table as jtable
from spark_rapids_tpu_torch import entry
from spark_rapids_tpu_torch.exec import KeyBatchingExec, asc, desc
from spark_rapids_tpu_torch.expressions import GetStructField, col, lit
from spark_rapids_tpu_torch.expressions import aggregates as PA
from spark_rapids_tpu_torch.expressions import window as PW
from spark_rapids_tpu_torch.plan import Session, table

from harness.asserts import assert_tables_equal
from harness.data_gen import IntegerGen, LongGen, gen_table
from test_coalesce_goals import big_table
from test_expressions_r4 import WT as WT4
from test_structs import struct_table
from test_window import RANGE_FRAMES, ROWS_FRAMES, WT


@pytest.fixture(autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class _Api:
    def __init__(self, **kw):
        self.__dict__.update(kw)


def _api(table, col, lit, asc, desc, W, A, GetStructField):
    return _Api(table=table, col=col, lit=lit, asc=asc, desc=desc,
                over=W.over, RowNumber=W.RowNumber, Rank=W.Rank,
                NTile=W.NTile, LagLead=W.LagLead, WindowAgg=W.WindowAgg,
                WindowFrame=W.WindowFrame, PercentRank=W.PercentRank,
                CumeDist=W.CumeDist, NthValue=W.NthValue,
                WindowExpression=W.WindowExpression, WindowSpec=W.WindowSpec,
                Sum=A.Sum, Count=A.Count, Min=A.Min, Max=A.Max,
                Average=A.Average, StddevSamp=A.StddevSamp,
                GetStructField=GetStructField)


JAX = _api(jtable, jcol, jlit, jasc, jdesc, JW, JA, JGetStructField)
PORT = _api(table, col, lit, asc, desc, PW, PA, GetStructField)
ORACLE = {"spark.rapids.tpu.sql.enabled": False}


def _both(q, conf=None, approx_float=True, islands=False):
    """``q(api)`` through the port's Session, its interpreter and the JAX
    Session: the same rows and types and the same islands (none unless
    ``islands``)."""
    conf = conf or {}
    ses = Session(conf, device="cpu")
    got = ses.collect(q(PORT))
    jses = JSession(conf)
    want = jses.collect(q(JAX))
    assert got.schema == want.schema
    assert_tables_equal(got, want, ignore_order=True,
                        approx_float=approx_float)
    assert ses.fell_back() == jses.fell_back()
    assert islands or ses.fell_back() == []
    cpu = Session({**conf, **ORACLE}, device="cpu").collect(q(PORT))
    assert_tables_equal(got, cpu, ignore_order=True,
                        approx_float=approx_float)
    return got, ses, jses


def _ko(a):
    return [a.asc(a.col("o")), a.asc(a.col("v"))]


# ---------------------------------------------------------------------------
# tests/test_window.py
# ---------------------------------------------------------------------------

def test_row_number():
    _, ses, _ = _both(lambda a: a.table(WT).window(
        a.over(a.RowNumber(), [a.col("k")], _ko(a)).alias("rn")))
    assert "WindowExec" in ses.executed_exec_names()
    assert ses.fell_back() == []


def test_rank_dense_rank():
    _both(lambda a: a.table(WT).window(
        a.over(a.Rank(), [a.col("k")], [a.asc(a.col("o"))]).alias("r"),
        a.over(a.Rank(dense=True), [a.col("k")],
               [a.asc(a.col("o"))]).alias("dr")))


def test_ntile():
    _both(lambda a: a.table(WT).window(
        a.over(a.NTile(4), [a.col("k")], _ko(a)).alias("nt")))


@pytest.mark.parametrize("is_lag,off", [(True, 1), (True, 3), (False, 1),
                                        (False, 2)])
def test_lag_lead(is_lag, off):
    _both(lambda a: a.table(WT).window(
        a.over(a.LagLead(a.col("v"), off, None, is_lag), [a.col("k")],
               _ko(a)).alias("x")))


def test_lag_with_default():
    _both(lambda a: a.table(WT).window(
        a.over(a.LagLead(a.col("v"), 2, a.lit(-999), True), [a.col("k")],
               _ko(a)).alias("x")))


def test_running_sum_range_ties():
    _both(lambda a: a.table(WT).window(
        a.over(a.WindowAgg(a.Sum(a.col("v"))), [a.col("k")],
               [a.asc(a.col("o"))]).alias("rs")))


def test_running_rows_frame():
    _both(lambda a: a.table(WT).window(
        a.over(a.WindowAgg(a.Sum(a.col("v"))), [a.col("k")], _ko(a),
               a.WindowFrame(is_rows=True, start=None, end=0))
        .alias("rs")))


def test_full_partition_aggs():
    _both(lambda a: a.table(WT).window(
        a.over(a.WindowAgg(a.Sum(a.col("v"))), [a.col("k")]).alias("s"),
        a.over(a.WindowAgg(a.Count(a.col("v"))), [a.col("k")]).alias("c"),
        a.over(a.WindowAgg(a.Min(a.col("v"))), [a.col("k")]).alias("mn"),
        a.over(a.WindowAgg(a.Max(a.col("v"))), [a.col("k")]).alias("mx"),
        a.over(a.WindowAgg(a.Average(a.col("d"))), [a.col("k")])
        .alias("a")))


@pytest.mark.parametrize("start,end", [(-2, 0), (-1, 1), (0, 2), (-3, -1)])
def test_sliding_rows_frames(start, end):
    _both(lambda a: a.table(WT).window(
        a.over(a.WindowAgg(a.Sum(a.col("v"))), [a.col("k")], _ko(a),
               a.WindowFrame(is_rows=True, start=start, end=end))
        .alias("s"),
        a.over(a.WindowAgg(a.Min(a.col("v"))), [a.col("k")], _ko(a),
               a.WindowFrame(is_rows=True, start=start, end=end))
        .alias("mn")))


def test_window_no_partition():
    _both(lambda a: a.table(WT).window(
        a.over(a.RowNumber(), [], _ko(a) + [a.asc(a.col("k"))])
        .alias("rn")))


def test_window_over_multislice_input():
    _both(lambda a: a.table(WT, num_slices=3).window(
        a.over(a.WindowAgg(a.Sum(a.col("v"))), [a.col("k")]).alias("s")))


def test_window_then_filter():
    _both(lambda a: a.table(WT).window(
        a.over(a.RowNumber(), [a.col("k")], _ko(a)).alias("rn"))
        .where(a.col("rn") <= a.lit(3)))


@pytest.mark.parametrize("start,end", ROWS_FRAMES)
def test_rows_frame_matrix(start, end):
    def q(a):
        fr = a.WindowFrame(is_rows=True, start=start, end=end)
        return a.table(WT).window(
            a.over(a.WindowAgg(a.Sum(a.col("v"))), [a.col("k")], _ko(a),
                   fr).alias("s"),
            a.over(a.WindowAgg(a.Min(a.col("v"))), [a.col("k")], _ko(a),
                   fr).alias("mn"),
            a.over(a.WindowAgg(a.Max(a.col("d"))), [a.col("k")], _ko(a),
                   fr).alias("mx"),
            a.over(a.WindowAgg(a.Count(a.col("v"))), [a.col("k")], _ko(a),
                   fr).alias("c"))
    _both(q)


@pytest.mark.parametrize("start,end", RANGE_FRAMES)
def test_range_frame_matrix_asc(start, end):
    def q(a):
        fr = a.WindowFrame(is_rows=False, start=start, end=end)
        o = [a.asc(a.col("o"))]
        return a.table(WT).window(
            a.over(a.WindowAgg(a.Sum(a.col("v"))), [a.col("k")], o, fr)
            .alias("s"),
            a.over(a.WindowAgg(a.Min(a.col("v"))), [a.col("k")], o, fr)
            .alias("mn"),
            a.over(a.WindowAgg(a.Count(a.col("v"))), [a.col("k")], o, fr)
            .alias("c"))
    _both(q)


@pytest.mark.parametrize("start,end", [(-5, 5), (-4, None), (None, 3),
                                       (1, 4)])
def test_range_frame_matrix_desc(start, end):
    def q(a):
        fr = a.WindowFrame(is_rows=False, start=start, end=end)
        o = [a.desc(a.col("o"))]
        return a.table(WT).window(
            a.over(a.WindowAgg(a.Sum(a.col("v"))), [a.col("k")], o, fr)
            .alias("s"),
            a.over(a.WindowAgg(a.Max(a.col("v"))), [a.col("k")], o, fr)
            .alias("mx"))
    _both(q)


def test_range_frame_average_large_window():
    _both(lambda a: a.table(WT).window(
        a.over(a.WindowAgg(a.Average(a.col("d"))), [a.col("k")], _ko(a),
               a.WindowFrame(is_rows=True, start=-200, end=100))
        .alias("a")))


def test_multi_key_value_range_rejected():
    """Value-bounded RANGE over two order keys is invalid SQL: both
    packages tag the window an island, whose interpreter raises."""
    def q(a):
        return a.table(WT).window(
            a.over(a.WindowAgg(a.Sum(a.col("v"))), partition_by=[a.col("k")],
                   order_by=_ko(a),
                   frame=a.WindowFrame(is_rows=False, start=-5, end=5))
            .alias("s"))
    with pytest.raises(ValueError, match="exactly one order key"):
        Session(device="cpu").collect(q(PORT))
    with pytest.raises(ValueError, match="exactly one order key"):
        JSession({}).collect(q(JAX))
    assert Session(device="cpu").explain(q(PORT)) == \
        JSession({}).explain(q(JAX))


def test_key_batching_splits_on_group_boundaries():
    """Whole groups per batch, a batch over the target only when one group
    is, and the JAX exec's batch sizes."""
    from collections import Counter
    from spark_rapids_tpu.exec import InMemoryScanExec as JScan
    from spark_rapids_tpu.exec import KeyBatchingExec as JKeyBatching
    from spark_rapids_tpu_torch.batch import to_arrow
    from spark_rapids_tpu_torch.exec import InMemoryScanExec

    t = gen_table([("k", IntegerGen(min_val=0, max_val=40,
                                    nullable=False)),
                   ("v", LongGen())], n=900, seed=121)
    kb = KeyBatchingExec([col("k")], InMemoryScanExec(t, batch_rows=200,
                                                      device="cpu"),
                         target_rows=150)
    biggest_group = max(Counter(t.column("k").to_pylist()).values())
    seen, sizes = [], []
    for b in kb.execute_partition(0):
        at = to_arrow(b, kb.output_schema)
        ks = set(at.column("k").to_pylist())
        assert all(not (ks & prev) for prev in seen)
        seen.append(ks)
        assert at.num_rows <= max(150, biggest_group), at.num_rows
        sizes.append(at.num_rows)
    assert sum(sizes) == 900 and len(sizes) > 1
    jkb = JKeyBatching([jcol("k")], JScan(t, batch_rows=200),
                       target_rows=150)
    assert sizes == [int(b.num_rows) for b in jkb.execute_partition(0)]


def test_window_with_key_batching_conf():
    conf = {"spark.rapids.tpu.sql.window.batchRows": 64}
    _both(lambda a: a.table(WT).window(
        a.over(a.WindowAgg(a.Sum(a.col("v"))), [a.col("k")], _ko(a))
        .alias("rs")), conf)
    _both(lambda a: a.table(WT).window(
        a.over(a.RowNumber(), [a.col("k")], _ko(a)).alias("rn")), conf)


def test_window_key_batching_exec_in_plan():
    conf = {"spark.rapids.tpu.sql.window.batchRows": 64}
    _, ses, jses = _both(lambda a: a.table(WT).window(
        a.over(a.Rank(), [a.col("k")], [a.asc(a.col("o"))]).alias("r")),
        conf)
    assert "KeyBatchingExec" in ses.executed_exec_names()
    assert ses.executed_exec_names() == jses.executed_exec_names()


def test_desc_range_frame_int64_boundary_values():
    imin = -(1 << 63)
    t = pa.table({
        "k": pa.array([0] * 6, pa.int32()),
        "o": pa.array([imin, imin + 1, imin + 2, imin + 6, 0, 5],
                      pa.int64()),
        "v": pa.array([1, 10, 100, 1000, 10000, 100000], pa.int64()),
    })
    _both(lambda a: a.table(t).window(
        a.over(a.WindowAgg(a.Sum(a.col("v"))), [a.col("k")],
               [a.desc(a.col("o"))],
               a.WindowFrame(is_rows=False, start=-1, end=1)).alias("s")))


def test_over_capacity_unpartitioned_window_falls_back():
    """Without PARTITION BY over more rows than batchRowCapacity the window
    is an island with the JAX reason; under it, on the device."""
    n = 4096
    t = pa.table({"o": np.arange(n, dtype=np.int64),
                  "v": np.arange(n, dtype=np.int64) % 7})
    conf = {"spark.rapids.tpu.sql.batchRowCapacity": 1024}

    def q(a, tbl=t):
        return a.table(tbl).window(
            a.over(a.RowNumber(), [], [a.asc(a.col("o"))]).alias("rn"))
    _, ses, _ = _both(q, conf, islands=True)
    assert any("Window" in f for f in ses.fell_back()), ses.fell_back()
    plan = Session(conf, device="cpu").explain(q(PORT))
    assert "batchRowCapacity" in plan
    assert plan == JSession(conf).explain(q(JAX))
    small = pa.table({"o": np.arange(512, dtype=np.int64),
                      "v": np.arange(512, dtype=np.int64) % 7})
    _, ses, _ = _both(lambda a: q(a, small), conf)
    assert ses.fell_back() == []


# ---------------------------------------------------------------------------
# tests/test_expressions_r4.py, test_structs.py, test_coalesce_goals.py
# ---------------------------------------------------------------------------

def test_percent_rank_and_cume_dist():
    _both(lambda a: a.table(WT4).window(
        a.over(a.PercentRank(), [a.col("k")], [a.asc(a.col("o"))])
        .alias("pr"),
        a.over(a.CumeDist(), [a.col("k")], [a.asc(a.col("o"))])
        .alias("cd")))


@pytest.mark.parametrize("n", [1, 2, 5])
def test_nth_value_default_frame(n):
    _both(lambda a: a.table(WT4).window(
        a.over(a.NthValue(a.col("v"), n), [a.col("k")], _ko(a))
        .alias("nv")))


def test_nth_value_bounded_frame():
    _both(lambda a: a.table(WT4).window(
        a.over(a.NthValue(a.col("v"), 2), [a.col("k")], _ko(a),
               a.WindowFrame(is_rows=True, start=-2, end=2)).alias("nv")))


def test_struct_carry_through_window():
    def q(a):
        spec = a.WindowSpec(partition_keys=(a.col("grp"),),
                            orders=(a.asc(a.col("id")),))
        return (a.table(struct_table())
                .window(a.WindowExpression(a.RowNumber(), spec).alias("rn"))
                .select(a.col("id"), a.col("rn"),
                        a.GetStructField(a.col("s"), 0).alias("x")))
    _, ses, _ = _both(q)
    assert ses.fell_back() == []


def test_struct_window_key_falls_back():
    def q(a):
        spec = a.WindowSpec(partition_keys=(a.col("s"),))
        return (a.table(struct_table())
                .window(a.WindowExpression(a.RowNumber(), spec).alias("rn"))
                .select(a.col("id"), a.col("rn")))
    _, ses, _ = _both(q, islands=True)
    assert any("CpuFallback" in f for f in ses.fell_back())


def test_multibatch_window_matches():
    def q(a):
        spec = a.WindowSpec(partition_keys=(a.col("k"),),
                            orders=(a.asc(a.col("v")),))
        return (a.table(big_table(), batch_rows=256)
                .window(a.WindowExpression(a.RowNumber(), spec).alias("rn"))
                .group_by("k").agg(a.Count().alias("c")))
    _both(q)


# ---------------------------------------------------------------------------
# The port's own cases
# ---------------------------------------------------------------------------

def _plain_scan(x, head, op):
    out, acc = [], None
    for v, h in zip(x, head):
        acc = v if (h or acc is None) else op(acc, v)
        out.append(acc)
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_segmented_scans_against_plain_loops(seed):
    """``segmented_scan`` (forward and reverse), ``segment_starts``,
    ``segment_ends`` and ``segmented_int_sum`` against Python loops."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 300))
    head = rng.random(n) < 0.2
    head[0] = bool(rng.integers(0, 2))
    x = rng.integers(-1000, 1000, n)
    h = torch.from_numpy(head)
    t = torch.from_numpy(x)
    for op, pop in ((torch.add, lambda a, b: a + b),
                    (torch.minimum, min), (torch.maximum, max)):
        assert PW.segmented_scan(t, h, op).tolist() == \
            _plain_scan(x.tolist(), head.tolist(), pop)
        back = _plain_scan(x[::-1].tolist(), head[::-1].tolist(), pop)[::-1]
        assert PW.segmented_scan(t, h, op, reverse=True).tolist() == back
    starts = [max([j for j in range(i + 1) if head[j]], default=0)
              for i in range(n)]
    assert PW.segment_starts(h).tolist() == starts
    ends = [min([j for j in range(i, n) if head[j]], default=n)
            for i in range(n)]
    assert PW.segment_ends(h).tolist() == ends
    sums = _plain_scan(x.tolist(), [True] + head[1:].tolist(),
                       lambda a, b: a + b) if n else []
    assert PW.segmented_int_sum(t, PW.segment_starts(
        torch.cat([torch.ones(1, dtype=torch.bool), h[1:]]))).tolist() \
        == sums


def test_float_running_sum_stays_within_its_partition():
    """A partition of small doubles sorted after one of 1e16: its running
    sum is exact, as the JAX package's partition-local scan gives it, where
    a batch-wide cumsum difference would round the small values away."""
    t = pa.table({"k": pa.array([0, 0, 1, 1, 1, 1], pa.int32()),
                  "i": pa.array([1, 2, 3, 4, 5, 6], pa.int64()),
                  "x": pa.array([1e16, 3e16, 1.0, 0.5, 2.0, 0.25])})
    got, _, _ = _both(lambda a: a.table(t).window(
        a.over(a.WindowAgg(a.Sum(a.col("x"))), [a.col("k")],
               [a.asc(a.col("i"))],
               a.WindowFrame(is_rows=True, start=None, end=0))
        .alias("run")), approx_float=False)
    run = dict(zip(got.column("i").to_pylist(),
                   got.column("run").to_pylist()))
    assert [run[i] for i in (3, 4, 5, 6)] == [1.0, 1.5, 3.5, 3.75]
    cum = np.cumsum(np.array([1e16, 3e16, 1.0, 0.5, 2.0, 0.25]))
    assert (cum[2:] - cum[1]).tolist() != [1.0, 1.5, 3.5, 3.75]


def test_explain_and_operators_beside_jax():
    """Over three slices the window is a hash exchange on its partition
    key, a KeyBatchingExec and the WindowExec, in both packages; the
    explain text (with an island's reasons) is the JAX text."""
    def q(a):
        return a.table(WT, num_slices=3).window(
            a.over(a.WindowAgg(a.Sum(a.col("v"))), [a.col("k")],
                   [a.asc(a.col("o"))]).alias("s"),
            a.over(a.Rank(), [a.col("k")], [a.asc(a.col("o"))]).alias("r"))
    conf = {"spark.rapids.tpu.sql.window.batchRows": 64}
    _, ses, jses = _both(q, conf)
    names = ses.executed_exec_names()
    assert names == jses.executed_exec_names()
    assert names[:3] == ["WindowExec", "KeyBatchingExec",
                         "ShuffleExchangeExec"], names
    assert Session(conf, device="cpu").explain(q(PORT)) == \
        JSession(conf).explain(q(JAX))

    def off(a):
        return a.table(WT).window(
            a.over(a.WindowAgg(a.Sum(a.col("v"))), [a.col("k")],
                   [a.asc(a.col("o")), a.asc(a.col("v"))],
                   a.WindowFrame(is_rows=False, start=-2, end=2))
            .alias("s"))
    mine = Session(device="cpu").explain(off(PORT))
    assert "exactly one order key" in mine
    assert mine == JSession().explain(off(JAX))
    conf = {"spark.rapids.tpu.sql.exec.Window": False}
    _, ses, _ = _both(lambda a: a.table(WT).window(
        a.over(a.RowNumber(), [a.col("k")], _ko(a)).alias("rn")), conf,
        islands=True)
    assert ses.fell_back() == ["CpuFallback[Window]"]


def test_entry_paths_at_small_scale():
    """Customer history and supplier months (``entry.py``) at SF 0.01
    through the port's Session: equal to their numpy references (integers
    and dates exactly, floats within rel 1e-6, rank ties as sets: the rows
    compare sorted by their keys), to the port's interpreter, and the
    customer-history rows to the JAX Session's."""
    orders, lineitem = entry.tpch_window_tables(0.01)
    conf = entry.session_conf(4)
    ses = Session(conf, device="cpu")
    got = ses.collect(entry.customer_history_df(orders, 4))
    assert ses.fell_back() == []
    want = entry.customer_history_reference(orders)
    entry.check_customer_history(got, want)
    assert "WindowExec" in ses.executed_exec_names()
    got = ses.collect(entry.supplier_months_df(lineitem, 4))
    assert ses.fell_back() == []
    entry.check_supplier_months(got, entry.supplier_months_reference(
        lineitem))
    assert got.num_rows > 0


def departures_table() -> pa.Table:
    import datetime as dt
    import decimal
    nan = float("nan")
    return pa.table({
        "k": pa.array([0, 0, 0, 1, 1, 1], pa.int32()),
        "i": pa.array([1, 2, 3, 4, 5, 6], pa.int64()),
        "o": pa.array([1.0, nan, 2.0, 5.0, nan, -1.0]),
        "s": pa.array(["pear", "apple", None, "zz", "b", "ba"]),
        "m": pa.array([decimal.Decimal(x) if x else None for x in
                       ("1.25", "2.50", None, "-3.00", "4.75", "0.01")],
                      pa.decimal128(7, 2)),
        "v": pa.array([1.0, nan, 3.0, nan, 2.0, 5.0]),
        "d": pa.array([dt.date(2020, 1, 1), dt.date(2020, 1, 5),
                       dt.date(2020, 3, 1), dt.date(2020, 1, 1), None,
                       dt.date(2020, 1, 2)], pa.date32()),
    })


def _by_i(a):
    return [a.asc(a.col("i"))]


#: (query, the port's column (its device and its interpreter, Spark's
#: answer), what the JAX device gives: a column, or the error it raises;
#: and the JAX interpreter's column where it is not the port's)
DEPARTURES = {
    # a string frame: the JAX device reduces the byte matrix
    # elementwise and cannot broadcast its fill; the port reduces ranks
    "min_max_string": (
        lambda a: a.table(departures_table()).window(
            a.over(a.WindowAgg(a.Max(a.col("s"))), [a.col("k")],
                   _by_i(a)).alias("x")),
        ["pear", "pear", "pear", "zz", "zz", "zz"],
        (ValueError, "Incompatible shapes")),
    # NaN order values under a value-bounded RANGE frame: NaN equals NaN
    # and orders above every value (Spark); the JAX device counts a NaN
    # row into its neighbours' frames, and the JAX interpreter leaves a
    # NaN row out of its own (NaN < NaN and NaN == NaN are false there)
    "nan_order_key": (
        lambda a: a.table(departures_table()).window(
            a.over(a.WindowAgg(a.Count(a.col("i"))), [a.col("k")],
                   [a.asc(a.col("o"))],
                   a.WindowFrame(is_rows=False, start=-1, end=1))
            .alias("x")),
        [2, 1, 2, 1, 1, 1], [2, 1, 2, 2, 1, 2], [2, 0, 2, 1, 0, 1]),
    # min over doubles skips NaN unless every value is NaN (Spark); the
    # JAX device's minimum propagates it
    "min_skips_nan": (
        lambda a: a.table(departures_table()).window(
            a.over(a.WindowAgg(a.Min(a.col("v"))), [a.col("k")])
            .alias("x")),
        [1.0, 1.0, 1.0, 2.0, 2.0, 2.0], [None] * 6),
    # avg over a decimal: an island in the port (Spark's decimal, on the
    # interpreter); the JAX device divides the unscaled sum and reads the
    # double as decimal(11,6)
    "avg_decimal": (
        lambda a: a.table(departures_table()).window(
            a.over(a.WindowAgg(a.Average(a.col("m"))), [a.col("k")])
            .alias("x")),
        ["1.875000"] * 3 + ["0.586667"] * 3, ["0.000187"] * 3
        + ["0.000058"] * 3),
    # stddev_samp over a frame: no device frame reduction in either
    # package; the JAX device raises at run time, the port's planner makes
    # the window an island
    "stddev_frame": (
        lambda a: a.table(departures_table()).window(
            a.over(a.WindowAgg(a.StddevSamp(a.col("i"))), [a.col("k")])
            .alias("x")),
        [1.0, 1.0, 1.0, 1.0, 1.0, 1.0], (NotImplementedError, "StddevSamp")),
    # lead with a default at the layout's last live row: the JAX device
    # reads the padding row after it as the same partition (null)
    "lead_default_at_the_end": (
        lambda a: a.table(departures_table()).window(
            a.over(a.LagLead(a.col("i"), 1, a.lit(-1), False),
                   [a.col("k")], _by_i(a)).alias("x")),
        [2, 3, -1, 5, 6, -1], [2, 3, -1, 5, 6, None]),
}


def _column(t, name="x"):
    vals = t.sort_by("i").column(name).to_pylist()
    return [None if isinstance(v, float) and v != v else
            (str(v) if hasattr(v, "as_tuple") else v) for v in vals]


@pytest.mark.parametrize("case", sorted(DEPARTURES))
def test_departures_pinned_both_ways(case):
    """Where the JAX device departs from Spark the port follows Spark, on
    its device and its interpreter (the JAX interpreter too, but for NaN
    order values); each case shows the port's column and the JAX
    device's (NaN read as None)."""
    q, port_col, jax_out, *jax_cpu = DEPARTURES[case]
    ses = Session(device="cpu")
    got = ses.collect(q(PORT))
    cpu = Session(ORACLE, device="cpu").collect(q(PORT))
    jcpu = JSession(ORACLE).collect(q(JAX))
    want = [None if isinstance(v, float) and v != v else v
            for v in port_col]
    assert _column(got) == want
    assert _column(cpu) == want
    assert _column(jcpu) == (jax_cpu[0] if jax_cpu else want)
    if case in ("avg_decimal", "stddev_frame"):
        assert ses.fell_back() == ["CpuFallback[Window]"]
    else:
        assert ses.fell_back() == []
    if isinstance(jax_out, tuple):
        with pytest.raises(jax_out[0], match=jax_out[1]):
            JSession().collect(q(JAX))
    else:
        assert _column(JSession().collect(q(JAX))) == jax_out


def test_range_over_a_date_order_key():
    """A value-bounded RANGE frame over a DATE order key: the devices agree
    (offsets in days); the port's interpreter adds days, where the JAX
    interpreter adds an int to a date and raises."""
    def q(a):
        return a.table(departures_table()).window(
            a.over(a.WindowAgg(a.Count(a.col("i"))), [a.col("k")],
                   [a.asc(a.col("d"))],
                   a.WindowFrame(is_rows=False, start=-3, end=0))
            .alias("x"))
    got = Session(device="cpu").collect(q(PORT))
    assert _column(got) == [1, 1, 1, 1, 1, 2]
    assert _column(JSession().collect(q(JAX))) == [1, 1, 1, 1, 1, 2]
    assert _column(Session(ORACLE, device="cpu").collect(q(PORT))) == \
        [1, 1, 1, 1, 1, 2]
    with pytest.raises(TypeError, match="datetime.date"):
        JSession(ORACLE).collect(q(JAX))


def test_decimal128_window_aggregates_are_islands_in_both():
    """Min and Max over a DECIMAL128 frame (the JAX device would reduce
    limbs elementwise with an int64 fill): the window's type signature
    refuses the column in both packages, so both run the window on their
    interpreter, with the same reasons and rows; a sum of decimal(12,2)
    into decimal(22,2) likewise."""
    import decimal
    w = [decimal.Decimal(x) for x in ("1.25", "-7.50", "3.00",
                                      "12345678901234567890.12", "0.01")]
    t = pa.table({"k": pa.array([0, 0, 0, 1, 1], pa.int32()),
                  "i": pa.array([1, 2, 3, 4, 5], pa.int64()),
                  "w": pa.array(w, pa.decimal128(25, 2)),
                  "m": pa.array(w[:3] + [decimal.Decimal("1234567890.12"),
                                         w[4]], pa.decimal128(12, 2))})

    def q(a):
        return a.table(t).window(
            a.over(a.WindowAgg(a.Min(a.col("w"))), [a.col("k")],
                   _by_i(a)).alias("mn"),
            a.over(a.WindowAgg(a.Max(a.col("w"))), [a.col("k")],
                   _by_i(a)).alias("mx"),
            a.over(a.WindowAgg(a.Sum(a.col("m"))), [a.col("k")],
                   _by_i(a)).alias("s"))
    got, ses, _ = _both(q, islands=True)
    assert ses.fell_back() == ["CpuFallback[Window]"]
    assert [str(v) for v in got.sort_by("i").column("mx").to_pylist()] == \
        ["1.25", "1.25", "3.00", w[3].__str__(), w[3].__str__()]
    assert Session(device="cpu").explain(q(PORT)) == JSession().explain(q(JAX))
