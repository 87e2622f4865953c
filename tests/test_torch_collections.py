"""The ARRAY, STRUCT and MAP kinds in the port (``types.py``, ``batch.py``,
``plan/typesig.py``, ``expressions/collections.py``, ``CollectList`` /
``CollectSet`` / ``PivotFirst``, ``StringSplit``, ``StringToMap``) against
the JAX package, on the CPU.

- The 7 cases of ``tests/test_collect.py``, the 13 of
  ``tests/test_structs.py`` but the two window ones, the ARRAY/MAP cases of
  ``tests/test_regex_spans.py`` and ``tests/test_expressions_r4.py`` but
  ``test_split_explode_roundtrip`` (in ``test_torch_generate.py``),
  ``test_pivot_first``, ``test_first_last_of_arrays_on_device`` and
  ``test_size_of_map_stays_on_device``: over the same inputs the port's
  Session gives the JAX Session's rows and ``fell_back()``.
- Every expression of the first ``collections.py`` slice evaluated by both
  packages on seeded lists with empty and null rows.
- The budgets that raise (``from_arrow``, ``to_arrow`` of a collect,
  ``split`` in every mode), a Parquet file with a list and a struct
  column, nested lanes through the wire, a fused stage and the mesh, and
  the NaN departures from the JAX device pinned both ways.

Each JAX plan runs once."""

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

from spark_rapids_tpu import types as JT
from spark_rapids_tpu.batch import ColumnarBatch as JColumnarBatch
from spark_rapids_tpu.batch import Field as JField
from spark_rapids_tpu.batch import Schema as JSchema
from spark_rapids_tpu.batch import from_arrow as jfrom_arrow
from spark_rapids_tpu.batch import to_arrow as jto_arrow
from spark_rapids_tpu.exec import AggregateMode as JAggregateMode
from spark_rapids_tpu.exec import HashAggregateExec as JHashAggregateExec
from spark_rapids_tpu.exec import InMemoryScanExec as JInMemoryScanExec
from spark_rapids_tpu.exec import ProjectExec as JProjectExec
from spark_rapids_tpu.exec import collect as jcollect
from spark_rapids_tpu.exec.join import JoinType as JJoinType
from spark_rapids_tpu.exec.sort import asc as jasc
from spark_rapids_tpu.exec.sort import desc as jdesc
from spark_rapids_tpu.expressions import col as jcol
from spark_rapids_tpu.expressions import collections as JC
from spark_rapids_tpu.expressions import lit as jlit
from spark_rapids_tpu.expressions import aggregates as JA
from spark_rapids_tpu.expressions.regex import StringSplit as JStringSplit
from spark_rapids_tpu.expressions.strings import StringToMap as JStringToMap
from spark_rapids_tpu.plan import Session as JSession
from spark_rapids_tpu.plan import table as jtable
from spark_rapids_tpu_torch import entry
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.batch import (CapacityError, ColumnarBatch,
                                          Field, Schema, from_arrow,
                                          to_arrow)
from spark_rapids_tpu_torch.exec import (AggregateMode, HashAggregateExec,
                                         InMemoryScanExec, JoinType,
                                         ProjectExec, collect)
from spark_rapids_tpu_torch.exec.sort import asc, desc
from spark_rapids_tpu_torch.expressions import col, lit
from spark_rapids_tpu_torch.expressions import aggregates as A
from spark_rapids_tpu_torch.expressions import collections as C
from spark_rapids_tpu_torch.expressions.regex import StringSplit
from spark_rapids_tpu_torch.expressions.strings import StringToMap
from spark_rapids_tpu_torch.plan import Session, table
from spark_rapids_tpu_torch.shuffle import serializer as tser

from harness.asserts import assert_tables_equal
from test_collect import CT
from test_regex_spans import str_table
from test_structs import nested_struct_table, struct_table


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Each case on one torch thread: many small ops, which a pool of
    threads per test worker only slows when the workers share the
    cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class _Api:
    def __init__(self, **kw):
        self.__dict__.update(kw)


def _api(pkg_table, pkg_col, pkg_lit, types, coll, aggs, split, s2m,
         join_type, asc_, desc_):
    return _Api(table=pkg_table, col=pkg_col, lit=pkg_lit, T=types,
                C=coll, A=aggs, StringSplit=split, StringToMap=s2m,
                JoinType=join_type, asc=asc_, desc=desc_)


JAX = _api(jtable, jcol, jlit, JT, JC, JA, JStringSplit, JStringToMap,
           JJoinType, jasc, jdesc)
PORT = _api(table, col, lit, T, C, A, StringSplit, StringToMap, JoinType,
            asc, desc)

ORACLE = {"spark.rapids.tpu.sql.enabled": False}


def _both(q, conf=None, ignore_order=True, oracle=False):
    """``q(api)`` through the port's Session and the JAX Session: the same
    rows and types and the same islands; with ``oracle``, the port's
    interpreter gives the same rows too. Returns the port's table and
    Session."""
    ses = Session(conf or {}, device="cpu")
    got = ses.collect(q(PORT))
    jses = JSession(conf or {})
    want = jses.collect(q(JAX))
    assert got.schema == want.schema
    assert_tables_equal(got, want, ignore_order=ignore_order,
                        approx_float=False)
    assert ses.fell_back() == jses.fell_back()
    if oracle:
        cpu = Session({**(conf or {}), **ORACLE}, device="cpu").collect(
            q(PORT))
        assert_tables_equal(got, cpu, ignore_order=ignore_order,
                            approx_float=False)
    return got, ses


# ---------------------------------------------------------------------------
# tests/test_collect.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("agg", ["CollectList", "CollectSet"])
def test_collect_list_and_set(agg):
    got, ses = _both(lambda a: a.table(CT, num_slices=2).group_by("k").agg(
        getattr(a.A, agg)(a.col("v")).alias("vs")))
    assert ses.fell_back() == []


def test_collect_matches_cpu_oracle():
    _both(lambda a: a.table(CT).group_by("k").agg(
        a.A.CollectList(a.col("v")).alias("vs"),
        a.A.Count().alias("n")), oracle=True)


def test_collect_list_overflow_raises():
    """A group past the budget keeps its true length and fails loud at
    ``to_arrow`` in both packages, never truncated."""
    plan = HashAggregateExec(
        [col("k")], [A.CollectList(col("v"), max_elems=8).alias("vs")],
        InMemoryScanExec(CT, device="cpu"), AggregateMode.COMPLETE)
    with pytest.raises(CapacityError, match="budget is 8"):
        collect(plan)
    jplan = JHashAggregateExec(
        [jcol("k")], [JA.CollectList(jcol("v"), max_elems=8).alias("vs")],
        JInMemoryScanExec(CT), JAggregateMode.COMPLETE)
    from spark_rapids_tpu.batch import CapacityError as JCapacityError
    with pytest.raises(JCapacityError):
        jcollect(jplan)


def _strings_table():
    rng = np.random.default_rng(175)
    words = ["", "a", "bb", "ccc", "dd", "eeee", "fffff", "gg"]
    s = [None if i % 9 == 4 else words[int(rng.integers(0, len(words)))]
         for i in range(200)]
    return pa.table({"k": pa.array(rng.integers(0, 6, 200), pa.int32()),
                     "s": pa.array(s)})


def test_collect_list_strings():
    got, ses = _both(lambda a: a.table(_strings_table()).group_by("k").agg(
        a.A.CollectList(a.col("s")).alias("xs")), oracle=True)
    assert not any("CpuFallback" in n for n in ses.executed_exec_names())


def test_collect_set_strings_dedupes():
    t = pa.table({"k": pa.array([1, 1, 1, 2, 2], pa.int32()),
                  "s": pa.array(["a", "a", "b", "x", None])})
    got, _ = _both(lambda a: a.table(t).group_by("k").agg(
        a.A.CollectSet(a.col("s")).alias("xs")), oracle=True)
    assert sorted(got.to_pylist(), key=lambda r: r["k"]) == [
        {"k": 1, "xs": ["a", "b"]}, {"k": 2, "xs": ["x"]}]


def test_two_collects_fall_back_cleanly():
    t = pa.table({"k": pa.array([1, 1, 2], pa.int32()),
                  "s": pa.array(["b", "a", "x"])})
    got, ses = _both(lambda a: a.table(t).group_by("k").agg(
        a.A.CollectList(a.col("s")).alias("l"),
        a.A.CollectSet(a.col("s")).alias("st")), oracle=True)
    assert ses.fell_back() == ["CpuFallback[Aggregate]"]


# ---------------------------------------------------------------------------
# tests/test_structs.py (but the two window cases)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("make", [struct_table, nested_struct_table])
def test_struct_storage_roundtrip(make):
    t = make()
    batch, schema = from_arrow(t, device="cpu")
    assert to_arrow(batch, schema).equals(t)
    jbatch, jschema = jfrom_arrow(t)
    assert str(schema) == str(jschema)
    # each leaf lane equals the JAX one
    kid, jkid = batch.columns[-1].data[0], jbatch.columns[-1].data[0]
    while kid.is_struct:
        kid, jkid = kid.data[0], jkid.data[0]
    np.testing.assert_array_equal(kid.data.numpy(), np.asarray(jkid.data))
    np.testing.assert_array_equal(kid.validity.numpy(),
                                  np.asarray(jkid.validity))


def test_struct_field_extraction_filter_agg():
    _both(lambda a: a.table(struct_table())
          .where(a.C.GetStructField(a.col("s"), 0) > a.lit(0))
          .group_by("grp")
          .agg(a.A.Sum(a.C.GetStructField(a.col("s"), 0)).alias("sx"),
               a.A.Count().alias("n")), oracle=True)


def test_struct_payload_through_join_and_agg():
    dims = pa.table({"d": np.arange(8, dtype=np.int32),
                     "w": np.arange(8, dtype=np.int64) * 10})
    _both(lambda a: a.table(struct_table())
          .join(a.table(dims), ["grp"], ["d"], a.JoinType.INNER)
          .group_by("grp")
          .agg(a.A.Sum(a.C.GetStructField(a.col("s"), 0)).alias("sx"),
               a.A.Sum(a.col("w")).alias("sw")))


def test_struct_sort_carry():
    _both(lambda a: a.table(struct_table())
          .order_by(a.desc(a.col("id"))).limit(20)
          .select(a.col("id"), a.C.GetStructField(a.col("s"), 2)
                  .alias("tag"), a.col("s")), ignore_order=False)


def test_struct_of_struct_extraction():
    def q(a):
        inner = a.C.GetStructField(a.col("o"), 0)
        return a.table(nested_struct_table()).select(
            a.col("k"), a.C.GetStructField(inner, 0).alias("a"),
            (a.C.GetStructField(a.col("o"), 1) + a.lit(1)).alias("s1"),
            a.col("o").is_null().alias("on"))
    _both(q, oracle=True)


def test_create_struct_materializes():
    t = pa.table({"x": pa.array([1, None, 3], type=pa.int32()),
                  "y": pa.array([1.5, 2.5, None], type=pa.float64())})
    got, ses = _both(lambda a: a.table(t).select(
        a.C.CreateStruct((a.col("x"), a.col("y")), ("x", "y")).alias("st"),
        a.col("x")), ignore_order=False, oracle=True)
    assert ses.fell_back() == []
    assert got.column("st").to_pylist() == [
        {"x": 1, "y": 1.5}, {"x": None, "y": 2.5}, {"x": 3, "y": None}]


def test_struct_through_exchange():
    _both(lambda a: a.table(struct_table(), num_slices=3).group_by("grp")
          .agg(a.A.Sum(a.C.GetStructField(a.col("s"), 0)).alias("sx")))


@pytest.mark.parametrize("shape", ["group", "join", "sort"])
def test_struct_key_falls_back_with_reason(shape):
    t = struct_table()

    def q(a):
        if shape == "group":
            return a.table(t).group_by(a.col("s")).agg(
                a.A.Count().alias("n"))
        if shape == "join":
            return a.table(t).join(a.table(t), [a.col("s")], [a.col("s")],
                                   a.JoinType.LEFT_SEMI)
        return a.table(t).order_by(a.asc(a.col("s")))
    got, ses = _both(q, oracle=True)
    assert any("CpuFallback" in n for n in ses.fell_back())
    assert "cannot be a sort/join key" in Session(device="cpu").explain(
        q(PORT))


def test_struct_spill_roundtrip():
    t = nested_struct_table()
    batch, schema = from_arrow(t, device="cpu")
    blob = tser.serialize_batch(batch, schema, codec="lz4")
    assert tser.deserialize_batch(blob, schema).columns[1].is_struct
    assert to_arrow(tser.deserialize_batch(blob, schema), schema).equals(t)
    # the JAX package reads the port's frame
    from spark_rapids_tpu.shuffle.serializer import deserialize_batch
    jschema = jfrom_arrow(t)[1]
    assert jto_arrow(deserialize_batch(blob, jschema), jschema).equals(t)


def test_count_struct_column_on_device():
    got, ses = _both(lambda a: a.table(struct_table()).group_by("grp").agg(
        a.A.Count(a.col("s")).alias("cs"), a.A.Count().alias("c")))
    assert ses.fell_back() == []


def test_struct_payload_fused_and_on_the_mesh():
    """A struct payload through a fused stage and under the ICI shuffle
    gets the JAX Session's tree and islands. The fused stage runs in both
    packages; on the mesh the JAX package cannot stack a struct column
    (``parallel/mesh.py`` ``stack_batches`` raises ``TypeError``), where
    the port's shards carry it and answer as the host path does (ROADMAP
    Queue 3, a JAX-side fault not queued)."""
    def fusable(a):
        return a.table(struct_table()).where(a.col("id") > a.lit(10)) \
            .select(a.col("id"), a.col("s"))
    _, ses = _both(fusable, ignore_order=False)
    assert ses.executed_exec_names() == ["FusedStageExec"]
    conf = entry.session_conf(8, **entry.ici_conf(8))

    def meshed(a):
        return a.table(struct_table(), num_slices=8).group_by("grp").agg(
            a.A.Sum(a.C.GetStructField(a.col("s"), 0)).alias("sx"))
    ses = Session(conf, device="cpu")
    got = ses.collect(meshed(PORT))
    jses = JSession(conf)
    jses.prepare(meshed(JAX))
    assert ses.last_plan.lowered == jses.last_plan.lowered
    assert ses.executed_exec_names() == ["MeshStageExec"]
    assert ses.fell_back() == [] == jses.fell_back()
    host = Session(entry.session_conf(8), device="cpu").collect(
        meshed(PORT))
    assert_tables_equal(got, host, ignore_order=True, approx_float=False)
    with pytest.raises(TypeError, match="stack requires ndarray"):
        JSession(conf).collect(meshed(JAX))


# ---------------------------------------------------------------------------
# The ARRAY/MAP cases of tests/test_regex_spans.py and
# tests/test_expressions_r4.py, and three more
# ---------------------------------------------------------------------------

def test_split():
    _both(lambda a: a.table(str_table()).select(
        a.StringSplit(a.col("s"), r"-").alias("parts"),
        a.StringSplit(a.col("s"), r"[0-9]+").alias("by_num"),
        a.StringSplit(a.col("s"), r" +", limit=2).alias("two")),
        ignore_order=False, oracle=True)


def test_split_element_at():
    got, ses = _both(lambda a: a.table(str_table()).select(
        a.C.GetArrayItem(a.StringSplit(a.col("s"), r"-"), a.lit(0))
        .alias("first"),
        a.C.Size(a.StringSplit(a.col("s"), r"-")).alias("n")),
        ignore_order=False, oracle=True)
    assert ses.fell_back() == []


def test_cpu_split_zero_width():
    """Java Pattern.split: 'abc'.split('x*') gives a piece per char; the
    device refuses the empty-matching pattern and limit 0."""
    def q(a):
        return a.table(pa.table({"s": pa.array(["abc", ""])})).select(
            a.StringSplit(a.col("s"), r"x*").alias("p"),
            a.StringSplit(a.col("s"), r"x*", limit=0).alias("p0"))
    out = Session(ORACLE, device="cpu").collect(q(PORT))
    assert out.column("p").to_pylist() == [["a", "b", "c", ""], [""]]
    assert out.column("p0").to_pylist() == [["a", "b", "c"], []]
    assert out.equals(JSession(ORACLE).collect(q(JAX)))
    ses = Session(device="cpu")
    assert ses.collect(q(PORT)).equals(out)
    assert ses.fell_back() == ["CpuFallback[Project]"]


def test_array_decimal_roundtrip():
    import decimal as pydec
    vals = [[pydec.Decimal("1.23"), pydec.Decimal("-4.50")], [], None]
    t = pa.table({"a": pa.array(vals, pa.list_(pa.decimal128(5, 2)))})
    b, sch = from_arrow(t, device="cpu")
    assert to_arrow(b, sch).column("a").to_pylist() == vals
    jb, _ = jfrom_arrow(t)
    np.testing.assert_array_equal(b.columns[0].data.numpy(),
                                  np.asarray(jb.columns[0].data))


@pytest.mark.parametrize("ansi", [False, True])
def test_split_overflow_raises(ansi):
    """``CAPACITY_split_max_elems`` raises in every mode, as in the JAX
    package."""
    def q(a):
        return a.table(pa.table({"s": pa.array(["a,b,c,d,e", "x"])})) \
            .select(a.StringSplit(a.col("s"), r",", max_elems=3).alias("p"))
    conf = {"spark.rapids.tpu.sql.ansi.enabled": ansi}
    with pytest.raises(CapacityError, match="split_max_elems"):
        Session(conf, device="cpu").collect(q(PORT))
    from spark_rapids_tpu.batch import CapacityError as JCapacityError
    with pytest.raises(JCapacityError, match="split_max_elems"):
        JSession(conf).collect(q(JAX))


def _project(a, t, exprs):
    if a is PORT:
        return collect(ProjectExec(exprs, InMemoryScanExec(t, device="cpu")))
    return jcollect(JProjectExec(exprs, JInMemoryScanExec(t)))


def test_str_to_map_and_consumers():
    t = pa.table({"s": pa.array(["a:1,b:2", "k:v", "solo", "", None,
                                 "x:1,x:9"])})

    def consumers(a):
        m = a.StringToMap(a.col("s"))
        return _project(a, t, [
            a.C.GetMapValue(m, a.lit("a")).alias("va"),
            a.C.GetMapValue(m, a.lit("x")).alias("vx"),
            a.C.GetMapValue(m, a.lit("solo")).alias("vs"),
            a.C.MapContainsKey(m, a.lit("b")).alias("cb"),
            a.C.MapKeys(m).alias("k"), a.C.MapValues(m).alias("v")])
    out = consumers(PORT)
    assert out.equals(consumers(JAX))
    assert out.column("va").to_pylist() == ["1", None, None, None, None,
                                            None]
    # duplicate keys: the last wins a read
    assert out.column("vx").to_pylist() == [None] * 5 + ["9"]
    # an entry without the kv delimiter: the key is there, its value null
    assert out.column("vs").to_pylist() == [None] * 6
    assert out.column("cb").to_pylist() == [True, False, False, False,
                                            None, False]
    keys = out.column("k").to_pylist()
    assert keys[0] == ["a", "b"] and keys[2] == ["solo"] and keys[1] == ["k"]
    vals = out.column("v").to_pylist()
    assert vals[0] == ["1", "2"] and vals[2] == [""]
    # the map layout itself, bit for bit with the JAX one
    batch, schema = from_arrow(t, device="cpu")
    jbatch, jschema = jfrom_arrow(t)
    m = StringToMap(col("s")).bind(schema).eval(batch)
    jm = JStringToMap(jcol("s")).bind(jschema).eval(jbatch)
    for ours, theirs in ((m.data, jm.data), (m.data2, jm.data2),
                         (m.lengths, jm.lengths),
                         (m.validity, jm.validity)):
        np.testing.assert_array_equal(ours.numpy(), np.asarray(theirs))
    # the interpreter keeps duplicate entries, as the device does (the
    # JAX handler's dict keeps the last)
    q = lambda a: a.table(t).select(a.StringToMap(a.col("s")).alias("m"))
    assert Session(ORACLE, device="cpu").collect(q(PORT)).column(
        "m").to_pylist()[5] == [("x", "1"), ("x", "9")]
    assert JSession(ORACLE).collect(q(JAX)).column(
        "m").to_pylist()[5] == [("x", "9")]
    assert Session(device="cpu").collect(q(PORT)).column(
        "m").to_pylist()[5] == [("x", "1"), ("x", "9")]


def test_pivot_first():
    t = pa.table({"g": pa.array([1, 1, 2, 2, 2], pa.int64()),
                  "p": pa.array(["x", "y", "x", "z", "x"]),
                  "v": pa.array([10, 20, 30, 40, 50], pa.int64())})

    agg = HashAggregateExec(
        [col("g")], [A.PivotFirst(col("v"), col("p"),
                                  ("x", "y")).alias("pv")],
        InMemoryScanExec(t, device="cpu"), AggregateMode.COMPLETE)
    out = collect(ProjectExec(
        [col("g"), C.GetArrayItem(col("pv"), lit(0)).alias("x"),
         C.GetArrayItem(col("pv"), lit(1)).alias("y")], agg))
    jagg = JHashAggregateExec(
        [jcol("g")], [JA.PivotFirst(jcol("v"), jcol("p"),
                                    ("x", "y")).alias("pv")],
        JInMemoryScanExec(t), JAggregateMode.COMPLETE)
    assert out.equals(jcollect(JProjectExec(
        [jcol("g"), JC.GetArrayItem(jcol("pv"), jlit(0)).alias("x"),
         JC.GetArrayItem(jcol("pv"), jlit(1)).alias("y")], jagg)))
    got = {g: (x, y) for g, x, y in zip(*[out.column(c).to_pylist()
                                          for c in ("g", "x", "y")])}
    assert got == {1: (10, 20), 2: (30, None)}
    # the pivot array itself: a missing combination is a null element in
    # the port, as in Spark and both interpreters (the Session's, over an
    # integer pivot: a string one is an island in both packages); the JAX
    # device's download drops the element validity and gives 0 (ROADMAP
    # Queue 3, not faults)
    assert {r["g"]: r["pv"] for r in collect(agg).to_pylist()} == \
        {1: [10, 20], 2: [30, None]}
    assert {r["g"]: r["pv"] for r in jcollect(jagg).to_pylist()} == \
        {1: [10, 20], 2: [30, 0]}
    ti = t.set_column(1, "p", pa.array([7, 8, 7, 9, 7], pa.int32()))
    df = table(ti).group_by("g").agg(A.PivotFirst(
        col("v"), col("p"), (7, 8, None)).alias("pv"))
    ses = Session(device="cpu")
    rows = {r["g"]: r["pv"] for r in ses.collect(df).to_pylist()}
    assert ses.fell_back() == []
    assert rows == {r["g"]: r["pv"] for r in Session(
        ORACLE, device="cpu").collect(df).to_pylist()}
    assert rows == {1: [10, 20, None], 2: [30, None, None]}


def test_first_last_of_arrays_on_device():
    t = pa.table({"k": pa.array([0, 0, 1], pa.int32()),
                  "vs": pa.array([[1, 2], [3], []], pa.list_(pa.int64()))})
    got, ses = _both(lambda a: a.table(t).group_by("k").agg(
        a.A.First(a.col("vs")).alias("f"), a.A.Count(a.col("vs")).alias("c")))
    assert ses.fell_back() == []
    assert dict(zip(got.column("k").to_pylist(),
                    got.column("f").to_pylist())) == {0: [1, 2], 1: []}


def test_size_of_map_stays_on_device():
    maps = [[(1, 2)], [], None]
    t = pa.table({"m": pa.array(maps, pa.map_(pa.int32(), pa.int64()))})
    got, ses = _both(lambda a: a.table(t).select(
        a.C.Size(a.col("m")).alias("n")), ignore_order=False, oracle=True)
    assert ses.fell_back() == []
    assert got.column("n").to_pylist() == [1, 0, -1]


# ---------------------------------------------------------------------------
# Every expression of the slice, function by function, against the JAX
# module
# ---------------------------------------------------------------------------

def _lists(seed=7, n=300):
    """Seeded lists with empty and null rows: int64 and double elements,
    strings, an int map, an int probe and index per row, a struct."""
    rng = np.random.default_rng(seed)
    ints, dbls, strs, maps = [], [], [], []
    for i in range(n):
        ln = int(rng.integers(0, 7))
        if i % 11 == 3:
            ints.append(None), dbls.append(None), strs.append(None)
            maps.append(None)
            continue
        if i % 7 == 0:
            ln = 0
        ints.append([int(v) for v in rng.integers(-9, 9, ln)])
        dbls.append([float(v) for v in rng.normal(0, 5, ln).round(2)])
        strs.append(["w" * int(k) for k in rng.integers(0, 5, ln)])
        keys = rng.choice(6, ln, replace=True)
        maps.append([(int(k), int(v)) for k, v in
                     zip(keys, rng.integers(-50, 50, ln))])
    probe = rng.integers(-9, 9, n)
    idx = rng.integers(-7, 8, n).astype(np.int32)
    st = pa.StructArray.from_arrays(
        [pa.array(rng.integers(0, 9, n), pa.int64()),
         pa.array(["t" * int(k) for k in rng.integers(0, 4, n)])],
        names=["a", "b"], mask=pa.array(np.arange(n) % 5 == 2))
    return pa.table({
        "ia": pa.array(ints, pa.list_(pa.int64())),
        "da": pa.array(dbls, pa.list_(pa.float64())),
        "sa": pa.array(strs, pa.list_(pa.string())),
        "m": pa.array(maps, pa.map_(pa.int32(), pa.int64())),
        "p": pa.array(probe, pa.int64()),
        "pw": pa.array(["w" * int(k) for k in rng.integers(0, 5, n)]),
        "i": pa.array(idx),
        "mk": pa.array(rng.integers(0, 7, n).astype(np.int32)),
        "st": st})


def _exprs(a):
    """(name, expression) of every expression of the slice."""
    c, k = a.col, a.C
    ia, da, sa, m = c("ia"), c("da"), c("sa"), c("m")
    return [
        ("create_array", k.CreateArray((c("p"), c("p") + a.lit(1, a.T.INT64),
                                        a.lit(5, a.T.INT64)))),
        ("size_ia", k.Size(ia)), ("size_sa", k.Size(sa)),
        ("size_m", k.Size(m)),
        ("contains_ia", k.ArrayContains(ia, c("p"))),
        ("contains_da", k.ArrayContains(da, a.lit(1.5))),
        ("contains_sa", k.ArrayContains(sa, c("pw"))),
        ("element_at_ia", k.ElementAt(ia, c("i"))),
        ("element_at_da", k.ElementAt(da, a.lit(-1))),
        ("element_at_sa", k.ElementAt(sa, c("i"))),
        ("item_ia", k.GetArrayItem(ia, c("i"))),
        ("item_sa", k.GetArrayItem(sa, a.lit(1))),
        ("sort_asc_ia", k.SortArray(ia, True)),
        ("sort_desc_ia", k.SortArray(ia, False)),
        ("sort_desc_da", k.SortArray(da, False)),
        ("min_ia", k.ArrayMin(ia)), ("max_ia", k.ArrayMax(ia)),
        ("min_da", k.ArrayMin(da)), ("max_da", k.ArrayMax(da)),
        ("create_struct", k.CreateStruct((c("p"), c("pw"), ia),
                                         ("p", "pw", "ia"))),
        ("struct_field_a", k.GetStructField(c("st"), 0)),
        ("struct_field_b", k.GetStructField(c("st"), 1)),
        ("map_keys", k.MapKeys(m)), ("map_values", k.MapValues(m)),
        ("map_value", k.GetMapValue(m, c("mk"))),
        ("map_contains", k.MapContainsKey(m, c("mk"))),
        ("map_from_arrays", k.MapFromArrays(ia, k.SortArray(ia, True))),
    ]


@pytest.mark.parametrize("name", [n for n, _ in _exprs(PORT)])
def test_expression_against_jax_module(name):
    t = _lists()
    batch, schema = from_arrow(t, device="cpu")
    jbatch, jschema = jfrom_arrow(t)
    e = dict(_exprs(PORT))[name].bind(schema)
    je = dict(_exprs(JAX))[name].bind(jschema)
    out = e.eval(batch)
    jout = je.eval(jbatch)
    assert str(e.dtype) == str(je.dtype)
    got = to_arrow(ColumnarBatch((out,), batch.num_rows),
                   Schema([Field("x", e.dtype)]))
    want = jto_arrow(JColumnarBatch((jout,), jbatch.num_rows),
                     JSchema([JField("x", je.dtype)]))
    assert got.equals(want), name
    # and the port's interpreter, row by row
    cpu = Session(ORACLE, device="cpu").collect(
        table(t).select(dict(_exprs(PORT))[name].alias("x")))
    assert cpu.column("x").to_pylist() == got.column("x").to_pylist()


def test_nan_departures_pinned_both_ways():
    """Not faults: over NaN the port follows Spark (NaN above every value,
    equal to itself); the JAX device sorts a descending NaN past the end,
    reduces with a NaN that wins both ways and finds no NaN."""
    nan = float("nan")
    t = pa.table({"d": pa.array([[1.0, nan, -2.0], [nan]],
                                pa.list_(pa.float64()))})

    def q(a):
        d = a.col("d")
        return a.table(t).select(
            a.C.SortArray(d, False).alias("desc"),
            a.C.ArrayMin(d).alias("mn"), a.C.ArrayMax(d).alias("mx"),
            a.C.ArrayContains(d, a.lit(nan)).alias("has"))
    got = Session(device="cpu").collect(q(PORT)).to_pylist()
    assert str(got) == str([
        {"desc": [nan, 1.0, -2.0], "mn": -2.0, "mx": nan, "has": True},
        {"desc": [nan], "mn": nan, "mx": nan, "has": True}])
    assert str(Session(ORACLE, device="cpu").collect(q(PORT)).to_pylist()) \
        == str(got)
    want = JSession({}).collect(q(JAX)).to_pylist()
    assert str(want) == str([
        {"desc": [1.0, -2.0, -float("inf")], "mn": nan, "mx": nan,
         "has": False},
        {"desc": [-float("inf")], "mn": nan, "mx": nan, "has": False}])


# ---------------------------------------------------------------------------
# Budgets, Parquet, the wire
# ---------------------------------------------------------------------------

def test_from_arrow_refuses_what_it_cannot_hold():
    """A list past its budget raises ``CapacityError``; null and nested
    elements ``TypeError``, as in the JAX package; the planner makes the
    null-element scan an island with the JAX reason."""
    over = pa.table({"a": pa.array([[1, 2, 3]], pa.list_(pa.int64()))})
    schema = Schema([Field("a", T.array(T.INT64, 2))])
    jschema = JSchema([JField("a", JT.array(JT.INT64, 2))])
    from spark_rapids_tpu.batch import CapacityError as JCapacityError
    with pytest.raises(CapacityError):
        from_arrow(over, schema=schema, device="cpu")
    with pytest.raises(JCapacityError):
        jfrom_arrow(over, schema=jschema)
    for bad in (pa.array([[1, None]], pa.list_(pa.int64())),
                pa.array([[[1]]], pa.list_(pa.list_(pa.int64())))):
        t = pa.table({"a": bad})
        with pytest.raises(TypeError):
            from_arrow(t, device="cpu")
        with pytest.raises(TypeError):
            jfrom_arrow(t)
        _, ses = _both(lambda a: a.table(t).select(
            a.C.Size(a.col("a")).alias("n")), ignore_order=False,
            oracle=True)
        assert ses.fell_back()


def test_parquet_list_and_struct_columns(tmp_path):
    """The native decoder hands nested columns to pyarrow; both Sessions
    read them to the same rows, on the device."""
    from spark_rapids_tpu.io import read_parquet as jread_parquet
    from spark_rapids_tpu_torch.io import read_parquet
    t = _lists(seed=9, n=200).select(["ia", "st", "p"])
    path = str(tmp_path / "nested.parquet")
    pq.write_table(t, path, row_group_size=64)

    def q(read, a):
        return read([path]).select(
            a.C.Size(a.col("ia")).alias("n"),
            a.C.GetStructField(a.col("st"), 0).alias("sa"),
            a.col("ia"), a.col("p"))
    ses = Session({}, device="cpu")
    got = ses.collect(q(read_parquet, PORT))
    want = JSession({}).collect(q(jread_parquet, JAX))
    assert ses.fell_back() == []
    assert_tables_equal(got, want, ignore_order=True, approx_float=False)


def test_array_and_map_lanes_cross_the_wire():
    t = _lists(seed=3, n=150).select(["ia", "sa", "m", "st"])
    batch, schema = from_arrow(t, device="cpu")
    blob = tser.serialize_batch(batch, schema, codec="lz4")
    assert to_arrow(tser.deserialize_batch(blob, schema), schema).equals(t)
    from spark_rapids_tpu.shuffle.serializer import serialize_batch
    jbatch, jschema = jfrom_arrow(t)
    jblob = serialize_batch(jbatch, jschema, codec="lz4")
    assert to_arrow(tser.deserialize_batch(jblob, schema),
                    schema).equals(t)


def test_nested_lanes_through_the_spill_tiers(tmp_path):
    """A batch of arrays, strings arrays, a map and a struct spilled to
    host memory and to disk comes back equal."""
    from spark_rapids_tpu_torch.memory import catalog as tcatalog
    t = _lists(seed=5, n=200).select(["ia", "sa", "m", "st"])
    batch, schema = from_arrow(t, device="cpu")
    size = batch.size_bytes()
    other = from_arrow(_lists(seed=6, n=200).select(["ia", "sa", "m", "st"]),
                       schema=schema, device="cpu")[0]
    for host_limit in (1 << 30, size // 2):        # host, then disk
        cat = tcatalog.BufferCatalog(device_limit=size + 100,
                                     host_limit=host_limit,
                                     spill_dir=str(tmp_path))
        hid = cat.register(batch, schema)
        hid2 = cat.register(other, schema)
        assert cat.tier_of(hid) is not tcatalog.StorageTier.DEVICE
        got = cat.acquire(hid)
        assert to_arrow(got, schema).equals(t)
        cat.release(hid)
        cat.remove(hid)
        cat.remove(hid2)
        assert cat.total_pinned() == 0
