"""The second half of ``collections.py`` in the port (the lambdas and the
higher-order functions, the set operations, remove/position/repeat/slice/
sequence/flatten, the map lambdas, ``zip_with`` and ``replicaterows``)
against the JAX package, on the CPU.

- The 27 cases of ``tests/test_collections.py``, the six collection cases
  of ``tests/test_expressions_breadth.py``, ``test_replicate_rows_explode``
  of ``tests/test_expressions_r4.py`` and the ``Sequence`` and
  ``ArrayRepeat`` cases of ``tests/test_typesig_params.py``: over the same
  inputs the port's Session gives the JAX Session's rows (exactly),
  ``fell_back()`` and reasons; where the JAX case holds the device against
  the row interpreter, the port's interpreter gives the same rows too.
- Every new expression evaluated by both packages' modules on seeded lists
  with empty and null rows, and by the port's row interpreter; a fused
  stage that holds a lambda; the tagging reasons of a nullable body, a
  non-literal ``array_repeat`` count and ``flatten`` of a column.
- The departures from Spark pinned both ways (NaN in the set operations,
  ``sequence`` against its direction or with a step of 0), and the order
  lines leg at SF 0.01 against its pyarrow reference.

Each JAX plan runs once; every case runs on one torch thread."""


import jax
import numpy as np
import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu import types as JT
from spark_rapids_tpu.batch import ColumnarBatch as JColumnarBatch
from spark_rapids_tpu.batch import Field as JField
from spark_rapids_tpu.batch import Schema as JSchema
from spark_rapids_tpu.batch import from_arrow as jfrom_arrow
from spark_rapids_tpu.batch import to_arrow as jto_arrow
from spark_rapids_tpu.exec import InMemoryScanExec as JInMemoryScanExec
from spark_rapids_tpu.exec import ProjectExec as JProjectExec
from spark_rapids_tpu.exec.base import collect as jcollect
from spark_rapids_tpu.exec.generate import GenerateExec as JGenerateExec
from spark_rapids_tpu.exec.sort import asc as jasc
from spark_rapids_tpu.expressions import Coalesce as JCoalesce
from spark_rapids_tpu.expressions import col as jcol
from spark_rapids_tpu.expressions import collections as JC
from spark_rapids_tpu.expressions import lit as jlit
from spark_rapids_tpu.plan import Session as JSession
from spark_rapids_tpu.plan import table as jtable
from spark_rapids_tpu_torch import entry
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.batch import (CapacityError, ColumnarBatch,
                                          Field, Schema, from_arrow,
                                          to_arrow)
from spark_rapids_tpu_torch.exec import (InMemoryScanExec, ProjectExec,
                                         collect)
from spark_rapids_tpu_torch.exec.generate import GenerateExec
from spark_rapids_tpu_torch.exec.sort import asc
from spark_rapids_tpu_torch.expressions import Coalesce, col, lit
from spark_rapids_tpu_torch.expressions import collections as C
from spark_rapids_tpu_torch.plan import Session, table

from harness.asserts import assert_tables_equal
from test_collections import arr_table, map_table, str_arr_table


@pytest.fixture(autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class _Api:
    def __init__(self, **kw):
        self.__dict__.update(kw)


JAX = _Api(table=jtable, col=jcol, lit=jlit, T=JT, C=JC, asc=jasc,
           Coalesce=JCoalesce, Session=JSession)
PORT = _Api(table=table, col=col, lit=lit, T=T, C=C, asc=asc,
            Coalesce=Coalesce, Session=lambda conf=None: Session(
                conf or {}, device="cpu"))

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


def _falls_back(q, node: str):
    """Both Sessions send ``node`` to the CPU with the same reasons, and
    the port's rows equal its interpreter's."""
    got, ses = _both(q, oracle=True)
    assert any(node in n for n in ses.fell_back()), ses.fell_back()
    text = ses.explain(q(PORT))
    assert text == JSession().explain(q(JAX))
    return text


def _v(api, t=None, name="x"):
    return api.C.hof_var(t or api.T.INT64, name)


# ---------------------------------------------------------------------------
# tests/test_collections.py, case by case
# ---------------------------------------------------------------------------

def test_size():
    _both(lambda a: a.table(arr_table()).select(
        "k", a.C.Size(a.col("vs")).alias("n")), oracle=True)


def test_array_contains():
    _both(lambda a: a.table(arr_table()).select(
        a.C.ArrayContains(a.col("vs"), a.col("x")).alias("has"),
        a.C.ArrayContains(a.col("vs"), a.lit(np.int64(3))).alias("has3")),
        oracle=True)


def test_element_at_and_subscript():
    _both(lambda a: a.table(arr_table()).select(
        a.C.ElementAt(a.col("vs"), a.lit(1)).alias("first"),
        a.C.ElementAt(a.col("vs"), a.lit(-1)).alias("last"),
        a.C.ElementAt(a.col("vs"), a.lit(9)).alias("oob"),
        a.C.GetArrayItem(a.col("vs"), a.lit(0)).alias("sub0"),
        a.C.GetArrayItem(a.col("vs"), a.lit(2)).alias("sub2")), oracle=True)


def test_sort_array_minmax():
    _both(lambda a: a.table(arr_table()).select(
        a.C.SortArray(a.col("vs")).alias("asc"),
        a.C.SortArray(a.col("vs"), ascending=False).alias("desc"),
        a.C.ArrayMin(a.col("vs")).alias("mn"),
        a.C.ArrayMax(a.col("vs")).alias("mx")), oracle=True)


def test_create_array():
    _both(lambda a: a.table(arr_table()).select(
        a.C.CreateArray((a.col("x"), a.col("x") * a.lit(np.int64(2))))
        .alias("a")), oracle=True)


def test_struct_fold():
    def q(a):
        s = a.C.CreateStruct((a.col("x"), a.col("k")), ("x", "k"))
        return a.table(arr_table()).select(
            a.C.GetStructField(s, 0).alias("sx"),
            a.C.GetStructField(s, 1).alias("sk"))
    _both(q, oracle=True)


def test_transform():
    def q(a):
        v = _v(a)
        return a.table(arr_table()).select(a.C.TransformArray(
            a.col("vs"), v, v * a.lit(np.int64(3))).alias("t"))
    _, ses = _both(q, oracle=True)
    assert ses.fell_back() == []


def test_filter_hof():
    def q(a):
        v = _v(a)
        return a.table(arr_table()).select(a.C.FilterArray(
            a.col("vs"), v, v > a.lit(np.int64(0))).alias("f"))
    _both(q, oracle=True)


def test_exists_forall():
    def q(a):
        v, w = _v(a), _v(a)
        return a.table(arr_table()).select(
            a.C.ExistsArray(a.col("vs"), v, v > a.lit(np.int64(10)))
            .alias("ex"),
            a.C.ForallArray(a.col("vs"), w, w > a.lit(np.int64(-25)))
            .alias("fa"))
    _both(q, oracle=True)


def test_aggregate_hof():
    def q(a):
        acc, x = _v(a, name="acc"), _v(a)
        return a.table(arr_table()).select(a.C.AggregateArray(
            a.col("vs"), a.lit(np.int64(0)), acc, x, acc + x).alias("s"))
    _both(q, oracle=True)


def test_hof_uses_outer_column():
    """The body reads ``x``, which the HOF's children leave out: tagging
    and the port's gather of the body's columns both find it."""
    def q(a):
        v = _v(a)
        return a.table(arr_table()).select(a.C.TransformArray(
            a.col("vs"), v, v + a.col("x")).alias("t"))
    _, ses = _both(q, oracle=True)
    assert ses.fell_back() == []


def test_map_h2d_roundtrip():
    t = map_table()
    batch, schema = from_arrow(t, device="cpu")
    back = to_arrow(batch, schema)
    assert back.column("m").to_pylist() == t.column("m").to_pylist()
    jbatch, jschema = jfrom_arrow(t)
    assert jto_arrow(jbatch, jschema).equals(back)


def test_map_keys_values():
    _both(lambda a: a.table(map_table()).select(
        a.C.MapKeys(a.col("m")).alias("ks"),
        a.C.MapValues(a.col("m")).alias("vs"),
        a.C.Size(a.col("m")).alias("n")), oracle=True)


def test_get_map_value():
    _both(lambda a: a.table(map_table()).select(
        a.C.GetMapValue(a.col("m"), a.col("q")).alias("at_q"),
        a.C.GetMapValue(a.col("m"), a.lit(np.int32(7))).alias("at7"),
        a.C.MapContainsKey(a.col("m"), a.col("q")).alias("has_q")),
        oracle=True)


def test_map_from_arrays():
    def q(a):
        v = _v(a)
        return a.table(arr_table()).select(a.C.GetMapValue(
            a.C.MapFromArrays(a.col("vs"), a.C.TransformArray(
                a.col("vs"), v, v * a.lit(np.int64(2)))),
            a.lit(np.int64(4))).alias("doubled4"))
    _both(q, oracle=True)


def test_map_scan_runs_on_tpu():
    _, ses = _both(lambda a: a.table(map_table()).select(
        a.C.MapKeys(a.col("m")).alias("ks")))
    assert not ses.fell_back()


def test_explode_map():
    _both(lambda a: a.table(map_table()).explode("m"), oracle=True)


def test_explode_map_outer_pos():
    _both(lambda a: a.table(map_table()).explode("m", outer=True, pos=True),
          oracle=True)


def test_explode_non_array_raises():
    with pytest.raises(TypeError, match="array or map"):
        table(map_table()).explode("q")
    with pytest.raises(TypeError, match="array or map"):
        jtable(map_table()).explode("q")


def test_array_sort_key_falls_back():
    _falls_back(lambda a: a.table(arr_table()).order_by("vs"), "Sort")


def test_null_element_arrays_on_cpu():
    """Arrays with null elements stay on the interpreter, with Spark's
    null semantics, in both packages."""
    t = pa.table({"vs": pa.array([[3, None, 1], [None], [], None],
                                 pa.list_(pa.int64()))})

    def q(a):
        return a.table(t).select(
            a.C.SortArray(a.col("vs")).alias("s"),
            a.C.SortArray(a.col("vs"), ascending=False).alias("sd"),
            a.C.ArrayMin(a.col("vs")).alias("mn"),
            a.C.ArrayMax(a.col("vs")).alias("mx"),
            a.C.ArrayContains(a.col("vs"), a.lit(np.int64(7)))
            .alias("has7"),
            a.C.ArrayContains(a.col("vs"), a.lit(np.int64(3)))
            .alias("has3"))
    out = Session(ORACLE, device="cpu").collect(q(PORT))
    assert out.column("s").to_pylist() == [[None, 1, 3], [None], [], None]
    assert out.column("sd").to_pylist() == [[3, 1, None], [None], [], None]
    assert out.column("mn").to_pylist() == [1, None, None, None]
    assert out.column("mx").to_pylist() == [3, None, None, None]
    assert out.column("has7").to_pylist() == [None, None, False, None]
    assert out.column("has3").to_pylist() == [True, None, False, None]
    assert out.equals(JSession(ORACLE).collect(q(JAX)))


def test_map_null_value_rejected_at_h2d():
    t = pa.table({"m": pa.array([[(1, 10), (2, None)]],
                                pa.map_(pa.int32(), pa.int64()))})
    with pytest.raises(TypeError, match="null keys/values"):
        from_arrow(t, device="cpu")
    with pytest.raises(TypeError, match="null keys/values"):
        jfrom_arrow(t)


def test_get_map_value_nullable_gates_create_array():
    _falls_back(lambda a: a.table(map_table()).select(
        a.C.CreateArray((a.C.GetMapValue(a.col("m"), a.lit(np.int32(99))),)
                        ).alias("a")), "Project")


def test_array_contains_strings_on_device():
    _, ses = _both(lambda a: a.table(str_arr_table()).select(
        a.C.ArrayContains(a.col("a"), a.lit("a")).alias("lit_hit"),
        a.C.ArrayContains(a.col("a"), a.col("v")).alias("col_hit")),
        oracle=True)
    assert ses.fell_back() == []


def test_array_position_strings_on_device():
    _, ses = _both(lambda a: a.table(str_arr_table()).select(
        a.C.ArrayPosition(a.col("a"), a.lit("a")).alias("p"),
        a.C.ArrayPosition(a.col("a"), a.col("v")).alias("pv")), oracle=True)
    assert ses.fell_back() == []


def test_array_remove_strings_on_device():
    _, ses = _both(lambda a: a.table(str_arr_table()).select(
        a.C.ArrayRemove(a.col("a"), a.lit("a")).alias("r")), oracle=True)
    assert ses.fell_back() == []


def test_element_at_strings_on_device():
    _, ses = _both(lambda a: a.table(str_arr_table()).select(
        a.C.ElementAt(a.col("a"), a.lit(1)).alias("e")), oracle=True)
    assert ses.fell_back() == []


# ---------------------------------------------------------------------------
# tests/test_expressions_breadth.py (collections), test_expressions_r4.py's
# replicaterows and tests/test_typesig_params.py's two collection cases:
# ProjectExec over a scan, as the JAX cases run them
# ---------------------------------------------------------------------------

ARR = pa.table({
    "a": pa.array([[1, 2, 2, 3], [5, 5], [], None], pa.list_(pa.int64())),
    "b": pa.array([[2, 9], [5], [1], [4]], pa.list_(pa.int64())),
})
MAPT = pa.table({"m": pa.array([[(1, 10), (2, 20)], [(3, 30)], []],
                               pa.map_(pa.int64(), pa.int64()))})


def _project_both(t, make):
    """``make(api)``'s expressions as a ProjectExec over a scan of ``t``
    in each package: equal tables; returns the port's."""
    got = collect(ProjectExec(make(PORT), InMemoryScanExec(t, device="cpu")))
    want = jcollect(JProjectExec(make(JAX), JInMemoryScanExec(t)))
    assert got.equals(want)
    return got


def test_array_set_ops():
    out = _project_both(ARR, lambda a: [
        a.C.ArrayDistinct(a.col("a")).alias("d"),
        a.C.ArrayUnion(a.col("a"), a.col("b")).alias("u"),
        a.C.ArrayIntersect(a.col("a"), a.col("b")).alias("i"),
        a.C.ArrayExcept(a.col("a"), a.col("b")).alias("e"),
        a.C.ArraysOverlap(a.col("a"), a.col("b")).alias("o")])
    assert out.column("d").to_pylist() == [[1, 2, 3], [5], [], None]
    assert out.column("u").to_pylist() == [[1, 2, 3, 9], [5], [1], None]
    assert out.column("i").to_pylist() == [[2], [5], [], None]
    assert out.column("e").to_pylist() == [[1, 3], [], [], None]
    assert out.column("o").to_pylist() == [True, True, False, None]


def test_array_remove_position_repeat_slice():
    out = _project_both(ARR, lambda a: [
        a.C.ArrayRemove(a.col("a"), a.lit(2, a.T.INT64)).alias("r"),
        a.C.ArrayPosition(a.col("a"), a.lit(5, a.T.INT64)).alias("p"),
        a.C.ArraySlice(a.col("a"), a.lit(2), a.lit(2)).alias("s"),
        a.C.ArraySlice(a.col("a"), a.lit(-2), a.lit(2)).alias("neg"),
        a.C.ArrayRepeat(a.lit(7, a.T.INT64), a.lit(3)).alias("rep")])
    assert out.column("r").to_pylist() == [[1, 3], [5, 5], [], None]
    assert out.column("p").to_pylist() == [0, 1, 0, None]
    assert out.column("s").to_pylist() == [[2, 2], [5], [], None]
    assert out.column("neg").to_pylist() == [[2, 3], [5, 5], [], None]
    assert out.column("rep").to_pylist() == [[7, 7, 7]] * 4


def test_sequence_and_flatten():
    t = pa.table({"lo": pa.array([1, 5, 0], pa.int64()),
                  "hi": pa.array([4, 1, 0], pa.int64())})
    out = _project_both(t, lambda a: [
        a.C.Sequence(a.col("lo"), a.col("hi")).alias("q")])
    assert out.column("q").to_pylist() == [[1, 2, 3, 4],
                                           [5, 4, 3, 2, 1], [0]]
    out2 = _project_both(ARR, lambda a: [a.C.Flatten(
        a.C.CreateArray((a.col("a"), a.col("b")))).alias("f")])
    assert out2.column("f").to_pylist() == [[1, 2, 2, 3, 2, 9],
                                            [5, 5, 5], [1], None]


def test_map_hofs():
    def make(a):
        k1, v1, k2, v2, k3, v3 = (_v(a, name=n) for n in "kvkvkv")
        i64 = a.T.INT64
        return [a.C.TransformKeys(a.col("m"), k1, v1,
                                  k1 + a.lit(100, i64)).alias("tk"),
                a.C.TransformValues(a.col("m"), k2, v2,
                                    v2 * a.lit(2, i64)).alias("tv"),
                a.C.MapFilter(a.col("m"), k3, v3,
                              v3 > a.lit(15, i64)).alias("mf")]
    out = _project_both(MAPT, make)
    assert out.column("tk").to_pylist() == [[(101, 10), (102, 20)],
                                            [(103, 30)], []]
    assert out.column("tv").to_pylist() == [[(1, 20), (2, 40)],
                                            [(3, 60)], []]
    assert out.column("mf").to_pylist() == [[(2, 20)], [(3, 30)], []]


def test_zip_with_equal_lengths():
    t = pa.table({"p": pa.array([[1, 2], [3]], pa.list_(pa.int64())),
                  "q": pa.array([[10, 20], [30]], pa.list_(pa.int64()))})

    def make(a):
        x, y = _v(a, name="x"), _v(a, name="y")
        return [a.C.ZipWith(a.col("p"), a.col("q"), x, y, x + y).alias("z")]
    out = _project_both(t, make)
    assert out.column("z").to_pylist() == [[11, 22], [33]]


def test_replicate_rows_explode():
    t = pa.table({"n": pa.array([2, 0, 3, None], pa.int64()),
                  "v": pa.array([10, 20, 30, 40], pa.int64())})
    out = collect(GenerateExec(C.ReplicateRows(col("n")),
                               InMemoryScanExec(t, device="cpu")))
    rows = sorted(zip(out.column("v").to_pylist(),
                      out.column("col").to_pylist()))
    assert rows == [(10, 0), (10, 1), (30, 0), (30, 1), (30, 2)]
    jout = jcollect(JGenerateExec(JC.ReplicateRows(jcol("n")),
                                  JInMemoryScanExec(t)))
    assert out.equals(jout)


TYPESIG = pa.table({
    "i": pa.array([1, 2, 3, None], type=pa.int32()),
    "f": pa.array([1.5, -2.0, None, 0.25], type=pa.float64())})


def test_sequence_bounds_must_be_integral():
    def q(a):
        return a.table(TYPESIG).select(
            a.C.Sequence(a.col("i"), a.col("f")).alias("r"))
    assert "parameter 'bound'" in Session(device="cpu").explain(q(PORT))
    assert Session(device="cpu").explain(q(PORT)) == JSession().explain(q(JAX))


def test_array_repeat_count_must_be_literal():
    def q(a):
        return a.table(TYPESIG).select(
            a.C.ArrayRepeat(a.col("i"), a.col("i")).alias("r"))
    text = Session(device="cpu").explain(q(PORT))
    assert "parameter 'count' must be a literal" in text
    assert "array_repeat with non-literal count has no static budget" in text
    assert text == JSession().explain(q(JAX))


# ---------------------------------------------------------------------------
# Every new expression, function by function, against the JAX module and
# the port's interpreter
# ---------------------------------------------------------------------------

def _hof_lists(seed=11, n=240):
    """Seeded lists with empty and null rows: two int64 lists sharing
    values, two double lists (no NaN), string lists, a map<bigint,bigint>,
    per-row scalars (a probe, a count, slice bounds with no zero start or
    negative length, sequence bounds within its budget)."""
    rng = np.random.default_rng(seed)
    cols = {k: [] for k in ("ia", "ib", "da", "db", "sa", "m")}
    for i in range(n):
        if i % 11 == 3:
            for k in cols:
                cols[k].append(None)
            continue
        la, lb = (0, 0) if i % 7 == 0 else rng.integers(0, 7, 2)
        cols["ia"].append([int(v) for v in rng.integers(-4, 5, la)])
        cols["ib"].append([int(v) for v in rng.integers(-4, 5, lb)])
        cols["da"].append([float(v) for v in rng.integers(-8, 8, la) / 4])
        cols["db"].append([float(v) for v in rng.integers(-8, 8, lb) / 4])
        cols["sa"].append(["w" * int(k) for k in rng.integers(0, 4, la)])
        cols["m"].append([(int(k), int(v)) for k, v in zip(
            rng.integers(0, 6, la), rng.integers(-50, 50, la))])
    start = rng.integers(1, 5, n) * rng.choice([-1, 1], n)
    lo = rng.integers(-5, 5, n)
    return pa.table({
        "ia": pa.array(cols["ia"], pa.list_(pa.int64())),
        "ib": pa.array(cols["ib"], pa.list_(pa.int64())),
        "da": pa.array(cols["da"], pa.list_(pa.float64())),
        "db": pa.array(cols["db"], pa.list_(pa.float64())),
        "sa": pa.array(cols["sa"], pa.list_(pa.string())),
        "m": pa.array(cols["m"], pa.map_(pa.int64(), pa.int64())),
        "p": pa.array(rng.integers(-4, 5, n), pa.int64()),
        "pw": pa.array(["w" * int(k) for k in rng.integers(0, 4, n)]),
        "n": pa.array(rng.integers(0, 6, n), pa.int64()),
        "s": pa.array(start.astype(np.int32)),
        "l": pa.array(rng.integers(0, 4, n).astype(np.int32)),
        "lo": pa.array(lo, pa.int64()),
        "hi": pa.array(lo + rng.integers(-6, 7, n), pa.int64()),
        "st": pa.array(rng.choice([-3, -2, -1, 1, 2, 3], n), pa.int64())})


#: (name, a function making the expression) of every new expression
def _hof_exprs(a):
    c, k, i64 = a.col, a.C, a.T.INT64
    ia, ib, da, db, m = c("ia"), c("ib"), c("da"), c("db"), c("m")

    def v(name="x", t=None):
        return _v(a, t, name)

    def one(make):
        return lambda: make()

    def hof(cls, arr, body, t=None):
        x = v(t=t)
        return cls(arr, x, body(x))

    def map_hof(cls, body):
        kk, vv = v("k"), v("v")
        return cls(m, kk, vv, body(kk, vv))

    def agg(arr, zero, merge, t=None):
        acc, x = v("acc", t), v("x", t)
        return k.AggregateArray(arr, zero, acc, x, merge(acc, x))

    def zipped(left, right, body):
        x, y = v("x"), v("y")
        return k.ZipWith(left, right, x, y, body(x, y))

    f64 = a.T.FLOAT64
    return [
        ("transform_outer", one(lambda: hof(
            k.TransformArray, ia, lambda x: x * a.lit(3, i64) + c("p")))),
        ("transform_da", one(lambda: hof(
            k.TransformArray, da, lambda x: x * a.lit(2.0), f64))),
        ("filter_ia", one(lambda: hof(
            k.FilterArray, ia, lambda x: x > a.lit(0, i64)))),
        ("filter_da", one(lambda: hof(
            k.FilterArray, da, lambda x: x < a.lit(0.5), f64))),
        ("exists_ia", one(lambda: hof(
            k.ExistsArray, ia, lambda x: x == c("p")))),
        ("forall_da", one(lambda: hof(
            k.ForallArray, da, lambda x: x < a.lit(1.0), f64))),
        ("aggregate_ia", one(lambda: agg(
            ia, a.lit(0, i64), lambda s, x: s + x))),
        ("aggregate_da", one(lambda: agg(
            da, a.lit(0.5), lambda s, x: s + x * x, f64))),
        ("aggregate_nested", one(lambda: agg(
            hof(k.TransformArray, ia, lambda x: x + c("n")), a.lit(0, i64),
            lambda s, x: s + x))),
        ("distinct_ia", one(lambda: k.ArrayDistinct(ia))),
        ("distinct_da", one(lambda: k.ArrayDistinct(da))),
        ("union_ia", one(lambda: k.ArrayUnion(ia, ib))),
        ("union_da", one(lambda: k.ArrayUnion(da, db))),
        ("intersect_ia", one(lambda: k.ArrayIntersect(ia, ib))),
        ("except_ia", one(lambda: k.ArrayExcept(ia, ib))),
        ("except_da", one(lambda: k.ArrayExcept(da, db))),
        ("overlap_ia", one(lambda: k.ArraysOverlap(ia, ib))),
        ("remove_ia", one(lambda: k.ArrayRemove(ia, c("p")))),
        ("remove_sa", one(lambda: k.ArrayRemove(c("sa"), c("pw")))),
        ("position_ia", one(lambda: k.ArrayPosition(ia, c("p")))),
        ("position_sa", one(lambda: k.ArrayPosition(c("sa"), c("pw")))),
        ("repeat", one(lambda: k.ArrayRepeat(c("p"), a.lit(3)))),
        ("slice", one(lambda: k.ArraySlice(ia, c("s"), c("l")))),
        ("sequence", one(lambda: k.Sequence(c("lo"), c("hi"),
                                            max_elems=16))),
        ("sequence_step", one(lambda: k.Sequence(c("lo"), c("hi"), c("st"),
                                                 max_elems=16))),
        ("flatten", one(lambda: k.Flatten(k.CreateArray((ia, ib))))),
        ("replicate_rows", one(lambda: k.ReplicateRows(c("n"), 8))),
        ("transform_keys", one(lambda: map_hof(
            k.TransformKeys, lambda kk, vv: kk + a.lit(1, i64)))),
        ("transform_values", one(lambda: map_hof(
            k.TransformValues, lambda kk, vv: vv * kk + c("p")))),
        ("map_filter", one(lambda: map_hof(
            k.MapFilter, lambda kk, vv: vv > c("p")))),
        ("zip_with", one(lambda: zipped(
            ia, ib, lambda x, y: a.Coalesce((x, a.lit(0, i64)))
            + a.Coalesce((y, a.lit(0, i64)))))),
        ("zip_with_equal", one(lambda: zipped(
            ia, hof(k.TransformArray, ia, lambda x: x - c("p")),
            lambda x, y: x * y))),
    ]


_NO_HANDLER = ("transform_keys", "transform_values", "map_filter",
               "zip_with", "zip_with_equal")


@pytest.mark.parametrize("name", [n for n, _ in _hof_exprs(PORT)])
def test_expression_against_jax_module(name):
    t = _hof_lists()
    batch, schema = from_arrow(t, device="cpu")
    jbatch, jschema = jfrom_arrow(t)
    e = dict(_hof_exprs(PORT))[name]().bind(schema)
    je = dict(_hof_exprs(JAX))[name]().bind(jschema)
    assert str(e.dtype) == str(je.dtype)
    got = to_arrow(ColumnarBatch((e.eval(batch),), batch.num_rows),
                   Schema([Field("x", e.dtype)]))
    # one XLA program for the expression (op by op, each op compiles)
    jout = jax.jit(lambda b: je.eval(b))(jbatch)
    want = jto_arrow(JColumnarBatch((jout,), jbatch.num_rows),
                     JSchema([JField("x", je.dtype)]))
    assert got.equals(want), name
    if name not in _NO_HANDLER:
        cpu = Session(ORACLE, device="cpu").collect(
            table(t).select(dict(_hof_exprs(PORT))[name]().alias("x")))
        assert cpu.column("x").to_pylist() == got.column("x").to_pylist()


def test_fused_stage_holds_a_lambda():
    """A filter and a projection of lambdas (reading an outer column, one
    nested in another) fuse into one stage in both packages; the
    port's stage gives the JAX Session's rows, and the iterator path's."""
    def q(a):
        x, y, z = _v(a), _v(a), _v(a)
        i64 = a.T.INT64
        return a.table(arr_table()).where(a.col("x") > a.lit(np.int64(-3))) \
            .select(a.col("k"),
                    a.C.TransformArray(a.col("vs"), x, x * a.col("x"))
                    .alias("t"),
                    a.C.ExistsArray(
                        a.C.FilterArray(a.col("vs"), y, y > a.lit(0, i64)),
                        z, z > a.col("x")).alias("s"))
    got, ses = _both(q, ignore_order=False, oracle=True)
    assert ses.executed_exec_names() == ["FusedStageExec"]
    jses = JSession()
    jses.collect(q(JAX))
    assert jses.executed_exec_names() == ["FusedStageExec"]
    plain = Session({"spark.rapids.tpu.sql.fusion.enabled": False},
                    device="cpu")
    assert plain.collect(q(PORT)).equals(got)


@pytest.mark.parametrize("case", ["nullable body", "repeat count",
                                  "flatten column", "set over strings"])
def test_tagging_reasons_are_the_jax_ones(case):
    """A nullable lambda body, a non-literal array_repeat count, flatten of
    a column of arrays and a set operation over strings: the JAX Session's
    islands and reasons, and the port's interpreter's rows."""
    t = pa.table({"vs": pa.array([[1, 2], None, []], pa.list_(pa.int64())),
                  "x": pa.array([1, None, 3], pa.int64()),
                  "sa": pa.array([["a"], ["b", "a"], None],
                                 pa.list_(pa.string())),
                  "nested": pa.array([[[1, 2], [3]], None, [[]]],
                                     pa.list_(pa.list_(pa.int64())))})
    needle = {"nullable body": "transform body may produce null",
              "repeat count": "non-literal count has no static budget",
              "flatten column": "flatten over a nested-array column",
              "set over strings": "array_distinct over array<string>"}[case]

    def q(a):
        v = _v(a)
        if case == "nullable body":
            e = a.C.TransformArray(a.col("vs"), v, v + a.col("x"))
        elif case == "repeat count":
            e = a.C.ArrayRepeat(a.col("x"), a.col("x"))
        elif case == "flatten column":
            e = a.C.Flatten(a.col("nested"))
        else:
            e = a.C.ArrayDistinct(a.col("sa"))
        return a.table(t).select(e.alias("r"))
    if case == "repeat count":
        # no schema without a literal budget: neither Session collects it
        text = Session(device="cpu").explain(q(PORT))
        assert text == JSession().explain(q(JAX))
    else:
        text = _falls_back(q, "Project")
    assert needle in text


def test_flatten_of_array_stays_on_device():
    """flatten(array(a, b)) runs on the device in the port, where the JAX
    check types the array of arrays and refuses the form its rule's note
    says lowers (ROADMAP Queue 3, a JAX-side fault); the rows agree."""
    lists = pa.list_(pa.int64())
    t = pa.table([pa.array([[1, 2, 2], [], [5]], lists),
                  pa.array([[2, 9], [5], []], lists)],
                 schema=pa.schema([pa.field("a", lists, nullable=False),
                                   pa.field("b", lists, nullable=False)]))

    def q(a):
        return a.table(t).select(a.C.Flatten(
            a.C.CreateArray((a.col("a"), a.col("b")))).alias("f"))
    ses = Session(device="cpu")
    got = ses.collect(q(PORT))
    assert ses.fell_back() == []
    jses = JSession()
    assert got.equals(jses.collect(q(JAX)))
    assert jses.fell_back() == ["CpuFallback[Project]"]
    assert "array<array<bigint>> nested elements" in jses.explain(q(JAX))
    assert got.column("f").to_pylist() == [[1, 2, 2, 2, 9], [5], [5]]


# ---------------------------------------------------------------------------
# Departures from Spark, pinned both ways (ROADMAP Queue 3, "Not faults")
# ---------------------------------------------------------------------------

def test_nan_in_set_operations_pinned_both_ways():
    """The port counts NaN as one value, as Spark 3.3 and later
    (SPARK-36702, SPARK-36741), on its device and its interpreter; the
    JAX device's == keeps every NaN apart."""
    nan = float("nan")
    t = pa.table({"a": pa.array([[nan, 1.0, nan], [nan]],
                                pa.list_(pa.float64())),
                  "b": pa.array([[nan], [2.0]], pa.list_(pa.float64()))})

    def make(a):
        return [a.C.ArrayDistinct(a.col("a")).alias("d"),
                a.C.ArrayUnion(a.col("a"), a.col("b")).alias("u"),
                a.C.ArrayIntersect(a.col("a"), a.col("b")).alias("i"),
                a.C.ArrayExcept(a.col("a"), a.col("b")).alias("e"),
                a.C.ArraysOverlap(a.col("a"), a.col("b")).alias("o"),
                a.C.ArrayPosition(a.col("a"), a.lit(nan)).alias("p"),
                a.C.ArrayRemove(a.col("a"), a.lit(nan)).alias("r")]
    got = collect(ProjectExec(make(PORT), InMemoryScanExec(t, device="cpu")))
    assert str(got.to_pylist()) == str([
        {"d": [nan, 1.0], "u": [nan, 1.0], "i": [nan], "e": [1.0],
         "o": True, "p": 1, "r": [1.0]},
        {"d": [nan], "u": [nan, 2.0], "i": [], "e": [nan], "o": False,
         "p": 1, "r": []}])
    cpu = Session(ORACLE, device="cpu").collect(
        table(t).select(*make(PORT)))
    assert str(cpu.to_pylist()) == str(got.to_pylist())
    want = jcollect(JProjectExec(make(JAX), JInMemoryScanExec(t)))
    assert str(want.to_pylist()) == str([
        {"d": [nan, 1.0, nan], "u": [nan, 1.0, nan, nan], "i": [],
         "e": [nan, 1.0, nan], "o": False, "p": 0, "r": [nan, 1.0, nan]},
        {"d": [nan], "u": [nan, 2.0], "i": [], "e": [nan], "o": False,
         "p": 0, "r": [nan]}])


def test_sequence_step_departures_pinned_both_ways():
    """A step against the direction gives an empty array and a step of 0
    null, on both devices and both interpreters (Spark raises for both);
    past its budget the port raises on its device and its interpreter."""
    t = pa.table({"lo": pa.array([1, 1, 5], pa.int64()),
                  "hi": pa.array([5, 5, 1], pa.int64()),
                  "st": pa.array([-1, 0, 2], pa.int64())})

    def make(a):
        return [a.C.Sequence(a.col("lo"), a.col("hi"), a.col("st"),
                             max_elems=8).alias("q")]
    want = [[], None, []]
    got = collect(ProjectExec(make(PORT), InMemoryScanExec(t, device="cpu")))
    assert got.column("q").to_pylist() == want
    assert jcollect(JProjectExec(make(JAX), JInMemoryScanExec(t))).column(
        "q").to_pylist() == want
    for ses in (Session(ORACLE, device="cpu"), JSession(ORACLE)):
        api = PORT if isinstance(ses, Session) else JAX
        assert ses.collect(api.table(t).select(*make(api))).column(
            "q").to_pylist() == want
    over = pa.table({"lo": pa.array([1], pa.int64()),
                     "hi": pa.array([20], pa.int64())})
    q = table(over).select(C.Sequence(col("lo"), col("hi"), max_elems=8)
                           .alias("q"))
    for conf in ({}, ORACLE):
        with pytest.raises(CapacityError,
                           match="CAPACITY_sequence_max_elems"):
            Session(conf, device="cpu").collect(q)


def test_slice_start_zero_fails_in_every_mode():
    t = pa.table({"a": pa.array([[1, 2]], pa.list_(pa.int64()))})
    q = table(t).select(C.ArraySlice(col("a"), lit(0), lit(1)).alias("s"))
    for conf in ({}, ORACLE):
        with pytest.raises(ArithmeticError, match="SLICE_START_ZERO"):
            Session(conf, device="cpu").collect(q)


# ---------------------------------------------------------------------------
# The order lines leg at SF 0.01
# ---------------------------------------------------------------------------

def test_order_lines_against_pyarrow():
    """The leg through the port's Session, exact against its reference,
    nothing fallen back (the map lambdas and zip_with have no interpreter
    handler in either package, so the interpreter cannot run it), and the
    explode of replicaterows(n_lines) under maxRepeat 8 gives one row per
    line."""
    _, q9 = entry.tpch_q14_q9_tables(0.01)
    _, _, _, lineitem, orders, _ = q9
    lines, orders = entry.order_lines_tables(lineitem, orders)
    probe = entry.basket_probe(lines)
    ses = Session(entry.order_lines_conf(4), device="cpu")
    got = ses.collect(entry.order_lines_df(lines, orders, probe, 4))
    assert ses.fell_back() == []
    assert got.equals(entry.order_lines_reference(lines, orders, probe))
    assert got.num_rows > 0
    copies = ses.collect(entry.order_line_copies_df(lines, 4))
    assert copies.column("n").to_pylist() == [lines.num_rows]
