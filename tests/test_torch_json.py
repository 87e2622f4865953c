"""``expressions/json.py`` in the port (get_json_object, from_json of a flat
struct through ``GetStructField``, json_tuple) and its string to double
parse against the JAX package, on the CPU.

- The two JSON cases of ``tests/test_expressions_breadth.py``, its
  ``test_json_path_gating`` and ``tests/test_expressions_r4.py``'s
  ``test_json_tuple_sugar``: the port's ProjectExec gives the JAX one's
  rows (exactly) and the JAX case's values.
- get_json_object over seeded documents with nesting, ``[i]`` paths,
  escapes, ``\\u`` escapes, blanks, ``null`` and garbage, through both
  packages' modules and the port's row interpreter; the tagging reasons of
  a standalone from_json and of paths outside the subset; every field step
  through the window match, at the key's quoted length.
- The departures pinned both ways: a nested value with blanks and a
  ``\\uXXXX`` escape (the port takes the JAX device's side on its device
  and its interpreter); the port's device parse of a double, under its own
  switch, where the JAX package runs the cast on its interpreter.
- TPC-H Q1 over JSON Lines against ``entry.q1_json_reference`` (floats
  within rel 1e-6) and the JAX Session, with json_tuple's count beside it.

Every case runs on one torch thread."""

import datetime

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
from spark_rapids_tpu.expressions import col as jcol
from spark_rapids_tpu.expressions import collections as JC
from spark_rapids_tpu.expressions import json as JJ
from spark_rapids_tpu.expressions import lit as jlit
from spark_rapids_tpu.expressions.cast import Cast as JCast
from spark_rapids_tpu.plan import Session as JSession
from spark_rapids_tpu.plan import table as jtable
from spark_rapids_tpu_torch import entry
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.batch import (ColumnarBatch, Field, Schema,
                                          from_arrow, to_arrow)
from spark_rapids_tpu_torch.exec import InMemoryScanExec, ProjectExec, collect
from spark_rapids_tpu_torch.expressions import col, lit
from spark_rapids_tpu_torch.expressions import collections as C
from spark_rapids_tpu_torch.expressions import json as J
from spark_rapids_tpu_torch.expressions.cast import Cast
from spark_rapids_tpu_torch.plan import Session, table


FLOAT_REL_TOL = 1e-6
ORACLE = {"spark.rapids.tpu.sql.enabled": False}
PARSE = {"spark.rapids.tpu.sql.castStringToFloat.enabled": True}


@pytest.fixture(autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class _Api:
    def __init__(self, **kw):
        self.__dict__.update(kw)


JAX = _Api(table=jtable, col=jcol, lit=jlit, T=JT, C=JC, J=JJ, Cast=JCast)
PORT = _Api(table=table, col=col, lit=lit, T=T, C=C, J=J, Cast=Cast)


def _project_both(t, make):
    got = collect(ProjectExec(make(PORT), InMemoryScanExec(t, device="cpu")))
    want = jcollect(JProjectExec(make(JAX), JInMemoryScanExec(t)))
    assert got.equals(want)
    return got


# ---------------------------------------------------------------------------
# tests/test_expressions_breadth.py and tests/test_expressions_r4.py
# ---------------------------------------------------------------------------

def test_get_json_object_matrix():
    docs = ['{"a": 1, "b": "x"}', '{"a": {"c": 7}}',
            '{"b": "q\\"uo\\nte"}', '{"arr": [10, 20]}',
            'garbage', None, '{"a": null}']
    t = pa.table({"j": pa.array(docs)})
    out = _project_both(t, lambda a: [
        a.J.GetJsonObject(a.col("j"), a.lit("$.a")).alias("a"),
        a.J.GetJsonObject(a.col("j"), a.lit("$.b")).alias("b"),
        a.J.GetJsonObject(a.col("j"), a.lit("$.a.c")).alias("ac"),
        a.J.GetJsonObject(a.col("j"), a.lit("$.arr[1]")).alias("x1")])
    assert out.column("a").to_pylist() == ["1", '{"c": 7}', None, None,
                                           None, None, None]
    assert out.column("b").to_pylist() == ["x", None, 'q"uo\nte', None,
                                           None, None, None]
    assert out.column("ac").to_pylist() == [None, "7", None, None, None,
                                            None, None]
    assert out.column("x1").to_pylist() == [None, None, None, "20", None,
                                            None, None]


@pytest.mark.parametrize("path", ["$..recursive", "no_dollar", "$.a[3].b",
                                  "$['a.b'][0]", "$", "$.a.*"])
def test_json_path_gating(path):
    try:
        want = JJ.parse_json_path(path)
    except JJ.JsonPathUnsupported:
        with pytest.raises(J.JsonPathUnsupported):
            J.parse_json_path(path)
        return
    assert J.parse_json_path(path) == want
    if path == "$.a[3].b":
        assert want == ["a", 3, "b"]


def test_from_json_field_projection():
    t = pa.table({"j": pa.array(['{"x": 5, "y": "ab"}', '{"x": 7}',
                                 None])})

    def make(a):
        js = a.J.JsonToStructs(a.col("j"), a.T.struct(a.T.INT64,
                                                      a.T.string(16)),
                               ("x", "y"))
        return [a.C.GetStructField(js, 0).alias("x"),
                a.C.GetStructField(js, 1).alias("y")]
    out = _project_both(t, make)
    assert out.column("x").to_pylist() == [5, 7, None]
    assert out.column("y").to_pylist() == ["ab", None, None]


def test_json_tuple_sugar():
    t = pa.table({"j": pa.array(['{"a": 1, "b": "x"}', '{"b": "y"}',
                                 None])})
    out = _project_both(t, lambda a: a.J.json_tuple(a.col("j"), "a", "b"))
    assert out.column("c0").to_pylist() == ["1", None, None]
    assert out.column("c1").to_pylist() == ["x", "y", None]
    # metacharacter field names stay LITERAL keys
    t2 = pa.table({"j": pa.array(['{"a.b": 7, "a": {"b": 1}}'])})
    out2 = _project_both(t2, lambda a: a.J.json_tuple(a.col("j"), "a.b"))
    assert out2.column("c0").to_pylist() == ["7"]
    with pytest.raises(ValueError, match="quote"):
        J.json_tuple(col("j"), "it's")


# ---------------------------------------------------------------------------
# get_json_object over seeded documents, path by path
# ---------------------------------------------------------------------------

def _documents(seed=5, n=160):
    """Flat and nested documents (the nested ones compact: blanks inside a
    nested value are a departure, pinned below), arrays, escapes, blanks
    around keys and values, a null value, garbage and null rows."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        a, b = int(rng.integers(-99, 99)), float(rng.integers(0, 400)) / 8
        word = ["x", "q\\\"t", "tab\\tx", "sl\\/a", "", "a,b}"][i % 6]
        kind = i % 9
        if kind == 0:
            out.append(None)
        elif kind == 1:
            out.append("garbage" if i % 2 else "")
        elif kind == 2:
            out.append(f'{{"a": {a}, "b": {b}, "s": "{word}"}}')
        elif kind == 3:
            out.append(f'  {{ "a" :{a} ,"n": {{"c":[{a},{{"d":"{word}"}}],'
                       f'"e":null}}, "s":"{word}"}}  ')
        elif kind == 4:
            out.append(f'{{"arr": [{a}, "{word}", [1,2], {{"k":{b}}}], '
                       f'"a": null}}')
        elif kind == 5:
            out.append(f'{{"s": "{word}", "a": "{a}", "b": true}}')
        elif kind == 6:
            out.append(f'{{"x": {{"a": {a}}}, "a": {b}, "s": "x\\\\y"}}')
        elif kind == 7:
            out.append(f'{{"a.b": {a}, "a": {{"b": {b}}}, "s": "{word}"}}')
        else:
            out.append(f'[{a}, {{"a": {b}}}, "{word}"]')
    return pa.table({"j": pa.array(out)})


#: the seeded documents' width
DOC_WIDTH = 128
PATHS = ["$", "$.a", "$.s", "$.n", "$.n.c[1].d", "$.n.e", "$.arr[1]",
         "$.arr[3].k", "$.arr[9]", "$['a.b']", "$.a.b", "$[1].a", "$[2]"]


@pytest.mark.parametrize("path", PATHS)
def test_get_json_object_against_jax_module(path):
    t = _documents()
    batch, schema = from_arrow(t, string_max_len=DOC_WIDTH, device="cpu")
    jbatch, jschema = jfrom_arrow(t, string_max_len=DOC_WIDTH)
    e = J.GetJsonObject(col("j"), lit(path)).bind(schema)
    je = JJ.GetJsonObject(jcol("j"), jlit(path)).bind(jschema)
    got = to_arrow(ColumnarBatch((e.eval(batch),), batch.num_rows),
                   Schema([Field("x", e.dtype)]))
    # one XLA program for the expression (op by op, each op compiles)
    jout = jax.jit(lambda b: je.eval(b))(jbatch)
    want = jto_arrow(JColumnarBatch((jout,), jbatch.num_rows),
                     JSchema([JField("x", je.dtype)]))
    assert got.equals(want), path
    cpu = Session(ORACLE, device="cpu").collect(entry._df(
        t, 1, DOC_WIDTH).select(J.GetJsonObject(col("j"), lit(path))
                                .alias("x")))
    assert cpu.column("x").to_pylist() == got.column("x").to_pylist()


def test_every_field_step_runs_the_window_match(monkeypatch):
    """Each field step searches for its quoted key with the window match
    (the hand-written kernel on a CUDA tensor): Q1's seven fields at k =
    14, 14, 12, 17, 12, 12 and 7."""
    seen = []
    real = J._window_match

    def spy(data, lengths, pat):
        seen.append(len(pat))
        return real(data, lengths, pat)
    monkeypatch.setattr(J, "_window_match", spy)
    docs = entry.lineitem_json(entry.lineitem_table(64))
    batch, schema = from_arrow(docs, schema=Schema(
        [Field("value", T.string(entry.JSON_MAX_LEN))]), device="cpu")
    for name in entry.Q1_JSON_FIELDS:
        J.GetJsonObject(col("value"), lit("$." + name)).bind(schema).eval(
            batch)
    assert seen == [14, 14, 12, 17, 12, 12, 7]


@pytest.mark.parametrize("case", ["standalone from_json", "recursive path",
                                  "wildcard path", "path column"])
def test_tagging_reasons_are_the_jax_ones(case):
    t = pa.table({"j": pa.array(['{"a": 1}', None, '{"a": {"b": 2}}']),
                  "p": pa.array(["$.a", "$.a", "$.a.b"])})
    needle = {"standalone from_json": "from_json produces a struct column",
              "recursive path": "unsupported path syntax",
              "wildcard path": "unsupported path syntax",
              "path column": "json path must be a literal"}[case]

    def q(a):
        if case == "standalone from_json":
            e = a.J.JsonToStructs(a.col("j"), a.T.struct(a.T.INT64),
                                  ("a",))
        elif case == "path column":
            e = a.J.GetJsonObject(a.col("j"), a.col("p"))
        else:
            path = "$..a" if case == "recursive path" else "$.a.*"
            e = a.J.GetJsonObject(a.col("j"), a.lit(path))
        return a.table(t).select(e.alias("r"))
    text = Session(device="cpu").explain(q(PORT))
    assert needle in text
    assert text == JSession().explain(q(JAX))
    if case == "standalone from_json":
        # no interpreter handler in either package: the island raises
        with pytest.raises(NotImplementedError, match="JsonToStructs"):
            Session(device="cpu").collect(q(PORT))
        return
    ses, jses = Session(device="cpu"), JSession()
    got = ses.collect(q(PORT))
    jses.collect(q(JAX))
    assert ses.fell_back() == jses.fell_back() == ["CpuFallback[Project]"]
    assert got.equals(Session(ORACLE, device="cpu").collect(q(PORT)))


# ---------------------------------------------------------------------------
# Departures, pinned both ways (ROADMAP Queue 3, "Not faults")
# ---------------------------------------------------------------------------

def test_nested_blanks_and_unicode_escapes_pinned_both_ways():
    """A nested value comes back as its input span, blanks included, and a
    string with a \\uXXXX escape is null, on the port's device and its
    interpreter, as on the JAX device; the JAX interpreter gives Jackson's
    compact JSON and the decoded string, as Spark does."""
    t = pa.table({"j": pa.array(['{"a": {"c": 7, "d": [1, 2]}}',
                                 '{"a": "caf\\u00e9"}'])})

    def q(a):
        return a.table(t).select(
            a.J.GetJsonObject(a.col("j"), a.lit("$.a")).alias("a"))
    device = ['{"c": 7, "d": [1, 2]}', None]
    spark = ['{"c":7,"d":[1,2]}', "café"]
    assert Session(device="cpu").collect(q(PORT)).column(
        "a").to_pylist() == device
    assert Session(ORACLE, device="cpu").collect(q(PORT)).column(
        "a").to_pylist() == device
    assert JSession().collect(q(JAX)).column("a").to_pylist() == device
    assert JSession(ORACLE).collect(q(JAX)).column("a").to_pylist() == spark


def test_string_to_double_on_the_device_pinned_both_ways():
    """Under the port's castStringToFloat switch the cast parses on the
    device, to the interpreter's doubles (Python's float); without it the
    port, as the JAX package always, runs it on the interpreter."""
    rng = np.random.default_rng(3)
    vals = ["1.5", "bad", " -2.25 ", "1e5", ".5", "5.", "-0", "NaN",
            "-Infinity", "inf", "1e400", "12345.67", "0.04", "", None,
            "1.2.3", "00012.50", "2.5E-3"]
    vals += [repr(float(x)) for x in rng.uniform(-1e5, 1e5, 200)]
    vals += [str(float(x)) for x in rng.uniform(0, 0.1, 200)]
    t = pa.table({"s": pa.array(vals)})

    def q(a):
        return a.table(t).select(a.Cast(a.col("s"), a.T.FLOAT64).alias("f"))
    ses = Session(PARSE, device="cpu")
    got = ses.collect(q(PORT))
    assert ses.fell_back() == []
    cpu = Session({**PARSE, **ORACLE}, device="cpu").collect(q(PORT))
    assert str(got.to_pylist()) == str(cpu.to_pylist())
    assert str(got.to_pylist()) == str(JSession(ORACLE).collect(
        q(JAX)).to_pylist())
    off = Session(device="cpu")
    assert str(off.collect(q(PORT)).to_pylist()) == str(got.to_pylist())
    jses = JSession()
    jses.collect(q(JAX))
    assert off.fell_back() == jses.fell_back() == ["CpuFallback[Project]"]


# ---------------------------------------------------------------------------
# TPC-H Q1 over JSON Lines
# ---------------------------------------------------------------------------

def _close(got, want):
    assert got.column_names == want.column_names
    assert got.num_rows == want.num_rows
    for name in got.column_names:
        a, e = got.column(name).to_pylist(), want.column(name).to_pylist()
        if pa.types.is_floating(want.schema.field(name).type):
            assert np.allclose(a, e, rtol=FLOAT_REL_TOL, atol=0), name
        else:
            assert a == e, name


def test_q1_over_json_lines():
    t = entry.lineitem_table(2048, seed=7)
    docs = entry.lineitem_json(t)
    assert all(150 < len(d) < entry.JSON_MAX_LEN
               for d in docs.column("value").to_pylist())
    ses = Session(entry.q1_json_conf(4), device="cpu")
    got = ses.collect(entry.q1_json_df(docs, 4))
    assert ses.fell_back() == []
    want = entry.q1_json_reference(t)
    _close(got, want)
    flags = ses.collect(entry.q1_json_flags_df(docs, 4))
    assert flags.column("count_order").to_pylist() == \
        want.column("count_order").to_pylist()
    assert flags.column("c0").to_pylist() == \
        want.column("l_returnflag").to_pylist()
    # the JAX package's row interpreter over the same documents (its
    # Session runs the DOUBLE casts there too)
    from spark_rapids_tpu.batch import schema_from_arrow as jschema_of
    from spark_rapids_tpu.exec.sort import asc as jasc
    from spark_rapids_tpu.expressions.aggregates import Average, Count, Sum
    from spark_rapids_tpu.plan.logical import DataFrame as JDataFrame
    from spark_rapids_tpu.plan.logical import LogicalScan as JLogicalScan
    kinds = (JT.string(1), JT.string(1), JT.INT64, JT.FLOAT64, JT.FLOAT64,
             JT.DATE, JT.FLOAT64)
    js = JJ.JsonToStructs(jcol("value"),
                          JT.struct(*kinds, names=entry.Q1_JSON_FIELDS),
                          entry.Q1_JSON_FIELDS)
    last = datetime.date(1970, 1, 1) + datetime.timedelta(
        entry.Q1_SHIPDATE_MAX)
    disc = jcol("l_extendedprice") * (jlit(1.0) - jcol("l_discount"))
    jdocs = JDataFrame(JLogicalScan(
        (), data=docs, _schema=jschema_of(docs.schema, entry.JSON_MAX_LEN),
        num_slices=4, batch_rows=docs.num_rows // 4))
    jdf = (jdocs
           .select(*[JC.GetStructField(js, i).alias(n)
                     for i, n in enumerate(entry.Q1_JSON_FIELDS)])
           .where(jcol("l_shipdate") <= jlit(last))
           .group_by(*entry.Q1_KEYS)
           .agg(Sum(jcol("l_quantity")).alias("sum_qty"),
                Sum(jcol("l_extendedprice")).alias("sum_base_price"),
                Sum(disc).alias("sum_disc_price"),
                Sum(disc * (jlit(1.0) + jcol("l_tax"))).alias("sum_charge"),
                Average(jcol("l_quantity")).alias("avg_qty"),
                Average(jcol("l_extendedprice")).alias("avg_price"),
                Average(jcol("l_discount")).alias("avg_disc"),
                Count().alias("count_order"))
           .order_by(*[jasc(jcol(k)) for k in entry.Q1_KEYS]))
    _close(got, JSession(ORACLE).collect(jdf))
    assert "cast string[256] → double has no device kernel" in \
        JSession(entry.session_conf(4)).explain(jdf)
