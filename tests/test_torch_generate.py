"""``GenerateExec`` (explode, posexplode and their outer forms) and the
two nested paths of ``entry.py`` in the port, against the JAX package on
the CPU.

- The 8 cases of ``tests/test_generate.py`` and
  ``tests/test_regex_spans.py::test_split_explode_roundtrip``: the port's
  Session gives the JAX Session's rows and ``fell_back()``, and its
  interpreter the same rows.
- A map exploded with ``outer`` and ``pos``, which emits key and value.
- The order baskets (``collect_set`` into arrays, riding a join as payload,
  a struct sort key, the array expressions, the support leg's explode) and
  the P_NAME words (``split`` into ``array<string>``, ``explode``) at SF
  0.01 against the JAX Session and the vectorized pyarrow references.

Each JAX plan runs once."""

import numpy as np
import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu import types as JT
from spark_rapids_tpu.batch import from_arrow as jfrom_arrow
from spark_rapids_tpu.exec.sort import asc as jasc
from spark_rapids_tpu.exec.sort import desc as jdesc
from spark_rapids_tpu.expressions import col as jcol
from spark_rapids_tpu.expressions import collections as JC
from spark_rapids_tpu.expressions import lit as jlit
from spark_rapids_tpu.expressions.aggregates import CollectSet as JCollectSet
from spark_rapids_tpu.expressions.aggregates import Count as JCount
from spark_rapids_tpu.expressions.aggregates import Max as JMax
from spark_rapids_tpu.expressions.aggregates import Sum as JSum
from spark_rapids_tpu.expressions.conditional import If as JIf
from spark_rapids_tpu.expressions.comparison import EqualTo as JEqualTo
from spark_rapids_tpu.expressions.regex import StringSplit as JStringSplit
from spark_rapids_tpu.plan import Session as JSession
from spark_rapids_tpu.plan import table as jtable
from spark_rapids_tpu_torch import entry
from spark_rapids_tpu_torch.batch import from_arrow, to_arrow
from spark_rapids_tpu_torch.expressions import col, lit
from spark_rapids_tpu_torch.expressions.aggregates import Count, Sum
from spark_rapids_tpu_torch.expressions.regex import StringSplit
from spark_rapids_tpu_torch.plan import Session, table

from harness.asserts import assert_tables_equal
from test_generate import list_table
from test_regex_spans import str_table


@pytest.fixture(autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class _Api:
    def __init__(self, **kw):
        self.__dict__.update(kw)


JAX = _Api(table=jtable, col=jcol, lit=jlit, Count=JCount, Sum=JSum,
           StringSplit=JStringSplit)
PORT = _Api(table=table, col=col, lit=lit, Count=Count, Sum=Sum,
            StringSplit=StringSplit)
ORACLE = {"spark.rapids.tpu.sql.enabled": False}


def _both(q, conf=None, ignore_order=True):
    """``q(api)`` through the port's Session, its interpreter and the JAX
    Session: the same rows and types and the same islands."""
    ses = Session(conf or {}, device="cpu")
    got = ses.collect(q(PORT))
    jses = JSession(conf or {})
    want = jses.collect(q(JAX))
    assert got.schema == want.schema
    assert_tables_equal(got, want, ignore_order=ignore_order,
                        approx_float=False)
    assert ses.fell_back() == jses.fell_back()
    cpu = Session({**(conf or {}), **ORACLE}, device="cpu").collect(q(PORT))
    assert_tables_equal(got, cpu, ignore_order=ignore_order,
                        approx_float=False)
    return got, ses


# ---------------------------------------------------------------------------
# tests/test_generate.py
# ---------------------------------------------------------------------------

def test_array_h2d_roundtrip():
    t = list_table()
    batch, schema = from_arrow(t, device="cpu")
    back = to_arrow(batch, schema)
    assert back.equals(t)
    jbatch, _ = jfrom_arrow(t)
    for ours, theirs in ((batch.columns[1].data, jbatch.columns[1].data),
                         (batch.columns[1].lengths,
                          jbatch.columns[1].lengths)):
        np.testing.assert_array_equal(ours.numpy(), np.asarray(theirs))


@pytest.mark.parametrize("outer,pos", [(False, False), (True, False),
                                       (False, True), (True, True)])
def test_explode(outer, pos):
    _both(lambda a: a.table(list_table()).explode("vs", alias="v",
                                                  outer=outer, pos=pos))


def test_explode_groupby_roundtrip():
    _both(lambda a: a.table(list_table()).explode("vs", alias="v")
          .where(a.col("v") > a.lit(-20)).group_by("k")
          .agg(a.Sum(a.col("v")).alias("sv"), a.Count().alias("c")))


def test_explode_runs_on_device():
    got, ses = _both(lambda a: a.table(list_table()).explode("vs",
                                                             alias="v"))
    assert "GenerateExec" in ses.executed_exec_names()
    assert ses.fell_back() == []


def test_explode_multi_partition():
    _both(lambda a: a.table(list_table(n=120), num_slices=3)
          .explode("vs", alias="v", outer=True))


def test_split_explode_roundtrip():
    got, ses = _both(lambda a: a.table(str_table())
                     .select(a.col("s"),
                             a.StringSplit(a.col("s"), r"[-@ ]").alias("p"))
                     .explode("p", alias="piece"))
    assert ses.fell_back() == []


def test_explode_map_outer_pos():
    """A map generator emits (key, value), with a null pair and pos on a
    null or empty map under ``outer``."""
    maps = [[(1, 10), (2, 20)], [], None, [(3, 30)]]
    t = pa.table({"id": pa.array([1, 2, 3, 4], pa.int32()),
                  "m": pa.array(maps, pa.map_(pa.int32(), pa.int64()))})
    got, ses = _both(lambda a: a.table(t).explode("m", outer=True, pos=True),
                     ignore_order=False)
    assert ses.fell_back() == []
    assert got.column_names == ["id", "m", "pos", "key", "value"]
    assert [(r["id"], r["pos"], r["key"], r["value"])
            for r in got.to_pylist()] == [
        (1, 0, 1, 10), (1, 1, 2, 20), (2, None, None, None),
        (3, None, None, None), (4, 0, 3, 30)]


# ---------------------------------------------------------------------------
# The two paths at SF 0.01
# ---------------------------------------------------------------------------

SF = 0.01
SLICES = 1
CONF = entry.session_conf(SLICES)


@pytest.fixture(scope="module")
def q9_tables():
    return entry.tpch_q9_tables(SF)


def _jax_baskets(lineitem, num_slices):
    return (jtable(lineitem.select(["l_orderkey", "l_partkey",
                                    "l_suppkey"]), num_slices=num_slices)
            .group_by("l_orderkey")
            .agg(JCollectSet(jcol("l_partkey"),
                             max_elems=entry.BASKET_MAX_ITEMS).alias("items"),
                 JCount().alias("n_lines"),
                 JMax(jcol("l_suppkey")).alias("top_supp")))


def _jax_baskets_df(lineitem, orders, probe, num_slices):
    """``entry.baskets_df`` written with the JAX package's classes."""
    items = jcol("items")
    return (jtable(orders.select(["o_orderkey", "o_orderdate"]),
                   num_slices=num_slices)
            .join(_jax_baskets(lineitem, num_slices), ["o_orderkey"],
                  ["l_orderkey"])
            .select(jcol("o_orderkey"),
                    JC.CreateStruct((jcol("o_orderdate"), jcol("n_lines")),
                                    ("o_orderdate", "n_lines")).alias("info"),
                    items, JC.Size(items).alias("n_items"),
                    JC.ArrayContains(items, jlit(probe, JT.INT64))
                    .alias("has_probe"),
                    JC.ArrayMin(items).alias("min_item"),
                    JC.ArrayMax(items).alias("max_item"),
                    JC.ElementAt(JC.SortArray(items, False), jlit(1))
                    .alias("top_item"),
                    jcol("top_supp"))
            .where(JC.Size(items) >= jlit(entry.BASKET_MIN_ITEMS))
            .order_by(jasc(JC.GetStructField(jcol("info"), 0)),
                      jasc(jcol("o_orderkey")))
            .limit(entry.BASKET_TOP))


def test_baskets_against_jax_and_pyarrow(q9_tables):
    part, supplier, partsupp, lineitem, orders, nation = q9_tables
    probe = entry.basket_probe(lineitem)
    ses = Session(CONF, device="cpu")
    got = ses.collect(entry.baskets_df(lineitem, orders, probe, SLICES))
    assert ses.fell_back() == []
    assert got.equals(entry.baskets_reference(lineitem, orders, probe))
    assert 0 < got.num_rows <= entry.BASKET_TOP
    jses = JSession(CONF)
    want = jses.collect(_jax_baskets_df(lineitem, orders, probe, SLICES))
    assert jses.fell_back() == []
    assert got.equals(want)


def test_support_against_jax_and_pyarrow(q9_tables):
    lineitem = q9_tables[3]
    ses = Session(CONF, device="cpu")
    got = ses.collect(entry.support_df(lineitem, SLICES))
    assert ses.fell_back() == []
    want, pairs = entry.support_reference(lineitem)
    assert got.equals(want)
    n = ses.collect(entry.exploded_rows_df(lineitem, SLICES))
    assert n.column("n").to_pylist() == [pairs]
    jwant = JSession(CONF).collect(
        _jax_baskets(lineitem, SLICES).explode("items", alias="item")
        .group_by("item").agg(JCount().alias("support"))
        .order_by(jdesc(jcol("support")), jasc(jcol("item")))
        .limit(entry.SUPPORT_TOP))
    assert got.equals(jwant)


def test_words_against_jax_and_pyarrow(q9_tables):
    part = q9_tables[0]
    ses = Session(CONF, device="cpu")
    got = ses.collect(entry.words_df(part, SLICES))
    assert ses.fell_back() == []
    assert got.equals(entry.words_reference(part))
    assert got.num_rows == len(entry.P_NAME_WORDS)

    words = jcol("words")
    one, zero = jlit(1, JT.INT64), jlit(0, JT.INT64)
    jses = JSession(CONF)
    want = jses.collect(
        jtable(part.select(["p_name"]), num_slices=SLICES)
        .select(JStringSplit(jcol("p_name"), " ",
                             max_elems=entry.WORDS_MAX_ELEMS).alias("words"))
        .select(words, JC.Size(words).alias("n_words"),
                JC.ElementAt(words, jlit(1)).alias("first_word"))
        .explode("words", alias="word")
        .select("word", "n_words", "first_word")
        .group_by("word")
        .agg(JCount().alias("n"), JSum(jcol("n_words")).alias("n_words"),
             JSum(JIf(JEqualTo(jcol("first_word"), jcol("word")), one,
                      zero)).alias("n_first"))
        .order_by(jasc(jcol("word"))))
    assert jses.fell_back() == []
    assert got.equals(want)
