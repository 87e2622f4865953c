"""The slice as a whole: the part-catalogue roll-up (``entry.catalog_df``)
and the comment leg (``entry.comment_spans_df``) at SF 0.01 through the
port's Session on the CPU, against the JAX Session running the same query
built with its own classes, against the port's row interpreter and
against pyarrow (``entry.catalog_reference``,
``entry.comment_spans_reference``), exactly: every column is an integer
or a string.

The JAX Session's ``table()`` scans strings at 64 bytes and refuses a
longer value, so the comment leg compares with it on comments cut to 64
bytes; the full comments (128 bytes a string) are held against pyarrow.
Each JAX Session runs once."""

import importlib
import types as pytypes

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc
import pytest

from spark_rapids_tpu_torch import entry
from spark_rapids_tpu_torch.plan import Session as TSession

SF, SLICES, PARTITIONS = 0.01, 4, 4
ORACLE = {"spark.rapids.tpu.sql.enabled": False}



@pytest.fixture(autouse=True)
def one_torch_thread():
    """Each case on one torch thread: the span scans are many small ops,
    which a pool of threads per test worker only slows when the workers
    share the cores."""
    import torch
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

def _jax():
    ns = {}
    for m in ("base", "strings", "regex", "aggregates"):
        mod = importlib.import_module(f"spark_rapids_tpu.expressions.{m}")
        ns.update({k: v for k, v in vars(mod).items()
                   if not k.startswith("_")})
    plan = importlib.import_module("spark_rapids_tpu.plan")
    ns.update(table=plan.table, Session=plan.Session,
              SortOrder=importlib.import_module(
                  "spark_rapids_tpu.exec.sort").SortOrder)
    return pytypes.SimpleNamespace(**ns)


J = _jax()


def _jax_catalog(part):
    """``entry.catalog_df``'s query in the JAX package's classes."""
    c, lit = J.col, J.lit
    rows = J.table(part, num_slices=SLICES,
                   batch_rows=-(-part.num_rows // SLICES)).select(
        J.RegexpExtract(c("p_type"), "^([A-Z]+) ([A-Z]+) ([A-Z]+)$",
                        3).alias("material"),
        J.FindInSet(J.RegexpExtract(c("p_type"), "^([A-Z]+) ", 1),
                    lit(entry.CATALOG_CLASSES)).alias("class_no"),
        J.InitCap(J.RegexpReplace(c("p_type"), " [A-Z]+$", "")).alias(
            "line"),
        J.RegexpReplace(c("p_brand"), "[^0-9]+", "").alias("brand_no"),
        c("p_size"), c("p_partkey"))
    groups = rows.group_by("material", "class_no", "line", "brand_no").agg(
        J.Count().alias("parts"), J.Sum(c("p_size")).alias("size_sum"),
        J.Min(c("p_partkey")).alias("first_key"))
    return groups.select(
        J.ConcatWs(lit(" / "), (c("line"), c("material"),
                                c("brand_no"))).alias("label"),
        c("class_no"), J.Bin(c("class_no")).alias("class_bits"),
        J.FormatNumber(c("parts"), 0).alias("parts_fmt"),
        J.Hex(c("first_key")).alias("first_hex"),
        J.Conv(c("brand_no"), lit(10), lit(36)).alias("brand_b36"),
        J.Empty2Null(J.RegexpExtract(c("line"), "Promo", 0)).alias("promo"),
        c("parts"), c("size_sum")).order_by(
        J.SortOrder(c("parts"), True), J.SortOrder(c("label")))


def _jax_comments(supplier):
    return J.table(supplier, num_slices=2).select(
        J.col("s_suppkey"),
        J.RegexpExtract(J.col("s_comment"), entry.COMMENT_EXTRACT,
                        1).alias("complaint"),
        J.RegexpReplace(J.col("s_comment"), entry.COMMENT_REPLACE,
                        "_").alias("squeezed"))


def _with_complaints(supplier):
    """The SF 0.01 suppliers and, after them, a few comments with known
    spans."""
    extra = ["xCustomerAbcComplaintsyCustomerQComplaints",
             "CustomerComplaints", "Customer Complaints", "aeiouaxbee",
             "CustomerZZZComplaintsCustomer", ""]
    keys = np.arange(len(extra), dtype=np.int64) + 10**6
    return pa.concat_tables([supplier, pa.table({
        "s_suppkey": keys, "s_comment": pa.array(extra)})])


@pytest.fixture(scope="module")
def tables():
    part, supplier, _ = entry.tpch_q16_tables(SF)
    return part, _with_complaints(supplier)


@pytest.fixture(scope="module")
def jax_catalog(tables):
    ses = J.Session(entry.session_conf(PARTITIONS))
    out = ses.collect(_jax_catalog(tables[0]))
    return out, ses.fell_back()


def test_catalog_matches_jax_and_pyarrow(tables, jax_catalog):
    part = tables[0]
    want, jax_fell = jax_catalog
    ses = TSession(entry.session_conf(PARTITIONS), device="cpu")
    got = ses.collect(entry.catalog_df(part, SLICES))
    assert ses.fell_back() == jax_fell == []
    assert got.schema.names == list(entry.CATALOG_SELECT)
    ref = entry.catalog_reference(part)
    assert got.equals(ref)
    assert got.equals(want)
    assert 1000 < got.num_rows <= len(entry.P_TYPES) * len(entry.P_BRANDS)
    assert set(got.column("promo").to_pylist()) == {"Promo", None}
    assert sorted(set(got.column("class_no").to_pylist())) == \
        [1, 2, 3, 4, 5, 6]


def test_run_catalog_and_the_interpreter_match_pyarrow(tables):
    part = tables[0]
    ref = entry.catalog_reference(part)
    assert entry.run_catalog(part, SLICES, PARTITIONS,
                             device="cpu").equals(ref)
    oracle = TSession({**entry.session_conf(PARTITIONS), **ORACLE},
                      device="cpu")
    assert oracle.collect(entry.catalog_df(part, SLICES)).equals(ref)


def test_catalog_reference_has_a_group_per_type_and_brand():
    """At a size where every pair occurs: 150 types x 25 brands."""
    part = entry.part_table(60000)
    part = part.append_column("p_partkey", pa.array(
        np.arange(1, part.num_rows + 1, dtype=np.int64)))
    ref = entry.catalog_reference(part)
    assert ref.num_rows == 3750
    assert pc.sum(ref.column("parts")).as_py() == part.num_rows


def test_comment_spans_match_pyarrow_and_jax(tables):
    supplier = tables[1]
    ses = TSession(entry.session_conf(PARTITIONS), device="cpu")
    got = ses.collect(entry.comment_spans_df(supplier, 2))
    assert ses.fell_back() == []
    assert got.equals(entry.comment_spans_reference(supplier))
    complaints = got.column("complaint").to_pylist()
    # greedy: the first 'Customer' to the last 'Complaints'
    assert complaints[-6:-1] == ["AbcComplaintsyCustomerQ", "", "", "",
                                 "ZZZ"]
    assert got.column("squeezed").to_pylist()[-3] == "_xb_"
    # the JAX Session on comments cut to 64 bytes, the port on the same
    cut = supplier.set_column(1, "s_comment", pc.utf8_slice_codeunits(
        supplier.column("s_comment"), 0, 64))
    jses = J.Session(entry.session_conf(PARTITIONS))
    want = jses.collect(_jax_comments(cut))
    mine = ses.collect(entry.comment_spans_df(cut, 2))
    assert mine.equals(want)
    assert jses.fell_back() == []
    oracle = TSession({**entry.session_conf(PARTITIONS), **ORACLE},
                      device="cpu")
    assert oracle.collect(entry.comment_spans_df(supplier, 2)).equals(got)
