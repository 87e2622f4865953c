"""Dictionary-encoded strings in the port (``spark_rapids_tpu_torch/dictenc.py``)
against the JAX package, on the CPU.

- The 19 cases of ``tests/test_dictenc.py`` against the port: each query
  over dictionary-encoded input equals the same query over plain input
  BIT FOR BIT in the port (group-by on codes visits rows in the plain
  path's string order, and the CPU's ``index_add_`` adds in row order), and
  equals the JAX Session on the same input (exact but for floats, within
  rel 1e-6). Each JAX plan runs once.
- The host pieces equal the JAX functions' output on seeded inputs:
  ``encode_strings_np``, ``bucket_card``, ``unify_dict_columns``' remap,
  ``column_from_arrow_dictionary``'s codes and dictionary lanes,
  ``dict_wire_bytes`` and the fallback reason texts.
- TPC-H Q16 at SF 0.01 over dictionary tables through both Sessions, and
  the native decoder's RLE_DICTIONARY codes hand-off on a file written by
  ``pq.write_table``.

The Sessions run with ``incompatibleOps`` on, so float sums stay on the
device in both packages (the float64 hazard gate sends them to the CPU
otherwise)."""

import os

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

from spark_rapids_tpu import dictenc as jd
from spark_rapids_tpu.batch import from_arrow as jfrom_arrow
from spark_rapids_tpu.expressions import col as jcol
from spark_rapids_tpu.expressions.aggregates import Average as JAverage
from spark_rapids_tpu.expressions.aggregates import Count as JCount
from spark_rapids_tpu.expressions.aggregates import Sum as JSum
from spark_rapids_tpu.expressions.comparison import In as JIn
from spark_rapids_tpu.io import read_parquet as jread_parquet
from spark_rapids_tpu.io.parquet_native import open_native as jopen_native
from spark_rapids_tpu.plan import Session as JSession
from spark_rapids_tpu.plan import table as jtable
from spark_rapids_tpu_torch import dictenc as td
from spark_rapids_tpu_torch import entry
from spark_rapids_tpu_torch.batch import from_arrow, to_arrow
from spark_rapids_tpu_torch.expressions import col
from spark_rapids_tpu_torch.expressions.aggregates import Average, Count, Sum
from spark_rapids_tpu_torch.expressions.comparison import In
from spark_rapids_tpu_torch.io import read_parquet
from spark_rapids_tpu_torch.io.parquet_native import open_native
from spark_rapids_tpu_torch.plan import Session, table

from harness.asserts import assert_tables_equal
from test_dictenc import N, _fact, _lineitem, _store_sales

CONF = {"spark.rapids.tpu.sql.incompatibleOps.enabled": True}


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Each case on one torch thread: many small ops, which a pool of
    threads per test worker only slows when the workers share the
    cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _ses(conf=None):
    return Session({**CONF, **(conf or {})}, device="cpu")


def _jses(conf=None):
    return JSession({**CONF, **(conf or {})})


#: the port's and the JAX package's API under one name, for queries that
#: are written once
PORT = dict(col=col, Sum=Sum, Count=Count, Average=Average, In=In,
            table=table)
JAX = dict(col=jcol, Sum=JSum, Count=JCount, Average=JAverage, In=JIn,
           table=jtable)


def _differential(q, t, conf=None, num_slices=1, ignore_order=True):
    """``q(api, df)`` over plain and dictionary-encoded ``t`` in the port,
    bit for bit, and over the encoded input in the JAX Session."""
    ses = _ses(conf)
    enc_t = td.dictionary_encode_arrow(t)
    plain = ses.collect(q(PORT, table(t, num_slices=num_slices)))
    enc = ses.collect(q(PORT, table(enc_t, num_slices=num_slices)))
    assert ses.fell_back() == []
    assert_tables_equal(enc, plain, ignore_order=ignore_order,
                        approx_float=False)
    want = _jses(conf).collect(q(JAX, jtable(enc_t,
                                              num_slices=num_slices)))
    assert_tables_equal(enc, want, ignore_order=ignore_order)
    return enc


def _cols_equal(port_col, jax_col, lanes=("data", "validity", "dict_data",
                                          "dict_lengths")):
    for lane in lanes:
        a, b = getattr(port_col, lane), getattr(jax_col, lane)
        assert (a is None) == (b is None), lane
        if a is not None:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                          err_msg=lane)


# ---------------------------------------------------------------------------
# the 19 cases of tests/test_dictenc.py
# ---------------------------------------------------------------------------

def test_smoke_dict_roundtrip():
    t = pa.table({"s": pa.array(["", "aa", None, "b", "aa", "", None, "c"]),
                  "v": pa.array(np.arange(8, dtype=np.int64))})
    plain, schema = from_arrow(t, device="cpu")
    enc, _ = from_arrow(td.dictionary_encode_arrow(t), schema=schema,
                        device="cpu")
    assert enc.columns[0].is_dict and not plain.columns[0].is_dict
    dec = td.decode_batch(enc)
    for lane in ("data", "lengths", "validity"):
        assert torch.equal(getattr(dec.columns[0], lane),
                           getattr(plain.columns[0], lane)), lane
    jenc, _ = jfrom_arrow(jd.dictionary_encode_arrow(t))
    _cols_equal(enc.columns[0], jenc.columns[0])
    assert to_arrow(enc, schema).equals(t)


def test_smoke_dict_exchange_wire_roundtrip():
    """The frame carries the dictionary and the codes (the JAX lanes
    ``D{i}``/``e{i}``), is smaller than the padded form, and reads back
    encoded; the JAX package reads the port's frame."""
    from spark_rapids_tpu.shuffle.serializer import \
        deserialize_batch as jdeserialize
    from spark_rapids_tpu_torch.shuffle.serializer import (
        deserialize_batch, serialize_batch)
    b, schema = from_arrow(_store_sales(2048), device="cpu")
    enc = td.encode_batch(b, schema)
    assert enc.columns[0].is_dict
    enc_frame = serialize_batch(enc, schema, "none")
    raw_frame = serialize_batch(td.decode_batch(enc), schema, "none")
    assert len(enc_frame) < len(raw_frame), (len(enc_frame),
                                             len(raw_frame))
    back = deserialize_batch(enc_frame, schema)
    assert back.columns[0].is_dict
    for c_back, c_enc in zip(back.columns, enc.columns):
        for lane in ("data", "validity", "lengths", "dict_data",
                     "dict_lengths"):
            a, b = getattr(c_back, lane), getattr(c_enc, lane)
            assert (a is None and b is None) or torch.equal(a, b), lane
    _, jschema = jfrom_arrow(_store_sales(2048))
    jback = jdeserialize(enc_frame, jschema)
    assert jback.columns[0].is_dict
    _cols_equal(back.columns[0], jback.columns[0])


def test_encode_sorted_distinct_invariant():
    rng = np.random.default_rng(7)
    words = np.array(["", "a", "ab", "abc", "b", "ba", "zz"])
    t = pa.table({"s": pa.array(words[rng.integers(0, len(words), 500)])})
    b, _ = from_arrow(t, device="cpu")
    mat = b.columns[0].data.numpy()
    lens = b.columns[0].lengths.numpy()
    valid = b.columns[0].validity.numpy()
    dm, dl, codes = td.encode_strings_np(mat, lens, valid)
    seen = [bytes(dm[i][:dl[i]]) for i in range(dm.shape[0])]
    assert seen == sorted(set(seen))
    np.testing.assert_array_equal(dm[codes][valid], mat[valid])
    np.testing.assert_array_equal(dl[codes][valid], lens[valid])
    order_by_code = np.argsort(codes[valid], kind="stable")
    strs = [bytes(r[:n]) for r, n in zip(mat[valid], lens[valid])]
    assert [strs[i] for i in order_by_code] == sorted(strs)
    for got, want in zip((dm, dl, codes),
                         jd.encode_strings_np(mat, lens, valid)):
        np.testing.assert_array_equal(got, want)


def test_bucket_card_powers_of_two():
    assert td.bucket_card(0) == 8
    assert td.bucket_card(8) == 8
    assert td.bucket_card(9) == 16
    assert td.bucket_card(1000) == 1024
    assert [td.bucket_card(n) for n in range(3000)] == \
        [jd.bucket_card(n) for n in range(3000)]


def test_unify_dict_batches_remap():
    t1 = pa.table({"s": pa.array(["apple", "pear", "apple", None] * 4)})
    t2 = pa.table({"s": pa.array(["pear", "quince", "fig", "fig"] * 4)})
    b1, schema = from_arrow(td.dictionary_encode_arrow(t1), device="cpu")
    b2, _ = from_arrow(td.dictionary_encode_arrow(t2), schema=schema,
                       device="cpu")
    merged = td.merged_pieces()
    u1, u2 = td.unify_dict_batches([b1, b2])
    assert td.merged_pieces() == merged + 2
    c1, c2 = u1.columns[0], u2.columns[0]
    assert c1.is_dict and c2.is_dict and c1.dict_data is c2.dict_data
    for orig, uni in ((b1, u1), (b2, u2)):
        d_orig = td.decode_batch(orig).columns[0]
        d_uni = td.decode_batch(uni).columns[0]
        assert torch.equal(d_orig.data, d_uni.data)
        assert torch.equal(d_orig.lengths, d_uni.lengths)
    j1, js = jfrom_arrow(jd.dictionary_encode_arrow(t1))
    j2, _ = jfrom_arrow(jd.dictionary_encode_arrow(t2), schema=js)
    for p, j in zip((u1, u2), jd.unify_dict_batches([j1, j2])):
        _cols_equal(p.columns[0], j.columns[0])


def test_dict_wire_bytes_accounting():
    b, schema = from_arrow(_store_sales(2048), device="cpu")
    enc = td.encode_batch(b, schema)
    enc_bytes, raw_bytes = td.dict_wire_bytes(enc)
    assert enc_bytes < raw_bytes
    plain_enc, plain_raw = td.dict_wire_bytes(b)
    assert plain_enc == plain_raw
    jb, js = jfrom_arrow(_store_sales(2048))
    assert td.dict_wire_bytes(enc) == jd.dict_wire_bytes(
        jd.encode_batch(jb, js))
    assert td.dict_wire_bytes(b) == jd.dict_wire_bytes(jb)


def test_differential_q1_stage():
    _differential(
        lambda a, df: df.where(a["col"]("l_shipdate") <= 10471)
        .group_by("l_returnflag", "l_linestatus")
        .agg(a["Sum"](a["col"]("l_quantity")).alias("sq"),
             a["Sum"](a["col"]("l_extendedprice")).alias("sp"),
             a["Count"](a["col"]("l_quantity")).alias("n")),
        _lineitem())


def test_differential_hash_agg():
    _differential(
        lambda a, df: df.group_by("ss_item_sk")
        .agg(a["Sum"](a["col"]("ss_quantity")).alias("sq"),
             a["Average"](a["col"]("ss_sales_price")).alias("ap"),
             a["Count"](a["col"]("ss_net_profit")).alias("n")),
        _store_sales())


def test_differential_join_sort():
    items = np.array([f"ITEM{i:07d}" for i in range(64)])
    dim = pa.table({"i_item_sk": pa.array(items),
                    "i_class": pa.array(
                        [f"CLASS{i % 7}" for i in range(64)])})
    fact = _store_sales(N, 64)

    def q(a, f, d):
        return (f.join(d, ["ss_item_sk"], ["i_item_sk"])
                .group_by("i_class")
                .agg(a["Sum"](a["col"]("ss_quantity")).alias("sq"))
                .order_by("i_class"))
    ses = _ses()
    plain = ses.collect(q(PORT, table(fact), table(dim)))
    encf, encd = (td.dictionary_encode_arrow(fact),
                  td.dictionary_encode_arrow(dim))
    enc = ses.collect(q(PORT, table(encf), table(encd)))
    assert ses.fell_back() == []
    assert enc.equals(plain)
    want = _jses().collect(q(JAX, jtable(encf), jtable(encd)))
    assert enc.equals(want)


def test_differential_exchange():
    """Four slices force a shuffle: per-batch dictionaries cross the
    exchange and unify at its read."""
    _differential(
        lambda a, df: df.group_by("g")
        .agg(a["Sum"](a["col"]("v")).alias("sv"),
             a["Count"](a["col"]("k")).alias("n")),
        _fact(), num_slices=4)


def test_differential_filter_pushdown_ops():
    t = _lineitem()
    preds = (lambda a: a["col"]("l_returnflag") == "A",
             lambda a: a["col"]("l_returnflag") != "N",
             lambda a: a["col"]("l_returnflag") < "N",
             lambda a: a["In"](a["col"]("l_returnflag"), ("A", "R")),
             lambda a: a["In"](a["col"]("l_returnflag"), ("A", None)),
             lambda a: a["col"]("l_linestatus") == "O")
    for pred in preds:
        _differential(
            lambda a, df, p=pred: df.where(p(a)).select(
                "l_returnflag", "l_linestatus", "l_quantity"),
            t, ignore_order=False)


def test_differential_parquet_scan(tmp_path):
    """RLE_DICTIONARY pages land as codes when dictEncoding is on; the
    rows equal the padded path's bit for bit, and the JAX Session's."""
    t = _lineitem()
    path = os.path.join(str(tmp_path), "lineitem.parquet")
    pq.write_table(t, path, use_dictionary=True)

    def q(a, read, conf, session):
        return session(conf).collect(
            read(path).where(a["col"]("l_shipdate") <= 10471)
            .group_by("l_returnflag", "l_linestatus")
            .agg(a["Sum"](a["col"]("l_quantity")).alias("sq"),
                 a["Sum"](a["col"]("l_extendedprice")).alias("sp")))
    on = {"spark.rapids.tpu.dictEncoding.enabled": True}
    off = {"spark.rapids.tpu.dictEncoding.enabled": False}
    got = q(PORT, read_parquet, on, _ses)
    assert_tables_equal(got, q(PORT, read_parquet, off, _ses),
                        ignore_order=True, approx_float=False)
    assert_tables_equal(got, q(JAX, jread_parquet, on, _jses),
                        ignore_order=True)


def test_differential_null_strings():
    t = _lineitem(with_nulls=True)
    _differential(
        lambda a, df: df.group_by("l_returnflag")
        .agg(a["Count"](a["col"]("l_quantity")).alias("n"),
             a["Sum"](a["col"]("l_quantity")).alias("sq")), t)
    _differential(
        lambda a, df: df.where(a["col"]("l_returnflag") == "F")
        .select("l_returnflag", "l_quantity"), t)


def test_differential_empty_strings():
    vals = ["", "x", "", "xx", "x", "", None, "xyz"] * 64
    t = pa.table({"s": pa.array(vals),
                  "v": pa.array(np.arange(len(vals), dtype=np.int64))})
    _differential(
        lambda a, df: df.group_by("s").agg(
            a["Sum"](a["col"]("v")).alias("sv")), t)
    _differential(
        lambda a, df: df.where(a["col"]("s") == "").select("s", "v"), t)


def test_differential_distinct_via_groupby_order():
    _differential(
        lambda a, df: df.group_by("g").agg(
            a["Count"](a["col"]("v")).alias("n")).order_by("g"),
        _fact(), ignore_order=False)


def test_over_threshold_cardinality_fallback(tmp_path):
    rng = np.random.default_rng(13)
    n = 2048
    uniq = np.array([f"U{i:05d}" for i in range(512)])
    t = pa.table({"s": pa.array(uniq[rng.integers(0, 512, n)]),
                  "v": pa.array(np.arange(n, dtype=np.int64))})
    path = os.path.join(str(tmp_path), "hicard.parquet")
    pq.write_table(t, path, use_dictionary=True)
    td.clear_fallbacks()
    ses = _ses({"spark.rapids.tpu.dictEncoding.maxCardinality": 64})
    got = ses.collect(read_parquet(path).group_by("s")
                      .agg(Sum(col("v")).alias("sv")))
    reasons = ses.dict_fallbacks()
    assert any("maxCardinality" in r for r in reasons), reasons
    off = _ses({"spark.rapids.tpu.dictEncoding.enabled": False})
    expected = off.collect(read_parquet(path).group_by("s")
                           .agg(Sum(col("v")).alias("sv")))
    assert_tables_equal(got, expected, ignore_order=True,
                        approx_float=False)
    jses = _jses({"spark.rapids.tpu.dictEncoding.maxCardinality": 64})
    assert_tables_equal(got, jses.collect(
        jread_parquet(path).group_by("s")
        .agg(JSum(jcol("v")).alias("sv"))), ignore_order=True)
    assert sorted(reasons) == sorted(jses.dict_fallbacks())


def test_fraction_threshold_fallback_records_reason():
    t = pa.table({"s": pa.array([f"V{i}" for i in range(64)])})
    td.clear_fallbacks()
    jd.clear_fallbacks()
    b, schema = from_arrow(td.dictionary_encode_arrow(t), device="cpu")
    jfrom_arrow(jd.dictionary_encode_arrow(t))
    assert not b.columns[0].is_dict
    reasons = td.fallback_reasons()
    assert reasons and any("maxCardinalityFraction" in r
                           for r in reasons), reasons
    assert reasons == jd.fallback_reasons()
    assert to_arrow(b, schema)["s"].equals(t["s"])


def test_session_kill_switch_reaches_in_memory_scan():
    t = td.dictionary_encode_arrow(_fact(512))

    def q(a):
        return a["table"](t).group_by("g").agg(
            a["Sum"](a["col"]("v")).alias("sv"))
    expected = _ses().collect(q(PORT))
    kill = {"spark.rapids.tpu.dictEncoding.enabled": False}
    off = _ses(kill)
    got = off.collect(q(PORT))
    assert_tables_equal(got, expected, ignore_order=True,
                        approx_float=False)
    assert any("dictEncoding.enabled" in r
               for r in off.dict_fallbacks()), off.dict_fallbacks()
    joff = _jses(kill)
    assert_tables_equal(got, joff.collect(q(JAX)), ignore_order=True)
    assert sorted(off.dict_fallbacks()) == sorted(joff.dict_fallbacks())


def test_disabled_conf_fallback_records_reason():
    t = pa.table({"s": pa.array(["a", "b", "a", "c"])})
    td.clear_fallbacks()
    jd.clear_fallbacks()
    b, _ = from_arrow(td.dictionary_encode_arrow(t), device="cpu",
                      dict_conf=(False, 1 << 16, 0.5))
    jfrom_arrow(jd.dictionary_encode_arrow(t), dict_conf=(False, 1 << 16,
                                                          0.5))
    assert not b.columns[0].is_dict
    reasons = td.fallback_reasons()
    assert reasons and any("dictEncoding.enabled" in r
                           for r in reasons), reasons
    assert reasons == jd.fallback_reasons()


# ---------------------------------------------------------------------------
# the host pieces against the JAX functions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_encode_strings_np_matches_jax(seed):
    rng = np.random.default_rng(seed)
    n, ml = 300, 12
    lens = rng.integers(0, ml + 1, n).astype(np.int32)
    # a small alphabet with NULs, so trailing-zero ties occur
    mat = rng.choice(np.array([0, 97, 98], np.uint8), (n, ml))
    mat = np.where(np.arange(ml)[None, :] < lens[:, None], mat, 0)
    valid = rng.uniform(size=n) > 0.1
    for got, want in zip(td.encode_strings_np(mat, lens, valid),
                         jd.encode_strings_np(mat, lens, valid)):
        np.testing.assert_array_equal(got, want)


def test_column_from_arrow_dictionary_matches_jax():
    """An Arrow dictionary that is unsorted, repeats a value, and has null
    rows and unused entries: the same canonical sorted dictionary,
    bucketed card, codes and validity as the JAX package."""
    values = pa.array(["pear", "", "apple", "pear", "fig", "zz", "a\x00"])
    idx = pa.array([0, 1, 2, 3, None, 2, 0, 6, 1, 3, 2, 0, 6, 1] * 3,
                   pa.int32())
    t = pa.table({"s": pa.DictionaryArray.from_arrays(idx, values)})
    got, schema = from_arrow(t, device="cpu")
    want, _ = jfrom_arrow(t)
    assert got.columns[0].is_dict
    _cols_equal(got.columns[0], want.columns[0])
    assert to_arrow(got, schema)["s"].to_pylist() == \
        t["s"].cast(pa.string()).to_pylist()


def test_unify_remap_matches_jax_on_seeded_dictionaries():
    rng = np.random.default_rng(21)
    words = np.array([f"w{i:03d}" for i in range(200)] + ["", "w\x00"])
    tables = [pa.table({"s": pa.array(
        np.where(rng.uniform(size=300) < 0.05, None,
                 words[rng.integers(lo, lo + 60, 300)]).tolist())})
        for lo in (0, 40, 120, 140)]
    port, schema = [], None
    for t in tables:
        b, schema = from_arrow(td.dictionary_encode_arrow(t), schema=schema,
                               device="cpu")
        port.append(b)
    jax, jschema = [], None
    for t in tables:
        b, jschema = jfrom_arrow(jd.dictionary_encode_arrow(t),
                                 schema=jschema)
        jax.append(b)
    for p, j in zip(td.unify_dict_batches(port),
                    jd.unify_dict_batches(jax)):
        _cols_equal(p.columns[0], j.columns[0])


def test_fallback_reason_texts_match_jax():
    """The reason of each fallback, word for word the JAX package's."""
    many = pa.table({"s": pa.array([f"V{i}" for i in range(40)] * 2)
                     .dictionary_encode()})
    nulls = pa.table({"s": pa.DictionaryArray.from_arrays(
        pa.array([0, 1, 0, 1], pa.int32()), pa.array(["a", None]))})
    cases = [(many, (False, 1 << 16, 0.5)), (many, (True, 16, 0.5)),
             (many, (True, 1 << 16, 0.25)), (nulls, (True, 1 << 16, 0.5))]
    for t, conf3 in cases:
        td.clear_fallbacks()
        jd.clear_fallbacks()
        arr = t["s"].combine_chunks()
        typ = from_arrow(t, device="cpu")[1][0].dtype
        assert td.column_from_arrow_dictionary(
            arr, typ, 128, torch.device("cpu"), "s", conf3) is None
        from spark_rapids_tpu import types as JT
        assert jd.column_from_arrow_dictionary(
            arr, JT.string(64), 128, False, "s", conf3) is None
        assert td.fallback_reasons() == jd.fallback_reasons() != []
    # the merge past maxCardinality (the registry default, 65,536)
    rng = np.random.default_rng(4)
    big = [pa.table({"s": pa.array([f"k{lo + i}" for i in
                                    rng.permutation(40000)])})
           for lo in (0, 40000)]
    td.clear_fallbacks()
    jd.clear_fallbacks()
    pb = [from_arrow(t.set_column(0, "s", t["s"].dictionary_encode()),
                     device="cpu", dict_conf=(True, 1 << 16, 1.0))[0]
          for t in big]
    jb = [jfrom_arrow(t.set_column(0, "s", t["s"].dictionary_encode()),
                      dict_conf=(True, 1 << 16, 1.0))[0] for t in big]
    assert td.unify_dict_columns([b.columns[0] for b in pb]) is None
    assert jd.unify_dict_columns([b.columns[0] for b in jb]) is None
    assert td.fallback_reasons() == jd.fallback_reasons() != []


# ---------------------------------------------------------------------------
# Q16 over dictionary codes, and the native codes hand-off
# ---------------------------------------------------------------------------

def test_q16_over_dictionary_tables_matches_jax_session():
    from test_torch_q16 import _jax_q16, cut_comments
    part, supplier, partsupp = entry.tpch_q16_tables(0.01)
    cut = cut_comments(supplier)
    enc = [td.dictionary_encode_arrow(t) for t in (part, cut, partsupp)]
    conf = entry.session_conf(4)
    ses = Session(conf, device="cpu")
    got = ses.collect(entry.q16_df(*enc, 4))
    assert ses.fell_back() == []
    # p_brand and p_type stay codes; s_comment, unique, falls back
    reasons = ses.dict_fallbacks()
    assert reasons and all("'s_comment'" in r and "Fraction" in r
                           for r in reasons), reasons
    assert got.equals(Session(conf, device="cpu").collect(
        entry.q16_df(part, cut, partsupp, 4)))
    assert got.equals(entry.q16_reference(part, cut, partsupp))
    assert got.equals(JSession(conf).collect(_jax_q16(*enc, 4)))


def test_native_codes_hand_off_matches_pyarrow_and_jax(tmp_path):
    t = _lineitem(with_nulls=True)
    path = os.path.join(str(tmp_path), "codes.parquet")
    pq.write_table(t, path, use_dictionary=True, row_group_size=1500)
    schema = pq.read_schema(path)
    cols = ["l_returnflag", "l_linestatus", "l_quantity"]
    f, jf = open_native(path), jopen_native(path)
    for rg in range(f.num_row_groups):
        got = f.read_row_group(rg, cols, schema, {"l_returnflag",
                                                  "l_linestatus"})
        assert pa.types.is_dictionary(got["l_returnflag"].type)
        want = jf.read_row_group(rg, cols, schema, {"l_returnflag",
                                                    "l_linestatus"})
        assert got.equals(want)
        plain = pq.ParquetFile(path).read_row_group(rg, columns=cols)
        for c in cols:
            assert got[c].cast(plain[c].type).equals(plain[c])
    # through the scan: the hand-off is on by default, off under a
    # predicate (the host filter over dictionaries is not relied on)
    from spark_rapids_tpu_torch.io.parquet import ParquetSource
    src = ParquetSource([path], columns=cols)
    src.apply_conf({})
    assert src._dict_read_columns(path) == ["l_returnflag", "l_linestatus"]
    filtered = ParquetSource([path], columns=cols,
                             predicate=col("l_quantity") > 3)
    filtered.apply_conf({})
    assert filtered._dict_read_columns(path) == []
