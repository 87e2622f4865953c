"""``InterleaveBits`` / ``zorder_key`` (``expressions/zorder.py``) in the
port, against the JAX package on the CPU.

- ``tests/test_zorder.py::test_interleave_bits_orders_locally``. Its Delta
  case (``test_zorder_write_improves_file_skipping``) waits for the port's
  ``io/delta.py``.
- The key over 2 to 8 columns of every kind the rule admits (int8 to
  int64, float, double, date, timestamp, boolean, decimal), with nulls,
  NaN, -NaN, +-0.0, +-inf and int64 values past int32, bit for bit with
  the JAX key; one JAX plan per column count.
- The pinned departures: one column (the JAX key raises), and a double
  that rounds to a float32 subnormal (XLA's CPU flushes it to zero, torch
  keeps it).
- The port's key against a numpy Morton key built with magic-mask bit
  spreading, and the interpreter's JAX message."""

import datetime as dt
import decimal

import numpy as np
import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu.expressions import col as jcol
from spark_rapids_tpu.expressions.zorder import zorder_key as jzorder_key
from spark_rapids_tpu.plan import Session as JSession
from spark_rapids_tpu.plan import table as jtable
from spark_rapids_tpu_torch import entry
from spark_rapids_tpu_torch.expressions import col
from spark_rapids_tpu_torch.expressions.zorder import (InterleaveBits,
                                                        orderable_u32,
                                                        zorder_key)
from spark_rapids_tpu_torch.plan import Session, table

from harness.asserts import rows_of


@pytest.fixture(autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


ORACLE = {"spark.rapids.tpu.sql.enabled": False}


def test_interleave_bits_orders_locally():
    t = pa.table({"x": pa.array([0, 0, 1, 1, 1000, 1000, 1001, 1001]),
                  "y": pa.array([0, 1, 0, 1, 1000, 1001, 1000, 1001])})
    ses = Session(device="cpu")
    got = rows_of(ses.collect(
        table(t).select(col("x"), col("y"),
                        zorder_key(col("x"), col("y")).alias("z"))))
    zs = {(x, y): z for x, y, z in got}
    small = max(zs[(a, b)] for a in (0, 1) for b in (0, 1))
    big = min(zs[(a, b)] for a in (1000, 1001) for b in (1000, 1001))
    assert small < big
    assert ses.fell_back() == []
    want = JSession().collect(jtable(t).select(
        jcol("x"), jcol("y"), jzorder_key(jcol("x"), jcol("y")).alias("z")))
    assert rows_of(want) == got


NAN = float("nan")
INF = float("inf")
N = 24


def kinds_table() -> pa.Table:
    """One column of each kind, with nulls and the edge values."""
    rng = np.random.default_rng(61)

    def ints(bits, extra):
        lo, hi = -(1 << (bits - 1)), (1 << (bits - 1)) - 1
        v = [int(x) for x in rng.integers(lo, hi, N - len(extra) - 2)]
        return v + list(extra) + [None, None]

    doubles = [float(x) for x in rng.normal(0, 1e3, N - 10)] + [
        NAN, -NAN, 0.0, -0.0, INF, -INF, 1e300, -1e-300, None, None]
    floats = [float(np.float32(x)) if x is not None else None
              for x in doubles[:N - 4]] + [3.5, -3.5, None, None]
    days = [dt.date(1970, 1, 1) + dt.timedelta(days=int(d))
            for d in rng.integers(-20000, 20000, N - 2)] + [None, None]
    stamps = [dt.datetime(2020, 1, 1, tzinfo=dt.timezone.utc)
              + dt.timedelta(microseconds=int(u))
              for u in rng.integers(-10 ** 15, 10 ** 15, N - 2)] + [None,
                                                                    None]
    decs = [decimal.Decimal(int(u)).scaleb(-2)
            for u in rng.integers(-10 ** 9, 10 ** 9, N - 2)] + [None, None]
    return pa.table({
        "i8": pa.array(ints(8, [-128, 127]), pa.int8()),
        "i16": pa.array(ints(16, [-32768]), pa.int16()),
        "i32": pa.array(ints(32, [-(1 << 31), (1 << 31) - 1]), pa.int32()),
        "i64": pa.array(ints(64, [1 << 40, -(1 << 40), (1 << 63) - 1,
                                  -(1 << 63), 0]), pa.int64()),
        "f32": pa.array(floats, pa.float32()),
        "f64": pa.array(doubles, pa.float64()),
        "d": pa.array(days, pa.date32()),
        "ts": pa.array(stamps, pa.timestamp("us", tz="UTC")),
        "b": pa.array([bool(x) for x in rng.integers(0, 2, N - 2)]
                      + [None, None], pa.bool_()),
        "dec": pa.array(decs, pa.decimal128(12, 2)),
    })


KINDS = ("i8", "i16", "i32", "i64", "f32", "f64", "d", "ts", "b", "dec")


@pytest.mark.parametrize("k", range(2, 9))
def test_interleave_bits_matches_jax(k):
    """Keys over k columns, each kind once at every position, bit for bit
    with the JAX package's (one JAX plan per k); the port's interpreter
    raises the JAX interpreter's message."""
    t = kinds_table()
    combos = [[KINDS[(s + j) % len(KINDS)] for j in range(k)]
              for s in range(len(KINDS))]
    port = [zorder_key(*[col(c) for c in cs]).alias(f"z{s}")
            for s, cs in enumerate(combos)]
    jax = [jzorder_key(*[jcol(c) for c in cs]).alias(f"z{s}")
           for s, cs in enumerate(combos)]
    ses = Session(device="cpu")
    got = ses.collect(table(t).select(*port))
    want = JSession().collect(jtable(t).select(*jax))
    assert ses.fell_back() == []
    assert got.schema == want.schema
    assert got.equals(want)
    with pytest.raises(NotImplementedError,
                       match=r"^CPU interpreter: InterleaveBits$"):
        Session(ORACLE, device="cpu").collect(table(t).select(*port[:1]))


def test_one_column_departure_pinned_both_ways():
    """One column: the port's key is the column's word below the flipped
    top bit, in the column's order; the JAX key raises on its shift by
    32 - 64."""
    t = pa.table({"x": pa.array([5, -3, None, 1 << 40, -(1 << 40)],
                                pa.int64())})
    got = Session(device="cpu").collect(
        table(t).select(zorder_key(col("x")).alias("z")))
    lo = -(1 << 63)
    assert got.column("z").to_pylist() == [
        lo + (1 << 31) + 5, lo + (1 << 31) - 3, lo, lo + (1 << 32) - 1,
        lo + 1]
    with pytest.raises(OverflowError):
        JSession().collect(jtable(t).select(
            jzorder_key(jcol("x")).alias("z")))


def test_subnormal_departure_pinned_both_ways():
    """A double that rounds to a float32 subnormal: torch keeps the
    subnormal's bits, XLA's CPU backend flushes it to a signed zero (ROADMAP
    "Other"), so the keys over 2 columns (32 bits each) differ in the low
    bits of that column; a normal value gives the same key."""
    t = pa.table({"f": pa.array([1e-40, -1e-40, 1.0], pa.float64()),
                  "g": pa.array([7, 7, 7], pa.int32())})
    got = Session(device="cpu").collect(table(t).select(
        zorder_key(col("f"), col("g")).alias("z"))).column("z").to_pylist()
    want = JSession().collect(jtable(t).select(
        jzorder_key(jcol("f"), jcol("g")).alias("z"))).column("z")\
        .to_pylist()
    sub = np.array([1e-40, -1e-40], np.float64).astype(np.float32)
    bits = sub.view(np.uint32).astype(np.int64)
    port_words = [int(bits[0] | 0x80000000), int(~bits[1] & 0xFFFFFFFF)]
    flushed = [0x80000000, 0x7FFFFFFF]   # the words of +0.0 and -0.0
    g_word = 7 + (1 << 31)

    def key(fw):
        z = 0
        for b in range(32):
            z |= ((fw >> b) & 1) << (2 * b + 1)
            z |= ((g_word >> b) & 1) << (2 * b)
        return z - (1 << 64) if z >= 1 << 63 else z

    def flip(z):
        return z ^ -(1 << 63)
    assert got[:2] == [flip(key(w)) for w in port_words]
    assert want[:2] == [flip(key(w)) for w in flushed]
    assert got[2] == want[2]


def test_against_numpy_morton_key():
    """``zorder_key(l_partkey, l_suppkey, l_shipdate)``'s shape (two int64
    keys and a date) against ``entry.zorder3_reference``, the magic-mask
    key the chip script checks with, and ``entry.zorder_df``'s sort."""
    rng = np.random.default_rng(8)
    n = 4096
    pk = rng.integers(1, 200_000, n)
    sk = rng.integers(1, 10_000, n)
    sd = rng.integers(8000, 10600, n).astype(np.int32)
    t = pa.table({"l_partkey": pk, "l_suppkey": sk,
                  "l_shipdate": pa.array(sd).view(pa.date32())})
    got = Session(device="cpu").collect(table(t).select(zorder_key(
        col("l_partkey"), col("l_suppkey"), col("l_shipdate")).alias("z")))
    want = entry.zorder3_reference(pk, sk, sd)
    np.testing.assert_array_equal(got.column("z").to_numpy(), want)
    u = torch.from_numpy(pk)
    from spark_rapids_tpu_torch import types as PT
    from spark_rapids_tpu_torch.batch import DeviceColumn
    w = orderable_u32(DeviceColumn(u, torch.ones(n, dtype=torch.bool),
                                   PT.INT64))
    np.testing.assert_array_equal(w.numpy(), pk + (1 << 31))
    assert isinstance(zorder_key(col("a")), InterleaveBits)
    srt = Session(device="cpu").collect(entry.zorder_df(t, 3))
    zs = srt.column("z").to_numpy()
    np.testing.assert_array_equal(zs, np.sort(want))
    np.testing.assert_array_equal(zs, entry.zorder3_reference(
        srt.column("l_partkey").to_numpy(), srt.column("l_suppkey")
        .to_numpy(), srt.column("l_shipdate").cast(pa.int32()).to_numpy()))
