"""The port's cast matrix against the JAX package's, on the CPU.

- Every case of ``tests/test_cast_strings.py``: the device's string casts
  (to integral types and dates, integral types and dates to strings)
  through the port's Session against the JAX Session, and the casts only
  the CPU makes (to double, timestamp or decimal from a string) through
  the port's row interpreter against the JAX interpreter.
- The whole device matrix over edge values: every source kind to every
  target kind over MIN and MAX of each integral width, NaN, the
  infinities, -0.0, values past int64's range and fractions. The port's
  device equals the JAX device's exactly (narrowing wraps, a float
  saturates, NaN is 0: torch's own float conversion of these is undefined
  on CUDA); the port's interpreter equals the port's device wherever the
  value is a date Python can hold.
- A pair ``cast_supported`` refuses tags an island with the JAX reason,
  in both Sessions; ANSI reports ``CAST_INVALID_INPUT`` in both.

Each source table goes through one JAX collect: its cost is the JAX
compile."""

import datetime as dt
import decimal
import importlib
import types as pytypes

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc
import pytest

from harness.asserts import assert_tables_equal

CONF = {"spark.rapids.tpu.sql.incompatibleOps.enabled": True}
ORACLE = {**CONF, "spark.rapids.tpu.sql.enabled": False}


def _api(pkg):
    ns = {"T": importlib.import_module(f"{pkg}.types")}
    for m in ("base", "cast"):
        mod = importlib.import_module(f"{pkg}.expressions.{m}")
        ns.update({k: v for k, v in vars(mod).items()
                   if not k.startswith("_")})
    plan = importlib.import_module(f"{pkg}.plan")
    ns.update(table=plan.table, Session=plan.Session)
    return pytypes.SimpleNamespace(**ns)


JAX = _api("spark_rapids_tpu")
PORT = _api("spark_rapids_tpu_torch")


def session(api, conf):
    return api.Session(conf, device="cpu") if api is PORT \
        else api.Session(conf)


def both(t, make, conf=CONF):
    """``make(api)`` over ``t`` through the JAX Session and the port's:
    the same rows and the same ``fell_back()``; returns the port's
    Session and rows."""
    jses = session(JAX, conf)
    want = jses.collect(make(JAX))
    ses = session(PORT, conf)
    got = ses.collect(make(PORT))
    assert got.schema == want.schema
    assert_tables_equal(got, want)
    assert ses.fell_back() == jses.fell_back()
    return ses, got


# ---------------------------------------------------------------------------
# tests/test_cast_strings.py, case by case
# ---------------------------------------------------------------------------

INTS = ["42", "-7", "+013", "  88  ", "12.9", "-3.99", "", "abc",
        "1 2", "9223372036854775807", "-9223372036854775808",
        "9223372036854775808", "99999999999999999999", "4.", None,
        "300", "-129", ".5", "-", "+", "12a",
        "00000000000000000001", "\x0c42", "\t-5\n"]


def test_string_to_longs():
    t = pa.table({"s": pa.array(INTS, pa.string())})

    def q(a):
        return a.table(t).select(*[a.Cast(a.col("s"), k).alias(n) for n, k in
                                   (("l", a.T.INT64), ("i", a.T.INT32),
                                    ("h", a.T.INT16), ("b", a.T.INT8))])
    ses, got = both(t, q)
    assert ses.fell_back() == []
    assert_tables_equal(session(PORT, ORACLE).collect(q(PORT)), got)
    assert got.column("l").to_pylist()[:5] == [42, -7, 13, 88, 12]


def test_string_to_long_runs_on_device():
    t = pa.table({"s": pa.array(["1", "2"], pa.string())})
    ses, _ = both(t, lambda a: a.table(t).select(
        a.Cast(a.col("s"), a.T.INT64).alias("l")))
    assert not ses.fell_back()


def test_long_to_string():
    vals = [0, 1, -1, 42, -99999, 2**63 - 1, -(2**63), 10**18, None]
    t = pa.table({"x": pa.array(vals, pa.int64())})

    def q(a):
        return a.table(t).select(a.Cast(a.col("x"), a.T.string(24))
                                 .alias("s"))
    _, got = both(t, q)
    assert got.column("s").to_pylist() == [
        None if v is None else str(v) for v in vals]
    assert_tables_equal(session(PORT, ORACLE).collect(q(PORT)), got)


def test_string_to_date():
    strs = ["2024-02-29", "2023-02-29", "1999-1-5", "2024", "2024-7",
            "0001-01-01", "2024-13-01", "2024-00-10", "2024-04-31",
            "not a date", "", None, "2024-06-15", " 2024-06-15 ",
            "0000-01-01", "-024-01-01", "2024-", "2024-06-15-"]
    t = pa.table({"s": pa.array(strs, pa.string())})

    def q(a):
        return a.table(t).select(a.Cast(a.col("s"), a.T.DATE).alias("d"))
    _, got = both(t, q)
    assert_tables_equal(session(PORT, ORACLE).collect(q(PORT)), got)
    assert got.column("d").to_pylist()[:3] == [
        dt.date(2024, 2, 29), None, dt.date(1999, 1, 5)]


def test_date_to_string():
    dates = [dt.date(2024, 6, 15), dt.date(1970, 1, 1),
             dt.date(1969, 12, 31), dt.date(2000, 2, 29), None]
    t = pa.table({"d": pa.array(dates, pa.date32())})

    def q(a):
        return a.table(t).select(a.Cast(a.col("d"), a.T.string(12))
                                 .alias("s"))
    _, got = both(t, q)
    assert got.column("s").to_pylist() == [
        None if d is None else d.isoformat() for d in dates]
    assert_tables_equal(session(PORT, ORACLE).collect(q(PORT)), got)


def test_string_to_float_falls_back():
    t = pa.table({"s": pa.array(["1.5", "bad", None], pa.string())})

    def q(a):
        return a.table(t).select(a.Cast(a.col("s"), a.T.FLOAT64).alias("f"))
    ses, got = both(t, q)
    assert any("Project" in n for n in ses.fell_back())
    assert got.column("f").to_pylist() == [1.5, None, None]


def _oracle_both(t, make):
    """``make(api)`` through each package's row interpreter: equal rows."""
    want = session(JAX, ORACLE).collect(make(JAX))
    got = session(PORT, ORACLE).collect(make(PORT))
    assert got.schema == want.schema
    assert_tables_equal(got, want)
    return got


def _naive(vals):
    return [v.replace(tzinfo=None) if v else None for v in vals]


def test_cast_timestamp_corners_cpu():
    t = pa.table({"s": pa.array(["2020-03-04 05:06:07", "2020-03-04",
                                 "2020-3-4T5:6:7.25", "nope", ""]),
                  "n": pa.array([0, 86400, -1, 3600, None], pa.int64()),
                  "d": pa.array([dt.date(1999, 12, 31)] * 5)})
    got = _oracle_both(t, lambda a: a.table(t).select(
        a.Cast(a.col("s"), a.T.TIMESTAMP).alias("ts"),
        a.Cast(a.col("n"), a.T.TIMESTAMP).alias("tn"),
        a.Cast(a.col("d"), a.T.TIMESTAMP).alias("td")))
    assert _naive(got.column("ts").to_pylist()) == [
        dt.datetime(2020, 3, 4, 5, 6, 7), dt.datetime(2020, 3, 4),
        dt.datetime(2020, 3, 4, 5, 6, 7, 250000), None, None]
    tn = _naive(got.column("tn").to_pylist())
    assert tn[0] == dt.datetime(1970, 1, 1)
    assert tn[1] == dt.datetime(1970, 1, 2)
    assert tn[4] is None
    assert _naive(got.column("td").to_pylist())[0] == \
        dt.datetime(1999, 12, 31)


def test_cast_timestamp_to_date_cpu():
    t = pa.table({"ts": pa.array([dt.datetime(2001, 2, 3, 4, 5)])})
    got = _oracle_both(t, lambda a: a.table(t).select(
        a.Cast(a.col("ts"), a.T.DATE).alias("d")))
    assert got.column("d").to_pylist() == [dt.date(2001, 2, 3)]


def test_cast_decimal_target_cpu():
    t = pa.table({"s": pa.array(["12.345", "1e2", "bad", "99999"]),
                  "f": pa.array([1.005, -2.675, 0.0, 12345.6])})
    got = _oracle_both(t, lambda a: a.table(t).select(
        a.Cast(a.col("s"), a.T.decimal(6, 2)).alias("ds"),
        a.Cast(a.col("f"), a.T.decimal(6, 2)).alias("df")))
    assert got.column("ds").to_pylist() == [
        decimal.Decimal("12.35"), decimal.Decimal("100.00"), None, None]
    df = got.column("df").to_pylist()
    assert df[0] == decimal.Decimal("1.01")      # HALF_UP on the repr
    assert df[3] is None          # 12345.60 needs 7 digits > precision 6
    assert df[2] == decimal.Decimal("0.00")


def test_cast_timestamp_zone_suffixes_cpu():
    t = pa.table({"s": pa.array(["2020-03-04T05:06:07Z",
                                 "2020-03-04 05:06:07+01:00",
                                 "2020-03-04 05:06:07-0230",
                                 "2020-03-04 05:06:07 UTC"])})
    got = _oracle_both(t, lambda a: a.table(t).select(
        a.Cast(a.col("s"), a.T.TIMESTAMP).alias("t")))
    assert _naive(got.column("t").to_pylist()) == [
        dt.datetime(2020, 3, 4, 5, 6, 7), dt.datetime(2020, 3, 4, 4, 6, 7),
        dt.datetime(2020, 3, 4, 7, 36, 7), dt.datetime(2020, 3, 4, 5, 6, 7)]


def test_cast_bool_to_timestamp_micros_cpu():
    t = pa.table({"b": pa.array([True, False])})
    for conf in (CONF, ORACLE):
        for a in (JAX, PORT):
            got = session(a, conf).collect(a.table(t).select(
                a.Cast(a.col("b"), a.T.TIMESTAMP).alias("t")))
            # Spark's booleanToTimestamp: true is 1 microsecond
            assert _naive(got.column("t").to_pylist()) == [
                dt.datetime(1970, 1, 1, 0, 0, 0, 1),
                dt.datetime(1970, 1, 1)], (conf, a)


# ---------------------------------------------------------------------------
# The device matrix over edge values
# ---------------------------------------------------------------------------

I64 = (-(2**63), 2**63 - 1)
EDGE_INTS = [0, 1, -1, 127, -128, 128, -129, 255, 32767, -32768, 65535,
             2**31 - 1, -(2**31), 2**31, I64[0], I64[1], 86400, -86401,
             10**15, None]
EDGE_FLOATS = [0.0, -0.0, 1.5, -1.5, 2.5, -2.7, float("nan"), float("inf"),
               -float("inf"), 1e300, -1e300, 2.0**63, -(2.0**63),
               2.0**63 - 1024, 9.3e18, 3e9, -3e9, 127.9, -128.9, 300.7,
               1e-300, 86400.5, None]
SOURCES = {
    "int8": pa.array([v if v is None or -128 <= v <= 127 else v % 256 - 128
                      if v % 256 >= 128 else v % 256 for v in EDGE_INTS],
                     pa.int8()),
    "int16": pa.array([None if v is None else (v + 2**15) % 2**16 - 2**15
                       for v in EDGE_INTS], pa.int16()),
    "int32": pa.array([None if v is None else (v + 2**31) % 2**32 - 2**31
                       for v in EDGE_INTS], pa.int32()),
    "int64": pa.array(EDGE_INTS, pa.int64()),
    "float32": pa.array(EDGE_FLOATS, pa.float32()),
    "float64": pa.array(EDGE_FLOATS, pa.float64()),
    "bool": pa.array([True, False, None] * 3, pa.bool_()),
    "date": pa.array([dt.date(1969, 12, 31), dt.date(1970, 1, 1),
                      dt.date(1, 1, 1), dt.date(9999, 12, 31),
                      dt.date(2024, 2, 29), None], pa.date32()),
    "timestamp": pa.array([dt.datetime(1969, 12, 31, 23, 59, 59, 999999),
                           dt.datetime(1970, 1, 1), dt.datetime(1, 1, 1),
                           dt.datetime(9999, 12, 31, 23, 59, 59),
                           dt.datetime(2024, 2, 29, 12, 0, 0, 1), None],
                          pa.timestamp("us", tz="UTC")),
    "decimal": pa.array([decimal.Decimal(v) for v in
                         ("0.00", "-0.01", "1.99", "-1.99", "127.50",
                          "-128.50", "99999999.99", "-99999999.99",
                          "86400.00")] + [None], pa.decimal128(10, 2)),
}


def _targets(a, src: str):
    T = a.T
    out = {"int8": T.INT8, "int16": T.INT16, "int32": T.INT32,
           "int64": T.INT64, "float32": T.FLOAT32, "float64": T.FLOAT64,
           "bool": T.BOOLEAN, "date": T.DATE, "timestamp": T.TIMESTAMP}
    if src in ("int8", "int16", "bool", "decimal"):
        # a decimal target keeps its unscaled value in int64 without a
        # precision check on the device: only sources that fit
        out["decimal"] = T.decimal(10, 2)
        out["decimal_down"] = T.decimal(10, 0)
    if src == "decimal":
        out["decimal_up"] = T.decimal(14, 4)
    return out


def _raw(col: pa.ChunkedArray) -> list:
    """A column's values with dates and timestamps as their stored
    integers (a device value may lie outside Python's calendar)."""
    if pa.types.is_date32(col.type):
        col = col.cast(pa.int32())
    elif pa.types.is_timestamp(col.type):
        col = col.cast(pa.int64())
    return col.to_pylist()


def _same(a, b) -> bool:
    if isinstance(a, float) and isinstance(b, float):
        return (a != a and b != b) or a == b
    return a == b


@pytest.mark.parametrize("src", list(SOURCES))
def test_device_cast_matrix_matches_jax(src):
    t = pa.table({"x": SOURCES[src]})

    def q(a):
        return a.table(t).select(*[a.Cast(a.col("x"), k).alias(n)
                                   for n, k in _targets(a, src).items()])
    want = session(JAX, CONF).collect(q(JAX))
    ses = session(PORT, CONF)
    got = ses.collect(q(PORT))
    assert ses.fell_back() == []
    assert got.schema == want.schema
    for name in want.column_names:
        g, w = _raw(got.column(name)), _raw(want.column(name))
        bad = [(i, x, y) for i, (x, y) in enumerate(zip(g, w))
               if not _same(x, y)]
        assert not bad, (src, name, bad)
    # the interpreter, where Python's calendar holds every value
    interp = session(PORT, ORACLE).collect(q(PORT))
    for name in want.column_names:
        g = _raw(got.column(name))
        if pa.types.is_date32(got.column(name).type) or \
                pa.types.is_timestamp(got.column(name).type):
            lo, hi = ((-719162, 2932896) if pa.types.is_date32(
                got.column(name).type) else
                (-62135596800 * 10**6, 253402300799 * 10**6))
            keep = [v is None or lo <= v <= hi for v in g]
        else:
            keep = [True] * len(g)
        want_i = _raw(pc.filter(got.column(name), pa.array(keep)))
        got_i = _raw(pc.filter(interp.column(name), pa.array(keep)))
        bad = [(x, y) for x, y in zip(got_i, want_i) if not _same(x, y)]
        assert not bad, (src, name, bad)


def test_narrowing_wraps_and_saturates_at_min_and_max():
    """Two's complement at MIN and MAX, and a float saturating, pinned
    by value."""
    t = pa.table({"i": pa.array([I64[0], I64[1], 2**31, -(2**31) - 1],
                                pa.int64()),
                  "f": pa.array([1e300, -1e300, float("nan"), 2.0**62],
                                pa.float64())})
    _, got = both(t, lambda a: a.table(t).select(
        a.Cast(a.col("i"), a.T.INT32).alias("i32"),
        a.Cast(a.col("i"), a.T.INT8).alias("i8"),
        a.Cast(a.col("f"), a.T.INT32).alias("f32"),
        a.Cast(a.col("f"), a.T.INT64).alias("f64")))
    assert got.column("i32").to_pylist() == [0, -1, -(2**31), 2**31 - 1]
    assert got.column("i8").to_pylist() == [0, -1, 0, -1]
    assert got.column("f32").to_pylist() == [2**31 - 1, -(2**31), 0,
                                             2**31 - 1]
    assert got.column("f64").to_pylist() == [2**63 - 1, -(2**63), 0, 2**62]


def test_refused_pair_tags_an_island_with_the_jax_reason():
    """A pair ``cast_supported`` refuses (double to string) runs on the
    interpreter in both Sessions, and explain names the JAX reason."""
    t = pa.table({"x": pa.array([1.5, None, -2.0])})

    def q(a):
        return a.table(t).select(a.Cast(a.col("x"), a.T.string(24))
                                 .alias("s"))
    ses, got = both(t, q)
    assert ses.fell_back() == ["CpuFallback[Project]"]
    assert got.column("s").to_pylist() == ["1.5", None, "-2.0"]
    reason = "cast double → string[24] has no device kernel"
    assert reason in ses.explain(q(PORT))
    assert reason in session(JAX, CONF).explain(q(JAX))
    assert not PORT.cast_supported(PORT.T.FLOAT64, PORT.T.string(24))
    assert not PORT.cast_supported(PORT.T.INT64, PORT.T.string(12))
    assert PORT.cast_supported(PORT.T.INT64, PORT.T.string(20))


def test_ansi_invalid_string_reports_in_both():
    t = pa.table({"s": pa.array(["12", "x1"])})
    conf = {**CONF, "spark.rapids.tpu.sql.ansi.enabled": True}
    for a in (JAX, PORT):
        with pytest.raises(Exception, match="CAST_INVALID_INPUT"):
            session(a, conf).collect(a.table(t).select(
                a.Cast(a.col("s"), a.T.INT32).alias("i")))


def test_decimal_cast_past_its_precision_is_null():
    """A cast to DECIMAL(p, s) nulls a value of more than p digits (and
    the int64 overflow of the rescale), as Spark and the port's
    interpreter do; under ANSI the device raises
    NUMERIC_VALUE_OUT_OF_RANGE. The rows that fit keep their values."""
    t = pa.table({
        "i": pa.array([2147483647, 5, None], pa.int32()),
        "l": pa.array([10**18, 12, None], pa.int64()),
        "d": pa.array([1e16, 1.5, None], pa.float64()),
        "m": pa.array([decimal.Decimal("12345678.9012"),
                       decimal.Decimal("1.2345"), None],
                      pa.decimal128(12, 4))})
    to = {"i": (5, 0), "l": (18, 2), "d": (18, 2), "m": (5, 2)}

    def q(a, tab, names=tuple(to)):
        return a.table(tab).select(*[
            a.Cast(a.col(c), a.T.decimal(*to[c])).alias(c) for c in names])
    ses = session(PORT, CONF)
    got = ses.collect(q(PORT, t))
    assert ses.fell_back() == []
    D = decimal.Decimal
    assert got.to_pydict() == {"i": [None, D("5"), None],
                               "l": [None, D("12.00"), None],
                               "d": [None, D("1.50"), None],
                               "m": [None, D("1.23"), None]}
    assert_tables_equal(session(PORT, ORACLE).collect(q(PORT, t)), got)
    ansi = {**CONF, "spark.rapids.tpu.sql.ansi.enabled": True}
    for c in to:
        with pytest.raises(ArithmeticError,
                           match="NUMERIC_VALUE_OUT_OF_RANGE"):
            session(PORT, ansi).collect(q(PORT, t, (c,)))
    assert session(PORT, ansi).collect(q(PORT, t.slice(1))).to_pydict() == \
        {c: v[1:] for c, v in got.to_pydict().items()}
