"""The port's conditional and math expressions against the JAX package's,
on the CPU.

- The eleven cases of ``tests/test_expressions.py`` from
  ``test_conditionals`` through ``test_abs_pow``, and the
  ``tests/test_expressions_r4.py`` cases of hypot, log(base, x), nanvl,
  cot/sec/csc, raise_error, rand and the time-zone conversions: each
  expression through a ``ProjectExec`` over an ``InMemoryScanExec`` of
  each package, the port's rows equal to the JAX package's and to the
  reference's expected values.
- ``Rand`` bit for bit: the port's threefry2x32 and bits-to-double step
  against ``jax.random`` itself, over seeds, batch seeds and sizes.
- Every math function over edge doubles (NaN, the infinities, -0.0,
  1e300, subnormals, MIN and MAX of int64): the port's device against the
  JAX device's within rel 1e-12 (both are IEEE libraries), and the port's
  interpreter against the port's device.
- The departures, each with both outputs: string branches of two widths
  raise in both packages; the port's interpreter follows the device where
  the JAX interpreter does not (least/greatest beside a NaN, the log of
  NaN); both devices read a decimal's unscaled value in floor/round.

Each JAX plan runs once."""

import importlib
import math
import types as pytypes

import numpy as np
import pyarrow as pa
import pytest

from harness.asserts import assert_rows_equal, assert_tables_equal, rows_of

CONF = {"spark.rapids.tpu.sql.incompatibleOps.enabled": True}
ORACLE = {**CONF, "spark.rapids.tpu.sql.enabled": False}


def _api(pkg):
    ns = {"T": importlib.import_module(f"{pkg}.types")}
    for m in ("base", "arithmetic", "comparison", "conditional", "math",
              "cast", "datetime"):
        mod = importlib.import_module(f"{pkg}.expressions.{m}")
        ns.update({k: v for k, v in vars(mod).items()
                   if not k.startswith("_")})
    plan = importlib.import_module(f"{pkg}.plan")
    exe = importlib.import_module(f"{pkg}.exec")
    ns.update(table=plan.table, Session=plan.Session,
              ProjectExec=exe.ProjectExec,
              InMemoryScanExec=exe.InMemoryScanExec,
              collect=importlib.import_module(f"{pkg}.exec.base").collect)
    return pytypes.SimpleNamespace(**ns)


JAX = _api("spark_rapids_tpu")
PORT = _api("spark_rapids_tpu_torch")


def project(a, t, exprs, batch_rows=None):
    kw = {"device": "cpu"} if a is PORT else {}
    if batch_rows:
        kw["batch_rows"] = batch_rows
    return a.collect(a.ProjectExec([e.alias(f"c{i}") for i, e in
                                    enumerate(exprs)],
                                   a.InMemoryScanExec(t, **kw)))


def both(t, make, **kw):
    """``make(api)`` (a list of expressions) over ``t`` in each package:
    equal rows, floats within rel 1e-6. Returns the port's columns as
    lists."""
    want = project(JAX, t, make(JAX), **kw)
    got = project(PORT, t, make(PORT), **kw)
    assert got.schema == want.schema
    assert_tables_equal(got, want)
    return [c.to_pylist() for c in got.columns]


# ---------------------------------------------------------------------------
# tests/test_expressions.py: test_conditionals .. test_abs_pow
# ---------------------------------------------------------------------------

def test_conditionals():
    t = pa.table({"a": pa.array([1, 5, None], type=pa.int32())})
    e, e2, e3 = both(t, lambda a: [
        a.If(a.col("a") > a.lit(2), a.lit(100), a.lit(-100)),
        a.CaseWhen(((a.col("a") > a.lit(4), a.lit(1)),
                    (a.col("a") > a.lit(0), a.lit(2))), None),
        a.Coalesce((a.col("a"), a.lit(0)))])
    assert e == [-100, 100, -100]           # a null predicate: else
    assert e2 == [2, 1, None]
    assert e3 == [1, 5, 0]


def test_least_greatest_skip_nulls():
    t = pa.table({"a": pa.array([1, None, None], type=pa.int32()),
                  "b": pa.array([5, 7, None], type=pa.int32())})
    lo, hi = both(t, lambda a: [
        a.LeastGreatest((a.col("a"), a.col("b"))),
        a.LeastGreatest((a.col("a"), a.col("b")), greatest=True)])
    assert lo == [1, 7, None] and hi == [5, 7, None]


def test_cast_float_to_int_java_semantics():
    t = pa.table({"a": pa.array([1.9, -1.9, float("nan"), 1e20, -1e20,
                                 None])})
    i32, i64 = both(t, lambda a: [a.Cast(a.col("a"), a.T.INT32),
                                  a.Cast(a.col("a"), a.T.INT64)])
    assert i32 == [1, -1, 0, 2**31 - 1, -(2**31), None]
    assert i64 == [1, -1, 0, 2**63 - 1, -(2**63), None]


def test_cast_int_narrowing_wraps():
    t = pa.table({"a": pa.array([300, -300], type=pa.int32())})
    (got,) = both(t, lambda a: [a.Cast(a.col("a"), a.T.INT8)])
    assert got == [44, -44]


def test_cast_bool_numeric():
    t = pa.table({"a": pa.array([0, 3, None], type=pa.int32())})
    (got,) = both(t, lambda a: [a.Cast(a.col("a"), a.T.BOOLEAN)])
    assert got == [False, True, None]
    t2 = pa.table({"b": pa.array([True, False])})
    (got,) = both(t2, lambda a: [a.Cast(a.col("b"), a.T.INT64)])
    assert got == [1, 0]


def test_cast_timestamp_date():
    import datetime as dt
    t = pa.table({"ts": pa.array([dt.datetime(2020, 5, 1, 23, 59),
                                  dt.datetime(1969, 12, 31, 23, 0)],
                                 type=pa.timestamp("us"))})
    (got,) = both(t, lambda a: [a.Cast(a.col("ts"), a.T.DATE)])
    assert got == [dt.date(2020, 5, 1), dt.date(1969, 12, 31)]


def test_math_log_null_on_nonpositive():
    t = pa.table({"a": pa.array([math.e, 0.0, -1.0, None])})
    (got,) = both(t, lambda a: [a.UnaryMath(a.col("a"), "log")])
    assert got[0] == pytest.approx(1.0)
    assert got[1:] == [None, None, None]


def test_sqrt_negative_is_nan():
    t = pa.table({"a": pa.array([4.0, -4.0])})
    (got,) = both(t, lambda a: [a.UnaryMath(a.col("a"), "sqrt")])
    assert got[0] == 2.0 and math.isnan(got[1])


def test_round_half_up_vs_bround():
    t = pa.table({"a": pa.array([2.5, 3.5, -2.5, 1.25])})
    up, even, one = both(t, lambda a: [
        a.Round(a.col("a"), 0), a.Round(a.col("a"), 0, half_even=True),
        a.Round(a.col("a"), 1)])
    assert up == [3.0, 4.0, -3.0, 1.0]
    assert even == [2.0, 4.0, -2.0, 1.0]     # bround: HALF_EVEN
    assert one == [2.5, 3.5, -2.5, 1.3]


def test_floor_ceil_return_long():
    t = pa.table({"a": pa.array([1.5, -1.5, None])})
    from spark_rapids_tpu_torch.batch import schema_from_arrow
    e = PORT.FloorCeil(PORT.col("a"))
    assert e.bind(schema_from_arrow(t.schema)).dtype == PORT.T.INT64
    fl, ce = both(t, lambda a: [a.FloorCeil(a.col("a")),
                                a.FloorCeil(a.col("a"), is_ceil=True)])
    assert fl == [1, -2, None] and ce == [2, -1, None]


def test_abs_pow():
    t = pa.table({"a": pa.array([-3, 3, None], type=pa.int32())})
    (got,) = both(t, lambda a: [a.Abs(a.col("a"))])
    assert got == [3, 3, None]
    t2 = pa.table({"a": pa.array([2.0, 3.0]), "b": pa.array([10.0, 2.0])})
    (got,) = both(t2, lambda a: [a.Pow(a.col("a"), a.col("b"))])
    assert got == [1024.0, 9.0]


# ---------------------------------------------------------------------------
# tests/test_expressions_r4.py: hypot, log(base, x), nanvl, cot/sec/csc,
# raise_error, rand, the time zones
# ---------------------------------------------------------------------------

def test_hypot_logarithm_nanvl():
    t = pa.table({
        "a": pa.array([3.0, -4.0, 1e200, None, float("nan")], pa.float64()),
        "b": pa.array([4.0, 3.0, 1e200, 1.0, 2.5], pa.float64()),
    })
    h, lg, nv = both(t, lambda a: [a.Hypot(a.col("a"), a.col("b")),
                                   a.Logarithm(a.col("b"), a.col("a")),
                                   a.NaNvl(a.col("a"), a.col("b"))])
    assert h[0] == 5.0 and h[1] == 5.0
    assert h[2] == pytest.approx(math.hypot(1e200, 1e200))  # no overflow
    assert h[3] is None
    assert lg[0] == pytest.approx(math.log(3.0) / math.log(4.0))
    assert lg[1] is None and lg[3] is None     # non-positive x, null x
    assert nv[0] == 3.0 and nv[3] is None and nv[4] == 2.5


def test_cot_sec_csc():
    xs = [0.5, 1.2, -0.7]
    t = pa.table({"x": pa.array(xs, pa.float64())})
    cot, sec, csc = both(t, lambda a: [a.UnaryMath(a.col("x"), f)
                                       for f in ("cot", "sec", "csc")])
    for i, x in enumerate(xs):
        assert cot[i] == pytest.approx(1 / math.tan(x))
        assert sec[i] == pytest.approx(1 / math.cos(x))
        assert csc[i] == pytest.approx(1 / math.sin(x))


def test_raise_error_fires_and_clean_passes():
    t = pa.table({"s": pa.array(["boom"]), "ok": pa.array([1], pa.int64())})
    for a in (JAX, PORT):
        with pytest.raises(Exception, match="USER_RAISED_ERROR"):
            project(a, t, [a.RaiseError(a.col("s"))])
    t2 = pa.table({"s": pa.array([None], pa.string())})
    (got,) = both(t2, lambda a: [a.RaiseError(a.col("s"))])
    assert got == [None]


def test_raise_error_in_both_sessions_and_the_interpreter():
    t = pa.table({"s": pa.array([None, "bad"])})
    for a in (JAX, PORT):
        for conf in (CONF, ORACLE):
            ses = a.Session(conf, device="cpu") if a is PORT \
                else a.Session(conf)
            with pytest.raises(Exception, match="USER_RAISED_ERROR"):
                ses.collect(a.table(t).select(
                    a.RaiseError(a.col("s")).alias("e")))


def test_rand_deterministic_and_uniform():
    """Bit for bit equal to the JAX package's draws, and the reference's
    checks on them."""
    t = pa.table({"x": pa.array(np.arange(4096), pa.int64())})
    a, c = both(t, lambda api: [api.Rand(seed=42), api.Rand(seed=7)])
    b = project(PORT, t, [PORT.Rand(seed=42)]).column("c0").to_pylist()
    want = project(JAX, t, [JAX.Rand(seed=42)]).column("c0").to_pylist()
    assert a == b == want                  # exact: bit for bit
    assert all(0.0 <= v < 1.0 for v in a)
    assert 0.4 < sum(a) / len(a) < 0.6
    assert c != a


def test_rand_varies_across_batches():
    t = pa.table({"x": pa.array(np.arange(512), pa.int64())})
    vals = project(PORT, t, [PORT.Rand(seed=3)], batch_rows=128) \
        .column("c0").to_pylist()
    want = project(JAX, t, [JAX.Rand(seed=3)], batch_rows=128) \
        .column("c0").to_pylist()
    assert vals == want
    batches = [vals[i * 128:(i + 1) * 128] for i in range(4)]
    assert batches[0] != batches[1] and batches[1] != batches[2]
    again = project(PORT, t, [PORT.Rand(seed=3)], batch_rows=128)
    assert again.column("c0").to_pylist() == vals


@pytest.mark.parametrize("seed,batch_seed,n", [
    (0, None, 1), (42, None, 1000), (2**31 + 5, None, 17), (7, 0, 64),
    (3, 65537, 300), (123456789, 0xFFFF, 4097), (-5, 12, 33)])
def test_threefry_uniform_equals_jax_random(seed, batch_seed, n):
    import jax
    import jax.numpy as jnp
    import torch
    from spark_rapids_tpu_torch.expressions.math import (rand_key,
                                                         uniform_doubles)
    key = jax.random.key(seed & 0x7FFFFFFF)
    if batch_seed is not None:
        key = jax.random.fold_in(key, jnp.asarray(batch_seed, jnp.uint32))
    want = np.asarray(jax.random.uniform(key, (n,), dtype=jnp.float64))
    got = uniform_doubles(rand_key(seed, batch_seed), n, "cpu").numpy()
    assert got.dtype == np.float64
    assert np.array_equal(got.view(np.int64), want.view(np.int64))
    assert torch.equal(uniform_doubles(rand_key(seed, batch_seed), n, "cpu"),
                       torch.from_numpy(got))


def test_from_to_utc_timestamp():
    import datetime as dt
    import random
    vals = [dt.datetime(2024, 1, 15, 12, 0, 0),     # PST (-8)
            dt.datetime(2024, 7, 15, 12, 0, 0),     # PDT (-7)
            dt.datetime(1995, 3, 1, 0, 30, 0), None]
    t = pa.table({"ts": pa.array(vals, pa.timestamp("us"))})

    def naive(vs):
        return [None if v is None else v.replace(tzinfo=None) for v in vs]
    la, utc, ist = (naive(c) for c in both(t, lambda a: [
        a.UTCTimestampConv(a.col("ts"), "America/Los_Angeles"),
        a.UTCTimestampConv(a.col("ts"), "America/Los_Angeles", to_utc=True),
        a.UTCTimestampConv(a.col("ts"), "Asia/Kolkata")]))
    assert la[:2] == [dt.datetime(2024, 1, 15, 4), dt.datetime(2024, 7, 15, 5)]
    assert la[3] is None
    assert utc[:2] == [dt.datetime(2024, 1, 15, 20),
                       dt.datetime(2024, 7, 15, 19)]
    assert ist[0] == dt.datetime(2024, 1, 15, 17, 30)     # +5:30
    rng = random.Random(5)
    many = [dt.datetime(1960 + rng.randrange(120), rng.randrange(1, 13),
                        rng.randrange(1, 28), rng.randrange(24),
                        rng.randrange(60)) for _ in range(200)]
    t2 = pa.table({"ts": pa.array(many, pa.timestamp("us"))})
    (got,) = both(t2, lambda a: [a.UTCTimestampConv(a.col("ts"),
                                                    "Europe/Berlin")])
    from zoneinfo import ZoneInfo
    for v, g in zip(many, naive(got)):
        assert g == v.replace(tzinfo=dt.timezone.utc).astimezone(
            ZoneInfo("Europe/Berlin")).replace(tzinfo=None)


def test_utc_conversion_dst_gap_and_overlap():
    import datetime as dt
    for when, zone, want in (
            (dt.datetime(2026, 3, 8, 2, 30), "America/New_York",
             dt.datetime(2026, 3, 8, 7, 30)),        # a gap: forward
            (dt.datetime(2026, 10, 25, 2, 30), "Europe/Berlin",
             dt.datetime(2026, 10, 25, 0, 30))):     # an overlap: earlier
        t = pa.table({"ts": pa.array([when], pa.timestamp("us"))})
        (got,) = both(t, lambda a: [a.UTCTimestampConv(a.col("ts"), zone,
                                                       to_utc=True)])
        assert got[0].replace(tzinfo=None) == want
        interp = PORT.Session(ORACLE, device="cpu").collect(
            PORT.table(t).select(PORT.UTCTimestampConv(
                PORT.col("ts"), zone, to_utc=True).alias("u")))
        assert interp.column("u").to_pylist() == got


def test_unknown_zone_is_refused_with_the_jax_reason():
    t = pa.table({"ts": pa.array([0], pa.timestamp("us"))})
    e = PORT.UTCTimestampConv(PORT.col("ts"), "Mars/Olympus_Mons")
    from spark_rapids_tpu_torch.batch import schema_from_arrow
    assert e.bind(schema_from_arrow(t.schema)).device_unsupported_reason() \
        == "unknown time zone 'Mars/Olympus_Mons'"
    out = PORT.Session(CONF, device="cpu").explain(PORT.table(t).select(
        e.alias("x")))
    assert "unknown time zone 'Mars/Olympus_Mons'" in out


# ---------------------------------------------------------------------------
# Every math function over edge doubles
# ---------------------------------------------------------------------------

EDGE = [0.0, -0.0, 0.5, -0.5, 1.0, -1.0, 2.5, -2.5, math.e, 10.0, 0.1,
        1e-310, -1e-310, 1e300, -1e300, 700.0, -745.5, 1e15 + 0.5,
        9.223372036854776e18, -9.223372036854776e18, float("nan"),
        float("inf"), -float("inf"), None]
UNARY = ("sqrt", "exp", "expm1", "sin", "cos", "tan", "asin", "acos",
         "atan", "sinh", "cosh", "tanh", "asinh", "acosh", "atanh", "cbrt",
         "rint", "degrees", "radians", "cot", "sec", "csc", "log", "log10",
         "log2", "log1p")


def _close(x, y, rel=1e-12) -> bool:
    if x is None or y is None:
        return x is None and y is None
    if isinstance(x, float) and math.isnan(x):
        return isinstance(y, float) and math.isnan(y)
    if isinstance(x, float) and math.isinf(x):
        return x == y
    return x == y or math.isclose(x, y, rel_tol=rel, abs_tol=1e-300)


def _math_exprs(a):
    x, y = a.col("x"), a.col("y")
    return ([a.UnaryMath(x, f) for f in UNARY] +
            [a.Pow(x, y), a.Atan2(x, y), a.Hypot(x, y), a.Logarithm(y, x),
             a.NaNvl(x, y), a.FloorCeil(x), a.FloorCeil(x, True),
             a.Round(x, 0), a.Round(x, 2), a.Round(x, -1),
             a.Round(x, 0, True), a.Signum(x)])


def test_math_over_edge_doubles_matches_jax_and_the_interpreter():
    rng = np.random.default_rng(12)
    ys = [EDGE[i] for i in rng.permutation(len(EDGE))]
    t = pa.table({"x": pa.array(EDGE * len(EDGE), pa.float64()),
                  "y": pa.array([v for v in ys for _ in EDGE],
                                pa.float64())})
    want = project(JAX, t, _math_exprs(JAX))
    got = project(PORT, t, _math_exprs(PORT))
    assert got.schema == want.schema
    df = PORT.table(t).select(*[e.alias(f"c{i}") for i, e in
                                enumerate(_math_exprs(PORT))])
    interp = PORT.Session(ORACLE, device="cpu").collect(df)
    names = [f"{f}" for f in UNARY] + [
        "pow", "atan2", "hypot", "logarithm", "nanvl", "floor", "ceil",
        "round0", "round2", "round-1", "bround", "signum"]
    # XLA's CPU backend flushes subnormal doubles to zero; torch and the
    # H100 keep them (IEEE), so rows with a subnormal input are held
    # against the interpreter alone
    def normal(v):
        return v is None or not 0 < abs(v) < 2.2250738585072014e-308
    xs, ys = t.column("x").to_pylist(), t.column("y").to_pylist()
    keep = [normal(x) and normal(y) for x, y in zip(xs, ys)]
    assert keep.count(False) == 2 * 2 * len(EDGE) - 4
    for i, name in enumerate(names):
        g = got.column(i).to_pylist()
        w = want.column(i).to_pylist()
        bad = [(k, xs[k], ys[k], u, v) for k, (u, v) in enumerate(zip(g, w))
               if keep[k] and not _close(u, v)]
        assert not bad, (name, bad[:5])
        c = interp.column(i).to_pylist()
        bad = [(k, xs[k], ys[k], u, v) for k, (u, v) in enumerate(zip(g, c))
               if not _close(u, v)]
        assert not bad, ("interpreter", name, bad[:5])


def test_signum_and_round_keep_nan_and_negative_zero_as_xla():
    """torch.sign gives 0 for NaN and +0 for -0.0; the port's sign keeps
    both, as XLA's does, in signum and in round's HALF_UP."""
    t = pa.table({"x": pa.array([float("nan"), -0.0, -0.3], pa.float64())})
    sg, rd = both(t, lambda a: [a.Signum(a.col("x")), a.Round(a.col("x"))])
    assert math.isnan(sg[0]) and math.copysign(1.0, sg[1]) == -1.0
    assert math.isnan(rd[0]) and math.copysign(1.0, rd[2]) == -1.0


# ---------------------------------------------------------------------------
# Departures, each with both packages' outputs
# ---------------------------------------------------------------------------

def test_string_branches_of_two_widths_raise_in_both():
    t = pa.table({"s": pa.array(["abc", "hello"]),
                  "b": pa.array([True, False])})
    for a in (JAX, PORT):
        with pytest.raises(ValueError):
            project(a, t, [a.If(a.col("b"), a.col("s"), a.lit("zz"))])
    # one width: the rows pick bytes and lengths
    (got,) = both(t, lambda a: [a.If(a.col("b"), a.col("s"),
                                     a.Coalesce((a.col("s"),)))])
    assert got == ["abc", "hello"]


def test_least_greatest_beside_nan_follows_the_device():
    """Both devices compare with > and <, so a NaN never replaces the best
    and a NaN first stays; the JAX interpreter orders NaN above every
    double. The port's interpreter gives the devices' answer."""
    nan = float("nan")
    t = pa.table({"a": pa.array([nan, 1.0, 2.0]),
                  "b": pa.array([1.0, nan, 3.0])})

    def q(a):
        return a.table(t).select(
            a.LeastGreatest((a.col("a"), a.col("b"))).alias("lo"),
            a.LeastGreatest((a.col("a"), a.col("b")), True).alias("hi"))
    jdev = JAX.Session(CONF).collect(q(JAX))
    pdev = PORT.Session(CONF, device="cpu").collect(q(PORT))
    pcpu = PORT.Session(ORACLE, device="cpu").collect(q(PORT))
    jcpu = JAX.Session(ORACLE).collect(q(JAX))
    assert_tables_equal(pdev, jdev)
    assert_tables_equal(pcpu, pdev)
    assert rows_of(pdev)[1] == (1.0, 1.0)
    assert math.isnan(rows_of(jcpu)[1][1])      # the JAX interpreter


def test_log_of_nan_is_null_as_on_the_device():
    t = pa.table({"x": pa.array([float("nan"), 1.0])})

    def q(a):
        return a.table(t).select(a.UnaryMath(a.col("x"), "log").alias("l"))
    pdev = PORT.Session(CONF, device="cpu").collect(q(PORT))
    assert_tables_equal(pdev, JAX.Session(CONF).collect(q(JAX)))
    assert_tables_equal(PORT.Session(ORACLE, device="cpu").collect(q(PORT)),
                        pdev)
    assert pdev.column("l").to_pylist() == [None, 0.0]
    assert math.isnan(JAX.Session(ORACLE).collect(q(JAX)).column(
        "l").to_pylist()[0])


def test_decimal_floor_and_round_read_the_unscaled_value_in_both():
    """Both devices floor and round a decimal's unscaled int64 as if it
    were the value (JAX math.py: ``astype(float64)``); both interpreters
    give Spark's answer. A departure of the JAX device that the port's
    device keeps (ROADMAP Queue 3)."""
    import decimal
    t = pa.table({"d": pa.array([decimal.Decimal("12.34")],
                                pa.decimal128(6, 2))})

    def q(a):
        return a.table(t).select(a.FloorCeil(a.col("d")).alias("f"))
    pdev = PORT.Session(CONF, device="cpu").collect(q(PORT))
    assert_tables_equal(pdev, JAX.Session(CONF).collect(q(JAX)))
    assert pdev.column("f").to_pylist() == [1234]
    pcpu = PORT.Session(ORACLE, device="cpu").collect(q(PORT))
    assert pcpu.column("f").to_pylist() == [12] == \
        JAX.Session(ORACLE).collect(q(JAX)).column("f").to_pylist()


def test_round_and_decimal_cast_of_a_double_follow_the_device():
    """Both devices round the double scaled by 10^s (1.005 * 100 is
    100.49999999999999: HALF_UP gives 1.0) and cast a double to a decimal
    half to even on the scaled double with no precision check; both
    interpreters round the double's decimal string HALF_UP (1.01) and null
    a value past the precision, as Spark does (ROADMAP Queue 3)."""
    import decimal
    t = pa.table({"x": pa.array([1.005, 12345.6])})

    def q(a):
        return a.table(t).select(
            a.Round(a.col("x"), 2).alias("r"),
            a.Cast(a.col("x"), a.T.decimal(18, 2)).alias("c"))
    pdev = PORT.Session(CONF, device="cpu").collect(q(PORT))
    assert_tables_equal(pdev, JAX.Session(CONF).collect(q(JAX)))
    pcpu = PORT.Session(ORACLE, device="cpu").collect(q(PORT))
    assert_tables_equal(pcpu, JAX.Session(ORACLE).collect(q(JAX)))
    assert pdev.column("r").to_pylist() == [1.0, 12345.6]
    assert pcpu.column("r").to_pylist() == [1.01, 12345.6]
    assert pdev.column("c").to_pylist() == [decimal.Decimal("1.00"),
                                            decimal.Decimal("12345.60")]
    assert pcpu.column("c").to_pylist() == [decimal.Decimal("1.01"),
                                            decimal.Decimal("12345.60")]
