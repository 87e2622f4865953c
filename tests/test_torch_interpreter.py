"""The port's row interpreter (``spark_rapids_tpu_torch/plan/interpreter.py``)
on the CPU.

- Each ``RowEvaluator`` handler over seeded rows with int MIN/MAX, NaN,
  +-0.0, +-inf, nulls and decimals: the same ``Project`` through the JAX
  package's interpreter and the port's, and through the port's device path
  (its Session on the CPU), as one parametrised test. Floats compare
  within rel 1e-6, everything else exactly.
- Each operator handler and each aggregate branch: the same logical plan
  through both interpreters and the port's device path.
- Each departure from the JAX interpreter, with both outputs shown: the
  port's interpreter agrees with the port's device path, which follows
  Spark (ROADMAP Queue 3, "Not faults").
- An expression, aggregate or operator the port does not have raises,
  naming ROADMAP item 7.

No JAX program is compiled here: the JAX interpreter is plain Python."""

import decimal
import importlib
import math
import types as pytypes

import numpy as np
import pyarrow as pa
import pytest

from spark_rapids_tpu.plan.interpreter import Interpreter as JInterpreter
from spark_rapids_tpu.plan.interpreter import RowEvaluator as JRowEvaluator
from spark_rapids_tpu_torch.plan import Session
from spark_rapids_tpu_torch.plan import interpreter as I
from spark_rapids_tpu_torch.plan import logical as L

from harness.asserts import assert_tables_equal

I64_MIN, I64_MAX = -(1 << 63), (1 << 63) - 1
I32_MIN, I32_MAX = -(1 << 31), (1 << 31) - 1
CONF = {"spark.rapids.tpu.sql.incompatibleOps.enabled": True}


def _api(pkg):
    """Each package's expression classes and helpers by name, its types,
    aggregates and plan builders."""
    ns = {}
    for m in ("base", "arithmetic", "comparison", "boolean", "strings",
              "hashing", "cast", "aggregates"):
        mod = importlib.import_module(f"{pkg}.expressions.{m}")
        ns.update({k: v for k, v in vars(mod).items()
                   if not k.startswith("_")})
    plan = importlib.import_module(f"{pkg}.plan.logical")
    ns.update(T=importlib.import_module(f"{pkg}.types"), L=plan,
              DataFrame=plan.DataFrame, table=plan.table, range_=plan.range_,
              JoinType=importlib.import_module(f"{pkg}.exec.join").JoinType,
              sort=importlib.import_module(f"{pkg}.exec.sort"))
    return pytypes.SimpleNamespace(**ns)


JAX = _api("spark_rapids_tpu")
PORT = _api("spark_rapids_tpu_torch")


def _edge_table(n=40, seed=11):
    """Seeded rows, then edge rows: int MIN/MAX, NaN, +-0.0, +-inf, a
    subnormal, nulls, decimals, empty and multi-byte strings, dates."""
    rng = np.random.default_rng(seed)

    def ints(lo, hi, edges):
        vals = [int(v) for v in rng.integers(lo, hi, n)]
        vals = [None if rng.random() < 0.1 else v for v in vals]
        return vals + edges

    def floats(edges):
        vals = [float(v) for v in rng.normal(0, 100, n)]
        vals = [None if rng.random() < 0.1 else v for v in vals]
        return vals + edges

    a = ints(-1000, 1000, [I64_MIN, I64_MAX, 0, -1, (1 << 62) + 1, None,
                           7, -7, I64_MIN, 3])
    b = ints(-9, 10, [-1, 2, 0, -1, 7, 7, -3, 3, 2, None])
    i = ints(-500, 500, [I32_MIN, I32_MAX, 0, -1, 5, None, -7, 7, 1, 2])
    j = ints(-40, 40, [-1, 2, 0, 33, -3, 32, -3, 3, 31, None])
    x = floats([math.nan, -0.0, 0.0, math.inf, -math.inf, None, 1.5,
                5e-324, 1e300, -2.5])
    y = floats([2.0, 0.0, -0.0, 1.5, math.nan, 3.0, math.inf, 1.0,
                1e300, -0.0])
    d = [None if v is None else decimal.Decimal(v) / 100
         for v in ints(-99999, 99999, [99999, -99999, 0, 1, -1, None,
                                       12345, 50, -50, 7])]
    e = [None if v is None else decimal.Decimal(v) / 100
         for v in ints(-9999, 9999, [1, -1, 0, 300, -7, 2, None, 50, 3,
                                     -3])]
    words = ["", "abc", "ab", "héllo", "xabcx", "abcd", "zz", "ä", "ca"]
    s = [None if rng.random() < 0.1 else words[k]
         for k in rng.integers(0, len(words), n)] + words + [None]
    bo = [None if rng.random() < 0.15 else bool(v)
          for v in rng.integers(0, 2, n)] + [True, False, None, True,
                                             False, None, True, False,
                                             True, False]
    days = ints(0, 20000, [0, 1, -1, 10471, None, 20000, 3, 4, 5, 6])
    return pa.table({
        "a": pa.array(a, pa.int64()), "b": pa.array(b, pa.int64()),
        "i": pa.array(i, pa.int32()), "j": pa.array(j, pa.int32()),
        "h": pa.array([None if v is None else v % 30000 for v in i],
                      pa.int16()),
        "t": pa.array([None if v is None else v % 120 for v in j],
                      pa.int8()),
        "x": pa.array(x, pa.float64()), "y": pa.array(y, pa.float64()),
        "f": pa.array(x, pa.float32()),
        "d": pa.array(d, pa.decimal128(7, 2)),
        "e": pa.array(e, pa.decimal128(6, 2)),
        "s": pa.array(s, pa.string()), "bo": pa.array(bo, pa.bool_()),
        "dt": pa.array(days, pa.int32()).cast(pa.date32()),
    })


EDGE = _edge_table()

#: (id, expression over the api, whether the JAX interpreter departs on
#: some rows: those cases compare with it on the rows ``jax_rows`` keeps)
HANDLERS = [
    ("Add", lambda a: a.col("a") + a.col("b")),
    ("Add_int8", lambda a: a.col("t") + a.col("t")),
    ("Subtract", lambda a: a.col("i") - a.col("j")),
    ("Multiply", lambda a: a.col("a") * a.col("b")),
    ("Multiply_int16", lambda a: a.col("h") * a.col("h")),
    ("Multiply_float32", lambda a: a.col("f") * a.col("f")),
    ("Add_double", lambda a: a.col("x") + a.col("y")),
    ("Subtract_decimal", lambda a: a.col("d") - a.col("d")),
    ("Multiply_decimal", lambda a: a.col("d") * a.col("e")),
    ("Divide", lambda a: a.col("x") / a.col("y")),
    ("Divide_long", lambda a: a.col("a") / a.col("b")),
    ("IntegralDivide", lambda a: a.IntegralDivide(a.col("a"), a.col("b"))),
    ("Remainder", lambda a: a.col("i") % a.col("j")),
    ("Remainder_long", lambda a: a.col("a") % a.col("b")),
    ("Remainder_double", lambda a: a.col("x") % a.col("y")),
    ("Pmod", lambda a: a.Pmod(a.col("i"), a.col("j"))),
    ("Pmod_double", lambda a: a.Pmod(a.col("x"), a.col("y"))),
    ("UnaryMinus", lambda a: -a.col("a")),
    ("Abs", lambda a: a.Abs(a.col("i"))),
    ("BitwiseOp", lambda a: a.BitwiseOp(a.col("a"), a.col("b"), "xor")),
    ("BitwiseNot", lambda a: a.BitwiseNot(a.col("i"))),
    ("Shift_left", lambda a: a.Shift(a.col("i"), a.col("j"), "left")),
    ("Shift_right", lambda a: a.Shift(a.col("a"), a.col("j"), "right")),
    ("Shift_unsigned", lambda a: a.Shift(a.col("i"), a.col("j"),
                                         "right_unsigned")),
    ("EqualTo", lambda a: a.EqualTo(a.col("x"), a.col("y"))),
    ("LessThan", lambda a: a.LessThan(a.col("x"), a.col("y"))),
    ("LessThanOrEqual", lambda a: a.LessThanOrEqual(a.col("s"),
                                                    a.lit("abc"))),
    ("GreaterThan", lambda a: a.GreaterThan(a.col("a"), a.col("b"))),
    ("GreaterThanOrEqual", lambda a: a.GreaterThanOrEqual(a.col("d"),
                                                          a.col("d"))),
    ("EqualNullSafe", lambda a: a.EqualNullSafe(a.col("b"), a.col("j"))),
    ("Not", lambda a: a.Not(a.col("bo"))),
    ("IsNull", lambda a: a.IsNull(a.col("x"))),
    ("IsNotNull", lambda a: a.IsNotNull(a.col("s"))),
    ("IsNaN", lambda a: a.IsNaN(a.col("x"))),
    ("In", lambda a: a.In(a.col("j"), (2, -3, 33))),
    ("And", lambda a: a.And(a.col("bo"), a.GreaterThan(a.col("i"),
                                                       a.lit(0)))),
    ("Or", lambda a: a.Or(a.col("bo"), a.IsNull(a.col("x")))),
    ("Cast", lambda a: a.Cast(a.col("t"), a.T.INT64)),
    ("StringPredicate_contains", lambda a: a.contains(a.col("s"), "ab")),
    ("StringPredicate_startswith",
     lambda a: a.startswith(a.col("s"), "ab")),
    ("StringPredicate_endswith", lambda a: a.endswith(a.col("s"), "")),
    ("Murmur3Hash", lambda a: a.Murmur3Hash(
        (a.col("i"), a.col("a"), a.col("x"), a.col("f"), a.col("s"),
         a.col("bo"), a.col("d"), a.col("dt"), a.col("t")))),
    ("XxHash64", lambda a: a.XxHash64(
        (a.col("i"), a.col("a"), a.col("x"), a.col("f"), a.col("s"),
         a.col("bo"), a.col("d"), a.col("dt"), a.col("h")))),
    ("XxHash64_flat", lambda a: a.XxHash64(
        (a.col("i"), a.col("a"), a.col("x"), a.col("f"), a.col("s"),
         a.col("bo"), a.col("h"), a.col("t")))),
]

#: the rows where the JAX interpreter departs (see the departure tests);
#: None: it departs on every row, and only the port's device compares
JAX_DEPARTS = {
    # math.fmod rounds int64 operands past 2^53
    "Remainder_long": lambda r: abs(r["a"] or 0) > 1 << 53,
    # Spark's pmod by a negative divisor: (r + n) % n, the JAX adds abs(n)
    "Pmod": lambda r: (r["j"] or 0) < 0,
    "Pmod_double": lambda r: (r["y"] or 0) < 0 or (
        r["x"] is not None and math.isinf(r["x"])),
    # the JAX's Remainder raises on an infinite dividend (math.fmod)
    "Remainder_double": lambda r: r["x"] is not None and math.isinf(r["x"]),
    # the JAX's In reads the expression's children: never true
    "In": None,
    # the JAX's scalar hash does not know SQL types, and raises
    "Murmur3Hash": None,
    # the JAX handler builds a device column of each value: a date or a
    # decimal value raises there (XxHash64_flat compares without them)
    "XxHash64": None,
    # the JAX package flushes a subnormal double to 0.0 before hashing;
    # Spark, and the port, hash its bits
    "XxHash64_flat": lambda r: r["x"] is not None and
    0 < abs(r["x"]) < 2.2250738585072014e-308,
}


def _project(api, expr, t=EDGE):
    return api.table(t).select(expr.alias("r"))


def _values(tbl):
    return tbl.column("r").to_pylist()


def _same(got, want):
    if isinstance(want, float) and isinstance(got, float):
        if math.isnan(want):
            return math.isnan(got)
        return got == want or math.isclose(got, want, rel_tol=1e-6)
    return got == want and type(got) is type(want)


def _jax_rows(case):
    departs = JAX_DEPARTS.get(case, False)
    if departs is None:
        return []
    rows = EDGE.to_pylist()
    return [k for k, r in enumerate(rows)
            if departs is False or not departs(r)]


@pytest.mark.parametrize("case,make", HANDLERS, ids=[h[0] for h in HANDLERS])
def test_row_handler_matches_jax_and_the_device(case, make):
    port = I.Interpreter().execute(_project(PORT, make(PORT)).plan)
    device = Session(CONF, device="cpu").collect(_project(PORT, make(PORT)))
    assert port.schema == device.schema
    got, dev = _values(port), _values(device)
    bad = [(k, g, d) for k, (g, d) in enumerate(zip(got, dev))
           if not _same(g, d)]
    assert not bad, bad[:5]
    keep = _jax_rows(case)
    if keep:
        want = _values(JInterpreter().execute(
            _project(JAX, make(JAX), EDGE.take(keep)).plan))
        bad = [(k, got[k], w) for k, w in zip(keep, want)
               if not _same(got[k], w)]
        assert not bad, bad[:5]


# ---------------------------------------------------------------------------
# the departures from the JAX interpreter, each with both outputs
# ---------------------------------------------------------------------------

def _one(api, interp, expr_of, **cols):
    t = pa.table(cols)
    return _values(interp.execute(
        api.table(t).select(expr_of(api).alias("r")).plan))


def _both(expr_of, **cols):
    """(port interpreter, port device, JAX interpreter) values."""
    t = pa.table(cols)
    df = PORT.table(t).select(expr_of(PORT).alias("r"))
    device = _values(Session(CONF, device="cpu").collect(df))
    return (_one(PORT, I.Interpreter(), expr_of, **cols), device,
            _one(JAX, JInterpreter(), expr_of, **cols))


def test_int64_remainder_is_exact():
    """(2**62 + 1) % 7: Java gives 5; the JAX interpreter's math.fmod
    rounds the dividend to a double first and gives 4."""
    port, device, jax = _both(lambda a: a.col("a") % a.col("b"),
                              a=pa.array([(1 << 62) + 1], pa.int64()),
                              b=pa.array([7], pa.int64()))
    assert port == device == [5]
    assert jax == [4]


def test_pmod_by_a_negative_divisor_follows_spark():
    """pmod(-7, -3): Spark's ``(r + n) % n`` gives -1; the JAX interpreter
    adds abs(n) and gives 2."""
    port, device, jax = _both(lambda a: a.Pmod(a.col("a"), a.col("b")),
                              a=pa.array([-7], pa.int64()),
                              b=pa.array([-3], pa.int64()))
    assert port == device == [-1]
    assert jax == [2]


def test_in_reads_its_value_list():
    """k IN (1, 2): the JAX handler walks ``e.children[1:]``, which is
    empty (the values are a field), so it answers false."""
    port, device, jax = _both(lambda a: a.In(a.col("k"), (1, 2, None)),
                              k=pa.array([1, 3, None], pa.int32()))
    assert port == device == [True, None, None]
    assert jax == [False, False, None]


def test_isnan_of_null_is_false_as_in_spark():
    """Spark's IsNaN is never null: isnan(null) is false on the port's
    device, in its interpreter and in the JAX interpreter; the JAX device
    alone gives null."""
    x = pa.array([math.nan, None, 1.0])
    port, device, jax = _both(lambda a: a.IsNaN(a.col("x")), x=x)
    assert port == device == jax == [True, False, False]
    from spark_rapids_tpu.plan import Session as JSession
    jdevice = _values(JSession(CONF).collect(
        JAX.table(pa.table({"x": x})).select(
            JAX.IsNaN(JAX.col("x")).alias("r"))))
    assert jdevice == [True, None, False]


def test_integral_divide_of_doubles_truncates_the_operands():
    """7.9 div 0.5: the port casts both to bigint first (7 div 0, null),
    as its device does; the JAX interpreter divides the doubles (15)."""
    port, device, jax = _both(
        lambda a: a.IntegralDivide(a.col("x"), a.col("y")),
        x=pa.array([7.9, -7.9]), y=pa.array([0.5, 2.5]))
    assert port == device == [None, -3]
    assert jax == [15, -3]


def test_murmur3_hash_hashes_the_sql_kinds():
    """The JAX handler hands its scalar hash SqlTypes where it expects
    kind names, and raises; the port's hashes each kind as Spark (and its
    device) does."""
    cols = dict(i=pa.array([1, None, -5], pa.int32()),
                s=pa.array(["a", "héllo", None]))
    t = pa.table(cols)
    port = _one(PORT, I.Interpreter(),
                lambda a: a.Murmur3Hash((a.col("i"), a.col("s"))), **cols)
    device = _values(Session(CONF, device="cpu").collect(
        PORT.table(t).select(PORT.Murmur3Hash(
            (PORT.col("i"), PORT.col("s"))).alias("r"))))
    assert port == device
    assert port[0] == I.murmur3_bytes(b"a", I.murmur3_int(1, 42))
    with pytest.raises(ValueError):
        _one(JAX, JInterpreter(),
             lambda a: a.Murmur3Hash((a.col("i"), a.col("s"))), **cols)


def test_percentile_orders_nan_last():
    """percentile over (NaN, 1, 3) at 0.5: NaN sorts above every double
    (Spark, and the port's device), so the median is 3; the JAX
    interpreter's ``sorted`` leaves NaN first and gives 1."""
    t = pa.table({"k": pa.array([0, 0, 0], pa.int32()),
                  "x": pa.array([math.nan, 1.0, 3.0])})

    def q(a):
        return a.table(t).group_by("k").agg(
            a.Percentile(a.col("x"), 0.5).alias("r"))
    port = _values(I.Interpreter().execute(q(PORT).plan))
    device = _values(Session(CONF, device="cpu").collect(q(PORT)))
    jax = _values(JInterpreter().execute(q(JAX).plan))
    assert port == device == [3.0]
    assert jax == [1.0]


ANSI_CASES = [
    ("add_overflow", lambda a: a.col("a") + a.col("b"), "ARITHMETIC_OVERFLOW",
     [I64_MAX], [1], False),
    ("div_by_zero", lambda a: a.col("a") / a.col("b"), "DIVIDE_BY_ZERO",
     [1], [0], False),
    ("min_div_minus_one", lambda a: a.IntegralDivide(a.col("a"),
                                                     a.col("b")),
     "ARITHMETIC_OVERFLOW", [I64_MIN], [-1], True),
    ("remainder_by_zero", lambda a: a.col("a") % a.col("b"),
     "DIVIDE_BY_ZERO", [5], [0], True),
    ("negate_min", lambda a: -a.col("a"), "ARITHMETIC_OVERFLOW",
     [I64_MIN], [0], True),
]


@pytest.mark.parametrize("case,make,error,a,b,jax_departs", ANSI_CASES,
                         ids=[c[0] for c in ANSI_CASES])
def test_ansi_errors_raise_as_the_device_raises(case, make, error, a, b,
                                                jax_departs):
    """Under ANSI the interpreter raises where the port's device raises;
    the JAX interpreter leaves out ``MIN div -1``, ``%`` by zero and
    ``-MIN`` (it wraps or nulls)."""
    t = pa.table({"a": pa.array(a, pa.int64()), "b": pa.array(b, pa.int64())})
    ansi = {"spark.rapids.tpu.sql.ansi.enabled": True}
    with pytest.raises(I.AnsiError, match=error):
        I.Interpreter(ansi=True).execute(
            PORT.table(t).select(make(PORT).alias("r")).plan)
    with pytest.raises(ArithmeticError, match=error):
        Session(ansi, device="cpu").collect(
            PORT.table(t).select(make(PORT).alias("r")))
    jplan = JAX.table(t).select(make(JAX).alias("r")).plan
    if jax_departs:
        JInterpreter(ansi=True).execute(jplan)
    else:
        with pytest.raises(ArithmeticError, match=error):
            JInterpreter(ansi=True).execute(jplan)


# ---------------------------------------------------------------------------
# operators and aggregates: the same logical plan through both interpreters
# ---------------------------------------------------------------------------

def _facts(n=300, seed=21):
    rng = np.random.default_rng(seed)
    k = rng.integers(0, 12, n)
    v = rng.integers(-1000, 1000, n)
    x = rng.normal(0, 50, n)
    return pa.table({
        "k": pa.array([None if r < 0.05 else int(q)
                       for q, r in zip(k, rng.random(n))], pa.int32()),
        "v": pa.array([None if r < 0.1 else int(q)
                       for q, r in zip(v, rng.random(n))], pa.int64()),
        "x": pa.array([None if r < 0.1 else float(q)
                       for q, r in zip(x, rng.random(n))], pa.float64()),
        "s": pa.array([f"w{int(q) % 7}" for q in k], pa.string()),
        "d": pa.array([decimal.Decimal(int(q)) / 100 for q in v],
                      pa.decimal128(6, 2)),
    })


def _dims():
    return pa.table({"k2": pa.array([0, 1, 2, 3, 3, 5, 20, None],
                                    pa.int32()),
                     "w": pa.array([10, 11, 12, 13, 14, 15, 16, 17],
                                   pa.int64())})


F, D = _facts(), _dims()


def _aggs(a):
    return [a.Sum(a.col("v")).alias("sv"), a.Sum(a.col("x")).alias("sx"),
            a.Sum(a.col("d")).alias("sd"),
            a.Count(a.col("v")).alias("cv"), a.Count().alias("n"),
            a.Average(a.col("v")).alias("av"),
            a.Average(a.col("d")).alias("ad"),
            a.Min(a.col("x")).alias("mn"), a.Max(a.col("s")).alias("mx"),
            a.First(a.col("v")).alias("fv"), a.Last(a.col("x")).alias("lx"),
            a.StddevSamp(a.col("x")).alias("ss"),
            a.StddevPop(a.col("x")).alias("sp"),
            a.VarianceSamp(a.col("v")).alias("vs"),
            a.VariancePop(a.col("x")).alias("vp")]


PLANS = [
    ("scan", lambda a: a.table(F)),
    ("range", lambda a: a.range_(-5, 40, 3)),
    ("project", lambda a: a.table(F).select(
        (a.col("v") * a.lit(3)).alias("v3"), a.col("s"))),
    ("filter", lambda a: a.table(F).where(a.col("x") > a.lit(0.0))),
    ("limit", lambda a: a.table(F).limit(17)),
    ("union", lambda a: a.table(D).union(a.table(D))),
    ("expand", lambda a: a.DataFrame(a.L.LogicalExpand(
        (a.table(D).plan,),
        [[a.col("k2"), a.col("w")], [a.col("k2"), a.lit(None, a.T.INT64)]]))),
    ("sort", lambda a: a.table(F).order_by(
        a.sort.asc(a.col("k")), a.sort.desc(a.col("x")),
        a.sort.SortOrder(a.col("v"), False, False))),
    ("aggregate", lambda a: a.table(F).group_by("k").agg(*_aggs(a))),
    ("global_aggregate", lambda a: a.table(F).agg(*_aggs(a))),
    ("empty_global_aggregate", lambda a: a.table(F).where(
        a.col("v") > a.lit(10 ** 6)).agg(*_aggs(a))),
    ("percentiles", lambda a: a.table(F).where(a.IsNotNull(a.col("x")))
     .group_by("k").agg(a.Percentile(a.col("x"), 0.25).alias("p"),
                        a.ApproxPercentile(a.col("x"), 0.5).alias("q"))),
] + [(f"join_{how}", (lambda how: lambda a: a.table(F).join(
    a.table(D), ["k"], ["k2"], getattr(a.JoinType, how)))(how))
     for how in ("INNER", "LEFT_OUTER", "RIGHT_OUTER", "FULL_OUTER",
                 "LEFT_SEMI", "LEFT_ANTI", "EXISTENCE")] + [
    ("join_condition", lambda a: a.table(F).join(
        a.table(D), ["k"], ["k2"], a.JoinType.INNER,
        condition=a.GreaterThan(a.col("w"), a.col("v")))),
    ("join_cross", lambda a: a.table(D).join(a.table(D).select(
        a.col("w").alias("w2")), [], [], a.JoinType.CROSS)),
]

#: plans whose row order the test holds (the rest compare as multisets)
ORDERED = {"sort", "limit", "range", "scan", "project", "filter", "expand"}
#: the device path runs these plans too (it has no expand logical path
#: in the DataFrame API, and sample draws another sequence)
NO_DEVICE = {"expand"}


@pytest.mark.parametrize("case,make", PLANS, ids=[p[0] for p in PLANS])
def test_plan_handlers_match_jax_and_the_device(case, make):
    jax = JInterpreter().execute(make(JAX).plan)
    port = I.Interpreter().execute(make(PORT).plan)
    assert port.schema.types == jax.schema.types
    assert_tables_equal(port, jax, ignore_order=case not in ORDERED)
    if case not in NO_DEVICE:
        device = Session(CONF, device="cpu").collect(make(PORT))
        assert_tables_equal(port, device,
                            ignore_order=case not in ORDERED - {"filter"})


def test_sample_draws_the_jax_interpreters_rows():
    def q(a):
        return a.table(F).sample(0.3, seed=5)
    port = I.Interpreter().execute(q(PORT).plan)
    assert port.equals(JInterpreter().execute(q(JAX).plan))
    assert 0 < port.num_rows < F.num_rows


def test_file_scan_reads_the_source(tmp_path):
    import pyarrow.parquet as pq
    from spark_rapids_tpu.io.scan import read_parquet as jread_parquet
    from spark_rapids_tpu_torch.io import read_parquet
    pq.write_table(F.slice(0, 150), tmp_path / "a.parquet")
    pq.write_table(F.slice(150), tmp_path / "b.parquet")
    paths = [str(tmp_path / "a.parquet"), str(tmp_path / "b.parquet")]
    pred_p = PORT.col("v") > PORT.lit(0)
    pred_j = JAX.col("v") > JAX.lit(0)
    port = I.Interpreter().execute(read_parquet(paths, predicate=pred_p).plan)
    jax = JInterpreter().execute(jread_parquet(paths, predicate=pred_j).plan)
    assert_tables_equal(port, jax, ignore_order=True)
    assert port.num_rows == sum(1 for v in F.column("v").to_pylist()
                                if v is not None and v > 0)


# ---------------------------------------------------------------------------
# what the port does not have raises, naming its item
# ---------------------------------------------------------------------------

def test_unported_expression_raises_naming_item_7():
    """An expression of a module still to come (a scalar pandas UDF of
    ``python_exec.py``) has no handler yet and raises naming item 7, from
    a projection and from an aggregate's input, and so does an operator
    still to come. The window functions and ``LogicalWindow`` run;
    ``InterleaveBits`` and a window function outside a window raise the
    JAX interpreter's message (no handler there either)."""
    from dataclasses import dataclass
    from spark_rapids_tpu_torch.exec.sort import asc
    from spark_rapids_tpu_torch.expressions.aggregates import Count
    from spark_rapids_tpu_torch.expressions.base import Expression
    from spark_rapids_tpu_torch.expressions.window import (NthValue,
                                                           RowNumber, over)
    from spark_rapids_tpu_torch.expressions.zorder import zorder_key

    @dataclass(frozen=True, eq=False)
    class PandasUDF(Expression):
        child: Expression

        @property
        def children(self):
            return (self.child,)

        def with_children(self, c):
            return PandasUDF(c[0])

        @property
        def dtype(self):
            return PORT.T.INT64

    class LogicalArrowEvalPython(L.LogicalPlan):
        def schema(self):
            return self.children[0].schema()

    t = PORT.table(D)
    with pytest.raises(NotImplementedError,
                       match="PandasUDF.*ROADMAP item 7"):
        I.Interpreter().execute(t.select(PandasUDF(
            PORT.col("w")).alias("u")).plan)
    with pytest.raises(NotImplementedError,
                       match="PandasUDF.*ROADMAP item 7"):
        I.Interpreter().execute(t.group_by("k2").agg(
            Count(PandasUDF(PORT.col("w"))).alias("c")).plan)
    with pytest.raises(NotImplementedError,
                       match="ArrowEvalPython.*ROADMAP item 7"):
        I.Interpreter().execute(LogicalArrowEvalPython((t.plan,)))
    with pytest.raises(NotImplementedError,
                       match=r"^CPU interpreter: InterleaveBits$"):
        I.Interpreter().execute(t.select(zorder_key(
            PORT.col("w"), PORT.col("k2")).alias("z")).plan)
    with pytest.raises(NotImplementedError,
                       match=r"^CPU interpreter: NthValue$"):
        I.Interpreter().execute(t.group_by("k2").agg(
            Count(NthValue(PORT.col("w"))).alias("c")).plan)
    out = I.Interpreter().execute(t.window(
        over(RowNumber(), [PORT.col("k2")], [asc(PORT.col("w"))])
        .alias("rn")).plan)
    assert out.num_rows == D.num_rows
    assert out.column_names == D.column_names + ["rn"]


def test_row_evaluator_dispatch_is_the_jax_ones():
    """Both evaluators dispatch on ``_eval_<Class>``: every handler the
    port has, the JAX evaluator has by the same name."""
    port = {n for n in dir(I.RowEvaluator) if n.startswith("_eval_")}
    jax = {n for n in dir(JRowEvaluator) if n.startswith("_eval_")}
    assert port <= jax
    # 52 before the scalar slice, which adds the 22 handlers of
    # conditional.py, math.py and datetime.py, and Hypot, Logarithm,
    # NaNvl, Rand, RaiseError and UTCTimestampConv; the rest of
    # strings.py and the span programs add 10; the first collections
    # slice adds 15 and StringSplit and StringToMap; the second adds the
    # lambdas, the set operations, the shaping, ReplicateRows and
    # GetJsonObject (19)
    assert len(port) == 126
    for name in ("LambdaVariable", "TransformArray", "FilterArray",
                 "ExistsArray", "ForallArray", "AggregateArray",
                 "ArrayDistinct", "ArrayUnion", "ArrayIntersect",
                 "ArrayExcept", "ArraysOverlap", "ArrayRemove",
                 "ArrayPosition", "ArrayRepeat", "ArraySlice", "Sequence",
                 "Flatten", "GetJsonObject", "ReplicateRows"):
        assert f"_eval_{name}" in port
    for name in ("CreateArray", "Size", "ArrayContains", "ElementAt",
                 "GetArrayItem", "SortArray", "ArrayMin", "ArrayMax",
                 "CreateStruct", "GetStructField", "MapKeys", "MapValues",
                 "GetMapValue", "MapContainsKey", "MapFromArrays",
                 "StringSplit", "StringToMap"):
        assert f"_eval_{name}" in port
    for name in ("InitCap", "FormatNumber", "RegexpExtract",
                 "RegexpReplace", "ConcatWs", "Hex", "Bin", "Conv",
                 "FindInSet", "Empty2Null"):
        assert f"_eval_{name}" in port
    for name in ("If", "CaseWhen", "Coalesce", "LeastGreatest", "UnaryMath",
                 "Pow", "Atan2", "FloorCeil", "Round", "Signum",
                 "ExtractDatePart", "DateAddSub", "DateDiff", "AddMonths",
                 "LastDay", "UnixTimestampConv", "DateFormat",
                 "ParseDateTime", "FromUnixtime", "TruncDateTime",
                 "MonthsBetween", "NextDay"):
        assert f"_eval_{name}" in port
