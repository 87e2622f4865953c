"""The port's arithmetic expressions against the JAX package's and against
Spark's (Java's) semantics, on edge values: int64 and int32 extremes,
division by 0 and -1, NaN and signed zero divisors, shifts by -1, 31, 32,
63 and 64, an int32 value shifted by an int64 amount. Each expression runs
outside ANSI mode (rows must equal) and under it (the rows each kind
reports must equal). ``SPARK_DEPARTURES`` lists the cells where the JAX
package departs from Spark: there the port gives Spark's answer, and the
test pins that JAX gives another (ROADMAP Queue 3). Also the ANSI contract
through ``ProjectExec``, the generated case of
``tests/test_expressions.py::test_generated_arithmetic_matches_numpy`` and
the operator sugar.

Integers compare exactly, doubles bit for bit (NaN equal to NaN). The JAX
side runs with ``jax_disable_jit``, so each case pays no compile."""

import math

import jax
import numpy as np
import pyarrow as pa
import pytest

from spark_rapids_tpu import exec as jexec
from spark_rapids_tpu.batch import from_arrow as jax_from_arrow
from spark_rapids_tpu.exec.basic import \
    ArithmeticException as JArithmeticException
from spark_rapids_tpu.expressions import arithmetic as JA
from spark_rapids_tpu.expressions import col as jcol
from spark_rapids_tpu.expressions import lit as jlit
from spark_rapids_tpu.expressions.base import EvalContext as JCtx
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.batch import from_arrow
from spark_rapids_tpu_torch.exec import (ArithmeticException, InMemoryScanExec,
                                         ProjectExec, collect)
from spark_rapids_tpu_torch.expressions import arithmetic as TA
from spark_rapids_tpu_torch.expressions import col, lit
from spark_rapids_tpu_torch.expressions.base import EvalContext
from tests.harness.data_gen import LongGen, gen_table

I64_MIN, I64_MAX = -(1 << 63), (1 << 63) - 1
I32_MIN, I32_MAX = -(1 << 31), (1 << 31) - 1

#: (a, b) pairs at the edges of integer arithmetic, at each width
INT64_ROWS = [(I64_MIN, -1), (I64_MIN, 1), (I64_MIN, 2), (I64_MIN, 3),
              (I64_MIN, -3), (I64_MAX, -1), (I64_MAX, 2), (-7, -3), (7, -3),
              (-7, 3), (7, 3), (0, 0), (5, 0), (-(1 << 62), 2),
              (1 << 62, 2), (3037000500, 3037000500), (None, 4), (3, None),
              (-1, -1), (1, I64_MIN)]
INT32_ROWS = [(I32_MIN, -1), (I32_MIN, 2), (I32_MIN, 3), (I32_MAX, -1),
              (I32_MAX, 2), (-7, -3), (7, -3), (-7, 3), (0, 0), (5, 0),
              (-(1 << 30), 2), (46341, 46341), (None, 1), (2, None)]
NAN, INF = float("nan"), float("inf")
FLOAT_ROWS = [(7.5, 2.0), (-7.5, 2.0), (7.5, -2.0), (-7.5, -2.0),
              (1.0, 0.0), (1.0, -0.0), (-1.0, 0.0), (0.0, 0.0),
              (NAN, 1.0), (1.0, NAN), (INF, 2.0), (2.0, INF), (INF, INF),
              (-0.0, 3.0), (None, 1.0), (5.5, None)]

BINARY = ("Add", "Subtract", "Multiply", "Divide", "IntegralDivide",
          "Remainder", "Pmod")
UNARY = ("UnaryMinus", "Abs")

#: (expression, width, a, b) cells where the port follows Spark and the
#: JAX package gives another value
SPARK_DEPARTURES = {
    # abs(MIN) wraps, so the JAX package's floor division goes wrong
    ("IntegralDivide", 64, I64_MIN, 2), ("IntegralDivide", 64, I64_MIN, 3),
    ("IntegralDivide", 64, I64_MIN, -3), ("IntegralDivide", 64, 1, I64_MIN),
    ("Remainder", 64, I64_MIN, 3), ("Remainder", 64, I64_MIN, -3),
    ("Remainder", 64, 1, I64_MIN), ("Remainder", 32, I32_MIN, 3),
    ("Pmod", 64, I64_MIN, -3),
    # Spark's pmod by a negative divisor can stay negative
    ("Pmod", 64, -7, -3), ("Pmod", 32, -7, -3), ("Pmod", 0, -7.5, -2.0),
}
#: (expression, kind) whose ANSI reports the JAX package leaves out, or
#: (Multiply) makes on other rows
ANSI_DEPARTURES = {("Multiply", "ARITHMETIC_OVERFLOW"),
                   ("IntegralDivide", "ARITHMETIC_OVERFLOW"),
                   ("Remainder", "DIVIDE_BY_ZERO"),
                   ("Pmod", "DIVIDE_BY_ZERO"),
                   ("UnaryMinus", "ARITHMETIC_OVERFLOW"),
                   ("Abs", "ARITHMETIC_OVERFLOW")}


@pytest.fixture(autouse=True)
def _jax_eager():
    with jax.disable_jit():
        yield


# ---------------------------------------------------------------------------
# Spark's semantics on Python numbers
# ---------------------------------------------------------------------------

def _wrap(x: int, bits: int) -> int:
    x &= (1 << bits) - 1
    return x - (1 << bits) if x >> (bits - 1) else x


def _quot(a: int, b: int) -> int:
    """Java's integer division, exact (toward zero)."""
    q = abs(a) // abs(b)
    return q if (a < 0) == (b < 0) else -q


def _rem(a, b):
    if isinstance(a, float):
        with np.errstate(invalid="ignore"):
            return float(np.fmod(a, b))     # C fmod: NaN for inf % x
    return a - b * _quot(a, b)


def _long(x: float) -> int:
    """Spark's (non-ANSI) cast of a double to bigint: NaN to 0, out of
    range saturated."""
    if math.isnan(x):
        return 0
    if x >= 2.0 ** 63:
        return I64_MAX
    if x <= -2.0 ** 63:
        return I64_MIN
    return int(x)


def spark(name: str, a, b, bits: int):
    """(value, kind that ANSI raises or None) of Spark's expression;
    ``bits`` 0 for doubles, where no integer overflow exists."""
    if a is None or (b is None and name in BINARY):
        return None, None
    if bits == 0 and name == "IntegralDivide":
        # div takes bigint operands: the analyzer casts doubles
        a, b, bits = _long(a), _long(b), 64
    if bits == 0:
        if name in ("Add", "Subtract", "Multiply"):
            return {"Add": a + b, "Subtract": a - b,
                    "Multiply": a * b}[name], None
        if name == "UnaryMinus":
            return -a, None
        if name == "Abs":
            return abs(a), None
        if b == 0.0:
            return None, "DIVIDE_BY_ZERO"
        if name == "Divide":
            return a / b, None
        r = _rem(a, b)
        if name == "Pmod" and r < 0:
            r = _rem(r + b, b)
        return r, None
    exact = {"Add": lambda: a + b, "Subtract": lambda: a - b,
             "Multiply": lambda: a * b, "UnaryMinus": lambda: -a,
             "Abs": lambda: abs(a)}
    if name in exact:
        v = exact[name]()
        return _wrap(v, bits), (None if v == _wrap(v, bits)
                                else "ARITHMETIC_OVERFLOW")
    if b == 0:
        return None, "DIVIDE_BY_ZERO"
    if name == "Divide":
        return float(a) / float(b), None
    if name == "IntegralDivide":
        # Spark casts int operands to bigint; only bigint MIN div -1
        # overflows
        q = _quot(a, b)
        return _wrap(q, 64), (None if q == _wrap(q, 64)
                              else "ARITHMETIC_OVERFLOW")
    r = _rem(a, b)
    if name == "Pmod" and r < 0:
        r = _rem(_wrap(r + b, bits), b)
    return r, None


def _same(x, y) -> bool:
    if isinstance(x, float) and isinstance(y, float):
        return (math.isnan(x) and math.isnan(y)) or (
            x == y and math.copysign(1, x) == math.copysign(1, y))
    return x == y and type(x) is type(y)


# ---------------------------------------------------------------------------
# Evaluation in both packages
# ---------------------------------------------------------------------------

def _table(rows, typ) -> pa.Table:
    a, b = zip(*rows)
    return pa.table({"a": pa.array(a, typ), "b": pa.array(b, typ)})


def _expr(pkg, name: str, **kw):
    c = col if pkg is TA else jcol
    cls = getattr(pkg, name)
    if name in UNARY or name == "BitwiseNot":
        return cls(c("a"))
    return cls(c("a"), c("b"), **kw)


def _port_eval(expr, t: pa.Table, ansi: bool):
    """(values, {kind: bool rows reported}) of the port's expression."""
    batch, schema = from_arrow(t, device="cpu")
    masks = {}
    ctx = EvalContext(ansi, _Recorder(masks))
    out = expr.bind(schema).eval(batch, ctx)
    n = t.num_rows
    v = out.validity[:n].numpy()
    data = out.data[:n].numpy().tolist()
    return [x if ok else None for x, ok in zip(data, v)], masks


def _jax_eval(expr, t: pa.Table, ansi: bool):
    batch, schema = jax_from_arrow(t)
    masks = {}
    ctx = JCtx(ansi, _Recorder(masks))
    out = expr.bind(schema).eval(batch, ctx)
    n = t.num_rows
    v = np.asarray(out.validity)[:n]
    data = np.asarray(out.data)[:n].tolist()
    return [x if ok else None for x, ok in zip(data, v)], masks


class _Recorder(dict):
    """An ``errors`` collector whose reports keep their row masks (both
    packages keep only ``sum(bad)``; the mask says which rows)."""

    def __init__(self, masks):
        super().__init__()
        self.masks = masks


@pytest.fixture(autouse=True)
def _record_masks(monkeypatch):
    """Reports into a ``_Recorder`` keep their masks; others go on as
    they are."""
    def recorder(real):
        def report(self, bad, kind="ARITHMETIC_OVERFLOW", always=False):
            if not isinstance(self.errors, _Recorder):
                return real(self, bad, kind, always)
            if self.ansi or always:
                m = np.asarray(bad.cpu() if hasattr(bad, "cpu") else bad)
                old = self.errors.masks.get(kind)
                self.errors.masks[kind] = m if old is None else old | m
        return report
    monkeypatch.setattr(EvalContext, "report", recorder(EvalContext.report))
    monkeypatch.setattr(JCtx, "report", recorder(JCtx.report))


WIDTHS = {64: (INT64_ROWS, pa.int64()), 32: (INT32_ROWS, pa.int32()),
          0: (FLOAT_ROWS, pa.float64())}


@pytest.mark.parametrize("bits", [64, 32, 0], ids=["int64", "int32",
                                                   "double"])
@pytest.mark.parametrize("name", BINARY + UNARY)
def test_expression_matches_spark_and_jax(name, bits):
    rows, typ = WIDTHS[bits]
    t = _table(rows, typ)
    for ansi in (False, True):
        got, got_masks = _port_eval(_expr(TA, name), t, ansi)
        want, want_masks = _jax_eval(_expr(JA, name), t, ansi)
        spark_kinds = {}
        for i, (a, b) in enumerate(rows):
            value, kind = spark(name, a, b, bits)
            if kind == "DIVIDE_BY_ZERO":
                value = None        # the non-ANSI null
            assert _same(got[i], value), (name, a, b, got[i], value)
            departs = (name, bits, a, b) in SPARK_DEPARTURES
            assert _same(got[i], want[i]) != departs, \
                (name, a, b, got[i], want[i])
            if kind is not None:
                spark_kinds.setdefault(kind, set()).add(i)
        if not ansi:
            assert got_masks == {} and want_masks == {}
            continue
        got_rows = {k: set(np.flatnonzero(m[:len(rows)]))
                    for k, m in got_masks.items()}
        got_rows = {k: v for k, v in got_rows.items() if v}
        assert got_rows == spark_kinds, name
        want_rows = {k: set(np.flatnonzero(m[:len(rows)]))
                     for k, m in want_masks.items()}
        for kind in set(got_rows) | set(want_rows):
            if (name, kind) in ANSI_DEPARTURES:
                continue
            assert got_rows.get(kind, set()) == want_rows.get(kind, set()), \
                (name, kind)


def test_ansi_departures_are_real():
    """Each ANSI departure shows on one row: the port raises or passes as
    Spark does, and the JAX package does the other."""
    cases = [("Multiply", (I64_MIN, -1), True),
             ("Multiply", (-(1 << 62), 2), False),
             ("IntegralDivide", (I64_MIN, -1), True),
             ("Remainder", (5, 0), True), ("Pmod", (5, 0), True),
             ("UnaryMinus", (I64_MIN, 1), True), ("Abs", (I64_MIN, 1), True)]
    for name, row, raises in cases:
        t = _table([row], pa.int64())
        _, got = _port_eval(_expr(TA, name), t, True)
        _, want = _jax_eval(_expr(JA, name), t, True)
        assert any(m[0] for m in got.values()) == raises, name
        assert any(m[0] for m in want.values()) != raises, name


SHIFT_AMOUNTS = [-1, 0, 1, 5, 31, 32, 33, 63, 64, 65, -33]


@pytest.mark.parametrize("op", ["left", "right", "right_unsigned"])
@pytest.mark.parametrize("value_type,amount_type",
                         [(pa.int32(), pa.int32()), (pa.int64(), pa.int32()),
                          (pa.int32(), pa.int64()), (pa.int64(), pa.int64())],
                         ids=["i32<<i32", "i64<<i32", "i32<<i64", "i64<<i64"])
def test_shift_matches_spark_and_jax(op, value_type, amount_type):
    bits = 64 if value_type == pa.int64() else 32
    lo, hi = (I64_MIN, I64_MAX) if bits == 64 else (I32_MIN, I32_MAX)
    values = [lo, hi, -1, 1, -123456789, 987654321, 0, None]
    amounts = SHIFT_AMOUNTS + ([(1 << 32) + 3, -(1 << 40)]
                               if amount_type == pa.int64() else [])
    rows = [(v, s) for v in values for s in amounts] + [(1, None)]
    a, b = zip(*rows)
    t = pa.table({"a": pa.array(a, value_type), "b": pa.array(b, amount_type)})
    got, _ = _port_eval(TA.Shift(col("a"), col("b"), op), t, False)
    want, _ = _jax_eval(JA.Shift(jcol("a"), jcol("b"), op), t, False)
    assert got == want
    for (v, s), g in zip(rows, got):
        if v is None or s is None:
            assert g is None
            continue
        n = _wrap(s, 32) & (bits - 1)     # the amount as a Java int
        if op == "left":
            exp = _wrap(v << n, bits)
        elif op == "right":
            exp = v >> n
        else:
            exp = _wrap((v & ((1 << bits) - 1)) >> n, bits)
        assert g == exp, (op, v, s)
    _, schema = from_arrow(t, device="cpu")
    want_type = T.INT64 if bits == 64 else T.INT32
    assert TA.Shift(col("a"), col("b"), op).bind(schema).dtype == want_type


@pytest.mark.parametrize("op", ["and", "or", "xor"])
def test_bitwise_matches_jax(op):
    vals = [I64_MIN, I64_MAX, -1, 0, 0x5555, None]
    rows = [(x, y) for x in vals for y in vals]
    t = pa.table({"a": pa.array([r[0] for r in rows], pa.int64()),
                  "b": pa.array([r[1] for r in rows], pa.int64())})
    got, _ = _port_eval(TA.BitwiseOp(col("a"), col("b"), op), t, False)
    want, _ = _jax_eval(JA.BitwiseOp(jcol("a"), jcol("b"), op), t, False)
    assert got == want
    t32 = pa.table({"a": pa.array([I32_MIN, I32_MAX, -1, 7, None],
                                  pa.int32())})
    got, _ = _port_eval(TA.BitwiseNot(col("a")), t32, False)
    want, _ = _jax_eval(JA.BitwiseNot(jcol("a")), t32, False)
    assert got == want == [I32_MAX, I32_MIN, 0, -8, None]


def test_mixed_widths_promote_as_jax():
    """int32 op int64 computes in int64; the result types agree."""
    t = pa.table({"a": pa.array([I32_MIN, I32_MAX, -5, None], pa.int32()),
                  "b": pa.array([I64_MAX, 2, -1, 3], pa.int64())})
    _, schema = from_arrow(t, device="cpu")
    for name in BINARY:
        got, _ = _port_eval(_expr(TA, name), t, False)
        want, _ = _jax_eval(_expr(JA, name), t, False)
        assert got == want, name
        assert str(_expr(TA, name).bind(schema).dtype) == \
            str(_expr(JA, name).bind(jax_from_arrow(t)[1]).dtype)
    for name in ("Divide", "IntegralDivide", "Remainder", "Pmod"):
        assert _expr(TA, name).bind(schema).nullable


@pytest.mark.parametrize("expr,kind", [
    (TA.Multiply(col("a"), lit(4)), "ARITHMETIC_OVERFLOW"),
    (TA.Add(col("a"), col("a")), "ARITHMETIC_OVERFLOW"),
    (TA.Divide(col("a"), col("z")), "DIVIDE_BY_ZERO"),
    (TA.IntegralDivide(col("a"), col("z")), "DIVIDE_BY_ZERO"),
])
def test_project_raises_ansi_with_jax_kind(expr, kind):
    """The ANSI contract through the operators: a report raises
    ``ArithmeticException`` after the batch, naming the JAX kind; the same
    rows pass outside ANSI mode, and clean rows pass under it."""
    t = pa.table({"a": pa.array([1, 2, 1 << 62], pa.int64()),
                  "z": pa.array([1, 0, 2], pa.int64())})
    jexpr = {"Multiply": JA.Multiply(jcol("a"), jlit(4)),
             "Add": JA.Add(jcol("a"), jcol("a")),
             "Divide": JA.Divide(jcol("a"), jcol("z")),
             "IntegralDivide": JA.IntegralDivide(jcol("a"), jcol("z"))}[
                 type(expr).__name__]
    with pytest.raises(ArithmeticException, match=kind):
        collect(ProjectExec([expr.alias("x")],
                            InMemoryScanExec(t, device="cpu"),
                            ctx=EvalContext(True)))
    with pytest.raises(JArithmeticException, match=kind):
        jexec.collect(jexec.ProjectExec([jexpr.alias("x")],
                                        jexec.InMemoryScanExec(t),
                                        ctx=JCtx(True)))
    collect(ProjectExec([expr.alias("x")], InMemoryScanExec(t, device="cpu")))
    clean = t.slice(0, 1)
    got = collect(ProjectExec([expr.alias("x")],
                              InMemoryScanExec(clean, device="cpu"),
                              ctx=EvalContext(True)))
    want = jexec.collect(jexec.ProjectExec([jexpr.alias("x")],
                                           jexec.InMemoryScanExec(clean),
                                           ctx=JCtx(True)))
    assert got.column("x").to_pylist() == want.column("x").to_pylist()


def test_filter_raises_ansi():
    from spark_rapids_tpu_torch.exec import FilterExec
    t = pa.table({"a": pa.array([1, I64_MAX], pa.int64())})
    plan = FilterExec(TA.Add(col("a"), lit(1)) > lit(0),
                      InMemoryScanExec(t, device="cpu"),
                      ctx=EvalContext(True))
    with pytest.raises(ArithmeticException, match="ARITHMETIC_OVERFLOW"):
        collect(plan)


def test_non_ansi_reports_nothing():
    """Outside ANSI mode no expression reports, so no operator reads a
    count back."""
    t = pa.table({"a": pa.array([I64_MIN, 5], pa.int64()),
                  "b": pa.array([-1, 0], pa.int64())})
    for name in BINARY + UNARY:
        _, masks = _port_eval(_expr(TA, name), t, False)
        assert masks == {}
    assert EvalContext(True).errors is None       # ANSI no longer refused


def test_generated_arithmetic_matches_numpy():
    """``tests/test_expressions.py``'s generated case on both packages."""
    t = gen_table([("a", LongGen(min_val=-10**6, max_val=10**6)),
                   ("b", LongGen(min_val=1, max_val=1000))], n=1024, seed=5)
    got, _ = _port_eval((col("a") + col("b")) * lit(3) - col("b"), t, False)
    want, _ = _jax_eval((jcol("a") + jcol("b")) * jlit(3) - jcol("b"), t,
                        False)
    a, b = t.column("a").to_pylist(), t.column("b").to_pylist()
    exp = [None if (x is None or y is None) else (x + y) * 3 - y
           for x, y in zip(a, b)]
    assert got == want == exp


def test_operator_sugar():
    a, b = col("a"), col("b")
    assert type(a / b) is TA.Divide and type(a % b) is TA.Remainder
    assert type(-a) is TA.UnaryMinus
    from spark_rapids_tpu_torch.expressions import And, Not, Or
    assert type(a & b) is And and type(a | b) is Or and type(~a) is Not
    t = pa.table({"a": pa.array([7, -7], pa.int64()),
                  "b": pa.array([2, 2], pa.int64())})
    got, _ = _port_eval(-(a % b) + a / b, t, False)
    assert got == [-1 + 3.5, 1 - 3.5]
