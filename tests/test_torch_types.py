"""The fixed-width kinds the port adds (int8, int16, float32, 18-digit
decimal, timestamp and NULL) against the JAX package on the CPU: the Arrow
round trip (the port's ``to_arrow`` equal to the JAX package's over the same
input, decimals exact at their edges and with garbage under nulls), the
numeric promotion, the sort order, grouping and the join keys, and the
arithmetic on int8 and int16 with Java's wrapping and decimal ``Multiply``'s
result type. Where the JAX package departs from Spark (float32 orders -0.0
below 0.0 there), the port follows Spark and a test pins the difference."""

import decimal as D

import jax
import numpy as np
import pyarrow as pa
import pyarrow.compute as pc
import pytest

from spark_rapids_tpu import types as JT
from spark_rapids_tpu.batch import from_arrow as jax_from_arrow
from spark_rapids_tpu.batch import to_arrow as jax_to_arrow
from spark_rapids_tpu.exec.sort import SortOrder as JSortOrder
from spark_rapids_tpu.exec.sort import sort_batch as jax_sort_batch
from spark_rapids_tpu.expressions import arithmetic as JA
from spark_rapids_tpu.expressions import col as jcol
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.batch import from_arrow, to_arrow
from spark_rapids_tpu_torch.exec import (AggregateMode, HashAggregateExec,
                                         HashJoinExec, InMemoryScanExec,
                                         JoinType, ProjectExec, collect)
from spark_rapids_tpu_torch.exec.sort import SortOrder, sort_batch
from spark_rapids_tpu_torch.expressions import arithmetic as TA
from spark_rapids_tpu_torch.expressions import col
from spark_rapids_tpu_torch.expressions.aggregates import Count, Sum

N = 257
DEC_MAX = 10 ** 18 - 1


def _decimals(unscaled, scale, precision=18, valid=None):
    vals = [None if valid is not None and not ok else
            D.Decimal(int(u)).scaleb(-scale)
            for u, ok in zip(unscaled, valid if valid is not None
                             else [True] * len(unscaled))]
    with D.localcontext() as c:
        c.prec = 60
        return pa.array(vals, pa.decimal128(precision, scale))


def _kinds_table(seed: int = 0, n: int = N) -> pa.Table:
    rng = np.random.default_rng(seed)
    nulls = rng.random(n) < 0.15
    f32 = rng.standard_normal(n).astype(np.float32)
    f32[:4] = [np.nan, np.inf, -np.inf, 0.5]
    dec = rng.integers(-DEC_MAX, DEC_MAX, n, dtype=np.int64)
    dec[:2] = [DEC_MAX, -DEC_MAX]
    return pa.table({
        "i8": pa.array(rng.integers(-128, 128, n).astype(np.int8),
                       mask=nulls),
        "i16": pa.array(rng.integers(-32768, 32768, n).astype(np.int16),
                        mask=np.roll(nulls, 1)),
        "f32": pa.array(f32, mask=np.roll(nulls, 2)),
        "d18": _decimals(dec, 0, valid=~np.roll(nulls, 3)),
        "d15": _decimals(rng.integers(-10 ** 15 + 1, 10 ** 15, n), 2, 15),
        "ts": pa.array(rng.integers(-2 ** 55, 2 ** 55, n),
                       pa.timestamp("us", tz="UTC"),
                       mask=np.roll(nulls, 4)),
    })


@pytest.fixture(scope="module")
def kinds():
    return _kinds_table()


def test_kinds_and_storage_match_jax():
    for name in ("INT8", "INT16", "FLOAT32", "TIMESTAMP", "NULL"):
        ours, theirs = getattr(T, name), getattr(JT, name)
        assert ours.kind.value == theirs.kind.value
        assert str(ours) == str(theirs)
        assert T.numpy_dtype(ours) == JT.numpy_dtype(theirs)
    assert str(T.decimal(15, 2)) == str(JT.decimal(15, 2)) == \
        "decimal(15,2)"
    assert T.numpy_dtype(T.decimal(18, 4)) == np.int64
    assert T.to_arrow(T.TIMESTAMP) == pa.timestamp("us", tz="UTC")
    assert T.from_arrow(pa.timestamp("ns")) == T.TIMESTAMP
    assert T.from_arrow(pa.decimal128(12, 3)) == T.decimal(12, 3)


@pytest.mark.parametrize("precision", [19, 38])
def test_wide_decimals_raise_naming_their_slice(precision):
    """A decimal past 18 digits is a type of its own now (DECIMAL128,
    four limbs): equal to the JAX type, from Arrow too; and a wide
    ``Multiply`` result, which no device here computes, is refused by
    tagging with its reason (an island on the row interpreter)."""
    from spark_rapids_tpu_torch.batch import Field, Schema
    from spark_rapids_tpu_torch.plan import Session, table
    ours, theirs = T.decimal(precision, 2), JT.decimal(precision, 2)
    assert (ours.kind.value, ours.precision, ours.scale) == \
        (theirs.kind.value, theirs.precision, theirs.scale)
    assert str(ours) == str(theirs) == f"decimal({precision},2)"
    assert T.from_arrow(pa.decimal128(precision, 2)) == ours
    assert T.to_arrow(ours) == pa.decimal128(precision, 2)
    product = TA.Multiply(col("a"), col("b")).bind(
        Schema([Field("a", T.decimal(10, 2)), Field("b", T.decimal(9, 2))]))
    assert product.dtype == T.decimal(20, 4)
    assert "decimal(20,4), past 18 digits" in \
        product.device_unsupported_reason()
    t = pa.table({"a": pa.array([D.Decimal("1.25")], pa.decimal128(10, 2)),
                  "b": pa.array([D.Decimal("2.50")], pa.decimal128(9, 2))})
    ses = Session(device="cpu")
    df = table(t).select((col("a") * col("b")).alias("p"))
    assert "decimal(20,4), past 18 digits" in ses.explain(df)
    assert ses.collect(df).column("p").to_pylist() == [D.Decimal("3.1250")]
    assert ses.fell_back() == ["CpuFallback[Project]"]


def _schema(**kinds):
    from spark_rapids_tpu_torch.batch import Field, Schema
    return Schema([Field(k, v) for k, v in kinds.items()])


_NUMERIC = ["INT8", "INT16", "INT32", "INT64", "FLOAT32", "FLOAT64",
            (5, 2), (10, 0), (18, 18), (12, 4)]


def _numeric(pkg, spec):
    return pkg.decimal(*spec) if isinstance(spec, tuple) else \
        getattr(pkg, spec)


@pytest.mark.parametrize("a", _NUMERIC, ids=str)
def test_common_numeric_type_matches_jax(a):
    for b in _NUMERIC:
        theirs = JT.common_numeric_type(_numeric(JT, a), _numeric(JT, b))
        # past 18 digits too (DECIMAL128)
        ours = T.common_numeric_type(_numeric(T, a), _numeric(T, b))
        assert str(ours) == str(theirs), (a, b)


def test_arrow_round_trip_matches_jax(kinds):
    batch, schema = from_arrow(kinds, device="cpu")
    ours = to_arrow(batch, schema)
    jb, js = jax_from_arrow(kinds)
    theirs = jax_to_arrow(jb, js)
    assert ours.schema == theirs.schema == kinds.schema
    for name in kinds.column_names:
        o, t = ours.column(name), theirs.column(name)
        assert pc.is_null(o).equals(pc.is_null(t))
        if name == "f32":     # NaN: compare the bits
            assert np.array_equal(
                o.to_numpy(zero_copy_only=False).view(np.int32),
                t.to_numpy(zero_copy_only=False).view(np.int32))
        else:
            assert o.equals(t), name
    assert ours.drop(["f32"]).equals(kinds.drop(["f32"]))


@pytest.mark.parametrize("scale,values", [
    (0, [DEC_MAX, -DEC_MAX, 0, 1, -1]),
    (18, [DEC_MAX, -DEC_MAX, 1, -1, 0]),
    (2, [123456789012345678, -5, 0, 10 ** 17, -(10 ** 17)])])
def test_decimal_edges_cross_exactly(scale, values):
    arr = _decimals(values, scale)
    batch, schema = from_arrow(pa.table({"d": arr}), device="cpu")
    assert batch.columns[0].data.tolist()[:len(values)] == values
    assert to_arrow(batch, schema).column("d").combine_chunks().equals(arr)


def test_decimal_nulls_under_garbage_upload_as_zero():
    """Arrow leaves a null slot's bytes undefined: garbage under a null
    uploads as 0 and comes back null."""
    words = np.array([[7, 0], [-1, -1], [123, 0], [999, 12345]], np.int64)
    valid = np.array([True, False, True, False])
    arr = pa.Array.from_buffers(
        pa.decimal128(18, 3), 4,
        [pa.py_buffer(np.packbits(valid, bitorder="little").tobytes()),
         pa.py_buffer(words.tobytes())])
    batch, schema = from_arrow(pa.table({"d": arr}), device="cpu")
    assert batch.columns[0].data.tolist()[:4] == [7, 0, 123, 0]
    assert batch.columns[0].validity.tolist()[:4] == valid.tolist()
    out = to_arrow(batch, schema).column("d")
    assert out.to_pylist() == [D.Decimal("0.007"), None, D.Decimal("0.123"),
                               None]


def test_sliced_decimal_and_timestamp_units():
    arr = _decimals(list(range(-5, 5)), 1, 4).slice(3, 5)
    batch, _ = from_arrow(pa.table({"d": arr}), device="cpu")
    assert batch.columns[0].data.tolist()[:5] == [-2, -1, 0, 1, 2]
    ts = pa.array([1, -1000, None], pa.timestamp("ms", tz="Asia/Tokyo"))
    batch, schema = from_arrow(pa.table({"t": ts}), device="cpu")
    assert batch.columns[0].data.tolist()[:2] == [1000, -1000000]
    assert to_arrow(batch, schema).column("t").to_pylist() == \
        ts.cast(pa.timestamp("us", tz="UTC")).to_pylist()


def test_null_column_round_trip():
    t = pa.table({"n": pa.nulls(5), "x": pa.array(range(5), pa.int8())})
    batch, schema = from_arrow(t, device="cpu")
    assert schema[0].dtype == T.NULL
    assert not batch.columns[0].validity.any()
    assert batch.columns[0].data.dtype == T.NULL.storage_dtype
    assert to_arrow(batch, schema).equals(t)


def _sort_rows(table: pa.Table):
    return list(zip(*[table.column(n).to_pylist()
                      for n in table.column_names]))


@pytest.mark.parametrize("name", ["i8", "i16", "f32", "d18", "d15", "ts"])
@pytest.mark.parametrize("descending", [False, True])
def test_sort_order_matches_jax(kinds, name, descending):
    t = kinds.select([name])
    batch, schema = from_arrow(t, device="cpu")
    ours = to_arrow(sort_batch(batch, [SortOrder(col(name).bind(schema),
                                                 descending)]), schema)
    jb, js = jax_from_arrow(t)
    with jax.disable_jit():
        theirs = jax_to_arrow(jax_sort_batch(
            jb, [JSortOrder(jcol(name).bind(js), descending)]), js)
    a, b = _sort_rows(ours), _sort_rows(theirs)
    if name == "f32":   # NaN != NaN as a Python float
        a, b = ([tuple("nan" if v != v else v for v in r) for r in x]
                for x in (a, b))
    assert a == b


def test_float32_signed_zero_sorts_as_spark():
    """Spark orders -0.0 equal to 0.0 (``SQLOrderingUtil``): a stable sort
    keeps their input order. The JAX package orders float32 by its bits,
    -0.0 first (ROADMAP Queue 3)."""
    t = pa.table({"f": pa.array([0.0, -0.0, 1.0, -0.0, 0.0], pa.float32()),
                  "i": pa.array(range(5), pa.int32())})
    batch, schema = from_arrow(t, device="cpu")
    ours = to_arrow(sort_batch(batch, [SortOrder(col("f").bind(schema))]),
                    schema)
    assert ours.column("i").to_pylist() == [0, 1, 3, 4, 2]
    jb, js = jax_from_arrow(t)
    with jax.disable_jit():
        theirs = jax_to_arrow(jax_sort_batch(
            jb, [JSortOrder(jcol("f").bind(js))]), js)
    assert theirs.column("i").to_pylist() == [1, 3, 0, 4, 2]


@pytest.mark.parametrize("key", ["i8", "i16", "d15", "ts"])
def test_group_by_new_kinds_matches_pyarrow(key):
    rng = np.random.default_rng(3)
    base = _kinds_table(seed=4, n=600)
    t = pa.table({key: pc.take(base.column(key),
                               pa.array(rng.integers(0, 40, 600))),
                  "v": pa.array(rng.integers(-50, 50, 600))})
    scan = InMemoryScanExec(t, batch_rows=128, device="cpu")
    partial = HashAggregateExec([col(key)], [Sum(col("v")).alias("s"),
                                             Count().alias("c")],
                                scan, AggregateMode.PARTIAL)
    final = HashAggregateExec([col(key)], [Sum(col("v")).alias("s"),
                                           Count().alias("c")],
                              partial, AggregateMode.FINAL)
    got = collect(final).sort_by(key)
    want = t.group_by(key).aggregate([("v", "sum"), ("v", "count")])
    want = want.sort_by(key)
    assert got.column(key).equals(want.column(key))
    assert got.column("s").to_pylist() == want.column("v_sum").to_pylist()
    assert got.column("c").to_pylist() == want.column("v_count").to_pylist()


@pytest.mark.parametrize("key", ["i8", "i16", "ts", "d18"])
def test_hash_join_on_new_kinds_matches_pyarrow(kinds, key):
    left = pa.table({"k": kinds.column(key),
                     "x": pa.array(range(kinds.num_rows))})
    right = pa.table({"rk": kinds.column(key).slice(0, 90),
                      "y": pa.array(range(90))})
    plan = HashJoinExec([col("k")], [col("rk")], JoinType.INNER,
                        InMemoryScanExec(left, batch_rows=64, device="cpu"),
                        InMemoryScanExec(right, device="cpu"))
    got = sorted(_sort_rows(collect(plan).select(["x", "y"])))
    want = left.join(right, keys="k", right_keys="rk", join_type="inner")
    assert got == sorted(_sort_rows(want.select(["x", "y"])))


# ---- arithmetic on int8 / int16 and decimals -----------------------------

I8, I16 = (-128, 127), (-32768, 32767)
NARROW_ROWS = {
    "int8": [(-128, -1), (-128, 1), (127, 1), (127, 127), (-128, -128),
             (100, 100), (-7, 3), (7, -3), (-100, -100), (5, 0), (-128, 2),
             (None, 3), (64, 2)],
    "int16": [(-32768, -1), (32767, 1), (32767, 32767), (-32768, -32768),
              (300, 300), (-7, 3), (7, -3), (-30000, -30000), (5, 0),
              (None, 2), (16384, 2)],
}
_BINARY = ("Add", "Subtract", "Multiply", "IntegralDivide", "Remainder")


def _narrow_table(width):
    rows = NARROW_ROWS[width]
    at = pa.int8() if width == "int8" else pa.int16()
    return pa.table({"a": pa.array([r[0] for r in rows], at),
                     "b": pa.array([r[1] for r in rows], at)})


def _eval_both(expr_t, expr_j, t):
    scan = InMemoryScanExec(t, device="cpu")
    ours = collect(ProjectExec([expr_t], scan)).column(0).to_pylist()
    jb, js = jax_from_arrow(t)
    with jax.disable_jit():
        c = expr_j.bind(js).eval(jb)
        n = int(jb.num_rows)
        theirs = [int(v) if ok else None for v, ok in
                  zip(np.asarray(c.data)[:n], np.asarray(c.validity)[:n])]
    return ours, theirs


@pytest.mark.parametrize("width", ["int8", "int16"])
@pytest.mark.parametrize("op", _BINARY)
def test_narrow_arithmetic_wraps_as_jax(width, op):
    t = _narrow_table(width)
    ours, theirs = _eval_both(getattr(TA, op)(col("a"), col("b")),
                              getattr(JA, op)(jcol("a"), jcol("b")), t)
    if op == "Remainder":
        # the JAX package's MIN % d departs from Java (ROADMAP Queue 3)
        keep = [i for i, r in enumerate(NARROW_ROWS[width])
                if r[0] not in (I8[0], I16[0])]
        ours = [ours[i] for i in keep]
        theirs = [theirs[i] for i in keep]
    assert ours == theirs
    dtype = getattr(TA, op)(col("a"), col("b")).bind(
        _schema(a=getattr(T, width.upper()), b=getattr(T, width.upper())))
    want = "bigint" if op == "IntegralDivide" else \
        {"int8": "tinyint", "int16": "smallint"}[width]
    assert str(dtype.dtype) == want


def _java(op, a, b, bits):
    """Java's int arithmetic, narrowed back to ``bits`` (Spark's byte and
    short arithmetic)."""
    if a is None or b is None:
        return None
    if op == "Add":
        r = a + b
    elif op == "Subtract":
        r = a - b
    elif op == "Multiply":
        r = a * b
    elif op == "Pmod":
        if b == 0:
            return None
        m = int(np.fmod(a, b))
        r = int(np.fmod(m + b, b)) if m < 0 else m
    else:
        raise ValueError(op)
    r &= (1 << bits) - 1
    return r - (1 << bits) if r >= 1 << (bits - 1) else r


@pytest.mark.parametrize("width,bits", [("int8", 8), ("int16", 16)])
@pytest.mark.parametrize("op", ["Add", "Subtract", "Multiply", "Pmod"])
def test_narrow_arithmetic_follows_java(width, bits, op):
    t = _narrow_table(width)
    scan = InMemoryScanExec(t, device="cpu")
    got = collect(ProjectExec([getattr(TA, op)(col("a"), col("b"))],
                              scan)).column(0).to_pylist()
    assert got == [_java(op, a, b, bits) for a, b in NARROW_ROWS[width]]


@pytest.mark.parametrize("width", ["int8", "int16"])
def test_shift_promotes_narrow_operands_to_int(width):
    t = _narrow_table(width)
    ours, theirs = _eval_both(TA.Shift(col("a"), col("b"), "left"),
                              JA.Shift(jcol("a"), jcol("b"), "left"), t)
    assert ours == theirs
    assert TA.Shift(col("a"), col("b")).bind(t and _schema(
        a=getattr(T, width.upper()), b=T.INT32)).dtype == T.INT32


@pytest.mark.parametrize("a,b", [((5, 2), (6, 3)), ((9, 0), (8, 8)),
                                 ((4, 1), "INT16"), ("INT8", (7, 7))],
                         ids=str)
def test_decimal_multiply_result_type_matches_jax(a, b):
    def typed(pkg, spec):
        return pkg.decimal(*spec) if isinstance(spec, tuple) else \
            getattr(pkg, spec)
    ours = TA.Multiply(col("a"), col("b")).bind(
        _schema(a=typed(T, a), b=typed(T, b))).dtype
    from spark_rapids_tpu.batch import Field as JField
    from spark_rapids_tpu.batch import Schema as JSchema
    theirs = JA.Multiply(jcol("a"), jcol("b")).bind(
        JSchema([JField("a", typed(JT, a)), JField("b", typed(JT, b))])
    ).dtype
    assert str(ours) == str(theirs)


def test_decimal_multiply_is_the_unscaled_product():
    t = pa.table({"a": _decimals([125, -300, 7], 2, 5),
                  "b": _decimals([40, 11, -1], 1, 4)})
    scan = InMemoryScanExec(t, device="cpu")
    out = collect(ProjectExec([TA.Multiply(col("a"), col("b"))], scan))
    assert out.schema.field(0).type == pa.decimal128(10, 3)
    assert out.column(0).to_pylist() == [
        D.Decimal("1.25") * D.Decimal("4.0"),
        D.Decimal("-3.00") * D.Decimal("1.1"),
        D.Decimal("0.07") * D.Decimal("-0.1")]
