"""The rest of the port's ``strings.py`` (InitCap, FormatNumber, ConcatWs,
Hex, Bin, Conv, FindInSet, Empty2Null) against the JAX package's, on the
CPU.

- ``tests/test_expressions_breadth.py``'s ``test_hex_bin_conv`` and
  ``test_concat_ws_skips_nulls``, ``tests/test_expressions_r4.py``'s
  ``test_find_in_set`` and ``test_empty2null`` and
  ``tests/test_typesig_params.py``'s FormatNumber and ConcatWs cases,
  each built with each package's classes and run through the JAX Session
  and the port's ``Session(device="cpu")`` (the same rows, exact, the
  same ``fell_back()``), then through the port's row interpreter, with
  the reference file's expected values.
- The uint64 edges (INT64_MIN, -1, 0, INT64_MAX) through Hex, Bin, Conv
  (bases 2, 36, -10) and FormatNumber, and FormatNumber over a decimal of
  scale above d.
- Each new expression's device column (payload, validity, lengths over
  the whole capacity) equal to the JAX package's.
- Where the JAX interpreter departs from the device, the port's handler
  follows the port's device: each such case with both outputs."""

import decimal
import importlib
import types as pytypes

import numpy as np
import pyarrow as pa
import pytest

from harness.asserts import assert_tables_equal

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

def _api(pkg):
    ns = {}
    for m in ("base", "arithmetic", "strings", "regex"):
        mod = importlib.import_module(f"{pkg}.expressions.{m}")
        ns.update({k: v for k, v in vars(mod).items()
                   if not k.startswith("_")})
    plan = importlib.import_module(f"{pkg}.plan")
    ns.update(table=plan.table, Session=plan.Session,
              T=importlib.import_module(f"{pkg}.types"),
              ExplainMode=importlib.import_module(
                  f"{pkg}.plan.overrides").ExplainMode)
    return pytypes.SimpleNamespace(**ns)


JAX = _api("spark_rapids_tpu")
PORT = _api("spark_rapids_tpu_torch")


def session(api, conf):
    return api.Session(conf, device="cpu") if api is PORT \
        else api.Session(conf)


def both(make, conf=None, ignore_order=False):
    """``make(api)`` through the JAX Session and the port's, then through
    the port's interpreter: equal rows and the same ``fell_back()``.
    Returns the port's rows."""
    conf = conf or {}
    jses = session(JAX, conf)
    want = jses.collect(make(JAX))
    ses = session(PORT, conf)
    got = ses.collect(make(PORT))
    assert got.schema.names == want.schema.names
    assert_tables_equal(got, want, ignore_order=ignore_order,
                        approx_float=False)
    assert ses.fell_back() == jses.fell_back()
    interpreted = session(PORT, {**conf, **ORACLE}).collect(make(PORT))
    assert_tables_equal(interpreted, got, ignore_order=ignore_order,
                        approx_float=False)
    return got


def _select(t, **exprs):
    return lambda a: a.table(t).select(
        *[f(a).alias(name) for name, f in exprs.items()])


def _values(t, name):
    return t.column(name).to_pylist()


# ---------------------------------------------------------------------------
# the reference files' cases
# ---------------------------------------------------------------------------

def test_hex_bin_conv():
    t = pa.table({"n": pa.array([255, -1, 0, None], pa.int64()),
                  "s": pa.array(["ff", "7b", "zz", "-10"])})
    out = both(_select(
        t, hx=lambda a: a.Hex(a.col("n")), bn=lambda a: a.Bin(a.col("n")),
        cv=lambda a: a.Conv(a.col("s"), a.lit(16), a.lit(10)),
        cvs=lambda a: a.Conv(a.col("s"), a.lit(16), a.lit(-10))))
    assert _values(out, "hx") == ["FF", "F" * 16, "0", None]
    assert _values(out, "bn") == ["11111111", "1" * 64, "0", None]
    assert _values(out, "cv") == ["255", "123", "0", str(2**64 - 16)]
    assert _values(out, "cvs") == ["255", "123", "0", "-16"]


def test_concat_ws_skips_nulls():
    t = pa.table({"a": pa.array(["x", None, "y"]),
                  "b": pa.array(["1", "2", None])})
    out = both(_select(t, c=lambda a: a.ConcatWs(
        a.lit(","), (a.col("a"), a.col("b")))))
    assert _values(out, "c") == ["x,1", "2", "y"]


def test_concat_ws_wide_separator_and_null_separator():
    t = pa.table({"a": pa.array(["x", None, "", None]),
                  "b": pa.array(["1", "2", None, None]),
                  "c": pa.array(["é", "", "z", None])})
    out = both(_select(
        t, w=lambda a: a.ConcatWs(a.lit(" / "),
                                  (a.col("a"), a.col("b"), a.col("c"))),
        one=lambda a: a.ConcatWs(a.lit("--"), (a.col("a"),)),
        e=lambda a: a.ConcatWs(a.lit(""), (a.col("a"), a.col("c"))),
        n=lambda a: a.ConcatWs(a.lit(None, a.T.string(4)),
                               (a.col("a"), a.col("b")))))
    assert _values(out, "w") == ["x / 1 / é", "2 / ", " / z", ""]
    assert _values(out, "one") == ["x", "", "", ""]
    assert _values(out, "n") == [None] * 4


def test_find_in_set():
    t = pa.table({
        "q": pa.array(["b", "c", "ab", "", "x,y", None, "b"]),
        "s": pa.array(["a,b,c", "a,b,c", "abc,ab", "a,,b", "x,y",
                       "a,b", None]),
    })
    out = both(_select(t, i=lambda a: a.FindInSet(a.col("q"), a.col("s"))))
    assert _values(out, "i") == [2, 3, 2, 2, 0, None, None]
    # end-of-set empty entries: '' in '' -> 1; '' in 'a,' -> 2
    t2 = pa.table({"q": pa.array(["", "", "", "b"]),
                   "s": pa.array(["", "a,", "a,b", "a,b,"])})
    out2 = both(_select(t2, i=lambda a: a.FindInSet(a.col("q"),
                                                    a.col("s"))))
    assert _values(out2, "i") == [1, 2, 0, 2]


def test_find_in_set_literal_set():
    t = pa.table({"q": pa.array(["SMALL", "PROMO", "TINY", "", None,
                                 "MEDIUM", "small"])})
    out = both(_select(t, i=lambda a: a.FindInSet(
        a.col("q"), a.lit("STANDARD,SMALL,MEDIUM,LARGE,ECONOMY,PROMO"))))
    assert _values(out, "i") == [2, 6, 0, 0, None, 3, 0]


def test_empty2null():
    t = pa.table({"s": pa.array(["a", "", None, "b"])})
    out = both(_select(t, x=lambda a: a.Empty2Null(a.col("s"))))
    assert _values(out, "x") == ["a", None, None, "b"]


TYPESIG = pa.table({
    "s": pa.array(["alpha", "beta,x", None, "d,e,f"]),
    "i": pa.array([1, 2, 3, None], type=pa.int32()),
})


def _refusals(api, df) -> list:
    text = session(api, {}).explain(df, api.ExplainMode.ALL)
    return [line.strip() for line in text.splitlines()
            if line.lstrip().startswith("!")]


def test_format_number_x_must_be_numeric():
    """tests/test_typesig_params.py: a string x tags the node off the
    device with the parameter's reason, in both packages."""
    for a in (PORT, JAX):
        lines = _refusals(a, a.table(TYPESIG).select(
            a.FormatNumber(a.col("s"), a.lit(2)).alias("r")))
        assert any("parameter 'x'" in line for line in lines), lines


def test_concat_ws_separator_must_be_literal():
    """tests/test_typesig_params.py: a column separator falls back with
    the parameter's reason and runs on the interpreter."""
    def q(a):
        return a.table(TYPESIG).select(
            a.ConcatWs(a.col("s"), (a.col("s"), a.col("s"))).alias("r"))
    got, want = _refusals(PORT, q(PORT)), _refusals(JAX, q(JAX))
    assert got == want
    assert any("parameter 'sep' must be a literal" in line for line in got)
    out = both(q)
    assert _values(out, "r") == ["alphaalphaalpha", "beta,xbeta,xbeta,x",
                                 None, "d,e,fd,e,fd,e,f"]


# ---------------------------------------------------------------------------
# the uint64 edges
# ---------------------------------------------------------------------------

LO, HI = -(2**63), 2**63 - 1
EDGES = pa.table({
    "v": pa.array([LO, -1, 0, HI, 1, -2**62, 2**32 + 5, None], pa.int64()),
    "s": pa.array([str(LO), "-1", "0", str(HI), "18446744073709551615",
                   "zZ", "1" * 60, None]),
})


def test_hex_bin_at_the_int64_edges():
    out = both(_select(EDGES, hx=lambda a: a.Hex(a.col("v")),
                       bn=lambda a: a.Bin(a.col("v"))))
    vals = EDGES.column("v").to_pylist()
    assert _values(out, "hx") == [
        None if v is None else format(v & (2**64 - 1), "X") for v in vals]
    assert _values(out, "bn") == [
        None if v is None else format(v & (2**64 - 1), "b") for v in vals]


CONV_BASES = [(10, 2), (10, 36), (10, -10), (36, 10)]


def _conv_edges(a):
    return a.table(EDGES).select(*[
        a.Conv(a.col("s"), a.lit(fb), a.lit(tb)).alias(f"c{k}")
        for k, (fb, tb) in enumerate(CONV_BASES)])


@pytest.fixture(scope="module")
def conv_edges_jax():
    """The JAX Session's answer for every base pair at once (one JAX
    compile)."""
    return session(JAX, {}).collect(_conv_edges(JAX))


@pytest.mark.parametrize("k", range(len(CONV_BASES)),
                         ids=[f"{fb}-{tb}" for fb, tb in CONV_BASES])
def test_conv_at_the_int64_edges(k, conv_edges_jax):
    fb, tb = CONV_BASES[k]
    want = _values(conv_edges_jax, f"c{k}")
    for conf in ({}, ORACLE):
        ses = session(PORT, conf)
        out = ses.collect(_conv_edges(PORT))
        assert ses.fell_back() == []
        assert _values(out, f"c{k}") == want, conf
    assert want[2] == "0" and want[-1] is None
    if (fb, tb) == (10, -10):
        assert want[:5] == [str(LO), "-1", "0", str(HI), "-1"]
    if (fb, tb) == (10, 2):
        assert want[1] == "1" * 64 and want[3] == "1" * 63


def test_conv_of_an_invalid_base_is_null():
    out = both(_select(EDGES, c=lambda a: a.Conv(a.col("s"), a.lit(1),
                                                 a.lit(10)),
                       d=lambda a: a.Conv(a.col("s"), a.lit(10),
                                          a.lit(37))))
    assert _values(out, "c") == _values(out, "d") == [None] * 8


def test_format_number_at_the_int64_edges():
    out = both(_select(EDGES, f0=lambda a: a.FormatNumber(a.col("v"), 0),
                       f3=lambda a: a.FormatNumber(a.col("v"), 3)))
    assert _values(out, "f0")[:4] == ["-9,223,372,036,854,775,808", "-1",
                                      "0", "9,223,372,036,854,775,807"]
    assert _values(out, "f3")[0] == "-9,223,372,036,854,775,808.000"


DECIMALS = pa.table({"d": pa.array(
    [decimal.Decimal(x) for x in ("1234567.8950", "-0.0050", "0.0150",
                                  "999999.9999", "-1.0050", "0")]
    + [None], pa.decimal128(14, 4))})


@pytest.mark.parametrize("d", [0, 2, 3, 4, 6])
def test_format_number_decimal_scale_above_d(d):
    """HALF_EVEN to d places where the scale is larger (4 > d)."""
    out = both(_select(DECIMALS, f=lambda a: a.FormatNumber(a.col("d"), d)))
    if d == 2:
        assert _values(out, "f") == ["1,234,567.90", "-0.00", "0.02",
                                     "1,000,000.00", "-1.00", "0.00", None]


def test_format_number_negative_and_wide_d_fall_back():
    for d in (-1, 10):
        out = both(_select(DECIMALS, f=lambda a: a.FormatNumber(a.col("d"),
                                                                d)))
        assert out.num_rows == DECIMALS.num_rows


# ---------------------------------------------------------------------------
# the device columns, whole
# ---------------------------------------------------------------------------

MIXED = pa.table({
    "s": pa.array(["hello world", "", None, "élan vital", "ab,cd", "a",
                   "  two  spaces", "-7f", "x" * 20, "b"] * 3),
    "v": pa.array([0, -1, None, LO, HI, 255, 7, -300, 12345678, 1] * 3,
                  pa.int64()),
    "dec": pa.array([decimal.Decimal(x) if x else None for x in
                     ("1.25", "-0.50", None, "123456.78", "0", "-99.99",
                      "5.05", "1000", "0.01", "-3.14")] * 3,
                    pa.decimal128(10, 2)),
})


def _column_cases():
    out = []
    for a in (PORT, JAX):
        s, v, dec = a.col("s"), a.col("v"), a.col("dec")
        out.append([
            ("initcap", a.InitCap(s)),
            ("format_number", a.FormatNumber(v, 2)),
            ("format_number_dec", a.FormatNumber(dec, 1)),
            ("concat_ws", a.ConcatWs(a.lit("/"), (s, s))),
            ("hex", a.Hex(v)), ("hex_str", a.Hex(s)), ("bin", a.Bin(v)),
            ("conv", a.Conv(s, a.lit(16), a.lit(-2))),
            ("find_in_set", a.FindInSet(a.lit("cd"), s)),
            ("empty2null", a.Empty2Null(s)),
            ("regexp_extract", a.RegexpExtract(s, r"([a-z]+) ([a-z]+)", 2)),
            ("regexp_replace", a.RegexpReplace(s, r"[aeiou]+", "<>")),
        ])
    return [(p[0], p[1], j[1]) for p, j in zip(*out)]


@pytest.mark.parametrize("name,pe,je", _column_cases(),
                         ids=[c[0] for c in _column_cases()])
def test_device_column_equals_jax(name, pe, je):
    """Payload, validity and lengths over the whole capacity (padding rows
    included), after each package's own batch upload."""
    from spark_rapids_tpu.batch import from_arrow as jfrom_arrow
    from spark_rapids_tpu_torch.batch import from_arrow
    import jax
    pb, ps = from_arrow(MIXED, device="cpu")
    jb, js = jfrom_arrow(MIXED)
    pc_ = pe.bind(ps).eval(pb)
    bound = je.bind(js)
    jc = jax.jit(lambda b: bound.eval(b))(jb)
    np.testing.assert_array_equal(pc_.validity.numpy(),
                                  np.asarray(jc.validity))
    np.testing.assert_array_equal(pc_.data.numpy(), np.asarray(jc.data))
    if jc.lengths is not None:
        np.testing.assert_array_equal(pc_.lengths.numpy(),
                                      np.asarray(jc.lengths))
    assert pc_.dtype.kind.name == jc.dtype.kind.name
    assert pc_.dtype.max_len == jc.dtype.max_len


# ---------------------------------------------------------------------------
# the handlers that follow the device where the JAX interpreter departs
# ---------------------------------------------------------------------------

def _three(make, t):
    """(port device, port interpreter, JAX device, JAX interpreter)
    values of column r."""
    def q(a):
        return a.table(t).select(make(a).alias("r"))
    return [_values(ses.collect(q(a)), "r") for a, ses in (
        (PORT, session(PORT, {})), (PORT, session(PORT, ORACLE)),
        (JAX, session(JAX, {})), (JAX, session(JAX, ORACLE)))]


def test_initcap_maps_ascii_letters_only_departure():
    """initcap over a non-ASCII letter: both devices map ASCII only
    ('élan' stays 'élan'); the JAX interpreter (and Spark) give 'Élan'.
    The port's interpreter follows its device."""
    t = pa.table({"s": pa.array(["élan vital", "ÉCOLE x"])})
    dev, interp, jdev, jinterp = _three(lambda a: a.InitCap(a.col("s")), t)
    assert dev == interp == jdev == ["élan Vital", "École X"]
    assert jinterp == ["Élan Vital", "École X"]


def test_conv_trims_nothing_departure():
    """conv(' 12', 10, 16): both devices read no digit at the space and
    give '0'; the JAX interpreter (and Spark) trim first and give 'C'."""
    t = pa.table({"s": pa.array([" 12", "12 "])})
    dev, interp, jdev, jinterp = _three(
        lambda a: a.Conv(a.col("s"), a.lit(10), a.lit(16)), t)
    assert dev == interp == jdev == ["0", "C"]
    assert jinterp == ["C", "C"]


def test_conv_wraps_past_64_bits_departure():
    """A positive input past 2^64 wraps mod 2^64 on both devices (the
    uint64 accumulation); the JAX interpreter keeps every digit. Spark
    saturates at 2^64 - 1; neither models that."""
    big = str(2**64 + 5)
    t = pa.table({"s": pa.array([big])})
    dev, interp, jdev, jinterp = _three(
        lambda a: a.Conv(a.col("s"), a.lit(10), a.lit(10)), t)
    assert dev == interp == jdev == ["5"]
    assert jinterp == [big]
