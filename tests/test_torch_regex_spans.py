"""The port's span programs (regexp_extract, regexp_replace) against the
JAX package's, on the CPU.

- ``compile_spans`` on each pattern of the slice's path and of the JAX
  package's span tests: the same segment sources and machines (tables,
  ``accepting``, ``start_state``, ``byte_class``), the same group bounds
  and anchors, and the same ``RegexUnsupported`` text for every pattern it
  refuses.
- ``first_match_bounds``, ``all_match_spans``, ``extract_group_device`` and
  ``replace_all_device`` equal to the JAX arrays over the whole capacity,
  on seeded random strings 8 and 40 bytes wide.
- The cases of ``tests/test_regex_spans.py`` that need no ARRAY, each
  built with each package's classes and run through the JAX Session and
  the port's ``Session(device="cpu")`` (the same rows, exact, and the same
  ``fell_back()`` with the same reasons), then through the port's row
  interpreter (``sql.enabled=false``).

Each case runs one JAX Session collect: its cost is the JAX compile."""

import importlib
import re
import types as pytypes

import numpy as np
import pyarrow as pa
import pytest

from spark_rapids_tpu.batch import from_arrow as jfrom_arrow
from spark_rapids_tpu.expressions import regex as JR
from spark_rapids_tpu_torch.batch import from_arrow
from spark_rapids_tpu_torch.expressions import regex as PR

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
    """Each package's expression classes by name, ``table`` and Session."""
    ns = {}
    for m in ("base", "arithmetic", "strings", "regex"):
        mod = importlib.import_module(f"{pkg}.expressions.{m}")
        ns.update({k: v for k, v in vars(mod).items()
                   if not k.startswith("_")})
    plan = importlib.import_module(f"{pkg}.plan")
    ns.update(table=plan.table, Session=plan.Session,
              ExplainMode=importlib.import_module(
                  f"{pkg}.plan.overrides").ExplainMode)
    return pytypes.SimpleNamespace(**ns)


JAX = _api("spark_rapids_tpu")
PORT = _api("spark_rapids_tpu_torch")


def session(api, conf):
    return api.Session(conf, device="cpu") if api is PORT \
        else api.Session(conf)


def refusals(api, conf, df) -> list:
    """The explain lines of the nodes tagging keeps off the device."""
    text = session(api, conf).explain(df, api.ExplainMode.ALL)
    return [line.strip() for line in text.splitlines()
            if line.lstrip().startswith("!")]


def both(make, conf=None, ignore_order=True):
    """``make(api)`` through the JAX Session and the port's, then through
    the port's interpreter: equal rows, the same ``fell_back()`` and the
    same refusal lines. Returns (the port's Session, its rows)."""
    conf = conf or {}
    jses = session(JAX, conf)
    want = jses.collect(make(JAX))
    ses = session(PORT, conf)
    got = ses.collect(make(PORT))
    assert got.schema.names == want.schema.names
    assert_tables_equal(got, want, ignore_order=ignore_order,
                        approx_float=False)
    assert ses.fell_back() == jses.fell_back()
    assert refusals(PORT, conf, make(PORT)) == \
        refusals(JAX, conf, make(JAX))
    interpreted = session(PORT, {**conf, **ORACLE}).collect(make(PORT))
    assert_tables_equal(interpreted, got, ignore_order=ignore_order,
                        approx_float=False)
    return ses, got


# ---------------------------------------------------------------------------
# the compiler
# ---------------------------------------------------------------------------

#: the slice's path, tests/test_regex_spans.py's and a few more shapes
SPAN_PATTERNS = [
    r"^([A-Z]+) ([A-Z]+) ([A-Z]+)$", r"^([A-Z]+) ", r" [A-Z]+$", r"[^0-9]+",
    r"Promo", r"[aeiou][aeiou]+", r"Customer([A-Za-z]*)Complaints",
    r"([0-9]+)", r"([a-z]+)([0-9]*)", r"(\w+)@(\w+)", r"[a-z]+",
    r"[0-9]+", r"\s+", r"[aeiou]", r"a*", r"(a)(b)", r"-", r" +",
    r"[-@ ]", r"(?:ab)+c", r"((a)(b))c", r"(?s)a.b", r"x{2,3}y?",
    r"[\]a]+", r"\.\d{1,2}$", r"[^a]", r"\d\D\w\W\s\S", r"[a-c]?x",
]
#: patterns compile_spans refuses, each with its text
REFUSED_PATTERNS = [
    r"(a|bb)x?", r"(ab)+", r"a+?", r"a$b", r"(?=a)", r"(?:a+)+",
    r"(?:a(b))*", r"", r"^", r"(ab", r"a{2,", r"[ab", "a\\",
    r"[aeiou]{2,}", r"a{1,9}", r"ab|cd", r"^$", r"é.",
]


def _machines_equal(got, want):
    np.testing.assert_array_equal(got.table, want.table)
    np.testing.assert_array_equal(got.accepting, want.accepting)
    np.testing.assert_array_equal(got.byte_class, want.byte_class)
    assert got.start_state == want.start_state
    assert (got.anchored_start, got.anchored_end) == \
        (want.anchored_start, want.anchored_end)


@pytest.mark.parametrize("pattern", SPAN_PATTERNS)
def test_compile_spans_equals_jax(pattern):
    got, want = PR.compile_spans(pattern), JR.compile_spans(pattern)
    assert [s.src for s in got.segments] == [s.src for s in want.segments]
    for g, w in zip(got.segments, want.segments):
        _machines_equal(g.compiled, w.compiled)
    assert len(got.suffixes) == len(want.suffixes)
    for g, w in zip(got.suffixes, want.suffixes):
        assert (g is None) == (w is None)
        if w is not None:
            _machines_equal(g, w)
    assert got.group_bounds == want.group_bounds
    assert got.n_groups == want.n_groups
    assert (got.anchored_start, got.anchored_end) == \
        (want.anchored_start, want.anchored_end)


@pytest.mark.parametrize("pattern", REFUSED_PATTERNS)
def test_compile_spans_refuses_as_jax(pattern):
    with pytest.raises(JR.RegexUnsupported) as want:
        JR.compile_spans(pattern)
    with pytest.raises(PR.RegexUnsupported, match=re.escape(
            str(want.value))) as got:
        PR.compile_spans(pattern)
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# the scans, whole
# ---------------------------------------------------------------------------

SCAN_PATTERNS = [
    r"[0-9]+", r"([a-z]+)([0-9]*)", r"a*", r"^([A-Z]+) ", r" [A-Z]+$",
    r"[aeiou][aeiou]+", r"b(?:ab)*", r"(\w+)-(\d+)", r"[^0-9]+",
    r"Ba(b*)A",
]
REPLACEMENTS = (b"", b"#", b"XY")


def _random_columns(width: int, seed: int):
    rng = np.random.default_rng(seed)
    alpha = np.array(list("abAB 0129-aeioé"))
    vals = ["".join(rng.choice(alpha, rng.integers(0, width // 2 + 1)))
            for _ in range(240)]
    vals[:3] = ["", None, "a" * (width // 2)]
    t = pa.table({"s": pa.array(vals)})
    jb, _ = jfrom_arrow(t, string_max_len=width)
    pb, _ = from_arrow(t, device="cpu", string_max_len=width)
    return jb.columns[0], pb.columns[0]


COLUMNS = {w: _random_columns(w, 60 + w) for w in (8, 40)}


def _scans(api, c, prog):
    """Every scan's output for ``prog`` over column ``c``, flat: the first
    match, all matches, each group, each replacement."""
    out = [*api.first_match_bounds(c, prog), *api.all_match_spans(c, prog)]
    for g in range(prog.n_groups + 1):
        out += api.extract_group_device(c, prog, g)
    for repl in REPLACEMENTS:
        out += api.replace_all_device(c, prog, repl)
    return out


@pytest.mark.parametrize("width", [8, 40])
@pytest.mark.parametrize("pattern", SCAN_PATTERNS)
def test_span_scans_equal_the_jax_arrays(pattern, width):
    """The JAX side runs as one jitted program (one compile per case)."""
    import jax
    jc, pc = COLUMNS[width]
    jp, pp = JR.compile_spans(pattern), PR.compile_spans(pattern)
    want = jax.jit(lambda c: _scans(JR, c, jp))(jc)
    got = _scans(PR, pc, pp)
    names = ["matched", "bounds", "sel_start", "match_end"] + [
        f"group {g} {part}" for g in range(pp.n_groups + 1)
        for part in ("bytes", "lengths")] + [
        f"replace {r!r} {part}" for r in REPLACEMENTS
        for part in ("bytes", "lengths")]
    assert len(got) == len(want) == len(names)
    for g, w, name in zip(got, want, names):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                      err_msg=name)


def test_scans_read_nothing_back_to_the_host(monkeypatch):
    """No loop of the scans converts a tensor to a Python value, so a fused
    stage can capture them."""
    import torch

    def refuse(*_):
        raise AssertionError("a host read in the span scans")
    monkeypatch.setattr(torch.Tensor, "item", refuse)
    monkeypatch.setattr(torch.Tensor, "__bool__", refuse)
    monkeypatch.setattr(torch.Tensor, "tolist", refuse)
    _, pc = COLUMNS[8]
    for pattern in (r"^([A-Z]+) ([A-Z]+)$", r"[aeiou][aeiou]+", r"a*"):
        prog = PR.compile_spans(pattern)
        PR.extract_group_device(pc, prog, 0)
        PR.replace_all_device(pc, prog, b"_")


# ---------------------------------------------------------------------------
# tests/test_regex_spans.py's cases that need no ARRAY
# ---------------------------------------------------------------------------

STRS = ["abc123def45", "", "no digits", "7", "a1b2c3", "x-42-y-7",
        "user@example.com", "  padded  ", "1,234.5", "aab", "ab-12",
        "UPPER lower MiXeD", "one two  three", "tab\tsep", "0.5",
        "12345.6789", "-42", None, "end9"]


def str_table():
    import decimal
    return pa.table({"s": pa.array(STRS, pa.string()),
                     "x": pa.array(
                         [None if s is None else len(s) * 7 - 20
                          for s in STRS], pa.int64()),
                     "dec": pa.array(
                         [None if s is None else
                          decimal.Decimal(len(s) * 997).scaleb(-2)
                          for s in STRS],
                         pa.decimal128(12, 2))})


def _select(t, *exprs):
    return lambda a: a.table(t).select(
        *[f(a).alias(name) for name, f in exprs])


CASES = {
    "regexp_extract_groups": _select(
        str_table(),
        ("num", lambda a: a.RegexpExtract(a.col("s"), r"([0-9]+)", 1)),
        ("tail", lambda a: a.RegexpExtract(a.col("s"), r"([a-z]+)([0-9]*)",
                                           2)),
        ("host", lambda a: a.RegexpExtract(a.col("s"), r"(\w+)@(\w+)", 2)),
        ("whole", lambda a: a.RegexpExtract(a.col("s"), r"[a-z]+", 0))),
    "regexp_replace": _select(
        str_table(),
        ("r1", lambda a: a.RegexpReplace(a.col("s"), r"[0-9]+", "#")),
        ("r2", lambda a: a.RegexpReplace(a.col("s"), r"\s+", "_")),
        ("r3", lambda a: a.RegexpReplace(a.col("s"), r"[aeiou]", ""))),
    "regexp_replace_empty_matches": _select(
        pa.table({"s": pa.array(["bc", "", "b"])}),
        ("r", lambda a: a.RegexpReplace(a.col("s"), r"a*", "X"))),
    "translate": _select(
        str_table(),
        ("t", lambda a: a.Translate(a.col("s"), "abc-", "xyz")),
        ("masked", lambda a: a.Translate(a.col("s"), "0123456789",
                                         "##########"))),
    "initcap": _select(str_table(),
                       ("ic", lambda a: a.InitCap(a.col("s")))),
    "format_number_long": _select(
        str_table(),
        ("f2", lambda a: a.FormatNumber(a.col("x") * a.lit(np.int64(98765)),
                                        2)),
        ("f0", lambda a: a.FormatNumber(a.col("x"), 0))),
    "format_number_decimal": _select(
        str_table(),
        ("d1", lambda a: a.FormatNumber(a.col("dec"), 1)),
        ("d4", lambda a: a.FormatNumber(a.col("dec"), 4))),
    "format_number_huge_long": _select(
        pa.table({"v": pa.array([9_100_000_000_000_000_000,
                                 -9_100_000_000_000_000_000, 2**63 - 1,
                                 -(2**63)], pa.int64())}),
        ("f", lambda a: a.FormatNumber(a.col("v"), 2))),
}

#: the cases that fall back, and the node each leaves to the CPU
FALLBACK_CASES = {
    "regexp_extract_unsupported_falls_back": _select(
        str_table(),
        ("n", lambda a: a.RegexpExtract(a.col("s"), r"(a|bb)x?", 1))),
    "format_number_double_falls_back": _select(
        pa.table({"f": pa.array([1.25, -0.004, 1e8])}),
        ("ff", lambda a: a.FormatNumber(a.col("f"), 2))),
    "quantified_capture_group_falls_back": _select(
        pa.table({"s": pa.array(["ababab", "xx", "ab"])}),
        ("g", lambda a: a.RegexpExtract(a.col("s"), r"(ab)+", 1))),
    "replace_backref_falls_back_and_expands": _select(
        pa.table({"s": pa.array(["ab", "xy ab"])}),
        ("r", lambda a: a.RegexpReplace(a.col("s"), r"(a)(b)", "$2$1"))),
}


@pytest.mark.parametrize("case", list(CASES))
def test_span_case_matches_jax(case):
    ses, _ = both(CASES[case])
    assert ses.fell_back() == []


@pytest.mark.parametrize("case", list(FALLBACK_CASES))
def test_fallback_case_matches_jax(case):
    ses, got = both(FALLBACK_CASES[case])
    assert ses.fell_back() == ["CpuFallback[Project]"]
    if case == "replace_backref_falls_back_and_expands":
        assert got.column("r").to_pylist() == ["ba", "xy ba"]


def test_regexp_extract_runs_on_the_device():
    ses, got = both(_select(str_table(), ("n", lambda a: a.RegexpExtract(
        a.col("s"), r"([0-9]+)", 1))), ignore_order=False)
    assert not ses.fell_back()
    assert got.column("n").to_pylist()[:4] == ["123", "", "", "7"]


def test_regex_master_switch_sends_them_to_the_cpu():
    """``sql.regexp.enabled=false`` keeps regexp_extract and
    regexp_replace off the device in both packages, for the same
    reason."""
    ses, _ = both(_select(
        str_table(),
        ("e", lambda a: a.RegexpExtract(a.col("s"), r"[0-9]+", 0)),
        ("r", lambda a: a.RegexpReplace(a.col("s"), r"[0-9]+", "#"))),
        {"spark.rapids.tpu.sql.regexp.enabled": False})
    assert ses.fell_back() == ["CpuFallback[Project]"]


def test_replacement_widens_the_string():
    """regexp_replace returns string(ml + R * (ml + 1)) in both packages:
    a replacement at every position of a full row fits."""
    t = pa.table({"s": pa.array(["a" * 10, "", None])})
    for a in (PORT, JAX):
        e = a.RegexpReplace(a.col("s"), r"x*", "--")
        df = a.table(t)
        ses = session(a, {})
        out = ses.collect(df.select(e.alias("r")))
        assert out.column("r").to_pylist() == ["--" + "a--" * 10, "--", None]
        bound = e.bind(df.plan.schema())
        assert bound.dtype.max_len == 64 + 2 * 65
