"""The port's regex DFA (``spark_rapids_tpu_torch/expressions/regex.py``)
against the JAX package's and Python's ``re``, on the CPU.

- Each case of ``tests/test_regex.py`` through the port's
  ``Session(device="cpu")``: RLIKE against ``re.search`` (Java's find()
  for the supported subset), LIKE against its regex under DOTALL, the
  planner differential, the fuzz, the UTF-8 character units; each also
  against the JAX Session on the same rows, booleans exact.
- The unsupported patterns raise ``RegexUnsupported`` in both packages,
  with the same message.
- ``compile_regex`` gives the JAX package's tables, byte classes,
  accepting sets, start state and anchors for every pattern above.
- ``sql.regexp.enabled=false`` sends RLIKE to the CPU as the JAX tagging
  does, and the interpreter's LIKE and RLIKE agree with the device."""

import random
import re

import numpy as np
import pyarrow as pa
import pytest

from spark_rapids_tpu.expressions import col as jcol
from spark_rapids_tpu.expressions import regex as jrx
from spark_rapids_tpu.plan import Session as JSession
from spark_rapids_tpu.plan import table as jtable
from spark_rapids_tpu_torch.expressions import col
from spark_rapids_tpu_torch.expressions import regex as rx
from spark_rapids_tpu_torch.plan import Session, table

from harness.asserts import assert_tables_equal, rows_of
from harness.data_gen import StringGen, gen_table

SUBJECTS = pa.table({"s": pa.array(
    ["abc", "aabbcc", "", "xyz", "a1b2c3", "hello world", "aaab",
     "ab", "ba", "cab", "abcabc", "  spaced  ", "123", "a_b", "A1",
     "zzzabczzz", "ab\ncd", None, "aab", "b"] * 5)})

PATTERNS = [
    "abc", "a+b", "a*b", "ab?c", "a.c", r"\d+", r"\w+\d", r"[a-c]+",
    "[^a-c]+", "a|b", "(?:ab)+", "^abc", "abc$", "^abc$", "^$",
    r"a{2,3}b", r"\s+", "a(?:b|c)d", "x?y?z", "(?:a|b)(?:b|c)",
]
LIKE_PATTERNS = ["a%", "%bc", "%b%", "a_c", "_", "%", "abc", "a\\%b"]
UNSUPPORTED = ["a(b", "a**", "(?=x)", "a{2,}", "a{1,99}", r"\b", "a$b",
               "(a$|b)", "a^b"]
FUZZ_PATTERNS = ["a+b*c", "(?:ab|ba)+", "a.b", "^a.*c$", "[ab]{1,3}c",
                 "c(?:a|b)?c", "a|bb|ccc"]
UTF8_PATTERNS = ["a.b", r"\D+", "[^a]b", "^.$", "^...$", r"a.{2}b", r"\S+",
                 "(?s).", r"\w+", "caf.", "[^x]+"]
UNICODE_SUBJECTS = pa.table({"s": pa.array(
    ["aéb", "ab", "aééb", "é", "café", "x中y", "\U0001F600ok", "a\nb",
     "", "naïve", "αβγ", "a中", None, "ASCII only"])})


def matches(t, make, jmake):
    """The column ``m`` of ``make(col('s'))`` over ``t`` through the
    port's Session, equal to the JAX Session's; returns it."""
    got = Session(device="cpu").collect(table(t).select(
        make(col("s")).alias("m")))
    want = JSession().collect(jtable(t).select(jmake(jcol("s")).alias("m")))
    assert_tables_equal(got, want, approx_float=False)
    return [r[0] for r in rows_of(got)]


@pytest.mark.parametrize("pat", PATTERNS)
def test_rlike_matches_python_re(pat):
    got = matches(SUBJECTS, lambda c: rx.RLike(c, pat),
                  lambda c: jrx.RLike(c, pat))
    exp = [None if s is None else (re.search(pat, s) is not None)
           for s in SUBJECTS.column("s").to_pylist()]
    assert got == exp, pat


@pytest.mark.parametrize("pat", LIKE_PATTERNS)
def test_like(pat):
    got = matches(SUBJECTS, lambda c: rx.Like(c, pat),
                  lambda c: jrx.Like(c, pat))
    exp = [None if s is None else
           (re.search(rx.like_to_regex(pat), s, re.DOTALL) is not None)
           for s in SUBJECTS.column("s").to_pylist()]
    assert got == exp, pat
    assert rx.like_to_regex(pat) == jrx.like_to_regex(pat)


def test_rlike_differential_through_planner():
    """The device against the interpreter in the port, and the JAX
    Session's rows."""
    t = gen_table([("s", StringGen(max_len=10))], n=300, seed=200)
    q = table(t).select(rx.RLike(col("s"), "[a-m]+[0-9]").alias("m"))
    got = Session(device="cpu").collect(q)
    oracle = Session({"spark.rapids.tpu.sql.enabled": False},
                     device="cpu").collect(q)
    assert_tables_equal(got, oracle, approx_float=False)
    matches(t, lambda c: rx.RLike(c, "[a-m]+[0-9]"),
            lambda c: jrx.RLike(c, "[a-m]+[0-9]"))


@pytest.mark.parametrize("pat", UNSUPPORTED)
def test_unsupported_patterns_raise(pat):
    with pytest.raises(rx.RegexUnsupported) as port:
        rx.compile_regex(pat)
    with pytest.raises(jrx.RegexUnsupported) as jax:
        jrx.compile_regex(pat)
    assert str(port.value) == str(jax.value)


def test_fuzz_against_python_re():
    rng = random.Random(7)
    subjects = ["".join(rng.choice("abc") for _ in range(rng.randint(0, 8)))
                for _ in range(200)]
    tbl = pa.table({"s": pa.array(subjects)})
    for pat in FUZZ_PATTERNS:
        got = matches(tbl, lambda c: rx.RLike(c, pat),
                      lambda c: jrx.RLike(c, pat))
        assert got == [re.search(pat, s) is not None for s in subjects], pat


@pytest.mark.parametrize("pat", UTF8_PATTERNS)
def test_rlike_utf8_char_units(pat):
    """'.' and negated classes take one multi-byte UTF-8 character as ONE
    unit; re.ASCII mirrors Java's ASCII-only \\w \\d \\s."""
    got = matches(UNICODE_SUBJECTS, lambda c: rx.RLike(c, pat),
                  lambda c: jrx.RLike(c, pat))
    exp = [None if s is None else (re.search(pat, s, re.ASCII) is not None)
           for s in UNICODE_SUBJECTS.column("s").to_pylist()]
    assert got == exp, pat


ALL_PATTERNS = sorted(set(PATTERNS + FUZZ_PATTERNS + UTF8_PATTERNS
                          + ["[a-m]+[0-9]"]
                          + [jrx.like_to_regex(p) for p in LIKE_PATTERNS]
                          + [jrx.like_to_regex("%Customer%Complaints%")]))


@pytest.mark.parametrize("pat", ALL_PATTERNS)
def test_compiled_tables_equal_jax(pat):
    got, want = rx.compile_regex(pat), jrx.compile_regex(pat)
    np.testing.assert_array_equal(got.table, want.table)
    np.testing.assert_array_equal(got.byte_class, want.byte_class)
    np.testing.assert_array_equal(got.accepting, want.accepting)
    assert got.table.dtype == want.table.dtype == np.int32
    assert (got.start_state, got.anchored_start, got.anchored_end,
            got.max_states) == (want.start_state, want.anchored_start,
                                want.anchored_end, want.max_states)


def test_regexp_disabled_falls_back_like_jax():
    """``sql.regexp.enabled=false`` refuses RLIKE on the device in both
    packages (LIKE is not gated), with the same explain."""
    conf = {"spark.rapids.tpu.sql.regexp.enabled": False}
    q = table(SUBJECTS).select(rx.RLike(col("s"), "a+b").alias("m"),
                               rx.Like(col("s"), "a%").alias("l"))
    jq = jtable(SUBJECTS).select(jrx.RLike(jcol("s"), "a+b").alias("m"),
                                 jrx.Like(jcol("s"), "a%").alias("l"))
    ses, jses = Session(conf, device="cpu"), JSession(conf)
    got, want = ses.collect(q), jses.collect(jq)
    assert_tables_equal(got, want, approx_float=False)
    assert ses.fell_back() == jses.fell_back() == ["CpuFallback[Project]"]
    assert ses.explain(q) == jses.explain(jq)
    assert "regex master switch" in ses.explain(q)
    on = Session(device="cpu")
    assert_tables_equal(on.collect(q), got, approx_float=False)
    assert on.fell_back() == []
