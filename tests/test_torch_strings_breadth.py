"""The port's string expressions against the JAX package's, on the CPU.

- Each case of ``tests/test_strings.py``, built with each package's
  classes on the same ``gen_table`` data and seed, through the port's
  ``Session(device="cpu")`` and the JAX Session under the same conf
  (``incompatibleOps`` on, so that ``Upper``/``Lower`` run on the device):
  the same rows, strings and integers exact, and the same ``fell_back()``.
- The same query through the port's row interpreter
  (``sql.enabled=false``): each new handler against the port's device path.
- ``Translate`` and ``SubstringIndex``, the two ``window_match`` callers
  the reference's file does not test, against the JAX package, and the
  columns each expression leaves (payload, validity, lengths over the
  whole capacity) equal to the JAX package's.
- The case tables equal to the JAX package's arrays, and the departures
  from Spark that the port keeps from the JAX device (ROADMAP Queue 3),
  each with both outputs.

Each case runs one JAX Session collect: its cost is the JAX compile."""

import importlib
import types as pytypes

import numpy as np
import pyarrow as pa
import pytest

from harness.asserts import assert_tables_equal
from harness.data_gen import IntegerGen, StringGen, gen_table

CONF = {"spark.rapids.tpu.sql.incompatibleOps.enabled": True}
ORACLE = {**CONF, "spark.rapids.tpu.sql.enabled": False}


def _api(pkg):
    """Each package's expression classes and helpers by name, its plan
    builders, Session and operators."""
    ns = {}
    for m in ("base", "arithmetic", "strings", "regex", "aggregates"):
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


def session(api, conf):
    return api.Session(conf, device="cpu") if api is PORT \
        else api.Session(conf)


def both(make, conf=CONF, ignore_order=True):
    """``make(api)`` through the JAX Session and the port's, then through
    the port's interpreter: equal rows (no float column is compared
    approximately), the same ``fell_back()``. Returns the port's rows."""
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


ST = gen_table([("s", StringGen(max_len=12)),
                ("t", StringGen(max_len=6, charset="abcAB  ")),
                ("n", IntegerGen(min_val=-5, max_val=15))], n=400, seed=100)

UNI = pa.table({"u": pa.array(["héllo", "wörld", "日本語テキスト", "", None,
                               "mixed日本", "café au lait", "ASCII only",
                               "ñandú", "ß"] * 10)})

REV = pa.table({"s": pa.array(["hello", "", "ab", "héllo", "日本語", None])})
ASC = pa.table({"s": pa.array(["Abc", "", "é", "1x", None])})
CHR = pa.table({"n": pa.array([65, 97, 0, 255, 256 + 66, -3, None],
                              pa.int64())})
OCT = pa.table({"s": pa.array(["abc", "", "héllo", "日本語", None])})
LEV = pa.table({"a": pa.array(["kitten", "flaw", "", "abc", "same", None]),
                "b": pa.array(["sitting", "lawn", "abc", "", "same", "x"])})
LEV_RANDOM = gen_table([("a", StringGen(min_len=0, max_len=12)),
                        ("b", StringGen(min_len=0, max_len=12))], n=200,
                       seed=190)
SDX = pa.table({"s": pa.array(
    ["Robert", "Rupert", "Ashcraft", "Ashcroft", "Tymczak", "Pfister",
     "Honeyman", "", "123", "a", None])})


def _sel(t, *exprs):
    return lambda a: a.table(t).select(
        *[f(a).alias(f"c{i}") for i, f in enumerate(exprs)])


#: the select-only cases of tests/test_strings.py, by its test names
SELECT_CASES = {
    "length_ascii": _sel(ST, lambda a: a.length(a.col("s"))),
    "length_unicode_codepoints": _sel(UNI, lambda a: a.length(a.col("u"))),
    "upper_lower": _sel(ST, lambda a: a.upper(a.col("s")),
                        lambda a: a.lower(a.col("s"))),
    **{f"substring[{pos},{ln}]": _sel(
        ST, lambda a, pos=pos, ln=ln: a.substring(a.col("s"), pos, ln))
       for pos, ln in [(1, 3), (3, 100), (-4, 2), (0, 2), (2, None),
                       (-100, 5)]},
    "substring_unicode": _sel(UNI, lambda a: a.substring(a.col("u"), 2, 3)),
    "concat": _sel(ST, lambda a: a.concat(a.col("s"), a.lit("-"),
                                          a.col("t"))),
    **{f"contains_starts_ends[{pat}]": _sel(
        ST, lambda a, pat=pat: a.contains(a.col("t"), pat),
        lambda a, pat=pat: a.startswith(a.col("t"), pat),
        lambda a, pat=pat: a.endswith(a.col("t"), pat))
       for pat in ["ab", "", "zz9", "a"]},
    "locate": _sel(ST, lambda a: a.StringLocate(a.col("t"), a.lit("b"))),
    **{f"trim[{side}]": _sel(
        ST, lambda a, side=side: a.StringTrim(a.col("t"), side))
       for side in ["both", "leading", "trailing"]},
    **{f"pad[{left}]": _sel(
        ST, lambda a, left=left: a.StringPad(a.col("t"), a.lit(8),
                                             a.lit("*"), left))
       for left in [True, False]},
    "repeat": _sel(ST, lambda a: a.StringRepeat(a.col("t"), a.lit(3))),
    "replace": _sel(ST, lambda a: a.StringReplace(a.col("t"), a.lit("ab"),
                                                  a.lit("XY"))),
    "replace_shrinking": _sel(ST, lambda a: a.StringReplace(
        a.col("t"), a.lit("a"), a.lit(""))),
    "reverse_ascii_and_unicode": _sel(REV, lambda a: a.Reverse(a.col("s"))),
    "ascii_fn": _sel(ASC, lambda a: a.Ascii(a.col("s"))),
    "chr_fn": _sel(CHR, lambda a: a.Chr(a.col("n"))),
    "octet_bit_length": _sel(OCT, lambda a: a.OctetLength(a.col("s")),
                             lambda a: a.OctetLength(a.col("s"), bits=True)),
    "levenshtein": _sel(LEV, lambda a: a.Levenshtein(a.col("a"),
                                                     a.col("b"))),
    "levenshtein_random_differential": _sel(
        LEV_RANDOM, lambda a: a.Levenshtein(a.col("a"), a.col("b"))),
    "soundex": _sel(SDX, lambda a: a.Soundex(a.col("s"))),
}


@pytest.mark.parametrize("case", list(SELECT_CASES))
def test_strings_case_matches_jax(case):
    both(SELECT_CASES[case])


def test_string_filter_pipeline():
    both(lambda a: a.table(ST)
         .where(a.contains(a.col("s"), "a"))
         .select(a.upper(a.col("s")).alias("u"), a.col("n")))


def test_soundex_known_codes():
    """Published anchors (US-census soundex, Spark's variant where the
    first letter's own code seeds the duplicate tracker)."""
    t = pa.table({"s": pa.array(["Robert", "Rupert", "Ashcraft", "Tymczak",
                                 "Pfister", "Honeyman", "Jackson"])})
    got = both(lambda a: a.table(t).select(a.Soundex(a.col("s")).alias("x")),
               ignore_order=False)
    assert got.column("x").to_pylist() == \
        ["R163", "R163", "A261", "T522", "P236", "H555", "J250"]


def test_soundex_non_letter_resets_tracker():
    t = pa.table({"s": pa.array(["B-b", "Mc-Carthy"])})
    got = both(lambda a: a.table(t).select(a.Soundex(a.col("s")).alias("x")),
               ignore_order=False)
    assert got.column("x").to_pylist() == ["B100", "M226"]


def test_ascii_supplementary_plane_returns_surrogate():
    t = pa.table({"s": pa.array(["\U0001F600x", "A"])})
    for conf in ({}, {"spark.rapids.tpu.sql.enabled": False}):
        got = both(lambda a: a.table(t).select(
            a.Ascii(a.col("s")).alias("a")), conf, ignore_order=False)
        assert got.column("a").to_pylist() == [0xD83D, 65], conf


def test_groupby_null_producing_key_expression():
    """A computed key with runtime nulls (divide by zero) keeps its null
    sort lane: null and valid rows with equal payloads form two groups."""
    t = pa.table({"a": pa.array([10, 10, 10, 7, 7, 10], pa.int64()),
                  "b": pa.array([0, 2, 0, 7, 7, 2], pa.int64())})
    got = both(lambda a: a.table(t).group_by(
        (a.col("a") / a.col("b")).alias("k")).agg(a.Count().alias("c")))
    assert got.num_rows == 3     # null, 5.0 and 1.0, two rows each
    assert got.column("c").to_pylist() == [2, 2, 2]


CASE_VALUES = [
    "აბგ",          # Georgian mkhedruli -> mtavruli
    "ａｂｃ",          # full-width latin a b c
    "ᏸᏹ",                # Cherokee lowercase
    "ἀἁ",                # Greek Extended
    "бдα",          # 2-byte Cyrillic/Greek
    "mixed აａZ x",
    "ß straße",
]


def test_case_mapping_3byte_scripts():
    """3-byte cased scripts map; the operators alone, as the reference's
    case runs them, in both packages."""
    t = pa.table({"s": pa.array(CASE_VALUES)})
    outs = []
    for a in (PORT, JAX):
        kw = {"device": "cpu"} if a is PORT else {}
        outs.append(a.collect(a.ProjectExec(
            [a.Upper(a.col("s")).alias("u"), a.Lower(a.col("s")).alias("l")],
            a.InMemoryScanExec(t, **kw))))
    assert outs[0].equals(outs[1])
    for v, u, low in zip(CASE_VALUES, outs[0].column("u").to_pylist(),
                         outs[0].column("l").to_pylist()):
        exp_u = "".join(c.upper() if len(c.upper()) == 1 else c for c in v)
        exp_l = "".join(c.lower() if len(c.lower()) == 1 else c for c in v)
        assert u == exp_u, (v, u, exp_u)
        assert low == exp_l, (v, low, exp_l)


def test_case_tables_equal_the_jax_arrays():
    from spark_rapids_tpu.expressions import strings as jstr
    from spark_rapids_tpu_torch.expressions import strings as tstr
    for name in ("_UPPER_2B", "_LOWER_2B", "_UPPER_3B", "_LOWER_3B"):
        np.testing.assert_array_equal(getattr(tstr, name),
                                      getattr(jstr, name))
    assert tstr._UPPER_2B.shape == (2048,)
    assert tstr._UPPER_3B.shape == (65536,)


def test_upper_is_incompat_in_both():
    """Without incompatibleOps the case mapping runs on the CPU in both
    packages, for the same reason."""
    got = both(lambda a: a.table(ST).select(
        a.upper(a.col("s")).alias("u")), {})
    assert got.num_rows == ST.num_rows
    ses = PORT.Session({}, device="cpu")
    ses.collect(PORT.table(ST).select(PORT.upper(PORT.col("s")).alias("u")))
    assert ses.fell_back() == ["CpuFallback[Project]"]


# ---------------------------------------------------------------------------
# Translate, SubstringIndex
# ---------------------------------------------------------------------------

WORDS = gen_table([("w", StringGen(max_len=14, charset="ab.c-d."))],
                  n=300, seed=77)
DELIMS = pa.table({"w": pa.array(
    ["a.b.c", "a..b", ".lead", "trail.", "", None, "no delims", "x.y",
     "é.ü.日", "a-b-c-d", "...", "日本.語"] * 3)})


@pytest.mark.parametrize("frm,to", [("abc", "xyz"), ("ab", "x"),
                                    ("aab", "xyz"), (".", ""),
                                    ("", "q"), ("d-", "D_")])
def test_translate_matches_jax(frm, to):
    both(lambda a: a.table(WORDS).select(
        a.Translate(a.col("w"), frm, to).alias("t")))


def test_translate_non_ascii_mapping_falls_back_in_both():
    def q(a):
        return a.table(DELIMS).select(
            a.Translate(a.col("w"), "é", "e").alias("t"))
    both(q)
    ses = PORT.Session(CONF, device="cpu")
    ses.collect(q(PORT))
    assert ses.fell_back() == ["CpuFallback[Project]"]


@pytest.mark.parametrize("delim,count", [(".", 1), (".", 2), (".", -1),
                                         (".", -2), (".", 0), ("-", 3),
                                         ("..", 1), ("", 2), (".", 9),
                                         (".", -9)])
def test_substring_index_matches_jax(delim, count):
    for t in (WORDS, DELIMS):
        both(lambda a: a.table(t).select(a.SubstringIndex(
            a.col("w"), a.lit(delim), a.lit(count)).alias("x")))


def test_substring_index_self_overlapping_delimiter_departure():
    """ROADMAP Queue 3: the device counts every start of a delimiter that
    overlaps itself ('aa' in 'aaa' twice), as the JAX device does; Spark
    and the interpreters split without overlap. Both outputs pinned."""
    t = pa.table({"w": pa.array(["xaaay", "aaaa"])})

    def q(a):
        return a.table(t).select(a.SubstringIndex(
            a.col("w"), a.lit("aa"), a.lit(2)).alias("x"))
    dev = PORT.Session(CONF, device="cpu").collect(q(PORT))
    jdev = JAX.Session(CONF).collect(q(JAX))
    cpu = PORT.Session(ORACLE, device="cpu").collect(q(PORT))
    jcpu = JAX.Session(ORACLE).collect(q(JAX))
    assert dev.column("x").to_pylist() == \
        jdev.column("x").to_pylist() == ["xa", "a"]
    assert cpu.column("x").to_pylist() == \
        jcpu.column("x").to_pylist() == ["xaaay", "aa"]


def test_replace_truncates_at_its_width_departure():
    """ROADMAP Queue 3: replace's output is string(max(2 * max_len, 64))
    and a longer result is cut there, in both devices; Spark and the
    interpreters keep it whole."""
    t = pa.table({"w": pa.array(["a" * 60])})     # a 64-byte scan

    def q(a):
        return a.table(t).select(a.StringReplace(
            a.col("w"), a.lit("a"), a.lit("bcd")).alias("x"))
    dev = PORT.Session(CONF, device="cpu").collect(q(PORT))
    jdev = JAX.Session(CONF).collect(q(JAX))
    cpu = PORT.Session(ORACLE, device="cpu").collect(q(PORT))
    assert dev.column("x").to_pylist() == jdev.column("x").to_pylist() \
        == [("bcd" * 60)[:128]]
    assert cpu.column("x").to_pylist() == ["bcd" * 60]


def test_upper_leaves_sharp_s_departure():
    """ROADMAP Queue 3: upper('ß') is 'ß' on both devices and in both
    interpreters (the simple mapping); Spark gives 'SS'."""
    t = pa.table({"w": pa.array(["straße"])})

    def q(a):
        return a.table(t).select(a.upper(a.col("w")).alias("x"))
    dev = PORT.Session(CONF, device="cpu").collect(q(PORT))
    jdev = JAX.Session(CONF).collect(q(JAX))
    assert dev.column("x").to_pylist() == jdev.column("x").to_pylist() \
        == ["STRAßE"]
    assert "straße".upper() == "STRASSE"


# ---------------------------------------------------------------------------
# the device columns, whole
# ---------------------------------------------------------------------------

def _column_cases():
    """(name, port expression, JAX expression) over MIXED's column s."""
    out = []
    for a in (PORT, JAX):
        s = a.col("s")
        out.append([
            ("length", a.length(s)), ("upper", a.upper(s)),
            ("lower", a.lower(s)), ("substring", a.substring(s, -3, 2)),
            ("concat", a.concat(s, a.lit("|"), s)),
            ("locate", a.StringLocate(s, a.lit("é"))),
            ("trim", a.StringTrim(s, "both")),
            ("lpad", a.StringPad(s, a.lit(9), a.lit("<>"), True)),
            ("repeat", a.StringRepeat(s, a.lit(2))),
            ("replace", a.StringReplace(s, a.lit("é"), a.lit("E!"))),
            ("translate", a.Translate(s, "ae ", "AE")),
            ("reverse", a.Reverse(s)), ("ascii", a.Ascii(s)),
            ("octet", a.OctetLength(s)), ("soundex", a.Soundex(s)),
            ("substring_index", a.SubstringIndex(s, a.lit(" "), a.lit(-1))),
            ("levenshtein", a.Levenshtein(s, a.lit("café"))),
            ("like", a.Like(s, "%a_%")), ("rlike", a.RLike(s, "^[a-c]+.")),
        ])
    return [(p[0], p[1], j[1]) for p, j in zip(*out)]


MIXED = pa.table({"s": pa.array(
    ["  café au lait ", "", None, "ÉCOLE élève", "abc", "Straße", "日本語 é",
     "\U0001F600 é", "aéb", "zz top"] * 7)})


@pytest.mark.parametrize("name,pe,je", _column_cases(),
                         ids=[c[0] for c in _column_cases()])
def test_device_column_equals_jax(name, pe, je):
    """Payload, validity and lengths over the whole capacity (padding rows
    included), after the port's and the JAX package's own batch upload."""
    from spark_rapids_tpu.batch import from_arrow as jfrom_arrow
    from spark_rapids_tpu_torch.batch import from_arrow
    pb, ps = from_arrow(MIXED, device="cpu")
    jb, js = jfrom_arrow(MIXED)
    pc_ = pe.bind(ps).eval(pb)
    jc = je.bind(js).eval(jb)
    np.testing.assert_array_equal(pc_.validity.numpy(),
                                  np.asarray(jc.validity))
    np.testing.assert_array_equal(pc_.data.numpy(), np.asarray(jc.data))
    if jc.lengths is not None:
        np.testing.assert_array_equal(pc_.lengths.numpy(),
                                      np.asarray(jc.lengths))
    assert pc_.dtype.kind.name == jc.dtype.kind.name
    assert pc_.dtype.max_len == jc.dtype.max_len
