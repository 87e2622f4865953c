"""The port's string slice against the JAX package, exactly: the string
batch (Arrow in and out, the padded matrix and lengths), the substring
search kernel's plain version against ``pallas_window_match`` in interpret
mode and against the rolled-compare ``_window_match``, the string
predicates, comparisons and three-valued logic, string hashing and hash
partitioning, and sorting on string keys. The CUDA kernel itself is held
against its plain version on a card."""

import jax.numpy as jnp
import numpy as np
import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu import exec as jexec
from spark_rapids_tpu import types as JT
from spark_rapids_tpu.batch import StringOverflowError as JOverflow
from spark_rapids_tpu.batch import column_from_arrow as jax_column_from_arrow
from spark_rapids_tpu.batch import from_arrow as jax_from_arrow
from spark_rapids_tpu.exec.sort import SortOrder as JSortOrder
from spark_rapids_tpu.expressions import boolean as jbool
from spark_rapids_tpu.expressions import col as jcol
from spark_rapids_tpu.expressions import comparison as jcmp
from spark_rapids_tpu.expressions import hashing as jh
from spark_rapids_tpu.expressions import lit as jlit
from spark_rapids_tpu.expressions import strings as jstr
from spark_rapids_tpu.kernels.string_search import (pallas_window_match,
                                                    supports)
from spark_rapids_tpu_torch import batch as tb
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.exec import (InMemoryScanExec, SortExec, asc,
                                         collect, desc)
from spark_rapids_tpu_torch.expressions import (And, EqualTo, In,
                                                LessThanOrEqual, Not, Or,
                                                col, lit)
from spark_rapids_tpu_torch.expressions import hashing as th
from spark_rapids_tpu_torch.expressions import strings as tstr
from spark_rapids_tpu_torch.kernels.string_search import (
    window_match, window_match_plain)

from harness.asserts import assert_tables_equal
from harness.murmur3_oracle import hash_bytes


def _same_column(pc, jc):
    """Payload, validity and lengths equal over the whole capacity."""
    np.testing.assert_array_equal(pc.validity.numpy(), np.asarray(jc.validity))
    np.testing.assert_array_equal(pc.data.numpy(), np.asarray(jc.data))
    if jc.lengths is not None:
        np.testing.assert_array_equal(pc.lengths.numpy(),
                                      np.asarray(jc.lengths))


# ---------------------------------------------------------------------------
# Batch
# ---------------------------------------------------------------------------

STRING_CASES = {
    "utf8": pa.array(["héllo", "日本語テキ", "ünï", "a€b", "🙂x"]),
    "empty": pa.array(["", "x", "", "", "yz"]),
    "nulls": pa.array([None, "abc", None, "", "d"]),
    "sliced": pa.array(["skip", "me", "kept", None, "tail", "x" * 16])
    .slice(2, 4),
    "at_max_len": pa.array(["x" * 16, "é" * 8, "", "0123456789abcdef"]),
    "chunked": pa.chunked_array([["ab", None], ["cde", "f" * 16]]),
    "large_string": pa.array(["ab", None, "c" * 16], pa.large_string()),
}


@pytest.mark.parametrize("case", list(STRING_CASES))
def test_string_column_matches_jax_and_round_trips(case):
    arr = STRING_CASES[case]
    t = pa.table({"s": arr})
    pb, ps = tb.from_arrow(t, string_max_len=16, device="cpu")
    jb, _ = jax_from_arrow(t, string_max_len=16)
    assert ps[0].dtype == T.string(16)
    assert pb.capacity == jb.capacity
    _same_column(pb.columns[0], jb.columns[0])
    out = tb.to_arrow(pb, ps)
    assert out.column(0).type == pa.string()
    expected = arr.combine_chunks() if isinstance(arr, pa.ChunkedArray) \
        else arr
    assert out.column(0).to_pylist() == expected.to_pylist()


def test_column_from_arrow_at_a_larger_capacity_matches_jax():
    arr = pa.array(["abc", None, "é" * 20, "", "z"] * 7)
    pc = tb.column_from_arrow(arr, T.string(40), 256, torch.device("cpu"))
    jc = jax_column_from_arrow(arr, JT.string(40), 256)
    _same_column(pc, jc)


def test_string_overflow_raises_in_both_packages():
    t = pa.table({"s": pa.array(["short", "x" * 17])})
    with pytest.raises(tb.StringOverflowError):
        tb.from_arrow(t, string_max_len=16, device="cpu")
    with pytest.raises(JOverflow):
        jax_from_arrow(t, string_max_len=16)


def test_matrix_build_matches_the_host_gather():
    """The device-side build from offsets equals a host build row by row,
    on random UTF-8 bytes including 0x00 inside a value."""
    rng = np.random.default_rng(4)
    values = [bytes(rng.integers(0, 256, int(k), dtype=np.uint8))
              for k in rng.integers(0, 33, 300)]
    arr = pa.array(values, pa.binary()).cast(pa.string(), safe=False)
    col = tb.column_from_arrow(arr, T.string(32), 512, torch.device("cpu"))
    host = np.zeros((512, 32), np.uint8)
    for i, v in enumerate(values):
        host[i, :len(v)] = np.frombuffer(v, np.uint8)
    np.testing.assert_array_equal(col.data.numpy(), host)
    np.testing.assert_array_equal(col.lengths.numpy()[:300],
                                  [len(v) for v in values])


def test_batch_from_numpy_carries_a_jax_string_batch():
    t = pa.table({"s": pa.array(["ab", None, "cde", ""]),
                  "i": pa.array([1, 2, None, 4], pa.int32())})
    jb, js = jax_from_arrow(t)
    _, ps = tb.from_arrow(t, device="cpu")
    cols = [(np.asarray(c.data), np.asarray(c.validity))
            + ((np.asarray(c.lengths),) if c.lengths is not None else ())
            for c in jb.columns]
    pb = tb.batch_from_numpy(cols, int(jb.num_rows), ps, device="cpu")
    assert tb.to_arrow(pb, ps).equals(jexec.collect(
        jexec.InMemoryScanExec(t)))


def test_dictionary_arrays_name_their_slice():
    """A dictionary string array comes up dict-encoded in both packages
    (``dictenc.py``), with the same sorted dictionary and codes, and
    collects to the same rows."""
    t = pa.table({"s": pa.array(["b", "a", "b", "", "a", "b"])
                  .dictionary_encode()})
    got, schema = tb.from_arrow(t, device="cpu")
    want, jschema = jax_from_arrow(t)
    g, w = got.columns[0], want.columns[0]
    assert g.is_dict and w.is_dict
    for a, b in ((g.data, w.data), (g.dict_data, w.dict_data),
                 (g.dict_lengths, w.dict_lengths), (g.validity, w.validity)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert tb.to_arrow(got, schema).column(0).to_pylist() == \
        ["b", "a", "b", "", "a", "b"]


def test_empty_string_batch():
    schema = tb.Schema([tb.Field("s", T.string(10))])
    b = tb.empty_batch(schema, torch.device("cpu"), capacity=128)
    assert b.columns[0].data.shape == (128, 10)
    assert tb.to_arrow(b, schema).column(0).to_pylist() == []


# ---------------------------------------------------------------------------
# The substring-search kernel's plain version
# ---------------------------------------------------------------------------

def _matrix(rng, n, ml, alphabet=(97, 98, 99, 100)):
    data = np.asarray(alphabet, np.uint8)[rng.integers(0, len(alphabet),
                                                       (n, ml))]
    lengths = rng.integers(0, ml + 1, n).astype(np.int32)
    data[np.arange(ml)[None, :] >= lengths[:, None]] = 0
    return data, lengths


def _pattern(k, ml):
    """A repeated-byte pattern for the longest k, ab-runs otherwise."""
    return b"a" * k if k == ml else (b"ab" * k)[:k]


@pytest.mark.parametrize("ml", [64, 32, 16])
@pytest.mark.parametrize("k", [1, 2, 5, 14, 15, "max_len"])
def test_plain_matches_pallas_window_match(ml, k):
    k = ml if k == "max_len" else k
    rng = np.random.default_rng(ml * 100 + k)
    n = (128 // ml) * 256
    data, lengths = _matrix(rng, n, ml, alphabet=(97, 98))
    lengths[:4] = ml
    # runs of one byte, then "abab...", so that every pattern matches
    for rows, fill in ((slice(0, n // 8), b"a" * ml),
                       (slice(n // 8, n // 4), (b"ab" * ml)[:ml])):
        data[rows] = np.where(np.arange(ml)[None, :] < lengths[rows, None],
                              np.frombuffer(fill, np.uint8)[None, :], 0)
    pat = _pattern(k, ml)
    assert supports(n, ml, pat)
    got = window_match_plain(torch.from_numpy(data),
                             torch.from_numpy(lengths), pat).numpy()
    exp = np.asarray(pallas_window_match(jnp.asarray(data),
                                         jnp.asarray(lengths), pat,
                                         interpret=True))
    np.testing.assert_array_equal(got, exp)
    assert got.any()


@pytest.mark.parametrize("ml", [25, 10])
@pytest.mark.parametrize("k", [0, 1, 3, "max_len", "max_len+1"])
def test_window_match_matches_jax_where_pallas_cannot_run(ml, k):
    """max_len that does not divide 128, and the k the kernel never sees
    (0 and max_len + 1), against the JAX package's ``_window_match``."""
    k = {"max_len": ml, "max_len+1": ml + 1}.get(k, k)
    rng = np.random.default_rng(ml + 7 * k)
    data, lengths = _matrix(rng, 700, ml, alphabet=(97, 98, 0xC3, 0x80))
    pat = bytes([97, 0xC3] * k)[:k]
    got = tstr._window_match(torch.from_numpy(data),
                             torch.from_numpy(lengths), pat).numpy()
    exp = np.asarray(jstr._window_match(jnp.asarray(data),
                                        jnp.asarray(lengths), pat))
    np.testing.assert_array_equal(got, exp)


def test_bytes_at_or_above_0x80_compare_unsigned():
    data = torch.tensor([[0xC3, 0xA9, 0x41, 0], [0x41, 0xC3, 0xA9, 0xFF]],
                        dtype=torch.uint8)
    lengths = torch.tensor([3, 4], dtype=torch.int32)
    m = window_match(data, lengths, b"\xc3\xa9")
    assert m.tolist() == [[True, False, False, False],
                          [False, True, False, False]]
    assert window_match(data, lengths, b"\xff")[1, 3]


def test_wrapper_rejects_bad_inputs():
    d = torch.zeros((4, 8), dtype=torch.uint8)
    n = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="1 to max_len"):
        window_match(d, n, b"")
    with pytest.raises(ValueError, match="1 to max_len"):
        window_match(d, n, b"x" * 9)
    with pytest.raises(ValueError, match="lengths"):
        window_match(d, n.long(), b"x")
    with pytest.raises(ValueError, match="contiguous"):
        window_match(d.t(), n, b"x")
    with pytest.raises(ValueError, match="rows"):
        window_match(d, n[:3], b"x")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode "
                    "(chip_smoke.py holds it against the plain version)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n,ml", [(1, 64), (1_000_003, 25), (1 << 20, 64),
                                  (4099, 10)])
def test_cuda_kernel_matches_plain(cuda_device, n, ml):
    rng = np.random.default_rng(n)
    data, lengths = _matrix(rng, n, ml, alphabet=(97, 98, 0xC3))
    d = torch.from_numpy(data).to(cuda_device)
    ln = torch.from_numpy(lengths).to(cuda_device)
    for k in sorted({1, 5, 15, ml} & set(range(1, ml + 1))):
        pat = _pattern(k, ml)
        before = window_match.launches
        got = window_match(d, ln, pat)
        torch.cuda.synchronize()
        assert window_match.launches == before + 1
        assert torch.equal(got, window_match_plain(d, ln, pat))


@pytest.mark.cuda
def test_cuda_kernel_takes_unaligned_view(cuda_device):
    """A contiguous view that starts one 25-byte row in is not 16-byte
    aligned; the wrapper copies it before the launch."""
    rng = np.random.default_rng(25)
    data, lengths = _matrix(rng, 10_001, 25, alphabet=(97, 98, 0xC3))
    d = torch.from_numpy(data).to(cuda_device)[1:]
    ln = torch.from_numpy(lengths).to(cuda_device)[1:]
    assert d.is_contiguous() and d.data_ptr() % 16
    for k in (1, 5, 25):
        pat = _pattern(k, 25)
        assert torch.equal(window_match(d, ln, pat),
                           window_match_plain(d, ln, pat))


# ---------------------------------------------------------------------------
# Expressions
# ---------------------------------------------------------------------------

def _strings_table():
    rng = np.random.default_rng(21)
    words = ["", "ab", "abc", "abcab", "MEDIUM POLISHED TIN",
             "MEDIUM POLISHED", "SMALL PLATED", "x€y", "é", "ÉCONOMY"]
    vals = [None if rng.random() < 0.15 else words[int(rng.integers(0, 10))]
            for _ in range(400)]
    ints = [None if rng.random() < 0.1 else int(rng.integers(0, 6))
            for _ in range(400)]
    return pa.table({"s": pa.array(vals), "i": pa.array(ints, pa.int32())})


def _eval_both(port_expr, jax_expr, t):
    pb, ps = tb.from_arrow(t, device="cpu")
    jb, js = jax_from_arrow(t)
    return (port_expr.bind(ps).eval(pb), jax_expr.bind(js).eval(jb))


PREDICATES = {
    "contains": ("ab", "contains"),
    "startswith": ("MEDIUM POLISHED", "startswith"),
    "endswith": ("b", "endswith"),
    "endswith_utf8": ("€y", "endswith"),
    "contains_empty": ("", "contains"),
    "startswith_too_long": ("MEDIUM POLISHED TIN AND MORE", "startswith"),
    "null_literal": (None, "contains"),
}


@pytest.mark.parametrize("case", list(PREDICATES))
def test_string_predicate_matches_jax(case):
    pat, op = PREDICATES[case]
    p_lit = lit(pat, T.string(32)) if pat is None else lit(pat)
    j_lit = jlit(pat, JT.string(32)) if pat is None else jlit(pat)
    got, exp = _eval_both(tstr.StringPredicate(col("s"), p_lit, op),
                          jstr.StringPredicate(jcol("s"), j_lit, op),
                          _strings_table())
    _same_column(got, exp)


def _logic(m):
    """A tree over strings and ints with nulls on both sides: equality and
    IN with a null in the list, NOT, AND and OR."""
    c, lt = m["col"], m["lit"]
    eq = m["EqualTo"](c("s"), lt("abc"))
    isin = m["In"](c("s"), ("ab", None, "é"))
    ints = m["In"](c("i"), (1, 3, 5))
    sw = m["startswith"](c("s"), "MEDIUM")
    return {
        "eq": eq, "not_eq": m["Not"](eq), "in_with_null": isin,
        "le": m["LessThanOrEqual"](c("s"), lt("abc")),
        "in_ints": ints,
        "and": m["And"](m["Not"](eq), ints),
        "or": m["Or"](isin, m["Not"](sw)),
        "nested": m["And"](m["Or"](eq, ints), m["Not"](m["In"](c("i"),
                                                           (None, 2)))),
    }


PORT = {"col": col, "lit": lit, "EqualTo": EqualTo, "In": In, "Not": Not,
        "And": And, "Or": Or, "startswith": tstr.startswith,
        "LessThanOrEqual": LessThanOrEqual}
JAX = {"col": jcol, "lit": jlit, "EqualTo": jcmp.EqualTo, "In": jcmp.In,
       "Not": jcmp.Not, "And": jbool.And, "Or": jbool.Or,
       "startswith": jstr.startswith,
       "LessThanOrEqual": jcmp.LessThanOrEqual}


@pytest.mark.parametrize("case", list(_logic(PORT)))
def test_comparison_and_logic_match_jax(case):
    got, exp = _eval_both(_logic(PORT)[case], _logic(JAX)[case],
                          _strings_table())
    _same_column(got, exp)


def test_string_literal_longer_than_its_column_raises():
    t = pa.table({"s": pa.array(["ab"])})
    pb, ps = tb.from_arrow(t, string_max_len=4, device="cpu")
    with pytest.raises(tb.StringOverflowError):
        In(col("s"), ("abcdef",)).bind(ps).eval(pb)


# ---------------------------------------------------------------------------
# Hashing and partitioning
# ---------------------------------------------------------------------------

def _hash_inputs():
    """Every length 0..64 (most not multiples of 4), bytes >= 0x80 among
    them, and null rows."""
    rng = np.random.default_rng(8)
    vals = []
    for length in range(65):
        for _ in range(3):
            raw = rng.integers(0x20, 0x7F, length, dtype=np.uint8)
            raw[rng.random(length) < 0.3] = 0xC3
            vals.append(raw.tobytes())
    mask = rng.random(len(vals)) < 0.1
    arr = pa.array([None if m else v for v, m in zip(vals, mask)],
                   pa.binary()).cast(pa.string(), safe=False)
    return vals, mask, arr


def test_hash_column_on_strings_matches_jax_and_spark():
    vals, mask, arr = _hash_inputs()
    t = pa.table({"s": arr})
    pb, _ = tb.from_arrow(t, device="cpu")
    jb, _ = jax_from_arrow(t)
    got = th.hash_column(pb.columns[0], 42).numpy()
    exp = np.asarray(jh.hash_column(jb.columns[0], jnp.uint32(42))
                     .view(jnp.int32))
    np.testing.assert_array_equal(got, exp)
    for i, (v, null) in enumerate(zip(vals, mask)):
        assert got[i] == (42 if null else hash_bytes(v, 42)), i


def test_partition_ids_over_part_keys_match_jax():
    from spark_rapids_tpu.shuffle.partitioning import HashPartitioning as JHP
    from spark_rapids_tpu_torch import entry
    from spark_rapids_tpu_torch.shuffle import HashPartitioning
    t = entry.part_table(3000, seed=5)
    pb, ps = tb.from_arrow(t, device="cpu")
    jb, js = jax_from_arrow(t)
    np.testing.assert_array_equal(th.murmur3_batch(pb.columns).numpy(),
                                  np.asarray(jh.murmur3_batch(jb.columns)))
    for n in (8, 7, 200):
        np.testing.assert_array_equal(
            th.partition_ids(pb.columns, n).numpy(),
            np.asarray(jh.partition_ids(jb.columns, n)))
        keys = entry.Q16_KEYS
        got = HashPartitioning([col(k) for k in keys], n).bind(ps)
        exp = JHP([jcol(k) for k in keys], n).bind(js)
        np.testing.assert_array_equal(
            got.partition_ids(pb).numpy(),
            np.asarray(exp.partition_ids(jb)))


# ---------------------------------------------------------------------------
# Sort
# ---------------------------------------------------------------------------

def _sort_table():
    """Prefixes of one another, embedded and trailing 0x00, bytes >= 0x80,
    nulls, and a count column with ties."""
    base = ["", "a", "ab", "abc", "a\x00", "a\x00b", "b", "é", "éa", "\x7f",
            "\x00", "zz", "MEDIUM POLISHED", "MEDIUM POLISHED TIN", None]
    rng = np.random.default_rng(13)
    s = [base[int(i)] for i in rng.integers(0, len(base), 500)]
    s2 = [base[int(i)] for i in rng.integers(0, len(base), 500)]
    cnt = rng.integers(0, 4, 500).astype(np.int64)
    return pa.table({"cnt": cnt, "s": pa.array(s), "s2": pa.array(s2)})


@pytest.mark.parametrize("string_desc", [False, True],
                         ids=["strings_asc", "strings_desc"])
def test_sort_on_string_keys_matches_jax(string_desc):
    t = _sort_table()
    jplan = jexec.SortExec(
        [JSortOrder(jcol("cnt"), True), JSortOrder(jcol("s"), string_desc),
         JSortOrder(jcol("s2"), string_desc)],
        jexec.InMemoryScanExec(t, batch_rows=200))
    order = desc if string_desc else asc
    plan = SortExec([desc(col("cnt")), order(col("s")), order(col("s2"))],
                    InMemoryScanExec(t, batch_rows=200, num_slices=2,
                                     device="cpu"))
    got = collect(plan)
    assert_tables_equal(got, jexec.collect(jplan), approx_float=False)
    assert got.column("s").to_pylist() == jexec.collect(
        jplan).column("s").to_pylist()
