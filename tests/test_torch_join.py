"""The port's hash join against the JAX package's, exactly, on the same
numpy-made inputs: every join type but CROSS, three key shapes (an exact
int64 key, a dense contiguous primary-key build that starts at the int64
minimum, and a hashed (int32, string) key pair), a broadcast build and
co-partitioned inputs, and data with null keys and keys at the int64
minimum and maximum, an empty build and an empty stream. Rows compare after
sorting them. Also the comparisons and null tests the join slice adds (NaN,
-0.0, strings with 0x00 bytes), date literals, the limits and
``slice_batch``, ``RequireSingleBatch`` and ``BroadcastExchangeExec``'s byte
limit.

The JAX side runs with ``jax_disable_jit``: the same operations, dispatched
one by one, so each case pays no XLA compile of its own."""

import datetime

import jax
import numpy as np
import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu import exec as jexec
from spark_rapids_tpu.batch import from_arrow as jax_from_arrow
from spark_rapids_tpu.batch import schema_from_arrow as jax_schema_from_arrow
from spark_rapids_tpu.exec.common import slice_batch as jax_slice_batch
from spark_rapids_tpu.expressions import col as jcol
from spark_rapids_tpu.expressions import comparison as jcmp
from spark_rapids_tpu.expressions import lit as jlit
from spark_rapids_tpu.shuffle import exchange as jex
from spark_rapids_tpu.shuffle.partitioning import \
    HashPartitioning as JHashPartitioning
from spark_rapids_tpu_torch import batch as tb
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.exec import (CoalesceBatchesExec, GlobalLimitExec,
                                         HashJoinExec, InMemoryScanExec,
                                         JoinType, LocalLimitExec,
                                         RequireSingleBatch, collect)
from spark_rapids_tpu_torch.exec import join as tjoin
from spark_rapids_tpu_torch.exec.common import slice_batch
from spark_rapids_tpu_torch.expressions import (EqualNullSafe, EqualTo,
                                                GreaterThan,
                                                GreaterThanOrEqual, IsNotNull,
                                                IsNull, LessThan,
                                                LessThanOrEqual, col, lit)
from spark_rapids_tpu_torch.shuffle import (BroadcastExchangeExec,
                                            BroadcastTooLargeError,
                                            HashPartitioning,
                                            ShuffleExchangeExec)

I64_MIN, I64_MAX = np.iinfo(np.int64).min, np.iinfo(np.int64).max

JOIN_TYPES = [t for t in JoinType if t is not JoinType.CROSS]
SLICES, PARTITIONS = 2, 3


@pytest.fixture(autouse=True)
def _jax_eager():
    with jax.disable_jit():
        yield


# ---------------------------------------------------------------------------
# Join inputs
# ---------------------------------------------------------------------------

def _masked(values, null_frac, rng, typ):
    return pa.array(values, typ, mask=rng.random(len(values)) < null_frac)


def _int64_keys(rng, n, domain):
    """Keys drawn from ``domain`` (duplicates), one in eight null."""
    return _masked(rng.choice(np.asarray(domain, np.int64), n), 0.125, rng,
                   pa.int64())


def _exact_tables(rng):
    """A single int64 key: duplicates on both sides, nulls on both sides,
    the int64 minimum and maximum on both sides."""
    domain = [I64_MIN, I64_MIN + 1, -5, 0, 3, 7, 11, I64_MAX - 1, I64_MAX]
    stream = pa.table({"k": _int64_keys(rng, 170, domain),
                       "v": rng.integers(-1000, 1000, 170)})
    build = pa.table({"bk": _int64_keys(rng, 60, domain[1:] + [99]),
                      "w": np.round(rng.uniform(-10, 10, 60), 3)})
    return stream, build


def _dense_tables(rng):
    """A unique contiguous build key starting at the int64 minimum (one
    null build key besides); the stream hits it, misses it just past its
    end and far away (where key - first wraps in int64), and has nulls."""
    n_build = 40
    bk = np.arange(n_build, dtype=np.int64) + I64_MIN
    build = pa.table({
        "bk": pa.array(np.append(bk, 0), pa.int64(),
                       mask=np.arange(n_build + 1) == n_build),
        "w": np.round(rng.uniform(-10, 10, n_build + 1), 3)})
    far = np.array([0, -1, I64_MAX, I64_MIN + n_build, 1 << 62], np.int64)
    pool = np.concatenate([bk, far])
    stream = pa.table({"k": _masked(rng.choice(pool, 150), 0.1, rng,
                                    pa.int64()),
                       "v": rng.integers(-1000, 1000, 150)})
    return stream, build


WORDS = ["", "a", "ab", "a\x00", "MEDI", "é", "zz"]
#: string width of the join inputs: the JAX package's string hash mixes
#: every byte position in turn, and dispatched one operation at a time a
#: narrow column keeps it quick
STRING_WIDTH = 4


def _hashed_tables(rng):
    """An (int32, string) key pair over small domains: duplicate pairs,
    pairs present on one side only, nulls in either column, and strings
    that differ only by a trailing 0x00 byte."""
    def side(n, ids):
        return {"a": _masked(rng.choice(ids, n).astype(np.int32), 0.08, rng,
                             pa.int32()),
                "s": _masked(np.array(WORDS, object)[rng.integers(
                    0, len(WORDS), n)], 0.08, rng, pa.string())}
    stream = pa.table({**side(170, [-1, 0, 1, 2]),
                       "v": rng.integers(-1000, 1000, 170)})
    b = side(70, [0, 1, 2, 3])
    build = pa.table({"ba": b["a"], "bs": b["s"],
                      "w": np.round(rng.uniform(-10, 10, 70), 3)})
    return stream, build


KEYS = {
    "exact_int64": (_exact_tables, ["k"], ["bk"]),
    "dense_pk": (_dense_tables, ["k"], ["bk"]),
    "hashed_int32_string": (_hashed_tables, ["a", "s"], ["ba", "bs"]),
}

DATA = ["nulls_and_extremes", "empty_build", "empty_stream"]


def _inputs(keys, data):
    make, lk, rk = KEYS[keys]
    stream, build = make(np.random.default_rng(len(keys)))
    if data == "empty_build":
        build = build.slice(0, 0)
    elif data == "empty_stream":
        stream = stream.slice(0, 0)
    return stream, build, lk, rk


def _port_join(stream, build, lk, rk, how, broadcast):
    return _port_join_on(stream, build, lk, rk, how, broadcast, "cpu")


def _port_join_on(stream, build, lk, rk, how, broadcast, device):
    def scan(t):
        return InMemoryScanExec(
            t, tb.schema_from_arrow(t.schema, STRING_WIDTH),
            batch_rows=max(1, -(-t.num_rows // SLICES)), num_slices=SLICES,
            device=device)
    ls, rs = scan(stream), scan(build)
    if broadcast:
        return HashJoinExec([col(k) for k in lk], [col(k) for k in rk], how,
                            ls, BroadcastExchangeExec(rs))
    return HashJoinExec(
        [col(k) for k in lk], [col(k) for k in rk], how,
        ShuffleExchangeExec(HashPartitioning([col(k) for k in lk],
                                             PARTITIONS), ls),
        ShuffleExchangeExec(HashPartitioning([col(k) for k in rk],
                                             PARTITIONS), rs),
        broadcast_build=False)


def _jax_join(stream, build, lk, rk, how, broadcast):
    def scan(t):
        return jexec.InMemoryScanExec(
            t, jax_schema_from_arrow(t.schema, STRING_WIDTH),
            batch_rows=max(1, -(-t.num_rows // SLICES)), num_slices=SLICES)
    ls, rs = scan(stream), scan(build)
    jt = jexec.JoinType[how.name]
    if broadcast:
        return jexec.HashJoinExec([jcol(k) for k in lk],
                                  [jcol(k) for k in rk], jt, ls,
                                  jex.BroadcastExchangeExec(rs))
    return jexec.HashJoinExec(
        [jcol(k) for k in lk], [jcol(k) for k in rk], jt,
        jex.ShuffleExchangeExec(JHashPartitioning(
            [jcol(k) for k in lk], PARTITIONS), ls),
        jex.ShuffleExchangeExec(JHashPartitioning(
            [jcol(k) for k in rk], PARTITIONS), rs),
        broadcast_build=False)


def _sorted_rows(t: pa.Table):
    def key(row):
        return tuple((v is None, v if v is not None else 0) for v in row)
    return sorted(zip(*[c.to_pylist() for c in t.columns]), key=key)


@pytest.mark.parametrize("data", DATA)
@pytest.mark.parametrize("broadcast", [True, False],
                         ids=["broadcast", "copartitioned"])
@pytest.mark.parametrize("keys", list(KEYS))
@pytest.mark.parametrize("how", JOIN_TYPES, ids=lambda t: t.name)
def test_join_matches_jax(how, keys, broadcast, data, monkeypatch):
    stream, build, lk, rk = _inputs(keys, data)
    dense = []
    real_build = tjoin.HashJoinExec._build_kernel

    def spy(self, b):
        table, sbuild = real_build(self, b)
        dense.append(table.dense)
        return table, sbuild

    monkeypatch.setattr(tjoin.HashJoinExec, "_build_kernel", spy)
    got = collect(_port_join(stream, build, lk, rk, how, broadcast))
    want = jexec.collect(_jax_join(stream, build, lk, rk, how, broadcast))
    assert got.schema == want.schema
    assert _sorted_rows(got) == _sorted_rows(want)
    # the dense path is taken where, and only where, the build is dense
    if keys == "dense_pk" and broadcast and data != "empty_build":
        assert dense == [True] * len(dense) and dense
    elif keys != "dense_pk":
        assert not any(dense)


@pytest.mark.cuda
@pytest.mark.parametrize("keys", list(KEYS))
def test_join_on_the_card_matches_the_cpu(keys):
    """On a card the hashed key's int32 column goes through the murmur3
    kernel; every join type must give the CPU's rows."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the murmur3 kernel has no CPU "
                    "mode (chip_smoke.py holds the join on the card too)")
    stream, build, lk, rk = _inputs(keys, DATA[0])
    for how in JOIN_TYPES:
        for broadcast in (True, False):
            want = collect(_port_join(stream, build, lk, rk, how,
                                      broadcast))
            got = collect(_port_join_on(stream, build, lk, rk, how,
                                        broadcast, "cuda"))
            assert _sorted_rows(got) == _sorted_rows(want)


@pytest.mark.parametrize("how", JOIN_TYPES, ids=lambda t: t.name)
def test_join_condition_matches_jax(how):
    """A non-equi condition over the candidate pairs (``v > 50 * w``),
    which also keeps the 1:1 path out."""
    stream, build, lk, rk = _inputs("exact_int64", DATA[0])
    port = _port_join(stream, build, lk, rk, how, True)
    port = HashJoinExec(port.left_keys, port.right_keys, how, port.left,
                        port.right, condition=GreaterThan(
                            col("v"), col("w") * lit(50.0)))
    jax_plan = _jax_join(stream, build, lk, rk, how, True)
    jax_plan = jexec.HashJoinExec(
        jax_plan.left_keys, jax_plan.right_keys, jax_plan.join_type,
        jax_plan.left, jax_plan.right,
        condition=jcmp.GreaterThan(jcol("v"), jcol("w") * jlit(50.0)))
    got, want = collect(port), jexec.collect(jax_plan)
    assert _sorted_rows(got) == _sorted_rows(want)
    assert got.num_rows > 0


def test_join_inputs_hold_what_they_claim():
    stream, build, _, _ = _inputs("exact_int64", DATA[0])
    ks = stream.column("k").to_pylist()
    bks = build.column("bk").to_pylist()
    assert {I64_MIN, I64_MAX} <= set(ks) and I64_MAX in bks
    assert None in ks and None in bks
    assert len(set(b for b in bks if b is not None)) < len(bks) - 1
    stream, build, _, _ = _inputs("hashed_int32_string", DATA[0])
    assert "a\x00" in build.column("bs").to_pylist()


def test_join_unique_path_against_jax():
    """A foreign-key stream over a unique build (at most one candidate per
    probe row and an output bucket of the stream's capacity): the 1:1 path
    for INNER and LEFT_OUTER, on the exact and the hashed key."""
    rng = np.random.default_rng(5)
    build = pa.table({"bk": np.arange(0, 400, 2, dtype=np.int64),
                      "ba": np.arange(200, dtype=np.int32),
                      "bs": pa.array([f"s{i % 7}" for i in range(200)]),
                      "w": rng.uniform(0, 1, 200)})
    stream = pa.table({"k": rng.integers(0, 399, 128).astype(np.int64),
                       "a": rng.integers(0, 200, 128).astype(np.int32),
                       "s": pa.array([f"s{i % 7}" for i in
                                      rng.integers(0, 200, 128)])})
    calls = []
    real = tjoin.HashJoinExec._expand_unique

    def spy(self, *args):
        calls.append(self.join_type)
        return real(self, *args)

    for how in (JoinType.INNER, JoinType.LEFT_OUTER):
        for lk, rk in ((["k"], ["bk"]), (["a", "s"], ["ba", "bs"])):
            with pytest.MonkeyPatch.context() as mp:
                mp.setattr(tjoin.HashJoinExec, "_expand_unique", spy)
                got = collect(_port_join(stream, build, lk, rk, how, True))
            want = jexec.collect(_jax_join(stream, build, lk, rk, how, True))
            assert _sorted_rows(got) == _sorted_rows(want)
    assert len(calls) >= 4


def test_join_keeps_the_output_capacity_contract():
    """Expanded outputs hold bucket_capacity(total) rows; LEFT/FULL outer
    outputs bucket_capacity(out_cap + stream capacity); rows past num_rows
    are dead."""
    stream, build, lk, rk = _inputs("exact_int64", DATA[0])
    for how in (JoinType.INNER, JoinType.LEFT_OUTER, JoinType.FULL_OUTER):
        plan = _port_join(stream, build, lk, rk, how, True)
        s_caps = [b.capacity for p in range(plan.left.num_partitions)
                  for b in plan.left.execute_partition(p)]
        outs = list(plan.execute())
        for b in outs[:len(s_caps)]:
            n = int(b.num_rows)
            for c in b.columns:
                assert not c.validity[n:].any()
            if how is JoinType.INNER:
                assert b.capacity == tb.bucket_capacity(max(n, 1))
            else:
                assert b.capacity >= tb.bucket_capacity(n) + min(s_caps)


def test_oversized_build_names_the_grace_join():
    """A build over ``max_build_rows`` takes the grace join, in
    ceil(rows / max_build_rows) buckets in each stream partition against
    the broadcast build (the ``graceBuckets`` metric), with the rows of the
    JAX package's ``_grace_join``."""
    stream, build, lk, rk = _inputs("exact_int64", DATA[0])
    plan = _port_join(stream, build, lk, rk, JoinType.INNER, True)
    jplan = _jax_join(stream, build, lk, rk, JoinType.INNER, True)
    plan.max_build_rows = jplan.max_build_rows = 10
    got, want = collect(plan), jexec.collect(jplan)
    assert _sorted_rows(got) == _sorted_rows(want) and got.num_rows
    assert plan.metrics["graceBuckets"].total() == \
        plan.num_partitions * -(-build.num_rows // 10)


def test_cross_join_type_is_refused():
    stream, build, lk, rk = _inputs("exact_int64", DATA[0])
    with pytest.raises(ValueError, match="BroadcastNestedLoopJoinExec"):
        _port_join(stream, build, lk, rk, JoinType.CROSS, True)


def test_join_of_mismatched_key_types_raises():
    stream, build, _, _ = _inputs("exact_int64", DATA[0])
    build = build.set_column(0, "bk", pa.array(
        np.arange(build.num_rows, dtype=np.int32)))
    with pytest.raises(TypeError, match="key type mismatch"):
        _port_join(stream, build, ["k"], ["bk"], JoinType.INNER, True)


# ---------------------------------------------------------------------------
# Comparisons, null tests and date literals
# ---------------------------------------------------------------------------

NAN = float("nan")


def _cmp_table():
    return pa.table({
        "x": pa.array([NAN, 1.0, -0.0, 0.0, None, NAN, 2.5, NAN, 1.0]),
        "y": pa.array([1.0, NAN, 0.0, -0.0, 1.0, NAN, None, -1e300, 1.0]),
        "i": pa.array([3, None, -2, 0, 5, 7, 1, 2, 9], pa.int32()),
        "j": pa.array([3, 4, None, 0, -1, 7, 2, 1, 9], pa.int64()),
        "s": pa.array(["a", "a\x00", "", None, "b", "ab", "a", "é", "a\x00"]),
        "t": pa.array(["a", "a", "\x00", "x", None, "a", "ab", "e", "a\x00"]),
        "d": pa.array(np.array([9000, 9203, 9204, 9205, 0, 9204, 1, 2, 3],
                               "datetime64[D]"), pa.date32()),
    })


CMP = {"LessThan": (LessThan, jcmp.LessThan, "lt"),
       "LessThanOrEqual": (LessThanOrEqual, jcmp.LessThanOrEqual, "le"),
       "GreaterThan": (GreaterThan, jcmp.GreaterThan, "gt"),
       "GreaterThanOrEqual": (GreaterThanOrEqual, jcmp.GreaterThanOrEqual,
                              "ge"),
       "EqualTo": (EqualTo, jcmp.EqualTo, "eq"),
       "EqualNullSafe": (EqualNullSafe, jcmp.EqualNullSafe, "nse")}


def _eval_both(port_expr, jax_expr, t):
    pb, ps = tb.from_arrow(t, device="cpu")
    jb, js = jax_from_arrow(t)
    pc = port_expr.bind(ps).eval(pb)
    jc = jax_expr.bind(js).eval(jb)
    n = t.num_rows
    return ((pc.data[:n].numpy(), pc.validity[:n].numpy()),
            (np.asarray(jc.data)[:n], np.asarray(jc.validity)[:n]))


def _spark_float(op, x, y):
    """Spark's double comparison: NaN == NaN, NaN above all."""
    if x is None or y is None:
        return None if op != "nse" else (x is None and y is None)
    xn, yn = np.isnan(x), np.isnan(y)
    lt = (x < y) or (not xn and yn)
    eq = (x == y) or (xn and yn)
    return {"lt": lt, "le": lt or eq, "gt": not (lt or eq), "ge": not lt,
            "eq": eq, "nse": eq}[op]


@pytest.mark.parametrize("cols", [("i", "j"), ("s", "t"), ("d", "d"),
                                  ("x", "y")])
@pytest.mark.parametrize("name", list(CMP))
def test_comparison_matches_jax(name, cols):
    """Int32 against int64, strings (0x00 bytes, UTF-8), dates and doubles
    against the JAX package; on a NaN row the port follows Spark's order
    where the JAX package compares IEEE floats."""
    port_cls, jax_cls, op = CMP[name]
    t = _cmp_table()
    a, b = cols
    (pd, pv), (jd, jv) = _eval_both(port_cls(col(a), col(b)),
                                    jax_cls(jcol(a), jcol(b)), t)
    np.testing.assert_array_equal(pv, jv)
    if a != "x":
        np.testing.assert_array_equal(pd, jd)
        return
    xs, ys = t.column("x").to_pylist(), t.column("y").to_pylist()
    for r, (x, y) in enumerate(zip(xs, ys)):
        want = _spark_float(op, x, y)
        if want is None:
            assert not pv[r] and not pd[r]
            continue
        assert bool(pd[r]) == want, (name, x, y)
        if not (x is not None and np.isnan(x)) and \
                not (y is not None and np.isnan(y)):
            assert pd[r] == jd[r]


@pytest.mark.parametrize("c", ["x", "i", "s", "d"])
def test_null_tests_match_jax(c):
    t = _cmp_table()
    for port_cls, jax_cls in ((IsNull, jcmp.IsNull),
                              (IsNotNull, jcmp.IsNotNull)):
        (pd, pv), (jd, jv) = _eval_both(port_cls(col(c)), jax_cls(jcol(c)),
                                        t)
        np.testing.assert_array_equal(pd, jd)
        np.testing.assert_array_equal(pv, jv)
        assert port_cls(col(c)).nullable is False


def test_date_literals_match_jax():
    t = _cmp_table()
    day = datetime.date(1995, 3, 15)
    assert lit(day).dtype == T.DATE
    for port_cls, jax_cls, _ in CMP.values():
        (pd, pv), (jd, jv) = _eval_both(port_cls(col("d"), lit(day)),
                                        jax_cls(jcol("d"), jlit(day)), t)
        np.testing.assert_array_equal(pd, jd)
        np.testing.assert_array_equal(pv, jv)
    pb, ps = tb.from_arrow(t, device="cpu")
    assert int(lit(day).eval(pb).data[0]) == 9204
    assert int((col("d") > lit(day)).bind(ps).eval(pb).data.sum()) == 1
    with pytest.raises(NotImplementedError):
        lit(datetime.datetime(1995, 3, 15))


# ---------------------------------------------------------------------------
# Limits, slice_batch, RequireSingleBatch, BroadcastExchangeExec
# ---------------------------------------------------------------------------

def _limit_table(n=700):
    rng = np.random.default_rng(9)
    return pa.table({"a": _masked(rng.integers(0, 100, n), 0.1, rng,
                                  pa.int64()),
                     "s": pa.array([f"r{i}" for i in range(n)])})


@pytest.mark.parametrize("start,count", [(0, 5), (3, 200), (250, 10),
                                         (0, 0), (299, 1)])
def test_slice_batch_matches_jax(start, count):
    t = _limit_table(300)
    pb, ps = tb.from_arrow(t, device="cpu")
    jb, _ = jax_from_arrow(t)
    got = tb.to_arrow(slice_batch(pb, start, count), ps)
    want = tb.to_arrow(slice_batch(pb, torch.tensor(start),
                                   torch.tensor(count), capacity=512), ps)
    jgot = jax_slice_batch(jb, start, count)
    assert got.equals(want)
    assert got.equals(t.slice(start, count))
    assert int(jgot.num_rows) == got.num_rows


@pytest.mark.parametrize("limit", [0, 1, 90, 100, 101, 699, 10_000])
@pytest.mark.parametrize("global_", [True, False], ids=["global", "local"])
def test_limits_match_jax(limit, global_):
    t = _limit_table()
    scan = InMemoryScanExec(t, batch_rows=100, num_slices=3, device="cpu")
    jscan = jexec.InMemoryScanExec(t, batch_rows=100, num_slices=3)
    if global_:
        plan = GlobalLimitExec(limit, scan)
        jplan = jexec.GlobalLimitExec(limit, jscan)
    else:
        plan = LocalLimitExec(limit, scan)
        jplan = jexec.LocalLimitExec(limit, jscan)
    got, want = collect(plan), jexec.collect(jplan)
    assert got.equals(want)
    assert got.num_rows == (min(limit, 700) if global_
                            else sum(min(limit, 300 if p < 1 else 200)
                                     for p in range(3)))
    assert plan.num_partitions == (1 if global_ else 3)


def test_require_single_batch_makes_one_batch_a_partition():
    t = _limit_table()
    scan = InMemoryScanExec(t, batch_rows=50, num_slices=2, device="cpu")
    plan = CoalesceBatchesExec(scan, RequireSingleBatch(), max_rows=64)
    for p in range(2):
        assert len(list(plan.execute_partition(p))) == 1
    assert collect(plan).num_rows == t.num_rows


def test_broadcast_exchange_serves_one_cached_batch():
    t = _limit_table()
    scan = InMemoryScanExec(t, batch_rows=100, num_slices=3, device="cpu")
    bx = BroadcastExchangeExec(scan)
    first = list(bx.execute_partition(0))
    again = list(bx.execute_partition(0))
    assert len(first) == 1 and first[0] is again[0]
    assert bx.num_partitions == 1
    assert scan.metrics["numOutputBatches"].total() == 7
    assert _sorted_rows(collect(bx)) == _sorted_rows(t)


def test_broadcast_exchange_byte_limit():
    t = _limit_table()
    size = tb.from_arrow(t, device="cpu")[0].size_bytes()
    scan = InMemoryScanExec(t, device="cpu")
    assert collect(BroadcastExchangeExec(scan, max_bytes=size)).equals(t)
    with pytest.raises(BroadcastTooLargeError, match="shuffle"):
        collect(BroadcastExchangeExec(scan, max_bytes=size - 1))
    assert issubclass(BroadcastTooLargeError, MemoryError)
    assert BroadcastExchangeExec(scan).max_bytes == 1 << 30
    assert issubclass(jex.BroadcastTooLargeError, MemoryError)


def test_broadcast_of_an_empty_child_is_one_empty_batch():
    t = _limit_table().slice(0, 0)
    bx = BroadcastExchangeExec(InMemoryScanExec(t, device="cpu"))
    (b,) = list(bx.execute_partition(0))
    assert int(b.num_rows) == 0
