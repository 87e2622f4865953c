"""The port's out-of-core operators against the JAX package's, on the same
numpy-made inputs: ``OutOfCoreSorter`` over multi-key orders (ascending,
descending, nulls first and last), the aggregate over a multi-batch scan in
a setting where its windowed merge fires and in one where the sort-based
out-of-core merge does, the global sort over ``max_rows``, the grace join
with a small ``max_build_rows``, the exchange's spill under a tiny budget
(the cases of ``tests/test_exchange_spill.py``), and double hashing against
the JAX ``hash_column`` and the scalar Spark oracle on -0.0, infinities and
NaN. Integers, strings and nulls compare exactly, floats within rel 1e-6
(the grouping of partial sums follows the JAX package's). Every test ends
with no pins and no handles left in the catalogs it used.

JAX's compile time sets these tests' cost: its out-of-core paths compile
one program per chunk shape. So the JAX sorter runs at a few hundred rows,
the JAX joins and hashes under ``jax_disable_jit``, and the aggregate and
the global sort are held against the JAX package's in-core plan (one
compile, the aggregates run once in a module fixture), which gives the
same rows as its out-of-core one."""

import math

import jax
import numpy as np
import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu import exec as jexec
from spark_rapids_tpu.batch import from_arrow as jax_from_arrow
from spark_rapids_tpu.batch import to_arrow as jax_to_arrow
from spark_rapids_tpu.exec.ooc_sort import OutOfCoreSorter as JSorter
from spark_rapids_tpu.exec.sort import SortOrder as JSortOrder
from spark_rapids_tpu.expressions import col as jcol
from spark_rapids_tpu.expressions import hashing as jh
from spark_rapids_tpu.expressions.aggregates import Count as JCount
from spark_rapids_tpu.expressions.aggregates import Sum as JSum
from spark_rapids_tpu.memory import catalog as jcatalog
from spark_rapids_tpu.shuffle import HashPartitioning as JHash
from spark_rapids_tpu.shuffle import ShuffleExchangeExec as JExchange
from spark_rapids_tpu_torch import batch as tb
from spark_rapids_tpu_torch.exec import (AggregateMode, HashAggregateExec,
                                         HashJoinExec, InMemoryScanExec,
                                         JoinType, SortExec, collect)
from spark_rapids_tpu_torch.exec.ooc_sort import OutOfCoreSorter
from spark_rapids_tpu_torch.exec.sort import SortOrder
from spark_rapids_tpu_torch.expressions import col
from spark_rapids_tpu_torch.expressions import hashing as th
from spark_rapids_tpu_torch.expressions.aggregates import Count, Sum
from spark_rapids_tpu_torch.memory.catalog import BufferCatalog
from spark_rapids_tpu_torch.shuffle import (BroadcastExchangeExec,
                                            BroadcastTooLargeError,
                                            HashPartitioning,
                                            ShuffleExchangeExec)

from harness.asserts import assert_tables_equal, rows_of
from harness.data_gen import (DoubleGen, IntegerGen, LongGen, StringGen,
                              gen_table)
from harness.murmur3_oracle import spark_hash_row


@pytest.fixture
def jax_eager():
    with jax.disable_jit():
        yield


def _assert_clean(cat):
    assert cat.total_pinned() == 0, cat.dump_state()
    assert not cat._entries, cat.dump_state()


def _repr_rows(t):
    return [tuple(("nan",) if isinstance(v, float) and math.isnan(v)
                  else v for v in r) for r in rows_of(t)]


# ---------------------------------------------------------------------------
# OutOfCoreSorter
# ---------------------------------------------------------------------------

def _sort_table(n=1500, seed=213):
    return gen_table([("a", IntegerGen(min_val=0, max_val=10)),
                      ("s", StringGen(max_len=6)),
                      ("f", DoubleGen()),
                      ("l", LongGen())], n=n, seed=seed)


#: (column, descending, nulls_first) keys of each order: strings, ints,
#: doubles (NaN, infinities, -0.0) and longs, each direction, nulls at
#: their default and at the other end
ORDERS = {
    "asc_a_desc_s_nulls_first_asc_f_nulls_last": [
        ("a", False, None), ("s", True, True), ("f", False, False)],
    "desc_a_nulls_first_desc_l": [("a", True, True), ("l", True, None)],
}


@pytest.mark.parametrize("order", list(ORDERS))
def test_ooc_sorter_matches_jax(order, tmp_path):
    """The chunked merge tree gives the JAX sorter's row sequence, ties
    included, over runs of several chunks each."""
    t = _sort_table(400)
    keys = ORDERS[order]
    scan = InMemoryScanExec(t, tb.schema_from_arrow(t.schema, 8),
                            batch_rows=100, device="cpu")
    from spark_rapids_tpu.batch import schema_from_arrow
    jscan = jexec.InMemoryScanExec(t, schema_from_arrow(t.schema, 8),
                                   batch_rows=100)
    orders = [SortOrder(col(c), d, nf).bind(scan.output_schema)
              for c, d, nf in keys]
    jorders = [JSortOrder(jcol(c), d, nf).bind(jscan.output_schema)
               for c, d, nf in keys]
    cat = BufferCatalog(device_limit=1 << 30, spill_dir=str(tmp_path))
    jcat = jcatalog.BufferCatalog(device_limit=1 << 30,
                                  spill_dir=str(tmp_path))
    got = [tb.to_arrow(b, scan.output_schema) for b in OutOfCoreSorter(
        orders, scan.output_schema, cat, chunk_rows=64).sort(
            scan.execute())]
    want = [jax_to_arrow(b, jscan.output_schema) for b in JSorter(
        jorders, jscan.output_schema, jcat, chunk_rows=64).sort(
            jscan.execute())]
    got, want = pa.concat_tables(got), pa.concat_tables(want)
    assert got.num_rows == t.num_rows
    assert _repr_rows(got) == _repr_rows(want)
    _assert_clean(cat)


def test_ooc_sort_with_spill_pressure(tmp_path):
    """A budget of about six chunks: the merge must spill, and the result
    is still sorted."""
    t = gen_table([("a", IntegerGen(nullable=False))], n=3000, seed=211)
    scan = InMemoryScanExec(t, batch_rows=250, device="cpu")
    schema = scan.output_schema
    orders = [SortOrder(col("a")).bind(schema)]
    size = tb.from_arrow(t.slice(0, 250), device="cpu")[0].size_bytes()
    cat = BufferCatalog(device_limit=size * 6, spill_dir=str(tmp_path))
    got = []
    for b in OutOfCoreSorter(orders, schema, cat, chunk_rows=256).sort(
            scan.execute()):
        got += tb.to_arrow(b, schema).column("a").to_pylist()
    assert got == sorted(t.column("a").to_pylist())
    assert cat.spilled_to_host > 0, "expected spill under pressure"
    _assert_clean(cat)


# ---------------------------------------------------------------------------
# The global sort over max_rows
# ---------------------------------------------------------------------------

def test_global_sort_over_max_rows_matches_jax():
    """Over ``max_rows`` the sort merges out of core, to the JAX sort's
    rows in the JAX sort's order."""
    t = _sort_table(3000, seed=212)
    keys = ORDERS["asc_a_desc_s_nulls_first_asc_f_nulls_last"]
    schema = tb.schema_from_arrow(t.schema, 8)
    plan = SortExec([SortOrder(col(c), d, nf) for c, d, nf in keys],
                    InMemoryScanExec(t, schema, batch_rows=512,
                                     num_slices=2, device="cpu"),
                    max_rows=2048)
    from spark_rapids_tpu.batch import schema_from_arrow
    jplan = jexec.SortExec(
        [JSortOrder(jcol(c), d, nf) for c, d, nf in keys],
        jexec.InMemoryScanExec(t, schema_from_arrow(t.schema, 8),
                               batch_rows=512, num_slices=2))
    got, want = collect(plan), jexec.collect(jplan)
    assert plan.metrics["oocSorts"].total() == 1
    assert _repr_rows(got) == _repr_rows(want)
    assert got.num_rows == t.num_rows


# ---------------------------------------------------------------------------
# The aggregate's bounded merge
# ---------------------------------------------------------------------------

def _agg_table(distinct, n=1024, seed=31):
    rng = np.random.default_rng(seed)
    return pa.table({
        "k": pa.array(rng.integers(0, distinct, n), mask=rng.random(n) < 0.02),
        "v": pa.array(rng.integers(-1000, 1000, n), mask=rng.random(n) < 0.1),
        "x": rng.uniform(-1e3, 1e3, n)})


def _aggs(mod):
    S, C = (Sum, Count) if mod == "torch" else (JSum, JCount)
    c = col if mod == "torch" else jcol
    return [S(c("v")).alias("sv"), S(c("x")).alias("sx"),
            C(c("v")).alias("cv")]


#: distinct keys over 1024 rows in 8 batches of 128, with a merge budget of
#: 256 rows: few keys shrink in one windowed pass; many keys do not, and go
#: to the sort-based merge
SETTINGS = {"windowed": (11, "windowedMergePasses"),
            "out_of_core": (700, "oocMerges")}
BATCH_ROWS, MAX_RESULT_ROWS = 128, 256


@pytest.fixture(scope="module")
def jax_aggregates():
    """The JAX aggregate (COMPLETE, in core) of each setting's table,
    computed once."""
    return {setting: jexec.collect(jexec.HashAggregateExec(
        [jcol("k")], _aggs("jax"), jexec.InMemoryScanExec(
            _agg_table(distinct), batch_rows=BATCH_ROWS),
        jexec.AggregateMode.COMPLETE))
        for setting, (distinct, _) in SETTINGS.items()}


def _port_aggregate(t, split):
    scan = InMemoryScanExec(t, batch_rows=BATCH_ROWS, device="cpu")
    if not split:
        return HashAggregateExec([col("k")], _aggs("torch"), scan,
                                 AggregateMode.COMPLETE,
                                 max_result_rows=MAX_RESULT_ROWS)
    partial = HashAggregateExec([col("k")], _aggs("torch"), scan,
                                AggregateMode.PARTIAL,
                                max_result_rows=MAX_RESULT_ROWS)
    return HashAggregateExec([col("k")], _aggs("torch"), partial,
                             AggregateMode.FINAL,
                             max_result_rows=MAX_RESULT_ROWS)


def _aggregate_metric(plan, name):
    total = plan.metrics[name].total()
    for c in plan.children:
        total += _aggregate_metric(c, name) if c.children else 0
    return total


@pytest.mark.parametrize("split", [False, True], ids=["complete",
                                                      "partial_final"])
@pytest.mark.parametrize("setting", list(SETTINGS))
def test_aggregate_bounded_merge_matches_jax(setting, split,
                                             jax_aggregates):
    """The port's bounded merge, COMPLETE or PARTIAL then FINAL, against
    the JAX aggregate; the merge of the setting ran and, with few keys,
    the out-of-core merge did not."""
    distinct, metric = SETTINGS[setting]
    t = _agg_table(distinct)
    plan = _port_aggregate(t, split)
    got, want = collect(plan), jax_aggregates[setting]
    assert got.num_rows == want.num_rows == len(set(
        t.column("k").to_pylist()))
    assert_tables_equal(got, want, ignore_order=True)
    assert _aggregate_metric(plan, metric) >= 1
    if setting == "windowed":
        assert _aggregate_metric(plan, "oocMerges") == 0


def test_eval_buffers_kernel_matches_a_final_merge():
    """Groups already unique: evaluating the buffers equals merging them."""
    t = _agg_table(50, n=600)
    scan = InMemoryScanExec(t, device="cpu")
    partial = HashAggregateExec([col("k")], _aggs("torch"), scan,
                                AggregateMode.PARTIAL)
    final = HashAggregateExec([col("k")], _aggs("torch"), partial,
                              AggregateMode.FINAL)
    (buffers,) = list(partial.execute_partition(0))
    a = tb.to_arrow(final._eval_buffers_kernel(buffers), final.output_schema)
    b = tb.to_arrow(final._merge_kernel(buffers, True), final.output_schema)
    assert a.equals(b)


# ---------------------------------------------------------------------------
# The grace join
# ---------------------------------------------------------------------------

def _grace_tables(seed=41):
    rng = np.random.default_rng(seed)
    build = pa.table({
        "bk": pa.array(rng.integers(0, 150, 400), mask=rng.random(400) < 0.05),
        "w": rng.integers(0, 100, 400)})
    stream = pa.table({
        "k": pa.array(rng.integers(0, 200, 500), mask=rng.random(500) < 0.05),
        "v": rng.integers(-50, 50, 500)})
    return stream, build


@pytest.mark.parametrize("how", [JoinType.INNER, JoinType.FULL_OUTER],
                         ids=lambda h: h.name)
def test_grace_join_matches_jax(how, jax_eager):
    """Builds of 400 rows over 2 partitions with max_build_rows 60: each
    partition splits into 3 or more buckets, as the JAX ``_grace_join``
    does, to the same rows (the FULL OUTER tails of every bucket
    included)."""
    stream, build = _grace_tables()
    plan = HashJoinExec(
        [col("k")], [col("bk")], how,
        ShuffleExchangeExec(HashPartitioning([col("k")], 2),
                            InMemoryScanExec(stream, batch_rows=200,
                                             device="cpu")),
        ShuffleExchangeExec(HashPartitioning([col("bk")], 2),
                            InMemoryScanExec(build, batch_rows=200,
                                             device="cpu")),
        broadcast_build=False, max_build_rows=60)
    jplan = jexec.HashJoinExec(
        [jcol("k")], [jcol("bk")], jexec.JoinType[how.name],
        JExchange(JHash([jcol("k")], 2),
                  jexec.InMemoryScanExec(stream, batch_rows=200)),
        JExchange(JHash([jcol("bk")], 2),
                  jexec.InMemoryScanExec(build, batch_rows=200)),
        broadcast_build=False, max_build_rows=60)
    got, want = collect(plan), jexec.collect(jplan)
    assert got.num_rows == want.num_rows > 0
    assert_tables_equal(got, want, ignore_order=True, approx_float=False)
    assert plan.metrics["graceBuckets"].total() >= 6


def test_grace_bucket_ids_match_jax(jax_eager):
    """The bucket hash: murmur3 with seed 77, floor-mod the bucket count."""
    stream, _ = _grace_tables()
    pb, ps = tb.from_arrow(stream, device="cpu")
    jb, _ = jax_from_arrow(stream)
    plan = HashJoinExec([col("k")], [col("k")], JoinType.INNER,
                        InMemoryScanExec(stream, device="cpu"),
                        InMemoryScanExec(stream, device="cpu"))
    jplan = jexec.HashJoinExec([jcol("k")], [jcol("k")],
                               jexec.JoinType.INNER,
                               jexec.InMemoryScanExec(stream),
                               jexec.InMemoryScanExec(stream))
    for n in (3, 8):
        np.testing.assert_array_equal(
            plan._bucket_pids(pb, plan.left_keys, n).numpy(),
            np.asarray(jplan._bucket_pids(jb, jplan.left_keys, n)))


# ---------------------------------------------------------------------------
# The exchange's spill (the cases of tests/test_exchange_spill.py)
# ---------------------------------------------------------------------------

def big_table(n=40_000, seed=5):
    rng = np.random.default_rng(seed)
    return pa.table({"k": rng.integers(0, 1000, n).astype(np.int64),
                     "v": rng.integers(-50, 50, n).astype(np.int64)})


def _partition_rows(ex, to_arrow):
    out = []
    for p in range(ex.num_partitions):
        rows = []
        for b in ex.execute_partition(p):
            rows += rows_of(to_arrow(b, ex.output_schema))
        out.append(rows)
    return out


def test_shuffle_spills_under_small_budget(tmp_path):
    """A shuffle several times the budget spills to host and overflows to
    disk; every partition holds the JAX exchange's rows, in order."""
    t = big_table()
    cat = BufferCatalog(device_limit=200_000, host_limit=150_000,
                        spill_dir=str(tmp_path))
    ex = ShuffleExchangeExec(
        HashPartitioning([col("k")], 8),
        InMemoryScanExec(t, num_slices=4, batch_rows=5000, device="cpu",
                         catalog=cat))
    got = _partition_rows(ex, tb.to_arrow)
    jex = JExchange(JHash([jcol("k")], 8),
                    jexec.InMemoryScanExec(t, num_slices=4,
                                           batch_rows=5000),
                    catalog=jcatalog.BufferCatalog(
                        device_limit=200_000, host_limit=150_000,
                        spill_dir=str(tmp_path / "jax")))
    assert got == _partition_rows(jex, jax_to_arrow)
    assert sorted(r for rows in got for r in rows) == sorted(rows_of(t))
    assert cat.spilled_to_host > 0, "budget never forced a spill"
    assert cat.spilled_to_disk > 0, "host limit never forced disk overflow"
    assert ex.metrics["spillBytes"].total() > 0
    _assert_clean(cat)     # every piece freed by its read
    assert not list(tmp_path.glob("*.rtpu"))


def test_partition_routing_consistent(tmp_path):
    """Same key, same output partition, across input batches."""
    t = big_table(5000)
    cat = BufferCatalog(device_limit=64 << 20, spill_dir=str(tmp_path))
    ex = ShuffleExchangeExec(HashPartitioning([col("k")], 4),
                             InMemoryScanExec(t, batch_rows=1000,
                                              device="cpu", catalog=cat))
    key_part = {}
    for p, rows in enumerate(_partition_rows(ex, tb.to_arrow)):
        for k, _ in rows:
            assert key_part.setdefault(k, p) == p
    _assert_clean(cat)


def test_broadcast_bounded(tmp_path):
    t = big_table(20_000)
    cat = BufferCatalog(device_limit=64 << 20, spill_dir=str(tmp_path))
    ex = BroadcastExchangeExec(InMemoryScanExec(t, device="cpu",
                                                catalog=cat),
                               max_bytes=1000)
    with pytest.raises(BroadcastTooLargeError):
        list(ex.execute_partition(0))
    _assert_clean(cat)


def test_broadcast_spillable_between_reads(tmp_path):
    t = big_table(2000)
    cat = BufferCatalog(device_limit=4 << 20, spill_dir=str(tmp_path))
    ex = BroadcastExchangeExec(InMemoryScanExec(t, device="cpu",
                                                catalog=cat),
                               max_bytes=64 << 20)
    n1 = int(next(iter(ex.execute_partition(0))).num_rows)
    cat.synchronous_spill(cat.device_used)      # force it out
    assert cat.spilled_to_host > 0
    b = next(iter(ex.execute_partition(0)))
    assert int(b.num_rows) == n1 == 2000
    assert tb.to_arrow(b, ex.output_schema).equals(t)
    ex.close()
    _assert_clean(cat)


def test_broadcast_closed_after_collect():
    """A join over a broadcast leaves no catalog entry after collect."""
    t = big_table(2000)
    d = pa.table({"dk": np.arange(1000, dtype=np.int64)})
    cat = BufferCatalog(device_limit=64 << 20)
    plan = HashJoinExec([col("k")], [col("dk")], JoinType.INNER,
                        InMemoryScanExec(t, device="cpu", catalog=cat),
                        BroadcastExchangeExec(InMemoryScanExec(
                            d, device="cpu", catalog=cat)))
    assert collect(plan).num_rows == 2000
    _assert_clean(cat)


# ---------------------------------------------------------------------------
# Double hashing
# ---------------------------------------------------------------------------

SPECIALS = [0.0, -0.0, float("inf"), float("-inf"), float("nan"), 1.5,
            -2.25e300, 2.2250738585072014e-308, None]
#: subnormal doubles: Spark hashes their bits; the JAX package extracts
#: bits arithmetically and hashes them as 0.0 (a reference difference)
SUBNORMALS = [5e-324, 1e-310, -3e-320]


def test_double_hash_matches_jax_and_the_spark_oracle(jax_eager):
    t = pa.table({"f": pa.array(SPECIALS * 7, pa.float64()),
                  "i": pa.array(np.arange(len(SPECIALS) * 7, dtype=np.int32))})
    pb, _ = tb.from_arrow(t, device="cpu")
    jb, _ = jax_from_arrow(t)
    got = th.murmur3_batch(pb.columns).numpy()
    np.testing.assert_array_equal(got, np.asarray(jh.murmur3_batch(
        jb.columns)))
    np.testing.assert_array_equal(
        th.hash_column(pb.columns[0], 42).numpy(),
        np.asarray(jh.hash_column(jb.columns[0], 42)).view(np.int32))
    for i, row in enumerate(rows_of(t)):
        assert got[i] == spark_hash_row(list(row), ["double", "int"])
    # -0.0 hashes as 0.0; every NaN as the canonical one
    h = th.hash_column(tb.from_arrow(pa.table({"f": np.array(
        [0.0, -0.0, np.nan, -np.nan, np.float64("nan") * 0.0])}),
        device="cpu")[0].columns[0], 42).numpy()
    assert h[0] == h[1] and h[2] == h[3] == h[4]


def test_subnormal_double_hash_follows_spark(jax_eager):
    t = pa.table({"f": pa.array(SUBNORMALS, pa.float64())})
    got = th.hash_column(tb.from_arrow(t, device="cpu")[0].columns[0],
                         42).numpy()
    jax_got = np.asarray(jh.hash_column(jax_from_arrow(t)[0].columns[0],
                                        42)).view(np.int32)
    zero = spark_hash_row([0.0], ["double"])
    for v, a, b in zip(SUBNORMALS, got, jax_got):
        assert a == spark_hash_row([v], ["double"]) != zero
        assert b == zero


def test_double_gen_partition_ids_match_jax():
    t = gen_table([("f", DoubleGen()), ("s", StringGen(max_len=6))],
                  n=800, seed=3)
    pb, _ = tb.from_arrow(t, device="cpu")
    jb, _ = jax_from_arrow(t)
    for n in (2, 7):
        np.testing.assert_array_equal(
            th.partition_ids(pb.columns, n).numpy(),
            np.asarray(jh.partition_ids(jb.columns, n)))
