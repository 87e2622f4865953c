"""The partitionings and the exchange of the port against the JAX package on
the CPU: the Session-free cases of ``tests/test_shuffle.py`` (hash routing,
round robin, the two-stage aggregate, the shuffled and the broadcast join,
range partitioning plus a partition-local sort, single), each partition's
rows equal to the JAX exchange's where the JAX package runs the same
exchange, and ``_coalesce_groups`` equal to the JAX function over
hypothesis-drawn row counts."""

import numpy as np
import pyarrow as pa
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from spark_rapids_tpu import exec as jexec
from spark_rapids_tpu import shuffle as jshuffle
from spark_rapids_tpu.batch import to_arrow as jax_to_arrow
from spark_rapids_tpu.exec.sort import asc as jasc
from spark_rapids_tpu.exec.sort import desc as jdesc
from spark_rapids_tpu.expressions import col as jcol
from spark_rapids_tpu.shuffle.exchange import \
    _coalesce_groups as jax_coalesce_groups
from spark_rapids_tpu_torch.batch import to_arrow
from spark_rapids_tpu_torch.exec import (AggregateMode, HashAggregateExec,
                                         HashJoinExec, InMemoryScanExec,
                                         JoinType, SortExec, collect)
from spark_rapids_tpu_torch.exec.sort import asc, desc
from spark_rapids_tpu_torch.expressions import col
from spark_rapids_tpu_torch.expressions.aggregates import Count, Sum
from spark_rapids_tpu_torch.memory import BufferCatalog
from spark_rapids_tpu_torch.shuffle import (BroadcastExchangeExec,
                                            HashPartitioning,
                                            RangePartitioning,
                                            RoundRobinPartitioning,
                                            ShuffleExchangeExec,
                                            SinglePartitioning)
from spark_rapids_tpu_torch.shuffle.exchange import _coalesce_groups
from tests.harness.asserts import assert_rows_equal, rows_of
from tests.harness.data_gen import (DoubleGen, IntegerGen, LongGen,
                                    StringGen, gen_table)


def scan(t, batch_rows=None, num_slices=1):
    return InMemoryScanExec(t, batch_rows=batch_rows, num_slices=num_slices,
                            device="cpu")


def jscan(t, batch_rows=None, num_slices=1):
    return jexec.InMemoryScanExec(t, batch_rows=batch_rows,
                                  num_slices=num_slices)


def partition_rows(ex, p, to_arrow_fn=to_arrow):
    rows = []
    for b in ex.execute_partition(p):
        rows += rows_of(to_arrow_fn(b, ex.output_schema))
    return rows


def _sorted(rows):
    """Rows in a fixed order, as reprs (NaN equals NaN)."""
    return sorted(repr(r) for r in rows)


def test_hash_partitioning_routes_rows_as_jax():
    t = gen_table([("k", IntegerGen()), ("v", LongGen())], n=1000, seed=50)
    ex = ShuffleExchangeExec(HashPartitioning([col("k")], 4),
                             scan(t, batch_rows=128, num_slices=2))
    jex = jshuffle.ShuffleExchangeExec(jshuffle.HashPartitioning(
        [jcol("k")], 4), jscan(t, batch_rows=128, num_slices=2))
    parts = [partition_rows(ex, p) for p in range(4)]
    for p in range(4):
        # same rows, in the same order (pieces in input order)
        assert parts[p] == partition_rows(jex, p, jax_to_arrow)
    ex.close()
    exp = list(zip(t.column("k").to_pylist(), t.column("v").to_pylist()))
    assert_rows_equal([r for p in parts for r in p], exp, ignore_order=True)
    seen = {}
    for pi, p in enumerate(parts):
        for k, _ in p:
            assert seen.setdefault(k, pi) == pi


def test_round_robin_balances_as_jax():
    t = gen_table([("v", IntegerGen(nullable=False))], n=800, seed=51)
    ex = ShuffleExchangeExec(RoundRobinPartitioning(4),
                             scan(t, batch_rows=100))
    jex = jshuffle.ShuffleExchangeExec(jshuffle.RoundRobinPartitioning(4),
                                       jscan(t, batch_rows=100))
    parts = [partition_rows(ex, p) for p in range(4)]
    assert parts == [partition_rows(jex, p, jax_to_arrow) for p in range(4)]
    sizes = [len(p) for p in parts]
    assert sum(sizes) == 800 and max(sizes) - min(sizes) <= 8


def test_two_stage_aggregate_over_exchange():
    t = gen_table([("k", IntegerGen(min_val=0, max_val=40)),
                   ("v", LongGen(min_val=-100, max_val=100))],
                  n=3000, seed=52)
    aggs = lambda: [Sum(col("v")).alias("s"), Count(col("v")).alias("c")]
    partial = HashAggregateExec([col("k")], aggs(),
                                scan(t, batch_rows=512, num_slices=3),
                                AggregateMode.PARTIAL)
    ex = ShuffleExchangeExec(HashPartitioning([col("k")], 4), partial)
    final = HashAggregateExec([col("k")], aggs(), ex, AggregateMode.FINAL)
    got = rows_of(collect(final))
    groups = {}
    for k, v in zip(t.column("k").to_pylist(), t.column("v").to_pylist()):
        groups.setdefault(k, []).append(v)
    exp = []
    for k, vs in groups.items():
        xs = [v for v in vs if v is not None]
        exp.append((k, sum(xs) if xs else None, len(xs)))
    assert_rows_equal(got, exp, ignore_order=True)


def _join_tables(seed_l, seed_r, n_l, n_r):
    lt = gen_table([("k", IntegerGen(min_val=0, max_val=30)),
                    ("x", LongGen())], n=n_l, seed=seed_l)
    rt = gen_table([("k2", IntegerGen(min_val=0, max_val=30)),
                    ("y", LongGen())], n=n_r, seed=seed_r)
    return (lt, rt,
            list(zip(lt.column("k").to_pylist(), lt.column("x").to_pylist())),
            list(zip(rt.column("k2").to_pylist(),
                     rt.column("y").to_pylist())))


def test_shuffled_hash_join():
    lt, rt, lrows, rrows = _join_tables(53, 54, 500, 400)
    lex = ShuffleExchangeExec(HashPartitioning([col("k")], 4),
                              scan(lt, batch_rows=128, num_slices=2))
    rex = ShuffleExchangeExec(HashPartitioning([col("k2")], 4),
                              scan(rt, batch_rows=128, num_slices=2))
    plan = HashJoinExec([col("k")], [col("k2")], JoinType.INNER, lex, rex,
                        broadcast_build=False)
    exp = [l + r for l in lrows for r in rrows
           if l[0] is not None and l[0] == r[0]]
    assert_rows_equal(rows_of(collect(plan)), exp, ignore_order=True)


def test_broadcast_join_over_exchange():
    lt, rt, lrows, rrows = _join_tables(55, 56, 300, 100)
    bex = BroadcastExchangeExec(scan(rt, batch_rows=32, num_slices=2))
    plan = HashJoinExec([col("k")], [col("k2")], JoinType.LEFT_OUTER,
                        scan(lt, batch_rows=64, num_slices=3), bex)
    exp = []
    for l in lrows:
        ms = [r for r in rrows if l[0] is not None and l[0] == r[0]]
        exp.extend([l + r for r in ms] if ms else [l + (None, None)])
    assert_rows_equal(rows_of(collect(plan)), exp, ignore_order=True)


def test_range_partition_plus_local_sort_is_global_sort():
    t = gen_table([("a", IntegerGen()), ("b", IntegerGen())], n=1200, seed=57)
    orders = [asc(col("a"))]
    ex = ShuffleExchangeExec(RangePartitioning(orders, 4),
                             scan(t, batch_rows=256, num_slices=2))
    plan = SortExec(orders, ex, global_sort=False)
    combined = [r for p in range(4) for r in partition_rows(plan, p)]
    vals = [r[0] for r in combined]
    nn = [v for v in vals if v is not None]
    assert vals[:len(vals) - len(nn)] == [None] * (len(vals) - len(nn))
    assert nn == sorted(nn)
    assert len(combined) == 1200
    plan.close()


@pytest.mark.parametrize("spec", [
    ("int", True), ("double", False), ("string", True), ("two", False)],
    ids=str)
def test_range_exchange_partitions_as_jax(spec):
    """The sampled bounds and every row's partition equal the JAX
    exchange's: ascending and descending, nulls, NaN, strings and a
    two-key order (a key equal to a bound stays in the earlier
    partition)."""
    kind, descending = spec
    gens = {"int": [("a", IntegerGen(min_val=-20, max_val=20))],
            "double": [("a", DoubleGen())],
            "string": [("a", StringGen(max_len=6))],
            "two": [("a", IntegerGen(min_val=0, max_val=5)),
                    ("b", LongGen(min_val=-9, max_val=9))]}[kind]
    t = gen_table(gens + [("i", IntegerGen(nullable=False))], n=400,
                  seed=60)
    names = [g[0] for g in gens]
    make = desc if descending else asc
    jmake = jdesc if descending else jasc
    ex = ShuffleExchangeExec(RangePartitioning(
        [make(col(n)) for n in names], 5),
        scan(t, batch_rows=100, num_slices=2))
    jex = jshuffle.ShuffleExchangeExec(jshuffle.RangePartitioning(
        [jmake(jcol(n)) for n in names], 5),
        jscan(t, batch_rows=100, num_slices=2))
    ours = [_sorted(partition_rows(ex, p)) for p in range(5)]
    theirs = [_sorted(partition_rows(jex, p, jax_to_arrow))
              for p in range(5)]
    assert ours == theirs
    assert sum(map(len, ours)) == 400
    ex.close()


def test_single_partitioning():
    t = gen_table([("v", IntegerGen())], n=300, seed=58)
    ex = ShuffleExchangeExec(SinglePartitioning(),
                             scan(t, num_slices=3, batch_rows=64))
    assert ex.num_partitions == 1
    assert_rows_equal(rows_of(collect(ex)),
                      [(v,) for v in t.column("v").to_pylist()],
                      ignore_order=True)


@settings(max_examples=200, deadline=None)
@given(st.lists(st.integers(0, 5000), min_size=0, max_size=40),
       st.integers(1, 6000))
def test_coalesce_groups_match_jax(counts, target):
    assert _coalesce_groups(counts, target) == \
        jax_coalesce_groups(counts, target)


def test_adaptive_exchange_coalesces_and_frees_every_piece():
    """A solo adaptive exchange groups thin partitions toward
    ``target_rows`` (same groups as the JAX exchange) and reads every row
    once; its pieces leave the catalog as they are read."""
    rng = np.random.default_rng(61)
    t = pa.table({"k": rng.integers(0, 1000, 2000).astype(np.int64)})
    cat = BufferCatalog(1 << 30)
    ex = ShuffleExchangeExec(HashPartitioning([col("k")], 8),
                             InMemoryScanExec(t, batch_rows=500,
                                              num_slices=2, device="cpu",
                                              catalog=cat),
                             adaptive=True, target_rows=600)
    jex = jshuffle.ShuffleExchangeExec(
        jshuffle.HashPartitioning([jcol("k")], 8),
        jscan(t, batch_rows=500, num_slices=2), adaptive=True,
        target_rows=600)
    assert ex.num_partitions == jex.num_partitions < 8
    assert ex._specs == jex._specs
    for p in range(ex.num_partitions):
        assert _sorted(partition_rows(ex, p)) == \
            _sorted(partition_rows(jex, p, jax_to_arrow))
    assert not cat._entries
    ex.close()
