"""The port's nested-loop join against the JAX package's, on the same
numpy-made inputs: every join type, with and without a condition (one that
reads both sides and is null on null inputs), in one build tile and in
many, over a broadcast build and over a build of several batches. Rows
compare exactly, as multisets: the two packages cut tiles at different
sizes (the JAX package by capacities, the port by live rows), which orders
pairs differently across tiles.

The JAX side runs with ``jax_disable_jit``: each case's shapes differ, and
running its operations one by one costs less than compiling them."""

import jax
import numpy as np
import pyarrow as pa
import pytest

from spark_rapids_tpu import exec as jexec
from spark_rapids_tpu.exec.join import JoinType as JJoinType
from spark_rapids_tpu.expressions import col as jcol
from spark_rapids_tpu.expressions import lit as jlit
from spark_rapids_tpu.expressions.boolean import And as JAnd
from spark_rapids_tpu.expressions.comparison import LessThan as JLess
from spark_rapids_tpu.shuffle.exchange import \
    BroadcastExchangeExec as JBroadcast
from spark_rapids_tpu_torch.exec import (BroadcastNestedLoopJoinExec,
                                         InMemoryScanExec, JoinType, collect)
from spark_rapids_tpu_torch.expressions import And, LessThan, col, lit
from spark_rapids_tpu_torch.shuffle import BroadcastExchangeExec

from harness.asserts import assert_tables_equal

STREAM_SLICES = 2
#: one tile per stream batch, and tiles of a few pairs each
TILES = {"one-tile": 1 << 20, "tiles": 40}


@pytest.fixture(autouse=True)
def _jax_eager():
    with jax.disable_jit():
        yield


def _tables(n_stream=45, n_build=11, seed=7):
    rng = np.random.default_rng(seed)
    stream = pa.table({
        "a": pa.array(rng.integers(0, 20, n_stream),
                      mask=rng.random(n_stream) < 0.15),
        "s": pa.array(rng.choice(["x", "yy", "zzz"], n_stream)),
    })
    build = pa.table({
        "w": pa.array(rng.integers(0, 20, n_build),
                      mask=rng.random(n_build) < 0.2),
        "f": rng.uniform(-1, 1, n_build),
    })
    return stream, build


def _condition(c, Less, And_, lit_):
    # a < w and w < 15: reads both sides; null when a or w is null
    return And_(Less(c("a"), c("w")), Less(c("w"), lit_(15)))


def _port(stream, build, how, cond, tile, build_batch_rows=None,
          broadcast=True):
    left = InMemoryScanExec(stream, num_slices=STREAM_SLICES,
                            batch_rows=-(-stream.num_rows // STREAM_SLICES),
                            device="cpu")
    right = InMemoryScanExec(build, batch_rows=build_batch_rows,
                             device="cpu")
    if broadcast:
        right = BroadcastExchangeExec(right)
    condition = _condition(col, LessThan, And, lit) if cond else None
    return BroadcastNestedLoopJoinExec(how, left, right, condition,
                                       max_tile_rows=tile)


def _jax(stream, build, how, cond, tile, build_batch_rows=None,
         broadcast=True):
    left = jexec.InMemoryScanExec(
        stream, num_slices=STREAM_SLICES,
        batch_rows=-(-stream.num_rows // STREAM_SLICES))
    right = jexec.InMemoryScanExec(build, batch_rows=build_batch_rows)
    if broadcast:
        right = JBroadcast(right)
    condition = _condition(jcol, JLess, JAnd, jlit) if cond else None
    return jexec.BroadcastNestedLoopJoinExec(JJoinType[how.name], left,
                                             right, condition,
                                             max_tile_rows=tile)


@pytest.mark.parametrize("tile", list(TILES), ids=list(TILES))
@pytest.mark.parametrize("cond", [False, True],
                         ids=["no-condition", "condition"])
@pytest.mark.parametrize("how", list(JoinType), ids=[t.name for t in JoinType])
def test_nested_loop_join_matches_jax(how, cond, tile):
    stream, build = _tables()
    plan = _port(stream, build, how, cond, TILES[tile])
    got = collect(plan)
    want = jexec.collect(_jax(stream, build, how, cond, TILES[tile]))
    assert got.schema.names == want.schema.names
    assert_tables_equal(got, want, ignore_order=True, approx_float=False)
    expect_parts = 1 if how in (JoinType.RIGHT_OUTER,
                                JoinType.FULL_OUTER) else STREAM_SLICES
    assert plan.num_partitions == expect_parts
    if how in (JoinType.INNER, JoinType.CROSS) and not cond:
        assert got.num_rows == stream.num_rows * build.num_rows


@pytest.mark.parametrize("how", [JoinType.INNER, JoinType.LEFT_OUTER,
                                 JoinType.FULL_OUTER],
                         ids=["INNER", "LEFT_OUTER", "FULL_OUTER"])
def test_build_of_several_batches_matches_jax(how):
    """A build side of several batches, not broadcast: INNER streams over
    them one by one, the others concatenate them."""
    stream, build = _tables(n_build=30, seed=9)
    got = collect(_port(stream, build, how, True, TILES["tiles"],
                        build_batch_rows=8, broadcast=False))
    want = jexec.collect(_jax(stream, build, how, True, TILES["tiles"],
                              build_batch_rows=8, broadcast=False))
    assert_tables_equal(got, want, ignore_order=True, approx_float=False)


@pytest.mark.parametrize("how", [JoinType.INNER, JoinType.LEFT_OUTER,
                                 JoinType.LEFT_ANTI, JoinType.RIGHT_OUTER],
                         ids=["INNER", "LEFT_OUTER", "LEFT_ANTI",
                              "RIGHT_OUTER"])
def test_empty_build_and_empty_stream(how):
    stream, build = _tables()
    for s, b in ((stream, build.slice(0, 0)), (stream.slice(0, 0), build)):
        got = collect(_port(s, b, how, True, TILES["one-tile"]))
        want = jexec.collect(_jax(s, b, how, True, TILES["one-tile"]))
        assert_tables_equal(got, want, ignore_order=True,
                            approx_float=False)


def test_one_row_build_sizes_the_expansion_by_live_rows():
    """Q11's shape: a one-row build against many stream rows expands to
    one slot a stream row, in one tile, whatever the build's capacity;
    the kept rows come out at their own bucket."""
    rng = np.random.default_rng(3)
    stream = pa.table({"v": rng.uniform(0, 100, 3000)})
    build = pa.table({"t": [50.0]})
    plan = BroadcastNestedLoopJoinExec(
        JoinType.INNER, InMemoryScanExec(stream, device="cpu"),
        BroadcastExchangeExec(InMemoryScanExec(build, device="cpu")),
        LessThan(col("t"), col("v")))
    assert list(plan._tiles(stream.num_rows, build.num_rows)) == [(0, 1)]
    [out] = list(plan.execute())
    plan.close()
    kept = int((stream.column("v").to_numpy() > 50.0).sum())
    assert int(out.num_rows) == kept
    assert out.capacity == 1 << (kept - 1).bit_length()
