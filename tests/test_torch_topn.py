"""The port's partition-local sort and top-N against the JAX package's on
the CPU: ``SortExec(global_sort=False)`` batch for batch and row for row
over several partitions of several batches, and
``TakeOrderedAndProjectExec`` (per-batch sort and cut, a tournament across
batches, the projection) over ascending and descending keys with nulls,
limits below, at and above the row count, with and without a projection.
Keys are unique per row, so the order is defined and rows compare exactly
and in order.

The JAX side runs with ``jax_disable_jit``: each case's shapes differ."""

import jax
import numpy as np
import pyarrow as pa
import pytest

from spark_rapids_tpu import exec as jexec
from spark_rapids_tpu.batch import to_arrow as jto_arrow
from spark_rapids_tpu.exec.sort import SortOrder as JSortOrder
from spark_rapids_tpu.exec.sort import \
    TakeOrderedAndProjectExec as JTakeOrdered
from spark_rapids_tpu.expressions import col as jcol
from spark_rapids_tpu_torch.batch import to_arrow
from spark_rapids_tpu_torch.exec import (InMemoryScanExec, SortExec,
                                         SortOrder,
                                         TakeOrderedAndProjectExec, collect)
from spark_rapids_tpu_torch.expressions import col

from harness.asserts import assert_tables_equal

SLICES, BATCH_ROWS = 3, 50


@pytest.fixture(autouse=True)
def _jax_eager():
    with jax.disable_jit():
        yield


def _table(n=400, seed=17):
    """A unique (a, b) key per row, a with nulls; c a string payload."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 40, n)
    b = rng.permutation(n)
    return pa.table({
        "a": pa.array(a, mask=rng.random(n) < 0.1),
        "b": b.astype(np.int64),
        "c": pa.array(rng.choice(["p", "qq", "rrr", ""], n)),
        "f": rng.uniform(-5, 5, n),
    })


#: (column, descending, nulls_first) sort keys
ORDERS = {
    "a_asc_b_desc": (("a", False, None), ("b", True, None)),
    "a_desc_nulls_first_b": (("a", True, True), ("b", False, None)),
    "f_desc": (("f", True, None),),
}


def _scans(t):
    kw = dict(batch_rows=BATCH_ROWS, num_slices=SLICES)
    return (InMemoryScanExec(t, device="cpu", **kw),
            jexec.InMemoryScanExec(t, **kw))


@pytest.mark.parametrize("order", list(ORDERS), ids=list(ORDERS))
def test_partition_local_sort_matches_jax(order):
    t = _table()
    scan, jscan = _scans(t)
    keys = ORDERS[order]
    plan = SortExec([SortOrder(col(c), d, nf) for c, d, nf in keys], scan,
                    global_sort=False)
    jplan = jexec.SortExec([JSortOrder(jcol(c), d, nf) for c, d, nf in keys],
                           jscan, global_sort=False)
    assert plan.num_partitions == jplan.num_partitions == SLICES
    for p in range(SLICES):
        got = [to_arrow(b, plan.output_schema)
               for b in plan.execute_partition(p)]
        want = [jto_arrow(b, jplan.output_schema)
                for b in jplan.execute_partition(p)]
        assert len(got) == len(want) > 1
        for g, w in zip(got, want):
            assert_tables_equal(g, w, approx_float=False)
    # each batch is sorted on its own, not the partition
    first = to_arrow(next(iter(plan.execute_partition(0))),
                     plan.output_schema)
    assert first.num_rows == BATCH_ROWS


@pytest.mark.parametrize("limit", [1, 7, 50, 400, 1000])
@pytest.mark.parametrize("order", list(ORDERS), ids=list(ORDERS))
def test_take_ordered_and_project_matches_jax(order, limit):
    t = _table()
    scan, jscan = _scans(t)
    keys = ORDERS[order]
    project = ["b", "c", "a"] if limit % 2 else None
    plan = TakeOrderedAndProjectExec(
        limit, [SortOrder(col(c), d, nf) for c, d, nf in keys],
        [col(x) for x in project] if project else None, scan)
    jplan = JTakeOrdered(
        limit, [JSortOrder(jcol(c), d, nf) for c, d, nf in keys],
        [jcol(x) for x in project] if project else None, jscan)
    got = collect(plan)
    want = jexec.collect(jplan)
    assert plan.num_partitions == 1
    assert got.num_rows == min(limit, t.num_rows)
    assert got.column_names == (project or t.column_names)
    assert_tables_equal(got, want, approx_float=False)
    # the first rows of the whole table in that order (nulls first)
    if order == "a_asc_b_desc":
        rows = sorted(zip(t.column("a").to_pylist(),
                          t.column("b").to_pylist()),
                      key=lambda r: (r[0] is not None, r[0] or 0, -r[1]))
        assert got.column("b").to_pylist() == [b for _, b in rows][:limit]


def test_take_ordered_over_no_rows_yields_nothing():
    t = _table().slice(0, 0)
    scan = InMemoryScanExec(t, device="cpu")
    plan = TakeOrderedAndProjectExec(5, [SortOrder(col("b"))], None, scan)
    assert collect(plan).num_rows == 0
