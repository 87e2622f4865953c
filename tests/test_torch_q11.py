"""TPC-H Q11 through the port on the CPU: the tree node for node against the
JAX Session's ``last_plan`` for the same DataFrame (AQE off, the broadcast
threshold of ``test_torch_q2``), its rows against the JAX Session's and
against pyarrow. The HAVING against the scalar subquery runs as a
nested-loop join of the grouped sums with the one-row global sum.

The row set compares exactly and ``value`` within rel 1e-6: the packages
and pyarrow add the float64 products in different orders. A group within
about 1e-12 of the threshold could then flip, so each check also asserts
the smallest relative margin between a group's value and the threshold.
The JAX Session runs once."""

import numpy as np
import pyarrow.compute as pc
import pytest

from spark_rapids_tpu.plan import Session
from spark_rapids_tpu_torch import entry
from spark_rapids_tpu_torch.exec import collect

from harness.asserts import assert_tables_equal
from test_torch_q2 import CONF, PARTITIONS, SF, SLICES, jax_q11, tree

FRACTION = entry.q11_fraction(SF)
#: no group's value lies this close (relative) to the threshold
MIN_MARGIN = 1e-9


@pytest.fixture(scope="module")
def tables():
    _, supplier, partsupp, nation, _ = entry.tpch_q2_tables(SF)
    return partsupp, supplier, nation


@pytest.fixture(scope="module")
def jax_run(tables):
    ses = Session(CONF)
    rows = ses.collect(jax_q11(*tables, FRACTION))
    return rows, ses.last_plan


def _plan(tables, fraction=FRACTION):
    return entry.q11_plan(*tables, fraction, SLICES, PARTITIONS,
                          device="cpu")


def margin(tables, fraction) -> float:
    """The smallest relative distance between a group's value and the
    threshold, by pyarrow."""
    groups, total = entry.q11_groups_reference(*tables)
    threshold = total * fraction
    v = groups.column("value").to_numpy()
    return float(np.min(np.abs(v - threshold)) / threshold)


def _by_key(t):
    return t.sort_by("ps_partkey")


def test_q11_tree_matches_the_jax_planner(tables, jax_run):
    got = tree(_plan(tables))
    assert got == tree(jax_run[1])
    assert got[2][1] == "BroadcastNestedLoopJoinExec"


def test_q11_matches_the_jax_session(tables, jax_run):
    got = collect(_plan(tables))
    want = jax_run[0]
    assert got.num_rows == want.num_rows > 0
    assert_tables_equal(_by_key(got), _by_key(want))
    v = got.column("value").to_numpy()
    assert np.all(v[:-1] >= v[1:])          # ORDER BY value DESC


@pytest.mark.parametrize("fraction", [FRACTION, FRACTION / 8],
                         ids=["spec", "fraction-8th"])
def test_q11_matches_pyarrow(tables, fraction):
    assert margin(tables, fraction) > MIN_MARGIN
    got = collect(_plan(tables, fraction))
    want = entry.q11_reference(*tables, fraction)
    assert_tables_equal(_by_key(got), _by_key(want))
    assert got.num_rows < entry.q11_groups_reference(*tables)[0].num_rows


def test_q11_with_no_german_supplier_is_empty(tables):
    """No row passes the nation filter: the groups are empty and the
    global sum is null, so no row meets the HAVING."""
    partsupp, supplier, nation = tables
    no_germans = supplier.filter(pc.not_equal(supplier.column("s_nationkey"),
                                              7))
    assert collect(_plan((partsupp, no_germans, nation))).num_rows == 0
