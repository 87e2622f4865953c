"""The whole slice: TPC-H Q1 through the port on the CPU against the JAX
Session (the same physical tree) and against pyarrow; the filter and sort
operators against the JAX package's; and the guards that keep the port
free of JAX and off a silent CPU fallback.

Keys and counts match exactly; float aggregates within rel 1e-6, because
the packages add float64 values in different orders."""

import ast
import pathlib
import subprocess
import sys

import pytest
import torch

from spark_rapids_tpu import exec as jexec
from spark_rapids_tpu.exec.sort import SortOrder as JSortOrder
from spark_rapids_tpu.expressions import col as jcol
from spark_rapids_tpu.expressions import lit as jlit
from spark_rapids_tpu.expressions.aggregates import Average, Count, Sum
from spark_rapids_tpu.plan import Session, table
from spark_rapids_tpu_torch import entry
from spark_rapids_tpu_torch.exec import (FilterExec, InMemoryScanExec,
                                         ProjectExec, SortExec, collect, desc)
from spark_rapids_tpu_torch.exec import asc
from spark_rapids_tpu_torch.expressions import col, lit

from harness.asserts import assert_tables_equal
from harness.data_gen import (BooleanGen, DateGen, DoubleGen, IntegerGen,
                              LongGen, gen_table)

ROOT = pathlib.Path(__file__).resolve().parent.parent
N, SLICES = 4000, 4


def _jax_q1(t, num_slices):
    disc = jcol("l_extendedprice") * (jlit(1.0) - jcol("l_discount"))
    df = (table(t, num_slices=num_slices,
                batch_rows=-(-t.num_rows // num_slices))
          .where(jcol("l_shipdate") <= jlit(entry.Q1_SHIPDATE_MAX))
          .group_by(*entry.Q1_KEYS)
          .agg(Sum(jcol("l_quantity")).alias("sum_qty"),
               Sum(jcol("l_extendedprice")).alias("sum_base_price"),
               Sum(disc).alias("sum_disc_price"),
               Sum(disc * (jlit(1.0) + jcol("l_tax"))).alias("sum_charge"),
               Average(jcol("l_quantity")).alias("avg_qty"),
               Average(jcol("l_extendedprice")).alias("avg_price"),
               Average(jcol("l_discount")).alias("avg_disc"),
               Count().alias("count_order"))
          .order_by(*[JSortOrder(jcol(k)) for k in entry.Q1_KEYS]))
    ses = Session({"spark.rapids.tpu.sql.incompatibleOps.enabled": True})
    return ses.collect(df), ses.executed_exec_names()


@pytest.fixture(scope="module")
def q1_jax():
    t = entry.lineitem_table(N)
    result, names = _jax_q1(t, SLICES)
    return t, result, names


def test_q1_matches_jax_session_and_pyarrow(q1_jax):
    t, jax_result, _ = q1_jax
    got = entry.run_q1(t, num_slices=SLICES, shuffle_partitions=8,
                       device="cpu")
    assert got.column_names == jax_result.column_names
    assert got.num_rows == 6
    assert_tables_equal(got, jax_result)
    assert_tables_equal(got, entry.q1_reference(t))


def test_q1_plan_is_the_jax_planners_tree(q1_jax):
    t, _, jax_names = q1_jax
    plan = entry.q1_plan(t, num_slices=SLICES, device="cpu")
    assert plan.exec_names() == jax_names == [
        "SortExec", "HashAggregateExec", "ShuffleExchangeExec",
        "HashAggregateExec", "CoalesceBatchesExec", "FilterExec",
        "InMemoryScanExec"]


@pytest.mark.parametrize("rows,slices,partitions", [
    (3000, 1, 1), (3001, 3, 5), (0, 2, 4), (50, 8, 8)])
def test_q1_shapes_match_pyarrow(rows, slices, partitions):
    t = entry.lineitem_table(rows, seed=rows)
    got = entry.run_q1(t, slices, partitions, device="cpu")
    exp = entry.q1_reference(t)
    assert got.schema.names == exp.schema.names
    assert_tables_equal(got, exp)


def test_run_q1_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        entry.run_q1(entry.lineitem_table(10))


def _gens():
    return [("i", IntegerGen(min_val=-3, max_val=3)),
            ("l", LongGen(min_val=-2, max_val=2)),
            ("d", DoubleGen()), ("b", BooleanGen()), ("t", DateGen())]


@pytest.mark.parametrize("descending", [False, True], ids=["asc", "desc"])
def test_sort_matches_jax(descending):
    """Nullable keys of every kind (NaN, inf and -0.0 among the doubles)."""
    t = gen_table(_gens(), n=700, seed=31)
    keys = ["b", "i", "t", "d", "l"]
    jplan = jexec.SortExec([JSortOrder(jcol(k), descending) for k in keys],
                           jexec.InMemoryScanExec(t, batch_rows=300))
    order = desc if descending else asc
    plan = SortExec([order(col(k)) for k in keys],
                    InMemoryScanExec(t, batch_rows=300, num_slices=2,
                                     device="cpu"))
    assert_tables_equal(collect(plan), jexec.collect(jplan),
                        approx_float=False)


def _project(c, lt):
    """int32 products and sums that wrap (non-ANSI), int64 and double
    arithmetic, nulls propagating, a comparison and a bare reference."""
    return [(c("i") * lt(2_000_000_000) + c("i")).alias("wrap32"),
            (c("l") - c("i") * lt(3)).alias("mixed"),
            (lt(1.5) - c("d") * c("d")).alias("dbl"),
            (c("t") <= lt(0)).alias("le"), c("b")]


@pytest.mark.parametrize("operator", ["filter", "project"])
def test_narrow_operator_matches_jax(operator):
    t = gen_table(_gens(), n=900, seed=32)
    jscan = jexec.InMemoryScanExec(t, batch_rows=400)
    scan = InMemoryScanExec(t, batch_rows=400, device="cpu")
    if operator == "filter":
        jplan = jexec.FilterExec(jcol("t") <= jlit(0), jscan)
        plan = FilterExec(col("t") <= lit(0), scan)
    else:
        jplan = jexec.ProjectExec(_project(jcol, jlit), jscan)
        plan = ProjectExec(_project(col, lit), scan)
    # filtered rows are copied bit for bit; XLA may contract the projected
    # multiply-add into one fused rounding, so doubles there agree to 1 ulp
    assert_tables_equal(collect(plan), jexec.collect(jplan),
                        approx_float=operator == "project")


def test_operator_metrics_count_rows_and_batches():
    t = entry.lineitem_table(3000, seed=9)
    plan = entry.q1_plan(t, num_slices=3, shuffle_partitions=4, device="cpu")
    collect(plan)
    ops = {}
    node = plan
    while True:
        ops[node.name] = ops.get(node.name, node)
        if not node.children:
            break
        node = node.children[0]
    passed = sum(d <= entry.Q1_SHIPDATE_MAX
                 for d in t.column("l_shipdate").to_pylist())
    scan, filt = ops["InMemoryScanExec"], ops["FilterExec"]
    assert scan.metrics["numOutputRows"].total() == 3000
    assert scan.metrics["numOutputBatches"].total() == 3
    assert filt.metrics["numOutputRows"].total() == passed
    assert plan.metrics["numOutputRows"].total() == 6
    assert plan.metrics["opTime"].total() > 0


def _port_sources():
    """Every Python source of the port, less ``_build/`` (gitignored build
    output, which may hold an unpacked checkout of the whole repo)."""
    pkg = ROOT / "spark_rapids_tpu_torch"
    return sorted(p for p in pkg.rglob("*.py")
                  if "_build" not in p.relative_to(pkg).parts) + [
        ROOT / "chip_smoke.py"]


def test_port_sources_import_no_jax():
    for path in _port_sources():
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                assert top not in ("jax", "jaxlib", "flax",
                                   "spark_rapids_tpu"), (path, name)


def test_importing_the_port_loads_no_jax():
    code = (
        "import pkgutil, sys\n"
        "import spark_rapids_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    __import__(m.name)\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('jax', 'jaxlib', 'flax', 'spark_rapids_tpu')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
