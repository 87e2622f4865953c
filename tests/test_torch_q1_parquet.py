"""The Parquet slice as a whole: TPC-H Q1 and the part stage of TPC-H Q16
read from Parquet files through the port on the CPU, against the JAX
Session's ``collect`` of ``read_parquet(...)`` with the same predicate
pushed down and kept in a filter (the same physical tree, held node for
node against ``Session.last_plan``), and against pyarrow; the bench's scan
shape; row-group pruning counted alike on int32 dates; and the new entry
points asking for CUDA by default.

Keys, counts and strings match exactly; Q1's float aggregates within rel
1e-6, because the packages add float64 values in different orders. Each
JAX Session runs once."""

import numpy as np
import pyarrow as pa
import pyarrow.dataset as ds
import pytest
import torch

from spark_rapids_tpu.exec.sort import SortOrder as JSortOrder
from spark_rapids_tpu.expressions import col as jcol
from spark_rapids_tpu.expressions import lit as jlit
from spark_rapids_tpu.expressions.aggregates import Average as JAverage
from spark_rapids_tpu.expressions.aggregates import Count as JCount
from spark_rapids_tpu.expressions.aggregates import Sum as JSum
from spark_rapids_tpu.expressions.boolean import And as JAnd
from spark_rapids_tpu.expressions.comparison import EqualTo as JEqualTo
from spark_rapids_tpu.expressions.comparison import In as JIn
from spark_rapids_tpu.expressions.comparison import Not as JNot
from spark_rapids_tpu.expressions.strings import startswith as jstartswith
from spark_rapids_tpu.io.scan import read_parquet
from spark_rapids_tpu.plan import Session
from spark_rapids_tpu_torch import entry
from spark_rapids_tpu_torch.batch import to_arrow
from spark_rapids_tpu_torch.exec import collect
from spark_rapids_tpu_torch.io.source import ReaderType

from harness.asserts import assert_tables_equal

N, PARTS, FILES, SLICES, PARTITIONS = 6000, 4000, 4, 3, 4
CONF = {"spark.rapids.tpu.sql.incompatibleOps.enabled": True,
        "spark.rapids.tpu.sql.adaptive.enabled": False,
        "spark.rapids.tpu.shuffle.partitions": PARTITIONS}
TREE = ["SortExec", "HashAggregateExec", "ShuffleExchangeExec",
        "HashAggregateExec", "CoalesceBatchesExec", "FilterExec",
        "FileSourceScanExec[parquet]"]


def node(e):
    """What a tree node must agree on: exec class, partitioning keys and
    count, aggregate mode, coalesce goal, sort keys, and the output
    columns' names, kinds and nullability."""
    attrs = [type(e).__name__, e.name]
    part = getattr(e, "partitioning", None)
    if part is not None:
        attrs.append(tuple((k.ordinal, k.dtype.kind.value)
                           for k in getattr(part, "exprs", ())))
        attrs.append(part.num_partitions)
    if hasattr(e, "mode"):
        attrs.append(e.mode.name)
    if hasattr(e, "goal"):
        attrs.append(type(e.goal).__name__)
    if hasattr(e, "orders"):
        attrs.append(tuple((o.child.ordinal, o.descending)
                           for o in e.orders))
    if hasattr(e, "source"):
        attrs += [e.num_partitions, e.source.columns,
                  type(e.source.predicate).__name__,
                  e.source.effective_reader().value]
    attrs.append(tuple((f.name, f.dtype.kind.value, f.nullable)
                       for f in e.output_schema))
    return tuple(attrs)


def tree(e, depth=0):
    out = [(depth,) + node(e)]
    for c in e.children:
        out += tree(c, depth + 1)
    return out


def jax_q1(paths):
    cond = jcol("l_shipdate") <= jlit(entry.Q1_SHIPDATE_MAX)
    disc = jcol("l_extendedprice") * (jlit(1.0) - jcol("l_discount"))
    return (read_parquet(paths, columns=list(entry.Q1_COLUMNS),
                         predicate=cond, num_slices=SLICES)
            .where(cond)
            .group_by(*entry.Q1_KEYS)
            .agg(JSum(jcol("l_quantity")).alias("sum_qty"),
                 JSum(jcol("l_extendedprice")).alias("sum_base_price"),
                 JSum(disc).alias("sum_disc_price"),
                 JSum(disc * (jlit(1.0) + jcol("l_tax"))).alias("sum_charge"),
                 JAverage(jcol("l_quantity")).alias("avg_qty"),
                 JAverage(jcol("l_extendedprice")).alias("avg_price"),
                 JAverage(jcol("l_discount")).alias("avg_disc"),
                 JCount().alias("count_order"))
            .order_by(*[JSortOrder(jcol(k)) for k in entry.Q1_KEYS]))


def jax_q16_part(paths):
    cond = JAnd(JAnd(JNot(JEqualTo(jcol("p_brand"), jlit(entry.Q16_BRAND))),
                     JNot(jstartswith(jcol("p_type"),
                                      entry.Q16_TYPE_PREFIX))),
                JIn(jcol("p_size"), entry.Q16_SIZES))
    return (read_parquet(paths, columns=list(entry.Q16_KEYS), predicate=cond,
                         num_slices=SLICES)
            .where(cond)
            .group_by(*entry.Q16_KEYS)
            .agg(JCount().alias("part_cnt"))
            .order_by(JSortOrder(jcol("part_cnt"), True),
                      *[JSortOrder(jcol(k)) for k in entry.Q16_KEYS]))


def jax_session(df):
    ses = Session(CONF)
    return ses.collect(df), ses.last_plan


@pytest.fixture(scope="module")
def lineitem(tmp_path_factory):
    """Q1's table, sorted by l_shipdate so that the footer statistics of
    the last files prune row groups, in 4 files of 500-row row groups."""
    t = entry.lineitem_table(N, seed=8).sort_by("l_shipdate")
    paths = entry.parquet_files(t, str(tmp_path_factory.mktemp("li")),
                                FILES, row_group_size=500)
    return t, paths


@pytest.fixture(scope="module")
def q1_jax(lineitem):
    return jax_session(jax_q1(lineitem[1]))


@pytest.fixture(scope="module")
def part(tmp_path_factory):
    t = entry.part_table(PARTS, seed=3)
    return t, entry.parquet_files(t, str(tmp_path_factory.mktemp("part")),
                                  FILES)


@pytest.fixture(scope="module")
def q16_jax(part):
    return jax_session(jax_q16_part(part[1]))


def test_q1_parquet_matches_the_jax_session_and_pyarrow(lineitem, q1_jax):
    t, paths = lineitem
    plan = entry.q1_parquet_plan(paths, SLICES, PARTITIONS, device="cpu")
    got = collect(plan)
    assert got.num_rows == 6
    assert_tables_equal(got, q1_jax[0])
    assert_tables_equal(got, entry.q1_reference(t))
    assert_tables_equal(got, entry.run_q1(t, SLICES, PARTITIONS,
                                          device="cpu"))
    scan, jscan = plan, q1_jax[1]
    while scan.children:
        scan, jscan = scan.children[0], jscan.children[0]
    assert scan.source.row_groups_pruned == \
        jscan.source.row_groups_pruned > 0
    assert scan.source.row_groups_fallback == 0


def test_q1_parquet_tree_is_the_jax_planners(lineitem, q1_jax):
    plan = entry.q1_parquet_plan(lineitem[1], SLICES, PARTITIONS,
                                 device="cpu")
    assert tree(plan) == tree(q1_jax[1])
    assert [n[2] for n in tree(plan)] == TREE
    # the file schema is nullable: the scan and its filter carry validity
    assert all(f.nullable for f in plan.children[0].children[0].children[0]
               .children[0].children[0].output_schema)


def test_q16_part_parquet_matches_the_jax_session_and_pyarrow(part,
                                                              q16_jax):
    t, paths = part
    got = entry.run_q16_part_parquet(paths, SLICES, PARTITIONS,
                                     device="cpu")
    assert got.num_rows > 500
    assert got.equals(q16_jax[0])
    assert got.equals(entry.q16_part_reference(t))


def test_q16_part_parquet_tree_is_the_jax_planners(part, q16_jax):
    plan = entry.q16_part_parquet_plan(part[1], SLICES, PARTITIONS,
                                       device="cpu")
    assert tree(plan) == tree(q16_jax[1])


@pytest.mark.parametrize("reader", ["PERFILE", "COALESCING",
                                    "MULTITHREADED"])
def test_bench_scan_equals_the_pyarrow_dataset_read(tmp_path, reader):
    t = entry.lineitem_table(1 << 13, seed=3).drop(["l_tax"])
    paths = entry.parquet_files(t, str(tmp_path), 8)
    plan = entry.parquet_scan_plan(paths, reader_type=ReaderType[reader],
                                   device="cpu")
    got = pa.concat_tables(to_arrow(b, plan.output_schema)
                           for b in plan.execute())
    want = ds.dataset(paths).to_table(
        columns=list(entry.PARQUET_SCAN_COLUMNS),
        filter=ds.field("l_shipdate") <= entry.Q1_SHIPDATE_MAX)
    keys = [(c, "ascending") for c in want.column_names]
    assert got.sort_by(keys).equals(want.sort_by(keys))
    assert plan.source.effective_reader() is ReaderType[reader]


def test_parquet_files_cover_every_row(tmp_path):
    t = entry.lineitem_table(1001, seed=2)
    paths = entry.parquet_files(t, str(tmp_path), 8)
    back = pa.concat_tables(ds.dataset(p).to_table() for p in paths)
    assert len(paths) == 8 and back.equals(t)


@pytest.mark.parametrize("entry_point", [
    "q1_parquet_plan", "run_q1_parquet", "q16_part_parquet_plan",
    "run_q16_part_parquet", "parquet_scan_plan", "write_lineitem_bucketed"])
def test_parquet_entry_points_ask_for_cuda_by_default(monkeypatch, tmp_path,
                                                      entry_point):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    t = (entry.part_table(10) if "q16" in entry_point
         else entry.lineitem_table(10))
    paths = entry.parquet_files(t, str(tmp_path / "in"), 1)
    args = ((t, str(tmp_path / "out")) if entry_point.startswith("write")
            else (paths,))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        getattr(entry, entry_point)(*args)


def test_int32_date_pruning_counts_as_jax(tmp_path):
    """``l_shipdate`` is int32 here: both packages compare its decoded
    footer statistics with the int literal and prune the same row
    groups, in every reader."""
    from spark_rapids_tpu.io.parquet import ParquetSource as JSource
    from spark_rapids_tpu.io.source import ReaderType as JReaderType
    from spark_rapids_tpu_torch.expressions import col, lit
    from spark_rapids_tpu_torch.io.parquet import ParquetSource
    t = pa.table({"l_shipdate": np.arange(8000, 11000, dtype=np.int32)})
    paths = entry.parquet_files(t, str(tmp_path), 2, row_group_size=250)
    for reader in ("PERFILE", "COALESCING", "MULTITHREADED"):
        src = ParquetSource(paths, predicate=col("l_shipdate") <= lit(
            entry.Q1_SHIPDATE_MAX), reader_type=ReaderType[reader])
        jsrc = JSource(paths, predicate=jcol("l_shipdate") <= jlit(
            entry.Q1_SHIPDATE_MAX), reader_type=JReaderType[reader])
        got = pa.concat_tables(src.read_split(src.files))
        want = pa.concat_tables(jsrc.read_split(jsrc.files))
        assert got.equals(want) and got.num_rows == 2472
        assert src.row_groups_pruned == jsrc.row_groups_pruned == 2
