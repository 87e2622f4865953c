"""TPC-H Q1, the part stage of TPC-H Q16 and Q16 whole, TPC-H Q3, Q18, Q2,
Q11, Q14 and Q9, order baskets and P_NAME words over Q9's tables (the
nested kinds, ``collect_set``, ``split`` and ``explode``) and the repo's
skewed join through the port, end to end,
Q1 and the Q16 part stage read from Parquet files, a bucketed Parquet
write, and the bench's fused Q1 stage and its hash_agg, join_sort and
parquet_scan shapes.

``q1_plan`` and ``q16_part_plan`` build the physical tree the JAX
package's planner gives each query (``plan/overrides.py``
``_convert_aggregate``)::

    InMemoryScanExec -> FilterExec -> CoalesceBatchesExec
      -> HashAggregateExec(PARTIAL)
      -> ShuffleExchangeExec(HashPartitioning(group keys))
      -> HashAggregateExec(FINAL) -> SortExec

and ``run_q1`` and ``run_q16_part`` collect it to a ``pyarrow.Table``.

Q1's select list is the full TPC-H Q1 (TPC-H spec 2.4.1) with its eight
aggregates. Flags are int32 and money float64, the repo's stand-ins for
CHAR(1) and DECIMAL(15,2). ``lineitem_table`` makes the input from a numpy
seed (the columns of ``bench.lineitem_table`` plus ``l_tax``).

The Q16 part stage is TPC-H Q16 (spec 2.4.16) up to its join::

    SELECT p_brand, p_type, p_size, count(*) AS part_cnt FROM part
    WHERE p_brand <> 'Brand#45' AND p_type NOT LIKE 'MEDIUM POLISHED%'
      AND p_size IN (49, 14, 23, 45, 19, 3, 36, 9)
    GROUP BY p_brand, p_type, p_size
    ORDER BY part_cnt DESC, p_brand, p_type, p_size

with the LIKE as Spark's LikeSimplification leaves it, ``NOT
StartsWith(p_type, 'MEDIUM POLISHED')``, and strings at the JAX Session's
scan width of 64 bytes. It counts parts per group where Q16 counts distinct
suppliers. ``part_table`` makes dbgen-shaped ``part`` columns (spec 4.2.3)
from a numpy seed.

Q16 whole (spec 2.4.16 with its validation parameters) runs through the
port's Session: ``q16_df`` is the part filter above, the join with
``partsupp``, ``ps_suppkey NOT IN`` the suppliers whose comment is
``LIKE '%Customer%Complaints%'`` (a LEFT ANTI join: the key is never
null), and count(DISTINCT ps_suppkey) as Spark rewrites it (a group-by on
the keys and ps_suppkey, then a count per key), sorted by the count
descending and the keys; ``run_q16`` collects it. ``tpch_q16_tables``
makes its ``part``, ``supplier`` and ``partsupp`` columns as dbgen draws
them.

Q3 is TPC-H Q3 (spec 2.4.3) with its validation parameters::

    SELECT l_orderkey, sum(l_extendedprice * (1 - l_discount)) AS revenue,
           o_orderdate, o_shippriority
    FROM customer, orders, lineitem
    WHERE c_mktsegment = 'BUILDING' AND c_custkey = o_custkey
      AND l_orderkey = o_orderkey AND o_orderdate < date '1995-03-15'
      AND l_shipdate > date '1995-03-15'
    GROUP BY l_orderkey, o_orderdate, o_shippriority
    ORDER BY revenue DESC, o_orderdate LIMIT 10

``q3_plan`` builds the tree the JAX planner gives it with AQE off: two
inner hash joins, each with its build side swapped to the smaller input and
a projection restoring the column order, over co-partitioned inputs
(``broadcast=False``, the planner's choice once every build side is over its
broadcast threshold, as at SF10) or over broadcast builds. ``tpch_q3_tables``
makes dbgen-shaped ``customer``, ``orders`` and ``lineitem`` columns (spec
4.2.3) from a numpy seed.

Q18 is TPC-H Q18 (spec 2.4.18, "Large Volume Customer") with its
validation parameter (QUANTITY 300; ``quantity`` sets another)::

    SELECT c_name, c_custkey, o_orderkey, o_orderdate, o_totalprice,
           sum(l_quantity)
    FROM customer, orders, lineitem
    WHERE o_orderkey IN (SELECT l_orderkey FROM lineitem GROUP BY l_orderkey
                         HAVING sum(l_quantity) > 300)
      AND c_custkey = o_custkey AND o_orderkey = l_orderkey
    GROUP BY c_name, c_custkey, o_orderkey, o_orderdate, o_totalprice
    ORDER BY o_totalprice DESC, o_orderdate LIMIT 100

``q18_plan`` builds the tree the JAX planner gives it with AQE off and
every join shuffled: the IN subquery as a LEFT SEMI join of orders with the
filtered lineitem aggregate, the customer join with its build side swapped
to customer, and the last join building on lineitem, which at SF10 over 2
partitions is past ``max_build_rows`` and takes the grace join. Its
``device_limit`` gives the tree a buffer catalog of its own with that
budget (else the device's process-wide one). ``tpch_q18_tables`` makes the
columns Q18 reads from the same draws as ``tpch_q3_tables``.

Q14 and Q9 (spec 2.4.14 and 2.4.9, with their validation parameters) run
through the port's Session: ``q14_df`` is September 1995's lineitem (the
upper bound ``add_months``), joined with part, and 100 times a CASE WHEN sum
over ``startswith(p_type, 'PROMO')`` over the whole sum; ``q9_df`` joins
lineitem with the parts whose name holds 'green' (``contains``), supplier,
partsupp on two keys, orders and nation, and sums the profit by nation and
``year(o_orderdate)``. ``tpch_q14_tables`` and ``tpch_q9_tables`` make
their columns from the draws of ``tpch_q3_tables`` with the part keys
drawn last (``tpch_q14_q9_tables``: both from one draw); ``run_q14``,
``run_q9``, ``q14_reference`` and ``q9_reference``.

Q2 and Q11 (spec 2.4.2 and 2.4.11) run over ``tpch_q2_tables``: ``q2_plan``
decorrelates Q2's Min subquery into a grouped Min joined on two keys, and
``q11_plan`` runs Q11's HAVING against its scalar subquery as a
nested-loop join with the one-row global sum; each builds the tree the JAX
planner gives it at SF100.

With ``adaptive=True`` (and the knobs ``target_rows``, ``skew_split_rows``
and ``broadcast_switch_rows``, the JAX package's defaults), ``q3_plan``
and ``q18_plan`` build the tree the JAX Session gives under its default
adaptive conf: adaptive exchanges, shuffled joins that lay out their reads
together, split skewed partitions and switch a small build to a broadcast
at run time, and an aggregate exchange only where its child reads as more
than one partition (``Adaptive``). ``skew_tables`` makes
``tools/skew_bench.py``'s skewed fact and dim tables, ``skew_plan`` and
``run_skew`` its query in each of its legs (``SKEW_LEGS``), and
``skew_reference`` its pyarrow answer.

``q1_stage`` is ``__graft_entry__._q1_stage``, the JAX ``entry()`` shape:
Q1's filter fused into a COMPLETE aggregate's update. ``hash_agg_table``
and ``hash_agg_plan`` are ``bench.bench_hash_agg``'s input and aggregate.
``join_sort_tables`` and ``join_sort_plan`` are ``bench.bench_join_sort``'s
inputs (resident on the device, one batch each) and its inner join and
sort; ``join_sort_runner`` and ``run_join_sort`` run that stage through the
captured CUDA graph of the fused stage (``exec/fuse.py``), the eager fused
program or the iterator path.

From Parquet files (``io/``): ``parquet_files`` writes a table as files of
consecutive rows; ``parquet_scan_plan`` is ``bench.bench_parquet_scan``'s
scan (three lineitem columns where ``l_shipdate <= 10471``, MULTITHREADED);
``q1_parquet_plan`` and ``q16_part_parquet_plan`` (``run_q1_parquet``,
``run_q16_part_parquet``) are Q1's and the Q16 part stage's trees with a
``FileSourceScanExec`` in place of the in-memory scan, the predicate pushed
down and kept in the ``FilterExec`` above it, as the JAX planner gives
``read_parquet(...).where(...)``; ``write_lineitem_bucketed`` writes a
table through ``io.writer.write_plan`` into bucket files on the int32
``l_shipdate``.

Each path is also a DataFrame of the port's planner (``plan/``):
``q1_df``, ``q16_part_df``, ``q3_df``, ``q18_df``, ``q2_df``, ``q11_df``,
``q1_stage_df``, ``hash_agg_df``, ``join_sort_df`` and ``parquet_scan_df``,
written as the JAX tests write them, for ``plan.Session`` under
``session_conf()``; the Session gives each the hand-built ``*_plan``'s
tree (``q1_stage_plan`` for the Q1 stage's query).

On the mesh (``shuffle.mode=ICI``, ``parallel/``): ``ici_conf`` is the
ICI shuffle and a shard count (add it to a base conf with ``**``), under
which ``q1_df`` lowers to
one ``MeshStageExec``; ``ici_exchange_tables`` and ``ici_exchange_df``
are the bench's fifth shape (``bench.bench_ici_exchange``: a planned
broadcast join and a group-by); ``mesh_chain_tables`` and
``mesh_chain_df`` are ``__graft_entry__.dryrun_multichip``'s filter,
shuffled join, group-by and global sort, which ``dryrun_multigpu`` runs
on the mesh against the port's row interpreter.

The part-catalogue roll-up: ``catalog_df`` (``run_catalog``) cleans
TPC-H part's P_TYPE and P_BRAND with ``regexp_extract``,
``regexp_replace``, ``find_in_set`` and ``initcap``, groups by the cleaned
columns and formats the groups with ``concat_ws``, ``bin``,
``format_number``, ``hex``, ``conv`` and ``empty2null``;
``comment_spans_df`` runs the span scans over S_COMMENT.
``catalog_reference`` and ``comment_spans_reference`` compute the same
with pyarrow and Python.

Two TPC-DS-shaped window paths run over TPC-H's orders and lineitem
(``tpch_window_tables``): ``customer_history_df`` is TPC-DS q51's running
sum and q67/q70's ``rank() <= N`` per customer (three window specs:
row_number, a ROWS running sum and lag; a 90-day RANGE sum; the rank by
price), and ``supplier_months_df`` is q47's shape (monthly sales per
supplier, their yearly average over the full frame, rank, lag, lead and a
three-month moving average, the 10% deviation filter, its top 100).
``customer_history_reference`` and ``supplier_months_reference`` compute
the same with numpy and pyarrow.

``q1_reference``, ``q16_part_reference``, ``q16_reference``,
``q3_reference``,
``q18_reference``, ``q2_reference``, ``q11_reference``,
``hash_agg_reference``, ``join_sort_reference``, ``skew_reference``,
``ici_exchange_reference`` and ``mesh_chain_reference`` compute the same
with pyarrow alone, as independent oracles.
"""

from __future__ import annotations

import datetime
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc

from . import types as T
from .batch import (ColumnarBatch, DeviceLike, Field, Schema, empty_batch,
                    from_arrow, resolve_device, schema_from_arrow, to_arrow)
from .config import (ADAPTIVE_BROADCAST_MAX_BUILD_ROWS, ADAPTIVE_TARGET_ROWS,
                     JOIN_MAX_BUILD_ROWS, SKEW_SPLIT_ROWS)
from .exec import (AggregateMode, BroadcastNestedLoopJoinExec,
                   CoalesceBatchesExec, Exec, FilterExec, GlobalLimitExec,
                   HashAggregateExec, HashJoinExec, InMemoryScanExec,
                   JoinType, ProjectExec, SortExec, TargetSize, asc, collect,
                   desc)
from .exec.common import concat_all
from .exec.fuse import try_fuse
from .exec.sort import SortOrder
from .expressions import (And, BoundReference, CaseWhen, EqualTo,
                          Expression, GreaterThan, In, Not, add_months, col,
                          contains, endswith, lit, startswith, year)
from .expressions.aggregates import Average, Count, Min, Sum
from .expressions.base import epoch_days
from .expressions.regex import Like
from .memory.catalog import BufferCatalog
from .shuffle import (BroadcastExchangeExec, HashPartitioning,
                      ShuffleExchangeExec, SinglePartitioning)

#: l_shipdate <= date '1998-12-01' - interval '90' day, in epoch days
Q1_SHIPDATE_MAX = 10471

Q1_KEYS = ("l_returnflag", "l_linestatus")

#: the JAX Session's scan width for string columns (config.STRING_MAX_BYTES)
STRING_MAX_LEN = 64


def q1_aggregates():
    disc_price = col("l_extendedprice") * (lit(1.0) - col("l_discount"))
    return [
        Sum(col("l_quantity")).alias("sum_qty"),
        Sum(col("l_extendedprice")).alias("sum_base_price"),
        Sum(disc_price).alias("sum_disc_price"),
        Sum(disc_price * (lit(1.0) + col("l_tax"))).alias("sum_charge"),
        Average(col("l_quantity")).alias("avg_qty"),
        Average(col("l_extendedprice")).alias("avg_price"),
        Average(col("l_discount")).alias("avg_disc"),
        Count().alias("count_order"),
    ]


def _scan(table: pa.Table, num_slices: int, device: DeviceLike,
          catalog: Optional[BufferCatalog] = None,
          string_max_len: int = STRING_MAX_LEN) -> InMemoryScanExec:
    """The scan of ``table`` in ``num_slices`` input partitions of one batch
    each, its string columns ``string_max_len`` bytes wide. Column
    nullability is read from the data (null counts), as
    ``batch.from_arrow`` does. ``catalog`` is the tree's buffer catalog
    (default: the device's process-wide one)."""
    dev = resolve_device(device)
    schema = Schema([Field(f.name, f.dtype,
                           f.nullable and table.column(i).null_count > 0)
                     for i, f in enumerate(schema_from_arrow(
                         table.schema, string_max_len))])
    batch_rows = max(1, -(-table.num_rows // num_slices))
    return InMemoryScanExec(table, schema, batch_rows=batch_rows,
                            num_slices=num_slices, device=dev,
                            catalog=catalog)


def _grouped_stage(scan: Exec, condition: Expression, keys: Sequence[str],
                   aggregates, shuffle_partitions: int,
                   orders: Sequence[SortOrder]) -> Exec:
    """Filter, coalesce, partial aggregate, hash exchange on the keys
    (over more than one partition), final aggregate and sort: the JAX
    planner's tree for a grouped query."""
    final = Adaptive.OFF.grouped(
        CoalesceBatchesExec(FilterExec(condition, scan)), keys, aggregates,
        shuffle_partitions)
    return SortExec(orders, final)


def q1_plan(table: pa.Table, num_slices: int = 8,
            shuffle_partitions: int = 8, device: DeviceLike = None) -> Exec:
    """Q1's physical tree over ``table``."""
    return _grouped_stage(
        _scan(table, num_slices, device),
        col("l_shipdate") <= lit(Q1_SHIPDATE_MAX), Q1_KEYS, q1_aggregates,
        shuffle_partitions, [asc(col(k)) for k in Q1_KEYS])


def run_q1(table: pa.Table, num_slices: int = 8,
           shuffle_partitions: int = 8, device: DeviceLike = None
           ) -> pa.Table:
    """Q1 over ``table``, collected to the host."""
    return collect(q1_plan(table, num_slices, shuffle_partitions, device))


def lineitem_table(n: int, seed: int = 3) -> pa.Table:
    """Lineitem-shaped input: the columns of ``bench.lineitem_table``, in
    its draw order, then ``l_tax`` uniform in [0, 0.08]."""
    rng = np.random.default_rng(seed)
    return pa.table({
        "l_returnflag": rng.integers(0, 3, n).astype(np.int32),
        "l_linestatus": rng.integers(0, 2, n).astype(np.int32),
        "l_quantity": rng.integers(1, 51, n).astype(np.int64),
        "l_extendedprice": rng.uniform(1.0, 1e5, n),
        "l_discount": rng.uniform(0.0, 0.1, n),
        "l_shipdate": rng.integers(8000, 11000, n).astype(np.int32),
        "l_tax": rng.uniform(0.0, 0.08, n),
    })


def q1_reference(table: pa.Table) -> pa.Table:
    """Q1 computed by pyarrow alone, in ``run_q1``'s column order."""
    f = table.filter(pc.less_equal(table.column("l_shipdate"),
                                   Q1_SHIPDATE_MAX))
    disc = pc.multiply(f.column("l_extendedprice"),
                       pc.subtract(1.0, f.column("l_discount")))
    charge = pc.multiply(disc, pc.add(1.0, f.column("l_tax")))
    f = f.append_column("disc_price", disc).append_column("charge", charge)
    aggs = [("l_quantity", "sum"), ("l_extendedprice", "sum"),
            ("disc_price", "sum"), ("charge", "sum"), ("l_quantity", "mean"),
            ("l_extendedprice", "mean"), ("l_discount", "mean"),
            ("l_quantity", "count")]       # count(*): no column is null
    g = f.group_by(list(Q1_KEYS)).aggregate(aggs)
    g = g.sort_by([(k, "ascending") for k in Q1_KEYS])
    columns = list(Q1_KEYS) + [f"{c}_{fn}" for c, fn in aggs]
    names = list(Q1_KEYS) + [a.name for a in q1_aggregates()]
    return pa.table([g.column(c) for c in columns], names=names)


def q1_stage_aggregates():
    """The six aggregates of ``__graft_entry__._q1_stage``."""
    return [Sum(col("l_quantity")).alias("sum_qty"),
            Sum(col("l_extendedprice")).alias("sum_base_price"),
            Sum(col("l_extendedprice") * (lit(1.0) - col("l_discount"))
                ).alias("sum_disc_price"),
            Average(col("l_quantity")).alias("avg_qty"),
            Average(col("l_discount")).alias("avg_disc"),
            Count().alias("count_order")]


def q1_stage_plan(table: pa.Table, device: DeviceLike = None) -> Exec:
    """The tree the planner gives the fused Q1 stage's query over
    ``table`` in one slice (``q1_stage_df``): the filter, a coalesce, and
    the PARTIAL and FINAL aggregates with no exchange between them (one
    partition)."""
    return Adaptive.OFF.grouped(
        CoalesceBatchesExec(FilterExec(
            col("l_shipdate") <= lit(Q1_SHIPDATE_MAX),
            _scan(table, 1, device))), Q1_KEYS, q1_stage_aggregates, 1)


def q1_stage(schema: Schema, device: DeviceLike = None):
    """The fused Q1 stage, the counterpart of ``__graft_entry__._q1_stage``:
    ``(stage, partial, final, cond)``, where ``stage(batch)`` is the filter
    ``l_shipdate <= 10471`` fused into a COMPLETE aggregate's update as a
    live-row mask (filtered rows sort last like padding, with no
    compaction) and returns its buffer-layout batch; ``partial`` and
    ``final`` are the PARTIAL and FINAL aggregates of the same functions
    over a placeholder scan of ``schema``, and ``cond`` the bound filter."""
    dev = resolve_device(device)
    placeholder = InMemoryScanExec([empty_batch(schema, dev)], schema=schema)
    keys = [col("l_returnflag"), col("l_linestatus")]
    agg = HashAggregateExec(keys, q1_stage_aggregates(), placeholder,
                            AggregateMode.COMPLETE)
    cond = (col("l_shipdate") <= lit(Q1_SHIPDATE_MAX)).bind(schema)

    def stage(batch: ColumnarBatch) -> ColumnarBatch:
        c = cond.eval(batch)
        return agg._update_kernel(batch, c.data & c.validity)

    named = [a.alias(n) for a, n in zip(agg.aggs, agg.agg_names)]
    partial = HashAggregateExec(agg.group_exprs, named, placeholder,
                                AggregateMode.PARTIAL)
    final = HashAggregateExec(keys, named, partial, AggregateMode.FINAL)
    return stage, partial, final, cond


# ---------------------------------------------------------------------------
# The bench's hash_agg shape
# ---------------------------------------------------------------------------

HASH_AGG_KEYS = ("ss_item_sk",)


def hash_agg_table(n: int, n_keys: int, seed: int = 5) -> pa.Table:
    """Store-sales-shaped input, the draws of ``bench.store_sales_table``:
    ``ss_item_sk`` uniform over ``n_keys`` keys, ``ss_quantity`` in 1..99,
    ``ss_sales_price`` in [0.5, 500), ``ss_net_profit`` in [-100, 400)."""
    rng = np.random.default_rng(seed)
    return pa.table({
        "ss_item_sk": rng.integers(0, n_keys, n).astype(np.int32),
        "ss_quantity": rng.integers(1, 100, n).astype(np.int64),
        "ss_sales_price": rng.uniform(0.5, 500.0, n),
        "ss_net_profit": rng.uniform(-100.0, 400.0, n),
    })


def hash_agg_aggregates():
    return [Sum(col("ss_quantity")).alias("sq"),
            Sum(col("ss_net_profit")).alias("sp"),
            Average(col("ss_sales_price")).alias("ap"),
            Count().alias("c")]


def hash_agg_plan(table: pa.Table, two_stage: bool = False,
                  num_slices: int = 1, shuffle_partitions: int = 8,
                  device: DeviceLike = None) -> Exec:
    """``bench.bench_hash_agg``'s aggregate over ``table``: grouped on
    ``ss_item_sk``, COMPLETE over the table in one slice (a COMPLETE
    aggregate sees every row of its groups), or (``two_stage``) PARTIAL
    over ``num_slices`` slices, the hash exchange on the key and FINAL."""
    keys = [col(k) for k in HASH_AGG_KEYS]
    if not two_stage:
        return HashAggregateExec(keys, hash_agg_aggregates(),
                                 _scan(table, 1, device),
                                 AggregateMode.COMPLETE)
    return Adaptive.OFF.grouped(_scan(table, num_slices, device),
                                HASH_AGG_KEYS, hash_agg_aggregates,
                                shuffle_partitions)


def hash_agg_reference(table: pa.Table) -> pa.Table:
    """The hash_agg shape by pyarrow alone, in ``hash_agg_plan``'s column
    order, by key."""
    g = table.group_by(list(HASH_AGG_KEYS)).aggregate(
        [("ss_quantity", "sum"), ("ss_net_profit", "sum"),
         ("ss_sales_price", "mean"), ("ss_item_sk", "count")])
    g = g.sort_by([(HASH_AGG_KEYS[0], "ascending")])
    return pa.table([g.column("ss_item_sk"), g.column("ss_quantity_sum"),
                     g.column("ss_net_profit_sum"),
                     g.column("ss_sales_price_mean"),
                     g.column("ss_item_sk_count")],
                    names=list(HASH_AGG_KEYS) + ["sq", "sp", "ap", "c"])


# ---------------------------------------------------------------------------
# The bench's join_sort shape
# ---------------------------------------------------------------------------

JOIN_SORT_MODES = ("graph", "eager", "iterator")


def join_sort_tables(n_stream: int, n_build: int, seed: int = 7
                     ) -> Tuple[pa.Table, pa.Table]:
    """(stream, build), ``bench.bench_join_sort``'s draws: ``l_orderkey``
    uniform over the ``n_build`` order keys, ``l_revenue`` in [1, 1e5);
    ``o_orderkey`` 0..n_build-1 (a dense primary key), ``o_custkey`` in
    [0, 2^16)."""
    rng = np.random.default_rng(seed)
    stream = pa.table({
        "l_orderkey": rng.integers(0, n_build, n_stream).astype(np.int64),
        "l_revenue": rng.uniform(1.0, 1e5, n_stream),
    })
    build = pa.table({
        "o_orderkey": np.arange(n_build, dtype=np.int64),
        "o_custkey": rng.integers(0, 1 << 16, n_build).astype(np.int64),
    })
    return stream, build


def join_sort_plan(stream: pa.Table, build: pa.Table,
                   device: DeviceLike = None) -> Exec:
    """``bench.bench_join_sort``'s plan over inputs uploaded once, one
    batch a scan, as the planner gives it (``join_sort_df``): ``HashJoinExec
    INNER l_orderkey = o_orderkey`` over the orders build broadcast, its
    output coalesced, then ``SortExec [l_revenue DESC]``. Over one batch
    the broadcast and the coalesce pass it through, so the stage fuses."""
    dev = resolve_device(device)
    sb, s_schema = from_arrow(stream, device=dev)
    bb, b_schema = from_arrow(build, device=dev)
    join = HashJoinExec([col("l_orderkey")], [col("o_orderkey")],
                        JoinType.INNER,
                        InMemoryScanExec([sb], schema=s_schema),
                        BroadcastExchangeExec(
                            InMemoryScanExec([bb], schema=b_schema)))
    return SortExec([desc(col("l_revenue"))],
                    CoalesceBatchesExec(join, TargetSize()))


def join_sort_runner(plan: Exec, mode: str = "graph"
                     ) -> Callable[[], ColumnarBatch]:
    """A callable that runs ``plan``'s stage once and returns its result
    batch on the device: ``graph`` replays the fused stage's CUDA graph
    (the first call plans and captures it; on the CPU the eager program),
    ``eager`` runs the fused program without capture, ``iterator`` pulls
    the operators' batches (``Exec.execute``). The fused modes' callable
    carries its ``FusedStage`` as ``.stage``."""
    if mode == "iterator":
        schema = plan.output_schema

        def iterate() -> ColumnarBatch:
            try:
                return concat_all(list(plan.execute()), schema, plan.device)
            finally:
                plan.close()
        return iterate
    if mode not in JOIN_SORT_MODES:
        raise ValueError(f"mode must be one of {JOIN_SORT_MODES}")
    stage = try_fuse(plan)
    if stage is None:
        raise ValueError("the plan does not fuse")
    capture = mode == "graph"

    def fused() -> ColumnarBatch:
        return stage.run(capture=capture)
    fused.stage = stage
    return fused


def run_join_sort(stream: pa.Table, build: pa.Table, mode: str = "graph",
                  device: DeviceLike = None) -> pa.Table:
    """The join_sort shape end to end, through ``mode``
    (``join_sort_runner``), collected to Arrow."""
    plan = join_sort_plan(stream, build, device)
    return to_arrow(join_sort_runner(plan, mode)(), plan.output_schema)


def _descending_order(values: np.ndarray) -> np.ndarray:
    """The stable order of ``values`` descending, as pyarrow's ``sort_by``
    gives it: eight contiguous runs are sorted in threads of their own
    (numpy sorts without the interpreter lock), then the sorted runs merge
    in one stable pass (timsort finds them), ties keeping their input
    order. About 4x quicker than one sort on 8 cores."""
    from concurrent.futures import ThreadPoolExecutor
    key = -values
    runs = np.array_split(np.arange(len(key)), 8)
    with ThreadPoolExecutor(len(runs)) as pool:
        done = list(pool.map(
            lambda ix: ix[np.argsort(key[ix], kind="stable")], runs))
    cat = np.concatenate(done)
    return cat[np.argsort(key[cat], kind="stable")]


def join_sort_reference(stream: pa.Table, build: pa.Table) -> pa.Table:
    """The join by pyarrow alone (``bench.py``'s oracle) and its rows by
    ``l_revenue`` descending, stable, with numpy: the key once
    (``l_orderkey``, ``l_revenue``, ``o_custkey``)."""
    j = stream.join(build, keys="l_orderkey", right_keys="o_orderkey",
                    join_type="inner").select(
        ["l_orderkey", "l_revenue", "o_custkey"])
    return j.take(_descending_order(j.column("l_revenue").to_numpy()))


# ---------------------------------------------------------------------------
# TPC-H Q16, the part stage
# ---------------------------------------------------------------------------

Q16_KEYS = ("p_brand", "p_type", "p_size")
Q16_BRAND = "Brand#45"
Q16_TYPE_PREFIX = "MEDIUM POLISHED"
Q16_SIZES = (49, 14, 23, 45, 19, 3, 36, 9)

#: TPC-H spec 4.2.2.13: the three syllables of P_TYPE
P_TYPE_SYLLABLES = (
    ("STANDARD", "SMALL", "MEDIUM", "LARGE", "ECONOMY", "PROMO"),
    ("ANODIZED", "BURNISHED", "PLATED", "POLISHED", "BRUSHED"),
    ("TIN", "NICKEL", "BRASS", "STEEL", "COPPER"))
P_TYPES = tuple(f"{a} {b} {c}" for a in P_TYPE_SYLLABLES[0]
                for b in P_TYPE_SYLLABLES[1] for c in P_TYPE_SYLLABLES[2])
P_BRANDS = tuple(f"Brand#{m}{n}" for m in range(1, 6) for n in range(1, 6))


def q16_part_condition() -> Expression:
    return And(And(Not(EqualTo(col("p_brand"), lit(Q16_BRAND))),
                   Not(startswith(col("p_type"), Q16_TYPE_PREFIX))),
               In(col("p_size"), Q16_SIZES))


def q16_part_aggregates():
    return [Count().alias("part_cnt")]


def q16_part_plan(table: pa.Table, num_slices: int = 8,
                  shuffle_partitions: int = 8,
                  device: DeviceLike = None) -> Exec:
    """The physical tree of Q16's part stage over ``table``."""
    return _grouped_stage(
        _scan(table, num_slices, device), q16_part_condition(), Q16_KEYS,
        q16_part_aggregates, shuffle_partitions,
        [desc(col("part_cnt"))] + [asc(col(k)) for k in Q16_KEYS])


def run_q16_part(table: pa.Table, num_slices: int = 8,
                 shuffle_partitions: int = 8, device: DeviceLike = None
                 ) -> pa.Table:
    """Q16's part stage over ``table``, collected to the host."""
    return collect(q16_part_plan(table, num_slices, shuffle_partitions,
                                 device))


def part_table(n: int, seed: int = 16) -> pa.Table:
    """The ``part`` columns Q16 reads, as dbgen draws them (TPC-H spec
    4.2.3): P_BRAND 'Brand#MN' with M and N uniform in 1..5, P_TYPE uniform
    over the 150 syllable triples, P_SIZE uniform in 1..50. Strings are
    taken from the distinct values by code, with no Python loop per row."""
    rng = np.random.default_rng(seed)
    brand = rng.integers(0, len(P_BRANDS), n)
    ptype = rng.integers(0, len(P_TYPES), n)
    size = rng.integers(1, 51, n).astype(np.int32)
    return pa.table({
        "p_brand": pa.array(P_BRANDS).take(pa.array(brand)),
        "p_type": pa.array(P_TYPES).take(pa.array(ptype)),
        "p_size": size,
    })


def q16_part_reference(table: pa.Table) -> pa.Table:
    """Q16's part stage computed by pyarrow alone, in ``run_q16_part``'s
    column order."""
    keep = pc.and_kleene(
        pc.and_kleene(
            pc.not_equal(table.column("p_brand"), Q16_BRAND),
            pc.invert(pc.starts_with(table.column("p_type"),
                                     Q16_TYPE_PREFIX))),
        pc.is_in(table.column("p_size"),
                 value_set=pa.array(Q16_SIZES, pa.int32())))
    g = table.filter(keep).group_by(list(Q16_KEYS)).aggregate(
        [([], "count_all")])
    g = g.sort_by([("count_all", "descending")]
                  + [(k, "ascending") for k in Q16_KEYS])
    return pa.table([g.column(k) for k in Q16_KEYS] + [g.column("count_all")],
                    names=list(Q16_KEYS) + ["part_cnt"])


# ---------------------------------------------------------------------------
# TPC-H Q3
# ---------------------------------------------------------------------------

Q3_SEGMENT = "BUILDING"
Q3_DATE = datetime.date(1995, 3, 15)
Q3_KEYS = ("l_orderkey", "o_orderdate", "o_shippriority")
Q3_SELECT = ("l_orderkey", "revenue", "o_orderdate", "o_shippriority")
Q3_LIMIT = 10

#: TPC-H spec 4.2.2.13: C_MKTSEGMENT
SEGMENTS = ("AUTOMOBILE", "BUILDING", "FURNITURE", "HOUSEHOLD", "MACHINERY")
#: O_ORDERDATE is uniform in [STARTDATE, ENDDATE - 151 days]
ORDERDATE_MIN = epoch_days(datetime.date(1992, 1, 1))
ORDERDATE_MAX = epoch_days(datetime.date(1998, 8, 2))


def _date_column(days: np.ndarray) -> pa.Array:
    return pa.array(days.astype(np.int32), pa.int32()).view(pa.date32())


def _tpch_columns(sf: float, seed: int, part_keys: bool = False
                  ) -> Dict[str, object]:
    """Every column Q3 and Q18 read at scale factor ``sf``, drawn as dbgen
    draws them (TPC-H spec 4.2.3), in one fixed order of draws from one
    numpy generator; columns only Q18 reads are drawn after those of Q3,
    so Q3's input does not depend on them.

    - customer: SF x 150,000 rows, C_CUSTKEY 1..n, C_MKTSEGMENT uniform
      over the five segments, C_NAME 'Customer#' and the key in 9 digits;
    - orders: SF x 1,500,000 rows, O_ORDERKEY sparse (the first 8 keys of
      every 32), O_CUSTKEY uniform over the customers whose key is not
      divisible by 3, O_ORDERDATE uniform in [1992-01-01, 1998-08-02],
      O_SHIPPRIORITY 0, O_TOTALPRICE the sum over the order's lines of
      L_EXTENDEDPRICE * (1 + L_TAX) * (1 - L_DISCOUNT);
    - lineitem: 1 to 7 rows per order, L_QUANTITY 1..50, L_EXTENDEDPRICE
      the quantity times a price in [900.00, 2099.99], L_DISCOUNT in
      0.00..0.10 and L_TAX in 0.00..0.08 by 0.01, L_SHIPDATE the order date
      plus 1 to 121 days.

    With ``part_keys``, L_PARTKEY (uniform over SF x 200,000 parts) and
    L_SUPPKEY (one of its part's four suppliers, dbgen's PART_SUPP_BRIDGE,
    the formula of ``tpch_q2_tables``' PS_SUPPKEY) are drawn last, so
    that no earlier column changes.

    Money and L_QUANTITY are float64, the repo's stand-in for
    DECIMAL(15,2)."""
    rng = np.random.default_rng(seed)
    n_cust = int(round(150_000 * sf))
    n_ord = int(round(1_500_000 * sf))
    out: Dict[str, object] = {}
    out["c_custkey"] = np.arange(1, n_cust + 1, dtype=np.int64)
    segment = rng.integers(0, len(SEGMENTS), n_cust)
    out["c_mktsegment"] = pa.array(SEGMENTS).take(pa.array(segment))
    i = np.arange(n_ord, dtype=np.int64)
    orderkey = (i // 8) * 32 + i % 8 + 1
    # the r-th customer key not divisible by 3 is 3 * (r // 2) + r % 2 + 1
    r = rng.integers(0, n_cust - n_cust // 3, n_ord)
    orderdate = rng.integers(ORDERDATE_MIN, ORDERDATE_MAX + 1, n_ord)
    out["o_orderkey"] = orderkey
    out["o_custkey"] = (3 * (r // 2) + r % 2 + 1).astype(np.int64)
    out["o_orderdate"] = _date_column(orderdate)
    out["o_shippriority"] = np.zeros(n_ord, np.int32)
    lines = rng.integers(1, 8, n_ord)
    n_line = int(lines.sum())
    price = rng.integers(90_000, 210_000, n_line)
    quantity = rng.integers(1, 51, n_line)
    out["l_orderkey"] = np.repeat(orderkey, lines)
    out["l_extendedprice"] = (quantity * price) / 100.0
    out["l_discount"] = rng.integers(0, 11, n_line) / 100.0
    out["l_shipdate"] = _date_column(np.repeat(orderdate, lines)
                                     + rng.integers(1, 122, n_line))
    # Q18's own columns, drawn after Q3's
    out["l_quantity"] = quantity.astype(np.float64)
    tax = rng.integers(0, 9, n_line) / 100.0
    charge = out["l_extendedprice"] * (1.0 + tax) * (1.0 - out["l_discount"])
    out["o_totalprice"] = np.bincount(np.repeat(i, lines), weights=charge,
                                      minlength=n_ord)
    out["c_name"] = _numbered(b"Customer#", out["c_custkey"])
    if part_keys:
        # Q14's and Q9's own columns, drawn after every other
        n_part, n_supp = _part_rows(sf), _supplier_rows(sf)
        partkey = rng.integers(1, n_part + 1, n_line)
        out["l_partkey"] = partkey
        out["l_suppkey"] = _supplier_of(partkey, rng.integers(0, 4, n_line),
                                        n_supp)
    return out


def _part_rows(sf: float) -> int:
    return max(int(round(200_000 * sf)), 1)


def _supplier_rows(sf: float) -> int:
    return max(int(round(10_000 * sf)), 1)


def _supplier_of(partkey: np.ndarray, i: np.ndarray, n_supp: int
                 ) -> np.ndarray:
    """The ``i``-th of the four suppliers of each part (dbgen's
    PART_SUPP_BRIDGE: ``(p + i * (S / 4 + (p - 1) / S)) % S + 1``)."""
    return ((partkey + i * (n_supp // 4 + (partkey - 1) // n_supp))
            % n_supp + 1).astype(np.int64)


def _digits(values: np.ndarray, width: int) -> np.ndarray:
    """uint8[n, width]: each value's last ``width`` decimal digits as
    ASCII, zero-padded on the left."""
    d = (values[:, None] // 10 ** np.arange(width - 1, -1, -1)) % 10
    return (d + ord("0")).astype(np.uint8)


def _strings(mat: np.ndarray, lengths: Optional[np.ndarray] = None
             ) -> pa.Array:
    """A string array whose row i is ``mat[i, :lengths[i]]`` (every row
    whole without ``lengths``), built from the bytes at once."""
    n, w = mat.shape
    if lengths is None:
        lengths = np.full(n, w, np.int64)
    chars = mat[np.arange(w)[None, :] < lengths[:, None]]
    offsets = np.zeros(n + 1, np.int32)
    np.cumsum(lengths, out=offsets[1:])
    return pa.StringArray.from_buffers(n, pa.py_buffer(offsets.tobytes()),
                                       pa.py_buffer(chars.tobytes()))


def _numbered(prefix: bytes, keys: np.ndarray) -> pa.Array:
    """``prefix`` and each key in 9 digits ('Customer#%09d')."""
    head = np.broadcast_to(np.frombuffer(prefix, np.uint8),
                           (len(keys), len(prefix)))
    return _strings(np.concatenate([head, _digits(keys, 9)], axis=1))


def _tpch_table(columns: Dict[str, object], names: Sequence[str]
                ) -> pa.Table:
    return pa.table({n: columns[n] for n in names})


def tpch_q3_tables(sf: float, seed: int = 3
                   ) -> Tuple[pa.Table, pa.Table, pa.Table]:
    """``(customer, orders, lineitem)``: the columns Q3 reads at scale
    factor ``sf`` (``_tpch_columns``)."""
    c = _tpch_columns(sf, seed)
    return (_tpch_table(c, ("c_custkey", "c_mktsegment")),
            _tpch_table(c, ("o_orderkey", "o_custkey", "o_orderdate",
                            "o_shippriority")),
            _tpch_table(c, ("l_orderkey", "l_extendedprice", "l_discount",
                            "l_shipdate")))


def q3_aggregates():
    return [Sum(col("l_extendedprice") * (lit(1.0) - col("l_discount")))
            .alias("revenue")]


class Adaptive:
    """The adaptive-execution knobs of one tree, with the JAX package's
    defaults (``spark.rapids.tpu.sql.adaptive.*``): what its shuffle
    exchanges and its shuffled hash joins are built with. ``None`` for
    ``skew_split_rows`` or ``broadcast_switch_rows`` turns that decision
    off, as its ``enabled`` key does. ``Adaptive.OFF`` is the tree with
    AQE off."""

    def __init__(self, enabled: bool = True,
                 target_rows: int = ADAPTIVE_TARGET_ROWS.default,
                 skew_split_rows: Optional[int] = SKEW_SPLIT_ROWS.default,
                 broadcast_switch_rows: Optional[int] =
                 ADAPTIVE_BROADCAST_MAX_BUILD_ROWS.default):
        self.enabled = enabled
        self.target_rows = target_rows
        self.skew_split_rows = skew_split_rows if enabled else None
        self.broadcast_switch_rows = (broadcast_switch_rows if enabled
                                      else None)

    def exchange(self, partitioning, child: Exec) -> ShuffleExchangeExec:
        return ShuffleExchangeExec(partitioning, child,
                                   adaptive=self.enabled,
                                   target_rows=self.target_rows)

    def shuffled_join(self, stream_keys: Sequence[Expression],
                      build_keys: Sequence[Expression], how: JoinType,
                      stream: Exec, build: Exec, shuffle_partitions: int,
                      **kw) -> Exec:
        """A hash join over both sides hash-partitioned on their keys."""
        return HashJoinExec(
            stream_keys, build_keys, how,
            self.exchange(HashPartitioning(stream_keys, shuffle_partitions),
                          stream),
            self.exchange(HashPartitioning(build_keys, shuffle_partitions),
                          build),
            broadcast_build=False, skew_split_rows=self.skew_split_rows,
            broadcast_switch_rows=self.broadcast_switch_rows, **kw)

    def grouped(self, child: Exec, keys: Sequence[str], aggregates,
                shuffle_partitions: int) -> Exec:
        """Partial aggregate, exchange (hash on the keys, or into one
        partition without keys), final aggregate. The exchange is left out
        where the child reads as one partition, as the JAX planner's
        ``_convert_aggregate`` does; asking an adaptive child for its
        partitions materializes the exchanges below it."""
        key_cols = [col(k) for k in keys]
        partial = HashAggregateExec(key_cols, aggregates(), child,
                                    AggregateMode.PARTIAL)
        below: Exec = partial
        if child.num_partitions > 1:
            below = self.exchange(
                HashPartitioning([col(f.name) for f in partial.key_fields],
                                 shuffle_partitions) if keys
                else SinglePartitioning(), partial)
        return HashAggregateExec(key_cols, aggregates(), below,
                                 AggregateMode.FINAL)


Adaptive.OFF = Adaptive(enabled=False)


def _inner_join(stream: Exec, build: Exec, stream_key: str, build_key: str,
                shuffle_partitions: int, broadcast: bool,
                aqe: Adaptive = Adaptive.OFF) -> Exec:
    """An inner hash join of ``stream`` (probe) and ``build``: over a
    broadcast build with a coalesced stream, or over both sides
    hash-partitioned on their keys."""
    lk, rk = [col(stream_key)], [col(build_key)]
    if broadcast:
        return HashJoinExec(lk, rk, JoinType.INNER,
                            CoalesceBatchesExec(stream, TargetSize()),
                            BroadcastExchangeExec(build))
    return aqe.shuffled_join(lk, rk, JoinType.INNER, stream, build,
                             shuffle_partitions)


def _swap_back(join: Exec, first: Exec, second: Exec) -> Exec:
    """The projection that restores the query's column order (``first``'s
    columns, then ``second``'s) over a join whose build side was swapped:
    ``join`` streams ``second`` and builds ``first``."""
    n_second = len(second.output_schema)
    refs = [BoundReference(n_second + i, f.dtype, f.nullable, f.name)
            for i, f in enumerate(first.output_schema)]
    refs += [BoundReference(i, f.dtype, f.nullable, f.name)
             for i, f in enumerate(second.output_schema)]
    return ProjectExec(refs, join)


def q3_plan(customer: pa.Table, orders: pa.Table, lineitem: pa.Table,
            num_slices: int = 8, shuffle_partitions: int = 8,
            broadcast: bool = False, device: DeviceLike = None,
            adaptive: bool = False,
            target_rows: int = ADAPTIVE_TARGET_ROWS.default,
            skew_split_rows: Optional[int] = SKEW_SPLIT_ROWS.default,
            broadcast_switch_rows: Optional[int] =
            ADAPTIVE_BROADCAST_MAX_BUILD_ROWS.default) -> Exec:
    """Q3's physical tree over the three tables. The JAX planner joins
    customer with orders and that with lineitem, and swaps each join's
    sides to build on the smaller one. With ``adaptive`` the tree is the
    one the JAX Session gives under its default adaptive conf (the knobs
    as arguments): adaptive exchanges, shuffled joins that coordinate
    their reads, split skewed partitions and switch a small build to a
    broadcast at run time, and the aggregate's exchange only where the
    join reads as more than one partition (which materializes the joins'
    exchanges while the tree is built)."""
    aqe = Adaptive(adaptive, target_rows, skew_split_rows,
                   broadcast_switch_rows)
    c = FilterExec(EqualTo(col("c_mktsegment"), lit(Q3_SEGMENT)),
                   _scan(customer, num_slices, device))
    o = FilterExec(col("o_orderdate") < lit(Q3_DATE),
                   _scan(orders, num_slices, device))
    li = FilterExec(col("l_shipdate") > lit(Q3_DATE),
                    _scan(lineitem, num_slices, device))
    co = _swap_back(_inner_join(o, c, "o_custkey", "c_custkey",
                                shuffle_partitions, broadcast, aqe), c, o)
    joined = _swap_back(_inner_join(li, co, "l_orderkey", "o_orderkey",
                                    shuffle_partitions, broadcast, aqe),
                        co, li)
    final = aqe.grouped(joined, Q3_KEYS, q3_aggregates, shuffle_partitions)
    top = GlobalLimitExec(Q3_LIMIT, SortExec(
        [desc(col("revenue")), asc(col("o_orderdate"))], final))
    return ProjectExec([col(k) for k in Q3_SELECT], top)


def run_q3(customer: pa.Table, orders: pa.Table, lineitem: pa.Table,
           num_slices: int = 8, shuffle_partitions: int = 8,
           broadcast: bool = False, device: DeviceLike = None,
           adaptive: bool = False, **knobs) -> pa.Table:
    """Q3 over the three tables, collected to the host (``knobs``: the
    adaptive ones of ``q3_plan``)."""
    return collect(q3_plan(customer, orders, lineitem, num_slices,
                           shuffle_partitions, broadcast, device, adaptive,
                           **knobs))


def q3_groups_reference(customer: pa.Table, orders: pa.Table,
                        lineitem: pa.Table) -> pa.Table:
    """Every group of Q3 before its ORDER BY and LIMIT, by pyarrow alone:
    the group keys and revenue, in ``run_q3``'s column order."""
    day = pa.scalar(Q3_DATE, pa.date32())
    c = customer.filter(pc.equal(customer.column("c_mktsegment"),
                                 Q3_SEGMENT))
    o = orders.filter(pc.less(orders.column("o_orderdate"), day))
    li = lineitem.filter(pc.greater(lineitem.column("l_shipdate"), day))
    co = o.join(c.select(["c_custkey"]), keys="o_custkey",
                right_keys="c_custkey", join_type="inner")
    j = li.join(co.select(["o_orderkey", "o_orderdate", "o_shippriority"]),
                keys="l_orderkey", right_keys="o_orderkey",
                join_type="inner")
    rev = pc.multiply(j.column("l_extendedprice"),
                      pc.subtract(1.0, j.column("l_discount")))
    g = j.append_column("rev", rev).group_by(list(Q3_KEYS)).aggregate(
        [("rev", "sum")])
    return pa.table([g.column("l_orderkey"), g.column("rev_sum"),
                     g.column("o_orderdate"), g.column("o_shippriority")],
                    names=list(Q3_SELECT))


def q3_top(groups: pa.Table) -> pa.Table:
    """Q3's ORDER BY revenue DESC, o_orderdate and LIMIT over its groups."""
    return groups.sort_by([("revenue", "descending"),
                           ("o_orderdate", "ascending")]).slice(0, Q3_LIMIT)


def q3_reference(customer: pa.Table, orders: pa.Table,
                 lineitem: pa.Table) -> pa.Table:
    """Q3 computed by pyarrow alone, in ``run_q3``'s column order."""
    return q3_top(q3_groups_reference(customer, orders, lineitem))


# ---------------------------------------------------------------------------
# TPC-H Q18
# ---------------------------------------------------------------------------

Q18_QUANTITY = 300.0
Q18_KEYS = ("c_name", "c_custkey", "o_orderkey", "o_orderdate",
            "o_totalprice")
Q18_LIMIT = 100


def tpch_q18_tables(sf: float, seed: int = 3
                    ) -> Tuple[pa.Table, pa.Table, pa.Table]:
    """``(customer, orders, lineitem)``: the columns Q18 reads at scale
    factor ``sf``, from the same draws as ``tpch_q3_tables``
    (``_tpch_columns``)."""
    c = _tpch_columns(sf, seed)
    return (_tpch_table(c, ("c_custkey", "c_name")),
            _tpch_table(c, ("o_orderkey", "o_custkey", "o_totalprice",
                            "o_orderdate")),
            _tpch_table(c, ("l_orderkey", "l_quantity")))


def q18_aggregates(name: str = "sum_qty"):
    return [Sum(col("l_quantity")).alias(name)]


def q18_plan(customer: pa.Table, orders: pa.Table, lineitem: pa.Table,
             num_slices: int = 8, shuffle_partitions: int = 2,
             device_limit: Optional[int] = None,
             max_build_rows: int = JOIN_MAX_BUILD_ROWS.default,
             device: DeviceLike = None,
             quantity: float = Q18_QUANTITY, adaptive: bool = False,
             target_rows: int = ADAPTIVE_TARGET_ROWS.default,
             skew_split_rows: Optional[int] = SKEW_SPLIT_ROWS.default,
             broadcast_switch_rows: Optional[int] =
             ADAPTIVE_BROADCAST_MAX_BUILD_ROWS.default) -> Exec:
    """Q18's physical tree over the three tables, every join shuffled. With
    ``device_limit`` the tree gets a buffer catalog of its own with that
    device budget (``plan.catalog``). ``adaptive`` and its knobs as in
    ``q3_plan``."""
    aqe = Adaptive(adaptive, target_rows, skew_split_rows,
                   broadcast_switch_rows)
    cat = BufferCatalog(device_limit) if device_limit else None

    def scan(t: pa.Table) -> Exec:
        return _scan(t, num_slices, device, cat)

    def shuffled_join(stream: Exec, build: Exec, stream_key: str,
                      build_key: str, how: JoinType) -> Exec:
        return aqe.shuffled_join([col(stream_key)], [col(build_key)], how,
                                 stream, build, shuffle_partitions,
                                 max_build_rows=max_build_rows)

    big_orders = FilterExec(
        col("sq") > lit(float(quantity)),
        aqe.grouped(scan(lineitem), ["l_orderkey"],
                    lambda: q18_aggregates("sq"), shuffle_partitions))
    semi = shuffled_join(scan(orders), big_orders, "o_orderkey",
                         "l_orderkey", JoinType.LEFT_SEMI)
    cust = scan(customer)
    co = _swap_back(shuffled_join(semi, cust, "o_custkey", "c_custkey",
                                  JoinType.INNER), cust, semi)
    joined = shuffled_join(co, scan(lineitem), "o_orderkey", "l_orderkey",
                           JoinType.INNER)
    final = aqe.grouped(CoalesceBatchesExec(joined, TargetSize()), Q18_KEYS,
                        q18_aggregates, shuffle_partitions)
    return GlobalLimitExec(Q18_LIMIT, SortExec(
        [desc(col("o_totalprice")), asc(col("o_orderdate"))], final))


def run_q18(customer: pa.Table, orders: pa.Table, lineitem: pa.Table,
            num_slices: int = 8, shuffle_partitions: int = 2,
            device_limit: Optional[int] = None,
            max_build_rows: int = JOIN_MAX_BUILD_ROWS.default,
            device: DeviceLike = None,
            quantity: float = Q18_QUANTITY, adaptive: bool = False,
            **knobs) -> pa.Table:
    """Q18 over the three tables, collected to the host (``knobs``: the
    adaptive ones of ``q18_plan``)."""
    return collect(q18_plan(customer, orders, lineitem, num_slices,
                            shuffle_partitions, device_limit,
                            max_build_rows, device, quantity, adaptive,
                            **knobs))


def q18_groups_reference(customer: pa.Table, orders: pa.Table,
                         lineitem: pa.Table,
                         quantity: float = Q18_QUANTITY) -> pa.Table:
    """Every group of Q18 before its ORDER BY and LIMIT, by pyarrow alone,
    in ``run_q18``'s column order."""
    sq = lineitem.group_by("l_orderkey").aggregate([("l_quantity", "sum")])
    big = sq.filter(pc.greater(sq.column("l_quantity_sum"), quantity))
    keys = big.column("l_orderkey")
    o = orders.filter(pc.is_in(orders.column("o_orderkey"), value_set=keys))
    li = lineitem.filter(pc.is_in(lineitem.column("l_orderkey"),
                                  value_set=keys))
    co = o.join(customer, keys="o_custkey", right_keys="c_custkey",
                join_type="inner")
    j = li.join(co, keys="l_orderkey", right_keys="o_orderkey",
                join_type="inner")
    g = j.group_by(["c_name", "o_custkey", "l_orderkey", "o_orderdate",
                    "o_totalprice"]).aggregate([("l_quantity", "sum")])
    return pa.table([g.column("c_name"), g.column("o_custkey"),
                     g.column("l_orderkey"), g.column("o_orderdate"),
                     g.column("o_totalprice"), g.column("l_quantity_sum")],
                    names=list(Q18_KEYS) + ["sum_qty"])


def q18_top(groups: pa.Table) -> pa.Table:
    """Q18's ORDER BY o_totalprice DESC, o_orderdate and LIMIT."""
    return groups.sort_by([("o_totalprice", "descending"),
                           ("o_orderdate", "ascending")]).slice(0, Q18_LIMIT)


def q18_reference(customer: pa.Table, orders: pa.Table,
                  lineitem: pa.Table,
                  quantity: float = Q18_QUANTITY) -> pa.Table:
    """Q18 computed by pyarrow alone, in ``run_q18``'s column order."""
    return q18_top(q18_groups_reference(customer, orders, lineitem,
                                        quantity))


def decimal_from_int64(unscaled: np.ndarray, precision: int,
                       scale: int) -> pa.Array:
    """An Arrow decimal128(precision, scale) array of int64 unscaled
    values, built from its buffer: each value sign-extended to 16
    little-endian bytes (no ``Decimal`` per row)."""
    v = np.asarray(unscaled).astype(np.int64)
    words = np.empty((len(v), 2), np.int64)
    words[:, 0] = v
    np.right_shift(v, 63, out=words[:, 1])
    return pa.Array.from_buffers(pa.decimal128(precision, scale), len(v),
                                 [None, pa.py_buffer(words)])


#: Q18's HAVING literal in the spec's types: 300 as decimal(3, 0)
Q18_DECIMAL_QUANTITY = 300
#: the type Spark's JDBC reader gives an Oracle NUMBER(38) identifier
WIDE_KEY = (38, 0)


def tpch_q18_decimal_tables(sf: float, seed: int = 3,
                            wide_keys: bool = False
                            ) -> Tuple[pa.Table, pa.Table, pa.Table]:
    """``tpch_q18_tables`` in the spec's DECIMAL types, from the same
    draws (``q18_decimal_of``)."""
    return q18_decimal_of(*tpch_q18_tables(sf, seed), wide_keys=wide_keys)


def q18_decimal_of(customer: pa.Table, orders: pa.Table, lineitem: pa.Table,
                   wide_keys: bool = False
                   ) -> Tuple[pa.Table, pa.Table, pa.Table]:
    """``tpch_q18_tables``' tables in the spec's DECIMAL types:
    L_QUANTITY and O_TOTALPRICE decimal(15, 2), O_TOTALPRICE the float64
    total rounded half up to the cent. With ``wide_keys`` C_CUSTKEY,
    O_CUSTKEY, O_ORDERKEY and L_ORDERKEY are decimal(38, 0), the type
    Spark's JDBC reader gives NUMBER(38) identifier columns. Every array
    is built from int64 cents or keys (``decimal_from_int64``)."""
    def cents(t: pa.Table, name: str, rounded: bool) -> pa.Array:
        x = t.column(name).to_numpy() * 100
        return decimal_from_int64(np.floor(x + 0.5) if rounded else x,
                                  15, 2)

    def with_columns(t: pa.Table, cols: Dict[str, pa.Array]) -> pa.Table:
        for name, arr in cols.items():
            t = t.set_column(t.schema.get_field_index(name), name, arr)
        return t

    def key(t: pa.Table, name: str) -> Dict[str, pa.Array]:
        return ({name: decimal_from_int64(t.column(name).to_numpy(),
                                          *WIDE_KEY)} if wide_keys else {})

    return (with_columns(customer, key(customer, "c_custkey")),
            with_columns(orders, {
                "o_totalprice": cents(orders, "o_totalprice", True),
                **key(orders, "o_orderkey"), **key(orders, "o_custkey")}),
            with_columns(lineitem, {
                "l_quantity": cents(lineitem, "l_quantity", False),
                **key(lineitem, "l_orderkey")}))


def q18_decimal_reference(customer: pa.Table, orders: pa.Table,
                          lineitem: pa.Table,
                          quantity: int = Q18_DECIMAL_QUANTITY) -> pa.Table:
    """Q18 over ``tpch_q18_decimal_tables`` by pyarrow alone: exact
    decimal group sums typed as Spark types them (sum of decimal(15, 2)
    is decimal(25, 2)), then the spec's sort and limit."""
    import decimal
    sum_type = pa.decimal128(min(lineitem.schema.field(
        "l_quantity").type.precision + 10, 38), 2)

    def summed(t: pa.Table, keys) -> pa.Table:
        g = t.group_by(keys).aggregate([("l_quantity", "sum")])
        return g.set_column(g.schema.get_field_index("l_quantity_sum"),
                            "l_quantity_sum",
                            g.column("l_quantity_sum").cast(sum_type))

    sq = summed(lineitem, "l_orderkey")
    big = sq.filter(pc.greater(sq.column("l_quantity_sum"), pa.scalar(
        decimal.Decimal(quantity), sum_type)))
    keys = big.column("l_orderkey")
    o = orders.filter(pc.is_in(orders.column("o_orderkey"), value_set=keys))
    li = lineitem.filter(pc.is_in(lineitem.column("l_orderkey"),
                                  value_set=keys))
    co = o.join(customer, keys="o_custkey", right_keys="c_custkey",
                join_type="inner")
    j = li.join(co, keys="l_orderkey", right_keys="o_orderkey",
                join_type="inner")
    g = summed(j, ["c_name", "o_custkey", "l_orderkey", "o_orderdate",
                   "o_totalprice"])
    return q18_top(pa.table(
        [g.column("c_name"), g.column("o_custkey"), g.column("l_orderkey"),
         g.column("o_orderdate"), g.column("o_totalprice"),
         g.column("l_quantity_sum")], names=list(Q18_KEYS) + ["sum_qty"]))


# ---------------------------------------------------------------------------
# TPC-H Q2 and Q11
# ---------------------------------------------------------------------------

#: TPC-H spec 4.2.3: N_NAME and N_REGIONKEY of the 25 nations, by key
NATIONS = (
    ("ALGERIA", 0), ("ARGENTINA", 1), ("BRAZIL", 1), ("CANADA", 1),
    ("EGYPT", 4), ("ETHIOPIA", 0), ("FRANCE", 3), ("GERMANY", 3),
    ("INDIA", 2), ("INDONESIA", 2), ("IRAN", 4), ("IRAQ", 4), ("JAPAN", 2),
    ("JORDAN", 4), ("KENYA", 0), ("MOROCCO", 0), ("MOZAMBIQUE", 0),
    ("PERU", 1), ("CHINA", 2), ("ROMANIA", 3), ("SAUDI ARABIA", 4),
    ("VIETNAM", 2), ("RUSSIA", 3), ("UNITED KINGDOM", 3),
    ("UNITED STATES", 1))
#: R_NAME of the 5 regions, by key
REGIONS = ("AFRICA", "AMERICA", "ASIA", "EUROPE", "MIDDLE EAST")

#: Q2's validation parameters (spec 2.4.2.3)
Q2_SIZE = 15
Q2_TYPE_SUFFIX = "BRASS"
Q2_REGION = "EUROPE"
Q2_LIMIT = 100
Q2_SELECT = ("s_acctbal", "s_name", "n_name", "p_partkey", "p_mfgr",
             "s_address", "s_phone", "s_comment")
#: Q11's validation parameters (spec 2.4.11.3): FRACTION is 0.0001 / SF
Q11_NATION = "GERMANY"
Q11_FRACTION = 0.0001
#: the supplier scan's string width: S_COMMENT runs to 100 bytes
SUPPLIER_STRING_MAX_LEN = 128

_LETTERS = np.frombuffer(b"abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ",
                         np.uint8)


def _random_text(rng, n: int, lo: int, hi: int) -> pa.Array:
    """Strings of ``lo`` to ``hi`` random letters (dbgen's V-string
    lengths, not its text grammar)."""
    lengths = rng.integers(lo, hi + 1, n)
    mat = _LETTERS[rng.integers(0, len(_LETTERS), (n, hi), dtype=np.uint8)]
    return _strings(mat, lengths)


def tpch_q2_tables(sf: float, seed: int = 2
                   ) -> Tuple[pa.Table, pa.Table, pa.Table, pa.Table,
                              pa.Table]:
    """``(part, supplier, partsupp, nation, region)``: every column Q2 and
    Q11 read at scale factor ``sf``, drawn as dbgen draws them (TPC-H spec
    4.2.3) from one numpy generator, with no Python loop per row:

    - part: SF x 200,000 rows, P_PARTKEY 1..n, P_MFGR 'Manufacturer#M'
      with M uniform in 1..5, P_TYPE and P_SIZE as ``part_table`` draws
      them;
    - supplier: SF x 10,000 rows, S_SUPPKEY 1..n, S_NAME 'Supplier#' and
      the key in 9 digits, S_ADDRESS 10 to 40 random letters, S_NATIONKEY
      uniform in 0..24, S_PHONE '(10 + nationkey)-ddd-ddd-dddd',
      S_ACCTBAL in [-999.99, 9999.99] by 0.01, S_COMMENT 25 to 100 random
      letters;
    - partsupp: four rows per part, PS_SUPPKEY by dbgen's formula
      ``(ps_partkey + i * (S / 4 + (ps_partkey - 1) / S)) % S + 1``,
      PS_AVAILQTY in 1..9999, PS_SUPPLYCOST in [1.00, 1000.00] by 0.01;
    - nation and region: the spec's 25 and 5 rows.

    Keys are int64, money float64 (the repo's stand-in for DECIMAL)."""
    rng = np.random.default_rng(seed)
    n_part = max(int(round(200_000 * sf)), 1)
    n_supp = max(int(round(10_000 * sf)), 1)
    partkey = np.arange(1, n_part + 1, dtype=np.int64)
    mfgr = rng.integers(1, 6, n_part)
    ptype = rng.integers(0, len(P_TYPES), n_part)
    size = rng.integers(1, 51, n_part).astype(np.int32)
    part = pa.table({
        "p_partkey": partkey,
        "p_mfgr": pa.array([f"Manufacturer#{m}" for m in range(1, 6)]).take(
            pa.array(mfgr - 1)),
        "p_type": pa.array(P_TYPES).take(pa.array(ptype)),
        "p_size": size,
    })
    suppkey = np.arange(1, n_supp + 1, dtype=np.int64)
    address = _random_text(rng, n_supp, 10, 40)
    nationkey = rng.integers(0, len(NATIONS), n_supp)
    dash = np.full((n_supp, 1), ord("-"), np.uint8)
    phone = _strings(np.concatenate([
        _digits(nationkey + 10, 2), dash,
        _digits(rng.integers(100, 1000, n_supp), 3), dash,
        _digits(rng.integers(100, 1000, n_supp), 3), dash,
        _digits(rng.integers(1000, 10000, n_supp), 4)], axis=1))
    supplier = pa.table({
        "s_suppkey": suppkey,
        "s_name": _numbered(b"Supplier#", suppkey),
        "s_address": address,
        "s_nationkey": nationkey.astype(np.int64),
        "s_phone": phone,
        "s_acctbal": rng.integers(-99_999, 1_000_000, n_supp) / 100.0,
        "s_comment": _random_text(rng, n_supp, 25, 100),
    })
    ps_partkey = np.repeat(partkey, 4)
    i = np.tile(np.arange(4, dtype=np.int64), n_part)
    ps_suppkey = (ps_partkey + i * (n_supp // 4 + (ps_partkey - 1) // n_supp)
                  ) % n_supp + 1
    del i
    partsupp = pa.table({
        "ps_partkey": ps_partkey,
        "ps_suppkey": ps_suppkey,
        "ps_availqty": rng.integers(1, 10_000, 4 * n_part).astype(np.int32),
        "ps_supplycost": rng.integers(100, 100_001, 4 * n_part) / 100.0,
    })
    nation = pa.table({
        "n_nationkey": np.arange(len(NATIONS), dtype=np.int64),
        "n_name": [name for name, _ in NATIONS],
        "n_regionkey": np.array([r for _, r in NATIONS], np.int64),
    })
    region = pa.table({"r_regionkey": np.arange(len(REGIONS),
                                                dtype=np.int64),
                       "r_name": list(REGIONS)})
    return part, supplier, partsupp, nation, region


#: the columns each query reads, by table: its plan scans only these, as
#: Spark's column pruning leaves them
Q2_COLUMNS = {"partsupp": ("ps_partkey", "ps_suppkey", "ps_supplycost")}
Q11_COLUMNS = {"partsupp": ("ps_partkey", "ps_suppkey", "ps_availqty",
                            "ps_supplycost"),
               "supplier": ("s_suppkey", "s_nationkey"),
               "nation": ("n_nationkey", "n_name")}


def q11_fraction(sf: float) -> float:
    """Q11's FRACTION at scale factor ``sf``: 0.0001 / SF."""
    return Q11_FRACTION / sf


def _q2_subquery_reference(partsupp: pa.Table, suppliers: pa.Table
                           ) -> pa.Table:
    """(ps_partkey, min_cost): the smallest supply cost of each part over
    the suppliers given."""
    ps = partsupp.join(suppliers.select(["s_suppkey"]), keys="ps_suppkey",
                       right_keys="s_suppkey", join_type="inner")
    g = ps.group_by("ps_partkey").aggregate([("ps_supplycost", "min")])
    return g.rename_columns(["ps_partkey", "min_cost"])


def q2_reference(part: pa.Table, supplier: pa.Table, partsupp: pa.Table,
                 nation: pa.Table, region: pa.Table) -> pa.Table:
    """TPC-H Q2 computed by pyarrow alone, in ``run_q2``'s column order:
    the correlated subquery as the smallest European supply cost of each
    part, the outer rows those whose cost equals it."""
    r = region.filter(pc.equal(region.column("r_name"), Q2_REGION))
    n = nation.join(r, keys="n_regionkey", right_keys="r_regionkey",
                    join_type="inner").select(["n_nationkey", "n_name"])
    s = supplier.join(n, keys="s_nationkey", right_keys="n_nationkey",
                      join_type="inner")
    mins = _q2_subquery_reference(partsupp, s)
    p = part.filter(pc.and_(
        pc.equal(part.column("p_size"), Q2_SIZE),
        pc.ends_with(part.column("p_type"), Q2_TYPE_SUFFIX)))
    j = p.join(partsupp, keys="p_partkey", right_keys="ps_partkey",
               join_type="inner")
    j = j.join(mins, keys="p_partkey", right_keys="ps_partkey",
               join_type="inner")
    j = j.filter(pc.equal(j.column("ps_supplycost"), j.column("min_cost")))
    j = j.join(s, keys="ps_suppkey", right_keys="s_suppkey",
               join_type="inner")
    j = j.sort_by([("s_acctbal", "descending"), ("n_name", "ascending"),
                   ("s_name", "ascending"), ("p_partkey", "ascending")])
    return j.slice(0, Q2_LIMIT).select(list(Q2_SELECT))


def q11_groups_reference(partsupp: pa.Table, supplier: pa.Table,
                         nation: pa.Table) -> Tuple[pa.Table, float]:
    """Every group of Q11 before its HAVING, by pyarrow alone, as
    ``(ps_partkey, value)``, and the subquery's total."""
    n = nation.filter(pc.equal(nation.column("n_name"), Q11_NATION))
    s = supplier.join(n.select(["n_nationkey"]), keys="s_nationkey",
                      right_keys="n_nationkey", join_type="inner")
    ps = partsupp.join(s.select(["s_suppkey"]), keys="ps_suppkey",
                       right_keys="s_suppkey", join_type="inner")
    value = pc.multiply(ps.column("ps_supplycost"),
                        pc.cast(ps.column("ps_availqty"), pa.float64()))
    ps = ps.append_column("value", value)
    g = ps.group_by("ps_partkey").aggregate([("value", "sum")])
    total = pc.sum(value).as_py() or 0.0
    return g.rename_columns(["ps_partkey", "value"]), total


def q11_reference(partsupp: pa.Table, supplier: pa.Table, nation: pa.Table,
                  fraction: float) -> pa.Table:
    """TPC-H Q11 computed by pyarrow alone, in ``run_q11``'s column order:
    the groups whose value passes ``total * fraction``, by value
    descending."""
    g, total = q11_groups_reference(partsupp, supplier, nation)
    keep = g.filter(pc.greater(g.column("value"), total * fraction))
    return keep.sort_by([("value", "descending"), ("ps_partkey",
                                                   "ascending")])


def _prune(table: pa.Table, names: Optional[Sequence[str]]) -> pa.Table:
    return table if names is None else table.select(list(names))


def _broadcast_join(stream: Exec, build: Exec, stream_keys: Sequence[str],
                    build_keys: Sequence[str]) -> Exec:
    return HashJoinExec([col(k) for k in stream_keys],
                        [col(k) for k in build_keys], JoinType.INNER,
                        stream, BroadcastExchangeExec(build))


def _shuffled_join(stream: Exec, build: Exec, stream_keys: Sequence[str],
                   build_keys: Sequence[str],
                   shuffle_partitions: int) -> Exec:
    lk = [col(k) for k in stream_keys]
    rk = [col(k) for k in build_keys]
    return HashJoinExec(
        lk, rk, JoinType.INNER,
        ShuffleExchangeExec(HashPartitioning(lk, shuffle_partitions), stream),
        ShuffleExchangeExec(HashPartitioning(rk, shuffle_partitions), build),
        broadcast_build=False)


def q2_aggregates():
    return [Min(col("ps_supplycost")).alias("min_cost")]


def q2_plan(part: pa.Table, supplier: pa.Table, partsupp: pa.Table,
            nation: pa.Table, region: pa.Table, num_slices: int = 8,
            shuffle_partitions: int = 8, device: DeviceLike = None) -> Exec:
    """TPC-H Q2 (spec 2.4.2, "Minimum Cost Supplier") with its validation
    parameters, as the tree the JAX planner gives it with AQE off at SF100
    (every join over a ``supplier``, ``part`` or ``partsupp`` input
    shuffled, the ``nation`` and ``region`` builds broadcast)::

        SELECT s_acctbal, s_name, n_name, p_partkey, p_mfgr, s_address,
               s_phone, s_comment
        FROM part, supplier, partsupp, nation, region
        WHERE p_partkey = ps_partkey AND s_suppkey = ps_suppkey
          AND p_size = 15 AND p_type LIKE '%BRASS'
          AND s_nationkey = n_nationkey AND n_regionkey = r_regionkey
          AND r_name = 'EUROPE'
          AND ps_supplycost = (SELECT min(ps_supplycost)
                               FROM partsupp, supplier, nation, region
                               WHERE p_partkey = ps_partkey AND ...)
        ORDER BY s_acctbal DESC, n_name, s_name, p_partkey LIMIT 100

    The correlated subquery is decorrelated as Spark does it: the least
    European supply cost of every part (a grouped Min over partsupp joined
    to the European suppliers), renamed ``(m_partkey, min_cost)`` and
    joined on the two keys ``(p_partkey, ps_supplycost)``. The LIKE is
    ``endswith``, as Spark's LikeSimplification leaves it; ``supplier``
    scans at 128 bytes a string (``s_comment`` runs to 100), the others at
    64. Only the columns Q2 reads are scanned."""
    def scan(t: pa.Table, width: int = STRING_MAX_LEN) -> Exec:
        return _scan(t, num_slices, device, string_max_len=width)

    ps = _prune(partsupp, Q2_COLUMNS["partsupp"])

    def eu_suppliers() -> Exec:
        regions = FilterExec(EqualTo(col("r_name"), lit(Q2_REGION)),
                             scan(region))
        nations = ProjectExec(
            [col("n_nationkey"), col("n_name")],
            _broadcast_join(scan(nation), regions, ["n_regionkey"],
                            ["r_regionkey"]))
        return _broadcast_join(scan(supplier, SUPPLIER_STRING_MAX_LEN),
                               nations, ["s_nationkey"], ["n_nationkey"])

    # the subquery: each part's least European supply cost
    costs = _shuffled_join(scan(ps), ProjectExec([col("s_suppkey")],
                                                 eu_suppliers()),
                           ["ps_suppkey"], ["s_suppkey"], shuffle_partitions)
    mins = ProjectExec(
        [col("ps_partkey").alias("m_partkey"), col("min_cost")],
        Adaptive.OFF.grouped(CoalesceBatchesExec(costs, TargetSize()),
                             ["ps_partkey"], q2_aggregates,
                             shuffle_partitions))
    parts = FilterExec(And(EqualTo(col("p_size"), lit(Q2_SIZE)),
                           endswith(col("p_type"), Q2_TYPE_SUFFIX)),
                       scan(part))
    # the planner builds on part, the smaller side, and restores the order
    part_ps = _swap_back(_shuffled_join(scan(ps), parts, ["ps_partkey"],
                                        ["p_partkey"], shuffle_partitions),
                         parts, scan(ps))
    rows = _shuffled_join(part_ps, eu_suppliers(), ["ps_suppkey"],
                          ["s_suppkey"], shuffle_partitions)
    rows = _shuffled_join(rows, mins, ["p_partkey", "ps_supplycost"],
                          ["m_partkey", "min_cost"], shuffle_partitions)
    top = GlobalLimitExec(Q2_LIMIT, SortExec(
        [desc(col("s_acctbal")), asc(col("n_name")), asc(col("s_name")),
         asc(col("p_partkey"))], CoalesceBatchesExec(rows, TargetSize())))
    return ProjectExec([col(k) for k in Q2_SELECT], top)


def run_q2(part: pa.Table, supplier: pa.Table, partsupp: pa.Table,
           nation: pa.Table, region: pa.Table, num_slices: int = 8,
           shuffle_partitions: int = 8, device: DeviceLike = None
           ) -> pa.Table:
    """Q2 over the five tables, collected to the host."""
    return collect(q2_plan(part, supplier, partsupp, nation, region,
                           num_slices, shuffle_partitions, device))


def q11_aggregates(name: str = "value"):
    return [Sum(col("ps_supplycost") * col("ps_availqty")).alias(name)]


def q11_plan(partsupp: pa.Table, supplier: pa.Table, nation: pa.Table,
             fraction: float, num_slices: int = 8,
             shuffle_partitions: int = 8, device: DeviceLike = None) -> Exec:
    """TPC-H Q11 (spec 2.4.11, "Important Stock Identification") with
    NATION 'GERMANY' and ``fraction`` (the spec's 0.0001 / SF,
    ``q11_fraction``), as the tree the JAX planner gives it with AQE off
    at SF100::

        SELECT ps_partkey, sum(ps_supplycost * ps_availqty) AS value
        FROM partsupp, supplier, nation
        WHERE ps_suppkey = s_suppkey AND s_nationkey = n_nationkey
          AND n_name = 'GERMANY'
        GROUP BY ps_partkey
        HAVING sum(ps_supplycost * ps_availqty) >
               (SELECT sum(ps_supplycost * ps_availqty) * FRACTION
                FROM partsupp, supplier, nation WHERE ...)
        ORDER BY value DESC

    The HAVING against the scalar subquery is a nested-loop join of the
    grouped sums with the one-row global sum, broadcast, on the condition
    ``value > total * fraction``. The German rows are joined twice, once
    for each side, with the partsupp join shuffled and the nation build
    broadcast. Only the columns Q11 reads are scanned."""
    def scan(t: pa.Table, names: Sequence[str]) -> Exec:
        return _scan(_prune(t, names), num_slices, device)

    def german_rows() -> Exec:
        nations = FilterExec(EqualTo(col("n_name"), lit(Q11_NATION)),
                             scan(nation, Q11_COLUMNS["nation"]))
        suppliers = ProjectExec(
            [col("s_suppkey")],
            _broadcast_join(scan(supplier, Q11_COLUMNS["supplier"]),
                            nations, ["s_nationkey"], ["n_nationkey"]))
        return CoalesceBatchesExec(_shuffled_join(
            scan(partsupp, Q11_COLUMNS["partsupp"]), suppliers,
            ["ps_suppkey"], ["s_suppkey"], shuffle_partitions), TargetSize())

    groups = Adaptive.OFF.grouped(german_rows(), ["ps_partkey"],
                                  q11_aggregates, shuffle_partitions)
    total = Adaptive.OFF.grouped(german_rows(), [],
                                 lambda: q11_aggregates("total"),
                                 shuffle_partitions)
    having = BroadcastNestedLoopJoinExec(
        JoinType.INNER, groups, BroadcastExchangeExec(total),
        GreaterThan(col("value"), col("total") * lit(float(fraction))))
    return SortExec([desc(col("value"))],
                    ProjectExec([col("ps_partkey"), col("value")], having))


def run_q11(partsupp: pa.Table, supplier: pa.Table, nation: pa.Table,
            fraction: float, num_slices: int = 8,
            shuffle_partitions: int = 8, device: DeviceLike = None
            ) -> pa.Table:
    """Q11 over the three tables, collected to the host."""
    return collect(q11_plan(partsupp, supplier, nation, fraction,
                            num_slices, shuffle_partitions, device))


# ---------------------------------------------------------------------------
# TPC-H Q16, whole
# ---------------------------------------------------------------------------

#: Q16's supplier pattern (spec 2.4.16: NOT IN the suppliers with
#: complaints) and the words dbgen writes into S_COMMENT for it
Q16_COMMENT = "%Customer%Complaints%"
Q16_SELECT = ("p_brand", "p_type", "p_size", "supplier_cnt")
_CUSTOMER, _COMPLAINTS, _RECOMMENDS = b"Customer", b"Complaints", \
    b"Recommends"


def _comments_with(rng, rows: np.ndarray, first: bytes, second: bytes,
                   mat: np.ndarray, lengths: np.ndarray) -> None:
    """Write ``first`` and, later in the comment, ``second`` into each of
    ``rows`` of the letter matrix ``mat`` at random positions (spec
    4.2.3's S_COMMENT rule), all rows at once."""
    span = len(first) + len(second)
    free = lengths[rows] - span
    p1 = (rng.random(len(rows)) * (free + 1)).astype(np.int64)
    p2 = p1 + len(first) + (rng.random(len(rows))
                            * (free - p1 + 1)).astype(np.int64)
    for word, at in ((first, p1), (second, p2)):
        cols = at[:, None] + np.arange(len(word))[None, :]
        mat[rows[:, None], cols] = np.frombuffer(word, np.uint8)[None, :]


def tpch_q16_tables(sf: float, seed: int = 16
                    ) -> Tuple[pa.Table, pa.Table, pa.Table]:
    """``(part, supplier, partsupp)``: every column Q16 reads at scale
    factor ``sf``, drawn as dbgen draws them (TPC-H spec 4.2.3) from one
    numpy generator, with no Python loop per row:

    - part: SF x 200,000 rows, P_PARTKEY 1..n, P_BRAND, P_TYPE and P_SIZE
      as ``part_table`` draws them;
    - supplier: SF x 10,000 rows, S_SUPPKEY 1..n, S_COMMENT 25 to 100
      random letters; in ``max(round(SF * 5), 1)`` random rows 'Customer'
      is followed later by 'Complaints', in as many others by
      'Recommends', at random positions;
    - partsupp: four rows per part, PS_SUPPKEY by dbgen's formula (as
      ``tpch_q2_tables``).

    Keys are int64."""
    rng = np.random.default_rng(seed)
    n_part = max(int(round(200_000 * sf)), 1)
    n_supp = max(int(round(10_000 * sf)), 1)
    partkey = np.arange(1, n_part + 1, dtype=np.int64)
    brand = rng.integers(0, len(P_BRANDS), n_part)
    ptype = rng.integers(0, len(P_TYPES), n_part)
    size = rng.integers(1, 51, n_part).astype(np.int32)
    part = pa.table({
        "p_partkey": partkey,
        "p_brand": pa.array(P_BRANDS).take(pa.array(brand)),
        "p_type": pa.array(P_TYPES).take(pa.array(ptype)),
        "p_size": size,
    })
    lengths = rng.integers(25, 101, n_supp)
    mat = _LETTERS[rng.integers(0, len(_LETTERS), (n_supp, 100),
                                dtype=np.uint8)]
    k = max(int(round(sf * 5)), 1)
    picked = rng.permutation(n_supp)[:2 * k]
    _comments_with(rng, picked[:k], _CUSTOMER, _COMPLAINTS, mat, lengths)
    _comments_with(rng, picked[k:], _CUSTOMER, _RECOMMENDS, mat, lengths)
    supplier = pa.table({
        "s_suppkey": np.arange(1, n_supp + 1, dtype=np.int64),
        "s_comment": _strings(mat, lengths),
    })
    ps_partkey = np.repeat(partkey, 4)
    i = np.tile(np.arange(4, dtype=np.int64), n_part)
    partsupp = pa.table({
        "ps_partkey": ps_partkey,
        "ps_suppkey": (ps_partkey + i * (n_supp // 4
                                         + (ps_partkey - 1) // n_supp))
        % n_supp + 1,
    })
    return part, supplier, partsupp


def q16_reference(part: pa.Table, supplier: pa.Table, partsupp: pa.Table
                  ) -> pa.Table:
    """TPC-H Q16 computed by pyarrow alone (``pc.match_like``,
    ``pc.starts_with``, Acero joins and ``group_by`` with a distinct
    count), in ``run_q16``'s column order."""
    keep = pc.and_kleene(
        pc.and_kleene(
            pc.not_equal(part.column("p_brand"), Q16_BRAND),
            pc.invert(pc.starts_with(part.column("p_type"),
                                     Q16_TYPE_PREFIX))),
        pc.is_in(part.column("p_size"),
                 value_set=pa.array(Q16_SIZES, pa.int32())))
    p = part.filter(keep)
    j = partsupp.join(p, keys="ps_partkey", right_keys="p_partkey",
                      join_type="inner")
    bad = supplier.filter(pc.match_like(supplier.column("s_comment"),
                                        Q16_COMMENT))
    j = j.join(bad.select(["s_suppkey"]), keys="ps_suppkey",
               right_keys="s_suppkey", join_type="left anti")
    g = j.group_by(list(Q16_KEYS)).aggregate(
        [("ps_suppkey", "count_distinct")])
    g = g.sort_by([("ps_suppkey_count_distinct", "descending")]
                  + [(k, "ascending") for k in Q16_KEYS])
    return pa.table([g.column(k) for k in Q16_KEYS]
                    + [g.column("ps_suppkey_count_distinct")],
                    names=list(Q16_SELECT))


def run_q16(part: pa.Table, supplier: pa.Table, partsupp: pa.Table,
            num_slices: int = 8, shuffle_partitions: int = 8,
            device: DeviceLike = None) -> pa.Table:
    """Q16 through the port's Session (``q16_df`` under
    ``session_conf``), collected to the host."""
    from .plan.session import Session
    return Session(session_conf(shuffle_partitions), device=device).collect(
        q16_df(part, supplier, partsupp, num_slices))


# ---------------------------------------------------------------------------
# TPC-H Q14 and Q9: CASE WHEN, add_months, year() and the string
# predicates through the Session
# ---------------------------------------------------------------------------

#: Q14's validation DATE (spec 2.4.14.3) and the P_TYPE prefix it sums
Q14_DATE = datetime.date(1995, 9, 1)
Q14_TYPE_PREFIX = "PROMO"
Q14_SELECT = ("promo_revenue",)
#: Q9's validation COLOR (spec 2.4.9.3), its group keys and select list
Q9_COLOR = "green"
Q9_KEYS = ("nation", "o_year")
Q9_SELECT = ("nation", "o_year", "sum_profit")
#: TPC-H spec 4.2.3: the 92 words of P_NAME
P_NAME_WORDS = (
    "almond", "antique", "aquamarine", "azure", "beige", "bisque", "black",
    "blanched", "blue", "blush", "brown", "burlywood", "burnished",
    "chartreuse", "chiffon", "chocolate", "coral", "cornflower", "cornsilk",
    "cream", "cyan", "dark", "deep", "dim", "dodger", "drab", "firebrick",
    "floral", "forest", "frosted", "gainsboro", "ghost", "goldenrod",
    "green", "grey", "honeydew", "hot", "indian", "ivory", "khaki", "lace",
    "lavender", "lawn", "lemon", "light", "lime", "linen", "magenta",
    "maroon", "medium", "metallic", "midnight", "mint", "misty", "moccasin",
    "navajo", "navy", "olive", "orange", "orchid", "pale", "papaya",
    "peach", "peru", "pink", "plum", "powder", "puff", "purple", "red",
    "rose", "rosy", "royal", "saddle", "salmon", "sandy", "seashell",
    "sienna", "sky", "slate", "smoke", "snow", "spring", "steel", "tan",
    "thistle", "tomato", "turquoise", "violet", "wheat", "white", "yellow")


def _part_names(rng, n: int) -> pa.Array:
    """P_NAME: five distinct words of ``P_NAME_WORDS`` joined by spaces,
    drawn for every row at once (the k-th draw takes the r-th word not yet
    taken)."""
    picked = np.empty((n, 5), np.int64)
    for k in range(5):
        r = rng.integers(0, len(P_NAME_WORDS) - k, n)
        taken = np.sort(picked[:, :k], axis=1)
        for j in range(k):
            r += r >= taken[:, j]
        picked[:, k] = r
    words = pa.array(P_NAME_WORDS)
    return pc.binary_join_element_wise(
        *[words.take(pa.array(picked[:, k])) for k in range(5)], " ")


def tpch_q14_tables(sf: float, seed: int = 3
                    ) -> Tuple[pa.Table, pa.Table]:
    """``(lineitem, part)``: the columns Q14 reads at scale factor ``sf``.
    ``lineitem`` is ``_tpch_columns``' with its part keys (L_SHIPDATE and
    the money of Q3's draws); ``part`` is SF x 200,000 rows, P_PARTKEY
    1..n and P_TYPE as ``part_table`` draws it, from a generator of its
    own."""
    return _q14_tables(_tpch_columns(sf, seed, part_keys=True), sf, seed)


def tpch_q9_tables(sf: float, seed: int = 3) -> Tuple[pa.Table, ...]:
    """``(part, supplier, partsupp, lineitem, orders, nation)``: the columns
    Q9 reads at scale factor ``sf``. ``lineitem`` and ``orders`` are
    ``_tpch_columns``' (with the part keys; L_QUANTITY is Q18's draw);
    from a generator of their own:

    - part: SF x 200,000 rows, P_PARTKEY 1..n, P_NAME five distinct words
      of the spec's 92 (at most 55 bytes);
    - supplier: SF x 10,000 rows, S_SUPPKEY 1..n, S_NATIONKEY uniform in
      0..24;
    - partsupp: four rows per part, PS_SUPPKEY by dbgen's formula (the
      suppliers L_SUPPKEY picks from), PS_SUPPLYCOST in [1.00, 1000.00] by
      0.01;
    - nation: the spec's 25 rows.

    Keys are int64, money float64."""
    return _q9_tables(_tpch_columns(sf, seed, part_keys=True), sf, seed)


def tpch_q14_q9_tables(sf: float, seed: int = 3):
    """``(tpch_q14_tables(sf, seed), tpch_q9_tables(sf, seed))`` from one
    draw of ``_tpch_columns``."""
    c = _tpch_columns(sf, seed, part_keys=True)
    return _q14_tables(c, sf, seed), _q9_tables(c, sf, seed)


def _q14_tables(c: Dict[str, object], sf: float, seed: int):
    rng = np.random.default_rng((seed, 14))
    n_part = _part_rows(sf)
    part = pa.table({
        "p_partkey": np.arange(1, n_part + 1, dtype=np.int64),
        "p_type": pa.array(P_TYPES).take(
            pa.array(rng.integers(0, len(P_TYPES), n_part))),
    })
    return (_tpch_table(c, ("l_partkey", "l_extendedprice", "l_discount",
                            "l_shipdate")), part)


def _q9_tables(c: Dict[str, object], sf: float, seed: int):
    rng = np.random.default_rng((seed, 9))
    n_part, n_supp = _part_rows(sf), _supplier_rows(sf)
    partkey = np.arange(1, n_part + 1, dtype=np.int64)
    part = pa.table({"p_partkey": partkey,
                     "p_name": _part_names(rng, n_part)})
    supplier = pa.table({
        "s_suppkey": np.arange(1, n_supp + 1, dtype=np.int64),
        "s_nationkey": rng.integers(0, len(NATIONS), n_supp).astype(np.int64),
    })
    ps_partkey = np.repeat(partkey, 4)
    partsupp = pa.table({
        "ps_partkey": ps_partkey,
        "ps_suppkey": _supplier_of(ps_partkey,
                                   np.tile(np.arange(4), n_part), n_supp),
        "ps_supplycost": rng.integers(100, 100_001, 4 * n_part) / 100.0,
    })
    nation = pa.table({
        "n_nationkey": np.arange(len(NATIONS), dtype=np.int64),
        "n_name": [name for name, _ in NATIONS],
    })
    return (part, supplier, partsupp,
            _tpch_table(c, ("l_orderkey", "l_partkey", "l_suppkey",
                            "l_quantity", "l_extendedprice", "l_discount")),
            _tpch_table(c, ("o_orderkey", "o_orderdate")), nation)


def _revenue() -> Expression:
    return col("l_extendedprice") * (lit(1.0) - col("l_discount"))


def q14_df(lineitem: pa.Table, part: pa.Table, num_slices: int = 8):
    """TPC-H Q14 as a DataFrame (spec 2.4.14)::

        SELECT 100.00 * sum(CASE WHEN p_type LIKE 'PROMO%'
                                 THEN l_extendedprice * (1 - l_discount)
                                 ELSE 0 END)
               / sum(l_extendedprice * (1 - l_discount)) AS promo_revenue
        FROM lineitem, part
        WHERE l_partkey = p_partkey AND l_shipdate >= date '1995-09-01'
          AND l_shipdate < date '1995-09-01' + interval '1' month

    with the LIKE as Spark's LikeSimplification leaves it (StartsWith),
    the month as ``add_months`` and the CASE as ``CaseWhen``."""
    start = lit(Q14_DATE)
    promo = CaseWhen(((startswith(col("p_type"), Q14_TYPE_PREFIX),
                       _revenue()),), lit(0.0))
    return (_df(lineitem, num_slices)
            .where(And(col("l_shipdate") >= start,
                       col("l_shipdate") < add_months(lit(Q14_DATE), 1)))
            .join(_df(part, num_slices), ["l_partkey"], ["p_partkey"])
            .agg(Sum(promo).alias("promo"), Sum(_revenue()).alias("total"))
            .select((lit(100.0) * col("promo") / col("total"))
                    .alias("promo_revenue")))


def run_q14(lineitem: pa.Table, part: pa.Table, num_slices: int = 8,
            shuffle_partitions: int = 8,
            device: DeviceLike = None) -> pa.Table:
    """Q14 through the port's Session (``q14_df`` under
    ``session_conf``), collected to the host."""
    from .plan.session import Session
    return Session(session_conf(shuffle_partitions), device=device).collect(
        q14_df(lineitem, part, num_slices))


def q14_reference(lineitem: pa.Table, part: pa.Table) -> pa.Table:
    """TPC-H Q14 computed by pyarrow alone: the month's lines, an Acero
    join with part, and the two sums."""
    lo = pa.scalar(Q14_DATE, pa.date32())
    hi = pa.scalar(Q14_DATE.replace(month=Q14_DATE.month + 1), pa.date32())
    d = lineitem.column("l_shipdate")
    li = lineitem.filter(pc.and_(pc.greater_equal(d, lo), pc.less(d, hi)))
    j = li.join(part, keys="l_partkey", right_keys="p_partkey",
                join_type="inner")
    rev = pc.multiply(j.column("l_extendedprice"),
                      pc.subtract(1.0, j.column("l_discount")))
    promo = pc.if_else(pc.starts_with(j.column("p_type"), Q14_TYPE_PREFIX),
                       rev, 0.0)
    value = 100.0 * pc.sum(promo).as_py() / pc.sum(rev).as_py()
    return pa.table({"promo_revenue": pa.array([value], pa.float64())})


def q9_df(part: pa.Table, supplier: pa.Table, partsupp: pa.Table,
          lineitem: pa.Table, orders: pa.Table, nation: pa.Table,
          num_slices: int = 8):
    """TPC-H Q9 as a DataFrame (spec 2.4.9)::

        SELECT nation, o_year, sum(amount) AS sum_profit
        FROM (SELECT n_name AS nation, year(o_orderdate) AS o_year,
                     l_extendedprice * (1 - l_discount)
                       - ps_supplycost * l_quantity AS amount
              FROM part, supplier, lineitem, partsupp, orders, nation
              WHERE s_suppkey = l_suppkey AND ps_suppkey = l_suppkey
                AND ps_partkey = l_partkey AND p_partkey = l_partkey
                AND o_orderkey = l_orderkey AND s_nationkey = n_nationkey
                AND p_name LIKE '%green%')
        GROUP BY nation, o_year ORDER BY nation, o_year DESC

    with the LIKE as Spark leaves it (Contains) and five joins from
    lineitem, the partsupp one on two keys."""
    green = (_df(part, num_slices)
             .where(contains(col("p_name"), Q9_COLOR))
             .select("p_partkey"))
    amount = _revenue() - col("ps_supplycost") * col("l_quantity")
    return (_df(lineitem, num_slices)
            .join(green, ["l_partkey"], ["p_partkey"])
            .join(_df(supplier, num_slices), ["l_suppkey"], ["s_suppkey"])
            .join(_df(partsupp, num_slices), ["l_suppkey", "l_partkey"],
                  ["ps_suppkey", "ps_partkey"])
            .join(_df(orders, num_slices), ["l_orderkey"], ["o_orderkey"])
            .join(_df(nation, num_slices), ["s_nationkey"], ["n_nationkey"])
            .select(col("n_name").alias("nation"),
                    year(col("o_orderdate")).alias("o_year"),
                    amount.alias("amount"))
            .group_by(*Q9_KEYS)
            .agg(Sum(col("amount")).alias("sum_profit"))
            .order_by(asc(col("nation")), desc(col("o_year"))))


def run_q9(part: pa.Table, supplier: pa.Table, partsupp: pa.Table,
           lineitem: pa.Table, orders: pa.Table, nation: pa.Table,
           num_slices: int = 8, shuffle_partitions: int = 8,
           device: DeviceLike = None) -> pa.Table:
    """Q9 through the port's Session (``q9_df`` under ``session_conf``),
    collected to the host."""
    from .plan.session import Session
    return Session(session_conf(shuffle_partitions), device=device).collect(
        q9_df(part, supplier, partsupp, lineitem, orders, nation,
              num_slices))


def q9_reference(part: pa.Table, supplier: pa.Table, partsupp: pa.Table,
                 lineitem: pa.Table, orders: pa.Table, nation: pa.Table
                 ) -> pa.Table:
    """TPC-H Q9 computed by pyarrow alone (``pc.match_substring``, Acero
    joins, ``pc.year``, ``group_by``), in ``run_q9``'s order."""
    green = part.filter(pc.match_substring(part.column("p_name"), Q9_COLOR))
    j = lineitem.join(green.select(["p_partkey"]), keys="l_partkey",
                      right_keys="p_partkey", join_type="inner")
    j = j.join(supplier, keys="l_suppkey", right_keys="s_suppkey",
               join_type="inner")
    j = j.join(partsupp, keys=["l_suppkey", "l_partkey"],
               right_keys=["ps_suppkey", "ps_partkey"], join_type="inner")
    j = j.join(orders, keys="l_orderkey", right_keys="o_orderkey",
               join_type="inner")
    j = j.join(nation, keys="s_nationkey", right_keys="n_nationkey",
               join_type="inner")
    amount = pc.subtract(
        pc.multiply(j.column("l_extendedprice"),
                    pc.subtract(1.0, j.column("l_discount"))),
        pc.multiply(j.column("ps_supplycost"), j.column("l_quantity")))
    t = pa.table({"nation": j.column("n_name"),
                  "o_year": pc.cast(pc.year(j.column("o_orderdate")),
                                    pa.int32()),
                  "amount": amount})
    g = t.group_by(list(Q9_KEYS)).aggregate([("amount", "sum")]).sort_by(
        [("nation", "ascending"), ("o_year", "descending")])
    return pa.table([g.column("nation"), g.column("o_year"),
                     g.column("amount_sum")], names=list(Q9_SELECT))


# ---------------------------------------------------------------------------
# The part-catalogue roll-up: the rest of strings.py and the span programs
# ---------------------------------------------------------------------------

#: the catalogue's class words, in find_in_set's order (P_TYPE's first
#: syllables, TPC-H spec 4.2.2.13)
CATALOG_CLASSES = "STANDARD,SMALL,MEDIUM,LARGE,ECONOMY,PROMO"
#: the roll-up's output columns
CATALOG_SELECT = ("label", "class_no", "class_bits", "parts_fmt",
                  "first_hex", "brand_b36", "promo", "parts", "size_sum")
#: the roll-up scans part at 32 bytes a string: P_TYPE is VARCHAR(25) and
#: P_BRAND CHAR(10) (TPC-H spec 1.4.1), and a span scan's cost grows with
#: the square of the width
CATALOG_STRING_MAX_LEN = 32
#: the comment leg's patterns: the words between 'Customer' and
#: 'Complaints' (19 segments), and every run of two or more vowels
COMMENT_EXTRACT = "Customer([A-Za-z]*)Complaints"
COMMENT_REPLACE = "[aeiou][aeiou]+"
COMMENT_SELECT = ("s_suppkey", "complaint", "squeezed")


def catalog_df(part: pa.Table, num_slices: int = 8,
               string_max_len: int = CATALOG_STRING_MAX_LEN):
    """A product catalogue's clean-up and roll-up over TPC-H ``part``::

        SELECT concat_ws(' / ', line, material, brand_no) AS label,
               class_no, bin(class_no) AS class_bits,
               format_number(parts, 0) AS parts_fmt,
               hex(first_key) AS first_hex,
               conv(brand_no, 10, 36) AS brand_b36,
               empty2null(regexp_extract(line, 'Promo', 0)) AS promo,
               parts, size_sum
        FROM (SELECT material, class_no, line, brand_no, count(*) AS parts,
                     sum(p_size) AS size_sum, min(p_partkey) AS first_key
              FROM (SELECT
                      regexp_extract(p_type,
                          '^([A-Z]+) ([A-Z]+) ([A-Z]+)$', 3) AS material,
                      find_in_set(regexp_extract(p_type, '^([A-Z]+) ', 1),
                          'STANDARD,SMALL,MEDIUM,LARGE,ECONOMY,PROMO')
                          AS class_no,
                      initcap(regexp_replace(p_type, ' [A-Z]+$', ''))
                          AS line,
                      regexp_replace(p_brand, '[^0-9]+', '') AS brand_no,
                      p_size, p_partkey
                    FROM part)
              GROUP BY material, class_no, line, brand_no)
        ORDER BY parts DESC, label

    One group per P_TYPE and P_BRAND pair (3,750 over the 150 types and
    25 brands); every column an integer or a string."""
    from .expressions import (Bin, ConcatWs, Conv, Empty2Null, FindInSet,
                              FormatNumber, Hex, InitCap, RegexpExtract,
                              RegexpReplace)
    rows = (_df(part, num_slices, string_max_len)
            .select(RegexpExtract(col("p_type"),
                                  "^([A-Z]+) ([A-Z]+) ([A-Z]+)$",
                                  3).alias("material"),
                    FindInSet(RegexpExtract(col("p_type"), "^([A-Z]+) ", 1),
                              lit(CATALOG_CLASSES)).alias("class_no"),
                    InitCap(RegexpReplace(col("p_type"), " [A-Z]+$",
                                          "")).alias("line"),
                    RegexpReplace(col("p_brand"), "[^0-9]+",
                                  "").alias("brand_no"),
                    col("p_size"), col("p_partkey")))
    groups = (rows.group_by("material", "class_no", "line", "brand_no")
              .agg(Count().alias("parts"), Sum(col("p_size")).alias(
                  "size_sum"), Min(col("p_partkey")).alias("first_key")))
    return (groups.select(
        ConcatWs(lit(" / "), (col("line"), col("material"),
                              col("brand_no"))).alias("label"),
        col("class_no"), Bin(col("class_no")).alias("class_bits"),
        FormatNumber(col("parts"), 0).alias("parts_fmt"),
        Hex(col("first_key")).alias("first_hex"),
        Conv(col("brand_no"), lit(10), lit(36)).alias("brand_b36"),
        Empty2Null(RegexpExtract(col("line"), "Promo", 0)).alias("promo"),
        col("parts"), col("size_sum"))
        .order_by(desc(col("parts")), asc(col("label"))))


def run_catalog(part: pa.Table, num_slices: int = 8,
                shuffle_partitions: int = 8,
                device: DeviceLike = None) -> pa.Table:
    """The roll-up through the port's Session (``catalog_df`` under
    ``session_conf``), collected to the host."""
    from .plan.session import Session
    return Session(session_conf(shuffle_partitions), device=device).collect(
        catalog_df(part, num_slices))


def _initcap(s: str) -> str:
    """Spark's initcap over ASCII text: each space-separated word's first
    letter upper, the rest lower."""
    return " ".join(w[:1].upper() + w[1:].lower() for w in s.split(" "))


def _base36(s: str) -> str:
    digits = "0123456789ABCDEFGHIJKLMNOPQRSTUVWXYZ"
    v, out = int(s) if s else 0, ""
    while v:
        v, d = divmod(v, 36)
        out = digits[d] + out
    return out or "0"


def _per_value(column, fn) -> pa.Array:
    """``fn`` over each distinct value of ``column``, taken back per row
    (P_TYPE has 150 values and P_BRAND 25, so RE2 runs once a value)."""
    codes = pc.dictionary_encode(column).combine_chunks()
    return pc.take(fn(codes.dictionary), codes.indices)


def catalog_reference(part: pa.Table) -> pa.Table:
    """The roll-up computed by pyarrow and Python alone: the per-row
    columns with ``pc.extract_regex`` (no match gives '', as in Spark),
    ``pc.replace_substring_regex`` and the class list's index + 1, a
    pyarrow group-by, then each of the groups formatted in Python; in
    ``catalog_df``'s column types and order."""
    classes = pa.array(CATALOG_CLASSES.split(","))

    def material(v):
        words = pc.extract_regex(
            v, r"^(?P<c>[A-Z]+) (?P<f>[A-Z]+) (?P<m>[A-Z]+)$")
        return pc.fill_null(pc.struct_field(words, "m"), "")

    def class_no(v):
        first = pc.struct_field(pc.extract_regex(v, r"^(?P<w>[A-Z]+) "),
                                "w")
        return pc.add(pc.fill_null(pc.index_in(first, classes), -1),
                      1).cast(pa.int32())

    ptype = part.column("p_type")
    rows = pa.table({
        "material": _per_value(ptype, material),
        "class_no": _per_value(ptype, class_no),
        "line": _per_value(ptype, lambda v: pc.replace_substring_regex(
            v, r" [A-Z]+$", "")),
        "brand_no": _per_value(
            part.column("p_brand"),
            lambda v: pc.replace_substring_regex(v, r"[^0-9]+", "")),
        "p_size": part.column("p_size").cast(pa.int64()),
        "p_partkey": part.column("p_partkey"),
    })
    g = rows.group_by(["material", "class_no", "line", "brand_no"]
                      ).aggregate([([], "count_all"), ("p_size", "sum"),
                                   ("p_partkey", "min")])
    out = []
    for r in g.to_pylist():
        line = _initcap(r["line"])
        out.append({
            "label": f"{line} / {r['material']} / {r['brand_no']}",
            "class_no": r["class_no"],
            "class_bits": format(r["class_no"], "b"),
            "parts_fmt": f"{r['count_all']:,}",
            "first_hex": format(r["p_partkey_min"] & ((1 << 64) - 1), "X"),
            "brand_b36": _base36(r["brand_no"]),
            "promo": "Promo" if "Promo" in line else None,
            "parts": r["count_all"], "size_sum": r["p_size_sum"]})
    out.sort(key=lambda r: (-r["parts"], r["label"].encode()))
    types = {"class_no": pa.int32(), "parts": pa.int64(),
             "size_sum": pa.int64()}
    return pa.table({k: pa.array([r[k] for r in out],
                                 types.get(k, pa.string()))
                     for k in CATALOG_SELECT})


def comment_spans_df(supplier: pa.Table, num_slices: int = 8):
    """The span scans over long strings: S_COMMENT (25-100 letters, 128
    bytes a string) through ``regexp_extract(s_comment,
    'Customer([A-Za-z]*)Complaints', 1)`` and ``regexp_replace(s_comment,
    '[aeiou][aeiou]+', '_')``."""
    from .expressions import RegexpExtract, RegexpReplace
    return _df(supplier, num_slices, SUPPLIER_STRING_MAX_LEN).select(
        col("s_suppkey"),
        RegexpExtract(col("s_comment"), COMMENT_EXTRACT, 1).alias(
            "complaint"),
        RegexpReplace(col("s_comment"), COMMENT_REPLACE, "_").alias(
            "squeezed"))


def comment_spans_reference(supplier: pa.Table) -> pa.Table:
    """``comment_spans_df`` by pyarrow's RE2 (greedy, no alternation:
    there RE2 and Java agree); a row with no match extracts ''."""
    c = supplier.column("s_comment")
    pattern = COMMENT_EXTRACT.replace("(", "(?P<g>", 1)
    return pa.table({
        "s_suppkey": supplier.column("s_suppkey"),
        "complaint": pc.fill_null(pc.struct_field(
            pc.extract_regex(c, pattern), "g"), ""),
        "squeezed": pc.replace_substring_regex(c, COMMENT_REPLACE, "_"),
    })


# ---------------------------------------------------------------------------
# The skewed join (tools/skew_bench.py's shape)
# ---------------------------------------------------------------------------

#: the skew bench's legs (``tools/skew_bench.LEGS``): AQE off; coalesce and
#: skew split; and those with the runtime broadcast switch
SKEW_LEGS = ("static", "adaptive", "adaptive_bcast")
#: the bench's fact slices (its upstream map tasks: one piece per slice
#: per shuffle partition, the granularity a skewed partition splits at)
SKEW_SLICES = 16
SKEW_PARTITIONS = 32
#: the bench's ``skewJoin.splitRows`` (16,384 of its 131,072 fact rows)
SKEW_SPLIT_ROWS_BENCH = 1 << 14


def skew_tables(rows: int = 1 << 17, keys: int = 1 << 12,
                hot_frac: float = 0.5, seed: int = 29
                ) -> Tuple[pa.Table, pa.Table]:
    """``(fact, dim)``: the skew bench's draws
    (``tools/skew_bench.make_skewed_tables``). Key 0 takes ``hot_frac`` of
    the fact rows and the rest are uniform over keys 1 to ``keys - 1``, so
    after hash partitioning one shuffle partition holds about ``hot_frac``
    of the table; ``g`` is one of 64 groups and ``v`` a measure. The dim
    has one row per key, ``dk`` with a measure ``w``."""
    rng = np.random.default_rng(seed)
    n_hot = int(rows * hot_frac)
    k = np.concatenate([
        np.zeros(n_hot, dtype=np.int64),
        rng.integers(1, keys, rows - n_hot).astype(np.int64)])
    rng.shuffle(k)
    fact = pa.table({
        "k": k,
        "g": rng.integers(0, 64, rows).astype(np.int32),
        "v": rng.integers(-1000, 1000, rows).astype(np.int64),
    })
    dim = pa.table({
        "dk": np.arange(keys, dtype=np.int64),
        "w": rng.integers(0, 10, keys).astype(np.int64),
    })
    return fact, dim


def skew_aggregates():
    return [Sum(col("v")).alias("sv"), Sum(col("w")).alias("sw"),
            Count().alias("c")]


def skew_plan(fact: pa.Table, dim: pa.Table, leg: str = "adaptive_bcast",
              split_rows: int = SKEW_SPLIT_ROWS_BENCH,
              num_slices: int = SKEW_SLICES,
              shuffle_partitions: int = SKEW_PARTITIONS,
              target_rows: int = ADAPTIVE_TARGET_ROWS.default,
              device: DeviceLike = None) -> Exec:
    """The tree the JAX Session gives the skew bench's query
    (``tools/skew_bench._query``: fact JOIN dim ON k = dk, GROUP BY g with
    sum(v), sum(w) and count(*), ORDER BY g) under the conf of ``leg``:
    the join shuffled in every leg (``autoBroadcastJoinThreshold`` 0);
    ``adaptive`` splits a stream partition over ``split_rows`` rows;
    ``adaptive_bcast`` also switches the join to a broadcast when the dim
    measures at most ``max(dim rows, 2^16)`` rows. The fact scans in
    ``num_slices`` slices of one batch each, the dim in one."""
    if leg not in SKEW_LEGS:
        raise ValueError(f"leg {leg!r} is not one of {SKEW_LEGS}")
    aqe = Adaptive(
        leg != "static", target_rows, split_rows,
        max(dim.num_rows, 1 << 16) if leg == "adaptive_bcast" else None)
    dev = resolve_device(device)
    facts = InMemoryScanExec(fact, schema_from_arrow(fact.schema),
                             batch_rows=max(1, fact.num_rows // num_slices),
                             num_slices=num_slices, device=dev)
    dims = InMemoryScanExec(dim, schema_from_arrow(dim.schema), device=dev)
    joined = aqe.shuffled_join([col("k")], [col("dk")], JoinType.INNER,
                               facts, dims, shuffle_partitions)
    final = aqe.grouped(CoalesceBatchesExec(joined, TargetSize()), ["g"],
                        skew_aggregates, shuffle_partitions)
    return SortExec([asc(col("g"))], final)


def run_skew(fact: pa.Table, dim: pa.Table, leg: str = "adaptive_bcast",
             device: DeviceLike = None, **kw) -> pa.Table:
    """The skew bench's query under ``leg``, collected to the host
    (``kw``: the other arguments of ``skew_plan``)."""
    return collect(skew_plan(fact, dim, leg, device=device, **kw))


def skew_reference(fact: pa.Table, dim: pa.Table) -> pa.Table:
    """The skew bench's query computed by pyarrow alone."""
    j = fact.join(dim, keys="k", right_keys="dk", join_type="inner")
    g = j.group_by("g").aggregate([("v", "sum"), ("w", "sum"),
                                   ("g", "count")])
    out = pa.table([g.column("g"), g.column("v_sum"), g.column("w_sum"),
                    g.column("g_count")], names=["g", "sv", "sw", "c"])
    return out.sort_by("g")


# ---------------------------------------------------------------------------
# Parquet: the bench's scan, Q1 and Q16's part stage read from files, and
# the bucketed lineitem write
# ---------------------------------------------------------------------------

#: the columns Q1 reads (``lineitem_table``'s)
Q1_COLUMNS = ("l_returnflag", "l_linestatus", "l_quantity",
              "l_extendedprice", "l_discount", "l_shipdate", "l_tax")
#: ``bench.bench_parquet_scan``'s projection; its predicate is Q1's filter
PARQUET_SCAN_COLUMNS = ("l_quantity", "l_extendedprice", "l_shipdate")
#: the bucketed write's key (an int32 column, hashed by murmur3_int32)
BUCKET_KEY = "l_shipdate"


def parquet_files(table: pa.Table, directory: str, n_files: int,
                  **write_kw) -> list:
    """Write ``table`` as ``n_files`` Parquet files of consecutive rows
    (``part-{i}.parquet`` under ``directory``, pyarrow's writer defaults
    unless ``write_kw`` says otherwise), as ``bench.bench_parquet_scan``
    lays out its input; every row lands in a file. Returns the paths."""
    import os
    import pyarrow.parquet as pq
    os.makedirs(directory, exist_ok=True)
    per = max(1, -(-table.num_rows // n_files))
    paths = []
    for i in range(n_files):
        path = os.path.join(directory, f"part-{i}.parquet")
        pq.write_table(table.slice(i * per, per), path, **write_kw)
        paths.append(path)
    return paths


def _file_scan(paths, columns: Sequence[str],
               predicate: Optional[Expression], num_slices: int,
               device: DeviceLike, reader_type=None,
               conf: Optional[Dict] = None) -> Exec:
    """A Parquet scan of ``paths`` with the projection and the predicate
    pushed down, under the reader keys of ``conf`` (default: theirs; the
    JAX planner applies the Session's conf to the source,
    ``plan/overrides.py:961``)."""
    from .io.parquet import ParquetSource
    from .io.scan import FileSourceScanExec
    from .io.source import ReaderType
    source = ParquetSource(paths, columns=list(columns), predicate=predicate,
                           reader_type=reader_type or ReaderType.AUTO)
    source.apply_conf(conf or {})
    return FileSourceScanExec(source, num_slices, device=device)


def parquet_scan_plan(paths, num_slices: int = 1, reader_type=None,
                      device: DeviceLike = None) -> Exec:
    """``bench.bench_parquet_scan``'s scan: ``PARQUET_SCAN_COLUMNS`` where
    ``l_shipdate <= 10471``, MULTITHREADED unless ``reader_type`` (an
    ``io.source.ReaderType``) says otherwise; its batches land on the
    device."""
    from .io.source import ReaderType
    return _file_scan(paths, PARQUET_SCAN_COLUMNS,
                      col("l_shipdate") <= lit(Q1_SHIPDATE_MAX),
                      num_slices, device,
                      reader_type or ReaderType.MULTITHREADED)


def q1_parquet_plan(paths, num_slices: int = 8, shuffle_partitions: int = 8,
                    device: DeviceLike = None) -> Exec:
    """Q1's physical tree with a ``FileSourceScanExec`` of ``paths`` in
    place of the in-memory scan: Q1's columns, its filter pushed down and
    kept above the scan in a ``FilterExec``, as the JAX planner keeps it.
    The file schema is nullable, so the aggregates and the exchange run
    their nullable branches."""
    cond = col("l_shipdate") <= lit(Q1_SHIPDATE_MAX)
    return _grouped_stage(
        _file_scan(paths, Q1_COLUMNS, cond, num_slices, device), cond,
        Q1_KEYS, q1_aggregates, shuffle_partitions,
        [asc(col(k)) for k in Q1_KEYS])


def run_q1_parquet(paths, num_slices: int = 8, shuffle_partitions: int = 8,
                   device: DeviceLike = None) -> pa.Table:
    """Q1 over the lineitem files ``paths``, collected to the host."""
    return collect(q1_parquet_plan(paths, num_slices, shuffle_partitions,
                                   device))


def q16_part_parquet_plan(paths, num_slices: int = 8,
                          shuffle_partitions: int = 8,
                          device: DeviceLike = None, pushdown: bool = True,
                          conf: Optional[Dict] = None) -> Exec:
    """The tree of Q16's part stage over the part files ``paths``, its
    predicate kept in a ``FilterExec`` and, with ``pushdown``, pushed down
    too (pyarrow takes none of it but ``p_size IN``, and the row groups'
    statistics prune nothing). Without it the readers hand the string
    columns over as dictionary codes (none do under a pushed predicate),
    and the filter runs on them. ``conf``: the scan's settings."""
    cond = q16_part_condition()
    return _grouped_stage(
        _file_scan(paths, Q16_KEYS, cond if pushdown else None, num_slices,
                   device, conf=conf), cond,
        Q16_KEYS, q16_part_aggregates, shuffle_partitions,
        [desc(col("part_cnt"))] + [asc(col(k)) for k in Q16_KEYS])


def run_q16_part_parquet(paths, num_slices: int = 8,
                         shuffle_partitions: int = 8,
                         device: DeviceLike = None) -> pa.Table:
    """Q16's part stage over the part files ``paths``, collected."""
    return collect(q16_part_parquet_plan(paths, num_slices,
                                         shuffle_partitions, device))


def write_lineitem_bucketed(table: pa.Table, path: str, buckets: int = 16,
                            num_slices: int = 8, device: DeviceLike = None):
    """Write ``table`` under ``path`` as SNAPPY Parquet from a
    ``num_slices``-slice in-memory scan, one write task per slice, each row
    into the bucket file ``pmod(murmur3(l_shipdate, 42), buckets)`` of its
    task (``io.writer.write_plan``). Returns the job's ``WriteStats``."""
    from .io.writer import write_plan
    return write_plan(_scan(table, num_slices, device), path,
                      bucket_by=([BUCKET_KEY], buckets))


# ---------------------------------------------------------------------------
# The same paths as DataFrames, for the port's Session (``plan/``)
# ---------------------------------------------------------------------------

def session_conf(shuffle_partitions: int = 8, **settings) -> Dict:
    """The conf the Session runs these paths under, the one the port's
    tests give the JAX Session: ``incompatibleOps`` on (float64 sums), AQE
    off, ``shuffle_partitions`` shuffle partitions; ``settings`` (full
    ``spark.rapids.tpu.*`` keys) add to it or override it."""
    conf = {"spark.rapids.tpu.sql.incompatibleOps.enabled": True,
            "spark.rapids.tpu.sql.adaptive.enabled": False,
            "spark.rapids.tpu.shuffle.partitions": shuffle_partitions}
    conf.update(settings)
    return conf


def _df(table: pa.Table, num_slices: int,
        string_max_len: int = STRING_MAX_LEN):
    """A DataFrame scan of ``table`` in ``num_slices`` partitions of one
    batch each, as the JAX tests give ``table()``; strings
    ``string_max_len`` bytes wide (the JAX Session's 64 unless named)."""
    from .plan.logical import DataFrame, LogicalScan
    return DataFrame(LogicalScan(
        (), data=table,
        _schema=(None if string_max_len == STRING_MAX_LEN else
                 schema_from_arrow(table.schema, string_max_len)),
        num_slices=num_slices,
        batch_rows=max(1, -(-table.num_rows // num_slices))))


def q1_df(table: pa.Table, num_slices: int = 8):
    """TPC-H Q1 as a DataFrame (``q1_plan``'s query)."""
    return (_df(table, num_slices)
            .where(col("l_shipdate") <= lit(Q1_SHIPDATE_MAX))
            .group_by(*Q1_KEYS)
            .agg(*q1_aggregates())
            .order_by(*[asc(col(k)) for k in Q1_KEYS]))


def q16_part_df(table: pa.Table, num_slices: int = 8):
    """Q16's part stage as a DataFrame (``q16_part_plan``'s query)."""
    return (_df(table, num_slices)
            .where(q16_part_condition())
            .group_by(*Q16_KEYS)
            .agg(*q16_part_aggregates())
            .order_by(desc(col("part_cnt")),
                      *[asc(col(k)) for k in Q16_KEYS]))


def q16_df(part: pa.Table, supplier: pa.Table, partsupp: pa.Table,
           num_slices: int = 8):
    """TPC-H Q16 as a DataFrame: the part filter of ``q16_part_df``, the
    NOT IN subquery over a non-null key as a LEFT ANTI join with the
    suppliers whose comment is LIKE '%Customer%Complaints%', and
    count(DISTINCT ps_suppkey) as Spark rewrites it: a group-by on the
    keys and ps_suppkey, then a count per key. ``supplier`` scans at 128
    bytes a string."""
    complaints = (_df(supplier, num_slices, SUPPLIER_STRING_MAX_LEN)
                  .where(Like(col("s_comment"), Q16_COMMENT))
                  .select("s_suppkey"))
    return (_df(partsupp, num_slices)
            .join(_df(part, num_slices).where(q16_part_condition()),
                  ["ps_partkey"], ["p_partkey"])
            .join(complaints, ["ps_suppkey"], ["s_suppkey"],
                  JoinType.LEFT_ANTI)
            .group_by(*Q16_KEYS, "ps_suppkey").agg()
            .group_by(*Q16_KEYS).agg(Count().alias("supplier_cnt"))
            .order_by(desc(col("supplier_cnt")),
                      *[asc(col(k)) for k in Q16_KEYS]))


def q3_df(customer: pa.Table, orders: pa.Table, lineitem: pa.Table,
          num_slices: int = 8):
    """TPC-H Q3 as a DataFrame, tables in the FROM order (``q3_plan``'s
    query)."""
    day = Q3_DATE
    return (_df(customer, num_slices)
            .where(EqualTo(col("c_mktsegment"), lit(Q3_SEGMENT)))
            .join(_df(orders, num_slices)
                  .where(col("o_orderdate") < lit(day)),
                  ["c_custkey"], ["o_custkey"])
            .join(_df(lineitem, num_slices)
                  .where(col("l_shipdate") > lit(day)),
                  ["o_orderkey"], ["l_orderkey"])
            .group_by(*Q3_KEYS)
            .agg(*q3_aggregates())
            .order_by(desc(col("revenue")), asc(col("o_orderdate")))
            .limit(Q3_LIMIT)
            .select(*Q3_SELECT))


def q18_df(customer: pa.Table, orders: pa.Table, lineitem: pa.Table,
           num_slices: int = 8, quantity: float = Q18_QUANTITY):
    """TPC-H Q18 as a DataFrame, the IN subquery as a LEFT SEMI join
    (``q18_plan``'s query)."""
    big = (_df(lineitem, num_slices).group_by("l_orderkey")
           .agg(*q18_aggregates("sq"))
           .where(GreaterThan(col("sq"), lit(float(quantity)))))
    return (_df(customer, num_slices)
            .join(_df(orders, num_slices).join(
                big, ["o_orderkey"], ["l_orderkey"], JoinType.LEFT_SEMI),
                  ["c_custkey"], ["o_custkey"])
            .join(_df(lineitem, num_slices), ["o_orderkey"], ["l_orderkey"])
            .group_by(*Q18_KEYS)
            .agg(*q18_aggregates())
            .order_by(desc(col("o_totalprice")), asc(col("o_orderdate")))
            .limit(Q18_LIMIT))


def q18_decimal_df(customer: pa.Table, orders: pa.Table,
                   lineitem: pa.Table, num_slices: int = 8,
                   quantity: int = Q18_DECIMAL_QUANTITY):
    """``q18_df``'s query over ``tpch_q18_decimal_tables``: the HAVING
    literal is ``quantity`` as decimal(3, 0), compared with the
    decimal(25, 2) limb sum after a rescale."""
    import decimal
    big = (_df(lineitem, num_slices).group_by("l_orderkey")
           .agg(*q18_aggregates("sq"))
           .where(GreaterThan(col("sq"), lit(decimal.Decimal(quantity),
                                              T.decimal(3, 0)))))
    return (_df(customer, num_slices)
            .join(_df(orders, num_slices).join(
                big, ["o_orderkey"], ["l_orderkey"], JoinType.LEFT_SEMI),
                  ["c_custkey"], ["o_custkey"])
            .join(_df(lineitem, num_slices), ["o_orderkey"], ["l_orderkey"])
            .group_by(*Q18_KEYS)
            .agg(*q18_aggregates())
            .order_by(desc(col("o_totalprice")), asc(col("o_orderdate")))
            .limit(Q18_LIMIT))


def q2_df(part: pa.Table, supplier: pa.Table, partsupp: pa.Table,
          nation: pa.Table, region: pa.Table, num_slices: int = 8):
    """TPC-H Q2 as a DataFrame, the correlated subquery decorrelated
    (``q2_plan``'s query); ``supplier`` scans at 128 bytes a string."""
    ps = _prune(partsupp, Q2_COLUMNS["partsupp"])

    def eu_suppliers():
        regions = _df(region, num_slices).where(
            EqualTo(col("r_name"), lit(Q2_REGION)))
        nations = (_df(nation, num_slices)
                   .join(regions, ["n_regionkey"], ["r_regionkey"])
                   .select("n_nationkey", "n_name"))
        return _df(supplier, num_slices, SUPPLIER_STRING_MAX_LEN).join(
            nations, ["s_nationkey"], ["n_nationkey"])

    mins = (_df(ps, num_slices)
            .join(eu_suppliers().select("s_suppkey"), ["ps_suppkey"],
                  ["s_suppkey"])
            .group_by("ps_partkey")
            .agg(*q2_aggregates())
            .select(col("ps_partkey").alias("m_partkey"), col("min_cost")))
    parts = _df(part, num_slices).where(And(
        EqualTo(col("p_size"), lit(Q2_SIZE)),
        endswith(col("p_type"), Q2_TYPE_SUFFIX)))
    return (parts.join(_df(ps, num_slices), ["p_partkey"], ["ps_partkey"])
            .join(eu_suppliers(), ["ps_suppkey"], ["s_suppkey"])
            .join(mins, ["p_partkey", "ps_supplycost"],
                  ["m_partkey", "min_cost"])
            .order_by(desc(col("s_acctbal")), asc(col("n_name")),
                      asc(col("s_name")), asc(col("p_partkey")))
            .limit(Q2_LIMIT)
            .select(*Q2_SELECT))


def q11_df(partsupp: pa.Table, supplier: pa.Table, nation: pa.Table,
           fraction: float, num_slices: int = 8):
    """TPC-H Q11 as a DataFrame, the HAVING against the scalar subquery
    as a keyless join with the one-row global sum (``q11_plan``'s
    query)."""
    ps = _prune(partsupp, Q11_COLUMNS["partsupp"])
    s = _prune(supplier, Q11_COLUMNS["supplier"])
    n = _prune(nation, Q11_COLUMNS["nation"])

    def german_rows():
        nations = _df(n, num_slices).where(
            EqualTo(col("n_name"), lit(Q11_NATION)))
        suppliers = (_df(s, num_slices)
                     .join(nations, ["s_nationkey"], ["n_nationkey"])
                     .select("s_suppkey"))
        return _df(ps, num_slices).join(suppliers, ["ps_suppkey"],
                                        ["s_suppkey"])

    groups = german_rows().group_by("ps_partkey").agg(*q11_aggregates())
    total = german_rows().agg(*q11_aggregates("total"))
    cond = GreaterThan(col("value"), col("total") * lit(float(fraction)))
    return (groups.join(total, [], [], JoinType.INNER, condition=cond)
            .select("ps_partkey", "value")
            .order_by(desc(col("value"))))


def q1_stage_df(table: pa.Table):
    """The fused Q1 stage's query (``__graft_entry__._q1_stage``) as a
    DataFrame over ``table`` in one slice (``q1_stage_plan``'s tree)."""
    return (_df(table, 1)
            .where(col("l_shipdate") <= lit(Q1_SHIPDATE_MAX))
            .group_by(*Q1_KEYS)
            .agg(*q1_stage_aggregates()))


def hash_agg_df(table: pa.Table, num_slices: int = 8):
    """``bench.bench_hash_agg``'s aggregate as a DataFrame over
    ``num_slices`` slices (``hash_agg_plan(two_stage=True)``'s tree)."""
    return (_df(table, num_slices).group_by(*HASH_AGG_KEYS)
            .agg(*hash_agg_aggregates()))


def join_sort_df(stream: pa.Table, build: pa.Table):
    """``bench.bench_join_sort``'s join and sort as a DataFrame, each input
    one batch (``join_sort_plan``'s tree, which the Session fuses)."""
    return (_df(stream, 1)
            .join(_df(build, 1), ["l_orderkey"], ["o_orderkey"])
            .order_by(desc(col("l_revenue"))))


def parquet_scan_df(paths, num_slices: int = 1, reader_type=None):
    """``bench.bench_parquet_scan``'s scan as a DataFrame over
    ``read_parquet`` (``parquet_scan_plan``'s tree), MULTITHREADED unless
    ``reader_type`` says otherwise."""
    from .io.scan import read_parquet
    from .io.source import ReaderType
    return read_parquet(paths, columns=list(PARQUET_SCAN_COLUMNS),
                        predicate=col("l_shipdate") <= lit(Q1_SHIPDATE_MAX),
                        num_slices=num_slices,
                        reader_type=reader_type or ReaderType.MULTITHREADED)


# ---------------------------------------------------------------------------
# The mesh: shuffle.mode=ICI
# ---------------------------------------------------------------------------

def ici_conf(n_shards: int = 8, **settings) -> Dict:
    """The ICI shuffle over ``n_shards`` mesh shards on the JAX Session's
    defaults; ``settings`` (full ``spark.rapids.tpu.*`` keys) add to it.
    On another base conf: ``session_conf(p, **ici_conf(n))``."""
    return {"spark.rapids.tpu.shuffle.mode": "ICI",
            "spark.rapids.tpu.mesh.devices": n_shards, **settings}


#: rows of the ici_exchange shape's dimension table
ICI_DIM_ROWS = 1 << 12


def ici_exchange_tables(n: int = 1 << 20, seed: int = 11
                        ) -> Tuple[pa.Table, pa.Table]:
    """``bench.bench_ici_exchange``'s fact and dim tables, the same draws:
    fact (k in [0, 4096), g in [0, 64), v in [-1000, 1000)), dim (dk =
    0..4095, w in [0, 10))."""
    rng = np.random.default_rng(seed)
    fact = pa.table({
        "k": rng.integers(0, ICI_DIM_ROWS, n).astype(np.int32),
        "g": rng.integers(0, 64, n).astype(np.int32),
        "v": rng.integers(-1000, 1000, n).astype(np.int64),
    })
    dim = pa.table({
        "dk": np.arange(ICI_DIM_ROWS, dtype=np.int32),
        "w": rng.integers(0, 10, ICI_DIM_ROWS).astype(np.int64),
    })
    return fact, dim


def _join_group(fact_df, dim_df):
    return (fact_df.join(dim_df, ["k"], ["dk"], JoinType.INNER)
            .group_by("g")
            .agg(Sum(col("v")).alias("sv"), Sum(col("w")).alias("sw"),
                 Count().alias("c")))


def ici_exchange_df(fact: pa.Table, dim: pa.Table):
    """The bench's ici_exchange query: fact join dim on k = dk, grouped by
    g with sum(v), sum(w) and count(*); under the JAX default conf the
    4096-row dim is a planned broadcast build."""
    from .plan import table
    return _join_group(table(fact), table(dim))


def _join_group_reference(fact: pa.Table, dim: pa.Table) -> pa.Table:
    j = fact.join(dim, keys="k", right_keys="dk", join_type="inner")
    g = j.group_by(["g"]).aggregate([("v", "sum"), ("w", "sum"),
                                     ("g", "count")])
    return pa.table([g.column("g"), g.column("v_sum"), g.column("w_sum"),
                     g.column("g_count")], names=["g", "sv", "sw", "c"])


def ici_exchange_reference(fact: pa.Table, dim: pa.Table) -> pa.Table:
    """The ici_exchange query in pyarrow (groups sorted by g)."""
    return _join_group_reference(fact, dim).sort_by("g")


def mesh_chain_tables(n_fact: int = 512, n_dim: int = 40, n_groups: int = 6,
                      seed: int = 7) -> Tuple[pa.Table, pa.Table]:
    """``__graft_entry__.dryrun_multichip``'s draws at any size: fact (k in
    [0, n_dim), g in [0, n_groups), v in [-1000, 1000), ship in
    [8000, 11000)), dim (dk = 0..n_dim - 1, w in [0, 10)); the defaults
    are the dryrun's own."""
    rng = np.random.default_rng(seed)
    fact = pa.table({
        "k": pa.array(rng.integers(0, n_dim, n_fact).astype(np.int32)),
        "g": pa.array(rng.integers(0, n_groups, n_fact).astype(np.int32)),
        "v": pa.array(rng.integers(-1000, 1000, n_fact).astype(np.int64)),
        "ship": pa.array(rng.integers(8000, 11000, n_fact)
                         .astype(np.int32)),
    })
    dim = pa.table({
        "dk": pa.array(np.arange(n_dim, dtype=np.int32)),
        "w": pa.array(rng.integers(0, 10, n_dim).astype(np.int64)),
    })
    return fact, dim


def mesh_chain_df(fact: pa.Table, dim: pa.Table):
    """The q72 shape of the dryrun: ship <= 10471, fact join dim on k =
    dk, grouped by g with sum(v), sum(w) and count(*), ordered by sum(v)
    descending."""
    from .plan import table
    return _join_group(table(fact).where(col("ship") <= lit(Q1_SHIPDATE_MAX)),
                       table(dim)).order_by(desc(col("sv")))


def mesh_chain_reference(fact: pa.Table, dim: pa.Table) -> pa.Table:
    """The chain in pyarrow, ordered by sum(v) descending (ties by g)."""
    f = fact.filter(pc.less_equal(fact.column("ship"), Q1_SHIPDATE_MAX))
    return _join_group_reference(f, dim).sort_by([("sv", "descending"),
                                                  ("g", "ascending")])


def mesh_chain_conf(n_shards: int) -> Dict:
    """The chain's conf: ICI over ``n_shards`` shards, every join shuffled
    (``autoBroadcastJoinThreshold`` 0) and AQE off, so the planned
    shuffled join reaches the lowering as planned."""
    return ici_conf(n_shards, **{
        "spark.rapids.tpu.sql.autoBroadcastJoinThreshold": 0,
        "spark.rapids.tpu.sql.adaptive.enabled": False})


def dryrun_multigpu(n: int, device: DeviceLike = None) -> Dict:
    """``__graft_entry__.dryrun_multichip`` on the port: the Session
    (``shuffle.mode=ICI`` over ``n`` shards) plans the filter, shuffled
    join, group-by and global sort over the dryrun's tables and lowers
    them onto one ``MeshStageExec`` (both join sides hash-exchanged, the
    join, partial aggregation, key routing, final merge, the splitter
    range exchange and local sort), whose rows must equal the port's row
    interpreter's. Returns the stage's lowered list and the groups.

    The conf adds ``sql.adaptive.enabled=false`` to the JAX dryrun's:
    under AQE the aggregate's planning reads the shuffled join's
    partitions, whose runtime broadcast switch turns the 40-row build into
    a broadcast before lowering, and the lowering refuses a broadcast join
    without a broadcast exchange child, so the JAX dryrun itself never
    lowers (ROADMAP Queue 3)."""
    from .plan import Session
    fact, dim = mesh_chain_tables()
    ses = Session(mesh_chain_conf(n), device=device)
    got = ses.collect(mesh_chain_df(fact, dim))
    names = ses.executed_exec_names()
    if names != ["MeshStageExec"]:
        raise AssertionError(f"the planned query did not lower onto the "
                             f"mesh: {names}")
    lowered = ses.last_plan.lowered
    n_exchanges = lowered.count("mesh_exchange(all_to_all)")
    if n_exchanges < 3:
        raise AssertionError(f"{n_exchanges} mesh exchanges: {lowered}")
    oracle = Session({"spark.rapids.tpu.sql.enabled": False},
                     device=device or "cpu")
    want = oracle.collect(mesh_chain_df(fact, dim))
    if sorted(got.to_pylist(), key=str) != sorted(want.to_pylist(),
                                                   key=str):
        raise AssertionError(f"the mesh's {got.num_rows} groups differ "
                             f"from the interpreter's {want.num_rows}")
    return {"lowered": lowered, "exchanges": n_exchanges,
            "groups": got.num_rows, "shards": n}


# ---------------------------------------------------------------------------
# Order baskets and P_NAME words: arrays, structs, collect_set, split and
# explode over Q9's tables
# ---------------------------------------------------------------------------

#: a basket's element budget: dbgen draws 1 to 7 lines an order (spec
#: 4.2.3), so 8 holds every order's distinct parts
BASKET_MAX_ITEMS = 8
#: the baskets the first leg keeps, and how many of them it returns
BASKET_MIN_ITEMS = 4
BASKET_TOP = 10_000
#: the support leg's top items
SUPPORT_TOP = 100
#: P_NAME's budget of words (it has five)
WORDS_MAX_ELEMS = 8
BASKET_SELECT = ("o_orderkey", "info", "items", "n_items", "has_probe",
                 "min_item", "max_item", "top_item", "top_supp")
SUPPORT_SELECT = ("item", "support")
WORDS_SELECT = ("word", "n", "n_words", "n_first")


def basket_probe(lineitem: pa.Table) -> int:
    """The part key ``array_contains`` probes: lineitem's first one."""
    return int(lineitem.column("l_partkey")[0].as_py())


def _baskets_df(lineitem: pa.Table, num_slices: int):
    """One basket per order, the input Spark MLlib's FPGrowth takes::

        SELECT l_orderkey, collect_set(l_partkey) AS items,
               count(*) AS n_lines, max(l_suppkey) AS top_supp
        FROM lineitem GROUP BY l_orderkey

    ``items`` in value order, at most ``BASKET_MAX_ITEMS`` a basket."""
    from .expressions.aggregates import CollectSet, Max
    return (_df(lineitem.select(["l_orderkey", "l_partkey", "l_suppkey"]),
                num_slices)
            .group_by("l_orderkey")
            .agg(CollectSet(col("l_partkey"),
                            max_elems=BASKET_MAX_ITEMS).alias("items"),
                 Count().alias("n_lines"),
                 Max(col("l_suppkey")).alias("top_supp")))


def baskets_df(lineitem: pa.Table, orders: pa.Table, probe: int,
               num_slices: int = 8):
    """The baskets leg::

        SELECT o_orderkey, named_struct('o_orderdate', o_orderdate,
                                        'n_lines', n_lines) AS info,
               items, size(items) AS n_items,
               array_contains(items, probe) AS has_probe,
               array_min(items) AS min_item, array_max(items) AS max_item,
               element_at(sort_array(items, false), 1) AS top_item,
               top_supp
        FROM orders JOIN baskets ON o_orderkey = l_orderkey
        WHERE size(items) >= 4
        ORDER BY info.o_orderdate, o_orderkey LIMIT 10000

    The arrays ride the join as payload and the struct the sort."""
    from .expressions.collections import (ArrayContains, ArrayMax,
                                          ArrayMin, CreateStruct, ElementAt,
                                          GetStructField, Size, SortArray)
    items = col("items")
    return (_df(orders.select(["o_orderkey", "o_orderdate"]), num_slices)
            .join(_baskets_df(lineitem, num_slices), ["o_orderkey"],
                  ["l_orderkey"])
            .select(col("o_orderkey"),
                    CreateStruct((col("o_orderdate"), col("n_lines")),
                                 ("o_orderdate", "n_lines")).alias("info"),
                    items,
                    Size(items).alias("n_items"),
                    ArrayContains(items, lit(probe, T.INT64))
                    .alias("has_probe"),
                    ArrayMin(items).alias("min_item"),
                    ArrayMax(items).alias("max_item"),
                    ElementAt(SortArray(items, False), lit(1))
                    .alias("top_item"),
                    col("top_supp"))
            .where(Size(items) >= lit(BASKET_MIN_ITEMS))
            .order_by(asc(GetStructField(col("info"), 0)),
                      asc(col("o_orderkey")))
            .limit(BASKET_TOP))


def support_df(lineitem: pa.Table, num_slices: int = 8):
    """The support leg: each part's count of baskets::

        SELECT item, count(*) AS support
        FROM baskets LATERAL VIEW explode(items) AS item
        GROUP BY item ORDER BY support DESC, item LIMIT 100"""
    return (_baskets_df(lineitem, num_slices)
            .explode("items", alias="item")
            .group_by("item")
            .agg(Count().alias("support"))
            .order_by(desc(col("support")), asc(col("item")))
            .limit(SUPPORT_TOP))


def exploded_rows_df(lineitem: pa.Table, num_slices: int = 8):
    """``count(*)`` of the exploded baskets: the number of distinct
    (order, part) pairs."""
    return (_baskets_df(lineitem, num_slices)
            .explode("items", alias="item")
            .agg(Count().alias("n")))


def words_df(part: pa.Table, num_slices: int = 8):
    """The P_NAME words leg::

        SELECT word, count(*) AS n, sum(n_words) AS n_words,
               sum(if(first_word = word, 1, 0)) AS n_first
        FROM (SELECT words, size(words) AS n_words,
                     element_at(words, 1) AS first_word
              FROM (SELECT split(p_name, ' ') AS words FROM part))
        LATERAL VIEW explode(words) AS word
        GROUP BY word ORDER BY word

    ``split`` gives ``array<string>`` in the 3D byte layout, at most
    ``WORDS_MAX_ELEMS`` words a name; the explode carries it along."""
    from .expressions import If
    from .expressions.collections import ElementAt, Size
    from .expressions.regex import StringSplit

    words = col("words")
    one, zero = lit(1, T.INT64), lit(0, T.INT64)
    return (_df(part.select(["p_name"]), num_slices)
            .select(StringSplit(col("p_name"), " ",
                                max_elems=WORDS_MAX_ELEMS).alias("words"))
            .select(words, Size(words).alias("n_words"),
                    ElementAt(words, lit(1)).alias("first_word"))
            .explode("words", alias="word")
            .select("word", "n_words", "first_word")
            .group_by("word")
            .agg(Count().alias("n"), Sum(col("n_words")).alias("n_words"),
                 Sum(If(EqualTo(col("first_word"), col("word")), one, zero))
                 .alias("n_first"))
            .order_by(asc(col("word"))))


def _segments(starts: np.ndarray, counts: np.ndarray) -> np.ndarray:
    """The flat indices of consecutive runs ``[starts[i], starts[i] +
    counts[i])``, run after run."""
    total = int(counts.sum())
    ends = np.cumsum(counts)
    run_of = np.repeat(np.arange(counts.size), counts)
    return starts[run_of] + np.arange(total) - (ends - counts)[run_of]


def basket_pairs(lineitem: pa.Table):
    """(the distinct (order, part) pairs as sorted order keys and part
    keys, each order's key, first pair and pair count): numpy sorts of one
    packed int64 key, no loop over rows. Both references take it, so a
    caller that checks both legs sorts once."""
    ok = lineitem.column("l_orderkey").to_numpy()
    pk = lineitem.column("l_partkey").to_numpy()
    bits = max(int(pk.max()).bit_length(), 1)
    packed = np.sort((ok << bits) | pk)
    packed = packed[np.concatenate([[True], packed[1:] != packed[:-1]])]
    okd, pkd = packed >> bits, packed & ((1 << bits) - 1)
    # okd is sorted: each order's run starts where the key changes
    starts = np.flatnonzero(np.concatenate([[True], okd[1:] != okd[:-1]]))
    counts = np.diff(np.append(starts, okd.size))
    return okd, pkd, okd[starts], starts, counts


def baskets_reference(lineitem: pa.Table, orders: pa.Table, probe: int,
                      pairs=None) -> pa.Table:
    """The baskets leg by numpy and pyarrow alone: distinct pairs from
    one sort, per-order counts and max supplier from another, each
    basket's reductions from its sorted run, the top rows by
    ``np.lexsort``; in ``baskets_df``'s types and order."""
    _, pkd, keys, starts, counts = pairs or basket_pairs(lineitem)
    # every line's (order, supplier) in one sorted key: an order's lines
    # are a run, its largest supplier the run's last
    ok = lineitem.column("l_orderkey").to_numpy()
    sk = lineitem.column("l_suppkey").to_numpy()
    bits = max(int(sk.max()).bit_length(), 1)
    lines = np.sort((ok << bits) | sk)
    line_keys = lines >> bits
    ends = np.flatnonzero(np.append(line_keys[1:] != line_keys[:-1], True))
    n_lines = np.diff(np.append(-1, ends))          # orders in keys' order
    top_supp = lines[ends] & ((1 << bits) - 1)
    has = np.add.reduceat((pkd == probe).astype(np.int64), starts) > 0
    o_keys = orders.column("o_orderkey").to_numpy()
    o_days = orders.column("o_orderdate").cast(pa.int32()).to_numpy()
    in_orders = np.searchsorted(keys, o_keys)
    in_orders = np.clip(in_orders, 0, keys.size - 1)
    joined = keys[in_orders] == o_keys
    g = in_orders[joined]                       # the order's basket
    ok_rows, days = o_keys[joined], o_days[joined]
    keep = counts[g] >= BASKET_MIN_ITEMS
    g, ok_rows, days = g[keep], ok_rows[keep], days[keep]
    top = np.lexsort((ok_rows, days))[:BASKET_TOP]
    g, ok_rows, days = g[top], ok_rows[top], days[top]
    c = counts[g].astype(np.int32)
    offsets = np.zeros(c.size + 1, np.int32)
    np.cumsum(c, out=offsets[1:])
    items = pa.ListArray.from_arrays(
        pa.array(offsets), pa.array(pkd[_segments(starts[g], c)]))
    first, last = pkd[starts[g]], pkd[starts[g] + c - 1]
    info = pa.StructArray.from_arrays(
        [pa.array(days.astype(np.int32)).cast(pa.date32()),
         pa.array(n_lines[g])], names=["o_orderdate", "n_lines"])
    return pa.table([pa.array(ok_rows), info, items, pa.array(c),
                     pa.array(has[g]), pa.array(first), pa.array(last),
                     pa.array(last), pa.array(top_supp[g])],
                    names=list(BASKET_SELECT))


def support_reference(lineitem: pa.Table,
                      pairs=None) -> Tuple[pa.Table, int]:
    """(the support leg's table, the count of distinct (order, part)
    pairs) by numpy alone."""
    _, pkd, _, _, _ = pairs or basket_pairs(lineitem)
    per_item = np.bincount(pkd)
    item = np.flatnonzero(per_item)
    support = per_item[item]
    top = np.lexsort((item, -support))[:SUPPORT_TOP]
    return (pa.table([pa.array(item[top]), pa.array(support[top])],
                     names=list(SUPPORT_SELECT)), int(pkd.size))


def words_reference(part: pa.Table) -> pa.Table:
    """The words leg by pyarrow alone: ``pc.split_pattern``, then
    ``list_flatten`` and ``value_counts`` for ``n``, each word's name's
    word count summed by a group-by, ``value_counts`` of the first words;
    sorted by word."""
    names = part.column("p_name").combine_chunks()
    split = pc.split_pattern(names, " ")
    flat = pc.list_flatten(split)
    sizes = pc.list_value_length(split).cast(pa.int64())
    per = pa.table({"word": flat,
                    "n_words": sizes.take(pc.list_parent_indices(split))})
    g = per.group_by("word").aggregate([("word", "count"),
                                        ("n_words", "sum")])
    first = pc.value_counts(pc.list_element(split, 0))
    first_n = dict(zip(first.field("values").to_pylist(),
                       first.field("counts").to_pylist()))
    g = g.sort_by([("word", "ascending")])
    words = g.column("word")
    return pa.table([words, g.column("word_count"),
                     g.column("n_words_sum"),
                     pa.array([first_n.get(w, 0) for w in words.to_pylist()],
                              pa.int64())],
                    names=list(WORDS_SELECT))


# ---------------------------------------------------------------------------
# Order lines as arrays (the lambdas, the set operations and the shaping
# of collections.py) and TPC-H Q1 over JSON Lines (json.py)
# ---------------------------------------------------------------------------

#: lines an order holds at most (dbgen draws 1 to 7): every list's budget
ORDER_LINES_MAX = 8
#: the orders the order-lines leg keeps (Q18's HAVING shape: about 0.5%
#: of them), and how many it returns, by quantity
ORDER_LINES_MIN_QTY = 250
ORDER_LINES_TOP = 10_000
#: a line at this discount or more puts its part among the deep items
DEEP_DISCOUNT = 0.05
#: each packed line's fields as (lowest bit, width): the line number, the
#: quantity, the discount in points, the price in cents, the supplier
LINE_FIELDS = {"lno": (58, 3), "qty": (52, 6), "pct": (48, 4),
               "cents": (24, 24), "supp": (0, 24)}
ORDER_LINES_SELECT = (
    "o_orderkey", "o_orderdate", "qty", "revenue", "n_supp", "all_items",
    "common", "shallow", "overlap", "big_qtys", "deep_disc", "all_small",
    "scaled", "top3", "probe_at", "no_probe", "doubled", "big_lines",
    "shifted", "seq", "flat")


def order_lines_tables(lineitem: pa.Table, orders: pa.Table):
    """(lineitem with ``l_linenumber``, orders), both with non-nullable
    columns. ``l_linenumber`` is each line's 1-based place in its order,
    made on the host from the draw, whose lines of an order are
    consecutive; no other column changes."""
    ok = lineitem.column("l_orderkey").to_numpy()
    if ok.size and not np.all(ok[1:] >= ok[:-1]):
        raise ValueError("an order's lines must be consecutive")
    start = np.flatnonzero(np.concatenate([[True], ok[1:] != ok[:-1]]))
    run = np.repeat(np.arange(start.size),
                    np.diff(np.append(start, ok.size)))
    lno = (np.arange(ok.size) - start[run] + 1).astype(np.int32)
    lineitem = lineitem.append_column("l_linenumber", pa.array(lno))

    def required(t):
        return t.cast(pa.schema([pa.field(f.name, f.type, nullable=False)
                                 for f in t.schema]))
    return required(lineitem), required(orders)


def _packed_line() -> Expression:
    """A line's fields in one bigint, the line number on top, so that an
    order's values sorted (as collect_list gives them in both packages)
    are its lines in order."""
    from .expressions import BitwiseOp, Cast, Round, Shift
    fields = {
        "lno": Cast(col("l_linenumber"), T.INT64),
        "qty": Cast(col("l_quantity"), T.INT64),
        "pct": Cast(Round(col("l_discount") * lit(100.0)), T.INT64),
        "cents": Cast(Round(col("l_extendedprice") * lit(100.0)), T.INT64),
        "supp": col("l_suppkey")}
    out = None
    for name, e in fields.items():
        low = LINE_FIELDS[name][0]
        e = Shift(e, lit(low), "left") if low else e
        out = e if out is None else BitwiseOp(out, e, "or")
    return out


def _order_lines(lineitem: pa.Table, num_slices: int):
    """``SELECT l_orderkey, collect_list(packed line) AS packed,
    count(*) AS n_lines FROM lineitem GROUP BY l_orderkey``."""
    from .expressions.aggregates import CollectList
    return (_df(lineitem, num_slices)
            .select(col("l_orderkey"), _packed_line().alias("line"))
            .group_by("l_orderkey")
            .agg(CollectList(col("line"), max_elems=ORDER_LINES_MAX)
                 .alias("packed"), Count().alias("n_lines")))


def _order_items(lineitem: pa.Table, num_slices: int, key: str, name: str,
                 deep: bool = False):
    """An order's distinct parts (with ``deep``, of its lines discounted
    by ``DEEP_DISCOUNT`` or more), keyed by ``key``."""
    from .expressions.aggregates import CollectSet
    df = _df(lineitem.select(["l_orderkey", "l_partkey", "l_discount"]),
             num_slices)
    if deep:
        df = df.where(col("l_discount") >= lit(DEEP_DISCOUNT))
    return (df.select(col("l_orderkey").alias(key), col("l_partkey"))
            .group_by(key)
            .agg(CollectSet(col("l_partkey"), max_elems=ORDER_LINES_MAX)
                 .alias(name)))


def order_lines_df(lineitem: pa.Table, orders: pa.Table, probe: int,
                   num_slices: int = 8):
    """Order lines kept as arrays and worked on with higher-order
    functions, over ``order_lines_tables``::

        lines = SELECT l_orderkey, collect_list(line) packed, count(*) n_lines
                FROM lineitem GROUP BY l_orderkey
        items = SELECT l_orderkey, collect_set(l_partkey) items ...
        deep  = ... WHERE l_discount >= 0.05 ... collect_set(...) deep_items
        SELECT o_orderkey, o_orderdate,
               aggregate(qtys, 0L, (acc, q) -> acc + q) qty,
               aggregate(zip_with(cents, pcts, (p, d) -> p * (100 - d)),
                         0L, (a, r) -> a + r) revenue,
               size(array_distinct(supps)) n_supp,
               array_union(deep_items, items), array_intersect(items,
               deep_items), array_except(items, deep_items),
               arrays_overlap(items, deep_items), filter(qtys, q -> q > 25),
               exists(pcts, d -> d >= 9), forall(qtys, q -> q <= 50),
               transform(cents, p -> p * n_lines),          -- outer column
               slice(sort_array(cents, false), 1, 3),
               array_position(items, probe), array_remove(items, probe),
               transform_values(map_from_arrays(lnos, qtys), (k, v) -> v * 2),
               map_filter(map_from_arrays(lnos, qtys), (k, v) -> v > 25),
               transform_keys(map_from_arrays(lnos, qtys), (k, v) -> k + 100),
               sequence(1, n_lines), flatten(array(items, deep_items))
        FROM orders JOIN lines JOIN items JOIN deep (on the order key)
        WHERE qty > 250 ORDER BY qty DESC, o_orderkey LIMIT 10000

    ``lnos``, ``qtys``, ``pcts`` (the discount in points), ``cents`` (the
    price) and ``supps`` are ``transform``s of ``packed``, which holds each
    line's fields in one bigint (``LINE_FIELDS``): collect_list gives an
    order's values sorted in both packages, and a line number on top
    sorts them by line, so the lists line up element by element. Money
    is in integers, so every column is exact. ``/`` may give null (a zero
    divisor), which a lambda body may not, as in the JAX tagging: hence
    ``p * n_lines``. Each collect has its aggregate: one exec holds one
    value-sorted layout."""
    from .expressions import BitwiseOp, Shift
    from .expressions import collections as C

    def i64(v):
        return lit(v, T.INT64)

    def unpacked(name):
        low, width = LINE_FIELDS[name]
        x = C.hof_var(T.INT64)
        v = Shift(x, lit(low), "right") if low else x
        return C.TransformArray(col("packed"), x, BitwiseOp(
            v, i64((1 << width) - 1), "and")).alias(
            "cents" if name == "cents" else name + "s")

    def var(name="x"):
        return C.hof_var(T.INT64, name)

    items, deep = col("items"), col("deep_items")
    qtys, pcts, cents = col("qtys"), col("pcts"), col("cents")

    def qty_map():
        return C.MapFromArrays(col("lnos"), qtys)

    acc, q, a, r, p, d = (var(n) for n in ("acc", "q", "a", "r", "p", "d"))
    fq, eq_, aq, sp = var("q"), var("d"), var("q"), var("p")
    k1, v1, k2, v2, k3, v3 = (var(n) for n in ("k", "v") * 3)
    return (_df(orders.select(["o_orderkey", "o_orderdate"]), num_slices)
            .join(_order_lines(lineitem, num_slices), ["o_orderkey"],
                  ["l_orderkey"])
            .join(_order_items(lineitem, num_slices, "i_orderkey", "items"),
                  ["o_orderkey"], ["i_orderkey"])
            .join(_order_items(lineitem, num_slices, "d_orderkey",
                               "deep_items", deep=True),
                  ["o_orderkey"], ["d_orderkey"])
            .select(col("o_orderkey"), col("o_orderdate"), col("n_lines"),
                    items, deep, *[unpacked(n) for n in LINE_FIELDS])
            .select(
                col("o_orderkey"), col("o_orderdate"),
                C.AggregateArray(qtys, i64(0), acc, q, acc + q).alias("qty"),
                C.AggregateArray(
                    C.ZipWith(cents, pcts, p, d, p * (i64(100) - d)),
                    i64(0), a, r, a + r).alias("revenue"),
                C.Size(C.ArrayDistinct(col("supps"))).alias("n_supp"),
                C.ArrayUnion(deep, items).alias("all_items"),
                C.ArrayIntersect(items, deep).alias("common"),
                C.ArrayExcept(items, deep).alias("shallow"),
                C.ArraysOverlap(items, deep).alias("overlap"),
                C.FilterArray(qtys, fq, fq > i64(25)).alias("big_qtys"),
                C.ExistsArray(pcts, eq_, eq_ >= i64(9)).alias("deep_disc"),
                C.ForallArray(qtys, aq, aq <= i64(50)).alias("all_small"),
                C.TransformArray(cents, sp, sp * col("n_lines"))
                .alias("scaled"),
                C.ArraySlice(C.SortArray(cents, False), lit(1), lit(3))
                .alias("top3"),
                C.ArrayPosition(items, i64(probe)).alias("probe_at"),
                C.ArrayRemove(items, i64(probe)).alias("no_probe"),
                C.TransformValues(qty_map(), k1, v1, v1 * i64(2))
                .alias("doubled"),
                C.MapFilter(qty_map(), k2, v2, v2 > i64(25))
                .alias("big_lines"),
                C.TransformKeys(qty_map(), k3, v3, k3 + i64(100))
                .alias("shifted"),
                C.Sequence(i64(1), col("n_lines"),
                           max_elems=ORDER_LINES_MAX).alias("seq"),
                C.Flatten(C.CreateArray((items, deep))).alias("flat"))
            .where(col("qty") > i64(ORDER_LINES_MIN_QTY))
            .order_by(desc(col("qty")), asc(col("o_orderkey")))
            .limit(ORDER_LINES_TOP))


def order_line_copies_df(lineitem: pa.Table, num_slices: int = 8):
    """``SELECT count(*) FROM lines LATERAL VIEW
    explode(replicaterows(n_lines))``: one row per line, under
    ``spark.rapids.tpu.sql.generate.maxRepeat`` = ``ORDER_LINES_MAX``
    (``order_lines_conf``); at the default 64 the explode's output would
    hold cap x 64 slots."""
    from .expressions.collections import ReplicateRows
    return (_order_lines(lineitem, num_slices)
            .explode(ReplicateRows(col("n_lines")), alias="copy")
            .agg(Count().alias("n")))


def order_lines_conf(shuffle_partitions: int = 8) -> Dict:
    return session_conf(shuffle_partitions, **{
        "spark.rapids.tpu.sql.generate.maxRepeat": ORDER_LINES_MAX})


def _runs(keys: np.ndarray):
    """(run starts, run lengths) of the equal consecutive ``keys``."""
    start = np.flatnonzero(np.concatenate([[True], keys[1:] != keys[:-1]]))
    return start, np.diff(np.append(start, keys.size))


def order_lines_reference(lineitem: pa.Table, orders: pa.Table,
                          probe: int) -> pa.Table:
    """``order_lines_df`` by numpy and pyarrow alone: an order's lines are
    a run of the draw, so its quantity and whether it has a deep line are
    ``reduceat``s, the joins ``np.searchsorted`` and the top rows
    ``np.lexsort``; then each kept order's lists from its run. In
    ``order_lines_df``'s types and order."""
    ok = lineitem.column("l_orderkey").to_numpy()
    qty = lineitem.column("l_quantity").to_numpy().astype(np.int64)
    pct = np.round(lineitem.column("l_discount").to_numpy() * 100.0
                   ).astype(np.int64)
    deep_pct = int(round(DEEP_DISCOUNT * 100))
    lstart, n_lines = _runs(ok)
    lkeys = ok[lstart]
    qty_sum = np.add.reduceat(qty, lstart)
    has_deep = np.maximum.reduceat((pct >= deep_pct).astype(np.int8),
                                   lstart) > 0
    o_keys = orders.column("o_orderkey").to_numpy()
    o_days = orders.column("o_orderdate").cast(pa.int32()).to_numpy()
    li = np.clip(np.searchsorted(lkeys, o_keys), 0, lkeys.size - 1)
    keep = (lkeys[li] == o_keys) & has_deep[li] & \
        (qty_sum[li] > ORDER_LINES_MIN_QTY)
    rows = np.flatnonzero(keep)
    top = rows[np.lexsort((o_keys[rows], -qty_sum[li[rows]]))][
        :ORDER_LINES_TOP]
    cents = np.round(lineitem.column("l_extendedprice").to_numpy() * 100.0
                     ).astype(np.int64)
    supp = lineitem.column("l_suppkey").to_numpy()
    pk = lineitem.column("l_partkey").to_numpy()
    out = {name: [] for name in ORDER_LINES_SELECT}
    for r in top:
        g = li[r]
        s0, n = int(lstart[g]), int(n_lines[g])
        q_, p_, c_, sp_, pk_ = (x[s0:s0 + n].tolist()
                                for x in (qty, pct, cents, supp, pk))
        its = sorted(set(pk_))
        dps = sorted({k for k, d in zip(pk_, p_) if d >= deep_pct})
        lnos = list(range(1, n + 1))
        both = set(dps)
        out["o_orderkey"].append(int(o_keys[r]))
        out["o_orderdate"].append(int(o_days[r]))
        out["qty"].append(sum(q_))
        out["revenue"].append(sum(c * (100 - d) for c, d in zip(c_, p_)))
        out["n_supp"].append(len(set(sp_)))
        out["all_items"].append(dps + [x for x in its if x not in both])
        out["common"].append([x for x in its if x in both])
        out["shallow"].append([x for x in its if x not in both])
        out["overlap"].append(any(x in both for x in its))
        out["big_qtys"].append([x for x in q_ if x > 25])
        out["deep_disc"].append(any(x >= 9 for x in p_))
        out["all_small"].append(all(x <= 50 for x in q_))
        out["scaled"].append([x * n for x in c_])
        out["top3"].append(sorted(c_, reverse=True)[:3])
        out["probe_at"].append(its.index(probe) + 1 if probe in its else 0)
        out["no_probe"].append([x for x in its if x != probe])
        out["doubled"].append([(k, v * 2) for k, v in zip(lnos, q_)])
        out["big_lines"].append([(k, v) for k, v in zip(lnos, q_)
                                 if v > 25])
        out["shifted"].append([(k + 100, v) for k, v in zip(lnos, q_)])
        out["seq"].append(lnos)
        out["flat"].append(its + dps)
    i64 = pa.int64()
    lst, mp = pa.list_(i64), pa.map_(i64, i64)
    types = {"o_orderkey": i64, "o_orderdate": pa.int32(), "qty": i64,
             "revenue": i64, "n_supp": pa.int32(), "overlap": pa.bool_(),
             "deep_disc": pa.bool_(), "all_small": pa.bool_(),
             "probe_at": i64, "doubled": mp, "big_lines": mp, "shifted": mp}
    cols = [pa.array(out[n], types.get(n, lst)) for n in ORDER_LINES_SELECT]
    cols[1] = cols[1].cast(pa.date32())
    return pa.table(cols, names=list(ORDER_LINES_SELECT))


#: the JSON Lines leg: the documents' width, the field names of Q1's
#: seven columns in the documents, and the letters of the two flags
JSON_MAX_LEN = 256
Q1_JSON_FIELDS = ("l_returnflag", "l_linestatus", "l_quantity",
                  "l_extendedprice", "l_discount", "l_shipdate", "l_tax")
RETURN_FLAGS = ("A", "N", "R")
LINE_STATUSES = ("F", "O")


def lineitem_json(table: pa.Table) -> pa.Table:
    """``table`` (``lineitem_table``'s columns) as one JSON document a
    row, a ``value`` column as ``spark.read.text`` of a JSON Lines file
    or a Kafka value gives it: the flags as their letters, numbers in
    their shortest round-trip form (Arrow's cast), the ship date ISO;
    about 200 bytes a document, made by pyarrow compute."""
    def letters(name, alphabet):
        return pa.array(alphabet).take(table.column(name))

    def text(name, to=None):
        c = table.column(name)
        return pc.cast(c.cast(to) if to else c, pa.string())

    values = {"l_returnflag": letters("l_returnflag", RETURN_FLAGS),
              "l_linestatus": letters("l_linestatus", LINE_STATUSES),
              "l_quantity": text("l_quantity"),
              "l_extendedprice": text("l_extendedprice"),
              "l_discount": text("l_discount"),
              "l_shipdate": text("l_shipdate", pa.date32()),
              "l_tax": text("l_tax")}
    quoted = {"l_returnflag", "l_linestatus", "l_shipdate"}
    parts = []
    for i, name in enumerate(Q1_JSON_FIELDS):
        q = '"' if name in quoted else ""
        parts += [("{" if i == 0 else ", ") + f'"{name}": {q}',
                  values[name], q]
    parts.append("}")
    return pa.table({"value": pc.binary_join_element_wise(*parts, "")})


def q1_json_conf(shuffle_partitions: int = 8) -> Dict:
    """``session_conf`` with the port's device parse of a double
    (``spark.rapids.tpu.sql.castStringToFloat.enabled``; the JAX package
    runs that cast on its row interpreter)."""
    return session_conf(shuffle_partitions, **{
        "spark.rapids.tpu.sql.castStringToFloat.enabled": True})


def q1_json_df(docs: pa.Table, num_slices: int = 8):
    """TPC-H Q1 over JSON Lines: every field read as
    ``from_json(value, schema).field``, which binds to
    ``get_json_object(value, '$.field')`` and a cast (BIGINT, DOUBLE or
    DATE; the flags stay strings)."""
    from .expressions.collections import GetStructField
    from .expressions.json import JsonToStructs
    kinds = (T.string(1), T.string(1), T.INT64, T.FLOAT64, T.FLOAT64,
             T.DATE, T.FLOAT64)
    js = JsonToStructs(col("value"), T.struct(*kinds, names=Q1_JSON_FIELDS),
                       Q1_JSON_FIELDS)
    last = datetime.date(1970, 1, 1) + datetime.timedelta(Q1_SHIPDATE_MAX)
    return (_df(docs, num_slices, JSON_MAX_LEN)
            .select(*[GetStructField(js, i).alias(n)
                      for i, n in enumerate(Q1_JSON_FIELDS)])
            .where(col("l_shipdate") <= lit(last))
            .group_by(*Q1_KEYS)
            .agg(*q1_aggregates())
            .order_by(*[asc(col(k)) for k in Q1_KEYS]))


def q1_json_flags_df(docs: pa.Table, num_slices: int = 8):
    """``json_tuple(value, 'l_returnflag', 'l_linestatus', 'l_shipdate')``
    grouped by both flags with ``count(*)`` over Q1's ship dates (an ISO
    date compares as its string): Q1's ``count_order``."""
    from .expressions.json import json_tuple
    last = (datetime.date(1970, 1, 1)
            + datetime.timedelta(Q1_SHIPDATE_MAX)).isoformat()
    return (_df(docs, num_slices, JSON_MAX_LEN)
            .select(*json_tuple(col("value"), *Q1_JSON_FIELDS[:2],
                                "l_shipdate"))
            .where(col("c2") <= lit(last))
            .group_by("c0", "c1")
            .agg(Count().alias("count_order"))
            .order_by(asc(col("c0")), asc(col("c1"))))


def q1_json_reference(table: pa.Table) -> pa.Table:
    """``q1_reference`` over the source table, its flags as the
    documents' letters (an order-keeping map, so the rows' order holds)."""
    ref = q1_reference(table)
    flags = pa.array(RETURN_FLAGS).take(ref.column("l_returnflag"))
    status = pa.array(LINE_STATUSES).take(ref.column("l_linestatus"))
    return ref.set_column(0, "l_returnflag", flags).set_column(
        1, "l_linestatus", status)



# ---------------------------------------------------------------------------
# Windows: TPC-DS-shaped paths over TPC-H's orders and lineitem
# ---------------------------------------------------------------------------

CUSTOMER_HISTORY_COLUMNS = ("o_orderkey", "o_custkey", "o_orderdate",
                            "o_totalprice", "rn", "running", "prev_date",
                            "last90", "price_rank")
SUPPLIER_MONTHS_COLUMNS = ("l_suppkey", "y", "m", "sum_sales",
                           "avg_monthly", "rn", "prev_sales", "next_sales",
                           "avg3")
#: customer history keeps each customer's orders of these price ranks
PRICE_RANKS = 3
#: supplier months: the year q47 filters and the rows it keeps
Q47_YEAR = 1996
Q47_TOP = 100


def tpch_window_tables(sf: float, seed: int = 3
                       ) -> Tuple[pa.Table, pa.Table]:
    """``(orders, lineitem)`` of one ``_tpch_columns(sf, seed,
    part_keys=True)`` draw: orders with O_ORDERKEY, O_CUSTKEY, O_ORDERDATE
    and O_TOTALPRICE; lineitem with L_PARTKEY, L_SUPPKEY, L_SHIPDATE and
    L_EXTENDEDPRICE. Keys are int64, money float64, dates DATE."""
    return _window_tables(_tpch_columns(sf, seed, part_keys=True))


def tpch_q14_q9_window_tables(sf: float, seed: int = 3):
    """``(tpch_q14_tables, tpch_q9_tables, tpch_window_tables)`` at
    ``(sf, seed)`` from one draw of ``_tpch_columns``."""
    c = _tpch_columns(sf, seed, part_keys=True)
    return _q14_tables(c, sf, seed), _q9_tables(c, sf, seed), \
        _window_tables(c)


def _window_tables(c: Dict[str, object]):
    return (_tpch_table(c, ("o_orderkey", "o_custkey", "o_orderdate",
                            "o_totalprice")),
            _tpch_table(c, ("l_partkey", "l_suppkey", "l_shipdate",
                            "l_extendedprice")))


def customer_history_df(orders: pa.Table, num_slices: int = 8):
    """Each customer's orders (TPC-DS q51's running sum, q67/q70's top N):
    over (o_custkey; o_orderdate, o_orderkey) the row number, the running
    sum of o_totalprice (ROWS UNBOUNDED PRECEDING to CURRENT ROW) and the
    previous order's date; over (o_custkey; o_orderdate) the sum of
    o_totalprice RANGE BETWEEN 90 PRECEDING AND CURRENT ROW; over
    (o_custkey; o_totalprice DESC) the rank; then the orders of rank at
    most ``PRICE_RANKS``."""
    from .expressions.window import (LagLead, Rank, RowNumber, WindowAgg,
                                     WindowFrame, over)
    cust = [col("o_custkey")]
    by_date = [asc(col("o_orderdate")), asc(col("o_orderkey"))]
    price = Sum(col("o_totalprice"))
    return (_df(orders, num_slices)
            .window(over(RowNumber(), cust, by_date).alias("rn"),
                    over(WindowAgg(price), cust, by_date,
                         WindowFrame(is_rows=True, start=None, end=0))
                    .alias("running"),
                    over(LagLead(col("o_orderdate"), 1), cust, by_date)
                    .alias("prev_date"))
            .window(over(WindowAgg(price), cust, [asc(col("o_orderdate"))],
                         WindowFrame(is_rows=False, start=-90, end=0))
                    .alias("last90"))
            .window(over(Rank(), cust, [desc(col("o_totalprice"))])
                    .alias("price_rank"))
            .where(col("price_rank") <= lit(PRICE_RANKS)))


def _sort_order(keys: Sequence[np.ndarray]) -> np.ndarray:
    """The order of rows sorted by the integer ``keys`` (most significant
    first): one argsort of the keys packed into an int64 when their
    ranges fit 63 bits, else ``np.lexsort``."""
    lows = [int(k.min()) for k in keys]
    bits = [max(int(k.max()) - lo, 1).bit_length()
            for k, lo in zip(keys, lows)]
    if sum(bits) > 63:
        return np.lexsort(tuple(reversed(keys)))
    packed = np.zeros(len(keys[0]), np.int64)
    for k, lo, b in zip(keys, lows, bits):
        packed = (packed << b) | (k.astype(np.int64) - lo)
    return np.argsort(packed, kind="stable")


def _group_starts(sorted_key: np.ndarray) -> np.ndarray:
    """The index of each row's group's first row, over a sorted key."""
    n = len(sorted_key)
    new = np.ones(n, bool)
    new[1:] = sorted_key[1:] != sorted_key[:-1]
    return np.maximum.accumulate(np.where(new, np.arange(n), 0))


def _segment_sums(values: np.ndarray, lo: np.ndarray, hi: np.ndarray
                  ) -> np.ndarray:
    """sum(values[lo:hi + 1]) per row, from one long-double prefix sum."""
    cs = np.concatenate([[0], np.cumsum(values, dtype=np.longdouble)])
    return (cs[hi + 1] - cs[lo]).astype(np.float64)


def customer_history_reference(orders: pa.Table) -> pa.Table:
    """``customer_history_df``'s rows with numpy (one sort per spec,
    binary searches for the 90-day frame), sorted by o_orderkey."""
    key = orders.column("o_orderkey").to_numpy()
    cust = orders.column("o_custkey").to_numpy()
    date = orders.column("o_orderdate").cast(pa.int32()).to_numpy()
    price = orders.column("o_totalprice").to_numpy()
    n = len(key)
    iota = np.arange(n)
    o = _sort_order((cust, date, key))
    c, d = cust[o], date[o]
    start = _group_starts(c)
    rn = np.empty(n, np.int32)
    rn[o] = iota - start + 1
    running = np.empty(n)
    running[o] = _segment_sums(price[o], start, iota)
    prev = np.empty(n, np.int32)
    prev[o] = np.where(start == iota, 0, np.roll(d, 1))
    first = np.empty(n, bool)
    first[o] = start == iota
    # the 90-day RANGE frame: every order of the customer dated d-90..d,
    # ties on the date included
    ck = (c.astype(np.int64) << 20) + d
    lo = np.searchsorted(ck, ck - 90, "left")
    hi = np.searchsorted(ck, ck, "right") - 1
    last90 = np.empty(n)
    last90[o] = _segment_sums(price[o], lo, hi)
    by_price = np.argsort(-price, kind="stable")
    o2 = by_price[np.argsort(cust[by_price], kind="stable")]
    c2, p2 = cust[o2], price[o2]
    peer = np.ones(n, bool)
    peer[1:] = (c2[1:] != c2[:-1]) | (p2[1:] != p2[:-1])
    peer_start = np.maximum.accumulate(np.where(peer, iota, 0))
    rank = np.empty(n, np.int32)
    rank[o2] = peer_start - _group_starts(c2) + 1
    keep = np.flatnonzero(rank <= PRICE_RANKS)
    keep = keep[np.argsort(key[keep], kind="stable")]
    return pa.table({
        "o_orderkey": key[keep], "o_custkey": cust[keep],
        "o_orderdate": orders.column("o_orderdate").take(keep),
        "o_totalprice": price[keep], "rn": rn[keep],
        "running": running[keep],
        "prev_date": pa.array(prev[keep], pa.int32(),
                              mask=first[keep]).view(pa.date32()),
        "last90": last90[keep], "price_rank": rank[keep]})


def _check_window_rows(got: pa.Table, want: pa.Table, keys: Sequence[str],
                       floats: Sequence[str], what: str) -> str:
    """``got`` sorted by ``keys`` against ``want`` (sorted so): the same
    columns, integers, dates and nulls exactly, ``floats`` within rel
    1e-6. Returns a line that says so; raises on a difference."""
    got = got.sort_by([(k, "ascending") for k in keys])
    want = want.sort_by([(k, "ascending") for k in keys])
    if got.column_names != want.column_names or \
            got.num_rows != want.num_rows:
        raise AssertionError(f"{what}: {got.num_rows} rows of "
                             f"{got.column_names}, the reference "
                             f"{want.num_rows} of {want.column_names}")
    worst = 0.0
    for name in got.column_names:
        g, w = got.column(name), want.column(name)
        if name not in floats:
            if not g.cast(w.type).equals(w):
                raise AssertionError(f"{what}: column {name} differs")
            continue
        if not pc.equal(g.is_null(), w.is_null()).to_numpy().all():
            raise AssertionError(f"{what}: column {name}'s nulls differ")
        gv = g.fill_null(0.0).to_numpy()
        wv = w.fill_null(0.0).to_numpy()
        rel = np.abs(gv - wv) / np.maximum(np.abs(wv), 1e-300)
        err = float(rel.max()) if len(rel) else 0.0
        if not err <= 1e-6:
            raise AssertionError(f"{what}: column {name} max rel err {err}")
        worst = max(worst, err)
    return f"all {got.num_rows} rows, floats max rel err {worst:.3g}"


def check_customer_history(got: pa.Table, want: pa.Table) -> str:
    return _check_window_rows(got, want, ["o_orderkey"],
                              ("o_totalprice", "running", "last90"),
                              "customer history")


def supplier_months_df(lineitem: pa.Table, num_slices: int = 8):
    """TPC-DS q47's shape over lineitem: monthly sales per supplier (a sum
    grouped by l_suppkey, year and month of l_shipdate), their average
    over (l_suppkey, year) in the full frame; over (l_suppkey; year,
    month) the rank, the previous and next month's sales and the average
    over ROWS BETWEEN 1 PRECEDING AND 1 FOLLOWING; q47's filter (year
    ``Q47_YEAR``, a positive average, more than 10% away from it) and its
    first ``Q47_TOP`` rows by the deviation, then supplier and month."""
    from .expressions import Abs, month
    from .expressions.window import (LagLead, Rank, WindowAgg, WindowFrame,
                                     over)
    supp, ym = [col("l_suppkey")], [asc(col("y")), asc(col("m"))]
    sales = col("sum_sales")
    dev = Abs(sales - col("avg_monthly")) / col("avg_monthly")
    return (_df(lineitem, num_slices)
            .select(col("l_suppkey"), year(col("l_shipdate")).alias("y"),
                    month(col("l_shipdate")).alias("m"),
                    col("l_extendedprice"))
            .group_by("l_suppkey", "y", "m")
            .agg(Sum(col("l_extendedprice")).alias("sum_sales"))
            .window(over(WindowAgg(Average(sales)),
                         [col("l_suppkey"), col("y")]).alias("avg_monthly"))
            .window(over(Rank(), supp, ym).alias("rn"),
                    over(LagLead(sales, 1), supp, ym).alias("prev_sales"),
                    over(LagLead(sales, 1, None, False), supp, ym)
                    .alias("next_sales"),
                    over(WindowAgg(Average(sales)), supp, ym,
                         WindowFrame(is_rows=True, start=-1, end=1))
                    .alias("avg3"))
            .where(And(And(EqualTo(col("y"), lit(Q47_YEAR)),
                           GreaterThan(col("avg_monthly"), lit(0.0))),
                       GreaterThan(dev, lit(0.1))))
            .order_by(asc(sales - col("avg_monthly")), asc(col("l_suppkey")),
                      asc(col("m")))
            .limit(Q47_TOP))


def supplier_months_reference(lineitem: pa.Table) -> pa.Table:
    """``supplier_months_df``'s rows with numpy: the monthly sums by one
    bincount over dense (supplier, month) numbers, the windows over the
    groups in that order."""
    days = lineitem.column("l_shipdate").to_numpy().astype("datetime64[D]")
    months = days.astype("datetime64[M]").astype(np.int64)   # since 1970
    supp = lineitem.column("l_suppkey").to_numpy()
    # one dense group number a (supplier, month), in their order: the
    # groups' sums are one bincount, the groups present its nonzero counts
    m0, s0 = int(months.min()), int(supp.min())
    span = int(months.max()) - m0 + 1
    gid = (supp - s0) * span + (months - m0)
    size = int(gid.max()) + 1
    present = np.flatnonzero(np.bincount(gid, minlength=size))
    sales = np.bincount(gid, weights=lineitem.column("l_extendedprice")
                        .to_numpy(), minlength=size)[present]
    s, mo = present // span + s0, present % span + m0
    y, m = (mo // 12 + 1970).astype(np.int32), (mo % 12 + 1).astype(np.int32)
    n = len(present)
    iota = np.arange(n)
    sy = _group_starts(s * 16384 + y)
    sy_end = np.empty(n, np.int64)
    sy_end[::-1] = np.minimum.accumulate(
        np.where(np.r_[sy[1:] != sy[:-1], True], iota, n)[::-1])
    avg = _segment_sums(sales, sy, sy_end) / (sy_end - sy + 1)
    start = _group_starts(s)
    end = np.empty(n, np.int64)
    end[::-1] = np.minimum.accumulate(
        np.where(np.r_[start[1:] != start[:-1], True], iota, n)[::-1])
    first, last = start == iota, end == iota
    lo, hi = np.maximum(iota - 1, start), np.minimum(iota + 1, end)
    avg3 = _segment_sums(sales, lo, hi) / (hi - lo + 1)
    keep = np.flatnonzero((y == Q47_YEAR) & (avg > 0)
                          & (np.abs(sales - avg) / np.where(avg > 0, avg, 1)
                             > 0.1))
    keep = keep[np.lexsort((m[keep], s[keep], sales[keep] - avg[keep]))]
    keep = keep[:Q47_TOP]
    return pa.table({
        "l_suppkey": s[keep], "y": y[keep], "m": m[keep],
        "sum_sales": sales[keep], "avg_monthly": avg[keep],
        "rn": (iota - start + 1).astype(np.int32)[keep],
        "prev_sales": pa.array(np.roll(sales, 1)[keep],
                               mask=first[keep]),
        "next_sales": pa.array(np.roll(sales, -1)[keep], mask=last[keep]),
        "avg3": avg3[keep]})


def check_supplier_months(got: pa.Table, want: pa.Table) -> str:
    return _check_window_rows(got, want, ["l_suppkey", "y", "m"],
                              ("sum_sales", "avg_monthly", "prev_sales",
                               "next_sales", "avg3"), "supplier months")


def _spread3(v: np.ndarray) -> np.ndarray:
    """The low 21 bits of each value spaced three apart (magic masks)."""
    x = v.astype(np.uint64) & np.uint64(0x1FFFFF)
    for shift, mask in ((32, 0x1F00000000FFFF), (16, 0x1F0000FF0000FF),
                        (8, 0x100F00F00F00F00F), (4, 0x10C30C30C30C30C3),
                        (2, 0x1249249249249249)):
        x = (x | (x << np.uint64(shift))) & np.uint64(mask)
    return x


def zorder3_reference(a: np.ndarray, b: np.ndarray, c: np.ndarray
                      ) -> np.ndarray:
    """``zorder_key`` of three non-null integer or date columns with
    numpy's magic-mask bit spread (not the port's bit loop): each value
    saturated into int32 and offset by 2^31 (at least 1), its top 21 bits
    spread three apart, column ``a`` the most significant of each group,
    the top bit flipped; int64."""
    def top21(v):
        w = np.clip(v.astype(np.int64), -(1 << 31), (1 << 31) - 1) \
            + (1 << 31)
        return np.maximum(w, 1) >> 11
    z = (_spread3(top21(a)) << np.uint64(2)) | \
        (_spread3(top21(b)) << np.uint64(1)) | _spread3(top21(c))
    return (z ^ np.uint64(1 << 63)).view(np.int64)


def zorder_df(lineitem: pa.Table, num_slices: int = 8):
    """Delta's OPTIMIZE ZORDER BY (l_partkey, l_suppkey, l_shipdate) as the
    JAX ``io/delta.py`` runs it: the rows sorted by their Morton key,
    which the query keeps as ``z``."""
    from .expressions.zorder import zorder_key
    z = zorder_key(col("l_partkey"), col("l_suppkey"), col("l_shipdate"))
    return (_df(lineitem, num_slices)
            .select(col("l_partkey"), col("l_suppkey"), col("l_shipdate"),
                    z.alias("z"))
            .order_by(asc(col("z"))))
