"""TPC-H Q1 and the part stage of TPC-H Q16 through the port, end to end.

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
suppliers over ``partsupp`` less the complained-of ones: the join slice is
not ported yet. ``part_table`` makes dbgen-shaped ``part`` columns (spec
4.2.3) from a numpy seed.

``q1_reference`` and ``q16_part_reference`` compute the same with pyarrow
alone, as independent oracles.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc

from .batch import DeviceLike, Field, Schema, resolve_device, schema_from_arrow
from .exec import (AggregateMode, CoalesceBatchesExec, Exec, FilterExec,
                   HashAggregateExec, InMemoryScanExec, SortExec, asc,
                   collect, desc)
from .exec.sort import SortOrder
from .expressions import (And, EqualTo, Expression, In, Not, col, lit,
                          startswith)
from .expressions.aggregates import Average, Count, Sum
from .shuffle import HashPartitioning, ShuffleExchangeExec

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


def _scan(table: pa.Table, num_slices: int,
          device: DeviceLike) -> InMemoryScanExec:
    """The scan of ``table`` in ``num_slices`` input partitions of one batch
    each. Column nullability is read from the data (null counts), as
    ``batch.from_arrow`` does."""
    dev = resolve_device(device)
    schema = Schema([Field(f.name, f.dtype,
                           f.nullable and table.column(i).null_count > 0)
                     for i, f in enumerate(schema_from_arrow(
                         table.schema, STRING_MAX_LEN))])
    batch_rows = max(1, -(-table.num_rows // num_slices))
    return InMemoryScanExec(table, schema, batch_rows=batch_rows,
                            num_slices=num_slices, device=dev)


def _grouped_stage(scan: Exec, condition: Expression, keys: Sequence[str],
                   aggregates, shuffle_partitions: int,
                   orders: Sequence[SortOrder]) -> Exec:
    """Filter, partial aggregate, hash exchange on the keys, final
    aggregate and sort: the JAX planner's tree for a grouped query."""
    filtered = FilterExec(condition, scan)
    key_cols = [col(k) for k in keys]
    partial = HashAggregateExec(key_cols, aggregates(),
                                CoalesceBatchesExec(filtered),
                                AggregateMode.PARTIAL)
    exchange = ShuffleExchangeExec(
        HashPartitioning([col(f.name) for f in partial.key_fields],
                         shuffle_partitions), partial)
    final = HashAggregateExec(key_cols, aggregates(), exchange,
                              AggregateMode.FINAL)
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
