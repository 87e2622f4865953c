#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--rows N]

Builds every CUDA kernel of the port from the sources in this checkout (one
``nvcc`` per source, all at once) and holds each kernel against its plain
PyTorch version on the card. Then it holds the hash join on the card
against the same join on the CPU, for every join type over 2^17 stream rows
and 2^15 build rows, on an exact int64 key, a dense primary-key build and a
hashed (int32, string) key, broadcast and co-partitioned. Last it runs the
port's three paths end to end through ``spark_rapids_tpu_torch.entry``:
TPC-H Q1 at the SF10 lineitem row count (``--rows``; Arrow upload, filter,
partial aggregate, hash exchange, final aggregate, sort, collect), the part
stage of TPC-H Q16 at the SF100 part row count, and TPC-H Q3 at SF10 (three
scans and filters, two shuffled hash joins, the aggregate's exchange, sort
and limit) and TPC-H Q18 at SF10 (the IN subquery's aggregate and semi
join, the customer join, the grace join that builds on lineitem, the
grouped aggregate, sort and limit) under a 1 GiB device budget, so exchange
pieces spill to pinned host memory. Each result is checked against an
independent pyarrow oracle, and each path's kernel launch counts, set to 0
just before its first run and read just after, show that it went through
its kernels. Right after Q18 comes the DECIMAL128 phase: Q18 again over
the same SF10 tables through the port's Session with AQE on, in the
spec's DECIMAL types (decimal(15, 2) quantities and prices, decimal(25, 2)
limb sums, the HAVING a limb comparison), with its four keys as
decimal(38, 0) (limb keys sorted, grouped, joined and routed by
``_hash_dec128``) and as float64, each exactly equal to its pyarrow
oracle, nothing fallen back, with cold, warm and profiled walls, peaks
and idle shares, murmur3 held against its plain version in each cold
run, a sample of every ``_hash_dec128`` call and the hash's edge list
against the scalar ``hash_decimal``, and the limb sum lanes' device ms.
Then the out-of-core operators (the windowed and the
sort-based aggregate merge, the out-of-core global sort, the grace join)
run on the card and on the CPU at about 4M rows, 0 rows apart, and Q18 at
SF1 runs under injected OOMs (every third allocation check fails) and must
equal its clean run bit for bit. Then TPC-H Q2 and Q11 run at SF100
(80,000,000 partsupp rows): Q2 (the grouped Min of its subquery, the
two-key join, the top 100 by four keys) must equal pyarrow in all 100 rows
and every column and launch ``window_match`` once per part slice, which is
also held against its plain version at Q2's own shape (k = 5); Q11 (the
HAVING against its scalar subquery as a nested-loop join) must give
pyarrow's row set, with its smallest margin to the threshold printed. Last
come the bench's hash_agg shape (4M rows, 1M keys, COMPLETE and PARTIAL ->
FINAL) against pyarrow, every new operator (the aggregate functions, the
top-N, the partition-local sort, the nested-loop join in every type) on the
card against the CPU, and the fused Q1 stage (``entry.q1_stage``) on one
SF10 slice, on CUDA events, against pyarrow.

Then TPC-H Q16 whole at SF100 (80,000,000 partsupp, 20,000,000 part and
1,000,000 supplier rows, ``entry.tpch_q16_tables``) through the port's
Session (``entry.q16_df``: the part filter, the join with partsupp, the
LEFT ANTI join with the suppliers whose comment is LIKE
'%Customer%Complaints%', count(DISTINCT ps_suppkey) as two group-bys, the
sort), equal to ``entry.q16_reference`` (pyarrow) in every row, nothing
fallen back, with its warm wall, rows/s, peak and idle share;
``window_match`` at its k = 15 part filter and murmur3 at its two
p_size exchanges held against their plain versions, and the Like
filter's DFA on the card against the CPU over every supplier batch, with
its device time and launches a batch. Its second leg runs the same query
over ``dictionary_encode_arrow`` of the same tables (``dictenc.py``):
p_brand and p_type stay codes, s_comment falls back on the cardinality
fraction, and ``dict_fallbacks()`` must name s_comment alone; its rows
equal the plain leg's and the oracle's, both kernels launch and are held
against their plain versions, and its walls, peak, idle share and the
wire bytes (encoded, raw) of the part side's exchange input print beside
the plain leg's. Then the string phase: every
string expression of the port (53, each class at least once; hex, bin and
conv at INT64_MIN, -1, 0 and INT64_MAX) over 2^12 rows of S_COMMENT,
P_TYPE, an int64 and a decimal on the card against the port's row
interpreter, 0 rows apart (a fused stage, captured), and StringLocate,
StringReplace and SubstringIndex over the SF100 P_TYPE column in 8
slices against pyarrow, each ``window_match`` launch held against its
plain version on the same inputs (24: k = 8, 5 and 1). Then the catalog
phase: the part-catalogue roll-up (``entry.catalog_df``: regexp_extract,
find_in_set, initcap over regexp_replace and regexp_replace over P_TYPE
and P_BRAND, a group-by, then concat_ws, bin, format_number, hex, conv
and empty2null over the groups) over the 20,000,000 SF100 part rows
through the Session, cold, equal to
``entry.catalog_reference`` in all 3,750 groups in order, nothing fallen
back, with its wall, rows/s and peak, murmur3 at its exchange against its
plain version; and the
comment leg (``entry.comment_spans_df``: regexp_extract and
regexp_replace over the 1,000,000 SF100 S_COMMENT rows at 128 bytes), 0
rows apart from pyarrow's RE2 in one run.

Then the scalar slice. TPC-H Q14 at SF10 (``entry.q14_df``: September
1995's lines by ``add_months``, the join with 2,000,000 part rows, a CASE
WHEN over ``startswith(p_type, 'PROMO')`` in a global sum) and TPC-H Q9 at
SF10 (``entry.q9_df``: the green part filter, five joins, the partsupp one
on two keys, ``year(o_orderdate)``, profit summed by nation and year)
through the port's Session, each equal to its pyarrow reference (floats
within rel 1e-6), nothing fallen back, with cold and warm walls, rows/s,
peak and idle share, ``window_match`` (k = 5) held against its plain
version at every launch of one run, and murmur3 at Q9's o_year exchange;
then every expression of ``conditional.py``, ``math.py``, ``cast.py`` and
``datetime.py`` (110: every math function, cast pair, date part, format,
level and zone the columns reach; decimal casts past their precision give
null) over 2^14 rows of dates, timestamps,
strings and doubles with NaN, the infinities, -0.0, MIN and MAX and nulls,
on the card as one fused stage captured in a CUDA graph, against the row
interpreter (0 rows apart, floats within rel 1e-12) and ``Rand`` against
the same Session on the CPU, bit for bit; and raise_error failing a query
on the card and on the interpreter.

Right after Q9, over the same SF10 draw, the windows
(``[phase windows]``): customer history over the 15,000,000 orders
(``entry.customer_history_df``: three window specs per o_custkey, row
number, a ROWS running sum and lag over (date, key), a 90-day RANGE sum
over the date, the rank by price descending, then rank <= 3) and supplier
months over the 59,986,052 lines (``entry.supplier_months_df``: monthly
sales per supplier by year and month, their yearly average over the full
frame, rank, lag, lead and a three-month average, q47's filter and top
100), each through the Session with nothing fallen back, equal to its
numpy reference (integers and dates exactly, floats within rel 1e-6),
with cold, warm and profiled walls, rows/s, peak and idle share, and
supplier months' murmur3 launches (its int32 year and month at the
aggregate's exchange and the year at the yearly window's) each held
against the plain version in the cold run; then every window function
over 2^14 rows on the card against the row interpreter, 0 rows apart: the
ROWS and RANGE frame matrices ascending and descending with nulls first
and last, int, double (NaN and nulls), date and string order keys, the
ranking functions, nth_value, lag and lead of strings with defaults, a
window without PARTITION BY, and key batching at batchRows 64. Then
``[phase zorder]``: OPTIMIZE ZORDER BY's sort (``entry.zorder_df``) of
the SF10 lineitem by zorder_key(l_partkey, l_suppkey, l_shipdate), every
key equal to numpy's magic-mask Morton key (``entry.zorder3_reference``)
and the keys in order.

Then, over the same SF10 draw, the nested kinds
(``[phase baskets]``): the order baskets (``entry.baskets_df``:
collect_set of each order's part keys into array<bigint> of at most 8,
count and max beside it, the arrays riding the join with the 15,000,000
orders as payload, a named_struct of the order date and line count as
the sort key, size, array_contains, array_min, array_max,
element_at(sort_array(desc), 1), size >= 4, the first 10,000), the item
support (explode, group by item, the top 100, its exploded row count the
distinct (order, part) pairs) and the P_NAME words (split into
array<string> in the 3D layout, size, element_at, explode, all 92 words),
each exact against its vectorized numpy/pyarrow reference, nothing fallen
back, with a checked cold run, a checked warm run (wall, rows/s, peak)
and a profiled run (idle share), beside the card's name and power
limit; no
kernel lies on these paths. Then the order lines as arrays
(``[phase order lines]``, ``entry.order_lines_df`` over the same draw:
each order's lines packed into one collect_list and unpacked by
transforms, collect_set of its parts and of its deep-discount parts,
three joins with orders, aggregate, zip_with, array_distinct, the four
set operations, filter, exists, forall, a transform reading an outer
column, slice, array_position, array_remove, transform_values,
map_filter, transform_keys, sequence and flatten; the top 10,000 by
quantity), exact against its vectorized reference, nothing fallen back,
cold, warm and profiled as the baskets; and explode(replicaterows(
n_lines)) under generate.maxRepeat 8, one row per line. Then
``[phase collections]``: every expression of ``collections.py`` and
``json.py``, split and str_to_map with their consumers, collect_list,
collect_set, pivot_first, first/last over arrays and explode of an array,
a map, a split and replicaterows with outer and pos, over 2^14 seeded rows
(lists with empty and null rows and NaN, null structs, a
map<int,bigint>, "k:v,k:v" strings, JSON documents with nesting, [i]
paths, escapes, a \\u escape, blanks, null and garbage) on the card
against the row interpreter (the map lambdas and zip_with, which no
interpreter handles, against the port's CPU run), 0 rows apart, and slice
from 0 and a sequence past its budget failing on both. Then
``[phase json q1]``: TPC-H Q1 over 6,001,215 JSON Lines documents (SF1)
through from_json's fields (get_json_object and a cast, the double parse
on the card), within rel 1e-6 of pyarrow, nothing fallen back, every
window_match launch (each field step, k = 7 to 17) against its plain
version, and json_tuple's count by flag equal to Q1's count_order.

Then whole-stage fusion (``exec/fuse.py``): Q2's part filter (one Q2 part
slice, ``window_match`` at k = 5) and a join on two int32 keys (murmur3)
each run as a fused stage captured in a CUDA graph and replayed, every run
equal to the iterator path, the capture holding the kernel, the kernel
equal to its plain version on the stage's own input; union, range, expand,
sample (seeded; over 2^20 ids the card keeps the CPU's rows, the JAX
package's threefry draws, in three (fraction, seed, slices) cases) and every arithmetic
expression over edge rows on the card against the CPU, and the ANSI
errors raising on the card in a
``ProjectExec`` and in a fused stage. Last the bench's join+sort stage
(``entry.join_sort_runner``) at 2^21 x 2^18 through the captured graph,
the eager fused program and the iterator path, every row equal to pyarrow,
and at 59,986,052 x 15,000,000 rows through the graph and the eager
program, equal to each other, with each mode's warm wall, rows/s, peak,
and the device busy time and idle share of one profiled run; and the 8x
overflow retry at 1M stream rows, which must re-plan and capture at the
needed factor.

Then adaptive execution (AQE) and the new kinds: Q3 and Q18 at SF10 run
again under the JAX Session's default adaptive conf, equal to pyarrow,
with their decisions, warm walls and peaks beside the AQE-off runs (Q18
must leave no catalog entry); the range exchange plus a partition-local
sort over 2^24 rows of Q3's lineitem must equal pyarrow's global sort;
the skew bench's query (``tools/skew_bench.py``) at 67,108,864 fact rows
and 2,097,152 dim rows runs in its three legs, each equal to pyarrow and
bit for bit to the others, with its decisions, the wall of one warm run,
rows/s and peak, and the idle share of the last leg; and a column of each
new kind (int8, int16, float, DECIMAL(15,2), timestamp, NULL) at the SF10
lineitem row count is
hash-partitioned alone, its partition counts over a 2^22-row prefix equal
on the card and the CPU, murmur3 launched for the int8, int16 and float
keys.

Last the Parquet slice (``spark_rapids_tpu_torch/io``), over files written
to a fresh temporary directory that is removed at the end: a 2^24-row
prefix of the SF10 lineitem written through
``entry.write_lineitem_bucketed`` from an 8-slice scan into 16 buckets on
l_shipdate (SNAPPY), whose ``WriteStats`` must count
every row in 8 x 16 files, whose files read back through the port's
``ParquetSource`` must hold only rows of their bucket (``murmur3_int32`` on
the card, equal to its plain version) and together equal the input as a
multiset of rows; the bench's scan (``bench.bench_parquet_scan``: 2^21 rows
in 8 files, each reader type, then the SF10 lineitem in 8 files,
MULTITHREADED), equal to pyarrow's dataset read as a row set, with its warm
wall, rows/s, the decode alone beside the upload alone, the row groups
pruned and the peak; Q1 from those SF10 files, equal to the pyarrow oracle
and to the in-memory ``run_q1``, with its idle share and murmur3 held
against its plain version on every batch of its exchange; and Q16's part
stage from the SF100 part table in 8 files, exact, its predicate kept
above the scan so that p_brand and p_type arrive as RLE_DICTIONARY codes
(the default; none do under a pushed-down predicate), with the pieces
the exchange read merged and the decode and upload seconds beside a run
under ``dictEncoding.enabled=false``, whose rows are equal. Every row
group of
those files must decode through the port's native decoder, and no scan of
the runs may take the pyarrow fallback.

After Q3 and the range sort comes the fallback phase: CPU fallback
islands through the port's Session under the same conf. Q1 at SF10 with
``sql.exec.Sort`` off is a CPU-topped plan (the final sort over the 4
groups runs on the row interpreter, on the host, with no upload after it),
and Q3 at SF10 with ``sql.expression.EqualTo`` off turns the customer
filter alone into an island that reads the card's scan through Arrow and
uploads its rows back; each equals its oracle (and Q3 the same Session
without the switch) with the ``fell_back()`` list it must have, murmur3
held against its plain version at every exchange, and each prints one
cold and one warm wall, the islands' host time inside
``CpuFallbackExec.interpret`` with their rows in and out, the peak and the
idle share. Then the port's own differential on the card: q1_stage,
hash_agg, join_sort, parquet_scan and the Q16 part stage at 2^16 rows,
``Session()`` against ``Session({"spark.rapids.tpu.sql.enabled":
False})`` (the row interpreter), ``window_match`` held against its plain
version at the Q16 filter, and explain-only mode on q1_stage (the
interpreter's rows, a planned ``last_plan``, the device bytes it
allocated). To keep the script's time, the bucketed write has no
profiled second write, and the SF10 join_sort runs its iterator path
once.

Right after Q1 and the Q16 part stage comes the Session phase: the port's
``plan.Session`` plans Q1 at SF10, the Q16 part stage at 20,000,000 part
rows and the bench's q1_stage, hash_agg, join_sort and parquet_scan
shapes from their DataFrames (``entry.*_df``) under the conf the port's
tests use (incompatibleOps on, AQE off), each tree equal to the
hand-built ``entry.*_plan``'s, nothing fallen back and every operator on
the card, each result against pyarrow, with each path's warm wall and
planning time; murmur3 is held against its plain version at the Session
Q1's and Q16's exchanges and ``window_match`` at the Session Q16's filter,
and join_sort runs as a fused stage that ``Session.collect`` captures in
a CUDA graph and replays.

Right after the Session phase, over its SF10 lineitem, comes the mesh
phase (``spark_rapids_tpu_torch.parallel``, ``shuffle.mode=ICI``), 8
shards over the visible cards (all 8 on one card where it is alone): Q1
at SF10 through the Session as one ``MeshStageExec`` whose lowered list
is the JAX Session's, equal to pyarrow, with a cold and two warm walls,
the peak, the split of one warm wall between input staging, each shard's
local kernels and the exchanges (CUDA events), the idle share of one
profiled warm run, and Session Q1 without ICI beside it; the bench's
ici_exchange shape (2^20 fact rows, a planned broadcast join and a
group-by) against pyarrow, with its stage's program timed alone as the
bench times it; the dryrun's filter, shuffled join, group-by and global
sort at 2^24 x 2^20 rows with AQE off (four exchanges, the order exact
against pyarrow); the two-process exchange (two ranks of two shards
each over ``torch.distributed``: NCCL with a card per rank, gloo through
host memory on one card); and ``entry.dryrun_multigpu(8)``. murmur3 is
held against its plain version on every key the stages route.

Prints, in order: the card's name and power limit, the build time, each
kernel check with its times and bound, the join check, the checks of Q1 and
the Q16 part stage, the Session phase, the mesh phase, Q3 (AQE off, then
on) with their times, the range sort, the fallback phase, the spill copy
rate, Q18's checks (AQE off, then on) with their times, the catalog's
tiers, spilled bytes, retry metrics, grace buckets and the allocator's
peak, the three legs of Q18 in decimals, the skew legs, the types exchange, the out-of-core check, the
injection run, the checks of Q2 and Q11 with their times, Q16 whole, the
string phase and the catalog phase, Q14, Q9, the baskets and collections
phases and the scalar phase, the captured kernel checks, the
hash_agg, operator, new-operator, limb (DECIMAL128 at 2^17 rows, card
against the row interpreter) and Q1-stage checks, the join_sort modes
and the overflow retry, the Parquet write, scans, Q1 and Q16 part stage,
each phase's wall time, a ``{"kernels": [...]}`` JSON line (the
window_match times are at Q2's shape; launches count a graph's replays),
and last ``{"ok": true, "device": ...}``. Any failed phase raises, so the
exit code is not 0 and no result line is printed. Without CUDA it exits 1
at once."""

from __future__ import annotations

import argparse
import json
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

#: TPC-H SF10 lineitem rows
SF10_LINEITEM_ROWS = 59_986_052
#: TPC-H SF100 part rows (spec: SF x 200,000)
SF100_PART_ROWS = 20_000_000
#: the Q16 part stage's input slices (2,500,000 rows, capacity 2^22, each)
#: and shuffle partitions
Q16_SLICES = 8
Q16_SHUFFLE_PARTITIONS = 8
#: groups of the Q16 part stage once every combination is present:
#: 24 brands x 145 types x 8 sizes
Q16_GROUPS = 27_840
#: numpy seed of the part data
PART_SEED = 16
#: Q1's input slices (capacity 2^23 each at SF10) and shuffle partitions
Q1_SLICES = 8
Q1_SHUFFLE_PARTITIONS = 8
#: numpy seed of the lineitem data
DATA_SEED = 3
#: TPC-H scale factor of the Q3 run (1,500,000 customers, 15,000,000 orders,
#: about 60,000,000 lineitem rows), its input slices, shuffle partitions
#: and data seed
Q3_SF = 10
Q3_SLICES = 8
Q3_SHUFFLE_PARTITIONS = 8
Q3_SEED = 3
#: TPC-H Q18: scale factor, input slices, shuffle partitions (each holds
#: about 30M lineitem rows, as SF1000 over Spark's 200 do), device budget
#: (spark.rapids.tpu.memory: the JAX package's 8 GiB cut to 1 GiB so that
#: SF10 spills about as SF100 would under 8 GiB) and data seed
Q18_SF = 10
Q18_SLICES = 8
Q18_SHUFFLE_PARTITIONS = 2
Q18_BUDGET = 1 << 30
Q18_SEED = 3
#: scale factor and injection schedule of the OOM-injection run
Q18_INJECT_SF = 1
Q18_INJECT_MODE = "every-3"
#: PCIe Gen5 x16 rate in each direction, bytes/s (32 GT/s x 16 lanes,
#: 128b/130b encoding)
PCIE_BYTES_PER_S = 63.0e9
#: H100 SXM device memory rate, bytes/s (NVIDIA data sheet)
HBM_BYTES_PER_S = 3.35e12
#: H100 SXM float32 rate outside the tensor cores, operations/s; 32-bit
#: integer work is counted against it
FP32_OPS_PER_S = 67e12
#: relative tolerance for float aggregates: the port and the oracle add
#: float64 values in different orders
FLOAT_REL_TOL = 1e-6


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


#: GPU clock cycles of the sleep kernel queued ahead of each timed call
#: (about 1 ms on an H100), longer than the host takes to launch the call
QUEUE_SLEEP_CYCLES = 2_000_000


def time_cuda_ms(fn, reps: int, warmup: int = 3) -> float:
    """Median device time of one call, from CUDA events around each. A
    sleep kernel queued first keeps the device busy while the host launches
    the call, so the interval holds the call's device work and not the
    host's launch overhead (host syncs inside ``fn`` still count)."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(QUEUE_SLEEP_CYCLES)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


# ---------------------------------------------------------------------------
# murmur3 hashInt kernel
# ---------------------------------------------------------------------------

#: the exchange hashes each PARTIAL output at its capacity, one slice's
#: bucket (SF10 rows over 8 slices -> 7,498,257 rows -> 2^23)
MURMUR3_PATH_ROWS = 1 << 23
MURMUR3_BYTES_PER_ROW = 13      # 4 data + 1 validity + 4 seed in, 4 out
MURMUR3_OPS_PER_ROW = 22        # mixes, rotates, xors, fmix, select


def check_murmur3(dev, part) -> dict:
    """The kernel against its plain version, bit for bit, with random
    validity and chained seeds over two key columns. At the Q16 part
    stage's capacity the first column is p_size of ``part`` (one scanned
    slice) and its seeds are the running hash of p_brand and p_type, as in
    that stage's exchange. The shapes of Q3, Q18 and the skewed join are
    checked in their own phases (``check_murmur3_at_exchanges``), on
    those paths' data."""
    import numpy as np
    import torch
    from spark_rapids_tpu_torch.expressions.hashing import (DEFAULT_SEED,
                                                            hash_column)
    from spark_rapids_tpu_torch.kernels.murmur3 import (murmur3_int32,
                                                        murmur3_int32_plain)
    rng = np.random.default_rng(11)
    max_err = 0
    timing = None
    for n in (MURMUR3_PATH_ROWS, part.capacity, 1_000_003, 1):
        cols = [torch.from_numpy(rng.integers(-2**31, 2**31, n, dtype=np.int64)
                                 .astype(np.int32)).to(dev) for _ in range(2)]
        valid = [torch.from_numpy(rng.random(n) > 0.1).to(dev)
                 for _ in range(2)]
        seed = torch.full((n,), DEFAULT_SEED, dtype=torch.int32, device=dev)
        what = "two chained columns"
        if n == part.capacity:
            brand, ptype, size = part.columns
            seed = hash_column(ptype, hash_column(brand, DEFAULT_SEED))
            cols[0], valid[0] = size.data, size.validity
            what = "p_size seeded by the p_brand, p_type hash, then a column"
        k1 = murmur3_int32(cols[0], valid[0], seed)
        k2 = murmur3_int32(cols[1], valid[1], k1)
        p1 = murmur3_int32_plain(cols[0], valid[0], seed)
        p2 = murmur3_int32_plain(cols[1], valid[1], p1)
        torch.cuda.synchronize()
        err = max(int((k1.long() - p1.long()).abs().max()),
                  int((k2.long() - p2.long()).abs().max()))
        print(f"murmur3_int32 n={n}: kernel vs plain, {what}, "
              f"max_abs_err={err}")
        if err != 0:
            raise AssertionError(f"murmur3_int32 disagrees with its plain "
                                 f"version at n={n}")
        max_err = max(max_err, err)
        if n == MURMUR3_PATH_ROWS:
            ms = time_cuda_ms(lambda: murmur3_int32(cols[1], valid[1], k1), 50)
            plain_ms = time_cuda_ms(
                lambda: murmur3_int32_plain(cols[1], valid[1], k1), 10)
            timing = (ms, plain_ms)
    ms, plain_ms = timing
    n = MURMUR3_PATH_ROWS
    bytes_ms = n * MURMUR3_BYTES_PER_ROW / HBM_BYTES_PER_S * 1e3
    ops_ms = n * MURMUR3_OPS_PER_ROW / FP32_OPS_PER_S * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    print(f"murmur3_int32 n={n}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms,"
          f" bound {bound_ms:.4f} ms ({'bytes' if bytes_ms >= ops_ms else 'operations'}"
          f"; {bound_ms / ms:.1%} of it)")
    return {"name": "murmur3_int32", "route": "cuda",
            "source": "spark_rapids_tpu_torch/csrc/murmur3.cu",
            "replaces": "spark_rapids_tpu/kernels/murmur3.py:46",
            "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": None}


# ---------------------------------------------------------------------------
# window_match substring-search kernel
# ---------------------------------------------------------------------------

#: the Q16 part stage searches each slice's p_type column, at its capacity
#: (2^22 rows) and the scan width (64 bytes), for 'MEDIUM POLISHED'
SEARCH_PATH_ROWS = 1 << 22
SEARCH_PATH_MAX_LEN = 64
SEARCH_PATH_PATTERN = b"MEDIUM POLISHED"


def search_bound_ms(n: int, max_len: int, k: int) -> tuple:
    """(bound ms, "bytes" or "operations") of one match matrix: each row
    reads max_len bytes and a 4-byte length and writes max_len bytes; the
    work is n * max_len windows of k byte compares."""
    bytes_ms = n * (2 * max_len + 4) / HBM_BYTES_PER_S * 1e3
    ops_ms = n * max_len * k / FP32_OPS_PER_S * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms
                                   else "operations")


def search_rows(n: int, max_len: int, rng):
    """(data, lengths) on the host for the mismatch check: a third real
    p_type values cut to max_len bytes, a third drawn from {'A', 0xC3} (a
    byte >= 0x80) at random lengths, a third 0xC3 repeated, zero past each
    length."""
    import numpy as np
    from spark_rapids_tpu_torch import entry
    types = np.zeros((len(entry.P_TYPES), max_len), np.uint8)
    type_len = np.zeros(len(entry.P_TYPES), np.int32)
    for i, v in enumerate(entry.P_TYPES):
        b = v.encode()[:max_len]
        types[i, :len(b)] = np.frombuffer(b, np.uint8)
        type_len[i] = len(b)
    group = rng.integers(0, 3, n)
    codes = rng.integers(0, len(entry.P_TYPES), n)
    alphabet = np.array([0x41, 0xC3], np.uint8)
    drawn = alphabet[rng.integers(0, 2, (n, max_len), dtype=np.uint8)]
    data = np.where((group == 0)[:, None], types[codes],
                    np.where((group == 1)[:, None], drawn, np.uint8(0xC3)))
    lengths = np.where(group == 0, type_len[codes],
                       rng.integers(0, max_len + 1, n)).astype(np.int32)
    data[np.arange(max_len)[None, :] >= lengths[:, None]] = 0
    return data, lengths


def part_slice(dev):
    """One slice of the Q16 part stage's input as its scan uploads it: an
    eighth of the SF100 part rows at capacity 2^22, strings at the scan
    width. The kernel checks run on it at the shapes the path gives."""
    from spark_rapids_tpu_torch import entry
    from spark_rapids_tpu_torch.batch import from_arrow
    rows = -(-SF100_PART_ROWS // Q16_SLICES)
    batch, _ = from_arrow(entry.part_table(rows, PART_SEED),
                          string_max_len=entry.STRING_MAX_LEN, device=dev)
    if batch.capacity != SEARCH_PATH_ROWS:
        raise AssertionError(f"a part slice of {rows} rows has capacity "
                             f"{batch.capacity}, not {SEARCH_PATH_ROWS}")
    return batch


def search_pattern(k: int) -> bytes:
    return (SEARCH_PATH_PATTERN if k <= len(SEARCH_PATH_PATTERN)
            else b"\xc3" * k)[:k]


def check_window_match(dev, part) -> dict:
    """The kernel against its plain version at every (n, max_len, k), on a
    view that is not 16-byte aligned, and on the real p_type column of
    ``part`` (one scanned slice of the Q16 part stage); then both timed on
    that column, at the path's pattern length and at k = 5."""
    import numpy as np
    import torch
    from spark_rapids_tpu_torch.kernels.string_search import (
        window_match, window_match_plain)
    rng = np.random.default_rng(12)
    ptype = part.columns[1]

    def cases():
        """(label, data, lengths) on the device, made one at a time."""
        for n in (SEARCH_PATH_ROWS, 1_000_003, 1):
            for ml in (SEARCH_PATH_MAX_LEN, 25, 10):
                host, host_len = search_rows(n, ml, rng)
                yield (f"n={n} max_len={ml}", torch.from_numpy(host).to(dev),
                       torch.from_numpy(host_len).to(dev))
        # a contiguous view one 25-byte row in, not 16-byte aligned: the
        # wrapper copies it before the launch
        host, host_len = search_rows(1_000_004, 25, rng)
        yield ("n=1000003 max_len=25 view one row in",
               torch.from_numpy(host).to(dev)[1:],
               torch.from_numpy(host_len).to(dev)[1:])
        yield (f"n={ptype.capacity} max_len={ptype.data.shape[1]} p_type "
               f"slice", ptype.data, ptype.lengths)

    worst = 0
    for label, data, lengths in cases():
        ml = data.shape[1]
        for k in sorted({1, 5, 15, ml}):
            if k > ml:
                continue
            pat = search_pattern(k)
            got = window_match(data, lengths, pat)
            ref = window_match_plain(data, lengths, pat)
            torch.cuda.synchronize()
            bad = int((got != ref).sum())
            print(f"window_match {label} k={k}: {int(ref.sum())} matches, "
                  f"{bad} mismatches")
            if bad:
                raise AssertionError(f"window_match disagrees with its "
                                     f"plain version at {label} k={k}")
            worst = max(worst, bad)
    # timed at the path's shape on the rows the path gives the kernel
    data, lengths = ptype.data, ptype.lengths
    timed = {}
    for k in (5, len(SEARCH_PATH_PATTERN)):
        pat = search_pattern(k)
        timed[k] = (
            time_cuda_ms(lambda: window_match(data, lengths, pat), 50),
            time_cuda_ms(lambda: window_match_plain(data, lengths, pat), 5))
    n, ml = data.shape
    for k, (ms, plain_ms) in sorted(timed.items()):
        bound_ms, by = search_bound_ms(n, ml, k)
        print(f"window_match p_type slice n={n} max_len={ml} k={k}: "
              f"kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({by}; "
              f"{bound_ms / ms:.1%} of it)")
    k = len(SEARCH_PATH_PATTERN)
    ms, plain_ms = timed[k]
    bound_ms, by = search_bound_ms(n, ml, k)
    return {"name": "window_match", "route": "cuda",
            "source": "spark_rapids_tpu_torch/csrc/string_search.cu",
            "replaces": "spark_rapids_tpu/kernels/string_search.py:51",
            "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": by, "library_ms": None}


# ---------------------------------------------------------------------------
# Hash join: the card against the CPU
# ---------------------------------------------------------------------------

#: stream and build rows of the join check
JOIN_STREAM_ROWS = 1 << 17
JOIN_BUILD_ROWS = 1 << 15
JOIN_SLICES = 4
JOIN_PARTITIONS = 8


def join_tables(keys: str):
    """(stream, build, stream keys, build keys) of the join check, from a
    numpy seed, with about a twentieth of the keys null:

    - ``exact``: an int64 key with duplicates on both sides, half the
      stream keys missing from the build, and the int64 minimum and maximum
      on both sides;
    - ``dense``: a unique contiguous int64 build key starting at -2^40
      (the dense probe) and, past it, build rows with a null key; stream
      keys in and around it;
    - ``hashed``: an (int32, string) key pair, the strings p_type values at
      the scan width."""
    import numpy as np
    import pyarrow as pa
    from spark_rapids_tpu_torch import entry
    rng = np.random.default_rng(13)
    ns, nb = JOIN_STREAM_ROWS, JOIN_BUILD_ROWS

    def nulls(values, typ):
        return pa.array(values, typ, mask=rng.random(len(values)) < 0.05)

    payload = {"v": rng.integers(-10**6, 10**6, ns),
               "x": rng.uniform(-1e3, 1e3, ns)}
    if keys == "hashed":
        ptypes = pa.array(entry.P_TYPES)
        stream = pa.table({
            "a": nulls(rng.integers(0, 1200, ns).astype(np.int32),
                       pa.int32()),
            "s": ptypes.take(pa.array(rng.integers(0, len(entry.P_TYPES),
                                                   ns))), **payload})
        build = pa.table({
            "ba": nulls(rng.integers(0, 1000, nb).astype(np.int32),
                        pa.int32()),
            "bs": ptypes.take(pa.array(rng.integers(0, len(entry.P_TYPES),
                                                    nb))),
            "w": rng.uniform(0, 1, nb)})
        return stream, build, ["a", "s"], ["ba", "bs"]
    if keys == "dense":
        first = -(1 << 40)
        n_null = nb // 20
        bk = np.concatenate([first + rng.permutation(nb).astype(np.int64),
                             np.zeros(n_null, np.int64)])
        build = pa.table({"bk": pa.array(bk, pa.int64(),
                                         mask=np.arange(nb + n_null) >= nb),
                          "w": rng.uniform(0, 1, nb + n_null)})
        sk = first + rng.integers(-nb // 4, nb + nb // 4, ns)
        stream = pa.table({"k": nulls(sk, pa.int64()), **payload})
        return stream, build, ["k"], ["bk"]
    else:
        bk = rng.integers(0, nb, nb).astype(np.int64)
        sk = rng.integers(0, 2 * nb, ns).astype(np.int64)
        lo, hi = np.iinfo(np.int64).min, np.iinfo(np.int64).max
        bk[:4], sk[:6] = [lo, hi, hi, lo], [lo, hi, lo, hi, 0, hi - 1]
    stream = pa.table({"k": nulls(sk, pa.int64()), **payload})
    build = pa.table({"bk": nulls(bk, pa.int64()),
                      "w": rng.uniform(0, 1, nb)})
    return stream, build, ["k"], ["bk"]


def join_plan(stream, build, lk, rk, how, broadcast, dev):
    from spark_rapids_tpu_torch import entry
    from spark_rapids_tpu_torch.exec import HashJoinExec
    from spark_rapids_tpu_torch.expressions import col
    from spark_rapids_tpu_torch.shuffle import (BroadcastExchangeExec,
                                                HashPartitioning,
                                                ShuffleExchangeExec)
    ls = entry._scan(stream, JOIN_SLICES, dev)
    rs = entry._scan(build, JOIN_SLICES, dev)
    lkeys, rkeys = [col(k) for k in lk], [col(k) for k in rk]
    if broadcast:
        return HashJoinExec(lkeys, rkeys, how, ls, BroadcastExchangeExec(rs))
    return HashJoinExec(
        lkeys, rkeys, how,
        ShuffleExchangeExec(HashPartitioning(lkeys, JOIN_PARTITIONS), ls),
        ShuffleExchangeExec(HashPartitioning(rkeys, JOIN_PARTITIONS), rs),
        broadcast_build=False)


def differing_rows(got, want) -> int:
    """Rows that differ between two tables once both are sorted on every
    column (nulls equal to nulls); a row-count difference counts whole."""
    import pyarrow.compute as pc
    if got.num_rows != want.num_rows:
        return abs(got.num_rows - want.num_rows) + min(got.num_rows,
                                                       want.num_rows)
    order = [(c, "ascending") for c in got.column_names]
    a, b = got.sort_by(order), want.sort_by(order)
    differ = None
    for x, y in zip(a.columns, b.columns):
        same = pc.or_kleene(pc.fill_null(pc.equal(x, y), False),
                            pc.and_(pc.is_null(x), pc.is_null(y)))
        d = pc.invert(same)
        differ = d if differ is None else pc.or_(differ, d)
    return int(pc.sum(differ).as_py() or 0)


def check_joins(dev) -> None:
    """Every join type, each key shape, broadcast and co-partitioned: the
    join on the card against the same join on the CPU, 0 rows apart. The
    broadcast build must be dense for the dense key shape only."""
    import torch
    from spark_rapids_tpu_torch.exec import JoinType, collect
    from spark_rapids_tpu_torch.exec.common import concat_all
    t0 = time.perf_counter()
    for keys in ("exact", "dense", "hashed"):
        stream, build, lk, rk = join_tables(keys)
        plan = join_plan(stream, build, lk, rk, JoinType.INNER, True, dev)
        try:
            table, _ = plan._build_kernel(concat_all(
                list(plan.right.execute_partition(0)),
                plan.right.output_schema, dev))
        finally:
            plan.close()        # the broadcast relation leaves the catalog
        dense = table.dense is not None and bool(table.dense)
        print(f"join {keys}: broadcast build dense {dense}")
        if dense != (keys == "dense"):
            raise AssertionError(f"the {keys} build's dense flag is "
                                 f"{dense}")
        for how in JoinType:
            if how is JoinType.CROSS:
                continue
            for broadcast in (True, False):
                got = collect(join_plan(stream, build, lk, rk, how,
                                        broadcast, dev))
                torch.cuda.synchronize(dev)
                want = collect(join_plan(stream, build, lk, rk, how,
                                         broadcast, "cpu"))
                bad = differing_rows(got, want)
                mode = "broadcast" if broadcast else "co-partitioned"
                print(f"join {keys} {how.name} {mode}: {got.num_rows} rows "
                      f"on the card, {bad} differing from the CPU")
                if bad:
                    raise AssertionError(
                        f"the {keys} {how.name} {mode} join differs between "
                        f"the card and the CPU in {bad} rows")
    print(f"join check: {time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------------
# Q1 end to end
# ---------------------------------------------------------------------------

def check_q1_result(got, expected) -> float:
    """Keys, counts and integer sums exact; floats within FLOAT_REL_TOL.
    Returns the largest relative float error."""
    import numpy as np
    import pyarrow as pa
    if got.column_names != expected.column_names:
        raise AssertionError(f"columns {got.column_names} != "
                             f"{expected.column_names}")
    if got.num_rows != expected.num_rows:
        raise AssertionError(f"{got.num_rows} rows != {expected.num_rows}")
    worst = 0.0
    for name in got.column_names:
        a = got.column(name).to_numpy()
        e = expected.column(name).to_numpy()
        if pa.types.is_floating(expected.schema.field(name).type):
            rel = np.abs(a - e) / np.maximum(np.abs(e), 1e-300)
            worst = max(worst, float(rel.max(initial=0.0)))
            if not np.all(rel <= FLOAT_REL_TOL):
                raise AssertionError(f"{name}: {a} !~ {e}")
        elif not np.array_equal(a, e):
            raise AssertionError(f"{name}: {a} != {e}")
    return worst


def check_q16_part_result(got, expected) -> None:
    """Every group, count and row position exact."""
    if got.num_rows != Q16_GROUPS:
        raise AssertionError(f"{got.num_rows} groups, not {Q16_GROUPS}")
    if not got.equals(expected):
        raise AssertionError("the Q16 part stage differs from the pyarrow "
                             "oracle")


def run_path(name: str, make_table, reference, run, check, dev, counted,
             rows_of=lambda table: table.num_rows,
             stats: dict = None, warm_runs: int = 1) -> dict:
    """One path end to end: make its data and its oracle's answer, run it
    cold with every kernel's launch count set to 0 just before, check it and
    read the counts, then ``warm_runs`` warm runs. ``rows_of`` gives the
    input rows that rows/s counts; ``stats``, where given, gets the cold
    and warm seconds and the allocator's peak. Returns the launches per
    kernel of the cold run; fails if a kernel of the path was not
    launched."""
    import torch
    t0 = time.perf_counter()
    table = make_table()
    rows = rows_of(table)
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    expected = reference(table)
    oracle_s = time.perf_counter() - t0
    print(f"{name}: {rows} rows made in {gen_s:.2f} s; pyarrow oracle "
          f"{oracle_s:.2f} s")

    torch.cuda.reset_peak_memory_stats(dev)
    for wrapper in counted:
        wrapper.launches = 0
    t0 = time.perf_counter()
    got = run(table)
    torch.cuda.synchronize(dev)
    cold_s = time.perf_counter() - t0
    launches = {w.__name__: w.launches for w in counted}
    detail = check(got, expected)
    print(f"{name}: matches the pyarrow oracle ({got.num_rows} rows"
          f"{detail or ''})")
    print(f"{name}: kernel launches in the run: {launches}")
    for kernel, n in launches.items():
        if n <= 0:
            raise AssertionError(f"{kernel} was not launched by the {name} "
                                 f"run")

    warm = []
    for _ in range(warm_runs):
        t0 = time.perf_counter()
        again = run(table)
        torch.cuda.synchronize(dev)
        warm.append(time.perf_counter() - t0)
        check(again, expected)
    peak = torch.cuda.max_memory_allocated(dev)
    if warm:
        warm_s = statistics.median(warm)
        print(f"{name}: cold {cold_s:.3f} s, warm median {warm_s:.3f} s of "
              f"{[round(w, 4) for w in warm]}, {rows / warm_s:,.0f} rows/s;"
              f" device memory peak {peak / 2**30:.2f} GiB")
    else:
        # no warm run here: the caller's profiled run gives the warm wall
        warm_s = cold_s
        print(f"{name}: cold {cold_s:.3f} s, {rows / cold_s:,.0f} rows/s "
              f"cold; device memory peak {peak / 2**30:.2f} GiB")
    if stats is not None:
        stats.update(cold_s=cold_s, warm_s=warm_s, peak=peak, rows=rows)
    return launches


def run_adaptive(name: str, tables, expected, make_plan, check, dev,
                 counted, off: dict, rows_of) -> dict:
    """A path again over the same tables with AQE on (``make_plan()`` builds
    its tree): ``run_path``'s checks, then the decisions of its cold run
    and its warm wall and peak beside the AQE-off run's (``off``).
    ``check(got, expected, state)`` returns the detail to print; ``state``
    holds the run's ``plan`` and the retry metrics before it, ``retry0``."""
    from spark_rapids_tpu_torch import adaptive
    from spark_rapids_tpu_torch.exec import collect
    from spark_rapids_tpu_torch.memory.retry import metrics
    state, stats = {}, {}

    def run(_):
        state.pop("plan", None)
        mark = adaptive.reason_mark()
        state["retry0"] = metrics().snapshot()
        state["plan"] = make_plan()
        out = collect(state["plan"])
        state.setdefault("decisions", adaptive.reasons(since=mark))
        return out

    launches = run_path(f"{name} aqe", lambda: tables, lambda _: expected,
                        run, lambda got, exp: check(got, exp, state),
                        dev, counted, rows_of=rows_of, stats=stats)
    print(f"{name} aqe: decisions of the cold run: {state['decisions']}")
    print(f"{name} aqe: warm median {stats['warm_s']:.3f} s against "
          f"{off['warm_s']:.3f} s with AQE off "
          f"({stats['warm_s'] / off['warm_s']:.2f}x); peak "
          f"{stats['peak'] / 2**30:.2f} GiB against "
          f"{off['peak'] / 2**30:.2f} GiB")
    if not state["decisions"]:
        raise AssertionError(f"{name} with AQE on decided nothing")
    state.clear()
    return launches


def run_q1_phase(args, dev, counted) -> dict:
    from spark_rapids_tpu_torch import entry

    def check(got, expected):
        worst = check_q1_result(got, expected)
        return (f"; keys, counts and int sums exact; float max rel err "
                f"{worst:.3g} <= {FLOAT_REL_TOL}")

    print(f"q1: {Q1_SLICES} slices, {Q1_SHUFFLE_PARTITIONS} shuffle "
          f"partitions")
    return run_path(
        "q1", lambda: entry.lineitem_table(args.rows, DATA_SEED),
        entry.q1_reference,
        lambda t: entry.run_q1(t, Q1_SLICES, Q1_SHUFFLE_PARTITIONS,
                               device=dev), check, dev, counted)


def run_q16_part_phase(dev, counted) -> dict:
    from spark_rapids_tpu_torch import entry
    print(f"q16 part stage: {Q16_SLICES} slices, {Q16_SHUFFLE_PARTITIONS} "
          f"shuffle partitions, strings at {entry.STRING_MAX_LEN} bytes")
    launches = run_path(
        "q16_part", lambda: entry.part_table(SF100_PART_ROWS, PART_SEED),
        entry.q16_part_reference,
        lambda t: entry.run_q16_part(t, Q16_SLICES, Q16_SHUFFLE_PARTITIONS,
                                     device=dev),
        check_q16_part_result, dev, counted)
    if launches["window_match"] != Q16_SLICES:
        raise AssertionError(f"window_match launched "
                             f"{launches['window_match']} times, not once "
                             f"per slice ({Q16_SLICES})")
    return launches


def check_q3_result(got, expected) -> float:
    """Keys exact and in order, revenue within FLOAT_REL_TOL. Returns the
    largest relative revenue error."""
    import numpy as np
    if got.column_names != expected.column_names:
        raise AssertionError(f"columns {got.column_names} != "
                             f"{expected.column_names}")
    if got.num_rows != expected.num_rows:
        raise AssertionError(f"{got.num_rows} rows != {expected.num_rows}")
    for name in ("l_orderkey", "o_orderdate", "o_shippriority"):
        if got.column(name).to_pylist() != expected.column(name).to_pylist():
            raise AssertionError(f"{name}: {got.column(name)} != "
                                 f"{expected.column(name)}")
    a = got.column("revenue").to_numpy()
    e = expected.column("revenue").to_numpy()
    rel = np.abs(a - e) / np.abs(e)
    if not np.all(rel <= FLOAT_REL_TOL):
        raise AssertionError(f"revenue: {a} !~ {e}")
    return float(rel.max(initial=0.0))


def _children(plan) -> list:
    """An operator's children, and the device children a CPU fallback
    island keeps."""
    return list(plan.children) + list(getattr(plan, "child_execs", ()))


def _execs(plan, name: str) -> list:
    found = [plan] if plan.name == name else []
    for c in _children(plan):
        found += _execs(c, name)
    return found


def run_q3_phase(dev, counted) -> dict:
    from spark_rapids_tpu_torch import entry
    from spark_rapids_tpu_torch.exec import collect
    state = {}

    def reference(tables):
        groups = entry.q3_groups_reference(*tables)
        state["groups"] = groups.num_rows
        return entry.q3_top(groups)

    def run(tables):
        state["plan"] = entry.q3_plan(*tables, Q3_SLICES,
                                      Q3_SHUFFLE_PARTITIONS, device=dev)
        return collect(state["plan"])

    def check(got, expected):
        worst = check_q3_result(got, expected)
        plan = state["plan"]
        # depth first: the lineitem, orders and customer filters
        rows = [f.metrics["numOutputRows"].total()
                for f in _execs(plan, "FilterExec")]
        outer, inner = [j.metrics["numOutputRows"].total()
                        for j in _execs(plan, "HashJoinExec")]
        groups = _execs(plan, "HashAggregateExec")[0].metrics[
            "numOutputRows"].total()
        if groups != state["groups"]:
            raise AssertionError(f"{groups} groups, pyarrow has "
                                 f"{state['groups']}")
        return (f"; keys exact, revenue max rel err {worst:.3g} <= "
                f"{FLOAT_REL_TOL}; rows passing the lineitem, orders and "
                f"customer filters {rows[0]}, {rows[1]}, {rows[2]}; orders "
                f"joined to customers {inner}; lineitem rows joined {outer};"
                f" groups {groups}, as pyarrow")

    print(f"q3: SF{Q3_SF}, {Q3_SLICES} slices, {Q3_SHUFFLE_PARTITIONS} "
          f"shuffle partitions, both joins shuffled")

    def make_tables():
        state["tables"] = entry.tpch_q3_tables(Q3_SF, Q3_SEED)
        return state["tables"]

    def reference_kept(tables):
        state["expected"] = reference(tables)
        return state["expected"]

    off = {}
    launches = [run_path("q3", make_tables, reference_kept, run, check, dev,
                         counted, rows_of=lambda t: t[2].num_rows,
                         stats=off)]
    state.pop("plan", None)
    tables = state["tables"]

    def check_aqe(got, expected, _state):
        worst = check_q3_result(got, expected)
        return f"; keys exact, revenue max rel err {worst:.3g}"

    from spark_rapids_tpu_torch import config
    print(f"q3 aqe: the JAX Session's default adaptive conf (targetRows "
          f"{config.ADAPTIVE_TARGET_ROWS.default}, splitRows "
          f"{config.SKEW_SPLIT_ROWS.default}, broadcastJoin.maxBuildRows "
          f"{config.ADAPTIVE_BROADCAST_MAX_BUILD_ROWS.default})")
    launches.append(run_adaptive(
        "q3", tables, state["expected"],
        lambda: entry.q3_plan(*tables, Q3_SLICES, Q3_SHUFFLE_PARTITIONS,
                              device=dev, adaptive=True),
        check_aqe, dev, counted, off, lambda t: t[2].num_rows))
    for aqe in (False, True):
        check_murmur3_at_exchanges(
            f"q3{' aqe' if aqe else ''}",
            entry.q3_plan(*tables, Q3_SLICES, Q3_SHUFFLE_PARTITIONS,
                          device=dev, adaptive=aqe), dev)
    state.clear()
    return launches, tables


# ---------------------------------------------------------------------------
# Q18 end to end, through the memory runtime
# ---------------------------------------------------------------------------

def measure_spill_rates(dev) -> None:
    """Device-to-host and host-to-device rates of the catalog's spill copy
    (``HostTable.pack`` into pinned memory, ``to_device`` back) over eight
    lineitem exchange pieces of the Q18 shape (int64 and float64 at 2^22
    rows, 75.5 MB each), against the PCIe Gen5 x16 bound. The first pack
    allocates its pinned buffers; the second reuses them from torch's
    caching host allocator."""
    import torch
    from spark_rapids_tpu_torch import batch as tb
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.shuffle.serializer import HostTable
    cap = 1 << 22
    schema = tb.Schema([tb.Field("l_orderkey", T.INT64),
                        tb.Field("l_quantity", T.FLOAT64)])
    pieces = [tb.ColumnarBatch(
        (tb.DeviceColumn(torch.arange(cap, device=dev), torch.ones(
            cap, dtype=torch.bool, device=dev), T.INT64),
         tb.DeviceColumn(torch.rand(cap, dtype=torch.float64, device=dev),
                         torch.ones(cap, dtype=torch.bool, device=dev),
                         T.FLOAT64)), tb.rows_scalar(cap, dev))
        for _ in range(8)]
    nbytes = sum(p.size_bytes() for p in pieces)
    for label in ("first (fresh pinned buffers)", "second (cached)"):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        tables = [HostTable.pack(p) for p in pieces]
        for t in tables:
            t.wait()
        d2h = time.perf_counter() - t0
        t0 = time.perf_counter()
        back = [t.to_device(schema, dev) for t in tables]
        torch.cuda.synchronize(dev)
        h2d = time.perf_counter() - t0
        same = all(bool((a.columns[1].data == b.columns[1].data).all())
                   for a, b in zip(pieces, back))
        if not same:
            raise AssertionError("a spilled batch came back changed")
        print(f"spill copy, {label}: {nbytes / 2**20:.1f} MiB device to "
              f"host {d2h * 1e3:.2f} ms ({nbytes / d2h / 1e9:.2f} GB/s), "
              f"host to device {h2d * 1e3:.2f} ms ({nbytes / h2d / 1e9:.2f}"
              f" GB/s); PCIe Gen5 x16 bound {PCIE_BYTES_PER_S / 1e9:.0f} "
              f"GB/s each way")
        del tables, back


def check_q18_result(got, expected) -> None:
    """Every row and column exact: keys, names, dates, o_totalprice (read,
    not computed) and sum_qty (a sum of whole numbers)."""
    if got.column_names != expected.column_names:
        raise AssertionError(f"columns {got.column_names} != "
                             f"{expected.column_names}")
    if not got.equals(expected):
        raise AssertionError(f"Q18 differs from the pyarrow oracle:\n"
                             f"{got.slice(0, 5)}\n{expected.slice(0, 5)}")


def q18_memory_report(plan, dev, retry0) -> dict:
    """What the memory runtime did in one Q18 run: the catalog's tiers,
    spilled bytes, retry metrics, grace buckets and the allocator's peak.
    Raises on a leak."""
    import torch
    from spark_rapids_tpu_torch.memory.retry import metrics
    cat = plan.catalog
    retry = {k: v - retry0[k] for k, v in metrics().snapshot().items()}
    buckets = sum(j.metrics["graceBuckets"].total()
                  for j in _execs(plan, "HashJoinExec"))
    spill = sum(x.metrics["spillBytes"].total()
                for x in _execs(plan, "ShuffleExchangeExec"))
    leaks = cat.leak_check()
    print("q18: catalog after the run:\n" + cat.tier_summary())
    print(f"q18: spilled_to_host {cat.spilled_to_host} B, spilled_to_disk "
          f"{cat.spilled_to_disk} B, brought back {cat.unspilled} B; "
          f"exchanges' spillBytes {spill} B; retry metrics {retry}; grace "
          f"buckets {buckets}; device budget {cat.device_limit} B; "
          f"allocator peak {torch.cuda.max_memory_allocated(dev)} B, now "
          f"{torch.cuda.memory_allocated(dev)} B")
    if leaks or cat.total_pinned():
        raise AssertionError(f"the catalog leaks after Q18: {leaks}")
    return {"spilled": cat.spilled_to_host + cat.spilled_to_disk,
            "buckets": buckets, "retry": retry}


def check_murmur3_at_exchanges(what: str, plan, dev) -> list:
    """murmur3 against its plain version, bit for bit, at the shapes a
    path gives it: for each hash exchange of a fresh, unrun ``plan`` with
    a key the kernel hashes (an exchange reads its child's exchanges once,
    so a path whose hashed exchanges nest checks its launches in a run
    instead, ``murmur3_checked``), the exchange's child runs
    over each of its partitions, and on each output batch the kernel and
    its plain version hash that key's int32 words seeded by the running
    hash of the keys before it (seed 42), as the exchange does. Closes the
    plan. Returns (key, capacity, max_abs_err) per comparison; raises on a
    difference or when no key reached the kernel."""
    import torch
    from spark_rapids_tpu_torch.expressions.base import raw_eval
    from spark_rapids_tpu_torch.expressions.hashing import (
        DEFAULT_SEED, INT32_HASHED_KINDS, hash_column, int32_words)
    from spark_rapids_tpu_torch.kernels.murmur3 import (murmur3_int32,
                                                        murmur3_int32_plain)
    from spark_rapids_tpu_torch.shuffle import HashPartitioning
    compared = []
    try:
        hashed = [x for x in _execs(plan, "ShuffleExchangeExec")
                  if isinstance(x.partitioning, HashPartitioning) and any(
                      e.dtype.kind in INT32_HASHED_KINDS
                      for e in x.partitioning.exprs)]
        for exchange in hashed:
            part = exchange.partitioning
            child = exchange.child
            for p in range(child.num_partitions):
                for batch in child.execute_partition(p):
                    seed = torch.full((batch.capacity,), DEFAULT_SEED,
                                      dtype=torch.int32, device=dev)
                    for e in part.exprs:
                        c = raw_eval(e, batch)
                        if c.dtype.kind in INT32_HASHED_KINDS:
                            args = (int32_words(c), c.validity.contiguous(),
                                    seed)
                            err = int((murmur3_int32(*args).long()
                                       - murmur3_int32_plain(*args).long())
                                      .abs().max())
                            compared.append((str(e), batch.capacity, err))
                        seed = hash_column(c, seed)
    finally:
        plan.close()
    shapes = {}
    for key, cap, err in compared:
        n, worst = shapes.get((key, cap), (0, 0))
        shapes[(key, cap)] = (n + 1, max(worst, err))
    print(f"murmur3_int32 against its plain version at {what}'s hash "
          f"exchanges, (key, capacity): (batches, max_abs_err) {shapes}")
    if not compared:
        raise AssertionError(f"{what}: no hash exchange key reached "
                             f"murmur3_int32")
    if any(err for _, _, err in compared):
        raise AssertionError(f"murmur3_int32 disagrees with its plain "
                             f"version at {what}'s exchanges")
    return compared


def run_q18_phase(dev, counted, keep: dict) -> dict:
    """Q18 at SF10 over 2 partitions under a 1 GiB budget: equal to the
    pyarrow oracle, and it must spill, run the grace join in at least 2
    buckets, launch murmur3 and leave the catalog empty; then again with
    AQE on. Then murmur3 against its plain version at the shapes of both
    trees' exchanges. ``keep`` gets the tables and the oracle's rows
    (``tables``, ``expected``), which the decimal phase reuses."""
    from spark_rapids_tpu_torch import entry
    from spark_rapids_tpu_torch.exec import collect
    from spark_rapids_tpu_torch.memory.retry import metrics
    state = {}

    def reference(tables):
        groups = entry.q18_groups_reference(*tables)
        state["groups"] = groups.num_rows
        return entry.q18_top(groups)

    def run(tables):
        state.pop("plan", None)
        state["retry0"] = metrics().snapshot()
        state["plan"] = entry.q18_plan(*tables, Q18_SLICES,
                                       Q18_SHUFFLE_PARTITIONS,
                                       device_limit=Q18_BUDGET, device=dev)
        return collect(state["plan"])

    def check(got, expected):
        check_q18_result(got, expected)
        plan = state["plan"]
        groups = _execs(plan, "HashAggregateExec")[0].metrics[
            "numOutputRows"].total()
        if groups != state["groups"]:
            raise AssertionError(f"{groups} qualifying orders, pyarrow has "
                                 f"{state['groups']}")
        report = q18_memory_report(plan, dev, state["retry0"])
        if report["spilled"] <= 0:
            raise AssertionError("Q18 under a 1 GiB budget spilled nothing")
        if report["buckets"] < 2:
            raise AssertionError(f"the grace join ran {report['buckets']} "
                                 f"buckets, not at least 2")
        return (f"; every column exact; {groups} qualifying orders, as "
                f"pyarrow; spilled {report['spilled']} B; grace buckets "
                f"{report['buckets']}")

    print(f"q18: SF{Q18_SF}, {Q18_SLICES} slices, {Q18_SHUFFLE_PARTITIONS} "
          f"shuffle partitions, every join shuffled, device budget "
          f"{Q18_BUDGET} B")
    def make_tables():
        state["tables"] = entry.tpch_q18_tables(Q18_SF, Q18_SEED)
        return state["tables"]

    def reference_kept(tables):
        state["expected"] = reference(tables)
        return state["expected"]

    off = {}
    launches = [run_path("q18", make_tables, reference_kept, run, check,
                         dev, counted, rows_of=lambda t: t[2].num_rows,
                         stats=off)]
    state.pop("plan", None)
    tables = state["tables"]

    def check_aqe(got, expected, aqe_state):
        check_q18_result(got, expected)
        plan = aqe_state["plan"]
        report = q18_memory_report(plan, dev, aqe_state["retry0"])
        switched = sum(j.metrics["switchBuildBytes"].total()
                       for j in _execs(plan, "HashJoinExec"))
        return (f"; every column exact; spilled {report['spilled']} B; "
                f"grace buckets {report['buckets']}; runtime broadcast "
                f"build held outside the budget: {switched} B; no catalog "
                f"entry left")

    launches.append(run_adaptive(
        "q18", tables, state["expected"],
        lambda: entry.q18_plan(*tables, Q18_SLICES, Q18_SHUFFLE_PARTITIONS,
                               device_limit=Q18_BUDGET, device=dev,
                               adaptive=True),
        check_aqe, dev, counted, off, lambda t: t[2].num_rows))
    for aqe in (False, True):
        check_murmur3_at_exchanges(
            f"q18{' aqe' if aqe else ''}",
            entry.q18_plan(*tables, Q18_SLICES, Q18_SHUFFLE_PARTITIONS,
                           device_limit=Q18_BUDGET, device=dev,
                           adaptive=aqe), dev)
    keep.update(tables=tables, expected=state["expected"])
    state.clear()
    return launches


def run_q18_injection_phase(dev) -> None:
    """Q18 at SF1 clean, then with every third allocation check failing:
    bit for bit the same, with retries recorded and no leak."""
    from spark_rapids_tpu_torch import entry
    from spark_rapids_tpu_torch.exec import collect
    from spark_rapids_tpu_torch.memory.retry import metrics, oom_injection
    tables = entry.tpch_q18_tables(Q18_INJECT_SF, Q18_SEED)
    t0 = time.perf_counter()
    clean = collect(entry.q18_plan(*tables, Q18_SLICES,
                                   Q18_SHUFFLE_PARTITIONS,
                                   device_limit=Q18_BUDGET, device=dev))
    clean_s = time.perf_counter() - t0
    check_q18_result(clean, entry.q18_reference(*tables))
    retry0 = metrics().snapshot()
    t0 = time.perf_counter()
    with oom_injection(Q18_INJECT_MODE) as inj:
        plan = entry.q18_plan(*tables, Q18_SLICES, Q18_SHUFFLE_PARTITIONS,
                              device_limit=Q18_BUDGET, device=dev)
        injected = collect(plan)
        fired = inj.injected
    inj_s = time.perf_counter() - t0
    retry = {k: v - retry0[k] for k, v in metrics().snapshot().items()}
    print(f"q18 injection: SF{Q18_INJECT_SF} under {Q18_INJECT_MODE}: "
          f"{fired} injected OOMs, retry metrics {retry}; clean "
          f"{clean_s:.3f} s, injected {inj_s:.3f} s; {clean.num_rows} rows")
    if not injected.equals(clean):
        raise AssertionError("Q18 under injected OOMs differs from its "
                             "clean run")
    if retry["retryCount"] <= 0 or fired <= 0:
        raise AssertionError("no retry ran under injection")
    if plan.catalog.leak_check() or plan.catalog.total_pinned():
        raise AssertionError(f"the catalog leaks after the injected run: "
                             f"{plan.catalog.leak_check()}")


# ---------------------------------------------------------------------------
# Out-of-core operators: the card against the CPU
# ---------------------------------------------------------------------------

#: rows of the out-of-core check, its scan batches and budgets: every batch
#: of 2^18 rows is a partial, and a merge pins at most 2^20 rows
OOC_ROWS = 1 << 22
OOC_BATCH_ROWS = 1 << 18
OOC_MAX_RESULT_ROWS = 1 << 20
OOC_SORT_MAX_ROWS = 1 << 20
OOC_BUILD_ROWS = 1 << 20
OOC_MAX_BUILD_ROWS = 1 << 18


def ooc_plans(dev):
    """(name, plan maker, metric name, operator name) of each out-of-core
    check, over integer data from a numpy seed, so the card and the CPU
    must agree exactly: the aggregate over 16 scan batches with 1,000
    groups (windowed merge passes) and with ~2M groups (the sort-based
    merge), the global sort over 2^20 rows (the out-of-core sorter), and
    the grace join of 4M stream rows with a 1M-row build in 4 buckets."""
    import numpy as np
    import pyarrow as pa
    from spark_rapids_tpu_torch.exec import (AggregateMode, HashAggregateExec,
                                             HashJoinExec, InMemoryScanExec,
                                             JoinType, SortExec, asc, desc)
    from spark_rapids_tpu_torch.expressions import col
    from spark_rapids_tpu_torch.expressions.aggregates import Count, Sum
    from spark_rapids_tpu_torch.shuffle import (HashPartitioning,
                                                ShuffleExchangeExec)
    rng = np.random.default_rng(21)
    n = OOC_ROWS
    v = pa.array(rng.integers(-10**6, 10**6, n),
                 mask=rng.random(n) < 0.02)
    few = pa.table({"k": rng.integers(0, 1000, n), "v": v})
    many = pa.table({"k": rng.integers(0, n // 2, n), "v": v})
    sortable = pa.table({"a": pa.array(rng.integers(0, 1000, n).astype(
        np.int32), mask=rng.random(n) < 0.01), "b": rng.integers(0, 2**40, n),
        "v": v})
    build = pa.table({"bk": rng.integers(0, OOC_BUILD_ROWS, OOC_BUILD_ROWS),
                      "w": rng.integers(0, 100, OOC_BUILD_ROWS)})
    stream = pa.table({"k": rng.integers(0, 2 * OOC_BUILD_ROWS, n), "v": v})

    def scan(t, d, slices=1):
        return InMemoryScanExec(t, batch_rows=OOC_BATCH_ROWS,
                                num_slices=slices, device=d)

    def agg(t):
        return lambda d: HashAggregateExec(
            [col("k")], [Sum(col("v")).alias("s"), Count().alias("c")],
            scan(t, d), AggregateMode.COMPLETE,
            max_result_rows=OOC_MAX_RESULT_ROWS)

    def sort(d):
        return SortExec([asc(col("a")), desc(col("b"))],
                        scan(sortable, d, 2), max_rows=OOC_SORT_MAX_ROWS)

    def join(d):
        return HashJoinExec(
            [col("k")], [col("bk")], JoinType.INNER,
            ShuffleExchangeExec(HashPartitioning([col("k")], 1),
                                scan(stream, d)),
            ShuffleExchangeExec(HashPartitioning([col("bk")], 1),
                                scan(build, d)),
            broadcast_build=False, max_build_rows=OOC_MAX_BUILD_ROWS)

    return [("aggregate, windowed merge", agg(few), "windowedMergePasses",
             "HashAggregateExec"),
            ("aggregate, out-of-core merge", agg(many), "oocMerges",
             "HashAggregateExec"),
            ("global sort, out of core", sort, "oocSorts", "SortExec"),
            ("grace join", join, "graceBuckets", "HashJoinExec")]


def check_out_of_core(dev) -> None:
    """Each out-of-core path on the card and on the CPU, 0 rows apart, and
    its counter above 0 on the card."""
    import torch
    from spark_rapids_tpu_torch.exec import collect
    t_all = time.perf_counter()
    for name, make, metric, op in ooc_plans(dev):
        plan = make(dev)
        t0 = time.perf_counter()
        got = collect(plan)
        torch.cuda.synchronize(dev)
        card_s = time.perf_counter() - t0
        fired = sum(x.metrics[metric].total() for x in _execs(plan, op))
        t0 = time.perf_counter()
        cpu_plan = make("cpu")
        want = collect(cpu_plan)
        cpu_s = time.perf_counter() - t0
        cpu_fired = sum(x.metrics[metric].total()
                        for x in _execs(cpu_plan, op))
        if name.startswith("global sort"):
            bad = 0 if got.equals(want) else differing_rows(got, want) or 1
        else:
            bad = differing_rows(got, want)
        print(f"out of core, {name}: {got.num_rows} rows, {bad} differing "
              f"from the CPU; {metric} {fired} on the card, {cpu_fired} on "
              f"the CPU; card {card_s:.3f} s, CPU {cpu_s:.3f} s")
        if bad:
            raise AssertionError(f"{name} differs between the card and the "
                                 f"CPU in {bad} rows")
        if fired <= 0:
            raise AssertionError(f"{name}: {metric} is 0 on the card")
    print(f"out-of-core check: {time.perf_counter() - t_all:.1f} s")


# ---------------------------------------------------------------------------
# TPC-H Q2 and Q11 end to end, and their kernel at Q2's shape
# ---------------------------------------------------------------------------

#: TPC-H Q2 and Q11: scale factor (20,000,000 part rows, 80,000,000
#: partsupp rows, 1,000,000 suppliers), input slices, shuffle partitions
#: and data seed
Q2_SF = 100
Q2_SLICES = 8
Q2_SHUFFLE_PARTITIONS = 8
Q2_SEED = 2
#: Q2's LIKE '%BRASS' as the filter runs it: endswith, k = 5
Q2_PATTERN = b"BRASS"


def check_window_match_at_q2(dev, part) -> dict:
    """The kernel against its plain version at Q2's own shape: the p_type
    column of one scanned slice of Q2's part table (an eighth of the SF100
    rows, capacity 2^22, 64 bytes), k = 5 as ``endswith 'BRASS'`` runs it,
    the match matrix and the predicate both; then both timed there."""
    import torch
    from spark_rapids_tpu_torch import entry
    from spark_rapids_tpu_torch.batch import from_arrow
    from spark_rapids_tpu_torch.expressions import col, endswith
    from spark_rapids_tpu_torch.kernels.string_search import (
        window_match, window_match_plain)
    rows = -(-part.num_rows // Q2_SLICES)
    first_slice = part.slice(0, rows)
    batch, schema = from_arrow(first_slice,
                               string_max_len=entry.STRING_MAX_LEN,
                               device=dev)
    ptype = batch.columns[schema.index_of("p_type")]
    data, lengths = ptype.data, ptype.lengths
    got = window_match(data, lengths, Q2_PATTERN)
    ref = window_match_plain(data, lengths, Q2_PATTERN)
    # the filter's predicate over the card's batch (the kernel) and over
    # the same slice on the CPU (the plain version)
    pred = endswith(col("p_type"), Q2_PATTERN.decode()).bind(schema)
    kernel_rows = pred.eval(batch).data.cpu()
    cpu_batch, _ = from_arrow(first_slice, schema=schema, device="cpu")
    plain_rows = pred.eval(cpu_batch).data
    torch.cuda.synchronize(dev)
    bad = int((got != ref).sum())
    bad_rows = int((kernel_rows != plain_rows).sum())
    n, ml = data.shape
    print(f"window_match at Q2's shape: p_type slice of {rows} rows, "
          f"capacity {n}, max_len {ml}, k=5 'BRASS': {int(ref.sum())} "
          f"matches, {bad} mismatches in the matrix; endswith keeps "
          f"{int(plain_rows.sum())} rows, {bad_rows} rows apart")
    if bad or bad_rows:
        raise AssertionError("window_match disagrees with its plain version "
                             "at Q2's shape")
    ms = time_cuda_ms(lambda: window_match(data, lengths, Q2_PATTERN), 50)
    plain_ms = time_cuda_ms(
        lambda: window_match_plain(data, lengths, Q2_PATTERN), 5)
    bound_ms, by = search_bound_ms(n, ml, len(Q2_PATTERN))
    print(f"window_match at Q2's shape n={n} max_len={ml} k=5: kernel "
          f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
          f"({by}; {bound_ms / ms:.1%} of it)")
    return {"name": "window_match", "route": "cuda",
            "source": "spark_rapids_tpu_torch/csrc/string_search.cu",
            "replaces": "spark_rapids_tpu/kernels/string_search.py:51",
            "max_abs_err": bad, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": by, "library_ms": None}


def run_q2_phase(dev, counted, tables) -> dict:
    """Q2 at SF100: the 100 rows equal to pyarrow in every column, and
    window_match launched once per part slice."""
    from spark_rapids_tpu_torch import entry

    def check(got, expected):
        if got.num_rows != entry.Q2_LIMIT:
            raise AssertionError(f"Q2 gave {got.num_rows} rows, not "
                                 f"{entry.Q2_LIMIT}")
        if not got.equals(expected):
            raise AssertionError(f"Q2 differs from the pyarrow oracle:\n"
                                 f"{got.slice(0, 3)}\n{expected.slice(0, 3)}")
        return "; all 100 rows equal in every column"

    print(f"q2: SF{Q2_SF}, {Q2_SLICES} slices, {Q2_SHUFFLE_PARTITIONS} "
          f"shuffle partitions, supplier strings at "
          f"{entry.SUPPLIER_STRING_MAX_LEN} bytes; rows/s counts partsupp")
    launches = run_path(
        "q2", lambda: tables, lambda t: entry.q2_reference(*t),
        lambda t: entry.run_q2(*t, Q2_SLICES, Q2_SHUFFLE_PARTITIONS,
                               device=dev), check, dev, counted,
        rows_of=lambda t: t[2].num_rows)
    if launches["window_match"] != Q2_SLICES:
        raise AssertionError(f"window_match launched "
                             f"{launches['window_match']} times in Q2, not "
                             f"once per part slice ({Q2_SLICES})")
    return launches


def check_q11_result(got, expected, margin: float) -> str:
    """The row set exact, value within FLOAT_REL_TOL, in descending
    value order."""
    import numpy as np
    a, e = got.sort_by("ps_partkey"), expected.sort_by("ps_partkey")
    if a.column("ps_partkey").to_pylist() != \
            e.column("ps_partkey").to_pylist():
        raise AssertionError(f"Q11's row set differs from pyarrow's: "
                             f"{a.num_rows} rows against {e.num_rows}")
    va, ve = a.column("value").to_numpy(), e.column("value").to_numpy()
    rel = np.abs(va - ve) / np.abs(ve)
    if not np.all(rel <= FLOAT_REL_TOL):
        raise AssertionError(f"Q11 value off by rel {rel.max()}")
    v = got.column("value").to_numpy()
    if not np.all(v[:-1] >= v[1:]):
        raise AssertionError("Q11 is not in descending value order")
    return (f"; row set exact ({got.num_rows} rows), value max rel err "
            f"{float(rel.max(initial=0.0)):.3g} <= {FLOAT_REL_TOL}; smallest "
            f"relative margin of a group to the threshold {margin:.3e}")


def run_q11_phase(dev, counted, tables) -> dict:
    """Q11 at SF100: the row set of pyarrow's, value within rel 1e-6, and
    the smallest margin of any group to the threshold printed."""
    import numpy as np
    from spark_rapids_tpu_torch import entry
    _, supplier, partsupp, nation, _ = tables
    q11 = (partsupp, supplier, nation)
    fraction = entry.q11_fraction(Q2_SF)
    state = {}

    def reference(t):
        groups, total = entry.q11_groups_reference(*t)
        threshold = total * fraction
        v = groups.column("value").to_numpy()
        state["margin"] = float(np.min(np.abs(v - threshold)) / threshold)
        return entry.q11_reference(*t, fraction)

    print(f"q11: SF{Q2_SF}, NATION {entry.Q11_NATION}, FRACTION "
          f"{fraction:g}, {Q2_SLICES} slices, {Q2_SHUFFLE_PARTITIONS} "
          f"shuffle partitions; rows/s counts partsupp")
    return run_path(
        "q11", lambda: q11, reference,
        lambda t: entry.run_q11(*t, fraction, Q2_SLICES,
                                Q2_SHUFFLE_PARTITIONS, device=dev),
        lambda got, exp: check_q11_result(got, exp, state["margin"]), dev,
        counted, rows_of=lambda t: t[0].num_rows)


# ---------------------------------------------------------------------------
# TPC-H Q16 whole, and the string expressions
# ---------------------------------------------------------------------------

Q16_SF = 100
Q16_SEED = 16
#: Q16's supplier filter: LIKE '%Customer%Complaints%' through the DFA
Q16_LIKE_PATTERN = "%Customer%Complaints%"


def check_like_at_q16(dev, ses, df) -> dict:
    """The Like filter over the Session's scanned supplier batches: on the
    card against the same rows on the CPU over the first batch (cut from
    every batch to make room for the DECIMAL128 phase; the CPU's DFA scan
    of all 1,000,000 comments took most of the phase's checks), the rows
    it keeps over every batch, then its device time per batch on CUDA
    events and its launches per batch (the device records of one profiled
    call). Returns the figures."""
    import torch
    from spark_rapids_tpu_torch.batch import from_arrow, to_arrow
    from spark_rapids_tpu_torch.exec import FilterExec
    _, plan = ses.prepare(df)
    try:
        filt = next(e for e in _walk_plan(plan) if isinstance(e, FilterExec)
                    and "s_comment" in e.child.output_schema.names)
        schema = filt.child.output_schema
        batches = [b for p in range(filt.child.num_partitions)
                   for b in filt.child.execute_partition(p)]
        kept = 0
        for b in batches:
            on_card = filt.condition.eval(b)
            kept += int((on_card.data & on_card.validity).sum())
        first = batches[0]
        on_card = filt.condition.eval(first)
        cpu_batch, _ = from_arrow(to_arrow(first, schema), schema=schema,
                                  device="cpu")
        on_cpu = filt.condition.eval(cpu_batch)
        live = int(first.num_rows)
        bad = int(((on_card.data & on_card.validity).cpu()[:live]
                   != (on_cpu.data & on_cpu.validity)[:live]).sum())
        ms = time_cuda_ms(lambda: filt.condition.eval(first), 5, 2)
        _, _, _, events = profiled(lambda: filt.condition.eval(first), dev,
                                   host=False)
        torch.cuda.synchronize(dev)
    finally:
        plan.close()
    n, ml = first.columns[schema.index_of("s_comment")].data.shape
    out = {"batches": len(batches), "ms_per_batch": ms,
           "launches_per_batch": len(events), "kept": kept, "bad": bad}
    print(f"q16 Like filter: {len(batches)} supplier batches of capacity {n}"
          f", max_len {ml}; keeps {kept} rows, {bad} rows of the first "
          f"batch apart from the CPU; {ms:.3f} ms of device time a batch "
          f"(CUDA events, "
          f"{ms * len(batches):.3f} ms a run), {len(events)} device "
          f"launches a batch")
    if bad:
        raise AssertionError("the Like filter disagrees between the card "
                             "and the CPU")
    return out


def run_q16_phase(dev, counted, tables) -> list:
    """TPC-H Q16 at SF100 through the port's Session (``entry.q16_df``
    under ``entry.session_conf``): equal to ``q16_reference``, nothing
    fallen back, window_match at its k = 15 prefix and murmur3 at the
    exchanges held against their plain versions, the Like filter's device
    time and launches. Then
    the same query over ``dictionary_encode_arrow`` of the same tables
    (``run_q16_dict_leg``). Returns each leg's launches."""
    from spark_rapids_tpu_torch import entry
    from spark_rapids_tpu_torch.plan import Session
    conf = entry.session_conf(Q16_SHUFFLE_PARTITIONS)
    ses = Session(conf, device=dev)
    last, hashed = {}, []

    def run(t):
        # the cold run holds each murmur3 launch against its plain version
        collect = (lambda: ses.collect(entry.q16_df(*t, Q16_SLICES)))
        out = last["rows"] = (collect() if hashed
                              else murmur3_checked(collect, hashed))
        if ses.fell_back():
            raise AssertionError(f"q16 fell back: {ses.fell_back()}")
        return out

    def check(got, expected):
        if not got.equals(expected):
            raise AssertionError(f"Q16 differs from the pyarrow oracle:\n"
                                 f"{got.slice(0, 3)}\n{expected.slice(0, 3)}")
        return (f"; all {got.num_rows} groups equal in every column and "
                f"position")

    part, supplier, partsupp = tables
    print(f"q16: SF{Q16_SF} ({part.num_rows} part, {supplier.num_rows} "
          f"supplier, {partsupp.num_rows} partsupp rows), {Q16_SLICES} "
          f"slices, {Q16_SHUFFLE_PARTITIONS} shuffle partitions, supplier "
          f"strings at {entry.SUPPLIER_STRING_MAX_LEN} bytes; rows/s counts "
          f"partsupp")
    stats, oracle = {}, {}

    def reference(t):
        oracle["rows"] = entry.q16_reference(*t)
        return oracle["rows"]
    launches = run_path(
        "q16", lambda: tables, reference, run, check, dev, counted,
        rows_of=lambda t: t[2].num_rows, stats=stats, warm_runs=1)
    print(f"q16: the Session's operators {ses.executed_exec_names()}")
    # no profiled run (cut to make room for [phase windows]): the walls
    # and the Like filter's device time stand for the path
    df = entry.q16_df(*tables, Q16_SLICES)
    check_window_match_at_session_q16(dev, ses, df)
    like = check_like_at_q16(dev, ses, df)
    report_murmur3("q16", hashed, "p_size at its two aggregate exchanges")
    stats.update(like)
    dict_launches = run_q16_dict_leg(dev, counted, tables, oracle["rows"],
                                     last["rows"], stats)
    return [launches, dict_launches]


def exchange_wire_bytes(ses, df, column: str) -> tuple:
    """``dictenc.dict_wire_bytes`` (encoded, raw) summed over the input
    batches of the plan's first shuffle exchange whose input holds
    ``column`` (the part side of Q16's join: scan, filter, exchange)."""
    from spark_rapids_tpu_torch.dictenc import dict_wire_bytes
    _, plan = ses.prepare(df)
    enc = raw = 0
    try:
        ex = next(x for x in _execs(plan, "ShuffleExchangeExec")
                  if column in x.child.output_schema.names)
        for p in range(ex.child.num_partitions):
            for b in ex.child.execute_partition(p):
                e, r = dict_wire_bytes(b)
                enc, raw = enc + e, raw + r
    finally:
        plan.close()
    return enc, raw


def run_q16_dict_leg(dev, counted, tables, expected, plain_rows,
                     plain) -> dict:
    """Q16 over ``dictionary_encode_arrow`` of the same SF100 tables,
    through a Session under the same conf, the ``dictEncoding.*`` keys at
    their defaults: p_brand (25 values) and p_type (150) stay codes, and
    s_comment, nearly unique, falls back on the cardinality fraction. Its
    rows equal the plain leg's and ``q16_reference``; ``dict_fallbacks()``
    names s_comment alone; murmur3 and window_match launch and are held
    against their plain versions; cold and warm walls and peak beside the
    plain leg's (``plain``: its stats); the wire bytes of the
    part side's exchange input. Returns the cold run's launches."""
    import pyarrow as pa
    from spark_rapids_tpu_torch import entry
    from spark_rapids_tpu_torch.dictenc import dictionary_encode_arrow
    from spark_rapids_tpu_torch.plan import Session
    t0 = time.perf_counter()
    enc = [dictionary_encode_arrow(t) for t in tables]
    coded = [c for t in enc for c in t.column_names
             if pa.types.is_dictionary(t[c].type)]
    print(f"q16 dict: the three tables dictionary-encoded in "
          f"{time.perf_counter() - t0:.2f} s (string columns {coded})")
    ses = Session(entry.session_conf(Q16_SHUFFLE_PARTITIONS), device=dev)
    hashed = []

    def run(t):
        collect = (lambda: ses.collect(entry.q16_df(*t, Q16_SLICES)))
        out = collect() if hashed else murmur3_checked(collect, hashed)
        if ses.fell_back():
            raise AssertionError(f"q16 dict fell back: {ses.fell_back()}")
        return out

    def check(got, want):
        if not (got.equals(want) and got.equals(plain_rows)):
            raise AssertionError(f"Q16 over codes differs from the oracle "
                                 f"or the plain leg:\n{got.slice(0, 3)}\n"
                                 f"{want.slice(0, 3)}")
        return (f"; all {got.num_rows} groups equal to the plain leg and "
                f"the oracle in every column and position")

    stats = {}
    launches = run_path(
        "q16 dict", lambda: enc, lambda _: expected, run, check, dev,
        counted, rows_of=lambda t: t[2].num_rows, stats=stats, warm_runs=1)
    reasons = ses.dict_fallbacks()
    print(f"q16 dict: dict_fallbacks() {reasons}")
    if not reasons or any("'s_comment'" not in r for r in reasons):
        raise AssertionError(f"q16 dict: the fallbacks are not s_comment's "
                             f"alone: {reasons}")
    df = entry.q16_df(*enc, Q16_SLICES)
    check_window_match_at_session_q16(dev, ses, df)
    # p_size, seeded by the per-entry hashes of the dictionary keys
    report_murmur3("q16 dict", hashed, "p_size at its two aggregate "
                   "exchanges, seeded by p_brand's and p_type's entries")
    wire = exchange_wire_bytes(ses, df, "p_type")
    print(f"q16 dict: against the plain leg, cold {stats['cold_s']:.3f} s "
          f"vs {plain['cold_s']:.3f} s, warm {stats['warm_s']:.3f} s vs "
          f"{plain['warm_s']:.3f} s, peak {stats['peak'] / 2**30:.2f} GiB "
          f"vs {plain['peak'] / 2**30:.2f} GiB; wire bytes (encoded, raw) "
          f"of the part side's exchange input {wire}")
    return launches


#: rows of the strings phase's card-against-interpreter check: cut from
#: 2^16 to make room for [phase q18 decimal] and [phase limbs], and to
#: 2^12 for [phase order lines] and [phase json q1]; every expression and
#: edge row stays, only the random rows shrink
STRINGS_ROWS = 1 << 12


def rows_apart(a, b) -> int:
    """Positions where two columns differ (nulls equal to nulls)."""
    import pyarrow.compute as pc
    same = pc.or_kleene(pc.fill_null(pc.equal(a, b), False),
                        pc.and_(pc.is_null(a), pc.is_null(b)))
    return int(pc.sum(pc.invert(same)).as_py() or 0)


def strings_table(supplier, part, n: int):
    """``n`` rows for the string expressions: S_COMMENT (25-100 letters,
    some with 'Customer ... Complaints'), P_TYPE with a twentieth null,
    an int32 in [-5, 300], an int64 over its whole range (INT64_MIN, -1,
    0 and INT64_MAX first) with a twentieth null, and a decimal(12, 4)."""
    import decimal
    import numpy as np
    import pyarrow as pa
    rng = np.random.default_rng(31)
    ptype = part.column("p_type").slice(0, n).combine_chunks()
    wide = rng.integers(-2**63, 2**63 - 1, n, dtype=np.int64, endpoint=True)
    wide[:6] = [-2**63, -1, 0, 2**63 - 1, 1, 36]
    small = rng.random(n) < 0.3
    wide[small] = rng.integers(-10**6, 10**6, small.sum())
    null = rng.random(n) < 0.05
    null[:6] = False
    cents = rng.integers(-10**11, 10**11, n)
    cents[:4] = [5000, -5000, 15000, 25000]     # halves at scale 4 > 2
    return pa.table({
        "c": supplier.column("s_comment").slice(0, n),
        "t": pa.array(ptype.to_pylist(), pa.string(),
                      mask=rng.random(n) < 0.05),
        "n": pa.array(rng.integers(-5, 301, n).astype(np.int32)),
        "i": pa.array(wide, pa.int64(), mask=null),
        "d": pa.array([decimal.Decimal(int(v)).scaleb(-4) for v in cents],
                      pa.decimal128(12, 4)),
    })


def strings_exprs():
    """Every string expression of the port's string slices (each class at
    least once), over ``strings_table``'s columns: hex, bin and conv at
    INT64_MIN, -1, 0 and INT64_MAX, conv to bases 2, 36 and -10, and
    format_number over a decimal whose scale is above d."""
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.entry import CATALOG_CLASSES, COMMENT_EXTRACT
    from spark_rapids_tpu_torch.expressions import (
        Ascii, Bin, Cast, Chr, ConcatWs, Conv, Empty2Null, FindInSet,
        FormatNumber, Hex, InitCap, Levenshtein, Like, OctetLength,
        RegexpExtract, RegexpReplace, Reverse, RLike, Soundex, StringLocate,
        StringPad, StringRepeat, StringReplace, StringTrim, SubstringIndex,
        Translate, col, concat, length, lit, lower, substring, upper)
    c, t, n, i, d = col("c"), col("t"), col("n"), col("i"), col("d")
    digits = Cast(i, T.string(20))
    return [
        length(t), OctetLength(c), OctetLength(t, bits=True), upper(c),
        lower(t), substring(c, 3, 7), substring(t, -5, 3),
        concat(t, lit("/"), substring(c, 1, 6)),
        StringLocate(c, lit("Customer")), StringLocate(t, lit("PLATED")),
        StringTrim(concat(lit("  "), t, lit(" ")), "both"),
        StringTrim(concat(lit("  "), t), "leading"),
        StringTrim(concat(t, lit("   ")), "trailing"),
        StringPad(t, lit(30), lit("*-"), True),
        StringPad(substring(t, 1, 5), n % lit(12), lit("."), False),
        StringRepeat(substring(t, 1, 3), n % lit(5)),
        StringReplace(t, lit("BRASS"), lit("BRONZE")),
        StringReplace(c, lit("a"), lit("")),
        Translate(t, "AEIOU ", "aeiou"), Reverse(t), Ascii(c), Chr(n),
        Levenshtein(substring(t, 1, 8), lit("PROMO BR")), Soundex(c),
        Soundex(t), SubstringIndex(t, lit(" "), lit(2)),
        SubstringIndex(t, lit(" "), lit(-1)),
        Like(c, Q16_LIKE_PATTERN), Like(t, "%POLISHED%"),
        RLike(t, "^(?:SMALL|LARGE) [A-Z]+ (?:TIN|STEEL)$"),
        RLike(c, "[aeiou]{3}"),
        InitCap(t), InitCap(lower(substring(c, 1, 30))),
        FormatNumber(i, 2), FormatNumber(n, 0), FormatNumber(d, 2),
        FormatNumber(d, 6),
        ConcatWs(lit(" | "), (t, substring(c, 1, 5), t)),
        Hex(i), Hex(substring(t, 1, 6)), Bin(i), Bin(n),
        Conv(digits, lit(10), lit(2)), Conv(digits, lit(10), lit(36)),
        Conv(digits, lit(10), lit(-10)), Conv(substring(t, 1, 5), lit(36),
                                              lit(16)),
        FindInSet(RegexpExtract(t, "^([A-Z]+) ", 1), lit(CATALOG_CLASSES)),
        Empty2Null(RegexpExtract(c, COMMENT_EXTRACT, 1)),
        RegexpExtract(t, "^([A-Z]+) ([A-Z]+) ([A-Z]+)$", 3),
        RegexpExtract(c, "([a-z]+)([A-Z]+)", 2),
        RegexpReplace(t, " [A-Z]+$", ""), RegexpReplace(c, "[aeiou][aeiou]+",
                                                        "_"),
        RegexpReplace(substring(c, 1, 12), "x*", "-"),
    ]


def checked_window_match(record):
    """``window_match`` with each launch held against its plain version on
    the same inputs: (pattern length, rows, mismatches) appended to
    ``record``."""
    import torch
    from spark_rapids_tpu_torch.kernels.string_search import (
        window_match, window_match_plain)

    def checked(data, lengths, pat):
        got = window_match(data, lengths, pat)
        if not torch.cuda.is_current_stream_capturing():
            # a fused stage's capture reads nothing back; its eager
            # planning run before it is checked
            ref = window_match_plain(data, lengths, pat)
            record.append((len(pat), data.shape[0],
                           int((got != ref).sum())))
        return got
    return checked


def run_strings_phase(dev, tables) -> dict:
    """Each string expression of the slice on the card against the port's
    row interpreter at 2^12 rows, 0 rows apart; then StringLocate,
    StringReplace and SubstringIndex over the SF100 P_TYPE column (8
    slices of the part table) against pyarrow, each window_match launch
    held against its plain version on the same inputs, with each of the
    three expressions' device time on one slice. Returns the
    window_match launches of the p_type run."""
    import pyarrow as pa
    import pyarrow.compute as pc
    import torch
    from spark_rapids_tpu_torch import entry
    from spark_rapids_tpu_torch.expressions import (
        StringLocate, StringReplace, SubstringIndex, col, lit)
    from spark_rapids_tpu_torch.expressions import strings as S
    from spark_rapids_tpu_torch.kernels.string_search import window_match
    from spark_rapids_tpu_torch.plan import Session, table
    part, supplier, _ = tables
    conf = {"spark.rapids.tpu.sql.incompatibleOps.enabled": True}
    t = strings_table(supplier, part, STRINGS_ROWS)
    exprs = strings_exprs()
    df = entry._df(t, 1, entry.SUPPLIER_STRING_MAX_LEN).select(
        *[e.alias(f"e{i}") for i, e in enumerate(exprs)])
    record = []
    plain_wm = S.window_match
    S.window_match = checked_window_match(record)
    try:
        ses = Session(conf, device=dev)
        t0 = time.perf_counter()
        got = ses.collect(df)
        torch.cuda.synchronize(dev)
        card_s = time.perf_counter() - t0
    finally:
        S.window_match = plain_wm
    if ses.fell_back():
        raise AssertionError(f"strings: fell back {ses.fell_back()}")
    t0 = time.perf_counter()
    want = Session({**conf, **ORACLE_CONF}, device=dev).collect(df)
    cpu_s = time.perf_counter() - t0
    bad = {name: rows_apart(got.column(name), want.column(name))
           for name in want.column_names}
    wrong = {k: v for k, v in bad.items() if v}
    print(f"strings: {len(exprs)} expressions over {t.num_rows} rows on the "
          f"card ({card_s:.2f} s, cold) against the interpreter "
          f"({cpu_s:.2f} s): rows apart {wrong or 0}; window_match launches "
          f"{len(record)}, each against its plain version: "
          f"{sum(r[2] for r in record)} mismatches")
    if wrong or any(r[2] for r in record) or not record:
        raise AssertionError(f"strings: the card differs from the "
                             f"interpreter {wrong} or window_match from its "
                             f"plain version")

    # the three window_match callers over the SF100 p_type column
    ptype = part.select(["p_type"])
    three = {"locate": StringLocate(col("p_type"), lit("POLISHED")),
             "replace": StringReplace(col("p_type"), lit("BRASS"),
                                      lit("BRONZE")),
             "index": SubstringIndex(col("p_type"), lit(" "), lit(2))}
    calls = table(ptype, num_slices=Q16_SLICES,
                  batch_rows=-(-ptype.num_rows // Q16_SLICES)).select(
        *[e.alias(name) for name, e in three.items()])
    p = ptype.column("p_type")
    words = pc.split_pattern(p, " ")
    want = pa.table({
        "locate": pc.add(pc.find_substring(p, "POLISHED"), 1),
        "replace": pc.replace_substring(p, "BRASS", "BRONZE"),
        "index": pc.binary_join(pc.list_slice(words, 0, 2), " ")})
    record.clear()
    S.window_match = checked_window_match(record)
    try:
        ses = Session(conf, device=dev)
        window_match.launches = 0
        t0 = time.perf_counter()
        got = ses.collect(calls)
        torch.cuda.synchronize(dev)
        cold_s = time.perf_counter() - t0
        launches = window_match.launches
    finally:
        S.window_match = plain_wm
    bad = {name: rows_apart(pc.cast(got.column(name),
                                    want.column(name).type),
                            want.column(name))
           for name in want.column_names}
    shapes = sorted({(k, n) for k, n, _ in record})
    print(f"strings over SF100 p_type ({ptype.num_rows} rows, "
          f"{Q16_SLICES} slices): rows apart from pyarrow {bad}; "
          f"window_match launched {launches} times at (k, rows) {shapes}, "
          f"{sum(r[2] for r in record)} mismatches against its plain "
          f"version; the collect (upload, three expressions, Arrow out) "
          f"{cold_s:.3f} s cold")
    if any(bad.values()) or any(r[2] for r in record) or \
            launches != 3 * Q16_SLICES:
        raise AssertionError("strings over p_type: differs from pyarrow, "
                             "or window_match from its plain version, or "
                             f"{launches} launches, not {3 * Q16_SLICES}")
    # each expression's device time on one scanned slice
    from spark_rapids_tpu_torch.batch import from_arrow
    batch, schema = from_arrow(
        ptype.slice(0, -(-ptype.num_rows // Q16_SLICES)),
        string_max_len=entry.STRING_MAX_LEN, device=dev)
    times = {name: time_cuda_ms(lambda b=e.bind(schema): b.eval(batch), 5, 1)
             for name, e in three.items()}
    print(f"strings over one p_type slice (capacity {batch.capacity}): "
          f"device ms per expression (CUDA events) "
          f"{ {k: round(v, 3) for k, v in times.items()} }")
    return {"window_match": launches}


# ---------------------------------------------------------------------------
# The part-catalogue roll-up and the comment leg (the span programs)
# ---------------------------------------------------------------------------

#: the roll-up's input slices and shuffle partitions, and the comment
#: leg's slices of the SF100 supplier table (125,000 rows each)
CATALOG_SLICES = 8
CATALOG_PARTITIONS = 8
COMMENT_SLICES = 8


def run_catalog_phase(dev, counted, tables) -> dict:
    """The part-catalogue roll-up over the SF100 part table (20,000,000
    rows, ``entry.catalog_df`` through the port's Session, 8 slices): one
    cold run, equal to ``entry.catalog_reference`` in all 3,750 groups, in
    order, nothing fallen back, with its wall, rows/s and peak; murmur3 at
    its exchange and every window_match launch held against their plain
    versions. (Its profiled warm run and the span expressions' device
    times were cut to make room for the DECIMAL128 phase; PERF.md keeps
    their last readings.) Then
    the comment leg (``entry.comment_spans_df`` over the SF100 S_COMMENT,
    1,000,000 rows at 128 bytes): one run, 0 rows apart from pyarrow's
    RE2."""
    import pyarrow.compute as pc
    import torch
    from spark_rapids_tpu_torch import entry
    from spark_rapids_tpu_torch.plan import Session
    from spark_rapids_tpu_torch.expressions import hashing
    part, supplier, _ = tables
    conf = entry.session_conf(CATALOG_PARTITIONS)
    ses = Session(conf, device=dev)
    record, hashed = [], []

    def run(p):
        # every launch of both kernels held against its plain version
        df = entry.catalog_df(p, CATALOG_SLICES)
        plain = hashing.murmur3_int32
        hashing.murmur3_int32 = checked_murmur3(hashed)
        try:
            out = checked_run(lambda: ses.collect(df), record)
        finally:
            hashing.murmur3_int32 = plain
        if ses.fell_back():
            raise AssertionError(f"catalog fell back: {ses.fell_back()}")
        return out

    def check(got, expected):
        if not got.equals(expected):
            raise AssertionError(
                f"the catalog roll-up differs from the pyarrow oracle:\n"
                f"{got.slice(0, 3)}\n{expected.slice(0, 3)}")
        if got.num_rows != len(entry.P_TYPES) * len(entry.P_BRANDS):
            raise AssertionError(f"catalog: {got.num_rows} groups")
        return (f"; all {got.num_rows} groups equal in every column and "
                f"position")

    print(f"catalog: SF{Q16_SF} part ({part.num_rows} rows), "
          f"{CATALOG_SLICES} slices, {CATALOG_PARTITIONS} shuffle "
          f"partitions, strings at {entry.CATALOG_STRING_MAX_LEN} bytes")
    launches = run_path("catalog", lambda: part, entry.catalog_reference,
                        run, check, dev, counted, warm_runs=0)
    print(f"catalog: the Session's operators {ses.executed_exec_names()}")
    bad = sum(r[2] for r in record)
    worst = max((err for _, err in hashed), default=0)
    print(f"catalog: over the checked run, murmur3_int32 launched "
          f"{len(hashed)} times at rows "
          f"{sorted({n for n, _ in hashed})} (class_no at the group-by's "
          f"exchange), max_abs_err against its plain version {worst}; "
          f"window_match launched {len(record)} times (no string search on "
          f"this path), {bad} mismatches")
    if bad or worst or not hashed:
        raise AssertionError("catalog: a kernel differs from its plain "
                             "version, or murmur3 was not launched")

    # the comment leg: the span scans over 128-byte strings
    sup = supplier.select(["s_suppkey", "s_comment"])
    t0 = time.perf_counter()
    want = entry.comment_spans_reference(sup)
    oracle_s = time.perf_counter() - t0
    cses = Session(conf, device=dev)
    df = entry.comment_spans_df(sup, COMMENT_SLICES)
    t0 = time.perf_counter()
    got = cses.collect(df)
    torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    if cses.fell_back():
        raise AssertionError(f"comments fell back: {cses.fell_back()}")
    apart = {k: rows_apart(got.column(k), want.column(k))
             for k in want.column_names}
    if any(apart.values()):
        raise AssertionError(f"comments: rows apart from pyarrow {apart}")
    found = int(pc.sum(pc.greater(pc.utf8_length(got.column("complaint")),
                                  0)).as_py() or 0)
    print(f"comments: {sup.num_rows} S_COMMENT rows in {COMMENT_SLICES} "
          f"slices at {entry.SUPPLIER_STRING_MAX_LEN} bytes: 0 rows apart "
          f"from pyarrow (oracle {oracle_s:.2f} s; {found} rows extract a "
          f"non-empty complaint); cold {wall:.3f} s")
    return launches


# ---------------------------------------------------------------------------
# TPC-H Q14 and Q9 at SF10, and the scalar expressions, through the Session
# ---------------------------------------------------------------------------

#: TPC-H Q14 and Q9: scale factor, input slices, shuffle partitions, seed
#: (the lineitem and orders draws of Q3's seed, with the part keys)
SCALAR_Q_SF = 10
SCALAR_Q_SLICES = 8
SCALAR_Q_PARTITIONS = 8
SCALAR_Q_SEED = 3


def checked_murmur3(record):
    """``murmur3_int32`` with each launch held against its plain version on
    the same inputs: (rows, max_abs_err) appended to ``record``."""
    import torch
    from spark_rapids_tpu_torch.kernels.murmur3 import (murmur3_int32,
                                                        murmur3_int32_plain)

    def checked(data, validity, seeds):
        got = murmur3_int32(data, validity, seeds)
        if not torch.cuda.is_current_stream_capturing():
            ref = murmur3_int32_plain(data, validity, seeds)
            record.append((data.shape[0],
                           int((got.long() - ref.long()).abs().max())))
        return got
    return checked


def murmur3_checked(run, hashed):
    """``run()`` with every ``murmur3_int32`` launch of the hash
    expressions held against its plain version (``checked_murmur3``):
    (rows, max_abs_err) appended to ``hashed``."""
    from spark_rapids_tpu_torch.expressions import hashing
    plain = hashing.murmur3_int32
    hashing.murmur3_int32 = checked_murmur3(hashed)
    try:
        return run()
    finally:
        hashing.murmur3_int32 = plain


def report_murmur3(what: str, hashed, where: str) -> None:
    worst = max((err for _, err in hashed), default=0)
    print(f"{what}: murmur3_int32 launched {len(hashed)} times in the "
          f"checked run at rows {sorted({n for n, _ in hashed})} ({where}),"
          f" max_abs_err against its plain version {worst}")
    if worst or not hashed:
        raise AssertionError(f"{what}: murmur3 differs from its plain "
                             f"version, or was not launched")


def checked_run(run, record):
    """``run()`` with every ``window_match`` launch held against its plain
    version on the same inputs (``checked_window_match``)."""
    from spark_rapids_tpu_torch.expressions import strings as S
    plain = S.window_match
    S.window_match = checked_window_match(record)
    try:
        return run()
    finally:
        S.window_match = plain


def report_window_match(what: str, record) -> None:
    shapes = sorted({(k, n) for k, n, _ in record})
    bad = sum(r[2] for r in record)
    print(f"{what}: window_match launched {len(record)} times at (k, rows) "
          f"{shapes}, each against its plain version: {bad} mismatches")
    if not record or bad:
        raise AssertionError(f"{what}: window_match was not launched or "
                             f"disagrees with its plain version")


def run_q14_phase(dev, counted, tables) -> dict:
    """TPC-H Q14 at SF10 through the port's Session (``entry.q14_df``:
    September 1995's lines by ``add_months``, the join with part, the
    CASE WHEN over ``startswith(p_type, 'PROMO')`` in a global sum): its
    promo_revenue within rel 1e-6 of pyarrow's, nothing fallen back, cold
    and warm walls, rows/s, peak and idle share; then one run with each
    ``window_match`` launch (k = 5) held against its plain version."""
    from spark_rapids_tpu_torch import entry
    from spark_rapids_tpu_torch.plan import Session
    ses = Session(entry.session_conf(SCALAR_Q_PARTITIONS), device=dev)

    def run(t):
        out = ses.collect(entry.q14_df(*t, SCALAR_Q_SLICES))
        if ses.fell_back():
            raise AssertionError(f"q14 fell back: {ses.fell_back()}")
        return out

    def check(got, expected):
        (v,) = got.column("promo_revenue").to_pylist()
        (w,) = expected.column("promo_revenue").to_pylist()
        rel = abs(v - w) / abs(w)
        if not rel <= FLOAT_REL_TOL:
            raise AssertionError(f"Q14 promo_revenue {v!r}, pyarrow {w!r}")
        return f"; promo_revenue {v!r} against {w!r}, rel err {rel:.3g}"

    t0 = time.perf_counter()
    expected = entry.q14_reference(*tables)
    print(f"q14: SF{SCALAR_Q_SF} ({tables[0].num_rows} lineitem, "
          f"{tables[1].num_rows} part rows), {SCALAR_Q_SLICES} slices, "
          f"{SCALAR_Q_PARTITIONS} shuffle partitions; pyarrow oracle "
          f"{time.perf_counter() - t0:.2f} s; rows/s counts lineitem")
    launches = run_path("q14", lambda: tables, lambda _: expected, run,
                        check, dev, counted,
                        rows_of=lambda t: t[0].num_rows)
    print(f"q14: the Session's operators {ses.executed_exec_names()}")
    profiled_idle("q14", lambda: run(tables), dev, host=False)
    record = []
    check(checked_run(lambda: run(tables), record), expected)
    report_window_match("q14", record)
    return launches


def run_q9_phase(dev, counted, tables) -> dict:
    """TPC-H Q9 at SF10 through the port's Session (``entry.q9_df``: the
    green part filter, five joins, ``year(o_orderdate)``, the sum of
    profit by nation and year): equal to pyarrow in every group and
    position (profit within rel 1e-6), nothing fallen back, cold and warm
    walls, rows/s, peak and idle share; then one run with each
    ``window_match`` launch (k = 5) held against its plain version, and
    murmur3 against its plain version at the group-by's exchange (it
    hashes the int32 o_year)."""
    from spark_rapids_tpu_torch import entry
    from spark_rapids_tpu_torch.plan import Session
    ses = Session(entry.session_conf(SCALAR_Q_PARTITIONS), device=dev)

    def run(t):
        out = ses.collect(entry.q9_df(*t, SCALAR_Q_SLICES))
        if ses.fell_back():
            raise AssertionError(f"q9 fell back: {ses.fell_back()}")
        return out

    def check(got, expected):
        if got.num_rows != expected.num_rows or any(
                not got.column(k).equals(expected.column(k))
                for k in entry.Q9_KEYS):
            raise AssertionError(f"Q9's groups differ from pyarrow:\n"
                                 f"{got.slice(0, 3)}\n{expected.slice(0, 3)}")
        g = got.column("sum_profit").to_pylist()
        w = expected.column("sum_profit").to_pylist()
        worst = max(abs(a - b) / abs(b) for a, b in zip(g, w))
        if not worst <= FLOAT_REL_TOL:
            raise AssertionError(f"Q9 profit max rel err {worst:.3g}")
        return (f"; all {got.num_rows} groups in order, profit max rel err "
                f"{worst:.3g}")

    t0 = time.perf_counter()
    expected = entry.q9_reference(*tables)
    print(f"q9: SF{SCALAR_Q_SF} ({[t.num_rows for t in tables]} rows of "
          f"part, supplier, partsupp, lineitem, orders, nation), "
          f"{SCALAR_Q_SLICES} slices, {SCALAR_Q_PARTITIONS} shuffle "
          f"partitions; pyarrow oracle {time.perf_counter() - t0:.2f} s; "
          f"rows/s counts lineitem")
    launches = run_path("q9", lambda: tables, lambda _: expected, run, check,
                        dev, counted, rows_of=lambda t: t[3].num_rows)
    print(f"q9: the Session's operators {ses.executed_exec_names()}")
    profiled_idle("q9", lambda: run(tables), dev, host=False)
    record = []
    check(checked_run(lambda: run(tables), record), expected)
    report_window_match("q9", record)
    ses.prepare(entry.q9_df(*tables, SCALAR_Q_SLICES))
    check_murmur3_at_exchanges("Q9", ses.last_plan, dev)
    return launches


# ---------------------------------------------------------------------------
# Windows and Z-order over the SF10 orders and lineitem of Q9's draw
# ---------------------------------------------------------------------------

#: the window legs: input slices and shuffle partitions
WINDOW_SLICES = 8
WINDOW_PARTITIONS = 8
#: rows of the window matrix's card-against-interpreter check, in
#: partitions of about 16 rows (the interpreter's value-bounded RANGE
#: frames scan their partition for every row)
WINDOW_MATRIX_ROWS = 1 << 14
WINDOW_MATRIX_KEYS = 1 << 10


def run_windows_phase(dev, counted, tables) -> list:
    """Both window legs at SF10 through the port's Session, then the
    window matrix (``check_window_matrix``). Each leg: nothing fallen back,
    equal to its numpy reference (``entry.check_customer_history``,
    ``check_supplier_months``), cold and warm walls, rows/s, peak, and a
    profiled run's wall and idle share; supplier months' murmur3 launches
    in its cold run each against the plain version. Returns each leg's
    launches."""
    from spark_rapids_tpu_torch import entry
    from spark_rapids_tpu_torch.plan import Session
    orders, lineitem = tables
    runs = []
    legs = (("customer history", orders, entry.customer_history_df,
             entry.customer_history_reference,
             entry.check_customer_history, []),
            ("supplier months", lineitem, entry.supplier_months_df,
             entry.supplier_months_reference, entry.check_supplier_months,
             counted))
    for name, table, make_df, reference, check, kernels in legs:
        ses = Session(entry.session_conf(WINDOW_PARTITIONS), device=dev)
        hashed = []

        def run(t, ses=ses, make_df=make_df, hashed=hashed, name=name):
            # the cold run holds each murmur3 launch against its plain
            # version
            collect = (lambda: ses.collect(make_df(t, WINDOW_SLICES)))
            out = collect() if hashed else murmur3_checked(collect, hashed)
            if ses.fell_back():
                raise AssertionError(f"{name} fell back: {ses.fell_back()}")
            return out

        print(f"{name}: {table.num_rows} rows of {table.column_names}, "
              f"{WINDOW_SLICES} slices, {WINDOW_PARTITIONS} shuffle "
              f"partitions")
        launches = run_path(name, lambda t=table: t, reference, run,
                            lambda got, want, check=check: "; " +
                            check(got, want), dev, kernels)
        print(f"{name}: the Session's operators {ses.executed_exec_names()}")
        profiled_idle(name, lambda t=table, run=run: run(t), dev,
                      host=False)
        if kernels:
            report_murmur3(name, hashed, "y and m at the aggregate's "
                           "exchange, y at the (l_suppkey, y) window's")
        elif hashed:
            raise AssertionError(f"{name}: murmur3 launched on int64 keys")
        runs.append(launches)
    check_window_matrix(dev)
    return runs


def window_matrix_table(n: int, keys: int, seed: int = 29):
    """``n`` seeded rows: a partition key of ``keys`` values with nulls, an
    int order key of ties and nulls, a double order key with NaN, -0.0
    and nulls, a date, a string with nulls and empty strings, int64 and
    double values with nulls (NaN among the doubles) and a unique row
    number ``u`` that breaks ties."""
    import numpy as np
    import pyarrow as pa
    rng = np.random.default_rng(seed)

    def nulls(p):
        return rng.random(n) < p
    f = rng.normal(0, 10, n).round(1)
    f[rng.random(n) < 0.03] = np.nan
    f[rng.random(n) < 0.03] = -0.0
    # quarters: every sum is exact in any order
    d = rng.integers(-400, 400, n) / 4
    d[rng.random(n) < 0.02] = np.nan
    words = np.array(["", "a", "ab", "b", "ba", "pear", "apple", "zz"])
    return pa.table({
        "k": pa.array(rng.integers(0, keys, n).astype(np.int32),
                      mask=nulls(0.01)),
        "o": pa.array(rng.integers(0, 12, n).astype(np.int32),
                      mask=nulls(0.05)),
        "f": pa.array(f, mask=nulls(0.05)),
        "dt": pa.array(rng.integers(18000, 18040, n).astype(np.int32),
                       mask=nulls(0.05)).view(pa.date32()),
        "s": pa.array(words[rng.integers(0, len(words), n)],
                      mask=nulls(0.1)),
        "v": pa.array(rng.integers(-100, 100, n), mask=nulls(0.1)),
        "d": pa.array(d, mask=nulls(0.1)),
        "u": np.arange(n, dtype=np.int64),
    })


def window_matrix_queries():
    """(name, DataFrame maker over the matrix table, conf) of the window
    matrix: ``tests/test_window.py``'s ROWS and RANGE frame matrices
    (:116-158) ascending and descending with nulls first and last, the
    ranking functions, nth_value and lag/lead (strings with defaults) over
    int, double, date and string order keys, a window without PARTITION
    BY, and key batching at batchRows 64."""
    from spark_rapids_tpu_torch import entry
    from spark_rapids_tpu_torch.exec.sort import SortOrder
    from spark_rapids_tpu_torch.expressions import col, lit
    from spark_rapids_tpu_torch.expressions.aggregates import (
        Average, Count, Max, Min, Sum)
    from spark_rapids_tpu_torch.expressions.window import (
        CumeDist, LagLead, NthValue, NTile, PercentRank, Rank, RowNumber,
        WindowAgg, WindowFrame, over)
    rows_frames = [(-2, None), (1, None), (None, -1), (None, 2), (-3, -1),
                   (1, 3), (-2, 2), (-100, 50), (None, None)]
    range_asc = [(-5, 5), (None, 3), (-4, None), (-5, -1), (2, 6), (0, 4),
                 (-3, 0)]
    range_desc = [(-5, 5), (-4, None), (None, 3), (1, 4)]
    part = [col("k")]
    out = []

    def df(t, *ws):
        return entry._df(t, 1).window(*ws)
    for desc in (False, True):
        for nf in (True, False):
            tag = f"{'desc' if desc else 'asc'} nulls " \
                  f"{'first' if nf else 'last'}"
            # every frame of a matrix in one query: one spec, a frame each;
            # Spark's default null orders take the test's four aggregates,
            # the other two sum and count (the interpreter's row loop is
            # most of the phase)
            by = [SortOrder(col("o"), desc, nf), SortOrder(col("u"), desc)]
            aggs = (("s", Sum), ("c", Count)) + (
                (("mn", Min), ("mx", Max)) if nf != desc else ())
            out.append((f"rows matrix {tag}", lambda t, by=by, aggs=aggs:
                        df(t, *[
                            over(WindowAgg(a(col("d" if n == "mx"
                                                 else "v"))),
                                 part, by, WindowFrame(is_rows=True,
                                                       start=lo, end=hi))
                            .alias(f"{n}{j}")
                            for j, (lo, hi) in enumerate(rows_frames)
                            for n, a in aggs]), {}))
            o = [SortOrder(col("o"), desc, nf)]
            frames = range_desc if desc else range_asc
            fns = (("s", lambda: WindowAgg(Sum(col("v")))),
                   ("c", lambda: WindowAgg(Count(col("v"))))) + ((
                       ("mn", lambda: WindowAgg(Min(col("v")))),
                       ("mx", lambda: WindowAgg(Max(col("d")))),
                       ("nv", lambda: NthValue(col("v"), 2)))
                       if nf != desc else ())
            out.append((f"range matrix {tag}",
                        lambda t, o=o, frames=frames, fns=fns: df(t, *[
                            over(fn(), part, o,
                                 WindowFrame(is_rows=False, start=lo,
                                             end=hi)).alias(f"{n}{j}")
                            for j, (lo, hi) in enumerate(frames)
                            for n, fn in fns]), {}))
    for key in ("o", "f", "dt", "s"):
        for desc in (False, True):
            by = [SortOrder(col(key), desc, not desc)]
            out.append((f"ranking by {key} {'desc' if desc else 'asc'}",
                        lambda t, by=by: df(t, *[
                            over(fn, part, by).alias(n) for n, fn in (
                                ("rn", RowNumber()), ("r", Rank()),
                                ("dr", Rank(dense=True)), ("nt", NTile(3)),
                                ("pr", PercentRank()), ("cd", CumeDist()),
                                ("nv", NthValue(col("s"), 2)),
                                ("lag", LagLead(col("s"), 1, lit("none"))),
                                ("lead", LagLead(col("s"), 2, lit("?"),
                                                 False)),
                                ("lv", LagLead(col("v"), 1)),
                                ("mn", WindowAgg(Min(col("s")))),
                                ("run", WindowAgg(Sum(col("d")))))]), {}))
        fr = WindowFrame(is_rows=False, start=-2, end=1)
        if key in ("o", "f", "dt"):
            by = [SortOrder(col(key), False, False)]
            out.append((f"range -2,1 by {key}", lambda t, by=by, fr=fr: df(
                t, over(WindowAgg(Sum(col("v"))), part, by, fr)
                .alias("sum_v"),
                over(WindowAgg(Max(col("s"))), part, by, fr).alias("max_s")),
                {}))
    by = [SortOrder(col("o")), SortOrder(col("u"))]
    # (no unbounded frame: the interpreter sums each row's frame, and one
    # partition of 2^14 rows would make that quadratic)
    out.append(("unpartitioned", lambda t: df(
        t, over(RowNumber(), [], by).alias("rn"),
        over(WindowAgg(Sum(col("v"))), [], by,
             WindowFrame(is_rows=True, start=-2, end=2)).alias("sum_v"),
        over(LagLead(col("s"), 3, lit("-")), [], by).alias("lag")), {}))
    out.append(("key batching at batchRows 64", lambda t: df(
        t, over(RowNumber(), part, by).alias("rn"),
        over(WindowAgg(Sum(col("v"))), part, by).alias("sum_v"),
        over(WindowAgg(Min(col("s"))), part, by,
             WindowFrame(is_rows=True, start=-1, end=1)).alias("mn")),
        {"spark.rapids.tpu.sql.window.batchRows": 64}))
    return out


def check_window_matrix(dev) -> None:
    """Every window query of ``window_matrix_queries`` over
    ``WINDOW_MATRIX_ROWS`` rows on the card against the port's row
    interpreter: nothing fallen back, 0 rows apart (floats within rel
    1e-6), the rows sorted by ``u``; key batching splits."""
    from spark_rapids_tpu_torch.plan import Session
    t = window_matrix_table(WINDOW_MATRIX_ROWS, WINDOW_MATRIX_KEYS)
    card_s = interp_s = 0.0
    apart, n = {}, 0
    for name, make, conf in window_matrix_queries():
        ses = Session(conf, device=dev)
        t0 = time.perf_counter()
        got = ses.collect(make(t)).sort_by("u")
        card_s += time.perf_counter() - t0
        if ses.fell_back():
            raise AssertionError(f"window matrix {name}: fell back "
                                 f"{ses.fell_back()}")
        if conf and "KeyBatchingExec" not in ses.executed_exec_names():
            raise AssertionError(f"window matrix {name}: no key batching")
        t0 = time.perf_counter()
        want = Session({**conf, **ORACLE_CONF}, device=dev).collect(
            make(t)).sort_by("u")
        interp_s += time.perf_counter() - t0
        bad = sum(float_rows_apart(got.column(c), want.column(c),
                                   FLOAT_REL_TOL)
                  for c in got.column_names)
        n += got.num_columns - t.num_columns
        if bad:
            apart[name] = bad
    print(f"windows: {n} window columns in "
          f"{len(window_matrix_queries())} queries over {t.num_rows} rows "
          f"on the card ({card_s:.2f} s) against the interpreter "
          f"({interp_s:.2f} s): rows apart {apart or 0}")
    if apart:
        raise AssertionError(f"window matrix: the card differs {apart}")


def run_zorder_phase(dev, lineitem) -> None:
    """OPTIMIZE ZORDER BY (l_partkey, l_suppkey, l_shipdate) over the SF10
    lineitem through the Session (``entry.zorder_df``: the key and the
    global sort by it): every output row's key equal to numpy's
    magic-mask Morton key of its columns, the keys equal to numpy's
    sorted keys of the input; the run's wall and peak."""
    import numpy as np
    import pyarrow as pa
    import torch
    from spark_rapids_tpu_torch import entry
    from spark_rapids_tpu_torch.plan import Session
    t0 = time.perf_counter()
    want = np.sort(entry.zorder3_reference(
        lineitem.column("l_partkey").to_numpy(),
        lineitem.column("l_suppkey").to_numpy(),
        lineitem.column("l_shipdate").cast(pa.int32()).to_numpy()))
    oracle_s = time.perf_counter() - t0
    ses = Session(entry.session_conf(WINDOW_PARTITIONS), device=dev)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    got = ses.collect(entry.zorder_df(lineitem, WINDOW_SLICES))
    torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    if ses.fell_back():
        raise AssertionError(f"zorder fell back: {ses.fell_back()}")
    z = got.column("z").to_numpy()
    mine = entry.zorder3_reference(
        got.column("l_partkey").to_numpy(), got.column("l_suppkey")
        .to_numpy(), got.column("l_shipdate").cast(pa.int32()).to_numpy())
    bad_rows = int((z != mine).sum())
    bad_sorted = int((z != want).sum()) if len(z) == len(want) else -1
    print(f"zorder: {lineitem.num_rows} rows sorted by zorder_key("
          f"l_partkey, l_suppkey, l_shipdate) in {wall:.3f} s (one cold "
          f"run, {lineitem.num_rows / wall:,.0f} rows/s, peak "
          f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB; "
          f"operators {ses.executed_exec_names()}); numpy's Morton key "
          f"and sort {oracle_s:.2f} s; keys apart from numpy's of their "
          f"row {bad_rows}, from numpy's sorted keys {bad_sorted}")
    if bad_rows or bad_sorted:
        raise AssertionError("zorder: the keys or their order differ from "
                             "numpy's")


# ---------------------------------------------------------------------------
# The nested kinds: order baskets and P_NAME words over Q9's SF10 tables,
# and every collection expression on the card against the interpreter
# ---------------------------------------------------------------------------

#: the baskets and words legs: input slices and shuffle partitions
NESTED_SLICES = 8
NESTED_PARTITIONS = 8


def _exact(what: str):
    def check(got, expected):
        if not got.equals(expected):
            raise AssertionError(f"{what} differs from pyarrow:\n"
                                 f"{got.slice(0, 3).to_pylist()}\n"
                                 f"{expected.slice(0, 3).to_pylist()}")
    return check


def run_baskets_phase(dev, tables) -> dict:
    """The nested paths at SF10 over Q9's draw, through the port's
    Session, each exact against its vectorized pyarrow/numpy reference
    with nothing fallen back: the order baskets (``entry.baskets_df``:
    collect_set of each order's part keys into array<bigint> with a budget
    of 8, count and max beside it, the arrays riding the join with orders
    as payload, a named_struct sort key, size, array_contains,
    array_min/max, element_at(sort_array(desc), 1), size >= 4, the first
    10,000 by date and key); the item support (``entry.support_df``:
    explode, group by item, the top 100), its exploded row count equal to
    the distinct (order, part) pairs; and the P_NAME words
    (``entry.words_df``: split into array<string> in the 3D layout, size,
    element_at, explode, all 92 words). Each leg a checked cold run, a
    checked warm run and a profiled run for the idle share."""
    from spark_rapids_tpu_torch import entry
    from spark_rapids_tpu_torch.plan import Session
    part, _, _, lineitem, orders, _ = tables
    ses = Session(entry.session_conf(NESTED_PARTITIONS), device=dev)

    def collect(df):
        out = ses.collect(df)
        if ses.fell_back():
            raise AssertionError(f"nested paths fell back: "
                                 f"{ses.fell_back()}")
        return out

    probe = entry.basket_probe(lineitem)
    ref_s = []
    t0 = time.perf_counter()
    pairs = entry.basket_pairs(lineitem)
    ref_s.append(time.perf_counter() - t0)
    baskets = entry.baskets_reference(lineitem, orders, probe, pairs)
    ref_s.append(time.perf_counter() - t0 - sum(ref_s))
    support, n_pairs = entry.support_reference(lineitem, pairs)
    ref_s.append(time.perf_counter() - t0 - sum(ref_s))
    words = entry.words_reference(part)
    ref_s.append(time.perf_counter() - t0 - sum(ref_s))
    print(f"baskets: SF{SCALAR_Q_SF} ({lineitem.num_rows} lineitem, "
          f"{orders.num_rows} orders, {part.num_rows} part rows), "
          f"{NESTED_SLICES} slices, {NESTED_PARTITIONS} shuffle partitions;"
          f" references (pairs, baskets, support, words) "
          f"{[round(x, 2) for x in ref_s]} s; {n_pairs} distinct (order, "
          f"part) pairs, probe part {probe}", flush=True)

    def leg(name, run, expected, rows):
        # a checked cold run and an unprofiled checked warm run (walls,
        # peak), then a profiled run for the idle share
        stats = {}
        run_path(name, lambda: None, lambda _: expected, lambda _: run(),
                 _exact(name), dev, [], rows_of=lambda _: rows,
                 stats=stats)
        idle = profiled_idle(name, run, dev, host=False)
        print(f"{name}: warm {stats['warm_s']:.3f} s, "
              f"{rows / stats['warm_s']:,.0f} rows/s, device memory peak "
              f"{stats['peak'] / 2**30:.2f} GiB, idle share {idle:.1%}; "
              f"{card_line()}", flush=True)

    leg("baskets", lambda: collect(entry.baskets_df(
        lineitem, orders, probe, NESTED_SLICES)), baskets,
        lineitem.num_rows)
    print(f"baskets: the Session's operators {ses.executed_exec_names()}")
    leg("support", lambda: collect(entry.support_df(
        lineitem, NESTED_SLICES)), support, lineitem.num_rows)
    n = collect(entry.exploded_rows_df(lineitem, NESTED_SLICES))
    (exploded,) = n.column("n").to_pylist()
    if exploded != n_pairs:
        raise AssertionError(f"explode gave {exploded} rows, not the "
                             f"{n_pairs} distinct pairs")
    print(f"support: explode gave {exploded} rows, the distinct (order, "
          f"part) pairs")
    leg("words", lambda: collect(entry.words_df(part, NESTED_SLICES)),
        words, part.num_rows)
    if words.num_rows != len(entry.P_NAME_WORDS):
        raise AssertionError(f"{words.num_rows} words, not 92")
    print(f"words: the Session's operators {ses.executed_exec_names()}")
    return {}


def run_order_lines_phase(dev, tables) -> dict:
    """The order lines kept as arrays at SF10 over Q9's draw, through the
    port's Session (``entry.order_lines_df``: each order's lines packed
    into one collect_list and unpacked by transforms, collect_set of its
    parts and of its deep-discount parts, three joins with orders, then
    aggregate, zip_with, array_distinct, the four set operations,
    filter, exists, forall, a transform reading an outer column, slice of
    sort_array, array_position, array_remove, transform_values,
    map_filter, transform_keys, sequence and flatten; the top 10,000 by
    quantity), exact against its vectorized reference with nothing fallen
    back: a checked cold run and an unprofiled checked warm run (walls,
    rows/s, peak), then a profiled run for the idle share. Then
    ``explode(replicaterows(n_lines))`` under ``generate.maxRepeat`` = 8:
    one row per line. No kernel lies on this path: its exchanges hash
    int64 keys."""
    from spark_rapids_tpu_torch import entry
    from spark_rapids_tpu_torch.plan import Session
    _, _, _, lineitem, orders, _ = tables
    t0 = time.perf_counter()
    lines, orders = entry.order_lines_tables(lineitem, orders)
    made_s = time.perf_counter() - t0
    probe = entry.basket_probe(lines)
    t0 = time.perf_counter()
    expected = entry.order_lines_reference(lines, orders, probe)
    ref_s = time.perf_counter() - t0
    print(f"order lines: SF{SCALAR_Q_SF} ({lines.num_rows} lineitem, "
          f"{orders.num_rows} orders rows), {NESTED_SLICES} slices, "
          f"{NESTED_PARTITIONS} shuffle partitions, lists of at most "
          f"{entry.ORDER_LINES_MAX}; l_linenumber on the host {made_s:.2f} "
          f"s; reference {ref_s:.2f} s; probe part {probe}", flush=True)
    ses = Session(entry.order_lines_conf(NESTED_PARTITIONS), device=dev)

    def run():
        out = ses.collect(entry.order_lines_df(lines, orders, probe,
                                               NESTED_SLICES))
        if ses.fell_back():
            raise AssertionError(f"order lines fell back {ses.fell_back()}")
        return out

    stats = {}
    run_path("order lines", lambda: None, lambda _: expected,
             lambda _: run(), _exact("order lines"), dev, [],
             rows_of=lambda _: lines.num_rows, stats=stats)
    idle = profiled_idle("order lines", run, dev, host=False)
    print(f"order lines: warm {stats['warm_s']:.3f} s, "
          f"{lines.num_rows / stats['warm_s']:,.0f} rows/s, device memory "
          f"peak {stats['peak'] / 2**30:.2f} GiB, idle share {idle:.1%}; "
          f"{card_line()}", flush=True)
    print(f"order lines: the Session's operators {ses.executed_exec_names()}")
    t0 = time.perf_counter()
    (copies,) = ses.collect(entry.order_line_copies_df(
        lines, NESTED_SLICES)).column("n").to_pylist()
    if ses.fell_back() or copies != lines.num_rows:
        raise AssertionError(f"explode(replicaterows(n_lines)) gave "
                             f"{copies} rows, not {lines.num_rows}, or fell "
                             f"back {ses.fell_back()}")
    print(f"order lines: explode(replicaterows(n_lines)) under maxRepeat "
          f"{entry.ORDER_LINES_MAX} gave {copies} rows, the lineitem rows "
          f"({time.perf_counter() - t0:.2f} s)")
    return {}


#: TPC-H Q1 over JSON Lines: the scale factor (SF1's 6,001,215 lineitem
#: rows; at SF10 the [cap, 256] int32 scan masks of one slice's field step
#: take tens of GiB), input slices and shuffle partitions
JSON_ROWS = 6_001_215
JSON_SLICES = 8
JSON_PARTITIONS = 8


def run_json_q1_phase(dev, counted) -> dict:
    """TPC-H Q1 over SF1 JSON Lines (``entry.lineitem_json``: one ~200
    byte document a lineitem row in a string(256) column) through the
    port's Session (``entry.q1_json_df``: every field as
    ``from_json(value, schema).field``, which binds to get_json_object and
    a cast to BIGINT, DOUBLE or DATE, the double parse on the device under
    ``castStringToFloat``): within rel 1e-6 of ``entry.q1_json_reference``
    with nothing fallen back, cold and warm walls, rows/s, peak and idle
    share, each ``window_match`` launch of the cold run (every field step,
    k = 7 to 17) held against its plain version; then json_tuple's count
    by both flags equal to Q1's count_order. Returns the cold run's
    launches."""
    import collections as pycollections
    from spark_rapids_tpu_torch import entry
    from spark_rapids_tpu_torch.plan import Session
    t0 = time.perf_counter()
    source = entry.lineitem_table(JSON_ROWS, DATA_SEED)
    docs = entry.lineitem_json(source)
    import pyarrow.compute as pc
    sizes = pc.binary_length(docs.column("value"))
    print(f"json q1: {docs.num_rows} documents of "
          f"{pc.min(sizes).as_py()}-{pc.max(sizes).as_py()} bytes (string("
          f"{entry.JSON_MAX_LEN})) made by pyarrow in "
          f"{time.perf_counter() - t0:.2f} s; {JSON_SLICES} slices, "
          f"{JSON_PARTITIONS} shuffle partitions", flush=True)
    ses = Session(entry.q1_json_conf(JSON_PARTITIONS), device=dev)

    def run(d):
        out = ses.collect(entry.q1_json_df(d, JSON_SLICES))
        if ses.fell_back():
            raise AssertionError(f"json q1 fell back {ses.fell_back()}")
        return out

    def check(got, expected):
        return f"; float max rel err {check_q1_result(got, expected):.3g}"

    stats, record = {}, []
    expected = entry.q1_json_reference(source)
    # the cold run with each window_match launch held against its plain
    # version on the same inputs
    launches = run_path("json q1", lambda: docs, lambda _: expected,
                        lambda d: checked_run(lambda: run(d), record)
                        if not record else run(d),
                        check, dev, counted, stats=stats)
    idle = profiled_idle("json q1", lambda: run(docs), dev, host=False)
    print(f"json q1: warm {stats['warm_s']:.3f} s, "
          f"{docs.num_rows / stats['warm_s']:,.0f} rows/s, device memory "
          f"peak {stats['peak'] / 2**30:.2f} GiB, idle share {idle:.1%}; "
          f"{card_line()}", flush=True)
    print(f"json q1: the Session's operators {ses.executed_exec_names()}")
    report_window_match("json q1", record)
    by_k = pycollections.Counter(k for k, _, _ in record)
    print(f"json q1: window_match launches per run by k {dict(by_k)}")
    flags = ses.collect(entry.q1_json_flags_df(docs, JSON_SLICES))
    if ses.fell_back() or flags.column("count_order").to_pylist() != \
            expected.column("count_order").to_pylist():
        raise AssertionError(f"json_tuple's counts {flags.to_pylist()} "
                             f"differ from Q1's count_order")
    print(f"json q1: json_tuple(value, 'l_returnflag', 'l_linestatus', "
          f"'l_shipdate') counts {flags.column('count_order').to_pylist()}"
          f" = Q1's count_order")
    return launches


#: rows of the collection phase's table, and its arrays' and maps' budget
COLLECTIONS_ROWS = 1 << 14
COLLECTIONS_BUDGET = 8


def collections_table(n: int, seed: int = 23):
    """``n`` rows for the collection expressions, drawn in bulk: int64 and
    double lists of 0 to 6 elements (every seventh empty, every eleventh
    null), string lists, a map<int,int64> (duplicate keys possible), an
    int64 probe and an int32 index per row, a string, a struct with every
    fifth row null, "k:v,k:v" strings (entries without ':', empty strings
    and nulls among them), a group key and nullable values."""
    import numpy as np
    import pyarrow as pa
    rng = np.random.default_rng(seed)
    i = np.arange(n)
    lens = rng.integers(0, 7, n)
    lens[i % 7 == 0] = 0
    null = i % 11 == 3
    lens[null] = 0
    offsets = np.zeros(n + 1, np.int32)
    np.cumsum(lens, out=offsets[1:])
    off = pa.array(offsets, mask=np.append(null, False))
    total = int(offsets[-1])
    vocab = pa.array(["", "a", "bb", "ccc", "w", "ww", "www", "xyz"])
    word = vocab.take(pa.array(rng.integers(0, len(vocab), total)))
    kv_words = ["k", "v", "kk", "a", "", "x"]
    kv = []
    for j in range(n):
        if j % 13 == 5:
            kv.append(None)
            continue
        parts = []
        for _ in range(int(rng.integers(0, 4))):
            k = kv_words[int(rng.integers(0, len(kv_words)))]
            parts.append(k if rng.random() < 0.2 else
                         f"{k}:{int(rng.integers(0, 99))}")
        kv.append(",".join(parts))
    st = pa.StructArray.from_arrays(
        [pa.array(rng.integers(0, 9, n), pa.int64()),
         vocab.take(pa.array(rng.integers(0, len(vocab), n)))],
        names=["a", "b"], mask=pa.array(i % 5 == 2))
    v = pa.array(rng.integers(-99, 99, n), pa.int64(),
                 mask=rng.random(n) < 0.05)
    dvals = rng.normal(0, 5, total).round(2)
    dvals[::97] = np.nan
    lens_b = rng.integers(0, 7, n)
    lens_b[null] = 0
    off_b = np.zeros(n + 1, np.int32)
    np.cumsum(lens_b, out=off_b[1:])
    lo = rng.integers(-5, 5, n)
    return pa.table({
        "ia": pa.ListArray.from_arrays(off, pa.array(
            rng.integers(-9, 9, total), pa.int64())),
        "da": pa.ListArray.from_arrays(off, pa.array(dvals)),
        "sa": pa.ListArray.from_arrays(off, word),
        "m": pa.MapArray.from_arrays(off, pa.array(
            rng.integers(0, 6, total), pa.int32()), pa.array(
            rng.integers(-50, 50, total), pa.int64())),
        "p": pa.array(rng.integers(-9, 9, n), pa.int64()),
        "i": pa.array(rng.integers(-7, 8, n).astype(np.int32)),
        "pw": vocab.take(pa.array(rng.integers(0, len(vocab), n))),
        "mk": pa.array(rng.integers(0, 7, n).astype(np.int32)),
        "st": st,
        "kv": pa.array(kv),
        "k": pa.array(rng.integers(0, 100, n).astype(np.int32)),
        "v": v,
        "ib": pa.ListArray.from_arrays(pa.array(
            off_b, mask=np.append(null, False)), pa.array(
            rng.integers(-9, 9, int(off_b[-1])), pa.int64())),
        "db": pa.ListArray.from_arrays(pa.array(
            off_b, mask=np.append(null, False)), pa.array(
            rng.integers(-8, 8, int(off_b[-1])) / 4)),
        "n": pa.array(rng.integers(0, 8, n), pa.int64()),
        "s": pa.array((rng.integers(1, 5, n)
                       * rng.choice([-1, 1], n)).astype(np.int32)),
        "l": pa.array(rng.integers(0, 4, n).astype(np.int32)),
        "lo": pa.array(lo, pa.int64()),
        "hi": pa.array(lo + rng.integers(-7, 8, n), pa.int64()),
        "step": pa.array(rng.choice([-3, -2, -1, 1, 2, 3], n), pa.int64()),
        "doc": pa.array(json_docs(rng, n))})


#: the collection phase's documents: nested objects and arrays, escapes,
#: a \u escape, blanks, null values, garbage and null rows
JSON_DOC_SHAPES = (
    '{{"a": {a}, "b": {b}, "s": "{w}"}}',
    ' {{ "a" :{a} ,"n": {{"c":[{a},{{"d":"{w}"}}], "e":null}}, "s":"{w}"}} ',
    '{{"arr": [{a}, "{w}", [1, 2], {{"k": {b}}}], "a": null}}',
    '{{"s": "{w}", "a": "{a}", "b": true}}',
    '{{"a.b": {a}, "a": {{"b": {b}}}, "s": "caf\\u00e9"}}',
    '[{a}, {{"a": {b}}}, "{w}"]', "garbage", "")
JSON_DOC_WORDS = ("x", 'q\\"t', "tab\\tx", "sl\\/a", "", "a,b}")
JSON_PATHS = ("$", "$.a", "$.b", "$.s", "$.n", "$.n.c[1].d", "$.n.e",
              "$.arr[1]", "$.arr[3].k", "$.arr[9]", "$['a.b']", "$.a.b",
              "$[1].a", "$[2]")
JSON_DOC_WIDTH = 128


def json_docs(rng, n: int) -> list:
    out = []
    for j in range(n):
        if j % 17 == 4:
            out.append(None)
            continue
        shape = JSON_DOC_SHAPES[int(rng.integers(0, len(JSON_DOC_SHAPES)))]
        out.append(shape.format(
            a=int(rng.integers(-99, 99)), b=int(rng.integers(0, 400)) / 8,
            w=JSON_DOC_WORDS[int(rng.integers(0, len(JSON_DOC_WORDS)))]))
    return out


def collections_scan(t):
    """One batch of ``t``, arrays and maps at a budget of 8 elements."""
    # one batch, arrays and maps at a budget of 8 elements (the data
    # holds at most 6): an explode's output holds cap x budget rows
    # and carries the array along, so the default 256 would make it
    # 2 KiB a row
    import dataclasses
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.batch import (Field, Schema,
                                              schema_from_arrow)
    from spark_rapids_tpu_torch.plan.logical import (DataFrame,
                                                     LogicalScan)
    # a column without nulls is declared so: a lambda body that reads
    # a nullable column may give null elements, which the planner
    # sends to the CPU
    sch = Schema([Field(f.name, dataclasses.replace(
        f.dtype, max_len=COLLECTIONS_BUDGET)
        if f.dtype.kind in (T.TypeKind.ARRAY, T.TypeKind.MAP)
        else T.string(JSON_DOC_WIDTH) if f.name == "doc" else f.dtype,
        f.nullable and t.column(f.name).null_count > 0)
        for f in schema_from_arrow(t.schema)])
    return DataFrame(LogicalScan((), data=t, _schema=sch, num_slices=1,
                                 batch_rows=t.num_rows))


def collections_queries():
    """(name, DataFrame builder over the table, order-insensitive) of
    every expression, aggregate and generator of the slice."""
    from spark_rapids_tpu_torch import entry, types as T
    from spark_rapids_tpu_torch.expressions import col, lit
    from spark_rapids_tpu_torch.expressions import collections as C
    from spark_rapids_tpu_torch.expressions import aggregates as A
    from spark_rapids_tpu_torch.expressions.regex import StringSplit
    from spark_rapids_tpu_torch.expressions.strings import StringToMap
    ia, da, sa, m = col("ia"), col("da"), col("sa"), col("m")
    s2m = StringToMap(col("kv"))
    split = StringSplit(col("kv"), ",", max_elems=8)
    # a class with a repeat: matches of more than one byte
    split_rx = StringSplit(col("kv"), "[:,]+", max_elems=8)
    from spark_rapids_tpu_torch.expressions.json import json_tuple
    scan = collections_scan
    exprs = [
        C.CreateArray((C.Size(ia), C.Size(sa), lit(3))),
        C.Size(ia), C.Size(sa), C.Size(m),
        C.ArrayContains(ia, col("p")), C.ArrayContains(da, lit(1.5)),
        C.ArrayContains(sa, col("pw")),
        C.ElementAt(ia, col("i")), C.ElementAt(da, lit(-1)),
        C.ElementAt(sa, col("i")), C.GetArrayItem(ia, col("i")),
        C.GetArrayItem(sa, lit(1)),
        C.SortArray(ia, True), C.SortArray(ia, False),
        C.SortArray(da, False),
        C.ArrayMin(ia), C.ArrayMax(ia), C.ArrayMin(da), C.ArrayMax(da),
        C.CreateStruct((col("p"), col("pw"), ia), ("p", "pw", "ia")),
        C.GetStructField(col("st"), 0), C.GetStructField(col("st"), 1),
        C.MapKeys(m), C.MapValues(m), C.GetMapValue(m, col("mk")),
        C.MapContainsKey(m, col("mk")),
        C.MapFromArrays(ia, C.SortArray(ia, True)),
        split, C.Size(split), C.ElementAt(split, lit(1)),
        split_rx, C.ElementAt(split_rx, lit(-1)),
        s2m, C.GetMapValue(s2m, lit("k")), C.MapContainsKey(s2m, lit("a")),
        C.MapKeys(s2m), C.MapValues(s2m), C.Size(s2m)]

    return [
        ("expressions", lambda t: scan(t).select(
            *[e.alias(f"e{k}") for k, e in enumerate(exprs)]), False),
        ("collect_list", lambda t: scan(t).group_by("k").agg(
            A.CollectList(col("v"), max_elems=512).alias("l")), True),
        ("collect_set", lambda t: scan(t).group_by("k").agg(
            A.CollectSet(col("pw")).alias("s")), True),
        ("pivot_first", lambda t: scan(t).group_by("k").agg(
            A.PivotFirst(col("v"), col("mk"), (0, 3, 6, None))
            .alias("pv"), A.First(ia).alias("f"), A.Last(sa).alias("l"),
            A.Count(col("st")).alias("c")), True),
        ("explode array", lambda t: scan(t).select("k", "ia").explode(
            "ia", alias="x", outer=True, pos=True), False),
        ("explode map", lambda t: scan(t).select("k", "m").explode(
            "m", outer=True, pos=True), False),
        ("explode split", lambda t: scan(t).select("k", "kv").explode(
            split, alias="w", outer=True), False),
        ("lambdas and set operations", lambda t: scan(t).select(
            *[e.alias(f"h{k}") for k, e in enumerate(hof_exprs())]), False),
        ("json", lambda t: scan(t).select(
            *[e.alias(f"j{k}") for k, e in enumerate(json_exprs())],
            *json_tuple(col("doc"), "a", "s", "a.b")), False),
        ("explode replicaterows", lambda t: scan(t).select("k", "n").explode(
            C.ReplicateRows(col("n")), alias="r", pos=True), False),
        ("map lambdas and zip_with", lambda t: scan(t).select(
            *[e.alias(f"m{k}") for k, e in enumerate(map_hof_exprs())]),
         False)]


def hof_exprs():
    """Every lambda, set operation and shaping expression of the second
    half of ``collections.py`` that the row interpreter has, over
    ``collections_table``'s columns."""
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.expressions import col, lit
    from spark_rapids_tpu_torch.expressions import collections as C
    i64, f64 = T.INT64, T.FLOAT64
    ia, ib, da, db = col("ia"), col("ib"), col("da"), col("db")

    def hof(cls, arr, body, t=i64):
        x = C.hof_var(t)
        return cls(arr, x, body(x))

    def agg(arr, zero, merge, t=i64):
        acc, x = C.hof_var(t, "acc"), C.hof_var(t)
        return C.AggregateArray(arr, zero, acc, x, merge(acc, x))
    return [
        hof(C.TransformArray, ia, lambda x: x * lit(3, i64) + col("p")),
        hof(C.TransformArray, da, lambda x: x * lit(2.0), f64),
        hof(C.FilterArray, ia, lambda x: x > col("p")),
        hof(C.FilterArray, da, lambda x: x < lit(0.5), f64),
        hof(C.ExistsArray, ia, lambda x: x == col("p")),
        hof(C.ForallArray, da, lambda x: x < lit(4.0), f64),
        agg(ia, lit(0, i64), lambda s_, x: s_ + x),
        agg(da, lit(0.5), lambda s_, x: s_ + x * x, f64),
        agg(hof(C.TransformArray, ib, lambda x: x + col("n")), lit(0, i64),
            lambda s_, x: s_ * lit(2, i64) + x),
        C.ArrayDistinct(ia), C.ArrayDistinct(da),
        C.ArrayUnion(ia, ib), C.ArrayUnion(da, db),
        C.ArrayIntersect(ia, ib), C.ArrayIntersect(da, db),
        C.ArrayExcept(ia, ib), C.ArrayExcept(da, db),
        C.ArraysOverlap(ia, ib), C.ArraysOverlap(da, db),
        C.ArrayRemove(ia, col("p")), C.ArrayRemove(col("sa"), col("pw")),
        C.ArrayRemove(da, lit(float("nan"))),
        C.ArrayPosition(ia, col("p")), C.ArrayPosition(col("sa"), col("pw")),
        C.ArrayPosition(da, lit(float("nan"))),
        C.ArrayRepeat(col("p"), lit(3)),
        C.ArraySlice(ia, col("s"), col("l")),
        C.Sequence(col("lo"), col("hi"), max_elems=16),
        C.Sequence(col("lo"), col("hi"), col("step"), max_elems=16),
        C.Flatten(C.CreateArray((ia, ib))),
        C.Size(C.ArrayDistinct(C.Flatten(C.CreateArray((ia, ib)))))]


def map_hof_exprs():
    """The map lambdas and zip_with (no interpreter handler in either
    package: the card is held against the port's own CPU run)."""
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.expressions import Coalesce, col, lit
    from spark_rapids_tpu_torch.expressions import collections as C
    i32, i64 = T.INT32, T.INT64
    m = col("m")

    def map_hof(cls, body):
        k, v = C.hof_var(i32, "k"), C.hof_var(i64, "v")
        return cls(m, k, v, body(k, v))

    def zipped(a, b, body):
        x, y = C.hof_var(i64, "x"), C.hof_var(i64, "y")
        return C.ZipWith(a, b, x, y, body(x, y))
    return [
        map_hof(C.TransformKeys, lambda k, v: k + lit(1)),
        map_hof(C.TransformValues, lambda k, v: v * col("p")),
        map_hof(C.MapFilter, lambda k, v: v > col("p")),
        zipped(col("ia"), col("ib"), lambda x, y: Coalesce(
            (x, lit(0, i64))) + Coalesce((y, lit(0, i64)))),
        zipped(col("ia"), C.TransformArray(
            col("ia"), C.hof_var(i64), lit(1, i64)),
            lambda x, y: x * y)]


def json_exprs():
    """get_json_object over ``JSON_PATHS`` and from_json's fields (bound to
    get_json_object and a cast) over the phase's documents."""
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.expressions import col, lit
    from spark_rapids_tpu_torch.expressions import collections as C
    from spark_rapids_tpu_torch.expressions.json import (GetJsonObject,
                                                         JsonToStructs)
    js = JsonToStructs(col("doc"), T.struct(T.INT64, T.string(32), T.DATE),
                       ("a", "s", "d"))
    return [GetJsonObject(col("doc"), lit(p)) for p in JSON_PATHS] + [
        C.GetStructField(js, i) for i in range(3)]


def nested_rows_apart(got, want, unordered: bool) -> dict:
    """Rows apart per column of two tables of nested values (``repr``
    equality; an unordered result sorted by its first column first)."""
    g, w = got.to_pylist(), want.to_pylist()
    if unordered:
        first = got.column_names[0]
        g.sort(key=lambda r: (r[first] is None, r[first]))
        w.sort(key=lambda r: (r[first] is None, r[first]))
    if len(g) != len(w):
        return {"rows": abs(len(g) - len(w))}
    apart = {}
    for name in got.column_names:
        bad = sum(repr(a[name]) != repr(b[name]) for a, b in zip(g, w))
        if bad:
            apart[name] = bad
    return apart


#: the queries held against the port's own CPU run, which the
#: interpreter cannot run (no handler in either package)
COLLECTIONS_ON_CPU = ("map lambdas and zip_with",)


def run_collections_phase(dev) -> dict:
    """Every expression of ``collections.py`` and ``json.py``, split and
    str_to_map with their consumers, collect_list, collect_set,
    pivot_first, first/last over arrays, count of a struct, and explode
    of an array, a map, a split and ``replicaterows`` with ``outer`` and
    ``pos``, over ``COLLECTIONS_ROWS`` rows of ``collections_table`` (NaN
    among the doubles; empty and null arrays; documents with nesting,
    ``[i]`` paths, escapes, a ``\\u`` escape, blanks, null and garbage) on
    the card through the Session, against the port's row interpreter (the
    map lambdas and zip_with against the port's CPU run): 0 rows apart,
    nothing fallen back. Then slice with start 0 and a sequence past its
    budget fail on the card and on the interpreter."""
    import torch
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.batch import CapacityError
    from spark_rapids_tpu_torch.expressions import col, lit
    from spark_rapids_tpu_torch.expressions import collections as C
    from spark_rapids_tpu_torch.plan import Session
    conf = {"spark.rapids.tpu.sql.generate.maxRepeat": COLLECTIONS_BUDGET}
    t = collections_table(COLLECTIONS_ROWS)
    card_s = interp_s = 0.0
    report = []
    queries = collections_queries()
    for name, q, unordered in queries:
        ses = Session(conf, device=dev)
        t0 = time.perf_counter()
        got = ses.collect(q(t))
        torch.cuda.synchronize(dev)
        card_s += time.perf_counter() - t0
        if ses.fell_back():
            raise AssertionError(f"collections {name}: fell back "
                                 f"{ses.fell_back()}")
        t0 = time.perf_counter()
        against = ({**conf, **ORACLE_CONF}, dev) \
            if name not in COLLECTIONS_ON_CPU else (conf, "cpu")
        want = Session(*against).collect(q(t))
        interp_s += time.perf_counter() - t0
        apart = nested_rows_apart(got, want, unordered)
        if apart:
            raise AssertionError(f"collections {name}: the card differs "
                                 f"from the interpreter {apart}")
        report.append(f"{name} {got.num_columns} columns x {got.num_rows}"
                      f" rows")
    print(f"collections: {t.num_rows} rows; {'; '.join(report)}: 0 rows "
          f"apart from the interpreter ({', '.join(COLLECTIONS_ON_CPU)}: "
          f"from the port's CPU run) (card {card_s:.2f} s, interpreter "
          f"{interp_s:.2f} s)")
    edges = {"slice start 0": (C.ArraySlice(col("ia"), lit(0), lit(1)),
                               ArithmeticError, "SLICE_START_ZERO"),
             "sequence past its budget": (
                 C.Sequence(col("lo"), col("hi") + lit(40, T.INT64),
                            max_elems=16),
                 CapacityError, "CAPACITY_sequence_max_elems")}
    for what, (e, err, kind) in edges.items():
        for where in (conf, {**conf, **ORACLE_CONF}):
            try:
                Session(where, device=dev).collect(
                    collections_scan(t).select(e.alias("x")))
            except err as ex:
                if kind not in str(ex):
                    raise
            else:
                raise AssertionError(f"collections: {what} did not fail")
    print(f"collections: {' and '.join(edges)} fail on the card and on "
          f"the interpreter ({', '.join(k for *_, k in edges.values())})")
    return {}


# ---------------------------------------------------------------------------
# DECIMAL128: TPC-H Q18 in decimals at SF10, and the limb check
# ---------------------------------------------------------------------------

#: Q18 in decimals: scale factor, input slices, shuffle partitions, seed
#: (the draws of Q3's and Q18's seed)
Q18D_SF = 10
Q18D_SLICES = 8
Q18D_PARTITIONS = 8
Q18D_SEED = 3
#: rows of each leg's _hash_dec128 calls held against the scalar oracle,
#: and the most sampled from one call
HASH128_SAMPLE_ROWS = 1 << 16
HASH128_CALL_SAMPLE = 1 << 13
#: the byte-length edges of the DECIMAL128 hash (tests/test_decimal128.py)
HASH128_EDGES = [0, 1, -1, 127, 128, -128, -129, 255, 256, -256,
                 2**31 - 1, 2**31, -(2**31), 2**32 - 1, 2**32, -(2**32),
                 2**63 - 1, 2**63, -(2**63), 10**37, -(10**37),
                 3 * 10**37, -(3 * 10**37), 2**96 + 12345, -(2**96) - 99,
                 10**38 - 1, -(2**127)]


def checked_hash_dec128(record):
    """``_hash_dec128`` with a sample of each call's rows recorded for the
    scalar oracle: (limbs, seeds, hashes) of up to HASH128_CALL_SAMPLE
    random valid rows, and the call's inputs for the largest call."""
    import torch
    from spark_rapids_tpu_torch.expressions import hashing
    plain = hashing._hash_dec128

    def checked(col, seed):
        got = plain(col, seed)
        valid = torch.nonzero(col.validity).squeeze(1)
        if valid.numel():
            pick = valid[torch.randperm(valid.numel(), device=valid.device)
                         [:HASH128_CALL_SAMPLE]]
            record["rows"].append((col.data[pick].cpu(),
                                   seed[pick].cpu(), got[pick].cpu()))
        record["calls"].append(col.capacity)
        if col.capacity >= record.get("largest", (0,))[0]:
            record["largest"] = (col.capacity, col, seed)
        return got
    return checked


def check_hash_dec128_sample(what: str, record, dev) -> dict:
    """The recorded rows (at most HASH128_SAMPLE_ROWS of them) and the
    edge list hashed on the card, each against the scalar
    ``hash_decimal`` with its row's running seed: 0 apart. Then the device
    ms of the largest call (CUDA events)."""
    import numpy as np
    import torch
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.batch import DeviceColumn
    from spark_rapids_tpu_torch.expressions.decimal128 import (from_limbs_np,
                                                               to_limbs_np)
    from spark_rapids_tpu_torch.expressions.hashing import (_hash_dec128,
                                                            _seeds)
    from spark_rapids_tpu_torch.kernels.murmur3 import hash_decimal
    if not record["rows"]:
        raise AssertionError(f"{what}: _hash_dec128 was not called")
    limbs = torch.cat([r[0] for r in record["rows"]]).numpy()
    seeds = torch.cat([r[1] for r in record["rows"]]).numpy()
    got = torch.cat([r[2] for r in record["rows"]]).numpy()
    if len(got) > HASH128_SAMPLE_ROWS:
        keep = np.random.default_rng(0).choice(len(got), HASH128_SAMPLE_ROWS,
                                               replace=False)
        limbs, seeds, got = limbs[keep], seeds[keep], got[keep]
    edge = torch.from_numpy(to_limbs_np(HASH128_EDGES)).to(dev)
    ecol = DeviceColumn(edge, torch.ones(len(HASH128_EDGES), dtype=torch.bool,
                                         device=dev), T.decimal(38, 0))
    egot = _hash_dec128(ecol, _seeds(42, ecol.validity)).cpu().numpy()
    vals = from_limbs_np(limbs) + HASH128_EDGES
    seeds = seeds.tolist() + [42] * len(HASH128_EDGES)
    got = got.tolist() + egot.tolist()
    apart = sum(int(g != hash_decimal(v, 38, s))
                for v, s, g in zip(vals, seeds, got))
    cap, col, seed = record["largest"]
    ms = time_cuda_ms(lambda: _hash_dec128(col, seed), 5, 1)
    print(f"{what}: _hash_dec128 called {len(record['calls'])} times at "
          f"capacities {sorted(set(record['calls']))}; {len(vals)} rows "
          f"({len(HASH128_EDGES)} of them the edge list) against the scalar "
          f"hash_decimal: {apart} apart; device ms at capacity {cap}: "
          f"{ms:.4f}")
    if apart:
        raise AssertionError(f"{what}: _hash_dec128 differs from "
                             f"hash_decimal in {apart} rows")
    return {"apart": apart, "ms": ms, "capacity": cap}


def limb_sum_ms(dev, lineitem) -> None:
    """Device ms of the limb sum lanes at the inner group-by's PARTIAL
    shape: one slice's l_quantity (decimal(15, 2) widened to limbs) summed
    into its l_orderkey groups (``decimal128.seg_sum128``: one
    ``index_add_`` of [rows, 4] limbs, the negative count, the overflow
    rule) and the precision test, beside the int64 ``index_add_`` of the
    same values (CUDA events)."""
    import torch
    from spark_rapids_tpu_torch.batch import from_arrow
    from spark_rapids_tpu_torch.expressions.decimal128 import (
        exceeds_digits, lift64, seg_sum128)
    rows = -(-lineitem.num_rows // Q18D_SLICES)
    batch, _ = from_arrow(lineitem.slice(0, rows), device=dev)
    keys, qty = batch.columns
    live = batch.row_mask()
    change = torch.ones_like(live)
    change[1:] = keys.data[1:] != keys.data[:-1]
    seg = torch.cumsum(change & live, 0) - 1
    seg = seg.clamp(min=0)
    groups = int(seg.max()) + 1
    limbs = lift64(qty.data)

    def limb_lanes():
        s, ovf = seg_sum128(limbs, live, seg, groups)
        return ovf | exceeds_digits(s, 25)

    def int64_lane():
        out = torch.zeros(groups, dtype=torch.int64, device=dev)
        return out.index_add_(0, seg, torch.where(live, qty.data, 0))
    ms = time_cuda_ms(limb_lanes, 5, 1)
    ms64 = time_cuda_ms(int64_lane, 5, 1)
    print(f"q18 decimal: the limb sum lanes over one slice ({rows} rows, "
          f"capacity {batch.capacity}, {groups} l_orderkey groups): "
          f"{ms:.4f} ms on the card, the int64 index_add_ of the same "
          f"values {ms64:.4f} ms (CUDA events)")


def run_q18_decimal_phase(dev, counted, base, float_expected) -> list:
    """TPC-H Q18 at SF10 (59,986,052 lineitem rows, 8 slices) through the
    port's Session with ``entry.session_conf`` and AQE at the JAX default
    (on), in three legs over the Q18 phase's tables (``base``, from
    ``entry.tpch_q18_tables``) and its oracle's rows (``float_expected``):
    the spec's DECIMAL types (``entry.q18_decimal_of``: decimal(25, 2)
    limb sums, the HAVING a limb comparison against a rescaled
    decimal(3, 0) literal, o_totalprice decimal(15, 2) a group key and the
    sort key), the keys as decimal(38, 0) (limb keys sorted, grouped,
    joined and routed by ``_hash_dec128``), and the float64 Q18
    (``entry.q18_df``) as the baseline. Each leg: its rows exactly equal
    to its pyarrow oracle (100, ties as sets), ``fell_back()`` [] in the
    decimal legs, a cold and a profiled warm run (walls, peak, idle
    share). In the cold run every murmur3 launch is held against its plain
    version on its inputs, and in the decimal legs every ``_hash_dec128``
    call is sampled for the scalar ``hash_decimal``. Then the limb sum
    lanes' device ms. Returns each leg's launches."""
    from spark_rapids_tpu_torch import entry
    from spark_rapids_tpu_torch.expressions import hashing
    from spark_rapids_tpu_torch.plan import Session
    t0 = time.perf_counter()
    legs = {"spec": entry.q18_decimal_of(*base),
            "wide": entry.q18_decimal_of(*base, wide_keys=True),
            "float": base}
    print(f"q18 decimal: the SF{Q18D_SF} tables of the Q18 phase "
          f"({[t.num_rows for t in base]} customer, orders, lineitem rows) "
          f"in the decimal legs' types in {time.perf_counter() - t0:.2f} s")
    conf = entry.session_conf(Q18D_PARTITIONS, **{
        "spark.rapids.tpu.sql.adaptive.enabled": True})
    runs, stats = [], {}

    def check(got, expected):
        order = [(c, "ascending") for c in got.column_names]
        if got.schema != expected.schema or \
                not got.sort_by(order).equals(expected.sort_by(order)):
            raise AssertionError(f"Q18 differs from the pyarrow oracle:\n"
                                 f"{got.slice(0, 3)}\n"
                                 f"{expected.slice(0, 3)}")
        if got.num_rows != entry.Q18_LIMIT or not got.column(
                "o_totalprice").equals(expected.column("o_totalprice")):
            raise AssertionError("Q18: not 100 rows in the spec's order")
        return (f"; all {got.num_rows} rows exact, sum_qty "
                f"{got.schema.field('sum_qty').type}")

    for leg, tables in legs.items():
        ses = Session(conf, device=dev)
        if leg == "float":
            make_df = lambda t: entry.q18_df(*t, Q18D_SLICES)   # noqa: E731
            reference = lambda t: float_expected                # noqa: E731
        else:
            make_df = lambda t: entry.q18_decimal_df(  # noqa: E731
                *t, Q18D_SLICES)
            reference = lambda t: entry.q18_decimal_reference(*t)  # noqa
        hashed, record = [], {"rows": [], "calls": []}

        def run(t, ses=ses, make_df=make_df, leg=leg, hashed=hashed,
                record=record):
            collect = (lambda: ses.collect(make_df(t)))
            if hashed:                          # checked in the cold run
                out = collect()
            else:
                plain = hashing._hash_dec128
                hashing._hash_dec128 = checked_hash_dec128(record)
                try:
                    out = murmur3_checked(collect, hashed)
                finally:
                    hashing._hash_dec128 = plain
            if leg != "float" and ses.fell_back():
                raise AssertionError(f"q18 {leg} fell back: "
                                     f"{ses.fell_back()}")
            return out
        st = stats.setdefault(leg, {})
        runs.append(run_path(f"q18 decimal {leg}", lambda: tables,
                             reference, run, check, dev, counted,
                             rows_of=lambda t: t[2].num_rows, stats=st,
                             warm_runs=0))
        print(f"q18 decimal {leg}: fell_back() {ses.fell_back()}; key types "
              f"{[str(t.schema.field(0).type) for t in tables]}; the "
              f"Session's operators {ses.executed_exec_names()}")
        # the profiled run is the leg's warm run
        _, wall_us, busy, _ = profiled(lambda: run(tables), dev, host=False)
        st["warm_s"], st["idle"] = wall_us / 1e6, 1 - busy / wall_us
        print(f"q18 decimal {leg}: profiled warm run {wall_us / 1e3:.1f} "
              f"ms, {tables[2].num_rows / st['warm_s']:,.0f} rows/s, device "
              f"busy {busy / 1e3:.1f} ms, idle share {st['idle']:.1%}")
        report_murmur3(f"q18 decimal {leg}", hashed,
                       "o_orderdate at the final group-by's exchange")
        if leg == "wide":
            check_hash_dec128_sample(f"q18 decimal {leg}", record, dev)
        elif record["calls"]:
            raise AssertionError(f"q18 {leg}: _hash_dec128 ran over keys "
                                 f"that are not limbs")
    for leg in ("spec", "wide"):
        print(f"q18 decimal {leg}: warm {stats[leg]['warm_s']:.3f} s against "
              f"the float64 leg's {stats['float']['warm_s']:.3f} s "
              f"({stats[leg]['warm_s'] / stats['float']['warm_s']:.2f}x); "
              f"peak {stats[leg]['peak'] / 2**30:.2f} GiB against "
              f"{stats['float']['peak'] / 2**30:.2f} GiB; idle share "
              f"{stats[leg]['idle']:.1%} against "
              f"{stats['float']['idle']:.1%}")
    limb_sum_ms(dev, legs["spec"][2])
    return runs


#: rows of the limb check, wide_table's distribution: 2^17, where 2^20
#: took 124.7 s on the card's host (the row interpreter's sorts alone
#: 56 s), past the script's time
LIMB_ROWS = 1 << 17
LIMB_SLICES = 3


def limb_table(n: int, seed: int = 7):
    """``tests/test_decimal128.py``'s ``wide_table`` distribution at ``n``
    rows, drawn with numpy: k in 0..5, w decimal(38, 4) of 1 to 34 digits
    (uniform below 10^digits), signs mixed, every 11th row null; and b,
    decimal(25, 3), for the mixed-scale comparison. The limbs are built
    digit by digit (Horner's rule in four 32-bit limbs), with no Python
    int a row."""
    import numpy as np
    import pyarrow as pa
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.expressions.decimal128 import (MASK32,
                                                               limbs_to_arrow)

    def number(digits, rng, width):
        limbs = np.zeros((n, 4), np.int64)
        for j in range(width):
            dj = np.where(j >= width - digits, rng.integers(0, 10, n), 0)
            limbs = limbs * 10
            limbs[:, 0] += dj
            for i in range(3):          # carry into the next limb
                limbs[:, i + 1] += limbs[:, i] >> 32
                limbs[:, i] &= MASK32
            limbs[:, 3] &= MASK32
        neg = rng.random(n) < 0.5
        inv = (~limbs) & MASK32
        inv[:, 0] += 1
        for i in range(3):
            inv[:, i + 1] += inv[:, i] >> 32
            inv[:, i] &= MASK32
        inv[:, 3] &= MASK32
        return np.where(neg[:, None], inv, limbs)

    rng = np.random.default_rng(seed)
    k = rng.integers(0, 6, n).astype(np.int32)
    w = number(rng.integers(1, 35, n), rng, 34)
    b = number(rng.integers(1, 23, n), rng, 22)
    valid = np.arange(n) % 11 != 0
    return pa.table({
        "k": pa.array(k),
        "w": limbs_to_arrow(w, T.decimal(38, 4), valid),
        "b": limbs_to_arrow(b, T.decimal(25, 3), np.ones(n, bool))})


def check_limbs(dev) -> None:
    """DECIMAL128 on the card against the port's row interpreter
    (``sql.enabled=false``), 0 rows apart, at LIMB_ROWS rows of
    ``limb_table``: group-by Sum, Min, Max and Count on the int key; a
    group-by on the limb key through a LIMB_SLICES-slice hash exchange;
    the limb join key; ascending and descending sorts; ``w > 10^18 +
    0.0001``; the mixed-scale comparison against decimal(25, 3); and Sum
    into a null past 38 digits. Each on the card with nothing fallen
    back. Then a fused filter and project over the limbs, captured in a
    CUDA graph and replayed, against the iterator path."""
    import decimal
    import pyarrow as pa
    import torch
    from spark_rapids_tpu_torch import entry, types as T
    from spark_rapids_tpu_torch.batch import to_arrow
    from spark_rapids_tpu_torch.exec import (FilterExec, InMemoryScanExec,
                                             JoinType, ProjectExec, asc,
                                             collect, desc, try_fuse)
    from spark_rapids_tpu_torch.expressions import col, lit
    from spark_rapids_tpu_torch.expressions.aggregates import (Count, Max,
                                                               Min, Sum)
    from spark_rapids_tpu_torch.plan import Session, table
    t_all = time.perf_counter()
    t = limb_table(LIMB_ROWS)
    big = pa.table({"k": pa.array([0, 0, 1, 1, 2], pa.int32()),
                    "w": pa.array([decimal.Decimal(9 * 10**37)] * 2
                                  + [decimal.Decimal(-(10**37)),
                                     decimal.Decimal(7), None],
                                  pa.decimal128(38, 0))})
    bound = decimal.Decimal("1000000000000000000.0001")
    paths = {
        "group-by sum/min/max/count": lambda: table(t).group_by("k").agg(
            Sum(col("w")).alias("s"), Min(col("w")).alias("mn"),
            Max(col("w")).alias("mx"), Count(col("w")).alias("c")),
        "limb key through the exchange": lambda: table(
            t, num_slices=LIMB_SLICES).group_by("w").agg(
            Count().alias("c"), Max(col("k")).alias("mk")),
        "limb join key": lambda: table(t).join(
            table(t.slice(0, LIMB_ROWS // 4)).group_by("w").agg(
                Count().alias("n")).select(col("w").alias("w2"), "n"),
            [col("w")], [col("w2")], JoinType.INNER),
        "sort asc": lambda: table(t).order_by(asc(col("w"))),
        "sort desc": lambda: table(t).order_by(desc(col("w"))),
        "w > 10^18 + 0.0001": lambda: table(t).where(
            col("w") > lit(bound, T.decimal(38, 4))),
        "mixed scale vs decimal(25,3)": lambda: table(t).select(
            col("k"), (col("w") > col("b")).alias("gt"),
            (col("w") == col("b")).alias("eq"),
            (col("w") <= col("b")).alias("le")),
        "sum past 38 digits": lambda: table(big).group_by("k").agg(
            Sum(col("w")).alias("s")),
    }
    for name, make in paths.items():
        ses = Session(entry.session_conf(8), device=dev)
        t0 = time.perf_counter()
        got = ses.collect(make())
        torch.cuda.synchronize(dev)
        card_s = time.perf_counter() - t0
        if ses.fell_back():
            raise AssertionError(f"limbs {name}: fell back {ses.fell_back()}")
        t0 = time.perf_counter()
        want = Session(ORACLE_CONF, device=dev).collect(make())
        oracle_s = time.perf_counter() - t0
        ordered = name.startswith("sort")
        bad = (rows_apart(got.column("w"), want.column("w")) if ordered
               else differing_rows(got, want))
        if ordered:
            bad += differing_rows(got, want)
        print(f"limbs {name}: {got.num_rows} rows on the card "
              f"({card_s:.2f} s), {bad} apart from the interpreter "
              f"({oracle_s:.2f} s)")
        if bad or got.num_rows != want.num_rows:
            raise AssertionError(f"limbs {name}: the card differs from the "
                                 f"interpreter in {bad} rows")
        if name == "sum past 38 digits" and \
                got.sort_by("k").column("s").to_pylist()[0] is not None:
            raise AssertionError("limbs: a sum past 38 digits is not null")

    # limb lanes through a fused stage: planned eagerly, then captured in
    # a CUDA graph and replayed, each run equal to the iterator path
    def fused_plan():
        return ProjectExec([col("w"), col("k")], FilterExec(
            col("w") > lit(bound, T.decimal(38, 4)),
            InMemoryScanExec(t, device=dev)))
    stage = try_fuse(fused_plan())
    outs = [to_arrow(stage.run(), stage.plan.output_schema)
            for _ in range(3)]
    want = collect(fused_plan())
    same = all(o.equals(want) for o in outs)
    print(f"limbs fused stage (filter, project): {want.num_rows} rows; "
          f"{stage.captures} capture(s), {stage.replays} replay(s), every "
          f"run equal to the iterator path: {same}")
    if not same or stage.captures != (torch.device(dev).type == "cuda"):
        raise AssertionError("limbs: the captured fused stage differs from "
                             "the iterator path, or was not captured")
    print(f"limb check: {time.perf_counter() - t_all:.1f} s")


#: rows of the scalar phase's card-against-interpreter check: cut from
#: 2^16 to make room for [phase catalog], since the interpreter's row loop
#: took about 30 s of the phase's 34 s; every expression and every edge row
#: of scalar_table (its first rows) stays, only the random rows shrink
SCALAR_ROWS = 1 << 14
#: float tolerance of the scalar phase: both sides are IEEE libraries
SCALAR_REL_TOL = 1e-12


def scalar_table(n: int):
    """``n`` rows for the scalar expressions, from a numpy seed: dates
    (1700-2300, and the days around 1970), timestamps (1901-2099, where
    the zone tables hold; a microsecond before the epoch among them),
    strings (integers, dates, timestamps, garbage, empty), doubles with
    NaN, the infinities, -0.0, 1e300, MIN and MAX of int64, int64 with MIN
    and MAX, a boolean and an int32, each with nulls."""
    import datetime as dt
    import numpy as np
    import pyarrow as pa
    rng = np.random.default_rng(47)

    def nulls(frac=0.05):
        return rng.random(n) < frac

    d0 = (dt.date(1700, 1, 1) - dt.date(1970, 1, 1)).days
    d1 = (dt.date(2300, 1, 1) - dt.date(1970, 1, 1)).days
    days = rng.integers(d0, d1, n)
    days[:6] = [-1, 0, 1, -365, 11016, -25567]
    us = rng.integers(-2177452800 * 10**6, 4102444800 * 10**6, n)
    us[:4] = [-1, 0, 1, -31536000 * 10**6 + 500000]
    specials = np.array([np.nan, np.inf, -np.inf, 0.0, -0.0, 1e300, -1e300,
                         9.223372036854776e18, -9.223372036854776e18, 2.5,
                         -2.5, 0.5, 1.0, -1.0])
    x = rng.standard_normal(n) * np.exp(rng.uniform(-5, 12, n))
    x[:len(specials)] = specials
    pick = rng.random(n) < 0.05
    x[pick] = specials[rng.integers(0, len(specials), pick.sum())]
    y = rng.standard_normal(n) * np.exp(rng.uniform(-3, 3, n))
    y[rng.random(n) < 0.03] = np.nan
    i64 = rng.integers(-2**63, 2**63 - 1, n, dtype=np.int64,
                       endpoint=True)
    i64[:6] = [-2**63, 2**63 - 1, 0, -1, 1, 2**31]
    small = rng.random(n) < 0.5
    i64[small] = rng.integers(-100000, 100000, small.sum())
    words = np.array(["42", "-7", "+013", "  88  ", "12.9", "", "abc", "1 2",
                      "9223372036854775807", "-9223372036854775808",
                      "9223372036854775808", ".5", "-", "\t-5\n",
                      "2024-02-29", "2023-02-29", "1999-1-5", "2024-13-01",
                      "2020-03-04 05:06:07", "1969-12-31 23:59:59",
                      "00000000000000000001", "0001-01-01"], dtype=object)
    strs = words[rng.integers(0, len(words), n)]
    dated = rng.random(n) < 0.4
    fmt = (np.datetime64("1970-01-01") + days[dated]).astype(str)
    strs[dated] = fmt
    return pa.table({
        "d": pa.array(days.astype(np.int32), pa.int32(),
                      mask=nulls()).view(pa.date32()),
        "t": pa.array(us, pa.int64(), mask=nulls()).view(
            pa.timestamp("us", tz="UTC")),
        "s": pa.array(list(strs), pa.string(), mask=nulls()),
        "w": pa.array(list(words[rng.integers(0, len(words), n)]),
                      pa.string(), mask=nulls(0.3)),
        "x": pa.array(x, pa.float64(), mask=nulls()),
        "y": pa.array(y, pa.float64(), mask=nulls()),
        "i": pa.array(i64, pa.int64(), mask=nulls()),
        "b": pa.array(rng.random(n) < 0.5, pa.bool_(), mask=nulls()),
        "n": pa.array(rng.integers(-1200, 1201, n).astype(np.int32),
                      pa.int32(), mask=nulls()),
    })


def scalar_exprs():
    """Every expression of conditional.py, math.py, cast.py and
    datetime.py (each class, and every function, format and level the
    scalar_table's columns reach), as (expression, held against): "interp"
    for the port's row interpreter, "cpu" for the same Session on the
    CPU, bit for bit (Rand: the interpreter draws another sequence)."""
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.expressions import (
        AddMonths, Atan2, CaseWhen, Cast, Coalesce, FloorCeil, Hypot, If,
        LastDay, LeastGreatest, Logarithm, NaNvl, Pow, RaiseError, Rand,
        Round, Signum, UnaryMath, UnixTimestampConv, UTCTimestampConv, col,
        date_add, date_format, date_sub, date_trunc, datediff, dayofmonth,
        dayofweek, dayofyear, from_unixtime, hour, lit, minute, month,
        months_between, next_day, quarter, second, to_date, to_timestamp,
        trunc, unix_timestamp, weekofyear, year)
    d, t, s, w, x, y, i, b, n = (col(c) for c in "dtswxyibn")
    interp = [
        If(b, x, y), If(x > lit(0.0), i, Cast(n, T.INT64)), If(b, s, w),
        CaseWhen(((x > lit(1.0), x), (x < lit(-1.0), y)), lit(0.0)),
        CaseWhen(((b, s),), None), Coalesce((x, y, lit(0.0))),
        Coalesce((s, w)), LeastGreatest((x, y)),
        LeastGreatest((x, y), True), LeastGreatest((d, date_add(d, n))),
        LeastGreatest((i, Cast(n, T.INT64)), True),
        *[UnaryMath(x, f) for f in (
            "sqrt", "exp", "expm1", "sin", "cos", "tan", "asin", "acos",
            "atan", "sinh", "cosh", "tanh", "asinh", "acosh", "atanh",
            "cbrt", "rint", "degrees", "radians", "cot", "sec", "csc", "log",
            "log10", "log2", "log1p")],
        Pow(x, y), Atan2(x, y), Hypot(x, y), Logarithm(y, x), NaNvl(x, y),
        FloorCeil(x), FloorCeil(x, True), FloorCeil(i), Round(x, 2),
        Round(x, 0, True), Round(x, -2), Round(n, -1), Signum(x),
        RaiseError(lit(None, T.string(8))),
        Cast(x, T.INT64), Cast(x, T.INT32), Cast(x, T.INT8),
        Cast(i, T.INT32), Cast(i, T.INT8), Cast(i, T.INT16),
        Cast(x, T.FLOAT32), Cast(i, T.FLOAT64), Cast(x, T.BOOLEAN),
        Cast(t, T.DATE), Cast(d, T.TIMESTAMP), Cast(t, T.INT64),
        Cast(n, T.TIMESTAMP), Cast(s, T.INT64), Cast(s, T.INT32),
        Cast(s, T.DATE), Cast(i, T.string(20)), Cast(d, T.string(10)),
        Cast(n, T.decimal(10, 2)),
        # past the target's precision (and the rescale's int64 overflow):
        # null, as Spark and the interpreter give
        Cast(i, T.decimal(18, 2)), Cast(n, T.decimal(3, 0)),
        Cast(Cast(n, T.decimal(10, 2)), T.decimal(5, 2)),
        year(d), month(t), dayofmonth(d), quarter(d), dayofweek(t),
        dayofyear(d), weekofyear(d), hour(t), minute(t), second(t),
        date_add(d, n), date_sub(d, 30), datediff(d, date_add(d, n)),
        AddMonths(d, n), LastDay(d), UnixTimestampConv(t),
        UnixTimestampConv(d), UnixTimestampConv(n, to_unix=False),
        date_format(t, "yyyy-MM-dd HH:mm:ss.SSS"),
        date_format(d, "dd/MM/yyyy"), to_date(s),
        to_timestamp(s, "yyyy-MM-dd HH:mm:ss"), unix_timestamp(s),
        from_unixtime(UnixTimestampConv(t)), trunc(d, "quarter"),
        trunc(d, "week"), date_trunc("hour", t), date_trunc("month", t),
        months_between(t, d), months_between(d, AddMonths(d, n)),
        next_day(d, "tu"), next_day(t, "sunday"),
        UTCTimestampConv(t, "America/Los_Angeles"),
        UTCTimestampConv(t, "Europe/Berlin", to_utc=True),
        UTCTimestampConv(t, "Asia/Kolkata"),
    ]
    return [(e, "interp") for e in interp] + [(Rand(seed=17), "cpu"),
                                              (Rand(seed=2**31 + 3), "cpu")]


def float_rows_apart(a, b, rel: float) -> int:
    """Positions where two columns of one type differ: nulls equal nulls,
    NaN equals NaN, floats within ``rel`` (``math.isclose``), everything
    else exact; dates and timestamps compare as their stored integers.
    Vectorized: no value becomes a Python object (a zoned timestamp's
    conversion costs a module search a value on some hosts)."""
    import numpy as np
    import pyarrow as pa
    import pyarrow.compute as pc
    a, b = a.combine_chunks(), b.combine_chunks()
    t = a.type
    if pa.types.is_timestamp(t):
        a, b = a.cast(pa.int64()), b.cast(pa.int64())
    elif pa.types.is_date32(t):
        a, b = a.cast(pa.int32()), b.cast(pa.int32())
    na = np.asarray(a.is_null())
    nb = np.asarray(b.is_null())
    both = ~na & ~nb
    bad = int((na != nb).sum())
    if pa.types.is_null(a.type) or not both.any():
        return bad
    if pa.types.is_floating(a.type):
        u = np.asarray(a.fill_null(0.0), dtype=np.float64)[both]
        v = np.asarray(b.fill_null(0.0), dtype=np.float64)[both]
        with np.errstate(invalid="ignore"):
            same = (u == v) | (np.isnan(u) & np.isnan(v)) | (
                np.isfinite(u) & np.isfinite(v) &
                (np.abs(u - v) <= np.maximum(
                    rel * np.maximum(np.abs(u), np.abs(v)), 1e-300)))
        return bad + int((~same).sum())
    eq = np.asarray(pc.fill_null(pc.equal(a, b), False))
    return bad + int((~eq & both).sum())


def run_scalar_phase(dev) -> dict:
    """Every expression of the scalar slice (``scalar_exprs``) over
    ``SCALAR_ROWS`` rows of ``scalar_table`` on the card through the
    Session, as one fused stage captured in a CUDA graph, against the
    port's row interpreter (0 rows apart, floats within rel 1e-12), Rand
    against the same Session on the CPU bit for bit; and raise_error
    raising on the card and on the interpreter for a row that evaluates
    it."""
    import numpy as np
    import pyarrow as pa
    import torch
    from spark_rapids_tpu_torch import entry
    from spark_rapids_tpu_torch.exec import FusedStageExec
    from spark_rapids_tpu_torch.expressions import RaiseError, col
    from spark_rapids_tpu_torch.plan import Session
    conf = {"spark.rapids.tpu.sql.incompatibleOps.enabled": True}
    t = scalar_table(SCALAR_ROWS)
    exprs = scalar_exprs()
    df = entry._df(t, 1).select(*[e.alias(f"e{k}")
                                  for k, (e, _) in enumerate(exprs)])
    ses = Session(conf, device=dev)
    t0 = time.perf_counter()
    got = ses.collect(df)
    torch.cuda.synchronize(dev)
    cold_s = time.perf_counter() - t0
    print(f"scalar: the card's cold run {cold_s:.2f} s", flush=True)
    if ses.fell_back():
        raise AssertionError(f"scalar: fell back {ses.fell_back()}")
    fused = isinstance(ses.last_plan, FusedStageExec)
    t0 = time.perf_counter()
    again = ses.collect(df)
    torch.cuda.synchronize(dev)
    warm_s = time.perf_counter() - t0
    second = sum(float_rows_apart(again.column(k), got.column(k), 0.0)
                 for k in got.column_names)
    if second:
        raise AssertionError(f"scalar: a second run on the card differs in "
                             f"{second} values")
    print(f"scalar: the card's runs: cold {cold_s:.2f} s, warm "
          f"{warm_s:.3f} s", flush=True)
    t0 = time.perf_counter()
    want = Session({**conf, **ORACLE_CONF}, device=dev).collect(df)
    interp_s = time.perf_counter() - t0
    print(f"scalar: the interpreter {interp_s:.2f} s", flush=True)
    t0 = time.perf_counter()
    cpu_ses = Session(conf, device="cpu")
    cpu = cpu_ses.collect(df)
    print(f"scalar: the CPU {time.perf_counter() - t0:.2f} s", flush=True)
    if cpu_ses.executed_exec_names() != ses.executed_exec_names():
        raise AssertionError(f"scalar: the CPU's plan "
                             f"{cpu_ses.executed_exec_names()} is not the "
                             f"card's {ses.executed_exec_names()}")
    apart = {}
    for k, (e, held) in enumerate(exprs):
        name = f"e{k}"
        if held == "cpu":
            a = np.asarray(got.column(name).to_numpy(zero_copy_only=False))
            c = np.asarray(cpu.column(name).to_numpy(zero_copy_only=False))
            bad = int((a.view(np.int64) != c.view(np.int64)).sum())
        else:
            bad = float_rows_apart(got.column(name), want.column(name),
                                   SCALAR_REL_TOL)
        if bad:
            apart[f"{name} {e!r}"[:80]] = bad
    n_cpu = sum(held == "cpu" for _, held in exprs)
    print(f"scalar: {len(exprs)} expressions over {t.num_rows} rows on the "
          f"card ({'a fused stage' if fused else ses.executed_exec_names()}"
          f", cold {cold_s:.2f} s, warm {warm_s:.3f} s); "
          f"{len(exprs) - n_cpu} against the interpreter ({interp_s:.2f} "
          f"s), {n_cpu} (Rand) against the CPU bit for bit: rows apart "
          f"{apart or 0}")
    if apart:
        raise AssertionError(f"scalar: the card differs {apart}")
    # raise_error fails the query on the card and on the interpreter
    bad_rows = pa.table({"s": pa.array([None, "boom", None])})
    for what, c in (("card", conf), ("interpreter", {**conf,
                                                      **ORACLE_CONF})):
        print(f"scalar: raise_error on the {what}", flush=True)
        try:
            Session(c, device=dev).collect(entry._df(bad_rows, 1).select(
                RaiseError(col("s")).alias("e")))
        except Exception as ex:           # the error each side raises
            if "USER_RAISED_ERROR" not in str(ex):
                raise
        else:
            raise AssertionError(f"raise_error did not fail on the {what}")
    print("scalar: raise_error('boom') fails the query on the card and on "
          "the interpreter ([USER_RAISED_ERROR])")
    return {}


# ---------------------------------------------------------------------------
# The bench's hash_agg shape, the new operators, the fused Q1 stage
# ---------------------------------------------------------------------------

#: bench.bench_hash_agg: 4M rows over 1M keys, and the two-stage form's
#: slices and partitions
HASH_AGG_ROWS = 1 << 22
HASH_AGG_KEYS = 1 << 20
HASH_AGG_SLICES = 8
HASH_AGG_PARTITIONS = 8
#: one Q1 slice at SF10 (59,986,052 rows over 8 slices, capacity 2^23)
Q1_STAGE_ROWS = -(-SF10_LINEITEM_ROWS // Q1_SLICES)


def check_float_table(got, want, keys, what: str) -> float:
    """Two tables equal once sorted on ``keys``: every column but a double
    exactly, doubles within FLOAT_REL_TOL. Returns the largest relative
    float error."""
    import numpy as np
    import pyarrow as pa
    order = [(k, "ascending") for k in keys]
    a, b = got.sort_by(order), want.sort_by(order)
    if a.num_rows != b.num_rows or a.column_names != b.column_names:
        raise AssertionError(f"{what}: {a.num_rows} rows {a.column_names} "
                             f"against {b.num_rows} {b.column_names}")
    worst = 0.0
    for name in a.column_names:
        x, y = a.column(name), b.column(name)
        if x.null_count != y.null_count or not x.is_null().equals(
                y.is_null()):
            raise AssertionError(f"{what}: {name}'s nulls differ")
        if pa.types.is_floating(x.type):
            xv = x.fill_null(0.0).to_numpy()
            yv = y.fill_null(0.0).to_numpy()
            same = (xv == yv) | (np.isnan(xv) & np.isnan(yv))
            rel = np.where(same, 0.0, np.abs(xv - yv)
                           / np.maximum(np.abs(yv), 1e-300))
            worst = max(worst, float(rel.max(initial=0.0)))
            if not np.all(rel <= FLOAT_REL_TOL):
                raise AssertionError(f"{what}: {name} off by rel "
                                     f"{rel.max()}")
        elif not x.equals(y):
            raise AssertionError(f"{what}: {name} differs")
    return worst


def check_hash_agg(dev) -> None:
    """The bench's hash_agg shape at its 4M rows and 1M keys, COMPLETE and
    PARTIAL -> exchange -> FINAL, against pyarrow: keys, counts and integer
    sums exact, float sums and averages within FLOAT_REL_TOL."""
    import torch
    from spark_rapids_tpu_torch import entry
    from spark_rapids_tpu_torch.exec import collect
    table = entry.hash_agg_table(HASH_AGG_ROWS, HASH_AGG_KEYS)
    want = entry.hash_agg_reference(table)
    for two_stage in (False, True):
        label = "PARTIAL -> FINAL" if two_stage else "COMPLETE"
        walls = []
        for _ in range(3):
            t0 = time.perf_counter()
            got = collect(entry.hash_agg_plan(
                table, two_stage, HASH_AGG_SLICES, HASH_AGG_PARTITIONS,
                device=dev))
            torch.cuda.synchronize(dev)
            walls.append(time.perf_counter() - t0)
        worst = check_float_table(got, want, entry.HASH_AGG_KEYS,
                                  f"hash_agg {label}")
        warm = statistics.median(walls[1:])
        print(f"hash_agg {label}: {HASH_AGG_ROWS} rows, {got.num_rows} "
              f"groups, equal to pyarrow (float max rel err {worst:.3g}); "
              f"cold {walls[0]:.3f} s, warm {warm:.3f} s, "
              f"{HASH_AGG_ROWS / warm:,.0f} rows/s")


#: the operator check's nested-loop join: stream rows, build rows, slices
BNLJ_STREAM_ROWS = 1 << 16
BNLJ_BUILD_ROWS = 48
BNLJ_SLICES = 2
#: the top-N's limit
TOPN_LIMIT = 100


def operator_plans(table):
    """(name, plan maker, sort keys) of the operator check over the
    hash_agg table: every new aggregate (COMPLETE, and PARTIAL -> FINAL
    where it decomposes), the top-N, the partition-local sort, and the
    nested-loop join in every type. ``None`` keys: compare in order."""
    import numpy as np
    import pyarrow as pa
    from spark_rapids_tpu_torch.exec import (
        AggregateMode, BroadcastNestedLoopJoinExec, HashAggregateExec,
        InMemoryScanExec, JoinType, SortExec, SortOrder,
        TakeOrderedAndProjectExec)
    from spark_rapids_tpu_torch.expressions import LessThan, col
    from spark_rapids_tpu_torch.expressions import aggregates as A
    from spark_rapids_tpu_torch.shuffle import (BroadcastExchangeExec,
                                                HashPartitioning,
                                                ShuffleExchangeExec)
    key = [col("ss_item_sk")]

    def scan(t, d, slices=1):
        return InMemoryScanExec(t, batch_rows=-(-t.num_rows // slices),
                                num_slices=slices, device=d)

    def decomposable():
        return [A.Min(col("ss_quantity")).alias("min_q"),
                A.Max(col("ss_quantity")).alias("max_q"),
                A.Min(col("ss_sales_price")).alias("min_p"),
                A.Max(col("ss_sales_price")).alias("max_p"),
                A.VarianceSamp(col("ss_net_profit")).alias("var_s"),
                A.VariancePop(col("ss_net_profit")).alias("var_p"),
                A.StddevSamp(col("ss_quantity")).alias("sd_s"),
                A.StddevPop(col("ss_quantity")).alias("sd_p")]

    def complete(d):
        return HashAggregateExec(key, decomposable() + [
            A.First(col("ss_sales_price")).alias("first_p"),
            A.Last(col("ss_net_profit")).alias("last_n")], scan(table, d))

    def two_stage(d):
        partial = HashAggregateExec(key, decomposable(),
                                    scan(table, d, HASH_AGG_SLICES),
                                    AggregateMode.PARTIAL)
        return HashAggregateExec(key, decomposable(), ShuffleExchangeExec(
            HashPartitioning(key, HASH_AGG_PARTITIONS), partial),
            AggregateMode.FINAL)

    def percentile(approx):
        def make(d):
            fn = (A.ApproxPercentile(col("ss_sales_price"), 0.25, 100)
                  if approx else A.Percentile(col("ss_net_profit"), 0.5))
            return HashAggregateExec(key, [fn.alias("pct")], scan(table, d))
        return make

    orders = [SortOrder(col("ss_net_profit"), True),
              SortOrder(col("ss_sales_price")), SortOrder(col("ss_item_sk"))]

    def topn(d):
        return TakeOrderedAndProjectExec(
            TOPN_LIMIT, orders, [col("ss_item_sk"), col("ss_net_profit")],
            scan(table, d, HASH_AGG_SLICES))

    def local_sort(d):
        return SortExec(orders, scan(table, d, HASH_AGG_SLICES),
                        global_sort=False)

    stream = table.slice(0, BNLJ_STREAM_ROWS)
    rng = np.random.default_rng(23)
    build = pa.table({"w": pa.array(rng.integers(0, 100, BNLJ_BUILD_ROWS),
                                    mask=rng.random(BNLJ_BUILD_ROWS) < 0.1),
                      "f": rng.uniform(0, 1, BNLJ_BUILD_ROWS)})

    def nested(how):
        def make(d):
            return BroadcastNestedLoopJoinExec(
                how, scan(stream, d, BNLJ_SLICES),
                BroadcastExchangeExec(scan(build, d)),
                LessThan(col("ss_quantity"), col("w")))
        return make

    keys = ["ss_item_sk"]
    plans = [("aggregates COMPLETE", complete, keys),
             ("aggregates PARTIAL -> FINAL", two_stage, keys),
             ("percentile", percentile(False), keys),
             ("approx_percentile", percentile(True), keys),
             ("top-N", topn, None),
             ("partition-local sort", local_sort, None)]
    for how in JoinType:
        plans.append((f"nested-loop join {how.name}", nested(how),
                      [c for c in ("ss_item_sk", "ss_quantity",
                                   "ss_sales_price", "ss_net_profit", "w",
                                   "f", "exists")]))
    return plans


def check_operators(dev) -> None:
    """Each new operator on the card against the port on the CPU over the
    same input: 0 rows apart (doubles within FLOAT_REL_TOL: the card's
    group sums add in another order)."""
    import torch
    from spark_rapids_tpu_torch import entry
    from spark_rapids_tpu_torch.exec import collect
    t_all = time.perf_counter()
    table = entry.hash_agg_table(HASH_AGG_ROWS, HASH_AGG_KEYS)
    for name, make, keys in operator_plans(table):
        t0 = time.perf_counter()
        got = collect(make(dev))
        torch.cuda.synchronize(dev)
        card_s = time.perf_counter() - t0
        want = collect(make("cpu"))
        if keys is None:
            if not got.equals(want):
                raise AssertionError(f"{name}: the card's rows or their "
                                     f"order differ from the CPU's")
            worst = 0.0
        else:
            keys = [k for k in keys if k in got.column_names]
            worst = check_float_table(got, want, keys, name)
        print(f"operators, {name}: {got.num_rows} rows on the card, 0 apart "
              f"from the CPU (float max rel err {worst:.3g}); card "
              f"{card_s:.3f} s")
    print(f"operator check: {time.perf_counter() - t_all:.1f} s")


#: edge rows of the arithmetic check: int64 and int32 extremes, 0 and -1
#: divisors, NaN, infinities and signed zeros, shift amounts around the
#: widths
ARITH_INT64 = [(-(1 << 63), -1), (-(1 << 63), 2), (-(1 << 63), 3),
               ((1 << 63) - 1, -1), (-7, -3), (7, -3), (-7, 3), (0, 0),
               (5, 0), (-(1 << 62), 2), (1, -(1 << 63)), (None, 4),
               (3, None), (1 << 40, 64), (-1, 63), (123, -1)]
ARITH_INT32 = [(-(1 << 31), -1), (-(1 << 31), 3), ((1 << 31) - 1, 2),
               (-7, -3), (5, 0), (46341, 46341), (-1, 31), (1, 32),
               (9, -33), (None, 1)]
ARITH_DOUBLE = [(7.5, 2.0), (-7.5, -2.0), (1.0, 0.0), (1.0, -0.0),
                (float("nan"), 1.0), (1.0, float("nan")),
                (float("inf"), 2.0), (2.0, float("inf")), (-0.0, 3.0),
                (None, 1.0)]


def arithmetic_plans():
    """(name, plan maker) of every arithmetic expression of the port over
    the edge rows, outside ANSI mode."""
    import pyarrow as pa
    from spark_rapids_tpu_torch.exec import InMemoryScanExec, ProjectExec
    from spark_rapids_tpu_torch.expressions import arithmetic as A
    from spark_rapids_tpu_torch.expressions import col

    def table(rows, typ):
        a, b = zip(*rows)
        return pa.table({"a": pa.array(a, typ), "b": pa.array(b, typ)})
    tables = {"int64": table(ARITH_INT64, pa.int64()),
              "int32": table(ARITH_INT32, pa.int32()),
              "double": table(ARITH_DOUBLE, pa.float64())}
    binary = [A.Add, A.Subtract, A.Multiply, A.Divide, A.IntegralDivide,
              A.Remainder, A.Pmod]
    plans = []
    for tname, t in tables.items():
        exprs = [cls(col("a"), col("b")) for cls in binary]
        exprs += [A.UnaryMinus(col("a")), A.Abs(col("a"))]
        if tname != "double":
            exprs += [A.BitwiseOp(col("a"), col("b"), op)
                      for op in ("and", "or", "xor")]
            exprs += [A.BitwiseNot(col("a"))]
            exprs += [A.Shift(col("a"), col("b"), op)
                      for op in ("left", "right", "right_unsigned")]
        for i, e in enumerate(exprs):
            plans.append((f"{tname} {type(e).__name__}"
                          f"{' ' + e.op if hasattr(e, 'op') else ''}",
                          lambda d, e=e, t=t: ProjectExec(
                              [e.alias("r")], InMemoryScanExec(t, device=d))))
    return plans


def _equal_nan(got, want) -> bool:
    """Two tables equal in every row: integers exactly, doubles as values
    with their sign (NaN equal to NaN)."""
    import numpy as np
    import pyarrow as pa
    if got.num_rows != want.num_rows or \
            got.column_names != want.column_names:
        return False
    for x, y in zip(got.columns, want.columns):
        if not x.is_null().equals(y.is_null()):
            return False
        valid = ~np.asarray(x.is_null())
        xv = x.to_numpy(zero_copy_only=False)[valid]
        yv = y.to_numpy(zero_copy_only=False)[valid]
        if pa.types.is_floating(x.type):
            nan = np.isnan(xv)
            if not (np.array_equal(nan, np.isnan(yv))
                    and np.array_equal(xv[~nan], yv[~nan])
                    and np.array_equal(np.signbit(xv[~nan]),
                                       np.signbit(yv[~nan]))):
                return False
        elif not np.array_equal(xv, yv):
            return False
    return True


def check_new_operators(dev) -> None:
    """``UnionExec``, ``RangeExec``, ``ExpandExec`` and ``SampleExec`` on
    the card against the CPU (the sample seeded: the same rows twice, a
    subset in input order), every arithmetic expression over its edge rows
    card against CPU, and the ANSI errors (overflow, divide by zero)
    raising ``ArithmeticException`` with the JAX package's kind names in a
    ``ProjectExec`` and in a fused stage on the card."""
    import numpy as np
    import pyarrow as pa
    import torch
    from spark_rapids_tpu_torch import entry, types as T
    from spark_rapids_tpu_torch.exec import (ArithmeticException, ExpandExec,
                                             InMemoryScanExec, ProjectExec,
                                             RangeExec, SampleExec,
                                             UnionExec, collect, try_fuse)
    from spark_rapids_tpu_torch.expressions import col, lit
    from spark_rapids_tpu_torch.expressions.arithmetic import (Divide,
                                                               Multiply)
    from spark_rapids_tpu_torch.expressions.base import EvalContext
    t_all = time.perf_counter()
    table = entry.hash_agg_table(1 << 20, 1 << 16)

    def scan(t, d, slices=1):
        return InMemoryScanExec(t, batch_rows=-(-t.num_rows // slices),
                                num_slices=slices, device=d)
    plans = [
        ("union", lambda d: UnionExec([scan(table, d, 4),
                                       scan(table.slice(0, 1000), d)])),
        ("range", lambda d: RangeExec(-5, 3_000_000, 3, batch_rows=1 << 20,
                                      device=d)),
        ("expand", lambda d: ExpandExec(
            [[col("ss_item_sk"), lit(None, T.INT64)],
             [col("ss_item_sk"), col("ss_quantity")]], scan(table, d, 2))),
    ] + arithmetic_plans()
    for name, make in plans:
        got = collect(make(dev))
        want = collect(make("cpu"))
        if not _equal_nan(got, want):
            raise AssertionError(f"{name}: the card differs from the CPU")
    print(f"new operators: union, range, expand and {len(plans) - 3} "
          f"arithmetic expressions over edge rows, card equal to the CPU")

    def sample(d, fraction=0.3, seed=42, slices=1, n=4_000_000):
        ids = RangeExec(0, n, batch_rows=1 << 20, device=d)
        if slices > 1:
            ids = scan(collect(ids), d, slices)
        return SampleExec(fraction, seed, ids)
    s1, s2 = collect(sample(dev)), collect(sample(dev))
    ids = s1.column("id").to_numpy()
    if not (s1.equals(s2) and np.all(np.diff(ids) > 0)
            and 0.29 < len(ids) / 4_000_000 < 0.31):
        raise AssertionError("sample: not a seeded subset in input order")
    # the draws are the JAX package's threefry stream: the card keeps the
    # CPU's rows exactly
    kept = []
    for fraction, seed, slices in ((0.1, 5, 3), (0.5, 123456, 1),
                                   (0.01, 7, 4)):
        on_card = collect(sample(dev, fraction, seed, slices, 1 << 20))
        if not on_card.equals(collect(sample("cpu", fraction, seed, slices,
                                             1 << 20))):
            raise AssertionError(f"sample ({fraction}, {seed}, {slices} "
                                 f"slices): the card keeps other rows than "
                                 f"the CPU")
        kept.append(on_card.num_rows)
    print(f"sample 0.3 of 4,000,000 ids on the card: {len(ids)} rows, a "
          f"seeded subset in input order; over 2^20 ids, (fraction, seed, "
          f"slices) (0.1, 5, 3), (0.5, 123456, 1), (0.01, 7, 4) keep {kept} "
          f"rows, each the CPU's rows exactly")

    t = pa.table({"a": pa.array([1, 2, 1 << 62], pa.int64()),
                  "z": pa.array([1, 0, 2], pa.int64())})
    for expr, kind in ((Multiply(col("a"), lit(4)), "ARITHMETIC_OVERFLOW"),
                       (Divide(col("a"), col("z")), "DIVIDE_BY_ZERO")):
        for how in ("ProjectExec", "fused stage"):
            plan = ProjectExec([expr.alias("x")],
                               InMemoryScanExec(t, device=dev),
                               ctx=EvalContext(True))
            try:
                if how == "ProjectExec":
                    collect(plan)
                else:
                    try_fuse(plan).run()
            except ArithmeticException as e:
                if kind not in str(e):
                    raise AssertionError(f"{how}: raised {e}, not {kind}")
                print(f"ANSI {kind} on the card, {how}: {e}")
            else:
                raise AssertionError(f"{how}: {kind} did not raise")
    torch.cuda.synchronize(dev)
    print(f"new-operator check: {time.perf_counter() - t_all:.1f} s")


def check_q1_stage(dev) -> None:
    """``entry.q1_stage`` (the filter fused into the COMPLETE aggregate's
    update) on one SF10 lineitem slice, on CUDA events, then its FINAL
    against pyarrow."""
    import pyarrow as pa
    import pyarrow.compute as pc
    from spark_rapids_tpu_torch import entry
    from spark_rapids_tpu_torch.batch import from_arrow, to_arrow
    table = entry.lineitem_table(Q1_STAGE_ROWS, DATA_SEED)
    batch, schema = from_arrow(table, device=dev)
    stage, _, final, _ = entry.q1_stage(schema, device=dev)
    ms = time_cuda_ms(lambda: stage(batch), 10)
    got = to_arrow(final._merge_kernel(stage(batch), final=True),
                   final.output_schema)
    f = table.filter(pc.less_equal(table.column("l_shipdate"),
                                   entry.Q1_SHIPDATE_MAX))
    disc = pc.multiply(f.column("l_extendedprice"),
                       pc.subtract(1.0, f.column("l_discount")))
    g = f.append_column("disc", disc).group_by(list(entry.Q1_KEYS)) \
        .aggregate([("l_quantity", "sum"), ("l_extendedprice", "sum"),
                    ("disc", "sum"), ("l_quantity", "mean"),
                    ("l_discount", "mean"), ("l_quantity", "count")])
    want = pa.table([g.column(c) for c in (
        "l_returnflag", "l_linestatus", "l_quantity_sum",
        "l_extendedprice_sum", "disc_sum", "l_quantity_mean",
        "l_discount_mean", "l_quantity_count")], names=got.column_names)
    worst = check_float_table(got, want, list(entry.Q1_KEYS), "q1_stage")
    print(f"q1_stage: one SF10 slice, {Q1_STAGE_ROWS} rows at capacity "
          f"{batch.capacity}: {got.num_rows} groups equal to pyarrow (float "
          f"max rel err {worst:.3g}); fused update {ms:.3f} ms on CUDA "
          f"events, {Q1_STAGE_ROWS / ms * 1e3:,.0f} rows/s")


# ---------------------------------------------------------------------------
# The fused stage captured in a CUDA graph: join_sort and its checks
# ---------------------------------------------------------------------------

#: profiler ranges the port opens around operators and join steps; the
#: profiler mirrors them onto the device timeline, where they are not work
PROFILER_RANGES = ("SortExec", "HashAggregateExec", "ShuffleExchangeExec",
                   "CoalesceBatchesExec", "FilterExec", "InMemoryScanExec",
                   "HashJoinExec", "ProjectExec", "GlobalLimitExec",
                   "LocalLimitExec", "BroadcastExchangeExec",
                   "BroadcastNestedLoopJoinExec", "TakeOrderedAndProjectExec",
                   "HashJoinExec.build", "HashJoinExec.count",
                   "HashJoinExec.expand", "HashJoinExec.grace_split",
                   "FileSourceScanExec[parquet]", "MeshStageExec",
                   "mesh_exchange", "mesh_broadcast")
#: the prefix of a CPU fallback island's range (``CpuFallback[Filter]``):
#: host work, though the profiler mirrors it onto the device timeline
ISLAND_RANGE = "CpuFallback["


def busy_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


#: the kernel that brackets every profiled run (``torch.cuda._sleep``);
#: nothing in the port launches it
SENTINEL_KERNEL = "spin_kernel"
#: its length in device cycles: a few microseconds
SENTINEL_CYCLES = 10_000
#: tries at one profile before it fails
PROFILE_TRIES = 6
#: the profiler range around the call itself inside ``capture``
CALL_RANGE = "chip_smoke.capture"
#: how ``capture`` opens and closes its window: the tiny kernels launched
#: before the first sentinel, and the seconds of host idle after the last.
#: Each doubles when its sentinel goes missing, and stays grown for later
#: calls, since the losses grow as the process runs.
_window = {"lead": 256, "pad": 0.02}


class DeviceRecord:
    """One record of a profile's device timeline: its ``name`` and its
    ``time_range`` (``start`` and ``end`` in us, ``elapsed_us()``), as a
    ``FunctionEvent`` of ``prof.events()`` has them."""
    __slots__ = ("name", "time_range")

    def __init__(self, name, time_range):
        self.name = name
        self.time_range = time_range


def device_records(prof) -> list:
    """Every record of a profile on the device timeline, read from the
    profiler's raw results: ``prof.events()`` first builds the host's
    event tree, which takes tens of seconds at 100,000 records."""
    import torch
    from torch.autograd.profiler_util import Interval
    cuda = torch.autograd.DeviceType.CUDA
    return [DeviceRecord(e.name(), Interval(
                e.start_ns() / 1e3, (e.start_ns() + e.duration_ns()) / 1e3))
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == cuda]


def device_events(records) -> list:
    """The kernels, copies and memsets of ``device_records``, without the
    operators' ranges that the profiler mirrors onto the device timeline
    and without the sentinels and the call's range of ``capture``."""
    return [e for e in records
            if e.name not in PROFILER_RANGES and e.name != CALL_RANGE
            and not e.name.startswith(ISLAND_RANGE)
            and SENTINEL_KERNEL not in e.name]


def capture(fn, dev, host: bool = True):
    """(profile, host wall us, result, device records of the call) of one
    call of ``fn`` under ``torch.profiler``, with every record of the call.

    The profiler drops the device records it finds outside its window, and
    on the H100 it finds some there: the first few records of a session
    (late in a long run, every record of the bench's scan at its own
    size), now and then the last. So the call is bracketed by a
    sentinel kernel on each side, each followed by a synchronize; a lead of
    tiny kernels before the first sentinel takes the losses at the start,
    and idle host time after the last those at the end. While a sentinel
    is missing, the call is profiled again with its side's lead or pad
    doubled. The call's records are those between the sentinels; on the
    host, the call runs under the range ``CALL_RANGE``.
    ``host=False`` records the device's activity alone, which reads back
    far quicker when a run launches hundreds of thousands of kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    activities = [ProfilerActivity.CUDA]
    if host:
        activities.append(ProfilerActivity.CPU)
    lead_buf = torch.zeros(1, dtype=torch.int32, device=dev)
    for _ in range(PROFILE_TRIES):
        lead, pad = _window["lead"], _window["pad"]
        with profile(activities=activities) as prof:
            for _ in range(lead):
                lead_buf.fill_(0)
            torch.cuda._sleep(SENTINEL_CYCLES)
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            with record_function(CALL_RANGE):
                out = fn()
                torch.cuda.synchronize(dev)
            wall_us = (time.perf_counter() - t0) * 1e6
            torch.cuda._sleep(SENTINEL_CYCLES)
            torch.cuda.synchronize(dev)
            time.sleep(pad)
        timeline = device_records(prof)
        records = device_events(timeline)
        marks = sorted((e.time_range for e in timeline
                        if SENTINEL_KERNEL in e.name),
                       key=lambda r: r.start)
        if len(marks) == 2:
            first, last = marks
            inside = [e for e in records if e.time_range.start >= first.end
                      and e.time_range.end <= last.start]
            # outside the sentinels lie the lead's kernels, no more
            if len(records) - len(inside) > lead:
                raise RuntimeError(
                    f"{len(records) - len(inside) - lead} device records "
                    f"of the call fell outside its sentinels")
            return prof, wall_us, out, inside
        # a lone sentinel with records after it opened the call
        lost_first = not marks or not any(
            e.time_range.start >= marks[0].end for e in records)
        lost_last = len(marks) != 1 or not lost_first
        if lost_first:
            _window["lead"] = 2 * lead
        if lost_last:
            _window["pad"] = 2 * pad
        lost = " and ".join(side for side, gone in (
            ("first", lost_first), ("last", lost_last)) if gone)
        print(f"profiler: the {lost} sentinel fell outside the window "
              f"(lead {lead} kernels, pad {pad:.2f} s); "
              f"profiling again with lead {_window['lead']}, pad "
              f"{_window['pad']:.2f} s")
    raise RuntimeError(f"the profiler dropped a sentinel kernel "
                       f"{PROFILE_TRIES} times, the last with a lead of "
                       f"{lead} kernels and a pad of {pad:.2f} s")


def profiled(fn, dev, host: bool = True):
    """(profile, host wall us, device busy us, device records) of one call
    of ``fn`` through ``capture``; fails if the device did nothing."""
    prof, wall_us, _, events = capture(fn, dev, host)
    if not events:
        raise RuntimeError("the profiler recorded no device activity")
    busy = busy_us([(e.time_range.start, e.time_range.end) for e in events])
    return prof, wall_us, busy, events


#: (stream rows, build rows) of the join_sort runs: bench.bench_join_sort's
#: size, and TPC-H SF10's lineitem probing its orders (the Q3/Q10 shape)
JOIN_SORT_SIZES = ((1 << 21, 1 << 18), (SF10_LINEITEM_ROWS, 15_000_000))
#: up to this many stream rows the three modes run and the graph's rows are
#: held against pyarrow; above it (SF10) the graph and the eager program
#: run and hold each other, without the oracle (13.8 s) and the iterator's
#: grace join (cut to make room for [phase windows] and [phase zorder]):
#: the smaller size holds the same program against pyarrow
JOIN_SORT_ORACLE_MAX_ROWS = 1 << 21
JOIN_SORT_BIG_MODES = ("graph", "eager")


def check_join_sort_result(got, want) -> int:
    """The fused or iterator rows against pyarrow's: row count, l_revenue
    exact and in order, o_orderkey equal to l_orderkey, and (l_orderkey,
    o_custkey) exact, compared as sets within each run of equal revenue.
    Returns the rows in ties."""
    import numpy as np
    if got.num_rows != want.num_rows:
        raise AssertionError(f"join_sort: {got.num_rows} rows, pyarrow "
                             f"{want.num_rows}")
    rev = got.column("l_revenue").to_numpy()
    if not np.array_equal(rev, want.column("l_revenue").to_numpy()):
        raise AssertionError("join_sort: l_revenue differs or is out of "
                             "order")
    keys = got.column("l_orderkey").to_numpy()
    if not np.array_equal(keys, got.column("o_orderkey").to_numpy()):
        raise AssertionError("join_sort: o_orderkey differs from the key")
    mine = np.stack([keys, got.column("o_custkey").to_numpy()], 1)
    theirs = np.stack([want.column("l_orderkey").to_numpy(),
                       want.column("o_custkey").to_numpy()], 1)
    tie = np.zeros(len(rev), bool)
    tie[1:] = rev[1:] == rev[:-1]
    tie[:-1] |= tie[1:]
    if not np.array_equal(mine[~tie], theirs[~tie]):
        raise AssertionError("join_sort: keys or o_custkey differ")
    idx = np.flatnonzero(tie)
    if len(idx):
        group = np.cumsum(np.r_[True, rev[idx][1:] != rev[idx][:-1]])
        a, b = mine[idx], theirs[idx]
        oa = np.lexsort((a[:, 1], a[:, 0], group))
        ob = np.lexsort((b[:, 1], b[:, 0], group))
        if not np.array_equal(a[oa], b[ob]):
            raise AssertionError("join_sort: rows within a revenue tie "
                                 "differ")
    return len(idx)


def _same_batch(a, b) -> bool:
    """Two device batches hold the same live rows."""
    import torch
    n = int(a.num_rows)
    if n != int(b.num_rows):
        return False
    return all(torch.equal(x.data[:n], y.data[:n])
               and torch.equal(x.validity[:n], y.validity[:n])
               for x, y in zip(a.columns, b.columns))


def run_join_sort_phase(dev, n_stream: int, n_build: int) -> dict:
    """The bench's join+sort stage at one size, three ways: the fused stage
    captured in a CUDA graph, the eager fused program and the iterator
    path (above ``JOIN_SORT_ORACLE_MAX_ROWS`` the first two alone). The
    graph's first (cold) result is checked against pyarrow (above that
    size: not), every other result against it on the device; prints each
    mode's warm
    median wall (three warm calls after the cold one), stream rows/s, the
    CUDA-event time of one graph replay, the allocator's peak, and, from
    one warm run profiled on the device, the device kernels and copies per
    run, device busy time and idle share. Returns {mode: warm
    seconds}."""
    import torch
    from spark_rapids_tpu_torch import entry
    from spark_rapids_tpu_torch.batch import to_arrow
    name = f"join_sort {n_stream} x {n_build}"
    t0 = time.perf_counter()
    stream, build = entry.join_sort_tables(n_stream, n_build)
    gen_s = time.perf_counter() - t0
    full = n_stream <= JOIN_SORT_ORACLE_MAX_ROWS
    t0 = time.perf_counter()
    want = entry.join_sort_reference(stream, build) if full else None
    oracle_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    plan = entry.join_sort_plan(stream, build, dev)
    torch.cuda.synchronize(dev)
    oracle = (f"pyarrow oracle {oracle_s:.2f} s ({want.num_rows} rows)"
              if full else "no oracle (the graph's rows against the eager "
              "program's)")
    print(f"{name}: tables made in {gen_s:.2f} s, {oracle}, uploaded once "
          f"in {time.perf_counter() - t0:.2f} s")
    del stream, build
    walls, checked = {}, None
    modes = entry.JOIN_SORT_MODES if full else JOIN_SORT_BIG_MODES
    for mode in modes:
        run = entry.join_sort_runner(plan, mode)
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        cold = run()
        torch.cuda.synchronize(dev)
        cold_s = time.perf_counter() - t0
        if checked is None:
            verdict = "equal to the eager program's rows"
            if full:
                ties = check_join_sort_result(
                    to_arrow(cold, plan.output_schema), want)
                verdict = (f"equal to pyarrow ({ties} rows in revenue "
                           f"ties, compared as sets)")
            checked = cold
            del want
        elif not _same_batch(cold, checked):
            raise AssertionError(f"{name} {mode}: differs from the graph's "
                                 f"rows")
        warm = []
        for _ in range(3):
            t0 = time.perf_counter()
            out = run()
            torch.cuda.synchronize(dev)
            warm.append(time.perf_counter() - t0)
            if not _same_batch(out, cold):
                raise AssertionError(f"{name} {mode}: a warm run differs "
                                     f"from the checked cold run")
        del out
        peak = torch.cuda.max_memory_allocated(dev)
        wall = statistics.median(warm)
        walls[mode] = wall
        line = (f"{name} {mode}: {verdict}; cold {cold_s * 1e3:.3f} ms, warm "
                f"median {wall * 1e3:.3f} ms of "
                f"{[round(w * 1e3, 3) for w in warm]}, "
                f"{n_stream / wall:,.0f} stream rows/s; device memory peak "
                f"{peak / 2**30:.3f} GiB")
        # the device's activity alone: at SF10 the iterator launches
        # about 450,000 kernels (the grace join, the out-of-core sort),
        # whose host-side events take minutes to read back
        _, prof_us, busy, events = profiled(run, dev, host=False)
        line += (f"; profiled run: {len(events)} device kernels and "
                 f"copies, wall {prof_us / 1e3:.3f} ms, busy "
                 f"{busy / 1e3:.3f} ms, idle share "
                 f"{1 - busy / prof_us:.1%} (against the warm wall "
                 f"{1 - busy / (wall * 1e6):.1%})")
        if mode != "iterator":
            stage = run.stage
            line += (f"; stage: factor {stage.expand_factor}, "
                     f"{stage.captures} capture(s), {stage.retries} "
                     f"re-plan(s)")
        if mode == "graph":
            program, _ = stage.prepare()
            replay_ms = time_cuda_ms(program, reps=10)
            line += (f"; one replay on CUDA events {replay_ms:.3f} ms; "
                     f"host launches per run: 1 graph replay, 1 flag read, "
                     f"{len(plan.output_schema)} column copies")
        print(line)
        del run, cold
    del checked
    plan.close()
    return walls


def check_overflow_retry(dev) -> None:
    """``test_fuse.py``'s 8x expansion on the card at 1,048,576 stream
    rows: the 1x bucket overflows, the flag trips, the stage is planned and
    captured again at the needed factor, and its rows equal pyarrow's."""
    import numpy as np
    import pyarrow as pa
    from spark_rapids_tpu_torch.batch import to_arrow
    from spark_rapids_tpu_torch.exec import (HashJoinExec, InMemoryScanExec,
                                             JoinType, SortExec, desc,
                                             try_fuse)
    from spark_rapids_tpu_torch.expressions import col
    n = 1 << 20
    stream = pa.table({"k": np.arange(n, dtype=np.int64) % 16,
                       "v": np.arange(n, dtype=np.float64)})
    build = pa.table({"bk": np.repeat(np.arange(16, dtype=np.int64), 8),
                      "w": np.arange(128, dtype=np.int64)})
    plan = SortExec([desc(col("v"))], HashJoinExec(
        [col("k")], [col("bk")], JoinType.INNER,
        InMemoryScanExec(stream, device=dev),
        InMemoryScanExec(build, device=dev)))
    stage = try_fuse(plan, expand_factor=1)
    first = to_arrow(stage.run(), plan.output_schema)
    second = to_arrow(stage.run(), plan.output_schema)
    want = stream.join(build, keys="k", right_keys="bk", join_type="inner")

    def canon(t):
        cols = [t.column(c).to_numpy() for c in ("k", "v", "w")]
        order = np.lexsort((cols[2], -cols[1]))
        return np.stack([c[order].astype(np.float64) for c in cols])
    if stage.retries != 1 or stage.expand_factor != 8 or stage.captures != 1:
        raise AssertionError(f"overflow retry: {stage.retries} re-plans at "
                             f"factor {stage.expand_factor}, "
                             f"{stage.captures} captures")
    if not (first.num_rows == second.num_rows == want.num_rows == 8 * n
            and np.array_equal(canon(first), canon(want))
            and second.equals(first)):
        raise AssertionError("overflow retry: rows differ from pyarrow")
    print(f"overflow retry: {n} stream rows x 8 matches each overflowed the "
          f"1x bucket, the flag tripped, one re-plan captured at factor "
          f"{stage.expand_factor}; {first.num_rows} rows equal to pyarrow, "
          f"the replay equal to the first run")


def _captured_check(name, make_plan, wrapper, kernel_vs_plain) -> dict:
    """A fused stage that launches ``wrapper``'s kernel: run, captured and
    replayed; its rows equal the iterator path's; the capture recorded the
    kernel; the kernel equals its plain version on the stage's own input
    (``kernel_vs_plain(stage)`` returns the mismatches). Returns the
    kernel's launches in the run: the eager run's, and the capture's
    times the replays."""
    from spark_rapids_tpu_torch.batch import to_arrow
    from spark_rapids_tpu_torch.exec import collect, try_fuse
    wrapper.launches = 0
    plan = make_plan()
    stage = try_fuse(plan)
    runs = [to_arrow(stage.run(), plan.output_schema) for _ in range(3)]
    host_calls = wrapper.launches
    captured = stage.capture_launches[wrapper.__name__]
    launches = host_calls - captured + captured * stage.replays
    want = collect(make_plan())
    bad = kernel_vs_plain(stage)
    print(f"captured {name}: {runs[0].num_rows} rows; every run (eager, "
          f"then {stage.replays} replays) equal to the iterator path: "
          f"{all(r.equals(want) for r in runs)}; {wrapper.__name__} "
          f"recorded {captured} time(s) by the capture, {launches} launches "
          f"in the run; kernel against its plain version on the stage's "
          f"input: {bad} mismatches")
    if not all(r.equals(want) for r in runs) or captured <= 0 or bad:
        raise AssertionError(f"captured {name} failed")
    return {wrapper.__name__: launches}


#: the captured two-int32-key join: stream and build rows, key domains
HASHED_STREAM_ROWS = 1 << 22
HASHED_BUILD_ROWS = 1 << 18


def check_captured_murmur3(dev) -> dict:
    """A fused join on two int32 keys (the hashed probe: ``_hash64`` ->
    ``hash_column`` -> ``murmur3_int32``), then a sort, captured."""
    import numpy as np
    import pyarrow as pa
    import torch
    from spark_rapids_tpu_torch.exec import (HashJoinExec, InMemoryScanExec,
                                             JoinType, SortExec, desc)
    from spark_rapids_tpu_torch.expressions import col
    from spark_rapids_tpu_torch.kernels.murmur3 import (
        murmur3_int32, murmur3_int32_plain)
    rng = np.random.default_rng(29)
    n, m = HASHED_STREAM_ROWS, HASHED_BUILD_ROWS
    stream = pa.table({
        "a": rng.integers(0, 1 << 16, n).astype(np.int32),
        "b": rng.integers(0, 8, n).astype(np.int32),
        "v": rng.uniform(0, 1, n)})
    build = pa.table({
        "a2": rng.permutation(1 << 16).repeat(m >> 16).astype(np.int32),
        "b2": np.tile(np.arange(8, dtype=np.int32), m // 8),
        "w": np.arange(m, dtype=np.int64)})

    def make_plan():
        return SortExec([desc(col("v"))], HashJoinExec(
            [col("a"), col("b")], [col("a2"), col("b2")], JoinType.INNER,
            InMemoryScanExec(stream, device=dev),
            InMemoryScanExec(build, device=dev)))

    def kernel_vs_plain(stage):
        a = stage.inputs[0].columns[0]
        seeds = torch.full_like(a.data, 42)
        return int((murmur3_int32(a.data, a.validity, seeds)
                    != murmur3_int32_plain(a.data, a.validity, seeds)).sum())
    return _captured_check("two-int32-key join", make_plan, murmur3_int32,
                           kernel_vs_plain)


def check_captured_window_match(dev, part) -> dict:
    """Q2's part filter (p_size = 15 AND endswith(p_type, 'BRASS')) and a
    projection over one Q2 part slice, captured: ``window_match`` at
    k = 5."""
    from spark_rapids_tpu_torch import entry
    from spark_rapids_tpu_torch.batch import from_arrow
    from spark_rapids_tpu_torch.exec import (FilterExec, InMemoryScanExec,
                                             ProjectExec)
    from spark_rapids_tpu_torch.expressions import (And, EqualTo, col,
                                                    endswith, lit)
    from spark_rapids_tpu_torch.kernels.string_search import (
        window_match, window_match_plain)
    batch, schema = from_arrow(part.slice(0, -(-part.num_rows // Q2_SLICES)),
                               string_max_len=entry.STRING_MAX_LEN,
                               device=dev)

    def make_plan():
        cond = And(EqualTo(col("p_size"), lit(15)),
                   endswith(col("p_type"), Q2_PATTERN.decode()))
        return ProjectExec([col("p_partkey"), col("p_mfgr"), col("p_type")],
                           FilterExec(cond, InMemoryScanExec(
                               [batch], schema=schema)))

    def kernel_vs_plain(stage):
        t = stage.inputs[0].columns[schema.index_of("p_type")]
        return int((window_match(t.data, t.lengths, Q2_PATTERN)
                    != window_match_plain(t.data, t.lengths, Q2_PATTERN))
                   .sum())
    return _captured_check("Q2 part filter", make_plan, window_match,
                           kernel_vs_plain)


# ---------------------------------------------------------------------------
# Adaptive execution: the skewed join, the types exchange, the range sort
# ---------------------------------------------------------------------------

#: the repo's skew shape (BENCH_skew.json ``params``: 131,072 fact rows,
#: 4,096 keys, 32 partitions, hot fraction 0.5, seed 29, splitRows 16,384)
#: scaled to 2^26 fact rows with its ratios kept: 32 fact rows per key, 16
#: fact slices (tools/skew_bench._query), splitRows rows / 8, and the
#: adaptive_bcast leg's maxBuildRows max(keys, 2^16)
SKEW_ROWS = 1 << 26
SKEW_KEYS = SKEW_ROWS // 32
SKEW_HOT_FRAC = 0.5
SKEW_SEED = 29
SKEW_SPLIT_ROWS = SKEW_ROWS // 8


def run_skew_phase(dev, counted) -> list:
    """The skew bench's query at 67,108,864 x 2,097,152 rows in its three
    legs: each leg's cold run (launch counts from 0) equal to pyarrow and
    bit for bit to the other legs, its decisions, the wall of one warm
    run, rows/s and allocator peak, and the device idle share of one
    profiled warm run of the last leg; in each cold run every murmur3
    launch (the aggregate's exchange) is held against its plain version.
    Returns the launches of each leg's cold run."""
    import torch
    from spark_rapids_tpu_torch import adaptive, entry
    t0 = time.perf_counter()
    fact, dim = entry.skew_tables(SKEW_ROWS, SKEW_KEYS, SKEW_HOT_FRAC,
                                  SKEW_SEED)
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    want = entry.skew_reference(fact, dim)
    print(f"skew: {fact.num_rows} fact rows ({SKEW_HOT_FRAC:.0%} on key 0),"
          f" {dim.num_rows} dim rows, {entry.SKEW_PARTITIONS} partitions, "
          f"{entry.SKEW_SLICES} fact slices, splitRows {SKEW_SPLIT_ROWS}; "
          f"made in {gen_s:.2f} s, pyarrow oracle "
          f"{time.perf_counter() - t0:.2f} s ({want.num_rows} groups)")
    first, launches = None, []
    for leg in entry.SKEW_LEGS:
        def run():
            return entry.run_skew(fact, dim, leg, split_rows=SKEW_SPLIT_ROWS,
                                  device=dev)
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        for wrapper in counted:
            wrapper.launches = 0
        mark = adaptive.reason_mark()
        hashed = []
        t0 = time.perf_counter()
        got = murmur3_checked(run, hashed)
        cold_s = time.perf_counter() - t0
        decisions = adaptive.reasons(since=mark)
        counts = {w.__name__: w.launches for w in counted}
        if not got.equals(want):
            raise AssertionError(f"skew {leg} differs from pyarrow")
        if first is not None and not got.equals(first):
            raise AssertionError(f"skew {leg} differs from the static leg")
        first = got if first is None else first
        for kernel, n in counts.items():
            if n <= 0:
                raise AssertionError(f"{kernel} was not launched by the "
                                     f"skew {leg} run")
        if (leg == "static") != (not decisions):
            raise AssertionError(f"skew {leg}: decisions {decisions}")
        # one warm run a leg, and the profiled run on the last leg only,
        # within the script's time limit (three warm runs and a profile of
        # each leg gave 66-76% idle in every leg)
        t0 = time.perf_counter()
        if not run().equals(want):
            raise AssertionError(f"skew {leg}: the warm run differs")
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated(dev)
        print(f"skew {leg}: equal to pyarrow and to the static leg, bit for "
              f"bit; kernel launches {counts}; decisions {decisions}")
        print(f"skew {leg}: cold {cold_s:.3f} s (murmur3 checked), warm "
              f"{wall:.3f} s, {SKEW_ROWS / wall:,.0f} fact rows/s; device "
              f"memory peak {peak / 2**30:.2f} GiB")
        if hashed or any(counts.values()):
            report_murmur3(f"skew {leg}", hashed, "the aggregate's exchange")
        if leg == entry.SKEW_LEGS[-1]:
            _, prof_us, busy, events = profiled(run, dev, host=False)
            print(f"skew {leg}: profiled run: {len(events)} device kernels "
                  f"and copies, wall {prof_us / 1e6:.3f} s, busy "
                  f"{busy / 1e6:.3f} s, idle share {1 - busy / prof_us:.1%}"
                  f" (against the warm wall "
                  f"{1 - busy / (wall * 1e6):.1%})")
        launches.append(counts)
    return launches


#: the types exchange: one column of each new kind at the SF10 lineitem
#: row count, each hash-partitioned alone; the card's partition counts over
#: a 2^22-row prefix equal the CPU's
TYPES_ROWS = SF10_LINEITEM_ROWS
TYPES_PREFIX = 1 << 22
TYPES_SLICES = 8
TYPES_PARTITIONS = 8
TYPES_SEED = 41


def types_table(n: int, seed: int):
    """int8, int16, float32 (with NaN, infinities and -0.0), DECIMAL(15,2),
    timestamp and an all-null column, about 5% nulls in each; the decimal
    built from its unscaled int64 buffer."""
    import numpy as np
    import pyarrow as pa
    rng = np.random.default_rng(seed)

    def mask():
        return rng.random(n) < 0.05
    f = rng.standard_normal(n).astype(np.float32)
    f[:4] = [np.nan, np.inf, -np.inf, -0.0]
    valid = ~mask()
    unscaled = np.where(valid, rng.integers(-10 ** 15 + 1, 10 ** 15, n), 0)
    words = np.stack([unscaled, unscaled >> 63], axis=1)
    dec = pa.Array.from_buffers(
        pa.decimal128(15, 2), n,
        [pa.py_buffer(np.packbits(valid, bitorder="little").tobytes()),
         pa.py_buffer(words.tobytes())])
    return pa.table({
        "i8": pa.array(rng.integers(-128, 128, n, dtype=np.int8),
                       mask=mask()),
        "i16": pa.array(rng.integers(-32768, 32768, n, dtype=np.int16),
                        mask=mask()),
        "f32": pa.array(f, mask=mask()),
        "d15": dec,
        "ts": pa.array(rng.integers(-2 ** 60, 2 ** 60, n),
                       pa.timestamp("us", tz="UTC"), mask=mask()),
        "nul": pa.nulls(n),
    })


def check_types_exchange(dev, murmur3) -> dict:
    """Each new kind hash-partitioned alone into 8 partitions: at the SF10
    lineitem row count on the card (every row routed), and over a 2^22-row
    prefix on the card and on the CPU, whose partition row counts and
    partition ids row for row must be equal. int8, int16 and float32 keys
    must launch murmur3 at full size. Returns the launches of the
    full-size exchanges."""
    import torch
    from spark_rapids_tpu_torch.batch import from_arrow
    from spark_rapids_tpu_torch.exec import InMemoryScanExec
    from spark_rapids_tpu_torch.expressions import col
    from spark_rapids_tpu_torch.shuffle import (HashPartitioning,
                                                ShuffleExchangeExec)
    t0 = time.perf_counter()
    table = types_table(TYPES_ROWS, TYPES_SEED)
    print(f"types exchange: {TYPES_ROWS} rows of {table.schema.types} made "
          f"in {time.perf_counter() - t0:.2f} s")

    def counts(t, device):
        ex = ShuffleExchangeExec(
            HashPartitioning([col(t.column_names[0])], TYPES_PARTITIONS),
            InMemoryScanExec(t, batch_rows=-(-t.num_rows // TYPES_SLICES),
                             num_slices=TYPES_SLICES, device=device))
        try:
            return ex.partition_row_counts()
        finally:
            ex.close()

    def ids(t, device):
        """The prefix's partition id per row, from one batch."""
        batch, schema = from_arrow(t, device=device)
        part = HashPartitioning([col(t.column_names[0])],
                                TYPES_PARTITIONS).bind(schema)
        return part.partition_ids(batch)[:t.num_rows]

    total = 0
    for name in table.column_names:
        one = table.select([name])
        murmur3.launches = 0
        t0 = time.perf_counter()
        full = counts(one, dev)
        torch.cuda.synchronize(dev)
        full_s = time.perf_counter() - t0
        launched = murmur3.launches
        total += launched
        if sum(full) != TYPES_ROWS:
            raise AssertionError(f"types exchange {name}: {sum(full)} rows "
                                 f"routed of {TYPES_ROWS}")
        prefix = one.slice(0, TYPES_PREFIX)
        card, cpu = counts(prefix, dev), counts(prefix, "cpu")
        if card != cpu:
            raise AssertionError(f"types exchange {name}: card {card} != "
                                 f"CPU {cpu}")
        apart = int((ids(prefix, dev).cpu() != ids(prefix, "cpu")).sum())
        if apart:
            raise AssertionError(f"types exchange {name}: {apart} rows of "
                                 f"the prefix routed apart on the card and "
                                 f"the CPU")
        if name in ("i8", "i16", "f32") and launched <= 0:
            raise AssertionError(f"types exchange {name}: murmur3_int32 was "
                                 f"not launched")
        print(f"types exchange {name} ({one.schema.types[0]}): {full_s:.3f} s"
              f" for {TYPES_ROWS} rows, partition rows {full}; murmur3_int32"
              f" launches {launched}; the {TYPES_PREFIX}-row prefix: card "
              f"{card} == CPU, and its partition ids row for row")
    return {"murmur3_int32": total}


#: range exchange plus a partition-local sort, over the first 2^24 rows of
#: Q3's SF10 lineitem, against pyarrow's global sort
RANGE_ROWS = 1 << 24
RANGE_SLICES = 8
RANGE_PARTITIONS = 8


def check_range_sort(dev, lineitem) -> None:
    """``tests/test_shuffle.py``'s range-plus-local-sort shape at 2^24
    rows: four keys (date ascending, int64 descending, two doubles), whose
    concatenated partitions equal pyarrow's sort row for row."""
    import pyarrow as pa
    from spark_rapids_tpu_torch.batch import to_arrow
    from spark_rapids_tpu_torch.exec import InMemoryScanExec, SortExec
    from spark_rapids_tpu_torch.exec.sort import asc, desc
    from spark_rapids_tpu_torch.expressions import col
    from spark_rapids_tpu_torch.shuffle import (RangePartitioning,
                                                ShuffleExchangeExec)
    t = lineitem.slice(0, RANGE_ROWS).combine_chunks()
    keys = [("l_shipdate", "ascending"), ("l_orderkey", "descending"),
            ("l_extendedprice", "ascending"), ("l_discount", "ascending")]
    orders = [(asc if d == "ascending" else desc)(col(k)) for k, d in keys]
    t0 = time.perf_counter()
    want = t.sort_by(keys)
    oracle_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ex = ShuffleExchangeExec(
        RangePartitioning(orders, RANGE_PARTITIONS),
        InMemoryScanExec(t, batch_rows=RANGE_ROWS // RANGE_SLICES,
                         num_slices=RANGE_SLICES, device=dev))
    plan = SortExec(orders, ex, global_sort=False)
    try:
        parts = [[to_arrow(b, plan.output_schema)
                  for b in plan.execute_partition(p)]
                 for p in range(RANGE_PARTITIONS)]
    finally:
        plan.close()
    run_s = time.perf_counter() - t0
    got = pa.concat_tables([b for p in parts for b in p])
    if not got.equals(want):
        raise AssertionError("range exchange plus local sort differs from "
                             "pyarrow's global sort")
    sizes = [sum(b.num_rows for b in p) for p in parts]
    print(f"range sort: {RANGE_ROWS} rows in {RANGE_PARTITIONS} range "
          f"partitions {sizes}, each sorted alone, equal row for row to "
          f"pyarrow's global sort on {[k for k, _ in keys]}; {run_s:.2f} s "
          f"(pyarrow {oracle_s:.2f} s)")


# ---------------------------------------------------------------------------
# the Parquet slice: bucketed write, the bench's scan, Q1 and Q16's part
# stage read from files
# ---------------------------------------------------------------------------

#: the bucketed write: lineitem from an 8-slice scan into 16 buckets on
#: l_shipdate, SNAPPY (8 tasks x 16 bucket files)
PARQUET_WRITE_SLICES = 8
PARQUET_BUCKETS = 16
#: the bucketed write's rows: a 2^24-row prefix of the SF10 lineitem (cut
#: from all 59,986,052 to make room for [phase order lines] and
#: [phase json q1]; the scans below read their own files)
PARQUET_WRITE_ROWS = 1 << 24
#: bench.bench_parquet_scan's size and file count, and the SF10 files
PARQUET_BENCH_ROWS = 1 << 21
PARQUET_FILES = 8
#: Q1 and Q16's part stage from files: scan partitions and shuffle
#: partitions, as in memory
PARQUET_SLICES = 8
PARQUET_PARTITIONS = 8


def same_rows(got, want, dev, what: str) -> None:
    """``got`` and ``want`` (pyarrow tables of integer and double columns,
    no nulls) hold the same multiset of rows: both are sorted on the card
    by every column (doubles by their bits) and compared column for
    column."""
    import numpy as np
    import torch
    if got.column_names != want.column_names:
        raise AssertionError(f"{what}: columns {got.column_names} != "
                             f"{want.column_names}")
    if got.num_rows != want.num_rows:
        raise AssertionError(f"{what}: {got.num_rows} rows != "
                             f"{want.num_rows}")

    def sorted_columns(t):
        cols = []
        for name in t.column_names:
            c = t.column(name)
            if c.null_count:
                raise AssertionError(f"{what}: {name} holds nulls")
            a = np.ascontiguousarray(c.to_numpy())
            a = a.view(np.int64) if a.dtype == np.float64 else a
            cols.append(torch.from_numpy(a).to(dev))
        order = torch.arange(t.num_rows, device=dev)
        for x in reversed(cols):
            order = order[torch.sort(x[order], stable=True).indices]
        return [x[order] for x in cols]

    for name, a, b in zip(got.column_names, sorted_columns(got),
                          sorted_columns(want)):
        if not torch.equal(a, b):
            raise AssertionError(f"{what}: column {name} differs as a "
                                 f"multiset of rows")


def check_native_decode(what: str, paths) -> int:
    """Every row group of every file decodes through the port's native
    decoder (``read_row_group_native`` gives a table, never the pyarrow
    fallback's None), on the shared reader pool. Returns the row groups."""
    import pyarrow.parquet as pq
    from spark_rapids_tpu_torch.io.parquet_native import \
        read_row_group_native
    from spark_rapids_tpu_torch.io.source import reader_pool

    def one(path):
        schema = pq.read_schema(path)
        n = pq.ParquetFile(path).metadata.num_row_groups
        for rg in range(n):
            t = read_row_group_native(path, rg, schema.names, schema)
            if t is None:
                raise AssertionError(f"{what}: row group {rg} of {path} "
                                     f"is outside the native decoder")
        return n
    groups = sum(reader_pool(8).map(one, paths))
    print(f"{what}: all {groups} row groups of {len(paths)} files decode "
          f"natively")
    return groups


def no_fallback(what: str, plan) -> None:
    """No row group of ``plan``'s file scans took the pyarrow fallback."""
    for scan in _execs(plan, "FileSourceScanExec[parquet]"):
        if scan.source.row_groups_fallback:
            raise AssertionError(
                f"{what}: {scan.source.row_groups_fallback} row groups "
                f"took the pyarrow fallback")


def run_parquet_write_phase(dev, counted, table, out) -> dict:
    """The bucketed write of ``table`` (a prefix of the SF10 lineitem,
    ``PARQUET_WRITE_ROWS``) under ``out``:
    ``WriteStats`` must count every row in 8 x 16 files; every file read
    back through the port's ``ParquetSource`` must hold only rows whose
    bucket id, from ``murmur3_int32`` on the card, equals the plain
    version's and the file's bucket number; and the files' rows together
    must equal the input as a multiset. Returns the write's launches."""
    import pyarrow as pa
    import torch
    from spark_rapids_tpu_torch import entry
    from spark_rapids_tpu_torch.batch import to_arrow
    from spark_rapids_tpu_torch.expressions.hashing import (DEFAULT_SEED,
                                                            int32_words)
    from spark_rapids_tpu_torch.io.parquet import ParquetSource
    from spark_rapids_tpu_torch.io.scan import FileSourceScanExec
    from spark_rapids_tpu_torch.kernels.murmur3 import (murmur3_int32,
                                                        murmur3_int32_plain)
    n = table.num_rows
    torch.cuda.reset_peak_memory_stats(dev)
    for wrapper in counted:
        wrapper.launches = 0
    t0 = time.perf_counter()
    stats = entry.write_lineitem_bucketed(table, out, PARQUET_BUCKETS,
                                          PARQUET_WRITE_SLICES, device=dev)
    wall = time.perf_counter() - t0
    launches = {w.__name__: w.launches for w in counted}
    peak = torch.cuda.max_memory_allocated(dev)
    print(f"parquet write: {stats.describe()} in {wall:.3f} s, "
          f"{n / wall:,.0f} rows/s, {stats.num_bytes / wall / 1e6:,.1f} MB/s"
          f" written; device memory peak {peak / 2**30:.2f} GiB; kernel "
          f"launches {launches}")
    want_files = PARQUET_WRITE_SLICES * PARQUET_BUCKETS
    if (stats.num_rows, stats.num_files, stats.num_tasks) != (
            n, want_files, PARQUET_WRITE_SLICES):
        raise AssertionError(f"parquet write: {stats.describe()}, not {n} "
                             f"rows in {want_files} files")
    for kernel, count in launches.items():
        if count <= 0:
            raise AssertionError(f"{kernel} was not launched by the "
                                 f"bucketed write")

    t0 = time.perf_counter()
    key = table.column_names.index(entry.BUCKET_KEY)
    pieces, worst, batches = [], 0, 0
    for path in stats.files:
        bucket = int(path.rsplit("_", 1)[1].split(".")[0])
        scan = FileSourceScanExec(ParquetSource([path]), device=dev)
        for batch in scan.execute():
            c = batch.columns[key]
            seed = torch.full((batch.capacity,), DEFAULT_SEED,
                              dtype=torch.int32, device=dev)
            args = (int32_words(c), c.validity.contiguous(), seed)
            k, plain = murmur3_int32(*args), murmur3_int32_plain(*args)
            worst = max(worst, int((k.long() - plain.long()).abs().max()))
            live = batch.row_mask()
            ids = torch.remainder(k, PARQUET_BUCKETS)
            if bool((live & (ids != bucket)).any()):
                raise AssertionError(f"parquet write: {path} holds rows of "
                                     f"another bucket than {bucket}")
            pieces.append(to_arrow(batch, scan.output_schema))
            batches += 1
        no_fallback("parquet write read-back", scan)
    if worst:
        raise AssertionError(f"murmur3_int32 disagrees with its plain "
                             f"version on the written files ({worst})")
    same_rows(pa.concat_tables(pieces), table, dev, "parquet write")
    print(f"parquet write: {len(stats.files)} files read back through "
          f"ParquetSource in {time.perf_counter() - t0:.2f} s "
          f"({batches} batches): every row in its bucket by murmur3_int32"
          f" on the card, equal to its plain version (max_abs_err "
          f"{worst}); the files' rows equal the input as a multiset")
    return launches


def run_parquet_scan(dev, label: str, paths, rows: int, reader) -> dict:
    """The bench's scan over ``paths`` in one reader type: its batches
    equal pyarrow's dataset read as a row set, then the warm wall (median
    of three), rows/s of input rows, the decode alone (``read_split``,
    nothing uploaded) beside the upload alone (those tables through
    ``from_arrow``), the row groups pruned and the allocator peak."""
    import pyarrow.dataset as ds
    import torch
    from spark_rapids_tpu_torch import entry
    from spark_rapids_tpu_torch.batch import from_arrow, to_arrow
    from spark_rapids_tpu_torch.exec.base import assemble_result
    cols = list(entry.PARQUET_SCAN_COLUMNS)
    t0 = time.perf_counter()
    want = ds.dataset(paths).to_table(
        columns=cols, filter=ds.field("l_shipdate") <= entry.Q1_SHIPDATE_MAX)
    oracle_s = time.perf_counter() - t0

    def run():
        plan = entry.parquet_scan_plan(paths, reader_type=reader,
                                       device=dev)
        batches = list(plan.execute())
        torch.cuda.synchronize(dev)
        return plan, batches

    torch.cuda.reset_peak_memory_stats(dev)
    plan, batches = run()
    got = assemble_result([to_arrow(b, plan.output_schema) for b in batches],
                          plan.output_schema)
    same_rows(got, want, dev, f"parquet scan {label}")
    no_fallback(f"parquet scan {label}", plan)
    pruned = plan.source.row_groups_pruned
    del batches, got
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        run()
        walls.append(time.perf_counter() - t0)
    wall = statistics.median(walls)
    peak = torch.cuda.max_memory_allocated(dev)
    profiled_idle(f"parquet scan {label}", run, dev)
    src = plan.source
    t0 = time.perf_counter()
    tables = list(src.read_split(src.files))
    decode_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for t in tables:
        from_arrow(t, schema=plan.output_schema, device=dev)
    torch.cuda.synchronize(dev)
    upload_s = time.perf_counter() - t0
    print(f"parquet scan {label}: {len(paths)} files, {rows} rows -> "
          f"{want.num_rows} rows in {len(tables)} tables, equal to pyarrow's"
          f" dataset read ({oracle_s:.2f} s) as a row set; warm median "
          f"{wall:.4f} s of {[round(w, 4) for w in walls]}, "
          f"{rows / wall:,.0f} rows/s; decode alone {decode_s:.4f} s, "
          f"upload alone {upload_s:.4f} s; row groups pruned {pruned}; "
          f"device memory peak {peak / 2**30:.2f} GiB")
    return {"wall": wall, "decode_s": decode_s, "upload_s": upload_s}


def run_parquet_scan_phase(dev, table, tmp) -> list:
    """The bench's scan (``bench.bench_parquet_scan``): at its own size, 8
    files written by ``pq.write_table``, in each reader type, then over
    the SF10 lineitem in 8 files, MULTITHREADED. Every file's row groups
    must decode natively. Returns the SF10 files."""
    from spark_rapids_tpu_torch import entry
    from spark_rapids_tpu_torch.io.source import ReaderType
    bench = entry.lineitem_table(PARQUET_BENCH_ROWS, DATA_SEED).drop(
        ["l_tax"])
    bench_paths = entry.parquet_files(bench, f"{tmp}/bench",
                                      PARQUET_FILES)
    check_native_decode("parquet scan bench files", bench_paths)
    for reader in (ReaderType.PERFILE, ReaderType.COALESCING,
                   ReaderType.MULTITHREADED):
        run_parquet_scan(dev, f"{PARQUET_BENCH_ROWS} {reader.value}",
                         bench_paths, PARQUET_BENCH_ROWS, reader)
    t0 = time.perf_counter()
    paths = entry.parquet_files(table, f"{tmp}/sf10", PARQUET_FILES)
    print(f"parquet scan: SF10 lineitem written to {PARQUET_FILES} files in"
          f" {time.perf_counter() - t0:.2f} s")
    check_native_decode("parquet scan SF10 files", paths)
    run_parquet_scan(dev, f"SF10 {ReaderType.MULTITHREADED.value}", paths,
                     table.num_rows, ReaderType.MULTITHREADED)
    return paths


def profiled_idle(what: str, run, dev, host: bool = True) -> float:
    """The idle share of one profiled warm run of ``run()`` (``host``:
    as ``capture``'s)."""
    t0 = time.perf_counter()
    _, wall_us, busy, events = profiled(run, dev, host)
    own_s = time.perf_counter() - t0 - wall_us / 1e6
    idle = 1 - busy / wall_us
    print(f"{what}: profiled warm run {wall_us / 1e3:.1f} ms, device busy "
          f"{busy / 1e3:.1f} ms, idle share {idle:.1%}; {len(events)} "
          f"device records, the profile's own {own_s:.1f} s")
    return idle


# ---------------------------------------------------------------------------
# The Session: the same paths planned by spark_rapids_tpu_torch.plan
# ---------------------------------------------------------------------------

#: the bench scan's files in the Session phase
SESSION_SCAN_FILES = 8


def plan_tree(e, depth: int = 0) -> list:
    """A physical tree node by node (a fused stage as the tree it runs):
    exec class and name, join type, build mode and keys, partitioning keys
    and count, aggregate mode, limit, coalesce goal, sort keys, a file
    scan's partitions, columns and reader, and the output columns' names
    and kinds."""
    stage = getattr(e, "stage", None)
    if stage is not None:
        e = stage.plan
    attrs = [type(e).__name__, e.name]
    if hasattr(e, "join_type"):
        attrs += [e.join_type.name, getattr(e, "broadcast_build", None)]
    for keys in ("left_keys", "right_keys"):
        if hasattr(e, keys):
            attrs.append(tuple((type(k).__name__, getattr(k, "ordinal", None),
                                k.dtype.kind.value)
                               for k in getattr(e, keys)))
    part = getattr(e, "partitioning", None)
    if part is not None:
        attrs.append(tuple((k.ordinal, k.dtype.kind.value)
                           for k in getattr(part, "exprs", ())))
        attrs.append(part.num_partitions)
    if hasattr(e, "mode"):
        attrs.append(e.mode.name)
    if hasattr(e, "goal"):
        attrs.append(type(e.goal).__name__)
    if hasattr(e, "limit"):
        attrs.append(e.limit)
    if hasattr(e, "orders"):
        attrs.append(tuple((o.child.ordinal, o.descending)
                           for o in e.orders))
    if hasattr(e, "source"):
        attrs += [e.num_partitions, e.source.columns,
                  e.source.effective_reader().value]
    attrs.append(tuple((f.name, f.dtype.kind.value)
                       for f in e.output_schema))
    out = [(depth,) + tuple(attrs)]
    for c in e.children:
        out += plan_tree(c, depth + 1)
    return out


def _walk_plan(e):
    yield e
    for c in _children(e):
        yield from _walk_plan(c)


def check_session_plan(name: str, ses, hand) -> None:
    """The Session's last plan is the hand-built tree, nothing fell back,
    and every operator's batches live on the card."""
    got, want = plan_tree(ses.last_plan), plan_tree(hand)
    hand.close()
    if got != want:
        for i, (a, b) in enumerate(zip(got, want)):
            if a != b:
                raise AssertionError(f"session {name}: node {i} of the "
                                     f"Session's tree {a} != the "
                                     f"hand-built {b}")
        raise AssertionError(f"session {name}: {len(got)} nodes against "
                             f"the hand-built {len(want)}")
    if ses.fell_back():
        raise AssertionError(f"session {name}: fell back {ses.fell_back()}")
    off = [e.name for e in _walk_plan(ses.last_plan)
           if e.device.type != "cuda"]
    if off:
        raise AssertionError(f"session {name}: off the card: {off}")
    print(f"session {name}: the Session's tree is the hand-built one "
          f"({len(got)} nodes, root {type(ses.last_plan).__name__}); "
          f"nothing fell back, every operator on the card")


def run_session_path(name: str, dev, counted, table, reference, make_df,
                     make_hand, check, conf, rows_of=lambda t: t.num_rows,
                     reuse_plan: bool = False):
    """One path planned by ``plan.Session`` through ``run_path`` (its cold
    run's launch counts, one warm run, three with ``reuse_plan``, the
    oracle): after the cold run
    its tree is held against the hand-built ``make_hand(table)``. With
    ``reuse_plan`` one prepared plan is collected every time (a fused
    stage then plans, captures and replays); else each run plans afresh.
    Prints the planning time of ``prepare`` (host ms). Returns (launches,
    Session)."""
    from spark_rapids_tpu_torch.plan import Session
    ses = Session(conf, device=dev)
    state = {"prepare_ms": []}

    def run(t):
        df = make_df(t)
        prepared = None
        if reuse_plan:
            if "prepared" not in state:
                state["prepared"] = ses.prepare(df)
                state["prepare_ms"].append(ses.last_prepare_ns / 1e6)
            prepared = state["prepared"]
        out = ses.collect(df, _prepared=prepared)
        if not reuse_plan:
            state["prepare_ms"].append(ses.last_prepare_ns / 1e6)
        if "checked" not in state:
            check_session_plan(name, ses, make_hand(t))
            state["checked"] = True
        return out

    launches = run_path(f"session {name}", lambda: table, reference, run,
                        check, dev, counted, rows_of=rows_of,
                        warm_runs=3 if reuse_plan else 1)
    ms = state["prepare_ms"]
    print(f"session {name}: planning (prepare) {statistics.median(ms):.2f} "
          f"ms host median of {[round(m, 2) for m in ms]}")
    return launches, ses, state.get("prepared")


def check_window_match_at_session_q16(dev, ses, df) -> int:
    """``window_match`` against its plain version on the batch the
    Session's Q16 part filter sees (its scan's first batch), at k = 15 as
    ``NOT startswith 'MEDIUM POLISHED'`` runs it: the match matrix, and the
    filter's predicate on the card against the same rows on the CPU.
    Returns the mismatches (0)."""
    import torch
    from spark_rapids_tpu_torch import entry
    from spark_rapids_tpu_torch.batch import from_arrow, to_arrow
    from spark_rapids_tpu_torch.dictenc import decode_column
    from spark_rapids_tpu_torch.exec import FilterExec
    from spark_rapids_tpu_torch.kernels.string_search import (
        window_match, window_match_plain)
    _, plan = ses.prepare(df)
    try:
        filt = next(e for e in _walk_plan(plan) if isinstance(e, FilterExec)
                    and "p_type" in e.child.output_schema.names)
        schema = filt.child.output_schema
        batch = next(iter(filt.child.execute_partition(0)))
        # the filter reads a dictionary p_type decoded (dictenc.py)
        ptype = decode_column(batch.columns[schema.index_of("p_type")])
        pat = entry.Q16_TYPE_PREFIX.encode()
        got = window_match(ptype.data, ptype.lengths, pat)
        ref = window_match_plain(ptype.data, ptype.lengths, pat)
        on_card = filt.condition.eval(batch).data.cpu()
        cpu_batch, _ = from_arrow(to_arrow(batch, schema), schema=schema,
                                  device="cpu")
        on_cpu = filt.condition.eval(cpu_batch).data
        live = int(batch.num_rows)
        on_card, on_cpu = on_card[:live], on_cpu[:live]
        torch.cuda.synchronize(dev)
        bad = int((got != ref).sum()) + int((on_card != on_cpu).sum())
    finally:
        plan.close()
    n, ml = ptype.data.shape
    print(f"window_match at the Session's Q16 filter: capacity {n}, max_len "
          f"{ml}, k = {len(pat)}: {int(ref.sum())} matches, the filter keeps "
          f"{int(on_cpu.sum())} rows; {bad} mismatches against the plain "
          f"version and the CPU")
    if bad:
        raise AssertionError("window_match disagrees at the Session's Q16 "
                             "filter")
    return bad


def run_session_phase(dev, args, lineitem) -> list:
    """The Session (``spark_rapids_tpu_torch.plan.Session``) plans and runs
    the paths from their DataFrames (``entry.*_df``) under the conf the
    port's tests use (incompatibleOps on, AQE off): Q1 at SF10 and the Q16
    part stage at 20,000,000 part rows against pyarrow (murmur3 held
    against its plain version at the Session's exchanges, window_match at
    its filter), then the bench's q1_stage (2^22 rows, one slice),
    hash_agg (2^22 rows, 2^20 keys, 8 slices), join_sort (2^21 x 2^18, a
    fused stage captured in a CUDA graph and replayed) and parquet_scan
    (2^21 rows in 8 files, MULTITHREADED). Each tree equals the hand-built
    ``entry.*_plan``'s. ``lineitem`` is Q1's table. Returns each path's
    launches."""
    import pyarrow.dataset as ds
    from spark_rapids_tpu_torch import entry
    from spark_rapids_tpu_torch.exec import FusedStageExec
    from spark_rapids_tpu_torch.kernels.murmur3 import murmur3_int32
    from spark_rapids_tpu_torch.kernels.string_search import \
        window_match as window_match_wrapper
    runs = []

    def q1_check(got, expected):
        return f"; float max rel err {check_q1_result(got, expected):.3g}"

    launches, ses, _ = run_session_path(
        "q1", dev, [murmur3_int32], lineitem, entry.q1_reference,
        lambda t: entry.q1_df(t, Q1_SLICES),
        lambda t: entry.q1_plan(t, Q1_SLICES, Q1_SHUFFLE_PARTITIONS,
                                device=dev),
        q1_check, entry.session_conf(Q1_SHUFFLE_PARTITIONS))
    runs.append(launches)
    ses.prepare(entry.q1_df(lineitem, Q1_SLICES))
    check_murmur3_at_exchanges("the Session's Q1", ses.last_plan, dev)

    part = entry.part_table(SF100_PART_ROWS, PART_SEED)
    launches, ses, _ = run_session_path(
        "q16_part", dev, [murmur3_int32, window_match_wrapper], part,
        entry.q16_part_reference,
        lambda t: entry.q16_part_df(t, Q16_SLICES),
        lambda t: entry.q16_part_plan(t, Q16_SLICES, Q16_SHUFFLE_PARTITIONS,
                                      device=dev),
        check_q16_part_result, entry.session_conf(Q16_SHUFFLE_PARTITIONS))
    runs.append(launches)
    ses.prepare(entry.q16_part_df(part, Q16_SLICES))
    check_murmur3_at_exchanges("the Session's Q16 part stage",
                               ses.last_plan, dev)
    check_window_match_at_session_q16(dev, ses,
                                      entry.q16_part_df(part, Q16_SLICES))
    del part

    stage_rows = entry.lineitem_table(HASH_AGG_ROWS, DATA_SEED)
    q1_stage_ref = entry.q1_stage_plan(stage_rows,
                                       device="cpu").output_schema

    def q1_stage_reference(t):
        import pyarrow as pa
        import pyarrow.compute as pc
        f = t.filter(pc.less_equal(t.column("l_shipdate"),
                                   entry.Q1_SHIPDATE_MAX))
        f = f.append_column("disc", pc.multiply(
            f.column("l_extendedprice"),
            pc.subtract(1.0, f.column("l_discount"))))
        g = f.group_by(list(entry.Q1_KEYS)).aggregate(
            [("l_quantity", "sum"), ("l_extendedprice", "sum"),
             ("disc", "sum"), ("l_quantity", "mean"),
             ("l_discount", "mean"), ("l_quantity", "count")])
        return pa.table([g.column(c) for c in (
            "l_returnflag", "l_linestatus", "l_quantity_sum",
            "l_extendedprice_sum", "disc_sum", "l_quantity_mean",
            "l_discount_mean", "l_quantity_count")],
            names=q1_stage_ref.names)

    def keyed_check(keys, what):
        def check(got, expected):
            worst = check_float_table(got, expected, list(keys), what)
            return f"; float max rel err {worst:.3g}"
        return check

    launches, _, _ = run_session_path(
        "q1_stage", dev, [], stage_rows, q1_stage_reference,
        entry.q1_stage_df, lambda t: entry.q1_stage_plan(t, device=dev),
        keyed_check(entry.Q1_KEYS, "session q1_stage"),
        entry.session_conf(HASH_AGG_PARTITIONS))
    runs.append(launches)
    del stage_rows

    sales = entry.hash_agg_table(HASH_AGG_ROWS, HASH_AGG_KEYS)
    launches, _, _ = run_session_path(
        "hash_agg", dev, [murmur3_int32], sales, entry.hash_agg_reference,
        lambda t: entry.hash_agg_df(t, HASH_AGG_SLICES),
        lambda t: entry.hash_agg_plan(t, True, HASH_AGG_SLICES,
                                      HASH_AGG_PARTITIONS, device=dev),
        keyed_check(entry.HASH_AGG_KEYS, "session hash_agg"),
        entry.session_conf(HASH_AGG_PARTITIONS))
    runs.append(launches)
    del sales

    n_stream, n_build = JOIN_SORT_SIZES[0]
    tables = entry.join_sort_tables(n_stream, n_build)

    def join_sort_check(got, expected):
        return (f"; {check_join_sort_result(got, expected)} rows in "
                f"revenue ties, compared as sets")

    launches, ses, prepared = run_session_path(
        "join_sort", dev, [], tables,
        lambda t: entry.join_sort_reference(*t),
        lambda t: entry.join_sort_df(*t),
        lambda t: entry.join_sort_plan(*t, device=dev),
        join_sort_check, entry.session_conf(HASH_AGG_PARTITIONS),
        rows_of=lambda t: t[0].num_rows, reuse_plan=True)
    runs.append(launches)
    plan = prepared[1]
    stage = plan.stage if isinstance(plan, FusedStageExec) else None
    if stage is None or stage.captures != 1 or stage.replays < 2:
        raise AssertionError(
            f"session join_sort: not a captured, replayed fused stage "
            f"({type(plan).__name__}, "
            f"{getattr(stage, 'captures', 0)} captures, "
            f"{getattr(stage, 'replays', 0)} replays)")
    print(f"session join_sort: a FusedStageExec captured "
          f"{stage.captures} time(s) in a CUDA graph and replayed "
          f"{stage.replays} times by Session.collect")
    del tables, prepared, plan, stage

    tmp = tempfile.mkdtemp(prefix="chip_smoke_session_")
    try:
        bench = entry.lineitem_table(PARQUET_BENCH_ROWS, DATA_SEED).drop(
            ["l_tax"])
        paths = entry.parquet_files(bench, f"{tmp}/bench",
                                    SESSION_SCAN_FILES)

        def scan_reference(_):
            return ds.dataset(paths).to_table(
                columns=list(entry.PARQUET_SCAN_COLUMNS),
                filter=ds.field("l_shipdate") <= entry.Q1_SHIPDATE_MAX)

        def scan_check(got, expected):
            same_rows(got, expected, dev, "session parquet_scan")
            return "; the same rows as a multiset"

        launches, ses, _ = run_session_path(
            "parquet_scan", dev, [], paths, scan_reference,
            entry.parquet_scan_df,
            lambda t: entry.parquet_scan_plan(t, device=dev),
            scan_check, entry.session_conf(HASH_AGG_PARTITIONS),
            rows_of=lambda _: bench.num_rows)
        runs.append(launches)
        no_fallback("session parquet_scan", ses.last_plan)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return runs


# ---------------------------------------------------------------------------
# The mesh: shuffle.mode=ICI (spark_rapids_tpu_torch.parallel)
# ---------------------------------------------------------------------------

#: shards of the mesh phase's stages (all on one card where it is alone)
MESH_SHARDS = 8
#: the JAX Session's lowering of TPC-H Q1 (the aggregate's murmur3 routing
#: and the sort's splitter range exchange)
Q1_MESH_LOWERED = ["SortExec", "mesh_exchange(all_to_all)",
                   "HashAggregateExec", "ShuffleExchangeExec",
                   "HashAggregateExec", "mesh_exchange(all_to_all)",
                   "CoalesceBatchesExec", "FilterExec", "InMemoryScanExec"]
#: bench.bench_ici_exchange's fact rows
ICI_FACT_ROWS = 1 << 20
#: the chain's fact and dim rows and groups (dryrun_multichip's draws at
#: scale)
CHAIN_FACT_ROWS = 1 << 24
CHAIN_DIM_ROWS = 1 << 20
CHAIN_GROUPS = 64
#: ranks of the two-process exchange, shards per rank, and its limit
MULTIHOST_RANKS = 2
MULTIHOST_SHARDS = 2
MULTIHOST_TIMEOUT_S = 180


class RoutedKeys:
    """Collects the key columns of every murmur3 routing of a mesh run (a
    hash exchange's ``partition_ids``, an aggregate's ``murmur3_batch``,
    which the lowering module calls by name: they are wrapped there while
    the block runs), and holds the kernel against its plain version on
    them afterwards, seeded as the routing seeds them."""

    NAMES = ("partition_ids", "murmur3_batch")

    def __init__(self):
        self.keys = []
        self._saved = {}

    def __enter__(self):
        from spark_rapids_tpu_torch.parallel import lowering
        self.keys.clear()

        def recording(fn):
            def wrapped(cols, *args, **kwargs):
                self.keys.append(cols)
                return fn(cols, *args, **kwargs)
            return wrapped
        for name in self.NAMES:
            self._saved[name] = getattr(lowering, name)
            setattr(lowering, name, recording(self._saved[name]))
        return self

    def __exit__(self, *exc):
        from spark_rapids_tpu_torch.parallel import lowering
        for name, fn in self._saved.items():
            setattr(lowering, name, fn)
        self._saved.clear()

    def check(self, what: str, dev) -> int:
        """Compares every routed key column that reaches the kernel;
        returns the comparisons. The comparisons' own launches are taken
        back off the wrapper's count."""
        import torch
        from spark_rapids_tpu_torch.expressions.hashing import (
            DEFAULT_SEED, INT32_HASHED_KINDS, hash_column, int32_words)
        from spark_rapids_tpu_torch.kernels.murmur3 import (
            murmur3_int32, murmur3_int32_plain)
        before = murmur3_int32.launches
        compared, worst, shapes = 0, 0, set()
        for cols in self.keys:
            seed = torch.full((cols[0].capacity,), DEFAULT_SEED,
                              dtype=torch.int32, device=dev)
            for c in cols:
                if c.dtype.kind in INT32_HASHED_KINDS:
                    args = (int32_words(c), c.validity.contiguous(), seed)
                    err = int((murmur3_int32(*args).long()
                               - murmur3_int32_plain(*args).long())
                              .abs().max())
                    worst = max(worst, err)
                    compared += 1
                    shapes.add(c.capacity)
                seed = hash_column(c, seed)
        murmur3_int32.launches = before
        self.keys.clear()
        if not compared:
            raise AssertionError(f"{what}: no routed key reached "
                                 f"murmur3_int32")
        if worst:
            raise AssertionError(f"murmur3_int32 disagrees with its plain "
                                 f"version at {what}'s routings")
        print(f"murmur3_int32 against its plain version on {what}'s routed "
              f"keys: {compared} columns (capacities {sorted(shapes)}), "
              f"max_abs_err 0")
        return compared


def mesh_run(name: str, dev, counted, ses, make_df, check, expected,
             rows: int, lowered=None, warm_runs: int = 2) -> dict:
    """One Session path on the mesh: a cold run (every counted kernel's
    launches from 0, its tree one ``MeshStageExec`` with ``lowered`` where
    given, murmur3 held against its plain version on every routed key),
    ``warm_runs`` warm runs (each checked, murmur3 too), the allocator's
    peak, and the split of one more warm run's wall between input
    staging, the shards' local kernels and the exchanges (CUDA events).
    Returns the cold run's launches, walls and the last stage."""
    import torch
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    for wrapper in counted:
        wrapper.launches = 0
    with RoutedKeys() as routed:
        t0 = time.perf_counter()
        got = ses.collect(make_df())
        torch.cuda.synchronize(dev)
        cold = time.perf_counter() - t0
        launches = {w.__name__: w.launches for w in counted}
        stage = ses.last_plan
        if ses.executed_exec_names() != ["MeshStageExec"]:
            raise AssertionError(f"mesh {name}: not one mesh stage: "
                                 f"{ses.executed_exec_names()}")
        if lowered is not None and stage.lowered != lowered:
            raise AssertionError(f"mesh {name}: lowered {stage.lowered}")
        detail = check(got, expected)
        routed.check(f"mesh {name}", dev)
        for kernel, n in launches.items():
            if n <= 0:
                raise AssertionError(f"{kernel} was not launched by the "
                                     f"mesh {name} run")
        print(f"mesh {name}: one MeshStageExec over "
              f"{stage.num_partitions} shards, lowered {stage.lowered}; "
              f"matches its oracle ({got.num_rows} rows{detail or ''}); "
              f"cold {cold:.3f} s, {stage.attempts} attempt(s); kernel "
              f"launches in the run: {launches}")
        warm = []
        for _ in range(warm_runs):
            t0 = time.perf_counter()
            again = ses.collect(make_df())
            torch.cuda.synchronize(dev)
            warm.append(time.perf_counter() - t0)
            check(again, expected)
            routed.check(f"mesh {name} (warm)", dev)
    peak = torch.cuda.max_memory_allocated(dev)
    wall = statistics.median(warm)
    _, timed = ses.prepare(make_df())
    try:
        split = timed.time_split()
    finally:
        timed.close()
    per_shard = [round(split[k], 1) for k in sorted(split)
                 if k.startswith("shard ")]
    print(f"mesh {name}: warm median {wall:.3f} s of "
          f"{[round(w, 4) for w in warm]}, {rows / wall:,.0f} rows/s; "
          f"device memory peak {peak / 2**30:.2f} GiB")
    print(f"mesh {name}: split of one warm run (CUDA events, ms): input "
          f"staging {split.get('input', 0):.1f}, the shards' local kernels "
          f"{sum(per_shard):.1f} (per shard {per_shard}), exchanges "
          f"{split.get('exchange', 0):.1f}, broadcasts "
          f"{split.get('broadcast', 0):.1f}, splitters "
          f"{split.get('splitters', 0):.1f}")
    return {"launches": launches, "cold_s": cold, "warm_s": wall,
            "peak": peak, "stage": stage}


def check_chain_result(got, expected) -> str:
    """The chain's groups in order of sum(v) descending, every column
    exact; groups tied on sum(v) compared as sets."""
    if got.num_rows != expected.num_rows:
        raise AssertionError(f"{got.num_rows} groups != "
                             f"{expected.num_rows}")
    if got.column("sv").to_pylist() != expected.column("sv").to_pylist():
        raise AssertionError("the chain's order on sum(v) differs from "
                             "pyarrow's")
    if sorted(got.to_pylist(), key=str) != sorted(expected.to_pylist(),
                                                  key=str):
        raise AssertionError("the chain's groups differ from pyarrow's")
    ties = got.num_rows - len(set(got.column("sv").to_pylist()))
    return f"; order exact, {ties} groups in sum(v) ties compared as sets"


def run_multihost_exchange(dev) -> dict:
    """The two-process exchange: ``MULTIHOST_RANKS`` processes, each with
    ``MULTIHOST_SHARDS`` shards on the card, route int64 rows by value
    modulo the global shard count through ``torch.distributed`` and check
    what lands on each shard (``parallel.multihost.routing_check``). NCCL
    with one card per rank where there are two cards; on one card gloo,
    which stages each buffer through host memory. Fails if a rank fails or
    outlives its limit."""
    import socket
    import torch
    n_cards = torch.cuda.device_count()
    backend = "nccl" if n_cards >= MULTIHOST_RANKS else "gloo"
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = []
    for rank in range(MULTIHOST_RANKS):
        card = f"cuda:{rank if backend == 'nccl' else dev.index or 0}"
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "spark_rapids_tpu_torch.parallel.multihost",
             str(rank), str(MULTIHOST_RANKS), str(port), "--devices",
             ",".join([card] * MULTIHOST_SHARDS), "--backend", backend],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=MULTIHOST_TIMEOUT_S)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
    for rank, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0 or "routed rows correctly OK" not in out:
            raise AssertionError(f"multihost rank {rank} failed "
                                 f"(rc {p.returncode}):\n{out[-3000:]}")
        line = next(l for l in out.splitlines() if "correctly OK" in l)
        print(f"multihost: {line}")
    return {"backend": backend}


def run_mesh_phase(dev, lineitem) -> list:
    """The mesh (``shuffle.mode=ICI``, ``parallel/``), MESH_SHARDS shards
    over the visible cards: TPC-H Q1 at SF10 through the Session as one
    ``MeshStageExec`` (its lowered list the JAX Session's, equal to
    pyarrow; walls, peak and the split of a warm wall, beside Session Q1
    without ICI in the same call), the bench's ici_exchange shape (a broadcast join and a group-by,
    with the stage's program timed alone as the bench times it), the
    dryrun's chain at 2^24 x 2^20 (four exchanges, exact order against
    pyarrow), the two-process exchange and ``entry.dryrun_multigpu``;
    murmur3 held against its plain version on every routed key. Returns
    each path's launches."""
    import torch
    from spark_rapids_tpu_torch import entry
    from spark_rapids_tpu_torch.kernels.murmur3 import murmur3_int32
    from spark_rapids_tpu_torch.plan import Session
    runs = []
    counted = [murmur3_int32]
    rows = lineitem.num_rows
    t0 = time.perf_counter()
    q1_expected = entry.q1_reference(lineitem)
    print(f"mesh q1: {rows} rows; pyarrow oracle "
          f"{time.perf_counter() - t0:.2f} s; {torch.cuda.device_count()} "
          f"card(s) for {MESH_SHARDS} shards")

    def q1_check(got, expected):
        return f"; float max rel err {check_q1_result(got, expected):.3g}"

    # Session Q1 without ICI, in the same call
    host = Session(entry.session_conf(Q1_SHUFFLE_PARTITIONS), device=dev)
    host_walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        check_q1_result(host.collect(entry.q1_df(lineitem, Q1_SLICES)),
                        q1_expected)
        torch.cuda.synchronize(dev)
        host_walls.append(time.perf_counter() - t0)
    print(f"mesh q1: Session Q1 without ICI in this call: cold "
          f"{host_walls[0]:.3f} s, warm "
          f"{[round(w, 4) for w in host_walls[1:]]}")
    del host

    conf = entry.session_conf(Q1_SHUFFLE_PARTITIONS,
                              **entry.ici_conf(MESH_SHARDS))
    ses = Session(conf, device=dev)
    q1 = mesh_run("q1", dev, counted, ses,
                  lambda: entry.q1_df(lineitem, Q1_SLICES), q1_check,
                  q1_expected, rows, lowered=Q1_MESH_LOWERED)
    runs.append(q1["launches"])
    print(f"mesh q1: warm {q1['warm_s']:.3f} s on the mesh against "
          f"{statistics.median(host_walls[1:]):.3f} s without ICI")
    del ses, q1

    fact, dim = entry.ici_exchange_tables(ICI_FACT_ROWS)
    ici_expected = entry.ici_exchange_reference(fact, dim)
    ses = Session(entry.ici_conf(MESH_SHARDS), device=dev)

    def ici_check(got, expected):
        if not got.sort_by("g").equals(expected):
            raise AssertionError("ici_exchange differs from pyarrow")
        return "; every group exact"

    ici = mesh_run("ici_exchange", dev, counted, ses,
                   lambda: entry.ici_exchange_df(fact, dim), ici_check,
                   ici_expected, ICI_FACT_ROWS)
    runs.append(ici["launches"])
    if "mesh_broadcast(all_gather)" not in ici["stage"].lowered:
        raise AssertionError("ici_exchange: no broadcast in the stage")
    # the bench's timing: the stage's program on staged inputs
    _, plan = ses.prepare(entry.ici_exchange_df(fact, dim))
    program, staged = plan.prepare()
    program(staged)
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        program(staged)
        torch.cuda.synchronize(dev)
        times.append(time.perf_counter() - t0)
    best = statistics.median(times)
    print(f"mesh ici_exchange: the stage's program on staged inputs "
          f"(bench.bench_ici_exchange's timing), median of 5 "
          f"{best * 1e3:.2f} ms, {ICI_FACT_ROWS / best:,.0f} rows/s")
    plan.close()
    del ses, plan, program, staged, fact, dim, ici

    t0 = time.perf_counter()
    fact, dim = entry.mesh_chain_tables(CHAIN_FACT_ROWS, CHAIN_DIM_ROWS,
                                        CHAIN_GROUPS)
    chain_expected = entry.mesh_chain_reference(fact, dim)
    print(f"mesh chain: {CHAIN_FACT_ROWS} x {CHAIN_DIM_ROWS} rows made and "
          f"pyarrow oracle in {time.perf_counter() - t0:.2f} s")
    ses = Session(entry.mesh_chain_conf(MESH_SHARDS), device=dev)
    chain = mesh_run("chain", dev, counted, ses,
                     lambda: entry.mesh_chain_df(fact, dim),
                     check_chain_result, chain_expected, CHAIN_FACT_ROWS)
    runs.append(chain["launches"])
    lowered = chain["stage"].lowered
    if lowered.count("mesh_exchange(all_to_all)") != 4 or \
            "HashJoinExec(masked)" not in lowered:
        raise AssertionError(f"mesh chain: lowered {lowered}")
    del ses, fact, dim, chain

    run_multihost_exchange(dev)
    t0 = time.perf_counter()
    dry = entry.dryrun_multigpu(MESH_SHARDS, device=dev)
    print(f"dryrun_multigpu({MESH_SHARDS}): {dry['exchanges']} chained "
          f"exchanges in one MeshStageExec, {dry['groups']} groups equal "
          f"to the interpreter's, {time.perf_counter() - t0:.2f} s")
    return runs


def run_q1_parquet_phase(dev, counted, table, paths) -> dict:
    """Q1 at SF10 from the SF10 files: equal to the pyarrow oracle and to
    ``run_q1`` over the same table in memory, with its warm wall, rows/s,
    peak, idle share and murmur3's launches; murmur3 held bit for bit
    against its plain version on every batch of its exchange."""
    from spark_rapids_tpu_torch import entry
    from spark_rapids_tpu_torch.exec import collect
    in_memory = entry.run_q1(table, Q1_SLICES, Q1_SHUFFLE_PARTITIONS,
                             device=dev)
    state = {}

    def run(paths):
        state["plan"] = entry.q1_parquet_plan(paths, PARQUET_SLICES,
                                              PARQUET_PARTITIONS, device=dev)
        return collect(state["plan"])

    def check(got, expected):
        worst = check_q1_result(got, expected)
        worst = max(worst, check_q1_result(got, in_memory))
        no_fallback("q1 parquet", state["plan"])
        return (f"; and the in-memory run_q1; keys, counts and int sums "
                f"exact, float max rel err {worst:.3g} <= {FLOAT_REL_TOL}")

    print(f"q1 parquet: {len(paths)} files, {PARQUET_SLICES} scan "
          f"partitions, {PARQUET_PARTITIONS} shuffle partitions")
    launches = run_path("q1 parquet", lambda: paths,
                        lambda _: entry.q1_reference(table), run, check, dev,
                        counted, rows_of=lambda _: table.num_rows)
    profiled_idle("q1 parquet", lambda: run(paths), dev)
    check_murmur3_at_exchanges(
        "q1 parquet", entry.q1_parquet_plan(paths, PARQUET_SLICES,
                                            PARQUET_PARTITIONS, device=dev),
        dev)
    return launches


def run_q16_parquet_phase(dev, counted, tmp) -> dict:
    """Q16's part stage over the SF100 part table written by
    ``pq.write_table`` (dictionary-encoded string pages), its predicate
    kept above the scan, so that the readers hand p_brand and p_type over
    as RLE_DICTIONARY codes under the default conf (none do under a
    pushed-down predicate) and the filter runs on the codes: exact against
    the pyarrow oracle, its row groups decoded natively, with its wall,
    idle share and window_match's launches; the columns that arrived as
    codes, the pieces whose dictionaries the exchange read merged in one
    run, and the decode and upload seconds beside a run under
    ``dictEncoding.enabled=false``, whose rows are equal."""
    import torch
    from spark_rapids_tpu_torch import entry
    from spark_rapids_tpu_torch.batch import from_arrow
    from spark_rapids_tpu_torch.dictenc import merged_pieces
    from spark_rapids_tpu_torch.exec import collect
    part = entry.part_table(SF100_PART_ROWS, PART_SEED)
    t0 = time.perf_counter()
    paths = entry.parquet_files(part, f"{tmp}/part", PARQUET_FILES)
    print(f"q16 parquet: {SF100_PART_ROWS} part rows written to "
          f"{len(paths)} files in {time.perf_counter() - t0:.2f} s")
    check_native_decode("q16 parquet part files", paths)
    state = {}
    off = {"spark.rapids.tpu.dictEncoding.enabled": False}

    def plan_of(conf=None):
        return entry.q16_part_parquet_plan(
            paths, PARQUET_SLICES, PARQUET_PARTITIONS, device=dev,
            pushdown=False, conf=conf)

    def run(_):
        state["plan"] = plan_of()
        return collect(state["plan"])

    def check(got, expected):
        check_q16_part_result(got, expected)
        no_fallback("q16 parquet", state["plan"])

    launches = run_path("q16 parquet", lambda: paths,
                        lambda _: entry.q16_part_reference(part), run, check,
                        dev, counted, rows_of=lambda _: part.num_rows,
                        warm_runs=2)
    merged = merged_pieces()
    profiled_idle("q16 parquet", lambda: run(paths), dev)
    merged = merged_pieces() - merged
    plan = plan_of()
    scan = _execs(plan, "FileSourceScanExec[parquet]")[0]
    coded = set()
    try:
        for b in scan.execute_partition(0):
            coded |= {f.name for f, c in zip(scan.output_schema, b.columns)
                      if c.is_dict}
    finally:
        plan.close()
    t0 = time.perf_counter()
    got_off = collect(plan_of(off))
    torch.cuda.synchronize(dev)
    off_s = time.perf_counter() - t0
    if not got_off.equals(entry.q16_part_reference(part)):
        raise AssertionError("q16 parquet: the dictEncoding.enabled=false "
                             "run differs")
    split = {}
    for label, conf in (("codes", None), ("bytes", off)):
        plan = plan_of(conf)
        plan.close()
        src = _execs(plan, "FileSourceScanExec[parquet]")[0]
        t0 = time.perf_counter()
        tables = list(src.source.read_split(src.source.files))
        decode_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        for t in tables:
            from_arrow(t, schema=src.output_schema, device=dev,
                       dict_conf=src.source._dict_conf)
        torch.cuda.synchronize(dev)
        split[label] = (decode_s, time.perf_counter() - t0)
    print(f"q16 parquet: columns that arrived as codes {sorted(coded)}; "
          f"pieces whose dictionaries the exchange read merged in one run "
          f"{merged}; host decode and upload seconds, codes "
          f"{split['codes'][0]:.3f} + {split['codes'][1]:.3f}, under "
          f"dictEncoding.enabled=false {split['bytes'][0]:.3f} + "
          f"{split['bytes'][1]:.3f}; that run {off_s:.3f} s, its rows equal")
    if sorted(coded) != ["p_brand", "p_type"]:
        raise AssertionError(f"q16 parquet: codes for {sorted(coded)}")
    return launches


# ---------------------------------------------------------------------------
# CPU fallback islands and the row interpreter (plan/interpreter.py)
# ---------------------------------------------------------------------------

#: the rows of each path of the on-card differential against the
#: interpreter (its row loops take about a second a path here)
DIFF_ROWS = 1 << 16
#: the keys of the differential's hash_agg table, and its join_sort build
DIFF_KEYS = 1 << 12
DIFF_BUILD_ROWS = 1 << 13
#: the kernels each path of the differential must launch on the card
DIFF_KERNELS = {"hash_agg": ("murmur3_int32",),
                "q16_part": ("murmur3_int32", "window_match")}
#: the interpreter as the oracle: the whole query on the CPU
ORACLE_CONF = {"spark.rapids.tpu.sql.enabled": False}


def island_stats(plan) -> dict:
    """The host work of a plan's CPU fallback islands in its last run:
    ``collectTime`` (the device children to Arrow) and ``interpretTime``
    (the row loop), both inside ``CpuFallbackExec.interpret``, and the
    rows the islands read from the device."""
    from spark_rapids_tpu_torch.plan import CpuFallbackExec
    out = {"collect_s": 0.0, "interpret_s": 0.0, "rows_in": 0}
    for e in _walk_plan(plan):
        if isinstance(e, CpuFallbackExec):
            out["collect_s"] += e.metrics["collectTime"].total() / 1e9
            out["interpret_s"] += e.metrics["interpretTime"].total() / 1e9
            out["rows_in"] += e.metrics["numInputRows"].total()
    return out


def run_fallback_path(name: str, dev, counted, table, expected, make_df,
                      check, conf, fallen, top_island: bool,
                      rows_out) -> dict:
    """One path through the port's Session with islands: one cold run
    (every counted kernel's launches from 0, its result checked, its
    ``fell_back()`` equal to ``fallen``, a CPU-topped plan interpreted on
    the host where ``top_island``) and one profiled warm run (checked).
    Prints the warm wall and idle share, the islands' host time inside
    ``CpuFallbackExec.interpret`` with their rows in and out
    (``rows_out(plan, result)``) and the allocator's peak.
    Returns the cold run's launches."""
    import torch
    from spark_rapids_tpu_torch.plan import CpuFallbackExec, Session
    ses = Session(conf, device=dev)
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    for wrapper in counted:
        wrapper.launches = 0
    t0 = time.perf_counter()
    got = ses.collect(make_df(table))
    torch.cuda.synchronize(dev)
    cold_s = time.perf_counter() - t0
    launches = {w.__name__: w.launches for w in counted}
    detail = check(got, expected)
    if ses.fell_back() != fallen:
        raise AssertionError(f"fallback {name}: fell back {ses.fell_back()}"
                             f", not {fallen}")
    if isinstance(ses.last_plan, CpuFallbackExec) != top_island:
        raise AssertionError(f"fallback {name}: the plan's root is "
                             f"{ses.last_plan.name}")
    for kernel, n in launches.items():
        if n <= 0:
            raise AssertionError(f"{kernel} was not launched by the "
                                 f"fallback {name} run")
    print(f"fallback {name}: matches its oracle ({got.num_rows} rows"
          f"{detail or ''}); fell_back() {ses.fell_back()}, executed "
          f"{ses.executed_exec_names()}; cold {cold_s:.3f} s; kernel "
          f"launches in the run: {launches}")
    # one warm run, profiled, within the script's time limit
    warm = {}

    def again():
        warm["rows"] = ses.collect(make_df(table))
    profiled_idle(f"fallback {name}", again, dev, host=False)
    check(warm["rows"], expected)
    isl = island_stats(ses.last_plan)
    peak = torch.cuda.max_memory_allocated(dev)
    total = isl["collect_s"] + isl["interpret_s"]
    print(f"fallback {name}: the warm run's island host time in "
          f"CpuFallbackExec.interpret {total:.3f} s "
          f"(device children to Arrow {isl['collect_s']:.3f} s, row loop "
          f"{isl['interpret_s']:.3f} s), rows in {isl['rows_in']:,}, rows "
          f"out {rows_out(ses.last_plan, warm['rows']):,}; device memory "
          f"peak {peak / 2**30:.2f} GiB")
    return launches


def _sorted_keys(t) -> list:
    """A table's columns, those that are not floats first: the sort order
    under which two results compare row by row."""
    import pyarrow as pa
    exact = [n for n, f in zip(t.column_names, t.schema)
             if not pa.types.is_floating(f.type)]
    return exact + [n for n in t.column_names if n not in exact]


def check_against_interpreter(dev, counted) -> list:
    """The port's differential on the card: q1_stage, hash_agg, join_sort,
    parquet_scan and the Q16 part stage at DIFF_ROWS rows, each through
    ``Session`` on the card and through ``Session`` with
    ``sql.enabled=false`` (the row interpreter): floats within
    FLOAT_REL_TOL, everything else exact. ``window_match`` is held against
    its plain version at the Q16 filter. Then explain-only mode on
    q1_stage: the interpreter's rows, a planned ``last_plan``, and the
    device bytes it allocated. Returns the device runs' launches."""
    import torch
    from spark_rapids_tpu_torch import entry
    from spark_rapids_tpu_torch.plan import Session
    conf = entry.session_conf(HASH_AGG_PARTITIONS)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_fallback_")
    runs = []
    try:
        lineitem = entry.lineitem_table(DIFF_ROWS, DATA_SEED)
        paths = entry.parquet_files(lineitem.drop(["l_tax"]),
                                    f"{tmp}/scan", 4)
        part = entry.part_table(DIFF_ROWS, PART_SEED)
        paths_df = [
            ("q1_stage", lambda: entry.q1_stage_df(lineitem)),
            ("hash_agg", lambda: entry.hash_agg_df(
                entry.hash_agg_table(DIFF_ROWS, DIFF_KEYS), HASH_AGG_SLICES)),
            ("join_sort", lambda: entry.join_sort_df(
                *entry.join_sort_tables(DIFF_ROWS, DIFF_BUILD_ROWS))),
            ("parquet_scan", lambda: entry.parquet_scan_df(paths)),
            ("q16_part", lambda: entry.q16_part_df(part, Q16_SLICES)),
        ]
        for name, make in paths_df:
            for wrapper in counted:
                wrapper.launches = 0
            ses = Session(conf, device=dev)
            got = ses.collect(make())
            torch.cuda.synchronize(dev)
            runs.append({w.__name__: w.launches for w in counted})
            for kernel in DIFF_KERNELS.get(name, ()):
                if runs[-1][kernel] <= 0:
                    raise AssertionError(f"interpreter differential {name}"
                                         f": {kernel} was not launched")
            if ses.fell_back():
                raise AssertionError(f"interpreter differential {name}: "
                                     f"fell back {ses.fell_back()}")
            t0 = time.perf_counter()
            want = Session(ORACLE_CONF, device=dev).collect(make())
            oracle_s = time.perf_counter() - t0
            worst = check_float_table(got, want, _sorted_keys(want),
                                      f"interpreter differential {name}")
            print(f"interpreter differential {name}: the card's "
                  f"{got.num_rows} rows equal the interpreter's (its run "
                  f"{oracle_s:.2f} s on the host; float max rel err "
                  f"{worst:.3g}); launches {runs[-1]}")
        ses = Session(conf, device=dev)
        check_window_match_at_session_q16(dev, ses,
                                          entry.q16_part_df(part, Q16_SLICES))
        # explain-only: planned for the card, run on the interpreter
        explain = Session({**conf, "spark.rapids.tpu.sql.mode":
                           "explainonly"}, device=dev)
        torch.cuda.synchronize(dev)
        before = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        got = explain.collect(entry.q1_stage_df(lineitem))
        torch.cuda.synchronize(dev)
        grown = torch.cuda.max_memory_allocated(dev) - before
        want = Session(ORACLE_CONF, device=dev).collect(
            entry.q1_stage_df(lineitem))
        if explain.last_plan is None or not got.equals(want):
            raise AssertionError("explain-only mode: not the interpreter's "
                                 "rows, or no planned last_plan")
        print(f"explain-only q1_stage: the interpreter's {got.num_rows} rows"
              f", last_plan {explain.last_plan.name} with "
              f"{len(list(_walk_plan(explain.last_plan)))} operators; device"
              f" bytes allocated while it ran: {grown:,}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return runs


def run_fallback_phase(dev, lineitem, q3_tables) -> list:
    """CPU fallback islands on the card, each path through the port's
    Session under ``entry.session_conf`` (incompatibleOps on, AQE off):
    Q1 at SF10 with ``sql.exec.Sort`` off (a CPU-topped plan: the final
    sort over the 4 groups interpreted on the host, no upload after it),
    Q3 at SF10 with ``sql.expression.EqualTo`` off (the customer filter an
    island that reads the card's scan through Arrow; both joins, the
    aggregate, the exchanges, the sort and the limit on the card), each
    against its oracle and murmur3 held against its plain version at every
    exchange; then the port's differential against the row interpreter.
    Returns each run's launches."""
    from spark_rapids_tpu_torch import entry
    from spark_rapids_tpu_torch.kernels.murmur3 import murmur3_int32
    from spark_rapids_tpu_torch.kernels.string_search import window_match
    from spark_rapids_tpu_torch.plan import Session
    runs = []

    def q1_check(got, expected):
        return f"; float max rel err {check_q1_result(got, expected):.3g}"

    q1_conf = entry.session_conf(Q1_SHUFFLE_PARTITIONS, **{
        "spark.rapids.tpu.sql.exec.Sort": False})
    runs.append(run_fallback_path(
        "q1 (Sort off)", dev, [murmur3_int32], lineitem,
        entry.q1_reference(lineitem), lambda t: entry.q1_df(t, Q1_SLICES),
        q1_check, q1_conf, ["CpuFallback[Sort]"], True,
        lambda plan, result: result.num_rows))
    ses = Session(q1_conf, device=dev)
    ses.prepare(entry.q1_df(lineitem, Q1_SLICES))
    check_murmur3_at_exchanges("the Sort-off Q1", ses.last_plan, dev)
    del ses

    customer, orders, li = q3_tables
    expected = entry.q3_reference(customer, orders, li)
    q3_conf = entry.session_conf(Q3_SHUFFLE_PARTITIONS, **{
        "spark.rapids.tpu.sql.expression.EqualTo": False})
    same = Session(entry.session_conf(Q3_SHUFFLE_PARTITIONS),
                   device=dev).collect(
        entry.q3_df(customer, orders, li, Q3_SLICES))

    def q3_check(got, want):
        worst = check_q3_result(got, want)
        worst = max(worst, check_q3_result(got, same))
        return (f"; keys exact, revenue max rel err {worst:.3g}, against "
                f"pyarrow and the same Session without the switch")

    def island_rows_out(plan, _):
        return sum(e.metrics["numOutputRows"].total()
                   for e in _execs(plan, "CpuFallback[Filter]"))

    runs.append(run_fallback_path(
        "q3 (EqualTo off)", dev, [murmur3_int32], (customer, orders, li),
        expected, lambda t: entry.q3_df(*t, Q3_SLICES), q3_check, q3_conf,
        ["CpuFallback[Filter]"], False, island_rows_out))
    ses = Session(q3_conf, device=dev)
    ses.prepare(entry.q3_df(customer, orders, li, Q3_SLICES))
    check_murmur3_at_exchanges("the EqualTo-off Q3", ses.last_plan, dev)
    del ses, same

    runs += check_against_interpreter(dev, [murmur3_int32, window_match])
    return runs


def timed(name: str, fn, *args):
    """``fn(*args)``, with the phase's wall time printed after it."""
    t0 = time.perf_counter()
    out = fn(*args)
    print(f"[phase {name}: {time.perf_counter() - t0:.1f} s]")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=SF10_LINEITEM_ROWS,
                    help="Q1's lineitem rows (default: SF10)")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    from spark_rapids_tpu_torch.kernels import build
    from spark_rapids_tpu_torch.kernels.murmur3 import murmur3_int32
    from spark_rapids_tpu_torch.kernels.string_search import window_match
    dev = torch.device("cuda", 0)
    print(card_line())

    t0 = time.perf_counter()
    # every library at once: the CUDA kernels, the frame codec and the
    # Parquet decoder
    built = build.build([*build.SOURCES, *build.HOST_SOURCES])
    print(f"build: {time.perf_counter() - t0:.2f} s for "
          f"{sorted(built) or 'nothing (already built)'}")
    for name, (secs, output) in built.items():
        info = " | ".join(line.strip() for line in output.splitlines()
                          if "registers" in line or "spill" in line)
        print(f"build {name}: {secs:.2f} s; {info}")

    part = part_slice(dev)
    murmur3 = timed("murmur3", check_murmur3, dev, part)
    q16_search = timed("window_match", check_window_match, dev, part)
    del part
    from spark_rapids_tpu_torch import entry
    t0 = time.perf_counter()
    q2_tables = entry.tpch_q2_tables(Q2_SF, Q2_SEED)
    print(f"q2/q11 tables at SF{Q2_SF}: "
          f"{[t.num_rows for t in q2_tables]} rows (part, supplier, "
          f"partsupp, nation, region) made in "
          f"{time.perf_counter() - t0:.2f} s")
    search = timed("window_match at q2", check_window_match_at_q2, dev,
                   q2_tables[0])
    search["max_abs_err"] = max(search["max_abs_err"],
                                q16_search["max_abs_err"])
    kernels = [murmur3, search]
    timed("joins", check_joins, dev)
    # each path's own kernels, counted from 0 over its first run
    runs = [timed("q1", run_q1_phase, args, dev, [murmur3_int32]),
            timed("q16_part", run_q16_part_phase, dev,
                  [murmur3_int32, window_match])]
    # the same paths and the bench's four shapes planned by the port's
    # Session from their DataFrames; then the mesh (ICI) over the same
    # SF10 lineitem
    lineitem = entry.lineitem_table(args.rows, DATA_SEED)
    runs += timed("session", run_session_phase, dev, args, lineitem)
    runs += timed("mesh", run_mesh_phase, dev, lineitem)
    # Q3 with AQE off, then on (the JAX Session's default adaptive conf)
    q3_runs, q3_tables = timed("q3", run_q3_phase, dev, [murmur3_int32])
    runs += q3_runs
    timed("range sort", check_range_sort, dev, q3_tables[2])
    # CPU fallback islands (Q1 over the same SF10 lineitem, Q3 at SF10)
    # and the port's differential against its row interpreter
    runs += timed("fallback", run_fallback_phase, dev, lineitem, q3_tables)
    del q3_tables, lineitem
    # before Q18, whose spills would leave pinned buffers in the cache
    timed("spill rates", measure_spill_rates, dev)
    q18_keep = {}
    runs += timed("q18", run_q18_phase, dev, [murmur3_int32], q18_keep)
    # Q18 again over the same tables and oracle: in the spec's DECIMAL
    # types, over decimal(38,0) keys and as float64 through the Session
    runs += timed("q18 decimal", run_q18_decimal_phase, dev, [murmur3_int32],
                  q18_keep["tables"], q18_keep["expected"])
    del q18_keep
    # the skewed join's three legs (its aggregate exchange hashes the int32
    # group key), and the new kinds through the hash exchange
    runs += timed("skew", run_skew_phase, dev, [murmur3_int32])
    runs.append(timed("types exchange", check_types_exchange, dev,
                      murmur3_int32))
    timed("out of core", check_out_of_core, dev)
    timed("q18 injection", run_q18_injection_phase, dev)
    # Q2's own kernel is window_match (its exchanges hash int64 and double
    # keys, which take no kernel); Q11 reaches none
    runs.append(timed("q2", run_q2_phase, dev, [window_match], q2_tables))
    runs.append(timed("q11", run_q11_phase, dev, [], q2_tables))
    # the fused, captured stages that launch each kernel
    runs.append(timed("captured window_match", check_captured_window_match,
                      dev, q2_tables[0]))
    del q2_tables
    # TPC-H Q16 whole through the Session (window_match at its k = 15
    # part filter, murmur3 at its p_size exchange keys, the Like DFA on
    # the supplier side), then the string expressions (window_match at
    # locate, replace and substring_index over its p_type column)
    t0 = time.perf_counter()
    q16_tables = entry.tpch_q16_tables(Q16_SF, Q16_SEED)
    print(f"q16 tables at SF{Q16_SF}: "
          f"{[t.num_rows for t in q16_tables]} rows (part, supplier, "
          f"partsupp) made in {time.perf_counter() - t0:.2f} s")
    runs += timed("q16", run_q16_phase, dev, [murmur3_int32, window_match],
                  q16_tables)
    runs.append(timed("strings", run_strings_phase, dev, q16_tables))
    # the part-catalogue roll-up over the same SF100 part table (the span
    # programs and the rest of strings.py; murmur3 at its class_no key),
    # and the span scans over the SF100 S_COMMENT
    runs.append(timed("catalog", run_catalog_phase, dev, [murmur3_int32],
                      q16_tables))
    del q16_tables
    # TPC-H Q14 and Q9 at SF10 through the Session (CaseWhen, add_months
    # and year(); window_match at k = 5 in each, murmur3 at Q9's o_year
    # exchange), then every scalar expression on the card against the
    # row interpreter
    t0 = time.perf_counter()
    q14_tables, q9_tables, window_tables = entry.tpch_q14_q9_window_tables(
        SCALAR_Q_SF, SCALAR_Q_SEED)
    print(f"q14/q9 tables at SF{SCALAR_Q_SF} made in "
          f"{time.perf_counter() - t0:.2f} s")
    runs.append(timed("q14", run_q14_phase, dev, [window_match],
                      q14_tables))
    del q14_tables
    runs.append(timed("q9", run_q9_phase, dev, [murmur3_int32, window_match],
                      q9_tables))
    # the windows over the same draw's orders and lineitem (murmur3 at
    # supplier months' int32 year and month), every window function
    # against the interpreter, then OPTIMIZE ZORDER BY's sort
    runs += timed("windows", run_windows_phase, dev, [murmur3_int32],
                  window_tables)
    timed("zorder", run_zorder_phase, dev, window_tables[1])
    del window_tables
    # the nested kinds over the same SF10 draw: the order baskets, the
    # item support and the P_NAME words (no kernel on their paths), then
    # every collection expression against the row interpreter
    timed("baskets", run_baskets_phase, dev, q9_tables)
    # the order lines as arrays over the same draw: the lambdas, the set
    # operations and the shaping at SF10 (no kernel on its path)
    timed("order lines", run_order_lines_phase, dev, q9_tables)
    del q9_tables
    timed("collections", run_collections_phase, dev)
    # Q1 over SF1 JSON Lines: window_match at every field step
    runs.append(timed("json q1", run_json_q1_phase, dev, [window_match]))
    timed("scalar", run_scalar_phase, dev)
    runs.append(timed("captured murmur3", check_captured_murmur3, dev))
    timed("hash_agg", check_hash_agg, dev)
    timed("operators", check_operators, dev)
    timed("new operators", check_new_operators, dev)
    timed("limbs", check_limbs, dev)
    timed("q1_stage", check_q1_stage, dev)
    # the bench's join+sort stage three ways (its int64 key is probed
    # exactly: no kernel), and the overflow retry
    for n_stream, n_build in JOIN_SORT_SIZES:
        timed(f"join_sort {n_stream}", run_join_sort_phase, dev, n_stream,
              n_build)
    timed("overflow retry", check_overflow_retry, dev)
    # the Parquet slice: the bucketed write (murmur3 on its int32 bucket
    # key), the bench's scan, Q1 read from files (murmur3 at its exchange)
    # and Q16's part stage read from files (window_match, k = 15)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_parquet_")
    try:
        lineitem = entry.lineitem_table(args.rows, DATA_SEED)
        runs.append(timed("parquet write", run_parquet_write_phase, dev,
                          [murmur3_int32],
                          lineitem.slice(0, PARQUET_WRITE_ROWS),
                          f"{tmp}/bucketed"))
        shutil.rmtree(f"{tmp}/bucketed")
        paths = timed("parquet scan", run_parquet_scan_phase, dev,
                      lineitem, tmp)
        runs.append(timed("q1 parquet", run_q1_parquet_phase, dev,
                          [murmur3_int32], lineitem, paths))
        del lineitem
        runs.append(timed("q16 parquet", run_q16_parquet_phase, dev,
                          [murmur3_int32, window_match], tmp))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    for k in kernels:
        k["launches"] = sum(r.get(k["name"], 0) for r in runs)
    order = ["name", "route", "source", "replaces", "launches",
             "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
             "library_ms"]
    print(json.dumps({"kernels": [{key: k[key] for key in order}
                                  for k in kernels]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
