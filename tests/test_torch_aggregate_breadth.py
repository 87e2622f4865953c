"""The rest of the aggregate functions in the port against the JAX package
on the CPU: Min and Max over every type the JAX package takes, the central
moments, First and Last, Percentile and ApproxPercentile with the exec's
sort-sensitive branch, ``IsNaN``, the fused filter mask of the Q1 stage,
the capacity tiers and the bench's hash_agg shape.

Tolerances: integers, booleans, dates, strings, nulls and row counts
exactly; Min, Max, First, Last and Percentile exactly (each is one of its
inputs, or Percentile's interpolation of two, computed the same way); sums
and averages within rel 1e-6 (the two packages add float64 values in
different orders); the moments within rel 1e-6 of the JAX value plus an
absolute floor of 1e-9 times the group's squared magnitude (its variance)
or magnitude (its deviation), for groups whose m2 is near 0 and so lost to
cancellation in either order.

Min and Max differ from the JAX package on NaN, on purpose: the port
follows Spark (NaN above every other value, so max is NaN if any value is,
min only if all are), where the JAX package's ``jnp.minimum`` lets NaN win
both; ``test_minmax_nan_follows_spark`` pins it. Each JAX plan runs once.
"""

import math

import jax
import numpy as np
import pyarrow as pa
import pyarrow.compute as pc
import pytest

import __graft_entry__ as graft
from spark_rapids_tpu import exec as jexec
from spark_rapids_tpu.batch import from_arrow as jfrom_arrow
from spark_rapids_tpu.expressions import col as jcol
from spark_rapids_tpu.expressions import aggregates as jagg
from spark_rapids_tpu.expressions.comparison import IsNaN as JIsNaN
from spark_rapids_tpu_torch import entry
from spark_rapids_tpu_torch.batch import from_arrow, to_arrow
from spark_rapids_tpu_torch.exec import (AggregateMode, HashAggregateExec,
                                         InMemoryScanExec, ProjectExec,
                                         collect)
from spark_rapids_tpu_torch.expressions import IsNaN, col
from spark_rapids_tpu_torch.expressions import aggregates as tagg
from spark_rapids_tpu_torch.shuffle import (HashPartitioning,
                                            ShuffleExchangeExec,
                                            SinglePartitioning)

from harness.asserts import assert_tables_equal, rows_of

REL_TOL = 1e-6
#: the moments' absolute floor, times the group's squared magnitude
MOMENT_ABS = 1e-9
#: keys 0..7 hold random rows; 8 holds one row, 9 only null values, 10 a
#: near-constant double column, and some keys are null
N_KEYS = 11


def _values_table(n=700, seed=31):
    rng = np.random.default_rng(seed)
    k = rng.integers(0, 8, n).astype(np.int32)
    k[:1], k[1:40], k[40:80] = 8, 9, 10
    key_null = rng.random(n) < 0.04
    key_null[:80] = False
    null = rng.random(n) < 0.15
    null[1:40] = True                     # key 9: every value null
    null[0] = False
    lo, hi = np.iinfo(np.int64).min, np.iinfo(np.int64).max
    lng = rng.integers(-10**15, 10**15, n)
    lng[80:84] = [lo, hi, lo + 1, hi - 1]
    f = rng.standard_normal(n) * rng.choice([1.0, 1e3, 1e-3, 1e9], n)
    f[84:90] = [np.inf, -np.inf, -0.0, 0.0, np.inf, -0.0]
    f[40:80] = 1e6 + rng.integers(0, 3, 40) * 1e-3    # near-constant
    fn = f.copy()
    fn[90:94] = np.nan
    words = np.array(["", "a", "ab", "b", "ba", "abc", "bb", "aab"])
    s = pa.array(words[rng.integers(0, len(words), n)], mask=null)
    return pa.table({
        "k": pa.array(k, mask=key_null),
        "i": pa.array(rng.integers(-2**31, 2**31, n).astype(np.int32),
                      mask=null),
        "l": pa.array(lng, mask=null),
        "d": pa.array(rng.integers(-20000, 20000, n).astype(np.int32),
                      mask=null).view(pa.date32()),
        "f": pa.array(f, mask=null),
        "fn": pa.array(fn, mask=null),
        "b": pa.array(rng.random(n) < 0.5, mask=null),
        "s": s,
    })


MINMAX_COLS = ("i", "l", "d", "f", "b", "s")
MOMENT_COLS = ("i", "l", "f", "fn")
MOMENTS = ("VarianceSamp", "VariancePop", "StddevSamp", "StddevPop")


def _breadth_aggs(c, A):
    out = []
    for x in MINMAX_COLS:
        out += [A.Min(c(x)).alias(f"min_{x}"), A.Max(c(x)).alias(f"max_{x}")]
    for x in MOMENT_COLS:
        out += [getattr(A, m)(c(x)).alias(f"{m}_{x}") for m in MOMENTS]
    return out


def _first_last_aggs(c, A):
    return [fn(c(x)).alias(f"{fn.__name__}_{x}")
            for fn in (A.First, A.Last) for x in ("i", "fn", "s", "b")]


def _jax_collect(plan):
    """The JAX plan's rows, run op by op: its shapes vary per case, and
    compiling each would cost more than running it."""
    with jax.disable_jit():
        return jexec.collect(plan)


def _port_plan(t, keys, aggs, batch_rows, two_stage, num_slices=1):
    scan = InMemoryScanExec(t, batch_rows=batch_rows, num_slices=num_slices,
                            device="cpu")
    kc = [col(x) for x in keys]
    if not two_stage:
        return HashAggregateExec(kc, aggs(col, tagg), scan)
    partial = HashAggregateExec(kc, aggs(col, tagg), scan,
                                AggregateMode.PARTIAL)
    exchange = ShuffleExchangeExec(
        HashPartitioning(kc, 3) if keys else SinglePartitioning(), partial)
    return HashAggregateExec(kc, aggs(col, tagg), exchange,
                             AggregateMode.FINAL)


def _group_scale(t, keys, value):
    """The largest finite |value| of each group, by its key tuple."""
    key_rows = list(zip(*[t.column(x).to_pylist() for x in keys])) \
        if keys else [()] * t.num_rows
    out = {}
    for kr, v in zip(key_rows, t.column(value).to_pylist()):
        if v is not None and math.isfinite(float(v)):
            out[kr] = max(out.get(kr, 0.0), abs(float(v)))
    return out


def _assert_breadth(got, want, t, keys):
    """Every column exactly (floats within REL_TOL), the moments against
    the JAX value within REL_TOL plus the floor for near-zero m2."""
    moment = [n for n in got.column_names if n.split("_")[0] in MOMENTS]
    plain = [n for n in got.column_names if n not in moment]
    if keys:
        order = [(x, "ascending") for x in keys]
        got, want = got.sort_by(order), want.sort_by(order)
    assert_tables_equal(got.select(plain), want.select(plain))
    key_rows = list(zip(*[got.column(x).to_pylist() for x in keys])) \
        if keys else [()]
    for name in moment:
        fn, x = name.split("_", 1)
        scale = _group_scale(t, keys, x)
        for kr, a, e in zip(key_rows, got.column(name).to_pylist(),
                            want.column(name).to_pylist()):
            if e is None or a is None:
                assert a is None and e is None, (name, kr, a, e)
                continue
            if math.isnan(e) or math.isinf(e):
                assert (math.isnan(a) and math.isnan(e)) or a == e, \
                    (name, kr, a, e)
                continue
            mag = scale.get(kr, 0.0)
            floor = MOMENT_ABS * (mag * mag if fn.startswith("Var")
                                  else mag)
            assert math.isclose(a, e, rel_tol=REL_TOL, abs_tol=floor), \
                (name, kr, a, e)


@pytest.fixture(scope="module")
def values():
    return _values_table()


def _keyed_aggs(c, A):
    return _breadth_aggs(c, A) + _first_last_aggs(c, A)


@pytest.fixture(scope="module")
def jax_keyed(values):
    """The JAX package's COMPLETE aggregate over the whole table in one
    batch, every new function at once (run once for the module)."""
    return _jax_collect(jexec.HashAggregateExec(
        [jcol("k")], _keyed_aggs(jcol, jagg),
        jexec.InMemoryScanExec(values), jexec.AggregateMode.COMPLETE))


@pytest.mark.parametrize("batch_rows,two_stage,slices", [
    (None, False, 1), (128, False, 1), (128, True, 3)],
    ids=["complete", "complete-batches", "partial-final"])
def test_new_aggregates_match_jax(values, jax_keyed, batch_rows, two_stage,
                                  slices):
    """Min and Max over every type, the moments over int, bigint and
    double (with NaN), First and Last: the port's COMPLETE over one batch
    and over several, and its PARTIAL -> exchange -> FINAL over three
    slices, against the JAX package's rows. First and Last are held only
    where input order defines them (one slice)."""
    aggs = _keyed_aggs if slices == 1 else _breadth_aggs
    got = collect(_port_plan(values, ("k",), aggs, batch_rows, two_stage,
                             slices))
    want = jax_keyed.select(got.column_names)
    assert got.num_rows == want.num_rows == N_KEYS + 1
    _assert_breadth(got, want, values, ("k",))
    by_key = dict(zip(got.column("k").to_pylist(), rows_of(got)))
    # key 9's values are all null: every aggregate is null
    assert all(v is None for v in by_key[9][1:])
    row8 = dict(zip(got.column_names, by_key[8]))
    # one row: the sample moments are null, the population ones 0
    assert row8["VarianceSamp_f"] is None and row8["VariancePop_f"] == 0.0
    nan_var = got.column("VariancePop_fn").to_pylist()
    assert any(v is not None and math.isnan(v) for v in nan_var)


def _pyarrow_keyless(t):
    """The keyless aggregates of ``_breadth_aggs`` by pyarrow alone."""
    out = {}
    for x in MINMAX_COLS:
        mm = pc.min_max(t.column(x))
        out[f"min_{x}"], out[f"max_{x}"] = mm["min"], mm["max"]
    for x in MOMENT_COLS:
        v = t.column(x).cast(pa.float64(), safe=False)
        out[f"VarianceSamp_{x}"] = pc.variance(v, ddof=1)
        out[f"VariancePop_{x}"] = pc.variance(v, ddof=0)
        out[f"StddevSamp_{x}"] = pc.stddev(v, ddof=1)
        out[f"StddevPop_{x}"] = pc.stddev(v, ddof=0)
    return pa.table({n: pa.array([v.as_py()], v.type)
                     for n, v in out.items()})


@pytest.mark.parametrize("two_stage", [False, True],
                         ids=["complete", "partial-final"])
def test_keyless_new_aggregates_match_pyarrow(values, two_stage):
    """The global aggregate (one group of every row) against pyarrow; the
    NaN rows are left out, where Min/Max differ (see below) and pyarrow
    skips them."""
    nan = pc.fill_null(pc.is_nan(values.column("fn")), False)
    t = values.filter(pc.invert(nan))
    got = collect(_port_plan(t, (), _breadth_aggs, 128, two_stage,
                             3 if two_stage else 1))
    _assert_breadth(got, _pyarrow_keyless(t), t, ())


def test_minmax_nan_follows_spark():
    """The difference from the JAX package, pinned: in a group holding NaN
    and numbers, Spark's (and the port's) max is NaN and min the least
    number; JAX gives NaN for both. An all-NaN group gives NaN for both
    everywhere."""
    k = np.array([0, 0, 0, 1, 1, 2], np.int32)
    f = np.array([np.nan, 1.5, -2.0, np.nan, np.nan, -0.0])
    t = pa.table({"k": k, "f": f})
    aggs = lambda c, A: [A.Min(c("f")).alias("mn"),  # noqa: E731
                         A.Max(c("f")).alias("mx")]
    got = collect(_port_plan(t, ("k",), aggs, None, False)).sort_by("k")
    mn, mx = got.column("mn").to_pylist(), got.column("mx").to_pylist()
    assert mn[0] == -2.0 and math.isnan(mx[0])
    assert math.isnan(mn[1]) and math.isnan(mx[1])
    assert mn[2] == 0.0 and mx[2] == 0.0
    # the same over PARTIAL -> FINAL, where the NaN meets in the merge
    split = collect(_port_plan(t, ("k",), aggs, 1, True, 3)).sort_by("k")
    assert split.column("mn").to_pylist()[0] == -2.0
    assert math.isnan(split.column("mx").to_pylist()[0])
    jscan = jexec.InMemoryScanExec(t)
    want = _jax_collect(jexec.HashAggregateExec(
        [jcol("k")], aggs(jcol, jagg), jscan,
        jexec.AggregateMode.COMPLETE)).sort_by("k")
    assert math.isnan(want.column("mn").to_pylist()[0])
    assert math.isnan(want.column("mx").to_pylist()[0])


def test_first_last_partials_without_a_value_lose():
    """A FINAL merge never takes a partial that saw no row of the group:
    one row per group per slice keeps the order defined."""
    t = pa.table({"k": pa.array([1, 2, 1, 2], pa.int32()),
                  "v": pa.array([10, None, 30, 40], pa.int64())})
    aggs = lambda c, A: [A.First(c("v")).alias("f"),  # noqa: E731
                         A.Last(c("v")).alias("l")]
    got = collect(_port_plan(t, ("k",), aggs, 2, True, 2)).sort_by("k")
    assert got.column("f").to_pylist() == [10, None]
    assert got.column("l").to_pylist() == [30, 40]


def _percentile_table():
    rng = np.random.default_rng(5)
    n = 300
    k = rng.integers(0, 6, n).astype(np.int32)
    k[:1], k[1:12] = 7, 8          # a group of one, a group of nulls only
    v = rng.integers(-1000, 1000, n).astype(np.float64)
    v[20:24] = [np.inf, -np.inf, -0.0, 0.0]
    null = rng.random(n) < 0.2
    null[1:12], null[0] = True, False
    return pa.table({"k": k, "v": pa.array(v, mask=null),
                     "w": pa.array(rng.integers(-50, 50, n), mask=null)})


@pytest.mark.parametrize("pct", [0.0, 0.5, 1.0, 0.37])
def test_percentile_matches_jax(pct):
    t = _percentile_table()

    def aggs(c, A):
        return [A.Percentile(c("v"), pct).alias("p"),
                A.Count(c("v")).alias("n"), A.Min(c("w")).alias("mw")]

    def approx(c, A):
        return [A.ApproxPercentile(c("w"), pct, 100).alias("a")]

    want = _jax_collect(jexec.HashAggregateExec(
        [jcol("k")], aggs(jcol, jagg),
        jexec.InMemoryScanExec(t, batch_rows=100),
        jexec.AggregateMode.COMPLETE)).sort_by("k")
    got = collect(HashAggregateExec(
        [col("k")], aggs(col, tagg),
        InMemoryScanExec(t, batch_rows=100, device="cpu"))).sort_by("k")
    assert_tables_equal(got, want, approx_float=False)
    by_key = dict(zip(got.column("k").to_pylist(),
                      got.column("p").to_pylist()))
    assert by_key[8] is None and by_key[7] is not None
    # keyless, and exact: the interpolated percentile of the non-null
    # values, whatever the accuracy argument
    got_a = collect(HashAggregateExec(
        [], approx(col, tagg), InMemoryScanExec(t, device="cpu")))
    w = np.sort(t.column("w").drop_null().to_numpy())
    r = pct * (len(w) - 1)
    lo, hi = math.floor(r), math.ceil(r)
    assert got_a.column("a")[0].as_py() == \
        (1 - (r - lo)) * w[lo] + (r - lo) * w[hi]


@pytest.mark.parametrize("mode", [AggregateMode.PARTIAL,
                                  AggregateMode.FINAL, "two"])
def test_percentile_mode_errors(mode):
    """Both packages refuse a sort-sensitive aggregate outside COMPLETE,
    and two of them in one exec."""
    t = _percentile_table()
    scan = InMemoryScanExec(t, device="cpu")
    jscan = jexec.InMemoryScanExec(t)
    if mode == "two":
        with pytest.raises(ValueError, match="one sort-sensitive"):
            HashAggregateExec([col("k")], [tagg.Percentile(col("v"), 0.5),
                                           tagg.ApproxPercentile(col("w"))],
                              scan)
        with pytest.raises(ValueError, match="one sort-sensitive"):
            jexec.HashAggregateExec(
                [jcol("k")], [jagg.Percentile(jcol("v"), 0.5),
                              jagg.ApproxPercentile(jcol("w"))], jscan)
        return
    # bound functions: a FINAL stage would otherwise take its functions
    # from the PARTIAL stage below it
    pct = tagg.Percentile(col("v"), 0.5).bind(scan.output_schema)
    jpct = jagg.Percentile(jcol("v"), 0.5).bind(jscan.output_schema)
    with pytest.raises(ValueError, match="COMPLETE mode only"):
        HashAggregateExec([col("k")], [pct], scan, mode)
    with pytest.raises(ValueError, match="COMPLETE mode only"):
        jexec.HashAggregateExec([jcol("k")], [jpct], jscan,
                                jexec.AggregateMode[mode.name])


def test_keyless_new_aggregates_over_empty_input():
    """A global aggregate over no row yields one row: every new aggregate
    null, as in the JAX package (a sort-sensitive one through its own
    branch)."""
    t = _values_table().slice(0, 0)

    def aggs(c, A):
        return [A.Min(c("s")).alias("mn"), A.Max(c("l")).alias("mx"),
                A.StddevSamp(c("f")).alias("sd"),
                A.VariancePop(c("i")).alias("vp"),
                A.First(c("b")).alias("fb"), A.Last(c("d")).alias("ld")]

    want = _jax_collect(jexec.HashAggregateExec(
        [], aggs(jcol, jagg), jexec.InMemoryScanExec(t),
        jexec.AggregateMode.COMPLETE))
    got = collect(_port_plan(t, (), aggs, None, True))
    assert got.num_rows == want.num_rows == 1
    assert all(v is None for v in rows_of(got)[0])
    assert_tables_equal(got, want)
    pct = collect(HashAggregateExec([], [tagg.Percentile(col("f"), 0.5)],
                                    InMemoryScanExec(t, device="cpu")))
    assert pct.column(0).to_pylist() == [None]


def test_isnan_matches_jax(values):
    from spark_rapids_tpu.exec import ProjectExec as JProject
    exprs = lambda c, N: [N(c("fn")), N(c("f")), N(c("i"))]  # noqa: E731
    want = jexec.collect(JProject(exprs(jcol, JIsNaN),
                                  jexec.InMemoryScanExec(values)))
    got = collect(ProjectExec(exprs(col, IsNaN),
                              InMemoryScanExec(values, device="cpu")))
    # isnan(null): false in the port (Spark), null on the JAX device
    for k, name in enumerate(("fn", "f", "i")):
        g = got.column(k).to_pylist()
        w = want.column(k).to_pylist()
        assert [v for v, x in zip(g, w) if x is not None] == \
            [x for x in w if x is not None]
        assert {v for v, x in zip(g, w) if x is None} == {False}
        assert None not in g
        assert sum(x is None for x in w) == values.column(name).null_count
    assert sum(v is True for v in got.column(0).to_pylist()) == 4


def test_fused_mask_matches_the_graft_q1_stage():
    """``entry.q1_stage`` against ``__graft_entry__._q1_stage`` on one
    lineitem batch: the fused update's groups, then FINAL over them."""
    table = entry.lineitem_table(5000, seed=9).drop_columns(["l_tax"])
    jbatch, jschema = jfrom_arrow(table)
    jstage, _, jfinal, _ = graft._q1_stage(jschema)
    batch, schema = from_arrow(table, device="cpu")
    stage, _, final, cond = entry.q1_stage(schema, device="cpu")
    jout = jstage(jbatch)
    out = stage(batch)
    assert int(out.num_rows) == int(jout.num_rows) == 6
    assert out.capacity == batch.capacity
    keys = [("l_returnflag", "ascending"), ("l_linestatus", "ascending")]
    from spark_rapids_tpu.batch import to_arrow as jto_arrow
    buf_schema = final.child.output_schema
    assert_tables_equal(to_arrow(out, buf_schema).sort_by(keys),
                        jto_arrow(jout, jfinal.child.output_schema)
                        .sort_by(keys))
    got = to_arrow(final._merge_kernel(out, final=True),
                   final.output_schema).sort_by(keys)
    want = jto_arrow(jfinal._merge_kernel(jout, final=True),
                     jfinal.output_schema).sort_by(keys)
    assert_tables_equal(got, want)
    # and the filter fused: the same groups as filtering first
    kept = table.filter(pc.less_equal(table.column("l_shipdate"),
                                      entry.Q1_SHIPDATE_MAX))
    assert sum(got.column("count_order").to_pylist()) == kept.num_rows
    c = cond.eval(batch)
    assert int((c.data & c.validity).sum()) == kept.num_rows


def _tier_table(groups, rows=512, seed=3):
    rng = np.random.default_rng(seed)
    k = rng.permutation(np.arange(rows) % groups).astype(np.int32)
    return pa.table({"k": k, "q": rng.integers(-5, 5, rows),
                     "p": rng.uniform(-1, 1, rows)})


@pytest.mark.parametrize("groups", [6, 128, 512],
                         ids=["6-groups", "quarter", "full"])
def test_capacity_tiers_give_the_ports_rows(groups):
    """The JAX package's static-shape answer to the group count
    (``small_groups_bucket``, ``layout_tiers``: lax.cond over prebuilt
    layouts) against the port's layout sized from the observed count: the
    same rows under the default tiers, a 128-slot small bucket and
    explicit tiers, at 6 groups, a quarter of capacity and all of it."""
    t = _tier_table(groups)

    def aggs(c, A):
        return [A.Sum(c("q")).alias("sq"), A.Sum(c("p")).alias("sp"),
                A.Min(c("p")).alias("mn"), A.Count().alias("n")]

    got = collect(HashAggregateExec([col("k")], aggs(col, tagg),
                                    InMemoryScanExec(t, device="cpu")))
    assert got.num_rows == groups
    for kw in ({}, {"small_groups_bucket": 128},
               {"layout_tiers": (8, 256, 512)}):
        want = _jax_collect(jexec.HashAggregateExec(
            [jcol("k")], aggs(jcol, jagg), jexec.InMemoryScanExec(t),
            jexec.AggregateMode.COMPLETE, **kw))
        assert_tables_equal(got, want, ignore_order=True)


@pytest.mark.parametrize("two_stage", [False, True],
                         ids=["complete", "partial-final"])
def test_hash_agg_shape_matches_jax_and_pyarrow(two_stage):
    """``bench.bench_hash_agg``'s aggregate at a small n."""
    import bench
    n, n_keys = 4000, 1000
    table = entry.hash_agg_table(n, n_keys)
    assert table.equals(bench.store_sales_table(n, n_keys))
    plan = entry.hash_agg_plan(table, two_stage, num_slices=3,
                               shuffle_partitions=4, device="cpu")
    assert plan.child.num_partitions == (4 if two_stage else 1)
    assert [e.mode.name for e in [plan] + list(plan.children[0].children)
            if hasattr(e, "mode")] == (["FINAL", "PARTIAL"] if two_stage
                                       else ["COMPLETE"])
    got = collect(plan).sort_by("ss_item_sk")
    assert_tables_equal(got, entry.hash_agg_reference(table))
    if not two_stage:
        jagg_exec = jexec.HashAggregateExec(
            [jcol("ss_item_sk")],
            [jagg.Sum(jcol("ss_quantity")).alias("sq"),
             jagg.Sum(jcol("ss_net_profit")).alias("sp"),
             jagg.Average(jcol("ss_sales_price")).alias("ap"),
             jagg.Count().alias("c")],
            jexec.InMemoryScanExec(table), jexec.AggregateMode.COMPLETE)
        assert_tables_equal(got, _jax_collect(jagg_exec), ignore_order=True)


def test_int64_minmax_is_exact_beyond_float64():
    """int64 extremes reduce in their own dtype: no float64 rounding."""
    lo, hi = np.iinfo(np.int64).min, np.iinfo(np.int64).max
    t = pa.table({"k": pa.array([0, 0, 0, 1, 1], pa.int32()),
                  "v": pa.array([hi, hi - 1, 3, lo + 1, lo], pa.int64())})
    aggs = lambda c, A: [A.Min(c("v")).alias("mn"),  # noqa: E731
                         A.Max(c("v")).alias("mx")]
    got = collect(_port_plan(t, ("k",), aggs, 2, True, 2)).sort_by("k")
    assert got.column("mn").to_pylist() == [3, lo]
    assert got.column("mx").to_pylist() == [hi, lo + 1]


# ---------------------------------------------------------------------------
# decimal sum and average: Spark's result types, against the JAX Session
# ---------------------------------------------------------------------------

def _decimal_table(precision):
    from decimal import Decimal
    top = Decimal(10 ** (precision - 2) - 1) / 100      # the largest value
    return pa.table({
        "k": pa.array([0, 0, 1, 1, 2], pa.int32()),
        "x": pa.array([top, Decimal("-0.01"), Decimal("1.50"), None, None],
                      pa.decimal128(precision, 2))})


@pytest.mark.parametrize("precision", [5, 10])
@pytest.mark.parametrize("fn", ["Sum", "Average"])
@pytest.mark.parametrize("grouped", [True, False], ids=["grouped", "global"])
def test_decimal_sum_and_average_types_match_jax(precision, fn, grouped):
    """sum(decimal(p, s)) is decimal(p + 10, s) and avg(decimal(p, s))
    decimal(p + 4, s + 4), as in the JAX Session (the port typed both as
    int64 and float64 before). Every sum runs on the device (a wider one
    over DECIMAL128 limbs, as in the JAX package); every decimal average
    runs as a CPU island."""
    from spark_rapids_tpu.plan import Session as JSession
    from spark_rapids_tpu.plan import table as jtable
    from spark_rapids_tpu_torch.plan import Session, table
    t = _decimal_table(precision)

    def q(tbl, c, aggs):
        df = tbl(t)
        agg = getattr(aggs, fn)(c("x")).alias("r")
        return (df.group_by("k").agg(agg) if grouped else df.agg(agg))
    jses = JSession({})
    want = jses.collect(q(jtable, jcol, jagg))
    ses = Session({}, device="cpu")
    got = ses.collect(q(table, col, tagg))
    assert got.schema.field("r").type == want.schema.field("r").type
    assert_tables_equal(got, want, ignore_order=True)
    island = fn == "Average"
    assert ses.fell_back() == (["CpuFallback[Aggregate]"] if island else [])
    assert ses.fell_back() == jses.fell_back()


@pytest.mark.parametrize("fn", ["Sum", "Average"])
def test_decimal_aggregate_types_are_the_jax_types(fn):
    """The bound result type alone (the port's Average over a decimal was
    float64, its Sum int64)."""
    from spark_rapids_tpu.batch import schema_from_arrow as jschema_of
    from spark_rapids_tpu_torch.batch import schema_from_arrow
    t = _decimal_table(5)
    got = getattr(tagg, fn)(col("x")).bind(schema_from_arrow(t.schema)).dtype
    want = getattr(jagg, fn)(jcol("x")).bind(jschema_of(t.schema)).dtype
    assert (got.kind.value, got.precision, got.scale) == \
        (want.kind.value, want.precision, want.scale) == \
        ("decimal", 15 if fn == "Sum" else 9, 2 if fn == "Sum" else 6)
