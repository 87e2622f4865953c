"""The port's fused stage (``exec/fuse.py``) against the JAX package's
``FusedStage.run()`` and against the port's own iterator path, on the same
numpy-made inputs: every fusable node (project, filter, the INNER,
LEFT_OUTER, LEFT_SEMI, LEFT_ANTI and EXISTENCE joins on an exact, a dense
and a hashed key, with and without a condition, COMPLETE and PARTIAL
aggregates (also straight over an INNER join, which feeds them its pairs
uncompacted), sort, top-N, limit, a string filter), the Session-free cases
of ``tests/test_fuse.py`` as plans (the 8x overflow retry, an ANSI
multiply overflow raising, clean ANSI inputs passing, an exchange plan not
fusing), a divide by zero, and a kept branch whose input changes.

On the CPU the fused program runs eagerly (there is no graph). Integers,
strings and nulls compare exactly, doubles within rel 1e-6 (the packages
sum in other orders); plans topped by a sort on a unique key compare in
order. The JAX side runs with ``jax_disable_jit``: its fused program
traces op by op, with no compile a case."""

from types import SimpleNamespace

import jax
import numpy as np
import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu import exec as jexec
from spark_rapids_tpu.batch import to_arrow as jax_to_arrow
from spark_rapids_tpu.exec import fuse as jfuse
from spark_rapids_tpu.exec import sort as jsort
from spark_rapids_tpu.exec.basic import \
    ArithmeticException as JArithmeticException
from spark_rapids_tpu.expressions import aggregates as JAgg
from spark_rapids_tpu.expressions import base as jbase
from spark_rapids_tpu.expressions import strings as jstrings
from spark_rapids_tpu.shuffle import exchange as jex
from spark_rapids_tpu.shuffle.partitioning import \
    HashPartitioning as JHashPartitioning
import spark_rapids_tpu.expressions as jexpr
from spark_rapids_tpu_torch import entry
from spark_rapids_tpu_torch import exec as texec
from spark_rapids_tpu_torch import expressions as texpr
from spark_rapids_tpu_torch.batch import to_arrow
from spark_rapids_tpu_torch.exec import fuse as tfuse
from spark_rapids_tpu_torch.exec import sort as tsort
from spark_rapids_tpu_torch.exec.basic import ArithmeticException
from spark_rapids_tpu_torch.expressions import aggregates as TAgg
from spark_rapids_tpu_torch.expressions import base as tbase
from spark_rapids_tpu_torch.expressions import strings as tstrings
from spark_rapids_tpu_torch.shuffle import (HashPartitioning,
                                            ShuffleExchangeExec)
from tests.harness.asserts import assert_tables_equal

JT = jexec.JoinType


@pytest.fixture(autouse=True)
def _jax_eager():
    with jax.disable_jit():
        yield


PORT = SimpleNamespace(
    ex=texec, x=texpr, A=TAgg, sort=tsort, base=tbase, strings=tstrings,
    fuse=tfuse, to_arrow=to_arrow, JoinType=texec.JoinType,
    scan=lambda t: texec.InMemoryScanExec(t, device="cpu"))
JAX = SimpleNamespace(
    ex=jexec, x=jexpr, A=JAgg, sort=jsort, base=jbase, strings=jstrings,
    fuse=jfuse, to_arrow=jax_to_arrow, JoinType=JT,
    scan=lambda t: jexec.InMemoryScanExec(t))


def _tables(seed=11, n=200, n_build=32, dup=False):
    """A stream with null and unmatched keys, a build on 0..n_build-1
    (each key twice for the first three when ``dup``)."""
    rng = np.random.default_rng(seed)
    k = rng.integers(0, n_build + 8, n)
    stream = pa.table({
        "k": pa.array(k, pa.int64(), mask=rng.random(n) < 0.05),
        "v": rng.permutation(n).astype(np.float64) * 1.5 - 100.0,
        "s": rng.integers(0, 6, n).astype(np.int32),
        "k32": (k % 11).astype(np.int32),
    })
    bk = np.arange(n_build)
    if dup:
        bk = np.concatenate([bk, [0, 1, 2]])
    m = len(bk)
    build = pa.table({
        "bk": pa.array(bk, pa.int64()),
        "w": rng.integers(-50, 50, m).astype(np.int64),
        "c": rng.integers(0, 5, m).astype(np.int32),
        "bk32": (bk % 11).astype(np.int32),
        "bs": rng.integers(0, 6, m).astype(np.int32),
    })
    return stream, build


def _join(P, how, stream, build, keys="exact", condition=False):
    c = P.x.col
    lk, rk = {"exact": (["k"], ["bk"]),
              "hashed": (["k32", "s"], ["bk32", "bs"])}[keys]
    cond = P.x.GreaterThan(c("v"), c("w")) if condition else None
    return P.ex.HashJoinExec([c(x) for x in lk], [c(x) for x in rk],
                             getattr(P.JoinType, how), P.scan(stream),
                             P.scan(build), cond)


def _aggs(P):
    c = P.x.col
    return [P.A.Sum(c("v")).alias("sv"), P.A.Count().alias("n"),
            P.A.Average(c("v")).alias("av"), P.A.Min(c("k")).alias("mk"),
            P.A.Max(c("v")).alias("xv")]


def _plans():
    """name -> (plan maker(P), inputs maker, compare in order)."""
    def sorted_join(how, keys="exact", dup=False, condition=False):
        def make(P, t):
            s, b = t
            return P.ex.SortExec([P.sort.desc(P.x.col("v"))],
                                 _join(P, how, s, b, keys, condition))
        return make, (lambda: _tables(dup=dup)), True

    def agg_over(child, mode, keys=("s",)):
        def make(P, t):
            m = getattr(P.ex.AggregateMode, mode)
            return P.ex.HashAggregateExec([P.x.col(k) for k in keys],
                                          _aggs(P), child(P, t), m)
        return make, _tables, False

    def filtered(P, t):
        return P.ex.FilterExec(P.x.col("k") > P.x.lit(5), P.scan(t[0]))

    def inner(P, t):
        return _join(P, "INNER", t[0], t[1])

    def left_outer(P, t):
        return _join(P, "LEFT_OUTER", t[0], t[1])

    plans = {
        "project_filter": (lambda P, t: P.ex.ProjectExec(
            [(P.x.col("k") * P.x.lit(2)).alias("k2"), P.x.col("v"),
             (P.x.col("s") + P.x.lit(1)).alias("s1")], filtered(P, t)),
            _tables, True),
        "top_n": (lambda P, t: P.ex.TakeOrderedAndProjectExec(
            10, [P.sort.desc(P.x.col("v"))], [P.x.col("k"), P.x.col("v")],
            filtered(P, t)), _tables, True),
        "local_limit": (lambda P, t: P.ex.LocalLimitExec(
            17, P.ex.SortExec([P.sort.asc(P.x.col("v"))], filtered(P, t))),
            _tables, True),
        "complete_agg": agg_over(filtered, "COMPLETE"),
        "global_agg": agg_over(filtered, "COMPLETE", keys=()),
        "partial_agg": agg_over(filtered, "PARTIAL"),
        "complete_agg_over_inner_join": agg_over(inner, "COMPLETE",
                                                 keys=("c",)),
        "partial_agg_over_inner_join": agg_over(inner, "PARTIAL",
                                                keys=("c", "s")),
        "complete_agg_over_left_outer_join": agg_over(left_outer,
                                                      "COMPLETE",
                                                      keys=("c",)),
    }
    for how in ("INNER", "LEFT_OUTER", "LEFT_SEMI", "LEFT_ANTI",
                "EXISTENCE"):
        plans[f"{how}_dense"] = sorted_join(how)
        plans[f"{how}_duplicates"] = sorted_join(how, dup=True)
        plans[f"{how}_hashed"] = sorted_join(how, keys="hashed")
    plans["INNER_condition"] = sorted_join("INNER", condition=True)
    plans["LEFT_OUTER_condition"] = sorted_join("LEFT_OUTER",
                                                condition=True)
    plans["LEFT_SEMI_condition"] = sorted_join("LEFT_SEMI", dup=True,
                                               condition=True)
    return plans


PLANS = _plans()


def _fused(P, plan):
    stage = P.fuse.try_fuse(plan)
    assert stage is not None
    return P.to_arrow(stage.run(), plan.output_schema)


@pytest.mark.parametrize("name", list(PLANS))
def test_fused_stage_matches_jax_and_iterator(name):
    make, inputs, ordered = PLANS[name]
    t = inputs()
    got = _fused(PORT, make(PORT, t))
    want = _fused(JAX, make(JAX, t))
    assert got.schema.names == want.schema.names
    assert_tables_equal(got, want, ignore_order=not ordered)
    # the port's fused stage gives its iterator path's rows
    it = texec.collect(make(PORT, t))
    assert_tables_equal(got, it, ignore_order=not ordered)


def test_fused_string_filter_matches_jax():
    """Q2's part filter, p_size = 15 AND endswith(p_type, 'BRASS'), then a
    projection: the stage whose captured form launches ``window_match``."""
    part = entry.part_table(3000, seed=4)

    def make(P):
        c = P.x.col
        cond = P.x.And(P.x.EqualTo(c("p_size"), P.x.lit(15)),
                       P.strings.endswith(c("p_type"), "BRASS"))
        return P.ex.ProjectExec([c("p_brand"), c("p_type")],
                                P.ex.FilterExec(cond, P.scan(part)))
    got = _fused(PORT, make(PORT))
    assert got.num_rows > 0
    assert_tables_equal(got, _fused(JAX, make(JAX)))
    assert_tables_equal(got, texec.collect(make(PORT)))


def test_fused_join_overflow_retry():
    """``test_fuse.py``'s case: every probe matches 8 build rows, so the
    optimistic 1x bucket overflows; ``run()`` re-plans at the needed
    factor and gives the exact join."""
    n = 256
    stream = pa.table({"k": np.arange(n, dtype=np.int64) % 16,
                       "v": np.arange(n, dtype=np.float64)})
    build = pa.table({"bk": np.repeat(np.arange(16, dtype=np.int64), 8),
                      "w": np.arange(128, dtype=np.int64)})

    def make(P):
        join = P.ex.HashJoinExec([P.x.col("k")], [P.x.col("bk")],
                                 P.JoinType.INNER, P.scan(stream),
                                 P.scan(build))
        return P.ex.SortExec([P.sort.desc(P.x.col("v"))], join)
    plan = make(PORT)
    stage = tfuse.try_fuse(plan, expand_factor=1)
    got = to_arrow(stage.run(), plan.output_schema)
    assert stage.retries == 1 and stage.expand_factor == 8
    jplan = make(JAX)
    want = jax_to_arrow(jfuse.try_fuse(jplan).run(), jplan.output_schema)
    expected = stream.join(build, keys="k", right_keys="bk",
                           join_type="inner")
    assert got.num_rows == want.num_rows == expected.num_rows == n * 8
    key = [("v", "ascending"), ("w", "ascending")]
    assert_tables_equal(got.select(["k", "v", "w"]).sort_by(key),
                        expected.select(["k", "v", "w"]).sort_by(key))
    assert_tables_equal(got.sort_by(key), want.sort_by(key))
    # a second run starts at the grown factor
    again = to_arrow(stage.run(), plan.output_schema)
    assert stage.retries == 1 and again.equals(got)


def _ansi_plan(P, values, expr):
    t = pa.table({"a": pa.array(values, pa.int64()),
                  "z": pa.array([1] * (len(values) - 1) + [0], pa.int64())})
    return P.ex.ProjectExec([expr(P).alias("x")], P.scan(t),
                            ctx=P.base.EvalContext(True))


def test_fused_ansi_overflow_raises():
    def times4(P):
        return P.x.col("a") * P.x.lit(4)
    with pytest.raises(ArithmeticException, match="ARITHMETIC_OVERFLOW"):
        tfuse.try_fuse(_ansi_plan(PORT, [1, 2, 2 ** 62], times4)).run()
    with pytest.raises(JArithmeticException, match="ARITHMETIC_OVERFLOW"):
        jfuse.try_fuse(_ansi_plan(JAX, [1, 2, 2 ** 62], times4)).run()


def test_fused_divide_by_zero_raises():
    def div(P):
        return P.x.Divide(P.x.col("a"), P.x.col("z"))
    with pytest.raises(ArithmeticException, match="DIVIDE_BY_ZERO"):
        tfuse.try_fuse(_ansi_plan(PORT, [1, 2, 3], div)).run()
    with pytest.raises(JArithmeticException, match="DIVIDE_BY_ZERO"):
        jfuse.try_fuse(_ansi_plan(JAX, [1, 2, 3], div)).run()


def test_fused_ansi_clean_inputs_pass():
    def times4(P):
        return P.x.col("a") * P.x.lit(4)
    plan = _ansi_plan(PORT, [1, 2, 3], times4)
    got = to_arrow(tfuse.try_fuse(plan).run(), plan.output_schema)
    jplan = _ansi_plan(JAX, [1, 2, 3], times4)
    want = jax_to_arrow(jfuse.try_fuse(jplan).run(), jplan.output_schema)
    assert got.column("x").to_pylist() == want.column("x").to_pylist() \
        == [4, 8, 12]


def test_fusion_skips_exchange_plans():
    t = pa.table({"g": np.arange(64, dtype=np.int64) % 4,
                  "a": np.arange(64, dtype=np.int64)})

    def make(P, exchange, part):
        scan = P.ex.InMemoryScanExec(t, **({"device": "cpu"}
                                           if P is PORT else {}))
        partial = P.ex.HashAggregateExec(
            [P.x.col("g")], [P.A.Sum(P.x.col("a")).alias("s")], scan,
            P.ex.AggregateMode.PARTIAL)
        return P.ex.HashAggregateExec(
            [P.x.col("g")], [P.A.Sum(P.x.col("a")).alias("s")],
            exchange(part([P.x.col("g")], 4), partial),
            P.ex.AggregateMode.FINAL)
    assert tfuse.try_fuse(make(PORT, ShuffleExchangeExec,
                               HashPartitioning)) is None
    assert jfuse.try_fuse(make(JAX, jex.ShuffleExchangeExec,
                               JHashPartitioning)) is None
    assert tfuse.try_fuse_exec(make(PORT, ShuffleExchangeExec,
                                    HashPartitioning)) is None


def test_fusion_refuses_what_jax_refuses():
    s, b = _tables()
    outer = _join(PORT, "FULL_OUTER", s, b)
    assert tfuse.try_fuse(outer) is None
    aggs = [TAgg.Sum(texpr.col("v")).alias("sv")]
    partial = texec.HashAggregateExec([texpr.col("s")], aggs, PORT.scan(s),
                                      texec.AggregateMode.PARTIAL)
    final = texec.HashAggregateExec([texpr.col("s")], aggs, partial,
                                    texec.AggregateMode.FINAL)
    assert tfuse.try_fuse(final) is None
    pct = texec.HashAggregateExec([texpr.col("s")], [TAgg.Percentile(
        texpr.col("v"), 0.5).alias("p")], PORT.scan(s))
    assert tfuse.try_fuse(pct) is None
    two_batches = texec.InMemoryScanExec(s, batch_rows=64, device="cpu")
    assert tfuse.try_fuse(two_batches) is None


def test_fused_stage_exec_and_a_tripped_branch():
    """``FusedStageExec`` yields the stage's rows through ``collect``. A
    branch kept from the planning run (the dense build, the 1:1 expansion)
    is guarded: when the staged input changes under it, the guard trips
    and the stage plans again, still giving the right rows."""
    s, b = _tables()
    plan = PORT.ex.SortExec([tsort.desc(texpr.col("v"))],
                            _join(PORT, "INNER", s, b))
    exec_ = tfuse.try_fuse_exec(plan)
    got = texec.collect(exec_)
    assert_tables_equal(got, texec.collect(plan))
    stage = exec_.stage
    assert stage._choices == {("dense", id(plan.children[0])): True,
                              ("unique", id(plan.children[0])): True}
    # every build key now shared by two rows: no longer dense, nor 1:1
    build = stage.inputs[1]
    build.columns[0].data[1::2] = build.columns[0].data[0::2].clone()
    retries = stage.retries
    rows = to_arrow(stage.run(), plan.output_schema)
    assert stage.retries == retries + 1
    assert stage._choices[("dense", id(plan.children[0]))] is False
    bk = build.columns[0].data[:int(build.num_rows)].numpy()
    w = build.columns[1].data[:int(build.num_rows)].numpy()
    want = s.join(pa.table({"bk": bk, "w": w}), keys="k", right_keys="bk",
                  join_type="inner")
    assert rows.num_rows == want.num_rows
    assert sorted(rows.column("w").to_pylist()) == \
        sorted(want.column("w").to_pylist())


def test_join_sort_shape_fuses_to_jax_rows():
    """The bench's join_sort plan at 2^12 x 2^9 in all three modes of
    ``entry.run_join_sort`` (on the CPU ``graph`` is the eager program)
    against the JAX fused stage and pyarrow."""
    stream, build = entry.join_sort_tables(1 << 12, 1 << 9)
    want = entry.join_sort_reference(stream, build)
    joined = stream.join(build, keys="l_orderkey", right_keys="o_orderkey",
                         join_type="inner")
    assert want.equals(joined.sort_by([("l_revenue", "descending")]).select(
        want.column_names))
    jplan = jexec.SortExec([jsort.desc(jexpr.col("l_revenue"))],
                           jexec.HashJoinExec(
                               [jexpr.col("l_orderkey")],
                               [jexpr.col("o_orderkey")], JT.INNER,
                               jexec.InMemoryScanExec(stream),
                               jexec.InMemoryScanExec(build)))
    jax_rows = jax_to_arrow(jfuse.try_fuse(jplan).run(), jplan.output_schema)
    for mode in entry.JOIN_SORT_MODES:
        got = entry.run_join_sort(stream, build, mode, device="cpu")
        assert got.equals(jax_rows), mode
        assert got.select(["l_orderkey", "l_revenue", "o_custkey"]).equals(
            want), mode
        assert got.column("o_orderkey").equals(got.column("l_orderkey"))


def test_join_sort_asks_for_cuda():
    if torch.cuda.is_available():
        pytest.skip("the card is there: the default device is CUDA")
    stream, build = entry.join_sort_tables(256, 64)
    with pytest.raises(RuntimeError, match="CUDA"):
        entry.run_join_sort(stream, build)
    with pytest.raises(ValueError):
        entry.join_sort_runner(entry.join_sort_plan(stream, build, "cpu"),
                               "bogus")


@pytest.mark.cuda
def test_fused_stage_captures_on_the_card():
    """On a card the stage is captured in a CUDA graph: the first run is
    the eager planning run, later runs replay, every run equal to the
    iterator path."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA graphs have no CPU mode "
                    "(chip_smoke.py captures the stage too)")
    stream, build = entry.join_sort_tables(1 << 14, 1 << 11)
    plan = entry.join_sort_plan(stream, build, "cuda")
    stage = tfuse.try_fuse(plan)
    first = to_arrow(stage.run(), plan.output_schema)
    second = to_arrow(stage.run(), plan.output_schema)
    assert stage.captures == 1 and stage.replays == 1
    assert first.equals(second)
    assert first.equals(entry.run_join_sort(stream, build, "iterator"))


def test_repeated_error_kind_is_not_lost():
    """Two projections report ARITHMETIC_OVERFLOW, the first on a row and
    the second on none: the port sums the kind's counts and raises, where
    the JAX ``FusedStage.run`` keeps the last count of a kind (0) and
    returns (ROADMAP Queue 3)."""
    def make(P):
        t = pa.table({"a": pa.array([1, 2 ** 62], pa.int64())})
        ctx = P.base.EvalContext(True)
        inner = P.ex.ProjectExec([(P.x.col("a") * P.x.lit(4)).alias("x")],
                                 P.scan(t), ctx=ctx)
        return P.ex.ProjectExec([(P.x.col("x") + P.x.lit(1)).alias("y")],
                                inner, ctx=ctx)
    with pytest.raises(ArithmeticException, match="ARITHMETIC_OVERFLOW"):
        tfuse.try_fuse(make(PORT)).run()
    jplan = make(JAX)
    out = jax_to_arrow(jfuse.try_fuse(jplan).run(), jplan.output_schema)
    assert out.column("y").to_pylist() == [5, 1]
