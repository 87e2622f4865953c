"""The port's ``UnionExec``, ``RangeExec`` and ``ExpandExec`` against the
JAX package's on the same inputs (the cases of ``tests/test_exec_basic.py``),
row for row and in order, and ``SampleExec`` held to what
``test_sample_is_subset_and_seeded`` checks, a seeded subset in input
order, and to the JAX package's rows: both draw threefry. The JAX side
runs with ``jax_disable_jit``."""

import jax
import numpy as np
import pyarrow as pa
import pytest

from spark_rapids_tpu import exec as jexec
from spark_rapids_tpu import types as JT
from spark_rapids_tpu.expressions import col as jcol
from spark_rapids_tpu.expressions import lit as jlit
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.exec import (ExpandExec, InMemoryScanExec,
                                         RangeExec, SampleExec, UnionExec,
                                         collect)
from spark_rapids_tpu_torch.expressions import col, lit
from tests.harness.data_gen import IntegerGen, gen_table


@pytest.fixture(autouse=True)
def _jax_eager():
    with jax.disable_jit():
        yield


def _rows(t: pa.Table):
    return list(zip(*[c.to_pylist() for c in t.columns]))


def _scan(t, slices=1, batch_rows=None):
    return InMemoryScanExec(t, batch_rows=batch_rows, num_slices=slices,
                            device="cpu")


def _jscan(t, slices=1, batch_rows=None):
    return jexec.InMemoryScanExec(t, batch_rows=batch_rows,
                                  num_slices=slices)


def test_union_matches_jax():
    t1 = gen_table([("a", IntegerGen())], n=100, seed=5)
    t2 = gen_table([("a", IntegerGen())], n=50, seed=6)
    plan = UnionExec([_scan(t1, 2, 32), _scan(t2)])
    want = jexec.collect(jexec.UnionExec([_jscan(t1, 2, 32), _jscan(t2)]))
    assert plan.num_partitions == 3
    got = collect(plan)
    assert _rows(got) == _rows(want)
    assert sorted(_rows(got), key=repr) == sorted(
        [(v,) for v in t1.column("a").to_pylist()
         + t2.column("a").to_pylist()], key=repr)


@pytest.mark.parametrize("start,end,step", [(0, 100, 1), (5, 50, 7),
                                            (10, 0, -3), (0, 0, 1)])
def test_range_matches_jax(start, end, step):
    got = collect(RangeExec(start, end, step, batch_rows=16, device="cpu"))
    want = jexec.collect(jexec.RangeExec(start, end, step, batch_rows=16))
    assert _rows(got) == _rows(want) == [(v,) for v in
                                         range(start, end, step)]
    assert got.schema == want.schema


def test_range_rejects_step_zero_and_asks_for_cuda():
    with pytest.raises(ValueError):
        RangeExec(0, 10, 0, device="cpu")
    import torch
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            RangeExec(0, 10)


def test_expand_matches_jax():
    t = gen_table([("a", IntegerGen()), ("b", IntegerGen(nullable=False))],
                  n=64, seed=7)
    plan = ExpandExec([[col("a"), lit(None, T.INT32)],
                       [col("a"), col("b")],
                       [lit(7), col("b") + lit(1)]], _scan(t))
    jplan = jexec.ExpandExec([[jcol("a"), jlit(None, JT.INT32)],
                              [jcol("a"), jcol("b")],
                              [jlit(7), jcol("b") + jlit(1)]], _jscan(t))
    got, want = collect(plan), jexec.collect(jplan)
    assert _rows(got) == _rows(want)
    # the union of the projections' nullability
    assert [f.nullable for f in plan.output_schema] == \
        [f.nullable for f in jplan.output_schema] == [True, True]


def _is_subsequence(rows, src) -> bool:
    it = iter(src)
    return all(any(s == r for s in it) for r in rows)


def test_sample_is_seeded_subset():
    t = gen_table([("a", IntegerGen(nullable=False))], n=1000, seed=8)
    src = [(v,) for v in t.column("a").to_pylist()]
    r1 = _rows(collect(SampleExec(0.3, 42, _scan(t, 2, 128))))
    r2 = _rows(collect(SampleExec(0.3, 42, _scan(t, 2, 128))))
    r3 = _rows(collect(SampleExec(0.3, 43, _scan(t, 2, 128))))
    assert r1 == r2 and r1 != r3
    assert 100 < len(r1) < 500
    # a subsequence of the rows in partition order (chunks 0, 2, ... then
    # 1, 3, ...): each partition keeps its rows in input order
    order = [r for p in range(2) for i, r in enumerate(src)
             if (i // 128) % 2 == p]
    assert _is_subsequence(r1, order)
    # the JAX package's own sample is a subset of the same size range
    j = _rows(jexec.collect(jexec.SampleExec(0.3, 42, _jscan(t))))
    assert 100 < len(j) < 500 and _is_subsequence(j, src)


@pytest.mark.parametrize("fraction,seed,slices", [(0.1, 5, 3),
                                                  (0.5, 123456, 1),
                                                  (0.01, 7, 4)])
def test_sample_keeps_the_jax_rows(fraction, seed, slices):
    t = gen_table([("a", IntegerGen(nullable=False))], n=5000, seed=9)
    t = t.append_column("i", pa.array(np.arange(5000, dtype=np.int64)))
    got = _rows(collect(SampleExec(fraction, seed,
                                   _scan(t, slices, 1024))))
    want = _rows(jexec.collect(jexec.SampleExec(fraction, seed,
                                                _jscan(t, slices, 1024))))
    assert got == want and len(got) > 0


def test_sample_keeps_all_and_none():
    t = pa.table({"a": np.arange(300, dtype=np.int64)})
    assert collect(SampleExec(1.0, 1, _scan(t))).num_rows == 300
    assert collect(SampleExec(0.0, 1, _scan(t))).num_rows == 0
