"""The port's data plane against the JAX package: Arrow round trips over
the fixed-width generators (nulls included), the batch contract array for
array, batch_from_numpy, and the device guard."""

import numpy as np
import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu.batch import from_arrow as jax_from_arrow
from spark_rapids_tpu.batch import to_arrow as jax_to_arrow
from spark_rapids_tpu_torch import batch as tb

from harness.asserts import assert_tables_equal
from harness.data_gen import (BooleanGen, DateGen, DoubleGen, IntegerGen,
                              LongGen, gen_table)

GENS = [IntegerGen(), LongGen(), DoubleGen(), BooleanGen(), DateGen()]


def _assert_same_arrays(port_batch, jax_batch):
    """Capacity, row count, payload and validity equal, padding included
    (NaN payloads compare equal to NaN)."""
    assert port_batch.capacity == jax_batch.capacity
    assert int(port_batch.num_rows) == int(jax_batch.num_rows)
    for pc, jc in zip(port_batch.columns, jax_batch.columns):
        np.testing.assert_array_equal(pc.validity.numpy(),
                                      np.asarray(jc.validity))
        np.testing.assert_array_equal(pc.data.numpy(), np.asarray(jc.data))


@pytest.mark.parametrize("gen", GENS, ids=lambda g: str(g.sql_type))
def test_round_trip_matches_jax(gen):
    t = gen_table([("a", gen)], n=1000, seed=3)
    assert t.column(0).null_count > 0
    pb, ps = tb.from_arrow(t, device="cpu")
    jb, js = jax_from_arrow(t)
    _assert_same_arrays(pb, jb)
    out = tb.to_arrow(pb, ps)
    assert out.schema == jax_to_arrow(jb, js).schema
    assert_tables_equal(out, t, approx_float=False)


def test_round_trip_all_kinds_explicit_capacity():
    t = gen_table([(f"c{i}", g) for i, g in enumerate(GENS)], n=777, seed=5)
    pb, ps = tb.from_arrow(t, capacity=4096, device="cpu")
    jb, _ = jax_from_arrow(t, capacity=4096)
    assert pb.capacity == 4096
    _assert_same_arrays(pb, jb)
    assert_tables_equal(tb.to_arrow(pb, ps), t, approx_float=False)
    # nullability is tightened from the data, as in the JAX package
    dense = pa.table({"x": pa.array([1, 2], pa.int32())})
    assert tb.from_arrow(dense, device="cpu")[1][0].nullable is False


def test_batch_from_numpy_rebuilds_a_jax_batch():
    t = gen_table([("k", IntegerGen()), ("v", DoubleGen())], n=300, seed=7)
    jb, js = jax_from_arrow(t)
    ps = tb.from_arrow(t, device="cpu")[1]
    arrays = [(np.asarray(c.data), np.asarray(c.validity))
              for c in jb.columns]
    pb = tb.batch_from_numpy(arrays, int(jb.num_rows), ps, device="cpu")
    _assert_same_arrays(pb, jb)
    assert_tables_equal(tb.to_arrow(pb, ps), t, approx_float=False)


def test_bucket_capacity_matches_jax():
    from spark_rapids_tpu.batch import bucket_capacity
    for n in (0, 1, 128, 129, 1000, 1 << 20, (1 << 20) + 1):
        assert tb.bucket_capacity(n) == bucket_capacity(n)


def test_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    t = pa.table({"x": pa.array([1, 2], pa.int32())})
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tb.from_arrow(t)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tb.resolve_device("cuda")
    assert tb.resolve_device("cpu") == torch.device("cpu")


def test_unported_types_raise():
    import decimal
    # a decimal(20, 2) column uploads as four 32-bit limbs a row, the JAX
    # package's layout, and collects to the same values
    vals = [decimal.Decimal("1.25"), None, decimal.Decimal("-1.25"),
            decimal.Decimal("-999999999999999999.99"),
            decimal.Decimal("123456789012345678.90")]
    t = pa.table({"d": pa.array(vals, pa.decimal128(20, 2))})
    got, schema = tb.from_arrow(t, device="cpu")
    want, jschema = jax_from_arrow(t)
    assert tuple(got.columns[0].data.shape) == (got.capacity, 4)
    _assert_same_arrays(got, want)
    assert tb.to_arrow(got, schema).equals(jax_to_arrow(want, jschema))
    assert tb.to_arrow(got, schema).column(0).to_pylist() == vals
    # a dictionary string column uploads as codes (dictenc.py), as in the
    # JAX package, and collects to the same rows
    t = pa.table({"s": pa.array(["a", "b", "a", None]).dictionary_encode()})
    got, schema = tb.from_arrow(t, device="cpu")
    want, jschema = jax_from_arrow(t)
    assert got.columns[0].is_dict and want.columns[0].is_dict
    np.testing.assert_array_equal(got.columns[0].data.numpy(),
                                  np.asarray(want.columns[0].data))
    assert tb.to_arrow(got, schema).equals(jax_to_arrow(want, jschema))
    assert tb.to_arrow(got, schema).column(0).to_pylist() == \
        ["a", "b", "a", None]
