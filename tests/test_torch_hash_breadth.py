"""Hashes of every flat kind against the JAX package on the CPU: murmur3
partition ids (``pmod(murmur3(row, 42), n)``, the hash exchange's routing)
and XXH64 per kind, equal to the JAX package's ``partition_ids`` /
``hash_column`` and ``xxhash64_column``, and murmur3 equal to the scalar
oracle of ``tests/harness/murmur3_oracle.py``. int8 and int16 keys reach the
``murmur3_int32`` wrapper (on the card, its kernel). Where the JAX package
departs from Spark (the float32 NaN bits), the port follows Spark and a test
pins the difference."""

import decimal as D
import struct

import jax.numpy as jnp
import numpy as np
import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu import types as JT
from spark_rapids_tpu.batch import DeviceColumn as JColumn
from spark_rapids_tpu.batch import from_arrow as jax_from_arrow
from spark_rapids_tpu.expressions import col as jcol
from spark_rapids_tpu.expressions import hashing as JH
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.batch import DeviceColumn, from_arrow
from spark_rapids_tpu_torch.exec import (InMemoryScanExec, ProjectExec,
                                         collect)
from spark_rapids_tpu_torch.expressions import col
from spark_rapids_tpu_torch.expressions import hashing as TH
from spark_rapids_tpu_torch.kernels import murmur3 as K
from tests.harness import murmur3_oracle as oracle

N = 300


def _column(name: str, rng, n: int = N) -> pa.Array:
    nulls = rng.random(n) < 0.1
    if name == "i8":
        return pa.array(rng.integers(-128, 128, n).astype(np.int8),
                        mask=nulls)
    if name == "i16":
        return pa.array(rng.integers(-32768, 32768, n).astype(np.int16),
                        mask=nulls)
    if name == "f32":
        v = rng.standard_normal(n).astype(np.float32) * 1e3
        v[:6] = [0.0, -0.0, np.inf, -np.inf, np.float32(1e-30), np.nan]
        return pa.array(v, mask=nulls)
    if name in ("d15", "d18"):
        digits = 15 if name == "d15" else 18
        u = rng.integers(-10 ** digits + 1, 10 ** digits, n, dtype=np.int64)
        u[:2] = [10 ** digits - 1, -(10 ** digits) + 1]
        scale = 2 if name == "d15" else 0
        return pa.array([None if m else D.Decimal(int(x)).scaleb(-scale)
                         for x, m in zip(u, nulls)],
                        pa.decimal128(digits, scale))
    if name == "ts":
        return pa.array(rng.integers(-2 ** 60, 2 ** 60, n),
                        pa.timestamp("us", tz="UTC"), mask=nulls)
    if name == "i32":
        return pa.array(rng.integers(-2 ** 31, 2 ** 31, n).astype(np.int32),
                        mask=nulls)
    if name == "i64":
        return pa.array(rng.integers(-2 ** 63, 2 ** 63 - 1, n,
                                     dtype=np.int64), mask=nulls)
    if name == "f64":
        v = rng.standard_normal(n) * 1e6
        v[:4] = [0.0, -0.0, np.nan, np.inf]
        return pa.array(v, mask=nulls)
    if name == "bool":
        return pa.array(rng.random(n) < 0.5, mask=nulls)
    if name == "date":
        return pa.array(rng.integers(-20000, 20000, n).astype(np.int32),
                        mask=nulls).view(pa.date32())
    if name == "str":
        return pa.array(["".join(chr(97 + c) for c in
                                 rng.integers(0, 26, rng.integers(0, 64)))
                         for _ in range(n)], mask=nulls)
    raise ValueError(name)


KINDS = ["i8", "i16", "f32", "d15", "d18", "ts", "i32", "i64", "f64",
         "bool", "date", "str"]
NEW_KINDS = ["i8", "i16", "f32", "d15", "d18", "ts"]


@pytest.fixture(scope="module")
def table():
    rng = np.random.default_rng(7)
    return pa.table({k: _column(k, rng) for k in KINDS})


def _both(table, names):
    t = table.select(names)
    tb, _ = from_arrow(t, device="cpu")
    jb, _ = jax_from_arrow(t)
    return tb, jb


@pytest.mark.parametrize("name", KINDS)
@pytest.mark.parametrize("n_parts", [8, 7])
def test_partition_ids_match_jax(table, name, n_parts):
    tb, jb = _both(table, [name])
    ours = TH.partition_ids(list(tb.columns), n_parts).numpy()[:N]
    theirs = np.asarray(JH.partition_ids(list(jb.columns), n_parts))[:N]
    assert np.array_equal(ours, theirs)


@pytest.mark.parametrize("name", KINDS)
def test_xxhash64_matches_jax(table, name):
    tb, jb = _both(table, [name])
    ours = TH.xxhash64_column(tb.columns[0], 42).numpy()[:N]
    theirs = np.asarray(JH.xxhash64_column(jb.columns[0], jnp.uint64(42)))
    assert np.array_equal(ours, theirs.view(np.int64)[:N])


_ORACLE_TYPE = {"i8": "int", "i16": "int", "i32": "int", "date": "int",
                "i64": "long", "ts": "long", "f32": "float",
                "f64": "double", "bool": "bool", "str": "string"}


@pytest.mark.parametrize("name", NEW_KINDS + ["i32", "i64", "str"])
def test_murmur3_matches_the_scalar_oracle(table, name):
    tb, _ = _both(table, [name])
    ours = TH.murmur3_batch(list(tb.columns)).numpy()[:N]
    arr = table.column(name).combine_chunks()
    if name in ("d15", "d18"):
        want = [42 if v is None else oracle.hash_decimal(
            int(v.scaleb(arr.type.scale)), arr.type.precision, 42)
            for v in arr.to_pylist()]
    else:
        if name == "ts":
            values = arr.cast(pa.int64()).to_pylist()
        elif name == "date":
            values = arr.cast(pa.int32()).to_pylist()
        else:
            values = arr.to_pylist()
        if name == "f32":       # the oracle takes the float's own bits
            values = [None if v is None else
                      struct.unpack("<f", struct.pack("<f", v))[0]
                      for v in values]
        want = [oracle.spark_hash_row([v], [_ORACLE_TYPE[name]])
                for v in values]
    assert ours.tolist() == want


def test_multi_column_fold_and_xxhash64_expression_match_jax(table):
    from spark_rapids_tpu.expressions.hashing import XxHash64 as JX
    names = ["i8", "f32", "d15", "ts", "str", "i16"]
    t = table.select(names)
    plan = ProjectExec([TH.XxHash64(tuple(col(n) for n in names))],
                       InMemoryScanExec(t, device="cpu"))
    out = collect(plan)
    tb, jb = _both(table, names)
    jx = JX(tuple(jcol(n) for n in t.column_names)).bind(
        jax_from_arrow(t)[1]).eval(jb)
    assert out.column(0).to_pylist() == \
        np.asarray(jx.data).view(np.int64)[:N].tolist()
    assert out.schema.types == [pa.int64()]
    ours = TH.murmur3_batch(list(tb.columns)).numpy()[:N]
    theirs = np.asarray(JH.murmur3_batch(list(jb.columns)))[:N]
    assert np.array_equal(ours, theirs.view(np.int32))


@pytest.mark.parametrize("length", list(range(0, 65, 3)) + [31, 32, 33, 64])
def test_xxhash64_string_lengths_match_jax(length):
    rng = np.random.default_rng(length)
    s = ["".join(chr(32 + c) for c in rng.integers(0, 90, length))
         for _ in range(5)]
    tb, jb = _both(pa.table({"s": s}), ["s"])
    ours = TH.xxhash64_column(tb.columns[0], 42).numpy()[:5]
    theirs = np.asarray(JH.xxhash64_column(jb.columns[0],
                                           jnp.uint64(42))).view(np.int64)
    assert np.array_equal(ours, theirs[:5])


def test_null_column_passes_the_seed():
    seeds = torch.arange(-3, 125, dtype=torch.int32)
    col_t = DeviceColumn(torch.zeros(128, dtype=torch.int8),
                         torch.zeros(128, dtype=torch.bool), T.NULL)
    col_j = JColumn(jnp.zeros(128, jnp.int8), jnp.zeros(128, bool), None,
                    JT.NULL)
    ours = TH.hash_column(col_t, seeds)
    assert torch.equal(ours, seeds)
    theirs = np.asarray(JH.hash_column(col_j, jnp.asarray(seeds.numpy())))
    assert np.array_equal(theirs.view(np.int32), seeds.numpy())
    xs = TH.xxhash64_column(col_t, 42)
    assert torch.equal(xs, torch.full((128,), 42, dtype=torch.int64))


def test_float32_nan_hash_follows_spark():
    """Spark's floatToIntBits folds every NaN to 0x7FC00000; the JAX
    package hashes the raw bits (``bitcast_convert_type``), so a NaN with
    another payload or sign hashes differently there (ROADMAP Queue 3)."""
    bits = np.array([0x7FC00000, 0x7FC00001, -0x400000, 0x7F800001],
                    dtype=np.int64).astype(np.uint32).view(np.int32)
    f = bits.view(np.float32)
    t = pa.table({"f": pa.array(f, pa.float32())})
    tb, jb = _both(t, ["f"])
    ours = TH.murmur3_batch(list(tb.columns)).numpy()[:4]
    canonical = oracle.hash_int(0x7FC00000, 42)
    assert ours.tolist() == [canonical] * 4
    x = TH.xxhash64_column(tb.columns[0], 42).numpy()[:4]
    assert len(set(x.tolist())) == 1
    theirs = np.asarray(JH.murmur3_batch(list(jb.columns)))[:4]
    assert theirs[0] == canonical
    assert all(h != canonical for h in theirs[1:])


@pytest.mark.parametrize("name", ["i8", "i16"])
def test_narrow_keys_reach_the_murmur3_wrapper(table, name, monkeypatch):
    """int8 and int16 keys hash through ``murmur3_int32`` (the kernel on a
    CUDA tensor), widened to a contiguous int32 tensor."""
    seen = []
    real = K.murmur3_int32

    def spy(data, validity, seeds):
        seen.append((data.dtype, data.is_contiguous()))
        return real(data, validity, seeds)

    monkeypatch.setattr(TH, "murmur3_int32", spy)
    tb, _ = _both(table, [name])
    TH.partition_ids(list(tb.columns), 8)
    assert seen == [(torch.int32, True)]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the murmur3 kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["i8", "i16", "f32"])
def test_narrow_keys_launch_the_kernel_on_the_card(table, name, cuda_device):
    tb, _ = from_arrow(table.select([name]), device=cuda_device)
    cpu, _ = from_arrow(table.select([name]), device="cpu")
    K.murmur3_int32.launches = 0
    got = TH.partition_ids(list(tb.columns), 8).cpu()
    assert K.murmur3_int32.launches == 1
    assert torch.equal(got, TH.partition_ids(list(cpu.columns), 8))
