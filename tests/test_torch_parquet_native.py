"""The port's native Parquet decoder (csrc/rtpu_parquet.cpp through
spark_rapids_tpu_torch/io/parquet_native.py) against the JAX package's and
against pyarrow, on the axes of tests/test_parquet_native.py: physical
types, nulls, codecs (snappy, zstd, uncompressed), PLAIN and dictionary
pages, page v1 and v2, several row groups, small pages, the per-row-group
fallback for nested and GZIP columns, footer statistics, and decimal
statistics that never prune. Every row group read by the port equals the
JAX package's and pyarrow's table for table.

The decoder builds with the host compiler at first use; a failed build or
load raises."""

import decimal

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from spark_rapids_tpu.expressions import col as jcol
from spark_rapids_tpu.expressions import lit as jlit
from spark_rapids_tpu.io import parquet_native as jax_native
from spark_rapids_tpu.io.parquet import ParquetSource as JParquetSource
from spark_rapids_tpu.io.source import ReaderType as JReaderType
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.expressions import col, lit
from spark_rapids_tpu_torch.io import parquet_native as port_native
from spark_rapids_tpu_torch.io.parquet import ParquetSource
from spark_rapids_tpu_torch.io.source import ReaderType
from spark_rapids_tpu_torch.kernels import build


def sample_table(n=5000, seed=3, with_nulls=True):
    rng = np.random.default_rng(seed)

    def maybe_null(arr, t):
        if not with_nulls:
            return pa.array(arr, type=t)
        return pa.array(arr, type=t, mask=rng.random(len(arr)) < 0.15)
    strings = rng.choice(
        ["", "a", "bb", "hello world", "x" * 40, "уникод", "z"], n)
    return pa.table({
        "i32": maybe_null(rng.integers(-10**6, 10**6, n).astype(np.int32),
                          pa.int32()),
        "i64": maybe_null(rng.integers(-10**12, 10**12, n), pa.int64()),
        "f32": maybe_null(rng.normal(size=n).astype(np.float32),
                          pa.float32()),
        "f64": maybe_null(rng.normal(size=n) * 1e6, pa.float64()),
        "b": maybe_null(rng.integers(0, 2, n).astype(bool), pa.bool_()),
        "s": maybe_null(strings, pa.string()),
        "d": maybe_null(rng.integers(0, 20000, n).astype(np.int32),
                        pa.date32()),
        "ts": maybe_null(rng.integers(0, 10**15, n), pa.timestamp("us")),
    })


#: (name, table, pq.write_table options): tests/test_parquet_native.py's
#: round trips
CASES = [
    ("snappy_dict_default", lambda: sample_table(),
     dict(row_group_size=1500)),
    ("plain_encoding", lambda: sample_table(seed=5),
     dict(use_dictionary=False, row_group_size=2000)),
    ("uncompressed", lambda: sample_table(seed=7), dict(compression="none")),
    ("zstd", lambda: sample_table(seed=9), dict(compression="zstd")),
    ("data_page_v2", lambda: sample_table(seed=11),
     dict(data_page_version="2.0", row_group_size=1000)),
    ("data_page_v2_plain_uncompressed", lambda: sample_table(seed=13),
     dict(use_dictionary=False, data_page_version="2.0",
          compression="none")),
    ("no_nulls", lambda: sample_table(seed=15, with_nulls=False), {}),
    ("tiny_and_empty_strings",
     lambda: pa.table({"s": pa.array(["", "", None, "q", ""]),
                       "i": pa.array([1, 2, 3, 4, 5], type=pa.int32())}),
     {}),
    ("small_page_sizes", lambda: sample_table(seed=17),
     dict(data_page_size=2048, row_group_size=2500)),
]


@pytest.mark.parametrize("make,write_kw", [c[1:] for c in CASES],
                         ids=[c[0] for c in CASES])
def test_row_groups_match_jax_and_pyarrow(tmp_path, make, write_kw):
    t = make()
    p = str(tmp_path / "f.parquet")
    pq.write_table(t, p, **write_kw)
    pf = pq.ParquetFile(p)
    schema = pq.read_schema(p)
    cols = t.column_names
    port_native._lib()
    zstd_native = 6 in port_native._CODECS
    for rg in range(pf.metadata.num_row_groups):
        expected = pf.read_row_group(rg, columns=cols, use_threads=False)
        got = port_native.read_row_group_native(p, rg, cols, schema)
        if write_kw.get("compression") == "zstd" and not zstd_native:
            assert got is None       # built without libzstd: outside
            continue
        assert got is not None, "native decode unexpectedly fell back"
        assert got.equals(expected), f"row group {rg} differs from pyarrow"
        jax_got = jax_native.read_row_group_native(p, rg, cols, schema)
        assert got.equals(jax_got), f"row group {rg} differs from JAX"


def test_nested_falls_back_and_flat_sibling_decodes(tmp_path):
    t = pa.table({"a": pa.array([[1, 2], [3]], pa.list_(pa.int64())),
                  "i": pa.array([1, 2], type=pa.int64())})
    p = str(tmp_path / "nested.parquet")
    pq.write_table(t, p)
    schema = pq.read_schema(p)
    assert port_native.read_row_group_native(p, 0, ["a"], schema) is None
    got = port_native.read_row_group_native(p, 0, ["i"], schema)
    assert got is not None and got.column("i").to_pylist() == [1, 2]
    assert got.equals(jax_native.read_row_group_native(p, 0, ["i"], schema))


def test_gzip_falls_back(tmp_path):
    p = str(tmp_path / "gz.parquet")
    pq.write_table(sample_table(300), p, compression="gzip")
    assert port_native.read_row_group_native(
        p, 0, ["i64"], pq.read_schema(p)) is None


def test_footer_stats_match_jax(tmp_path):
    t = pa.table({"k": pa.array(np.arange(1000, dtype=np.int64)),
                  "f": pa.array(np.arange(1000, dtype=np.float64) / 3),
                  "s": pa.array([f"v{i:04d}" for i in range(1000)])})
    p = str(tmp_path / "stats.parquet")
    pq.write_table(t, p, row_group_size=250)
    f, jf = port_native.open_native(p), jax_native.open_native(p)
    assert f.num_row_groups == jf.num_row_groups == 4
    assert f.num_rows == jf.num_rows == 1000
    mn, mx, nulls = f.chunk_stats(1, "k")
    assert int.from_bytes(mn, "little", signed=True) == 250
    assert int.from_bytes(mx, "little", signed=True) == 499
    assert nulls == 0
    for rg in range(4):
        for name in ("k", "f", "s"):
            assert f.chunk_stats(rg, name) == jf.chunk_stats(rg, name)
            assert f.decoded_stats(rg, name) == jf.decoded_stats(rg, name)
    assert f.decoded_stats(0, "s") is None       # strings never prune


def test_decimal_stats_never_prune(tmp_path):
    """Decimal footer stats are UNSCALED ints; the native stats path must
    decline decimal columns, so nothing is pruned in either package."""
    t = pa.table({"x": pa.array([decimal.Decimal("1.00"),
                                 decimal.Decimal("5.00")],
                                pa.decimal128(9, 2))})
    p = str(tmp_path / "dec.parquet")
    pq.write_table(t, p)
    assert port_native.open_native(p).decoded_stats(0, "x") is None
    src = ParquetSource([p], predicate=col("x") < lit(
        decimal.Decimal("50"), T.decimal(9, 2)),
        reader_type=ReaderType.MULTITHREADED)
    out = pa.concat_tables(list(src.read_split(src.files)))
    jsrc = JParquetSource([p], predicate=jcol("x") < jlit(
        decimal.Decimal("50")), reader_type=JReaderType.MULTITHREADED)
    jout = pa.concat_tables(list(jsrc.read_split(jsrc.files)))
    assert out.num_rows == 2 and out.equals(jout)
    assert src.row_groups_pruned == jsrc.row_groups_pruned == 0


@pytest.mark.parametrize("reader", ["PERFILE", "MULTITHREADED"])
def test_native_vs_pyarrow_with_out_of_projection_predicate(tmp_path,
                                                            reader):
    """A predicate on a column OUTSIDE the projection: the native path
    reads it for the filter and drops it after, as the pyarrow dataset
    path does; native, pyarrow and the JAX package agree."""
    t = sample_table(4000, seed=31)
    p = str(tmp_path / "pf.parquet")
    pq.write_table(t, p, row_group_size=700)

    def read(native):
        src = ParquetSource([p], columns=["i64", "s"],
                            predicate=col("i32") > lit(0),
                            reader_type=ReaderType[reader])
        src._native = native
        out = pa.concat_tables(list(src.read_split(src.files)))
        return out, src.row_groups_fallback
    (a, fa), (b, fb) = read(True), read(False)
    jsrc = JParquetSource([p], columns=["i64", "s"],
                          predicate=jcol("i32") > jlit(0),
                          reader_type=JReaderType[reader])
    j = pa.concat_tables(list(jsrc.read_split(jsrc.files)))
    assert a.column_names == ["i64", "s"]
    assert a.num_rows > 0 and a.equals(b) and a.equals(j)
    assert fa == 0 and fb == 6       # every row group took pyarrow


def test_perfile_native_prunes_row_groups_as_jax(tmp_path):
    t = pa.table({"k": np.arange(4000, dtype=np.int64)})
    p = str(tmp_path / "sorted.parquet")
    pq.write_table(t, p, row_group_size=1000)
    src = ParquetSource([p], predicate=col("k") >= lit(3900),
                        reader_type=ReaderType.PERFILE)
    out = pa.concat_tables(list(src.read_split(src.files)))
    assert out.column("k").to_pylist() == list(range(3900, 4000))
    jsrc = JParquetSource([p], predicate=jcol("k") >= jlit(3900),
                          reader_type=JReaderType.PERFILE)
    list(jsrc.read_split(jsrc.files))
    assert src.row_groups_pruned == jsrc.row_groups_pruned == 3
    # a fully-pruned file yields an empty, correctly-typed table
    src2 = ParquetSource([p], predicate=col("k") >= lit(10**6),
                         reader_type=ReaderType.PERFILE)
    out2 = pa.concat_tables(list(src2.read_split(src2.files)))
    assert out2.num_rows == 0 and out2.column_names == ["k"]


def test_library_without_zstd_reads_zstd_row_groups_with_pyarrow(
        tmp_path, monkeypatch):
    """Built without libzstd, a ZSTD chunk is outside the native subset:
    the row group falls back to pyarrow and reads the same rows."""
    t = sample_table(2000, seed=41)
    p = str(tmp_path / "z.parquet")
    pq.write_table(t, p, compression="zstd", row_group_size=800)
    port_native._lib()
    monkeypatch.setattr(port_native, "_CODECS", frozenset({0, 1}))
    schema = pq.read_schema(p)
    assert port_native.read_row_group_native(p, 0, ["i64"], schema) is None
    src = ParquetSource([p], reader_type=ReaderType.MULTITHREADED)
    out = pa.concat_tables(list(src.read_split(src.files)))
    assert out.equals(pq.read_table(p))
    assert src.row_groups_fallback == 3


def test_failed_build_raises_and_falls_back_nowhere(tmp_path, monkeypatch):
    """A compile that fails raises from the first native read; nothing
    quietly takes pyarrow for every file."""
    p = str(tmp_path / "f.parquet")
    pq.write_table(sample_table(100), p)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(build, "_loaded", {})
    monkeypatch.setattr(build, "host_cxx", lambda: "false")
    monkeypatch.setattr(port_native, "_LIB", None)
    monkeypatch.setattr(port_native, "_CACHE", {})
    with pytest.raises(RuntimeError, match="kernel build failed"):
        port_native.read_row_group_native(p, 0, ["i64"],
                                          pq.read_schema(p))
    src = ParquetSource([p], reader_type=ReaderType.MULTITHREADED)
    with pytest.raises(RuntimeError, match="kernel build failed"):
        list(src.read_split(src.files))


def test_decoder_builds_from_the_package_source(tmp_path, monkeypatch):
    """``kernels/build.py`` compiles csrc/rtpu_parquet.cpp into the build
    directory, with ZSTD where the system has libzstd's header."""
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    built = build.build(["rtpu_parquet"])
    assert set(built) == {"rtpu_parquet"}
    path = build.library_path("rtpu_parquet")
    assert path.is_file() and path.parent == tmp_path / "build"
    import ctypes
    lib = ctypes.CDLL(str(path))
    assert lib.rtpu_pq_has_zstd() == int(build._ZSTD_HEADER.is_file())
