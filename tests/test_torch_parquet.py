"""The port's Parquet scan (spark_rapids_tpu_torch/io: ``ParquetSource`` and
``FileSourceScanExec``) against the JAX package's on the same files written
from seeded numpy data: each reader type, projection, pushdown, a predicate
outside the projection, row-group pruning (equal ``row_groups_pruned``),
hive partitions, the input-file-name column, path rewrites, a conf dict
applied to both, the legacy datetime rebase modes
(tests/test_parquet_legacy.py's cases), and the upload under injected OOMs
at ``scan.h2d``, bit for bit its clean run. Device batches are compared
through ``to_arrow``, batch for batch; sliced, chunked Arrow input through
``from_arrow`` too."""

import datetime as dt

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from spark_rapids_tpu import batch as jbatch
from spark_rapids_tpu.config import RapidsTpuConf as JConf
from spark_rapids_tpu.expressions import col as jcol
from spark_rapids_tpu.expressions.comparison import EqualTo as JEqualTo
from spark_rapids_tpu.expressions import lit as jlit
from spark_rapids_tpu.io import parquet as jparquet
from spark_rapids_tpu.io import source as jsource
from spark_rapids_tpu.io.scan import FileSourceScanExec as JScan
from spark_rapids_tpu_torch.batch import from_arrow, to_arrow
from spark_rapids_tpu_torch.expressions import EqualTo, col, lit
from spark_rapids_tpu_torch.io import parquet, source
from spark_rapids_tpu_torch.io.scan import FileSourceScanExec
from spark_rapids_tpu_torch.memory import retry

READERS = ["PERFILE", "COALESCING", "MULTITHREADED"]


def gen_table(n: int, seed: int) -> pa.Table:
    rng = np.random.default_rng(seed)
    words = np.array(["", "a", "bb", "hello world", "уникод", "x" * 30])
    return pa.table({
        "k": pa.array(rng.integers(0, 21, n).astype(np.int32)),
        "v": pa.array(rng.integers(-10**12, 10**12, n),
                      mask=rng.random(n) < 0.1),
        "s": pa.array(words[rng.integers(0, len(words), n)],
                      mask=rng.random(n) < 0.1),
        "d": pa.array(rng.normal(size=n) * 1e3),
        "day": pa.array(rng.integers(0, 20000, n).astype(np.int32),
                        pa.date32()),
    })


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("pq")
    paths = []
    for i in range(4):
        t = gen_table(500 + 37 * i, 80 + i)
        # sorted k per file, so the footer statistics prune row groups
        t = t.sort_by("k")
        p = str(d / f"part-{i}.parquet")
        pq.write_table(t, p, row_group_size=200)
        paths.append(p)
    return paths


def scans(paths, num_slices=2, reader="MULTITHREADED", pred=None,
          conf=None, **kw):
    """(port scan, JAX scan) over the same files, options and predicate
    (``pred(col, lit, EqualTo)`` builds it in either package)."""
    port_src = parquet.ParquetSource(
        paths, reader_type=source.ReaderType[reader],
        predicate=pred(col, lit, EqualTo) if pred else None, **kw)
    jax_src = jparquet.ParquetSource(
        paths, reader_type=jsource.ReaderType[reader],
        predicate=pred(jcol, jlit, JEqualTo) if pred else None, **kw)
    if conf is not None:
        port_src.apply_conf(conf)
        jax_src.apply_conf(JConf(conf))
    return (FileSourceScanExec(port_src, num_slices, device="cpu"),
            JScan(jax_src, num_slices))


def batches(scan, to_arrow_fn):
    return [[to_arrow_fn(b, scan.output_schema)
             for b in scan.execute_partition(p)]
            for p in range(scan.num_partitions)]


def assert_same_batches(port, jax):
    """Every partition's batches equal, batch for batch."""
    got, want = batches(port, to_arrow), batches(jax, jbatch.to_arrow)
    assert port.num_partitions == jax.num_partitions
    assert [len(p) for p in got] == [len(p) for p in want]
    for gp, wp in zip(got, want):
        for g, w in zip(gp, wp):
            assert g.equals(w), (g.to_pydict(), w.to_pydict())
    assert port.output_schema.names == jax.output_schema.names
    return pa.concat_tables([t for p in got for t in p])


@pytest.mark.parametrize("reader", READERS)
def test_each_reader_matches_jax(files, reader):
    port, jax = scans(files, reader=reader)
    out = assert_same_batches(port, jax)
    want = pa.concat_tables(pq.read_table(p) for p in files)
    assert out.num_rows == want.num_rows
    assert sorted(out.column("v").to_pylist(), key=str) == \
        sorted(want.column("v").to_pylist(), key=str)


@pytest.mark.parametrize("reader", READERS)
def test_projection_and_pushdown_prune_as_jax(files, reader):
    """A projection and a predicate over its own column: the same rows and
    the same row groups pruned by the footer statistics."""
    port, jax = scans(files, reader=reader, columns=["k", "s"],
                      pred=lambda c, l, eq: c("k") >= l(15))
    out = assert_same_batches(port, jax)
    assert out.column_names == ["k", "s"]
    assert min(out.column("k").to_pylist()) >= 15
    assert port.source.row_groups_pruned == jax.source.row_groups_pruned
    assert port.source.row_groups_pruned > 0
    assert port.source.row_groups_fallback == 0


@pytest.mark.parametrize("reader", READERS)
def test_predicate_outside_the_projection(files, reader):
    """Pushdown filters before the projection: a predicate on a column the
    projection leaves out works in every reader, and does not leak into
    the output."""
    port, jax = scans(files, reader=reader, columns=["d", "day"],
                      pred=lambda c, l, eq: (c("k") < l(4)) | (c("k") > l(18)))
    out = assert_same_batches(port, jax)
    assert out.column_names == ["d", "day"]
    assert 0 < out.num_rows < 2000
    assert port.source.row_groups_pruned == jax.source.row_groups_pruned


def test_flipped_literal_and_equality_prune_as_jax(tmp_path):
    t = pa.table({"k": np.arange(4000, dtype=np.int64),
                  "v": np.arange(4000, dtype=np.float64)})
    p = str(tmp_path / "rg.parquet")
    pq.write_table(t, p, row_group_size=1000)
    for pred, pruned in ((lambda c, l, eq: l(500) > c("k"), 3),
                         (lambda c, l, eq: eq(c("k"), l(2500)), 3),
                         (lambda c, l, eq: c("k") >= l(2500), 2)):
        port, jax = scans([p], num_slices=1, pred=pred)
        assert_same_batches(port, jax)
        assert port.source.row_groups_pruned == \
            jax.source.row_groups_pruned == pruned


def test_conf_dict_drives_both_packages(files):
    """One conf dict: batch rows, prefetch off, native decode off."""
    conf = {"spark.rapids.tpu.sql.reader.batchSizeRows": 150,
            "spark.rapids.tpu.prefetch.depth": 0,
            "spark.rapids.tpu.sql.format.parquet.nativeDecode.enabled":
                False}
    for reader in READERS:
        port, jax = scans(files, reader=reader, conf=conf)
        assert port.source.batch_rows == 150
        assert port.source.prefetch_depth() == 0
        assert_same_batches(port, jax)
        assert port.source.row_groups_fallback > 0


def test_hive_partitions_match_jax(tmp_path):
    root = tmp_path / "hive"
    for k, region in ((1, "eu"), (2, "us"), (3000000000, "eu")):
        d = root / f"big={k}" / f"region={region}"
        d.mkdir(parents=True)
        pq.write_table(gen_table(120, k % 97), str(d / "part-0.parquet"))
    port, jax = scans([str(root)], num_slices=2, reader="PERFILE",
                      columns=["v", "region", "big"])
    assert port.source.partition_schema == jax.source.partition_schema == [
        ("big", "int64"), ("region", "string")]
    out = assert_same_batches(port, jax)
    assert out.column_names == ["v", "region", "big"]
    assert set(out.column("big").to_pylist()) == {1, 2, 3000000000}
    # partition pruning on the plan's copy of the file list
    assert port.prune_partitions("region", {"us"}) == \
        jax.prune_partitions("region", {"us"}) == 2
    assert_same_batches(port, jax)


def test_input_file_name_column(tmp_path):
    p1, p2 = str(tmp_path / "a.parquet"), str(tmp_path / "b.parquet")
    pq.write_table(pa.table({"x": pa.array([1, 2], pa.int64())}), p1)
    pq.write_table(pa.table({"x": pa.array([3], pa.int64())}), p2)
    port, jax = scans([p1, p2], num_slices=1, with_file_name=True)
    out = assert_same_batches(port, jax)
    got = sorted(zip(out.column("x").to_pylist(),
                     out.column(source.FileSource.FILE_NAME_COL)
                     .to_pylist()))
    assert got == [(1, p1), (2, p1), (3, p2)]
    assert not port.output_schema[1].nullable


def test_path_rewrite_hook(tmp_path, files):
    source.register_path_rewrite("remote://bucket/", str(tmp_path) + "/")
    jsource.register_path_rewrite("remote://bucket/", str(tmp_path) + "/")
    try:
        real = str(tmp_path / "cached.parquet")
        pq.write_table(gen_table(50, 95), real)
        port, jax = scans(["remote://bucket/cached.parquet"], num_slices=1)
        assert port.source.files == [real]
        out = assert_same_batches(port, jax)
        assert out.num_rows == 50
    finally:
        source.clear_path_rewrites()
        jsource.clear_path_rewrites()


def test_upload_under_injected_ooms_is_bit_for_bit_the_clean_run(files):
    """Two consecutive OOMs at every ``scan.h2d`` check: each table's upload
    retries, then halves; the halves concatenate to the clean run's
    batches bit for bit."""
    clean, _ = scans(files, num_slices=2, reader="COALESCING")
    want = [pa.concat_tables(p) for p in batches(clean, to_arrow)]
    before = retry.metrics().snapshot()
    port, _ = scans(files, num_slices=2, reader="COALESCING")
    with retry.retry_policy(split_floor_rows=16), \
            retry.oom_injection("every-1", oom_count=2):
        got = batches(port, to_arrow)
    after = retry.metrics().snapshot()
    assert [len(p) for p in got] > [1, 1]
    for g, w in zip(got, want):
        assert pa.concat_tables(g).equals(w)
    assert after["splitAndRetryCount"] > before["splitAndRetryCount"]


def test_from_arrow_takes_sliced_chunked_tables():
    """The readers hand the upload a slice of a concatenation: several
    chunks, nonzero offsets in validity bitmaps and string offsets."""
    parts = [gen_table(300 + 11 * i, 7 + i) for i in range(3)]
    whole = pa.concat_tables(parts)
    for off, n in ((0, 250), (290, 400), (613, 333), (17, 1)):
        t = whole.slice(off, n)
        assert t.column("s").num_chunks >= 1
        batch, schema = from_arrow(t, device="cpu")
        got = to_arrow(batch, schema)
        jb, js = jbatch.from_arrow(t)
        assert got.equals(jbatch.to_arrow(jb, js))
        assert got.equals(t.combine_chunks().cast(got.schema))


# ---------------------------------------------------------------------------
# legacy datetime rebase (tests/test_parquet_legacy.py's cases)
# ---------------------------------------------------------------------------

def _legacy_file(tmp_path, table, name="legacy.parquet"):
    p = str(tmp_path / name)
    meta = dict(table.schema.metadata or {})
    meta[parquet.LEGACY_DATETIME_KEY] = b""
    pq.write_table(table.replace_schema_metadata(meta), p)
    return p


def test_rebase_known_anchors_match_jax():
    days = np.asarray([parquet.GREGORIAN_CUTOVER_DAYS - 1, -200000, -150000,
                       0, 10000, parquet.GREGORIAN_CUTOVER_DAYS])
    got = parquet.rebase_julian_to_gregorian_days(days)
    assert (got == jparquet.rebase_julian_to_gregorian_days(days)).all()
    assert got[0] == (dt.date(1582, 10, 4) - dt.date(1970, 1, 1)).days
    assert (got[3:] == days[3:]).all()


def test_legacy_file_exception_mode(tmp_path):
    ancient = parquet.GREGORIAN_CUTOVER_DAYS - 100
    t = pa.table({"d": pa.array([ancient, 0], pa.int32()).cast(pa.date32())})
    p = _legacy_file(tmp_path, t)
    with pytest.raises(parquet.DatetimeRebaseError, match="pre-1582"):
        parquet.ParquetSource([p]).read_file(p)
    port, _ = scans([p], num_slices=1)
    with pytest.raises(parquet.DatetimeRebaseError):
        batches(port, to_arrow)


@pytest.mark.parametrize("mode", ["CORRECTED", "LEGACY"])
@pytest.mark.parametrize("reader", READERS)
def test_legacy_modes_match_jax(tmp_path, mode, reader):
    ancient = parquet.GREGORIAN_CUTOVER_DAYS - 1
    us = ancient * 86_400_000_000 + 59_000_000
    t = pa.table({
        "d": pa.array([ancient, None, 7], pa.int32()).cast(pa.date32()),
        "ts": pa.array([us, None, 0], pa.int64()).cast(pa.timestamp("us")),
        "x": pa.array([1, 2, 3], pa.int64()),
    })
    p = _legacy_file(tmp_path, t)
    got = parquet.ParquetSource([p], rebase_mode=mode).read_file(p)
    want = jparquet.ParquetSource([p], rebase_mode=mode).read_file(p)
    assert got.equals(want)
    expect_day = (dt.date(1582, 10, 4) - dt.date(1970, 1, 1)).days
    first = expect_day if mode == "LEGACY" else ancient
    assert got.column("d").cast(pa.int32()).to_pylist() == [first, None, 7]
    port, jax = scans([p], num_slices=1, reader=reader, rebase_mode=mode)
    assert_same_batches(port, jax)
    if mode == "LEGACY":        # the legacy footer sends it to pyarrow
        assert port.source.row_groups_fallback == 1


def test_legacy_rebase_keeps_tz_and_other_types(tmp_path):
    ancient = parquet.GREGORIAN_CUTOVER_DAYS - 100
    t = pa.table({
        "d": pa.array([ancient], pa.int32()).cast(pa.date32()),
        "ts_utc": pa.array([0], pa.int64()).cast(pa.timestamp("us",
                                                              tz="UTC")),
        "x": pa.array([9], pa.int64()),
    })
    p = _legacy_file(tmp_path, t)
    got = parquet.ParquetSource([p], rebase_mode="LEGACY").read_file(p)
    assert got.schema.field("ts_utc").type == pa.timestamp("us", tz="UTC")
    assert got.schema.field("x").type == pa.int64()
    assert got.equals(
        jparquet.ParquetSource([p], rebase_mode="LEGACY").read_file(p))


def test_modern_file_untouched_and_int96_reads(tmp_path):
    ancient = parquet.GREGORIAN_CUTOVER_DAYS - 100
    p = str(tmp_path / "modern.parquet")
    pq.write_table(pa.table({"d": pa.array([ancient], pa.int32())
                             .cast(pa.date32())}), p)
    got = parquet.ParquetSource([p]).read_file(p)
    assert got.column("d").cast(pa.int32()).to_pylist() == [ancient]
    ts = [dt.datetime(2020, 1, 1, 12, 0, 0),
          dt.datetime(1969, 7, 20, 20, 17, 40)]
    p96 = str(tmp_path / "int96.parquet")
    pq.write_table(pa.table({"ts": pa.array(ts, pa.timestamp("us"))}), p96,
                   use_deprecated_int96_timestamps=True)
    port, jax = scans([p96], num_slices=1, reader="MULTITHREADED")
    out = assert_same_batches(port, jax)
    assert [v.replace(tzinfo=None) for v in out.column("ts").to_pylist()] \
        == ts
    assert port.source.row_groups_fallback == 1     # INT96: pyarrow


def test_stats_pruning_disabled_for_legacy_rebase_files(tmp_path):
    """Footer stats are hybrid-calendar in legacy files: a LEGACY scan must
    not prune against the rebased literal."""
    t = pa.table({"d": pa.array(np.full(10, -142427, np.int32),
                                pa.date32()),
                  "v": pa.array(np.arange(10), pa.int64())})
    p = _legacy_file(tmp_path, t)
    port, jax = scans(
        [p], num_slices=1, rebase_mode="LEGACY",
        pred=lambda c, l, eq: c("d") <= l(dt.date(1580, 1, 15)))
    out = assert_same_batches(port, jax)
    assert port.source.row_groups_pruned == jax.source.row_groups_pruned == 0
    assert out.num_rows == 10


@pytest.mark.parametrize("reader", READERS)
def test_is_not_null_pushdown_follows_spark(tmp_path, reader):
    """``IsNotNull`` subclasses ``IsNull`` in both packages, and the JAX
    package's pushdown tests ``IsNull`` first, so its scan of ``v IS NOT
    NULL`` returns the null rows (and the FilterExec above then drops
    them all). The port keeps the rows Spark keeps: the non-null ones."""
    from spark_rapids_tpu.expressions.comparison import IsNotNull as JNN
    from spark_rapids_tpu_torch.expressions import IsNotNull, IsNull
    p = str(tmp_path / "nn.parquet")
    pq.write_table(pa.table({"v": pa.array([1, None, 3, None, 5]),
                             "s": pa.array(["a", "b", None, "d", None])}),
                   p)
    src = parquet.ParquetSource([p], predicate=IsNotNull(col("v")),
                                reader_type=source.ReaderType[reader])
    got = pa.concat_tables(src.read_split(src.files))
    assert got.column("v").to_pylist() == [1, 3, 5]
    jsrc = jparquet.ParquetSource([p], predicate=JNN(jcol("v")),
                                  reader_type=jsource.ReaderType[reader])
    jgot = pa.concat_tables(jsrc.read_split(jsrc.files))
    assert jgot.column("v").to_pylist() == [None, None]
    src = parquet.ParquetSource([p], predicate=IsNull(col("s")),
                                reader_type=source.ReaderType[reader])
    got = pa.concat_tables(src.read_split(src.files))
    assert got.column("v").to_pylist() == [3, 5]


@pytest.mark.parametrize("reader", READERS)
def test_float_predicates_stay_above_the_scan(tmp_path, reader):
    """pyarrow and the footer statistics compare IEEE floats; Spark and
    the port's FilterExec order NaN above every value. A predicate on a
    double column is therefore not pushed down: the scan keeps every row
    and the filter keeps NaN > 5.0, as Spark does (the JAX package pushes
    it down and loses those rows)."""
    from spark_rapids_tpu_torch.exec import FilterExec, collect
    nan = float("nan")
    p = str(tmp_path / "nan.parquet")
    pq.write_table(pa.table({"d": pa.array([nan, 1.0, 7.0, nan, 2.0]),
                             "k": pa.array([1, 2, 3, 4, 5], pa.int32())}),
                   p, row_group_size=2)
    port, jax = scans([p], num_slices=1, reader=reader,
                      pred=lambda c, l, eq: c("d") > l(5.0))
    assert port.source._pushed is None
    got = collect(FilterExec(col("d") > lit(5.0), port))
    assert got.column("k").to_pylist() == [1, 3, 4]
    assert port.source.row_groups_pruned == 0
    jgot = pa.concat_tables(
        jbatch.to_arrow(b, jax.output_schema) for b in jax.execute())
    assert jgot.column("k").to_pylist() == [3]
