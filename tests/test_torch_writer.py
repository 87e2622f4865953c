"""The port's columnar writer (spark_rapids_tpu_torch/io/writer.py) against
the JAX package's ``write_plan`` over the same input: plain, hive-partitioned
and bucketed writes put the same rows in the same relative directories and
bucket files (names compared without their per-task uuid), with equal
``WriteStats``; a task that raises leaves no file; and the Parquet-blob
cache (io/cache.py) round-trips as the JAX one does. Also the
``entry.write_lineitem_bucketed`` entry point, whose bucket ids are the
hash exchange's murmur3-pmod on its int32 key."""

import os
import re

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

from spark_rapids_tpu import batch as jbatch
from spark_rapids_tpu.exec.basic import InMemoryScanExec as JScan
from spark_rapids_tpu.io import cache as jcache
from spark_rapids_tpu.io import writer as jwriter
from spark_rapids_tpu_torch import entry
from spark_rapids_tpu_torch.batch import to_arrow
from spark_rapids_tpu_torch.exec import InMemoryScanExec, ProjectExec
from spark_rapids_tpu_torch.expressions import Alias, col
from spark_rapids_tpu_torch.expressions.base import Expression
from spark_rapids_tpu_torch.io import cache, writer
from spark_rapids_tpu_torch.kernels.murmur3 import murmur3_int32_plain

N, SLICES, BATCH_ROWS = 3000, 3, 700


def src_table(n=N, seed=4):
    rng = np.random.default_rng(seed)
    return pa.table({
        "k": pa.array(rng.integers(0, 4, n).astype(np.int32)),
        "r": pa.array(rng.choice(["eu", "us", "apac"], n)),
        "v": pa.array(rng.integers(-100, 100, n).astype(np.int64),
                      mask=rng.random(n) < 0.1),
        "d": pa.array(rng.normal(size=n)),
    })


def port_scan(t):
    return InMemoryScanExec(t, batch_rows=BATCH_ROWS, num_slices=SLICES,
                            device="cpu")


def jax_scan(t):
    return JScan(t, batch_rows=BATCH_ROWS, num_slices=SLICES)


def layout(base):
    """{relative path with the task uuid removed: table} of a write."""
    out = {}
    for dp, _, fs in os.walk(base):
        for f in fs:
            rel = os.path.relpath(os.path.join(dp, f), base)
            key = re.sub(r"part-(\d+)-[0-9a-f]{8}", r"part-\1", rel)
            out[key] = pq.read_table(os.path.join(dp, f))
    return out


@pytest.mark.parametrize("kind", ["plain", "hive", "bucketed",
                                  "hive_bucketed"])
def test_write_plan_matches_jax(tmp_path, kind):
    t = src_table()
    kw = {"plain": {}, "hive": {"partition_by": ["r"]},
          "bucketed": {"bucket_by": (["k"], 4)},
          "hive_bucketed": {"partition_by": ["r"],
                            "bucket_by": (["k", "v"], 3)}}[kind]
    got = writer.write_plan(port_scan(t), str(tmp_path / "port"), **kw)
    want = jwriter.write_plan(jax_scan(t), str(tmp_path / "jax"), **kw)
    assert (got.num_rows, got.num_files, got.num_tasks, got.num_bytes,
            got.partition_keys) == (want.num_rows, want.num_files,
                                    want.num_tasks, want.num_bytes,
                                    want.partition_keys)
    assert got.num_rows == N and got.num_tasks == SLICES
    a, b = layout(tmp_path / "port"), layout(tmp_path / "jax")
    assert sorted(a) == sorted(b) and len(a) == got.num_files
    for name in a:
        assert a[name].equals(b[name]), name
    if "partition_by" in kw:
        assert all("r=" in name for name in a)
        assert all("r" not in t.column_names for t in a.values())


def test_bucket_files_hold_their_murmur3_bucket(tmp_path):
    """Every row of bucket file b hashes to b: pmod(murmur3(k, 42), n)."""
    t = src_table(2000)
    stats = writer.write_plan(port_scan(t), str(tmp_path / "b"),
                              bucket_by=(["k"], 4))
    for f in stats.files:
        bucket = int(f.rsplit("_", 1)[1].split(".")[0])
        k = torch.from_numpy(pq.read_table(f).column("k").to_numpy())
        h = murmur3_int32_plain(k, torch.ones_like(k, dtype=torch.bool),
                                torch.full_like(k, 42))
        assert set(torch.remainder(h, 4).tolist()) == {bucket}


def test_csv_and_orc_formats_match_jax(tmp_path):
    t = src_table(300).select(["k", "r", "d"])
    for fmt in ("csv", "orc"):
        got = writer.write_plan(port_scan(t), str(tmp_path / f"p{fmt}"),
                                fmt=fmt)
        want = jwriter.write_plan(jax_scan(t), str(tmp_path / f"j{fmt}"),
                                  fmt=fmt)
        assert (got.num_files, got.num_rows, got.num_bytes) == \
            (want.num_files, want.num_rows, want.num_bytes)
        assert all(f.endswith(f".{fmt}") for f in got.files)


class _Boom(Expression):
    """An expression that fails on its second batch."""

    def __init__(self):
        self.calls = 0

    @property
    def children(self):
        return ()

    @property
    def dtype(self):
        from spark_rapids_tpu_torch import types as T
        return T.INT32

    def bind(self, schema):
        return self

    def eval(self, batch, ctx=None):
        self.calls += 1
        if self.calls == 2:
            raise RuntimeError("task failed")
        return batch.columns[0]


def test_a_raising_task_leaves_no_files(tmp_path):
    t = src_table()
    plan = ProjectExec([Alias(_Boom(), "k"), col("v")], port_scan(t))
    out = tmp_path / "w"
    with pytest.raises(RuntimeError, match="task failed"):
        writer.write_plan(plan, str(out), bucket_by=(["k"], 4))
    assert not [f for _, _, fs in os.walk(out) for f in fs]


def test_cached_relation_round_trip_matches_jax():
    t = src_table()
    rel = cache.CachedRelation.build(port_scan(t))
    jrel = jcache.CachedRelation.build(jax_scan(t))
    assert rel.num_partitions == jrel.num_partitions == SLICES
    assert rel.read_all().equals(jrel.read_all())
    assert rel.read_all().num_rows == N
    scan = cache.InMemoryRelationExec(rel, device="cpu")
    jscan = jcache.InMemoryRelationExec(jrel)
    for p in range(SLICES):
        got = [to_arrow(b, scan.output_schema)
               for b in scan.execute_partition(p)]
        want = [jbatch.to_arrow(b, jscan.output_schema)
                for b in jscan.execute_partition(p)]
        assert len(got) == len(want) == 1
        assert got[0].equals(want[0])


def test_write_lineitem_bucketed(tmp_path):
    t = entry.lineitem_table(6000)
    stats = entry.write_lineitem_bucketed(t, str(tmp_path / "li"), 8, 3,
                                          device="cpu")
    assert (stats.num_rows, stats.num_tasks, stats.num_files) == \
        (6000, 3, 24)
    back = pa.concat_tables(pq.read_table(f) for f in stats.files)
    keys = [(c, "ascending") for c in t.column_names]
    assert back.sort_by(keys).equals(t.sort_by(keys))
    want = jwriter.write_plan(
        JScan(t, batch_rows=2000, num_slices=3), str(tmp_path / "jax"),
        bucket_by=([entry.BUCKET_KEY], 8))
    a, b = layout(tmp_path / "li"), layout(tmp_path / "jax")
    assert sorted(a) == sorted(b)
    assert all(a[k].equals(b[k]) for k in a)
