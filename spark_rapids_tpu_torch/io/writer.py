"""Per-task columnar writers with job stats.

Port of ``spark_rapids_tpu/io/writer.py`` (reference:
GpuFileFormatDataWriter.scala, SingleDirectoryDataWriter /
DynamicPartitionDataWriter / bucketing, and GpuWriteJobStatsTracker):

- each plan partition is a write TASK producing its own part files,
- batches stream through an open writer (no whole-result collect),
- hive partitioning splits each batch by partition values,
- bucketed writes route rows with the hash exchange's murmur3-pmod
  (``HashPartitioning.partition_ids``, so an int32 bucket key goes through
  the ``murmur3_int32`` kernel on the card) and bucket files line up with
  hash-exchange partitions,
- a task that raises closes and deletes its partial files,
- ``WriteStats`` aggregates rows, bytes, files and partitions per job.

Parquet, ORC and CSV are written by pyarrow from the host table that
``to_arrow`` brings back.
"""

from __future__ import annotations

import os
import uuid
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq

from ..batch import ColumnarBatch, Schema, to_arrow
from ..expressions.base import col
from ..shuffle.partitioning import HashPartitioning


@dataclass
class WriteStats:
    """GpuWriteJobStatsTracker analogue."""

    num_files: int = 0
    num_rows: int = 0
    num_bytes: int = 0
    num_tasks: int = 0
    files: List[str] = field(default_factory=list)
    partition_keys: set = field(default_factory=set)

    @property
    def num_partitions(self) -> int:
        """Distinct hive partition dirs across the whole job."""
        return len(self.partition_keys)

    def describe(self) -> str:
        return (f"{self.num_rows} rows in {self.num_files} files "
                f"({self.num_bytes} bytes) across {self.num_tasks} tasks"
                + (f", {self.num_partitions} partitions"
                   if self.num_partitions else ""))


class _FormatWriter:
    """One open output file."""

    def __init__(self, path: str, schema: pa.Schema, fmt: str,
                 compression: str, header: bool = True):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self.path = path
        self.fmt = fmt
        if fmt == "parquet":
            self._w = pq.ParquetWriter(path, schema,
                                       compression=compression)
        elif fmt == "orc":
            import pyarrow.orc as paorc
            self._w = paorc.ORCWriter(path)
        elif fmt == "csv":
            import pyarrow.csv as pacsv
            self._w = pacsv.CSVWriter(
                path, schema,
                write_options=pacsv.WriteOptions(include_header=header))
        else:
            raise ValueError(f"unknown write format {fmt!r}")

    def write(self, table: pa.Table) -> None:
        if self.fmt == "orc":
            self._w.write(table)
        else:
            self._w.write_table(table)

    def close(self) -> int:
        self._w.close()
        return os.path.getsize(self.path)


class ColumnarWriteTask:
    """Writes one plan partition's stream of batches (the reference's
    per-task GpuFileFormatDataWriter)."""

    def __init__(self, task_id: int, base: str, fmt: str,
                 compression: str, schema: Schema,
                 partition_by: Sequence[str] = (),
                 bucket_spec: Optional[Tuple[List[str], int]] = None,
                 header: bool = True):
        self.task_id = task_id
        self.base = base
        self.fmt = fmt
        self.compression = compression
        self.header = header
        self.schema = schema
        self.partition_by = list(partition_by)
        self.bucket_spec = bucket_spec
        self.out_names = [f.name for f in schema
                          if f.name not in self.partition_by]
        self._writers: Dict[Tuple, _FormatWriter] = {}
        self._uuid = uuid.uuid4().hex[:8]
        self.rows = 0
        self._bucketing = None
        if bucket_spec is not None:
            cols, n = bucket_spec
            self._bucketing = HashPartitioning([col(c) for c in cols],
                                               n).bind(schema)

    def _target(self, part_key: Tuple, bucket: Optional[int]) -> str:
        name = f"part-{self.task_id:05d}-{self._uuid}"
        if bucket is not None:
            name += f"_{bucket:05d}"    # Spark bucket file suffix
        name += f".{self.fmt}"
        sub = "/".join(f"{c}={v}" for c, v in
                       zip(self.partition_by, part_key))
        return os.path.join(self.base, sub, name) if sub else \
            os.path.join(self.base, name)

    def _writer(self, part_key: Tuple, bucket: Optional[int],
                arrow_schema: pa.Schema) -> _FormatWriter:
        key = (part_key, bucket)
        w = self._writers.get(key)
        if w is None:
            w = _FormatWriter(self._target(part_key, bucket), arrow_schema,
                              self.fmt, self.compression, self.header)
            self._writers[key] = w
        return w

    def write_batch(self, batch: ColumnarBatch) -> None:
        table = to_arrow(batch, self.schema)
        if table.num_rows == 0:
            return
        self.rows += table.num_rows
        buckets = None
        if self._bucketing is not None:
            buckets = self._bucketing.partition_ids(batch)[
                :table.num_rows].cpu().numpy().astype(np.int64)
        out_table = table.select(self.out_names)
        if not self.partition_by and buckets is None:
            self._writer((), None, out_table.schema).write(out_table)
            return
        # split by (partition values, bucket id) with vectorized key
        # codes — a per-row Python loop would serialize the write path
        codes = np.zeros(table.num_rows, np.int64)
        for c in self.partition_by:
            enc = table.column(c).combine_chunks().dictionary_encode(
                null_encoding="encode")
            codes = (codes * (len(enc.dictionary) + 1)
                     + enc.indices.to_numpy(zero_copy_only=False))
        if buckets is not None:
            codes = codes * (int(buckets.max(initial=0)) + 2) + buckets
        order = np.argsort(codes, kind="stable")
        sorted_codes = codes[order]
        starts = np.flatnonzero(
            np.r_[True, sorted_codes[1:] != sorted_codes[:-1]])
        bounds = np.r_[starts, len(sorted_codes)]
        pcols = [table.column(c) for c in self.partition_by]
        for a, b in zip(bounds[:-1], bounds[1:]):
            idxs = order[a:b]
            i0 = int(idxs[0])
            pk = tuple(pc[i0].as_py() for pc in pcols)
            bk = int(buckets[i0]) if buckets is not None else None
            piece = out_table.take(pa.array(idxs, pa.int64()))
            self._writer(pk, bk, piece.schema).write(piece)

    def abort(self) -> None:
        """Close and delete this task's partial outputs after a failure
        (footer-less files would poison readers of the directory)."""
        for w in self._writers.values():
            try:
                w.close()
            except Exception:
                pass
            try:
                os.remove(w.path)
            except OSError:
                pass
        self._writers.clear()

    def close(self, stats: WriteStats) -> None:
        for (pk, _), w in self._writers.items():
            size = w.close()
            stats.num_files += 1
            stats.num_bytes += size
            stats.files.append(w.path)
            if pk:
                stats.partition_keys.add(pk)
        stats.num_rows += self.rows
        stats.num_tasks += 1


def write_plan(plan, path: str, fmt: str = "parquet",
               compression: str = "snappy",
               partition_by: Sequence[str] = (),
               bucket_by: Optional[Tuple[List[str], int]] = None,
               header: bool = True) -> WriteStats:
    """Execute a physical plan and write it task by task (the reference's
    GpuInsertIntoHadoopFsRelationCommand shape — no driver-side collect).
    Closes the plan."""
    stats = WriteStats()
    schema = plan.output_schema
    os.makedirs(path, exist_ok=True)
    task = None
    try:
        for p in range(plan.num_partitions):
            task = ColumnarWriteTask(p, path, fmt, compression, schema,
                                     partition_by, bucket_by, header)
            for batch in plan.execute_partition(p):
                task.write_batch(batch)
            task.close(stats)
            task = None
    finally:
        if task is not None:        # a batch raised mid-task: close the
            task.abort()            # open writers, drop partial files
        plan.close()
    return stats
