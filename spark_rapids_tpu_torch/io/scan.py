"""File scan exec.

Port of ``FileSourceScanExec`` from ``spark_rapids_tpu/io/scan.py``
(reference: GpuFileSourceScanExec.scala:67): files are split across
partitions, each partition's reader streams host tables through the
source's strategy, and each table lands on the device at the upload
boundary (``batch.from_arrow``) under the retry loop, which halves a table
whose upload runs out of device memory (``split_host_table``). Decode runs
on the reader pool and the prefetch thread; the upload and all device work
run on the consumer's thread, the one iterating the partition.

``read_parquet`` returns a DataFrame over a ``ParquetSource``, which the
planner turns into this exec. Not ported here: the cross-query scan share
(``share=``), which waits for the plan-sharing slice, and the CSV, JSON and
Avro readers, which wait for their sources (ROADMAP item 8).
"""

from __future__ import annotations

from typing import Iterator, List, Optional

import pyarrow as pa
import torch

from ..batch import ColumnarBatch, DeviceLike, Schema, from_arrow, \
    resolve_device
from ..exec.base import LeafExec, Metric
from ..memory.catalog import BufferCatalog
from ..memory.retry import maybe_inject, split_host_table, with_retry
from ..pipeline import close_iterator
from .source import FileSource


class FileSourceScanExec(LeafExec):
    """Leaf over a ``FileSource``: ``num_slices`` partitions, file ``i`` in
    partition ``i % num_slices``. ``catalog`` is the buffer catalog of the
    tree above it (default: the device's process-wide one)."""

    def __init__(self, source: FileSource, num_slices: int = 1,
                 device: DeviceLike = None,
                 catalog: Optional[BufferCatalog] = None):
        super().__init__()
        # prefetch pipeline visibility: overlapTime = decode work hidden
        # behind this exec's upload and compute
        self.metrics["overlapTime"] = Metric("overlapTime")
        self.metrics["prefetchWaitTime"] = Metric("prefetchWaitTime")
        self._catalog = catalog
        self._device = resolve_device(device)
        self.source = source
        #: per-PLAN file list: partition pruning changes THIS copy, never
        #: the source (a pruned source would corrupt later plans)
        self.files = list(source.files)
        self.files_pruned = 0
        self._num_slices = max(1, min(num_slices, len(source.files)))
        self._schema = source.schema()

    def prune_partitions(self, name: str, allowed) -> int:
        """Dynamic partition pruning: drop this plan's files whose hive
        partition value ``name`` is not in ``allowed`` (reference:
        GpuSubqueryBroadcastExec feeding the scan's partition filters).
        One file stays if none is allowed, so the scan keeps its schema.
        Returns the files pruned."""
        values = getattr(self.source, "_pvalues", {}).get(name)
        if not values:
            return 0
        before = len(self.files)
        keep = [f for f in self.files if values[f] in allowed]
        self.files = keep or self.files[:1]
        pruned = before - len(self.files)
        self.files_pruned += pruned
        self.source.files_pruned = getattr(
            self.source, "files_pruned", 0) + pruned
        self._num_slices = max(1, min(self._num_slices, len(self.files)))
        return pruned

    @property
    def name(self):
        return f"FileSourceScanExec[{self.source.format_name}]"

    @property
    def output_schema(self) -> Schema:
        return self._schema

    @property
    def num_partitions(self) -> int:
        return self._num_slices

    @property
    def device(self) -> torch.device:
        return self._device

    def _files_for(self, p: int) -> List[str]:
        """The files partition ``p`` reads."""
        return [f for i, f in enumerate(self.files)
                if i % self._num_slices == p]

    def _h2d(self, table: pa.Table) -> ColumnarBatch:
        maybe_inject("scan.h2d")
        # dictionary columns (the RLE_DICTIONARY hand-off) land as codes
        # under the Session's dictEncoding.* thresholds
        batch, _ = from_arrow(table, schema=self._schema,
                              device=self._device,
                              dict_conf=getattr(self.source, "_dict_conf",
                                                None))
        return batch

    def do_execute_partition(self, p: int) -> Iterator[ColumnarBatch]:
        it = self.source.read_split(self._files_for(p), metrics=self.metrics)
        try:
            for host_table in it:
                # an OOM uploading this table halves it (host-side slices)
                # and uploads the halves, in row order
                yield from with_retry(host_table, self._h2d,
                                      split=split_host_table,
                                      catalog=self.catalog, name=self.name)
        finally:
            # consumer abort (limit early-exit) must cancel the prefetch
            # producer promptly — no decode running past the query
            close_iterator(it)


def read_parquet(paths, columns=None, predicate=None, num_slices: int = 1,
                 **kw):
    """A DataFrame over Parquet files (``session.read.parquet``): the
    projection ``columns`` and the ``predicate`` pushed down to the
    ``ParquetSource`` (``kw``: its other arguments, ``reader_type`` among
    them), in ``num_slices`` partitions."""
    from ..plan.logical import DataFrame, LogicalScan
    from .parquet import ParquetSource
    src = ParquetSource(paths, columns=columns, predicate=predicate, **kw)
    return DataFrame(LogicalScan((), source=src, _schema=src.schema(),
                                 num_slices=num_slices))
