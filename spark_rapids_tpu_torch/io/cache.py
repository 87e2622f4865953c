"""DataFrame cache serializer.

Port of ``spark_rapids_tpu/io/cache.py`` (reference:
ParquetCachedBatchSerializer.scala:260): a cached plan's partitions live on
the host as in-memory Parquet blobs (snappy) and are uploaded again as
device batches on demand.
"""

from __future__ import annotations

import io
from typing import List, Optional

import pyarrow as pa
import pyarrow.parquet as pq
import torch

from .. import types as T
from ..batch import DeviceLike, Schema, from_arrow, resolve_device, to_arrow
from ..exec.base import Exec, LeafExec


class CachedRelation:
    """Materialized, parquet-compressed cache of a plan's output."""

    def __init__(self, schema: Schema, partitions: List[bytes]):
        self.schema = schema
        self._partitions = partitions

    @classmethod
    def build(cls, plan: Exec) -> "CachedRelation":
        """Run ``plan`` and keep each partition as one Parquet blob. Closes
        the plan."""
        schema = plan.output_schema
        parts: List[bytes] = []
        try:
            for p in range(plan.num_partitions):
                tables = [to_arrow(b, schema)
                          for b in plan.execute_partition(p)]
                buf = io.BytesIO()
                if tables:
                    pq.write_table(pa.concat_tables(tables), buf,
                                   compression="snappy")
                parts.append(buf.getvalue())
        finally:
            plan.close()
        return cls(schema, parts)

    def size_bytes(self) -> int:
        return sum(len(p) for p in self._partitions)

    @property
    def num_partitions(self) -> int:
        return len(self._partitions)

    def read_all(self) -> pa.Table:
        tabs = [self.read_partition(p) for p in range(self.num_partitions)]
        tabs = [t for t in tabs if t is not None]
        if not tabs:
            return pa.table({f.name: pa.array([], T.to_arrow(f.dtype))
                             for f in self.schema})
        return pa.concat_tables(tabs)

    def read_partition(self, p: int) -> Optional[pa.Table]:
        blob = self._partitions[p]
        if not blob:
            return None
        return pq.read_table(io.BytesIO(blob))


class InMemoryRelationExec(LeafExec):
    """Scan over a CachedRelation (reference: GpuInMemoryTableScanExec)."""

    def __init__(self, cached: CachedRelation, device: DeviceLike = None):
        super().__init__()
        self.cached = cached
        self._device = resolve_device(device)

    @property
    def output_schema(self) -> Schema:
        return self.cached.schema

    @property
    def num_partitions(self) -> int:
        return self.cached.num_partitions

    @property
    def device(self) -> torch.device:
        return self._device

    def do_execute_partition(self, p: int):
        t = self.cached.read_partition(p)
        if t is None or t.num_rows == 0:
            return
        batch, _ = from_arrow(t, schema=self.cached.schema,
                              device=self._device)
        yield batch
