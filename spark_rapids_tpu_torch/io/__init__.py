"""I/O layer: file sources, the file scan exec, writers and the cache.

Port of ``spark_rapids_tpu/io`` for Parquet (reference: GpuParquetScan.scala:96
with its three reader strategies PERFILE, COALESCING and MULTITHREADED,
GpuMultiFileReader.scala's shared thread pool, the writers
GpuParquetFileFormat:163 / ColumnarOutputWriter:64). Host decode rides the
port's C++ Parquet decoder (``csrc/rtpu_parquet.cpp``) with pyarrow as the
per-row-group fallback; the upload to the device is the ``from_arrow``
boundary of ``FileSourceScanExec``. The CSV, JSON, ORC, Avro, Delta and
Iceberg sources and their ``read_*`` DataFrame helpers come with later
slices; ``read_parquet`` is here.
"""

from .source import FileSource
from .parquet import ParquetSource, write_parquet
from .scan import FileSourceScanExec, read_parquet

__all__ = [n for n in dir() if not n.startswith("_")]
