"""Shuffle: partitionings, the in-process exchange and its adaptive reads."""

from .exchange import (BroadcastExchangeExec,  # noqa: F401
                       BroadcastTooLargeError, ReadSpec,
                       ShuffleExchangeExec, coordinate_join_reads)
from .partitioning import (HashPartitioning,  # noqa: F401
                           RangePartitioning, RoundRobinPartitioning,
                           SinglePartitioning)
