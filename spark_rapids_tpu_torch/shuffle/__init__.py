"""Shuffle: partitionings and the in-process exchange."""

from .exchange import (BroadcastExchangeExec,  # noqa: F401
                       BroadcastTooLargeError, ShuffleExchangeExec)
from .partitioning import HashPartitioning, SinglePartitioning  # noqa: F401
