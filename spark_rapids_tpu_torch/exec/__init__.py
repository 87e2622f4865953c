"""Physical operators of the port."""

from .aggregate import AggregateMode, HashAggregateExec  # noqa: F401
from .base import BinaryExec, Exec, collect  # noqa: F401
from .basic import (ArithmeticException, ExpandExec,  # noqa: F401
                    FilterExec, GlobalLimitExec, InMemoryScanExec,
                    LocalLimitExec, ProjectExec, RangeExec, SampleExec,
                    UnionExec)
from .coalesce import (CoalesceBatchesExec, RequireSingleBatch,  # noqa: F401
                       TargetSize)
from .generate import GenerateExec  # noqa: F401
from .key_batching import KeyBatchingExec  # noqa: F401
from .join import (BroadcastNestedLoopJoinExec, HashJoinExec,  # noqa: F401
                   JoinType)
from .sort import (SortExec, SortOrder, TakeOrderedAndProjectExec,  # noqa
                   asc, desc)
from .window import WindowExec  # noqa: F401
from .fuse import (FusedStage, FusedStageExec, FusionUnsupported,  # noqa
                   try_fuse, try_fuse_exec)
