"""Memory runtime: the device budget, tiered spill and OOM retry.

Port of ``spark_rapids_tpu/memory``: a reservation budget above the
device allocator, a catalog of spillable batches (device -> pinned host ->
disk) and the retry loop that releases pins, spills and re-runs (halving
its input on a repeated OOM). ``TpuSemaphore`` and ``QueryAdmission`` come
with the plugin and server slices; ``memory/packed.py`` with the network
shuffle.
"""

from .catalog import (BufferCatalog, OutOfBudgetError, SpillableBatch,
                      StorageTier, device_budget)
from .retry import (FinalOOMError, InjectedOOMError, SpillableInput,
                    acquire_with_retry, admit_all, is_retryable_oom,
                    maybe_inject, oom_injection, presplit_inputs,
                    register_with_retry, split_host_table,
                    split_input_halves, with_retry, with_retry_no_split)

__all__ = [n for n in dir() if not n.startswith("_")]
