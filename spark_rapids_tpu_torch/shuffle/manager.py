"""Shuffle manager: the one place the planner asks for an exchange.

Port of ``spark_rapids_tpu/shuffle/manager.py`` (``get_shuffle_manager``
and ``create_exchange``) for its DEFAULT and ICI modes: both plant the
in-process ``ShuffleExchangeExec`` of ``shuffle/exchange.py``, adaptive as
the conf says; under ICI the Session then lowers the planned query onto a
mesh (``parallel/lowering.py``), and a shape the lowering cannot take keeps
these exchanges. The thread-pooled (MULTITHREADED) and device-resident
(CACHED) modes come with ROADMAP item 8; asking for one raises
``NotImplementedError``.
"""

from __future__ import annotations

from typing import Optional

from ..config import (ADAPTIVE_ENABLED, ADAPTIVE_TARGET_ROWS, SHUFFLE_MODE,
                      RapidsTpuConf)
from ..exec.base import Exec
from .exchange import ShuffleExchangeExec
from .partitioning import Partitioning

#: the modes of the JAX package's manager, and the ROADMAP item that
#: brings each mode the port does not have yet
_LATER_MODES = {"MULTITHREADED": 8, "CACHED": 8}


class ShuffleManager:
    """Mode facade; construct through ``get_shuffle_manager``."""

    DEFAULT = "DEFAULT"
    ICI = "ICI"

    def __init__(self, conf: RapidsTpuConf):
        self.conf = conf
        self.mode = str(conf.get(SHUFFLE_MODE.key)).upper()
        if self.mode in _LATER_MODES:
            raise NotImplementedError(
                f"spark.rapids.tpu.shuffle.mode={self.mode} is not in the "
                f"port yet (ROADMAP item {_LATER_MODES[self.mode]}); the "
                f"port has DEFAULT and ICI")
        if self.mode not in (self.DEFAULT, self.ICI):
            raise ValueError(
                f"spark.rapids.tpu.shuffle.mode must be DEFAULT, "
                f"MULTITHREADED, ICI or CACHED, got {self.mode!r}")

    def create_exchange(self, partitioning: Partitioning,
                        child: Exec) -> Exec:
        """The exchange operator for the configured mode (under ICI too:
        the Session's mesh lowering replaces it where the plan allows)."""
        return ShuffleExchangeExec(
            partitioning, child,
            adaptive=self.conf.get(ADAPTIVE_ENABLED.key),
            target_rows=self.conf.get(ADAPTIVE_TARGET_ROWS.key))

    @property
    def wants_mesh_lowering(self) -> bool:
        return self.mode == self.ICI


def get_shuffle_manager(conf: Optional[RapidsTpuConf] = None
                        ) -> ShuffleManager:
    return ShuffleManager(conf or RapidsTpuConf())
