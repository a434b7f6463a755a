"""Checkpoint policies — the paper's two modes plus OFF.

The semantic split (paper §III-A) is *when* a checkpoint may be taken:

* TRANSPARENT — any step boundary. Periodic (every ``periodic_interval_s``)
  *and* on-demand (termination checkpoint inside the eviction notice).
* APPLICATION — only at application-defined **stage boundaries** (metaSPAdes'
  k-mer stages; for training, epoch/eval boundaries). "Compared to transparent
  checkpointing, application-specific checkpointing cannot be taken on
  demand" — so no termination checkpoints, and an eviction rolls the job back
  to the last completed stage.
* OFF — no protection (the paper's baseline rows).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass


class Mode(enum.Enum):
    OFF = "off"
    APPLICATION = "application"
    TRANSPARENT = "transparent"


@dataclass(frozen=True)
class CheckpointPolicy:
    mode: Mode = Mode.TRANSPARENT
    periodic_interval_s: float = 900.0      # paper uses 15/30 min
    poll_interval_s: float = 1.0            # metadata poll cadence
    async_writes: bool = True               # overlap write IO with training
    checkpoint_on_rebalance: bool = True    # AWS rebalance hint -> proactive ckpt

    @property
    def supports_on_demand(self) -> bool:
        return self.mode is Mode.TRANSPARENT

    @property
    def periodic_enabled(self) -> bool:
        return self.mode is Mode.TRANSPARENT

    @property
    def stage_boundary_enabled(self) -> bool:
        return self.mode is Mode.APPLICATION

    @staticmethod
    def off() -> "CheckpointPolicy":
        return CheckpointPolicy(mode=Mode.OFF)

    @staticmethod
    def application() -> "CheckpointPolicy":
        return CheckpointPolicy(mode=Mode.APPLICATION)

    @staticmethod
    def transparent(periodic_interval_s: float = 900.0) -> "CheckpointPolicy":
        return CheckpointPolicy(mode=Mode.TRANSPARENT,
                                periodic_interval_s=periodic_interval_s)
