"""Checkpointing: atomic, async, keep-last-k, verified restore with
fallback (port of ``repro/checkpoint``)."""
from repro_torch.checkpoint.manager import (CheckpointManager,
                                           CheckpointWriteError)

__all__ = ["CheckpointManager", "CheckpointWriteError"]
