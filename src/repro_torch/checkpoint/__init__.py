"""Checkpoints of the port (mirrors ``repro/checkpoint``)."""

from repro_torch.checkpoint.store import (
    CheckpointManager,
    latest_step,
    restore,
    restore_resharded,
    save,
)

__all__ = ["CheckpointManager", "latest_step", "restore", "restore_resharded", "save"]
