"""Atomic step checkpoints in the reference's on-disk format."""
from repro_torch.checkpoint.checkpoint import (
    CheckpointError,
    latest_step,
    restore,
    save,
    save_async,
    wait_pending,
)

__all__ = [
    "CheckpointError",
    "latest_step",
    "restore",
    "save",
    "save_async",
    "wait_pending",
]
