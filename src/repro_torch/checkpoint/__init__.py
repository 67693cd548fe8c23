"""repro_torch.checkpoint — atomic, sharded, keep-k checkpointing."""

from .manager import (
    CheckpointManager,
    all_steps,
    latest_step,
    restore_checkpoint,
    save_checkpoint,
)

__all__ = [
    "CheckpointManager",
    "all_steps",
    "latest_step",
    "restore_checkpoint",
    "save_checkpoint",
]
