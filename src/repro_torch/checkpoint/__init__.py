"""Checkpointing: save/restore, retention, async writes, restore onto any
device (the port's copy of the JAX package's ``checkpoint``)."""
from repro_torch.checkpoint.io import (
    CheckpointManager, latest_step, load_checkpoint, save_checkpoint,
)

__all__ = ["CheckpointManager", "save_checkpoint", "load_checkpoint",
           "latest_step"]
