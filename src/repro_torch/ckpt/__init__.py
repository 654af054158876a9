"""Checkpoints, on disk the reference's ``repro.ckpt`` (formats 1 and 2)."""
from repro_torch.ckpt.checkpoint import (CheckpointManager, latest_step,
                                         list_steps, restore_checkpoint,
                                         restore_sharded_checkpoint,
                                         save_checkpoint,
                                         save_sharded_checkpoint)

__all__ = ["CheckpointManager", "save_checkpoint", "restore_checkpoint",
           "save_sharded_checkpoint", "restore_sharded_checkpoint",
           "latest_step", "list_steps"]
