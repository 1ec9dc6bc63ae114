"""Checkpointing of the port, after ``repro.checkpoint``."""
from repro_torch.checkpoint.ckpt import CheckpointCorrupt, CheckpointManager

__all__ = ["CheckpointCorrupt", "CheckpointManager"]
