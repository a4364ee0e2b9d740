"""Checkpoints in the reference's format (counterpart of `repro.checkpoint`)."""
from .ckpt import AsyncCheckpointer, latest_step, restore_checkpoint, save_checkpoint

__all__ = ["AsyncCheckpointer", "latest_step", "restore_checkpoint", "save_checkpoint"]
