"""Checkpoints of training state (``ckpt.CheckpointManager``). Restoring
onto another mesh (the reference's ``elastic``) belongs with
distribution."""

from .ckpt import CheckpointManager

__all__ = ["CheckpointManager"]
