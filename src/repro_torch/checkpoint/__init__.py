"""Checkpoints of training state (``ckpt.CheckpointManager``) and
restoring them onto another mesh (``elastic``)."""

from . import elastic
from .ckpt import CheckpointManager

__all__ = ["CheckpointManager", "elastic"]
