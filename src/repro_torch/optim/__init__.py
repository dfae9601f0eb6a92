"""Optimizers of the port."""

from . import adamw
from .adamw import AdamW, AdamWConfig, OptState, global_norm, schedule

__all__ = ["adamw", "AdamW", "AdamWConfig", "OptState", "global_norm",
           "schedule"]
