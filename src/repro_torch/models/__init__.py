"""Models of the port: the learned cache policy's training-time heads."""

from . import policy_head
from .policy_head import PolicyHead

__all__ = ["policy_head", "PolicyHead"]
