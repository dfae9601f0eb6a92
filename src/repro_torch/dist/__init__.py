"""Distributed execution: sharding rules, logical-axis contexts and
explicit expert-parallel MoE over ``torch.distributed``.

``dist`` sits below ``launch`` (which owns meshes and the cell steps)
and above ``models`` (which only speaks logical axes through
``ctx.constrain``). Importing it starts no process group. ``moe_ep``
loads on first use: it imports ``models``, which import this package.
"""

from . import sharding
from .ctx import ShardingCtx, constrain, current, resolve, sharding_ctx

__all__ = [
    "sharding", "ShardingCtx", "constrain", "current", "resolve",
    "sharding_ctx", "moe_ffn_ep", "moe_ffn_tp",
]


def __getattr__(name: str):
    if name in ("moe_ffn_ep", "moe_ffn_tp"):
        from . import moe_ep
        return getattr(moe_ep, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
