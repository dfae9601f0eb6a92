"""The pairwise association check for one lane.

Counterpart of ``repro/kernels/mithril_mine.py`` (the Pallas
``pairwise_codes_kernel``): the same codes as
``mithril_mine_batched`` for one (N, S) mining table. On the card it is
the ``L = 1`` launch of the same CUDA kernel (``csrc/mithril_mine.cu``),
behind its own wrapper and launch counter; it serves the one-lane fast
path of ``core.mithril.mine_batched`` and ``core.mithril.mine``.
"""

from __future__ import annotations

import torch

from .mithril_mine_batched import launch, pairwise_codes_plain

__all__ = ["pairwise_codes_plain", "pairwise_codes_kernel"]


def pairwise_codes_kernel(ts: torch.Tensor, cnt: torch.Tensor,
                          valid: torch.Tensor, delta: int,
                          window: int) -> torch.Tensor:
    """(N, S) x (N,) x (N,) -> (N, W) codes.

    CPU tensors take :func:`pairwise_codes_plain`; CUDA tensors launch
    the kernel or raise.
    """
    if ts.dim() != 2:
        raise ValueError(f"ts must be (N, S), got {tuple(ts.shape)}")
    if ts.device.type == "cpu":
        return pairwise_codes_plain(ts, cnt, valid, delta, window)
    out, launched = launch(ts[None], cnt[None], valid[None], delta, window)
    pairwise_codes_kernel.launches += int(launched)
    return out[0]


pairwise_codes_kernel.launches = 0
