"""AMP — Adaptive Multi-stream Prefetching (Gill & Bathen, FAST'07).

Counterpart of ``repro/cache/amp.py``: per-stream sequential detection
with an adaptive prefetch degree ``p`` and trigger distance ~p/2. The
degree grows when prefetched blocks are consumed and shrinks when they
are evicted unused. Every lane of the leading ``(B,)`` axis runs its own
stream table; updates are in place, one slot write per vector, and
``enabled=False`` is a bit-exact no-op.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple, Union

import torch

from ..core.hashindex import EMPTY, arange, argmin_first, first_index, lanes_of


@dataclasses.dataclass(frozen=True)
class AmpConfig:
    n_streams: int = 32
    init_degree: int = 4
    max_degree: int = 8     # also the width of the per-step prefetch vector
    min_run: int = 2        # sequential run length before prefetching starts


class AmpState(NamedTuple):
    last: torch.Tensor      # (B, NS) last block seen per stream
    seqlen: torch.Tensor    # (B, NS) current sequential run length
    frontier: torch.Tensor  # (B, NS) highest block prefetched for the stream
    deg: torch.Tensor       # (B, NS) adaptive prefetch degree
    age: torch.Tensor       # (B, NS) recency for stream-slot replacement
    clock: torch.Tensor     # (B,)


def init_amp(cfg: AmpConfig, device: Union[None, str, torch.device] = None,
             lanes: int = 1) -> AmpState:
    from ..kernels.backend import resolve_device
    dev = resolve_device(device)
    shape = (lanes, cfg.n_streams)

    def full(v, shp=shape):
        return torch.full(shp, v, dtype=torch.int32, device=dev)

    return AmpState(last=full(EMPTY), seqlen=full(0), frontier=full(EMPTY),
                    deg=full(cfg.init_degree), age=full(0),
                    clock=full(0, (lanes,)))


def amp_access(cfg: AmpConfig, st: AmpState, block: torch.Tensor,
               enabled) -> Tuple[AmpState, torch.Tensor]:
    """Advance AMP on a demand access; returns (state, (B, max_degree)
    blocks). ``s`` is the continuing stream on a sequential match, else
    the LRU victim slot; disabled lanes return all-EMPTY vectors."""
    ar = lanes_of(block)
    enabled = torch.as_tensor(enabled, device=block.device).expand(
        block.shape[0])
    clock = st.clock + enabled.to(torch.int32)
    match = st.last == (block - 1)[:, None]
    found = match.any(-1)
    s = torch.where(found, first_index(match), argmin_first(st.age))

    # continuing-stream values (meaningful only when found)
    old_last, old_seq = st.last[ar, s], st.seqlen[ar, s]
    old_front, deg = st.frontier[ar, s], st.deg[ar, s]
    run = old_seq + 1
    near_frontier = block + (deg // 2).clamp(min=1) >= old_front
    want = found & (run >= cfg.min_run) & near_frontier
    start = torch.maximum(old_front, block) + 1
    end = block + deg
    cand = start[:, None] + arange(cfg.max_degree, block.device).to(
        torch.int32)
    vec = torch.where((enabled & want)[:, None] & (cand <= end[:, None]),
                      cand, EMPTY)

    def sel(new, old):
        return torch.where(enabled, new, old)

    st.last[ar, s] = sel(block, old_last)
    st.seqlen[ar, s] = sel(torch.where(found, run, 1), old_seq).to(
        torch.int32)
    st.frontier[ar, s] = sel(
        torch.where(found,
                    torch.where(want, torch.maximum(old_front, end),
                                old_front),
                    block),
        old_front)
    st.deg[ar, s] = sel(torch.where(found, deg, cfg.init_degree), deg).to(
        torch.int32)
    st.age[ar, s] = sel(clock, st.age[ar, s])
    st.clock.copy_(clock)
    return st, vec


def _owning_stream(st: AmpState, block: torch.Tensor):
    """Stream whose prefetch range plausibly produced ``block``."""
    lo = st.frontier - 2 * st.deg.clamp(min=1)
    b = block[:, None]
    own = (b <= st.frontier) & (b >= lo) & (st.last != EMPTY)
    return own.any(-1), first_index(own)


def amp_feedback_used(cfg: AmpConfig, st: AmpState, block: torch.Tensor,
                      used: torch.Tensor) -> AmpState:
    """A prefetched block was consumed -> grow that stream's degree."""
    ar = lanes_of(block)
    found, s = _owning_stream(st, block)
    d = st.deg[ar, s]
    st.deg[ar, s] = torch.where(used & found,
                                (d + 1).clamp(max=cfg.max_degree), d)
    return st


def amp_feedback_evicted(cfg: AmpConfig, st: AmpState, block: torch.Tensor,
                         evicted_unused: torch.Tensor) -> AmpState:
    """A prefetched block died unused -> shrink that stream's degree."""
    ar = lanes_of(block)
    found, s = _owning_stream(st, block)
    d = st.deg[ar, s]
    st.deg[ar, s] = torch.where(evicted_unused & found,
                                (d - 1).clamp(min=1), d)
    return st
