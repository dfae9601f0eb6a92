"""PROBABILITY GRAPH (Griffioen & Appleton, USENIX Summer'94) prefetcher.

Counterpart of ``repro/cache/pg.py``: a directed graph over blocks whose
edge h->x is reinforced whenever x follows h within a short lookahead
window; the successors of the current block whose conditional
probability cnt(h->x)/occ(h) reaches a minimum chance are prefetched.
Bounded out-degree (LFU slot replacement) keeps the graph inside a fixed
budget. Every lane of the leading ``(B,)`` axis has its own graph;
updates are in place, one row write per table.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple, Union

import torch

from ..core.hashindex import (EMPTY, arange, argmin_first, first_index,
                              lanes_of, locate)


@dataclasses.dataclass(frozen=True)
class PgConfig:
    window: int = 3          # lookahead period (edges from the last W blocks)
    buckets: int = 4096
    ways: int = 4
    out_degree: int = 4      # neighbor slots per node (bounded out-degree)
    min_chance_num: int = 1  # prefetch if cnt/occ >= num/den
    min_chance_den: int = 4
    max_prefetch: int = 2    # candidates returned per access


class PgState(NamedTuple):
    hist: torch.Tensor   # (B, W) recent blocks ring
    key: torch.Tensor    # (B, GB, GW) node id
    nbr: torch.Tensor    # (B, GB, GW, K) successor ids
    cnt: torch.Tensor    # (B, GB, GW, K) edge counts
    occ: torch.Tensor    # (B, GB, GW) node occurrence count
    age: torch.Tensor    # (B, GB, GW)
    clock: torch.Tensor  # (B,)


def init_pg(cfg: PgConfig, device: Union[None, str, torch.device] = None,
            lanes: int = 1) -> PgState:
    from ..kernels.backend import resolve_device
    dev = resolve_device(device)
    gb, gw, k = cfg.buckets, cfg.ways, cfg.out_degree

    def full(shp, v):
        return torch.full((lanes,) + shp, v, dtype=torch.int32, device=dev)

    return PgState(hist=full((cfg.window,), EMPTY), key=full((gb, gw), EMPTY),
                   nbr=full((gb, gw, k), EMPTY), cnt=full((gb, gw, k), 0),
                   occ=full((gb, gw), 0), age=full((gb, gw), 0),
                   clock=full((), 0))


def _add_edge(cfg: PgConfig, st: PgState, src: torch.Tensor,
              dst: torch.Tensor, enabled: torch.Tensor) -> PgState:
    """Reinforce src -> dst per lane (upsert the src node, bump or claim
    an edge slot). With the guard false every slot keeps its value."""
    ar = lanes_of(src)
    g = enabled & (src != EMPTY) & (src != dst)
    b, w, found = locate(st.key, st.age, src, cfg.buckets)

    old_key, old_nbr = st.key[ar, b, w], st.nbr[ar, b, w]
    old_cnt, old_occ, old_age = st.cnt[ar, b, w], st.occ[ar, b, w], \
        st.age[ar, b, w]
    # post-upsert row values (a created row starts empty)
    f = found[:, None]
    nbr_row = torch.where(f, old_nbr, EMPTY)
    cnt_row = torch.where(f, old_cnt, 0)

    hit = nbr_row == dst[:, None]
    have = hit.any(-1)
    k = torch.where(have, first_index(hit), argmin_first(cnt_row))  # LFU
    at = arange(cfg.out_degree, src.device) == k[:, None]
    nbr_row = torch.where(at, dst[:, None], nbr_row)
    cnt_row = torch.where(at, torch.where(have[:, None], cnt_row + 1, 1),
                          cnt_row)

    create = g & ~found
    gc = g[:, None]
    st.key[ar, b, w] = torch.where(create, src, old_key)
    st.nbr[ar, b, w] = torch.where(gc, nbr_row, old_nbr)
    st.cnt[ar, b, w] = torch.where(gc, cnt_row, old_cnt).to(torch.int32)
    st.occ[ar, b, w] = torch.where(create, 0, old_occ).to(torch.int32)
    st.age[ar, b, w] = torch.where(create, st.clock, old_age)
    return st


def pg_access(cfg: PgConfig, st: PgState, block: torch.Tensor,
              enabled) -> Tuple[PgState, torch.Tensor]:
    """Update the graph with ``block``; returns (state, (B, max_prefetch)
    candidates). ``enabled=False`` freezes the graph bit for bit (its
    candidates are then meaningless and must be discarded)."""
    ar = lanes_of(block)
    enabled = torch.as_tensor(enabled, device=block.device).expand(
        block.shape[0])
    st.clock.add_(enabled.to(torch.int32))
    # reinforce edges from the last `window` blocks to this one
    hist = st.hist.clone()
    for i in range(cfg.window):
        _add_edge(cfg, st, hist[:, i], block, enabled)
    # upsert this block's node and bump its occurrence count
    b, w, found = locate(st.key, st.age, block, cfg.buckets)
    fresh = (enabled & ~found)[:, None]
    old_key, old_nbr = st.key[ar, b, w], st.nbr[ar, b, w]
    old_cnt, old_occ, old_age = st.cnt[ar, b, w], st.occ[ar, b, w], \
        st.age[ar, b, w]
    nbrs = torch.where(fresh, EMPTY, old_nbr)
    counts = torch.where(fresh, 0, old_cnt).to(torch.int32)
    occ_new = torch.where(enabled, torch.where(found, old_occ, 0) + 1,
                          old_occ).to(torch.int32)
    st.key[ar, b, w] = torch.where(enabled, block, old_key)
    st.nbr[ar, b, w] = nbrs
    st.cnt[ar, b, w] = counts
    st.occ[ar, b, w] = occ_new
    st.age[ar, b, w] = torch.where(enabled, st.clock, old_age)

    # candidates: successors with cnt/occ >= min_chance, top-by-count
    occ = occ_new.clamp(min=1)[:, None]
    qual = (nbrs != EMPTY) & (counts * cfg.min_chance_den
                              >= occ * cfg.min_chance_num)
    score = torch.where(qual, counts, -1)
    slots = arange(cfg.out_degree, block.device)
    cands = []
    for _ in range(cfg.max_prefetch):
        k = score.argmax(-1)
        ok = score[ar, k] > 0
        cands.append(torch.where(ok, nbrs[ar, k], EMPTY))
        # a taken slot drops out (a select, not a scalar write: no host
        # value is copied, so a CUDA graph can capture the step)
        score = torch.where(slots == k[:, None], -1, score)
    out = torch.stack(cands, 1)

    # slide history ring
    st.hist.copy_(torch.where(enabled[:, None],
                              torch.cat([hist[:, 1:], block[:, None]], 1),
                              hist))
    return st, out
