"""MITHRIL state as a NamedTuple of int32 tensors.

Layout mirrors the paper's optimized structures (Sec. 4.2): a
set-associative recording table whose ``rec_loc``/``rec_row`` point at
migrated mining rows, a flat mining table of up to S timestamps per row
(``mine_fill`` counts occupied rows), and a set-associative prefetching
table of P association slots per source block.

Every leaf carries a leading lanes axis ``(B, ...)``: the port's
functions advance all lanes of a stacked state at once, and a single
trace is ``B = 1``. Updates are in place.
"""

from __future__ import annotations

from typing import NamedTuple, Union

import torch

from .config import MithrilConfig
from .hashindex import EMPTY


class MithrilState(NamedTuple):
    # recording table ------------------------------------------------------
    rec_key: torch.Tensor    # (B, NB, W)  block id, EMPTY if free
    rec_ts: torch.Tensor     # (B, NB, W, R) timestamps
    rec_cnt: torch.Tensor    # (B, NB, W)  number of recorded timestamps
    rec_age: torch.Tensor    # (B, NB, W)  insertion time (FIFO eviction)
    rec_loc: torch.Tensor    # (B, NB, W)  0=recording, 1=in mining table
    rec_row: torch.Tensor    # (B, NB, W)  mining row when rec_loc==1
    # mining table -----------------------------------------------------------
    mine_block: torch.Tensor  # (B, Nm)
    mine_ts: torch.Tensor     # (B, Nm, S)
    mine_cnt: torch.Tensor    # (B, Nm) (S+1 marks "frequent", excluded)
    mine_fill: torch.Tensor   # (B,)
    # prefetching table ------------------------------------------------------
    pf_key: torch.Tensor     # (B, PB, PW)    source block
    pf_vals: torch.Tensor    # (B, PB, PW, P) associated blocks
    pf_cnt: torch.Tensor     # (B, PB, PW)    FIFO ring position
    pf_age: torch.Tensor     # (B, PB, PW)    insertion time
    # counters ----------------------------------------------------------------
    ts: torch.Tensor          # (B,) logical timestamp (per record event)
    n_mines: torch.Tensor     # (B,)
    n_pairs: torch.Tensor     # (B,) associations written (cumulative)
    n_dropped: torch.Tensor   # (B,) pairs dropped by max_pairs compaction


def init_state(cfg: MithrilConfig,
               device: Union[None, str, torch.device] = None,
               lanes: int = 1) -> MithrilState:
    """A fresh state with ``lanes`` independent lanes on ``device``
    (``None`` means the card)."""
    from ..kernels.backend import resolve_device
    dev = resolve_device(device)
    nb, w, r = cfg.rec_buckets, cfg.rec_ways, cfg.min_support
    nm, s = cfg.mine_rows, cfg.max_support
    pb, pw, p = cfg.pf_buckets, cfg.pf_ways, cfg.prefetch_list

    def full(shape, v):
        return torch.full((lanes,) + shape, v, dtype=torch.int32, device=dev)

    return MithrilState(
        rec_key=full((nb, w), EMPTY), rec_ts=full((nb, w, r), 0),
        rec_cnt=full((nb, w), 0), rec_age=full((nb, w), 0),
        rec_loc=full((nb, w), 0), rec_row=full((nb, w), 0),
        mine_block=full((nm,), EMPTY), mine_ts=full((nm, s), 0),
        mine_cnt=full((nm,), 0), mine_fill=full((), 0),
        pf_key=full((pb, pw), EMPTY), pf_vals=full((pb, pw, p), EMPTY),
        pf_cnt=full((pb, pw), 0), pf_age=full((pb, pw), 0),
        ts=full((), 0), n_mines=full((), 0), n_pairs=full((), 0),
        n_dropped=full((), 0))
