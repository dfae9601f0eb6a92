"""MITHRIL mining procedure.

Two implementations with identical semantics, as in the reference:

* ``associations_dense`` — vectorized: a stable sort by first
  timestamp, then every row ``i`` against the look-ahead window of rows
  ``i+1 .. i+W`` (the paper's inner loop breaks once the first-ts gap
  exceeds Delta; first timestamps are unique so ``W = min(rows-1,
  Delta)`` is safe). The pairwise check is the hot spot that the CUDA
  kernel ``kernels/csrc/mithril_mine.cu`` takes on the card.
* ``mine_reference_sequential`` — a literal numpy transcription of the
  paper's Algorithms 1 & 2, the test oracle.

Association semantics (paper Fig. 2 + Alg. 1): rows must have the SAME
number of timestamps; every aligned timestamp pair must differ by at
most ``Delta`` (weak); one pair with difference exactly 1 makes the
pair strong. Alg. 2 keeps, per source row, the FIRST association found
plus every STRONG one.

The vectorized functions take any leading dims: (N, ...) for one lane,
(L, N, ...) for a lanes axis.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from ..kernels.mithril_mine import pairwise_codes_plain
from ..kernels.mithril_mine_batched import pairwise_codes_batched_plain

INT32_MAX = np.iinfo(np.int32).max

# the plain forms of the pairwise check are the kernels' plain versions
pairwise_codes = pairwise_codes_plain
pairwise_codes_batched = pairwise_codes_batched_plain


def sort_by_first_ts(blocks: torch.Tensor, ts: torch.Tensor,
                     cnt: torch.Tensor, min_support: int,
                     max_support: int):
    """Stable-sort mining rows by first timestamp; invalid rows sink.

    A row is valid if ``R <= cnt <= S`` (cnt > S marks a frequent block
    the paper kicks out; cnt < R guards cleared rows).
    """
    valid = (cnt >= min_support) & (cnt <= max_support)
    key = torch.where(valid, ts[..., 0], INT32_MAX)
    order = torch.sort(key, dim=-1, stable=True).indices
    ts_order = order[..., None].expand(ts.shape)
    return (blocks.gather(-1, order), ts.gather(-2, ts_order),
            cnt.gather(-1, order), valid.gather(-1, order))


def select_pairs(code: torch.Tensor) -> torch.Tensor:
    """Alg. 2 selection: per row keep every strong pair plus the first
    pair. Returns a bool mask (..., N, W)."""
    any_assoc = code > 0
    first_d = any_assoc.to(torch.int32).argmax(-1)
    has_any = any_assoc.any(-1)
    w = code.shape[-1]
    is_first = ((torch.arange(w, device=code.device) == first_d[..., None])
                & has_any[..., None])
    return (code == 2) | (is_first & any_assoc)


def _emit_pairs(blk: torch.Tensor, code: torch.Tensor, max_pairs: int):
    """Alg. 2 selection + compaction: codes (..., N, W) ->
    (src, dst, valid, dropped), pairs (..., max_pairs).

    Pairs are compacted in the paper's discovery order (source-row-major,
    then ascending distance): valid pairs first.
    """
    mask = select_pairs(code)
    n, w = mask.shape[-2:]
    dev = code.device
    idx_j = (torch.arange(n, device=dev)[:, None]
             + torch.arange(1, w + 1, device=dev)[None, :]).clamp(max=n - 1)
    lead = mask.shape[:-2]
    src = blk[..., :, None].expand(*lead, n, w).reshape(*lead, n * w)
    dst = blk[..., idx_j].reshape(*lead, n * w)
    flat = mask.reshape(*lead, n * w)

    # stable compaction: flagged pairs first, discovery order kept
    order = torch.sort((~flat).to(torch.int32), dim=-1,
                       stable=True).indices[..., :max_pairs]
    dropped = (flat.sum(-1, dtype=torch.int32) - max_pairs).clamp(min=0)
    return (src.gather(-1, order), dst.gather(-1, order),
            flat.gather(-1, order), dropped)


def associations_dense(blocks: torch.Tensor, ts: torch.Tensor,
                       cnt: torch.Tensor, min_support: int,
                       max_support: int, delta: int, window: int,
                       max_pairs: int, pairwise_fn=pairwise_codes):
    """Full vectorized mining of one lane: (src, dst, valid, n_dropped).

    ``pairwise_fn`` (the (N, S) contract) lets the kernel slot in for
    the hot inner loop (``kernels.ops.mithril_pairwise``).
    """
    blk, tss, cnts, valid = sort_by_first_ts(blocks, ts, cnt, min_support,
                                             max_support)
    code = pairwise_fn(tss, cnts, valid, delta, window)
    return _emit_pairs(blk, code, max_pairs)


def associations_dense_batched(blocks: torch.Tensor, ts: torch.Tensor,
                               cnt: torch.Tensor, min_support: int,
                               max_support: int, delta: int, window: int,
                               max_pairs: int, pairwise_fn=None):
    """``associations_dense`` over a leading lanes axis with ONE pairwise
    call on the whole (L, N, S) stack, so the kernel covers every lane
    with one launch."""
    fn = pairwise_fn or pairwise_codes_batched
    blk, tss, cnts, valid = sort_by_first_ts(blocks, ts, cnt, min_support,
                                             max_support)
    code = fn(tss, cnts, valid, delta, window)
    return _emit_pairs(blk, code, max_pairs)


# ---------------------------------------------------------------------------
# Sequential reference (paper Algorithms 1 & 2, verbatim) — test oracle
# ---------------------------------------------------------------------------

def _check_association(row_i: np.ndarray, row_j: np.ndarray, delta: int,
                       threshold: str) -> bool:
    """Paper Algorithm 1. Rows are 1-D arrays of timestamps (trimmed)."""
    if len(row_i) != len(row_j):
        return False
    diffs = np.abs(row_j - row_i)
    if np.any(diffs > delta):
        return False
    strong = bool(np.any(diffs == 1))
    if threshold == "strong":
        return strong
    return True  # weak suffices


def mine_reference_sequential(blocks: np.ndarray, ts: np.ndarray,
                              cnt: np.ndarray, min_support: int,
                              max_support: int,
                              delta: int) -> List[Tuple[int, int]]:
    """Paper Algorithm 2 on a raw (unsorted) mining table. Returns
    directed (src_block, dst_block) pairs in discovery order."""
    valid = (cnt >= min_support) & (cnt <= max_support)
    key = np.where(valid, ts[:, 0], INT32_MAX)
    order = np.argsort(key, kind="stable")
    blk, tss, cnts, val = blocks[order], ts[order], cnt[order], valid[order]

    pairs: List[Tuple[int, int]] = []
    n = len(blk)
    for i in range(n - 1):
        if not val[i]:
            continue
        threshold = "weak"
        row_i = tss[i, : cnts[i]]
        for j in range(i + 1, n):
            # invalid rows sort to the end with key INT32_MAX, so the
            # paper's single break-on-gap condition covers them too
            if not val[j] or tss[j, 0] - tss[i, 0] > delta:
                break
            if _check_association(row_i, tss[j, : cnts[j]], delta,
                                  threshold):
                pairs.append((int(blk[i]), int(blk[j])))
                threshold = "strong"
    return pairs
