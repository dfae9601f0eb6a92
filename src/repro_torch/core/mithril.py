"""MITHRIL prefetching layer on tensors (paper Alg. 3).

Counterpart of ``repro/core/mithril.py``. Every function takes a
stacked :class:`MithrilState` with a leading lanes axis ``(B, ...)``
and per-lane arguments of shape ``(B,)``; a single trace is ``B = 1``.
States are updated IN PLACE and returned, so a view of one lane
(``x[i:i+1]`` of every leaf) can be advanced on its own.

    state = init(cfg, device)
    state = record(cfg, state, block)            # rFlag path; mines when full
    cand  = lookup(cfg, state, block)            # pFlag path; (B, P) or EMPTY
    state, cand = access(cfg, state, block, do_record, do_lookup)
    state = mine(cfg, state)                     # usually triggered by record()
    state = mine_batched(cfg, states, need)      # the sweep's mining barrier

Record/mine split contract
--------------------------
``record_event`` advances the recording/mining tables but NEVER runs the
mining procedure; callers MUST call :func:`maybe_mine` before the next
recording event, which restores ``mine_fill < mine_rows``. ``record``
composes the two; the batched sweep engine (``cache/sweep.py``) keeps
them apart so mining runs at batch level.

Each per-event update is in the reference's branchless form: the
(bucket, way, row-value) updates of every case are computed and selected
per lane, then each table gets one row write. A disabled event writes
the old values back — bit-identical to not running at all.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ..kernels import ops
from ..kernels.mithril_record import record_step_plain
from .config import MithrilConfig
from .hashindex import EMPTY, arange, lanes_of, locate, probe
from .mining import associations_dense, associations_dense_batched
from .state import MithrilState, init_state

init = init_state
i32 = torch.int32


def _lane_vec(x, like: torch.Tensor, dtype=None) -> torch.Tensor:
    """A per-lane (B,) tensor from a scalar or (B,) value."""
    t = torch.as_tensor(x, device=like.device)
    if dtype is not None:
        t = t.to(dtype)
    return t.expand(like.shape[0])


# ---------------------------------------------------------------------------
# Prefetching table
# ---------------------------------------------------------------------------

def lookup(cfg: MithrilConfig, state: MithrilState,
           block: torch.Tensor) -> torch.Tensor:
    """Up to P prefetch candidates per lane (EMPTY-padded): (B, P).

    Pure read (pFlag path): needs no mining barrier."""
    b, way, found = probe(state.pf_key, block, cfg.pf_buckets)
    vals = state.pf_vals[lanes_of(block), b, way]
    return torch.where(found[:, None], vals, EMPTY)


def assoc_count(cfg: MithrilConfig, state: MithrilState,
                block: torch.Tensor) -> torch.Tensor:
    """Associations recorded with ``block`` as source (0 when absent)."""
    b, way, found = probe(state.pf_key, block, cfg.pf_buckets)
    return torch.where(found, state.pf_cnt[lanes_of(block), b, way], 0)


def add_association(cfg: MithrilConfig, state: MithrilState,
                    src: torch.Tensor, dst: torch.Tensor,
                    valid: torch.Tensor) -> MithrilState:
    """Insert association src -> dst per lane (FIFO within the P slots).

    The update-existing / insert-new / invalid cases reduce to one row
    write per prefetch-table tensor at ``(bucket, way)``; ``valid=False``
    writes the old values back (bit-exact no-op).
    """
    ar = lanes_of(src)
    b, w, found = locate(state.pf_key, state.pf_age, src, cfg.pf_buckets)
    upd = valid & found           # existing source row
    new = valid & ~found          # allocate (or evict into) a fresh row

    old_key, old_vals = state.pf_key[ar, b, w], state.pf_vals[ar, b, w]
    old_cnt, old_age = state.pf_cnt[ar, b, w], state.pf_age[ar, b, w]

    already = upd & (old_vals == dst[:, None]).any(-1)   # duplicate dst
    pos = torch.remainder(old_cnt, cfg.prefetch_list)    # FIFO ring slot
    kp = arange(cfg.prefetch_list, src.device)
    vals_upd = torch.where((kp == pos[:, None]) & ~already[:, None],
                           dst[:, None], old_vals)
    vals_new = torch.where(kp == 0, dst[:, None], EMPTY)
    stored = (upd & ~already) | new                      # a pair landed

    state.pf_key[ar, b, w] = torch.where(new, src, old_key)
    state.pf_vals[ar, b, w] = torch.where(
        upd[:, None], vals_upd, torch.where(new[:, None], vals_new, old_vals))
    state.pf_cnt[ar, b, w] = torch.where(
        new, 1, old_cnt + (upd & ~already).to(i32)).to(i32)
    # touch the entry age on every valid update: a re-mined source is hot
    state.pf_age[ar, b, w] = torch.where(valid, state.ts, old_age)
    state.n_pairs.add_(stored.to(i32))
    return state


# ---------------------------------------------------------------------------
# Mining
# ---------------------------------------------------------------------------

def _clear_after_mine(state: MithrilState, dropped: torch.Tensor,
                      need: Optional[torch.Tensor] = None) -> MithrilState:
    """Clear the mining table and drop stale recording-index pointers
    of the lanes in ``need`` (default: every lane)."""
    if need is None:
        need = torch.ones_like(state.mine_fill, dtype=torch.bool)
    n3 = need[:, None, None]
    state.rec_key.masked_fill_((state.rec_loc == 1) & n3, EMPTY)
    state.rec_loc.masked_fill_(n3, 0)
    state.mine_block.masked_fill_(need[:, None], EMPTY)
    state.mine_ts.masked_fill_(n3, 0)
    state.mine_cnt.masked_fill_(need[:, None], 0)
    state.mine_fill.masked_fill_(need, 0)
    state.n_mines.add_(need.to(i32))
    state.n_dropped.add_(torch.where(need, dropped, 0).to(i32))
    return state


def _fold_pairs(cfg: MithrilConfig, state: MithrilState, src, dst, valid,
                dropped, need: Optional[torch.Tensor] = None
                ) -> MithrilState:
    """Fold discovered pairs (B, K) into the prefetch table, then clear.

    The reference scans all K = pairs_cap pairs; an invalid pair is a
    bit-exact no-op and valid pairs come first (``_emit_pairs``), so the
    loop stops after the most valid pairs of any lane (one host sync).
    """
    if need is not None:
        valid = valid & need[:, None]
    n_valid = int(valid.sum(-1).max()) if valid.numel() else 0
    for k in range(n_valid):
        s, d, v = src[:, k], dst[:, k], valid[:, k]
        add_association(cfg, state, s, d, v)
        if cfg.symmetric:  # beyond-paper: bidirectional edges
            add_association(cfg, state, d, s, v)
    return _clear_after_mine(state, dropped, need)


def mine(cfg: MithrilConfig, state: MithrilState,
         pairwise_fn: Optional[Callable] = None) -> MithrilState:
    """Run the mining procedure on every lane of ``state`` (usually one)
    and fold associations into the prefetch table.

    On the card with no ``pairwise_fn`` the whole run is one launch
    (``ops.mithril_mine_step``). Otherwise the run is composed:
    ``pairwise_fn`` has the one-lane (N, S) contract of
    ``mining.pairwise_codes`` (default ``ops.mithril_pairwise``, the
    plain version on the CPU).
    """
    if pairwise_fn is None and state.ts.is_cuda:
        return ops.mithril_mine_step(
            cfg, state, ops.all_lanes(state.ts.shape[0], state.ts.device))
    fn = pairwise_fn or ops.mithril_pairwise
    outs = [associations_dense(
        state.mine_block[i], state.mine_ts[i], state.mine_cnt[i],
        cfg.min_support, cfg.max_support, cfg.lookahead, cfg.window,
        cfg.pairs_cap, pairwise_fn=fn) for i in range(state.ts.shape[0])]
    src, dst, valid, dropped = (torch.stack(x) for x in zip(*outs))
    return _fold_pairs(cfg, state, src, dst, valid, dropped)


def mine_batched(cfg: MithrilConfig, states: MithrilState,
                 need: torch.Tensor,
                 pairwise_fn: Optional[Callable] = None,
                 serial_pairwise_fn: Optional[Callable] = None
                 ) -> MithrilState:
    """Mine every lane flagged in ``need`` (B,) bool; others untouched.

    Per-lane results equal :func:`mine` on exactly the needed lanes. On
    the card with neither pairwise function given, the run is one launch
    of ``ops.mithril_mine_step`` on the device mask: no host wait, as the
    reference's ``lax.cond`` reads nothing on the host. Otherwise (the
    CPU, or a pairwise function passed) a host-side count of ``need``
    picks one of two composed paths:

    * exactly ONE lane flagged — the common case when trace lanes fill
      their tables at their own pace — runs :func:`mine` on a view of
      that lane (``serial_pairwise_fn``, default the one-lane codes);
    * several lanes flagged: one pass over ALL lanes, with
      ``pairwise_fn`` on the whole (B, N, S) stack (default the batched
      codes), then the pairs of the flagged lanes fold in.
    """
    if pairwise_fn is None and serial_pairwise_fn is None and \
            states.ts.is_cuda:
        return ops.mithril_mine_step(cfg, states, need)
    flagged = torch.nonzero(need).flatten().tolist()    # one host sync
    if not flagged:
        return states
    if len(flagged) == 1:
        i = flagged[0]
        mine(cfg, MithrilState(*(x[i:i + 1] for x in states)),
             pairwise_fn=serial_pairwise_fn or ops.mithril_pairwise)
        return states
    fn = pairwise_fn or ops.mithril_pairwise_batched
    src, dst, valid, dropped = associations_dense_batched(
        states.mine_block, states.mine_ts, states.mine_cnt,
        cfg.min_support, cfg.max_support, cfg.lookahead,
        cfg.window, cfg.pairs_cap, pairwise_fn=fn)
    return _fold_pairs(cfg, states, src, dst, valid, dropped, need=need)


# ---------------------------------------------------------------------------
# Recording
# ---------------------------------------------------------------------------

def record_event(cfg: MithrilConfig, state: MithrilState,
                 block: torch.Tensor, enabled=True) -> MithrilState:
    """Record one request per lane WITHOUT the mining trigger.

    Contract: callers MUST follow up with :func:`maybe_mine` before the
    next recording event. ``enabled=False`` makes the event a bit-exact
    no-op (``ts`` does not advance). This is the plain form; the fused
    CUDA kernel computes the same event through
    :func:`record_event_batched` with ``fused_fn``.
    """
    record_step_plain(
        _lane_vec(block, state.ts, i32).contiguous(),
        _lane_vec(enabled, state.ts, i32).contiguous(),
        state.rec_key, state.rec_ts, state.rec_cnt, state.rec_age,
        state.rec_loc, state.rec_row, state.mine_block, state.mine_ts,
        state.mine_cnt, state.mine_fill, state.ts)
    return state


def record_event_batched(cfg: MithrilConfig, states: MithrilState,
                         blocks: torch.Tensor, enabled,
                         fused_fn: Optional[Callable] = None
                         ) -> MithrilState:
    """Advance every lane by one recording event (the sweep hot path).

    Default is the plain form :func:`record_event`;
    ``fused_fn(states, blocks, enabled)`` swaps in the fused kernel
    (``kernels.ops.mithril_record_fused``), which the sweep engine
    passes. Both inherit the :func:`record_event` contract.
    """
    if fused_fn is not None:
        return fused_fn(states, blocks, enabled)
    return record_event(cfg, states, blocks, enabled)


def maybe_mine(cfg: MithrilConfig, state: MithrilState,
               pairwise_fn: Optional[Callable] = None) -> MithrilState:
    """Mine the lanes whose mining table is full (the Alg. 3 trigger):
    one launch and no host check on the card, one host check otherwise.
    ``pairwise_fn`` has the one-lane contract."""
    need = state.mine_fill >= cfg.mine_rows
    return mine_batched(cfg, state, need, serial_pairwise_fn=pairwise_fn)


def record(cfg: MithrilConfig, state: MithrilState, block: torch.Tensor,
           pairwise_fn: Optional[Callable] = None,
           enabled=True) -> MithrilState:
    """Record one request (Alg. 3 rFlag path); mines when the table fills."""
    state = record_event(cfg, state, block, enabled=enabled)
    return maybe_mine(cfg, state, pairwise_fn=pairwise_fn)


def access(cfg: MithrilConfig, state: MithrilState, block: torch.Tensor,
           do_record, do_lookup, pairwise_fn: Optional[Callable] = None):
    """Alg. 3: optional record (rFlag) + optional prefetch lookup (pFlag)."""
    state = record(cfg, state, block, pairwise_fn=pairwise_fn,
                   enabled=do_record)
    cand = lookup(cfg, state, block)
    do_lookup = _lane_vec(do_lookup, state.ts, torch.bool)
    return state, torch.where(do_lookup[:, None], cand, EMPTY)
