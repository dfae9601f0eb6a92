"""Fixed-capacity cache replacement policies on tensors.

Counterpart of ``repro/cache/base.py``. Caches are set-associative
(buckets x ways) with a leading lanes axis ``(B, NB, W)``; every
operation advances all lanes at once and updates the tables in place,
one bucket-row write for all seven tables.

Policies: ``lru`` (stamp = last access) and ``fifo`` (stamp = insert
time). Prefetched blocks carry a flag for precision accounting and for
the paper's second-chance rule: an unused prefetched block that would be
evicted is instead refreshed to MRU once (Sec. 4.2.2).

Learned eviction plugs in through the optional ``scorer``: a function
of the per-way feature rows (recency, frequency, association hint,
prefetch flag) returning a keep-score per way; the victim is then the
minimum-score way instead of the minimum-stamp way.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Union

import torch

from ..core.hashindex import (EMPTY, arange, argmin_first, bucket_index,
                              first_index, lanes_of)

# prefetcher ids for per-source precision accounting
PF_NONE, PF_MITHRIL, PF_AMP, PF_PG = 0, 1, 2, 3
N_PF_SRC = 4
INT32_MAX = 2**31 - 1


class CacheState(NamedTuple):
    """Cache tables with a leading lanes axis.

    The seven (B, NB, W) tables are views of ONE packed (7, B, NB, W)
    tensor (build states with :func:`init_cache` or :func:`pack_cache`),
    so a bucket's rows of every table are read and written with one
    indexing op each.
    """
    key: torch.Tensor      # (B, NB, W) block id or EMPTY
    stamp: torch.Tensor    # (B, NB, W) recency (lru) / insertion (fifo)
    pf_flag: torch.Tensor  # (B, NB, W) 1 = prefetched & not yet used
    pf_sc: torch.Tensor    # (B, NB, W) 1 = second chance consumed
    pf_src: torch.Tensor   # (B, NB, W) which prefetcher inserted it
    freq: torch.Tensor     # (B, NB, W) accesses while resident
    assoc: torch.Tensor    # (B, NB, W) association-count hint at insert
    clock: torch.Tensor    # (B,)


N_TABLES = 7
# tables a hit rewrites at the hit way: (stamp if lru), pf_flag, pf_src, freq
_HIT_TABLES = {"lru": (1, 2, 4, 5), "fifo": (2, 4, 5)}


class Evicted(NamedTuple):
    block: torch.Tensor      # (B,) block id or EMPTY
    unused_pf: torch.Tensor  # (B,) bool: was an unused prefetched block
    pf_src: torch.Tensor     # (B,)


def pack_cache(key, stamp, pf_flag, pf_sc, pf_src, freq, assoc,
               clock) -> CacheState:
    """A :class:`CacheState` over one packed copy of the seven tables."""
    tables = torch.stack([key, stamp, pf_flag, pf_sc, pf_src, freq, assoc])
    return CacheState(*tables.unbind(0), clock.clone())


def init_cache(capacity: int, ways: int = 16,
               device: Union[None, str, torch.device] = None,
               lanes: int = 1) -> CacheState:
    """``capacity`` is rounded to a power-of-two bucket count x ways."""
    from ..kernels.backend import resolve_device
    dev = resolve_device(device)
    nb = max(1, capacity // ways)
    nb = 1 << (nb - 1).bit_length() if nb & (nb - 1) else nb  # pow2 ceil
    tables = torch.zeros((N_TABLES, lanes, nb, ways), dtype=torch.int32,
                         device=dev)
    tables[0].fill_(EMPTY)
    return CacheState(*tables.unbind(0),
                      torch.zeros((lanes,), dtype=torch.int32, device=dev))


def _tables(state: CacheState) -> torch.Tensor:
    """The packed (7, B, NB, W) tensor behind the state's tables."""
    base = state.key._base
    if (base is None or base.dim() != 4 or base.shape[0] != N_TABLES
            or state.assoc._base is not base
            or state.key.data_ptr() != base.data_ptr()):
        raise ValueError("CacheState tables must be views of one packed "
                         "tensor: build the state with init_cache or "
                         "pack_cache")
    return base


@functools.lru_cache(maxsize=None)
def _const(value: int, lanes: int, device: torch.device) -> torch.Tensor:
    """A cached read-only (B,) int32 constant."""
    return torch.full((lanes,), value, dtype=torch.int32, device=device)


@functools.lru_cache(maxsize=None)
def _table_mask(tables: tuple, device: torch.device) -> torch.Tensor:
    m = torch.zeros((N_TABLES, 1, 1), dtype=torch.bool, device=device)
    m[list(tables)] = True
    return m


def _no_evict(like: torch.Tensor) -> Evicted:
    n, dev = like.shape[0], like.device
    return Evicted(_const(EMPTY, n, dev), _const(0, n, dev).bool(),
                   _const(PF_NONE, n, dev))


def contains(state: CacheState, block: torch.Tensor) -> torch.Tensor:
    b = bucket_index(block, state.key.shape[1])
    return (state.key[lanes_of(block), b] == block[:, None]).any(-1)


def _bucket_rows(state: CacheState, b: torch.Tensor) -> torch.Tensor:
    """The (7, B, W) rows of bucket ``b`` of every table."""
    return _tables(state)[:, lanes_of(b), b]


def _set_bucket(state: CacheState, b: torch.Tensor, rows: torch.Tensor,
                old: torch.Tensor, do: torch.Tensor) -> None:
    """Write ``rows`` into bucket ``b`` where ``do``, else ``old`` back."""
    _tables(state)[:, lanes_of(b), b] = torch.where(do[None, :, None], rows,
                                                    old)


def _insert_rows(state: CacheState, old: torch.Tensor, block: torch.Tensor,
                 pf: int, src: int, assoc_hint=None, scorer=None):
    """Insertion as branchless row values for the bucket rows ``old``.

    Returns ``(rows, ev)``: the post-insert (7, B, W) rows (key, stamp,
    pf_flag, pf_sc, pf_src, freq, assoc) and the eviction record. The
    empty-way / second-chance / plain-eviction cases are all computed on
    the rows and selected per lane; ``scorer`` replaces the
    minimum-stamp victim with the minimum-score way, under the same
    second chance.
    """
    keys, stamps, flags, scs, srcs, freqs, assocs = old.unbind(0)
    n, dev = block.shape[0], block.device
    ar = lanes_of(block)
    clock = state.clock[:, None]
    ways = arange(keys.shape[1], dev)

    empty = keys == EMPTY
    any_empty = empty.any(-1)
    w_empty = first_index(empty)

    # second chance: only consulted (and consumed) when evicting. The
    # victim, if an unused prefetch with its chance left, is refreshed
    # to MRU once and the next-best victim evicts instead.
    protected = (flags == 1) & (scs == 0)
    if scorer is None:
        v0 = argmin_first(stamps)
    else:
        scores = scorer(clock - stamps, freqs, assocs, flags)
        v0 = argmin_first(scores)
    grant = protected[ar, v0] & ~any_empty
    g_at = (ways == v0[:, None]) & grant[:, None]
    refreshed = torch.where(g_at, clock, stamps)
    if scorer is None:
        v1 = argmin_first(refreshed)
    else:
        # a granted way is out of the running this insertion
        v1 = argmin_first(torch.where(g_at, INT32_MAX, scores))
    way = torch.where(any_empty, w_empty, torch.where(grant, v1, v0))

    ev = Evicted(
        block=torch.where(any_empty, EMPTY, keys[ar, way]),
        unused_pf=(~any_empty) & (flags[ar, way] == 1),
        pf_src=torch.where(any_empty, PF_NONE, srcs[ar, way]))

    rows = old.clone()
    rows[1] = refreshed
    rows[3] = torch.where(g_at, 1, scs)
    hint = _const(0, n, dev) if assoc_hint is None else assoc_hint
    vals = torch.stack([block, state.clock, _const(pf, n, dev),
                        _const(0, n, dev), _const(src, n, dev),
                        _const(1, n, dev), hint])
    at = (ways == way[:, None])[None]
    return torch.where(at, vals[:, :, None], rows), ev


def access(state: CacheState, block: torch.Tensor, policy: str = "lru",
           enabled=True, scorer=None, assoc_hint=None):
    """Demand access per lane. Returns (state, hit, used_pf_src, evicted).

    On miss the block is demand-inserted. ``used_pf_src`` is the
    prefetcher id if this hit consumed a prefetched block (else
    PF_NONE). With ``enabled=False`` the access is a bit-exact no-op
    reporting ``(hit=False, PF_NONE, no-evict)``.
    """
    n, dev = block.shape[0], block.device
    enabled = torch.as_tensor(enabled, device=dev).expand(n)
    state.clock.add_(enabled.to(torch.int32))
    b = bucket_index(block, state.key.shape[1])
    ar = lanes_of(block)
    old = _bucket_rows(state, b)
    keys, flags, srcs, freqs = old[0], old[2], old[4], old[5]
    ways_hit = keys == block[:, None]
    hit = ways_hit.any(-1)
    way = first_index(ways_hit)
    at = arange(keys.shape[1], dev) == way[:, None]

    used_src = torch.where(enabled & hit & (flags[ar, way] == 1),
                           srcs[ar, way], PF_NONE)

    # hit: touch the way (LRU), consume its prefetch flag, bump frequency
    hit_vals = torch.stack([block, state.clock, _const(0, n, dev),
                            _const(0, n, dev), _const(PF_NONE, n, dev),
                            freqs[ar, way] + 1, _const(0, n, dev)])
    hit_rows = torch.where(at[None] & _table_mask(_HIT_TABLES[policy], dev),
                           hit_vals[:, :, None], old)

    # miss: demand-insert
    ins_rows, ins_ev = _insert_rows(state, old, block, 0, PF_NONE,
                                    assoc_hint=assoc_hint, scorer=scorer)

    rows = torch.where(hit[None, :, None], hit_rows, ins_rows)
    evict = enabled & ~hit
    no_ev = _no_evict(block)
    ev = Evicted(*(torch.where(evict, m, e) for m, e in zip(ins_ev, no_ev)))
    _set_bucket(state, b, rows, old, enabled)
    return state, hit & enabled, used_src, ev


def insert_prefetch(state: CacheState, block: torch.Tensor, src: int,
                    enable: torch.Tensor, scorer=None, assoc_hint=None):
    """Prefetch-insert ``block`` per lane if enabled, valid and absent.

    Returns (state, issued, evicted). A suppressed insert writes the
    bucket rows back unchanged (bit-exact no-op).
    """
    b = bucket_index(block, state.key.shape[1])
    old = _bucket_rows(state, b)
    present = (old[0] == block[:, None]).any(-1)
    do = enable & (block != EMPTY) & ~present
    rows, ins_ev = _insert_rows(state, old, block, 1, src,
                                assoc_hint=assoc_hint, scorer=scorer)
    no_ev = _no_evict(block)
    ev = Evicted(*(torch.where(do, i, e) for i, e in zip(ins_ev, no_ev)))
    _set_bucket(state, b, rows, old, do)
    return state, do, ev
