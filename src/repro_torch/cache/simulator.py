"""Trace-driven cache+prefetch simulator on tensors.

Counterpart of ``repro/cache/simulator.py``. Composable the way the
paper composes layers (Fig. 1): a replacement policy (LRU/FIFO)
underneath, any subset of {MITHRIL, AMP, PG} prefetching on top.
Statistics match the paper's metrics:

  hit ratio            = hits / requests
  prefetch precision   = used prefetches / issued prefetches (per source)

Every carry leaf has a leading lanes axis ``(B, ...)`` — one trace per
lane — and the segments update it in place.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple, Union

import numpy as np
import torch

from ..core import MithrilConfig, mithril
from ..core.hashindex import EMPTY, lanes_of
from ..kernels import ops
from ..kernels.cache_set import Access
from ..learn.policy import LearnedConfig, make_scorer
from . import base
from .amp import (AmpConfig, amp_access, amp_feedback_evicted,
                  amp_feedback_used, init_amp)
from .base import N_PF_SRC, PF_AMP, PF_MITHRIL, PF_NONE, PF_PG
from .pg import PgConfig, init_pg, pg_access

Device = Union[None, str, torch.device]


@dataclasses.dataclass(frozen=True)
class SimConfig:
    capacity: int = 4096          # cache capacity in blocks
    ways: int = 16
    policy: str = "lru"           # lru | fifo
    use_mithril: bool = False
    use_amp: bool = False
    use_pg: bool = False
    use_learned: bool = False     # learned admission/eviction
    mithril: MithrilConfig = dataclasses.field(default_factory=MithrilConfig)
    amp: AmpConfig = dataclasses.field(default_factory=AmpConfig)
    pg: PgConfig = dataclasses.field(default_factory=PgConfig)
    learned: LearnedConfig = dataclasses.field(default_factory=LearnedConfig)

    def label(self) -> str:
        """Canonical config name: prefetchers joined by ``-``, then policy
        (e.g. ``mithril-amp-lru``, ``learned-mithril-lru``)."""
        parts = [n for n, u in [("learned", self.use_learned),
                                ("mithril", self.use_mithril),
                                ("amp", self.use_amp),
                                ("pg", self.use_pg)] if u]
        return "-".join(parts + [self.policy])


class Stats(NamedTuple):
    requests: torch.Tensor           # (B,)
    hits: torch.Tensor               # (B,)
    pf_issued: torch.Tensor          # (B, N_PF_SRC)
    pf_used: torch.Tensor            # (B, N_PF_SRC)
    pf_evicted_unused: torch.Tensor  # (B, N_PF_SRC)


def init_stats(device: Device = None, lanes: int = 1) -> Stats:
    from ..kernels.backend import resolve_device
    dev = resolve_device(device)

    def z(*shape):
        return torch.zeros((lanes,) + shape, dtype=torch.int32, device=dev)

    return Stats(z(), z(), z(N_PF_SRC), z(N_PF_SRC), z(N_PF_SRC))


class SimResult(NamedTuple):
    stats: Stats            # numpy leaves of one trace
    hit_curve: np.ndarray   # per-request hit boolean

    @property
    def hit_ratio(self) -> float:
        return float(self.stats.hits) / max(1, int(self.stats.requests))

    def precision(self, src: int) -> float:
        issued = int(self.stats.pf_issued[src])
        return (float(self.stats.pf_used[src]) / issued if issued
                else float("nan"))


def _count(table: torch.Tensor, col: torch.Tensor, flag: torch.Tensor):
    """``table[lane, col[lane]] += flag[lane]`` for every lane."""
    table.index_put_((lanes_of(col), col), flag.to(torch.int32),
                     accumulate=True)


def _apply_prefetches(cfg, cache, stats, cands, src, enable, scorer=None):
    """Insert a (B, K) candidate matrix; collect eviction feedback.

    An EMPTY candidate inserts nothing, issues nothing and evicts
    nothing, so on the CPU a column that is EMPTY in every lane is
    skipped (one host read; on the card the step reads nothing on the
    host and inserts every column)."""
    evs = []
    cols = range(cands.shape[1])
    if not cands.is_cuda:
        cols = torch.nonzero((cands != EMPTY).any(0)).flatten().tolist()
    for i in cols:
        cache, issued, ev = base.insert_prefetch(cache, cands[:, i], src,
                                                 enable, scorer=scorer)
        stats.pf_issued[:, src] += issued.to(torch.int32)
        _count(stats.pf_evicted_unused, ev.pf_src, ev.unused_pf)
        evs.append(ev)
    return cache, stats, evs


def cache_access_plain(cache, stats, block, valid, policy: str = "lru",
                       mith=None, record_on=None, mine_rows: int = 0,
                       scorer=None, assoc_hint=None, hit=None) -> Access:
    """The step's demand access of every lane with its statistics, then
    the record event of ``record_on`` (``"miss"``, ``"evict"``, ``"all"``
    or None) on ``mith``, in place: the plain version of
    ``ops.cache_access`` (its CPU path), and the card's path under a
    learned ``scorer`` (with its ``assoc_hint``), which the kernel does
    not take. The record event runs through ``ops.mithril_record_fused``.
    ``hit``, if given, receives the hit row."""
    stats.requests.add_(valid.to(torch.int32))
    _, hit_now, used_src, ev = base.access(cache, block, policy,
                                           enabled=valid, scorer=scorer,
                                           assoc_hint=assoc_hint)
    stats.hits.add_(hit_now.to(torch.int32))
    _count(stats.pf_used, used_src, used_src != PF_NONE)
    _count(stats.pf_evicted_unused, ev.pf_src, ev.unused_pf)
    need = None
    if record_on is not None:
        blk, en = {"miss": (block, valid & ~hit_now),
                   "evict": (ev.block, ev.block != EMPTY),
                   "all": (block, valid)}[record_on]
        ops.mithril_record_fused(mith, blk, en)
        need = (mith.mine_fill >= mine_rows) & valid
    if hit is not None:
        hit_now = hit.copy_(hit_now)
    return Access(hit_now, used_src, ev, need)


def mithril_prefetch_plain(cache, stats, mith, block, valid, mcfg,
                           scorer=None) -> None:
    """The MITHRIL lookup of every lane's block and the prefetch inserts
    of its candidates, in place: the plain version of
    ``ops.mithril_prefetch``, and the card's path under a learned
    ``scorer``."""
    cands = mithril.lookup(mcfg, mith, block)
    _apply_prefetches(None, cache, stats, cands, PF_MITHRIL, valid,
                      scorer=scorer)


def build_segments(cfg: SimConfig, device: Device = None):
    """Per-lane step split into segments separated by mining barriers.

    Returns ``(init_carry, segments)``: ``init_carry(lanes)`` builds the
    stacked carry on ``device`` and ``segments`` is a list of
    ``(fn, mine_after)`` pairs, each ``fn(carry, block, aux)`` returning
    ``(carry, aux)``. ``aux`` threads per-request values (``valid``,
    ``hit``, ``used_src``, the demand eviction) between segments.
    ``mine_after=True`` marks a point where a MITHRIL recording event
    may have filled the mining table, so the mining trigger MUST run
    before the next segment (the record/maybe_mine contract); such a
    segment leaves the barrier's mask in ``aux["need"]`` (the lanes,
    valid, whose mining table is full). ``aux["valid"]`` gates every
    state write at source, so an invalid (padded-tail) request is a
    bit-exact no-op. A ``aux["hit_out"]`` tensor receives the hit row.

    The cache set goes through ``ops.cache_access`` (the demand access,
    its statistics and the first recording event) and
    ``ops.mithril_prefetch`` (the MITHRIL lookup and its inserts): one
    launch each on the card, the plain composition on the CPU. A learned
    scorer (an arbitrary function of the way features, which the kernels
    do not take) runs :func:`cache_access_plain` and
    :func:`mithril_prefetch_plain` on either device.
    """
    rec_on = cfg.mithril.record_on
    # the recording event before the first barrier runs inside the access
    first_rec = rec_on.split("+")[0] if cfg.use_mithril else None
    mine_rows = cfg.mithril.mine_rows
    scorer = make_scorer(cfg.learned) if cfg.use_learned else None
    if scorer is None:
        access, prefetch = ops.cache_access, ops.mithril_prefetch
    else:
        access = functools.partial(cache_access_plain, scorer=scorer)
        prefetch = functools.partial(mithril_prefetch_plain, scorer=scorer)

    def init_carry(lanes: int = 1):
        carry = {"cache": base.init_cache(cfg.capacity, cfg.ways, device,
                                          lanes),
                 "stats": init_stats(device, lanes)}
        if cfg.use_mithril:
            carry["mith"] = mithril.init(cfg.mithril, device, lanes)
        if cfg.use_amp:
            carry["amp"] = init_amp(cfg.amp, device, lanes)
        if cfg.use_pg:
            carry["pg"] = init_pg(cfg.pg, device, lanes)
        return carry

    def seg_access(carry, block, aux):
        """Demand access + hit/eviction statistics, then the first
        recording event."""
        # association-count feature for learned insertion (a pure
        # pf-table read, so no mining-barrier interaction)
        hint = (mithril.assoc_count(cfg.mithril, carry["mith"], block)
                if cfg.use_learned and cfg.use_mithril else None)
        kw = {} if hint is None else {"assoc_hint": hint}
        acc = access(carry["cache"], carry["stats"], block, aux["valid"],
                     cfg.policy, carry.get("mith"), first_rec, mine_rows,
                     hit=aux.get("hit_out"), **kw)
        return carry, {**aux, "hit": acc.hit, "used_src": acc.used_src,
                       "ev": base.Evicted(*acc.evicted), "need": acc.need}

    def seg_record_evict(carry, block, aux):
        """The second recording event of ``miss+evict``."""
        ev, mith = aux["ev"], carry["mith"]
        ops.mithril_record_fused(mith, ev.block, ev.block != EMPTY)
        return carry, {**aux,
                       "need": (mith.mine_fill >= mine_rows) & aux["valid"]}

    def seg_prefetch(carry, block, aux):
        """Prefetch issue for every enabled layer (no mining in here)."""
        valid = aux["valid"]
        cache, stats = carry["cache"], carry["stats"]
        used_src, ev = aux["used_src"], aux["ev"]

        # MITHRIL prefetch-list check (Alg. 3 pFlag path)
        if cfg.use_mithril:
            prefetch(cache, stats, carry["mith"], block, valid, cfg.mithril)

        # AMP sequential prefetching + degree feedback, every piece
        # source-gated by valid-gated signals
        if cfg.use_amp:
            amp = amp_feedback_used(cfg.amp, carry["amp"], block,
                                    used_src == PF_AMP)
            amp, vec = amp_access(cfg.amp, amp, block, enabled=valid)
            _, _, evs = _apply_prefetches(cfg, cache, stats, vec, PF_AMP,
                                          valid, scorer=scorer)
            for e in evs:
                amp_feedback_evicted(cfg.amp, amp, e.block,
                                     e.unused_pf & (e.pf_src == PF_AMP))
            amp_feedback_evicted(cfg.amp, amp, ev.block,
                                 ev.unused_pf & (ev.pf_src == PF_AMP))

        # probability graph
        if cfg.use_pg:
            _, cands = pg_access(cfg.pg, carry["pg"], block, enabled=valid)
            _apply_prefetches(cfg, cache, stats, cands, PF_PG, valid,
                              scorer=scorer)
        return carry, aux

    segments = [(seg_access, first_rec is not None)]
    if cfg.use_mithril and rec_on == "miss+evict":
        segments.append((seg_record_evict, True))
    segments.append((seg_prefetch, False))
    return init_carry, segments


def build_step(cfg: SimConfig, device: Device = None):
    """Returns (init_carry, step) for a loop over a block trace.

    Serial composition of ``build_segments`` with ``mithril.maybe_mine``
    at every mining barrier: ``step(carry, block)`` advances every lane
    by one request (``block`` is (B,)) and returns ``(carry, hit)``.
    """
    init_carry, segments = build_segments(cfg, device)

    def step(carry, block):
        aux = {"valid": torch.ones_like(block, dtype=torch.bool)}
        for fn, mine_after in segments:
            carry, aux = fn(carry, block, aux)
            if mine_after:
                mithril.maybe_mine(cfg.mithril, carry["mith"])
        return carry, aux["hit"]

    return init_carry, step


def simulate(cfg: SimConfig, trace: np.ndarray,
             device: Device = None) -> SimResult:
    """Run ``trace`` (1-D int array of block ids) through the
    configuration: the batched engine at lane width 1, so the card path
    goes through the kernels. Bit-identical to the reference's serial
    ``simulate``."""
    from .sweep import sweep
    trace = np.asarray(trace, np.int32)
    return sweep(cfg, trace[None], device=device).result(0)


def max_hit_ratio(trace: np.ndarray) -> float:
    """1 - cold-miss ratio: the paper's 'maximum obtainable hit ratio'."""
    n_unique = len(np.unique(trace))
    return 1.0 - n_unique / max(1, len(trace))


class SimSession:
    """Incremental simulation: feed requests as they arrive.

    Holds a lane-width-1 carry of the batched engine between calls and
    steps it as requests are fed. Statistics and hit curve are
    bit-identical to ``simulate`` on the concatenated feed, however the
    feed was sliced.
    """

    def __init__(self, cfg: SimConfig, device: Device = None):
        from .sweep import build_batched_step
        from ..kernels.backend import resolve_device
        self._device = resolve_device(device)
        init_batched, self._step = build_batched_step(cfg, self._device)
        self._carry = init_batched(1)
        self._valid = torch.ones((1,), dtype=torch.bool, device=self._device)
        self._hits: list = []
        self._fed = 0
        self._done = False

    @property
    def requests_fed(self) -> int:
        return self._fed

    @property
    def carry(self) -> dict:
        """The engine's carry after the requests fed so far: cache state,
        MITHRIL state (``carry["mith"].n_mines`` counts mining runs) and
        counters, each leaf with a leading lanes axis of 1."""
        return self._carry

    def feed(self, blocks) -> None:
        """Append arrived requests; each runs immediately."""
        if self._done:
            raise RuntimeError("session already finished")
        blocks = np.atleast_1d(np.asarray(blocks, np.int32))
        self._fed += len(blocks)
        dev_blocks = torch.as_tensor(blocks, device=self._device)
        for t in range(len(blocks)):
            self._carry, hit = self._step(self._carry, dev_blocks[t:t + 1],
                                          self._valid)
            self._hits.append(hit)

    def finish(self) -> SimResult:
        if self._done:
            raise RuntimeError("session already finished")
        self._done = True
        from ..convert import to_numpy
        stats = Stats(*(leaf[0] for leaf in to_numpy(self._carry["stats"])))
        hits = (torch.cat(self._hits).cpu().numpy() if self._hits
                else np.zeros((0,), bool))
        return SimResult(stats, hits)
