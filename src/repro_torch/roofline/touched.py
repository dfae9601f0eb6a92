"""The card's kernel bounds: the least bytes and operations of one launch
of the port's CUDA kernels on the data it is given, and the least time
they take on an H100 SXM.

A launch touches only the rows it probes, so its least traffic depends
on the data: which lanes are enabled, which buckets hit, which rows a
mining run finds valid. Each function here counts what this call's
inputs need (every input element read once, every output element the
call changes written once), running the kernel's plain version on a
copy where that is the quickest way to know what changes. These are the
bounds a measured device time is held against; ``analysis.KERNEL_MODELS``
instead prices the reference's TPU kernels by their copy-through
layouts (every table in and out once), which the card's kernels
undercut by orders of magnitude.

:func:`bound_ms` turns (bytes, operations) into the least time: bytes
over the card's memory rate, the integer and compare operations over
its non-tensor 32-bit rate, whichever is larger.
"""

from __future__ import annotations

import math

import torch

from ..core.hashindex import arange, bucket_index, first_index
from ..kernels.mithril_mine_step import LEAVES as MINE_LEAVES
from ..kernels.mithril_record import LEAVES as RECORD_LEAVES
from .analysis import H100_HBM_BW

H100_INT_OPS = 67e12     # non-tensor 32-bit operations/s (the fp32 line)


def bound_ms(bytes_: float, ops: float):
    """The least time in ms of work moving ``bytes_`` and doing ``ops``
    integer operations on an H100 SXM, and which of the two binds
    (``"bytes"`` or ``"operations"``)."""
    t_b, t_o = bytes_ / H100_HBM_BW, ops / H100_INT_OPS
    return max(t_b, t_o) * 1e3, ("bytes" if t_b >= t_o else "operations")


def record_event_bytes(cfg, st, blk, en) -> float:
    """Least bytes of one record event on ``st``, which the plain version
    then advances in place. Reads: every lane's enable flag; for an
    enabled lane its block, ``ts`` and ``mine_fill`` and the bucket's W
    keys and ages; for a hit, the slot's cnt, loc and row; for a
    migration, the slot's R timestamps; for an update of a mining row,
    its count. Writes: the int32 elements the event changes."""
    from ..kernels.mithril_record import record_step_plain
    lanes, w, r = blk.shape[0], cfg.rec_ways, cfg.min_support
    ar = arange(lanes, blk.device)
    b = bucket_index(blk, cfg.rec_buckets)
    hit = st.rec_key[ar, b] == blk[:, None]
    on = en != 0
    found = on & hit.any(-1)
    upd = found & (st.rec_loc[ar, b, first_index(hit)] == 1)
    before = [getattr(st, f).clone() for f in RECORD_LEAVES]
    record_step_plain(blk, en, *(getattr(st, f) for f in RECORD_LEAVES))
    changed = sum(int((getattr(st, f) != x).sum())
                  for f, x in zip(RECORD_LEAVES, before))
    mig = int((st.mine_fill != before[RECORD_LEAVES.index("mine_fill")])
              .sum())
    reads = (lanes + int(on.sum()) * (3 + 2 * w) + int(found.sum()) * 3
             + mig * r + int(upd.sum()))
    return 4.0 * (reads + changed)


def record_ops(cfg, n_enabled: int) -> float:
    """Operations of a record event on ``n_enabled`` lanes: the W-way
    probe, the R-slot stamp and the S-slot insert."""
    w, r, s = cfg.rec_ways, cfg.min_support, cfg.max_support
    return n_enabled * (16 + 8 * w + 6 * r + 8 * s)


def cache_set_bytes(ways: int, written: bool, hit: bool) -> float:
    """One access to a cache set: its W keys read; a hit writes the
    way's stamp, flag, layer and frequency; an insertion reads the W
    stamps and writes the way's seven fields."""
    if hit:
        return 4.0 * (ways + 4)
    if written:
        return 4.0 * (2 * ways + 7)
    return 4.0 * ways


def cache_access_work(cfg, carry, blk, val):
    """Least bytes and operations of one ``cache_access`` launch (``cfg``
    a ``SimConfig``; its first recording event fused) on ``carry``, which
    the plain version then advances in place. Bytes: per lane its valid
    flag and outputs (hit, need, used layer, the eviction); per valid
    lane its block, clock and request count (read and written), the
    cache set (:func:`cache_set_bytes`), the hit, used and evicted-unused
    counters it changes (read and written), and its record event
    (:func:`record_event_bytes`, less the enable flags, which the fused
    launch computes in registers). Operations: per valid lane the hash
    and W compares, per insertion two W-way minima (the second chance),
    and the record event's (:func:`record_ops`)."""
    from ..cache.simulator import cache_access_plain
    from ..core.hashindex import EMPTY
    m, w = cfg.mithril, cfg.ways
    rec = m.record_on.split("+")[0] if cfg.use_mithril else None
    acc = cache_access_plain(carry["cache"], carry["stats"], blk, val,
                             cfg.policy)
    hit, ev = acc.hit, acc.evicted
    n, n_hit = int(val.sum()), int(hit.sum())
    n_ins = int((val & ~hit).sum())
    by = blk.shape[0] * (1 + 14 + (rec is not None))
    by += 4.0 * (5 * n + 2 * n_hit + 2 * int((acc.used_src != 0).sum())
                 + 2 * int(ev.unused_pf.sum()))
    by += (n_hit * cache_set_bytes(w, False, True)
           + n_ins * cache_set_bytes(w, True, False)
           + (n - n_hit - n_ins) * cache_set_bytes(w, False, False))
    ops = n * (12.0 + w) + n_ins * 2.0 * w
    if rec is not None:
        b, en = {"miss": (blk, val & ~hit),
                 "evict": (ev.block, ev.block != EMPTY),
                 "all": (blk, val)}[rec]
        by += record_event_bytes(m, carry["mith"], b, en.to(torch.int32))
        by -= 4.0 * blk.shape[0]
        ops += record_ops(m, int(en.sum()))
    return by, ops


def mithril_prefetch_work(cfg, carry, blk, val):
    """Least bytes and operations of one ``mithril_prefetch`` launch on
    ``carry``, which the plain version then advances in place. Bytes:
    per lane its valid flag; per valid lane its block and clock, the
    prefetch bucket's keys and a hit way's P values; per live candidate
    the cache set (:func:`cache_set_bytes`, an insertion or a probe of W
    keys); the issued and evicted-unused counters it changes (read and
    written). Operations: per valid lane the hash and the prefetch
    bucket's compares, per live candidate the hash, W compares and, if
    inserted, a W-way minimum."""
    from ..cache.simulator import mithril_prefetch_plain
    from ..core import mithril
    from ..core.hashindex import EMPTY
    m, w = cfg.mithril, cfg.ways
    stats = carry["stats"]
    cands = mithril.lookup(m, carry["mith"], blk)
    issued0 = int(stats.pf_issued.sum())
    unused0 = int(stats.pf_evicted_unused.sum())
    mithril_prefetch_plain(carry["cache"], stats, carry["mith"], blk, val, m)
    issued = int(stats.pf_issued.sum()) - issued0
    unused = int(stats.pf_evicted_unused.sum()) - unused0
    n = int(val.sum())
    live = int(((cands != EMPTY) & val[:, None]).sum())
    found = int((val & (cands != EMPTY).any(-1)).sum())
    by = (blk.shape[0]
          + 4.0 * (2 * n + n * m.pf_ways + found * m.prefetch_list
                   + 2 * issued + 2 * unused)
          + issued * cache_set_bytes(w, True, False)
          + (live - issued) * cache_set_bytes(w, False, False))
    ops = n * (12.0 + m.pf_ways) + live * (12.0 + w) + issued * w
    return by, ops


def miss_event_bytes(cfg, st, page) -> float:
    """Least bytes of one serving-tier miss (one lane) on ``st``, which
    the plain version then advances in place: the record event's
    (:func:`record_event_bytes`, less the flag and the block, which come
    by value), the probe's W keys and a hit way's P values, and the
    1 + P ints of the result."""
    dev = st.ts.device
    blk = torch.tensor([page], dtype=torch.int32, device=dev)
    row = st.pf_key[0, bucket_index(blk, cfg.pf_buckets)]
    found = bool((row == blk[:, None]).any())
    by = record_event_bytes(cfg, st, blk,
                            torch.ones(1, dtype=torch.int32, device=dev))
    return by - 8.0 + 4.0 * (cfg.pf_ways + cfg.prefetch_list * found
                             + 1 + cfg.prefetch_list)


def miss_ops(cfg) -> float:
    """Operations of one miss: the record event's on its lane, the
    probe's hash (about 12 integer operations) and its W compares."""
    return record_ops(cfg, 1) + 12 + cfg.pf_ways


def pairwise_bytes(lanes, n, s, window) -> float:
    """The codes launch: each lane's N x S timestamps, counts and valid
    flags read, its N x W codes written."""
    return lanes * (n * s * 4 + n * 4 + n) + lanes * n * window * 4


def pairwise_ops(lanes, n, s, window) -> float:
    """The codes launch's S aligned compares per row pair in the window."""
    return lanes * n * window * s * 3


def mine_step_work(cfg, st, need):
    """Least bytes and operations of one mining run on ``st`` (the
    state is not changed), and the pairs it finds. Bytes read: the need
    flags; for a lane that mines, its counts and blocks, the live
    timestamps of its valid rows, the scalars, per prefetch bucket the
    pairs touch its W keys and ages and one way's P values and count,
    and the rec_loc of the recording buckets of its mined blocks (a
    record event leaves rec_loc = 1 only on a slot that holds a mined
    block, in the block's bucket) plus any other slot with rec_loc = 1.
    Bytes written: the int32 elements the run changes. Operations: a
    compare per sort step (N log2 N), 4 per row pair the window examines
    (both valid), 3 per live aligned timestamp of a pair with equal
    counts."""
    from ..core.mining import associations_dense_batched, sort_by_first_ts
    from ..kernels.mithril_mine_step import mine_step_plain
    nd = need.bool()
    lanes, n = st.mine_cnt.shape
    w = cfg.window
    _, _, cnt, valid = sort_by_first_ts(st.mine_block, st.mine_ts,
                                        st.mine_cnt, cfg.min_support,
                                        cfg.max_support)
    live = torch.where(valid, cnt, 0)
    reads = int(nd.sum()) * (2 * n + 5) + int(live[nd].sum())
    src, dst, ok, _ = associations_dense_batched(
        st.mine_block, st.mine_ts, st.mine_cnt, cfg.min_support,
        cfg.max_support, cfg.lookahead, w, cfg.pairs_cap)
    keys = [src] + ([dst] if cfg.symmetric else [])
    buckets = 0
    for lane in torch.nonzero(nd).flatten().tolist():
        got = torch.cat([k[lane][ok[lane]] for k in keys])
        buckets += int(torch.unique(bucket_index(got, cfg.pf_buckets))
                       .numel())
        mined = st.mine_block[lane, :min(int(st.mine_fill[lane]), n)]
        rec = torch.unique(bucket_index(mined, cfg.rec_buckets))
        outside = torch.ones(cfg.rec_buckets, dtype=torch.bool,
                             device=nd.device)
        outside[rec] = False
        reads += rec.numel() * cfg.rec_ways + int(
            (st.rec_loc[lane][outside] == 1).sum())
    reads += buckets * (2 * cfg.pf_ways + cfg.prefetch_list + 1)
    after = type(st)(*(x.clone() for x in st))
    mine_step_plain(cfg, after, nd)
    changed = sum(int((getattr(after, f) != getattr(st, f)).sum())
                  for f in MINE_LEAVES)
    idx = (torch.arange(n, device=cnt.device)[:, None]
           + torch.arange(1, w + 1, device=cnt.device)[None])
    inside = idx < n
    idx = idx.clamp(max=n - 1)
    pair = valid[..., :, None] & valid[..., idx] & inside      # (L, N, W)
    same = pair & (cnt[..., :, None] == cnt[..., idx])
    ops = (int(nd.sum()) * n * max(1.0, math.log2(max(n, 2)))
           + 4.0 * int(pair[nd].sum())
           + 3.0 * int(torch.where(same, cnt[..., :, None], 0)[nd].sum()))
    return lanes + 4.0 * (reads + changed), ops, int(ok[nd].sum())


def lookup_bytes(queries, pf_key, pf_vals) -> float:
    """Per query: the query, the bucket's W keys, a hit way's P values,
    the P outputs."""
    from ..kernels.hash_lookup import hash_lookup_plain
    ways, plist = pf_key.shape[1], pf_vals.shape[-1]
    hits = int((hash_lookup_plain(queries, pf_key, pf_vals) != -1)
               .any(-1).sum())
    return 4.0 * (queries.numel() * (1 + ways + plist) + hits * plist)


def lookup_ops(n_queries: int, ways: int) -> float:
    """Per query the hash (about 12 integer operations) and W compares."""
    return n_queries * (12.0 + ways)


def decode_bytes(q, pool, tab, lens) -> float:
    """Least bytes of one paged decode call: every (page, token) that
    some row's length reaches, K and V of every kv head, read once; q,
    the page table and lengths read, the output written."""
    npg, ps = tab.shape[1], pool.shape[1]
    pos = (torch.arange(npg, device=tab.device)[:, None] * ps
           + torch.arange(ps, device=tab.device)[None])       # (npg, ps)
    live = pos[None] < lens.long()[:, None, None]             # (B, npg, ps)
    keys = tab.long()[:, :, None] * ps + torch.arange(ps, device=tab.device)
    n_tok = int(torch.unique(keys[live]).numel())
    tok_bytes = pool[0, 0].numel() * pool.element_size()
    return (2.0 * n_tok * tok_bytes + 2 * q.numel() * q.element_size()
            + 4 * (tab.numel() + lens.numel()))


def decode_ops(q, lens) -> float:
    """Multiply-adds of QK and PV over the positions each row needs."""
    _, hq, hd = q.shape
    return 4.0 * hq * hd * float(lens.long().sum())
