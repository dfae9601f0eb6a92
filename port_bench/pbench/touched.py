"""The benchmark's yardstick for the kernels: the least bytes and
operations of the request step's parts and of a mining run, counted from
the inputs, and the card's peaks.

The record-event, lookup and mining-run formulas are frozen copies of
``repro_torch.roofline.touched`` (``record_event_bytes``,
``lookup_bytes``, ``mine_step_work``), rewritten per lane over the
reference's own state so that they do not depend on the program; the
tests hold them equal to the program's at fixed inputs. The cache set's
bytes are the benchmark's own: a set access reads the set's keys, an
insertion also its stamps, and the way written is counted whole.
"""

from __future__ import annotations

import math
from typing import Tuple

# NVIDIA's data sheet, H100 SXM: HBM3 bandwidth and the non-tensor 32-bit
# rate (the integer and compare work of these kernels)
PEAKS = {"NVIDIA H100 80GB HBM3": {"hbm_bytes_s": 3.35e12,
                                   "int32_ops_s": 67e12}}
H100 = PEAKS["NVIDIA H100 80GB HBM3"]


def bound_s(bytes_: float, ops: float) -> Tuple[float, str]:
    """The least seconds of work moving ``bytes_`` and doing ``ops``
    32-bit operations on the H100, and which of the two binds."""
    t_b, t_o = bytes_ / H100["hbm_bytes_s"], ops / H100["int32_ops_s"]
    return max(t_b, t_o), ("bytes" if t_b >= t_o else "operations")


def record_event_bytes_one(ways: int, r: int, found: bool, migrate: bool,
                           upd: bool, changed: int) -> float:
    """One enabled lane's share of ``touched.record_event_bytes``: its
    block, ``ts`` and ``mine_fill`` and the bucket's keys and ages; a hit
    slot's cnt, loc and row; a migration's R timestamps; an updated
    mining row's count; and the ``changed`` elements written. A launch
    adds 4 bytes a lane for the enable flags."""
    reads = (3 + 2 * ways) + 3 * found + r * migrate + upd
    return 4.0 * (reads + changed)


def lookup_bytes_one(ways: int, plist: int, hit: bool) -> float:
    """``touched.lookup_bytes`` of one query: the query, the bucket's W
    keys, a hit way's P values and the P outputs."""
    return 4.0 * (1 + ways + plist + plist * hit)


def cache_set_bytes(ways: int, written: bool, hit: bool) -> float:
    """One access to a cache set: its W keys read; a hit writes the
    way's stamp, flag, layer and frequency; an insertion reads the W
    stamps and writes the way's seven fields."""
    if hit:
        return 4.0 * (ways + 4)
    if written:
        return 4.0 * (2 * ways + 7)
    return 4.0 * ways


def mine_run_work(m) -> Tuple[float, float]:
    """One lane's share of ``touched.mine_step_work`` before its
    written elements: bytes read (the counts and blocks, the live
    timestamps of valid rows, the scalars, per prefetch bucket the pairs
    touch its W keys and ages and one way's P values and count, the
    recording buckets of the mined blocks and any other slot that points
    into the mining table) and operations (the sort's compares, 4 per
    valid row pair in the window, 3 per aligned timestamp of a pair with
    equal counts). ``m`` is the reference's ``Mithril`` lane at a full
    mining table. A launch adds one byte a lane for the need flags; the
    run adds 4 bytes for every element it changes."""
    from .reference import mix
    n, r, s, w = m.n, m.r, m.s, m.window
    valid = [r <= c <= s for c in m.mine_cnt]
    reads = 2 * n + 5 + sum(c for c, v in zip(m.mine_cnt, valid) if v)
    kept, _ = m.pairs()
    pf_buckets = {mix(src) & m.pf_mask for src, _ in kept}
    reads += len(pf_buckets) * (2 * m.pf_ways + m.p + 1)
    mined = m.mine_block[:min(m.fill, n)]
    rec = {mix(b) & m.rec_mask for b in mined}
    reads += len(rec) * m.rec_ways + sum(
        loc == 1 for b, locs in enumerate(m.rec_loc) if b not in rec
        for loc in locs)
    # the sort puts valid rows first, in first-timestamp order
    order = sorted(range(n), key=lambda i: m.mine_ts[i][0] if valid[i]
                   else 2**31 - 1)
    cnt = [m.mine_cnt[i] for i in order]
    nv = sum(valid)
    pairs = same = 0
    for i in range(nv):
        for j in range(i + 1, min(i + w, nv - 1) + 1):
            pairs += 1
            if cnt[j] == cnt[i]:
                same += cnt[i]
    ops = n * max(1.0, math.log2(max(n, 2))) + 4.0 * pairs + 3.0 * same
    return 4.0 * reads, ops
