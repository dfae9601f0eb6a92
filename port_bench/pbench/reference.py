"""The plain reference: one block trace through a set-associative cache
with MITHRIL (and optionally AMP) prefetching, request by request, in
plain Python and NumPy.

It is written from the semantics the configuration file states, not from
the program under test, and imports nothing of it. All state is integer,
so the program's per-trace ``Stats`` and hit curve must equal these bit
for bit.

Semantics, per request of a trace:

1. Demand access to the cache (``ways``-way sets, ``capacity / ways``
   sets rounded up to a power of two, set = murmur3 finalizer of the
   block id masked by the set count). A hit refreshes the way's stamp
   (LRU), consumes its prefetch flag (counted as a used prefetch of the
   layer that inserted it) and bumps its frequency. A miss inserts the
   block: the first empty way, else the way with the smallest stamp; an
   unused prefetched victim with its second chance left is refreshed to
   the current clock once and the next smallest-stamp way goes instead.
2. MITHRIL records the block on a miss (``record_on = "miss"``): the
   recording table (set-associative, first-empty else FIFO-oldest
   victim) stamps up to R timestamps; at R the block migrates to the
   next mining-table row, where later records append up to S stamps
   (beyond S the row is marked frequent, S + 1). Timestamps count
   record events.
3. When the mining table is full, mining: rows with R <= count <= S,
   stably sorted by first timestamp; row i pairs with row j (i < j <= i
   + window) when their counts are equal, the first-timestamp gap is at
   most Delta and every aligned timestamp pair differs by at most Delta
   (weak); a difference of exactly 1 makes the pair strong. Each row
   keeps its first pair and every strong pair, in row-major order, at
   most ``pairs_cap`` pairs; each lands in the prefetching table (P
   slots a source, FIFO ring, duplicates ignored, FIFO-oldest victim by
   insertion age). Then the mining table and the recording table's
   entries that point into it are cleared.
4. Prefetch: the block's P associations are looked up and each absent
   one is inserted into the cache flagged as a prefetch.
5. With AMP: the consumed-prefetch feedback, the sequential stream
   detection (``n_streams`` streams, degree between 1 and
   ``max_degree``, trigger within half the degree of the frontier), its
   prefetches, then the evicted-unused feedback of AMP's inserts and of
   the demand eviction.

``simulate`` optionally counts the least bytes and operations of each
part (``touched``'s formulas) for the per-layer metrics.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from . import touched

EMPTY = -1
PF_NONE, PF_MITHRIL, PF_AMP = 0, 1, 2
N_PF_SRC = 4
INT32_MAX = 2**31 - 1
_M32 = 0xFFFFFFFF


def mix(key: int) -> int:
    """The murmur3 finalizer of a 32-bit key, as an unsigned value."""
    k = key & _M32
    k ^= k >> 16
    k = (k * 0x7FEB352D) & _M32
    k ^= k >> 15
    k = (k * 0x846CA68B) & _M32
    return k ^ (k >> 16)


def _pow2_ceil(n: int) -> int:
    return 1 << (n - 1).bit_length() if n & (n - 1) else n


class Cache:
    """The cache: per set, the ways' key, stamp, prefetch flag, second
    chance, prefetching layer and frequency."""

    def __init__(self, capacity: int, ways: int, policy: str):
        nb = _pow2_ceil(max(1, capacity // ways))
        self.mask, self.lru = nb - 1, policy == "lru"
        self.key = [[EMPTY] * ways for _ in range(nb)]
        self.stamp = [[0] * ways for _ in range(nb)]
        self.flag = [[0] * ways for _ in range(nb)]
        self.sc = [[0] * ways for _ in range(nb)]
        self.src = [[PF_NONE] * ways for _ in range(nb)]
        self.freq = [[0] * ways for _ in range(nb)]
        self.clock = 0

    def _insert(self, b: int, block: int, pf: int, src: int):
        """Insert into set ``b``; returns the eviction ``(block, unused
        prefetch, layer)`` or None."""
        keys = self.key[b]
        ev = None
        if EMPTY in keys:
            w = keys.index(EMPTY)
        else:
            st, fl, sc = self.stamp[b], self.flag[b], self.sc[b]
            w = st.index(min(st))
            if fl[w] == 1 and sc[w] == 0:         # second chance
                st[w] = self.clock
                sc[w] = 1
                w = st.index(min(st))
            ev = (keys[w], fl[w] == 1, self.src[b][w])
        keys[w] = block
        self.stamp[b][w] = self.clock
        self.flag[b][w] = pf
        self.sc[b][w] = 0
        self.src[b][w] = src
        self.freq[b][w] = 1
        return ev

    def access(self, block: int):
        """Demand access: ``(hit, used prefetch layer, eviction)``."""
        self.clock += 1
        b = mix(block) & self.mask
        keys = self.key[b]
        if block in keys:
            w = keys.index(block)
            fl = self.flag[b]
            used = self.src[b][w] if fl[w] == 1 else PF_NONE
            if self.lru:
                self.stamp[b][w] = self.clock
            fl[w] = 0
            self.src[b][w] = PF_NONE
            self.freq[b][w] += 1
            return True, used, None
        return False, PF_NONE, self._insert(b, block, 0, PF_NONE)

    def prefetch(self, block: int, src: int):
        """Prefetch-insert an absent block: ``(issued, eviction)``."""
        b = mix(block) & self.mask
        if block == EMPTY or block in self.key[b]:
            return False, None
        return True, self._insert(b, block, 1, src)


class Mithril:
    """One lane's MITHRIL tables (recording, mining, prefetching)."""

    def __init__(self, m: dict, count: bool = False):
        self.r, self.s = m["min_support"], m["max_support"]
        self.delta, self.p = m["lookahead"], m["prefetch_list"]
        self.n = m["mine_rows"]
        self.rec_mask, self.rec_ways = m["rec_buckets"] - 1, m["rec_ways"]
        self.pf_mask, self.pf_ways = m["pf_buckets"] - 1, m["pf_ways"]
        self.window = min(self.n - 1, m["lookahead"])
        self.pairs_cap = 2 * self.n
        if m.get("record_on", "miss") != "miss" or m.get("symmetric") or \
                m.get("max_window") or m.get("max_pairs"):
            raise ValueError("the reference follows record_on='miss', "
                             "asymmetric pairs and the default window and "
                             "pairs cap")
        nb, w = m["rec_buckets"], self.rec_ways
        self.rec_key = [[EMPTY] * w for _ in range(nb)]
        self.rec_ts = [[[0] * self.r for _ in range(w)] for _ in range(nb)]
        self.rec_cnt = [[0] * w for _ in range(nb)]
        self.rec_age = [[0] * w for _ in range(nb)]
        self.rec_loc = [[0] * w for _ in range(nb)]
        self.rec_row = [[0] * w for _ in range(nb)]
        self.mine_block = [EMPTY] * self.n
        self.mine_ts = [[0] * self.s for _ in range(self.n)]
        self.mine_cnt = [0] * self.n
        self.fill = 0
        self.migrated: List[tuple] = []    # slots pointing into the table
        pb, pw = m["pf_buckets"], self.pf_ways
        self.pf_key = [[EMPTY] * pw for _ in range(pb)]
        self.pf_vals = [[[EMPTY] * self.p for _ in range(pw)]
                        for _ in range(pb)]
        self.pf_cnt = [[0] * pw for _ in range(pb)]
        self.pf_age = [[0] * pw for _ in range(pb)]
        self.ts = 0
        self.n_mines = self.n_pairs = self.n_dropped = 0
        self.count = count
        self.record_bytes = 0        # least bytes of the record events
        self.mine_runs: List[tuple] = []   # (bytes, operations, pairs)

    # -- recording ---------------------------------------------------------
    def record(self, block: int) -> None:
        """One record event (the block missed)."""
        t, r = self.ts, self.r
        b = mix(block) & self.rec_mask
        keys = self.rec_key[b]
        found = block in keys
        if found:
            w = keys.index(block)
        elif EMPTY in keys:
            w = keys.index(EMPTY)
        else:
            ages = self.rec_age[b]
            w = ages.index(min(ages))
        old_ts = self.rec_ts[b][w]
        old_cnt, old_loc = self.rec_cnt[b][w], self.rec_loc[b][w]
        old_row = self.rec_row[b][w]
        if self.count:
            rows = sorted({min(self.fill, self.n - 1), old_row})
            before = self._record_snapshot(b, w, rows)
        is_upd = found and old_loc == 1
        is_rec = found and not is_upd
        migrate = False
        if not found:
            ts_row = [t] + [0] * (r - 1)
            cnt = 1
            migrate = r == 1
        elif is_rec:
            ts_row = list(old_ts)
            ts_row[old_cnt] = t
            cnt = old_cnt + 1
            migrate = cnt >= r
        else:
            ts_row, cnt = old_ts, old_cnt
        self.rec_ts[b][w] = ts_row
        self.rec_cnt[b][w] = cnt
        if not found:
            keys[w] = block
            self.rec_age[b][w] = t
            self.rec_loc[b][w] = 0
        if migrate:
            m = self.fill
            self.rec_loc[b][w] = 1
            self.rec_row[b][w] = m
            self.migrated.append((b, w))
            self.mine_block[m] = block
            self.mine_ts[m][:r] = ts_row
            self.mine_cnt[m] = r
            self.fill += 1
        elif is_upd:
            c = self.mine_cnt[old_row]
            if c < self.s:
                self.mine_ts[old_row][c] = t
                self.mine_cnt[old_row] = c + 1
            else:
                self.mine_cnt[old_row] = self.s + 1
        self.ts += 1
        if self.count:
            self.record_bytes += touched.record_event_bytes_one(
                self.rec_ways, r, found, migrate, is_upd,
                self._changed(before, self._record_snapshot(b, w, rows)))

    def _record_snapshot(self, b, w, rows):
        """The record event's elements: the slot, the mining ``rows`` it
        can write (the next free row and the slot's own) and the
        counters."""
        return ([self.rec_key[b][w], *self.rec_ts[b][w], self.rec_cnt[b][w],
                 self.rec_age[b][w], self.rec_loc[b][w], self.rec_row[b][w],
                 self.fill, self.ts]
                + [v for m in rows
                   for v in (self.mine_block[m], *self.mine_ts[m],
                             self.mine_cnt[m])])

    @staticmethod
    def _changed(a, b) -> int:
        return sum(x != y for x, y in zip(a, b))

    # -- mining ------------------------------------------------------------
    def pairs(self):
        """The mining run's pairs ``[(src, dst)]`` and the count dropped
        past ``pairs_cap``."""
        r, s, delta = self.r, self.s, self.delta
        rows = [(self.mine_ts[i][0] if r <= self.mine_cnt[i] <= s
                 else INT32_MAX, i) for i in range(self.n)]
        order = [i for _, i in sorted(rows, key=lambda x: x[0])]
        valid = [r <= self.mine_cnt[i] <= s for i in order]
        found = []
        for a in range(self.n):
            if not valid[a]:
                continue
            ia = order[a]
            ca, ta = self.mine_cnt[ia], self.mine_ts[ia]
            first = True
            for d in range(1, self.window + 1):
                j = a + d
                if j >= self.n or not valid[j]:
                    break
                ib = order[j]
                tb = self.mine_ts[ib]
                if tb[0] - ta[0] > delta:
                    break
                if self.mine_cnt[ib] != ca:
                    continue
                strong = False
                weak = True
                for k in range(ca):
                    diff = abs(tb[k] - ta[k])
                    if diff > delta:
                        weak = False
                        break
                    if diff == 1:
                        strong = True
                if weak and (first or strong):
                    found.append((self.mine_block[ia], self.mine_block[ib]))
                    first = False
        return found[:self.pairs_cap], max(0, len(found) - self.pairs_cap)

    def mine(self) -> None:
        """The mining run at a full mining table, and the clear."""
        if self.count:
            work = touched.mine_run_work(self)
            before = self._mine_snapshot()
        kept, dropped = self.pairs()
        for src, dst in kept:
            self._associate(src, dst)
        for b, w in self.migrated:       # every slot with loc 1 is here
            if self.rec_loc[b][w] == 1:
                self.rec_key[b][w] = EMPTY
                self.rec_loc[b][w] = 0
        self.migrated = []
        self.mine_block = [EMPTY] * self.n
        self.mine_ts = [[0] * self.s for _ in range(self.n)]
        self.mine_cnt = [0] * self.n
        self.fill = 0
        self.n_mines += 1
        self.n_dropped += dropped
        if self.count:
            changed = int((self._mine_snapshot() != before).sum())
            self.mine_runs.append((work[0] + 4.0 * changed, work[1],
                                   len(kept)))

    def _mine_snapshot(self) -> np.ndarray:
        """Every element a mining run may write."""
        return np.concatenate([
            np.ravel(self.mine_block), np.ravel(self.mine_ts),
            np.ravel(self.mine_cnt), np.ravel(self.rec_key),
            np.ravel(self.rec_loc), np.ravel(self.pf_key),
            np.ravel(self.pf_vals), np.ravel(self.pf_cnt),
            np.ravel(self.pf_age),
            [self.fill, self.ts, self.n_mines, self.n_pairs,
             self.n_dropped]]).astype(np.int64)

    def _associate(self, src: int, dst: int) -> None:
        b = mix(src) & self.pf_mask
        keys = self.pf_key[b]
        if src in keys:
            w = keys.index(src)
            vals = self.pf_vals[b][w]
            if dst not in vals:
                vals[self.pf_cnt[b][w] % self.p] = dst
                self.pf_cnt[b][w] += 1
                self.n_pairs += 1
        else:
            if EMPTY in keys:
                w = keys.index(EMPTY)
            else:
                ages = self.pf_age[b]
                w = ages.index(min(ages))
            keys[w] = src
            self.pf_vals[b][w] = [dst] + [EMPTY] * (self.p - 1)
            self.pf_cnt[b][w] = 1
            self.n_pairs += 1
        self.pf_age[b][w] = self.ts

    # -- prefetching -------------------------------------------------------
    def lookup(self, block: int) -> Optional[list]:
        """The block's associations, or None when it has no entry."""
        b = mix(block) & self.pf_mask
        keys = self.pf_key[b]
        if block in keys:
            return self.pf_vals[b][keys.index(block)]
        return None


class Amp:
    """One lane's AMP stream table."""

    def __init__(self, a: dict):
        ns = a["n_streams"]
        self.init, self.max = a["init_degree"], a["max_degree"]
        self.min_run = a["min_run"]
        self.last = [EMPTY] * ns
        self.seq = [0] * ns
        self.front = [EMPTY] * ns
        self.deg = [self.init] * ns
        self.age = [0] * ns
        self.clock = 0

    def _owner(self, block: int) -> int:
        for s, (f, d, la) in enumerate(zip(self.front, self.deg, self.last)):
            if la != EMPTY and f - 2 * max(d, 1) <= block <= f:
                return s
        return -1

    def used(self, block: int) -> None:
        s = self._owner(block)
        if s >= 0:
            self.deg[s] = min(self.deg[s] + 1, self.max)

    def evicted_unused(self, block: int) -> None:
        s = self._owner(block)
        if s >= 0:
            self.deg[s] = max(self.deg[s] - 1, 1)

    def access(self, block: int) -> list:
        """Advance on a demand access; the blocks to prefetch."""
        self.clock += 1
        prev = block - 1
        found = prev in self.last
        s = self.last.index(prev) if found else self.age.index(min(self.age))
        front, deg = self.front[s], self.deg[s]
        out = []
        if found:
            run = self.seq[s] + 1
            if run >= self.min_run and block + max(deg // 2, 1) >= front:
                start, end = max(front, block) + 1, block + deg
                out = list(range(start, min(end, start + self.max - 1) + 1))
                self.front[s] = max(front, end)
            self.seq[s] = run
        else:
            self.seq[s] = 1
            self.front[s] = block
            self.deg[s] = self.init
        self.last[s] = block
        self.age[s] = self.clock
        return out


def simulate(cfg: dict, trace: np.ndarray, count: bool = False) -> Dict:
    """One trace through the configuration ``cfg`` (the configuration
    file's ``system`` object). Returns the ``Stats`` fields, the hit
    curve and, with ``count``, the least bytes of the requests' cache set
    accesses, record events and prefetch lookups and each mining run's
    ``(bytes, operations, pairs, request index)``."""
    cache = Cache(cfg["capacity"], cfg["ways"], cfg["policy"])
    mith = Mithril(cfg["mithril"], count) if cfg["use_mithril"] else None
    amp = Amp(cfg["amp"]) if cfg["use_amp"] else None
    n = len(trace)
    hits = np.zeros(n, bool)
    n_hits = 0
    issued = [0] * N_PF_SRC
    used_pf = [0] * N_PF_SRC
    unused = [0] * N_PF_SRC
    set_bytes = lookup_bytes = 0.0
    mine_at: List[int] = []
    ways = cfg["ways"]
    for i, block in enumerate(trace.tolist()):
        hit, used, ev = cache.access(block)
        if hit:
            hits[i] = True
            n_hits += 1
        if used:
            used_pf[used] += 1
        if ev is not None and ev[1]:
            unused[ev[2]] += 1
        if count:
            set_bytes += touched.cache_set_bytes(ways, True, hit)
        if mith is not None:
            if not hit:
                mith.record(block)
                if mith.fill >= mith.n:
                    mith.mine()
                    mine_at.append(i)
            cands = mith.lookup(block)
            if count:
                lookup_bytes += touched.lookup_bytes_one(
                    mith.pf_ways, mith.p, cands is not None)
            for c in cands or ():
                ok, pev = cache.prefetch(c, PF_MITHRIL)
                if count and c != EMPTY:
                    set_bytes += touched.cache_set_bytes(ways, ok, False)
                if ok:
                    issued[PF_MITHRIL] += 1
                    if pev is not None and pev[1]:
                        unused[pev[2]] += 1
        if amp is not None:
            if used == PF_AMP:
                amp.used(block)
            for c in amp.access(block):
                ok, pev = cache.prefetch(c, PF_AMP)
                if ok:
                    issued[PF_AMP] += 1
                    if pev is not None and pev[1]:
                        unused[pev[2]] += 1
                        if pev[2] == PF_AMP:
                            amp.evicted_unused(pev[0])
            if ev is not None and ev[1] and ev[2] == PF_AMP:
                amp.evicted_unused(ev[0])
    out = {"requests": n, "hits": n_hits, "pf_issued": issued,
           "pf_used": used_pf, "pf_evicted_unused": unused,
           "hit_curve": hits}
    if count:
        out["set_bytes"] = set_bytes
        out["lookup_bytes"] = lookup_bytes
        out["record_bytes"] = mith.record_bytes if mith else 0.0
        out["mine_runs"] = [run + (at,) for run, at in
                            zip(mith.mine_runs if mith else (), mine_at)]
        out["mines"] = mith.n_mines if mith else 0
    return out
