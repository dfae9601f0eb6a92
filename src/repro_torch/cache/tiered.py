"""Tiered device/host paged-KV cache with a MITHRIL prefetching layer.

Counterpart of ``repro/cache/tiered.py``: "block" -> KV page, "cache"
-> the device-resident slot pool ("HBM"), "backend" -> host memory.
Multi-tenant decode interleaves the page accesses of many requests, the
interleaved-stream structure MITHRIL mines. The manager:

* keeps a fixed pool of device page slots (the cache) and a host pool
  (the backend);
* on each scheduled request demands that request's pages; a miss copies
  the page host -> device, evicting the LRU slot (an unused prefetched
  slot gets the paper's second chance);
* records page misses into MITHRIL and prefetches the predicted pages
  ahead of the request that will need them;
* serves attention through the paged flash-decode kernel over the
  device pool (``kernels/paged_decode.py``).

The management plane is host numpy and Python, call for call as in the
reference, so both packages evict the same slots on any one machine
(``np.argsort``'s default kind does not keep ties in index order, and
stamps tie often). The data plane lives on the tier's device: the host
pools are pinned CPU tensors, the slot pools device tensors; an install
is an asynchronous copy on the current stream, ordered after any decode
launch in flight. ``TieredStats`` gives the paper's metrics in this
setting: page hit ratio, prefetch precision and bytes moved.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Union

import numpy as np
import torch

from ..core import MithrilConfig, mithril
from ..kernels import ops
from ..kernels.backend import resolve_device


@dataclasses.dataclass
class TieredStats:
    accesses: int = 0
    hits: int = 0
    demand_fetches: int = 0
    prefetch_issued: int = 0
    prefetch_used: int = 0
    prefetch_evicted_unused: int = 0
    bytes_moved: int = 0

    @property
    def hit_ratio(self) -> float:
        return self.hits / max(1, self.accesses)

    @property
    def precision(self) -> float:
        return self.prefetch_used / max(1, self.prefetch_issued)

    def as_dict(self) -> Dict[str, object]:
        """Counters + derived ratios, all deterministic given the access
        stream (no wall-clock)."""
        out = dict(dataclasses.asdict(self))
        out["hit_ratio"] = round(self.hit_ratio, 6)
        out["precision"] = round(self.precision, 6)
        return out


def _as_tensor(x, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.ascontiguousarray(x))
    return x.to(device=device, dtype=dtype)


class MissRoute:
    """A one-lane MITHRIL state fed one missed item at a time: record the
    miss, mine when the event filled the mining table, and return the
    item's prefetch candidates (the reference's record, ``maybe_mine``,
    then ``lookup``). The serving tier's misses and the data pipeline's
    shard readahead both take this route.

    On the card a miss is one launch and one wait (``ops.MissStep``);
    after a full mining table, :meth:`mine_and_probe` adds the mining run
    (``ops.mithril_mine_step``) and the lookup kernel, and one wait. CPU
    states take the plain versions."""

    def __init__(self, cfg: MithrilConfig, dev: torch.device):
        self.cfg = cfg
        self.state = mithril.init(cfg, dev)
        self._miss = ops.MissStep(cfg.mine_rows, cfg.prefetch_list, dev)
        # the item of a miss that mined, for the lookup after the run
        self._query = torch.zeros(1, dtype=torch.int32, device=dev)
        self._all = ops.all_lanes(1, dev)         # need of the one lane
        # the lane's prefetch table, as the lookup takes it: the same
        # tensors every call, so its launcher binds them once
        self._pf = (self.state.pf_key[0], self.state.pf_vals[0])

    def miss(self, item: int) -> List[int]:
        """Record a miss of ``item``; its candidates, EMPTY dropped."""
        need, cand = self._miss(self.state, item)
        return self.mine_and_probe(item) if need else cand

    def mine_and_probe(self, item: int) -> List[int]:
        """The mining run of the lane, then the probe of ``item`` in the
        mined table."""
        ops.mithril_mine_step(self.cfg, self.state, self._all)
        self._query.fill_(item)     # a fill launch: no host-to-device copy
        cand = ops.prefetch_lookup(self._query, *self._pf)
        return [c for c in cand[0].tolist() if c >= 0]


class TieredKVCache:
    """Page-granular two-tier KV store with optional MITHRIL prefetch.

    ``device=None`` means the card; pass ``device="cpu"`` for the plain
    path on the CPU.
    """

    def __init__(self, n_host_pages: int, n_hbm_slots: int, page_size: int,
                 n_kv: int, head_dim: int, *,
                 mithril_cfg: Optional[MithrilConfig] = None,
                 seed: int = 0,
                 device: Union[None, str, torch.device] = None):
        dev = resolve_device(device)
        rng = np.random.default_rng(seed)
        shape = (n_host_pages, page_size, n_kv, head_dim)
        # the host tier holds the ground-truth page contents, drawn as the
        # reference draws them (K, then V)
        host_k = self._host(rng.standard_normal(shape).astype(np.float32),
                            dev)
        host_v = self._host(rng.standard_normal(shape).astype(np.float32),
                            dev)
        self._setup(host_k, host_v, n_hbm_slots, mithril_cfg, dev)

    @classmethod
    def from_host_pools(cls, host_k, host_v, n_hbm_slots: int, *,
                        mithril_cfg: Optional[MithrilConfig] = None,
                        device: Union[None, str, torch.device] = None
                        ) -> "TieredKVCache":
        """A fresh tier over the given (n_host_pages, ps, Hkv, hd) float32
        host pools (numpy arrays or tensors)."""
        dev = resolve_device(device)
        tier = cls.__new__(cls)
        tier._setup(cls._host(host_k, dev), cls._host(host_v, dev),
                    n_hbm_slots, mithril_cfg, dev)
        return tier

    @staticmethod
    def _host(arr, dev: torch.device) -> torch.Tensor:
        t = _as_tensor(arr, torch.device("cpu"), torch.float32)
        return t.pin_memory() if dev.type == "cuda" else t

    def _setup(self, host_k: torch.Tensor, host_v: torch.Tensor,
               n_hbm_slots: int, mithril_cfg: Optional[MithrilConfig],
               dev: torch.device) -> None:
        _, self.page_size, self.n_kv, self.head_dim = host_k.shape
        self.device = dev
        self.n_hbm_slots = n_hbm_slots
        self.host_k, self.host_v = host_k, host_v
        # device tier: slot tensors + host-side slot metadata
        slot_shape = (n_hbm_slots,) + tuple(host_k.shape[1:])
        self.hbm_k = torch.zeros(slot_shape, dtype=torch.float32, device=dev)
        self.hbm_v = torch.zeros(slot_shape, dtype=torch.float32, device=dev)
        self.slot_page = np.full(n_hbm_slots, -1, np.int64)   # page in slot
        self.slot_stamp = np.zeros(n_hbm_slots, np.int64)     # LRU stamp
        self.slot_pf = np.zeros(n_hbm_slots, bool)            # unused prefetch
        self.slot_sc = np.zeros(n_hbm_slots, bool)            # 2nd chance used
        self.page_slot: Dict[int, int] = {}
        self.clock = 0
        self.page_bytes = int(np.prod(slot_shape[1:])) * 4 * 2   # k+v

        self.stats = TieredStats()
        self.mith_cfg = mithril_cfg
        self._route = None
        if mithril_cfg is not None:
            self._route = MissRoute(mithril_cfg, dev)
            self._mstate = self._route.state

    # -- tier management ----------------------------------------------------

    def _evict_slot(self) -> int:
        """LRU slot, honoring the paper's second chance for prefetches."""
        order = np.argsort(self.slot_stamp)
        for s in order:
            if self.slot_page[s] == -1:
                return s
            if self.slot_pf[s] and not self.slot_sc[s]:
                self.slot_sc[s] = True              # grant second chance
                self.slot_stamp[s] = self.clock     # move to MRU
                continue
            return s
        return order[0]

    def _install(self, page: int, prefetched: bool) -> int:
        s = self._evict_slot()
        old = self.slot_page[s]
        if old != -1:
            if self.slot_pf[s]:
                self.stats.prefetch_evicted_unused += 1
            del self.page_slot[old]
        self.hbm_k[s].copy_(self.host_k[page], non_blocking=True)
        self.hbm_v[s].copy_(self.host_v[page], non_blocking=True)
        self.slot_page[s] = page
        self.slot_stamp[s] = self.clock
        self.slot_pf[s] = prefetched
        self.slot_sc[s] = False
        self.page_slot[page] = s
        self.stats.bytes_moved += self.page_bytes
        return s

    def _touch(self, page: int) -> int:
        s = self.page_slot[page]
        self.slot_stamp[s] = self.clock
        if self.slot_pf[s]:
            self.stats.prefetch_used += 1
            self.slot_pf[s] = False
        return s

    def _mithril_on_miss(self, page: int) -> List[int]:
        """Record the miss and return the page's prefetch candidates
        (:class:`MissRoute`: one launch and one wait on the card, and
        after a full mining table the mining run and the lookup)."""
        return [] if self._route is None else self._route.miss(page)

    def access(self, pages: np.ndarray) -> np.ndarray:
        """Make ``pages`` resident; returns their slot ids."""
        slots = np.empty(len(pages), np.int64)
        for i, p in enumerate(map(int, pages)):
            self.clock += 1
            self.stats.accesses += 1
            if p in self.page_slot:
                self.stats.hits += 1
                slots[i] = self._touch(p)
            else:
                self.stats.demand_fetches += 1
                slots[i] = self._install(p, prefetched=False)
                for cand in self._mithril_on_miss(p):
                    if cand not in self.page_slot and \
                            cand < len(self.host_k):
                        self.stats.prefetch_issued += 1
                        self._install(cand, prefetched=True)
        return slots

    # -- data plane -----------------------------------------------------------

    def _ints(self, x) -> torch.Tensor:
        return torch.from_numpy(np.asarray(x, np.int32)).to(self.device)

    def attend(self, q, pages: np.ndarray, length: int) -> torch.Tensor:
        """Flash-decode one query over ``pages`` (made resident first).

        q: (Hq, hd). Returns (Hq, hd)."""
        slots = self.access(np.asarray(pages))
        q = _as_tensor(q, self.device, torch.float32)
        out = ops.paged_decode(q[None], self.hbm_k, self.hbm_v,
                               self._ints(slots[None]), self._ints([length]))
        return out[0]

    def demand_batch(self, page_lists: List[np.ndarray]) -> np.ndarray:
        """Host half of a continuous-batch step: demand residency for
        every request's pages and return the settled slot table.

        ``page_lists[i]`` are request i's page ids (ragged: the table is
        zero-padded to the widest request, and ``lengths`` masks the
        padding inside the kernel). Residency is demanded request by
        request IN ORDER, each page a MITHRIL access event; a later
        request's install may evict an earlier one's page mid-batch, so a
        pin pass re-installs any batch page lost that way. Re-installs
        count as ``bytes_moved`` but not as accesses. The whole batch
        must fit the slot pool. Installs are copies on the current
        stream, so they run after a decode launch still in flight.
        """
        n_batch_pages = sum(len(p) for p in page_lists)
        if n_batch_pages > self.n_hbm_slots:
            raise ValueError(f"batch demands {n_batch_pages} pages but the"
                             f" HBM pool has {self.n_hbm_slots} slots")
        for pages in page_lists:
            self.access(np.asarray(pages))
        # pin pass: stamp every resident batch page newest, then install
        # the missing ones; each pass at worst consumes one prefetch
        # second chance, so the slot count bounds the settling
        for _ in range(self.n_hbm_slots):
            self.clock += 1
            batch_pages = {int(p) for pages in page_lists for p in pages}
            missing = []
            for p in batch_pages:
                s = self.page_slot.get(p)
                if s is None:
                    missing.append(p)
                else:
                    self.slot_stamp[s] = self.clock
            if not missing:
                break
            for p in missing:
                self.clock += 1
                self._install(p, prefetched=False)
        else:
            raise RuntimeError("batch pages failed to settle in HBM")
        width = max(len(p) for p in page_lists)
        tab = np.zeros((len(page_lists), width), np.int64)
        for i, pages in enumerate(page_lists):
            tab[i, : len(pages)] = [self.page_slot[int(p)] for p in pages]
        return tab

    def decode_batch(self, q, tab: np.ndarray,
                     lengths: np.ndarray) -> torch.Tensor:
        """Device half: flash-decode the whole batch over its settled
        slot table in one kernel launch, over the device pools as they
        are (no copy). The launch is asynchronous; later installs are
        ordered after it on the stream."""
        q = _as_tensor(q, self.device, torch.float32)
        return ops.paged_decode(q, self.hbm_k, self.hbm_v, self._ints(tab),
                                self._ints(lengths))

    def attend_batch(self, q, page_lists: List[np.ndarray],
                     lengths: np.ndarray) -> torch.Tensor:
        """One continuous-batch decode step: :meth:`demand_batch` then
        :meth:`decode_batch`. q: (B, Hq, hd)."""
        if len(page_lists) != q.shape[0]:
            raise ValueError(f"need one page list per query, got "
                             f"{len(page_lists)} for batch {q.shape[0]}")
        tab = self.demand_batch(page_lists)
        return self.decode_batch(q, tab, lengths)
