"""Continuous-batching decode over a MITHRIL-managed tiered KV cache.

Counterpart of ``TieredServeEngine`` in ``repro/launch/serve.py``, the
measured serving scenario: requests carrying KV page working sets
arrive on a virtual clock (multi-tenant on-off arrivals in
``chip_smoke.py``), and each step flash-decodes the active batch over
the tier's device pool in one kernel launch.

    from repro_torch.cache.tiered import TieredKVCache
    from repro_torch.launch.serve import TieredServeEngine
    tier = TieredKVCache(256, 13, 8, 2, 32, device="cpu")
    eng = TieredServeEngine(tier, max_batch=3, n_q_heads=4)
    eng.submit(0, pages, decode_steps=3, arrival=0)
    metrics = eng.run()

The reference's ``ServeLoop`` and ``main`` drive a language model; they
wait for the port of the model substrate.
"""

from __future__ import annotations

import collections
import time
from typing import Dict, List

import numpy as np
import torch

from ..cache.tiered import TieredKVCache


def _percentiles(xs: List[float]) -> Dict[str, float]:
    if not xs:
        return {"p50": 0.0, "p95": 0.0, "p99": 0.0}
    arr = np.asarray(xs, np.float64)
    return {p: float(np.percentile(arr, q))
            for p, q in (("p50", 50), ("p95", 95), ("p99", 99))}


class TieredServeEngine:
    """Continuous-batching decode over the paged-KV tier under an
    arrival process.

    Each virtual step decodes the active batch through the tier's
    ``demand_batch``/``decode_batch`` split (residency demanded through
    the tier, so MITHRIL sees the interleaved page stream; one decode
    launch). The loop keeps one launch in flight: batch k's host
    marshalling (admission, page lists, query draw) overlaps batch k-1's
    decode, and the engine waits on the CUDA event recorded after that
    launch only right before the demand pass. ``metrics()`` splits the
    deterministic virtual-step counters (tokens, turnaround percentiles,
    tier counters), which equal the reference's, from wall-clock
    measurements (tok/s, step-latency percentiles, host vs device-wait
    seconds).
    """

    def __init__(self, tier: TieredKVCache, *, max_batch: int = 8,
                 n_q_heads: int = 4, seed: int = 0):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        self.tier = tier
        self.max_batch = int(max_batch)
        self.n_q_heads = int(n_q_heads)
        self._rng = np.random.default_rng(seed)
        self.queue: collections.deque = collections.deque()
        self.active: Dict[int, dict] = {}
        self.clock = 0                       # virtual step counter
        self.tokens = 0
        self.steps = 0
        self.turnaround: Dict[int, int] = {}  # rid -> steps in system
        self.occupancy: List[int] = []
        self.step_seconds: List[float] = []
        self.host_seconds = 0.0              # marshalling + bookkeeping
        self.device_wait_seconds = 0.0       # blocked on in-flight launch
        self._pending = None                 # event after the launch in flight

    def submit(self, rid: int, pages: np.ndarray, decode_steps: int,
               arrival: int = 0):
        """Enqueue a request: decode ``decode_steps`` tokens over the KV
        ``pages``; eligible for admission once clock >= ``arrival``.
        Submissions must be in nondecreasing arrival order (FIFO)."""
        if decode_steps < 1:
            raise ValueError(f"decode_steps must be >= 1, got {decode_steps}")
        if self.queue and int(arrival) < self.queue[-1]["arrival"]:
            raise ValueError("submissions must be in arrival order")
        self.queue.append({"rid": int(rid),
                           "pages": np.asarray(pages, np.int64),
                           "remaining": int(decode_steps),
                           "arrival": int(arrival)})

    def _admit(self):
        while self.queue and len(self.active) < self.max_batch \
                and self.queue[0]["arrival"] <= self.clock:
            req = self.queue.popleft()
            self.active[req["rid"]] = req

    def _sync(self):
        """Retire the in-flight decode launch, if any (device wait)."""
        if self._pending is None:
            return
        t0 = time.perf_counter()
        self._pending.synchronize()
        self.device_wait_seconds += time.perf_counter() - t0
        self._pending = None

    def step(self):
        """One continuous-batch decode step over the active requests:
        marshal batch k on the host, wait for k-1's launch, demand k's
        pages, launch k without waiting, then retire its bookkeeping
        (which depends on the virtual clock, never on the output)."""
        t0 = time.perf_counter()
        self._admit()
        if not self.active:
            self.clock += 1
            self.host_seconds += time.perf_counter() - t0
            return
        rids = sorted(self.active)            # deterministic batch order
        page_lists = [self.active[r]["pages"] for r in rids]
        lengths = np.asarray(
            [len(p) * self.tier.page_size for p in page_lists], np.int64)
        q = torch.from_numpy(self._rng.standard_normal(
            (len(rids), self.n_q_heads, self.tier.head_dim)
        ).astype(np.float32))
        self.host_seconds += time.perf_counter() - t0
        self._sync()
        t1 = time.perf_counter()
        tab = self.tier.demand_batch(page_lists)
        out = self.tier.decode_batch(q, tab, lengths)
        if out.is_cuda:
            self._pending = torch.cuda.Event()
            self._pending.record()
        self.occupancy.append(len(rids))
        for rid in rids:
            req = self.active[rid]
            req["remaining"] -= 1
            self.tokens += 1
            if req["remaining"] == 0:
                self.turnaround[rid] = self.clock - req["arrival"] + 1
                del self.active[rid]
        self.steps += 1
        self.clock += 1
        self.host_seconds += time.perf_counter() - t1
        self.step_seconds.append(time.perf_counter() - t0)

    def run(self):
        """Drive until every submitted request has retired."""
        while self.active or self.queue:
            if not self.active and self.queue \
                    and self.queue[0]["arrival"] > self.clock:
                self.clock = self.queue[0]["arrival"]   # fast-forward idle
            self.step()
        self._sync()                  # flush the last in-flight launch
        return self.metrics()

    def metrics(self) -> Dict[str, object]:
        self._sync()                  # wall split must include the tail
        turn = _percentiles([float(v) for v in self.turnaround.values()])
        lat = _percentiles(self.step_seconds)
        wall = self.host_seconds + self.device_wait_seconds
        return {
            # deterministic virtual-step counters
            "requests": len(self.turnaround),
            "tokens": self.tokens,
            "steps": self.steps,
            "mean_batch_occupancy": round(
                float(np.mean(self.occupancy)) if self.occupancy else 0.0, 4),
            "turnaround_steps_p50": turn["p50"],
            "turnaround_steps_p95": turn["p95"],
            "turnaround_steps_p99": turn["p99"],
            "tier": self.tier.stats.as_dict(),
            # wall-clock measurements: host marshalling vs time blocked
            # on the in-flight launch
            "wall_seconds": round(wall, 4),
            "host_seconds": round(self.host_seconds, 4),
            "device_wait_seconds": round(self.device_wait_seconds, 4),
            "throughput_tok_s": round(self.tokens / max(wall, 1e-9), 2),
            "step_latency_s_p50": round(lat["p50"], 6),
            "step_latency_s_p95": round(lat["p95"], 6),
            "step_latency_s_p99": round(lat["p99"], 6),
        }
