"""The system under test: the port's entries, called as a cell's traffic
file says, on a configuration built from its file.

This is the only module of the benchmark that imports the program
(``repro_torch``); the rest reads what it returns: per-trace ``Stats``
and hit curves, the streaming engine's counters and the chunk runner's
replay count (the profiler gives the names of the kernels it launches).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np


class Pass(NamedTuple):
    """What one pass of the entry produced, on the host."""
    stats: dict                 # field -> (B, ...) int array
    hit_curve: np.ndarray       # (B, T) bool
    streaming: Optional[dict]   # ``streaming_stats()`` of a streamed pass


STATS = ("requests", "hits", "pf_issued", "pf_used", "pf_evicted_unused")


def sim_config(cfg: dict):
    """A ``repro_torch.cache.SimConfig`` from a configuration file."""
    from repro_torch.cache import SimConfig
    from repro_torch.cache.amp import AmpConfig
    from repro_torch.core import MithrilConfig
    return SimConfig(capacity=cfg["capacity"], ways=cfg["ways"],
                     policy=cfg["policy"], use_mithril=cfg["use_mithril"],
                     use_amp=cfg["use_amp"],
                     mithril=MithrilConfig(**cfg["mithril"]),
                     amp=AmpConfig(**cfg["amp"]))


class System:
    """One configuration and one entry, on one device."""

    def __init__(self, cfg: dict, traffic: dict, device):
        from repro_torch.cache import sweep_scheduled, sweep_streaming
        self.sim = sim_config(cfg)
        self.device = device
        self.entry = traffic["entry"]
        args = dict(traffic.get("entry_args", {}))
        if self.entry == "sweep_scheduled":
            if args.pop("plan", "wide") != "wide":
                raise ValueError("sweep_scheduled takes plan 'wide'")
            self._fn = sweep_scheduled
        elif self.entry == "sweep_streaming":
            self._fn = sweep_streaming
        else:
            raise ValueError(f"unknown entry {self.entry!r}")
        self.args = args

    @property
    def lane_width(self) -> Optional[int]:
        return self.args.get("lane_width")

    @property
    def chunk(self) -> int:
        from repro_torch.cache.sweep import DEFAULT_CHUNK
        return self.args.get("chunk", DEFAULT_CHUNK)

    def run(self, blocks: np.ndarray, lengths: np.ndarray) -> Pass:
        """One pass over the ``(B, T)`` corpus; results on the host."""
        out = self._fn(self.sim, blocks, lengths=lengths,
                       device=self.device, **self.args)
        streaming = None
        if self.entry == "sweep_streaming":
            streaming = out.streaming_stats()
            out = out.result
        return Pass({f: np.asarray(getattr(out.stats, f)) for f in STATS},
                    np.asarray(out.hit_curve), streaming)

    def runner(self):
        """The chunk runner the entry's passes use."""
        from repro_torch.cache import chunk_runner
        return chunk_runner(self.sim, device=self.device)


def build_kernels() -> bool:
    """Build the port's CUDA kernels that are missing or stale; True when
    anything was compiled."""
    from repro_torch.kernels import backend
    before = set(backend.BUILD_LOGS)
    backend.build_all()
    return bool(set(backend.BUILD_LOGS) - before)
