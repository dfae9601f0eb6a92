"""Deterministic synthetic data pipeline with MITHRIL shard readahead.

A copy of the reference's pipeline on the port's pieces:

* **restart-reproducible** — batch(step) is a pure function of (seed,
  step), so checkpoint-restart resumes the exact stream (the same numpy
  bits as the reference's);
* **placement** — ``batch(step, device)`` builds the batch on the host
  and copies it to the device from pinned memory, without blocking;
* **readahead** — the shard-fetch stream (which "file" each step touches)
  feeds a MITHRIL instance; predicted shards are staged ahead of use.
  Shard access is mildly non-sequential (shuffled epochs re-visit shard
  groups), which is precisely the sporadic-association regime. A missed
  shard takes the serving tier's route (``cache.tiered.MissRoute``): on
  the card one miss launch, and after a full mining table the mining
  run and the lookup kernel.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional, Union

import numpy as np
import torch

from ..core import MithrilConfig


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_shards: int = 64          # virtual input files
    shard_group: int = 4        # shards co-read per step window


class SyntheticPipeline:
    """``mithril_cfg`` turns the readahead on, its one-lane state on
    ``device`` (None: the card)."""

    def __init__(self, cfg: DataConfig,
                 mithril_cfg: Optional[MithrilConfig] = None,
                 device: Union[None, str, torch.device] = None):
        self.cfg = cfg
        self.staged: set = set()
        self.readahead_hits = 0
        self.readahead_misses = 0
        self.mith_cfg = mithril_cfg
        self._route = None
        if mithril_cfg is not None:
            from ..cache.tiered import MissRoute
            from ..kernels.backend import resolve_device
            self._route = MissRoute(mithril_cfg, resolve_device(device))

    # -- shard schedule -------------------------------------------------------

    def shard_for_step(self, step: int) -> int:
        c = self.cfg
        epoch = step // c.n_shards
        rng = np.random.default_rng(c.seed + epoch)
        order = rng.permutation(c.n_shards)
        # group locality: consecutive steps hit a small co-read group
        g = (step % c.n_shards) // c.shard_group
        within = step % c.shard_group
        return int(order[(g * c.shard_group + within) % c.n_shards])

    def _stage(self, shard: int):
        self.staged.add(shard)

    def fetch_shard(self, step: int) -> int:
        shard = self.shard_for_step(step)
        if shard in self.staged:
            self.readahead_hits += 1
        else:
            self.readahead_misses += 1
            self._stage(shard)
            if self._route is not None:
                for c in self._route.miss(shard):
                    self._stage(int(c))
        # bound staging memory: keep most recent few groups
        if len(self.staged) > 4 * self.cfg.shard_group:
            self.staged = set(list(self.staged)[-4 * self.cfg.shard_group:])
        return shard

    # -- batches ---------------------------------------------------------------

    def batch_np(self, step: int) -> Dict[str, np.ndarray]:
        c = self.cfg
        shard = self.fetch_shard(step)
        rng = np.random.default_rng((c.seed, shard, step))
        tokens = rng.integers(0, c.vocab, (c.global_batch, c.seq_len),
                              dtype=np.int32)
        labels = np.roll(tokens, -1, axis=1)
        labels[:, -1] = -1
        return {"tokens": tokens, "labels": labels}

    def batch(self, step: int, device: Union[None, str, torch.device] = None
              ) -> Dict[str, torch.Tensor]:
        """``batch_np(step)`` as int32 tensors on ``device`` (None: the
        card): on a card, pinned host copies sent without blocking."""
        from ..kernels.backend import resolve_device
        dev = resolve_device(device)
        out = {}
        for name, arr in self.batch_np(step).items():
            host = torch.from_numpy(arr)
            if dev.type == "cuda":
                host = host.pin_memory()
            out[name] = host.to(dev, non_blocking=True)
        return out

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_np(step)
            step += 1
