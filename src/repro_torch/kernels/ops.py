"""Public wrappers that adapt the core data layouts to the kernels.

Counterpart of ``repro/kernels/ops.py``. Each wrapper dispatches on the
device of the tensors it is given: CPU tensors take the kernel's plain
PyTorch version, CUDA tensors launch the kernel or raise. There is no
fallback from the card to the plain path.
"""

from __future__ import annotations

import functools
from typing import Dict, List, Tuple

import torch

from . import backend
from .cache_set import cache_access_kernel, mithril_prefetch_kernel
from .hash_lookup import hash_lookup_kernel
from .mithril_mine import pairwise_codes_kernel
from .mithril_mine_batched import pairwise_codes_batched_kernel
from .mithril_mine_step import mine_step_kernel
from .mithril_record import (miss_args, miss_step_kernel, miss_step_plain,
                             record_step_kernel)
from .paged_decode import paged_decode_kernel

KERNELS = {
    "mithril_record": record_step_kernel,
    "mithril_pairwise_batched": pairwise_codes_batched_kernel,
    "mithril_pairwise": pairwise_codes_kernel,
    "hash_lookup": hash_lookup_kernel,
    "paged_decode": paged_decode_kernel,
    "mithril_miss_step": miss_step_kernel,
    "mithril_mine_step": mine_step_kernel,
    "cache_access": cache_access_kernel,
    "mithril_prefetch": mithril_prefetch_kernel,
}


def launch_counts() -> Dict[str, int]:
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0
    paged_decode_kernel.merge_launches = 0


def set_launch_counts(counts: Dict[str, int]) -> None:
    """Put the counters back to ``counts`` (a ``launch_counts()``)."""
    for name, n in counts.items():
        KERNELS[name].launches = n


def add_launch_counts(counts: Dict[str, int], times: int = 1) -> None:
    """Count ``times`` runs of a captured CUDA graph that launches
    ``counts`` kernels of each name: a replay calls no wrapper."""
    for name, n in counts.items():
        KERNELS[name].launches += n * times


# drop-ins for ``core.mining.pairwise_codes`` ((N,S),(N,),(N,) -> (N,W)) and
# ``pairwise_codes_batched`` ((L,N,S),(L,N),(L,N) -> (L,N,W), every lane
# of the mining barrier in one launch)
mithril_pairwise = pairwise_codes_kernel
mithril_pairwise_batched = pairwise_codes_batched_kernel
# drop-in for ``core.mithril.mine_batched`` (cfg, states, need): the whole
# mining run of the flagged lanes, one launch on the card
mithril_mine_step = mine_step_kernel
# the request step's cache set (``cache_set``): the demand access with its
# statistics and first record event, one launch on the card; and the
# MITHRIL lookup with its prefetch inserts, one launch after the barrier
cache_access = cache_access_kernel
mithril_prefetch = mithril_prefetch_kernel


@functools.lru_cache(maxsize=None)
def _ones(lanes: int, device: torch.device) -> torch.Tensor:
    """A cached all-enabled flag vector: read-only, never write into it."""
    return torch.ones(lanes, dtype=torch.int32, device=device)


@functools.lru_cache(maxsize=None)
def all_lanes(lanes: int, device: torch.device) -> torch.Tensor:
    """A cached all-true (lanes,) bool mask (``need`` of a mining run of
    every lane): read-only, never write into it."""
    return torch.ones(lanes, dtype=torch.bool, device=device)


def _per_lane(x, lanes: int, device: torch.device,
              dtypes: Tuple[torch.dtype, ...]) -> torch.Tensor:
    """``x`` (a scalar or (lanes,) value) as a contiguous (lanes,) tensor
    on ``device`` of one of ``dtypes`` (the first when it must be
    converted); no copy when it is one already."""
    if isinstance(x, torch.Tensor) and x.dtype in dtypes and \
            x.device == device and x.shape == (lanes,) and x.is_contiguous():
        return x
    t = torch.as_tensor(x, device=device)
    if t.dtype not in dtypes:
        t = t.to(dtypes[0])
    return t.expand(lanes).contiguous()


def mithril_record_fused(states, blocks: torch.Tensor, enabled):
    """Fused record event over a lanes axis, in place.

    Drop-in for ``core.mithril.record_event`` on a stacked
    ``MithrilState``: ``blocks``/``enabled`` are ``(B,)`` or scalars
    (``enabled`` int32 or bool, as the kernel takes either). One launch
    covers the locate probe, the recording-table stamp and the
    mining-table insert for every lane; the prefetch table and the
    mining counters are not touched (``record_event`` never writes them).
    Inputs already in the kernel's form pass through without a copy, and
    ``enabled=True`` is a cached device vector of ones.
    Returns ``states``, whose tensors now hold the new values.
    """
    lanes = states.ts.shape[0]
    dev = states.ts.device
    blocks = _per_lane(blocks, lanes, dev, (torch.int32,))
    if enabled is True:
        enabled = _ones(lanes, dev)
    else:
        enabled = _per_lane(enabled, lanes, dev, (torch.int32, torch.bool))
    record_step_kernel(blocks, enabled, states.rec_key, states.rec_ts,
                       states.rec_cnt, states.rec_age, states.rec_loc,
                       states.rec_row, states.mine_block, states.mine_ts,
                       states.mine_cnt, states.mine_fill, states.ts)
    return states


class MissStep:
    """A serving tier's miss through MITHRIL: the record event of the
    page on the tier's one-lane state and the probe of its prefetch
    table (``mithril_record.miss_step_kernel``).

    On the card it is one launch, the page passed by value, and one wait
    on a CUDA event that the launch records: the kernel writes
    ``[need, candidates]`` to a pinned host buffer through its mapping,
    which the host reads after the wait. The buffer, the event and the
    state's binding are the tier's, made once. CPU states take the plain
    version.
    """

    def __init__(self, mine_rows: int, plist: int, device: torch.device):
        self.mine_rows = mine_rows
        self._bound = backend.Bound(miss_args)
        if device.type == "cuda":
            self._out = torch.empty(1 + plist, dtype=torch.int32,
                                    pin_memory=True)
            self._host = self._out.numpy()
            # created on the tier's card here; the launch records it
            self._done = torch.cuda.Event()
            with torch.cuda.device(device):
                self._done.record()

    def __call__(self, state, page: int) -> Tuple[bool, List[int]]:
        """``(need, candidates)`` of a miss of ``page``: need says the
        mining table is full (the caller mines, then looks up again); the
        candidates are the prefetch table's for the page, EMPTY dropped."""
        if state.ts.device.type == "cpu":
            res = miss_step_plain(page, state, self.mine_rows).tolist()
        else:
            miss_step_kernel(page, state, self.mine_rows, self._out,
                             bound=self._bound, done=self._done)
            self._done.synchronize()
            res = self._host.tolist()
        return res[0] != 0, [c for c in res[1:] if c >= 0]


def prefetch_lookup(queries: torch.Tensor, pf_key: torch.Tensor,
                    pf_vals: torch.Tensor) -> torch.Tensor:
    """Batched MITHRIL prefetch-table probe: (Q,) -> (Q, P) candidates,
    for any Q (the kernel needs no padding of the queries)."""
    return hash_lookup_kernel(queries.to(torch.int32), pf_key, pf_vals)


def paged_decode(q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor,
                 page_table: torch.Tensor, lengths: torch.Tensor
                 ) -> torch.Tensor:
    """Flash-decode over paged KV: (B, Hq, hd) x pools -> (B, Hq, hd).

    The page table and lengths may come as any integer type (the tier's
    page table is int64); the kernel takes them as int32."""
    return paged_decode_kernel(q, k_pool, v_pool,
                               page_table.to(torch.int32).contiguous(),
                               lengths.to(torch.int32).contiguous())
