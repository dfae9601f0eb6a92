"""Public wrappers that adapt the core data layouts to the kernels.

Counterpart of ``repro/kernels/ops.py``. Each wrapper dispatches on the
device of the tensors it is given: CPU tensors take the kernel's plain
PyTorch version, CUDA tensors launch the kernel or raise. There is no
fallback from the card to the plain path.
"""

from __future__ import annotations

from typing import Dict

import torch

from .hash_lookup import hash_lookup_kernel
from .mithril_mine import pairwise_codes_kernel
from .mithril_mine_batched import pairwise_codes_batched_kernel
from .mithril_record import record_step_kernel
from .paged_decode import paged_decode_kernel

KERNELS = {
    "mithril_record": record_step_kernel,
    "mithril_pairwise_batched": pairwise_codes_batched_kernel,
    "mithril_pairwise": pairwise_codes_kernel,
    "hash_lookup": hash_lookup_kernel,
    "paged_decode": paged_decode_kernel,
}


def launch_counts() -> Dict[str, int]:
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0
    paged_decode_kernel.merge_launches = 0


# drop-ins for ``core.mining.pairwise_codes`` ((N,S),(N,),(N,) -> (N,W)) and
# ``pairwise_codes_batched`` ((L,N,S),(L,N),(L,N) -> (L,N,W), every lane
# of the mining barrier in one launch)
mithril_pairwise = pairwise_codes_kernel
mithril_pairwise_batched = pairwise_codes_batched_kernel


def mithril_record_fused(states, blocks: torch.Tensor,
                         enabled: torch.Tensor):
    """Fused record event over a lanes axis, in place.

    Drop-in for ``core.mithril.record_event`` on a stacked
    ``MithrilState``: ``blocks``/``enabled`` are ``(B,)``. One launch
    covers the locate probe, the recording-table stamp and the
    mining-table insert for every lane; the prefetch table and the
    mining counters are not touched (``record_event`` never writes them).
    Returns ``states``, whose tensors now hold the new values.
    """
    lanes = states.rec_key.shape[0]
    dev = states.rec_key.device
    blocks = torch.as_tensor(blocks, device=dev).to(torch.int32)
    enabled = torch.as_tensor(enabled, device=dev).to(torch.int32)
    blocks = blocks.expand(lanes).contiguous()
    enabled = enabled.expand(lanes).contiguous()
    record_step_kernel(blocks, enabled, states.rec_key, states.rec_ts,
                       states.rec_cnt, states.rec_age, states.rec_loc,
                       states.rec_row, states.mine_block, states.mine_ts,
                       states.mine_cnt, states.mine_fill, states.ts)
    return states


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
