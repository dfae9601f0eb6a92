"""Fixed-capacity set-associative hash tables on tensors.

Every map is a W-way set-associative array: ``bucket = mix(key) &
(n_buckets - 1)``, then a W-wide compare. ``choose_victim`` evicts the
smallest-age way; what "age" means is the caller's policy (see
``mithril.add_association`` and ``mithril.record_event``).

Keys are int32 block ids; EMPTY = -1. Functions take a leading lanes
axis: tables are ``(B, NB, W)`` and keys ``(B,)``; lane ``i`` probes its
own table. First-index tie semantics match ``argmax``/``argmin`` on the
reference's bool masks. Bucket and way indices come back as int64, the
index type torch takes (``bucket_of`` keeps the reference's int32).
"""

from __future__ import annotations

import functools

import torch

EMPTY = -1
_MASK32 = 0xFFFFFFFF


def _mix_u32(key: torch.Tensor) -> torch.Tensor:
    """The murmur3-style finalizer as an unsigned value in int64.

    The reference shifts as uint32. An int32 ``>>`` is arithmetic and
    gives other buckets for negative keys (EMPTY among them), and
    ``torch.uint32`` has no ``>>`` on the CPU, so the arithmetic runs in
    int64 on the low 32 bits: each product is taken mod 2**64 (int64
    multiplication wraps on the CPU and the GPU alike) and masked back
    to 32 bits, which is the uint32 product."""
    k = key.to(torch.int64) & _MASK32
    k = k ^ (k >> 16)
    k = (k * 0x7FEB352D) & _MASK32
    k = k ^ (k >> 15)
    k = (k * 0x846CA68B) & _MASK32
    return k ^ (k >> 16)


def mix32(key: torch.Tensor) -> torch.Tensor:
    """Murmur3-style finalizer on int32, two's complement result."""
    k = _mix_u32(key)
    return torch.where(k >= 1 << 31, k - (1 << 32), k).to(torch.int32)


def bucket_index(key: torch.Tensor, n_buckets: int) -> torch.Tensor:
    """``bucket_of`` as an int64 index tensor."""
    return _mix_u32(key) & (n_buckets - 1)


def bucket_of(key: torch.Tensor, n_buckets: int) -> torch.Tensor:
    return bucket_index(key, n_buckets).to(torch.int32)


def first_index(mask: torch.Tensor) -> torch.Tensor:
    """Index of the first True along the last axis (0 if none)."""
    return mask.to(torch.uint8).argmax(-1)


def argmin_first(x: torch.Tensor) -> torch.Tensor:
    """Index of the first minimum along the last axis."""
    return x.argmin(-1)


@functools.lru_cache(maxsize=None)
def arange(n: int, device: torch.device) -> torch.Tensor:
    """A cached ``torch.arange(n)``: read-only, never write into it."""
    return torch.arange(n, device=device)


def lanes_of(t: torch.Tensor) -> torch.Tensor:
    return arange(t.shape[0], t.device)


def probe(keys: torch.Tensor, key: torch.Tensor, n_buckets: int):
    """Find ``key`` in ``keys[B, n_buckets, ways]``.

    Returns (bucket, way, found) with way = index of the hit (or 0).
    """
    b = bucket_index(key, n_buckets)
    row = keys[lanes_of(keys), b]
    hit = row == key[:, None]
    return b, first_index(hit), hit.any(-1)


def choose_victim(keys_row: torch.Tensor, age_row: torch.Tensor
                  ) -> torch.Tensor:
    """Way to overwrite: first empty way, else the FIFO-oldest way."""
    empty = keys_row == EMPTY
    return torch.where(empty.any(-1), first_index(empty),
                       argmin_first(age_row))


def locate(keys: torch.Tensor, ages: torch.Tensor, key: torch.Tensor,
           n_buckets: int):
    """Branchless find-or-allocate: (bucket, way, found).

    ``way`` is the hit way when ``found``, else the victim way the caller
    should overwrite.
    """
    b = bucket_index(key, n_buckets)
    ar = lanes_of(keys)
    row = keys[ar, b]
    hit = row == key[:, None]
    found = hit.any(-1)
    victim = choose_victim(row, ages[ar, b])
    return b, torch.where(found, first_index(hit), victim), found
