"""Batched set-associative prefetch-table probe.

Counterpart of ``repro/kernels/hash_lookup.py`` (the Pallas
``hash_lookup_kernel``). Each query is hashed with ``mix32`` to a
bucket of the (NB, W) key table; the first way whose key equals the
query picks its P values from the (NB, W, P) value table, and a query
with no hit gets P times EMPTY. A query equal to EMPTY matches an empty
way and returns that way's values, whatever they hold, as the reference
does.

* ``hash_lookup_plain`` is plain PyTorch (the CPU path and the
  card-side yardstick);
* ``hash_lookup_kernel`` launches ``csrc/hash_lookup.cu`` on CUDA
  tensors and raises on anything it does not take. It takes any Q: the
  Pallas grid's padding of the queries to a block multiple has no
  counterpart here.
"""

from __future__ import annotations

import ctypes

import torch

from ..core.hashindex import EMPTY, bucket_index, first_index
from . import backend

LIB = "hash_lookup"


def hash_lookup_plain(queries: torch.Tensor, pf_key: torch.Tensor,
                      pf_vals: torch.Tensor) -> torch.Tensor:
    """(Q,) x (NB, W) x (NB, W, P) -> (Q, P) int32 candidates."""
    b = bucket_index(queries, pf_key.shape[0])
    hit = pf_key[b] == queries[:, None]
    picked = pf_vals[b, first_index(hit)]
    return torch.where(hit.any(-1)[:, None], picked, EMPTY).to(torch.int32)


def hash_lookup_kernel(queries: torch.Tensor, pf_key: torch.Tensor,
                       pf_vals: torch.Tensor) -> torch.Tensor:
    """(Q,) -> (Q, P) prefetch candidates (EMPTY = none).

    CPU tensors take :func:`hash_lookup_plain`; CUDA tensors launch the
    kernel (one thread per query) or raise.
    """
    if queries.device.type == "cpu":
        return hash_lookup_plain(queries, pf_key, pf_vals)
    nb, ways = pf_key.shape
    plist = pf_vals.shape[-1]
    dev = queries.device
    if nb & (nb - 1):
        raise ValueError(f"the bucket count must be a power of two, got {nb}")
    req = backend.require
    i32 = torch.int32
    req(queries, "queries", i32, (queries.shape[0],), dev)
    req(pf_key, "pf_key", i32, (nb, ways), dev)
    req(pf_vals, "pf_vals", i32, (nb, ways, plist), dev)
    n_q = queries.shape[0]
    out = torch.empty((n_q, plist), dtype=i32, device=dev)
    if n_q == 0:
        return out
    fn = backend.c_function(LIB, "mithril_hash_lookup",
                            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
                            + [ctypes.c_void_p])
    err = fn(queries.data_ptr(), pf_key.data_ptr(), pf_vals.data_ptr(),
             out.data_ptr(), n_q, nb, ways, plist, backend.stream_of(out))
    backend.check_launch(err, "mithril_hash_lookup")
    hash_lookup_kernel.launches += 1
    return out


hash_lookup_kernel.launches = 0
