"""Flash-decode of one query token per batch row over a paged KV cache.

Counterpart of ``repro/kernels/paged_decode.py`` (the Pallas
``paged_decode_kernel``): ``q`` (B, Hq, hd) attends over the pages that
row b's ``page_table`` (B, n_pages) picks out of the (NP, ps, Hkv, hd)
pools, positions ``>= lengths[b]`` masked. Query heads form contiguous
GQA groups of G = Hq / Hkv per kv head; scores are scaled by
``hd ** -0.5`` after the dot; the mask value is the finite ``NEG_INF``,
so a row with every position masked averages V uniformly (``-inf``
would give NaN). Pools may be float32 or bfloat16; the arithmetic is
float32 and the output has ``q``'s dtype.

* ``paged_decode_plain`` is plain PyTorch (gather, float32 einsum,
  mask, softmax), the CPU path and the card-side yardstick;
* ``paged_decode_kernel`` launches ``csrc/paged_decode.cu`` on CUDA
  tensors and raises on anything it does not take. It reads only the
  pages of the table, from pools that stay on the card.
"""

from __future__ import annotations

import ctypes

import torch

from . import backend

LIB = "paged_decode"
NEG_INF = -1e30
MAX_GROUP = 16          # query heads per kv head the kernel holds
MAX_HEAD_DIM = 256
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def paged_decode_plain(q: torch.Tensor, k_pool: torch.Tensor,
                       v_pool: torch.Tensor, page_table: torch.Tensor,
                       lengths: torch.Tensor) -> torch.Tensor:
    """(B, Hq, hd) x (NP, ps, Hkv, hd) pools -> (B, Hq, hd)."""
    b, hq, hd = q.shape
    _, ps, hkv, _ = k_pool.shape
    npg = page_table.shape[1]
    tab = page_table.long()
    k = k_pool[tab].reshape(b, npg * ps, hkv, hd).float()
    v = v_pool[tab].reshape(b, npg * ps, hkv, hd).float()
    qg = q.reshape(b, hkv, hq // hkv, hd).float()
    s = torch.einsum("bhgd,bshd->bhgs", qg, k) * hd ** -0.5
    pos = torch.arange(npg * ps, device=q.device)
    valid = pos[None] < lengths.to(q.device).long()[:, None]
    s = torch.where(valid[:, None, None], s, NEG_INF)
    o = torch.einsum("bhgs,bshd->bhgd", torch.softmax(s, -1), v)
    return o.reshape(b, hq, hd).to(q.dtype)


def paged_decode_kernel(q: torch.Tensor, k_pool: torch.Tensor,
                        v_pool: torch.Tensor, page_table: torch.Tensor,
                        lengths: torch.Tensor) -> torch.Tensor:
    """(B, Hq, hd) -> (B, Hq, hd), one launch over (kv head, batch row).

    CPU tensors take :func:`paged_decode_plain`; CUDA tensors launch the
    kernel or raise. ``page_table`` and ``lengths`` are int32 and every
    page id must lie in ``[0, NP)``.
    """
    if q.device.type == "cpu":
        return paged_decode_plain(q, k_pool, v_pool, page_table, lengths)
    b, hq, hd = q.shape
    n_pages_total, ps, hkv, _ = k_pool.shape
    npg = page_table.shape[1]
    dev = q.device
    if q.dtype not in _DTYPES or k_pool.dtype not in _DTYPES:
        raise TypeError(f"decode takes float32 or bfloat16, got q "
                        f"{q.dtype}, pools {k_pool.dtype}")
    if hq % hkv or hq // hkv > MAX_GROUP or hd > MAX_HEAD_DIM:
        raise ValueError(f"decode takes Hq a multiple of Hkv with at most "
                         f"{MAX_GROUP} query heads per kv head and hd <= "
                         f"{MAX_HEAD_DIM}; got Hq={hq}, Hkv={hkv}, hd={hd}")
    req = backend.require
    pool_shape = (n_pages_total, ps, hkv, hd)
    req(q, "q", q.dtype, (b, hq, hd), dev)
    req(k_pool, "k_pool", k_pool.dtype, pool_shape, dev)
    req(v_pool, "v_pool", k_pool.dtype, pool_shape, dev)
    req(page_table, "page_table", torch.int32, (b, npg), dev)
    req(lengths, "lengths", torch.int32, (b,), dev)
    if npg == 0:
        raise ValueError("decode needs at least one page per row")
    out = torch.empty_like(q)
    if b == 0:
        return out
    fn = backend.c_function(LIB, "mithril_paged_decode",
                            [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8
                            + [ctypes.c_float, ctypes.c_void_p])
    err = fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
             page_table.data_ptr(), lengths.data_ptr(), out.data_ptr(),
             _DTYPES[q.dtype], _DTYPES[k_pool.dtype], b, hq, hkv, hd, ps,
             npg, float(hd ** -0.5), backend.stream_of(q))
    backend.check_launch(err, "mithril_paged_decode")
    paged_decode_kernel.launches += 1
    return out


paged_decode_kernel.launches = 0
