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
  tensors and raises on anything it does not take. The kernel splits
  each row's pages over blocks (:func:`split_plan`), reads only the
  pages a row's length reaches, and a second launch merges the splits;
* ``paged_decode_partials_plain`` and ``merge_partials_plain`` are that
  split and merge in plain PyTorch, for the tests.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import backend

LIB = "paged_decode"
NEG_INF = -1e30
MAX_GROUP = 16          # query heads per kv head the kernel holds
MAX_HEAD_DIM = 256
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the split plan: blocks it aims for per SM, the fewest positions worth
# a block of their own, the most page ids a block keeps in shared
# memory, and the most splits the merge weighs in shared memory
SPLIT_BLOCKS_PER_SM = 4
MIN_SPLIT_TOKENS = 64
MAX_PAGES_PER_SPLIT = 1024
MAX_SPLITS = 6144


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


def split_plan(b: int, hkv: int, npg: int, ps: int,
               n_sm: int) -> Tuple[int, int]:
    """``(pages_per_split, n_splits)`` for B rows of ``npg`` pages of
    ``ps`` positions over ``hkv`` kv heads on a card of ``n_sm`` SMs.

    A function of the shapes alone (never of ``lengths``, which lies on
    the card): about ``SPLIT_BLOCKS_PER_SM`` blocks a SM, at least
    ``MIN_SPLIT_TOKENS`` positions a split, at most
    ``MAX_PAGES_PER_SPLIT`` pages and ``MAX_SPLITS`` splits."""
    args = (b, hkv, npg, ps, n_sm)
    if not all(isinstance(v, int) and not isinstance(v, bool)
               for v in args):
        raise TypeError(f"split_plan takes ints, got {args}")
    if min(args) < 1:
        raise ValueError(f"split_plan takes positive shapes, got {args}")
    want = -(-SPLIT_BLOCKS_PER_SM * n_sm // (b * hkv))
    pps = max(-(-npg // want), -(-MIN_SPLIT_TOKENS // ps))
    pps = min(pps, npg, MAX_PAGES_PER_SPLIT)
    if -(-npg // pps) > MAX_SPLITS:
        raise ValueError(f"{npg} pages need more than {MAX_SPLITS} splits "
                         f"of {MAX_PAGES_PER_SPLIT} pages")
    return pps, -(-npg // pps)


def paged_decode_partials_plain(q: torch.Tensor, k_pool: torch.Tensor,
                                v_pool: torch.Tensor,
                                page_table: torch.Tensor,
                                lengths: torch.Tensor, pages_per_split: int
                                ) -> Tuple[torch.Tensor, torch.Tensor,
                                           torch.Tensor]:
    """The split kernel's float32 partials: m, l (B, Hkv, S, G) and the
    unnormalised acc (B, Hkv, S, G, hd) of each split of
    ``pages_per_split`` pages. A row with ``length >= 1`` sees only its
    positions below ``length``, so a split wholly past it is the empty
    partial (m = NEG_INF, l = 0, acc = 0); a row with ``length <= 0``
    sees every position, each scored ``NEG_INF``."""
    b, hq, hd = q.shape
    _, ps, hkv, _ = k_pool.shape
    npg = page_table.shape[1]
    g = hq // hkv
    n_splits = -(-npg // pages_per_split)
    span = pages_per_split * ps
    pad = n_splits * span - npg * ps
    tab = page_table.long()
    k = k_pool[tab].reshape(b, npg * ps, hkv, hd).float()
    v = v_pool[tab].reshape(b, npg * ps, hkv, hd).float()
    qg = q.reshape(b, hkv, g, hd).float()
    s = torch.einsum("bhgd,bshd->bhgs", qg, k) * hd ** -0.5
    lens = lengths.to(q.device).long()
    masked = lens <= 0
    s = torch.where(masked[:, None, None, None], NEG_INF, s)
    seen = (torch.arange(npg * ps, device=q.device)[None] < lens[:, None]
            ) | masked[:, None]                                  # (B, P)
    s = torch.nn.functional.pad(s, (0, pad)).reshape(
        b, hkv, g, n_splits, span)
    seen = torch.nn.functional.pad(seen, (0, pad)).reshape(
        b, 1, 1, n_splits, span)
    v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad)).reshape(
        b, n_splits, span, hkv, hd)
    m = torch.where(seen, s, -torch.inf).amax(-1).clamp(min=NEG_INF)
    p = torch.where(seen, torch.exp(s - m[..., None]), 0.0)
    acc = torch.einsum("bhgcs,bcshd->bhcgd", p, v)
    return m.transpose(2, 3), p.sum(-1).transpose(2, 3), acc


def merge_partials_plain(m: torch.Tensor, l: torch.Tensor,
                         acc: torch.Tensor,
                         dtype: torch.dtype) -> torch.Tensor:
    """The merge kernel: (B, Hkv, S, G[, hd]) partials -> (B, Hq, hd),
    splits taken in order 0, 1, ...; an empty split (l = 0) weighs 0."""
    b, hkv, n_splits, g, hd = acc.shape
    live = l > 0
    mx = torch.where(live, m, -torch.inf).amax(2).clamp(min=NEG_INF)
    den = torch.zeros_like(mx)
    num = torch.zeros((b, hkv, g, hd), dtype=torch.float32,
                      device=acc.device)
    for s in range(n_splits):
        w = torch.where(live[:, :, s], torch.exp(m[:, :, s] - mx), 0.0)
        den = den + w * l[:, :, s]
        num = num + w[..., None] * acc[:, :, s]
    out = num / den.clamp(min=1e-30)[..., None]
    return out.reshape(b, hkv * g, hd).to(dtype)


def paged_decode_kernel(q: torch.Tensor, k_pool: torch.Tensor,
                        v_pool: torch.Tensor, page_table: torch.Tensor,
                        lengths: torch.Tensor,
                        pages_per_split: Optional[int] = None
                        ) -> torch.Tensor:
    """(B, Hq, hd) -> (B, Hq, hd): the split kernel over (split, kv head,
    batch row), then, when the plan has more than one split, the merge.

    CPU tensors take :func:`paged_decode_plain`; CUDA tensors launch the
    kernels or raise. ``page_table`` and ``lengths`` are int32 and every
    page id must lie in ``[0, NP)``; a pool row (hd elements) must be a
    multiple of 16 bytes and the pools 16-byte aligned. The plan is
    :func:`split_plan`'s unless ``pages_per_split`` is given.
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
    if hd * k_pool.element_size() % 16:
        raise ValueError(f"decode copies pool rows 16 bytes at a time; a "
                         f"row of hd={hd} {k_pool.dtype} is "
                         f"{hd * k_pool.element_size()} bytes")
    if k_pool.data_ptr() % 16 or v_pool.data_ptr() % 16:
        raise ValueError("decode needs 16-byte aligned pools")
    out = torch.empty_like(q)
    if b == 0:
        return out
    if pages_per_split is None:
        pps, n_splits = split_plan(b, hkv, npg, ps, backend.sm_count(dev))
    elif 1 <= pages_per_split <= MAX_PAGES_PER_SPLIT and \
            -(-npg // pages_per_split) <= MAX_SPLITS:
        pps = min(int(pages_per_split), npg)
        n_splits = -(-npg // pps)
    else:
        raise ValueError(f"pages_per_split must lie in [1, "
                         f"{MAX_PAGES_PER_SPLIT}] and give at most "
                         f"{MAX_SPLITS} splits, got {pages_per_split}")
    part = (torch.empty(b * hkv * n_splits * (hq // hkv) * (hd + 2),
                        dtype=torch.float32, device=dev)
            if n_splits > 1 else None)
    stream = backend.stream_of(q)
    fn = backend.c_function(LIB, "mithril_paged_decode",
                            [ctypes.c_void_p] * 7 + [ctypes.c_int] * 10
                            + [ctypes.c_float, ctypes.c_void_p])
    err = fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
             page_table.data_ptr(), lengths.data_ptr(), out.data_ptr(),
             None if part is None else part.data_ptr(), _DTYPES[q.dtype],
             _DTYPES[k_pool.dtype], b, hq, hkv, hd, ps, npg, pps, n_splits,
             float(hd ** -0.5), stream)
    backend.check_launch(err, "mithril_paged_decode")
    paged_decode_kernel.launches += 1
    if part is not None:
        merge = backend.c_function(LIB, "mithril_paged_decode_merge",
                                   [ctypes.c_void_p] * 2
                                   + [ctypes.c_int] * 6 + [ctypes.c_void_p])
        err = merge(part.data_ptr(), out.data_ptr(), _DTYPES[q.dtype], b, hq,
                    hkv, hd, n_splits, stream)
        backend.check_launch(err, "mithril_paged_decode_merge")
        paged_decode_kernel.merge_launches += 1
    return out


def decode_smem_bytes(hq: int, hkv: int, hd: int, kv_dtype: torch.dtype,
                      pages_per_split: int) -> int:
    """Dynamic shared memory of one split block, as the launch sizes it."""
    fn = backend.c_function(LIB, "mithril_paged_decode_smem",
                            [ctypes.c_int] * 5, ctypes.c_longlong)
    return int(fn(hq, hkv, hd, _DTYPES[kv_dtype], pages_per_split))


paged_decode_kernel.launches = 0
paged_decode_kernel.merge_launches = 0
