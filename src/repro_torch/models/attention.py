"""Attention: blockwise flash (prefill, the full-sequence forward and its
backward) and cached decode, GQA and sliding-window aware.

The flash path keeps the reference's structure: an outer loop over
query blocks, grouped into lanes as the reference groups them, and an
inner loop over key/value blocks whose bounds skip the causal and
sliding-window tiles that would be fully masked, with a running max and
sum in float32. Scores and the value product compute in float32 from
the operands as given (a bf16 product is exact in float32, as the
reference's ``preferred_element_type=float32`` is); the output is
rounded to ``q``'s dtype.

The backward is the reference's custom VJP: the forward keeps ``(q, k,
v, out, lse)`` and the backward walks the same lanes and tiles (the
same skipping), recomputing each tile's probabilities from ``lse`` in
float32 and accumulating dk and dv block by block. The forward of a
pass that records autograd runs as the operator ``repro_torch::
flash_fwd``, so that a selective-checkpoint policy can keep its output
(``models.lm``'s ``remat="attn_out"``).
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch.overrides import handle_torch_function, has_torch_function

NEG_INF = -1e30


def _tile_scores(q, k, scale):
    """q: (B, L, qb, Hkv, G, hd); k: (B, kb, Hkv, hd)
    -> (B, L, Hkv, G, qb, kb) fp32. L = q-block lanes."""
    return torch.einsum("blqhgd,bkhd->blhgqk", q.float(), k.float()) * scale


def _tile_mask(q_pos, k_pos, causal, window):
    """q_pos: (L, qb); k_pos: (kb,) -> (L, qb, kb) bool."""
    mask = torch.ones(q_pos.shape + k_pos.shape, dtype=torch.bool,
                      device=q_pos.device)
    if causal:
        mask &= q_pos[..., None] >= k_pos[None, None, :]
    if window:
        mask &= q_pos[..., None] - k_pos[None, None, :] < window
    return mask


def kv_tile_update(carry, q, k, v, q_pos, k_pos, scale, causal, window):
    """One flash tile step over all lanes: update (m, l, acc).

    q: (B, L, qb, Hkv, G, hd); carry fp32: m/l (B, L, Hkv, G, qb),
    acc (B, L, Hkv, G, qb, hd).
    """
    m, l, acc = carry
    s = _tile_scores(q, k, scale)                      # (B,L,Hkv,G,qb,kb)
    mask = _tile_mask(q_pos, k_pos, causal, window)    # (L,qb,kb)
    s = torch.where(mask[None, :, None, None], s, NEG_INF)
    m_new = torch.maximum(m, s.amax(-1))
    p = torch.exp(s - m_new[..., None])
    corr = torch.exp(m - m_new)
    l_new = l * corr + p.sum(-1)
    pv = torch.einsum("blhgqk,bkhd->blhgqd", p, v.float())
    acc_new = acc * corr[..., None] + pv
    return m_new, l_new, acc_new


def _factor_blocks(n_q: int, shards: int = 16):
    """Factor the q-block axis into (lanes, outer): lane l owns the
    contiguous blocks [l*outer, (l+1)*outer), as in the reference."""
    lanes = 1
    for cand in range(min(shards, n_q), 0, -1):
        if n_q % cand == 0 and shards % cand == 0:
            lanes = cand
            break
    return lanes, n_q // lanes


def _lane_bounds(blk_lo, blk_hi, *, q_offset, block_q, block_k, n_k,
                 causal, window):
    """kv-block range [lo, hi) covering q blocks blk_lo..blk_hi (incl)."""
    hi, lo = n_k, 0
    if causal:
        hi = min((q_offset + (blk_hi + 1) * block_q + block_k - 1)
                 // block_k, n_k)
    if window:
        lo = max((q_offset + blk_lo * block_q - window) // block_k, 0)
    return lo, hi


def _flash_fwd(q, k, v, causal, window, q_offset, block_q, block_k):
    """Returns (out (B, Sq, Hq, hd) in q's dtype, lse (B, Hkv, G, Sq)
    float32)."""
    b, sq, hq, hd = q.shape
    _, skv, hkv, _ = k.shape
    g = hq // hkv
    scale = hd ** -0.5
    n_q, n_k = sq // block_q, skv // block_k
    lanes, n_outer = _factor_blocks(n_q)
    # lane-major layout: lane l holds blocks l*n_outer + o
    qb = q.reshape(b, lanes, n_outer, block_q, hkv, g, hd)
    lane_ids = torch.arange(lanes, device=q.device)
    outs, lses = [], []
    for oi in range(n_outer):
        q_tile = qb[:, :, oi]                          # (b,L,bq,hkv,g,hd)
        blk = lane_ids * n_outer + oi                  # (L,)
        q_pos = (q_offset + blk[:, None] * block_q
                 + torch.arange(block_q, device=q.device)[None])  # (L,bq)
        lo, hi = _lane_bounds(oi, (lanes - 1) * n_outer + oi,
                              q_offset=q_offset, block_q=block_q,
                              block_k=block_k, n_k=n_k, causal=causal,
                              window=window)
        m = torch.full((b, lanes, hkv, g, block_q), NEG_INF,
                       dtype=torch.float32, device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros((b, lanes, hkv, g, block_q, hd),
                          dtype=torch.float32, device=q.device)
        for ki in range(lo, hi):
            sl = slice(ki * block_k, (ki + 1) * block_k)
            k_pos = torch.arange(ki * block_k, (ki + 1) * block_k,
                                 device=q.device)
            m, l, acc = kv_tile_update((m, l, acc), q_tile, k[:, sl],
                                       v[:, sl], q_pos, k_pos, scale,
                                       causal, window)
        l = torch.clamp(l, min=1e-30)
        outs.append((acc / l[..., None]).to(q.dtype))  # (b,L,hkv,g,bq,hd)
        lses.append(m + torch.log(l))                  # (b,L,hkv,g,bq)
    # (n_outer, b, L, hkv, g, bq, hd) -> (b, sq, hq, hd)
    out = torch.stack(outs).permute(1, 2, 0, 5, 3, 4, 6)
    # (n_outer, b, L, hkv, g, bq) -> (b, hkv, g, sq)
    lse = torch.stack(lses).permute(1, 3, 4, 2, 0, 5)
    return out.reshape(b, sq, hq, hd), lse.reshape(b, hkv, g, sq)


def _flash_bwd_impl(q, k, v, out, lse, dout, causal, window, q_offset,
                    block_q, block_k):
    """Blockwise flash backward: the forward's lanes and tile bounds,
    float32 tiles, dk and dv accumulated block by block. Returns (dq,
    dk, dv) in the dtypes of q, k, v."""
    b, sq, hq, hd = q.shape
    _, skv, hkv, _ = k.shape
    g = hq // hkv
    scale = hd ** -0.5
    n_q, n_k = sq // block_q, skv // block_k
    lanes, n_outer = _factor_blocks(n_q)
    qb = q.reshape(b, lanes, n_outer, block_q, hkv, g, hd)
    dob = dout.reshape(b, lanes, n_outer, block_q, hkv, g, hd)
    ob = out.reshape(b, lanes, n_outer, block_q, hkv, g, hd)
    lseb = lse.reshape(b, hkv, g, lanes, n_outer, block_q)
    lane_ids = torch.arange(lanes, device=q.device)
    dk = torch.zeros((b, skv, hkv, hd), dtype=torch.float32, device=q.device)
    dv = torch.zeros_like(dk)
    dqs = []
    for oi in range(n_outer):
        q_tile = qb[:, :, oi]                                # (b,L,bq,h,g,d)
        do_t = dob[:, :, oi].float().permute(0, 1, 3, 4, 2, 5)
        o_t = ob[:, :, oi].float().permute(0, 1, 3, 4, 2, 5)  # (b,L,h,g,q,d)
        lse_t = lseb[:, :, :, :, oi].permute(0, 3, 1, 2, 4)   # (b,L,h,g,q)
        d_t = torch.sum(do_t * o_t, dim=-1)
        blk = lane_ids * n_outer + oi
        q_pos = (q_offset + blk[:, None] * block_q
                 + torch.arange(block_q, device=q.device)[None])  # (L,bq)
        lo, hi = _lane_bounds(oi, (lanes - 1) * n_outer + oi,
                              q_offset=q_offset, block_q=block_q,
                              block_k=block_k, n_k=n_k, causal=causal,
                              window=window)
        dq_t = torch.zeros((b, lanes, hkv, g, block_q, hd),
                           dtype=torch.float32, device=q.device)
        for ki in range(lo, hi):
            sl = slice(ki * block_k, (ki + 1) * block_k)
            k_tile, v_tile = k[:, sl], v[:, sl]
            k_pos = torch.arange(ki * block_k, (ki + 1) * block_k,
                                 device=q.device)
            s = _tile_scores(q_tile, k_tile, scale)   # (b,L,hkv,g,bq,bk)
            mask = _tile_mask(q_pos, k_pos, causal, window)
            s = torch.where(mask[None, :, None, None], s, NEG_INF)
            p = torch.exp(s - lse_t[..., None])
            dv_blk = torch.einsum("blhgqk,blhgqd->bkhd", p, do_t)
            dp = torch.einsum("blhgqd,bkhd->blhgqk", do_t, v_tile.float())
            ds = p * (dp - d_t[..., None]) * scale
            dq_t = dq_t + torch.einsum("blhgqk,bkhd->blhgqd", ds,
                                       k_tile.float())
            dk_blk = torch.einsum("blhgqk,blqhgd->bkhd", ds, q_tile.float())
            dk[:, sl] += dk_blk
            dv[:, sl] += dv_blk
        dqs.append(dq_t)
    # (n_outer, b, L, hkv, g, bq, hd) -> (b, sq, hq, hd)
    dq = torch.stack(dqs).permute(1, 2, 0, 5, 3, 4, 6).reshape(b, sq, hq, hd)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


@torch.library.custom_op("repro_torch::flash_fwd", mutates_args=())
def flash_fwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 causal: bool, window: int, q_offset: int, block_q: int,
                 block_k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`_flash_fwd` as one operator (what a selective-checkpoint
    policy sees and can keep)."""
    return _flash_fwd(q, k, v, causal, window, q_offset, block_q, block_k)


@flash_fwd_op.register_fake
def _flash_fwd_fake(q, k, v, causal, window, q_offset, block_q, block_k):
    """Shapes of the operator's outputs (``meta`` tensors, the dry run)."""
    b, sq, hq, hd = q.shape
    hkv = k.shape[2]
    return (q.new_empty((b, sq, hq, hd)),
            q.new_empty((b, hkv, hq // hkv, sq), dtype=torch.float32))


class FlashAttention(torch.autograd.Function):
    """The flash forward, keeping ``(q, k, v, out, lse)``, and the
    blockwise backward (the reference's ``_flash`` custom VJP)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset, block_q, block_k):
        out, lse = flash_fwd_op(q, k, v, causal, window, q_offset, block_q,
                                block_k)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.plan = (causal, window, q_offset, block_q, block_k)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _flash_bwd_impl(q, k, v, out, lse, dout, *ctx.plan)
        return dq, dk, dv, None, None, None, None, None


def _pick_block(s: int, target: int) -> int:
    """Largest divisor of ``s`` that is <= target."""
    t = max(1, min(target, s))
    while s % t:
        t -= 1
    return t


def block_plan(sq: int, skv: int, block_q: int = 512, block_k: int = 512,
               shards: int = 16):
    """(block_q, block_k) used by flash_attention: q blocks sized so the
    number of q blocks is a multiple of ``shards`` when possible."""
    bq = _pick_block(sq, min(block_q, max(sq // shards, 128)))
    bk = _pick_block(skv, block_k)
    return bq, bk


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    q_offset: int = 0, block_q: int = 512,
                    block_k: int = 512) -> torch.Tensor:
    """q: (B, Sq, Hq, hd); k,v: (B, Skv, Hkv, hd) -> (B, Sq, Hq, hd).

    Blockwise flash with causal and sliding-window tile skipping in the
    forward and, when autograd records (:class:`FlashAttention`), in the
    backward. ``q_offset``: absolute position of q[0]. Overridable by
    ``__torch_function__`` (a mesh runs it shard by shard).
    """
    if has_torch_function((q, k, v)):
        return handle_torch_function(
            flash_attention, (q, k, v), q, k, v, causal=causal,
            window=window, q_offset=q_offset, block_q=block_q,
            block_k=block_k)
    block_q, block_k = block_plan(q.shape[1], k.shape[1], block_q, block_k)
    plan = (causal, window, q_offset, block_q, block_k)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttention.apply(q, k, v, *plan)
    return _flash_fwd(q, k, v, *plan)[0]


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, lengths: torch.Tensor, *,
                     window: int = 0) -> torch.Tensor:
    """Single-token decode. q: (B, 1, Hq, hd); caches: (B, S, Hkv, hd);
    lengths: (B,) number of valid cache positions (ring-buffer aware for
    SWA); ``window`` also masks positions before ``lengths - window``."""
    b, s, hkv, hd = k_cache.shape
    hq = q.shape[2]
    g = hq // hkv
    scale = hd ** -0.5
    qg = q.reshape(b, hkv, g, hd)
    scores = torch.einsum("bhgd,bshd->bhgs", qg.float(),
                          k_cache.float()) * scale
    pos = torch.arange(s, device=q.device)[None, :]
    valid = pos < lengths[:, None]
    if window:
        valid &= pos >= (lengths[:, None] - window)
    scores = torch.where(valid[:, None, None, :], scores, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgs,bshd->bhgd", p, v_cache.float())
    return out.reshape(b, 1, hq, hd).to(q.dtype)


def full_attention(q, k, v, *, causal=True, window=0, q_offset=0):
    """Quadratic attention (tests only: materializes S^2)."""
    b, sq, hq, hd = q.shape
    _, skv, hkv, _ = k.shape
    g = hq // hkv
    scale = hd ** -0.5
    qg = q.reshape(b, sq, hkv, g, hd)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float()) * scale
    q_pos = q_offset + torch.arange(sq, device=q.device)
    k_pos = torch.arange(skv, device=q.device)
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= q_pos[:, None] >= k_pos[None, :]
    if window:
        mask &= q_pos[:, None] - k_pos[None, :] < window
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return out.reshape(b, sq, hq, hd).to(q.dtype)
