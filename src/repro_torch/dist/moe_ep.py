"""Explicit expert-parallel MoE over ``torch.distributed`` collectives.

Two distributed layouts over the same routing math as
:func:`models.moe.moe_ffn` (a float64 router, a stable top-k):

* ``moe_ffn_tp`` — tokens stay data-sharded; expert weights are sharded
  over the "model" axis (``Shard(0)``). Every TP rank routes its whole
  local token set, computes ONLY its resident experts' FFNs (a choice of
  another rank's expert goes to a zero-weight drop bin), and a sum over
  the model sub-group combines: each (token, choice) is handled by
  exactly one rank. No token movement and no weight gathers: the
  serving layout ``models.lm`` selects under a sharding context.
* ``moe_ffn_ep`` — all-to-all expert parallelism: tokens are sharded
  over the expert axis too; each rank packs its tokens into
  per-destination-rank buffers, ``all_to_all_single`` exchanges them,
  resident experts run, and a second ``all_to_all_single`` returns the
  results for the gate-weighted combine at the source.

The collectives carry autograd (``torch.distributed.nn.functional``),
so a training step through either differentiates. Every layout adds a
token's rows by ascending expert (``models.moe.combine``), but TP sums
per-rank partial outputs over the ranks and EP runs the experts at its
own capacities (other product shapes, and at a small capacity factor
other dropped tokens), so the outputs agree with the dense path's
within the reference's tolerance (rtol = atol = 2e-2, at its capacity
factor 4.0), the router logits within 1e-5 and the expert choices
exactly.

Tokens come in as a DTensor (redistributed to ``Shard(0)`` over the data
axes, and also over the expert axis for EP) or as a plain tensor, the
same full value on every rank, of which each rank takes its slice; the
outputs come back in the same form. Both return ``(out, router_logits,
idx)`` exactly like ``moe_ffn`` and fall back to it when no context is
active or shapes do not divide.
"""

from __future__ import annotations

from typing import Callable, Sequence, Tuple

import torch

from ..models.moe import (capacity, combine, expert_ffn, group_tokens,
                          moe_ffn, router_logits, router_topk,
                          shared_expert)
from .ctx import current


def _flat_rank(mesh, axes: Sequence[str]) -> int:
    """This rank's index over ``axes`` of ``mesh``, the first axis
    major (the order a multi-axis spec entry nests them)."""
    r = 0
    for a in axes:
        r = r * mesh.size(mesh.mesh_dim_names.index(a)) \
            + mesh.get_local_rank(a)
    return r


def _placements(mesh, shard_axes: Sequence[str], dim: int = 0) -> list:
    from torch.distributed.tensor import Replicate, Shard
    return [Shard(dim) if a in shard_axes else Replicate()
            for a in mesh.mesh_dim_names]


def _tokens_in(x: torch.Tensor, mesh, axes: Sequence[str]
               ) -> Tuple[torch.Tensor, Callable]:
    """This rank's token rows, sharded over ``axes``, and the map that
    brings a per-rank result back in ``x``'s form (a DTensor sharded
    the same way, or the full tensor, gathered)."""
    from torch.distributed.tensor import DTensor
    pl = _placements(mesh, axes)
    if isinstance(x, DTensor):
        xs = x.redistribute(mesh, pl).to_local()
    else:
        n = 1
        for a in axes:
            n *= mesh.size(mesh.mesh_dim_names.index(a))
        t_loc = x.shape[0] // n
        r = _flat_rank(mesh, axes)
        xs = x[r * t_loc:(r + 1) * t_loc]

    def out(y: torch.Tensor) -> torch.Tensor:
        shape = (x.shape[0],) + tuple(y.shape[1:])
        dt = DTensor.from_local(y, mesh, pl, run_check=False, shape=shape,
                                stride=torch.empty(shape, device="meta")
                                .stride())
        return dt if isinstance(x, DTensor) else dt.full_tensor()
    return xs, out


def _full(w: torch.Tensor) -> torch.Tensor:
    from torch.distributed.tensor import DTensor
    return w.full_tensor() if isinstance(w, DTensor) else w


def _resident(w: torch.Tensor, mesh, axis: str, e_loc: int
              ) -> torch.Tensor:
    """This rank's ``e_loc`` experts of an (E, ...) weight sharded over
    ``axis`` (a DTensor redistributed to ``Shard(0)`` there)."""
    from torch.distributed.tensor import DTensor
    if isinstance(w, DTensor):
        return w.redistribute(mesh, _placements(mesh, (axis,))).to_local()
    e0 = mesh.get_local_rank(axis) * e_loc
    return w[e0:e0 + e_loc]


def _sum_over(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    from torch.distributed.nn.functional import all_reduce
    return all_reduce(x, group=mesh.get_group(axis))


def _exchange(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """``all_to_all_single`` over ``axis``: row block i goes to rank i."""
    from torch.distributed.nn.functional import all_to_all_single
    return all_to_all_single(torch.empty_like(x), x.contiguous(),
                             group=mesh.get_group(axis))


def _pack(rows: torch.Tensor, slot, keep, n_slots: int, fill=0):
    """``rows`` into ``n_slots`` slots (kept rows at ``slot``; the rest
    into one overflow row, dropped)."""
    buf = torch.full((n_slots + 1,) + tuple(rows.shape[1:]), fill,
                     dtype=rows.dtype, device=rows.device)
    buf[torch.where(keep, slot, n_slots)] = rows
    return buf[:-1]


# ---------------------------------------------------------------------------
# tensor-parallel experts (no token movement)
# ---------------------------------------------------------------------------

def _tp_body(router, w1, w3, w2, xs, *, e0: int, n_experts: int,
             top_k: int, cap_factor: float):
    t_loc, d = xs.shape
    logits = router_logits(xs, router)
    gates, idx = router_topk(logits, top_k)
    e_loc = w1.shape[0]
    # non-resident choices route to a zero-weight drop bin (expert e_loc)
    idx_loc = torch.where((idx >= e0) & (idx < e0 + e_loc), idx - e0,
                          e_loc)
    cap = capacity(t_loc, top_k, n_experts, cap_factor)
    slot, keep, token_id, order = group_tokens(idx_loc, e_loc + 1, cap)
    xe = _pack(xs[token_id], slot, keep, (e_loc + 1) * cap).reshape(
        e_loc + 1, cap, d)[:e_loc]
    ye = expert_ffn(xe, w1, w3, w2)
    # drop-bin slots read the appended zero rows: they add nothing
    ye = torch.cat([ye, ye.new_zeros((1, cap, d))])
    flat_gate = gates.reshape(-1)[order]
    y_tok = ye.reshape(-1, d)[torch.where(keep, slot, 0)]
    contrib = (torch.where(keep[:, None], y_tok, 0)
               * flat_gate[:, None].to(xs.dtype))
    return combine(contrib, order, idx), logits, idx


def moe_ffn_tp(p, x: torch.Tensor, *, n_experts: int, top_k: int,
               cap_factor: float = 1.25):
    """TP-MoE. x: (T, d) tokens. Same contract as ``moe_ffn``."""
    ctx = current()
    if ctx is None:
        return moe_ffn(p, x, n_experts=n_experts, top_k=top_k,
                       cap_factor=cap_factor)
    sizes = ctx.axis_sizes()
    tp, tp_size = ctx.tp_axis, sizes.get(ctx.tp_axis, 1)
    t = x.shape[0]
    if tp not in sizes or n_experts % tp_size or t % ctx.logical_sizes()[
            "dp"]:
        return moe_ffn(p, x, n_experts=n_experts, top_k=top_k,
                       cap_factor=cap_factor)
    mesh = ctx.mesh
    e_loc = n_experts // tp_size
    xs, back = _tokens_in(x, mesh, ctx.dp_axes)
    w1, w3, w2 = (_resident(p[n], mesh, tp, e_loc)
                  for n in ("w1", "w3", "w2"))
    out, logits, idx = _tp_body(
        _full(p["router"]), w1, w3, w2, xs,
        e0=mesh.get_local_rank(tp) * e_loc, n_experts=n_experts,
        top_k=top_k, cap_factor=cap_factor)
    out = back(_sum_over(out, mesh, tp))
    return out + shared_expert(p, x), back(logits), back(idx)


# ---------------------------------------------------------------------------
# all-to-all expert parallelism
# ---------------------------------------------------------------------------

def _ep_body(router, w1, w3, w2, xs, *, mesh, ep: str, n_shards: int,
             n_experts: int, top_k: int, cap_factor: float):
    t_loc, d = xs.shape
    e_loc = n_experts // n_shards
    logits = router_logits(xs, router)
    gates, idx = router_topk(logits, top_k)

    # --- pack per destination rank -------------------------------------
    dest = torch.div(idx, e_loc, rounding_mode="floor")      # (T_loc, K)
    c_send = capacity(t_loc, top_k, n_shards, cap_factor)
    slot, keep, token_id, order = group_tokens(dest, n_shards, c_send)
    n_slots = n_shards * c_send
    send_x = _pack(xs[token_id], slot, keep, n_slots)
    send_e = _pack(idx.reshape(-1)[order], slot, keep, n_slots, fill=-1)

    # --- exchange tokens -----------------------------------------------
    recv_x = _exchange(send_x, mesh, ep)
    recv_e = _exchange(send_e, mesh, ep)

    # --- resident expert compute ---------------------------------------
    e0 = mesh.get_local_rank(ep) * e_loc
    el = torch.where(recv_e >= 0, recv_e - e0, e_loc)   # invalid: drop bin
    c_loc = capacity(n_slots, 1, max(e_loc, 1), cap_factor)
    slot2, keep2, tid2, _ = group_tokens(el[:, None], e_loc + 1, c_loc)
    xe = _pack(recv_x[tid2], slot2, keep2, (e_loc + 1) * c_loc).reshape(
        e_loc + 1, c_loc, d)[:e_loc]
    ye = expert_ffn(xe, w1, w3, w2)
    ye = torch.cat([ye, ye.new_zeros((1, c_loc, d))])
    y_tok = ye.reshape(-1, d)[torch.where(keep2, slot2, 0)]
    y_flat = torch.zeros((n_slots, d), dtype=xs.dtype, device=xs.device)
    y_flat = y_flat.index_put((tid2,), torch.where(keep2[:, None], y_tok, 0))

    # --- return results and combine at the source ----------------------
    y_back = _exchange(y_flat, mesh, ep)
    flat_gate = gates.reshape(-1)[order]
    contrib = (torch.where(keep[:, None],
                           y_back[torch.where(keep, slot, 0)], 0)
               * flat_gate[:, None].to(xs.dtype))
    return combine(contrib, order, idx), logits, idx


def moe_ffn_ep(p, x: torch.Tensor, *, n_experts: int, top_k: int,
               cap_factor: float = 1.25):
    """All-to-all EP MoE: tokens AND experts sharded over the "model"
    axis (tokens also over the data axes). Same contract as moe_ffn;
    falls back to it off-mesh or when shapes do not divide."""
    ctx = current()
    if ctx is None:
        return moe_ffn(p, x, n_experts=n_experts, top_k=top_k,
                       cap_factor=cap_factor)
    sizes = ctx.axis_sizes()
    ep, n_shards = ctx.tp_axis, sizes.get(ctx.tp_axis, 1)
    t = x.shape[0]
    if (ep not in sizes or n_experts % n_shards
            or t % (ctx.logical_sizes()["dp"] * n_shards)):
        return moe_ffn(p, x, n_experts=n_experts, top_k=top_k,
                       cap_factor=cap_factor)
    mesh = ctx.mesh
    e_loc = n_experts // n_shards
    xs, back = _tokens_in(x, mesh, tuple(ctx.dp_axes) + (ep,))
    w1, w3, w2 = (_resident(p[n], mesh, ep, e_loc)
                  for n in ("w1", "w3", "w2"))
    out, logits, idx = _ep_body(
        _full(p["router"]), w1, w3, w2, xs, mesh=mesh, ep=ep,
        n_shards=n_shards, n_experts=n_experts, top_k=top_k,
        cap_factor=cap_factor)
    return (back(out) + shared_expert(p, x), back(logits), back(idx))
