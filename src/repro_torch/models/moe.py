"""Mixture-of-Experts FFN: top-k routing with fixed capacity (forward).

``moe_ffn`` is the reference's sort-based grouped dispatch: tokens are
sorted by expert (stably), packed into a fixed (E, C, d) buffer (a token
past an expert's capacity is dropped, like production dropping MoEs),
the expert FFNs run as batched products, and the results are weighted
by the gates and summed back per token. Routing covers plain top-k
(mixtral) and shared experts with a sigmoid gate (qwen2-moe).

Two choices keep routing the same on the CPU and the card:

* the router's product and softmax compute in float64 and round to
  float32, so the order of a library's float32 sum cannot move an
  expert choice (a tie in float32 is still a tie: equal logits stay
  equal), and ``top_k`` is a stable descending sort, lowest index first
  among equal scores, as ``jax.lax.top_k`` breaks ties;
* the combine adds each token's ``top_k`` weighted rows in bf16 one at
  a time, in the order the reference's scatter-add meets them (by
  expert), with no atomic adds.
"""

from __future__ import annotations

from typing import Optional

import torch

from .layers import sigmoid, silu, swiglu


def router_logits(x: torch.Tensor, router: torch.Tensor) -> torch.Tensor:
    """(T, d) tokens (bf16) times the (d, E) float32 router -> (T, E)
    float32, computed in float64 (the reference promotes to float32)."""
    return (x.double() @ router.double()).float()


def router_topk(logits: torch.Tensor, top_k: int, normalize: bool = True):
    """logits: (T, E) -> gates (T, K) fp32, idx (T, K) int32."""
    probs = torch.softmax(logits.double(), dim=-1)
    vals, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, idx = vals[:, :top_k], order[:, :top_k]
    if normalize:
        gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    return gates.float(), idx.to(torch.int32)


def capacity(n_tokens: int, top_k: int, n_experts: int,
             factor: float = 1.25, multiple: int = 8) -> int:
    c = int(n_tokens * top_k / n_experts * factor) + 1
    return max(multiple, ((c + multiple - 1) // multiple) * multiple)


def group_tokens(idx: torch.Tensor, n_experts: int, cap: int):
    """Sort-based grouping. idx: (T, K) expert choice per token-slot.

    Returns (slot, keep, token_id, order) each (T*K,): target slot in the
    packed (E*C) buffer, whether the slot fit under capacity, the source
    token, and the stable sort order of the flattened choices (int64, the
    index dtype; the reference's are int32).
    """
    t, k = idx.shape
    flat_e = idx.reshape(-1).long()
    order = torch.sort(flat_e, stable=True).indices      # (T*K,)
    sorted_e = flat_e[order]
    # bincount's values, with a shape known before the data (meta)
    counts = torch.zeros(n_experts, dtype=flat_e.dtype,
                         device=idx.device).scatter_add_(
        0, flat_e, torch.ones_like(flat_e))
    starts = torch.cumsum(counts, 0) - counts
    pos_in_e = torch.arange(t * k, device=idx.device) - starts[sorted_e]
    keep = pos_in_e < cap
    slot = sorted_e * cap + torch.clamp(pos_in_e, max=cap - 1)
    return slot, keep, order // k, order


def expert_ffn(xe: torch.Tensor, w1: torch.Tensor, w3: torch.Tensor,
               w2: torch.Tensor) -> torch.Tensor:
    """The experts' SwiGLU FFNs as batched products: xe (E, C, d)."""
    return torch.bmm(silu(torch.bmm(xe, w1)) * torch.bmm(xe, w3), w2)


def combine(contrib: torch.Tensor, order: torch.Tensor,
            idx: torch.Tensor) -> torch.Tensor:
    """Each token's ``top_k`` weighted rows (``contrib``, in the sorted
    order ``order`` of the flattened (T, K) choices ``idx``) added one
    at a time in the rows' dtype, by ascending expert, as the
    reference's scatter-add meets them in the dense path (and in this
    order in every layout, so a sharded combine adds alike)."""
    t, top_k = idx.shape
    rank = torch.empty_like(order)
    rank[order] = torch.arange(t * top_k, device=order.device)
    by_expert = torch.sort(idx.long(), dim=-1, stable=True).indices
    rows = torch.gather(rank.reshape(t, top_k), 1, by_expert)
    out = torch.zeros((t, contrib.shape[1]), dtype=contrib.dtype,
                      device=contrib.device)
    for j in range(top_k):
        out = out + contrib[rows[:, j]]
    return out


def shared_expert(p, x: torch.Tensor) -> torch.Tensor:
    """qwen2-moe's shared experts with a sigmoid gate (zeros when the
    model has none)."""
    if "shared_w1" not in p:
        return torch.zeros_like(x)
    shared = swiglu(x, p["shared_w1"], p["shared_w3"], p["shared_w2"])
    sg = sigmoid((x @ p["shared_gate"]).float())
    return shared * sg[:, None].to(x.dtype)


def moe_ffn(p, x: torch.Tensor, *, n_experts: int, top_k: int,
            cap_factor: float = 1.25,
            router_bias_mask: Optional[torch.Tensor] = None):
    """x: (T, d) flattened tokens. p: router/w1/w2/w3 (+shared).
    ``router_bias_mask`` (E,) is added to the router's logits (it masks
    expert-parallel padding experts).

    Returns (out (T, d), router_logits (T, E) fp32, idx (T, K)).
    """
    t, d = x.shape
    logits = router_logits(x, p["router"])
    if router_bias_mask is not None:
        logits = logits + router_bias_mask
    gates, idx = router_topk(logits, top_k)

    cap = capacity(t, top_k, n_experts, cap_factor)
    slot, keep, token_id, order = group_tokens(idx, n_experts, cap)

    # dispatch: tokens into (E*C [+1 overflow row], d)
    buf = torch.zeros((n_experts * cap + 1, d), dtype=x.dtype,
                      device=x.device)
    tgt = torch.where(keep, slot, n_experts * cap)
    buf[tgt] = x[token_id]
    xe = buf[:-1].reshape(n_experts, cap, d)

    ye = expert_ffn(xe, p["w1"], p["w3"], p["w2"])

    # combine: gather back, weight by the gate
    flat_gate = gates.reshape(-1)[order]
    y_tok = ye.reshape(-1, d)[torch.where(keep, slot, 0)]
    contrib = (torch.where(keep[:, None], y_tok, 0)
               * flat_gate[:, None].to(x.dtype))     # sorted order
    # each token's rows in sorted order (ascending expert)
    out = combine(contrib, order, idx)
    if "shared_w1" in p:
        out = out + shared_expert(p, x)
    return out, logits, idx


def aux_load_balance_loss(logits: torch.Tensor, idx: torch.Tensor,
                          n_experts: int) -> torch.Tensor:
    """Switch-style load-balancing auxiliary loss (fp32)."""
    probs = torch.softmax(logits.float(), -1)
    me = probs.mean(0)
    onehot = torch.nn.functional.one_hot(idx[:, 0].long(),
                                         n_experts).float()
    ce = onehot.mean(0)
    return n_experts * torch.sum(me * ce)
