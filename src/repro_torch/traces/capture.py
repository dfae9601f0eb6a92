"""Capture real access streams from model execution for MITHRIL mining.

The paper mines block-I/O streams; the serving adaptation mines whatever
stream the tiered resource produces. Two capturers:

* ``capture_expert_trace`` — run a (reduced) MoE model's routers over
  token batches and record the top-k expert choices per layer as a
  stream of (layer, expert) "block ids". Multi-tenant inference
  interleaves these streams like the paper's multi-application block
  traces; a MITHRIL layer in front of an expert-weight cache (offloaded
  experts) prefetches co-activated experts.
* ``capture_page_trace`` — synthesize the KV-page access stream of a
  multi-tenant paged decode schedule (request -> its pages), the input
  to ``cache/tiered.py`` (numpy only, a copy of the reference's).
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..models.lm import CausalLM, MoE, layer_groups, layer_slots
from ..models.moe import router_logits, router_topk


def expert_block_id(layer: int, expert: int, n_experts: int) -> int:
    return layer * n_experts + expert


def unrouted_layers(cfg: ModelConfig, reps: int) -> int:
    """The layers that ``capture_expert_trace`` counts for a unit without
    a router: the reference adds the unit's ``ln1.shape[0]``, its
    repeats, and 1 where ``ln1`` has no shape (the encoder-decoder's
    ``{"s", "b"}`` norms)."""
    return 1 if cfg.is_encoder_decoder else reps


def capture_expert_trace(cfg: ModelConfig, model: CausalLM, token_batches,
                         interleave: int = 4, seed: int = 0) -> np.ndarray:
    """Run the model's routers over batches; emit the expert access stream.

    ``interleave`` emulates multi-tenant serving: the per-batch streams
    are round-robin interleaved (the sporadic-association regime). Only
    the router products run, on the embeddings of the tokens, with the
    real per-layer router weights, on the model's device.
    """
    dev = model.embed.device
    slots = layer_slots(cfg)
    streams: List[List[int]] = []
    for tokens in token_batches:
        tokens = torch.as_tensor(np.asarray(tokens), device=dev)
        x = model.embed[tokens.long()]                  # (B, S, d)
        flat = x.reshape(-1, x.shape[-1])
        stream: List[int] = []
        layer = 0
        for gi, (unit, reps) in enumerate(layer_groups(cfg)):
            for j in range(len(unit)):
                blocks = [blk for blk, (g, u, _, _) in zip(model.layers, slots)
                          if (g, u) == (gi, j)]
                if not isinstance(getattr(blocks[0], "mlp", None), MoE):
                    layer += unrouted_layers(cfg, reps)
                    continue
                idx = torch.stack([router_topk(router_logits(
                    flat, blk.mlp.router), cfg.top_k)[1] for blk in blocks])
                idx = idx.cpu().numpy()                 # (reps, T, K)
                step = max(1, idx.shape[1] // 64)
                for r in range(reps):
                    for row in idx[r][::step]:
                        for e in row:
                            stream.append(expert_block_id(
                                layer + r, int(e), cfg.n_experts))
                layer += reps
        streams.append(stream)

    rng = np.random.default_rng(seed)
    cursors = [0] * len(streams)
    out: List[int] = []
    while any(c < len(s) for c, s in zip(cursors, streams)):
        si = int(rng.integers(len(streams)))
        c = cursors[si]
        if c < len(streams[si]):
            out.extend(streams[si][c: c + interleave])
            cursors[si] = c + interleave
    return np.asarray(out, np.int32)


def capture_page_trace(n_requests: int, pages_per_req: int, rounds: int,
                       n_pages: int, seed: int = 0) -> np.ndarray:
    """KV-page access stream of a randomized multi-tenant decode schedule."""
    rng = np.random.default_rng(seed)
    reqs = [rng.choice(n_pages, pages_per_req, replace=False)
            for _ in range(n_requests)]
    out: List[int] = []
    for _ in range(rounds):
        for r in rng.permutation(n_requests):
            out.extend(int(p) for p in reqs[r])
    return np.asarray(out, np.int32)
