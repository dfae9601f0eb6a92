"""Causal language model for the attention families (forward only).

One module, ``CausalLM(cfg)``, with one submodule per layer, and plain
functions under the reference's names:

    init_params(cfg, generator, device=None)      -> model
    forward(cfg, model, batch)                    -> logits (B, S, V) fp32
    forward_train(cfg, model, batch)              -> (loss, metrics)
    prefill(cfg, model, batch, pad_to=0)          -> (last_logits, cache)
    decode_step(cfg, model, cache, token, pos)    -> (logits, cache)

Block kinds "attn" (full or sliding-window GQA) and "local" (sliding
window), each with a dense SwiGLU FFN or, when ``cfg.n_experts > 0``,
the MoE FFN (``models.moe.moe_ffn``; there is no mesh, so no other MoE
path). Parameters are the reference's, in its layouts ((d, out)
products, bf16, the MoE router float32); ``convert.lm_params_from``
carries a reference pytree across. The RG-LRU and RWKV6 blocks and the
whisper encoder-decoder are not ported yet: building such a model
raises ``NotImplementedError``.

The KV cache has the reference's layout: a list with one entry per
layer group (``layer_groups``), ``{"u<j>": {"k", "v"}}`` with a leading
axis over the group's repeats, each (reps, B, S_c, Hkv, hd) bf16.
``decode_step`` writes the new key and value into the cache's ring slot
``pos % S_c`` in place and returns the same cache.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple, Union

import torch
from torch import nn

from ..configs.base import ModelConfig
from .attention import decode_attention, flash_attention
from .layers import dense_init, rms_norm, rope, swiglu
from .moe import aux_load_balance_loss, moe_ffn

Device = Optional[Union[str, torch.device]]
ATTN_KINDS = ("attn", "local")
NOT_PORTED = ("is not ported yet (ROADMAP Queue 1 item 10, the remaining "
              "families)")


# ---------------------------------------------------------------------------
# structure
# ---------------------------------------------------------------------------

def layer_groups(cfg: ModelConfig) -> List[Tuple[Tuple[str, ...], int]]:
    """[(unit_pattern, repeats)]: the reference's scan units over
    ``cfg.pattern``."""
    pat = cfg.pattern
    if len(set(pat)) == 1:
        return [((pat[0],), len(pat))]
    period = len(cfg.layer_pattern)
    n_full = len(pat) // period
    groups: List[Tuple[Tuple[str, ...], int]] = []
    if n_full:
        groups.append((tuple(cfg.layer_pattern), n_full))
    rem = pat[n_full * period:]
    if rem:
        groups.append((tuple(rem), 1))
    return groups


def layer_slots(cfg: ModelConfig) -> List[Tuple[int, int, int, str]]:
    """(group, unit, repeat, kind) of each layer in execution order: the
    reference scans a group's repeats and runs its units in turn."""
    return [(gi, j, r, kind)
            for gi, (unit, reps) in enumerate(layer_groups(cfg))
            for r in range(reps) for j, kind in enumerate(unit)]


def check_ported(cfg: ModelConfig) -> None:
    if cfg.is_encoder_decoder:
        raise NotImplementedError(
            f"{cfg.name}: the encoder-decoder (whisper) {NOT_PORTED}")
    for kind in sorted(set(cfg.pattern) - set(ATTN_KINDS)):
        block = {"rglru": "the RG-LRU block (recurrentgemma)",
                 "rwkv": "the RWKV6 block"}.get(kind, f"block {kind!r}")
        raise NotImplementedError(f"{cfg.name}: {block} {NOT_PORTED}")


def layer_window(cfg: ModelConfig, kind: str) -> int:
    return cfg.window if (kind == "local" or cfg.attn_kind == "swa") else 0


def _weight(shape, device, dtype=torch.bfloat16) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


class Attention(nn.Module):
    def __init__(self, cfg: ModelConfig, device: Device = None):
        super().__init__()
        d, hd = cfg.d_model, cfg.head_dim
        hq, hkv = cfg.n_heads, cfg.n_kv_heads
        self.wq = _weight((d, hq * hd), device)
        self.wk = _weight((d, hkv * hd), device)
        self.wv = _weight((d, hkv * hd), device)
        self.wo = _weight((hq * hd, d), device)
        if cfg.qkv_bias:
            self.bq = _weight((hq * hd,), device)
            self.bk = _weight((hkv * hd,), device)
            self.bv = _weight((hkv * hd,), device)
        self.shape = (hq, hkv, hd)

    def qkv(self, x: torch.Tensor):
        b, s, _ = x.shape
        hq, hkv, hd = self.shape
        q, k, v = x @ self.wq, x @ self.wk, x @ self.wv
        if hasattr(self, "bq"):
            q, k, v = q + self.bq, k + self.bk, v + self.bv
        return (q.reshape(b, s, hq, hd), k.reshape(b, s, hkv, hd),
                v.reshape(b, s, hkv, hd))


class DenseMLP(nn.Module):
    def __init__(self, cfg: ModelConfig, device: Device = None):
        super().__init__()
        d, f = cfg.d_model, cfg.d_ff
        self.w_gate = _weight((d, f), device)
        self.w_up = _weight((d, f), device)
        self.w_down = _weight((f, d), device)


class MoE(nn.Module):
    def __init__(self, cfg: ModelConfig, device: Device = None):
        super().__init__()
        d, f, e = cfg.d_model, cfg.moe_d_ff, cfg.n_experts
        self.router = _weight((d, e), device, torch.float32)
        self.w1 = _weight((e, d, f), device)
        self.w3 = _weight((e, d, f), device)
        self.w2 = _weight((e, f, d), device)
        if cfg.n_shared_experts:
            fs = cfg.moe_d_ff * cfg.n_shared_experts
            self.shared_w1 = _weight((d, fs), device)
            self.shared_w3 = _weight((d, fs), device)
            self.shared_w2 = _weight((fs, d), device)
            self.shared_gate = _weight((d,), device)

    def params(self) -> Dict[str, torch.Tensor]:
        return dict(self.named_parameters())


class Block(nn.Module):
    """One "attn" / "local" layer: pre-norm attention and FFN."""

    def __init__(self, cfg: ModelConfig, kind: str, device: Device = None):
        super().__init__()
        d = cfg.d_model
        self.ln1 = _weight((d,), device)
        self.attn = Attention(cfg, device)
        self.ln2 = _weight((d,), device)
        self.mlp = MoE(cfg, device) if cfg.n_experts else DenseMLP(cfg,
                                                                   device)
        self.kind = kind
        self.window = layer_window(cfg, kind)


class CausalLM(nn.Module):
    def __init__(self, cfg: ModelConfig, device: Device = None):
        super().__init__()
        check_ported(cfg)
        self.cfg = cfg
        d, vp = cfg.d_model, cfg.padded_vocab
        self.embed = _weight((vp, d), device)
        self.final_norm = _weight((d,), device)
        if not cfg.tie_embeddings:
            self.lm_head = _weight((d, vp), device)
        self.layers = nn.ModuleList(
            Block(cfg, kind, device) for *_, kind in layer_slots(cfg))

    def head(self) -> torch.Tensor:
        return self.embed.T if self.cfg.tie_embeddings else self.lm_head


# ---------------------------------------------------------------------------
# parameter init
# ---------------------------------------------------------------------------

def _init_axis(name: str, ndim: int) -> Optional[int]:
    """Fan-in axis of a weight, None for the zero-initialised norms and
    biases (as the reference initialises them)."""
    leaf = name.rsplit(".", 1)[-1]
    if leaf in ("ln1", "ln2", "final_norm", "bq", "bk", "bv"):
        return None
    if leaf == "embed" or ndim == 3:          # (V, d) and (E, d|f, f|d)
        return 1
    return 0


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device: Device = None) -> CausalLM:
    """A model with random weights drawn from ``generator`` (which must
    live on the device), on ``device`` (None: the card)."""
    from ..kernels.backend import resolve_device
    dev = resolve_device(device)
    model = CausalLM(cfg, device=dev)
    with torch.no_grad():
        for name, prm in model.named_parameters():
            axis = _init_axis(name, prm.ndim)
            if axis is None:
                prm.zero_()
            else:
                prm.copy_(dense_init(prm.shape, generator, axis,
                                     dtype=prm.dtype, device=dev))
    return model


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

def _attn_sub(cfg, blk: Block, x, positions, mode, cache):
    """Self-attention sublayer. ``cache``: this layer's (k, v) views in
    decode mode. Returns (out, new_cache_entry or None)."""
    b, s, _ = x.shape
    q, k, v = blk.attn.qkv(x)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    new_cache = None
    if mode == "decode":
        kc, vc = cache
        s_c = kc.shape[1]
        slot = (positions[:, 0] % s_c).long()       # ring slot per row
        rows = torch.arange(b, device=x.device)
        kc[rows, slot] = k[:, 0]
        vc[rows, slot] = v[:, 0]
        lengths = torch.clamp(positions[:, 0] + 1, max=s_c)
        out = decode_attention(q, kc, vc, lengths)
    else:
        out = flash_attention(q, k, v, causal=True, window=blk.window)
        if mode == "prefill":
            s_c = min(s, blk.window) if blk.window else s
            new_cache = (k[:, -s_c:], v[:, -s_c:])
    return out.reshape(b, s, -1) @ blk.attn.wo, new_cache


def _ffn_sub(cfg, blk: Block, x, mode):
    """Dense or MoE FFN. Returns (out, aux_loss: the MoE's load-balancing
    loss in "train" mode, else None)."""
    mlp = blk.mlp
    if isinstance(mlp, MoE):
        b, s, d = x.shape
        out, logits, idx = moe_ffn(mlp.params(), x.reshape(b * s, d),
                                   n_experts=cfg.n_experts, top_k=cfg.top_k,
                                   cap_factor=cfg.moe_cap_factor)
        aux = (aux_load_balance_loss(logits, idx, cfg.n_experts)
               if mode == "train" else None)
        return out.reshape(b, s, d), aux
    return swiglu(x, mlp.w_gate, mlp.w_up, mlp.w_down), None


def apply_layer(cfg, blk: Block, x, positions, mode, cache=None):
    """One block. Returns (x, aux or None, new_cache_entry)."""
    h = rms_norm(x, blk.ln1, cfg.norm_eps)
    out, new_c = _attn_sub(cfg, blk, h, positions, mode, cache)
    x = x + out
    h = rms_norm(x, blk.ln2, cfg.norm_eps)
    out, aux = _ffn_sub(cfg, blk, h, mode)
    return x + out, aux, new_c


# ---------------------------------------------------------------------------
# cache
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device: Device = None) -> list:
    """An empty cache: full-attention layers hold ``max_len`` slots,
    sliding-window layers a ring of ``min(max_len, window)``."""
    from ..kernels.backend import resolve_device
    dev = resolve_device(device)
    check_ported(cfg)
    hd, hkv = cfg.head_dim, cfg.n_kv_heads
    cache = []
    for unit, reps in layer_groups(cfg):
        entry = {}
        for j, kind in enumerate(unit):
            window = layer_window(cfg, kind)
            s_c = min(max_len, window) if window else max_len
            entry[f"u{j}"] = {
                n: torch.zeros((reps, batch, s_c, hkv, hd),
                               dtype=torch.bfloat16, device=dev)
                for n in ("k", "v")}
        cache.append(entry)
    return cache


def _layer_cache(cache, gi, j, r):
    entry = cache[gi][f"u{j}"]
    return entry["k"][r], entry["v"][r]


# ---------------------------------------------------------------------------
# full-model passes
# ---------------------------------------------------------------------------

def _run_layers(cfg, model: CausalLM, x, positions, mode, cache=None):
    """Every layer in order. Returns (x, aux_total, prefill entries by
    (group, unit) as lists over repeats)."""
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    entries: Dict[Tuple[int, int], list] = {}
    for blk, (gi, j, r, _) in zip(model.layers, layer_slots(cfg)):
        c = _layer_cache(cache, gi, j, r) if mode == "decode" else None
        x, aux, new_c = apply_layer(cfg, blk, x, positions, mode, c)
        if aux is not None:
            aux_total = aux_total + aux
        if new_c is not None:
            entries.setdefault((gi, j), []).append(new_c)
    return x, aux_total, entries


def _positions_for(cfg, batch):
    tokens = batch["tokens"]
    b, s = tokens.shape
    total = s + (cfg.n_patches if (cfg.frontend == "vision_stub"
                                   and "patches" in batch) else 0)
    return torch.arange(total, device=tokens.device)[None].expand(b, total)


def _input_embeds(cfg, model: CausalLM, batch):
    """Token (+ stub-frontend patch) embedding."""
    x = model.embed[batch["tokens"]]
    if cfg.frontend == "vision_stub" and "patches" in batch:
        x = torch.cat([batch["patches"].to(x.dtype), x], dim=1)
    return x


def f32_product(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` for bf16 operands with a float32 result (the reference's
    ``preferred_element_type=float32``): on the card one bf16 product
    that writes float32; on the CPU, which has no such product, the
    operands widened to float32 (their products are exact there)."""
    if x.is_cuda:
        flat = x.reshape(-1, x.shape[-1])
        return torch.mm(flat, w, out_dtype=torch.float32).reshape(
            *x.shape[:-1], w.shape[-1])
    return x.float() @ w.float()


def logits_fn(cfg, model: CausalLM, x):
    logits = f32_product(x, model.head())
    if cfg.padded_vocab != cfg.vocab:            # mask the vocab padding
        cols = torch.arange(cfg.padded_vocab, device=x.device)
        logits = logits + torch.where(cols < cfg.vocab, 0.0, -1e9)
    return logits


def lm_loss(cfg, logits, labels):
    """Mean cross-entropy over labels >= 0 (fp32)."""
    ll = torch.gather(logits, -1, labels.clamp(min=0)[..., None].long())[
        ..., 0]
    logz = torch.logsumexp(logits, dim=-1)
    mask = (labels >= 0).float()
    return torch.sum((logz - ll) * mask) / torch.clamp(mask.sum(), min=1.0)


def _forward(cfg, model: CausalLM, batch):
    positions = _positions_for(cfg, batch)
    x = _input_embeds(cfg, model, batch)
    x, aux, _ = _run_layers(cfg, model, x, positions, "train")
    x = rms_norm(x, model.final_norm, cfg.norm_eps)
    return logits_fn(cfg, model, x), aux


def forward(cfg: ModelConfig, model: CausalLM, batch) -> torch.Tensor:
    """The full-sequence forward (the reference's training pass without
    its backward): logits (B, S, V) fp32."""
    return _forward(cfg, model, batch)[0]


def forward_train(cfg: ModelConfig, model: CausalLM, batch):
    """batch: tokens/labels (+patches). Returns (loss, metrics), forward
    only (the backward waits for the training slice)."""
    logits, aux = _forward(cfg, model, batch)
    loss = lm_loss(cfg, logits, batch["labels"])
    return loss + 0.01 * aux, {"loss": loss, "aux": aux}


def prefill(cfg: ModelConfig, model: CausalLM, batch, pad_to: int = 0):
    """Fill the KV cache; returns (last_token_logits, cache).

    ``pad_to``: decode headroom. Full-attention caches are extended to
    this many slots so that decode at positions past the prompt does not
    wrap the ring; sliding-window caches keep their window size."""
    positions = _positions_for(cfg, batch)
    s_in = positions.shape[1]
    x = _input_embeds(cfg, model, batch)
    x, _, entries = _run_layers(cfg, model, x, positions, "prefill")
    cache = []
    for gi, (unit, _) in enumerate(layer_groups(cfg)):
        group = {}
        for j, kind in enumerate(unit):
            reps = entries[(gi, j)]
            kv = {n: torch.stack([e[i] for e in reps])
                  for i, n in enumerate(("k", "v"))}
            if pad_to > s_in and not layer_window(cfg, kind):
                kv = {n: nn.functional.pad(t, (0, 0, 0, 0, 0, pad_to - s_in))
                      for n, t in kv.items()}
            group[f"u{j}"] = kv
        cache.append(group)
    x = rms_norm(x[:, -1:], model.final_norm, cfg.norm_eps)
    return logits_fn(cfg, model, x)[:, 0], cache


def decode_step(cfg: ModelConfig, model: CausalLM, cache, token, pos):
    """One decode step. token: (B,) int; pos: (B,) int (absolute).
    Writes the cache in place; returns (logits (B, V) fp32, cache)."""
    positions = pos[:, None]
    x = _input_embeds(cfg, model, {"tokens": token[:, None]})
    x, _, _ = _run_layers(cfg, model, x, positions, "decode", cache)
    x = rms_norm(x, model.final_norm, cfg.norm_eps)
    return logits_fn(cfg, model, x)[:, 0], cache


serve_step = decode_step
