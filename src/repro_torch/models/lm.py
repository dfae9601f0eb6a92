"""Causal language model covering the repository's ten architectures.

One module, ``CausalLM(cfg)``, with one submodule per layer, and plain
functions under the reference's names:

    init_params(cfg, generator, device=None)      -> model
    forward(cfg, model, batch)                    -> logits (B, S, V) fp32
    forward_train(cfg, model, batch, flags)       -> (total, metrics)
    prefill(cfg, model, batch, flags, pad_to=0)   -> (last_logits, cache)
    decode_step(cfg, model, cache, token, pos, flags) -> (logits, cache)

Block kinds: "attn" (full or sliding-window GQA) and "local" (sliding
window), each with a dense SwiGLU FFN or, when ``cfg.n_experts > 0``,
the MoE FFN (``models.moe.moe_ffn``; under a sharding context whose
data axes divide the tokens, ``dist.moe_ep.moe_ffn_tp``); "rglru"
(``models.rglru``, RecurrentGemma) with the dense FFN;
"rwkv" (``models.rwkv6``: time mix, then channel mix). The
encoder-decoder (whisper) uses layer norms with a bias, a GELU FFN
with biases and no rotary embedding; its encoder runs non-causal "attn"
blocks over the frames (the conv frontend is a stub: frames are
embeddings), and each decoder block adds a cross-attention sublayer
over the encoder's keys and values. Parameters are the reference's, in
its layouts ((d, out) products, bf16, the MoE router, ``lam``, ``u``
and ``w0`` float32); ``convert.lm_params_from`` carries a reference
pytree across.

The cache has the reference's layout: a list with one entry per layer
group (``layer_groups``), ``{"u<j>": entry}`` with a leading axis over
the group's repeats: ``{"k", "v"}`` (reps, B, S_c, Hkv, hd) bf16 for
attention, the block's state NamedTuple (``RgState``, ``RwkvState``)
for the recurrent kinds; the encoder-decoder appends ``{"cross": {"k",
"v"}}`` (L, B, S_enc, Hkv, hd). ``decode_step`` writes the new key and
value into the ring slot ``pos % S_c``, and the new recurrent states
over the old, in place, and returns the same cache.

Training: the parameters are created frozen; ``model.requires_grad_()``
opens them to autograd, and ``forward_train(...)[0].backward()`` gives
every one a gradient. The layers run unit by unit, a unit being one
repeat of a layer group's pattern (the reference's scan body): in train
mode each unit ends in :func:`grad_cast_bf16`, and ``RunFlags.remat``
recomputes a unit in the backward (``"full"``) or everything in it but
the flash attention's output (``"attn_out"``); neither changes a bit of
the loss or the gradients.

Distribution: the reference's logical-axis annotations (``dist.ctx.
constrain``) stand at the same points: q, k and v, the embedded input,
each unit's output (the residual stream) and the logits. Outside a
sharding context they are the identity. Inside one the parameters and
inputs are DTensors (``launch.steps.jit_cell``) and ``constrain``
redistributes. This module stays plain PyTorch: how its products,
lookups and attention run on a mesh is ``dist.local.ShardwiseOps``'s
choice, a ``__torch_function__`` mode that ``jit_cell`` installs (hence
the override hooks in :func:`decode_attend` and :func:`f32_product`).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, List, Optional, Tuple, Union

import torch
from torch import nn
from torch.overrides import handle_torch_function, has_torch_function
from torch.utils import checkpoint as ckpt

from ..configs.base import ModelConfig
from ..dist.ctx import constrain, current, remat_contexts
from . import rglru as rg
from . import rwkv6 as rk
from .attention import decode_attention, flash_attention
from .layers import (dense_init, gelu_mlp, layer_norm, rms_norm, rope,
                     sinusoidal_pos, swiglu, weight)
from .moe import aux_load_balance_loss, moe_ffn

Device = Optional[Union[str, torch.device]]
ATTN_KINDS = ("attn", "local")


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


def layer_window(cfg: ModelConfig, kind: str) -> int:
    return cfg.window if (kind == "local" or cfg.attn_kind == "swa") else 0


def use_rope(cfg: ModelConfig) -> bool:
    return not cfg.is_encoder_decoder


def encoder_config(cfg: ModelConfig) -> ModelConfig:
    """The whisper encoder's stack: ``n_encoder_layers`` "attn" blocks."""
    return dataclasses.replace(cfg, n_layers=cfg.n_encoder_layers,
                               layer_pattern=(), n_experts=0)


class LayerNorm(nn.Module):
    """The encoder-decoder's norm: the reference's ``{"s", "b"}``."""

    def __init__(self, d: int, device: Device = None):
        super().__init__()
        self.s = weight((d,), device)
        self.b = weight((d,), device)


def _norm_weights(cfg: ModelConfig, device: Device):
    d = cfg.d_model
    return LayerNorm(d, device) if cfg.is_encoder_decoder else weight(
        (d,), device)


def _norm(cfg: ModelConfig, p, x: torch.Tensor) -> torch.Tensor:
    if cfg.is_encoder_decoder:
        return layer_norm(x, p.s, p.b, cfg.norm_eps)
    return rms_norm(x, p, cfg.norm_eps)


class Attention(nn.Module):
    def __init__(self, cfg: ModelConfig, device: Device = None,
                 cross: bool = False):
        super().__init__()
        d, hd = cfg.d_model, cfg.head_dim
        hq, hkv = cfg.n_heads, cfg.n_kv_heads
        self.wq = weight((d, hq * hd), device)
        self.wk = weight((d, hkv * hd), device)
        self.wv = weight((d, hkv * hd), device)
        self.wo = weight((hq * hd, d), device)
        if cfg.qkv_bias and not cross:
            self.bq = weight((hq * hd,), device)
            self.bk = weight((hkv * hd,), device)
            self.bv = weight((hkv * hd,), device)
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
        self.w_gate = weight((d, f), device)
        self.w_up = weight((d, f), device)
        self.w_down = weight((f, d), device)


class GeluMLP(nn.Module):
    """The encoder-decoder's FFN: GELU with biases."""

    def __init__(self, cfg: ModelConfig, device: Device = None):
        super().__init__()
        d, f = cfg.d_model, cfg.d_ff
        self.w_up = weight((d, f), device)
        self.b_up = weight((f,), device)
        self.w_down = weight((f, d), device)
        self.b_down = weight((d,), device)


class MoE(nn.Module):
    def __init__(self, cfg: ModelConfig, device: Device = None):
        super().__init__()
        d, f, e = cfg.d_model, cfg.moe_d_ff, cfg.n_experts
        self.router = weight((d, e), device, torch.float32)
        self.w1 = weight((e, d, f), device)
        self.w3 = weight((e, d, f), device)
        self.w2 = weight((e, f, d), device)
        if cfg.n_shared_experts:
            fs = cfg.moe_d_ff * cfg.n_shared_experts
            self.shared_w1 = weight((d, fs), device)
            self.shared_w3 = weight((d, fs), device)
            self.shared_w2 = weight((fs, d), device)
            self.shared_gate = weight((d,), device)

    def params(self) -> Dict[str, torch.Tensor]:
        return dict(self.named_parameters())


def _mlp(cfg: ModelConfig, device: Device, routed: bool = True
         ) -> nn.Module:
    """The FFN: MoE when ``cfg.n_experts`` (attention blocks only, as in
    the reference), else GELU (encoder-decoder) or SwiGLU."""
    if cfg.n_experts and routed:
        return MoE(cfg, device)
    return GeluMLP(cfg, device) if cfg.is_encoder_decoder else DenseMLP(
        cfg, device)


class Block(nn.Module):
    """One layer, pre-norm. "attn" / "local": attention (and, in the
    decoder of an encoder-decoder, cross-attention) and the FFN;
    "rglru": the RG-LRU and the dense FFN; "rwkv": time mix and channel
    mix."""

    def __init__(self, cfg: ModelConfig, kind: str, device: Device = None,
                 with_cross: bool = False):
        super().__init__()
        self.kind = kind
        self.ln1 = _norm_weights(cfg, device)
        if kind in ATTN_KINDS:
            self.attn = Attention(cfg, device)
            self.window = layer_window(cfg, kind)
            if with_cross:
                self.ln_x = _norm_weights(cfg, device)
                self.cross = Attention(cfg, device, cross=True)
        elif kind == "rglru":
            self.rg = rg.RgLRU(cfg.d_model, device)
        elif kind == "rwkv":
            self.rwkv = rk.Rwkv(cfg.d_model, cfg.d_ff, cfg.rwkv_head_size,
                                device)
        else:
            raise ValueError(f"{cfg.name}: unknown block kind {kind!r}")
        self.ln2 = _norm_weights(cfg, device)
        if kind != "rwkv":
            self.mlp = _mlp(cfg, device, routed=kind in ATTN_KINDS)


class CausalLM(nn.Module):
    def __init__(self, cfg: ModelConfig, device: Device = None):
        super().__init__()
        self.cfg = cfg
        d, vp = cfg.d_model, cfg.padded_vocab
        self.embed = weight((vp, d), device)
        self.final_norm = _norm_weights(cfg, device)
        if not cfg.tie_embeddings:
            self.lm_head = weight((d, vp), device)
        self.layers = nn.ModuleList(
            Block(cfg, kind, device, with_cross=cfg.is_encoder_decoder)
            for *_, kind in layer_slots(cfg))
        if cfg.is_encoder_decoder:    # the decoder's FFN kind, as the
            self.enc_layers = nn.ModuleList(      # reference lays it out
                Block(cfg, "attn", device)
                for _ in range(cfg.n_encoder_layers))
            self.enc_norm = _norm_weights(cfg, device)

    def head(self) -> torch.Tensor:
        return self.embed.T if self.cfg.tie_embeddings else self.lm_head


# ---------------------------------------------------------------------------
# parameter init
# ---------------------------------------------------------------------------

ZERO_LEAVES = ("ln1", "ln2", "ln_x", "final_norm", "enc_norm", "s", "b",
               "bq", "bk", "bv", "b_up", "b_down")


def _init_axis(name: str, ndim: int) -> Optional[int]:
    """Fan-in axis of a weight, None for the zero-initialised norms and
    biases (as the reference initialises them)."""
    leaf = name.rsplit(".", 1)[-1]
    if leaf in ZERO_LEAVES:
        return None
    if leaf == "embed" or ndim == 3:          # (V, d) and (E, d|f, f|d)
        return 1
    return 0


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device: Device = None) -> CausalLM:
    """A model with random weights drawn from ``generator`` (which must
    live on the device), on ``device`` (None: the card). The recurrent
    blocks take their reference initialisation (``rglru``, ``rwkv6``)."""
    from ..kernels.backend import resolve_device
    dev = resolve_device(device)
    model = CausalLM(cfg, device=dev)
    with torch.no_grad():
        for name, prm in model.named_parameters():
            if ".rg." in name or ".rwkv." in name:
                continue
            axis = _init_axis(name, prm.ndim)
            if axis is None:
                prm.zero_()
            else:
                prm.copy_(dense_init(prm.shape, generator, axis,
                                     dtype=prm.dtype, device=dev))
        for blk in model.layers:
            if blk.kind == "rglru":
                rg.init_rglru_params(blk.rg, generator)
            elif blk.kind == "rwkv":
                rk.init_rwkv_params(blk.rwkv, generator)
    return model


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

def decode_attend(q, k, v, kc, vc, positions):
    """Write the step's key and value into the ring slot ``pos % S_c``
    of this layer's caches, in place, and attend over them. Overridable
    by ``__torch_function__`` (a mesh runs it shard by shard)."""
    if has_torch_function((q, k, v, kc, vc)):
        return handle_torch_function(decode_attend, (q, k, v, kc, vc), q, k,
                                     v, kc, vc, positions)
    b, s_c = q.shape[0], kc.shape[1]
    slot = (positions[:, 0] % s_c).long()           # ring slot per row
    rows = torch.arange(b, device=q.device)
    kc[rows, slot] = k[:, 0]
    vc[rows, slot] = v[:, 0]
    lengths = torch.clamp(positions[:, 0] + 1, max=s_c)
    return decode_attention(q, kc, vc, lengths)


def _attn_sub(cfg, blk: Block, x, positions, mode, cache, causal=True):
    """Self-attention sublayer. ``cache``: this layer's (k, v) views in
    decode mode. Returns (out, new_cache_entry or None)."""
    b, s, _ = x.shape
    q, k, v = blk.attn.qkv(x)
    if use_rope(cfg):
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    if mode != "decode":
        # the flash loop wants whole-sequence K/V per shard; q stays
        # sequence-sharded
        k = constrain(k, ("dp", None, None, None))
        v = constrain(v, ("dp", None, None, None))
        q = constrain(q, ("dp", "tp", None, None))
    new_cache = None
    if mode == "decode":
        out = decode_attend(q, k, v, *cache, positions)
    else:
        out = flash_attention(q, k, v, causal=causal, window=blk.window)
        if mode == "prefill":
            s_c = min(s, blk.window) if blk.window else s
            new_cache = (k[:, -s_c:], v[:, -s_c:])
    return out.reshape(b, s, -1) @ blk.attn.wo, new_cache


def _cross_sub(cfg, p: Attention, x, cross_kv):
    """Cross-attention (the whisper decoder). cross_kv: this layer's
    (k, v), each (B, S_enc, Hkv, hd)."""
    b, s, _ = x.shape
    hq, _, hd = p.shape
    q = (x @ p.wq).reshape(b, s, hq, hd)
    out = flash_attention(q, cross_kv[0], cross_kv[1], causal=False)
    return out.reshape(b, s, -1) @ p.wo


def _moe_impl_auto(t: int):
    """The active sharding context when it can run the TP-MoE (its data
    axes divide the token count), else None."""
    ctx = current()
    if ctx is None or t % ctx.logical_sizes()["dp"]:
        return None
    return ctx


def _ffn_sub(cfg, blk: Block, x, mode):
    """Dense, GELU or MoE FFN. Returns (out, aux_loss: the MoE's
    load-balancing loss in "train" mode, else None)."""
    mlp = blk.mlp
    if isinstance(mlp, MoE):
        b, s, d = x.shape
        flat = constrain(x.reshape(b * s, d), ("dp", None))
        impl = moe_ffn
        if _moe_impl_auto(b * s) is not None:
            from ..dist.moe_ep import moe_ffn_tp as impl
        out, logits, idx = impl(mlp.params(), flat,
                                n_experts=cfg.n_experts, top_k=cfg.top_k,
                                cap_factor=cfg.moe_cap_factor)
        aux = (aux_load_balance_loss(logits, idx, cfg.n_experts)
               if mode == "train" else None)
        return out.reshape(b, s, d), aux
    if isinstance(mlp, GeluMLP):
        return gelu_mlp(x, mlp.w_up, mlp.b_up, mlp.w_down, mlp.b_down), None
    return swiglu(x, mlp.w_gate, mlp.w_up, mlp.w_down), None


def apply_layer(cfg, blk: Block, x, positions, mode, cache=None,
                cross_kv=None, causal=True):
    """One block. ``cache``: in decode mode the layer's (k, v) views or
    its recurrent state. Returns (x, aux or None, new cache entry: the
    prefill's (k, v), or a recurrent block's new state)."""
    if blk.kind in ATTN_KINDS:
        h = _norm(cfg, blk.ln1, x)
        out, new_c = _attn_sub(cfg, blk, h, positions, mode, cache, causal)
        x = x + out
        if hasattr(blk, "cross") and cross_kv is not None:
            h = _norm(cfg, blk.ln_x, x)
            x = x + _cross_sub(cfg, blk.cross, h, cross_kv)
        h = _norm(cfg, blk.ln2, x)
        out, aux = _ffn_sub(cfg, blk, h, mode)
        return x + out, aux, new_c
    b, dev = x.shape[0], x.device
    if blk.kind == "rglru":
        state = cache if cache is not None else rg.init_rg_state(
            b, cfg.d_model, dev)
        h = _norm(cfg, blk.ln1, x)
        fn = rg.rglru_decode if mode == "decode" else rg.rglru_block
        out, state = fn(blk.rg, h, state)
        x = x + out
        h = _norm(cfg, blk.ln2, x)
        out, _ = _ffn_sub(cfg, blk, h, mode)
        return x + out, None, state
    state = cache if cache is not None else rk.init_rwkv_state(
        b, cfg.n_rwkv_heads, cfg.rwkv_head_size, cfg.d_model, dev)
    h = _norm(cfg, blk.ln1, x)
    out, state = rk.time_mix(blk.rwkv, h, state, chunked=(mode != "decode"))
    x = x + out
    h = _norm(cfg, blk.ln2, x)
    out, state = rk.channel_mix(blk.rwkv, h, state)
    return x + out, None, state


# ---------------------------------------------------------------------------
# cache
# ---------------------------------------------------------------------------

def _empty_entry(cfg, kind, reps, batch, max_len, dev):
    """A zero cache entry of one unit, with the leading repeats axis."""
    if kind in ATTN_KINDS:
        window = layer_window(cfg, kind)
        s_c = min(max_len, window) if window else max_len
        return {n: torch.zeros((reps, batch, s_c, cfg.n_kv_heads,
                                cfg.head_dim), dtype=torch.bfloat16,
                               device=dev) for n in ("k", "v")}
    state = (rg.init_rg_state(batch, cfg.d_model, dev) if kind == "rglru"
             else rk.init_rwkv_state(batch, cfg.n_rwkv_heads,
                                     cfg.rwkv_head_size, cfg.d_model, dev))
    return type(state)(*(t.expand(reps, *t.shape).clone() for t in state))


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device: Device = None) -> list:
    """An empty cache: full-attention layers hold ``max_len`` slots,
    sliding-window layers a ring of ``min(max_len, window)``, recurrent
    layers a zero state; the encoder-decoder's cross keys and values
    for ``cfg.encoder_seq`` frames."""
    from ..kernels.backend import resolve_device
    dev = resolve_device(device)
    cache = [{f"u{j}": _empty_entry(cfg, kind, reps, batch, max_len, dev)
              for j, kind in enumerate(unit)}
             for unit, reps in layer_groups(cfg)]
    if cfg.is_encoder_decoder:
        reps = layer_groups(cfg)[0][1]
        cache.append({"cross": {
            n: torch.zeros((reps, batch, cfg.encoder_seq, cfg.n_kv_heads,
                            cfg.head_dim), dtype=torch.bfloat16, device=dev)
            for n in ("k", "v")}})
    return cache


def _layer_cache(cache, gi, j, r):
    """Layer (gi, j, r)'s views into the cache: (k, v) or its state."""
    entry = cache[gi][f"u{j}"]
    if isinstance(entry, dict):
        return entry["k"][r], entry["v"][r]
    return type(entry)(*(t[r] for t in entry))


# ---------------------------------------------------------------------------
# full-model passes
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class RunFlags:
    """``remat``: "none", "full" (a unit keeps nothing for its backward
    and is recomputed) or "attn_out" (a unit keeps only its flash
    attentions' outputs). ``scan_layers`` is accepted for the
    reference's signature: the port has one submodule a layer and runs
    them in a Python loop either way."""
    remat: str = "attn_out"
    scan_layers: bool = True


class GradCastBf16(torch.autograd.Function):
    """Identity forward; the cotangent leaves in bf16 (the reference's
    ``grad_cast_bf16`` barrier at the end of each unit)."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.to(torch.bfloat16)


def grad_cast_bf16(x: torch.Tensor) -> torch.Tensor:
    return GradCastBf16.apply(x)


def _keep_attn_out(ctx, op, *args, **kwargs):
    """Selective-checkpoint policy of ``remat="attn_out"``: keep the
    flash forward's outputs, recompute everything else."""
    if op == torch.ops.repro_torch.flash_fwd.default:
        return ckpt.CheckpointPolicy.MUST_SAVE
    return ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def _maybe_remat(fn, flags: "RunFlags"):
    """``fn`` under the remat policy of ``flags`` (the reference's
    ``jax.checkpoint`` with ``nothing_saveable`` or
    ``save_only_these_names("attn_out")``); a recompute runs under the
    forward's sharding context (``dist.ctx.remat_contexts``)."""
    if flags.remat == "none":
        return fn
    if flags.remat == "full":
        return functools.partial(ckpt.checkpoint, fn, use_reentrant=False,
                                 context_fn=remat_contexts)
    if flags.remat == "attn_out":
        return functools.partial(
            ckpt.checkpoint, fn, use_reentrant=False,
            context_fn=functools.partial(remat_contexts, functools.partial(
                ckpt.create_selective_checkpoint_contexts, _keep_attn_out)))
    raise ValueError(f"unknown remat policy {flags.remat!r}")


def _units(cfg):
    """(group, repeat, [(index into the layers, unit position)]) of each
    unit in execution order (``layer_slots`` grouped by unit)."""
    i = 0
    for gi, (unit, reps) in enumerate(layer_groups(cfg)):
        for r in range(reps):
            yield gi, r, [(i + j, j) for j in range(len(unit))]
            i += len(unit)


def _run_layers(cfg, layers, x, positions, mode, cache=None,
                cross_kv=None, flags: Optional["RunFlags"] = None,
                causal=True):
    """Every layer of ``layers`` (the model's, or the encoder's under
    ``encoder_config``) in order, unit by unit. ``cross_kv``: the
    decoder's stacked cross (k, v) (the encoder-decoder has one decoder
    group). Returns (x, aux_total, prefill entries by (group, unit) as
    lists over repeats); in decode mode the recurrent states are written
    into ``cache``. In train mode each unit ends in
    :func:`grad_cast_bf16` and runs under ``flags``' remat policy."""
    flags = flags or RunFlags()
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    entries: Dict[Tuple[int, int], list] = {}
    train = mode == "train"
    # autograd records this pass: remat and the cotangent casts apply
    recording = train and torch.is_grad_enabled() and (
        x.requires_grad or any(p.requires_grad for p in layers.parameters()))
    for gi, r, unit in _units(cfg):
        xkv = ((cross_kv[0][r], cross_kv[1][r])
               if cross_kv is not None and gi == 0 else None)
        if train:
            def body(xu, unit=unit, xkv=xkv):
                auxes = []
                for i, _ in unit:
                    xu, aux, _ = apply_layer(cfg, layers[i], xu, positions,
                                             mode, None, xkv, causal)
                    auxes.append(aux)
                return _constrain_stream(xu, mode), auxes

            if recording:
                x, auxes = _maybe_remat(body, flags)(x)
                x = grad_cast_bf16(x)
            else:
                x, auxes = body(x)
            for aux in auxes:
                if aux is not None:
                    aux_total = aux_total + aux
            continue
        for i, j in unit:
            c = _layer_cache(cache, gi, j, r) if mode == "decode" else None
            x, _, new_c = apply_layer(cfg, layers[i], x, positions, mode, c,
                                      xkv, causal)
            if new_c is None:
                continue
            if mode == "decode":                  # a recurrent state
                for dst, src in zip(c, new_c):
                    dst.copy_(src)
            else:
                entries.setdefault((gi, j), []).append(new_c)
        x = _constrain_stream(x, mode)
    return x, aux_total, entries


def _constrain_stream(x, mode):
    """The residual stream after a unit: batch over the data axes and,
    outside decode, the sequence over the model axis (the per-unit save
    otherwise dominates memory); dropped where it does not divide."""
    return constrain(x, ("dp", "tp" if mode != "decode" else None, None))


def _encode(cfg, model: CausalLM, frames, flags=None):
    """The whisper encoder (the conv frontend is a stub: frames are
    embeddings): frames + sinusoidal positions, non-causal "attn" blocks
    (in train mode, as the reference runs them), the encoder's norm."""
    b, senc, _ = frames.shape
    pos = torch.arange(senc, device=frames.device)[None].expand(b, senc)
    x = frames.to(torch.bfloat16) + sinusoidal_pos(pos, cfg.d_model).to(
        torch.bfloat16)
    x, _, _ = _run_layers(encoder_config(cfg), model.enc_layers, x, pos,
                          "train", flags=flags, causal=False)
    return _norm(cfg, model.enc_norm, x)


def _project_cross(cfg, model: CausalLM, enc):
    """Each decoder layer's cross keys and values of the encoder output:
    (k, v), each stacked (L, B, S_enc, Hkv, hd)."""
    b, senc, _ = enc.shape
    _, hkv, hd = model.layers[0].cross.shape
    k = torch.stack([(enc @ blk.cross.wk).reshape(b, senc, hkv, hd)
                     for blk in model.layers])
    v = torch.stack([(enc @ blk.cross.wv).reshape(b, senc, hkv, hd)
                     for blk in model.layers])
    return k, v


def _positions_for(cfg, batch):
    tokens = batch["tokens"]
    b, s = tokens.shape
    total = s + (cfg.n_patches if (cfg.frontend == "vision_stub"
                                   and "patches" in batch) else 0)
    return torch.arange(total, device=tokens.device)[None].expand(b, total)


def _input_embeds(cfg, model: CausalLM, batch, positions):
    """Token (+ stub-frontend patch) embedding; the encoder-decoder adds
    the sinusoidal position."""
    x = model.embed[batch["tokens"]]
    if cfg.frontend == "vision_stub" and "patches" in batch:
        x = torch.cat([batch["patches"].to(x.dtype), x], dim=1)
    if cfg.is_encoder_decoder:
        x = x + sinusoidal_pos(positions, cfg.d_model).to(x.dtype)
    return constrain(x, ("dp", "tp" if x.shape[1] > 1 else None, None))


class _F32Product(torch.autograd.Function):
    """The card's bf16 product with a float32 result; its backward is
    the CPU form's: float32 products of the float32 cotangent, rounded
    to the operands' dtypes (as the reference's transposes round)."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        flat = x.reshape(-1, x.shape[-1])
        return torch.mm(flat, w, out_dtype=torch.float32).reshape(
            *x.shape[:-1], w.shape[-1])

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        gf = g.reshape(-1, g.shape[-1])
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = (gf @ w.float().t()).to(x.dtype).reshape(x.shape)
        if ctx.needs_input_grad[1]:
            dw = (x.reshape(-1, x.shape[-1]).float().t() @ gf).to(w.dtype)
        return dx, dw


def f32_product(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` for bf16 operands with a float32 result (the reference's
    ``preferred_element_type=float32``): on the card one bf16 product
    that writes float32; on the CPU, which has no such product, the
    operands widened to float32 (their products are exact there).
    Overridable by ``__torch_function__`` (a mesh runs it shard by
    shard)."""
    if has_torch_function((x, w)):
        return handle_torch_function(f32_product, (x, w), x, w)
    if x.is_cuda:
        return _F32Product.apply(x, w)
    return x.float() @ w.float()


def logits_fn(cfg, model: CausalLM, x):
    logits = f32_product(x, model.head())
    if cfg.padded_vocab != cfg.vocab:            # mask the vocab padding
        cols = torch.arange(cfg.padded_vocab, device=x.device)
        logits = logits + torch.where(cols < cfg.vocab, 0.0, -1e9)
    return constrain(logits, ("dp", None, "tp"))


def lm_loss(cfg, logits, labels):
    """Mean cross-entropy over labels >= 0 (fp32)."""
    ll = torch.gather(logits, -1, labels.clamp(min=0)[..., None].long())[
        ..., 0]
    logz = torch.logsumexp(logits, dim=-1)
    mask = (labels >= 0).float()
    return torch.sum((logz - ll) * mask) / torch.clamp(mask.sum(), min=1.0)


def _cross_of(cfg, model: CausalLM, batch, flags=None):
    """The decoder's cross (k, v) from ``batch["frames"]`` (None unless
    the model is an encoder-decoder)."""
    if not cfg.is_encoder_decoder:
        return None
    return _project_cross(cfg, model, _encode(cfg, model, batch["frames"],
                                              flags))


def _forward(cfg, model: CausalLM, batch, flags=None):
    cross_kv = _cross_of(cfg, model, batch, flags)
    positions = _positions_for(cfg, batch)
    x = _input_embeds(cfg, model, batch, positions)
    x, aux, _ = _run_layers(cfg, model.layers, x, positions, "train",
                            cross_kv=cross_kv, flags=flags)
    x = _norm(cfg, model.final_norm, x)
    return logits_fn(cfg, model, x), aux


def forward(cfg: ModelConfig, model: CausalLM, batch) -> torch.Tensor:
    """The full-sequence forward (the reference's training pass without
    its loss): logits (B, S, V) fp32."""
    return _forward(cfg, model, batch)[0]


def forward_train(cfg: ModelConfig, model: CausalLM, batch,
                  flags: RunFlags = RunFlags()):
    """batch: tokens/labels (+frames|patches). Returns (total, {"loss",
    "aux"}): the mean cross-entropy plus 0.01 times the MoE
    load-balancing loss; ``total.backward()`` differentiates it."""
    logits, aux = _forward(cfg, model, batch, flags)
    loss = lm_loss(cfg, logits, batch["labels"])
    return loss + 0.01 * aux, {"loss": loss, "aux": aux}


def prefill(cfg: ModelConfig, model: CausalLM, batch,
            flags: RunFlags = RunFlags(), pad_to: int = 0):
    """Fill the cache; returns (last_token_logits, cache). ``flags`` is
    the reference's (a forward-only pass records no autograd, so it
    changes no value).

    ``pad_to``: decode headroom. Full-attention caches are extended to
    this many slots so that decode at positions past the prompt does not
    wrap the ring; sliding-window caches keep their window size, and
    recurrent states have none. The encoder-decoder encodes
    ``batch["frames"]`` and appends the cross keys and values."""
    cross_kv = _cross_of(cfg, model, batch, flags)
    positions = _positions_for(cfg, batch)
    s_in = positions.shape[1]
    x = _input_embeds(cfg, model, batch, positions)
    x, _, entries = _run_layers(cfg, model.layers, x, positions,
                                "prefill", cross_kv=cross_kv, flags=flags)
    cache = []
    for gi, (unit, _) in enumerate(layer_groups(cfg)):
        group = {}
        for j, kind in enumerate(unit):
            reps = entries[(gi, j)]
            if kind not in ATTN_KINDS:        # a state NamedTuple
                group[f"u{j}"] = type(reps[0])(
                    *(torch.stack(leaf) for leaf in zip(*reps)))
                continue
            kv = {n: torch.stack([e[i] for e in reps])
                  for i, n in enumerate(("k", "v"))}
            if pad_to > s_in and not layer_window(cfg, kind):
                kv = {n: nn.functional.pad(t, (0, 0, 0, 0, 0, pad_to - s_in))
                      for n, t in kv.items()}
            group[f"u{j}"] = kv
        cache.append(group)
    if cross_kv is not None:
        cache.append({"cross": dict(zip(("k", "v"), cross_kv))})
    x = _norm(cfg, model.final_norm, x[:, -1:])
    return logits_fn(cfg, model, x)[:, 0], cache


def decode_step(cfg: ModelConfig, model: CausalLM, cache, token, pos,
                flags: RunFlags = RunFlags(remat="none")):
    """One decode step. token: (B,) int; pos: (B,) int (absolute).
    Writes the cache in place; returns (logits (B, V) fp32, cache).
    ``flags`` is the reference's and changes no value."""
    positions = pos[:, None]
    x = _input_embeds(cfg, model, {"tokens": token[:, None]}, positions)
    cross_kv = None
    if cfg.is_encoder_decoder:
        cross = cache[-1]["cross"]
        cross_kv = (cross["k"], cross["v"])
    x, _, _ = _run_layers(cfg, model.layers, x, positions, "decode", cache,
                          cross_kv, flags)
    x = _norm(cfg, model.final_norm, x)
    return logits_fn(cfg, model, x)[:, 0], cache


serve_step = decode_step
