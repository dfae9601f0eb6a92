"""Model configuration schema for the assigned architectures (a copy of
the reference's; it imports neither torch nor JAX)."""

from __future__ import annotations

import dataclasses
from typing import Tuple


def _pad_to(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    # attention --------------------------------------------------------------
    head_dim: int = 0           # 0 -> d_model // n_heads
    qkv_bias: bool = False
    attn_kind: str = "full"     # full | swa (sliding window)
    window: int = 0             # swa / local-attention window
    rope_theta: float = 1e6
    # layer pattern (hybrid archs): tuple of block kinds, tiled over layers
    layer_pattern: Tuple[str, ...] = ()   # e.g. ("rglru","rglru","local")
    # moe ---------------------------------------------------------------------
    n_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0           # per-routed-expert hidden dim
    n_shared_experts: int = 0   # qwen2-moe style shared experts
    moe_cap_factor: float = 1.25  # dispatch capacity factor (dropping MoE)
    # enc-dec (whisper) -------------------------------------------------------
    is_encoder_decoder: bool = False
    n_encoder_layers: int = 0
    encoder_seq: int = 1500     # whisper frame count after conv (stub input)
    # frontend stub -----------------------------------------------------------
    frontend: str = "none"      # none | audio_stub | vision_stub
    n_patches: int = 256        # vlm stub patch count
    # misc --------------------------------------------------------------------
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    subquadratic: bool = False  # eligible for long_500k
    rwkv_head_size: int = 64

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // max(1, self.n_heads))

    @property
    def padded_vocab(self) -> int:
        """Vocab padded so TP sharding divides evenly (loss masks the pad)."""
        return _pad_to(self.vocab, 128)

    @property
    def pattern(self) -> Tuple[str, ...]:
        """Per-layer block kinds, length n_layers."""
        if not self.layer_pattern:
            return ("attn",) * self.n_layers
        reps = (self.n_layers + len(self.layer_pattern) - 1) // len(self.layer_pattern)
        return (self.layer_pattern * reps)[: self.n_layers]

    @property
    def n_rwkv_heads(self) -> int:
        return self.d_model // self.rwkv_head_size

    # -- parameter counting (roofline MODEL_FLOPS) ----------------------------
    def param_count(self, active_only: bool = False) -> int:
        d, dff, v = self.d_model, self.d_ff, self.padded_vocab
        hd, nh, nkv = self.head_dim, self.n_heads, self.n_kv_heads
        attn = d * hd * nh + 2 * d * hd * nkv + hd * nh * d
        mlp_dense = 3 * d * dff
        n = 0
        for kind in self.pattern:
            if kind in ("attn", "local"):
                n += attn
            elif kind == "rglru":
                # gated linear recurrent block: in/out proj + conv + gates
                n += 2 * d * d + 4 * d + 3 * d
            elif kind == "rwkv":
                n += 4 * d * d + d * d  # r,k,v,o,g projections (lora-ish extras small)
            if self.n_experts:
                per_exp = 3 * d * self.moe_d_ff
                if active_only:
                    n += per_exp * self.top_k + d * self.n_experts
                else:
                    n += per_exp * self.n_experts + d * self.n_experts
                if self.n_shared_experts:
                    n += 3 * d * (self.moe_d_ff * self.n_shared_experts)
            elif kind in ("attn", "local"):
                n += mlp_dense
            elif kind in ("rglru", "rwkv"):
                n += mlp_dense if kind == "rglru" else 2 * d * dff
            n += 2 * d  # norms
        n += v * d  # embedding
        if not self.tie_embeddings:
            n += v * d
        if self.is_encoder_decoder:
            enc_layer = attn + mlp_dense + 2 * d
            n += self.n_encoder_layers * enc_layer
            n += self.n_layers * (attn + 2 * d)  # cross-attention blocks
        return n
