"""Configurations: the 10 model architectures with their assigned input
shapes, and the paper's own MITHRIL settings.

The architecture registry is a copy of the reference's (``ARCHS``,
``SHAPES``, ``get_config``, ``cell_enabled``, ``all_cells``,
``reduced_config``); the architectures are data, so all 10 are here,
including the families whose blocks the port does not run yet
(``models.lm`` raises for those).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

from .base import ModelConfig
from . import (internvl2_1b, llama3_2_3b, mixtral_8x7b, qwen1_5_110b,
               qwen2_5_14b, qwen2_7b, qwen2_moe_a2_7b, recurrentgemma_9b,
               rwkv6_1_6b, whisper_medium)
from .mithril_paper import PAPER_MITHRIL, SUITE_MITHRIL, paper_sim

ARCHS: Dict[str, ModelConfig] = {
    m.CONFIG.name: m.CONFIG
    for m in (qwen2_5_14b, qwen2_7b, llama3_2_3b, qwen1_5_110b,
              recurrentgemma_9b, rwkv6_1_6b, whisper_medium,
              mixtral_8x7b, qwen2_moe_a2_7b, internvl2_1b)
}


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


def get_config(arch: str) -> ModelConfig:
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(ARCHS)}")
    return ARCHS[arch]


def cell_enabled(cfg: ModelConfig, shape: ShapeSpec) -> Tuple[bool, str]:
    """Whether (arch x shape) is a live dry-run cell."""
    if shape.name == "long_500k" and not cfg.subquadratic:
        return False, "full quadratic attention; long_500k skipped per spec"
    return True, ""


def all_cells():
    """Yield (arch, shape, enabled, reason) for the full 40-cell table."""
    for arch, cfg in ARCHS.items():
        for shape in SHAPES.values():
            on, why = cell_enabled(cfg, shape)
            yield arch, shape, on, why


def reduced_config(cfg: ModelConfig) -> ModelConfig:
    """Tiny same-family variant for CPU smoke tests."""
    kw = dict(
        n_layers=min(cfg.n_layers, 4 if not cfg.layer_pattern
                     else len(cfg.layer_pattern) + 1),
        d_model=128, n_heads=4 if cfg.n_heads else 0,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads else 0,
        d_ff=256, vocab=512, head_dim=32 if cfg.n_heads else 0,
        window=min(cfg.window, 64) if cfg.window else 0,
        encoder_seq=24, n_patches=8, rwkv_head_size=32,
    )
    if cfg.n_experts:
        kw.update(n_experts=min(cfg.n_experts, 8),
                  top_k=min(cfg.top_k, 2), moe_d_ff=64,
                  moe_cap_factor=8.0)   # dropless at smoke-test scale
    if cfg.is_encoder_decoder:
        kw.update(n_encoder_layers=2)
    return dataclasses.replace(cfg, **kw)


__all__ = ["ARCHS", "SHAPES", "ModelConfig", "ShapeSpec", "all_cells",
           "cell_enabled", "get_config", "reduced_config",
           "PAPER_MITHRIL", "SUITE_MITHRIL", "paper_sim"]
