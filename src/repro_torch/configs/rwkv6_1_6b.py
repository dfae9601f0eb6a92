"""rwkv6-1.6b [ssm] — Finch, data-dependent decay, attention-free.
[arXiv:2404.05892; unverified]

DESIGN.md §Arch-applicability: attention-free with O(1) state, so the
paper's KV-page prefetching is inapplicable; built without it.
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-1.6b", family="ssm",
    n_layers=24, d_model=2048, n_heads=0, n_kv_heads=0,
    d_ff=7168, vocab=65536,
    layer_pattern=("rwkv",), subquadratic=True, rwkv_head_size=64,
)
