"""internvl2-1b [vlm] — InternViT frontend (stub) + Qwen2-0.5B-style backbone.
[arXiv:2404.16821; hf]
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-1b", family="vlm",
    n_layers=24, d_model=896, n_heads=14, n_kv_heads=2,
    d_ff=4864, vocab=151655, qkv_bias=True,
    frontend="vision_stub", n_patches=256,
)
