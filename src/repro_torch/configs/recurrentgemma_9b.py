"""recurrentgemma-9b [hybrid] — RG-LRU + local attention, 2:1 pattern.
[arXiv:2402.19427; unverified]
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b", family="hybrid",
    n_layers=38, d_model=4096, n_heads=16, n_kv_heads=1,
    d_ff=12288, vocab=256000,
    layer_pattern=("rglru", "rglru", "local"),
    window=2048, attn_kind="swa", subquadratic=True,
)
