"""qwen2-moe-a2.7b [moe] — 60 routed experts top-4 + 4 shared experts.
[hf:Qwen/Qwen1.5-MoE-A2.7B; hf]
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b", family="moe",
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=5632, vocab=151936, qkv_bias=True,
    n_experts=60, top_k=4, moe_d_ff=1408, n_shared_experts=4,
)
