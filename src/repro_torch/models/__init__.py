"""Models of the port: the causal language model of the attention
families (``lm``: dense, GQA/SWA and MoE transformers, forward only)
and the learned cache policy's training-time heads (``policy_head``)."""

from . import policy_head
from .lm import (CausalLM, decode_step, forward, forward_train, init_cache,
                 init_params, layer_groups, prefill, serve_step)
from .policy_head import PolicyHead

__all__ = ["policy_head", "PolicyHead", "CausalLM", "decode_step",
           "forward", "forward_train", "init_cache", "init_params",
           "layer_groups", "prefill", "serve_step"]
