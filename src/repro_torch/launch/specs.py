"""Abstract inputs for every (arch x shape) cell, on the ``meta`` device.

No storage anywhere: the model, its optimizer state and its cache are
built on ``meta`` by the same constructors the runtime calls (the
reference's ``jax.eval_shape`` over its init functions), so a step run
on them (the dry run) executes what the runtime would, shapes only.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from ..configs import ShapeSpec, get_config
from ..configs.base import ModelConfig
from ..models.lm import CausalLM, init_cache
from ..optim import adamw

META = torch.device("meta")


def _sds(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def batch_sds(cfg: ModelConfig, batch: int, seq: int) -> Dict[str, Any]:
    spec: Dict[str, Any] = {}
    s_text = seq
    if cfg.frontend == "vision_stub":
        s_text = seq - cfg.n_patches
        spec["patches"] = _sds((batch, cfg.n_patches, cfg.d_model),
                               torch.bfloat16)
    if cfg.is_encoder_decoder:
        spec["frames"] = _sds((batch, cfg.encoder_seq, cfg.d_model),
                              torch.bfloat16)
    spec["tokens"] = _sds((batch, s_text), torch.int32)
    spec["labels"] = _sds((batch, seq), torch.int32)
    return spec


def params_sds(cfg: ModelConfig) -> CausalLM:
    """The model with every parameter on ``meta``."""
    return CausalLM(cfg, device=META)


def opt_sds(cfg: ModelConfig, params: CausalLM = None) -> adamw.OptState:
    """AdamW's state of ``params`` (default: :func:`params_sds`) on
    ``meta``; the step count is a host scalar, as in training."""
    params = params_sds(cfg) if params is None else params
    return adamw.init(dict(params.named_parameters()))


def cache_sds(cfg: ModelConfig, batch: int, max_len: int) -> list:
    return init_cache(cfg, batch, max_len, device=META)


def input_specs(arch: str, shape: ShapeSpec) -> Dict[str, Any]:
    """All abstract inputs for the cell's step function."""
    cfg = get_config(arch)
    b, s = shape.global_batch, shape.seq_len
    out: Dict[str, Any] = {"cfg": cfg, "kind": shape.kind,
                           "params": params_sds(cfg)}
    if shape.kind == "train":
        out["batch"] = batch_sds(cfg, b, s)
        out["opt_state"] = opt_sds(cfg, out["params"])
    elif shape.kind == "prefill":
        out["batch"] = {k: v for k, v in batch_sds(cfg, b, s).items()
                        if k != "labels"}
    elif shape.kind == "decode":
        out["cache"] = cache_sds(cfg, b, s)
        out["token"] = _sds((b,), torch.int32)
        out["pos"] = _sds((b,), torch.int32)
    return out
