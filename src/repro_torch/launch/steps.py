"""Step builders on the port's model: a training step, a prefill and a
decode step, as plain functions (the reference's ``launch/steps.py``
without its mesh; ``jit_cell`` belongs with distribution).

A training step writes in place: it zeroes the gradients (to None),
runs ``forward_train`` and its backward, optionally passes the
gradients through ``runtime.fake_quant_grads``, and steps AdamW in place
(``optim.adamw.update_``). Weight decay follows the reference's rule on
the reference's parameter paths (:func:`lm_decay`): in its layout every
block parameter sits under a ``u<j>`` unit, so only the embedding and
an untied head decay.
"""

from __future__ import annotations

from typing import Dict

import torch

from ..configs.base import ModelConfig
from ..models.lm import RunFlags, decode_step, forward_train, prefill
from ..optim import adamw


def lm_decay(cfg: ModelConfig) -> Dict[str, bool]:
    """``{parameter name: weight decay applies}`` for a ``cfg`` model:
    ``adamw._decay_mask`` of the reference's path of each parameter (its
    pytree keys joined by ``/``, without the layer's index into its
    group's repeats)."""
    from ..convert import lm_state_names
    out = {}
    for name, path in lm_state_names(cfg).items():
        keys = path[:-1] if name.startswith(("layers.", "enc_layers.")) \
            else path
        out[name] = adamw._decay_mask("/".join(str(k) for k in keys))
    return out


def make_train_fn(cfg: ModelConfig, opt_cfg: adamw.AdamWConfig,
                  flags: RunFlags = RunFlags(), compress: bool = False):
    """``train_step(model, opt_state, batch) -> (model, opt_state,
    metrics)``: one step in place; ``metrics`` holds the loss, the MoE
    auxiliary loss, the gradient norm and the learning rate as device
    scalars (nothing is read back)."""
    decay = lm_decay(cfg)

    def train_step(model, opt_state, batch):
        params = dict(model.named_parameters())
        model.zero_grad(set_to_none=True)
        total, metrics = forward_train(cfg, model, batch, flags)
        total.backward()
        grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p))
                 for n, p in params.items()}
        del total
        if compress:
            from ..runtime import fake_quant_grads
            grads = fake_quant_grads(grads)
        opt_state, om = adamw.update_(opt_cfg, grads, opt_state, params,
                                      decay)
        model.zero_grad(set_to_none=True)
        return model, opt_state, {
            **{k: v.detach() for k, v in metrics.items()}, **om}
    return train_step


def make_prefill_fn(cfg: ModelConfig):
    @torch.no_grad()
    def prefill_step(model, batch):
        return prefill(cfg, model, batch)
    return prefill_step


def make_serve_fn(cfg: ModelConfig):
    @torch.no_grad()
    def serve_step(model, cache, token, pos):
        return decode_step(cfg, model, cache, token, pos)
    return serve_step
