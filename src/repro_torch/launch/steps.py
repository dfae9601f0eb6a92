"""Step builders on the port's model: a training step, a prefill and a
decode step, as plain functions, and :func:`jit_cell`, the step of one
(arch x shape) cell with the reference's shardings attached.

A training step writes in place: it zeroes the gradients (to None),
runs ``forward_train`` and its backward, optionally passes the
gradients through ``runtime.fake_quant_grads``, and steps AdamW in place
(``optim.adamw.update_``). Weight decay follows the reference's rule on
the reference's parameter paths (:func:`lm_decay`): in its layout every
block parameter sits under a ``u<j>`` unit, so only the embedding and
an untied head decay.
"""

from __future__ import annotations

from typing import Dict, Optional

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


def make_prefill_fn(cfg: ModelConfig,
                    flags: RunFlags = RunFlags(remat="none")):
    @torch.no_grad()
    def prefill_step(model, batch):
        return prefill(cfg, model, batch, flags)
    return prefill_step


def make_serve_fn(cfg: ModelConfig):
    @torch.no_grad()
    def serve_step(model, cache, token, pos):
        return decode_step(cfg, model, cache, token, pos)
    return serve_step


# ---------------------------------------------------------------------------
# cells on a mesh
# ---------------------------------------------------------------------------

def place_model(model: torch.nn.Module, named: Dict[str, list], mesh
                ) -> torch.nn.Module:
    """Every parameter of ``model`` replaced, in place, by a DTensor
    parameter with the placements ``named[name]`` (a parameter already
    placed so is kept); returns ``model``."""
    from ..dist.local import is_dtensor
    from ..dist.sharding import place
    for name, prm in list(model.named_parameters()):
        if is_dtensor(prm) and list(prm.placements) == list(named[name]):
            continue
        mod_name, _, leaf = name.rpartition(".")
        mod = model.get_submodule(mod_name) if mod_name else model
        mod._parameters[leaf] = torch.nn.Parameter(
            place(prm.detach(), mesh, named[name]),
            requires_grad=prm.requires_grad)
    return model


def _replicated(x):
    """A DTensor as its full value on every rank; anything else as is."""
    from ..dist.local import is_dtensor
    return x.full_tensor() if is_dtensor(x) else x


def jit_cell(mesh, specs, *, strategy: str = "fsdp",
             opt_cfg: Optional[adamw.AdamWConfig] = None,
             flags: RunFlags = RunFlags(), donate: bool = True):
    """The step of one (arch x shape) cell under ``mesh`` (a
    ``DeviceMesh``), with the reference's shardings attached.

    Returns ``(step_fn, abstract_args)``: ``specs`` is
    ``launch.specs.input_specs``'s dict (its tensors may be real or on
    ``meta``), and ``abstract_args`` are its inputs in the step's order.
    PyTorch has no jit: the step places its inputs by the spec rules
    (``dist.sharding``) as DTensors, runs ``make_train_fn`` /
    ``make_prefill_fn`` / ``make_serve_fn`` inside ``sharding_ctx`` with
    ``dist.local.ShardwiseOps`` as its dispatch (the model's products,
    attention and lookups run shard by shard) and under implicit
    replication (the model's own constants are the same on every rank),
    and gives its outputs the reference's placements:
    the logits ``(dp, "model")``, the cache by ``cache_specs``, the
    metrics replicated (plain tensors). Parameters are placed in the
    model in place, and the cache's tensors as new DTensors; decode
    under ``fsdp`` becomes ``tp_serve`` (inference keeps weights
    resident per TP shard). ``donate`` is accepted for the reference's
    signature: the train step updates its state in place either way
    (``optim.adamw.update_``), and decode writes the cache in place.
    """
    from torch.distributed.tensor.experimental import implicit_replication

    from ..dist import sharding as shd
    from ..dist.ctx import sharding_ctx
    from ..dist.local import ShardwiseOps
    from .mesh import dp_axes_of

    cfg, kind = specs["cfg"], specs["kind"]
    if kind == "decode" and strategy == "fsdp":
        strategy = "tp_serve"   # inference TP: no per-layer weight gathers
    pspec = shd.param_specs(specs["params"], mesh, strategy)
    psh = shd.to_named(pspec, mesh)
    ctx_kw = dict(dp_axes=dp_axes_of(mesh), tp_axis="model",
                  dispatch=ShardwiseOps)

    def logits_placed(logits, b: int):
        bsp = shd.batch_specs({"t": torch.empty((b,), device="meta")},
                              mesh)["t"]
        spec = (bsp[0],) + (None,) * (logits.dim() - 2) + ("model",)
        return shd.place(logits, mesh, shd.placements(spec, mesh))

    if kind == "train":
        fn = make_train_fn(cfg, opt_cfg or adamw.AdamWConfig(), flags)

        def train_step(model, opt_state, batch):
            place_model(model, psh, mesh)
            osh = shd.to_named(shd.opt_specs(opt_state, pspec, mesh), mesh)
            opt_state = opt_state._replace(**{   # the step stays on the host
                f: shd.place_tree(getattr(opt_state, f), getattr(osh, f),
                                  mesh) for f in ("master", "m", "v")})
            batch = shd.place_tree(
                batch, shd.to_named(shd.batch_specs(batch, mesh), mesh),
                mesh)
            with sharding_ctx(mesh, **ctx_kw), implicit_replication():
                model, opt_state, metrics = fn(model, opt_state, batch)
            return model, opt_state, {k: _replicated(v)
                                      for k, v in metrics.items()}
        return train_step, (specs["params"], specs["opt_state"],
                            specs["batch"])

    if kind == "prefill":
        fn = make_prefill_fn(cfg, RunFlags(remat="none"))

        def prefill_step(model, batch):
            place_model(model, psh, mesh)
            batch = shd.place_tree(
                batch, shd.to_named(shd.batch_specs(batch, mesh), mesh),
                mesh)
            with sharding_ctx(mesh, **ctx_kw), implicit_replication():
                logits, cache = fn(model, batch)
            cache = shd.place_tree(
                cache, shd.to_named(shd.cache_specs(cache, mesh), mesh),
                mesh)
            return logits_placed(logits, logits.shape[0]), cache
        return prefill_step, (specs["params"], specs["batch"])

    if kind == "decode":
        fn = make_serve_fn(cfg)

        def decode_step_(model, cache, token, pos):
            place_model(model, psh, mesh)
            cache = shd.place_tree(
                cache, shd.to_named(shd.cache_specs(cache, mesh), mesh),
                mesh)
            tsh = shd.to_named(shd.batch_specs(token, mesh), mesh)
            token, pos = (shd.place(t, mesh, tsh) for t in (token, pos))
            with sharding_ctx(mesh, **ctx_kw), implicit_replication():
                logits, cache = fn(model, cache, token, pos)
            return logits_placed(logits, logits.shape[0]), cache
        return decode_step_, (specs["params"], specs["cache"],
                              specs["token"], specs["pos"])

    raise ValueError(kind)
