"""One rank of the port's distributed CPU checks (``test_torch_dist.py``).

Started by ``multiprocessing`` (spawn) once per rank; the ranks meet in
a gloo group through a ``FileStore`` in the test's temporary directory,
run every collective check there, and each writes what it measured to
``rank<r>.json`` (and rank 0 its MoE outputs to ``moe_out.npz``) for the
test to judge. Imports no JAX: the reference's inputs and outputs come
in through files the test wrote.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

LLAMA = "llama3.2-3b"
MIXTRAL = "mixtral-8x7b"


def _mesh(world: int, shape):
    from torch.distributed.device_mesh import DeviceMesh
    return DeviceMesh("cpu", torch.arange(world).reshape(shape),
                      mesh_dim_names=("data", "model"))


def _moe(tmp: str, mesh) -> dict:
    """TP and EP on each MoE architecture's inputs, against the port's
    dense path (and EP again at the configs' capacity factor 1.25 and at
    0.5, where tokens drop); rank 0 keeps the outputs for the test."""
    from repro_torch.dist import moe_ffn_ep, moe_ffn_tp
    from repro_torch.dist.ctx import sharding_ctx
    from repro_torch.models.moe import moe_ffn
    out, arrays = {}, {}
    with np.load(os.path.join(tmp, "moe_in.npz")) as z:
        data = {k: z[k] for k in z.files}
    for arch in ("mixtral", "qwen2moe"):
        p = {k.split("/", 1)[1]: torch.from_numpy(v) for k, v in data.items()
             if k.startswith(arch + "/")}
        p = {k: (v if k == "router" else v.bfloat16()) for k, v in p.items()}
        x = torch.from_numpy(data[f"x/{arch}"]).bfloat16()
        kw = dict(n_experts=int(data[f"E/{arch}"]), top_k=int(
            data[f"K/{arch}"]), cap_factor=4.0)
        dense = moe_ffn(p, x, **kw)
        for name, impl, cap in (("tp", moe_ffn_tp, 4.0),
                                ("ep", moe_ffn_ep, 4.0),
                                ("ep1.25", moe_ffn_ep, 1.25),
                                ("ep0.5", moe_ffn_ep, 0.5)):
            with sharding_ctx(mesh):
                got = impl(p, x, **dict(kw, cap_factor=cap))
            out[f"{arch}/{name}"] = {
                "idx_equal_dense": bool(torch.equal(got[2], dense[2])),
                "logits_err_dense": float((got[1] - dense[1]).abs().max())}
            for i, t in enumerate(got):
                arrays[f"{arch}/{name}/{i}"] = t.float().numpy()
        arrays[f"{arch}/dense/0"] = dense[0].float().numpy()
    if dist.get_rank() == 0:
        np.savez(os.path.join(tmp, "moe_out.npz"), **arrays)
    return out


def _model_ctx(tmp: str, mesh) -> dict:
    """The reduced two-layer mixtral's training loss with no context and
    under one (plain tensors: the MoE layers take the TP path)."""
    from repro_torch.configs import ARCHS, reduced_config
    from repro_torch.dist.ctx import sharding_ctx
    from repro_torch.models import lm
    cfg = dataclasses.replace(reduced_config(ARCHS[MIXTRAL]), n_layers=2,
                              layer_pattern=("attn",))
    model = lm.CausalLM(cfg, device="cpu")
    model.load_state_dict(torch.load(os.path.join(tmp, "mixtral.pt")))
    tokens = torch.from_numpy(np.load(os.path.join(tmp, "mixtral_tok.npy")))
    batch = {"tokens": tokens, "labels": tokens}
    plain = float(lm.forward_train(cfg, model, batch)[0])
    with sharding_ctx(mesh):
        under = float(lm.forward_train(cfg, model, batch)[0])
    return {"plain": plain, "ctx": under}


def _psum(mesh) -> dict:
    """compressed_psum over the whole group and over the mesh's data
    axis, against the int8 sum made from every rank's input."""
    from repro_torch.runtime.compress import compressed_psum, quantize_int8
    world, rank = dist.get_world_size(), dist.get_rank()
    xs = [torch.from_numpy(np.random.default_rng(100 + r).standard_normal(
        257).astype(np.float32)) for r in range(world)]
    out = {}
    for name, group, members in (
            ("world", dist.group.WORLD, range(world)),
            ("data", (mesh, "data"),
             [int(r) for r in mesh.mesh[:, mesh.get_local_rank("model")]])):
        got = compressed_psum(xs[rank], group)
        qs = [quantize_int8(xs[r]) for r in members]
        total = sum(q.to(torch.int32) for q, _ in qs)
        want = total.float() * max(float(s) for _, s in qs)
        out[name] = float((got - want).abs().max())
    return out


def _llama(tmp: str):
    from repro_torch.configs import ARCHS, reduced_config
    from repro_torch.models import lm
    cfg = dataclasses.replace(reduced_config(ARCHS[LLAMA]), n_layers=2)
    model = lm.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    return cfg, model


def _cells(tmp: str, mesh) -> dict:
    """``jit_cell``'s train, prefill and decode steps against the plain
    steps on the same weights and inputs."""
    import copy
    from repro_torch.launch.steps import jit_cell, make_train_fn
    from repro_torch.models import lm
    from repro_torch.optim import adamw
    cfg, model = _llama(tmp)
    rng = np.random.default_rng(7)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (4, 33)).astype(
        np.int32))
    batch = {"tokens": tokens[:, :32], "labels": tokens[:, 1:]}
    out = {}

    plain = copy.deepcopy(model).requires_grad_()
    cell = copy.deepcopy(model).requires_grad_()
    opt_cfg = adamw.AdamWConfig(warmup_steps=1)
    opt_p = adamw.init(dict(plain.named_parameters()))
    opt_c = adamw.init(dict(cell.named_parameters()))
    _, _, mp = make_train_fn(cfg, opt_cfg)(plain, opt_p, batch)
    step, _ = jit_cell(mesh, {"cfg": cfg, "kind": "train", "params": cell,
                              "opt_state": opt_c, "batch": batch},
                       opt_cfg=opt_cfg)
    cell, opt_c, mc = step(cell, opt_c, batch)
    got = dict(cell.named_parameters())
    out["train"] = {
        "loss": [float(mp["loss"]), float(mc["loss"])],
        "grad_norm": [float(mp["grad_norm"]), float(mc["grad_norm"])],
        "param_err": max(float((got[n].detach().full_tensor().float()
                                - p.detach().float()).abs().max())
                         for n, p in plain.named_parameters()),
        "placed": all(type(p).__name__ == "DTensor"
                      for p in cell.parameters()),
        "step": int(opt_c.step)}

    ref = copy.deepcopy(model)
    served = copy.deepcopy(model)
    pf = {"tokens": tokens[:, :32]}
    want, cache_p = lm.prefill(cfg, ref, pf, pad_to=33)
    step, _ = jit_cell(mesh, {"cfg": cfg, "kind": "prefill",
                              "params": served, "batch": pf})
    got, _ = step(served, pf)
    out["prefill"] = [got.full_tensor().tolist(), want.tolist()]
    pos = torch.full((4,), 32, dtype=torch.int32)
    want, _ = lm.decode_step(cfg, ref, cache_p, tokens[:, 32], pos)
    cache = lm.init_cache(cfg, 4, 33, device="cpu")
    _, cache_d = lm.prefill(cfg, ref, pf, pad_to=33)
    for g, gd in zip(cache, cache_d):
        for u in g:
            for n in g[u]:
                g[u][n].copy_(gd[u][n])
    step, _ = jit_cell(mesh, {"cfg": cfg, "kind": "decode",
                              "params": served, "cache": cache,
                              "token": tokens[:, 32], "pos": pos})
    got, cache = step(served, cache, tokens[:, 32], pos)
    out["decode_err"] = float((got.full_tensor() - want).abs().max())
    out["decode_cache_err"] = float(
        (cache[0]["u0"]["k"].full_tensor().float()
         - cache_p[0]["u0"]["k"].float()).abs().max())
    return out


def _restore(tmp: str, mesh) -> dict:
    """A checkpoint restored onto the mesh (``restore(shardings=)``) is
    the saved state, each leaf a DTensor placed by the rules."""
    from repro_torch.checkpoint import CheckpointManager, elastic
    _, model = _llama(tmp)
    state = {n: p.detach() for n, p in model.named_parameters()}
    ck = CheckpointManager(os.path.join(tmp, "ck"))
    if dist.get_rank() == 0:
        ck.save(3, state)
    dist.barrier()
    step, got = ck.restore(state, shardings=elastic.reshard_state(state,
                                                                  mesh))
    plan = elastic.plan_remesh(state, (1, 1), mesh)
    # a (chunk, lanes) slab staged lane-last over the data axis
    from repro_torch.dist.sharding import ring_put
    slab = torch.arange(6 * 8, dtype=torch.int32).reshape(6, 8)
    ring = ring_put({"b": slab}, mesh, axis="data")["b"]
    return {"step": step,
            "ring_equal": bool(torch.equal(ring.full_tensor(), slab)),
            "ring_local": list(ring.to_local().shape),
            "equal": all(torch.equal(got[n].full_tensor(), t)
                         for n, t in state.items()),
            "sharded_leaves": sum(any(p.is_shard() for p in got[n].placements)
                                  for n in state),
            "plan": plan}


def main(rank: int, world: int, tmp: str, shape) -> None:
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))
    torch.set_num_threads(1)
    store = dist.FileStore(os.path.join(tmp, "store"), world)
    dist.init_process_group("gloo", store=store, rank=rank,
                            world_size=world)
    try:
        mesh = _mesh(world, shape)
        res = {"moe": _moe(tmp, mesh), "model_ctx": _model_ctx(tmp, mesh),
               "psum": _psum(mesh), "cells": _cells(tmp, mesh),
               "restore": _restore(tmp, mesh)}
        with open(os.path.join(tmp, f"rank{rank}.json"), "w") as f:
            json.dump(res, f)
    finally:
        dist.destroy_process_group()


def dryrun_main(tmp: str) -> None:
    """The dry run of reduced llama3.2-3b train and prefill cells on a
    fake 8-rank (2, 4) mesh; writes ``dryrun.json``."""
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))
    from repro_torch.configs import ARCHS, ShapeSpec, reduced_config
    from repro_torch.launch import dryrun, specs
    from repro_torch.roofline import model_flops
    torch.set_num_threads(2)
    dryrun.init_fake_group(8)
    mesh = _mesh(8, (2, 4))
    cfg = reduced_config(ARCHS[LLAMA])
    specs.get_config = lambda _: cfg
    out = {}
    for shape in (ShapeSpec("t", 256, 16, "train"),
                  ShapeSpec("p", 256, 16, "prefill")):
        c = dryrun.count_cell(mesh, specs.input_specs(LLAMA, shape))
        c["model_flops"] = model_flops(cfg, shape.kind, shape.global_batch,
                                       shape.seq_len)
        out[shape.kind] = c
    with open(os.path.join(tmp, "dryrun.json"), "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()
