"""End-to-end training driver.

Runs real steps on the device (the card unless ``device="cpu"``):
reduced configurations by default, the published widths with
``--full``. Wired in as in the reference: the synthetic data pipeline,
AdamW (in place), remat, async checkpointing with resume from the
latest step, optional int8 gradient compression, straggler policy
bookkeeping.

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-3b \\
        --steps 50 --batch 8 --seq 128 --device cpu
"""

from __future__ import annotations

import argparse
import time
from typing import Optional

import torch

from ..checkpoint import CheckpointManager
from ..configs import get_config, reduced_config
from ..data import DataConfig, SyntheticPipeline
from ..kernels.backend import resolve_device
from ..models.lm import CausalLM, RunFlags, init_params
from ..optim import adamw
from ..runtime import StragglerPolicy
from .steps import make_train_fn as make_train_step


def train_batch(cfg, data: SyntheticPipeline, step: int, batch: int,
                seq: int, dev: torch.device) -> dict:
    """Step ``step``'s batch on ``dev``: the pipeline's tokens and labels,
    with the encoder-decoder's frames and the vision stub's patches
    (ones, bf16), whose positions come first and cut the tokens."""
    b = data.batch(step, dev)
    out = {"tokens": b["tokens"], "labels": b["labels"]}
    if cfg.is_encoder_decoder:
        out["frames"] = torch.ones((batch, cfg.encoder_seq, cfg.d_model),
                                   dtype=torch.bfloat16, device=dev)
    if cfg.frontend == "vision_stub":
        npatch = cfg.n_patches
        out["tokens"] = out["tokens"][:, :seq - npatch]
        out["patches"] = torch.ones((batch, npatch, cfg.d_model),
                                    dtype=torch.bfloat16, device=dev)
    return out


def train(arch: str, *, steps: int = 50, batch: int = 8, seq: int = 128,
          reduced: bool = True, ckpt_dir: str = "results/ckpt",
          ckpt_every: int = 20, compress: bool = False,
          resume: bool = True, log_every: int = 10, seed: int = 0,
          device=None, flags: RunFlags = RunFlags(remat="full"),
          init: Optional[CausalLM] = None) -> dict:
    """Train ``arch`` for ``steps`` steps on ``device`` (None: the card).

    The weights come from a generator on the device seeded with
    ``seed``, or are ``init`` (a ``CausalLM`` of the configuration, moved
    to the device and trained in place). Returns the reference's dict
    (``losses``, ``final_loss``, ``readahead_hits``) with each step's
    ``grad_norms`` and ``step_seconds`` (host clock from the batch to
    the loss read, which waits for the step)."""
    dev = resolve_device(device)
    cfg = get_config(arch)
    if reduced:
        cfg = reduced_config(cfg)
    if init is None:
        model = init_params(cfg, torch.Generator(device=dev).manual_seed(
            seed), device=dev)
    else:
        model = init.to(dev)
    model.requires_grad_(True)
    params = dict(model.named_parameters())
    opt_cfg = adamw.AdamWConfig(total_steps=steps,
                                warmup_steps=max(2, steps // 10))
    opt_state = adamw.init(params)
    data = SyntheticPipeline(DataConfig(vocab=cfg.vocab, seq_len=seq,
                                        global_batch=batch, seed=seed))
    step_fn = make_train_step(cfg, opt_cfg, flags, compress)

    ckpt = CheckpointManager(ckpt_dir)
    start = 0
    if resume and ckpt.latest_step() is not None:
        start, (saved, opt_state) = ckpt.restore((params, opt_state))
        with torch.no_grad():
            for name, p in params.items():
                p.copy_(saved[name])
        del saved
        print(f"resumed from step {start}")

    straggler = StragglerPolicy()
    losses, gnorms, seconds = [], [], []
    try:
        for step in range(start, steps):
            t0 = time.perf_counter()
            batch_dev = train_batch(cfg, data, step, batch, seq, dev)
            model, opt_state, metrics = step_fn(model, opt_state, batch_dev)
            loss = float(metrics["loss"])
            dt = time.perf_counter() - t0
            straggler.observe(dt)
            losses.append(loss)
            gnorms.append(float(metrics["grad_norm"]))
            seconds.append(dt)
            if step % log_every == 0 or step == steps - 1:
                print(f"step {step:5d} loss {loss:.4f} "
                      f"gnorm {gnorms[-1]:.3f} "
                      f"lr {float(metrics['lr']):.2e} {dt*1e3:.0f}ms")
            if (step + 1) % ckpt_every == 0:
                ckpt.save_async(step + 1, (params, opt_state),
                                {"arch": arch, "loss": loss})
    finally:
        ckpt.wait()           # a pending checkpoint is complete on exit
    return {"losses": losses, "final_loss": losses[-1] if losses else None,
            "readahead_hits": data.readahead_hits, "grad_norms": gnorms,
            "step_seconds": seconds}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-3b")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false",
                    help="the published widths")
    ap.add_argument("--compress", action="store_true")
    ap.add_argument("--ckpt-dir", default="results/ckpt")
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    a = ap.parse_args(argv)
    out = train(a.arch, steps=a.steps, batch=a.batch, seq=a.seq,
                reduced=a.reduced, compress=a.compress, ckpt_dir=a.ckpt_dir,
                ckpt_every=a.ckpt_every, seed=a.seed, device=a.device)
    print(f"final loss: {out['final_loss']:.4f}")
    return out


if __name__ == "__main__":
    main()
