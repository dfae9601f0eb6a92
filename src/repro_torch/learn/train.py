"""Offline training for the learned admission/eviction policy.

    python -m repro_torch.learn.train [--scale quick] [--steps 400]

Counterpart of ``repro/learn/train.py``. Replay corpus-registry traces
on the host and emit one sample per request — features as the request
path would see them (recency / residency frequency / association-count
proxy / prefetch flag), label = "reused within the horizon"
(:func:`extract_features`, a copy of the reference's numpy code). Train
the ``models/policy_head.py`` heads with ``optim/adamw.py`` (fixed seed,
full batch, float32 autograd; the same bits on the CPU and the card),
freeze the float32 weights into the hashable tuples
``learn.policy.LearnedConfig`` carries, and print them as Python
literals.

The frozen ``DEFAULT_LOGREG`` / ``DEFAULT_MLP`` stay the reference's
checked-in constants: the port's initial draws come from a
``torch.Generator`` and cannot equal ``jax.random``'s, so a run of this
module is comparable with the reference's only from the same initial
parameters (``train_head(..., init=convert.policy_head_from(...))``).

Offline/online feature deviations (as the reference's): the
association count is a support proxy (re-occurrences within the
lookahead window) rather than the live MITHRIL table count, and the
prefetch flag is always 0 offline — its weight stays at initialization.
"""

from __future__ import annotations

import argparse
from typing import Dict, List, Mapping, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..kernels.backend import resolve_device
from .policy import (ASSOC_CAP, FREQ_CAP, RECENCY_CAP, LearnedConfig,
                     params_to_weights)

DEFAULT_HORIZON = 1024      # reuse-within-horizon label (≈ 2x cache capacity)
DEFAULT_LOOKAHEAD = 100     # association-proxy window (paper Delta)


def extract_features(blocks: np.ndarray, lengths: np.ndarray,
                     horizon: int = DEFAULT_HORIZON,
                     lookahead: int = DEFAULT_LOOKAHEAD,
                     stride: int = 1) -> Tuple[np.ndarray, np.ndarray]:
    """(X, y) training samples from a padded (B, T) trace batch.

    Feature normalization matches ``learn.policy.features``
    exactly (power-of-two cap + scale), so trained weights transfer to
    the request path without recalibration.
    """
    xs, ys = [], []
    for t in range(blocks.shape[0]):
        trace = np.asarray(blocks[t, : int(lengths[t])], np.int64)
        n = len(trace)
        if n < 2:
            continue
        # next-occurrence distance via one reversed pass
        next_gap = np.full((n,), RECENCY_CAP, np.int64)
        seen: Dict[int, int] = {}
        for i in range(n - 1, -1, -1):
            blk = int(trace[i])
            if blk in seen:
                next_gap[i] = seen[blk] - i
            seen[blk] = i
        last: Dict[int, int] = {}
        freq: Dict[int, int] = {}
        assoc: Dict[int, int] = {}
        for i in range(0, n, stride):
            blk = int(trace[i])
            rec = i - last.get(blk, i - RECENCY_CAP)
            fr = freq.get(blk, 0)
            ac = assoc.get(blk, 0)
            xs.append((min(max(rec, 0), RECENCY_CAP) / RECENCY_CAP,
                       min(fr, FREQ_CAP) / FREQ_CAP,
                       min(ac, ASSOC_CAP) / ASSOC_CAP,
                       0.0))
            ys.append(1.0 if next_gap[i] <= horizon else 0.0)
            freq[blk] = fr + 1
            if blk in last and rec <= lookahead:
                assoc[blk] = ac + 1       # sporadic-support proxy
            last[blk] = i
    x = np.asarray(xs, np.float32)
    y = np.asarray(ys, np.float32)
    return x, y


def train_head(kind: str, x: np.ndarray, y: np.ndarray, *,
               steps: int = 400, seed: int = 0, lr: float = 0.05,
               init: Optional[Mapping[str, object]] = None,
               device=None) -> Tuple[Dict[str, torch.Tensor], List[float]]:
    """AdamW full-batch training on ``device`` (None: the card); returns
    (params as CPU float32 tensors, loss trajectory).

    The initial parameters are ``init`` (arrays or tensors keyed as the
    head's), else drawn from a CPU ``torch.Generator`` seeded with
    ``seed``, so every device starts from the same values. The losses
    stay on the device until the last step. The head has no matmul
    (``models/policy_head.py``), so TF32 cannot enter.
    """
    from ..models import policy_head
    from ..optim import adamw

    dev = resolve_device(device)
    if init is None:
        init = policy_head.init_params(
            kind, generator=torch.Generator().manual_seed(seed))
    head = policy_head.PolicyHead(kind, dict(init)).to(dev)
    cfg = adamw.AdamWConfig(lr=lr, weight_decay=0.0, clip_norm=1.0,
                            warmup_steps=max(1, steps // 20),
                            total_steps=steps)
    opt = adamw.AdamW(head, cfg)
    xt = torch.as_tensor(np.asarray(x, np.float32), device=dev)
    yt = torch.as_tensor(np.asarray(y, np.float32), device=dev)
    losses = []
    for _ in range(steps):
        opt.zero_grad(set_to_none=True)
        loss = head.loss(xt, yt)
        loss.backward()
        opt.step()
        losses.append(loss.detach())
    trajectory = (torch.stack(losses).cpu().tolist() if losses else [])
    return ({k: p.detach().cpu() for k, p in head.named_parameters()},
            trajectory)


class TrainedHead(NamedTuple):
    config: LearnedConfig
    params: Dict[str, torch.Tensor]     # float32, on the CPU
    losses: List[float]                 # one per step, before its update
    samples: int


def train_heads(scale: str = "quick", trace_len: int = 4000, *,
                steps: int = 400, seed: int = 0, stride: int = 4,
                device=None) -> Dict[str, TrainedHead]:
    """Train both heads on the corpus registry slice on ``device``."""
    from ..traces import build_corpus, corpus_specs
    from ..traces.synthetic import stack_padded

    dev = resolve_device(device)
    _, blocks, lengths = stack_padded(build_corpus(
        corpus_specs(trace_len, scale)))
    x, y = extract_features(blocks, lengths, stride=stride)
    out = {}
    for kind in ("logreg", "mlp"):
        params, losses = train_head(kind, x, y, steps=steps, seed=seed,
                                    device=dev)
        out[kind] = TrainedHead(
            LearnedConfig(kind=kind,
                          weights=params_to_weights(kind, params)),
            params, losses, len(x))
        print(f"  [train] {kind}: {len(x)} samples, "
              f"loss {losses[0]:.4f} -> {losses[-1]:.4f}")
    return out


def train_configs(scale: str = "quick", trace_len: int = 4000, *,
                  steps: int = 400, seed: int = 0, stride: int = 4,
                  device=None) -> Dict[str, LearnedConfig]:
    """Train both heads on the corpus registry slice; returns configs."""
    return {kind: head.config for kind, head in train_heads(
        scale, trace_len, steps=steps, seed=seed, stride=stride,
        device=device).items()}


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.strip().splitlines()[0])
    ap.add_argument("--scale", default="quick",
                    help="corpus registry scale to train on")
    ap.add_argument("--trace-len", type=int, default=4000)
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--stride", type=int, default=4,
                    help="sample every Nth request")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    return ap


def main(argv=None) -> None:
    a = _parser().parse_args(argv)
    cfgs = train_configs(a.scale, a.trace_len, steps=a.steps, seed=a.seed,
                         stride=a.stride, device=a.device)
    for kind, cfg in cfgs.items():
        print(f"\nDEFAULT_{kind.upper()} = {cfg.weights!r}")


if __name__ == "__main__":
    main()
