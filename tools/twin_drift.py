#!/usr/bin/env python3
"""How far the port's bf16 models drift between the card and the CPU.

    python3 tools/twin_drift.py

Needs one NVIDIA GPU (exits non-zero without one). Prints one JSON line:

* ``ops``: single operations on the same inputs on the card and on the
  CPU at recurrentgemma-9b's width (d 4,096, d_ff 12,288, 32 tokens):
  bf16 products, float32 products, the port's bf16 elementwise steps
  (``layers.gelu``, ``sigmoid``, ``silu``), ``rms_norm``, float32
  ``exp`` / ``sigmoid``; each the share of outputs that differ and the
  largest difference;
* ``residual``: the share of the residual stream that differs after each
  of recurrentgemma's first three layers (a prefill of 32 tokens);
* ``twins``: the largest teacher-forced logit difference (rtol = atol =
  5e-2, as ``chip_smoke.py``'s model phase) of depth-cut twins of
  recurrentgemma-9b with its first 1, 2 and 3 layers, and the number of
  logits outside the tolerance.

Weights come from the seeded card generator, as in ``chip_smoke.py``.
"""

from __future__ import annotations

import dataclasses
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
ARCH = "recurrentgemma-9b"


def differ(card, cpu) -> dict:
    a, b = card.float().cpu(), cpu.float()
    d = (a - b).abs()
    return {"share_differing": float((d > 0).float().mean()),
            "max_abs": float(d.max())}


def ops(dev) -> dict:
    import torch
    from repro_torch.models import layers
    g = torch.Generator().manual_seed(1)
    d, f = 4096, 12288
    x = torch.randn((1, 32, d), generator=g).bfloat16()
    w = (torch.randn((d, d), generator=g) * d ** -0.5).bfloat16()
    w_up = (torch.randn((d, f), generator=g) * d ** -0.5).bfloat16()
    h = torch.randn((1, 32, f), generator=g).bfloat16()
    w_down = (torch.randn((f, d), generator=g) * f ** -0.5).bfloat16()
    zero = torch.zeros(d).bfloat16()
    cases = {
        "bf16 product, K 4096": (lambda a, b: a @ b, x, w),
        "bf16 product, N 12288": (lambda a, b: a @ b, x, w_up),
        "bf16 product, K 12288": (lambda a, b: a @ b, h, w_down),
        "float32 product, K 4096": (lambda a, b: a.float() @ b.float(), x, w),
        "layers.gelu (bf16)": (layers.gelu, x),
        "layers.sigmoid (bf16)": (layers.sigmoid, x),
        "layers.silu (bf16)": (layers.silu, x),
        "layers.rms_norm (bf16)": (lambda a, s: layers.rms_norm(a, s, 1e-6),
                                   x, zero),
        "torch.sigmoid (float32)": (torch.sigmoid, x.float()),
        "torch.exp (float32)": (torch.exp, -x.float().abs()),
    }
    out = {}
    for name, (fn, *args) in cases.items():
        out[name] = differ(fn(*(a.to(dev) for a in args)), fn(*args))
    return out


def twin(model, first_n: int, dev):
    import torch
    from repro_torch.models import lm
    cfg = dataclasses.replace(model.cfg, n_layers=first_n,
                              layer_pattern=model.cfg.pattern[:first_n])
    keep = {k: v for k, v in model.state_dict().items()
            if not k.startswith("layers.") or int(k.split(".")[1]) < first_n}
    twins = {}
    for name, where in (("card", dev), ("cpu", "cpu")):
        t = lm.CausalLM(cfg, device="meta")
        t.load_state_dict({k: v.to(where) for k, v in keep.items()},
                          assign=True)
        twins[name] = t
    return cfg, twins


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("twin_drift: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    dev = torch.device("cuda")
    full = get_config(ARCH)
    cfg3 = dataclasses.replace(full, n_layers=3)
    model = lm.init_params(cfg3, torch.Generator(device=dev).manual_seed(0),
                           device=dev)
    tokens = np.random.default_rng(2).integers(0, full.vocab, (1, 36))
    result = {"device": torch.cuda.get_device_name(0),
              "nvidia_smi": cs.nvidia_smi(), "ops": ops(dev)}

    cfg, twins = twin(model, 3, dev)
    states = {}
    for name, where in (("card", dev), ("cpu", "cpu")):
        t = torch.as_tensor(tokens[:, :32], device=where)
        pos = lm._positions_for(cfg, {"tokens": t})
        x = lm._input_embeds(cfg, twins[name], {"tokens": t}, pos)
        states[name] = []
        for blk in twins[name].layers:
            x, _, _ = lm.apply_layer(cfg, blk, x, pos, "prefill")
            states[name].append(x)
    result["residual"] = [differ(a, b) for a, b in
                          zip(states["card"], states["cpu"])]

    result["twins"] = {}
    for n in (1, 2, 3):
        cfg, twins = twin(model, n, dev)
        card = cs.teacher_forced(cfg, twins["card"], tokens, dev)
        cpu = cs.teacher_forced(cfg, twins["cpu"], tokens, "cpu")
        errs = [cs.logits_err(a, b) for a, b in zip(card, cpu)]
        outside = sum(int((np.abs(a - b) > cs.MODEL_TOL * (1 + np.abs(b)))
                          .sum()) for a, b in zip(card, cpu))
        result["twins"][f"{n} layers {list(cfg.pattern)}"] = {
            "max_abs_err": max(e["max_abs_err"] for e in errs),
            "logits": int(sum(a.size for a in cpu)),
            "outside_tolerance": outside}
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
