#!/usr/bin/env python3
"""Time the port's plain model path, llama3.2-3b at its published
widths, for one or more source trees in turn on one card: the decode
step and the training step that ``chip_smoke.py``'s model and training
phases drive.

    python3 tools/model_path_ab.py SRC [SRC ...]

Each ``SRC`` is a ``src`` directory holding ``repro_torch`` (this
checkout's, or a second commit's unpacked beside it); each runs in a
child process of its own, in the order given, so ``A B B A`` compares
two commits on the same machine. Needs one NVIDIA GPU (exits non-zero
without one). Per run, one JSON line:

* ``decode``: 4 prompts of 32 seeded tokens, ``prefill`` with room for
  18 more, then 18 greedy ``decode_step`` calls, each timed on the host
  clock up to a synchronise; the median of the last 16 (ms a step and
  ms a token, a step being 4 tokens);
* ``train``: ``launch.train.make_train_step`` (remat "full") on a batch
  of 8 x 128 synthetic tokens, 6 steps on the host clock up to a
  synchronise; the median of steps 2-6, the losses and the peak memory.

Weights come from the seeded card generator, as in ``chip_smoke.py``.
The last lines are the card's name and power limit (``nvidia-smi``)
and a summary: each tree's medians in the order run.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

ARCH = "llama3.2-3b"
PROMPT, BATCH, DECODE_STEPS, DECODE_WARM = 32, 4, 16, 2
TRAIN = dict(steps=6, batch=8, seq=128)


def timed(fn) -> float:
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def child(src: str) -> dict:
    sys.path.insert(0, src)
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticPipeline
    from repro_torch.launch.train import make_train_step, train_batch
    from repro_torch.models import lm
    from repro_torch.optim import adamw
    dev = torch.device("cuda")
    cfg = get_config(ARCH)
    model = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                           device=dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    tokens = torch.randint(0, cfg.vocab, (BATCH, PROMPT), generator=gen,
                           device=dev, dtype=torch.int32)
    n_steps = DECODE_WARM + DECODE_STEPS
    with torch.no_grad():
        logits, cache = lm.prefill(cfg, model, {"tokens": tokens},
                                   pad_to=PROMPT + n_steps)
        step_ms = []
        for i in range(n_steps):
            tok = torch.argmax(logits, -1).to(torch.int32)
            pos = torch.full((BATCH,), PROMPT + i, dtype=torch.int32,
                             device=dev)
            out = {}

            def step():
                out["r"] = lm.decode_step(cfg, model, cache, tok, pos)
            step_ms.append(timed(step))
            logits, cache = out["r"]
    decode_p50 = statistics.median(step_ms[DECODE_WARM:])
    del cache, logits
    torch.cuda.empty_cache()

    model.requires_grad_(True)
    state = [adamw.init(dict(model.named_parameters()))]
    step_fn = make_train_step(cfg, adamw.AdamWConfig(
        total_steps=TRAIN["steps"], warmup_steps=2),
        lm.RunFlags(remat="full"))
    data = SyntheticPipeline(DataConfig(vocab=cfg.vocab, seq_len=TRAIN["seq"],
                                        global_batch=TRAIN["batch"]))
    torch.cuda.reset_peak_memory_stats()
    train_ms, losses = [], []
    for s in range(TRAIN["steps"]):
        batch = train_batch(cfg, data, s, TRAIN["batch"], TRAIN["seq"], dev)
        out = {}

        def step():
            _, state[0], out["m"] = step_fn(model, state[0], batch)
        train_ms.append(timed(step))
        losses.append(float(out["m"]["loss"]))
    return {"src": src, "arch": ARCH,
            "decode": {"batch": BATCH, "prompt": PROMPT,
                       "step_ms": step_ms, "step_ms_p50": decode_p50,
                       "ms_a_token_p50": decode_p50 / BATCH},
            "train": {**TRAIN, "remat": "full", "step_ms": train_ms,
                      "step_ms_p50": statistics.median(train_ms[1:]),
                      "losses": losses,
                      "max_memory_allocated": int(
                          torch.cuda.max_memory_allocated())}}


def main(argv) -> int:
    if len(argv) == 3 and argv[1] == "--child":
        print(json.dumps(child(argv[2])), flush=True)
        return 0
    import torch
    if not torch.cuda.is_available() or len(argv) < 2:
        print("usage (on the card): python3 tools/model_path_ab.py SRC "
              "[SRC ...]", file=sys.stderr)
        return 2
    runs = []
    for src in argv[1:]:
        out = subprocess.run([sys.executable, __file__, "--child", src],
                             stdout=subprocess.PIPE, text=True, check=True)
        runs.append(json.loads(out.stdout.strip().splitlines()[-1]))
        print(json.dumps(runs[-1]), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], stdout=subprocess.PIPE,
                         text=True).stdout.strip()
    print(smi, flush=True)
    print(json.dumps({"summary": [
        {"src": r["src"], "decode_ms_a_token_p50":
         r["decode"]["ms_a_token_p50"],
         "train_step_ms_p50": r["train"]["step_ms_p50"]} for r in runs]}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
