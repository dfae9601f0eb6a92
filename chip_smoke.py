#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of MITHRIL end to end on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure exits non-zero:

1. device and build — the card's name and power limit, then the CUDA
   kernels built from ``src/repro_torch/kernels/csrc`` into
   ``build/kernels``, one ``nvcc`` per source, all at once, with what
   ptxas reports for the decode kernels (registers, spills);
2. kernels — each kernel against its plain PyTorch version on the card:
   the record and mining kernels at the paper's shapes (L = 1, 16, 135
   lanes), at the parity sweeps' shapes (``SUITE_MITHRIL``, 16 lanes)
   and odd cases, exactly (int32); the decode kernel at the shapes of
   ``tests/test_kernels.py::TestPagedDecodeKernel`` and at llama3.2-3b's
   attention widths (5 rows and one row; lengths 0, 1, ragged and
   full), float32 within 2e-5 and bfloat16 within 2e-2; the lookup
   kernel exactly, Q = 1 and EMPTY queries included. ``ms`` is the
   median CUDA-event time of one call as the main path makes it
   (wrapper included), ``device_ms`` the kernel's own time in a
   ``torch.profiler`` trace (decode: split kernel plus merge, with the
   split plan), ``bound_ms`` the least bytes (or operations) of the
   same call over the card's peak, ``library_ms`` one PyTorch call
   computing the same function, where there is one;
   ``launch_floor_ms`` is the device time of one PyTorch elementwise op
   on a one-element tensor;
3. parity — the port's ``sweep_scheduled`` over the 16-trace quick
   corpus (4000 requests) for the 9 labels of the benchmark grid at
   capacity 512, in three processes at once; each label's rounded hit
   ratios (and mean precision) must equal the ``corpus_figures_quick``
   rows of ``results/bench/BENCH_baseline_quick.json``;
4. real size — the paper's deployment: the full 135-trace corpus
   (22.5k-50k requests per trace), the paper's MITHRIL tables and a
   65,536-block cache with 16 ways, ``mithril-lru`` in one sweep of 135
   lanes; 4 of its traces, one per family, are run again on the CPU
   through the plain versions (in a child process, meanwhile) and must
   give equal ``Stats`` (the child starts with the script);
5. serving — the tiered paged-KV cache under multi-tenant on-off
   arrivals through ``launch.serve.TieredServeEngine``, with and without
   MITHRIL: (a) at ``benchmarks/serving_bench.py``'s quick scale, where
   every deterministic field must equal the ``serving`` rows of
   ``BENCH_baseline_quick.json``; (b) at llama3.2-3b's attention widths
   (24 query heads, 8 kv heads, head_dim 128, page 16, float32) with the
   bench's full-scale traffic at a 2,048-token context (128 pages a
   request, 704 device slots, 16,384 host pages), whose counters must
   equal a CPU run of the port in a child process (started with the
   script), and whose decode through the tier must match the plain
   decode over the host pages.

The main path is phases 3, 4 and 5: the launch counters are zeroed just
before the parity sweeps and read after each of the later phases, and
each of the five kernels (and the decode's merge) must have launched
on one of them; the ``kernels`` line gives the launches of each phase.
(At the paper's sizes the 50k request traces never fill the
65,536-block cache, so the real-size sweep records every miss but never
mines; the batched mining kernel runs in parity only, and is timed at
its shapes.)
The last lines are the ``kernels`` JSON line, the card's name and power
limit, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time
import zlib
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
BASELINE = ROOT / "results" / "bench" / "BENCH_baseline_quick.json"

HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory
INT_OPS_PER_S = 67e12         # non-tensor 32-bit rate (the table's fp32 line)
PAPER_CAPACITY = 65_536       # the paper's 256 MB cache at 4 KB blocks
PARITY_CAPACITY = 512
PARITY_LEN = 4_000
# crc32 of the (16, 4000) int32 block matrix of corpus_suite("quick", 4000):
# the traces the baseline rows were computed on
QUICK_CORPUS_CRC32 = 766487755
REAL_LEN = 50_000
CROSS_TRACES = ("seq000", "loop003", "midfreq005", "mixed007")

KERNEL_INFO = {
    "mithril_record": (
        "src/repro_torch/kernels/csrc/mithril_record.cu",
        "src/repro/kernels/mithril_record.py:199"),
    "mithril_pairwise_batched": (
        "src/repro_torch/kernels/csrc/mithril_mine.cu",
        "src/repro/kernels/mithril_mine_batched.py:72"),
    "mithril_pairwise": (
        "src/repro_torch/kernels/csrc/mithril_mine.cu",
        "src/repro/kernels/mithril_mine.py:88"),
    "hash_lookup": (
        "src/repro_torch/kernels/csrc/hash_lookup.cu",
        "src/repro/kernels/hash_lookup.py:62"),
    "paged_decode": (
        "src/repro_torch/kernels/csrc/paged_decode.cu",
        "src/repro/kernels/paged_decode.py:104"),
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 30, warm: int = 3) -> float:
    """Median milliseconds of one call, from CUDA events."""
    import torch
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    marks = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        marks.append((a, b))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in marks)


def profiled_kernels(fn, reps: int):
    """``(name, device seconds * 1e6, launches)`` of every CUDA kernel in
    a ``torch.profiler`` trace of ``reps`` calls of ``fn``."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return [(ev.key, getattr(ev, "self_device_time_total",
                             getattr(ev, "self_cuda_time_total", 0.0)),
             ev.count) for ev in prof.key_averages()]


def device_ms(fn, kernel: str, reps: int = 20):
    """Mean device time of the CUDA kernel whose name contains ``kernel``,
    from a ``torch.profiler`` trace of ``reps`` calls (None when the
    profiler records no device time)."""
    hits = [(t, n) for key, t, n in profiled_kernels(fn, reps)
            if kernel in key]
    total, count = sum(t for t, _ in hits), sum(n for _, n in hits)
    return total / count / 1e3 if count and total > 0 else None


def device_ms_per_call(fn, kernels, reps: int = 20) -> dict:
    """Device time a call spends in each named CUDA kernel (a name
    matches the kernels whose names contain it), from one trace of
    ``reps`` calls; None where the profiler records no device time."""
    trace = profiled_kernels(fn, reps)
    out = {}
    for kernel in kernels:
        total = sum(t for key, t, _ in trace if kernel in key)
        out[kernel] = total / reps / 1e3 if total > 0 else None
    return out


def launch_floor_ms() -> float:
    """Device time of one PyTorch elementwise op on a one-element CUDA
    tensor: what any kernel launch costs on the card, whatever it does."""
    import torch
    x = torch.zeros(1, device="cuda")
    return device_ms(lambda: x.add_(1), "elementwise_kernel", reps=200)


def ptxas_report(log: str) -> list:
    """Registers, spills and static shared memory of each decode kernel
    in an ``nvcc -Xptxas -v`` log, template arguments spelt out."""
    import re
    rows, row = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '[^']*?(paged_decode_"
                      r"(?:split|merge))(?:I(13__nv_bfloat16|f)Li(\d+)E)?",
                      line)
        if m:
            name = m.group(1)
            if m.group(2):
                name += (f"<{'float' if m.group(2) == 'f' else 'bfloat16'}"
                         f", hd <= {32 * int(m.group(3))}>")
            row = {"kernel": name}
            rows.append(row)
        elif row is not None:
            for key, pat in (("registers", r"Used (\d+) registers"),
                             ("static_smem_bytes", r"(\d+) bytes smem"),
                             ("stack_frame_bytes", r"(\d+) bytes stack"),
                             ("spill_store_bytes", r"(\d+) bytes spill st"),
                             ("spill_load_bytes", r"(\d+) bytes spill lo")):
                m = re.search(pat, line)
                if m:
                    row[key] = int(m.group(1))
    return rows


def bound(bytes_: float, ops: float):
    t_b, t_o = bytes_ / HBM_BYTES_PER_S, ops / INT_OPS_PER_S
    return max(t_b, t_o) * 1e3, ("bytes" if t_b >= t_o else "operations")


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

RECORD_LEAVES = ("rec_key", "rec_ts", "rec_cnt", "rec_age", "rec_loc",
                 "rec_row", "mine_block", "mine_ts", "mine_cnt", "mine_fill",
                 "ts")


def record_event_bytes(cfg, st, blk, en) -> float:
    """Least bytes of one record event on ``st``, which the plain version
    then advances in place. Reads: every lane's enable flag; for an
    enabled lane its block, ``ts`` and ``mine_fill`` and the bucket's W
    keys and ages; for a hit, the slot's cnt, loc and row; for a
    migration, the slot's R timestamps; for an update of a mining row,
    its count. Writes: the int32 elements the event changes."""
    import torch
    from repro_torch.core.hashindex import arange, bucket_index, first_index
    from repro_torch.kernels.mithril_record import record_step_plain
    lanes, w, r = blk.shape[0], cfg.rec_ways, cfg.min_support
    ar = arange(lanes, blk.device)
    b = bucket_index(blk, cfg.rec_buckets)
    hit = st.rec_key[ar, b] == blk[:, None]
    on = en != 0
    found = on & hit.any(-1)
    upd = found & (st.rec_loc[ar, b, first_index(hit)] == 1)
    before = [getattr(st, f).clone() for f in RECORD_LEAVES]
    record_step_plain(blk, en, *(getattr(st, f) for f in RECORD_LEAVES))
    changed = sum(int((getattr(st, f) != x).sum())
                  for f, x in zip(RECORD_LEAVES, before))
    mig = int((st.mine_fill != before[RECORD_LEAVES.index("mine_fill")])
              .sum())
    reads = (lanes + int(on.sum()) * (3 + 2 * w) + int(found.sum()) * 3
             + mig * r + int(upd.sum()))
    return 4.0 * (reads + changed)


def record_ops(cfg, n_enabled: int) -> float:
    w, r, s = cfg.rec_ways, cfg.min_support, cfg.max_support
    return n_enabled * (16 + 8 * w + 6 * r + 8 * s)


def max_err(got, want) -> int:
    return int((got.long() - want.long()).abs().max()) if got.numel() else 0


def pairwise_bytes(lanes, n, s, window) -> float:
    return lanes * (n * s * 4 + n * 4 + n) + lanes * n * window * 4


def pairwise_ops(lanes, n, s, window) -> float:
    return lanes * n * window * s * 3


def random_mining(rng, lanes, n, s, r_sup, valid_frac=0.8):
    """Sorted mining tables like the barrier sees: unique first
    timestamps, clustered rows, some frequent and cleared rows."""
    import numpy as np
    import torch
    base = np.sort(rng.choice(20 * n, size=(lanes, n), replace=True), -1)
    cnt = rng.integers(r_sup, s + 1, size=(lanes, n))
    cnt = np.where(rng.random((lanes, n)) < valid_frac, cnt,
                   rng.choice([0, s + 1], size=(lanes, n)))
    ts = base[..., None] + np.sort(rng.integers(0, 60, (lanes, n, s)), -1)
    ts = np.where(np.arange(s) < np.minimum(cnt, s)[..., None], ts, 0)
    valid = (cnt >= r_sup) & (cnt <= s)
    return (torch.as_tensor(ts.astype(np.int32)),
            torch.as_tensor(cnt.astype(np.int32)),
            torch.as_tensor(valid))


def warm_record_state(cfg, lanes, dev, rng, events=400):
    """A state with live recording and mining rows, drained like mine()."""
    import torch
    from repro_torch.core import init_state
    from repro_torch.kernels.mithril_record import record_step_plain
    st = init_state(cfg, dev, lanes=lanes)
    universe = 4 * cfg.rec_buckets * cfg.rec_ways
    for _ in range(events):
        blk = torch.as_tensor(rng.integers(0, universe // 64, lanes),
                              dtype=torch.int32, device=dev)
        en = torch.ones(lanes, dtype=torch.int32, device=dev)
        record_step_plain(blk, en, *(getattr(st, f) for f in RECORD_LEAVES))
        full = st.mine_fill >= cfg.mine_rows - 1
        st.mine_fill.masked_fill_(full, 0)
    return st


def check_record(cfg, lanes, dev, rng, enabled_frac=1.0, steps=20):
    """Run kernel and plain on two copies of one state; exact equality
    after every event. Returns the kernel's and the plain version's ms,
    the mean least bytes and the operations of a timed event, the
    kernel's device ms and the largest absolute difference seen."""
    import torch
    from repro_torch.kernels.mithril_record import (record_step_kernel,
                                                    record_step_plain)
    base = warm_record_state(cfg, lanes, dev, rng)
    a = type(base)(*(x.clone() for x in base))
    b = type(base)(*(x.clone() for x in base))
    universe = 4 * cfg.rec_buckets * cfg.rec_ways
    err = 0
    for _ in range(steps):
        blk = torch.as_tensor(rng.integers(0, universe // 64, lanes),
                              dtype=torch.int32, device=dev)
        en = torch.as_tensor(rng.random(lanes) < enabled_frac,
                             device=dev).to(torch.int32)
        record_step_kernel(blk, en, *(getattr(a, f) for f in RECORD_LEAVES))
        record_step_plain(blk, en, *(getattr(b, f) for f in RECORD_LEAVES))
        torch.cuda.synchronize()
        for name in a._fields:
            err = max(err, max_err(getattr(a, name), getattr(b, name)))
            if not torch.equal(getattr(a, name), getattr(b, name)):
                fail(f"record kernel differs from plain in {name} "
                     f"(L={lanes}, NB={cfg.rec_buckets}, "
                     f"Nm={cfg.mine_rows}, R={cfg.min_support}, "
                     f"enabled={enabled_frac})")
    # timing: one event per call on the same inputs; the mining fill
    # starts at 0 so the 33 timed events stay inside the table
    blk = torch.as_tensor(rng.integers(0, universe // 64, lanes),
                          dtype=torch.int32, device=dev)
    en = torch.as_tensor(rng.random(lanes) < enabled_frac,
                         device=dev).to(torch.int32)
    a.mine_fill.zero_()
    b.mine_fill.zero_()
    # the bytes of the 33 events cuda_ms times, replayed on a third copy
    c = type(a)(*(x.clone() for x in a))
    by = statistics.mean(record_event_bytes(cfg, c, blk, en)
                         for _ in range(33))
    del c

    def kern():
        record_step_kernel(blk, en, *(getattr(a, f) for f in RECORD_LEAVES))
    ms = cuda_ms(kern)
    dev_ms = device_ms(kern, "record_kernel")
    plain_ms = cuda_ms(lambda: record_step_plain(
        blk, en, *(getattr(b, f) for f in RECORD_LEAVES)))
    return ms, plain_ms, by, record_ops(cfg, int(en.sum())), dev_ms, err


def check_pairwise(lanes, n, s, delta, window, dev, rng, r_sup=4,
                   valid_frac=0.8, serial=False):
    import torch
    from repro_torch.kernels.mithril_mine import pairwise_codes_kernel
    from repro_torch.kernels.mithril_mine_batched import (
        pairwise_codes_batched_kernel, pairwise_codes_batched_plain)
    ts, cnt, valid = (x.to(dev) for x in random_mining(
        rng, lanes, n, s, r_sup, valid_frac))
    if serial:                  # the one-lane kernel sees lane 0 only
        ts, cnt, valid, lanes = ts[:1], cnt[:1], valid[:1], 1
    want = pairwise_codes_batched_plain(ts, cnt, valid, delta, window)
    if serial:
        def kern():
            return pairwise_codes_kernel(ts[0], cnt[0], valid[0], delta,
                                         window)[None]
    else:
        def kern():
            return pairwise_codes_batched_kernel(ts, cnt, valid, delta,
                                                 window)
    got = kern()
    torch.cuda.synchronize()
    err = max_err(got, want)
    if not torch.equal(got, want):
        bad = int((got != want).sum())
        fail(f"pairwise kernel differs from plain at {bad} codes "
             f"(L={lanes}, N={n}, S={s}, W={window}, serial={serial})")
    ms = cuda_ms(kern)
    dev_ms = device_ms(kern, "pairwise_codes_kernel")
    plain_ms = cuda_ms(lambda: pairwise_codes_batched_plain(
        ts, cnt, valid, delta, window), reps=10)
    return ms, plain_ms, pairwise_bytes(lanes, n, s, window), \
        pairwise_ops(lanes, n, s, window), int((want > 0).sum()), dev_ms, err


# the decode kernel's shapes: (B, Hq, Hkv, hd, ps, n_pages) of
# tests/test_kernels.py::TestPagedDecodeKernel, each in both dtypes, then
# (in phase_serving_kernels) llama3.2-3b's attention widths at the
# full-width serving batch (5 rows of 128 pages out of the 704-slot pool)
DECODE_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
# bfloat16 also within a rounding bound: kernel and plain both compute in
# float32 and round once, so they differ by the float32 tolerance plus at
# most two bfloat16 steps (each at most 2**-7 of the value). At the full
# width the outputs are ~0.04, and 2e-2 alone would pass a dropped page.
DECODE_BF16_ROUNDING = {"atol": 2e-5, "rtol": 2.0 ** -6}
DECODE_SHAPES = [(2, 8, 2, 32, 16, 4), (1, 4, 4, 64, 32, 8),
                 (3, 16, 8, 64, 8, 6), (2, 4, 1, 128, 64, 2)]


def decode_bytes(q, pool, tab, lens) -> float:
    """Least bytes of one decode call: every (page, token) that some
    row's length reaches, K and V of every kv head, read once; q, the
    page table and lengths read, the output written."""
    import torch
    npg, ps = tab.shape[1], pool.shape[1]
    pos = (torch.arange(npg, device=tab.device)[:, None] * ps
           + torch.arange(ps, device=tab.device)[None])       # (npg, ps)
    live = pos[None] < lens.long()[:, None, None]             # (B, npg, ps)
    keys = tab.long()[:, :, None] * ps + torch.arange(ps, device=tab.device)
    n_tok = int(torch.unique(keys[live]).numel())
    tok_bytes = pool[0, 0].numel() * pool.element_size()
    return (2.0 * n_tok * tok_bytes + 2 * q.numel() * q.element_size()
            + 4 * (tab.numel() + lens.numel()))


def decode_ops(q, lens) -> float:
    """Multiply-adds of QK and PV over the positions each row needs."""
    _, hq, hd = q.shape
    return 4.0 * hq * hd * float(lens.long().sum())


def decode_library(q, k_pool, v_pool, tab, lens):
    """The yardstick, never the port: a page gather, then one
    ``scaled_dot_product_attention`` call with GQA and the length mask."""
    import torch
    import torch.nn.functional as F
    b, hq, hd = q.shape
    _, ps, hkv, _ = k_pool.shape
    n = tab.shape[1] * ps
    k = k_pool[tab.long()].reshape(b, n, hkv, hd).transpose(1, 2)
    v = v_pool[tab.long()].reshape(b, n, hkv, hd).transpose(1, 2)
    mask = (torch.arange(n, device=q.device)[None] < lens[:, None])
    return F.scaled_dot_product_attention(
        q[:, :, None].to(k.dtype), k, v, attn_mask=mask[:, None, None],
        enable_gqa=True)[:, :, 0]


def random_decode(gen, shape, dtype, dev, n_total=None, lengths=None):
    import torch
    b, hq, hkv, hd, ps, npg = shape
    n_total = n_total or npg * b + 2
    dt = getattr(torch, dtype)

    def randn(*size):
        return torch.randn(size, generator=gen, device=dev).to(dt)
    q = randn(b, hq, hd)
    kp, vp = randn(n_total, ps, hkv, hd), randn(n_total, ps, hkv, hd)
    tab = torch.randperm(n_total, generator=gen, device=dev)[:b * npg]
    tab = tab.reshape(b, npg).to(torch.int32)
    if lengths is None:
        lens = torch.randint(1, npg * ps + 1, (b,), generator=gen,
                             device=dev).to(torch.int32)
    else:
        lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    return q, kp, vp, tab, lens


def decode_plan(shape, dtype) -> dict:
    """The split plan the wrapper picks for ``shape`` on this card."""
    import torch
    from repro_torch.kernels import backend
    from repro_torch.kernels.paged_decode import decode_smem_bytes, split_plan
    b, hq, hkv, hd, ps, npg = shape
    pps, n_splits = split_plan(b, hkv, npg, ps, backend.sm_count(
        torch.device("cuda")))
    return {"pages_per_split": pps, "n_splits": n_splits,
            "blocks": n_splits * hkv * b, "merge": n_splits > 1,
            "smem_bytes": decode_smem_bytes(hq, hkv, hd,
                                            getattr(torch, dtype), pps)}


def check_decode(shape, dtype, dev, gen, n_total=None, lengths=None,
                 timed=False):
    """Kernel against plain on one input; within DECODE_TOL. Returns the
    largest absolute difference and, when ``timed``, the call's, the
    plain version's and the library call's ms, bytes, operations, the
    device ms of a call (split kernel plus merge) and the plan with the
    device ms of each of the two kernels."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.paged_decode import paged_decode_plain
    args = random_decode(gen, shape, dtype, dev, n_total, lengths)
    got = ops.paged_decode(*args)
    want = paged_decode_plain(*args)
    torch.cuda.synchronize()
    tol = DECODE_TOL[dtype]
    err = float((got.float() - want.float()).abs().max())
    if got.dtype != want.dtype or got.shape != want.shape or not \
            torch.allclose(got.float(), want.float(), rtol=tol, atol=tol):
        fail(f"decode kernel differs from plain by {err} (shape {shape}, "
             f"{dtype}, tolerance {tol})")
    if dtype == "bfloat16" and not torch.allclose(
            got.float(), want.float(), **DECODE_BF16_ROUNDING):
        fail(f"decode kernel differs from plain by {err}, more than "
             f"bfloat16 rounding {DECODE_BF16_ROUNDING} (shape {shape})")
    if not timed:
        return err, None
    q, kp, vp, tab, lens = args
    ms = cuda_ms(lambda: ops.paged_decode(*args))
    parts = device_ms_per_call(lambda: ops.paged_decode(*args),
                               ("paged_decode_split", "paged_decode_merge"))
    split_ms, merge_ms = parts.values()
    plan = decode_plan(shape, dtype)
    dev_ms = None if split_ms is None or (plan["merge"] and merge_ms is None) \
        else split_ms + (merge_ms or 0.0)
    plain_ms = cuda_ms(lambda: paged_decode_plain(*args), reps=10)
    lib_ms = cuda_ms(lambda: decode_library(*args), reps=10)
    return err, (ms, plain_ms, decode_bytes(q, kp, tab, lens),
                 decode_ops(q, lens), dev_ms, lib_ms,
                 {"plan": plan, "device_ms_split": split_ms,
                  "device_ms_merge": merge_ms})


def lookup_tables(gen, nb, ways, plist, dev, fill=0.7):
    """A prefetch table with distinct keys in their buckets' first empty
    ways; empty ways hold values other than EMPTY, so an EMPTY query's
    result shows which way it matched."""
    import torch
    from repro_torch.core.hashindex import bucket_index
    keys = torch.randperm(1 << 20, generator=gen, device=dev)[
        :int(nb * ways * fill)].to(torch.int32)
    pf_key = torch.full((nb, ways), -1, dtype=torch.int32, device=dev)
    b = bucket_index(keys, nb)
    order = torch.argsort(b, stable=True)
    b, keys = b[order], keys[order]
    first = torch.searchsorted(b, b, right=False)
    way = torch.arange(len(b), device=dev) - first       # rank in bucket
    ok = way < ways
    pf_key[b[ok], way[ok]] = keys[ok]
    pf_vals = torch.randint(0, 1 << 20, (nb, ways, plist), generator=gen,
                            device=dev).to(torch.int32)
    return pf_key, pf_vals, keys[ok]


def lookup_bytes(queries, pf_key, pf_vals) -> float:
    """Per query: the query, the bucket's W keys, a hit way's P values,
    the P outputs."""
    from repro_torch.kernels.hash_lookup import hash_lookup_plain
    ways, plist = pf_key.shape[1], pf_vals.shape[-1]
    hits = int((hash_lookup_plain(queries, pf_key, pf_vals) != -1)
               .any(-1).sum())
    return 4.0 * (queries.numel() * (1 + ways + plist) + hits * plist)


def check_lookup(nb, ways, plist, n_q, dev, gen, timed=False):
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.hash_lookup import hash_lookup_plain
    pf_key, pf_vals, keys = lookup_tables(gen, nb, ways, plist, dev)
    pick = torch.randint(0, len(keys), (n_q,), generator=gen, device=dev)
    queries = torch.where(
        torch.rand(n_q, generator=gen, device=dev) < 0.6, keys[pick],
        torch.randint(-1, 1 << 21, (n_q,), generator=gen, device=dev)
        .to(torch.int32))
    queries[torch.rand(n_q, generator=gen, device=dev) < 0.1] = -1
    got = ops.prefetch_lookup(queries, pf_key, pf_vals)
    want = hash_lookup_plain(queries, pf_key, pf_vals)
    torch.cuda.synchronize()
    err = max_err(got, want)
    if not torch.equal(got, want):
        fail(f"lookup kernel differs from plain (NB={nb}, W={ways}, "
             f"P={plist}, Q={n_q})")
    if not timed:
        return err, None
    ms = cuda_ms(lambda: ops.prefetch_lookup(queries, pf_key, pf_vals))
    dev_ms = device_ms(lambda: ops.prefetch_lookup(queries, pf_key, pf_vals),
                       "hash_lookup")
    plain_ms = cuda_ms(lambda: hash_lookup_plain(queries, pf_key, pf_vals))
    # operations: the hash (about 12 integer ops) and W compares a query
    return err, (ms, plain_ms, lookup_bytes(queries, pf_key, pf_vals),
                 n_q * (12.0 + ways), dev_ms, None)


def phase_serving_kernels(dev, cases, timing, errs):
    """The decode and lookup kernels against their plain versions; the
    timed shapes are those of the full-width serving phase (decode: B =
    5 rows of 128 pages, float32, and one row; lookup: Q = 1 on MCFG's
    tables) and of the quick-scale one. Lengths 0 (every page read, V
    averaged), 1, ragged and full, in both dtypes."""
    import torch
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

    def decode(shape, dtype, tag, timed=None, **kw):
        err, t = check_decode(shape, dtype, dev, gen, timed=bool(timed),
                              **kw)
        errs["paged_decode"] = max(errs["paged_decode"], err)
        row = {"kernel": "paged_decode", "shape": list(shape),
               "dtype": dtype, "case": tag, "max_abs_err": err}
        if t:
            ms, plain, by, ops_, dms, lib, extra = t
            row.update(ms=ms, device_ms=dms, plain_ms=plain,
                       library_ms=lib, bound_ms=bound(by, ops_)[0], **extra)
            timing[timed] = t
        cases.append(row)

    for shape in DECODE_SHAPES:
        for dtype in DECODE_TOL:
            decode(shape, dtype, "test shape")
    p, m, geo = FULL_WIDTH_PAGE, SERVING_PAGE, full_width_geometry()
    full = (geo["max_batch"], FULL_WIDTH_Q_HEADS, p["n_kv"], p["head_dim"],
            p["page_size"], geo["pages_per_req"])
    n_ctx = geo["pages_per_req"] * p["page_size"]
    decode(full, "float32", "full width, serving batch",
           n_total=geo["n_hbm_slots"], lengths=[n_ctx] * full[0],
           timed="paged_decode")
    decode(full, "bfloat16", "full width, bfloat16 pools",
           n_total=geo["n_hbm_slots"], lengths=[n_ctx] * full[0])
    decode(full, "float32", "full width, lengths not page multiples",
           n_total=geo["n_hbm_slots"],
           lengths=[n_ctx - 5, 1, n_ctx, 17, n_ctx - 16])
    one = (1,) + full[1:]
    decode(one, "float32", "full width, one row",
           n_total=geo["n_hbm_slots"], lengths=[n_ctx],
           timed="paged_decode@b1")
    for dtype in DECODE_TOL:
        decode(full, dtype, "full width, lengths 0, 1, ragged, full",
               n_total=geo["n_hbm_slots"],
               lengths=[0, 1, n_ctx // 2 + 7, n_ctx, 33])
        decode(one, dtype, "full width, one row, length 0",
               n_total=geo["n_hbm_slots"], lengths=[0])
    quick = SERVING_SCALES["quick"]
    decode((quick["max_batch"], 4, m["n_kv"], m["head_dim"], m["page_size"],
            quick["pages_per_req"]), "float32", "quick scale, serving batch",
           n_total=quick["n_hbm_slots"],
           lengths=[quick["pages_per_req"] * m["page_size"]]
           * quick["max_batch"], timed="paged_decode@quick")

    def lookup(nb, ways, plist, n_q, tag, timed=None):
        err, t = check_lookup(nb, ways, plist, n_q, dev, gen,
                              timed=bool(timed))
        errs["hash_lookup"] = max(errs["hash_lookup"], err)
        row = {"kernel": "hash_lookup", "NB": nb, "W": ways, "P": plist,
               "Q": n_q, "case": tag, "max_abs_err": err}
        if t:
            ms, plain, by, ops_, dms, _ = t
            row.update(ms=ms, device_ms=dms, plain_ms=plain,
                       bound_ms=bound(by, ops_)[0])
            timing[timed] = t
        cases.append(row)

    mc = serving_mcfg()
    lookup(mc.pf_buckets, mc.pf_ways, mc.prefetch_list, 1,
           "serving tables, Q = 1 (the tier's probe)", timed="hash_lookup")
    for nb, ways, plist, n_q, tag in [
            (64, 4, 2, 64, "test shape"), (256, 4, 3, 100, "test shape"),
            (32, 2, 2, 7, "test shape"), (512, 4, 3, 1000, "Q = 1000"),
            (16384, 4, 2, 100_000, "paper tables, Q = 100,000")]:
        for _ in range(3):
            lookup(nb, ways, plist, n_q, tag)


def phase_kernels(dev):
    """Every kernel against its plain version. Returns, per kernel, the
    timing at the shape the main path launches it most (record: the
    real-size sweep's; one-lane pairwise: the serving tier's; batched
    pairwise: the parity sweeps', the only ones that mine batched) and
    the largest absolute difference over all its cases."""
    import dataclasses
    import numpy as np
    from repro_torch.configs import PAPER_MITHRIL as P, SUITE_MITHRIL as M
    rng = np.random.default_rng(0)
    cases, timing = [], {}
    errs = {k: 0 for k in KERNEL_INFO}
    t0 = time.time()

    def record(cfg, lanes, tag, frac=1.0, timed=None):
        ms, plain, by, ops, dms, err = check_record(cfg, lanes, dev, rng,
                                                    enabled_frac=frac)
        errs["mithril_record"] = max(errs["mithril_record"], err)
        cases.append({"kernel": "mithril_record", "L": lanes, "case": tag,
                      "ms": ms, "device_ms": dms, "plain_ms": plain,
                      "bound_ms": bound(by, ops)[0]})
        if timed:
            timing[timed] = (ms, plain, by, ops, dms)

    for lanes in (1, 16, 135):
        record(P, lanes, "paper tables",
               timed="mithril_record" if lanes == 135 else None)
    record(M, 16, "suite tables (parity)", timed="mithril_record@parity")
    record(M, 16, "suite tables, mixed enabled", frac=0.5)
    record(dataclasses.replace(P, min_support=1), 16, "R=1")
    record(P, 16, "mixed enabled", frac=0.5)
    record(dataclasses.replace(P, rec_buckets=64, mine_rows=16), 16,
           "small tables", frac=0.7)
    # the serving tier's shape: MCFG's tables, one lane, one event a miss
    mc = serving_mcfg()
    record(mc, 1, "serving tables (MCFG)", timed="mithril_record@serving")
    record(mc, 1, "serving tables, mixed enabled", frac=0.5)

    def pairwise(lanes, n, s, delta, w, tag, r_sup=4, vf=0.8, serial=False,
                 timed=None):
        name = "mithril_pairwise" if serial else "mithril_pairwise_batched"
        ms, plain, by, ops, nz, dms, err = check_pairwise(
            lanes, n, s, delta, w, dev, rng, r_sup=r_sup, valid_frac=vf,
            serial=serial)
        errs[name] = max(errs[name], err)
        cases.append({"kernel": name, "L": 1 if serial else lanes,
                      "N": n, "S": s, "W": w, "case": tag, "ms": ms,
                      "device_ms": dms, "plain_ms": plain,
                      "bound_ms": bound(by, ops)[0], "nonzero_codes": nz})
        if timed:
            timing[timed] = (ms, plain, by, ops, dms)

    n, s, delta, w = P.mine_rows, P.max_support, P.lookahead, P.window
    for lanes in (1, 16, 135):
        pairwise(lanes, n, s, delta, w, "paper tables")
    pairwise(1, n, s, delta, w, "paper tables", serial=True)
    # the parity sweeps' shape: SUITE_MITHRIL's 64 x 8 mining table, 16
    # lanes (fused path) or one lane (one-lane path)
    for serial in (False, True):
        pairwise(16, M.mine_rows, M.max_support, M.lookahead, M.window,
                 "suite tables (parity)", r_sup=M.min_support, vf=0.9,
                 serial=serial, timed=("mithril_pairwise@parity" if serial
                                       else "mithril_pairwise_batched"))
    # the serving tier's mining: one lane of MCFG's 8 x 8 table, below
    # the row block, W = min(Nm - 1, lookahead) = 7
    pairwise(1, mc.mine_rows, mc.max_support, mc.lookahead, mc.window,
             "serving tables (MCFG)", r_sup=mc.min_support, serial=True,
             timed="mithril_pairwise")
    for _ in range(8):      # every row at full count: weak and strong codes
        pairwise(1, mc.mine_rows, mc.max_support, mc.lookahead, mc.window,
                 "serving tables, rows at full count",
                 r_sup=mc.max_support, vf=1.0, serial=True)
    for lanes, n_, s_, d_, w_, vf, tag in [
            (3, 1000, 8, 100, 100, 0.8, "N not a row-block multiple"),
            (4, 64, 8, 100, 63, 0.0, "all rows invalid"),
            (2, 40, 4, 50, 90, 0.9, "window >= N"),
            (2, 300, 12, 30, 300, 0.9, "S=12, wide window")]:
        for serial in (False, True):
            pairwise(lanes, n_, s_, d_, w_, tag, r_sup=2, vf=vf,
                     serial=serial)
    phase_serving_kernels(dev, cases, timing, errs)
    emit({"phase": "kernels", "seconds": round(time.time() - t0, 3),
          "exact": ["mithril_record", "mithril_pairwise_batched",
                    "mithril_pairwise", "hash_lookup"],
          "tolerance": {"paged_decode": DECODE_TOL,
                        "paged_decode_bfloat16_rounding":
                            DECODE_BF16_ROUNDING},
          "max_abs_err": errs, "cases": cases})
    # a line of its own: the kernels line above is long, and the end of
    # the output is what a reader of the run gets to see
    emit({"phase": "launch_floor", "launch_floor_ms": launch_floor_ms(),
          "op": "x.add_(1), x a one-element float32 tensor on the card"})
    return timing, errs


# ---------------------------------------------------------------------------
# phase 3: the quick corpus against the checked-in reference rows
# ---------------------------------------------------------------------------

def parity_grid(capacity: int):
    """The benchmark grid (a copy of ``benchmarks/common.py::configs``)."""
    from repro_torch.cache import SimConfig
    from repro_torch.configs import SUITE_MITHRIL as M
    grid = [
        SimConfig(capacity=capacity),
        SimConfig(capacity=capacity, policy="fifo"),
        SimConfig(capacity=capacity, use_amp=True),
        SimConfig(capacity=capacity, use_pg=True),
        SimConfig(capacity=capacity, use_mithril=True, mithril=M),
        SimConfig(capacity=capacity, policy="fifo", use_mithril=True,
                  mithril=M),
        SimConfig(capacity=capacity, use_amp=True, use_mithril=True,
                  mithril=M),
        SimConfig(capacity=capacity, use_learned=True),
        SimConfig(capacity=capacity, use_learned=True, use_mithril=True,
                  mithril=M),
    ]
    return {cfg.label(): cfg for cfg in grid}


def pf_src_of(cfg) -> int:
    from repro_torch.cache import PF_AMP, PF_MITHRIL, PF_PG
    if cfg.use_mithril:
        return PF_MITHRIL
    if cfg.use_amp:
        return PF_AMP
    if cfg.use_pg:
        return PF_PG
    return 0


# the parity sweeps run in three processes that drive the card at once
# (each sweep is host-bound); each group takes about a third of the time
PARITY_GROUPS = (("mithril-amp-lru", "lru", "fifo"),
                 ("amp-lru", "mithril-lru", "learned-lru"),
                 ("pg-lru", "mithril-fifo", "learned-mithril-lru"))


def parity_labels(dev, labels, n_requests: int = PARITY_LEN) -> dict:
    """Sweep the quick corpus through ``labels`` in this process and hold
    each label's rounded hit ratios and mean precision against the
    baseline row. Returns the results, launch counts and fold time."""
    import numpy as np
    from repro_torch.cache import sweep_scheduled
    from repro_torch.kernels import ops
    from repro_torch.traces import corpus_suite
    rows = {r["config"]: r for r in json.loads(BASELINE.read_text())["sweeps"]
            if r["job"] == "corpus_figures_quick"}
    names, blocks, lengths = corpus_suite("quick", n_requests)
    crc = zlib.crc32(np.ascontiguousarray(blocks).tobytes())
    grid = parity_grid(PARITY_CAPACITY)
    timer = FoldTimer()
    ops.reset_launch_counts()
    t0 = time.time()
    out = {}
    try:
        for label in labels:
            cfg = grid[label]
            t1 = time.time()
            res = sweep_scheduled(cfg, blocks, lengths, device=dev)
            hr = [round(float(h), 6) for h in res.hit_ratios()]
            src = pf_src_of(cfg)
            prec = res.precisions(src) if src else np.full(len(hr), np.nan)
            prec_mean = (None if np.isnan(prec).all()
                         else round(float(np.nanmean(prec)), 6))
            row = rows[label]
            ok = (hr == row["hit_ratios"]
                  and prec_mean == row["precision_mean"]
                  and round(float(np.mean(res.hit_ratios())), 6)
                  == row["hit_ratio_mean"])
            out[label] = {"hit_ratio_mean": round(float(np.mean(hr)), 6),
                          "precision_mean": prec_mean, "equal": ok,
                          "seconds": round(time.time() - t1, 3)}
            if not ok:
                out[label].update(got=hr, want=row["hit_ratios"],
                                  want_precision=row["precision_mean"])
    finally:
        timer.close()
    return {"labels": out, "launches": ops.launch_counts(),
            "seconds": time.time() - t0, "fold_seconds": timer.seconds,
            "n_mines": timer.mines, "traces": len(names),
            "requests": int(lengths.sum()), "corpus_crc32": crc,
            "numpy": np.__version__}


def phase_parity() -> dict:
    """The quick corpus through the 9 labels, in PARITY_GROUPS child
    processes; returns the launch counts of all of them."""
    t0 = time.time()
    procs = [subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--parity",
         ",".join(g)], stdout=subprocess.PIPE, text=True,
        env=dict(os.environ, PYTHONPATH=str(SRC))) for g in PARITY_GROUPS]
    try:
        results = []
        for proc in procs:
            out, _ = proc.communicate(timeout=1100)
            if proc.returncode != 0:
                fail(f"parity: a sweep process failed ({proc.returncode})")
            results.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    labels, counts = {}, {}
    for r in results:
        labels.update(r["labels"])
        for k, v in r["launches"].items():
            counts[k] = counts.get(k, 0) + v
    seconds = time.time() - t0
    sweep_s = sum(r["seconds"] for r in results)
    fold_s = sum(r["fold_seconds"] for r in results)
    first = results[0]
    emit({"phase": "parity", "traces": first["traces"],
          "requests": first["requests"],
          "corpus_crc32": first["corpus_crc32"], "numpy": first["numpy"],
          "processes": len(results), "labels": labels, "launches": counts,
          "seconds": seconds, "sweep_seconds": sweep_s,
          "fold_seconds": fold_s, "fold_share": fold_s / sweep_s,
          "n_mines": sum(r["n_mines"] for r in results)})
    crcs = {r["corpus_crc32"] for r in results}
    if crcs != {QUICK_CORPUS_CRC32}:
        fail(f"parity: the generated quick corpus (crc32 {crcs}) is not "
             f"the one the baseline was computed on ({QUICK_CORPUS_CRC32})")
    bad = [k for k, v in labels.items() if not v["equal"]]
    if bad or len(labels) != 9:
        fail(f"parity: {bad or 'labels missing'} differ from "
             f"BENCH_baseline_quick.json")
    if counts["mithril_record"] == 0 or not (
            counts["mithril_pairwise"] or counts["mithril_pairwise_batched"]):
        fail(f"parity: kernels not launched on the main path: {counts}")
    return counts


# ---------------------------------------------------------------------------
# phase 4: the paper's deployment at full size
# ---------------------------------------------------------------------------

def real_config():
    from repro_torch.cache import SimConfig
    from repro_torch.configs import PAPER_MITHRIL
    return SimConfig(capacity=PAPER_CAPACITY, ways=16, policy="lru",
                     use_mithril=True, mithril=PAPER_MITHRIL)


def cross_check_child(n_requests: int) -> None:
    """Child process: the CROSS_TRACES on the CPU through the plain
    versions; prints their Stats as JSON."""
    import torch
    from repro_torch.cache import pad_traces, sweep_scheduled
    from repro_torch.traces import build_corpus, corpus_specs
    torch.set_num_threads(2)
    specs = [s for s in corpus_specs(n_requests, "full")
             if s.name in CROSS_TRACES]
    suite = pad_traces(build_corpus(specs))
    res = sweep_scheduled(real_config(), suite, device="cpu")
    print(json.dumps({"names": list(suite.names),
                      "stats": {k: v.tolist() for k, v in
                                res.stats._asdict().items()},
                      "seconds": res.seconds}), flush=True)


class FoldTimer:
    """Host time inside ``mithril._fold_pairs`` (synchronised at exit)
    and the number of lane mining runs it folded."""

    def __init__(self):
        import torch
        from repro_torch.core import mithril
        self.mod, self.orig = mithril, mithril._fold_pairs
        self.seconds, self.calls, self.mines = 0.0, 0, 0

        def timed(cfg, state, src, dst, valid, dropped, need=None):
            t = time.perf_counter()
            out = self.orig(cfg, state, src, dst, valid, dropped, need)
            torch.cuda.synchronize()
            self.seconds += time.perf_counter() - t
            self.calls += 1
            self.mines += (state.ts.shape[0] if need is None
                           else int(need.sum()))
            return out
        mithril._fold_pairs = timed

    def close(self):
        self.mod._fold_pairs = self.orig


def phase_profile(dev, steps: int = 300):
    """Device busy share of the real-size sweep over its first ``steps``
    requests, from a ``torch.profiler`` trace: the sum of kernel times
    over the wall time of the traced sweep, and the kernels that take
    most of the device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.cache import sweep
    from repro_torch.traces import corpus_suite
    _, blocks, _ = corpus_suite("full", REAL_LEN)
    blocks = blocks[:, :steps]
    cfg = real_config()
    sweep(cfg, blocks[:, :20], device=dev)          # warm the allocator
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sweep(cfg, blocks, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = []
    for ev in prof.key_averages():
        dt = getattr(ev, "self_device_time_total",
                     getattr(ev, "self_cuda_time_total", 0.0))
        if dt > 0 and ev.device_type == torch.autograd.DeviceType.CUDA:
            rows.append((dt, ev.key, ev.count))
    busy = sum(r[0] for r in rows) / 1e6
    rows.sort(reverse=True)
    emit({"phase": "profile", "steps": steps, "lanes": blocks.shape[0],
          "wall_seconds": wall, "device_busy_seconds": busy,
          "device_idle_share": (1.0 - busy / wall) if busy else None,
          "kernels_per_step": sum(r[2] for r in rows) / steps,
          "top_device_time": [{"kernel": k[:80], "seconds": t / 1e6,
                               "count": c} for t, k, c in rows[:8]]})


def start_cross_check(n_requests: int = REAL_LEN) -> subprocess.Popen:
    """The CPU cross-check of the real-size phase, in a child process
    that runs while the card works (no GPU visible to it)."""
    return subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--cross-check",
         str(n_requests)], stdout=subprocess.PIPE, text=True,
        env=dict(os.environ, PYTHONPATH=str(SRC), CUDA_VISIBLE_DEVICES=""))


def phase_real(dev, child: subprocess.Popen, timer,
               n_requests: int = REAL_LEN):
    import numpy as np
    import torch
    from repro_torch.cache import sweep_scheduled
    from repro_torch.kernels import ops
    from repro_torch.traces import corpus_suite
    t_gen = time.time()
    names, blocks, lengths = corpus_suite("full", n_requests)
    t_gen = time.time() - t_gen
    cfg = real_config()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = ops.launch_counts()
    fold = (timer.seconds, timer.calls, timer.mines)
    res = sweep_scheduled(cfg, blocks, lengths, device=dev)
    torch.cuda.synchronize()
    counts = {k: v - before[k] for k, v in ops.launch_counts().items()}
    peak = torch.cuda.max_memory_allocated()
    hr = res.hit_ratios()
    if not np.isfinite(hr).all() or hr.shape != (len(names),):
        fail("real size: hit ratios are not finite")
    stats = res.stats
    fold_s = timer.seconds - fold[0]
    info = {"phase": "real_size", "traces": len(names),
            "requests": int(lengths.sum()),
            "requests_min": int(lengths.min()),
            "requests_max": int(lengths.max()),
            "lane_width": len(names), "steps": int(lengths.max()),
            "seconds": res.seconds,
            "requests_per_s": float(lengths.sum() / res.seconds),
            "fold_seconds": fold_s, "fold_calls": timer.calls - fold[1],
            "fold_share": fold_s / res.seconds,
            "n_mines": timer.mines - fold[2],
            "hit_ratio_mean": float(hr.mean()),
            "prefetch_issued": int(stats.pf_issued[:, 1].sum()),
            "prefetch_used": int(stats.pf_used[:, 1].sum()),
            "max_memory_allocated": int(peak), "launches": counts,
            "trace_gen_seconds": t_gen}
    out, _ = child.communicate(timeout=1200)
    if child.returncode != 0:
        emit(info)
        fail("real size: CPU cross-check process failed")
    cpu = json.loads(out.strip().splitlines()[-1])
    idx = [names.index(n) for n in cpu["names"]]
    for field, want in cpu["stats"].items():
        got = getattr(stats, field)[idx].tolist()
        if got != want:
            emit(info)
            fail(f"real size: CPU cross-check differs in {field}: "
                 f"{got} vs {want}")
    info["cpu_cross_check"] = {"traces": cpu["names"], "equal": True,
                               "seconds": cpu["seconds"]}
    emit(info)
    return counts


# ---------------------------------------------------------------------------
# phase 5: serving over the tiered paged-KV cache
# ---------------------------------------------------------------------------

# copies of benchmarks/serving_bench.py's PAGE, SCALES and MCFG (this
# script imports nothing of the benchmarks; a CPU test holds them equal)
SERVING_PAGE = dict(page_size=8, n_kv=2, head_dim=32)
SERVING_SCALES = {
    "quick": dict(n_tenants=5, reqs_per_tenant=10, pages_per_req=4,
                  n_host_pages=256, n_hbm_slots=13, max_batch=3,
                  idle_len=6, stagger=10),
    "full": dict(n_tenants=12, reqs_per_tenant=16, pages_per_req=4,
                 n_host_pages=1024, n_hbm_slots=22, max_batch=5,
                 idle_len=10, stagger=24),
}
SERVING_CONFIGS = (("lru_tier", False), ("mithril_tier", True))
SERVING_KEYS = ("requests", "tokens", "steps", "mean_batch_occupancy",
                "turnaround_steps_p50", "turnaround_steps_p95",
                "turnaround_steps_p99", "tier")
# llama3.2-3b's attention widths (src/repro/configs/llama3_2_3b.py: 24
# query heads, 8 kv heads, head_dim 3072 / 24) at page size 16; the tier
# stores float32
FULL_WIDTH_PAGE = dict(page_size=16, n_kv=8, head_dim=128)
FULL_WIDTH_Q_HEADS = 24


def serving_mcfg():
    from repro_torch.core import MithrilConfig
    return MithrilConfig(min_support=2, max_support=8, lookahead=40,
                         rec_buckets=512, rec_ways=4, mine_rows=8,
                         pf_buckets=512, pf_ways=4, prefetch_list=3)


def full_width_geometry() -> dict:
    """The bench's full-scale traffic (12 tenants x 16 requests, on-off
    arrivals, max batch 5) at a 2,048-token context: 128 pages a request;
    704 = 22 x 32 device slots, above one batch (640 pages) and below the
    working set of all tenants (1,536); 16,384 host pages (2 GiB of K+V)."""
    return dict(SERVING_SCALES["full"], pages_per_req=128,
                n_host_pages=16_384, n_hbm_slots=704)


def build_workload(geo: dict, seed: int = 0):
    """(arrival, rid, pages, decode_steps) rows in admission order (a copy
    of ``benchmarks/serving_bench.py::build_workload``)."""
    import numpy as np
    from repro_torch.traces import arrival_process
    rng = np.random.default_rng(seed)
    streams = {f"tenant{t:02d}": np.empty(geo["reqs_per_tenant"])
               for t in range(geo["n_tenants"])}
    arrivals = arrival_process(streams, mode="onoff", burst_len=1,
                               idle_len=geo["idle_len"],
                               stagger=geo["stagger"], seed=seed)
    working_sets = [rng.choice(geo["n_host_pages"], geo["pages_per_req"],
                               replace=False)
                    for _ in range(geo["n_tenants"])]
    rows = []
    for t, name in enumerate(streams):
        for j, at in enumerate(arrivals[name]):
            rows.append((int(at), t * geo["reqs_per_tenant"] + j,
                         working_sets[t], 2 + (t + j) % 4))
    rows.sort(key=lambda r: (r[0], r[1]))
    return rows


def serve(geo, page, n_q_heads, mithril, device, pools=None, seed=0):
    """One serving run; ``pools`` reuses another tier's host pools (the
    same seed draws the same pages)."""
    from repro_torch.cache.tiered import TieredKVCache
    from repro_torch.launch.serve import TieredServeEngine
    cfg = serving_mcfg() if mithril else None
    if pools is None:
        tier = TieredKVCache(geo["n_host_pages"], geo["n_hbm_slots"],
                             **page, mithril_cfg=cfg, seed=seed,
                             device=device)
    else:
        tier = TieredKVCache.from_host_pools(*pools, geo["n_hbm_slots"],
                                             mithril_cfg=cfg, device=device)
    eng = TieredServeEngine(tier, max_batch=geo["max_batch"],
                            n_q_heads=n_q_heads, seed=seed)
    for arrival, rid, pages, steps in build_workload(geo, seed):
        eng.submit(rid, pages, steps, arrival=arrival)
    return eng.run(), eng


def serving_cross_check_child() -> None:
    """Child process: the full-width serving runs on the CPU through the
    plain versions; prints their deterministic metrics as JSON."""
    import torch
    torch.set_num_threads(2)
    out, pools = {}, None
    for config, mithril in SERVING_CONFIGS:
        t0 = time.time()
        m, eng = serve(full_width_geometry(), FULL_WIDTH_PAGE,
                       FULL_WIDTH_Q_HEADS, mithril, "cpu", pools=pools)
        pools = (eng.tier.host_k, eng.tier.host_v)
        out[config] = {k: m[k] for k in SERVING_KEYS}
        out[config]["seconds"] = time.time() - t0
    print(json.dumps(out), flush=True)


def start_serving_cross_check() -> subprocess.Popen:
    return subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()),
         "--serving-cross-check"], stdout=subprocess.PIPE, text=True,
        env=dict(os.environ, PYTHONPATH=str(SRC), CUDA_VISIBLE_DEVICES=""))


def check_tier_decode(eng, dev, seed: int = 1) -> float:
    """A batch of the workload's working sets through ``attend_batch``
    on the warm tier, against the plain decode over the same pages taken
    straight from the host pools: finite, of shape (B, Hq, hd) and
    within 2e-5; returns the largest difference."""
    import numpy as np
    import torch
    from repro_torch.kernels.paged_decode import paged_decode_plain
    tier = eng.tier
    rng = np.random.default_rng(seed)
    rows = build_workload(full_width_geometry())
    page_lists, seen = [], set()
    for _, _, pages, _ in rows:
        if id(pages) not in seen and len(page_lists) < eng.max_batch:
            seen.add(id(pages))
            page_lists.append(pages)
    n_ctx = len(page_lists[0]) * tier.page_size
    lengths = np.asarray([n_ctx - 5 * i for i in range(len(page_lists))])
    q = rng.standard_normal((len(page_lists), eng.n_q_heads,
                             tier.head_dim)).astype(np.float32)
    got = tier.attend_batch(torch.from_numpy(q), page_lists, lengths)
    ids = torch.from_numpy(np.concatenate(page_lists))
    k = tier.host_k[ids].to(dev)
    v = tier.host_v[ids].to(dev)
    tab = torch.arange(len(ids), device=dev).reshape(len(page_lists), -1)
    want = paged_decode_plain(torch.from_numpy(q).to(dev), k, v, tab,
                              torch.from_numpy(lengths).to(dev))
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    if tuple(got.shape) != (len(page_lists), eng.n_q_heads,
                            tier.head_dim) \
            or not torch.isfinite(got).all() \
            or not torch.allclose(got, want, rtol=2e-5, atol=2e-5):
        fail(f"serving: decode through the tier differs from the plain "
             f"decode over the host pages by {err}")
    return err


class HostSpans:
    """Host seconds and calls inside named functions while open, nested
    as they call each other. Nothing is synchronised: a span that ends
    in a read of a device value includes the wait for it."""

    def __init__(self, targets: dict):
        self.seconds = {n: 0.0 for n in targets}
        self.calls = {n: 0 for n in targets}
        self._orig = []
        for name, (owner, attr) in targets.items():
            fn = getattr(owner, attr)
            self._orig.append((owner, attr, fn))
            setattr(owner, attr, self._wrap(name, fn))

    def _wrap(self, name, fn):
        def timed(*args, **kw):
            t = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                self.seconds[name] += time.perf_counter() - t
                self.calls[name] += 1
        return timed

    def close(self) -> dict:
        for owner, attr, fn in reversed(self._orig):
            setattr(owner, attr, fn)
        return {n: {"seconds": self.seconds[n], "calls": self.calls[n]}
                for n in self.seconds}


def serving_spans() -> HostSpans:
    """The serving step's host work: the demand pass and, inside it, the
    installs (eviction + the two page copies) and MITHRIL on each miss
    (record, mining check, lookup), with the mining runs inside that;
    the decode launch."""
    from repro_torch.cache.tiered import TieredKVCache
    from repro_torch.core import mithril
    return HostSpans({
        "demand_batch": (TieredKVCache, "demand_batch"),
        "install": (TieredKVCache, "_install"),
        "mithril_on_miss": (TieredKVCache, "_mithril_on_miss"),
        "mine": (mithril, "mine"),
        "decode_batch": (TieredKVCache, "decode_batch")})


def profile_serving(eng, n_requests: int = 40) -> dict:
    """Device busy share of the warm full-width MITHRIL tier serving
    ``n_requests`` more requests of the workload, from a
    ``torch.profiler`` trace: kernels and copies on the device over the
    wall time, and what takes most of the device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch.serve import TieredServeEngine
    rows = build_workload(full_width_geometry())[:n_requests]
    e2 = TieredServeEngine(eng.tier, max_batch=eng.max_batch,
                           n_q_heads=eng.n_q_heads, seed=1)
    for arrival, rid, pages, steps in rows:
        e2.submit(rid, pages, steps, arrival=arrival)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        e2.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    found = []
    for ev in prof.key_averages():
        dt = getattr(ev, "self_device_time_total",
                     getattr(ev, "self_cuda_time_total", 0.0))
        if dt > 0 and ev.device_type == torch.autograd.DeviceType.CUDA:
            found.append((dt, ev.key, ev.count))
    busy = sum(r[0] for r in found) / 1e6
    found.sort(reverse=True)
    return {"requests": len(rows), "steps": e2.steps, "wall_seconds": wall,
            "device_busy_seconds": busy,
            "device_idle_share": (1.0 - busy / wall) if busy else None,
            "device_ops_per_step": sum(r[2] for r in found) / max(1, e2.steps),
            "top_device_time": [{"op": k[:80], "seconds": t / 1e6,
                                 "count": c} for t, k, c in found[:8]]}


def phase_serving(dev, child: subprocess.Popen) -> dict:
    """Quick-scale parity against the baseline rows, then the full width
    on the card against the CPU child. Returns the launch counts."""
    import numpy as np
    import torch
    from repro_torch.kernels import ops
    rows = {r["config"]: r for r in json.loads(BASELINE.read_text())[
        "serving"] if r["job"] == "serving_quick"}
    decode = ops.KERNELS["paged_decode"]
    before = ops.launch_counts()
    merges_before = decode.merge_launches
    t0 = time.time()
    quick = {}
    for config, mithril in SERVING_CONFIGS:
        m, _ = serve(SERVING_SCALES["quick"], SERVING_PAGE, 4, mithril, dev)
        equal = all(m[k] == rows[config][k] for k in SERVING_KEYS)
        quick[config] = {k: m[k] for k in SERVING_KEYS}
        quick[config].update(equal=equal,
                             throughput_tok_s=m["throughput_tok_s"],
                             wall_seconds=m["wall_seconds"])
        if not equal:
            quick[config]["want"] = {k: rows[config][k] for k in SERVING_KEYS}
    info = {"phase": "serving", "numpy": np.__version__,
            "quick": quick, "quick_seconds": time.time() - t0}
    geo = full_width_geometry()
    info["full_width"] = {"geometry": geo, "page": FULL_WIDTH_PAGE,
                          "q_heads": FULL_WIDTH_Q_HEADS, "dtype": "float32",
                          "runs": {}}
    full, pools, warm = info["full_width"]["runs"], None, None
    for config, mithril in SERVING_CONFIGS:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        c0 = ops.launch_counts()
        t1 = time.time()
        spans = serving_spans()
        try:
            m, eng = serve(geo, FULL_WIDTH_PAGE, FULL_WIDTH_Q_HEADS,
                           mithril, dev, pools=pools)
            torch.cuda.synchronize()
        finally:
            host_spans = spans.close()
        seconds = time.time() - t1
        pools = (eng.tier.host_k, eng.tier.host_v)
        full[config] = dict(m, seconds=seconds, host_spans=host_spans,
                            max_memory_allocated=int(
                                torch.cuda.max_memory_allocated()),
                            launches={k: v - c0[k] for k, v in
                                      ops.launch_counts().items()})
        if mithril:
            full[config]["n_mines"] = int(eng.tier._mstate.n_mines[0])
            warm = eng
    counts = {k: v - before[k] for k, v in ops.launch_counts().items()}
    # the decode's merge kernel, launched by its wrapper when a plan has
    # more than one split (at full width)
    counts["paged_decode_merge"] = decode.merge_launches - merges_before
    # off the counted path: the data plane against the host pages, and a
    # profiled window of the warm tier
    info["full_width"]["tier_decode_max_abs_err"] = check_tier_decode(
        warm, dev)
    info["full_width"]["profile"] = profile_serving(warm)
    del warm, pools
    out, _ = child.communicate(timeout=1100)
    if child.returncode != 0:
        emit(info)
        fail("serving: CPU cross-check process failed")
    cpu = json.loads(out.strip().splitlines()[-1])
    for config, _ in SERVING_CONFIGS:
        got = {k: full[config][k] for k in SERVING_KEYS}
        want = {k: cpu[config][k] for k in SERVING_KEYS}
        full[config]["cpu_equal"] = got == want
        full[config]["cpu_seconds"] = cpu[config]["seconds"]
        if got != want:
            full[config]["cpu"] = want
    info["launches"] = counts
    emit(info)
    bad = [c for c, v in quick.items() if not v["equal"]]
    if bad:
        fail(f"serving: {bad} differ from BENCH_baseline_quick.json")
    bad = [c for c, v in full.items() if not v["cpu_equal"]]
    if bad:
        fail(f"serving: full-width {bad} differ from the CPU run")
    return counts


# ---------------------------------------------------------------------------

def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--cross-check":
        sys.path.insert(0, str(SRC))
        cross_check_child(int(sys.argv[2]))
        return 0
    if len(sys.argv) == 2 and sys.argv[1] == "--serving-cross-check":
        sys.path.insert(0, str(SRC))
        serving_cross_check_child()
        return 0
    if len(sys.argv) == 3 and sys.argv[1] == "--parity":
        import torch
        sys.path.insert(0, str(SRC))
        emit(parity_labels(torch.device("cuda"), sys.argv[2].split(",")))
        return 0
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke: run from a checkout of the repository (no "
              "src/repro_torch here)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    t_start = time.time()
    children = {"real_size": start_cross_check(),
                "serving": start_serving_cross_check()}
    try:
        return run(children, t_start)
    finally:
        for child in children.values():
            if child.poll() is None:
                child.kill()
                child.wait()


def run(children: dict, t_start: float) -> int:
    import torch
    smi = nvidia_smi()
    print(smi, flush=True)
    from repro_torch.kernels import backend
    t0 = time.time()
    libs = backend.build_all(force=True)
    dev = torch.device("cuda")
    emit({"phase": "build", "device": torch.cuda.get_device_name(0),
          "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda,
          "libraries": [str(p.relative_to(ROOT)) for p in libs.values()],
          "seconds": round(time.time() - t0, 3),
          "ptxas_paged_decode": ptxas_report(
              backend.BUILD_LOGS["paged_decode"])})

    timing, errs = phase_kernels(dev)
    # the main path: the parity sweeps (in child processes, whose
    # counters start at zero), the real-size sweep and the serving runs,
    # counted from zero here to the end of the serving phase
    from repro_torch.kernels import ops
    ops.reset_launch_counts()
    by_path = {"parity": phase_parity()}
    timer = FoldTimer()
    by_path["real_size"] = phase_real(dev, children["real_size"], timer)
    timer.close()
    by_path["serving"] = phase_serving(dev, children["serving"])
    counts = {k: sum(c[k] for c in by_path.values()) for k in KERNEL_INFO}
    merges = by_path["serving"]["paged_decode_merge"]    # only serving
    missing = [k for k, v in counts.items() if v == 0]
    if merges == 0:
        missing.append("paged_decode (merge)")
    if missing:
        fail(f"kernels never launched on the main path: {missing}")
    phase_profile(dev)

    # each kernel timed at the shape the main path launches it most:
    # record at the real-size sweep's (paper tables, 135 lanes; its
    # parity and serving shapes are under "at_parity" / "at_serving"),
    # one-lane pairwise at the serving tier's (MCFG, N = 8, W = 7; its
    # parity shape under "at_parity"), batched pairwise at the parity
    # sweeps' (the real-size sweep never mines), decode and lookup at
    # the full-width serving run's (decode's quick-scale shape is under
    # "at_quick")
    kernels = []
    for name, (src, replaces) in KERNEL_INFO.items():
        ms, plain_ms, by, ops_, dev_ms, lib_ms = (timing[name] + (None,))[:6]
        bound_ms, bound_by = bound(by, ops_)
        row = {"name": name, "route": "cuda", "source": src,
               "replaces": replaces, "launches": counts[name],
               "launches_by_path": {p: c[name] for p, c in by_path.items()},
               "max_abs_err": errs[name], "ms": ms, "device_ms": dev_ms,
               "plain_ms": plain_ms, "bound_ms": bound_ms,
               "bound_by": bound_by, "library_ms": lib_ms}
        if name == "paged_decode":
            row["merge_launches"] = merges
            row.update(timing[name][6])
        for tag in ("parity", "quick", "b1", "serving"):
            if f"{name}@{tag}" in timing:
                t = timing[f"{name}@{tag}"]
                row[f"at_{tag}"] = {"ms": t[0], "device_ms": t[4],
                                    "plain_ms": t[1],
                                    "bound_ms": bound(t[2], t[3])[0]}
                if len(t) > 5:
                    row[f"at_{tag}"]["library_ms"] = t[5]
                if len(t) > 6:
                    row[f"at_{tag}"].update(t[6])
        kernels.append(row)
    emit({"kernels": kernels})
    emit({"phase": "done", "seconds": round(time.time() - t_start, 3)})
    print(nvidia_smi(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
