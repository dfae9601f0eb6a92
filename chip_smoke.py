#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of MITHRIL end to end on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure exits non-zero:

1. device and build — the card's name and power limit, then the CUDA
   kernels built from ``src/repro_torch/kernels/csrc`` into
   ``build/kernels``, one ``nvcc`` per source, all at once, with what
   ptxas reports for the decode and mining kernels (registers, spills);
2. kernels — each kernel against its plain PyTorch version on the card:
   the record and codes kernels at the paper's shapes (L = 1, 16, 135
   lanes), at the parity sweeps' shapes (``SUITE_MITHRIL``, 16 lanes)
   and odd cases, exactly (int32); the fused mining run
   (``mithril_mine_step``) exactly, every state leaf, at the serving
   tier's tables (MCFG, one lane), the parity sweeps' (16 lanes, mixed
   need, and symmetric), the paper's (L = 1, 16, 135; and 135 lanes with
   no lane to mine, the real-size sweep's launch; one lane with no
   valid row) and a pairs cap that cuts rows, with the serving tier's
   whole mining run (launch, lookup, read) on the host clock; the
   decode kernel at the shapes of
   ``tests/test_kernels.py::TestPagedDecodeKernel`` and at llama3.2-3b's
   attention widths (5 rows and one row; lengths 0, 1, ragged and
   full), float32 within 2e-5 and bfloat16 within 2e-2; the lookup
   kernel exactly, Q = 1 and EMPTY queries included; the serving tier's
   miss launch (record event + probe, ``mithril_miss_step``) exactly, at
   the serving tables, need = 0 and 1; the request step's cache set
   (``cache_access``, ``mithril_prefetch``) exactly, every output and
   carry leaf, on card copies of a warm state, with the mining barrier
   between steps, at the benchmark's and the paper's tables (135 lanes),
   16 lanes FIFO and one paper lane. ``ms`` is the median CUDA-event
   time of one call as the main path makes it (wrapper included; for
   the miss launch the host clock around the tier's whole call, the wait
   for the result included; for the mining run a call on a fresh copy of
   the state each time), ``host_ms`` (record, codes, mining run, lookup)
   the host clock of a call that is not waited for, ``device_ms`` the
   kernel's own time in a ``torch.profiler`` trace (decode: split kernel
   plus merge, with the split plan), ``bound_ms`` the least bytes (or
   operations) of the same call over the card's peak, ``library_ms``
   one PyTorch call computing the same function, where there is one;
   ``launch_floor_ms`` is the device time of one PyTorch elementwise op
   on a one-element tensor, and ``floor_ratio`` a kernel's device time
   over it;
3. parity — the port's ``sweep_scheduled`` over the 16-trace quick
   corpus (4000 requests) for the 9 labels of the benchmark grid at
   capacity 512, in three processes at once, through the chunk runner
   (one captured CUDA graph a label, replayed); each label's rounded hit
   ratios (and mean precision) must equal the ``corpus_figures_quick``
   rows of ``results/bench/BENCH_baseline_quick.json``; three MITHRIL
   labels (``PARITY_PROFILED``) are swept again, which must capture
   nothing and give the same bits, under ``torch.profiler``, whose
   device time of the mining kernel is the label's mining time;
4. real size — the paper's deployment: the full 135-trace corpus
   (22.5k-50k requests per trace), the paper's MITHRIL tables and a
   65,536-block cache with 16 ways, ``mithril-lru`` in one sweep of 135
   lanes through the runner. Before it: its first 2,000 steps as the
   eager loop over ``build_batched_step``'s step and through the runner,
   every carry leaf and hit row equal, both timed; its first 2,048 steps
   through runners of G = 1, 16, 64 and 128 steps a graph, captured, then
   timed on a repeat that must capture nothing. 4 of its traces, one per
   family, are run again on the CPU through the plain versions (in a
   child process, meanwhile) and must give equal ``Stats`` (the child
   starts with the script);
4b. paper mining — the same deployment where MITHRIL mines: 135 traces
   ``looping(PAPER_LEN, loop_len=18_000, n_loops=4, seed=s)``, s = 1 to
   135 (72,000 blocks a trace against the 65,536-block cache), in one
   group through ``sweep_scheduled`` and the runner; every lane must
   mine and issue prefetches; plain LRU on the same traces; seeds 1 and
   2 again on the CPU through the plain versions (a child started with
   the script): equal ``Stats`` and mining runs (at least two each);
   then, from the state the sweep left, the traces' next requests as
   eager steps and as replays across mining barriers (every leaf and hit
   equal, lanes must mine) and a profiled window: the device time of a
   barrier where a lane mines, and the mining kernel's share;
5. streaming — ``sweep_streaming``: (a) ``benchmarks/serving_bench.py``'s
   ``pipeline_quick`` job, sync then async, every deterministic field
   equal to the ``streaming`` rows of ``BENCH_baseline_quick.json`` and
   the async hit curve equal to the sync one; (b) the real-size
   configuration and corpus through 64 recycled lanes under the job's
   on-off arrivals with the async producer, each trace's ``Stats`` equal
   to the offline real-size sweep's; the ``pipeline`` telemetry of each;
6. learned — the online MITHRIL search (``learn.adapt``) and the policy
   heads' training (``learn.train``): (a) ``benchmarks/adaptive_bench.py``'s
   hill-climb then bandit (8 episodes, seed 0, top 4) over the quick
   corpus, base ``mithril-lru`` at capacity 512 over its 12-arm grid,
   from fresh runners (``reset_runners``), every deterministic field
   (arms, labels, hit ratios, means, decision CRC, graphs captured)
   equal to the ``learned`` rows of ``BENCH_baseline_quick.json``; the
   hill-climb again, which must capture nothing and give the same bits
   (the bandit's repeat is held in (b)); (b) the
   135-trace corpus at 2,000 requests a trace (the bench's 50,000 cut by
   the script's time limit) exported with ``traces.io.write_corpus_dir``
   and loaded back through ``RealCorpus`` (fingerprint and padded matrix
   equal to the synthetic suite's), both searchers at 135 lanes: the 16
   quick traces' hill-climb arms and hit ratios equal to a hill-climb
   of those 16 alone at the same length, every
   committed hit ratio at least its static one, every arm on the grid,
   the bandit's decisions equal on a repeat, and each committed arm's
   hit ratios equal to a plain ``sweep`` of its config over the lanes
   that committed it; seconds, captures and peak device memory; (c)
   ``learn.train.train_heads`` (both heads, 400 steps on the quick
   corpus) on the card and on the CPU from one generator seed:
   parameters equal bit for bit, losses within 1e-6, Q8 weights equal;
7. serving — the tiered paged-KV cache under multi-tenant on-off
   arrivals through ``launch.serve.TieredServeEngine``, with and without
   MITHRIL: (a) at ``benchmarks/serving_bench.py``'s quick scale, where
   every deterministic field must equal the ``serving`` rows of
   ``BENCH_baseline_quick.json``; (b) at llama3.2-3b's attention widths
   (24 query heads, 8 kv heads, head_dim 128, page 16, float32) with the
   bench's full-scale traffic at a 2,048-token context (128 pages a
   request, 704 device slots, 16,384 host pages), whose counters must
   equal a CPU run of the port in a child process (started with the
   script), and whose decode through the tier must match the plain
   decode over the host pages; each MITHRIL run must launch the miss
   kernel once per demand fetch and the mining run (and the lookup after
   it) once per mining run, and the line gives the host time of a mining
   run and of a miss outside mining;
8. model — the model substrate (``models.lm``, ``launch.serve``):
   (a) ``reduced_config`` llama3.2-3b, qwen2-moe-a2.7b,
   recurrentgemma-9b, rwkv6-1.6b and whisper-medium (weights from the
   CPU generator of seed 0; whisper with seeded frames), 24-token
   prefills (RWKV also 32: its chunked form; 24 takes the sequential
   one) then 4 teacher-forced decode steps on the card, logits within
   rtol = atol = 5e-2 of a CPU run in a child process (started after
   the parity phase); (b) llama3.2-3b, recurrentgemma-9b, rwkv6-1.6b and
   whisper-medium at their published widths (weights from a seeded card
   generator; each freed before the next) with ``launch.serve.main``'s
   defaults (4 requests x 32-token prompts x 16 decode steps), through
   ``ServeLoop`` (whisper, whose prefill takes 1,500 seeded frames,
   through ``prefill`` / ``decode_step``): prefill seconds a request,
   decode ms a token (p50, p99), tok/s, peak device memory, the
   weights-read-once bound, kernels and device time a token from a
   profiled window; every logit finite; each one's depth-cut twins (the
   embedding, head and first 2 layers; whisper's with 2 encoder
   layers; recurrentgemma's first (rglru, rglru, local) unit as two
   twins, ``TWIN_SPANS``) on the card and copied to the CPU agree within
   the same tolerance; (c) ``benchmarks/expert_prefetch.py``'s
   path: the expert access stream captured from the MoE routers of a
   reduced qwen2-moe (16 experts, top 4, 8 layers, 6 tenants' 2 x 64
   tokens) on the card, then ``simulate`` with LRU and MITHRIL-LRU
   (capacity 48, ``SUITE_MITHRIL`` with lookahead 40, support 2)
   through the record kernel and the mining run: the trace and both
   ``Stats`` must equal the CPU child's;
8b. training — ``launch.train`` (``models.lm.forward_train`` and its
   backward, remat, in-place AdamW, the data pipeline, checkpoints):
   (a) reduced llama3.2-3b and qwen2-moe-a2.7b, 4 steps (batch 2, seq
   64, remat "full") from the CPU generator's seed-0 weights, each
   step's loss and gradient norm within rtol = atol = 5e-2 of a CPU
   child (started after the model phase); on the card, 12 steps
   uninterrupted and 12 steps stopped by an injected worker failure
   after 7, then resumed from the step-5 checkpoint: 7 finite losses
   within the tolerance of the uninterrupted run's; (b) llama3.2-3b at
   its published widths, 6 steps of batch 8 x 128 tokens (remat "full",
   checkpointing off): step ms (p50 of steps 2-6, host clock ending in
   the loss read, which waits for the step), tokens/s, peak device
   memory, every loss and gradient norm finite, the step's bound (8 N
   tokens FLOPs at 989 TFLOP/s, plus 30 B a parameter of AdamW and its
   norm at 3.35 TB/s), and kernels and device time of one profiled step
   of a fresh model; (c) its embedding, head and first 2 layers as a
   model, one forward_train + backward of 1 x 64 tokens on the card and
   the CPU: loss within the tolerance, every gradient leaf within a
   relative L2 error of 5e-2; (d) the data pipeline's MITHRIL readahead
   (``tests/test_runtime.py``'s configuration, 16 shards in groups of
   4, 200 steps, which never mines; and 64 shards over 400 steps, which
   does) on the card: hits, misses and staged set equal to the CPU
   child's, hits at least plain staging's, one miss launch a miss and
   one mining run and one lookup a mining run;
8c. distribution — ``torch.distributed`` at world size 1: an NCCL
   group over an in-memory store (no network) and the (1, 1) smoke mesh
   (``launch.mesh.make_smoke_mesh``): (a) llama3.2-3b at full width and
   depth, ``main``'s 4 x 32-token prompts and 16 teacher-forced decode
   steps through the plain ``prefill`` / ``decode_step``, then through
   ``launch.steps.jit_cell``'s prefill and decode cells on the same
   weights (now DTensors placed by the spec rules, ``tp_serve`` for
   decode): logits within rtol = atol = 5e-2 of the plain path's (the
   largest difference printed; 0 expected at one rank), ms a token of
   both; (b) the training twin (the embedding, head and 2 layers, 1 x
   64) one step through ``jit_cell``'s train cell (fsdp) and one of
   ``make_train_fn`` from equal states: loss and gradient norm within
   rtol = atol = 1e-3; (c) ``dist.moe_ep.moe_ffn_tp`` and
   ``moe_ffn_ep`` on the mesh at qwen2-moe-a2.7b's published widths
   (one layer, 512 tokens) against dense ``moe_ffn``: expert choices
   equal, logits within 1e-5, outputs within 2e-2; (d)
   ``compressed_psum`` on the group against int8 quantize-dequantize;
   (e) ``sweep_scheduled(shard=True)`` (one shard here) and with
   ``devices=[dev, dev]`` (two lane blocks, each through its own
   captured-graph runner on the card) against ``shard=False`` for
   ``mithril-lru`` over the first 2,000 requests of the quick corpus:
   equal ``Stats`` and hits, and the two-runner sweep launches the
   record kernel and the mining run (its launches are this phase's
   main path);
   (f) the dry run (``launch.dryrun``) of llama3.2-3b ``train_4k`` and
   ``decode_32k`` on the 256-rank production mesh, in a CPU child (a
   fake process group cannot share a process with the NCCL one): flops
   a device against ``model_flops / 256``, collectives by kind;
9. profile — 300 replayed steps of the real-size sweep under
   ``torch.profiler``: device idle share, kernels a step, and the launch
   counters against the profiler's count of the record kernel and the
   mining run.

A captured graph calls no Python at replay, so the runner counts each
graph's launches at its capture and adds them at every replay: the
counters stay the launches the card ran. The main path is phases 3-8c
(4b's windows after its main sweep do not count):
the launch counters are zeroed just before the parity sweeps and read
after each of the later phases' main runs (the learned phase's searches
launch the record kernel and the mining run); the
record, lookup and decode kernels, the serving tier's miss launch, the
fused mining run and the decode's merge must have launched on one of
them, and the two codes launches on none: the main path mines only
through ``mithril_mine_step``, and the codes launches, the counterparts
of the TPU kernels' own contract, are held and timed in phase 2; the
``kernels`` line gives the launches of each phase.
(At the paper's sizes the 50k request traces never fill the
65,536-block cache, so the real-size sweep records every miss but never
mines; its barrier launches the mining run with no lane to mine. The
paper-mining phase's loops overflow the cache, and there it mines.)
Each ``kernels`` row's ``bound_ms`` is the package's touched-byte bound
(``repro_torch.roofline.touched``) on the inputs this run timed. The
last lines are the
``kernels`` JSON line, the card's name and power limit, and
``{"ok": true, "device": {...}}``.
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
PAPER_CAPACITY = 65_536       # the paper's 256 MB cache at 4 KB blocks
PARITY_CAPACITY = 512
PARITY_LEN = 4_000
# crc32 of the (16, 4000) int32 block matrix of corpus_suite("quick", 4000):
# the traces the baseline rows were computed on
QUICK_CORPUS_CRC32 = 766487755
REAL_LEN = 50_000
CROSS_TRACES = ("seq000", "loop003", "midfreq005", "mixed007")
REPLAY_STEPS = 2_000          # the replay-equals-eager prefix
UNROLL_STEPS = 2_048          # the prefix that G is timed on (a multiple
UNROLLS = (1, 16, 64, 128)    # of each G)
# a copy of benchmarks/serving_bench.py's PIPE_SCALES["quick"] (a CPU test
# holds it equal) and the deterministic fields of its streaming rows
PIPE_QUICK = dict(n_streams=6, stream_len=2500, lane_width=4, chunk=256)
PIPE_KEYS = ("lane_width", "chunk", "n_slabs", "lane_steps",
             "ideal_lane_steps", "waste_ratio", "hit_ratio_mean")
STREAM_WIDTH = 64             # lanes of the full-width stream: they recycle
STREAM_CHUNK = 1024

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
    # the serving tier's miss: the record event and the lookup of its page
    # in one launch
    "mithril_miss_step": (
        "src/repro_torch/kernels/csrc/mithril_record.cu",
        "src/repro/kernels/mithril_record.py:199"),
    # the whole mining run (sort, codes, selection, compaction, fold,
    # clear) in one launch
    "mithril_mine_step": (
        "src/repro_torch/kernels/csrc/mithril_mine.cu",
        "src/repro/kernels/mithril_mine_batched.py:72"),
    # the request step's cache set, which the reference computes as plain
    # jnp code: the demand access with its statistics and record event,
    # and the MITHRIL lookup with its prefetch inserts
    "cache_access": (
        "src/repro_torch/kernels/csrc/cache_set.cu",
        "src/repro/cache/base.py:160 (jnp, no Pallas kernel)"),
    "mithril_prefetch": (
        "src/repro_torch/kernels/csrc/cache_set.cu",
        "src/repro/core/mithril.py:64 with src/repro/cache/base.py:208 "
        "(jnp, no Pallas kernel)"),
}
ALSO_REPLACES = {"mithril_miss_step": "src/repro/kernels/hash_lookup.py:62",
                 "mithril_mine_step": "src/repro/kernels/mithril_mine.py:88"}
# the codes launches keep the TPU kernels' contract for callers that pass
# a pairwise function; the main path mines through mithril_mine_step
OFF_PATH = ("mithril_pairwise", "mithril_pairwise_batched")


def kernel_path(counts) -> bool:
    """Sweeps ran through the hand-written kernels alone: the cache access
    with its record event, the MITHRIL prefetch and the mining run, and
    no codes launch."""
    return bool(counts["cache_access"] and counts["mithril_prefetch"]
                and counts["mithril_mine_step"]
                and not any(counts[k] for k in OFF_PATH))


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


def host_ms(fn, reps: int = 200, warm: int = 5) -> float:
    """Median host-clock milliseconds of one call of ``fn``: what the
    host spends on it, the wait included for a call that waits for its
    result (the serving tier's miss does), the enqueue alone otherwise."""
    import torch
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    marks = []
    for _ in range(reps):
        t = time.perf_counter()
        fn()
        marks.append(time.perf_counter() - t)
    return statistics.median(marks) * 1e3


def fresh_ms(call, restore, reps: int = 30, warm: int = 3):
    """Median CUDA-event ms and host-clock ms of ``call`` on a state that
    ``restore`` resets before every call, outside both clocks (the reset
    is queued before the first event, so the interval holds the call)."""
    import torch
    for _ in range(warm):
        restore()
        call()
    torch.cuda.synchronize()
    marks, host = [], []
    for _ in range(reps):
        restore()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        t = time.perf_counter()
        call()
        host.append(time.perf_counter() - t)
        b.record()
        marks.append((a, b))
    torch.cuda.synchronize()
    return (statistics.median(a.elapsed_time(b) for a, b in marks),
            statistics.median(host) * 1e3)


def trace_kernels(prof, copies: bool = False):
    """``(name, device microseconds, launches)`` of every CUDA kernel
    (and, with ``copies``, every copy and fill) in a ``torch.profiler``
    trace, read from the profiler's raw events (a replayed sweep has
    millions; the event tables of ``key_averages`` are too slow for
    that), by name."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    rows = {}
    for ev in prof.profiler.kineto_results.events():
        name = ev.name()
        if ev.device_type() != cuda or (
                not copies and name.startswith(("Memcpy", "Memset"))):
            continue
        us = (ev.duration_ns() / 1e3 if hasattr(ev, "duration_ns")
              else ev.duration_us())
        t, n = rows.get(name, (0.0, 0))
        rows[name] = (t + us, n + 1)
    return [(k, t, n) for k, (t, n) in rows.items()]


def profiled_kernels(fn, reps: int):
    """``(name, device seconds * 1e6, launches)`` of every CUDA kernel
    and copy in a ``torch.profiler`` trace of ``reps`` calls of ``fn``."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return trace_kernels(prof, copies=True)


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


def ptxas_report(log: str, names: str = "paged_decode_(?:split|merge)"
                 ) -> list:
    """Registers, spills and static shared memory of each kernel whose
    name matches ``names`` in an ``nvcc -Xptxas -v`` log, the decode
    kernels' template arguments spelt out."""
    import re
    rows, row = [], None
    for line in log.splitlines():
        m = re.search(rf"Compiling entry function '[^']*?({names})"
                      r"(?:I(13__nv_bfloat16|f)Li(\d+)E)?", line)
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


def touched():
    """The package's touched-byte kernel bounds
    (``repro_torch.roofline.touched``): ``bound_ms`` and the least bytes
    and operations of each launch on this run's inputs."""
    from repro_torch.roofline import touched as mod
    return mod


def floor_ratio(dev_ms, floor):
    """A kernel's device time over the launch floor (None unmeasured)."""
    return dev_ms / floor if dev_ms and floor else None


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

RECORD_LEAVES = ("rec_key", "rec_ts", "rec_cnt", "rec_age", "rec_loc",
                 "rec_row", "mine_block", "mine_ts", "mine_cnt", "mine_fill",
                 "ts")


def max_err(got, want) -> int:
    return int((got.long() - want.long()).abs().max()) if got.numel() else 0


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
    kernel's device ms, the largest absolute difference seen and the
    host-clock ms of a call (the launch not waited for)."""
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
    by = statistics.mean(touched().record_event_bytes(cfg, c, blk, en)
                         for _ in range(33))
    del c

    def kern():
        record_step_kernel(blk, en, *(getattr(a, f) for f in RECORD_LEAVES))
    ms = cuda_ms(kern)
    dev_ms = device_ms(kern, "record_kernel")
    plain_ms = cuda_ms(lambda: record_step_plain(
        blk, en, *(getattr(b, f) for f in RECORD_LEAVES)))
    return (ms, plain_ms, by, touched().record_ops(cfg, int(en.sum())),
            dev_ms, err, host_ms(kern, reps=100))


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
    tb = touched()
    return ms, plain_ms, tb.pairwise_bytes(lanes, n, s, window), \
        tb.pairwise_ops(lanes, n, s, window), int((want > 0).sum()), dev_ms, \
        err, host_ms(kern, reps=100)


# the state leaves a mining run reads or writes
MINE_LEAVES = ("mine_block", "mine_ts", "mine_cnt", "mine_fill", "rec_key",
               "rec_loc", "pf_key", "pf_vals", "pf_cnt", "pf_age", "ts",
               "n_mines", "n_pairs", "n_dropped")


def random_mine_state(cfg, lanes, dev, rng, valid_frac=0.85):
    """A stacked state whose mining tables are full, in migration order:
    rows of clustered timestamps (weak and strong pairs, first
    timestamps that tie), some frequent and cleared rows; prefetch tables
    half full, their sources among the mined blocks; the recording
    table as record events leave it: a slot points into the mining table
    (rec_loc = 1) only where it holds a mined block, in that block's
    bucket."""
    import numpy as np
    import torch
    from repro_torch.core import init_state
    from repro_torch.core.hashindex import bucket_index
    st = init_state(cfg, dev, lanes=lanes)
    n, s, r = cfg.mine_rows, cfg.max_support, cfg.min_support
    n_clusters = max(1, n // 6)
    pattern = np.sort(rng.integers(0, 3 * cfg.lookahead // 4 + 2,
                                   (lanes, n_clusters, s)), -1)
    start = rng.integers(0, 12 * n, (lanes, n_clusters))
    which = rng.integers(0, n_clusters, (lanes, n))
    ar = np.arange(lanes)[:, None]
    ts = (start[ar, which][..., None] + pattern[ar, which]
          + rng.integers(0, 3, (lanes, n))[..., None])
    cnt = rng.integers(r, s + 1, (lanes, n))
    cnt = np.where(rng.random((lanes, n)) < valid_frac, cnt,
                   rng.choice([0, s + 1], (lanes, n)))
    ts = np.where(np.arange(s) < np.minimum(cnt, s)[..., None], ts, 0)
    universe = 3 * cfg.pf_buckets
    pf_shape, rec_shape = tuple(st.pf_key.shape), tuple(st.rec_key.shape)
    blocks = rng.integers(0, universe, (lanes, n))
    rec_key = rng.integers(0, universe, rec_shape)
    rec_loc = np.zeros(rec_shape, np.int32)
    bucket = bucket_index(torch.as_tensor(blocks.astype(np.int32)),
                          cfg.rec_buckets).numpy()
    way = rng.integers(0, cfg.rec_ways, (lanes, n))
    rec_key[ar, bucket, way] = blocks
    rec_loc[ar, bucket, way] = 1
    fill = {"mine_block": blocks,
            "mine_ts": ts, "mine_cnt": cnt, "mine_fill": np.full(lanes, n),
            "rec_key": rec_key, "rec_loc": rec_loc,
            "pf_key": np.where(rng.random(pf_shape) < 0.5,
                               rng.integers(0, universe, pf_shape), -1),
            "pf_vals": rng.integers(-1, universe, tuple(st.pf_vals.shape)),
            "pf_cnt": rng.integers(0, 7, pf_shape),
            "pf_age": rng.integers(0, 10**6, pf_shape),
            "ts": rng.integers(10**6, 2 * 10**6, lanes),
            "n_mines": rng.integers(0, 9, lanes),
            "n_pairs": rng.integers(0, 999, lanes),
            "n_dropped": rng.integers(0, 99, lanes)}
    for name, value in fill.items():
        getattr(st, name).copy_(torch.as_tensor(value.astype(np.int32)))
    return st


def check_mine_step(cfg, lanes, dev, rng, need_frac=1.0, timed=False,
                    plain_reps=10, valid_frac=0.85):
    """The fused mining run against ``mine_step_plain`` on copies of a
    warm state, every leaf exactly, and the lanes whose flag is clear
    untouched; when ``timed``, both on a fresh copy a call, the kernel's
    device time and host clock, and the run's least bytes and
    operations."""
    import torch
    from repro_torch.kernels.mithril_mine_step import (mine_step_kernel,
                                                       mine_step_plain)
    base = random_mine_state(cfg, lanes, dev, rng, valid_frac)
    need = torch.as_tensor(rng.random(lanes) < need_frac, device=dev)
    got = type(base)(*(x.clone() for x in base))
    want = type(base)(*(x.clone() for x in base))
    mine_step_kernel(cfg, got, need)
    mine_step_plain(cfg, want, need)
    torch.cuda.synchronize()
    err = 0
    for name in base._fields:
        a, b, x = getattr(got, name), getattr(want, name), getattr(base, name)
        err = max(err, max_err(a, b))
        if not torch.equal(a, b) or not torch.equal(a[~need], x[~need]):
            fail(f"mining run differs from plain in {name} (L={lanes}, "
                 f"N={cfg.mine_rows}, W={cfg.window}, "
                 f"pairs_cap={cfg.pairs_cap}, symmetric={cfg.symmetric}, "
                 f"need {int(need.sum())} of {lanes})")
    out = {"err": err, "lanes_mined": int(need.sum()),
           "pairs_stored": int((want.n_pairs - base.n_pairs).sum()),
           "pairs_dropped": int((want.n_dropped - base.n_dropped).sum())}
    if not timed:
        return out
    work = type(base)(*(x.clone() for x in base))

    def restore():
        for f in MINE_LEAVES:
            getattr(work, f).copy_(getattr(base, f))

    def kern():
        mine_step_kernel(cfg, work, need)
    ms, hms = fresh_ms(kern, restore)
    dev_ms = device_ms(lambda: (restore(), kern()), "mine_step_kernel")
    plain_ms, _ = fresh_ms(lambda: mine_step_plain(cfg, work, need),
                           restore, reps=plain_reps, warm=1)
    by, ops, pairs = touched().mine_step_work(cfg, base, need)
    out.update(ms=ms, host_ms=hms, device_ms=dev_ms, plain_ms=plain_ms,
               bytes=by, ops=ops, pairs_kept=pairs)
    return out


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
    tb = touched()
    return err, (ms, plain_ms, tb.decode_bytes(q, kp, tab, lens),
                 tb.decode_ops(q, lens), dev_ms, lib_ms,
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
    def kern():
        return ops.prefetch_lookup(queries, pf_key, pf_vals)
    ms = cuda_ms(kern)
    dev_ms = device_ms(kern, "hash_lookup")
    plain_ms = cuda_ms(lambda: hash_lookup_plain(queries, pf_key, pf_vals))
    tb = touched()
    return err, (ms, plain_ms, tb.lookup_bytes(queries, pf_key, pf_vals),
                 tb.lookup_ops(n_q, ways), dev_ms, None,
                 {"host_ms": host_ms(kern, reps=100)})


def serving_pages(rng, n_events, n_sets=12, universe=1024):
    """Misses of a multi-tenant tier: one tenant's 4 working-set pages
    in order at a time, now and then a stray page or an EMPTY (-1) page."""
    sets = [rng.choice(universe, 4, replace=False) for _ in range(n_sets)]
    out = []
    while len(out) < n_events:
        out.extend(int(p) for p in sets[rng.integers(n_sets)])
        if rng.random() < 0.2:
            out.append(int(rng.integers(universe)))
        if rng.random() < 0.03:
            out.append(-1)
    return out[:n_events]


def warm_miss_state(cfg, dev, rng, events=400):
    """A one-lane state after ``events`` misses of a tier (the plain
    version, mining when the table fills): live recording and mining
    rows, associations in the prefetch table."""
    from repro_torch.core import init_state, maybe_mine
    from repro_torch.kernels.mithril_record import miss_step_plain
    st = init_state(cfg, dev)
    for page in serving_pages(rng, events):
        if int(miss_step_plain(page, st, cfg.mine_rows)[0]):
            maybe_mine(cfg, st)
    return st


def check_miss(cfg, dev, rng, events=300):
    """The serving tier's miss launch against ``miss_step_plain`` on
    copies of one warm state, exactly: the result and every record leaf
    after every event, the tier's own call (``ops.MissStep``) on a third
    copy; all copies mine when need is 1. Then, on one page with
    candidates: the tier's call on the host clock (``ms``, the wait
    included), the launch alone (CUDA events, and its device time), the
    plain version with its result read on the host, and the two ways to
    bring the result home in turns (mapped, async copy, async copy,
    mapped): the kernel storing to pinned memory through its mapping,
    or to a device buffer that an async copy moves to pinned memory."""
    import torch
    from repro_torch.core import maybe_mine
    from repro_torch.kernels import ops
    from repro_torch.kernels.mithril_record import (miss_step_kernel,
                                                    miss_step_plain)
    base = warm_miss_state(cfg, dev, rng)
    a, b, c = (type(base)(*(x.clone() for x in base)) for _ in range(3))
    out = torch.empty(1 + cfg.prefetch_list, dtype=torch.int32,
                      pin_memory=True)
    step = ops.MissStep(cfg.mine_rows, cfg.prefetch_list, dev)
    err, needs, hit_page = 0, 0, None
    for page in serving_pages(rng, events):
        want = miss_step_plain(page, b, cfg.mine_rows).cpu()
        miss_step_kernel(page, a, cfg.mine_rows, out)
        need, cand = step(c, page)
        torch.cuda.synchronize()
        err = max(err, max_err(out, want))
        same = [f for f in RECORD_LEAVES
                if torch.equal(getattr(a, f), getattr(b, f))
                and torch.equal(getattr(c, f), getattr(b, f))]
        if not torch.equal(out, want) or need != bool(want[0]) or \
                cand != [x for x in want[1:].tolist() if x >= 0] or \
                len(same) != len(RECORD_LEAVES):
            fail(f"miss kernel differs from plain at page {page}: "
                 f"{out.tolist()} vs {want.tolist()}, tier {need, cand}")
        needs += need
        if cand:
            hit_page = page
        if need:
            for st in (a, b, c):
                maybe_mine(cfg, st)
    if not needs or hit_page is None:
        fail(f"miss check: {needs} events mined, candidates "
             f"{'seen' if hit_page is not None else 'never seen'}")
    page, reps, warm = hit_page, 200, 5
    d = type(c)(*(x.clone() for x in c))
    by = statistics.mean(touched().miss_event_bytes(cfg, d, page)
                         for _ in range(reps + warm))
    del d
    ms = host_ms(lambda: step(c, page), reps, warm)

    def launch():
        miss_step_kernel(page, a, cfg.mine_rows, out)
    launch_ms = cuda_ms(launch)
    dev_ms = device_ms(launch, "miss_kernel")
    done, host = torch.cuda.Event(), out.numpy()
    dev_out = torch.empty(out.shape, dtype=out.dtype, device=dev)

    def mapped():
        miss_step_kernel(page, a, cfg.mine_rows, out)
        done.record()
        done.synchronize()
        return host.tolist()

    def async_copy():
        miss_step_kernel(page, a, cfg.mine_rows, dev_out)
        out.copy_(dev_out, non_blocking=True)
        done.record()
        done.synchronize()
        return host.tolist()
    turns = [(f.__name__, host_ms(f, reps, warm))
             for f in (mapped, async_copy, async_copy, mapped)]
    plain_ms = host_ms(lambda: miss_step_plain(page, b, cfg.mine_rows)
                       .tolist(), 50, 3)
    return {"ms": ms, "plain_ms": plain_ms, "bytes": by,
            "ops": touched().miss_ops(cfg),
            "device_ms": dev_ms, "launch_ms": launch_ms, "err": err,
            "events": events, "need_events": needs,
            "transport_ms_in_turns": turns}


def serving_mining_run(cfg, dev, rng, reps: int = 200) -> dict:
    """Host-clock ms of the serving tier's mining run on warm one-lane
    states at its tables, the card idle at each start (the state reset
    and synchronised first): the launch alone, the launch and a wait for
    it, the query's fill with the lookup and the read of its result, and
    the whole run as the tier makes it (``MissRoute.mine_and_probe``:
    launch, fill, lookup, read)."""
    import torch
    from repro_torch.kernels import ops
    base = random_mine_state(cfg, 1, dev, rng)
    work = type(base)(*(x.clone() for x in base))
    everyone = ops.all_lanes(1, dev)
    query = torch.zeros(1, dtype=torch.int32, device=dev)
    page = int(base.mine_block[0, 0])

    def restore():
        for f in MINE_LEAVES:
            getattr(work, f).copy_(getattr(base, f))
        torch.cuda.synchronize()

    def probe():
        query.fill_(page)
        return ops.prefetch_lookup(query, work.pf_key[0],
                                   work.pf_vals[0])[0].tolist()

    def waited():
        ops.mithril_mine_step(cfg, work, everyone)
        torch.cuda.synchronize()

    def run():
        ops.mithril_mine_step(cfg, work, everyone)
        return probe()
    out = {}
    for name, fn in (("launch", lambda: ops.mithril_mine_step(
            cfg, work, everyone)), ("launch_and_wait", waited),
            ("fill_lookup_read", probe), ("run", run), ("run_again", run)):
        marks = []
        for _ in range(reps):
            restore()
            t = time.perf_counter()
            fn()
            marks.append(time.perf_counter() - t)
        out[name] = statistics.median(marks) * 1e3
    return out


def phase_serving_kernels(dev, cases, timing, errs, floor):
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
                       library_ms=lib,
                       bound_ms=touched().bound_ms(by, ops_)[0], **extra)
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
            ms, plain, by, ops_, dms, _, extra = t
            row.update(ms=ms, device_ms=dms, plain_ms=plain,
                       bound_ms=touched().bound_ms(by, ops_)[0],
                       floor_ratio=floor_ratio(dms, floor), **extra)
            timing[timed] = t
        cases.append(row)

    mc = serving_mcfg()
    lookup(mc.pf_buckets, mc.pf_ways, mc.prefetch_list, 1,
           "serving tables, Q = 1 (the tier's probe)", timed="hash_lookup")
    for nb, ways, plist, n_q, tag in [
            (64, 4, 2, 64, "test shape"), (256, 4, 3, 100, "test shape"),
            (32, 2, 2, 7, "test shape"), (512, 4, 3, 1000, "Q = 1000"),
            (64, 48, 33, 500, "W = 48, P = 33: two chunks of a warp"),
            (16384, 4, 2, 100_000, "paper tables, Q = 100,000")]:
        for _ in range(3):
            lookup(nb, ways, plist, n_q, tag)


def cache_set_config(paper: bool, policy: str = "lru"):
    """MITHRIL over ``policy`` at the benchmark's shape (512 blocks of 16
    ways, ``SUITE_MITHRIL``: 32 buckets) or the paper's (65,536 blocks,
    ``PAPER_MITHRIL``: 4,096 buckets); record on miss."""
    from repro_torch.cache import SimConfig
    from repro_torch.configs import PAPER_MITHRIL, SUITE_MITHRIL
    return SimConfig(capacity=PAPER_CAPACITY if paper else PARITY_CAPACITY,
                     ways=16, policy=policy, use_mithril=True,
                     mithril=PAPER_MITHRIL if paper else SUITE_MITHRIL)


def warm_cache_set(cfg, lanes, dev, warm: int = 4000, more: int = 400):
    """The state the cache set meets on the main path: two copies of the
    end state of a sweep of ``warm`` requests of ``lanes`` mixed traces
    (the runner's carry: cache, statistics, MITHRIL state), and the
    traces' next ``more`` requests, (more, lanes) on the card."""
    import numpy as np
    import torch
    from repro_torch.cache import chunk_runner, sweep
    from repro_torch.cache.base import pack_cache
    from repro_torch.traces import mixed
    traces = np.stack([mixed(warm + more, seed=s)
                       for s in range(1, lanes + 1)]).astype(np.int32)
    sweep(cfg, traces[:, :warm], device=dev)
    carry = chunk_runner(cfg, device=dev).carry(lanes)
    sides = []
    for _ in range(2):
        side = {k: type(carry[k])(*(x.clone() for x in carry[k]))
                for k in ("cache", "stats", "mith")}
        side["cache"] = pack_cache(*side["cache"])
        sides.append(side)
    nxt = torch.as_tensor(np.ascontiguousarray(traces[:, warm:].T),
                          device=dev)
    return sides, nxt


def check_cache_set(cfg, lanes, dev, rng, steps: int = 120) -> dict:
    """The cache-set kernels (``ops.cache_access``, ``ops.mithril_prefetch``)
    and their plain versions (``cache.simulator.cache_access_plain``,
    ``mithril_prefetch_plain``) on two copies of one warm state on the
    card, with the step's mining barrier between them (the mining kernel
    on both sides), about a tenth of the requests invalid: every output
    and every carry leaf equal after every step. Then each kernel and its
    plain version timed on the traces' next requests (one a call, no
    barrier between the calls), the least bytes and operations the mean
    of the first 33 of those calls (``roofline.touched``, on a copy)."""
    import itertools
    import torch
    from repro_torch.cache.base import pack_cache
    from repro_torch.cache.simulator import (cache_access_plain,
                                             mithril_prefetch_plain)
    from repro_torch.core import mithril
    from repro_torch.kernels import ops
    m = cfg.mithril
    first = m.record_on.split("+")[0]
    (a, b), nxt = warm_cache_set(cfg, lanes, dev)
    valid = torch.as_tensor(rng.random((steps, lanes)) > 0.1, device=dev)
    sides = ((a, ops.cache_access, ops.mithril_prefetch),
             (b, cache_access_plain, mithril_prefetch_plain))
    err, mined = 0, 0
    for t in range(steps):
        blk, val = nxt[t], valid[t]
        outs = []
        for side, access, prefetch in sides:
            acc = access(side["cache"], side["stats"], blk, val, cfg.policy,
                         side["mith"], first, m.mine_rows)
            mithril.mine_batched(m, side["mith"], acc.need)
            prefetch(side["cache"], side["stats"], side["mith"], blk, val, m)
            outs.append(torch.stack([acc.hit.int(), acc.used_src,
                                     *(x.int() for x in acc.evicted),
                                     acc.need.int()]))
        torch.cuda.synchronize()
        mined += int(outs[1][-1].sum())
        err = max(err, max_err(outs[0], outs[1]))
        where = (f"(L={lanes}, NB={cfg.capacity // cfg.ways}, "
                 f"{cfg.policy}, step {t})")
        if not torch.equal(outs[0], outs[1]):
            fail(f"cache-set kernels differ from plain in the outputs "
                 f"{where}")
        for part in ("cache", "stats", "mith"):
            for name, x, y in zip(a[part]._fields, a[part], b[part]):
                if not torch.equal(x, y):
                    fail(f"cache-set kernels differ from plain in {part}."
                         f"{name} {where}")
    ones = torch.ones(lanes, dtype=torch.bool, device=dev)
    rest = nxt[steps:]

    def work(fn):
        """Mean least bytes and operations of 33 calls, on a copy."""
        c = {k: type(v)(*(x.clone() for x in v)) for k, v in a.items()}
        c["cache"] = pack_cache(*c["cache"])
        got = [fn(cfg, c, rest[i % len(rest)], ones) for i in range(33)]
        return (statistics.mean(x for x, _ in got),
                statistics.mean(y for _, y in got))

    out = {"err": err, "lanes_mined": mined}
    for name, kern_fn, plain_fn, work_fn in (
            ("cache_access",
             lambda s, x: ops.cache_access(
                 s["cache"], s["stats"], x, ones, cfg.policy, s["mith"],
                 first, m.mine_rows),
             lambda s, x: cache_access_plain(
                 s["cache"], s["stats"], x, ones, cfg.policy, s["mith"],
                 first, m.mine_rows),
             touched().cache_access_work),
            ("mithril_prefetch",
             lambda s, x: ops.mithril_prefetch(
                 s["cache"], s["stats"], s["mith"], x, ones, m),
             lambda s, x: mithril_prefetch_plain(
                 s["cache"], s["stats"], s["mith"], x, ones, m),
             touched().mithril_prefetch_work)):
        by, n_ops = work(work_fn)
        it = itertools.count()

        def kern():
            kern_fn(a, rest[next(it) % len(rest)])

        def plain():
            plain_fn(b, rest[next(it) % len(rest)])
        out[name] = {"ms": cuda_ms(kern), "host_ms": host_ms(kern, reps=30),
                     "device_ms": device_ms(kern, f"{name}_kernel"),
                     "plain_ms": cuda_ms(plain), "bytes": by, "ops": n_ops}
    return out


def phase_kernels(dev):
    """Every kernel against its plain version. Returns, per kernel, the
    timing at the shape the main path launches it most (record: the
    real-size sweep's; the mining run: the serving tier's, where it
    mines most; the codes launches, off the main path: the serving
    tier's and the parity sweeps' shapes) and the largest absolute
    difference over all its cases."""
    import dataclasses
    import numpy as np
    from repro_torch.configs import PAPER_MITHRIL as P, SUITE_MITHRIL as M
    rng = np.random.default_rng(0)
    cases, timing = [], {}
    errs = {k: 0 for k in KERNEL_INFO}
    t0 = time.time()
    floor = launch_floor_ms()

    def record(cfg, lanes, tag, frac=1.0, timed=None):
        ms, plain, by, ops, dms, err, hms = check_record(
            cfg, lanes, dev, rng, enabled_frac=frac)
        errs["mithril_record"] = max(errs["mithril_record"], err)
        cases.append({"kernel": "mithril_record", "L": lanes, "case": tag,
                      "ms": ms, "host_ms": hms, "device_ms": dms,
                      "plain_ms": plain,
                      "bound_ms": touched().bound_ms(by, ops)[0],
                      "floor_ratio": floor_ratio(dms, floor)})
        if timed:
            timing[timed] = (ms, plain, by, ops, dms, None, {"host_ms": hms})

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
    # every lane disabled: the kernel leaves after its first round of
    # loads, so its device time shows what the rest of the body costs
    record(mc, 1, "serving tables, all disabled", frac=0.0)

    def pairwise(lanes, n, s, delta, w, tag, r_sup=4, vf=0.8, serial=False,
                 timed=None):
        name = "mithril_pairwise" if serial else "mithril_pairwise_batched"
        ms, plain, by, ops, nz, dms, err, hms = check_pairwise(
            lanes, n, s, delta, w, dev, rng, r_sup=r_sup, valid_frac=vf,
            serial=serial)
        errs[name] = max(errs[name], err)
        cases.append({"kernel": name, "L": 1 if serial else lanes,
                      "N": n, "S": s, "W": w, "case": tag, "ms": ms,
                      "host_ms": hms, "device_ms": dms, "plain_ms": plain,
                      "bound_ms": touched().bound_ms(by, ops)[0],
                      "floor_ratio": floor_ratio(dms, floor),
                      "nonzero_codes": nz})
        if timed:
            timing[timed] = (ms, plain, by, ops, dms, None,
                             {"host_ms": hms})

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

    def mine_step(cfg, lanes, tag, frac=1.0, timed=None, plain_reps=10,
                  vf=0.85):
        t = check_mine_step(cfg, lanes, dev, rng, need_frac=frac,
                            timed=bool(timed), plain_reps=plain_reps,
                            valid_frac=vf)
        errs["mithril_mine_step"] = max(errs["mithril_mine_step"], t["err"])
        row = {"kernel": "mithril_mine_step", "L": lanes,
               "N": cfg.mine_rows, "S": cfg.max_support, "W": cfg.window,
               "pairs_cap": cfg.pairs_cap, "symmetric": cfg.symmetric,
               "case": tag, "max_abs_err": t["err"],
               "lanes_mined": t["lanes_mined"],
               "pairs_stored": t["pairs_stored"],
               "pairs_dropped": t["pairs_dropped"]}
        if timed:
            bms = touched().bound_ms(t["bytes"], t["ops"])[0]
            row.update(ms=t["ms"], host_ms=t["host_ms"],
                       device_ms=t["device_ms"], plain_ms=t["plain_ms"],
                       bound_ms=bms, pairs_kept=t["pairs_kept"],
                       floor_ratio=floor_ratio(t["device_ms"], floor))
            timing[timed] = (t["ms"], t["plain_ms"], t["bytes"], t["ops"],
                             t["device_ms"], None,
                             {"host_ms": t["host_ms"], "L": lanes})
        cases.append(row)

    # the serving tier's mining run (one lane of MCFG), several tables
    mine_step(mc, 1, "serving tables (MCFG), one lane",
              timed="mithril_mine_step")
    timing["mithril_mine_step"][6]["serving_run_host_ms"] = \
        serving_mining_run(mc, dev, rng)
    for _ in range(4):
        mine_step(mc, 1, "serving tables (MCFG), one lane")
    # the parity sweeps' barrier: SUITE_MITHRIL, 16 lanes, some mining
    mine_step(M, 16, "suite tables (parity), mixed need", frac=0.6,
              timed="mithril_mine_step@parity")
    mine_step(dataclasses.replace(M, symmetric=True, pf_buckets=64), 16,
              "suite tables, symmetric, 64 prefetch buckets", frac=0.6)
    mine_step(dataclasses.replace(M, min_support=1, max_pairs=6,
                                  mine_rows=37, lookahead=60), 8,
              "R = 1, N = 37, window >= N - 1, 6 pairs kept", frac=0.8)
    # the paper's tables: over 48 KiB of shared memory a block
    mine_step(P, 1, "paper tables", timed="mithril_mine_step@paper1",
              plain_reps=3)
    # the sort, the walk and the clears alone: no row to pair
    mine_step(P, 1, "paper tables, no valid row", vf=0.0,
              timed="mithril_mine_step@empty", plain_reps=3)
    mine_step(P, 16, "paper tables")
    mine_step(dataclasses.replace(P, symmetric=True), 1,
              "paper tables, symmetric")
    mine_step(P, 135, "paper tables, every lane mines",
              timed="mithril_mine_step@paper", plain_reps=3)
    # the real-size sweep's barrier: 135 lanes, none to mine
    mine_step(P, 135, "paper tables, no lane mines", frac=0.0,
              timed="mithril_mine_step@no_need", plain_reps=3)
    phase_serving_kernels(dev, cases, timing, errs, floor)

    def cache_set(lanes, paper, tag, policy="lru", timed=None):
        cfg = cache_set_config(paper, policy)
        t = check_cache_set(cfg, lanes, dev, rng)
        for name in ("cache_access", "mithril_prefetch"):
            k = t[name]
            errs[name] = max(errs[name], t["err"])
            cases.append({"kernel": name, "L": lanes,
                          "NB": cfg.capacity // cfg.ways, "W": cfg.ways,
                          "policy": policy, "case": tag,
                          "lanes_mined": t["lanes_mined"], "ms": k["ms"],
                          "host_ms": k["host_ms"],
                          "device_ms": k["device_ms"],
                          "plain_ms": k["plain_ms"],
                          "bound_ms": touched().bound_ms(k["bytes"],
                                                         k["ops"])[0],
                          "floor_ratio": floor_ratio(k["device_ms"],
                                                     floor)})
            if timed:
                timing[name + timed] = (k["ms"], k["plain_ms"], k["bytes"],
                                        k["ops"], k["device_ms"], None,
                                        {"host_ms": k["host_ms"],
                                         "L": lanes})

    # the benchmark's cells and the parity sweeps: SUITE tables, 32
    # buckets; the real-size and paper-mining sweeps: 4,096 buckets
    cache_set(135, False, "suite tables, 32 x 16 (the benchmark)",
              timed="")
    cache_set(135, True, "paper tables, 4,096 x 16 (real size)",
              timed="@paper")
    cache_set(16, False, "suite tables, FIFO", policy="fifo")
    cache_set(1, True, "paper tables, one lane")
    # the serving tier's miss at MCFG's tables
    t = check_miss(serving_mcfg(), dev, rng)
    errs["mithril_miss_step"] = t["err"]
    extra = {k: t[k] for k in ("launch_ms", "events", "need_events",
                                "transport_ms_in_turns")}
    cases.append(dict({"kernel": "mithril_miss_step",
                       "case": "serving tables (MCFG), one lane",
                       "ms": t["ms"], "device_ms": t["device_ms"],
                       "plain_ms": t["plain_ms"],
                       "bound_ms": touched().bound_ms(t["bytes"],
                                                      t["ops"])[0],
                       "floor_ratio": floor_ratio(t["device_ms"], floor)},
                      **extra))
    timing["mithril_miss_step"] = (t["ms"], t["plain_ms"], t["bytes"],
                                   t["ops"], t["device_ms"], None, extra)
    emit({"phase": "kernels", "seconds": round(time.time() - t0, 3),
          "exact": ["mithril_record", "mithril_pairwise_batched",
                    "mithril_pairwise", "hash_lookup", "mithril_miss_step",
                    "mithril_mine_step", "cache_access",
                    "mithril_prefetch"],
          "tolerance": {"paged_decode": DECODE_TOL,
                        "paged_decode_bfloat16_rounding":
                            DECODE_BF16_ROUNDING},
          "max_abs_err": errs, "cases": cases})
    # a line of its own: the kernels line above is long, and the end of
    # the output is what a reader of the run gets to see
    emit({"phase": "launch_floor", "launch_floor_ms": floor,
          "op": "x.add_(1), x a one-element float32 tensor on the card"})
    return timing, errs, floor


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
# the MITHRIL labels swept again under the profiler for the mining time
# and the repeat check; mithril-amp-lru, whose AMP steps make the largest
# trace, is swept once (its repeat set the parity phase's wall time)
# the labels swept again under the profiler (one, for the script's time
# limit)
PARITY_PROFILED = ("mithril-lru",)
PARITY_GROUPS = (("mithril-amp-lru", "lru", "fifo"),
                 ("amp-lru", "mithril-lru", "learned-lru"),
                 ("pg-lru", "mithril-fifo", "learned-mithril-lru"))


def parity_labels(dev, labels, n_requests: int = PARITY_LEN) -> dict:
    """Sweep the quick corpus through ``labels`` in this process and hold
    each label's rounded hit ratios and mean precision against the
    baseline row. Each sweep replays captured graphs, so no Python runs
    inside a mining run: each PARITY_PROFILED label is swept a second
    time (a repeat at the same geometry, which must capture nothing)
    under ``torch.profiler``, whose device time of the mining kernel
    over the sweep is the label's mining time. Returns the results, launch counts
    (of the first sweeps) and mining times."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.cache import chunk_runner, sweep_scheduled
    from repro_torch.kernels import ops
    from repro_torch.traces import corpus_suite
    rows = {r["config"]: r for r in json.loads(BASELINE.read_text())["sweeps"]
            if r["job"] == "corpus_figures_quick"}
    names, blocks, lengths = corpus_suite("quick", n_requests)
    crc = zlib.crc32(np.ascontiguousarray(blocks).tobytes())
    grid = parity_grid(PARITY_CAPACITY)
    ops.reset_launch_counts()
    t0 = time.time()
    out, totals = {}, dict.fromkeys(PARITY_KEYS, 0)
    for label in labels:
        cfg = grid[label]
        row = rows[label]
        t1 = time.time()
        res = sweep_scheduled(cfg, blocks, lengths, device=dev)
        seconds = time.time() - t1
        hr = [round(float(h), 6) for h in res.hit_ratios()]
        src = pf_src_of(cfg)
        prec = res.precisions(src) if src else np.full(len(hr), np.nan)
        prec_mean = (None if np.isnan(prec).all()
                     else round(float(np.nanmean(prec)), 6))
        ok = (hr == row["hit_ratios"] and prec_mean == row["precision_mean"]
              and round(float(np.mean(res.hit_ratios())), 6)
              == row["hit_ratio_mean"])
        runner = chunk_runner(cfg, device=dev)
        out[label] = {"hit_ratio_mean": round(float(np.mean(hr)), 6),
                      "precision_mean": prec_mean, "equal": ok,
                      "seconds": round(seconds, 3),
                      "compiles": res.compiles,
                      "capture_seconds": runner.capture_seconds,
                      "replays": runner.replays}
        totals["sweep_seconds"] += seconds
        totals["compiles"] += res.compiles
        totals["capture_seconds"] += runner.capture_seconds
        if label in PARITY_PROFILED:
            counts = ops.launch_counts()
            lanes_mined = int(runner.carry(len(names))["mith"].n_mines.sum())
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                again = sweep_scheduled(cfg, blocks, lengths, device=dev)
                torch.cuda.synchronize()
            ops.set_launch_counts(counts)
            mine = [(t, n) for k, t, n in trace_kernels(prof)
                    if "mine_step_kernel" in k]
            mining = sum(t for t, _ in mine) / 1e6
            out[label].update(repeat_compiles=again.compiles,
                              mining_device_seconds=mining,
                              mining_kernels=sum(n for _, n in mine),
                              lanes_mined=lanes_mined)
            totals["mining_device_seconds"] += mining
            totals["mining_kernels"] += sum(n for _, n in mine)
            totals["lanes_mined"] += lanes_mined
            totals["repeat_compiles"] += again.compiles
            totals["mithril_sweep_seconds"] += seconds
            if again.compiles != 0 or not np.array_equal(again.hit_curve,
                                                         res.hit_curve):
                out[label]["repeat_differs"] = True
                ok = out[label]["equal"] = False
        if not ok:
            out[label].update(got=hr, want=row["hit_ratios"],
                              want_precision=row["precision_mean"])
    return dict({"labels": out, "launches": ops.launch_counts(),
                 "seconds": time.time() - t0, "traces": len(names),
                 "requests": int(lengths.sum()), "corpus_crc32": crc,
                 "numpy": np.__version__}, **totals)


PARITY_KEYS = ("sweep_seconds", "compiles", "capture_seconds",
               "mining_device_seconds", "mining_kernels", "lanes_mined",
               "repeat_compiles", "mithril_sweep_seconds")


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
    total = {k: sum(r[k] for r in results) for k in PARITY_KEYS}
    first = results[0]
    emit(dict({"phase": "parity", "traces": first["traces"],
               "requests": first["requests"],
               "corpus_crc32": first["corpus_crc32"],
               "numpy": first["numpy"], "processes": len(results),
               "labels": labels, "launches": counts, "seconds": seconds,
               "mining_share": total["mining_device_seconds"]
               / total["mithril_sweep_seconds"]}, **total))
    crcs = {r["corpus_crc32"] for r in results}
    if crcs != {QUICK_CORPUS_CRC32}:
        fail(f"parity: the generated quick corpus (crc32 {crcs}) is not "
             f"the one the baseline was computed on ({QUICK_CORPUS_CRC32})")
    bad = [k for k, v in labels.items() if not v["equal"]]
    if bad or len(labels) != 9:
        fail(f"parity: {bad or 'labels missing'} differ from "
             f"BENCH_baseline_quick.json (or a repeat sweep differed or "
             f"captured again)")
    if not kernel_path(counts):
        fail(f"parity: the sweeps did not access, record and mine through "
             f"the cache-set kernels and the mining run alone: {counts}")
    if total["compiles"] != 9:
        fail(f"parity: {total['compiles']} graphs captured, not one a "
             f"label")
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


def phase_profile(dev, blocks, steps: int = 300):
    """Device busy share of the real-size sweep over its first ``steps``
    requests, replayed, from a ``torch.profiler`` trace: the device time
    of kernels and copies over the wall time of the traced sweep, the
    kernels that take most of it, and the launch counters of the traced
    sweep against the profiler's count of the record kernel and the
    mining run (they must agree)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule
    from repro_torch.cache import chunk_runner, sweep
    from repro_torch.kernels import ops
    blocks = blocks[:, :steps]
    cfg = real_config()
    runner = chunk_runner(cfg, device=dev)
    sweep(cfg, blocks[:, :20], device=dev)          # warm the allocator
    torch.cuda.synchronize()
    # the profiler's own warm-up (its events dropped) runs a short sweep:
    # once, late in this process, a trace started cold counted one
    # cache_access fewer than the launch counters; its cause is unknown
    # and cold traces have not shown it since (PERF.md)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1)) as prof:
        sweep(cfg, blocks[:, :20], device=dev)
        torch.cuda.synchronize()
        prof.step()
        counts, replays = ops.launch_counts(), runner.replays
        t0 = time.perf_counter()
        res = sweep(cfg, blocks, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launched = {k: v - counts[k] for k, v in ops.launch_counts().items()}
    ops.set_launch_counts(counts)       # the main path's counts stay
    rows = trace_kernels(prof, copies=True)
    busy = sum(t for _, t, _ in rows) / 1e6
    kernels = [r for r in rows if not r[0].startswith(("Memcpy", "Memset"))]
    run = (runner.replays - replays) * runner.unroll
    traced = {name: sum(n for k, _, n in kernels if sub in k)
              for name, sub in (("mithril_record", "record_kernel"),
                                ("cache_access", "cache_access_kernel"),
                                ("mithril_prefetch",
                                 "mithril_prefetch_kernel"),
                                ("mithril_mine_step", "mine_step_kernel"))}
    rows.sort(key=lambda r: -r[1])
    info = {"phase": "profile", "steps": steps, "steps_replayed": run,
            "unroll": runner.unroll, "compiles": res.compiles,
            "lanes": blocks.shape[0], "wall_seconds": wall,
            "device_busy_seconds": busy,
            "device_idle_share": (1.0 - busy / wall) if busy else None,
            "kernels_per_step": sum(n for _, _, n in kernels) / max(run, 1),
            "launches": {k: launched[k] for k in traced},
            "profiler_launches": traced,
            "top_device_time": [{"kernel": k[:80], "seconds": t / 1e6,
                                 "count": c} for k, t, c in rows[:8]]}
    emit(info)
    if any(traced.values()) and traced != info["launches"]:
        fail(f"profile: the launch counters {info['launches']} differ "
             f"from the kernels the profiler saw {traced}")


def start_cross_check(n_requests: int = REAL_LEN) -> subprocess.Popen:
    """The CPU cross-check of the real-size phase, in a child process
    that runs while the card works (no GPU visible to it)."""
    return subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--cross-check",
         str(n_requests)], stdout=subprocess.PIPE, text=True,
        env=dict(os.environ, PYTHONPATH=str(SRC), CUDA_VISIBLE_DEVICES=""))


def replay_equals_eager(cfg, blocks, dev) -> dict:
    """The first REPLAY_STEPS steps of the real-size sweep twice: the
    eager loop over ``build_batched_step``'s step (no runner), and
    ``sweep`` through the runner; every carry leaf and every hit row must
    be equal. Both are timed."""
    import numpy as np
    import torch
    from repro_torch.cache import build_batched_step, chunk_runner, sweep
    from repro_torch.cache.sweep import _leaves
    b = np.ascontiguousarray(blocks[:, :REPLAY_STEPS])
    lanes = b.shape[0]
    init, step = build_batched_step(cfg, dev)
    carry = init(lanes)
    xs = torch.as_tensor(np.ascontiguousarray(b.T), device=dev)
    valid = torch.ones(lanes, dtype=torch.bool, device=dev)
    torch.cuda.synchronize()
    t = time.perf_counter()
    hits = torch.stack([step(carry, xs[i], valid)[1]
                        for i in range(REPLAY_STEPS)])
    torch.cuda.synchronize()
    eager_s = time.perf_counter() - t
    runner = chunk_runner(cfg, device=dev)
    cap0, captures0 = runner.capture_seconds, runner.captures
    t = time.perf_counter()
    res = sweep(cfg, b, device=dev)
    replay_s = time.perf_counter() - t
    capture_s = runner.capture_seconds - cap0
    got = _leaves(runner.carry(lanes))
    leaves = sum(bool(torch.equal(x, y)) for x, y in zip(got, _leaves(carry)))
    equal = (leaves == len(got) and
             np.array_equal(res.hit_curve, hits.cpu().numpy().T))
    info = {"steps": REPLAY_STEPS, "lanes": lanes, "unroll": runner.unroll,
            "equal": equal, "leaves_equal": f"{leaves}/{len(got)}",
            "eager_seconds": eager_s,
            "eager_ms_per_step": eager_s / REPLAY_STEPS * 1e3,
            "runner_seconds": replay_s,
            "runner_ms_per_step": (replay_s - capture_s)
            / REPLAY_STEPS * 1e3,
            "captures": runner.captures - captures0,
            "capture_seconds": capture_s, "compiles": res.compiles,
            "graph_launches": (runner.graphs[lanes].launches
                               if lanes in runner.graphs else None)}
    del carry, hits
    return info


def unroll_times(cfg, blocks, dev) -> dict:
    """The real-size prefix of UNROLL_STEPS steps through runners of
    each G in UNROLLS: a first sweep (which captures, unless the graph
    exists), then a timed repeat that must capture nothing and give the
    same results."""
    import numpy as np
    import torch
    from repro_torch.cache import chunk_runner, sweep
    b = np.ascontiguousarray(blocks[:, :UNROLL_STEPS])
    out, want = {}, None
    for g in UNROLLS:
        runner = chunk_runner(cfg, g, dev)
        cap0 = runner.capture_seconds
        first = sweep(cfg, b, unroll=g, device=dev)
        torch.cuda.synchronize()
        t = time.perf_counter()
        again = sweep(cfg, b, unroll=g, device=dev)
        seconds = time.perf_counter() - t
        want = first if want is None else want
        same = all(np.array_equal(x, y) for x, y in
                   zip(list(again.stats) + [again.hit_curve, first.hit_curve],
                       list(want.stats) + [want.hit_curve, want.hit_curve]))
        out[g] = {"seconds": seconds,
                  "ms_per_step": seconds / UNROLL_STEPS * 1e3,
                  "capture_seconds": runner.capture_seconds - cap0,
                  "compiles": [first.compiles, again.compiles],
                  "equal": same and again.compiles == 0}
    return out


def phase_real(dev, child: subprocess.Popen, n_requests: int = REAL_LEN):
    """The real-size sweep through the runner, after the replay-equals-
    eager check and the timing of G on its prefix; returns the launch
    counts of the sweep and its corpus and statistics."""
    import numpy as np
    import torch
    from repro_torch.cache import sweep_scheduled
    from repro_torch.kernels import ops
    from repro_torch.traces import corpus_suite
    t_gen = time.time()
    names, blocks, lengths = corpus_suite("full", n_requests)
    t_gen = time.time() - t_gen
    cfg = real_config()
    replay = replay_equals_eager(cfg, blocks, dev)
    unrolls = unroll_times(cfg, blocks, dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = ops.launch_counts()
    res = sweep_scheduled(cfg, blocks, lengths, device=dev)
    torch.cuda.synchronize()
    counts = {k: v - before[k] for k, v in ops.launch_counts().items()}
    peak = torch.cuda.max_memory_allocated()
    hr = res.hit_ratios()
    if not np.isfinite(hr).all() or hr.shape != (len(names),):
        fail("real size: hit ratios are not finite")
    stats = res.stats
    steps = int(lengths.max())
    info = {"phase": "real_size", "traces": len(names),
            "requests": int(lengths.sum()),
            "requests_min": int(lengths.min()),
            "requests_max": int(lengths.max()),
            "lane_width": len(names), "steps": steps,
            "seconds": res.seconds, "ms_per_step": res.seconds / steps * 1e3,
            "requests_per_s": float(lengths.sum() / res.seconds),
            "compiles": res.compiles,
            "hit_ratio_mean": float(hr.mean()),
            "prefetch_issued": int(stats.pf_issued[:, 1].sum()),
            "prefetch_used": int(stats.pf_used[:, 1].sum()),
            "max_memory_allocated": int(peak), "launches": counts,
            "trace_gen_seconds": t_gen, "replay_vs_eager": replay,
            "unroll": unrolls}
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
    if not replay["equal"]:
        fail(f"real size: the runner's replays differ from the eager "
             f"steps ({replay['leaves_equal']} carry leaves equal)")
    bad = [g for g, v in unrolls.items() if not v["equal"]]
    if bad:
        fail(f"real size: the runners of G = {bad} differ, or captured "
             f"again on a repeat")
    if counts["cache_access"] < steps or \
            counts["mithril_mine_step"] < steps or \
            counts["mithril_prefetch"] < steps:
        fail(f"real size: the replays did not count an access (with its "
             f"record event), a mining run and a prefetch a step: {counts}")
    return counts, (names, blocks, lengths, stats)


# ---------------------------------------------------------------------------
# phase 4b: the paper's deployment where MITHRIL mines
# ---------------------------------------------------------------------------

# looping(N, loop_len=18_000, n_loops=4, seed=s), s = 1..135: 72,000
# blocks a trace against the 65,536-block cache, so every block misses
# again each pass. A lane first fills its 1,024 mining rows after about
# 218,000 requests (the 4th miss of its blocks) and then mines about
# every 2,400 until its 4th pass ends; the pairs it mined recur only in
# the next pass, so the first prefetch comes near request 287,000. The
# sweep runs 300,000 requests: the first 240,000 through
# ``sweep_scheduled``, the rest through the same runner and carry, where
# the replay-vs-eager and the profiled windows lie while lanes mine.
PAPER_LOOPS = dict(loop_len=18_000, n_loops=4)
PAPER_SEEDS = tuple(range(1, 136))
PAPER_LEN = 300_000
PAPER_SPLIT = 240_000
PAPER_CHILD_SEEDS = (1, 2)    # the lanes held against the CPU child
PAPER_WINDOW = 1_280          # replay vs eager: about 70 mining runs
PAPER_PROFILE = 1_024         # the profiled window after it


def paper_traces(n_requests: int, seeds=None):
    """The looping traces of ``seeds`` (default PAPER_SEEDS), (S, n)."""
    import numpy as np
    from repro_torch.traces.synthetic import looping
    return np.stack([looping(n_requests, seed=s, **PAPER_LOOPS)
                     for s in (PAPER_SEEDS if seeds is None else seeds)])


def paper_cross_check_child() -> None:
    """Child process: the PAPER_CHILD_SEEDS lanes of the paper-mining
    sweep on the CPU through the plain versions; prints their Stats and
    mining runs as JSON."""
    import torch
    from repro_torch.cache import chunk_runner, sweep_scheduled
    torch.set_num_threads(2)
    cfg = real_config()
    blocks = paper_traces(PAPER_LEN, PAPER_CHILD_SEEDS)
    res = sweep_scheduled(cfg, blocks, device="cpu")
    mines = chunk_runner(cfg, device="cpu").carry(len(blocks))["mith"]
    print(json.dumps({"seeds": list(PAPER_CHILD_SEEDS),
                      "stats": {k: v.tolist() for k, v in
                                res.stats._asdict().items()},
                      "n_mines": mines.n_mines.tolist(),
                      "seconds": res.seconds}), flush=True)


def start_paper_cross_check() -> subprocess.Popen:
    return subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()),
         "--paper-cross-check"], stdout=subprocess.PIPE, text=True,
        env=dict(os.environ, PYTHONPATH=str(SRC), CUDA_VISIBLE_DEVICES=""))


def advance(runner, carry, blocks, dev):
    """``blocks`` (W, T), every request valid, through the runner's
    replays from ``carry`` (its static carry at width W) in place;
    returns the hits (T, W) on the card."""
    import numpy as np
    import torch
    xs = torch.as_tensor(np.ascontiguousarray(blocks.T), device=dev)
    valid = torch.ones(xs.shape, dtype=torch.bool, device=dev)
    return runner.run(carry, xs, valid, np.ones(xs.shape[0], bool))


def paper_replay_equals_eager(cfg, runner, blocks, dev) -> dict:
    """From the runner's carry at width W, the next requests ``blocks``
    (W, T) twice: the eager loop over ``build_batched_step``'s step on a
    copy of the carry (its launches are not counted), and the runner's
    replays, which advance the carry; every carry leaf and hit must be
    equal, and lanes must have mined inside the window."""
    import numpy as np
    import torch
    from repro_torch.cache import build_batched_step
    from repro_torch.cache.sweep import _assign, _leaves
    from repro_torch.kernels import ops
    lanes = blocks.shape[0]
    carry = runner.carry(lanes)
    mines0 = carry["mith"].n_mines.clone()
    init, step = build_batched_step(cfg, dev)
    eager = init(lanes)
    _assign(eager, carry)
    xs = torch.as_tensor(np.ascontiguousarray(blocks.T), device=dev)
    valid = torch.ones(lanes, dtype=torch.bool, device=dev)
    counts = ops.launch_counts()
    torch.cuda.synchronize()
    t = time.perf_counter()
    hits = torch.stack([step(eager, xs[i], valid)[1]
                        for i in range(xs.shape[0])])
    torch.cuda.synchronize()
    eager_s = time.perf_counter() - t
    ops.set_launch_counts(counts)
    t = time.perf_counter()
    replayed = advance(runner, carry, blocks, dev)
    torch.cuda.synchronize()
    replay_s = time.perf_counter() - t
    got, want = _leaves(carry), _leaves(eager)
    leaves = sum(bool(torch.equal(x, y)) for x, y in zip(got, want))
    mined = carry["mith"].n_mines - mines0
    info = {"steps": int(xs.shape[0]), "lanes": lanes,
            "equal": leaves == len(got) and bool(torch.equal(hits, replayed)),
            "leaves_equal": f"{leaves}/{len(got)}",
            "mining_runs": int(mined.sum()),
            "lanes_mined": int((mined > 0).sum()),
            "eager_ms_per_step": eager_s / xs.shape[0] * 1e3,
            "runner_seconds": replay_s,
            "runner_ms_per_step": replay_s / xs.shape[0] * 1e3}
    del eager, hits
    return info


def kernel_times(prof, sub: str) -> list:
    """Device microseconds of each launch of the kernels whose name
    contains ``sub`` in a ``torch.profiler`` trace."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    return [(ev.duration_ns() / 1e3 if hasattr(ev, "duration_ns")
             else ev.duration_us())
            for ev in prof.profiler.kineto_results.events()
            if ev.device_type() == cuda and sub in ev.name()]


def paper_profile(runner, blocks, dev, floor: float) -> dict:
    """The traces' next PAPER_PROFILE requests through the runner under
    ``torch.profiler``: the mining kernel's device time and its share of
    the window's wall time (PERF.md §2, "mining share"), the launches
    that mined (longer than 10 launch floors; a barrier where no lane
    mines takes about one) and their mean device time, the device idle
    share."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    lanes = blocks.shape[0]
    carry = runner.carry(lanes)
    mines0 = carry["mith"].n_mines.clone()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        advance(runner, carry, blocks, dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    mine = kernel_times(prof, "mine_step_kernel")
    mined = [us for us in mine if us > 10 * floor * 1e3]
    busy = sum(t for _, t, _ in trace_kernels(prof, copies=True)) / 1e6
    return {"steps": int(blocks.shape[1]), "wall_seconds": wall,
            "ms_per_step": wall / blocks.shape[1] * 1e3,
            "mining_kernels": len(mine),
            "mining_device_seconds": sum(mine) / 1e6,
            "mining_share": sum(mine) / 1e6 / wall,
            "launches_that_mined": len(mined),
            "mined_device_ms_mean": (sum(mined) / len(mined) / 1e3
                                     if mined else None),
            "mined_device_ms_max": max(mined) / 1e3 if mined else None,
            "barrier_device_ms_median": (statistics.median(mine) / 1e3
                                         if mine else None),
            "mining_runs": int((carry["mith"].n_mines - mines0).sum()),
            "device_busy_seconds": busy,
            "device_idle_share": 1.0 - busy / wall}


def phase_paper(dev, child: subprocess.Popen, floor: float) -> dict:
    """The paper's deployment (``real_config``: PAPER_MITHRIL, 65,536
    blocks, 16 ways, mithril-lru) over 135 looping traces of PAPER_LEN
    requests that overflow the cache, as one group of 135 lanes: the
    first PAPER_SPLIT requests through ``sweep_scheduled``; the rest
    through the same captured runner from the carry it left, first the
    replay-vs-eager window and the profiled window (while lanes mine),
    then the remaining requests. Every lane must mine and issue
    prefetches; plain LRU on the same traces; the CPU child's lanes
    equal. Returns the launch counts of the sweep (its windows' replays
    included, the eager copy's launches not)."""
    import numpy as np
    import torch
    from repro_torch.cache import (PF_MITHRIL, SimConfig, Stats,
                                   chunk_runner, sweep_scheduled)
    from repro_torch.convert import to_numpy
    from repro_torch.kernels import ops
    t_phase = time.time()
    t0 = time.time()
    blocks = paper_traces(PAPER_LEN)
    t_gen = time.time() - t0
    head, tail = blocks[:, :PAPER_SPLIT], blocks[:, PAPER_SPLIT:]
    lanes = len(blocks)
    cfg = real_config()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = ops.launch_counts()
    res = sweep_scheduled(cfg, head, device=dev)
    runner = chunk_runner(cfg, device=dev)
    carry = runner.carry(lanes)
    mines_split = carry["mith"].n_mines.cpu().numpy()
    replay = paper_replay_equals_eager(cfg, runner, tail[:, :PAPER_WINDOW],
                                       dev)
    rest = tail[:, PAPER_WINDOW:]
    prof = paper_profile(runner, rest[:, :PAPER_PROFILE], dev, floor)
    t0 = time.perf_counter()
    advance(runner, carry, rest[:, PAPER_PROFILE:], dev)
    torch.cuda.synchronize()
    rest_s = time.perf_counter() - t0
    counts = {k: v - before[k] for k, v in ops.launch_counts().items()}
    peak = int(torch.cuda.max_memory_allocated())
    stats = Stats(*to_numpy(carry["stats"]))
    n_mines = carry["mith"].n_mines.cpu().numpy()
    seconds = (res.seconds + replay["runner_seconds"] + prof["wall_seconds"]
               + rest_s)
    lru = sweep_scheduled(SimConfig(capacity=cfg.capacity, ways=cfg.ways,
                                    policy="lru"), blocks, device=dev)
    issued = stats.pf_issued[:, PF_MITHRIL]
    used = stats.pf_used[:, PF_MITHRIL]
    hr = stats.hits / stats.requests
    lru_hr = lru.hit_ratios()
    info = {"phase": "paper_mining", "traces": lanes,
            "trace": dict(PAPER_LOOPS, seeds=[PAPER_SEEDS[0],
                                              PAPER_SEEDS[-1]]),
            "requests": int(blocks.size), "steps": PAPER_LEN,
            "steps_through_sweep_scheduled": PAPER_SPLIT,
            "lane_width": lanes, "seconds": seconds,
            "ms_per_step": seconds / PAPER_LEN * 1e3,
            "ms_per_step_sweep_scheduled": res.seconds / PAPER_SPLIT * 1e3,
            "requests_per_s": blocks.size / seconds,
            "compiles": res.compiles,
            "hit_ratio_mean": float(hr.mean()),
            "lru_hit_ratio_mean": float(lru_hr.mean()),
            "hit_ratio_gain_min_max": [float((hr - lru_hr).min()),
                                       float((hr - lru_hr).max())],
            "lru_seconds": lru.seconds,
            "lanes_better_than_lru": int((hr > lru_hr).sum()),
            "prefetch_issued": int(issued.sum()),
            "prefetch_used": int(used.sum()),
            "prefetch_precision": float(used.sum() / max(issued.sum(), 1)),
            "mining_runs": int(n_mines.sum()),
            "mining_runs_per_lane": [int(n_mines.min()),
                                     int(n_mines.max())],
            "mining_runs_by_split": int(mines_split.sum()),
            "lanes_mined": int((n_mines > 0).sum()),
            "lanes_prefetched": int((issued > 0).sum()),
            "max_memory_allocated": peak, "launches": counts,
            "trace_gen_seconds": t_gen, "replay_vs_eager": replay,
            "profile": prof}
    out, _ = child.communicate(timeout=1200)
    if child.returncode != 0:
        emit(info)
        fail("paper mining: CPU cross-check process failed")
    cpu = json.loads(out.strip().splitlines()[-1])
    idx = [PAPER_SEEDS.index(s) for s in cpu["seeds"]]
    bad = [f for f, want in cpu["stats"].items()
           if getattr(stats, f)[idx].tolist() != want]
    if n_mines[idx].tolist() != cpu["n_mines"]:
        bad.append("n_mines")
    info["cpu_cross_check"] = {"seeds": cpu["seeds"], "equal": not bad,
                               "n_mines": cpu["n_mines"],
                               "seconds": cpu["seconds"]}
    info["seconds_phase"] = time.time() - t_phase
    emit(info)
    if bad:
        fail(f"paper mining: the CPU cross-check differs in {bad}")
    idle = [PAPER_SEEDS[i] for i in
            np.flatnonzero((n_mines == 0) | (issued == 0))]
    if idle or min(cpu["n_mines"]) < 2:
        fail(f"paper mining: lanes of seeds {idle} did not mine or issue a "
             f"prefetch, or a cross-checked lane mined fewer than twice")
    if not (replay["equal"] and replay["mining_runs"] > 0):
        fail(f"paper mining: the replays differ from the eager steps "
             f"across mining barriers ({replay})")
    if not (prof["mining_runs"] > 0 and prof["launches_that_mined"] > 0):
        fail(f"paper mining: the profiled window saw no mining run {prof}")
    if counts["cache_access"] < PAPER_LEN or \
            counts["mithril_mine_step"] < PAPER_LEN:
        fail(f"paper mining: the replays did not count an access (with its "
             f"record event) and a mining run a step: {counts}")
    return counts


# ---------------------------------------------------------------------------
# phase 5: the streaming engine
# ---------------------------------------------------------------------------

def pipe_config():
    """``benchmarks/serving_bench.py``'s PIPE_CFG (a CPU test holds the
    copy equal)."""
    from repro_torch.cache import SimConfig
    from repro_torch.core import MithrilConfig
    return SimConfig(capacity=128, use_mithril=True, use_amp=True,
                     mithril=MithrilConfig(min_support=2, max_support=6,
                                           lookahead=30, rec_buckets=256,
                                           rec_ways=4, mine_rows=32,
                                           pf_buckets=256, pf_ways=4))


def pipeline_job(dev, async_producer: bool, warm: bool = True):
    """``benchmarks/serving_bench.py``'s pipeline job at PIPE_QUICK: the
    streamed tenants, their on-off arrivals, a warm-up sweep of two
    short streams (the graph's capture) when ``warm``.
    Returns the StreamResult and its ``streaming_stats()`` with
    ``hit_ratio_mean``."""
    import numpy as np
    from repro_torch.cache import sweep_streaming
    from repro_torch.traces import arrival_process, mixed
    geo, cfg = PIPE_QUICK, pipe_config()
    traces = {f"s{i:02d}": mixed(geo["stream_len"] + 137 * i, 0.3, 0.4,
                                 0.3, seed=40 + i)
              for i in range(geo["n_streams"])}
    arrivals = arrival_process(traces, mode="onoff", burst_len=64,
                               idle_len=32, stagger=geo["chunk"], seed=7)
    if warm:
        sweep_streaming(cfg, {k: v[: geo["chunk"] * 2] for k, v in
                              list(traces.items())[:2]},
                        lane_width=geo["lane_width"], chunk=geo["chunk"],
                        async_producer=False, device=dev)
    stream = sweep_streaming(cfg, traces,
                             arrivals=[arrivals[k] for k in traces],
                             lane_width=geo["lane_width"],
                             chunk=geo["chunk"],
                             async_producer=async_producer, device=dev)
    st = stream.streaming_stats()
    st["hit_ratio_mean"] = round(float(np.mean(stream.result.hit_ratios())),
                                 6)
    return stream, st


def phase_streaming(dev, real) -> dict:
    """(a) the pipeline job at quick scale, sync then async, against the
    ``pipeline_quick`` rows, the async hit curve equal to the sync one;
    (b) the real-size configuration and corpus through a recycled pool of
    STREAM_WIDTH lanes under the job's on-off arrivals, async, each
    trace's Stats equal to the offline real-size sweep's. Returns the
    launch counts of both."""
    import numpy as np
    import torch
    from repro_torch.cache import chunk_runner, sweep_streaming
    from repro_torch.kernels import ops
    from repro_torch.traces import arrival_process
    rows = {r["config"]: r for r in json.loads(BASELINE.read_text())[
        "streaming"] if r["job"] == "pipeline_quick"}
    before = ops.launch_counts()
    t0 = time.time()
    quick, streams = {}, {}
    for mode, async_on in (("sync", False), ("async", True)):
        stream, st = pipeline_job(dev, async_on, warm=not async_on)
        streams[mode] = stream
        quick[mode] = dict(st, compiles=stream.result.compiles,
                           seconds=stream.result.seconds,
                           equal=all(st[k] == rows[mode][k]
                                     for k in PIPE_KEYS))
    a, s = streams["async"].result, streams["sync"].result
    async_same = np.array_equal(a.hit_curve, s.hit_curve) and all(
        np.array_equal(x, y) for x, y in zip(a.stats, s.stats))
    names, blocks, lengths, offline = real
    traces = {n: blocks[i, : lengths[i]] for i, n in enumerate(names)}
    arr = arrival_process(traces, mode="onoff", burst_len=64, idle_len=32,
                          stagger=STREAM_CHUNK, seed=7)
    cfg = real_config()
    runner = chunk_runner(cfg, device=dev)
    replays = runner.replays
    full = sweep_streaming(cfg, traces, arrivals=[arr[k] for k in traces],
                           lane_width=STREAM_WIDTH, chunk=STREAM_CHUNK,
                           async_producer=True, device=dev)
    req = sum(len(t) for t in traces.values())
    same = [bool(np.array_equal(np.asarray(getattr(full.result.stats, f)),
                                np.asarray(getattr(offline, f))))
            for f in offline._fields]
    counts = {k: v - before[k] for k, v in ops.launch_counts().items()}
    info = {"phase": "streaming", "quick": quick,
            "quick_async_equals_sync": async_same,
            "full": dict(full.streaming_stats(), traces=len(traces),
                         requests=req, seconds=full.result.seconds,
                         requests_per_s=req / full.result.seconds,
                         compiles=full.result.compiles,
                         replays=runner.replays - replays,
                         hit_ratio_mean=float(
                             np.mean(full.result.hit_ratios())),
                         stats_equal_offline=same),
            "launches": counts, "seconds": time.time() - t0}
    emit(info)
    bad = [m for m, v in quick.items() if not v["equal"]]
    if bad:
        fail(f"streaming: {bad} differ from the pipeline_quick rows")
    if not async_same:
        fail("streaming: the async pipeline differs from the sync one")
    if not all(same):
        fail(f"streaming: the recycled full-width stream differs from the "
             f"offline real-size sweep in "
             f"{[f for f, ok in zip(offline._fields, same) if not ok]}")
    return counts


# ---------------------------------------------------------------------------
# phase 6: the learned & adaptive lane
# ---------------------------------------------------------------------------

# copies of benchmarks/adaptive_bench.py's GRID (its axes), BASE, EPISODES,
# SEED, TOP_K and _crc (a CPU test holds them equal)
ADAPT_GRID = dict(lookaheads=(25, 100, 400), min_supports=(2, 4),
                  pf_sizes=(1, 2))
ADAPT_BASE = "mithril-lru"
EPISODES = 8
SEED = 0
TOP_K = 4
# the adaptive bench's quick length, and the depth of the full-width run
# (of its 50,000 requests: the script's 1,200 s limit cuts it)
LEARNED_LEN = 4_000
# (b)'s traces: cut from LEARNED_LEN to stay inside the script's limit
# once the paper-mining phase came (PERF.md §4)
LEARNED_FULL_LEN = 2_000
ADAPT_KEYS = ("episodes", "arms", "labels", "hit_ratios", "base_hit_ratios",
              "hit_ratio_mean", "base_hit_ratio_mean", "decisions_crc",
              "compiles")
TRAIN = dict(scale="quick", trace_len=4000, steps=400, seed=0, stride=4)
# the card's training against the CPU's from the same start: the head's
# fixed-order arithmetic (models/policy_head.py) gives both the same
# parameters; a loss value may differ in its last bit (the library's
# log1p), which feeds no gradient
TRAIN_TOL = {"params": 0.0, "loss": 1e-6}


def _crc(history) -> str:
    """CRC32 of the full decision history — one reproducibility token
    per run, cheap to gate exactly in BENCH json."""
    return f"{zlib.crc32(repr(history).encode()):08x}"


def adapt_row(r) -> dict:
    """An AdaptResult as the adaptive bench records it (ADAPT_KEYS)."""
    import numpy as np
    return {"episodes": int(r.episodes), "arms": [int(a) for a in r.arms],
            "labels": list(r.labels),
            "hit_ratios": [round(float(h), 6) for h in r.hit_ratios],
            "base_hit_ratios": [round(float(h), 6)
                                for h in r.base_hit_ratios],
            "hit_ratio_mean": round(float(np.mean(r.hit_ratios)), 6),
            "base_hit_ratio_mean": round(
                float(np.mean(r.base_hit_ratios)), 6),
            "decisions_crc": _crc(r.history), "compiles": int(r.compiles)}


def run_searches(base_cfg, blocks, lengths, dev,
                 names=("hill-climb", "bandit")) -> dict:
    """The adaptive bench's searchers ``names`` (both: hill-climb, then
    bandit) in this process: {name: (AdaptResult, seconds)}."""
    from repro_torch.learn.adapt import SearchGrid, bandit, hill_climb
    grid = SearchGrid(**ADAPT_GRID)
    out = {}
    for name in names:
        t0 = time.time()
        if name == "hill-climb":
            r = hill_climb(base_cfg, blocks, lengths, grid, device=dev)
        else:
            r = bandit(base_cfg, blocks, lengths, grid, episodes=EPISODES,
                       seed=SEED, top_k=TOP_K, device=dev)
        out[name] = (r, time.time() - t0)
    return out


def same_result(a, b) -> bool:
    """Two AdaptResults with the same decisions and the same bits."""
    import numpy as np
    return (a.arms == b.arms and a.history == b.history
            and np.array_equal(a.hit_ratios, b.hit_ratios)
            and np.array_equal(a.base_hit_ratios, b.base_hit_ratios))


def runner_capture_seconds(base_cfg, dev) -> float:
    """Capture seconds of the runners of the base config and every arm
    (a set: the base may equal an arm, whose runner it then shares)."""
    from repro_torch.cache import chunk_runner
    from repro_torch.learn.adapt import SearchGrid
    grid = SearchGrid(**ADAPT_GRID)
    cfgs = {base_cfg} | {grid.config(base_cfg, a) for a in range(grid.n_arms)}
    return sum(chunk_runner(c, device=dev).capture_seconds for c in cfgs)


def learned_quick(dev) -> dict:
    """(a) both searchers over the quick corpus from fresh runners, each
    row's deterministic fields equal to the adaptive_quick rows, then the
    hill-climb again: no capture, the same bits (the bandit's repeat is
    held at full width, in (b); repeating it here too was cut for the
    script's time limit)."""
    import numpy as np
    from repro_torch.cache import reset_runners
    from repro_torch.traces import corpus_suite
    rows = {r["config"]: r for r in json.loads(BASELINE.read_text())[
        "learned"] if r["job"] == "adaptive_quick"}
    names, blocks, lengths = corpus_suite("quick", LEARNED_LEN)
    crc = zlib.crc32(np.ascontiguousarray(blocks).tobytes())
    base = parity_grid(PARITY_CAPACITY)[ADAPT_BASE]
    reset_runners()
    first = run_searches(base, blocks, lengths, dev)
    capture_s = runner_capture_seconds(base, dev)
    again = run_searches(base, blocks, lengths, dev, names=("hill-climb",))
    out = {}
    for name, (r, seconds) in first.items():
        got, want = adapt_row(r), rows[name]
        r2, seconds2 = again.get(name, (None, None))
        out[name] = {
            "equal": all(got[k] == want[k] for k in ADAPT_KEYS),
            "differs_in": [k for k in ADAPT_KEYS if got[k] != want[k]],
            "seconds": seconds, "repeat_seconds": seconds2,
            "reference_cpu_seconds": want["seconds"],
            "compiles": r.compiles,
            "repeat_compiles": None if r2 is None else r2.compiles,
            # None: not repeated here
            "repeat_equal": None if r2 is None else (
                r2.compiles == 0 and same_result(r, r2)),
            "sweeps": r.sweeps, "decisions_crc": got["decisions_crc"],
            "hit_ratio_mean": got["hit_ratio_mean"],
            "base_hit_ratio_mean": got["base_hit_ratio_mean"]}
    return {"traces": len(names), "requests": int(lengths.sum()),
            "corpus_crc32": crc, "capture_seconds": capture_s,
            "rows": out}


def learned_full(dev) -> dict:
    """(b) the 135-trace corpus at LEARNED_FULL_LEN exported with
    write_corpus_dir and loaded back through RealCorpus, then both
    searchers at 135 lanes and the bandit again; hill-climb over the
    16 quick traces alone at that length, whose arms and hit ratios the
    135-lane search must give them."""
    import tempfile
    import numpy as np
    import torch
    from repro_torch.cache import sweep
    from repro_torch.learn.adapt import (DEFAULT_CHUNK, SearchGrid, bandit,
                                         hill_climb)
    from repro_torch.traces import (RealCorpus, corpus_fingerprint,
                                    corpus_suite, family_of,
                                    write_corpus_dir)
    names, blocks, lengths = corpus_suite("full", LEARNED_FULL_LEN)
    traces = {n: blocks[i, : lengths[i]] for i, n in enumerate(names)}
    with tempfile.TemporaryDirectory() as d:
        write_corpus_dir(d, traces, {n: family_of(n) for n in names})
        rc = RealCorpus(d)
        fingerprint = rc.fingerprint("full")
        r_names, r_blocks, r_lengths = rc.suite("full")
    ingest_equal = (tuple(r_names) == tuple(names)
                    and fingerprint == corpus_fingerprint(traces)
                    and np.array_equal(r_blocks, blocks)
                    and np.array_equal(r_lengths, lengths))
    base = parity_grid(PARITY_CAPACITY)[ADAPT_BASE]
    grid = SearchGrid(**ADAPT_GRID)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()    # what earlier phases still hold
    cap0 = runner_capture_seconds(base, dev)
    res = run_searches(base, r_blocks, r_lengths, dev)
    t0 = time.time()
    again = bandit(base, r_blocks, r_lengths, grid, episodes=EPISODES,
                   seed=SEED, top_k=TOP_K, device=dev)
    again_s = time.time() - t0
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    capture_s = runner_capture_seconds(base, dev) - cap0
    # the 16 quick traces: hill-climb decides each trace from its own
    # lane, so their arms and hit ratios are those of a search of them
    # alone
    hill = res["hill-climb"][0]
    q_names, q_blocks, q_lengths = corpus_suite("quick", LEARNED_FULL_LEN)
    t1 = time.time()
    qhill = hill_climb(base, q_blocks, q_lengths, grid, device=dev)
    quick_s = time.time() - t1
    idx = [list(r_names).index(n) for n in q_names]
    quick_equal = ([hill.arms[i] for i in idx] == list(qhill.arms)
                   and np.array_equal(hill.hit_ratios[idx],
                                      qhill.hit_ratios)
                   and np.array_equal(hill.base_hit_ratios[idx],
                                      qhill.base_hit_ratios))
    # each committed arm's hit ratios against a plain sweep of that arm's
    # config over the lanes that committed it
    t1 = time.time()
    by_arm = {}
    for name, (r, _) in res.items():
        for t, a in enumerate(r.arms):
            if a >= 0:
                by_arm.setdefault(a, []).append((name, t))
    arms_equal = True
    for a, where in sorted(by_arm.items()):
        lanes = sorted({t for _, t in where})
        ref = sweep(grid.config(base, a), r_blocks[lanes],
                    lengths=r_lengths[lanes], chunk=DEFAULT_CHUNK,
                    device=dev).hit_ratios()
        hr = dict(zip(lanes, ref.tolist()))
        arms_equal &= all(float(res[n][0].hit_ratios[t]) == hr[t]
                          for n, t in where)
    check_s = time.time() - t1
    out = {}
    for name, (r, seconds) in res.items():
        out[name] = {
            "seconds": seconds, "compiles": r.compiles, "sweeps": r.sweeps,
            "episodes": r.episodes,
            "committed": sum(a >= 0 for a in r.arms),
            "distinct_arms": len({a for a in r.arms if a >= 0}),
            "hit_ratio_mean": float(np.mean(r.hit_ratios)),
            "base_hit_ratio_mean": float(np.mean(r.base_hit_ratios)),
            "decisions_crc": _crc(r.history),
            "geq_static": bool(np.all(r.hit_ratios >= r.base_hit_ratios)),
            "on_grid": all(a == -1 or 0 <= a < grid.n_arms
                           for a in r.arms)}
    out["bandit"].update(repeat_seconds=again_s,
                         repeat_compiles=again.compiles,
                         repeat_crc=_crc(again.history),
                         repeat_equal=same_result(res["bandit"][0], again))
    return {"traces": len(names), "requests": int(lengths.sum()),
            "requests_min": int(lengths.min()),
            "requests_max": int(lengths.max()),
            "depth_cut": f"{LEARNED_FULL_LEN} of the adaptive bench's "
                         f"50000 requests a trace (the script's time "
                         f"limit)",
            "fingerprint": fingerprint, "ingest_equal": ingest_equal,
            "quick_traces_equal_alone": quick_equal,
            "quick_alone_seconds": quick_s,
            "committed_arms_equal_plain_sweep": arms_equal,
            "arm_check_sweeps": len(by_arm), "arm_check_seconds": check_s,
            "capture_seconds": capture_s, "max_memory_allocated": int(peak),
            "memory_allocated_before": int(held),
            "rows": out}


def learned_training(dev) -> dict:
    """(c) the policy heads trained on the card and on the CPU from the
    same generator seed: parameters, losses and Q8 weights compared."""
    import numpy as np
    from repro_torch.learn.policy import quantize
    from repro_torch.learn.train import train_heads
    runs, seconds = {}, {}
    for where, d in (("card", dev), ("cpu", "cpu")):
        t0 = time.time()
        runs[where] = train_heads(**TRAIN, device=d)
        seconds[where] = time.time() - t0

    def q8(w):
        flat = []
        for v in w:
            flat.extend(np.ravel(np.asarray(v, np.float64)).tolist())
        return [quantize(v) for v in flat]

    out = {}
    for kind in ("logreg", "mlp"):
        card, cpu = runs["card"][kind], runs["cpu"][kind]
        out[kind] = {
            "samples": card.samples,
            "loss_first": [card.losses[0], cpu.losses[0]],
            "loss_last": [card.losses[-1], cpu.losses[-1]],
            "loss_max_abs_diff": float(np.max(np.abs(
                np.asarray(card.losses) - np.asarray(cpu.losses)))),
            "params_max_abs_diff": max(
                float((card.params[k] - cpu.params[k]).abs().max())
                for k in card.params),
            "q8_equal": q8(card.config.weights) == q8(cpu.config.weights)}
    return {"kinds": out, "card_seconds": seconds["card"],
            "cpu_seconds": seconds["cpu"], "tolerance": TRAIN_TOL,
            "steps": TRAIN["steps"]}


def phase_learned(dev) -> dict:
    """(a) the adaptive_quick rows, (b) the full-width search through
    RealCorpus, (c) training on the card against the CPU. Returns the
    launch counts of (a) and (b)."""
    from repro_torch.kernels import ops
    before = ops.launch_counts()
    t0 = time.time()
    quick = learned_quick(dev)
    full = learned_full(dev)
    counts = {k: v - before[k] for k, v in ops.launch_counts().items()}
    training = learned_training(dev)
    info = {"phase": "learned",
            "quick": quick,
            "full": full, "training": training, "launches": counts,
            "seconds": time.time() - t0}
    emit(info)
    if quick["corpus_crc32"] != QUICK_CORPUS_CRC32:
        fail("learned: the quick corpus is not the baseline's")
    bad = [k for k, v in quick["rows"].items()
           if not (v["equal"] and v["repeat_equal"] is not False)]
    if bad:
        fail(f"learned: {bad} differ from the adaptive_quick rows, or a "
             f"repeat captured again or differed")
    checks = {"ingest_equal": full["ingest_equal"],
              "quick_traces_equal_alone": full["quick_traces_equal_alone"],
              "committed_arms_equal_plain_sweep":
                  full["committed_arms_equal_plain_sweep"],
              "bandit_repeat_equal": full["rows"]["bandit"]["repeat_equal"],
              "geq_static": all(full["rows"][n]["geq_static"]
                                for n in ("hill-climb", "bandit")),
              "on_grid": all(full["rows"][n]["on_grid"]
                             for n in ("hill-climb", "bandit"))}
    if not all(checks.values()):
        fail(f"learned: full-width checks failed: "
             f"{[k for k, v in checks.items() if not v]}")
    for kind, v in training["kinds"].items():
        if not (v["q8_equal"]
                and v["params_max_abs_diff"] <= TRAIN_TOL["params"]
                and v["loss_max_abs_diff"] <= TRAIN_TOL["loss"]):
            fail(f"learned: {kind} trained on the card differs from the "
                 f"CPU beyond {TRAIN_TOL}: {v}")
    if not kernel_path(counts):
        fail(f"learned: the searches did not access, record and mine "
             f"through the cache-set kernels and the mining run alone: "
             f"{counts}")
    return counts


# ---------------------------------------------------------------------------
# phase 7: serving over the tiered paged-KV cache
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
    (the miss launch and its wait; after a full mining table the mining
    run), with the mining runs inside that (the run's launch, the lookup
    launch, and the rest: the query's fill and the wait); the decode
    launch."""
    from repro_torch.cache.tiered import MissRoute, TieredKVCache
    from repro_torch.kernels import ops
    return HostSpans({
        "demand_batch": (TieredKVCache, "demand_batch"),
        "install": (TieredKVCache, "_install"),
        "mithril_on_miss": (TieredKVCache, "_mithril_on_miss"),
        "mine": (MissRoute, "mine_and_probe"),
        "mine_launch": (ops, "mithril_mine_step"),
        "mine_lookup": (ops, "prefetch_lookup"),
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
    quick, miss_bad = {}, []
    for config, mithril in SERVING_CONFIGS:
        c0 = ops.launch_counts()["mithril_miss_step"]
        m, _ = serve(SERVING_SCALES["quick"], SERVING_PAGE, 4, mithril, dev)
        equal = all(m[k] == rows[config][k] for k in SERVING_KEYS)
        quick[config] = {k: m[k] for k in SERVING_KEYS}
        misses = ops.launch_counts()["mithril_miss_step"] - c0
        quick[config].update(equal=equal,
                             throughput_tok_s=m["throughput_tok_s"],
                             wall_seconds=m["wall_seconds"],
                             miss_launches=misses)
        if misses != (m["tier"]["demand_fetches"] if mithril else 0):
            miss_bad.append(f"quick {config}")
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
        misses = full[config]["launches"]["mithril_miss_step"]
        if misses != (m["tier"]["demand_fetches"] if mithril else 0):
            miss_bad.append(f"full width {config}")
        if mithril:
            n_mines = int(eng.tier._mstate.n_mines[0])
            full[config]["n_mines"] = n_mines
            # a miss's host time outside the mining runs (record, probe,
            # the wait for the result), and a mining run's (its launch,
            # the lookup and the wait)
            on_miss, mine = host_spans["mithril_on_miss"], host_spans["mine"]
            full[config]["host_ms_a_miss_outside_mining"] = (
                (on_miss["seconds"] - mine["seconds"])
                / max(1, on_miss["calls"]) * 1e3)
            runs = max(1, mine["calls"])
            full[config]["host_ms_a_mining_run"] = (
                mine["seconds"] / runs * 1e3)
            launch = host_spans["mine_launch"]["seconds"]
            lookup = host_spans["mine_lookup"]["seconds"]
            full[config]["host_ms_a_mining_run_parts"] = {
                "mine_launch": launch / runs * 1e3,
                "lookup": lookup / runs * 1e3,
                "fill_and_wait": (mine["seconds"] - launch - lookup)
                / runs * 1e3}
            full[config]["miss_launches"] = misses
            launched = full[config]["launches"]
            if not (launched["mithril_mine_step"] == launched["hash_lookup"]
                    == mine["calls"] == n_mines > 0):
                miss_bad.append(f"full width {config}: {n_mines} mining "
                                f"runs, launches {launched}")
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
    if miss_bad:
        fail(f"serving: miss or mining launches differ from the demand "
             f"fetches or the mining runs in {miss_bad}")
    return counts


# ---------------------------------------------------------------------------
# phase 8: the model substrate
# ---------------------------------------------------------------------------

MODEL_TOL = 5e-2              # rtol = atol: tests/test_torch_lm.py's
MODEL_REDUCED = ("llama3.2-3b", "qwen2-moe-a2.7b", "recurrentgemma-9b",
                 "rwkv6-1.6b", "whisper-medium")
MODEL_PROMPT, MODEL_DECODE = 24, 4    # prefill, then teacher-forced steps
# the reduced runs: each arch at MODEL_PROMPT (RWKV's sequential prefill:
# 24 is not a multiple of 32), and RWKV again at 32 (its chunked form)
REDUCED_RUNS = tuple((a, MODEL_PROMPT) for a in MODEL_REDUCED) + (
    ("rwkv6-1.6b", 32),)
SERVE_ARCHS = ("llama3.2-3b", "recurrentgemma-9b", "rwkv6-1.6b",
               "whisper-medium")
SERVE_ARGS = dict(requests=4, prompt_len=32, decode_steps=16)  # main's
# the depth-cut twins, as spans of the full model's layers: llama and
# RWKV its first 2 layers, whisper 2 decoder and 2 encoder layers;
# recurrentgemma its first (rglru, rglru, local) unit as two twins, the
# two RG-LRU layers and the local-attention layer alone: card and CPU
# drift apart by bf16 rounding at every layer (``tools/twin_drift.py``:
# on an H100 the largest logit difference of its twins grew 0.031,
# 0.048, 0.059 with 1, 2, 3 layers), and 3 layers at d 4,096 and a
# 256,000 vocabulary put a few of 1.28 million logits past the tolerance
TWIN_SPANS = {"llama3.2-3b": ((0, 2),), "recurrentgemma-9b": ((0, 2), (2, 3)),
              "rwkv6-1.6b": ((0, 2),), "whisper-medium": ((0, 2),)}
# benchmarks/expert_prefetch.py's geometry
EXPERT = dict(n_experts=16, top_k=4, n_layers=8, tenants=6, batch=(2, 64),
              capacity=48, lookahead=40, min_support=2)


def model_frames(cfg, batch: int, seed: int):
    """Stub encoder frames (the whisper frontend's embeddings) from a
    seed, bf16 numpy-made, the same bits in every process; None unless
    the model is an encoder-decoder."""
    import numpy as np
    import torch
    if not cfg.is_encoder_decoder:
        return None
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal(
        (batch, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
                            ).bfloat16()


def teacher_forced(cfg, model, tokens, dev, frames=None) -> list:
    """Prefill ``tokens[:, :-MODEL_DECODE]`` (cache padded for the
    steps; ``frames`` for an encoder-decoder), then decode the remaining
    tokens one at a time; the logits of each call as float32 numpy."""
    import torch
    from repro_torch.models import lm
    tokens = torch.as_tensor(tokens, device=dev)
    s = tokens.shape[1] - MODEL_DECODE
    batch = {"tokens": tokens[:, :s]}
    if frames is not None:
        batch["frames"] = frames.to(dev)
    logits, cache = lm.prefill(cfg, model, batch, pad_to=tokens.shape[1] + 8)
    out = [logits]
    for i in range(MODEL_DECODE):
        pos = torch.full((tokens.shape[0],), s + i, dtype=torch.int32,
                         device=dev)
        logits, cache = lm.decode_step(cfg, model, cache, tokens[:, s + i],
                                       pos)
        out.append(logits)
    return [t.float().cpu().numpy() for t in out]


def reduced_model(arch: str, dev, prompt: int = MODEL_PROMPT):
    """``reduced_config(arch)`` with weights from the CPU generator of
    seed 0 (the same bits in every process), on ``dev``; its tokens and
    (encoder-decoder) frames."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.models import lm
    cfg = reduced_config(get_config(arch))
    model = lm.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu").to(dev)
    tokens = np.random.default_rng(1).integers(
        0, cfg.vocab, (2, prompt + MODEL_DECODE)).astype(np.int64)
    return cfg, model, tokens, model_frames(cfg, 2, 3)


def reduced_logits(dev) -> dict:
    """Every REDUCED_RUNS run's teacher-forced logits on ``dev``."""
    out = {}
    for arch, prompt in REDUCED_RUNS:
        cfg, model, tokens, frames = reduced_model(arch, dev, prompt)
        out[f"{arch}@{prompt}"] = teacher_forced(cfg, model, tokens, dev,
                                                 frames)
    return out


def expert_setup(dev):
    """benchmarks/expert_prefetch.py's model and token batches: reduced
    qwen2-moe with 16 experts, top 4, 8 layers (weights from the CPU
    generator of seed 0), 6 tenants' batches of 2 x 64 tokens."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.models import lm
    cfg = dataclasses.replace(reduced_config(get_config("qwen2-moe-a2.7b")),
                              n_experts=EXPERT["n_experts"],
                              top_k=EXPERT["top_k"],
                              n_layers=EXPERT["n_layers"])
    model = lm.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu").to(dev)
    rng = np.random.default_rng(0)
    batches = [rng.integers(lo, lo + cfg.vocab // 8, EXPERT["batch"])
               for lo in rng.integers(0, cfg.vocab // 2, EXPERT["tenants"])]
    return cfg, model, batches


def expert_sim_configs():
    import dataclasses
    from repro_torch.cache import SimConfig
    from repro_torch.configs import SUITE_MITHRIL
    mith = dataclasses.replace(SUITE_MITHRIL, lookahead=EXPERT["lookahead"],
                               min_support=EXPERT["min_support"])
    return {"lru": SimConfig(capacity=EXPERT["capacity"]),
            "mithril-lru": SimConfig(capacity=EXPERT["capacity"],
                                     use_mithril=True, mithril=mith)}


def stats_dict(res) -> dict:
    return {k: v.tolist() for k, v in res.stats._asdict().items()}


def model_cross_check_child() -> None:
    """Child process: phase 8's reduced models and the expert capture and
    simulations on the CPU; prints them as JSON."""
    import torch
    from repro_torch.cache import SimSession, simulate
    from repro_torch.traces.capture import capture_expert_trace
    torch.set_num_threads(2)
    t0 = time.time()
    out = {"reduced": {k: [a.tolist() for a in v]
                       for k, v in reduced_logits("cpu").items()}}
    cfg, model, batches = expert_setup("cpu")
    trace = capture_expert_trace(cfg, model, batches)
    out["trace"] = trace.tolist()
    out["stats"] = {name: stats_dict(simulate(sim, trace, device="cpu"))
                    for name, sim in expert_sim_configs().items()}
    sess = SimSession(expert_sim_configs()["mithril-lru"], device="cpu")
    sess.feed(trace)
    out["mining_runs"] = int(sess.carry["mith"].n_mines[0])
    out["seconds"] = time.time() - t0
    print(json.dumps(out), flush=True)


def start_model_cross_check() -> subprocess.Popen:
    return subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()),
         "--model-cross-check"], stdout=subprocess.PIPE, text=True,
        env=dict(os.environ, PYTHONPATH=str(SRC), CUDA_VISIBLE_DEVICES=""))


def logits_err(got, want) -> dict:
    """Largest |got - want| and whether every logit is within
    atol + rtol * |want| (rtol = atol = MODEL_TOL)."""
    import numpy as np
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return {"max_abs_err": float(np.abs(got - want).max()),
            "within_tol": bool(np.all(np.abs(got - want)
                                      <= MODEL_TOL * (1 + np.abs(want))))}


class EncDecRequests:
    """The whisper requests driven through ``prefill`` and
    ``decode_step`` directly, the way ``ServeLoop`` drives a decoder-only
    model (``ServeLoop.admit`` takes no frames, as the reference's): one
    prefill a request with its frames, the cache padded to ``max_len``,
    then a greedy token a step for each request in turn."""

    def __init__(self, cfg, model, *, max_len: int):
        self.cfg, self.model, self.max_len = cfg, model, max_len
        self.requests = {}
        self.stats = {"prefills": 0, "decode_steps": 0, "tokens": 0}

    def admit(self, rid: int, prompt, frames):
        import torch
        from repro_torch.models import lm
        logits, cache = lm.prefill(self.cfg, self.model,
                                   {"tokens": prompt[None],
                                    "frames": frames[None]},
                                   pad_to=self.max_len)
        self.requests[rid] = {"cache": cache, "logits": logits,
                              "tok": torch.argmax(logits, -1).to(torch.int32),
                              "pos": prompt.shape[0]}
        self.stats["prefills"] += 1

    def step(self):
        import torch
        from repro_torch.models import lm
        for st in self.requests.values():
            pos = torch.full((1,), st["pos"], dtype=torch.int32,
                             device=st["tok"].device)
            logits, st["cache"] = lm.decode_step(self.cfg, self.model,
                                                 st["cache"], st["tok"], pos)
            st["tok"] = torch.argmax(logits, -1).to(torch.int32)
            st["logits"] = logits
            st["pos"] += 1
            self.stats["tokens"] += 1
        self.stats["decode_steps"] += 1


def decode_read_bytes(model) -> int:
    """Bytes a decoded token must read at least: every weight but the
    encoder's (which only the prefill reads)."""
    return sum(p.numel() * p.element_size()
               for name, p in model.named_parameters()
               if not name.startswith(("enc_layers.", "enc_norm.")))


def serve_full_width(dev, arch: str) -> tuple:
    """``arch`` at its published widths: weights from a seeded card
    generator, ``launch.serve.main``'s defaults (4 requests x 32-token
    prompts x 16 decode steps) through ``ServeLoop`` (whisper: through
    ``prefill`` / ``decode_step``, each request with 1,500 seeded
    frames); every request's prefill and every step timed on the host
    clock, ending in a synchronise. Returns (line, model)."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import ServeLoop
    from repro_torch.models import lm
    cfg = get_config(arch)
    torch.cuda.synchronize()
    before = int(torch.cuda.memory_allocated())   # earlier phases' state
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                           device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_peak = int(torch.cuda.max_memory_allocated())
    held = int(torch.cuda.memory_allocated())
    torch.cuda.reset_peak_memory_stats()
    n_params = sum(p.numel() for p in model.parameters())
    w_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    read_bytes = decode_read_bytes(model)
    a = SERVE_ARGS
    max_len = a["prompt_len"] + a["decode_steps"] + 8
    loop = (EncDecRequests(cfg, model, max_len=max_len)
            if cfg.is_encoder_decoder else ServeLoop(cfg, model,
                                                     max_len=max_len))
    rng = np.random.default_rng(0)
    finite = torch.ones((), dtype=torch.bool, device=dev)
    prefill_s = []
    for rid in range(a["requests"]):
        prompt = torch.as_tensor(rng.integers(0, cfg.vocab, a["prompt_len"]),
                                 dtype=torch.int32, device=dev)
        frames = model_frames(cfg, 1, 10 + rid)
        t0 = time.perf_counter()
        if frames is None:
            loop.admit(rid, prompt)
        else:
            loop.admit(rid, prompt, frames[0].to(dev))
        torch.cuda.synchronize()
        prefill_s.append(time.perf_counter() - t0)
        finite &= torch.isfinite(loop.requests[rid]["logits"]).all()
    step_s = []
    for _ in range(a["decode_steps"]):
        t0 = time.perf_counter()
        loop.step()
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        for st in loop.requests.values():
            finite &= torch.isfinite(st["logits"]).all()
    per_token_ms = [t / a["requests"] * 1e3 for t in step_s]
    decode_s = sum(step_s)
    serve_peak = int(torch.cuda.max_memory_allocated())
    stats = dict(loop.stats)
    positions = sorted({st["pos"] for st in loop.requests.values()})
    # off the timed run: kernels and device time of a decoded token, from
    # a profiler trace of 1 + 2 more steps (the cache has room for them)
    reps = 2
    rows = profiled_kernels(loop.step, reps)
    kernels = [r for r in rows if not r[0].startswith(("Memcpy", "Memset"))]
    tokens = reps * a["requests"]
    device_ms = sum(t for _, t, _ in rows) / 1e3 / tokens
    p50 = float(np.percentile(per_token_ms, 50))
    line = {"arch": cfg.name, "layers": cfg.n_layers,
            "encoder_layers": cfg.n_encoder_layers,
            "pattern": [list(u) + [r] for u, r in lm.layer_groups(cfg)],
            "d_model": cfg.d_model,
            "heads": [cfg.n_heads, cfg.n_kv_heads], "head_dim": cfg.head_dim,
            "d_ff": cfg.d_ff, "vocab": cfg.vocab,
            "tied": cfg.tie_embeddings, "params": n_params,
            "weight_bytes": w_bytes, "decode_read_bytes": read_bytes,
            "init_seconds": init_s, **a, "stats": stats,
            "prefill_seconds": prefill_s,
            "prefill_seconds_p50": statistics.median(prefill_s),
            "decode_ms_a_token_p50": p50,
            "decode_ms_a_token_p99": float(np.percentile(per_token_ms, 99)),
            "decode_ms_a_token": per_token_ms,
            "tok_s": stats["tokens"] / decode_s,
            "decode_seconds": decode_s,
            "bound_ms_a_token": read_bytes / HBM_BYTES_PER_S * 1e3,
            "max_memory_allocated": serve_peak,
            "max_memory_allocated_init": init_peak,
            "memory_allocated_before_init": before,
            "memory_allocated_after_init": held,
            "serving_peak_over_before": serve_peak - before,
            "kernels_a_token": sum(n for _, _, n in kernels) / tokens,
            "device_ms_a_token": device_ms,
            "device_idle_share": 1.0 - device_ms / p50,
            "top_device_time": [
                {"kernel": k[:80], "ms_a_token": t / 1e3 / tokens,
                 "launches_a_token": n / tokens}
                for k, t, n in sorted(rows, key=lambda r: -r[1])[:6]],
            "all_logits_finite": bool(finite),
            "positions": positions}
    return line, model


def depth_cut_twin(cfg_full, model, dev, span) -> dict:
    """The full-width model's embedding, norms and head with its layers
    ``span`` = (first, end) (whisper: and its first encoder layers, as
    many) as a model of that depth, on the card and copied to the CPU:
    teacher-forced logits of both must agree."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.models import lm
    first, end = span
    kinds = cfg_full.pattern[first:end]
    cfg = dataclasses.replace(
        cfg_full, n_layers=end - first,
        layer_pattern=kinds if cfg_full.layer_pattern else (),
        n_encoder_layers=(end - first if cfg_full.is_encoder_decoder
                          else 0))
    keep = {}
    for k, v in model.state_dict().items():
        head, _, rest = k.partition(".")
        if head == "layers":
            i, _, sub = rest.partition(".")
            if first <= int(i) < end:
                keep[f"layers.{int(i) - first}.{sub}"] = v
        elif head != "enc_layers" or int(rest.split(".")[0]) < end - first:
            keep[k] = v
    twins = {}
    for name, where in (("card", dev), ("cpu", "cpu")):
        twin = lm.CausalLM(cfg, device="meta")
        twin.load_state_dict({k: v.to(where) for k, v in keep.items()},
                             assign=True)
        twins[name] = twin
    tokens = np.random.default_rng(2).integers(
        0, cfg.vocab, (1, SERVE_ARGS["prompt_len"] + MODEL_DECODE))
    frames = model_frames(cfg, 1, 4)
    t0 = time.time()
    card = teacher_forced(cfg, twins["card"], tokens, dev, frames)
    cpu = teacher_forced(cfg, twins["cpu"], tokens, "cpu", frames)
    per_call = [logits_err(a, b) for a, b in zip(card, cpu)]
    return {"layers": [first, end], "kinds": list(kinds),
            "calls": len(per_call),
            "max_abs_err": max(e["max_abs_err"] for e in per_call),
            "max_abs_err_by_call": [e["max_abs_err"] for e in per_call],
            "within_tol": all(e["within_tol"] for e in per_call),
            "finite": bool(all(np.isfinite(a).all() for a in card)),
            "seconds": time.time() - t0}


def phase_model(dev, child: subprocess.Popen) -> dict:
    """(a) the REDUCED_RUNS models on the card against the CPU child;
    (b) each of SERVE_ARCHS at full width, held by its depth-cut twin,
    one after another (each freed before the next); (c) the
    expert-prefetch path: capture from the MoE routers on the card, then
    ``simulate`` LRU and MITHRIL-LRU on the card (record kernel, mining
    run), against the CPU child's trace and ``Stats``. Returns the
    launch counts of (c)."""
    import gc
    import numpy as np
    import torch
    from repro_torch.cache import simulate
    from repro_torch.kernels import ops
    from repro_torch.traces.capture import capture_expert_trace
    t_phase = time.time()
    info = {"phase": "model", "tolerance": {"rtol": MODEL_TOL,
                                            "atol": MODEL_TOL},
            "reduced": {}, "full_width": {}}
    card_reduced = reduced_logits(dev)
    for arch in SERVE_ARCHS:
        t0 = time.time()
        line, model = serve_full_width(dev, arch)
        line["twins"] = [depth_cut_twin(model.cfg, model, dev, span)
                         for span in TWIN_SPANS[arch]]
        line["seconds"] = time.time() - t0
        info["full_width"][arch] = line
        del model
        gc.collect()
        torch.cuda.empty_cache()

    cfg, model, batches = expert_setup(dev)
    ops.reset_launch_counts()           # (a) and (b) launch none of them
    t0 = time.time()
    trace = capture_expert_trace(cfg, model, batches)
    capture_s = time.time() - t0
    expert = {"geometry": EXPERT, "accesses": len(trace),
              "unique_shards": int(len(np.unique(trace))),
              "capture_seconds": capture_s, "runs": {}}
    card_stats = {}
    for name, sim in expert_sim_configs().items():
        t0 = time.time()
        res = simulate(sim, trace, device=dev)
        card_stats[name] = stats_dict(res)
        precision = res.precision(1)       # NaN when none was issued
        expert["runs"][name] = {"hit_ratio": res.hit_ratio,
                                "precision": (None if precision != precision
                                              else precision),
                                "seconds": time.time() - t0,
                                "stats": card_stats[name]}
    counts = ops.launch_counts()
    expert["launches"] = counts
    info["expert_prefetch"] = expert

    out, _ = child.communicate(timeout=900)
    if child.returncode != 0:
        emit(info)
        fail("model: CPU cross-check process failed")
    cpu = json.loads(out.strip().splitlines()[-1])
    bad = []
    for key, card in card_reduced.items():
        errs = [logits_err(a, b) for a, b in zip(card, cpu["reduced"][key])]
        info["reduced"][key] = {
            "calls": len(errs),
            "max_abs_err": max(e["max_abs_err"] for e in errs),
            "within_tol": all(e["within_tol"] for e in errs),
            "finite": bool(all(np.isfinite(a).all() for a in card))}
        if not (info["reduced"][key]["within_tol"]
                and info["reduced"][key]["finite"]):
            bad.append(f"reduced {key}")
    expert["trace_equal_cpu"] = trace.tolist() == cpu["trace"]
    expert["stats_equal_cpu"] = card_stats == cpu["stats"]
    expert["mining_runs_cpu"] = cpu["mining_runs"]
    info["cpu_seconds"] = cpu["seconds"]
    info["seconds"] = time.time() - t_phase
    emit(info)
    want_pos = [SERVE_ARGS["prompt_len"] + SERVE_ARGS["decode_steps"]]
    for arch, fw in info["full_width"].items():
        if not fw["all_logits_finite"]:
            bad.append(f"full width {arch}: a logit is not finite")
        if fw["stats"]["tokens"] != SERVE_ARGS["requests"] * SERVE_ARGS[
                "decode_steps"] or fw["positions"] != want_pos:
            bad.append(f"full width {arch}: {fw['stats']} tokens")
        for twin in fw["twins"]:
            if not (twin["within_tol"] and twin["finite"]):
                bad.append(f"full width {arch}: the depth-cut twin of "
                           f"layers {twin['layers']} differs from the CPU")
    if not expert["trace_equal_cpu"]:
        bad.append("expert trace differs from the CPU's")
    if not expert["stats_equal_cpu"]:
        bad.append("expert Stats differ from the CPU's")
    if not (counts["cache_access"] and counts["mithril_mine_step"]):
        bad.append(f"expert prefetch launched {counts}")
    if bad:
        fail(f"model: {bad}")
    return counts


# ---------------------------------------------------------------------------
# phase 9: training
# ---------------------------------------------------------------------------

TRAINING_TOL = 5e-2           # rtol = atol: card against CPU
TRAIN_REDUCED = ("llama3.2-3b", "qwen2-moe-a2.7b")
TRAIN_REDUCED_ARGS = dict(steps=4, batch=2, seq=64)
# the restart: 12 steps uninterrupted; 12 steps stopped after 7 (the
# checkpoint of step 5 written), then resumed
RESTART_ARGS = dict(steps=12, batch=2, seq=64, ckpt_every=5, seed=3)
RESTART_STOP = 7
TRAIN_FULL_ARGS = dict(steps=6, batch=8, seq=128)
TRAIN_TWIN = dict(layers=2, batch=1, seq=64)
# tests/test_runtime.py's readahead configuration and pipeline
READAHEAD_MCFG = dict(min_support=2, max_support=8, lookahead=16,
                      rec_buckets=128, rec_ways=4, mine_rows=16,
                      pf_buckets=128, pf_ways=4)
# (16 shards, 200 steps: its misses never fill the mining table), and the
# same with 64 shards over 400 steps, where the readahead mines
READAHEAD_RUNS = {
    "reference": (dict(vocab=100, seq_len=8, global_batch=2, n_shards=16,
                       shard_group=4), 200),
    "mining": (dict(vocab=100, seq_len=8, global_batch=2, n_shards=64,
                    shard_group=4), 400)}
BF16_FLOPS = 989e12           # H100 SXM dense bf16 tensor-core peak
OPT_BYTES_A_PARAM = 28 + 2    # AdamW's reads and writes, and the norm's read


def train_init(arch: str):
    """``reduced_config(arch)`` with weights from the CPU generator of
    seed 0 (the same bits in every process), on the CPU."""
    import torch
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.models import lm
    cfg = reduced_config(get_config(arch))
    return lm.init_params(cfg, torch.Generator().manual_seed(0),
                          device="cpu")


def ckpt_scratch(name: str) -> str:
    """An empty checkpoint directory under ``build/`` (gitignored)."""
    import shutil
    path = ROOT / "build" / "train_ckpt" / name
    shutil.rmtree(path, ignore_errors=True)
    return str(path)


def reduced_training(dev) -> dict:
    """Each TRAIN_REDUCED model, TRAIN_REDUCED_ARGS steps of
    ``launch.train.train`` (remat "full", no compression, no checkpoint)
    from ``train_init``: losses and gradient norms."""
    from repro_torch.launch.train import train
    out = {}
    for arch in TRAIN_REDUCED:
        t0 = time.time()
        r = train(arch, **TRAIN_REDUCED_ARGS, ckpt_dir=ckpt_scratch(arch),
                  ckpt_every=10 ** 9, resume=False, log_every=10 ** 9,
                  device=dev, init=train_init(arch))
        out[arch] = {"losses": r["losses"], "grad_norms": r["grad_norms"],
                     "seconds": time.time() - t0}
    return out


def readahead_run(dev, run: str, mithril: bool = True) -> dict:
    """The shard fetches of READAHEAD_RUNS[run], with or without the
    MITHRIL readahead on ``dev``."""
    from repro_torch.core import MithrilConfig
    from repro_torch.data import DataConfig, SyntheticPipeline
    data, steps = READAHEAD_RUNS[run]
    pipe = SyntheticPipeline(DataConfig(**data),
                             mithril_cfg=(MithrilConfig(**READAHEAD_MCFG)
                                          if mithril else None),
                             device=dev)
    for step in range(steps):
        pipe.fetch_shard(step)
    out = {"hits": pipe.readahead_hits, "misses": pipe.readahead_misses,
           "staged": sorted(pipe.staged)}
    if mithril:
        out["mining_runs"] = int(pipe._route.state.n_mines[0])
    return out


def training_cross_check_child() -> None:
    """Child process: phase 9's reduced training and readahead on the
    CPU; prints them as JSON."""
    import torch
    torch.set_num_threads(2)
    t0 = time.time()
    out = {"reduced": reduced_training("cpu"),
           "readahead": {run: readahead_run("cpu", run)
                         for run in READAHEAD_RUNS}}
    out["seconds"] = time.time() - t0
    print(json.dumps(out), flush=True)


def start_training_cross_check() -> subprocess.Popen:
    return subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()),
         "--training-cross-check"], stdout=subprocess.PIPE, text=True,
        env=dict(os.environ, PYTHONPATH=str(SRC), CUDA_VISIBLE_DEVICES=""))


def close_all(got, want) -> bool:
    import numpy as np
    return bool(np.allclose(got, want, rtol=TRAINING_TOL, atol=TRAINING_TOL))


def restart_on_card(dev) -> dict:
    """RESTART_ARGS on reduced llama3.2-3b: an uninterrupted run; a run
    stopped by an injected worker failure after RESTART_STOP steps; the
    same run resumed from its latest checkpoint to the end."""
    from repro_torch.launch import train as train_mod
    from repro_torch.runtime import StragglerPolicy, WorkerFailure

    class Crash(StragglerPolicy):
        def observe(self, step_time):
            super().observe(step_time)
            if len(self._times) == RESTART_STOP:
                raise WorkerFailure(0, f"injected after {RESTART_STOP} steps")

    kw = dict(RESTART_ARGS, log_every=10 ** 9, device=dev)
    whole = train_mod.train("llama3.2-3b", ckpt_dir=ckpt_scratch("whole"),
                            **kw)
    ckpt_dir = ckpt_scratch("restart")
    train_mod.StragglerPolicy = Crash
    try:
        train_mod.train("llama3.2-3b", ckpt_dir=ckpt_dir, **kw)
        stopped = False
    except WorkerFailure:
        stopped = True
    finally:
        train_mod.StragglerPolicy = StragglerPolicy
    from repro_torch.checkpoint import CheckpointManager
    saved = CheckpointManager(ckpt_dir).steps()
    resumed = train_mod.train("llama3.2-3b", ckpt_dir=ckpt_dir, **kw)
    start = RESTART_ARGS["steps"] - len(resumed["losses"])
    want = whole["losses"][start:]
    import numpy as np
    return {"stopped_by_failure": stopped, "checkpoints": saved,
            "resumed_at": start, "losses": resumed["losses"],
            "uninterrupted": whole["losses"],
            "max_abs_diff": float(np.max(np.abs(
                np.subtract(resumed["losses"], want)))) if want else None,
            "bit_equal": resumed["losses"] == want,
            "finite": bool(np.all(np.isfinite(resumed["losses"]))),
            "ok": (stopped and start == 5 and len(resumed["losses"]) == 7
                   and bool(np.all(np.isfinite(resumed["losses"])))
                   and close_all(resumed["losses"], want))}


def train_bound_ms(n_params: int, tokens: int) -> dict:
    """The step's least time: 8 N tokens FLOPs (forward, recompute,
    backward) at the bf16 dense peak, plus AdamW's bytes at the memory
    rate."""
    flops = 8 * n_params * tokens
    opt_bytes = OPT_BYTES_A_PARAM * n_params
    return {"flops": flops, "optimizer_bytes": opt_bytes,
            "compute_ms": flops / BF16_FLOPS * 1e3,
            "optimizer_ms": opt_bytes / HBM_BYTES_PER_S * 1e3,
            "bound_ms": (flops / BF16_FLOPS
                         + opt_bytes / HBM_BYTES_PER_S) * 1e3}


def full_width_training(dev) -> tuple:
    """llama3.2-3b at its published widths through ``launch.train.train``
    (TRAIN_FULL_ARGS, remat "full", checkpointing off), then, off the
    timed run, one more step under ``torch.profiler`` from a fresh
    model of the same seed. Returns (line, that model)."""
    import gc
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticPipeline
    from repro_torch.launch.train import make_train_step, train, train_batch
    from repro_torch.models import lm
    from repro_torch.optim import adamw
    a = TRAIN_FULL_ARGS
    cfg = get_config("llama3.2-3b")
    torch.cuda.synchronize()
    before = int(torch.cuda.memory_allocated())
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    r = train("llama3.2-3b", **a, reduced=False, ckpt_dir=ckpt_scratch(
        "full"), ckpt_every=10 ** 9, resume=False, log_every=1, device=dev,
        flags=lm.RunFlags(remat="full"))
    run_s = time.time() - t0
    peak = int(torch.cuda.max_memory_allocated())
    step_ms = [t * 1e3 for t in r["step_seconds"]]
    p50 = float(np.median(step_ms[1:]))
    tokens = a["batch"] * a["seq"]
    # the profiled step: a fresh model, its state, a warm step, then one
    gc.collect()
    torch.cuda.empty_cache()
    model = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                           device=dev)
    model.requires_grad_(True)
    n_params = sum(p.numel() for p in model.parameters())
    state = [adamw.init(dict(model.named_parameters()))]
    step_fn = make_train_step(cfg, adamw.AdamWConfig(
        total_steps=a["steps"], warmup_steps=2), lm.RunFlags(remat="full"))
    data = SyntheticPipeline(DataConfig(vocab=cfg.vocab, seq_len=a["seq"],
                                        global_batch=a["batch"]))
    batch = train_batch(cfg, data, 0, a["batch"], a["seq"], dev)

    def one_step():
        _, state[0], m = step_fn(model, state[0], batch)
        return m
    rows = profiled_kernels(one_step, 1)
    del state[0]
    kernels = [x for x in rows if not x[0].startswith(("Memcpy", "Memset"))]
    dev_ms = sum(t for _, t, _ in rows) / 1e3
    bound = train_bound_ms(n_params, tokens)
    line = {"arch": cfg.name, "params": n_params, **a,
            "tokens_a_step": tokens, "losses": r["losses"],
            "grad_norms": r["grad_norms"], "step_ms": step_ms,
            "step_ms_p50": p50, "tokens_s": tokens / p50 * 1e3,
            "run_seconds": run_s, "max_memory_allocated": peak,
            "memory_allocated_before": before,
            "device_memory_bytes": int(
                torch.cuda.get_device_properties(0).total_memory),
            "finite": bool(np.all(np.isfinite(r["losses"]))
                           and np.all(np.isfinite(r["grad_norms"]))),
            **bound, "bound_share": bound["bound_ms"] / p50,
            "profiled_kernels": sum(n for _, _, n in kernels),
            "profiled_device_ms": dev_ms,
            "device_idle_share": 1.0 - dev_ms / p50,
            "top_device_time": [
                {"kernel": k[:80], "ms": t / 1e3, "launches": n}
                for k, t, n in sorted(rows, key=lambda x: -x[1])[:6]]}
    return line, model


def training_twin(model, dev) -> dict:
    """The full-width model's embedding, head, final norm and first
    TRAIN_TWIN["layers"] layers as a model of that depth, on the card and
    copied to the CPU: the loss and every gradient of one
    forward_train + backward (remat "full") on the same batch."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.models import lm
    t0 = time.time()
    n = TRAIN_TWIN["layers"]
    cfg = dataclasses.replace(model.cfg, n_layers=n)
    keep = {k: v.detach() for k, v in model.state_dict().items()
            if not k.startswith("layers.") or int(k.split(".")[1]) < n}
    rng = np.random.default_rng(2)
    tokens = rng.integers(0, cfg.vocab, (TRAIN_TWIN["batch"],
                                         TRAIN_TWIN["seq"]))
    labels = np.roll(tokens, -1, axis=1)
    labels[:, -1] = -1
    res = {}
    for name, where in (("card", dev), ("cpu", "cpu")):
        twin = lm.CausalLM(cfg, device="meta")
        twin.load_state_dict({k: v.to(where) for k, v in keep.items()},
                             assign=True)
        twin.requires_grad_(True)
        batch = {"tokens": torch.as_tensor(tokens, device=where),
                 "labels": torch.as_tensor(labels, device=where)}
        total, m = lm.forward_train(cfg, twin, batch,
                                    lm.RunFlags(remat="full"))
        total.backward()
        res[name] = (float(m["loss"].detach()),
                     {k: p.grad.float().cpu().numpy()
                      for k, p in twin.named_parameters()})
        del twin, total
    (lc, gc_), (lp, gp) = res["card"], res["cpu"]
    rel = {k: float(np.linalg.norm(gc_[k] - gp[k])
                    / max(np.linalg.norm(gp[k]), 1e-30)) for k in gp}
    return {"layers": n, "batch": TRAIN_TWIN["batch"],
            "seq": TRAIN_TWIN["seq"], "loss_card": lc, "loss_cpu": lp,
            "loss_within_tol": close_all(lc, lp),
            "grad_leaves": len(rel),
            "grad_rel_l2_max": max(rel.values()),
            "grad_rel_l2_worst": max(rel, key=rel.get),
            "grads_within_tol": max(rel.values()) <= TRAINING_TOL,
            "finite": bool(np.isfinite(lc) and all(
                np.isfinite(g).all() for g in gc_.values())),
            "seconds": time.time() - t0}


def phase_training(dev, child: subprocess.Popen) -> dict:
    """(a) reduced llama3.2-3b and qwen2-moe training on the card against
    the CPU child, and a checkpoint restart on the card; (b) llama3.2-3b
    at full width, 6 steps, timed, with a profiled step; (c) its
    depth-cut twin's loss and gradients, card against CPU; (d) the data
    pipeline's MITHRIL readahead on the card against the CPU child and
    plain staging, its kernel launches counted. Returns the launch
    counts of (d), the only kernels the training path launches."""
    import gc
    import numpy as np
    import torch
    from repro_torch.cache import reset_runners
    from repro_torch.kernels import ops
    t_phase = time.time()
    info = {"phase": "training", "tolerance": {"rtol": TRAINING_TOL,
                                               "atol": TRAINING_TOL}}
    card_reduced = reduced_training(dev)
    t0 = time.time()
    info["restart"] = restart_on_card(dev)
    info["restart"]["seconds"] = time.time() - t0
    reset_runners()                      # the sweeps' graphs and carries
    gc.collect()
    torch.cuda.empty_cache()
    info["full_width"], model = full_width_training(dev)
    info["twin"] = training_twin(model, dev)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    ops.reset_launch_counts()
    t0 = time.time()
    card_ra, by_run = {}, {}
    for run in READAHEAD_RUNS:
        before = ops.launch_counts()
        card_ra[run] = readahead_run(dev, run)
        by_run[run] = {k: v - before[k]
                       for k, v in ops.launch_counts().items()}
    counts = ops.launch_counts()
    plain = {run: readahead_run(None, run, mithril=False)
             for run in READAHEAD_RUNS}
    out, _ = child.communicate(timeout=900)
    if child.returncode != 0:
        emit(info)
        fail("training: CPU cross-check process failed")
    cpu = json.loads(out.strip().splitlines()[-1])
    info["readahead"] = {
        "config": READAHEAD_MCFG, "seconds": time.time() - t0,
        "runs": {run: {"pipeline": data, "steps": steps,
                       "card": {k: v for k, v in card_ra[run].items()
                                if k != "staged"},
                       "plain_hits": plain[run]["hits"],
                       "staged": card_ra[run]["staged"],
                       "equal_cpu": card_ra[run] == cpu["readahead"][run],
                       "launches": by_run[run]}
                 for run, (data, steps) in READAHEAD_RUNS.items()}}
    info["reduced"] = {}
    for arch, card in card_reduced.items():
        want = cpu["reduced"][arch]
        info["reduced"][arch] = {
            "losses": card["losses"], "cpu_losses": want["losses"],
            "grad_norms": card["grad_norms"],
            "cpu_grad_norms": want["grad_norms"],
            "loss_max_abs_diff": float(np.max(np.abs(np.subtract(
                card["losses"], want["losses"])))),
            "grad_norm_max_abs_diff": float(np.max(np.abs(np.subtract(
                card["grad_norms"], want["grad_norms"])))),
            "within_tol": (close_all(card["losses"], want["losses"])
                           and close_all(card["grad_norms"],
                                         want["grad_norms"])),
            "seconds": card["seconds"], "cpu_seconds": want["seconds"]}
    info["cpu_seconds"] = cpu["seconds"]
    info["seconds"] = time.time() - t_phase
    emit(info)
    bad = [f"reduced {a}" for a, v in info["reduced"].items()
           if not v["within_tol"]]
    if not info["restart"]["ok"]:
        bad.append("the checkpoint restart")
    fw = info["full_width"]
    if not (fw["finite"] and len(fw["losses"]) == TRAIN_FULL_ARGS["steps"]):
        bad.append("full width: a loss or gradient is not finite")
    if fw["max_memory_allocated"] >= fw["device_memory_bytes"]:
        bad.append("full width: peak memory")
    tw = info["twin"]
    if not (tw["loss_within_tol"] and tw["grads_within_tol"]
            and tw["finite"]):
        bad.append("the depth-cut twin differs from the CPU")
    for run, ra in info["readahead"]["runs"].items():
        n, got = ra["launches"], card_ra[run]
        if not ra["equal_cpu"]:
            bad.append(f"readahead {run} differs from the CPU's")
        if got["hits"] < ra["plain_hits"]:
            bad.append(f"readahead {run} hits fewer than plain staging")
        if (n["mithril_miss_step"] != got["misses"]
                or n["mithril_mine_step"] != got["mining_runs"]
                or n["hash_lookup"] != got["mining_runs"]):
            bad.append(f"readahead {run}: launches {n} for {got}")
    if counts["mithril_miss_step"] == 0 or counts["mithril_mine_step"] == 0:
        bad.append(f"the readahead launched {counts}")
    if bad:
        fail(f"training: {bad}")
    return counts


# ---------------------------------------------------------------------------
# phase 10: distribution
# ---------------------------------------------------------------------------

DIST_ARCH = "llama3.2-3b"
# one MoE layer; the capacity factor of the reference's TP/EP test
# (tests/test_dist.py), where no layout drops a token: EP's two-stage
# capacities differ from the dense path's, so at the config's own factor
# the layouts keep different tokens
DIST_MOE = dict(arch="qwen2-moe-a2.7b", tokens=512, cap_factor=4.0)
# rtol = atol, the reference's (tests/test_dist.py)
DIST_MOE_TOL = {"logits": 1e-5, "out": 2e-2}
DIST_TRAIN_TOL = 1e-3         # rtol = atol: the CPU tests' (bf16 partials)
DIST_SWEEP = dict(label="mithril-lru", requests=2_000)
DRYRUN_CELLS = ("train_4k", "decode_32k")


def dryrun_child() -> None:
    """Child process: the dry run of DRYRUN_CELLS for DIST_ARCH on the
    256-rank production mesh (a fake process group, so on the CPU and in
    a process of its own); prints the per-device counts as JSON."""
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.launch.dryrun import run_cell
    from repro_torch.roofline import model_flops
    out = {}
    for name in DRYRUN_CELLS:
        t0 = time.time()
        r = run_cell(DIST_ARCH, name, False, "fsdp", save=False)
        sh = SHAPES[name]
        share = model_flops(get_config(DIST_ARCH), sh.kind, sh.global_batch,
                            sh.seq_len) / r["n_devices"]
        out[name] = {"mesh": r["mesh"], "n_devices": r["n_devices"],
                     "flops_per_device": r["flops_hlo_once"],
                     "model_flops_per_device": share,
                     "flops_over_model_share": r["flops_hlo_once"] / share,
                     "bytes_per_device": r["bytes_hlo_once"],
                     "argument_bytes_per_device":
                         r["memory"]["argument_size_in_bytes"],
                     "collective_counts": r["collective_counts"],
                     "collective_bytes": r["collective_bytes_once"],
                     "run_seconds": r["lower_s"],
                     "seconds": time.time() - t0}
    print(json.dumps(out), flush=True)


def start_dryrun_child() -> subprocess.Popen:
    return subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--dryrun-child"],
        stdout=subprocess.PIPE, text=True,
        env=dict(os.environ, PYTHONPATH=str(SRC), CUDA_VISIBLE_DEVICES=""))


def _max_diff(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def _local(t):
    """A DTensor's shard on this rank (at one rank: the whole tensor)."""
    return t.to_local() if hasattr(t, "to_local") else t


def dist_serving(dev, mesh) -> dict:
    """DIST_ARCH at full width and depth: ``main``'s 4 x 32-token prompts
    and 16 teacher-forced decode steps through the plain ``prefill`` /
    ``decode_step``, then through ``jit_cell``'s prefill and decode cells
    on the same weights (now DTensors on the mesh) and tokens; the
    largest logit difference of each call and ms a token of each path."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import jit_cell
    from repro_torch.models import lm
    cfg = get_config(DIST_ARCH)
    b, p, d = (SERVE_ARGS[k] for k in ("requests", "prompt_len",
                                        "decode_steps"))
    model = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                           device=dev)
    rng = np.random.default_rng(0)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab, (b, p + d)),
                             dtype=torch.int32, device=dev)
    batch = {"tokens": tokens[:, :p]}

    def pos(i):
        return torch.full((b,), p + i, dtype=torch.int32, device=dev)

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    with torch.no_grad():
        (want, cache), plain_prefill_ms = timed(
            lambda: lm.prefill(cfg, model, batch, pad_to=p + d))
        plain, plain_ms = [want], []
        for i in range(d):
            (logits, cache), ms = timed(lambda: lm.decode_step(
                cfg, model, cache, tokens[:, p + i], pos(i)))
            plain.append(logits)
            plain_ms.append(ms)
    del cache
    step, _ = jit_cell(mesh, {"cfg": cfg, "kind": "prefill",
                              "params": model, "batch": batch})
    (got, cache_c), cell_prefill_ms = timed(lambda: step(model, batch))
    errs = [logits_err(_local(got).cpu().numpy(), plain[0].cpu().numpy())]
    # the decode cell's cache: the prefill cell's entries, with headroom
    cache = lm.init_cache(cfg, b, p + d, device=dev)
    for g, gc in zip(cache, cache_c):
        for u in g:
            for n in g[u]:
                g[u][n][:, :, :p].copy_(_local(gc[u][n]))
    del cache_c
    step, _ = jit_cell(mesh, {"cfg": cfg, "kind": "decode", "params": model,
                              "cache": cache, "token": tokens[:, p],
                              "pos": pos(0)})
    cell_ms = []
    for i in range(d):
        (logits, cache), ms = timed(
            lambda: step(model, cache, tokens[:, p + i], pos(i)))
        errs.append(logits_err(_local(logits).cpu().numpy(),
                               plain[i + 1].cpu().numpy()))
        cell_ms.append(ms)
    placements = sorted({str(tuple(prm.placements))
                         for prm in model.parameters()})
    del model, cache
    return {"arch": DIST_ARCH, "requests": b, "prompt_len": p,
            "decode_steps": d, "strategy": "tp_serve (decode), fsdp "
            "(prefill)", "parameter_placements": placements,
            "prefill_max_abs_diff": errs[0]["max_abs_err"],
            "decode_max_abs_diff": max(e["max_abs_err"] for e in errs[1:]),
            "within_tol": all(e["within_tol"] for e in errs),
            "finite": bool(all(torch.isfinite(t).all() for t in plain)),
            "plain_prefill_ms": plain_prefill_ms,
            "cell_prefill_ms": cell_prefill_ms,
            "plain_ms_a_token_p50": statistics.median(plain_ms) / b,
            "cell_ms_a_token_p50": statistics.median(cell_ms) / b,
            "plain_step_ms": plain_ms, "cell_step_ms": cell_ms}


def dist_training(dev, mesh) -> dict:
    """The training twin (DIST_ARCH at full width, TRAIN_TWIN's depth
    and batch): one step of ``make_train_fn`` and one of ``jit_cell``'s
    train cell (fsdp) from equal states; losses, gradient norms and the
    largest difference of the updated parameters."""
    import copy
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import jit_cell, make_train_fn
    from repro_torch.models import lm
    from repro_torch.optim import adamw
    cfg = dataclasses.replace(get_config(DIST_ARCH),
                              n_layers=TRAIN_TWIN["layers"])
    plain = lm.init_params(cfg, torch.Generator(device=dev).manual_seed(1),
                           device=dev).requires_grad_()
    cell = copy.deepcopy(plain)
    rng = np.random.default_rng(1)
    tokens = torch.as_tensor(rng.integers(
        0, cfg.vocab, (TRAIN_TWIN["batch"], TRAIN_TWIN["seq"] + 1)),
        dtype=torch.int32, device=dev)
    batch = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
    opt_cfg = adamw.AdamWConfig()
    out = {"layers": cfg.n_layers, "batch": list(batch["tokens"].shape),
           "strategy": "fsdp"}
    for name, model, make in (
            ("plain", plain, lambda m, o: make_train_fn(cfg, opt_cfg)),
            ("cell", cell, lambda m, o: jit_cell(
                mesh, {"cfg": cfg, "kind": "train", "params": m,
                       "opt_state": o, "batch": batch},
                opt_cfg=opt_cfg)[0])):
        opt = adamw.init(dict(model.named_parameters()))
        step = make(model, opt)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, _, metrics = step(model, opt, batch)
        out[name] = {"loss": float(metrics["loss"]),
                     "grad_norm": float(metrics["grad_norm"]),
                     "step_ms": (time.perf_counter() - t0) * 1e3}
        del opt
    got = dict(cell.named_parameters())
    out["param_max_abs_diff"] = max(
        _max_diff(_local(got[n].detach()), prm.detach())
        for n, prm in plain.named_parameters())
    out["loss_abs_diff"] = abs(out["plain"]["loss"] - out["cell"]["loss"])
    out["grad_norm_abs_diff"] = abs(out["plain"]["grad_norm"]
                                    - out["cell"]["grad_norm"])
    del plain, cell, got
    return out


def dist_moe(dev, mesh) -> dict:
    """One MoE layer at DIST_MOE's published widths, DIST_MOE's tokens:
    ``moe_ffn_tp`` and ``moe_ffn_ep`` on the mesh against dense
    ``moe_ffn``, and each one's time."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.dist import moe_ffn_ep, moe_ffn_tp, sharding_ctx
    from repro_torch.models import lm
    from repro_torch.models.layers import dense_init
    from repro_torch.models.moe import moe_ffn
    cfg = get_config(DIST_MOE["arch"])
    gen = torch.Generator(device=dev).manual_seed(2)
    layer = lm.MoE(cfg, device=dev)
    with torch.no_grad():
        for name, prm in layer.named_parameters():
            prm.copy_(dense_init(prm.shape, gen, lm._init_axis(name, prm.ndim),
                                 dtype=prm.dtype, device=dev))
    p = layer.params()
    x = torch.randn((DIST_MOE["tokens"], cfg.d_model), generator=gen,
                    device=dev).to(torch.bfloat16)
    kw = dict(n_experts=cfg.n_experts, top_k=cfg.top_k,
              cap_factor=DIST_MOE["cap_factor"])
    out = {"arch": DIST_MOE["arch"], "d_model": cfg.d_model,
           "cap_factor": DIST_MOE["cap_factor"],
           "n_experts": cfg.n_experts, "top_k": cfg.top_k,
           "expert_width": cfg.moe_d_ff,
           "shared_experts": cfg.n_shared_experts,
           "tokens": DIST_MOE["tokens"], "tolerance": DIST_MOE_TOL}
    with torch.no_grad():
        dense = moe_ffn(p, x, **kw)
        out["dense_ms"] = cuda_ms(lambda: moe_ffn(p, x, **kw), reps=10)
        for name, impl in (("tp", moe_ffn_tp), ("ep", moe_ffn_ep)):
            with sharding_ctx(mesh):
                got = impl(p, x, **kw)
                ms = cuda_ms(lambda: impl(p, x, **kw), reps=10)
            tol = {k: DIST_MOE_TOL[k] * (1 + t.float().abs())
                   for k, t in (("logits", dense[1]), ("out", dense[0]))}
            out[name] = {
                "idx_equal": bool(torch.equal(got[2], dense[2])),
                "logits_max_abs_diff": _max_diff(got[1], dense[1]),
                "out_max_abs_diff": _max_diff(got[0], dense[0]),
                "within_tol": bool(
                    ((got[1] - dense[1]).abs() <= tol["logits"]).all()
                    and ((got[0].float() - dense[0].float()).abs()
                         <= tol["out"]).all()),
                "ms": ms}
    return out


def dist_psum(dev) -> dict:
    """``compressed_psum`` over the one-rank group against int8
    quantize-dequantize of the same tensor."""
    import torch
    import torch.distributed as dist
    from repro_torch.runtime import (compressed_psum, dequantize_int8,
                                     quantize_int8)
    x = torch.randn(1 << 20, generator=torch.Generator(device=dev)
                    .manual_seed(3), device=dev)
    got = compressed_psum(x, dist.group.WORLD)
    want = dequantize_int8(*quantize_int8(x)).to(x.dtype)
    return {"elements": x.numel(), "max_abs_diff": _max_diff(got, want)}


def dist_sweep(dev) -> dict:
    """DIST_SWEEP's label over a prefix of the quick corpus through
    ``sweep_scheduled`` with ``shard=True`` (the lanes split over the
    cards: one here), with ``devices=[dev, dev]`` (two contiguous lane
    blocks, each through its own captured-graph runner and carry on the
    one card: the split, the per-shard live masks and the concatenation
    of hits and ``Stats``) and with ``shard=False``: equal ``Stats`` and
    hits. The launches of the two-runner sweep are counted apart."""
    import numpy as np
    from repro_torch.cache import sweep_scheduled
    from repro_torch.cache.sweep import _lane_shards
    from repro_torch.kernels import ops
    from repro_torch.traces import corpus_suite
    _, blocks, lengths = corpus_suite("quick", DIST_SWEEP["requests"])
    cfg = parity_grid(PARITY_CAPACITY)[DIST_SWEEP["label"]]
    t0 = time.time()
    sharded = sweep_scheduled(cfg, blocks, lengths, shard=True, device=dev)
    before = ops.launch_counts()
    two = sweep_scheduled(cfg, blocks, lengths, shard=True, device=dev,
                          devices=[dev, dev])
    two_launches = {k: v - before[k] for k, v in ops.launch_counts().items()}
    single = sweep_scheduled(cfg, blocks, lengths, shard=False, device=dev)

    def equal(a, b) -> dict:
        return {"stats_equal": all(np.array_equal(x, y) for x, y in zip(
                    a.stats, b.stats)),
                "hits_equal": bool(np.array_equal(a.hit_curve,
                                                  b.hit_curve))}
    return {"label": DIST_SWEEP["label"], "traces": len(lengths),
            "requests": int(np.sum(lengths)),
            "n_shards": len(_lane_shards(len(lengths), True, dev)),
            **equal(sharded, single),
            "two_runners": {"n_shards": len(_lane_shards(
                len(lengths), True, devices=[dev, dev])),
                **equal(two, single), "launches": two_launches},
            "hit_ratio_mean": float(np.mean(sharded.hit_ratios())),
            "seconds": time.time() - t0}


def phase_distribution(dev, child: subprocess.Popen) -> dict:
    """A one-rank NCCL group (no network: a ``HashStore``) and the smoke
    mesh (1, 1) on it: DIST_ARCH's prefill and decode cells and the
    training twin's train cell against the plain steps, TP and EP MoE
    against dense, ``compressed_psum``, the lane-sharded sweeps (one
    shard, then two runners on the card; their launches are this
    phase's), then the dry run from the CPU child.
    Returns the launch counts of the sweeps."""
    import gc
    import torch
    import torch.distributed as dist
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_smoke_mesh
    t_phase = time.time()
    info = {"phase": "distribution", "tolerance": {
        "serving_cells": {"rtol": MODEL_TOL, "atol": MODEL_TOL},
        "train_cell": {"rtol": DIST_TRAIN_TOL, "atol": DIST_TRAIN_TOL},
        "moe": DIST_MOE_TOL}}
    if dev.type == "cuda":
        torch.cuda.set_device(torch.cuda.current_device())
    # no network: the one rank meets itself through an in-memory store
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            store=dist.HashStore(), rank=0, world_size=1)
    try:
        mesh = make_smoke_mesh(dev)
        info["mesh"] = {"shape": list(mesh.shape),
                        "axes": list(mesh.mesh_dim_names),
                        "backend": dist.get_backend()}
        for key, fn in (("serving", dist_serving), ("training",
                                                    dist_training)):
            t0 = time.time()
            info[key] = fn(dev, mesh)
            info[key]["seconds"] = time.time() - t0
            gc.collect()
            torch.cuda.empty_cache()
        info["moe"] = dist_moe(dev, mesh)
        info["compressed_psum"] = dist_psum(dev)
        ops.reset_launch_counts()
        info["sweep"] = dist_sweep(dev)
        counts = ops.launch_counts()
        info["sweep"]["launches"] = counts
    finally:
        dist.destroy_process_group()
    out, _ = child.communicate(timeout=600)
    if child.returncode != 0:
        emit(info)
        fail("distribution: the dry-run process failed")
    info["dryrun"] = json.loads(out.strip().splitlines()[-1])
    info["seconds"] = time.time() - t_phase
    emit(info)
    bad = []
    sv, tr = info["serving"], info["training"]
    if not (sv["finite"] and sv["within_tol"]):
        bad.append(f"serving cells differ from the plain steps: "
                   f"{sv['prefill_max_abs_diff']}, "
                   f"{sv['decode_max_abs_diff']}")
    for key in ("loss", "grad_norm"):
        want = tr["plain"][key]
        if not abs(tr["cell"][key] - want) <= DIST_TRAIN_TOL * (
                1 + abs(want)):
            bad.append(f"train cell's {key} differs from make_train_fn's: "
                       f"{tr}")
    for name in ("tp", "ep"):
        m = info["moe"][name]
        if not (m["idx_equal"] and m["within_tol"]):
            bad.append(f"moe {name}: {m}")
    if info["compressed_psum"]["max_abs_diff"] != 0:
        bad.append(f"compressed_psum: {info['compressed_psum']}")
    sw = info["sweep"]
    if not (sw["stats_equal"] and sw["hits_equal"]):
        bad.append("the sharded sweep differs from shard=False")
    two = sw["two_runners"]
    if not (two["n_shards"] == 2 and two["stats_equal"]
            and two["hits_equal"]):
        bad.append(f"the two-runner sweep differs from shard=False: {two}")
    if not (two["launches"]["cache_access"]
            and two["launches"]["mithril_mine_step"]):
        bad.append(f"the two-runner sweep launched {two['launches']}")
    if not (counts["cache_access"] and counts["mithril_mine_step"]):
        bad.append(f"the sweeps launched {counts}")
    for name, cell in info["dryrun"].items():
        if not cell["flops_per_device"] > 0:
            bad.append(f"dry run {name}: no flops")
    if bad:
        fail(f"distribution: {bad}")
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
    if len(sys.argv) == 2 and sys.argv[1] == "--paper-cross-check":
        sys.path.insert(0, str(SRC))
        paper_cross_check_child()
        return 0
    if len(sys.argv) == 2 and sys.argv[1] == "--model-cross-check":
        sys.path.insert(0, str(SRC))
        model_cross_check_child()
        return 0
    if len(sys.argv) == 2 and sys.argv[1] == "--training-cross-check":
        sys.path.insert(0, str(SRC))
        training_cross_check_child()
        return 0
    if len(sys.argv) == 2 and sys.argv[1] == "--dryrun-child":
        sys.path.insert(0, str(SRC))
        dryrun_child()
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
                "paper_mining": start_paper_cross_check(),
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
              backend.BUILD_LOGS["paged_decode"]),
          "ptxas_mithril_mine": ptxas_report(
              backend.BUILD_LOGS["mithril_mine"],
              "mine_step_kernel|pairwise_codes_kernel")})

    timing, errs, floor = phase_kernels(dev)
    # the main path: the parity sweeps (in child processes, whose
    # counters start at zero), the real-size sweep, the serving runs and
    # the expert-prefetch simulations, counted from zero here to the end
    # of the model phase
    from repro_torch.kernels import ops
    ops.reset_launch_counts()
    by_path = {"parity": phase_parity()}
    # after the parity phase's three processes: the model phase's CPU
    # child (about a minute) runs while the card works on
    children["model"] = start_model_cross_check()
    by_path["real_size"], real = phase_real(dev, children["real_size"])
    by_path["paper_mining"] = phase_paper(dev, children["paper_mining"],
                                          floor)
    by_path["streaming"] = phase_streaming(dev, real)
    by_path["learned"] = phase_learned(dev)
    by_path["serving"] = phase_serving(dev, children["serving"])
    by_path["model"] = phase_model(dev, children["model"])
    children["training"] = start_training_cross_check()
    # the dry run's fake process group cannot share a process with the
    # NCCL one: it runs on the CPU in a child, meanwhile
    children["dryrun"] = start_dryrun_child()
    by_path["training"] = phase_training(dev, children["training"])
    by_path["distribution"] = phase_distribution(dev, children["dryrun"])
    counts = {k: sum(c[k] for c in by_path.values()) for k in KERNEL_INFO}
    merges = by_path["serving"]["paged_decode_merge"]    # only serving
    missing = [k for k, v in counts.items() if v == 0 and k not in OFF_PATH]
    if merges == 0:
        missing.append("paged_decode (merge)")
    if missing:
        fail(f"kernels never launched on the main path: {missing}")
    composed = {k: counts[k] for k in OFF_PATH if counts[k]}
    if composed:
        fail(f"the main path mined through the codes launches: {composed}")
    phase_profile(dev, real[1])

    # each kernel timed at the shape the main path launches it most:
    # record at the real-size sweep's (paper tables, 135 lanes; its
    # parity and serving shapes are under "at_parity" / "at_serving");
    # the mining run at the serving tier's (MCFG, one lane), where it
    # mines most (the parity sweeps' shape under "at_parity", the
    # paper's under "at_paper" (135 lanes) and "at_paper1" (one), and the
    # real-size barrier's 135 lanes with none to mine under
    # "at_no_need", and one paper lane with no valid row, the run's
    # sort, walk and clears alone, under "at_empty"); the codes
    # launches, off the main path, at the serving tier's (one lane) and
    # the parity sweeps' (16 lanes) shapes;
    # decode and lookup at the full-width serving run's (decode's
    # quick-scale shape is under "at_quick")
    kernels = []
    for name, (src, replaces) in KERNEL_INFO.items():
        ms, plain_ms, by, ops_, dev_ms, lib_ms = (timing[name] + (None,))[:6]
        bound_ms, bound_by = touched().bound_ms(by, ops_)
        row = {"name": name, "route": "cuda", "source": src,
               "replaces": replaces, "launches": counts[name],
               "launches_by_path": {p: c[name] for p, c in by_path.items()},
               "max_abs_err": errs[name], "ms": ms, "device_ms": dev_ms,
               "plain_ms": plain_ms, "bound_ms": bound_ms,
               "bound_by": bound_by, "library_ms": lib_ms,
               "floor_ratio": floor_ratio(dev_ms, floor)}
        if name in ALSO_REPLACES:
            row["also_replaces"] = ALSO_REPLACES[name]
        if name == "paged_decode":
            row["merge_launches"] = merges
        if len(timing[name]) > 6:
            row.update(timing[name][6])
        for tag in ("parity", "quick", "b1", "serving", "paper", "paper1",
                    "empty", "no_need"):
            if f"{name}@{tag}" in timing:
                t = timing[f"{name}@{tag}"]
                row[f"at_{tag}"] = {"ms": t[0], "device_ms": t[4],
                                    "plain_ms": t[1],
                                    "bound_ms":
                                        touched().bound_ms(t[2], t[3])[0],
                                    "floor_ratio": floor_ratio(t[4], floor)}
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
