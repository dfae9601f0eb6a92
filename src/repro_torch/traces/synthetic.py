"""Synthetic block-I/O trace generators.

The CloudPhysics traces were never released and the MSR traces are not in
this container, so the evaluation re-creates the *structure* the paper
exploits, with tunable mixture weights (DESIGN.md §8):

* ``interleaved_sequential`` — concurrent sequential streams whose accesses
  interleave (AMP's home turf; breaks naive sequential detection).
* ``association_groups`` — groups of blocks re-accessed together at
  mid-range frequency with interleaving gaps: the sporadic associations
  MITHRIL mines. Group members are *spatially scattered*, so no sequential
  prefetcher can find them.
* ``looping`` — cyclic scans over fixed regions (LRU-pathological; the
  corpus registry's ``loop`` family).
* ``zipf`` — skewed popularity: a hot head (LRU's home turf) plus a long
  one-shot tail (cold misses nobody should chase).
* ``mixed`` — weighted interleave of the three; presets ``cp_like`` /
  ``msr_like`` give a 30-trace suite spanning the paper's regimes from
  sequentiality-dominant to association-dominant.

All generators return int32 block ids, deterministic per seed. They
are copies of the reference's (``repro/traces/synthetic.py``); the one
change is :func:`zipf_draws`, which keeps ``zipf`` independent of the
installed numpy version.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List

import numpy as np


def interleaved_sequential(n_requests: int, n_streams: int = 8,
                           run_len: int = 24, lba_space: int = 1 << 22,
                           skip_prob: float = 0.12,
                           seed: int = 0) -> np.ndarray:
    """Concurrent sequential streams, round-robin with random stalls.

    Runs are short and occasionally skip blocks (real block streams pass
    through file systems/virtualization and are rarely perfectly dense —
    the paper's AMP baseline gains only ~12% on real traces; perfectly
    dense long runs would hand it multiples)."""
    rng = np.random.default_rng(seed)
    pos = rng.integers(0, lba_space, size=n_streams)
    left = rng.integers(1, run_len, size=n_streams)
    out = np.empty(n_requests, np.int64)
    for i in range(n_requests):
        s = rng.integers(n_streams)
        if left[s] == 0:  # stream jumps to a new extent
            pos[s] = rng.integers(0, lba_space)
            left[s] = rng.integers(run_len // 2, run_len)
        out[i] = pos[s]
        step = 1 if rng.random() >= skip_prob else rng.integers(2, 5)
        pos[s] += step
        left[s] -= 1
    return (out % (1 << 30)).astype(np.int32)


def association_groups(n_requests: int, n_groups: int = 200,
                       group_size: int = 4, reuse: int = 8,
                       spread: int = 3, lba_space: int = 1 << 22,
                       seed: int = 0) -> np.ndarray:
    """Scattered block groups re-accessed together ``reuse`` times.

    Group members appear within ``spread`` requests of each other
    (interleaving), and the whole group recurs at widely separated times —
    mid-frequency, beyond LRU's reach, invisible to sequential prefetchers.
    """
    rng = np.random.default_rng(seed)
    groups = [np.sort(rng.choice(lba_space, size=group_size, replace=False))
              for _ in range(n_groups)]
    events: List[np.ndarray] = []
    for g in groups:
        for _ in range(reuse):
            order = rng.permutation(group_size)
            events.append(g[order])
    rng.shuffle(events)
    out: List[int] = []
    queue: List[int] = []
    for ev in events:
        queue.extend(ev.tolist())
        # drain with jitter so group members sit within `spread` of each other
        while len(queue) > spread:
            out.append(queue.pop(0))
    out.extend(queue)
    arr = np.asarray(out[:n_requests], np.int64)
    if len(arr) < n_requests:  # pad by tiling
        arr = np.resize(arr, n_requests)
    return (arr % (1 << 30)).astype(np.int32)


def looping(n_requests: int, loop_len: int = 800, n_loops: int = 4,
            jitter: float = 0.02, lba_space: int = 1 << 22,
            seed: int = 0) -> np.ndarray:
    """Cyclic scans: repeated sequential passes over fixed regions.

    The classic LRU-pathological regime (a loop slightly larger than the
    cache evicts every block just before its reuse) and one of the
    paper's corpus workload shapes. ``n_loops`` concurrent loops
    interleave; ``jitter`` occasionally skips blocks so runs are not
    perfectly dense (same rationale as ``interleaved_sequential``).
    """
    rng = np.random.default_rng(seed)
    base = rng.integers(0, lba_space, size=n_loops)
    which = rng.integers(0, n_loops, size=n_requests)
    # per-request rank within its own loop (stable counting sort)
    counts = np.bincount(which, minlength=n_loops)
    order = np.argsort(which, kind="stable")
    starts = np.cumsum(counts) - counts
    ranks = np.empty(n_requests, np.int64)
    ranks[order] = np.arange(n_requests) - np.repeat(starts, counts)
    pos = ranks % max(1, loop_len)
    skip = np.where(rng.random(n_requests) < jitter,
                    rng.integers(1, 4, size=n_requests), 0)
    out = base[which].astype(np.int64) + pos + skip
    return (out % (1 << 30)).astype(np.int32)


_INT64_MAX = float(2**63 - 1)


def zipf_draws(rng: np.random.Generator, a: float, size: int) -> np.ndarray:
    """``rng.zipf(a, size)`` as numpy 2.0 computes it, on any numpy.

    Later numpy releases changed ``Generator.zipf`` for ``a`` near 1, so
    the same seed gave other traces there (the zipf and mixed families
    of the corpus). This is numpy 2.0's rejection sampler, drawing its
    two uniforms per attempt from ``rng.random`` (whose stream has not
    changed) and using the C library's ``pow`` through ``math.pow``.
    """
    am1 = a - 1.0
    b = math.pow(2.0, am1)
    out = np.empty(size, np.int64)
    n = 0
    while n < size:
        d = rng.random(2 * (size - n) + 16)
        for i in range(0, len(d) - 1, 2):
            u, v = 1.0 - d[i], d[i + 1]
            x = math.floor(math.pow(u, -1.0 / am1))
            if x > _INT64_MAX or x < 1.0:
                continue
            t = math.pow(1.0 + 1.0 / x, am1)
            if v * x * (t - 1.0) / (b - 1.0) <= t / b:
                out[n] = int(x)
                n += 1
                if n == size:
                    break
    return out


def zipf(n_requests: int, catalog: int = 1 << 16, alpha: float = 1.1,
         seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    ranks = zipf_draws(rng, alpha, n_requests)
    return (np.minimum(ranks, catalog) - 1).astype(np.int32)


def mixed(n_requests: int, w_seq: float = 0.3, w_assoc: float = 0.4,
          w_zipf: float = 0.3, seed: int = 0, **kw) -> np.ndarray:
    """Weighted interleave; address spaces offset so components don't alias."""
    rng = np.random.default_rng(seed)
    n_s = int(n_requests * w_seq)
    n_a = int(n_requests * w_assoc)
    n_z = n_requests - n_s - n_a
    parts = []
    if n_s:
        parts.append(interleaved_sequential(n_s, seed=seed + 1,
                                            **kw.get("seq", {})))
    if n_a:
        parts.append(association_groups(n_a, seed=seed + 2,
                                        **kw.get("assoc", {})) + (1 << 26))
    if n_z:
        parts.append(zipf(n_z, seed=seed + 3, **kw.get("zipf", {})) + (1 << 28))
    idx = np.concatenate([np.full(len(p), i) for i, p in enumerate(parts)])
    rng.shuffle(idx)
    cursors = [0] * len(parts)
    out = np.empty(n_requests, np.int32)
    for i, which in enumerate(idx):
        out[i] = parts[which][cursors[which]]
        cursors[which] += 1
    return out


def stack_padded(traces: Dict[str, np.ndarray]):
    """Stack a name->trace dict into ``(names, blocks, lengths)``.

    The canonical zero-padded batch convention (DESIGN.md §6): ``blocks``
    is ``(B, max_len)`` int32 with zeros past each trace's ``lengths[i]``.
    Single implementation shared by ``padded_suite`` and
    ``corpus.corpus_suite`` (and mirrored by ``cache.sweep.pad_traces``,
    which additionally accepts anonymous sequences).
    """
    names = tuple(traces)
    lengths = np.array([len(traces[k]) for k in names], np.int64)
    blocks = np.zeros((len(names), int(lengths.max())), np.int32)
    for i, k in enumerate(names):
        blocks[i, : lengths[i]] = traces[k]
    return names, blocks, lengths


@dataclasses.dataclass(frozen=True)
class TraceSpec:
    name: str
    kind: str           # seq | assoc | zipf | mixed
    n_requests: int
    params: dict
    seed: int


def suite(n_requests: int = 60_000, n_traces: int = 30) -> Dict[str, np.ndarray]:
    """The evaluation suite: a spectrum from sequential- to association-dominant."""
    traces: Dict[str, np.ndarray] = {}
    rng = np.random.default_rng(1234)
    for i in range(n_traces):
        t = i / max(1, n_traces - 1)
        w_seq = 0.45 * (1 - t)         # sequential fades out
        w_assoc = 0.20 + 0.60 * t      # associations fade in
        w_zipf = 1 - w_seq - w_assoc
        traces[f"syn{i:02d}"] = mixed(
            n_requests, w_seq=w_seq, w_assoc=w_assoc, w_zipf=w_zipf,
            seed=int(rng.integers(1 << 30)))
    return traces


def padded_suite(n_requests: int = 60_000, n_traces: int = 30,
                 min_frac: float = 1.0, seed: int = 1234):
    """The evaluation suite as one zero-padded batch for the sweep engine.

    Returns ``(names, blocks, lengths)`` with ``blocks`` of shape
    ``(n_traces, n_requests)`` int32 and per-trace valid ``lengths``.
    With ``min_frac < 1`` each trace keeps a prefix of uniformly drawn
    length in ``[min_frac * n_requests, n_requests]`` so the batch
    exercises the padded-tail masking path; the default keeps every trace
    full length, making results directly comparable with the serial
    ``suite()``. Trace contents are identical to ``suite()`` prefixes.
    """
    if not 0.0 < min_frac <= 1.0:
        raise ValueError("min_frac must be in (0, 1]")
    traces = suite(n_requests, n_traces)
    rng = np.random.default_rng(seed)
    lengths = np.full((n_traces,), n_requests, np.int64)
    if min_frac < 1.0:
        lengths = rng.integers(max(1, int(min_frac * n_requests)),
                               n_requests + 1, size=n_traces)
    names, blocks, _ = stack_padded(
        {k: traces[k][: lengths[i]] for i, k in enumerate(traces)})
    if blocks.shape[1] != n_requests:       # every trace was shortened
        blocks = np.pad(blocks, ((0, 0), (0, n_requests - blocks.shape[1])))
    return names, blocks, lengths


def arrival_process(traces: Dict[str, np.ndarray], mode: str = "poisson",
                    rate: float = 1.0, burst_len: int = 64,
                    idle_len: int = 192, stagger: int = 0,
                    seed: int = 0) -> Dict[str, np.ndarray]:
    """Per-tenant request arrival steps on the streaming virtual clock.

    Turns a name->trace dict into a name->arrivals dict for the
    streaming engine (``cache.sweep.sweep_streaming``) and the serving
    benchmark: ``arrivals[name][k]`` is the earliest virtual step at
    which request ``k`` of tenant ``name`` may run, nondecreasing per
    tenant. Two processes:

    * ``poisson`` — independent exponential inter-arrival times with
      mean ``1 / rate`` requests/step per tenant (open-loop traffic);
    * ``onoff`` — alternating bursts (``burst_len`` back-to-back
      requests, one per step) and idle gaps (``idle_len`` steps), the
      bursty tenant shape that exercises lane recycling: a tenant's
      lane drains and is reclaimed while the tenant idles.

    Each tenant additionally starts at a uniform random offset in
    ``[0, stagger]`` so admissions spread over the ramp. Seeding is
    content-addressed like ``traces/corpus.py``: each tenant draws from
    ``crc32(f"{mode}:{seed}:{name}")``, so arrivals are reproducible
    per (name, mode, seed) regardless of dict order or suite
    composition — never Python ``hash``.
    """
    import zlib

    if mode not in ("poisson", "onoff"):
        raise ValueError(f"mode must be poisson|onoff, got {mode!r}")
    if rate <= 0:
        raise ValueError(f"rate must be > 0, got {rate}")
    if burst_len < 1 or idle_len < 0 or stagger < 0:
        raise ValueError("burst_len >= 1, idle_len >= 0, stagger >= 0")
    out: Dict[str, np.ndarray] = {}
    for name, trace in traces.items():
        n = len(trace)
        key = zlib.crc32(f"{mode}:{seed}:{name}".encode()) & 0x7FFFFFFF
        rng = np.random.default_rng(key)
        start = int(rng.integers(0, stagger + 1))
        if mode == "poisson":
            steps = np.floor(np.cumsum(
                rng.exponential(1.0 / rate, size=n))).astype(np.int64)
        else:
            k = np.arange(n, dtype=np.int64)
            phase = int(rng.integers(0, burst_len))
            steps = k + ((k + phase) // burst_len) * idle_len
        out[name] = steps + start
    return out


def representative_traces(n_requests: int = 60_000) -> Dict[str, np.ndarray]:
    """Six traces mirroring the paper's Fig. 5 regimes."""
    return {
        "assoc_heavy_a": mixed(n_requests, 0.05, 0.85, 0.10, seed=11),
        "assoc_heavy_b": mixed(n_requests, 0.10, 0.75, 0.15, seed=12),
        "balanced_a": mixed(n_requests, 0.30, 0.40, 0.30, seed=13),
        "balanced_b": mixed(n_requests, 0.35, 0.35, 0.30, seed=14),
        "seq_heavy_a": mixed(n_requests, 0.80, 0.05, 0.15, seed=15),
        "seq_heavy_b": mixed(n_requests, 0.70, 0.10, 0.20, seed=16),
    }
