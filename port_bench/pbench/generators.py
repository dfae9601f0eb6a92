"""The trace generators of the corpus, frozen for the benchmark.

Copies of ``repro_torch.traces.synthetic``'s numpy generators (which
copy the reference package's), kept here so that a change to the
program cannot change the benchmark's traffic. Every generator returns
int32 block ids and is deterministic per seed; ``zipf_draws`` is numpy
2.0's rejection sampler on ``rng.random``, so the traces do not depend
on the installed numpy.
"""

from __future__ import annotations

import math
from typing import List

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
