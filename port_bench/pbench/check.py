"""How ``correct`` is decided: every trace of every pass the window ran,
against the plain reference on the same trace.

The numbers compared, each with its limit (all state is int32, so the
comparison is exact and every limit is 0):

* ``stats_differ``: ``Stats`` fields (requests, hits, and per prefetching
  layer the prefetches issued, used and evicted unused) of a trace in a
  pass that differ from the reference's;
* ``hits_differ``: requests of a trace in a pass whose hit or miss
  differs from the reference's hit curve.

The reference runs once the window has closed, one trace per task in a
pool of worker processes.
"""

from __future__ import annotations

import multiprocessing
import os
from typing import Dict, List, Sequence

import numpy as np

from . import reference

LIMITS = {"stats_differ": 0, "hits_differ": 0}
FIELDS = ("requests", "hits", "pf_issued", "pf_used", "pf_evicted_unused")


def _simulate(job):
    cfg, trace, count = job
    return reference.simulate(cfg, trace, count)


def run_reference(cfg: dict, traces: Sequence[np.ndarray],
                  count: bool = False, workers: int = 0) -> List[Dict]:
    """The reference's result for each trace, in order; ``workers``
    processes (default: the cores, at most 8), longest traces first."""
    workers = workers or min(8, os.cpu_count() or 1)
    order = sorted(range(len(traces)), key=lambda i: -len(traces[i]))
    jobs = [(cfg, traces[i], count) for i in order]
    if workers == 1:
        out = [_simulate(j) for j in jobs]
    else:
        ctx = multiprocessing.get_context("spawn")
        with ctx.Pool(workers) as pool:
            out = pool.map(_simulate, jobs, chunksize=1)
    res: List[Dict] = [None] * len(traces)
    for i, r in zip(order, out):
        res[i] = r
    return res


def compare(passes, ref: List[Dict]) -> Dict:
    """The numbers compared over every pass and trace, the answers
    attempted and those that failed."""
    stats_differ = hits_differ = failed = 0
    for p in passes:
        for i, r in enumerate(ref):
            bad = sum(not np.array_equal(np.asarray(p.stats[f][i]),
                                         np.asarray(r[f])) for f in FIELDS)
            n = len(r["hit_curve"])
            got = p.hit_curve[i]
            wrong = int((got[:n] != r["hit_curve"]).sum()) + int(
                got[n:].sum())
            stats_differ += bad
            hits_differ += wrong
            failed += bool(bad or wrong)
    return {"numbers": {"stats_differ": stats_differ,
                        "hits_differ": hits_differ},
            "attempted": len(passes) * len(ref), "failed": failed}


def verdict(numbers: Dict[str, float]) -> bool:
    return all(numbers[k] <= LIMITS[k] for k in LIMITS)
