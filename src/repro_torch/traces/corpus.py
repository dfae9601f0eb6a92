"""Paper-scale trace corpus: a registry of 135 parameterized workloads.

The paper's headline numbers are averages over **135 block-storage
traces** (106 CloudPhysics VMs + 29 MSR-Cambridge volumes). Neither
corpus ships with this container (DESIGN.md §8), so this module rebuilds
the *population structure* instead of six hand-picked traces: five
workload families (sequential, looping, zipf, mid-frequency-heavy,
mixed), each swept over a parameter grid, 135 registry entries total.

Everything is deterministic and process-stable: a spec's seed is derived
from its name via ``zlib.crc32`` (never Python's randomized ``hash``),
so any subset of the corpus can be regenerated bit-identically anywhere
(``tests/test_corpus.py`` pins this across processes). Trace lengths are
deliberately heterogeneous (each spec keeps a family-dependent fraction
of the nominal length) so the sweep scheduler's length bucketing
(``cache/sweep.py``) has real work to do.

    specs  = corpus_specs(n_requests=50_000, scale="full")   # 135 specs
    traces = build_corpus(specs)                             # name -> int32
    names, blocks, lengths = corpus_suite("quick")           # padded batch

A copy of the reference's registry (``repro/traces/corpus.py``): the
same specs, seeds and generators give the same traces array for array,
and ingested real corpora (:class:`RealCorpus`, a directory that
``traces/io.py`` writes) stand in for it under the same contract.

Scales: ``quick`` (16) ⊂ ``mid`` (64) ⊂ ``full`` (135), sampled evenly
across the registry so every family is represented at every scale.
"""

from __future__ import annotations

import dataclasses
import os
import zlib
from typing import Dict, Optional, Tuple

import numpy as np

from . import io as trace_io
from .synthetic import (association_groups, interleaved_sequential, looping,
                        mixed, stack_padded, zipf)

FAMILIES = ("seq", "loop", "zipf", "midfreq", "mixed")

# the fallback family for traces that did not come out of the synthetic
# registry (real ingested volumes with no family metadata)
INGESTED = "ingested"

_BUILDERS = {
    "seq": interleaved_sequential,
    "loop": looping,
    "zipf": zipf,
    "midfreq": association_groups,
    "mixed": mixed,
}

SCALES = {"quick": 16, "mid": 64, "full": 135}

# heterogeneous lengths: fraction of the nominal n_requests each spec
# keeps, cycled per family position (bucketing fodder for the scheduler)
_LEN_FRACS = (1.0, 0.7, 0.45, 0.85, 0.6)


@dataclasses.dataclass(frozen=True)
class WorkloadSpec:
    """One corpus entry: family + params + seed, fully reproducible."""

    name: str
    family: str
    n_requests: int
    params: Tuple[Tuple[str, object], ...]   # sorted items, hashable
    seed: int

    def generate(self) -> np.ndarray:
        fn = _BUILDERS[self.family]
        return fn(self.n_requests, seed=self.seed, **dict(self.params))


def _seed_of(name: str) -> int:
    """Process-stable deterministic seed (crc32, not ``hash``)."""
    return zlib.crc32(name.encode()) & 0x7FFFFFFF


def _spec(name: str, family: str, n_requests: int, frac: float,
          **params) -> WorkloadSpec:
    return WorkloadSpec(
        name=name, family=family,
        n_requests=max(1, int(n_requests * frac)),
        params=tuple(sorted(params.items())), seed=_seed_of(name))


def corpus_specs(n_requests: int = 50_000,
                 scale: str = "full") -> Tuple[WorkloadSpec, ...]:
    """The registry: 135 specs at ``scale="full"``, even subsets below.

    ``n_requests`` is the nominal trace length; each spec keeps a
    family-position-dependent fraction of it (heterogeneous lengths).
    """
    if scale not in SCALES:
        raise ValueError(f"unknown scale {scale!r}; expected {set(SCALES)}")
    specs = []

    def add(family, i, **params):
        specs.append(_spec(f"{family}{i:03d}", family, n_requests,
                           _LEN_FRACS[i % len(_LEN_FRACS)], **params))

    # sequential: 25 — stream count x run length, drifting skip prob
    i = 0
    for n_streams in (2, 4, 8, 16, 32):
        for run_len in (8, 16, 32, 64, 128):
            add("seq", i, n_streams=n_streams, run_len=run_len,
                skip_prob=round(0.05 + 0.03 * (i % 5), 2))
            i += 1

    # looping: 25 — loop length x concurrency
    i = 0
    for loop_len in (200, 400, 800, 1600, 3200):
        for n_loops in (1, 2, 4, 8, 16):
            add("loop", i, loop_len=loop_len, n_loops=n_loops,
                jitter=round(0.01 + 0.02 * (i % 3), 2))
            i += 1

    # zipf: 20 — skew x catalog size (numpy's zipf needs alpha > 1)
    i = 0
    for alpha in (1.05, 1.2, 1.4, 1.7):
        for catalog in (1 << 12, 1 << 14, 1 << 16, 1 << 18, 1 << 20):
            add("zipf", i, alpha=alpha, catalog=catalog)
            i += 1

    # mid-frequency-heavy: 30 — the sporadic associations MITHRIL mines
    i = 0
    for group_size in (2, 4, 8):
        for reuse in (4, 8, 12, 16, 24):
            for spread in (3, 7):
                add("midfreq", i, group_size=group_size, reuse=reuse,
                    spread=spread, n_groups=120 + 40 * (i % 4))
                i += 1

    # mixed: 35 — the sequential-to-association spectrum of ``suite()``
    for i in range(35):
        t = i / 34.0
        w_seq = round(0.45 * (1 - t), 4)
        w_assoc = round(0.20 + 0.60 * t, 4)
        add("mixed", i, w_seq=w_seq, w_assoc=w_assoc,
            w_zipf=round(1.0 - w_seq - w_assoc, 4))

    assert len(specs) == SCALES["full"], len(specs)

    # scales NEST (quick ⊂ mid ⊂ full): each scale samples evenly from
    # the next one up, so a trace studied at one scale exists at every
    # larger scale and per-trace trajectories are comparable across them
    if scale != "full":
        specs = _even_sample(specs, SCALES["mid"])
        if scale == "quick":
            specs = _even_sample(specs, SCALES["quick"])
    return tuple(specs)


def _even_sample(seq, n: int):
    """Even order-preserving sample of ``n`` items (capped at ``len``).

    The nested-scale rule shared by the synthetic registry and
    :class:`RealCorpus`: indices spread evenly over the sequence, no
    duplicates, first and last always included — so subsets NEST the
    same way at every scale regardless of corpus origin.
    """
    n = min(int(n), len(seq))
    if n <= 1:
        return list(seq[:n])
    idx = sorted({round(j * (len(seq) - 1) / (n - 1)) for j in range(n)})
    assert len(idx) == n, (n, len(seq))
    return [seq[j] for j in idx]


def family_of(name: str, fallback: Optional[str] = None) -> str:
    """Workload family of a registry entry name (``seq012`` -> ``seq``).

    Registry names are ``{family}{index:03d}``; the figure layer uses
    this to aggregate per-family breakdowns without re-deriving specs.
    Non-registry names (real ingested volumes like ``web2``) raise by
    default; pass ``fallback`` (usually :data:`INGESTED`) to classify
    them instead — the figure layer surfaces that family in by-family
    CSVs rather than dropping the rows.
    """
    fam = name.rstrip("0123456789")
    if fam == name or fam not in FAMILIES:
        if fallback is not None:
            return fallback
        raise ValueError(f"{name!r} is not a corpus registry name "
                         f"(families: {FAMILIES})")
    return fam


def build_corpus(specs) -> Dict[str, np.ndarray]:
    """Generate every spec; dict preserves registry order."""
    return {sp.name: sp.generate() for sp in specs}


def corpus_suite(scale: str = "quick", n_requests: int = 50_000):
    """The corpus as one zero-padded batch: ``(names, blocks, lengths)``.

    Same convention as ``synthetic.padded_suite`` — ``blocks`` is
    ``(B, max_len)`` int32 zero-padded past each trace's ``lengths[i]``
    (``synthetic.stack_padded``) — directly consumable by
    ``cache.sweep.sweep_scheduled``.
    """
    return stack_padded(build_corpus(corpus_specs(n_requests, scale)))


# ---------------------------------------------------------------------------
# Real-corpus drop-in: ingested directories behind the registry contract
# ---------------------------------------------------------------------------

class RealCorpus:
    """An ingested corpus directory satisfying the registry contract.

    A corpus directory holds canonical npz volumes plus a
    ``manifest.json`` (``traces/io.py``: ``ingest_to_dir`` writes one,
    ``scan_corpus_dir`` discovers/validates one; a bare directory of
    npz files also works). ``suite(scale, n_requests)`` returns the
    same ``(names, blocks, lengths)`` zero-padded batch as
    :func:`corpus_suite`, so everything downstream of the registry —
    ``plan_sweep``, ``sweep_scheduled``, the figure engine — runs
    unchanged the moment a volume directory is present.

    Contract deltas vs the synthetic registry, both deliberate:

    * **scales subset, they don't generate** — ``quick``/``mid`` take
      the registry's nested even-sample (:func:`_even_sample`, capped
      at the volume count) of the manifest order, so per-trace
      trajectories stay comparable across scales exactly like
      synthetic specs;
    * **``n_requests`` is a length CAP, not a nominal length** — real
      traces carry their own lengths; the cap keeps quick-suite runs
      affordable on corpus-scale volumes and is a no-op when traces
      are shorter.

    Families come from the manifest (``family_of`` with the
    :data:`INGESTED` fallback classifies unlabeled volumes), and
    ``fingerprint()`` hashes the *sampled, capped* suite content so
    BENCH telemetry keys distinguish every distinct corpus geometry.
    """

    def __init__(self, directory: str):
        self.directory = os.path.abspath(directory)
        self._traces, self._families = trace_io.load_corpus_dir(directory)
        self.names: Tuple[str, ...] = tuple(self._traces)

    def __len__(self) -> int:
        return len(self.names)

    def family(self, name: str) -> str:
        """Manifest family of a volume, :data:`INGESTED` when absent."""
        return self._families.get(name, INGESTED)

    def subset_names(self, scale: str = "full") -> Tuple[str, ...]:
        """The nested even-sample of volume names at a registry scale."""
        if scale not in SCALES:
            raise ValueError(
                f"unknown scale {scale!r}; expected {set(SCALES)}")
        names = list(self.names)
        if scale != "full":
            names = _even_sample(names, SCALES["mid"])
            if scale == "quick":
                names = _even_sample(names, SCALES["quick"])
        return tuple(names)

    def subset(self, scale: str = "full",
               n_requests: Optional[int] = None) -> Dict[str, np.ndarray]:
        """The sampled, length-capped traces as a name->blocks dict
        (manifest order) — the raw-dict form for stream consumers."""
        cap = int(n_requests) if n_requests else None
        return {k: (self._traces[k][:cap] if cap else self._traces[k])
                for k in self.subset_names(scale)}

    def suite(self, scale: str = "full",
              n_requests: Optional[int] = None):
        """``(names, blocks, lengths)`` — the :func:`corpus_suite` form."""
        return stack_padded(self.subset(scale, n_requests))

    def fingerprint(self, scale: str = "full",
                    n_requests: Optional[int] = None) -> str:
        """Content hash of the sampled/capped suite (BENCH job key)."""
        return trace_io.corpus_fingerprint(self.subset(scale, n_requests))


def resolve_corpus_dir(corpus_dir: Optional[str] = None) -> Optional[str]:
    """The active ingested-corpus directory, or None for synthetic.

    Resolution order: the explicit ``--corpus-dir`` argument, then the
    ``REPRO_CORPUS_DIR`` environment variable — one switch flips every
    figure script, ``corpus_sweep``, ``adaptive_bench`` and the
    streaming pipeline job onto real traces.
    """
    return corpus_dir or os.environ.get("REPRO_CORPUS_DIR") or None
