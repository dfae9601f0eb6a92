"""Synthetic trace generators, the 135-trace corpus registry, real-trace
ingestion and corpus directories (copies of the reference's numpy
modules)."""

from .synthetic import (arrival_process, association_groups,
                        interleaved_sequential, looping, mixed, padded_suite,
                        representative_traces, stack_padded, suite, zipf)
from .corpus import (FAMILIES, INGESTED, SCALES, RealCorpus, WorkloadSpec,
                     build_corpus, corpus_specs, corpus_suite, family_of,
                     resolve_corpus_dir)
from .io import (corpus_fingerprint, ingest, ingest_msr_csv, ingest_raw,
                 ingest_to_dir, ingest_to_npz, load_corpus_dir, load_traces,
                 read_manifest, save_traces, scan_corpus_dir, workload_stats,
                 write_corpus_dir)

__all__ = [
    "arrival_process", "association_groups", "interleaved_sequential",
    "looping", "mixed", "padded_suite", "representative_traces",
    "stack_padded", "suite", "zipf",
    "FAMILIES", "INGESTED", "SCALES", "RealCorpus", "WorkloadSpec",
    "build_corpus", "corpus_specs", "corpus_suite", "family_of",
    "resolve_corpus_dir",
    "corpus_fingerprint", "ingest", "ingest_msr_csv", "ingest_raw",
    "ingest_to_dir", "ingest_to_npz", "load_corpus_dir", "load_traces",
    "read_manifest", "save_traces", "scan_corpus_dir", "workload_stats",
    "write_corpus_dir",
]
