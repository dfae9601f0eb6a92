"""Synthetic trace generators and the 135-trace corpus registry (copies
of the reference's numpy generators)."""

from .synthetic import (arrival_process, association_groups,
                        interleaved_sequential, looping, mixed, padded_suite,
                        representative_traces, stack_padded, suite, zipf)
from .corpus import (FAMILIES, INGESTED, SCALES, WorkloadSpec, build_corpus,
                     corpus_specs, corpus_suite, family_of)

__all__ = [
    "arrival_process", "association_groups", "interleaved_sequential",
    "looping", "mixed", "padded_suite", "representative_traces",
    "stack_padded", "suite", "zipf",
    "FAMILIES", "INGESTED", "SCALES", "WorkloadSpec", "build_corpus",
    "corpus_specs", "corpus_suite", "family_of",
]
