"""MITHRIL core on tensors: sporadic-association mining for prefetching.

Counterpart of ``repro/core``: fixed-shape recording/mining/prefetching
tables with a leading lanes axis, the mining procedure (dense vectorized
+ sequential oracle) and the Alg. 3 access API.
"""

from .config import MithrilConfig
from .state import MithrilState, init_state
from .mithril import (access, add_association, assoc_count, init, lookup,
                      maybe_mine, mine, mine_batched, record, record_event,
                      record_event_batched)
from .mining import (associations_dense, associations_dense_batched,
                     mine_reference_sequential, pairwise_codes,
                     pairwise_codes_batched, select_pairs, sort_by_first_ts)
from .hashindex import EMPTY

__all__ = [
    "MithrilConfig", "MithrilState", "init_state", "init",
    "access", "add_association", "assoc_count", "lookup", "mine", "record",
    "record_event", "record_event_batched", "maybe_mine", "mine_batched",
    "associations_dense", "associations_dense_batched",
    "mine_reference_sequential", "pairwise_codes", "pairwise_codes_batched",
    "select_pairs", "sort_by_first_ts", "EMPTY",
]
