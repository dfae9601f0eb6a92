"""Configuration for the MITHRIL prefetching layer.

Defaults follow the paper (Sec. 4.4 / Sec. 5.4): minimum support R=4,
maximum support S=8, lookahead range ``delta``~100, prefetching list size
P=2, and a metadata budget of ~10% of the cache. Capacities here are
expressed directly in rows because the implementation uses fixed-shape
arrays; ``from_metadata_budget`` derives them from a byte budget the same
way the paper derives table sizes from ``M``.
"""

from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class MithrilConfig:
    # --- paper parameters -------------------------------------------------
    min_support: int = 4          # R: timestamps needed before mining-ready
    max_support: int = 8          # S: row length in the mining table
    lookahead: int = 100          # Delta: max logical-ts distance for association
    prefetch_list: int = 2        # P: associations kept per source block
    # --- capacities (fixed-shape tensors) ------------------------------
    rec_buckets: int = 2048       # recording-table buckets
    rec_ways: int = 4             # set-associativity of the recording table
    mine_rows: int = 256          # mining-table rows; mining triggers when full
    pf_buckets: int = 4096        # prefetching-table buckets
    pf_ways: int = 4              # set-associativity of the prefetching table
    # --- policies ----------------------------------------------------------
    record_on: str = "miss"       # miss | evict | miss+evict | all (paper Fig 7f)
    max_window: int = 0           # 0 => min(mine_rows - 1, lookahead)
    max_pairs: int = 0            # pairs kept per mining run; 0 => 2*mine_rows
    # --- beyond-paper extensions (off by default = paper-faithful) ---------
    symmetric: bool = False       # also insert dst->src for every mined pair

    def __post_init__(self) -> None:
        if self.min_support < 1:
            raise ValueError("min_support must be >= 1")
        if self.max_support < self.min_support:
            raise ValueError("max_support must be >= min_support")
        if self.prefetch_list < 1:
            raise ValueError("prefetch_list must be >= 1")
        if self.record_on not in ("miss", "evict", "miss+evict", "all"):
            raise ValueError(f"bad record_on: {self.record_on}")

    @property
    def window(self) -> int:
        """Mining look-ahead window in *rows* (paper: inner-loop break bound).

        First timestamps are unique per recording event, so at most
        ``lookahead`` rows can fall within ``Delta`` of row i after the sort.
        """
        if self.max_window:
            return min(self.max_window, self.mine_rows - 1)
        return min(self.mine_rows - 1, self.lookahead)

    @property
    def pairs_cap(self) -> int:
        """Max associations materialized per mining run (compaction bound)."""
        return self.max_pairs if self.max_pairs else 2 * self.mine_rows

    # -- metadata accounting (paper Sec 4.4) --------------------------------
    def metadata_bytes(self) -> int:
        """Bytes used by all MITHRIL state (int32 timestamps; see DESIGN.md)."""
        rec = self.rec_buckets * self.rec_ways * (4 + 4 + 4 + 4 * self.min_support)
        mine = self.mine_rows * (4 + 4 + 4 * self.max_support)
        pf = self.pf_buckets * self.pf_ways * (4 + 4 + 4 + 4 * self.prefetch_list)
        return rec + mine + pf + 64

    @classmethod
    def from_metadata_budget(cls, budget_bytes: int, **kw) -> "MithrilConfig":
        """Size the tables to fit ``budget_bytes`` (the paper's ``M``).

        Split the budget like the paper's defaults do: ~55% recording,
        ~5% mining, ~40% prefetching, then round capacities down to
        powers of two so bucket hashing stays a mask.
        """
        base = cls(**kw)
        rec_row = 4 + 4 + 4 + 4 * base.min_support
        pf_row = 4 + 4 + 4 + 4 * base.prefetch_list
        mine_row = 4 + 4 + 4 * base.max_support
        rec_rows = max(base.rec_ways, int(budget_bytes * 0.55) // rec_row)
        pf_rows = max(base.pf_ways, int(budget_bytes * 0.40) // pf_row)
        mine_rows = max(16, int(budget_bytes * 0.05) // mine_row)

        def pow2_floor(n: int) -> int:
            return 1 << max(0, int(math.floor(math.log2(max(1, n)))))

        return dataclasses.replace(
            base,
            rec_buckets=max(1, pow2_floor(rec_rows // base.rec_ways)),
            pf_buckets=max(1, pow2_floor(pf_rows // base.pf_ways)),
            mine_rows=pow2_floor(mine_rows),
        )
