"""Batched trace sweep: a corpus of traces advanced lane by lane.

Counterpart of the batch half of ``repro/cache/sweep.py``:

* ``pad_traces`` stacks a suite of traces to a common length;
* ``build_batched_step`` advances every trace lane by one request:
  the segments of ``simulator.build_segments`` run on the stacked
  carry, recording segments go through
  ``mithril.record_event_batched`` with the fused record kernel, and
  each mining barrier is one host check of which lanes filled their
  mining table, followed by ``mithril.mine_batched`` (the pairwise
  kernels) only when some did;
* ``sweep`` is the plain loop over ``(chunk, B)`` request slabs — the
  reference's offline special case of its streaming engine;
* ``plan_sweep`` is the reference's cost-model packer (one device, so
  ``n_shards`` is 1); ``sweep_scheduled`` runs a corpus through a plan,
  by default ``wide_plan``: one group of every trace. The packer prices
  XLA-compiled slab shapes, which the port does not have; here a
  request step costs about the same at any lane width, so the fewest
  groups are the fastest schedule.

Padded-tail requests carry ``valid=False`` into every segment, whose
updates then write back old values: an exhausted lane can neither change
state, contribute to statistics, nor trigger mining, so per-trace
results are bit-identical to simulating each trace alone. Steps past
the longest trace of a batch would be no-ops on every lane and are not
run. PyTorch runs eagerly, so ``SweepResult.compiles`` is always 0.

Streaming, the ring buffer and lane sharding are not ported yet.
"""

from __future__ import annotations

import time
from typing import Dict, Mapping, NamedTuple, Optional, Sequence, Tuple, \
    Union

import numpy as np
import torch

from ..core import mithril
from ..kernels import ops
from ..kernels.backend import resolve_device
from .simulator import Device, SimConfig, SimResult, Stats, build_segments

DEFAULT_CHUNK = 4096
DEFAULT_LANE_WIDTH = 16     # lanes per scheduled group


class PaddedSuite(NamedTuple):
    names: tuple            # (B,) trace names
    blocks: np.ndarray      # (B, T) int32, zero-padded past each length
    lengths: np.ndarray     # (B,) valid request count per trace


def pad_traces(traces: Union[Mapping[str, np.ndarray],
                             Sequence[np.ndarray]]) -> PaddedSuite:
    """Stack unequal-length traces into a zero-padded (B, T) batch."""
    if isinstance(traces, Mapping):
        names = tuple(traces.keys())
        arrs = [np.asarray(t, np.int32) for t in traces.values()]
    else:
        arrs = [np.asarray(t, np.int32) for t in traces]
        names = tuple(f"trace{i:03d}" for i in range(len(arrs)))
    if not arrs:
        raise ValueError("pad_traces needs at least one trace")
    lengths = np.array([len(a) for a in arrs], np.int64)
    blocks = np.zeros((len(arrs), int(lengths.max())), np.int32)
    for i, a in enumerate(arrs):
        blocks[i, : len(a)] = a
    return PaddedSuite(names, blocks, lengths)


def build_batched_step(cfg: SimConfig, device: Device = None):
    """Returns ``(init_batched, step)`` on ``device`` (None: the card).

    ``step(carry, block, valid)`` advances every lane by one request
    (``block``/``valid`` are (B,)) and returns ``(carry, hit)``; the
    carry is updated in place. Recording segments launch the fused
    record kernel once per segment (its plain version for CPU tensors);
    each mining barrier mines exactly the live lanes whose table filled,
    through the pairwise kernels.
    """
    dev = resolve_device(device)
    init_carry, segments = build_segments(cfg, dev)
    mine_rows = cfg.mithril.mine_rows

    def init_batched(batch_size: int):
        return init_carry(batch_size)

    def batched_maybe_mine(mith, valid):
        need = (mith.mine_fill >= mine_rows) & valid
        return mithril.mine_batched(
            cfg.mithril, mith, need,
            pairwise_fn=ops.mithril_pairwise_batched,
            serial_pairwise_fn=ops.mithril_pairwise)

    def step(carry, block, valid):
        aux = {"valid": valid}
        for fn, mine_after in segments:
            gate = getattr(fn, "record_gate", None)
            if gate is not None:
                blk, en = gate(block, aux)
                mithril.record_event_batched(
                    cfg.mithril, carry["mith"], blk, en,
                    fused_fn=ops.mithril_record_fused)
            else:
                carry, aux = fn(carry, block, aux)
            if mine_after:
                batched_maybe_mine(carry["mith"], valid)
        return carry, aux["hit"]

    return init_batched, step


class SweepResult(NamedTuple):
    stats: Stats            # numpy, every leaf with a leading (B,) axis
    hit_curve: np.ndarray   # (B, T) bool, False past each trace's length
    lengths: np.ndarray     # (B,)
    compiles: int           # always 0: PyTorch runs eagerly
    seconds: float          # wall-clock for this sweep call

    @property
    def n_traces(self) -> int:
        return len(self.lengths)

    def result(self, i: int) -> SimResult:
        """Per-trace view, same type ``simulate`` returns."""
        stats = Stats(*(np.asarray(leaf)[i] for leaf in self.stats))
        return SimResult(stats, self.hit_curve[i, : int(self.lengths[i])])

    def hit_ratios(self) -> np.ndarray:
        req = np.maximum(np.asarray(self.stats.requests), 1)
        return np.asarray(self.stats.hits) / req

    def precisions(self, src: int) -> np.ndarray:
        issued = np.asarray(self.stats.pf_issued)[:, src].astype(np.float64)
        used = np.asarray(self.stats.pf_used)[:, src]
        with np.errstate(invalid="ignore", divide="ignore"):
            return np.where(issued > 0, used / issued, np.nan)


def _check_lengths(lengths, n: int, t_max: int) -> np.ndarray:
    lengths = (np.full((n,), t_max, np.int64) if lengths is None
               else np.asarray(lengths, np.int64))
    if lengths.shape != (n,) or (lengths > t_max).any() \
            or (lengths < 0).any():
        raise ValueError("lengths must be (B,) within [0, trace axis]")
    return lengths


def sweep(cfg: SimConfig, blocks: np.ndarray,
          lengths: Optional[np.ndarray] = None,
          chunk: int = DEFAULT_CHUNK,
          device: Device = None) -> SweepResult:
    """Run a (B, T) padded trace batch through one configuration.

    ``lengths`` gives each trace's valid prefix (default: full T);
    requests past it are bit-exact no-ops excluded from all statistics.
    Requests are staged on the device one ``(chunk, B)`` slab at a time
    and hits come back per slab. Results are bit-identical to running
    each trace through ``simulate`` alone.
    """
    t0 = time.time()
    dev = resolve_device(device)
    blocks = np.ascontiguousarray(np.asarray(blocks, np.int32))
    if blocks.ndim != 2:
        raise ValueError(f"blocks must be (B, T), got {blocks.shape}")
    n_traces, n_req = blocks.shape
    lengths = _check_lengths(lengths, n_traces, n_req)
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")

    init_batched, step = build_batched_step(cfg, dev)
    carry = init_batched(n_traces)
    hit = np.zeros((n_traces, n_req), bool)
    lens = torch.as_tensor(lengths, device=dev)
    t_end = int(lengths.max()) if n_traces else 0
    for c0 in range(0, t_end, chunk):
        c1 = min(c0 + chunk, t_end)
        slab = torch.as_tensor(np.ascontiguousarray(blocks[:, c0:c1].T),
                               device=dev)
        valid = (torch.arange(c0, c1, device=dev)[:, None] < lens[None, :])
        hits = []
        for t in range(c1 - c0):
            carry, h = step(carry, slab[t], valid[t])
            hits.append(h)
        hit[:, c0:c1] = torch.stack(hits, 1).cpu().numpy()

    from ..convert import to_numpy
    return SweepResult(stats=Stats(*to_numpy(carry["stats"])),
                       hit_curve=hit, lengths=lengths, compiles=0,
                       seconds=time.time() - t0)


# ---------------------------------------------------------------------------
# Corpus-scale scheduler: cost-model lane packer, bounded slab shapes
#
# The reference's packer, unchanged, so plans are equal. Its cost model
# prices compiled slab shapes (XLA executables), which the port does not
# have; on the card a step costs about the same at any lane width, so a
# caller there passes a large ``overhead_lanes`` to get one wide group.
# ---------------------------------------------------------------------------

DEFAULT_MAX_SHAPES = 2      # distinct lane widths (= compiled slab shapes)
# Per-group serial-dispatch cost in lane-equivalents. Any positive value
# stops the pure padded-steps objective from shredding the corpus into
# width-1 groups (grouping equal-padded traces then always wins); the
# default is deliberately small because a chunk launch costs far less
# than one lane of chunk compute — raise it on hardware where narrow
# lanes underfill the vector unit (DESIGN.md §9).
DEFAULT_PACK_OVERHEAD = 0.25


class LaneGroup(NamedTuple):
    indices: Tuple[int, ...]    # original trace positions in this group
    padded_t: int               # group time axis (a chunk multiple)
    lane_width: int             # lanes this group pads to
    chunk: int                  # time-axis chunk of this group's slabs


class SweepPlan(NamedTuple):
    """Device-and-shape schedule for a heterogeneous trace corpus.

    Groups are consecutive runs of the length-sorted corpus (longest
    first), each running through a ``(chunk, width)`` slab shape drawn
    from at most ``max_shapes`` distinct shapes — one compiled
    executable per shape. Both axes are free per group: a short-trace
    group may take a *narrower lane width* AND a *finer time chunk*
    than the primary shape (the second-chunk freedom of DESIGN.md §9),
    so chunk granularity no longer floors the padded tail on short
    corpora. The port runs one device, so ``n_shards`` is always 1;
    chunks are halvings of the base chunk. ``lane_width``/``chunk`` are
    the widest group's shape (the primary slab).
    """

    groups: Tuple[LaneGroup, ...]
    lane_width: int             # max group width (primary compiled shape)
    chunk: int                  # base (primary) time chunk
    n_shards: int
    total_requests: int         # sum of valid per-trace lengths
    fixed_lane_steps: int       # padded_lane_steps of the fixed-shape plan

    @property
    def padded_lane_steps(self) -> int:
        """Total (lane x request) slots the schedule executes."""
        return sum(g.padded_t * g.lane_width for g in self.groups)

    @property
    def shape_widths(self) -> Tuple[int, ...]:
        """Distinct lane widths across the compiled slab shapes."""
        return tuple(sorted({g.lane_width for g in self.groups}))

    @property
    def shapes(self) -> Tuple[Tuple[int, int], ...]:
        """Distinct compiled ``(chunk, width)`` slab shapes."""
        return tuple(sorted({(g.chunk, g.lane_width) for g in self.groups}))

    @property
    def waste_ratio(self) -> float:
        """Fraction of executed lane-steps that are padded-tail waste."""
        steps = self.padded_lane_steps
        return 1.0 - self.total_requests / steps if steps else 0.0

    @property
    def fixed_waste_ratio(self) -> float:
        """Waste ratio of the fixed-shape reference plan (same inputs)."""
        if not self.fixed_lane_steps:
            return 0.0
        return 1.0 - self.total_requests / self.fixed_lane_steps

    def packer_stats(self) -> Dict[str, object]:
        """Packer-efficiency summary recorded in BENCH json."""
        return {
            "n_traces": sum(len(g.indices) for g in self.groups),
            "n_groups": len(self.groups),
            "widths": list(self.shape_widths),
            "shapes": [f"{c}x{w}" for c, w in self.shapes],
            "n_shapes": len(self.shapes),
            "chunk": self.chunk,
            "n_shards": self.n_shards,
            "padded_lane_steps": int(self.padded_lane_steps),
            "ideal_lane_steps": int(self.total_requests),
            "waste_ratio": round(self.waste_ratio, 6),
            "fixed_padded_lane_steps": int(self.fixed_lane_steps),
            "fixed_waste_ratio": round(self.fixed_waste_ratio, 6),
            "reduction_vs_fixed": round(
                1.0 - (self.padded_lane_steps / self.fixed_lane_steps
                       if self.fixed_lane_steps else 1.0), 6),
        }


def _width_candidates(w_max: int) -> Tuple[int, ...]:
    """Packer width ladder: ``w_max`` and its successive halvings,
    deduplicated, ascending."""
    cands = set()
    w = w_max
    while w >= 1:
        cands.add(w)
        if w == 1:
            break
        w //= 2
    return tuple(sorted(cands))


# Chunk-ladder depth: the base chunk plus up to this many halvings are
# shape candidates. Three halvings reach chunk/8 — finer granularity
# stops mattering once the per-trace remainder is < 1/8 of a chunk,
# while the candidate-shape count (widths x chunks) stays small enough
# to enumerate shape subsets exhaustively.
_CHUNK_LADDER = 3


def _chunk_candidates(base: int) -> Tuple[int, ...]:
    """Time-axis chunk ladder: the base chunk and its halvings
    (``_CHUNK_LADDER`` deep, floored at 1), deduplicated, ascending."""
    cands = set()
    c = base
    for _ in range(_CHUNK_LADDER + 1):
        cands.add(max(1, c))
        c //= 2
    return tuple(sorted(cands))


def _padded_len(length: int, chunk: int) -> int:
    return -(-max(1, int(length)) // chunk) * chunk


def _pack(lengths: Sequence[int], shapes: Sequence[Tuple[int, int]],
          overhead: float) -> Tuple[float, Tuple[Tuple[int, int], ...]]:
    """Optimal consecutive partition of the length-sorted corpus.

    ``lengths[i]`` is trace ``i``'s raw length, sorted descending, so a
    group covering positions ``[i, i+w)`` pads its time axis to position
    ``i``'s length rounded up to the group's chunk. ``shapes`` are the
    candidate ``(width, chunk)`` slab shapes. Minimizes

        sum_g padded_t_g * (w_g + overhead)

    — the schedule's padded lane-steps plus a per-group serial-dispatch
    term (``overhead`` lane-equivalents) that keeps the otherwise
    degenerate width-1 optimum from shredding the corpus into
    per-trace groups. Returns (cost, per-group (width, chunk) in order).
    """
    n = len(lengths)
    cost = [0.0] * (n + 1)
    choice: list = [None] * n
    for i in range(n - 1, -1, -1):
        best, best_s = None, shapes[0]
        for w, ck in shapes:
            c = _padded_len(lengths[i], ck) * (w + overhead) \
                + cost[min(n, i + w)]
            if best is None or c < best:
                best, best_s = c, (w, ck)
        cost[i], choice[i] = best, best_s
    group_shapes = []
    i = 0
    while i < n:
        group_shapes.append(choice[i])
        i += choice[i][0]
    return cost[0], tuple(group_shapes)


def plan_sweep(lengths, lane_width: Optional[int] = None,
               chunk: int = DEFAULT_CHUNK,
               max_shapes: int = DEFAULT_MAX_SHAPES,
               overhead_lanes: float = DEFAULT_PACK_OVERHEAD) -> SweepPlan:
    """Pack traces into lane groups with a cost-model packer (§9).

    Traces sort longest-first; groups are consecutive runs of that
    order, so a group's time axis pads to its FIRST member's length
    rounded up to the *group's* chunk. The packer chooses per-group
    ``(width, chunk)`` slab shapes from the candidate ladders — widths
    are ``lane_width`` (default ``min(n, DEFAULT_LANE_WIDTH)``) and its
    halvings; chunks are the base chunk and its halvings — to minimize total padded lane-steps plus
    an ``overhead_lanes`` serial-dispatch term per group, subject to
    the compile budget: at most ``max_shapes`` DISTINCT ``(chunk,
    width)`` shapes, because every distinct slab shape is one more
    executable. A short-trace group may therefore take a finer time
    chunk than the primary shape (not just a narrower width), which
    recovers the chunk-floor waste on short corpora. Plans are
    guaranteed never worse than the fixed-shape reference (single
    shape ``(lane_width, chunk)``) in padded lane-steps — when the
    cost-model pick loses on pure padded waste it falls back to the
    reference (``fixed_lane_steps`` records the reference either way).

    The plan is for one device (``n_shards`` = 1). The effective base
    chunk is capped at the longest trace (padded up), so each group's
    loop reuses its shape's ``(chunk, width)`` slab.
    """
    lengths = np.asarray(lengths, np.int64)
    n = len(lengths)
    if n == 0:
        raise ValueError("plan_sweep needs at least one trace")
    if max_shapes < 1:
        raise ValueError("max_shapes must be >= 1")
    w_max = min(n, DEFAULT_LANE_WIDTH) if lane_width is None \
        else max(1, lane_width)
    eff_chunk = max(1, min(chunk, int(lengths.max())))
    order = np.argsort(-lengths, kind="stable")   # longest first
    sorted_lens = [int(lengths[i]) for i in order]

    def steps_of(group_shapes: Sequence[Tuple[int, int]]) -> int:
        total, i = 0, 0
        for w, ck in group_shapes:
            total += _padded_len(sorted_lens[i], ck) * w
            i += w
        return total

    # fixed-shape reference: the single-shape plan at (w_max, eff_chunk)
    _, fixed_shapes = _pack(sorted_lens, ((w_max, eff_chunk),),
                            overhead_lanes)
    fixed_steps = steps_of(fixed_shapes)

    # shape subsets within the compile budget, simplest-first: every
    # single shape, then pairs, ... — ties keep the earlier (simpler)
    # plan, so the search is deterministic. Candidate shapes are the
    # width ladder x chunk ladder, ordered coarse-to-fine.
    from itertools import combinations
    cands = [(w, ck)
             for w in reversed(_width_candidates(w_max))
             for ck in reversed(_chunk_candidates(eff_chunk))]
    best_cost, best_shapes = None, fixed_shapes
    for size in range(1, min(max_shapes, len(cands)) + 1):
        for subset in combinations(cands, size):
            cost, shapes = _pack(sorted_lens, subset, overhead_lanes)
            if best_cost is None or cost < best_cost:
                best_cost, best_shapes = cost, shapes

    # never-worse guard: the packer must not trade padded waste for
    # dispatch savings relative to the documented fixed-shape reference
    if steps_of(best_shapes) > fixed_steps:
        best_shapes = fixed_shapes

    groups, i = [], 0
    for w, ck in best_shapes:
        idx = order[i: i + w]
        groups.append(LaneGroup(tuple(int(j) for j in idx),
                                _padded_len(sorted_lens[i], ck),
                                int(w), int(ck)))
        i += w
    return SweepPlan(tuple(groups),
                     max(g.lane_width for g in groups),
                     eff_chunk, 1,
                     int(lengths.sum()), int(fixed_steps))


def wide_plan(lengths, lane_width: Optional[int] = None,
              chunk: int = DEFAULT_CHUNK) -> SweepPlan:
    """The default schedule of :func:`sweep_scheduled`: consecutive
    groups of ``lane_width`` traces (default: all of them) in
    longest-first order, each padded to its first member's length."""
    lengths = np.asarray(lengths, np.int64)
    n = len(lengths)
    if n == 0:
        raise ValueError("wide_plan needs at least one trace")
    w = n if lane_width is None else max(1, min(lane_width, n))
    eff_chunk = max(1, min(chunk, int(lengths.max())))
    order = np.argsort(-lengths, kind="stable")
    groups = tuple(
        LaneGroup(tuple(int(j) for j in order[i:i + w]),
                  _padded_len(int(lengths[order[i]]), eff_chunk),
                  len(order[i:i + w]), eff_chunk)
        for i in range(0, n, w))
    steps = sum(g.padded_t * g.lane_width for g in groups)
    return SweepPlan(groups, max(g.lane_width for g in groups), eff_chunk,
                     1, int(lengths.sum()), steps)


def sweep_scheduled(cfg: SimConfig,
                    traces: Union[Mapping[str, np.ndarray],
                                  Sequence[np.ndarray], PaddedSuite,
                                  np.ndarray],
                    lengths: Optional[np.ndarray] = None,
                    lane_width: Optional[int] = None,
                    chunk: int = DEFAULT_CHUNK,
                    plan: Optional[SweepPlan] = None,
                    device: Device = None) -> SweepResult:
    """Sweep an arbitrary-size trace corpus through one configuration.

    Accepts a dict/sequence of unequal-length traces, a
    :class:`PaddedSuite`, or a ``(B, T)`` block array with ``lengths``.
    The corpus is scheduled with ``plan`` (default :func:`wide_plan`
    at ``lane_width``; :func:`plan_sweep` gives the reference packer's
    plan), each group runs
    through :func:`sweep`, and per-trace results are reassembled in the
    ORIGINAL trace order. Statistics are bit-identical to sweeping (or
    serially simulating) each trace alone; groups holding fewer traces
    than their lane width are padded with empty (length-0) lanes.
    """
    t0 = time.time()
    dev = resolve_device(device)
    if not isinstance(traces, np.ndarray):
        if lengths is not None:
            raise ValueError("pass lengths only with a (B, T) block array"
                             " — suites already carry per-trace lengths")
        if not isinstance(traces, PaddedSuite):
            traces = pad_traces(traces)
        blocks, lengths = traces.blocks, traces.lengths
    else:
        blocks = np.asarray(traces, np.int32)
    if blocks.ndim != 2:
        raise ValueError(f"traces must stack to (B, T), got {blocks.shape}")
    n, t_max = blocks.shape
    lengths = _check_lengths(lengths, n, t_max)
    if plan is None:
        plan = wide_plan(lengths, lane_width, chunk)

    stats_out = None
    hit = np.zeros((n, t_max), bool)
    for g in plan.groups:
        gb = np.zeros((g.lane_width, g.padded_t), np.int32)
        gl = np.zeros((g.lane_width,), np.int64)
        for j, idx in enumerate(g.indices):
            ln = int(lengths[idx])
            gb[j, :ln] = blocks[idx, :ln]
            gl[j] = ln
        res = sweep(cfg, gb, gl, chunk=g.chunk, device=dev)
        if stats_out is None:
            stats_out = [np.zeros((n,) + leaf.shape[1:], leaf.dtype)
                         for leaf in res.stats]
        for j, idx in enumerate(g.indices):
            ln = int(lengths[idx])
            hit[idx, :ln] = res.hit_curve[j, :ln]
            for leaf_out, leaf in zip(stats_out, res.stats):
                leaf_out[idx] = leaf[j]

    return SweepResult(stats=Stats(*stats_out), hit_curve=hit,
                       lengths=lengths, compiles=0,
                       seconds=time.time() - t0)


def sweep_grid(cfgs: Dict[str, SimConfig], blocks: np.ndarray,
               lengths: Optional[np.ndarray] = None,
               chunk: int = DEFAULT_CHUNK,
               device: Device = None) -> Dict[str, SweepResult]:
    """Sweep the trace batch through every config in the grid; equal
    configs share one pass (the frozen configs are hashable)."""
    memo: Dict[SimConfig, SweepResult] = {}
    out = {}
    for name, cfg in cfgs.items():
        if cfg not in memo:
            memo[cfg] = sweep(cfg, blocks, lengths, chunk=chunk,
                              device=device)
        out[name] = memo[cfg]
    return out
