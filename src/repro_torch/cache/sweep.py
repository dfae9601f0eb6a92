"""Batched trace sweep and the streaming engine: a corpus of traces
advanced lane by lane.

Counterpart of ``repro/cache/sweep.py``:

* ``pad_traces`` stacks a suite of traces to a common length;
* ``build_batched_step`` advances every trace lane by one request:
  the segments of ``simulator.build_segments`` run on the stacked
  carry (on the card the cache set is two hand-written kernels, the
  access with its recording event and the MITHRIL prefetch), and each
  mining barrier is ``mithril.mine_batched`` on the device mask of the
  lanes that filled their mining table: on the card one launch of the
  fused mining run and no host wait;
* the chunk runner (``_runner``, ``compile_count``, ``reset_runners``),
  the counterpart of the reference's jitted ``lax.scan`` of a chunk: on
  the card, for each configuration, ``unroll`` = G and lane width W, one
  ``torch.cuda.CUDAGraph`` of G steps captured over a static carry and
  static ``(G, W)`` inputs, replayed ``chunk / G`` times a slab (a
  capture is what the reference counts as a compile); on the CPU the
  eager loop over the step;
* ``sweep_streaming`` is the streaming engine: traces are admitted in
  FIFO order into a recycled pool of lanes at slab boundaries, arrival
  gaps become invalid rows, a drained lane is reset in place
  (``_masked_reset``), slabs stage through a :class:`RingBuffer` ahead
  of the device and, with ``async_producer``, a producer thread stages
  them and a drain thread brings the hits back;
* ``sweep`` is its offline special case (lane width B, every trace at
  step 0), as in the reference;
* ``plan_sweep`` is the reference's cost-model packer (one device, so
  ``n_shards`` is 1); ``sweep_scheduled`` runs a corpus through a plan,
  by default ``wide_plan``: one group of every trace. The packer prices
  XLA-compiled slab shapes; here a request step costs about the same at
  any lane width, so the fewest groups are the fastest schedule.

Padded-tail requests carry ``valid=False`` into every segment, whose
updates then write back old values: an exhausted lane can neither change
state, contribute to statistics, nor trigger mining, so per-trace
results are bit-identical to simulating each trace alone. Groups of
steps in which no lane is valid are therefore skipped, on the card and
on the CPU alike.

Lane sharding (``shard=None``/``True``, the reference's): lanes never
communicate, so a sweep whose lane width divides over the local cards
(``torch.cuda.device_count()``, or an explicit ``devices`` sequence)
splits its lanes into contiguous blocks, one chunk runner and carry per
block on its device, with no collective; per-lane results are the
single-device runner's bit for bit. ``shard=False`` forces one device.
Two shards on one device (``devices=["cpu", "cpu"]``) keep two runners:
a runner's carry and graphs are its own.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import queue as _queue_mod
import threading
import time
from typing import Dict, List, Mapping, NamedTuple, Optional, Sequence, \
    Tuple, Union

import numpy as np
import torch

from ..core import mithril
from ..kernels import ops
from ..kernels.backend import resolve_device
from ..runtime import spans
from .simulator import Device, SimConfig, SimResult, Stats, build_segments

DEFAULT_CHUNK = 4096
DEFAULT_LANE_WIDTH = 16     # lanes per scheduled group
# request steps in one captured graph. With the cache set in two kernels
# a step is 3 launches, and at G = 16 the consumer's host work for each
# replay (its copies and events) set the pace of a pass; G = 64 makes the
# device the pace (PERF.md)
DEFAULT_UNROLL = 64


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

    ``step(carry, block, valid, hit=None)`` advances every lane by one
    request (``block``/``valid`` are (B,)) and returns ``(carry, hit)``;
    the carry is updated in place and ``hit``, if given, receives the hit
    row. On the card, without a learned scorer, the step is three
    launches: the cache access with its first recording event
    (``ops.cache_access``), the mining barrier, and the MITHRIL lookup
    with its prefetch inserts (``ops.mithril_prefetch``); ``miss+evict``
    adds the record kernel and a second barrier. Each barrier mines
    exactly the live lanes whose table filled: on the card one launch of
    the fused mining run on the device mask. On the card the step reads
    nothing on the host, so a CUDA graph can capture it.
    """
    dev = resolve_device(device)
    init_carry, segments = build_segments(cfg, dev)

    def init_batched(batch_size: int):
        return init_carry(batch_size)

    def step(carry, block, valid, hit=None):
        aux = {"valid": valid, "hit_out": hit}
        for fn, mine_after in segments:
            carry, aux = fn(carry, block, aux)
            if mine_after:
                mithril.mine_batched(cfg.mithril, carry["mith"], aux["need"])
        return carry, aux["hit"]

    return init_batched, step


# ---------------------------------------------------------------------------
# The chunk runner: captured CUDA graphs of the request step on the card
# ---------------------------------------------------------------------------

def _leaves(carry) -> List[torch.Tensor]:
    """Every tensor of a sweep carry, in one fixed order."""
    return [leaf for part in carry.values() for leaf in part]


def _assign(carry, template) -> None:
    """Every lane of ``carry`` becomes the template's, in place."""
    for c, t in zip(_leaves(carry), _leaves(template)):
        c.copy_(t)


def _masked_reset(carry, template, mask: torch.Tensor):
    """Lane recycling: where ``mask`` (W,) is set, the lane's carry
    becomes the init template bit for bit; every other lane keeps its
    state untouched. A recycled lane is therefore indistinguishable from
    a fresh lane in a fresh batch. In place: the captured graphs and the
    bound kernel launchers hold the carry's addresses, so no tensor of
    it is rebound."""
    for c, t in zip(_leaves(carry), _leaves(template)):
        torch.where(mask.view((-1,) + (1,) * (c.dim() - 1)), t, c, out=c)
    return carry


class _Graph(NamedTuple):
    """One captured graph of G request steps at lane width W."""
    carry: dict                 # the static carry the graph steps
    blocks: torch.Tensor        # (G, W) int32, static input
    valid: torch.Tensor         # (G, W) bool, static input
    hits: torch.Tensor          # (G, W) bool, static output
    graph: "torch.cuda.CUDAGraph"
    launches: Dict[str, int]    # kernel launches of a replay, by wrapper


class ChunkRunner:
    """Runs ``(chunk, W)`` request slabs of one configuration.

    On the card each lane width gets, at its first use, a static carry,
    static ``(G, W)`` block, valid and hit buffers and one CUDA graph of
    ``G = unroll`` calls of ``step``, step g reading row g and writing
    hits row g. A slab runs as ``ceil(chunk / G)`` replays: before each,
    the slab's next G rows are copied into the static inputs (a short
    last group is padded with invalid rows, which are no-ops); after it,
    the hit rows are copied out. A group of rows with no valid lane is a
    no-op on every lane and is not replayed. Before each capture
    one eager step with every lane invalid runs on a side stream, so
    that cached constants, each kernel's first launch and the mining
    run's shared-memory limit are set up outside the capture. A capture
    that fails raises: the card never falls back to eager steps.

    The kernel wrappers count launches in Python, which runs at capture
    and not at replay: the runner takes back what the capture counted
    and adds it again at every replay, so ``ops.launch_counts()`` stays
    the number of launches the card ran.

    On the CPU ``run`` is the eager loop over the step (the plain
    kernels), every row that holds a valid lane, and nothing is
    captured. On both devices a runner keeps one carry per lane width,
    which a sweep resets at its start and leaves as its end state (its
    MITHRIL state included, ``n_mines`` counting each lane's mining
    runs). One sweep at a time may use a runner.
    """

    def __init__(self, cfg: SimConfig, unroll: int, device: torch.device):
        if isinstance(unroll, bool) or not isinstance(
                unroll, (int, np.integer)) or unroll < 1:
            raise ValueError(f"unroll must be an int >= 1, got {unroll!r}")
        self.cfg, self.unroll, self.device = cfg, int(unroll), device
        self.init_batched, self.step = build_batched_step(cfg, device)
        self.graphs: Dict[int, _Graph] = {}
        self.carries: Dict[int, dict] = {}       # the CPU's, by width
        self.capture_seconds = 0.0
        self.replays = 0

    @property
    def captures(self) -> int:
        """Graphs captured so far (one per lane width; 0 on the CPU)."""
        return len(self.graphs)

    def carry(self, lanes: int):
        """The carry that ``run`` advances at this width, made at the first
        call (on the card the width's static carry, whose graph is
        captured then); after a sweep, that sweep's end state."""
        if self.device.type != "cuda":
            if lanes not in self.carries:
                self.carries[lanes] = self.init_batched(lanes)
            return self.carries[lanes]
        if lanes not in self.graphs:
            with spans.span("runner.capture") as cap:
                self.graphs[lanes] = self._capture(lanes)
            self.capture_seconds += cap.seconds
        return self.graphs[lanes].carry

    def _capture(self, lanes: int) -> _Graph:
        dev, g = self.device, self.unroll
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            self.step(self.init_batched(lanes),
                      torch.zeros(lanes, dtype=torch.int32, device=dev),
                      torch.zeros(lanes, dtype=torch.bool, device=dev))
        torch.cuda.synchronize(dev)
        carry = self.init_batched(lanes)
        blocks = torch.zeros((g, lanes), dtype=torch.int32, device=dev)
        valid = torch.zeros((g, lanes), dtype=torch.bool, device=dev)
        hits = torch.zeros((g, lanes), dtype=torch.bool, device=dev)
        graph = torch.cuda.CUDAGraph()
        before = ops.launch_counts()
        try:
            with torch.cuda.graph(graph):
                for i in range(g):
                    self.step(carry, blocks[i], valid[i], hits[i])
        finally:
            counted = ops.launch_counts()
            ops.set_launch_counts(before)
        torch.cuda.synchronize(dev)
        return _Graph(carry, blocks, valid, hits, graph,
                      {k: n - before[k] for k, n in counted.items()
                       if n != before[k]})

    def run(self, carry, blocks: torch.Tensor, valid: torch.Tensor,
            live: np.ndarray) -> torch.Tensor:
        """Advance ``carry`` through the ``(chunk, W)`` slab in place;
        ``live`` (chunk,) says which rows hold a valid lane. Returns the
        ``(chunk, W)`` hits on the device, without waiting for them. On
        the card each replay, with its input and hit copies, is a
        ``replay`` device interval of the call's record, and the replay
        alone a ``runner.replay`` span."""
        chunk, lanes = blocks.shape
        hits = torch.zeros((chunk, lanes), dtype=torch.bool,
                           device=blocks.device)
        if self.device.type != "cuda":
            for t in np.flatnonzero(live):
                hits[t] = self.step(carry, blocks[t], valid[t])[1]
            return hits
        cap = self.graphs.get(lanes)
        if cap is None or carry is not cap.carry:
            raise ValueError("a runner on the card advances its own carry: "
                             "pass runner.carry(lanes)")
        g = self.unroll
        starts = np.arange(0, chunk, g)
        starts = starts[np.logical_or.reduceat(live, starts)]
        for r0 in starts.tolist():
            n = min(g, chunk - r0)
            with spans.device("replay", self.device):
                cap.blocks[:n].copy_(blocks[r0:r0 + n])
                cap.valid[:n].copy_(valid[r0:r0 + n])
                if n < g:
                    cap.valid[n:].zero_()
                with spans.span("runner.replay"):
                    cap.graph.replay()
                hits[r0:r0 + n].copy_(cap.hits[:n])
        self.replays += len(starts)
        ops.add_launch_counts(cap.launches, len(starts))
        return hits


def _device(device: Device) -> torch.device:
    """``resolve_device`` with the card's index filled in (a cache key)."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


@functools.lru_cache(maxsize=None)
def _runner(cfg: SimConfig, unroll: int, device: torch.device,
            shard: int = 0) -> ChunkRunner:
    """One chunk runner per (config, steps a graph, device, lane shard)."""
    return ChunkRunner(cfg, unroll, device)


def _shard_devices(device: Device, n_shards: int) -> Tuple[torch.device, ...]:
    """The devices of an ``n_shards``-way lane split of a sweep on
    ``device``: the cards 0..n-1, or ``device`` n times on the CPU."""
    dev = _device(device)
    if dev.type == "cuda" and n_shards > 1:
        return tuple(torch.device("cuda", i) for i in range(n_shards))
    return (dev,) * n_shards


def _lane_shards(n_lanes: int, shard: Optional[bool], device: Device = None,
                 devices: Optional[Sequence[Device]] = None
                 ) -> Tuple[torch.device, ...]:
    """The devices to split the lane axis over, one per shard (one
    device: the single-device path).

    Auto policy (``shard=None``/``True``): every local card (or each of
    ``devices``) when the lane count divides — the divisibility contract
    of ``dist.sharding`` (a width that does not divide runs on one
    device rather than erroring). ``shard=False`` forces the
    single-device path (the bit-exactness reference)."""
    if devices is not None:
        devs = tuple(_device(d) for d in devices)
        if not devs:
            raise ValueError("devices must name at least one device")
    else:
        dev = _device(device)
        n = torch.cuda.device_count() if dev.type == "cuda" else 1
        devs = _shard_devices(dev, n)
    if shard is False or len(devs) <= 1 or n_lanes % len(devs):
        return devs[:1]
    return devs


def chunk_runner(cfg: SimConfig, unroll: int = DEFAULT_UNROLL,
                 device: Device = None) -> ChunkRunner:
    """The cached runner that sweeps of ``cfg`` at ``unroll`` use (on one
    device: the first lane shard's)."""
    return _runner(cfg, unroll, _device(device), 0)


def compile_count(cfg: SimConfig, unroll: int = DEFAULT_UNROLL,
                  device: Device = None, n_shards: int = 1) -> int:
    """Graphs captured by ``cfg``'s chunk runners of an ``n_shards``-way
    lane split on ``device``: one per lane width and shard, so a repeat
    sweep at the same geometry captures none (0 on the CPU)."""
    return sum(_runner(cfg, unroll, d, i).captures
               for i, d in enumerate(_shard_devices(device, n_shards)))


def reset_runners() -> None:
    """Drop the cached runners and their graphs (test isolation for
    capture counts)."""
    _runner.cache_clear()


class SweepResult(NamedTuple):
    stats: Stats            # numpy, every leaf with a leading (B,) axis
    hit_curve: np.ndarray   # (B, T) bool, False past each trace's length
    lengths: np.ndarray     # (B,)
    compiles: int           # graphs this sweep captured (0 = all cached)
    seconds: float          # this call's span (``perf_counter_ns``)

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


def _entry(fn):
    """A public sweep entry: its call runs inside ``spans.call`` (the
    outermost on a thread opens the record; ``runtime/spans.py``), and
    its result's ``seconds`` is the duration of that call's span."""
    @functools.wraps(fn)
    def entry(*args, **kwargs):
        with spans.call(fn.__name__) as call:
            out = fn(*args, **kwargs)
        if isinstance(out, StreamResult):
            return out._replace(
                result=out.result._replace(seconds=call.seconds))
        return out._replace(seconds=call.seconds)
    return entry


def _check_lengths(lengths, n: int, t_max: int) -> np.ndarray:
    lengths = (np.full((n,), t_max, np.int64) if lengths is None
               else np.asarray(lengths, np.int64))
    if lengths.shape != (n,) or (lengths > t_max).any() \
            or (lengths < 0).any():
        raise ValueError("lengths must be (B,) within [0, trace axis]")
    return lengths


@_entry
def sweep(cfg: SimConfig, blocks: np.ndarray,
          lengths: Optional[np.ndarray] = None,
          chunk: int = DEFAULT_CHUNK, unroll: int = DEFAULT_UNROLL,
          shard: Optional[bool] = None,
          device: Device = None,
          devices: Optional[Sequence[Device]] = None) -> SweepResult:
    """Run a (B, T) padded trace batch through one configuration.

    The offline special case of :func:`sweep_streaming`: every trace is
    submitted at step 0 on its own lane (``lane_width = B``), so the
    whole batch is admitted into the first slab and no lane recycles.
    ``lengths`` gives each trace's valid prefix (default: full T);
    requests past it are bit-exact no-ops excluded from all statistics.
    Results are bit-identical to running each trace through ``simulate``
    alone. ``unroll`` is the steps of one captured graph on the card;
    ``compiles`` counts the graphs this call captured. ``shard`` and
    ``devices``: the lane split (:func:`sweep_streaming`).
    """
    blocks = np.ascontiguousarray(np.asarray(blocks, np.int32))
    if blocks.ndim != 2:
        raise ValueError(f"blocks must be (B, T), got {blocks.shape}")
    n_traces, n_req = blocks.shape
    lengths = _check_lengths(lengths, n_traces, n_req)
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    res = sweep_streaming(cfg, blocks, lengths=lengths,
                          lane_width=n_traces, chunk=chunk, unroll=unroll,
                          shard=shard, device=device,
                          devices=devices).result
    return SweepResult(stats=res.stats, hit_curve=res.hit_curve,
                       lengths=lengths, compiles=res.compiles, seconds=0.0)


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
    corpora. Widths are multiples of ``n_shards`` so the lane axis
    splits evenly over the cards; chunks are halvings of the base
    chunk. ``lane_width``/``chunk`` are the widest group's shape (the
    primary slab).
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


def _width_candidates(w_max: int, n_shards: int = 1) -> Tuple[int, ...]:
    """Packer width ladder: ``w_max`` and its successive halvings, each
    rounded up to a multiple of ``n_shards`` (the divisibility contract
    applied to the lane axis), deduplicated, ascending."""
    cands = set()
    w = w_max
    while w >= 1:
        cands.add(-(-w // n_shards) * n_shards)
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
               n_shards: Optional[int] = None,
               max_shapes: int = DEFAULT_MAX_SHAPES,
               overhead_lanes: float = DEFAULT_PACK_OVERHEAD) -> SweepPlan:
    """Pack traces into lane groups with a cost-model packer (§9).

    Traces sort longest-first; groups are consecutive runs of that
    order, so a group's time axis pads to its FIRST member's length
    rounded up to the *group's* chunk. The packer chooses per-group
    ``(width, chunk)`` slab shapes from the candidate ladders — widths
    are ``lane_width`` (default ``min(n, DEFAULT_LANE_WIDTH)``) and its
    halvings rounded up to ``n_shards`` multiples; chunks are the base
    chunk and its halvings — to minimize total padded lane-steps plus
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

    ``n_shards=None`` reads the local card count (1 without a card);
    pass 1 to plan a single-device schedule. The effective base chunk
    is capped at the longest trace (padded up), so each group's loop
    reuses its shape's ``(chunk, width)`` slab.
    """
    lengths = np.asarray(lengths, np.int64)
    n = len(lengths)
    if n == 0:
        raise ValueError("plan_sweep needs at least one trace")
    if max_shapes < 1:
        raise ValueError("max_shapes must be >= 1")
    if n_shards is None:
        n_shards = max(1, torch.cuda.device_count())
    w_max = min(n, DEFAULT_LANE_WIDTH) if lane_width is None \
        else max(1, lane_width)
    w_max = -(-w_max // n_shards) * n_shards
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
             for w in reversed(_width_candidates(w_max, n_shards))
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
                     eff_chunk, n_shards,
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


@_entry
def sweep_scheduled(cfg: SimConfig,
                    traces: Union[Mapping[str, np.ndarray],
                                  Sequence[np.ndarray], PaddedSuite,
                                  np.ndarray],
                    lengths: Optional[np.ndarray] = None,
                    lane_width: Optional[int] = None,
                    chunk: int = DEFAULT_CHUNK,
                    plan: Optional[SweepPlan] = None,
                    shard: Optional[bool] = None,
                    device: Device = None,
                    devices: Optional[Sequence[Device]] = None
                    ) -> SweepResult:
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
    ``compiles`` sums the groups' captures. ``shard`` and ``devices``:
    each group's lane split (:func:`sweep_streaming`).
    """
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
        with spans.span("sweep.plan"):
            plan = wide_plan(lengths, lane_width, chunk)

    stats_out = None
    hit = np.zeros((n, t_max), bool)
    compiles = 0
    for g in plan.groups:
        with spans.span("sweep.pad"):
            gb = np.zeros((g.lane_width, g.padded_t), np.int32)
            gl = np.zeros((g.lane_width,), np.int64)
            for j, idx in enumerate(g.indices):
                ln = int(lengths[idx])
                gb[j, :ln] = blocks[idx, :ln]
                gl[j] = ln
        res = sweep(cfg, gb, gl, chunk=g.chunk, shard=shard, device=dev,
                    devices=devices)
        compiles += res.compiles
        with spans.span("sweep.reassemble"):
            if stats_out is None:
                stats_out = [np.zeros((n,) + leaf.shape[1:], leaf.dtype)
                             for leaf in res.stats]
            for j, idx in enumerate(g.indices):
                ln = int(lengths[idx])
                hit[idx, :ln] = res.hit_curve[j, :ln]
                for leaf_out, leaf in zip(stats_out, res.stats):
                    leaf_out[idx] = leaf[j]

    return SweepResult(stats=Stats(*stats_out), hit_curve=hit,
                       lengths=lengths, compiles=compiles, seconds=0.0)


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


# ---------------------------------------------------------------------------
# Streaming ingestion engine: ring-buffered slabs, lane recycling
# ---------------------------------------------------------------------------

DEFAULT_RING_DEPTH = 4      # slabs the producer stages ahead of the device


class _Tenant:
    """Host-side bookkeeping for one submitted trace.

    ``avail`` (optional, same length as the trace) gives each request's
    arrival step on the engine's virtual clock, nondecreasing; ``None``
    means the whole trace is available at step 0 (the offline case).
    ``cursor`` is the next unplaced request — the ONLY progress state,
    and it is host-known, which is what lets the scheduler run ahead of
    the device (see :class:`RingBuffer`).
    """

    __slots__ = ("index", "blocks", "avail", "length", "cursor")

    def __init__(self, index: int, blocks: np.ndarray,
                 avail: Optional[np.ndarray], length: int):
        self.index = index
        self.blocks = blocks
        self.avail = avail
        self.length = length
        self.cursor = 0


class _Staging(NamedTuple):
    """Host arrays of one slab (blocks, valid, the admission mask, hits)
    and the tensors that share their memory: pinned on the card's async
    path, where a pool recycles them."""
    blocks: np.ndarray                  # (chunk, W) int32
    valid: np.ndarray                   # (chunk, W) bool
    reset: np.ndarray                   # (W,) bool
    hits: np.ndarray                    # (chunk, W) bool
    tensors: Tuple[torch.Tensor, ...]   # the four, as tensors


def _staging(chunk: int, lanes: int, pinned: bool) -> _Staging:
    ts = tuple(torch.zeros(shape, dtype=dtype, pin_memory=pinned)
               for shape, dtype in (((chunk, lanes), torch.int32),
                                    ((chunk, lanes), torch.bool),
                                    ((lanes,), torch.bool),
                                    ((chunk, lanes), torch.bool)))
    return _Staging(*(t.numpy() for t in ts), ts)


class _Slab(NamedTuple):
    """One staged ``(chunk, W)`` request slab plus its host-side routing.

    ``placements`` maps device outputs back to traces: for each lane
    that placed requests, ``(lane, tenant, cursor0, row0, k, positions)``
    says requests ``cursor0 .. cursor0+k-1`` of ``tenant`` sit at slab
    rows ``row0 .. row0+k-1`` when ``positions`` is ``None`` (the
    contiguous fast path — offline traces always, arrival traces
    whenever the placed run has no interior gap), else at
    ``positions[0..k-1]``. ``harvest`` lists ``(tenant, lane)`` pairs
    that drain once this slab runs — the consumer copies those lanes'
    statistics on the device before the next slab changes the carry in
    place. ``live`` says which rows hold a valid lane (the others are
    not run; one mask per lane shard). ``buffers`` holds the host
    staging so the async drain can recycle it into the producer's
    pool, and ``ready`` is the event of
    its upload on the card (``None`` on the synchronous path, where
    staging is throwaway, and on the CPU).
    """

    blocks: torch.Tensor                    # (chunk, W) int32, staged
    valid: torch.Tensor                     # (chunk, W) bool, staged
    reset: Optional[torch.Tensor]           # (W,) bool; None = no admission
    live: Tuple[np.ndarray, ...]            # per lane shard: (chunk,) bool
    placements: Tuple[Tuple[int, int, int, int, int,
                            Optional[np.ndarray]], ...]
    harvest: Tuple[Tuple[int, int], ...]
    buffers: Optional[_Staging] = None
    ready: Optional["torch.cuda.Event"] = None


class RingBuffer:
    """Thread-safe bounded FIFO ring of staged request slabs.

    The producer (the host scheduler, its own thread under
    ``async_producer=True``) stages up to ``depth`` slabs ahead of the
    consumer (the chunk runner): host marshalling and H2D staging of
    slabs k+1..k+depth overlap slab k's compute. Admission and placement
    depend only on host-known cursors — never on device results — which
    is what makes the produce-ahead legal; the depth bounds in-flight
    device memory at ``depth * chunk * W`` request slots.

    ``push``/``pop`` default to the non-blocking semantics the
    synchronous engine uses (full push / empty pop raise a clear
    ``RuntimeError``); ``block=True`` waits on a condition variable
    instead and counts each wait in the stall telemetry: a producer
    that blocked on a full ring bumps ``push_stalls`` (device is the
    bottleneck), a consumer that blocked on an empty ring bumps
    ``pop_stalls`` (host marshalling is the bottleneck). The time
    blocked is the span ``stream.ring_full`` (push) or
    ``stream.ring_wait`` (pop) of the current sweep record. ``close()``
    wakes every waiter; a blocking pop on a closed, drained ring
    returns ``None`` (end of stream).
    """

    def __init__(self, depth: int = DEFAULT_RING_DEPTH):
        if isinstance(depth, bool) or not isinstance(
                depth, (int, np.integer)) or depth < 1:
            raise ValueError(f"ring depth must be an int >= 1, "
                             f"got {depth!r}")
        self.depth = int(depth)
        self._q: collections.deque = collections.deque()
        self._cv = threading.Condition()
        self._closed = False
        self.push_stalls = 0    # producer waited on a full ring
        self.pop_stalls = 0     # consumer waited on an empty ring

    def __len__(self) -> int:
        return len(self._q)

    @property
    def full(self) -> bool:
        return len(self._q) >= self.depth

    @property
    def empty(self) -> bool:
        return not self._q

    @property
    def closed(self) -> bool:
        return self._closed

    def close(self) -> None:
        """End of stream: wake all waiters; further pushes are errors."""
        with self._cv:
            self._closed = True
            self._cv.notify_all()

    def push(self, slab: _Slab, block: bool = False) -> None:
        with self._cv:
            if len(self._q) >= self.depth:
                if not block:
                    raise RuntimeError(
                        "ring buffer full — pop before pushing")
                self.push_stalls += 1
                with spans.span("stream.ring_full"):
                    while len(self._q) >= self.depth and not self._closed:
                        self._cv.wait()
            if self._closed:
                raise RuntimeError("ring buffer closed")
            self._q.append(slab)
            self._cv.notify_all()

    def pop(self, block: bool = False) -> Optional[_Slab]:
        with self._cv:
            if not self._q:
                if not block:
                    raise RuntimeError(
                        "ring buffer empty — push (produce) before popping")
                if not self._closed:
                    self.pop_stalls += 1
                    with spans.span("stream.ring_wait"):
                        while not self._q and not self._closed:
                            self._cv.wait()
            if not self._q:
                return None         # closed and fully drained
            slab = self._q.popleft()
            self._cv.notify_all()
            return slab


class StreamResult(NamedTuple):
    """Streaming-engine result plus schedule telemetry.

    ``result`` carries per-trace statistics in SUBMISSION order — the
    same :class:`SweepResult` type the offline engines return, and per
    trace bit-identical to them (lane assignment, slab chunking and
    arrival gaps are all invisible under the masking contract).
    ``lane_steps`` is the executed (lane x request) slot count — the
    recycling analogue of ``SweepPlan.padded_lane_steps``, counted as
    the reference counts it (rows with no valid lane, which the runner
    skips, included).

    ``pipeline`` carries the producer-pipeline telemetry: stage-busy
    seconds (``produce_s`` host marshalling + H2D staging,
    ``consume_s`` reset + chunk-runner dispatch, ``drain_s`` D2H
    copy + hit-curve scatter), the loop wall clock ``wall_s``, the
    ring-buffer stall counters (``producer_stalls`` = producer blocked
    on a full ring, ``consumer_stalls`` = consumer blocked on an empty
    ring) and ``overlap`` = ``1 - wall / sum of stage-busy`` clipped to
    [0, 1] — 0 when the stages serialize, approaching ``1 - 1/n_stages``
    when they fully overlap. Timings and stalls are scheduling noise;
    every other ``streaming_stats`` key is deterministic.
    """

    result: SweepResult
    lane_width: int
    chunk: int
    n_slabs: int
    async_producer: bool = True
    pipeline: Optional[Dict[str, object]] = None

    @property
    def lane_steps(self) -> int:
        return self.n_slabs * self.chunk * self.lane_width

    def streaming_stats(self) -> Dict[str, object]:
        """Schedule-efficiency summary, as the reference records it."""
        total = int(np.asarray(self.result.lengths).sum())
        steps = self.lane_steps
        stats: Dict[str, object] = {
            "lane_width": self.lane_width,
            "chunk": self.chunk,
            "n_slabs": self.n_slabs,
            "lane_steps": int(steps),
            "ideal_lane_steps": total,
            "waste_ratio": round(1.0 - total / steps, 6) if steps else 0.0,
            "async_producer": bool(self.async_producer),
        }
        if self.pipeline is not None:
            stats["pipeline"] = dict(self.pipeline)
        return stats


def _on(dev: torch.device):
    """The context that makes ``dev`` current in a thread."""
    return (torch.cuda.device(dev) if dev.type == "cuda"
            else contextlib.nullcontext())


@_entry
def sweep_streaming(cfg: SimConfig,
                    traces: Union[Mapping[str, np.ndarray],
                                  Sequence[np.ndarray], PaddedSuite,
                                  np.ndarray],
                    lengths: Optional[np.ndarray] = None,
                    arrivals: Optional[Sequence[np.ndarray]] = None,
                    lane_width: Optional[int] = None,
                    chunk: int = DEFAULT_CHUNK,
                    unroll: int = DEFAULT_UNROLL,
                    shard: Optional[bool] = None,
                    ring_depth: int = DEFAULT_RING_DEPTH,
                    async_producer: bool = True,
                    device: Device = None,
                    devices: Optional[Sequence[Device]] = None
                    ) -> StreamResult:
    """Online ingestion: arrival is the primitive, traces stream through
    a recycled lane pool.

    The engine keeps ``lane_width`` device lanes and a virtual step
    clock that advances one ``chunk`` per slab. A host scheduler admits
    queued traces (FIFO) into idle lanes at slab boundaries, places each
    admitted trace's arrived requests into its lane's slab column
    (arrival gaps become ``valid=False`` no-op rows), and RECYCLES a
    lane the moment its trace drains — the next queued trace is admitted
    mid-run after an in-place masked reset (:func:`_masked_reset`)
    instead of the engine scanning padded tails. Slabs stage through a
    :class:`RingBuffer` ``ring_depth`` ahead of the device and run
    through the chunk runner (``unroll`` steps a captured graph on the
    card). ``shard`` (None/True: split the lanes over the cards, or over
    ``devices``, when the width divides; False: one device) runs each
    contiguous block of lanes through a runner of its own on its device;
    slabs stage on the first device and each shard takes its columns.

    ``arrivals`` gives per-trace nondecreasing request arrival steps
    (``None`` = everything at step 0); when every trace arrives at 0 and
    ``lane_width`` covers the batch this degrades exactly to
    :func:`sweep`, which is implemented on top of this engine.
    Statistics and hit curves are bit-identical to the offline engines
    per trace: lanes are independent, invalid slots are bit-exact
    no-ops, and the mining barrier masks per-lane ``need``.

    ``async_producer=True`` (the default) runs the host scheduler on a
    background thread: on the card it marshals slabs into a recycled pool
    of pinned host buffers and uploads them with non-blocking copies on a
    copy stream, whose event the consumer's stream waits on; a drain
    thread copies each slab's hits back into pinned buffers after an
    event of the consumer's and scatters them into the hit curve. A
    buffer returns to the pool only after its events have completed.
    Production order depends only on host-known cursors, so the async
    pipeline is bit-identical to the synchronous path
    (``async_producer=False``: fill the ring, run one slab, bring every
    hit back at the end, with throwaway staging). Stage timings, ring
    stall counters and the overlap ratio surface in
    :meth:`StreamResult.streaming_stats` under ``"pipeline"``; the stage
    timings are this call's totals of the record's ``stream.produce``,
    ``stream.consume`` and ``stream.drain`` spans (``runtime/spans.py``).
    """
    rec = spans.current()
    if isinstance(async_producer, np.bool_):
        async_producer = bool(async_producer)
    if not isinstance(async_producer, bool):
        raise ValueError(f"async_producer must be a bool, "
                         f"got {async_producer!r}")
    if isinstance(ring_depth, bool) or not isinstance(
            ring_depth, (int, np.integer)) or ring_depth < 1:
        raise ValueError(f"ring_depth must be an int >= 1, "
                         f"got {ring_depth!r}")
    ring_depth = int(ring_depth)
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

    avails: List[Optional[np.ndarray]] = [None] * n
    if arrivals is not None:
        if len(arrivals) != n:
            raise ValueError(f"arrivals must give one array per trace "
                             f"({n}), got {len(arrivals)}")
        for i, a in enumerate(arrivals):
            if a is None:
                continue
            a = np.asarray(a, np.int64)
            if a.shape != (int(lengths[i]),):
                raise ValueError(f"arrivals[{i}] must have shape "
                                 f"({int(lengths[i])},), got {a.shape}")
            if a.size and ((np.diff(a) < 0).any() or a[0] < 0):
                raise ValueError(f"arrivals[{i}] must be nondecreasing "
                                 "and nonnegative")
            avails[i] = a

    w = min(n, DEFAULT_LANE_WIDTH) if lane_width is None \
        else max(1, int(lane_width))
    shard_devs = _lane_shards(w, shard, device, devices)
    dev = shard_devs[0]
    per = w // len(shard_devs)
    cols = [slice(i * per, (i + 1) * per) for i in range(len(shard_devs))]
    chunk = max(1, min(int(chunk), max(1, t_max)))
    tenants = [_Tenant(i, blocks[i], avails[i], int(lengths[i]))
               for i in range(n)]

    stage_names = ("stream.produce", "stream.consume", "stream.drain")
    stage_s0 = [rec.total_s(k) for k in stage_names]
    launches0 = ops.launch_counts()
    with spans.span("stream.setup"):
        runners = [_runner(cfg, unroll, d, i)
                   for i, d in enumerate(shard_devs)]
        before = sum(r.captures for r in runners)
        templates = [r.init_batched(per) for r in runners]
        # on the card: captured at first use
        carries = [r.carry(per) for r in runners]
        for c, t in zip(carries, templates):
            _assign(c, t)

    def lane_stats(parts) -> List[torch.Tensor]:
        """Every lane's stats leaves and, last, its mining runs
        (``n_mines``; zeros without MITHRIL): copies, the shards' joined
        on the first device."""
        leaves = [list(p["stats"]) + [p["mith"].n_mines if "mith" in p
                                      else torch.zeros_like(p["stats"][0])]
                  for p in parts]
        if len(parts) == 1:
            return [leaf.clone() for leaf in leaves[0]]
        return [torch.cat([p[j].to(dev) for p in leaves])
                for j in range(len(leaves[0]))]

    queue: collections.deque = collections.deque(range(n))
    lanes: List[Optional[int]] = [None] * w
    clock = 0
    # tenant -> (index into ``snaps``, or -1 for the template; lane)
    stash: List[Optional[Tuple[int, int]]] = [None] * n
    snaps: List[List[torch.Tensor]] = []

    # --- staging: how host slab arrays become device tensors -----------
    # Sync keeps throwaway arrays and blocking uploads. Async marshals
    # into a recycled pool of staging buffers: on the card pinned, each
    # slab uploaded on the copy stream with non-blocking copies and an
    # event the consumer waits on; on the CPU the tensors share the
    # arrays' memory, safe because a buffer returns to the pool only
    # after the drain, when its slab has run.
    pinned = async_producer and dev.type == "cuda"
    if async_producer:
        pool: _queue_mod.Queue = _queue_mod.Queue()
        with spans.span("stream.setup"):
            for _ in range(ring_depth + 3):
                pool.put(_staging(chunk, w, pinned))

        def alloc() -> _Staging:
            buf = pool.get()
            buf.blocks.fill(0)
            buf.valid.fill(False)
            return buf
    else:
        def alloc() -> _Staging:
            return _staging(chunk, w, False)

    if pinned:
        copy_stream = torch.cuda.Stream(dev)
        drain_stream = torch.cuda.Stream(dev)

        def stage(buf: _Staging, admit: bool):
            with torch.cuda.stream(copy_stream):
                tb, tv, tr, _ = buf.tensors
                out = (tb.to(dev, non_blocking=True),
                       tv.to(dev, non_blocking=True),
                       tr.to(dev, non_blocking=True) if admit else None)
                ready = torch.cuda.Event()
                ready.record(copy_stream)
            return out + (ready,)
    else:
        def stage(buf: _Staging, admit: bool):
            tb, tv, tr, _ = buf.tensors
            return (tb.to(dev), tv.to(dev), tr.to(dev) if admit else None,
                    None)

    def produce() -> Optional[_Slab]:
        """The next slab, or None once every trace is placed; each slab
        is a ``stream.produce`` span."""
        with spans.span("stream.produce") as sp:
            slab = next_slab()
            if slab is None:
                sp.drop()
        return slab

    def next_slab() -> Optional[_Slab]:
        nonlocal clock
        while True:
            t_start = clock
            reset = np.zeros((w,), bool)
            for lane in range(w):
                if lanes[lane] is not None:
                    continue
                # zero-length submissions drain at admission: init stats,
                # no lane occupied (bit-identical to an all-masked lane)
                while queue and tenants[queue[0]].length == 0:
                    stash[queue.popleft()] = (-1, 0)
                if not queue:
                    break
                head = tenants[queue[0]]
                first = 0 if head.avail is None \
                    else int(head.avail[head.cursor])
                if first < t_start + chunk:
                    queue.popleft()
                    lanes[lane] = head.index
                    reset[lane] = True
                else:
                    break       # FIFO: a not-yet-arrived head blocks
            if any(la is not None for la in lanes):
                break
            if not queue:
                return None     # fully drained
            # every lane idle, nothing arrived yet: fast-forward the
            # clock to the slab containing the head's first arrival
            head = tenants[queue[0]]
            clock = (int(head.avail[head.cursor]) // chunk) * chunk
        buf = alloc()
        slab_blocks, slab_valid = buf.blocks, buf.valid
        placements, harvest = [], []
        for lane, ti in enumerate(lanes):
            if ti is None:
                continue
            t = tenants[ti]
            cap = min(t.length - t.cursor, chunk)
            if t.avail is None:
                # offline lanes always place a gapless run from row 0:
                # contiguous slice writes, no index vectors built
                row0, k, pos = 0, cap, None
            else:
                # request k lands at slab row k + the running max of its
                # arrival slack: in-order placement, one row per request,
                # never before arrival — gaps stay valid=False no-ops
                slack = (t.avail[t.cursor: t.cursor + cap] - t_start
                         - np.arange(cap))
                p = np.arange(cap) + np.maximum(
                    np.maximum.accumulate(slack, axis=0)
                    if cap else slack, 0)
                p = p[p < chunk]
                k = len(p)
                if k and int(p[-1]) - int(p[0]) + 1 == k:
                    # no interior gap: same contiguous fast path
                    row0, pos = int(p[0]), None
                else:
                    row0, pos = 0, p
            if k:
                if pos is None:
                    slab_blocks[row0: row0 + k, lane] = \
                        t.blocks[t.cursor: t.cursor + k]
                    slab_valid[row0: row0 + k, lane] = True
                else:
                    slab_blocks[pos, lane] = t.blocks[t.cursor: t.cursor + k]
                    slab_valid[pos, lane] = True
                placements.append((lane, ti, t.cursor, row0, k, pos))
                t.cursor += k
            if t.cursor == t.length:
                harvest.append((ti, lane))
                lanes[lane] = None      # recycled at the next admission
        clock = t_start + chunk
        admit = bool(reset.any())
        buf.reset[:] = reset
        with spans.span("stream.stage"):
            dev_blocks, dev_valid, dev_reset, ready = stage(buf, admit)
        live = tuple(slab_valid[:, sp].any(1) for sp in cols)
        return _Slab(dev_blocks, dev_valid, dev_reset, live,
                     tuple(placements), tuple(harvest),
                     buf if async_producer else None, ready)

    hit_curve = np.zeros((n, t_max), bool)

    def scatter_hits(h: np.ndarray, placements) -> None:
        for lane, ti, c0, row0, k, pos in placements:
            if pos is None:
                hit_curve[ti, c0: c0 + k] = h[row0: row0 + k, lane]
            else:
                hit_curve[ti, c0: c0 + k] = h[pos, lane]

    ring = RingBuffer(ring_depth)
    n_slabs, first_slab = 0, True
    current = torch.cuda.current_stream(dev) if dev.type == "cuda" else None

    @spans.within("stream.consume")
    def consume(slab: _Slab) -> torch.Tensor:
        """Reset admitted lanes, run the slab, copy drained lanes' stats;
        returns the slab's hits on the device."""
        nonlocal first_slab, n_slabs
        if slab.ready is not None:
            current.wait_event(slab.ready)
            for t in (slab.blocks, slab.valid, slab.reset):
                if t is not None:
                    t.record_stream(current)
        # slab 0 skips the reset outright: the carry IS the template
        if slab.reset is not None and not first_slab:
            with spans.span("stream.reset"), spans.device("lane_work", dev):
                for c, t, sp, d in zip(carries, templates, cols, shard_devs):
                    _masked_reset(c, t, slab.reset[sp].to(d))
        first_slab = False
        with spans.span("runner.run"):
            hits = [r.run(c, slab.blocks[:, sp].to(d),
                          slab.valid[:, sp].to(d), live)
                    for r, c, sp, d, live in zip(runners, carries, cols,
                                                 shard_devs, slab.live)]
            hits = hits[0] if len(hits) == 1 else torch.cat(
                [h.to(dev) for h in hits], 1)
        if slab.harvest:
            # the carry changes in place: copy the stats of the lanes
            # that drained before the next slab runs
            with spans.span("stream.harvest"), \
                    spans.device("lane_work", dev):
                snaps.append(lane_stats(carries))
            for ti, lane in slab.harvest:
                stash[ti] = (len(snaps) - 1, lane)
        n_slabs += 1
        return hits

    t_wall = time.perf_counter()
    if async_producer:
        # three-stage pipeline: the producer thread marshals + stages,
        # the calling thread runs the slabs in ring order (the order the
        # sync loop runs them — bit-identity is by construction), a drain
        # thread brings each slab's hit rows back and recycles its
        # staging buffers
        prod_err: List[BaseException] = []
        drain_err: List[BaseException] = []
        drain_q: _queue_mod.Queue = _queue_mod.Queue(maxsize=ring_depth + 2)

        def producer_main():
            try:
                with _on(dev), spans.attach(rec):
                    while True:
                        slab = produce()
                        if slab is None:
                            break
                        ring.push(slab, block=True)
            except BaseException as e:  # noqa: BLE001 — surfaced below
                prod_err.append(e)
            finally:
                ring.close()

        def fetch(hits: torch.Tensor, done, buf: _Staging) -> np.ndarray:
            """The slab's hits on the host: on the card copied into the
            pinned buffer on the drain stream, after ``done``."""
            if done is None:
                return hits.numpy()
            with torch.cuda.stream(drain_stream):
                drain_stream.wait_event(done)
                buf.tensors[3].copy_(hits, non_blocking=True)
                hits.record_stream(drain_stream)
                copied = torch.cuda.Event()
                copied.record(drain_stream)
            with spans.span("stream.drain_wait"):
                copied.synchronize()
            return buf.hits

        @spans.within("stream.drain")
        def drain_one(hits, done, slab) -> None:
            try:
                if not drain_err:
                    h = fetch(hits, done, slab.buffers)
                    with spans.span("stream.scatter"):
                        scatter_hits(h, slab.placements)
            except BaseException as e:  # noqa: BLE001
                drain_err.append(e)     # keep draining: never
            finally:                    # block the consumer
                if done is not None:
                    with spans.span("stream.drain_wait"):
                        done.synchronize()
                        slab.ready.synchronize()
                pool.put(slab.buffers)

        def drain_main():
            with _on(dev), spans.attach(rec):
                while True:
                    item = drain_q.get()
                    if item is None:
                        return
                    drain_one(*item)

        producer = threading.Thread(target=producer_main, daemon=True,
                                    name="sweep-producer")
        drainer = threading.Thread(target=drain_main, daemon=True,
                                   name="sweep-drain")
        producer.start()
        drainer.start()
        try:
            while True:
                slab = ring.pop(block=True)
                if slab is None:
                    break
                hits = consume(slab)
                done = None
                if pinned:
                    done = torch.cuda.Event()
                    done.record(current)
                drain_q.put((hits, done, slab))
        finally:
            with spans.span("stream.join"):
                ring.close()    # unblocks a producer stuck mid-push
                drain_q.put(None)
                drainer.join()
                producer.join()
        if prod_err:
            raise prod_err[0]
        if drain_err:
            raise drain_err[0]
    else:
        # synchronous path: fill the ring, run one slab, bring every hit
        # record back at the end
        hit_records: List[Tuple[torch.Tensor, Tuple]] = []
        producing = True
        while True:
            while producing and not ring.full:
                slab = produce()
                if slab is None:
                    producing = False
                    break
                ring.push(slab)
            if ring.empty:
                break
            slab = ring.pop()
            hit_records.append((consume(slab), slab.placements))

        with spans.span("stream.drain"):
            for hits, placements in hit_records:
                with spans.span("stream.drain_wait"):
                    h = hits.cpu().numpy()
                with spans.span("stream.scatter"):
                    scatter_hits(h, placements)
    wall_s = time.perf_counter() - t_wall
    with spans.span("stream.collect"):
        mat: Dict[int, List[np.ndarray]] = {}
        rows = []
        mines = 0       # a zero-length trace (the template) mined nothing
        for ti in range(n):
            k, lane = stash[ti]
            if k not in mat:
                src = lane_stats(templates) if k < 0 else snaps[k]
                mat[k] = [leaf.cpu().numpy() for leaf in src]
            rows.append([leaf[lane] for leaf in mat[k]])
            mines += int(mat[k][-1][lane]) if k >= 0 else 0
        stats = Stats(*(np.stack([r[j] for r in rows])
                        for j in range(len(Stats._fields))))
    spans.count("mining.runs", mines)
    launched = ops.launch_counts()
    for counter, kernel in (("mining.launches", "mithril_mine_step"),
                            ("cache.access_launches", "cache_access"),
                            ("cache.prefetch_launches", "mithril_prefetch")):
        spans.count(counter, launched[kernel] - launches0[kernel])

    produce_s, consume_s, drain_s = (rec.total_s(k) - t for k, t in
                                     zip(stage_names, stage_s0))
    busy = produce_s + consume_s + drain_s
    pipeline = {
        "produce_s": round(produce_s, 4),
        "consume_s": round(consume_s, 4),
        "drain_s": round(drain_s, 4),
        "wall_s": round(wall_s, 4),
        "producer_stalls": int(ring.push_stalls),
        "consumer_stalls": int(ring.pop_stalls),
        "overlap": round(max(0.0, 1.0 - wall_s / busy), 4) if busy else 0.0,
    }
    result = SweepResult(stats=stats, hit_curve=hit_curve, lengths=lengths,
                         compiles=sum(r.captures for r in runners) - before,
                         seconds=0.0)
    return StreamResult(result=result, lane_width=w, chunk=chunk,
                        n_slabs=n_slabs, async_producer=async_producer,
                        pipeline=pipeline)
