"""Online adaptation of MITHRIL parameters over the batched sweep.

Counterpart of ``repro/learn/adapt.py``, the same searches, decisions
and commit guard. Fig 7 sweeps ``(lookahead, min_support,
prefetch_list)`` offline; this module turns the same axis into an
*online* per-trace search: episodes re-run growing trace prefixes under
candidate configurations through the batched sweep engine
(``cache/sweep.sweep`` on ``device``: on the card every episode for a
config replays the one CUDA graph its cached chunk runner captured at
the batch's lane width, ``sweep._runner``), then commit the winner per
trace and score it on the full trace. The search itself is host logic
over the sweeps' hit ratios, which are float64 ratios of int32
counters, so its decisions are the reference's bit for bit.

Two searchers share the episode protocol:

* :func:`hill_climb` — per-trace coordinate descent on the grid:
  each episode evaluates the current arm and its axis neighbours on the
  episode prefix and moves only on a strict improvement (ties keep the
  current arm — deterministic).
* :func:`bandit` — per-trace epsilon-greedy over all grid arms with a
  fixed-seed decision tensor drawn up front (``numpy.random
  .default_rng(seed)``), so a run's decision history is reproducible
  bit for bit across processes; commitment re-scores each trace's
  ``top_k`` arms (by mean episode reward) on the full trace.

Both searchers end with the same commit guard: a winning arm must
strictly beat the incumbent static configuration on the full observed
trace, else the trace keeps the static config (arm ``-1``) — so the
committed per-trace hit ratio is never below the static baseline.

Determinism contract (``tests/test_torch_adapt.py``): with zero episodes both
searchers reduce to the static configuration — the returned full-trace
result is the very same ``sweep`` call a static run performs, bit for
bit — and no searcher ever selects an arm outside the declared
:class:`SearchGrid`.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np

from ..cache.simulator import SimConfig
from ..cache.sweep import SweepResult, _device, sweep

DEFAULT_CHUNK = 256


@dataclasses.dataclass(frozen=True)
class SearchGrid:
    """The declared (lookahead, min_support, prefetch_list) search space.

    ``pf_sizes`` is the paper's P (prefetch-list length). Values must
    satisfy the :class:`~repro_torch.core.MithrilConfig` invariants against
    the base config (``min_support <= max_support``), checked when an
    arm is materialized.
    """
    lookaheads: Tuple[int, ...] = (25, 100, 400)
    min_supports: Tuple[int, ...] = (2, 4, 6)
    pf_sizes: Tuple[int, ...] = (1, 2, 4)

    @property
    def shape(self) -> Tuple[int, int, int]:
        return (len(self.lookaheads), len(self.min_supports),
                len(self.pf_sizes))

    @property
    def n_arms(self) -> int:
        return len(self.lookaheads) * len(self.min_supports) * len(self.pf_sizes)

    def arm_values(self, arm: int) -> Tuple[int, int, int]:
        nl, nr, np_ = self.shape
        i, rest = divmod(arm, nr * np_)
        j, k = divmod(rest, np_)
        return (self.lookaheads[i], self.min_supports[j], self.pf_sizes[k])

    def arm_index(self, i: int, j: int, k: int) -> int:
        nl, nr, np_ = self.shape
        return (i * nr + j) * np_ + k

    def config(self, base: SimConfig, arm: int) -> SimConfig:
        la, r, p = self.arm_values(arm)
        return dataclasses.replace(
            base, mithril=dataclasses.replace(
                base.mithril, lookahead=la, min_support=r, prefetch_list=p))

    def configs(self, base: SimConfig) -> Dict[int, SimConfig]:
        return {a: self.config(base, a) for a in range(self.n_arms)}

    def contains(self, base: SimConfig, cfg: SimConfig) -> bool:
        return any(cfg == self.config(base, a) for a in range(self.n_arms))

    def nearest_arm(self, base: SimConfig) -> int:
        """Grid arm closest to the static config (per-axis, ties low)."""
        def closest(values, target):
            return min(range(len(values)),
                       key=lambda ix: (abs(values[ix] - target), ix))
        return self.arm_index(
            closest(self.lookaheads, base.mithril.lookahead),
            closest(self.min_supports, base.mithril.min_support),
            closest(self.pf_sizes, base.mithril.prefetch_list))


class AdaptResult(NamedTuple):
    arms: Tuple[int, ...]          # committed grid arm per trace (-1 = static)
    labels: Tuple[str, ...]        # committed (lookahead,R,P) label per trace
    hit_ratios: np.ndarray         # (B,) full-trace HR under the committed arm
    base_hit_ratios: np.ndarray    # (B,) full-trace HR under the static config
    base_result: SweepResult       # the full static sweep (zero-episode identity)
    history: Tuple                 # ((episode, prefix, trace, arm, reward), ...)
    episodes: int
    compiles: int                  # graphs captured across every episode
                                   # and the commit (0 on the CPU)
    sweeps: int = 0                # distinct (config, prefix) sweeps run


def arm_label(grid: SearchGrid, arm: int) -> str:
    la, r, p = grid.arm_values(arm)
    return f"la={la},r={r},p={p}"


class _Evaluator:
    """Prefix-sweep evaluator with (config, prefix) memoization.

    Each distinct config captures at most one graph on the card (its
    runner's, at lane width B); every later episode (any prefix) replays
    it — the prefix only changes the replay *count*. ``compiles``
    accumulates the captures the sweeps reported so callers can assert
    the reuse.
    """

    def __init__(self, blocks: np.ndarray, lengths: np.ndarray, chunk: int,
                 device=None):
        self.blocks = np.ascontiguousarray(np.asarray(blocks, np.int32))
        self.lengths = np.asarray(lengths, np.int64)
        self.chunk = int(chunk)
        self.device = _device(device)
        self.t_full = self.blocks.shape[1]
        self.memo: Dict[tuple, SweepResult] = {}
        self.compiles = 0

    def result(self, cfg: SimConfig, prefix: int) -> SweepResult:
        prefix = int(min(max(prefix, 1), self.t_full))
        t_pad = min(self.t_full,
                    int(math.ceil(prefix / self.chunk)) * self.chunk)
        key = (cfg, prefix)
        if key not in self.memo:
            res = sweep(cfg, self.blocks[:, :t_pad],
                        lengths=np.minimum(self.lengths, prefix),
                        chunk=self.chunk, shard=False, device=self.device)
            self.compiles += res.compiles
            self.memo[key] = res
        return self.memo[key]

    def hit_ratios(self, cfg: SimConfig, prefix: int) -> np.ndarray:
        return self.result(cfg, prefix).hit_ratios()


def _prefixes(fracs, t_full: int, chunk: int):
    return [min(t_full, max(chunk, int(round(f * t_full)))) for f in fracs]


def _finalize(base_cfg, grid, ev, committed, history, episodes):
    base_res = ev.result(base_cfg, ev.t_full)
    base_hr = base_res.hit_ratios()
    # commit guard: a candidate arm must strictly beat the incumbent
    # static config on the full observed trace or the trace keeps the
    # static config — adaptation never deploys a config that lost its
    # own validation (ties keep the incumbent, deterministically)
    committed = [
        arm if arm >= 0
        and float(ev.hit_ratios(grid.config(base_cfg, arm),
                                ev.t_full)[t]) > float(base_hr[t])
        else -1
        for t, arm in enumerate(committed)]
    hit = np.array([
        (base_hr[t] if arm < 0
         else ev.hit_ratios(grid.config(base_cfg, arm), ev.t_full)[t])
        for t, arm in enumerate(committed)])
    labels = tuple("static" if a < 0 else arm_label(grid, a)
                   for a in committed)
    return AdaptResult(arms=tuple(int(a) for a in committed), labels=labels,
                       hit_ratios=hit, base_hit_ratios=base_hr,
                       base_result=base_res, history=tuple(history),
                       episodes=episodes, compiles=ev.compiles,
                       sweeps=len(ev.memo))


def hill_climb(base_cfg: SimConfig, blocks: np.ndarray, lengths: np.ndarray,
               grid: Optional[SearchGrid] = None, *,
               prefix_fracs: Tuple[float, ...] = (0.25, 0.5, 1.0),
               chunk: int = DEFAULT_CHUNK, device=None) -> AdaptResult:
    """Per-trace coordinate descent on the grid (see module docstring).

    ``prefix_fracs=()`` disables adaptation: every trace commits the
    static config and the result is the static sweep, bit-identically.
    Sweeps run on ``device`` (None: the card).
    """
    grid = grid or SearchGrid()
    ev = _Evaluator(blocks, lengths, chunk, device)
    n = ev.blocks.shape[0]
    if not prefix_fracs:
        return _finalize(base_cfg, grid, ev, [-1] * n, [], 0)

    nl, nr, np_ = grid.shape
    pos = [list(np.unravel_index(grid.nearest_arm(base_cfg), grid.shape))
           for _ in range(n)]
    history = []
    for e, prefix in enumerate(_prefixes(prefix_fracs, ev.t_full, chunk)):
        # candidate arms per trace: current + one step along each axis
        cand_per_trace = []
        for t in range(n):
            i, j, k = pos[t]
            cands = {grid.arm_index(i, j, k)}
            for di in (-1, 1):
                if 0 <= i + di < nl:
                    cands.add(grid.arm_index(i + di, j, k))
                if 0 <= j + di < nr:
                    cands.add(grid.arm_index(i, j + di, k))
                if 0 <= k + di < np_:
                    cands.add(grid.arm_index(i, j, k + di))
            cand_per_trace.append(sorted(cands))
        hr = {arm: ev.hit_ratios(grid.config(base_cfg, arm), prefix)
              for arm in sorted({a for c in cand_per_trace for a in c})}
        for t in range(n):
            cur = grid.arm_index(*pos[t])
            best, best_hr = cur, hr[cur][t]
            for arm in cand_per_trace[t]:
                if hr[arm][t] > best_hr:       # strict: ties keep current
                    best, best_hr = arm, hr[arm][t]
            pos[t] = list(np.unravel_index(best, grid.shape))
            history.append((e, prefix, t, int(best), float(best_hr)))
    committed = [grid.arm_index(*p) for p in pos]
    return _finalize(base_cfg, grid, ev, committed, history,
                     len(prefix_fracs))


def bandit(base_cfg: SimConfig, blocks: np.ndarray, lengths: np.ndarray,
           grid: Optional[SearchGrid] = None, *, episodes: int = 12,
           epsilon: float = 0.25, seed: int = 0,
           prefix_frac: float = 0.25, top_k: int = 3,
           chunk: int = DEFAULT_CHUNK, device=None) -> AdaptResult:
    """Per-trace epsilon-greedy bandit over all grid arms.

    Exploration decisions come from one ``default_rng(seed)`` tensor
    drawn before any episode, so the decision history is a pure
    function of ``(seed, grid, corpus)`` — reproducible across
    processes. ``episodes=0`` reduces to the static config (see
    :func:`hill_climb`). Sweeps run on ``device`` (None: the card).
    """
    grid = grid or SearchGrid()
    ev = _Evaluator(blocks, lengths, chunk, device)
    n = ev.blocks.shape[0]
    if episodes <= 0:
        return _finalize(base_cfg, grid, ev, [-1] * n, [], 0)

    rng = np.random.default_rng(seed)
    explore = rng.random((episodes, n)) < epsilon
    draws = rng.integers(0, grid.n_arms, size=(episodes, n))

    prefix = _prefixes([prefix_frac], ev.t_full, chunk)[0]
    start = grid.nearest_arm(base_cfg)
    pulls = np.zeros((n, grid.n_arms), np.int64)
    means = np.zeros((n, grid.n_arms))
    history = []
    for e in range(episodes):
        chosen = np.empty((n,), np.int64)
        for t in range(n):
            if pulls[t].sum() == 0:
                chosen[t] = start
            elif explore[e, t]:
                chosen[t] = draws[e, t]
            else:
                chosen[t] = int(np.argmax(
                    np.where(pulls[t] > 0, means[t], -np.inf)))
        hr = {arm: ev.hit_ratios(grid.config(base_cfg, int(arm)), prefix)
              for arm in sorted(set(chosen.tolist()))}
        for t in range(n):
            arm, r = int(chosen[t]), float(hr[int(chosen[t])][t])
            means[t, arm] = (means[t, arm] * pulls[t, arm] + r) \
                / (pulls[t, arm] + 1)
            pulls[t, arm] += 1
            history.append((e, prefix, t, arm, r))

    committed = []
    for t in range(n):
        pulled = np.flatnonzero(pulls[t] > 0)
        order = sorted(pulled, key=lambda a: (-means[t, a], a))
        finalists = order[:max(1, top_k)]
        full = {a: float(ev.hit_ratios(grid.config(base_cfg, int(a)),
                                       ev.t_full)[t]) for a in finalists}
        committed.append(int(min(full, key=lambda a: (-full[a], a))))
    return _finalize(base_cfg, grid, ev, committed, history, episodes)
