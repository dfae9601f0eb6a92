"""Fault tolerance: failure detection, checkpoint-restart, stragglers
(a copy of the reference's ``runtime/fault.py``, which is plain Python).

The package has no multi-host runtime of its own, so the control
plane is implemented against an abstract ``WorkerPool`` that tests drive
with injected failures/delays — the state machine, restart driver, and
mitigation math are the real deliverable and run unchanged on top of a
real pool (heartbeats from the process group at deployment).

* ``HeartbeatMonitor``  — per-worker deadline detection.
* ``run_with_restarts`` — restart-from-latest-checkpoint driver with
  bounded retries and elastic scale-down on repeated failure.
* ``StragglerPolicy``   — p50-relative deadline; slow shards get their
  work redundantly dispatched to the fastest idle worker (backup tasks,
  MapReduce-style).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional


class WorkerFailure(RuntimeError):
    def __init__(self, worker: int, reason: str):
        super().__init__(f"worker {worker}: {reason}")
        self.worker = worker
        self.reason = reason


@dataclasses.dataclass
class HeartbeatMonitor:
    n_workers: int
    timeout_s: float = 30.0
    _last: Dict[int, float] = dataclasses.field(default_factory=dict)

    def beat(self, worker: int, now: Optional[float] = None):
        self._last[worker] = time.monotonic() if now is None else now

    def check(self, now: Optional[float] = None) -> List[int]:
        now = time.monotonic() if now is None else now
        return [w for w in range(self.n_workers)
                if now - self._last.get(w, now) > self.timeout_s]


@dataclasses.dataclass
class StragglerPolicy:
    """Flag shards slower than ``factor`` x running-median step time."""
    factor: float = 2.0
    history: int = 20
    _times: List[float] = dataclasses.field(default_factory=list)

    def observe(self, step_time: float) -> None:
        self._times.append(step_time)
        self._times = self._times[-self.history:]

    @property
    def median(self) -> float:
        s = sorted(self._times)
        return s[len(s) // 2] if s else 0.0

    def deadline(self) -> float:
        return self.factor * self.median if self._times else float("inf")

    def plan_backup(self, shard_times: Dict[int, float]) -> Dict[int, int]:
        """shard -> backup worker for shards past the deadline; backups are
        the fastest workers this step (they're idle soonest)."""
        dl = self.deadline()
        slow = [s for s, t in shard_times.items() if t > dl]
        fast = sorted(shard_times, key=shard_times.get)
        plan = {}
        for i, s in enumerate(slow):
            cand = fast[i % max(1, len(fast))]
            if cand != s:
                plan[s] = cand
        return plan


def run_with_restarts(train_some_steps: Callable[[int, object], tuple],
                      init_state, ckpt, *, total_steps: int,
                      ckpt_every: int = 10, max_restarts: int = 3,
                      on_restart: Optional[Callable[[int], None]] = None):
    """Drive ``train_some_steps(start_step, state) -> (step, state)`` to
    ``total_steps``, restarting from the latest checkpoint on failure.

    ``train_some_steps`` is expected to checkpoint via ``ckpt`` at least
    every ``ckpt_every`` steps (the driver re-seeds from ckpt.restore).
    Raises after ``max_restarts`` consecutive failures (caller escalates
    to elastic scale-down / page the operator).
    """
    state = init_state
    step = 0
    restarts = 0
    while step < total_steps:
        try:
            step, state = train_some_steps(step, state)
            restarts = 0
        except WorkerFailure as e:
            restarts += 1
            if restarts > max_restarts:
                raise RuntimeError(
                    f"exceeded {max_restarts} restarts; last: {e}") from e
            ckpt.wait()
            latest = ckpt.latest_step()
            if latest is None:
                step, state = 0, init_state
            else:
                step, state = ckpt.restore(state)
            if on_restart:
                on_restart(step)
    return step, state
