"""Spans, counters and device events of the sweep engine.

Each public sweep entry (``sweep_scheduled``, ``sweep``,
``sweep_streaming``) opens :func:`call`. The outermost entry on a thread
opens a :class:`Record`; an entry called inside it joins that record,
so ``sweep_scheduled`` -> ``sweep`` -> ``sweep_streaming`` is one
record. Inside a call:

* :func:`span` (or the decorator :func:`within`) adds a named interval
  on ``time.perf_counter_ns``: its count, total and self time (total
  less the spans opened inside it on the same thread). Only where the
  profiler runs on the current thread does it also open a record
  function of that name, which puts it into the profiler's trace as a
  host operation on the profiler's clock (``record_function`` costs
  ~10 us even with no profiler, the flag check ~0.2 us). It is a
  function-scope record function (``_RecordFunctionFast``), not
  ``torch.profiler.record_function``: a user annotation also becomes a
  device-side interval over the kernels it launched, which a trace
  reader would count as device work;
* :func:`device` records a pair of timing CUDA events around device
  work enqueued on the current stream. The events are read only when
  the record is read (:meth:`Record.device_intervals`), never inside a
  call; on the CPU, and in a call under the profiler (which times the
  device itself), nothing is recorded;
* :func:`count` adds to an integer counter.

Worker threads of a call join its record through :func:`attach`. The
records of the last ``HISTORY`` calls stay in memory, newest last
(:func:`records`); nothing is written or printed. Spans sit at slab or
replay granularity, never inside a request step or a captured graph.
"""

from __future__ import annotations

import collections
import functools
import threading
import time
from typing import Dict, List, Optional, Tuple

import torch

HISTORY = 4     # records kept, newest last

_local = threading.local()
_history: collections.deque = collections.deque(maxlen=HISTORY)
_history_lock = threading.Lock()


class Record:
    """What one outermost sweep call recorded."""

    def __init__(self, entry: str, profiled: bool):
        self.entry = entry
        self.profiled = profiled
        self.start_ns = time.perf_counter_ns()
        self.end_ns: Optional[int] = None
        self.spans: Dict[str, List[int]] = {}   # name -> [count, total, self]
        self.counters: Dict[str, int] = {}
        self.events: Dict[str, list] = {}       # name -> [(start, end)]
        self._origin = None                     # the first event recorded
        self._origin_dev: Optional[torch.device] = None
        self._intervals: Optional[Dict[str, list]] = None
        self._lock = threading.Lock()

    @property
    def wall_s(self) -> Optional[float]:
        """The call's seconds, once it has returned."""
        return None if self.end_ns is None else (
            self.end_ns - self.start_ns) / 1e9

    def count_of(self, name: str) -> int:
        return self.spans.get(name, (0, 0, 0))[0]

    def total_s(self, name: str) -> float:
        return self.spans.get(name, (0, 0, 0))[1] / 1e9

    def _add(self, name: str, total: int, own: int) -> None:
        with self._lock:
            row = self.spans.get(name)
            if row is None:
                self.spans[name] = [1, total, own]
            else:
                row[0] += 1
                row[1] += total
                row[2] += own

    def device_intervals(self, name: str) -> List[Tuple[float, float]]:
        """The ``(start, end)`` ms of each :func:`device` interval named
        ``name``, from the record's first event. Waits for the events;
        read the record after its call has returned."""
        if self._intervals is None:
            out: Dict[str, list] = {}
            for key, pairs in self.events.items():
                if pairs:
                    pairs[-1][1].synchronize()
                out[key] = [(self._origin.elapsed_time(a),
                             self._origin.elapsed_time(b))
                            for a, b in pairs]
            self._intervals = out
        return list(self._intervals.get(name, ()))


def _state():
    if not hasattr(_local, "stack"):
        _local.record, _local.stack = None, []
    return _local


def current() -> Optional[Record]:
    """The record of the call running on this thread, if any."""
    return _state().record


def records() -> List[Record]:
    """The records of the last ``HISTORY`` calls, newest last."""
    with _history_lock:
        return list(_history)


class _Span:
    """One open span; ``seconds`` holds its duration once closed. It
    measures even without a record (a caller may read ``seconds``)."""

    __slots__ = ("name", "seconds", "_t0", "_child", "_rf", "_local",
                 "_kept")

    def __init__(self, name: str):
        self.name = name
        self.seconds = 0.0
        self._rf = None
        self._kept = True

    def drop(self) -> None:
        """Leave this span out of the record: its time stays in the
        enclosing span's self time."""
        self._kept = False

    def __enter__(self):
        loc = _state()
        self._local = loc
        if loc.record is not None:
            loc.stack.append(self)
            if torch.autograd._profiler_enabled():
                self._rf = torch._C._profiler._RecordFunctionFast(self.name)
                self._rf.__enter__()
        self._child = 0
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter_ns() - self._t0
        self.seconds = dt / 1e9
        if self._rf is not None:
            self._rf.__exit__(*exc)
            self._rf = None
        loc = self._local
        rec = loc.record
        if rec is not None and loc.stack and loc.stack[-1] is self:
            loc.stack.pop()
            if self._kept:
                if loc.stack:
                    loc.stack[-1]._child += dt
                rec._add(self.name, dt, dt - self._child)
        return False


def span(name: str) -> _Span:
    """A context that adds one interval named ``name`` to the current
    record (see the module's docstring)."""
    return _Span(name)


class _Call(_Span):
    """An entry's span; the outermost on its thread opens the record."""

    __slots__ = ("_owner",)

    def __enter__(self):
        loc = _state()
        self._owner = loc.record is None
        if self._owner:
            loc.record = Record(self.name,
                                torch.autograd._profiler_enabled())
            loc.stack = []
        return super().__enter__()

    def __exit__(self, *exc):
        super().__exit__(*exc)
        if self._owner:
            rec = self._local.record
            rec.end_ns = time.perf_counter_ns()
            self._local.record, self._local.stack = None, []
            with _history_lock:
                _history.append(rec)
        return False


def within(name: str):
    """Decorator: each call of the function is a span named ``name``."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with _Span(name):
                return fn(*args, **kwargs)
        return inner
    return wrap


def call(entry: str) -> _Call:
    """The context of a public entry: opens a record unless one is open
    on this thread, and adds the entry as a span of it."""
    return _Call(entry)


class attach:
    """Make ``record`` current on this (worker) thread for the body."""

    def __init__(self, record: Optional[Record]):
        self.record = record

    def __enter__(self):
        loc = _state()
        self._saved = (loc.record, loc.stack)
        loc.record, loc.stack = self.record, []
        return self.record

    def __exit__(self, *exc):
        loc = _state()
        loc.record, loc.stack = self._saved
        return False


class device:
    """Timing CUDA events on ``dev``'s current stream around the body:
    an interval named ``name`` of the current record. Records nothing on
    the CPU, outside a call, in a profiled call, or on another card than
    the first one the call recorded on (events of two cards share no
    clock)."""

    __slots__ = ("name", "dev", "_rec", "_start")

    def __init__(self, name: str, dev: torch.device):
        self.name, self.dev = name, dev

    def __enter__(self):
        rec = _state().record if self.dev.type == "cuda" else None
        if rec is not None and (rec.profiled or rec._origin_dev not in (
                None, self.dev)):
            rec = None
        self._rec = rec
        if rec is not None:
            self._start = torch.cuda.Event(enable_timing=True)
            self._start.record(torch.cuda.current_stream(self.dev))
        return self

    def __exit__(self, *exc):
        rec = self._rec
        if rec is not None:
            end = torch.cuda.Event(enable_timing=True)
            end.record(torch.cuda.current_stream(self.dev))
            with rec._lock:
                if rec._origin is None:
                    rec._origin, rec._origin_dev = self._start, self.dev
                rec.events.setdefault(self.name, []).append(
                    (self._start, end))
        return False


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the current record's counter ``name``."""
    rec = _state().record
    if rec is not None:
        with rec._lock:
            rec.counters[name] = rec.counters.get(name, 0) + int(n)
