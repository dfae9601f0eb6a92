"""The program's own sweep records, for the readers of in-program
metrics, and interval arithmetic for them and the profiler's trace.

The program (``repro_torch.runtime.spans``) keeps a record of each of
its last sweep calls: span totals, counters and the consumer stream's
device events. The window's last pass is the newest record taken
without the profiler, since the traced pass runs after the window. A
program without the recorder has nothing to read: :func:`window` then
gives ``None``.
"""

from __future__ import annotations

from typing import Iterable, List, Tuple

Interval = Tuple[float, float]


def window():
    """The newest sweep record taken without the profiler, or None."""
    try:
        from repro_torch.runtime import spans
    except ImportError:
        return None
    for rec in reversed(spans.records()):
        if not rec.profiled:
            return rec
    return None


def merge(intervals: Iterable[Interval]) -> List[Interval]:
    """The union of ``intervals`` as sorted, disjoint intervals."""
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def length(intervals: Iterable[Interval]) -> float:
    return sum(b - a for a, b in merge(intervals))


def gaps(busy: Iterable[Interval], lo: float, hi: float) -> List[Interval]:
    """The parts of ``[lo, hi]`` that ``busy`` leaves uncovered."""
    out, at = [], lo
    for a, b in merge(busy):
        if a > at:
            out.append((at, min(a, hi)))
        at = max(at, b)
        if at >= hi:
            break
    if at < hi:
        out.append((at, hi))
    return [(a, b) for a, b in out if b > a]


def intersect(xs: Iterable[Interval],
              ys: Iterable[Interval]) -> List[Interval]:
    """The parts of the union of ``xs`` that the union of ``ys`` covers."""
    xs, ys = merge(xs), merge(ys)
    out, j = [], 0
    for a, b in xs:
        while j < len(ys) and ys[j][1] <= a:
            j += 1
        k = j
        while k < len(ys) and ys[k][0] < b:
            lo, hi = max(a, ys[k][0]), min(b, ys[k][1])
            if hi > lo:
                out.append((lo, hi))
            k += 1
    return out


def subtract(xs: Iterable[Interval],
             ys: Iterable[Interval]) -> List[Interval]:
    """The parts of the union of ``xs`` that ``ys`` leaves uncovered."""
    out: List[Interval] = []
    for a, b in merge(xs):
        out += gaps(ys, a, b)
    return out
