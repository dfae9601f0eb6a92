"""Reading a ``torch.profiler`` trace of the traced span: the device's
operations (kernels, copies, fills) with their times, the host's
operations, the device's busy time as the union of its operations'
intervals, and the idle gaps between them by what the host was doing.

The profiler's raw kineto events are read directly: a traced sweep holds
hundreds of thousands of kernels, too many for ``key_averages``.
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import time
from typing import Dict, List, NamedTuple, Tuple

SPAN = "pbench.traced"      # the host span around the traced call


class Trace(NamedTuple):
    device: List[Tuple[str, int, int]]   # (name, start ns, end ns)
    host: List[Tuple[str, int, int]]
    span: Tuple[int, int]                # the traced span, ns
    wall_s: float                        # host clock around the span

    @property
    def window_s(self) -> float:
        return (self.span[1] - self.span[0]) / 1e9

    def busy_s(self) -> float:
        """Seconds in which some device operation ran, inside the span."""
        return sum(b - a for a, b in self.busy_intervals()) / 1e9

    def busy_intervals(self) -> List[Tuple[int, int]]:
        lo, hi = self.span
        out: List[List[int]] = []
        for _, a, b in sorted(self.device, key=lambda e: e[1]):
            a, b = max(a, lo), min(b, hi)
            if b <= a:
                continue
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return [(a, b) for a, b in out]

    def by_name(self) -> Dict[str, Tuple[float, int]]:
        """Device seconds and count of each operation, by its
        :func:`short` name."""
        rows: Dict[str, List[float]] = collections.defaultdict(
            lambda: [0.0, 0])
        for name, a, b in self.device:
            row = rows[short(name)]
            row[0] += (b - a) / 1e9
            row[1] += 1
        return {k: (v[0], int(v[1])) for k, v in rows.items()}

    def kernels(self) -> List[Tuple[str, int, int]]:
        return [e for e in self.device
                if not e[0].startswith(("Memcpy", "Memset"))]

    def idle_gaps(self, top: int = 10) -> List[Tuple[str, float]]:
        """Idle device seconds inside the span, summed by the innermost
        host operation running at each gap's midpoint (``host python``
        where none is), the largest ``top``."""
        lo, hi = self.span
        edges = [lo]
        for a, b in self.busy_intervals():
            edges += [a, b]
        edges.append(hi)
        gaps = [(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]
        host = sorted((e for e in self.host if e[0] != SPAN),
                      key=lambda e: e[1])
        starts = [e[1] for e in host]
        out: Dict[str, float] = collections.defaultdict(float)
        for a, b in gaps:
            mid = (a + b) // 2
            k = bisect.bisect_right(starts, mid)
            best = None
            # the innermost open event: scan back over events that began
            # before the midpoint (host events nest, so few are open)
            for name, s, e in reversed(host[max(0, k - 64):k]):
                if e >= mid and (best is None or e - s < best[1]):
                    best = (name, e - s)
            out[best[0] if best else "host python"] += (b - a) / 1e9
        return sorted(out.items(), key=lambda kv: -kv[1])[:top]


def short(name: str, width: int = 120) -> str:
    """A kernel's name without its namespaces and return type, cut to
    ``width`` characters."""
    for cut in ("void ", "at::native::", "(anonymous namespace)::"):
        name = name.replace(cut, "")
    return name[:width]


def _times(ev) -> Tuple[int, int]:
    if hasattr(ev, "start_ns"):
        a = ev.start_ns()
        return a, a + ev.duration_ns()
    a = int(ev.start_us() * 1e3)
    return a, a + int(ev.duration_us() * 1e3)


@contextlib.contextmanager
def traced():
    """Profile the body (host and device); yields a dict that holds the
    :class:`Trace` under ``"trace"`` once the body has run. The body
    must end with the device synchronised.

    The profiler is stopped with ``torch.autograd._disable_profiler``,
    which returns the raw events without building the profiler's event
    tables (a minute and more for a traced sweep)."""
    import torch
    from torch.autograd import profiler as autograd_profiler
    from torch.profiler import record_function
    box: dict = {}
    prof = autograd_profiler.profile(
        use_kineto=True,
        use_device="cuda" if torch.cuda.is_available() else None)
    prof.__enter__()
    try:
        t0 = time.perf_counter()
        with record_function(SPAN):
            yield box
        wall = time.perf_counter() - t0
    finally:
        t_stop = time.perf_counter()
        result = torch.autograd._disable_profiler()
    t_read = time.perf_counter()
    cuda = torch.autograd.DeviceType.CUDA
    device, host, span = [], [], None
    for ev in result.events():
        a, b = _times(ev)
        name = ev.name()
        if ev.device_type() == cuda:
            if name != SPAN:        # not the span's device-side annotation
                device.append((name, a, b))
        else:
            if name == SPAN:
                span = (a, b)
            host.append((name, a, b))
    if span is None:
        raise RuntimeError(f"the profiler recorded no {SPAN} span")
    box["trace"] = Trace(device, host, span, wall)
    box["read_s"] = time.perf_counter() - t_read
    box["exit_s"] = t_read - t_stop
