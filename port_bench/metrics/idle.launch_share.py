"""The graph launch's share of the traced span's device idle time: of
the span's idle time (no kernel, copy or fill running), the share that
lies inside the program's ``runner.replay`` spans (host events, one
around each ``CUDAGraph.replay()``), as a percentage. Time under the
profiler's own buffer events (``Buffer Flush``, ``Activity Buffer
Request``; the ledger writes them with ``_``) is taken out of both.
Nothing to read without the program's spans in the trace."""

from pbench import records

REPLAY = "runner.replay"
PROFILER = ("Buffer_Flush", "Activity_Buffer_Request")


def read(ctx):
    trace = ctx.get("trace")
    if trace is None:
        return None
    replay = [(a, b) for name, a, b in trace.host if name == REPLAY]
    if not replay:
        return None
    idle = records.gaps(trace.busy_intervals(), *trace.span)
    idle = records.subtract(idle, [(a, b) for name, a, b in trace.host
                                   if name.replace(" ", "_") in PROFILER])
    total = records.length(idle)
    if total <= 0:
        return None
    return 100.0 * records.length(records.intersect(idle, replay)) / total
