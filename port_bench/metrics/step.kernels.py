"""Device kernels a request step: the profiler's kernel count in the
traced span over the steps the chunk runner replayed there."""


def read(ctx):
    trace, steps = ctx.get("trace"), ctx.get("steps")
    if trace is None or not steps:
        return None
    return len(trace.kernels()) / steps
