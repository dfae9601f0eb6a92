"""Device busy milliseconds a request step: the union of the traced
span's kernels, copies and fills over the steps replayed there."""


def read(ctx):
    trace, steps = ctx.get("trace"), ctx.get("steps")
    if trace is None or not steps:
        return None
    return trace.busy_s() * 1e3 / steps
