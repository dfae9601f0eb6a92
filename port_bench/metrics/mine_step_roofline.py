"""The mining-run kernel's share of its roofline: the least time of each
launch in the traced span (``pbench.touched.mine_run_work`` of the
lanes that mine in it, a byte a lane for the need flags, bytes or
operations, whichever binds) over the kernel's device time there, as a
percentage. Nothing to read where no lane mines in the span."""

from pbench import touched

KERNEL = "mine_step_kernel"


def read(ctx):
    trace, runs = ctx.get("trace"), ctx.get("mine_launches")
    if trace is None or not runs:
        return None
    times = [b - a for name, a, b in trace.device if KERNEL in name]
    if not times:
        return None
    lanes = ctx["lanes"]
    least = sum(touched.bound_s(lanes + b, ops)[0] for b, ops in runs)
    least += (len(times) - len(runs)) * touched.bound_s(lanes, 0)[0]
    return 100.0 * least / (sum(times) / 1e9)
