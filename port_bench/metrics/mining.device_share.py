"""The mining barrier's device time (every launch of the mining-run
kernel in the traced span, where no lane mines too) over the span's
device busy time, as a percentage."""

KERNEL = "mine_step_kernel"


def read(ctx):
    trace = ctx.get("trace")
    if trace is None:
        return None
    mine = sum(b - a for name, a, b in trace.device if KERNEL in name) / 1e9
    busy = trace.busy_s()
    if mine <= 0 or busy <= 0:
        return None
    return 100.0 * mine / busy
