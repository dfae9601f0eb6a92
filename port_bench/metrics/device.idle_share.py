"""The device's idle share of the traced span: 1 - busy / wall, where
busy is the union of its operations' intervals, as a percentage."""


def read(ctx):
    trace = ctx.get("trace")
    if trace is None or trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s() / trace.window_s)
