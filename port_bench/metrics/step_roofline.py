"""The request steps' share of their roofline: the least time of the
traced span's bytes at the card's memory rate over the span's device
busy time, as a percentage. The bytes are counted from the inputs by the
reference (``pbench.touched``): each cache set access (demand and
prefetch), each record event with 4 bytes a lane for its enable flags,
each prefetch lookup, and each mining run with a byte a lane for the
barrier's flags."""

from pbench import touched


def read(ctx):
    trace, steps, by = ctx.get("trace"), ctx.get("steps"), ctx.get("bytes")
    if trace is None or not steps or not by:
        return None
    busy = trace.busy_s()
    if busy <= 0:
        return None
    lanes = ctx["lanes"]
    total = (by["set"] + by["record"] + by["lookup"] + 4.0 * lanes * steps
             + sum(b for b, _ in ctx["mine_launches"]) + lanes * steps)
    return 100.0 * total / touched.H100["hbm_bytes_s"] / busy
