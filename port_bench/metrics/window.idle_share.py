"""The untraced window's device idle share: over the window's last pass
(``pbench.records.window``), 1 - the union of the consumer stream's
``replay`` and ``lane_work`` device intervals (CUDA events the program
records around each graph replay with its input and hit copies, and
each lane reset and harvest copy) over the time from the first
interval's start to the last one's end, as a percentage: the share of
that timeline in which the stream held no work the host had enqueued.
Nothing to read without the program's events (the CPU, or a program
without the recorder)."""

from pbench import records


def read(ctx):
    rec = records.window()
    if rec is None:
        return None
    iv = rec.device_intervals("replay") + rec.device_intervals("lane_work")
    if not iv:
        return None
    lo, hi = min(a for a, _ in iv), max(b for _, b in iv)
    if hi <= lo:
        return None
    return 100.0 * (1.0 - records.length(iv) / (hi - lo))
