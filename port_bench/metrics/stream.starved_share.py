"""The consumer's starved share of the window's last pass
(``pbench.records.window``): the program's ``stream.ring_wait`` span
total (the calling thread blocked on an empty ring, the producer behind)
over the pass's host time (the record's wall), as a percentage. Nothing
to read where the pass ran no slab (a program without the recorder)."""

from pbench import records


def read(ctx):
    rec = records.window()
    if rec is None or not rec.count_of("stream.consume") or not rec.wall_s:
        return None
    return 100.0 * rec.total_s("stream.ring_wait") / rec.wall_s
