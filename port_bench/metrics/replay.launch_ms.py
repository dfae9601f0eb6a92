"""Host milliseconds in ``CUDAGraph.replay()`` a replay, over the
window's last pass (``pbench.records.window``): the program's
``runner.replay`` span total over its count. Nothing to read where the
pass replayed no graph (the CPU, or a program without the recorder)."""

from pbench import records


def read(ctx):
    rec = records.window()
    if rec is None or not rec.count_of("runner.replay"):
        return None
    return 1e3 * rec.total_s("runner.replay") / rec.count_of("runner.replay")
