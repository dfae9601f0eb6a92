"""Lane mining runs a launch of the mining barrier's kernel, over the
window's last pass (``pbench.records.window``): the program's counters
``mining.runs`` (the traces' ``n_mines``) over ``mining.launches`` (the
pass's launches of ``mithril_mine_step``), useful outcomes over
attempts. Nothing to read where no barrier launched (the CPU counts no
launch) or without the recorder."""

from pbench import records


def read(ctx):
    rec = records.window()
    if rec is None:
        return None
    runs = rec.counters.get("mining.runs")
    launches = rec.counters.get("mining.launches")
    if runs is None or not launches:
        return None
    return runs / launches
