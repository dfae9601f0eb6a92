"""The benchmark's plain reference against the port's CPU sweep: equal
per-trace ``Stats`` and hit curves, on traces of the cells' traffic."""

import dataclasses

import numpy as np
import pytest

from pbench import check, traffic
from pbench.system import STATS, System, sim_config

from pb_helpers import small_cell

CELLS = ["mithril-lru-c512.corpus135", "mithril-amp-lru-c512.corpus135",
         "mithril-lru-c512.stream64"]


@pytest.mark.parametrize("workload", CELLS)
def test_reference_equals_port_on_cpu(workload):
    cell, cfg, tr, _, _ = small_cell(workload, n_specs=10, nominal=2500)
    _, traces = traffic.generate(tr, seed=2**31 + 11)
    blocks, lengths = traffic.stack(traces)
    got = System(cfg, tr, "cpu").run(blocks, lengths)
    ref = check.run_reference(cfg, traces, workers=1)
    result = check.compare([got], ref)
    assert result["numbers"] == {"stats_differ": 0, "hits_differ": 0}
    # the cells exercise every layer the comparison covers
    issued = sum(r["pf_issued"][1] for r in ref)
    assert issued > 0 and sum(r["hits"] for r in ref) > 0
    if cfg["use_amp"]:
        assert sum(r["pf_issued"][2] for r in ref) > 0


def test_reference_mines():
    """At the traced span's length lanes mine, and the port agrees."""
    cell, cfg, tr, _, _ = small_cell("mithril-lru-c512.corpus135",
                                     n_specs=6, nominal=2500)
    tr = {**tr, "specs": [s for s in traffic.load_traffic("corpus135")
                          ["specs"] if s["name"] in ("midfreq010", "loop001",
                                                     "mixed006")]}
    _, traces = traffic.generate(tr, seed=7)
    ref = check.run_reference(cfg, traces, count=True, workers=1)
    assert sum(len(r["mine_runs"]) for r in ref) > 0
    blocks, lengths = traffic.stack(traces)
    got = System(cfg, tr, "cpu").run(blocks, lengths)
    assert check.compare([got], ref)["numbers"]["stats_differ"] == 0


def test_config_files_are_the_run_configuration():
    """Each configuration file builds the ``SimConfig`` it states."""
    for name in ("mithril-lru-c512", "mithril-amp-lru-c512"):
        cfg = traffic.load_json("configs", name)
        d = dataclasses.asdict(sim_config(cfg))
        for k in ("capacity", "ways", "policy", "use_mithril", "use_amp"):
            assert d[k] == cfg[k]
        for k, v in cfg["mithril"].items():
            assert d["mithril"][k] == v
        assert d["amp"] == cfg["amp"]


def test_compare_counts_each_difference():
    ref = [{"requests": 3, "hits": 1, "pf_issued": [0, 1, 0, 0],
            "pf_used": [0] * 4, "pf_evicted_unused": [0] * 4,
            "hit_curve": np.array([0, 1, 0], bool)}]

    class P:
        stats = {f: np.array([ref[0][f]]) for f in STATS}
        hit_curve = np.array([[0, 1, 0, 0]], bool)

    assert check.compare([P], ref)["numbers"] == {"stats_differ": 0,
                                                  "hits_differ": 0}
    P.hit_curve = np.array([[1, 1, 0, 1]], bool)
    P.stats = {**P.stats, "hits": np.array([2])}
    out = check.compare([P], ref)
    assert out["numbers"] == {"stats_differ": 1, "hits_differ": 2}
    assert (out["attempted"], out["failed"]) == (1, 1)
