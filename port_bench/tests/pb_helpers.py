"""Small cells for the CPU tests: the cell's own files with fewer and
shorter traces, and a stand-in for the card."""

import json
from pathlib import Path

import torch

from pbench import traffic

ROOT = Path(__file__).resolve().parents[2]


class CpuCard:
    """Runs the harness on the CPU (the tests' stand-in for the card)."""
    device = torch.device("cpu")

    def sync(self):
        pass

    def reset_peak(self):
        pass

    def peak(self):
        return 0

    def name(self):
        return "cpu"

    def build(self):
        return False

    def free(self):
        pass


def small_cell(workload: str, n_specs: int = 6, nominal: int = 1500):
    """``run.load_cell``'s tuple for ``workload`` with every
    ``len(specs) // n_specs``-th trace at ``nominal`` requests; a cell
    named ``<config>.<traffic>`` that ``BENCHMARK.json`` does not list
    takes the metrics of the listed cells."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    # a cell that BENCHMARK.json does not list: "<config>.<traffic>"
    config, traffic_name = workload.rsplit(".", 1)
    cell = cells.get(workload, {"name": workload, "config": config,
                                "traffic": traffic_name, "chips": 1})
    cfg = traffic.load_json("configs", cell["config"])
    tr = traffic.load_traffic(cell["traffic"])
    step = max(1, len(tr["specs"]) // n_specs)
    tr = {**tr, "specs": tr["specs"][::step][:n_specs],
          "nominal_length": nominal}
    args = dict(tr.get("entry_args", {}))
    if "lane_width" in args:
        args["lane_width"] = max(1, n_specs // 2)
        args["chunk"] = nominal // 3
        tr["entry_args"] = args

    def mine(m):
        return workload in m.get("workloads", [workload])

    return (cell, cfg, tr, [m for m in bench["end_to_end"] if mine(m)],
            [m for m in bench["per_layer"] if mine(m)])
