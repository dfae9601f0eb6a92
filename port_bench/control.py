#!/usr/bin/env python3
"""The control of the benchmark's correctness check: the plain reference
put in the program's place with its block ids held in 16 bits (unsigned,
so that no id becomes the tables' empty key), the next width below the
int32 that the configuration states, as a later change that packed the
cache's and tables' keys might hold them. The check must
call it not correct.

    python3 port_bench/control.py --workload <cell> --seed <n> [--seed <m> ...]

For each seed it generates the cell's corpus at its own size, runs the
reference on it and the control, compares the two as the benchmark
compares a pass (``pbench.check``) and prints each number compared with
its limit. The benchmark's own runs do not run it.
"""

import argparse
import json
import sys
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))


class AsPass:
    """Reference results in the shape of a pass of the program."""

    def __init__(self, results, width: int):
        from pbench.check import FIELDS
        self.stats = {f: np.array([r[f] for r in results]) for f in FIELDS}
        self.hit_curve = np.zeros((len(results), width), bool)
        for i, r in enumerate(results):
            self.hit_curve[i, :len(r["hit_curve"])] = r["hit_curve"]


def uint16_ids(trace: np.ndarray) -> np.ndarray:
    """Block ids as unsigned 16-bit keys would hold them."""
    return trace.astype(np.uint16).astype(np.int32)


def control_numbers(cfg: dict, traces, workers: int = 0) -> dict:
    """The numbers the check compares, for the control in the program's
    place over ``traces``."""
    from pbench import check
    ref = check.run_reference(cfg, traces, workers=workers)
    ctl = check.run_reference(cfg, [uint16_ids(t) for t in traces],
                              workers=workers)
    width = max(len(t) for t in traces)
    return check.compare([AsPass(ctl, width)], ref)["numbers"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, action="append", required=True)
    args = ap.parse_args(argv)
    from pbench import check, traffic
    bench = json.loads((HERE.parent / "BENCHMARK.json").read_text())
    cell = {w["name"]: w for w in bench["workloads"]}[args.workload]
    cfg = traffic.load_json("configs", cell["config"])
    tr = traffic.load_traffic(cell["traffic"])
    for seed in args.seed:
        _, traces = traffic.generate(tr, seed)
        numbers = control_numbers(cfg, traces)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control": numbers, "limits": check.LIMITS,
                          "correct": check.verdict(numbers)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
