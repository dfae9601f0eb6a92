#!/usr/bin/env python3
"""One run of one benchmark cell of the PyTorch and CUDA port
(``repro_torch``) on the card, from the root of a checkout:

    python3 port_bench/run.py --workload <cell> --seed <n> \
        --seconds <s> --trace <0|1>

The cell (``BENCHMARK.json``'s ``workloads``) names a configuration
(``port_bench/configs/<name>.json``) and a traffic mix
(``port_bench/traffic/<name>.json``); per-layer metrics are the readers
``port_bench/metrics/<name>.py``.

Set-up builds the port's kernels that are missing (the first run in a
checkout compiles them into ``build/kernels/``), generates the corpus
from the seed, runs one warm pass (which captures the graph of the
cell's lane width) and resets the device's memory peak. The
window then runs whole passes of the cell's entry over the corpus, back
to back, at least one, a further one only while the time left holds it
(estimated from the passes run); its time is the sum of the passes'
host-clock times, each ending with the results on the host. With
``--trace 1`` a pass over the first ``TRACE_STEPS`` requests of every
trace then runs under ``torch.profiler`` for the per-layer metrics.

Once the window has closed the plain reference (``pbench.reference``)
simulates every trace and ``correct`` says whether every pass equals it.
The last line of standard output is the result as one JSON object; the
numbers compared, with their limits, are the last lines of standard
error. Exits non-zero, printing no result, without a card, without the
program, or when JAX or the JAX package was loaded.
"""

import time

T_START = time.monotonic()      # set-up is timed from here

import argparse                                     # noqa: E402
import importlib.util                               # noqa: E402
import json                                         # noqa: E402
import statistics                                   # noqa: E402
import sys                                          # noqa: E402
from pathlib import Path                            # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
sys.path.insert(0, str(HERE))
sys.path.insert(1, str(ROOT / "src"))

# requests of each trace in the traced span: enough that lanes mine
# (about 200 mining runs in 60 of the 135 corpus traces)
TRACE_STEPS = 2048
# top-level module names that must not be loaded: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def load_cell(name: str):
    """The cell's entry, configuration, traffic and metric definitions."""
    from pbench import traffic
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; cells: "
                         f"{sorted(cells)}")
    cell = cells[name]
    cfg = traffic.load_json("configs", cell["config"])
    tr = traffic.load_traffic(cell["traffic"])

    def mine(m):
        return name in m.get("workloads", [name])

    return (cell, cfg, tr, [m for m in bench["end_to_end"] if mine(m)],
            [m for m in bench["per_layer"] if mine(m)])


def reader(metric: str):
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"pbench_metric_{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def mine_launches(ref_prefix, starts):
    """``(bytes, operations)`` of each mining-run launch of the traced
    span in which some lane mines: the runs of every trace grouped by the
    step they fall on."""
    by_step = {}
    for r, s0 in zip(ref_prefix, starts):
        for b, ops, _, at in r["mine_runs"]:
            acc = by_step.setdefault(int(s0) + at, [0.0, 0.0])
            acc[0] += b
            acc[1] += ops
    return [tuple(v) for v in by_step.values()]


class Card:
    """The card a run measures on: its device, clock fence and memory
    peak."""

    def __init__(self, chips: int):
        import torch
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n < chips:
            raise LookupError(f"this cell needs {chips} CUDA device(s); "
                              f"found {n}")
        self.torch = torch
        self.device = torch.device("cuda", 0)

    def sync(self) -> None:
        self.torch.cuda.synchronize()

    def reset_peak(self) -> None:
        self.torch.cuda.reset_peak_memory_stats()

    def peak(self) -> int:
        return int(self.torch.cuda.max_memory_allocated())

    def name(self) -> str:
        return self.torch.cuda.get_device_name(0)

    def build(self) -> bool:
        from pbench.system import build_kernels
        return build_kernels()

    def free(self) -> None:
        self.torch.cuda.empty_cache()


def main(argv=None, card=None, cell=None) -> int:
    """One run; ``card`` and ``cell`` stand in for the card and the
    cell's files in the tests."""
    args = parse(argv)
    import numpy as np
    from pbench import check, profile, traffic
    from pbench.system import System

    cell, cfg, tr, e2e, layers = cell or load_cell(args.workload)
    chips = int(cell["chips"])
    if card is None:
        try:
            card = Card(chips)
        except LookupError as e:
            print(e, file=sys.stderr)
            return 3

    # --- set-up -----------------------------------------------------------
    marks = {"imports_s": time.monotonic() - T_START}
    t = time.monotonic()
    compiled = card.build()
    system = System(cfg, tr, card.device)
    marks["build_s"] = time.monotonic() - t
    t = time.monotonic()
    _, traces = traffic.generate(tr, args.seed)
    blocks, lengths = traffic.stack(traces)
    marks["generate_s"] = time.monotonic() - t
    t = time.monotonic()
    # a whole pass: it captures the graph, and the first whole pass after
    # a warm-up of one chunk ran up to 11% slower than the next (PERF.md)
    system.run(blocks, lengths)
    chunk = system.chunk
    card.sync()
    card.reset_peak()
    marks["warm_s"] = time.monotonic() - t
    setup_s = time.monotonic() - T_START

    # --- the window -------------------------------------------------------
    passes, times = [], []
    while not times or sum(times) + statistics.mean(times) <= args.seconds:
        t0 = time.perf_counter()
        passes.append(system.run(blocks, lengths))
        card.sync()
        times.append(time.perf_counter() - t0)
    window_s = sum(times)
    peak = card.peak()
    requests = int(lengths.sum()) * len(passes)

    # --- the traced span --------------------------------------------------
    ctx = {"peak_bytes": peak, "streaming": passes[-1].streaming}
    traced_pass = None
    if args.trace:
        cut = np.minimum(lengths, TRACE_STEPS)
        runner = system.runner()
        replays = runner.replays
        with profile.traced() as box:
            traced_pass = system.run(
                np.ascontiguousarray(blocks[:, :TRACE_STEPS]), cut)
            card.sync()
        marks.update(trace_read_s=box["read_s"], trace_exit_s=box["exit_s"])
        ctx.update(trace=box["trace"],
                   steps=(runner.replays - replays) * runner.unroll,
                   lanes=system.lane_width or len(traces))
    del system
    from repro_torch.cache import reset_runners
    reset_runners()
    card.free()

    # --- correctness, after the window ------------------------------------
    t_ref = time.perf_counter()
    ref = check.run_reference(cfg, traces)
    result = check.compare(passes, ref)
    numbers = dict(result["numbers"])
    if traced_pass is not None:
        ref_prefix = check.run_reference(
            cfg, [t[:TRACE_STEPS] for t in traces], count=True)
        traced = check.compare([traced_pass], ref_prefix)
        for k, v in traced["numbers"].items():
            numbers[k] += v
        result["attempted"] += traced["attempted"]
        result["failed"] += traced["failed"]
        starts = (traffic.admission_starts(cut, ctx["lanes"], chunk)
                  if tr["entry"] == "sweep_streaming"
                  else np.zeros(len(traces), np.int64))
        ctx.update(
            bytes={k: sum(r[f"{k}_bytes"] for r in ref_prefix)
                   for k in ("set", "record", "lookup")},
            mine_launches=mine_launches(ref_prefix, starts),
            mining_runs=sum(len(r["mine_runs"]) for r in ref_prefix))
    ref_s = time.perf_counter() - t_ref
    correct = check.verdict(numbers)

    # --- metrics ----------------------------------------------------------
    metrics = {}
    if args.trace:
        for m in layers:
            v = reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        values = {"sweep_requests_per_s": requests / window_s,
                  "setup_s": setup_s}
        for m in e2e:
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}

    found = forbidden_modules()
    if found:
        print(f"loaded in this process: {', '.join(found)}; the benchmark "
              "runs the port without JAX or the JAX package",
              file=sys.stderr)
        return 4

    device = {"platform": "gpu", "kind": card.name(),
              "count": chips, "memory_peak_bytes": int(peak)}
    out = {"correct": correct, "attempted": result["attempted"],
           "failed": result["failed"], "metrics": metrics, "device": device}
    if args.trace:
        trace = ctx["trace"]
        device.update(busy_s=trace.busy_s(), window_s=trace.window_s)
        ops = sorted(trace.by_name().items(), key=lambda kv: -kv[1][0])
        out["breakdown"] = {
            "device_ops": [[k, v[0]] for k, v in ops[:10]],
            "idle_gaps": [[k, v] for k, v in trace.idle_gaps(10)]}
    limits = check.LIMITS
    out["checks"] = {k: {"value": numbers[k], "limit": limits[k]}
                     for k in limits}
    info = {"passes": len(passes), "pass_s": times, "window_s": window_s,
            "requests": requests, "setup_s": setup_s, "compiled": compiled,
            "reference_s": ref_s, "seed": args.seed, **marks,
            "run_s": time.monotonic() - T_START}
    if args.trace:
        info.update(traced_steps=ctx["steps"],
                    traced_wall_s=ctx["trace"].wall_s,
                    mining_runs=ctx["mining_runs"])
    print(json.dumps({"run": info}), file=sys.stderr)
    for k in limits:
        print(f"{k} {numbers[k]} limit {limits[k]}", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
