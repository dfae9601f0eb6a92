#!/usr/bin/env python3
"""The traced span's device idle time by the sweep span open at each gap.

    python3 tools/idle_by_span.py --workload <cell> --seed <n> \
        --seconds <s> [--out FILE]

Runs one benchmark run of the cell with ``--trace 1``
(``port_bench/run.py``, whose result line it prints unchanged) and then
splits the traced span's idle device time (no kernel, copy or fill
running) by the innermost program span (``repro_torch.runtime.spans``,
in the trace as host events of the calling thread) open over each part
of each gap: ``runner.replay``, ``runner.run`` (its self time: the input
and hit copies), ``stream.reset``, ``stream.harvest``,
``stream.ring_wait``, ``stream.join``, any other program span by its
name, and ``none`` where no program span is open. Time under the
profiler's own buffer events is counted apart as ``profiler``. Also
gives the traced span's mean ``runner.replay`` (host ms a replay under
the profiler). Needs one NVIDIA GPU; prints the split as one JSON line
on standard error and writes it to ``--out`` when given.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib.util
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
BENCH = ROOT / "port_bench"
PREFIXES = ("sweep", "stream.", "runner.")
PROFILER = ("Buffer_Flush", "Activity_Buffer_Request")


def split_idle(trace) -> dict:
    """Idle seconds of ``trace`` (a ``pbench.profile.Trace``) by the
    innermost program span open, ``profiler`` and ``none``."""
    from pbench import records
    idle = records.gaps(trace.busy_intervals(), *trace.span)
    prof = records.merge((a, b) for name, a, b in trace.host
                         if name.replace(" ", "_") in PROFILER)
    spans = sorted(((a, -b, name) for name, a, b in trace.host
                    if name.startswith(PREFIXES)))
    points = sorted({p for iv in idle for p in iv}
                    | {p for a, nb, _ in spans for p in (a, -nb)})
    out: dict = {}
    stack, i, j, k = [], 0, 0, 0
    for p, q in zip(points, points[1:]):
        while stack and stack[-1][0] <= p:     # spans ended by p
            stack.pop()
        while i < len(spans) and spans[i][0] <= p:
            a, nb, name = spans[i]
            if -nb > p:
                stack.append((-nb, name))
            i += 1
        while j < len(idle) and idle[j][1] <= p:
            j += 1
        if j == len(idle) or idle[j][0] > p:
            continue                            # the device is busy
        while k < len(prof) and prof[k][1] <= p:
            k += 1
        if k < len(prof) and prof[k][0] <= p:
            key = "profiler"
        else:
            key = stack[-1][1] if stack else "none"
        out[key] = out.get(key, 0.0) + (q - p) / 1e9
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--out", type=Path)
    args = ap.parse_args(argv)
    spec = importlib.util.spec_from_file_location("pb_run", BENCH / "run.py")
    run = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(run)
    from pbench import profile
    traced, kept = profile.traced, {}

    @contextlib.contextmanager
    def keeping():
        with traced() as box:
            yield box
        kept["trace"] = box["trace"]

    profile.traced = keeping
    rc = run.main(["--workload", args.workload, "--seed", str(args.seed),
                   "--seconds", str(args.seconds), "--trace", "1"])
    if rc or "trace" not in kept:
        return rc or 1
    trace = kept["trace"]
    split = split_idle(trace)
    replays = [b - a for name, a, b in trace.host if name == "runner.replay"]
    line = {"workload": args.workload, "seed": args.seed,
            "window_s": trace.window_s, "busy_s": trace.busy_s(),
            "idle_s": trace.window_s - trace.busy_s(), "idle_by_span": split,
            "traced_replay_ms": sum(replays) / len(replays) / 1e6
            if replays else None}
    print(json.dumps(line), file=sys.stderr)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
