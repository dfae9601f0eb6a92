"""The one generator of the benchmark's traffic: it reads a traffic file
(``traffic/<name>.json``) and a configuration file
(``configs/<name>.json``) and makes the cell's inputs from ``--seed``.

A traffic file lists trace specs (``name``, ``family``, ``length_frac``,
generator ``params``) and a ``nominal_length``, or names another
traffic file's traces under ``traces_from``; ``entry`` and
``entry_args`` say which entry of the program a pass calls and how.
Each spec generates with its own seed, ``crc32("<seed>:<name>")``, so a
seed changes every trace's content and none of their lengths.
"""

from __future__ import annotations

import json
import zlib
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

from . import generators

ROOT = Path(__file__).resolve().parents[1]
BUILDERS = {
    "seq": generators.interleaved_sequential,
    "loop": generators.looping,
    "zipf": generators.zipf,
    "midfreq": generators.association_groups,
    "mixed": generators.mixed,
}


def load_json(kind: str, name: str) -> dict:
    """``<kind>/<name>.json`` under the benchmark's folder."""
    path = ROOT / kind / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no such {kind} file: {path}")
    return json.loads(path.read_text())


def load_traffic(name: str) -> dict:
    """A traffic file, with ``traces_from`` resolved into its specs."""
    doc = load_json("traffic", name)
    if "traces_from" in doc:
        base = load_traffic(doc["traces_from"])
        doc = {**doc, "specs": base["specs"],
               "nominal_length": base["nominal_length"]}
    return doc


def spec_seed(name: str, seed: Optional[int]) -> int:
    """A spec's generator seed: ``crc32(name)`` as the registry has it
    when ``seed`` is None, else mixed with the run's seed."""
    key = name if seed is None else f"{seed}:{name}"
    return zlib.crc32(key.encode()) & 0x7FFFFFFF


def spec_length(spec: dict, nominal: int) -> int:
    return max(1, int(nominal * spec["length_frac"]))


def generate(traffic: dict, seed: Optional[int],
             nominal: Optional[int] = None
             ) -> Tuple[Tuple[str, ...], List[np.ndarray]]:
    """The traces of ``traffic`` for ``seed`` (names, int32 arrays)."""
    n = traffic["nominal_length"] if nominal is None else nominal
    names, traces = [], []
    for spec in traffic["specs"]:
        fn = BUILDERS[spec["family"]]
        traces.append(np.asarray(
            fn(spec_length(spec, n), seed=spec_seed(spec["name"], seed),
               **spec["params"]), np.int32))
        names.append(spec["name"])
    return tuple(names), traces


def stack(traces: List[np.ndarray]) -> Tuple[np.ndarray, np.ndarray]:
    """Zero-padded ``(B, T)`` blocks and the ``(B,)`` lengths."""
    lengths = np.array([len(t) for t in traces], np.int64)
    blocks = np.zeros((len(traces), int(lengths.max())), np.int32)
    for i, t in enumerate(traces):
        blocks[i, :len(t)] = t
    return blocks, lengths


def admission_starts(lengths, lane_width: int, chunk: int) -> np.ndarray:
    """The step at which each trace starts when every trace is queued at
    step 0 and lanes recycle at slab boundaries in FIFO order (the
    streamed traffic's schedule): a trace holds its lane for
    ``ceil(length / chunk)`` slabs and its lane takes the next queued
    trace at the slab after it drains."""
    free_at = [0] * lane_width          # slab at which each lane is free
    starts = np.zeros(len(lengths), np.int64)
    queue = list(range(len(lengths)))
    slab = 0
    while queue:
        for lane in range(lane_width):
            if queue and free_at[lane] <= slab:
                i = queue.pop(0)
                starts[i] = slab * chunk
                free_at[lane] = slab + max(1, -(-int(lengths[i]) // chunk))
        slab += 1
    return starts

