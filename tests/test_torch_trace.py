"""The sweep engine's spans, counters and device events
(``repro_torch.runtime.spans``) on the CPU: nesting and self time per
thread, one record per outermost entry, the bounded history, spans in
the profiler's trace, the streaming engine's record and the
``pipeline`` telemetry it feeds, and the mining-run counter against the
benchmark's plain reference (``port_bench/pbench/reference.py``)."""

import json
import pathlib
import sys
import threading
import time

import numpy as np
import pytest
import torch

from repro_torch.cache import (SimConfig, sweep, sweep_scheduled,
                               sweep_streaming)
from repro_torch.core import MithrilConfig
from repro_torch.runtime import spans
from repro_torch.traces import mixed

ROOT = pathlib.Path(__file__).resolve().parents[1]
BENCH = ROOT / "port_bench"

CFG = SimConfig(capacity=128, use_mithril=True,
                mithril=MithrilConfig(min_support=2, max_support=6,
                                      lookahead=30, rec_buckets=256,
                                      rec_ways=4, mine_rows=32,
                                      pf_buckets=256, pf_ways=4))
# what a streamed pass on the CPU records (the card adds the capture, the
# replays and the ring's waits)
STREAM_SPANS = {"sweep_streaming", "stream.setup", "stream.produce",
                "stream.stage", "stream.consume", "stream.reset",
                "runner.run", "stream.harvest", "stream.drain",
                "stream.scatter", "stream.collect"}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def corpus(n=5, base=300):
    return {f"t{i}": mixed(base + 70 * i, 0.3, 0.4, 0.3, seed=i)
            for i in range(n)}


def test_nesting_and_self_time_per_thread():
    with spans.call("outer"):
        rec = spans.current()
        done = threading.Event()

        def worker():
            with spans.attach(rec):
                with spans.span("w"):
                    time.sleep(0.02)
                with spans.span("w"):
                    pass
            done.set()

        with spans.span("a"):
            th = threading.Thread(target=worker)
            th.start()
            with spans.span("b"):
                time.sleep(0.01)
            th.join(timeout=10)
            time.sleep(0.005)
        assert done.is_set() and not th.is_alive()
    assert spans.records()[-1] is rec
    a, b, w = rec.spans["a"], rec.spans["b"], rec.spans["w"]
    assert (a[0], b[0], w[0]) == (1, 1, 2)
    # self = total less the children opened on the same thread only
    assert a[2] == a[1] - b[1]
    assert b[2] == b[1] >= 0.01e9 and w[2] == w[1] >= 0.02e9
    out = rec.spans["outer"]
    assert out[2] == out[1] - a[1]
    assert rec.wall_s >= out[1] / 1e9 > 0
    assert rec.entry == "outer" and rec.profiled is False
    # outside a call nothing is recorded, but a span still measures
    with spans.span("loose") as s:
        time.sleep(0.001)
    assert s.seconds >= 0.001 and spans.current() is None
    assert "loose" not in spans.records()[-1].spans


def test_an_inner_entry_joins_the_outer_record():
    n = len(spans.records())
    with spans.call("outer"):
        with spans.call("inner"):
            with spans.span("x"):
                pass
            spans.count("c", 2)
        spans.count("c", 3)
    rec = spans.records()[-1]
    assert len(spans.records()) == min(spans.HISTORY, n + 1)
    assert rec.entry == "outer" and rec.counters == {"c": 5}
    assert {"outer", "inner", "x"} <= set(rec.spans)
    # through the sweep entries: one record of the outermost call, whose
    # span gives the result's seconds
    res = sweep_scheduled(CFG, corpus(4), lane_width=2, chunk=128,
                          device="cpu")
    rec = spans.records()[-1]
    assert rec.entry == "sweep_scheduled"
    assert rec.count_of("sweep") == rec.count_of("sweep_streaming") == 2
    assert rec.count_of("sweep.plan") == 1
    assert rec.count_of("sweep.pad") == rec.count_of("sweep.reassemble") == 2
    assert res.seconds == rec.total_s("sweep_scheduled") > 0
    one = sweep(CFG, np.stack([corpus(1)["t0"]] * 2), chunk=128,
                device="cpu")
    assert one.seconds == spans.records()[-1].total_s("sweep") > 0


def test_the_history_is_bounded():
    for i in range(spans.HISTORY + 2):
        with spans.call(f"c{i}"):
            pass
    recs = spans.records()
    assert len(recs) == spans.HISTORY
    assert [r.entry for r in recs] == [f"c{i}" for i in
                                       range(2, spans.HISTORY + 2)]


def test_profiled_calls_put_their_spans_into_the_trace():
    with torch.autograd.profiler.profile() as prof:
        with spans.call("entry"):
            with spans.span("inside"):
                torch.ones(3).sum()
    rec = spans.records()[-1]
    assert rec.profiled is True
    names = [e.name for e in prof.function_events]
    assert "entry" in names and "inside" in names
    with spans.call("plain"):
        pass
    assert spans.records()[-1].profiled is False


@pytest.mark.parametrize("async_on", [False, True])
def test_a_streamed_pass_records_its_spans(async_on):
    got = sweep_streaming(CFG, corpus(), lane_width=2, chunk=128,
                          async_producer=async_on, device="cpu")
    rec = spans.records()[-1]
    assert rec.entry == "sweep_streaming"
    assert STREAM_SPANS <= set(rec.spans)
    if async_on:
        assert "stream.join" in rec.spans
    assert rec.count_of("stream.produce") == got.n_slabs
    assert rec.count_of("stream.consume") == got.n_slabs
    assert rec.count_of("runner.run") == got.n_slabs
    assert rec.events == {}         # device events are the card's
    for counter in ("mining.launches", "cache.access_launches",
                    "cache.prefetch_launches"):
        assert rec.counters[counter] == 0           # the CPU counts none
    # the pipeline's stage timings are the record's totals
    p = got.pipeline
    for key, name in (("produce_s", "stream.produce"),
                      ("consume_s", "stream.consume"),
                      ("drain_s", "stream.drain")):
        assert p[key] == round(rec.total_s(name), 4)
    assert rec.count_of("stream.ring_wait") == p["consumer_stalls"]
    assert rec.count_of("stream.ring_full") == p["producer_stalls"]
    assert got.result.seconds == rec.total_s("sweep_streaming")


def bench_modules():
    for p in (str(BENCH),):
        if p not in sys.path:
            sys.path.insert(0, p)
    from pbench import reference, system, traffic
    return reference, system, traffic


@pytest.mark.parametrize("entry", ["sweep_scheduled", "sweep_streaming"])
def test_mining_runs_equal_the_references(entry):
    """``mining.runs`` counts every lane's mining runs: through the
    scheduled sweep, and through two recycled lanes, where the lane of
    a trace that mined is reset for the next (its counts are taken at
    its harvest, not from the end state)."""
    reference, system, traffic = bench_modules()
    cfg = json.loads((BENCH / "configs" / "mithril-lru-c512.json")
                     .read_text())
    tr = traffic.load_traffic("corpus135")
    tr = {**tr, "nominal_length": 2500,
          "specs": [s for s in tr["specs"]
                    if s["name"] in ("midfreq010", "loop001", "mixed006")]}
    _, traces = traffic.generate(tr, seed=7)
    want = [len(reference.simulate(cfg, t, count=True)["mine_runs"])
            for t in traces]
    assert sum(w > 0 for w in want) >= 2
    # mixed006 (mines) and loop001 drain first; midfreq010 takes a lane
    order = [2, 0, 1]
    assert want[2] > 0 and len(traces[1]) > len(traces[2])
    blocks, lengths = traffic.stack([traces[i] for i in order])
    sim = system.sim_config(cfg)
    if entry == "sweep_scheduled":
        sweep_scheduled(sim, blocks, lengths=lengths, device="cpu")
    else:
        got = sweep_streaming(sim, blocks, lengths=lengths, lane_width=2,
                              chunk=1000, device="cpu")
        assert got.n_slabs > -(-int(lengths.max()) // 1000)   # recycled
    assert spans.records()[-1].counters["mining.runs"] == sum(want)
