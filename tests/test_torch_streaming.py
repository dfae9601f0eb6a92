"""The port's streaming engine against the JAX reference, bit for bit.

``repro_torch.cache.sweep_streaming(device="cpu")`` (the chunk runner's
eager loop over the plain kernels) and ``repro.cache.sweep_streaming``
run the corpus of ``tests/test_streaming.py`` (its ``CFG`` and 9-trace
``mixed`` corpus) at lane widths 9, 4 and 2, with and without arrival
gaps, sync and async; every ``Stats`` leaf, the hit curves and the
schedule (``n_slabs``, ``lane_steps``) must be equal. The same file
holds the ring buffer, the argument checks at the engine's boundary,
producer errors, the ``pipeline`` telemetry and the ``pipeline_quick``
rows of ``results/bench/BENCH_baseline_quick.json``.
"""

import importlib
import json
import pathlib
import threading
import time

import numpy as np
import pytest
import torch

import repro.cache as rc
from repro.cache import SimConfig
from repro.core import MithrilConfig
from repro.traces import arrival_process, mixed

import repro_torch.cache as pc
from repro_torch.cache import RingBuffer
from repro_torch.convert import config_from

# the module (the package's ``sweep`` attribute is the function)
psweep = importlib.import_module("repro_torch.cache.sweep")

ROOT = pathlib.Path(__file__).resolve().parents[1]
BASELINE = ROOT / "results" / "bench" / "BENCH_baseline_quick.json"

CFG = SimConfig(capacity=128, use_mithril=True, use_amp=True,
                mithril=MithrilConfig(min_support=2, max_support=6,
                                      lookahead=30, rec_buckets=256,
                                      rec_ways=4, mine_rows=32,
                                      pf_buckets=256, pf_ways=4))
PCFG = config_from(CFG)
CHUNK = 128
SCHEDULE_KEYS = ("lane_width", "chunk", "n_slabs", "lane_steps",
                 "ideal_lane_steps", "waste_ratio", "async_producer")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the plain step's tensors are small, and
    thread hand-offs cost more than they save (the mining run's plain
    codes take 60 ms with 8 threads and 0.4 ms with one)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def corpus():
    # tests/test_streaming.py's corpus: one long trace pins the clock
    # while short tenants cycle through reclaimed lanes
    return {f"t{i:02d}": mixed(1400 - 190 * i if i < 5 else 160 + 40 * i,
                               w_seq=0.3, w_assoc=0.4, w_zipf=0.3,
                               seed=80 + i) for i in range(9)}


# (lane width, arrival process, async producer)
CASES = {
    "w9-offline-async": (9, None, True),
    "w4-onoff-sync": (4, dict(mode="onoff", burst_len=48, idle_len=96,
                              stagger=400, seed=5), False),
    "w2-poisson-async": (2, dict(mode="poisson", rate=2.0, stagger=300,
                                 seed=9), True),
}
# The reference's per-trace results do not depend on the lane width or
# the arrivals (tests/test_streaming.py pins that), so every case is held
# against its run at width 9, one compile of CFG; the schedule depends on
# the lengths, arrivals, width and chunk alone, so each case's n_slabs
# and lane_steps are held against the reference's run at the case's width
# with a plain LRU cache, which compiles in a second.
REF_WIDTH = 9
LRU = SimConfig(capacity=128)
_RUNS = {}


def reference(traces, arrivals, width, async_on):
    """The reference's results (at REF_WIDTH) and schedule (at
    ``width``)."""
    kw = dict(arrivals=arrivals, chunk=CHUNK, async_producer=async_on,
              shard=False)
    want = rc.sweep_streaming(CFG, traces, lane_width=REF_WIDTH, **kw)
    sched = want if width == REF_WIDTH else \
        rc.sweep_streaming(LRU, traces, lane_width=width, **kw)
    return want, sched


def run_case(name, corpus):
    """The port's and the reference's runs of one case, once each."""
    if name not in _RUNS:
        w, arrivals, async_on = CASES[name]
        arr = None
        if arrivals is not None:
            a = arrival_process(corpus, **arrivals)
            arr = [a[k] for k in corpus]
        got = pc.sweep_streaming(PCFG, corpus, arrivals=arr, lane_width=w,
                                 chunk=CHUNK, async_producer=async_on,
                                 device="cpu")
        _RUNS[name] = (got,) + reference(corpus, arr, w, async_on)
    return _RUNS[name]


def assert_same(got, want, msg=""):
    for field in want.result.stats._fields:
        g = np.asarray(getattr(got.result.stats, field))
        w = np.asarray(getattr(want.result.stats, field))
        assert g.dtype == w.dtype, (msg, field)
        np.testing.assert_array_equal(g, w, err_msg=f"{msg} {field}")
    np.testing.assert_array_equal(got.result.hit_curve,
                                  want.result.hit_curve, err_msg=msg)


def assert_same_schedule(got, sched, msg=""):
    sg, ss = got.streaming_stats(), sched.streaming_stats()
    for k in SCHEDULE_KEYS:
        assert sg[k] == ss[k], (msg, k)
    assert got.n_slabs == sched.n_slabs
    assert got.lane_steps == sched.lane_steps


@pytest.mark.parametrize("name", list(CASES))
def test_streaming_matches_reference(corpus, name):
    got, want, sched = run_case(name, corpus)
    assert_same(got, want, name)
    assert_same_schedule(got, sched, name)
    assert got.result.compiles == 0         # nothing is captured on the CPU
    np.testing.assert_array_equal(got.result.lengths, want.result.lengths)


@pytest.mark.parametrize("async_on", [False, True])
def test_zero_length_tenants_drain_at_admission(async_on):
    traces = {"a": mixed(300, 0.3, 0.4, 0.3, seed=1),
              "b": np.empty((0,), np.int32),
              "c": mixed(200, 0.3, 0.4, 0.3, seed=2),
              "d": np.empty((0,), np.int32)}
    got = pc.sweep_streaming(PCFG, traces, lane_width=2, chunk=CHUNK,
                             async_producer=async_on, device="cpu")
    want, sched = reference(traces, None, 2, async_on)
    assert_same(got, want, "zero-length tenants")
    assert_same_schedule(got, sched, "zero-length tenants")
    assert list(got.result.stats.requests) == [300, 0, 200, 0]


def test_pipeline_telemetry_keys(corpus):
    for name in ("w9-offline-async", "w4-onoff-sync"):
        got, want, _ = run_case(name, corpus)
        st = got.streaming_stats()
        assert set(st) == set(want.streaming_stats())
        p = st["pipeline"]
        assert set(p) == {"produce_s", "consume_s", "drain_s", "wall_s",
                          "producer_stalls", "consumer_stalls", "overlap"}
        assert p["wall_s"] >= 0 and 0.0 <= p["overlap"] <= 1.0
        assert p["producer_stalls"] >= 0 and p["consumer_stalls"] >= 0
        assert st["async_producer"] is CASES[name][2]


def test_pipeline_quick_matches_the_baseline_rows():
    """chip_smoke.py's streaming phase (a), sync, on the CPU: every
    deterministic field of the ``pipeline_quick`` rows; its geometry is
    ``benchmarks/serving_bench.py``'s."""
    import chip_smoke
    from benchmarks import serving_bench
    assert chip_smoke.PIPE_QUICK == serving_bench.PIPE_SCALES["quick"]
    assert config_from(serving_bench.PIPE_CFG) == chip_smoke.pipe_config()
    rows = [r for r in json.loads(BASELINE.read_text())["streaming"]
            if r["job"] == "pipeline_quick" and r["config"] == "sync"]
    assert len(rows) == 1
    _, st = chip_smoke.pipeline_job("cpu", async_producer=False,
                                    warm=False)
    for k in chip_smoke.PIPE_KEYS:
        assert st[k] == rows[0][k], k
    assert st["async_producer"] is False


# ---------------------------------------------------------------------------
# the ring buffer and the engine's boundary
# ---------------------------------------------------------------------------

def ring_bounds():
    ring = RingBuffer(depth=2)
    assert ring.empty and not ring.full and len(ring) == 0
    ring.push("a")
    ring.push("b")
    assert ring.full and len(ring) == 2
    with pytest.raises(RuntimeError, match="full"):
        ring.push("c")
    assert ring.pop() == "a" and ring.pop() == "b"
    with pytest.raises(RuntimeError, match="empty"):
        ring.pop()


def ring_closed():
    ring = RingBuffer(depth=2)
    ring.push("a")
    ring.close()
    assert ring.closed
    with pytest.raises(RuntimeError, match="closed"):
        ring.push("b")
    assert ring.pop(block=True) == "a"
    assert ring.pop(block=True) is None


def ring_slow_consumer():
    # the producer fills the depth-1 ring and blocks on later pushes
    ring = RingBuffer(depth=1)

    def producer():
        for i in range(5):
            ring.push(i, block=True)
        ring.close()

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    got = []
    while True:
        time.sleep(0.02)
        item = ring.pop(block=True)
        if item is None:
            break
        got.append(item)
    t.join()
    assert got == list(range(5))
    assert ring.push_stalls >= 1 and ring.pop_stalls == 0


def ring_slow_producer():
    ring = RingBuffer(depth=4)

    def producer():
        time.sleep(0.05)
        ring.push("x", block=True)
        ring.close()

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    assert ring.pop(block=True) == "x"
    assert ring.pop(block=True) is None
    t.join()
    assert ring.pop_stalls >= 1


@pytest.mark.parametrize("case", [ring_bounds, ring_closed,
                                  ring_slow_consumer, ring_slow_producer],
                         ids=lambda f: f.__name__)
def test_ring_buffer(case):
    case()


def _two_traces():
    return {"a": mixed(60, 0.3, 0.4, 0.3, seed=1),
            "b": mixed(40, 0.3, 0.4, 0.3, seed=2)}


BAD_ARGUMENTS = (
    [(dict(ring_depth=d), "ring.?depth") for d in (0, -1, 2.5, "4", None,
                                                    True)]
    + [(dict(async_producer=f), "async_producer") for f in ("yes", 1, None)]
    + [(dict(arrivals=[np.zeros(1, np.int64)]), "one array per trace"),
       (dict(arrivals=[np.zeros(3, np.int64), None]), "shape"),
       (dict(arrivals=[np.arange(60)[::-1], None]), "nondecreasing"),
       (dict(unroll=0), "unroll")])


@pytest.mark.parametrize("kw,match", BAD_ARGUMENTS,
                         ids=[f"{next(iter(k))}={next(iter(k.values()))!r}"
                              for k, _ in BAD_ARGUMENTS])
def test_boundary_validation(kw, match):
    with pytest.raises(ValueError, match=match):
        pc.sweep_streaming(PCFG, _two_traces(), device="cpu", **kw)


@pytest.mark.parametrize("depth", [0, -3])
def test_ring_buffer_depth_validated(depth):
    with pytest.raises(ValueError, match="depth"):
        RingBuffer(depth=depth)


def test_producer_errors_propagate(monkeypatch):
    with pytest.raises(ValueError):
        pc.sweep_streaming(PCFG, [np.array(["x", "y"], object)],
                           device="cpu")

    def broken(*args, **kw):
        raise RuntimeError("staging failed")

    # an error in the producer thread comes out of the call
    with monkeypatch.context() as m:
        m.setattr(psweep, "_Slab", broken)
        with pytest.raises(RuntimeError, match="staging failed"):
            pc.sweep_streaming(PCFG, _two_traces(), lane_width=1, chunk=16,
                               async_producer=True, device="cpu")
    # and the engine stays usable
    out = pc.sweep_streaming(PCFG, _two_traces(), lane_width=1, chunk=16,
                             device="cpu")
    assert list(out.result.stats.requests) == [60, 40]


# ---------------------------------------------------------------------------
# the chunk runner on the CPU, and the card's absence
# ---------------------------------------------------------------------------

def test_masked_reset_is_in_place():
    runner = pc.chunk_runner(PCFG, device="cpu")
    carry = runner.init_batched(3)
    rng = np.random.default_rng(0)
    for leaf in psweep._leaves(carry):
        leaf.copy_(torch.as_tensor(
            rng.integers(-5, 50, leaf.shape).astype(np.int32)))
    before = [leaf.clone() for leaf in psweep._leaves(carry)]
    ptrs = [leaf.data_ptr() for leaf in psweep._leaves(carry)]
    template = runner.init_batched(3)
    out = psweep._masked_reset(carry, template,
                               torch.tensor([True, False, True]))
    assert out is carry
    for leaf, old, t, p in zip(psweep._leaves(carry), before,
                               psweep._leaves(template), ptrs):
        assert leaf.data_ptr() == p
        assert torch.equal(leaf[[0, 2]], t[[0, 2]])
        assert torch.equal(leaf[1], old[1])


def test_cpu_runner_captures_nothing():
    psweep.reset_runners()
    runner = pc.chunk_runner(PCFG, unroll=8, device="cpu")
    assert runner is pc.chunk_runner(PCFG, unroll=8, device="cpu")
    res = pc.sweep(PCFG, np.stack([mixed(50, seed=1), mixed(50, seed=2)]),
                   chunk=16, unroll=8, device="cpu")
    assert res.compiles == 0 and runner.captures == 0 and runner.replays == 0
    assert pc.compile_count(PCFG, 8, device="cpu") == 0
    psweep.reset_runners()
    assert pc.chunk_runner(PCFG, unroll=8, device="cpu") is not runner


def test_sweep_streaming_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pc.sweep_streaming(PCFG, _two_traces())
