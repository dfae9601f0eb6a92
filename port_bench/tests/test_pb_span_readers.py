"""The readers of the program's spans, counters and device events on
synthetic records and traces with known intervals; each gives ``None``
where its record or spans are missing (the CPU, a program without the
recorder, a run without ``--trace``)."""

import importlib.util
from pathlib import Path

import pytest

from pbench import records
from pbench.profile import Trace

METRICS = Path(__file__).resolve().parents[1] / "metrics"


def reader(name):
    spec = importlib.util.spec_from_file_location(
        f"pb_reader_{name.replace('.', '_')}", METRICS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


class FakeRecord:
    """What a reader reads of ``repro_torch.runtime.spans.Record``."""

    def __init__(self, profiled=False, spans=None, counters=None,
                 intervals=None, wall_s=1.0):
        self.profiled = profiled
        self.spans = spans or {}            # name -> (count, total s)
        self.counters = counters or {}
        self.intervals = intervals or {}
        self.wall_s = wall_s

    def count_of(self, name):
        return self.spans.get(name, (0, 0.0))[0]

    def total_s(self, name):
        return self.spans.get(name, (0, 0.0))[1]

    def device_intervals(self, name):
        return list(self.intervals.get(name, ()))


@pytest.fixture
def program(monkeypatch):
    """Hands the readers the records put in the returned list."""
    from repro_torch.runtime import spans
    recs = []
    monkeypatch.setattr(spans, "records", lambda: list(recs))
    return recs


def test_interval_arithmetic():
    assert records.merge([(3, 4), (0, 2), (1, 2.5), (5, 5)]) == [(0, 2.5),
                                                                (3, 4)]
    assert records.gaps([(1, 2), (3, 5)], 0, 4) == [(0, 1), (2, 3)]
    assert records.gaps([], 0, 4) == [(0, 4)]
    assert records.intersect([(0, 10)], [(2, 3), (8, 12)]) == [(2, 3),
                                                               (8, 10)]
    assert records.subtract([(0, 10)], [(2, 3), (8, 12)]) == [(0, 2),
                                                              (3, 8)]


def test_window_is_the_newest_unprofiled_record(program):
    assert records.window() is None
    a, b, traced = FakeRecord(), FakeRecord(), FakeRecord(profiled=True)
    program += [a, b, traced]
    assert records.window() is b


def test_window_idle_share(program):
    read = reader("window.idle_share")
    assert read({}) is None
    # replays at [0, 4] and [5, 9], a lane reset at [4, 4.5]: 0.5 of 9 idle
    program.append(FakeRecord(intervals={"replay": [(0, 4), (5, 9)],
                                         "lane_work": [(4, 4.5)]}))
    assert read({}) == pytest.approx(100 * 0.5 / 9)
    program.append(FakeRecord())            # the CPU records no event
    assert read({}) is None


def test_replay_launch_ms(program):
    read = reader("replay.launch_ms")
    program.append(FakeRecord(spans={"runner.run": (3, 1.0)}))
    assert read({}) is None
    program.append(FakeRecord(spans={"runner.replay": (4, 0.02)}))
    assert read({}) == pytest.approx(5.0)
    program.append(FakeRecord(profiled=True,
                              spans={"runner.replay": (1, 9.0)}))
    assert read({}) == pytest.approx(5.0)


def test_stream_starved_share(program):
    read = reader("stream.starved_share")
    assert read({}) is None
    program.append(FakeRecord(spans={"stream.consume": (10, 1.0)},
                              wall_s=2.0))
    assert read({}) == 0.0
    program.append(FakeRecord(spans={"stream.consume": (10, 1.0),
                                     "stream.ring_wait": (3, 0.05)},
                              wall_s=2.0))
    assert read({}) == pytest.approx(2.5)


def test_mining_runs_per_launch(program):
    read = reader("mining.runs_per_launch")
    program.append(FakeRecord(counters={"mining.runs": 7,
                                        "mining.launches": 0}))
    assert read({}) is None
    program.append(FakeRecord(counters={"mining.runs": 210,
                                        "mining.launches": 2048}))
    assert read({}) == pytest.approx(210 / 2048)


def test_idle_launch_share():
    read = reader("idle.launch_share")
    assert read({}) is None
    # span [0, 100]; busy [10, 40] and [60, 100]: idle [0, 10], [40, 60]
    device = [("k", 10, 40), ("k", 60, 100)]
    # the profiler flushes in [45, 50]; a replay covers [0, 5] and [42, 60]
    host = [("pbench.traced", 0, 100), ("runner.replay", 0, 5),
            ("runner.replay", 42, 60), ("cudaGraphLaunch", 42, 60),
            ("Buffer_Flush", 45, 50)]
    trace = Trace(device, host, (0, 100), 1e-7)
    # idle less the flush: 10 + 5 + 10 = 25; in a replay: 5 + 3 + 10 = 18
    assert read({"trace": trace}) == pytest.approx(100 * 18 / 25)
    # the card's profiler names its buffer events with spaces
    spaced = Trace(device, host[:-1] + [("Buffer Flush", 45, 50)],
                   (0, 100), 1e-7)
    assert read({"trace": spaced}) == pytest.approx(100 * 18 / 25)
    without = Trace(device, [e for e in host if e[0] != "runner.replay"],
                    (0, 100), 1e-7)
    assert read({"trace": without}) is None


def test_readers_without_the_recorder(monkeypatch):
    """A program that lacks ``repro_torch.runtime.spans`` (the parent of
    the change that added it) gives nothing and raises nothing."""
    import builtins
    real = builtins.__import__

    def no_spans(name, globals=None, locals=None, fromlist=(), level=0):
        if name == "repro_torch.runtime" and "spans" in (fromlist or ()):
            raise ImportError("no module named repro_torch.runtime.spans")
        return real(name, globals, locals, fromlist, level)

    monkeypatch.setattr(builtins, "__import__", no_spans)
    for name in ("window.idle_share", "replay.launch_ms",
                 "stream.starved_share", "mining.runs_per_launch"):
        assert reader(name)({}) is None, name
