"""The port's batched sweep against the JAX reference, bit for bit.

Every label of the benchmark grid (``benchmarks/common.py::configs``)
runs through ``repro_torch.cache.sweep_scheduled(device="cpu")`` and
``repro.cache.sweep_scheduled(..., shard=False)`` on the same traces;
every ``Stats`` leaf and the hit curves must be equal. MITHRIL runs
with small tables so the mining barrier fires
(``test_torch_sweep_mining.py`` drives it harder).
"""

import dataclasses

import numpy as np
import pytest
import torch

import repro.cache as rc
import repro.traces as rt
from benchmarks.common import configs
from repro.core import MithrilConfig

import repro_torch.cache as pc
import repro_torch.traces as pt
from repro_torch.convert import config_from, to_numpy

SMALL_MITHRIL = MithrilConfig(
    min_support=2, max_support=8, lookahead=100, prefetch_list=3,
    rec_buckets=64, rec_ways=4, mine_rows=8, pf_buckets=64, pf_ways=2,
    record_on="miss")
CAPACITY = 64
LABELS = list(configs(CAPACITY))


def grid_config(label: str):
    cfg = configs(CAPACITY)[label]
    if cfg.use_mithril:
        cfg = dataclasses.replace(cfg, mithril=SMALL_MITHRIL)
    return cfg


@pytest.fixture(scope="module")
def quick():
    return rt.corpus_suite("quick", 600)


def one_group_plan(mod, lengths):
    """One 16-lane group: the fewest steps, one compile per config."""
    kw = {} if mod is pc else {"n_shards": 1}
    return mod.plan_sweep(lengths, lane_width=len(lengths), max_shapes=1,
                          overhead_lanes=1e9, **kw)


def assert_stats_equal(got, want, msg=""):
    for name, g, w in zip(want._fields, got, want):
        g, w = np.asarray(g), np.asarray(w)
        assert g.dtype == w.dtype, (msg, name, g.dtype, w.dtype)
        np.testing.assert_array_equal(g, w, err_msg=f"{msg} {name}")


_REFERENCE = {}


def reference(label, quick):
    """The reference's sweep of the quick corpus, once per label."""
    if label not in _REFERENCE:
        _, blocks, lengths = quick
        _REFERENCE[label] = rc.sweep_scheduled(
            grid_config(label), blocks, lengths, shard=False,
            plan=one_group_plan(rc, lengths))
    return _REFERENCE[label]


@pytest.mark.parametrize("label", LABELS)
def test_sweep_scheduled_matches_reference(quick, label):
    _, blocks, lengths = quick
    want = reference(label, quick)
    # the reference packer's plan for one label (several groups,
    # reassembled in trace order), the default one-group plan for the rest
    plan = pc.plan_sweep(lengths) if label == "lru" else None
    got = pc.sweep_scheduled(config_from(grid_config(label)), blocks,
                             lengths, plan=plan, device="cpu")
    assert got.compiles == 0
    assert_stats_equal(got.stats, want.stats, label)
    np.testing.assert_array_equal(got.hit_curve, want.hit_curve)


@pytest.mark.parametrize("label", LABELS)
def test_simulate_matches_reference(quick, label):
    """``simulate`` on one trace (the shortest) at lane width 1."""
    _, blocks, lengths = quick
    i = int(np.argmin(lengths))
    want = reference(label, quick).result(i)
    got = pc.simulate(config_from(grid_config(label)),
                      blocks[i, : lengths[i]], device="cpu")
    assert_stats_equal(got.stats, want.stats, f"{label} simulate")
    np.testing.assert_array_equal(got.hit_curve, want.hit_curve)


def test_session_matches_simulate():
    cfg = config_from(grid_config("mithril-amp-lru"))
    trace = pt.mixed(300, seed=5)
    want = pc.simulate(cfg, trace, device="cpu")
    sess = pc.SimSession(cfg, device="cpu")
    for piece in np.split(trace, [7, 8, 150, 299]):
        sess.feed(piece)
    got = sess.finish()
    assert sess.requests_fed == 300
    assert_stats_equal(got.stats, want.stats)
    np.testing.assert_array_equal(got.hit_curve, want.hit_curve)


def test_serial_step_matches_simulate():
    """``build_step`` (per-lane ``maybe_mine`` at every barrier) gives
    the batched engine's results."""
    cfg = config_from(dataclasses.replace(grid_config("mithril-lru"),
                                          capacity=16))
    trace = pt.association_groups(300, n_groups=12, reuse=40, lba_space=512,
                                  seed=2)
    want = pc.simulate(cfg, trace, device="cpu")
    init, step = pc.build_step(cfg, device="cpu")
    carry, hits = init(1), []
    for blk in torch.as_tensor(trace):
        carry, hit = step(carry, blk[None])
        hits.append(bool(hit[0]))
    assert int(carry["mith"].n_mines[0]) > 0
    np.testing.assert_array_equal(np.array(hits), want.hit_curve)
    assert_stats_equal([x[0] for x in to_numpy(carry["stats"])], want.stats)


def test_sweep_grid_shares_equal_configs(quick):
    _, blocks, lengths = quick
    cfg = pc.SimConfig(capacity=CAPACITY)
    out = pc.sweep_grid({"a": cfg, "b": cfg, "c": pc.SimConfig(
        capacity=CAPACITY, policy="fifo")}, blocks[:4, :200],
        lengths=np.minimum(lengths[:4], 200), device="cpu")
    assert out["a"] is out["b"] and out["c"] is not out["a"]


@pytest.mark.parametrize("lane_width,chunk,max_shapes",
                         [(None, 4096, 2), (16, 4096, 2), (8, 512, 1),
                          (135, 512, 2), (5, 1000, 3)])
def test_plan_sweep_matches_reference(lane_width, chunk, max_shapes):
    for scale, n in [("quick", 4000), ("full", 50_000)]:
        lengths = np.array([s.n_requests for s in rt.corpus_specs(n, scale)])
        want = rc.plan_sweep(lengths, lane_width, chunk, n_shards=1,
                             max_shapes=max_shapes)
        got = pc.plan_sweep(lengths, lane_width, chunk,
                            max_shapes=max_shapes)
        assert got == want
        assert got.packer_stats() == want.packer_stats()


@pytest.mark.parametrize("lane_width", [None, 135, 40, 16, 1])
def test_wide_plan_groups_every_trace_longest_first(lane_width):
    """The default schedule: ceil(n / width) groups of consecutive
    longest-first traces, each trace once, padded to its first member."""
    lengths = np.array([s.n_requests for s in rt.corpus_specs(50_000,
                                                                "full")])
    plan = pc.wide_plan(lengths, lane_width, chunk=4096)
    w = len(lengths) if lane_width is None else min(lane_width,
                                                    len(lengths))
    assert len(plan.groups) == -(-len(lengths) // w)
    order = [i for g in plan.groups for i in g.indices]
    assert sorted(order) == list(range(len(lengths)))
    assert list(lengths[order]) == sorted(lengths, reverse=True)
    for g in plan.groups:
        assert g.lane_width == len(g.indices) <= w
        assert g.padded_t % g.chunk == 0
        assert lengths[g.indices[0]] <= g.padded_t < \
            lengths[g.indices[0]] + g.chunk
    assert plan.n_shards == 1 and plan.total_requests == lengths.sum()


@pytest.mark.parametrize("scale,n", [("quick", 600), ("quick", 4000),
                                     ("mid", 300)])
def test_corpus_suite_matches_reference(scale, n):
    got, want = pt.corpus_suite(scale, n), rt.corpus_suite(scale, n)
    assert got[0] == want[0]
    for g, w in zip(got[1:], want[1:]):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert [pt.family_of(k) for k in got[0]] == \
        [rt.family_of(k) for k in want[0]]


def test_quick_corpus_is_the_baselines_on_any_numpy():
    """The port draws zipf ranks itself, so the quick corpus that the
    checked-in baseline rows were computed on comes out the same under
    any numpy; its checksum is pinned in ``chip_smoke.py``."""
    import zlib
    from chip_smoke import QUICK_CORPUS_CRC32
    _, blocks, _ = pt.corpus_suite("quick", 4000)
    assert zlib.crc32(np.ascontiguousarray(blocks).tobytes()) == \
        QUICK_CORPUS_CRC32
    for seed, a in [(0, 1.05), (3, 1.1), (7, 1.7)]:
        np.testing.assert_array_equal(
            pt.synthetic.zipf_draws(np.random.default_rng(seed), a, 3000),
            np.random.default_rng(seed).zipf(a, 3000))


def test_padded_tail_is_inert():
    """Garbage past a trace's length changes nothing."""
    cfg = config_from(grid_config("mithril-lru"))
    blocks = np.stack([pt.mixed(200, seed=s) for s in range(3)])
    lengths = np.array([200, 120, 60])
    dirty = blocks.copy()
    for i, ln in enumerate(lengths):
        dirty[i, ln:] = np.arange(200 - ln) + 10 ** 6
        blocks[i, ln:] = 0
    a = pc.sweep(cfg, blocks, lengths, chunk=64, device="cpu")
    b = pc.sweep(cfg, dirty, lengths, chunk=64, device="cpu")
    assert_stats_equal(a.stats, b.stats)
    np.testing.assert_array_equal(a.stats.requests, lengths)
