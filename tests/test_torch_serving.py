"""The port's serving slice against the reference: the tiered paged-KV
cache and the continuous-batching engine.

The same seeds and page streams go through ``repro.cache.tiered`` /
``repro.launch.serve`` and ``repro_torch.cache.tiered`` /
``repro_torch.launch.serve`` on the CPU (the reference's decode kernel
in Pallas interpret mode, the port's through its plain version):

* ``TieredStats`` equal after ``access`` streams, with and without
  MITHRIL, at the geometries of ``tests/test_tiered.py``; eviction
  stays within capacity; slot choices equal on tie-heavy LRU stamps
  (numpy's default ``argsort`` does not keep ties in index order, so a
  stable sort would evict other slots);
* ``attend`` / ``attend_batch`` outputs within rtol = atol = 2e-5;
* every deterministic engine metric equal; idle fast-forward; the
  validation errors;
* the quick-scale ``serving`` rows of
  ``results/bench/BENCH_baseline_quick.json`` reproduced;
* a reference tier carried across mid-stream (``convert.tier_from``)
  continues with the reference's counters;
* ``chip_smoke.py``'s copy of the serving workload equals
  ``benchmarks.serving_bench.build_workload``.
"""

import dataclasses
import importlib.util
import json
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks import serving_bench
from repro.cache.tiered import TieredKVCache as RefTier
from repro.core import MithrilConfig as RefConfig
from repro.launch.serve import TieredServeEngine as RefEngine

from repro_torch.cache.tiered import TieredKVCache
from repro_torch.convert import config_from, tier_from
from repro_torch.kernels import ops
from repro_torch.launch.serve import TieredServeEngine

ROOT = pathlib.Path(__file__).resolve().parents[1]
MCFG = RefConfig(min_support=2, max_support=8, lookahead=30,
                 rec_buckets=256, rec_ways=4, mine_rows=32,
                 pf_buckets=256, pf_ways=4, prefetch_list=3)
DETERMINISTIC = ("requests", "tokens", "steps", "mean_batch_occupancy",
                 "turnaround_steps_p50", "turnaround_steps_p95",
                 "turnaround_steps_p99", "tier")


def tiers(mithril=True, seed=0, **kw):
    ref = RefTier(**kw, mithril_cfg=MCFG if mithril else None, seed=seed)
    port = TieredKVCache(**kw, mithril_cfg=config_from(MCFG) if mithril
                         else None, seed=seed, device="cpu")
    return ref, port


def request_page_stream(rng, n_requests=12, pages_per_req=4, rounds=30,
                        n_pages=200):
    """Multi-tenant decode (``tests/test_tiered.py``'s stream)."""
    reqs = [rng.choice(n_pages, pages_per_req, replace=False)
            for _ in range(n_requests)]
    return [reqs[r] for _ in range(rounds)
            for r in rng.permutation(n_requests)]


def assert_same_tier(port, ref):
    assert port.stats == type(port.stats)(**dataclasses.asdict(ref.stats))
    assert port.clock == ref.clock
    assert port.page_slot == {int(k): int(v) for k, v in ref.page_slot.items()}
    for name in ("slot_page", "slot_stamp", "slot_pf", "slot_sc"):
        np.testing.assert_array_equal(getattr(port, name), getattr(ref, name))


@pytest.mark.parametrize("mithril", [False, True])
def test_tier_stats_equal_after_access_streams(mithril):
    kw = dict(n_host_pages=200, n_hbm_slots=24, page_size=8, n_kv=2,
              head_dim=16)
    ref, port = tiers(mithril, **kw)
    np.testing.assert_array_equal(port.host_k.numpy(), ref.host_k)
    np.testing.assert_array_equal(port.host_v.numpy(), ref.host_v)
    for pages in request_page_stream(np.random.default_rng(3)):
        np.testing.assert_array_equal(port.access(pages), ref.access(pages))
    assert_same_tier(port, ref)
    if mithril:
        assert port.stats.prefetch_used > 0
    np.testing.assert_array_equal(port.hbm_k.numpy(), ref.hbm_k)
    np.testing.assert_array_equal(port.hbm_v.numpy(), ref.hbm_v)


def test_eviction_respects_capacity():
    kw = dict(n_host_pages=100, n_hbm_slots=8, page_size=4, n_kv=1,
              head_dim=8)
    ref, port = tiers(**kw)
    for pages in request_page_stream(np.random.default_rng(4),
                                     n_requests=6, pages_per_req=3,
                                     rounds=10, n_pages=100):
        port.access(pages)
        ref.access(pages)
    assert len(port.page_slot) <= 8
    for page, slot in port.page_slot.items():
        assert port.slot_page[slot] == page
    assert_same_tier(port, ref)


@pytest.mark.parametrize("n_slots", [13, 64, 704, 4096])
def test_eviction_on_tied_stamps_equals_reference(n_slots):
    """Stamps tie whenever a demand install and its prefetches share one
    clock value; the port must take numpy's own ``argsort`` order there,
    as the reference does."""
    rng = np.random.default_rng(n_slots)
    kw = dict(n_host_pages=4 * n_slots, n_hbm_slots=n_slots, page_size=1,
              n_kv=1, head_dim=1)
    ref, port = tiers(False, **kw)
    for _ in range(20):
        stamps = rng.integers(0, 4, n_slots).astype(np.int64)
        pages = rng.choice(4 * n_slots, n_slots, replace=False)
        pf = rng.random(n_slots) < 0.3
        sc = rng.random(n_slots) < 0.5
        for t in (ref, port):
            t.slot_stamp[:] = stamps
            t.slot_page[:] = pages
            t.slot_pf[:] = pf
            t.slot_sc[:] = sc
            t.clock = 9
        assert port._evict_slot() == ref._evict_slot()
        np.testing.assert_array_equal(port.slot_stamp, ref.slot_stamp)
        np.testing.assert_array_equal(port.slot_sc, ref.slot_sc)


def test_attend_matches_reference():
    kw = dict(n_host_pages=32, n_hbm_slots=16, page_size=8, n_kv=2,
              head_dim=16)
    ref, port = tiers(**kw)
    pages = np.array([3, 7, 11])
    q = np.random.default_rng(6).standard_normal((8, 16)).astype(np.float32)
    want = ref.attend(jnp.asarray(q), pages, length=20)
    got = port.attend(torch.from_numpy(q), pages, length=20)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)
    assert_same_tier(port, ref)


def test_attend_batch_matches_reference():
    kw = dict(n_host_pages=64, n_hbm_slots=32, page_size=8, n_kv=2,
              head_dim=16)
    ref, port = tiers(**kw)
    page_lists = [np.array([3, 7, 11, 2]), np.array([40, 5]),
                  np.array([11, 60, 9])]
    lengths = np.array([len(p) * 8 for p in page_lists])
    lengths[1] -= 3                         # not a page multiple
    q = np.random.default_rng(8).standard_normal((3, 8, 16)).astype(
        np.float32)
    for _ in range(2):
        want = ref.attend_batch(jnp.asarray(q), page_lists, lengths)
        got = port.attend_batch(torch.from_numpy(q), page_lists, lengths)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=2e-5, atol=2e-5)
    assert port.stats.accesses == 2 * sum(len(p) for p in page_lists)
    assert_same_tier(port, ref)


def test_attend_batch_validates():
    port = TieredKVCache(n_host_pages=16, n_hbm_slots=4, page_size=4,
                         n_kv=1, head_dim=8, device="cpu")
    q = torch.zeros((2, 4, 8))
    with pytest.raises(ValueError, match="one page list per query"):
        port.attend_batch(q, [np.array([0, 1])], np.array([8]))
    too_big = [np.array([0, 1, 2]), np.array([3, 4, 5])]
    with pytest.raises(ValueError, match="HBM pool"):
        port.attend_batch(q, too_big, np.array([12, 12]))


def engines(max_batch=4, seed=0):
    kw = dict(n_host_pages=64, n_hbm_slots=32, page_size=4, n_kv=1,
              head_dim=8)
    ref, port = tiers(seed=seed, **kw)
    return (RefEngine(ref, max_batch=max_batch, n_q_heads=2, seed=seed),
            TieredServeEngine(port, max_batch=max_batch, n_q_heads=2,
                              seed=seed))


def submit_workload(eng, rng):
    """``tests/test_tiered.py::_submit_workload``."""
    arrivals = [0, 0, 1, 3, 3, 7, 12, 12]
    steps = [5, 2, 7, 3, 4, 2, 6, 3]
    for rid, (t, k) in enumerate(zip(arrivals, steps)):
        eng.submit(rid, rng.choice(64, 3, replace=False), k, arrival=t)
    return sum(steps)


@pytest.mark.parametrize("max_batch", [1, 3])
def test_engine_metrics_equal_reference(max_batch):
    ref_eng, port_eng = engines(max_batch=max_batch)
    want_tokens = submit_workload(ref_eng, np.random.default_rng(7))
    submit_workload(port_eng, np.random.default_rng(7))
    want, got = ref_eng.run(), port_eng.run()
    assert set(got) == set(want)
    for key in DETERMINISTIC:
        assert got[key] == want[key], key
    assert got["tokens"] == want_tokens and got["requests"] == 8
    assert max(port_eng.occupancy) <= max_batch
    assert got["throughput_tok_s"] > 0 and got["wall_seconds"] > 0


def test_engine_fast_forwards_idle_gaps():
    ref_eng, port_eng = engines(max_batch=2)
    for eng in (ref_eng, port_eng):
        rng = np.random.default_rng(1)
        eng.submit(0, rng.choice(64, 2, replace=False), 2, arrival=0)
        eng.submit(1, rng.choice(64, 2, replace=False), 2, arrival=500)
    want, got = ref_eng.run(), port_eng.run()
    assert got["requests"] == 2 and got["steps"] == 4
    assert port_eng.clock == ref_eng.clock >= 500
    for key in DETERMINISTIC:
        assert got[key] == want[key], key


def test_engine_validates():
    _, eng = engines()
    with pytest.raises(ValueError, match="decode_steps"):
        eng.submit(0, np.array([1]), 0)
    eng.submit(0, np.array([1]), 1, arrival=5)
    with pytest.raises(ValueError, match="arrival order"):
        eng.submit(1, np.array([2]), 1, arrival=3)
    with pytest.raises(ValueError, match="max_batch"):
        TieredServeEngine(eng.tier, max_batch=0)


def test_quick_serving_baseline_rows_reproduced():
    rows = {r["config"]: r for r in json.loads(
        (ROOT / "results/bench/BENCH_baseline_quick.json").read_text()
    )["serving"]}
    geo = serving_bench.SCALES["quick"]
    ops.reset_launch_counts()
    for config, mithril in (("lru_tier", False), ("mithril_tier", True)):
        tier = TieredKVCache(geo["n_host_pages"], geo["n_hbm_slots"],
                             **serving_bench.PAGE,
                             mithril_cfg=(config_from(serving_bench.MCFG)
                                          if mithril else None),
                             device="cpu")
        eng = TieredServeEngine(tier, max_batch=geo["max_batch"],
                                n_q_heads=4)
        for arrival, rid, pages, steps in serving_bench.build_workload(geo):
            eng.submit(rid, pages, steps, arrival=arrival)
        got = eng.run()
        for key in DETERMINISTIC:
            assert got[key] == rows[config][key], (config, key)
    assert ops.launch_counts() == {k: 0 for k in ops.KERNELS}


def test_tier_resumed_from_reference_mid_stream():
    kw = dict(n_host_pages=200, n_hbm_slots=24, page_size=8, n_kv=2,
              head_dim=16)
    ref = RefTier(**kw, mithril_cfg=MCFG)
    stream = request_page_stream(np.random.default_rng(9))
    half = len(stream) // 2
    for pages in stream[:half]:
        ref.access(pages)
    port = tier_from(ref, device="cpu")
    assert_same_tier(port, ref)
    np.testing.assert_array_equal(port.hbm_k.numpy(), ref.hbm_k)
    assert int(port._mstate.n_mines[0]) == int(ref._mstate.n_mines) > 0
    for pages in stream[half:]:
        np.testing.assert_array_equal(port.access(pages), ref.access(pages))
    assert_same_tier(port, ref)
    q = np.random.default_rng(2).standard_normal((2, 8, 16)).astype(
        np.float32)
    page_lists = [stream[-1], stream[-2]]
    lengths = np.array([32, 29])
    np.testing.assert_allclose(
        port.attend_batch(torch.from_numpy(q), page_lists, lengths).numpy(),
        np.asarray(ref.attend_batch(jnp.asarray(q), page_lists, lengths)),
        rtol=2e-5, atol=2e-5)


def load_chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_workload_equals_serving_bench():
    chip_smoke = load_chip_smoke()
    assert chip_smoke.SERVING_PAGE == serving_bench.PAGE
    assert chip_smoke.serving_mcfg() == config_from(serving_bench.MCFG)
    for scale in ("quick", "full"):
        assert chip_smoke.SERVING_SCALES[scale] == \
            serving_bench.SCALES[scale], scale
    geos = [serving_bench.SCALES["quick"], serving_bench.SCALES["full"],
            chip_smoke.full_width_geometry()]
    for geo in geos:
        want = serving_bench.build_workload(geo)
        got = chip_smoke.build_workload(geo)
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert a[0] == b[0] and a[1] == b[1] and a[3] == b[3]
            np.testing.assert_array_equal(a[2], b[2])
