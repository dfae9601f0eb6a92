"""The port's cost model against the reference's arithmetic, on the CPU.

* ``model_flops``, ``attention_extra``, ``rwkv_chunk_extra`` and the
  ``Roofline`` properties float-equal to the reference's, on every
  reduced and published config and every shape, and on
  ``tests/test_roofline.py``'s geometries; the reference's four
  ``KERNEL_MODELS`` float-equal on its geometries.
* The card's touched-byte bounds (``roofline.touched``) on warm CPU
  states: under the copy-through models, exact where the count is
  known (no enabled lane, no lane to mine, distinct full pages).
* ``machine_peaks``: an H100 SXM's published peaks trusted, the
  reference's TPU constants trusted, anything else (this CPU included)
  untrusted nominal peaks.
* A dry run of reduced llama3.2-3b's train and prefill cells on a fake
  8-rank (2, 4) mesh, in a spawned process: every device does at least
  its share of the model's flops and at most 4x it (remat's recompute,
  attention, the float32 head, work the model axis cannot split), and
  the step all-gathers and reduces.
"""

import json
import math
import multiprocessing as mp
import os
import sys

import numpy as np
import pytest
import torch

import repro.core as ref_core
from repro.configs import ARCHS as REF_ARCHS
from repro.configs import SHAPES as REF_SHAPES
from repro.configs import reduced_config as ref_reduced
from repro.roofline import analysis as ra

import repro_torch.core as port_core
from repro_torch.configs import ARCHS, SHAPES, reduced_config
from repro_torch.convert import config_from
from repro_torch.core.hashindex import bucket_index
from repro_torch.kernels.hash_lookup import hash_lookup_plain
from repro_torch.roofline import analysis as pa
from repro_torch.roofline import touched as tb

sys.path.insert(0, os.path.dirname(__file__))
import _torch_dist_worker as worker  # noqa: E402

REF_GEOMS = {
    "mithril_record_fused": dict(lanes=4, n_buckets=16, ways=2, r_sup=2,
                                 mine_rows=16, s_sup=4),
    "mithril_mine_batched": dict(lanes=2, mine_rows=256, s_sup=8,
                                 window=32),
    "hash_lookup": dict(queries=256, n_buckets=128, ways=4, plist=3),
    "paged_decode": dict(batch=4, heads_q=32, heads_kv=8, head_dim=128,
                         page_size=16, n_pages=8),
}
# chip_smoke.py's serving_mcfg (benchmarks/serving_bench.py's MCFG)
SERVING = dict(min_support=2, max_support=8, lookahead=40, rec_buckets=512,
               rec_ways=4, mine_rows=8, pf_buckets=512, pf_ways=4,
               prefetch_list=3)


def configs():
    for arch in sorted(ARCHS):
        yield arch, "reduced", reduced_config(ARCHS[arch]), ref_reduced(
            REF_ARCHS[arch])
        yield arch, "full", ARCHS[arch], REF_ARCHS[arch]


CONFIGS = list(configs())


@pytest.mark.parametrize("i", range(len(CONFIGS)),
                         ids=[f"{a}-{k}" for a, k, _, _ in CONFIGS])
def test_cell_arithmetic_equals_reference(i):
    _, _, cfg, ref_cfg = CONFIGS[i]
    geoms = [(s.global_batch, s.seq_len, s.kind) for s in SHAPES.values()]
    geoms += [(2, 128, "train"), (3, 96, "prefill"), (1, 64, "decode"),
              (4, 1024, "train")]
    for b, s, kind in geoms:
        assert pa.model_flops(cfg, kind, b, s) == ra.model_flops(
            ref_cfg, kind, b, s)
        for n_dev in (1, 256):
            assert pa.attention_extra(cfg, b, s, s, kind, n_dev) == \
                ra.attention_extra(ref_cfg, b, s, s, kind, n_dev)
            assert pa.rwkv_chunk_extra(cfg, b, s, kind, n_dev) == \
                ra.rwkv_chunk_extra(ref_cfg, b, s, kind, n_dev)
    assert {k: v.name for k, v in SHAPES.items()} == {
        k: v.name for k, v in REF_SHAPES.items()}


def test_roofline_properties_equal_reference():
    for flops, bytes_, coll in ((1e15, 1e12, 1e9), (1e12, 1e13, 0.0),
                                (1e9, 1e6, 1e12)):
        kw = dict(arch="a", shape="s", mesh="m", flops_dev=flops,
                  bytes_dev=bytes_, coll_dev=coll, n_dev=256,
                  model_flops=1e17)
        got, want = pa.Roofline(**kw).to_dict(), ra.Roofline(**kw).to_dict()
        assert {k: got[k] for k in want} == want
    h100 = pa.Roofline(**kw, peak_flops=pa.H100_PEAK_FLOPS,
                       peak_bw=pa.H100_HBM_BW, link_bw=pa.H100_LINK_BW)
    assert h100.compute_s == kw["flops_dev"] / 989e12


@pytest.mark.parametrize("name", sorted(REF_GEOMS))
def test_reference_kernel_models_equal(name):
    got = pa.analyze_kernel(name, REF_GEOMS[name], "cpu").to_dict()
    want = ra.analyze_kernel(name, REF_GEOMS[name], "cpu").to_dict()
    assert {k: got[k] for k in want} == want
    doubled = dict(REF_GEOMS[name])
    key = next(iter(doubled))
    doubled[key] *= 2
    assert pa.KERNEL_MODELS[name](doubled) == ra.KERNEL_MODELS[name](doubled)


def warm_state(cfg, lanes, n_events=300, seed=0):
    """A state whose lanes have recorded and mined a multi-tenant page
    stream (``miss_step_plain`` on lane 0's stream, each lane its own)."""
    rng = np.random.default_rng(seed)
    sets = rng.choice(200, size=(10, 4), replace=False)
    st = port_core.init_state(cfg, "cpu", lanes=lanes)
    for i in range(n_events):
        blk = torch.as_tensor(sets[rng.integers(10, size=lanes), i % 4],
                              dtype=torch.int32)
        port_core.record(cfg, st, blk)
    return st


def clone(st):
    return type(st)(*(x.clone() for x in st))


@pytest.mark.parametrize("kernel", ["record", "miss", "mine_step", "lookup",
                                    "decode", "pairwise"])
def test_touched_bounds(kernel):
    """The card's bounds count what one call's data needs: never more
    than the reference's copy-through model of the same geometry, and
    exactly the flags alone for a call with nothing to do."""
    cfg = config_from(ref_core.MithrilConfig(**SERVING))
    ct = pa.KERNEL_MODELS
    if kernel == "record":
        st = warm_state(cfg, 4)
        blk = torch.tensor([3, 17, 40, 199], dtype=torch.int32)
        copy = ct["mithril_record_fused"](dict(
            lanes=4, n_buckets=cfg.rec_buckets, ways=cfg.rec_ways,
            r_sup=cfg.min_support, mine_rows=cfg.mine_rows,
            s_sup=cfg.max_support))[0]
        by = tb.record_event_bytes(cfg, clone(st), blk,
                                   torch.ones(4, dtype=torch.int32))
        assert 4 * 4 * (3 + 2 * cfg.rec_ways) < by < copy / 100
        assert tb.record_event_bytes(cfg, st, blk, torch.zeros(
            4, dtype=torch.int32)) == 4.0 * 4
        assert tb.record_ops(cfg, 4) == 4 * ct["mithril_record_fused"](
            dict(lanes=1, n_buckets=1, ways=cfg.rec_ways,
                 r_sup=cfg.min_support, mine_rows=1,
                 s_sup=cfg.max_support))[1]
    elif kernel == "miss":
        st = warm_state(cfg, 1)
        for page in (3, 150, 1000):
            a, b = clone(st), clone(st)
            blk = torch.tensor([page], dtype=torch.int32)
            found = bool((a.pf_key[0, bucket_index(blk, cfg.pf_buckets)]
                          == page).any())
            want = tb.record_event_bytes(cfg, b, blk, torch.ones(
                1, dtype=torch.int32)) - 8 + 4 * (
                cfg.pf_ways + cfg.prefetch_list * found + 1
                + cfg.prefetch_list)
            assert tb.miss_event_bytes(cfg, a, page) == want
            for x, y in zip(a, b):       # both advanced by the event
                assert torch.equal(x, y)
        assert tb.miss_ops(cfg) == tb.record_ops(cfg, 1) + 12 + cfg.pf_ways
    elif kernel == "mine_step":
        st = warm_state(cfg, 3)
        before = clone(st)
        need = torch.tensor([1, 0, 1], dtype=torch.int32)
        by, ops, pairs = tb.mine_step_work(cfg, st, need)
        for x, y in zip(st, before):     # the state is left as it was
            assert torch.equal(x, y)
        assert by > 3 + 4 * 2 * (2 * cfg.mine_rows + 5) and ops > 0
        assert pairs >= 0
        assert tb.mine_step_work(cfg, st, torch.zeros(
            3, dtype=torch.int32)) == (3.0, 0.0, 0)
    elif kernel == "lookup":
        st = warm_state(cfg, 1)
        q = torch.arange(0, 256, dtype=torch.int32)
        key, vals = st.pf_key[0], st.pf_vals[0]
        hits = int((hash_lookup_plain(q, key, vals) != -1).any(-1).sum())
        assert hits > 0
        by = tb.lookup_bytes(q, key, vals)
        w, p = cfg.pf_ways, cfg.prefetch_list
        assert by == 4.0 * (256 * (1 + w + p) + hits * p)
        assert by < ct["hash_lookup"](dict(queries=256,
                                           n_buckets=cfg.pf_buckets,
                                           ways=w, plist=p))[0]
        assert tb.lookup_ops(256, w) == 256 * (12.0 + w)
    elif kernel == "decode":
        b, hq, hkv, hd, ps, npg = 3, 8, 2, 16, 4, 5
        pool = torch.zeros((b * npg, ps, hkv, hd))
        q = torch.zeros((b, hq, hd))
        tab = torch.arange(b * npg, dtype=torch.int32).reshape(b, npg)
        full = torch.full((b,), npg * ps, dtype=torch.int32)
        copy = ct["paged_decode"](dict(batch=b, heads_q=hq, heads_kv=hkv,
                                       head_dim=hd, page_size=ps,
                                       n_pages=npg))
        # distinct full pages in float32: the copy-through traffic, plus
        # the page table and lengths
        assert tb.decode_bytes(q, pool, tab, full) == copy[0] + 4 * b * (
            npg + 1)
        assert tb.decode_ops(q, full) == copy[1]
        assert tb.decode_bytes(q, pool, tab, full // 2) < copy[0]
        shared = torch.zeros_like(tab)   # every row reads the same page
        assert tb.decode_bytes(q, pool, shared, full) < copy[0] / b
    else:
        geo = dict(lanes=2, mine_rows=64, s_sup=8, window=16)
        by = tb.pairwise_bytes(2, 64, 8, 16)
        assert by < ct["mithril_mine_batched"](geo)[0]
        assert tb.pairwise_ops(2, 64, 8, 16) == \
            ct["mithril_mine_batched"](geo)[1]
    assert tb.bound_ms(3.35e9, 1.0) == (1.0, "bytes")
    assert tb.bound_ms(1.0, 67e9) == (1.0, "operations")


@pytest.mark.parametrize("kernel", ["cache_access", "mithril_prefetch"])
def test_cache_set_work(kernel):
    """The cache-set kernels' bounds advance the carry exactly as the
    plain version does, count the flags alone (and no operation) for a
    launch with every lane invalid, and on valid lanes at least each
    lane's block and the W keys of the sets it probes."""
    import dataclasses
    from repro_torch.cache import SimConfig, build_segments
    from repro_torch.cache.base import pack_cache
    from repro_torch.cache.simulator import (cache_access_plain,
                                             mithril_prefetch_plain)
    mcfg = dataclasses.replace(config_from(ref_core.MithrilConfig(
        **SERVING)), pf_buckets=16, record_on="miss")
    cfg = SimConfig(capacity=64, ways=4, use_mithril=True, mithril=mcfg)
    init, _ = build_segments(cfg, "cpu")
    lanes = 3
    carry = init(lanes)
    carry["mith"].pf_key[:, :, 0] = torch.arange(16, dtype=torch.int32)
    carry["mith"].pf_vals[:, :, 0] = torch.arange(16, 32)[:, None]
    work = getattr(tb, f"{kernel}_work")
    rng = np.random.default_rng(5)
    for _ in range(40):
        blk = torch.as_tensor(rng.integers(0, 40, lanes).astype(np.int32))
        val = torch.as_tensor(rng.random(lanes) < 0.8)
        ours = {k: type(v)(*(x.clone() for x in v)) for k, v in carry.items()}
        ours["cache"] = pack_cache(*ours["cache"])
        if kernel == "cache_access":
            cache_access_plain(carry["cache"], carry["stats"], blk, val,
                               "lru", carry["mith"], "miss", mcfg.mine_rows)
        else:
            mithril_prefetch_plain(carry["cache"], carry["stats"],
                                   carry["mith"], blk, val, mcfg)
        by, ops = work(cfg, ours, blk, val)
        for part in carry:
            for x, y in zip(ours[part], carry[part]):
                assert torch.equal(x, y)
        n = int(val.sum())
        assert by >= lanes + 4.0 * n * (1 + cfg.ways) and ops >= 0
        assert (ops > 0) == (n > 0)
    off = torch.zeros(lanes, dtype=torch.bool)
    flags = lanes * (16 if kernel == "cache_access" else 1)
    assert work(cfg, carry, blk, off) == (flags, 0.0)
    st = carry["stats"]
    assert int((st.hits if kernel == "cache_access" else st.pf_issued)
               .sum()) > 0


def test_machine_peaks_trust():
    tpu = pa.machine_peaks("tpu")
    assert tpu == pa.MachinePeaks("tpu", ra.PEAK_FLOPS, ra.HBM_BW, True)
    h100 = pa.machine_peaks("NVIDIA H100 80GB HBM3")
    assert h100.trusted and (h100.flops_per_s, h100.bytes_per_s) == (
        989e12, 3.35e12)
    for name in ("cpu", "gpu", "NVIDIA H100 PCIe", "NVIDIA A100-SXM4-80GB"):
        pk = pa.machine_peaks(name)
        want = ra.machine_peaks(name)
        assert not pk.trusted and (pk.flops_per_s, pk.bytes_per_s) == (
            want.flops_per_s, want.bytes_per_s)
    live = pa.machine_peaks()        # this container has no card
    assert live.backend == "cpu" and not live.trusted


def test_dry_run_of_a_reduced_cell(tmp_path):
    proc = mp.get_context("spawn").Process(target=worker.dryrun_main,
                                           args=(str(tmp_path),))
    proc.start()
    proc.join(timeout=300)
    if proc.is_alive():
        proc.kill()
    assert proc.exitcode == 0
    with open(tmp_path / "dryrun.json") as f:
        got = json.load(f)
    for kind, c in got.items():
        share = c["model_flops"] / 8
        assert share <= c["flops"] <= 4 * share, (kind, c["flops"] / share)
        assert c["bytes"] > 0 and c["argument_bytes"] > 0
        assert c["collective_counts"]["all-gather"] > 0
        assert sum(c["collective_bytes"].values()) > 0
    assert got["train"]["collective_counts"]["all-reduce"] > 0
    assert got["train"]["collective_counts"]["reduce-scatter"] > 0
