"""The port's lane-sharded sweep against the reference, on the CPU.

Lanes never communicate, so a sweep split into contiguous lane blocks,
one chunk runner per block (``devices=["cpu"] * n``: two runners on one
device keep their own carries), must give the ``Stats`` and hit curves
of the port's ``shard=False`` sweep and of the reference's
``shard=False`` sweep bit for bit; the reference's own sharded test
cannot run in this container. Plans place group widths on multiples of
the shard count, as the reference's packer does.
"""

import importlib

import numpy as np
import pytest
import torch

from repro.cache import sweep_scheduled as ref_sweep_scheduled
from repro.core import MithrilConfig
from repro.traces import mixed

import repro_torch.cache as pc
from repro_torch.convert import config_from


SHARD_MITHRIL = MithrilConfig(min_support=2, max_support=4, lookahead=20,
                              rec_buckets=128, rec_ways=2, mine_rows=16,
                              pf_buckets=128, pf_ways=2)


_SWEEPS = {}


def unsharded_sweeps():
    """The reference's and the port's ``shard=False`` sweeps of 8 traces
    (once per session)."""
    if not _SWEEPS:
        from repro.cache import SimConfig
        traces = {f"t{i}": mixed(250 + 111 * i, 0.3, 0.4, 0.3, seed=60 + i)
                  for i in range(8)}
        ref_cfg = SimConfig(capacity=64, use_mithril=True, use_amp=True,
                            mithril=SHARD_MITHRIL)
        cfg = config_from(ref_cfg)
        _SWEEPS.update(
            traces=traces, cfg=cfg,
            want=ref_sweep_scheduled(ref_cfg, traces, lane_width=8,
                                     chunk=128, shard=False),
            single=pc.sweep_scheduled(cfg, traces, lane_width=8, chunk=128,
                                      shard=False, device="cpu"))
    return _SWEEPS


@pytest.mark.parametrize("n_shards", [2, 4])
def test_sharded_sweep_bit_identical(n_shards):
    u = unsharded_sweeps()
    traces, cfg, want, single = u["traces"], u["cfg"], u["want"], u["single"]
    # MITHRIL mined and prefetched in the lanes
    assert int(np.asarray(single.stats.pf_issued)[:, pc.PF_MITHRIL].sum()) > 0
    sharded = pc.sweep_scheduled(cfg, traces, lane_width=8, chunk=128,
                                 device="cpu", devices=["cpu"] * n_shards)
    lane_shards = importlib.import_module(
        "repro_torch.cache.sweep")._lane_shards
    assert lane_shards(8, None, devices=["cpu"] * n_shards) == (
        torch.device("cpu"),) * n_shards
    for name, a, b, c in zip(want.stats._fields, want.stats, single.stats,
                             sharded.stats):
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a),
                                      err_msg=name)
        np.testing.assert_array_equal(np.asarray(c), np.asarray(a),
                                      err_msg=name)
    np.testing.assert_array_equal(sharded.hit_curve, single.hit_curve)
    np.testing.assert_array_equal(sharded.hit_curve,
                                  np.asarray(want.hit_curve))
    assert pc.compile_count(cfg, device="cpu", n_shards=n_shards) == 0
    # a width that does not divide runs on one device
    assert len(lane_shards(6, True, devices=["cpu"] * 4)) == 1
    assert len(lane_shards(8, False, devices=["cpu"] * 4)) == 1


def test_plan_sweep_widths_are_shard_multiples():
    from repro.cache import plan_sweep as ref_plan
    lengths = np.array([900, 850, 400, 390, 380, 120, 100, 90, 60, 30, 20])
    for n_shards in (1, 2, 4):
        got = pc.plan_sweep(lengths, lane_width=6, chunk=256,
                            n_shards=n_shards)
        want = ref_plan(lengths, lane_width=6, chunk=256, n_shards=n_shards)
        assert got.n_shards == want.n_shards == n_shards
        assert [g.lane_width for g in got.groups] == [
            g.lane_width for g in want.groups]
        assert all(g.lane_width % n_shards == 0 for g in got.groups)
        assert got.packer_stats() == want.packer_stats()
