"""The port's sweep where MITHRIL mines hard, against the reference.

Small block universes make mining fire on one lane at a time (the
one-lane path of ``mine_batched``) and on several lanes at once (the
fused path), and MITHRIL prefetches are issued and used; every
``Stats`` leaf and the hit curves must equal
``repro.cache.sweep_scheduled(..., shard=False)``.
"""

import dataclasses

import numpy as np
import pytest

import repro.cache as rc
import repro.traces as rt

import repro_torch.cache as pc
from repro_torch.convert import config_from
from test_torch_sweep import LABELS, assert_stats_equal, grid_config, \
    one_group_plan


@pytest.mark.parametrize("label", [lb for lb in LABELS if "mithril" in lb])
def test_association_rich_suite_mines_like_reference(label):
    """Small block universes: mining fires on one lane and on several
    lanes at once, and MITHRIL prefetches are issued and used."""
    traces = [rt.association_groups(500, n_groups=6 + 2 * i, group_size=4,
                                    reuse=60, spread=3, lba_space=4096,
                                    seed=i) for i in range(6)]
    traces[2] = traces[2][:310]               # a ragged tail
    suite = rc.pad_traces(traces)
    ref_cfg = dataclasses.replace(grid_config(label), capacity=32)
    want = rc.sweep_scheduled(ref_cfg, suite, shard=False,
                              plan=one_group_plan(rc, suite.lengths))
    got = pc.sweep_scheduled(config_from(ref_cfg), pc.pad_traces(traces),
                             plan=one_group_plan(pc, suite.lengths),
                             device="cpu")
    assert_stats_equal(got.stats, want.stats, label)
    np.testing.assert_array_equal(got.hit_curve, want.hit_curve)
    assert want.stats.pf_issued[:, 1].sum() > 0
    assert want.stats.pf_used[:, 1].sum() > 0
