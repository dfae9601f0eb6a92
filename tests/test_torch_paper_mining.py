"""The paper's MITHRIL tables where they really mine, against the reference.

The paper-size configuration (the main path at ``PAPER_MITHRIL``, a
65,536-block cache, loops of 4 x 18,000 blocks) first mines after about
218,000 requests a lane, too long for the CPU here. The same tables mine
on a looping trace scaled down with the cache: one loop of 2,048 blocks
against 512 blocks of cache, whose 1,024-row mining table first fills at
request 7,235 and again at 12,172. Through the port's ``sweep`` (the
batched engine and its runner, as ``simulate`` calls it) every ``Stats``
field, the hit curve and the count of mining runs (``n_mines``) must
equal the reference's ``simulate`` bit for bit (its step scanned over
the trace, as ``simulate`` scans it, keeping the carry), and mining
(at least two runs) and prefetching are asserted, not assumed. A second
case runs the suite tables (``SUITE_MITHRIL``: 64 mining rows), which
mine many times on a shorter trace.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.cache.simulator import SimConfig as RefSimConfig
from repro.cache.simulator import build_step
from repro.configs.mithril_paper import PAPER_MITHRIL as REF_PAPER
from repro.configs.mithril_paper import SUITE_MITHRIL as REF_SUITE
from repro.traces.synthetic import looping as ref_looping

import repro_torch.cache as pc
from repro_torch.configs import PAPER_MITHRIL, SUITE_MITHRIL
from repro_torch.convert import config_from
from repro_torch.traces.synthetic import looping

# (tables, requests, loop length, least mining runs)
CASES = {"paper": (REF_PAPER, 12_500, 2048, 2),
         "suite": (REF_SUITE, 3_000, 1024, 10)}


def ref_run(cfg, trace):
    """The reference's ``simulate``, keeping the final carry: (Stats,
    hits, n_mines)."""
    init, step = build_step(cfg)
    carry, hits = jax.jit(lambda t: jax.lax.scan(step, init(), t))(
        jnp.asarray(trace))
    return (jax.device_get(carry["stats"]), np.asarray(hits),
            int(carry["mith"].n_mines))


def test_configs_are_the_reference_tables():
    assert dataclasses.asdict(PAPER_MITHRIL) == dataclasses.asdict(REF_PAPER)
    assert dataclasses.asdict(SUITE_MITHRIL) == dataclasses.asdict(REF_SUITE)
    np.testing.assert_array_equal(
        looping(40_000, loop_len=18_000, n_loops=4, seed=1),
        ref_looping(40_000, loop_len=18_000, n_loops=4, seed=1))


@pytest.mark.parametrize("tables", sorted(CASES))
def test_sweep_mines_like_reference(tables):
    mith, n, loop_len, least = CASES[tables]
    ref_cfg = RefSimConfig(capacity=512, ways=16, policy="lru",
                           use_mithril=True, mithril=mith)
    trace = looping(n, loop_len=loop_len, n_loops=1, seed=1)
    want, want_hits, want_mines = ref_run(ref_cfg, trace)

    cfg = config_from(ref_cfg)
    got = pc.sweep(cfg, trace[None], device="cpu")
    got_mines = pc.chunk_runner(cfg, device="cpu").carry(1)["mith"].n_mines
    for field in want._fields:
        np.testing.assert_array_equal(getattr(got.stats, field)[0],
                                      np.asarray(getattr(want, field)),
                                      err_msg=field)
    np.testing.assert_array_equal(got.hit_curve[0], want_hits)
    assert got_mines.tolist() == [want_mines]
    assert want_mines >= least
    assert int(want.pf_issued[1]) > 0 and int(want.pf_used[1]) > 0


def test_chip_smoke_paper_configuration_is_the_reference():
    """chip_smoke.py's paper-mining traces and configuration: the
    reference's looping traces and its SimConfig at the paper's tables."""
    import pathlib
    import sys
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
    import chip_smoke
    got = chip_smoke.paper_traces(5_000, (1, 135))
    for row, seed in zip(got, (1, 135), strict=True):
        np.testing.assert_array_equal(row, ref_looping(
            5_000, loop_len=18_000, n_loops=4, seed=seed))
    assert chip_smoke.real_config() == config_from(RefSimConfig(
        capacity=65_536, ways=16, policy="lru", use_mithril=True,
        mithril=REF_PAPER))
    assert chip_smoke.PAPER_SEEDS == tuple(range(1, 136))
