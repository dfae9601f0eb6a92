"""The port's online MITHRIL search against the JAX reference, bit for bit.

``repro_torch.learn.adapt``'s ``hill_climb`` and ``bandit`` (on the CPU:
the sweep's plain path) and ``repro.learn.adapt``'s run
``tests/test_adapt.py``'s tiny corpus (4 traces of 512 requests,
capacity 64, a 4-arm grid); the committed arms, labels, hit ratios, the
base sweep's ``Stats`` and hit curve, the decision history and its CRC
must be equal. The reference's invariants hold for the port too: zero
episodes is the static sweep, commits stay on the grid, the guard never
loses to static, a fixed-seed bandit repeats in and across processes,
and each distinct config builds one chunk runner (on the CPU nothing is
captured, so the budget counts runners; ``tests/test_torch_cuda.py``
counts the card's captures).
"""

import importlib
import os
import subprocess
import sys
import zlib

import numpy as np
import pytest
import torch

import repro.learn.adapt as ra
from repro.cache import SimConfig
from repro.core import MithrilConfig

import repro_torch.learn.adapt as pa
from repro_torch.cache import sweep
from repro_torch.cache.sweep import reset_runners
from repro_torch.convert import config_from

psweep = importlib.import_module("repro_torch.cache.sweep")

SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))

CHUNK = 256
AXES = dict(lookaheads=(50, 200), min_supports=(2, 4), pf_sizes=(1,))
GRID = pa.SearchGrid(**AXES)
REF_BASE = SimConfig(capacity=64, use_mithril=True)
BASE = config_from(REF_BASE)
# small mining tables and a 12-arm grid, where the tiny corpus mines
# often enough that traces commit grid arms (the base above commits none)
REF_SMALL = SimConfig(capacity=64, use_mithril=True, mithril=MithrilConfig(
    min_support=2, max_support=8, lookahead=40, rec_buckets=512, rec_ways=4,
    mine_rows=16, pf_buckets=512, pf_ways=4, prefetch_list=2))
SMALL_AXES = dict(lookaheads=(10, 40, 160), min_supports=(2, 3),
                  pf_sizes=(1, 2))

# (searcher, small tables?, keyword arguments), run by both
CASES = {
    "hill_climb": ("hill_climb", False, {}),
    "hill_climb_two_episodes": ("hill_climb", False,
                                {"prefix_fracs": (0.5, 1.0)}),
    "bandit": ("bandit", False, {"episodes": 4}),
    "bandit_seed11_top1": ("bandit", False, {"episodes": 4, "seed": 11,
                                             "top_k": 1}),
    "hill_climb_small_tables": ("hill_climb", True, {}),
    "bandit_small_tables": ("bandit", True, {"episodes": 4, "seed": 3}),
}


def corpus():
    """tests/test_adapt.py's corpus: assoc-heavy and random lanes,
    unequal lengths so padded tails are in play."""
    rng = np.random.default_rng(7)
    blocks = rng.integers(0, 150, size=(4, 512)).astype(np.int32)
    blocks[1, 1::3] = blocks[1, 0::3] + 1     # correlated pairs
    lengths = np.array([512, 512, 400, 301])
    return blocks, lengths


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def runs():
    """Each case through the reference and the port, once."""
    blocks, lengths = corpus()
    out = {}
    for case, (fn, small, kw) in CASES.items():
        base, axes = (REF_SMALL, SMALL_AXES) if small else (REF_BASE, AXES)
        ref = getattr(ra, fn)(base, blocks, lengths, ra.SearchGrid(**axes),
                              chunk=CHUNK, **kw)
        got = getattr(pa, fn)(config_from(base), blocks, lengths,
                              pa.SearchGrid(**axes), chunk=CHUNK,
                              device="cpu", **kw)
        out[case] = (ref, got, pa.SearchGrid(**axes), config_from(base))
    return out


@pytest.mark.parametrize("case", sorted(CASES))
def test_search_equals_reference(runs, case):
    ref, got, _, _ = runs[case]
    assert got.arms == ref.arms
    assert got.labels == ref.labels
    assert got.episodes == ref.episodes
    np.testing.assert_array_equal(got.hit_ratios, ref.hit_ratios)
    np.testing.assert_array_equal(got.base_hit_ratios, ref.base_hit_ratios)
    assert got.history == ref.history
    assert zlib.crc32(repr(got.history).encode()) == \
        zlib.crc32(repr(ref.history).encode())
    for field, a, b in zip(ref.base_result.stats._fields,
                           got.base_result.stats, ref.base_result.stats):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=f"base stats.{field}")
    np.testing.assert_array_equal(got.base_result.hit_curve,
                                  ref.base_result.hit_curve)
    assert got.compiles == 0            # nothing is captured on the CPU
    assert got.sweeps > 0


def test_small_tables_commit_arms(runs):
    """The guard is exercised both ways: with small tables traces commit
    grid arms, each strictly above its static hit ratio."""
    for case in ("hill_climb_small_tables", "bandit_small_tables"):
        ref, got, _, _ = runs[case]
        won = [t for t, a in enumerate(got.arms) if a >= 0]
        assert won, case
        assert all(got.hit_ratios[t] > got.base_hit_ratios[t] for t in won)


class TestStaticReduction:
    def test_zero_episode_bandit_is_static_sweep(self):
        blocks, lengths = corpus()
        r = pa.bandit(BASE, blocks, lengths, GRID, episodes=0, chunk=CHUNK,
                      device="cpu")
        ref = sweep(BASE, blocks, lengths=lengths, chunk=CHUNK,
                    shard=False, device="cpu")
        assert r.arms == (-1,) * 4 and set(r.labels) == {"static"}
        for field, a, b in zip(ref.stats._fields, r.base_result.stats,
                               ref.stats):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                          err_msg=f"stats.{field}")
        np.testing.assert_array_equal(r.base_result.hit_curve,
                                      ref.hit_curve)
        np.testing.assert_array_equal(r.hit_ratios, ref.hit_ratios())

    def test_empty_prefix_hill_climb_is_static(self):
        blocks, lengths = corpus()
        r = pa.hill_climb(BASE, blocks, lengths, GRID, prefix_fracs=(),
                          chunk=CHUNK, device="cpu")
        assert r.arms == (-1,) * 4 and r.episodes == 0 and r.history == ()
        np.testing.assert_array_equal(r.hit_ratios, r.base_hit_ratios)


class TestSearchContract:
    def test_commits_stay_on_declared_grid(self, runs):
        for _, r, grid, base in runs.values():
            for arm, label in zip(r.arms, r.labels):
                assert arm == -1 or 0 <= arm < grid.n_arms
                assert label == ("static" if arm == -1
                                 else pa.arm_label(grid, arm))
                if arm >= 0:
                    assert grid.contains(base, grid.config(base, arm))
            for _, _, t, arm, _ in r.history:
                assert 0 <= arm < grid.n_arms and 0 <= t < 4

    def test_commit_guard_never_loses_to_static(self, runs):
        for _, r, _, _ in runs.values():
            assert (np.asarray(r.hit_ratios)
                    >= np.asarray(r.base_hit_ratios)).all()


class TestDeterminism:
    def test_fixed_seed_bandit_reproduces_in_process(self):
        blocks, lengths = corpus()

        def run(seed):
            return pa.bandit(BASE, blocks, lengths, GRID, episodes=3,
                             seed=seed, chunk=CHUNK, device="cpu")
        a, b = run(11), run(11)
        assert a.arms == b.arms and a.history == b.history
        np.testing.assert_array_equal(a.hit_ratios, b.hit_ratios)
        assert run(12).history != a.history

    def test_fixed_seed_bandit_reproduces_across_processes(self):
        blocks, lengths = corpus()
        here = pa.bandit(BASE, blocks, lengths, GRID, episodes=3, seed=5,
                         chunk=CHUNK, device="cpu")
        script = (
            "import numpy as np, torch, zlib\n"
            "torch.set_num_threads(1)\n"
            "from repro_torch.cache import SimConfig\n"
            "from repro_torch.learn import SearchGrid, bandit\n"
            "rng = np.random.default_rng(7)\n"
            "blocks = rng.integers(0, 150, size=(4, 512))"
            ".astype(np.int32)\n"
            "blocks[1, 1::3] = blocks[1, 0::3] + 1\n"
            "lengths = np.array([512, 512, 400, 301])\n"
            "grid = SearchGrid(lookaheads=(50, 200),"
            " min_supports=(2, 4), pf_sizes=(1,))\n"
            "r = bandit(SimConfig(capacity=64, use_mithril=True),"
            " blocks, lengths, grid, episodes=3, seed=5, chunk=256,"
            " device='cpu')\n"
            "print(list(r.arms))\n"
            "print(zlib.crc32(repr(r.history).encode()))\n"
            "import sys\n"
            "assert not [m for m in sys.modules"
            " if m.split('.')[0] in ('jax', 'repro')]\n")
        out = subprocess.run([sys.executable, "-c", script],
                             env=dict(os.environ, PYTHONPATH=SRC),
                             capture_output=True, text=True, timeout=600)
        assert out.returncode == 0, out.stderr
        arms_line, crc_line = out.stdout.strip().splitlines()[-2:]
        assert arms_line == str(list(here.arms))
        assert int(crc_line) == zlib.crc32(repr(here.history).encode())


class TestRunnerBudget:
    def test_episodes_reuse_chunk_runners(self):
        """However many episodes and prefixes run, each distinct config
        builds one chunk runner (the card captures one graph in it, at
        the batch's width); a repeat search builds none."""
        blocks, lengths = corpus()
        reset_runners()

        def built():
            return psweep._runner.cache_info().currsize

        r1 = pa.hill_climb(BASE, blocks, lengths, GRID, chunk=CHUNK,
                           device="cpu")
        n1 = built()
        assert 0 < n1 <= GRID.n_arms + 1
        assert r1.compiles == 0
        pa.bandit(BASE, blocks, lengths, GRID, episodes=4, chunk=CHUNK,
                  device="cpu")
        n2 = built()
        assert n2 - n1 <= GRID.n_arms
        r3 = pa.hill_climb(BASE, blocks, lengths, GRID, chunk=CHUNK,
                           device="cpu")
        assert built() == n2 and r3.compiles == 0
        assert r3.history == r1.history
        reset_runners()
        assert built() == 0


class TestSearchGrid:
    GRIDS = [dict(), AXES,
             dict(lookaheads=(25, 100, 400), min_supports=(2, 4),
                  pf_sizes=(1, 2)),
             dict(lookaheads=(10, 30, 90, 270), min_supports=(1, 3, 5),
                  pf_sizes=(2,))]

    @pytest.mark.parametrize("i", range(len(GRIDS)))
    def test_indexing_equals_reference(self, i):
        g, r = pa.SearchGrid(**self.GRIDS[i]), ra.SearchGrid(**self.GRIDS[i])
        assert g.shape == r.shape and g.n_arms == r.n_arms
        for arm in range(g.n_arms):
            assert g.arm_values(arm) == r.arm_values(arm)
            assert pa.arm_label(g, arm) == ra.arm_label(r, arm)
            assert g.arm_index(*np.unravel_index(arm, g.shape)) == arm
            assert config_from(r.config(REF_BASE, arm)) == g.config(BASE,
                                                                  arm)
        assert g.contains(BASE, g.config(BASE, g.n_arms - 1))
        assert g.contains(BASE, BASE) == r.contains(REF_BASE, REF_BASE)

    @pytest.mark.parametrize("la,r_sup,p", [(100, 2, 2), (1, 1, 1),
                                            (1000, 9, 9), (60, 3, 1),
                                            (62, 3, 3)])
    def test_nearest_arm_equals_reference(self, la, r_sup, p):
        import dataclasses
        ref_base = dataclasses.replace(REF_BASE, mithril=dataclasses.replace(
            REF_BASE.mithril, lookahead=la, min_support=r_sup,
            max_support=max(r_sup, REF_BASE.mithril.max_support),
            prefetch_list=p))
        for axes in self.GRIDS:
            assert pa.SearchGrid(**axes).nearest_arm(
                config_from(ref_base)) == \
                ra.SearchGrid(**axes).nearest_arm(ref_base)


def test_search_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    blocks, lengths = corpus()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pa.hill_climb(BASE, blocks, lengths, GRID, prefix_fracs=())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pa.bandit(BASE, blocks, lengths, GRID, episodes=0)
