"""The port's copies and hash tables against the reference.

``MithrilConfig``, the paper configurations and the learned scorer are
copies; ``mix32``/``bucket_of``/``probe``/``choose_victim``/``locate``
are ports whose traps (logical uint32 shifts, first-index ties) are
pinned here on keys that include EMPTY = -1 and other negatives.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import mithril_paper as ref_paper
from repro.core import MithrilConfig as RefConfig
from repro.core import hashindex as ref_hash
from repro.learn import policy as ref_policy

from repro_torch.configs import mithril_paper as port_paper
from repro_torch.convert import config_from
from repro_torch.core import MithrilConfig, hashindex, init_state
from repro_torch.learn import policy as port_policy

CONFIGS = [
    {}, {"max_window": 7, "mine_rows": 32}, {"max_pairs": 5},
    {"min_support": 1, "max_support": 1, "lookahead": 3},
    {"record_on": "miss+evict", "symmetric": True},
    dataclasses.asdict(ref_paper.PAPER_MITHRIL),
    dataclasses.asdict(ref_paper.SUITE_MITHRIL),
]


@pytest.mark.parametrize("kw", CONFIGS)
def test_config_fields_and_derived_properties(kw):
    ref, port = RefConfig(**kw), MithrilConfig(**kw)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert (port.window, port.pairs_cap, port.metadata_bytes()) == \
        (ref.window, ref.pairs_cap, ref.metadata_bytes())
    for budget in (10_000, 1 << 20, 26_843_545):
        assert dataclasses.asdict(
            MithrilConfig.from_metadata_budget(budget, **kw)) == \
            dataclasses.asdict(RefConfig.from_metadata_budget(budget, **kw))


def test_config_validation_matches():
    for bad in ({"min_support": 0}, {"max_support": 1, "min_support": 2},
                {"prefetch_list": 0}, {"record_on": "sometimes"}):
        with pytest.raises(ValueError):
            RefConfig(**bad)
        with pytest.raises(ValueError):
            MithrilConfig(**bad)


def test_paper_configs_match_reference():
    for name in ("PAPER_MITHRIL", "SUITE_MITHRIL"):
        assert dataclasses.asdict(getattr(port_paper, name)) == \
            dataclasses.asdict(getattr(ref_paper, name))
    for kw in ({}, {"capacity": 512, "ways": 8}):
        assert port_paper.paper_sim(**kw) == \
            config_from(ref_paper.paper_sim(**kw))
        assert port_paper.paper_sim(**kw).label() == \
            ref_paper.paper_sim(**kw).label()


KEYS = np.concatenate([
    np.array([-1, -5, 0, 1, 2, -2**31, 2**31 - 1, 12345, -77777], np.int32),
    np.random.default_rng(0).integers(-2**31, 2**31 - 1, 4000,
                                      dtype=np.int64).astype(np.int32)])


def test_mix32_and_buckets_match_reference():
    got = hashindex.mix32(torch.as_tensor(KEYS))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(ref_hash.mix32(jnp.asarray(KEYS))))
    # the reference's value for -5; a sign-extending shift gives 677335055
    assert int(hashindex.mix32(torch.tensor([-5], dtype=torch.int32))) \
        == -1679748776
    for nb in (1, 2, 64, 4096, 32768):
        np.testing.assert_array_equal(
            hashindex.bucket_of(torch.as_tensor(KEYS), nb).numpy(),
            np.asarray(ref_hash.bucket_of(jnp.asarray(KEYS), nb)))


@pytest.mark.parametrize("seed", range(4))
def test_probe_victim_locate_match_reference(seed):
    rng = np.random.default_rng(seed)
    lanes, nb, ways = 6, 8, 4
    # small key universe with EMPTY slots, ties in ages, negative keys
    keys = rng.integers(-3, 12, size=(lanes, nb, ways)).astype(np.int32)
    ages = rng.integers(0, 3, size=(lanes, nb, ways)).astype(np.int32)
    query = rng.integers(-3, 12, size=lanes).astype(np.int32)
    tk, ta, tq = (torch.as_tensor(x) for x in (keys, ages, query))
    pb, pw, pf = hashindex.probe(tk, tq, nb)
    lb, lw, lf = hashindex.locate(tk, ta, tq, nb)
    for i in range(lanes):
        rb, rw, rf = ref_hash.probe(jnp.asarray(keys[i]), query[i], nb)
        assert (int(pb[i]), int(pw[i]), bool(pf[i])) == \
            (int(rb), int(rw), bool(rf))
        rb, rw, rf = ref_hash.locate(jnp.asarray(keys[i]),
                                     jnp.asarray(ages[i]), query[i], nb)
        assert (int(lb[i]), int(lw[i]), bool(lf[i])) == \
            (int(rb), int(rw), bool(rf))
        row = int(rb)
        v = hashindex.choose_victim(tk[i, row][None], ta[i, row][None])
        assert int(v[0]) == int(ref_hash.choose_victim(
            jnp.asarray(keys[i, row]), jnp.asarray(ages[i, row])))


def test_init_state_matches_reference():
    from repro.core import init_state as ref_init
    cfg = RefConfig(**CONFIGS[1])
    port = init_state(config_from(cfg), "cpu", lanes=2)
    for name, a, b in zip(port._fields, port, ref_init(cfg)):
        assert a.dtype == torch.int32, name
        assert tuple(a.shape) == (2,) + tuple(b.shape), name
        np.testing.assert_array_equal(a[1].numpy(), np.asarray(b))


def test_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_state(MithrilConfig())
    assert hashindex.lanes_of(torch.zeros(3)).tolist() == [0, 1, 2]


@pytest.mark.parametrize("kind", ["logreg", "mlp"])
def test_learned_scores_match_reference(kind):
    ref_cfg = ref_policy.LearnedConfig(
        kind=kind, weights=(ref_policy.DEFAULT_LOGREG if kind == "logreg"
                            else ref_policy.DEFAULT_MLP))
    port_cfg = config_from(ref_cfg)
    assert port_cfg.weights == ref_cfg.weights
    rng = np.random.default_rng(3)
    feats = [rng.integers(-10, 200_000, size=(5, 16)).astype(np.int32),
             rng.integers(0, 600, size=(5, 16)).astype(np.int32),
             rng.integers(0, 100, size=(5, 16)).astype(np.int32),
             rng.integers(0, 2, size=(5, 16)).astype(np.int32)]
    got = port_policy.score_rows(port_cfg, *(torch.as_tensor(f)
                                             for f in feats))
    want = ref_policy.score_rows(ref_cfg, *(jnp.asarray(f) for f in feats))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
