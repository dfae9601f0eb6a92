"""The whole mining run of the port against the reference.

``kernels.mithril_mine_step.mine_step_plain`` (the CPU path of the fused
mining launch, and its yardstick on the card) must leave every state leaf
as ``repro.core.mithril.mine_batched`` leaves it, for need masks of no,
one, several and all lanes, ``symmetric``, R = 1, pairs caps that cut
rows, mining tables without a valid row, N not a power of two and
windows of N - 1 rows. Two numpy emulations pin what the CUDA kernel
does differently from the reference's sequential form: its fold applies
the operations grouped by prefetch bucket (list order within a bucket,
the groups in any order), and its clear walks the recording table four
slots at a time, writing only what changes.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.cache as rc
import repro.core as ref_core
import repro.core.mithril as ref_mithril
import repro.traces as rt
from repro.core import MithrilConfig as RefConfig

import repro_torch.cache as pc
import repro_torch.core as port_core
from repro_torch.convert import config_from, to_numpy, to_torch
from repro_torch.core.hashindex import EMPTY, bucket_index
from repro_torch.kernels import ops
from repro_torch.kernels.mithril_mine_step import mine_step_plain
from test_torch_cuda import warm_mine_state


def small_cfg(**kw):
    base = dict(min_support=2, max_support=4, lookahead=12, rec_buckets=16,
                rec_ways=4, mine_rows=24, pf_buckets=8, pf_ways=2,
                prefetch_list=2)
    base.update(kw)
    return RefConfig(**base)


def assert_state_equal(port, ref, msg=""):
    for name, a, b in zip(ref._fields, to_numpy(port), ref):
        b = np.asarray(b)
        assert a.dtype == b.dtype, (msg, name, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=f"{msg} {name}")


def mining_states(cfg, lanes, seed, valid_frac=0.85, ts_base=0):
    """``warm_mine_state`` of the card tests (full mining tables in
    migration order, clustered rows, half-full prefetch tables,
    recording pointers into the miner) as stacked reference states."""
    port = warm_mine_state(config_from(cfg), lanes, "cpu",
                           np.random.default_rng(seed), valid_frac, ts_base)
    return ref_core.MithrilState(*(jnp.asarray(x) for x in to_numpy(port)))


NEEDS = {"none": [0, 0, 0, 0], "one": [0, 0, 1, 0],
         "several": [1, 0, 1, 1], "all": [1, 1, 1, 1]}
CASES = {
    "need none": ({}, "none", 0.85),
    "need one": ({}, "one", 0.85),
    "need several": ({}, "several", 0.85),
    "need all": ({}, "all", 0.85),
    "symmetric": ({"symmetric": True}, "several", 0.85),
    "symmetric, R = 1": ({"symmetric": True, "min_support": 1}, "all",
                         0.85),
    "R = 1": ({"min_support": 1}, "several", 0.85),
    "pairs dropped": ({"max_pairs": 5}, "all", 0.85),
    "pairs dropped, symmetric": ({"max_pairs": 7, "symmetric": True},
                                 "several", 0.85),
    "no valid row": ({}, "all", 0.0),
    "N not a power of two": ({"mine_rows": 37}, "several", 0.85),
    "window of N - 1 rows": ({"mine_rows": 13, "lookahead": 40}, "all",
                             0.85),
    "S = 5, N = 33": ({"max_support": 5, "mine_rows": 33}, "several", 0.9),
}


@pytest.mark.parametrize("name", list(CASES))
def test_mine_step_plain_matches_reference(name):
    kw, need_name, valid_frac = CASES[name]
    cfg = small_cfg(**kw)
    ref = mining_states(cfg, 4, seed=len(name), valid_frac=valid_frac)
    need = np.array(NEEDS[need_name], bool)
    want = jax.jit(functools.partial(ref_core.mine_batched, cfg))(
        ref, jnp.asarray(need))
    port = to_torch(ref, "cpu")
    got = mine_step_plain(config_from(cfg), port, torch.as_tensor(need))
    assert got is port
    assert_state_equal(port, want, name)
    mined = np.asarray(want.n_pairs) - np.asarray(ref.n_pairs)
    dropped = np.asarray(want.n_dropped) - np.asarray(ref.n_dropped)
    assert (mined[~need] == 0).all() and (dropped[~need] == 0).all()
    if valid_frac and need.any():
        assert mined[need].sum() > 0, name
    if "dropped" in name:
        assert dropped[need].sum() > 0, name


# timestamp bases: rows whose first timestamps pass INT32_MAX and wrap to
# negative values (gaps across the wrap), first timestamps either side of
# 0, and all near INT32_MIN; every state also holds two valid rows whose
# first timestamp is INT32_MAX (a tie with the invalid rows)
WRAP_BASES = {"past INT32_MAX": 2**31 - 400, "either side of 0": -150,
              "near INT32_MIN": -2**31}


@pytest.mark.parametrize("symmetric", [False, True])
@pytest.mark.parametrize("base", list(WRAP_BASES))
def test_mine_step_plain_matches_reference_at_wrapping_timestamps(
        base, symmetric):
    cfg = small_cfg(mine_rows=40, lookahead=40, symmetric=symmetric)
    ref = mining_states(cfg, 4, seed=11, ts_base=WRAP_BASES[base])
    first = np.asarray(ref.mine_ts)[..., 0]
    assert (first == 2**31 - 1).any() and (first < 0).any()
    need = np.array(NEEDS["all"], bool)
    want = jax.jit(functools.partial(ref_core.mine_batched, cfg))(
        ref, jnp.asarray(need))
    port = to_torch(ref, "cpu")
    mine_step_plain(config_from(cfg), port, torch.as_tensor(need))
    assert_state_equal(port, want, base)
    assert (np.asarray(want.n_pairs) - np.asarray(ref.n_pairs)).sum() > 0


def test_the_wrapper_on_the_cpu_is_the_plain_run():
    """``ops.mithril_mine_step`` on CPU tensors runs the plain run and
    equals ``core.mithril.mine_batched`` (the composed paths)."""
    cfg = small_cfg(symmetric=True)
    ref = mining_states(cfg, 4, seed=3)
    need = torch.tensor([True, False, True, True])
    a, b = to_torch(ref, "cpu"), to_torch(ref, "cpu")
    before = ops.launch_counts()["mithril_mine_step"]
    ops.mithril_mine_step(config_from(cfg), a, need)
    port_core.mine_batched(config_from(cfg), b, need)
    assert ops.launch_counts()["mithril_mine_step"] == before
    for name, x, y in zip(a._fields, to_numpy(a), to_numpy(b)):
        np.testing.assert_array_equal(x, y, err_msg=name)


# ---------------------------------------------------------------------------
# the fold, grouped by bucket
# ---------------------------------------------------------------------------

def add_association_np(pf, lane_ts, plist, src, dst, b):
    """``add_association(src -> dst)`` on bucket ``b`` of one lane's
    numpy prefetch table; returns 1 when a pair landed."""
    keys, vals, cnt, age = pf["key"][b], pf["vals"][b], pf["cnt"][b], \
        pf["age"][b]
    hit = np.flatnonzero(keys == src)
    empty = np.flatnonzero(keys == EMPTY)
    way = hit[0] if len(hit) else (empty[0] if len(empty) else
                                   int(np.argmin(age)))
    landed = 1
    if len(hit):
        if (vals[way] == dst).any():
            landed = 0
        else:
            vals[way, cnt[way] % plist] = dst
            cnt[way] += 1
    else:
        keys[way] = src
        vals[way] = EMPTY
        vals[way, 0] = dst
        cnt[way] = 1
    age[way] = lane_ts
    return landed


def grouped_fold(cfg, state, src, dst, order_rng):
    """The kernel's fold of one lane: the operation list (s -> d, then
    d -> s when symmetric) sorted by (bucket, position), each bucket's
    run applied in list order, the runs in a random order."""
    ops_ = [(int(s), int(d)) for s, d in zip(src, dst)]
    if cfg.symmetric:
        ops_ = [op for s, d in ops_ for op in ((s, d), (d, s))]
    buckets = bucket_index(torch.tensor([s for s, _ in ops_] or [0],
                                        dtype=torch.int32),
                           cfg.pf_buckets).tolist()[:len(ops_)]
    runs = {}
    for k in sorted(range(len(ops_)), key=lambda k: (buckets[k], k)):
        runs.setdefault(buckets[k], []).append(ops_[k])
    pf = {k: np.array(getattr(state, f"pf_{k}")[0])
          for k in ("key", "vals", "cnt", "age")}
    stored = 0
    for b in order_rng.permutation(sorted(runs)):
        for s, d in runs[b]:
            stored += add_association_np(pf, int(state.ts[0]),
                                         cfg.prefetch_list, s, d, b)
    return pf, stored


@pytest.mark.parametrize("symmetric", [False, True])
@pytest.mark.parametrize("seed", range(4))
def test_fold_grouped_by_bucket_equals_the_sequential_fold(symmetric, seed):
    """Pairs over a few buckets (repeated sources, duplicate
    destinations, evictions by age, and with ``symmetric`` both
    directions of a pair in one bucket): the grouped fold gives the
    reference's prefetch table and ``n_pairs``."""
    cfg = small_cfg(pf_buckets=4, pf_ways=2, prefetch_list=2,
                    symmetric=symmetric)
    rng = np.random.default_rng(seed)
    state = mining_states(cfg, 1, seed=seed + 50)
    state = jax.tree.map(lambda x: x[0], state)
    universe = np.arange(40, dtype=np.int32)
    b = bucket_index(torch.as_tensor(universe), cfg.pf_buckets).numpy()
    same = [(int(x), int(y)) for x in universe for y in universe
            if x < y and b[x] == b[y]]
    pairs = [tuple(rng.choice(universe, 2, replace=False)) for _ in range(30)]
    pairs += [same[i] for i in rng.choice(len(same), 6, replace=False)]
    pairs += pairs[:3]                               # repeated pairs
    rng.shuffle(pairs)
    src = np.array([p[0] for p in pairs], np.int32)
    dst = np.array([p[1] for p in pairs], np.int32)
    want = ref_mithril._fold_pairs(
        cfg, state, jnp.asarray(src), jnp.asarray(dst),
        jnp.ones(len(pairs), bool), jnp.int32(0))
    got, stored = grouped_fold(cfg, jax.tree.map(lambda x: x[None], state),
                               src, dst, rng)
    for k in ("key", "vals", "cnt", "age"):
        np.testing.assert_array_equal(got[k], np.asarray(
            getattr(want, f"pf_{k}")), err_msg=k)
    assert int(state.n_pairs) + stored == int(want.n_pairs)
    if symmetric:
        both = [(s, d) for s, d in pairs
                if b[s] == b[d]]
        assert both, "no pair with both directions in one bucket"


# ---------------------------------------------------------------------------
# the clear of the recording table
# ---------------------------------------------------------------------------

def kernel_clear(rec_key, rec_loc):
    """The kernel's walk over one lane's recording slots: four at a
    time when the slots are a multiple of four (a quad with any pointer
    into the miner loses those keys; a quad with any nonzero rec_loc is
    zeroed), one at a time otherwise."""
    key, loc = rec_key.reshape(-1).copy(), rec_loc.reshape(-1).copy()
    step = 4 if key.size % 4 == 0 else 1
    for e in range(0, key.size, step):
        quad = slice(e, e + step)
        if not loc[quad].any():
            continue
        if (loc[quad] == 1).any():
            key[quad] = np.where(loc[quad] == 1, EMPTY, key[quad])
        loc[quad] = 0
    return key.reshape(rec_key.shape), loc.reshape(rec_loc.shape)


@pytest.mark.parametrize("buckets,ways", [(16, 4), (8, 3), (2, 3)])
@pytest.mark.parametrize("share", [0.0, 0.05, 0.6])
def test_recording_clear_equals_clear_after_mine(buckets, ways, share):
    cfg = small_cfg(rec_buckets=buckets, rec_ways=ways)
    rng = np.random.default_rng(buckets * ways + int(share * 100))
    state = ref_core.init_state(cfg)
    state = state._replace(
        rec_key=jnp.asarray(rng.integers(-1, 50, state.rec_key.shape),
                            jnp.int32),
        rec_loc=jnp.asarray(rng.random(state.rec_loc.shape) < share,
                            jnp.int32))
    want = ref_mithril._clear_after_mine(state, jnp.int32(0))
    key, loc = kernel_clear(np.asarray(state.rec_key),
                            np.asarray(state.rec_loc))
    np.testing.assert_array_equal(key, np.asarray(want.rec_key))
    np.testing.assert_array_equal(loc, np.asarray(want.rec_loc))


# ---------------------------------------------------------------------------
# the sweep's barrier
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("symmetric", [False, True])
def test_sweep_barrier_equals_the_reference(symmetric):
    """The barrier that hands the device mask of the lanes to mine to
    the mining run gives the reference's Stats on a suite that mines on
    one lane and on several at once."""
    traces = [rt.association_groups(400, n_groups=6 + 2 * i, group_size=4,
                                    reuse=60, spread=3, lba_space=4096,
                                    seed=i) for i in range(4)]
    mcfg = small_cfg(min_support=2, max_support=8, lookahead=60,
                     rec_buckets=256, mine_rows=16, pf_buckets=64, pf_ways=4,
                     symmetric=symmetric)
    cfg = rc.SimConfig(capacity=32, use_mithril=True, mithril=mcfg)
    want = rc.sweep_scheduled(cfg, rc.pad_traces(traces), shard=False)
    got = pc.sweep_scheduled(config_from(cfg), pc.pad_traces(traces),
                             device="cpu")
    for name, a, b in zip(want.stats._fields, got.stats, want.stats):
        np.testing.assert_array_equal(a, np.asarray(b), err_msg=name)
    assert np.asarray(want.stats.pf_used)[:, 1].sum() > 0
