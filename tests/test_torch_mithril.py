"""The port's MITHRIL layer against the reference, state leaf by leaf.

``mine`` and both paths of ``mine_batched`` (the one-lane fast path and
the fused path), ``record_event_batched`` and ``access`` are driven from
the same random states and traces through ``repro.core`` and
``repro_torch.core``; every state leaf must match after every call.
Also: the sequential paper oracle, ``enabled=False`` as a no-op,
``min_support == 1``, and a reference mid-run state that continues in
the port (and back) through ``repro_torch.convert``.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

import repro.cache as rc
import repro.core as ref_core
from repro.core import MithrilConfig as RefConfig

import repro_torch.cache as pc
import repro_torch.core as port_core
from repro_torch.convert import config_from, to_numpy, to_torch


def small_cfg(**kw):
    base = dict(min_support=2, max_support=4, lookahead=10, rec_buckets=64,
                rec_ways=4, mine_rows=8, pf_buckets=16, pf_ways=2,
                prefetch_list=2)
    base.update(kw)
    return RefConfig(**base)


def assert_state_equal(port, ref, msg=""):
    for name, a, b in zip(ref._fields, to_numpy(port), ref):
        b = np.asarray(b)
        assert a.dtype == b.dtype, (msg, name, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=f"{msg} {name}")


def random_table(rng, n, s, spread=12):
    cnt = rng.integers(0, s + 2, size=n).astype(np.int32)
    base = np.sort(rng.integers(0, 6 * n, size=n)).astype(np.int32)
    ts = np.zeros((n, s), np.int32)
    for i in range(n):
        c = min(int(cnt[i]), s)
        if c:
            ts[i, :c] = np.sort(rng.integers(0, spread, size=c)) + base[i]
    return ts, cnt


def random_states(cfg, lanes, seed):
    """Stacked reference states with full random mining tables, partly
    filled prefetch tables and recording rows pointing at the miner."""
    rng = np.random.default_rng(seed)
    st = jax.vmap(lambda _: ref_core.init_state(cfg))(jnp.arange(lanes))
    ts, cnt = zip(*(random_table(rng, cfg.mine_rows, cfg.max_support)
                    for _ in range(lanes)))
    blocks = rng.integers(0, 40, size=(lanes, cfg.mine_rows)).astype(np.int32)
    pf_key = np.where(rng.random(st.pf_key.shape) < 0.5,
                      rng.integers(0, 40, st.pf_key.shape), -1)
    return st._replace(
        mine_block=jnp.asarray(blocks), mine_ts=jnp.asarray(np.stack(ts)),
        mine_cnt=jnp.asarray(np.stack(cnt)),
        mine_fill=jnp.full((lanes,), cfg.mine_rows, jnp.int32),
        rec_key=jnp.asarray(rng.integers(0, 40, st.rec_key.shape),
                            jnp.int32),
        rec_loc=jnp.asarray(rng.integers(0, 2, st.rec_loc.shape), jnp.int32),
        pf_key=jnp.asarray(pf_key, jnp.int32),
        pf_vals=jnp.asarray(rng.integers(-1, 40, st.pf_vals.shape),
                            jnp.int32),
        pf_cnt=jnp.asarray(rng.integers(0, 5, st.pf_cnt.shape), jnp.int32),
        pf_age=jnp.asarray(rng.integers(0, 9, st.pf_age.shape), jnp.int32),
        ts=jnp.asarray(rng.integers(50, 90, (lanes,)), jnp.int32))


@pytest.mark.parametrize("seed", range(5))
def test_dense_matches_sequential_oracle(seed):
    rng = np.random.default_rng(seed)
    n, s, r_, delta = 24, 6, 2, 12
    ts, cnt = random_table(rng, n, s, spread=25)
    blocks = np.arange(10, 10 + n, dtype=np.int32)
    want = ref_core.mine_reference_sequential(blocks, ts, cnt, r_, s, delta)
    assert port_core.mine_reference_sequential(blocks, ts, cnt, r_, s,
                                               delta) == want
    src, dst, valid, dropped = port_core.associations_dense(
        torch.as_tensor(blocks), torch.as_tensor(ts), torch.as_tensor(cnt),
        r_, s, delta, window=n - 1, max_pairs=256)
    assert [(int(a), int(b)) for a, b, v in zip(src, dst, valid) if v] \
        == want
    assert int(dropped) == 0 and dropped.dtype == torch.int32


@pytest.mark.parametrize("kw", [{}, {"symmetric": True}, {"max_pairs": 3},
                                {"min_support": 1, "max_support": 3}])
def test_mine_matches_reference(kw):
    cfg = small_cfg(**kw)
    ref = random_states(cfg, 1, seed=len(kw))
    port = to_torch(ref, "cpu")
    want = jax.jit(functools.partial(ref_core.mine, cfg))(
        jax.tree.map(lambda x: x[0], ref))
    port_core.mine(config_from(cfg), port)
    assert_state_equal(port, jax.tree.map(lambda x: x[None], want))
    assert int(port.n_mines[0]) == 1


@pytest.mark.parametrize("need", [[0, 1, 0, 0], [1, 0, 1, 1], [1, 1, 1, 1],
                                  [0, 0, 0, 0]])
def test_mine_batched_both_paths_match_reference(need):
    cfg = small_cfg(max_pairs=6)
    ref = random_states(cfg, 4, seed=11)
    port = to_torch(ref, "cpu")
    need = np.array(need, bool)
    want = ref_core.mine_batched(cfg, ref, jnp.asarray(need))
    got = port_core.mine_batched(config_from(cfg), port,
                                 torch.as_tensor(need))
    assert got is port
    assert_state_equal(port, want, f"need={need.tolist()}")


@pytest.mark.parametrize("r_sup", [1, 2])
def test_access_sequence_matches_reference(r_sup):
    """Record + lookup per event with mining inside ``record``; random
    record/lookup flags make disabled events part of the stream."""
    cfg = small_cfg(min_support=r_sup, max_support=4, mine_rows=6)
    rng = np.random.default_rng(r_sup)
    blocks = rng.integers(0, 14, size=160).astype(np.int32)
    flags = rng.random((160, 2)) < 0.8
    ref = ref_core.init_state(cfg)
    port = port_core.init_state(config_from(cfg), "cpu")
    step = jax.jit(lambda st, b, r, p: ref_core.access(cfg, st, b, r, p))
    n_cand = 0
    for t, b in enumerate(blocks):
        ref, want = step(ref, jnp.int32(b), bool(flags[t, 0]),
                         bool(flags[t, 1]))
        port, got = port_core.access(config_from(cfg), port,
                                     torch.tensor([b], dtype=torch.int32),
                                     bool(flags[t, 0]), bool(flags[t, 1]))
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want))
        assert_state_equal(port, jax.tree.map(lambda x: x[None], ref),
                           f"event {t}")
        n_cand += int((np.asarray(want) >= 0).sum())
    assert int(ref.n_mines) > 2 and n_cand > 0


def test_record_event_batched_plain_and_fused_agree():
    cfg = small_cfg(mine_rows=64)
    pcfg = config_from(cfg)
    rng = np.random.default_rng(5)
    a = port_core.init_state(pcfg, "cpu", lanes=4)
    b = port_core.init_state(pcfg, "cpu", lanes=4)
    ref = jax.vmap(lambda _: ref_core.init_state(cfg))(jnp.arange(4))
    from repro_torch.kernels import ops
    rec = jax.jit(lambda st, bl, e: ref_core.record_event_batched(cfg, st,
                                                                  bl, e))
    for _ in range(60):
        blk = rng.integers(0, 30, 4).astype(np.int32)
        en = rng.random(4) < 0.7
        ref = rec(ref, jnp.asarray(blk), jnp.asarray(en))
        port_core.record_event_batched(pcfg, a, torch.as_tensor(blk),
                                       torch.as_tensor(en))
        port_core.record_event_batched(pcfg, b, torch.as_tensor(blk),
                                       torch.as_tensor(en),
                                       fused_fn=ops.mithril_record_fused)
    assert_state_equal(a, ref)
    assert_state_equal(b, ref)


def test_disabled_record_is_noop():
    cfg = config_from(small_cfg())
    st = port_core.init_state(cfg, "cpu", lanes=2)
    for blk in range(20):
        port_core.record(cfg, st, torch.tensor([blk, blk + 3],
                                               dtype=torch.int32))
    before = to_numpy(st)
    for blk in range(20):
        port_core.record(cfg, st, torch.tensor([blk, 7], dtype=torch.int32),
                         enabled=False)
    for name, x, y in zip(st._fields, before, to_numpy(st)):
        np.testing.assert_array_equal(x, y, err_msg=name)


def _ref_carry_type(carry):
    types = {"cache": rc.CacheState, "stats": rc.Stats,
             "mith": ref_core.MithrilState, "amp": rc.AmpState,
             "pg": rc.PgState}
    return {k: types[k](*(jnp.asarray(x) for x in v))
            for k, v in to_numpy(carry).items()}


def test_state_continues_across_packages():
    """A reference mid-run carry continues in the port, and a port
    mid-run carry continues in the reference, to the reference's end."""
    cfg = rc.SimConfig(capacity=32, use_mithril=True, use_amp=True,
                       mithril=small_cfg(prefetch_list=3))
    pcfg = config_from(cfg)
    blocks = np.stack([rc_tr(s) for s in range(3)]).T    # (T, B)
    half = blocks.shape[0] // 2
    valid = np.ones_like(blocks, bool)
    init_b, ref_step = rc.build_batched_step(cfg)
    run = jax.jit(lambda c, b, v: lax.scan(ref_step, c, (b, v)))
    whole, _ = run(init_b(3), jnp.asarray(blocks), jnp.asarray(valid))
    first, _ = run(init_b(3), jnp.asarray(blocks[:half]),
                   jnp.asarray(valid[:half]))

    # reference -> port
    _, port_step = pc.build_batched_step(pcfg, "cpu")
    carry = to_torch(jax.tree.map(np.asarray, first), "cpu")
    assert carry["mith"].rec_key.dtype == torch.int32
    for t in range(half, blocks.shape[0]):
        carry, _ = port_step(carry, torch.as_tensor(blocks[t]),
                             torch.ones(3, dtype=torch.bool))
    for k in whole:
        assert_state_equal(carry[k], whole[k], k)

    # port -> reference
    init_p, _ = pc.build_batched_step(pcfg, "cpu")
    carry = init_p(3)
    for t in range(half):
        carry, _ = port_step(carry, torch.as_tensor(blocks[t]),
                             torch.ones(3, dtype=torch.bool))
    back, _ = run(_ref_carry_type(carry), jnp.asarray(blocks[half:]),
                  jnp.asarray(valid[half:]))
    for k in whole:
        for name, x, y in zip(whole[k]._fields, back[k], whole[k]):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y),
                                          err_msg=f"{k}.{name}")


def rc_tr(seed):
    import repro.traces as rt
    return rt.association_groups(240, n_groups=5, group_size=3, reuse=30,
                                 lba_space=2048, seed=seed)


def test_convert_round_trip_keeps_int32():
    cfg = dataclasses.replace(small_cfg(), rec_buckets=16)
    ref = jax.vmap(lambda _: ref_core.init_state(cfg))(jnp.arange(2))
    port = to_torch(ref, "cpu")
    assert type(port).__module__.startswith("repro_torch")
    back = to_numpy(port)
    for x, y in zip(back, ref):
        assert x.dtype == np.int32
        np.testing.assert_array_equal(x, np.asarray(y))
    one = to_torch(jax.tree.map(lambda x: np.asarray(x[0]), ref), "cpu",
                   lanes=True)
    assert one.rec_key.shape == (1,) + tuple(ref.rec_key.shape[1:])
