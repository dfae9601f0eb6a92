"""The port's kernel modules against the reference's Pallas kernels.

On the CPU every wrapper runs its kernel's plain PyTorch version; these
tests hold those plain versions bit for bit against the Pallas kernels
in interpret mode and against the reference's pure-jnp oracles:

* ``record_step_plain`` vs the Pallas ``record_step_kernel`` in
  interpret mode (through the reference's jitted
  ``ops.mithril_record_fused``) and ``vmap(core.mithril.record_event)``,
  per event over random traces (R in {1, 2, 4}, mixed ``enabled``);
* ``pairwise_codes[_batched]_plain`` vs ``ops.mithril_pairwise[_batched]``
  (interpret mode here) and ``core.mining.pairwise_codes[_batched]``.

The CUDA kernels themselves run only on the card
(``tests/test_torch_cuda.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import MithrilConfig as RefConfig
from repro.core import init_state as ref_init_state
from repro.core import mining as ref_mining
from repro.core import record_event_batched as ref_record_batched
from repro.kernels import ops as ref_ops

from repro_torch.convert import to_numpy, to_torch
from repro_torch.core import init_state
from repro_torch.kernels import ops
from repro_torch.kernels.mithril_mine import (pairwise_codes_kernel,
                                              pairwise_codes_plain)
from repro_torch.kernels.mithril_mine_batched import (
    pairwise_codes_batched_kernel, pairwise_codes_batched_plain)
from repro_torch.kernels.mithril_record import record_step_plain

LANES = 3
RECORD_LEAVES = ("rec_key", "rec_ts", "rec_cnt", "rec_age", "rec_loc",
                 "rec_row", "mine_block", "mine_ts", "mine_cnt", "mine_fill",
                 "ts")


def small_cfg(**kw):
    base = dict(min_support=2, max_support=4, lookahead=8, rec_buckets=16,
                rec_ways=2, mine_rows=8, pf_buckets=16, pf_ways=2,
                prefetch_list=2)
    base.update(kw)
    return RefConfig(**base)


def assert_state_equal(port, ref, msg=""):
    for name, a, b in zip(ref._fields, to_numpy(port), ref):
        b = np.asarray(b)
        assert a.dtype == b.dtype, (msg, name)
        np.testing.assert_array_equal(a, b, err_msg=f"{msg} {name}")


def _drain_ref(states):
    """Out-of-band mining-table drain (what ``mine`` does to the record
    path), keeping ``mine_fill < mine_rows`` without mining."""
    return states._replace(
        rec_key=jnp.where(states.rec_loc == 1, -1, states.rec_key),
        rec_loc=jnp.zeros_like(states.rec_loc),
        mine_block=jnp.full_like(states.mine_block, -1),
        mine_ts=jnp.zeros_like(states.mine_ts),
        mine_cnt=jnp.zeros_like(states.mine_cnt),
        mine_fill=jnp.zeros_like(states.mine_fill))


@pytest.mark.parametrize("r_sup,s_sup", [(1, 4), (2, 4), (4, 8)])
@pytest.mark.parametrize("seed", [0, 1])
def test_record_plain_matches_pallas_and_scatter(r_sup, s_sup, seed):
    cfg = small_cfg(min_support=r_sup, max_support=s_sup)
    rng = np.random.default_rng(seed)
    n_events = 40
    blk = rng.integers(-3, 41, size=(n_events, LANES)).astype(np.int32)
    en = rng.integers(0, 2, size=(n_events, LANES)).astype(bool)
    ref = jax.vmap(lambda _: ref_init_state(cfg))(jnp.arange(LANES))
    kern = ref
    port = to_torch(ref, "cpu")
    scatter = jax.jit(lambda st, b, e: ref_record_batched(cfg, st, b, e))
    for t in range(n_events):
        b, e = jnp.asarray(blk[t]), jnp.asarray(en[t])
        ref = scatter(ref, b, e)
        kern = ref_ops.mithril_record_fused(kern, b, e, interpret=True)
        record_step_plain(torch.as_tensor(blk[t]),
                          torch.as_tensor(en[t].astype(np.int32)),
                          *(getattr(port, f) for f in RECORD_LEAVES))
        assert_state_equal(port, ref, f"R={r_sup} event {t}")
        assert_state_equal(port, kern, f"R={r_sup} event {t} (pallas)")
        if int(jnp.max(ref.mine_fill)) >= cfg.mine_rows - 1:
            ref, kern = _drain_ref(ref), _drain_ref(kern)
            port = to_torch(ref, "cpu")


def test_record_disabled_is_noop():
    cfg = small_cfg()
    rng = np.random.default_rng(7)
    port = init_state(cfg, "cpu", lanes=LANES)
    for _ in range(12):
        ops.mithril_record_fused(
            port, torch.as_tensor(rng.integers(0, 30, LANES), dtype=torch.int32),
            torch.ones(LANES, dtype=torch.bool))
    before = to_numpy(port)
    for blk in range(30):
        ops.mithril_record_fused(port, torch.full((LANES,), blk,
                                                  dtype=torch.int32),
                                 torch.zeros(LANES, dtype=torch.bool))
    for a, b in zip(before, to_numpy(port)):
        np.testing.assert_array_equal(a, b)


def make_table(rng, n, s, spread=30, min_support=2):
    cnt = rng.integers(0, s + 2, size=n).astype(np.int32)
    base = np.sort(rng.integers(0, 40 * n, size=n)).astype(np.int32)
    ts = np.zeros((n, s), np.int32)
    for i in range(n):
        c = min(int(cnt[i]), s)
        if c:
            ts[i, :c] = np.sort(rng.integers(0, spread, size=c)) + base[i]
    valid = (cnt >= min_support) & (cnt <= s)
    return ts, cnt, valid


PAIRWISE_CASES = [(64, 4, 8, 8), (96, 8, 25, 16), (48, 8, 100, 47),
                  (33, 4, 5, 7), (20, 4, 10, 30), (1, 8, 4, 4)]


@pytest.mark.parametrize("n,s,delta,window", PAIRWISE_CASES)
def test_pairwise_plain_matches_pallas_and_oracle(rng, n, s, delta, window):
    ts, cnt, valid = make_table(rng, n, s)
    got = pairwise_codes_plain(torch.as_tensor(ts), torch.as_tensor(cnt),
                               torch.as_tensor(valid), delta, window)
    assert got.dtype == torch.int32 and got.shape == (n, window)
    want = ref_mining.pairwise_codes(jnp.asarray(ts), jnp.asarray(cnt),
                                     jnp.asarray(valid), delta, window)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    pallas = ref_ops.mithril_pairwise(jnp.asarray(ts), jnp.asarray(cnt),
                                      jnp.asarray(valid), delta, window)
    np.testing.assert_array_equal(got.numpy(), np.asarray(pallas))


@pytest.mark.parametrize("lanes,n,s,delta,window",
                         [(1, 64, 4, 8, 8), (3, 96, 8, 25, 16),
                          (4, 33, 4, 5, 7), (2, 16, 8, 100, 15)])
def test_pairwise_batched_plain_matches_pallas_and_oracle(rng, lanes, n, s,
                                                          delta, window):
    tabs = [make_table(rng, n, s) for _ in range(lanes)]
    ts, cnt, valid = (np.stack([t[i] for t in tabs]) for i in range(3))
    got = pairwise_codes_batched_plain(
        torch.as_tensor(ts), torch.as_tensor(cnt), torch.as_tensor(valid),
        delta, window)
    want = ref_mining.pairwise_codes_batched(
        jnp.asarray(ts), jnp.asarray(cnt), jnp.asarray(valid), delta, window)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    pallas = ref_ops.mithril_pairwise_batched(
        jnp.asarray(ts), jnp.asarray(cnt), jnp.asarray(valid), delta, window)
    np.testing.assert_array_equal(got.numpy(), np.asarray(pallas))
    for lane in range(lanes):     # every lane equals the one-lane form
        one = pairwise_codes_plain(torch.as_tensor(ts[lane]),
                                   torch.as_tensor(cnt[lane]),
                                   torch.as_tensor(valid[lane]), delta,
                                   window)
        np.testing.assert_array_equal(got[lane].numpy(), one.numpy())


def test_pairwise_all_invalid_rows():
    ts = torch.zeros((32, 4), dtype=torch.int32)
    cnt = torch.zeros((32,), dtype=torch.int32)
    valid = torch.zeros((32,), dtype=torch.bool)
    assert int(pairwise_codes_plain(ts, cnt, valid, 10, 8).sum()) == 0


def test_cpu_wrappers_take_plain_and_launch_nothing(rng):
    ops.reset_launch_counts()
    ts, cnt, valid = (torch.as_tensor(x) for x in make_table(rng, 40, 8))
    np.testing.assert_array_equal(
        ops.mithril_pairwise(ts, cnt, valid, 20, 10).numpy(),
        pairwise_codes_plain(ts, cnt, valid, 20, 10).numpy())
    np.testing.assert_array_equal(
        ops.mithril_pairwise_batched(ts[None], cnt[None], valid[None], 20,
                                     10).numpy(),
        pairwise_codes_plain(ts, cnt, valid, 20, 10)[None].numpy())
    state = init_state(small_cfg(), "cpu", lanes=2)
    ops.mithril_record_fused(state, torch.tensor([3, 4], dtype=torch.int32),
                             torch.tensor([True, False]))
    assert int(state.ts.sum()) == 1
    assert ops.launch_counts() == {k: 0 for k in ops.KERNELS}


def test_kernel_wrappers_reject_bad_inputs():
    """Shape and dtype checks run before any launch (CPU tensors take the
    plain path, so the checks are exercised through the meta device)."""
    ts = torch.zeros((2, 16, 4), dtype=torch.int32, device="meta")
    with pytest.raises(TypeError):
        pairwise_codes_batched_kernel(ts, torch.zeros((2, 16), device="meta"),
                                      torch.zeros((2, 16), dtype=torch.bool,
                                                  device="meta"), 4, 4)
    with pytest.raises(ValueError):
        pairwise_codes_kernel(ts, ts, ts, 4, 4)
