"""The serving tier's miss against the reference, event by event.

One miss of a ``TieredKVCache`` with MITHRIL is, in the reference,
``repro.core.mithril.record`` (the record event, then a mining run when
the mining table is full) followed by ``repro.core.mithril.lookup``. The
port does it as ``miss_step_plain`` (the record event, ``need``, the
probe of the prefetch table), then, when ``need``, ``maybe_mine`` and the
lookup again; on the card that first step is one launch
(``miss_step_kernel``, held against ``miss_step_plain`` in
``tests/test_torch_cuda.py``). The same seeded page streams, EMPTY pages
among them, go through both on the CPU; every state leaf and the
candidates must be equal after every event, over several mining runs.

Also: ``ops.MissStep`` and ``miss_step_kernel`` take the plain version
for CPU tensors and launch nothing; the ctypes argument blocks have the
layout the CUDA sources assert; a bound launcher checks a state in full
once and again whenever a tensor is swapped or reshaped after binding
(on meta tensors, which reach the checks without a card); the fused
record wrapper gives the same state for every form of ``enabled``.
"""

import ctypes

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as ref_core
from repro.core import MithrilConfig as RefConfig

import repro_torch.core as port_core
from repro_torch.convert import config_from, to_numpy
from repro_torch.kernels import backend, ops
from repro_torch.kernels.mithril_record import (LEAVES, MissArgs,
                                                RecordArgs, miss_args,
                                                miss_step_kernel,
                                                miss_step_plain, record_args)

# chip_smoke.py's serving_mcfg (benchmarks/serving_bench.py's MCFG)
SERVING = dict(min_support=2, max_support=8, lookahead=40, rec_buckets=512,
               rec_ways=4, mine_rows=8, pf_buckets=512, pf_ways=4,
               prefetch_list=3)
CONFIGS = {
    "serving_mcfg": SERVING,
    "min_support_1": dict(SERVING, min_support=1),
    # tiny tables: bucket collisions, victims by age, evicted sources
    "small_tables": dict(SERVING, rec_buckets=8, rec_ways=2, pf_buckets=4,
                         pf_ways=2, mine_rows=6, prefetch_list=2),
}


def page_stream(rng, n_events, n_sets=10, set_size=4, universe=200):
    """Multi-tenant misses: each step one working set's pages in order,
    now and then a stray page, and a few EMPTY (-1) pages."""
    sets = [rng.choice(universe, set_size, replace=False)
            for _ in range(n_sets)]
    out = []
    while len(out) < n_events:
        out.extend(int(p) for p in sets[rng.integers(n_sets)])
        if rng.random() < 0.2:
            out.append(int(rng.integers(universe)))
        if rng.random() < 0.03:
            out.append(-1)
    return out[:n_events] + [-1]


def assert_lane0_equal(port, ref, msg):
    for name, a, b in zip(ref._fields, to_numpy(port), ref):
        np.testing.assert_array_equal(a[0], np.asarray(b),
                                      err_msg=f"{msg} {name}")


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_miss_step_then_mine_then_lookup_equals_reference(name, seed):
    ref_cfg = RefConfig(**CONFIGS[name])
    cfg = config_from(ref_cfg)
    record = jax.jit(lambda st, blk: ref_core.record(ref_cfg, st, blk))
    lookup = jax.jit(lambda st, blk: ref_core.lookup(ref_cfg, st, blk))
    ref = ref_core.init_state(ref_cfg)
    port = port_core.init_state(cfg, "cpu")
    needs = hits = 0
    for i, page in enumerate(page_stream(np.random.default_rng(seed), 400)):
        mines = int(ref.n_mines)
        ref = record(ref, jnp.int32(page))
        want = np.asarray(lookup(ref, jnp.int32(page)))
        res = miss_step_plain(page, port, cfg.mine_rows)
        assert res.dtype == torch.int32 and res.shape == (1 + cfg.prefetch_list,)
        need, cand = bool(res[0]), res[1:]
        assert need == (int(ref.n_mines) > mines), (i, page)
        if need:
            port_core.maybe_mine(cfg, port)
            cand = ops.prefetch_lookup(torch.tensor([page]), port.pf_key[0],
                                       port.pf_vals[0])[0]
        needs += need
        hits += bool((want >= 0).any())
        np.testing.assert_array_equal(cand.numpy(), want,
                                      err_msg=f"event {i}, page {page}")
        assert_lane0_equal(port, ref, f"event {i}, page {page}")
    assert needs >= 3 and hits > 0


@pytest.mark.parametrize("name", list(CONFIGS))
def test_miss_step_on_the_cpu_takes_plain_and_launches_nothing(name):
    """``ops.MissStep`` (the tier's miss) and ``miss_step_kernel`` on CPU
    tensors give the plain version's result and state, launching nothing."""
    cfg = config_from(RefConfig(**CONFIGS[name]))
    a, b, c = (port_core.init_state(cfg, "cpu") for _ in range(3))
    step = ops.MissStep(cfg.mine_rows, cfg.prefetch_list, torch.device("cpu"))
    out = torch.empty(1 + cfg.prefetch_list, dtype=torch.int32)
    ops.reset_launch_counts()
    for page in page_stream(np.random.default_rng(5), 200):
        want = miss_step_plain(page, a, cfg.mine_rows)
        need, cand = step(b, page)
        miss_step_kernel(page, c, cfg.mine_rows, out)
        assert need == bool(want[0]) and torch.equal(out, want)
        assert cand == [x for x in want[1:].tolist() if x >= 0]
        if need:
            for st in (a, b, c):
                port_core.maybe_mine(cfg, st)
    for x, y, z in zip(to_numpy(a), to_numpy(b), to_numpy(c)):
        np.testing.assert_array_equal(x, y)
        np.testing.assert_array_equal(x, z)
    assert ops.launch_counts() == {k: 0 for k in ops.KERNELS}


def test_argument_blocks_have_the_layout_the_cuda_sources_assert():
    """``RecordArgs``/``MissArgs`` mirror ``RecordTables`` (112 bytes) and
    ``MissArgs`` (152 bytes), which the sources ``static_assert``."""
    assert ctypes.sizeof(RecordArgs) == 112
    assert ctypes.sizeof(MissArgs) == 152
    assert RecordArgs.lanes.offset == 11 * 8
    assert MissArgs.pf_key.offset == 112 and MissArgs.pf_nb.offset == 136


def meta_state(cfg, lanes=1):
    st = port_core.init_state(cfg, "cpu", lanes=lanes)
    return type(st)(*(torch.empty_like(x, device="meta") for x in st))


def test_bound_launchers_recheck_a_swapped_or_reshaped_tensor():
    """A binding checks every tensor at the first call, reuses the
    arguments while it gets the same tensors at the same addresses, and
    checks in full again (so raises) when one is swapped, reshaped or
    retyped after binding."""
    cfg = config_from(RefConfig(**SERVING))
    st = meta_state(cfg)
    leaves = tuple(getattr(st, f) for f in LEAVES)
    bound = backend.Bound(record_args)
    args = bound(leaves)
    assert (args.lanes, args.nb, args.ways, args.r_sup, args.nm,
            args.s_sup) == (1, 512, 4, 2, 8, 8)
    assert bound(leaves) is args and bound.binds == 1
    views = tuple(x.view(x.shape) for x in leaves)    # other objects
    assert bound(views) is not args and bound.binds == 2
    args = bound(leaves)
    i = LEAVES.index("rec_key")
    with pytest.raises(ValueError):          # reshaped after binding
        bound(leaves[:i] + (leaves[i].reshape(1, 256, 8),) + leaves[i + 1:])
    with pytest.raises(TypeError):           # swapped for another dtype
        bound(leaves[:i] + (leaves[i].float(),) + leaves[i + 1:])
    with pytest.raises(ValueError):          # swapped for a CPU tensor
        bound(leaves[:i] + (torch.zeros(leaves[i].shape, dtype=torch.int32),)
              + leaves[i + 1:])
    j = LEAVES.index("mine_ts")
    with pytest.raises(ValueError):          # more rows than mine_block
        bound(leaves[:j] + (torch.empty((1, 9, 8), dtype=torch.int32,
                                        device="meta"),) + leaves[j + 1:])
    # a failed binding keeps the last good one
    assert bound(leaves) is args and bound.binds == 3

    out = torch.empty(1 + cfg.prefetch_list, dtype=torch.int32, device="meta")
    miss = backend.Bound(miss_args)
    margs = miss((*leaves, st.pf_key, st.pf_vals, out), cfg.mine_rows)
    assert (margs.pf_nb, margs.pf_ways, margs.plist, margs.mine_rows) == \
        (512, 4, 3, 8)
    assert miss((*leaves, st.pf_key, st.pf_vals, out), cfg.mine_rows) is margs
    with pytest.raises(TypeError):           # pf_vals swapped for int64
        miss((*leaves, st.pf_key, st.pf_vals.long(), out), cfg.mine_rows)
    with pytest.raises(ValueError):          # pf_key reshaped
        miss((*leaves, st.pf_key.reshape(1, 1024, 2), st.pf_vals, out),
             cfg.mine_rows)
    with pytest.raises(ValueError):          # an output of another length
        miss((*leaves, st.pf_key, st.pf_vals, out[:2]), cfg.mine_rows)
    two = meta_state(cfg, lanes=2)
    with pytest.raises(ValueError):          # the miss takes one lane
        miss((*(getattr(two, f) for f in LEAVES), two.pf_key, two.pf_vals,
              out), cfg.mine_rows)


def test_record_and_miss_wrappers_reject_bad_inputs():
    """The full checks run before any launch (through the meta device)."""
    from repro_torch.kernels.mithril_record import record_step_kernel
    cfg = config_from(RefConfig(**SERVING))
    st = meta_state(cfg, lanes=3)
    leaves = [getattr(st, f) for f in LEAVES]
    blk = torch.zeros(3, dtype=torch.int32, device="meta")
    with pytest.raises(TypeError):
        record_step_kernel(blk.long(), blk, *leaves)
    with pytest.raises(ValueError):
        record_step_kernel(blk[:2], blk, *leaves)
    with pytest.raises(TypeError):
        record_step_kernel(blk, blk.float(), *leaves)
    wide = config_from(RefConfig(**dict(SERVING, rec_ways=33)))
    with pytest.raises(ValueError):          # more ways than a warp
        record_step_kernel(blk, blk, *(getattr(meta_state(wide, 3), f)
                                       for f in LEAVES))
    out = torch.empty(4, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):          # three lanes
        miss_step_kernel(3, st, cfg.mine_rows, out)
    one = meta_state(cfg)
    with pytest.raises(ValueError):          # not an int32 page
        miss_step_kernel(1 << 31, one, cfg.mine_rows, out)


@pytest.mark.parametrize("enabled", ["true", "bool", "int32", "scalar"])
def test_fused_record_takes_every_form_of_enabled(enabled):
    """``True``, a bool or int32 (B,) tensor and a scalar tensor give the
    state the plain record event gives (the kernel takes bool or int32
    flags, so neither is converted on the card)."""
    cfg = config_from(RefConfig(**dict(SERVING, rec_buckets=16)))
    rng = np.random.default_rng(7)
    a = port_core.init_state(cfg, "cpu", lanes=4)
    b = port_core.init_state(cfg, "cpu", lanes=4)
    for _ in range(60):
        blk = torch.as_tensor(rng.integers(0, 30, 4), dtype=torch.int32)
        en = {"true": True, "bool": torch.ones(4, dtype=torch.bool),
              "int32": torch.ones(4, dtype=torch.int32),
              "scalar": torch.tensor(1)}[enabled]
        ops.mithril_record_fused(a, blk, en)
        port_core.record_event(cfg, b, blk, True)
        for st in (a, b):
            full = st.mine_fill >= cfg.mine_rows
            st.mine_fill.masked_fill_(full, 0)
    for x, y in zip(to_numpy(a), to_numpy(b)):
        np.testing.assert_array_equal(x, y)
    assert ops._ones(4, torch.device("cpu")).tolist() == [1, 1, 1, 1]
