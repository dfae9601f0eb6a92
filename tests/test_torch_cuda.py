"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA GPU (``nvcc`` builds the kernels on first
use) and skip elsewhere. They import neither JAX nor the reference, so
they run where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from repro_torch.convert import to_numpy
from repro_torch.core import MithrilConfig, init_state
from repro_torch.kernels import ops
from repro_torch.kernels.mithril_mine import pairwise_codes_kernel
from repro_torch.kernels.mithril_mine_batched import (
    pairwise_codes_batched_kernel, pairwise_codes_batched_plain)
from repro_torch.kernels.mithril_mine_step import (mine_step_kernel,
                                                   mine_step_plain)
from repro_torch.kernels.mithril_record import (miss_step_kernel,
                                                miss_step_plain,
                                                record_step_kernel,
                                                record_step_plain)

RECORD_LEAVES = ("rec_key", "rec_ts", "rec_cnt", "rec_age", "rec_loc",
                 "rec_row", "mine_block", "mine_ts", "mine_cnt", "mine_fill",
                 "ts")
PAIRWISE_CASES = [(64, 4, 8, 8), (96, 8, 25, 16), (48, 8, 100, 47),
                  (33, 4, 5, 7), (20, 4, 10, 30), (1, 8, 4, 4),
                  (1024, 8, 100, 100)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernels run only on the card")
    return torch.device("cuda")


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


@pytest.mark.cuda
@pytest.mark.parametrize("ways", [1, 4, 32])
@pytest.mark.parametrize("r_sup", [1, 2, 4])
def test_record_kernel_matches_plain(cuda, r_sup, ways):
    """Mixed enabled lanes, the flags as int32 and as bool in turn; 64
    recording slots a lane, a hot set of keys that recur (migrations,
    mining-row appends, frequent marks) and cold keys that fill every
    bucket (victims by age)."""
    cfg = MithrilConfig(min_support=r_sup, max_support=max(4, r_sup),
                        lookahead=8, rec_buckets=64 // ways, rec_ways=ways,
                        mine_rows=512)
    rng = np.random.default_rng(r_sup * 100 + ways)
    gpu = init_state(cfg, cuda, lanes=5)
    cpu = init_state(cfg, "cpu", lanes=5)
    before = ops.launch_counts()["mithril_record"]
    for i in range(300):
        blk = np.where(rng.random(5) < 0.6, rng.integers(-2, 18, 5),
                       rng.integers(0, 10**6, 5)).astype(np.int32)
        en = rng.integers(0, 2, 5).astype(np.int32)
        en_gpu = torch.as_tensor(en, device=cuda)
        record_step_kernel(torch.as_tensor(blk, device=cuda),
                           en_gpu.bool() if i % 2 else en_gpu,
                           *(getattr(gpu, f) for f in RECORD_LEAVES))
        record_step_plain(torch.as_tensor(blk), torch.as_tensor(en),
                          *(getattr(cpu, f) for f in RECORD_LEAVES))
    torch.cuda.synchronize()
    assert ops.launch_counts()["mithril_record"] == before + 300
    for name, a, b in zip(gpu._fields, to_numpy(gpu), to_numpy(cpu)):
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert int(cpu.mine_fill.min()) > 0
    assert int((cpu.rec_key != -1).sum(-1).max()) == ways   # a full bucket


def page_stream(rng, n_events, n_sets=10, universe=200):
    """Working sets of 4 pages replayed in random order, stray pages and
    a few EMPTY (-1) pages: the misses of a multi-tenant tier."""
    sets = [rng.choice(universe, 4, replace=False) for _ in range(n_sets)]
    out = []
    while len(out) < n_events:
        out.extend(int(p) for p in sets[rng.integers(n_sets)])
        if rng.random() < 0.2:
            out.append(int(rng.integers(universe)))
        if rng.random() < 0.03:
            out.append(-1)
    return out[:n_events] + [-1]


MISS_CONFIGS = {
    # chip_smoke.py's serving_mcfg
    "serving": dict(min_support=2, max_support=8, lookahead=40,
                    rec_buckets=512, rec_ways=4, mine_rows=8, pf_buckets=512,
                    pf_ways=4, prefetch_list=3),
    "r1_small": dict(min_support=1, max_support=4, lookahead=40,
                     rec_buckets=8, rec_ways=2, mine_rows=6, pf_buckets=4,
                     pf_ways=2, prefetch_list=2),
    # more ways and values than a warp's lanes: the probe's second chunk
    "wide_prefetch": dict(min_support=2, max_support=8, lookahead=40,
                          rec_buckets=16, rec_ways=32, mine_rows=8,
                          pf_buckets=2, pf_ways=40, prefetch_list=33),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(MISS_CONFIGS))
def test_miss_launch_matches_plain(cuda, name):
    """The tier's miss (``ops.MissStep``: one launch, the result read
    from pinned memory after one wait) against ``miss_step_plain`` on a
    copy of the state, exactly, event by event, with need = 0 and 1 (both
    states mine when need is 1); and the launch into a device buffer."""
    from repro_torch.core import maybe_mine
    cfg = MithrilConfig(**MISS_CONFIGS[name])
    a, b, c = (init_state(cfg, cuda) for _ in range(3))
    step = ops.MissStep(cfg.mine_rows, cfg.prefetch_list, cuda)
    dev_out = torch.empty(1 + cfg.prefetch_list, dtype=torch.int32,
                          device=cuda)
    before = ops.launch_counts()["mithril_miss_step"]
    needs = hits = n = 0
    for page in page_stream(np.random.default_rng(11), 400):
        want = miss_step_plain(page, b, cfg.mine_rows).tolist()
        need, cand = step(a, page)
        miss_step_kernel(page, c, cfg.mine_rows, dev_out)
        assert dev_out.tolist() == want, page
        assert need == bool(want[0])
        assert cand == [x for x in want[1:] if x >= 0], page
        needs += need
        hits += bool(cand)
        n += 1
        if need:
            for st in (a, b, c):
                maybe_mine(cfg, st)
        for f in RECORD_LEAVES:
            assert torch.equal(getattr(a, f), getattr(b, f)), (page, f)
    for x, y, z in zip(to_numpy(a), to_numpy(b), to_numpy(c)):
        np.testing.assert_array_equal(x, y)
        np.testing.assert_array_equal(x, z)
    assert ops.launch_counts()["mithril_miss_step"] == before + 2 * n
    assert needs >= 3 and hits > 0


@pytest.mark.cuda
@pytest.mark.parametrize("plist", [1, 3, 33])
@pytest.mark.parametrize("ways", [1, 4, 32, 48])
def test_hash_lookup_warp_probe_matches_plain(cuda, ways, plist):
    """Keys in their own buckets, a quarter of the ways empty (hits in
    the second chunk of ways at W = 48), values on empty ways, EMPTY
    queries (which match the last way of their bucket, its only empty
    one, and return its values), misses; Q not a multiple of the block's
    warps."""
    from repro_torch.kernels.hash_lookup import (hash_lookup_kernel,
                                                 hash_lookup_plain)
    from repro_torch.core.hashindex import bucket_index
    nb = 8
    rng = np.random.default_rng(ways * 100 + plist)
    cand = rng.choice(10**6, 40 * nb * ways, replace=False).astype(np.int32)
    home = bucket_index(torch.as_tensor(cand), nb).numpy()
    full = np.stack([cand[home == b][:ways] for b in range(nb)])
    pf_key = np.where(rng.random((nb, ways)) < 0.25, -1, full)
    # the EMPTY query's bucket: its only empty way is the last one
    e = int(bucket_index(torch.tensor([-1]), nb))
    pf_key[e] = full[e]
    pf_key[e, -1] = -1
    pf_vals = rng.integers(0, 10**6, (nb, ways, plist)).astype(np.int32)
    live = pf_key[pf_key >= 0]
    qs = np.concatenate([rng.choice(live, 200), [-1] * 7,
                         rng.integers(10**6, 2 * 10**6, 50)]).astype(np.int32)
    qs = torch.as_tensor(rng.permutation(qs))
    pf_key, pf_vals = torch.as_tensor(pf_key), torch.as_tensor(pf_vals)
    want = hash_lookup_plain(qs, pf_key, pf_vals)
    got = hash_lookup_kernel(qs.to(cuda), pf_key.to(cuda), pf_vals.to(cuda))
    np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("n,s,delta,window", PAIRWISE_CASES)
def test_pairwise_kernels_match_plain(cuda, n, s, delta, window):
    rng = np.random.default_rng(n + window)
    tabs = [make_table(rng, n, s) for _ in range(3)]
    ts, cnt, valid = (torch.as_tensor(np.stack([t[i] for t in tabs]))
                      for i in range(3))
    want = pairwise_codes_batched_plain(ts, cnt, valid, delta, window)
    got = pairwise_codes_batched_kernel(ts.to(cuda), cnt.to(cuda),
                                        valid.to(cuda), delta, window)
    np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())
    one = pairwise_codes_kernel(ts[1].to(cuda), cnt[1].to(cuda),
                                valid[1].to(cuda), delta, window)
    np.testing.assert_array_equal(one.cpu().numpy(), want[1].numpy())


@pytest.mark.cuda
def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    ts = torch.zeros((2, 16, 4), dtype=torch.int32, device=cuda)
    cnt = torch.zeros((2, 16), dtype=torch.int32, device=cuda)
    valid = torch.zeros((2, 16), dtype=torch.bool, device=cuda)
    with pytest.raises(TypeError):
        pairwise_codes_batched_kernel(ts, cnt.float(), valid, 4, 4)
    with pytest.raises(ValueError):
        pairwise_codes_batched_kernel(ts, cnt, valid.cpu(), 4, 4)
    with pytest.raises(ValueError):
        pairwise_codes_batched_kernel(ts.transpose(1, 2).contiguous()
                                      .transpose(1, 2), cnt, valid, 4, 4)

    # a state bound by a launch, then a tensor swapped or reshaped
    cfg = MithrilConfig(min_support=2, max_support=4, lookahead=8,
                        rec_buckets=64, rec_ways=4, mine_rows=16,
                        pf_buckets=16, pf_ways=4, prefetch_list=3)
    st = init_state(cfg, cuda, lanes=2)
    blk = torch.zeros(2, dtype=torch.int32, device=cuda)
    leaves = [getattr(st, f) for f in RECORD_LEAVES]
    record_step_kernel(blk, blk, *leaves)
    with pytest.raises(TypeError):
        record_step_kernel(blk, blk, leaves[0].float(), *leaves[1:])
    with pytest.raises(ValueError):
        record_step_kernel(blk, blk, leaves[0].reshape(2, 32, 8), *leaves[1:])
    with pytest.raises(ValueError):
        record_step_kernel(blk, blk, leaves[0], leaves[1].cpu(), *leaves[2:])
    with pytest.raises(TypeError):
        record_step_kernel(blk, blk.float(), *leaves)
    record_step_kernel(blk, blk.bool(), *leaves)

    # the miss launcher: one lane, an output on the card or pinned
    one = init_state(cfg, cuda)
    out = torch.empty(4, dtype=torch.int32, device=cuda)
    miss_step_kernel(5, one, cfg.mine_rows, out)
    with pytest.raises(ValueError):
        miss_step_kernel(5, st, cfg.mine_rows, out)          # two lanes
    with pytest.raises(ValueError):
        miss_step_kernel(5, one, cfg.mine_rows, out[:3])
    with pytest.raises(ValueError):                          # pageable
        miss_step_kernel(5, one, cfg.mine_rows, out.cpu())
    with pytest.raises(TypeError):
        miss_step_kernel(5, one._replace(pf_vals=one.pf_vals.long()),
                         cfg.mine_rows, out)
    with pytest.raises(ValueError):
        miss_step_kernel(5, one._replace(rec_ts=one.rec_ts.reshape(
            1, 64, 8, 1)), cfg.mine_rows, out)
    with pytest.raises(ValueError):
        miss_step_kernel(1 << 31, one, cfg.mine_rows, out)
    miss_step_kernel(5, one, cfg.mine_rows, out.cpu().pin_memory())
    torch.cuda.synchronize()


# the shapes of tests/test_kernels.py::TestPagedDecodeKernel, then
# llama3.2-3b's attention widths at the full-width serving batch and at
# one row, and G = 16 at hd = 256 (the kernel's limits)
DECODE_SHAPES = [(2, 8, 2, 32, 16, 4), (1, 4, 4, 64, 32, 8),
                 (3, 16, 8, 64, 8, 6), (2, 4, 1, 128, 64, 2),
                 (5, 24, 8, 128, 16, 128), (1, 24, 8, 128, 16, 128),
                 (2, 32, 2, 256, 16, 3)]
DECODE_TOLS = [(torch.float32, 2e-5), (torch.bfloat16, 2e-2)]


def decode_case(shape, dtype, lengths=None, seed=None):
    """CPU inputs from numpy; ``lengths`` None draws them in [0, full]."""
    b, hq, hkv, hd, ps, npg = shape
    rng = np.random.default_rng(b * hq + npg if seed is None else seed)
    n_total = npg * b + 2
    q = torch.as_tensor(rng.standard_normal((b, hq, hd)), dtype=dtype)
    kp, vp = (torch.as_tensor(rng.standard_normal((n_total, ps, hkv, hd)),
                              dtype=dtype) for _ in range(2))
    tab = torch.as_tensor(rng.choice(n_total, (b, npg), replace=False),
                          dtype=torch.int32)
    if lengths is None:
        lengths = rng.integers(0, npg * ps + 1, b)
    return q, kp, vp, tab, torch.as_tensor(lengths, dtype=torch.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", DECODE_TOLS)
@pytest.mark.parametrize("b,hq,hkv,hd,ps,npg", DECODE_SHAPES)
def test_paged_decode_kernel_matches_plain(cuda, b, hq, hkv, hd, ps, npg,
                                           dtype, tol):
    from repro_torch.kernels.paged_decode import (paged_decode_kernel,
                                                  paged_decode_plain)
    q, kp, vp, tab, lens = decode_case((b, hq, hkv, hd, ps, npg), dtype)
    want = paged_decode_plain(q, kp, vp, tab, lens)
    before = ops.launch_counts()["paged_decode"]
    got = paged_decode_kernel(*(x.to(cuda) for x in (q, kp, vp, tab, lens)))
    torch.cuda.synchronize()
    assert ops.launch_counts()["paged_decode"] == before + 1
    assert got.dtype == dtype
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().numpy(), rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["zero", "one", "ragged", "full"])
@pytest.mark.parametrize("dtype,tol", DECODE_TOLS)
@pytest.mark.parametrize("shape", DECODE_SHAPES)
def test_paged_decode_kernel_at_lengths(cuda, shape, dtype, tol, kind):
    """Every row at length 0 (every page read, V averaged), 1 (one page
    read, later splits empty), not a page multiple, or full; the plan's
    split and one split a page."""
    from repro_torch.kernels.paged_decode import (paged_decode_kernel,
                                                  paged_decode_plain)
    b, _, _, _, ps, npg = shape
    full = npg * ps
    lengths = {"zero": [0] * b, "one": [1] * b,
               "ragged": [full // 2 + 1 + 3 * i for i in range(b)],
               "full": [full] * b}[kind]
    lengths = [min(n, full) for n in lengths]
    args = decode_case(shape, dtype, lengths)
    want = paged_decode_plain(*args).float().numpy()
    for pps in (None, 1):
        got = paged_decode_kernel(*(x.to(cuda) for x in args),
                                  pages_per_split=pps)
        torch.cuda.synchronize()
        assert got.dtype == dtype
        np.testing.assert_allclose(got.float().cpu().numpy(), want,
                                   rtol=tol, atol=tol, err_msg=f"pps={pps}")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", DECODE_SHAPES[4:6])
def test_paged_decode_kernel_is_bit_identical_between_calls(cuda, shape):
    """The splits merge in a fixed order: two calls give the same bits."""
    from repro_torch.kernels.paged_decode import paged_decode_kernel
    args = [x.to(cuda) for x in decode_case(shape, torch.float32)]
    first = paged_decode_kernel(*args)
    second = paged_decode_kernel(*args)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.cuda
def test_paged_decode_merges_only_a_split_plan(cuda):
    """A one-split plan launches no merge; a plan of many splits launches
    exactly one merge a call."""
    from repro_torch.kernels.paged_decode import (paged_decode_kernel,
                                                  split_plan)
    n_sm = torch.cuda.get_device_properties(cuda).multi_processor_count
    quick, full = (3, 4, 2, 32, 8, 4), (5, 24, 8, 128, 16, 128)
    assert split_plan(3, 2, 4, 8, n_sm)[1] == 1
    assert split_plan(5, 8, 128, 16, n_sm)[1] > 1
    for shape, merges in ((quick, 0), (full, 1)):
        args = [x.to(cuda) for x in decode_case(shape, torch.float32)]
        calls = paged_decode_kernel.launches
        before = paged_decode_kernel.merge_launches
        for _ in range(3):
            paged_decode_kernel(*args)
        torch.cuda.synchronize()
        assert paged_decode_kernel.launches == calls + 3
        assert paged_decode_kernel.merge_launches == before + 3 * merges


@pytest.mark.cuda
@pytest.mark.parametrize("nb,w,p,nq", [(64, 4, 2, 64), (256, 4, 3, 100),
                                       (32, 2, 2, 7), (512, 4, 3, 1),
                                       (16384, 4, 2, 5000)])
def test_hash_lookup_kernel_matches_plain(cuda, nb, w, p, nq):
    from repro_torch.kernels.hash_lookup import (hash_lookup_kernel,
                                                 hash_lookup_plain)
    from repro_torch.core.hashindex import bucket_index
    rng = np.random.default_rng(nb + nq)
    keys = torch.as_tensor(rng.choice(10**6, nb * w, replace=False),
                           dtype=torch.int32)
    pf_key = torch.full((nb, w), -1, dtype=torch.int32)
    for k, b in zip(keys.tolist(), bucket_index(keys, nb).tolist()):
        free = (pf_key[b] == -1).nonzero()
        if len(free):
            pf_key[b, free[0, 0]] = k
    pf_vals = torch.as_tensor(rng.integers(0, 10**6, (nb, w, p)),
                              dtype=torch.int32)
    qs = keys[torch.as_tensor(rng.integers(0, nb * w, nq))].clone()
    miss = torch.as_tensor(rng.random(nq) < 0.3)
    qs[miss] = torch.as_tensor(rng.integers(-1, 2 * 10**6, int(miss.sum())),
                               dtype=torch.int32)
    qs[:1] = -1
    want = hash_lookup_plain(qs, pf_key, pf_vals)
    got = hash_lookup_kernel(qs.to(cuda), pf_key.to(cuda), pf_vals.to(cuda))
    np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())


@pytest.mark.cuda
def test_tier_on_the_card_matches_the_cpu(cuda):
    """Counters, slots and decode outputs of a MITHRIL tier on the card
    equal those of the same tier on the CPU."""
    from repro_torch.cache.tiered import TieredKVCache
    cfg = MithrilConfig(min_support=2, max_support=8, lookahead=30,
                        rec_buckets=256, rec_ways=4, mine_rows=8,
                        pf_buckets=256, pf_ways=4, prefetch_list=3)
    kw = dict(n_host_pages=200, n_hbm_slots=16, page_size=8, n_kv=2,
              head_dim=16, mithril_cfg=cfg)
    gpu = TieredKVCache(**kw, device=cuda)
    cpu = TieredKVCache(**kw, device="cpu")
    rng = np.random.default_rng(3)
    reqs = [rng.choice(200, 4, replace=False) for _ in range(12)]
    before = ops.launch_counts()
    for _ in range(60):
        batch = [reqs[i] for i in rng.choice(12, 3, replace=False)]
        q = torch.as_tensor(rng.standard_normal((3, 8, 16)),
                            dtype=torch.float32)
        lengths = np.array([32, 29, 17])
        got = gpu.attend_batch(q, batch, lengths)
        want = cpu.attend_batch(q, batch, lengths)
        np.testing.assert_allclose(got.cpu().numpy(), want.numpy(),
                                   rtol=2e-5, atol=2e-5)
    assert gpu.stats == cpu.stats and gpu.stats.prefetch_used > 0
    np.testing.assert_array_equal(gpu.slot_page, cpu.slot_page)
    after = ops.launch_counts()
    # a miss is one launch (record + probe); a mining run is one launch
    # and the lookup kernel runs only after one
    for name in ("mithril_miss_step", "mithril_mine_step", "hash_lookup",
                 "paged_decode"):
        assert after[name] > before[name], name
    assert after["mithril_miss_step"] - before["mithril_miss_step"] == \
        gpu.stats.demand_fetches
    assert after["mithril_mine_step"] - before["mithril_mine_step"] == \
        after["hash_lookup"] - before["hash_lookup"]
    for name in ("mithril_record", "mithril_pairwise",
                 "mithril_pairwise_batched"):
        assert after[name] == before[name], name


# ---------------------------------------------------------------------------
# the fused mining run and the redesigned codes launch
# ---------------------------------------------------------------------------

# chip_smoke.py's pairwise cases of the kernels phase, (L, N, S, delta, W)
PHASE_PAIRWISE_CASES = [(1, 1024, 8, 100, 100), (16, 1024, 8, 100, 100),
                        (135, 1024, 8, 100, 100), (16, 64, 8, 100, 63),
                        (1, 8, 8, 40, 7), (3, 1000, 8, 100, 100),
                        (4, 64, 8, 100, 63), (2, 40, 4, 50, 90),
                        (2, 300, 12, 30, 300)]
MINE_CONFIGS = {
    # chip_smoke.py's serving_mcfg: one lane, N = 8, W = 7
    "serving": (dict(min_support=2, max_support=8, lookahead=40,
                     rec_buckets=512, rec_ways=4, mine_rows=8,
                     pf_buckets=512, pf_ways=4, prefetch_list=3), 1),
    # SUITE_MITHRIL, the parity sweeps' 16 lanes
    "suite": (dict(min_support=2, max_support=8, lookahead=100,
                   prefetch_list=3, rec_buckets=4096, rec_ways=4,
                   mine_rows=64, pf_buckets=4096, pf_ways=4), 16),
    "suite_symmetric": (dict(min_support=2, max_support=8, lookahead=100,
                             prefetch_list=3, rec_buckets=4096, rec_ways=4,
                             mine_rows=64, pf_buckets=64, pf_ways=4,
                             symmetric=True), 16),
    # PAPER_MITHRIL: N = 1024, W = 100, over 48 KiB of shared memory
    "paper_1": (dict(min_support=4, max_support=8, lookahead=100,
                     prefetch_list=2, rec_buckets=32768, rec_ways=4,
                     mine_rows=1024, pf_buckets=16384, pf_ways=4), 1),
    "paper_135": (dict(min_support=4, max_support=8, lookahead=100,
                       prefetch_list=2, rec_buckets=32768, rec_ways=4,
                       mine_rows=1024, pf_buckets=16384, pf_ways=4), 135),
    "paper_symmetric": (dict(min_support=4, max_support=8, lookahead=100,
                             prefetch_list=2, rec_buckets=32768, rec_ways=4,
                             mine_rows=1024, pf_buckets=16384, pf_ways=4,
                             symmetric=True), 1),
    # few pairs kept (the cut falls mid-row), R = 1, odd N, W >= N - 1
    "small_cap": (dict(min_support=1, max_support=4, lookahead=60,
                       rec_buckets=16, rec_ways=3, mine_rows=37,
                       pf_buckets=8, pf_ways=2, prefetch_list=2,
                       max_pairs=6), 8),
}


def warm_mine_state(cfg, lanes, dev, rng, valid_frac=0.85, ts_base=0):
    """A stacked state whose mining tables are full, in migration order:
    rows of clustered timestamps (weak and strong pairs, shifts of 0-2),
    some frequent and cleared rows; prefetch tables half full, sources
    among the mined blocks; recording pointers into the mining table.

    A nonzero ``ts_base`` is added to every timestamp in wrapped int32
    (so a base near 2**31 puts some first timestamps past INT32_MAX, at
    negative values), and two valid rows, N // 2 and N // 2 + 2, get
    first timestamps of exactly INT32_MAX, which tie in the sort with
    the invalid rows, and aligned gaps of 0 and 1 (a strong pair)."""
    st = init_state(cfg, "cpu", lanes=lanes)
    n, s, r = cfg.mine_rows, cfg.max_support, cfg.min_support
    n_clusters = max(1, n // 6)
    pattern = np.sort(rng.integers(0, 3 * cfg.lookahead // 4 + 2,
                                   (lanes, n_clusters, s)), -1)
    start = rng.integers(0, 12 * n, (lanes, n_clusters))
    which = rng.integers(0, n_clusters, (lanes, n))
    shift = rng.integers(0, 3, (lanes, n))
    ar = np.arange(lanes)[:, None]
    ts = (start[ar, which][..., None] + pattern[ar, which]
          + shift[..., None])
    cnt = rng.integers(r, s + 1, (lanes, n))
    cnt = np.where(rng.random((lanes, n)) < valid_frac, cnt,
                   rng.choice([0, s + 1], (lanes, n)))
    if ts_base:
        ts = ts.astype(np.int64) + ts_base
        top = 2**31 - 1 + np.arange(s)
        for row, step in ((n // 2, 0), (n // 2 + 2, 1)):
            if row < n:
                ts[:, row] = top + step * (np.arange(s) > 0)
                cnt[:, row] = s
        ts = (ts + 2**31) % 2**32 - 2**31
    ts = np.where(np.arange(s) < np.minimum(cnt, s)[..., None], ts, 0)
    universe = 3 * cfg.pf_buckets
    blocks = rng.integers(0, universe, (lanes, n))
    pf_shape = tuple(st.pf_key.shape)
    pf_key = np.where(rng.random(pf_shape) < 0.5,
                      rng.integers(0, universe, pf_shape), -1)
    now = rng.integers(10**6, 2 * 10**6, lanes)
    rec_shape = tuple(st.rec_key.shape)
    fill = {"mine_block": blocks, "mine_ts": ts, "mine_cnt": cnt,
            "mine_fill": np.full(lanes, n),
            "rec_key": rng.integers(0, universe, rec_shape),
            "rec_loc": (rng.random(rec_shape) < 0.05).astype(int),
            "pf_key": pf_key,
            "pf_vals": rng.integers(-1, universe, tuple(st.pf_vals.shape)),
            "pf_cnt": rng.integers(0, 7, pf_shape),
            "pf_age": rng.integers(0, 10**6, pf_shape), "ts": now,
            "n_mines": rng.integers(0, 9, lanes),
            "n_pairs": rng.integers(0, 999, lanes),
            "n_dropped": rng.integers(0, 99, lanes)}
    for name, value in fill.items():
        getattr(st, name).copy_(torch.as_tensor(value.astype(np.int32)))
    return type(st)(*(x.to(dev) for x in st))


def clone_state(st):
    return type(st)(*(x.clone() for x in st))


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(MINE_CONFIGS))
def test_mine_step_matches_plain(cuda, name):
    """The fused mining run against ``mine_step_plain`` on a copy of a
    warm state, every leaf exactly; lanes with need = 0 untouched; a
    second launch on another copy gives the same bits."""
    kw, lanes = MINE_CONFIGS[name]
    cfg = MithrilConfig(**kw)
    rng = np.random.default_rng(len(name) * 7 + lanes)
    base = warm_mine_state(cfg, lanes, cuda, rng)
    need = torch.as_tensor(rng.random(lanes) < 0.6, device=cuda)
    need[0] = True
    if lanes > 2:
        need[1] = False
    got, again, want = (clone_state(base) for _ in range(3))
    before = ops.launch_counts()
    mine_step_kernel(cfg, got, need)
    mine_step_kernel(cfg, again, need)
    mine_step_plain(cfg, want, need)
    torch.cuda.synchronize()
    after = ops.launch_counts()
    assert after["mithril_mine_step"] == before["mithril_mine_step"] + 2
    for name_ in ("mithril_pairwise", "mithril_pairwise_batched"):
        assert after[name_] == before[name_]
    for field, a, b, c, x in zip(got._fields, got, again, want, base):
        assert torch.equal(a, c), field
        assert torch.equal(a, b), field
        idle = ~need
        assert torch.equal(a[idle], x[idle]), field
    assert int((got.n_pairs - base.n_pairs)[need].sum()) > 0
    if name == "small_cap":
        assert int((got.n_dropped - base.n_dropped).sum()) > 0


# timestamp bases for N mining rows, whose first timestamps start in
# [0, 12 N) before the shift
WRAP_BASES = {"past_int32_max": lambda n: 2**31 - 6 * n,
              "either_side_of_0": lambda n: -6 * n,
              "near_int32_min": lambda n: -2**31}


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["suite", "suite_symmetric", "paper_1",
                                  "small_cap"])
@pytest.mark.parametrize("base", list(WRAP_BASES))
def test_mine_step_matches_plain_at_wrapping_timestamps(cuda, base, name):
    """Timestamps shifted by ``base`` in wrapped int32 (first timestamps
    past INT32_MAX, negative ones, gaps across the wrap, valid rows at
    INT32_MAX tied with the invalid rows): the fused mining run equals
    ``mine_step_plain`` on every leaf, and the codes launch on the sorted
    table equals the plain codes."""
    from repro_torch.core.mining import sort_by_first_ts
    kw, lanes = MINE_CONFIGS[name]
    cfg = MithrilConfig(**kw)
    rng = np.random.default_rng(len(name) + len(base))
    base_st = warm_mine_state(cfg, lanes, cuda, rng,
                              ts_base=WRAP_BASES[base](cfg.mine_rows))
    assert bool((base_st.mine_ts[..., 0] == 2**31 - 1).any())
    assert bool((base_st.mine_ts[..., 0] < 0).any())
    need = torch.ones(lanes, dtype=torch.bool, device=cuda)
    got, want = clone_state(base_st), clone_state(base_st)
    mine_step_kernel(cfg, got, need)
    mine_step_plain(cfg, want, need)
    torch.cuda.synchronize()
    for field, a, b in zip(got._fields, got, want):
        assert torch.equal(a, b), field
    _, ts, cnt, valid = sort_by_first_ts(
        base_st.mine_block, base_st.mine_ts, base_st.mine_cnt,
        cfg.min_support, cfg.max_support)
    codes = pairwise_codes_batched_kernel(ts, cnt, valid, cfg.lookahead,
                                          cfg.window)
    assert torch.equal(codes, pairwise_codes_batched_plain(
        ts, cnt, valid, cfg.lookahead, cfg.window))


@pytest.mark.cuda
def test_mine_step_runs_the_cards_mining_path(cuda):
    """``mine``, ``maybe_mine`` and ``mine_batched`` on a card state take
    the fused launch; with a pairwise function passed they stay composed
    and give the same state."""
    from repro_torch.core import mine, mine_batched
    cfg = MithrilConfig(**MINE_CONFIGS["suite"][0])
    base = warm_mine_state(cfg, 4, cuda, np.random.default_rng(5))
    need = torch.tensor([True, False, True, True], device=cuda)
    fused, composed = clone_state(base), clone_state(base)
    before = ops.launch_counts()
    mine_batched(cfg, fused, need)
    mine_batched(cfg, composed, need,
                 pairwise_fn=pairwise_codes_batched_kernel)
    after = ops.launch_counts()
    assert after["mithril_mine_step"] == before["mithril_mine_step"] + 1
    assert after["mithril_pairwise_batched"] == \
        before["mithril_pairwise_batched"] + 1
    for field, a, b in zip(fused._fields, fused, composed):
        assert torch.equal(a, b), field
    one = type(base)(*(x[2:3].clone() for x in base))
    two = clone_state(base)
    mine(cfg, one)
    mine_batched(cfg, two, torch.tensor([False, False, True, False],
                                        device=cuda))
    for field, a, b in zip(one._fields, one, two):
        assert torch.equal(a[0], b[2]), field


@pytest.mark.cuda
@pytest.mark.parametrize("lanes,n,s,delta,window", PHASE_PAIRWISE_CASES)
def test_pairwise_codes_launch_at_the_phase_shapes(cuda, lanes, n, s, delta,
                                                   window):
    """The redesigned codes launch against the plain codes at every
    pairwise shape of chip_smoke.py's kernels phase; lane 0 alone
    through the one-lane wrapper."""
    rng = np.random.default_rng(n * 3 + window)
    tabs = [make_table(rng, n, s, spread=2 * delta) for _ in range(lanes)]
    ts, cnt, valid = (torch.as_tensor(np.stack([t[i] for t in tabs]))
                      for i in range(3))
    want = pairwise_codes_batched_plain(ts, cnt, valid, delta, window)
    got = pairwise_codes_batched_kernel(ts.to(cuda), cnt.to(cuda),
                                        valid.to(cuda), delta, window)
    np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())
    one = pairwise_codes_kernel(ts[0].to(cuda), cnt[0].to(cuda),
                                valid[0].to(cuda), delta, window)
    np.testing.assert_array_equal(one.cpu().numpy(), want[0].numpy())


@pytest.mark.cuda
def test_mine_step_rejects_what_the_kernel_does_not_take(cuda):
    cfg = MithrilConfig(**MINE_CONFIGS["serving"][0])
    st = warm_mine_state(cfg, 2, cuda, np.random.default_rng(1))
    need = torch.ones(2, dtype=torch.bool, device=cuda)
    mine_step_kernel(cfg, st, need)
    with pytest.raises(TypeError):                      # int mask
        mine_step_kernel(cfg, st, need.int())
    with pytest.raises(ValueError):                     # on the host
        mine_step_kernel(cfg, st, need.cpu())
    with pytest.raises(ValueError):                     # one flag short
        mine_step_kernel(cfg, st, need[:1])
    with pytest.raises(TypeError):
        mine_step_kernel(cfg, st._replace(pf_age=st.pf_age.long()), need)
    with pytest.raises(ValueError):
        mine_step_kernel(cfg, st._replace(rec_loc=st.rec_loc.cpu()), need)
    with pytest.raises(ValueError):
        mine_step_kernel(cfg, st._replace(
            mine_cnt=st.mine_cnt.reshape(2, 4, 2)), need)
    with pytest.raises(ValueError):                     # S of another cfg
        mine_step_kernel(MithrilConfig(**dict(MINE_CONFIGS["serving"][0],
                                              max_support=4)), st, need)
    mine_step_kernel(cfg, st, need)
    torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# the chunk runner: captured CUDA graphs of the request step
# ---------------------------------------------------------------------------

def runner_configs():
    import dataclasses
    from repro_torch.cache import SimConfig
    from repro_torch.configs import PAPER_MITHRIL
    # the paper's R, S, delta and P with tables small enough to mine
    small_paper = dataclasses.replace(PAPER_MITHRIL, rec_buckets=1024,
                                      mine_rows=64, pf_buckets=1024)
    small = MithrilConfig(min_support=2, max_support=8, lookahead=100,
                          prefetch_list=3, rec_buckets=256, rec_ways=4,
                          mine_rows=16, pf_buckets=256, pf_ways=4,
                          record_on="miss+evict")
    return {
        "mithril-lru": SimConfig(capacity=128, use_mithril=True,
                                 mithril=small_paper),
        "learned-mithril-amp-pg-lru": SimConfig(
            capacity=64, use_learned=True, use_mithril=True, use_amp=True,
            use_pg=True, mithril=small),
    }


RUNNER_LABELS = ["mithril-lru", "learned-mithril-amp-pg-lru"]


def runner_blocks(lanes, steps, seed):
    """Loops over 400 blocks (every block misses four times, so the
    paper's R = 4 fills a mining table) beside mixed traces."""
    from repro_torch.traces import mixed
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(lanes):
        if i % 2:
            rows.append(mixed(steps, seed=seed * 10 + i))
        else:
            loop = rng.permutation(400).astype(np.int32) + 1000 * i
            rows.append(np.tile(loop, -(-steps // 400))[:steps])
    return np.stack(rows).astype(np.int32)


def sweep_module():
    import importlib
    return importlib.import_module("repro_torch.cache.sweep")


def clear_constant_caches():
    """Drop the step's cached device constants, so that the next runner
    meets them uncached (its warm-up step builds them before capture)."""
    from repro_torch.cache import base
    from repro_torch.core import hashindex
    for fn in (base._const, base._table_mask, hashindex.arange, ops._ones,
               ops.all_lanes):
        fn.cache_clear()


@pytest.mark.cuda
@pytest.mark.parametrize("label", RUNNER_LABELS)
def test_runner_replays_equal_the_eager_steps(cuda, label):
    """Every carry leaf and hit row of a sweep through the runner (G =
    16, 500-row slabs, so a short group is padded) equals the eager loop
    over the public step; ragged lengths and an empty lane."""
    from repro_torch.cache import build_batched_step, chunk_runner, sweep
    sw = sweep_module()
    cfg = runner_configs()[label]
    steps = 1600
    blocks = runner_blocks(5, steps, seed=3)
    lengths = np.array([steps, steps, 1200, 777, 0])
    init, step = build_batched_step(cfg, cuda)
    carry = init(5)
    xs = torch.as_tensor(np.ascontiguousarray(blocks.T), device=cuda)
    valid = torch.as_tensor(np.arange(steps)[:, None] < lengths[None],
                            device=cuda)
    hits = torch.stack([step(carry, xs[t], valid[t])[1]
                        for t in range(steps)])
    sw.reset_runners()
    clear_constant_caches()     # the warm-up must build them, not the capture
    res = sweep(cfg, blocks, lengths, chunk=500, unroll=16, device=cuda)
    assert res.compiles == 1
    got = chunk_runner(cfg, 16, cuda).carry(5)
    for a, b in zip(sw._leaves(got), sw._leaves(carry)):
        assert torch.equal(a, b)
    np.testing.assert_array_equal(res.hit_curve, hits.cpu().numpy().T)
    assert int(carry["mith"].n_mines.sum()) > 0
    np.testing.assert_array_equal(res.stats.requests, lengths)


@pytest.mark.cuda
def test_sweeps_capture_once_per_geometry(cuda):
    from repro_torch.cache import (compile_count, sweep, sweep_scheduled,
                                   sweep_streaming)
    sw = sweep_module()
    sw.reset_runners()
    cfg = runner_configs()["mithril-lru"]
    blocks = runner_blocks(3, 300, seed=5)
    a = sweep(cfg, blocks, chunk=64, device=cuda)
    b = sweep(cfg, blocks, chunk=64, device=cuda)
    assert (a.compiles, b.compiles) == (1, 0)
    np.testing.assert_array_equal(a.hit_curve, b.hit_curve)
    for x, y in zip(a.stats, b.stats):
        np.testing.assert_array_equal(x, y)
    assert sweep(cfg, blocks[:2], chunk=64, device=cuda).compiles == 1
    # groups of 2, 2 and 1 lanes: the width 1 is new
    five = {f"t{i}": blocks[i % 3, : 100 + 40 * i] for i in range(5)}
    s = sweep_scheduled(cfg, five, lane_width=2, device=cuda)
    assert s.compiles == 1
    assert sweep_streaming(cfg, five, lane_width=2, chunk=64,
                           device=cuda).result.compiles == 0
    assert compile_count(cfg, device=cuda) == 3


@pytest.mark.cuda
def test_recycled_lanes_equal_fresh_lanes(cuda):
    """Through two lanes, traces are admitted after in-place masked
    resets between replays; each equals its run in a lane of its own."""
    from repro_torch.cache import (chunk_runner, sweep_scheduled,
                                   sweep_streaming)
    from repro_torch.traces import arrival_process
    sw = sweep_module()
    cfg = runner_configs()["learned-mithril-amp-pg-lru"]
    blocks = runner_blocks(6, 700, seed=7)
    traces = {f"t{i}": blocks[i, : 700 - 90 * i] for i in range(6)}
    arr = arrival_process(traces, mode="onoff", burst_len=40, idle_len=30,
                          stagger=100, seed=1)
    stream = sweep_streaming(cfg, traces, arrivals=[arr[k] for k in traces],
                             lane_width=2, chunk=128, device=cuda)
    alone = sweep_scheduled(cfg, traces, lane_width=1, device=cuda)
    for x, y in zip(stream.result.stats, alone.stats):
        np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(stream.result.hit_curve, alone.hit_curve)
    # the reset itself: in place, the masked lane becomes the template
    runner = chunk_runner(cfg, device=cuda)
    carry = runner.carry(2)
    ptrs = [x.data_ptr() for x in sw._leaves(carry)]
    before = [x.clone() for x in sw._leaves(carry)]
    template = runner.init_batched(2)
    sw._masked_reset(carry, template,
                     torch.tensor([True, False], device=cuda))
    for x, old, t, p in zip(sw._leaves(carry), before,
                            sw._leaves(template), ptrs):
        assert x.data_ptr() == p
        assert torch.equal(x[0], t[0]) and torch.equal(x[1], old[1])


@pytest.mark.cuda
def test_async_equals_sync_on_the_card(cuda):
    from repro_torch.cache import sweep_streaming
    from repro_torch.traces import arrival_process
    cfg = runner_configs()["learned-mithril-amp-pg-lru"]
    blocks = runner_blocks(5, 900, seed=11)
    traces = {f"t{i}": blocks[i, : 900 - 150 * i] for i in range(5)}
    arr = arrival_process(traces, mode="poisson", rate=0.8, stagger=200,
                          seed=4)
    kw = dict(arrivals=[arr[k] for k in traces], lane_width=3, chunk=96,
              ring_depth=2, device=cuda)
    a = sweep_streaming(cfg, traces, async_producer=True, **kw)
    s = sweep_streaming(cfg, traces, async_producer=False, **kw)
    for x, y in zip(a.result.stats, s.result.stats):
        np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(a.result.hit_curve, s.result.hit_curve)
    assert a.n_slabs == s.n_slabs
    assert a.streaming_stats()["pipeline"]["wall_s"] > 0


@pytest.mark.cuda
def test_launch_counters_count_the_replays(cuda):
    """The counters hold the warm-up step's launches plus the graph's
    launches times its replays, and nothing the capture counted."""
    from repro_torch.cache import chunk_runner, sweep
    sw = sweep_module()
    sw.reset_runners()
    cfg = runner_configs()["mithril-lru"]
    blocks = runner_blocks(4, 900, seed=2)
    ops.reset_launch_counts()
    sweep(cfg, blocks, np.array([900, 850, 400, 30]), chunk=100, unroll=8,
          device=cuda)
    runner = chunk_runner(cfg, 8, cuda)
    graph = runner.graphs[4]
    # rec_on = "miss": the access with its record event, one mining run
    # and the prefetch a step
    assert graph.launches == {"cache_access": 8, "mithril_mine_step": 8,
                              "mithril_prefetch": 8}
    assert runner.replays == 9 * 13      # 9 slabs of 13 groups
    counts = ops.launch_counts()
    for name, n in counts.items():
        want = graph.launches.get(name, 0)
        assert n == want * runner.replays + want // 8, name


def window_idle_share():
    """The benchmark's ``window.idle_share`` reader."""
    import importlib.util
    import pathlib
    import sys
    bench = pathlib.Path(__file__).resolve().parents[1] / "port_bench"
    if str(bench) not in sys.path:
        sys.path.insert(0, str(bench))
    spec = importlib.util.spec_from_file_location(
        "pb_window_idle_share", bench / "metrics" / "window.idle_share.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@pytest.mark.cuda
def test_the_sweep_record_on_the_card(cuda, monkeypatch):
    """A sweep's record on the card: the capture's span feeds
    ``capture_seconds``; a repeat has a ``runner.replay`` span and a
    ``replay`` device interval for each replay the runner counted, the
    barrier's launches, and reads no event inside the call; the window's
    idle share from its events lies in [0, 100]%."""
    from repro_torch.cache import chunk_runner, sweep
    from repro_torch.runtime import spans
    sw = sweep_module()
    sw.reset_runners()
    cfg = runner_configs()["mithril-lru"]
    blocks = runner_blocks(4, 900, seed=2)
    lengths = np.array([900, 850, 400, 30])
    sweep(cfg, blocks, lengths, chunk=100, unroll=8, device=cuda)
    runner = chunk_runner(cfg, 8, cuda)
    first = spans.records()[-1]
    assert first.count_of("runner.capture") == 1
    assert first.total_s("runner.capture") == runner.capture_seconds > 0
    replays = runner.replays
    reads = []
    elapsed = torch.cuda.Event.elapsed_time

    def counted(self, end):
        reads.append(end)
        return elapsed(self, end)

    monkeypatch.setattr(torch.cuda.Event, "elapsed_time", counted)
    sweep(cfg, blocks, lengths, chunk=100, unroll=8, device=cuda)
    assert reads == []
    rec = spans.records()[-1]
    n = runner.replays - replays
    assert n == 9 * 13 and rec.count_of("runner.replay") == n
    assert len(rec.events["replay"]) == n
    assert "runner.capture" not in rec.spans
    assert rec.counters["mining.launches"] == 8 * n
    assert rec.counters["cache.access_launches"] == 8 * n
    assert rec.counters["cache.prefetch_launches"] == 8 * n
    share = window_idle_share()({})
    assert reads and 0.0 <= share <= 100.0
    # under the profiler the spans are host operations of the trace and
    # add nothing on the device's side (a user annotation would)
    from torch.autograd import profiler as autograd_profiler
    autograd_profiler.profile(use_kineto=True, use_device="cuda").__enter__()
    try:
        sweep(cfg, blocks, lengths, chunk=100, unroll=8, device=cuda)
        torch.cuda.synchronize()
    finally:
        events = torch.autograd._disable_profiler().events()
    assert spans.records()[-1].profiled is True
    assert spans.records()[-1].events == {}     # the profiler times it
    on_device = torch.autograd.DeviceType.CUDA
    host = [e.name() for e in events if e.device_type() != on_device]
    device = [e.name() for e in events if e.device_type() == on_device]
    assert host.count("runner.replay") == n and "stream.consume" in host
    assert not [d for d in device if d in spans.records()[-1].spans]


@pytest.mark.cuda
def test_a_failed_capture_raises(cuda):
    """A step that reads the host cannot be captured: the runner raises
    and captures nothing (no eager fallback), and the card still works."""
    from repro_torch.cache import sweep
    sw = sweep_module()
    cfg = runner_configs()["mithril-lru"]
    runner = sw.ChunkRunner(cfg, 4, cuda)
    step = runner.step

    def host_read(carry, block, valid, hit=None):
        out = step(carry, block, valid, hit)
        int(out[1].sum())
        return out

    runner.step = host_read
    with pytest.raises(RuntimeError):
        runner.carry(2)
    assert runner.captures == 0
    torch.cuda.synchronize()
    res = sweep(cfg, runner_blocks(2, 50, seed=1), chunk=16, device=cuda)
    assert res.stats.requests.tolist() == [50, 50]


@pytest.mark.cuda
def test_first_capture_at_the_paper_mining_shape(cuda, tmp_path):
    """In a fresh process, the first mining launch at the paper's tables
    (N = 1024: above 48 KiB of shared memory, so the launch raises the
    kernel's limit first) comes in the runner's warm-up, and the capture
    after it holds; the sweep equals the CPU's."""
    import os
    import pathlib
    import subprocess
    import sys
    root = pathlib.Path(__file__).resolve().parents[1]
    code = (
        "import json, numpy as np\n"
        "from repro_torch.cache import SimConfig, sweep\n"
        "from repro_torch.configs import PAPER_MITHRIL\n"
        "cfg = SimConfig(capacity=1024, use_mithril=True, "
        "mithril=PAPER_MITHRIL)\n"
        "b = (np.arange(2 * 300).reshape(2, 300) % 97).astype(np.int32)\n"
        "gpu = sweep(cfg, b, chunk=100, device='cuda')\n"
        "cpu = sweep(cfg, b, chunk=100, device='cpu')\n"
        "print(json.dumps([gpu.compiles, all(np.array_equal(x, y) for "
        "x, y in zip(gpu.stats, cpu.stats)), bool(np.array_equal("
        "gpu.hit_curve, cpu.hit_curve))]))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         env=dict(os.environ, PYTHONPATH=str(root / "src")),
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[1, true, true]"


# ---------------------------------------------------------------------------
# the learned & adaptive lane: the online search and the heads' training
# ---------------------------------------------------------------------------

# tests/test_torch_adapt.py's tiny corpus, small-table base and 12-arm grid
ADAPT_AXES = dict(lookaheads=(10, 40, 160), min_supports=(2, 3),
                  pf_sizes=(1, 2))


def adapt_corpus():
    rng = np.random.default_rng(7)
    blocks = rng.integers(0, 150, size=(4, 512)).astype(np.int32)
    blocks[1, 1::3] = blocks[1, 0::3] + 1
    return blocks, np.array([512, 512, 400, 301])


def adapt_base():
    from repro_torch.cache import SimConfig
    return SimConfig(capacity=64, use_mithril=True, mithril=MithrilConfig(
        min_support=2, max_support=8, lookahead=40, rec_buckets=512,
        rec_ways=4, mine_rows=16, pf_buckets=512, pf_ways=4,
        prefetch_list=2))


@pytest.mark.cuda
def test_searches_on_the_card_equal_the_cpu(cuda):
    """hill_climb then bandit on the card from fresh runners: the same
    decisions, hit ratios and base Stats as the CPU; each run's
    ``compiles`` is the graphs its new configs captured (one each, the
    sweeps share one lane width), and a repeat captures none."""
    from repro_torch.cache import chunk_runner, reset_runners
    from repro_torch.learn.adapt import SearchGrid, bandit, hill_climb
    blocks, lengths = adapt_corpus()
    base, grid = adapt_base(), SearchGrid(**ADAPT_AXES)
    # a set: the base config is also an arm of this grid (one runner)
    cfgs = {base} | {grid.config(base, a) for a in range(grid.n_arms)}
    runs = {"hill": lambda d: hill_climb(base, blocks, lengths, grid,
                                         device=d),
            "bandit": lambda d: bandit(base, blocks, lengths, grid,
                                       episodes=4, seed=3, device=d)}
    reset_runners()
    captured = 0
    for name, run in runs.items():
        card, cpu = run(cuda), run("cpu")
        assert card.arms == cpu.arms and card.history == cpu.history
        assert any(a >= 0 for a in card.arms), name
        np.testing.assert_array_equal(card.hit_ratios, cpu.hit_ratios)
        for a, b in zip(card.base_result.stats, cpu.base_result.stats):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        now = sum(chunk_runner(c, device=cuda).captures for c in cfgs)
        assert card.compiles == now - captured
        assert all(chunk_runner(c, device=cuda).captures <= 1 for c in cfgs)
        captured = now
        again = run(cuda)
        assert again.compiles == 0 and again.history == card.history
        np.testing.assert_array_equal(again.hit_ratios, card.hit_ratios)
    assert captured > 0


@pytest.mark.cuda
def test_first_search_captures_one_graph_per_config(cuda):
    """From fresh runners a hill-climb captures exactly one graph for
    each distinct config it swept (its sweeps share one lane width)."""
    from repro_torch.cache import chunk_runner, reset_runners
    from repro_torch.learn.adapt import SearchGrid, hill_climb
    blocks, lengths = adapt_corpus()
    base, grid = adapt_base(), SearchGrid(**ADAPT_AXES)
    reset_runners()
    r = hill_climb(base, blocks, lengths, grid, device=cuda)
    cfgs = {base} | {grid.config(base, a) for a in range(grid.n_arms)}
    captured = sum(chunk_runner(c, device=cuda).captures for c in cfgs)
    assert r.compiles == captured > 0


@pytest.mark.cuda
def test_training_on_the_card_equals_the_cpu(cuda):
    """Both heads, 400 steps, from one generator seed: the fixed-order
    head and optimizer give the card the CPU's parameters bit for bit;
    a loss differs by at most the library log1p's last bit."""
    from repro_torch.learn import train
    from repro_torch.traces import build_corpus, corpus_specs, stack_padded
    _, blocks, lengths = stack_padded(build_corpus(corpus_specs(4000,
                                                                "quick")))
    x, y = train.extract_features(blocks, lengths, stride=4)
    for kind in ("logreg", "mlp"):
        card = train.train_head(kind, x, y, steps=400, seed=0, device=cuda)
        cpu = train.train_head(kind, x, y, steps=400, seed=0, device="cpu")
        for k in cpu[0]:
            assert torch.equal(card[0][k], cpu[0][k]), (kind, k)
        assert max(abs(a - b) for a, b in zip(card[1], cpu[1])) <= 1e-6


def teacher_forced_logits(cfg, model, tokens, dev, steps=4, frames=None):
    from repro_torch.models import lm
    tokens = torch.as_tensor(tokens, device=dev)
    s = tokens.shape[1] - steps
    batch = {"tokens": tokens[:, :s]}
    if frames is not None:
        batch["frames"] = frames.to(dev)
    logits, cache = lm.prefill(cfg, model, batch,
                               pad_to=tokens.shape[1] + 8)
    out = [logits]
    for i in range(steps):
        pos = torch.full((tokens.shape[0],), s + i, device=dev)
        logits, cache = lm.decode_step(cfg, model, cache, tokens[:, s + i],
                                       pos)
        out.append(logits)
    return [t.cpu().numpy() for t in out]


@pytest.mark.cuda
@pytest.mark.parametrize("arch,prompt", [
    ("llama3.2-3b", 24), ("qwen2-moe-a2.7b", 24), ("recurrentgemma-9b", 24),
    ("rwkv6-1.6b", 24), ("rwkv6-1.6b", 32), ("whisper-medium", 24)])
def test_reduced_model_decode_on_the_card_matches_the_cpu(cuda, arch,
                                                          prompt):
    """Prefill and 4 teacher-forced decode steps of ``reduced_config``
    (weights from the CPU generator of seed 0; whisper with seeded
    frames) on the card, within rtol = atol = 5e-2 of the CPU's logits,
    all finite. RWKV prefills 24 tokens sequentially, 32 in chunks."""
    from repro_torch.configs import ARCHS, reduced_config
    from repro_torch.models import lm
    cfg = reduced_config(ARCHS[arch])
    model = lm.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    tokens = np.random.default_rng(1).integers(0, cfg.vocab,
                                               (2, prompt + 4))
    frames = (torch.from_numpy(np.random.default_rng(3).standard_normal(
        (2, cfg.encoder_seq, cfg.d_model)).astype(np.float32)).bfloat16()
              if cfg.is_encoder_decoder else None)
    cpu = teacher_forced_logits(cfg, model, tokens, "cpu", frames=frames)
    card = teacher_forced_logits(cfg, model.to(cuda), tokens, cuda,
                                 frames=frames)
    for a, b in zip(card, cpu):
        assert np.isfinite(a).all()
        np.testing.assert_allclose(a, b, rtol=5e-2, atol=5e-2)


@pytest.mark.cuda
def test_expert_trace_and_stats_on_the_card_equal_the_cpu(cuda):
    """benchmarks/expert_prefetch.py's capture (reduced qwen2-moe, 16
    experts, top 4, 8 layers) and its LRU and MITHRIL-LRU simulations:
    the card's trace and Stats equal the CPU's."""
    import dataclasses
    from repro_torch.cache import SimConfig, simulate
    from repro_torch.configs import ARCHS, SUITE_MITHRIL, reduced_config
    from repro_torch.models import lm
    from repro_torch.traces.capture import capture_expert_trace
    cfg = dataclasses.replace(reduced_config(ARCHS["qwen2-moe-a2.7b"]),
                              n_experts=16, top_k=4, n_layers=8)
    model = lm.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    rng = np.random.default_rng(0)
    batches = [rng.integers(lo, lo + cfg.vocab // 8, (2, 64))
               for lo in rng.integers(0, cfg.vocab // 2, 6)]
    trace = capture_expert_trace(cfg, model, batches)
    card_trace = capture_expert_trace(cfg, model.to(cuda), batches)
    np.testing.assert_array_equal(card_trace, trace)
    mith = dataclasses.replace(SUITE_MITHRIL, lookahead=40, min_support=2)
    for sim in (SimConfig(capacity=48),
                SimConfig(capacity=48, use_mithril=True, mithril=mith)):
        before = ops.launch_counts()["mithril_record"]
        card = simulate(sim, trace, device=cuda)
        cpu = simulate(sim, trace, device="cpu")
        for name, a, b in zip(cpu.stats._fields, card.stats, cpu.stats):
            np.testing.assert_array_equal(a, b, err_msg=name)
        launched = ops.launch_counts()["mithril_record"] - before
        assert (launched > 0) == sim.use_mithril


@pytest.mark.cuda
@pytest.mark.parametrize("block", ["rglru", "rwkv_chunked",
                                   "rwkv_sequential", "encoder"])
def test_new_blocks_on_the_card_match_the_cpu(cuda, block):
    """Each block of the recurrent and encoder-decoder families at the
    reduced size (d 128), from the same state, on the card and the CPU:
    outputs within 5e-2, float32 states within 1e-3."""
    from repro_torch.configs import ARCHS, reduced_config
    from repro_torch.models import lm, rglru, rwkv6
    gen = torch.Generator().manual_seed(5)
    x = torch.randn((2, 32, 128), generator=gen).bfloat16()

    def run(dev):
        if block == "rglru":
            p = rglru.RgLRU(128, device="cpu")
            rglru.init_rglru_params(p, torch.Generator().manual_seed(0))
            p = p.to(dev)
            st = rglru.init_rg_state(2, 128, dev)
            y, st = rglru.rglru_block(p, x.to(dev), st)
            z, st = rglru.rglru_decode(p, x[:, :1].to(dev), st)
            return [y, z, st.h, st.conv]
        if block.startswith("rwkv"):
            p = rwkv6.Rwkv(128, 256, 32, device="cpu")
            rwkv6.init_rwkv_params(p, torch.Generator().manual_seed(0))
            p = p.to(dev)
            st = rwkv6.init_rwkv_state(2, 4, 32, 128, dev)
            seq = 32 if block == "rwkv_chunked" else 24
            y, st = rwkv6.time_mix(p, x[:, :seq].to(dev), st)
            z, st = rwkv6.channel_mix(p, y, st)
            return [y, z, *st]
        cfg = reduced_config(ARCHS["whisper-medium"])
        model = lm.init_params(cfg, torch.Generator().manual_seed(0),
                               device="cpu").to(dev)
        enc = lm._encode(cfg, model, x[:, :cfg.encoder_seq].to(dev))
        return [enc, *lm._project_cross(cfg, model, enc)]

    for card, cpu in zip(run(cuda), run("cpu"), strict=True):
        tol = 1e-3 if card.dtype == torch.float32 else 5e-2
        np.testing.assert_allclose(card.float().cpu().numpy(),
                                   cpu.float().numpy(), rtol=tol, atol=tol)


@pytest.mark.cuda
def test_paper_mining_first_barrier_replays_equal_eager(cuda):
    """The paper-size configuration (PAPER_MITHRIL, 65,536 blocks, 16
    ways) on seeds 1 and 2 of chip_smoke's looping traces: their first
    217,600 requests through the runner, then the next 4,096, in which
    each lane mines for the first and second time (steps 218,416 /
    220,756 and 218,552 / 221,007), as eager steps on a copy of the
    carry and as replays: every leaf and hit equal."""
    import sys
    from pathlib import Path
    from repro_torch.cache import chunk_runner, sweep
    from repro_torch.traces.synthetic import looping
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke
    cfg = chip_smoke.real_config()
    blocks = np.stack([looping(300_000, seed=s, **chip_smoke.PAPER_LOOPS)
                       for s in (1, 2)])
    sweep(cfg, blocks[:, :217_600], device=cuda)
    runner = chunk_runner(cfg, device=cuda)
    assert runner.carry(2)["mith"].n_mines.tolist() == [0, 0]
    info = chip_smoke.paper_replay_equals_eager(
        cfg, runner, blocks[:, 217_600:221_696], cuda)
    assert info["equal"], info
    assert info["mining_runs"] == 4 and info["lanes_mined"] == 2



@pytest.mark.cuda
@pytest.mark.parametrize("sq,skv,window,q_offset", [(128, 128, 0, 0),
                                                    (256, 256, 40, 0),
                                                    (32, 96, 0, 64)])
def test_flash_backward_on_the_card_matches_the_cpu(cuda, sq, skv, window,
                                                     q_offset):
    """The flash forward and its blockwise backward (bf16 operands) on
    the card and the CPU from the same inputs: within 2e-2."""
    from repro_torch.models.attention import flash_attention
    gen = torch.Generator().manual_seed(sq + window)
    q = torch.randn((2, sq, 4, 32), generator=gen).bfloat16()
    k, v = (torch.randn((2, skv, 2, 32), generator=gen).bfloat16()
            for _ in range(2))
    dout = torch.randn((2, sq, 4, 32), generator=gen).bfloat16()

    def run(dev):
        leaves = [t.to(dev).requires_grad_(True) for t in (q, k, v)]
        out = flash_attention(*leaves, window=window, q_offset=q_offset)
        return [out.detach(), *torch.autograd.grad(out, leaves,
                                                   dout.to(dev))]

    for card, cpu in zip(run(cuda), run("cpu"), strict=True):
        assert card.dtype == torch.bfloat16
        np.testing.assert_allclose(card.float().cpu().numpy(),
                                   cpu.float().numpy(), rtol=2e-2, atol=2e-2)


@pytest.mark.cuda
def test_inplace_adamw_step_on_the_card_equals_the_cpu(cuda):
    """Three in-place AdamW steps over a reduced model's parameters (bf16
    weights, the float32 router, decay on the embedding) from the same
    gradients: the same bits on the card and the CPU."""
    from repro_torch.configs import ARCHS, reduced_config
    from repro_torch.launch.steps import lm_decay
    from repro_torch.models import lm
    from repro_torch.optim import adamw
    cfg = reduced_config(ARCHS["qwen2-moe-a2.7b"])
    model = lm.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    gen = torch.Generator().manual_seed(1)
    grads = [{n: torch.randn(p.shape, generator=gen).to(p.dtype)
              for n, p in model.named_parameters()} for _ in range(3)]
    opt_cfg = adamw.AdamWConfig(total_steps=6, warmup_steps=2)

    def run(dev):
        params = {n: p.detach().clone().to(dev)
                  for n, p in model.named_parameters()}
        state = adamw.init(params)
        for g in grads:
            state, m = adamw.update_(opt_cfg, {n: t.to(dev) for n, t in
                                               g.items()}, state, params,
                                     lm_decay(cfg))
        return params, state, m

    (pc, sc, mc), (pp, sp, mp) = run(cuda), run("cpu")
    assert torch.equal(mc["grad_norm"].cpu(), mp["grad_norm"])
    for n in pp:
        assert torch.equal(pc[n].cpu(), pp[n]), n
        for leaf in ("master", "m", "v"):
            assert torch.equal(getattr(sc, leaf)[n].cpu(),
                               getattr(sp, leaf)[n]), (leaf, n)


@pytest.mark.cuda
def test_readahead_on_the_card_counts_its_launches(cuda):
    """The data pipeline's MITHRIL readahead on the card: counters and
    staged set equal to the CPU's, one miss launch a miss, one lookup a
    mining run."""
    from repro_torch.data import DataConfig, SyntheticPipeline
    mcfg = MithrilConfig(min_support=2, max_support=8, lookahead=16,
                         rec_buckets=128, rec_ways=4, mine_rows=16,
                         pf_buckets=128, pf_ways=4)
    cfg = DataConfig(vocab=100, seq_len=8, global_batch=2, n_shards=64,
                     shard_group=4)
    cpu = SyntheticPipeline(cfg, mithril_cfg=mcfg, device="cpu")
    card = SyntheticPipeline(cfg, mithril_cfg=mcfg, device=cuda)
    before = ops.launch_counts()
    for step in range(400):
        cpu.fetch_shard(step)
        card.fetch_shard(step)
    n = {k: v - before[k] for k, v in ops.launch_counts().items()}
    assert card.staged == cpu.staged
    assert (card.readahead_hits, card.readahead_misses) == \
        (cpu.readahead_hits, cpu.readahead_misses)
    mines = int(card._route.state.n_mines[0])
    assert mines == int(cpu._route.state.n_mines[0]) > 0
    assert n["mithril_miss_step"] == card.readahead_misses
    assert n["mithril_mine_step"] == n["hash_lookup"] == mines


# ---------------------------------------------------------------------------
# the request step's cache set: the access and the MITHRIL prefetch kernels
# ---------------------------------------------------------------------------

# (lanes, ways, buckets): every lane width, way count and bucket count of
# the card's sweeps (the paper's 65,536 blocks are 4,096 buckets of 16)
CACHE_SET_SHAPES = [(1, 4, 1), (5, 16, 1), (5, 32, 32), (135, 16, 32),
                    (1, 4, 4096), (135, 16, 4096)]
# R = 1: a recorded block enters the mining table at once, so lanes mine
# often whatever their cache's size
CACHE_SET_MITHRIL = MithrilConfig(min_support=1, max_support=8, lookahead=50,
                                  prefetch_list=3, rec_buckets=64, rec_ways=4,
                                  mine_rows=16, pf_buckets=64, pf_ways=4)


def np_bucket(blocks, nb):
    """``hashindex.bucket_index`` in numpy (murmur3's finalizer on the
    uint32 bits)."""
    k = np.asarray(blocks, np.int64).astype(np.uint64) & 0xFFFFFFFF
    with np.errstate(over="ignore"):
        k ^= k >> 16
        k = (k * 0x7FEB352D) & 0xFFFFFFFF
        k ^= k >> 15
        k = (k * 0x846CA68B) & 0xFFFFFFFF
        k ^= k >> 16
    return (k & (nb - 1)).astype(np.int64)


def bucket_lists(universe, nb):
    """(NB, n) blocks of ``universe`` by cache bucket, -1 padded, and the
    count of each bucket."""
    bk = np_bucket(universe, nb)
    order = np.argsort(bk, kind="stable")
    counts = np.bincount(bk, minlength=nb)
    lists = np.full((nb, max(1, counts.max())), -1, np.int64)
    starts = np.cumsum(counts) - counts
    pos = np.arange(len(universe)) - starts[bk[order]]
    lists[bk[order], pos] = universe[order]
    return lists, counts


def planted_cache_set(rng, lanes, ways, nb, mcfg):
    """A cache, statistics and MITHRIL state that exercise every rule of
    the cache set at once, on the CPU: buckets full of blocks that hash
    there (some ways empty) with many stamp ties, unused prefetched blocks
    with their second chance left, a mining table one or two migrations
    short of its mining run, and a prefetch table whose rows hold a
    block's own id, EMPTY values and candidates that share one cache
    bucket. Returns the state, the block universe, a loop of 40 blocks a
    lane, each with a prefetch row, and W + 4 blocks a lane of one cache
    bucket (they miss in turn, so they record and mine)."""
    from repro_torch.cache.base import pack_cache
    from repro_torch.cache.simulator import init_stats
    universe = np.arange(max(64, 2 * nb * ways), dtype=np.int64)
    lists, counts = bucket_lists(universe, nb)
    w = np.arange(ways)
    off = rng.integers(0, 1 << 20, size=(lanes, nb, 1))
    n = np.minimum(counts, ways)[None, :, None]
    keys = lists[np.arange(nb)[None, :, None],
                 (off + w) % np.maximum(counts, 1)[None, :, None]]
    keys = np.where((w < n) & (rng.random((lanes, nb, ways)) > 0.08),
                    keys, -1)
    full = keys >= 0
    flag = (rng.random(keys.shape) < 0.5) & full
    src = np.where(flag, rng.integers(1, 4, keys.shape), 0)
    stamp = rng.integers(0, 6, keys.shape)
    cache = pack_cache(*(torch.as_tensor(x.astype(np.int32)) for x in (
        keys, stamp, flag, np.zeros(keys.shape), src,
        rng.integers(0, 5, keys.shape), rng.integers(0, 3, keys.shape),
        rng.integers(6, 9, lanes))))
    stats = init_stats("cpu", lanes)
    mith = init_state(mcfg, "cpu", lanes)
    pb, pw, p = mcfg.pf_buckets, mcfg.pf_ways, mcfg.prefetch_list
    pf_key = np.full((lanes, pb, pw), -1, np.int64)
    pf_vals = np.full((lanes, pb, pw, p), -1, np.int64)
    loops = rng.choice(universe, size=(lanes, 40))
    filled = np.flatnonzero(counts)
    for lane in range(lanes):
        sources = np.concatenate([loops[lane], rng.choice(universe, 2 * pb)])
        for s in sources:
            b = np_bucket(s, pb)
            free = np.flatnonzero(pf_key[lane, b] < 0)
            if not len(free) or (pf_key[lane, b] == s).any():
                continue
            kind = rng.integers(0, 4)
            if kind == 0:     # every candidate in one cache bucket
                row = lists[rng.choice(filled)]
                vals = rng.choice(row[row >= 0], size=p)
            elif kind == 1:   # the block itself and EMPTY among them
                vals = rng.choice(np.array([s, -1, rng.choice(universe)]),
                                  size=p)
            else:
                vals = rng.choice(universe, size=p)
            pf_key[lane, b, free[0]] = s
            pf_vals[lane, b, free[0]] = vals
    nm, s_sup = mcfg.mine_rows, mcfg.max_support
    fill = nm - rng.integers(1, 3, lanes)
    rows = np.arange(nm) < fill[:, None]
    cnt = np.where(rows, rng.integers(mcfg.min_support, s_sup + 1,
                                      (lanes, nm)), 0)
    ts = np.sort(rng.integers(0, 900, (lanes, nm, s_sup)), -1)
    planted = {"pf_key": pf_key, "pf_vals": pf_vals,
               "mine_block": np.where(rows, rng.choice(universe, (lanes, nm)),
                                      -1),
               "mine_ts": np.where(np.arange(s_sup) < cnt[..., None], ts, 0),
               "mine_cnt": cnt, "mine_fill": fill,
               "ts": np.full(lanes, 1000)}
    for name, value in planted.items():
        getattr(mith, name).copy_(torch.as_tensor(value.astype(np.int32)))
    crowded = lists[np.argsort(-counts, kind="stable")[np.arange(lanes) % nb]]
    thrash = np.stack([rng.permutation(row[row >= 0])[:ways + 4]
                       for row in crowded])
    return ({"cache": cache, "stats": stats, "mith": mith}, universe, loops,
            thrash)


def cache_set_traffic(rng, steps, universe, loops, thrash):
    """(steps, lanes) blocks: 40% from the lane's loop (they hit and find
    prefetch rows), 30% its crowded bucket's blocks in turn (each misses,
    so they record and mine), 30% uniform; and the valid mask, about 12%
    of requests invalid."""
    lanes = len(loops)
    at = np.arange(steps)[:, None]
    lane = np.arange(lanes)[None]
    pick = rng.random((steps, lanes))
    turn = np.cumsum((pick >= 0.4) & (pick < 0.7), axis=0)
    blocks = np.where(pick < 0.4, loops[lane, at % loops.shape[1]],
                      np.where(pick < 0.7, thrash[lane,
                                                  turn % thrash.shape[1]],
                               rng.choice(universe, size=(steps, lanes))))
    valid = rng.random((steps, lanes)) > 0.12
    return blocks.astype(np.int32), valid


def run_cache_set(carry, blocks, valid, policy, rec_on, mcfg):
    """The step's cache set and barriers through the wrappers: the access
    with the first recording event, the mining barrier, the second event
    of ``miss+evict`` with its barrier, then the MITHRIL prefetch. CPU
    states take the plain versions. Returns each step's outputs."""
    from repro_torch.core import mithril
    from repro_torch.kernels.cache_set import (cache_access_kernel,
                                               mithril_prefetch_kernel)
    cache, stats, mith = carry["cache"], carry["stats"], carry["mith"]
    first = rec_on.split("+")[0]
    outs = []
    for blk, val in zip(blocks, valid):
        acc = cache_access_kernel(cache, stats, blk, val, policy, mith, first,
                                  mcfg.mine_rows)
        mithril.mine_batched(mcfg, mith, acc.need)
        ev_block, ev_unused, ev_src = acc.evicted
        if rec_on == "miss+evict":
            ops.mithril_record_fused(mith, ev_block, ev_block != -1)
            mithril.mine_batched(mcfg, mith,
                                 (mith.mine_fill >= mcfg.mine_rows) & val)
        mithril_prefetch_kernel(cache, stats, mith, blk, val, mcfg)
        outs.append(torch.stack([acc.hit.int(), acc.used_src, ev_block,
                                 ev_unused.int(), ev_src, acc.need.int()]))
    return torch.stack(outs)


@pytest.mark.cuda
@pytest.mark.parametrize("rec_on", ["miss", "evict", "all", "miss+evict"])
@pytest.mark.parametrize("policy", ["lru", "fifo"])
@pytest.mark.parametrize("lanes,ways,nb", CACHE_SET_SHAPES)
def test_cache_set_kernels_match_plain(cuda, lanes, ways, nb, policy,
                                       rec_on):
    """The access kernel (with its record event and need) and the MITHRIL
    prefetch kernel equal their plain versions bit for bit: every output
    of every step and every leaf of the cache, statistics and MITHRIL
    state, over full buckets that force the second chance, stamp ties,
    invalid requests, and prefetch rows with candidates in one bucket,
    equal to the block, or EMPTY."""
    import dataclasses
    rng = np.random.default_rng(lanes * 7919 + ways * 31 + nb)
    mcfg = dataclasses.replace(CACHE_SET_MITHRIL, record_on=rec_on)
    cpu, universe, loops, thrash = planted_cache_set(rng, lanes, ways, nb,
                                                     mcfg)
    gpu = {k: type(v)(*(x.to(cuda) for x in v)) for k, v in cpu.items()}
    from repro_torch.cache.base import pack_cache
    gpu["cache"] = pack_cache(*gpu["cache"])
    blocks, valid = cache_set_traffic(rng, 240, universe, loops, thrash)
    before = ops.launch_counts()
    got = run_cache_set(gpu, torch.as_tensor(blocks, device=cuda),
                        torch.as_tensor(valid, device=cuda), policy, rec_on,
                        mcfg)
    want = run_cache_set(cpu, torch.as_tensor(blocks), torch.as_tensor(valid),
                         policy, rec_on, mcfg)
    torch.cuda.synchronize()
    n = {k: v - before[k] for k, v in ops.launch_counts().items()}
    assert n["cache_access"] == n["mithril_prefetch"] == 240
    assert n["mithril_record"] == (240 if rec_on == "miss+evict" else 0)
    assert torch.equal(got.cpu(), want)
    for part in ("cache", "stats", "mith"):
        for name, a, b in zip(cpu[part]._fields, gpu[part], cpu[part]):
            assert torch.equal(a.cpu(), b), (part, name)
    stats = cpu["stats"]
    assert int(stats.pf_issued[:, 1].sum()) > 0
    assert int(stats.hits.sum()) > 0
    assert int(cpu["cache"].pf_sc.sum()) > 0       # second chances granted
    assert int(got[:, 5].sum()) > 0                 # lanes mined
    if lanes > 1:
        assert int(stats.requests.sum()) < lanes * 240


@pytest.mark.cuda
def test_cache_set_wrappers_reject_what_the_kernels_do_not_take(cuda):
    import dataclasses
    from repro_torch.cache.base import CacheState, init_cache
    from repro_torch.cache.simulator import init_stats
    from repro_torch.kernels.cache_set import (cache_access_kernel,
                                               mithril_prefetch_kernel)
    mcfg = CACHE_SET_MITHRIL
    cache = init_cache(64, ways=16, device=cuda, lanes=2)
    stats = init_stats(cuda, 2)
    mith = init_state(mcfg, cuda, lanes=2)
    blk = torch.zeros(2, dtype=torch.int32, device=cuda)
    val = torch.ones(2, dtype=torch.bool, device=cuda)
    cache_access_kernel(cache, stats, blk, val, "lru", mith, "miss", 16)
    mithril_prefetch_kernel(cache, stats, mith, blk, val, mcfg)
    with pytest.raises(ValueError):         # 33 ways: more than a warp
        cache_access_kernel(init_cache(66, ways=33, device=cuda, lanes=2),
                            stats, blk, val)
    with pytest.raises(ValueError):         # 48 ways
        mithril_prefetch_kernel(init_cache(96, ways=48, device=cuda,
                                           lanes=2), stats, mith, blk, val,
                                mcfg)
    with pytest.raises(TypeError):
        cache_access_kernel(cache, stats, blk.long(), val)
    with pytest.raises(TypeError):
        cache_access_kernel(cache, stats, blk, val.int())
    with pytest.raises(ValueError):
        cache_access_kernel(cache, stats, blk.cpu(), val)
    with pytest.raises(ValueError):
        mithril_prefetch_kernel(cache, stats, mith, blk, val.cpu(), mcfg)
    with pytest.raises(TypeError):
        cache_access_kernel(cache, stats._replace(hits=stats.hits.long()),
                            blk, val)
    with pytest.raises(ValueError):         # not one packed tensor
        cache_access_kernel(CacheState(*(x.clone() for x in cache)), stats,
                            blk, val)
    with pytest.raises(ValueError):         # the MITHRIL state's lanes
        cache_access_kernel(cache, stats, blk, val, "lru",
                            init_state(mcfg, cuda, lanes=3), "miss", 16)
    with pytest.raises(ValueError):
        cache_access_kernel(cache, stats, blk, val, "lfu")
    with pytest.raises(ValueError):         # the configuration's buckets
        mithril_prefetch_kernel(cache, stats, mith, blk, val,
                                dataclasses.replace(mcfg, pf_buckets=32))
    with pytest.raises(TypeError):
        mithril_prefetch_kernel(cache, stats, mith._replace(
            pf_vals=mith.pf_vals.long()), blk, val, mcfg)
    with pytest.raises(ValueError):
        cache_access_kernel(cache, stats, blk, val,
                            hit=torch.zeros(3, dtype=torch.bool,
                                            device=cuda))
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("label", RUNNER_LABELS)
def test_cache_set_launches_and_counters_in_the_runner(cuda, label):
    """A MITHRIL-LRU replay launches G of the access, the mining run and
    the prefetch, and no record kernel (record on miss); the sweep's
    ``cache.*_launches`` counters are the steps replayed. A learned
    configuration keeps the plain cache set: both counters read 0 and its
    replays still equal its eager steps."""
    from repro_torch.cache import build_batched_step, chunk_runner, sweep
    from repro_torch.runtime import spans
    sw = sweep_module()
    sw.reset_runners()
    cfg = runner_configs()[label]
    blocks = runner_blocks(4, 900, seed=2)
    lengths = np.array([900, 850, 400, 30])
    sweep(cfg, blocks, lengths, chunk=100, unroll=16, device=cuda)
    runner = chunk_runner(cfg, 16, cuda)
    replays = runner.replays
    res = sweep(cfg, blocks, lengths, chunk=100, unroll=16, device=cuda)
    rec = spans.records()[-1]
    steps = 16 * (runner.replays - replays)
    launches = runner.graphs[4].launches
    if label == "mithril-lru":
        assert launches == {"cache_access": 16, "mithril_mine_step": 16,
                            "mithril_prefetch": 16}
        assert rec.counters["cache.access_launches"] == steps
        assert rec.counters["cache.prefetch_launches"] == steps
        return
    assert "cache_access" not in launches
    assert "mithril_prefetch" not in launches
    assert rec.counters["cache.access_launches"] == 0
    assert rec.counters["cache.prefetch_launches"] == 0
    init, step = build_batched_step(cfg, cuda)
    carry = init(4)
    xs = torch.as_tensor(np.ascontiguousarray(blocks.T), device=cuda)
    valid = torch.as_tensor(np.arange(900)[:, None] < lengths[None],
                            device=cuda)
    hits = torch.stack([step(carry, xs[t], valid[t])[1] for t in range(900)])
    np.testing.assert_array_equal(res.hit_curve, hits.cpu().numpy().T)
    for a, b in zip(sw._leaves(runner.carry(4)), sw._leaves(carry)):
        assert torch.equal(a, b)
