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
from repro_torch.kernels.mithril_record import (record_step_kernel,
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
@pytest.mark.parametrize("r_sup", [1, 2, 4])
def test_record_kernel_matches_plain(cuda, r_sup):
    cfg = MithrilConfig(min_support=r_sup, max_support=max(4, r_sup),
                        lookahead=8, rec_buckets=64, rec_ways=4,
                        mine_rows=512)
    rng = np.random.default_rng(r_sup)
    gpu = init_state(cfg, cuda, lanes=5)
    cpu = init_state(cfg, "cpu", lanes=5)
    before = ops.launch_counts()["mithril_record"]
    for _ in range(300):
        blk = rng.integers(-2, 200, 5).astype(np.int32)
        en = rng.integers(0, 2, 5).astype(np.int32)
        record_step_kernel(torch.as_tensor(blk, device=cuda),
                           torch.as_tensor(en, device=cuda),
                           *(getattr(gpu, f) for f in RECORD_LEAVES))
        record_step_plain(torch.as_tensor(blk), torch.as_tensor(en),
                          *(getattr(cpu, f) for f in RECORD_LEAVES))
    torch.cuda.synchronize()
    assert ops.launch_counts()["mithril_record"] == before + 300
    for name, a, b in zip(gpu._fields, to_numpy(gpu), to_numpy(cpu)):
        np.testing.assert_array_equal(a, b, err_msg=name)


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
    for name in ("mithril_record", "mithril_pairwise", "hash_lookup",
                 "paged_decode"):
        assert after[name] > before[name], name
