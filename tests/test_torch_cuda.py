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
