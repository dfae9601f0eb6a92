"""The pairwise association check of the mining barrier, over a lanes axis.

Counterpart of ``repro/kernels/mithril_mine_batched.py`` (the Pallas
``pairwise_codes_batched_kernel``). Each first-ts-sorted mining row i of
every lane is compared with rows i+1..i+W:

  1 = weak: both rows valid, equal counts, first-ts gap <= delta and
      every live aligned timestamp within delta;
  2 = strong: weak, plus some aligned difference equal to 1;
  0 otherwise.

``pairwise_codes_batched_plain`` is the plain PyTorch version (the CPU
path and the card-side yardstick); ``pairwise_codes_batched_kernel``
launches ``csrc/mithril_mine.cu`` on CUDA tensors: one warp per row, the
offsets across its lanes, a block of rows (plus the W rows after them)
staged in shared memory. Rows past N are masked inside the kernel, so no
padding is needed. The main path no longer launches it: a mining run on
the card is one launch of ``mithril_mine_step``, which computes the same
codes without writing them out; this launch stays the counterpart of the
two TPU kernels and the ``pairwise_fn`` a caller may pass.
"""

from __future__ import annotations

import ctypes

import torch

from . import backend

LIB = "mithril_mine"
ROW_BLOCKS = (64, 32, 16, 8)    # mining rows per CUDA block, largest first


def pairwise_codes_plain(ts: torch.Tensor, cnt: torch.Tensor,
                         valid: torch.Tensor, delta: int,
                         window: int) -> torch.Tensor:
    """Codes for each (row i, offset d=1..window), any leading dims.

    ``ts``: (..., N, S) int32 sorted by ts[..., 0]; ``cnt``/``valid``:
    (..., N). Returns (..., N, W) int32.
    """
    n, s = ts.shape[-2:]
    dev = ts.device
    idx_j = (torch.arange(n, device=dev)[:, None]
             + torch.arange(1, window + 1, device=dev)[None, :])   # (N, W)
    in_range = idx_j < n
    idx_jc = idx_j.clamp(max=n - 1)
    ts_j = ts[..., idx_jc, :]                 # (..., N, W, S)
    cnt_j = cnt[..., idx_jc]                  # (..., N, W)
    valid_j = valid[..., idx_jc] & in_range

    # paper inner-loop break: first-timestamp gap within Delta
    gap_ok = (ts_j[..., 0] - ts[..., :, None, 0]) <= delta
    same_cnt = cnt_j == cnt[..., :, None]

    diffs = (ts_j - ts[..., :, None, :]).abs()
    k = torch.arange(s, device=dev)
    live = k < cnt[..., :, None, None]                         # aligned pairs
    weak = torch.where(live, diffs <= delta, True).all(-1)
    strong = weak & torch.where(live, diffs == 1, False).any(-1)

    ok = valid[..., :, None] & valid_j & gap_ok & same_cnt
    return torch.where(ok & strong, 2,
                       torch.where(ok & weak, 1, 0)).to(torch.int32)


def pairwise_codes_batched_plain(ts: torch.Tensor, cnt: torch.Tensor,
                                 valid: torch.Tensor, delta: int,
                                 window: int) -> torch.Tensor:
    """(L, N, S) x (L, N) x (L, N) -> (L, N, W), plain PyTorch."""
    if ts.dim() != 3:
        raise ValueError(f"ts must be (L, N, S), got {tuple(ts.shape)}")
    return pairwise_codes_plain(ts, cnt, valid, delta, window)


def _row_block(lanes: int, n: int, device: torch.device) -> int:
    """Rows per CUDA block: the largest block that still gives two
    blocks per SM (the parity sweeps' 16 lanes of 64 rows take 8)."""
    want = 2 * backend.sm_count(device)
    for rb in ROW_BLOCKS:
        if lanes * -(-n // rb) >= want:
            return rb
    return ROW_BLOCKS[-1]


def launch(ts: torch.Tensor, cnt: torch.Tensor, valid: torch.Tensor,
           delta: int, window: int):
    """Check (L, N, S) CUDA inputs, allocate the codes, launch once.

    Returns ``(codes, launched)``: an empty problem launches nothing."""
    lanes, n, s = ts.shape
    dev = ts.device
    backend.require(ts, "ts", torch.int32, (lanes, n, s), dev)
    backend.require(cnt, "cnt", torch.int32, (lanes, n), dev)
    backend.require(valid, "valid", torch.bool, (lanes, n), dev)
    out = torch.empty((lanes, n, window), dtype=torch.int32, device=dev)
    if lanes == 0 or n == 0 or window == 0:
        return out, False
    rb = _row_block(lanes, n, dev)
    fn = backend.c_function(LIB, "mithril_pairwise_codes",
                            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                            + [ctypes.c_void_p])
    err = fn(ts.data_ptr(), cnt.data_ptr(), valid.data_ptr(),
             out.data_ptr(), lanes, n, s, int(delta), int(window), rb,
             backend.stream_of(ts))
    backend.check_launch(err, "mithril_pairwise_codes")
    return out, True


def pairwise_codes_batched_kernel(ts: torch.Tensor, cnt: torch.Tensor,
                                  valid: torch.Tensor, delta: int,
                                  window: int) -> torch.Tensor:
    """(L, N, S) -> (L, N, W) codes: one launch over (row-block, lane).

    CPU tensors take :func:`pairwise_codes_batched_plain`; CUDA tensors
    launch the kernel or raise.
    """
    if ts.device.type == "cpu":
        return pairwise_codes_batched_plain(ts, cnt, valid, delta, window)
    if ts.dim() != 3:
        raise ValueError(f"ts must be (L, N, S), got {tuple(ts.shape)}")
    out, launched = launch(ts, cnt, valid, delta, window)
    pairwise_codes_batched_kernel.launches += int(launched)
    return out


pairwise_codes_batched_kernel.launches = 0
