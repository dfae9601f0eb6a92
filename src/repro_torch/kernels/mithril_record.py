"""The fused per-request MITHRIL record event over a lanes axis.

Counterpart of ``repro/kernels/mithril_record.py`` (the Pallas
``record_step_kernel``). One event per lane: the ``hashindex.locate``
probe, the recording-table circular-buffer stamp, the migration into
the mining table at cnt >= R, the S-slot append or frequent mark of a
mining-resident block, and the ``mine_fill``/``ts`` bump. A lane with
``enabled == 0`` is left bit for bit as it was.

Both versions update the 11 state tensors in place, one row each:

* ``record_step_plain`` is plain PyTorch (the CPU path and the
  card-side yardstick);
* ``record_step_kernel`` launches ``csrc/mithril_record.cu`` on CUDA
  tensors and raises on anything it does not take.

Shapes: ``block``/``enabled``/``mine_fill``/``ts`` (L,) int32;
``rec_key/cnt/age/loc/row`` (L, NB, W); ``rec_ts`` (L, NB, W, R);
``mine_block``/``mine_cnt`` (L, Nm); ``mine_ts`` (L, Nm, S).
"""

from __future__ import annotations

import ctypes

import torch

from ..core.hashindex import (EMPTY, arange, argmin_first, bucket_index,
                              first_index)
from . import backend

LIB = "mithril_record"
MAX_WAYS = 32           # the ways of a bucket sit across one warp


def record_step_plain(block, enabled, rec_key, rec_ts, rec_cnt, rec_age,
                      rec_loc, rec_row, mine_block, mine_ts, mine_cnt,
                      mine_fill, ts) -> None:
    """One record event for every lane, in place (plain PyTorch)."""
    lanes, nb, ways = rec_key.shape
    r_sup = rec_ts.shape[-1]
    nm, s_sup = mine_ts.shape[1:]
    dev = rec_key.device
    ar = arange(lanes, dev)
    en = enabled != 0
    t = ts.clone()
    fill = mine_fill.clone()

    # --- hashindex.locate: probe the bucket, pick hit way or victim ---
    b = bucket_index(block, nb)
    keys_row = rec_key[ar, b]
    hit = keys_row == block[:, None]
    found = hit.any(-1)
    empty = keys_row == EMPTY
    victim = torch.where(empty.any(-1), first_index(empty),
                         argmin_first(rec_age[ar, b]))
    w = torch.where(found, first_index(hit), victim)

    old_key, old_ts_row = keys_row[ar, w], rec_ts[ar, b, w]
    old_cnt, old_age = rec_cnt[ar, b, w], rec_age[ar, b, w]
    old_loc, old_row = rec_loc[ar, b, w], rec_row[ar, b, w]
    in_mine = old_loc == 1
    is_new = en & ~found
    is_rec = en & found & ~in_mine
    is_upd = en & found & in_mine

    # --- recording-table stamp (invariant: old_cnt < R when is_rec) ---
    kr = arange(r_sup, dev)
    tcol = t[:, None]
    ts_row = torch.where(
        is_new[:, None], torch.where(kr == 0, tcol, 0),
        torch.where(is_rec[:, None] & (kr == old_cnt[:, None]), tcol,
                    old_ts_row))
    cnt_val = torch.where(is_new, 1, old_cnt + is_rec.to(torch.int32))

    # mining-ready: R timestamps accumulated (immediately, when R == 1)
    migrate = is_rec & (cnt_val >= r_sup)
    if r_sup == 1:
        migrate = migrate | is_new

    # --- mining-table row: migration target, resident row, or a no-op
    # write of row 0. Out-of-range rows (a broken record/maybe_mine
    # contract) read clamped and write nothing, as the reference's
    # gather clamps and its scatter drops ---
    m = torch.where(migrate, fill, torch.where(is_upd, old_row, 0))
    in_bounds = (m < nm)[:, None]
    m = m.clamp(max=nm - 1)
    old_mblk, old_mts, old_mcnt = (mine_block[ar, m], mine_ts[ar, m],
                                   mine_cnt[ar, m])
    can = old_mcnt < s_sup
    pos = old_mcnt.clamp(max=s_sup - 1)
    ks = arange(s_sup, dev)
    mig_ts = old_mts.clone()
    mig_ts[:, :r_sup] = ts_row
    upd_ts = torch.where((ks == pos[:, None]) & can[:, None], tcol, old_mts)
    new_mts = torch.where(migrate[:, None], mig_ts,
                          torch.where(is_upd[:, None], upd_ts, old_mts))
    new_mcnt = torch.where(
        migrate, r_sup,
        torch.where(is_upd, torch.where(can, old_mcnt + 1, s_sup + 1),
                    old_mcnt))

    i32 = torch.int32
    rec_key[ar, b, w] = torch.where(is_new, block, old_key)
    rec_ts[ar, b, w] = ts_row
    rec_cnt[ar, b, w] = cnt_val.to(i32)
    rec_age[ar, b, w] = torch.where(is_new, t, old_age)
    rec_loc[ar, b, w] = torch.where(migrate, 1,
                                    torch.where(is_new, 0, old_loc)).to(i32)
    rec_row[ar, b, w] = torch.where(migrate, fill, old_row)
    mine_block[ar, m] = torch.where(migrate & in_bounds[:, 0], block,
                                    old_mblk)
    mine_ts[ar, m] = torch.where(in_bounds, new_mts, old_mts)
    mine_cnt[ar, m] = torch.where(in_bounds[:, 0], new_mcnt,
                                  old_mcnt).to(i32)
    mine_fill.add_(migrate.to(i32))
    ts.add_(en.to(i32))


def record_step_kernel(block, enabled, rec_key, rec_ts, rec_cnt, rec_age,
                       rec_loc, rec_row, mine_block, mine_ts, mine_cnt,
                       mine_fill, ts) -> None:
    """One record event for every lane, in place.

    CPU tensors take :func:`record_step_plain`; CUDA tensors launch the
    kernel (one warp per lane) or raise.
    """
    if rec_key.device.type == "cpu":
        record_step_plain(block, enabled, rec_key, rec_ts, rec_cnt, rec_age,
                          rec_loc, rec_row, mine_block, mine_ts, mine_cnt,
                          mine_fill, ts)
        return
    lanes, nb, ways = rec_key.shape
    r_sup = rec_ts.shape[-1]
    nm, s_sup = mine_ts.shape[1:]
    dev = rec_key.device
    if ways > MAX_WAYS or nb & (nb - 1) or r_sup > s_sup:
        raise ValueError(f"record kernel takes <= {MAX_WAYS} ways, a power "
                         f"of two buckets and R <= S; got W={ways}, "
                         f"NB={nb}, R={r_sup}, S={s_sup}")
    req = backend.require
    i32 = torch.int32
    for name, x in (("block", block), ("enabled", enabled),
                    ("mine_fill", mine_fill), ("ts", ts)):
        req(x, name, i32, (lanes,), dev)
    for name, x in (("rec_key", rec_key), ("rec_cnt", rec_cnt),
                    ("rec_age", rec_age), ("rec_loc", rec_loc),
                    ("rec_row", rec_row)):
        req(x, name, i32, (lanes, nb, ways), dev)
    req(rec_ts, "rec_ts", i32, (lanes, nb, ways, r_sup), dev)
    req(mine_block, "mine_block", i32, (lanes, nm), dev)
    req(mine_cnt, "mine_cnt", i32, (lanes, nm), dev)
    req(mine_ts, "mine_ts", i32, (lanes, nm, s_sup), dev)
    if lanes == 0:
        return
    fn = backend.c_function(LIB, "mithril_record_step",
                            [ctypes.c_void_p] * 13 + [ctypes.c_int] * 6
                            + [ctypes.c_void_p])
    err = fn(*(x.data_ptr() for x in (
        block, enabled, rec_key, rec_ts, rec_cnt, rec_age, rec_loc, rec_row,
        mine_block, mine_ts, mine_cnt, mine_fill, ts)),
        lanes, nb, ways, r_sup, nm, s_sup, backend.stream_of(rec_key))
    backend.check_launch(err, "mithril_record_step")
    record_step_kernel.launches += 1


record_step_kernel.launches = 0
