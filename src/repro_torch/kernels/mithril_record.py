"""The fused per-request MITHRIL record event over a lanes axis, and the
serving tier's miss (that event with the prefetch-table probe).

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

Shapes: ``block``/``enabled``/``mine_fill``/``ts`` (L,) int32 (``enabled``
may also be bool); ``rec_key/cnt/age/loc/row`` (L, NB, W); ``rec_ts``
(L, NB, W, R); ``mine_block``/``mine_cnt`` (L, Nm); ``mine_ts`` (L, Nm, S).

The miss of a serving tier (one lane): the record event of the page,
``need = mine_fill >= mine_rows``, then the probe of the prefetch table
for the page, as ``[need, cand_0 .. cand_{P-1}]`` int32.
``miss_step_plain`` is the plain version; ``miss_step_kernel`` does it in
one launch with the page passed by value and writes the result to a
buffer the host reads after one wait. The probe inside the launch runs
before the record event's writes, which never touch the prefetch table,
so it equals the lookup after the event whenever no mining runs.

The launchers bind a state once (``backend.Bound``): its tensors are
checked in full at the first call and whenever another tensor object, or
another address, takes a leaf's place; other calls check only ``block``
and ``enabled``.
"""

from __future__ import annotations

import ctypes
import operator
from typing import Optional

import torch

from ..core.hashindex import (EMPTY, arange, argmin_first, bucket_index,
                              first_index)
from . import backend
from .hash_lookup import hash_lookup_plain

LIB = "mithril_record"
MAX_WAYS = 32           # the ways of a bucket sit across one warp
# the record path's state leaves, in the kernels' order
LEAVES = ("rec_key", "rec_ts", "rec_cnt", "rec_age", "rec_loc", "rec_row",
          "mine_block", "mine_ts", "mine_cnt", "mine_fill", "ts")
_INT32 = (-(1 << 31), 1 << 31)
# a state's tensors as the miss kernel binds them
_MISS_TENSORS = operator.attrgetter(*LEAVES, "pf_key", "pf_vals")


class RecordArgs(ctypes.Structure):
    """``RecordTables`` of ``csrc/mithril_common.cuh``: a state's 11
    record-path pointers and its dimensions."""
    _fields_ = ([(n, ctypes.c_void_p) for n in LEAVES]
                + [(n, ctypes.c_int) for n in ("lanes", "nb", "ways", "r_sup",
                                               "nm", "s_sup")])


class MissArgs(ctypes.Structure):
    """``MissArgs`` of ``csrc/mithril_record.cu``: a one-lane state's
    record tables, its prefetch table and the result buffer."""
    _fields_ = [("rec", RecordArgs), ("pf_key", ctypes.c_void_p),
                ("pf_vals", ctypes.c_void_p), ("out", ctypes.c_void_p),
                ("pf_nb", ctypes.c_int), ("pf_ways", ctypes.c_int),
                ("plist", ctypes.c_int), ("mine_rows", ctypes.c_int)]


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


def record_args(rec_key, rec_ts, rec_cnt, rec_age, rec_loc, rec_row,
                mine_block, mine_ts, mine_cnt, mine_fill, ts) -> RecordArgs:
    """Check the 11 state tensors in full (raising on what the kernel does
    not take) and bind their pointers and dimensions."""
    if rec_key.dim() != 3 or rec_ts.dim() != 4 or mine_ts.dim() != 3:
        raise ValueError(f"rec_key, rec_ts and mine_ts must be 3-, 4- and "
                         f"3-D; got {tuple(rec_key.shape)}, "
                         f"{tuple(rec_ts.shape)}, {tuple(mine_ts.shape)}")
    lanes, nb, ways = rec_key.shape
    r_sup = rec_ts.shape[-1]
    nm, s_sup = mine_ts.shape[1:]
    dev = rec_key.device
    if not (1 <= ways <= MAX_WAYS) or nb < 1 or nb & (nb - 1) or \
            not 1 <= r_sup <= s_sup:
        raise ValueError(f"record kernel takes 1..{MAX_WAYS} ways, a power "
                         f"of two buckets and 1 <= R <= S; got W={ways}, "
                         f"NB={nb}, R={r_sup}, S={s_sup}")
    req = backend.require
    i32 = torch.int32
    for name, x in (("mine_fill", mine_fill), ("ts", ts)):
        req(x, name, i32, (lanes,), dev)
    for name, x in (("rec_key", rec_key), ("rec_cnt", rec_cnt),
                    ("rec_age", rec_age), ("rec_loc", rec_loc),
                    ("rec_row", rec_row)):
        req(x, name, i32, (lanes, nb, ways), dev)
    req(rec_ts, "rec_ts", i32, (lanes, nb, ways, r_sup), dev)
    req(mine_block, "mine_block", i32, (lanes, nm), dev)
    req(mine_cnt, "mine_cnt", i32, (lanes, nm), dev)
    req(mine_ts, "mine_ts", i32, (lanes, nm, s_sup), dev)
    leaves = (rec_key, rec_ts, rec_cnt, rec_age, rec_loc, rec_row,
              mine_block, mine_ts, mine_cnt, mine_fill, ts)
    return RecordArgs(*(x.data_ptr() for x in leaves), lanes, nb, ways,
                      r_sup, nm, s_sup)


_RECORD = backend.Bound(record_args)


def record_step_kernel(block, enabled, *leaves) -> None:
    """One record event for every lane, in place.

    ``leaves`` are the 11 state tensors in :data:`LEAVES` order. CPU
    tensors take :func:`record_step_plain`; CUDA tensors launch the
    kernel (one warp per lane) or raise.
    """
    if leaves[0].device.type == "cpu":
        record_step_plain(block, enabled, *leaves)
        return
    args = _RECORD(leaves)
    dev = leaves[0].device
    lanes = args.lanes
    backend.require(block, "block", torch.int32, (lanes,), dev)
    en_bool = enabled.dtype == torch.bool
    backend.require(enabled, "enabled", torch.bool if en_bool else torch.int32,
                    (lanes,), dev)
    if lanes == 0:
        return
    fn = backend.c_function(LIB, "mithril_record_step",
                            [ctypes.c_void_p] * 3 + [ctypes.c_int,
                                                     ctypes.c_void_p])
    err = fn(ctypes.byref(args), block.data_ptr(), enabled.data_ptr(),
             en_bool, backend.stream_of(block))
    backend.check_launch(err, "mithril_record_step")
    record_step_kernel.launches += 1


record_step_kernel.launches = 0


def miss_step_plain(page: int, state, mine_rows: int) -> torch.Tensor:
    """One miss of the one-lane ``state`` (its leaves are attributes, as
    in ``MithrilState``), in place: the record event of ``page``, then
    ``[need, cand_0 .. cand_{P-1}]`` (int32, (1 + P,)), need being
    ``mine_fill >= mine_rows`` and the candidates the prefetch table's
    (EMPTY when the page has none)."""
    dev = state.ts.device
    blk = torch.tensor([page], dtype=torch.int32, device=dev)
    record_step_plain(blk, torch.ones(1, dtype=torch.int32, device=dev),
                      *(getattr(state, f) for f in LEAVES))
    need = (state.mine_fill >= mine_rows).to(torch.int32)
    cand = hash_lookup_plain(blk, state.pf_key[0], state.pf_vals[0])[0]
    return torch.cat([need, cand])


def device_address(t: torch.Tensor) -> int:
    """The address under which the card reaches ``t``: a CUDA tensor's
    own, a pinned host tensor's mapping; raises for other memory."""
    if t.device.type != "cpu":
        return t.data_ptr()
    if not t.is_pinned():
        raise ValueError("the miss kernel's output must be on the card or "
                         "in pinned host memory")
    addr = ctypes.c_void_p()
    fn = backend.c_function(LIB, "mithril_device_address",
                            [ctypes.c_void_p, ctypes.c_void_p])
    err = fn(t.data_ptr(), ctypes.byref(addr))
    if err != 0:
        raise RuntimeError(f"pinned output not mapped for the card (CUDA "
                           f"error {err})")
    return addr.value


def miss_args(*tensors) -> MissArgs:
    """Check a one-lane state's 11 record leaves, ``pf_key``, ``pf_vals``
    and the (1 + P,) output (on the card or pinned), then bind them;
    ``tensors`` ends with ``mine_rows`` (an int)."""
    *leaves, pf_key, pf_vals, out, mine_rows = tensors
    rec = record_args(*leaves)
    if rec.lanes != 1:
        raise ValueError(f"the miss kernel takes a one-lane state, got "
                         f"{rec.lanes} lanes")
    if pf_key.dim() != 3 or pf_vals.dim() != 4:
        raise ValueError(f"pf_key and pf_vals must be 3- and 4-D; got "
                         f"{tuple(pf_key.shape)}, {tuple(pf_vals.shape)}")
    _, pb, pw = pf_key.shape
    plist = pf_vals.shape[-1]
    if pb < 1 or pb & (pb - 1) or pw < 1 or plist < 1:
        raise ValueError(f"the prefetch table needs a power of two buckets "
                         f"and at least one way and value; got PB={pb}, "
                         f"PW={pw}, P={plist}")
    dev = leaves[0].device
    backend.require(pf_key, "pf_key", torch.int32, (1, pb, pw), dev)
    backend.require(pf_vals, "pf_vals", torch.int32, (1, pb, pw, plist), dev)
    if out.device != dev and out.device.type != "cpu":
        raise ValueError(f"out is on {out.device}, expected {dev} or pinned "
                         f"host memory")
    backend.require(out, "out", torch.int32, (1 + plist,), out.device)
    return MissArgs(rec, pf_key.data_ptr(), pf_vals.data_ptr(),
                    device_address(out), pb, pw, plist, mine_rows)


_MISS = backend.Bound(miss_args)


def miss_step_kernel(page: int, state, mine_rows: int, out: torch.Tensor,
                     bound: backend.Bound = _MISS,
                     done: Optional[torch.cuda.Event] = None) -> None:
    """One miss of the one-lane ``state``, in place, its
    ``[need, cand_0 ..]`` written to ``out``; see :func:`miss_step_plain`.

    CPU state tensors take the plain version. On the card: one launch
    with ``page`` by value, on the current stream, and no wait; ``out``
    (pinned host memory, which the kernel writes through its mapping, or
    a CUDA tensor) holds the result once the stream has passed the
    launch. ``bound`` keeps the binding (a tier passes its own); ``done``,
    an event already created on the state's card, is recorded on the
    stream right after the launch (no ``Stream`` object is built).
    """
    if state.ts.device.type == "cpu":
        out.copy_(miss_step_plain(page, state, mine_rows))
        return
    if not _INT32[0] <= page < _INT32[1]:
        raise ValueError(f"page {page} is not an int32")
    args = bound((*_MISS_TENSORS(state), out), mine_rows)
    fn = backend.c_function(LIB, "mithril_miss_step",
                            [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                             ctypes.c_void_p])
    err = fn(ctypes.byref(args), page, backend.stream_of(state.ts),
             None if done is None else done.cuda_event)
    backend.check_launch(err, "mithril_miss_step")
    miss_step_kernel.launches += 1


miss_step_kernel.launches = 0
