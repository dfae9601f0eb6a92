"""The whole MITHRIL mining run of a stacked state, in one launch.

Counterpart, on the card, of ``repro/core/mithril.py::mine_batched``: for
every lane whose ``need`` flag is set, the stable sort of the mining table
by first timestamp, the pairwise codes (the work of the Pallas kernels
``mithril_mine_batched.py::pairwise_codes_batched_kernel`` and
``mithril_mine.py::pairwise_codes_kernel``), the Alg. 2 selection, the
compaction to ``pairs_cap`` pairs, the fold into the prefetch table and
the clear of the mining table and of the recording table's pointers into
it. The state is updated in place; a lane whose flag is clear is left bit
for bit as it was.

* ``mine_step_plain`` is the composed PyTorch path (the CPU path and the
  card-side yardstick): ``associations_dense_batched`` with the plain
  codes, then ``_fold_pairs`` over the flagged lanes;
* ``mine_step_kernel`` launches ``mine_step_kernel`` of
  ``csrc/mithril_mine.cu`` on CUDA states (one block per lane, no host
  wait, no codes tensor) and raises on what the kernel does not take.

``need`` is a (B,) bool tensor on the state's device. The launcher binds a
state once (``backend.Bound``) and passes the configuration's scalars.
"""

from __future__ import annotations

import ctypes
import functools
import operator

import torch

from . import backend

LIB = "mithril_mine"
# the state leaves a mining run reads or writes, in the kernel's order
LEAVES = ("mine_block", "mine_ts", "mine_cnt", "mine_fill", "rec_key",
          "rec_loc", "pf_key", "pf_vals", "pf_cnt", "pf_age", "ts",
          "n_mines", "n_pairs", "n_dropped")
_TENSORS = operator.attrgetter(*LEAVES)
_DIMS = ("lanes", "n", "s_sup", "rec_slots", "rec_vec4", "pf_nb", "pf_ways",
         "plist", "r_sup", "delta", "window", "pairs_cap", "symmetric")


class MineArgs(ctypes.Structure):
    """``MineTables`` of ``csrc/mithril_mine.cu``: a state's 14 mining-run
    pointers, its dimensions and the configuration's scalars."""
    _fields_ = ([(n, ctypes.c_void_p) for n in LEAVES]
                + [(n, ctypes.c_int) for n in _DIMS])


@functools.lru_cache(maxsize=None)
def config_scalars(cfg) -> tuple:
    """What the kernel takes of a ``MithrilConfig``: R, S, Delta, the
    window, the pairs cap, symmetric and the prefetch buckets."""
    return (cfg.min_support, cfg.max_support, cfg.lookahead, cfg.window,
            cfg.pairs_cap, int(cfg.symmetric), cfg.pf_buckets)


def mine_step_plain(cfg, states, need: torch.Tensor):
    """Mine the lanes of ``states`` flagged in ``need``, in place (plain
    PyTorch); returns ``states``."""
    # imported here: the core imports the kernel wrappers
    from ..core.mining import associations_dense_batched
    from ..core.mithril import _fold_pairs
    from .mithril_mine_batched import pairwise_codes_batched_plain
    src, dst, valid, dropped = associations_dense_batched(
        states.mine_block, states.mine_ts, states.mine_cnt,
        cfg.min_support, cfg.max_support, cfg.lookahead, cfg.window,
        cfg.pairs_cap, pairwise_fn=pairwise_codes_batched_plain)
    return _fold_pairs(cfg, states, src, dst, valid, dropped, need=need)


def mine_args(*tensors) -> MineArgs:
    """Check the 14 state tensors in full against each other and the
    configuration scalars that end ``tensors`` (raising on what the
    kernel does not take) and bind their pointers and dimensions."""
    leaves, (r_sup, s_max, delta, window, pairs_cap, symmetric,
             pf_buckets) = tensors[:len(LEAVES)], tensors[len(LEAVES):]
    (mine_block, mine_ts, mine_cnt, mine_fill, rec_key, rec_loc, pf_key,
     pf_vals, pf_cnt, pf_age, ts, n_mines, n_pairs, n_dropped) = leaves
    if mine_ts.dim() != 3 or rec_key.dim() != 3 or pf_key.dim() != 3 or \
            pf_vals.dim() != 4:
        raise ValueError(
            f"mine_ts, rec_key, pf_key and pf_vals must be 3-, 3-, 3- and "
            f"4-D; got {tuple(mine_ts.shape)}, {tuple(rec_key.shape)}, "
            f"{tuple(pf_key.shape)}, {tuple(pf_vals.shape)}")
    lanes, n, s = mine_ts.shape
    _, nb, ways = rec_key.shape
    _, pb, pw = pf_key.shape
    plist = pf_vals.shape[-1]
    if s != s_max or pb != pf_buckets or pb & (pb - 1) or pw < 1 or \
            plist < 1 or not 1 <= r_sup <= s_max or pairs_cap < 0 or \
            not 0 <= window < max(n, 1):
        raise ValueError(
            f"the state does not fit the configuration: S={s} (max_support "
            f"{s_max}), PB={pb} (pf_buckets {pf_buckets}, a power of two), "
            f"PW={pw}, P={plist}, R={r_sup}, window={window} (N={n}), "
            f"pairs_cap={pairs_cap}")
    dev = mine_ts.device
    req = backend.require
    i32 = torch.int32
    for name, x in (("mine_fill", mine_fill), ("ts", ts),
                    ("n_mines", n_mines), ("n_pairs", n_pairs),
                    ("n_dropped", n_dropped)):
        req(x, name, i32, (lanes,), dev)
    req(mine_block, "mine_block", i32, (lanes, n), dev)
    req(mine_cnt, "mine_cnt", i32, (lanes, n), dev)
    req(mine_ts, "mine_ts", i32, (lanes, n, s), dev)
    req(rec_key, "rec_key", i32, (lanes, nb, ways), dev)
    req(rec_loc, "rec_loc", i32, (lanes, nb, ways), dev)
    for name, x in (("pf_key", pf_key), ("pf_cnt", pf_cnt),
                    ("pf_age", pf_age)):
        req(x, name, i32, (lanes, pb, pw), dev)
    req(pf_vals, "pf_vals", i32, (lanes, pb, pw, plist), dev)
    slots = nb * ways
    # the clear walks the recording table four slots at a time when a
    # lane's rows start on 16 bytes
    vec4 = slots % 4 == 0 and rec_key.data_ptr() % 16 == 0 and \
        rec_loc.data_ptr() % 16 == 0
    return MineArgs(*(x.data_ptr() for x in leaves), lanes, n, s, slots,
                    int(vec4), pb, pw, plist, r_sup, delta, window,
                    pairs_cap, symmetric)


_MINE = backend.Bound(mine_args)


def mine_step_kernel(cfg, states, need: torch.Tensor):
    """Mine the lanes of ``states`` flagged in ``need``, in place; returns
    ``states``.

    CPU states take :func:`mine_step_plain`. On the card: one launch on
    the current stream, no wait; ``need`` must be a (B,) bool tensor on
    the state's card.
    """
    if states.ts.device.type == "cpu":
        return mine_step_plain(cfg, states, need)
    args = _MINE(_TENSORS(states), *config_scalars(cfg))
    backend.require(need, "need", torch.bool, (args.lanes,),
                    states.ts.device)
    if args.lanes == 0:
        return states
    fn = backend.c_function(LIB, "mithril_mine_step",
                            [ctypes.c_void_p] * 3)
    err = fn(ctypes.byref(args), need.data_ptr(), backend.stream_of(need))
    backend.check_launch(err, "mithril_mine_step")
    mine_step_kernel.launches += 1
    return states


mine_step_kernel.launches = 0
