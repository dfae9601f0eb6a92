"""The request step's cache set over a lanes axis: the demand access with
its statistics and the MITHRIL record event that follows it, and the
MITHRIL lookup with its prefetch inserts.

No Pallas kernel stands behind these: the reference computes the cache
set as plain ``jnp`` code (``repro/cache/base.py``, the step's segments
in ``repro/cache/simulator.py``). Here ``cache_access_kernel`` and
``mithril_prefetch_kernel`` are one launch each of ``csrc/cache_set.cu``
on CUDA states (one warp a lane), raising on what the kernels do not
take. Their plain version is the cache layer's composition
(``cache.simulator.cache_access_plain`` / ``mithril_prefetch_plain``),
which CPU states take.

The access returns an :class:`Access`: ``hit``, ``used_src``, the
eviction as ``(block, unused_pf, pf_src)`` (the fields of
``cache.base.Evicted``) and ``need``, the mining barrier's mask after
the record event (``mine_fill >= mine_rows`` on a valid lane; ``None``
when no record event runs). ``record_on`` is ``"miss"``, ``"evict"`` or
``"all"`` (the event's block and gate as in
``cache.simulator.build_segments``) or ``None``. States and statistics
are updated in place; an invalid lane (``valid`` False) is left bit for
bit as it was. The launchers bind a state once (``backend.Bound``).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from . import backend
from .mithril_record import LEAVES as RECORD_LEAVES
from .mithril_record import MAX_WAYS, RecordArgs, record_args

LIB = "cache_set"
# cache.base's N_TABLES and N_PF_SRC (the cache imports these wrappers):
# key, stamp, pf_flag, pf_sc, pf_src, freq, assoc; the prefetch sources
N_TABLES, N_PF_SRC = 7, 4
RECORD_ON = {None: 0, "miss": 1, "evict": 2, "all": 3}
_STATS = ("requests", "hits", "pf_issued", "pf_used", "pf_evicted_unused")


class Access(NamedTuple):
    hit: torch.Tensor               # (B,) bool
    used_src: torch.Tensor          # (B,) int32
    evicted: tuple                  # (block, unused_pf, pf_src), (B,) each
    need: Optional[torch.Tensor]    # (B,) bool, or None


class CacheArgs(ctypes.Structure):
    """``CacheTables`` of ``csrc/cache_set.cu``."""
    _fields_ = ([(n, ctypes.c_void_p) for n in ("tables", "clock") + _STATS]
                + [(n, ctypes.c_int) for n in ("lanes", "nb", "ways")])


class AccessArgs(ctypes.Structure):
    """``AccessArgs`` of ``csrc/cache_set.cu``."""
    _fields_ = [("c", CacheArgs), ("r", RecordArgs), ("record_on", ctypes.c_int),
                ("mine_rows", ctypes.c_int)]


class PrefetchArgs(ctypes.Structure):
    """``PrefetchArgs`` of ``csrc/cache_set.cu``."""
    _fields_ = [("c", CacheArgs), ("pf_key", ctypes.c_void_p),
                ("pf_vals", ctypes.c_void_p), ("pf_nb", ctypes.c_int),
                ("pf_ways", ctypes.c_int), ("plist", ctypes.c_int)]


def cache_args(*tensors) -> CacheArgs:
    """Check the seven table views (of one packed (7, B, NB, W) tensor),
    the clock and the five statistics in full, and bind them."""
    tables, (clock, *stats) = tensors[:N_TABLES], tensors[N_TABLES:]
    key = tables[0]
    if key.dim() != 3:
        raise ValueError(f"the cache tables must be (B, NB, W), got "
                         f"{tuple(key.shape)}")
    lanes, nb, ways = key.shape
    if not 1 <= ways <= MAX_WAYS or nb < 1 or nb & (nb - 1):
        raise ValueError(f"the cache kernels take 1..{MAX_WAYS} ways and a "
                         f"power of two buckets; got W={ways}, NB={nb}")
    dev = key.device
    req = backend.require
    for k, x in enumerate(tables):
        req(x, f"cache table {k}", torch.int32, (lanes, nb, ways), dev)
    base = key._base
    size = lanes * nb * ways
    if base is None or base.dim() != 4 or tuple(base.shape) != (
            N_TABLES, lanes, nb, ways) or not base.is_contiguous() or any(
            x.data_ptr() != key.data_ptr() + 4 * size * k
            for k, x in enumerate(tables)):
        raise ValueError("the cache tables must be the views of one packed "
                         "(7, B, NB, W) tensor: build the state with "
                         "init_cache or pack_cache")
    req(clock, "clock", torch.int32, (lanes,), dev)
    for name, x in zip(_STATS, stats):
        req(x, name, torch.int32,
            (lanes,) if name in ("requests", "hits") else (lanes, N_PF_SRC),
            dev)
    return CacheArgs(key.data_ptr(), clock.data_ptr(),
                     *(x.data_ptr() for x in stats), lanes, nb, ways)


def access_args(*tensors) -> AccessArgs:
    """``cache_args`` of the first 13 tensors, then the 11 record leaves
    of ``core.mithril.MithrilState`` (none without a record event);
    ``tensors`` ends with ``record_on`` and ``mine_rows``."""
    *tensors, record_on, mine_rows = tensors
    c = cache_args(*tensors[:N_TABLES + 6])
    rec = RecordArgs()
    if record_on:
        rec = record_args(*tensors[N_TABLES + 6:])
        if rec.lanes != c.lanes:
            raise ValueError(f"the MITHRIL state has {rec.lanes} lanes, the "
                             f"cache {c.lanes}")
    return AccessArgs(c, rec, record_on, mine_rows)


def prefetch_args(*tensors) -> PrefetchArgs:
    """``cache_args`` of the first 13 tensors, then the prefetch table's
    ``pf_key`` (B, PB, PW) and ``pf_vals`` (B, PB, PW, P); ``tensors``
    ends with the configuration's ``pf_buckets``."""
    *tensors, pf_key, pf_vals, pf_buckets = tensors
    c = cache_args(*tensors)
    if pf_key.dim() != 3 or pf_vals.dim() != 4:
        raise ValueError(f"pf_key and pf_vals must be 3- and 4-D; got "
                         f"{tuple(pf_key.shape)}, {tuple(pf_vals.shape)}")
    _, pb, pw = pf_key.shape
    plist = pf_vals.shape[-1]
    if pb != pf_buckets or pb & (pb - 1) or pw < 1 or plist < 1:
        raise ValueError(f"the prefetch table needs pf_buckets ({pf_buckets},"
                         f" a power of two) buckets and at least one way and "
                         f"value; got PB={pb}, PW={pw}, P={plist}")
    dev = pf_key.device
    backend.require(pf_key, "pf_key", torch.int32, (c.lanes, pb, pw), dev)
    backend.require(pf_vals, "pf_vals", torch.int32, (c.lanes, pb, pw, plist),
                    dev)
    return PrefetchArgs(c, pf_key.data_ptr(), pf_vals.data_ptr(), pb, pw,
                        plist)


_ACCESS = backend.Bound(access_args)
_PREFETCH = backend.Bound(prefetch_args)


def _check_request(block, valid, lanes: int, dev: torch.device) -> None:
    backend.require(block, "block", torch.int32, (lanes,), dev)
    backend.require(valid, "valid", torch.bool, (lanes,), dev)


def cache_access_kernel(cache, stats, block, valid, policy: str = "lru",
                        mith=None, record_on: Optional[str] = None,
                        mine_rows: int = 0,
                        hit: Optional[torch.Tensor] = None) -> Access:
    """The demand access of every lane with its statistics, then the
    record event of ``record_on`` on ``mith``, in one launch on the card.

    CPU states take the plain version. On the card ``block`` is (B,)
    int32 and ``valid`` (B,) bool; ``hit``, if given, is a (B,) bool
    tensor the kernel writes the hit row into (a captured graph's static
    output). Raises on what the kernel does not take (more than 32 ways,
    other dtypes or devices).
    """
    if cache.key.device.type == "cpu":
        # imported here: the cache imports these wrappers
        from ..cache.simulator import cache_access_plain
        return cache_access_plain(cache, stats, block, valid, policy, mith,
                                  record_on, mine_rows, hit=hit)
    if policy not in ("lru", "fifo"):
        raise ValueError(f"unknown policy {policy!r}")
    rec = RECORD_ON[record_on]
    leaves = ((*cache[:N_TABLES], cache.clock, *stats)
              + (tuple(getattr(mith, f) for f in RECORD_LEAVES) if rec
                 else ()))
    args = _ACCESS(leaves, rec, mine_rows)
    lanes, dev = args.c.lanes, cache.key.device
    _check_request(block, valid, lanes, dev)
    ints = torch.empty((3, lanes), dtype=torch.int32, device=dev)
    flags = torch.empty((3, lanes), dtype=torch.bool, device=dev)
    if hit is None:
        hit = flags[2]
    else:
        backend.require(hit, "hit", torch.bool, (lanes,), dev)
    out = Access(hit, ints[0], (ints[1], flags[0], ints[2]),
                 flags[1] if rec else None)
    if lanes == 0:
        return out
    fn = backend.c_function(LIB, "mithril_cache_access",
                            [ctypes.c_void_p] * 6 + [ctypes.c_int,
                                                     ctypes.c_void_p])
    err = fn(ctypes.byref(args), block.data_ptr(), valid.data_ptr(),
             hit.data_ptr(), ints.data_ptr(), flags.data_ptr(),
             int(policy == "lru"), backend.stream_of(block))
    backend.check_launch(err, "mithril_cache_access")
    cache_access_kernel.launches += 1
    return out


cache_access_kernel.launches = 0


def mithril_prefetch_kernel(cache, stats, mith, block, valid, mcfg) -> None:
    """The MITHRIL lookup of every lane's block (``mcfg`` a
    ``MithrilConfig``) and the prefetch inserts of its candidates, in one
    launch on the card (after the step's mining barrier).

    CPU states take the plain version; on the card it raises on what the
    kernel does not take.
    """
    if cache.key.device.type == "cpu":
        from ..cache.simulator import mithril_prefetch_plain
        mithril_prefetch_plain(cache, stats, mith, block, valid, mcfg)
        return
    args = _PREFETCH((*cache[:N_TABLES], cache.clock, *stats, mith.pf_key,
                      mith.pf_vals), mcfg.pf_buckets)
    _check_request(block, valid, args.c.lanes, cache.key.device)
    if args.c.lanes == 0:
        return
    fn = backend.c_function(LIB, "mithril_prefetch", [ctypes.c_void_p] * 4)
    err = fn(ctypes.byref(args), block.data_ptr(), valid.data_ptr(),
             backend.stream_of(block))
    backend.check_launch(err, "mithril_prefetch")
    mithril_prefetch_kernel.launches += 1


mithril_prefetch_kernel.launches = 0
