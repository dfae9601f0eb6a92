"""State and configuration carried between the reference and the port.

A state produced by the JAX reference (as numpy arrays, or anything
``numpy.asarray`` takes) continues in the port, and the other way round:

* :func:`to_torch` maps a tree of arrays — the state NamedTuples
  ``MithrilState``, ``CacheState``, ``AmpState``, ``PgState``, ``Stats``
  (matched by class name), dicts such as the sweep carry, lists and
  tuples — onto the port's types, every leaf a tensor of the same dtype
  (the reference's leaves are int32) on ``device``;
* :func:`to_numpy` maps a tree of tensors back to numpy arrays, keeping
  the port's NamedTuple types (build the reference's with ``T(*leaves)``);
* :func:`config_from` rebuilds a frozen configuration dataclass
  (``SimConfig``, ``MithrilConfig``, ``AmpConfig``, ``PgConfig``,
  ``LearnedConfig`` with its fixed-point weights) as the port's class of
  the same name;
* :func:`tier_from` carries a reference ``TieredKVCache`` across into
  the port's, mid-stream: pools, slots and their metadata, clock,
  counters and MITHRIL state.

The port's functions take a leading lanes axis; the reference's sweep
carry has one, a single reference state gets one with ``lanes=True``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Union

import numpy as np
import torch

from .cache.amp import AmpConfig, AmpState
from .cache.base import CacheState, pack_cache
from .cache.pg import PgConfig, PgState
from .cache.simulator import SimConfig, Stats
from .cache.tiered import TieredKVCache, TieredStats
from .core.config import MithrilConfig
from .core.state import MithrilState
from .learn.policy import LearnedConfig

_TUPLES = {t.__name__: t for t in (MithrilState, CacheState, AmpState,
                                   PgState, Stats)}
_CONFIGS = {c.__name__: c for c in (SimConfig, MithrilConfig, AmpConfig,
                                    PgConfig, LearnedConfig)}
_DTYPES = {np.dtype(np.int32): torch.int32, np.dtype(np.bool_): torch.bool}


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def to_torch(tree: Any, device: Union[None, str, torch.device] = None,
             lanes: bool = False) -> Any:
    """Numpy-like leaves -> tensors on ``device`` (None: the card).

    ``lanes=True`` adds a leading lanes axis of 1 to every leaf (a
    single reference state becomes a one-lane port state)."""
    from .kernels.backend import resolve_device
    dev = resolve_device(device)

    def go(x):
        if isinstance(x, dict):
            return {k: go(v) for k, v in x.items()}
        if _is_namedtuple(x):
            name = type(x).__name__
            leaves = [go(v) for v in x]
            if name == "CacheState":    # tables packed into one tensor
                return pack_cache(*leaves)
            return _TUPLES.get(name, type(x))(*leaves)
        if isinstance(x, (list, tuple)):
            return type(x)(go(v) for v in x)
        arr = np.asarray(x)
        if arr.dtype not in _DTYPES:
            raise TypeError(f"unsupported leaf dtype {arr.dtype}")
        t = torch.tensor(arr, dtype=_DTYPES[arr.dtype], device=dev)
        return t[None].contiguous() if lanes else t

    return go(tree)


def to_numpy(tree: Any) -> Any:
    """Tensor leaves -> numpy arrays (dtype kept)."""
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*(to_numpy(v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_numpy(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return np.asarray(tree)


def config_from(cfg: Any) -> Any:
    """A configuration dataclass rebuilt as the port's class of the same
    name, field by field (nested configs too)."""
    cls = _CONFIGS[type(cfg).__name__]
    kw = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        kw[f.name] = (config_from(v) if dataclasses.is_dataclass(v)
                      else v)
    return cls(**kw)


def tier_from(ref: Any, device: Union[None, str, torch.device] = None
              ) -> TieredKVCache:
    """A reference ``TieredKVCache`` as the port's, on ``device``.

    Carries the host pools, the slot pools and slot metadata, the
    page -> slot map, the clock, the counters, the configuration and the
    MITHRIL state (one lane), so the port continues the reference's
    access stream with the same counters."""
    cfg = None if ref.mith_cfg is None else config_from(ref.mith_cfg)
    tier = TieredKVCache.from_host_pools(
        np.asarray(ref.host_k), np.asarray(ref.host_v), ref.n_hbm_slots,
        mithril_cfg=cfg, device=device)
    tier.hbm_k.copy_(torch.from_numpy(np.asarray(ref.hbm_k)))
    tier.hbm_v.copy_(torch.from_numpy(np.asarray(ref.hbm_v)))
    for name in ("slot_page", "slot_stamp", "slot_pf", "slot_sc"):
        getattr(tier, name)[:] = getattr(ref, name)
    tier.page_slot = {int(p): int(s) for p, s in ref.page_slot.items()}
    tier.clock = int(ref.clock)
    tier.stats = TieredStats(**dataclasses.asdict(ref.stats))
    if cfg is not None:
        tier._mstate = to_torch(ref._mstate, device, lanes=True)
    return tier
