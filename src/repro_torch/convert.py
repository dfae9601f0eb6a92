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
  counters and MITHRIL state;
* :func:`policy_head_from` carries a reference policy head's parameters
  (``w``, ``b`` / ``w1``, ``b1``, ``w2``, ``b2``, as numpy) across as
  the port's float32 tensors, so that both train from the same start;
* :func:`lm_params_from` carries a reference language model's parameter
  pytree (as numpy: groups stacked over a leading repeats axis, ``u<j>``
  units) into the port's ``models.lm.CausalLM``, one tensor per layer,
  dtypes kept (bf16 weights, the float32 MoE router);
  :func:`lm_state_names` names, for each entry of the port's state dict,
  the reference leaf it comes from;
* :func:`adamw_state_from` carries a reference AdamW state of such a
  model (``OptState``: step, master, m, v, as numpy) into the port's
  ``optim.adamw.OptState`` under the same names.

The port's functions take a leading lanes axis; the reference's sweep
carry has one, a single reference state gets one with ``lanes=True``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple, Union

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
    if cfg is not None:      # into the tier's own tensors, which it binds
        for mine, theirs in zip(tier._mstate, to_torch(ref._mstate, device,
                                                       lanes=True)):
            mine.copy_(theirs)
    return tier


def policy_head_from(ref_params: Any,
                     device: Union[None, str, torch.device] = None
                     ) -> dict:
    """A reference head's ``{name: array}`` parameters as the port's
    ``{name: float32 tensor}`` on ``device`` (None: the card), for
    ``models.policy_head`` and ``learn.train.train_head(init=...)``."""
    from .kernels.backend import resolve_device
    dev = resolve_device(device)
    out = {}
    for name, value in ref_params.items():
        arr = np.asarray(value)
        if arr.dtype != np.float32:
            raise TypeError(f"head parameter {name!r} is {arr.dtype}, not "
                            "float32")
        out[name] = torch.tensor(arr, dtype=torch.float32, device=dev)
    return out


def lm_state_names(cfg) -> Dict[str, Tuple]:
    """``{port state-dict name: reference path}`` for a model of ``cfg``.

    A path indexes the reference's pytree step by step, a trailing int
    picking a layer's slice of its group's repeats axis:
    ``"layers.3.attn.wq"`` comes from ``("blocks", 0, "u0", "attn", "wq",
    3)``, ``params["blocks"][0]["u0"]["attn"]["wq"][3]``; the encoder's
    ``"enc_layers.1.ln1.s"`` from ``("enc_blocks", "u0", "ln1", "s", 1)``,
    and ``"final_norm.b"`` from ``("final_norm", "b")``."""
    from .models.lm import CausalLM, layer_slots
    slots = layer_slots(cfg)
    names = {}
    for name in CausalLM(cfg, device="meta").state_dict():
        head, _, rest = name.partition(".")
        if head == "layers":
            i, _, sub = rest.partition(".")
            gi, j, r, _ = slots[int(i)]
            names[name] = ("blocks", gi, f"u{j}", *sub.split("."), r)
        elif head == "enc_layers":
            i, _, sub = rest.partition(".")
            names[name] = ("enc_blocks", "u0", *sub.split("."), int(i))
        else:
            names[name] = tuple(name.split("."))
    return names


def _leaf_tensor(arr, dtype: torch.dtype, device) -> torch.Tensor:
    arr = np.array(arr)                     # a writable copy
    if arr.dtype.name == "bfloat16":        # numpy's bf16 (ml_dtypes): bits
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    if t.dtype != dtype:
        raise TypeError(f"reference leaf is {t.dtype}, the port's {dtype}")
    return t.to(device)


def lm_params_from(params_np: Any, cfg,
                   device: Union[None, str, torch.device] = None):
    """A reference model's parameters (its pytree, leaves as numpy) as the
    port's ``CausalLM`` on ``device`` (None: the card)."""
    from .kernels.backend import resolve_device
    from .models.lm import CausalLM
    dev = resolve_device(device)
    model = CausalLM(cfg, device=dev)
    state = model.state_dict()
    with torch.no_grad():
        for name, path in lm_state_names(cfg).items():
            leaf = params_np
            for key in path:
                leaf = leaf[key]
            value = _leaf_tensor(leaf, state[name].dtype, dev)
            if value.shape != state[name].shape:
                raise ValueError(f"{name}: reference shape "
                                 f"{tuple(value.shape)}, the port's "
                                 f"{tuple(state[name].shape)}")
            state[name].copy_(value)
    return model


def _lm_leaves(tree_np: Any, cfg, dtype: torch.dtype, dev) -> Dict[str,
                                                                     torch.Tensor]:
    out = {}
    for name, path in lm_state_names(cfg).items():
        leaf = tree_np
        for key in path:
            leaf = leaf[key]
        out[name] = _leaf_tensor(leaf, dtype, dev)
    return out


def adamw_state_from(ref_state: Any, cfg,
                     device: Union[None, str, torch.device] = None):
    """A reference AdamW state of a ``cfg`` model (its ``OptState``:
    ``step``, and ``master``, ``m``, ``v`` pytrees shaped as the
    parameters, leaves as numpy float32) as the port's ``OptState``: the
    step an int32 scalar on the host, the rest float32 tensors on
    ``device`` (None: the card) keyed by the port's parameter names."""
    from .kernels.backend import resolve_device
    from .optim.adamw import OptState
    dev = resolve_device(device)
    step_, master, m, v = ref_state
    return OptState(
        step=torch.tensor(int(np.asarray(step_)), dtype=torch.int32),
        master=_lm_leaves(master, cfg, torch.float32, dev),
        m=_lm_leaves(m, cfg, torch.float32, dev),
        v=_lm_leaves(v, cfg, torch.float32, dev))
