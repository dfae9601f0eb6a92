"""AdamW with the reference's own formulas.

The reference's AdamW (its ``optim`` package), not ``torch.optim.AdamW``
(whose epsilon placement and decay order differ): global-norm
clipping of the gradients, then per parameter the bias-corrected
``mhat / (sqrt(vhat) + eps)`` step, plus ``weight_decay * p`` where
:func:`_decay_mask` allows it, scaled by the linear-warmup/cosine
:func:`schedule`; the moments and a float32 master copy live in the
optimizer state, and a parameter of a narrower dtype gets the master
cast down.

:func:`update` is the functional form over ``{name: tensor}`` dicts
(the reference's ``update`` with names for its tree paths): it returns
a new state and keeps the old. :func:`update_` is the same step in
place, the form the training driver and :class:`AdamW` (a
``torch.optim.Optimizer`` over named parameters) take: a float32 state
is 12 bytes a parameter, and two of them do not fit beside a 3B
model. Every scalar (step, learning rate, norm, bias corrections)
is float32. The step count and what depends on it alone (learning
rate, bias corrections) are computed on the host and copied to the
parameters' device; a step reads nothing back. Sums (the global norm)
are :func:`tree_sum`, whose order is the same on every device, and
square roots :func:`sqrt_rn`, correctly rounded on every device, so
the CPU and the card step alike bit for bit.
"""

from __future__ import annotations

import dataclasses
import math
from typing import (Dict, Iterable, Mapping, NamedTuple, Optional, Tuple,
                    Union)

import torch
from torch.overrides import handle_torch_function, has_torch_function


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


class OptState(NamedTuple):
    step: torch.Tensor                  # int32 scalar, on the host
    master: Dict[str, torch.Tensor]     # float32 params
    m: Dict[str, torch.Tensor]          # float32 first moment
    v: Dict[str, torch.Tensor]          # float32 second moment


def _f32(x, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=like.device)


def tree_sum(v: torch.Tensor) -> torch.Tensor:
    """Sum over the first axis in a fixed order: zero-padded to a power
    of two, then halves added until one row is left (a library ``sum``
    adds in an order of its own on each device)."""
    n = v.shape[0]
    size = 1 << max(0, (n - 1).bit_length())
    if size != n:
        v = torch.cat([v, v.new_zeros((size - n,) + tuple(v.shape[1:]))])
    while v.shape[0] > 1:
        half = v.shape[0] // 2
        v = v[:half] + v[half:]
    return v[0]


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded float32 ``sqrt``: the card's float32
    ``torch.sqrt`` is not (some values differ from the CPU's in the last
    bit). A float64 root rounded to float32 is the correctly rounded
    one, since 53 >= 2 * 24 + 2 bits makes the double rounding of a
    square root harmless."""
    return torch.sqrt(x.to(torch.float64)).to(torch.float32)


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warm-up to ``lr``, then a cosine down to
    ``lr * min_lr_frac`` at ``total_steps`` (float32, like ``step``'s
    device)."""
    s = step.to(torch.float32)
    warm = s / max(1, cfg.warmup_steps)
    prog = torch.clamp((s - cfg.warmup_steps)
                       / max(1, cfg.total_steps - cfg.warmup_steps), 0, 1)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
        1 + torch.cos(_f32(math.pi, s) * prog))
    return cfg.lr * torch.where(s < cfg.warmup_steps, warm, cos)


def global_norm(tensors: Union[Mapping[str, torch.Tensor],
                               Iterable[torch.Tensor]]) -> torch.Tensor:
    """``sqrt`` of the sum of squares of every element, in float32; a
    dict is summed in sorted key order (the reference's leaf order).
    Overridable by ``__torch_function__`` (a mesh sums each rank's
    shards and all-reduces the sums)."""
    if isinstance(tensors, Mapping):
        tensors = [tensors[k] for k in sorted(tensors)]
    tensors = tuple(tensors)
    if has_torch_function(tensors):
        return handle_torch_function(global_norm, tensors, tensors)
    total = None
    for x in tensors:
        s = tree_sum(torch.square(x.to(torch.float32)).reshape(-1))
        total = s if total is None else total + s
    return sqrt_rn(total)


def _decay_mask(name: str) -> bool:
    """No weight decay on norms / biases / 1-D params (the reference's
    rule on the parameter's path, ``/``-joined)."""
    return not any(t in name for t in ("ln", "norm", "bias", "b_", "mu_",
                                       "lam", "w0", "u"))


def init(params: Mapping[str, torch.Tensor]) -> OptState:
    return OptState(
        step=torch.zeros((), dtype=torch.int32),
        master={k: p.detach().to(torch.float32).clone()
                for k, p in params.items()},
        m={k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
           for k, p in params.items()},
        v={k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
           for k, p in params.items()})


def _prologue(cfg: AdamWConfig, grads: Mapping[str, torch.Tensor],
              state: OptState):
    """The next step count (on the host) and, on the gradients' device,
    the learning rate and the two bias corrections of that step, the
    global gradient norm and the clipping scale."""
    step = state.step.cpu() + 1
    sf = step.to(torch.float32)
    dev = next(iter(grads.values())).device
    lr, b1c, b2c = (t.to(dev) for t in (
        schedule(cfg, step), 1 - torch.pow(_f32(cfg.b1, sf), sf),
        1 - torch.pow(_f32(cfg.b2, sf), sf)))
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    return step, (lr, b1c, b2c, scale), gnorm


def _leaf_update(cfg: AdamWConfig, g, m, v, p, decay: bool, scalars):
    """One parameter's new (master, m, v), float32."""
    lr, b1c, b2c, scale = scalars
    g = g.to(torch.float32) * scale
    m = cfg.b1 * m + (1 - cfg.b1) * g
    v = cfg.b2 * v + (1 - cfg.b2) * torch.square(g)
    delta = (m / b1c) / (sqrt_rn(v / b2c) + cfg.eps)
    if decay:
        delta = delta + cfg.weight_decay * p
    return p - lr * delta, m, v


def _decays(grads, decay: Optional[Mapping[str, bool]]) -> Dict[str, bool]:
    return {k: (_decay_mask(k) if decay is None else bool(decay[k]))
            for k in grads}


def update(cfg: AdamWConfig, grads: Mapping[str, torch.Tensor],
           state: OptState, params: Mapping[str, torch.Tensor],
           decay: Optional[Mapping[str, bool]] = None
           ) -> Tuple[Dict[str, torch.Tensor], OptState,
                      Dict[str, torch.Tensor]]:
    """The functional step: returns ``(new_params, new_state, metrics)``
    and leaves ``state`` and ``params`` as they were (so the old and the
    new state are alive together; :func:`update_` writes in place).
    ``params`` gives each parameter's dtype (the master copy is
    float32); ``decay`` says per name whether weight decay applies
    (default: :func:`_decay_mask` of the name)."""
    step, scalars, gnorm = _prologue(cfg, grads, state)
    master, m_out, v_out = {}, {}, {}
    for k, d in _decays(grads, decay).items():
        master[k], m_out[k], v_out[k] = _leaf_update(
            cfg, grads[k], state.m[k], state.v[k], state.master[k], d,
            scalars)
    new_params = {k: master[k].to(params[k].dtype) for k in master}
    return (new_params, OptState(step, master, m_out, v_out),
            {"grad_norm": gnorm, "lr": scalars[0]})


@torch.no_grad()
def update_(cfg: AdamWConfig, grads: Mapping[str, torch.Tensor],
            state: OptState, params: Mapping[str, torch.Tensor],
            decay: Optional[Mapping[str, bool]] = None
            ) -> Tuple[OptState, Dict[str, torch.Tensor]]:
    """:func:`update` in place, with the same bits: each parameter's
    master copy, moments and the parameter itself are overwritten one
    parameter at a time, so at most one parameter's temporaries are
    alive beside the state (the reference donates its buffers instead).
    Returns ``(state with the step advanced, metrics)``; the state's
    dicts are the same objects as before."""
    step, scalars, gnorm = _prologue(cfg, grads, state)
    for k, d in _decays(grads, decay).items():
        p, m, v = _leaf_update(cfg, grads[k], state.m[k], state.v[k],
                               state.master[k], d, scalars)
        state.m[k].copy_(m)
        state.v[k].copy_(v)
        state.master[k].copy_(p)
        params[k].copy_(p)
        del p, m, v             # before the next parameter's temporaries
    return state._replace(step=step), {"grad_norm": gnorm,
                                       "lr": scalars[0]}


class AdamW(torch.optim.Optimizer):
    """:func:`update_` as an optimizer over named parameters.

    ``params`` is a module, a ``{name: parameter}`` dict or
    ``(name, parameter)`` pairs: the names decide the weight decay
    (:func:`_decay_mask`) and order the global norm. ``step`` clips by
    the norm of every gradient at once, so there is one parameter group;
    a parameter with no gradient gets a zero one. ``metrics`` holds the
    last step's ``grad_norm`` and ``lr``.
    """

    def __init__(self, params, cfg: AdamWConfig = AdamWConfig()):
        if isinstance(params, torch.nn.Module):
            params = params.named_parameters()
        named = list(params.items() if isinstance(params, Mapping)
                     else params)
        if not named or not all(isinstance(n, str) for n, _ in named):
            raise ValueError("AdamW takes named parameters")
        super().__init__([{"params": [p for _, p in named],
                           "names": [n for n, _ in named]}],
                         {"cfg": cfg})
        self.cfg = cfg
        self._opt_state = init(dict(named))
        self.metrics: Dict[str, torch.Tensor] = {}

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        group = self.param_groups[0]
        params = dict(zip(group["names"], group["params"]))
        grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p))
                 for n, p in params.items()}
        self._opt_state, self.metrics = update_(
            self.cfg, grads, self._opt_state, params)
        return loss
