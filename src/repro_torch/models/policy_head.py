"""Tiny policy heads for the learned cache-management lane.

Counterpart of ``repro/models/policy_head.py``: the training-time twin
of ``learn/policy.py``, with the same two model shapes (logistic
regression, one-ReLU-hidden-layer MLP) over batched ``(N, F)`` feature
matrices, so ``learn/train.py`` can differentiate them and step them
with ``optim/adamw.py``. After training, ``learn.policy.
params_to_weights`` freezes them into the hashable tuples the request
path carries, where they are applied in int32 fixed point.

Fixed-order float32. The reference's formulas, computed so that the CPU
and the card give the same bits: a library matmul or ``sum`` adds in an
order of its own on each device, and a few hundred Adam steps carry a
last-bit difference far enough to change the Q8 weights the request
path uses. So here every product of a feature and a weight is its own
multiply and the terms are added in feature (then hidden-unit) order;
every sum over samples is :func:`tree_sum`, halves added pairwise; a
parameter is spread over the samples by :class:`_Spread`, whose
gradient is that same :func:`tree_sum`; the loss's ``exp`` is
:func:`exp_nonpos`, a polynomial in correctly rounded operations (each
a kernel of its own, so nothing is fused into an FMA); and no float32
op whose last bit differs between the CPU and the card (``sqrt``, a
division by a Python number) is used. Autograd's backward of these is
elementwise and the same on both. Only the loss value's ``log1p`` is
the library's, and it feeds no gradient.

Parameters are a dict keyed as the reference's (``w``, ``b`` for
``logreg``; ``w1``, ``b1``, ``w2``, ``b2`` for ``mlp``); :class:`PolicyHead`
holds the same names as ``nn.Parameter``\\ s. Initial draws come from an
explicit ``torch.Generator`` and cannot equal ``jax.random``'s for the
same seed: to train both from one start, carry the reference's initial
parameters across with ``convert.policy_head_from``.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch

from ..optim.adamw import tree_sum

N_FEATURES = 4

# exp(x) = p(r) * 2^n with n = round(x / ln 2) and r = x - n ln 2, the
# reduction in two parts (LN2_HI has few enough bits that n * LN2_HI is
# exact) and p the degree-7 polynomial of Cephes' expf (|r| <= ln2/2)
LOG2E = 1.44269504088896341
LN2_HI = 0.693359375
LN2_LO = -2.12194440e-4
EXP_POLY = (1.9875691500e-4, 1.3981999507e-3, 8.3334519073e-3,
            4.1665795894e-2, 1.6666665459e-1, 5.0000001201e-1)
EXP_MIN = -80.0     # e^-80 ~ 1.8e-35: the result stays a normal float32


class _Spread(torch.autograd.Function):
    """A parameter repeated over ``n`` samples, whose gradient is the
    :func:`tree_sum` of the samples' gradients (autograd's own
    broadcast gradient would sum in the device's order)."""

    @staticmethod
    def forward(ctx, p: torch.Tensor, n: int) -> torch.Tensor:
        return p.expand((n,) + tuple(p.shape)).clone()

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        return tree_sum(g), None


class _ExpNonPos(torch.autograd.Function):
    """``exp(x)`` for ``x <= 0`` from correctly rounded operations only;
    its gradient is ``grad * exp(x)``, as ``torch.exp``'s."""

    @staticmethod
    def forward(ctx, x: torch.Tensor) -> torch.Tensor:
        x = torch.clamp(x, min=EXP_MIN)
        n = torch.round(x * LOG2E)
        r = (x - n * LN2_HI) - n * LN2_LO
        p = torch.full_like(r, EXP_POLY[0])
        for c in EXP_POLY[1:]:
            p = p * r + c
        p = (p * (r * r) + r) + 1.0
        scale = ((n.to(torch.int32) + 127) << 23).view(torch.float32)
        out = p * scale
        ctx.save_for_backward(out)
        return out

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        (out,) = ctx.saved_tensors
        return g * out


def exp_nonpos(x: torch.Tensor) -> torch.Tensor:
    """``exp`` of a non-positive float32 tensor, the same bits on every
    device (about 1 ulp from the library's; below ``EXP_MIN`` it stays
    at ``e^EXP_MIN``)."""
    return _ExpNonPos.apply(x)


def _relu(z: torch.Tensor) -> torch.Tensor:
    """``max(z, 0)`` whose gradient at ``z == 0`` is 1/2, as the
    reference's ``jnp.maximum`` (``clamp_min`` would pass all of it)."""
    return torch.maximum(z, z.new_zeros(()))


def init_params(kind: str, generator: Optional[torch.Generator] = None,
                hidden: int = 8, n_features: int = N_FEATURES
                ) -> Dict[str, torch.Tensor]:
    """Fresh float32 head parameters on the CPU (scaled-normal init, as
    the reference's); ``generator`` defaults to a CPU generator seeded
    with 0."""
    if generator is None:
        generator = torch.Generator().manual_seed(0)

    def normal(*shape):
        return torch.randn(shape, generator=generator, dtype=torch.float32)

    if kind == "logreg":
        return {"w": 0.1 * normal(n_features),
                "b": torch.zeros((), dtype=torch.float32)}
    if kind != "mlp":
        raise ValueError(f"bad policy head kind: {kind}")
    return {"w1": normal(n_features, hidden)
            / math.sqrt(float(n_features)),
            "b1": torch.zeros(hidden, dtype=torch.float32),
            "w2": normal(hidden) / math.sqrt(float(hidden)),
            "b2": torch.zeros((), dtype=torch.float32)}


def _dot(cols, weights, bias: torch.Tensor) -> torch.Tensor:
    """``sum_i cols[i] * weights[i]`` added in order ``i``, then the bias."""
    acc = None
    for c, w in zip(cols, weights):
        acc = c * w if acc is None else acc + c * w
    return acc + bias


def apply(kind: str, params: Dict[str, torch.Tensor],
          x: torch.Tensor) -> torch.Tensor:
    """Keep-score logits for an ``(N, F)`` feature batch -> ``(N,)``:
    the reference's ``x @ w + b`` (logreg) and
    ``relu(x @ w1 + b1) @ w2 + b2`` (mlp), in fixed order."""
    n = x.shape[0]
    if kind == "logreg":
        w = _Spread.apply(params["w"], n)
        return _dot([x[:, f] for f in range(x.shape[1])],
                    [w[:, f] for f in range(x.shape[1])],
                    _Spread.apply(params["b"], n))
    w1 = _Spread.apply(params["w1"], n)
    h = _relu(_dot([x[:, f:f + 1] for f in range(x.shape[1])],
                   [w1[:, f] for f in range(x.shape[1])],
                   _Spread.apply(params["b1"], n)))
    w2 = _Spread.apply(params["w2"], n)
    return _dot([h[:, j] for j in range(h.shape[1])],
                [w2[:, j] for j in range(h.shape[1])],
                _Spread.apply(params["b2"], n))


def bce_loss(kind: str, params: Dict[str, torch.Tensor], x: torch.Tensor,
             y: torch.Tensor) -> torch.Tensor:
    """Mean sigmoid cross-entropy of keep-logits against reuse labels.

    Stable form: ``max(z,0) - z*y + log1p(exp(-|z|))``.
    """
    z = apply(kind, params, x)
    y = y.to(torch.float32)
    terms = _relu(z) - z * y + torch.log1p(exp_nonpos(-torch.abs(z)))
    # a 0-d tensor divisor: the card divides by a Python number as a
    # multiply by its reciprocal, which can round otherwise
    return tree_sum(terms) / torch.tensor(float(z.shape[0]),
                                          device=z.device)


class PolicyHead(torch.nn.Module):
    """A head as a module: its parameters carry the reference's names."""

    def __init__(self, kind: str,
                 params: Optional[Dict[str, torch.Tensor]] = None,
                 generator: Optional[torch.Generator] = None,
                 hidden: int = 8):
        super().__init__()
        self.kind = kind
        if params is None:
            params = init_params(kind, generator, hidden)
        for name, value in params.items():
            self.register_parameter(name, torch.nn.Parameter(
                torch.as_tensor(value, dtype=torch.float32).clone()))

    def params(self) -> Dict[str, torch.Tensor]:
        return dict(self.named_parameters())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return apply(self.kind, self.params(), x)

    def loss(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        return bce_loss(self.kind, self.params(), x, y)
