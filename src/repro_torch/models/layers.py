"""Shared neural building blocks: bf16 parameters, fp32 math where the
reference asks for it.

Each function computes what its namesake in the reference does, in the
same dtypes: a product of two bf16 tensors is rounded to bf16, and the
norms and rotary embedding compute in float32 and round once at the end.
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Sequence, Union

import torch
from torch import nn


def weight(shape, device, dtype: torch.dtype = torch.bfloat16
           ) -> nn.Parameter:
    """An uninitialised parameter, frozen until a trainer opens it to
    autograd (``module.requires_grad_()``)."""
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


class Params(nn.Module):
    """A module of named parameters that also reads as the reference's
    parameter dict: ``p["w_x"]`` is ``p.w_x``."""

    def __getitem__(self, name: str) -> torch.Tensor:
        return getattr(self, name)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float
             ) -> torch.Tensor:
    """RMS norm with a ``1 + scale`` gain (a zero scale is the identity
    gain)."""
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * (1.0 + scale.float())
    return out.to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float
         ) -> torch.Tensor:
    """Rotary embedding over the two halves of the head dimension (not
    interleaved). x: (..., S, H, hd); positions: (..., S)."""
    half = x.shape[-1] // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                          device=x.device) / half))
    ang = positions[..., :, None].float() * freqs          # (..., S, half)
    cos = torch.cos(ang)[..., :, None, :]                  # (..., S, 1, half)
    sin = torch.sin(ang)[..., :, None, :]
    xf1, xf2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin], -1)
    return out.to(x.dtype)


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``1 / (1 + exp(-x))`` with every step rounded to ``x``'s dtype, as
    the reference's ``jax.nn.sigmoid`` computes it (in bf16 this differs
    from ``torch.sigmoid``'s one rounding in about a third of the
    values)."""
    return 1 / (1 + torch.exp(-x))


def silu(x: torch.Tensor) -> torch.Tensor:
    """``x * sigmoid(x)``, rounded step by step like ``jax.nn.silu``."""
    return x * sigmoid(x)


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    g = x @ w_gate
    u = x @ w_up
    return (silu(g) * u) @ w_down


def gelu(x: torch.Tensor) -> torch.Tensor:
    """The tanh approximation of GELU (``jax.nn.gelu``'s default) with
    every step rounded to ``x``'s dtype, its constants included, as the
    reference computes it: ``x * (0.5 * (1 + tanh(c * (x + 0.044715 *
    x * (x * x)))))``, ``c = sqrt(2 / pi)``."""
    cube = x * (x * x)
    inner = rounded(math.sqrt(2 / math.pi), x.dtype) * (
        x + rounded(0.044715, x.dtype) * cube)
    return x * (0.5 * (1.0 + torch.tanh(inner)))


@functools.lru_cache(maxsize=None)
def rounded(value: float, dtype: torch.dtype) -> float:
    """``value`` rounded to ``dtype``, as a Python number: a constant that
    multiplies a ``dtype`` tensor as the reference's constant of that
    dtype does (a bf16 op computes in float32, where the product of two
    bf16 values is exact)."""
    return torch.tensor(value, dtype=dtype).item()


def gelu_mlp(x: torch.Tensor, w_up: torch.Tensor, b_up: torch.Tensor,
             w_down: torch.Tensor, b_down: torch.Tensor) -> torch.Tensor:
    """GELU MLP with biases (``gelu``)."""
    return gelu(x @ w_up + b_up) @ w_down + b_down


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float) -> torch.Tensor:
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = xf.var(-1, keepdim=True, correction=0)
    out = (xf - mean) * torch.rsqrt(var + eps)
    out = out * (1.0 + scale.float()) + bias.float()
    return out.to(x.dtype)


def sinusoidal_pos(positions: torch.Tensor, d: int) -> torch.Tensor:
    """Absolute sinusoidal embedding (whisper-style). positions: (..., S)."""
    half = d // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(
        half, dtype=torch.float32, device=positions.device) / (half - 1))
    ang = positions[..., None].float() * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def dense_init(shape: Sequence[int], generator: torch.Generator,
               in_axis: int = 0, dtype: torch.dtype = torch.bfloat16,
               device: Optional[Union[str, torch.device]] = None
               ) -> torch.Tensor:
    """Normal(0, 1/fan_in) weights drawn in float32 from ``generator``
    (which must live on ``device``), then cast to ``dtype``."""
    std = shape[in_axis] ** -0.5
    w = torch.randn(tuple(shape), generator=generator, dtype=torch.float32,
                    device=device)
    return (w * std).to(dtype)
