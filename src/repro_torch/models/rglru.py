"""RG-LRU recurrent block (Griffin / RecurrentGemma, arXiv:2402.19427).

Diagonal gated linear recurrence:
    a_t = exp(-c * softplus(Lambda) * sigmoid(W_a x_t))
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (sigmoid(W_i x_t) * x_t)

A short causal depthwise conv1d (width 4) precedes the recurrence. The
full-sequence form (prefill, the forward) runs the recurrence in
float32 step by step from the carried state; the reference computes the
same recurrence with a parallel associative scan, whose different order
of float32 products moves ``h`` by a few float32 ulps (the tests state
the tolerance). Decode is the single-step update.

Dtypes are the reference's: the products and the conv in bf16, every
step rounded (its width-4 sum adds four bf16 products in order from 0),
the gates and the recurrence in float32; the state ``h`` is float32 and
``conv`` bf16.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple, Union

import torch

from .layers import Params, gelu, weight

RG_C = 8.0
CONV_W = 4
Device = Optional[Union[str, torch.device]]


class RgState(NamedTuple):
    h: torch.Tensor      # (B, d) recurrent state, float32
    conv: torch.Tensor   # (B, CONV_W - 1, d) trailing conv inputs, bf16


def init_rg_state(batch: int, d: int, device: Device = None) -> RgState:
    return RgState(
        h=torch.zeros((batch, d), dtype=torch.float32, device=device),
        conv=torch.zeros((batch, CONV_W - 1, d), dtype=torch.bfloat16,
                         device=device))


class RgLRU(Params):
    """The block's parameters, in the reference's layouts (bf16, ``lam``
    float32)."""

    def __init__(self, d: int, device: Device = None):
        super().__init__()
        for name in ("w_gate", "w_x", "w_a", "w_i", "w_out"):
            setattr(self, name, weight((d, d), device))
        self.conv_w = weight((CONV_W, d), device)
        self.conv_b = weight((d,), device)
        self.lam = weight((d,), device, torch.float32)


def init_rglru_params(p: RgLRU, generator: torch.Generator) -> None:
    """The reference's initialisation: Normal(0, 1/d) projections, a
    uniform 1/4 conv with no bias, and ``lam`` such that ``a^c`` spans
    (0.9, 0.999) over the channels."""
    d = p.w_x.shape[0]
    with torch.no_grad():
        for name in ("w_gate", "w_x", "w_a", "w_i", "w_out"):
            w = torch.randn((d, d), generator=generator, dtype=torch.float32,
                            device=p.w_x.device)
            p[name].copy_(w * d ** -0.5)
        p.conv_w.fill_(1.0 / CONV_W)
        p.conv_b.zero_()
        a = torch.linspace(0.9, 0.999, d, dtype=torch.float32,
                           device=p.lam.device)
        p.lam.copy_(torch.log(torch.expm1(-torch.log(a) / RG_C)))


def _gates(p, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The decay ``a`` and gated input ``b`` (float32). x: (..., d)."""
    xf = x.float()
    r = torch.sigmoid(xf @ p["w_a"].float())
    i = torch.sigmoid(xf @ p["w_i"].float())
    lam = p["lam"].float()
    log_a = -RG_C * torch.logaddexp(lam, torch.zeros_like(lam)) * r
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * (i * xf)
    return a, b


def _conv_sum(xp: torch.Tensor, p, s: int) -> torch.Tensor:
    """The width-4 causal conv over ``xp`` (B, s + 3, d): the reference's
    ``sum`` of four bf16 products, in order, before the bias."""
    conv_w = p["conv_w"].to(xp.dtype)
    out = xp[:, 0:s] * conv_w[0]
    for i in range(1, CONV_W):
        out = out + xp[:, i:i + s] * conv_w[i]
    return out


def _conv1d(p, x: torch.Tensor, conv_state: torch.Tensor):
    """Causal depthwise conv, width 4. x: (B, S, d); conv_state: (B, 3, d).
    Returns (out, new conv state)."""
    xp = torch.cat([conv_state.to(x.dtype), x], dim=1)
    out = _conv_sum(xp, p, x.shape[1])
    return out + p["conv_b"].to(x.dtype), xp[:, -(CONV_W - 1):]


def linear_scan(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor
                ) -> torch.Tensor:
    """``h_t = a_t * h_{t-1} + b_t`` over axis 1 from ``h0``, float32, one
    step at a time. a, b: (B, S, d); h0: (B, d) -> h (B, S, d)."""
    h = h0
    out = []
    for t in range(a.shape[1]):
        h = a[:, t] * h + b[:, t]
        out.append(h)
    return torch.stack(out, dim=1)


def rglru_block(p, x: torch.Tensor, state: RgState
                ) -> Tuple[torch.Tensor, RgState]:
    """Full-sequence form. x: (B, S, d) -> (y, new state)."""
    gate = gelu(x @ p["w_gate"])
    u, conv_new = _conv1d(p, x @ p["w_x"], state.conv)
    a, b = _gates(p, u)
    h = linear_scan(a, b, state.h)
    y = (gate.float() * h).to(x.dtype) @ p["w_out"]
    return y, RgState(h=h[:, -1], conv=conv_new)


def rglru_decode(p, x: torch.Tensor, state: RgState
                 ) -> Tuple[torch.Tensor, RgState]:
    """Single-token step. x: (B, 1, d)."""
    gate = gelu(x @ p["w_gate"])
    u = x @ p["w_x"]
    xp = torch.cat([state.conv.to(u.dtype), u], dim=1)      # (B, 4, d)
    u1 = _conv_sum(xp, p, 1) + p["conv_b"].to(u.dtype)
    a, b = _gates(p, u1)
    h = a[:, 0] * state.h + b[:, 0]
    y = (gate.float() * h[:, None]).to(x.dtype) @ p["w_out"]
    return y, RgState(h=h, conv=xp[:, 1:])
