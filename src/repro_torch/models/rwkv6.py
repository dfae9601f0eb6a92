"""RWKV-6 "Finch" block (arXiv:2404.05892): attention-free, with a
data-dependent decay.

Per head, with state S in R^{hd x hd}:
    S_t = diag(w_t) S_{t-1} + k_t (x) v_t
    o_t = r_t . (S_{t-1} + diag(u) k_t (x) v_t)

The prefill and the forward use the chunkwise-parallel form (an
intra-chunk "attention" matrix and an inter-chunk state carry, float32,
chunks of 32) when the sequence is a whole number of chunks, as the
reference chooses; otherwise, and in decode, the sequential recurrence.
The decay ``w`` comes from a low-rank MLP and is float32.

Dtypes are the reference's: the token shift, the mixes and the
projections in bf16 with every step rounded (``jax.nn.silu`` and
``jax.nn.sigmoid`` as ``layers.silu`` / ``layers.sigmoid``), the wkv
and the per-head group norm in float32. ``u`` and ``w0`` are float32
leaves, the rest bf16; the state ``s`` is float32 and the two shifts
bf16.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple, Union

import torch

from .layers import Params, sigmoid, silu, weight

CHUNK = 32
LORA = 64
Device = Optional[Union[str, torch.device]]
MIXES = ("r", "k", "v", "g", "w", "cr", "ck")


class RwkvState(NamedTuple):
    s: torch.Tensor        # (B, H, hd, hd) wkv state, float32
    shift_t: torch.Tensor  # (B, d) previous token of the time mix, bf16
    shift_c: torch.Tensor  # (B, d) previous token of the channel mix, bf16


def init_rwkv_state(batch: int, n_heads: int, head_size: int, d: int,
                    device: Device = None) -> RwkvState:
    return RwkvState(
        s=torch.zeros((batch, n_heads, head_size, head_size),
                      dtype=torch.float32, device=device),
        shift_t=torch.zeros((batch, d), dtype=torch.bfloat16, device=device),
        shift_c=torch.zeros((batch, d), dtype=torch.bfloat16, device=device))


class Rwkv(Params):
    """The block's parameters, in the reference's layouts."""

    def __init__(self, d: int, d_ff: int, head_size: int,
                 device: Device = None):
        super().__init__()
        h = d // head_size
        for name in ("w_r", "w_k", "w_v", "w_g", "w_o", "w_cr"):
            setattr(self, name, weight((d, d), device))
        self.w_w1 = weight((d, LORA), device)
        self.w_w2 = weight((LORA, d), device)
        self.w0 = weight((d,), device, torch.float32)
        self.u = weight((h, head_size), device, torch.float32)
        self.ln_w = weight((h, head_size), device)
        self.ln_b = weight((h, head_size), device)
        self.w_ck = weight((d, d_ff), device)
        self.w_cv = weight((d_ff, d), device)
        for name in MIXES:
            setattr(self, f"mu_{name}", weight((d,), device))


def init_rwkv_params(p: Rwkv, generator: torch.Generator) -> None:
    """The reference's initialisation: Normal(0, 1/d) products (the
    low-rank ``w_w2`` 1/64), ``w0`` = -2 (a decay of about 0.87),
    ``u`` ~ Normal(0, 0.01), a zero group norm, every mix 0.5."""
    d = p.w_r.shape[0]
    with torch.no_grad():
        for name, prm in p.named_parameters():
            if name.startswith("w_"):
                std = LORA ** -0.5 if name == "w_w2" else d ** -0.5
                w = torch.randn(prm.shape, generator=generator,
                                dtype=torch.float32, device=prm.device)
                prm.copy_(w * std)
        p.w0.fill_(-2.0)
        p.u.copy_(torch.randn(p.u.shape, generator=generator,
                              dtype=torch.float32, device=p.u.device) * 0.1)
        p.ln_w.zero_()
        p.ln_b.zero_()
        for name in MIXES:
            p[f"mu_{name}"].fill_(0.5)


def _shift(x: torch.Tensor, prev: torch.Tensor):
    """Token shift: x_{t-1} with the carry. x: (B, S, d); prev: (B, d)."""
    return torch.cat([prev[:, None].to(x.dtype), x[:, :-1]], dim=1), x[:, -1]


def _mix(x, xx, mu):
    return x + (xx - x) * mu.to(x.dtype)


def _projections(p, x, xx):
    """r, k, v, g and the decay w from the mixed inputs; r, k, v, w as
    (B, S, H, hd), w float32."""
    b, s, d = x.shape
    h, hd = p["u"].shape
    r, k, v = ((_mix(x, xx, p[f"mu_{n}"]) @ p[f"w_{n}"]).reshape(b, s, h, hd)
               for n in ("r", "k", "v"))
    g = silu(_mix(x, xx, p["mu_g"]) @ p["w_g"])
    wx = torch.tanh(_mix(x, xx, p["mu_w"]) @ p["w_w1"])
    wlog = p["w0"].float() + wx.float() @ p["w_w2"].float()
    w = torch.exp(-torch.exp(wlog)).reshape(b, s, h, hd)
    return r, k, v, g, w


def _wkv_chunked(r, k, v, w, u, s0):
    """Chunkwise-parallel wkv. r, k, v, w: (B, S, H, hd), w float32;
    s0: (B, H, hd, hd). Returns (out (B, S, H, hd) float32, last state)."""
    b, s, h, hd = r.shape
    if s % CHUNK:
        raise ValueError(f"sequence {s} is not a multiple of {CHUNK}")
    n = s // CHUNK
    rf, kf, vf = (t.float().reshape(b, n, CHUNK, h, hd) for t in (r, k, v))
    wf = w.reshape(b, n, CHUNK, h, hd)
    logw = torch.log(torch.clamp(wf, min=1e-30))
    lw = torch.cumsum(logw, dim=2)                    # (B, N, L, H, hd)
    lw_prev = lw - logw                               # through t - 1
    q_in = rf * torch.exp(lw_prev)                    # decays from the start
    k_out = kf * torch.exp(-lw)                       # inverse for sources
    att = torch.einsum("bnthe,bnshe->bnhts", q_in, k_out)
    tri = torch.tril(torch.ones((CHUNK, CHUNK), dtype=torch.bool,
                                device=r.device), diagonal=-1)
    att = torch.where(tri, att, torch.zeros((), device=r.device))
    intra = torch.einsum("bnhts,bnshe->bnthe", att, vf)
    diag = torch.einsum("bthe,he,bthe->bth", rf.reshape(b, s, h, hd), u,
                        kf.reshape(b, s, h, hd)).reshape(b, n, CHUNK, h)
    intra = intra + diag[..., None] * vf

    decay_end = torch.exp(lw[:, :, -1])               # (B, N, H, hd)
    kv_chunk = torch.einsum("bnshe,bnshf->bnhef",
                            kf * torch.exp(lw[:, :, -1:] - lw), vf)
    starts = []
    state = s0
    for i in range(n):                                # the carry over chunks
        starts.append(state)
        state = decay_end[:, i, ..., None] * state + kv_chunk[:, i]
    inter = torch.einsum("bnthe,bnhef->bnthf", q_in,
                         torch.stack(starts, dim=1))
    return (intra + inter).reshape(b, s, h, hd), state


def _wkv_sequential(r, k, v, w, u, s0):
    """The recurrence one token at a time (decode, and sequences that are
    not whole chunks). Same shapes as ``_wkv_chunked``."""
    rf, kf, vf, wf = (t.float() for t in (r, k, v, w))
    state = s0
    outs = []
    for t in range(r.shape[1]):
        kv = kf[:, t, ..., None] * vf[:, t, ..., None, :]   # (B, H, hd, hd)
        outs.append(torch.einsum("bhe,bhef->bhf", rf[:, t],
                                 state + u[None, :, :, None] * kv))
        state = wf[:, t, ..., None] * state + kv
    return torch.stack(outs, dim=1), state


def time_mix(p, x: torch.Tensor, state: RwkvState, chunked: bool = True
             ) -> Tuple[torch.Tensor, RwkvState]:
    """The time-mix block. x: (B, S, d). The chunked form runs when
    ``chunked`` and S is a multiple of CHUNK, as in the reference."""
    b, s, d = x.shape
    xx, last = _shift(x, state.shift_t)
    r, k, v, g, w = _projections(p, x, xx)
    wkv = _wkv_chunked if (chunked and s % CHUNK == 0) else _wkv_sequential
    o, s_new = wkv(r, k, v, w, p["u"], state.s)
    mean = o.mean(-1, keepdim=True)                   # per-head group norm
    var = o.var(-1, keepdim=True, correction=0)
    o = (o - mean) * torch.rsqrt(var + 1e-5)
    o = o * (1 + p["ln_w"].float()) + p["ln_b"].float()
    y = (o.reshape(b, s, d) * g.float()).to(x.dtype) @ p["w_o"]
    return y, state._replace(s=s_new, shift_t=last)


def channel_mix(p, x: torch.Tensor, state: RwkvState
                ) -> Tuple[torch.Tensor, RwkvState]:
    """The channel mix: a squared-ReLU FFN with token shift."""
    xx, last = _shift(x, state.shift_c)
    rgate = sigmoid(_mix(x, xx, p["mu_cr"]) @ p["w_cr"])
    kk = torch.square(torch.relu(_mix(x, xx, p["mu_ck"]) @ p["w_ck"]))
    y = rgate * (kk @ p["w_cv"])
    return y, state._replace(shift_c=last)
