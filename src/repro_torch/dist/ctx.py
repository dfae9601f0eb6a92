"""Logical-axis sharding context.

Model code never names mesh axes. It annotates activations with LOGICAL
axes — "dp" (batch), "tp" (the tensor/sequence axis), or ``None`` — and
``constrain`` resolves them against the active :func:`sharding_ctx`:

    with sharding_ctx(mesh, dp_axes=("pod", "data"), tp_axis="model"):
        ...  # model code; constrain() redistributes DTensors

Outside a context ``constrain`` is the identity, so single-device code
runs the exact same model with no distributed machinery. A logical axis
whose mesh-axis product does not divide the tensor dim resolves to
``None`` (dropped) rather than erroring — the same divisibility contract
as :mod:`dist.sharding`. Inside a context a DTensor is redistributed to
the resolved placements (the reference's ``with_sharding_constraint``);
a plain tensor is left as it is, since it is the same full value on
every rank.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager, nullcontext
from typing import Callable, Optional, Sequence, Tuple

import torch

from .sharding import axis_sizes, mesh_axes, placements


class ShardingCtx:
    """Immutable resolution environment for logical axes."""

    __slots__ = ("mesh", "dp_axes", "tp_axis", "dispatch")

    def __init__(self, mesh, dp_axes: Tuple[str, ...], tp_axis: str,
                 dispatch: Optional[Callable] = None):
        self.mesh = mesh
        self.dp_axes = tuple(dp_axes)
        self.tp_axis = tp_axis
        self.dispatch = dispatch

    def axis_sizes(self):
        return axis_sizes(self.mesh)

    def logical_sizes(self):
        sizes = self.axis_sizes()
        dp = 1
        for a in self.dp_axes:
            dp *= sizes.get(a, 1)
        return {"dp": dp, "tp": sizes.get(self.tp_axis, 1)}


_local = threading.local()


def _stack():
    if not hasattr(_local, "stack"):
        _local.stack = []
    return _local.stack


def current() -> Optional[ShardingCtx]:
    """The innermost active context, or None."""
    stack = _stack()
    return stack[-1] if stack else None


@contextmanager
def _entered(ctx: ShardingCtx):
    _stack().append(ctx)
    try:
        with ctx.dispatch() if ctx.dispatch is not None else nullcontext():
            yield ctx
    finally:
        _stack().pop()


@contextmanager
def sharding_ctx(mesh, *, dp_axes: Optional[Sequence[str]] = None,
                 tp_axis: str = "model", dispatch: Optional[Callable] = None):
    """Activate a logical-axis resolution context for the enclosed code.
    ``dispatch``: a factory of a context manager entered with it
    (``launch.steps.jit_cell`` passes ``dist.local.ShardwiseOps``, the
    mesh's ``__torch_function__`` mode)."""
    if dp_axes is None:
        dp_axes = tuple(a for a in mesh_axes(mesh)[0] if a != tp_axis)
    with _entered(ShardingCtx(mesh, tuple(dp_axes), tp_axis,
                              dispatch)) as ctx:
        yield ctx


def remat_contexts(inner: Optional[Callable] = None):
    """A ``context_fn`` for ``torch.utils.checkpoint``: ``inner``'s
    ``(forward, recompute)`` contexts (none when None), the recompute
    also under the sharding context active now and its dispatch. The
    backward runs a recompute on its own thread, or inside a call that
    suspends the dispatch, where neither would be active otherwise."""
    fwd, rec = inner() if inner is not None else (nullcontext(),
                                                  nullcontext())
    ctx = current()
    if ctx is None:
        return fwd, rec

    @contextmanager
    def recompute():
        with _entered(ctx), rec:
            yield
    return fwd, recompute()


def resolve(ctx: ShardingCtx, shape: Tuple[int, ...],
            axes: Sequence[Optional[str]]) -> tuple:
    """Logical axes -> spec under ``ctx`` (divisibility-gated)."""
    sizes = ctx.axis_sizes()
    out: list = []
    for dim, a in zip(shape, axes):
        if a is None:
            out.append(None)
            continue
        if a == "dp":
            names: Tuple[str, ...] = ctx.dp_axes
        elif a == "tp":
            names = (ctx.tp_axis,)
        else:                      # explicit mesh axis name passes through
            names = (a,)
        if not names or any(n not in sizes for n in names):
            out.append(None)
            continue
        prod = 1
        for n in names:
            prod *= sizes[n]
        if prod and dim % prod == 0:
            out.append(names[0] if len(names) == 1 else names)
        else:
            out.append(None)       # auto-drop: dim does not divide
    return tuple(out)


def constrain(x: torch.Tensor, axes: Sequence[Optional[str]]
              ) -> torch.Tensor:
    """The reference's sharding constraint via logical axes: a DTensor
    is redistributed to the resolved placements; identity when no
    context is active (single-device paths) and for plain tensors."""
    ctx = current()
    if ctx is None:
        return x
    if len(axes) != x.dim():
        raise ValueError(f"constrain: {len(axes)} logical axes for rank-"
                         f"{x.dim()} tensor {tuple(x.shape)}")
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    spec = resolve(ctx, tuple(x.shape), axes)
    return x.redistribute(ctx.mesh, placements(spec, ctx.mesh))
