"""Shard-by-shard execution of the model's products on a mesh.

DTensor propagates the model's plain PyTorch ops by itself, one op at a
time. For the products that carry the work it is no good: the flash-
attention operator (a custom op) and the bf16 product with a float32
result (``torch.mm(..., out_dtype=)``) have no sharding rule, and for a
plain ``x @ w`` with a batch-sharded ``x`` and a weight sharded over the
data axes (ZeRO-3) its per-op choice gathers the activations and
computes the global product on every rank. So while
:class:`ShardwiseOps` is active (``launch.steps.jit_cell`` installs it)
the model's products with a weight, its embedding lookup, its attention
and decode cache update, its float32 head, the label pick of its loss
and the optimizer's gradient norm run here on every rank's shard
through ``local_map``, after their inputs are redistributed to a layout
where the product needs no communication: the batch over the data axes
(weights gathered over them), and on the model axis the weight's own
split (column- or row-parallel) or the heads (attention), each only
where it divides. Everything else, and every call on plain tensors,
goes through unchanged, so the model and optimizer modules stay plain
PyTorch. On one rank the local call is the plain call on the same
tensors, so the values are the plain path's bit for bit.
"""

from __future__ import annotations

import sys
from typing import Callable

import torch
from torch.overrides import TorchFunctionMode

from .ctx import current
from .sharding import TP_AXIS


def is_dtensor(x) -> bool:
    """``isinstance(x, DTensor)`` without importing DTensor (no module
    has made one unless ``torch.distributed.tensor`` is loaded)."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(x, mod.DTensor)


def _dp_axes(mesh):
    ctx = current()
    if ctx is not None and ctx.mesh is mesh:
        return ctx.dp_axes
    return tuple(a for a in mesh.mesh_dim_names if a != TP_AXIS)


def _as_dtensor(x: torch.Tensor, mesh) -> torch.Tensor:
    """A plain tensor (the same full value on every rank) as a
    replicated DTensor."""
    from torch.distributed.tensor import DTensor, Replicate
    if is_dtensor(x):
        return x
    return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def _layout(mesh, batch: int, tp_dim: int, tp_size_ok: Callable[[int], bool]
            ) -> list:
    """Shard(0) on the data axes when ``batch`` divides their product,
    Shard(tp_dim) on the model axis when ``tp_size_ok(size)``,
    Replicate elsewhere."""
    from torch.distributed.tensor import Replicate, Shard
    names = mesh.mesh_dim_names
    dp = _dp_axes(mesh)
    dp_prod = 1
    for a in dp:
        dp_prod *= mesh.size(names.index(a))
    out = []
    for m, a in enumerate(names):
        if a in dp and batch % dp_prod == 0:
            out.append(Shard(0))
        elif a == TP_AXIS and tp_size_ok(mesh.size(m)):
            out.append(Shard(tp_dim))
        else:
            out.append(Replicate())
    return out


def product_local(fn, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``fn(x, w)`` (a product ``x @ w`` with ``w`` of shape (K, N)) on
    each rank's shard, Megatron-style: x's batch over the data axes (w
    gathered whole over them, as ZeRO-3 gathers a weight for its use);
    on the model axis, where w's columns are split (column-parallel) x
    is whole there and the result is split the same way, and where w's
    rows are split (row-parallel) x is split along K and the result is a
    partial sum. Gradients are partial sums over the axes that split
    the other operand's contribution."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = x.device_mesh if is_dtensor(x) else w.device_mesh
    w = _as_dtensor(w, mesh)
    x_pl = _layout(mesh, x.shape[0], 0, lambda n: False)
    w_pl, out_pl, x_grad, w_grad = [], [], [], []
    for m, a in enumerate(mesh.mesh_dim_names):
        cur = w.placements[m]
        col = a == TP_AXIS and cur == Shard(w.dim() - 1)
        row = a == TP_AXIS and cur == Shard(w.dim() - 2)
        if col:
            w_pl.append(Shard(1))
            out_pl.append(Shard(x.dim() - 1))
            x_grad.append(Partial())
            w_grad.append(Shard(1))
        elif row:
            x_pl[m] = Shard(x.dim() - 1)
            w_pl.append(Shard(0))
            out_pl.append(Partial())
            x_grad.append(x_pl[m])
            w_grad.append(Shard(0))
        else:
            w_pl.append(Replicate())
            out_pl.append(x_pl[m])
            x_grad.append(x_pl[m])
            # a rank's gradient of w comes from its own rows of x
            w_grad.append(Partial() if x_pl[m] == Shard(0)
                          else Replicate())
    return local_map(fn, out_placements=out_pl,
                     in_placements=(x_pl, w_pl),
                     in_grad_placements=(x_grad, w_grad), device_mesh=mesh,
                     redistribute_inputs=True)(_as_dtensor(x, mesh), w)


def rows_local(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]`` (an embedding lookup) on each rank's shard: the ids'
    batch over the data axes, the table gathered over them and its
    columns split over the model axis where they divide; the table's
    gradient is a partial sum over the data axes. (DTensor's own rule
    for the lookup's backward fails in some PyTorch releases.)"""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = table.device_mesh
    ids_pl = _layout(mesh, ids.shape[0], 0, lambda n: False)
    tab_pl, out_pl, grad_pl = [], [], []
    for m, a in enumerate(mesh.mesh_dim_names):
        if a == TP_AXIS and table.shape[1] % mesh.size(m) == 0:
            tab_pl.append(Shard(1))
            out_pl.append(Shard(ids.dim()))
            grad_pl.append(Shard(1))
        else:
            tab_pl.append(Replicate())
            out_pl.append(ids_pl[m])
            grad_pl.append(Partial() if ids_pl[m] == Shard(0)
                           else Replicate())
    return local_map(lambda t, i: t[i], out_placements=out_pl,
                     in_placements=(tab_pl, ids_pl),
                     in_grad_placements=(grad_pl, ids_pl), device_mesh=mesh,
                     redistribute_inputs=True)(table, _as_dtensor(ids, mesh))


def attention_local(fn, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    q_offset: int = 0, **kw) -> torch.Tensor:
    """``fn(q, k, v, q_offset=, **kw)`` (attention over (B, S, H, hd)
    tensors) on each rank's shard: the batch over the data axes and, on
    the model axis, the kv heads (with their query groups) where they
    divide, else the query sequence (each rank's queries offset by its
    position, the keys and values whole: the reference's sequence-
    sharded q), else nothing."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = next(t for t in (q, k, v) if is_dtensor(t)).device_mesh
    hkv, sq = k.shape[2], q.shape[1]
    pl = _layout(mesh, q.shape[0], 2, lambda n: hkv % n == 0)
    q_pl, kv_pl = list(pl), list(pl)
    names = mesh.mesh_dim_names
    tp = names.index(TP_AXIS) if TP_AXIS in names else None
    n_tp = mesh.size(tp) if tp is not None else 1
    seq_split = (n_tp > 1 and hkv % n_tp != 0 and sq % n_tp == 0)
    kv_grad = list(kv_pl)
    if seq_split:
        # whole keys and values; a rank's gradient of them comes from
        # its own queries: a partial sum over the model axis
        q_pl[tp], kv_pl[tp], kv_grad[tp] = Shard(1), Replicate(), Partial()

    def local(a, b, c):
        off = q_offset
        if seq_split:
            off += mesh.get_local_rank(TP_AXIS) * (sq // n_tp)
        return fn(a, b, c, q_offset=off, **kw)

    return local_map(local, out_placements=q_pl,
                     in_placements=(q_pl, kv_pl, kv_pl),
                     in_grad_placements=(q_pl, kv_grad, kv_grad),
                     device_mesh=mesh, redistribute_inputs=True)(
        *(_as_dtensor(t, mesh) for t in (q, k, v)))


def decode_local(fn, q, k, v, k_cache, v_cache, positions
                 ) -> torch.Tensor:
    """``fn(q, k, v, k_cache, v_cache, positions)`` (one decode step of a
    layer, writing the new key and value into the caches in place) on
    each rank's shard, in the caches' own layout (``cache_specs``: the
    batch over the data axes, the kv heads over the model axis), so
    the in-place writes land in the caches' storage."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = k_cache.device_mesh
    hkv = k_cache.shape[2]
    pl = _layout(mesh, q.shape[0], 2, lambda n: hkv % n == 0)
    if list(k_cache.placements) != pl or list(v_cache.placements) != pl:
        raise ValueError(f"decode: cache placements {k_cache.placements} "
                         f"are not the layout {pl} (place the cache by "
                         "dist.sharding.cache_specs)")
    pos_pl = [p if p == Shard(0) else Replicate() for p in pl]
    return local_map(fn, out_placements=pl,
                     in_placements=(pl,) * 5 + (pos_pl,), device_mesh=mesh,
                     redistribute_inputs=True)(
        *(_as_dtensor(t, mesh) for t in (q, k, v, k_cache, v_cache,
                                         positions)))


def _reshape_splittable(t: torch.Tensor, shape) -> torch.Tensor:
    """``t`` ready for ``t.reshape(shape)``: a dim that the reshape
    splits into (outer, ...), sharded over mesh axes whose product does
    not divide ``outer``, is gathered first (DTensor cannot split such a
    dim; the reference's partitioner reshards there by itself)."""
    from torch.distributed.tensor import Replicate
    if len(shape) == 1 and isinstance(shape[0], (tuple, list, torch.Size)):
        shape = tuple(shape[0])
    if not all(isinstance(n, int) for n in shape):
        return t                         # a view as another dtype
    old = tuple(t.shape)
    if -1 in shape:
        known = 1
        for n in shape:
            known *= n if n != -1 else 1
        shape = tuple(t.numel() // known if n == -1 else n for n in shape)
    pl = list(t.placements)
    for d in {p.dim % t.dim() for p in pl if p.is_shard()}:
        before, acc, j = 1, 1, 0
        for n in old[:d]:
            before *= n
        while j < len(shape) and acc < before:
            acc *= shape[j]
            j += 1
        if acc != before or j >= len(shape) or shape[j] == old[d]:
            continue                     # the dim is kept or merged
        on = [m for m, p in enumerate(pl) if p.is_shard(d)]
        prod = 1
        for m in on:
            prod *= t.device_mesh.size(m)
        if shape[j] % prod:
            for m in on:
                pl[m] = Replicate()
    if pl == list(t.placements):
        return t
    return t.redistribute(t.device_mesh, pl)


def _pick(func, inp, dim, index, **kw):
    """``torch.gather(inp, dim, index)`` of one element along a dim that
    ``inp`` shards: a column mask and a sum (exact: the other terms are
    zeros), which needs only a sum over the shards."""
    dim = dim % inp.dim()
    if kw or index.shape[dim] != 1 or not any(
            p.is_shard(dim) for p in inp.placements):
        return func(inp, dim, index, **kw)
    shape = [1] * inp.dim()
    shape[dim] = inp.shape[dim]
    cols = torch.arange(inp.shape[dim], device=inp.device).reshape(shape)
    return torch.where(cols == index, inp, 0.0).sum(dim, keepdim=True)


def _global_norm(tensors) -> torch.Tensor:
    """``optim.adamw.global_norm`` over DTensor gradients: each rank sums
    its own shards' squares (the plain tree order), a leaf replicated on
    a mesh dim counted by that dim's first rank only, one all-reduce of
    the per-leaf sums over the mesh, then the plain path's sum over the
    leaves and its square root. On one rank: the plain bits."""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    from ..optim.adamw import global_norm, sqrt_rn, tree_sum
    mesh = next((x.device_mesh for x in tensors if is_dtensor(x)), None)
    if mesh is None:
        return global_norm(tensors)
    coord = mesh.get_coordinate()
    parts = []
    for x in tensors:
        if not is_dtensor(x):
            x = _as_dtensor(x, mesh)
        if any(p.is_partial() for p in x.placements):
            x = x.redistribute(mesh, [Replicate() if p.is_partial() else p
                                      for p in x.placements])
        s = tree_sum(torch.square(x.to_local().to(torch.float32))
                     .reshape(-1))
        if any(not p.is_shard() and c for p, c in zip(x.placements, coord)):
            s = torch.zeros_like(s)
        parts.append(s)
    sums = DTensor.from_local(torch.stack(parts), mesh,
                              [Partial()] * mesh.ndim,
                              run_check=False).full_tensor()
    total = sums[0]
    for s in sums[1:]:
        total = total + s
    return sqrt_rn(total)


def _handlers() -> dict:
    """func -> handler(func, *args, **kwargs), for :class:`ShardwiseOps`."""
    global _HANDLERS
    if _HANDLERS is None:
        from ..models.attention import flash_attention
        from ..models.lm import decode_attend, f32_product
        from ..optim.adamw import global_norm

        def matmul(func, x, w, **kw):
            if not kw and w.dim() == 2 and (is_dtensor(x) or is_dtensor(w)):
                return product_local(torch.matmul, x, w)
            return func(x, w, **kw)

        def f32(func, x, w):
            if is_dtensor(x) or is_dtensor(w):
                return product_local(f32_product, x, w)
            return func(x, w)

        def lookup(func, table, idx):
            if (is_dtensor(table) and table.dim() == 2
                    and isinstance(idx, torch.Tensor)
                    and not idx.is_floating_point()
                    and idx.dtype != torch.bool):
                return rows_local(table, idx)
            return func(table, idx)

        def reshape(func, t, *shape):
            if is_dtensor(t):
                t = _reshape_splittable(t, shape)
            return func(t, *shape)

        def gather(func, inp, dim, index, **kw):
            if is_dtensor(inp):
                return _pick(func, inp, dim, index, **kw)
            return func(inp, dim, index, **kw)

        def attention(func, q, k, v, **kw):
            if any(is_dtensor(t) for t in (q, k, v)):
                return attention_local(func, q, k, v, **kw)
            return func(q, k, v, **kw)

        def decode(func, q, k, v, kc, vc, positions):
            if is_dtensor(kc):
                return decode_local(func, q, k, v, kc, vc, positions)
            return func(q, k, v, kc, vc, positions)

        def norm(func, tensors):
            return _global_norm(tensors)

        _HANDLERS = {
            torch.matmul: matmul, torch.Tensor.matmul: matmul,
            torch.Tensor.__matmul__: matmul, f32_product: f32,
            torch.Tensor.__getitem__: lookup,
            torch.Tensor.reshape: reshape, torch.Tensor.view: reshape,
            torch.gather: gather, torch.Tensor.gather: gather,
            flash_attention: attention, decode_attend: decode,
            global_norm: norm}
    return _HANDLERS


_HANDLERS = None


class ShardwiseOps(TorchFunctionMode):
    """The mesh's dispatch: while active, the calls :func:`_handlers`
    names run shard by shard when they meet a DTensor (see the module's
    docstring); every other call, and every call on plain tensors, runs
    as it is. A handler runs with the mode suspended, so the local calls
    inside it are the plain ones."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        handler = _handlers().get(func)
        if handler is None:
            return func(*args, **(kwargs or {}))
        return handler(func, *args, **(kwargs or {}))
