"""Divisibility-aware sharding rules for every runtime state of the port.

One rule set drives training, serving, the dry run and elastic resume:

    param_specs(model, mesh, strategy)   -> {name: spec}
    opt_specs(opt_state, pspec, mesh)    -> ZeRO-3 optimizer specs
    batch_specs(batch, mesh)             -> dp-sharded input batches
    cache_specs(cache, mesh)             -> decode cache specs
    to_named(specs, mesh)                -> DTensor placements

A spec is a FULL-RANK tuple, one entry per tensor dim: ``None``, a mesh
axis name, or a tuple of axis names (the dim split over their product,
the first axis major). It is the content of the reference's
``PartitionSpec``, so the two compare entry by entry.

The reference stacks each layer group's parameters on a leading axis
that is never sharded; the port's parameters are per layer
(``layers.<i>.*``), so a port spec is the reference's spec of that
stacked leaf without its first entry, and the divisibility choices are
the same. Caches keep the reference's stacked layout, and their rules
are the reference's.

An axis is sharded only when its size divides the mesh-axis product, so
a resume on a smaller or larger mesh recomputes the rules and the
non-dividing shardings drop out instead of erroring. The rules read only
a mesh's axis names and shape (``axis_names`` and ``devices.shape``, or
a ``DeviceMesh``'s ``mesh_dim_names`` and ``shape``), so they plan on
duck-typed meshes with no devices; only :func:`to_named` placements and
:func:`place` / :func:`ring_put` need a real ``DeviceMesh``.

Strategies:

* ``fsdp`` (default, alias ``2d``): weights sharded over the data axes on
  their largest dividing dim (ZeRO-3) plus tensor parallelism over the
  "model" axis on the minor dim;
* ``tp`` / ``tp_serve``: "model"-axis sharding only (inference keeps
  weights resident per TP shard);
* ``replicated``: everything replicated.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Sequence, Tuple

import torch

TP_AXIS = "model"

_STRATEGIES = ("fsdp", "2d", "tp", "tp_serve", "replicated")

Spec = Tuple[Any, ...]


# ---------------------------------------------------------------------------
# mesh introspection (duck-typed)
# ---------------------------------------------------------------------------

def mesh_axes(mesh) -> Tuple[Tuple[str, ...], Tuple[int, ...]]:
    """(axis names, axis sizes) of a fake mesh (``axis_names``,
    ``devices.shape``) or a ``DeviceMesh`` (``mesh_dim_names``,
    ``shape``)."""
    if hasattr(mesh, "axis_names"):
        return tuple(mesh.axis_names), tuple(mesh.devices.shape)
    return tuple(mesh.mesh_dim_names), tuple(mesh.shape)


def axis_sizes(mesh) -> Dict[str, int]:
    return dict(zip(*mesh_axes(mesh)))


def dp_axes_of(mesh) -> Tuple[str, ...]:
    """Every mesh axis except the tensor-parallel one ("pod", "data", ...)."""
    return tuple(a for a in mesh_axes(mesh)[0] if a != TP_AXIS)


def _prod(sizes: Dict[str, int], axes: Sequence[str]) -> int:
    out = 1
    for a in axes:
        out *= sizes[a]
    return out


def _dp_entry(dp: Tuple[str, ...]):
    """Spec entry of the (possibly multi-axis) data dimension."""
    return dp[0] if len(dp) == 1 else dp


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _map(tree, fn, path: Tuple = ()):
    """``tree`` (dicts, lists, tuples, NamedTuples of tensors) with each
    leaf replaced by ``fn(path, leaf)``; a NamedTuple field's key is its
    ``.name``."""
    if isinstance(tree, Mapping):
        return {k: _map(v, fn, path + (k,)) for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*(_map(v, fn, path + (f".{n}",))
                            for n, v in zip(tree._fields, tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(v, fn, path + (i,))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def _named(params) -> Dict[str, Any]:
    """``{name: tensor}`` of a module (its parameters) or a mapping."""
    if isinstance(params, torch.nn.Module):
        return dict(params.named_parameters())
    return dict(params)


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

def _leaf_spec(shape: Tuple[int, ...], strategy: str, dp: Tuple[str, ...],
               dp_prod: int, tp_size: int, has_tp: bool) -> Spec:
    """The reference's ``_leaf_spec`` of a leaf without a stack dim."""
    nd = len(shape)
    spec: list = [None] * nd
    if strategy == "replicated" or nd < 2:
        return tuple(spec)             # scalars/vectors/norms replicate
    tp_dim = None
    if has_tp and strategy in ("fsdp", "2d", "tp", "tp_serve"):
        for i in (nd - 1, nd - 2):     # prefer the minor (output) dim
            if shape[i] % tp_size == 0:
                tp_dim = i
                spec[i] = TP_AXIS
                break
    if dp and strategy in ("fsdp", "2d"):
        cands = [i for i in range(nd)
                 if i != tp_dim and shape[i] % dp_prod == 0]
        if cands:
            j = max(cands, key=lambda i: shape[i])
            spec[j] = _dp_entry(dp)
    return tuple(spec)


def param_specs(params, mesh, strategy: str = "fsdp") -> Dict[str, Spec]:
    """``{name: spec}`` of a model's named parameters (a ``CausalLM`` or
    a ``{name: tensor}`` mapping, on any device, ``meta`` included)."""
    if strategy not in _STRATEGIES:
        raise ValueError(f"unknown strategy {strategy!r}; "
                         f"expected one of {_STRATEGIES}")
    sizes = axis_sizes(mesh)
    dp = dp_axes_of(mesh)
    dp_prod = _prod(sizes, dp)
    tp_size = sizes.get(TP_AXIS, 1)
    has_tp = TP_AXIS in sizes
    return {name: _leaf_spec(tuple(p.shape), strategy, dp, dp_prod,
                             tp_size, has_tp)
            for name, p in _named(params).items()}


def opt_specs(opt_state, pspec: Dict[str, Spec], mesh):
    """ZeRO-3 optimizer specs: master/m/v follow the parameter specs
    exactly (``optim.adamw`` keeps them parameter-shaped), the step
    replicates. Any other state replicates every leaf."""
    from ..optim.adamw import OptState
    if isinstance(opt_state, OptState):
        return OptState(step=(), master=dict(pspec), m=dict(pspec),
                        v=dict(pspec))
    return _map(opt_state, lambda _, x: (None,) * x.dim())


# ---------------------------------------------------------------------------
# batches, lanes and caches
# ---------------------------------------------------------------------------

def batch_specs(batch, mesh):
    """Inputs shard their leading (global-batch) dim over the data axes."""
    sizes = axis_sizes(mesh)
    dp = dp_axes_of(mesh)
    dp_prod = _prod(sizes, dp)

    def leaf(_, x) -> Spec:
        shape = tuple(x.shape)
        spec: list = [None] * len(shape)
        if shape and dp and shape[0] % dp_prod == 0:
            spec[0] = _dp_entry(dp)
        return tuple(spec)

    return _map(batch, leaf)


def lane_specs(tree, mesh, axis: str = "lanes"):
    """Stacked-lane states (the sweep's carries): every leaf's leading
    dim is the lane axis and shards over ``axis`` when the lane count
    divides (otherwise it replicates)."""
    size = axis_sizes(mesh).get(axis, 1)

    def leaf(_, x) -> Spec:
        shape = tuple(x.shape)
        spec: list = [None] * len(shape)
        if shape and size > 1 and shape[0] % size == 0:
            spec[0] = axis
        return tuple(spec)

    return _map(tree, leaf)


def ring_specs(tree, mesh, axis: str = "lanes"):
    """Ring-staged request slabs (the streaming engine's ``(chunk, W)``
    buffers): the lane axis is the LAST dim and shards over ``axis``
    when it divides; leading dims (time, ring depth) never shard."""
    size = axis_sizes(mesh).get(axis, 1)

    def leaf(_, x) -> Spec:
        shape = tuple(x.shape)
        spec: list = [None] * len(shape)
        if shape and size > 1 and shape[-1] % size == 0:
            spec[-1] = axis
        return tuple(spec)

    return _map(tree, leaf)


def occupancy_specs(tree, mesh, axis: str = "lanes"):
    """Per-lane occupancy and admission vectors (``(W,)`` reset masks):
    rank-1 leaves shard their only dim over ``axis``; anything else
    replicates."""
    size = axis_sizes(mesh).get(axis, 1)

    def leaf(_, x) -> Spec:
        shape = tuple(x.shape)
        spec: list = [None] * len(shape)
        if len(shape) == 1 and size > 1 and shape[0] % size == 0:
            spec[0] = axis
        return tuple(spec)

    return _map(tree, leaf)


def cache_specs(cache, mesh):
    """Decode caches (``models.lm.init_cache``'s layout): leaves are
    (layer_stack, batch, ...); batch shards over the data axes and the
    K/V head dim over "model" (TP serving keeps each head's entries
    resident on its shard). A recurrent state's fields are not K/V."""
    sizes = axis_sizes(mesh)
    dp = dp_axes_of(mesh)
    dp_prod = _prod(sizes, dp)
    tp_size = sizes.get(TP_AXIS, 1)
    has_tp = TP_AXIS in sizes

    def leaf(path, x) -> Spec:
        shape = tuple(x.shape)
        nd = len(shape)
        spec: list = [None] * nd
        if nd >= 2 and dp and shape[1] % dp_prod == 0:
            spec[1] = _dp_entry(dp)
        is_kv = bool(path) and path[-1] in ("k", "v")
        # (stack, B, S, H, hd): shard the kv-head dim
        if is_kv and nd >= 4 and has_tp and shape[nd - 2] % tp_size == 0:
            spec[nd - 2] = TP_AXIS
        return tuple(spec)

    return _map(cache, leaf)


def spec_names_axis(spec: Spec) -> bool:
    """Whether a spec shards any dim over a mesh axis."""
    return any(e is not None for e in spec)


# ---------------------------------------------------------------------------
# materialisation on a DeviceMesh
# ---------------------------------------------------------------------------

def _is_spec(x) -> bool:
    return isinstance(x, tuple) and not _is_namedtuple(x) and all(
        e is None or isinstance(e, str) or (
            isinstance(e, tuple) and all(isinstance(a, str) for a in e))
        for e in x)


def placements(spec: Spec, mesh) -> list:
    """One DTensor placement per mesh dim for ``spec``: ``Shard(d)`` on
    each mesh axis that tensor dim ``d`` names (a multi-axis entry
    shards on each of its axes, the first one major, as the mesh's own
    order nests them), ``Replicate()`` on every other."""
    from torch.distributed.tensor import Replicate, Shard
    names = mesh_axes(mesh)[0]
    out: list = [Replicate() for _ in names]
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        for a in (entry if isinstance(entry, tuple) else (entry,)):
            if a not in names:
                raise ValueError(f"spec {spec} names axis {a!r}, not on "
                                 f"the mesh {names}")
            out[names.index(a)] = Shard(d)
    return out


def to_named(specs, mesh):
    """Map a spec tree to DTensor placement lists on a REAL mesh (one
    list per leaf, :func:`placements`)."""
    if _is_spec(specs):
        return placements(specs, mesh)
    if isinstance(specs, Mapping):
        return {k: to_named(v, mesh) for k, v in specs.items()}
    if _is_namedtuple(specs):
        return type(specs)(*(to_named(v, mesh) for v in specs))
    return type(specs)(to_named(v, mesh) for v in specs)


def place(x: torch.Tensor, mesh, pl) -> torch.Tensor:
    """``x`` as a DTensor with placements ``pl`` on ``mesh``, taking
    each rank's shard of the full value every rank holds (no
    communication; ``meta`` tensors stay on ``meta``). A DTensor is
    redistributed instead."""
    from torch.distributed.tensor import DTensor, distribute_tensor
    if isinstance(x, DTensor):
        if x.device_mesh == mesh and list(x.placements) == list(pl):
            return x
        return x.redistribute(mesh, pl)
    return distribute_tensor(x, mesh, pl, src_data_rank=None)


def place_tree(tree, named, mesh):
    """Every leaf of ``tree`` placed per the matching leaf of
    ``named`` (:func:`to_named`'s output)."""
    if isinstance(tree, Mapping):
        return {k: place_tree(v, named[k], mesh) for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*(place_tree(v, p, mesh)
                            for v, p in zip(tree, named)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(place_tree(v, p, mesh) for v, p in zip(tree,
                                                                 named))
    return place(tree, mesh, named)


def ring_put(tree, mesh, axis: str = "lanes"):
    """Stage host slab buffers onto the mesh pre-sharded per
    :func:`ring_specs` (lane axis LAST, time replicated): each rank
    keeps only its own lanes. Values are unchanged."""
    return place_tree(tree, to_named(ring_specs(tree, mesh, axis), mesh),
                      mesh)
