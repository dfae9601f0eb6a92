"""Elastic re-scaling: resume a checkpoint on a DIFFERENT mesh.

Checkpoints store full logical tensors (the manifest records the source
mesh for audit). Re-scaling is therefore: recompute the sharding rules
for the surviving mesh and place — the divisibility-aware rules
(:mod:`dist.sharding`) adapt to any axis sizes, so a resume onto any
divisor mesh (or a larger one) works. ``plan_remesh`` validates the
target before committing.

``leaves_sharded`` counts the leaves whose spec names a mesh axis. (The
reference counts the keys of its spec tree taken as one leaf, so it
reports 1 for any dict of parameters.)
"""

from __future__ import annotations

from typing import Tuple

from ..dist import sharding as shd


def plan_remesh(params, old_mesh_shape: Tuple[int, ...], new_mesh) -> dict:
    """Feasibility report for resuming ``params`` (a model or a ``{name:
    tensor}`` mapping, ``meta`` included) on ``new_mesh`` (a
    ``DeviceMesh`` or a duck-typed mesh)."""
    specs = shd.param_specs(params, new_mesh)
    shape = shd.mesh_axes(new_mesh)[1]
    n = 1
    for s in shape:
        n *= s
    return {
        "old_mesh": list(old_mesh_shape),
        "new_mesh": list(shape),
        "n_devices": n,
        "leaves": len(specs),
        "leaves_sharded": sum(1 for s in specs.values()
                              if shd.spec_names_axis(s)),
    }


def reshard_state(state, new_mesh, strategy: str = "fsdp"):
    """Placements for ``state`` (``{name: tensor}`` parameters) on
    ``new_mesh`` by the parameter rules: ``(new_mesh, placements)``,
    the form ``CheckpointManager.restore(shardings=)`` takes."""
    return new_mesh, shd.to_named(shd.param_specs(state, new_mesh,
                                                  strategy), new_mesh)
