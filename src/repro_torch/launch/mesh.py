"""Meshes: the production shapes and the smoke mesh, as ``DeviceMesh``.

Functions, not module constants: importing this module starts no
process group. Single pod: (16, 16) = ("data", "model"); multi-pod:
(2, 16, 16) = ("pod", "data", "model"). Tensor parallelism stays inside
the 16-wide "model" axis; only data-parallel traffic crosses a pod.
Both need a process group of 256 or 512 ranks already initialised: on
one machine that is a fake group (``launch.dryrun``). The smoke mesh is
``(world, 1)`` over whatever group is initialised (one rank on one card).
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..dist.sharding import mesh_axes


def _mesh(device_type: str, shape: Tuple[int, ...],
          axes: Tuple[str, ...]):
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    if not dist.is_initialized():
        raise RuntimeError("no process group: call torch.distributed."
                           "init_process_group first")
    n = 1
    for s in shape:
        n *= s
    if dist.get_world_size() != n:
        raise ValueError(f"a {shape} mesh needs {n} ranks, the process "
                         f"group has {dist.get_world_size()}")
    return DeviceMesh(device_type, torch.arange(n).reshape(shape),
                      mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cpu"):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(device_type, shape, axes)


def dp_axes_of(mesh) -> Tuple[str, ...]:
    return tuple(a for a in mesh_axes(mesh)[0] if a in ("pod", "data"))


def make_smoke_mesh(device=None):
    """(world, 1) over ("data", "model") on ``device``'s type (None: the
    card)."""
    import torch.distributed as dist
    from ..kernels.backend import resolve_device
    dev = resolve_device(device)
    if not dist.is_initialized():
        raise RuntimeError("no process group: call torch.distributed."
                           "init_process_group first")
    return _mesh(dev.type, (dist.get_world_size(), 1), ("data", "model"))
