"""Dry run: each (arch x shape) cell's step on the production mesh,
shapes only, with what every device would compute and exchange.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3.2-3b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod] [--strategy fsdp]

Outputs one JSON per cell under ``results/dryrun_torch/``.

PyTorch has no compiler to ask, so the cell's step (``launch.steps.
jit_cell``) runs once, eagerly, on ``meta`` tensors: the parameters,
optimizer state, batch and cache are DTensors placed by the spec rules
on the production mesh ((16, 16), or (2, 16, 16) with ``--multi-pod``)
over a fake process group of 256 (512) ranks in this one process, whose
collectives move nothing. A dispatch mode under DTensor sees each
device's own ops on its local shards and counts:

* ``flops_hlo_once``: the flops of every op (the formulas of
  ``torch.utils.flop_counter``, which, run as a mode over the whole
  step, would see DTensor ops at their global shapes);
* ``bytes_hlo_once``: every op's operand and result bytes (views
  excluded): the unfused traffic of eager PyTorch, an upper bound on
  what a fused step moves;
* ``collective_bytes_once`` / ``collective_counts``: each collective's
  result bytes and count, by kind.

The step executes every layer and every attention tile, so the counts
are the whole step's ("once" keeps the reference's key names; no loop
body is counted once). ``memory.argument_size_in_bytes`` is the local
shards' bytes of the step's inputs on one device. Keys with no
counterpart here are ``null``: ``compile_s`` and the XLA memory
analysis' output, temp and generated-code sizes, and the count of f32
collectives it adjusts. ``lower_s`` is the seconds of the eager run.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback
from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ..configs import SHAPES, all_cells, cell_enabled, get_config
from ..models.lm import RunFlags
from .mesh import make_production_mesh
from .specs import input_specs
from .steps import jit_cell

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "results", "dryrun_torch")

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")
# op name fragments of the c10d and functional collectives, by kind
_KIND_OF = (("all_gather", "all-gather"), ("allgather", "all-gather"),
            ("reduce_scatter", "reduce-scatter"),
            ("all_reduce", "all-reduce"), ("allreduce", "all-reduce"),
            ("all_to_all", "all-to-all"), ("alltoall", "all-to-all"))


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(tree))


class CostMode(TorchDispatchMode):
    """Counts, per device, the flops, operand and result bytes and
    collectives of the ops it sees. A DTensor op is handed on to DTensor
    (``NotImplemented``), which runs it as local ops on the shards and
    collectives; those come back through this mode and are counted."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self.registry = flop_registry
        self.flops = 0
        self.bytes = 0
        self.coll_bytes: Dict[str, int] = {k: 0 for k in _COLLECTIVES}
        self.coll_counts: Dict[str, int] = {k: 0 for k in _COLLECTIVES}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        ns = func.namespace
        if "c10d" in ns:
            name = func._overloadpacket.__name__
            kind = next((k for frag, k in _KIND_OF if frag in name), None)
            if kind is not None:
                self.coll_counts[kind] += 1
                self.coll_bytes[kind] += _nbytes(out)
            return out
        packet = func._overloadpacket
        if packet in self.registry:
            self.flops += int(self.registry[packet](*args, **kwargs,
                                                    out_val=out))
        if not func.is_view:
            self.bytes += _nbytes(args) + _nbytes(kwargs) + _nbytes(out)
        return out


def _local_bytes(tree, specs, mesh) -> int:
    """Bytes of one device's shards of ``tree``'s leaves, each split
    over the mesh axes its spec (the matching leaf of ``specs``) names."""
    from ..dist.sharding import axis_sizes
    sizes = axis_sizes(mesh)
    if isinstance(tree, torch.Tensor):
        n = tree.numel()
        for entry in specs:
            for a in (entry if isinstance(entry, tuple) else (entry,)):
                n //= sizes[a] if a is not None else 1
        return n * tree.element_size()
    if isinstance(tree, dict):
        return sum(_local_bytes(v, specs[k], mesh) for k, v in tree.items())
    return sum(_local_bytes(v, sp, mesh) for v, sp in zip(tree, specs))


def argument_bytes(mesh, specs, strategy: str) -> int:
    """One device's bytes of the cell's inputs, placed as ``jit_cell``
    places them."""
    from ..dist import sharding as shd
    kind = specs["kind"]
    if kind == "decode" and strategy == "fsdp":
        strategy = "tp_serve"
    params = {n: p for n, p in specs["params"].named_parameters()}
    pspec = shd.param_specs(params, mesh, strategy)
    total = _local_bytes(params, pspec, mesh)
    if kind == "train":
        opt = specs["opt_state"]
        ospec = shd.opt_specs(opt, pspec, mesh)
        total += sum(_local_bytes(getattr(opt, f), getattr(ospec, f), mesh)
                     for f in ("master", "m", "v"))
    for key, rule in (("batch", shd.batch_specs), ("cache", shd.cache_specs),
                      ("token", shd.batch_specs), ("pos", shd.batch_specs)):
        if key in specs:
            total += _local_bytes(specs[key], rule(specs[key], mesh), mesh)
    return total


def init_fake_group(world: int) -> None:
    """A fake process group of ``world`` ranks in this process (this
    process is rank 0); collectives on it move nothing."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_world_size() != world:
            raise RuntimeError(f"a process group of "
                               f"{dist.get_world_size()} ranks is already "
                               f"initialised; the cell needs {world}")
        return
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def count_cell(mesh, specs, strategy: str = "fsdp",
               flags: RunFlags = RunFlags(remat="full")) -> dict:
    """Run one cell's step (``jit_cell``) once on ``mesh`` under
    :class:`CostMode`; returns the counts and the seconds."""
    if specs["kind"] == "train":
        specs["params"].requires_grad_()
    arg_bytes = argument_bytes(mesh, specs, strategy)
    fn, args = jit_cell(mesh, specs, strategy=strategy, flags=flags)
    t0 = time.time()
    mode = CostMode()
    with mode:
        out = fn(*args)
    seconds = time.time() - t0
    del out
    return {"flops": float(mode.flops), "bytes": float(mode.bytes),
            "collective_bytes": dict(mode.coll_bytes),
            "collective_counts": dict(mode.coll_counts),
            "argument_bytes": arg_bytes, "seconds": seconds}


def run_cell(arch: str, shape_name: str, multi_pod: bool, strategy: str,
             save: bool = True, remat: str = "full") -> dict:
    shape = SHAPES[shape_name]
    cfg = get_config(arch)
    on, why = cell_enabled(cfg, shape)
    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    result = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
              "strategy": strategy, "enabled": on, "skip_reason": why}
    if not on:
        return result
    n_dev = 512 if multi_pod else 256
    init_fake_group(n_dev)
    mesh = make_production_mesh(multi_pod=multi_pod)
    c = count_cell(mesh, input_specs(arch, shape), strategy,
                   RunFlags(remat=remat))
    result.update({
        "ok": True,
        "lower_s": round(c["seconds"], 1), "compile_s": None,
        "flops_hlo_once": c["flops"],
        "bytes_hlo_once": c["bytes"],
        "memory": {"argument_size_in_bytes": c["argument_bytes"],
                   "output_size_in_bytes": None,
                   "temp_size_in_bytes": None,
                   "generated_code_size_in_bytes": None},
        "collective_bytes_once": c["collective_bytes"],
        "collective_counts": {**c["collective_counts"],
                              "f32_convert_adjusted": None},
        "n_devices": n_dev,
        "param_count": cfg.param_count(),
        "param_count_active": cfg.param_count(active_only=True),
    })
    if save:
        os.makedirs(RESULTS_DIR, exist_ok=True)
        fname = f"{arch}_{shape_name}_{mesh_name}_{strategy}.json"
        with open(os.path.join(RESULTS_DIR, fname), "w") as f:
            json.dump(result, f, indent=1)
    return result


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--strategy", default="fsdp", choices=["fsdp", "2d"])
    ap.add_argument("--remat", default="full", choices=["full", "none"])
    args = ap.parse_args(argv)

    cells = []
    if args.all:
        for arch, shape, on, _ in all_cells():
            cells.append((arch, shape.name))
    else:
        if not (args.arch and args.shape):
            ap.error("need --arch and --shape (or --all)")
        cells = [(args.arch, args.shape)]

    failures = 0
    for arch, shape_name in cells:
        try:
            r = run_cell(arch, shape_name, args.multi_pod, args.strategy,
                         remat=args.remat)
            if not r.get("enabled", True):
                print(f"SKIP {arch} {shape_name}: {r['skip_reason']}")
            else:
                print(f"OK   {arch} {shape_name} [{r['mesh']}] "
                      f"run={r['lower_s']}s "
                      f"flops={r['flops_hlo_once']:.3g} "
                      f"coll={sum(r['collective_bytes_once'].values()):.3g}B",
                      flush=True)
        except Exception as e:   # report the cell and go on to the next
            failures += 1
            traceback.print_exc()
            print(f"FAIL {arch} {shape_name}: {type(e).__name__}: {e}",
                  flush=True)
    sys.exit(1 if failures else 0)


if __name__ == "__main__":
    main()
