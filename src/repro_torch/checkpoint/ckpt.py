"""Checkpointing: atomic manifest + per-leaf arrays + async writer.

Layout:  <dir>/step_<N>/manifest.json  +  arrays.npz  (leaf path -> array),
the reference's. A state is a tensor or any nesting of dicts, lists,
tuples and NamedTuples of tensors (the training driver's ``(params,
OptState)``); a leaf's path joins its keys with ``/`` as the reference
names them (dict keys, sequence indices, ``.field`` for a NamedTuple).
bf16 leaves are stored as float32 (a lossless upcast: npz has no bf16)
and cast back to the template's dtype and device on restore.

Writes go to ``.tmp_step_<N>`` then rename (atomic at the step
granularity), so a crash mid-write never corrupts the latest checkpoint;
``restore`` loads the newest complete step. ``save_async`` copies the
state to the host on the caller's thread (the training step may then
overwrite its tensors in place) and writes it on a daemon thread.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _map(tree, fn, prefix: Tuple[str, ...] = ()):
    """``tree`` with every leaf replaced by ``fn(path, leaf)``."""
    if isinstance(tree, dict):
        return {k: _map(v, fn, prefix + (str(k),)) for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*(_map(v, fn, prefix + (f".{n}",))
                            for n, v in zip(tree._fields, tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(v, fn, prefix + (str(i),))
                          for i, v in enumerate(tree))
    return fn("/".join(prefix), tree)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:          # npz has no native bf16
        t = t.to(torch.float32)            # lossless upcast
    return t.numpy()


def _flatten(tree) -> Dict[str, np.ndarray]:
    """{leaf path: the leaf as numpy} (bf16 upcast)."""
    flat: Dict[str, np.ndarray] = {}

    def put(key, leaf):
        flat[key] = _to_numpy(leaf)
    _map(tree, put)
    return flat


def _unflatten(tree_like, flat: Dict[str, np.ndarray]):
    def restore(key, ref):
        arr = flat[key]
        if tuple(arr.shape) != tuple(ref.shape):
            raise ValueError(f"{key}: checkpoint shape {arr.shape}, the "
                             f"template's {tuple(ref.shape)}")
        return torch.from_numpy(np.array(arr)).to(dtype=ref.dtype,
                                                  device=ref.device)
    return _map(tree_like, restore)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None

    # -- write ---------------------------------------------------------------

    def save(self, step: int, state: Any, meta: Optional[dict] = None):
        tmp = os.path.join(self.dir, f".tmp_step_{step}")
        final = os.path.join(self.dir, f"step_{step}")
        os.makedirs(tmp, exist_ok=True)
        flat = _flatten(state)
        np.savez(os.path.join(tmp, "arrays.npz"), **flat)
        manifest = {"step": step, "time": time.time(),
                    "leaves": len(flat), **(meta or {})}
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)          # atomic publish
        self._gc()

    def save_async(self, step: int, state: Any, meta: Optional[dict] = None):
        self.wait()
        # snapshot on the host now: the caller goes on updating in place
        state = _map(state, lambda _, t: t.detach().to("cpu", copy=True))
        self._thread = threading.Thread(
            target=self.save, args=(step, state, meta), daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self):
        steps = sorted(self.steps())
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s}"),
                          ignore_errors=True)

    # -- read ----------------------------------------------------------------

    def steps(self):
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and os.path.exists(
                    os.path.join(self.dir, name, "manifest.json")):
                out.append(int(name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def restore(self, tree_like: Any, step: Optional[int] = None,
                shardings=None) -> Tuple[int, Any]:
        """(step, a new state shaped, typed and placed as ``tree_like``)
        from ``step`` (default: the latest complete one). ``shardings``
        (elastic resume): a ``(mesh, placements)`` pair, the placements
        a tree matching the state's (``dist.sharding.to_named``, e.g.
        ``checkpoint.elastic.reshard_state``); each restored leaf is
        then a DTensor so placed on that mesh."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.dir}")
        path = os.path.join(self.dir, f"step_{step}")
        with np.load(os.path.join(path, "arrays.npz")) as z:
            flat = {k: z[k] for k in z.files}
        state = _unflatten(tree_like, flat)
        if shardings is not None:   # elastic: place onto the (new) mesh
            from ..dist.sharding import place_tree
            mesh, named = shardings
            state = place_tree(state, named, mesh)
        return step, state
