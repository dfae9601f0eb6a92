"""Device selection and the CUDA kernel build.

Every entry point of the port takes ``device=None``, which means the
card: :func:`resolve_device` raises when no CUDA device is present, and
only an explicit ``device="cpu"`` runs on the CPU (the tests pass it).

The kernels are CUDA C++ for ``sm_90a`` under ``kernels/csrc/``. Each
source builds on first use into ``build/kernels/`` at the repository
root with ``nvcc -shared`` into a library with a plain C interface,
loaded with ``ctypes``: nothing is prebuilt or downloaded.
:func:`build_all` starts one ``nvcc`` per source, all at once.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
from pathlib import Path
from typing import Callable, Dict, Optional, Sequence, Union

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}
_FNS: Dict[tuple, Callable] = {}
# what nvcc printed for each source built in this process (ptxas' per
# kernel registers, shared memory and spills, from ``-Xptxas -v``)
BUILD_LOGS: Dict[str, str] = {}


def on_cuda() -> bool:
    return torch.cuda.is_available()


def resolve_device(device: Union[None, str, torch.device] = None
                   ) -> torch.device:
    """``None`` means the card; raises when the requested card is absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not on_cuda():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port's plain PyTorch path on the CPU")
    return dev


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def sources() -> Sequence[str]:
    return tuple(sorted(p.stem for p in CSRC.glob("*.cu")))


def _lib_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def _stale(name: str) -> bool:
    lib, src = _lib_path(name), CSRC / f"{name}.cu"
    return not lib.exists() or lib.stat().st_mtime < src.stat().st_mtime


def build_all(names: Optional[Sequence[str]] = None,
              force: bool = False) -> Dict[str, Path]:
    """Compile the named sources (default: all), one ``nvcc`` each, in
    parallel. Raises with the compiler's output if any build fails."""
    names = list(sources() if names is None else names)
    todo = [n for n in names if force or _stale(n)]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for n in todo:
        tmp = BUILD_DIR / f"lib{n}.{os.getpid()}.tmp.so"
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs.append((n, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    errors = []
    for n, tmp, proc in procs:
        out, _ = proc.communicate()
        BUILD_LOGS[n] = out
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {n}.cu:\n{out}")
        else:
            os.replace(tmp, _lib_path(n))
    if errors:
        raise RuntimeError("\n".join(errors))
    return {n: _lib_path(n) for n in names}


def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``csrc/<name>.cu``, built if needed."""
    if name not in _LIBS:
        if _stale(name):
            build_all([name])
        _LIBS[name] = ctypes.CDLL(str(_lib_path(name)))
    return _LIBS[name]


def c_function(lib: str, name: str, argtypes: Sequence,
               restype=ctypes.c_int) -> Callable:
    """A C entry point of ``lib`` with its argument types bound once.

    Pointers and the stream are ``c_void_p`` (a bare Python int would be
    cut to 32 bits); a launching entry point returns
    ``cudaGetLastError()``."""
    key = (lib, name)
    if key not in _FNS:
        fn = getattr(library(lib), name)
        fn.argtypes = list(argtypes)
        fn.restype = restype
        _FNS[key] = fn
    return _FNS[key]


def check_launch(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def stream_of(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def require(t: torch.Tensor, name: str, dtype: torch.dtype,
            shape: Sequence[int], device: torch.device) -> None:
    """Wrapper-side argument check: the kernels take nothing else."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
