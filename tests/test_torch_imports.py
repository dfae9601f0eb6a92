"""The port stands alone: it loads neither JAX nor the reference package,
and its entry points run on the card unless the CPU is asked for."""

import os
import pathlib
import pkgutil
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import repro_torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"
FORBIDDEN = re.compile(r"^\s*(import|from)\s+jax\b|(?<![\w.])repro\.",
                       re.MULTILINE)


def all_modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        repro_torch.__path__, "repro_torch."))


def test_importing_every_module_loads_no_jax_and_no_reference():
    code = ("import importlib, sys\n"
            f"for name in {all_modules()!r}:\n"
            "    importlib.import_module(name)\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'repro' or m.startswith('repro.'))\n"
            "print(len(sys.modules), bad)\n"
            "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr


# the serving slice's modules, and a kernel module that once could not be
# imported first (the kernels and the core import each other)
ALONE_MODULES = ["repro_torch.cache.tiered", "repro_torch.launch.serve",
                 "repro_torch.kernels.paged_decode",
                 "repro_torch.kernels.hash_lookup",
                 "repro_torch.kernels.mithril_record"]


@pytest.mark.parametrize("name", ALONE_MODULES)
def test_modules_load_alone_without_jax_or_reference(name):
    assert name in all_modules()
    code = (f"import importlib, sys\nimportlib.import_module({name!r})\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'repro'))\n"
            "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr


def test_serving_entry_points_without_a_card_raise():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from repro_torch.cache.tiered import TieredKVCache
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TieredKVCache(8, 4, 2, 1, 4)
    tier = TieredKVCache(8, 4, 2, 1, 4, device="cpu")
    assert tier.hbm_k.device.type == "cpu"
    assert not tier.host_k.is_pinned()


def test_sources_name_neither_jax_nor_the_reference():
    files = sorted(PKG.rglob("*.py")) + sorted(PKG.rglob("*.cu")) \
        + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    for path in files:
        text = path.read_text()
        hit = FORBIDDEN.search(text)
        assert hit is None, f"{path.relative_to(ROOT)}: {hit.group(0)!r}"


def test_simulate_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from repro_torch.cache import SimConfig, SimSession, simulate, sweep
    trace = np.arange(10, dtype=np.int32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        simulate(SimConfig(capacity=16), trace)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        sweep(SimConfig(capacity=16), trace[None])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SimSession(SimConfig(capacity=16))
    assert simulate(SimConfig(capacity=16), trace,
                    device="cpu").stats.requests == 10


def test_kernel_sources_and_build_flags():
    from repro_torch.kernels import backend
    assert set(backend.sources()) == {"hash_lookup", "mithril_mine",
                                      "mithril_record", "paged_decode"}
    assert "arch=compute_90a,code=sm_90a" in backend.NVCC_FLAGS
    assert backend.BUILD_DIR == ROOT / "build" / "kernels"
    assert "build/" in (ROOT / ".gitignore").read_text().split()
