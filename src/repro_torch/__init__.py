"""MITHRIL on PyTorch and CUDA: the port of the ``repro`` package.

Two paths, with every kernel hand-written in CUDA C++ for Hopper
(``kernels/csrc``):

* the batched trace sweep — trace -> ``cache.sweep_scheduled`` -> per-
  request segments -> MITHRIL record event and mining barrier -> hit
  ratio and prefetch precision per trace (record and mining kernels);
* serving — ``launch.serve.TieredServeEngine`` over the tiered paged-KV
  cache ``cache.tiered.TieredKVCache``, whose misses MITHRIL records and
  whose predicted pages it prefetches (record, mining and lookup
  kernels), one paged flash-decode launch a step.

Module names mirror ``repro``'s. Entry points take ``device=None``, meaning the card;
only an explicit ``device="cpu"`` runs on the CPU.

Importing this package loads neither JAX nor the ``repro`` package.
"""

# The MITHRIL core and the kernel modules import each other (the kernels
# hash with ``core.hashindex``; ``core.mithril`` defaults to the kernel
# wrappers). Loading the core first settles that order for an import of
# any single module of the package.
from . import core  # noqa: F401
