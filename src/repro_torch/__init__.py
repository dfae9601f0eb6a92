"""MITHRIL on PyTorch and CUDA: the port of the ``repro`` package.

The batched trace sweep — trace -> ``cache.sweep_scheduled`` -> per-
request segments -> MITHRIL record event and mining barrier -> hit ratio
and prefetch precision per trace — with the record and mining kernels
hand-written in CUDA C++ for Hopper (``kernels/csrc``). Module names
mirror ``repro``'s. Entry points take ``device=None``, meaning the card;
only an explicit ``device="cpu"`` runs on the CPU.

Importing this package loads neither JAX nor the ``repro`` package.
"""
