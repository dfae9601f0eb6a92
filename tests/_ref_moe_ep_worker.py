"""The reference's expert-parallel MoE on JAX CPU devices, for
``test_torch_dist.py``'s capacity check.

Started by ``multiprocessing`` (spawn) in a process of its own, because
it asks XLA for four host devices before JAX starts. It reads the MoE
inputs the test wrote (``moe_in.npz``) and writes the reference's
``moe_ffn_ep`` outputs on the gloo groups' mesh shapes, at the configs'
capacity factor 1.25, at 0.5 (where many tokens drop) and at 4.0
(where none does), to ``ref_ep.npz``.
"""

from __future__ import annotations

import os

EXACT_BF16 = {"xla_allow_excess_precision": False}
SHAPES = {2: (1, 2), 4: (2, 2)}
CAPS = (0.5, 1.25, 4.0)


def main(tmp: str) -> None:
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import Mesh

    from repro.dist.ctx import sharding_ctx
    from repro.dist.moe_ep import moe_ffn_ep

    with np.load(os.path.join(tmp, "moe_in.npz")) as z:
        data = {k: z[k] for k in z.files}
    out = {}
    for arch in ("mixtral", "qwen2moe"):
        p = {k.split("/", 1)[1]: jnp.asarray(
            v, jnp.float32 if k.endswith("/router") else jnp.bfloat16)
             for k, v in data.items() if k.startswith(arch + "/")}
        x = jnp.asarray(data[f"x/{arch}"], jnp.bfloat16)
        for world, shape in SHAPES.items():
            mesh = Mesh(np.array(jax.devices()[:world]).reshape(shape),
                        ("data", "model"))
            for cap in CAPS:
                kw = dict(n_experts=int(data[f"E/{arch}"]),
                          top_k=int(data[f"K/{arch}"]), cap_factor=cap)
                with sharding_ctx(mesh, dp_axes=("data",), tp_axis="model"):
                    fn = jax.jit(lambda p, x: moe_ffn_ep(p, x, **kw)).lower(
                        p, x).compile(compiler_options=EXACT_BF16)
                    got = fn(p, x)
                for i, t in enumerate(got):
                    out[f"{arch}/{world}/{cap}/{i}"] = np.asarray(t,
                                                                  np.float32)
    np.savez(os.path.join(tmp, "ref_ep.npz"), **out)
