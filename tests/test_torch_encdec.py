"""The whisper encoder-decoder's parts against the reference's, on the CPU.

At ``reduced_config("whisper-medium")`` (2 encoder and 4 decoder layers,
d 128, 24 frames), the reference's parameters carried into the port by
``convert.lm_params_from``, the same frames and activations (numpy,
seeded) go through the reference's ``_encode``, ``_project_cross`` and
``_cross_sub`` (compiled with ``xla_allow_excess_precision`` off) and
the port's. Each part is held alone, on the reference's own input:

* ``_encode`` (frames + sinusoidal positions, non-causal blocks with
  layer norms and the GELU FFN, the encoder norm) within 5e-2, the
  logits' tolerance (two layers of bf16 rounding);
* ``_project_cross``: every decoder layer's cross keys and values,
  (L, B, S_enc, Hkv, hd), within one bf16 step (2e-2);
* ``_cross_sub``: the cross-attention sublayer within 2e-2;
* the decoder's input embedding (tokens + sinusoidal positions) within
  one bf16 step (2^-7 relative: the two libraries' float32 ``sin`` and
  ``cos`` may differ in the last bit, which can move a bf16 rounding).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as REF_ARCHS
from repro.configs import reduced_config as ref_reduced
from repro.models import init_params as ref_init
from repro.models import lm as ref_lm

from repro_torch.configs import ARCHS, reduced_config
from repro_torch.convert import lm_params_from
from repro_torch.models import lm

EXACT_BF16 = {"xla_allow_excess_precision": False}
ARCH = "whisper-medium"
B = 2


def compiled(fn, *args):
    return jax.jit(fn).lower(*args).compile(compiler_options=EXACT_BF16)(
        *args)


def to_port(x) -> torch.Tensor:
    arr = np.array(x)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def as_np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.fixture(scope="module")
def whisper():
    cfg = reduced_config(ARCHS[ARCH])
    ref_cfg = ref_reduced(REF_ARCHS[ARCH])
    params = ref_init(ref_cfg, jax.random.PRNGKey(0))
    # non-zero norms and biases, so that each enters the comparison
    rng = np.random.default_rng(9)
    params = jax.tree_util.tree_map_with_path(
        lambda path, x: (x + jnp.asarray(rng.standard_normal(x.shape) * 0.1,
                                         x.dtype)
                         if getattr(path[-1], "key", "") in
                         ("s", "b", "b_up", "b_down") else x), params)
    model = lm_params_from(jax.tree.map(np.asarray, params), cfg,
                           device="cpu")
    frames = jnp.asarray(
        rng.standard_normal((B, cfg.encoder_seq, cfg.d_model)), jnp.bfloat16)
    return cfg, ref_cfg, params, model, frames


def test_encoder_matches_reference(whisper):
    cfg, ref_cfg, params, model, frames = whisper
    want = compiled(lambda p, f: ref_lm._encode(ref_cfg, p, f,
                                                ref_lm.RunFlags()),
                    params, frames)
    got = lm._encode(cfg, model, to_port(frames))
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(as_np(got), as_np(want), rtol=5e-2,
                               atol=5e-2)


def test_project_cross_matches_reference(whisper):
    cfg, ref_cfg, params, model, frames = whisper
    enc = compiled(lambda p, f: ref_lm._encode(ref_cfg, p, f,
                                               ref_lm.RunFlags()),
                   params, frames)
    want = compiled(lambda p, e: ref_lm._project_cross(ref_cfg, p, e),
                    params, enc)
    k, v = lm._project_cross(cfg, model, to_port(enc))
    for got, name in ((k, "k"), (v, "v")):
        assert tuple(got.shape) == want[name].shape == (
            cfg.n_layers, B, cfg.encoder_seq, cfg.n_kv_heads, cfg.head_dim)
        np.testing.assert_allclose(as_np(got), as_np(want[name]),
                                   rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("seq", [1, 5])
def test_cross_sub_matches_reference(whisper, seq):
    cfg, ref_cfg, params, model, _ = whisper
    rng = np.random.default_rng(seq)
    x = jnp.asarray(rng.standard_normal((B, seq, cfg.d_model)), jnp.bfloat16)
    kv = {n: jnp.asarray(rng.standard_normal(
        (B, cfg.encoder_seq, cfg.n_kv_heads, cfg.head_dim)), jnp.bfloat16)
        for n in ("k", "v")}
    layer = 2
    p_ref = jax.tree.map(lambda a: a[layer], params["blocks"][0]["u0"][
        "cross"])
    want = compiled(lambda p, x, kv: ref_lm._cross_sub(ref_cfg, p, x, kv),
                    p_ref, x, kv)
    got = lm._cross_sub(cfg, model.layers[layer].cross, to_port(x),
                        (to_port(kv["k"]), to_port(kv["v"])))
    np.testing.assert_allclose(as_np(got), as_np(want), rtol=2e-2,
                               atol=2e-2)


def test_decoder_input_embedding_equals_reference(whisper):
    cfg, ref_cfg, params, model, _ = whisper
    tokens = np.random.default_rng(3).integers(0, cfg.vocab, (B, 6))
    pos = np.tile(np.arange(10, 16)[None], (B, 1))
    want = compiled(lambda p, t, q: ref_lm._input_embeds(
        ref_cfg, p, {"tokens": t}, q), params, jnp.asarray(tokens),
        jnp.asarray(pos))
    got = lm._input_embeds(cfg, model, {"tokens": torch.from_numpy(tokens)},
                           torch.from_numpy(pos))
    np.testing.assert_allclose(as_np(got), as_np(want), rtol=2 ** -7,
                               atol=2 ** -7)
