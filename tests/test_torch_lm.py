"""The port's language model against the reference's, on the CPU.

For the 10 architectures (dense, GQA with QKV bias, SWA + MoE, MoE with
shared experts, the vision stub, RG-LRU + local attention, RWKV6, the
whisper encoder-decoder), at ``reduced_config``,
the reference's parameters (``repro.models.init_params``) are carried
into the port by ``convert.lm_params_from``, and the same tokens (numpy,
seeded) go through both:

* prefill logits and 4 teacher-forced ``decode_step`` logits within
  rtol = atol = 5e-2, the tolerance of the reference's own
  ``test_decode_matches_forward``; the KV caches (and the whisper cross
  keys and values) within the bf16 tolerance (2e-2), the recurrent
  states within the logits' tolerance (their float32 leaves carry the
  bf16 activations' differences);
* the port's decode against the port's full-sequence forward;
* the training pass's loss (forward only) within 1e-2.

The reference runs compiled, as its tests run it, with XLA's
``xla_allow_excess_precision`` off. By default XLA's CPU compiler keeps
float32 between the bf16 ops it fuses and rounds only at the fusion's
end, so the compiled reference departs from the arithmetic its program
states, bf16 rounding after every op, which is what the port does; in
the MoE architectures a router input a few bf16 steps away moves an
expert choice, and the logits with it, by far more than the tolerance.
With the option off the compiler rounds where the program rounds.

Every architecture builds, initialises and gives an empty cache, and
the module holds as many parameters as the reference's pytree.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as REF_ARCHS
from repro.configs import reduced_config as ref_reduced
from repro.models import decode_step as ref_decode
from repro.models import forward_train as ref_forward_train
from repro.models import init_params as ref_init
from repro.models import prefill as ref_prefill

from repro_torch.configs import ARCHS, get_config, reduced_config
from repro_torch.convert import lm_params_from, lm_state_names
from repro_torch.models import lm

PORTED = ["llama3.2-3b", "qwen2-7b", "qwen2.5-14b", "qwen1.5-110b",
          "mixtral-8x7b", "qwen2-moe-a2.7b", "internvl2-1b",
          "recurrentgemma-9b", "rwkv6-1.6b", "whisper-medium"]
ATTN_ONLY = PORTED[:7]
TOL = 5e-2
CACHE_TOL = 2e-2
B, S, STEPS = 2, 24, 4
EXACT_BF16 = {"xla_allow_excess_precision": False}


def compiled(fn, *args):
    """``fn`` compiled by XLA with bf16 rounded after every op."""
    return jax.jit(fn).lower(*args).compile(compiler_options=EXACT_BF16)


def as_np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def setup(arch, seed=0):
    cfg = reduced_config(ARCHS[arch])
    ref_cfg = ref_reduced(REF_ARCHS[arch])
    params = ref_init(ref_cfg, jax.random.PRNGKey(seed))
    model = lm_params_from(jax.tree.map(np.asarray, params), cfg,
                           device="cpu")
    return cfg, ref_cfg, params, model


def bf16_pair(a: np.ndarray):
    return (jnp.asarray(a, jnp.bfloat16),
            torch.from_numpy(a.astype(np.float32)).bfloat16())


def batches(cfg, seed=1, batch=B, seq=S):
    """Token batches for both (with stub patches for the vision
    frontend: they take the first positions; with stub frames for the
    encoder-decoder)."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab, (batch, seq + STEPS)).astype(
        np.int32)
    ref = {"tokens": jnp.asarray(tokens[:, :seq])}
    port = {"tokens": torch.from_numpy(tokens[:, :seq])}
    if cfg.frontend == "vision_stub":
        ref["patches"], port["patches"] = bf16_pair(
            rng.standard_normal((batch, cfg.n_patches, cfg.d_model)))
    if cfg.is_encoder_decoder:
        ref["frames"], port["frames"] = bf16_pair(
            rng.standard_normal((batch, cfg.encoder_seq, cfg.d_model)))
    return tokens, ref, port


def entry_leaves(entry) -> dict:
    """A cache entry's leaves by name: {"k", "v"} or a state's fields."""
    return dict(entry) if isinstance(entry, dict) else entry._asdict()


def test_every_architecture_is_ported_or_raises():
    assert sorted(PORTED) == sorted(ARCHS) == sorted(REF_ARCHS)
    for name in ARCHS:                  # the configs are copies
        assert ARCHS[name] == get_config(name)
        assert vars(ARCHS[name]) == vars(REF_ARCHS[name])


@pytest.mark.parametrize("arch", PORTED)
def test_prefill_and_decode_match_reference(arch):
    cfg, ref_cfg, params, model = setup(arch)
    tokens, ref_batch, port_batch = batches(cfg)
    offset = S + (cfg.n_patches if "patches" in port_batch else 0)
    pad_to = offset + STEPS + 4

    prefill_ref = compiled(lambda p, b: ref_prefill(ref_cfg, p, b,
                                                    pad_to=pad_to),
                           params, ref_batch)
    want, cache_ref = prefill_ref(params, ref_batch)
    got, cache = lm.prefill(cfg, model, port_batch, pad_to=pad_to)
    assert got.dtype == torch.float32 and got.shape == (B, cfg.padded_vocab)
    np.testing.assert_allclose(as_np(got), as_np(want), rtol=TOL, atol=TOL)

    decode_ref = None
    for i in range(STEPS):
        pos = np.full((B,), offset + i, np.int32)
        args = (params, cache_ref, jnp.asarray(tokens[:, S + i]),
                jnp.asarray(pos))
        if decode_ref is None:
            decode_ref = compiled(
                lambda p, c, t, q: ref_decode(ref_cfg, p, c, t, q), *args)
        want, cache_ref = decode_ref(*args)
        got, cache = lm.decode_step(cfg, model, cache,
                                    torch.from_numpy(tokens[:, S + i]),
                                    torch.from_numpy(pos))
        np.testing.assert_allclose(as_np(got), as_np(want), rtol=TOL,
                                   atol=TOL, err_msg=f"decode step {i}")
    assert len(cache) == len(cache_ref)
    for group, group_ref in zip(cache, cache_ref):
        assert sorted(group) == sorted(group_ref)
        for unit in group:
            got_leaves = entry_leaves(group[unit])
            want_leaves = entry_leaves(group_ref[unit])
            assert sorted(got_leaves) == sorted(want_leaves)
            tol = CACHE_TOL if isinstance(group[unit], dict) else TOL
            for name, leaf in got_leaves.items():
                want_leaf = want_leaves[name]
                assert str(leaf.dtype).split(".")[1] == str(want_leaf.dtype)
                np.testing.assert_allclose(
                    as_np(leaf), as_np(want_leaf), rtol=tol, atol=tol,
                    err_msg=f"{unit}.{name}")


def test_flags_in_the_reference_position():
    """``prefill(cfg, params, batch, flags, pad_to)``,
    ``decode_step(cfg, params, cache, token, pos, flags)`` and
    ``make_prefill_fn(cfg, flags)`` called positionally in the
    reference's form give the reference's logits in both packages."""
    from repro.launch.steps import make_prefill_fn as ref_make_prefill
    from repro.models import RunFlags as RefFlags
    from repro_torch.launch.steps import make_prefill_fn
    cfg, ref_cfg, params, model = setup("llama3.2-3b")
    tokens, ref_batch, port_batch = batches(cfg)
    pad_to = S + STEPS
    ref_flags, flags = RefFlags(remat="none"), lm.RunFlags(remat="none")
    want, cache_ref = compiled(
        lambda p, b: ref_prefill(ref_cfg, p, b, ref_flags, pad_to),
        params, ref_batch)(params, ref_batch)
    got, cache = lm.prefill(cfg, model, port_batch, flags, pad_to)
    assert cache[0]["u0"]["k"].shape[2] == pad_to == cache_ref[0]["u0"][
        "k"].shape[2]
    np.testing.assert_allclose(as_np(got), as_np(want), rtol=TOL, atol=TOL)
    got_fn, _ = make_prefill_fn(cfg, flags)(model, port_batch)
    want_fn, _ = compiled(ref_make_prefill(ref_cfg, ref_flags), params,
                          ref_batch)(params, ref_batch)
    np.testing.assert_array_equal(as_np(got_fn), as_np(
        lm.prefill(cfg, model, port_batch)[0]))
    np.testing.assert_allclose(as_np(got_fn), as_np(want_fn), rtol=TOL,
                               atol=TOL)
    pos = np.full((B,), S, np.int32)
    args = (params, cache_ref, jnp.asarray(tokens[:, S]), jnp.asarray(pos))
    want, _ = compiled(lambda p, c, t, q: ref_decode(ref_cfg, p, c, t, q,
                                                     ref_flags), *args)(*args)
    got, _ = lm.decode_step(cfg, model, cache, torch.from_numpy(tokens[:, S]),
                            torch.from_numpy(pos), flags)
    np.testing.assert_allclose(as_np(got), as_np(want), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("arch", PORTED)
def test_decode_matches_forward(arch):
    """prefill(x[:t]) + decode(x[t]) logits == forward(x[:t+1])[-1] in
    the port (the MoE archs are dropless at this scale)."""
    cfg = reduced_config(ARCHS[arch])
    model = lm.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    rng = np.random.default_rng(7)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (1, 65)))
    extra = {}
    if cfg.is_encoder_decoder:
        extra["frames"] = bf16_pair(rng.standard_normal(
            (1, cfg.encoder_seq, cfg.d_model)))[1]
    _, cache = lm.prefill(cfg, model, {"tokens": tokens[:, :64], **extra},
                          pad_to=72)
    got, _ = lm.decode_step(cfg, model, cache, tokens[:, 64],
                            torch.tensor([64]))
    want = lm.forward(cfg, model, {"tokens": tokens, **extra})[:, -1]
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("arch", PORTED)
def test_forward_train_loss_matches_reference(arch):
    cfg, ref_cfg, params, model = setup(arch)
    tokens, ref_batch, port_batch = batches(cfg)
    labels = np.concatenate([tokens[:, 1:S], np.full((B, 1), -1)], 1)
    if "patches" in port_batch:        # the patches take no label
        labels = np.concatenate([np.full((B, cfg.n_patches), -1), labels],
                                1)
    ref_batch["labels"] = jnp.asarray(labels, jnp.int32)
    port_batch["labels"] = torch.from_numpy(labels)
    (want, want_m) = compiled(lambda p, b: ref_forward_train(ref_cfg, p, b),
                              params, ref_batch)(params, ref_batch)
    got, got_m = lm.forward_train(cfg, model, port_batch)
    np.testing.assert_allclose(float(got_m["loss"]), float(want_m["loss"]),
                               rtol=1e-2)
    np.testing.assert_allclose(float(got_m["aux"]), float(want_m["aux"]),
                               rtol=1e-2, atol=1e-6)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-2)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_every_architecture_builds(arch):
    """The module at full width (on the meta device), its reduced weights
    (finite, norms and biases zero) and an empty cache."""
    lm.CausalLM(get_config(arch), device="meta")
    cfg = reduced_config(ARCHS[arch])
    model = lm.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    for name, prm in model.named_parameters():
        assert torch.isfinite(prm.float()).all(), name
        if name.rsplit(".", 1)[-1] in lm.ZERO_LEAVES:
            assert not prm.any(), name
    cache = lm.init_cache(cfg, 1, 8, device="cpu")
    assert len(cache) == len(lm.layer_groups(cfg)) + cfg.is_encoder_decoder


@pytest.mark.parametrize("arch", PORTED)
def test_state_names_cover_the_reference_pytree(arch):
    """Every reference leaf (each repeat of a stacked group) gives exactly
    one entry of the port's state dict, of the same shape and dtype."""
    cfg, ref_cfg, params, model = setup(arch)
    names = lm_state_names(cfg)
    state = model.state_dict()
    assert set(names) == set(state)
    leaves = jax.tree_util.tree_leaves_with_path(params)
    n_ref = sum(leaf.shape[0] if path[0].key in ("blocks", "enc_blocks")
                else 1 for path, leaf in leaves)
    assert len(names) == n_ref
    assert len(set(names.values())) == len(names)
    for name, path in names.items():
        leaf = params
        for key in path:
            leaf = leaf[key]
        assert tuple(state[name].shape) == leaf.shape
        assert str(state[name].dtype).split(".")[1] == str(leaf.dtype)
        np.testing.assert_array_equal(as_np(state[name]), as_np(leaf))
    if arch in ATTN_ONLY:
        assert names["layers.1.attn.wq"] == ("blocks", 0, "u0", "attn",
                                             "wq", 1)


@pytest.mark.parametrize("arch", PORTED)
def test_init_cache_matches_reference(arch):
    """Full-attention layers hold ``max_len`` slots, sliding-window
    layers a ring of ``min(max_len, window)``; zeros, bf16."""
    from repro.models import init_cache as ref_init_cache
    cfg = reduced_config(ARCHS[arch])
    for max_len in (40, 100):
        want = ref_init_cache(ref_reduced(REF_ARCHS[arch]), 3, max_len)
        got = lm.init_cache(cfg, 3, max_len, device="cpu")
        assert len(got) == len(want)
        for group, group_ref in zip(got, want):
            assert sorted(group) == sorted(group_ref)
            for unit, entry in group.items():
                want_leaves = entry_leaves(group_ref[unit])
                for name, t in entry_leaves(entry).items():
                    assert tuple(t.shape) == want_leaves[name].shape
                    assert str(t.dtype).split(".")[1] == str(
                        want_leaves[name].dtype)
                    assert not t.any()


@pytest.mark.parametrize("arch", PORTED)
def test_parameter_count(arch):
    """The module holds as many parameters as the reference's pytree at
    the published widths; for the attention families that is
    ``param_count()`` plus what that count leaves out: the final norm,
    QKV biases and shared-expert gates."""
    cfg = get_config(arch)
    model = lm.CausalLM(cfg, device="meta")
    n = sum(p.numel() for p in model.parameters())
    shapes = jax.eval_shape(lambda k: ref_init(REF_ARCHS[arch], k),
                            jax.random.PRNGKey(0))
    assert n == sum(leaf.size for leaf in jax.tree.leaves(shapes))
    if arch in ATTN_ONLY:
        extra = cfg.d_model
        if cfg.qkv_bias:
            extra += cfg.n_layers * (cfg.n_heads + 2 * cfg.n_kv_heads) \
                * cfg.head_dim
        if cfg.n_shared_experts:
            extra += cfg.n_layers * cfg.d_model
        assert n == cfg.param_count() + extra
    want = {"llama3.2-3b": 3_212_749_824,
            "recurrentgemma-9b": 10_444_771_328,
            "rwkv6-1.6b": 1_583_990_784, "whisper-medium": 811_569_152}
    if arch in want:
        assert n == want[arch]


def test_recurrentgemma_groups_match_reference():
    """38 layers: 12 units of (rglru, rglru, local) and a remainder group
    (rglru, rglru), as the reference groups them."""
    from repro.models.lm import layer_groups as ref_groups
    cfg = get_config("recurrentgemma-9b")
    groups = lm.layer_groups(cfg)
    assert groups == ref_groups(REF_ARCHS["recurrentgemma-9b"])
    assert groups == [(("rglru", "rglru", "local"), 12),
                      (("rglru", "rglru"), 1)]
    kinds = [blk.kind for blk in lm.CausalLM(cfg, device="meta").layers]
    assert kinds.count("rglru") == 26 and kinds.count("local") == 12
