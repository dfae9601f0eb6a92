"""The port's training pass against the reference's, on the CPU.

At ``reduced_config``, B = 2, S = 32, from the reference's parameters
(``repro.models.init_params``, carried in by ``convert.lm_params_from``)
and the same seeded batches; the reference compiled with
``xla_allow_excess_precision`` off, as ``tests/test_torch_lm.py``
compiles it (by default XLA keeps float32 between fused bf16 ops).

Tolerances:

* the flash backward (dq, dk, dv of bf16 operands) against ``jax.grad``
  of the reference's ``flash_attention`` and against autograd through
  the port's quadratic ``full_attention``: rtol = atol = 2e-2, one bf16
  step at the gradients' scale (the sums run in other orders);
* per architecture, the loss within 1e-2 (relative, as
  ``test_torch_lm.py`` holds the forward) and every gradient leaf with
  a cosine of at least 0.99 and a relative L2 error of at most 5e-2
  against ``jax.value_and_grad(forward_train)``, or, for a leaf where
  the reference disagrees with itself by more than that, at most twice
  its own spread: the L2 distance between its gradients compiled with
  and without ``xla_allow_excess_precision`` (two legitimate roundings
  of the same program), relative to the exact-bf16 one. Two kinds of
  leaf have such a spread, measured at this batch: whisper's last
  decoder layer's ``wq``/``wk`` (the reference's spread 0.06-0.10 over
  batch seeds 1-5, the port's distance 0.03-0.08), whose gradient is a
  small difference of large terms in the attention backward; and
  mixtral's layer-3 MoE leaves, where one token's router input, a bf16
  step apart, picks another expert in each rounding (the reference's
  spread up to 0.071, the port's distance up to 0.099; the MoE
  backward alone, on equal inputs, agrees within 1%: see
  ``test_moe_backward_matches_reference``);
* the three remat modes give the same bits in the port;
* one AdamW step on those gradients (the reference's, carried in with
  its initial state by ``convert.adamw_state_from``, weight decay by
  ``launch.steps.lm_decay``) within rtol 1e-5 of the reference's step:
  the same float32 formulas, the global norm summed in another order;
  the in-place step (``adamw.update_``) equal to the functional one bit
  for bit.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as REF_ARCHS
from repro.configs import reduced_config as ref_reduced
from repro.models import RunFlags as RefRunFlags
from repro.models import forward_train as ref_forward_train
from repro.models import init_params as ref_init
from repro.models.attention import flash_attention as ref_flash
from repro.optim import adamw as radamw

from repro_torch.configs import ARCHS, reduced_config
from repro_torch.convert import adamw_state_from, lm_params_from, \
    lm_state_names
from repro_torch.launch.steps import lm_decay
from repro_torch.models import attention, lm
from repro_torch.optim import adamw

TRAINED = ["llama3.2-3b", "qwen2-moe-a2.7b", "mixtral-8x7b", "internvl2-1b",
           "recurrentgemma-9b", "rwkv6-1.6b", "whisper-medium"]
B, S = 2, 32
FLASH_TOL = 2e-2
LOSS_RTOL = 1e-2
GRAD_REL_L2 = 5e-2
GRAD_COSINE = 0.99
EXACT_BF16 = {"xla_allow_excess_precision": False}


def compiled(fn, *args):
    return jax.jit(fn).lower(*args).compile(compiler_options=EXACT_BF16)


def bf16_pair(a: np.ndarray):
    return (jnp.asarray(a, jnp.bfloat16),
            torch.from_numpy(a.astype(np.float32)).bfloat16())


def train_batches(cfg, seed=1):
    """The training driver's batch layout: (B, S) labels, the vision
    stub's patches first (cutting the tokens), seeded frames."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    labels = np.roll(tokens, -1, axis=1)
    labels[:, -1] = -1
    ref, port = {}, {}
    if cfg.frontend == "vision_stub":
        tokens = tokens[:, :S - cfg.n_patches]
        ref["patches"], port["patches"] = bf16_pair(
            rng.standard_normal((B, cfg.n_patches, cfg.d_model)))
    if cfg.is_encoder_decoder:
        ref["frames"], port["frames"] = bf16_pair(
            rng.standard_normal((B, cfg.encoder_seq, cfg.d_model)))
    ref.update(tokens=jnp.asarray(tokens), labels=jnp.asarray(labels))
    port.update(tokens=torch.from_numpy(tokens),
                labels=torch.from_numpy(labels))
    return ref, port


def setup(arch, seed=0):
    cfg = reduced_config(ARCHS[arch])
    ref_cfg = ref_reduced(REF_ARCHS[arch])
    params = ref_init(ref_cfg, jax.random.PRNGKey(seed))
    model = lm_params_from(jax.tree.map(np.asarray, params), cfg,
                           device="cpu")
    model.requires_grad_(True)
    return cfg, ref_cfg, params, model


def by_port_name(cfg, tree) -> dict:
    """A reference pytree shaped as the parameters, as {port name: float32
    numpy}."""
    out = {}
    for name, path in lm_state_names(cfg).items():
        leaf = tree
        for key in path:
            leaf = leaf[key]
        out[name] = np.asarray(leaf, np.float32)
    return out


def rel_l2(got: np.ndarray, want: np.ndarray) -> float:
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-30))


def cosine(got: np.ndarray, want: np.ndarray) -> float:
    den = np.linalg.norm(got) * np.linalg.norm(want)
    return 1.0 if den == 0 else float(np.dot(got.ravel(), want.ravel())
                                      / den)


@functools.lru_cache(maxsize=None)
def reference_step(arch):
    """The reference's ``(total, metrics)`` and gradients of the seed-1
    batch, compiled with exact bf16 rounding."""
    cfg, ref_cfg, params, _ = setup(arch)
    ref_batch, _ = train_batches(cfg)
    fn = jax.value_and_grad(
        lambda p, b: ref_forward_train(ref_cfg, p, b,
                                       RefRunFlags(remat="none")),
        has_aux=True)
    (total, metrics), grads = compiled(fn, params, ref_batch)(
        params, ref_batch)
    spread = functools.partial(
        lambda: by_port_name(cfg, jax.jit(fn)(params, ref_batch)[1]))
    return float(total), float(metrics["loss"]), grads, spread


def port_step(cfg, model, batch, remat):
    model.zero_grad(set_to_none=True)
    total, metrics = lm.forward_train(cfg, model, batch,
                                      lm.RunFlags(remat=remat))
    total.backward()
    return (total.detach(), {k: v.detach() for k, v in metrics.items()},
            {n: p.grad.clone() for n, p in model.named_parameters()})


@pytest.mark.parametrize("sq,skv,causal,window,q_offset", [
    (64, 64, True, 0, 0),          # causal, one block
    (256, 256, True, 40, 0),       # windowed: several lanes, tiles skipped
    (32, 96, True, 0, 64),         # a query block at an offset
    (24, 40, False, 0, 0),         # non-causal (cross-attention)
])
def test_flash_backward_matches_reference(sq, skv, causal, window,
                                          q_offset):
    rng = np.random.default_rng(sq + skv)
    q, k, v = (rng.standard_normal(shape) for shape in
               ((B, sq, 4, 32), (B, skv, 2, 32), (B, skv, 2, 32)))
    dout = rng.standard_normal((B, sq, 4, 32))
    (jq, tq), (jk, tk), (jv, tv), (jd, td) = (
        bf16_pair(a) for a in (q, k, v, dout))
    kw = dict(causal=causal, window=window, q_offset=q_offset)

    def ref_loss(q_, k_, v_):
        out = ref_flash(q_, k_, v_, **kw).astype(jnp.float32)
        return jnp.sum(out * jd.astype(jnp.float32))
    want = jax.jit(jax.grad(ref_loss, argnums=(0, 1, 2)))(jq, jk, jv)
    leaves = [t.clone().requires_grad_(True) for t in (tq, tk, tv)]
    out = attention.flash_attention(*leaves, **kw)
    got = torch.autograd.grad(out, leaves, td)
    quad = torch.autograd.grad(attention.full_attention(*leaves, **kw),
                               leaves, td)
    for g, w, f in zip(got, want, quad):
        assert g.dtype == torch.bfloat16
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(w, np.float32),
                                   rtol=FLASH_TOL, atol=FLASH_TOL)
        np.testing.assert_allclose(g.float().numpy(), f.float().numpy(),
                                   rtol=FLASH_TOL, atol=FLASH_TOL)
    with torch.no_grad():                # inference keeps its bits
        assert torch.equal(attention.flash_attention(tq, tk, tv, **kw), out)


def test_grad_cast_bf16_casts_the_cotangent():
    x = torch.linspace(-3, 3, 17, dtype=torch.float32, requires_grad=True)
    g = torch.linspace(1, 2, 17, dtype=torch.float32) / 3
    y = lm.grad_cast_bf16(x)
    assert torch.equal(y, x)
    assert lm.GradCastBf16.backward(None, g).dtype == torch.bfloat16
    y.backward(g)
    assert torch.equal(x.grad, g.to(torch.bfloat16).float())
    assert not torch.equal(x.grad, g)


def test_remat_attn_out_keeps_the_flash_output(monkeypatch):
    """remat="full" recomputes each flash forward in the backward,
    "attn_out" keeps its output and recomputes none."""
    cfg, _, _, model = setup("llama3.2-3b")
    _, batch = train_batches(cfg)
    calls = []
    inner = attention._flash_fwd
    monkeypatch.setattr(attention, "_flash_fwd",
                        lambda *a: calls.append(1) or inner(*a))
    runs = {}
    for remat in ("none", "full", "attn_out"):
        calls.clear()
        port_step(cfg, model, batch, remat)
        runs[remat] = len(calls)
    assert runs == {"none": cfg.n_layers, "full": 2 * cfg.n_layers,
                    "attn_out": cfg.n_layers}


@pytest.mark.parametrize("arch", TRAINED)
def test_loss_and_gradients_match_reference(arch):
    cfg, _, _, model = setup(arch)
    _, port_batch = train_batches(cfg)
    want_total, want_loss, want_g, spread_of = reference_step(arch)
    runs = {r: port_step(cfg, model, port_batch, r)
            for r in ("none", "full", "attn_out")}
    total, metrics, grads = runs["none"]
    for remat in ("full", "attn_out"):          # remat moves no bit
        assert torch.equal(runs[remat][0], total), remat
        for name in grads:
            assert torch.equal(runs[remat][2][name], grads[name]), \
                (remat, name)
    np.testing.assert_allclose(float(metrics["loss"]), want_loss,
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(total), want_total, rtol=LOSS_RTOL)
    want = by_port_name(cfg, want_g)
    assert set(want) == set(grads)
    spread = None
    for name, g in grads.items():
        assert g.dtype == dict(model.named_parameters())[name].dtype, name
        got = g.float().numpy()
        assert np.isfinite(got).all(), name
        assert cosine(got, want[name]) >= GRAD_COSINE, name
        err = rel_l2(got, want[name])
        if err <= GRAD_REL_L2:
            continue
        if spread is None:          # the reference's own spread
            spread = spread_of()
        assert err <= 2 * rel_l2(spread[name], want[name]), name


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "mixtral-8x7b"])
def test_moe_backward_matches_reference(arch):
    """Each MoE layer's FFN and load-balancing loss, differentiated on
    the same bf16 inputs (the port's activations at that layer): the
    same expert choices, every gradient within 1e-2 relative L2."""
    from repro.models import moe as rmoe
    from repro_torch.models import moe as pmoe
    cfg, _, _, model = setup(arch)
    _, batch = train_batches(cfg)
    seen = []

    def spy(p, x, **kw):
        seen.append(x.detach().clone())
        return pmoe.moe_ffn(p, x, **kw)
    lm_moe, lm.moe_ffn = lm.moe_ffn, spy
    try:
        with torch.no_grad():
            lm.forward_train(cfg, model, batch)
    finally:
        lm.moe_ffn = lm_moe
    kw = dict(n_experts=cfg.n_experts, top_k=cfg.top_k,
              cap_factor=cfg.moe_cap_factor)

    def f(p_, x_, cot_):
        o, lg, ix = rmoe.moe_ffn(p_, x_, **kw)
        return ((o.astype(jnp.float32) * cot_).sum()
                + rmoe.aux_load_balance_loss(lg, ix, cfg.n_experts)), ix
    ref_grad = jax.jit(jax.value_and_grad(f, argnums=(0, 1), has_aux=True))
    assert len(seen) == cfg.n_layers
    for li, x in enumerate(seen):
        mlp = model.layers[li].mlp
        cot = np.random.default_rng(li).standard_normal(
            tuple(x.shape)).astype(np.float32)
        p = {k: v.detach().clone().requires_grad_(True)
             for k, v in mlp.params().items()}
        xp = x.clone().requires_grad_(True)
        out, logits, idx = pmoe.moe_ffn(p, xp, **kw)
        ((out.float() * torch.from_numpy(cot)).sum()
         + pmoe.aux_load_balance_loss(logits, idx, cfg.n_experts)
         ).backward()
        jp = {k: jnp.asarray(v.detach().float().numpy(),
                             jnp.float32 if v.dtype == torch.float32
                             else jnp.bfloat16)
              for k, v in mlp.params().items()}

        (_, want_idx), (gp, gx) = ref_grad(
            jp, jnp.asarray(x.float().numpy(), jnp.bfloat16), cot)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
        assert rel_l2(xp.grad.float().numpy(),
                      np.asarray(gx, np.float32)) <= 1e-2, li
        for k in p:
            assert rel_l2(p[k].grad.float().numpy(),
                          np.asarray(gp[k], np.float32)) <= 1e-2, (li, k)


@pytest.mark.parametrize("arch", ["llama3.2-3b", "qwen2-moe-a2.7b"])
def test_adamw_step_on_model_gradients_matches_reference(arch):
    cfg, _, params, model = setup(arch)
    grads_ref = reference_step(arch)[2]
    rcfg = radamw.AdamWConfig(total_steps=8, warmup_steps=2)
    new_ref, ref_state, ref_m = jax.jit(functools.partial(
        radamw.update, rcfg))(grads_ref, radamw.init(params), params)
    state = adamw_state_from(jax.tree.map(np.asarray, radamw.init(params)),
                             cfg, "cpu")
    assert int(state.step) == 0
    ported = {n: p.detach() for n, p in model.named_parameters()}
    grads = {n: torch.from_numpy(np.array(g)).to(ported[n].dtype)
             for n, g in by_port_name(cfg, grads_ref).items()}
    opt_cfg = adamw.AdamWConfig(total_steps=8, warmup_steps=2)
    decay = lm_decay(cfg)
    new, new_state, m = adamw.update(opt_cfg, grads, state, ported, decay)
    np.testing.assert_allclose(float(m["lr"]), float(ref_m["lr"]),
                               rtol=1e-6)
    np.testing.assert_allclose(float(m["grad_norm"]),
                               float(ref_m["grad_norm"]), rtol=1e-5)
    want_master = by_port_name(cfg, ref_state.master)
    want_params = by_port_name(cfg, new_ref)
    for name in ported:
        assert new[name].dtype == ported[name].dtype, name
        np.testing.assert_allclose(new_state.master[name].numpy(),
                                   want_master[name], rtol=1e-5, atol=1e-7,
                                   err_msg=name)
        np.testing.assert_allclose(new[name].float().numpy(),
                                   want_params[name], rtol=1e-2, atol=1e-7,
                                   err_msg=name)
    # the in-place step: the same bits, written into the state and params
    inplace = {n: p.clone() for n, p in ported.items()}
    state2, m2 = adamw.update_(opt_cfg, grads, state, inplace, decay)
    assert state2.master is state.master and int(state2.step) == 1
    assert torch.equal(m2["grad_norm"], m["grad_norm"])
    for name in ported:
        assert torch.equal(inplace[name], new[name]), name
        for leaf in ("master", "m", "v"):
            assert torch.equal(getattr(state2, leaf)[name],
                               getattr(new_state, leaf)[name]), (leaf, name)
    # the decay rule: the reference's paths decay only outside the units
    assert {n for n, d in decay.items() if d} == \
        {"embed"} | ({"lm_head"} if not cfg.tie_embeddings else set())
