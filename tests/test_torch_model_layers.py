"""The port's model building blocks against the reference's, on the CPU.

The same inputs, drawn with numpy from a seed, go through
``repro.models.{layers,attention,moe}`` and
``repro_torch.models.{layers,attention,moe}``:

* ``rms_norm``, ``rope`` and ``swiglu`` equal bit for bit in bf16 (the
  port rounds where the reference's ops round, ``jax.nn.sigmoid``'s
  three bf16 steps included) and within 1e-6 in float32, where the two
  libraries' ``rsqrt``, ``cos`` and ``sin`` may differ in the last bit;
* ``flash_attention`` (causal, ``window=48``, non-causal, and a length
  whose query blocks fill 16 lanes twice) and ``decode_attention``
  (ragged lengths, a full ring, a window) within 1e-5 in float32 and
  2e-2 in bf16;
* ``moe_ffn``: expert choices, capacity slots and kept rows equal
  exactly, with tokens dropped past capacity and with tied router
  scores; the output within the bf16 tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as ref_attn
from repro.models import layers as ref_layers
from repro.models import moe as ref_moe

from repro_torch.models import attention, layers, moe

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def both(a: np.ndarray, dtype: str):
    jdt, tdt = DTYPES[dtype]
    return jnp.asarray(a, jdt), torch.from_numpy(np.asarray(a, np.float32)
                                                 ).to(tdt)


def as_np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def assert_layer_equal(want, got, dtype):
    if dtype == "bfloat16":
        np.testing.assert_array_equal(as_np(got), as_np(want))
    else:
        np.testing.assert_allclose(as_np(got), as_np(want), rtol=1e-6,
                                   atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_equals_reference(dtype):
    rng = np.random.default_rng(0)
    xj, xt = both(rng.standard_normal((2, 16, 96)) * 3, dtype)
    sj, st = both(rng.standard_normal(96) * 0.1, dtype)
    assert_layer_equal(ref_layers.rms_norm(xj, sj, 1e-6),
                       layers.rms_norm(xt, st, 1e-6), dtype)


@pytest.mark.parametrize("theta", [1e4, 5e5, 1e6])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rope_equals_reference(dtype, theta):
    """Half-split rotary embedding over positions past the prompt."""
    rng = np.random.default_rng(1)
    xj, xt = both(rng.standard_normal((2, 24, 4, 32)), dtype)
    pos = np.tile(np.arange(40, 64)[None], (2, 1))
    assert_layer_equal(ref_layers.rope(xj, jnp.asarray(pos), theta),
                       layers.rope(xt, torch.from_numpy(pos), theta), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_swiglu_equals_reference(dtype):
    rng = np.random.default_rng(2)
    ws = [rng.standard_normal(s) * 0.1 for s in
          ((64, 160), (64, 160), (160, 64))]
    xj, xt = both(rng.standard_normal((8, 64)), dtype)
    wj, wt = zip(*(both(w, dtype) for w in ws))
    assert_layer_equal(ref_layers.swiglu(xj, *wj), layers.swiglu(xt, *wt),
                       dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_and_gelu_mlp_match_reference(dtype):
    """The encoder-decoder's blocks (its model waits for a later slice):
    within one bf16 step, as their float32 paths round alike."""
    rng = np.random.default_rng(7)
    xj, xt = both(rng.standard_normal((8, 64)) * 2, dtype)
    (sj, st), (bj, bt) = (both(rng.standard_normal(64) * 0.1, dtype)
                          for _ in range(2))
    np.testing.assert_allclose(
        as_np(layers.layer_norm(xt, st, bt, 1e-6)),
        as_np(ref_layers.layer_norm(xj, sj, bj, 1e-6)), rtol=TOL[dtype],
        atol=TOL[dtype])
    ws = [both(rng.standard_normal(shape) * 0.1, dtype)
          for shape in ((64, 96), (96,), (96, 64), (64,))]
    np.testing.assert_allclose(
        as_np(layers.gelu_mlp(xt, *(w[1] for w in ws))),
        as_np(ref_layers.gelu_mlp(xj, *(w[0] for w in ws))),
        rtol=TOL[dtype], atol=TOL[dtype])


def test_sinusoidal_pos_matches_reference():
    pos = np.tile(np.arange(0, 1500, 7)[None], (2, 1))
    np.testing.assert_allclose(
        layers.sinusoidal_pos(torch.from_numpy(pos), 64).numpy(),
        np.asarray(ref_layers.sinusoidal_pos(jnp.asarray(pos), 64)),
        rtol=1e-5, atol=2e-4)


def test_sigmoid_rounds_like_the_reference_in_bf16():
    """One rounding (``torch.sigmoid``) differs from the reference's three
    bf16 steps; the port's ``sigmoid`` takes the three."""
    x = np.linspace(-8, 8, 4001)
    xj, xt = both(x, "bfloat16")
    want = as_np(jax.nn.sigmoid(xj))
    np.testing.assert_array_equal(as_np(layers.sigmoid(xt)), want)
    assert (as_np(torch.sigmoid(xt)) != want).any()


FLASH_CASES = [(True, 0, 128), (True, 48, 128), (False, 0, 128),
               (True, 48, 512)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,window,seq", FLASH_CASES)
def test_flash_attention_matches_reference(causal, window, seq, dtype):
    """Blocks of 32 (16 for the long case: 32 query blocks, 16 lanes of
    2), GQA with 8 query and 4 kv heads."""
    rng = np.random.default_rng(3)
    block = 32 if seq <= 128 else 16
    q = rng.standard_normal((2, seq, 8, 32))
    k = rng.standard_normal((2, seq, 4, 32))
    v = rng.standard_normal((2, seq, 4, 32))
    (qj, qt), (kj, kt), (vj, vt) = (both(a, dtype) for a in (q, k, v))
    kw = dict(causal=causal, window=window, block_q=block, block_k=block)
    want = ref_attn.flash_attention(qj, kj, vj, **kw)
    got = attention.flash_attention(qt, kt, vt, **kw)
    assert got.dtype == DTYPES[dtype][1]
    np.testing.assert_allclose(as_np(got), as_np(want), rtol=TOL[dtype],
                               atol=TOL[dtype])
    full = attention.full_attention(qt, kt, vt, causal=causal, window=window)
    np.testing.assert_allclose(as_np(got), as_np(full), rtol=TOL[dtype],
                               atol=TOL[dtype])


def test_block_plan_equals_reference():
    for sq, skv in [(24, 24), (32, 32), (128, 128), (2048, 4096),
                    (600, 600), (4096, 1)]:
        assert attention.block_plan(sq, skv) == ref_attn.block_plan(sq, skv)


DECODE_CASES = [
    ("ragged", [40, 64], 0),
    ("empty and one", [0, 1], 0),
    ("full ring after wrapping", [64, 64], 0),
    ("window", [40, 64], 16),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case,lengths,window", DECODE_CASES)
def test_decode_attention_matches_reference(case, lengths, window, dtype):
    """A ring cache holds its positions in any slot order: a full ring
    (the lengths the model passes once ``pos + 1 > S_c``) attends to
    every slot."""
    rng = np.random.default_rng(4)
    q = rng.standard_normal((2, 1, 8, 32))
    kc = rng.standard_normal((2, 64, 4, 32))
    vc = rng.standard_normal((2, 64, 4, 32))
    (qj, qt), (kj, kt), (vj, vt) = (both(a, dtype) for a in (q, kc, vc))
    lens = np.asarray(lengths, np.int32)
    want = ref_attn.decode_attention(qj, kj, vj, jnp.asarray(lens),
                                     window=window)
    got = attention.decode_attention(qt, kt, vt, torch.from_numpy(lens),
                                     window=window)
    np.testing.assert_allclose(as_np(got), as_np(want), rtol=TOL[dtype],
                               atol=TOL[dtype])


def moe_params(rng, d, e, f, shared=0, tie_columns=False):
    p = {"router": rng.standard_normal((d, e)) * d ** -0.5,
         "w1": rng.standard_normal((e, d, f)) * d ** -0.5,
         "w3": rng.standard_normal((e, d, f)) * d ** -0.5,
         "w2": rng.standard_normal((e, f, d)) * f ** -0.5}
    if tie_columns:          # experts 1 and 3 score every token alike
        p["router"][:, 3] = p["router"][:, 1]
    if shared:
        fs = f * shared
        p.update(shared_w1=rng.standard_normal((d, fs)) * d ** -0.5,
                 shared_w3=rng.standard_normal((d, fs)) * d ** -0.5,
                 shared_w2=rng.standard_normal((fs, d)) * fs ** -0.5,
                 shared_gate=rng.standard_normal(d) * d ** -0.5)
    ref = {k: jnp.asarray(v, jnp.float32 if k == "router" else jnp.bfloat16)
           for k, v in p.items()}
    port = {k: torch.from_numpy(v.astype(np.float32)).to(
        torch.float32 if k == "router" else torch.bfloat16)
        for k, v in p.items()}
    return ref, port


MOE_CASES = [
    # name, tokens, experts, top_k, cap_factor, shared, tied columns
    ("dropless", 48, 8, 2, 8.0, 0, False),
    ("drops past capacity", 96, 8, 2, 0.5, 0, False),
    ("tied router scores", 48, 8, 2, 8.0, 0, True),
    ("tied and dropping, top 4", 64, 16, 4, 0.6, 0, True),
    ("shared experts (qwen2-moe)", 48, 8, 4, 1.25, 4, False),
]


@pytest.mark.parametrize("name,t,e,k,cap_factor,shared,tied", MOE_CASES)
def test_moe_ffn_matches_reference(name, t, e, k, cap_factor, shared,
                                   tied):
    rng = np.random.default_rng(5)
    d, f = 64, 32
    ref_p, port_p = moe_params(rng, d, e, f, shared, tied)
    xj, xt = both(rng.standard_normal((t, d)), "bfloat16")
    kw = dict(n_experts=e, top_k=k, cap_factor=cap_factor)
    out_r, logits_r, idx_r = ref_moe.moe_ffn(ref_p, xj, **kw)
    out_p, logits_p, idx_p = moe.moe_ffn(port_p, xt, **kw)
    np.testing.assert_array_equal(idx_p.numpy(), np.asarray(idx_r))
    np.testing.assert_allclose(logits_p.numpy(), np.asarray(logits_r),
                               rtol=1e-5, atol=1e-6)
    cap = moe.capacity(t, k, e, cap_factor)
    assert cap == ref_moe.capacity(t, k, e, cap_factor)
    grouped_r = ref_moe.group_tokens(idx_r, e, cap)
    grouped_p = moe.group_tokens(idx_p, e, cap)
    for a, b in zip(grouped_p, grouped_r):       # slot, keep, token, order
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    if cap_factor < 1:                           # tokens were dropped
        assert not grouped_p[1].numpy().all()
    if tied:                         # the lower index wins every tie
        assert not ((idx_p == 3).any(-1) & ~(idx_p == 1).any(-1)).any()
    np.testing.assert_allclose(as_np(out_p), as_np(out_r), rtol=2e-2,
                               atol=2e-2)


def test_router_topk_breaks_ties_by_lowest_index():
    logits = np.array([[0.5, 2.0, 1.0, 2.0, 1.0, 0.5]], np.float32)
    _, idx_r = ref_moe.router_topk(jnp.asarray(logits), 4)
    gates, idx = moe.router_topk(torch.from_numpy(logits), 4)
    assert idx.tolist() == [[1, 3, 2, 4]] == np.asarray(idx_r).tolist()
    assert gates.dtype == torch.float32 and idx.dtype == torch.int32


def test_aux_load_balance_loss_matches_reference():
    rng = np.random.default_rng(6)
    logits = rng.standard_normal((40, 8)).astype(np.float32)
    idx = rng.integers(0, 8, (40, 2)).astype(np.int32)
    want = ref_moe.aux_load_balance_loss(jnp.asarray(logits),
                                         jnp.asarray(idx), 8)
    got = moe.aux_load_balance_loss(torch.from_numpy(logits),
                                    torch.from_numpy(idx), 8)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
