"""The port's recurrent blocks against the reference's, on the CPU.

The same inputs and parameters, drawn with numpy from a seed, go
through ``repro.models.{rglru,rwkv6}`` (compiled with
``xla_allow_excess_precision`` off, so that XLA rounds bf16 where the
program rounds) and ``repro_torch.models.{rglru,rwkv6}``:

* the RG-LRU conv (four bf16 products summed in order) and the new conv
  state equal bit for bit;
* the port's float32 recurrence, one step at a time, against the
  reference's ``lax.associative_scan``: the two orders of float32
  products agree within rtol = 1e-5, atol = 1e-6 (SCAN_TOL);
* ``rglru_block`` / ``rglru_decode``: the state ``h`` within SCAN_TOL,
  ``conv`` equal, the bf16 outputs within one bf16 step (2e-2);
* ``_wkv_chunked`` and ``_wkv_sequential`` in float32 within 1e-4
  (WKV_TOL: einsums over 32-long chunks sum in another order), each
  with its final state;
* ``time_mix`` / ``channel_mix`` with their states: shifts equal, the
  wkv state within WKV_TOL, outputs within 2e-2;
* the chunk rule: both pick the chunked form exactly when not decoding
  and S % 32 == 0.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import rglru as ref_rg
from repro.models import rwkv6 as ref_rk

from repro_torch.models import rglru, rwkv6

EXACT_BF16 = {"xla_allow_excess_precision": False}
SCAN_TOL = dict(rtol=1e-5, atol=1e-6)
WKV_TOL = dict(rtol=1e-4, atol=1e-4)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)
D, B = 64, 2


def compiled(fn, *args):
    return jax.jit(fn).lower(*args).compile(compiler_options=EXACT_BF16)(
        *args)


def to_port(x):
    """A reference array (or a tree of them) as tensors, bits kept."""
    if isinstance(x, dict):
        return {k: to_port(v) for k, v in x.items()}
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return tuple(to_port(v) for v in x)
    arr = np.array(x)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def as_np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def bf16(rng, shape, scale=1.0):
    return jnp.asarray(rng.standard_normal(shape) * scale, jnp.bfloat16)


def rg_params(seed=0):
    """The reference's parameters with a random conv and bias (its init
    is a uniform conv, which would hide the order of the sum)."""
    rng = np.random.default_rng(seed)
    p = ref_rg.init_rglru_params(jax.random.PRNGKey(seed), D)
    p["conv_w"] = bf16(rng, (ref_rg.CONV_W, D), 0.5)
    p["conv_b"] = bf16(rng, (D,), 0.1)
    return p


def rg_state(rng):
    return ref_rg.RgState(
        h=jnp.asarray(rng.standard_normal((B, D)), jnp.float32),
        conv=bf16(rng, (B, ref_rg.CONV_W - 1, D)))


def test_conv1d_equals_reference():
    rng = np.random.default_rng(1)
    p, x, st = rg_params(), bf16(rng, (B, 9, D)), rg_state(rng)
    want, want_state = compiled(lambda p, x, c: ref_rg._conv1d(p, x, c),
                                p, x, st.conv)
    got, got_state = rglru._conv1d(to_port(p), to_port(x), to_port(st.conv))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(as_np(got), as_np(want))
    np.testing.assert_array_equal(as_np(got_state), as_np(want_state))


def test_linear_scan_matches_associative_scan():
    """The port's step-by-step recurrence against the reference's
    parallel scan with its virtual step 0 (decays in (0, 1))."""
    rng = np.random.default_rng(2)
    a = rng.uniform(0.5, 1.0, (B, 40, D)).astype(np.float32)
    b = rng.standard_normal((B, 40, D)).astype(np.float32)
    h0 = rng.standard_normal((B, D)).astype(np.float32)

    def ref(a, b, h0):
        a0 = jnp.concatenate([jnp.ones_like(a[:, :1]), a], axis=1)
        b0 = jnp.concatenate([h0[:, None, :], b], axis=1)
        return jax.lax.associative_scan(
            lambda l, r: (l[0] * r[0], l[1] * r[0] + r[1]), (a0, b0),
            axis=1)[1][:, 1:]

    want = compiled(ref, jnp.asarray(a), jnp.asarray(b), jnp.asarray(h0))
    got = rglru.linear_scan(torch.from_numpy(a), torch.from_numpy(b),
                            torch.from_numpy(h0))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **SCAN_TOL)


@pytest.mark.parametrize("seq", [1, 7, 33])
def test_rglru_block_matches_reference(seq):
    rng = np.random.default_rng(3)
    p, x, st = rg_params(), bf16(rng, (B, seq, D)), rg_state(rng)
    want, want_state = compiled(lambda p, x, s: ref_rg.rglru_block(p, x, s),
                                p, x, st)
    got, got_state = rglru.rglru_block(to_port(p), to_port(x),
                                       rglru.RgState(*to_port(st)))
    assert got.dtype == torch.bfloat16 and got_state.h.dtype == torch.float32
    np.testing.assert_allclose(as_np(got), as_np(want), **BF16_TOL)
    np.testing.assert_allclose(as_np(got_state.h), as_np(want_state.h),
                               **SCAN_TOL)
    np.testing.assert_array_equal(as_np(got_state.conv),
                                  as_np(want_state.conv))


def test_rglru_decode_matches_reference_and_the_block():
    """Decode steps from a carried state against the reference's, and the
    port's decode against its own block over the same tokens."""
    rng = np.random.default_rng(4)
    p, x, st = rg_params(), bf16(rng, (B, 5, D)), rg_state(rng)
    pt, state = to_port(p), rglru.RgState(*to_port(st))
    ref_state = st
    outs = []
    for t in range(x.shape[1]):
        want, ref_state = compiled(
            lambda p, x, s: ref_rg.rglru_decode(p, x, s), p, x[:, t:t + 1],
            ref_state)
        got, state = rglru.rglru_decode(pt, to_port(x[:, t:t + 1]), state)
        outs.append(got)
        np.testing.assert_allclose(as_np(got), as_np(want), **BF16_TOL)
        np.testing.assert_allclose(as_np(state.h), as_np(ref_state.h),
                                   **SCAN_TOL)
        np.testing.assert_array_equal(as_np(state.conv),
                                      as_np(ref_state.conv))
    whole, whole_state = rglru.rglru_block(pt, to_port(x),
                                           rglru.RgState(*to_port(st)))
    np.testing.assert_allclose(as_np(torch.cat(outs, 1)), as_np(whole),
                               **BF16_TOL)
    np.testing.assert_allclose(as_np(whole_state.h), as_np(state.h),
                               **SCAN_TOL)


def test_rglru_init_matches_reference():
    """The decay initialisation and the conv are the reference's."""
    want = ref_rg.init_rglru_params(jax.random.PRNGKey(0), D)
    p = rglru.RgLRU(D, device="cpu")
    rglru.init_rglru_params(p, torch.Generator().manual_seed(0))
    np.testing.assert_allclose(p.lam.numpy(), np.asarray(want["lam"]),
                               rtol=1e-5)
    np.testing.assert_array_equal(as_np(p.conv_w), as_np(want["conv_w"]))
    assert not p.conv_b.any()
    assert abs(float(p.w_x.float().std()) - D ** -0.5) < 0.1 * D ** -0.5


# ---------------------------------------------------------------------------
# RWKV6

HS = 16                 # head size: 4 heads of 16 at D = 64
FF = 96


def rk_params(seed=0):
    """The reference's parameters with random mixes, group norm and a
    spread of decays (its init makes them constant)."""
    rng = np.random.default_rng(seed)
    p = ref_rk.init_rwkv_params(jax.random.PRNGKey(seed), D, FF, HS)
    for name in [k for k in p if k.startswith("mu_")]:
        p[name] = jnp.asarray(rng.uniform(0, 1, D), jnp.bfloat16)
    p["ln_w"] = bf16(rng, p["ln_w"].shape, 0.1)
    p["ln_b"] = bf16(rng, p["ln_b"].shape, 0.1)
    p["w0"] = jnp.asarray(rng.uniform(-3, 0, D), jnp.float32)
    return p


def rk_state(rng):
    return ref_rk.RwkvState(
        s=jnp.asarray(rng.standard_normal((B, D // HS, HS, HS)) * 0.3,
                      jnp.float32),
        shift_t=bf16(rng, (B, D)), shift_c=bf16(rng, (B, D)))


def wkv_inputs(rng, seq):
    h = D // HS
    r, k, v = (rng.standard_normal((B, seq, h, HS)).astype(np.float32)
               for _ in range(3))
    w = rng.uniform(0.3, 0.999, (B, seq, h, HS)).astype(np.float32)
    u = (rng.standard_normal((h, HS)) * 0.1).astype(np.float32)
    s0 = (rng.standard_normal((B, h, HS, HS)) * 0.3).astype(np.float32)
    return r, k, v, w, u, s0


@pytest.mark.parametrize("form,seq", [("_wkv_chunked", 32),
                                      ("_wkv_chunked", 96),
                                      ("_wkv_sequential", 7),
                                      ("_wkv_sequential", 32)])
def test_wkv_forms_match_reference(form, seq):
    args = wkv_inputs(np.random.default_rng(5), seq)
    want, want_s = compiled(getattr(ref_rk, form),
                            *(jnp.asarray(a) for a in args))
    got, got_s = getattr(rwkv6, form)(*(torch.from_numpy(a) for a in args))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **WKV_TOL)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), **WKV_TOL)


def test_wkv_chunked_equals_sequential():
    args = [torch.from_numpy(a) for a in
            wkv_inputs(np.random.default_rng(6), 64)]
    out_c, s_c = rwkv6._wkv_chunked(*args)
    out_s, s_s = rwkv6._wkv_sequential(*args)
    np.testing.assert_allclose(out_c.numpy(), out_s.numpy(), **WKV_TOL)
    np.testing.assert_allclose(s_c.numpy(), s_s.numpy(), **WKV_TOL)


@pytest.mark.parametrize("seq,chunked", [(32, True), (64, True), (24, True),
                                         (1, False), (32, False)])
def test_time_mix_and_channel_mix_match_reference(seq, chunked):
    rng = np.random.default_rng(7)
    p, x, st = rk_params(), bf16(rng, (B, seq, D)), rk_state(rng)

    def ref(p, x, st):
        y, st = ref_rk.time_mix(p, x, st, chunked=chunked)
        z, st = ref_rk.channel_mix(p, y, st)
        return y, z, st

    want_y, want_z, want_st = compiled(ref, p, x, st)
    pt = to_port(p)
    got_y, state = rwkv6.time_mix(pt, to_port(x),
                                  rwkv6.RwkvState(*to_port(st)),
                                  chunked=chunked)
    # the channel mix on the reference's time-mix output, so that each is
    # held alone
    got_z, state = rwkv6.channel_mix(pt, to_port(want_y), state)
    assert got_y.dtype == got_z.dtype == torch.bfloat16
    np.testing.assert_allclose(as_np(got_y), as_np(want_y), **BF16_TOL)
    np.testing.assert_allclose(as_np(got_z), as_np(want_z), **BF16_TOL)
    np.testing.assert_allclose(as_np(state.s), as_np(want_st.s), **WKV_TOL)
    np.testing.assert_array_equal(as_np(state.shift_t),
                                  as_np(want_st.shift_t))
    np.testing.assert_array_equal(as_np(state.shift_c),
                                  as_np(want_st.shift_c))


@pytest.mark.parametrize("seq,chunked", [(32, True), (64, True), (24, True),
                                         (33, True), (1, False),
                                         (32, False)])
def test_chunk_rule_matches_reference(monkeypatch, seq, chunked):
    """Both take the chunked form exactly when ``chunked`` (not decode)
    and S is a multiple of 32."""
    picked = {}
    for tag, mod in (("ref", ref_rk), ("port", rwkv6)):
        for form in ("_wkv_chunked", "_wkv_sequential"):
            real = getattr(mod, form)

            def spy(*a, _real=real, _form=form, _tag=tag):
                picked[_tag] = _form
                return _real(*a)
            monkeypatch.setattr(mod, form, spy)
    rng = np.random.default_rng(8)
    p, x, st = rk_params(), bf16(rng, (B, seq, D)), rk_state(rng)
    ref_rk.time_mix(p, x, st, chunked=chunked)
    rwkv6.time_mix(to_port(p), to_port(x), rwkv6.RwkvState(*to_port(st)),
                   chunked=chunked)
    want = "_wkv_chunked" if chunked and seq % 32 == 0 else "_wkv_sequential"
    assert picked == {"ref": want, "port": want}


def test_rwkv_init_matches_reference():
    want = ref_rk.init_rwkv_params(jax.random.PRNGKey(0), D, FF, HS)
    p = rwkv6.Rwkv(D, FF, HS, device="cpu")
    rwkv6.init_rwkv_params(p, torch.Generator().manual_seed(0))
    got = dict(p.named_parameters())
    assert sorted(got) == sorted(want)
    for name, leaf in want.items():
        assert tuple(got[name].shape) == leaf.shape, name
        assert str(got[name].dtype).split(".")[1] == str(leaf.dtype), name
    for name in ["w0", "ln_w", "ln_b"] + [k for k in want if
                                          k.startswith("mu_")]:
        np.testing.assert_array_equal(as_np(got[name]), as_np(want[name]))
