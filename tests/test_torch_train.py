"""The port's policy-head training against the JAX reference.

* ``extract_features`` is the reference's numpy code: equal exactly;
* ``models.policy_head`` (``apply``, ``bce_loss``) from the reference's
  initial parameters (``convert.policy_head_from``) within 1e-6 of
  ``repro.models.policy_head``, the gradient within 5e-5: the port adds
  in a fixed order of its own and its ``exp`` is a polynomial within
  1 ulp of the library's;
* one ``optim.adamw.update`` from the same gradients and state within
  1e-6 of the reference's (the schedule's ``pow``/``cos`` may round
  differently in the last bit); the ``AdamW`` optimizer steps exactly as
  ``update``; ``_decay_mask`` decides as the reference for each name;
* ``train_head`` for both kinds, 400 full-batch steps from the
  reference's seed-0 parameters, against a fresh reference run. Both
  use the same formulas, so the first step agrees to float32 rounding;
  Adam's normalised step then carries last-bit differences forward.
  Measured over 400 steps of the quick corpus (11,250 samples): logreg
  parameters within 1.5e-4 (of weights up to 8.4) and losses within
  4.2e-7; the MLP, whose near-dead hidden units see tiny gradients that
  Adam scales up to full steps, parameters within 0.034 (of weights up
  to 9.8) and losses within 1.1e-4. The tolerances below are three to
  ten times those;
* ``params_to_weights`` lays out the reference's tuples.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.learn import train as rt
from repro.learn.policy import params_to_weights as ref_params_to_weights
from repro.models import policy_head as rph
from repro.optim import adamw as radamw
from repro.traces import build_corpus, corpus_specs
from repro.traces.synthetic import stack_padded

from repro_torch.convert import policy_head_from
from repro_torch.learn import train as pt
from repro_torch.learn.policy import LearnedConfig, params_to_weights
from repro_torch.models import PolicyHead
from repro_torch.models import policy_head as pph
from repro_torch.optim import AdamW, AdamWConfig, adamw as padamw

KINDS = ("logreg", "mlp")
# 400 steps from the same start (see the module docstring)
TRAIN_TOL = {"logreg": {"params": 5e-4, "loss": 5e-6},
             "mlp": {"params": 0.1, "loss": 5e-4}}
STEP_TOL = 1e-6         # one step, one update, one forward
# a gradient is a float32 sum over 11,250 samples whose terms cancel,
# added in another order than XLA's: measured within 1.6e-5
GRAD_TOL = 5e-5


@pytest.fixture(scope="module")
def quick_features():
    _, blocks, lengths = stack_padded(build_corpus(
        corpus_specs(4000, "quick")))
    return rt.extract_features(blocks, lengths, stride=4)


def ref_init(kind, seed=0):
    return {k: np.asarray(v) for k, v in
            rph.init_params(kind, seed=seed).items()}


@pytest.mark.parametrize("stride,horizon,lookahead",
                         [(1, 1024, 100), (4, 1024, 100), (3, 64, 8)])
def test_extract_features_equals_reference(stride, horizon, lookahead):
    _, blocks, lengths = stack_padded(build_corpus(
        corpus_specs(700, "quick")))
    lengths = lengths.copy()
    lengths[0] = 1                       # a trace too short to sample
    want = rt.extract_features(blocks, lengths, horizon, lookahead, stride)
    got = pt.extract_features(blocks, lengths, horizon, lookahead, stride)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    assert got[0].shape[1] == 4 and len(got[0]) == len(got[1]) > 0


@pytest.mark.parametrize("kind", KINDS)
def test_apply_loss_and_gradient_equal_reference(kind, quick_features):
    x, y = quick_features
    init = ref_init(kind, seed=3)
    params = {k: v.clone().requires_grad_(True)
              for k, v in policy_head_from(init, "cpu").items()}
    jp = {k: jnp.asarray(v) for k, v in init.items()}
    np.testing.assert_allclose(
        pph.apply(kind, params, torch.as_tensor(x)).detach().numpy(),
        np.asarray(rph.apply(kind, jp, jnp.asarray(x))),
        rtol=STEP_TOL, atol=STEP_TOL)
    loss = pph.bce_loss(kind, params, torch.as_tensor(x), torch.as_tensor(y))
    loss.backward()
    ref_loss, ref_grads = jax.value_and_grad(
        lambda p: rph.bce_loss(kind, p, jnp.asarray(x), jnp.asarray(y)))(jp)
    assert abs(loss.item() - float(ref_loss)) <= STEP_TOL
    for k in init:
        np.testing.assert_allclose(params[k].grad.numpy(),
                                   np.asarray(ref_grads[k]),
                                   rtol=1e-5, atol=GRAD_TOL, err_msg=k)


def test_fixed_order_helpers():
    v = torch.arange(1, 1001, dtype=torch.float32)
    assert float(padamw.tree_sum(v)) == 500500.0
    assert torch.equal(padamw.tree_sum(torch.ones(5, 3)), torch.full((3,),
                                                                      5.0))
    assert float(padamw.tree_sum(torch.tensor([2.5]))) == 2.5
    x = -torch.linspace(0, 79, 200_001)
    got, want = pph.exp_nonpos(x).double(), torch.exp(x.double())
    assert float(((got - want).abs() / want).max()) < 2 ** -23
    assert float(pph.exp_nonpos(torch.tensor(-200.0))) > 0


@pytest.mark.parametrize("step", [1, 7, 20, 150, 400])
def test_schedule_equals_reference(step):
    cfg = AdamWConfig(lr=0.05, warmup_steps=20, total_steps=400)
    rcfg = radamw.AdamWConfig(lr=0.05, warmup_steps=20, total_steps=400)
    got = float(padamw.schedule(cfg, torch.tensor(step, dtype=torch.int32)))
    want = float(radamw.schedule(rcfg, jnp.int32(step)))
    assert got == pytest.approx(want, rel=1e-6, abs=1e-9)


@pytest.mark.parametrize("wd,clip", [(0.0, 1.0), (0.1, 0.05)])
@pytest.mark.parametrize("kind", KINDS)
def test_one_update_equals_reference(kind, wd, clip):
    rng = np.random.default_rng(5)
    init = ref_init(kind, seed=1)
    grads = {k: rng.normal(size=v.shape).astype(np.float32)
             for k, v in init.items()}
    kw = dict(lr=0.05, weight_decay=wd, clip_norm=clip, warmup_steps=3,
              total_steps=10)
    rcfg, cfg = radamw.AdamWConfig(**kw), AdamWConfig(**kw)
    rstate = radamw.init({k: jnp.asarray(v) for k, v in init.items()})
    pstate = padamw.init(policy_head_from(init, "cpu"))
    rparams = {k: jnp.asarray(v) for k, v in init.items()}
    pparams = policy_head_from(init, "cpu")
    for _ in range(2):               # the second step has moments
        rparams, rstate, rm = radamw.update(
            rcfg, {k: jnp.asarray(v) for k, v in grads.items()}, rstate,
            rparams)
        pparams, pstate, pm = padamw.update(
            cfg, policy_head_from(grads, "cpu"), pstate, pparams)
        for k in init:
            np.testing.assert_allclose(pparams[k].numpy(),
                                       np.asarray(rparams[k]),
                                       rtol=STEP_TOL, atol=STEP_TOL,
                                       err_msg=k)
            np.testing.assert_allclose(pstate.m[k].numpy(),
                                       np.asarray(rstate.m[k]), rtol=1e-6)
            np.testing.assert_allclose(pstate.v[k].numpy(),
                                       np.asarray(rstate.v[k]), rtol=1e-6)
        assert float(pm["grad_norm"]) == pytest.approx(
            float(rm["grad_norm"]), rel=1e-6)
        assert float(pm["lr"]) == pytest.approx(float(rm["lr"]), rel=1e-6)
    assert int(pstate.step) == int(rstate.step) == 2


NAMES = ["w", "b", "w1", "b1", "w2", "b2", "ln_f/scale", "blocks/attn/wq",
         "mlp/bias", "emb/w0", "mixer/lam", "x/mu_k", "router/u",
         "norm", "proj/b_out", "layer0/wqkv"]


def test_decay_mask_equals_reference():
    for name in NAMES:
        tree = {}
        node = tree
        parts = name.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = 0.0
        (path, _), = jax.tree_util.tree_flatten_with_path(tree)[0]
        assert padamw._decay_mask(name) == radamw._decay_mask(path), name


def test_optimizer_steps_as_update():
    """AdamW(named params).step() is the functional update, bit for bit,
    with decay on the names _decay_mask allows."""
    init = ref_init("mlp", seed=2)
    cfg = AdamWConfig(lr=0.05, weight_decay=0.1, warmup_steps=2,
                      total_steps=6)
    head = PolicyHead("mlp", policy_head_from(init, "cpu"))
    opt = AdamW(head, cfg)
    params = policy_head_from(init, "cpu")
    state = padamw.init(params)
    x = torch.rand(64, 4, generator=torch.Generator().manual_seed(0))
    y = (torch.rand(64, generator=torch.Generator().manual_seed(1))
         > 0.5).float()
    for _ in range(4):
        opt.zero_grad()
        head.loss(x, y).backward()
        opt.step()
        p = {k: v.clone().requires_grad_(True) for k, v in params.items()}
        pph.bce_loss("mlp", p, x, y).backward()
        params, state, _ = padamw.update(cfg, {k: v.grad for k, v in
                                               p.items()}, state, params)
        for k, v in head.named_parameters():
            assert torch.equal(v.detach(), params[k]), k
    assert set(opt.metrics) == {"grad_norm", "lr"}
    with pytest.raises(ValueError, match="named"):
        AdamW([torch.nn.Parameter(torch.zeros(2))], cfg)


@pytest.mark.parametrize("kind", KINDS)
def test_train_head_equals_reference(kind, quick_features):
    x, y = quick_features
    init = ref_init(kind)
    for steps in (1, 400):
        rparams, rloss = rt.train_head(kind, x, y, steps=steps, seed=0)
        pparams, ploss = pt.train_head(kind, x, y, steps=steps,
                                       init=policy_head_from(init, "cpu"),
                                       device="cpu")
        tol = TRAIN_TOL[kind] if steps > 1 else {"params": STEP_TOL,
                                                 "loss": STEP_TOL}
        assert len(ploss) == len(rloss) == steps
        assert np.max(np.abs(np.asarray(ploss) - np.asarray(rloss))) \
            <= tol["loss"]
        for k in rparams:
            assert pparams[k].dtype == torch.float32
            np.testing.assert_allclose(pparams[k].numpy(),
                                       np.asarray(rparams[k]), rtol=0,
                                       atol=tol["params"], err_msg=k)
    assert ploss[-1] < ploss[0]


def test_train_head_repeats_bit_for_bit(quick_features):
    x, y = quick_features
    a = pt.train_head("mlp", x[:2000], y[:2000], steps=30, seed=4,
                      device="cpu")
    b = pt.train_head("mlp", x[:2000], y[:2000], steps=30, seed=4,
                      device="cpu")
    assert a[1] == b[1]
    assert all(torch.equal(a[0][k], b[0][k]) for k in a[0])
    c = pt.train_head("mlp", x[:2000], y[:2000], steps=30, seed=5,
                      device="cpu")
    assert c[1] != a[1]


@pytest.mark.parametrize("kind", KINDS)
def test_params_to_weights_layout_equals_reference(kind):
    init = ref_init(kind, seed=7)
    want = ref_params_to_weights(kind, {k: jnp.asarray(v)
                                        for k, v in init.items()})
    tensors = policy_head_from(init, "cpu")
    assert params_to_weights(kind, tensors) == want
    assert params_to_weights(kind, init) == want
    assert params_to_weights(kind, PolicyHead(kind, tensors).params()) == \
        want
    LearnedConfig(kind=kind, weights=want)       # a valid config


def test_init_params_and_head():
    for kind, names in (("logreg", ["w", "b"]),
                        ("mlp", ["w1", "b1", "w2", "b2"])):
        a = pph.init_params(kind, torch.Generator().manual_seed(9))
        b = pph.init_params(kind, torch.Generator().manual_seed(9))
        assert list(a) == names
        assert all(torch.equal(a[k], b[k]) and a[k].dtype == torch.float32
                   for k in a)
        assert [n for n, _ in PolicyHead(kind, a).named_parameters()] == \
            names
        ref = ref_init(kind)
        assert {k: v.shape for k, v in a.items()} == \
            {k: tuple(v.shape) for k, v in ref.items()}
    with pytest.raises(ValueError, match="kind"):
        pph.init_params("tree")
    with pytest.raises(TypeError, match="float32"):
        policy_head_from({"w": np.zeros(4, np.float64)}, "cpu")


def test_train_configs_small():
    cfgs = pt.train_configs("quick", 600, steps=20, seed=0, stride=4,
                            device="cpu")
    assert set(cfgs) == set(KINDS)
    assert cfgs["mlp"].hidden == 8 and len(cfgs["logreg"].weights) == 5
    again = pt.train_configs("quick", 600, steps=20, seed=0, stride=4,
                             device="cpu")
    assert again == cfgs
    assert dataclasses.replace(cfgs["logreg"]) == cfgs["logreg"]


def test_train_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    x = np.zeros((4, 4), np.float32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pt.train_head("logreg", x, np.zeros(4, np.float32), steps=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pt.train_configs("quick", 100, steps=1)
