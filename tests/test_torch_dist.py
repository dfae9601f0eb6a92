"""The port's distribution layer against the reference's, on the CPU.

* The spec rules (``dist.sharding``) entry by entry against the
  reference's for the reduced configs of all ten architectures on the
  reference tests' fake (2, 4) and (2, 4, 4) meshes (no devices): a
  per-layer parameter's spec is the reference's spec of its stacked
  leaf without the stack entry.
* The logical-axis context (``dist.ctx``): nesting, teardown on error,
  the divisibility drop against the reference's ``resolve``, the rank
  check; ``plan_remesh``'s count against one made from the reference's
  own specs (the reference reports 1 for any parameter dict).
* One spawned gloo group per world size (2: a (1, 2) mesh; 4: (2, 2))
  through a ``FileStore`` in ``tmp_path``, every collective check in it
  (``_torch_dist_worker.py``): TP and EP MoE against the port's and the
  reference's dense ``moe_ffn`` at the reference's tolerances (expert
  choices equal, logits 1e-5, outputs 2e-2); the reduced mixtral under a
  context against none (5e-2, the reference's); ``compressed_psum``
  against the int8 sum; ``jit_cell``'s train, prefill and decode steps
  against the plain steps; ``restore(shardings=)``; ``ring_put``.

The lane-sharded sweep is held in ``test_torch_dist_sweep.py``.
"""

import dataclasses
import json
import multiprocessing as mp
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs import ARCHS as REF_ARCHS
from repro.configs import reduced_config as ref_reduced
from repro.dist import sharding as rshd
from repro.dist.ctx import resolve as ref_resolve
from repro.dist.ctx import sharding_ctx as ref_ctx
from repro.launch.specs import batch_sds as ref_batch_sds
from repro.launch.specs import cache_sds as ref_cache_sds
from repro.launch.specs import opt_sds as ref_opt_sds
from repro.launch.specs import params_sds as ref_params_sds
from repro.models import init_params as ref_init
from repro.models.lm import _init_moe
from repro.models.moe import moe_ffn as ref_moe_ffn

from repro_torch.checkpoint import elastic
from repro_torch.configs import ARCHS, reduced_config
from repro_torch.convert import lm_params_from, lm_state_names
from repro_torch.dist import sharding as shd
from repro_torch.dist.ctx import constrain, current, resolve, sharding_ctx
from repro_torch.launch import specs as pspecs

sys.path.insert(0, os.path.dirname(__file__))
import _ref_moe_ep_worker as ref_ep_worker  # noqa: E402
import _torch_dist_worker as worker  # noqa: E402

EXACT_BF16 = {"xla_allow_excess_precision": False}


class FakeMesh:
    """The reference tests' mesh stand-in: the rules read only
    ``axis_names`` and ``devices.shape``."""

    def __init__(self, shape, axes):
        self.devices = np.empty(shape, object)
        self.axis_names = axes


MESHES = {"8": FakeMesh((2, 4), ("data", "model")),
          "pod": FakeMesh((2, 4, 4), ("pod", "data", "model"))}
STRATEGIES = ("fsdp", "2d", "tp", "tp_serve", "replicated")


def ref_leaves(specs):
    return jax.tree.leaves(specs, is_leaf=lambda x: isinstance(x, P))


def as_tuple(spec):
    return tuple(spec)


def ref_spec_of(ref_specs, path):
    """The reference spec of a port parameter's reference path; a
    per-layer leaf's without its stack entry."""
    leaf = ref_specs
    layer = isinstance(path[-1], int) and path[0] in ("blocks",
                                                      "enc_blocks")
    for key in (path[:-1] if layer else path):
        leaf = leaf[key]
    spec = as_tuple(leaf)
    return spec[1:] if layer else spec


# ---------------------------------------------------------------------------
# spec rules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_param_and_opt_specs_match_reference(arch, mesh):
    m = MESHES[mesh]
    cfg = reduced_config(ARCHS[arch])
    ref_cfg = ref_reduced(REF_ARCHS[arch])
    model = pspecs.params_sds(cfg)
    ref_params = ref_params_sds(ref_cfg)
    names = lm_state_names(cfg)
    n_sharded = 0
    for strategy in STRATEGIES:
        got = shd.param_specs(model, m, strategy)
        want = rshd.param_specs(ref_params, m, strategy)
        assert sorted(got) == sorted(names)
        for name, spec in got.items():
            assert len(spec) == model.get_parameter(name).dim()
            assert spec == ref_spec_of(want, names[name]), (strategy, name)
        n_sharded += sum(shd.spec_names_axis(s) for s in got.values())
    assert n_sharded > 0
    pspec = shd.param_specs(model, m)
    ospec = shd.opt_specs(pspecs.opt_sds(cfg, model), pspec, m)
    ref_o = rshd.opt_specs(ref_opt_sds(ref_cfg),
                           rshd.param_specs(ref_params, m), m)
    assert ospec.step == as_tuple(ref_o.step) == ()
    for field in ("master", "m", "v"):
        for name, spec in getattr(ospec, field).items():
            assert spec == ref_spec_of(getattr(ref_o, field), names[name])


def flatten(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in flatten(tree[k])]
    if isinstance(tree, (list, tuple)) and not shd._is_spec(tree):
        return [x for v in tree for x in flatten(v)]
    return [tree]


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_batch_and_cache_specs_match_reference(arch, mesh):
    m = MESHES[mesh]
    cfg = reduced_config(ARCHS[arch])
    ref_cfg = ref_reduced(REF_ARCHS[arch])
    for b, s in ((8, 64), (3, 40)):
        got = shd.batch_specs(pspecs.batch_sds(cfg, b, s), m)
        want = rshd.batch_specs(ref_batch_sds(ref_cfg, b, s), m)
        assert sorted(got) == sorted(want)
        assert all(got[k] == as_tuple(want[k]) for k in got)
        cache = pspecs.cache_sds(cfg, b, s)
        got = flatten(shd.cache_specs(cache, m))
        want = [as_tuple(x) for x in ref_leaves(
            rshd.cache_specs(ref_cache_sds(ref_cfg, b, s), m))]
        assert got == want
        assert [len(x) for x in got] == [t.dim() for t in flatten(cache)]


LANE_MESHES = [FakeMesh((4,), ("lanes",)), FakeMesh((2, 4), ("data",
                                                             "model")),
               FakeMesh((8,), ("lanes",))]


@pytest.mark.parametrize("mesh", range(len(LANE_MESHES)))
def test_lane_ring_and_occupancy_specs_match_reference(mesh):
    m = LANE_MESHES[mesh]
    shapes = [(16,), (16, 8), (12, 3, 2), (7,), (256, 16), (4, 12), ()]
    tree = {f"x{i}": torch.empty(s) for i, s in enumerate(shapes)}
    ref_tree = {f"x{i}": np.empty(s) for i, s in enumerate(shapes)}
    for fn, ref_fn in ((shd.lane_specs, rshd.lane_specs),
                       (shd.ring_specs, rshd.ring_specs),
                       (shd.occupancy_specs, rshd.occupancy_specs)):
        got, want = fn(tree, m), ref_fn(ref_tree, m)
        assert {k: v for k, v in got.items()} == {
            k: as_tuple(v) for k, v in want.items()}, fn.__name__


def test_unknown_strategy_raises():
    with pytest.raises(ValueError, match="unknown strategy"):
        shd.param_specs({"w": torch.empty(4, 4)}, MESHES["8"], "bogus")


# ---------------------------------------------------------------------------
# the context
# ---------------------------------------------------------------------------

def test_ctx_nesting_and_teardown_on_error():
    assert current() is None
    with sharding_ctx(MESHES["8"]) as outer:
        assert current() is outer and outer.dp_axes == ("data",)
        with sharding_ctx(MESHES["pod"], dp_axes=("pod",)) as inner:
            assert current() is inner
            assert inner.logical_sizes() == {"dp": 2, "tp": 4}
        assert current() is outer
        with pytest.raises(RuntimeError, match="boom"):
            with sharding_ctx(MESHES["pod"]):
                raise RuntimeError("boom")
        assert current() is outer
    assert current() is None


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_resolve_matches_reference_with_divisibility_drop(mesh):
    m = MESHES[mesh]
    cases = [((8, 16, 4), ("dp", "tp", None)),
             ((3, 16, 4), ("dp", "tp", None)),      # batch does not divide
             ((8, 6, 4), ("dp", "tp", None)),       # seq does not divide
             ((8, 16), ("model", "data")),          # explicit axis names
             ((8, 16), ("pod", None)),
             ((8, 16), ("lanes", "tp"))]            # absent axis: dropped
    for dp_axes in (None, ("data",)):
        with sharding_ctx(m, dp_axes=dp_axes) as ctx, \
                ref_ctx(m, dp_axes=dp_axes) as rctx:
            for shape, axes in cases:
                assert resolve(ctx, shape, axes) == as_tuple(
                    ref_resolve(rctx, shape, axes)), (shape, axes)


def test_constrain_identity_outside_ctx_and_rank_check():
    x = torch.ones(4, 8, 2)
    assert constrain(x, ("dp", "tp", None)) is x
    with sharding_ctx(MESHES["8"]):
        assert constrain(x, ("dp", "tp", None)) is x     # a plain tensor
        with pytest.raises(ValueError, match="logical axes"):
            constrain(torch.ones(2, 2), ("dp",))


@pytest.mark.parametrize("arch", ["llama3.2-3b", "mixtral-8x7b",
                                  "whisper-medium"])
def test_plan_remesh_counts_the_leaves_whose_spec_names_an_axis(arch):
    cfg = reduced_config(ARCHS[arch])
    ref_params = ref_params_sds(ref_reduced(REF_ARCHS[arch]))
    model = pspecs.params_sds(cfg)
    names = lm_state_names(cfg)
    for m in MESHES.values():
        want = rshd.param_specs(ref_params, m)
        n = sum(any(e is not None for e in ref_spec_of(want, path))
                for path in names.values())
        plan = elastic.plan_remesh(model, (1, 1), m)
        assert plan["leaves_sharded"] == n > 1
        assert plan["leaves"] == len(names)
        assert plan["new_mesh"] == list(m.devices.shape)
        assert plan["n_devices"] == int(np.prod(m.devices.shape))


def test_router_bias_mask_matches_reference():
    """``moe_ffn``'s ``router_bias_mask`` (the reference's: it masks
    expert-parallel padding experts) masks the same experts."""
    cfg = ref_reduced(REF_ARCHS["mixtral-8x7b"])
    p = _init_moe(cfg, jax.random.PRNGKey(4))
    x = jax.random.normal(jax.random.PRNGKey(5), (32, cfg.d_model),
                          jnp.float32).astype(jnp.bfloat16)
    mask = np.where(np.arange(cfg.n_experts) % 3 == 0, -1e9, 0.0).astype(
        np.float32)
    kw = dict(n_experts=cfg.n_experts, top_k=cfg.top_k, cap_factor=4.0)
    want = jax.jit(lambda p, x, m: ref_moe_ffn(p, x, router_bias_mask=m,
                                               **kw)).lower(
        p, x, mask).compile(compiler_options=EXACT_BF16)(p, x, mask)
    from repro_torch.models.moe import moe_ffn
    tp = {k: torch.from_numpy(np.array(v, np.float32)) for k, v in
          p.items()}
    tp = {k: (v if k == "router" else v.bfloat16()) for k, v in tp.items()}
    got = moe_ffn(tp, torch.from_numpy(np.asarray(x, np.float32)).bfloat16(),
                  router_bias_mask=torch.from_numpy(mask), **kw)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    assert not np.isin(got[2].numpy(), np.flatnonzero(mask)).any()
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got[0].float().numpy(),
                               np.asarray(want[0], np.float32), rtol=2e-2,
                               atol=2e-2)


# ---------------------------------------------------------------------------
# collectives in spawned gloo groups
# ---------------------------------------------------------------------------

MOE_ARCHS = {"mixtral": "mixtral-8x7b", "qwen2moe": "qwen2-moe-a2.7b"}
GROUPS = {2: (1, 2), 4: (2, 2)}
_RESULTS = {}


def _write_inputs(tmp):
    """The reference's MoE weights, tokens and dense outputs, and the
    reduced mixtral's weights, for the workers."""
    data, want = {}, {}
    for i, (tag, arch) in enumerate(MOE_ARCHS.items()):
        cfg = ref_reduced(REF_ARCHS[arch])
        p = _init_moe(cfg, jax.random.PRNGKey(2 * i))
        x = jax.random.normal(jax.random.PRNGKey(2 * i + 1),
                              (64, cfg.d_model), jnp.float32).astype(
            jnp.bfloat16)
        for k, v in p.items():
            data[f"{tag}/{k}"] = np.asarray(v, np.float32)
        data[f"x/{tag}"] = np.asarray(x, np.float32)
        data[f"E/{tag}"], data[f"K/{tag}"] = cfg.n_experts, cfg.top_k
        kw = dict(n_experts=cfg.n_experts, top_k=cfg.top_k, cap_factor=4.0)
        fn = jax.jit(lambda p, x: ref_moe_ffn(p, x, **kw)).lower(
            p, x).compile(compiler_options=EXACT_BF16)
        want[tag] = [np.asarray(t, np.float32) for t in fn(p, x)]
    np.savez(os.path.join(tmp, "moe_in.npz"), **data)
    cfg = dataclasses.replace(reduced_config(ARCHS["mixtral-8x7b"]),
                              n_layers=2, layer_pattern=("attn",))
    ref_cfg = dataclasses.replace(ref_reduced(REF_ARCHS["mixtral-8x7b"]),
                                  n_layers=2, layer_pattern=("attn",))
    params = ref_init(ref_cfg, jax.random.PRNGKey(0))
    model = lm_params_from(jax.tree.map(np.asarray, params), cfg,
                           device="cpu")
    torch.save(model.state_dict(), os.path.join(tmp, "mixtral.pt"))
    np.save(os.path.join(tmp, "mixtral_tok.npy"),
            np.random.default_rng(1).integers(0, cfg.vocab, (2, 16)).astype(
                np.int32))
    return want


def group_results(world, tmp_path_factory):
    """Spawn the ``world`` ranks once (per world size and session) and
    collect what each measured."""
    if "inputs" not in _RESULTS:
        inputs = str(tmp_path_factory.mktemp("gloo_inputs"))
        _RESULTS["inputs"] = (inputs, _write_inputs(inputs))
    inputs, want = _RESULTS["inputs"]
    if world not in _RESULTS:
        tmp = str(tmp_path_factory.mktemp(f"gloo{world}"))
        for name in os.listdir(inputs):
            os.symlink(os.path.join(inputs, name), os.path.join(tmp, name))
        ctx = mp.get_context("spawn")
        procs = [ctx.Process(target=worker.main,
                             args=(r, world, tmp, GROUPS[world]))
                 for r in range(world)]
        for p in procs:
            p.start()
        for p in procs:
            p.join(timeout=300)
        alive = [p for p in procs if p.is_alive()]
        for p in alive:
            p.kill()
        assert not alive, "a rank did not finish in 300 s"
        assert [p.exitcode for p in procs] == [0] * world
        ranks = []
        for r in range(world):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
        with np.load(os.path.join(tmp, "moe_out.npz")) as z:
            outs = {k: z[k] for k in z.files}
        _RESULTS[world] = (ranks, outs, want)
    return _RESULTS[world]


@pytest.mark.parametrize("world", sorted(GROUPS))
def test_tp_and_ep_moe_match_dense(world, tmp_path_factory):
    ranks, outs, want = group_results(world, tmp_path_factory)
    for tag in MOE_ARCHS:
        for impl in ("tp", "ep"):
            for r in ranks:
                got = r["moe"][f"{tag}/{impl}"]
                assert got["idx_equal_dense"], (tag, impl)
                assert got["logits_err_dense"] <= 1e-5, (tag, impl, got)
            out, logits, idx = (outs[f"{tag}/{impl}/{i}"] for i in range(3))
            np.testing.assert_allclose(out, outs[f"{tag}/dense/0"],
                                       rtol=2e-2, atol=2e-2,
                                       err_msg=f"{tag} {impl}: port dense")
            ref_out, ref_logits, ref_idx = want[tag]
            np.testing.assert_array_equal(idx, ref_idx)
            np.testing.assert_allclose(logits, ref_logits, rtol=1e-5,
                                       atol=1e-5)
            np.testing.assert_allclose(out, ref_out, rtol=2e-2, atol=2e-2,
                                       err_msg=f"{tag} {impl}")


def ref_ep_results(tmp_path_factory) -> dict:
    """The reference's ``moe_ffn_ep`` on the groups' mesh shapes, at
    capacity factors 1.25 and 4.0 (a spawned JAX process with four host
    devices, once per session)."""
    if "ref_ep" not in _RESULTS:
        group_results(min(GROUPS), tmp_path_factory)     # writes the inputs
        inputs = _RESULTS["inputs"][0]
        proc = mp.get_context("spawn").Process(target=ref_ep_worker.main,
                                               args=(inputs,))
        proc.start()
        proc.join(timeout=300)
        if proc.is_alive():
            proc.kill()
        assert proc.exitcode == 0
        with np.load(os.path.join(inputs, "ref_ep.npz")) as z:
            _RESULTS["ref_ep"] = {k: z[k] for k in z.files}
    return _RESULTS["ref_ep"]


def dropped_rows(at_cap, dropless):
    """Tokens that lost an expert's contribution: rows of the output at
    a capacity factor that differ from the dropless output (factor 4.0)
    by more than the bf16 tolerance of the comparison."""
    return np.flatnonzero(np.abs(at_cap - dropless).max(-1) > 5e-2)


@pytest.mark.parametrize("cap", [1.25, 0.5])
@pytest.mark.parametrize("world", sorted(GROUPS))
def test_ep_capacity_matches_reference(world, cap, tmp_path_factory):
    """EP below the dropless factor, where its two capacities (a
    source's slots per destination shard, then a resident expert's)
    drop tokens: at the configs' 1.25 and at 0.5, the same expert
    choices as the reference's ``moe_ffn_ep`` on the same mesh shape,
    the same dropped tokens, and outputs within 2e-2."""
    _, outs, _ = group_results(world, tmp_path_factory)
    ref = ref_ep_results(tmp_path_factory)
    n_drops = 0
    for tag in MOE_ARCHS:
        out, logits, idx = (outs[f"{tag}/ep{cap}/{i}"] for i in range(3))
        want = [ref[f"{tag}/{world}/{cap}/{i}"] for i in range(3)]
        np.testing.assert_array_equal(idx, want[2])
        np.testing.assert_allclose(logits, want[1], rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(out, want[0], rtol=2e-2, atol=2e-2,
                                   err_msg=tag)
        drops = dropped_rows(out, outs[f"{tag}/ep/0"])
        np.testing.assert_array_equal(
            drops, dropped_rows(want[0], ref[f"{tag}/{world}/4.0/0"]))
        n_drops += drops.size
    # the reduced inputs' 64 tokens fit at 1.25; at 0.5 both stages drop
    assert n_drops > 0 or cap > 1


@pytest.mark.parametrize("world", sorted(GROUPS))
def test_model_under_ctx_matches_plain(world, tmp_path_factory):
    ranks, _, _ = group_results(world, tmp_path_factory)
    for r in ranks:
        got = r["model_ctx"]
        np.testing.assert_allclose(got["ctx"], got["plain"], rtol=5e-2,
                                   atol=5e-2)
        assert np.isfinite(got["ctx"])


@pytest.mark.parametrize("world", sorted(GROUPS))
def test_compressed_psum_is_the_int8_sum(world, tmp_path_factory):
    ranks, _, _ = group_results(world, tmp_path_factory)
    for r in ranks:
        assert r["psum"] == {"world": 0.0, "data": 0.0}


@pytest.mark.parametrize("world", sorted(GROUPS))
def test_jit_cell_steps_match_plain_steps(world, tmp_path_factory):
    ranks, _, _ = group_results(world, tmp_path_factory)
    for r in ranks:
        c = r["cells"]
        t = c["train"]
        assert t["placed"] and t["step"] == 1
        # the sharded products add bf16 partial sums in another order:
        # the loss and gradient norm within 1e-3, the updated weights
        # within one bf16 step, the logits within the model tolerance
        np.testing.assert_allclose(*t["loss"], rtol=1e-3, atol=1e-3)
        np.testing.assert_allclose(*t["grad_norm"], rtol=1e-3, atol=1e-3)
        assert t["param_err"] <= 2e-2, t
        np.testing.assert_allclose(*c["prefill"], rtol=5e-2, atol=5e-2)
        assert c["decode_err"] <= 5e-2 and c["decode_cache_err"] == 0, c


@pytest.mark.parametrize("world", sorted(GROUPS))
def test_restore_onto_mesh(world, tmp_path_factory):
    ranks, _, _ = group_results(world, tmp_path_factory)
    for r in ranks:
        got = r["restore"]
        assert got["step"] == 3 and got["equal"]
        assert got["sharded_leaves"] == got["plan"]["leaves_sharded"] > 0
        assert got["plan"]["n_devices"] == world
        assert got["ring_equal"]
        assert got["ring_local"] == [6, 8 // GROUPS[world][0]]
