"""The port's model-serving driver and trace capture against the
reference's, on the CPU.

* ``launch.serve.ServeLoop`` on reduced llama3.2-3b mirrors
  ``tests/test_tiered.py::test_serve_loop_smoke`` beside the reference's
  loop over the same parameters (2 requests of 16 tokens, 4 steps, every
  request at position 20, the same counters, caches and MITHRIL
  configuration); ``main --device cpu`` runs;
* ``traces.capture.capture_page_trace`` equals the reference's exactly;
* ``capture_expert_trace`` at ``benchmarks/expert_prefetch.py``'s
  geometry (reduced qwen2-moe, 16 experts, top 4, 8 layers, 6 tenants'
  2 x 64 tokens) equals the reference's exactly, from the reference's
  parameters carried across by ``convert.lm_params_from``; and
  ``simulate``'s LRU and MITHRIL-LRU ``Stats`` over it (capacity 48,
  ``SUITE_MITHRIL`` with lookahead 40, support 2) equal the reference's.
"""

import dataclasses
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.cache import SimConfig as RefSimConfig
from repro.cache import simulate as ref_simulate
from repro.configs import ARCHS as REF_ARCHS
from repro.configs import reduced_config as ref_reduced
from repro.configs.mithril_paper import SUITE_MITHRIL as REF_SUITE
from repro.launch.serve import ServeLoop as RefServeLoop
from repro.models import init_params as ref_init
from repro.traces import capture as ref_capture

from repro_torch.cache import simulate
from repro_torch.configs import ARCHS, reduced_config
from repro_torch.convert import config_from, lm_params_from
from repro_torch.launch import serve
from repro_torch.traces import capture

ROOT = pathlib.Path(__file__).resolve().parents[1]


def test_serve_loop_mirrors_reference_smoke():
    cfg = reduced_config(ARCHS["llama3.2-3b"])
    ref_cfg = ref_reduced(REF_ARCHS["llama3.2-3b"])
    params = ref_init(ref_cfg, jax.random.PRNGKey(0))
    model = lm_params_from(jax.tree.map(np.asarray, params), cfg,
                           device="cpu")
    ref_loop = RefServeLoop(ref_cfg, params, max_len=48)
    loop = serve.ServeLoop(cfg, model, max_len=48)
    rng = np.random.default_rng(0)
    for rid in range(2):
        prompt = rng.integers(0, cfg.vocab, 16)
        ref_loop.admit(rid, jnp.asarray(prompt, jnp.int32))
        loop.admit(rid, torch.as_tensor(prompt, dtype=torch.int32))
    for _ in range(4):
        ref_loop.step()
        loop.step()
    assert loop.stats == ref_loop.stats == {"prefills": 2,
                                            "decode_steps": 4, "tokens": 8}
    assert loop.mith_cfg == config_from(ref_loop.mith_cfg)
    for rid, st in loop.requests.items():
        ref_st = ref_loop.requests[rid]
        assert st["pos"] == ref_st["pos"] == 20
        assert st["tok"].dtype == torch.int32 and st["tok"].shape == (1,)
        assert 0 <= int(st["tok"]) < cfg.padded_vocab
        assert torch.isfinite(st["logits"]).all()
        kv, ref_kv = st["cache"][0]["u0"], ref_st["cache"][0]["u0"]
        for name in ("k", "v"):      # padded to max_len, written to 20
            assert tuple(kv[name].shape) == ref_kv[name].shape
            assert kv[name].shape[2] == 48
            assert kv[name][:, :, :20].abs().amax(-1).amax(-1).min() > 0
            assert not kv[name][:, :, 20:].any()
    assert not serve.ServeLoop(cfg, model, max_len=8,
                               mithril=False).mith_cfg


def test_main_runs_on_the_cpu(capsys):
    out = serve.main(["--device", "cpu", "--requests", "2",
                      "--prompt-len", "8", "--decode-steps", "3"])
    assert out["tokens"] == 6 and out["device"] == "cpu"
    assert out["arch"] == "llama3.2-3b" and out["tok_s"] > 0
    assert "6 tokens decoded" in capsys.readouterr().out


@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "rwkv6-1.6b"])
def test_serve_loop_runs_the_recurrent_families(arch):
    """Two requests of 16 tokens and 4 steps through both loops: the same
    counts and positions, finite logits, and caches of the reference's
    layout whose recurrent states the steps wrote in place."""
    cfg = reduced_config(ARCHS[arch])
    ref_cfg = ref_reduced(REF_ARCHS[arch])
    params = ref_init(ref_cfg, jax.random.PRNGKey(0))
    model = lm_params_from(jax.tree.map(np.asarray, params), cfg,
                           device="cpu")
    ref_loop = RefServeLoop(ref_cfg, params, max_len=48)
    loop = serve.ServeLoop(cfg, model, max_len=48)
    rng = np.random.default_rng(0)
    for rid in range(2):
        prompt = rng.integers(0, cfg.vocab, 16)
        ref_loop.admit(rid, jnp.asarray(prompt, jnp.int32))
        loop.admit(rid, torch.as_tensor(prompt, dtype=torch.int32))
    admitted = [{u: [t.clone() for t in (e.values() if isinstance(e, dict)
                                         else e)]
                 for u, e in g.items()} for g in loop.requests[0]["cache"]]
    for _ in range(4):
        ref_loop.step()
        loop.step()
    assert loop.stats == ref_loop.stats == {"prefills": 2,
                                            "decode_steps": 4, "tokens": 8}
    for rid, st in loop.requests.items():
        ref_st = ref_loop.requests[rid]
        assert st["pos"] == ref_st["pos"] == 20
        assert torch.isfinite(st["logits"]).all()
        assert len(st["cache"]) == len(ref_st["cache"])
        for group, ref_group in zip(st["cache"], ref_st["cache"]):
            for unit, entry in group.items():
                leaves = (entry.values() if isinstance(entry, dict)
                          else entry)
                ref_leaves = (ref_group[unit].values()
                              if isinstance(entry, dict)
                              else ref_group[unit])
                for t, r in zip(leaves, ref_leaves, strict=True):
                    assert tuple(t.shape) == r.shape
    for group, before in zip(loop.requests[0]["cache"], admitted):
        for unit, entry in group.items():
            if not isinstance(entry, dict):
                assert not torch.equal(entry[0], before[unit][0]), unit


@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "rwkv6-1.6b"])
def test_main_runs_the_recurrent_families_on_the_cpu(arch):
    out = serve.main(["--arch", arch, "--device", "cpu", "--requests", "2",
                      "--prompt-len", "8", "--decode-steps", "3"])
    assert out["tokens"] == 6 and out["arch"] == arch


@pytest.mark.parametrize("args", [(8, 4, 3, 64, 0), (5, 16, 2, 100, 7),
                                  (12, 128, 1, 16_384, 3)])
def test_capture_page_trace_equals_reference(args):
    np.testing.assert_array_equal(capture.capture_page_trace(*args),
                                  ref_capture.capture_page_trace(*args))


def bench_geometry(vocab: int):
    """``benchmarks/expert_prefetch.py``'s token batches."""
    rng = np.random.default_rng(0)
    return [rng.integers(lo, lo + vocab // 8, (2, 64)).astype(np.int32)
            for lo in rng.integers(0, vocab // 2, 6)]


@pytest.fixture(scope="module")
def expert_traces():
    ref_cfg = dataclasses.replace(ref_reduced(REF_ARCHS["qwen2-moe-a2.7b"]),
                                  n_experts=16, top_k=4, n_layers=8)
    cfg = dataclasses.replace(reduced_config(ARCHS["qwen2-moe-a2.7b"]),
                              n_experts=16, top_k=4, n_layers=8)
    params = ref_init(ref_cfg, jax.random.PRNGKey(0))
    model = lm_params_from(jax.tree.map(np.asarray, params), cfg,
                           device="cpu")
    batches = bench_geometry(cfg.vocab)
    want = ref_capture.capture_expert_trace(
        ref_cfg, params, [jnp.asarray(b) for b in batches])
    got = capture.capture_expert_trace(cfg, model, batches)
    return cfg, batches, want, got


def test_capture_expert_trace_equals_reference(expert_traces):
    cfg, batches, want, got = expert_traces
    assert got.dtype == np.int32 and len(want) == 6 * 8 * 64 * 4
    np.testing.assert_array_equal(got, want)
    assert set(np.unique(got) // cfg.n_experts) == set(range(8))


def test_chip_smoke_expert_geometry_is_the_bench(expert_traces):
    """chip_smoke.py's copy of the bench's model shape and batches."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    cfg, batches, _, _ = expert_traces
    smoke_cfg, _, smoke_batches = chip_smoke.expert_setup("cpu")
    assert smoke_cfg == cfg
    for a, b in zip(smoke_batches, batches, strict=True):
        np.testing.assert_array_equal(a, b)
    mith = chip_smoke.expert_sim_configs()["mithril-lru"]
    assert mith == config_from(RefSimConfig(
        capacity=48, use_mithril=True,
        mithril=dataclasses.replace(REF_SUITE, lookahead=40,
                                    min_support=2)))


def test_capture_expert_trace_of_a_dense_model_is_empty():
    """No unit has a router: the reference's stream is empty too."""
    ref_cfg = ref_reduced(REF_ARCHS["llama3.2-3b"])
    cfg = reduced_config(ARCHS["llama3.2-3b"])
    params = ref_init(ref_cfg, jax.random.PRNGKey(0))
    model = lm_params_from(jax.tree.map(np.asarray, params), cfg,
                           device="cpu")
    batches = bench_geometry(cfg.vocab)[:2]
    want = ref_capture.capture_expert_trace(
        ref_cfg, params, [jnp.asarray(b) for b in batches])
    assert len(want) == 0
    assert len(capture.capture_expert_trace(cfg, model, batches)) == 0


@pytest.mark.parametrize("arch", ["whisper-medium", "rwkv6-1.6b",
                                  "recurrentgemma-9b"])
def test_capture_expert_trace_of_the_recurrent_and_encdec_models(arch):
    """Without a router the stream is empty, as the reference's."""
    ref_cfg = ref_reduced(REF_ARCHS[arch])
    cfg = reduced_config(ARCHS[arch])
    params = ref_init(ref_cfg, jax.random.PRNGKey(0))
    model = lm_params_from(jax.tree.map(np.asarray, params), cfg,
                           device="cpu")
    batches = bench_geometry(cfg.vocab)[:2]
    want = ref_capture.capture_expert_trace(
        ref_cfg, params, [jnp.asarray(b) for b in batches])
    assert len(want) == len(capture.capture_expert_trace(cfg, model,
                                                         batches)) == 0


def test_capture_counts_an_unrouted_encdec_unit_as_one_layer():
    """The reference counts a unit without a router by ``ln1.shape[0]``,
    its repeats, and by 1 where ``ln1`` is the encoder-decoder's dict
    norm. An encoder-decoder whose decoder repeats (rglru, MoE attn)
    twice shows it: the MoE layers are numbered 1 and 2, not 2 and 3,
    in both."""
    kw = dict(layer_pattern=("rglru", "attn"), n_layers=4, n_experts=4,
              top_k=2, moe_d_ff=64)
    ref_cfg = dataclasses.replace(ref_reduced(REF_ARCHS["whisper-medium"]),
                                  **kw)
    cfg = dataclasses.replace(reduced_config(ARCHS["whisper-medium"]), **kw)
    params = ref_init(ref_cfg, jax.random.PRNGKey(0))
    model = lm_params_from(jax.tree.map(np.asarray, params), cfg,
                           device="cpu")
    batches = bench_geometry(cfg.vocab)[:3]
    want = ref_capture.capture_expert_trace(
        ref_cfg, params, [jnp.asarray(b) for b in batches])
    got = capture.capture_expert_trace(cfg, model, batches)
    np.testing.assert_array_equal(got, want)
    assert set(np.unique(got) // cfg.n_experts) == {1, 2}
    assert capture.unrouted_layers(cfg, 2) == 1
    assert capture.unrouted_layers(ARCHS["recurrentgemma-9b"], 12) == 12


@pytest.mark.parametrize("mithril", [False, True], ids=["lru",
                                                        "mithril-lru"])
def test_expert_prefetch_stats_equal_reference(expert_traces, mithril):
    _, _, want_trace, trace = expert_traces
    mith = dataclasses.replace(REF_SUITE, lookahead=40, min_support=2)
    ref_sim = (RefSimConfig(capacity=48, use_mithril=True, mithril=mith)
               if mithril else RefSimConfig(capacity=48))
    want = ref_simulate(ref_sim, want_trace)
    got = simulate(config_from(ref_sim), trace, device="cpu")
    for name, a, b in zip(want.stats._fields, got.stats, want.stats):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=name)
    np.testing.assert_array_equal(got.hit_curve, np.asarray(want.hit_curve))
