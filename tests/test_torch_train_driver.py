"""The training drivers against the reference, on the CPU.

* ``data.SyntheticPipeline``: batches, the shard schedule and the
  readahead (counters and the staged set) equal to
  ``repro.data.SyntheticPipeline`` bit for bit over 200 steps, without
  and with MITHRIL (the reference test's configuration); the readahead's
  misses go through ``cache.tiered.MissRoute``, the serving tier's route;
* ``checkpoint.CheckpointManager``: the round trip (bf16 included, dtype
  and device kept), async saves with garbage collection, no partial
  directories, and the reference's key layout;
* ``runtime``: the fault module's heartbeat, restart, too-many-failures
  and straggler cases, and the int8 compression's error bounds, as the
  reference's own tests state them;
* ``launch.train.train``: a run interrupted after 7 steps and resumed
  from its step-5 checkpoint gives the uninterrupted run's losses bit for
  bit; compression ends within 0.3 of the uncompressed final loss (the
  reference's bound); 4 steps from the reference's weights against a
  loop of the reference's own ``forward_train`` + ``value_and_grad`` +
  ``adamw.update`` + ``batch_np`` (no mesh) within 5e-2 a loss, the
  bound ``chip_smoke.py`` holds the card to.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as REF_ARCHS
from repro.configs import reduced_config as ref_reduced
from repro.core import MithrilConfig as RefMithrilConfig
from repro.data import DataConfig as RefDataConfig
from repro.data import SyntheticPipeline as RefPipeline
from repro.models import RunFlags as RefRunFlags
from repro.models import forward_train as ref_forward_train
from repro.models import init_params as ref_init
from repro.optim import adamw as radamw

from repro_torch.checkpoint import CheckpointManager
from repro_torch.convert import config_from, lm_params_from
from repro_torch.data import DataConfig, SyntheticPipeline
from repro_torch.launch import train as ptrain
from repro_torch.optim import adamw
from repro_torch.runtime import (HeartbeatMonitor, StragglerPolicy,
                                 WorkerFailure, dequantize_int8,
                                 fake_quant_grads, quantize_int8,
                                 run_with_restarts)

LOSS_TOL = 5e-2
EXACT_BF16 = {"xla_allow_excess_precision": False}
# tests/test_runtime.py's readahead configuration
READAHEAD = RefMithrilConfig(min_support=2, max_support=8, lookahead=16,
                             rec_buckets=128, rec_ways=4, mine_rows=16,
                             pf_buckets=128, pf_ways=4)


# -- data ---------------------------------------------------------------------

@pytest.mark.parametrize("n_shards,group,mithril", [
    (16, 4, False), (16, 4, True), (64, 4, True), (24, 2, True)])
def test_pipeline_equals_reference(n_shards, group, mithril):
    kw = dict(vocab=100, seq_len=8, global_batch=2, seed=3,
              n_shards=n_shards, shard_group=group)
    ref = RefPipeline(RefDataConfig(**kw),
                      mithril_cfg=READAHEAD if mithril else None)
    port = SyntheticPipeline(
        DataConfig(**kw), mithril_cfg=config_from(READAHEAD)
        if mithril else None, device="cpu")
    for step in range(200):
        assert port.shard_for_step(step) == ref.shard_for_step(step)
        want = ref.batch_np(step)
        got = port.batch_np(step)
        for name in ("tokens", "labels"):
            assert got[name].dtype == want[name].dtype == np.int32
            np.testing.assert_array_equal(got[name], want[name])
        assert port.staged == ref.staged, step
        assert (port.readahead_hits, port.readahead_misses) == \
            (ref.readahead_hits, ref.readahead_misses), step
    assert port.readahead_misses > 0


def test_readahead_learns_shard_pattern():
    """The reference test's claim, through the miss route: MITHRIL's
    readahead hits at least as often as plain staging."""
    cfg = DataConfig(vocab=100, seq_len=8, global_batch=2, n_shards=64,
                     shard_group=4)
    plain = SyntheticPipeline(cfg)
    smart = SyntheticPipeline(cfg, mithril_cfg=config_from(READAHEAD),
                              device="cpu")
    for step in range(400):
        plain.fetch_shard(step)
        smart.fetch_shard(step)
    assert smart.readahead_hits >= plain.readahead_hits
    assert int(smart._route.state.n_mines[0]) > 0


def test_batch_on_device_and_iteration():
    cfg = DataConfig(vocab=50, seq_len=6, global_batch=3, seed=2)
    pipe = SyntheticPipeline(cfg)
    b = pipe.batch(4, "cpu")
    want = SyntheticPipeline(cfg).batch_np(4)
    for name in ("tokens", "labels"):
        assert b[name].dtype == torch.int32
        np.testing.assert_array_equal(b[name].numpy(), want[name])
    first = next(iter(SyntheticPipeline(cfg)))
    np.testing.assert_array_equal(first["tokens"],
                                  SyntheticPipeline(cfg).batch_np(0)["tokens"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            pipe.batch(0)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            SyntheticPipeline(cfg, mithril_cfg=config_from(READAHEAD))


# -- checkpoints ----------------------------------------------------------------

def test_checkpoint_roundtrip(tmp_path):
    ckpt = CheckpointManager(str(tmp_path))
    state = {"w": torch.arange(12.0).reshape(3, 4),
             "nested": {"b": torch.tensor([1.5, -2.25], dtype=torch.bfloat16)},
             "opt": adamw.init({"x": torch.ones(2, dtype=torch.bfloat16)})}
    ckpt.save(5, state)
    template = {"w": torch.zeros(3, 4),
                "nested": {"b": torch.zeros(2, dtype=torch.bfloat16)},
                "opt": adamw.init({"x": torch.zeros(2,
                                                    dtype=torch.bfloat16)})}
    step, restored = ckpt.restore(template)
    assert step == 5
    assert torch.equal(restored["w"], state["w"])
    assert restored["nested"]["b"].dtype == torch.bfloat16
    assert torch.equal(restored["nested"]["b"], state["nested"]["b"])
    assert isinstance(restored["opt"], adamw.OptState)
    assert restored["opt"].step.dtype == torch.int32
    assert torch.equal(restored["opt"].master["x"], torch.ones(2))
    with np.load(tmp_path / "step_5" / "arrays.npz") as z:
        assert sorted(z.files) == ["nested/b", "opt/.m/x", "opt/.master/x",
                                   "opt/.step", "opt/.v/x", "w"]
        assert z["nested/b"].dtype == np.float32


def test_checkpoint_async_and_gc(tmp_path):
    ckpt = CheckpointManager(str(tmp_path), keep=2)
    w = torch.zeros(4)
    for s in (1, 2, 3, 4):
        ckpt.save_async(s, {"w": w})
        w.add_(1)                   # the snapshot was taken at the call
    ckpt.wait()
    assert ckpt.steps() == [3, 4]
    step, restored = ckpt.restore({"w": torch.zeros(4)})
    assert step == 4 and torch.equal(restored["w"], torch.full((4,), 3.0))


def test_checkpoint_atomicity_no_partial_dirs(tmp_path):
    ckpt = CheckpointManager(str(tmp_path))
    ckpt.save(1, {"w": torch.zeros(2)})
    assert all(not n.startswith(".tmp") for n in os.listdir(tmp_path))
    os.makedirs(tmp_path / ".tmp_step_2")       # a crash mid-write
    assert ckpt.latest_step() == 1
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore({})


# -- fault tolerance and compression --------------------------------------------

def test_heartbeat_detection():
    mon = HeartbeatMonitor(n_workers=3, timeout_s=10)
    mon.beat(0, now=100.0)
    mon.beat(1, now=100.0)
    mon.beat(2, now=95.0)
    assert mon.check(now=106.0) == [2]


def test_restart_from_checkpoint(tmp_path):
    """Injected failure at step 7 -> the driver resumes from step 5."""
    ckpt = CheckpointManager(str(tmp_path))
    calls = {"fails": 0}

    def train_some(start, state):
        step = start
        while step < 10:
            state = {"w": state["w"] + 1}
            step += 1
            if step == 5:
                ckpt.save(5, state)
            if step == 7 and calls["fails"] == 0:
                calls["fails"] = 1
                raise WorkerFailure(3, "injected link timeout")
        return step, state

    step, state = run_with_restarts(train_some, {"w": torch.zeros(())},
                                    ckpt, total_steps=10)
    assert step == 10
    assert float(state["w"]) == 10.0


def test_too_many_failures_raises(tmp_path):
    ckpt = CheckpointManager(str(tmp_path))

    def always_fail(start, state):
        raise WorkerFailure(0, "dead")

    with pytest.raises(RuntimeError, match="restarts"):
        run_with_restarts(always_fail, {"w": torch.zeros(())}, ckpt,
                          total_steps=1, max_restarts=2)


def test_straggler_backup_plan():
    pol = StragglerPolicy(factor=2.0)
    for t in (1.0, 1.1, 0.9, 1.0, 1.05):
        pol.observe(t)
    plan = pol.plan_backup({0: 1.0, 1: 0.9, 2: 5.0, 3: 1.1})
    assert 2 in plan and plan[2] != 2


def test_quant_roundtrip_error():
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        1000).astype(np.float32))
    q, s = quantize_int8(x)
    assert q.dtype == torch.int8
    err = (dequantize_int8(q, s) - x).abs()
    assert float(err.max()) <= float(s) * 0.51 + 1e-6


def test_fake_quant_grads_small_effect():
    rng = np.random.default_rng(1)
    g = {"a": torch.from_numpy(rng.standard_normal((64, 64)).astype(
        np.float32)),
         "b": [torch.from_numpy(rng.standard_normal(32).astype(
             np.float32)).bfloat16()]}
    fq = fake_quant_grads(g)
    rel = float((fq["a"] - g["a"]).norm() / g["a"].norm())
    assert rel < 0.02
    assert fq["b"][0].dtype == torch.bfloat16


# -- the training driver ----------------------------------------------------------

TRAIN_KW = dict(batch=2, seq=64, log_every=100, device="cpu")


def test_train_restart_continuity(tmp_path, monkeypatch):
    """12 steps uninterrupted; then 12 steps that fail after 7 (the step-5
    checkpoint written) and resume: the resumed losses are the
    uninterrupted run's, bit for bit."""
    kw = dict(steps=12, ckpt_every=5, seed=3, **TRAIN_KW)
    whole = ptrain.train("llama3.2-3b", ckpt_dir=str(tmp_path / "a"), **kw)
    assert all(np.isfinite(whole["losses"])) and len(whole["losses"]) == 12

    class Crash(StragglerPolicy):
        def observe(self, step_time):
            super().observe(step_time)
            if len(self._times) == 7:
                raise WorkerFailure(0, "injected after 7 steps")

    with monkeypatch.context() as m:
        m.setattr(ptrain, "StragglerPolicy", Crash)
        with pytest.raises(WorkerFailure):
            ptrain.train("llama3.2-3b", ckpt_dir=str(tmp_path / "b"), **kw)
    assert CheckpointManager(str(tmp_path / "b")).steps() == [5]
    resumed = ptrain.train("llama3.2-3b", ckpt_dir=str(tmp_path / "b"),
                           **kw)
    assert len(resumed["losses"]) == 12 - 5
    assert resumed["losses"] == whole["losses"][5:]
    assert resumed["grad_norms"] == whole["grad_norms"][5:]


def test_train_with_compression_converges_similarly(tmp_path):
    a = ptrain.train("llama3.2-3b", steps=8, ckpt_dir=str(tmp_path / "a"),
                     resume=False, **TRAIN_KW)
    b = ptrain.train("llama3.2-3b", steps=8, compress=True,
                     ckpt_dir=str(tmp_path / "b"), resume=False, **TRAIN_KW)
    assert abs(a["final_loss"] - b["final_loss"]) < 0.3
    assert a["losses"][0] == b["losses"][0]      # the first forward is equal


@pytest.mark.parametrize("arch", ["llama3.2-3b", "qwen2-moe-a2.7b"])
def test_train_matches_reference_loop(arch, tmp_path):
    steps, batch, seq, seed = 4, 2, 64, 0
    ref_cfg = ref_reduced(REF_ARCHS[arch])
    params = ref_init(ref_cfg, jax.random.PRNGKey(seed))
    init = lm_params_from(jax.tree.map(np.asarray, params),
                          ptrain.reduced_config(ptrain.get_config(arch)),
                          device="cpu")
    got = ptrain.train(arch, steps=steps, batch=batch, seq=seq, seed=seed,
                       ckpt_dir=str(tmp_path), resume=False, init=init,
                       log_every=100, device="cpu")

    opt_cfg = radamw.AdamWConfig(total_steps=steps,
                                 warmup_steps=max(2, steps // 10))
    data = RefPipeline(RefDataConfig(vocab=ref_cfg.vocab, seq_len=seq,
                                     global_batch=batch, seed=seed))

    def step_fn(p, st, b):
        (_, m), g = jax.value_and_grad(
            lambda p_: ref_forward_train(ref_cfg, p_, b,
                                         RefRunFlags(remat="none")),
            has_aux=True)(p)
        p, st, om = radamw.update(opt_cfg, g, st, p)
        return p, st, m["loss"], om["grad_norm"]
    state = radamw.init(params)
    b0 = {k: jnp.asarray(v) for k, v in data.batch_np(0).items()}
    jstep = jax.jit(step_fn).lower(params, state, b0).compile(
        compiler_options=EXACT_BF16)
    losses, norms = [], []
    for step in range(steps):
        b = b0 if step == 0 else {k: jnp.asarray(v) for k, v in
                                  data.batch_np(step).items()}
        params, state, loss, gnorm = jstep(params, state, b)
        losses.append(float(loss))
        norms.append(float(gnorm))
    np.testing.assert_allclose(got["losses"], losses, rtol=0, atol=LOSS_TOL)
    np.testing.assert_allclose(got["grad_norms"], norms, rtol=LOSS_TOL,
                               atol=LOSS_TOL)
    assert got["readahead_hits"] == data.readahead_hits


def test_train_entry_points_without_a_card_raise(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ptrain.train("llama3.2-3b", steps=1, ckpt_dir=str(tmp_path))
    out = ptrain.main(["--steps", "2", "--batch", "2", "--seq", "32",
                       "--ckpt-dir", str(tmp_path / "m"), "--device", "cpu"])
    assert len(out["losses"]) == 2 and np.isfinite(out["final_loss"])
    assert all(np.isfinite(out["grad_norms"]))
