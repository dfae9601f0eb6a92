"""The benchmark's frozen copies against the program's originals: the
trace generators (at the registry's own seeds) and the ``touched``
formulas (at a fixed seed)."""

import numpy as np
import pytest
import torch

from pbench import reference, touched, traffic


def test_generators_equal_the_registry_at_its_seeds():
    from repro_torch.traces import corpus
    tr = traffic.load_traffic("corpus135")
    names, traces = traffic.generate(tr, seed=None, nominal=300)
    specs = corpus.corpus_specs(300, "full")
    assert names == tuple(s.name for s in specs)
    for s, t in zip(specs, traces):
        assert np.array_equal(s.generate(), t), s.name


def test_seed_changes_content_not_lengths():
    tr = traffic.load_traffic("corpus135")
    tr = {**tr, "specs": tr["specs"][::27]}
    _, a = traffic.generate(tr, seed=1, nominal=500)
    _, b = traffic.generate(tr, seed=2**40 + 1, nominal=500)
    _, c = traffic.generate(tr, seed=1, nominal=500)
    assert [len(x) for x in a] == [len(x) for x in b]
    assert all(np.array_equal(x, y) for x, y in zip(a, c))
    assert not all(np.array_equal(x, y) for x, y in zip(a, b))


def _mithril_config():
    from repro_torch.core import MithrilConfig
    cfg = traffic.load_json("configs", "mithril-lru-c512")["mithril"]
    return cfg, MithrilConfig(**cfg)


@pytest.mark.parametrize("name", ["midfreq010", "mixed006"])
def test_touched_formulas_equal_the_program(name):
    """Record events, lookups and mining runs of one lane: the frozen
    per-lane formulas plus the launch's per-lane flags equal
    ``repro_torch.roofline.touched`` event by event."""
    from repro_torch.core import mithril
    from repro_torch.roofline import touched as prog
    cfg, mcfg = _mithril_config()
    spec = next(s for s in traffic.load_traffic("corpus135")["specs"]
                if s["name"] == name)
    blocks = traffic.BUILDERS[spec["family"]](
        1500, seed=traffic.spec_seed(name, 5), **spec["params"])
    ours = reference.Mithril(cfg, count=True)
    st = mithril.init(mcfg, "cpu", 1)
    on = torch.ones(1, dtype=torch.int32)
    runs = 0
    for blk in blocks.tolist():
        b = torch.tensor([blk], dtype=torch.int32)
        before = ours.record_bytes
        ours.record(blk)
        assert prog.record_event_bytes(mcfg, st, b, on) == \
            4.0 + ours.record_bytes - before
        if ours.fill >= ours.n:
            need = torch.ones(1, dtype=torch.bool)
            want = prog.mine_step_work(mcfg, st, need)
            ours.mine()
            mine_bytes, ops, pairs = ours.mine_runs[-1]
            assert want == (1 + mine_bytes, ops, pairs)
            mithril.mine_batched(mcfg, st, need)
            runs += 1
        q = torch.tensor([blk], dtype=torch.int32)
        assert prog.lookup_bytes(q, st.pf_key[0], st.pf_vals[0]) == \
            touched.lookup_bytes_one(ours.pf_ways, ours.p,
                                     ours.lookup(blk) is not None)
    assert runs > 0


def test_bound_matches_the_program():
    from repro_torch.roofline import touched as prog
    for by, ops in ((1e6, 1e3), (10.0, 1e9)):
        ms, which = prog.bound_ms(by, ops)
        s, ours = touched.bound_s(by, ops)
        assert ours == which and s * 1e3 == pytest.approx(ms, rel=1e-12)
