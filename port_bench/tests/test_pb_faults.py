"""A run of the harness with the timed path broken underneath must come
out not correct: the look for a card is skipped (the CPU stands in) and
the rest of a run is driven, once for each fault a sweep cell can have.
(Its one chip holds no exchange between chips to leave out.)"""

import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from pbench import check

from pb_helpers import CpuCard, small_cell

_spec = importlib.util.spec_from_file_location(
    "pb_run", Path(__file__).resolve().parents[1] / "run.py")
run = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(run)


def _state_unchanged(orig):
    """Every step returns its state unchanged: nothing is stepped."""
    def fault(self, carry, blocks, valid, live):
        return torch.zeros(blocks.shape, dtype=torch.bool)
    return fault


def _half_the_batch(orig):
    """The second half of the lanes is left out of every step."""
    def fault(self, carry, blocks, valid, live):
        valid = valid.clone()
        valid[:, valid.shape[1] // 2:] = False
        return orig(self, carry, blocks, valid, live)
    return fault


def _answer_altered(orig):
    """One lane's hit or miss is flipped where the step produces it."""
    def fault(self, carry, blocks, valid, live):
        hits = orig(self, carry, blocks, valid, live)
        rows = np.flatnonzero(valid[:, 0].numpy())
        if len(rows):
            hits[rows[0], 0] = ~hits[rows[0], 0]
        return hits
    return fault


def _drive(workload, monkeypatch, capsys, fault=None):
    from repro_torch.cache import reset_runners
    from repro_torch.cache.sweep import ChunkRunner
    reset_runners()
    if fault is not None:
        monkeypatch.setattr(ChunkRunner, "run", fault(ChunkRunner.run))
    ref = check.run_reference
    monkeypatch.setattr(check, "run_reference",
                        lambda *a, **k: ref(*a, **{**k, "workers": 2}))
    rc = run.main(["--workload", workload, "--seed", "4294967311",
                   "--seconds", "1", "--trace", "0"],
                  card=CpuCard(), cell=small_cell(workload))
    out = capsys.readouterr()
    assert rc == 0
    return json.loads(out.out.strip().splitlines()[-1]), out.err


@pytest.mark.parametrize("workload", ["mithril-lru-c512.corpus135",
                                      "mithril-lru-c512.stream64"])
def test_sound_run_is_correct(workload, monkeypatch, capsys):
    res, err = _drive(workload, monkeypatch, capsys)
    assert res["correct"] is True and res["failed"] == 0
    assert list(res)[-1] == "checks"
    assert err.strip().splitlines()[-1] == "hits_differ 0 limit 0"


@pytest.mark.parametrize("fault", [_state_unchanged, _half_the_batch,
                                   _answer_altered])
@pytest.mark.parametrize("workload", ["mithril-lru-c512.corpus135",
                                      "mithril-lru-c512.stream64"])
def test_broken_path_is_not_correct(workload, fault, monkeypatch, capsys):
    res, _ = _drive(workload, monkeypatch, capsys, fault)
    assert res["correct"] is False and res["failed"] > 0
