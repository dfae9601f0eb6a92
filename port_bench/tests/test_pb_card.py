"""A small cell on the card, through the harness's own card: the timed
path with its captured graphs and kernels, and a traced span read from
the profiler. Skips without a card; run on the card with
``python -m pytest -q -m cuda port_bench/tests/test_pb_card.py``."""

import importlib.util
import json
from pathlib import Path

import pytest
import torch

from pb_helpers import small_cell

_spec = importlib.util.spec_from_file_location(
    "pb_run_card", Path(__file__).resolve().parents[1] / "run.py")
run = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(run)


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["mithril-lru-c512.corpus135",
                                      "mithril-amp-lru-c512.corpus135",
                                      "mithril-lru-c512.stream64"])
@pytest.mark.parametrize("trace", [0, 1])
def test_small_cell_on_the_card(workload, trace, capsys):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.cache import reset_runners
    reset_runners()
    rc = run.main(["--workload", workload, "--seed", "2147483659",
                   "--seconds", "1", "--trace", str(trace)],
                  cell=small_cell(workload, n_specs=8, nominal=3000))
    out = capsys.readouterr().out.strip().splitlines()
    assert rc == 0
    res = json.loads(out[-1])
    assert res["correct"] is True
    assert res["device"]["platform"] == "gpu"
    if trace:
        assert res["device"]["busy_s"] > 0
        assert 0 < res["metrics"]["step.kernels"]["value"]
        for name in ("step_roofline", "mine_step_roofline"):
            if name in res["metrics"]:
                assert res["metrics"][name]["value"] <= 100
