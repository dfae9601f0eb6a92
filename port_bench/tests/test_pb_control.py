"""The control: the reference with 16-bit block ids in the program's
place must come out not correct, on every seed, at a size a test run
holds (``control.py`` runs it at the cells' own size on the chip's
machine)."""

import importlib.util
from pathlib import Path

import pytest

from pbench import check, traffic

from pb_helpers import small_cell

_spec = importlib.util.spec_from_file_location(
    "pb_control", Path(__file__).resolve().parents[1] / "control.py")
control = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(control)


@pytest.mark.parametrize("workload", ["mithril-lru-c512.corpus135",
                                      "mithril-amp-lru-c512.corpus135"])
@pytest.mark.parametrize("seed", [3, 2**31 + 5, 987654321987])
def test_control_is_not_correct(workload, seed):
    _, cfg, tr, _, _ = small_cell(workload, n_specs=8, nominal=1500)
    _, traces = traffic.generate(tr, seed)
    numbers = control.control_numbers(cfg, traces, workers=1)
    assert not check.verdict(numbers)
    assert numbers["stats_differ"] > 0 and numbers["hits_differ"] > 0
