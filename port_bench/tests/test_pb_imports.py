"""Nothing the harness loads may be JAX or the JAX package: the modules
of a whole run are compared by their top-level name, as a whole name
(``repro_torch`` begins with ``repro`` and is allowed)."""

import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
BENCH = HERE.parent

SCRIPT = f"""
import importlib.util, json, sys
sys.path[:0] = [{str(HERE)!r}, {str(BENCH)!r}, {str(BENCH.parent / 'src')!r}]
import pb_helpers
spec = importlib.util.spec_from_file_location("pb_run", {str(BENCH / 'run.py')!r})
run = importlib.util.module_from_spec(spec)
spec.loader.exec_module(run)
if __name__ == "__main__":
    rc = run.main(["--workload", "mithril-lru-c512.stream64", "--seed", "1",
                   "--seconds", "1", "--trace", "0"],
                  card=pb_helpers.CpuCard(),
                  cell=pb_helpers.small_cell("mithril-lru-c512.stream64",
                                             n_specs=4, nominal=600))
    for p in {str(BENCH / 'metrics')!r}, :
        import pathlib
        for f in pathlib.Path(p).glob("*.py"):
            run.reader(f.stem)
    tops = sorted({{m.split(".")[0] for m in sys.modules}})
    print(json.dumps({{"rc": rc, "tops": tops,
                      "forbidden": run.forbidden_modules()}}))
"""


def test_harness_loads_no_jax_nor_the_jax_package(tmp_path):
    script = tmp_path / "drive.py"
    script.write_text(SCRIPT)
    out = subprocess.run([sys.executable, str(script)], capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    import json
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["rc"] == 0
    assert res["forbidden"] == []
    tops = set(res["tops"])
    assert "repro_torch" in tops and "torch" in tops
    assert not tops & {"jax", "jaxlib", "flax", "repro"}


def test_forbidden_names_are_whole_top_level_names(monkeypatch):
    import importlib.util
    spec = importlib.util.spec_from_file_location("pb_run2",
                                                  BENCH / "run.py")
    run = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(run)
    monkeypatch.setitem(sys.modules, "repro_torch_x", object())
    assert "repro" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "repro.cache", object())
    assert "repro" in run.forbidden_modules()
