"""The harness end to end at a tiny size on the CPU: the result line, the
blocked modules, a cell added by files alone, and the refusals."""

import json
import os
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

import pytest

from benchmarks import run
from conftest import ROOT, SEED

KEYS = {"correct", "attempted", "failed", "metrics", "device"}


def _run(cell, trace=False, seconds=2.0):
    return run.run_cell(cell, SEED, seconds, trace, "cpu",
                        Path(tempfile.gettempdir()))


@pytest.mark.parametrize("workload", ["atlas-1d-sweep-exact", "pbmc-2d-queries-exact"])
def test_result_line(tiny, workload):
    out = _run(tiny(workload))
    assert KEYS <= set(out)
    assert list(out)[-1] == "compared"  # the numbers compared come last
    assert out["correct"] is True and out["failed"] == 0
    assert out["attempted"] >= 1
    names = {m["name"] for m in tiny(workload).end_to_end}
    assert set(out["metrics"]) == names
    for m in out["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert set(out["device"]) >= {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    for value, limit in out["compared"].values():
        assert value <= limit


def test_traced_result_line(tiny):
    cell = tiny("atlas-1d-sweep-exact")
    out = _run(cell, trace=True)
    assert out["correct"] is True
    names = {m["name"] for m in cell.per_layer}
    # the CPU has no device events: the device's metric reads nothing
    assert set(out["metrics"]) == names - {"device_idle_share.1d"}
    assert {"busy_s", "window_s"} <= set(out["device"])
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    assert len(out["breakdown"]["idle_gaps"]) <= 10


BLOCKER = """
import sys, importlib.abc
BLOCKED = {"jax", "jaxlib", "flax", "memento_tpu"}
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError("blocked: " + name)
        return None
sys.meta_path.insert(0, Block())
"""


def test_runs_with_jax_and_the_jax_package_blocked():
    code = BLOCKER + f"""
import json, tempfile
from pathlib import Path
sys.path.insert(0, {str(ROOT)!r})
sys.path.insert(0, {str(ROOT / "benchmarks" / "tests")!r})
from benchmarks import run
from conftest import shrink
cell = shrink(run.find_cell(run.ROOT, "atlas-1d-sweep-exact"))
out = run.run_cell(cell, {SEED}, 1.0, False, "cpu",
                   Path(tempfile.gettempdir()))
print(json.dumps({{"correct": out["correct"],
                  "blocked": run.blocked_modules(),
                  "torch_port": "memento_tpu_torch" in sys.modules}}))
"""
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    last = json.loads(res.stdout.strip().splitlines()[-1])
    assert last == {"correct": True, "blocked": [], "torch_port": True}


def test_blocked_modules_by_whole_top_level_name():
    import types

    assert run.blocked_modules() == []
    sys.modules["memento_tpu"] = types.ModuleType("memento_tpu")
    try:
        assert run.blocked_modules() == ["memento_tpu"]
    finally:
        del sys.modules["memento_tpu"]
    sys.modules["memento_tpu_torch_x"] = types.ModuleType("x")
    try:
        assert run.blocked_modules() == []
    finally:
        del sys.modules["memento_tpu_torch_x"]


def _copy_benchmark(dest: Path):
    shutil.copy(ROOT / "BENCHMARK.json", dest / "BENCHMARK.json")
    shutil.copytree(ROOT / "benchmarks", dest / "benchmarks",
                    ignore=shutil.ignore_patterns("__pycache__"))


def _tree(root: Path) -> dict:
    return {p.relative_to(root).as_posix(): p.read_bytes()
            for p in sorted(root.rglob("*"))
            if p.is_file() and "__pycache__" not in p.parts}


def test_a_cell_is_added_by_files_alone(tmp_path):
    """A throwaway configuration, traffic mix and per-layer and end-to-end
    metric, as new files and new entries: the harness runs the new cell
    and reports the new metrics, and no existing file changed."""
    _copy_benchmark(tmp_path)
    before = _tree(tmp_path / "benchmarks")
    bench = tmp_path / "benchmarks"
    cfg = json.loads((bench / "configs" / "pbmc-ifn.json").read_text())
    cfg.update(name="tiny-x", n_cells=3000, n_genes=500, n_donors=3,
               celltype_shares=[0.6, 0.4])
    (bench / "configs" / "tiny-x.json").write_text(json.dumps(cfg))
    tr = json.loads((bench / "traffic" / "celltype-sweep-1d.json")
                    .read_text())
    tr.update(num_boot=150, check_requests=1)
    (bench / "traffic" / "sweep-x.json").write_text(json.dumps(tr))
    (bench / "checks" / "tiny-x.sweep.json").write_text(json.dumps(
        {"limits": {"items_differ": 0, "coef_gap.de": 0.01}}))
    (bench / "metrics" / "requests_done.py").write_text(
        "def read(run):\n    return float(len(run.records))\n")
    (bench / "metrics" / "spans_seen.x.py").write_text(
        "def read(run):\n"
        "    t = run.traced\n"
        "    return None if t is None else float(len(t.spans))\n")
    spec = json.loads((tmp_path / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "tiny-x", "source": "a test",
                            "file": "benchmarks/configs/tiny-x.json",
                            "reduced": [], "why": "a test"})
    spec["workloads"].append({"name": "tiny-x.sweep", "config": "tiny-x",
                              "traffic": "sweep-x", "chips": 1,
                              "why": "a test"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "tests_1d_per_s" in (m["name"], m.get("moves")):
            m["workloads"].append("tiny-x.sweep")
    spec["end_to_end"].append({"name": "requests_done", "unit": "requests",
                               "better": "higher", "bound": 0.25,
                               "source": "host_clock",
                               "workloads": ["tiny-x.sweep"]})
    spec["per_layer"].append({"name": "spans_seen.x", "unit": "spans",
                              "better": "higher", "source": "host_clock",
                              "layer": "API host stages",
                              "moves": "requests_done",
                              "workloads": ["tiny-x.sweep"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))

    cell = run.find_cell(tmp_path, "tiny-x.sweep")
    out = _run(cell, seconds=1.0)
    assert out["correct"] is True
    assert out["metrics"]["requests_done"]["value"] == out["attempted"]
    assert "tests_1d_per_s" in out["metrics"]
    traced = _run(cell, trace=True, seconds=1.0)
    assert traced["metrics"]["spans_seen.x"]["value"] >= 1
    assert "api_host_s.1d" in traced["metrics"]
    after = _tree(bench)
    assert {k: v for k, v in after.items() if k in before} == before


def test_refuses_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    res = subprocess.run(
        [sys.executable, "-m", "benchmarks.run", "--workload",
         "atlas-1d-sweep-exact", "--seed", str(SEED), "--seconds", "1", "--trace",
         "0"], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=300)
    assert res.returncode != 0 and res.stdout == ""


def test_fails_with_only_the_benchmark(tmp_path):
    """In a directory that holds only BENCHMARK.json and the benchmark's
    folder, a run (told that a card is there) exits non-zero and prints no
    result: the program is not there."""
    _copy_benchmark(tmp_path)
    code = ("import sys, runpy, torch; "
            "torch.cuda.is_available = lambda: True; "
            "torch.cuda.device_count = lambda: 1; "
            "sys.argv = ['run', '--workload', 'atlas-1d-sweep-exact', '--seed', "
            "'1', '--seconds', '1', '--trace', '0']; "
            "runpy.run_module('benchmarks.run', run_name='__main__')")
    res = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, PYTHONPATH=str(tmp_path)))
    assert res.returncode != 0 and res.stdout == ""
    assert "memento_tpu_torch" in res.stderr
