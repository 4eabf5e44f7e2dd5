"""The port's observability layer against the JAX package's.

``memento_tpu_torch/utils/profiling.py`` keeps the JAX package's registry
and its readers: on one hand-filled registry ``timings``, ``report`` and
``steady_state`` give what ``memento_tpu/utils/profiling.py`` gives (the
port's ``{prefix}.gev.refine.import`` phase, which the JAX package does not
have, counted once in the one-off); ``sync_pull`` sums the same nested
arrays within float32 rounding; ``device_trace`` writes a Chrome trace that
holds the phases of every thread.  ``chip_smoke.trace_summary``, the parser
of those traces, is checked on a trace made by hand.
"""

import importlib.util
import io
import json
import pathlib
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from memento_tpu.utils import profiling as j_prof

from memento_tpu_torch.utils import profiling as t_prof

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]

# four tiles of a 1D run under the JAX package's phase names, plus a name
# longer than the report's column
REGISTRY = {
    "ht1d.warmjoin": [1.375],
    "ht1d.compress+pack": [0.75, 0.5, 0.4375, 0.25],
    "ht1d.transfer": [0.015625, 0.0078125, 0.0078125, 0.0078125],
    "ht1d.dispatch": [0.5, 0.125, 0.1171875, 0.125],
    "ht1d.harvest": [0.0625, 2.25, 0.0625, 0.03125, 0.0625, 0.0625, 0.0625,
                     0.0625],
    "ht1d.gev": [0.001, 0.002, 0.003, 0.004],
    "ht1d.gev.join": [0.3],
    "a.phase.name.longer.than.thirty.two.characters": [12.5, 0.0001],
}


def _fill(registry):
    j_prof.reset_timings()
    t_prof.reset_timings()
    for name, vals in registry.items():
        j_prof._TIMINGS[name].extend(vals)
        for val in vals:
            t_prof.add_time(name, val)


@pytest.fixture
def registry():
    _fill(REGISTRY)
    yield
    for module in (j_prof, t_prof):
        module.reset_timings()


def test_timings_and_report_match_jax(registry):
    assert t_prof.timings() == j_prof.timings()
    text = t_prof.report()
    assert text == j_prof.report()
    assert text.splitlines()[1].startswith(
        "a.phase.name.longer.than.thirty.two.characters")
    printed = io.StringIO()
    assert t_prof.report(file=printed) == text
    assert printed.getvalue() == text + "\n"


@pytest.mark.parametrize("total_s, prefix, n_items", [
    (9.75, "ht1d", 960), (3.0, "ht1d", 17), (2.5, "ht2d", 512)])
def test_steady_state_matches_jax(registry, total_s, prefix, n_items):
    got = t_prof.steady_state(total_s, prefix, n_items)
    assert got == j_prof.steady_state(total_s, prefix, n_items)
    assert set(got) == {"oneoff_s", "steady_s", "steady_items_per_s"}


def test_steady_state_single_tile_reports_plain_throughput():
    """The JAX package's pinned case, through both packages."""
    out = {}
    for module in (j_prof, t_prof):
        module.reset_timings()
        with module.phase("x.dispatch"):
            pass
        with module.phase("x.harvest"):
            threading.Event().wait(0.01)
        out[module] = module.steady_state(2.0, "x", 100)
        module.reset_timings()
    assert out[t_prof] == out[j_prof]
    assert out[t_prof]["oneoff_s"] == 0.0
    assert out[t_prof]["steady_items_per_s"] == 50.0


def test_steady_state_counts_the_port_import_once():
    """The port has no warm join; its first ``gev.refine.import`` is added
    to the first pack, and later (cached) imports are not."""
    port = {name: vals for name, vals in REGISTRY.items()
            if name != "ht1d.warmjoin"}
    _fill(port)
    try:
        without = t_prof.steady_state(9.75, "ht1d", 960)
        assert without == j_prof.steady_state(9.75, "ht1d", 960)
        for val in (1.5, 0.25, 0.25):
            t_prof.add_time("ht1d.gev.refine.import", val)
        got = t_prof.steady_state(9.75, "ht1d", 960)
    finally:
        t_prof.reset_timings()
        j_prof.reset_timings()
    oneoff = 0.75 + 1.5 + 0.5 + 2.25  # first pack, first import, first
    # dispatch, largest harvest
    assert got["oneoff_s"] == round(oneoff, 2)
    assert without["oneoff_s"] == round(oneoff - 1.5, 2)
    assert got["steady_s"] == round(9.75 - oneoff, 2)
    assert got["steady_items_per_s"] == round(960 * 3 / 4 / (9.75 - oneoff), 2)


def test_sync_pull_matches_jax():
    rng = np.random.default_rng(5)
    arrays = [rng.standard_normal(shape).astype(np.float32)
              for shape in ((64, 3), (1000,), (7, 5, 2), (1,))]
    arrays[0][3, 1] = np.nan
    arrays[1][::97] = np.nan
    arrays[3][0] = np.nan  # a leaf that is all NaN sums to 0

    def nest(a):
        return {"coef": a[0], "rest": [a[1], (a[2], {"tail": a[3]})],
                "label": "not an array"}

    want = j_prof.sync_pull(nest([jnp.asarray(a) for a in arrays]))
    got = t_prof.sync_pull(nest([torch.from_numpy(a) for a in arrays]))
    assert isinstance(got, float)
    np.testing.assert_allclose(got, want, rtol=1e-6)
    np.testing.assert_allclose(
        got, sum(float(np.nansum(a, dtype=np.float64)) for a in arrays),
        rtol=1e-6)


def test_device_trace_without_logdir_is_a_noop(tmp_path):
    with t_prof.device_trace(None) as prof:
        assert prof is None
    with t_prof.device_trace() as prof:  # no logdir: no device resolved
        assert prof is None
    assert list(tmp_path.iterdir()) == []


def test_device_trace_on_cpu_holds_the_phases_of_every_thread(tmp_path):
    logdir = tmp_path / "trace"
    t_prof.reset_timings()
    try:
        with t_prof.device_trace(str(logdir), device="cpu") as prof:
            with t_prof.phase("t.outer"):
                x = torch.ones(64, 64)

                def worker():
                    with t_prof.phase("t.worker"):
                        (x @ x).sum()

                thread = threading.Thread(target=worker)
                thread.start()
                thread.join(timeout=30)
                assert not thread.is_alive()
        assert prof is not None
        assert any(e.key == "t.outer" for e in prof.key_averages())
        assert set(t_prof.timings()) == {"t.outer", "t.worker"}
    finally:
        t_prof.reset_timings()
    with open(logdir / t_prof.TRACE_FILE) as f:
        events = json.load(f)["traceEvents"]
    ranges = {(e["name"], e["tid"]) for e in events
              if e.get("cat") == "user_annotation"}
    names = {name for name, _ in ranges}
    assert {"t.outer", "t.worker"} <= names
    assert len({tid for _, tid in ranges}) == 2  # two threads' rows


def test_device_trace_needs_cuda_for_the_default_device(tmp_path,
                                                        monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        with t_prof.device_trace(str(tmp_path / "trace")):
            pass
    assert not (tmp_path / "trace").exists()


@pytest.fixture(scope="module")
def chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _x(name, cat, ts, dur, tid, pid=1):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "pid": pid, "tid": tid}


# a hand-made trace, µs: device busy 100-350 (a kernel and a copy that
# overlap it) and 700-850 (two kernels) in a window of 0-1000; idle gaps
# 0-100, 350-700 and 850-1000, the longest under a pack on another thread
HAND_TRACE = {"traceEvents": [
    {"ph": "M", "name": "process_name", "pid": 1, "args": {"name": "host"}},
    _x("aten::copy_", "cpu_op", 0, 1000, tid=10),
    _x("x.dispatch", "user_annotation", 0, 300, tid=10),
    _x("x.compress+pack", "user_annotation", 300, 500, tid=11),
    _x("x.harvest", "user_annotation", 400, 100, tid=10),
    _x("x.gev.join", "user_annotation", 860, 140, tid=12),
    _x("cudaLaunchKernel", "cuda_runtime", 90, 5, tid=10),
    _x("k1", "kernel", 100, 200, tid=7, pid=0),
    _x("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy", 250, 100, tid=8,
       pid=0),
    _x("x.dispatch", "gpu_user_annotation", 100, 250, tid=7, pid=0),
    _x("k1", "kernel", 700, 100, tid=7, pid=0),
    _x("k2", "kernel", 800, 50, tid=7, pid=0),
    {"ph": "i", "name": "marker", "ts": 2000, "pid": 1, "tid": 10},
]}


def test_trace_summary_on_a_hand_made_trace(tmp_path, chip_smoke):
    path = tmp_path / "trace.json"
    path.write_text(json.dumps(HAND_TRACE))
    got = chip_smoke.trace_summary(str(path))
    assert got["window_s"] == 1000 / 1e6
    assert got["busy_share"] == 0.4
    assert got["device_events"] == 4
    assert got["ops"] == [
        {"name": "k1", "count": 2, "ms": 0.3},
        {"name": "Memcpy HtoD (Pageable -> Device)", "count": 1, "ms": 0.1},
        {"name": "k2", "count": 1, "ms": 0.05}]
    assert got["gaps"] == [
        {"at_ms": 0.35, "ms": 0.35,
         "phases": [["x.compress+pack", 0.35], ["x.harvest", 0.1]]},
        {"at_ms": 0.85, "ms": 0.15, "phases": [["x.gev.join", 0.14]]},
        {"at_ms": 0.0, "ms": 0.1, "phases": [["x.dispatch", 0.1]]}]
    assert got["bytes"] == path.stat().st_size


def test_trace_summary_without_device_events(tmp_path, chip_smoke):
    host_only = {"traceEvents": [e for e in HAND_TRACE["traceEvents"]
                                 if e.get("pid") != 0]}
    path = tmp_path / "trace.json"
    path.write_text(json.dumps(host_only))
    got = chip_smoke.trace_summary(str(path))
    assert got["busy_share"] is None
    assert got["device_events"] == 0 and got["ops"] == []
    assert got["gaps"][0]["ms"] == 1.0  # the whole window
