"""Each metric's reader on a hand-made run, and the trace summary on a
hand-made Chrome trace."""

import json

import numpy as np
import pytest
import torch

from benchmarks import run, tracing

SPEC = run.load_json(run.ROOT / "BENCHMARK.json")
METRICS = {m["name"]: m for m in SPEC["end_to_end"] + SPEC["per_layer"]}


def reader(name):
    return run.load_module(run.ROOT / "benchmarks" / "metrics"
                           / f"{name}.py", "t_" + name.replace(".", "_"))


def records(kind):
    # three requests: 0-1 s, 1-3 s, 3-3.5 s
    spans = [(0.0, 1.0, 100), (1.0, 3.0, 300), (3.0, 3.5, 50)]
    return [run.Record(index=i, request={}, start_s=a, end_s=b, work=w)
            for i, (a, b, w) in enumerate(spans)]


def summary():
    return {"window_s": 4.0, "busy_s": 0.5, "device_events": 3,
            "ops": [{"name": "binomial_kernel", "count": 2, "s": 0.004},
                    {"name": "Memcpy HtoD", "count": 5, "s": 0.001}],
            "top_ops": 10, "gaps": [], "bytes": 1}


def view(kind, traced=True):
    t = run.Traced(
        phases={f"ht{kind}.compress+pack": 0.6, f"ht{kind}.gev.join": 0.2,
                f"ht{kind}.dispatch": 0.4},
        spans={"api.setup_memento": 0.1, "api.create_groups": 0.3,
               "api.compute_1d_moments": 0.2, "api.compute_2d_moments": 0.8},
        n=2, kind=kind, summary=summary(), n_profiled=1)
    return run.RunView(kind=kind, records=records(kind),
                       window_s=3.5, setup_s=12.5,
                       peak_host_bytes=3 * 2**30,
                       traced=t if traced else None)


EXPECTED = {
    ("1d", "tests_1d_per_s"): 450 / 3.5,
    ("2d", "pairs_2d_per_s"): 450 / 3.5,
    ("1d", "pairs_2d_per_s"): None,
    ("2d", "tests_1d_per_s"): None,
    ("1d", "peak_host_gib"): 3.0,
    ("1d", "setup_s"): 12.5,
    ("1d", "api_host_s.1d"): 0.3,
    ("2d", "api_host_s.2d"): 0.4,
    ("2d", "api_host_s.1d"): None,
    ("1d", "pack_s.1d"): 0.3,
    ("2d", "pack_s.2d"): 0.3,
    ("1d", "gev_wait_s.1d"): 0.1,
    ("2d", "gev_wait_s.2d"): 0.1,
    ("1d", "dispatch_s.1d"): 0.2,
    ("2d", "dispatch_s.1d"): None,
    ("2d", "dispatch_s.2d"): 0.2,
    ("1d", "device_idle_share.1d"): 87.5,
    ("2d", "device_idle_share.2d"): 87.5,
    ("1d", "device_idle_share.2d"): None,
}


@pytest.mark.parametrize("kind,name", sorted(EXPECTED))
def test_reader(kind, name):
    got = reader(name).read(view(kind))
    want = EXPECTED[(kind, name)]
    if want is None:
        assert got is None
    else:
        assert got == pytest.approx(want)


def test_every_metric_has_a_reader_and_is_tested():
    for name in METRICS:
        assert (run.ROOT / "benchmarks" / "metrics" / f"{name}.py").exists()
    assert {n for _, n in EXPECTED} == set(METRICS)


@pytest.mark.parametrize("name", [m["name"] for m in SPEC["per_layer"]])
def test_layer_metric_reads_nothing_untraced(name):
    assert reader(name).read(view(name.rsplit(".", 1)[1], traced=False)) \
        is None


def test_trace_summary(tmp_path):
    # host range 0-100 us; kernels 10-20 and 15-30 (overlapping), a copy
    # 60-70; the trace spans 0-100
    events = [
        {"ph": "X", "cat": "user_annotation", "name": "ht1d.dispatch",
         "ts": 0, "dur": 50},
        {"ph": "X", "cat": "user_annotation", "name": "ht1d.gev.join",
         "ts": 50, "dur": 50},
        {"ph": "X", "cat": "kernel", "name": "k", "ts": 10, "dur": 10},
        {"ph": "X", "cat": "kernel", "name": "k", "ts": 15, "dur": 15},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 60,
         "dur": 10},
        {"ph": "i", "cat": "kernel", "name": "instant", "ts": 5},
    ]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    s = tracing.summarize(path)
    assert s["window_s"] == pytest.approx(100e-6)
    assert s["busy_s"] == pytest.approx(30e-6)  # 10-30 and 60-70
    assert s["ops"][0] == {"name": "k", "count": 2, "s": pytest.approx(25e-6)}
    longest = s["gaps"][0]
    assert longest["s"] == pytest.approx(30e-6)  # 30-60
    assert longest["phases"][0][0] == "ht1d.dispatch"
    b = tracing.breakdown(s)
    assert b["device_ops"][0] == ["k", pytest.approx(25e-6)]
    assert len(b["idle_gaps"]) == 3 and all(
        isinstance(name, str) and sec > 0 for name, sec in b["idle_gaps"])


class _Runner:
    """Requests of a cycle of three; the second one traced."""

    kind, cycle = "1d", 3

    def __init__(self):
        self.done = 0

    def requests(self):
        i = 0
        while True:
            yield i
            i += 1

    def traced(self, index):
        return index == 1

    def run(self, request, spans):
        spans["api.x"] = 0.001
        self.done += 1
        return None, 1


def test_window_runs_whole_cycles(monkeypatch):
    import time

    monkeypatch.setattr(run, "phase_totals", lambda program: {})
    monkeypatch.setattr(tracing, "start", lambda device: object())
    monkeypatch.setattr(tracing, "stop", lambda prof, tmpdir: {"n": 1})
    device = torch.device("cpu")
    t0 = time.perf_counter()
    records, window_s, traced = run.run_window(_Runner(), 0.0, True, None,
                                               device, None)
    assert len(records) == 3 and window_s <= time.perf_counter() - t0
    assert traced.n == 3 and traced.n_profiled == 1
    assert traced.spans == {"api.x": pytest.approx(0.003)}
    assert traced.summary == {"n": 1}
