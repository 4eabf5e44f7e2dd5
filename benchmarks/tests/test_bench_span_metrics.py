"""The readers of the program's spans and counters on hand-made runs: each
reads its spans per request of the window, and nothing when the run is
untraced, of the other kind, or the spans are absent (a program that does
not record them)."""

import sys

import pytest

from benchmarks import run


def reader(name):
    return run.load_module(run.ROOT / "benchmarks" / "metrics"
                           / f"{name}.py", "s_" + name.replace(".", "_"))


def summary():
    return {"window_s": 4.0, "busy_s": 0.5, "device_events": 1, "ops": [],
            "top_ops": 10, "gaps": [], "bytes": 1}


# per-span seconds over a window of two requests
PHASES_1D = {
    "setup_memento.layout": 0.25, "create_groups.labels": 0.5,
    "create_groups.split": 1.0, "compute_1d_moments.subset": 0.25,
    "setup_memento.size_factor": 0.5, "setup_memento.moments": 0.25,
    "setup_memento.fit": 0.125, "compute_1d_moments.sf_bins": 0.125,
    "compute_1d_moments.observed": 1.5, "compute_1d_moments.filter": 0.375,
    "compute_1d_moments.fit": 0.125,
    "ht1d.pack.wait": 0.75, "ht1d.launch": 2.0, "ht1d.launch.wait": 1.5,
    "ht1d.harvest.wait": 0.5, "ht1d.gev.fit": 3.0,
}
PHASES_2D = {"ht2d.pack.wait": 0.1, "ht2d.launch": 0.9,
             "ht2d.launch.wait": 0.3, "ht2d.harvest.wait": 0.2}


def view(kind, phases, traced=True):
    t = run.Traced(phases=phases, spans={}, n=2, kind=kind,
                   summary=summary(), n_profiled=1)
    return run.RunView(kind=kind, records=[], window_s=3.5,
                       setup_s=1.0, peak_host_bytes=1,
                       traced=t if traced else None)


WANT = {
    ("1d", "api_layout_s.1d"): (0.25 + 0.5 + 1.0 + 0.25) / 2,
    ("1d", "api_stats_s.1d"): (0.5 + 0.25 + 0.125 + 0.125 + 1.5 + 0.375
                               + 0.125) / 2,
    ("1d", "pack_wait_s.1d"): 0.375,
    ("2d", "pack_wait_s.2d"): 0.05,
    ("1d", "launch_s.1d"): 0.25,
    ("2d", "launch_s.2d"): 0.3,
    ("1d", "device_wait_s.1d"): 1.0,
    ("2d", "device_wait_s.2d"): 0.25,
    ("1d", "gev_fit_s.1d"): 1.5,
}
PHASES = {"1d": PHASES_1D, "2d": PHASES_2D}


@pytest.mark.parametrize("kind,name", sorted(WANT))
def test_span_reader(kind, name):
    assert reader(name).read(view(kind, PHASES[kind])) == \
        pytest.approx(WANT[(kind, name)])
    other = "2d" if kind == "1d" else "1d"
    assert reader(name).read(view(other, PHASES[kind])) is None
    assert reader(name).read(view(kind, PHASES[kind], traced=False)) is None
    assert reader(name).read(view(kind, {"ht1d.dispatch": 1.0})) is None


def test_launch_without_waits_is_all_launch():
    phases = {"ht1d.launch": 0.5}  # a sampler that reads nothing back
    assert reader("launch_s.1d").read(view("1d", phases)) == 0.25


@pytest.fixture
def program_counters(monkeypatch):
    from memento_tpu_torch.utils import profiling

    def put(found):
        monkeypatch.setattr(profiling, "counters", lambda: dict(found))
    return put


def test_gev_fits_per_row(program_counters):
    read = reader("gev_fits_per_row.1d").read
    program_counters({"ht1d.gev.rows": 40, "ht1d.gev.fit_rows": 130,
                      "ht2d.gev.rows": 7})
    assert read(view("1d", PHASES_1D)) == pytest.approx(3.25)
    assert read(view("1d", PHASES_1D, traced=False)) is None
    assert read(view("2d", PHASES_2D)) is None
    program_counters({"ht2d.gev.rows": 7})  # no 1D refit
    assert read(view("1d", PHASES_1D)) is None


def test_gev_fits_per_row_without_program_counters(monkeypatch):
    """A program whose recorder keeps no counters reads nothing."""
    from memento_tpu_torch.utils import profiling

    monkeypatch.delattr(profiling, "counters")
    assert reader("gev_fits_per_row.1d").read(view("1d", PHASES_1D)) is None
    monkeypatch.delitem(sys.modules, "memento_tpu_torch.utils.profiling")
    assert reader("gev_fits_per_row.1d").read(view("1d", PHASES_1D)) is None


def test_every_span_metric_is_tested():
    """The metrics of the program's spans and counters have readers and
    are tested here; with those of ``test_bench_metrics.py`` they are
    every metric of ``BENCHMARK.json``."""
    spec = run.load_json(run.ROOT / "BENCHMARK.json")
    names = {m["name"] for m in spec["end_to_end"] + spec["per_layer"]}
    ours = {n for _, n in WANT} | {"gev_fits_per_row.1d"}
    for name in ours:
        assert (run.ROOT / "benchmarks" / "metrics" / f"{name}.py").exists()
    older = run.load_module(
        run.ROOT / "benchmarks" / "tests" / "test_bench_metrics.py",
        "s_test_bench_metrics")
    assert ours <= names
    assert ours | {n for _, n in older.EXPECTED} == names
