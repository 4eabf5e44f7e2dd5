"""The port's span recorder (``memento_tpu_torch/utils/profiling.py``) on
the CPU.

A small 1D and 2D analysis through the API: every span carries the request
id of the API call that caused it, on the prefetch and GEV threads too, and
its parent is the span that was open where it began; the registry's totals
are the sums of the span records; the exported spans line up with the
``record_function`` ranges of a ``torch.profiler`` trace taken over the same
region; the ring keeps its bound; and the results do not depend on what the
recorder holds.  An empty request returns empty results.
"""

import collections
import json
import threading

import numpy as np
import pytest
import scipy.sparse as sparse
import torch

import memento_tpu_torch as mtt
from memento_tpu_torch.utils import profiling

torch.set_num_threads(1)

API_ROOTS = {"setup_memento", "create_groups", "get_groups",
             "compute_1d_moments", "ht_1d_moments", "get_1d_ht_result",
             "compute_2d_moments", "ht_2d_moments", "get_2d_ht_result"}


@pytest.fixture(autouse=True)
def clean_registry():
    profiling.reset_timings()
    yield
    profiling.reset_timings()


def _adata(seed=3, n=800, g=40):
    rng = np.random.default_rng(seed)
    lam = rng.gamma(2.0, rng.uniform(0.3, 3.0, g) / 2.0, size=(n, g))
    cond = rng.integers(0, 2, n)
    # planted effects, so that the GEV refit has tails to fit: a mean
    # shift, and a factor shared by the first genes' counts (correlation)
    lam[cond == 1, :6] *= 1.8
    lam[cond == 1, :24] *= rng.gamma(3.0, 1 / 3.0, (cond == 1).sum())[:, None]
    X = rng.poisson(lam).astype(np.float64)
    obs = mtt.ColumnTable({"condition": cond.astype(str),
                           "donor": rng.integers(0, 2, n).astype(str),
                           "capture_q": np.full(n, 0.1)})
    return mtt.AnnData(sparse.csr_matrix(X), obs=obs)


def _design(adata):
    groups = mtt.get_groups(adata)
    tx = np.asarray(groups["condition"], np.float64)[:, None]
    return np.ones((tx.shape[0], 1)), tx


def _setup(adata, thresh=0.05):
    mtt.setup_memento(adata, q_column="capture_q", filter_mean_thresh=thresh)
    mtt.create_groups(adata, label_columns=["condition", "donor"])
    mtt.compute_1d_moments(adata, min_perc_group=0.5)


HT = dict(num_boot=400, sampler="multinomial", tile_size=16, verbose=0,
          seed=11, device="cpu")


def run_1d(adata=None):
    adata = _adata() if adata is None else adata
    _setup(adata)
    cov, tx = _design(adata)
    mtt.ht_1d_moments(adata, covariate=cov, treatment=tx, **HT)
    return mtt.get_1d_ht_result(adata)


def run_2d():
    adata = _adata()
    _setup(adata)
    genes = list(adata.var.index)
    pairs = [(genes[0], b) for b in genes[1:21]] + \
        [(genes[1], b) for b in genes[2:22]]
    mtt.compute_2d_moments(adata, pairs)
    cov, tx = _design(adata)
    mtt.ht_2d_moments(adata, covariate=cov, treatment=tx, **HT)
    return mtt.get_2d_ht_result(adata)


RUNS = {"1d": run_1d, "2d": run_2d}


def _root(by_id, span):
    while span["parent"]:
        span = by_id[span["parent"]]
    return span


@pytest.mark.parametrize("path", ["1d", "2d"])
def test_every_span_carries_its_request_and_parent(path):
    RUNS[path]()
    records = profiling.spans()
    by_id = {sp["id"]: sp for sp in records}
    assert len(by_id) == len(records)
    roots = [sp for sp in records if not sp["parent"]]
    assert {sp["name"] for sp in roots} <= API_ROOTS
    assert len({sp["request"] for sp in roots}) == len(roots)
    assert all(sp["request"] > 0 for sp in roots)
    for sp in records:
        root = _root(by_id, sp)
        assert sp["request"] == root["request"], sp["name"]
        assert sp["name"] == root["name"] or sp["name"].startswith(
            (root["name"] + ".", f"ht{path}.")), (sp["name"], root["name"])
        parent = by_id.get(sp["parent"])
        if parent is not None and parent["thread"] == sp["thread"]:
            assert parent["start_ns"] <= sp["start_ns"]
            assert sp["end_ns"] <= parent["end_ns"]
        elif parent is not None:  # handed to another thread inside it
            assert parent["start_ns"] <= sp["start_ns"]

    label = f"ht{path}"
    (ht,) = [sp for sp in roots if sp["name"] == f"ht_{path}_moments"]

    def named(name):
        found = [sp for sp in records if sp["name"] == name]
        assert found, name
        return found

    def parent_names(name):
        return {by_id[sp["parent"]]["name"] for sp in named(name)}

    assert parent_names(f"{label}.launch") == {f"{label}.dispatch"}
    assert parent_names(f"{label}.launch.wait") == {f"{label}.launch"}
    assert parent_names(f"{label}.harvest.wait") == {f"{label}.harvest"}
    assert parent_names(f"{label}.gev.refine") == {f"{label}.harvest"}
    assert parent_names(f"{label}.gev.refine.wait") == {f"{label}.gev.refine"}
    assert parent_names(f"{label}.gev.fit") == {f"{label}.gev.refine"}
    assert parent_names(f"{label}.compress+pack") == {f"ht_{path}_moments"}
    assert parent_names(f"{label}.pack.wait") == {f"ht_{path}_moments"}
    # the packer and the refits run on threads of their own
    threads = {sp["thread"] for sp in records if sp["request"] == ht["request"]}
    assert len(threads) == 3
    for name in (f"{label}.compress+pack", f"{label}.gev.refine"):
        assert all(sp["thread"] != ht["thread"] for sp in named(name))
    for sp in named(f"{label}.launch"):
        assert sp["attrs"]["B"] == HT["num_boot"]
        assert sp["attrs"]["T"] == HT["tile_size"]
        assert sp["attrs"]["R"] == 4 and sp["attrs"]["U"] > 0
        assert sp["attrs"]["steps"] > 0  # one binomial step per bin
    counts = profiling.counters()
    rows = counts[f"{label}.gev.rows"]
    assert rows > 0 and counts[f"{label}.gev.fit_rows"] >= rows
    assert not {f"{label}.gev", f"{label}.refine"} & {sp["name"]
                                                        for sp in records}


def test_api_children_cover_their_calls():
    run_1d()
    tm = profiling.timings()
    children = {
        "setup_memento": ("layout", "size_factor", "moments", "fit"),
        "create_groups": ("labels", "split"),
        "compute_1d_moments": ("sf_bins", "observed", "filter", "subset",
                               "fit"),
    }
    for root, parts in children.items():
        inside = sum(tm[f"{root}.{p}"]["total_s"] for p in parts)
        assert inside <= tm[root]["total_s"]
        # the stretches between children are a few statements
        assert tm[root]["total_s"] - inside < 0.05 + 0.1 * tm[root]["total_s"]


@pytest.mark.parametrize("path", ["1d", "2d"])
def test_timings_are_the_sums_of_the_span_records(path):
    RUNS[path]()
    records = profiling.spans()
    sums = collections.defaultdict(float)
    counts = collections.Counter()
    for sp in records:
        sums[sp["name"]] += sp["s"]
        counts[sp["name"]] += 1
    tm = profiling.timings()
    assert set(tm) == set(sums)
    for name, agg in tm.items():
        assert agg["count"] == counts[name]
        assert agg["total_s"] == pytest.approx(sums[name], rel=1e-12)
        assert agg["first_s"] == next(sp["s"] for sp in records
                                      if sp["name"] == name)


def test_exported_spans_line_up_with_the_profiler_trace(tmp_path):
    logdir = tmp_path / "trace"
    with profiling.device_trace(str(logdir), device="cpu"):
        run_2d()
    with open(logdir / profiling.TRACE_FILE) as f:
        trace = json.load(f)
    with open(logdir / profiling.SPANS_FILE) as f:
        spans = json.load(f)
    assert spans["baseTimeNanoseconds"] == trace["baseTimeNanoseconds"]
    ranges = collections.defaultdict(list)
    for e in trace["traceEvents"]:
        if e.get("cat") == "user_annotation":
            ranges[(e["name"], e["tid"])].append(e["ts"])
    mine = collections.defaultdict(list)
    for e in spans["traceEvents"]:
        assert e["ph"] == "X" and e["dur"] >= 0
        assert {"id", "parent", "request"} <= set(e["args"])
        mine[(e["name"], e["tid"])].append(e["ts"])
    assert len(mine) > 20 and set(mine) <= set(ranges)
    for key, starts in mine.items():
        theirs = sorted(ranges[key])
        assert len(theirs) == len(starts), key
        for a, b in zip(sorted(starts), theirs):
            assert abs(a - b) < 2000.0, key  # µs, the same clock and base


def _starts(logdir):
    """(span start, its profiler range's start) in µs, per exported span."""
    with open(logdir / profiling.TRACE_FILE) as f:
        trace = json.load(f)
    with open(logdir / profiling.SPANS_FILE) as f:
        spans = json.load(f)
    ranges = collections.defaultdict(list)
    for e in trace["traceEvents"]:
        if e.get("cat") == "user_annotation":
            ranges[(e["name"], e["tid"])].append(e["ts"])
    mine = collections.defaultdict(list)
    for e in spans["traceEvents"]:
        mine[(e["name"], e["tid"])].append(e["ts"])
    return [(a, b) for key, starts in mine.items()
            for a, b in zip(sorted(starts), sorted(ranges[key]))]


def test_spans_line_up_while_another_thread_wants_the_lock(tmp_path):
    """A thread that runs Python the whole time takes the interpreter lock
    whenever a span lets it go; a span's start and its range's start are
    read with no switch between them, so they still agree."""
    stop = threading.Event()

    def spin():
        while not stop.is_set():
            pass

    spinner = threading.Thread(target=spin)
    logdir = tmp_path / "trace"
    with profiling.device_trace(str(logdir), device="cpu"):
        spinner.start()
        try:
            for i in range(40):
                with profiling.phase("contended", i=i):
                    sum(range(2000))
        finally:
            stop.set()
            spinner.join()
    pairs = _starts(logdir)
    assert len(pairs) == 40
    assert max(abs(a - b) for a, b in pairs) < 2000.0  # µs


def test_ring_keeps_its_bound(monkeypatch):
    monkeypatch.setattr(profiling, "_RING", collections.deque(maxlen=50))
    for i in range(200):
        with profiling.request("r"):
            with profiling.phase("r.child", i=i):
                pass
    records = profiling.spans()
    assert len(records) == 50
    assert records[-1]["name"] == "r" and records[-2]["attrs"] == {"i": 199}
    assert profiling.timings()["r.child"]["count"] == 200


def test_results_do_not_depend_on_the_ring():
    first = run_1d()
    assert len(profiling.spans()) > 30
    second = run_1d()  # the ring holds the first run's spans
    profiling.reset_timings()
    third = run_1d()
    for col in ("de_coef", "de_se", "de_pval", "dv_coef", "dv_se", "dv_pval"):
        for other in (second, third):
            np.testing.assert_array_equal(np.asarray(other[col]),
                                          np.asarray(first[col]))


def test_waits_counters_and_requests():
    with profiling.wait():  # outside a span: nothing
        pass
    with profiling.request("outer") as outer:
        with profiling.phase("outer.step"):
            with profiling.wait():
                with profiling.wait():  # a wait in a wait is not recorded
                    pass
        with profiling.request("inner") as inner:  # a call inside a call
            pass
        with profiling.device_phase("outer.dev", "cpu"):  # host clock
            pass
    profiling.count("c", 3)
    profiling.count("c")
    assert inner.request == outer.request > 0
    assert set(profiling.timings()) == {"outer", "outer.step",
                                        "outer.step.wait", "inner",
                                        "outer.dev"}
    assert profiling.counters() == {"c": 4}
    profiling.reset_timings()
    assert profiling.counters() == {} and profiling.spans() == []
    with profiling.request("next") as nxt:
        pass
    assert nxt.request > outer.request


def test_an_empty_request_returns_empty_results():
    """No gene passes the filter: the test runs no tile."""
    adata = _adata()
    _setup(adata, thresh=1e9)
    assert adata.n_vars == 0
    cov, tx = _design(adata)
    mtt.ht_1d_moments(adata, covariate=cov, treatment=tx, **HT)
    res = mtt.get_1d_ht_result(adata)
    assert len(res["gene"]) == 0 and len(res["de_pval"]) == 0
    assert "ht1d.dispatch" not in profiling.timings()


def test_threads_lose_no_update():
    """More threads than cores record spans and counts at once, with the
    interpreter switching threads as often as it can."""
    import os
    import sys
    import threading

    n_threads, n_each = 2 * (os.cpu_count() or 2) + 2, 500
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            with profiling.request("stress"):
                for _ in range(n_each):
                    with profiling.phase("stress.step"):
                        profiling.count("stress.n")

        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(interval)
    tm = profiling.timings()
    assert tm["stress.step"]["count"] == n_threads * n_each
    assert tm["stress"]["count"] == n_threads
    assert profiling.counters() == {"stress.n": n_threads * n_each}
    records = profiling.spans()
    assert len({sp["request"] for sp in records}) == n_threads
    assert len({sp["id"] for sp in records}) == len(records)
