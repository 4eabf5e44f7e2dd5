"""Run one cell of the benchmark once.

    python3 -m benchmarks.run --workload NAME --seed N --seconds S --trace 0|1

from the root of a checkout.  The cell, its configuration, its traffic mix
and its metrics are found by name: ``BENCHMARK.json`` names them, and each
has a file of its own under ``benchmarks/`` (``configs/<config>.json``,
``traffic/<mix>.json``, whose ``kind`` names ``kinds/<kind>.py``,
``checks/<workload>.json`` for the limits of the comparison, and
``metrics/<metric>.py`` for each metric).  Adding a cell adds files and
entries, and edits none of these.

A run: set-up (imports, the data drawn on the card from ``--seed``, one
warm-up request of the cell's own shape, and with ``--trace 1`` the
profiler's first start), then requests back to back, closed loop with one
client, in whole cycles of the traffic until ``--seconds`` have passed (the
cycle running then finishes and counts), then the comparison of a sample of
the window's requests with the plain reference (``benchmarks/reference.py``).
A traced run profiles the requests that the request kind names and reads
the program's phases and the harness's spans over the whole window.  The last line on
standard output is one JSON object; the numbers compared, each beside its
limit, are the last lines on standard error.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()  # set-up counts from here: imports included

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import traceback  # noqa: E402
from dataclasses import dataclass, field  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Optional  # noqa: E402

from . import resources, tracing  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# module names that must not be loaded, compared by whole top-level name
BLOCKED = ("jax", "jaxlib", "flax", "memento_tpu")


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def blocked_modules() -> list:
    """The loaded modules whose top-level name is blocked."""
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(BLOCKED))


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    """A module from its file, so that names with dots load too."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    """Everything one workload needs, found by the names in
    ``BENCHMARK.json``."""

    name: str
    chips: int
    config: dict
    traffic: dict
    checks: dict
    end_to_end: list
    per_layer: list
    root: Path

    def kind(self):
        return load_module(self.root / "benchmarks" / "kinds"
                           / f"{self.traffic['kind']}.py",
                           f"bench_kind_{self.traffic['kind']}")

    def reader(self, metric: dict):
        return load_module(self.root / "benchmarks" / "metrics"
                           / f"{metric['name']}.py",
                           "bench_metric_" + metric["name"].replace(".", "_"))


def applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def find_cell(root: Path, workload: str) -> Cell:
    spec = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; "
                         f"known: {sorted(cells)}")
    w = cells[workload]
    configs = {c["name"]: c for c in spec["configs"]}
    bench = root / "benchmarks"
    return Cell(
        name=workload, chips=int(w["chips"]),
        config=load_json(root / configs[w["config"]]["file"]),
        traffic=load_json(bench / "traffic" / f"{w['traffic']}.json"),
        checks=load_json(bench / "checks" / f"{workload}.json"),
        end_to_end=[m for m in spec["end_to_end"] if applies(m, workload)],
        per_layer=[m for m in spec["per_layer"] if applies(m, workload)],
        root=root)


@dataclass
class Record:
    """One request of the window."""

    index: int
    request: object
    start_s: float  # from the window's start
    end_s: float
    work: int = 0  # tests or pairs completed (0 if it failed)
    error: Optional[str] = None
    result: object = None
    spans: dict = field(default_factory=dict)  # the harness's own spans


@dataclass
class Traced:
    """What a traced run's window left: the program's phases and the
    harness's spans summed over every request of the window, their number,
    the request kind, and the summary of the device trace of the requests
    that the kind profiles (``Runner.traced``), with their number."""

    phases: dict
    spans: dict
    n: int
    kind: str
    summary: dict
    n_profiled: int


@dataclass
class RunView:
    """What a metric's reader reads."""

    kind: str  # "1d" or "2d"
    records: list
    window_s: float  # from the window's start to the last completion
    setup_s: float
    peak_host_bytes: int
    traced: Optional[Traced] = None


def phase_totals(program) -> dict:
    """The program's phase registry as ``{name: total seconds}``."""
    return {k: v["total_s"]
            for k, v in program.utils.profiling.timings().items()}


def delta(after: dict, before: dict) -> dict:
    return {k: v - before.get(k, 0.0) for k, v in after.items()
            if v - before.get(k, 0.0) > 0}


def run_window(runner, seconds: float, trace: bool, program, device,
               tmpdir: Path):
    """Requests back to back, in whole cycles of the traffic
    (``runner.cycle`` requests), until ``seconds`` have passed: the cycle
    running then finishes and counts, so every run does whole cycles of
    the same mix.  With ``trace``, the requests that ``runner.traced(i)``
    names run under the profiler.  Returns (records, window_s, traced)."""
    import torch

    records, spans_all = [], {}
    phases0 = phase_totals(program)
    profiler, summary, n_profiled = None, None, 0
    t0 = time.perf_counter()
    for i, request in enumerate(runner.requests()):
        if trace and summary is None and profiler is None \
                and runner.traced(i):
            profiler = tracing.start(device)
        spans = {}
        r0 = time.perf_counter() - t0
        rec = Record(index=i, request=request, start_s=r0, end_s=r0,
                     spans=spans)
        try:
            rec.result, rec.work = runner.run(request, spans)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
        except Exception:  # a failed request is counted, and the run goes on
            rec.error = traceback.format_exc()
            rec.work = 0
            log(f"request {i} failed:\n{rec.error}")
        rec.end_s = time.perf_counter() - t0
        records.append(rec)
        for k, v in spans.items():
            spans_all[k] = spans_all.get(k, 0.0) + v
        if profiler is not None:
            n_profiled += 1
            if not runner.traced(i + 1):
                summary, profiler = tracing.stop(profiler, tmpdir), None
        if rec.end_s >= seconds and (i + 1) % runner.cycle == 0:
            break
    traced = None
    if trace:
        if profiler is not None:  # only if the loop ended early
            summary = tracing.stop(profiler, tmpdir)
        traced = Traced(phases=delta(phase_totals(program), phases0),
                        spans=spans_all, n=len(records), kind=runner.kind,
                        summary=summary, n_profiled=n_profiled)
    return records, records[-1].end_s if records else 0.0, traced


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
             tmpdir: Path) -> dict:
    """Set-up, window and comparison of one run; the result's object."""
    import torch

    import memento_tpu_torch as program
    import memento_tpu_torch.utils.profiling  # noqa: F401  (phase_totals)

    from . import data

    device = torch.device(device)
    t_draw = time.perf_counter()
    dataset = data.draw(cell.config, seed, device)
    log(f"data: {len(dataset.genes)} genes, "
        f"{sum(t.n_cells for t in dataset.types)} cells, nnz {dataset.nnz}, "
        f"drawn in {time.perf_counter() - t_draw:.3f} s")
    runner = cell.kind().Runner(program, dataset, cell.config, cell.traffic,
                                seed, device)
    t_warm = time.perf_counter()
    runner.warm()
    log(f"warm-up request: {time.perf_counter() - t_warm:.3f} s")
    if trace:
        tracing.first_start(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - T_START

    records, window_s, traced = run_window(runner, seconds, trace, program,
                                           device, tmpdir)
    peak_host = resources.peak_host_rss_bytes()
    peak_dev = resources.peak_device_bytes(device)
    failed = sum(r.error is not None for r in records)
    log(f"window: {len(records)} requests in {window_s:.3f} s, "
        f"{failed} failed, work {sum(r.work for r in records)} "
        f"{runner.unit}; program counters {runner.counters()}")
    log("request seconds: " + " ".join(
        f"{r.end_s - r.start_s:.3f}" for r in records))

    view = RunView(kind=runner.kind, records=records,
                   window_s=window_s, setup_s=setup_s,
                   peak_host_bytes=peak_host, traced=traced)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = cell.reader(m).read(view)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
        elif not trace:
            log(f"end-to-end metric {m['name']} read nothing")

    # the comparison, once the program's state is freed
    runner.release()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    check = runner.check(records, cell.checks)
    log(f"comparison: {time.perf_counter() - t_check:.3f} s, "
        f"{check['compared']} requests compared; numbers without a limit: "
        f"{json.dumps(check['others'])}")
    failed += check["failed_requests"]
    correct = bool(check["within"]) and failed == 0 and bool(records)

    out = {
        "correct": correct,
        "attempted": len(records),
        "failed": int(failed),
        "metrics": metrics,
        "device": resources.device_info(device, peak_dev),
    }
    if traced is not None and traced.summary is not None:
        log(f"trace: {traced.n_profiled} requests profiled, "
            f"{traced.summary['device_events']} device events, "
            f"{traced.summary['bytes']} bytes")
        out["device"]["busy_s"] = traced.summary["busy_s"]
        out["device"]["window_s"] = traced.summary["window_s"]
        out["breakdown"] = tracing.breakdown(traced.summary)
    out["compared"] = check["numbers"]
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    cell = find_cell(ROOT, args.workload)
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        log(f"{cell.name} needs {cell.chips} CUDA device(s); "
            f"torch.cuda.is_available() is {torch.cuda.is_available()}")
        return 2
    tmpdir = Path(tempfile.gettempdir())
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                   torch.device("cuda", 0), tmpdir)
    found = blocked_modules()
    if found:
        log(f"loaded blocked modules: {found}")
        return 3
    for name, (value, limit) in out["compared"].items():
        log(f"{name} {value!r} limit {limit!r}")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
