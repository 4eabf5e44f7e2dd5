"""The device trace of a run's first requests, and what it says.

``summarize`` is a frozen copy of ``chip_smoke.py::trace_summary`` (at
commit dd20120), widened to ten operations and ten gaps and given the busy
seconds: the window spans every complete event of the trace; device
activity is its kernels, copies and memsets; the busy time is the union of
their intervals; the operations are the device events summed by name; the
gaps are the longest intervals with no device activity, each with the host
ranges (``user_annotation``: the program's phase names and the harness's
spans, on any thread) that overlap it most.

The profiler records host activity on every thread (the program packs on a
prefetch thread and refits tails on a worker) and CUDA activity.  The trace
goes to a temporary directory under ``TMPDIR`` and is deleted once read.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
from pathlib import Path

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
TRACE_FILE = "trace.json"


def _profile(device):
    from torch.profiler import ProfilerActivity, _ExperimentalConfig, profile

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    return profile(activities=activities,
                   experimental_config=_ExperimentalConfig(
                       profile_all_threads=True))


def first_start(device) -> None:
    """Start and stop the profiler once on a trivial region: its first start
    (CUPTI's) takes seconds, and belongs to set-up."""
    import torch

    with _profile(device):
        x = torch.ones(16, device=device)
        (x * 2).sum().item()


def start(device):
    prof = _profile(device)
    prof.__enter__()
    return prof


def stop(prof, tmpdir) -> dict:
    """Stop the profiler, write its trace into a new directory under
    ``tmpdir``, read and delete it; the summary."""
    prof.__exit__(None, None, None)
    trace_dir = Path(tempfile.mkdtemp(prefix="bench-trace-", dir=tmpdir))
    path = trace_dir / TRACE_FILE
    try:
        prof.export_chrome_trace(str(path))
        return summarize(path)
    finally:
        shutil.rmtree(trace_dir, ignore_errors=True)


def summarize(path, n_ops: int = 10, n_gaps: int = 10) -> dict:
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X" and "dur" in e]
    lo = min(e["ts"] for e in events)
    hi = max(e["ts"] + e["dur"] for e in events)
    device = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                    if e.get("cat") in DEVICE_CATEGORIES)
    busy, gaps, cursor = 0.0, [], lo
    for begin, end in device:
        if begin > cursor:
            gaps.append((cursor, begin))
        busy += max(0.0, end - max(begin, cursor))
        cursor = max(cursor, end)
    if hi > cursor:
        gaps.append((cursor, hi))
    ops = {}
    for e in events:
        if e.get("cat") in DEVICE_CATEGORIES:
            count, us = ops.get(e["name"], (0, 0.0))
            ops[e["name"]] = (count + 1, us + e["dur"])
    ranges = [e for e in events if e.get("cat") == "user_annotation"]

    def overlapping(begin, end):
        by_name = {}
        for e in ranges:
            overlap = min(end, e["ts"] + e["dur"]) - max(begin, e["ts"])
            if overlap > 0:
                by_name[e["name"]] = by_name.get(e["name"], 0.0) + overlap
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:3]
        return [[name, us / 1e6] for name, us in top]

    longest = sorted(gaps, key=lambda g: g[0] - g[1])[:n_gaps]
    return {
        "window_s": (hi - lo) / 1e6,
        "busy_s": busy / 1e6 if device else None,
        "device_events": len(device),
        "ops": [{"name": name, "count": count, "s": us / 1e6}
                for name, (count, us) in sorted(ops.items(),
                                                key=lambda kv: -kv[1][1])],
        "top_ops": n_ops,
        "gaps": [{"at_s": (begin - lo) / 1e6, "s": (end - begin) / 1e6,
                  "phases": overlapping(begin, end)}
                 for begin, end in longest],
        "bytes": os.path.getsize(path),
    }


def breakdown(summary: dict) -> dict:
    """The result line's ``breakdown``: the device operations that took
    most time and the longest idle gaps, named by the host ranges over
    them."""
    gaps = []
    for g in summary["gaps"]:
        over = ", ".join(name for name, _ in g["phases"]) or "no host range"
        gaps.append([f"idle at {g['at_s']:.3f} s under {over}", g["s"]])
    return {"device_ops": [[op["name"], op["s"]]
                           for op in summary["ops"][:summary["top_ops"]]],
            "idle_gaps": gaps}


__all__ = ["first_start", "start", "stop", "summarize", "breakdown",
           "DEVICE_CATEGORIES"]
