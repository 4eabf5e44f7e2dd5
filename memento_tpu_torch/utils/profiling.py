"""Named phase timers, the device profiler and progress reporting.

Counterpart of ``memento_tpu/utils/profiling.py``.  CUDA work is
asynchronous: a phase given a CUDA ``device`` calls
``torch.cuda.synchronize`` before it reads the clock at both ends, so its
time covers the device work launched inside it.  Each phase is also a
``torch.profiler.record_function`` range, so a ``device_trace`` ties the
device's kernels and idle gaps to the host stage that ran around them.
"""

from __future__ import annotations

import contextlib
import os
import sys
import time
from collections import defaultdict
from typing import Dict, Optional

import torch

from ..device import resolve_device

_TIMINGS: Dict[str, list] = defaultdict(list)

TRACE_FILE = "trace.json"  # the Chrome trace ``device_trace`` writes


def _sync(device) -> None:
    if device is not None and torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def phase(name: str, device=None):
    """Time a named phase into the process-global registry."""
    with torch.profiler.record_function(name):
        _sync(device)
        t0 = time.perf_counter()
        try:
            yield
        finally:
            _sync(device)
            _TIMINGS[name].append(time.perf_counter() - t0)


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for value in tree.values():
            yield from _tensors(value)
    elif isinstance(tree, (list, tuple)):
        for value in tree:
            yield from _tensors(value)


def sync_pull(tree) -> float:
    """Wait for the device work behind every tensor in ``tree`` (nested
    dicts, lists and tuples) and return the sum of their ``nansum``s."""
    leaves = list(_tensors(tree))
    for dev in {leaf.device for leaf in leaves if leaf.is_cuda}:
        torch.cuda.synchronize(dev)
    return sum(float(leaf.nansum()) for leaf in leaves)


def timings() -> Dict[str, dict]:
    """Summary of all recorded phases."""
    return {
        name: {
            "count": len(vals),
            "total_s": sum(vals),
            "mean_s": sum(vals) / len(vals),
            "max_s": max(vals),
            "first_s": vals[0],
        }
        for name, vals in list(_TIMINGS.items())
    }


def reset_timings() -> None:
    _TIMINGS.clear()


def steady_state(total_s: float, prefix: str, n_items: int) -> Dict[str, float]:
    """Throughput of a tiled test run without its one-off costs.

    The one-off is what only the first tile pays: the first pack (the JAX
    package's first AOT warm join, where one ran beside it), the first
    ``{prefix}.gev.refine.import`` (the ``scipy.stats`` import, on the tile
    loop's thread after the pack, so added), the first dispatch and the
    largest harvest.  It comes off the wall time, and one tile's items come
    off the numerator.  A single-tile run reports its plain throughput.

    Args:
      total_s: wall time of the test.
      prefix: phase prefix, ``"ht1d"`` or ``"ht2d"``.
      n_items: genes or pairs tested.

    Returns:
      dict with ``oneoff_s``, ``steady_s``, ``steady_items_per_s``.
    """
    tm = timings()

    def get(name, key):
        return tm.get(name, {}).get(key, 0.0)

    n_tiles = max(int(tm.get(prefix + ".dispatch", {}).get("count", 1)), 1)
    if n_tiles < 2:
        return {
            "oneoff_s": 0.0,
            "steady_s": round(total_s, 2),
            "steady_items_per_s": round(n_items / max(total_s, 1e-9), 2),
        }
    oneoff = (max(get(prefix + ".warmjoin", "first_s"),
                  get(prefix + ".compress+pack", "first_s"))
              + get(prefix + ".gev.refine.import", "first_s")
              + get(prefix + ".dispatch", "first_s")
              + get(prefix + ".harvest", "max_s"))
    steady_s = max(total_s - oneoff, 1e-9)
    steady_items = n_items * (n_tiles - 1) / n_tiles
    return {
        "oneoff_s": round(oneoff, 2),
        "steady_s": round(steady_s, 2),
        "steady_items_per_s": round(steady_items / steady_s, 2),
    }


def report(file=None) -> str:
    """The phases as a table, longest total first."""
    lines = [
        f"{'phase':<32}{'count':>8}{'total(s)':>12}{'mean(s)':>12}{'max(s)':>12}"
    ]
    for name, s in sorted(timings().items(), key=lambda kv: -kv[1]["total_s"]):
        lines.append(
            f"{name:<32}{s['count']:>8}{s['total_s']:>12.3f}"
            f"{s['mean_s']:>12.4f}{s['max_s']:>12.3f}"
        )
    text = "\n".join(lines)
    if file is not None:
        print(text, file=file)
    return text


class ProgressReporter:
    """Items done, throughput and ETA for the tile orchestrators, printed to
    stderr at most every ``every_s`` seconds."""

    def __init__(self, total: int, unit: str = "genes", label: str = "ht",
                 every_s: float = 5.0, enabled: bool = True):
        self.total = int(total)
        self.unit = unit
        self.label = label
        self.every_s = every_s
        self.enabled = enabled
        self.done = 0
        self._t0 = time.perf_counter()
        self._last_print = self._t0
        self._file = sys.stderr

    def note(self, msg: str) -> None:
        if self.enabled:
            print(f"[{self.label}] {msg}", file=self._file, flush=True)

    def update(self, n: int) -> None:
        self.done += int(n)
        if not self.enabled:
            return
        now = time.perf_counter()
        if now - self._last_print < self.every_s and self.done < self.total:
            return
        self._last_print = now
        elapsed = now - self._t0
        rate = self.done / elapsed if elapsed > 0 else float("inf")
        eta = (self.total - self.done) / rate if rate > 0 else float("inf")
        print(
            f"[{self.label}] {self.done}/{self.total} {self.unit} | "
            f"{rate:.1f} {self.unit}/s | elapsed {elapsed:.1f}s | "
            f"ETA {eta:.0f}s",
            file=self._file, flush=True,
        )

    def close(self) -> dict:
        elapsed = time.perf_counter() - self._t0
        rate = self.done / elapsed if elapsed > 0 else 0.0
        if self.enabled and self.done:
            print(
                f"[{self.label}] done: {self.done} {self.unit} in "
                f"{elapsed:.1f}s ({rate:.1f} {self.unit}/s)",
                file=self._file, flush=True,
            )
        return {"elapsed_s": elapsed, "rate": rate, "n": self.done}


@contextlib.contextmanager
def device_trace(logdir: Optional[str] = None, device=None):
    """Trace a region with ``torch.profiler`` when a logdir is given; a
    no-op yielding ``None`` otherwise.

    Host activity is recorded on every thread (the tile loop packs on a
    prefetch thread and refits tails on a worker), the device's kernels and
    copies when ``device`` resolves to CUDA (``None`` means ``cuda``).
    Yields the profile, whose ``key_averages()`` the caller may read; on
    exit writes the Chrome trace to ``logdir/TRACE_FILE``.
    """
    if logdir is None:
        yield None
        return
    from torch.profiler import ProfilerActivity, _ExperimentalConfig, profile

    activities = [ProfilerActivity.CPU]
    if resolve_device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    config = _ExperimentalConfig(profile_all_threads=True)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities, experimental_config=config) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, TRACE_FILE))


__all__ = ["phase", "sync_pull", "timings", "reset_timings", "report",
           "ProgressReporter", "device_trace"]
