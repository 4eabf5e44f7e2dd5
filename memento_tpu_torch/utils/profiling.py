"""Named phase timers and progress reporting.

Counterpart of ``memento_tpu/utils/profiling.py``.  CUDA work is
asynchronous: a phase given a CUDA ``device`` calls
``torch.cuda.synchronize`` before it reads the clock at both ends, so its
time covers the device work launched inside it.
"""

from __future__ import annotations

import contextlib
import sys
import time
from collections import defaultdict
from typing import Dict

import torch

_TIMINGS: Dict[str, list] = defaultdict(list)


def _sync(device) -> None:
    if device is not None and torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def phase(name: str, device=None):
    """Time a named phase into the process-global registry."""
    _sync(device)
    t0 = time.perf_counter()
    try:
        yield
    finally:
        _sync(device)
        _TIMINGS[name].append(time.perf_counter() - t0)


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


__all__ = ["phase", "timings", "reset_timings", "ProgressReporter"]
