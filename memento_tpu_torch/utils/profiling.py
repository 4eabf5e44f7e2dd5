"""The program's span recorder, its counters, the device profiler and
progress reporting.

Counterpart of ``memento_tpu/utils/profiling.py``, whose registry readers
(``timings``, ``report``, ``steady_state``) this keeps.  A span is a named
stretch of work:

- ``phase(name, **attrs)`` times a stretch on the host clock;
- ``device_phase(name, device)`` times the device work launched inside it
  by two CUDA events on the current stream.  Nothing waits for them: the
  span is resolved when the host next waits anyway (``resolve()`` after a
  device read, or ``timings()``).  On the CPU it is a host span;
- ``wait()`` times a stretch in which the host blocks on the device; it is
  named after the span around it plus ``.wait``;
- ``request(name)`` (or the decorator ``traced``) opens a root span with a
  new request id, unique within the process.

Each span records its name, its start and end (``time.perf_counter_ns``),
its thread, its parent's id and its request id.  The parent is the span
open in the same ``contextvars`` context, so work handed to another thread
through ``submit(fn, ...)`` keeps the request and parent of the span that
handed it over.  No span synchronizes the device.

The registry keeps, per name, the count, total, largest and first duration
(what ``timings()`` reads); the span records go into a ring of the last
``RING_SIZE``; ``count(name, n)`` adds to a counter.  ``export_spans``
writes the ring as a Chrome trace on the clock of ``torch.profiler``'s
traces, and ``device_trace`` writes it beside its own trace, so the spans
line up with the device's kernels and idle gaps.  While the profiler runs,
each span is also a ``record_function`` range of the same name (a
``user_annotation`` of the trace).
"""

from __future__ import annotations

import collections
import contextlib
import contextvars
import functools
import itertools
import json
import operator
import os
import re
import sys
import threading
import time
from typing import Dict, Optional

import torch
from torch.autograd import profiler as _autograd_profiler

from ..device import resolve_device

TRACE_FILE = "trace.json"  # the Chrome trace ``device_trace`` writes
SPANS_FILE = "spans.json"  # the spans ``device_trace`` writes beside it
RING_SIZE = 200_000  # span records kept

_LOCK = threading.Lock()
_AGG: Dict[str, list] = {}  # name -> [count, total_s, max_s, first_s]
_COUNTERS: Dict[str, int] = {}
_RING = collections.deque(maxlen=RING_SIZE)
_PENDING = []  # device spans whose end event the device has not passed
_SPAN_IDS = itertools.count(1)
_REQUEST_IDS = itertools.count(1)
_CURRENT = contextvars.ContextVar("memento_tpu_torch_span", default=None)
_THREAD = threading.local()  # .id: the OS thread id, read once per thread


def _profiler_on() -> bool:
    # ``record_function`` costs ~10 µs even with no profiler running
    return getattr(_autograd_profiler, "_is_profiler_enabled", True)


# A span's profiler range opens and closes through the entry points under
# ``torch.profiler.record_function``, which keep the interpreter lock:
# ``record_function`` runs them as an operator that releases it, and a
# thread waiting for the lock then took it, often for its whole switch
# interval (5 ms), between the range's timestamp and the span's.
_range_enter = torch._C._autograd._record_function_with_args_enter
_range_exit = torch._C._autograd._record_function_with_args_exit


def _thread_id() -> int:
    # ``threading.get_native_id`` took 11 µs a call on the card's host
    try:
        return _THREAD.id
    except AttributeError:
        _THREAD.id = threading.get_native_id()
        return _THREAD.id


def _add_locked(name: str, seconds: float) -> None:
    agg = _AGG.get(name)
    if agg is None:
        _AGG[name] = [1, seconds, seconds, seconds]
    else:
        agg[0] += 1
        agg[1] += seconds
        if seconds > agg[2]:
            agg[2] = seconds


def add_time(name: str, seconds: float) -> None:
    """Add a duration measured elsewhere to ``name``'s totals (no span
    record)."""
    with _LOCK:
        _add_locked(name, float(seconds))


class Span:
    """One span; a context manager.  ``s`` is the duration counted in the
    registry (``None`` while a device span is unresolved)."""

    __slots__ = ("name", "id", "parent", "request", "thread", "t0", "t1",
                 "s", "attrs", "_token", "_rf")

    def __init__(self, name: str, attrs: Optional[dict] = None,
                 request: int = 0):
        self.name = name
        self.attrs = attrs or None
        self.request = request
        self.s = None
        self._rf = None

    def __enter__(self):
        parent = _CURRENT.get()
        self.id = next(_SPAN_IDS)
        if parent is None:
            self.parent = 0
        else:
            self.parent = parent.id
            self.request = self.request or parent.request
        self.thread = _thread_id()
        self._token = _CURRENT.set(self)
        if _profiler_on():
            # the span's timestamp, then the range's (taken early in the
            # entry), with no bytecode in between at which another thread
            # could take the lock
            self.t0, self._rf = map(operator.call, (
                time.perf_counter_ns, functools.partial(
                    _range_enter, self.name, f"request={self.request}")))
        else:
            self.t0 = time.perf_counter_ns()
        return self

    def _close(self):
        self.t1 = time.perf_counter_ns()
        if self._rf is not None:
            _range_exit(self._rf)
            self._rf = None
        _CURRENT.reset(self._token)
        self._token = None

    def __exit__(self, *exc):
        self._close()
        self.s = (self.t1 - self.t0) / 1e9
        with _LOCK:
            _add_locked(self.name, self.s)
        _RING.append(self)
        return False


class _DeviceSpan(Span):
    """A span timed by two CUDA events on the device's current stream."""

    __slots__ = ("device", "events")

    def __init__(self, name: str, device: torch.device):
        super().__init__(name)
        self.device = device
        self.events = None

    def __enter__(self):
        super().__enter__()
        start = torch.cuda.Event(enable_timing=True)
        start.record(torch.cuda.current_stream(self.device))
        self.events = (start, None)
        return self

    def __exit__(self, *exc):
        end = torch.cuda.Event(enable_timing=True)
        end.record(torch.cuda.current_stream(self.device))
        self.events = (self.events[0], end)
        self._close()
        with _LOCK:
            _PENDING.append(self)
        _RING.append(self)
        resolve()
        return False


def _resolve(block: bool) -> None:
    with _LOCK:
        done = []
        for span in _PENDING:
            start, end = span.events
            if block:
                end.synchronize()
            elif not end.query():
                continue
            span.s = start.elapsed_time(end) / 1e3
            span.events = None
            _add_locked(span.name, span.s)
            done.append(span)
        if done:
            _PENDING[:] = [sp for sp in _PENDING if sp.s is None]


def resolve() -> None:
    """Count the device spans whose work the device has finished; waits
    for nothing.  Call it after a read that waited for the device."""
    if _PENDING:
        _resolve(block=False)


def phase(name: str, **attrs) -> Span:
    """A span on the host clock; ``attrs`` go into its record."""
    return Span(name, attrs)


def device_phase(name: str, device=None) -> Span:
    """A span whose duration is the device's time between its two ends (on
    the current stream of ``device``); a host span when the device is not
    CUDA."""
    dev = resolve_device(device)
    return _DeviceSpan(name, dev) if dev.type == "cuda" else Span(name)


def wait(name: Optional[str] = None):
    """A span in which the host waits for the device (or for another
    thread): ``name``, or the open span's name plus ``.wait``.  Outside
    any span, or inside a wait, it records nothing."""
    if name is None:
        parent = _CURRENT.get()
        if parent is None or parent.name.endswith(".wait"):
            return contextlib.nullcontext()
        name = parent.name + ".wait"
    return Span(name)


def request(name: str) -> Span:
    """A root span with a new request id; inside an open span, a child
    span of the same request."""
    if _CURRENT.get() is None:
        return Span(name, request=next(_REQUEST_IDS))
    return Span(name)


def traced(fn):
    """Decorator: run ``fn`` inside ``request(fn.__name__)``."""
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with request(fn.__name__):
            return fn(*args, **kwargs)

    return wrapper


def submit(pool, fn, *args):
    """``pool.submit(fn, *args)`` in a copy of the caller's context, so the
    spans ``fn`` opens keep the caller's request and parent."""
    return pool.submit(contextvars.copy_context().run, fn, *args)


def tally(key: str, n: int) -> None:
    """Add ``n`` to attribute ``key`` of the open span (nothing outside
    one)."""
    span = _CURRENT.get()
    if span is not None:
        if span.attrs is None:
            span.attrs = {}
        span.attrs[key] = span.attrs.get(key, 0) + int(n)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name``."""
    with _LOCK:
        _COUNTERS[name] = _COUNTERS.get(name, 0) + int(n)


def counters() -> Dict[str, int]:
    """The counters since the last ``reset_timings()``."""
    with _LOCK:
        return dict(_COUNTERS)


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
    """Summary of all recorded phases (waits for unresolved device
    spans)."""
    if _PENDING:
        _resolve(block=True)
    with _LOCK:
        items = [(name, list(agg)) for name, agg in _AGG.items()]
    return {
        name: {
            "count": n,
            "total_s": total,
            "mean_s": total / n,
            "max_s": largest,
            "first_s": first,
        }
        for name, (n, total, largest, first) in items
    }


def reset_timings() -> None:
    """Clear the registry, the counters and the span records."""
    with _LOCK:
        _AGG.clear()
        _COUNTERS.clear()
        _RING.clear()
        _PENDING.clear()


def spans() -> list:
    """The span records in the ring, oldest closed first, as dicts."""
    return [{"name": sp.name, "id": sp.id, "parent": sp.parent,
             "request": sp.request, "thread": sp.thread,
             "start_ns": sp.t0, "end_ns": sp.t1, "s": sp.s,
             "device": isinstance(sp, _DeviceSpan),
             "attrs": dict(sp.attrs or {})}
            for sp in list(_RING)]


def wall_offset_ns(reads: int = 8) -> int:
    """``time_ns() - perf_counter_ns()``: what turns a span's clock into the
    wall clock, the clock of a ``torch.profiler`` trace (``ts`` µs plus
    ``baseTimeNanoseconds``).  Of ``reads`` wall-clock reads, each between
    two ``perf_counter_ns`` reads, the one with the shortest pair wins, so
    that a read the scheduler pulled apart does not skew it."""
    best = None
    for _ in range(reads):
        before = time.perf_counter_ns()
        wall = time.time_ns()
        after = time.perf_counter_ns()
        if best is None or after - before < best[0]:
            best = (after - before, wall - (before + after) // 2)
    return best[1]


def export_spans(path: str, base_ns: int = 0, since_ns: int = 0,
                 offset_ns: Optional[int] = None) -> int:
    """Write the ring as a Chrome trace of ``X`` events: ``ts`` in µs
    after ``base_ns`` on the wall clock (a ``torch.profiler`` trace's
    ``baseTimeNanoseconds``), ids, parents, request ids and attributes in
    ``args``, a device span's device seconds as ``device_s``.  Only spans
    that end after ``since_ns`` (``perf_counter_ns``) go in.  ``offset_ns``
    maps the spans to the wall clock (default: ``wall_offset_ns()`` now).
    Returns the number of events."""
    if offset_ns is None:
        offset_ns = wall_offset_ns()
    pid = os.getpid()
    events = []
    for sp in spans():
        if sp["end_ns"] <= since_ns:
            continue
        args = {"id": sp["id"], "parent": sp["parent"],
                "request": sp["request"], **sp["attrs"]}
        if sp["device"]:
            args["device_s"] = sp["s"]
        events.append({
            "ph": "X", "cat": "span", "name": sp["name"], "pid": pid,
            "tid": sp["thread"],
            "ts": (sp["start_ns"] + offset_ns - base_ns) / 1e3,
            "dur": (sp["end_ns"] - sp["start_ns"]) / 1e3,
            "args": args})
    with open(path, "w") as f:
        json.dump({"traceEvents": events, "displayTimeUnit": "ms",
                   "baseTimeNanoseconds": base_ns}, f)
    return len(events)


def steady_state(total_s: float, prefix: str, n_items: int) -> Dict[str, float]:
    """Throughput of a tiled test run without its one-off costs.

    The one-off is what only the first tile pays: the first pack or the
    warm-up that runs beside it, whichever is longer (the port's
    ``{prefix}.warm``; the JAX package's first AOT warm join), the first
    ``{prefix}.gev.refine.import`` (the ``scipy.stats`` import, which the
    first refit waits for, so added), the first dispatch and the largest
    harvest.  It comes off the wall time, and one tile's items come off the
    numerator.  A single-tile run reports its plain throughput.

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
                  get(prefix + ".warm", "first_s"),
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


def _trace_base_ns(path: str) -> int:
    """The ``baseTimeNanoseconds`` of a ``torch.profiler`` trace (written
    at its head), 0 if absent."""
    with open(path, "rb") as f:
        found = re.search(rb'"baseTimeNanoseconds"\s*:\s*(\d+)',
                          f.read(1 << 16))
    return int(found.group(1)) if found else 0


@contextlib.contextmanager
def device_trace(logdir: Optional[str] = None, device=None):
    """Trace a region with ``torch.profiler`` when a logdir is given; a
    no-op yielding ``None`` otherwise.

    Host activity is recorded on every thread (the tile loop packs on a
    prefetch thread and refits tails on a worker), the device's kernels and
    copies when ``device`` resolves to CUDA (``None`` means ``cuda``).
    Yields the profile, whose ``key_averages()`` the caller may read; on
    exit writes the Chrome trace to ``logdir/TRACE_FILE`` and the spans
    that ended inside the region to ``logdir/SPANS_FILE``, on the trace's
    clock (the offset between the two clocks taken as the profiler starts,
    as the profiler takes its own).
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
    since = time.perf_counter_ns()
    offset = wall_offset_ns()
    with profile(activities=activities, experimental_config=config) as prof:
        yield prof
    trace = os.path.join(logdir, TRACE_FILE)
    prof.export_chrome_trace(trace)
    if _PENDING:
        _resolve(block=True)
    export_spans(os.path.join(logdir, SPANS_FILE), _trace_base_ns(trace),
                 since, offset)


__all__ = ["phase", "device_phase", "wait", "request", "traced", "submit",
           "tally", "count", "counters", "resolve", "add_time", "spans",
           "export_spans", "wall_offset_ns", "sync_pull", "timings",
           "reset_timings", "steady_state", "report", "ProgressReporter", "device_trace",
           "TRACE_FILE", "SPANS_FILE", "RING_SIZE"]
