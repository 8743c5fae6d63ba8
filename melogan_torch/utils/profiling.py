"""Tracing and step timing: the port's ``melogan_tpu/utils/profiling.py``.

``device_trace`` records a ``torch.profiler`` trace (CPU activity, and CUDA
kernels when a card is present) and writes it as a Chrome trace into
``log_dir`` (viewable in Perfetto or ``chrome://tracing``), with the
program's spans beside it; ``StepTimer`` aggregates host-side step
latencies into percentile summaries.

``span(name)`` marks one piece of the program's work. While no torch
profiler records, it is one flag check and a shared no-op context. While
one records, it opens ``record_function(name)``, so the span lands in the
profiler's trace beside the kernels it launched, and keeps a record in
memory: name, native thread id, start and end in ``time.time_ns()`` (the
trace's own clock: an exported event's ``ts`` plus the trace's
``baseTimeNanoseconds`` / 1000 is Unix time in µs), the index of the span
open around it on the same thread, and the index of the outermost one, so
the spans of one call or step share a root. The flag is torch's global
one, so spans on every thread record (the sample pool's refill thread,
autograd's device thread running a backward); a span on a thread the
profiler does not follow has a record but no trace event. A span entered
on autograd's device thread is a root there. ``span_table()`` sums the
records by name, ``reset()`` clears them; records past ``MAX_RECORDS``
are dropped and counted.
"""
from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from typing import Dict, List, Optional

from torch.autograd import profiler as _profiler

TRACE_FILE = "trace.json"
SPANS_FILE = "spans.json"
MAX_RECORDS = 100_000

_OFF = contextlib.nullcontext()
_LOCK = threading.Lock()
_LOCAL = threading.local()
# each record: [name, thread, start_ns, end_ns (None while open), parent, root, its index]
_records: List[list] = []
_dropped = 0


class _Span:
    __slots__ = ("name", "rf", "rec")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.rf = _profiler.record_function(self.name)
        self.rf.__enter__()
        start = time.time_ns()
        try:
            stack, thread = _LOCAL.stack, _LOCAL.thread
        except AttributeError:  # once a thread: get_native_id is a system call (9–11 µs on an H100 host)
            stack, thread = _LOCAL.stack, _LOCAL.thread = [], threading.get_native_id()
        self.rec = _store(self.name, thread, start, stack[-1] if stack else None)
        stack.append(self.rec)
        return self

    def __exit__(self, *exc):
        self.rec[3] = time.time_ns()
        _LOCAL.stack.pop()
        return self.rf.__exit__(*exc)


def _store(name: str, thread: int, start: int, parent: Optional[list]) -> list:
    """A new open record, stored unless ``MAX_RECORDS`` are (its index then
    -1). Its parent is ``parent``'s index where that record is stored since
    the last ``reset``; else it is a root."""
    global _dropped
    with _LOCK:
        index = len(_records)
        if index >= MAX_RECORDS:
            _dropped += 1
            return [name, thread, start, None, None, None, -1]
        linked = parent is not None and 0 <= parent[6] < index and _records[parent[6]] is parent
        rec = [name, thread, start, None, parent[6] if linked else None, parent[5] if linked else index, index]
        _records.append(rec)
        return rec


def span(name: str):
    """Context manager: a span of the program's work named ``name`` (see
    the module docstring); the shared no-op while no profiler records."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _Span(name)


def reset() -> None:
    """Forget every record and the count of dropped ones."""
    global _records, _dropped
    with _LOCK:
        _records = []
        _dropped = 0


def span_records() -> List[dict]:
    """The closed spans recorded since the last ``reset``, in the order they
    were entered; ``parent`` and ``root`` are indices into this list's
    numbering of all spans entered (open ones included)."""
    with _LOCK:
        recs = list(_records)
    return [{"index": r[6], "name": r[0], "thread": r[1], "start_ns": r[2], "end_ns": r[3],
             "parent": r[4], "root": r[5]} for r in recs if r[3] is not None]


def dropped() -> int:
    """Spans not recorded since the last ``reset``: past ``MAX_RECORDS``."""
    return _dropped


def span_table() -> Dict[str, Dict[str, float]]:
    """Per span name: ``count``, ``host_s`` (the summed durations) and
    ``self_s`` (each duration less what its children on the same thread
    cover), over the closed spans recorded since the last ``reset``."""
    with _LOCK:
        recs = list(_records)
    child_ns: Dict[int, int] = {}
    for r in recs:
        if r[3] is not None and r[4] is not None:
            child_ns[r[4]] = child_ns.get(r[4], 0) + r[3] - r[2]
    table: Dict[str, Dict[str, float]] = {}
    for r in recs:
        if r[3] is None:
            continue
        row = table.setdefault(r[0], {"count": 0, "host_s": 0.0, "self_s": 0.0})
        ns = r[3] - r[2]
        row["count"] += 1
        row["host_s"] += ns * 1e-9
        row["self_s"] += (ns - child_ns.get(r[6], 0)) * 1e-9
    return table


@contextlib.contextmanager
def device_trace(log_dir: Optional[str]):
    """torch.profiler trace context writing ``<log_dir>/trace.json`` and the
    program's spans recorded inside it, ``<log_dir>/spans.json``
    (``span_table()``, the records and the count dropped); no-op when
    log_dir is None."""
    if not log_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    reset()
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))
    with open(os.path.join(log_dir, SPANS_FILE), "w") as f:
        json.dump({"table": span_table(), "records": span_records(), "dropped": dropped()}, f)


class StepTimer:
    """Collects per-step wall times; summarizes p50/p90/p99 and steps/sec."""

    def __init__(self):
        self.times: List[float] = []
        self._t0: Optional[float] = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.times.append(time.perf_counter() - self._t0)

    def summary(self) -> Dict[str, float]:
        if not self.times:
            return {}
        s = sorted(self.times)
        n = len(s)
        return {
            "steps": n,
            "mean_ms": sum(s) / n * 1e3,
            "p50_ms": s[n // 2] * 1e3,
            "p90_ms": s[min(n - 1, int(n * 0.9))] * 1e3,
            "p99_ms": s[min(n - 1, int(n * 0.99))] * 1e3,
            "steps_per_sec": n / sum(s),
        }
