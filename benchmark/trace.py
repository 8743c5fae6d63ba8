"""Trace arithmetic: a ``torch.profiler`` trace of a run's traced window
read into device intervals, the spans each kernel was launched in, the
device's busy and idle time, and the breakdown the result line carries.

The traced window is the ``bench.window`` annotation around a fixed number
of calls or group steps, ended by a synchronize. A device event (kernel,
copy or memset) belongs to the window when it starts inside it; busy time is
the union of the device intervals clipped to the window, not their sum. A
kernel's spans are the benchmark's ``record_function`` annotations open on
the launching thread when its launch call ran (matched by correlation id).
An idle gap is named by the innermost host event running at its midpoint on
the thread that opened the window.
"""
from __future__ import annotations

import bisect
import json
from dataclasses import dataclass
from typing import Dict, FrozenSet, Iterable, List, Optional, Sequence, Tuple

WINDOW = "bench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
CUDA_API = "cuda_"  # the categories of CUDA runtime and driver API calls
HOST_CATS = ("cpu_op", "user_annotation")
TOP = 10


@dataclass(frozen=True)
class DeviceEvent:
    name: str
    cat: str  # kernel, gpu_memcpy or gpu_memset
    start_us: float
    dur_us: float
    spans: FrozenSet[str]


class TraceView:
    """What a per-layer metric's reader reads: the traced window's device
    events, its length and busy time, how many units (calls or group steps)
    and rows it ran, the configuration, the traffic and the card's peaks."""

    def __init__(self, events: List[DeviceEvent], window_s: float, busy_s: float, units: int,
                 rows: int, config: dict, traffic: dict, peaks: Optional[dict],
                 breakdown: Optional[dict] = None):
        self.events, self.window_s, self.busy_s = events, window_s, busy_s
        self.units, self.rows = units, rows
        self.config, self.traffic, self.peaks = config, traffic, peaks
        self.breakdown = breakdown

    @property
    def gan(self) -> dict:
        return self.config["gan"]

    @property
    def ed(self) -> dict:
        return self.config["ed"]

    @property
    def precision(self) -> str:
        return self.config["precision"]

    def select(self, cats: Sequence[str] = ("kernel",), in_spans: Iterable[str] = (),
               not_in_spans: Iterable[str] = (), name_has: Iterable[str] = ()) -> List[DeviceEvent]:
        """Device events of ``cats`` launched inside any of ``in_spans`` (any
        span when empty), inside none of ``not_in_spans``, whose name holds
        any of ``name_has`` (any name when empty)."""
        ins, outs, words = set(in_spans), set(not_in_spans), tuple(name_has)
        return [e for e in self.events
                if e.cat in cats and (not ins or e.spans & ins) and not (e.spans & outs)
                and (not words or any(w in e.name for w in words))]

    @staticmethod
    def seconds(events: Iterable[DeviceEvent]) -> float:
        return sum(e.dur_us for e in events) * 1e-6


def _merge(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def busy_seconds(intervals: List[Tuple[float, float]], lo: float, hi: float) -> float:
    """Length of the union of ``intervals`` (µs) clipped to [lo, hi], in s."""
    clipped = [(max(s, lo), min(e, hi)) for s, e in intervals if e > lo and s < hi]
    return sum(e - s for s, e in _merge(clipped)) * 1e-6


def idle_gaps(intervals: List[Tuple[float, float]], lo: float, hi: float) -> List[Tuple[float, float]]:
    """The stretches of [lo, hi] (µs) that no interval covers."""
    gaps, at = [], lo
    for s, e in _merge([(max(s, lo), min(e, hi)) for s, e in intervals if e > lo and s < hi]):
        if s > at:
            gaps.append((at, s))
        at = max(at, e)
    if hi > at:
        gaps.append((at, hi))
    return gaps


def read_chrome_trace(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def parse(trace: dict) -> Tuple[List[DeviceEvent], float, float, dict]:
    """(device events in the window, window s, busy s, breakdown) of a
    chrome trace that holds one ``bench.window`` annotation."""
    xs = [e for e in trace.get("traceEvents", []) if e.get("ph") == "X"]
    windows = [e for e in xs if e.get("cat") == "user_annotation" and e.get("name") == WINDOW]
    if len(windows) != 1:
        raise ValueError(f"expected one {WINDOW!r} annotation in the trace, found {len(windows)}")
    win = windows[0]
    lo, hi = float(win["ts"]), float(win["ts"]) + float(win["dur"])
    spans_by_thread: Dict[tuple, List[Tuple[float, float, str]]] = {}
    host_by_thread: Dict[tuple, List[Tuple[float, float, str]]] = {}
    launches: Dict[int, Tuple[tuple, float]] = {}
    for e in xs:
        cat = e.get("cat")
        key = (e.get("pid"), e.get("tid"))
        if cat in HOST_CATS or cat.startswith(CUDA_API):
            host_by_thread.setdefault(key, []).append((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)), e["name"]))
        if cat == "user_annotation" and e["name"] != WINDOW:
            spans_by_thread.setdefault(key, []).append((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)), e["name"]))
        if cat.startswith(CUDA_API) and "correlation" in e.get("args", {}):
            launches[e["args"]["correlation"]] = (key, float(e["ts"]))
    events = []
    for e in xs:
        if e.get("cat") not in DEVICE_CATS:
            continue
        start = float(e["ts"])
        if not lo <= start < hi:
            continue
        spans: FrozenSet[str] = frozenset()
        launch = launches.get(e.get("args", {}).get("correlation"))
        if launch is not None:
            key, t = launch
            spans = frozenset(n for s, f, n in spans_by_thread.get(key, ()) if s <= t <= f)
        events.append(DeviceEvent(e["name"], e["cat"], start, float(e.get("dur", 0)), spans))
    intervals = [(e.start_us, e.start_us + e.dur_us) for e in events]
    busy = busy_seconds(intervals, lo, hi)
    host = host_by_thread.get((win.get("pid"), win.get("tid")), [])
    return events, (hi - lo) * 1e-6, busy, _breakdown(events, idle_gaps(intervals, lo, hi), host)


def _innermost(host: List[Tuple[float, float, str]], starts: List[float], t: float) -> str:
    """The latest-starting host event on the thread that still runs at
    ``t``: on one thread events nest, so that is the innermost."""
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(-1, i - 5000), -1):
        s, e, n = host[j]
        if e >= t and n != WINDOW:
            return n
    return "host (no traced op)"


def _breakdown(events: List[DeviceEvent], gaps, host) -> dict:
    by_op: Dict[str, float] = {}
    for e in events:
        by_op[e.name] = by_op.get(e.name, 0.0) + e.dur_us * 1e-6
    by_host: Dict[str, float] = {}
    host = sorted(host)
    starts = [h[0] for h in host]
    for s, e in gaps:
        name = _innermost(host, starts, (s + e) / 2)
        by_host[name] = by_host.get(name, 0.0) + (e - s) * 1e-6
    top = lambda d: [[k[:160], v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]
    return {"device_ops": top(by_op), "idle_gaps": top(by_host)}
