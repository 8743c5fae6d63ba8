"""Dependency-free serving metrics: Prometheus text exposition.

The port's copy of ``melogan_tpu/serving/metrics.py`` (stdlib only).

The reference app has no observability surface at all (app.py serves five
routes and prints nothing); a production serving tier needs one. This module
is a minimal, allocation-light metrics registry — counters and fixed-bucket
histograms behind one lock — rendered in the Prometheus text exposition
format (version 0.0.4) at ``GET /metrics`` so any standard scraper can
consume it. No client library exists in this image, and the hot-path cost
must stay trivial next to the ~0.3 ms /generate encode, so this is
hand-rolled: one lock acquire + two float adds per observation.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, List, Tuple

# Request-latency buckets (seconds). The serving profile spans ~0.3 ms pooled
# hits to ~1 s cold-miss refills (docs/performance.md), so the grid is
# log-spaced across exactly that range.
DEFAULT_BUCKETS = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
    0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)


def _fmt(v: float) -> str:
    """Prometheus float formatting: integers render bare, no exponent noise."""
    if v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


def _labels(labels: Tuple[Tuple[str, str], ...]) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{v}"' for k, v in labels)
    return "{" + inner + "}"


class Registry:
    """Counters + histograms keyed by (name, sorted label tuple)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[Tuple[str, Tuple[Tuple[str, str], ...]], float] = {}
        self._hists: Dict[Tuple[str, Tuple[Tuple[str, str], ...]], "_Hist"] = {}
        self._help: Dict[str, Tuple[str, str]] = {}  # name -> (type, help)
        self._gauges: Dict[str, Tuple[str, "callable", str]] = {}  # name -> (help, fn, type)
        self.started = time.time()

    # -- instruments ------------------------------------------------------

    def counter_inc(self, name: str, help: str = "", value: float = 1.0, **labels) -> None:
        key = (name, tuple(sorted(labels.items())))
        with self._lock:
            self._help.setdefault(name, ("counter", help))
            self._counters[key] = self._counters.get(key, 0.0) + value

    def observe(self, name: str, value: float, help: str = "",
                buckets: Tuple[float, ...] = DEFAULT_BUCKETS, **labels) -> None:
        key = (name, tuple(sorted(labels.items())))
        with self._lock:
            self._help.setdefault(name, ("histogram", help))
            hist = self._hists.get(key)
            if hist is None:
                hist = self._hists[key] = _Hist(buckets)
            hist.observe(value)

    def gauge_fn(self, name: str, fn, help: str = "", typ: str = "gauge") -> None:
        """Register a callable polled at render time (e.g. pool depth).
        The callable returns either a number or a {label_value: number} dict
        (rendered with a ``key`` label). ``typ`` is the exposition TYPE:
        monotonic callables (e.g. pool hit counts) should register as
        ``counter`` — the ``_total`` suffix is counter-reserved and
        OpenMetrics-strict scrapers reject gauge-typed ``*_total`` series."""
        with self._lock:
            self._gauges[name] = (help, fn, typ)

    # -- exposition ---------------------------------------------------------

    def render(self) -> str:
        """Prometheus text exposition format 0.0.4."""
        with self._lock:
            counters = dict(self._counters)
            hists = {k: v.snapshot() for k, v in self._hists.items()}
            helps = dict(self._help)
            gauges = dict(self._gauges)
        lines: List[str] = []
        seen_header = set()

        def header(name: str, typ: str, hlp: str):
            if name in seen_header:
                return
            seen_header.add(name)
            if hlp:
                lines.append(f"# HELP {name} {hlp}")
            lines.append(f"# TYPE {name} {typ}")

        for (name, labels), value in sorted(counters.items()):
            typ, hlp = helps.get(name, ("counter", ""))
            header(name, typ, hlp)
            lines.append(f"{name}{_labels(labels)} {_fmt(value)}")
        for (name, labels), (buckets, counts, total, count) in sorted(hists.items()):
            typ, hlp = helps.get(name, ("histogram", ""))
            header(name, typ, hlp)
            cum = 0
            for b, c in zip(buckets, counts):
                cum += c
                lab = labels + (("le", _fmt(b)),)
                lines.append(f"{name}_bucket{_labels(lab)} {cum}")
            lab = labels + (("le", "+Inf"),)
            lines.append(f"{name}_bucket{_labels(lab)} {count}")
            lines.append(f"{name}_sum{_labels(labels)} {repr(total)}")
            lines.append(f"{name}_count{_labels(labels)} {count}")
        for name, (hlp, fn, typ) in sorted(gauges.items()):
            # the WHOLE call-and-format is guarded: a gauge callback must not
            # 500 /metrics, and neither must its return value (nan/inf or a
            # non-numeric would raise in float()/_fmt — e.g. a ratio gauge
            # with a zero denominator). Samples are staged so a half-failed
            # dict gauge never emits a HELP/TYPE header with no sample.
            try:
                value = fn()
                if isinstance(value, dict):
                    samples = [f'{name}{{key="{k}"}} {_fmt(float(v))}'
                               for k, v in sorted(value.items())]
                else:
                    samples = [f"{name} {_fmt(float(value))}"]
            except Exception:  # noqa: BLE001
                continue
            header(name, typ, hlp)
            lines.extend(samples)
        header("process_uptime_seconds", "gauge", "Seconds since server start")
        lines.append(f"process_uptime_seconds {repr(time.time() - self.started)}")
        return "\n".join(lines) + "\n"


class _Hist:
    """Fixed-bucket histogram; lock is held by the owning Registry."""

    __slots__ = ("buckets", "counts", "total", "count")

    def __init__(self, buckets: Tuple[float, ...]):
        self.buckets = tuple(sorted(buckets))
        self.counts = [0] * len(self.buckets)
        self.total = 0.0
        self.count = 0

    def observe(self, value: float) -> None:
        self.total += value
        self.count += 1
        # linear scan beats bisect at 14 buckets for typical small latencies
        for i, b in enumerate(self.buckets):
            if value <= b:
                self.counts[i] += 1
                return

    def snapshot(self):
        return (self.buckets, list(self.counts), self.total, self.count)
