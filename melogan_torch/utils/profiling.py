"""Tracing and step timing: the port's ``melogan_tpu/utils/profiling.py``.

``device_trace`` records a ``torch.profiler`` trace (CPU activity, and CUDA
kernels when a card is present) and writes it as a Chrome trace into
``log_dir`` (viewable in Perfetto or ``chrome://tracing``); ``StepTimer``
aggregates host-side step latencies into percentile summaries.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, List, Optional

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def device_trace(log_dir: Optional[str]):
    """torch.profiler trace context writing ``<log_dir>/trace.json``; no-op
    when log_dir is None."""
    if not log_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


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
