"""The harness: finds a cell's configuration, traffic, kind and metrics by
the names in ``BENCHMARK.json``, runs set-up, the measured or traced window
and the check, and makes the result line.

Everything that belongs to one configuration, traffic mix or per-layer
metric is a file of its own: ``configs/<config>.json`` (named by the
manifest's ``file``), ``traffic/<traffic>.json`` (its ``kind`` names the
module ``kinds/<kind>.py``) and ``metrics/<metric>.py`` (a ``read(view)``
that returns a number, or None when it finds nothing to read). Adding a
cell, a configuration, a traffic mix or a metric adds files and entries and
edits none.
"""
from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Callable, Dict, Optional, Tuple

ROOT = Path(__file__).resolve().parent.parent
BENCH = Path(__file__).resolve().parent
MANIFEST = ROOT / "BENCHMARK.json"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "melogan_tpu")


def load_manifest(path: Path = MANIFEST) -> dict:
    return json.loads(path.read_text())


def find_cell(manifest: dict, workload: str) -> Tuple[dict, dict]:
    cells = {c["name"]: c for c in manifest["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json; there are {sorted(cells)}")
    cell = cells[workload]
    configs = {c["name"]: c for c in manifest["configs"]}
    return cell, configs[cell["config"]]


def load_config(entry: dict, root: Path = ROOT) -> dict:
    return json.loads((root / entry["file"]).read_text())


def load_kind(kind: str):
    return importlib.import_module(f"benchmark.kinds.{kind}")


def load_reader(name: str, directory: Path = BENCH / "metrics") -> Callable:
    path = directory / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no reader for metric {name!r}: {path} is missing")
    spec = importlib.util.spec_from_file_location("benchmark_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cell_metrics(manifest: dict, workload: str) -> Tuple[list, list]:
    """(end-to-end metrics, per-layer metrics) that ``workload`` reports."""
    e2e = [m for m in manifest["end_to_end"] if workload in m.get("workloads", [workload])]
    layer = [m for m in manifest["per_layer"] if workload in m["workloads"]]
    return e2e, layer


def forbidden_modules() -> list:
    """Top-level names of loaded modules that the benchmark must not load."""
    return sorted({name.split(".", 1)[0] for name in sys.modules} & set(FORBIDDEN))


def _sync(device: str) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _power_limit() -> Optional[str]:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=20)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else None


def _traced_window(cell, device: str, config: dict, traffic: dict, peaks):
    """Run the cell's traced window under ``torch.profiler`` with the
    benchmark's spans; returns the ``TraceView`` of it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from benchmark import trace
    from benchmark.spans import Spans

    spans = Spans()
    cell.install_spans(spans)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.device(device).type == "cuda" else [])
    try:
        with profile(activities=acts) as prof:
            with torch.autograd.profiler.record_function(trace.WINDOW):
                units, rows = cell.run_traced()
                _sync(device)
    finally:
        spans.remove()
    fd, path = tempfile.mkstemp(suffix=".json", prefix="bench_trace_")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        events, window_s, busy_s, breakdown = trace.parse(trace.read_chrome_trace(path))
    finally:
        os.unlink(path)
    return trace.TraceView(events, window_s, busy_s, units, rows, config, traffic, peaks, breakdown)


def run(workload: str, seed: int, seconds: float, traced: bool, device: str,
        t_start: float, manifest_path: Path = MANIFEST) -> dict:
    """One run of a cell of the manifest at ``manifest_path``, whose
    configuration, traffic and metric files lie beside it; returns the
    result line as a dict."""
    import torch

    from benchmark import traffic as traffic_gen
    from benchmark import yardstick

    manifest = load_manifest(manifest_path)
    cell_entry, config_entry = find_cell(manifest, workload)
    root = manifest_path.parent
    config = load_config(config_entry, root)
    traffic = traffic_gen.load(cell_entry["traffic"], root / "benchmark" / "traffic")
    e2e, layer = cell_metrics(manifest, workload)
    kind = load_kind(traffic["kind"])
    cell = kind.Cell(config, traffic, seed, device)

    t_cuda = time.perf_counter()
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t_setup = time.perf_counter()
    cell.setup()
    _sync(device)
    setup_s = time.perf_counter() - t_start
    phases = [("start to harness", t_cuda - t_start), ("cuda init", t_setup - t_cuda), *cell.phases]
    print("setup phases: " + ", ".join(f"{n} {s:.3f}" for n, s in phases), file=sys.stderr)

    metrics: Dict[str, dict] = {}
    dev_info = {"platform": "gpu" if torch.device(device).type == "cuda" else "cpu",
                "kind": torch.cuda.get_device_name(0) if torch.device(device).type == "cuda" else "cpu",
                "count": 1}
    breakdown = None
    if traced:
        peaks = yardstick.device_peaks(dev_info["kind"])
        view = _traced_window(cell, device, config, traffic, peaks)
        for m in layer:
            value = load_reader(m["name"], root / "benchmark" / "metrics")(view)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        dev_info.update(busy_s=view.busy_s, window_s=view.window_s)
        breakdown = view.breakdown
    else:
        measured = cell.run_window(seconds)
        measured["setup_s"] = (setup_s, "s")
        for m in e2e:
            if m["name"] not in measured:
                raise KeyError(f"{workload}: kinds/{traffic['kind']}.py measures no {m['name']!r}")
            value, unit = measured[m["name"]]
            if unit != m["unit"]:
                raise ValueError(f"{m['name']}: measured in {unit}, the manifest says {m['unit']}")
            metrics[m["name"]] = {"value": value, "unit": unit}
    dev_info["memory_peak_bytes"] = (torch.cuda.max_memory_allocated() if dev_info["platform"] == "gpu" else 0)

    cell.free_program()
    gc.collect()
    if dev_info["platform"] == "gpu":
        torch.cuda.empty_cache()
        dev_info["power_limit"] = _power_limit()
    numbers = cell.check()
    if getattr(cell, "worst", None):
        print("check worst: " + ", ".join(f"{k} at {v}" for k, v in cell.worst.items()), file=sys.stderr)
    limits = config["limits"][traffic["kind"]]
    checks = {k: {"value": v, "limit": limits[k]} for k, v in numbers.items()}
    correct = (cell.failed == 0 and bool(checks)
               and all(math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values()))
    result = {"correct": correct, "attempted": cell.attempted, "failed": cell.failed,
              "metrics": metrics, "device": dev_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    return result


def emit(result: dict) -> None:
    """The compared numbers with their limits as the last lines of standard
    error, then the result as the last line of standard output."""
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
