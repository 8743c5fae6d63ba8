"""Trace arithmetic, the end-to-end statistics and the per-layer readers on
synthetic inputs."""
import pytest

import conftest  # noqa: F401  (the repository on the path)

from benchmark import harness, trace
from benchmark.kinds.sample import p95


def test_busy_is_the_union_of_intervals_not_their_sum():
    iv = [(0.0, 10.0), (5.0, 15.0), (20.0, 30.0), (25.0, 26.0)]
    assert trace.busy_seconds(iv, 0.0, 40.0) == pytest.approx(25e-6)
    assert trace.busy_seconds(iv, 8.0, 22.0) == pytest.approx(9e-6)  # clipped to the window
    assert trace.idle_gaps(iv, 0.0, 40.0) == [(15.0, 20.0), (30.0, 40.0)]
    assert trace.idle_gaps(iv, -5.0, 40.0)[0] == (-5.0, 0.0)


def test_p95_is_the_nearest_rank_over_all_calls():
    assert p95(list(range(1, 101))) == 95
    assert p95(list(range(1, 21))) == 19
    assert p95([3.0]) == 3.0
    lat = [0.01] * 950 + [0.05] * 50
    assert p95(lat) == 0.01
    assert p95(lat + [0.05]) == 0.05


def test_the_rate_counts_every_completed_row_over_the_window(monkeypatch):
    from benchmark.kinds import sample

    clock = [5.0]
    monkeypatch.setattr(sample.time, "perf_counter", lambda: clock[0])

    class Cell(sample.Cell):
        def __init__(self):
            self.calls = type("Calls", (), {"rows": 4096})()
            self.n = 0

        def _call(self):
            self.n += 1
            dt = 0.030 if self.n % 20 == 0 else 0.010  # calls 20 and 40 are slow
            clock[0] += dt
            return dt, clock[0], self.n != 30  # call 30 fails

    out = Cell().run_window(0.505)
    # 47 calls end the window at 0.47 + 2 * 0.02 = 0.51 s; 46 of them delivered
    assert out["samples_per_s"][0] == pytest.approx(46 * 4096 / 0.51)
    # the 95th percentile of 47 latencies by nearest rank is the 45th: 10 ms
    assert out["sample_p95_ms"][0] == pytest.approx(10.0)


def _event(name, cat, ts, dur, pid=1, tid=1, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "pid": pid, "tid": tid, "args": args}


def synthetic_trace():
    ev = [
        _event(trace.WINDOW, "user_annotation", 100, 1000),
        _event("decoder", "user_annotation", 110, 300),
        _event("decoder_tail", "user_annotation", 200, 200),
        _event("cudaLaunchKernel", "cuda_runtime", 150, 5, correlation=1),
        _event("cudaLaunchKernel", "cuda_runtime", 250, 5, correlation=2),
        _event("cudaMemcpyAsync", "cuda_runtime", 500, 5, correlation=3),
        _event("cudaHostAlloc", "cuda_runtime", 700, 200),
        _event("gemm_kernel", "kernel", 160, 100, pid=0, tid=7, correlation=1),
        _event("igemm_tf32x3_conv", "kernel", 260, 140, pid=0, tid=7, correlation=2),
        _event("Memcpy DtoH (Device -> Pinned)", "gpu_memcpy", 510, 90, pid=0, tid=7, correlation=3),
        _event("late_kernel", "kernel", 2000, 10, pid=0, tid=7),  # outside the window
    ]
    return {"traceEvents": ev}


def test_parse_gives_spans_busy_time_and_the_breakdown():
    events, window_s, busy_s, breakdown = trace.parse(synthetic_trace())
    assert window_s == pytest.approx(1000e-6)
    assert busy_s == pytest.approx(330e-6)
    by_name = {e.name: e for e in events}
    assert by_name["gemm_kernel"].spans == {"decoder"}
    assert by_name["igemm_tf32x3_conv"].spans == {"decoder", "decoder_tail"}
    assert by_name["Memcpy DtoH (Device -> Pinned)"].spans == frozenset()
    assert "late_kernel" not in by_name
    assert breakdown["device_ops"][0] == ["igemm_tf32x3_conv", pytest.approx(140e-6)]
    gaps = dict(breakdown["idle_gaps"])
    # each gap goes by the innermost host event at its middle
    assert gaps == pytest.approx({"cudaHostAlloc": 500e-6, "host (no traced op)": 110e-6, "decoder": 60e-6})
    assert sum(gaps.values()) == pytest.approx(window_s - busy_s)


@pytest.fixture(scope="module")
def view():
    from benchmark import yardstick

    manifest = harness.load_manifest()
    entry = {c["name"]: c for c in manifest["configs"]}["melogan-gan"]
    events, window_s, busy_s, breakdown = trace.parse(synthetic_trace())
    return trace.TraceView(events, window_s, busy_s, units=2, rows=8192, config=harness.load_config(entry),
                           traffic={"rows_per_call": 4096}, peaks=yardstick.device_peaks("H100 HBM3"),
                           breakdown=breakdown)


def test_readers_on_a_synthetic_view(view):
    read = harness.load_reader
    assert read("sample.idle_pct")(view) == pytest.approx(67.0)
    assert read("sample.d2h_ms")(view) == pytest.approx(0.090 / 2)
    assert read("sample.prenet_ms")(view) == pytest.approx(0.100 / 2)
    f, b = __import__("benchmark.yardstick", fromlist=["x"]).decoder_tail_work(view.gan, 4096)
    assert read("sample.decoder_roofline")(view) == pytest.approx(100 * 2 * (f / 495e12) / 140e-6)
    assert read("sample_mfu_pct")(view) == pytest.approx(100 * 49_384_448 * 8192 / 1000e-6 / 495e12)
    assert read("train.kernels_per_group")(view) == 1.0  # 2 kernels over 2 units


def test_readers_find_nothing_to_read_without_device_events(view):
    empty = trace.TraceView([], 1.0, 0.0, 0, 0, view.config, view.traffic, None)
    for m in harness.load_manifest()["per_layer"]:
        assert harness.load_reader(m["name"])(empty) is None, m["name"]
