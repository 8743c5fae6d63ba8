"""Each cell run briefly on the card, plain and traced. Needs an NVIDIA card:
``python -m pytest benchmark/tests/test_benchmark_cuda.py`` on a machine that
has one; it skips elsewhere."""
import json
import subprocess
import sys

import pytest

import conftest  # noqa: F401  (the repository on the path)

from benchmark import harness

pytestmark = pytest.mark.cuda

WORKLOADS = [w["name"] for w in harness.load_manifest()["workloads"]]


@pytest.fixture(scope="module")
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the benchmark refuses to run without one)")


@pytest.mark.parametrize("traced", [0, 1])
@pytest.mark.parametrize("workload", WORKLOADS)
def test_a_short_run_on_the_card_is_correct(card, workload, traced):
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", workload, "--seed", str(2**31 + 5),
                          "--seconds", "2", "--trace", str(traced)],
                         cwd=harness.ROOT, capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True, line["checks"]
    assert line["device"]["platform"] == "gpu" and line["device"]["memory_peak_bytes"] > 0
    e2e, layer = harness.cell_metrics(harness.load_manifest(), workload)
    want = {m["name"] for m in (layer if traced else e2e)}
    assert set(line["metrics"]) == want
    if traced:
        assert 0 < line["device"]["busy_s"] <= line["device"]["window_s"]
        for name, m in line["metrics"].items():
            if name.endswith("_roofline") or "mfu" in name:
                assert 0 < m["value"] <= 100, name
