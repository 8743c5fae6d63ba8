"""Whole runs on the CPU at a tiny size: the command's refusals, the result
line, and faults planted under the timed path turning ``correct`` false."""
import json
import shutil
import subprocess
import sys
import textwrap

import pytest
import torch

import conftest  # noqa: F401  (the repository on the path)
from sizes import tiny_manifest

from benchmark import harness

ROOT = harness.ROOT


def test_the_command_refuses_without_a_card():
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "gan-f32-sample-b2048",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert "{" not in out.stdout
    assert "CUDA" in out.stderr


def test_the_command_refuses_where_the_program_is_missing(tmp_path):
    """A directory with only BENCHMARK.json and the benchmark: even where a
    card is claimed, the run stops before any result."""
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    script = textwrap.dedent("""
        import runpy, sys, torch
        torch.cuda.is_available = lambda: True
        torch.cuda.device_count = lambda: 1
        sys.argv = ["benchmark/run.py", "--workload", "gan-f32-sample-b2048", "--seed", "1",
                    "--seconds", "1", "--trace", "0"]
        runpy.run_path("benchmark/run.py", run_name="__main__")
    """)
    out = subprocess.run([sys.executable, "-c", script], cwd=tmp_path, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    assert "{" not in out.stdout
    assert "missing" in out.stderr


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """The manifest of a copy of the benchmark cut to tiny sizes."""
    return tiny_manifest(tmp_path_factory.mktemp("tiny"))


def _run(workload: str, traced: bool, manifest, seed: int = 2**31 + 11) -> dict:
    import time

    return harness.run(workload, seed, 0.3, traced, "cpu", time.perf_counter(), manifest_path=manifest)


@pytest.mark.parametrize("workload", [w["name"] for w in harness.load_manifest()["workloads"]])
@pytest.mark.parametrize("traced", [False, True])
def test_a_tiny_run_ends_in_one_well_formed_line(workload, traced, tiny, capsys):
    result = _run(workload, traced, tiny)
    harness.emit(result)
    out, err = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    assert list(line)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(line)
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] > 0
    assert line["device"]["platform"] == "cpu" and line["device"]["count"] == 1
    manifest = harness.load_manifest()
    e2e, _ = harness.cell_metrics(manifest, workload)
    if traced:
        assert set(line["device"]) >= {"busy_s", "window_s"}
        assert line["metrics"] == {}  # a CPU run writes no device metric
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert set(line["metrics"]) == {m["name"] for m in e2e}
        for m in e2e:
            assert line["metrics"][m["name"]]["unit"] == m["unit"]
    tail = err.strip().splitlines()[-len(line["checks"]):]
    assert [t.split()[1] for t in tail] == list(line["checks"])


def _alter_an_answer(monkeypatch):
    from melogan_torch.sampling import Sampler

    real = Sampler.sample_notes

    def altered(self, emotions, seed=0):
        notes = real(self, emotions, seed)
        notes[len(notes) // 2] += 0.25
        return notes

    monkeypatch.setattr(Sampler, "sample_notes", altered)


def _keep_the_state(monkeypatch):
    monkeypatch.setattr(torch.optim.Adam, "step", lambda self, closure=None: None)


def _halve_the_batch(monkeypatch):
    from melogan_torch.train import gan_step

    real = gan_step.make_train_steps

    def halved(cfg, *args, **kwargs):
        steps = real(cfg, *args, **kwargs)

        def group(state, batches, draws):
            h = batches[0].shape[1] // 2
            d = gan_step.GroupDraws(
                critic=[gan_step.CriticDraws(c.noise[:h], c.alpha[:h], [m[:h] for m in c.fe_masks])
                        for c in draws.critic],
                gen=gan_step.GenDraws(draws.gen.noise[:h], [m[:h] for m in draws.gen.fe_masks]))
            return steps.group(state, tuple(f[:, :h] for f in batches), d)

        return gan_step.TrainStepFns(group=group, tail=steps.tail)

    monkeypatch.setattr(gan_step, "make_train_steps", halved)


@pytest.mark.parametrize("workload,fault", [
    ("gan-f32-sample-b2048", None), ("gan-f32-sample-b2048", "altered answer"),
    ("gan-bf16-sample-b2048", None), ("gan-bf16-sample-b2048", "altered answer"),
    ("gan-f32-train-b256", None), ("gan-f32-train-b256", "state unchanged"),
    ("gan-f32-train-b256", "half the batch")])
def test_a_fault_under_the_timed_path_makes_the_run_incorrect(workload, fault, tiny, monkeypatch):
    """The faults a cell can have: a sample cell an answer altered where it is
    produced; a train cell a step that leaves its state unchanged, and half of
    the batch left out with the means over the rest. One chip: no exchange
    between chips to leave out. Without a fault the same run is correct."""
    plant = {None: None, "altered answer": _alter_an_answer, "state unchanged": _keep_the_state,
             "half the batch": _halve_the_batch}[fault]
    if plant is not None:
        plant(monkeypatch)
    result = _run(workload, False, tiny)
    assert result["correct"] is (fault is None), result["checks"]
