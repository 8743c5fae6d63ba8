"""BENCHMARK.json against the rules a manifest keeps, and the harness finding a
cell, a traffic mix and a metric by name with no edit."""
import json
import re
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from sizes import tiny_manifest

from benchmark.harness import ROOT

from benchmark import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


@pytest.fixture(scope="module")
def manifest():
    return harness.load_manifest()


def test_manifest_has_the_required_keys(manifest):
    assert set(manifest) == TOP_KEYS
    assert manifest["command"] == ["python3", "benchmark/run.py"]
    assert manifest["paths"] == ["benchmark"]
    assert 1 <= manifest["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    for c in manifest["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/") and (ROOT / c["file"]).is_file()
    for w in manifest["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1
    for m in manifest["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in manifest["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")


def test_names_units_and_texts_use_only_allowed_characters(manifest):
    names = [c["name"] for c in manifest["configs"]] + [w["name"] for w in manifest["workloads"]]
    names += [w["config"] for w in manifest["workloads"]] + [w["traffic"] for w in manifest["workloads"]]
    names += [m["name"] for m in manifest["end_to_end"] + manifest["per_layer"]]
    names += [k for c in manifest["configs"] for k in c["reduced"]]
    for n in names:
        assert NAME.match(n), n
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    texts = [w["why"] for w in manifest["workloads"]] + [c["why"] for c in manifest["configs"]]
    texts += [c["source"] for c in manifest["configs"]] + [m["layer"] for m in manifest["per_layer"]]
    texts += manifest["command"]
    for t in texts:
        assert 1 <= len(t) <= 200 and "\n" not in t and "\t" not in t, t


def test_names_are_unique_and_each_pair_once(manifest):
    for group in ("configs", "workloads"):
        names = [x["name"] for x in manifest[group]]
        assert len(names) == len(set(names))
    metrics = [m["name"] for m in manifest["end_to_end"] + manifest["per_layer"]]
    assert len(metrics) == len(set(metrics))
    pairs = [(w["config"], w["traffic"]) for w in manifest["workloads"]]
    assert len(pairs) == len(set(pairs))
    used = {w["config"] for w in manifest["workloads"]}
    assert used == {c["name"] for c in manifest["configs"]}


def test_every_moves_is_reported_by_each_of_its_cells(manifest):
    for m in manifest["per_layer"]:
        e2e = {x["name"]: x for x in manifest["end_to_end"]}
        assert m["moves"] in e2e, m["name"]
        for cell in m["workloads"]:
            reported, _ = harness.cell_metrics(manifest, cell)
            assert m["moves"] in {x["name"] for x in reported}, (m["name"], cell)


def test_every_cell_reports_setup_another_end_to_end_and_a_layer_metric(manifest):
    for w in manifest["workloads"]:
        e2e, layer = harness.cell_metrics(manifest, w["name"])
        names = {m["name"] for m in e2e}
        assert "setup_s" in names and len(names) >= 2
        assert layer


def test_every_name_finds_its_file(manifest):
    from benchmark import traffic

    for w in manifest["workloads"]:
        t = traffic.load(w["traffic"])
        assert (ROOT / "benchmark" / "kinds" / f"{t['kind']}.py").is_file()
    for m in manifest["per_layer"]:
        assert callable(harness.load_reader(m["name"]))
    configs = {c["name"]: c for c in manifest["configs"]}
    for w in manifest["workloads"]:
        kind = traffic.load(w["traffic"])["kind"]
        assert kind in harness.load_config(configs[w["config"]])["limits"], w["name"]


def test_an_added_cell_traffic_and_metric_are_found_with_no_edit(tmp_path):
    """A copy of the benchmark gains a traffic mix, a cell and a per-layer
    metric as new files and manifest entries only; a tiny CPU run of the new
    cell reports the new metric."""
    manifest_path = tiny_manifest(tmp_path)
    m = json.loads(manifest_path.read_text())
    m["workloads"].append({"name": "gan-f32-sample-b8", "config": "melogan-gan", "traffic": "sample-b8",
                           "chips": 1, "why": "an added cell"})
    m["end_to_end"][0]["workloads"].append("gan-f32-sample-b8")
    m["end_to_end"][1]["workloads"].append("gan-f32-sample-b8")
    m["per_layer"].append({"name": "sample.calls_traced", "unit": "calls", "better": "higher",
                           "source": "device_trace", "layer": "Sampler", "moves": "samples_per_s",
                           "workloads": ["gan-f32-sample-b8"]})
    manifest_path.write_text(json.dumps(m))
    t = json.loads((tmp_path / "benchmark" / "traffic" / "sample-pool-b2048.json").read_text())
    t.update(rows_per_call=8)
    (tmp_path / "benchmark" / "traffic" / "sample-b8.json").write_text(json.dumps(t))
    (tmp_path / "benchmark" / "metrics" / "sample.calls_traced.py").write_text(
        "def read(view):\n    return float(view.units)\n")
    script = textwrap.dedent(f"""
        import json, sys, time
        sys.path[:0] = [{str(tmp_path)!r}, {str(ROOT)!r}]
        from benchmark import harness
        r = harness.run("gan-f32-sample-b8", 7, 0.2, True, "cpu", time.perf_counter(),
                        manifest_path=harness.Path({str(manifest_path)!r}))
        print(harness.__file__)
        print(json.dumps(r))
    """)
    out = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True, timeout=300,
                         cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-3000:]
    where, line = out.stdout.strip().splitlines()[-2:]
    assert Path(where).resolve().is_relative_to(tmp_path.resolve())  # the copy, not this tree, ran
    assert json.loads(line)["metrics"]["sample.calls_traced"]["value"] == 3.0
