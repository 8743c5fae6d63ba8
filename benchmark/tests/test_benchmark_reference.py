"""The plain references: their layout against the program's, their rounding,
what they import, and the controls (the reference one precision below the
configuration's, in the program's place) failing the limits at a test size."""
import ast
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import conftest  # noqa: F401  (the repository on the path)
from sizes import TINY, TINY_TRAFFIC

from benchmark import control, harness, traffic
from benchmark.kinds.train import readings
from benchmark.reference import model
from benchmark.reference import sampling as ref_sampling

BENCH = Path(harness.BENCH)


def _config(name: str) -> dict:
    entry = {c["name"]: c for c in harness.load_manifest()["configs"]}[name]
    return harness.load_config(entry)


def test_the_reference_layout_is_the_programs_state_dicts():
    from melogan_torch.config import EDConfig, GANConfig
    from melogan_torch.train import gan_step

    cfg = _config("melogan-gan")
    models = gan_step.build_models(GANConfig(**{k.lower(): v for k, v in cfg["gan"].items()}),
                                   EDConfig(**cfg["ed"]))
    shapes = model.param_shapes(cfg["gan"], cfg["ed"])
    for key, module in (("gen", models.generator), ("fe", models.feature_encoder),
                        ("critic", models.critic), ("ed", models.ed)):
        sd = module.state_dict()
        assert {n: tuple(t.shape) for n, t in sd.items()} == {n: s[0] for n, s in shapes[key].items()}, key


def test_the_reference_emotion_features_are_the_upstream_ones():
    from melogan_torch import EMOTIONS
    from melogan_torch.sampling import EMOTION_FEATURES, FEATURE_JITTER_STD

    assert model.EMOTIONS == tuple(EMOTIONS)
    assert model.EMOTION_FEATURES == tuple(tuple(EMOTION_FEATURES[e]) for e in EMOTIONS)
    assert model.FEATURE_JITTER_STD == FEATURE_JITTER_STD


def test_rounding_modes():
    x = torch.randn(4096, dtype=torch.float64) * 3
    tf = model.round_to(x, "tf32")
    m, _ = np.frexp(tf.numpy())
    assert np.all(np.abs(m * 2 ** 11 - np.round(m * 2 ** 11)) == 0)  # 11 significant bits
    assert torch.all((tf - x).abs() <= x.abs() * 2.0 ** -11)
    bf = model.round_to(x, "bf16")
    assert torch.equal(bf, x.float().bfloat16().double())
    f8 = model.round_to(x, "fp8")
    assert torch.all((f8 - x).abs() <= x.abs().max() * 2.0 ** -4)
    assert torch.equal(model.round_to(x, "none"), x)


@pytest.mark.parametrize("name", ["melogan-gan", "melogan-gan-bf16"])
def test_the_reference_samples_what_the_program_samples_at_a_tiny_size(name):
    from melogan_torch.config import GANConfig
    from melogan_torch.sampling import Sampler
    from benchmark import weights

    cfg = _config(name)
    cfg["gan"].update(TINY["gan"])
    w = weights.make(cfg["gan"], cfg["ed"], 11, "cpu", {"gen": "served", "fe": "served"})
    sampler = Sampler(GANConfig(**{k.lower(): v for k, v in cfg["gan"].items()}), gen_variables=w["gen"],
                      fe_variables=w["fe"], fast_math=cfg["precision"] == "bf16", device="cpu")
    idx = torch.tensor([0, 1, 2, 3, 3, 2, 1, 0])
    got = sampler.sample_notes([model.EMOTIONS[i] for i in idx], seed=99)
    p64 = {m: {k: v.double() if v.is_floating_point() else v for k, v in w[m].items()} for m in ("gen", "fe")}
    ref = ref_sampling.sample_notes(p64, cfg["gan"], idx, 99, cfg["reference_rounding"]).numpy()
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_nothing_the_benchmark_runs_imports_jax_or_the_jax_package():
    files = [p for p in BENCH.rglob("*.py") if "tests" not in p.parts]
    assert files
    for path in files:
        for name in _imports(path):
            assert name.split(".")[0] not in harness.FORBIDDEN, (path, name)


def test_the_reference_imports_nothing_of_the_program():
    for path in (BENCH / "reference").glob("*.py"):
        for name in _imports(path):
            top = name.split(".")[0]
            assert top in ("__future__", "math", "typing", "torch", "benchmark"), (path, name)
            if top == "benchmark":
                assert name.startswith("benchmark.reference"), (path, name)


def test_the_forbidden_check_compares_whole_top_level_names(monkeypatch):
    import sys
    import types

    monkeypatch.setitem(sys.modules, "jaxtools_like", types.ModuleType("jaxtools_like"))
    monkeypatch.setitem(sys.modules, "melogan_tpu_extra.x", types.ModuleType("melogan_tpu_extra.x"))
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "flax.linen", types.ModuleType("flax.linen"))
    assert harness.forbidden_modules() == ["flax"]


def _tiny_cell(config_name: str, traffic_name: str, seed: int):
    """A configuration under a traffic mix, set up at a tiny size on the CPU
    (the pair need not be a cell of the manifest)."""
    config = _config(config_name)
    config["gan"].update(TINY["gan"])
    config["ed"].update(TINY["ed"])
    t = traffic.load(traffic_name)
    t.update(TINY_TRAFFIC[t["kind"]])
    cell = harness.load_kind(t["kind"]).Cell(config, t, seed, "cpu")
    cell.setup()
    return cell, config, t


@pytest.mark.parametrize("config_name", ["melogan-gan", "melogan-gan-bf16"])
def test_the_sampling_control_fails_the_limit(config_name):
    cell, config, _ = _tiny_cell(config_name, "sample-pool-b2048", 5)
    cell.run_window(0.05)
    assert cell.check()["notes_err"] <= config["limits"]["sample"]["notes_err"]
    assert control.sample_control(cell, config["control_rounding"]) > config["limits"]["sample"]["notes_err"]


@pytest.mark.parametrize("config_name", ["melogan-gan-b256"])
def test_the_training_control_fails_a_limit(config_name):
    cell, config, _ = _tiny_cell(config_name, "train-groups", 5)
    numbers, _ = readings(config, cell.weights, cell.reference_inputs(),
                          control.train_side(cell, config["control_rounding"]))
    limits = config["limits"]["train"]
    assert any(numbers[k] > limits[k] for k in limits), json.dumps(numbers)
