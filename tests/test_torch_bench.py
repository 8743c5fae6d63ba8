"""The port's benchmark (``melogan_torch/bench.py``) and its FLOP counts, on
the CPU, at small widths.

- ``_bench_sampling`` alone and over a two-shard local mesh, as JAX's
  ``test_bench_sampling_over_dp_mesh``; ``_bench_train`` calls the group
  step exactly ``iters · e · groups`` times between the warm-up's
  synchronize and the reading's; the pooled latency's order, its pool
  closed;
- ``sampling_flops_per_sample`` equals JAX's; ``chip_peak_bf16_tflops``;
- the printed line has every key of the JAX benchmark's ``out`` dict (read
  from the root ``bench.py`` with ``ast``, not imported), and
  ``power_limit``;
- ``bench`` on the command line runs on ``--device`` and never falls back
  from the card to the CPU.

``slow``: the CPU baseline child end to end, and ``_bench_train`` on two
gloo ranks. This file imports JAX only inside the tests that compare with
it, so the ``slow`` ones also run where there is no JAX (``--noconftest``).
"""
import ast
import math
import os
import threading

import pytest
import torch

from melogan_torch import bench
from melogan_torch.config import GANConfig
from melogan_torch.parallel.mesh import make_mesh
from melogan_torch.sampling import Sampler

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = GANConfig(noise_dim=16, latent_dim=8, gen_hidden=32)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Small CPU runs: more torch threads only contend with the other test
    workers' threads."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.mark.parametrize("shards", [0, 2])
def test_bench_sampling(shards):
    mesh = make_mesh(shards, device="cpu") if shards else None
    sampler = Sampler(SMALL, seed=0, mesh=mesh, device="cpu")
    rates = bench._bench_sampling(sampler, batch=16, iters=2, warmup=1)
    assert len(rates) == 1 and rates[0] > 0 and math.isfinite(rates[0])


def test_bench_train_times_exactly_its_group_steps(monkeypatch):
    from melogan_torch.train import gan_step

    calls, at_sync = [0], []
    make = gan_step.make_train_steps

    def counted(*a, **kw):
        steps = make(*a, **kw)

        def group(*ga, **gkw):
            calls[0] += 1
            return steps.group(*ga, **gkw)

        return steps._replace(group=group)

    sync = bench._sync
    monkeypatch.setattr(gan_step, "make_train_steps", counted)
    monkeypatch.setattr(bench, "_sync", lambda devices: (at_sync.append(calls[0]), sync(devices)))
    rates, flops = bench._bench_train(iters=1, warmup=1, epochs_per_dispatch=1, groups=1,
                                      cfg=SMALL, device="cpu")
    # the warm-up's synchronize, then the reading's: iters · e · g group steps between
    assert at_sync == [1, 2]
    assert len(rates) == 1 and rates[0] > 0 and math.isfinite(rates[0])
    assert flops > 0


def test_bench_latency_pooled_closes_its_pool():
    sampler = Sampler(GANConfig(max_notes=64, noise_dim=16, latent_dim=8, gen_hidden=32), seed=0, device="cpu")
    lat = bench._bench_latency_pooled(sampler, n=8)
    assert 0 < lat["p50"] <= lat["p90"] <= lat["p99"]
    assert not [t for t in threading.enumerate() if t.name == "sample-pool" and t.is_alive()]


@pytest.mark.parametrize("cfg", [GANConfig(), SMALL], ids=["default", "small"])
def test_sampling_flops_match_jax(cfg):
    from melogan_tpu.config import GANConfig as JGANConfig
    from melogan_tpu.utils import flops as jflops

    from melogan_torch.utils.flops import sampling_flops_per_sample

    jcfg = JGANConfig(noise_dim=cfg.noise_dim, latent_dim=cfg.latent_dim, gen_hidden=cfg.gen_hidden)
    assert sampling_flops_per_sample(cfg) == jflops.sampling_flops_per_sample(jcfg) > 0


def test_chip_peak_bf16_tflops():
    from melogan_torch.utils.flops import chip_peak_bf16_tflops

    assert chip_peak_bf16_tflops("NVIDIA H100 80GB HBM3") == 989.4
    assert chip_peak_bf16_tflops("NVIDIA H100 SXM5 80GB") == 989.4
    assert chip_peak_bf16_tflops("cpu") is None
    assert chip_peak_bf16_tflops("Some Other Card") is None


def _jax_out_keys():
    """The keys of the dict ``out`` that the root bench.py's ``run`` prints."""
    with open(os.path.join(REPO, "bench.py")) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and any(isinstance(t, ast.Name) and t.id == "out" for t in node.targets)):
            return {k.value for k in node.value.keys}
    raise AssertionError("no out dict in bench.py")


def test_line_has_every_jax_key():
    jax_keys = _jax_out_keys()
    assert {"value", "train_steps_per_sec", "p99_midi_gen_latency_ms", "chip"} <= jax_keys
    cpu = {"samples_per_sec": 1000.0, "samples_spread_pct": 3.0, "train_steps_per_sec": 2.0,
           "train_spread_pct": 4.0}
    readings = {"samples": 5e5, "samples_8k": 4e5, "train": 100.0, "train_flops_per_step": 2e10,
                "p50_direct": 0.002, "pool": {"p50": 1e-4, "p90": 2e-4, "p99": 3e-4},
                "fast_samples": 6e5, "bf16_train": 120.0, "dp_samples": None, "dp_train": None,
                "cpu": cpu, "chip": "NVIDIA H100 80GB HBM3", "n_devices": 1, "power_limit": "700.00 W",
                "flops_per_sample": 3e8}
    line = bench.result_line(readings)
    assert jax_keys | {"power_limit"} <= set(line)
    assert set(line) - jax_keys == {"power_limit", "samples_per_sec_8k"}
    assert line["vs_baseline"] == 500.0 and line["train_steps_vs_cpu"] == 50.0
    assert line["p50_midi_gen_latency_ms"] <= line["p90_midi_gen_latency_ms"] <= line["p99_midi_gen_latency_ms"]
    assert line["chip_peak_bf16_tflops"] == 989.4
    assert line["sampling_pct_bf16_peak"] == round(5e5 * 3e8 / 1e12 / 989.4 * 100, 2)
    for k in ("xla_samples_per_sec", "xla_samples_per_sec_8k", "pallas_samples_per_sec_8k",
              "xla_train_steps_per_sec", "pallas_train_steps_per_sec_1ep", "dp_samples_per_sec",
              "dp_train_steps_per_sec", "dp_sampling_scaling"):
        assert line[k] is None, k
    dp = bench.result_line(dict(readings, n_devices=2, dp_samples=9e5, dp_train=180.0))
    assert dp["dp_sampling_scaling"] == 1.8 and dp["dp_train_steps_per_sec"] == 180.0


def test_cli_bench_runs_on_its_device(monkeypatch):
    from melogan_torch import cli

    seen, run = [], bench.run
    monkeypatch.setattr(bench, "run", lambda device: seen.append(device))
    cli.main(["--device", "cpu", "bench"])
    assert seen == ["cpu"]
    if not torch.cuda.is_available():  # the card asked for and absent: no fallback
        with pytest.raises(SystemExit, match="--device cuda"):
            cli.main(["bench"])
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            run("cuda")
        assert seen == ["cpu"]


@pytest.mark.slow
def test_cpu_baseline_child():
    cpu = bench._run_cpu_baseline()
    assert cpu["samples_per_sec"] > 0 and cpu["train_steps_per_sec"] > 0
    assert 0 <= cpu["samples_spread_pct"] < 100 and 0 <= cpu["train_spread_pct"] < 100


@pytest.mark.slow
def test_bench_train_over_two_gloo_ranks():
    from melogan_torch.parallel import launch

    kw = {"iters": 1, "warmup": 1, "epochs_per_dispatch": 1, "groups": 1, "cfg": SMALL}
    rates = launch.spawn(bench._dp_train_rank, 2, args=(kw,), device="cpu", timeout=300)
    assert len(rates) == 2 and all(r > 0 and math.isfinite(r) for r in rates)
