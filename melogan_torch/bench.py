"""Benchmark of the port: one JSON line of end-to-end readings.

The port's counterpart of the root ``bench.py``, reading for reading:

- piano-roll sampling throughput (samples/s) through the feature encoder
  and the generator at batch 65536 and 8192, the notes left on the device
  (``Sampler._step``), each repeat ended by a synchronize;
- WGAN-GP training throughput in reference batch-steps/s at ``GANConfig()``
  (one group step = ``critic_iters`` batch-steps), the corpus on the device
  and every batch gathered there, as ``gan_loop`` gathers it;
- the p50 of one direct ``sample_notes`` call at batch 1 plus its MIDI
  bytes, and the p50/p90/p99 of the serving path (a ``SamplePool`` take
  plus its MIDI bytes);
- the fast-math sampling and bf16 training variants;
- on more than one card, sampling over a local mesh and training on one
  rank a card (``parallel.launch.spawn``);
- a CPU baseline in a child process (``--cpu-baseline``), the best of 3
  repeats with their spread, and the rates as TFLOP/s and percent of the
  card's dense bf16 peak (``utils/flops.py``).

It prints one JSON line with every key of the JAX benchmark's, plus
``power_limit`` (nvidia-smi's, as ``doctor`` reads it) and
``samples_per_sec_8k``. The ``xla_*`` and ``pallas_*`` pairs read null: the
port has one route through its kernels and no switch, so the batch-8192
reading, JAX's ``xla_samples_per_sec_8k``, has a key of its own. The dp
keys read null on one device. A reading that raises ends the run with its
traceback; nothing is skipped.

Run on the card with ``python -m melogan_torch bench`` (or ``python -m
melogan_torch.bench``); ``python -m melogan_torch --device cpu bench``
takes the same readings on the CPU.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU_BASELINE_TIMEOUT = 2100  # seconds


def _sync(devices) -> None:
    """Wait for the work queued on each CUDA device of ``devices``."""
    for dev in devices:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)


def _bench_sampling(sampler, batch: int, iters: int, warmup: int = 2, repeats: int = 1):
    """A list of ``repeats`` samples/s readings, each over ``iters`` calls of
    ``batch`` rows of ``happy``: the draws and the forward on the device,
    each call seeded alike with JAX's keys, no host copy."""
    idx = torch.zeros((batch,), dtype=torch.long, device=sampler.device)
    devices = [sampler.device] if sampler.mesh is None else list(sampler.mesh.devices)
    for i in range(warmup):
        sampler._step(idx, seed=i)
    _sync(devices)
    rates = []
    for r in range(repeats):
        t0 = time.perf_counter()
        for i in range(iters):
            sampler._step(idx, seed=100 + r * iters + i)
        _sync(devices)
        rates.append(batch * iters / (time.perf_counter() - t0))
    return rates


def _bench_train(iters: int = 20, warmup: int = 2, epochs_per_dispatch: int = 0, precision=None,
                 repeats: int = 1, groups: int = 5, mesh=None, cfg=None, device="cuda"):
    """A list of ``repeats`` batch-steps/s readings, and the analytic FLOPs
    of one batch-step (``utils.flops.train_flops_per_step``: its frozen ED
    counts 2× its forward where JAX's counts 3×).

    The JAX package dispatches one fused program per ``save_freq`` epochs;
    here a "dispatch" is the same work, ``e`` epochs of ``groups`` group
    steps in a loop (``e = epochs_per_dispatch`` or ``cfg.save_freq``), and
    a reading counts ``iters · e · groups · critic_iters`` batch-steps over
    the wall of ``iters`` dispatches ended by a synchronize. The corpus is
    ``groups · critic_iters · batch_size`` random rows put on the device
    once; each group step gathers its batches there by a permuted index
    already on the device. ``cfg``: ``GANConfig()`` unless given (the ED is
    ``EDConfig()``'s). ``precision="bf16"``: the steps run as
    ``train-gan --bf16`` runs them. ``mesh``: a data-parallel mesh of the
    ranks (``parallel.make_mesh`` in a process group), as ``train-gan --dp
    N``; the rank then runs on its own device. ``init_state`` turns TF32
    off on the card before the first step."""
    from melogan_torch.config import EDConfig, GANConfig
    from melogan_torch.train import gan_step
    from melogan_torch.train.gan_loop import device_gather, precision_steps
    from melogan_torch.train.harness import rank_device
    from melogan_torch.utils.flops import train_flops_per_step

    cfg = gan_step.precision_tuned_cfg(cfg or GANConfig(), precision)
    ed_cfg = EDConfig()
    dev = rank_device(device, mesh)
    models = gan_step.build_models(cfg, ed_cfg)
    state = gan_step.init_state(cfg, models, seed=0, device=dev)
    steps = precision_steps(gan_step.make_train_steps(cfg, mesh=mesh), precision)

    rng = np.random.default_rng(0)
    e = epochs_per_dispatch or cfg.save_freq
    g, k, b = groups, cfg.critic_iters, cfg.batch_size
    n = g * k * b
    gather = device_gather((
        rng.normal(size=(n, cfg.max_notes, cfg.note_dim)).astype(np.float32),
        rng.integers(0, 4, size=(n,)).astype(np.int64),
        rng.normal(size=(n, cfg.latent_dim)).astype(np.float32),
        rng.normal(size=(n, cfg.numeric_input_dim)).astype(np.float32),
    ), dev, mesh)
    idx = torch.as_tensor(np.stack([rng.permutation(n).reshape(g, k, b) for _ in range(e)]), device=dev)

    def dispatch(state):
        for ei in range(e):
            for gi in range(g):
                state, _ = steps.group(state, gather(idx[ei, gi]))
        return state

    for _ in range(warmup):
        state = dispatch(state)
    _sync([dev])
    rates = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        for _ in range(iters):
            state = dispatch(state)
        _sync([dev])
        rates.append(iters * e * g * k / (time.perf_counter() - t0))
    return rates, train_flops_per_step(cfg, ed_cfg)


def _dp_train_rank(mesh, kwargs: dict):
    """One rank of the dp training reading (``launch.spawn``): its rate of
    ``_bench_train(**kwargs)`` on the rank's device."""
    return _bench_train(mesh=mesh, device=mesh.device, **kwargs)[0][0]


def _bench_latency(sampler, n: int = 20) -> float:
    """The direct path, one device round trip a request (batch 1): the
    median seconds of ``sample_notes`` plus the MIDI bytes."""
    from melogan_torch.constants import EMOTION_BPM
    from melogan_torch.midi.codec import render_to_bytes
    from melogan_torch.sampling import emotion_scale

    lat = []
    for i in range(n):
        t0 = time.perf_counter()
        notes = sampler.sample_notes(["happy"], seed=i)[0]
        render_to_bytes(notes, bpm=EMOTION_BPM["happy"], scale=emotion_scale("happy"))
        lat.append(time.perf_counter() - t0)
    lat.sort()
    return lat[len(lat) // 2]


def _bench_latency_pooled(sampler, n: int = 100) -> dict:
    """The serving path: ``/generate`` pops a pre-generated sample from the
    batched prefetch pool, with no device call on the request path. p50,
    p90 and p99 seconds of a take plus its MIDI bytes; the pool is closed
    whatever happens."""
    from melogan_torch.constants import EMOTION_BPM
    from melogan_torch.midi.codec import render_to_bytes
    from melogan_torch.sampling import emotion_scale
    from melogan_torch.serving.pool import SamplePool

    emotions = ["happy", "sad", "angry", "calm"]
    pool = SamplePool(sampler, target=64, refill_batch=512)
    try:
        pool.prefill(timeout=300)
        lat = []
        for i in range(n):
            emotion = emotions[i % 4]
            t0 = time.perf_counter()
            notes = pool.take(emotion)
            render_to_bytes(notes, bpm=EMOTION_BPM[emotion], scale=emotion_scale(emotion))
            lat.append(time.perf_counter() - t0)
        lat.sort()
        return {
            "p50": lat[len(lat) // 2],
            "p90": lat[int(len(lat) * 0.9)],
            "p99": lat[min(len(lat) - 1, int(len(lat) * 0.99))],
        }
    finally:
        pool.close()


def power_limit(device: torch.device):
    """The power limit of card 0 as nvidia-smi prints it ("700.00 W"), or
    None on the CPU."""
    if device.type != "cuda":
        return None
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0].rsplit(",", 1)[1].strip()


def cpu_baseline() -> dict:
    """The baseline on the CPU: the best of 3 repeats of each reading with
    their spread (max − min over the max, percent). Sampling at batch 64, 50
    calls a repeat; training 1 dispatch of 1 epoch of 2 groups a repeat."""
    from melogan_torch.config import GANConfig
    from melogan_torch.sampling import Sampler

    def best(rates):
        rates = sorted(rates)
        return rates[-1], (rates[-1] - rates[0]) / rates[-1] * 100

    sampler = Sampler(GANConfig(), seed=0, device="cpu")
    s_best, s_spread = best(_bench_sampling(sampler, batch=64, iters=50, repeats=3))
    t_rates, _ = _bench_train(iters=1, warmup=1, epochs_per_dispatch=1, repeats=3, groups=2, device="cpu")
    t_best, t_spread = best(t_rates)
    return {"samples_per_sec": s_best, "samples_spread_pct": round(s_spread, 1),
            "train_steps_per_sec": t_best, "train_spread_pct": round(t_spread, 1)}


def _run_cpu_baseline() -> dict:
    """``cpu_baseline`` in a fresh child process (its own threads, no CUDA);
    a child that fails raises with its output."""
    proc = subprocess.run([sys.executable, "-m", "melogan_torch.bench", "--cpu-baseline"],
                          capture_output=True, text=True, timeout=CPU_BASELINE_TIMEOUT, cwd=REPO)
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("CPU_BASELINE ")]
    if proc.returncode != 0 or not lines:
        raise RuntimeError(f"the CPU baseline child exited {proc.returncode}:\n"
                           f"{proc.stdout[-4000:]}\n{proc.stderr[-4000:]}")
    return json.loads(lines[-1][len("CPU_BASELINE "):])


def result_line(r: dict) -> dict:
    """The printed line from the readings ``r``: ``samples``, ``samples_8k``,
    ``train``, ``train_flops_per_step``, ``p50_direct``, ``pool`` (p50, p90,
    p99 s), ``fast_samples``, ``bf16_train``, ``dp_samples``, ``dp_train``
    (None on one device), ``cpu`` (``cpu_baseline``'s dict), ``chip``,
    ``n_devices``, ``power_limit``, ``flops_per_sample``. Every key of the
    JAX benchmark's line, ``power_limit`` and ``samples_per_sec_8k``."""
    from melogan_torch.utils.flops import chip_peak_bf16_tflops

    cpu, fps, tfs = r["cpu"], r["flops_per_sample"], r["train_flops_per_step"]
    peak = chip_peak_bf16_tflops(r["chip"])

    def tflops(rate, per_unit):
        return rate * per_unit / 1e12 if (rate and per_unit) else None

    def pct_peak(tf):
        return round(tf / peak * 100, 2) if (tf and peak) else None

    def rounded(x, n):
        return round(x, n) if x else None

    sampling_tf, bf16_sampling_tf = tflops(r["samples"], fps), tflops(r["fast_samples"], fps)
    train_tf, bf16_train_tf = tflops(r["train"], tfs), tflops(r["bf16_train"], tfs)
    return {
        "metric": "piano_roll_samples_per_sec_per_chip",
        "value": round(r["samples"], 2),
        "unit": "samples/s",
        "vs_baseline": rounded(r["samples"] / cpu["samples_per_sec"], 2),
        "vs_baseline_spread_pct": cpu["samples_spread_pct"],
        "train_steps_per_sec": round(r["train"], 3),
        "train_steps_vs_cpu": rounded(r["train"] / cpu["train_steps_per_sec"], 2),
        "train_steps_vs_cpu_spread_pct": cpu["train_spread_pct"],
        "p50_midi_gen_latency_ms": round(r["pool"]["p50"] * 1000, 2),
        "p90_midi_gen_latency_ms": round(r["pool"]["p90"] * 1000, 2),
        "p99_midi_gen_latency_ms": round(r["pool"]["p99"] * 1000, 2),
        "p50_direct_dispatch_ms": round(r["p50_direct"] * 1000, 2),
        # one route through the port's kernels, no XLA/Pallas switch
        "xla_samples_per_sec": None,
        "xla_samples_per_sec_8k": None,
        "pallas_samples_per_sec_8k": None,
        "xla_train_steps_per_sec": None,
        "pallas_train_steps_per_sec_1ep": None,
        "samples_per_sec_8k": round(r["samples_8k"], 2),
        "bf16_samples_per_sec": rounded(r["fast_samples"], 2),
        "bf16_train_steps_per_sec": rounded(r["bf16_train"], 3),
        "cpu_samples_per_sec": rounded(cpu["samples_per_sec"], 2),
        "cpu_samples_spread_pct": cpu["samples_spread_pct"],
        "cpu_train_spread_pct": cpu["train_spread_pct"],
        "n_devices": r["n_devices"],
        "dp_samples_per_sec": rounded(r["dp_samples"], 2),
        "dp_train_steps_per_sec": rounded(r["dp_train"], 3),
        "dp_sampling_scaling": round(r["dp_samples"] / r["samples"], 2) if r["dp_samples"] else None,
        "chip": r["chip"],
        "power_limit": r["power_limit"],
        "chip_peak_bf16_tflops": peak,
        "flops_per_sample": fps,
        "train_flops_per_step": round(tfs),
        "sampling_tflops": rounded(sampling_tf, 2),
        "sampling_pct_bf16_peak": pct_peak(sampling_tf),
        "bf16_sampling_tflops": rounded(bf16_sampling_tf, 2),
        "bf16_sampling_pct_bf16_peak": pct_peak(bf16_sampling_tf),
        "train_tflops": rounded(train_tf, 2),
        "train_pct_bf16_peak": pct_peak(train_tf),
        "bf16_train_tflops": rounded(bf16_train_tf, 2),
        "bf16_train_pct_bf16_peak": pct_peak(bf16_train_tf),
    }


def run(device="cuda") -> dict:
    """Take every reading on ``device``, run the CPU baseline child, print
    the line and return it."""
    from melogan_torch.config import GANConfig
    from melogan_torch.device import device_info, resolve_device
    from melogan_torch.parallel import launch
    from melogan_torch.parallel.mesh import make_mesh
    from melogan_torch.sampling import Sampler
    from melogan_torch.utils.flops import sampling_flops_per_sample

    dev = resolve_device(device)
    info = device_info(dev)
    sampler = Sampler(GANConfig(), seed=0, device=dev)
    r = {"chip": info["kind"], "n_devices": info["count"], "power_limit": power_limit(dev),
         "flops_per_sample": sampling_flops_per_sample(GANConfig())}
    # batch 65536, where the JAX package found the rate flat with batch
    r["samples"] = _bench_sampling(sampler, batch=65536, iters=5)[0]
    train, r["train_flops_per_step"] = _bench_train(iters=15, device=dev)
    r["train"] = train[0]
    r["p50_direct"] = _bench_latency(sampler)
    r["pool"] = _bench_latency_pooled(sampler)
    r["samples_8k"] = _bench_sampling(sampler, batch=8192, iters=5)[0]
    fast_sampler = Sampler(GANConfig(), seed=0, fast_math=True, device=dev)
    r["fast_samples"] = _bench_sampling(fast_sampler, batch=65536, iters=5)[0]
    r["bf16_train"] = _bench_train(iters=15, precision="bf16", device=dev)[0][0]
    r["dp_samples"] = r["dp_train"] = None
    if r["n_devices"] > 1:
        dp_sampler = Sampler(GANConfig(), seed=0, mesh=make_mesh(device=dev.type), device=dev)
        r["dp_samples"] = _bench_sampling(dp_sampler, batch=65536, iters=5)[0]
        r["dp_train"] = launch.spawn(_dp_train_rank, r["n_devices"], args=({"iters": 15},),
                                    device=dev.type)[0]
    r["cpu"] = _run_cpu_baseline()
    line = result_line(r)
    print(json.dumps(line), flush=True)
    return line


def main(argv=None, device="cuda") -> dict:
    """``--cpu-baseline``: print ``CPU_BASELINE {...}`` (the child's job);
    otherwise ``run(device)``."""
    p = argparse.ArgumentParser(prog="python -m melogan_torch.bench", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--cpu-baseline", action="store_true", dest="cpu_baseline",
                   help="only the CPU baseline, printed as CPU_BASELINE {...}")
    args = p.parse_args(sys.argv[1:] if argv is None else argv)
    if args.cpu_baseline:
        result = cpu_baseline()
        print("CPU_BASELINE " + json.dumps(result), flush=True)
        return result
    return run(device)


if __name__ == "__main__":
    main()
