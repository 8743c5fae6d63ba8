"""Where one WGAN-GP group step spends its time on the GPU.

    python -m melogan_torch.profile_train [--batch 32] [--repeats 10] [--bf16]

Builds the shipped ``GANConfig()``/``EDConfig()`` training state on the card
with seeded random weights and a seeded batch of random notes (``--bf16``:
the steps run at ``precision="bf16"``, as ``train(precision="bf16")`` runs
them), warms it up, then

1. wall-clocks group steps (host clock around steps that end in a
   synchronize) and, with CUDA events, the critic-only part (the same
   batches through the tail step: ``critic_iters`` critic updates) and the
   whole group step; the generator update is their difference;
2. traces ``--trace-steps`` group steps with ``torch.profiler`` and lists
   device time by kernel name, the number of kernels, the device's busy
   share of the traced wall time, and host time by op and runtime call.

Prints one JSON object per part; needs CUDA.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np
import torch

from melogan_torch.config import EDConfig, GANConfig
from melogan_torch.train import gan_step
from melogan_torch.train.gan_loop import precision_steps
from melogan_torch.utils.flops import PEAK_F32_FLOPS, group_step_flops


def _batches(cfg: GANConfig, dev, seed: int = 0):
    rng = np.random.default_rng(seed)
    k, b = cfg.critic_iters, cfg.batch_size
    arrays = (rng.uniform(-1, 1, (k, b, cfg.max_notes, cfg.note_dim)).astype(np.float32),
              rng.integers(0, 4, (k, b)).astype(np.int64),
              np.zeros((k, b, cfg.latent_dim), np.float32),
              rng.normal(size=(k, b, cfg.numeric_input_dim)).astype(np.float32))
    return tuple(torch.as_tensor(a, device=dev) for a in arrays)


def _event_ms(fn, repeats: int) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(repeats):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / repeats


def kernel_table(fn, steps: int, top: int = 15) -> dict:
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    rows, host, busy_ms, kernels = [], [], 0.0, 0
    for ev in prof.key_averages():
        if not str(ev.device_type).endswith("CUDA"):
            # host side: ops and runtime calls by their own (self) CPU time,
            # which the tracer itself inflates; read the shares, not the sums
            if ev.self_cpu_time_total > 0:
                host.append({"name": ev.key[:90], "calls": ev.count,
                             "self_host_ms": ev.self_cpu_time_total / 1e3 / steps})
            continue
        if getattr(ev, "is_user_annotation", False) or "#" in ev.key:
            continue  # annotated ranges (Optimizer.step#..., spans): their kernels are listed themselves
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:  # older torch
            dev_us = getattr(ev, "self_cuda_time_total", 0.0)
        if dev_us > 0:
            rows.append({"name": ev.key[:90], "calls": ev.count, "device_ms": dev_us / 1e3 / steps})
            busy_ms += dev_us / 1e3
            kernels += ev.count
    rows.sort(key=lambda r: -r["device_ms"])
    host.sort(key=lambda r: -r["self_host_ms"])
    return {"steps": steps, "wall_ms_per_step": wall_ms / steps,
            "device_ms_per_step": busy_ms / steps, "kernels_per_step": kernels / steps,
            "device_busy_share": busy_ms / wall_ms, "top": rows[:top],
            "host_self_ms_per_step": sum(r["self_host_ms"] for r in host),
            "host_top": host[:top]}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--repeats", type=int, default=10)
    ap.add_argument("--trace-steps", type=int, default=3)
    ap.add_argument("--bf16", action="store_true",
                    help="run the steps with the one-pass bf16 products (precision='bf16')")
    args = ap.parse_args(argv)
    precision = "bf16" if args.bf16 else None
    cfg = gan_step.precision_tuned_cfg(dataclasses.replace(GANConfig(), batch_size=args.batch), precision)
    ed_cfg = EDConfig()
    state = gan_step.init_state(cfg, gan_step.build_models(cfg, ed_cfg), seed=0, device="cuda")
    steps = precision_steps(gan_step.make_train_steps(cfg), precision)
    batches = _batches(cfg, state.device)
    for _ in range(3):  # build the kernels, warm up cuBLAS/cuDNN
        steps.group(state, batches)
    torch.cuda.synchronize()
    info = {"device": torch.cuda.get_device_name(state.device), "batch": args.batch,
            "precision": precision or "f32"}
    walls = []
    for _ in range(args.repeats):
        t0 = time.perf_counter()
        steps.group(state, batches)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    flops = group_step_flops(cfg, ed_cfg)
    print(json.dumps({**info, "group_step_wall_ms": walls, "median_ms": float(np.median(walls)),
                      "flops": flops, "bound_ms_f32": flops / PEAK_F32_FLOPS * 1e3}))
    group_ms = _event_ms(lambda: steps.group(state, batches), args.repeats)
    critic_ms = _event_ms(lambda: steps.tail(state, batches), args.repeats)
    print(json.dumps({**info, "events_ms": {
        "group_step": group_ms, "critic_updates": critic_ms,
        "generator_update": group_ms - critic_ms}}))
    print(json.dumps({**info, "profile": kernel_table(lambda: steps.group(state, batches),
                                                       args.trace_steps)}))


if __name__ == "__main__":
    main()
