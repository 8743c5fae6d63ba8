"""Where one ``Sampler.sample_notes`` call spends its time on the GPU.

    python -m melogan_torch.profile_sample [--batch 4096] [--repeats 5] [--fast-math] [--max-notes 512]

Builds ``Sampler(GANConfig(max_notes=...), device="cuda")`` with seeded
random weights (``--fast-math``: ``Sampler(fast_math=True)``, the one-pass
bf16 products), warms it up, then

1. traces ``--repeats`` whole ``sample_notes`` calls under
   ``utils.profiling.device_trace`` and lists the program's spans in them
   (``span_table``): per span, its count, and host ms and self ms a call
   (the name check and index, the draws, the forward with the feature
   encoder, NoiseToLatent, the decoder pre-net and tail inside it, the copy
   to the host with its page-locked allocation);
2. wall-clocks whole ``sample_notes`` calls (host clock, ending in the copy);
3. traces one ``sample_notes`` call with ``torch.profiler`` and lists device
   time by kernel name;
4. (f32 only) times the decoder-tail stage with the folded BN stages from
   their cache (and, where the tree holds it there, their W') against
   folding them on every call, in turn over three rounds: CUDA-event ms and
   host-clock ms a call, and the device kernels of one call;
5. (f32 only) the decoder tail on the sampler's folded stages against its
   yardstick, three ``F.conv_transpose1d`` calls with the ReLUs (cuDNN, TF32
   off), each in CUDA-event ms and in device µs a call (``torch.profiler``).

Prints one JSON object per part; needs CUDA.
"""
from __future__ import annotations

import argparse
import json
import tempfile
import time

import torch

from melogan_torch import EMOTIONS
from melogan_torch.config import GANConfig
from melogan_torch.ops.decoder import fused_decoder_tail
from melogan_torch.sampling import Sampler
from melogan_torch.utils.profiling import device_trace, span_table


def _event_ms(fn, repeats: int) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(repeats):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / repeats


def span_times(sampler: Sampler, batch: int, repeats: int) -> dict:
    """The program's spans over ``repeats`` whole ``sample_notes`` calls
    under ``device_trace``: per span name, its count and host and self ms a
    call."""
    emotions = [EMOTIONS[i % len(EMOTIONS)] for i in range(batch)]
    with tempfile.TemporaryDirectory() as trace_dir:
        with device_trace(trace_dir):
            for seed in range(repeats):
                sampler.sample_notes(emotions, seed=seed)
    return {name: {"count": row["count"], "host_ms": row["host_s"] * 1e3 / repeats,
                   "self_ms": row["self_s"] * 1e3 / repeats}
            for name, row in span_table().items()}


def wall_times(sampler: Sampler, batch: int, repeats: int) -> list:
    emotions = [EMOTIONS[i % len(EMOTIONS)] for i in range(batch)]
    out = []
    for seed in range(repeats):
        t0 = time.perf_counter()
        sampler.sample_notes(emotions, seed=seed)
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def device_kernels_per_call(fn, name: str = "", calls: int = 2) -> float:
    """Device kernels whose name holds ``name`` (any, by default) that one
    ``fn()`` launches, read from a ``torch.profiler`` trace of ``calls``
    calls."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    n = sum(ev.count for ev in prof.key_averages()
            if str(ev.device_type).endswith("CUDA") and not getattr(ev, "is_user_annotation", False)
            and name in ev.key)
    return n / calls


def fold_cost(sampler: Sampler, batch: int, repeats: int, rounds: int = 3) -> dict:
    """The decoder-tail stage on a seeded (batch, M, 256) input, with the
    stages from ``folded_stages`` (cached) and from ``_fold`` (BN folded on
    every call), alternated."""
    dec = sampler.generator.decoder
    rng = torch.Generator(device=sampler.device).manual_seed(0)
    y = torch.randn((batch, dec.reduced_len, 256), generator=rng, device=sampler.device)
    variants = {"cached": dec.folded_stages, "fold_each_call": dec._fold}
    out = {k: {"event_ms": [], "host_ms": []} for k in variants}
    with torch.inference_mode():
        for _ in range(rounds):
            for k, stages in variants.items():
                def tail():
                    fused_decoder_tail(y, stages())

                out[k]["event_ms"].append(_event_ms(tail, repeats))
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(repeats):
                    tail()
                torch.cuda.synchronize()
                out[k]["host_ms"].append((time.perf_counter() - t0) * 1e3 / repeats)
        for k, stages in variants.items():
            out[k]["device_kernels_per_call"] = device_kernels_per_call(
                lambda: fused_decoder_tail(y, stages()))
    return out


def device_us_per_call(fn, calls: int = 5) -> float:
    """Device time (µs) of the kernels and copies one ``fn()`` launches, read
    from a ``torch.profiler`` trace of ``calls`` calls."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    total = 0.0
    for ev in prof.key_averages():
        if str(ev.device_type).endswith("CUDA") and not getattr(ev, "is_user_annotation", False):
            total += getattr(ev, "self_device_time_total", None) or getattr(ev, "self_cuda_time_total", 0.0)
    return total / calls


def tail_vs_library(sampler: Sampler, batch: int, repeats: int, rounds: int = 3) -> dict:
    """The fused tail on the sampler's folded stages (warm) against three
    cuDNN transposed convs with the ReLUs on the same stages, in turn."""
    import torch.nn.functional as F

    dec = sampler.generator.decoder
    rng = torch.Generator(device=sampler.device).manual_seed(0)
    y = torch.randn((batch, dec.reduced_len, 256), generator=rng, device=sampler.device)
    with torch.inference_mode():
        stages = dec.folded_stages()
        wt = [(w.permute(1, 2, 0).contiguous(), b) for w, b in stages]
        yn = y.transpose(1, 2).contiguous()

        def kernel():
            fused_decoder_tail(y, stages)

        def library():
            h = F.conv_transpose1d(yn, wt[0][0], wt[0][1], 2, 2, 1).relu_()
            h = F.conv_transpose1d(h, wt[1][0], wt[1][1], 2, 2, 1).relu_()
            F.conv_transpose1d(h, wt[2][0], wt[2][1], 2, 2, 1)

        kernel()
        library()
        out = {k: {"event_ms": [], "device_us": []} for k in ("kernel", "library")}
        for _ in range(rounds):
            for k, fn in (("kernel", kernel), ("library", library)):
                out[k]["event_ms"].append(_event_ms(fn, repeats))
                out[k]["device_us"].append(device_us_per_call(fn))
    return out


def kernel_table(sampler: Sampler, batch: int, top: int = 12) -> list:
    from torch.profiler import ProfilerActivity, profile

    emotions = [EMOTIONS[i % len(EMOTIONS)] for i in range(batch)]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        sampler.sample_notes(emotions, seed=0)
    rows = []
    for ev in prof.key_averages():
        if not str(ev.device_type).endswith("CUDA") or getattr(ev, "is_user_annotation", False):
            continue  # host-side ops and the spans' device ranges; their kernels are listed themselves
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:  # older torch
            dev_us = getattr(ev, "self_cuda_time_total", 0.0)
        if dev_us > 0:
            rows.append({"name": ev.key[:80], "calls": ev.count, "device_ms": dev_us / 1e3})
    rows.sort(key=lambda r: -r["device_ms"])
    return rows[:top]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--fast-math", action="store_true",
                    help="sample with the one-pass bf16 products (Sampler(fast_math=True))")
    ap.add_argument("--max-notes", type=int, default=GANConfig().max_notes,
                    help="GANConfig.max_notes (1024: the decoder tail at M = 128)")
    args = ap.parse_args(argv)
    sampler = Sampler(GANConfig(max_notes=args.max_notes), seed=0, fast_math=args.fast_math, device="cuda")
    sampler.sample_notes(["happy"] * args.batch, seed=0)  # build and warm up
    info = {"device": torch.cuda.get_device_name(sampler.device), "batch": args.batch,
            "max_notes": args.max_notes, "fast_math": args.fast_math}
    print(json.dumps({**info, "spans": span_times(sampler, args.batch, args.repeats)}))
    print(json.dumps({**info, "sample_notes_wall_ms": wall_times(sampler, args.batch, args.repeats)}))
    table = kernel_table(sampler, args.batch)
    print(json.dumps({**info, "profiler_top_kernels": table}))
    if not args.fast_math:
        print(json.dumps({**info, "decoder_tail_fold": fold_cost(sampler, args.batch, args.repeats)}))
        print(json.dumps({**info, "decoder_tail_vs_library": tail_vs_library(sampler, args.batch, args.repeats)}))


if __name__ == "__main__":
    main()
