"""Where one ``Sampler.sample_notes`` call spends its time on the GPU.

    python -m melogan_torch.profile_sample [--batch 4096] [--repeats 5]

Builds ``Sampler(GANConfig(), device="cuda")`` with seeded random weights,
warms it up, then

1. times the stages of the sample step with CUDA events, each over
   ``--repeats`` runs of the same inputs: jitter and noise draws, the feature
   encoder, NoiseToLatent plus the decoder pre-net, the decoder tail kernel
   (the folded stages come from their cache), and the device→host copy of the notes
   (through page-locked memory, as ``Sampler`` does);
2. wall-clocks whole ``sample_notes`` calls (host clock, ending in the copy);
3. traces one ``sample_notes`` call with ``torch.profiler`` and lists device
   time by kernel name;
4. times the decoder-tail stage with the folded BN stages from their cache
   against folding them on every call, in turn over three rounds: CUDA-event
   ms and host-clock ms a call, and the device kernels of one call.

Prints one JSON object per part; needs CUDA.
"""
from __future__ import annotations

import argparse
import json
import time

import torch

from melogan_torch import EMOTIONS
from melogan_torch.config import GANConfig
from melogan_torch.models.layers import trim_or_pad_length
from melogan_torch.ops.decoder import fused_decoder_tail
from melogan_torch.sampling import FEATURE_JITTER_STD, Sampler, _to_numpy


def _event_ms(fn, repeats: int) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(repeats):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / repeats


def stage_times(sampler: Sampler, batch: int, repeats: int) -> dict:
    dev = sampler.device
    gen, fe = sampler.generator, sampler.feature_encoder
    dec = gen.decoder
    idx = torch.arange(batch, device=dev) % len(EMOTIONS)
    rng = torch.Generator(device=dev).manual_seed(0)
    with torch.inference_mode():
        base = sampler._base_features[idx]
        feats = base + FEATURE_JITTER_STD * torch.randn(base.shape, generator=rng, device=dev)
        noise = torch.randn((batch, sampler.cfg.noise_dim), generator=rng, device=dev)
        emb = fe(feats)
        latent = gen.noise_to_latent(torch.cat([noise, emb], dim=1))
        y = dec.pre(latent).reshape(batch, 256, dec.reduced_len).transpose(1, 2).contiguous()
        notes = fused_decoder_tail(y, dec.folded_stages())

        def draws():
            b = sampler._base_features[idx]
            b + FEATURE_JITTER_STD * torch.randn(b.shape, generator=rng, device=dev)
            torch.randn((batch, sampler.cfg.noise_dim), generator=rng, device=dev)

        def prenet():
            z = dec.pre(gen.noise_to_latent(torch.cat([noise, emb], dim=1)))
            z.reshape(batch, 256, dec.reduced_len).transpose(1, 2).contiguous()

        times = {
            "draws_ms": _event_ms(draws, repeats),
            "feature_encoder_ms": _event_ms(lambda: fe(feats), repeats),
            "noise_to_latent_and_prenet_ms": _event_ms(prenet, repeats),
            "decoder_tail_ms": _event_ms(
                lambda: trim_or_pad_length(fused_decoder_tail(y, dec.folded_stages()),
                                           dec.max_notes), repeats),
            "to_host_ms": _event_ms(lambda: _to_numpy(notes), repeats),
        }
    times["sum_ms"] = sum(times.values())
    return times


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
            if str(ev.device_type).endswith("CUDA") and name in ev.key)
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


def kernel_table(sampler: Sampler, batch: int, top: int = 12) -> list:
    from torch.profiler import ProfilerActivity, profile

    emotions = [EMOTIONS[i % len(EMOTIONS)] for i in range(batch)]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        sampler.sample_notes(emotions, seed=0)
    rows = []
    for ev in prof.key_averages():
        if not str(ev.device_type).endswith("CUDA"):
            continue  # host-side ops; their kernels are listed themselves
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
    args = ap.parse_args(argv)
    sampler = Sampler(GANConfig(), seed=0, device="cuda")
    sampler.sample_notes(["happy"] * args.batch, seed=0)  # build and warm up
    info = {"device": torch.cuda.get_device_name(sampler.device), "batch": args.batch}
    print(json.dumps({**info, "stages": stage_times(sampler, args.batch, args.repeats)}))
    print(json.dumps({**info, "sample_notes_wall_ms": wall_times(sampler, args.batch, args.repeats)}))
    table = kernel_table(sampler, args.batch)
    print(json.dumps({**info, "profiler_top_kernels": table}))
    print(json.dumps({**info, "decoder_tail_fold": fold_cost(sampler, args.batch, args.repeats)}))


if __name__ == "__main__":
    main()
