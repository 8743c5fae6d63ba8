#!/usr/bin/env python3
"""Smoke test of melogan_torch on one NVIDIA GPU (built for the H100).

Run from the root of a checkout: ``python3 chip_smoke.py``. It

1. checks for CUDA and prints the card's name and power limit (nvidia-smi);
2. builds every kernel of ``melogan_torch/csrc`` with nvcc (sm_90a), in parallel;
3. turns TF32 off, then holds each kernel against its plain PyTorch version at
   the main path's shapes, batch 1 and 4096, and times kernel, plain version
   and one PyTorch library call (``F.conv_transpose1d``, a yardstick the port
   never calls) with CUDA events; one JSON line per kernel and batch;
4. sets every launch count to 0 and drives the main path through the entry
   points a user calls: ``Sampler(GANConfig(), device="cuda")`` for the four
   emotions and a batch of 4096 (the fused decoder kernel), a config whose
   max_notes is not a multiple of 8 (the per-layer convt kernel),
   ``generate_midi``, and the HTTP server answering four ``POST /generate``
   and one ``GET /healthz``; then reads the counts, which must all be > 0;
5. checks the notes against the port's CPU path on the same weights and inputs;
6. prints the ``kernels`` JSON line, the nvidia-smi line, and last
   ``{"ok": true, "device": {...}}``.

Any failure raises and exits non-zero; without CUDA, or without the rest of
the repository beside it, it exits non-zero before printing a result.
"""
import json
import os
import subprocess
import sys
import threading
import time
import urllib.request

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK_DIR = os.path.join(ROOT, "build", "chip_smoke")  # results.json, a .mid

# H100 SXM data sheet, dense, at the full 700 W power limit
PEAK_F32_FLOPS = 67e12  # IEEE f32 outside the tensor cores
PEAK_HBM_BYTES = 3.35e12
# kernel vs plain version, both IEEE f32 with sums in different orders over
# at most 5·256 products per stage and three stages: agreement is ~1e-6 of
# the output scale, so 1e-4 of it leaves a wide margin and still catches a
# wrong tap, channel or boundary (those are O(1) of the scale)
TOL_REL = 1e-4
BATCHES = (1, 4096)
MAIN_BATCH = 4096
DECODER_M, DECODER_WIDTHS = 64, (256, 128, 64, 4)
CONVT_LAYERS = [(64, 256, 128), (128, 128, 64), (256, 64, 4)]  # (L, Cin, Cout)


def emit(record, results):
    results.append(record)
    print(json.dumps(record), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, iters):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound(flops, nbytes):
    """Least time on the card (ms): the larger of operations over the f32
    peak and bytes (each input read once, each output written once) over
    the HBM rate."""
    t_ops, t_bytes = flops / PEAK_F32_FLOPS * 1e3, nbytes / PEAK_HBM_BYTES * 1e3
    return {"bound_ms": max(t_ops, t_bytes), "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "ops_ms": t_ops, "bytes_ms": t_bytes}


def compare(out, ref, what):
    err = float((out - ref).abs().max())
    scale = float(ref.abs().max())
    if not (err <= TOL_REL * max(scale, 1e-30)) or not bool(out.isfinite().all()):
        raise SystemExit(f"{what}: max abs err {err:.3e} exceeds {TOL_REL} x scale {scale:.3e}")
    return err, err / scale if scale else 0.0


def check_decoder(torch, F, ops, b, gen, results):
    m, widths = DECODER_M, DECODER_WIDTHS
    x = torch.randn((b, m, widths[0]), device="cuda", generator=gen)
    stages = []
    for cin, cout in zip(widths[:-1], widths[1:]):
        w = torch.randn((5, cin, cout), device="cuda", generator=gen) / (5 * cin) ** 0.5
        stages.append((w, 0.1 * torch.randn((cout,), device="cuda", generator=gen)))
    out = ops["decoder"].decoder_tail_cuda(x, stages)
    ref = ops["decoder"].decoder_tail_plain(x, stages)
    torch.cuda.synchronize()
    err, rel = compare(out, ref, f"decoder_tail B={b}")
    xn = x.transpose(1, 2).contiguous()
    wt = [(w.permute(1, 2, 0).contiguous(), bias) for w, bias in stages]

    def library():
        y = F.conv_transpose1d(xn, wt[0][0], wt[0][1], 2, 2, 1).relu_()
        y = F.conv_transpose1d(y, wt[1][0], wt[1][1], 2, 2, 1).relu_()
        return F.conv_transpose1d(y, wt[2][0], wt[2][1], 2, 2, 1)

    iters = 20 if b > 64 else 200
    flops = ops["decoder"].decoder_tail_flops(b, m, widths)
    nbytes = 4 * (x.numel() + out.numel() + sum(w.numel() + bb.numel() for w, bb in stages))
    rec = {
        "kernel": "decoder_tail", "batch": b, "shape": [b, m, *widths],
        "max_abs_err": err, "max_rel_err": rel, "tol_rel": TOL_REL,
        "kernel_ms": time_ms(torch, lambda: ops["decoder"].decoder_tail_cuda(x, stages), iters),
        "plain_ms": time_ms(torch, lambda: ops["decoder"].decoder_tail_plain(x, stages), iters),
        "library_ms": time_ms(torch, library, iters),
        **bound(flops, nbytes), "flops": flops, "bytes": nbytes,
    }
    emit(rec, results)
    return rec


def check_convt(torch, F, ops, b, gen, results):
    recs = []
    for l, cin, cout in CONVT_LAYERS:
        x = torch.randn((b, l, cin), device="cuda", generator=gen)
        w = torch.randn((5, cin, cout), device="cuda", generator=gen) / (5 * cin) ** 0.5
        bias = 0.1 * torch.randn((cout,), device="cuda", generator=gen)
        out = ops["convt"].convt1d_cuda(x, w, bias, 2, 2, 1)
        ref = ops["convt"].convt1d_plain(x, w, bias, 2, 2, 1)
        torch.cuda.synchronize()
        err, rel = compare(out, ref, f"convt1d B={b} L={l} {cin}->{cout}")
        xn, wt = x.transpose(1, 2).contiguous(), w.permute(1, 2, 0).contiguous()
        iters = 20 if b > 64 else 200
        flops = ops["convt"].convt_flops(b, l, cin, cout, 5, 2, 2, 1)
        nbytes = 4 * (x.numel() + w.numel() + bias.numel() + out.numel())
        rec = {
            "kernel": "convt1d", "batch": b, "shape": [b, l, cin, cout],
            "max_abs_err": err, "max_rel_err": rel, "tol_rel": TOL_REL,
            "kernel_ms": time_ms(torch, lambda: ops["convt"].convt1d_cuda(x, w, bias, 2, 2, 1), iters),
            "plain_ms": time_ms(torch, lambda: ops["convt"].convt1d_plain(x, w, bias, 2, 2, 1), iters),
            "library_ms": time_ms(torch, lambda: F.conv_transpose1d(xn, wt, bias, 2, 2, 1), iters),
            **bound(flops, nbytes), "flops": flops, "bytes": nbytes,
        }
        emit(rec, results)
        recs.append(rec)
    return recs


def http(base, path, body=None):
    req = urllib.request.Request(base + path, data=body,
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as resp:
        return resp.status, resp.read()


def drive_main_path(torch, results):
    """The port's entry points, as a user calls them."""
    import numpy as np

    from melogan_torch import EMOTIONS
    from melogan_torch.config import GANConfig
    from melogan_torch.sampling import Sampler
    from melogan_torch.serving.app import create_server

    def check_notes(notes, shape, what):
        if notes.shape != shape or not np.isfinite(notes).all():
            raise SystemExit(f"{what}: notes {notes.shape} (want {shape}) or not finite")

    sampler = Sampler(GANConfig(), seed=0, device="cuda")
    check_notes(sampler.sample_notes(list(EMOTIONS), seed=1), (4, 512, 4), "sample_notes x4")
    big = [EMOTIONS[i % 4] for i in range(MAIN_BATCH)]
    walls = []
    for seed in (2, 3, 4):
        t0 = time.perf_counter()
        notes = sampler.sample_notes(big, seed=seed)  # ends in a device→host copy
        walls.append(time.perf_counter() - t0)
        check_notes(notes, (MAIN_BATCH, 512, 4), "sample_notes x4096")
    emit({"phase": "sample_notes", "batch": MAIN_BATCH, "wall_s": walls,
          "samples_per_s_best": MAIN_BATCH / min(walls)}, results)

    layered = Sampler(GANConfig(max_notes=500), seed=0, device="cuda")
    if layered.generator.decoder.fuses():
        raise SystemExit("max_notes=500 should take the layered path")
    check_notes(layered.sample_notes(list(EMOTIONS), seed=5), (4, 500, 4), "layered sample_notes")

    os.makedirs(WORK_DIR, exist_ok=True)
    mid = os.path.join(WORK_DIR, "happy.mid")
    sampler.generate_midi("happy", mid, seed=6)
    with open(mid, "rb") as f:
        if f.read(4) != b"MThd":
            raise SystemExit("generate_midi wrote no MIDI file")

    httpd, _state = create_server("127.0.0.1", 0, device="cuda")
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        base = f"http://127.0.0.1:{httpd.server_address[1]}"
        for emotion in EMOTIONS:
            status, body = http(base, "/generate", json.dumps({"emotion": emotion}).encode())
            if status != 200 or body[:4] != b"MThd":
                raise SystemExit(f"/generate {emotion}: status {status}")
        status, body = http(base, "/healthz")
        health = json.loads(body)
        if status != 200 or health["device"]["platform"] != "gpu":
            raise SystemExit(f"/healthz: {status} {health}")
        emit({"phase": "http", "generate": 4, "healthz": health}, results)
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=30)
    return sampler, layered


def check_against_cpu(torch, samplers, results):
    """The GPU path (kernels) against the port's CPU path (plain versions) on
    the same weights and the same features and noise."""
    import numpy as np

    from melogan_torch.sampling import Sampler

    rng = np.random.default_rng(0)
    for s in samplers:
        cpu = Sampler(s.cfg, gen_variables=s.generator.state_dict(),
                      fe_variables=s.feature_encoder.state_dict(), device="cpu")
        feats = rng.normal(size=(8, s.cfg.numeric_input_dim)).astype(np.float32)
        noise = rng.normal(size=(8, s.cfg.noise_dim)).astype(np.float32)
        gpu_notes = torch.from_numpy(s.sample_from(feats, noise))
        cpu_notes = torch.from_numpy(cpu.sample_from(feats, noise))
        err, rel = compare(gpu_notes, cpu_notes, f"GPU vs CPU notes, max_notes={s.cfg.max_notes}")
        emit({"phase": "gpu_vs_cpu", "max_notes": s.cfg.max_notes,
              "fused": s.generator.decoder.fuses(), "max_abs_err": err, "max_rel_err": rel},
             results)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this check needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import melogan_torch  # fails when the script stands alone

    if not os.path.abspath(melogan_torch.__file__).startswith(ROOT + os.sep):
        print(f"chip_smoke: melogan_torch imported from {melogan_torch.__file__}, "
              f"not from this checkout", file=sys.stderr)
        return 2
    import torch.nn.functional as F

    from melogan_torch.ops import _build, convt, decoder

    smi = nvidia_smi_line()
    print(smi, flush=True)
    results = []

    t0 = time.perf_counter()
    libs = _build.build_all()
    ptxas = {}
    for name in libs:
        log = _build.log_path(name)
        if log.exists():
            ptxas[name] = [ln.strip() for ln in log.read_text().splitlines()
                           if "registers" in ln or "spill" in ln]
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "libraries": sorted(str(p.relative_to(ROOT)) for p in libs.values()),
          "ptxas": ptxas}, results)

    # IEEE f32 for the plain versions and library calls as for the port
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ops = {"convt": convt, "decoder": decoder}
    gen = torch.Generator(device="cuda").manual_seed(0)
    dec, cvt = {}, {}
    for b in BATCHES:
        dec[b] = check_decoder(torch, F, ops, b, gen, results)
        cvt[b] = check_convt(torch, F, ops, b, gen, results)

    convt.convt1d_cuda.launches = 0
    decoder.decoder_tail_cuda.launches = 0
    samplers = drive_main_path(torch, results)
    launches = {"decoder_tail": decoder.decoder_tail_cuda.launches,
                "convt1d": convt.convt1d_cuda.launches}
    emit({"phase": "main_path_launches", **launches}, results)
    missing = [k for k, n in launches.items() if n <= 0]
    if missing:
        raise SystemExit(f"main path never launched: {missing}")

    check_against_cpu(torch, samplers, results)

    big_d, big_c = dec[BATCHES[-1]], cvt[BATCHES[-1]]  # batch 4096
    kernels = [
        {
            "name": "decoder_tail", "route": "cuda",
            "source": "melogan_torch/csrc/decoder_tail.cu",
            "replaces": "melogan_tpu/ops/pallas/decoder.py:73",
            "launches": launches["decoder_tail"],
            "max_abs_err": max(dec[b]["max_abs_err"] for b in BATCHES),
            "ms": big_d["kernel_ms"], "plain_ms": big_d["plain_ms"],
            "bound_ms": big_d["bound_ms"], "bound_by": big_d["bound_by"],
            "library_ms": big_d["library_ms"],
        },
        {
            # the three layers of the layered decoder tail at batch 4096, summed
            "name": "convt1d", "route": "cuda",
            "source": "melogan_torch/csrc/convt1d.cu",
            "replaces": "melogan_tpu/ops/pallas/conv1d.py:140",
            "launches": launches["convt1d"],
            "max_abs_err": max(r["max_abs_err"] for b in BATCHES for r in cvt[b]),
            "ms": sum(r["kernel_ms"] for r in big_c),
            "plain_ms": sum(r["plain_ms"] for r in big_c),
            "bound_ms": sum(r["bound_ms"] for r in big_c),
            "bound_by": ("operations" if sum(r["ops_ms"] for r in big_c)
                         >= sum(r["bytes_ms"] for r in big_c) else "bytes"),
            "library_ms": sum(r["library_ms"] for r in big_c),
        },
    ]
    line = {"kernels": kernels}
    results.append(line)
    with open(os.path.join(WORK_DIR, "results.json"), "w") as f:
        json.dump({"nvidia_smi": smi, "results": results}, f, indent=1)
    print(json.dumps(line), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
