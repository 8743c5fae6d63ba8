#!/usr/bin/env python3
"""Smoke test of melogan_torch on one NVIDIA GPU (built for the H100).

Run from the root of a checkout: ``python3 chip_smoke.py``. It

1. checks for CUDA and prints the card's name and power limit (nvidia-smi);
2. builds every kernel of ``melogan_torch/csrc`` with nvcc (sm_90a), in parallel;
3. turns TF32 off, then holds each kernel against its plain PyTorch version at
   the main paths' shapes and times kernel, plain version and one PyTorch
   library call (a yardstick the port never calls) with CUDA events:
   ``decoder_tail`` at batch 1 and 4096 with M = 64 and at batch 2048 with
   M = 128 (max_notes 1024; the sampling path; one call must show three
   device launches of the implicit-GEMM core in a ``torch.profiler``
   trace), ``convt1d`` at the decoder's three layers at batch 1, 32 (the
   generator forward of a training step) and 4096, ``conv1d`` at the
   emotion discriminator's four layers at batch 32 (the training batch)
   and 1024, plus the VAE encoder's stride-2 layer;
   every kernel's bound is taken at the 3xTF32 rate; then the two backward
   routes (each conv's input gradient runs the other conv's kernel) against
   autograd through the plain versions;
4. drives the sampling path with every launch count set to 0:
   ``Sampler(GANConfig(), device="cuda")`` for the four emotions and a batch
   of 4096 (the decoder-tail kernel), max_notes 1024 (the same kernel at
   M = 128), a config whose max_notes is not a multiple of 8 (the per-layer
   convt kernel), ``generate_midi``, and the HTTP server answering four
   ``POST /generate`` and one ``GET /healthz``; reads the counts, which must
   be > 0, and checks the notes of each config against the port's CPU path;
5. drives the training path with the counts set to 0 again:
   ``train(GANConfig(save_freq=1), EDConfig(), ...)`` at full width on a
   seeded corpus of 384 rows (2 groups and a 2-batch tail per epoch, batch
   32) for 2 epochs, then 1 epoch with λ_fm = 1, EMA 0.9 and the ED
   feature-matching targets, each saving a ``gan_epochNNNN.ckpt`` every
   epoch, then serves the trained ``gan_final.pth`` through
   ``Sampler(device="cuda")``; ``conv1d``, ``convt1d`` and ``decoder_tail``
   must all have launched;
6. ``checkpoint``: the size of the full-width periodic checkpoints, their
   ``load_checkpoint`` and ``save_checkpoint`` seconds (a load and a save
   must give the same bytes) and ``export_train_payload``'s;
7. ``resume`` (counts at 0): ``train(resume=True)`` from a copy of the
   2-epoch run's ``gan_epoch0001.ckpt`` to epoch 2 on the card, held
   against the run done in one go: it reports whether the two are bit for
   bit equal, and fails unless every parameter is within 2·lr per update,
   Adam's steps and the CUDA random stream agree exactly; ``conv1d`` and
   ``convt1d`` must have launched;
8. ``serve_ckpt`` (counts at 0): ``create_server`` on the EMA run's
   ``gan_final.ckpt`` with ``use_ema=True`` answering four ``POST
   /generate`` and one ``GET /healthz`` (``"ema": true``, platform gpu);
   ``decoder_tail`` must have launched;
9. ``determinism``: which operations of a training step repeat bit for bit
   on the same inputs, with ``torch.backends.cudnn.deterministic`` off and
   on (the training state turns it on);
10. times the group step (median wall of 10 steps after a first) and holds
    one group step on the card against the port's CPU path from the same
    state and random draws;
11. Stage 1 from disk, each path with the counts set to 0 first:
    ``data`` (the seeded synthetic corpus of 64 songs an emotion written as
    MIDI, preprocessed to ``.npz``, split, and train and val loaded, each
    step's seconds), ``vae_train`` (``vae_loop.train`` with
    ``configs/ae.yaml`` for 3 epochs; the reconstruction dumps must parse),
    ``vae_resume`` (from a copy of a 1-epoch run's ``ae_best.ckpt``, made
    before the counts are set to 0, to epoch 3, held against the straight
    run as ``resume`` is), ``encode`` (``encode_mu`` of train and
    val on the card against the CPU path; ``encoder_feats.npy`` written) and
    ``gan_conditioning`` (``gan_loop.train`` with
    ``configs/gan_conditioning.yaml`` on those latents for 1 epoch, then
    ``create_server`` with that YAML path answering ``POST /generate``);
    before them, ``kernels_vae`` holds both conv kernels at the VAE's
    layers (batch 32 and 256) and both backward routes (batch 32) against
    their plain versions, timed beside the library calls; between
    ``vae_train`` and ``vae_resume``, outside any counted path,
    ``vae_step`` times the median wall of 10 VAE training steps;
12. prints the ``kernels`` JSON line (launches summed over every driven
    path), the nvidia-smi line, and last ``{"ok": true, "device": {...}}``.

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
PEAK_F32_FLOPS = 67e12  # IEEE f32 outside the tensor cores (the group step's bound)
PEAK_3XTF32_FLOPS = 495e12 / 3  # f32 work in 3xTF32 on the tensor cores (the kernels)
PEAK_HBM_BYTES = 3.35e12
# kernel vs plain version. The kernels sum in 3xTF32 (each operand split into
# two TF32 halves, three tensor-core products into one f32 sum), which is
# f32-accurate: about 5e-7 of the output scale against a float64 product at
# these widths, as IEEE f32 is (tests/test_torch_igemm.py), so max_rel_err
# should read near 1e-6. The plain version sums in IEEE f32 in another order
# over at most 5·256 products a layer. 1e-4 of the scale leaves a wide margin
# and still catches a wrong tap, channel or boundary (those are O(1) of the
# scale), and one-pass TF32 (about 3e-4) fails it.
TOL_REL = 1e-4
MAIN_BATCH = 4096
# (batch, M) of decoder_tail: /generate, bulk sampling, and max_notes 1024
DECODER_CASES = [(1, 64), (MAIN_BATCH, 64), (2048, 128)]
DECODER_WIDTHS = (256, 128, 64, 4)
DECODER_LAUNCHES = 3  # igemm_conv launches a decoder_tail call must show in the trace
CONVT_LAYERS = [(64, 256, 128), (128, 128, 64), (256, 64, 4)]  # (L, Cin, Cout)
# (L, Cin, Cout, K, stride, padding, name): the ED's four conv blocks, the
# training path's shapes, and the VAE encoder's first (stride-2) layer
ED_LAYERS = [(512, 4, 64, 5, 1, 2, "ed1"), (512, 64, 128, 3, 1, 1, "ed2"),
             (512, 128, 256, 3, 1, 1, "ed3"), (512, 256, 256, 3, 1, 1, "ed4")]
CONV1D_LAYERS = ED_LAYERS + [(512, 4, 32, 5, 2, 2, "vae1")]
CONV1D_BATCHES = (32, 1024)
TRAIN_BATCH = 32
CONVT_BATCHES = (1, TRAIN_BATCH, 4096)
# ((L, Cin, Cout, K, s, p, output_padding), transposed, name): conv1d's input
# gradient runs convt1d (the ED's layers), convT's runs conv1d (the decoder's)
BACKWARD_LAYERS = [((l, cin, cout, k, s, p, 0), False, n) for l, cin, cout, k, s, p, n in ED_LAYERS] + [
    ((l, cin, cout, 5, 2, 2, 1), True, f"dec{i + 1}") for i, (l, cin, cout) in enumerate(CONVT_LAYERS)]
# the VAE at full width (configs/ae.yaml: max_notes 512): (L, Cin, Cout, K, s, p, name) of the
# encoder's k5 s2 p2 convs, (L, Cin, Cout) of the decoder's k5 s2 p2 op1 transposed convs
VAE_ENCODER = [(512, 4, 32, 5, 2, 2, "enc1"), (256, 32, 64, 5, 2, 2, "enc2"), (128, 64, 128, 5, 2, 2, "enc3")]
VAE_DECODER = [(64, 128, 64), (128, 64, 32), (256, 32, 4)]
VAE_BATCHES = (32, 256)  # a training batch, and encode_mu's chunk (ENCODE_BATCH)
VAE_BACKWARD = [((l, cin, cout, k, s, p, 0), False, n) for l, cin, cout, k, s, p, n in VAE_ENCODER] + [
    ((l, cin, cout, 5, 2, 2, 1), True, f"dec{i + 1}") for i, (l, cin, cout) in enumerate(VAE_DECODER)]
# 64 songs an emotion: the train split (45 an emotion, 180 rows) gives 5 batches of 32, one
# WGAN-GP group step (critic_iters 5), so the conditioning GAN reaches the ED's conv1d; with
# 48 an emotion (136 rows, 4 batches) its epoch would be a critic-only tail
CORPUS_PER_EMOTION = 64
VAE_EPOCHS = 3
VAE_STEPS = 10  # timed VAE training steps after a first
CORPUS_ROWS = 384  # batch 32: 12 batches, 2 groups of 5 and a 2-batch tail per epoch
GROUP_STEPS = 10  # timed group steps after a first


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


def bound(flops, nbytes, peak_flops):
    """Least time on the card (ms): the larger of operations over the
    kernel's peak (3xTF32) and bytes (each input read once, each output
    written once) over the HBM rate."""
    t_ops, t_bytes = flops / peak_flops * 1e3, nbytes / PEAK_HBM_BYTES * 1e3
    return {"bound_ms": max(t_ops, t_bytes), "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "ops_ms": t_ops, "bytes_ms": t_bytes, "peak_flops": peak_flops}


def compare(out, ref, what):
    err = float((out - ref).abs().max())
    scale = float(ref.abs().max())
    if not (err <= TOL_REL * max(scale, 1e-30)) or not bool(out.isfinite().all()):
        raise SystemExit(f"{what}: max abs err {err:.3e} exceeds {TOL_REL} x scale {scale:.3e}")
    return err, err / scale if scale else 0.0


def check_decoder(torch, F, ops, b, m, gen, results):
    from melogan_torch.profile_sample import device_kernels_per_call

    widths = DECODER_WIDTHS
    x = torch.randn((b, m, widths[0]), device="cuda", generator=gen)
    stages = []
    for cin, cout in zip(widths[:-1], widths[1:]):
        w = torch.randn((5, cin, cout), device="cuda", generator=gen) / (5 * cin) ** 0.5
        stages.append((w, 0.1 * torch.randn((cout,), device="cuda", generator=gen)))
    out = ops["decoder"].decoder_tail_cuda(x, stages)
    ref = ops["decoder"].decoder_tail_plain(x, stages)
    torch.cuda.synchronize()
    err, rel = compare(out, ref, f"decoder_tail B={b} M={m}")
    # the most of three traces: a trace can lose a kernel's record (one of six
    # went missing once at batch 4096), never invent one
    launches = max(device_kernels_per_call(lambda: ops["decoder"].decoder_tail_cuda(x, stages),
                                           "igemm_conv") for _ in range(3))
    if launches != DECODER_LAUNCHES:
        raise SystemExit(f"decoder_tail B={b} M={m}: {launches} igemm_conv launches a call "
                         f"in the trace, want {DECODER_LAUNCHES}")
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
        "device_launches_per_call": launches,
        "max_abs_err": err, "max_rel_err": rel, "tol_rel": TOL_REL,
        "kernel_ms": time_ms(torch, lambda: ops["decoder"].decoder_tail_cuda(x, stages), iters),
        "plain_ms": time_ms(torch, lambda: ops["decoder"].decoder_tail_plain(x, stages), iters),
        "library_ms": time_ms(torch, library, iters),
        **bound(flops, nbytes, PEAK_3XTF32_FLOPS), "flops": flops, "bytes": nbytes,
    }
    emit(rec, results)
    return rec


def check_convt(torch, F, ops, b, gen, results, layers=CONVT_LAYERS, phase=None):
    recs = []
    for i, (l, cin, cout) in enumerate(layers):
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
            "kernel": "convt1d", "layer": f"dec{i + 1}", "batch": b, "shape": [b, l, cin, cout],
            "max_abs_err": err, "max_rel_err": rel, "tol_rel": TOL_REL,
            "kernel_ms": time_ms(torch, lambda: ops["convt"].convt1d_cuda(x, w, bias, 2, 2, 1), iters),
            "plain_ms": time_ms(torch, lambda: ops["convt"].convt1d_plain(x, w, bias, 2, 2, 1), iters),
            "library_ms": time_ms(torch, lambda: F.conv_transpose1d(xn, wt, bias, 2, 2, 1), iters),
            **bound(flops, nbytes, PEAK_3XTF32_FLOPS), "flops": flops, "bytes": nbytes,
        }
        if phase:
            rec = {"phase": phase, **rec}
        emit(rec, results)
        recs.append(rec)
    return recs


def check_conv1d(torch, F, ops, b, gen, results, layers=CONV1D_LAYERS, phase=None):
    """The conv1d kernel at the ED's four layers (and the VAE encoder's
    stride-2 layer) against its plain version, timed beside ``F.conv1d``."""
    recs = []
    for l, cin, cout, k, s, p, what in layers:
        x = torch.randn((b, l, cin), device="cuda", generator=gen)
        w = torch.randn((k, cin, cout), device="cuda", generator=gen) / (k * cin) ** 0.5
        bias = 0.1 * torch.randn((cout,), device="cuda", generator=gen)
        c1 = ops["conv1d"]
        out = c1.conv1d_cuda(x, w, bias, s, p)
        ref = c1.conv1d_plain(x, w, bias, s, p)
        torch.cuda.synchronize()
        err, rel = compare(out, ref, f"conv1d B={b} {what}")
        xn, wt = x.transpose(1, 2).contiguous(), w.permute(2, 1, 0).contiguous()
        iters = 10 if b > 64 else 100
        flops = c1.conv1d_flops(b, l, cin, cout, k, s, p)
        nbytes = 4 * (x.numel() + w.numel() + bias.numel() + out.numel())
        rec = {
            "kernel": "conv1d", "layer": what, "batch": b, "shape": [b, l, cin, cout, k, s, p],
            "max_abs_err": err, "max_rel_err": rel, "tol_rel": TOL_REL,
            "kernel_ms": time_ms(torch, lambda: c1.conv1d_cuda(x, w, bias, s, p), iters),
            "plain_ms": time_ms(torch, lambda: c1.conv1d_plain(x, w, bias, s, p), iters),
            "library_ms": time_ms(torch, lambda: F.conv1d(xn, wt, bias, s, p), iters),
            **bound(flops, nbytes, PEAK_3XTF32_FLOPS), "flops": flops, "bytes": nbytes,
        }
        if phase:
            rec = {"phase": phase, **rec}
        emit(rec, results)
        recs.append(rec)
    return recs


def check_backward_routes(torch, F, ops, b, gen, results, layers=BACKWARD_LAYERS, phase="backward_route"):
    """Each conv Function's dx, dw and dbias on the card against autograd
    through the plain versions, and the input-gradient route alone (the
    other conv's kernel) timed beside one library call computing the same
    function: cuDNN's conv1d input gradient, or ``F.conv1d`` for convT."""
    conv = ops["conv"]
    c1, ct = ops["conv1d"], ops["convt"]
    recs = []
    for (l, cin, cout, k, s, p, op), transposed, what in layers:
        x = torch.randn((b, l, cin), device="cuda", generator=gen)
        w = torch.randn((k, cin, cout), device="cuda", generator=gen) / (k * cin) ** 0.5
        bias = 0.1 * torch.randn((cout,), device="cuda", generator=gen)
        if transposed:
            ours = lambda x_, w_, b_: conv.conv_transpose1d(x_, w_, s, p, op, bias=b_)  # noqa: E731
            plain = lambda x_, w_, b_: ct.convt1d_plain(x_, w_, b_, s, p, op)  # noqa: E731
        else:
            ours = lambda x_, w_, b_: conv.conv1d(x_, w_, s, p, bias=b_)  # noqa: E731
            plain = lambda x_, w_, b_: c1.conv1d_plain(x_, w_, b_, s, p)  # noqa: E731
        g = torch.randn(plain(x, w, bias).shape, device="cuda", generator=gen)

        def grads(fn):
            xs, ws, bs = (t.detach().clone().requires_grad_() for t in (x, w, bias))
            return torch.autograd.grad((fn(xs, ws, bs) * g).sum(), (xs, ws, bs))

        got, want = grads(ours), grads(plain)
        torch.cuda.synchronize()
        errs = [compare(a, e, f"{what} grad {n}")[0] for a, e, n in zip(got, want, ("dx", "dw", "db"))]
        wT = w.transpose(1, 2).contiguous()
        if transposed:  # dx = conv1d(g, wᵀ)
            route = lambda: c1.conv1d_cuda(g, wT, None, s, p)  # noqa: E731
            route_plain = lambda: c1.conv1d_plain(g, wT, None, s, p)  # noqa: E731
            gn, wl = g.transpose(1, 2).contiguous(), w.permute(1, 2, 0).contiguous()
            library = lambda: F.conv1d(gn, wl, None, s, p)  # noqa: E731
            flops = c1.conv1d_flops(b, g.shape[1], cout, cin, k, s, p)
        else:  # dx = conv_transpose1d(g, wᵀ)
            opx = (l + 2 * p - k) % s
            route = lambda: ct.convt1d_cuda(g, wT, None, s, p, opx)  # noqa: E731
            route_plain = lambda: ct.convt1d_plain(g, wT, None, s, p, opx)  # noqa: E731
            gn, wl = g.transpose(1, 2).contiguous(), w.permute(2, 1, 0).contiguous()
            library = lambda: torch.nn.grad.conv1d_input((b, cin, l), wl, gn, s, p)  # noqa: E731
            flops = ct.convt_flops(b, g.shape[1], cout, cin, k, s, p, opx)
        lib_out = library()
        compare(lib_out.transpose(1, 2), route(), f"{what} library dx")  # the same function
        iters = 50
        nbytes = 4 * (g.numel() + w.numel() + x.numel())
        rec = {
            "phase": phase, "layer": what, "batch": b,
            "dx_runs": "conv1d kernel" if transposed else "convt1d kernel",
            "max_abs_err_dx_dw_db": errs, "tol_rel": TOL_REL,
            "dx_kernel_ms": time_ms(torch, route, iters),
            "dx_plain_ms": time_ms(torch, route_plain, iters),
            "dx_library_ms": time_ms(torch, library, iters),
            **bound(flops, nbytes, PEAK_3XTF32_FLOPS), "flops": flops,
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

    long_sampler = Sampler(GANConfig(max_notes=1024), seed=0, device="cuda")
    if not long_sampler.generator.decoder.fuses():
        raise SystemExit("max_notes=1024 should take the decoder-tail kernel")
    check_notes(long_sampler.sample_notes(list(EMOTIONS), seed=5), (4, 1024, 4),
                "max_notes=1024 sample_notes")
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

    # a workdir without checkpoints: seeded random weights, whatever the checkout holds
    httpd, _state = create_server("127.0.0.1", 0, workdir=os.path.join(WORK_DIR, "no_checkpoint"),
                                  device="cuda")
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
    return sampler, long_sampler, layered


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


def make_corpus(np, n, seed=0):
    """A seeded corpus at the real shapes: (n, 512, 4) raw notes (pitch,
    start, duration, velocity) with 200-512 notes a song and padding rows
    after, standardized numeric features, the four emotions in turn."""
    from melogan_torch.data.datasets import SplitData

    rng = np.random.default_rng(seed)
    raw = np.zeros((n, 512, 4), np.float32)
    raw[..., 0] = -1.0
    for i in range(n):
        m = int(rng.integers(200, 513))
        steps = rng.choice([0.25, 0.5, 1.0], size=m)
        raw[i, :m, 0] = rng.integers(36, 97, size=m)
        raw[i, :m, 1] = np.cumsum(steps) - steps
        raw[i, :m, 2] = steps * rng.uniform(0.5, 1.5, size=m)
        raw[i, :m, 3] = rng.integers(40, 111, size=m)
    emotions = np.array(["happy", "sad", "angry", "calm"] * (n // 4 + 1))[:n]
    numeric = rng.normal(size=(n, 6)).astype(np.float32)
    return SplitData(raw, emotions, numeric, [f"song{i}" for i in range(n)])


def drive_training_path(torch, np, results):
    """``train()`` as a user calls it, then the trained file served. The
    runs save a periodic checkpoint every epoch (``save_freq=1``)."""
    import dataclasses

    from melogan_torch import EMOTIONS
    from melogan_torch.config import EDConfig, GANConfig
    from melogan_torch.models.ed import EmotionDiscriminator
    from melogan_torch.models.layers import torch_default_init_
    from melogan_torch.sampling import Sampler
    from melogan_torch.train.gan_loop import train
    from melogan_torch.utils.weights import load_gan_final_full

    data = make_corpus(np, CORPUS_ROWS)
    cfg, ed_cfg = GANConfig(save_freq=1), EDConfig()
    workdir = os.path.join(WORK_DIR, "train")
    t0 = time.perf_counter()
    state, hist = train(cfg, ed_cfg, data, workdir=workdir, epochs=2, verbose=False, device="cuda")
    emit({"phase": "train", "epochs": 2, "wall_s": time.perf_counter() - t0, "history": hist}, results)
    # a pre-trained ED stands in as seeded random weights: it switches on the
    # ED feature-matching targets, as a reference run with ed_best.pth does
    ed = EmotionDiscriminator.from_config(ed_cfg.model_cfg())
    torch_default_init_(ed, torch.Generator().manual_seed(7))
    fm_cfg = dataclasses.replace(cfg, lambda_fm=1.0, ema_decay=0.9)
    fm_workdir = os.path.join(WORK_DIR, "train_fm_ema")
    t0 = time.perf_counter()
    _, hist_fm = train(fm_cfg, ed_cfg, data, ed_variables=ed.state_dict(), workdir=fm_workdir,
                       epochs=1, verbose=False, device="cuda")
    emit({"phase": "train_fm_ema", "epochs": 1, "wall_s": time.perf_counter() - t0,
          "history": hist_fm}, results)
    for h, keys in ((hist, 9), (hist_fm, 10)):
        if len(h) != keys or not all(np.isfinite(v) for v in h.values()):
            raise SystemExit(f"train history: {h}")

    path = os.path.join(fm_workdir, cfg.checkpoint_dir, "gan_final.pth")
    gen_sd, fe_sd, extras = load_gan_final_full(path, ema=True)
    sampler = Sampler(cfg, gen_variables=gen_sd, fe_variables=fe_sd,
                      emotion_features=extras["emotion_features"], device="cuda")
    notes = sampler.sample_notes(list(EMOTIONS), seed=0)
    if notes.shape != (4, 512, 4) or not np.isfinite(notes).all():
        raise SystemExit(f"trained sampler: notes {notes.shape} or not finite")
    emit({"phase": "serve_trained", "checkpoint": os.path.relpath(path, ROOT),
          "fused": sampler.generator.decoder.fuses(), "notes_std": float(notes.std())}, results)
    return {"data": data, "cfg": cfg, "ed_cfg": ed_cfg, "state": state, "history": hist,
            "workdir": workdir, "fm_workdir": fm_workdir}


def check_checkpoint_files(np, trained, results):
    """Size, ``load_checkpoint`` and ``save_checkpoint`` seconds of the
    training runs' periodic checkpoints at full width (the plain run's
    epoch 2: G, the critic, the feature encoder and both Adams; the EMA
    run's epoch 1 adds G_ema and the raw EMA stream), and the seconds
    ``export_train_payload`` takes to build the first from the live state."""
    from melogan_torch.train import gan_step
    from melogan_torch.utils.checkpoint import load_checkpoint, save_checkpoint
    from melogan_torch.utils.weights import export_train_payload

    cfg, state = trained["cfg"], trained["state"]
    rec = {"phase": "checkpoint"}
    for name, workdir, ckpt in (("plain", trained["workdir"], "gan_epoch0002.ckpt"),
                                ("ema", trained["fm_workdir"], "gan_epoch0001.ckpt")):
        path = os.path.join(workdir, cfg.checkpoint_dir, ckpt)
        t0 = time.perf_counter()
        tree = load_checkpoint(path)
        t1 = time.perf_counter()
        copy = os.path.join(WORK_DIR, f"resaved_{name}.ckpt")
        save_checkpoint(copy, tree)
        t2 = time.perf_counter()
        with open(path, "rb") as f, open(copy, "rb") as g:
            if f.read() != g.read():
                raise SystemExit(f"{path}: a load and save does not give the same bytes")
        os.remove(copy)
        rec[name] = {"file": os.path.relpath(path, ROOT), "mb": os.path.getsize(path) / 1e6,
                     "load_s": t1 - t0, "save_s": t2 - t1}
    t0 = time.perf_counter()
    export_train_payload(state, 2, np.zeros((4, 6), np.float32),
                         g_ema=gan_step.ema_weights(state, cfg.ema_decay))
    rec["plain"]["export_train_payload_s"] = time.perf_counter() - t0
    emit(rec, results)


def drive_resume(torch, trained, results):
    """``train(resume=True)`` on the card from a copy of the plain run's
    ``gan_epoch0001.ckpt``, to epoch 2, held against the run done in one
    go: bit for bit where every operation is deterministic, else to the
    tolerances of ``check_group_step_against_cpu`` (2·lr per update)."""
    import shutil

    from melogan_torch.train.gan_loop import train

    cfg, straight = trained["cfg"], trained["state"]
    workdir = os.path.join(WORK_DIR, "resume")
    shutil.rmtree(workdir, ignore_errors=True)
    ckpt_dir = os.path.join(workdir, cfg.checkpoint_dir)
    os.makedirs(ckpt_dir)
    shutil.copy(os.path.join(trained["workdir"], cfg.checkpoint_dir, "gan_epoch0001.ckpt"), ckpt_dir)
    t0 = time.perf_counter()
    resumed, hist = train(cfg, trained["ed_cfg"], trained["data"], workdir=workdir, epochs=2,
                          verbose=False, resume=True, device="cuda")
    wall = time.perf_counter() - t0
    if resumed.step != straight.step:
        raise SystemExit(f"resume: step {resumed.step}, straight-through {straight.step}")
    # updates each module group took in the resumed epoch: 12 critic updates
    # (2 groups of 5 and a 2-batch tail) and 2 generator updates
    n_batches = CORPUS_ROWS // cfg.batch_size
    n_groups = n_batches // cfg.critic_iters
    lr_updates = {"generator": (cfg.lr_g, n_groups), "feature_encoder": (cfg.lr_g, n_groups),
                  "critic": (cfg.lr_d, n_batches)}
    differing, worst = [], {}
    for what, (lr, updates) in lr_updates.items():
        a, b = getattr(straight, what).state_dict(), getattr(resumed, what).state_dict()
        for name in a:
            if torch.equal(a[name], b[name]):
                continue
            d = float((a[name].double() - b[name].double()).abs().max())
            differing.append(f"{what}.{name}")
            worst[what] = max(worst.get(what, 0.0), d)
            limit = 2 * lr * updates * (1 + 1e-3)
            if not a[name].is_floating_point() or ("running" not in name and d > limit):
                raise SystemExit(f"resume: {what}.{name} differs by {d:.3e} (limit {limit:.3e})")
    for opt in ("opt_g", "opt_d"):
        oa, ob = getattr(straight, opt), getattr(resumed, opt)
        for pa, pb in zip(oa.param_groups[0]["params"], ob.param_groups[0]["params"]):
            if not torch.equal(oa.state[pa]["step"], ob.state[pb]["step"]):
                raise SystemExit(f"resume: {opt} steps differ")
            for k in ("exp_avg", "exp_avg_sq"):
                if not torch.equal(oa.state[pa][k], ob.state[pb][k]):
                    differing.append(f"{opt}.{k}")
    if not torch.equal(straight.rng.get_state(), resumed.rng.get_state()):
        raise SystemExit("resume: the CUDA random stream did not continue")
    same_history = all(hist[k] == trained["history"][k] for k in hist if k != "epoch_seconds")
    rec = {"phase": "resume", "wall_s": wall, "bit_identical": not differing and same_history,
           "differing": sorted(set(differing))[:20], "n_differing": len(set(differing)),
           "max_abs_diff": worst, "same_history": same_history,
           "param_limit": {w: 2 * lr * n for w, (lr, n) in lr_updates.items()}}
    emit(rec, results)
    return rec


def probe_determinism(torch, np, results):
    """Which operations of a training step give the same bits when run three
    times on the same inputs and weights (full width, batch 32), one
    operation at a time: cuDNN's conv1d weight and input gradients at the
    critic's three layers, cuBLAS's Linear gradients at the critic's head,
    the port's conv Functions' backward (kernels for dx, matmuls for dw) at
    the ED's and the decoder's layers, the generator's gradients through
    the frozen ED (no critic), and the critic's parameter gradients and the
    gradient penalty; with ``torch.backends.cudnn.deterministic`` off and
    on (the training state sets it on), each with the critic's gradient and
    penalty times (CUDA events)."""
    import torch.nn.functional as F

    from melogan_torch.config import EDConfig, GANConfig
    from melogan_torch.ops import conv as port_conv
    from melogan_torch.train import gan_step

    cfg = GANConfig()
    state = gan_step.init_state(cfg, gan_step.build_models(cfg, EDConfig()), seed=0, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(9)
    b = cfg.batch_size

    def rand(*shape):
        return torch.randn(shape, device="cuda", generator=g)

    real, fake = rand(b, cfg.max_notes, 4), rand(b, cfg.max_notes, 4)
    emb, noise = rand(b, cfg.encoder_out_dim), rand(b, cfg.noise_dim)
    alpha = torch.rand((b, 1, 1), device="cuda", generator=g)
    labels = torch.arange(b, device="cuda") % 4
    critic_params = list(state.critic.parameters())

    def grads(out, wrt):
        return [d for d in torch.autograd.grad(out, wrt, allow_unused=True) if d is not None]

    def cudnn_conv(wrt_input):
        def fn():
            outs, length = [], cfg.max_notes
            for layer in state.critic.conv[::2]:
                x = rand(b, layer.weight.shape[1], length).requires_grad_(wrt_input)
                w = layer.weight.detach().requires_grad_(not wrt_input)
                y = F.conv1d(x, w, None, 2, 2)
                outs += grads((y * rand(*y.shape)).sum(), [x if wrt_input else w])
                length = y.shape[-1]
            return outs
        return fn

    def cublas_linear():
        outs = []
        for lin in (state.critic.fc[1], state.critic.real_fake):
            x = rand(b, lin.in_features).requires_grad_(True)
            w = lin.weight.detach().requires_grad_(True)
            y = F.linear(x, w)
            outs += grads((y * rand(*y.shape)).sum(), [x, w])
        return outs

    def port_convs():
        outs = []
        for (l, cin, cout, k, st, p, op), transposed, _ in BACKWARD_LAYERS:
            x = rand(b, l, cin).requires_grad_(True)
            w = (rand(k, cin, cout) / (k * cin) ** 0.5).requires_grad_(True)
            y = (port_conv.conv_transpose1d(x, w, st, p, op) if transposed
                 else port_conv.conv1d(x, w, st, p))
            outs += grads((y * rand(*y.shape)).sum(), [x, w])
        return outs

    def generator_through_ed():
        notes, _ = state.generator(noise, None, emb)
        return grads(gan_step.cross_entropy(state.ed(notes), labels), list(state.generator.parameters()))

    def critic_grads():
        return grads(state.critic(real, emb).square().sum(), critic_params)

    def gp_grads():
        return grads(gan_step.gradient_penalty(state.critic, real, fake, emb, alpha), critic_params)

    def same_bits(make):
        """Three runs from the same generator state: equal bits?"""
        runs = []
        for _ in range(3):
            g.manual_seed(9)
            runs.append([t.clone() for t in make()])
        return all(torch.equal(x, y) for r in runs[1:] for x, y in zip(runs[0], r))

    ops = (("cudnn_conv1d_weight_grad", cudnn_conv(False)), ("cudnn_conv1d_input_grad", cudnn_conv(True)),
           ("cublas_linear_grads", cublas_linear), ("port_conv_backward", port_convs),
           ("generator_through_frozen_ed", generator_through_ed),
           ("critic_param_grads", critic_grads), ("gradient_penalty", gp_grads))
    rec = {"phase": "determinism"}
    prev = torch.backends.cudnn.deterministic  # train.gan_step.init_state sets it
    try:
        for flag in (False, True):
            torch.backends.cudnn.deterministic = flag
            rec[f"cudnn_deterministic_{flag}"] = {
                "same_bits_in_3_runs": {name: same_bits(fn) for name, fn in ops},
                "critic_param_grads_ms": time_ms(torch, critic_grads, 20),
                "gradient_penalty_ms": time_ms(torch, gp_grads, 20)}
    finally:
        torch.backends.cudnn.deterministic = prev
    emit(rec, results)


def drive_serve_ckpt(torch, trained, results):
    """``create_server`` on the EMA run's ``gan_final.ckpt`` with
    ``use_ema=True``: four ``POST /generate`` and one ``GET /healthz``."""
    from melogan_torch import EMOTIONS
    from melogan_torch.config import GANConfig
    from melogan_torch.serving.app import create_server

    path = os.path.join(trained["fm_workdir"], trained["cfg"].checkpoint_dir, "gan_final.ckpt")
    httpd, state = create_server("127.0.0.1", 0, config=GANConfig(ema_decay=0.9), checkpoint=path,
                                 use_ema=True, device="cuda")
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        base = f"http://127.0.0.1:{httpd.server_address[1]}"
        for emotion in EMOTIONS:
            status, body = http(base, "/generate", json.dumps({"emotion": emotion}).encode())
            if status != 200 or body[:4] != b"MThd":
                raise SystemExit(f"/generate {emotion} from the .ckpt: status {status}")
        status, body = http(base, "/healthz")
        health = json.loads(body)
        if (status != 200 or health["device"]["platform"] != "gpu" or health["ema"] is not True
                or health["generator"] != "checkpoint"):
            raise SystemExit(f"/healthz serving the .ckpt: {status} {health}")
        emit({"phase": "serve_ckpt", "checkpoint": os.path.relpath(path, ROOT), "generate": 4,
              "fused": state.sampler.generator.decoder.fuses(), "healthz": health}, results)
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=30)


def _batches_and_draws(torch, np, cfg, fe, seed, device_list):
    """One group's batches and random draws, made with numpy, on each device."""
    from melogan_torch.train.gan_step import CriticDraws, GenDraws, GroupDraws

    rng = np.random.default_rng(seed)
    k, b = cfg.critic_iters, cfg.batch_size
    data = make_corpus(np, k * b, seed=seed)
    arrays = (data.notes_gan().reshape(k, b, 512, 4), data.emotion_idx.reshape(k, b),
              np.zeros((k, b, cfg.latent_dim), np.float32), data.numeric.reshape(k, b, 6))
    widths = [m.out_features for m in fe.net if isinstance(m, torch.nn.Linear)][:-1]

    def masks():
        return [rng.uniform(size=(b, w)) < 1.0 - cfg.encoder_dropout for w in widths]

    critic = [(rng.normal(size=(b, cfg.noise_dim)), rng.uniform(size=(b, 1, 1)), masks()) for _ in range(k)]
    gen = (rng.normal(size=(b, cfg.noise_dim)), masks())
    out = []
    for dev in device_list:
        def t(a):
            a = np.asarray(a)
            return torch.as_tensor(a if a.dtype == bool else a.astype(
                np.int64 if a.dtype.kind == "i" else np.float32), device=dev)

        out.append((tuple(t(a) for a in arrays), GroupDraws(
            critic=[CriticDraws(t(z), t(a), [t(m) for m in ms]) for z, a, ms in critic],
            gen=GenDraws(t(gen[0]), [t(m) for m in gen[1]]))))
    return out


def time_group_step(torch, np, results):
    """Wall time of one group step at batch 32, full width (host clock
    around steps that end in a synchronize), with its launch counts."""
    from melogan_torch.config import EDConfig, GANConfig
    from melogan_torch.ops import conv1d, convt
    from melogan_torch.train import gan_step
    from melogan_torch.utils.flops import group_step_flops

    cfg, ed_cfg = GANConfig(), EDConfig()
    state = gan_step.init_state(cfg, gan_step.build_models(cfg, ed_cfg), seed=0, device="cuda")
    steps = gan_step.make_train_steps(cfg)
    (batches, _), = _batches_and_draws(torch, np, cfg, state.feature_encoder, 1, ["cuda"])
    walls = []
    for i in range(GROUP_STEPS + 1):
        if i == 1:
            c1, ct = conv1d.conv1d_cuda.launches, convt.convt1d_cuda.launches
        t0 = time.perf_counter()
        state, m = steps.group(state, batches)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        if i == 1:
            per_step = {"conv1d": conv1d.conv1d_cuda.launches - c1,
                        "convt1d": convt.convt1d_cuda.launches - ct}
    if not all(np.isfinite(float(v)) for v in m.values()):
        raise SystemExit(f"group step metrics not finite: {m}")
    flops = group_step_flops(cfg, ed_cfg)
    med = float(np.median(walls[1:]))
    rec = {"phase": "group_step", "batch": cfg.batch_size, "wall_ms_first": walls[0],
           "wall_ms": walls[1:], "median_ms": med, "group_steps_per_s": 1e3 / med,
           "flops": flops, "bound_ms": flops / PEAK_F32_FLOPS * 1e3,
           "launches_per_group_step": per_step}
    emit(rec, results)
    return rec


def check_group_step_against_cpu(torch, np, results):
    """One group step on the card against the port's CPU path from the same
    state and draws, shipped width. The critic starts away from its
    N(0, 0.02) init (weights ×10, biases N(0, 0.05)): at the init its
    pre-activations are so small that Adam's sign-like first moves (±lr)
    flip LeakyReLU kinks, and two sums in different orders then send a
    unit down different branches. Tolerances: metrics 1e-4 of their scale;
    gradients (Adam's first moments) 1e-4 of their module group's largest;
    parameters within 2·lr per update everywhere (an element whose true
    gradient is zero moves ±lr at random on each side) and within 1e-6 per
    update where the gradient is above 1e-4 of the group's largest."""
    from melogan_torch.config import EDConfig, GANConfig
    from melogan_torch.train import gan_step

    cfg, ed_cfg = GANConfig(), EDConfig()
    gpu = gan_step.init_state(cfg, gan_step.build_models(cfg, ed_cfg), seed=3, device="cuda")
    g = torch.Generator().manual_seed(5)
    with torch.no_grad():
        for m in gpu.critic.modules():
            if isinstance(m, (torch.nn.Conv1d, torch.nn.Linear)):
                m.weight.mul_(10.0)
                m.bias.copy_(0.05 * torch.randn(m.bias.shape, generator=g))
    cpu = gan_step.init_state(cfg, gan_step.build_models(cfg, ed_cfg), seed=3, device="cpu")
    for name in ("generator", "feature_encoder", "critic", "ed"):
        getattr(cpu, name).load_state_dict(getattr(gpu, name).state_dict())
    steps = gan_step.make_train_steps(cfg)
    on_gpu, on_cpu = _batches_and_draws(torch, np, cfg, gpu.feature_encoder, 2, ["cuda", "cpu"])
    t0 = time.perf_counter()
    _, mg = steps.group(gpu, *on_gpu)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    _, mc = steps.group(cpu, *on_cpu)
    t2 = time.perf_counter()
    worst = {}
    for k in mc:
        a, b = float(mg[k]), float(mc[k])
        worst[f"metric {k}"] = abs(a - b) / max(abs(b), 1e-30)
        if not abs(a - b) <= 1e-4 * abs(b):
            raise SystemExit(f"group step GPU vs CPU: {k} {a} vs {b}")
    for what, opt, lr, updates in (("generator", "opt_g", cfg.lr_g, 1),
                                   ("feature_encoder", "opt_g", cfg.lr_g, 1),
                                   ("critic", "opt_d", cfg.lr_d, cfg.critic_iters)):
        pg = dict(getattr(gpu, what).named_parameters())
        pc = dict(getattr(cpu, what).named_parameters())
        mu = {n: getattr(cpu, opt).state[p]["exp_avg"] for n, p in pc.items()}
        gmax = max(float(v.abs().max()) for v in mu.values())
        for n in pc:
            gerr = float((getattr(gpu, opt).state[pg[n]]["exp_avg"].cpu() - mu[n]).abs().max())
            d = (pg[n].detach().cpu() - pc[n].detach()).abs()
            big = mu[n].abs() > 1e-4 * gmax
            dbig = float(d[big].max()) if bool(big.any()) else 0.0
            worst[f"{what} grad"] = max(worst.get(f"{what} grad", 0.0), gerr / gmax)
            worst[f"{what} param"] = max(worst.get(f"{what} param", 0.0), dbig)
            if gerr > 1e-4 * gmax or float(d.max()) > 2 * lr * updates * (1 + 1e-3) or dbig > 1e-6 * updates:
                raise SystemExit(f"group step GPU vs CPU: {what}.{n}: grad err {gerr:.3e} "
                                 f"(group max {gmax:.3e}), param err {float(d.max()):.3e}, "
                                 f"where the gradient is large {dbig:.3e}")
    emit({"phase": "group_step_gpu_vs_cpu", "metrics_gpu": {k: float(v) for k, v in mg.items()},
          "worst": worst, "gpu_s": t1 - t0, "cpu_s": t2 - t1}, results)


def check_vae_kernels(torch, F, ops, gen, results):
    """``kernels_vae``: ``conv1d`` at the VAE encoder's three layers and
    ``convt1d`` at its decoder's three, at batch 32 (a training batch) and
    256 (``encode_mu``'s chunk), then both backward routes at 32: each
    against its plain version, timed beside its plain version and one
    library call (TF32 off), with its bound at 3xTF32. The Cin = 4 layer
    (enc1) is one 4-channel chunk in the core, its weakest shape."""
    recs = {"conv1d": [], "convt1d": []}
    for b in VAE_BATCHES:
        recs["conv1d"] += check_conv1d(torch, F, ops, b, gen, results, VAE_ENCODER, "kernels_vae")
        recs["convt1d"] += check_convt(torch, F, ops, b, gen, results, VAE_DECODER, "kernels_vae")
    back = check_backward_routes(torch, F, ops, TRAIN_BATCH, gen, results, VAE_BACKWARD,
                                 "kernels_vae_backward")
    summary = {"phase": "kernels_vae_summary"}
    for name, rs in recs.items():
        for b in VAE_BATCHES:
            summary[f"{name}_b{b}"] = {k: sum(r[k] for r in rs if r["batch"] == b)
                                       for k in ("kernel_ms", "plain_ms", "library_ms", "bound_ms")}
    summary["cin4"] = {r["batch"]: {k: r[k] for k in ("kernel_ms", "plain_ms", "library_ms", "bound_ms",
                                                      "bound_by")}
                       for r in recs["conv1d"] if r["layer"] == "enc1"}
    summary["backward_b32"] = {k: sum(r[k] for r in back) for k in ("dx_kernel_ms", "dx_plain_ms",
                                                                    "dx_library_ms", "bound_ms")}
    emit(summary, results)
    return recs


def drive_data(np, results):
    """``data``: the seeded synthetic corpus on disk (``generate_corpus``,
    MIDI files and a manifest), ``preprocess_corpus`` (``.npz`` samples and
    the scaler), ``create_splits`` and ``load_split`` of train and val, each
    step's seconds on the host clock."""
    import shutil

    from melogan_torch.data.datasets import load_split
    from melogan_torch.data.preprocess import preprocess_corpus
    from melogan_torch.data.splits import create_splits, read_manifest
    from melogan_torch.data.synthetic import generate_corpus

    root = os.path.join(WORK_DIR, "data")
    shutil.rmtree(root, ignore_errors=True)
    processed, splits_dir = os.path.join(root, "processed"), os.path.join(root, "splits")
    secs = {}
    t0 = time.perf_counter()
    entries = generate_corpus(root, n_per_emotion=CORPUS_PER_EMOTION, seed=0)
    t1 = time.perf_counter()
    preprocess_corpus(entries, processed, verbose=False).save(os.path.join(root, "scaler.npz"))
    t2 = time.perf_counter()
    create_splits(read_manifest(os.path.join(root, "data_manifest.csv")), splits_dir)
    t3 = time.perf_counter()
    data = {name: load_split(os.path.join(splits_dir, f"{name}_split.csv"), processed, verbose=False)
            for name in ("train", "val")}
    t4 = time.perf_counter()
    secs = {"generate_corpus": t1 - t0, "preprocess_corpus": t2 - t1, "create_splits": t3 - t2,
            "load_split": t4 - t3}
    rows = {name: d.n for name, d in data.items()}
    for name, d in data.items():
        if d.notes_raw.shape[1:] != (512, 4) or not np.isfinite(d.notes_ae()).all():
            raise SystemExit(f"data: the {name} split is {d.notes_raw.shape} or not finite")
    if rows["train"] < 5 * TRAIN_BATCH:
        raise SystemExit(f"data: {rows['train']} train rows give no WGAN-GP group step")
    emit({"phase": "data", "songs": len(entries), "rows": rows, "seconds": secs}, results)
    return data


def _logged(log_dir):
    """{epoch: {tag: value}} of a run's metrics.jsonl."""
    out = {}
    with open(os.path.join(log_dir, "metrics.jsonl")) as f:
        for line in f:
            rec = json.loads(line)
            out.setdefault(rec["step"], {})[rec["tag"]] = rec["value"]
    return out


def drive_vae_train(torch, np, data, results):
    """``vae_train``: ``vae_loop.train`` with ``configs/ae.yaml`` (max_notes
    512, latent 8, hidden 512, batch 32) for 3 epochs on the card, in a
    fresh workdir; the reconstruction dumps must parse back."""
    import dataclasses
    import shutil

    from melogan_torch.config import AEConfig
    from melogan_torch.midi.midifile import read_midi
    from melogan_torch.train import vae_loop

    cfg = dataclasses.replace(AEConfig.from_yaml(os.path.join(ROOT, "configs", "ae.yaml")), epochs=VAE_EPOCHS)
    workdir = os.path.join(WORK_DIR, "vae")
    shutil.rmtree(workdir, ignore_errors=True)
    t0 = time.perf_counter()
    best, metrics = vae_loop.train(cfg, data["train"], data["val"], workdir=workdir, verbose=False,
                                   device="cuda")
    wall = time.perf_counter() - t0
    logged = _logged(os.path.join(workdir, cfg.log_dir))
    if sorted(logged) != list(range(1, VAE_EPOCHS + 1)) or not all(
            np.isfinite(v) for ep in logged.values() for v in ep.values()):
        raise SystemExit(f"vae_train: logged epochs {sorted(logged)} or a value not finite")
    # every dump written must parse back; an input song always encodes, while
    # a reconstruction with a note before time 0 cannot be written as MIDI
    # (the writer raises and the loop warns, as the JAX package's Python
    # writer does), so the "_out" files are counted, not required
    recon_dir = os.path.join(workdir, cfg.recon_dir)
    dumps = sorted(os.listdir(recon_dir))
    n_in = sum(name.endswith("_in.mid") for name in dumps)
    if n_in != VAE_EPOCHS * cfg.recon_save_count:
        raise SystemExit(f"vae_train: {n_in} reconstruction inputs written")
    notes_read = sum(len(inst.notes) for name in dumps
                     for inst in read_midi(os.path.join(recon_dir, name)).instruments)
    last = logged[VAE_EPOCHS]
    emit({"phase": "vae_train", "epochs": VAE_EPOCHS, "wall_s": wall,
          "epoch_seconds": [logged[ep]["epoch_seconds"] for ep in sorted(logged)],
          "final": {k: v for k, v in last.items() if k.startswith("loss/")}, "metrics": metrics,
          "recon_in_files": n_in, "recon_out_files": len(dumps) - n_in, "recon_notes_read": notes_read},
         results)
    return {"cfg": cfg, "workdir": workdir, "best": best, "metrics": metrics}


def time_vae_step(torch, np, data, vae, results):
    """``vae_step``, outside any counted path: the step wall, the median of
    10 ``train_step`` calls after a first, each ending in a synchronize,
    against the step's bound (``utils/flops.py::vae_step_flops`` over the
    f32 peak), and a ``torch.profiler`` trace of 3 steps
    (``profile_train.kernel_table``: device time by kernel, kernels and
    device busy share per step)."""
    from melogan_torch.profile_train import kernel_table
    from melogan_torch.train import vae_loop
    from melogan_torch.utils.flops import vae_step_flops

    cfg = vae["cfg"]
    state = vae_loop.init_state(cfg, seed=1, device="cuda")
    x = torch.as_tensor(data["train"].notes_ae(cfg)[: cfg.batch_size], device="cuda")
    walls = []
    for _ in range(VAE_STEPS + 1):
        t1 = time.perf_counter()
        vae_loop.train_step(state, x, cfg.beta, cfg.free_bits)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t1) * 1e3)
    profile = kernel_table(lambda: vae_loop.train_step(state, x, cfg.beta, cfg.free_bits), 3, top=8)
    flops = vae_step_flops(cfg)
    rec = {"phase": "vae_step", "batch": cfg.batch_size, "step_wall_ms_first": walls[0],
           "step_wall_ms": walls[1:], "step_median_ms": float(np.median(walls[1:])), "step_flops": flops,
           "step_bound_ms": flops / PEAK_F32_FLOPS * 1e3, "step_profile": profile}
    emit(rec, results)
    return rec


def seed_vae_resume(data, vae):
    """Before ``vae_resume``'s counted run: a 1-epoch run writes
    ``ae_best.ckpt`` (epoch 1), copied into the resume's fresh workdir."""
    import dataclasses
    import shutil

    from melogan_torch.train import vae_loop

    cfg = vae["cfg"]
    first = os.path.join(WORK_DIR, "vae_first")
    workdir = os.path.join(WORK_DIR, "vae_resume")
    for d in (first, workdir):
        shutil.rmtree(d, ignore_errors=True)
    vae_loop.train(dataclasses.replace(cfg, epochs=1), data["train"], data["val"], workdir=first,
                   verbose=False, recon_dumps=False, device="cuda")
    os.makedirs(os.path.join(workdir, cfg.checkpoint_dir))
    shutil.copy(os.path.join(first, cfg.checkpoint_dir, "ae_best.ckpt"),
                os.path.join(workdir, cfg.checkpoint_dir))
    return workdir


def drive_vae_resume(torch, np, data, vae, workdir, results):
    """``vae_resume``: from the copy of an epoch-1 ``ae_best.ckpt`` in
    ``workdir`` (``seed_vae_resume``), ``train(resume=True)`` runs to epoch
    3 on the card, held against the 3-epoch run of ``vae_train``: whether
    the two are bit for bit equal (the last weights, ``ae_best.ckpt`` and
    the logged losses), and it fails unless every parameter of the last
    state is within 2·lr per update and the best epoch, learning rate,
    plateau and stopper states agree exactly."""
    from melogan_torch.train import vae_loop
    from melogan_torch.utils.checkpoint import load_checkpoint
    from melogan_torch.utils.weights import export_vae

    cfg, straight = vae["cfg"], vae["workdir"]
    t0 = time.perf_counter()
    _, metrics = vae_loop.train(cfg, data["train"], data["val"], workdir=workdir, resume=True,
                                verbose=False, device="cuda")
    wall = time.perf_counter() - t0

    def files(w, name):
        path = os.path.join(w, cfg.checkpoint_dir, name)
        with open(path, "rb") as f:
            return f.read(), load_checkpoint(path)

    (final_a, tree_a), (final_b, tree_b) = files(straight, "ae_final.ckpt"), files(workdir, "ae_final.ckpt")
    (best_a, raw_a), (best_b, raw_b) = files(straight, "ae_best.ckpt"), files(workdir, "ae_best.ckpt")
    for key in ("epoch", "lr", "plateau", "stopper", "best_val"):
        if json.dumps(raw_a[key], default=float) != json.dumps(raw_b[key], default=float):
            raise SystemExit(f"vae_resume: ae_best {key} {raw_a[key]} vs straight {raw_b[key]}")
    updates = (VAE_EPOCHS - 1) * (data["train"].n // cfg.batch_size)
    limit = 2 * cfg.lr * updates * (1 + 1e-3)
    sd_a, sd_b = export_vae(tree_a), export_vae(tree_b)
    worst = max(float(np.abs(sd_a[k].astype(np.float64) - sd_b[k]).max()) for k in sd_a if "running" not in k)
    if not worst <= limit:
        raise SystemExit(f"vae_resume: a parameter differs by {worst:.3e} (limit {limit:.3e})")
    la = {(ep, k): v for ep, d in _logged(os.path.join(straight, cfg.log_dir)).items() if ep > 1
          for k, v in d.items() if k != "epoch_seconds"}
    lb = {(ep, k): v for ep, d in _logged(os.path.join(workdir, cfg.log_dir)).items() if ep > 1
          for k, v in d.items() if k != "epoch_seconds"}
    same_losses = la == lb
    rec = {"phase": "vae_resume", "wall_s": wall, "resumed_from_epoch": 1, "updates": updates,
           "bit_identical": final_a == final_b and best_a == best_b and same_losses,
           "final_bytes_equal": final_a == final_b, "best_bytes_equal": best_a == best_b,
           "same_losses": same_losses, "max_abs_param_diff": worst, "param_limit": limit,
           "best_epoch": int(raw_b["epoch"]), "metrics": metrics}
    emit(rec, results)
    return rec


def drive_encode(torch, np, data, vae, results):
    """``encode``: ``encode_mu`` of the train and val splits on the card
    with the best weights of ``vae_train``, held against the port's CPU path
    on the same weights (1e-4 of scale), written as the
    ``encoder_feats.npy`` files ``configs/gan_conditioning.yaml`` names."""
    from melogan_torch.config import GANConfig
    from melogan_torch.train import vae_loop

    cfg, model = vae["cfg"], vae["best"].model
    cpu = vae_loop.init_state(cfg, device="cpu")
    cpu.model.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    gan_cfg = GANConfig.from_yaml(os.path.join(ROOT, "configs", "gan_conditioning.yaml"))
    paths = {"train": gan_cfg.encoder_feats_train, "val": gan_cfg.encoder_feats_val}
    latents, rec = {}, {"phase": "encode"}
    for name, d in (("train", data["train"]), ("val", data["val"])):
        x = d.notes_ae(cfg)
        t0 = time.perf_counter()
        mu = vae_loop.encode_mu(model, x)
        t1 = time.perf_counter()
        mu_cpu = vae_loop.encode_mu(cpu.model, x)
        t2 = time.perf_counter()
        if mu.shape != (d.n, cfg.latent_dim):
            raise SystemExit(f"encode: {name} latents {mu.shape}")
        err, rel = compare(torch.from_numpy(mu), torch.from_numpy(mu_cpu), f"encode_mu {name}, card vs CPU")
        path = os.path.join(vae["workdir"], paths[name])
        os.makedirs(os.path.dirname(path), exist_ok=True)
        np.save(path, mu)
        latents[name] = mu
        rec[name] = {"rows": d.n, "gpu_s": t1 - t0, "cpu_s": t2 - t1, "max_abs_err": err,
                     "max_rel_err": rel, "mu_std_per_dim": mu.std(axis=0).tolist(),
                     "file": os.path.relpath(path, ROOT)}
    emit(rec, results)
    return latents


def drive_gan_conditioning(torch, np, data, latents, results):
    """``gan_conditioning``: ``gan_loop.train`` with
    ``configs/gan_conditioning.yaml`` and ``configs/ed.yaml`` on the train
    split with the exported µ as the AE latents, 1 epoch on the card (one
    group step and no tail: 5 batches of 32); then ``create_server`` with
    that YAML path, which serves the run's ``gan_final.ckpt``, answering one
    ``POST /generate`` and ``GET /healthz``."""
    import shutil

    from melogan_torch.config import EDConfig, GANConfig
    from melogan_torch.serving.app import create_server
    from melogan_torch.train.gan_loop import train

    cfg_path = os.path.join(ROOT, "configs", "gan_conditioning.yaml")
    cfg = GANConfig.from_yaml(cfg_path)
    ed_cfg = EDConfig.from_yaml(os.path.join(ROOT, "configs", "ed.yaml"))
    workdir = os.path.join(WORK_DIR, "gan_conditioning")
    shutil.rmtree(workdir, ignore_errors=True)
    t0 = time.perf_counter()
    state, hist = train(cfg, ed_cfg, data["train"], latents=latents["train"], workdir=workdir, epochs=1,
                        verbose=False, device="cuda")
    wall = time.perf_counter() - t0
    if state.step < 1 or not all(np.isfinite(v) for v in hist.values()):
        raise SystemExit(f"gan_conditioning: step {state.step}, history {hist}")
    httpd, app_state = create_server("127.0.0.1", 0, workdir=workdir, config=cfg_path, device="cuda")
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        base = f"http://127.0.0.1:{httpd.server_address[1]}"
        status, body = http(base, "/generate", json.dumps({"emotion": "calm"}).encode())
        if status != 200 or body[:4] != b"MThd":
            raise SystemExit(f"/generate with {cfg_path}: status {status}")
        status, body = http(base, "/healthz")
        health = json.loads(body)
        if (status != 200 or health["generator"] != "checkpoint"
                or app_state.cfg.integration_mode != "conditioning"):
            raise SystemExit(f"/healthz with {cfg_path}: {status} {health}")
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=30)
    emit({"phase": "gan_conditioning", "epochs": 1, "group_steps": state.step, "wall_s": wall,
          "history": hist, "served": os.path.relpath(app_state.ckpt_path, ROOT), "healthz": health},
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
    import numpy as np

    from melogan_torch.ops import conv, conv1d

    ops = {"convt": convt, "decoder": decoder, "conv1d": conv1d, "conv": conv}
    wrappers = {"decoder_tail": decoder.decoder_tail_cuda, "convt1d": convt.convt1d_cuda,
                "conv1d": conv1d.conv1d_cuda}
    gen = torch.Generator(device="cuda").manual_seed(0)
    dec, cvt, c1d = {}, {}, {}
    for b, m in DECODER_CASES:
        dec[b, m] = check_decoder(torch, F, ops, b, m, gen, results)
    for b in CONVT_BATCHES:
        cvt[b] = check_convt(torch, F, ops, b, gen, results)
    for b in CONV1D_BATCHES:
        c1d[b] = check_conv1d(torch, F, ops, b, gen, results)
    check_backward_routes(torch, F, ops, TRAIN_BATCH, gen, results)
    vae_kernels = check_vae_kernels(torch, F, ops, gen, results)

    def drive(path, fn, need):
        """Run one main path with every launch count at 0; its counts."""
        for w in wrappers.values():
            w.launches = 0
        out = fn()
        counts = {k: w.launches for k, w in wrappers.items()}
        emit({"phase": "main_path_launches", "path": path, **counts}, results)
        missing = [k for k in need if counts[k] <= 0]
        if missing:
            raise SystemExit(f"{path} path never launched: {missing}")
        return out, counts

    samplers, sampling = drive("sampling", lambda: drive_main_path(torch, results),
                               ("decoder_tail", "convt1d"))
    check_against_cpu(torch, samplers, results)
    trained, training = drive("training", lambda: drive_training_path(torch, np, results),
                              ("conv1d", "convt1d", "decoder_tail"))
    check_checkpoint_files(np, trained, results)
    _, resuming = drive("resume", lambda: drive_resume(torch, trained, results),
                        ("conv1d", "convt1d"))
    _, serving = drive("serve_ckpt", lambda: drive_serve_ckpt(torch, trained, results),
                       ("decoder_tail",))
    probe_determinism(torch, np, results)
    step = time_group_step(torch, np, results)
    check_group_step_against_cpu(torch, np, results)
    # Stage 1 from disk: corpus → VAE → µ → the conditioning-mode GAN
    data, loading = drive("data", lambda: drive_data(np, results), ())
    vae, vae_training = drive("vae_train", lambda: drive_vae_train(torch, np, data, results),
                              ("conv1d", "convt1d"))
    vae_step = time_vae_step(torch, np, data, vae, results)
    resume_dir = seed_vae_resume(data, vae)
    _, vae_resuming = drive("vae_resume",
                            lambda: drive_vae_resume(torch, np, data, vae, resume_dir, results),
                            ("conv1d", "convt1d"))
    latents, encoding = drive("encode", lambda: drive_encode(torch, np, data, vae, results), ("conv1d",))
    _, conditioning = drive("gan_conditioning",
                            lambda: drive_gan_conditioning(torch, np, data, latents, results),
                            ("conv1d", "convt1d", "decoder_tail"))
    paths = (sampling, training, resuming, serving, loading, vae_training, vae_resuming, encoding,
             conditioning)
    launches = {k: sum(p[k] for p in paths) for k in wrappers}

    big_d, big_c = dec[MAIN_BATCH, 64], cvt[CONVT_BATCHES[-1]]  # batch 4096
    ed32 = [r for r in c1d[TRAIN_BATCH] if r["layer"].startswith("ed")]

    def summed(name, recs, **extra):
        """One kernels-line entry over several layers (times and bounds summed)."""
        return {
            "name": name, "route": "cuda", **extra,
            "launches": launches[name],
            "ms": sum(r["kernel_ms"] for r in recs),
            "plain_ms": sum(r["plain_ms"] for r in recs),
            "bound_ms": sum(r["bound_ms"] for r in recs),
            "bound_by": ("operations" if sum(r["ops_ms"] for r in recs)
                         >= sum(r["bytes_ms"] for r in recs) else "bytes"),
            "library_ms": sum(r["library_ms"] for r in recs),
        }

    kernels = [
        {
            "name": "decoder_tail", "route": "cuda",
            "source": "melogan_torch/csrc/decoder_tail.cu",
            "replaces": "melogan_tpu/ops/pallas/decoder.py:73",
            "launches": launches["decoder_tail"],
            "device_launches_per_call": min(r["device_launches_per_call"] for r in dec.values()),
            "max_abs_err": max(r["max_abs_err"] for r in dec.values()),
            "ms": big_d["kernel_ms"], "plain_ms": big_d["plain_ms"],
            "bound_ms": big_d["bound_ms"], "bound_by": big_d["bound_by"],
            "library_ms": big_d["library_ms"],
        },
        # the three layers of the layered decoder tail at batch 4096, summed
        summed("convt1d", big_c, source="melogan_torch/csrc/convt1d.cu",
               replaces="melogan_tpu/ops/pallas/conv1d.py:140",
               max_abs_err=max(r["max_abs_err"] for b in CONVT_BATCHES for r in cvt[b])),
        # the ED's four layers at the training batch (32), summed
        summed("conv1d", ed32, source="melogan_torch/csrc/conv1d.cu",
               replaces="melogan_tpu/ops/pallas/conv1d.py:64",
               max_abs_err=max(r["max_abs_err"] for b in CONV1D_BATCHES for r in c1d[b])),
    ]
    emit({"phase": "summary", "group_steps_per_s": step["group_steps_per_s"],
          "group_step_median_ms": step["median_ms"], "group_step_bound_ms": step["bound_ms"],
          "vae_step_median_ms": vae_step["step_median_ms"], "vae_step_bound_ms": vae_step["step_bound_ms"],
          "vae_conv1d_b32_ms": sum(r["kernel_ms"] for r in vae_kernels["conv1d"] if r["batch"] == 32),
          "vae_convt1d_b32_ms": sum(r["kernel_ms"] for r in vae_kernels["convt1d"] if r["batch"] == 32),
          "launches_by_path": dict(zip(("sampling", "training", "resume", "serve_ckpt", "data", "vae_train",
                                        "vae_resume", "encode", "gan_conditioning"), paths))},
         results)
    line = {"kernels": kernels}
    results.append(line)
    os.makedirs(WORK_DIR, exist_ok=True)
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
