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
12. Stage 2 and serving, each path with the counts set to 0 first:
    ``ed_train`` (``ed_loop.train`` with ``configs/ed.yaml``, batch 64, for
    4 epochs with ``save_freq`` 2 on the data phase's splits; its
    ``conv1d`` and ``convt1d`` counts must equal ``ed_counts``' prediction),
    ``ed_resume`` (from a copy of a 2-epoch run's ``ed_epoch0002.ckpt``,
    made before the counts are set to 0, to epoch 4; it must be bit for bit
    the straight run), ``judge`` (``train_judge`` on val with test as its
    validation, ``judge_notes`` on the real test rows, ``evaluate`` on the
    card against the CPU), ``gan_with_ed`` (``configs/gan.yaml`` with
    λ_fm = 10 for 1 epoch against the ED that ``ed_train`` wrote, then
    ``judge_generated`` of its ``gan_final.ckpt``) and ``serve_reload``
    (``create_server`` with the sample pool and ``watch_ckpt``: ``POST
    /generate`` from the pool, ``POST /reload`` of ``gan_with_ed``'s
    checkpoint serving its weights bit for bit, ``/metrics``, and the
    watcher swapping in a replaced file); before them, ``kernels_ed``
    holds ``conv1d`` at the ED's four layers and the three input-gradient
    launches of a step (``convt1d``) at batch 64 against their plain
    versions, timed beside the library calls; between ``ed_train`` and
    ``ed_resume``, outside any counted path, ``ed_step`` times the median
    wall of 10 ED training steps and traces 3;
13. the population sweep on the training phase's corpus and config, each
    path with the counts set to 0 first and checked against
    ``sweep_counts``' prediction: ``sweep`` (``sweep_gan`` of 4 members,
    seeds ``cfg.seed`` to ``cfg.seed + 3`` with ``SWEEP_GRID``, 2 epochs,
    ``promote_best``; each member-epoch, gate and state write timed; after
    the window, member 0 read back from ``sweep_state.ckpt`` must equal the
    ``training`` phase's state bit for bit, and every member's
    ``gan_final.ckpt`` must sample finite notes), ``sweep_resume`` (the
    same sweep for 1 epoch, seeded before the counts are set to 0, resumed
    to 2: it must be ``sweep`` bit for bit) and ``sweep_halving`` (rungs of
    1 epoch for 3 epochs: 4 → 2 → 1 members); between them, outside any
    counted path, ``sweep_state`` reads the file's size, its load and save
    seconds and those of ``load_sweep_state``/``export_sweep_state``;
14. the bf16 slice: before the paths, ``kernels_bf16`` holds both conv
    kernels' one-pass bf16 mode against their plain versions
    (``bf16=True``) at the decoder's, the ED's and the VAE's layers and as
    each other's input gradient at batch 32, timed beside the f32 mode and
    cuDNN on bf16 tensors, bounds at 495 TFLOP/s; every earlier path must
    show no bf16-mode launch (``main_path_launches_bf16``, a line a path);
    then, each with the counts set to 0 first, ``sampling_fast``
    (``Sampler(fast_math=True)`` at batch 1 and 4096: three ``convt1d``
    launches in bf16 mode a call, no ``decoder_tail``; a
    ``create_server(fast_math=True)`` answering three ``POST /generate``
    whose MIDI parses), ``training_bf16`` (``gan_loop.train`` for 1 epoch,
    ``vae_loop.train`` for 3 and ``ed_loop.train`` for 4 at
    ``precision="bf16"``: every launch in bf16 mode, as many as the f32
    runs of the same shape) and ``spectral`` (a sampler with a
    spectral-norm encoder against the CPU path); between them, outside the
    counted windows, ``fast_vs_f32`` (the fast notes against the card's f32
    sampler and the CPU's fast path; the f32 walls) and ``bf16_steps``
    (group, VAE and ED steps at f32 and bf16 in turns);
15. the command line, each path with the counts set to 0 first and held
    to ``cli_counts``' prediction from the split sizes: ``cli_pipeline``
    (``melogan_torch.cli.main(["pipeline", ...])`` in this process at the
    shipped widths, ``configs/ae_freebits.yaml``, ``ed.yaml`` and
    ``gan.yaml``, 96 synthetic songs an emotion, 6 epochs of each trainer,
    ``--gan-fm 10 --gan-track-best``; every stage's wall from
    ``pipeline_timings.json``), ``cli_resume`` (the same argv with
    ``--resume``: every stage skips and nothing launches; then, with
    train-gan's completion marker deleted, train-gan resumes from
    ``gan_epoch0005.ckpt`` and the sample stage runs again),
    ``cli_commands`` (``sample``, ``eval-gen`` with JAX's report keys,
    ``quality-gate --no-strict`` at both tiers, ``export-checkpoint`` then
    ``import-checkpoint`` giving back the G and E_num leaves, ``profile``
    and ``doctor`` reporting the card OK) and ``cli_module`` (``python -m
    melogan_torch sample`` and ``serve`` as child processes: ``/healthz``
    on the gpu platform, one ``POST /generate``, SIGINT, exit 0; the
    children's launches are not counted here);
16. the text path, each phase with the counts set to 0 first: ``text_mlp``
    (the shipped recipe, 150 epochs of 106 AdamW steps, trained on the
    card; its accuracy against the lexicon's on the 1,620 eval sentences,
    which must beat it on overall and macro accuracy and equal
    ``MEASURED_EVAL_ACCURACY`` to 3 decimals; two 2-epoch trainings
    bitwise equal; the host/device split of one request), ``roberta`` (a
    random roberta-base-width checkpoint written as ``model.safetensors``
    and ``pytorch_model.bin`` and loaded both ways, equal; the card's
    logits against the CPU's; one ``__call__`` at B=1 in the 16, 64 and
    512 buckets; the forward at B=64, T=128 beside its bound),
    ``text_route`` (the server with the text-mlp backend, then the
    roberta one: ``POST /get_text_emotion`` then ``POST /generate`` with the
    answer for one text an emotion, valid MIDI each time, 9
    ``decoder_tail`` launches; /healthz's text fields) and
    ``cli_text_eval`` (``python -m melogan_torch text-eval --json
    --ceiling`` in a child process: JAX's report keys);
17. the camera path, each phase with the counts set to 0 first:
    ``camera_models`` (the res10 SSD at 300×300 on the card against the
    CPU within 1e-5 of scale, with seeded weights and with the crafted
    brightness detector written as a ``.caffemodel`` by the port's writer
    and read back, which must find the bright square of a 240×320 frame;
    ``detect()``'s median split into resize + forward, device→host copy and
    host NMS, and a ``torch.profiler`` trace of it; the SSD forward at B=1
    and 8 beside its bound, 2.249 GFLOP a frame at 67 TFLOP/s; the
    mini-Xception FER at B=1 and 64 against the CPU, timed; ``CameraEmotion``
    with both on the card against the CPU; the native JPEG encoder built
    with g++, byte-equal to the Python encoder, both timed on a 320×240
    frame; no kernel of the port launches) and ``camera_route``
    (``create_server(camera_source="synthetic")`` with a random FER
    injected: ``POST /camera_frame`` of a 96×96 frame, ``GET
    /get_camera_emotion`` equal to its answer, ``POST /generate`` with it,
    whose MIDI must parse, 8 times; ``GET /video_feed`` read for 10 parts
    (SOI…EOI each, frames/s under the 20 fps cap, the camera emotion set);
    ``/healthz``'s camera fields on the gpu platform; a second server on a
    ``.y4m`` file written by ``write_y4m``, read past the clip's end; 10
    ``decoder_tail`` launches, the two warm-ups and the 8 ``/generate``,
    and no ``conv1d`` or ``convt1d``);
18. data parallelism (``melogan_torch/parallel``), each phase with the
    counts set to 0 first: ``dp_train`` (``dp_program``: a ``GANConfig()``
    group step from a critic away from its init with given draws, 5 timed
    group steps, a one-step epoch of ``vae_loop.train`` and of
    ``ed_loop.train`` at the shipped widths, run plain, then on one NCCL rank in this process,
    ``--dp 1``, which must be bit for bit the plain run, as must a
    ``gan_loop.train`` epoch at ``--dp 1``; then on two gloo ranks sharing
    the card, held against the plain run with the tolerances of
    ``tests/test_torch_parallel.py``, Adam's first moments of every module
    included; every rank must launch the plain
    run's kernels; the step walls, the bytes the all-reduce carries and its
    share of two traced steps on the gloo ranks), ``dp_sample``
    (``Sampler(mesh=make_mesh(1))`` at batch 1, 4096 and 4095 bit for bit
    the plain sampler, and a sampler over two shards of the one card within
    ``DP_SAMPLE_ATOL``, one ``decoder_tail`` launch a non-empty block;
    ``create_server(dp=1)`` answering four ``POST /generate`` and
    ``/healthz``; 16 ``decoder_tail`` launches) and ``dp_cli``
    (``train-gan --dp 1`` through the command line in this process, its
    ``gan_final.ckpt`` bit for bit that of ``train-gan``; ``python -m
    melogan_torch train-gan --dp 2`` in a child exits non-zero with
    ``make_mesh``'s "asked for 2 devices, have 1" before any work);
19. tensor parallelism (``melogan_torch/parallel/tensor.py``): ``kernels_tp``
    (``convt1d`` and ``conv1d`` at the shard shapes of a split group step
    at batch 32, the decoder's stage 1 with 128 input channels a rank and
    the ED's blocks 3 and 4 with 128 output and input channels, and both
    input-gradient routes there, against their plain versions and timed)
    and ``tp_train`` (``tp_program``: a ``GANConfig()`` group step and a
    two-batch tail from a perturbed critic with given draws, plain in this
    process and on two gloo ranks sharing the card at (data 1, model 2),
    the state split by JAX's rule at min_dim 256; the metrics at JAX's TP
    tolerances, Adam's first moments after the group step within 1e-4 of
    their group's largest, parameters after the tail within 2·lr per
    update, replicated tensors bit-equal across the ranks; each rank's launches as ``tp_counts`` predicts, added to the
    path's; the step walls, the bytes the collectives carry a group step
    and the ``tp.all_reduce`` spans' share of a traced step);
20. the last two entry points: ``decoder_tail`` at the benchmark's batch
    of 65536 against its plain version (outside any counted path), then,
    each with the counts set to 0 first, ``bench`` (``python -m
    melogan_torch bench`` through ``cli.main`` in this process: every key
    of the root ``bench.py``'s line, read with ``ast``, and
    ``power_limit``; the rates positive, p50 ≤ p90 ≤ p99, every share of
    the bf16 peak at most 100, this card's name and count, the dp keys null
    on one card; all three kernels and both conv kernels' bf16 mode
    launched) and ``fault_inject`` (``melogan_torch.fault_inject.main``,
    one trial with seed 3: the pipeline in a child on the card, killed
    before it completes, resumed, every ``.mid`` and ``gan_final.ckpt``
    leaf equal to the uninterrupted run's; the reference wall and the
    stage the kill landed in; the children's launches are their own);
21. prints the per-mode launch counts (``launches_by_mode``), the
    script's wall, the ``kernels`` JSON line (launches summed over every
    driven path; the bf16 mode of each conv kernel as an entry of its own),
    the nvidia-smi line, and last ``{"ok": true, "device": {...}}``.

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
# the ED trainer (configs/ed.yaml: batch 64) on the data phase's splits: 180 train rows give 2
# steps an epoch, 40 val rows one validation batch
ED_BATCH = 64
ED_EPOCHS = 4
ED_SAVE_FREQ = 2
ED_STEPS = 10  # timed ED training steps after a first
JUDGE_EPOCHS = 4
# input gradients of ED blocks 2-4 (block 1's input is data and takes none)
ED_BACKWARD = [((l, cin, cout, k, s, p, 0), False, n) for l, cin, cout, k, s, p, n in ED_LAYERS[1:]]
CORPUS_ROWS = 384  # batch 32: 12 batches, 2 groups of 5 and a 2-batch tail per epoch
# the population sweep (train/sweep.py) on the training phase's corpus and config: four
# members, the first the training phase's own run, two more seeds, a learning rate and a
# loss weight of their own
SWEEP_EPOCHS = 2
SWEEP_GRID = [{}, {}, {"lr_g": 1e-4}, {"lambda_emotion": 0.5}]
HALVING_EPOCHS = 3  # rungs of 1 epoch: 4 members, then 2, then the winner alone
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


def compare(out, ref, what, tol=TOL_REL):
    err = float((out - ref).abs().max())
    scale = float(ref.abs().max())
    if not (err <= tol * max(scale, 1e-30)) or not bool(out.isfinite().all()):
        raise SystemExit(f"{what}: max abs err {err:.3e} exceeds {tol} x scale {scale:.3e}")
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
                                  device="cuda", sample_pool=False)
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
                                 use_ema=True, device="cuda", sample_pool=False)
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
    the scaler), ``create_splits`` and ``load_split`` of train, val and
    test, each step's seconds on the host clock."""
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
            for name in ("train", "val", "test")}
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
    httpd, app_state = create_server("127.0.0.1", 0, workdir=workdir, config=cfg_path, device="cuda",
                                     sample_pool=False)
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


def check_ed_kernels(torch, F, ops, gen, results):
    """``kernels_ed``: ``conv1d`` at the ED's four layers at the ED
    trainer's batch (64), and the three input-gradient launches of a step
    (blocks 2-4, on ``convt1d``), each against its plain version, timed
    beside ``F.conv1d`` / ``conv1d_input`` with TF32 off, bounds at
    3xTF32."""
    fwd = check_conv1d(torch, F, ops, ED_BATCH, gen, results, ED_LAYERS, "kernels_ed")
    back = check_backward_routes(torch, F, ops, ED_BATCH, gen, results, ED_BACKWARD, "kernels_ed_backward")
    summary = {"phase": "kernels_ed_summary", "batch": ED_BATCH,
               "conv1d_4_layers": {k: sum(r[k] for r in fwd) for k in ("kernel_ms", "plain_ms", "library_ms",
                                                                        "bound_ms", "flops")},
               "convt1d_dx_3_layers": {k: sum(r[k] for r in back) for k in ("dx_kernel_ms", "dx_plain_ms",
                                                                            "dx_library_ms", "bound_ms",
                                                                            "flops")}}
    emit(summary, results)
    return fwd, back


def _ed_cfg():
    import dataclasses

    from melogan_torch.config import EDConfig

    cfg = EDConfig.from_yaml(os.path.join(ROOT, "configs", "ed.yaml"))
    if cfg.batch_size != ED_BATCH:
        raise SystemExit(f"configs/ed.yaml: batch {cfg.batch_size}, expected {ED_BATCH}")
    return dataclasses.replace(cfg, num_epochs=ED_EPOCHS, save_freq=ED_SAVE_FREQ)


def ed_counts(data):
    """The launches ``ed_train`` must show (``ed_launches``)."""
    n_train, n_val = data["train"].n, data["val"].n
    return {**ed_launches(ED_BATCH, n_train, n_val, ED_EPOCHS),
            "steps_per_epoch": _batches(n_train, ED_BATCH), "val_batches": _batches(n_val, ED_BATCH)}


def drive_ed_train(torch, np, data, results):
    """``ed_train``: ``ed_loop.train`` with ``configs/ed.yaml`` (full width,
    batch 64) for 4 epochs with ``save_freq`` 2 on the card, in a fresh
    workdir: the epochs logged, ``ed_epoch0002.ckpt``, ``ed_epoch0004.ckpt``
    and ``ed_best.ckpt`` written."""
    import shutil

    from melogan_torch.train import ed_loop

    cfg = _ed_cfg()
    workdir = os.path.join(WORK_DIR, "ed")
    shutil.rmtree(workdir, ignore_errors=True)
    t0 = time.perf_counter()
    best, metrics = ed_loop.train(cfg, data["train"], data["val"], workdir=workdir, verbose=False,
                                  device="cuda")
    wall = time.perf_counter() - t0
    logged = _logged(os.path.join(workdir, cfg.log_dir))
    files = sorted(os.listdir(os.path.join(workdir, cfg.checkpoint_dir)))
    if sorted(logged) != list(range(1, ED_EPOCHS + 1)) or not all(
            np.isfinite(v) for ep in logged.values() for v in ep.values()):
        raise SystemExit(f"ed_train: logged epochs {sorted(logged)} or a value not finite")
    if files != ["ed_best.ckpt", "ed_epoch0002.ckpt", "ed_epoch0004.ckpt"]:
        raise SystemExit(f"ed_train: checkpoints {files}")
    emit({"phase": "ed_train", "epochs": ED_EPOCHS, "wall_s": wall,
          "epoch_seconds": [logged[ep]["epoch_seconds"] for ep in sorted(logged)],
          "val_loss": [logged[ep]["loss/val"] for ep in sorted(logged)],
          "val_acc": [logged[ep]["acc/val"] for ep in sorted(logged)], "best": metrics, "files": files},
         results)
    return {"cfg": cfg, "workdir": workdir, "best": best, "metrics": metrics}


def time_ed_step(torch, np, data, results):
    """``ed_step``, outside any counted path: the step wall, the median of
    10 ``train_step`` calls after a first, each ending in a synchronize,
    against the step's bound (``utils/flops.py::ed_step_flops`` over the f32
    peak), and a ``torch.profiler`` trace of 3 steps (device ms, kernels
    and ``cudaLaunchKernel`` calls a step)."""
    from melogan_torch.ops import conv1d, convt
    from melogan_torch.profile_train import kernel_table
    from melogan_torch.train import ed_loop
    from melogan_torch.utils.flops import ed_step_flops

    cfg = _ed_cfg()
    state = ed_loop.init_state(cfg, seed=1, device="cuda")
    x = torch.as_tensor(data["train"].notes_gan()[:ED_BATCH], device="cuda")
    y = torch.as_tensor(data["train"].emotion_idx[:ED_BATCH].astype(np.int64), device="cuda")
    walls = []
    for i in range(ED_STEPS + 1):
        if i == 1:
            c1, ct = conv1d.conv1d_cuda.launches, convt.convt1d_cuda.launches
        t1 = time.perf_counter()
        ed_loop.train_step(state, x, y)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t1) * 1e3)
    per_step = {"conv1d": (conv1d.conv1d_cuda.launches - c1) / ED_STEPS,
                "convt1d": (convt.convt1d_cuda.launches - ct) / ED_STEPS}
    profile = kernel_table(lambda: ed_loop.train_step(state, x, y), 3, top=10)
    launch_calls = sum(r["calls"] for r in profile["host_top"] if r["name"].startswith("cudaLaunchKernel"))
    flops = ed_step_flops(cfg, ED_BATCH)
    rec = {"phase": "ed_step", "batch": ED_BATCH, "step_wall_ms_first": walls[0], "step_wall_ms": walls[1:],
           "step_median_ms": float(np.median(walls[1:])), "step_flops": flops,
           "step_bound_ms": flops / PEAK_F32_FLOPS * 1e3, "launches_per_step": per_step,
           "cuda_launch_kernel_calls_per_step": launch_calls / 3, "step_profile": profile}
    emit(rec, results)
    return rec


def seed_ed_resume(data, ed):
    """Before ``ed_resume``'s counted run: a 2-epoch run writes
    ``ed_epoch0002.ckpt``, copied into the resume's fresh workdir."""
    import dataclasses
    import shutil

    from melogan_torch.train import ed_loop

    cfg = ed["cfg"]
    first = os.path.join(WORK_DIR, "ed_first")
    workdir = os.path.join(WORK_DIR, "ed_resume")
    for d in (first, workdir):
        shutil.rmtree(d, ignore_errors=True)
    ed_loop.train(dataclasses.replace(cfg, num_epochs=ED_SAVE_FREQ), data["train"], data["val"],
                  workdir=first, verbose=False, device="cuda")
    os.makedirs(os.path.join(workdir, cfg.checkpoint_dir))
    shutil.copy(os.path.join(first, cfg.checkpoint_dir, f"ed_epoch{ED_SAVE_FREQ:04d}.ckpt"),
                os.path.join(workdir, cfg.checkpoint_dir))
    return workdir


def drive_ed_resume(torch, np, data, ed, workdir, results):
    """``ed_resume``: from the copy of ``ed_epoch0002.ckpt`` in ``workdir``
    (``seed_ed_resume``), ``train(resume=True)`` runs to epoch 4 on the
    card; it must be bit for bit the 4-epoch run of ``ed_train``:
    ``ed_epoch0004.ckpt`` byte for byte and the logged losses, accuracies
    and learning rates of epochs 3 and 4 equal."""
    from melogan_torch.train import ed_loop

    cfg, straight = ed["cfg"], ed["workdir"]
    t0 = time.perf_counter()
    _, metrics = ed_loop.train(cfg, data["train"], data["val"], workdir=workdir, resume=True,
                               verbose=False, device="cuda")
    wall = time.perf_counter() - t0
    name = f"ed_epoch{ED_EPOCHS:04d}.ckpt"
    a, b = (open(os.path.join(w, cfg.checkpoint_dir, name), "rb").read() for w in (straight, workdir))

    def logged(w):
        return {(ep, k): v for ep, d in _logged(os.path.join(w, cfg.log_dir)).items() if ep > ED_SAVE_FREQ
                for k, v in d.items() if k != "epoch_seconds"}

    same_logs = logged(straight) == logged(workdir)
    rec = {"phase": "ed_resume", "wall_s": wall, "resumed_from_epoch": ED_SAVE_FREQ,
           "bit_identical": a == b and same_logs, "last_ckpt_bytes_equal": a == b,
           "same_logs": same_logs, "metrics": metrics}
    emit(rec, results)
    if not rec["bit_identical"]:
        raise SystemExit(f"ed_resume: not bit-identical to the straight run ({rec})")
    return rec


def drive_judge(torch, np, data, ed, results):
    """``judge``: ``train_judge`` on the val split with the test split as
    its validation (``JUDGE_EPOCHS``), ``judge_notes`` on the real test
    rows (the calibration report), and ``evaluate`` of the test split on
    the card against the port's CPU path on the same weights (loss 1e-4 of
    scale, the confusion matrix equal)."""
    import copy
    import shutil

    from melogan_torch.diagnostics import judge
    from melogan_torch.train import ed_loop

    workdir = os.path.join(WORK_DIR, "judge")
    shutil.rmtree(workdir, ignore_errors=True)
    t0 = time.perf_counter()
    jcfg, state = judge.train_judge(ed["cfg"], data["val"], data["test"], workdir=workdir,
                                    epochs=JUDGE_EPOCHS, device="cuda")
    wall = time.perf_counter() - t0
    real = judge.judge_notes(jcfg, state, data["test"].notes_gan(), data["test"].emotion_idx)
    on_card = ed_loop.evaluate(jcfg, state, data["test"])
    cpu = ed_loop.init_state(jcfg, model=copy.deepcopy(state.model).cpu(), device="cpu")
    on_cpu = ed_loop.evaluate(jcfg, cpu, data["test"])
    if (abs(on_card["loss"] - on_cpu["loss"]) > 1e-4 * abs(on_cpu["loss"])
            or on_card["confusion"] != on_cpu["confusion"] or real["n"] != data["test"].n):
        raise SystemExit(f"judge: evaluate on the card {on_card} vs the CPU {on_cpu}")
    emit({"phase": "judge", "epochs": JUDGE_EPOCHS, "train_s": wall, "judge_real": real,
          "evaluate_card": on_card, "evaluate_cpu_loss": on_cpu["loss"]}, results)
    return {"cfg": jcfg, "state": state, "real": real}


def drive_gan_with_ed(torch, np, data, ed, judged, results):
    """``gan_with_ed``: ``gan_loop.train`` with ``configs/gan.yaml`` (the
    warm start) and λ_fm = 10 (the round-5 fm9 setting, RESULTS.md), the
    frozen ED being the ``ed_best.ckpt`` that ``ed_train`` wrote, 1 epoch on
    the train split (one group step); then ``judge_generated`` of 8 fresh
    samples an emotion from its ``gan_final.ckpt``."""
    import dataclasses
    import shutil

    from melogan_torch.config import GANConfig
    from melogan_torch.diagnostics import judge
    from melogan_torch.sampling import Sampler
    from melogan_torch.train.gan_loop import train
    from melogan_torch.utils.checkpoint import load_checkpoint
    from melogan_torch.utils.weights import export_ed, load_gan_final_full

    raw = load_checkpoint(os.path.join(ed["workdir"], ed["cfg"].checkpoint_dir, "ed_best.ckpt"))
    ed_sd = export_ed({"params": raw["params"], "batch_stats": raw["batch_stats"]})
    cfg = dataclasses.replace(GANConfig.from_yaml(os.path.join(ROOT, "configs", "gan.yaml")), lambda_fm=10.0)
    workdir = os.path.join(WORK_DIR, "gan_with_ed")
    shutil.rmtree(workdir, ignore_errors=True)
    t0 = time.perf_counter()
    state, hist = train(cfg, ed["cfg"], data["train"], ed_variables=ed_sd, workdir=workdir, epochs=1,
                        verbose=False, device="cuda")
    wall = time.perf_counter() - t0
    if state.step < 1 or not all(np.isfinite(v) for v in hist.values()) or "Loss/Generator_FM" not in hist:
        raise SystemExit(f"gan_with_ed: step {state.step}, history {hist}")
    final = os.path.join(workdir, cfg.checkpoint_dir, "gan_final.ckpt")
    gen_sd, fe_sd, extras = load_gan_final_full(final)
    sampler = Sampler(cfg, gen_variables=gen_sd, fe_variables=fe_sd, emotion_features=extras["emotion_features"],
                      device="cuda")
    report = judge.judge_generated(judged["cfg"], judged["state"], sampler, n_per_emotion=8, seed=1234)
    if report["n"] != 32 or sum(map(sum, report["confusion"])) != 32:
        raise SystemExit(f"gan_with_ed: judge report {report}")
    emit({"phase": "gan_with_ed", "epochs": 1, "group_steps": state.step, "wall_s": wall, "history": hist,
          "ed_best_epoch": int(raw["epoch"]), "judge_generated": report,
          "checkpoint": os.path.relpath(final, ROOT)}, results)
    return {"cfg": cfg, "final": final}


def drive_serve_reload(torch, np, gan, trained, results):
    """``serve_reload``: ``create_server`` with ``configs/gan.yaml``, the
    sample pool (prefilled, its refill ladder warmed in the background) and
    ``watch_ckpt``, on a path that holds no checkpoint (random weights);
    four ``POST /generate`` from the pool; ``POST /reload`` of a copy of
    ``gan_with_ed``'s ``gan_final.ckpt`` (200, pooled samples flushed, the
    copy now the path served and watched), then ``/generate``; ``/metrics``
    counts the reload; then the copy is replaced on disk by the training
    phase's ``gan_final.ckpt`` and the watcher must swap it in within 30 s.
    The server, its pool and its watcher are stopped at the end.

    Only the server's own work runs here, inside the counted window. After
    each swap the served sampler is snapshotted (a shallow copy keeps the
    modules it serves at that moment, and launches nothing);
    ``check_served_weights`` samples the snapshots after the window. Every
    ``Sampler.sample_notes`` call the server makes is counted, so that the
    phase's ``decoder_tail`` launches can be held to it."""
    import copy
    import shutil

    from melogan_torch import EMOTIONS
    from melogan_torch.sampling import Sampler
    from melogan_torch.serving.app import create_server

    workdir = os.path.join(WORK_DIR, "serve_reload")
    shutil.rmtree(workdir, ignore_errors=True)
    os.makedirs(workdir)
    served = os.path.join(workdir, "served.ckpt")
    cfg_path = os.path.join(ROOT, "configs", "gan.yaml")
    calls = []  # the batch of every sample_notes call the server makes
    original = Sampler.sample_notes

    def counted(self, emotions, seed=0):
        calls.append(len(emotions))
        return original(self, emotions, seed=seed)

    Sampler.sample_notes = counted
    try:
        t0 = time.perf_counter()
        httpd, state = create_server("127.0.0.1", 0, config=cfg_path, checkpoint=served, device="cuda",
                                     watch_ckpt=0.1)
        startup = time.perf_counter() - t0
        thread = threading.Thread(target=httpd.serve_forever, daemon=True)
        thread.start()
        rec = {"phase": "serve_reload", "startup_s": startup}
        try:
            base = f"http://127.0.0.1:{httpd.server_address[1]}"
            for emotion in EMOTIONS:
                status, body = http(base, "/generate", json.dumps({"emotion": emotion}).encode())
                if status != 200 or body[:4] != b"MThd":
                    raise SystemExit(f"/generate {emotion} from the pool: status {status}")
            health = json.loads(http(base, "/healthz")[1])
            if health["generator"] != "random-weights" or health["sample_pool"]["hits"] < 1:
                raise SystemExit(f"serve_reload /healthz before the reload: {health}")
            reloaded = os.path.join(workdir, "reloaded.ckpt")
            shutil.copy(gan["final"], reloaded)
            t1 = time.perf_counter()
            status, body = http(base, "/reload", json.dumps({"checkpoint": reloaded}).encode())
            reload_s = time.perf_counter() - t1
            answer = json.loads(body)
            if status != 200 or answer["flushed_pool_samples"] < 1 or state.ckpt_path != reloaded:
                raise SystemExit(f"/reload: {status} {answer}")
            after_reload = copy.copy(state.sampler)
            status, body = http(base, "/generate", json.dumps({"emotion": "sad"}).encode())
            if status != 200 or body[:4] != b"MThd":
                raise SystemExit(f"/generate after /reload: status {status}")
            metrics = http(base, "/metrics")[1].decode()
            if "melogan_reloads_total 1" not in metrics:
                raise SystemExit("serve_reload: /metrics does not count the reload")
            # the watcher: replace the served file on disk with another checkpoint
            before = state.loaded_version
            swapped_in = os.path.join(trained["workdir"], trained["cfg"].checkpoint_dir, "gan_final.ckpt")
            incoming = os.path.join(workdir, "incoming.ckpt")
            shutil.copy(swapped_in, incoming)
            os.utime(incoming, (before[1] + 10, before[1] + 10))
            os.replace(incoming, reloaded)
            t2 = time.perf_counter()
            while state.loaded_version == before and time.perf_counter() - t2 < 30:
                time.sleep(0.05)
            watch_s = time.perf_counter() - t2
            if state.loaded_version == before:
                raise SystemExit("serve_reload: the checkpoint watcher did not pick up the replaced file")
            after_watch = copy.copy(state.sampler)
            health = json.loads(http(base, "/healthz")[1])
            rec.update({"reload": answer, "reload_s": reload_s, "watch_swap_s": watch_s,
                        "metrics_lines": len(metrics.splitlines()), "healthz": health})
        finally:
            httpd.shutdown()
            httpd.server_close()
            thread.join(timeout=30)
            state.close()
    finally:
        Sampler.sample_notes = original
    rec["server_sample_calls"] = len(calls)
    rec["server_sample_batches"] = sorted(set(calls))
    return {"rec": rec, "snapshots": [("/reload", after_reload, gan["final"], 5),
                                      ("the watcher", after_watch, swapped_in, 6)]}


def check_served_weights(np, gan, served, counts, results):
    """Outside the counts: each snapshot of the served sampler against a
    fresh ``Sampler`` on the file that was swapped in, bit for bit (a stale
    folded-BN stage would serve the old weights); and ``serve_reload``'s
    ``decoder_tail`` launches against the server's ``sample_notes`` calls,
    one launch each."""
    from melogan_torch import EMOTIONS
    from melogan_torch.sampling import Sampler
    from melogan_torch.utils.weights import load_gan_final_full

    rec = served["rec"]
    for swap, snapshot, path, seed in served["snapshots"]:
        gen_sd, fe_sd, extras = load_gan_final_full(path)
        fresh = Sampler(gan["cfg"], gen_variables=gen_sd, fe_variables=fe_sd,
                        emotion_features=extras["emotion_features"], device="cuda")
        notes, want = (s.sample_notes(list(EMOTIONS), seed=seed) for s in (snapshot, fresh))
        if not np.array_equal(notes, want):
            raise SystemExit(f"serve_reload: after {swap} the sampler does not serve the new weights")
    if counts["decoder_tail"] != rec["server_sample_calls"]:
        raise SystemExit(f"serve_reload: {counts['decoder_tail']} decoder_tail launches for "
                         f"{rec['server_sample_calls']} sample_notes calls of the server")
    emit(rec, results)


def state_differences(torch, a, b):
    """Where two GAN training states differ: the four modules' parameters
    and buffers, both Adams' moments and steps, the step count, the EMA
    stream and the random stream."""
    out = []
    for name in ("generator", "feature_encoder", "critic", "ed"):
        sa, sb = getattr(a, name).state_dict(), getattr(b, name).state_dict()
        out += [f"{name}.{k}" for k in sa if not torch.equal(sa[k], sb[k])]
    for opt in ("opt_g", "opt_d"):
        oa, ob = getattr(a, opt), getattr(b, opt)
        for pa, pb in zip(oa.param_groups[0]["params"], ob.param_groups[0]["params"]):
            out += [f"{opt}.{k}" for k in ("exp_avg", "exp_avg_sq", "step")
                    if not torch.equal(oa.state[pa][k], ob.state[pb][k])]
    if a.step != b.step:
        out.append("step")
    if (a.ema_params is None) != (b.ema_params is None) or any(
            not torch.equal(a.ema_params[n], b.ema_params[n]) for n in a.ema_params or {}):
        out.append("ema_params")
    if not torch.equal(a.rng.get_state(), b.rng.get_state()):
        out.append("rng")
    return sorted(set(out))


def sweep_counts(cfg, member_epochs, gates):
    """The launches a sweep phase must show, from the code: a member's epoch
    is ``gan_loop.run_epoch`` over the training corpus (2 group steps and a
    2-batch tail at 384 rows, batch 32; ``gan_launches``, no λ_fm); a gate
    one ``decoder_tail`` (one ``sample_notes`` of 4 × 2 pieces)."""
    return {**gan_launches(cfg, CORPUS_ROWS, member_epochs, 0), "decoder_tail": gates}


class _Timed:
    """Host seconds of each call of ``module.name`` while the phase runs
    (the wrapped calls end in a host sync or a file write; the wrapper
    launches nothing)."""

    def __init__(self, module, name):
        self.module, self.name, self.seconds = module, name, []

    def __enter__(self):
        self.real = getattr(self.module, self.name)

        def timed(*a, **k):
            t0 = time.perf_counter()
            out = self.real(*a, **k)
            self.seconds.append(time.perf_counter() - t0)
            return out

        setattr(self.module, self.name, timed)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.real)


def _sweep_args(trained, workdir, **kw):
    cfg = trained["cfg"]
    return dict(cfg=cfg, ed_cfg=trained["ed_cfg"], train_data=trained["data"],
                seeds=[cfg.seed + k for k in range(len(SWEEP_GRID))], workdir=workdir, verbose=False,
                hyper_grid=SWEEP_GRID, device="cuda", **kw)


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


def _sweep_file(cfg, workdir):
    return os.path.join(os.path.dirname(os.path.join(workdir, cfg.checkpoint_dir).rstrip("/")), "sweep",
                        "sweep_state.ckpt")


def drive_sweep(torch, np, trained, results):
    """``sweep``: ``sweep_gan`` of 4 members for 2 epochs with
    ``promote_best``, timed: each member-epoch (``run_epoch``), each gate
    and each ``sweep_state.ckpt`` write."""
    import shutil

    from melogan_torch.train import sweep

    workdir = os.path.join(WORK_DIR, "sweep")
    shutil.rmtree(workdir, ignore_errors=True)
    args = _sweep_args(trained, workdir, epochs=SWEEP_EPOCHS, promote_best=True)
    t0 = time.perf_counter()
    with _Timed(sweep, "run_epoch") as epochs, _Timed(sweep, "gate_member") as gates, \
            _Timed(sweep, "save_checkpoint") as saves:
        report = sweep.sweep_gan(**args)
    wall = time.perf_counter() - t0
    k = len(SWEEP_GRID)
    # chunks of one epoch (save_freq 1): each epoch's k member-epochs in turn
    rec = {"phase": "sweep", "members": k, "epochs": SWEEP_EPOCHS, "wall_s": wall,
           "population_epoch_s": [sum(epochs.seconds[e * k:(e + 1) * k]) for e in range(SWEEP_EPOCHS)],
           "member_epoch_s": epochs.seconds, "solo_epoch_s": trained["history"]["epoch_seconds"],
           "gate_s": gates.seconds, "state_save_s": saves.seconds,
           "best_seed": report["best_seed"],
           "gates": [(r["gate_passed"], r["gate_violations"]) for r in report["results"]]}
    emit(rec, results)
    return {"report": report, "workdir": workdir, "record": rec}


def check_sweep(torch, np, trained, swept, results):
    """After ``sweep``'s counted window: member 0 (the training phase's
    seed, config and epochs) read back from ``sweep_state.ckpt`` equals the
    training phase's state bit for bit; every member's ``gan_final.ckpt``
    loads and samples finite notes; the promoted file is the winner's."""
    from melogan_torch import EMOTIONS
    from melogan_torch.sampling import Sampler
    from melogan_torch.train import gan_step
    from melogan_torch.utils.checkpoint import load_checkpoint
    from melogan_torch.utils.weights import load_gan_final_full, load_sweep_state

    cfg, report = trained["cfg"], swept["report"]
    members = [gan_step.init_state(cfg, gan_step.build_models(cfg, trained["ed_cfg"]), seed=s, device="cuda")
               for s in report["seeds"]]
    note = load_sweep_state(members, load_checkpoint(_sweep_file(cfg, swept["workdir"])))
    differing = state_differences(torch, trained["state"], members[0])
    if note or differing:
        raise SystemExit(f"sweep: member 0 is not the training phase's state: {note}, {differing[:10]}")
    notes_std = []
    for r in report["results"]:
        gen_sd, fe_sd, extras = load_gan_final_full(r["checkpoint"])
        notes = Sampler(cfg, gen_variables=gen_sd, fe_variables=fe_sd, emotion_features=extras["emotion_features"],
                        device="cuda").sample_notes(list(EMOTIONS), seed=0)
        if notes.shape != (4, 512, 4) or not np.isfinite(notes).all():
            raise SystemExit(f"sweep: {r['checkpoint']} sampled {notes.shape} or not finite")
        notes_std.append(float(notes.std()))
    with open(report["best_checkpoint"], "rb") as f, open(report["promoted_to"], "rb") as g:
        if f.read() != g.read():
            raise SystemExit("sweep: the promoted gan_final.ckpt is not the winner's")
    emit({"phase": "sweep_check", "member0_equals_training": True, "notes_std": notes_std,
          "promoted": os.path.relpath(report["promoted_to"], ROOT)}, results)


def seed_sweep_resume(trained):
    """Before ``sweep_resume``'s counted run: the same sweep for 1 epoch in
    the resume's workdir, which leaves its ``sweep_state.ckpt`` there."""
    import shutil

    from melogan_torch.train.sweep import sweep_gan

    workdir = os.path.join(WORK_DIR, "sweep_resume")
    shutil.rmtree(workdir, ignore_errors=True)
    sweep_gan(**_sweep_args(trained, workdir, epochs=1, promote_best=True))
    return workdir


def drive_sweep_resume(torch, trained, swept, workdir, results):
    """``sweep_resume``: ``sweep_gan(resume=True)`` from the 1-epoch sweep's
    state to epoch 2; the members, their finals and the state file must be
    ``sweep``'s bit for bit."""
    from melogan_torch.train.sweep import sweep_gan

    t0 = time.perf_counter()
    report = sweep_gan(**_sweep_args(trained, workdir, epochs=SWEEP_EPOCHS, promote_best=True, resume=True))
    wall = time.perf_counter() - t0
    cfg, straight = trained["cfg"], swept["report"]
    same = {"curves": [r["curve"] for r in report["results"]] == [r["curve"] for r in straight["results"]]}
    for name, a, b in [("finals", [r["checkpoint"] for r in report["results"]],
                        [r["checkpoint"] for r in straight["results"]]),
                       ("state", [_sweep_file(cfg, workdir)], [_sweep_file(cfg, swept["workdir"])])]:
        same[name] = all(_bytes(x) == _bytes(y) for x, y in zip(a, b))
    rec = {"phase": "sweep_resume", "wall_s": wall, "resumed_from_epoch": 1, "bit_identical": all(same.values()),
           **{f"same_{k}": v for k, v in same.items()}}
    emit(rec, results)
    if not rec["bit_identical"]:
        raise SystemExit(f"sweep_resume is not the sweep done in one go: {same}")
    return rec


def drive_sweep_halving(torch, np, trained, results):
    """``sweep_halving``: the 4 members in rungs of 1 epoch for 3 epochs
    (4 → 2 → 1), each rung gated; rung sizes, survivors and the report
    checked."""
    import shutil

    from melogan_torch.train import sweep

    workdir = os.path.join(WORK_DIR, "sweep_halving")
    shutil.rmtree(workdir, ignore_errors=True)
    args = _sweep_args(trained, workdir, epochs=HALVING_EPOCHS, halving=True, rung_epochs=1)
    t0 = time.perf_counter()
    with _Timed(sweep, "gate_member") as gates:
        report = sweep.sweep_gan(**args)
    wall = time.perf_counter() - t0
    rungs = report.get("rungs", [])
    sizes = [len(r["members"]) for r in rungs]
    kept = [sum(m["survived"] for m in r["members"]) for r in rungs]
    (winner,) = report["results"]
    with open(os.path.join(os.path.dirname(os.path.dirname(winner["checkpoint"])), "sweep_report.json")) as f:
        on_disk = json.load(f)
    if sizes != [4, 2] or kept != [2, 1] or [row["epoch"] for row in winner["curve"]] != [1, 2, 3] \
            or on_disk["rungs"] != rungs or not all(np.isfinite(v) for row in winner["curve"] for v in row.values()):
        raise SystemExit(f"sweep_halving: rungs {sizes}, kept {kept}, winner curve {winner['curve']}")
    rec = {"phase": "sweep_halving", "wall_s": wall, "rung_sizes": sizes, "survivors": kept,
           "winner_seed": winner["seed"], "winner_hyper": winner["hyper"], "gate_s": gates.seconds,
           "rungs": [[(m["member"], m["gate_passed"], m["gate_violations"], m["survived"]) for m in r["members"]]
                     for r in rungs]}
    emit(rec, results)
    return rec


def measure_sweep_state(torch, np, trained, swept, results):
    """``sweep_state``, outside any counted path: the size of ``sweep``'s
    ``sweep_state.ckpt`` (4 members at full width), its ``load_checkpoint``
    and ``save_checkpoint`` seconds (a load and a save must give the same
    bytes), and the seconds ``load_sweep_state`` takes to put it into 4
    card states and ``export_sweep_state`` to take it back out."""
    from melogan_torch.train import gan_step
    from melogan_torch.utils.checkpoint import load_checkpoint, save_checkpoint
    from melogan_torch.utils.weights import export_sweep_state, load_sweep_state

    cfg = trained["cfg"]
    path = _sweep_file(cfg, swept["workdir"])
    t0 = time.perf_counter()
    raw = load_checkpoint(path)
    t1 = time.perf_counter()
    copy = os.path.join(WORK_DIR, "resaved_sweep_state.ckpt")
    save_checkpoint(copy, raw)
    t2 = time.perf_counter()
    with open(path, "rb") as f, open(copy, "rb") as g:
        if f.read() != g.read():
            raise SystemExit(f"{path}: a load and save does not give the same bytes")
    os.remove(copy)
    seeds = swept["report"]["seeds"]
    states = [gan_step.init_state(cfg, gan_step.build_models(cfg, trained["ed_cfg"]), seed=s, device="cuda")
              for s in seeds]
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    load_sweep_state(states, raw)
    torch.cuda.synchronize()
    t4 = time.perf_counter()
    export_sweep_state(states, seeds)
    t5 = time.perf_counter()
    rec = {"phase": "sweep_state", "file": os.path.relpath(path, ROOT), "members": len(seeds),
           "mb": os.path.getsize(path) / 1e6, "load_s": t1 - t0, "save_s": t2 - t1,
           "load_sweep_state_s": t4 - t3, "export_sweep_state_s": t5 - t4,
           "in_run_save_s": swept["record"]["state_save_s"]}
    emit(rec, results)
    return rec


# --- the bf16 slice ---------------------------------------------------------


def _bf16_record(torch, F, ops, results, kind, layer, b, shape, x, w, bias, geo, iters,
                 phase="kernels_bf16"):
    """One layer in the kernels' one-pass bf16 mode against its plain
    version (``bf16=True``), timed beside the f32 mode and beside cuDNN on
    bf16 tensors (the yardstick: bf16 in and out, f32 sums)."""
    from melogan_torch.utils.flops import PEAK_TF32_FLOPS

    if kind == "convt1d":
        s, p, op = geo
        run = lambda bf16: ops["convt"].convt1d_cuda(x, w, bias, s, p, op, bf16=bf16)  # noqa: E731
        plain = lambda: ops["convt"].convt1d_plain(x, w, bias, s, p, op, bf16=True)  # noqa: E731
        xn, wt = x.transpose(1, 2).contiguous().bfloat16(), w.permute(1, 2, 0).contiguous().bfloat16()
        bb = None if bias is None else bias.bfloat16()
        library = lambda: F.conv_transpose1d(xn, wt, bb, s, p, op)  # noqa: E731
        k = w.shape[0]
        flops = ops["convt"].convt_flops(b, x.shape[1], x.shape[2], w.shape[2], k, s, p, op)
    else:
        s, p = geo
        run = lambda bf16: ops["conv1d"].conv1d_cuda(x, w, bias, s, p, bf16=bf16)  # noqa: E731
        plain = lambda: ops["conv1d"].conv1d_plain(x, w, bias, s, p, bf16=True)  # noqa: E731
        xn, wt = x.transpose(1, 2).contiguous().bfloat16(), w.permute(2, 1, 0).contiguous().bfloat16()
        bb = None if bias is None else bias.bfloat16()
        library = lambda: F.conv1d(xn, wt, bb, s, p)  # noqa: E731
        flops = ops["conv1d"].conv1d_flops(b, x.shape[1], x.shape[2], w.shape[2], w.shape[0], s, p)
    out32 = run(False)
    out = run(True)
    ref = plain()
    again32 = run(False)
    torch.cuda.synchronize()
    err, rel = compare(out, ref, f"{kind} bf16 {layer} B={b}")
    if not torch.equal(again32, out32):
        raise SystemExit(f"{kind} {layer} B={b}: the f32 mode moved after a bf16 launch")
    diff = float((out - out32).abs().max()) / max(float(out32.abs().max()), 1e-30)
    if not diff > 0:
        raise SystemExit(f"{kind} {layer} B={b}: bf16 equals f32, the mode was not honoured")
    nbytes = 4 * (x.numel() + w.numel() + (0 if bias is None else bias.numel()) + out.numel())
    rec = {
        "phase": phase, "kernel": kind, "mode": "bf16", "layer": layer, "batch": b, "shape": shape,
        "max_abs_err": err, "max_rel_err": rel, "tol_rel": TOL_REL, "rel_diff_from_f32": diff,
        "kernel_ms": time_ms(torch, lambda: run(True), iters),
        "f32_kernel_ms": time_ms(torch, lambda: run(False), iters),
        "plain_ms": time_ms(torch, plain, iters),
        "library_ms": time_ms(torch, library, iters),
        **bound(flops, nbytes, PEAK_TF32_FLOPS), "flops": flops, "bytes": nbytes,
    }
    emit(rec, results)
    return rec


def check_bf16_kernels(torch, F, ops, gen, results):
    """``kernels_bf16``: both conv kernels in the one-pass bf16 mode against
    their plain versions (``bf16=True``) at the decoder's layers (batch 1,
    32 and 4096), the ED's (32, 64, 1024), the VAE's (32, 256) and, at 32,
    as the other conv's input gradient; each timed beside its f32 mode and
    cuDNN on bf16 tensors; bounds at the dense TF32 rate (495 TFLOP/s). The
    f32 mode's result must not move after the bf16 launches, and the bf16
    result must differ from it."""
    recs = {"convt1d": [], "conv1d": []}

    def rand(*shape, scale=1.0):
        return scale * torch.randn(shape, device="cuda", generator=gen)

    for b in CONVT_BATCHES:
        for i, (l, cin, cout) in enumerate(CONVT_LAYERS):
            x, w, bias = rand(b, l, cin), rand(5, cin, cout, scale=(5 * cin) ** -0.5), rand(cout, scale=0.1)
            recs["convt1d"].append(_bf16_record(torch, F, ops, results, "convt1d", f"dec{i + 1}", b,
                                                [b, l, cin, cout], x, w, bias, (2, 2, 1),
                                                20 if b > 64 else 100))
    for b in (TRAIN_BATCH, ED_BATCH, 1024):
        for l, cin, cout, k, s, p, name in ED_LAYERS:
            x, w, bias = rand(b, l, cin), rand(k, cin, cout, scale=(k * cin) ** -0.5), rand(cout, scale=0.1)
            recs["conv1d"].append(_bf16_record(torch, F, ops, results, "conv1d", name, b,
                                               [b, l, cin, cout, k, s, p], x, w, bias, (s, p),
                                               10 if b > 64 else 50))
    for b in VAE_BATCHES:
        for l, cin, cout, k, s, p, name in VAE_ENCODER:
            x, w, bias = rand(b, l, cin), rand(k, cin, cout, scale=(k * cin) ** -0.5), rand(cout, scale=0.1)
            recs["conv1d"].append(_bf16_record(torch, F, ops, results, "conv1d", f"vae_{name}", b,
                                               [b, l, cin, cout, k, s, p], x, w, bias, (s, p), 50))
        for i, (l, cin, cout) in enumerate(VAE_DECODER):
            x, w, bias = rand(b, l, cin), rand(5, cin, cout, scale=(5 * cin) ** -0.5), rand(cout, scale=0.1)
            recs["convt1d"].append(_bf16_record(torch, F, ops, results, "convt1d", f"vae_dec{i + 1}", b,
                                                [b, l, cin, cout], x, w, bias, (2, 2, 1), 50))
    # the input gradients at the training batch: conv1d's runs convt1d on
    # (g, wᵀ), convT's runs conv1d on (g, wᵀ)
    for (l, cin, cout, k, s, p, op), transposed, name in BACKWARD_LAYERS:
        w = rand(k, cin, cout, scale=(k * cin) ** -0.5)
        wT = w.transpose(1, 2).contiguous()
        if transposed:
            g = rand(TRAIN_BATCH, (l - 1) * s - 2 * p + k + op, cout)
            recs["conv1d"].append(_bf16_record(torch, F, ops, results, "conv1d", f"dx_{name}", TRAIN_BATCH,
                                               list(g.shape), g, wT, None, (s, p), 50))
        else:
            lout = (l + 2 * p - k) // s + 1
            g = rand(TRAIN_BATCH, lout, cout)
            recs["convt1d"].append(_bf16_record(torch, F, ops, results, "convt1d", f"dx_{name}", TRAIN_BATCH,
                                                list(g.shape), g, wT, None, (s, p, (l + 2 * p - k) % s), 50))
    return recs


FAST_B1_CALLS = 20  # /generate's batch
FAST_BIG_CALLS = 3
FAST_GENERATE = 3


def drive_sampling_fast(torch, np, results):
    """``sampling_fast`` (counted): ``Sampler(GANConfig(), fast_math=True)``
    at batch 1 (20 calls) and 4096 (3 calls): each call must launch
    ``convt1d`` three times, all in bf16 mode, and ``decoder_tail`` never;
    then ``create_server(fast_math=True)`` answering three ``POST
    /generate`` whose MIDI parses. Every forward of a fast sampler is
    counted, so that the phase's launches can be held to 3 a forward."""
    from melogan_torch import EMOTIONS
    from melogan_torch.config import GANConfig
    from melogan_torch.midi.midifile import read_midi
    from melogan_torch.ops import convt, decoder
    from melogan_torch.sampling import Sampler
    from melogan_torch.serving.app import create_server

    forwards = []
    original = Sampler._forward

    def counted(self, *a, **k):
        forwards.append(self.fast_math)
        return original(self, *a, **k)

    Sampler._forward = counted
    try:
        sampler = Sampler(GANConfig(), seed=0, fast_math=True, device="cuda")
        walls = {}
        for b, calls in ((1, FAST_B1_CALLS), (MAIN_BATCH, FAST_BIG_CALLS)):
            emotions = [EMOTIONS[i % 4] for i in range(b)]
            walls[b] = []
            for seed in range(calls):
                before = (convt.convt1d_cuda.launches, convt.convt1d_cuda.launches_bf16,
                          decoder.decoder_tail_cuda.launches)
                t0 = time.perf_counter()
                notes = sampler.sample_notes(emotions, seed=seed)  # ends in a device→host copy
                walls[b].append((time.perf_counter() - t0) * 1e3)
                delta = (convt.convt1d_cuda.launches - before[0], convt.convt1d_cuda.launches_bf16 - before[1],
                         decoder.decoder_tail_cuda.launches - before[2])
                if delta != (3, 3, 0) or notes.shape != (b, 512, 4) or not np.isfinite(notes).all():
                    raise SystemExit(f"fast sample_notes B={b}: launches (convt1d, bf16, decoder_tail) "
                                     f"{delta}, want (3, 3, 0); notes {notes.shape}")
        httpd, state = create_server("127.0.0.1", 0, workdir=os.path.join(WORK_DIR, "no_checkpoint"),
                                     device="cuda", sample_pool=False, fast_math=True)
        thread = threading.Thread(target=httpd.serve_forever, daemon=True)
        thread.start()
        try:
            base = f"http://127.0.0.1:{httpd.server_address[1]}"
            notes_read = []
            for emotion in EMOTIONS[:FAST_GENERATE]:
                status, body = http(base, "/generate", json.dumps({"emotion": emotion}).encode())
                if status != 200 or body[:4] != b"MThd":
                    raise SystemExit(f"fast /generate {emotion}: status {status}")
                notes_read.append(sum(len(inst.notes) for inst in read_midi(body).instruments))
            if not state.sampler.fast_math:
                raise SystemExit("create_server(fast_math=True) built an f32 sampler")
        finally:
            httpd.shutdown()
            httpd.server_close()
            thread.join(timeout=30)
    finally:
        Sampler._forward = original
    if not all(forwards):
        raise SystemExit("an f32 sampler ran inside sampling_fast")
    emit({"phase": "sampling_fast", "wall_ms_b1": walls[1], "wall_ms_b4096": walls[MAIN_BATCH],
          "median_ms_b1": float(np.median(walls[1])), "median_ms_b4096": float(np.median(walls[MAIN_BATCH])),
          "samples_per_s_b4096_best": MAIN_BATCH / (min(walls[MAIN_BATCH]) / 1e3),
          "fast_forwards": len(forwards), "generate_notes_read": notes_read}, results)
    return {"sampler": sampler, "forwards": len(forwards), "walls": walls}


def check_fast_sampling(torch, np, fast, results):
    """After ``sampling_fast``'s window: the fast sampler's notes against
    the card's f32 sampler on the same weights (they must differ, within 10
    product stages of 2⁻⁸: the encoder's 3 Linears, NoiseToLatent's 2, the
    pre-net's 2, the decoder's 3 transposed convs) and against the port's
    CPU fast path (the same roundings, sums in another order: within one
    bf16 step, 2⁻⁸, of the scale), on the same features and noise; and the
    f32 sampler's wall at 1 and 4096 beside the fast one's."""
    from melogan_torch.sampling import Sampler

    s = fast["sampler"]
    kw = dict(gen_variables=s.generator.state_dict(), fe_variables=s.feature_encoder.state_dict())
    f32 = Sampler(s.cfg, device="cuda", **kw)
    cpu = Sampler(s.cfg, device="cpu", fast_math=True, **kw)
    rng = np.random.default_rng(1)
    feats = rng.normal(size=(16, 6)).astype(np.float32)
    noise = rng.normal(size=(16, s.cfg.noise_dim)).astype(np.float32)
    ours, ref32, refcpu = s.sample_from(feats, noise), f32.sample_from(feats, noise), cpu.sample_from(feats, noise)
    scale = float(np.abs(ref32).max())
    vs_f32 = float(np.abs(ours - ref32).max()) / scale
    vs_cpu = float(np.abs(ours - refcpu).max()) / float(np.abs(refcpu).max())
    if not (0 < vs_f32 <= 10 * 2.0 ** -8) or not vs_cpu <= 2.0 ** -8:
        raise SystemExit(f"fast sampler: {vs_f32:.3e} of scale from the card's f32 sampler "
                         f"(want 0 < x <= {10 * 2.0 ** -8:.3e}), {vs_cpu:.3e} from the CPU's fast path")
    from melogan_torch import EMOTIONS

    walls32 = {}
    for b, calls in ((1, FAST_B1_CALLS), (MAIN_BATCH, FAST_BIG_CALLS)):
        emotions = [EMOTIONS[i % 4] for i in range(b)]
        f32.sample_notes(emotions, seed=0)
        walls32[b] = []
        for seed in range(calls):
            t0 = time.perf_counter()
            f32.sample_notes(emotions, seed=seed)
            walls32[b].append((time.perf_counter() - t0) * 1e3)
    rec = {"phase": "fast_vs_f32", "rel_err_vs_card_f32": vs_f32, "rel_err_vs_cpu_fast": vs_cpu,
           "f32_wall_ms_b1": walls32[1], "f32_wall_ms_b4096": walls32[MAIN_BATCH],
           "f32_median_ms_b1": float(np.median(walls32[1])),
           "f32_median_ms_b4096": float(np.median(walls32[MAIN_BATCH]))}
    emit(rec, results)
    return rec


def drive_training_bf16(torch, np, data, trained, vae, results):
    """``training_bf16`` (counted): the three trainers as a user calls them
    at ``precision="bf16"`` on the card: ``gan_loop.train`` for 1 epoch on
    the training phase's corpus and config, ``vae_loop.train`` with
    ``configs/ae.yaml`` for 3 epochs and ``ed_loop.train`` with
    ``configs/ed.yaml`` for 4 epochs on the data phase's splits. Every
    launch must be in bf16 mode, and the counts those of the f32 phases'
    runs of the same shape: ``sweep_counts`` for one GAN epoch, the
    ``vae_train`` phase's counts, ``ed_counts``. Losses finite."""
    import shutil

    from melogan_torch.train import ed_loop, gan_loop, vae_loop

    rec = {"phase": "training_bf16"}
    workdir = os.path.join(WORK_DIR, "bf16")
    shutil.rmtree(workdir, ignore_errors=True)
    t0 = time.perf_counter()
    state, hist = gan_loop.train(trained["cfg"], trained["ed_cfg"], trained["data"],
                                 workdir=os.path.join(workdir, "gan"), epochs=1, verbose=False,
                                 precision="bf16", device="cuda")
    rec["gan_wall_s"] = time.perf_counter() - t0
    if state.step < 1 or not all(np.isfinite(v) for v in hist.values()):
        raise SystemExit(f"training_bf16 GAN: step {state.step}, history {hist}")
    rec["gan_history"] = hist
    t0 = time.perf_counter()
    _, vm = vae_loop.train(vae["cfg"], data["train"], data["val"], workdir=os.path.join(workdir, "vae"),
                           verbose=False, precision="bf16", device="cuda")
    rec["vae_wall_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    _, em = ed_loop.train(_ed_cfg(), data["train"], data["val"], workdir=os.path.join(workdir, "ed"),
                          verbose=False, precision="bf16", device="cuda")
    rec["ed_wall_s"] = time.perf_counter() - t0
    if not all(np.isfinite(v) for v in list(vm.values()) + list(em.values())):
        raise SystemExit(f"training_bf16: VAE {vm}, ED {em}")
    rec.update(vae_metrics=vm, ed_metrics=em)
    emit(rec, results)


def time_bf16_steps(torch, np, data, vae, results):
    """``bf16_steps``, outside any counted path: the group step (batch 32,
    ``GANConfig()``), the VAE step (``configs/ae.yaml``) and the ED step
    (``configs/ed.yaml``, batch 64) at f32 and at ``precision="bf16"``, in
    turns (f32, bf16, bf16, f32), 5 steps each after a first, host clock
    around steps that end in a synchronize; each step's launches, which at
    bf16 must all be in bf16 mode and as many as at f32."""
    from melogan_torch.config import EDConfig, GANConfig
    from melogan_torch.ops import conv1d, convt
    from melogan_torch.train import ed_loop, gan_loop, gan_step, vae_loop
    from melogan_torch.train.harness import with_precision

    def counts():
        return (conv1d.conv1d_cuda.launches, convt.convt1d_cuda.launches,
                conv1d.conv1d_cuda.launches_bf16, convt.convt1d_cuda.launches_bf16)

    def timed(step, n=5):
        step()
        torch.cuda.synchronize()
        before = counts()
        walls = []
        for _ in range(n):
            t0 = time.perf_counter()
            step()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        per = [(a - b) / n for a, b in zip(counts(), before)]
        return walls, {"conv1d": per[0], "convt1d": per[1], "conv1d_bf16": per[2], "convt1d_bf16": per[3]}

    cfgs = {}
    for precision in (None, "bf16"):
        cfg = gan_step.precision_tuned_cfg(GANConfig(), precision)
        state = gan_step.init_state(cfg, gan_step.build_models(cfg, EDConfig()), seed=0, device="cuda")
        steps = gan_loop.precision_steps(gan_step.make_train_steps(cfg), precision)
        (batches, _), = _batches_and_draws(torch, np, cfg, state.feature_encoder, 1, ["cuda"])
        cfgs[("group", precision)] = lambda s=state, st=steps, bt=batches: st.group(s, bt)
        vcfg = vae["cfg"]
        vstate = vae_loop.init_state(vcfg, seed=1, device="cuda")
        x = torch.as_tensor(data["train"].notes_ae(vcfg)[: vcfg.batch_size], device="cuda")
        vstep = with_precision(vae_loop.train_step, precision)
        cfgs[("vae", precision)] = lambda s=vstate, x=x, f=vstep, c=vcfg: f(s, x, c.beta, c.free_bits)
        ecfg = _ed_cfg()
        estate = ed_loop.init_state(ecfg, seed=1, device="cuda")
        xe = torch.as_tensor(data["train"].notes_gan()[:ED_BATCH], device="cuda")
        ye = torch.as_tensor(data["train"].emotion_idx[:ED_BATCH].astype(np.int64), device="cuda")
        estep = with_precision(ed_loop.train_step, precision)
        cfgs[("ed", precision)] = lambda s=estate, f=estep, x=xe, y=ye: f(s, x, y)
    rec = {"phase": "bf16_steps"}
    for name in ("group", "vae", "ed"):
        walls = {None: [], "bf16": []}
        per = {}
        for precision in (None, "bf16", "bf16", None):
            w, per[precision] = timed(cfgs[(name, precision)])
            walls[precision] += w
        want = dict(per[None], conv1d_bf16=per[None]["conv1d"], convt1d_bf16=per[None]["convt1d"])
        if per["bf16"] != want or per[None]["conv1d_bf16"] or per[None]["convt1d_bf16"]:
            raise SystemExit(f"{name} step launches: f32 {per[None]}, bf16 {per['bf16']}")
        rec[name] = {"f32_wall_ms": walls[None], "bf16_wall_ms": walls["bf16"],
                     "f32_median_ms": float(np.median(walls[None])),
                     "bf16_median_ms": float(np.median(walls["bf16"])), "launches_per_step": per["bf16"]}
    emit(rec, results)
    return rec


def drive_spectral(torch, np, results):
    """``spectral`` (counted): a ``Sampler`` whose feature encoder has
    spectral norm (``GANConfig(encoder_use_sn=True)``, seeded weights and
    ``u``) on the card: ``sample_notes`` for the four emotions through the
    decoder-tail kernel, ``u`` unchanged (eval mode), and ``sample_from``
    held against the port's CPU path on the same state (1e-4 of scale)."""
    from melogan_torch import EMOTIONS
    from melogan_torch.config import GANConfig
    from melogan_torch.sampling import Sampler

    s = Sampler(GANConfig(encoder_use_sn=True), seed=0, device="cuda")
    u = s.feature_encoder.net[1].u.clone()
    notes = s.sample_notes(list(EMOTIONS), seed=1)
    if notes.shape != (4, 512, 4) or not np.isfinite(notes).all():
        raise SystemExit(f"spectral: notes {notes.shape} or not finite")
    if not torch.equal(s.feature_encoder.net[1].u, u):
        raise SystemExit("spectral: eval-mode sampling moved u")
    cpu = Sampler(s.cfg, gen_variables=s.generator.state_dict(), fe_variables=s.feature_encoder.state_dict(),
                  device="cpu")
    rng = np.random.default_rng(2)
    feats = rng.normal(size=(8, 6)).astype(np.float32)
    noise = rng.normal(size=(8, s.cfg.noise_dim)).astype(np.float32)
    err, rel = compare(torch.from_numpy(s.sample_from(feats, noise)), torch.from_numpy(cpu.sample_from(feats, noise)),
                       "spectral-norm sampler, card vs CPU")
    emit({"phase": "spectral", "max_abs_err": err, "max_rel_err": rel,
          "sigma": [float(m.sigma()) for m in s.feature_encoder.net if hasattr(m, "sigma")]}, results)


# ---------------------------------------------------------------------------
# the command line: python -m melogan_torch, in this process and in children
# ---------------------------------------------------------------------------

CLI_PER_EMOTION = 96  # 384 songs: about 268 train rows, a full group of 5 batches every GAN epoch
CLI_EPOCHS = 6  # SAVE_FREQ 5: gan_epoch0005.ckpt, gates at epochs 5 and 6
CLI_SAMPLES = 2
CLI_JUDGE_EPOCHS = 2
PROFILE_STEPS = 5
CLI_DIR = os.path.join(WORK_DIR, "cli")
CLI_CONFIGS = {k: os.path.join(ROOT, "configs", f) for k, f in
               (("ae", "ae_freebits.yaml"), ("ed", "ed.yaml"), ("gan", "gan.yaml"))}
EVAL_GEN_KEYS = {"n", "accuracy", "chance", "per_emotion", "confusion", "n_per_emotion", "seed",
                 "judge_real"}  # melogan_tpu/cli.py:1210-1220 with diagnostics/judge.py


def cli_pipeline_argv(work, resume=False):
    return (["pipeline", "--workdir", work, "--synthetic", "--per-emotion", str(CLI_PER_EMOTION),
             "--epochs", str(CLI_EPOCHS), "--ae-config", CLI_CONFIGS["ae"], "--ed-config", CLI_CONFIGS["ed"],
             "--gan-config", CLI_CONFIGS["gan"], "--gan-fm", "10", "--gan-track-best",
             # the gate stage exits 1 on a failing gate, which 6 epochs give;
             # cli_commands runs quality-gate --no-strict at both tiers
             "--skip-quality-gate"]
            + (["--resume"] if resume else []))


def run_cli(argv, name):
    """``melogan_torch.cli.main(argv)`` in this process (the launches count),
    its standard output into ``<CLI_DIR>/<name>.log`` and returned; on an
    error the log's tail goes to stderr before the error propagates."""
    import contextlib

    from melogan_torch.cli import main as cli_main

    os.makedirs(CLI_DIR, exist_ok=True)
    log = os.path.join(CLI_DIR, f"{name}.log")
    try:
        with open(log, "w") as f, contextlib.redirect_stdout(f):
            cli_main(argv)
    except BaseException:
        with open(log) as f:
            print(f"cli {name} failed; the tail of {log}:\n" + "".join(f.readlines()[-40:]),
                  file=sys.stderr, flush=True)
        raise
    with open(log) as f:
        return f.read()


def _rows(work):
    import numpy as np

    return {s: int(np.load(os.path.join(work, "data", "splits", s, "notes.npy"), mmap_mode="r").shape[0])
            for s in ("train", "val", "test")}


def _batches(n, batch):
    """``train.harness.batch_indices``: full batches, a split smaller than
    the batch one whole-split batch."""
    return max(1, n // min(batch, n))


def vae_launches(cfg, n_train, n_val, epochs):
    """``vae_loop.train``: a step runs the encoder's 3 convs (``conv1d``)
    and the decoder's 3 transposed convs (``convt1d``) forward, their input
    gradients backward (3 ``conv1d``; 2 ``convt1d``, the input's own not
    being needed); a validation batch and the reconstruction dump of every
    epoch one forward each."""
    steps, val = _batches(n_train, cfg.batch_size), _batches(n_val, cfg.batch_size)
    dumps = epochs // cfg.recon_freq if cfg.recon_save_count > 0 else 0
    return {"conv1d": epochs * (6 * steps + 3 * val) + 3 * dumps,
            "convt1d": epochs * (5 * steps + 3 * val) + 3 * dumps}


def ed_launches(batch, n_train, n_val, epochs):
    """``ed_loop.train``: a step 4 ``conv1d`` forward and 3 ``convt1d`` (the
    input gradients of the upper 3 convs), a validation batch 4 ``conv1d``."""
    steps, val = _batches(n_train, batch), _batches(n_val, batch)
    return {"conv1d": epochs * 4 * (steps + val), "convt1d": epochs * 3 * steps}


def gan_launches(cfg, n_train, epochs, fm_ed_rows):
    """``gan_loop.train``: a group step launches ``convt1d`` 22 times (the
    generator's 3 transposed convs in each of 5 critic updates and in the
    generator update, then the input gradients of the frozen ED's 4 convs)
    and ``conv1d`` 7 times (the ED's 4 convs, the input gradients of the
    decoder's 3); a tail batch 3 ``convt1d`` (the generator's forward); with
    λ_fm and an ED, the 4 ``conv1d`` of each 128-row chunk of the
    ``fm_ed_rows`` that the ED's feature targets take."""
    n_batches = n_train // cfg.batch_size
    groups = n_batches // cfg.critic_iters
    tail = n_batches - groups * cfg.critic_iters
    chunks = -(-fm_ed_rows // 128)
    return {"conv1d": epochs * groups * 7 + 4 * chunks,
            "convt1d": epochs * (groups * (3 * cfg.critic_iters + 7) + 3 * tail)}


def cli_counts(rows, gan_epochs, gates_and_samples, vae_epochs=0, ed_epochs=0, encode=False):
    """The launches of a pipeline run from its split sizes: the stages that
    ran, each by the code's count above; one ``decoder_tail`` a gate and a
    ``sample`` stage."""
    from melogan_torch.config import AEConfig, EDConfig, GANConfig

    ae, ed, gan = (c.from_yaml(CLI_CONFIGS[k]) for c, k in ((AEConfig, "ae"), (EDConfig, "ed"),
                                                            (GANConfig, "gan")))
    parts = [vae_launches(ae, rows["train"], rows["val"], vae_epochs),
             ed_launches(ed.batch_size, rows["train"], rows["val"], ed_epochs),
             gan_launches(gan, rows["train"], gan_epochs, rows["train"])]
    if encode:
        parts.append({"conv1d": 3 * sum(-(-n // 256) for n in rows.values()), "convt1d": 0})
    return {"conv1d": sum(p["conv1d"] for p in parts), "convt1d": sum(p["convt1d"] for p in parts),
            "decoder_tail": gates_and_samples}


def _count_mids(d):
    from melogan_torch.midi.midifile import read_midi

    mids = sorted(f for f in os.listdir(d) if f.endswith(".mid"))
    for f in mids:
        if len(read_midi(os.path.join(d, f)).note_array()) == 0:
            raise SystemExit(f"{d}/{f} holds no notes")
    return mids


def drive_cli_pipeline(np, results):
    """``cli_pipeline``: ``python -m melogan_torch pipeline`` in this process
    at the shipped widths (``configs/ae_freebits.yaml``, ``ed.yaml``,
    ``gan.yaml``), a synthetic corpus of 96 songs an emotion, 6 epochs of
    each trainer, λ_fm = 10 and the gate-tracked best, without the final
    gate stage (it exits 1 on a failing gate; ``cli_commands`` runs the
    gate); each stage's wall from ``pipeline_timings.json``."""
    import shutil

    shutil.rmtree(CLI_DIR, ignore_errors=True)
    work = os.path.join(CLI_DIR, "work")
    t0 = time.perf_counter()
    out = run_cli(cli_pipeline_argv(work), "pipeline")
    wall = time.perf_counter() - t0
    with open(os.path.join(work, "pipeline_timings.json")) as f:
        timings = json.load(f)
    stages = [s["name"] for s in timings["stages"]]
    want = ["synth-data", "preprocess", "make-splits", "split-arrays", "train-ae", "encode", "train-ed",
            "train-gan", "sample"]
    if stages != want or timings["resumed"] or "pipeline complete" not in out:
        raise SystemExit(f"cli_pipeline: stages {stages}, resumed {timings['resumed']}")
    ckpts = sorted(os.listdir(os.path.join(work, "experiments", "gan", "checkpoints")))
    for f in ("gan_best.ckpt", "gan_epoch0005.ckpt", "gan_final.ckpt", "gan_final.pth"):
        if f not in ckpts:
            raise SystemExit(f"cli_pipeline: {f} missing from {ckpts}")
    mids = _count_mids(os.path.join(work, "generated_tests"))
    best = os.path.join(work, "experiments", "gan", "checkpoints", "gan_best.ckpt")
    if len(mids) != 8 or f"loaded generator from {best}" not in out:
        raise SystemExit(f"cli_pipeline: {len(mids)} .mid files, the sample stage did not load {best}")
    rows = _rows(work)
    emit({"phase": "cli_pipeline", "wall_s": wall, "rows": rows,
          "stage_seconds": {s["name"]: s["seconds"] for s in timings["stages"]},
          "total_seconds": timings["total_seconds"], "checkpoints": ckpts}, results)
    return {"work": work, "rows": rows}


def drive_cli_resume(piped, results):
    """``cli_resume``: the same argv with ``--resume`` (every stage skips,
    no launch), then with train-gan's marker deleted: train-gan resumes
    from ``gan_epoch0005.ckpt`` for the last epoch and the sample stage runs
    again."""
    work = piped["work"]
    from melogan_torch.ops import conv1d, convt, decoder

    wrappers = (conv1d.conv1d_cuda, convt.convt1d_cuda, decoder.decoder_tail_cuda)
    out = run_cli(cli_pipeline_argv(work, resume=True), "resume_done")
    skipped = ["synth-data", "preprocess", "make-splits", "split-arrays"]
    done = ["train-ae", "encode", "train-ed", "train-gan", "sample"]
    missing = ([s for s in skipped if f"--resume: skipping {s} (outputs exist)" not in out]
               + [s for s in done if f"--resume: skipping {s} (completed in a previous run)" not in out])
    first = {w.__name__: w.launches for w in wrappers}
    if missing or any(first.values()):
        raise SystemExit(f"cli_resume: no skip for {missing}; launches {first}")
    os.unlink(os.path.join(work, ".pipeline_done", "train-gan.json"))
    t0 = time.perf_counter()
    out = run_cli(cli_pipeline_argv(work, resume=True), "resume_gan")
    wall = time.perf_counter() - t0
    periodic = os.path.join(work, "experiments", "gan", "checkpoints", "gan_epoch0005.ckpt")
    with open(os.path.join(work, "pipeline_timings.json")) as f:
        timings = json.load(f)
    ran = {s["name"]: s["seconds"] for s in timings["stages"] if s["seconds"] > 0}
    if (f"resumed from {periodic} at epoch {CLI_EPOCHS}" not in out
            or "--resume: skipping train-ed (completed in a previous run)" not in out
            or sorted(ran) != ["sample", "train-gan"] or not timings["resumed"]):
        raise SystemExit(f"cli_resume: stages run {ran}; the train-gan resume from {periodic} not seen")
    if len(_count_mids(os.path.join(work, "generated_tests"))) != 8:
        raise SystemExit("cli_resume: the sample stage wrote no 8 files")
    emit({"phase": "cli_resume", "done_run_launches": first, "resumed_wall_s": wall,
          "stage_seconds": ran}, results)


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def drive_cli_commands(np, piped, results):
    """``cli_commands``: ``sample``, ``eval-gen``, ``quality-gate`` at both
    tiers, ``export-checkpoint`` then ``import-checkpoint`` of the
    pipeline's ``gan_final.ckpt``, ``profile`` and ``doctor``, each by its
    own argv in this process."""
    import torch

    from melogan_torch.utils.checkpoint import load_checkpoint

    work = piped["work"]
    dirs = ["--splits-dir", os.path.join(work, "data", "splits"),
            "--processed-dir", os.path.join(work, "data", "processed")]
    rec = {"phase": "cli_commands"}
    out_dir = os.path.join(CLI_DIR, "sample")
    run_cli(["sample", "--emotion", "all", "--samples", str(CLI_SAMPLES), "--workdir", work,
             "--config", CLI_CONFIGS["gan"], "--out", out_dir], "sample")
    rec["sample_files"] = _count_mids(out_dir)
    if len(rec["sample_files"]) != 4 * CLI_SAMPLES:
        raise SystemExit(f"cli sample wrote {rec['sample_files']}")

    run_cli(["eval-gen", "--workdir", work, "--config", CLI_CONFIGS["gan"], "--ed-config", CLI_CONFIGS["ed"],
             *dirs, "--samples", str(CLI_SAMPLES), "--judge-epochs", str(CLI_JUDGE_EPOCHS)], "eval_gen")
    with open(os.path.join(work, "eval_gen.json")) as f:
        report = json.load(f)
    if set(report) != EVAL_GEN_KEYS or report["n"] != 4 * CLI_SAMPLES or report["judge_real"] is None:
        raise SystemExit(f"cli eval-gen: eval_gen.json {report}")
    rec["eval_gen"] = {k: report[k] for k in ("accuracy", "n")}
    rec["eval_gen"]["judge_real"] = report["judge_real"]["accuracy"]

    gen = os.path.join(work, "generated_tests")
    for tier in ("default", "strict"):
        out = run_cli(["quality-gate", gen, "--tier", tier, "--no-strict"], f"gate_{tier}")
        rec[f"gate_{tier}"] = [ln for ln in out.splitlines() if "quality gate" in ln]
        if not rec[f"gate_{tier}"]:
            raise SystemExit(f"cli quality-gate --tier {tier}: no verdict")

    final = os.path.join(work, "experiments", "gan", "checkpoints", "gan_final.ckpt")
    pth, back = os.path.join(CLI_DIR, "exported.pth"), os.path.join(CLI_DIR, "imported.ckpt")
    run_cli(["export-checkpoint", final, pth, "--kind", "gan"], "export")
    run_cli(["import-checkpoint", pth, back, "--kind", "gan"], "import")
    a, b = load_checkpoint(final), load_checkpoint(back)
    for key in ("G", "E_num"):
        la, lb = _leaves(a[key]), _leaves(b[key])
        if sorted(la) != sorted(lb) or not all(np.array_equal(la[k], lb[k]) for k in la):
            raise SystemExit(f"cli export/import: the {key} leaves differ from the original's")
    rec["roundtrip_leaves"] = sum(len(_leaves(a[k])) for k in ("G", "E_num"))

    out = run_cli(["profile", "--steps", str(PROFILE_STEPS), "--config", CLI_CONFIGS["gan"]], "profile")
    rec["profile"] = json.loads(out.strip().splitlines()[-1])
    if rec["profile"]["steps"] != PROFILE_STEPS:
        raise SystemExit(f"cli profile: {rec['profile']}")

    out = run_cli(["doctor", "--workdir", work], "doctor")
    if f"[OK] device: {torch.cuda.get_device_name(0)}" not in out or "[OK] doctor:" not in out:
        raise SystemExit(f"cli doctor:\n{out}")
    rec["doctor"] = [ln for ln in out.splitlines() if ln.startswith("[")]
    emit(rec, results)


def cli_commands_counts(rows):
    """``sample`` 1 ``decoder_tail``; ``eval-gen`` the judge's training on
    val (test as its validation; ``ed_launches``), its pass over the real
    test rows and over the generated ones (4 ``conv1d`` each) and one
    ``sample_notes``; ``profile`` 1 + PROFILE_STEPS ``sample_notes``."""
    from melogan_torch.config import EDConfig

    ed = EDConfig.from_yaml(CLI_CONFIGS["ed"])
    judge = ed_launches(ed.batch_size, rows["val"], rows["test"], CLI_JUDGE_EPOCHS)
    return {"conv1d": judge["conv1d"] + 8, "convt1d": judge["convt1d"],
            "decoder_tail": 1 + 1 + 1 + PROFILE_STEPS}


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def drive_cli_module(piped, results):
    """``cli_module``: ``python -m melogan_torch sample`` in a child process,
    then ``python -m melogan_torch serve`` on the pipeline's
    ``gan_final.ckpt``: ``/healthz`` says platform gpu, one ``POST
    /generate`` gives MIDI bytes, SIGINT stops it and it exits 0. The
    children's launches are their own (not counted here)."""
    import signal

    work = piped["work"]
    env = dict(os.environ, MELOGAN_POOL_WARM="0")
    out_dir = os.path.join(CLI_DIR, "module_sample")
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "melogan_torch", "sample", "--emotion", "calm", "--samples", "2",
                        "--seed", "7", "--workdir", work, "--config", CLI_CONFIGS["gan"], "--out", out_dir],
                       cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    sample_s = time.perf_counter() - t0
    if r.returncode != 0 or _count_mids(out_dir) != ["test_calm_1.mid", "test_calm_2.mid"]:
        raise SystemExit(f"python -m melogan_torch sample: rc {r.returncode}\n{r.stdout[-2000:]}\n{r.stderr[-2000:]}")

    port = _free_port()
    final = os.path.join(work, "experiments", "gan", "checkpoints", "gan_final.ckpt")
    log_path = os.path.join(CLI_DIR, "serve.log")
    with open(log_path, "w") as log:
        proc = subprocess.Popen([sys.executable, "-m", "melogan_torch", "serve", "--host", "127.0.0.1",
                                 "--port", str(port), "--checkpoint", final, "--config", CLI_CONFIGS["gan"]],
                                cwd=ROOT, env=env, stdout=log, stderr=subprocess.STDOUT)
        try:
            base = f"http://127.0.0.1:{port}"
            t0 = time.perf_counter()
            health = None
            while health is None:
                if proc.poll() is not None or time.perf_counter() - t0 > 240:
                    raise SystemExit(f"python -m melogan_torch serve did not come up (rc {proc.poll()})")
                try:
                    health = json.loads(http(base, "/healthz")[1])
                except OSError:
                    time.sleep(0.5)
            up_s = time.perf_counter() - t0
            status, body = http(base, "/generate", json.dumps({"emotion": "angry"}).encode())
            if (status != 200 or body[:4] != b"MThd" or health["device"]["platform"] != "gpu"
                    or health["generator"] != "checkpoint"):
                raise SystemExit(f"python -m melogan_torch serve: /generate {status}, /healthz {health}")
            proc.send_signal(signal.SIGINT)
            rc = proc.wait(timeout=60)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    if rc != 0:
        with open(log_path) as f:
            raise SystemExit(f"python -m melogan_torch serve exited {rc} on SIGINT:\n{f.read()[-2000:]}")
    emit({"phase": "cli_module", "sample_s": sample_s, "serve_up_s": up_s, "generate_bytes": len(body),
          "healthz": health, "serve_rc": rc}, results)


# ---------------------------------------------------------------------------
# The text path: text → emotion on the card, then /generate
# ---------------------------------------------------------------------------

TEXT_DIR = os.path.join(WORK_DIR, "text")
TEXT_REPEAT_EPOCHS = 2  # the bitwise repeat of training on the card
TEXT_SPLIT_TEXTS = 200  # eval sentences whose host and device times are split
# roberta-base's widths (SamLowe/roberta-base-go_emotions), random N(0, 0.02) weights
ROBERTA_BASE = dict(vocab_size=50265, hidden_size=768, num_hidden_layers=12, num_attention_heads=12,
                    intermediate_size=3072, max_position_embeddings=514, num_labels=28)
ROBERTA_BUCKETS = (16, 64, 512)  # one __call__ at B=1 timed in each
ROBERTA_BATCH, ROBERTA_SEQ = 64, 128  # the timed forward
ROBERTA_CALLS = 20
GO_EMOTIONS = ("admiration", "amusement", "anger", "annoyance", "approval", "caring", "confusion",
               "curiosity", "desire", "disappointment", "disapproval", "disgust", "embarrassment",
               "excitement", "fear", "gratitude", "grief", "joy", "love", "nervousness", "optimism",
               "pride", "realization", "relief", "remorse", "sadness", "surprise", "neutral")
# one text an emotion, each with a unique keyword hit in its emotion's categories
TEXT_PROBES = {"happy": "i am so happy today", "sad": "i feel so sad and heartbroken",
               "angry": "i am furious and livid about this", "calm": "i am relieved that it is finally over"}


def drive_text_mlp(torch, np, results):
    """``text_mlp``: the shipped recipe (150 epochs of 106 AdamW steps)
    trained on the card, evaluated against the lexicon on the 1,620 eval
    sentences, and two 2-epoch runs that must be bitwise equal. Its file is
    the cache of the later phases. The pin check comes last."""
    from melogan_torch.diagnostics.text_eval import evaluate_text_backend, macro_accuracy
    from melogan_torch.models import text_mlp
    from melogan_torch.models.text_emotion import MEASURED_EVAL_ACCURACY, LexiconClassifier

    stats = {}
    t0 = time.perf_counter()
    clf = text_mlp.train_text_classifier(device="cuda", stats=stats)
    wall = time.perf_counter() - t0
    if next(clf.model.parameters()).device.type != "cuda":
        raise SystemExit("text_mlp: the classifier is not on the card")
    t0 = time.perf_counter()
    own = evaluate_text_backend(clf)
    eval_s = time.perf_counter() - t0
    lex = evaluate_text_backend(LexiconClassifier())
    # where one request's time goes: the host's features, then the forward
    # on the card ending in the device→host copy of the logits
    from melogan_torch.data.text_corpus import generate_text_corpus

    host_ms, device_ms = [], []
    for t in generate_text_corpus("eval", seed=0)[0][:TEXT_SPLIT_TEXTS]:
        t0 = time.perf_counter()
        feats = clf.features([t])
        t1 = time.perf_counter()
        clf._logits(feats)
        host_ms.append((t1 - t0) * 1e3)
        device_ms.append((time.perf_counter() - t1) * 1e3)
    measured = {"text-mlp": {"overall": own["accuracy"], "macro": macro_accuracy(own)},
                "lexicon": {"overall": lex["accuracy"], "macro": macro_accuracy(lex)}}
    runs = [text_mlp.train_text_classifier(epochs=TEXT_REPEAT_EPOCHS, device="cuda").state_dict()
            for _ in range(2)]
    bitwise = all(np.array_equal(runs[0][k], runs[1][k]) for k in runs[0])
    os.makedirs(TEXT_DIR, exist_ok=True)
    cache = os.path.join(TEXT_DIR, "text_mlp.ckpt")
    clf.save(cache)
    losses = stats["epoch_losses"]
    emit({"phase": "text_mlp", "steps": stats["steps"], "wall_s": wall, "data_s": stats["data_s"],
          "loop_s": stats["loop_s"], "steps_per_s": stats["steps"] / stats["loop_s"],
          "loss_first_epoch": float(losses[0]), "loss_last_epoch": float(losses[-1]),
          "eval_n": own["n"], "eval_s": eval_s, "measured": measured,
          "request_features_median_ms": float(np.median(host_ms)),
          "request_forward_median_ms": float(np.median(device_ms)),
          "per_emotion": {k: {e: v["accuracy"] for e, v in r["per_emotion"].items()}
                          for k, r in (("text-mlp", own), ("lexicon", lex))},
          "repeat_epochs": TEXT_REPEAT_EPOCHS, "repeat_bitwise": bitwise, "pinned": MEASURED_EVAL_ACCURACY},
         results)
    if not (measured["text-mlp"]["overall"] > measured["lexicon"]["overall"]
            and measured["text-mlp"]["macro"] > measured["lexicon"]["macro"]):
        raise SystemExit(f"text_mlp does not beat the lexicon: {measured}")
    if not bitwise:
        raise SystemExit("text_mlp: two trainings on the card differ")
    off = {k: v for k, v in measured.items()
           if {m: round(x, 3) for m, x in v.items()} != MEASURED_EVAL_ACCURACY[k]}
    if off:
        raise SystemExit(f"text_mlp: measured {off} differ from MEASURED_EVAL_ACCURACY "
                         f"{MEASURED_EVAL_ACCURACY} to 3 decimals")
    return {"cache": cache, "measured": measured, "clf": clf}


def write_safetensors(sd, path):
    """A ``.safetensors`` file of float32 tensors: an 8-byte little-endian
    header length, the JSON header, then the raw buffers."""
    import struct

    header, offset, blobs = {}, 0, []
    for name, t in sd.items():
        raw = t.detach().float().cpu().contiguous().numpy().tobytes()
        header[name] = {"dtype": "F32", "shape": list(t.shape), "data_offsets": [offset, offset + len(raw)]}
        offset += len(raw)
        blobs.append(raw)
    head = json.dumps(header).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)) + head)
        for raw in blobs:
            f.write(raw)


def write_roberta_base(torch, np):
    """Two directories of one random roberta-base-width checkpoint, N(0,
    0.02) weights (LayerNorm 1 and 0, biases 0) from a seeded generator:
    ``st`` holds ``model.safetensors``, ``bin`` ``pytorch_model.bin``; both
    a ``config.json`` with the 28 go_emotions labels and a hand-written
    WordLevel ``tokenizer.json`` over the text corpus's words."""
    from melogan_torch.data.text_corpus import generate_text_corpus
    from melogan_torch.models.roberta import RobertaConfig, RobertaForSequenceClassification

    cfg = RobertaConfig(**ROBERTA_BASE)
    gen = torch.Generator().manual_seed(0)
    sd = {}
    for name, p in RobertaForSequenceClassification(cfg).state_dict().items():
        if name.endswith("LayerNorm.weight"):
            sd[name] = torch.ones_like(p)
        elif name.endswith("bias"):
            sd[name] = torch.zeros_like(p)
        else:
            sd[name] = torch.empty_like(p).normal_(0.0, 0.02, generator=gen)
    texts, _ = generate_text_corpus("train", seed=0)
    words = sorted({w for t in texts for w in t.split() if w.isalpha()})
    vocab = {"<s>": 0, "<pad>": 1, "</s>": 2, "<unk>": 3, **{w: 4 + i for i, w in enumerate(words)}}
    config = {"architectures": ["RobertaForSequenceClassification"], "model_type": "roberta",
              **ROBERTA_BASE, "type_vocab_size": 1, "layer_norm_eps": 1e-5, "pad_token_id": 1,
              "bos_token_id": 0, "eos_token_id": 2, "id2label": {str(i): l for i, l in enumerate(GO_EMOTIONS)},
              "label2id": {l: i for i, l in enumerate(GO_EMOTIONS)}}
    tokenizer = {"version": "1.0", "model": {"type": "WordLevel", "vocab": vocab, "unk_token": "<unk>"},
                 "pre_tokenizer": {"type": "Whitespace"},
                 "post_processor": {"type": "TemplateProcessing", "single": [
                     {"SpecialToken": {"id": "<s>", "type_id": 0}}, {"Sequence": {"id": "A", "type_id": 0}},
                     {"SpecialToken": {"id": "</s>", "type_id": 0}}]}}
    dirs = {k: os.path.join(TEXT_DIR, f"roberta_base_{k}") for k in ("st", "bin")}
    t0 = time.perf_counter()
    for kind, d in dirs.items():
        os.makedirs(d, exist_ok=True)
        for fname, obj in (("config.json", config), ("tokenizer.json", tokenizer)):
            with open(os.path.join(d, fname), "w") as f:
                json.dump(obj, f)
        if kind == "st":
            write_safetensors(sd, os.path.join(d, "model.safetensors"))
        else:
            torch.save(sd, os.path.join(d, "pytorch_model.bin"))
    return cfg, sd, dirs, words, time.perf_counter() - t0


def drive_roberta(torch, np, results):
    """``roberta``: the random roberta-base checkpoint written both ways and
    loaded both ways (equal parameters); the card's logits against the same
    module on the CPU; one ``__call__`` at B=1 in the 16, 64 and 512
    buckets, and the forward at B=64, T=128 beside its bound (operations
    over 67 TFLOP/s: f32 with TF32 off)."""
    from melogan_torch.models.roberta import (
        RobertaForSequenceClassification,
        RobertaTextClassifier,
        load_hf_checkpoint,
    )

    cfg, sd, dirs, words, write_s = write_roberta_base(torch, np)
    t0 = time.perf_counter()
    loaded = {k: load_hf_checkpoint(d) for k, d in dirs.items()}
    load_s = time.perf_counter() - t0
    if sorted(loaded["st"]) != sorted(sd) or any(
            not torch.equal(loaded["st"][k], sd[k]) or not torch.equal(loaded["bin"][k], sd[k]) for k in sd):
        raise SystemExit("roberta: model.safetensors and pytorch_model.bin load different parameters")
    t0 = time.perf_counter()
    clf = RobertaTextClassifier(dirs["st"], device="cuda")
    init_s = time.perf_counter() - t0
    if next(clf.model.parameters()).device.type != "cuda":
        raise SystemExit("roberta: the classifier is not on the card")
    n_params = sum(p.numel() for p in clf.model.parameters())

    cpu = RobertaForSequenceClassification(cfg)
    cpu.load_state_dict(sd, strict=True)
    cpu.eval()
    texts = list(TEXT_PROBES.values()) + [" ".join(words[:40])]
    ids, mask = clf.encode(texts)
    with torch.inference_mode():
        card = clf.model(torch.from_numpy(ids).cuda(), torch.from_numpy(mask).cuda()).cpu()
        ref = cpu(torch.from_numpy(ids), torch.from_numpy(mask))
    err, rel = compare(card, ref, "roberta logits card vs CPU")

    calls = {}
    for bucket in ROBERTA_BUCKETS:
        text = " ".join(words[i % len(words)] for i in range(bucket - 2))  # + <s> </s>: the bucket
        if clf.encode([text])[0].shape[1] != bucket:
            raise SystemExit(f"roberta: a {bucket - 2}-word text did not land in the {bucket} bucket")
        clf(text)
        walls = []
        for _ in range(ROBERTA_CALLS):
            t0 = time.perf_counter()
            out = clf(text)  # ends in a device→host copy of the logits
            walls.append((time.perf_counter() - t0) * 1e3)
        if out[0][0]["label"] not in GO_EMOTIONS:
            raise SystemExit(f"roberta: label {out}")
        enc_ms, fwd_ms = [], []
        for _ in range(ROBERTA_CALLS):
            t0 = time.perf_counter()
            ids, mask = clf.encode([text])
            t1 = time.perf_counter()
            with torch.inference_mode():
                clf.model(torch.from_numpy(ids).cuda(), torch.from_numpy(mask).cuda()).cpu()
            enc_ms.append((t1 - t0) * 1e3)
            fwd_ms.append((time.perf_counter() - t1) * 1e3)
        calls[bucket] = {"median_ms": float(np.median(walls)), "min_ms": min(walls),
                         "tokenize_median_ms": float(np.median(enc_ms)),
                         "forward_median_ms": float(np.median(fwd_ms))}

    gen = torch.Generator(device="cuda").manual_seed(0)
    big_ids = torch.randint(4, cfg.vocab_size, (ROBERTA_BATCH, ROBERTA_SEQ), device="cuda", generator=gen)
    big_mask = torch.ones_like(big_ids)
    with torch.inference_mode():
        ms = time_ms(torch, lambda: clf.model(big_ids, big_mask), 10)
    h, inter, layers, t = cfg.hidden_size, cfg.intermediate_size, cfg.num_hidden_layers, ROBERTA_SEQ
    macs_per_token = layers * (4 * h * h + 2 * h * inter + 2 * t * h)
    flops = 2 * macs_per_token * ROBERTA_BATCH * t
    nbytes = 4 * n_params + 8 * 2 * ROBERTA_BATCH * t + 4 * ROBERTA_BATCH * cfg.num_labels
    fwd = {"batch": ROBERTA_BATCH, "seq": t, "ms": ms, "tflop": flops / 1e12,
           **bound(flops, nbytes, PEAK_F32_FLOPS)}
    emit({"phase": "roberta", "params": n_params, "write_s": write_s, "load_both_s": load_s,
          "classifier_init_s": init_s, "max_abs_err": err, "max_rel_err": rel,
          "call_b1": calls, "forward": fwd}, results)
    return {"dirs": dirs, "forward": fwd}


def drive_text_route(torch, np, text, roberta, results):
    """``text_route``: the port's server on the card with the text-mlp
    backend (its cache from ``text_mlp``), then with MELOGAN_TEXT_MODEL_DIR
    at the random roberta-base directory: for each emotion's probe text
    ``POST /get_text_emotion``, then ``POST /generate`` with the answer,
    which must be MIDI at that emotion's tempo; /healthz's text fields.
    Counted: the server's warm-up ``sample_notes`` and 8 ``/generate``."""
    from melogan_torch import EMOTIONS
    from melogan_torch.constants import EMOTION_BPM
    from melogan_torch.midi.midifile import read_midi
    from melogan_torch.models import text_emotion
    from melogan_torch.serving.app import create_server

    saved = {k: os.environ.get(k) for k in ("MELOGAN_TEXT_MLP_CACHE", "MELOGAN_TEXT_BACKEND",
                                            "MELOGAN_TEXT_MODEL_DIR")}
    os.environ["MELOGAN_TEXT_MLP_CACHE"] = text["cache"]
    os.environ.pop("MELOGAN_TEXT_BACKEND", None)
    os.environ.pop("MELOGAN_TEXT_MODEL_DIR", None)
    text_emotion.reset_backend()
    httpd, state = create_server("127.0.0.1", 0, workdir=os.path.join(WORK_DIR, "no_checkpoint"),
                                 device="cuda", sample_pool=False)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    rec = {"phase": "text_route"}
    try:
        base = f"http://127.0.0.1:{httpd.server_address[1]}"
        for backend in ("text-mlp", "torch-roberta"):
            if backend == "torch-roberta":
                os.environ["MELOGAN_TEXT_MODEL_DIR"] = roberta["dirs"]["st"]
            health = json.loads(http(base, "/healthz")[1])
            if health["text_backend"] != backend or not health["text_backend_note"] or (
                    backend == "text-mlp" and health["text_backend_accuracy"]
                    != text_emotion.MEASURED_EVAL_ACCURACY["text-mlp"]):
                raise SystemExit(f"text_route /healthz for {backend}: {health}")
            out = {"answers": {}, "text_ms": [], "generate_ms": []}
            for want, sentence in TEXT_PROBES.items():
                t0 = time.perf_counter()
                status, body = http(base, "/get_text_emotion", json.dumps({"text": sentence}).encode())
                out["text_ms"].append((time.perf_counter() - t0) * 1e3)
                emotion = json.loads(body).get("emotion")
                if status != 200 or emotion not in EMOTIONS or (backend == "text-mlp" and emotion != want):
                    raise SystemExit(f"text_route {backend}: {sentence!r} -> {status} {body[:200]!r}")
                t0 = time.perf_counter()
                status, midi = http(base, "/generate", json.dumps({"emotion": emotion}).encode())
                out["generate_ms"].append((time.perf_counter() - t0) * 1e3)
                song = read_midi(midi) if status == 200 and midi[:4] == b"MThd" else None
                if song is None or abs(song.initial_tempo - EMOTION_BPM[emotion]) > 0.01:
                    raise SystemExit(f"text_route {backend}: /generate {emotion} gave no valid MIDI")
                out["answers"][sentence] = emotion
            clf = text_emotion.load_classifier("cuda")
            if next(clf.model.parameters()).device.type != "cuda":
                raise SystemExit(f"text_route: the {backend} classifier is not on the card")
            out["first_text_ms"] = out["text_ms"][0]  # the first request loads the classifier
            out["text_median_ms"] = float(np.median(out["text_ms"][1:]))
            out["generate_median_ms"] = float(np.median(out["generate_ms"]))
            out["healthz"] = {k: health[k] for k in ("text_backend", "text_backend_accuracy",
                                                     "text_backend_note")}
            rec[backend] = out
        emit(rec, results)
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=30)
        state.close()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        text_emotion.reset_backend()
    return rec


TEXT_REPORT_KEYS = {"n", "accuracy", "chance", "per_emotion", "confusion"}
CEILING_KEYS = {"eval", "knn_ngram_ceiling", "train_self_accuracy", "misclassified_examples"}


def drive_cli_text_eval(text, results):
    """``cli_text_eval``: ``python -m melogan_torch text-eval --json
    --ceiling`` in a child process on the text_mlp phase's cache; JAX's
    report keys, and the text-mlp accuracy that phase measured."""
    env = dict(os.environ, MELOGAN_TEXT_MLP_CACHE=text["cache"])
    env.pop("MELOGAN_TEXT_BACKEND", None)
    env.pop("MELOGAN_TEXT_MODEL_DIR", None)
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "melogan_torch", "text-eval", "--json", "--ceiling"],
                       cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    os.makedirs(CLI_DIR, exist_ok=True)
    with open(os.path.join(CLI_DIR, "text_eval.log"), "w") as f:
        f.write(r.stdout + r.stderr)
    if r.returncode != 0:
        raise SystemExit(f"python -m melogan_torch text-eval: rc {r.returncode}\n{r.stderr[-2000:]}")
    report = json.loads(r.stdout.strip().splitlines()[-1])
    if (set(report) != {"lexicon", "text-mlp", "ceiling"} or set(report["ceiling"]) != CEILING_KEYS
            or any(set(report[k]) != TEXT_REPORT_KEYS for k in ("lexicon", "text-mlp"))
            or "retraining" in r.stdout):
        raise SystemExit(f"text-eval report keys {_keys_of(report)}")
    if report["text-mlp"]["accuracy"] != text["measured"]["text-mlp"]["overall"]:
        raise SystemExit(f"text-eval text-mlp accuracy {report['text-mlp']['accuracy']} != the text_mlp "
                         f"phase's {text['measured']['text-mlp']['overall']}")
    emit({"phase": "cli_text_eval", "wall_s": wall, "accuracy": {k: report[k]["accuracy"]
                                                                 for k in ("lexicon", "text-mlp")},
          "knn_ngram_ceiling": report["ceiling"]["knn_ngram_ceiling"],
          "train_self_accuracy": report["ceiling"]["train_self_accuracy"]}, results)


def _keys_of(tree):
    return {k: _keys_of(v) for k, v in tree.items()} if isinstance(tree, dict) else type(tree).__name__


# ---------------------------------------------------------------------------
# the camera path: the res10 SSD, the mini-Xception FER, CameraEmotion, the
# native JPEG encoder, and the camera routes of the server
# ---------------------------------------------------------------------------

CAMERA_DIR = os.path.join(WORK_DIR, "camera")
# card against CPU for the camera models: both IEEE f32 (cuDNN with TF32 off),
# summed in other orders, about 1e-6 of scale; a wrong pad, tap or layout is O(1)
CAMERA_TOL_REL = 1e-5
CAMERA_SEED = 0
SSD_FLOPS = 2.249e9  # one 300x300 forward (XLA cost_analysis of the JAX SSD on the CPU)
SSD_BATCHES = (1, 8)
FER_BATCHES = (1, 64)
FER_FLOPS_B1 = 20.8e6  # one 64x64 crop (XLA cost_analysis of the JAX FER on the CPU)
CAMERA_CALLS = 30  # timed calls after a first
CAMERA_FRAME_HW = (240, 320)  # SyntheticFrameSource's and the crafted face frame's size
CAMERA_POST_HW = (96, 96)  # what the web page posts to /camera_frame
CAMERA_ROUTE_FRAMES = 8  # /camera_frame then /generate, each
JPEG_QUALITY = 80  # mjpeg_parts' default
JPEG_PY_CALLS = 3  # the Python encoder takes a tenth of a second or more a frame
VIDEO_PARTS = 10  # /video_feed parts read before the client closes
VIDEO_MAX_FPS = 20.0  # MELOGAN_VIDEO_MAX_FPS's default
Y4M_FRAMES = 4


def crafted_ssd_params():
    """Hand-crafted res10-SSD weights in the JAX package's tree (numpy,
    conv weights HWIO) that detect bright regions: the input scale maps BGR
    to a positive brightness, every residual stage passes the per-pixel mean
    brightness through its expand/identity path (centre-tap averaging
    kernels, every other conv zero), the fc7 conf head turns brightness v
    into a face logit 6v − 3 for its first prior only, and the loc heads are
    zero, so a detection is the prior centred on the brightest 19×19 cell.
    The construction of ``tests/test_emotion_models.py``'s crafted detector
    (held equal to it by ``tests/test_torch_camera.py``)."""
    import numpy as np

    from melogan_torch.models import ssd

    params = {}
    for name, cin, cout, k, _s, _p, _d, bias in ssd.CONV_SPECS:
        params[name] = {"w": np.zeros((k, k, cin, cout), np.float32)}
        if bias:
            params[name]["b"] = np.zeros((cout,), np.float32)
    for bn, sc, ch in ssd.BN_SPECS:
        params[bn] = {"mean": np.zeros(ch, np.float32), "var": np.ones(ch, np.float32)}
        params[sc] = {"gamma": np.ones(ch, np.float32), "beta": np.zeros(ch, np.float32)}
    params["conv4_3_norm"] = {"scale": np.full((128,), 20.0, np.float32)}
    params["data_scale"]["gamma"][:] = 1.0 / 255.0  # brightness (x − mean)/255 + 0.7
    params["data_scale"]["beta"][:] = 0.7
    params["conv1_h"]["w"][3, 3, :, :] = 1.0 / 3.0
    params["layer_64_1_conv1_h"]["w"][1, 1, :, :] = 1.0 / 32.0
    params["layer_128_1_conv_expand_h"]["w"][0, 0, :, :] = 1.0 / 32.0
    params["layer_256_1_conv_expand"]["w"][0, 0, :, :] = 1.0 / 128.0
    params["layer_512_1_conv_expand_h"]["w"][0, 0, :, :] = 1.0 / 256.0
    conf = params["fc7_mbox_conf"]
    conf["w"][1, 1, :, 1] = 6.0 / 256.0
    conf["b"][1] = -3.0
    for c in range(3, conf["b"].shape[0], 2):
        conf["b"][c] = -10.0  # the other priors' face channels never fire
    for head in ("conv4_3_norm", "conv6_2", "conv7_2", "conv8_2", "conv9_2"):
        params[f"{head}_mbox_conf"]["b"][1::2] = -10.0
    return params


def face_frame():
    """A dark 240×320 BGR frame with a bright 120×120 square at rows 60–180,
    columns 100–220 (relative x 0.3125–0.6875, y 0.25–0.75)."""
    import numpy as np

    frame = np.full((*CAMERA_FRAME_HW, 3), 20.0, np.float32)
    frame[60:180, 100:220, :] = 255.0
    return frame


def random_keras_weights(seed=0):
    """Random mini-Xception weights under the Keras names that
    ``load_mini_xception_weights`` gives (He-normal kernels, BN statistics
    away from the identity), so the probabilities are not degenerate."""
    import numpy as np

    from melogan_torch.models import xception

    rng = np.random.default_rng(seed)
    w = {}

    def kernel(name, shape):
        # a depthwise kernel (H, W, Cin, 1) sums H·W taps, any other all but its last axis
        fan_in = shape[0] * shape[1] * (1 if name.endswith("depthwise_kernel") else shape[2])
        w[name] = rng.normal(0.0, (2.0 / fan_in) ** 0.5, shape).astype(np.float32)

    def bn(i, c):
        w[f"batch_normalization_{i}/gamma"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
        w[f"batch_normalization_{i}/beta"] = rng.normal(0.0, 0.1, c).astype(np.float32)
        w[f"batch_normalization_{i}/moving_mean"] = rng.normal(0.0, 0.1, c).astype(np.float32)
        w[f"batch_normalization_{i}/moving_variance"] = rng.uniform(0.5, 2.0, c).astype(np.float32)

    kernel("conv2d_1/kernel", (3, 3, 1, 8))
    bn(1, 8)
    kernel("conv2d_2/kernel", (3, 3, 8, 8))
    bn(2, 8)
    cin = 8
    for i, f in xception._BLOCKS:
        kernel(f"conv2d_{i + 2}/kernel", (1, 1, cin, f))
        bn(3 * i, f)
        kernel(f"separable_conv2d_{2 * i - 1}/depthwise_kernel", (3, 3, cin, 1))
        kernel(f"separable_conv2d_{2 * i - 1}/pointwise_kernel", (1, 1, cin, f))
        bn(3 * i + 1, f)
        kernel(f"separable_conv2d_{2 * i}/depthwise_kernel", (3, 3, f, 1))
        kernel(f"separable_conv2d_{2 * i}/pointwise_kernel", (1, 1, f, f))
        bn(3 * i + 2, f)
        cin = f
    kernel("conv2d_7/kernel", (3, 3, cin, 7))
    w["conv2d_7/kernel"] *= 0.1  # a head at a tenth of He's scale: probabilities short of one-hot
    w["conv2d_7/bias"] = rng.normal(0.0, 0.1, 7).astype(np.float32)
    return w


def _median_ms(fn, calls=CAMERA_CALLS):
    """Host-clock median (ms) of ``calls`` calls after a first; ``fn`` ends
    in a device→host copy or a synchronize."""
    import numpy as np

    fn()
    walls = []
    for _ in range(calls):
        t0 = time.perf_counter()
        fn()
        walls.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(walls))


def _nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def drive_camera_models(torch, np, results):
    """``camera_models``: the SSD at 300×300 on the card against the same
    weights on the CPU (seeded, then the crafted detector written as a
    ``.caffemodel`` by the port's writer and read back); the crafted
    detector finding the bright square of a 240×320 frame; ``detect()``'s
    median split into resize + forward, device→host copy and host NMS, with
    a trace of one call; the forward at B=1 and 8 beside its bound; the FER
    at B=1 and 64 against the CPU, timed; ``CameraEmotion`` over both on the
    card against the CPU; the native JPEG encoder built, byte-equal to the
    Python one, both timed on a 320×240 frame. No kernel of the port runs."""
    from melogan_torch.camera import CameraEmotion
    from melogan_torch.imaging import jpeg, native
    from melogan_torch.models import caffe, ssd, xception
    from melogan_torch.profile_train import kernel_table
    from melogan_torch.serving.video import SyntheticFrameSource

    os.makedirs(CAMERA_DIR, exist_ok=True)
    rec = {"phase": "camera_models", "tol_rel": CAMERA_TOL_REL}
    rng = np.random.default_rng(CAMERA_SEED)
    x = torch.from_numpy(rng.uniform(-128, 128, (1, 300, 300, 3)).astype(np.float32))
    crafted_path = os.path.join(CAMERA_DIR, "crafted.caffemodel")
    caffe.write_caffemodel(crafted_path, ssd.to_caffe_layers(crafted_ssd_params()))
    dets = {}
    for name, make in (("seeded", lambda dev: ssd.FaceDetector(seed=CAMERA_SEED, device=dev)),
                       ("crafted", lambda dev: ssd.FaceDetector.from_caffemodel(crafted_path, device=dev))):
        card, cpu = make("cuda"), make("cpu")
        if next(card.net.parameters()).device.type != "cuda":
            raise SystemExit(f"camera_models: the {name} SSD is not on the card")
        with torch.inference_mode():
            got, want = card.net(x.cuda()), cpu.net(x)
        errs = [compare(g.cpu(), w, f"SSD {name} {k} card vs CPU", CAMERA_TOL_REL)
                for g, w, k in zip(got, want, ("loc", "conf"))]
        rec[f"ssd_{name}_max_rel_err"] = max(r for _e, r in errs)
        rec[f"ssd_{name}_max_abs_err"] = max(e for e, _r in errs)
        dets[name] = (card, cpu)

    det, det_cpu = dets["crafted"]
    frame = face_frame()
    rows = det.detect(frame, conf_threshold=0.5)
    if rows.shape[0] < 1:
        raise SystemExit("camera_models: the crafted detector found nothing on the card")
    best = rows[np.argmax(rows[:, 2])]
    cx, cy = (best[3] + best[5]) / 2, (best[4] + best[6]) / 2
    if not (best[2] > 0.85 and 0.3125 < cx < 0.6875 and 0.25 < cy < 0.75):
        raise SystemExit(f"camera_models: the crafted detector's best row {best} is not the bright square")
    cpu_rows = det_cpu.detect(frame, conf_threshold=0.5)
    if cpu_rows.shape != rows.shape or np.abs(cpu_rows - rows).max() > 1e-5:
        raise SystemExit(f"camera_models: detect rows card {rows} vs CPU {cpu_rows}")
    if det.detect(np.full_like(frame, 20.0), conf_threshold=0.5).shape[0]:
        raise SystemExit("camera_models: the crafted detector fired on a dark frame")
    rec["detect_rows"] = rows.tolist()

    # one detect() on a camera frame, split; each part ends where the next
    # one needs its result
    cam_frame = next(iter(SyntheticFrameSource(n_frames=1)))
    box = {}

    def device_part():
        box["dev"] = det.candidates(cam_frame)
        torch.cuda.synchronize()

    def copy_part():
        box["host"] = [t.cpu().numpy() for t in box["dev"]]

    def nms_part():
        det.rows(*box["host"])

    split = {"resize_forward_ms": _median_ms(device_part)}
    split["copy_ms"] = _median_ms(copy_part)
    split["nms_ms"] = _median_ms(nms_part)
    split["detect_ms"] = _median_ms(lambda: det.detect(cam_frame))
    trace = kernel_table(lambda: det.detect(cam_frame), 10, top=8)
    split["trace"] = {k: trace[k] for k in ("wall_ms_per_step", "device_ms_per_step", "kernels_per_step",
                                            "device_busy_share", "top")}
    rec["detect"] = split

    forward = {}
    for b in SSD_BATCHES:
        xb = torch.from_numpy(rng.uniform(-128, 128, (b, 300, 300, 3)).astype(np.float32)).cuda()
        with torch.inference_mode():
            out = det.net(xb)
            ms = time_ms(torch, lambda: det.net(xb), CAMERA_CALLS)
        nbytes = _nbytes(xb, *out, *det.net.state_dict().values())
        forward[b] = {"ms": ms, **bound(SSD_FLOPS * b, nbytes, PEAK_F32_FLOPS),
                      "device_kernels_per_call": _device_kernels(torch, lambda: det.net(xb))}
    rec["ssd_forward"] = forward

    keras = random_keras_weights(seed=CAMERA_SEED)
    fer, fer_cpu = xception.FERClassifier(keras, device="cuda"), xception.FERClassifier(keras, device="cpu")
    fer_rec = {}
    for b in FER_BATCHES:
        crops = rng.uniform(0, 255, (b, 64, 64, 1)).astype(np.float32)
        xc = torch.from_numpy(crops).cuda()
        err, rel = compare(fer.run(xc).cpu(), fer_cpu.run(torch.from_numpy(crops)), f"FER B={b} card vs CPU",
                           CAMERA_TOL_REL)
        fer_rec[b] = {"max_abs_err": err, "max_rel_err": rel, "ms": time_ms(torch, lambda: fer.run(xc), CAMERA_CALLS),
                      "device_kernels_per_call": _device_kernels(torch, lambda: fer.run(xc)),
                      "predict_proba_ms": _median_ms(lambda: fer.predict_proba(crops[..., 0])),
                      **bound(FER_FLOPS_B1 * b, _nbytes(xc, *fer.net.state_dict().values()) + 4 * 7 * b,
                              PEAK_F32_FLOPS)}
    rec["fer"] = fer_rec

    cam, cam_cpu = CameraEmotion(fer=fer, face_detector=det), CameraEmotion(fer=fer_cpu, face_detector=det_cpu)
    emotion = cam.process_frame(frame)
    if emotion != cam_cpu.process_frame(frame) or cam.last_box != cam_cpu.last_box:
        raise SystemExit(f"CameraEmotion card {emotion} {cam.last_box} vs CPU {cam_cpu.current_emotion} "
                         f"{cam_cpu.last_box}")
    x1, y1, x2, y2 = cam.last_box
    if not (100 <= (x1 + x2) / 2 <= 220 and 60 <= (y1 + y2) / 2 <= 180):
        raise SystemExit(f"CameraEmotion's box {cam.last_box} is not on the bright square")
    rec["camera_emotion"] = {"emotion": emotion, "box": list(cam.last_box),
                             "process_frame_ms": _median_ms(lambda: cam.process_frame(cam_frame))}

    # the first call on a fresh thread (as each request of the stdlib server
    # is): straight to the device, and through the model's worker thread
    crop = rng.uniform(0, 255, CAMERA_POST_HW).astype(np.float32)
    xcrop = torch.from_numpy(xception._host_resize_bilinear(crop[None, ..., None], 64))
    rec["fresh_thread_ms"] = {
        "fer_direct": _fresh_thread_ms(lambda: fer.run(xcrop.cuda()).cpu()),
        "fer_worker": _fresh_thread_ms(lambda: fer.predict_proba(crop[None])),
        "ssd_direct": _fresh_thread_ms(lambda: [t.cpu() for t in det.candidates(cam_frame)]),
        "ssd_worker": _fresh_thread_ms(lambda: det.detect(cam_frame))}

    lib = native.build()  # raises with g++'s output; the card's machine has g++ (nvcc needs it)
    if native.get_lib() is None:
        raise SystemExit(f"native JPEG: {lib} does not load: {native.load_error()}")
    native_bytes = native.encode_jpeg_native(cam_frame, JPEG_QUALITY)
    if native_bytes != jpeg._encode_jpeg_py(cam_frame, JPEG_QUALITY) or jpeg.encode_jpeg(
            cam_frame, JPEG_QUALITY) != native_bytes:
        raise SystemExit("native JPEG: bytes differ from the Python encoder's")
    rec["jpeg"] = {"library": os.path.relpath(lib, ROOT), "bytes": len(native_bytes),
                   "native_ms": _median_ms(lambda: native.encode_jpeg_native(cam_frame, JPEG_QUALITY)),
                   "python_ms": _median_ms(lambda: jpeg._encode_jpeg_py(cam_frame, JPEG_QUALITY),
                                           calls=JPEG_PY_CALLS)}
    for model in (fer, fer_cpu, *dets["seeded"], det, det_cpu):
        model.close()
    emit(rec, results)
    return {"keras": keras, "record": rec}


def _fresh_thread_ms(fn, threads=5):
    """The median ms of ``fn``'s first call on each of ``threads`` new threads."""
    import numpy as np

    walls = []
    for _ in range(threads):
        box = {}

        def run():
            t0 = time.perf_counter()
            fn()
            box["ms"] = (time.perf_counter() - t0) * 1e3

        t = threading.Thread(target=run)
        t.start()
        t.join(timeout=120)
        walls.append(box["ms"])
    return float(np.median(walls))


def _device_kernels(torch, fn):
    from melogan_torch.profile_sample import device_kernels_per_call

    with torch.inference_mode():
        return device_kernels_per_call(fn)


def _handler_mean_ms(text):
    """Mean handler ms by route from the server's /metrics text."""
    sums, counts = {}, {}
    for line in text.splitlines():
        for suffix, into in (("_sum", sums), ("_count", counts)):
            head = f"melogan_http_request_duration_seconds{suffix}{{route=\""
            if line.startswith(head):
                route, value = line[len(head):].split("\"} ")
                into[route] = float(value)
    return {r: 1e3 * sums[r] / counts[r] for r in sums if counts.get(r)}


def _read_parts(resp, n):
    """``n`` multipart parts of an MJPEG stream, with the client's clock at
    each; every part must be one JPEG, SOI to EOI."""
    parts = []
    for _ in range(n):
        if resp.readline() != b"--frame\r\n":
            raise SystemExit("/video_feed: no boundary where a part should start")
        headers = {}
        while True:
            line = resp.readline()
            if line in (b"\r\n", b""):
                break
            k, _, v = line.decode().partition(":")
            headers[k.strip().lower()] = v.strip()
        data = resp.read(int(headers["content-length"]))
        resp.readline()  # the CRLF after the payload
        if headers.get("content-type") != "image/jpeg" or data[:2] != b"\xff\xd8" or data[-2:] != b"\xff\xd9":
            raise SystemExit(f"/video_feed: part {len(parts)} is not one JPEG ({headers})")
        parts.append((time.perf_counter(), data))
    return parts


def drive_camera_route(torch, np, camera, results):
    """``camera_route``: ``create_server(camera_source="synthetic")`` on the
    card with a random FER injected; for each of 8 frames of the web page's
    size, ``POST /camera_frame``, ``GET /get_camera_emotion`` (the same
    answer) and ``POST /generate`` with it (MIDI at that emotion's tempo);
    ``GET /video_feed`` read for 10 parts, then closed (frames/s against the
    20 fps cap; the camera emotion set); ``/healthz``'s camera fields. Then
    a second server on a ``.y4m`` file written by ``write_y4m``, its
    stream read past the clip's end. Counted: the two servers' warm-up
    ``sample_notes`` and the 8 ``/generate``."""
    from melogan_torch import EMOTIONS
    from melogan_torch.camera import CameraEmotion
    from melogan_torch.constants import EMOTION_BPM
    from melogan_torch.imaging.y4m import write_y4m
    from melogan_torch.midi.midifile import read_midi
    from melogan_torch.models import xception
    from melogan_torch.serving.app import create_server
    from melogan_torch.serving.video import SyntheticFrameSource

    clip = os.path.join(CAMERA_DIR, "synthetic.y4m")
    with open(clip, "wb") as f:
        write_y4m(f, list(SyntheticFrameSource(n_frames=Y4M_FRAMES)), colorspace="420")
    fer_cpu = xception.FERClassifier(camera["keras"], device="cpu")
    rng = np.random.default_rng(CAMERA_SEED + 1)
    rec = {"phase": "camera_route"}
    for source in ("synthetic", clip):
        httpd, state = create_server("127.0.0.1", 0, workdir=os.path.join(WORK_DIR, "no_checkpoint"),
                                     device="cuda", sample_pool=False, camera_source=source)
        state.camera = xception.FERClassifier(camera["keras"], device="cuda")
        state.camera_pipeline = CameraEmotion(fer=state.camera)
        thread = threading.Thread(target=httpd.serve_forever, daemon=True)
        thread.start()
        try:
            base = f"http://127.0.0.1:{httpd.server_address[1]}"
            out = {}
            health = json.loads(http(base, "/healthz")[1])
            if (health["camera_backend"] != "xception" or health["video_feed"] is not True
                    or health["device"]["platform"] != "gpu"):
                raise SystemExit(f"camera_route /healthz: {health}")
            if source == "synthetic":
                out.update(frame_ms=[], generate_ms=[], answers=[])
                for _ in range(CAMERA_ROUTE_FRAMES):
                    frame = rng.uniform(0, 255, CAMERA_POST_HW)
                    payload = json.dumps({"frame": frame.tolist()}).encode()  # the page's work
                    t0 = time.perf_counter()
                    status, body = http(base, "/camera_frame", payload)
                    out["frame_ms"].append((time.perf_counter() - t0) * 1e3)
                    emotion = json.loads(body).get("emotion")
                    if status != 200 or emotion != fer_cpu.predict_emotion(frame.astype(np.float32)):
                        raise SystemExit(f"/camera_frame: {status} {body[:200]!r}, the CPU FER says "
                                         f"{fer_cpu.predict_emotion(frame.astype(np.float32))}")
                    if json.loads(http(base, "/get_camera_emotion")[1]) != {"emotion": emotion}:
                        raise SystemExit("/get_camera_emotion differs from /camera_frame's answer")
                    t0 = time.perf_counter()
                    status, midi = http(base, "/generate", json.dumps({"emotion": emotion}).encode())
                    out["generate_ms"].append((time.perf_counter() - t0) * 1e3)
                    song = read_midi(midi) if status == 200 and midi[:4] == b"MThd" else None
                    if song is None or abs(song.initial_tempo - EMOTION_BPM[emotion]) > 0.01:
                        raise SystemExit(f"camera_route: /generate {emotion} gave no valid MIDI")
                    out["answers"].append(emotion)
                # where a /camera_frame goes: the handler's mean (from
                # /metrics), and in it the JSON parse and the FER's call
                handler = _handler_mean_ms(state.metrics.render())
                frame32 = frame.astype(np.float32)
                out["split"] = {"payload_kb": len(payload) / 1024, "handler_mean_ms": handler,
                                "json_parse_ms": _median_ms(lambda: np.asarray(json.loads(payload)["frame"],
                                                                               dtype=np.float32)),
                                "fer_ms": _median_ms(lambda: state.camera.predict_emotion(frame32))}
                out["frame_median_ms"] = float(np.median(out["frame_ms"]))
                out["generate_median_ms"] = float(np.median(out["generate_ms"]))
                out["route_median_ms"] = float(np.median(np.add(out["frame_ms"], out["generate_ms"])))
                n_parts = VIDEO_PARTS
            else:
                n_parts = 2 * Y4M_FRAMES  # past the clip's end: the source loops
            state.camera_emotion = "unset"
            t0 = time.perf_counter()
            resp = urllib.request.urlopen(base + "/video_feed", timeout=120)
            try:
                if not resp.headers["Content-Type"].startswith("multipart/x-mixed-replace"):
                    raise SystemExit(f"/video_feed: {resp.headers['Content-Type']}")
                parts = _read_parts(resp, n_parts)
            finally:
                resp.close()
            # from the second part on: the first frame's work (the FER's
            # first call) delays it, and the parts after it keep the cap's schedule
            times = [t for t, _ in parts[1:]]
            fps = (len(times) - 1) / (times[-1] - times[0])
            if fps > VIDEO_MAX_FPS * 1.05:
                raise SystemExit(f"/video_feed: {fps:.1f} frames/s over the {VIDEO_MAX_FPS:g} fps cap")
            if state.camera_emotion not in EMOTIONS:
                raise SystemExit(f"/video_feed did not set the camera emotion ({state.camera_emotion!r})")
            out.update(video_parts=len(parts), video_fps=fps, first_part_ms=(parts[0][0] - t0) * 1e3,
                       part_kb=float(np.mean([len(d) for _, d in parts])) / 1024,
                       camera_emotion=state.camera_emotion,
                       healthz={k: health[k] for k in ("camera_backend", "video_feed")})
            rec["synthetic" if source == "synthetic" else "y4m"] = out
        finally:
            httpd.shutdown()
            httpd.server_close()
            thread.join(timeout=30)
            # as serve() drains: the stream's thread ends at its first write
            # after the client hung up, and its frames need the FER until then
            deadline = time.monotonic() + 10
            while state.inflight() > 0 and time.monotonic() < deadline:
                time.sleep(0.05)
            state.close()
    emit(rec, results)
    return rec


# data parallelism (melogan_torch/parallel): dp_train holds a GANConfig() group step from a
# perturbed critic, then a VAE and an ED epoch at the shipped widths, plain, on one NCCL rank
# (--dp 1, bit for bit) and on two gloo ranks sharing the card (the CPU tests' tolerances)
DP_STEPS = 5  # timed group steps after a first, each run
DP_PROFILED_STEPS = 2  # group steps traced on the gloo ranks for the all-reduce's share
# an epoch of one step (batch 32, 64) and one validation batch: the first moments after one
# update read the gradients; after a second, the ±lr moves of the first have changed them
DP_VAE_ROWS, DP_ED_ROWS, DP_VAL_ROWS = 32, 64, 32
DP_TIMEOUT = 600  # seconds before the two gloo ranks are killed
# Adam's first moments, of their module group's largest: 1e-4 at the shipped widths, as
# group_step_gpu_vs_cpu (five critic updates carry the reduction-order noise on; the CPU
# rehearsal of this phase read 2.2e-5 on the critic, the tiny CPU tests hold 1e-5); the VAE's
# and ED's one-step epochs too (3.0e-7 and 7.2e-7 on the H100)
DP_GRAD_REL = 1e-4
DP_REL = 1e-4  # metrics, of their scale
DP_SAMPLE_ATOL = 1e-5  # a sampler over two shards against one, as test_sharded_sampler_matches_one_device


def _np_sd(module):
    return {k: v.detach().cpu().numpy().copy() for k, v in module.state_dict().items()}


def dp_program(mesh, spec):
    """One rank of ``dp_train`` (``mesh`` None: the plain run, in this
    process): the group step from ``spec``'s perturbed state with its
    draws, then ``DP_STEPS`` timed group steps with the state's own draws
    (traced on two ranks: the all-reduce's share), then ``vae_loop.train``
    and ``ed_loop.train`` for one epoch. Returns numpy results and this
    process's kernel launches."""
    import numpy as np
    import torch

    from melogan_torch.config import AEConfig, EDConfig, GANConfig
    from melogan_torch.data.datasets import SplitData
    from melogan_torch.ops import conv1d, convt, decoder
    from melogan_torch.parallel.mesh import tree_map
    from melogan_torch.train import ed_loop, gan_step, vae_loop

    t_start = time.perf_counter()
    wrappers = {"decoder_tail": decoder.decoder_tail_cuda, "convt1d": convt.convt1d_cuda,
                "conv1d": conv1d.conv1d_cuda}
    before = {k: w.launches for k, w in wrappers.items()}
    dev = torch.device("cuda") if mesh is None else mesh.device
    tag = "plain" if mesh is None else f"world{mesh.data}"
    cfg, ed_cfg = GANConfig(), EDConfig()
    state = gan_step.init_state(cfg, gan_step.build_models(cfg, ed_cfg), seed=3, device=dev)
    for name, sd in spec["modules"].items():
        getattr(state, name).load_state_dict({k: torch.as_tensor(v) for k, v in sd.items()})
    steps = gan_step.make_train_steps(cfg, mesh=mesh)
    batches, draws = tree_map(lambda t: t.to(dev), spec["group"])
    state, m = steps.group(state, batches, draws)
    out = {"metrics": {k: float(v) for k, v in m.items()},
           "modules": {n: _np_sd(getattr(state, n)) for n in ("generator", "critic", "feature_encoder")},
           "exp_avg": {f"{g}.{n}": getattr(state, opt).state[p]["exp_avg"].cpu().numpy().copy()
                       for g, mod, opt in (("G", state.generator, "opt_g"),
                                           ("FE", state.feature_encoder, "opt_g"),
                                           ("D", state.critic, "opt_d"))
                       for n, p in mod.named_parameters()}}
    walls = []
    for _ in range(DP_STEPS + 1):
        t0 = time.perf_counter()
        state, _ = steps.group(state, batches)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    out["step_ms"] = walls[1:]
    if mesh is not None and mesh.data > 1:
        from torch.profiler import ProfilerActivity, profile

        profiled = {k: w.launches for k, w in wrappers.items()}
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(DP_PROFILED_STEPS):
                state, _ = steps.group(state, batches)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        # the traced steps' launches are left out of this rank's count, which must equal the plain run's
        before = {k: before[k] + w.launches - profiled[k] for k, w in wrappers.items()}
        coll = {e.key: {"host_ms": e.cpu_time_total / 1e3, "calls": e.count} for e in prof.key_averages()
                if e.key == "dp.all_reduce" or "allreduce" in e.key.lower() or "all_reduce" in e.key.lower()}
        # the spans' durations as the Chrome trace holds them (host side, "user_annotation")
        trace = os.path.join(spec["workdir"], f"trace_rank{mesh.rank}.json")
        prof.export_chrome_trace(trace)
        with open(trace) as f:
            events = json.load(f)["traceEvents"]
        spans = [e["dur"] for e in events if e.get("name") == "dp.all_reduce" and e.get("ph") == "X"
                 and e.get("cat") == "user_annotation"]
        span = sum(spans) / 1e3
        gpu_span = sum(e["dur"] for e in events if e.get("name") == "dp.all_reduce" and e.get("ph") == "X"
                       and e.get("cat") == "gpu_user_annotation") / 1e3
        # the reductions of one group step alone, on idle gradient-shaped buffers: the bytes'
        # own cost, without the wait for the device work queued before them
        grads = {"critic": [torch.zeros_like(p) for p in state.critic.parameters()],
                 "gen": [torch.zeros_like(p) for p in list(state.generator.parameters())
                         + list(state.feature_encoder.parameters())]}
        torch.cuda.synchronize()
        mesh.barrier()  # the ranks leave the trace's export at different times
        t0 = time.perf_counter()
        for _ in range(DP_PROFILED_STEPS):
            for _ in range(cfg.critic_iters):
                mesh.all_reduce_mean_(grads["critic"])
            mesh.all_reduce_mean_(grads["gen"])
        torch.cuda.synchronize()
        out["profile"] = {"steps": DP_PROFILED_STEPS, "wall_ms": wall, "collectives": coll,
                          "span_ms": span, "span_calls": len(spans), "gpu_span_ms": gpu_span,
                          "grad_allreduce_ms": (time.perf_counter() - t0) * 1e3}
    vae_tr, vae_va, ed_tr, ed_va = (SplitData(*a) for a in spec["data"])
    t0 = time.perf_counter()
    best, vm = vae_loop.train(AEConfig(epochs=1, recon_save_count=0), vae_tr, vae_va,
                              workdir=os.path.join(spec["workdir"], f"vae_{tag}"), verbose=False,
                              recon_dumps=False, mesh=mesh, device=dev)
    out["vae"] = {"model": _np_sd(best.model), "metrics": vm, "wall_s": time.perf_counter() - t0,
                  **_adam_first_moments(best.opt)}
    t0 = time.perf_counter()
    best, em = ed_loop.train(EDConfig(num_epochs=1), ed_tr, ed_va,
                             workdir=os.path.join(spec["workdir"], f"ed_{tag}"), verbose=False,
                             mesh=mesh, device=dev)
    out["ed"] = {"model": _np_sd(best.model), "metrics": em, "wall_s": time.perf_counter() - t0,
                 **_adam_first_moments(best.opt)}
    out["launches"] = {k: w.launches - before[k] for k, w in wrappers.items()}
    out["program_s"] = time.perf_counter() - t_start
    return out


def _adam_first_moments(opt):
    """A VAE or ED optimizer's first moments by parameter name, and its
    update count."""
    sd = opt.state_dict()
    return {"mu": {k: v.detach().cpu().numpy().copy() for k, v in sd["mu"].items()}, "count": sd["count"]}


def dp_gan_run(mesh, workdir):
    """``gan_loop.train`` at the shipped widths for one epoch on the
    training phase's corpus (2 groups and a 2-batch tail), with ``mesh``:
    the final modules, history and step."""
    import numpy as np

    from melogan_torch.config import EDConfig, GANConfig
    from melogan_torch.train.gan_loop import train

    state, hist = train(GANConfig(save_freq=1), EDConfig(), make_corpus(np, CORPUS_ROWS), workdir=workdir,
                        epochs=1, verbose=False, mesh=mesh, device="cuda")
    return {"modules": {n: _np_sd(getattr(state, n)) for n in ("generator", "critic", "feature_encoder")},
            "history": {k: v for k, v in hist.items() if k != "epoch_seconds"}, "step": state.step}


def _tree_equal(a, b):
    return not _tree_diff(a, b)


def _tree_diff(a, b, where=""):
    """{path: max abs difference} of the leaves that differ (None where
    the keys or shapes differ); empty when ``a`` equals ``b`` bit for bit."""
    import numpy as np

    if isinstance(a, dict):
        if set(a) != set(b):
            return {where: None}
        out = {}
        for k in a:
            out.update(_tree_diff(a[k], b[k], f"{where}/{k}"))
        return out
    a, b = np.asarray(a), np.asarray(b)
    if a.shape != b.shape:
        return {where: None}
    if np.array_equal(a, b):
        return {}
    return {where: float(np.abs(a.astype(np.float64) - b.astype(np.float64)).max())}


def check_dp_two(np, cfg, plain, rank0, rank1):
    """Two gloo ranks against the plain run, with the tolerances of
    ``tests/test_torch_parallel.py`` (the moments' at the shipped widths:
    ``DP_GRAD_REL``); the worst errors."""
    from melogan_torch.config import AEConfig, EDConfig

    worst = {}
    if not _tree_equal(rank0["modules"], rank1["modules"]):
        raise SystemExit("dp_train: the two ranks' weights differ")
    for k, want in plain["metrics"].items():
        err = abs(rank0["metrics"][k] - want) / max(abs(want), 1e-30)
        worst[f"metric {k}"] = err
        if err > DP_REL:
            raise SystemExit(f"dp_train: metric {k} {rank0['metrics'][k]} vs plain {want}")
    lr = {"G": cfg.lr_g, "FE": cfg.lr_g, "D": cfg.lr_d}
    updates = {"G": 1, "FE": 1, "D": cfg.critic_iters}
    module_of = {"G": "generator", "FE": "feature_encoder", "D": "critic"}
    for group in ("G", "FE", "D"):
        mine, want = ({n.split(".", 1)[1]: v for n, v in r["exp_avg"].items() if n.split(".", 1)[0] == group}
                      for r in (rank0, plain))
        worst[f"{group} grad"], worst[f"{group} param"] = _check_adam(
            np, mine, want, rank0["modules"][module_of[group]], plain["modules"][module_of[group]],
            lr[group], updates[group], DP_GRAD_REL, 1e-4, group)
    # the one-step epochs' best states, with the group step's rule
    for what, key, lr_w in (("vae", "best_val", AEConfig().lr), ("ed", "val_loss", EDConfig().optimizer.lr)):
        a, b = rank0[what]["metrics"][key], plain[what]["metrics"][key]
        worst[f"{what} {key}"] = abs(a - b) / abs(b)
        if abs(a - b) > DP_REL * abs(b):
            raise SystemExit(f"dp_train: {what} {key} {a} vs plain {b}")
        if rank0[what]["count"] != plain[what]["count"] or plain[what]["count"] != 1:
            raise SystemExit(f"dp_train: {what} took {rank0[what]['count']} updates, plain {plain[what]['count']}")
        worst[f"{what} grad"], worst[f"{what} param"] = _check_adam(
            np, rank0[what]["mu"], plain[what]["mu"], rank0[what]["model"], plain[what]["model"],
            lr_w, plain[what]["count"], DP_GRAD_REL, 1e-4, what)
        if not _tree_equal(rank0[what]["model"], rank1[what]["model"]):
            raise SystemExit(f"dp_train: the two ranks' {what} weights differ")
    return worst


def _check_adam(np, ours_mu, want_mu, ours_p, want_p, lr, updates, grad_rel, big_rel, what, phase="dp_train"):
    """One module group after ``updates`` Adam steps against the plain run:
    every first moment within ``grad_rel`` of the group's largest, every
    parameter within 2·lr per update (an element whose true gradient is
    zero moves ±lr at random), and within 1e-6 per update where the plain
    first moment is above ``big_rel`` of the largest. Returns the worst
    moment error (of the largest) and the worst parameter error."""
    gmax = max(float(np.abs(v).max()) for v in want_mu.values())
    worst_g = worst_p = 0.0
    for n, mu in want_mu.items():
        gerr = float(np.abs(ours_mu[n] - mu).max())
        d = np.abs(np.asarray(ours_p[n], np.float64) - np.asarray(want_p[n], np.float64))
        big = np.abs(mu) > big_rel * gmax
        dbig = float(d[big].max()) if big.any() else 0.0
        worst_g, worst_p = max(worst_g, gerr / gmax), max(worst_p, float(d.max()))
        if gerr > grad_rel * gmax or float(d.max()) > 2 * lr * updates * (1 + 1e-3) or dbig > 1e-6 * updates:
            raise SystemExit(f"{phase}: {what} {n}: grad err {gerr:.3e} (group max {gmax:.3e}), "
                             f"param err {float(d.max()):.3e}, where the gradient is large {dbig:.3e}")
    return worst_g, worst_p


def drive_dp_train(torch, np, results):
    """``dp_train``: ``dp_program`` plain, on one NCCL rank in this process
    (``--dp 1``: every result bit for bit the plain run's, and a
    ``train()`` run beside a plain one, bit for bit) and on two gloo ranks
    on the one card (against the plain run, ``check_dp_two``); the step
    walls and the gloo ranks' all-reduce share."""
    import datetime

    from melogan_torch.config import EDConfig, GANConfig
    from melogan_torch.parallel import launch
    from melogan_torch.train import gan_step
    from melogan_torch.utils.flops import group_step_flops

    cfg, ed_cfg = GANConfig(), EDConfig()
    cpu = gan_step.init_state(cfg, gan_step.build_models(cfg, ed_cfg), seed=3, device="cpu")
    g = torch.Generator().manual_seed(5)
    with torch.no_grad():  # a critic away from its init, as check_group_step_against_cpu
        for m in cpu.critic.modules():
            if isinstance(m, (torch.nn.Conv1d, torch.nn.Linear)):
                m.weight.mul_(10.0)
                m.bias.copy_(0.05 * torch.randn(m.bias.shape, generator=g))
    (group,) = _batches_and_draws(torch, np, cfg, cpu.feature_encoder, 4, ["cpu"])
    splits = [make_corpus(np, n, seed=s) for n, s in ((DP_VAE_ROWS, 11), (DP_VAL_ROWS, 12),
                                                       (DP_ED_ROWS, 13), (DP_VAL_ROWS, 14))]
    spec = {"modules": {n: _np_sd(getattr(cpu, n)) for n in ("generator", "critic", "feature_encoder", "ed")},
            "group": group, "workdir": os.path.join(WORK_DIR, "dp"),
            "data": [(d.notes_raw, d.emotions, d.numeric, list(d.filenames)) for d in splits]}
    def compared(r):  # dp_program's results, less its walls
        return {"metrics": r["metrics"], "modules": r["modules"], "exp_avg": r["exp_avg"],
                **{w: {k: r[w][k] for k in ("model", "metrics", "mu", "count")} for w in ("vae", "ed")}}

    # the process's first run warms its caches; a second one is the plain run compared
    warm = dp_program(None, spec)
    t0 = time.perf_counter()
    plain = dp_program(None, spec)
    t1 = time.perf_counter()
    (one,) = launch.spawn(dp_program, 1, args=(spec,), device="cuda")
    t2 = time.perf_counter()
    repeat = _tree_diff(compared(plain), compared(warm))
    dp1 = _tree_diff(compared(one), compared(plain))
    if dp1:
        raise SystemExit(f"dp_train: --dp 1 not bit for bit the plain run: {dp1}; the plain run "
                         f"against its first repeat: {repeat}")
    run_plain = dp_gan_run(None, os.path.join(WORK_DIR, "dp", "gan_plain"))
    (run_one,) = launch.spawn(dp_gan_run, 1, args=(os.path.join(WORK_DIR, "dp", "gan_world1"),), device="cuda")
    if not _tree_equal(run_one, run_plain):
        raise SystemExit("dp_train: train() at --dp 1 not bit for bit the plain run")
    t3 = time.perf_counter()
    two = launch.spawn(dp_program, 2, args=(spec,), device="cuda", backend="gloo", timeout=DP_TIMEOUT,
                       rank_timeout=datetime.timedelta(seconds=DP_TIMEOUT))
    t4 = time.perf_counter()
    worst = check_dp_two(np, cfg, plain, two[0], two[1])
    # what the all-reduce carries a group step: critic_iters critic updates and one G + FE update,
    # each one flat float32 buffer of the gradients and, with them, no other tensor
    n_critic = sum(p.numel() for p in cpu.critic.parameters())
    n_gen = sum(p.numel() for p in cpu.generator.parameters()) + sum(
        p.numel() for p in cpu.feature_encoder.parameters())
    prof = two[0]["profile"]
    rec = {"phase": "dp_train",
           "plain_step_median_ms": float(np.median(plain["step_ms"])),
           "dp1_step_median_ms": float(np.median(one["step_ms"])),
           "gloo2_step_median_ms": [float(np.median(r["step_ms"])) for r in two],
           "plain_step_ms": plain["step_ms"], "dp1_step_ms": one["step_ms"],
           "gloo2_rank0_step_ms": two[0]["step_ms"],
           "group_step_flops": group_step_flops(cfg, ed_cfg),
           "allreduce_bytes_per_group_step": {"critic": 4 * n_critic, "critic_updates": cfg.critic_iters,
                                              "generator_and_fe": 4 * n_gen},
           "gloo2_profile": prof,
           # the dp.all_reduce spans of the traced steps (their wait for queued device work
           # included), and one step's gradient reductions alone, each over the step's wall
           "gloo2_allreduce_share": prof["span_ms"] / prof["wall_ms"],
           "gloo2_grad_allreduce_ms_per_step": prof["grad_allreduce_ms"] / prof["steps"],
           "gloo2_grad_allreduce_share": prof["grad_allreduce_ms"] / prof["steps"] / float(np.median(two[0]["step_ms"])),
           "dp1_collectives": "none: a data axis of 1 takes the one-device path",
           "plain_repeat_differs": repeat,
           "program_s": {"plain": plain["program_s"], "dp1": one["program_s"],
                         "gloo2": [r["program_s"] for r in two]},
           "epoch_wall_s": {w: {"vae": r["vae"]["wall_s"], "ed": r["ed"]["wall_s"]}
                            for w, r in (("plain", plain), ("dp1", one), ("gloo2_rank0", two[0]))},
           "launches_per_rank": {"plain": plain["launches"], "dp1": one["launches"],
                                 "gloo2": [r["launches"] for r in two]},
           "worst_vs_plain": worst,
           "wall_s": {"plain": t1 - t0, "dp1": t2 - t1, "gan_runs": t3 - t2, "gloo2": t4 - t3}}
    emit(rec, results)
    if any(r["launches"][k] <= 0 for r in two for k in ("conv1d", "convt1d")):
        raise SystemExit(f"dp_train: a gloo rank launched no conv kernel: {[r['launches'] for r in two]}")
    return rec


def drive_dp_sample(torch, np, results):
    """``dp_sample``: at batch 1, ``MAIN_BATCH`` and ``MAIN_BATCH`` - 1,
    ``Sampler(mesh=make_mesh(1))`` bit for bit the plain ``Sampler``, and a
    sampler over a local mesh of two shards on the one card (the split,
    an empty block at batch 1, an uneven split and the concatenation on the
    host) within ``DP_SAMPLE_ATOL`` of it, with one ``decoder_tail`` launch
    a non-empty block; then ``create_server(dp=1)`` answering four
    ``POST /generate`` and ``GET /healthz``."""
    from melogan_torch import EMOTIONS
    from melogan_torch.config import GANConfig
    from melogan_torch.ops import decoder
    from melogan_torch.parallel.mesh import Mesh, make_mesh
    from melogan_torch.sampling import Sampler
    from melogan_torch.serving.app import create_server

    plain = Sampler(GANConfig(), seed=0, device="cuda")
    sharded = Sampler(GANConfig(), seed=0, mesh=make_mesh(1), device="cuda")
    # two shards on one card: _replicate shares the modules, so this costs no copy
    two = Sampler(GANConfig(), seed=0, mesh=Mesh(data=2, devices=(torch.device("cuda", 0),) * 2), device="cuda")
    walls, errs, two_launches = {}, {}, {}
    for b in (1, MAIN_BATCH, MAIN_BATCH - 1):
        emotions = [EMOTIONS[i % 4] for i in range(b)]
        want = plain.sample_notes(emotions, seed=11)
        t0 = time.perf_counter()
        got = sharded.sample_notes(emotions, seed=11)
        walls[b] = time.perf_counter() - t0
        if not np.array_equal(got, want):
            raise SystemExit(f"dp_sample: the mesh sampler differs from the plain one at batch {b}")
        n0 = decoder.decoder_tail_cuda.launches
        got = two.sample_notes(emotions, seed=11)
        two_launches[b] = decoder.decoder_tail_cuda.launches - n0
        errs[b] = float(np.abs(got.astype(np.float64) - want).max()) if got.shape == want.shape else None
        if errs[b] is None or errs[b] > DP_SAMPLE_ATOL or two_launches[b] != min(b, 2):
            raise SystemExit(f"dp_sample: two shards at batch {b}: shape {got.shape}, max abs err {errs[b]}, "
                             f"{two_launches[b]} decoder_tail launches (want {min(b, 2)})")
    httpd, state = create_server("127.0.0.1", 0, workdir=os.path.join(WORK_DIR, "no_checkpoint"),
                                 device="cuda", sample_pool=False, dp=1)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        base = f"http://127.0.0.1:{httpd.server_address[1]}"
        for emotion in EMOTIONS:
            status, body = http(base, "/generate", json.dumps({"emotion": emotion}).encode())
            if status != 200 or body[:4] != b"MThd":
                raise SystemExit(f"dp_sample /generate {emotion}: status {status}")
        status, body = http(base, "/healthz")
        health = json.loads(body)
        if status != 200 or health["device"]["platform"] != "gpu" or state.sampler.mesh is None:
            raise SystemExit(f"dp_sample /healthz: {status} {health}")
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=30)
        state.close()
    emit({"phase": "dp_sample", "bit_identical": True, "mesh_sample_s": walls, "two_shards_max_abs_err": errs,
          "two_shards_decoder_tail_launches": two_launches, "generate": 4}, results)


def drive_dp_cli(np, piped, results):
    """``dp_cli``: ``train-gan --dp 1`` through ``melogan_torch.cli.main``
    in this process (one NCCL rank) for one epoch on the pipeline's splits,
    its ``gan_final.ckpt`` bit for bit that of the same command without
    ``--dp``; then ``python -m melogan_torch train-gan --dp 2`` in a child
    process on the one card, which must exit non-zero before any work with
    ``make_mesh``'s device count."""
    import shutil

    from melogan_torch.utils.checkpoint import load_checkpoint

    data = os.path.join(piped["work"], "data")
    argv = ["train-gan", "--splits-dir", os.path.join(data, "splits"), "--processed-dir",
            os.path.join(data, "processed"), "--config", CLI_CONFIGS["gan"], "--ed-config",
            CLI_CONFIGS["ed"], "--epochs", "1"]
    finals, walls = {}, {}
    for name, extra in (("plain", []), ("dp1", ["--dp", "1"])):
        work = os.path.join(CLI_DIR, f"dp_{name}")
        shutil.rmtree(work, ignore_errors=True)
        t0 = time.perf_counter()
        run_cli(argv + ["--workdir", work] + extra, f"train_gan_{name}")
        walls[name] = time.perf_counter() - t0
        finals[name] = load_checkpoint(os.path.join(work, "experiments", "gan", "checkpoints", "gan_final.ckpt"))
    if not _tree_equal(finals["dp1"], finals["plain"]):
        raise SystemExit("dp_cli: train-gan --dp 1 wrote another gan_final.ckpt than train-gan")
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "melogan_torch", *argv, "--workdir",
                           os.path.join(CLI_DIR, "dp_2"), "--dp", "2"],
                          capture_output=True, text=True, timeout=300, cwd=ROOT)
    refused_s = time.perf_counter() - t0
    if proc.returncode == 0 or "asked for 2 devices, have 1" not in proc.stderr:
        raise SystemExit(f"dp_cli: --dp 2 on one card exited {proc.returncode}: {proc.stderr[-2000:]}")
    if os.path.exists(os.path.join(CLI_DIR, "dp_2", "experiments")):
        raise SystemExit("dp_cli: --dp 2 did work before it refused")
    emit({"phase": "dp_cli", "train_gan_wall_s": walls, "dp2_exit": proc.returncode,
          "dp2_message": proc.stderr.strip().splitlines()[-1], "dp2_wall_s": refused_s}, results)


# tensor parallelism (melogan_torch/parallel/tensor.py): tp_train holds a GANConfig() group step
# and a two-batch tail from a perturbed critic with given draws, plain in this process and on two
# gloo ranks sharing the card at (data 1, model 2) with the state split by JAX's rule at
# min_dim 256; the conv kernels at the shard shapes that path gives them, against their plain
# versions
TP_MODEL = 2
TP_MIN_DIM = 256
TP_STEPS = 3  # timed group steps after the compared run, each run
TP_PROFILED_STEPS = 1  # group steps traced on the ranks for the collectives' share
TP_TIMEOUT = 300  # seconds before the two gloo ranks are killed
TP_TAIL = 2  # batches of the compared tail step
TP_GRAD_REL = 1e-4  # Adam's first moments, of their module group's largest (as DP_GRAD_REL)
TP_RTOL, TP_ATOL = 2e-3, 1e-4  # metrics: JAX's TP test (tests/test_parallel.py:419-423)
# the shard shapes on the path at batch 32, model 2: the decoder's stage 1 splits its input
# channels (row), the ED's block 3 its output channels (column), block 4 its input ones (row)
TP_CONVT_LAYERS = [(64, 128, 128)]  # (L, Cin, Cout): stage 1, a partial sum a rank
TP_CONV1D_LAYERS = [(512, 128, 128, 3, 1, 1, "ed3_col"), (512, 128, 256, 3, 1, 1, "ed4_row")]
TP_BACKWARD_LAYERS = [((l, cin, cout, k, s, p, 0), False, n) for l, cin, cout, k, s, p, n in TP_CONV1D_LAYERS] + [
    ((64, 128, 128, 5, 2, 2, 1), True, "dec1_row")]


def tp_counts(cfg, group_steps):
    """Kernel launches of ``group_steps`` group steps and one ``TP_TAIL``
    tail, plain or on a model rank (a split layer runs its conv once, on its
    block): a critic update runs G's three transposed convs without
    gradients; the G update G's three and the ED's convs forward, the ED's
    input gradients (``convt1d``) and G's (``conv1d``, stages 3, 2, 1)."""
    from melogan_torch.config import EDConfig

    blocks = EDConfig().notes_blocks
    per_group = {"convt1d": 3 * cfg.critic_iters + 3 + blocks, "conv1d": blocks + 3}
    return {"decoder_tail": 0, "convt1d": group_steps * per_group["convt1d"] + 3 * TP_TAIL,
            "conv1d": group_steps * per_group["conv1d"]}


def tp_program(mesh, spec):
    """One rank of ``tp_train`` (``mesh`` None: the plain run, in this
    process): the state split over a (data 1, model ``TP_MODEL``) mesh by
    ``tensor.place_state``, the group step and tail from ``spec``'s state
    and draws (the compared run, whose launches are counted), the replica
    check, the gathered state; then ``TP_STEPS`` timed group steps and one
    traced on the ranks, and the bytes each collective carries in a group
    step. Returns numpy results."""
    import numpy as np
    import torch

    from melogan_torch.config import EDConfig, GANConfig
    from melogan_torch.ops import conv1d, convt, decoder
    from melogan_torch.parallel import tensor
    from melogan_torch.parallel.mesh import make_mesh, tree_map
    from melogan_torch.train import gan_step

    t_start = time.perf_counter()
    wrappers = {"decoder_tail": decoder.decoder_tail_cuda, "convt1d": convt.convt1d_cuda,
                "conv1d": conv1d.conv1d_cuda}
    before = {k: w.launches for k, w in wrappers.items()}
    dev = torch.device("cuda") if mesh is None else mesh.device
    tp = None if mesh is None else make_mesh(model_parallel=TP_MODEL, device="cuda")
    cfg, ed_cfg = GANConfig(), EDConfig()
    state = gan_step.init_state(cfg, gan_step.build_models(cfg, ed_cfg), seed=3, device=dev)
    for name, sd in spec["modules"].items():
        getattr(state, name).load_state_dict({k: torch.as_tensor(v) for k, v in sd.items()})
    dims = {} if tp is None else tensor.place_state(state, tp, min_dim=TP_MIN_DIM)
    steps = gan_step.make_train_steps(cfg, mesh=tp)
    batches, draws = tree_map(lambda t: t.to(dev), spec["group"])
    tail, tail_draws = tree_map(lambda t: t.to(dev), spec["tail"])
    state, m = steps.group(state, batches, draws)
    # the first moments after the group step: the tail's critic gradients read G's ±lr moves
    # of its near-zero gradients, which the sums' order decides
    after = tensor.gather_state(state)
    critic_step = float(next(iter(state.opt_d.state.values()))["step"])
    state, mt = steps.tail(state, tail, tail_draws)
    torch.cuda.synchronize()
    compared = {k: w.launches - before[k] for k, w in wrappers.items()}
    tensor.check_replicas(state)  # replicated tensors bit-equal over the model axis
    full = tensor.gather_state(state)

    def host(sd, prefix=""):
        return {k[len(prefix):]: v.cpu().numpy() for k, v in sd.items() if k.startswith(prefix)}

    gan = ("generator", "critic", "feature_encoder")
    out = {"metrics": [{k: float(v) for k, v in mm.items()} for mm in (m, mt)],
           "modules": {n: host(full[n]) for n in gan},
           "exp_avg": host(after["exp_avg"]), "tail_exp_avg": host(full["exp_avg"], "critic."),
           "split": {k: v for k, v in dims.items() if v is not None}}
    if tp is not None and tp.rank == 0:  # the state a plain tail starts from (check_tp_tail)
        out["after_group"] = {"modules": {n: host(after[n]) for n in gan}, "critic_step": critic_step,
                              "exp_avg": host(after["exp_avg"], "critic."),
                              "exp_avg_sq": host(after["exp_avg_sq"], "critic.")}
    walls = []
    for _ in range(TP_STEPS):
        t0 = time.perf_counter()
        state, _ = steps.group(state, batches)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    out["step_ms"] = walls
    if tp is not None:
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(TP_PROFILED_STEPS):
                state, _ = steps.group(state, batches)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        trace = os.path.join(spec["workdir"], f"tp_trace_rank{tp.rank}.json")
        prof.export_chrome_trace(trace)
        with open(trace) as f:
            events = json.load(f)["traceEvents"]
        spans = [e["dur"] for e in events if e.get("name") == "tp.all_reduce" and e.get("ph") == "X"
                 and e.get("cat") == "user_annotation"]
        busy = sum(e["dur"] for e in events if e.get("ph") == "X" and e.get("cat") == "kernel") / 1e3
        # what the collectives carry in one group step: count them through tensor.all_reduce
        carried = {"calls": 0, "bytes": 0}
        reduce_ = tensor.all_reduce

        def counted(t, group):
            carried["calls"] += 1
            carried["bytes"] += t.numel() * t.element_size()
            reduce_(t, group)

        tensor.all_reduce = counted
        try:
            state, _ = steps.group(state, batches)
            torch.cuda.synchronize()
        finally:
            tensor.all_reduce = reduce_
        tp.barrier()  # the ranks leave the trace's export at different times
        out["profile"] = {"steps": TP_PROFILED_STEPS, "wall_ms": wall, "span_ms": sum(spans) / 1e3,
                          "span_calls": len(spans), "kernel_ms": busy, "per_group_step": carried}
    out["compared_launches"] = compared
    out["launches"] = {k: w.launches - before[k] for k, w in wrappers.items()}
    out["program_s"] = time.perf_counter() - t_start
    return out


def check_tp_two(np, cfg, plain, ranks):
    """The two model ranks against the plain run: the metrics of the group
    step and the tail at JAX's TP tolerances, Adam's first moments after
    the group step within ``TP_GRAD_REL`` of their group's largest, the
    parameters after the tail within 2·lr per update (``_check_adam``); the
    gathered states of both ranks bit-equal. Returns the worst errors."""
    worst = {}
    if not _tree_equal(ranks[0]["modules"], ranks[1]["modules"]):
        raise SystemExit(f"tp_train: the two ranks' gathered weights differ: "
                         f"{_tree_diff(ranks[0]['modules'], ranks[1]['modules'])}")
    got = ranks[0]
    for i, (mine, want) in enumerate(zip(got["metrics"], plain["metrics"])):
        for k, w in want.items():
            err = abs(mine[k] - w)
            worst[f"metric {i} {k}"] = err / max(abs(w), 1e-30)
            if err > TP_ATOL + TP_RTOL * abs(w):
                raise SystemExit(f"tp_train: metric {k} of step {i}: {mine[k]} vs plain {w}")
    lr = {"G": cfg.lr_g, "FE": cfg.lr_g, "D": cfg.lr_d}
    updates = {"G": 1, "FE": 1, "D": cfg.critic_iters + TP_TAIL}
    module_of = {"G": "generator", "FE": "feature_encoder", "D": "critic"}
    for group in ("G", "FE", "D"):
        mine, want = ({n.split(".", 1)[1]: v for n, v in r["exp_avg"].items()
                       if n.split(".", 1)[0] == module_of[group]} for r in (got, plain))
        # the critic's parameters after the tail: only their 2·lr bound, as the CPU tests
        big_rel = 1e-4 if updates[group] == 1 else float("inf")
        worst[f"{group} grad"], worst[f"{group} param"] = _check_adam(
            np, mine, want, got["modules"][module_of[group]], plain["modules"][module_of[group]],
            lr[group], updates[group], TP_GRAD_REL, big_rel, group, phase="tp_train")
    return worst


def check_tp_tail(torch, np, cfg, spec, got):
    """The critic's tail against a plain tail on the card that starts from
    rank 0's gathered state after the group step (G, FE, the critic and the
    critic's Adam moments), so that the ±lr moves that G's near-zero
    gradients took in the ranks' order of sums are the plain tail's too:
    the ranks' critic first moments after the tail within ``TP_GRAD_REL``
    of the group's largest, the critic's parameters within 2·lr per update, with
    the large-gradient check (1e-4 of the largest). Returns the worst
    errors."""
    from melogan_torch.config import EDConfig
    from melogan_torch.parallel import tensor
    from melogan_torch.parallel.mesh import tree_map
    from melogan_torch.train import gan_step

    after = got["after_group"]
    state = gan_step.init_state(cfg, gan_step.build_models(cfg, EDConfig()), seed=3, device="cuda")
    for sds in (spec["modules"], after["modules"]):
        for name, sd in sds.items():
            getattr(state, name).load_state_dict({k: torch.as_tensor(v) for k, v in sd.items()})
    for n, p in state.critic.named_parameters():
        state.opt_d.state[p] = {"step": torch.tensor(after["critic_step"]),
                                "exp_avg": torch.as_tensor(after["exp_avg"][n]).to(p.device),
                                "exp_avg_sq": torch.as_tensor(after["exp_avg_sq"][n]).to(p.device)}
    tail, tail_draws = tree_map(lambda t: t.to("cuda"), spec["tail"])
    state, _ = gan_step.make_train_steps(cfg).tail(state, tail, tail_draws)
    full = tensor.gather_state(state)
    want_mu = {k.split(".", 1)[1]: v.cpu().numpy() for k, v in full["exp_avg"].items() if k.startswith("critic.")}
    want_p = {k: v.cpu().numpy() for k, v in full["critic"].items()}
    return _check_adam(np, got["tail_exp_avg"], want_mu, got["modules"]["critic"], want_p, cfg.lr_d, TP_TAIL,
                       TP_GRAD_REL, 1e-4, "D tail from the ranks' state", phase="tp_train")


def check_tp_kernels(torch, F, ops, gen, results):
    """``kernels_tp``: ``convt1d`` and ``conv1d`` at the shard shapes of the
    tensor-parallel step at batch 32 (``TP_CONVT_LAYERS``,
    ``TP_CONV1D_LAYERS``) and both input-gradient routes there
    (``TP_BACKWARD_LAYERS``), each against its plain version within
    ``TOL_REL`` of scale, timed beside the library call, bounds at 3xTF32."""
    return {"convt1d": check_convt(torch, F, ops, TRAIN_BATCH, gen, results, TP_CONVT_LAYERS, "kernels_tp"),
            "conv1d": check_conv1d(torch, F, ops, TRAIN_BATCH, gen, results, TP_CONV1D_LAYERS, "kernels_tp"),
            "backward": check_backward_routes(torch, F, ops, TRAIN_BATCH, gen, results, TP_BACKWARD_LAYERS,
                                              "kernels_tp_backward")}


def drive_tp_train(torch, np, results):
    """``tp_train``: ``tp_program`` plain in this process, then on two gloo
    ranks sharing the card at (data 1, model 2) with ``GANConfig()`` split
    by JAX's rule at min_dim 256; each rank's launches against
    ``tp_counts``; the step walls, what the collectives carry and their
    share of a traced step. Returns the record and the ranks' launches."""
    import datetime

    from melogan_torch.config import EDConfig, GANConfig
    from melogan_torch.parallel import launch
    from melogan_torch.train import gan_step

    cfg, ed_cfg = GANConfig(), EDConfig()
    cpu = gan_step.init_state(cfg, gan_step.build_models(cfg, ed_cfg), seed=3, device="cpu")
    g = torch.Generator().manual_seed(5)
    with torch.no_grad():  # a critic away from its init, as check_group_step_against_cpu
        for m in cpu.critic.modules():
            if isinstance(m, (torch.nn.Conv1d, torch.nn.Linear)):
                m.weight.mul_(10.0)
                m.bias.copy_(0.05 * torch.randn(m.bias.shape, generator=g))
    (group,) = _batches_and_draws(torch, np, cfg, cpu.feature_encoder, 6, ["cpu"])
    (tail,) = _batches_and_draws(torch, np, cfg, cpu.feature_encoder, 7, ["cpu"])
    tail = (tuple(f[:TP_TAIL] for f in tail[0]), list(tail[1].critic[:TP_TAIL]))
    spec = {"modules": {n: _np_sd(getattr(cpu, n)) for n in ("generator", "critic", "feature_encoder", "ed")},
            "group": group, "tail": tail, "workdir": os.path.join(WORK_DIR, "tp")}
    os.makedirs(spec["workdir"], exist_ok=True)
    predicted = tp_counts(cfg, 1 + TP_STEPS)
    predicted_rank = tp_counts(cfg, 1 + TP_STEPS + TP_PROFILED_STEPS + 1)
    t0 = time.perf_counter()
    plain = tp_program(None, spec)
    t1 = time.perf_counter()
    two = launch.spawn(tp_program, TP_MODEL, args=(spec,), device="cuda", backend="gloo", timeout=TP_TIMEOUT,
                       rank_timeout=datetime.timedelta(seconds=TP_TIMEOUT))
    t2 = time.perf_counter()
    worst = check_tp_two(np, cfg, plain, two)
    worst["D tail grad"], worst["D tail param"] = check_tp_tail(torch, np, cfg, spec, two[0])
    if plain["launches"] != predicted or any(r["launches"] != predicted_rank for r in two) or any(
            r["compared_launches"] != plain["compared_launches"] for r in two):
        raise SystemExit(f"tp_train launches: plain {plain['launches']} (predicted {predicted}), ranks "
                         f"{[r['launches'] for r in two]} (predicted {predicted_rank}), compared runs "
                         f"{[r['compared_launches'] for r in two]} vs plain {plain['compared_launches']}")
    prof = two[0]["profile"]
    rec = {"phase": "tp_train", "mesh": {"data": 1, "model": TP_MODEL}, "min_dim": TP_MIN_DIM,
           "split": two[0]["split"],
           "plain_step_median_ms": float(np.median(plain["step_ms"])),
           "tp2_step_median_ms": [float(np.median(r["step_ms"])) for r in two],
           "plain_step_ms": plain["step_ms"], "tp2_rank0_step_ms": two[0]["step_ms"],
           "tp2_profile": prof,
           # the tp.all_reduce spans of the traced step (their wait for queued device work included)
           "tp2_allreduce_share": prof["span_ms"] / prof["wall_ms"],
           "tp2_kernel_busy_share": prof["kernel_ms"] / prof["wall_ms"],
           "collective_mb_per_group_step": prof["per_group_step"]["bytes"] / 1e6,
           "collective_calls_per_group_step": prof["per_group_step"]["calls"],
           "launches": {"plain": plain["launches"], "ranks": [r["launches"] for r in two],
                        "predicted_plain": predicted, "predicted_rank": predicted_rank},
           "worst_vs_plain": worst, "program_s": {"plain": plain["program_s"],
                                                  "tp2": [r["program_s"] for r in two]},
           "wall_s": {"plain": t1 - t0, "tp2": t2 - t1}}
    emit(rec, results)
    ranks = {k: sum(r["launches"][k] for r in two) for k in plain["launches"]}
    return rec, ranks


# ---------------------------------------------------------------------------
# The last two entry points: python -m melogan_torch bench, and kill/resume
# fault injection
# ---------------------------------------------------------------------------

BENCH_BATCH = 65536  # bench.py's headline sampling batch
FAULT_DIR = os.path.join(WORK_DIR, "fault")
FAULT_SEED = 3  # the seed of the JAX package's bounded trial (tests/test_fault_inject.py)


def jax_bench_keys():
    """The keys of the line the root bench.py prints (its ``out`` dict), read
    with ``ast``: nothing of JAX is imported."""
    import ast

    with open(os.path.join(ROOT, "bench.py")) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and any(isinstance(t, ast.Name) and t.id == "out" for t in node.targets)):
            return {k.value for k in node.value.keys}
    raise SystemExit("bench.py has no out dict")


def drive_bench(torch, results):
    """``bench``: ``python -m melogan_torch bench`` through ``cli.main`` in
    this process (its launches count), the CPU baseline in its child; the
    line must hold every key of the JAX benchmark's and ``power_limit``,
    positive rates, ordered percentiles, no share of peak above 100, the
    dp keys null on one card, and this card's name and count."""
    t0 = time.perf_counter()
    text = run_cli(["bench"], "bench")
    seconds = time.perf_counter() - t0
    line = json.loads([ln for ln in text.splitlines() if ln.startswith("{")][-1])
    missing = (jax_bench_keys() | {"power_limit"}) - set(line)
    positive = ("value", "train_steps_per_sec", "bf16_samples_per_sec", "bf16_train_steps_per_sec",
                "cpu_samples_per_sec")
    bad = [k for k in positive if not (line[k] or 0) > 0]
    bad += [k for k, v in line.items() if k.endswith("_pct_bf16_peak") and not (v is not None and 0 < v <= 100)]
    if not line["p50_midi_gen_latency_ms"] <= line["p90_midi_gen_latency_ms"] <= line["p99_midi_gen_latency_ms"]:
        bad.append("p50 <= p90 <= p99")
    if line["n_devices"] != torch.cuda.device_count() or line["chip"] != torch.cuda.get_device_name(0):
        bad.append("n_devices / chip")
    if line["n_devices"] == 1 and any(line[k] is not None for k in
                                      ("dp_samples_per_sec", "dp_train_steps_per_sec", "dp_sampling_scaling")):
        bad.append("dp keys on one card")
    if missing or bad:
        raise SystemExit(f"bench line: missing keys {sorted(missing)}, failed checks {bad}: {line}")
    emit({"phase": "bench", "seconds": seconds, "line": line}, results)
    return line


def drive_fault_inject(results):
    """``fault_inject``: ``melogan_torch.fault_inject.main`` with one trial
    on the card (seed 3): the uninterrupted pipeline, one killed before it
    completes, its ``--resume``, every artifact equal. The pipelines are
    child processes; their launches are their own. Returns the record:
    the report, the reference run's wall and the stage the kill landed in."""
    import contextlib
    import shutil

    from melogan_torch import fault_inject

    shutil.rmtree(FAULT_DIR, ignore_errors=True)
    os.makedirs(FAULT_DIR)
    log = os.path.join(WORK_DIR, "fault_inject.log")
    t0 = time.perf_counter()
    try:
        with open(log, "w") as f, contextlib.redirect_stdout(f):
            reports = fault_inject.main(FAULT_DIR, trials=1, seed=FAULT_SEED, device="cuda")
    finally:
        with open(log) as f:
            printed = f.read()
        print(printed, end="", flush=True)
    seconds = time.perf_counter() - t0
    (report,) = reports
    if not report["ok"] or report["completed_before_kill"]:
        raise SystemExit(f"fault_inject: the pipeline was not killed before it completed: {report}")
    rec = {"phase": "fault_inject", "seconds": seconds, "report": report,
           "reference_wall_s": float(printed.split("[fault] reference wall ")[1].split("s,")[0]),
           "killed_in": printed.split("killed in ")[1].split()[0]}
    emit(rec, results)
    return rec


def main() -> int:
    t_script = time.perf_counter()
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
    check_ed_kernels(torch, F, ops, gen, results)
    check_tp_kernels(torch, F, ops, gen, results)
    bf16_kernels = check_bf16_kernels(torch, F, ops, gen, results)
    moded = {k: w for k, w in wrappers.items() if hasattr(w, "launches_bf16")}
    bf16_by_path = {}

    def drive(path, fn, need):
        """Run one main path with every launch count at 0; its counts (and
        the conv kernels' bf16-mode counts, on a line of their own)."""
        for w in wrappers.values():
            w.launches = 0
        for w in moded.values():
            w.launches_bf16 = 0
        out = fn()
        counts = {k: w.launches for k, w in wrappers.items()}
        bf16_by_path[path] = {k: w.launches_bf16 for k, w in moded.items()}
        emit({"phase": "main_path_launches", "path": path, **counts}, results)
        emit({"phase": "main_path_launches_bf16", "path": path, **bf16_by_path[path]}, results)
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
    # Stage 2 and serving: the ED trained on the card, the judge, the GAN
    # against that ED, and its checkpoint hot-swapped into a pooled server
    ed, ed_training = drive("ed_train", lambda: drive_ed_train(torch, np, data, results), ("conv1d", "convt1d"))
    want = ed_counts(data)
    if {k: ed_training[k] for k in ("conv1d", "convt1d")} != {k: want[k] for k in ("conv1d", "convt1d")}:
        raise SystemExit(f"ed_train launches {ed_training}, predicted {want}")
    ed_step = time_ed_step(torch, np, data, results)
    ed_resume_dir = seed_ed_resume(data, ed)
    _, ed_resuming = drive("ed_resume", lambda: drive_ed_resume(torch, np, data, ed, ed_resume_dir, results),
                           ("conv1d", "convt1d"))
    judged, judging = drive("judge", lambda: drive_judge(torch, np, data, ed, results), ("conv1d", "convt1d"))
    gan, gan_with_ed = drive("gan_with_ed", lambda: drive_gan_with_ed(torch, np, data, ed, judged, results),
                             ("conv1d", "convt1d", "decoder_tail"))
    served, reloading = drive("serve_reload", lambda: drive_serve_reload(torch, np, gan, trained, results),
                              ("decoder_tail",))
    check_served_weights(np, gan, served, reloading, results)
    # the population sweep: 4 members on the training phase's corpus and config
    swept, sweeping = drive("sweep", lambda: drive_sweep(torch, np, trained, results),
                            ("conv1d", "convt1d", "decoder_tail"))
    check_sweep(torch, np, trained, swept, results)
    sweep_state = measure_sweep_state(torch, np, trained, swept, results)
    sweep_resume_dir = seed_sweep_resume(trained)
    _, sweep_resuming = drive("sweep_resume",
                              lambda: drive_sweep_resume(torch, trained, swept, sweep_resume_dir, results),
                              ("conv1d", "convt1d", "decoder_tail"))
    _, sweep_halving = drive("sweep_halving", lambda: drive_sweep_halving(torch, np, trained, results),
                                   ("conv1d", "convt1d", "decoder_tail"))
    k = len(SWEEP_GRID)
    sweep_want = {"sweep": (sweeping, sweep_counts(trained["cfg"], k * SWEEP_EPOCHS, k)),
                  "sweep_resume": (sweep_resuming, sweep_counts(trained["cfg"], k * (SWEEP_EPOCHS - 1), k)),
                  "sweep_halving": (sweep_halving, sweep_counts(trained["cfg"], k + k // 2 + 1, k + k // 2 + 1))}
    for name, (got, predicted) in sweep_want.items():
        if got != predicted:
            raise SystemExit(f"{name} launches {got}, predicted {predicted}")
    # every path so far runs f32: no launch in bf16 mode
    f32_paths = dict(bf16_by_path)
    if any(n for counts in f32_paths.values() for n in counts.values()):
        raise SystemExit(f"an f32 path launched the bf16 mode: {f32_paths}")
    # the bf16 slice: fast sampling and serving, bf16 training, spectral norm
    fast, sampling_fast = drive("sampling_fast", lambda: drive_sampling_fast(torch, np, results),
                                ("convt1d",))
    want_fast = {"decoder_tail": 0, "convt1d": 3 * fast["forwards"], "conv1d": 0}
    if sampling_fast != want_fast or bf16_by_path["sampling_fast"] != {"convt1d": 3 * fast["forwards"],
                                                                       "conv1d": 0}:
        raise SystemExit(f"sampling_fast launches {sampling_fast} / bf16 {bf16_by_path['sampling_fast']}, "
                         f"predicted {want_fast}, all bf16")
    fast_vs_f32 = check_fast_sampling(torch, np, fast, results)
    _, training_bf16 = drive("training_bf16",
                             lambda: drive_training_bf16(torch, np, data, trained, vae, results),
                             ("conv1d", "convt1d"))
    gan_epoch = sweep_counts(trained["cfg"], 1, 0)
    want_bf16 = {k: gan_epoch[k] + vae_training[k] + want[k] for k in ("conv1d", "convt1d")}
    if ({k: training_bf16[k] for k in want_bf16} != want_bf16 or bf16_by_path["training_bf16"] != want_bf16
            or training_bf16["decoder_tail"] != 0):
        raise SystemExit(f"training_bf16 launches {training_bf16} / bf16 {bf16_by_path['training_bf16']}, "
                         f"predicted {want_bf16}, all bf16, no decoder_tail")
    bf16_steps = time_bf16_steps(torch, np, data, vae, results)
    _, spectral = drive("spectral", lambda: drive_spectral(torch, np, results), ("decoder_tail",))
    # the command line, python -m melogan_torch: the pipeline at the shipped
    # widths, its resume, the subcommands one by one, and children processes
    all3 = ("conv1d", "convt1d", "decoder_tail")
    piped, cli_pipeline = drive("cli_pipeline", lambda: drive_cli_pipeline(np, results), all3)
    _, cli_resume = drive("cli_resume", lambda: drive_cli_resume(piped, results), all3)
    _, cli_commands = drive("cli_commands", lambda: drive_cli_commands(np, piped, results), all3)
    _, cli_module = drive("cli_module", lambda: drive_cli_module(piped, results), ())
    rows = piped["rows"]
    cli_want = {"cli_pipeline": (cli_pipeline, cli_counts(rows, CLI_EPOCHS, 3, vae_epochs=CLI_EPOCHS,
                                                          ed_epochs=CLI_EPOCHS, encode=True)),
                "cli_resume": (cli_resume, cli_counts(rows, 1, 2)),
                "cli_commands": (cli_commands, cli_commands_counts(rows)),
                "cli_module": (cli_module, {k: 0 for k in wrappers})}
    for name, (got, predicted) in cli_want.items():
        if got != predicted or any(bf16_by_path[name].values()):
            raise SystemExit(f"{name} launches {got} / bf16 {bf16_by_path[name]}, predicted {predicted}, "
                             f"no bf16")
    # the text path: the text MLP trained on the card, the roberta-base-width
    # backend, text → emotion → /generate through the server, and text-eval
    text, text_mlp_counts = drive("text_mlp", lambda: drive_text_mlp(torch, np, results), ())
    roberta, roberta_counts = drive("roberta", lambda: drive_roberta(torch, np, results), ())
    _, text_route = drive("text_route", lambda: drive_text_route(torch, np, text, roberta, results),
                          ("decoder_tail",))
    _, cli_text_eval = drive("cli_text_eval", lambda: drive_cli_text_eval(text, results), ())
    none = {k: 0 for k in wrappers}
    text_want = {"text_mlp": (text_mlp_counts, none), "roberta": (roberta_counts, none),
                 # the server's warm-up sample_notes, then one /generate a probe and backend
                 "text_route": (text_route, dict(none, decoder_tail=1 + 2 * len(TEXT_PROBES))),
                 "cli_text_eval": (cli_text_eval, none)}
    for name, (got, predicted) in text_want.items():
        if got != predicted or any(bf16_by_path[name].values()):
            raise SystemExit(f"{name} launches {got} / bf16 {bf16_by_path[name]}, predicted {predicted}, "
                             f"no bf16")
    # the camera path: the SSD, the FER and the native JPEG on the card, then
    # camera frame → emotion → /generate and the MJPEG stream through the server
    camera, camera_models = drive("camera_models", lambda: drive_camera_models(torch, np, results), ())
    routed, camera_route = drive("camera_route", lambda: drive_camera_route(torch, np, camera, results),
                                 ("decoder_tail",))
    camera_want = {"camera_models": (camera_models, none),
                   # each server's warm-up sample_notes, then one /generate a frame
                   "camera_route": (camera_route, dict(none, decoder_tail=2 + CAMERA_ROUTE_FRAMES))}
    for name, (got, predicted) in camera_want.items():
        if got != predicted or any(bf16_by_path[name].values()):
            raise SystemExit(f"{name} launches {got} / bf16 {bf16_by_path[name]}, predicted {predicted}, "
                             f"no bf16")
    # data parallelism: --dp 1 bit for bit, two gloo ranks sharing the card, the sampler and the
    # server over a local mesh, and the command line's --dp
    dp, dp_training = drive("dp_train", lambda: drive_dp_train(torch, np, results), ("conv1d", "convt1d"))
    _, dp_sampling = drive("dp_sample", lambda: drive_dp_sample(torch, np, results), ("decoder_tail",))
    _, dp_cli = drive("dp_cli", lambda: drive_dp_cli(np, piped, results), ("conv1d", "convt1d"))
    per_rank = dp["launches_per_rank"]
    if any(r != per_rank["plain"] for r in [per_rank["dp1"]] + per_rank["gloo2"]):
        raise SystemExit(f"dp_train launches per rank {per_rank}: each rank should launch the plain run's")
    # the plain and the one-shard sampler at three batches, the two-shard sampler's non-empty
    # blocks (1 + 2 + 2), then the server's warm-up and four /generate
    dp_want = {"dp_sample": (dp_sampling, dict(none, decoder_tail=2 * 3 + 5 + 1 + 4))}
    for name, (got, predicted) in dp_want.items():
        if got != predicted:
            raise SystemExit(f"{name} launches {got}, predicted {predicted}")
    if any(n for name in ("dp_train", "dp_sample", "dp_cli") for n in bf16_by_path[name].values()):
        raise SystemExit(f"a dp path launched the bf16 mode: {bf16_by_path}")
    # tensor parallelism: the split group step on two gloo ranks against the plain one; the
    # path's launches are the plain run's in this process and both ranks'
    (tp, tp_rank_launches), tp_training = drive("tp_train", lambda: drive_tp_train(torch, np, results),
                                                ("conv1d", "convt1d"))
    if any(bf16_by_path["tp_train"].values()):
        raise SystemExit(f"tp_train launched the bf16 mode: {bf16_by_path['tp_train']}")
    tp_training = {k: tp_training[k] + tp_rank_launches[k] for k in wrappers}
    emit({"phase": "main_path_launches", "path": "tp_train_with_ranks", **tp_training}, results)
    # the last two entry points: the benchmark (its headline batch's tail held against the plain
    # version first, outside the counted window), then a pipeline killed and resumed
    check_decoder(torch, F, ops, BENCH_BATCH, 64, gen, results)
    bench_line, benching = drive("bench", lambda: drive_bench(torch, results), all3)
    if not all(bf16_by_path["bench"].values()):
        raise SystemExit(f"bench launched no bf16 mode of a conv kernel: {bf16_by_path['bench']}")
    fault, fault_injecting = drive("fault_inject", lambda: drive_fault_inject(results), ())
    if fault_injecting != none or any(bf16_by_path["fault_inject"].values()):
        raise SystemExit(f"fault_inject launched in this process: {fault_injecting}")
    path_names = ("sampling", "training", "resume", "serve_ckpt", "data", "vae_train", "vae_resume", "encode",
                  "gan_conditioning", "ed_train", "ed_resume", "judge", "gan_with_ed", "serve_reload",
                  "sweep", "sweep_resume", "sweep_halving", "sampling_fast", "training_bf16", "spectral",
                  "cli_pipeline", "cli_resume", "cli_commands", "cli_module",
                  "text_mlp", "roberta", "text_route", "cli_text_eval", "camera_models", "camera_route",
                  "dp_train", "dp_sample", "dp_cli", "tp_train", "bench", "fault_inject")
    paths = (sampling, training, resuming, serving, loading, vae_training, vae_resuming, encoding,
             conditioning, ed_training, ed_resuming, judging, gan_with_ed, reloading,
             sweeping, sweep_resuming, sweep_halving, sampling_fast, training_bf16, spectral,
             cli_pipeline, cli_resume, cli_commands, cli_module,
             text_mlp_counts, roberta_counts, text_route, cli_text_eval, camera_models, camera_route,
             dp_training, dp_sampling, dp_cli, tp_training, benching, fault_injecting)
    launches = {k: sum(p[k] for p in paths) for k in wrappers}
    launches_bf16 = {k: sum(bf16_by_path[p][k] for p in path_names) for k in moded}

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
    # the one-pass bf16 mode of each conv kernel at the same shapes as its f32
    # entry, its launches those of the bf16 mode, its library call cuDNN on
    # bf16 tensors
    for name, recs, source, replaces in (
            ("convt1d", [r for r in bf16_kernels["convt1d"] if r["batch"] == CONVT_BATCHES[-1]
                         and r["layer"].startswith("dec")],
             "melogan_torch/csrc/convt1d.cu", "melogan_tpu/ops/pallas/conv1d.py:140"),
            ("conv1d", [r for r in bf16_kernels["conv1d"] if r["batch"] == TRAIN_BATCH
                        and r["layer"].startswith("ed")],
             "melogan_torch/csrc/conv1d.cu", "melogan_tpu/ops/pallas/conv1d.py:64")):
        entry = summed(name, recs, source=source, replaces=replaces, mode="bf16",
                       max_abs_err=max(r["max_abs_err"] for r in bf16_kernels[name]))
        kernels.append(dict(entry, name=f"{name}_bf16", launches=launches_bf16[name]))
    emit({"phase": "launches_by_mode",
          **{k: {"all": launches[k], "bf16": launches_bf16[k], "f32": launches[k] - launches_bf16[k]}
             for k in moded}}, results)
    emit({"phase": "summary", "group_steps_per_s": step["group_steps_per_s"],
          "group_step_median_ms": step["median_ms"], "group_step_bound_ms": step["bound_ms"],
          "vae_step_median_ms": vae_step["step_median_ms"], "vae_step_bound_ms": vae_step["step_bound_ms"],
          "vae_conv1d_b32_ms": sum(r["kernel_ms"] for r in vae_kernels["conv1d"] if r["batch"] == 32),
          "vae_convt1d_b32_ms": sum(r["kernel_ms"] for r in vae_kernels["convt1d"] if r["batch"] == 32),
          "ed_step_median_ms": ed_step["step_median_ms"], "ed_step_bound_ms": ed_step["step_bound_ms"],
          "ed_train_predicted_launches": want,
          "sweep_population_epoch_s": swept["record"]["population_epoch_s"],
          "sweep_solo_epoch_s": swept["record"]["solo_epoch_s"],
          "sweep_state_mb": sweep_state["mb"], "sweep_state_save_s": sweep_state["save_s"],
          "sweep_state_load_s": sweep_state["load_s"], "sweep_gate_s": swept["record"]["gate_s"],
          "sweep_predicted_launches": {name: predicted for name, (_, predicted) in sweep_want.items()},
          "fast_median_ms_b1": float(np.median(fast["walls"][1])),
          "fast_median_ms_b4096": float(np.median(fast["walls"][MAIN_BATCH])),
          "f32_median_ms_b1": fast_vs_f32["f32_median_ms_b1"],
          "f32_median_ms_b4096": fast_vs_f32["f32_median_ms_b4096"],
          "bf16_steps_median_ms": {k: {p: bf16_steps[k][f"{p}_median_ms"] for p in ("f32", "bf16")}
                                   for k in ("group", "vae", "ed")},
          "training_bf16_predicted_launches": want_bf16,
          "cli_rows": rows, "cli_predicted_launches": {name: predicted for name, (_, predicted) in cli_want.items()},
          "text_mlp_measured": text["measured"], "roberta_forward_ms": roberta["forward"]["ms"],
          "roberta_forward_bound_ms": roberta["forward"]["bound_ms"],
          "text_predicted_launches": {name: predicted for name, (_, predicted) in text_want.items()},
          "camera_predicted_launches": {name: predicted for name, (_, predicted) in camera_want.items()},
          "detect": camera["record"]["detect"], "ssd_forward": camera["record"]["ssd_forward"],
          "fer": camera["record"]["fer"], "jpeg": camera["record"]["jpeg"],
          "camera_route_median_ms": routed["synthetic"]["route_median_ms"],
          "video_fps": {k: routed[k]["video_fps"] for k in ("synthetic", "y4m")},
          "dp_plain_step_median_ms": dp["plain_step_median_ms"], "dp1_step_median_ms": dp["dp1_step_median_ms"],
          "dp_gloo2_step_median_ms": dp["gloo2_step_median_ms"],
          "dp_gloo2_allreduce_share": dp["gloo2_allreduce_share"],
          "dp_gloo2_grad_allreduce_ms_per_step": dp["gloo2_grad_allreduce_ms_per_step"],
          "dp_launches_per_rank": dp["launches_per_rank"],
          "tp_plain_step_median_ms": tp["plain_step_median_ms"], "tp2_step_median_ms": tp["tp2_step_median_ms"],
          "tp2_allreduce_share": tp["tp2_allreduce_share"], "tp_collective_mb": tp["collective_mb_per_group_step"],
          "tp_launches": tp["launches"],
          "bench": bench_line, "fault_inject": fault,
          "launches_by_path": dict(zip(path_names, paths)), "launches_bf16_by_path": bf16_by_path},
         results)
    emit({"phase": "script", "wall_s": time.perf_counter() - t_script}, results)
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
