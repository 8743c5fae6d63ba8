"""Command-line interface of the port — the pipeline surface.

The port's ``melogan_tpu/cli.py``: the reference entry points (full_script.sh
stages, the missing src/gan/test_gan.py sampling CLI, tools/, diagnostics) as
subcommands of one program, run with ``python -m melogan_torch`` (or the
``melogan-torch`` script):

  synth-data        generate a synthetic emotion-labelled corpus
  preprocess        raw MIDI → per-song .npz (+ scaler)
  make-splits       manifest → stratified split CSVs
  split-arrays      per-split fast-path .npy arrays
  augment-corpus    real MIDI sources → an augmentation-expanded corpus
  train-ae          Stage 1: VAE
  encode            export µ latents per split (encoder_feats.npy)
  train-ed          Stage 2: emotion discriminator
  eval-ed           ED evaluation (the script the reference lost)
  train-gan         Stage 3: WGAN-GP
  sweep             Stage 3 population: K seeds, or a --hyper grid of
                    configs, quality-gate-ranked
  sample            emotion-conditioned .mid generation (test_gan)
  eval-gen          judge-ED emotion accuracy of fresh samples
  quality-gate      golden-band check of generated .mid files
  pipeline          all stages end-to-end (full_script.sh), with --resume
  diagnose          data-sanity diagnostics
  analyze-midi      MIDI statistics
  tsne              latent-space visualization
  roll-to-midi      raw (pitch, vel, dur, start) .npy → .mid
  import-checkpoint / export-checkpoint   reference .pth ⇄ .ckpt
  serve             HTTP serving app
  clean             delete generated artifacts
  logs              tfevents training curves
  profile           time (and trace) the sampling hot path
  text-eval         measured accuracy of the offline text-emotion backends
  doctor            bounded environment diagnostic
  bench             benchmark harness: one JSON line of end-to-end readings

Every subcommand that touches the device runs on the GPU unless the
top-level ``--device cpu`` is given (``python -m melogan_torch --device cpu
pipeline ...``); asking for the GPU where there is none raises, and nothing
falls back to the CPU. The handlers in ``_HOST_ONLY_FNS`` never touch the
device and never initialize CUDA. ``--dp N`` (data parallelism over N
devices): ``train-ae``, ``train-ed``, ``train-gan``, ``sweep`` and
``pipeline`` start N ranks, one process a device (``parallel/launch.py``),
each of which runs the subcommand again inside the group; under a group that
already exists (``torchrun``) the subcommand joins it and starts nothing.
``sample`` and ``serve`` split their batches over N local devices in this
process. ``bench`` runs the port's benchmark (``melogan_torch/bench.py``)
on the ``--device``. The JAX CLI's ``precompile`` (it warms a JAX compile
cache) has no counterpart here.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _resolve_config(path, workdir="."):
    """Resolve a config path the way the reference scripts absolutize theirs
    (train_ae.py:228-247, encode.py:69-76): as given, then under --workdir,
    then under the repo root. None when nothing exists."""
    if not path:
        return None
    for cand in (path, os.path.join(workdir, path), os.path.join(_REPO_ROOT, path)):
        if os.path.exists(cand):
            return cand
    return None


# the argparse default per config class; ONLY these may silently fall back to
# built-in defaults (which mirror the reference YAML values) — an explicitly
# passed config path that resolves nowhere is a hard error, never a silent
# default-hyperparameter run
_CFG_DEFAULTS = {"AEConfig": "configs/ae.yaml", "EDConfig": "configs/ed.yaml",
                 "GANConfig": "configs/gan.yaml"}


def _load_cfg(cls, path, workdir="."):
    """Load a config dataclass from the resolved YAML path (so the CLI works
    from any cwd); see _CFG_DEFAULTS for the fallback rule."""
    resolved = _resolve_config(path, workdir)
    if resolved is None:
        if path != _CFG_DEFAULTS.get(cls.__name__):
            raise FileNotFoundError(
                f"config {path!r} not found (tried as given, under --workdir "
                f"{workdir!r}, and under the repo root)")
        print(f"[WARN] default config {path!r} not found (tried cwd, workdir, "
              "repo root); using built-in defaults")
        return cls()
    return cls.from_yaml(resolved)


def _precision(args):
    return "bf16" if getattr(args, "bf16", False) else None


def cmd_synth_data(args):
    from melogan_torch.data.synthetic import generate_corpus

    entries = generate_corpus(args.out, n_per_emotion=args.per_emotion, seed=args.seed)
    print(f"[INFO] wrote {len(entries)} synthetic songs + manifest -> {args.out}")


def cmd_preprocess(args):
    from melogan_torch.data.preprocess import preprocess_corpus
    from melogan_torch.data.scaler import StandardScaler
    from melogan_torch.data.splits import read_manifest

    rows = read_manifest(args.manifest)
    entries = [(r["file_key"], r["full_path"], r["emotion"]) for r in rows]
    scaler = None
    if args.scaler and os.path.exists(args.scaler):
        scaler = StandardScaler.load(args.scaler)
        print(f"[INFO] using existing scaler {args.scaler}")
    scaler = preprocess_corpus(entries, args.out, scaler=scaler)
    save_to = args.scaler or os.path.join(os.path.dirname(args.out) or ".", "scaler.npz")
    if not (args.scaler and os.path.exists(args.scaler)):
        scaler.save(save_to)
        print(f"[INFO] saved scaler -> {save_to}")


def _parse_ratios(spec):
    """'TR/VA/TE' → three fractions summing to 1, else SystemExit."""
    parts = tuple(float(x) for x in str(spec).split("/"))
    if len(parts) != 3 or abs(sum(parts) - 1.0) > 1e-6:
        raise SystemExit(f"--ratios must be three fractions summing to 1, "
                         f"e.g. 0.5/0.25/0.25; got {spec!r}")
    return parts


def cmd_make_splits(args):
    from melogan_torch.data.splits import create_splits, read_manifest

    ratios = getattr(args, "ratios", None)
    kw = {"ratios": _parse_ratios(ratios)} if ratios else {}
    splits = create_splits(read_manifest(args.manifest), args.out, seed=args.seed, **kw)
    print({k: len(v) for k, v in splits.items()})


def cmd_split_arrays(args):
    from melogan_torch.data.preprocess import build_split_arrays

    for name in args.splits:
        csv_path = os.path.join(args.splits_dir, f"{name}_split.csv")
        build_split_arrays(csv_path, args.processed_dir, os.path.join(args.splits_dir, name))


def cmd_augment_corpus(args):
    """Expand real MIDI sources into an augmented training corpus
    (grouped-by-source splits, train-fit scaler — data/augment.py)."""
    from melogan_torch.data.augment import expand_corpus
    from melogan_torch.data.npz import read_split_csv

    rows = read_split_csv(args.manifest)
    entries = [(r["file_key"], r["full_path"], r["emotion"]) for r in rows]
    report = expand_corpus(entries, args.out, per_song=args.per_song,
                           ratios=_parse_ratios(args.ratios), seed=args.seed)
    print(json.dumps(report))
    return report


def _check_dp_batch(dp, batch_size):
    """Hard-errors when ``batch_size`` does not divide ``--dp``: no batch
    could then be split over the ranks, and every rank would train the
    whole batch, at one device's speed, while claiming to be data-parallel."""
    if batch_size is not None and batch_size % dp != 0:
        raise SystemExit(
            f"--dp {dp} requires the config batch_size ({batch_size}) to be "
            f"divisible by it; otherwise no batch sharding can be applied"
        )


def _mesh_from_args(args, batch_size=None):
    """--dp N → a (data=N, model=1) mesh, ``make_mesh(n_devices=N)``: over
    the process group inside the ranks that ``main`` started (or under
    ``torchrun``), else over the first N local devices (``sample``,
    ``serve``); 0/absent → None. ``batch_size``: see ``_check_dp_batch``."""
    dp = getattr(args, "dp", 0)
    if not dp:
        return None
    _check_dp_batch(dp, batch_size)
    from melogan_torch.parallel.mesh import make_mesh

    return make_mesh(n_devices=dp, device=args.device)


def _is_main(mesh):
    """Whether this process prints a trainer's result (rank 0, or alone)."""
    return mesh is None or mesh.is_main


def _load_split(args, name):
    from melogan_torch.data.datasets import load_split

    csv_path = os.path.join(args.splits_dir, f"{name}_split.csv")
    return load_split(csv_path, args.processed_dir)


def _load_trained(state, raw, kind):
    """Put a ``.ckpt``'s weights and BatchNorm statistics into a VAE
    (``kind="ae"``) or ED training state: a trainer's file of either package
    through ``weights.load_vae_payload``/``load_ed_payload``, an imported
    reference file (params and batch_stats only) through the exporters."""
    import torch

    from melogan_torch.utils import weights

    if "opt_state" in raw:
        (weights.load_vae_payload if kind == "ae" else weights.load_ed_payload)(state, raw)
        return state
    export = weights.export_vae if kind == "ae" else weights.export_ed
    sd = export({"params": raw["params"], "batch_stats": raw.get("batch_stats", {})})
    state.model.load_state_dict(
        {k: torch.as_tensor(np.array(v)).to(state.device) for k, v in sd.items()}, strict=True)
    return state


def cmd_train_ae(args):
    from melogan_torch.config import AEConfig
    from melogan_torch.train import vae_loop

    cfg = _load_cfg(AEConfig, args.config, args.workdir)
    if args.epochs:
        cfg.epochs = args.epochs
    mesh = _mesh_from_args(args, cfg.batch_size)
    train_data = _load_split(args, "train")
    val_data = _load_split(args, "val")
    _, metrics = vae_loop.train(
        cfg, train_data, val_data, workdir=args.workdir,
        resume=getattr(args, "resume", False), mesh=mesh, precision=_precision(args),
        device=args.device,
    )
    if _is_main(mesh):
        print(json.dumps(metrics))


def cmd_encode(args):
    from melogan_torch.config import AEConfig
    from melogan_torch.train import vae_loop
    from melogan_torch.utils.checkpoint import load_checkpoint

    cfg = _load_cfg(AEConfig, args.config, args.workdir)
    state = vae_loop.init_state(cfg, seed=cfg.seed, device=args.device)
    ckpt_path = args.checkpoint or os.path.join(args.workdir, cfg.checkpoint_dir, "ae_best.ckpt")
    _load_trained(state, load_checkpoint(ckpt_path), "ae")

    for name in args.splits:
        data = _load_split(args, name)
        mu = vae_loop.encode_mu(state.model, data.notes_ae(cfg))
        out_dir = os.path.join(args.splits_dir, name)
        os.makedirs(out_dir, exist_ok=True)
        out = os.path.join(out_dir, "encoder_feats.npy")
        np.save(out, mu)
        print(f"[INFO] wrote {mu.shape} latents -> {out}")


def cmd_train_ed(args):
    from melogan_torch.config import EDConfig
    from melogan_torch.train import ed_loop

    cfg = _load_cfg(EDConfig, args.config, args.workdir)
    if args.epochs:
        cfg.num_epochs = args.epochs
    mesh = _mesh_from_args(args, cfg.batch_size)
    train_data = _load_split(args, "train")
    val_data = _load_split(args, "val")
    lat_tr = lat_va = None
    if cfg.input_mode == "latent":
        lat_tr = np.load(os.path.join(args.splits_dir, "train", "encoder_feats.npy"))
        lat_va = np.load(os.path.join(args.splits_dir, "val", "encoder_feats.npy"))
    _, metrics = ed_loop.train(
        cfg, train_data, val_data, lat_tr, lat_va, workdir=args.workdir,
        resume=getattr(args, "resume", False), mesh=mesh, precision=_precision(args),
        device=args.device,
    )
    if _is_main(mesh):
        print(json.dumps(metrics))


def cmd_eval_ed(args):
    from melogan_torch.config import EDConfig
    from melogan_torch.train import ed_loop
    from melogan_torch.utils.checkpoint import load_checkpoint

    cfg = _load_cfg(EDConfig, args.config, args.workdir)
    state = ed_loop.init_state(cfg, seed=cfg.seed, device=args.device)
    ckpt_path = args.checkpoint or os.path.join(args.workdir, cfg.checkpoint_dir, "ed_best.ckpt")
    _load_trained(state, load_checkpoint(ckpt_path), "ed")
    data = _load_split(args, args.split)
    result = ed_loop.evaluate(cfg, state, data)
    print(json.dumps(result))


def _resolve_ema_arg(raw, cfg, n_epochs, n_train, flag="--ema"):
    """``--ema DECAY|auto`` → a concrete decay in [0, 1).

    ``auto`` derives the decay from the planned G-update count
    (gan_step.ema_auto_decay — a window of about t/50 updates), so a user
    never has to size the horizon by hand."""
    from melogan_torch.config import validate_ema_decay
    from melogan_torch.train.gan_step import ema_auto_decay

    try:
        if isinstance(raw, str) and raw.strip().lower() == "auto":
            d = ema_auto_decay(cfg, n_epochs, n_train)
            print(f"[INFO] {flag} auto: decay {d:.4g} sized for "
                  f"{n_epochs} epochs x {n_train} rows "
                  f"(window ~ t/50 G updates)")
            return d
        return validate_ema_decay(raw)
    except ValueError as e:
        raise SystemExit(f"{flag}: {e}")


def _train_latents(args):
    """The train split's encoder latents when ``encode`` wrote them."""
    feats_path = os.path.join(args.splits_dir, "train", "encoder_feats.npy")
    return np.load(feats_path) if os.path.exists(feats_path) else None


def _frozen_ed(args, ed_cfg):
    """The pre-trained ED (``ed_best.ckpt``, either package's) as the
    reference-layout state dict that ``gan_step.init_state`` takes, at the
    ED config's layout; None, with the reference's warning, when absent."""
    from melogan_torch.utils import weights
    from melogan_torch.utils.checkpoint import load_checkpoint

    ed_ckpt = args.ed_ckpt or os.path.join(args.workdir, ed_cfg.checkpoint_dir, "ed_best.ckpt")
    if not os.path.exists(ed_ckpt):
        print(f"[WARN] ED checkpoint not found at {ed_ckpt}. ED will be random!")
        return None
    ckpt = load_checkpoint(ed_ckpt)
    sd = weights.export_ed({"params": ckpt["params"], "batch_stats": ckpt.get("batch_stats", {})},
                           notes_blocks=ed_cfg.notes_blocks, mlp_hidden=len(ed_cfg.mlp_hidden))
    print(f"[INFO] loaded frozen ED from {ed_ckpt}")
    return sd


def cmd_train_gan(args):
    from melogan_torch.config import EDConfig, GANConfig
    from melogan_torch.train import gan_loop

    cfg = _load_cfg(GANConfig, args.config, args.workdir)
    ed_cfg = _load_cfg(EDConfig, args.ed_config, args.workdir)
    if args.epochs:
        cfg.epochs = args.epochs
    mesh = _mesh_from_args(args, cfg.batch_size)
    train_data = _load_split(args, "train")
    if getattr(args, "ema", None) is not None:
        cfg.ema_decay = _resolve_ema_arg(args.ema, cfg, cfg.epochs, train_data.n)
    if getattr(args, "fm", None) is not None:
        cfg.lambda_fm = float(args.fm)
    latents = _train_latents(args)
    ed_variables = _frozen_ed(args, ed_cfg)

    # EMA implies --track-best: the gate catches a mis-sized decay (a lagging
    # G_ema scores below the live weights and is never exported as the best
    # artifact) without the user reading docs/operations.md
    track_best = getattr(args, "track_best", False)
    if cfg.ema_decay and not track_best and not getattr(args, "no_track_best", False):
        track_best = True
        print("[INFO] --track-best enabled (default with EMA; disable with "
              "--no-track-best)")

    _, metrics = gan_loop.train(
        cfg, ed_cfg, train_data, latents=latents, ed_variables=ed_variables,
        workdir=args.workdir, resume=getattr(args, "resume", False), mesh=mesh,
        precision=_precision(args), track_best=track_best,
        gate_samples_per_emotion=getattr(args, "gate_samples", 2), device=args.device,
    )
    if _is_main(mesh):
        print(json.dumps(metrics))


def parse_hyper_grid(spec):
    """``--hyper`` JSON → a per-member override list for sweep_gan.

    Accepts row form (a list of override dicts) or column form (a dict of
    equal-length lists: '{"lr_g": [1e-4, 2e-4]}'); key validity is checked
    downstream by gan_step.HyperParams.from_config."""
    if not spec:
        return None
    grid = json.loads(spec)
    if isinstance(grid, dict):
        lens = {len(v) for v in grid.values()}
        if len(lens) != 1:
            raise SystemExit("--hyper column lists must share one length")
        n = lens.pop()
        grid = [{k: v[i] for k, v in grid.items()} for i in range(n)]
    if not isinstance(grid, list) or not all(isinstance(h, dict) for h in grid):
        raise SystemExit("--hyper must be a JSON list of override dicts "
                         "or a dict of equal-length lists")
    return grid


def cmd_sweep(args):
    """Population sweep: K WGAN-GP seeds, or a hyperparameter grid, trained
    side by side and ranked by the golden-band quality gate (train/sweep.py;
    no reference equivalent — the torch scripts train one model per
    process)."""
    from melogan_torch.config import EDConfig, GANConfig
    from melogan_torch.train.sweep import sweep_gan

    cfg = _load_cfg(GANConfig, args.config, args.workdir)
    ed_cfg = _load_cfg(EDConfig, args.ed_config, args.workdir)
    if args.epochs:
        cfg.epochs = args.epochs
    mesh = _mesh_from_args(args)
    train_data = _load_split(args, "train")
    if getattr(args, "ema", None) is not None:
        cfg.ema_decay = _resolve_ema_arg(args.ema, cfg, cfg.epochs, train_data.n)
    latents = _train_latents(args)
    ed_variables = _frozen_ed(args, ed_cfg)
    hyper_grid = parse_hyper_grid(getattr(args, "hyper", None))

    if args.seeds:
        seeds = args.seeds
    elif hyper_grid is not None:
        # a hyper search defaults to a SHARED seed: members differ only in
        # their hyperparameters, so the comparison is init/noise-controlled
        seeds = [cfg.seed] * len(hyper_grid)
    else:
        seeds = [cfg.seed + i for i in range(args.population)]
    report = sweep_gan(
        cfg, ed_cfg, train_data, seeds=seeds, latents=latents,
        ed_variables=ed_variables, workdir=args.workdir,
        samples_per_emotion=args.samples_per_emotion,
        promote_best=args.promote_best, precision=_precision(args),
        hyper_grid=hyper_grid, halving=getattr(args, "halving", False),
        rung_epochs=getattr(args, "rung_epochs", None),
        resume=getattr(args, "resume", False), mesh=mesh, device=args.device,
    )
    if not _is_main(mesh):
        return
    print(json.dumps({"best_seed": report["best_seed"],
                      "best_checkpoint": report["best_checkpoint"],
                      "gate": [{"seed": r["seed"], "passed": r["gate_passed"],
                                "total": r["gate_total"]}
                               for r in report["results"]]}))


def _load_generator(args, cfg):
    """(generator, feature encoder, corpus conditioning) state of the
    ``--checkpoint`` (default ``<workdir>/<checkpoint_dir>/gan_final.ckpt``),
    ``--ema`` taking ``G_ema``; Nones when the file does not exist. Returns
    also the path and whether it was loaded."""
    from melogan_torch.utils.weights import load_gan_final_full

    ckpt_path = args.checkpoint or os.path.join(args.workdir, cfg.checkpoint_dir, "gan_final.ckpt")
    if not os.path.exists(ckpt_path):
        return None, None, None, ckpt_path, False
    gen_sd, fe_sd, extras = load_gan_final_full(ckpt_path, ema=getattr(args, "ema", False))
    return gen_sd, fe_sd, extras["emotion_features"], ckpt_path, True


def cmd_sample(args):
    from melogan_torch.config import GANConfig
    from melogan_torch.constants import BPM_JITTER, EMOTION_BPM
    from melogan_torch.sampling import Sampler, emotion_scale

    cfg = _load_cfg(GANConfig, args.config, args.workdir)
    mesh = _mesh_from_args(args)
    gen_sd, fe_sd, emotion_features, ckpt_path, loaded = _load_generator(args, cfg)
    if loaded:
        print(f"[INFO] loaded generator from {ckpt_path}"
              + (" (EMA weights)" if getattr(args, "ema", False) else "")
              + ("" if emotion_features is None
                 else " (corpus-calibrated conditioning)"))
    else:
        print(f"[WARN] checkpoint not found at {ckpt_path}; sampling with random weights")

    sampler = Sampler(cfg, gen_variables=gen_sd, fe_variables=fe_sd, seed=args.seed,
                      mesh=mesh, emotion_features=emotion_features,
                      device=args.device)
    os.makedirs(args.out, exist_ok=True)
    rng = np.random.default_rng(args.seed)
    emotions = [args.emotion] if args.emotion != "all" else ["happy", "sad", "angry", "calm"]
    # one device batch for all prompts; per-file jittered bpm around the
    # emotion base (test_gan reconstruction; the quality gate derives its
    # tempo bands from the same constant). The bpms and the sampler seed are
    # the JAX CLI's draws from the same numpy stream.
    prompts, paths, bpms = [], [], []
    for emotion in emotions:
        for i in range(1, args.samples + 1):
            prompts.append(emotion)
            paths.append(os.path.join(args.out, f"test_{emotion}_{i}.mid"))
            bpms.append(float(EMOTION_BPM[emotion] * (1.0 + rng.uniform(-BPM_JITTER, BPM_JITTER))))
    sampler.generate_many(prompts, paths, seed=int(rng.integers(0, 2**31)), bpms=bpms)
    for emotion, out, bpm in zip(prompts, paths, bpms):
        print(f"[INFO] wrote {out} (bpm {max(60, min(bpm, 180)):.0f}, "
              f"{emotion_scale(emotion)})")


def cmd_doctor(args):
    """Bounded environment diagnostic: the card, ``nvcc``, the kernel build
    cache, config resolution, data and checkpoint presence, golden
    artifacts. Every check that could touch the device runs in a KILLABLE
    subprocess bounded by ``MELOGAN_DOCTOR_PROBE_SECS`` (default 240): a
    diagnostic tool hanging on the very condition it diagnoses would be
    useless, and the doctor itself never initializes CUDA. Exits nonzero if
    any check FAILs (WARNs don't fail the run). Both of the JAX doctor's
    native codec checks are kept, each built with g++ into
    ``build/melogan_torch/`` at first use: ``native-midi`` (the port's own
    ``midi/midi_codec.cpp``, which refuses a note before time 0) and
    ``native-jpeg`` (``native/jpeg_codec.cpp``). The text backend is checked by its
    configuration (loading it would touch the device): its name and, for
    ``torch-roberta``, that the checkpoint directory holds a config and
    weights."""
    import subprocess
    import time

    work = args.workdir
    results = []  # (level, name, detail)

    def check(level, name, detail):
        results.append((level, name, detail))
        print(f"[{level}] {name}: {detail}")

    def last_line(raw):
        lines = raw.decode("utf-8", "replace").strip().splitlines()
        return lines[-1][:160] if lines else "?"

    probe_secs = float(os.environ.get("MELOGAN_DOCTOR_PROBE_SECS", "240"))

    # the card (subprocess probe; a hung init means a wedged/unavailable card)
    probe = (
        "import subprocess, torch\n"
        "if not torch.cuda.is_available():\n"
        "    raise SystemExit('CUDA is not available')\n"
        "smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',\n"
        "                      '--format=csv,noheader'], capture_output=True, text=True)\n"
        "limit = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else 'nvidia-smi failed'\n"
        "print(f'{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()} | {limit}')\n"
    )
    t0 = time.perf_counter()
    try:
        r = subprocess.run([sys.executable, "-c", probe], timeout=probe_secs, capture_output=True)
        if r.returncode == 0:
            check("OK", "device", f"{r.stdout.decode().strip()} "
                  f"(init {time.perf_counter() - t0:.1f}s)")
        else:
            check("FAIL", "device", f"no usable GPU: {last_line(r.stderr)}")
    except subprocess.TimeoutExpired:
        check("FAIL", "device", f"CUDA init hung >{probe_secs:.0f}s")

    # the CUDA compiler and the kernel build cache
    from melogan_torch.ops import _build

    try:
        nvcc = _build.find_nvcc()
        r = subprocess.run([nvcc, "--version"], timeout=probe_secs, capture_output=True)
        check("OK" if r.returncode == 0 else "FAIL", "nvcc", f"{nvcc}: {last_line(r.stdout)}")
    except RuntimeError as e:
        check("FAIL", "nvcc", str(e))
    except subprocess.TimeoutExpired:
        check("FAIL", "nvcc", f"nvcc --version hung >{probe_secs:.0f}s")
    names = _build.kernel_names()
    state = {n: ("missing" if not _build.library_path(n).exists()
                 else "stale" if _build.is_stale(n) else "built") for n in names}
    fresh = all(s == "built" for s in state.values())
    check("OK" if fresh else "WARN", "kernel-cache",
          f"{_build.BUILD_DIR}: " + ", ".join(f"{n} {s}" for n, s in state.items())
          + ("" if fresh else " (built with nvcc at first use)"))

    # config resolution (the same loader every subcommand uses)
    for name, path in (("ae-config", args.ae_config), ("ed-config", args.ed_config),
                       ("gan-config", args.gan_config)):
        resolved = _resolve_config(path, work)
        if resolved:
            check("OK", name, resolved)
        else:
            check("WARN", name, f"{path} not found; built-in defaults would be used")

    # data + checkpoints under the workdir
    splits_dir = os.path.join(work, "data", "splits")
    have = [s for s in ("train", "val", "test")
            if os.path.exists(os.path.join(splits_dir, s, "notes.npy"))]
    if len(have) == 3:
        n = int(np.load(os.path.join(splits_dir, "train", "notes.npy"),
                        mmap_mode="r").shape[0])
        check("OK", "splits", f"{splits_dir} (train {n} rows)")
    else:
        check("WARN", "splits", f"{splits_dir}: arrays present for {have or 'none'}")
    for name, rel in (("ae-ckpt", "data/models/ae/ae_best.ckpt"),
                      ("ed-ckpt", "data/models/ed/ed_best.ckpt"),
                      ("gan-ckpt", "experiments/gan/checkpoints/gan_final.ckpt")):
        p = os.path.join(work, rel)
        check("OK" if os.path.exists(p) else "WARN", name,
              p if os.path.exists(p) else f"{p} missing")

    # golden artifacts (the ground truth the quality gate's built-in bands
    # were derived from)
    golden = os.environ.get("MELOGAN_REFERENCE_DIR")
    n_golden = 0
    if golden:
        n_golden = len([f for d in ("good_gens1", "generated_tests")
                        for f in (os.listdir(os.path.join(golden, d))
                                  if os.path.isdir(os.path.join(golden, d)) else [])
                        if f.endswith(".mid")])
    check("OK" if n_golden else "WARN", "golden-artifacts",
          f"{n_golden} reference .mid files under {golden}" if n_golden
          else f"none under {golden or '$MELOGAN_REFERENCE_DIR (unset)'} "
               "(the quality gate's bands are built in)")

    # the native MIDI and JPEG encoders (g++ at first use; the Python ones
    # serve without them)
    from melogan_torch.imaging import native as jpeg_native
    from melogan_torch.midi import native as midi_native

    for name, lib in (("native-midi", midi_native), ("native-jpeg", jpeg_native)):
        if lib.get_lib() is not None:
            check("OK", name, f"built ({lib.LIB_PATH})")
        else:
            check("WARN", name, "unavailable (Python fallback serves)"
                  + (f": {lib.load_error()}" if lib.load_error() else ""))

    # the text backend, by its configuration
    from melogan_torch.models.text_emotion import backend_name

    try:
        name = backend_name()
    except ValueError as e:
        check("FAIL", "text-backend", str(e))
    else:
        if name == "torch-roberta":
            d = os.environ["MELOGAN_TEXT_MODEL_DIR"]
            ok = os.path.exists(os.path.join(d, "config.json")) and any(
                os.path.exists(os.path.join(d, f)) for f in ("model.safetensors", "pytorch_model.bin"))
            check("OK" if ok else "FAIL", "text-backend",
                  f"{name} from {d}" + ("" if ok else " (no config.json, or no weights file)"))
        else:
            check("OK", "text-backend", name)

    fails = [n for lv, n, _ in results if lv == "FAIL"]
    print(f"[{'FAIL' if fails else 'OK'}] doctor: "
          f"{len(results) - len(fails)}/{len(results)} checks passed"
          + (f" (failing: {', '.join(fails)})" if fails else ""))
    if fails:
        raise SystemExit(1)


def cmd_pipeline(args):
    """full_script.sh equivalent: synth-data? → preprocess → splits → arrays →
    train-ae → encode → train-ed → train-gan → sample ×4 emotions →
    quality-gate. Prints per-stage wall-clock at the end and writes it to
    ``<workdir>/pipeline_timings.json``.

    Inside the ranks of ``--dp N`` the three train stages run on every
    rank; rank 0 alone runs the data stages, ``encode``, ``sample`` and the
    quality gate (on its own device) and writes the markers and the
    timings, while the others wait. Rank 0 decides every ``--resume`` skip
    and the others follow it."""
    import time
    from types import SimpleNamespace

    from melogan_torch.config import AEConfig, EDConfig, GANConfig
    from melogan_torch.utils.atomic import atomic_write

    timings = []
    work = args.workdir
    data_root = os.path.join(work, "data")
    resume = getattr(args, "resume", False)
    device = args.device
    dp = getattr(args, "dp", 0)
    mesh = _mesh_from_args(args)
    main = _is_main(mesh)

    # EMA implies --gan-track-best (mirrors train-gan's default): the gate
    # protects a mis-sized decay and the sample stage serves the gated-best
    # artifact instead of a possibly lagging final EMA
    if (getattr(args, "gan_ema", None) is not None
            and not getattr(args, "gan_track_best", False)
            and not getattr(args, "no_gan_track_best", False)):
        args.gan_track_best = True
        print("[INFO] --gan-track-best enabled (default with --gan-ema; "
              "disable with --no-gan-track-best)")

    # Completed-stage markers: each finished stage records its invocation
    # signature under .pipeline_done/; --resume skips a stage whose marker
    # matches instead of re-running it (a train stage that COMPLETED would
    # otherwise retrain from scratch whenever its run was shorter than
    # save_freq — no periodic checkpoint to resume from). A marker is only
    # trusted while every upstream stage was also skipped: as soon as one
    # stage actually runs, everything downstream re-runs too.
    done_dir = os.path.join(work, ".pipeline_done")
    # data_sig: the invocation knobs that determine WHAT data the data stages
    # produce. A --resume with a changed --per-emotion (or a different
    # manifest) must regenerate the corpus, not silently retrain on stale
    # data — so done_if gates on it, and it is part of the train-stage sig.
    data_sig = {
        "synthetic": bool(args.synthetic),
        "per_emotion": getattr(args, "per_emotion", None),
        "manifest": None if args.synthetic else args.manifest,
    }
    sig = {
        "epochs": getattr(args, "epochs", None),
        "bf16": getattr(args, "bf16", False),
        "dp": getattr(args, "dp", 0),
        "gan_ema": getattr(args, "gan_ema", None),
        "gan_track_best": getattr(args, "gan_track_best", False),
        "gan_fm": getattr(args, "gan_fm", None),
        "configs": [args.ae_config, args.ed_config, args.gan_config],
        **data_sig,
    }
    upstream_ran = False

    def _read_marker(name):
        try:
            with open(os.path.join(done_dir, f"{name}.json")) as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

    def stage(name, fn, *a, skippable=True, artifacts=(), where="all"):
        """Run (or, on --resume, skip) one stage. ``where``: "all" ranks
        run ``fn``, or rank 0 runs it while the others wait ("main"), or
        rank 0 is the only one here ("solo", the data stages)."""
        nonlocal upstream_ran
        marker = os.path.join(done_dir, f"{name}.json")
        skip = None
        if main:
            skip = bool(resume and skippable and not upstream_ran and os.path.exists(marker)
                        and all(os.path.exists(p) for p in artifacts)
                        and (_read_marker(name) or {}).get("sig") == sig)
        if mesh is not None and where != "solo":
            skip = mesh.broadcast_object(skip)
        if skip:
            if main:
                print(f"[INFO] --resume: skipping {name} "
                      "(completed in a previous run)")
            timings.append((name, 0.0))
            return None
        upstream_ran = True
        t0 = time.perf_counter()
        out = fn(*a) if where != "main" or main else None
        timings.append((name, time.perf_counter() - t0))
        if main:
            os.makedirs(done_dir, exist_ok=True)
            atomic_write(marker, lambda f: json.dump(
                {"stage": name, "sig": sig, "data_sig": data_sig}, f))
        if mesh is not None and where == "main":
            mesh.barrier()
        return out

    def done_if(name, *artifacts):
        # --resume: a data stage whose outputs already exist is skipped (the
        # train stages resume from their own checkpoints instead) — but only
        # if its marker's data_sig matches this invocation (a marker-less
        # workdir, e.g. data staged by individual subcommands, keeps the
        # existence-based skip: there is no record to contradict it)
        if resume and artifacts and all(os.path.exists(p) for p in artifacts):
            saved = _read_marker(name)
            if saved is not None and saved.get("data_sig") != data_sig:
                print(f"[INFO] --resume: re-running {name} "
                      "(data parameters changed since the previous run)")
                return False
            print(f"[INFO] --resume: skipping {name} (outputs exist)")
            timings.append((name, 0.0))
            return True
        return False

    processed = os.path.join(data_root, "processed")
    splits_dir = os.path.join(data_root, "splits")
    manifest = os.path.join(data_root, "data_manifest.csv") if args.synthetic else args.manifest

    # Per-stage output artifacts. A --resume skip requires these to still
    # exist: a matching marker whose checkpoint was since deleted must
    # re-run, or cmd_sample would silently fall back to random weights.
    gan_ckpt_dir = os.path.join(work, _load_cfg(GANConfig, args.gan_config, work).checkpoint_dir)
    arts = {
        "synth-data": (manifest,) if args.synthetic else (),
        "preprocess": (processed, os.path.join(data_root, "scaler.npz")),
        "make-splits": tuple(os.path.join(splits_dir, f"{s}_split.csv")
                             for s in ("train", "val", "test")),
        "split-arrays": tuple(os.path.join(splits_dir, s, f"{a}.npy")
                              for s in ("train", "val", "test")
                              for a in ("notes", "emotion", "numeric_features")),
        "train-ae": (os.path.join(
            work, _load_cfg(AEConfig, args.ae_config, work).checkpoint_dir, "ae_best.ckpt"),),
        "encode": tuple(os.path.join(splits_dir, s, "encoder_feats.npy")
                        for s in ("train", "val", "test")),
        "train-ed": (os.path.join(
            work, _load_cfg(EDConfig, args.ed_config, work).checkpoint_dir, "ed_best.ckpt"),),
        "train-gan": (os.path.join(gan_ckpt_dir, "gan_final.ckpt"),),
    }
    gan_best_path = os.path.join(gan_ckpt_dir, "gan_best.ckpt")
    if getattr(args, "gan_track_best", False):
        arts["train-gan"] = arts["train-gan"] + (gan_best_path,)

    if main:  # the data stages: host work, on rank 0 alone
        if args.synthetic and not done_if("synth-data", *arts["synth-data"]):
            stage("synth-data", cmd_synth_data,
                  SimpleNamespace(out=data_root, per_emotion=args.per_emotion, seed=42),
                  skippable=False, where="solo")
        if not done_if("preprocess", *arts["preprocess"]):
            stage("preprocess", cmd_preprocess,
                  SimpleNamespace(manifest=manifest, out=processed, scaler=None),
                  skippable=False, where="solo")
        if not done_if("make-splits", *arts["make-splits"]):
            stage("make-splits", cmd_make_splits,
                  SimpleNamespace(manifest=manifest, out=splits_dir, seed=42),
                  skippable=False, where="solo")
        if not done_if("split-arrays", *arts["split-arrays"]):
            stage("split-arrays", cmd_split_arrays,
                  SimpleNamespace(splits=["train", "val", "test"], splits_dir=splits_dir,
                                  processed_dir=processed),
                  skippable=False, where="solo")
    if mesh is not None:  # the other ranks follow rank 0's data stages
        upstream_ran = mesh.broadcast_object(upstream_ran)
    base = SimpleNamespace(
        workdir=work, splits_dir=splits_dir, processed_dir=processed,
        config=args.ae_config, epochs=args.epochs, checkpoint=None,
        bf16=getattr(args, "bf16", False), resume=resume, device=device, dp=dp,
    )
    stage("train-ae", cmd_train_ae, base, artifacts=arts["train-ae"])
    stage("encode", cmd_encode,
          SimpleNamespace(**{**vars(base), "splits": ["train", "val", "test"]}),
          artifacts=arts["encode"], where="main")
    stage("train-ed", cmd_train_ed,
          SimpleNamespace(**{**vars(base), "config": args.ed_config}),
          artifacts=arts["train-ed"])
    stage("train-gan", cmd_train_gan,
          SimpleNamespace(**{**vars(base), "config": args.gan_config,
                             "ed_config": args.ed_config, "ed_ckpt": None,
                             "ema": getattr(args, "gan_ema", None),
                             "track_best": getattr(args, "gan_track_best", False),
                             "fm": getattr(args, "gan_fm", None)}),
          artifacts=arts["train-gan"])
    gen_dir = os.path.join(work, "generated_tests")
    # downstream serves what training selected: the gate-tracked best when
    # --gan-track-best produced one, its EMA weights when --gan-ema trained
    sample_ckpt = (gan_best_path if getattr(args, "gan_track_best", False)
                   and os.path.exists(gan_best_path) else None)
    stage("sample", cmd_sample, SimpleNamespace(
        workdir=work, config=args.gan_config, checkpoint=sample_ckpt,
        emotion="all", samples=2, seed=42, out=gen_dir,
        ema=getattr(args, "gan_ema", None) is not None, device=device,
    ), artifacts=(gen_dir,), where="main")
    # golden-band quality gate over the fresh samples
    if not getattr(args, "skip_quality_gate", False):
        stage("quality-gate", cmd_quality_gate,
              SimpleNamespace(dir=gen_dir, strict=True), skippable=False, where="main")
    if not main:
        return
    total = sum(t for _, t in timings)
    print("[INFO] pipeline stage timings: "
          + " | ".join(f"{n} {t:.1f}s" for n, t in timings)
          + f" | total {total:.1f}s")
    # persist the timings for tooling (demo summaries, regression checks)
    atomic_write(
        os.path.join(work, "pipeline_timings.json"),
        lambda f: json.dump(
            {"stages": [{"name": n, "seconds": round(t, 3)} for n, t in timings],
             "total_seconds": round(total, 3),
             "resumed": resume}, f),
    )
    print("[INFO] pipeline complete")


def cmd_diagnose(args):
    from melogan_torch.diagnostics.diagnose import diagnose

    data = _load_split(args, args.split)
    feats_path = os.path.join(args.splits_dir, args.split, "encoder_feats.npy")
    latents = np.load(feats_path) if os.path.exists(feats_path) else None
    report = diagnose(data, latents)
    print(json.dumps(report, indent=2, default=str))


def cmd_analyze_midi(args):
    from melogan_torch.diagnostics.analyze_midi import analyze_file

    for path in args.files:
        stats = analyze_file(path)
        print(json.dumps({"file": os.path.basename(path), **stats}))


def cmd_import_checkpoint(args):
    """Convert a reference torch ``.pth`` checkpoint into the ``.ckpt``
    format (migration path for reference users), through the port's own
    converters (``utils/weights.py``).

    Reference layouts (SURVEY.md §5): ae_best {'epoch','model_state'} or a
    raw state_dict (ae_final); ed_best {'epoch','model','optimizer','cfg'};
    gan_final {'G','E_num'} state dicts. The file loads with
    ``weights_only=True``: tensors and containers only, no pickled code.
    """
    import torch

    from melogan_torch.utils import weights
    from melogan_torch.utils.checkpoint import save_checkpoint

    raw = torch.load(args.pth, map_location="cpu", weights_only=True)

    def epoch():
        return int(raw.get("epoch", 0)) if isinstance(raw, dict) else 0

    if args.kind == "ae":
        sd = raw.get("model_state", raw.get("model", raw)) if isinstance(raw, dict) else raw
        variables = weights.convert_vae(sd)
        tree = {"epoch": epoch(), "params": variables["params"],
                "batch_stats": variables["batch_stats"]}
    elif args.kind == "ed":
        from melogan_torch.config import EDConfig

        ed_cfg = (_load_cfg(EDConfig, args.ed_config, getattr(args, "workdir", "."))
                  if args.ed_config else EDConfig())
        sd = raw.get("model", raw) if isinstance(raw, dict) else raw
        variables = weights.convert_ed(sd, notes_blocks=ed_cfg.notes_blocks,
                                       mlp_hidden=len(ed_cfg.mlp_hidden))
        tree = {"epoch": epoch(), "params": variables["params"],
                "batch_stats": variables.get("batch_stats", {})}
    else:  # "gan" (argparse choices guard the kind)
        gen_vars, fe_vars = weights.convert_gan_final(raw)
        tree = {"G": gen_vars, "E_num": fe_vars}

    save_checkpoint(args.out, tree)
    print(f"[INFO] imported {args.kind} checkpoint {args.pth} -> {args.out}")
    print("[NOTE] imported checkpoints carry params/stats for inference and "
          "warm-starting; optimizer state is not part of the reference format")


def cmd_export_checkpoint(args):
    """Convert a ``.ckpt`` back into the reference torch ``.pth`` layouts
    (the inverse of ``import-checkpoint`` — migration is two-way).

    Output layouts match what the reference scripts write/read:
    ae → {'epoch','model_state'} (src/ae/train_ae.py:197), ed →
    {'epoch','model','optimizer','cfg'} (train_ed.py:41-47), gan →
    {'G','E_num'} (train_gan.py:279-282), plus 'D'/'epoch' when the source
    is a periodic gan_epoch ckpt. The optimizer state of a ``.ckpt`` is
    optax's layout, so 'optimizer' exports as an empty dict — the reference
    never reloads it anyway (SURVEY.md §5).
    """
    import torch

    from melogan_torch.utils import weights
    from melogan_torch.utils.checkpoint import load_checkpoint

    ckpt = load_checkpoint(args.ckpt)

    def t(sd):
        return {k: torch.from_numpy(np.array(v, copy=True)) for k, v in sd.items()}

    if args.kind == "ae":
        sd = weights.export_vae({"params": ckpt["params"], "batch_stats": ckpt["batch_stats"]})
        out = {"epoch": int(ckpt.get("epoch", 0)), "model_state": t(sd)}
    elif args.kind == "ed":
        sd = weights.export_ed({"params": ckpt["params"],
                                "batch_stats": ckpt.get("batch_stats", {})})
        out = {"epoch": int(ckpt.get("epoch", 0)), "model": t(sd), "optimizer": {},
               "cfg": dict(ckpt.get("cfg", {}))}
    else:  # "gan" (argparse choices guard the kind)
        out = {"G": t(weights.export_generator(ckpt["G"])),
               "E_num": t(weights.export_feature_encoder(ckpt["E_num"]))}
        if "D" in ckpt:  # periodic gan_epoch layout carries the critic too
            out["D"] = t(weights.export_critic(ckpt["D"]))
        if "epoch" in ckpt:
            out["epoch"] = int(ckpt["epoch"])

    torch.save(out, args.out)
    print(f"[INFO] exported {args.kind} checkpoint {args.ckpt} -> {args.out}")


def cmd_quality_gate(args):
    """Check generated .mid files against the golden-artifact bands."""
    from melogan_torch.diagnostics.quality import band_breakdown, gate_directory

    tier = getattr(args, "tier", "default")
    report = gate_directory(args.dir, tier=tier)
    for name, entry in report.get("files", {}).items():
        status = "PASS" if not entry["violations"] else "FAIL"
        print(f"[{status}] {name} ({entry['emotion']})")
        for v in entry["violations"]:
            print(f"         {v}")
    if getattr(args, "breakdown", False):
        bd = band_breakdown(report, tier=tier)
        print(f"[BREAKDOWN] per-metric ({tier} tier):")
        for metric, m in sorted(bd["per_metric"].items(),
                                key=lambda kv: -kv[1]["n_fail"]):
            if m["n_fail"]:
                print(f"  {metric:14s} {m['n_fail']} file(s) out of band; "
                      f"worst delta {m['worst_delta']:+g} "
                      f"({', '.join(m['failing_files'])})")
            else:
                print(f"  {metric:14s} all files in band")
        out = getattr(args, "breakdown_json", None)
        if out:
            from melogan_torch.utils.atomic import atomic_write

            atomic_write(out, lambda f: json.dump(bd, f, indent=2))
            print(f"[INFO] breakdown -> {out}")
    if report.get("error"):
        print(f"[FAIL] {report['error']}")
    print(f"[{'PASS' if report['ok'] else 'FAIL'}] quality gate ({tier} tier): "
          f"{sum(1 for e in report.get('files', {}).values() if not e['violations'])}"
          f"/{len(report.get('files', {}))} files within golden bands")
    if not report["ok"] and getattr(args, "strict", True):
        raise SystemExit(1)
    return report


def cmd_eval_gen(args):
    """Independent emotion-accuracy evaluation of fresh generated samples: a
    judge ED trained on the held-out val split (different seed, never inside
    G's loss) classifies sampler output per emotion. Writes
    ``eval_gen.json``.

    As in the JAX CLI (ROADMAP C.6): the judge trains with the test split as
    its validation set (model selection), and ``judge_real`` then scores the
    judge on those same test rows; and any error of that calibration step
    (a bare ``except Exception``) leaves ``judge_real`` None with a
    warning."""
    from melogan_torch.config import EDConfig, GANConfig
    from melogan_torch.diagnostics import judge as judge_mod
    from melogan_torch.sampling import Sampler
    from melogan_torch.train import ed_loop
    from melogan_torch.utils.atomic import atomic_write
    from melogan_torch.utils.checkpoint import load_checkpoint

    cfg = _load_cfg(GANConfig, args.config, args.workdir)
    ed_cfg = _load_cfg(EDConfig, args.ed_config, args.workdir)
    judge_cfg = judge_mod.judge_config(ed_cfg, epochs=args.judge_epochs)

    judge_ckpt = os.path.join(args.workdir, judge_cfg.checkpoint_dir, "ed_best.ckpt")
    test_data = None
    if os.path.exists(judge_ckpt) and not args.retrain_judge:
        judge_state = ed_loop.init_state(judge_cfg, seed=judge_cfg.seed, device=args.device)
        _load_trained(judge_state, load_checkpoint(judge_ckpt), "ed")
        print(f"[INFO] loaded judge ED from {judge_ckpt}")
    else:
        val_data = _load_split(args, "val")
        test_data = _load_split(args, "test")
        print(f"[INFO] training judge ED on the held-out val split "
              f"({val_data.n} rows; test split as judge-val, {test_data.n} rows)")
        judge_cfg, judge_state = judge_mod.train_judge(
            ed_cfg, val_data, test_data, workdir=args.workdir,
            epochs=args.judge_epochs, verbose=False, device=args.device,
        )
        print(f"[INFO] judge saved -> {judge_ckpt}")

    # Judge calibration: the same judge scored on REAL held-out test rows.
    # A generated-sample accuracy is only meaningful relative to this — a
    # judge that cannot classify real music bounds what the generated number
    # can say.
    judge_real = None
    try:
        if test_data is None:
            test_data = _load_split(args, "test")
        judge_real = judge_mod.judge_notes(
            judge_cfg, judge_state, test_data.notes_gan(), test_data.emotion_idx)
        print(f"[INFO] judge on REAL held-out test data: "
              f"{judge_real['accuracy']:.1%} over {judge_real['n']} rows")
    except Exception as exc:  # splits may be absent when judging a bare ckpt
        print(f"[WARN] judge real-data calibration skipped: {exc}")

    gen_sd, fe_sd, emotion_features, ckpt_path, loaded = _load_generator(args, cfg)
    if loaded:
        print(f"[INFO] loaded generator from {ckpt_path}"
              + (" (EMA weights)" if getattr(args, "ema", False) else ""))
    else:
        print(f"[WARN] checkpoint not found at {ckpt_path}; judging RANDOM weights")

    sampler = Sampler(cfg, gen_variables=gen_sd, fe_variables=fe_sd, seed=args.seed,
                      emotion_features=emotion_features, device=args.device)
    report = judge_mod.judge_generated(judge_cfg, judge_state, sampler,
                                       n_per_emotion=args.samples, seed=args.seed)
    print(f"[INFO] judge-ED accuracy over {report['n']} fresh samples: "
          f"{report['accuracy']:.1%} (chance {report['chance']:.0%})")
    for emotion, entry in report["per_emotion"].items():
        acc = entry["accuracy"]
        print(f"    {emotion:6s} {'' if acc is None else f'{acc:.1%}'} "
              f"(n={entry['n']})")
    report["judge_real"] = judge_real
    out_path = os.path.join(args.workdir, "eval_gen.json")
    atomic_write(out_path, lambda f: json.dump(report, f, indent=1))
    print(f"[INFO] wrote {out_path}")
    if args.min_accuracy is not None and report["accuracy"] < args.min_accuracy:
        raise SystemExit(
            f"[FAIL] judge-ED accuracy {report['accuracy']:.3f} below the "
            f"--min-accuracy gate {args.min_accuracy}")
    return report


def cmd_text_eval(args):
    """Measured accuracy of the offline text-emotion backends on the
    held-out eval split (the lexicon and the text MLP, trained or loaded
    from its cache on the device); ``--ceiling`` adds the ceiling study."""
    from melogan_torch.diagnostics.text_eval import ceiling_study, compare_offline_backends

    report = compare_offline_backends(seed=args.seed, verbose=True, device=args.device)
    if args.ceiling:
        report["ceiling"] = ceiling_study(seed=args.seed, verbose=True, device=args.device)
    if args.json:
        print(json.dumps(report))
    return report


def cmd_tsne(args):
    from melogan_torch.diagnostics.tsne import visualize_latents

    out = visualize_latents(args.splits_dir, args.split, args.processed_dir, out_dir=args.out)
    print(f"[INFO] wrote {out}")


def cmd_serve(args):
    from melogan_torch.config import GANConfig
    from melogan_torch.serving.app import serve

    # resolve the config exactly like every other subcommand (as given →
    # --workdir → repo root)
    cfg = _load_cfg(GANConfig, args.config, args.workdir)
    serve(host=args.host, port=args.port, workdir=args.workdir,
          config=cfg, checkpoint=args.checkpoint,
          fast_math=getattr(args, "fast_math", False),
          watch_ckpt=getattr(args, "watch_ckpt", 0.0), dp=getattr(args, "dp", 0),
          use_ema=getattr(args, "ema", False), device=args.device)


def cmd_roll_to_midi(args):
    from melogan_torch.midi.codec import raw_roll_to_song

    roll = np.load(args.roll)
    out = args.out or "generated_sample.mid"
    raw_roll_to_song(roll, bpm=args.bpm).write(out)
    print(f"Wrote {out}")


def cmd_clean(args):
    from melogan_torch.utils.cleaner import bulk_delete

    report = bulk_delete(args.workdir, dry_run=not args.confirm, confirm=args.confirm)
    mode = "DRY RUN — would delete" if report["dry_run"] or not args.confirm else "deleted"
    for p in report["planned"]:
        print(f"[{mode}] {p}")
    if report.get("deleted"):
        print(f"[INFO] removed {len(report['deleted'])} artifact paths")
    elif not args.confirm:
        print("[INFO] pass --confirm to actually delete")


def cmd_logs(args):
    from melogan_torch.utils.metrics import read_tfevents

    events = []
    for root, _, files in os.walk(args.log_dir):
        for f in files:
            if f.startswith("events.out"):
                events.extend(read_tfevents(os.path.join(root, f)))
    tags = sorted({t for t, _, _ in events})
    if args.tag:
        series = sorted(((s, v) for t, v, s in events if t == args.tag))
        for step, value in series:
            print(f"{step}\t{value}")
    else:
        for tag in tags:
            series = sorted(((s, v) for t, v, s in events if t == tag))
            if series:
                print(f"{tag}: {series[0][1]:.4f} -> {series[-1][1]:.4f} "
                      f"({len(series)} points)")


def cmd_profile(args):
    """Time the sampling hot path: ``Sampler.sample_notes`` on the four
    emotion prompts, ``--steps`` times under a ``StepTimer``, after one call
    outside the window; with ``--trace-dir`` a ``torch.profiler`` trace of
    the timed calls lands there as ``trace.json`` (Perfetto,
    chrome://tracing), and the program's spans in those calls as
    ``spans.json``: per span name its count, host and self seconds
    (``table``), and each span's name, thread, start and end in Unix ns
    (the trace's clock), parent and root (``records``)."""
    from melogan_torch.config import GANConfig
    from melogan_torch.sampling import Sampler
    from melogan_torch.utils.profiling import StepTimer, device_trace

    cfg = _load_cfg(GANConfig, args.config, getattr(args, "workdir", "."))
    sampler = Sampler(cfg, seed=0, device=args.device)
    sampler.sample_notes(["happy"], seed=0)  # first call outside the window
    timer = StepTimer()
    with device_trace(args.trace_dir):
        for i in range(args.steps):
            with timer:
                sampler.sample_notes(["happy", "sad", "angry", "calm"], seed=i)
    out = {"batch": 4, **timer.summary()}
    if args.trace_dir:
        out["trace_dir"] = args.trace_dir
    print(json.dumps(out))
    return out


def cmd_bench(args):
    """The port's benchmark (``melogan_torch/bench.py``) on ``--device``:
    one JSON line, its CPU baseline from a child process."""
    from melogan_torch import bench

    bench.main([], device=args.device)


def build_parser():
    p = argparse.ArgumentParser(prog="python -m melogan_torch", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where the models run (default cuda; cpu runs each kernel's "
                        "plain PyTorch version). There is no fallback: cuda "
                        "without a card raises")
    sub = p.add_subparsers(dest="cmd", required=True)

    s = sub.add_parser("synth-data", help="generate a synthetic labelled corpus")
    s.add_argument("--out", default="data")
    s.add_argument("--per-emotion", type=int, default=64, dest="per_emotion")
    s.add_argument("--seed", type=int, default=42)
    s.set_defaults(fn=cmd_synth_data)

    s = sub.add_parser("preprocess", help="raw MIDI → per-song .npz")
    s.add_argument("--manifest", required=True)
    s.add_argument("--out", default="data/processed")
    s.add_argument("--scaler", default=None)
    s.set_defaults(fn=cmd_preprocess)

    s = sub.add_parser("make-splits", help="manifest → stratified split CSVs")
    s.add_argument("--manifest", required=True)
    s.add_argument("--out", default="data/splits")
    s.add_argument("--seed", type=int, default=42)
    s.add_argument("--ratios", default=None, metavar="TR/VA/TE",
                   help="split fractions, e.g. 0.5/0.25/0.25 (default "
                        "0.70/0.15/0.15; tiny corpora need coarser cuts so "
                        "no split lands empty)")
    s.set_defaults(fn=cmd_make_splits)

    s = sub.add_parser("split-arrays", help="per-split fast-path arrays")
    s.add_argument("--splits", nargs="+", default=["train", "val", "test"])
    s.add_argument("--splits-dir", default="data/splits")
    s.add_argument("--processed-dir", default="data/processed")
    s.set_defaults(fn=cmd_split_arrays)

    dp_help = "data-parallel device count: N ranks, one a device (0 = single device)"
    bf16_help = "bf16 training (one-pass bf16 products, f32 sums)"
    for name, fn, cfg_default in (
        ("train-ae", cmd_train_ae, "configs/ae.yaml"),
        ("train-ed", cmd_train_ed, "configs/ed.yaml"),
    ):
        s = sub.add_parser(name)
        s.add_argument("--config", default=cfg_default)
        s.add_argument("--workdir", default=".")
        s.add_argument("--splits-dir", default="data/splits")
        s.add_argument("--processed-dir", default="data/processed")
        s.add_argument("--epochs", type=int, default=None)
        s.add_argument("--resume", action="store_true")
        s.add_argument("--dp", type=int, default=0, help=dp_help)
        s.add_argument("--bf16", action="store_true", help=bf16_help)
        s.set_defaults(fn=fn)

    s = sub.add_parser("encode", help="export µ latents per split")
    s.add_argument("--config", default="configs/ae.yaml")
    s.add_argument("--checkpoint", default=None)
    s.add_argument("--workdir", default=".")
    s.add_argument("--splits-dir", default="data/splits")
    s.add_argument("--processed-dir", default="data/processed")
    s.add_argument("--splits", nargs="+", default=["train", "val", "test"])
    s.set_defaults(fn=cmd_encode)

    s = sub.add_parser("eval-ed", help="evaluate the emotion discriminator")
    s.add_argument("--config", default="configs/ed.yaml")
    s.add_argument("--checkpoint", default=None)
    s.add_argument("--workdir", default=".")
    s.add_argument("--splits-dir", default="data/splits")
    s.add_argument("--processed-dir", default="data/processed")
    s.add_argument("--split", default="test")
    s.set_defaults(fn=cmd_eval_ed)

    s = sub.add_parser("train-gan")
    s.add_argument("--config", default="configs/gan.yaml")
    s.add_argument("--ed-config", default="configs/ed.yaml", dest="ed_config")
    s.add_argument("--ed-ckpt", default=None, dest="ed_ckpt")
    s.add_argument("--workdir", default=".")
    s.add_argument("--splits-dir", default="data/splits")
    s.add_argument("--processed-dir", default="data/processed")
    s.add_argument("--epochs", type=int, default=None)
    s.add_argument("--resume", action="store_true",
                   help="restart from the newest periodic checkpoint")
    s.add_argument("--ema", default=None, metavar="DECAY|auto",
                   help="track a generator weight EMA (e.g. 0.999); "
                        "checkpoints gain G_ema, served via sample/serve "
                        "--ema. 'auto' sizes the decay from the planned "
                        "G-update count (window ~ t/50); implies --track-best")
    s.add_argument("--track-best", action="store_true", dest="track_best",
                   help="score fresh samples against the golden-band quality "
                        "gate at every checkpoint cadence and keep the best "
                        "weights as gan_best.ckpt; ON by default when "
                        "--ema is set")
    s.add_argument("--no-track-best", action="store_true", dest="no_track_best",
                   help="opt out of the EMA-implied --track-best default")
    s.add_argument("--fm", type=float, default=None, metavar="LAMBDA",
                   help="per-emotion note-space feature-matching loss weight "
                        "(documented deviation, default 0 = exact reference "
                        "loss; YAML key LAMBDA_FM)")
    s.add_argument("--gate-samples", type=int, default=2, dest="gate_samples",
                   help="gate samples per emotion for --track-best")
    s.add_argument("--dp", type=int, default=0, help=dp_help)
    s.add_argument("--bf16", action="store_true", help=bf16_help)
    s.set_defaults(fn=cmd_train_gan)

    s = sub.add_parser(
        "sweep",
        help="population training: K GAN seeds (or a --hyper grid), "
             "quality-gate-ranked (train/sweep.py)")
    s.add_argument("--config", default="configs/gan.yaml")
    s.add_argument("--ed-config", default="configs/ed.yaml", dest="ed_config")
    s.add_argument("--ed-ckpt", default=None, dest="ed_ckpt")
    s.add_argument("--workdir", default=".")
    s.add_argument("--splits-dir", default="data/splits")
    s.add_argument("--processed-dir", default="data/processed")
    s.add_argument("--epochs", type=int, default=None)
    s.add_argument("--seeds", type=int, nargs="+", default=None,
                   help="explicit member seeds (default: cfg.seed .. +K-1; "
                        "with --hyper: cfg.seed shared by every member)")
    s.add_argument("--population", type=int, default=4,
                   help="member count when --seeds is not given")
    s.add_argument("--hyper", default=None,
                   help="JSON hyperparameter grid: a list of per-member "
                        "override dicts (keys: lr_g, lr_d, lambda_gp, "
                        "lambda_emotion, lambda_fm) or a dict of equal-length "
                        "lists, e.g. '{\"lr_g\": [1e-4, 2e-4, 4e-4]}'")
    s.add_argument("--samples-per-emotion", type=int, default=2,
                   help="gate samples generated per emotion per member")
    s.add_argument("--halving", action="store_true",
                   help="successive-halving search: per rung, train the "
                        "population --rung-epochs, rank by the quality gate, "
                        "keep the top half (state + shuffle streams carry "
                        "over); the winner trains on to --epochs total")
    s.add_argument("--rung-epochs", type=int, default=None, dest="rung_epochs",
                   help="epochs per halving rung (default: SAVE_FREQ)")
    s.add_argument("--promote-best", action="store_true",
                   help="copy the winning member to the stage's gan_final.ckpt")
    s.add_argument("--resume", action="store_true",
                   help="continue an interrupted sweep from sweep_state.ckpt "
                        "(trajectory-identical to straight-through; the "
                        "invocation must match the interrupted run)")
    s.add_argument("--ema", default=None, metavar="DECAY|auto",
                   help="track per-member generator EMAs; the gate then "
                        "ranks EMA weights and finals carry G_ema ('auto' "
                        "sizes the decay from the planned G-update count)")
    s.add_argument("--dp", type=int, default=0,
                   help="shard the population over N ranks, one a device")
    s.add_argument("--bf16", action="store_true", help=bf16_help)
    s.set_defaults(fn=cmd_sweep)

    s = sub.add_parser("sample", help="emotion-conditioned MIDI generation")
    s.add_argument("--emotion", default="all", choices=["all", "happy", "sad", "angry", "calm"])
    s.add_argument("--samples", type=int, default=1)
    s.add_argument("--seed", type=int, default=42)
    s.add_argument("--config", default="configs/gan.yaml")
    s.add_argument("--checkpoint", default=None)
    s.add_argument("--workdir", default=".")
    s.add_argument("--out", default="generated_tests")
    s.add_argument("--ema", action="store_true",
                   help="sample from the EMA generator weights (G_ema)")
    s.add_argument("--dp", type=int, default=0,
                   help="shard the sample batch over N local devices")
    s.set_defaults(fn=cmd_sample)

    s = sub.add_parser("pipeline", help="all stages end-to-end")
    s.add_argument("--workdir", default=".")
    s.add_argument("--synthetic", action="store_true")
    s.add_argument("--per-emotion", type=int, default=32, dest="per_emotion")
    s.add_argument("--manifest", default=None)
    s.add_argument("--epochs", type=int, default=None)
    s.add_argument("--ae-config", default="configs/ae.yaml", dest="ae_config")
    s.add_argument("--ed-config", default="configs/ed.yaml", dest="ed_config")
    s.add_argument("--gan-config", default="configs/gan.yaml", dest="gan_config")
    s.add_argument("--skip-quality-gate", action="store_true", dest="skip_quality_gate",
                   help="skip the final golden-band quality gate")
    s.add_argument("--gan-ema", default=None, dest="gan_ema",
                   metavar="DECAY|auto",
                   help="train the GAN stage with a generator weight EMA; "
                        "the sample stage then samples the EMA weights "
                        "('auto' sizes the decay from the planned G-update "
                        "count; implies --gan-track-best)")
    s.add_argument("--gan-track-best", action="store_true", dest="gan_track_best",
                   help="gate-score GAN checkpoints during training and "
                        "sample from gan_best.ckpt instead of gan_final; ON "
                        "by default when --gan-ema is set")
    s.add_argument("--no-gan-track-best", action="store_true",
                   dest="no_gan_track_best",
                   help="opt out of the EMA-implied --gan-track-best default")
    s.add_argument("--gan-fm", type=float, default=None, dest="gan_fm",
                   metavar="LAMBDA",
                   help="feature-matching loss weight for the GAN stage "
                        "(documented deviation, default 0 = reference loss)")
    s.add_argument("--resume", action="store_true",
                   help="continue an interrupted run: skip data stages whose "
                        "outputs exist and stages whose completion marker "
                        "matches, resume each train stage from its "
                        "checkpoints (step-identical)")
    s.add_argument("--bf16", action="store_true", help="bf16 training for all three stages")
    s.add_argument("--dp", type=int, default=0,
                   help="data-parallel device count for all three train stages")
    s.set_defaults(fn=cmd_pipeline)

    s = sub.add_parser("doctor", help="environment diagnostic (card, nvcc, kernel "
                                      "cache, configs, data) — bounded, never "
                                      "hangs on a wedged device")
    s.add_argument("--workdir", default=".")
    s.add_argument("--ae-config", default="configs/ae.yaml", dest="ae_config")
    s.add_argument("--ed-config", default="configs/ed.yaml", dest="ed_config")
    s.add_argument("--gan-config", default="configs/gan.yaml", dest="gan_config")
    s.set_defaults(fn=cmd_doctor)

    s = sub.add_parser("diagnose", help="data-sanity diagnostics")
    s.add_argument("--split", default="train")
    s.add_argument("--splits-dir", default="data/splits")
    s.add_argument("--processed-dir", default="data/processed")
    s.set_defaults(fn=cmd_diagnose)

    s = sub.add_parser("analyze-midi", help="per-file MIDI statistics")
    s.add_argument("files", nargs="+")
    s.set_defaults(fn=cmd_analyze_midi)

    s = sub.add_parser("bench", help="benchmark harness")
    s.set_defaults(fn=cmd_bench)

    s = sub.add_parser("profile", help="time (and trace) the sampling hot path")
    s.add_argument("--steps", type=int, default=20)
    s.add_argument("--config", default="configs/gan.yaml")
    s.add_argument("--trace-dir", default=None, dest="trace_dir")
    s.set_defaults(fn=cmd_profile)

    s = sub.add_parser("import-checkpoint",
                       help="convert a reference torch .pth checkpoint to .ckpt")
    s.add_argument("pth")
    s.add_argument("out")
    s.add_argument("--kind", choices=["ae", "ed", "gan"], required=True)
    s.add_argument("--ed-config", default=None, dest="ed_config")
    s.set_defaults(fn=cmd_import_checkpoint)

    s = sub.add_parser("export-checkpoint",
                       help="convert a .ckpt back to the reference torch .pth layout")
    s.add_argument("ckpt")
    s.add_argument("out")
    s.add_argument("--kind", choices=["ae", "ed", "gan"], required=True)
    s.set_defaults(fn=cmd_export_checkpoint)

    s = sub.add_parser(
        "augment-corpus",
        help="expand real MIDI sources into an augmentation-expanded corpus "
             "(K variants/song, leakage-safe grouped splits)",
    )
    s.add_argument("--manifest", required=True,
                   help="CSV with file_key, emotion, full_path columns")
    s.add_argument("--out", required=True, help="output corpus root")
    s.add_argument("--per-song", type=int, default=20, dest="per_song")
    s.add_argument("--ratios", default="0.5/0.25/0.25",
                   help="train/val/test fractions over SOURCE songs")
    s.add_argument("--seed", type=int, default=42)
    s.set_defaults(fn=cmd_augment_corpus)

    s = sub.add_parser("quality-gate",
                       help="check generated .mid files against the golden-artifact bands")
    s.add_argument("dir")
    s.add_argument("--no-strict", dest="strict", action="store_false",
                   help="report violations without failing")
    s.add_argument("--tier", choices=("default", "strict"), default="default",
                   help="band tier: 'strict' = raw golden envelopes "
                        "(no safety margins)")
    s.add_argument("--breakdown", action="store_true",
                   help="print a per-metric table: which bands fail, by how "
                        "much, in which files")
    s.add_argument("--breakdown-json", default=None, dest="breakdown_json",
                   metavar="PATH", help="also write the full per-file "
                        "per-metric breakdown as JSON")
    s.set_defaults(fn=cmd_quality_gate, strict=True)

    s = sub.add_parser("eval-gen",
                       help="judge-ED emotion accuracy of fresh generated samples "
                            "(independent of the in-loss ED)")
    s.add_argument("--config", default="configs/gan.yaml")
    s.add_argument("--ed-config", default="configs/ed.yaml")
    s.add_argument("--checkpoint", default=None,
                   help="generator checkpoint (default workdir gan_final.ckpt)")
    s.add_argument("--ema", action="store_true",
                   help="judge the EMA generator weights")
    s.add_argument("--workdir", default=".")
    s.add_argument("--splits-dir", default="data/splits")
    s.add_argument("--processed-dir", default="data/processed")
    s.add_argument("--samples", type=int, default=8, metavar="N",
                   help="fresh samples per emotion (default 8)")
    s.add_argument("--seed", type=int, default=1234)
    s.add_argument("--judge-epochs", type=int, default=None,
                   help="judge training epochs (default: ed config epochs)")
    s.add_argument("--retrain-judge", action="store_true",
                   help="retrain even if a judge checkpoint exists")
    s.add_argument("--min-accuracy", type=float, default=None,
                   help="exit nonzero when overall judge accuracy is below "
                        "this (optional gate)")
    s.set_defaults(fn=cmd_eval_gen)

    s = sub.add_parser(
        "text-eval",
        help="measured accuracy of the offline text-emotion backends",
    )
    s.add_argument("--seed", type=int, default=0)
    s.add_argument("--json", action="store_true")
    s.add_argument("--ceiling", action="store_true",
                   help="add the ceiling study: 1-NN surface baseline, "
                        "train-self capacity check, confusion matrix, "
                        "misclassified examples")
    s.set_defaults(fn=cmd_text_eval)

    s = sub.add_parser("tsne", help="latent-space t-SNE visualization")
    s.add_argument("--split", default="train")
    s.add_argument("--splits-dir", default="data/splits")
    s.add_argument("--processed-dir", default="data/processed")
    s.add_argument("--out", default="experiments")
    s.set_defaults(fn=cmd_tsne)

    s = sub.add_parser("serve", help="HTTP serving app")
    s.add_argument("--host", default="0.0.0.0")
    s.add_argument("--port", type=int, default=5000)
    s.add_argument("--workdir", default=".")
    s.add_argument("--config", default="configs/gan.yaml")
    s.add_argument("--checkpoint", default=None)
    s.add_argument("--fast-math", action="store_true", dest="fast_math",
                   help="one-pass bf16 products: not f32-deterministic bytes")
    s.add_argument("--dp", type=int, default=0,
                   help="shard every sample batch over N local devices")
    s.add_argument("--watch-ckpt", type=float, default=0.0, dest="watch_ckpt",
                   metavar="SECS",
                   help="auto hot-reload the checkpoint when its mtime "
                        "changes, polled every SECS (0 = off; POST /reload "
                        "swaps on demand either way)")
    s.add_argument("--ema", action="store_true",
                   help="serve the EMA generator weights (G_ema) from every "
                        "loaded checkpoint, incl. hot-swaps")
    s.set_defaults(fn=cmd_serve)

    s = sub.add_parser("roll-to-midi", help="raw (pitch,vel,dur,start) .npy → .mid")
    s.add_argument("roll")
    s.add_argument("--out", default=None)
    s.add_argument("--bpm", type=float, default=120.0)
    s.set_defaults(fn=cmd_roll_to_midi)

    s = sub.add_parser("clean", help="delete generated artifacts (dry-run by default)")
    s.add_argument("--workdir", default=".")
    s.add_argument("--confirm", action="store_true")
    s.set_defaults(fn=cmd_clean)

    s = sub.add_parser("logs", help="inspect tfevents training curves")
    s.add_argument("log_dir")
    s.add_argument("--tag", default=None)
    s.set_defaults(fn=cmd_logs)

    return p


# subcommand handlers that never touch the device: main() does not check for
# a card before them, and nothing they run initializes CUDA
_HOST_ONLY_FNS = {"cmd_synth_data", "cmd_preprocess", "cmd_make_splits",
                  "cmd_split_arrays", "cmd_analyze_midi", "cmd_quality_gate",
                  "cmd_clean", "cmd_logs", "cmd_diagnose", "cmd_roll_to_midi",
                  "cmd_augment_corpus", "cmd_tsne", "cmd_import_checkpoint",
                  "cmd_export_checkpoint",
                  # doctor probes the card in a subprocess it can kill; it
                  # must never initialize CUDA itself
                  "cmd_doctor"}


# subcommand handlers that --dp N runs on N ranks, one process a device
_RANK_FNS = {"cmd_train_ae", "cmd_train_ed", "cmd_train_gan", "cmd_sweep", "cmd_pipeline"}


def _dp_batch_sizes(args):
    """The config batch sizes that ``--dp`` must divide, as the JAX CLI
    checks them: each trainer's own, the three of ``pipeline``, none for
    ``sweep`` (it shards members, not batches)."""
    from melogan_torch.config import AEConfig, EDConfig, GANConfig

    name = args.fn.__name__
    if name == "cmd_pipeline":
        pairs = [(AEConfig, args.ae_config), (EDConfig, args.ed_config), (GANConfig, args.gan_config)]
    else:
        pairs = {"cmd_train_ae": [(AEConfig, args.config)], "cmd_train_ed": [(EDConfig, args.config)],
                 "cmd_train_gan": [(GANConfig, args.config)]}.get(name, [])
    return [_load_cfg(cls, path, args.workdir).batch_size for cls, path in pairs]


def _needs_ranks(args) -> bool:
    """Whether ``main`` starts the ranks of a ``--dp`` run: a training
    subcommand outside a process group. Under ``torchrun`` this process
    first joins torchrun's group (``parallel.distributed.join_torchrun``)."""
    if not getattr(args, "dp", 0) or args.fn.__name__ not in _RANK_FNS:
        return False
    from melogan_torch.parallel.distributed import join_torchrun

    return not join_torchrun(args.device)


def _check_dp(args):
    """Before any work: the batch sizes and the device count of a ``--dp``
    run that starts its ranks."""
    from melogan_torch.parallel.mesh import make_mesh

    for batch_size in _dp_batch_sizes(args):
        _check_dp_batch(args.dp, batch_size)
    try:
        make_mesh(n_devices=args.dp, device=args.device)
    except ValueError as e:
        raise SystemExit(f"--dp {args.dp}: {e}")


def _run_ranks(args, argv):
    """``--dp N``: run this command line on N ranks (``parallel/launch.py``),
    each of which joins the group and trains its shard; a rank that fails
    ends them all and exits non-zero with its traceback."""
    from melogan_torch.parallel import launch

    try:
        launch.spawn(launch.cli_rank, args.dp, args=(argv,), device=args.device)
    except Exception as e:  # noqa: BLE001 — a rank's failure, reported with its traceback
        raise SystemExit(f"--dp {args.dp}: a rank failed:\n{e}")


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    args = build_parser().parse_args(argv)
    spawn_ranks = _needs_ranks(args)
    if spawn_ranks:
        _check_dp(args)
    if args.fn.__name__ not in _HOST_ONLY_FNS:
        from melogan_torch.device import resolve_device

        try:
            device = resolve_device(args.device)
        except RuntimeError as e:
            raise SystemExit(f"--device {args.device}: {e}")
        if device.type == "cuda":
            _build_kernels()
    if spawn_ranks:
        _run_ranks(args, argv)
        return
    args.fn(args)


def _build_kernels():
    """Build every stale kernel library before the work, one nvcc each, all
    at once: a stage would otherwise build each kernel at its first launch,
    one after another, inside its own timing."""
    import time

    from melogan_torch.ops import _build

    stale = [n for n in _build.kernel_names() if _build.is_stale(n)]
    if stale:
        t0 = time.perf_counter()
        _build.build_all(stale)
        print(f"[INFO] built the {', '.join(stale)} kernels with nvcc in "
              f"{time.perf_counter() - t0:.1f}s")


if __name__ == "__main__":
    main()
