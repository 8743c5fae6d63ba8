"""The WGAN-GP epoch loop on the port.

Port of ``melogan_tpu/train/gan_loop.py`` in the JAX loop's order: the
λ_fm targets and the per-emotion ``emotion_features`` centroids from the
corpus; then per epoch a numpy ``default_rng(cfg.seed)`` permutation cut by
``epoch_group_indices`` into group steps (``critic_iters`` critic updates +
one G update each) and a critic-only tail for the remainder; the same
per-epoch scalar tags, written with ``utils.metrics.MetricsWriter`` to
``<workdir>/<cfg.log_dir>``; every ``cfg.save_freq`` epochs a
``gan_epochNNNN.ckpt`` in the JAX payload layout (Adam and the EMA stream
included, plus the port's ``torch.Generator`` state), from which
``resume=True`` continues step for step; with ``track_best`` a quality gate
at each of those epochs that keeps the best weights as ``gan_best.ckpt``;
at the end ``gan_final.pth`` (reference layout) and ``gan_final.ckpt`` (JAX
layout) with ``emotion_features`` and, when EMA is on, ``G_ema``.
``load_gan_final`` / ``load_gan_final_full`` read either file for sampling.

bf16 training (``precision``) and the data-parallel mesh are not ported yet.
"""
from __future__ import annotations

import os
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from melogan_torch.config import EDConfig, GANConfig
from melogan_torch.data.datasets import SplitData, epoch_group_indices
from melogan_torch.device import resolve_device
from melogan_torch.train import gan_step
from melogan_torch.train.sweep import gate_member
from melogan_torch.utils import weights
from melogan_torch.utils.checkpoint import latest_checkpoint, load_checkpoint, save_checkpoint
from melogan_torch.utils.metrics import MetricsWriter
from melogan_torch.utils.weights import load_gan_final, load_gan_final_full  # noqa: F401  (the JAX module's names)


def emotion_centroids(numeric: np.ndarray, emotion_idx: np.ndarray) -> np.ndarray:
    """(4, 6) per-emotion mean of the standardized numeric features; the
    corpus mean for an emotion with no rows. Sampling conditions the feature
    encoder on these, as it was trained."""
    return np.stack([
        numeric[emotion_idx == e].mean(axis=0) if (emotion_idx == e).any() else numeric.mean(axis=0)
        for e in range(4)
    ]).astype(np.float32)


def _epoch_scalars(m: Dict[str, float], n_groups: int, n_steps: int) -> Dict[str, float]:
    scalars = {
        "Loss/Critic": m["loss_d_sum"] / n_steps,
        "Loss/Generator_Adv": m["loss_g_adv"] / n_groups if n_groups else 0.0,
        "Loss/Generator_Emo": m["loss_g_emo"] / n_groups if n_groups else 0.0,
        "Critic/Wasserstein": (m["d_real_sum"] - m["d_fake_sum"]) / n_steps,
        "Critic/d_real": m["d_real_sum"] / n_steps,
        "Critic/d_fake": m["d_fake_sum"] / n_steps,
        "Critic/gp": m["gp_mean"],
    }
    if "loss_g_fm" in m:
        scalars["Loss/Generator_FM"] = m["loss_g_fm"] / n_groups
    return scalars


def save_gan_final(path: str, state: gan_step.GANTrainState, cfg: GANConfig,
                   emotion_features: np.ndarray) -> str:
    """Write ``gan_final`` atomically, in the reference ``.pth`` layout or
    the JAX ``.ckpt`` layout by ``path``'s suffix: ``G`` and ``E_num``,
    ``emotion_features`` and, with EMA on, ``G_ema`` (the debiased EMA
    parameters beside the live BatchNorm statistics)."""
    def cpu(sd):
        return {k: v.detach().cpu().clone() for k, v in sd.items()}

    final = {
        "G": cpu(state.generator.state_dict()),
        "E_num": cpu(state.feature_encoder.state_dict()),
        "emotion_features": emotion_features,
    }
    ema = gan_step.ema_weights(state, cfg.ema_decay)
    if ema is not None:
        final["G_ema"] = {**final["G"], **cpu(ema)}
    return weights.write_gan_final(path, final)


def _best_payload(state, cfg, epoch, gate, emotion_features):
    """``gan_best.ckpt``: the JAX layout of ``gan_loop.py:372-386``."""
    full = weights.export_train_payload(state, epoch, emotion_features,
                                        g_ema=gan_step.ema_weights(state, cfg.ema_decay))
    best = {k: full[k] for k in ("epoch", "G", "E_num", "emotion_features")}
    best["gate"] = gate
    if "G_ema" in full:
        best["G_ema"] = full["G_ema"]
    return best


def train(
    cfg: GANConfig,
    ed_cfg: EDConfig,
    train_data: SplitData,
    latents: Optional[np.ndarray] = None,
    ed_variables: Optional[Dict] = None,
    workdir: Optional[str] = None,
    epochs: Optional[int] = None,
    verbose: bool = True,
    resume: bool = False,
    mesh=None,
    precision=None,
    track_best: bool = False,
    gate_samples_per_emotion: int = 2,
    device="cuda",
) -> Tuple[gan_step.GANTrainState, Dict[str, float]]:
    """Train the GAN on ``train_data``; returns (state, the last epoch's
    history). ``ed_variables`` is the pre-trained frozen ED as a
    reference-layout state dict; without it the ED is random (the reference
    warns and proceeds) and the ED feature-matching targets are off, as in
    the JAX loop. Checkpoints go to ``<workdir>/<cfg.checkpoint_dir>``
    (``cfg.checkpoint_dir`` without a workdir), metrics to
    ``<workdir>/<cfg.log_dir>``.

    ``resume=True`` restarts from the newest ``gan_epochNNNN.ckpt`` there:
    weights, BatchNorm statistics, both Adams, the step count and the EMA
    stream, and from a file of the port also its random stream, so that a
    run split at a checkpoint equals the run done in one go. A file of the
    JAX package restores the same, but its random stream cannot drive the
    port's, which goes on from its seed. ``track_best``: at every checkpoint
    epoch (and the last), generate ``gate_samples_per_emotion`` pieces per
    emotion from the deployable weights (EMA when on), score them against
    the golden quality bands, and keep the best as ``gan_best.ckpt``.
    ``mesh`` and ``precision`` are not ported yet and raise unless None."""
    if mesh is not None:
        raise NotImplementedError("data-parallel training over a mesh is not ported yet")
    if precision is not None:
        raise NotImplementedError("reduced-precision training is not ported yet")
    dev = resolve_device(device)
    models = gan_step.build_models(cfg, ed_cfg)
    state = gan_step.init_state(cfg, models, seed=cfg.seed, ed_variables=ed_variables, device=dev)
    notes = train_data.notes_gan()
    emotion_idx = train_data.emotion_idx.astype(np.int64)
    numeric = train_data.numeric.astype(np.float32)
    fm_target = fm_ed_target = None
    if cfg.lambda_fm:
        fm_target = gan_step.fm_targets_from_data(notes, emotion_idx)
        if ed_variables is not None:
            fm_ed_target = gan_step.fm_ed_targets_from_data(state.ed, notes, emotion_idx)
    steps = gan_step.make_train_steps(cfg, fm_target=fm_target, fm_ed_target=fm_ed_target)
    emotion_features = emotion_centroids(numeric, emotion_idx)

    ckpt_dir = os.path.join(workdir, cfg.checkpoint_dir) if workdir else cfg.checkpoint_dir
    log_dir = os.path.join(workdir, cfg.log_dir) if workdir else cfg.log_dir
    start_epoch = 1
    if resume:
        latest = latest_checkpoint(ckpt_dir, "gan_epoch")
        if latest:
            epoch, note = weights.load_train_payload(state, load_checkpoint(latest), cfg.ema_decay)
            start_epoch = epoch + 1
            if verbose:
                print(f"[INFO] resumed from {latest} at epoch {start_epoch}")
                if note:
                    print(f"[INFO] {note}")

    if latents is None or latents.shape[0] != notes.shape[0]:
        if latents is not None and verbose:
            print("[WARN] latent feats length mismatch; using zero latents")
        latents = np.zeros((notes.shape[0], cfg.latent_dim), np.float32)
    if cfg.integration_mode == "conditioning" and latents.shape[1] != cfg.latent_dim:
        raise ValueError(
            f"conditioning mode: encoder latents are {latents.shape[1]}-d but "
            f"the GAN config's LATENT_DIM is {cfg.latent_dim}. Set LATENT_DIM "
            f"to the AE latent size, or re-export the latents."
        )
    # the corpus lives on the device; each step gathers its batches there
    data = tuple(torch.as_tensor(np.ascontiguousarray(a), device=dev)
                 for a in (notes, emotion_idx, latents.astype(np.float32), numeric))

    def gather(idx: np.ndarray):
        i = torch.as_tensor(idx, device=dev)
        return tuple(a[i] for a in data)

    gate_sampler = None
    best_gate = None  # (passed, -violations) of gan_best.ckpt
    if track_best and resume:
        # a resumed run overwrites gan_best only when it beats it
        best_path = os.path.join(ckpt_dir, "gan_best.ckpt")
        if os.path.exists(best_path):
            prev = load_checkpoint(best_path)
            if "gate" in prev:
                best_gate = (int(prev["gate"]["passed"]), -int(prev["gate"]["violations"]))

    rng = np.random.default_rng(cfg.seed)
    n_epochs = epochs or cfg.epochs
    note = gan_step.ema_horizon_note(cfg, n_epochs, notes.shape[0])
    if note and verbose:
        print(note)
    # replay the data order: one permutation per epoch already trained
    for _ in range(start_epoch - 1):
        epoch_group_indices(notes.shape[0], cfg.batch_size, cfg.critic_iters, rng)
    writer = MetricsWriter(log_dir)
    history: Dict[str, float] = {}
    for ep in range(start_epoch, n_epochs + 1):
        t0 = time.perf_counter()
        gi, ti = epoch_group_indices(notes.shape[0], cfg.batch_size, cfg.critic_iters, rng)
        if gi is None and ti is None:
            scalars = {k: 0.0 for k in ("Loss/Critic", "Loss/Generator_Adv", "Loss/Generator_Emo",
                                        "Critic/Wasserstein", "Critic/d_real", "Critic/d_fake",
                                        "Critic/gp")}
        else:
            sums: Dict[str, torch.Tensor] = {}
            gps = []
            for g in (gi if gi is not None else []):
                state, m = steps.group(state, gather(g))
                gps.append(m.pop("gp_mean"))
                for k, v in m.items():
                    sums[k] = sums[k] + v if k in sums else v
            n_group = 0 if gi is None else gi.shape[0] * gi.shape[1]
            gp = torch.stack(gps).mean() if gps else None
            if ti is not None:
                state, tm = steps.tail(state, gather(ti))
                for k in ("loss_d_sum", "d_real_sum", "d_fake_sum"):
                    sums[k] = sums[k] + tm[k] if k in sums else tm[k]
                # fold the tail's gp into the mean by critic-update counts
                n_tail = ti.shape[0]
                gp = tm["gp_mean"] if gp is None else (gp * n_group + tm["gp_mean"] * n_tail) / float(
                    n_group + n_tail)
            sums["gp_mean"] = gp
            m = {k: float(v) for k, v in sums.items()}  # one host sync per epoch
            n_groups = 0 if gi is None else gi.shape[0]
            n_steps = n_group + (0 if ti is None else ti.shape[0])
            scalars = _epoch_scalars(m, n_groups, n_steps)
        dt = time.perf_counter() - t0
        scalars = dict(scalars, epoch_seconds=dt)
        writer.add_scalars(scalars, ep)
        if verbose:
            print(
                f"[GAN epoch {ep}/{n_epochs}] D {scalars['Loss/Critic']:.4f} | "
                f"G_adv {scalars['Loss/Generator_Adv']:.4f} | "
                f"G_emo {scalars['Loss/Generator_Emo']:.4f} | {dt:.2f}s"
            )
        history = dict(scalars, epoch=ep)

        if ep % cfg.save_freq == 0:
            save_checkpoint(os.path.join(ckpt_dir, f"gan_epoch{ep:04d}.ckpt"),
                            weights.export_train_payload(
                                state, ep, emotion_features,
                                g_ema=gan_step.ema_weights(state, cfg.ema_decay)))
        if track_best and (ep % cfg.save_freq == 0 or ep == n_epochs):
            gate_dir = os.path.join(workdir or ".", cfg.sample_dir, f"gate_epoch{ep:04d}")
            passed, total, violations, _, _, gate_sampler = gate_member(
                cfg, state, cfg.seed + ep, gate_dir, gate_samples_per_emotion, gate_sampler,
                emotion_features=emotion_features)
            writer.add_scalars({"Gate/passed": passed, "Gate/violations": violations}, ep)
            score = (passed, -violations)
            if best_gate is None or score > best_gate:
                best_gate = score
                gate = {"passed": passed, "total": total, "violations": violations}
                save_checkpoint(os.path.join(ckpt_dir, "gan_best.ckpt"),
                                _best_payload(state, cfg, ep, gate, emotion_features))
                if verbose:
                    print(f"[GAN] new best at epoch {ep}: gate {passed}/{total} ({violations} violations)")

    for name in ("gan_final.pth", "gan_final.ckpt"):
        save_gan_final(os.path.join(ckpt_dir, name), state, cfg, emotion_features)
    writer.close()
    return state, history
