"""The WGAN-GP epoch loop on the port.

Port of ``melogan_tpu/train/gan_loop.py::train`` in the JAX loop's order:
the λ_fm targets and the per-emotion ``emotion_features`` centroids from the
corpus; then per epoch a numpy ``default_rng(cfg.seed)`` permutation cut by
``epoch_group_indices`` into group steps (``critic_iters`` critic updates +
one G update each) and a critic-only tail for the remainder; the same
per-epoch history keys; at the end ``gan_final.pth`` in the reference
layout ``{'G', 'E_num'}`` plus ``emotion_features`` (and ``G_ema`` when EMA
is on), which ``utils.weights.load_gan_final_pth`` and ``Sampler`` read.

Periodic checkpoints, resume, gate-based best tracking, the metrics writer,
bf16 and the mesh are not ported yet.
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
                   emotion_features: np.ndarray) -> None:
    """Write the reference ``gan_final.pth`` layout (CPU tensors only), plus
    ``emotion_features`` and, with EMA on, ``G_ema``: the debiased EMA
    parameters beside the live BatchNorm statistics."""
    def cpu(sd):
        return {k: v.detach().cpu().clone() for k, v in sd.items()}

    final = {
        "G": cpu(state.generator.state_dict()),
        "E_num": cpu(state.feature_encoder.state_dict()),
        "emotion_features": torch.from_numpy(emotion_features),
    }
    ema = gan_step.ema_weights(state, cfg.ema_decay)
    if ema is not None:
        final["G_ema"] = {**final["G"], **cpu(ema)}
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.save(final, path)


def train(
    cfg: GANConfig,
    ed_cfg: EDConfig,
    train_data: SplitData,
    latents: Optional[np.ndarray] = None,
    ed_variables: Optional[Dict] = None,
    workdir: Optional[str] = None,
    epochs: Optional[int] = None,
    verbose: bool = True,
    device="cuda",
) -> Tuple[gan_step.GANTrainState, Dict[str, float]]:
    """Train the GAN on ``train_data``; returns (state, the last epoch's
    history). ``ed_variables`` is the pre-trained frozen ED as a
    reference-layout state dict; without it the ED is random (the reference
    warns and proceeds) and the ED feature-matching targets are off, as in
    the JAX loop. ``gan_final.pth`` goes to ``<workdir>/<cfg.checkpoint_dir>``
    (``cfg.checkpoint_dir`` without a workdir)."""
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

    rng = np.random.default_rng(cfg.seed)
    n_epochs = epochs or cfg.epochs
    note = gan_step.ema_horizon_note(cfg, n_epochs, notes.shape[0])
    if note and verbose:
        print(note)
    history: Dict[str, float] = {}
    for ep in range(1, n_epochs + 1):
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
        if verbose:
            print(
                f"[GAN epoch {ep}/{n_epochs}] D {scalars['Loss/Critic']:.4f} | "
                f"G_adv {scalars['Loss/Generator_Adv']:.4f} | "
                f"G_emo {scalars['Loss/Generator_Emo']:.4f} | {dt:.2f}s"
            )
        history = dict(scalars, epoch_seconds=dt, epoch=ep)

    ckpt_dir = os.path.join(workdir, cfg.checkpoint_dir) if workdir else cfg.checkpoint_dir
    save_gan_final(os.path.join(ckpt_dir, "gan_final.pth"), state, cfg, emotion_features)
    return state, history
