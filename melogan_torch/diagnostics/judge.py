"""Independent emotion accuracy of generated music: the port of
``melogan_tpu/diagnostics/judge.py``.

The GAN's training loss contains a frozen ED trained on the TRAIN split
(reference src/gan/train_gan.py:121-133), so scoring generations with that
model measures the objective G optimized, not generalization. The judge is
a second EmotionDiscriminator trained on the held-out VALIDATION split with
a different seed, never inside G's loss. Its per-emotion accuracy over
fresh samples says whether generated music carries its target emotion.

The judge trains through ``train.ed_loop.train`` and scores in one
eval-mode pass on its state's device: the card by default (the ED's convs
on the port's ``conv1d`` kernel), the CPU with ``device="cpu"``.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional, Tuple

import numpy as np

from melogan_torch import EMOTIONS
from melogan_torch.config import EDConfig
from melogan_torch.data.datasets import SplitData

JUDGE_SEED_OFFSET = 1000  # decorrelate judge init/data-order from the in-loss ED


def judge_config(ed_cfg: EDConfig, epochs: Optional[int] = None) -> EDConfig:
    """Clone the ED config for the judge: different seed, own checkpoint/log
    dirs, notes mode (raw generations are scored; latent mode would need the
    VAE in the loop)."""
    return dataclasses.replace(
        ed_cfg,
        input_mode="notes",
        seed=ed_cfg.seed + JUDGE_SEED_OFFSET,
        num_epochs=epochs or ed_cfg.num_epochs,
        checkpoint_dir=os.path.join(os.path.dirname(ed_cfg.checkpoint_dir.rstrip("/")) or "data/models", "judge"),
        log_dir=os.path.join(os.path.dirname(ed_cfg.log_dir.rstrip("/")) or "experiments", "judge"),
        save_name="judge_best.pth",
    )


def train_judge(
    ed_cfg: EDConfig,
    judge_train: SplitData,
    judge_val: SplitData,
    workdir: Optional[str] = None,
    epochs: Optional[int] = None,
    verbose: bool = False,
    device="cuda",
) -> Tuple[EDConfig, "object"]:
    """Train the judge on held-out data (callers pass the val split as
    judge-train and the test split as judge-val, so that no GAN-train row is
    ever seen). Returns (judge_cfg, best_state)."""
    from melogan_torch.train import ed_loop

    cfg = judge_config(ed_cfg, epochs)
    state, _ = ed_loop.train(cfg, judge_train, judge_val, workdir=workdir, verbose=verbose,
                             device=device)
    return cfg, state


def judge_notes(cfg: EDConfig, state, notes: np.ndarray, labels: np.ndarray) -> Dict:
    """Classify (B, L, 4) note arrays with the judge ``state`` (an
    ``ed_loop.EDTrainState``) in one eval-mode pass; the per-emotion
    accuracy report. ``labels``: the target emotion indices."""
    from melogan_torch.train.ed_loop import confusion_matrix, logits_of

    pred = logits_of(state, notes).argmax(-1)
    labels = np.asarray(labels)
    per_emotion: Dict[str, Dict] = {}
    for i, emotion in enumerate(EMOTIONS):
        mask = labels == i
        per_emotion[emotion] = {
            "n": int(mask.sum()),
            "accuracy": float((pred[mask] == i).mean()) if mask.any() else None,
        }
    return {
        "n": int(len(labels)),
        "accuracy": float((pred == labels).mean()),
        "chance": 1.0 / len(EMOTIONS),
        "per_emotion": per_emotion,
        "confusion": confusion_matrix(labels, pred, len(EMOTIONS)).tolist(),
    }


def judge_generated(cfg: EDConfig, state, sampler, n_per_emotion: int = 8, seed: int = 1234) -> Dict:
    """Generate ``n_per_emotion`` fresh samples per emotion with ``sampler``
    (the port's ``Sampler``) and judge them. Deterministic given the
    sampler's weights and device and ``seed``."""
    prompts = [e for e in EMOTIONS for _ in range(n_per_emotion)]
    notes = sampler.sample_notes(prompts, seed=seed)
    labels = np.asarray([EMOTIONS.index(e) for e in prompts])
    report = judge_notes(cfg, state, notes, labels)
    report["n_per_emotion"] = n_per_emotion
    report["seed"] = seed
    return report
