"""The quality gate that scores a training state, for ``train(track_best=True)``.

Port of ``melogan_tpu/train/sweep.py::_gate_member``. The population sweep
itself is not ported yet.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np

from melogan_torch import EMOTIONS
from melogan_torch.config import GANConfig
from melogan_torch.constants import BPM_JITTER, EMOTION_BPM
from melogan_torch.diagnostics import quality
from melogan_torch.sampling import Sampler
from melogan_torch.train import gan_step


def gate_member(
    cfg: GANConfig,
    state: gan_step.GANTrainState,
    seed: int,
    out_dir: str,
    samples_per_emotion: int,
    sampler: Optional[Sampler],
    emotion_features=None,
):
    """Generate ``samples_per_emotion`` fresh .mid per emotion from the
    state's deployable weights (the debiased EMA generator when the run
    keeps one, else the live generator) and score them against the golden
    bands (``diagnostics.quality.gate_directory``). Tempos are jittered by
    ``BPM_JITTER`` from a numpy stream seeded with ``seed``.

    Returns ``(passed, total, violations, gen_sd, fe_sd, sampler)``: the
    sampler runs on the state's device, is built on first use and has its
    weights swapped after that."""
    gen_sd = {k: v.detach() for k, v in state.generator.state_dict().items()}
    ema = gan_step.ema_weights(state, cfg.ema_decay)
    if ema is not None:
        gen_sd.update(ema)
    fe_sd = {k: v.detach() for k, v in state.feature_encoder.state_dict().items()}
    os.makedirs(out_dir, exist_ok=True)
    if sampler is None:
        sampler = Sampler(cfg, gen_variables=gen_sd, fe_variables=fe_sd,
                          emotion_features=emotion_features, device=state.device)
    else:
        sampler.swap_variables(gen_sd, fe_sd, emotion_features=emotion_features)
    rng = np.random.default_rng(seed)
    prompts, paths, bpms = [], [], []
    for emotion in EMOTIONS:
        for i in range(1, samples_per_emotion + 1):
            prompts.append(emotion)
            paths.append(os.path.join(out_dir, f"gate_{emotion}_{i}.mid"))
            bpms.append(float(EMOTION_BPM[emotion] * (1.0 + rng.uniform(-BPM_JITTER, BPM_JITTER))))
    sampler.generate_many(prompts, paths, seed=int(rng.integers(0, 2**31)), bpms=bpms)
    gate = quality.gate_directory(out_dir)
    passed = sum(1 for f in gate["files"].values() if not f["violations"])
    violations = sum(len(f["violations"]) for f in gate["files"].values())
    return passed, len(gate["files"]), violations, gen_sd, fe_sd, sampler
