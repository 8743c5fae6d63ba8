"""The plain reference of one bulk sampling call: emotion rows and a seed in,
notes out.

The jitter and the noise are worked out again from the call's seed as the
upstream sampler defines them: a generator on the device seeded with the
call's seed draws N(0, 1) jitter for the (B, 6) features, scaled by 0.15,
then the (B, noise_dim) noise. The feature encoder runs in eval mode (no
dropout), the generator in eval mode (BatchNorm on its running statistics,
unfolded). Computed in float64, in blocks of rows.
"""
from __future__ import annotations

import torch

from benchmark.reference import model


def draws(gan, idx: torch.Tensor, seed: int):
    """(features (B, 6), noise (B, noise_dim)) in float32 on ``idx``'s device."""
    dev = idx.device
    rng = torch.Generator(device=dev).manual_seed(int(seed))
    base = torch.tensor(model.EMOTION_FEATURES, dtype=torch.float32, device=dev)[idx]
    features = base + model.FEATURE_JITTER_STD * torch.randn(base.shape, generator=rng, device=dev)
    noise = torch.randn((idx.shape[0], gan["NOISE_DIM"]), generator=rng, device=dev)
    return features, noise


@torch.no_grad()
def sample_notes(params, gan, idx: torch.Tensor, seed: int, mode: str = "none",
                 block: int = 1024, dtype=torch.float64) -> torch.Tensor:
    """(B, max_notes, note_dim) notes in ``dtype`` for emotion indices
    ``idx`` (a device tensor) and the call's ``seed``. ``params``: the
    ``gen`` and ``fe`` dicts, already in ``dtype`` on the device."""
    features, noise = draws(gan, idx, seed)
    out = []
    for i in range(0, idx.shape[0], block):
        f = features[i:i + block].to(dtype)
        z = noise[i:i + block].to(dtype)
        emb = model.feature_encoder(params["fe"], gan, f, mode)
        out.append(model.generator(params["gen"], gan, z, emb, mode, train=False))
    return torch.cat(out)
