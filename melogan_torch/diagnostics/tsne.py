"""Latent-space t-SNE visualization (reference tsne.py capability): embeds the
per-split encoder latents in 2-D colored by emotion; saves
``{split}_latent_tsne_visualization.png``. The port's copy of
``melogan_tpu/diagnostics/tsne.py``; matplotlib and scikit-learn are imported
when it runs, so the package imports without them."""
from __future__ import annotations

import os
from typing import Optional

import numpy as np

from melogan_torch import EMOTIONS
from melogan_torch.data.datasets import load_split


def visualize_latents(
    splits_dir: str,
    split: str,
    processed_dir: str,
    out_dir: str = "experiments",
    perplexity: Optional[float] = None,
) -> str:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from sklearn.manifold import TSNE

    feats_path = os.path.join(splits_dir, split, "encoder_feats.npy")
    latents = np.load(feats_path, allow_pickle=True)
    data = load_split(
        os.path.join(splits_dir, f"{split}_split.csv"), processed_dir, verbose=False
    )
    labels = data.emotion_idx[: latents.shape[0]]

    n = latents.shape[0]
    perplexity = perplexity or max(2.0, min(30.0, (n - 1) / 3))
    emb = TSNE(
        n_components=2, perplexity=perplexity, init="pca", random_state=42
    ).fit_transform(np.asarray(latents, np.float64))

    colors = {0: "#e6b422", 1: "#4169e1", 2: "#dc143c", 3: "#3cb371"}
    fig, ax = plt.subplots(figsize=(8, 7))
    for i, emotion in enumerate(EMOTIONS):
        mask = labels == i
        if mask.any():
            ax.scatter(emb[mask, 0], emb[mask, 1], s=18, c=colors[i], label=emotion, alpha=0.75)
    ax.set_title(f"VAE latent space (t-SNE) — {split}")
    ax.legend()
    os.makedirs(out_dir, exist_ok=True)
    out = os.path.join(out_dir, f"{split}_latent_tsne_visualization.png")
    fig.tight_layout()
    fig.savefig(out, dpi=120)
    plt.close(fig)
    return out
