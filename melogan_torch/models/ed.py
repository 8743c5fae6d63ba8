"""Emotion discriminator: a 4-class classifier over notes or latents.

Port of ``melogan_tpu/models/ed.py`` (reference
src/emotion_discriminator/ed_model.py), with the reference module names, so
that a reference ``ed_best.pth`` or ``utils.weights.export_ed`` of JAX
variables loads with ``load_state_dict(strict=True)``:

- ``input_mode='latent'``: the MLP classifier over encoder latents
- ``input_mode='notes'``: ``encoder.conv.{i}.net.{0,1}`` = Conv1d (k5 p2
  first, then k3 p1, stride 1), BatchNorm, GELU; channels 4→64→128→256→256
  capped at ``notes_hidden``; mean-pool; ``encoder.project`` linear; then
  the classifier ``classifier.net.{0,3,...}`` (Linear, GELU, Dropout) and
  ``classifier.head``

Notes are (B, T, note_dim), channels last. The convs run through
``ops.conv.conv1d``: the hand-written ``conv1d`` kernel on the card. During
GAN training the ED runs frozen in eval mode inside the generator loss, and
only its input gradient flows back (the ``convt1d`` kernel on the card).
Train-mode dropout takes an explicit ``torch.Generator``.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from melogan_torch.models.layers import Conv1d, Dropout, adaptive_avg_pool_1, batch_norm_lc


class ConvBlock1D(nn.Module):
    """Conv1d → BatchNorm → exact GELU over (B, L, C)."""

    def __init__(self, in_channels: int, features: int, kernel_size: int = 3,
                 stride: int = 1, padding: int = 1):
        super().__init__()
        self.net = nn.Sequential(
            Conv1d(in_channels, features, kernel_size, stride=stride, padding=padding),
            nn.BatchNorm1d(features),
            nn.GELU(),
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        conv, bn, act = self.net
        return act(batch_norm_lc(bn, conv(x)))


class NotesEncoder(nn.Module):
    """(B, T, note_dim) → (B, hidden_dim) pooled embedding."""

    def __init__(self, note_dim: int = 4, hidden_dim: int = 256, num_blocks: int = 4):
        super().__init__()
        blocks = []
        cin, ch = note_dim, 64
        for i in range(num_blocks):
            blocks.append(ConvBlock1D(cin, ch, kernel_size=5 if i == 0 else 3,
                                      padding=2 if i == 0 else 1))
            cin, ch = ch, min(ch * 2, hidden_dim)
        self.conv = nn.ModuleList(blocks)
        self.project = nn.Linear(cin, hidden_dim)

    def forward(self, notes: torch.Tensor, return_taps: bool = False):
        """``return_taps``: also the mean-pooled activation of every block and
        the projection, concatenated (the multi-scale features the GAN's
        feature-matching loss reads)."""
        x = notes
        taps = []
        for block in self.conv:
            x = block(x)
            if return_taps:
                taps.append(x.mean(dim=1))
        out = self.project(adaptive_avg_pool_1(x))
        if return_taps:
            return out, torch.cat(taps + [out], dim=-1)
        return out


class MLPClassifier(nn.Module):
    """(Linear, GELU, Dropout) per hidden width, then the ``head``."""

    def __init__(self, in_dim: int, hidden_dims: Sequence[int] = (256, 128), n_classes: int = 4,
                 dropout: float = 0.2, use_sn: bool = False):
        super().__init__()
        if use_sn:
            raise NotImplementedError(
                "SpectralNormLinear is not ported yet (the shipped EDConfig has use_spectral_norm=False)")
        layers = []
        prev = in_dim
        for h in hidden_dims:
            layers += [nn.Linear(prev, h), nn.GELU(), Dropout(dropout)]
            prev = h
        self.net = nn.Sequential(*layers)
        self.head = nn.Linear(prev, n_classes)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        for m in self.net:
            x = m(x, generator=generator) if isinstance(m, Dropout) else m(x)
        return self.head(x)


class EmotionDiscriminator(nn.Module):
    """4-class emotion classifier; returns raw logits (B, n_classes).

    Train or eval mode is the module's own (``.train()`` / ``.eval()``);
    ``generator`` feeds the classifier's dropout in train mode."""

    def __init__(
        self,
        input_mode: str = "notes",
        latent_dim: int = 64,
        note_dim: int = 4,
        notes_hidden: int = 256,
        notes_blocks: int = 4,
        mlp_hidden: Sequence[int] = (256, 128),
        n_classes: int = 4,
        dropout: float = 0.2,
        use_spectral_norm: bool = False,
    ):
        super().__init__()
        if input_mode == "notes":
            self.encoder = NotesEncoder(note_dim, notes_hidden, notes_blocks)
            in_dim = notes_hidden
        elif input_mode == "latent":
            self.encoder = None
            in_dim = latent_dim
        else:
            raise ValueError("input_mode must be 'latent' or 'notes'")
        self.input_mode = input_mode
        self.classifier = MLPClassifier(in_dim, tuple(mlp_hidden), n_classes, dropout,
                                        use_spectral_norm)

    def _check(self, x: torch.Tensor) -> None:
        want = 2 if self.input_mode == "latent" else 3
        if x.dim() != want:
            shape = "(B, latent_dim)" if want == 2 else "(B, T, note_dim)"
            raise ValueError(f"expected {shape}, got {tuple(x.shape)}")

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        self._check(x)
        feats = x if self.input_mode == "latent" else self.encoder(x)
        return self.classifier(feats, generator)

    def features(self, x: torch.Tensor, multi: bool = False) -> torch.Tensor:
        """The penultimate (B, notes_hidden) embedding; with ``multi`` also
        the mean-pooled activations of every conv block before it,
        (B, 64+128+256+256+256) at the shipped width. The input itself in
        latent mode."""
        if self.input_mode == "latent":
            return x
        if multi:
            return self.encoder(x, return_taps=True)[1]
        return self.encoder(x)

    def features_and_logits(self, x: torch.Tensor, multi: bool = False,
                            generator: Optional[torch.Generator] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(features, logits) from one encoder pass (the G loss needs both)."""
        if self.input_mode == "latent":
            return x, self.classifier(x, generator)
        if multi:
            pen, taps = self.encoder(x, return_taps=True)
            return taps, self.classifier(pen, generator)
        feats = self.encoder(x)
        return feats, self.classifier(feats, generator)

    def predict_proba(self, x: torch.Tensor) -> torch.Tensor:
        """Class probabilities in eval mode (the module's mode is restored)."""
        was = self.training
        self.eval()
        try:
            with torch.no_grad():
                return torch.softmax(self(x), dim=-1)
        finally:
            self.train(was)

    def predict(self, x: torch.Tensor) -> torch.Tensor:
        return self.predict_proba(x).argmax(dim=-1)

    @classmethod
    def from_config(cls, cfg) -> "EmotionDiscriminator":
        """Build from an EDConfig or a reference-style cfg dict."""
        get = cfg.get if isinstance(cfg, dict) else lambda k, d=None: getattr(cfg, k, d)
        return cls(
            input_mode=get("input_mode", "latent"),
            latent_dim=int(get("latent_dim", 128)),
            note_dim=int(get("note_dim", 4)),
            notes_hidden=int(get("notes_hidden", 256)),
            notes_blocks=int(get("notes_blocks", 4)),
            mlp_hidden=tuple(get("mlp_hidden", (256, 128))),
            n_classes=int(get("n_classes", 4)),
            dropout=float(get("dropout", 0.2)),
            use_spectral_norm=bool(get("use_spectral_norm", False)),
        )
