"""Generator and numeric feature encoder of the generation slice.

Ports of ``melogan_tpu/models/gan.py`` (reference src/gan/models.py and
src/gan/feature_encoder.py), with the reference torch module names so that a
reference state dict, or one exported from JAX variables by
``utils/weights.py``, loads with ``load_state_dict(strict=True)``:

- ``NoiseToLatent``: ``net.{0,2}``, MLP input → hidden → latent with ReLU
- ``GeneratorDecoder``: ``pre.{0,2}`` linear pre-net to (B, max_notes/8, 256),
  then ``deconv.{0,1,3,4,6}`` = ConvT, BN, ReLU, ConvT, BN, ReLU, ConvT
  (256→128→64→note_dim, k5/s2/p2/op1), trimmed or padded to ``max_notes``
- ``Generator``: concat [noise, numeric_emb (+ AE latent in 'conditioning'
  mode)] → NoiseToLatent → decoder; returns (notes, latent)
- ``FeatureEncoder``: ``net.0..7`` = LayerNorm(6) → (Linear, GELU, Dropout)×2
  → Linear, a 128-d embedding

Notes are (B, max_notes, note_dim), channels last as in the JAX package. The
convolutions run through ``ops`` in that layout; the Critic comes with the
training slice.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from melogan_torch.config import GANConfig
from melogan_torch.models.layers import batch_norm_lc, default_precision, trim_or_pad_length
from melogan_torch.ops.conv import conv_transpose1d
from melogan_torch.ops.decoder import fold_bn_affine, fused_decoder_tail

_CONVT = dict(kernel_size=5, stride=2, padding=2, output_padding=1)


def _hio(conv: nn.ConvTranspose1d) -> torch.Tensor:
    """torch ConvTranspose1d weight (Cin, Cout, K) → HIO (K, Cin, Cout)."""
    return conv.weight.permute(2, 0, 1).contiguous()


class NoiseToLatent(nn.Module):
    """MLP expanding the combined conditioning vector to the decoder latent."""

    def __init__(self, in_dim: int, out_dim: int, hidden: int = 512):
        super().__init__()
        self.net = nn.Sequential(nn.Linear(in_dim, hidden), nn.ReLU(), nn.Linear(hidden, out_dim))

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        return self.net(z)


class GeneratorDecoder(nn.Module):
    """(B, latent_dim) → (B, max_notes, out_channels), raw values.

    In eval mode at f32 precision, the three transposed convs with their
    BatchNorm affines folded in run as ONE fused kernel
    (``ops/decoder.py``), which keeps the activations on chip. Otherwise —
    training, which must update the BN statistics per stage, or a
    lower-precision request — the layered path runs each conv through
    ``ops/conv.py``.
    """

    def __init__(self, latent_dim: int = 128, max_notes: int = 512, out_channels: int = 4):
        super().__init__()
        self.max_notes = max_notes
        self.reduced_len = max(1, max_notes // 8)
        self.pre = nn.Sequential(
            nn.Linear(latent_dim, 512), nn.ReLU(), nn.Linear(512, 256 * self.reduced_len), nn.ReLU()
        )
        self.deconv = nn.Sequential(
            nn.ConvTranspose1d(256, 128, **_CONVT),
            nn.BatchNorm1d(128),
            nn.ReLU(),
            nn.ConvTranspose1d(128, 64, **_CONVT),
            nn.BatchNorm1d(64),
            nn.ReLU(),
            nn.ConvTranspose1d(64, out_channels, **_CONVT),
        )

    def fuses(self) -> bool:
        """The fuse gate of ``melogan_tpu/models/gan.py:94-103``: eval mode,
        f32 precision, and a max_notes the three ×2 stages reach exactly. The
        JAX gate's batch cap (≤ 32768) was the TPU compiler's envelope and is
        dropped: the CUDA kernel runs one CTA per sample at any batch."""
        return (
            not self.training
            and default_precision() == "f32"
            and self.max_notes == 8 * self.reduced_len
        )

    def folded_stages(self) -> Sequence[tuple]:
        """The three (HIO weight, bias) pairs with eval BN folded into the
        first two, as the fused kernel takes them."""
        convs = [self.deconv[0], self.deconv[3], self.deconv[6]]
        bns = [self.deconv[1], self.deconv[4]]
        stages = []
        for i, conv in enumerate(convs):
            w, b = _hio(conv), conv.bias
            if i < 2:
                bn = bns[i]
                w, b = fold_bn_affine(w, b, bn.running_mean, bn.running_var, bn.weight, bn.bias, bn.eps)
            stages.append((w.contiguous(), b.contiguous()))
        return stages

    def forward(self, latent: torch.Tensor) -> torch.Tensor:
        y = self.pre(latent)
        # the reference reshapes to (B, 256, reduced_len); our layout is (B, L, C)
        y = y.reshape(y.shape[0], 256, self.reduced_len).transpose(1, 2).contiguous()
        if self.fuses():
            return trim_or_pad_length(fused_decoder_tail(y, self.folded_stages()), self.max_notes)
        for conv_i, bn_i in ((0, 1), (3, 4)):
            conv = self.deconv[conv_i]
            y = conv_transpose1d(y, _hio(conv), 2, 2, 1, bias=conv.bias)
            y = torch.relu(batch_norm_lc(self.deconv[bn_i], y))
        conv = self.deconv[6]
        y = conv_transpose1d(y, _hio(conv), 2, 2, 1, bias=conv.bias)
        # no final activation: raw note values
        return trim_or_pad_length(y, self.max_notes)


class Generator(nn.Module):
    """Emotion-conditioned note generator; returns (notes, internal_latent).

    ``mode='warm_start'``: input = [noise, numeric_emb] (the shipped config).
    ``mode='conditioning'``: input additionally concatenates the AE latent.
    """

    def __init__(
        self,
        noise_dim: int = 128,
        latent_dim: int = 128,
        mode: str = "warm_start",
        hidden: int = 512,
        max_notes: int = 512,
        note_dim: int = 4,
        numeric_embed_dim: int = 128,
    ):
        super().__init__()
        if mode not in ("conditioning", "warm_start"):
            raise ValueError(f"mode must be 'conditioning' or 'warm_start', got {mode!r}")
        self.mode = mode
        self.numeric_embed_dim = numeric_embed_dim
        in_dim = noise_dim + numeric_embed_dim + (latent_dim if mode == "conditioning" else 0)
        self.noise_to_latent = NoiseToLatent(in_dim, latent_dim, hidden)
        self.decoder = GeneratorDecoder(latent_dim, max_notes, note_dim)

    def forward(
        self,
        noise: torch.Tensor,
        encoder_latent: Optional[torch.Tensor] = None,
        numeric_embedding: Optional[torch.Tensor] = None,
    ):
        inputs = [noise]
        if self.numeric_embed_dim > 0:
            if numeric_embedding is None:
                raise ValueError("numeric_embedding is required")
            inputs.append(numeric_embedding)
        if self.mode == "conditioning":
            if encoder_latent is None:
                raise ValueError("conditioning mode requires the AE latent")
            inputs.append(encoder_latent)
        latent = self.noise_to_latent(torch.cat(inputs, dim=1))
        return self.decoder(latent), latent

    @classmethod
    def from_config(cls, cfg: GANConfig) -> "Generator":
        return cls(
            noise_dim=cfg.noise_dim,
            latent_dim=cfg.latent_dim,
            mode=cfg.integration_mode,
            hidden=cfg.gen_hidden,
            max_notes=cfg.max_notes,
            note_dim=cfg.note_dim,
            numeric_embed_dim=cfg.encoder_out_dim if cfg.use_numeric_encoder else 0,
        )


class FeatureEncoder(nn.Module):
    """Numeric feature (6,) → conditioning embedding (out_dim,)."""

    def __init__(
        self,
        in_dim: int = 6,
        hidden_dims: Sequence[int] = (256, 128),
        out_dim: int = 128,
        dropout: float = 0.2,
        use_sn: bool = False,
    ):
        super().__init__()
        if use_sn:
            raise NotImplementedError(
                "SpectralNormLinear is not ported yet (the shipped config has encoder_use_sn=False)")
        layers = [nn.LayerNorm(in_dim)]
        prev = in_dim
        for h in hidden_dims:
            layers += [nn.Linear(prev, h), nn.GELU(), nn.Dropout(dropout)]
            prev = h
        layers.append(nn.Linear(prev, out_dim))
        self.net = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.net(x)

    @classmethod
    def from_config(cls, cfg: GANConfig, dropout: Optional[float] = None) -> "FeatureEncoder":
        return cls(
            in_dim=cfg.numeric_input_dim,
            hidden_dims=tuple(cfg.encoder_hidden),
            out_dim=cfg.encoder_out_dim,
            dropout=cfg.encoder_dropout if dropout is None else dropout,
            use_sn=cfg.encoder_use_sn,
        )
