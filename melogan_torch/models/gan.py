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
- ``Critic``: ``conv.{0,2,4}`` = three k5 s2 p2 convs 4→64→128→256, each
  followed by LeakyReLU(0.2) (no batch-norm: WGAN-GP), mean-pool,
  ``fc.1`` linear to 256 + LeakyReLU, concat the numeric embedding,
  ``real_fake`` scalar score head
- ``FeatureEncoder``: ``net.0..7`` = LayerNorm(6) → (Linear, GELU, Dropout)×2
  → Linear, a 128-d embedding; its dropout masks are injected or drawn from
  a ``torch.Generator``

Notes are (B, max_notes, note_dim), channels last as in the JAX package. The
generator's convolutions run through ``ops`` in that layout, differentiable
on both devices; the critic's are pinned to ``F.conv1d`` (see ``Critic``).
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import torch
from torch import nn

from melogan_torch.config import GANConfig
from melogan_torch.models.layers import (
    Conv1d,
    ConvTranspose1d,
    Dropout,
    Linear,
    SpectralNormLinear,
    adaptive_avg_pool_1,
    batch_norm_lc,
    default_precision,
    trim_or_pad_length,
)
from melogan_torch.ops.decoder import TailStages, fold_bn_affine, fused_decoder_tail
from melogan_torch.utils.profiling import span

_CONVT = dict(kernel_size=5, stride=2, padding=2, output_padding=1)


def _hio(conv: nn.ConvTranspose1d) -> torch.Tensor:
    """torch ConvTranspose1d weight (Cin, Cout, K) → HIO (K, Cin, Cout)."""
    return conv.weight.permute(2, 0, 1).contiguous()


class NoiseToLatent(nn.Module):
    """MLP expanding the combined conditioning vector to the decoder latent."""

    def __init__(self, in_dim: int, out_dim: int, hidden: int = 512):
        super().__init__()
        self.net = nn.Sequential(Linear(in_dim, hidden), nn.ReLU(), Linear(hidden, out_dim))

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        with span("gan.noise_to_latent"):
            return self.net(z)


class GeneratorDecoder(nn.Module):
    """(B, latent_dim) → (B, max_notes, out_channels), raw values.

    In eval mode at f32 precision, the three transposed convs with their
    BatchNorm affines folded in run as one kernel call
    (``ops/decoder.py``: three launches of the f32 conv core, the bias and
    ReLU in its store, on W' planes held with the folded stages).
    Otherwise — training, which must update the BN statistics per stage, or
    a lower-precision request — the layered path runs each conv through
    ``ops/conv.py``.
    """

    def __init__(self, latent_dim: int = 128, max_notes: int = 512, out_channels: int = 4):
        super().__init__()
        self.max_notes = max_notes
        self.reduced_len = max(1, max_notes // 8)
        self.pre = nn.Sequential(
            Linear(latent_dim, 512), nn.ReLU(), Linear(512, 256 * self.reduced_len), nn.ReLU()
        )
        self.deconv = nn.Sequential(
            ConvTranspose1d(256, 128, **_CONVT),
            nn.BatchNorm1d(128),
            nn.ReLU(),
            ConvTranspose1d(128, 64, **_CONVT),
            nn.BatchNorm1d(64),
            nn.ReLU(),
            ConvTranspose1d(64, out_channels, **_CONVT),
        )
        self._folded = None  # (key, source tensors, stages) of folded_stages

    def fuses(self) -> bool:
        """The fuse gate of ``melogan_tpu/models/gan.py:94-103``: eval mode,
        f32 precision, and a max_notes the three ×2 stages reach exactly. The
        JAX gate's batch cap (≤ 32768) was the TPU compiler's envelope and is
        dropped: each stage's launch spreads its tiles over every SM at any
        batch, and the core takes any channel count and length. A decoder
        split over a model axis (``parallel/tensor.py``) stays layered."""
        return (
            not self.training
            and default_precision() == "f32"
            and self.max_notes == 8 * self.reduced_len
            and all(self.deconv[i].tp is None for i in (0, 3, 6))
        )

    def _fold_sources(self) -> List[torch.Tensor]:
        """Every tensor the folded stages are computed from."""
        out = []
        for i in (0, 3, 6):
            out += [self.deconv[i].weight, self.deconv[i].bias]
        for i in (1, 4):
            bn = self.deconv[i]
            out += [bn.weight, bn.bias, bn.running_mean, bn.running_var, bn.num_batches_tracked]
        return out

    def folded_stages(self) -> TailStages:
        """The three (HIO weight, bias) pairs with eval BN folded into the
        first two, as the fused kernel takes them: a ``TailStages``, which
        also holds the W' planes the kernel makes from them on the card, one
        set per W' layout (batch 1 and batch 4096 take two), so a warm call
        launches no prologue.

        Without grad mode they are cached, keyed on the version counter and
        data pointer of every source tensor: ``load_state_dict``, in-place
        optimiser steps and moves to another device all change a key. A
        train-mode BatchNorm updates its running statistics without bumping
        their version counters, but it bumps ``num_batches_tracked``'s. The
        entry holds the source tensors, so a parameter replaced by a new
        one cannot pass its address on while the entry lives. A new key
        makes a new ``TailStages``, and with it new W': W' is tied to the
        entry, never to the folded tensors' version counters (under
        ``torch.inference_mode``, as ``Sampler`` folds them, they have none).
        With grad mode on they are folded afresh, so that gradients flow to
        the parameters; each such fold is a new ``TailStages`` whose W' is
        made afresh (on the card the kernel refuses weights that require
        grad, so only grad-free weights get that far)."""
        if torch.is_grad_enabled():
            return self._fold()
        sources = self._fold_sources()
        key = tuple((t._version, t.data_ptr()) for t in sources)
        cached = self._folded
        if cached is None or cached[0] != key:
            cached = (key, sources, self._fold())
            self._folded = cached
        return cached[2]

    def _fold(self) -> TailStages:
        convs = [self.deconv[0], self.deconv[3], self.deconv[6]]
        bns = [self.deconv[1], self.deconv[4]]
        stages = []
        for i, conv in enumerate(convs):
            w, b = _hio(conv), conv.bias
            if i < 2:
                bn = bns[i]
                w, b = fold_bn_affine(w, b, bn.running_mean, bn.running_var, bn.weight, bn.bias, bn.eps)
            stages.append((w.contiguous(), b.contiguous()))
        return TailStages(stages)

    def forward(self, latent: torch.Tensor) -> torch.Tensor:
        with span("gan.decoder.pre"):
            y = self.pre(latent)
            # the reference reshapes to (B, 256, reduced_len); our layout is (B, L, C)
            y = y.reshape(y.shape[0], 256, self.reduced_len).transpose(1, 2).contiguous()
        return self.tail(y)

    def tail(self, y: torch.Tensor) -> torch.Tensor:
        """The three transposed convs from the pre-net's (B, max_notes/8,
        256) output: fused or layered, as ``fuses`` says."""
        with span("gan.decoder.tail"):
            if self.fuses():
                return trim_or_pad_length(fused_decoder_tail(y, self.folded_stages()), self.max_notes)
            for conv_i, bn_i in ((0, 1), (3, 4)):
                y = torch.relu(batch_norm_lc(self.deconv[bn_i], self.deconv[conv_i](y)))
            # no final activation: raw note values
            return trim_or_pad_length(self.deconv[6](y), self.max_notes)


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


class Critic(nn.Module):
    """WGAN-GP critic: raw realness score per sample (B,).

    Batch-norm-free, conditioned on the numeric embedding by concatenation
    before the score head. Its convolutions are pinned to ``F.conv1d``
    (``Conv1d(native=True)``), as the JAX critic pins its own to XLA's conv
    (``pallas=False``): the gradient penalty differentiates the critic's
    input gradient again w.r.t. its parameters, and the port's conv
    Functions are first-order only.
    """

    def __init__(self, note_dim: int = 4, emb_dim: int = 256, numeric_embed_dim: int = 128):
        super().__init__()
        self.numeric_embed_dim = numeric_embed_dim
        layers = []
        cin = note_dim
        for ch in (64, 128, 256):
            layers += [Conv1d(cin, ch, 5, stride=2, padding=2, native=True), nn.LeakyReLU(0.2)]
            cin = ch
        self.conv = nn.Sequential(*layers)
        self.fc = nn.Sequential(nn.Flatten(), Linear(cin, emb_dim), nn.LeakyReLU(0.2))
        self.real_fake = Linear(emb_dim + numeric_embed_dim, 1)

    def forward(self, notes: torch.Tensor,
                numeric_embedding: Optional[torch.Tensor] = None) -> torch.Tensor:
        if self.numeric_embed_dim > 0:
            if numeric_embedding is None or numeric_embedding.shape[-1] != self.numeric_embed_dim:
                raise ValueError(
                    f"critic needs a numeric embedding of dim {self.numeric_embed_dim}, got "
                    f"{None if numeric_embedding is None else tuple(numeric_embedding.shape)}")
        x = self.fc(adaptive_avg_pool_1(self.conv(notes)))
        if self.numeric_embed_dim > 0:
            x = torch.cat([x, numeric_embedding], dim=1)
        return self.real_fake(x).squeeze(1)

    @classmethod
    def from_config(cls, cfg: GANConfig) -> "Critic":
        return cls(note_dim=cfg.note_dim,
                   numeric_embed_dim=cfg.encoder_out_dim if cfg.use_numeric_encoder else 0)


class FeatureEncoder(nn.Module):
    """Numeric feature (6,) → conditioning embedding (out_dim,).

    In train mode each Dropout takes its keep mask from ``masks`` (one per
    hidden layer, of shape (B, hidden)) or draws it from ``generator``.
    ``use_sn``: the hidden layers are ``SpectralNormLinear`` (the output
    layer stays a plain ``Linear``), as in the JAX encoder; their ``u``
    advances in train mode only."""

    def __init__(
        self,
        in_dim: int = 6,
        hidden_dims: Sequence[int] = (256, 128),
        out_dim: int = 128,
        dropout: float = 0.2,
        use_sn: bool = False,
    ):
        super().__init__()
        layers = [nn.LayerNorm(in_dim)]
        prev = in_dim
        for h in hidden_dims:
            hidden = SpectralNormLinear(prev, h) if use_sn else Linear(prev, h)
            layers += [hidden, nn.GELU(), Dropout(dropout)]
            prev = h
        layers.append(Linear(prev, out_dim))
        self.net = nn.Sequential(*layers)

    @property
    def dropouts(self) -> Sequence[Dropout]:
        return [m for m in self.net if isinstance(m, Dropout)]

    def draw_masks(self, batch: int, generator: torch.Generator) -> Sequence[torch.Tensor]:
        """Keep masks for one train-mode forward over ``batch`` rows, drawn
        from ``generator`` on its device."""
        widths = [m.out_features for m in self.net if isinstance(m, nn.Linear)][:-1]
        return [d.draw_mask((batch, w), generator, generator.device)
                for d, w in zip(self.dropouts, widths)]

    def forward(self, x: torch.Tensor, masks: Optional[Sequence[torch.Tensor]] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if masks is not None and len(masks) != len(self.dropouts):
            raise ValueError(f"expected {len(self.dropouts)} dropout masks, got {len(masks)}")
        with span("gan.feature_encoder"):
            i = 0
            for m in self.net:
                if isinstance(m, Dropout):
                    x = m(x, None if masks is None else masks[i], generator)
                    i += 1
                else:
                    x = m(x)
            return x

    @classmethod
    def from_config(cls, cfg: GANConfig, dropout: Optional[float] = None) -> "FeatureEncoder":
        return cls(
            in_dim=cfg.numeric_input_dim,
            hidden_dims=tuple(cfg.encoder_hidden),
            out_dim=cfg.encoder_out_dim,
            dropout=cfg.encoder_dropout if dropout is None else dropout,
            use_sn=cfg.encoder_use_sn,
        )
