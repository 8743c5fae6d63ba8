"""Conv1D VAE over (B, max_notes, 4) note tensors: the port of
``melogan_tpu/models/vae.py`` (reference src/ae/model.py).

A 3-layer strided conv encoder (4→32→64→128, k5 s2 p2, BN+ReLU), a linear
head to a ``hidden_dim`` state, ``fc_mu`` / ``fc_log_var`` to the latent,
and a mirrored decoder: a linear pre-net to (B, max_notes/8, 128), three
k5 s2 p2 op1 transposed convs (128→64→32→4, BN+ReLU between) and a final
tanh, trimmed or padded to ``max_notes``. The modules carry the reference
torch names, so a reference-layout state dict (or ``utils.weights.
export_vae`` of JAX variables) loads with ``strict=True``:

- ``encoder.conv.{0,3,6}`` convs, ``encoder.conv.{1,4,7}`` BatchNorms,
  ``encoder._linear.1`` the head;
- ``fc_mu``, ``fc_log_var``;
- ``decoder.pre.{0,2}``, ``decoder.deconv.{0,3,6}`` transposed convs,
  ``decoder.deconv.{1,4}`` BatchNorms.

Activations are channels last, (B, L, C), as in the JAX package; the
encoder flattens in torch (B, C, L) order and the decoder reshapes its
pre-net output to (B, 128, L/8) before turning it channels last, so the
Linear weights line up with the reference's. The convs run through
``ops/conv.py``: the hand-written kernels on the card, forward and backward.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from melogan_torch.config import AEConfig
from melogan_torch.models.layers import Conv1d, ConvTranspose1d, batch_norm_lc, trim_or_pad_length

_CONV = dict(kernel_size=5, stride=2, padding=2)


def encoded_len(max_notes: int, layers: int = 3) -> int:
    """Length after the encoder's stride-2 k5 p2 convs: ceil(L/2) per layer."""
    length = max_notes
    for _ in range(layers):
        length = (length - 1) // 2 + 1
    return length


class ConvEncoder(nn.Module):
    """(B, L, 4) → (B, hidden_dim) hidden state."""

    def __init__(self, max_notes: int = 512, hidden_dim: int = 512,
                 channels: Tuple[int, ...] = (32, 64, 128), in_channels: int = 4):
        super().__init__()
        layers = []
        cin = in_channels
        for ch in channels:
            layers += [Conv1d(cin, ch, **_CONV), nn.BatchNorm1d(ch), nn.ReLU()]
            cin = ch
        self.conv = nn.Sequential(*layers)
        self._linear = nn.Sequential(
            nn.Flatten(), nn.Linear(cin * encoded_len(max_notes, len(channels)), hidden_dim), nn.ReLU())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(0, len(self.conv), 3):
            x = torch.relu(batch_norm_lc(self.conv[i + 1], self.conv[i](x)))
        # flatten in torch (B, C, L) order so reference checkpoints line up
        return self._linear(x.transpose(1, 2))


class ConvDecoder(nn.Module):
    """(B, latent) → (B, max_notes, 4) reconstruction in [−1, 1]."""

    def __init__(self, max_notes: int = 512, latent_dim: int = 8, hidden_dim: int = 512,
                 out_channels: int = 4):
        super().__init__()
        self.max_notes = max_notes
        self.reduced_len = max(1, max_notes // 8)
        self.pre = nn.Sequential(nn.Linear(latent_dim, hidden_dim), nn.ReLU(),
                                 nn.Linear(hidden_dim, 128 * self.reduced_len), nn.ReLU())
        convt = dict(_CONV, output_padding=1)
        self.deconv = nn.Sequential(
            ConvTranspose1d(128, 64, **convt), nn.BatchNorm1d(64), nn.ReLU(),
            ConvTranspose1d(64, 32, **convt), nn.BatchNorm1d(32), nn.ReLU(),
            ConvTranspose1d(32, out_channels, **convt),
        )

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        y = self.pre(z)
        # the reference reshapes to (B, 128, reduced_len); our layout is (B, L, C)
        y = y.reshape(y.shape[0], 128, self.reduced_len).transpose(1, 2)
        for conv_i, bn_i in ((0, 1), (3, 4)):
            y = torch.relu(batch_norm_lc(self.deconv[bn_i], self.deconv[conv_i](y)))
        return trim_or_pad_length(torch.tanh(self.deconv[6](y)), self.max_notes)


class VAE(nn.Module):
    """Variational autoencoder; ``forward`` returns (recon, z, mu, log_var).

    In train mode the reparameterisation noise ``eps`` ~ N(0, 1) of shape
    (B, latent_dim) is given by the caller or drawn from ``generator`` (it
    raises with neither: the port never touches the global RNG); in eval
    mode eps is 0, so z = mu."""

    def __init__(self, max_notes: int = 512, latent_dim: int = 8, hidden_dim: int = 512):
        super().__init__()
        self.latent_dim = latent_dim
        self.encoder = ConvEncoder(max_notes, hidden_dim)
        self.fc_mu = nn.Linear(hidden_dim, latent_dim)
        self.fc_log_var = nn.Linear(hidden_dim, latent_dim)
        self.decoder = ConvDecoder(max_notes, latent_dim, hidden_dim)

    def forward(self, x: torch.Tensor, eps: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        h = self.encoder(x)
        mu, log_var = self.fc_mu(h), self.fc_log_var(h)
        if not self.training:
            eps = torch.zeros_like(mu)
        elif eps is None:
            if generator is None:
                raise ValueError("VAE in train mode needs eps or a torch.Generator")
            eps = torch.randn(mu.shape, generator=generator, device=mu.device)
        z = mu + eps * torch.exp(0.5 * log_var)
        return self.decoder(z), z, mu, log_var

    def encode_mu(self, x: torch.Tensor) -> torch.Tensor:
        """Deterministic µ embedding; call in eval mode (the latent-export
        path, reference src/ae/encode.py:125-134 exports mu, not z)."""
        return self.fc_mu(self.encoder(x))

    @classmethod
    def from_config(cls, cfg: AEConfig) -> "VAE":
        return cls(max_notes=cfg.max_notes, latent_dim=cfg.latent_dim, hidden_dim=cfg.hidden_dim)


def vae_loss(recon, x, mu, log_var, beta: float, free_bits: float = 0.0,
             capacity: Optional[float] = None):
    """(total, mse, kld): MSE + β·KLD, both means over all elements
    (reference src/ae/train_ae.py:35-51), with the JAX package's two
    anti-collapse knobs, which default to the exact reference loss.

    - ``free_bits`` (nats per latent dim): the KL *penalty* is
      ``mean_d(max(KL_d, free_bits))`` over the per-dim batch-mean KL.
    - ``capacity`` C: the penalty becomes ``β·|KL_pen − C|``; None keeps
      ``β·KL_pen``.

    ``kld`` is always the true reference KLD, for logging and selection."""
    mse = torch.mean(torch.square(recon - x))
    kl_terms = 1 + log_var - torch.square(mu) - torch.exp(log_var)
    kld = -0.5 * torch.mean(kl_terms)
    if free_bits and free_bits > 0.0:
        kl_pen = torch.mean(torch.clamp(-0.5 * torch.mean(kl_terms, dim=0), min=free_bits))
    else:
        kl_pen = kld
    if capacity is None:
        total = mse + beta * kl_pen
    else:
        total = mse + beta * torch.abs(kl_pen - capacity)
    return total, mse, kld
