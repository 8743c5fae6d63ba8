"""Analytic FLOP counts of the models, of one WGAN-GP group step and of one
VAE training step.

The port's own copy of ``melogan_tpu/utils/flops.py`` (matmul and conv
FLOPs only, 1 MAC = 2 FLOPs), with one change: the frozen emotion
discriminator counts forward plus input gradient (2× its forward) inside
the generator update, since its weights take no gradient; the JAX count
takes it at 3×. The counts give the group step's bound on the card:
operations over the f32 peak. ``vae_flops`` and ``vae_step_flops`` have no
JAX counterpart.
"""
from __future__ import annotations

from melogan_torch.config import AEConfig, GANConfig


def _linear(d_in: int, d_out: int) -> int:
    return 2 * d_in * d_out


def _conv1d(l_out: int, c_in: int, c_out: int, k: int) -> int:
    return 2 * l_out * c_in * c_out * k


def _convt1d(l_in: int, c_in: int, c_out: int, k: int) -> int:
    return 2 * l_in * c_in * c_out * k


def feature_encoder_flops(cfg: GANConfig) -> int:
    total, d = 0, cfg.numeric_input_dim
    for h in cfg.encoder_hidden:
        total += _linear(d, h)
        d = h
    return total + _linear(d, cfg.encoder_out_dim)


def generator_flops(cfg: GANConfig) -> int:
    in_dim = cfg.noise_dim + (cfg.encoder_out_dim if cfg.use_numeric_encoder else 0)
    if cfg.integration_mode == "conditioning":
        in_dim += cfg.latent_dim
    total = _linear(in_dim, cfg.gen_hidden) + _linear(cfg.gen_hidden, cfg.latent_dim)
    reduced = max(1, cfg.max_notes // 8)
    total += _linear(cfg.latent_dim, 512) + _linear(512, 256 * reduced)
    total += _convt1d(reduced, 256, 128, 5)
    total += _convt1d(2 * reduced, 128, 64, 5)
    total += _convt1d(4 * reduced, 64, cfg.note_dim, 5)
    return total


def critic_flops(cfg: GANConfig) -> int:
    l, total, c_in = cfg.max_notes, 0, cfg.note_dim
    for c_out in (64, 128, 256):
        l = (l + 1) // 2
        total += _conv1d(l, c_in, c_out, 5)
        c_in = c_out
    total += _linear(256, 256)
    cond = cfg.encoder_out_dim if cfg.use_numeric_encoder else 0
    return total + _linear(256 + cond, 1)


def ed_flops(ed_cfg) -> int:
    """ED forward, notes mode: the conv blocks, the projection, the MLP."""
    l, total = ed_cfg.max_notes, 0
    c_in, ch = ed_cfg.note_dim, 64
    for i in range(ed_cfg.notes_blocks):
        total += _conv1d(l, c_in, ch, 5 if i == 0 else 3)
        c_in, ch = ch, min(ch * 2, ed_cfg.notes_hidden)
    total += _linear(c_in, ed_cfg.notes_hidden)
    d = ed_cfg.notes_hidden
    for h in ed_cfg.mlp_hidden:
        total += _linear(d, h)
        d = h
    return total + _linear(d, ed_cfg.n_classes)


def train_flops_per_step(cfg: GANConfig, ed_cfg) -> int:
    """FLOPs per batch-step (one critic update, plus 1/critic_iters of a
    generator update). A critic update: G and FE forward without grad, the
    critic on real and fake (3× forward each, forward and both gradients)
    and the gradient penalty (≈6× forward). A generator update: 3× the
    forward of FE, G and the critic, and 2× the frozen ED's."""
    return int(group_step_flops(cfg, ed_cfg) / max(1, cfg.critic_iters))


def group_step_flops(cfg: GANConfig, ed_cfg) -> int:
    """FLOPs of one group step: ``critic_iters`` critic updates and one
    generator update."""
    b = cfg.batch_size
    f_c, f_g, f_f, f_e = critic_flops(cfg), generator_flops(cfg), feature_encoder_flops(cfg), ed_flops(ed_cfg)
    critic_step = b * (f_g + f_f + 12 * f_c)
    gen_step = b * (3 * (f_g + f_f + f_c) + 2 * f_e)
    return max(1, cfg.critic_iters) * critic_step + gen_step


def vae_flops(cfg: AEConfig) -> int:
    """Forward FLOPs of one sample through the VAE: three k5 s2 convs, the
    Linear head, fc_mu and fc_log_var, the decoder's pre-net and three k5
    transposed convs."""
    total, length, c = 0, cfg.max_notes, 4
    for ch in (32, 64, 128):
        length = (length - 1) // 2 + 1
        total += _conv1d(length, c, ch, 5)
        c = ch
    total += _linear(c * length, cfg.hidden_dim) + 2 * _linear(cfg.hidden_dim, cfg.latent_dim)
    reduced = max(1, cfg.max_notes // 8)
    total += _linear(cfg.latent_dim, cfg.hidden_dim) + _linear(cfg.hidden_dim, 128 * reduced)
    length, c = reduced, 128
    for ch in (64, 32, 4):
        total += _convt1d(length, c, ch, 5)
        length, c = 2 * length, ch
    return total


def vae_step_flops(cfg: AEConfig) -> int:
    """One VAE training step over a batch of ``cfg.batch_size``: the
    forward, every weight gradient and every input gradient but the first
    conv's (its input is data), each as many FLOPs as its forward."""
    first = _conv1d((cfg.max_notes - 1) // 2 + 1, 4, 32, 5)
    return cfg.batch_size * (3 * vae_flops(cfg) - first)
