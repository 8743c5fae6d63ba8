"""GAN and emotion-discriminator configurations: the same fields and defaults
as ``melogan_tpu.config.GANConfig`` and the model fields of its ``EDConfig``.

Loading from YAML comes with a later slice; the shipped configurations are the
default-constructed ``GANConfig()`` and ``EDConfig()``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Tuple


def validate_ema_decay(d) -> float:
    """Reject a generator-EMA decay outside [0, 1)."""
    d = float(d)
    if not (0.0 <= d < 1.0):
        raise ValueError(
            f"ema_decay must be in [0, 1) (0 disables EMA); got {d!r}. A "
            f"decay of 1.0 would average over an infinite window and never "
            f"leave its zero seed."
        )
    return d


@dataclass
class GANConfig:
    """GAN workload config (reference config/gan_config.yaml)."""

    epochs: int = 50
    batch_size: int = 32
    seed: int = 42
    save_freq: int = 5
    # model
    integration_mode: str = "warm_start"  # warm_start | conditioning
    noise_dim: int = 128
    latent_dim: int = 64  # the AE latent dim as conditioning input
    max_notes: int = 512
    note_dim: int = 4
    gen_hidden: int = 512
    # optimizers
    lr_g: float = 2e-4
    lr_d: float = 1e-4
    lr_e: float = 1e-4
    weight_decay: float = 0.0
    beta1: float = 0.5
    beta2: float = 0.9
    # WGAN-GP
    use_wgangp: bool = True
    lambda_gp: float = 10.0
    critic_iters: int = 5
    lambda_emotion: float = 5.0
    lambda_fm: float = 0.0
    fused_critic_batch: bool = False
    # generator weight EMA (0.0 = off)
    ema_decay: float = 0.0
    # numeric feature encoder
    use_numeric_encoder: bool = True
    numeric_input_dim: int = 6
    encoder_hidden: Tuple[int, ...] = (256, 128)
    encoder_out_dim: int = 128
    encoder_dropout: float = 0.2
    encoder_use_sn: bool = False
    # sampling
    n_samples_per_emotion: int = 2
    # paths
    checkpoint_dir: str = "experiments/gan/checkpoints"
    log_dir: str = "experiments/gan/logs"
    sample_dir: str = "experiments/gan/samples"
    train_split: str = "data/splits/train_split.csv"
    val_split: str = "data/splits/val_split.csv"
    splits_dir: str = "data/splits"
    processed_dir: str = "data/processed"
    encoder_feats_train: str = "data/splits/train/encoder_feats.npy"
    encoder_feats_val: str = "data/splits/val/encoder_feats.npy"

    def __post_init__(self):
        validate_ema_decay(self.ema_decay)


@dataclass
class EDConfig:
    """Emotion-discriminator model config (reference config/ed_config.yaml).

    Only the model fields: the ED trainer (optimizer, scheduler, paths) comes
    with a later slice."""

    name: str = "emotion_discriminator_v1"
    input_mode: str = "notes"  # 'latent' | 'notes'
    # 'normalized': trained on the GAN-normalized note layout (in-domain for
    # the GAN's emotion loss); 'raw': the reference's raw .npz notes
    notes_domain: str = "normalized"
    n_classes: int = 4
    labels: Tuple[str, ...] = ("happy", "sad", "angry", "calm")
    latent_dim: int = 64  # unused in notes mode, kept for parity
    note_dim: int = 4
    max_notes: int = 512
    notes_hidden: int = 256
    notes_blocks: int = 4
    mlp_hidden: Tuple[int, ...] = (256, 128)
    dropout: float = 0.2
    use_spectral_norm: bool = False

    def model_cfg(self) -> Dict[str, Any]:
        """Dict view consumed by the EmotionDiscriminator constructor."""
        return {
            "input_mode": self.input_mode,
            "latent_dim": self.latent_dim,
            "note_dim": self.note_dim,
            "notes_hidden": self.notes_hidden,
            "notes_blocks": self.notes_blocks,
            "mlp_hidden": list(self.mlp_hidden),
            "n_classes": self.n_classes,
            "dropout": self.dropout,
            "use_spectral_norm": self.use_spectral_norm,
        }
