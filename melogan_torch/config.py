"""Typed configuration: the port's copy of ``melogan_tpu/config.py``.

The reference drives each pipeline stage with a flat YAML file; the AE and
GAN configs use UPPER_CASE keys and the ED config lower_case.
``load_config`` reads either style into a ``ConfigDict`` that answers both
spellings, and each dataclass's ``from_yaml`` reads the repo's
``configs/*.yaml`` with the JAX package's fallbacks, which are not always
the dataclass defaults (``GANConfig``: ``INTEGRATION_MODE`` → conditioning,
``LAMBDA_EMOTION`` → 1.0; ``EDConfig``: ``input_mode`` → latent,
``latent_dim`` → 128).

YAML is read by ``utils/yaml_subset.py``, the port's own reader of the
subset these files use, which types every value as ``yaml.safe_load`` does
(the GPU machine does not promise PyYAML).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, Tuple

from melogan_torch.utils.yaml_subset import safe_load


def load_yaml(path: str) -> Dict[str, Any]:
    """Load a flat YAML config file into a dict ({} for an empty file)."""
    with open(path) as f:
        data = safe_load(f.read())
    return data or {}


class ConfigDict(dict):
    """A dict that also answers a key's UPPER and lower case spellings (the
    reference mixes both styles)."""

    def get(self, key, default=None):  # type: ignore[override]
        for alt in (key, str(key).upper(), str(key).lower()):
            if dict.__contains__(self, alt):
                return dict.__getitem__(self, alt)
        return default

    def __getitem__(self, key):
        if dict.__contains__(self, key):
            return dict.__getitem__(self, key)
        for alt in (key.upper(), key.lower()):
            if dict.__contains__(self, alt):
                return dict.__getitem__(self, alt)
        raise KeyError(key)

    def __contains__(self, key):
        return (
            dict.__contains__(self, key)
            or dict.__contains__(self, str(key).upper())
            or dict.__contains__(self, str(key).lower())
        )


def load_config(path: str) -> ConfigDict:
    return ConfigDict(load_yaml(path))


@dataclass
class AugmentConfig:
    """AE data augmentation knobs (reference config/ae_config.yaml:13-18 — all off)."""

    tempo_jitter: float = 0.0
    pitch_shift: int = 0
    note_dropout: float = 0.0
    velocity_jitter: float = 0.0
    timing_jitter: float = 0.0


@dataclass
class AEConfig:
    """VAE workload config (reference config/ae_config.yaml)."""

    max_notes: int = 512
    latent_dim: int = 8
    batch_size: int = 32
    lr: float = 1e-4
    epochs: int = 100
    weight_decay: float = 1e-5
    kld_warmup_epochs: int = 1
    beta: float = 10.0
    # anti-collapse knobs (defaults = exact reference loss; see vae_loss):
    # free_bits — per-dim KL floor in nats; kl_capacity — Burgess-style
    # annealed KL target C (β·|KL−C|), ramped linearly over
    # kl_capacity_epochs (0 → ramp over the full run)
    free_bits: float = 0.0
    kl_capacity: float = 0.0
    kl_capacity_epochs: int = 0
    early_stop_patience: int = 15
    hidden_dim: int = 512  # reference hardcodes 512 (src/ae/model.py:104)
    augment: AugmentConfig = field(default_factory=AugmentConfig)
    # normalization caps (reference src/ae/dataset.py:86-88 cfg.get defaults)
    max_start_beat: float = 100.0
    max_duration_beat: float = 20.0
    # paths
    processed_dir: str = "data/processed"
    splits_dir: str = "data/splits"
    checkpoint_dir: str = "data/models/ae"
    log_dir: str = "experiments/ae"
    recon_dir: str = "experiments/ae/reconstructions"
    recon_freq: int = 1
    recon_save_count: int = 6
    seed: int = 42

    @classmethod
    def from_yaml(cls, path: str) -> "AEConfig":
        raw = load_config(path)
        aug = raw.get("AUGMENT", {}) or {}
        return cls(
            max_notes=int(raw.get("MAX_NOTES", 512)),
            latent_dim=int(raw.get("LATENT_DIM", 8)),
            batch_size=int(raw.get("BATCH_SIZE", 32)),
            lr=float(raw.get("LR", 1e-4)),
            epochs=int(raw.get("EPOCHS", 100)),
            weight_decay=float(raw.get("WEIGHT_DECAY", 1e-5)),
            kld_warmup_epochs=int(raw.get("KLD_WARMUP_EPOCHS", 1)),
            beta=float(raw.get("BETA", 10.0)),
            free_bits=float(raw.get("FREE_BITS", 0.0)),
            kl_capacity=float(raw.get("KL_CAPACITY", 0.0)),
            kl_capacity_epochs=int(raw.get("KL_CAPACITY_EPOCHS", 0)),
            early_stop_patience=int(raw.get("EARLY_STOP_PATIENCE", 15)),
            hidden_dim=int(raw.get("HIDDEN_DIM", 512)),
            augment=AugmentConfig(
                tempo_jitter=float(aug.get("tempo_jitter", 0.0)),
                pitch_shift=int(aug.get("pitch_shift", 0)),
                note_dropout=float(aug.get("note_dropout", 0.0)),
                velocity_jitter=float(aug.get("velocity_jitter", 0.0)),
                timing_jitter=float(aug.get("timing_jitter", 0.0)),
            ),
            max_start_beat=float(raw.get("MAX_START_BEAT", 100.0)),
            max_duration_beat=float(raw.get("MAX_DURATION_BEAT", 20.0)),
            processed_dir=str(raw.get("PROCESSED_DIR", "data/processed")),
            splits_dir=str(raw.get("SPLITS_DIR", "data/splits")),
            checkpoint_dir=str(raw.get("CHECKPOINT_DIR", "data/models/ae")),
            log_dir=str(raw.get("LOG_DIR", "experiments/ae")),
            recon_dir=str(raw.get("RECON_DIR", "experiments/ae/reconstructions")),
            recon_freq=int(raw.get("RECON_FREQ", 1)),
            recon_save_count=int(raw.get("RECON_SAVE_COUNT", 6)),
            seed=int(raw.get("SEED", 42)),
        )


@dataclass
class OptimizerConfig:
    name: str = "AdamW"
    lr: float = 2e-4
    betas: Tuple[float, float] = (0.5, 0.999)
    weight_decay: float = 0.0


@dataclass
class SchedulerConfig:
    name: str = "ReduceLROnPlateau"
    mode: str = "min"
    factor: float = 0.5
    patience: int = 5
    threshold: float = 1e-4


@dataclass
class EDConfig:
    """Emotion-discriminator workload config (reference config/ed_config.yaml)."""

    name: str = "emotion_discriminator_v1"
    input_mode: str = "notes"  # 'latent' | 'notes'
    # 'normalized': train on the GAN-normalized note layout (in-domain for the
    # GAN's emotion loss — the default); 'raw': reference behavior (trains on
    # raw .npz notes while the GAN applies the ED to normalized output)
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
    batch_size: int = 64
    num_epochs: int = 50
    optimizer: OptimizerConfig = field(default_factory=OptimizerConfig)
    scheduler: SchedulerConfig = field(default_factory=SchedulerConfig)
    early_stopping_patience: int = 10
    metric_for_best: str = "val_loss"
    save_freq: int = 5
    save_name: str = "ed_best.pth"
    use_weighted_sampler: bool = False
    seed: int = 42
    # paths
    processed_dir: str = "data/processed"
    manifest_csv: str = "data/docs/data_manifest.csv"
    checkpoint_dir: str = "data/models/ed"
    log_dir: str = "data/experiments/ed"
    train_split_csv: str = "data/splits/train_split.csv"
    val_split_csv: str = "data/splits/val_split.csv"
    test_split_csv: str = "data/splits/test_split.csv"
    train_encoder_feats_path: str = "data/splits/train/encoder_feats.npy"
    val_encoder_feats_path: str = "data/splits/val/encoder_feats.npy"
    test_encoder_feats_path: str = "data/splits/test/encoder_feats.npy"

    @classmethod
    def from_yaml(cls, path: str) -> "EDConfig":
        raw = load_config(path)
        opt = raw.get("optimizer", {}) or {}
        sched = raw.get("scheduler", {}) or {}
        betas = opt.get("betas", [0.5, 0.999])
        return cls(
            name=str(raw.get("name", "emotion_discriminator_v1")),
            input_mode=str(raw.get("input_mode", "latent")),
            notes_domain=str(raw.get("notes_domain", "normalized")),
            n_classes=int(raw.get("n_classes", 4)),
            labels=tuple(raw.get("labels", ["happy", "sad", "angry", "calm"])),
            latent_dim=int(raw.get("latent_dim", 128)),
            note_dim=int(raw.get("note_dim", 4)),
            max_notes=int(raw.get("max_notes", 512)),
            notes_hidden=int(raw.get("notes_hidden", 256)),
            notes_blocks=int(raw.get("notes_blocks", 4)),
            mlp_hidden=tuple(int(h) for h in raw.get("mlp_hidden", [256, 128])),
            dropout=float(raw.get("dropout", 0.2)),
            use_spectral_norm=bool(raw.get("use_spectral_norm", False)),
            batch_size=int(raw.get("batch_size", 64)),
            num_epochs=int(raw.get("num_epochs", 50)),
            optimizer=OptimizerConfig(
                name=str(opt.get("name", "AdamW")),
                lr=float(opt.get("lr", 2e-4)),
                betas=(float(betas[0]), float(betas[1])),
                weight_decay=float(opt.get("weight_decay", 0.0)),
            ),
            scheduler=SchedulerConfig(
                name=str(sched.get("name", "ReduceLROnPlateau")),
                mode=str(sched.get("mode", "min")),
                factor=float(sched.get("factor", 0.5)),
                patience=int(sched.get("patience", 5)),
                threshold=float(sched.get("threshold", 1e-4)),
            ),
            early_stopping_patience=int(raw.get("early_stopping_patience", 10)),
            metric_for_best=str(raw.get("metric_for_best", "val_loss")),
            save_freq=int(raw.get("save_freq", 5)),
            save_name=str(raw.get("save_name", "ed_best.pth")),
            use_weighted_sampler=bool(raw.get("use_weighted_sampler", False)),
            seed=int(raw.get("seed", 42)),
            processed_dir=str(raw.get("processed_dir", "data/processed")),
            manifest_csv=str(raw.get("manifest_csv", "data/docs/data_manifest.csv")),
            checkpoint_dir=str(raw.get("checkpoint_dir", "data/models/ed")),
            log_dir=str(raw.get("log_dir", "data/experiments/ed")),
            train_split_csv=str(raw.get("train_split_csv", "data/splits/train_split.csv")),
            val_split_csv=str(raw.get("val_split_csv", "data/splits/val_split.csv")),
            test_split_csv=str(raw.get("test_split_csv", "data/splits/test_split.csv")),
            train_encoder_feats_path=str(
                raw.get("train_encoder_feats_path", "data/splits/train/encoder_feats.npy")
            ),
            val_encoder_feats_path=str(
                raw.get("val_encoder_feats_path", "data/splits/val/encoder_feats.npy")
            ),
            test_encoder_feats_path=str(
                raw.get("test_encoder_feats_path", "data/splits/test/encoder_feats.npy")
            ),
        )

    def model_cfg(self) -> Dict[str, Any]:
        """Dict view consumed by the EmotionDiscriminator model constructor."""
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

    @classmethod
    def from_yaml(cls, path: str) -> "GANConfig":
        raw = load_config(path)
        return cls(
            epochs=int(raw.get("EPOCHS", 50)),
            batch_size=int(raw.get("BATCH_SIZE", 32)),
            seed=int(raw.get("SEED", 42)),
            save_freq=int(raw.get("SAVE_FREQ", 5)),
            integration_mode=str(raw.get("INTEGRATION_MODE", "conditioning")),
            noise_dim=int(raw.get("NOISE_DIM", 128)),
            latent_dim=int(raw.get("LATENT_DIM", 64)),
            max_notes=int(raw.get("MAX_NOTES", 512)),
            note_dim=int(raw.get("NOTE_DIM", 4)),
            gen_hidden=int(raw.get("GEN_HIDDEN", 512)),
            lr_g=float(raw.get("LR_G", 2e-4)),
            lr_d=float(raw.get("LR_D", 1e-4)),
            lr_e=float(raw.get("LR_E", 1e-4)),
            weight_decay=float(raw.get("WEIGHT_DECAY", 0.0)),
            beta1=float(raw.get("BETA1", 0.5)),
            beta2=float(raw.get("BETA2", 0.9)),
            use_wgangp=bool(raw.get("USE_WGANGP", True)),
            lambda_gp=float(raw.get("LAMBDA_GP", 10.0)),
            critic_iters=int(raw.get("CRITIC_ITERS", 5)),
            lambda_emotion=float(raw.get("LAMBDA_EMOTION", 1.0)),
            lambda_fm=float(raw.get("LAMBDA_FM", 0.0)),
            fused_critic_batch=bool(raw.get("FUSED_CRITIC_BATCH", False)),
            ema_decay=float(raw.get("EMA_DECAY", 0.0)),
            use_numeric_encoder=bool(raw.get("USE_NUMERIC_ENCODER", True)),
            numeric_input_dim=int(raw.get("NUMERIC_INPUT_DIM", 6)),
            encoder_hidden=tuple(int(h) for h in raw.get("ENCODER_HIDDEN", [256, 128])),
            encoder_out_dim=int(raw.get("ENCODER_OUT_DIM", 128)),
            encoder_dropout=float(raw.get("ENCODER_DROPOUT", 0.2)),
            encoder_use_sn=bool(raw.get("ENCODER_USE_SN", False)),
            n_samples_per_emotion=int(raw.get("N_SAMPLES_PER_EMOTION", 2)),
            checkpoint_dir=str(raw.get("CHECKPOINT_DIR", "experiments/gan/checkpoints")),
            log_dir=str(raw.get("LOG_DIR", "experiments/gan/logs")),
            sample_dir=str(raw.get("SAMPLE_DIR", "experiments/gan/samples")),
            train_split=str(raw.get("TRAIN_SPLIT", "data/splits/train_split.csv")),
            val_split=str(raw.get("VAL_SPLIT", "data/splits/val_split.csv")),
            splits_dir=str(raw.get("SPLITS_DIR", "data/splits")),
            processed_dir=str(raw.get("PROCESSED_DIR", "data/processed")),
            encoder_feats_train=str(
                raw.get("ENCODER_FEATS_TRAIN", "data/splits/train/encoder_feats.npy")
            ),
            encoder_feats_val=str(
                raw.get("ENCODER_FEATS_VAL", "data/splits/val/encoder_feats.npy")
            ),
        )


def asdict(cfg) -> Dict[str, Any]:
    return dataclasses.asdict(cfg)
