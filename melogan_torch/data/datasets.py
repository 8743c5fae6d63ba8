"""In-memory array datasets and batch iterators: the port's copy of
``melogan_tpu/data/datasets.py`` (numpy only).

The corpus is small (1282 songs × 512×4 floats ≈ 10 MB), so a split is
loaded once into contiguous numpy arrays and batched by index; the training
loops move it to the device once and gather each batch there.

Semantics parity with the reference:
- AE normalization (src/ae/dataset.py:72-89): pitch/velocity → [−1, 1] masked
  where pitch ≠ −1; start /100; duration /20; NaN→0
- AE augmentations (tempo-scale, pitch-shift, note-dropout, velocity-jitter,
  timing-jitter; src/ae/dataset.py:11-40), config-disabled by default
- ED label map happy/sad/angry/calm → 0..3; optional inverse-frequency
  weighted sampling (ed_dataset.py:505-538)
- GAN batches: (notes, emotion_idx, latent, numeric) with a zero-latent
  fallback (gan/dataset.py:172,191)
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from melogan_torch import EMOTION_TO_INDEX
from melogan_torch.config import AEConfig
from melogan_torch.data.npz import load_sample, resolve_split
from melogan_torch.data.preprocess import raw_to_gan_normalized


# ---------------------------------------------------------------------------
# AE normalization + augmentations
# ---------------------------------------------------------------------------


def ae_normalize(
    notes_raw: np.ndarray, max_start_beat: float = 100.0, max_duration_beat: float = 20.0
) -> np.ndarray:
    """Raw AE-layout notes → the VAE's training domain."""
    notes = np.array(notes_raw, dtype=np.float32, copy=True)
    mask = notes[..., 0] != -1
    p = notes[..., 0]
    s = notes[..., 1]
    d = notes[..., 2]
    v = notes[..., 3]
    notes[..., 0] = np.where(mask, (p / 128.0) * 2.0 - 1.0, p)
    notes[..., 1] = np.where(mask, s / max_start_beat, s)
    notes[..., 2] = np.where(mask, d / max_duration_beat, d)
    notes[..., 3] = np.where(mask, (np.clip(v, 0, 127) / 128.0) * 2.0 - 1.0, v)
    return np.nan_to_num(notes, nan=0.0, posinf=0.0, neginf=0.0)


def ae_denormalize(
    notes_norm: np.ndarray, max_start_beat: float = 100.0, max_duration_beat: float = 20.0
) -> np.ndarray:
    """Inverse of :func:`ae_normalize` (for reconstruction MIDI dumps)."""
    notes = np.array(notes_norm, dtype=np.float32, copy=True)
    notes[..., 0] = (notes[..., 0] + 1.0) / 2.0 * 128.0
    notes[..., 1] = notes[..., 1] * max_start_beat
    notes[..., 2] = notes[..., 2] * max_duration_beat
    notes[..., 3] = (notes[..., 3] + 1.0) / 2.0 * 128.0
    return notes


def augment_ae_notes(notes: np.ndarray, cfg: AEConfig, rng: np.random.Generator) -> np.ndarray:
    """Probabilistic AE augmentations on one normalized (T, 4) array."""
    a = cfg.augment
    out = notes
    if a.tempo_jitter > 0 and rng.random() < 0.3:
        scale = 1.0 + rng.uniform(-a.tempo_jitter, a.tempo_jitter)
        out = out.copy()
        out[:, 1] *= scale
        out[:, 2] *= scale
    if a.pitch_shift != 0 and rng.random() < 0.3:
        out = out.copy()
        out[:, 0] += rng.integers(-a.pitch_shift, a.pitch_shift + 1)
    if a.note_dropout > 0 and rng.random() < 0.2:
        out = out.copy()
        drop = rng.random(out.shape[0]) < a.note_dropout
        out[drop] = 0.0
    if a.velocity_jitter > 0 and rng.random() < 0.3:
        out = out.copy()
        out[:, 3] += rng.normal(0, a.velocity_jitter, out.shape[0])
    if a.timing_jitter > 0 and rng.random() < 0.2:
        out = out.copy()
        out[:, 1] = np.clip(out[:, 1] + rng.normal(0, a.timing_jitter, out.shape[0]), 0.0, None)
    return out


# ---------------------------------------------------------------------------
# Loaders
# ---------------------------------------------------------------------------


@dataclass
class SplitData:
    """One split, fully materialized."""

    notes_raw: np.ndarray  # (N, 512, 4) raw AE layout
    emotions: np.ndarray  # (N,) str
    numeric: np.ndarray  # (N, 6) standardized
    filenames: List[str]

    @property
    def n(self) -> int:
        return self.notes_raw.shape[0]

    @property
    def emotion_idx(self) -> np.ndarray:
        return np.array([EMOTION_TO_INDEX.get(str(e).lower(), -1) for e in self.emotions])

    def notes_gan(self) -> np.ndarray:
        return raw_to_gan_normalized(self.notes_raw)

    def notes_ae(self, cfg: Optional[AEConfig] = None) -> np.ndarray:
        cfg = cfg or AEConfig()
        return ae_normalize(self.notes_raw, cfg.max_start_beat, cfg.max_duration_beat)


def load_split(
    split_csv: str, processed_dir: str, numeric_input_dim: int = 6, verbose: bool = True
) -> SplitData:
    paths, emotions, dropped = resolve_split(split_csv, processed_dir)
    if dropped:
        if verbose:
            print(f"[WARN] dropped {len(dropped)} unresolvable rows from {split_csv}")
        # persist the filtered view (reference ed_dataset.py:477-485 behavior)
        from melogan_torch.data.npz import read_split_csv, write_filtered_csv

        rows = read_split_csv(split_csv)
        dropped_keys = {tuple(sorted(r.items())) for r in dropped}
        kept = [r for r in rows if tuple(sorted(r.items())) not in dropped_keys]
        out = os.path.join(
            os.path.dirname(os.path.abspath(split_csv)),
            f"auto_filtered_{os.path.basename(split_csv)}",
        )
        try:
            write_filtered_csv(split_csv, kept, out)
        except OSError:
            pass
    notes, moods, feats, names = [], [], [], []
    for path, emo in zip(paths, emotions):
        s = load_sample(path, numeric_input_dim)
        notes.append(s.notes)
        moods.append(s.mood or emo)
        feats.append(s.numeric_features)
        names.append(s.filename)
    if not notes:
        raise RuntimeError(f"no samples resolved for {split_csv}")
    return SplitData(
        notes_raw=np.stack(notes),
        emotions=np.asarray(moods),
        numeric=np.stack(feats),
        filenames=names,
    )


def load_split_fast(split_dir: str) -> Optional[Dict[str, np.ndarray]]:
    """GANDataset fast path: per-split {notes, emotion, numeric_features}.npy
    (notes already in normalized GAN layout)."""
    files = {n: os.path.join(split_dir, f"{n}.npy") for n in ("notes", "emotion", "numeric_features")}
    if not all(os.path.exists(p) for p in files.values()):
        return None
    out = {n: np.load(p, allow_pickle=True) for n, p in files.items()}
    n = out["notes"].shape[0]
    if not (out["emotion"].shape[0] == n and out["numeric_features"].shape[0] == n):
        raise ValueError("split fast-path arrays are misaligned")
    return out


# ---------------------------------------------------------------------------
# Batch iteration
# ---------------------------------------------------------------------------


def epoch_batches(
    n: int,
    batch_size: int,
    rng: np.random.Generator,
    shuffle: bool = True,
    drop_last: bool = True,
    weights: Optional[np.ndarray] = None,
) -> Iterator[np.ndarray]:
    """Yield index batches for one epoch.

    ``weights`` enables inverse-frequency sampling-with-replacement
    (WeightedRandomSampler parity, ed_dataset.py:505-538)."""
    if weights is not None:
        p = np.asarray(weights, np.float64)
        p = p / p.sum()
        order = rng.choice(n, size=n, replace=True, p=p)
    elif shuffle:
        order = rng.permutation(n)
    else:
        order = np.arange(n)
    n_full = n // batch_size
    for i in range(n_full):
        yield order[i * batch_size : (i + 1) * batch_size]
    if not drop_last and n % batch_size:
        yield order[n_full * batch_size :]


def class_balance_weights(labels: np.ndarray) -> np.ndarray:
    """Per-sample 1/class-count weights."""
    labels = np.asarray(labels)
    counts: Dict = {}
    for l in labels:
        counts[int(l)] = counts.get(int(l), 0) + 1
    return np.array([1.0 / counts[int(l)] for l in labels], np.float64)


def epoch_group_indices(
    n: int, batch_size: int, group: int, rng: np.random.Generator
) -> Tuple[Optional[np.ndarray], Optional[np.ndarray]]:
    """One epoch's shuffled gather indices: (groups (G, group, B) or None,
    tail (K, B) or None). drop_last=True parity with the reference loop."""
    order = rng.permutation(n)
    n_batches = n // batch_size
    idx = order[: n_batches * batch_size].reshape(n_batches, batch_size)
    n_groups = n_batches // group
    groups = (
        idx[: n_groups * group].reshape(n_groups, group, batch_size)
        if n_groups
        else None
    )
    rem = n_batches - n_groups * group
    tail = idx[n_groups * group :] if rem else None
    return groups, tail
