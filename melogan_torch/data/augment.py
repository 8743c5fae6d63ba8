"""Corpus expansion: real MIDI songs → an augmentation-expanded training
corpus. The port's copy of ``melogan_tpu/data/augment.py``.

The reference defines 5 AE augmentations (tempo-scale, pitch-shift,
note-dropout, velocity-jitter, timing-jitter — src/ae/dataset.py:11-40) but
ships them disabled and never uses them to grow data. Here they become a
corpus EXPANSION operator on raw note arrays: each source song yields K
deterministic augmented variants written as real ``.npz`` samples with
freshly computed numeric features, and splits are grouped BY SOURCE SONG so
no variant of a train song can leak into val/test.
"""
from __future__ import annotations

import csv
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from melogan_torch import EMOTIONS
from melogan_torch.data.npz import MAX_NOTES, PAD_PITCH, Sample, save_sample
from melogan_torch.data.preprocess import (
    extract_notes,
    numeric_features_raw,
)
from melogan_torch.data.scaler import StandardScaler
from melogan_torch.midi.midifile import read_midi


def augment_song_raw(
    notes_raw: np.ndarray,
    tempo: float,
    rng: np.random.Generator,
) -> Tuple[np.ndarray, float]:
    """One augmented variant of a raw (T, 4) (pitch, start, duration,
    velocity) array. All five reference transforms applied with random
    magnitudes; padding rows (pitch = −1) are preserved."""
    out = notes_raw.copy()
    mask = out[:, 0] >= 0
    n = int(mask.sum())
    if n == 0:
        return out, tempo

    # pitch shift: whole-song transposition, interval structure preserved
    shift = int(rng.integers(-5, 6))
    out[mask, 0] = np.clip(out[mask, 0] + shift, 21, 108)

    # tempo scale: stretch the beat grid; the song's bpm scales inversely
    s = float(rng.uniform(0.85, 1.18))
    out[:, 1] *= s
    out[:, 2] *= s
    aug_tempo = float(np.clip(tempo / s, 40.0, 220.0))

    # velocity jitter
    out[mask, 3] = np.clip(out[mask, 3] + rng.normal(0, 6.0, n), 1, 127)

    # timing jitter: small humanization around each onset
    starts = out[mask, 1]
    steps = np.diff(starts)
    med = float(np.median(np.abs(steps))) if steps.size else 0.25
    out[mask, 1] = np.maximum(starts + rng.normal(0, 0.05 * max(med, 1e-3), n), 0.0)

    # note dropout: ~2% of sounding rows become silent padding
    drop = mask & (rng.random(out.shape[0]) < 0.02)
    out[drop, 0] = PAD_PITCH
    out[drop, 1:] = 0.0
    return out, aug_tempo


def expand_corpus(
    entries: Sequence[Tuple[str, str, str]],
    out_root: str,
    per_song: int = 20,
    ratios: Tuple[float, float, float] = (0.5, 0.25, 0.25),
    seed: int = 42,
    max_notes: int = MAX_NOTES,
    verbose: bool = True,
) -> Dict:
    """(file_key, midi_path, mood) sources → an expanded corpus under
    ``out_root`` (``processed/`` npz + ``splits/{train,val,test}_split.csv``
    + a manifest).

    Each source song contributes ``per_song`` augmented variants PLUS itself.
    Splits are stratified per emotion over SOURCE SONGS (grouped split: every
    variant follows its source), so eval rows are derived from songs the
    model never saw in any form. The feature scaler is fit on the TRAIN
    portion only and applied to all splits (reference scaler.joblib
    semantics: fit on train — n_samples_seen 890 < corpus size)."""
    rng = np.random.default_rng(seed)
    processed = os.path.join(out_root, "processed")
    splits_dir = os.path.join(out_root, "splits")
    os.makedirs(processed, exist_ok=True)
    os.makedirs(splits_dir, exist_ok=True)

    # group sources per emotion, then cut sources into splits
    by_emotion: Dict[str, List[Tuple[str, str, str]]] = {e: [] for e in EMOTIONS}
    for row in entries:
        emotion = str(row[2]).lower()
        if emotion not in by_emotion:
            raise ValueError(f"unknown emotion {emotion!r} in manifest")
        by_emotion[emotion].append(row)

    split_sources: Dict[str, List[Tuple[str, str, str]]] = {
        "train": [], "val": [], "test": []}
    for emotion, rows in by_emotion.items():
        order = rng.permutation(len(rows))
        n = len(rows)
        n_train = max(1, int(round(n * ratios[0]))) if n else 0
        n_val = max(1, int(round(n * ratios[1]))) if n > 1 else 0
        for j, idx in enumerate(order):
            if j < n_train:
                split_sources["train"].append(rows[idx])
            elif j < n_train + n_val:
                split_sources["val"].append(rows[idx])
            else:
                split_sources["test"].append(rows[idx])

    # expand each split: source + per_song variants, raw features collected
    all_samples: Dict[str, List[Tuple[str, Sample, np.ndarray]]] = {}
    for split, sources in split_sources.items():
        rows_out: List[Tuple[str, Sample, np.ndarray]] = []
        for file_key, midi_path, mood in sources:
            song = read_midi(midi_path)
            notes, tempo = extract_notes(song, max_notes)
            variants = [(f"{file_key}", notes, tempo)]
            for k in range(per_song):
                aug_notes, aug_tempo = augment_song_raw(notes, tempo, rng)
                variants.append((f"{file_key}__aug{k:03d}", aug_notes, aug_tempo))
            for key, arr, tp in variants:
                feats = numeric_features_raw(arr, tp)
                rows_out.append((key, Sample(
                    notes=arr, mood=mood, numeric_features=feats,
                    tempo=tp, filename=f"{key}.mid"), feats))
        all_samples[split] = rows_out

    scaler = StandardScaler()
    scaler.fit(np.stack([f for _, _, f in all_samples["train"]]))

    manifest_rows = []
    for split, rows_out in all_samples.items():
        std = scaler.transform(np.stack([f for _, _, f in rows_out])) \
            if rows_out else np.zeros((0, 6), np.float32)
        csv_path = os.path.join(splits_dir, f"{split}_split.csv")
        with open(csv_path, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=[
                "file_key", "emotion", "source", "full_path", "npz_path"])
            w.writeheader()
            for (key, sample, _), feats in zip(rows_out, std):
                sample.numeric_features = feats
                npz_path = os.path.join(processed, f"{key}.npz")
                save_sample(npz_path, sample)
                w.writerow(dict(file_key=key, emotion=sample.mood,
                                source="augmented", full_path=sample.filename,
                                npz_path=npz_path))
                manifest_rows.append((key, sample.mood, split))
        if verbose:
            print(f"[augment] {split}: {len(rows_out)} rows "
                  f"({len(split_sources[split])} sources x (1+{per_song}))")

    # scaler artifact (pipeline/diagnose compatibility)
    scaler.save(os.path.join(out_root, "scaler.npz"))
    counts = {s: len(r) for s, r in all_samples.items()}
    return {"counts": counts, "splits_dir": splits_dir,
            "processed_dir": processed,
            "sources": {s: len(r) for s, r in split_sources.items()}}
