"""Preprocessing pipeline: raw MIDI → per-song .npz + per-split fast arrays.
The port's copy of ``melogan_tpu/data/preprocess.py``.

The reference repo does NOT ship its preprocessing script (the author's
gitignored ``nothing.py``, SURVEY.md §2.9); this module rebuilds it from the
observable schema:

- per-song ``notes`` (512, 4): RAW units, AE column order (pitch, start_beats,
  duration_beats, velocity); pads with pitch = −1
  (consistent with src/ae/dataset.py:72-89 normalization masks)
- 6 numeric features, reverse-engineered from the shipped scaler statistics
  (data/models/scaler.joblib, mean ≈ [119.5, 0.685, −0.027, −0.195, 339.65, 0]):
    0. tempo (bpm)                                    mean ≈ 119.5 ✓
    1. key strength (Krumhansl–Schmuckler correlation) mean ≈ 0.685 ✓
    2. mode: +1 major / −1 minor                       mean ≈ −0.03 ✓
    3. mean normalized velocity (v/64 − 1)             mean ≈ −0.195 ✓
    4. mean-pitch frequency in Hz (440·2^((p̄−69)/12))  mean ≈ 339.65 ✓
    5. constant 0 (the reference's sixth feature is constant per the scaler)
  standardized with a StandardScaler fit on the train split
- per-split fast arrays (``notes.npy``/``emotion.npy``/``numeric_features.npy``,
  the GANDataset fast path, src/gan/dataset.py:32-56): notes in NORMALIZED
  GAN layout (pitch, velocity, duration, step) ∈ [−1, 1], the renderer's
  input convention (src/gan/utils.py:131)
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from melogan_torch.data.npz import (
    MAX_NOTES,
    Sample,
    pad_notes,
    resolve_split,
    save_sample,
)
from melogan_torch.data.scaler import StandardScaler
from melogan_torch.midi.midifile import MidiSong, read_midi

# Krumhansl–Schmuckler key profiles (standard music-cognition data)
_KS_MAJOR = np.array([6.35, 2.23, 3.48, 2.33, 4.38, 4.09, 2.52, 5.19, 2.39, 3.66, 2.29, 2.88])
_KS_MINOR = np.array([6.33, 2.68, 3.52, 5.38, 2.60, 3.53, 2.54, 4.75, 3.98, 2.69, 3.34, 3.17])

MAX_BEAT = 4.0  # renderer MAX_BEAT_TIME; used to normalize durations/steps


def extract_notes(song: MidiSong, max_notes: int = MAX_NOTES) -> Tuple[np.ndarray, float]:
    """All non-drum notes → (max_notes, 4) raw AE-layout array + tempo."""
    tempo = float(song.initial_tempo)
    spb = 60.0 / max(tempo, 1e-6)
    rows = []
    for inst in song.instruments:
        if inst.is_drum:
            continue
        for n in inst.notes:
            rows.append((float(n.pitch), n.start / spb, (n.end - n.start) / spb, float(n.velocity)))
    if not rows:
        return pad_notes(np.zeros((0, 4), np.float32), max_notes), tempo
    arr = np.asarray(rows, dtype=np.float32)
    order = np.lexsort((arr[:, 0], arr[:, 1]))  # by start, then pitch
    return pad_notes(arr[order], max_notes), tempo


def key_analysis(notes_raw: np.ndarray) -> Tuple[float, float]:
    """(key_strength, mode) via Krumhansl–Schmuckler profile correlation.

    Duration-weighted pitch-class histogram correlated against the 24
    major/minor profile rotations; strength = best correlation (0..1-ish),
    mode = +1 if the best key is major else −1.
    """
    mask = notes_raw[:, 0] >= 0
    if not mask.any():
        return 0.0, 1.0
    pitches = notes_raw[mask, 0].astype(int) % 12
    weights = np.maximum(notes_raw[mask, 2], 1e-3)
    hist = np.zeros(12)
    np.add.at(hist, pitches, weights)
    if hist.std() == 0:
        return 0.0, 1.0

    def best_corr(profile):
        scores = []
        for rot in range(12):
            p = np.roll(profile, rot)
            c = np.corrcoef(hist, p)[0, 1]
            scores.append(c)
        return max(scores)

    cmaj, cmin = best_corr(_KS_MAJOR), best_corr(_KS_MINOR)
    if cmaj >= cmin:
        return float(cmaj), 1.0
    return float(cmin), -1.0


def numeric_features_raw(notes_raw: np.ndarray, tempo: float) -> np.ndarray:
    """Un-standardized 6-feature vector for one song."""
    mask = notes_raw[:, 0] >= 0
    strength, mode = key_analysis(notes_raw)
    if mask.any():
        mean_vel = float(notes_raw[mask, 3].mean())
        mean_pitch = float(notes_raw[mask, 0].mean())
    else:
        mean_vel, mean_pitch = 64.0, 60.0
    freq = 440.0 * 2.0 ** ((mean_pitch - 69.0) / 12.0)
    return np.array(
        [tempo, strength, mode, mean_vel / 64.0 - 1.0, freq, 0.0], dtype=np.float32
    )


def preprocess_midi_file(midi_path: str, mood: str, max_notes: int = MAX_NOTES) -> Tuple[Sample, np.ndarray]:
    """One raw MIDI file → (Sample with raw features, raw feature vector).

    Feature standardization is corpus-level; the caller overwrites
    ``sample.numeric_features`` after fitting the scaler.
    """
    song = read_midi(midi_path)
    notes, tempo = extract_notes(song, max_notes)
    feats = numeric_features_raw(notes, tempo)
    sample = Sample(
        notes=notes,
        mood=mood,
        numeric_features=feats,
        tempo=tempo,
        filename=os.path.basename(midi_path),
    )
    return sample, feats


def preprocess_corpus(
    entries: Sequence[Tuple[str, str, str]],
    processed_dir: str,
    scaler: Optional[StandardScaler] = None,
    fit_scaler: bool = True,
    max_notes: int = MAX_NOTES,
    verbose: bool = True,
) -> StandardScaler:
    """Process (file_key, midi_path, mood) entries → ``processed_dir/<key>.npz``.

    Fits the StandardScaler over the corpus raw features (unless given one),
    then standardizes every sample's features before writing. Returns the
    scaler for reuse on other splits.
    """
    os.makedirs(processed_dir, exist_ok=True)
    samples: List[Tuple[str, Sample]] = []
    raw_feats = []
    for file_key, midi_path, mood in entries:
        try:
            sample, feats = preprocess_midi_file(midi_path, mood, max_notes)
        except Exception as e:  # noqa: BLE001 — fail-soft row dropping
            if verbose:
                print(f"[WARN] failed to preprocess {midi_path}: {e}")
            continue
        samples.append((file_key, sample))
        raw_feats.append(feats)
    if not samples:
        raise RuntimeError("no MIDI files could be preprocessed")
    feats_arr = np.stack(raw_feats)
    if scaler is None:
        scaler = StandardScaler()
        if fit_scaler:
            scaler.fit(feats_arr)
    std = scaler.transform(feats_arr)
    for (file_key, sample), f in zip(samples, std):
        sample.numeric_features = f
        save_sample(os.path.join(processed_dir, f"{file_key}.npz"), sample)
    if verbose:
        print(f"[INFO] preprocessed {len(samples)}/{len(entries)} files -> {processed_dir}")
    return scaler


# ---------------------------------------------------------------------------
# Raw AE layout ⇄ normalized GAN layout
# ---------------------------------------------------------------------------


def raw_to_gan_normalized(notes_raw: np.ndarray) -> np.ndarray:
    """(…, 512, 4) raw (pitch, start, duration, velocity) → normalized GAN
    layout (pitch, velocity, duration, step) ∈ [−1, 1].

    Inverse of the renderer decode (src/gan/utils.py:131-148): durations and
    inter-onset steps are scaled by MAX_BEAT=4; padding rows become rests
    (velocity −1 < rest threshold −0.2)."""
    notes = np.asarray(notes_raw, np.float32)
    p, s, d, v = notes[..., 0], notes[..., 1], notes[..., 2], notes[..., 3]
    valid = p >= 0

    pitch_n = np.clip((p / 128.0) * 2.0 - 1.0, -1.0, 1.0)
    vel_n = np.clip((np.clip(v, 0, 127) / 128.0) * 2.0 - 1.0, -1.0, 1.0)
    dur_n = np.clip(d / MAX_BEAT, 0.0, 1.0) * 2.0 - 1.0
    # renderer semantics: a row's step is the clock advance AFTER its note
    # (exclusive prefix sum on decode, src/gan/utils.py:133,151), so
    # step[i] = start[i+1] − start[i]; the last row gets its duration as a
    # trailing gap.
    step = np.concatenate(
        [np.diff(s, axis=-1), d[..., -1:].copy()], axis=-1
    )
    step_n = np.clip(step / MAX_BEAT, 0.0, 1.0) * 2.0 - 1.0

    out = np.stack([pitch_n, vel_n, dur_n, step_n], axis=-1)
    pad_row = np.array([-1.0, -1.0, -1.0, -0.95], np.float32)  # silent rest
    out = np.where(valid[..., None], out, pad_row)
    return out.astype(np.float32)


def gan_normalized_to_raw(notes_gan: np.ndarray) -> np.ndarray:
    """Normalized GAN layout → raw AE layout (for diagnostics/round-trips)."""
    notes = np.asarray(notes_gan, np.float32)
    p, v, d, s = notes[..., 0], notes[..., 1], notes[..., 2], notes[..., 3]
    pitch = (p + 1.0) / 2.0 * 128.0
    vel = (v + 1.0) / 2.0 * 128.0
    dur = (d + 1.0) / 2.0 * MAX_BEAT
    step = (s + 1.0) / 2.0 * MAX_BEAT
    start = np.cumsum(step, axis=-1) - step
    return np.stack([pitch, start, dur, vel], axis=-1).astype(np.float32)


def build_split_arrays(
    split_csv: str,
    processed_dir: str,
    out_dir: str,
    numeric_input_dim: int = 6,
    verbose: bool = True,
) -> Dict[str, np.ndarray]:
    """Build the GANDataset fast-path arrays for one split:
    ``<out_dir>/{notes,emotion,numeric_features}.npy``."""
    from melogan_torch.data.npz import load_sample

    paths, emotions, dropped = resolve_split(split_csv, processed_dir)
    if verbose and dropped:
        print(f"[WARN] {len(dropped)} rows of {split_csv} had no .npz; dropped")
    notes, moods, feats = [], [], []
    for path, emo in zip(paths, emotions):
        sample = load_sample(path, numeric_input_dim)
        notes.append(raw_to_gan_normalized(sample.notes))
        moods.append(sample.mood or emo)
        feats.append(sample.numeric_features)
    arrays = {
        "notes": np.stack(notes) if notes else np.zeros((0, MAX_NOTES, 4), np.float32),
        "emotion": np.asarray(moods),
        "numeric_features": np.stack(feats) if feats else np.zeros((0, numeric_input_dim), np.float32),
    }
    os.makedirs(out_dir, exist_ok=True)
    from melogan_torch.utils.atomic import atomic_write

    for name, arr in arrays.items():
        # atomic: these arrays are pipeline --resume completion markers, and
        # a half-written notes.npy would poison every later stage
        atomic_write(os.path.join(out_dir, f"{name}.npy"),
                     lambda f, a=arr: np.save(f, a), mode="wb")
    if verbose:
        print(f"[INFO] wrote split arrays ({arrays['notes'].shape[0]} rows) -> {out_dir}")
    return arrays
