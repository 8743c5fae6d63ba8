"""Per-song .npz sample schema + unified split-CSV resolution.

The port's copy of ``melogan_tpu/data/npz.py`` (numpy and the standard library).

Schema (reference-compatible, SURVEY.md §2.9):
- ``notes``            (MAX_NOTES, 4) float32 — RAW units, AE column order
                       (pitch 0-127, start_beats, duration_beats, velocity
                       0-127); padding rows have pitch = −1
- ``mood``             str — one of happy/sad/angry/calm
- ``numeric_features`` (6,) float32 — standardized numeric conditioning vector
- ``tempo``            float — bpm
- ``filename``         str

Split CSVs carry ``file_key, emotion, source, full_path, npz_path`` columns
(reference data/splits/*.csv layout).
"""
from __future__ import annotations

import csv
import glob
import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

MAX_NOTES = 512
NOTE_DIM = 4
PAD_PITCH = -1.0


@dataclass
class Sample:
    notes: np.ndarray  # (MAX_NOTES, 4) float32, raw units
    mood: str
    numeric_features: np.ndarray  # (6,) float32
    tempo: float
    filename: str


def save_sample(path: str, sample: Sample) -> str:
    os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)
    np.savez(
        path,
        notes=sample.notes.astype(np.float32),
        mood=sample.mood,
        numeric_features=sample.numeric_features.astype(np.float32),
        tempo=float(sample.tempo),
        filename=sample.filename,
    )
    return path


def load_sample(path: str, numeric_input_dim: int = 6) -> Sample:
    with np.load(path, allow_pickle=True) as data:
        notes = data["notes"].astype(np.float32)
        mood = str(data["mood"]) if "mood" in data else ""
        numeric = (
            data["numeric_features"].astype(np.float32)
            if "numeric_features" in data
            else np.zeros(numeric_input_dim, np.float32)
        )
        # pad/truncate malformed numeric vectors (gan/dataset.py:96-113 parity)
        if numeric.size != numeric_input_dim:
            fixed = np.zeros(numeric_input_dim, np.float32)
            n = min(numeric.size, numeric_input_dim)
            fixed[:n] = numeric.flatten()[:n]
            numeric = fixed
        tempo = float(data["tempo"]) if "tempo" in data else 120.0
        filename = str(data["filename"]) if "filename" in data else os.path.basename(path)
    return Sample(notes, mood, numeric, tempo, filename)


def pad_notes(notes: np.ndarray, max_notes: int = MAX_NOTES) -> np.ndarray:
    """Truncate or pad (N, 4) raw notes to (max_notes, 4); pad rows get
    pitch = −1 so downstream normalization masks them out."""
    notes = np.asarray(notes, dtype=np.float32).reshape(-1, NOTE_DIM)
    if notes.shape[0] >= max_notes:
        return notes[:max_notes]
    pad = np.zeros((max_notes - notes.shape[0], NOTE_DIM), np.float32)
    pad[:, 0] = PAD_PITCH
    return np.concatenate([notes, pad], axis=0)


# ---------------------------------------------------------------------------
# Split CSV resolution (the one true resolver)
# ---------------------------------------------------------------------------

PREFERRED_COLUMNS = (
    "npz_path",
    "processed_file",
    "processed",
    "full_path",
    "filepath",
    "file",
    "filename",
    "file_key",
)


def read_split_csv(split_csv: str) -> List[Dict[str, str]]:
    with open(split_csv, newline="") as f:
        return list(csv.DictReader(f))


def _resolve_one(cell: str, row: Dict[str, str], processed_dir: str) -> Optional[str]:
    cell = str(cell)
    # direct path (absolute, or relative to processed_dir)
    candidate = cell if os.path.isabs(cell) else os.path.join(processed_dir, cell)
    if cell.lower().endswith(".npz") and os.path.exists(candidate):
        return candidate
    # stem-based glob fallback
    stem = os.path.splitext(os.path.basename(cell))[0]
    if stem:
        hits = sorted(glob.glob(os.path.join(processed_dir, f"*{stem}*.npz")))
        if hits:
            return hits[0]
    # explicit npz_path column fallback
    alt = row.get("npz_path", "")
    if alt and alt != cell:
        candidate = alt if os.path.isabs(alt) else os.path.join(processed_dir, alt)
        if os.path.exists(candidate):
            return candidate
    return None


def resolve_split(
    split_csv: str,
    processed_dir: str,
    emotion_columns: Sequence[str] = ("emotion", "mood", "label"),
) -> Tuple[List[str], List[str], List[Dict[str, str]]]:
    """Resolve a split CSV to existing .npz paths.

    Returns (paths, emotions, dropped_rows). Rows whose .npz cannot be found
    are dropped fail-soft (reference behavior across all four resolvers).
    """
    rows = read_split_csv(split_csv)
    if not rows:
        return [], [], []
    col = next((c for c in PREFERRED_COLUMNS if c in rows[0]), None)
    if col is None:
        raise KeyError(
            f"split CSV must contain one of {PREFERRED_COLUMNS}; has {list(rows[0])}"
        )
    paths, emotions, dropped = [], [], []
    for row in rows:
        resolved = _resolve_one(row[col], row, processed_dir)
        if resolved is None:
            dropped.append(row)
            continue
        paths.append(resolved)
        emotions.append(
            next((row[c] for c in emotion_columns if c in row and row[c]), "")
        )
    return paths, emotions, dropped


def write_filtered_csv(split_csv: str, kept_rows: List[Dict[str, str]], out_path: str) -> str:
    """Persist the auto-filtered view of a split (ed_dataset.py:477-485 parity)."""
    if not kept_rows:
        return out_path
    with open(out_path, "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=list(kept_rows[0].keys()))
        writer.writeheader()
        writer.writerows(kept_rows)
    return out_path
