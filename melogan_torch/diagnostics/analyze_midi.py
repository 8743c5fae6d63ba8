"""Per-file MIDI statistics (reference src/gan/analyze_midi.py:12-58
capability): duration, note count, pitch stats, velocity, note density —
the per-emotion conditioning sanity check for generated output. The port's
copy of ``melogan_tpu/diagnostics/analyze_midi.py``."""
from __future__ import annotations

from typing import Dict

import numpy as np

from melogan_torch.midi.midifile import read_midi


def analyze_file(path: str) -> Dict[str, float]:
    try:
        song = read_midi(path)
    except (ValueError, OSError) as e:
        # one malformed user file must not kill a whole directory scan —
        # the quality gate renders this as "unreadable: ..." (quality.py)
        return {"error": str(e), "n_notes": 0}
    arr = song.note_array()  # (N, 4): pitch, velocity, start, end
    if arr.shape[0] == 0:
        return {"error": "no notes", "n_notes": 0}
    duration = float(arr[:, 3].max())
    pitches = arr[:, 0]
    return {
        "tempo_bpm": round(float(song.initial_tempo), 2),
        "duration_sec": round(duration, 2),
        "n_notes": int(arr.shape[0]),
        "avg_pitch": round(float(pitches.mean()), 2),
        "min_pitch": int(pitches.min()),
        "max_pitch": int(pitches.max()),
        "unique_pitches": int(np.unique(pitches.astype(int)).size),
        "avg_velocity": round(float(arr[:, 1].mean()), 2),
        "notes_per_sec": round(arr.shape[0] / max(duration, 1e-6), 3),
        "avg_note_duration": round(float((arr[:, 3] - arr[:, 2]).mean()), 3),
    }
