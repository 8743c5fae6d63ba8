"""Piano-roll → MIDI codec: the serving part of ``melogan_tpu/midi/codec.py``.

Exact output semantics of the reference renderer (src/gan/utils.py:95-161):

- rows are ``(norm_pitch, norm_velocity, norm_duration, norm_step)``
- ``step_beats  = max(0.1,  (step+1)/2 · 4.0)``     (MAX_BEAT_TIME = 4.0)
- rest rule: ``velocity < −0.2`` ⇒ advance time, emit no note
- ``pitch      = clip(int((p+1)·63.5), 36, 96)`` then snapped to scale
  (nearest allowed pitch class, ties resolved to the lower class)
- ``velocity   = clip(int(60 + (v+0.2)/1.2 · 67), 0, 127)``
- ``duration   = max(0.25, (d+1)/2 · 4.0)`` beats; times = beats · 60/bpm
- bpm clamped to [60, 180]; instrument selected by GM name (default piano)

Per-row arithmetic is float32 (the dtype of model output rows) and time
accumulation float64, as in the JAX package. Bytes come from the object-model
writer (``midifile.MidiSong.to_bytes``), which the JAX package's native
encoder matches byte for byte.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from melogan_torch.midi.gm import instrument_name_to_program
from melogan_torch.midi.midifile import MidiInstrument, MidiNote, MidiSong

# Musical scale interval tables (reference: src/gan/utils.py:14-26).
SCALES: Dict[str, list] = {
    "major": [0, 2, 4, 5, 7, 9, 11],
    "minor": [0, 2, 3, 5, 7, 8, 10],
    "chromatic": [0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11],
    "dorian": [0, 2, 3, 5, 7, 9, 10],
    "phrygian": [0, 1, 3, 5, 7, 8, 10],
    "lydian": [0, 2, 4, 6, 7, 9, 11],
    "mixolydian": [0, 2, 4, 5, 7, 9, 10],
    "locrian": [0, 1, 3, 5, 6, 8, 10],
    "major_pentatonic": [0, 2, 4, 7, 9],
    "minor_pentatonic": [0, 3, 5, 7, 10],
    "blues": [0, 3, 5, 6, 7, 10],
}

NOTE_NAMES = ["C", "C#", "D", "D#", "E", "F", "F#", "G", "G#", "A", "A#", "B"]

MAX_BEAT_TIME = 4.0
VELOCITY_THRESHOLD = -0.2


def scale_snap_table(scale: str, root_key: int = 0) -> np.ndarray:
    """12-entry lookup: pitch class -> snapped pitch class.

    Nearest allowed class by absolute distance within the octave; on a tie the
    *lower* allowed class wins (the reference's ``min(..., key=abs)``).
    """
    intervals = SCALES.get(scale, SCALES["chromatic"])
    allowed = sorted((interval + root_key) % 12 for interval in intervals)
    allowed_arr = np.array(allowed)
    table = np.empty(12, dtype=np.int64)
    for pc in range(12):
        dists = np.abs(allowed_arr - pc)
        table[pc] = allowed_arr[int(np.argmin(dists))]  # argmin: first on ties
    return table


def render_piano_roll(
    notes_array: np.ndarray,
    bpm: float = 120.0,
    scale: str = "major",
    root_key: int = 0,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Render a (N, 4) normalized note array to concrete MIDI note fields.

    Returns ``(pitch[int], velocity[int], start_sec[float64], end_sec[float64])``
    for the kept (non-rest) rows, in row order.
    """
    notes = np.asarray(notes_array, dtype=np.float32).reshape(-1, 4)
    bpm = max(60.0, min(float(bpm), 180.0))
    seconds_per_beat = 60.0 / bpm

    p, v, d, s = notes[:, 0], notes[:, 1], notes[:, 2], notes[:, 3]

    # f32 inner arithmetic; the clamp floor enters the float64 accumulator as
    # exact 0.1 (compare in f32, substitute f64)
    step_inner = ((s + np.float32(1.0)) / np.float32(2.0)) * np.float32(MAX_BEAT_TIME)
    step_beats = np.where(step_inner > np.float32(0.1), step_inner.astype(np.float64), 0.1)
    # exclusive prefix-sum in float64: time advances on every row, rests included
    start_beats = np.concatenate([[0.0], np.cumsum(step_beats)])[:-1]

    keep = v >= np.float32(VELOCITY_THRESHOLD)

    raw_pitch = np.trunc((p + np.float32(1.0)) * np.float32(63.5)).astype(np.int64)
    pitch = np.clip(raw_pitch, 36, 96)
    table = scale_snap_table(scale, root_key)
    pitch = (pitch // 12) * 12 + table[pitch % 12]

    vel_range = np.float32(1.0 - VELOCITY_THRESHOLD)
    vel_offset = v - np.float32(VELOCITY_THRESHOLD)
    velocity = np.trunc(np.float32(60.0) + (vel_offset / vel_range) * np.float32(67.0)).astype(np.int64)
    velocity = np.clip(velocity, 0, 127)

    duration_beats = np.maximum(np.float32(0.25), ((d + np.float32(1.0)) / np.float32(2.0)) * np.float32(MAX_BEAT_TIME))

    start_sec = start_beats * seconds_per_beat
    end_sec = (start_beats + duration_beats.astype(np.float64)) * seconds_per_beat

    return pitch[keep], velocity[keep], start_sec[keep], end_sec[keep]


def piano_roll_to_song(
    notes_array: np.ndarray,
    bpm: float = 120.0,
    scale: str = "major",
    root_key: int = 0,
    instrument_name: str = "Acoustic Grand Piano",
) -> MidiSong:
    """Render a normalized (N, 4) note array into a :class:`MidiSong`."""
    try:
        program = instrument_name_to_program(instrument_name)
    except KeyError:
        print(f"[WARN] Instrument '{instrument_name}' not found. Defaulting to Piano.")
        program = 0

    bpm = max(60.0, min(float(bpm), 180.0))
    pitch, velocity, start, end = render_piano_roll(notes_array, bpm, scale, root_key)

    song = MidiSong(initial_tempo=bpm)
    inst = MidiInstrument(program=program)
    inst.notes = [
        MidiNote(velocity=int(v), pitch=int(p), start=float(st), end=float(en))
        for p, v, st, en in zip(pitch, velocity, start, end)
    ]
    song.instruments.append(inst)
    return song


def render_to_bytes(
    notes_array: np.ndarray,
    bpm: float = 120.0,
    scale: str = "major",
    root_key: int = 0,
    instrument_name: str = "Acoustic Grand Piano",
) -> bytes:
    """Serving path: normalized notes → `.mid` bytes (the reference layout)."""
    return piano_roll_to_song(notes_array, bpm, scale, root_key, instrument_name).to_bytes()


def save_piano_roll_to_midi(
    notes_array: np.ndarray,
    output_path: str,
    fs: int = 100,
    bpm: float = 120.0,
    scale: Optional[str] = None,
    root_key: int = 0,
    instrument_name: str = "Acoustic Grand Piano",
    scale_type: Optional[str] = None,
    verbose: bool = True,
) -> MidiSong:
    """Write a normalized note array to a `.mid` file (reference API parity).

    Accepts both ``scale=`` and ``scale_type=`` (the reference serving code
    passes ``scale_type``, app.py:113); ``scale`` wins if both are given.
    """
    resolved_scale = scale if scale is not None else (scale_type or "major")
    song = piano_roll_to_song(notes_array, bpm, resolved_scale, root_key, instrument_name)
    song.write(output_path)
    if verbose:
        scale_name = f"{NOTE_NAMES[root_key % 12]} {resolved_scale}"
        print(f"[INFO] Saved MIDI ({instrument_name} | {scale_name}) to {output_path}")
    return song
