"""Piano-roll → MIDI codec: the port's copy of ``melogan_tpu/midi/codec.py``
(the serving renderer, and the VAE's raw-unit writer ``save_recon_midi``).

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
accumulation float64, as in the JAX package. ``render_to_bytes`` goes from
the rendered arrays to bytes through the native encoder (``native.py``)
with no Python object a note; the object-model writer
(``midifile.MidiSong.to_bytes``) serves when the library does not load, and
the two agree byte for byte. ``render_piano_roll_torch`` is the on-device
twin of the renderer, as ``render_piano_roll_jax`` is in the JAX package
(no caller there either).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from melogan_torch.midi.gm import instrument_name_to_program
from melogan_torch.midi.midifile import DEFAULT_RESOLUTION, MidiInstrument, MidiNote, MidiSong
from melogan_torch.midi.native import encode_song_native

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


def render_piano_roll_torch(notes_array, bpm: float = 120.0, scale: str = "major", root_key: int = 0):
    """On-device twin of :func:`render_piano_roll` with static shapes, the
    counterpart of JAX's ``render_piano_roll_jax``: float32 throughout, on
    the device of ``notes_array`` (a tensor; anything else goes to the CPU).

    Accepts (..., N, 4) and returns ``(pitch, velocity, start_sec, end_sec,
    keep)`` tensors of shape (..., N); rows where ``keep`` is False are rests.
    bpm / scale / root_key are static Python values.
    """
    import torch

    notes = torch.as_tensor(notes_array, dtype=torch.float32)
    bpm = max(60.0, min(float(bpm), 180.0))
    seconds_per_beat = 60.0 / bpm

    p, v, d, s = notes.unbind(-1)

    def const(x):  # an f32 operand of p's shape, so each op is one IEEE f32 op, as XLA's
        return torch.full_like(p, x)

    step_beats = torch.maximum(const(0.1), ((s + const(1.0)) / const(2.0)) * const(MAX_BEAT_TIME))
    start_beats = torch.cumsum(step_beats, dim=-1) - step_beats  # exclusive prefix sum

    keep = v >= const(VELOCITY_THRESHOLD)

    raw_pitch = torch.trunc((p + const(1.0)) * const(63.5)).to(torch.int32)
    pitch = torch.clamp(raw_pitch, 36, 96)
    table = torch.as_tensor(scale_snap_table(scale, root_key), dtype=torch.int32, device=notes.device)
    pitch = (pitch // 12) * 12 + table[(pitch % 12).long()]

    vel_range = 1.0 - VELOCITY_THRESHOLD
    velocity = torch.trunc(const(60.0) + ((v - const(VELOCITY_THRESHOLD)) / const(vel_range)) * const(67.0))
    velocity = torch.clamp(velocity.to(torch.int32), 0, 127)

    duration_beats = torch.maximum(const(0.25), ((d + const(1.0)) / const(2.0)) * const(MAX_BEAT_TIME))
    start_sec = start_beats * const(seconds_per_beat)
    end_sec = (start_beats + duration_beats) * const(seconds_per_beat)
    return pitch, velocity, start_sec, end_sec, keep


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
    """Serving fast path: normalized notes → `.mid` bytes with no per-note
    Python objects (vectorized render → tick arrays → native C++ encoder,
    the object model only when the native library does not load).
    Byte-identical to :func:`save_piano_roll_to_midi` output."""
    try:
        program = instrument_name_to_program(instrument_name)
    except KeyError:
        program = 0
    bpm = max(60.0, min(float(bpm), 180.0))
    pitch, velocity, start, end = render_piano_roll(notes_array, bpm, scale, root_key)

    ts = 60.0 / (bpm * DEFAULT_RESOLUTION)
    tempo_us = int(6e7 / (60.0 / (ts * DEFAULT_RESOLUTION)))
    encoded = encode_song_native(
        pitch, velocity, np.round(start / ts).astype(np.int64), np.round(end / ts).astype(np.int64),
        program=program, channel=0, tempo_us=tempo_us, division=DEFAULT_RESOLUTION,
    )
    if encoded is not None:
        return encoded
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


# ---------------------------------------------------------------------------
# AE-side writer (reference src/ae/midi_utils.py parity): columns are
# (pitch, start_rel, duration, velocity) in *raw* units, not normalized.
# ---------------------------------------------------------------------------


def notes_array_to_song(
    notes_arr: np.ndarray, tempo: float = 120.0, instrument_program: int = 0
) -> MidiSong:
    """Convert a raw-unit (N, 4) notes array (pitch, start, duration, velocity)
    to a song, skipping rows with pitch<=0 or duration<=0."""
    notes = np.asarray(notes_arr, dtype=np.float64).reshape(-1, 4)
    p, s, d, v = notes[:, 0], notes[:, 1], notes[:, 2], notes[:, 3]
    keep = (p > 0) & (d > 0)

    pitch = np.clip(np.round(p[keep]), 0, 127).astype(np.int64)
    vel = np.clip(np.round(v[keep]), 1, 127).astype(np.int64)
    start = s[keep]
    end = s[keep] + d[keep]

    song = MidiSong(initial_tempo=tempo)
    inst = MidiInstrument(program=instrument_program)
    inst.notes = [
        MidiNote(velocity=int(vv), pitch=int(pp), start=float(st), end=float(en))
        for pp, vv, st, en in zip(pitch, vel, start, end)
    ]
    song.instruments.append(inst)
    return song


def raw_roll_to_song(roll: np.ndarray, bpm: float = 120.0) -> MidiSong:
    """tools/roll_to_midi.py semantics: rows are RAW
    (pitch, velocity, duration_sec, start_sec); pitch clipped 0-127, velocity
    floored at 1, duration floored at 0.05 s, start floored at 0."""
    arr = np.asarray(roll, np.float64).reshape(-1, 4)
    pitch = np.clip(arr[:, 0], 0, 127).astype(np.int64)
    vel = np.clip(arr[:, 1], 1, 127).astype(np.int64)
    dur = np.maximum(arr[:, 2], 0.05)
    start = np.maximum(arr[:, 3], 0.0)
    song = MidiSong(initial_tempo=bpm)
    inst = MidiInstrument(program=0)
    inst.notes = [
        MidiNote(velocity=int(v), pitch=int(p), start=float(s), end=float(s + d))
        for p, v, d, s in zip(pitch, vel, dur, start)
    ]
    song.instruments.append(inst)
    return song


def save_recon_midi(
    notes_in: np.ndarray,
    notes_out: np.ndarray,
    outdir: str,
    prefix: str,
    tempo: float = 120.0,
) -> None:
    """Write `<prefix>_in.mid` / `<prefix>_out.mid` reconstruction pairs."""
    import os

    os.makedirs(outdir, exist_ok=True)
    notes_array_to_song(notes_in, tempo=tempo).write(os.path.join(outdir, f"{prefix}_in.mid"))
    notes_array_to_song(notes_out, tempo=tempo).write(os.path.join(outdir, f"{prefix}_out.mid"))
