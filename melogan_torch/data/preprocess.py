"""Raw AE note layout → the GAN's normalized layout.

The port's own copy of ``raw_to_gan_normalized`` from
``melogan_tpu/data/preprocess.py`` (numpy only). Preprocessing MIDI files
into a corpus comes with a later slice.
"""
from __future__ import annotations

import numpy as np

MAX_BEAT = 4.0  # renderer MAX_BEAT_TIME; used to normalize durations/steps


def raw_to_gan_normalized(notes_raw: np.ndarray) -> np.ndarray:
    """(…, 512, 4) raw (pitch, start, duration, velocity) → normalized GAN
    layout (pitch, velocity, duration, step) ∈ [−1, 1].

    Inverse of the renderer decode: durations and inter-onset steps are
    scaled by MAX_BEAT=4; padding rows (pitch < 0) become rests (velocity
    −1, below the rest threshold −0.2). A row's step is the clock advance
    after its note, start[i+1] − start[i]; the last row gets its duration."""
    notes = np.asarray(notes_raw, np.float32)
    p, s, d, v = notes[..., 0], notes[..., 1], notes[..., 2], notes[..., 3]
    valid = p >= 0

    pitch_n = np.clip((p / 128.0) * 2.0 - 1.0, -1.0, 1.0)
    vel_n = np.clip((np.clip(v, 0, 127) / 128.0) * 2.0 - 1.0, -1.0, 1.0)
    dur_n = np.clip(d / MAX_BEAT, 0.0, 1.0) * 2.0 - 1.0
    step = np.concatenate([np.diff(s, axis=-1), d[..., -1:].copy()], axis=-1)
    step_n = np.clip(step / MAX_BEAT, 0.0, 1.0) * 2.0 - 1.0

    out = np.stack([pitch_n, vel_n, dur_n, step_n], axis=-1)
    pad_row = np.array([-1.0, -1.0, -1.0, -0.95], np.float32)  # silent rest
    out = np.where(valid[..., None], out, pad_row)
    return out.astype(np.float32)
