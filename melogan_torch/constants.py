"""Serving constants shared by the sampler, the HTTP app and the quality gate."""
from __future__ import annotations

from typing import Dict

# Serving bpm map (reference app.py:110).
EMOTION_BPM: Dict[str, float] = {"happy": 140.0, "sad": 70.0, "angry": 160.0, "calm": 90.0}

# Sampling bpm jitter: bpm ~ U(bpm·(1−J), bpm·(1+J)); the quality gate's
# tempo bands admit it.
BPM_JITTER = 0.15
