"""Serving constants shared by the sampler and the HTTP app."""
from __future__ import annotations

from typing import Dict

# Serving bpm map (reference app.py:110).
EMOTION_BPM: Dict[str, float] = {"happy": 140.0, "sad": 70.0, "angry": 160.0, "calm": 90.0}
