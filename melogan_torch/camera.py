"""Camera emotion pipeline: frame → face → FER → music emotion.

The port's copy of ``melogan_tpu/camera.py`` over the port's FER
(``models/xception.py``) and face detector (``models/ssd.py``).

Headless equivalent of the reference's webcam loop (camera/camera.py:70-125):
face detection (SSD when weights are available, else a luminance-structure
heuristic), grayscale crop, mini-Xception classification, 7→4 emotion map.
State is held behind a lock (the reference shares a bare module global between
the MJPEG thread and the HTTP handler — app.py:87-90).

No cv2 / webcam dependency: frames are numpy arrays from any source (the
serving layer accepts them over HTTP at ``POST /camera_frame``).
"""
from __future__ import annotations

import threading
from typing import Iterator, Optional, Tuple

import numpy as np

from melogan_torch.models.xception import FERClassifier, load_default_fer


def rgb_to_gray(frame: np.ndarray) -> np.ndarray:
    """(H, W, 3) → (H, W) luma (ITU-R BT.601, the cv2.cvtColor convention)."""
    f = np.asarray(frame, np.float32)
    if f.ndim == 2:
        return f
    return 0.299 * f[..., 0] + 0.587 * f[..., 1] + 0.114 * f[..., 2]


def heuristic_face_box(gray: np.ndarray, min_rel: float = 0.25) -> Tuple[int, int, int, int]:
    """Fallback face localizer: the highest local-variance window near the
    frame center (faces are high-contrast structures; webcams center them).
    Returns (x1, y1, x2, y2) pixels."""
    h, w = gray.shape
    size = int(min(h, w) * 0.6)
    step = max(8, size // 8)
    best, best_score = (w // 2 - size // 2, h // 2 - size // 2), -1.0
    cy, cx = h / 2, w / 2
    for y in range(0, h - size + 1, step):
        for x in range(0, w - size + 1, step):
            win = gray[y : y + size, x : x + size]
            centrality = 1.0 - (abs(y + size / 2 - cy) / h + abs(x + size / 2 - cx) / w)
            score = float(win.std()) * (0.5 + centrality)
            if score > best_score:
                best_score, best = score, (x, y)
    x, y = best
    return x, y, x + size, y + size


class CameraEmotion:
    """Stateful camera pipeline with a thread-safe current emotion."""

    def __init__(self, fer: Optional[FERClassifier] = None, face_detector=None, device="cuda"):
        # without a FER, the default weight file's on ``device`` (None when
        # there is none: every frame then reads "calm")
        self.fer = fer if fer is not None else load_default_fer(device)
        self.face_detector = face_detector  # optional SSD FaceDetector
        self._lock = threading.Lock()
        self._current = "calm"
        self._last_box: Optional[Tuple[int, int, int, int]] = None

    @property
    def current_emotion(self) -> str:
        with self._lock:
            return self._current

    @property
    def last_box(self) -> Optional[Tuple[int, int, int, int]]:
        """Face box (x1, y1, x2, y2) from the most recent frame (for the
        MJPEG overlay, reference camera/camera.py:104-106)."""
        with self._lock:
            return self._last_box

    def process_frame(self, frame: np.ndarray, conf_threshold: float = 0.5) -> str:
        """One frame → detected emotion (updates ``current_emotion``)."""
        gray = rgb_to_gray(frame)
        if self.face_detector is not None:
            det = self.face_detector.detect(
                frame if frame.ndim == 3 else np.stack([gray] * 3, -1),
                conf_threshold=conf_threshold,
            )
            if det.shape[0]:
                h, w = gray.shape
                best = det[np.argmax(det[:, 2])]
                x1, y1, x2, y2 = (
                    int(best[3] * w), int(best[4] * h), int(best[5] * w), int(best[6] * h)
                )
                x1, y1 = max(0, x1), max(0, y1)
                x2, y2 = min(w, max(x2, x1 + 8)), min(h, max(y2, y1 + 8))
            else:
                x1, y1, x2, y2 = heuristic_face_box(gray)
        else:
            x1, y1, x2, y2 = heuristic_face_box(gray)

        crop = gray[y1:y2, x1:x2]
        if self.fer is not None and crop.size:
            emotion = self.fer.predict_emotion(crop)
        else:
            emotion = "calm"
        with self._lock:
            self._current = emotion
            self._last_box = (x1, y1, x2, y2)
        return emotion

    def generate_emotions(self, frames: Iterator[np.ndarray]) -> Iterator[str]:
        """Streaming equivalent of the reference's generate_frames loop."""
        for frame in frames:
            yield self.process_frame(frame)
