"""MJPEG video feed: pluggable frame source → annotate → multipart stream.

The port's copy of ``melogan_tpu/serving/video.py``; the camera pipeline
it drives is the port's (``camera.py``).

Reference behavior (camera/camera.py:70-125 + app.py:82-85): a webcam loop
that detects the best face box, classifies the crop's emotion, annotates the
frame (rectangle + label), updates the shared current-emotion state, and
yields ``multipart/x-mixed-replace`` JPEG parts.

Here the frame SOURCE is pluggable (this deployment has no webcam): anything
iterable over (H, W, 3) uint8 RGB frames works — a capture device wrapper, a
file reader, or the built-in :class:`SyntheticFrameSource` used by tests and
demos. JPEG encoding is the framework's own baseline encoder
(``melogan_torch.imaging.jpeg``), annotation its own raster ops — no OpenCV.
"""
from __future__ import annotations

import time
from typing import Iterable, Iterator, Optional

import numpy as np

from melogan_torch.imaging import draw_rect, draw_text, encode_jpeg

BOUNDARY = "frame"


class SyntheticFrameSource:
    """Deterministic synthetic webcam: a drifting bright face-like blob on a
    gradient background (enough structure for the heuristic face localizer)."""

    def __init__(self, width: int = 320, height: int = 240, n_frames: Optional[int] = None):
        self.width, self.height, self.n_frames = width, height, n_frames

    def __iter__(self) -> Iterator[np.ndarray]:
        w, h = self.width, self.height
        yy, xx = np.mgrid[0:h, 0:w]
        base = (32 + 64 * xx / w + 32 * yy / h).astype(np.float32)
        i = 0
        while self.n_frames is None or i < self.n_frames:
            cx = w // 2 + int(0.15 * w * np.sin(i / 7.0))
            cy = h // 2 + int(0.10 * h * np.cos(i / 11.0))
            r2 = (xx - cx) ** 2 + (yy - cy) ** 2
            blob = 170.0 * np.exp(-r2 / (2 * (min(h, w) * 0.18) ** 2))
            # high-frequency texture inside the blob (face-like contrast)
            tex = 25.0 * np.sin(xx / 3.0) * np.sin(yy / 4.0) * (blob > 40)
            gray = np.clip(base + blob + tex, 0, 255)
            yield np.stack([gray, gray * 0.95, gray * 0.9], axis=-1).astype(np.uint8)
            i += 1


def annotate_frame(frame: np.ndarray, box, emotion: str) -> np.ndarray:
    """Reference-style overlay: green face box + emotion label above it
    (camera/camera.py:104-110)."""
    out = np.ascontiguousarray(frame)
    x1, y1, x2, y2 = (int(v) for v in box)
    draw_rect(out, x1, y1, x2, y2, color=(0, 230, 0), thickness=2)
    draw_text(out, emotion, x1, max(0, y1 - 18), color=(0, 230, 0), scale=2)
    return out


def mjpeg_parts(
    frames: Iterable[np.ndarray],
    camera,
    on_emotion=None,
    quality: int = 80,
    max_fps: Optional[float] = None,
) -> Iterator[bytes]:
    """Frames → annotated multipart/x-mixed-replace JPEG parts.

    ``camera`` is a :class:`melogan_torch.camera.CameraEmotion` (or None for a
    raw passthrough stream); ``on_emotion`` receives each detected emotion
    (the serving layer uses it to update the shared camera-emotion state).
    """
    from melogan_torch.camera import heuristic_face_box, rgb_to_gray

    min_dt = 1.0 / max_fps if max_fps else 0.0
    last = 0.0
    for frame in frames:
        if min_dt:
            now = time.monotonic()
            wait = min_dt - (now - last)
            if wait > 0:
                time.sleep(wait)
            last = time.monotonic()
        if camera is not None:
            emotion = camera.process_frame(frame)
            box = camera.last_box
            if box is None:
                box = heuristic_face_box(rgb_to_gray(frame))
            frame = annotate_frame(frame, box, emotion)
            if on_emotion is not None:
                on_emotion(emotion)
        data = encode_jpeg(frame, quality=quality)
        yield (
            b"--" + BOUNDARY.encode() + b"\r\n"
            b"Content-Type: image/jpeg\r\n"
            b"Content-Length: " + str(len(data)).encode() + b"\r\n\r\n"
            + data + b"\r\n"
        )
