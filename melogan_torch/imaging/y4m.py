"""YUV4MPEG2 (.y4m) reader/writer: real video in and out, zero dependencies.

The port's copy of ``melogan_tpu/imaging/y4m.py`` (numpy only); its bytes
and frames equal the original's.

The reference's camera loop reads a live webcam through OpenCV
(camera/camera.py:70-78). This image has no webcam and no cv2, so the
framework's `/video_feed` pipeline takes any iterable of RGB frames
(serving/video.py). This module supplies the missing "real footage" source:
YUV4MPEG2 is the standard *uncompressed* interchange format every common
tool emits (`ffmpeg -i clip.mp4 out.y4m`, mpv, gstreamer, x264's input
format), and its framing is simple enough to parse exactly — a one-line
ASCII stream header, then `FRAME\\n` + raw planar YCbCr per frame. With
this, `MELOGAN_CAMERA_SOURCE=/path/clip.y4m` runs the full
detect→classify→annotate→MJPEG pipeline over real video.

Format (see the mjpegtools YUV4MPEG2 spec):
  ``YUV4MPEG2 W<w> H<h> F<num>:<den> [It|b|p|m] [A<n>:<d>] [C<cs>] [X...]\\n``
  then per frame: ``FRAME[ <params>]\\n`` + planes (Y, then Cb, then Cr).
Colorspaces handled: C420 (+ the jpeg/mpeg2/paldv siting variants — siting
only moves chroma sample *positions*, which nearest-neighbor upsampling
ignores), C422, C444, Cmono. Values are BT.601 limited-range, the Y4M
convention.
"""
from __future__ import annotations

import os
from typing import BinaryIO, Iterable, Iterator, Tuple

import numpy as np


class Y4MError(ValueError):
    """Malformed .y4m stream (bad magic, missing geometry, truncated frame)."""


# BT.601 limited-range matrices (the Y4M convention; full-range would need
# XCOLORRANGE=FULL, which is rare and ignored by most tools).
_KR, _KG, _KB = 0.299, 0.587, 0.114


def _ycbcr_to_rgb(y: np.ndarray, cb: np.ndarray, cr: np.ndarray) -> np.ndarray:
    yf = (y.astype(np.float32) - 16.0) * (255.0 / 219.0)
    cbf = (cb.astype(np.float32) - 128.0) * (255.0 / 224.0)
    crf = (cr.astype(np.float32) - 128.0) * (255.0 / 224.0)
    r = yf + 1.402 * crf
    g = yf - (1.402 * _KR / _KG) * crf - (1.772 * _KB / _KG) * cbf
    b = yf + 1.772 * cbf
    return np.clip(np.stack([r, g, b], axis=-1), 0.0, 255.0).round().astype(np.uint8)


def _rgb_to_ycbcr(rgb: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    f = rgb.astype(np.float32)
    y = _KR * f[..., 0] + _KG * f[..., 1] + _KB * f[..., 2]
    cb = (f[..., 2] - y) / 1.772
    cr = (f[..., 0] - y) / 1.402
    y = np.clip(16.0 + y * (219.0 / 255.0), 16, 235).round().astype(np.uint8)
    cb = np.clip(128.0 + cb * (224.0 / 255.0), 16, 240).round().astype(np.uint8)
    cr = np.clip(128.0 + cr * (224.0 / 255.0), 16, 240).round().astype(np.uint8)
    return y, cb, cr


def _read_line(f: BinaryIO, what: str, limit: int = 4096) -> bytes:
    """Read up to ``\\n`` (excluded) without over-reading past it."""
    buf = bytearray()
    while True:
        c = f.read(1)
        if not c:
            raise Y4MError(f"truncated {what} (EOF before newline)")
        if c == b"\n":
            return bytes(buf)
        buf += c
        if len(buf) > limit:
            raise Y4MError(f"{what} exceeds {limit} bytes — not a y4m stream?")


def _parse_header(line: bytes) -> dict:
    parts = line.split(b" ")
    if parts[0] != b"YUV4MPEG2":
        raise Y4MError(f"bad magic {parts[0][:20]!r} (want b'YUV4MPEG2')")
    hdr = {"W": None, "H": None, "F": (30, 1), "C": "420"}
    for tag in parts[1:]:
        if not tag:
            continue
        key, val = chr(tag[0]), tag[1:].decode("ascii", "replace")
        if key in ("W", "H"):
            try:
                hdr[key] = int(val)
            except ValueError as e:
                raise Y4MError(f"bad {key} tag {val!r}") from e
        elif key == "F":
            try:
                num, den = val.split(":")
                hdr["F"] = (int(num), int(den))
            except ValueError as e:
                raise Y4MError(f"bad frame-rate tag {val!r}") from e
            if hdr["F"][0] <= 0 or hdr["F"][1] <= 0:
                raise Y4MError(f"non-positive frame rate {val!r}")
        elif key == "C":
            hdr["C"] = val
    if not hdr["W"] or not hdr["H"] or hdr["W"] <= 0 or hdr["H"] <= 0:
        raise Y4MError(f"missing/invalid geometry in header {line[:80]!r}")
    return hdr


# exact-match sets: prefix matching would silently accept high-bit-depth /
# alpha variants (C420p10, C422p12, C444alpha — 2 bytes/sample or 4 planes)
# as 8-bit 3-plane and decode garbage; unknown tags must fail fast at
# construction time, not as a misleading 'bad frame marker' mid-stream
_CS_420 = {"420", "420jpeg", "420mpeg2", "420paldv"}
_CS_422 = {"422"}
_CS_444 = {"444"}
_CS_MONO = {"mono"}


def _plane_geometry(cs: str, w: int, h: int):
    """(chroma_w, chroma_h) or None for mono; raises on unsupported."""
    if cs in _CS_420:
        if w % 2 or h % 2:
            raise Y4MError(f"C420 needs even dimensions, got {w}x{h}")
        return (w // 2, h // 2)
    if cs in _CS_422:
        if w % 2:
            raise Y4MError(f"C422 needs even width, got {w}")
        return (w // 2, h)
    if cs in _CS_444:
        return (w, h)
    if cs in _CS_MONO:
        return None
    raise Y4MError(f"unsupported colorspace C{cs!r} "
                   f"(8-bit {sorted(_CS_420 | _CS_422 | _CS_444 | _CS_MONO)} only)")


def _read_exact(f: BinaryIO, n: int, what: str) -> bytes:
    data = f.read(n)
    if len(data) != n:
        raise Y4MError(f"truncated {what}: wanted {n} bytes, got {len(data)}")
    return data


def read_y4m(f: BinaryIO) -> Tuple[dict, Iterator[np.ndarray]]:
    """Parse a YUV4MPEG2 stream → (header dict, iterator of RGB uint8 frames).

    The header dict has ``W``/``H`` (int), ``F`` ((num, den) frame rate) and
    ``C`` (colorspace string). Frames decode to (H, W, 3) uint8 RGB via
    BT.601 limited-range; chroma is upsampled nearest-neighbor. Raises
    :class:`Y4MError` on malformed input — a truncated final frame fails
    typed, it does not yield garbage."""
    hdr = _parse_header(_read_line(f, "stream header"))
    w, h = hdr["W"], hdr["H"]
    chroma = _plane_geometry(hdr["C"], w, h)

    def frames() -> Iterator[np.ndarray]:
        while True:
            first = f.read(1)
            if not first:
                return  # clean EOF at a frame boundary
            marker = first + _read_exact(f, 4, "frame marker")
            if marker != b"FRAME":
                raise Y4MError(f"bad frame marker {marker!r}")
            rest = _read_line(f, "frame header")  # optional per-frame params
            del rest
            y = np.frombuffer(_read_exact(f, w * h, "Y plane"), np.uint8).reshape(h, w)
            if chroma is None:
                yield _ycbcr_to_rgb(y, np.full((h, w), 128, np.uint8),
                                    np.full((h, w), 128, np.uint8))
                continue
            cw, ch = chroma
            cb = np.frombuffer(_read_exact(f, cw * ch, "Cb plane"), np.uint8).reshape(ch, cw)
            cr = np.frombuffer(_read_exact(f, cw * ch, "Cr plane"), np.uint8).reshape(ch, cw)
            cb = cb.repeat(h // ch, axis=0).repeat(w // cw, axis=1)
            cr = cr.repeat(h // ch, axis=0).repeat(w // cw, axis=1)
            yield _ycbcr_to_rgb(y, cb, cr)

    return hdr, frames()


def write_y4m(
    f: BinaryIO,
    frames: Iterable[np.ndarray],
    rate: Tuple[int, int] = (30, 1),
    colorspace: str = "444",
) -> int:
    """Write RGB uint8 frames as YUV4MPEG2; returns the frame count.

    ``colorspace``: "444" (no chroma loss beyond the BT.601 round trip — the
    round-trip test bound) or "420" (2x2-mean subsampled, what most tools
    default to). Geometry is taken from the first frame; all frames must
    match it."""
    if colorspace not in ("444", "420"):
        raise ValueError(f"colorspace must be '444' or '420', got {colorspace!r}")
    it = iter(frames)
    try:
        first = next(it)
    except StopIteration:
        raise ValueError("write_y4m needs at least one frame") from None
    h, w = first.shape[:2]
    if colorspace == "420" and (w % 2 or h % 2):
        raise ValueError(f"C420 needs even dimensions, got {w}x{h}")
    f.write(b"YUV4MPEG2 W%d H%d F%d:%d Ip A1:1 C%s\n"
            % (w, h, rate[0], rate[1], colorspace.encode()))
    count = 0

    def emit(frame: np.ndarray) -> None:
        if frame.shape[:2] != (h, w):
            raise ValueError(f"frame {count} is {frame.shape[:2]}, stream is {(h, w)}")
        y, cb, cr = _rgb_to_ycbcr(np.asarray(frame, np.uint8))
        if colorspace == "420":
            cb = cb.reshape(h // 2, 2, w // 2, 2).mean(axis=(1, 3)).round().astype(np.uint8)
            cr = cr.reshape(h // 2, 2, w // 2, 2).mean(axis=(1, 3)).round().astype(np.uint8)
        f.write(b"FRAME\n")
        f.write(y.tobytes())
        f.write(cb.tobytes())
        f.write(cr.tobytes())

    emit(first)
    count += 1
    for frame in it:
        emit(frame)
        count += 1
    return count


class Y4MFrameSource:
    """Re-iterable frame source over a .y4m file for the MJPEG pipeline.

    Each ``iter()`` re-opens the file (the serving layer starts one iteration
    per `/video_feed` connection, possibly concurrent — independent file
    handles keep them isolated). ``loop=True`` restarts at EOF so a short
    clip behaves like a webcam that never runs dry. The file's stream header
    is validated eagerly at construction so `melogan serve` fails fast on a
    bad path, not on the first viewer."""

    def __init__(self, path: str, loop: bool = True):
        self.path, self.loop = os.fspath(path), bool(loop)
        with open(self.path, "rb") as f:
            self.header = _parse_header(_read_line(f, "stream header"))
        self.width, self.height = self.header["W"], self.header["H"]
        self.rate = self.header["F"]

    def __iter__(self) -> Iterator[np.ndarray]:
        while True:
            with open(self.path, "rb") as f:
                _, frames = read_y4m(f)
                n = 0
                for frame in frames:
                    yield frame
                    n += 1
            if not self.loop:
                return
            if n == 0:
                raise Y4MError(f"{self.path} contains no frames")
