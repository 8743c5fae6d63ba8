"""Baseline JPEG (JFIF) encoder, from scratch on numpy.

The port's copy of ``melogan_tpu/imaging/jpeg.py`` (numpy and pure Python);
its bytes equal the original's.

Replaces the reference's ``cv2.imencode('.jpg', frame)`` in the MJPEG camera
stream (reference camera/camera.py:117-121) without an OpenCV dependency.

Implementation: ITU-T T.81 baseline sequential DCT, 4:4:4 sampling, the
Annex K quantization and Huffman tables with libjpeg-style quality scaling.
The DCT/quantization/zigzag stages are vectorized over all 8×8 blocks; only
the entropy coder walks blocks in Python (a few thousand blocks per frame —
fine for a preview stream). Output decodes with any standard JPEG decoder
(validated against PIL in tests).
"""
from __future__ import annotations

import numpy as np

# --- Annex K tables ---------------------------------------------------------

_Q_LUMA = np.array([
    [16, 11, 10, 16, 24, 40, 51, 61],
    [12, 12, 14, 19, 26, 58, 60, 55],
    [14, 13, 16, 24, 40, 57, 69, 56],
    [14, 17, 22, 29, 51, 87, 80, 62],
    [18, 22, 37, 56, 68, 109, 103, 77],
    [24, 35, 55, 64, 81, 104, 113, 92],
    [49, 64, 78, 87, 103, 121, 120, 101],
    [72, 92, 95, 98, 112, 100, 103, 99],
], np.float64)

_Q_CHROMA = np.array([
    [17, 18, 24, 47, 99, 99, 99, 99],
    [18, 21, 26, 66, 99, 99, 99, 99],
    [24, 26, 56, 99, 99, 99, 99, 99],
    [47, 66, 99, 99, 99, 99, 99, 99],
    [99, 99, 99, 99, 99, 99, 99, 99],
    [99, 99, 99, 99, 99, 99, 99, 99],
    [99, 99, 99, 99, 99, 99, 99, 99],
    [99, 99, 99, 99, 99, 99, 99, 99],
], np.float64)

_DC_LUMA_BITS = [0, 0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0]
_DC_LUMA_VALS = list(range(12))
_DC_CHROMA_BITS = [0, 0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0]
_DC_CHROMA_VALS = list(range(12))

_AC_LUMA_BITS = [0, 0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D]
_AC_LUMA_VALS = [
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06,
    0x13, 0x51, 0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xA1, 0x08,
    0x23, 0x42, 0xB1, 0xC1, 0x15, 0x52, 0xD1, 0xF0, 0x24, 0x33, 0x62, 0x72,
    0x82, 0x09, 0x0A, 0x16, 0x17, 0x18, 0x19, 0x1A, 0x25, 0x26, 0x27, 0x28,
    0x29, 0x2A, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3A, 0x43, 0x44, 0x45,
    0x46, 0x47, 0x48, 0x49, 0x4A, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59,
    0x5A, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6A, 0x73, 0x74, 0x75,
    0x76, 0x77, 0x78, 0x79, 0x7A, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8A, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9A, 0xA2, 0xA3,
    0xA4, 0xA5, 0xA6, 0xA7, 0xA8, 0xA9, 0xAA, 0xB2, 0xB3, 0xB4, 0xB5, 0xB6,
    0xB7, 0xB8, 0xB9, 0xBA, 0xC2, 0xC3, 0xC4, 0xC5, 0xC6, 0xC7, 0xC8, 0xC9,
    0xCA, 0xD2, 0xD3, 0xD4, 0xD5, 0xD6, 0xD7, 0xD8, 0xD9, 0xDA, 0xE1, 0xE2,
    0xE3, 0xE4, 0xE5, 0xE6, 0xE7, 0xE8, 0xE9, 0xEA, 0xF1, 0xF2, 0xF3, 0xF4,
    0xF5, 0xF6, 0xF7, 0xF8, 0xF9, 0xFA,
]
_AC_CHROMA_BITS = [0, 0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77]
_AC_CHROMA_VALS = [
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41,
    0x51, 0x07, 0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91,
    0xA1, 0xB1, 0xC1, 0x09, 0x23, 0x33, 0x52, 0xF0, 0x15, 0x62, 0x72, 0xD1,
    0x0A, 0x16, 0x24, 0x34, 0xE1, 0x25, 0xF1, 0x17, 0x18, 0x19, 0x1A, 0x26,
    0x27, 0x28, 0x29, 0x2A, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3A, 0x43, 0x44,
    0x45, 0x46, 0x47, 0x48, 0x49, 0x4A, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58,
    0x59, 0x5A, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6A, 0x73, 0x74,
    0x75, 0x76, 0x77, 0x78, 0x79, 0x7A, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87,
    0x88, 0x89, 0x8A, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9A,
    0xA2, 0xA3, 0xA4, 0xA5, 0xA6, 0xA7, 0xA8, 0xA9, 0xAA, 0xB2, 0xB3, 0xB4,
    0xB5, 0xB6, 0xB7, 0xB8, 0xB9, 0xBA, 0xC2, 0xC3, 0xC4, 0xC5, 0xC6, 0xC7,
    0xC8, 0xC9, 0xCA, 0xD2, 0xD3, 0xD4, 0xD5, 0xD6, 0xD7, 0xD8, 0xD9, 0xDA,
    0xE2, 0xE3, 0xE4, 0xE5, 0xE6, 0xE7, 0xE8, 0xE9, 0xEA, 0xF2, 0xF3, 0xF4,
    0xF5, 0xF6, 0xF7, 0xF8, 0xF9, 0xFA,
]

_ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
])

# orthonormal DCT-II matrix (8×8)
_k = np.arange(8)
_DCT = np.cos((2 * _k[None, :] + 1) * _k[:, None] * np.pi / 16) * np.where(
    _k[:, None] == 0, np.sqrt(1 / 8), np.sqrt(2 / 8)
)


def _huff_table(bits, vals):
    """Canonical Huffman (code, length) per symbol from a BITS/HUFFVAL spec."""
    table = {}
    code = 0
    idx = 0
    for length in range(1, 17):
        for _ in range(bits[length]):
            table[vals[idx]] = (code, length)
            code += 1
            idx += 1
        code <<= 1
    return table

_HUFF_DC = (_huff_table(_DC_LUMA_BITS, _DC_LUMA_VALS), _huff_table(_DC_CHROMA_BITS, _DC_CHROMA_VALS))
_HUFF_AC = (_huff_table(_AC_LUMA_BITS, _AC_LUMA_VALS), _huff_table(_AC_CHROMA_BITS, _AC_CHROMA_VALS))


class _BitWriter:
    __slots__ = ("buf", "acc", "nbits")

    def __init__(self):
        self.buf = bytearray()
        self.acc = 0
        self.nbits = 0

    def write(self, code: int, length: int):
        self.acc = (self.acc << length) | (code & ((1 << length) - 1))
        self.nbits += length
        while self.nbits >= 8:
            self.nbits -= 8
            byte = (self.acc >> self.nbits) & 0xFF
            self.buf.append(byte)
            if byte == 0xFF:  # byte stuffing
                self.buf.append(0x00)
        # drop the emitted bits: otherwise acc grows into a frame-sized
        # bignum and every shift turns O(output) — quadratic total
        self.acc &= (1 << self.nbits) - 1

    def flush(self):
        if self.nbits:
            pad = 8 - self.nbits
            self.write((1 << pad) - 1, pad)  # pad with 1s


def _bit_size(v: int) -> int:
    return int(v).bit_length() if v > 0 else int(-v).bit_length()


def _quality_tables(quality: int):
    q = max(1, min(100, int(quality)))
    scale = 5000 / q if q < 50 else 200 - 2 * q
    out = []
    for tbl in (_Q_LUMA, _Q_CHROMA):
        t = np.floor((tbl * scale + 50) / 100)
        out.append(np.clip(t, 1, 255).astype(np.float64))
    return out


def _blocks(channel: np.ndarray) -> np.ndarray:
    """(H, W) → (n_blocks, 8, 8), edge-replicated to multiples of 8,
    in MCU raster order."""
    h, w = channel.shape
    ph, pw = (-h) % 8, (-w) % 8
    if ph or pw:
        channel = np.pad(channel, ((0, ph), (0, pw)), mode="edge")
    hh, ww = channel.shape
    return (
        channel.reshape(hh // 8, 8, ww // 8, 8)
        .transpose(0, 2, 1, 3)
        .reshape(-1, 8, 8)
    )


def _marker(tag: int, payload: bytes) -> bytes:
    return bytes([0xFF, tag]) + (len(payload) + 2).to_bytes(2, "big") + payload


def _dht_payload(tc_th: int, bits, vals) -> bytes:
    return bytes([tc_th]) + bytes(bits[1:17]) + bytes(vals)


def encode_jpeg(img: np.ndarray, quality: int = 80) -> bytes:
    """Encode (H, W, 3) RGB or (H, W) grayscale uint8 → baseline JFIF bytes.

    Dispatches to the native C++ twin (native/jpeg_codec.cpp, built by
    ``imaging/native.py``; it is what keeps the MJPEG stream real-time) and
    falls back to the pure numpy/Python reference implementation below;
    tests enforce output equality between the two. ``MELOGAN_NATIVE_JPEG=0`` forces Python.
    """
    img = np.asarray(img)
    if img.dtype != np.uint8:
        img = np.clip(img, 0, 255).astype(np.uint8)
    if img.ndim == 2:
        img = np.stack([img] * 3, axis=-1)

    from melogan_torch.imaging.native import encode_jpeg_native

    data = encode_jpeg_native(img, quality)
    if data is not None:
        return data
    return _encode_jpeg_py(img, quality)


def _encode_jpeg_py(img: np.ndarray, quality: int = 80) -> bytes:
    """Pure numpy/Python reference encoder."""
    h, w = img.shape[:2]
    f = img.astype(np.float64)
    r, g, b = f[..., 0], f[..., 1], f[..., 2]
    ycc = [
        0.299 * r + 0.587 * g + 0.114 * b,
        -0.168736 * r - 0.331264 * g + 0.5 * b + 128.0,
        0.5 * r - 0.418688 * g - 0.081312 * b + 128.0,
    ]

    qt_luma, qt_chroma = _quality_tables(quality)

    # vectorized DCT + quantization + zigzag per channel
    coefs = []
    for ci, ch in enumerate(ycc):
        blocks = _blocks(ch) - 128.0
        dct = np.einsum("ij,njk,lk->nil", _DCT, blocks, _DCT)
        qt = qt_luma if ci == 0 else qt_chroma
        q = np.round(dct / qt).astype(np.int32)
        coefs.append(q.reshape(-1, 64)[:, _ZIGZAG])

    # --- headers ---
    out = bytearray(b"\xff\xd8")  # SOI
    out += _marker(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
    out += _marker(
        0xDB, b"\x00" + bytes(qt_luma.astype(np.uint8).flat[_ZIGZAG])
    )
    out += _marker(
        0xDB, b"\x01" + bytes(qt_chroma.astype(np.uint8).flat[_ZIGZAG])
    )
    sof = bytes([8]) + h.to_bytes(2, "big") + w.to_bytes(2, "big") + bytes(
        [3, 1, 0x11, 0, 2, 0x11, 1, 3, 0x11, 1]
    )
    out += _marker(0xC0, sof)
    out += _marker(0xC4, _dht_payload(0x00, _DC_LUMA_BITS, _DC_LUMA_VALS))
    out += _marker(0xC4, _dht_payload(0x10, _AC_LUMA_BITS, _AC_LUMA_VALS))
    out += _marker(0xC4, _dht_payload(0x01, _DC_CHROMA_BITS, _DC_CHROMA_VALS))
    out += _marker(0xC4, _dht_payload(0x11, _AC_CHROMA_BITS, _AC_CHROMA_VALS))
    out += _marker(0xDA, bytes([3, 1, 0x00, 2, 0x11, 3, 0x11, 0, 63, 0]))

    # --- entropy-coded segment: interleaved MCUs (4:4:4 ⇒ 1 block each) ---
    writer = _BitWriter()
    prev_dc = [0, 0, 0]
    n_mcu = coefs[0].shape[0]
    for m in range(n_mcu):
        for ci in range(3):
            tid = 0 if ci == 0 else 1
            huff_dc, huff_ac = _HUFF_DC[tid], _HUFF_AC[tid]
            zz = coefs[ci][m]
            # DC
            diff = int(zz[0]) - prev_dc[ci]
            prev_dc[ci] = int(zz[0])
            size = _bit_size(diff)
            code, length = huff_dc[size]
            writer.write(code, length)
            if size:
                amp = diff if diff >= 0 else diff + (1 << size) - 1
                writer.write(amp, size)
            # AC
            nz = np.nonzero(zz[1:])[0]
            pos = 0
            for idx in nz:
                run = int(idx) - pos
                while run >= 16:
                    code, length = huff_ac[0xF0]  # ZRL
                    writer.write(code, length)
                    run -= 16
                v = int(zz[1 + idx])
                size = _bit_size(v)
                code, length = huff_ac[(run << 4) | size]
                writer.write(code, length)
                amp = v if v >= 0 else v + (1 << size) - 1
                writer.write(amp, size)
                pos = int(idx) + 1
            if pos < 63:
                code, length = huff_ac[0x00]  # EOB
                writer.write(code, length)
    writer.flush()
    out += writer.buf
    out += b"\xff\xd9"  # EOI
    return bytes(out)
