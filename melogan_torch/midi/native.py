"""ctypes bridge to the port's native MIDI encoder (``midi_codec.cpp``
beside this file).

The port's counterpart of ``melogan_tpu/midi/native.py``. The Python writer
(``midifile.MidiSong.to_bytes(allow_native=False)``) is the reference
implementation; the native twin sorts and encodes the note events in C++,
without a Python object a note, on the serving and sampling path. Byte
equality between the two is enforced in tests.

The library is built at first use with ``g++`` into
``build/melogan_torch/libmelomidi.so`` of the checkout, never into
``native/`` (the JAX package's loader owns ``native/libmelomidi.so`` and
rebuilds it in place). Each build writes a per-process temporary file and
renames it into place, so processes that build at once never load a
half-written library; a source newer than the library rebuilds it. When the
build or the load fails, :func:`encode_song_native` returns None and the
callers use the Python writer, as in the JAX package (the reason is in
:func:`load_error`).

A song the Python writer refuses is refused here too, with its exception
and message: a note before time 0 (ROADMAP C.3, which the JAX encoder
writes as garbage), or a program, pitch or velocity outside 0-255. A
refusal never falls back to the Python writer. This is host code: the
device plays no part in it.
"""
from __future__ import annotations

import ctypes
import struct
import threading
from pathlib import Path
from typing import Optional

import numpy as np

from melogan_torch.utils import gxx

ROOT = Path(__file__).resolve().parents[2]
SRC_PATH = Path(__file__).resolve().with_name("midi_codec.cpp")
LIB_PATH = ROOT / "build" / "melogan_torch" / "libmelomidi.so"

# melomidi_write's refusal codes, and the Python writer's message for each
NEGATIVE_TICK, BYTE_RANGE = -2, -3
REFUSALS = {NEGATIVE_TICK: "events must be sorted by tick",  # smf.encode_track
            BYTE_RANGE: "bytes must be in range(0, 256)"}  # bytes([...]) of an event

_LOCK = threading.Lock()
_loaded = {"tried": False, "lib": None, "error": None}
encodes = 0  # songs the library encoded; chip_smoke.py sets it to 0 and reads it


def is_stale() -> bool:
    return gxx.is_stale(SRC_PATH, LIB_PATH)


def build() -> Path:
    """Compile ``midi_codec.cpp`` into ``LIB_PATH`` when it is missing or
    older than its source; returns the path. Raises RuntimeError with the
    compiler's output when ``g++`` is missing or fails."""
    return gxx.build(SRC_PATH, LIB_PATH)


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded encoder library, built first if stale; None when the
    build or the load failed (the reason is in :func:`load_error`). The
    first failure is kept: no rebuild is tried on every song."""
    with _LOCK:
        if not _loaded["tried"]:
            _loaded["tried"] = True
            try:
                lib = ctypes.CDLL(str(build()))
                i32, i64 = ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int64)
                lib.melomidi_write.restype = ctypes.c_int64
                lib.melomidi_write.argtypes = [
                    i32, i32, i64, i64, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
                    ctypes.c_int32, ctypes.c_int32, ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
                ]
                _loaded["lib"] = lib
            except (RuntimeError, OSError, AttributeError) as e:
                _loaded["error"] = f"{type(e).__name__}: {e}"
        return _loaded["lib"]


def load_error() -> Optional[str]:
    """Why :func:`get_lib` returned None after a build or load, if it did."""
    return _loaded["error"]


def native_available() -> bool:
    return get_lib() is not None


def _bytes_field(name: str, values) -> np.ndarray:
    """``values`` as int32 for the library. Integers outside int32 become
    -1 (outside 0-255 either way, so the library refuses them as the
    Python writer does); anything but integers raises TypeError, as
    ``bytes([...])`` does."""
    a = np.asarray(values)
    if a.size and a.dtype.kind not in "biu":
        raise TypeError(f"{name} must be integers, got {a.dtype}")
    if a.size and (a.min() < 0 or a.max() > 255):
        a = np.where((a >= 0) & (a <= 255), a, -1)
    return np.ascontiguousarray(a, np.int32)


def encode_song_native(
    pitch: np.ndarray,
    velocity: np.ndarray,
    start_tick: np.ndarray,
    end_tick: np.ndarray,
    program: int,
    channel: int,
    tempo_us: int,
    division: int,
) -> Optional[bytes]:
    """Single-instrument song → SMF bytes via the native encoder; None if
    the native library is unavailable. Raises what the Python writer raises
    for the same song: ValueError for a note before time 0 or a program,
    pitch or velocity outside 0-255, struct.error for a tempo or a division
    that does not fit its field."""
    global encodes
    lib = get_lib()
    if lib is None:
        return None
    struct.pack(">I", tempo_us)  # the Python writer's own checks, in its order
    struct.pack(">H", division)
    p, v = _bytes_field("pitch", pitch), _bytes_field("velocity", velocity)
    st = np.ascontiguousarray(start_tick, np.int64)
    en = np.ascontiguousarray(end_tick, np.int64)
    (program,) = _bytes_field("program", [program])
    n = p.shape[0]
    # each event: a varlen of at most 10 bytes and 2 data bytes (status once)
    cap = 64 + 24 * n
    out = np.empty(cap, np.uint8)
    written = lib.melomidi_write(
        p.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        v.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        st.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        en.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        n, int(program), int(channel), int(tempo_us) & 0xFFFFFF, int(division),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), cap,
    )
    if written in REFUSALS:
        raise ValueError(REFUSALS[written])
    if written < 0:
        raise RuntimeError(f"melomidi_write returned {written} for {n} notes (capacity {cap})")
    encodes += 1
    return out[:written].tobytes()
