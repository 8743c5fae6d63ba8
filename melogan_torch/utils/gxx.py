"""Host libraries of the port built with ``g++`` at first use: the native
MIDI encoder (``midi/native.py``) and the native JPEG encoder
(``imaging/native.py``).

Each library lives under ``build/melogan_torch/`` of the checkout and is
rebuilt when its source is newer. A build writes a per-process temporary
file and renames it into place, so processes that build at once never
load a half-written library.
"""
from __future__ import annotations

import os
import subprocess
from pathlib import Path

CXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]


def is_stale(src: Path, lib: Path) -> bool:
    return not lib.exists() or src.stat().st_mtime > lib.stat().st_mtime


def build(src: Path, lib: Path) -> Path:
    """Compile ``src`` into ``lib`` when it is missing or older than its
    source; returns ``lib``. Raises RuntimeError with the compiler's output
    when ``g++`` is missing or fails."""
    if not is_stale(src, lib):
        return lib
    lib.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f".{lib.stem}.{os.getpid()}{lib.suffix}")
    try:
        r = subprocess.run(["g++", *CXX_FLAGS, "-o", str(tmp), str(src)],
                           capture_output=True, text=True, timeout=120)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise RuntimeError(f"g++ could not build {src}: {e}") from e
    if r.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed (rc {r.returncode}) on {src}:\n{r.stderr[-2000:]}")
    os.replace(tmp, lib)
    return lib
