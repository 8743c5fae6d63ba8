"""Atomic file writes (temp file + ``os.replace``).

The port's copy of ``melogan_tpu/utils/atomic.py``. Checkpoints and
``gan_final`` files are written this way, so that a reader (a server
loading a checkpoint, a resumed run) sees either the old file or the whole
new one, never a partial write.
"""
from __future__ import annotations

import os
import tempfile
from typing import Callable


def atomic_write(path: str, write_fn: Callable, mode: str = "w", **open_kw) -> str:
    """Call ``write_fn(file_object)`` on a temp file in ``path``'s directory,
    then ``os.replace`` it into place. The temp file is removed on any
    failure, and the old file, if any, stays as it was."""
    dirname = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(dirname, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=dirname, suffix=".tmp")
    try:
        with os.fdopen(fd, mode, **open_kw) as f:
            write_fn(f)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return path
