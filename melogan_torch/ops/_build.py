"""Build and load the port's CUDA kernels (``melogan_torch/csrc/*.cu``).

Each source compiles with ``nvcc`` for Hopper (``sm_90a``) into its own shared
library with a plain C interface under ``build/melogan_torch/`` of the
checkout, at first use, and loads with ``ctypes``. A library is rebuilt when
its source, or any header ``csrc/*.cuh`` (the shared implicit-GEMM core), is
newer. :func:`build_all` compiles every stale source at once,
one ``nvcc`` process each, started together.

Nothing here runs at import: the CPU tests import every module of the port,
and a machine without ``nvcc`` only fails when a kernel is asked for.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, List, Optional

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "melogan_torch"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas=-v",  # registers, shared memory and spills go to <name>.log
]

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()
_COUNT_LOCK = threading.Lock()


def kernel_names() -> List[str]:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def library_path(name: str) -> Path:
    return BUILD_DIR / f"libmelogan_{name}.so"


def log_path(name: str) -> Path:
    return BUILD_DIR / f"{name}.log"


def sources(name: str) -> List[Path]:
    """What library ``name`` is built from: its ``.cu`` and every header."""
    return [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]


def is_stale(name: str) -> bool:
    lib = library_path(name)
    return not lib.exists() or max(p.stat().st_mtime for p in sources(name)) > lib.stat().st_mtime


def find_nvcc() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, ``nvcc`` on PATH, or
    ``/usr/local/cuda/bin/nvcc``; raises RuntimeError when there is none."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(on_path)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH, /usr/local/cuda/bin); "
        "the CUDA kernels of melogan_torch need the CUDA toolkit"
    )


def nvcc_command(nvcc: str, name: str, out: Path) -> List[str]:
    return [nvcc, *NVCC_FLAGS, "-o", str(out), str(CSRC / f"{name}.cu")]


def build_all(names: Optional[Iterable[str]] = None) -> Dict[str, Path]:
    """Compile every stale kernel library in parallel; returns name → path.

    Each build writes to a temporary name and is renamed into place, so a
    concurrent reader never loads a half-written library. Raises RuntimeError
    with the compiler's output when a build fails."""
    names = list(kernel_names() if names is None else names)
    stale = [n for n in names if is_stale(n)]
    if stale:
        nvcc = find_nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs = []
        for n in stale:
            tmp = BUILD_DIR / f".libmelogan_{n}.{os.getpid()}.so"
            log = open(log_path(n), "w")
            proc = subprocess.Popen(nvcc_command(nvcc, n, tmp), stdout=log,
                                    stderr=subprocess.STDOUT)
            procs.append((n, tmp, log, proc))
        failed = []
        for n, tmp, log, proc in procs:
            rc = proc.wait()
            log.close()
            if rc == 0:
                os.replace(tmp, library_path(n))
            else:
                failed.append(f"{n} (nvcc rc {rc}):\n{log_path(n).read_text()}")
        if failed:
            raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return {n: library_path(n) for n in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if stale."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            path = build_all([name])[name]
            lib = ctypes.CDLL(str(path))
            _LIBS[name] = lib
        return lib


def count_launch(wrapper) -> None:
    """Add one to ``wrapper.launches``, the plain-int launch count that shows
    a run went through the kernel (server threads launch concurrently)."""
    with _COUNT_LOCK:
        wrapper.launches += 1


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


def check_operand(kernel: str, t, name: str, dev, shape=None) -> None:
    """Raise on an operand a kernel does not take: another device, not
    float32, not contiguous, another shape, or requiring grad (a wrapper
    launches a forward kernel only; ``ops.conv`` gives the convolutions
    their backward)."""
    if t.device != dev:
        raise ValueError(f"{kernel}: {name} is on {t.device}, x on {dev}")
    if t.dtype != torch.float32:
        raise ValueError(f"{kernel}: {name} must be float32, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{kernel}: {name} must be contiguous")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{kernel}: {name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if torch.is_grad_enabled() and t.requires_grad:
        raise NotImplementedError(
            f"{kernel}: the kernel wrapper is forward-only; for gradients call "
            f"melogan_torch.ops.conv.conv1d / conv_transpose1d")
