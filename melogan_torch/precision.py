"""The precision switch of the port: per thread, ``"f32"`` or ``"fast"``.

The counterpart of the JAX package's ``models/layers.py`` precision
(``Precision.HIGHEST`` by default, ``Precision.DEFAULT`` for ``--fast-math``
and ``--bf16``). ``"f32"`` is IEEE float32 everywhere. ``"fast"`` is the
TPU's one bf16 pass: every operand of every conv, transposed conv and
Linear product, forward and backward, is rounded to bf16 with
round-to-nearest-even, the products are exact and summed in f32, and
everything else (parameters, activations at rest, norms, losses, gradients,
optimizers) stays f32. Not TF32, which keeps 10 mantissa bits and would be
more precise than the reference's fast path.

The switch is per thread, as in the JAX package: a server thread's switch
must not flip another thread's forward mid-run. Layers and the conv
Functions read it when they run (``models/layers.py``, ``ops/conv.py``).
"""
from __future__ import annotations

import contextlib
import threading

import torch

PRECISIONS = ("f32", "fast")

_TLS = threading.local()


def set_default_precision(precision: str) -> None:
    """``"f32"`` (IEEE float32 everywhere, the default) or ``"fast"`` (the
    one-pass bf16 products; the fused decoder kernel is f32 by
    construction, so the decoder then takes the layered path)."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, got {precision!r}")
    _TLS.value = precision


def default_precision() -> str:
    return getattr(_TLS, "value", "f32")


@contextlib.contextmanager
def using(precision: str):
    """This thread's precision set to ``precision`` inside the block, and
    the one before restored after it, also when the block raises."""
    prev = default_precision()
    set_default_precision(precision)
    try:
        yield
    finally:
        set_default_precision(prev)


def bf16_products() -> bool:
    """Whether this thread's products take bf16-rounded operands."""
    return default_precision() == "fast"


def mode_of(precision) -> str:
    """A trainer's ``precision`` argument as a switch value: None or
    ``"highest"`` → ``"f32"``; ``"bf16"`` or ``"default"`` → ``"fast"``
    (``jit_with_precision``'s names); anything else raises ValueError."""
    if precision in (None, "highest"):
        return "f32"
    if precision in ("bf16", "default"):
        return "fast"
    raise ValueError(f"precision must be None, 'highest', 'bf16' or 'default'; got {precision!r}")


def round_bf16(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to bf16 (round to nearest even) and back to its dtype."""
    return t.to(torch.bfloat16).to(t.dtype)
