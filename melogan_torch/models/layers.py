"""Building blocks the generation slice uses, in PyTorch idiom.

Ports of ``melogan_tpu/models/layers.py`` where the port needs its own code:
the GAN init, ``trim_or_pad_length`` and the precision switch. BatchNorm,
LayerNorm and exact-erf GELU are native ``nn.BatchNorm1d``, ``nn.LayerNorm``
and ``nn.GELU()``: the JAX layers copy their semantics. Layout at the model's
convolutions is (B, L, C), channels last, as in the JAX package.
"""
from __future__ import annotations

import threading

import torch
from torch import nn
import torch.nn.functional as F

PRECISIONS = ("f32", "fast")

# per-thread, as in the JAX package: a server thread's switch must not flip
# another thread's forward mid-run
_PRECISION_TLS = threading.local()


def set_default_precision(precision: str) -> None:
    """``"f32"`` (IEEE float32 everywhere, the default) or ``"fast"`` (lower
    precision allowed; the fused decoder kernel is f32 by construction, so the
    decoder then takes the layered path)."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, got {precision!r}")
    _PRECISION_TLS.value = precision


def default_precision() -> str:
    return getattr(_PRECISION_TLS, "value", "f32")


def gan_init_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """The reference's ``weights_init`` on every Linear and ConvTranspose1d
    below ``module``: N(0, 0.02) weights, zero biases. Norm layers keep their
    torch defaults (scale 1, bias 0)."""
    for m in module.modules():
        if isinstance(m, (nn.Linear, nn.ConvTranspose1d)):
            with torch.no_grad():
                m.weight.copy_(torch.randn(m.weight.shape, generator=generator) * 0.02)
                if m.bias is not None:
                    m.bias.zero_()
    return module


def batch_norm_lc(bn: nn.BatchNorm1d, x: torch.Tensor) -> torch.Tensor:
    """``bn`` over a channels-last (B, L, C) tensor: statistics over B and L,
    running stats updated in train mode exactly as over (B, C, L)."""
    b, l, c = x.shape
    return bn(x.reshape(b * l, c)).reshape(b, l, c)


def trim_or_pad_length(x: torch.Tensor, target_len: int) -> torch.Tensor:
    """Trim or zero-pad the length axis of (B, L, C) to ``target_len``."""
    cur = x.shape[-2]
    if cur > target_len:
        return x[..., :target_len, :]
    if cur < target_len:
        return F.pad(x, (0, 0, 0, target_len - cur))
    return x
