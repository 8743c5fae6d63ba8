"""Building blocks of the port's models, in PyTorch idiom.

Ports of ``melogan_tpu/models/layers.py`` where the port needs its own code:
the GAN init, the torch-default init drawn from a ``torch.Generator``,
``Conv1d`` and ``ConvTranspose1d`` over channels-last inputs, ``Dropout``
with explicit randomness,
``trim_or_pad_length``, ``adaptive_avg_pool_1`` and the precision switch.
BatchNorm, LayerNorm, exact-erf GELU and LeakyReLU(0.2) are native
``nn.BatchNorm1d``, ``nn.LayerNorm``, ``nn.GELU()`` and ``nn.LeakyReLU``:
the JAX layers copy their semantics. Layout at the model's convolutions is
(B, L, C), channels last, as in the JAX package.
"""
from __future__ import annotations

import math
import threading
from typing import Optional

import torch
from torch import nn
import torch.nn.functional as F

from melogan_torch.ops.conv import conv1d, conv_transpose1d

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
    """The reference's ``weights_init`` on every Linear, Conv1d and
    ConvTranspose1d below ``module``: N(0, 0.02) weights, zero biases. Norm
    layers keep their torch defaults (scale 1, bias 0)."""
    for m in module.modules():
        if isinstance(m, (nn.Linear, nn.Conv1d, nn.ConvTranspose1d)):
            with torch.no_grad():
                m.weight.copy_(torch.randn(m.weight.shape, generator=generator) * 0.02)
                if m.bias is not None:
                    m.bias.zero_()
    return module


def torch_default_init_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """torch's own Linear/Conv1d/ConvTranspose1d init, U(±1/√fan_in) for
    weights and biases (kaiming_uniform with a=√5; fan_in is Cout·K for a
    transposed conv's (Cin, Cout, K) weight), drawn from ``generator``
    rather than the global RNG. The ED's and the VAE's layers start this
    way (``torch_kaiming_uniform`` of the JAX package)."""
    for m in module.modules():
        if isinstance(m, (nn.Linear, nn.Conv1d, nn.ConvTranspose1d)):
            fan_in = m.weight[0].numel()
            bound = 1.0 / math.sqrt(fan_in) if fan_in > 0 else 0.0
            with torch.no_grad():
                for p in (m.weight, m.bias):
                    if p is not None:
                        p.copy_((torch.rand(p.shape, generator=generator) * 2 - 1) * bound)
    return module


def adaptive_avg_pool_1(x: torch.Tensor) -> torch.Tensor:
    """AdaptiveAvgPool1d(1) over (B, L, C): mean over the length axis."""
    return x.mean(dim=-2)


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


class Conv1d(nn.Conv1d):
    """1-D convolution over (B, L, C) with torch Conv1d geometry and the
    torch ``(Cout, Cin, K)`` weight, so reference state dicts load strictly.

    By default it computes through ``ops.conv.conv1d`` (the hand-written
    kernel on the card, its plain version on the CPU, both differentiable
    once). ``native=True`` pins it to ``F.conv1d`` with cuDNN in IEEE f32
    (TF32 off): the counterpart of the JAX layer's ``pallas=False``, for the
    WGAN-GP critic, whose gradient penalty needs a second derivative.
    """

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, padding: int = 0, bias: bool = True, native: bool = False):
        super().__init__(in_channels, out_channels, kernel_size, stride=stride,
                         padding=padding, bias=bias)
        self.native = native

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s, p = self.stride[0], self.padding[0]
        if self.native:
            with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
                y = F.conv1d(x.transpose(1, 2), self.weight, self.bias, s, p)
            return y.transpose(1, 2)
        return conv1d(x, self.weight.permute(2, 1, 0), s, p, bias=self.bias)


class ConvTranspose1d(nn.ConvTranspose1d):
    """Transposed 1-D convolution over (B, L, C) with torch ConvTranspose1d
    geometry and the torch ``(Cin, Cout, K)`` weight, so reference state
    dicts load strictly. It always computes through
    ``ops.conv.conv_transpose1d``: the hand-written kernel on the card, its
    plain version on the CPU, both differentiable once."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv_transpose1d(x, self.weight.permute(2, 0, 1), self.stride[0], self.padding[0],
                                self.output_padding[0], bias=self.bias)


class Dropout(nn.Module):
    """Inverted dropout whose randomness is explicit: in train mode it takes
    a boolean keep ``mask`` of x's shape, or draws one from ``generator``;
    it never touches the global RNG, and raises when given neither. Identity
    in eval mode or at rate 0."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = float(rate)

    def draw_mask(self, shape, generator: torch.Generator, device) -> torch.Tensor:
        return torch.rand(shape, generator=generator, device=device) < 1.0 - self.rate

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        if mask is None:
            if generator is None:
                raise ValueError("Dropout in train mode needs a mask or a torch.Generator")
            mask = self.draw_mask(x.shape, generator, x.device)
        return torch.where(mask, x / (1.0 - self.rate), torch.zeros_like(x))

    def extra_repr(self) -> str:
        return f"rate={self.rate}"
