"""Conv front end: ``conv_transpose1d`` over (B, L, C) inputs and HIO weights.

The port of ``melogan_tpu/ops/conv.py``. Where the tensor lies decides the
path, and nothing else does: a CUDA tensor goes to the hand-written kernel
(``ops/convt.py::convt1d_cuda``), a CPU tensor to the kernel's plain PyTorch
version, and any other device raises. There is no mode switch and no
fallback. ``conv1d`` comes with the ED/VAE slice.
"""
from __future__ import annotations

from typing import Optional

import torch

from melogan_torch.ops.convt import convt1d_cuda, convt1d_plain


def conv_transpose1d(
    x: torch.Tensor,
    w_hio: torch.Tensor,
    stride: int = 2,
    padding: int = 0,
    output_padding: int = 0,
    bias: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """(B, L, Cin) transposed-conv (K, Cin, Cout) [+ bias] → (B, Lout, Cout),
    torch ConvTranspose1d geometry."""
    if x.device.type == "cuda":
        return convt1d_cuda(x, w_hio, bias, stride, padding, output_padding)
    if x.device.type == "cpu":
        return convt1d_plain(x, w_hio, bias, stride, padding, output_padding)
    raise ValueError(f"conv_transpose1d: unsupported device {x.device}")
