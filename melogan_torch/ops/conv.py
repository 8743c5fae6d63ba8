"""Conv front end: ``conv1d`` and ``conv_transpose1d`` over (B, L, C) inputs
and HIO weights, differentiable on both devices.

The port of ``melogan_tpu/ops/conv.py``. Where the tensor lies decides the
path, and nothing else does: a CUDA tensor goes to the hand-written kernel
(``ops/conv1d.py::conv1d_cuda``, ``ops/convt.py::convt1d_cuda``), a CPU tensor
to the kernel's plain PyTorch version, and any other device raises. There is
no mode switch and no fallback.

Each op is one ``torch.autograd.Function``. Its backward is exact, and each
conv's input gradient is the other conv, so on the card both directions run
the port's own kernels:

- conv1d: dx = conv_transpose1d(g, wᵀ) with the same stride and padding and
  output_padding = (L + 2p − K) mod s; dw[k] = Σ x_pad[s·t + k]ᵀ · g[t].
- conv_transpose1d: dx = conv1d(g, wᵀ) with the same stride and padding;
  dw[k] = Σ x[i]ᵀ · g_pad[s·i + k].

wᵀ is w with Cin and Cout swapped, (K, Cout, Cin). The dw products are
``torch.matmul``s (the JAX package leaves both gradients to XLA convs outside
any Pallas kernel). The backward is first-order only: the WGAN-GP critic,
whose gradient penalty needs a second derivative, does not use these ops.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch.autograd.function import once_differentiable

from melogan_torch.ops.conv1d import conv1d_cuda, conv1d_plain
from melogan_torch.ops.convt import convt1d_cuda, convt1d_plain


def _check_device(x: torch.Tensor, op: str) -> None:
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"{op}: unsupported device {x.device}")


def _conv1d_forward(x, w, bias, stride, padding):
    if x.device.type == "cuda":
        return conv1d_cuda(x, w, bias, stride, padding)
    return conv1d_plain(x, w, bias, stride, padding)


def _convt_forward(x, w, bias, stride, padding, output_padding):
    if x.device.type == "cuda":
        return convt1d_cuda(x, w, bias, stride, padding, output_padding)
    return convt1d_plain(x, w, bias, stride, padding, output_padding)


def _swap_io(w: torch.Tensor) -> torch.Tensor:
    """(K, Cin, Cout) → (K, Cout, Cin)."""
    return w.transpose(1, 2).contiguous()


def _tap_products(inp, g, k: int, stride: int, padding: int):
    """(K, C_inp, C_g) with [k] = Σ_{b,t} inp_pad[b, s·t + k]ᵀ · g[b, t], where
    inp_pad is ``inp`` with ``padding`` zero rows in front (and enough
    behind): the weight gradient of conv1d(inp) → g, one matmul per tap."""
    b, l, c = inp.shape
    t = g.shape[1]
    span = stride * (t - 1) + 1
    xp = torch.nn.functional.pad(inp, (0, 0, padding, max(0, span + k - 1 - l - padding)))
    g2 = g.reshape(b * t, g.shape[2])
    return torch.stack([
        xp[:, kk: kk + span: stride].reshape(b * t, c).transpose(0, 1) @ g2
        for kk in range(k)
    ])


class _Conv1d(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, bias, stride, padding):
        x, w = x.contiguous(), w.contiguous()
        ctx.save_for_backward(x, w)
        ctx.geometry = (stride, padding)
        return _conv1d_forward(x, w, bias, stride, padding)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        stride, padding = ctx.geometry
        g = g.contiguous()
        k = w.shape[0]
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            output_padding = (x.shape[1] + 2 * padding - k) % stride
            dx = _convt_forward(g, _swap_io(w), None, stride, padding, output_padding)
        if ctx.needs_input_grad[1]:
            dw = _tap_products(x, g, k, stride, padding)
        if ctx.needs_input_grad[2]:
            db = g.sum(dim=(0, 1))
        return dx, dw, db, None, None


class _ConvTranspose1d(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, bias, stride, padding, output_padding):
        x, w = x.contiguous(), w.contiguous()
        ctx.save_for_backward(x, w)
        ctx.geometry = (stride, padding)
        return _convt_forward(x, w, bias, stride, padding, output_padding)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        stride, padding = ctx.geometry
        g = g.contiguous()
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            dx = _conv1d_forward(g, _swap_io(w), None, stride, padding)
        if ctx.needs_input_grad[1]:
            dw = _tap_products(g, x, w.shape[0], stride, padding).transpose(1, 2)
        if ctx.needs_input_grad[2]:
            db = g.sum(dim=(0, 1))
        return dx, dw, db, None, None, None


def conv1d(
    x: torch.Tensor,
    w_hio: torch.Tensor,
    stride: int = 1,
    padding: int = 0,
    bias: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """(B, L, Cin) ⊛ (K, Cin, Cout) [+ bias] → (B, Lout, Cout), torch Conv1d
    geometry."""
    _check_device(x, "conv1d")
    return _Conv1d.apply(x, w_hio, bias, stride, padding)


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
    _check_device(x, "conv_transpose1d")
    return _ConvTranspose1d.apply(x, w_hio, bias, stride, padding, output_padding)
