"""Transposed 1-D convolution: the CUDA kernel ``csrc/convt1d.cu`` and its
plain PyTorch version.

Port of ``melogan_tpu/ops/pallas/conv1d.py::_convt_kernel``. Both versions
take the JAX package's layout: x (B, L, Cin), weight HIO (K, Cin, Cout), with
torch ConvTranspose1d geometry, Lout = (L-1)·stride − 2·padding + K +
output_padding. The front end ``ops/conv.py::conv_transpose1d`` picks one by
the tensor's device.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from melogan_torch.ops import _build
from melogan_torch.ops.igemm import check_limits, convt_plan, convt_taps


def convt_out_len(l: int, k: int, stride: int, padding: int, output_padding: int) -> int:
    return (l - 1) * stride - 2 * padding + k + output_padding


def convt1d_plain(x, w, bias=None, stride: int = 2, padding: int = 0,
                  output_padding: int = 0):
    """The tap sum written out: for each parity class r, Σ over
    ``convt_taps`` of a contiguous shifted slice of x times one tap of the
    flipped weight, then the classes interleaved. f32 matmuls."""
    b, l, cin = x.shape
    k, _, cout = w.shape
    lout = convt_out_len(l, k, stride, padding, output_padding)
    lmax = -(-lout // stride)
    taps = [convt_taps(k, stride, padding, r) for r in range(stride)]
    offs = [off for tr in taps for _, off in tr]
    pad_lo = max(0, -min(offs))
    pad_hi = max(0, max(offs) + lmax - l)
    xp = torch.nn.functional.pad(x, (0, 0, pad_lo, pad_hi))
    wf = torch.flip(w, dims=(0,))
    classes = []
    for r in range(stride):
        acc = x.new_zeros((b, lmax, cout))
        for j, off in taps[r]:
            acc = acc + xp[:, off + pad_lo: off + pad_lo + lmax] @ wf[j]
        classes.append(acc)
    out = torch.stack(classes, dim=2).reshape(b, stride * lmax, cout)[:, :lout]
    if bias is not None:
        out = out + bias
    return out


def convt_flops(b: int, l: int, cin: int, cout: int, k: int, stride: int,
                padding: int, output_padding: int) -> int:
    """Floating-point operations of the valid taps only (2 per MAC)."""
    lout = convt_out_len(l, k, stride, padding, output_padding)
    macs = 0
    for t in range(lout):
        for kk in range(k):
            num = t + padding - kk
            if num >= 0 and num % stride == 0 and num // stride < l:
                macs += 1
    return 2 * b * macs * cin * cout


def _lib():
    lib = _build.load("convt1d")
    if not getattr(lib, "_melogan_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.melogan_convt1d.argtypes = [p, p, p, p, p, i, p]
        lib.melogan_convt1d.restype = ctypes.c_int
        lib._melogan_typed = True
    return lib


def convt1d_cuda(x, w, bias: Optional[torch.Tensor] = None, stride: int = 2,
                 padding: int = 0, output_padding: int = 0):
    """Launch ``csrc/convt1d.cu`` (the implicit-GEMM core, every parity class
    in one launch) on PyTorch's current stream.

    Takes CUDA float32 contiguous tensors only and raises on anything else
    (K ≤ 7, stride ≤ 16); forward only (no autograd), so it refuses inputs
    that require grad."""
    if x.device.type != "cuda":
        raise ValueError(f"convt1d_cuda needs CUDA tensors, got {x.device}")
    if x.dim() != 3 or w.dim() != 3:
        raise ValueError(f"convt1d: x must be (B, L, Cin) and w (K, Cin, Cout); "
                         f"got {tuple(x.shape)} and {tuple(w.shape)}")
    b, l, cin = x.shape
    k, wcin, cout = w.shape
    if wcin != cin:
        raise ValueError(f"convt1d: w has Cin {wcin}, x has {cin}")
    if stride < 1 or padding < 0 or output_padding < 0 or output_padding >= stride:
        raise ValueError(f"convt1d: bad geometry stride={stride} padding={padding} "
                         f"output_padding={output_padding}")
    check_limits("convt1d", k, stride)
    dev = x.device
    _build.check_operand("convt1d", x, "x", dev)
    _build.check_operand("convt1d", w, "w", dev)
    if bias is not None:
        _build.check_operand("convt1d", bias, "bias", dev, (cout,))
    lout = convt_out_len(l, k, stride, padding, output_padding)
    if lout <= 0:
        raise ValueError(f"convt1d: output length {lout} <= 0")
    y = torch.empty((b, lout, cout), device=dev, dtype=torch.float32)
    if y.numel() == 0:
        return y
    plan = convt_plan(b, l, cin, cout, k, stride, padding, output_padding)
    err = _lib().melogan_convt1d(
        x.data_ptr(), w.data_ptr(), bias.data_ptr() if bias is not None else None,
        y.data_ptr(), ctypes.byref(plan.c_struct()),
        dev.index, torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(err, "convt1d launch")
    _build.count_launch(convt1d_cuda)
    return y


convt1d_cuda.launches = 0
