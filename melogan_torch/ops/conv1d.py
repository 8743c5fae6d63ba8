"""Strided 1-D convolution: the CUDA kernel ``csrc/conv1d.cu`` and its plain
PyTorch version.

Port of ``melogan_tpu/ops/pallas/conv1d.py::_conv1d_kernel``. Both versions
take the JAX package's layout: x (B, L, Cin), weight HIO (K, Cin, Cout), with
torch Conv1d geometry, Lout = (L + 2·padding − K) // stride + 1. The front end
``ops/conv.py::conv1d`` picks one by the tensor's device and gives it a
backward.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from melogan_torch.ops import _build
from melogan_torch.ops.igemm import MAX_K, MAX_STRIDE, conv1d_plan
from melogan_torch.precision import round_bf16
from melogan_torch.utils.profiling import span


def conv_out_len(l: int, k: int, stride: int, padding: int) -> int:
    return (l + 2 * padding - k) // stride + 1


def conv1d_plain(x, w, bias=None, stride: int = 1, padding: int = 0, bf16: bool = False):
    """The tap sum written out as the JAX kernel does it: the zero-padded
    input split into ``stride`` parity streams, then for each tap k one f32
    matmul of a contiguous slice of stream k mod s (offset k div s) with
    w[k]. ``bf16``: x and w rounded to bf16 first (the kernel's one-pass
    mode; the products of bf16 values are exact in f32)."""
    if bf16:
        x, w = round_bf16(x), round_bf16(w)
    b, l, cin = x.shape
    k, _, cout = w.shape
    lout = conv_out_len(l, k, stride, padding)
    ls = lout + (k - 1) // stride  # rows every stream must cover
    need = stride * ls
    xp = torch.nn.functional.pad(x, (0, 0, padding, max(0, need - l - padding)))[:, :need]
    streams = [xp[:, r::stride] for r in range(stride)]
    acc = x.new_zeros((b, lout, cout))
    for kk in range(k):
        r, q = kk % stride, kk // stride
        acc = acc + streams[r][:, q: q + lout] @ w[kk]
    if bias is not None:
        acc = acc + bias
    return acc


def conv1d_flops(b: int, l: int, cin: int, cout: int, k: int, stride: int,
                 padding: int) -> int:
    """Floating-point operations of the taps that land inside the input
    (2 per MAC); taps on the zero padding are not counted."""
    lout = conv_out_len(l, k, stride, padding)
    macs = 0
    for t in range(lout):
        for kk in range(k):
            if 0 <= stride * t + kk - padding < l:
                macs += 1
    return 2 * b * macs * cin * cout


def _lib():
    lib = _build.load("conv1d")
    if not getattr(lib, "_melogan_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.melogan_conv1d.argtypes = [p, p, p, p, p, p, i, p, i]
        lib.melogan_conv1d.restype = ctypes.c_int
        lib._melogan_typed = True
    return lib


def conv1d_cuda(x, w, bias: Optional[torch.Tensor] = None, stride: int = 1,
                padding: int = 0, bf16: bool = False):
    """Launch ``csrc/conv1d.cu`` (the implicit-GEMM core) on PyTorch's
    current stream; ``bf16``: on the one-pass bf16 core
    (``csrc/igemm_bf16.cuh``: x and w rounded to bf16 once, on their way
    into shared memory, bf16 tensor-core products, f32 sums), else in
    3xTF32 on the f32 core (``csrc/igemm_tf32x3.cuh``: w split once by a
    prologue launch into scratch from the caching allocator, x by TMA,
    wgmma, persistent CTAs, split-K in a fixed order).

    Takes CUDA float32 contiguous tensors only and raises on anything else
    (K ≤ 7, stride ≤ 16). Forward only: gradients come from
    ``ops.conv.conv1d``."""
    with span("ops.conv1d"):
        if x.device.type != "cuda":
            raise ValueError(f"conv1d_cuda needs CUDA tensors, got {x.device}")
        if x.dim() != 3 or w.dim() != 3:
            raise ValueError(f"conv1d: x must be (B, L, Cin) and w (K, Cin, Cout); "
                             f"got {tuple(x.shape)} and {tuple(w.shape)}")
        b, l, cin = x.shape
        k, wcin, cout = w.shape
        if wcin != cin:
            raise ValueError(f"conv1d: w has Cin {wcin}, x has {cin}")
        if not (1 <= k <= MAX_K and 1 <= stride <= MAX_STRIDE and padding >= 0):
            raise ValueError(f"conv1d: kernel takes K <= {MAX_K}, stride <= {MAX_STRIDE}, "
                             f"padding >= 0; got K={k} stride={stride} padding={padding}")
        dev = x.device
        _build.check_operand("conv1d", x, "x", dev)
        _build.check_operand("conv1d", w, "w", dev)
        if bias is not None:
            _build.check_operand("conv1d", bias, "bias", dev, (cout,))
        lout = conv_out_len(l, k, stride, padding)
        if lout <= 0:
            raise ValueError(f"conv1d: output length {lout} <= 0")
        y = torch.empty((b, lout, cout), device=dev, dtype=torch.float32)
        if y.numel() == 0:
            return y
        plan = conv1d_plan(b, l, cin, cout, k, stride, padding, bf16)
        scratch = _build.scratch_for(plan, dev)
        err = _lib().melogan_conv1d(
            x.data_ptr(), w.data_ptr(), bias.data_ptr() if bias is not None else None,
            y.data_ptr(), ctypes.byref(plan.c_struct()), scratch.data_ptr() if scratch is not None else None,
            dev.index, torch.cuda.current_stream(dev).cuda_stream, int(bf16),
        )
        _build.check(err, "conv1d launch")
        _build.count_launch(conv1d_cuda, bf16)
        return y


conv1d_cuda.launches = 0
conv1d_cuda.launches_bf16 = 0
