"""Generator-decoder tail: the CUDA kernel ``csrc/decoder_tail.cu`` (three
launches of the implicit-GEMM core, ``csrc/igemm.cuh``) and its plain
PyTorch version.

Port of ``melogan_tpu/ops/pallas/decoder.py::_decoder_kernel``: (B, M, C0) →
(B, 8·M, C3) through three k5/s2/p2/op1 transposed convolutions with bias and
ReLU after the first two, eval BatchNorm folded into the weights ahead of the
call (:func:`fold_bn_affine`). ``stages`` are three (weight HIO (5, Cin, Cout),
bias (Cout,)) pairs, as in the JAX ``fused_decoder_tail``.
"""
from __future__ import annotations

import ctypes
from typing import List, Sequence, Tuple

import torch

from melogan_torch.ops import _build, igemm

K = 5
STRIDE = 2
PADDING = 2
_PADLO = K - 1 - PADDING  # 2


def taps(r: int) -> List[Tuple[int, int]]:
    """(tap_j, logical_offset) pairs for output parity class r
    (``_taps`` of the JAX package; w_flip[j] = w[K-1-j])."""
    return [
        (j, (r + j - _PADLO) // STRIDE)
        for j in range(K)
        if (r + j - _PADLO) % STRIDE == 0
    ]


def fold_bn_affine(w, b, bn_mean, bn_var, bn_scale, bn_bias, eps: float = 1e-5):
    """Fold a torch-semantics eval BatchNorm into (w, b) of the preceding
    transposed conv: y = ((conv + b) − µ)·γ/√(σ²+ε) + β. w is HIO, so the
    per-output-channel scale broadcasts over its last axis."""
    g = bn_scale * torch.rsqrt(bn_var + eps)
    return w * g, (b - bn_mean) * g + bn_bias


def decoder_tail_plain(x, stages: Sequence[Tuple[torch.Tensor, torch.Tensor]]):
    """The tap sum written out: each stage computes both parity classes as
    Σ over ``taps(r)`` of a contiguous slice of the zero-margined input times
    one flipped tap, then interleaves them. f32 matmuls."""
    if len(stages) != 3:
        raise ValueError(f"decoder_tail: expected 3 stages, got {len(stages)}")
    y = x
    for i, (w, bias) in enumerate(stages):
        b, m, _ = y.shape
        yp = torch.nn.functional.pad(y, (0, 0, 1, 1))  # one zero row each side
        wf = torch.flip(w, dims=(0,))
        classes = []
        for r in range(STRIDE):
            acc = bias.expand(b, m, -1)
            for j, off in taps(r):
                acc = acc + yp[:, 1 + off: 1 + off + m] @ wf[j]
            classes.append(acc)
        y = torch.stack(classes, dim=2).reshape(b, STRIDE * m, -1)
        if i < 2:
            y = torch.relu(y)
    return y


def decoder_tail_flops(b: int, m: int, widths: Sequence[int]) -> int:
    """Floating-point operations of the valid taps (2 per MAC): each input
    row meets five taps across the two output parities of a k5/s2/p2/op1
    stage, less the three that fall outside the signal (x[-1] once, x[L]
    twice)."""
    flops, lin = 0, m
    for cin, cout in zip(widths[:-1], widths[1:]):
        flops += 2 * b * (K * lin - 3) * cin * cout
        lin *= STRIDE
    return flops


def _lib():
    lib = _build.load("decoder_tail")
    if not getattr(lib, "_melogan_typed", False):
        p = ctypes.c_void_p
        lib.melogan_decoder_tail.argtypes = [p] * 11 + [ctypes.c_int, p]
        lib.melogan_decoder_tail.restype = ctypes.c_int
        lib._melogan_typed = True
    return lib


def stage_plans(b: int, m: int, widths: Sequence[int]) -> Tuple[igemm.Plan, ...]:
    """The core's plan of each stage: a k5/s2/p2/op1 transposed conv from
    length m·2^i and widths[i] channels to widths[i + 1] (cached)."""
    return tuple(igemm.convt_plan(b, m << i, widths[i], widths[i + 1], K, STRIDE, PADDING, 1)
                 for i in range(3))


def decoder_tail_cuda(x, stages: Sequence[Tuple[torch.Tensor, torch.Tensor]]):
    """Launch ``csrc/decoder_tail.cu`` on PyTorch's current stream: three
    launches of the implicit-GEMM core (x → h1 → h2 → y, ReLU in the first
    two stores), one call and one counted launch. h1 and h2 come from the
    caching allocator on the same stream. Raises on what the kernel does not
    take: non-CUDA, non-f32, non-contiguous or misshapen operands, or a
    plan outside the core's envelope."""
    if x.device.type != "cuda":
        raise ValueError(f"decoder_tail_cuda needs CUDA tensors, got {x.device}")
    if len(stages) != 3:
        raise ValueError(f"decoder_tail: expected 3 stages, got {len(stages)}")
    if x.dim() != 3:
        raise ValueError(f"decoder_tail: x must be (B, M, C0), got {tuple(x.shape)}")
    b, m, c0 = x.shape
    dev = x.device
    widths = [c0] + [int(w.shape[-1]) for w, _ in stages]
    if m < 1:
        raise ValueError(f"decoder_tail: M={m} must be positive")
    _build.check_operand("decoder_tail", x, "x", dev, (b, m, c0))
    for i, (w, bias) in enumerate(stages):
        _build.check_operand("decoder_tail", w, f"w{i + 1}", dev, (K, widths[i], widths[i + 1]))
        _build.check_operand("decoder_tail", bias, f"b{i + 1}", dev, (widths[i + 1],))
    y = torch.empty((b, 8 * m, widths[3]), device=dev, dtype=torch.float32)
    if b == 0:
        return y
    plans = (igemm.CPlan * 3)(*(p.c_struct() for p in stage_plans(b, m, widths)))
    h1 = torch.empty((b, 2 * m, widths[1]), device=dev, dtype=torch.float32)
    h2 = torch.empty((b, 4 * m, widths[2]), device=dev, dtype=torch.float32)
    (w1, b1), (w2, b2), (w3, b3) = stages
    err = _lib().melogan_decoder_tail(
        x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
        w3.data_ptr(), b3.data_ptr(), h1.data_ptr(), h2.data_ptr(), y.data_ptr(),
        plans, dev.index, torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(err, "decoder_tail launch")
    _build.count_launch(decoder_tail_cuda)
    return y


decoder_tail_cuda.launches = 0


def fused_decoder_tail(x, stages: Sequence[Tuple[torch.Tensor, torch.Tensor]]):
    """(B, M, C0) → (B, 8·M, C3): the kernel for a CUDA tensor, the plain
    version for a CPU tensor; any other device raises."""
    if x.device.type == "cuda":
        return decoder_tail_cuda(x, stages)
    if x.device.type == "cpu":
        return decoder_tail_plain(x, stages)
    raise ValueError(f"fused_decoder_tail: unsupported device {x.device}")
