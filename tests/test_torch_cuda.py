"""The CUDA kernels of melogan_torch against their plain PyTorch versions.

Needs an NVIDIA GPU (sm_90a) and nvcc: the kernels have no interpret mode,
so every test here is marked ``cuda`` and skips without a card. This file
imports neither JAX nor the JAX package, so that it runs where JAX is not
installed:

    python -m pytest tests/test_torch_cuda.py --noconftest -q

Tolerance: the kernels (the two convs' f32 mode and the decoder tail's three
launches, all on ``csrc/igemm_tf32x3.cuh``) sum in 3xTF32 on the tensor cores
(each operand split into two TF32 halves, three products into one f32 sum),
which is f32-accurate (about 5e-7 of the output scale against float64 at
full width, as IEEE f32 is; tests/test_torch_igemm.py); the plain versions
sum in IEEE f32 (TF32 off),
all in different orders over at most 5·Cin products per output. 1e-4
absolute and relative on O(1) outputs is about 100× that rounding; one-pass
TF32 would miss it.

The one-pass bf16 mode runs a core of its own (``csrc/igemm_bf16.cuh``):
it rounds x and w (and, as an input gradient, g and wᵀ) to bf16 once, as
its plain version does (``bf16=True``: ``.to(torch.bfloat16)``), and a
product of bf16 values is exact in f32: only the summation order differs,
so the same 1e-4 holds; at the shapes ``chip_smoke.py`` times it must also
come within 2e-6 of the scale (the core's emulation in
``tests/test_torch_igemm.py`` reads 0.8–2.4e-7 against float64, the plain
version as much again) and repeat bit for bit. Its results must differ from
the f32 mode's, and the f32 mode's must not move after bf16 launches (bit
for bit).
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from melogan_torch.config import GANConfig
from melogan_torch.ops import conv as conv_ops
from melogan_torch.ops.conv1d import conv1d_cuda, conv1d_plain
from melogan_torch.ops.convt import convt1d_cuda, convt1d_plain
from melogan_torch.models.gan import GeneratorDecoder
from melogan_torch.ops.decoder import TailStages, decoder_tail_cuda, decoder_tail_plain, fused_decoder_tail
from melogan_torch.precision import using
from melogan_torch.sampling import Sampler

pytestmark = pytest.mark.cuda

CONVT_SHAPES = [
    # (b, l, cin, cout, k, s, p, op)
    (2, 16, 32, 16, 5, 2, 2, 1),
    (2, 32, 16, 8, 5, 2, 2, 1),
    (2, 20, 8, 4, 3, 2, 1, 1),  # Cout = 4: one 8-wide N tile straddles both classes
    (2, 20, 8, 4, 3, 1, 1, 0),
    (3, 8, 24, 12, 5, 2, 2, 1),
    (4, 64, 256, 128, 5, 2, 2, 1),
    (2048, 16, 32, 66, 5, 2, 2, 1),  # N = 132: 64-wide tiles straddle classes, 4-byte weight copies
    (3, 37, 66, 66, 5, 2, 2, 1),  # Cin and Cout not multiples of 4, ragged row tile
    (1200, 20, 16, 64, 4, 3, 1, 2),
    (2, 45, 4, 32, 5, 2, 2, 1),  # Cin = 4: one 4-channel chunk, reduction 5·4 → 24
    (2, 41, 17, 40, 5, 2, 2, 1),  # Cin = 17: a chunk of 32 with 15 zero channels
    (2, 29, 12, 20, 7, 3, 3, 2),  # K = 7, stride 3: classes of 2 and 3 taps
    (64, 300, 64, 128, 3, 1, 1, 0),  # stride 1 (conv1d's input gradient), 128-row tiles
    # the decoder's three layers at full width, B = 288
    (288, 64, 256, 128, 5, 2, 2, 1),
    (288, 128, 128, 64, 5, 2, 2, 1),
    (288, 256, 64, 4, 5, 2, 2, 1),
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: a CUDA kernel has no interpret mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture
def rng():
    return np.random.default_rng(42)


def _t(a, dev):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)


@pytest.mark.parametrize("b,l,cin,cout,k,s,p,op", CONVT_SHAPES)
def test_convt1d_kernel_matches_plain(cuda, rng, b, l, cin, cout, k, s, p, op):
    x = _t(rng.normal(size=(b, l, cin)), cuda)
    w = _t(rng.normal(size=(k, cin, cout)) * 0.1, cuda)
    bias = _t(rng.normal(size=(cout,)) * 0.1, cuda)
    before = convt1d_cuda.launches
    out = convt1d_cuda(x, w, bias, s, p, op)
    torch.cuda.synchronize()
    assert convt1d_cuda.launches == before + 1
    torch.testing.assert_close(out, convt1d_plain(x, w, bias, s, p, op), atol=1e-4, rtol=1e-4)
    # without bias too
    torch.testing.assert_close(convt1d_cuda(x, w, None, s, p, op),
                               convt1d_plain(x, w, None, s, p, op), atol=1e-4, rtol=1e-4)


CONV1D_SHAPES = [
    # (b, l, cin, cout, k, s, p): the ED's four layers, ...
    (4, 512, 4, 64, 5, 1, 2),
    (4, 512, 64, 128, 3, 1, 1),
    (4, 512, 128, 256, 3, 1, 1),
    (2, 512, 256, 256, 3, 1, 1),
    (32, 512, 256, 256, 3, 1, 1),  # enough CTAs for 128-row tiles
    # ... the VAE encoder's k5 s2 p2, the decoder convts' input gradients
    # (k5 s2 p2 from 4, 64 and 128 channels), and the tiles' edges: a Cin
    # chunk that is not full (20, 17), Cout not a multiple of 64 or of 4,
    # narrow N tiles (6, 16, 32), stride 3 with K = 7, a ragged row tile
    (3, 512, 4, 64, 5, 2, 2),
    (4, 128, 128, 256, 5, 2, 2),
    (3, 37, 20, 70, 7, 3, 3),
    (2, 65, 17, 6, 2, 1, 0),
    (2, 77, 4, 16, 7, 3, 3),
    (3, 130, 17, 32, 3, 1, 1),
    (2, 300, 12, 66, 5, 2, 2),
    (2, 900, 8, 20, 7, 16, 3),  # stride 16: the shared-memory envelope's corner
]


@pytest.mark.parametrize("b,l,cin,cout,k,s,p", CONV1D_SHAPES)
def test_conv1d_kernel_matches_plain(cuda, rng, b, l, cin, cout, k, s, p):
    x = _t(rng.normal(size=(b, l, cin)), cuda)
    w = _t(rng.normal(size=(k, cin, cout)) / np.sqrt(k * cin), cuda)
    bias = _t(rng.normal(size=(cout,)) * 0.1, cuda)
    before = conv1d_cuda.launches
    out = conv1d_cuda(x, w, bias, s, p)
    torch.cuda.synchronize()
    assert conv1d_cuda.launches == before + 1
    torch.testing.assert_close(out, conv1d_plain(x, w, bias, s, p), atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(conv1d_cuda(x, w, None, s, p),
                               conv1d_plain(x, w, None, s, p), atol=1e-4, rtol=1e-4)


def _grads(fn, x, w, bias, g):
    x, w, bias = (t.detach().clone().requires_grad_() for t in (x, w, bias))
    (fn(x, w, bias) * g).sum().backward()
    return x.grad, w.grad, bias.grad


@pytest.mark.parametrize("b,l,cin,cout,k,s,p,op,transposed", [
    (4, 512, 4, 64, 5, 1, 2, 0, False),  # ED layer 1: dx is convt to 4 channels
    (32, 512, 64, 128, 3, 1, 1, 0, False),  # dx is a stride-1 convT (taps flipped, Q = K)
    (3, 512, 4, 64, 5, 2, 2, 0, False),
    (3, 511, 8, 16, 5, 2, 2, 0, False),  # (L + 2p - K) odd: dx needs output_padding 1
    (32, 512, 256, 256, 3, 1, 1, 0, False),  # ED layer 4: dx is a stride-1 convT, 256 wide
    (4, 64, 256, 128, 5, 2, 2, 1, True),  # the generator's three convts
    (4, 128, 128, 64, 5, 2, 2, 1, True),
    (4, 256, 64, 4, 5, 2, 2, 1, True),
])
def test_conv_backward_runs_the_other_kernel(cuda, rng, b, l, cin, cout, k, s, p, op, transposed):
    """Each Function's dx, dw and dbias on the card against autograd through
    the plain version; the input gradient launches the other conv's kernel."""
    x = _t(rng.normal(size=(b, l, cin)), cuda)
    w = _t(rng.normal(size=(k, cin, cout)) / np.sqrt(k * cin), cuda)
    bias = _t(rng.normal(size=(cout,)) * 0.1, cuda)
    if transposed:
        ours = lambda x, w, bias: conv_ops.conv_transpose1d(x, w, s, p, op, bias)  # noqa: E731
        plain = lambda x, w, bias: convt1d_plain(x, w, bias, s, p, op)  # noqa: E731
        other = conv1d_cuda
    else:
        ours = lambda x, w, bias: conv_ops.conv1d(x, w, s, p, bias)  # noqa: E731
        plain = lambda x, w, bias: conv1d_plain(x, w, bias, s, p)  # noqa: E731
        other = convt1d_cuda
    g = _t(rng.normal(size=tuple(plain(x, w, bias).shape)), cuda)
    before = other.launches
    got = _grads(ours, x, w, bias, g)
    torch.cuda.synchronize()
    assert other.launches == before + 1
    for a, e in zip(got, _grads(plain, x, w, bias, g)):
        torch.testing.assert_close(a, e, atol=1e-4 * float(e.abs().max()), rtol=1e-4)


def _bf16_mode_check(wrapper, cuda_fn, plain_fn, x, w, bias):
    """The bf16 mode (``cuda_fn``, a call of ``wrapper``) against its plain
    version; the f32 mode bit for bit the same before and after the bf16
    launches; one counted bf16 launch each."""
    f32_before = cuda_fn(x, w, bias)
    before = (wrapper.launches, wrapper.launches_bf16)
    out = cuda_fn(x, w, bias, bf16=True)
    out_nobias = cuda_fn(x, w, None, bf16=True)
    torch.cuda.synchronize()
    assert (wrapper.launches, wrapper.launches_bf16) == (before[0] + 2, before[1] + 2)
    for got, b in ((out, bias), (out_nobias, None)):
        want = plain_fn(x, w, b, bf16=True)
        torch.testing.assert_close(got, want, atol=1e-4 * float(want.abs().max()), rtol=1e-4)
    assert torch.equal(cuda_fn(x, w, bias), f32_before)
    assert not torch.equal(out, f32_before)


@pytest.mark.parametrize("b,l,cin,cout,k,s,p,op", CONVT_SHAPES)
def test_convt1d_bf16_mode_matches_plain(cuda, rng, b, l, cin, cout, k, s, p, op):
    x = _t(rng.normal(size=(b, l, cin)), cuda)
    w = _t(rng.normal(size=(k, cin, cout)) * 0.1, cuda)
    bias = _t(rng.normal(size=(cout,)) * 0.1, cuda)

    def ours(x_, w_, b_, bf16=False):
        return convt1d_cuda(x_, w_, b_, s, p, op, bf16=bf16)

    def plain(x_, w_, b_, bf16=False):
        return convt1d_plain(x_, w_, b_, s, p, op, bf16=bf16)

    _bf16_mode_check(convt1d_cuda, ours, plain, x, w, bias)


@pytest.mark.parametrize("b,l,cin,cout,k,s,p", CONV1D_SHAPES)
def test_conv1d_bf16_mode_matches_plain(cuda, rng, b, l, cin, cout, k, s, p):
    x = _t(rng.normal(size=(b, l, cin)), cuda)
    w = _t(rng.normal(size=(k, cin, cout)) / np.sqrt(k * cin), cuda)
    bias = _t(rng.normal(size=(cout,)) * 0.1, cuda)

    def ours(x_, w_, b_, bf16=False):
        return conv1d_cuda(x_, w_, b_, s, p, bf16=bf16)

    def plain(x_, w_, b_, bf16=False):
        return conv1d_plain(x_, w_, b_, s, p, bf16=bf16)

    _bf16_mode_check(conv1d_cuda, ours, plain, x, w, bias)


@pytest.mark.parametrize("b,l,cin,cout,k,s,p,op,transposed", [
    (4, 512, 4, 64, 5, 1, 2, 0, False),
    (32, 512, 64, 128, 3, 1, 1, 0, False),
    (3, 511, 8, 16, 5, 2, 2, 0, False),
    (32, 512, 256, 256, 3, 1, 1, 0, False),
    (4, 64, 256, 128, 5, 2, 2, 1, True),
    (4, 128, 128, 64, 5, 2, 2, 1, True),
    (4, 256, 64, 4, 5, 2, 2, 1, True),
])
def test_conv_backward_at_bf16_runs_the_other_kernel_in_bf16(cuda, rng, b, l, cin, cout, k, s, p, op,
                                                             transposed):
    """Under "fast" each Function's forward and input gradient launch the
    kernels' bf16 mode (one each, counted per mode), and its dx, dw and dbias
    match the same Function on the CPU, where the plain versions and the dw
    tap products round the same operands."""
    x = _t(rng.normal(size=(b, l, cin)), cuda)
    w = _t(rng.normal(size=(k, cin, cout)) / np.sqrt(k * cin), cuda)
    bias = _t(rng.normal(size=(cout,)) * 0.1, cuda)
    if transposed:
        ours = lambda x, w, bias: conv_ops.conv_transpose1d(x, w, s, p, op, bias)  # noqa: E731
        own, other = convt1d_cuda, conv1d_cuda
    else:
        ours = lambda x, w, bias: conv_ops.conv1d(x, w, s, p, bias)  # noqa: E731
        own, other = conv1d_cuda, convt1d_cuda
    with torch.no_grad():
        shape = tuple(ours(x, w, bias).shape)
    g = _t(rng.normal(size=shape), cuda)
    before = (own.launches_bf16, other.launches_bf16)
    with using("fast"):
        got = _grads(ours, x, w, bias, g)
        torch.cuda.synchronize()
        want = _grads(ours, *(t.cpu() for t in (x, w, bias, g)))
    assert (own.launches_bf16, other.launches_bf16) == (before[0] + 1, before[1] + 1)
    for a, e in zip(got, want):
        torch.testing.assert_close(a.cpu(), e, atol=1e-4 * float(e.abs().max()), rtol=1e-4)
    f32 = _grads(ours, x, w, bias, g)
    assert not torch.equal(got[0], f32[0]) and not torch.equal(got[1], f32[1])


# the layers chip_smoke.py's kernels_bf16 phase times, at its batches:
# (kind, b, L, Cin, Cout, K, s, p, op); the decoder's also at bench's 65536
_DEC = [(64, 256, 128), (128, 128, 64), (256, 64, 4)]
_ED = [(512, 4, 64, 5, 2), (512, 64, 128, 3, 1), (512, 128, 256, 3, 1), (512, 256, 256, 3, 1)]
_VAE_ENC = [(512, 4, 32), (256, 32, 64), (128, 64, 128)]
_VAE_DEC = [(64, 128, 64), (128, 64, 32), (256, 32, 4)]
BF16_SMOKE_SHAPES = (
    [("convt1d", b, l, cin, cout, 5, 2, 2, 1) for b in (1, 32, 4096, 65536) for l, cin, cout in _DEC]
    + [("conv1d", b, l, cin, cout, k, 1, p, 0) for b in (32, 64, 1024) for l, cin, cout, k, p in _ED]
    + [("conv1d", b, l, cin, cout, 5, 2, 2, 0) for b in (32, 256) for l, cin, cout in _VAE_ENC]
    + [("convt1d", b, l, cin, cout, 5, 2, 2, 1) for b in (32, 256) for l, cin, cout in _VAE_DEC]
    # input gradients at batch 32: conv1d's is convt1d on (g, wᵀ), convT's is conv1d
    + [("convt1d", 32, l + 2 * p - k + 1, cout, cin, k, 1, p, 0) for l, cin, cout, k, p in _ED]
    + [("conv1d", 32, 2 * l, cout, cin, 5, 2, 2, 0) for l, cin, cout in _DEC]
)


def _bf16_run(kind, x, w, bias, s, p, op):
    if kind == "convt1d":
        return convt1d_cuda(x, w, bias, s, p, op, bf16=True), convt1d_plain(x, w, bias, s, p, op, bf16=True)
    return conv1d_cuda(x, w, bias, s, p, bf16=True), conv1d_plain(x, w, bias, s, p, bf16=True)


@pytest.mark.parametrize("kind,b,l,cin,cout,k,s,p,op", BF16_SMOKE_SHAPES)
def test_bf16_mode_at_the_smoke_shapes_repeats_bit_for_bit(cuda, rng, kind, b, l, cin, cout, k, s, p, op):
    """The bf16 core at every layer ``kernels_bf16`` times (Cin = 4 in
    im2col rows, Cout = 4 in 8-wide tiles, stride 2, short samples sharing
    a 256-row tile, both input-gradient routes) and at the benchmark's
    batch of 65536: within 2e-6 of the scale of its plain version, and a
    second launch on the same inputs equal bit for bit (no reduction is
    split across CTAs)."""
    gen = torch.Generator(device=cuda).manual_seed(b * 1000 + l + cin + cout)
    x = torch.randn((b, l, cin), device=cuda, generator=gen)  # up to 4.3 GB: made on the card
    w = _t(rng.normal(size=(k, cin, cout)) / np.sqrt(k * cin), cuda)
    bias = _t(rng.normal(size=(cout,)) * 0.1, cuda)
    wrapper = convt1d_cuda if kind == "convt1d" else conv1d_cuda
    before = wrapper.launches_bf16
    out, want = _bf16_run(kind, x, w, bias, s, p, op)
    again, _ = _bf16_run(kind, x, w, bias, s, p, op)
    torch.cuda.synchronize()
    assert wrapper.launches_bf16 == before + 2
    assert float((out - want).abs().max()) <= 2e-6 * float(want.abs().max())
    assert torch.equal(out, again)


# every f32 layer chip_smoke.py launches in its kernel phases (kernels, kernels_ed,
# kernels_vae, backward_route, kernels_tp) and the decoder's at bench's 65536
_TP_CONV1D = [(512, 128, 128, 3, 1), (512, 128, 256, 3, 1)]
F32_SMOKE_SHAPES = (
    BF16_SMOKE_SHAPES
    + [("conv1d", b, 512, 4, 32, 5, 2, 2, 0) for b in (32, 1024)]
    + [("convt1d", 64, l + 2 * p - k + 1, cout, cin, k, 1, p, 0) for l, cin, cout, k, p in _ED[1:]]
    + [("convt1d", 32, (l + 4 - 5) // 2 + 1, cout, cin, 5, 2, 2, (l + 4 - 5) % 2) for l, cin, cout in _VAE_ENC]
    + [("conv1d", 32, 2 * l, cout, cin, 5, 2, 2, 0) for l, cin, cout in _VAE_DEC]
    + [("convt1d", 32, 64, 128, 128, 5, 2, 2, 1), ("conv1d", 32, 128, 128, 128, 5, 2, 2, 0)]
    + [("conv1d", 32, l, cin, cout, k, 1, p, 0) for l, cin, cout, k, p in _TP_CONV1D]
    + [("convt1d", 32, l + 2 * p - k + 1, cout, cin, k, 1, p, 0) for l, cin, cout, k, p in _TP_CONV1D]
)


@pytest.mark.parametrize("kind,b,l,cin,cout,k,s,p,op", F32_SMOKE_SHAPES)
def test_f32_mode_at_the_smoke_shapes_repeats_bit_for_bit(cuda, rng, kind, b, l, cin, cout, k, s, p, op):
    """The f32 core (``csrc/igemm_tf32x3.cuh``) at every f32 layer of
    ``chip_smoke.py``'s kernel phases (split-K parts at batch 1 and at the
    tensor-parallel shards, im2col at Cin = 4, 8-wide tiles at Cout = 4,
    stride 2) and at the benchmark's batch of 65536: within 1e-6 of the
    scale of the plain version run in float64 (3xTF32 is f32-accurate), and
    a second launch on the same inputs equal bit for bit (split-K parts are
    summed in a fixed order), one counted launch each, none in bf16 mode."""
    gen = torch.Generator(device=cuda).manual_seed(b * 1000 + l + cin + cout)
    x = torch.randn((b, l, cin), device=cuda, generator=gen)  # up to 4.3 GB: made on the card
    w = _t(rng.normal(size=(k, cin, cout)) / np.sqrt(k * cin), cuda)
    bias = _t(rng.normal(size=(cout,)) * 0.1, cuda)
    wrapper = convt1d_cuda if kind == "convt1d" else conv1d_cuda
    before, before_bf16 = wrapper.launches, wrapper.launches_bf16
    if kind == "convt1d":
        out, again = (convt1d_cuda(x, w, bias, s, p, op) for _ in range(2))
        want = convt1d_plain(x.double(), w.double(), bias.double(), s, p, op)
    else:
        out, again = (conv1d_cuda(x, w, bias, s, p) for _ in range(2))
        want = conv1d_plain(x.double(), w.double(), bias.double(), s, p)
    torch.cuda.synchronize()
    assert (wrapper.launches - before, wrapper.launches_bf16 - before_bf16) == (2, 0)
    assert float((out.double() - want).abs().max()) <= 1e-6 * float(want.abs().max())
    assert torch.equal(out, again)


def test_conv_kernels_take_unaligned_operands_in_bf16(cuda, rng):
    """The bf16 core with operands one float past a 16-byte boundary (its
    4-byte copies and scalar rounding), Cin and Cout not multiples of 4."""
    def unaligned(shape):
        a = _t(rng.normal(size=(int(np.prod(shape)) + 1,)), cuda)[1:].view(shape)
        assert a.data_ptr() % 16 and a.is_contiguous()
        return a

    for (cin, cout) in ((8, 12), (6, 10), (20, 36)):
        x, w = unaligned((3, 40, cin)), unaligned((5, cin, cout))
        for kind, geo in (("convt1d", (2, 2, 1)), ("conv1d", (2, 2, 0))):
            got, want = _bf16_run(kind, x, w, None, *geo)
            torch.testing.assert_close(got, want, atol=1e-4 * float(want.abs().max()), rtol=1e-4)


def test_fast_sampler_on_card_runs_bf16_convt_and_no_tail(cuda, rng):
    """``Sampler(fast_math=True)``: three ``convt1d`` launches in bf16 mode a
    call and no decoder-tail launch; its notes match the CPU port's fast
    path within 2⁻⁸ of their scale (the same roundings, sums in another
    order: where an f32 sum and its CPU twin round to neighbouring bf16
    values in the next layer, that operand moves by one bf16 step) and
    differ from the card's f32 sampler's."""
    cfg = GANConfig()
    gpu = Sampler(cfg, seed=0, fast_math=True, device="cuda")
    f32 = Sampler(cfg, gen_variables=gpu.generator.state_dict(),
                  fe_variables=gpu.feature_encoder.state_dict(), device="cuda")
    cpu = Sampler(cfg, gen_variables=gpu.generator.state_dict(),
                  fe_variables=gpu.feature_encoder.state_dict(), fast_math=True, device="cpu")
    feats = rng.normal(size=(8, 6)).astype(np.float32)
    noise = rng.normal(size=(8, cfg.noise_dim)).astype(np.float32)
    before = (convt1d_cuda.launches_bf16, convt1d_cuda.launches, decoder_tail_cuda.launches)
    ours = gpu.sample_from(feats, noise)
    assert (convt1d_cuda.launches_bf16 - before[0], convt1d_cuda.launches - before[1],
            decoder_tail_cuda.launches - before[2]) == (3, 3, 0)
    theirs = cpu.sample_from(feats, noise)
    scale = float(np.abs(theirs).max())
    assert float(np.abs(ours - theirs).max()) <= 2.0 ** -8 * scale
    assert not np.array_equal(ours, f32.sample_from(feats, noise))


def _decoder_stages(rng, widths, dev):
    return [(_t(rng.normal(size=(5, cin, cout)) / np.sqrt(5 * cin), dev),
             _t(rng.normal(size=(cout,)) * 0.1, dev))
            for cin, cout in zip(widths[:-1], widths[1:])]


@pytest.mark.parametrize("b,m,widths", [
    (2, 16, (24, 16, 8, 4)),
    (3, 5, (8, 12, 8, 4)),  # M = 5: a ragged row tile in every stage
    (2, 7, (6, 10, 6, 3)),  # channel counts not multiples of 4: 4-byte copies
    (3, 9, (66, 33, 18, 5)),  # odd Cout: 4-byte stores, N tiles straddling classes
    (4, 64, (256, 128, 64, 4)),  # the main path's widths (max_notes 512)
    (2, 128, (256, 128, 64, 4)),  # max_notes 1024
])
def test_decoder_tail_kernel_matches_plain(cuda, rng, b, m, widths):
    """One wrapper call is one counted launch of the decoder-tail kernel
    (three device launches of the core), and never goes through the
    ``convt1d`` wrapper."""
    x = _t(rng.normal(size=(b, m, widths[0])), cuda)
    stages = _decoder_stages(rng, widths, cuda)
    before, before_convt = decoder_tail_cuda.launches, convt1d_cuda.launches
    out = fused_decoder_tail(x, stages)
    torch.cuda.synchronize()
    assert decoder_tail_cuda.launches == before + 1
    assert convt1d_cuda.launches == before_convt
    torch.testing.assert_close(out, decoder_tail_plain(x, stages), atol=1e-4, rtol=1e-4)


def _device_kernels(fn, name):
    """Device kernels whose name holds ``name`` that one ``fn()`` launches
    (a ``torch.profiler`` trace)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(ev.count for ev in prof.key_averages()
               if str(ev.device_type).endswith("CUDA") and name in ev.key)


@pytest.mark.parametrize("b,m", [(1, 64), (4096, 64), (2048, 128)])
def test_decoder_tail_repeats_and_warm_calls_make_no_wprep(cuda, rng, b, m):
    """On stages that hold their W' (``TailStages``) the first call makes it
    (three ``prep_w`` launches) and a warm call launches only the three
    convs of the core: no ``prep_w``, no new W'. A second launch gives the
    first one's bits (split-K parts summed in part order at batch 1), held
    and fresh W' give the same bits, and the output is the plain
    version's."""
    widths = (256, 128, 64, 4)
    x = _t(rng.normal(size=(b, m, widths[0])), cuda)
    stages = TailStages(_decoder_stages(rng, widths, cuda))
    before = decoder_tail_cuda.prepares
    out = decoder_tail_cuda(x, stages)
    assert decoder_tail_cuda.prepares == before + 1 and len(stages.layouts) == 1
    again = decoder_tail_cuda(x, stages)
    assert decoder_tail_cuda.prepares == before + 1
    torch.cuda.synchronize()
    assert torch.equal(out, again)
    assert torch.equal(out, decoder_tail_cuda(x, list(stages)))
    torch.testing.assert_close(out, decoder_tail_plain(x, stages), atol=1e-4, rtol=1e-4)
    assert _device_kernels(lambda: decoder_tail_cuda(x, stages), "prep_w") == 0
    assert _device_kernels(lambda: decoder_tail_cuda(x, stages), "igemm_tf32x3_conv") == 3
    assert decoder_tail_cuda.prepares == before + 2  # the fresh list's call alone


def test_fused_decoder_follows_an_in_place_weight_update(cuda, rng):
    """The eval decoder's W', held with its folded stages, is made again
    after an in-place change of a conv weight: the fused output follows the
    new weights, as the layered path computes them."""
    dec = GeneratorDecoder(latent_dim=16, max_notes=512).to(cuda).eval()
    latent = _t(rng.normal(size=(3, 16)), cuda)
    with torch.inference_mode():
        before = dec(latent)
        held = dec.folded_stages()
    with torch.no_grad():
        dec.deconv[3].weight.mul_(-1.5)
    with torch.inference_mode():
        after = dec(latent)
        assert dec.folded_stages() is not held
        dec.fuses = lambda: False
        layered = dec(latent)
    del dec.fuses
    assert not torch.allclose(before, after)
    torch.testing.assert_close(after, layered, atol=1e-4, rtol=1e-4)


def test_kernels_refuse_what_they_do_not_take(cuda):
    x = torch.zeros((2, 8, 6), device=cuda)
    stages = [(torch.zeros((5, 6, 6), device=cuda), torch.zeros(6, device=cuda))] * 3
    with pytest.raises(ValueError, match="float32"):
        decoder_tail_cuda(x.double(), stages)
    with pytest.raises(ValueError, match="contiguous"):
        decoder_tail_cuda(x, [(stages[0][0].transpose(1, 2), stages[0][1])] + stages[1:])
    with pytest.raises(ValueError, match="shape"):
        decoder_tail_cuda(x, [(torch.zeros((5, 6, 8), device=cuda), torch.zeros(8, device=cuda))] * 3)
    with pytest.raises(ValueError, match="float32"):
        convt1d_cuda(x.double(), torch.zeros((5, 6, 4), device=cuda, dtype=torch.float64))
    with pytest.raises(ValueError, match="contiguous"):
        convt1d_cuda(x.transpose(1, 2).contiguous().transpose(1, 2),
                     torch.zeros((5, 6, 4), device=cuda))
    w = torch.zeros((5, 6, 4), device=cuda, requires_grad=True)
    with pytest.raises(NotImplementedError):
        convt1d_cuda(x, w)
    with pytest.raises(ValueError, match="K <= 7"):
        convt1d_cuda(x, torch.zeros((8, 6, 4), device=cuda))
    with pytest.raises(ValueError, match="stride <= 16"):
        conv1d_cuda(torch.zeros((2, 40, 6), device=cuda), torch.zeros((3, 6, 4), device=cuda), None, 17)


def test_conv_kernels_take_unaligned_operands(cuda, rng):
    """Operands one float past a 16-byte boundary take the 4-byte copies."""
    def unaligned(shape):
        a = _t(rng.normal(size=(int(np.prod(shape)) + 1,)), cuda)[1:].view(shape)
        assert a.data_ptr() % 16 and a.is_contiguous()
        return a

    x, w = unaligned((3, 40, 8)), unaligned((5, 8, 12))
    torch.testing.assert_close(convt1d_cuda(x, w, None, 2, 2, 1), convt1d_plain(x, w, None, 2, 2, 1),
                               atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(conv1d_cuda(x, w, None, 2, 2), conv1d_plain(x, w, None, 2, 2),
                               atol=1e-4, rtol=1e-4)


def test_decoder_tail_takes_unaligned_operands(cuda, rng):
    """x and the weights one float past a 16-byte boundary take the core's
    4-byte copies."""
    def unaligned(a):
        t = _t(np.concatenate([[0.0], a.ravel()]), cuda)[1:].view(a.shape)
        assert t.data_ptr() % 16 and t.is_contiguous()
        return t

    widths = (12, 8, 8, 4)
    x = unaligned(rng.normal(size=(3, 10, widths[0])))
    stages = [(unaligned(rng.normal(size=(5, cin, cout)) / np.sqrt(5 * cin)), bias)
              for (cin, cout), (_, bias) in zip(zip(widths[:-1], widths[1:]),
                                                 _decoder_stages(rng, widths, cuda))]
    torch.testing.assert_close(decoder_tail_cuda(x, stages), decoder_tail_plain(x, stages),
                               atol=1e-4, rtol=1e-4)


def test_sampler_on_card_matches_cpu(cuda, rng):
    """The whole slice on the card (kernels) against the port's CPU path
    (plain versions), same weights and inputs, both decoder paths (the
    decoder-tail kernel at max_notes 512 and 1024)."""
    for cfg in (GANConfig(), GANConfig(max_notes=1024), GANConfig(max_notes=500)):
        gpu = Sampler(cfg, seed=0, device="cuda")
        cpu = Sampler(cfg, gen_variables=gpu.generator.state_dict(),
                      fe_variables=gpu.feature_encoder.state_dict(), device="cpu")
        feats = rng.normal(size=(4, 6)).astype(np.float32)
        noise = rng.normal(size=(4, cfg.noise_dim)).astype(np.float32)
        a, b = gpu.sample_from(feats, noise), cpu.sample_from(feats, noise)
        assert np.abs(a - b).max() <= 1e-4 * np.abs(b).max()


# the VAE's layers: (L, Cin, Cout) of the encoder's k5 s2 p2 convs and of the
# decoder's k5 s2 p2 op1 transposed convs, at full width (max_notes 512)
VAE_ENCODER = [(512, 4, 32), (256, 32, 64), (128, 64, 128)]
VAE_DECODER = [(64, 128, 64), (128, 64, 32), (256, 32, 4)]


@pytest.mark.parametrize("b", [32, 256])  # a training batch, and encode_mu's chunk
@pytest.mark.parametrize("layer", range(3))
def test_vae_layers_on_card_match_plain(cuda, rng, b, layer):
    """Both kernels at the VAE's shapes, forward, against their plain versions."""
    l, cin, cout = VAE_ENCODER[layer]
    x = _t(rng.normal(size=(b, l, cin)), cuda)
    w = _t(rng.normal(size=(5, cin, cout)) / np.sqrt(5 * cin), cuda)
    bias = _t(rng.normal(size=(cout,)) * 0.1, cuda)
    torch.testing.assert_close(conv1d_cuda(x, w, bias, 2, 2), conv1d_plain(x, w, bias, 2, 2),
                               atol=1e-4, rtol=1e-4)
    l, cin, cout = VAE_DECODER[layer]
    x = _t(rng.normal(size=(b, l, cin)), cuda)
    w = _t(rng.normal(size=(5, cin, cout)) / np.sqrt(5 * cin), cuda)
    bias = _t(rng.normal(size=(cout,)) * 0.1, cuda)
    torch.testing.assert_close(convt1d_cuda(x, w, bias, 2, 2, 1), convt1d_plain(x, w, bias, 2, 2, 1),
                               atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("layer", range(3))
@pytest.mark.parametrize("transposed", [False, True])
def test_vae_backward_routes_on_card(cuda, rng, layer, transposed):
    """dx, dw and dbias at batch 32 at the VAE's shapes against autograd
    through the plain versions: the encoder's conv input gradient launches
    ``convt1d``, the decoder's convT input gradient launches ``conv1d``."""
    l, cin, cout = (VAE_DECODER if transposed else VAE_ENCODER)[layer]
    x = _t(rng.normal(size=(32, l, cin)), cuda)
    w = _t(rng.normal(size=(5, cin, cout)) / np.sqrt(5 * cin), cuda)
    bias = _t(rng.normal(size=(cout,)) * 0.1, cuda)
    if transposed:
        ours = lambda x, w, bias: conv_ops.conv_transpose1d(x, w, 2, 2, 1, bias)  # noqa: E731
        plain = lambda x, w, bias: convt1d_plain(x, w, bias, 2, 2, 1)  # noqa: E731
        other = conv1d_cuda
    else:
        ours = lambda x, w, bias: conv_ops.conv1d(x, w, 2, 2, bias)  # noqa: E731
        plain = lambda x, w, bias: conv1d_plain(x, w, bias, 2, 2)  # noqa: E731
        other = convt1d_cuda
    g = _t(rng.normal(size=tuple(plain(x, w, bias).shape)), cuda)
    before = other.launches
    got = _grads(ours, x, w, bias, g)
    torch.cuda.synchronize()
    assert other.launches == before + 1
    for a, e in zip(got, _grads(plain, x, w, bias, g)):
        torch.testing.assert_close(a, e, atol=1e-4 * float(e.abs().max()), rtol=1e-4)


def test_vae_step_and_encode_on_card_match_cpu(cuda, rng):
    """One VAE training step at full width (batch 32) on the card against the
    port's CPU path from the same weights and eps: losses 1e-4 of scale,
    parameters within 2·lr. Adam's first moments are held against a float64
    step on the CPU: the card's error must be within three times the CPU
    float32 path's own, plus 1e-5 of the largest moment (the CPU parity
    tests' gradient tolerance). On this input the f32 step itself is off the
    f64 one by 1.4e-4 of the largest moment at fc_mu.bias, so a fixed 1e-4
    would test the input's conditioning, not the card. Then
    ``encode_mu`` of 300 rows (a padded tail), 1e-4 of scale."""
    from melogan_torch.config import AEConfig
    from melogan_torch.train import vae_loop

    cfg = AEConfig()
    gpu = vae_loop.init_state(cfg, seed=0, device="cuda")
    cpu = vae_loop.init_state(cfg, seed=0, device="cpu")
    cpu.model.load_state_dict(gpu.model.state_dict())
    f64 = vae_loop.init_state(cfg, seed=0, device="cpu")
    f64.model.load_state_dict(gpu.model.state_dict())
    f64.model.double()
    f64.opt = vae_loop.make_optimizer(cfg, f64.model)
    x = rng.uniform(-1, 1, size=(32, 512, 4)).astype(np.float32)
    eps = rng.normal(size=(32, cfg.latent_dim)).astype(np.float32)
    launches = (conv1d_cuda.launches, convt1d_cuda.launches)
    rows = [vae_loop.train_step(s, _t(x, s.device), 10.0, eps=_t(eps, s.device)).cpu()
            for s in (gpu, cpu)]
    assert (conv1d_cuda.launches - launches[0], convt1d_cuda.launches - launches[1]) == (6, 5)
    vae_loop.train_step(f64, torch.from_numpy(x).double(), 10.0, eps=torch.from_numpy(eps).double())
    torch.testing.assert_close(rows[0], rows[1], atol=1e-4 * float(rows[1].abs().max()), rtol=0)
    mu_g, mu_c = gpu.opt.state_dict()["mu"], cpu.opt.state_dict()["mu"]
    mu_ref = f64.opt.state_dict()["mu"]
    gmax = max(float(v.abs().max()) for v in mu_ref.values())
    for (name, pg), (_, pc) in zip(gpu.model.named_parameters(), cpu.model.named_parameters()):
        err_g = float((mu_g[name].cpu().double() - mu_ref[name]).abs().max())
        err_c = float((mu_c[name].double() - mu_ref[name]).abs().max())
        assert err_g <= 3 * err_c + 1e-5 * gmax, (name, err_g, err_c)
        assert float((pg.detach().cpu() - pc.detach()).abs().max()) <= 2 * cfg.lr * (1 + 1e-3), name
    notes = rng.uniform(-1, 1, size=(300, 512, 4)).astype(np.float32)
    a, b = vae_loop.encode_mu(gpu.model, notes), vae_loop.encode_mu(cpu.model, notes)
    assert a.shape == (300, cfg.latent_dim) and np.abs(a - b).max() <= 1e-4 * np.abs(b).max()


# the ED's four conv blocks at full width: (L, Cin, Cout, K, padding), stride 1
ED_LAYERS = [(512, 4, 64, 5, 2), (512, 64, 128, 3, 1), (512, 128, 256, 3, 1), (512, 256, 256, 3, 1)]


@pytest.mark.parametrize("layer", range(4))
def test_ed_layers_at_batch_64_on_card(cuda, rng, layer):
    """The ED trainer's batch (64): ``conv1d`` forward at each block, and
    the conv Function's backward, whose input gradient runs the ``convt1d``
    kernel (one launch), against autograd through the plain version."""
    l, cin, cout, k, p = ED_LAYERS[layer]
    x = _t(rng.normal(size=(64, l, cin)), cuda)
    w = _t(rng.normal(size=(k, cin, cout)) / np.sqrt(k * cin), cuda)
    bias = _t(0.1 * rng.normal(size=(cout,)), cuda)
    out, ref = conv1d_cuda(x, w, bias, 1, p), conv1d_plain(x, w, bias, 1, p)
    torch.testing.assert_close(out, ref, atol=1e-4 * float(ref.abs().max()), rtol=1e-4)
    g = _t(rng.normal(size=tuple(ref.shape)), cuda)
    before = convt1d_cuda.launches
    got = _grads(lambda x_, w_, b_: conv_ops.conv1d(x_, w_, 1, p, bias=b_), x, w, bias, g)
    torch.cuda.synchronize()
    assert convt1d_cuda.launches == before + 1
    for a, e in zip(got, _grads(lambda x_, w_, b_: conv1d_plain(x_, w_, b_, 1, p), x, w, bias, g)):
        torch.testing.assert_close(a, e, atol=1e-4 * float(e.abs().max()), rtol=1e-4)


def test_ed_step_and_evaluate_on_card_match_cpu(cuda, rng):
    """One ED training step at full width (``EDConfig()``, batch 64) on the
    card against the port's CPU path from the same weights and dropout
    masks: loss 1e-4 of scale, accuracy exactly, BatchNorm running
    statistics 1e-4 of scale, parameters within 2·lr; 4 ``conv1d`` and 3
    ``convt1d`` launches. Adam's first moments are held against a float64
    step on the CPU: the card's error within three times the CPU float32
    path's own, plus 1e-5 of the largest moment (as for the VAE step: a
    fixed bound would test the input's conditioning). Then ``evaluate`` of
    a 70-row split on each: loss 1e-4 of scale, the confusion matrix
    equal."""
    import copy

    from melogan_torch.config import EDConfig
    from melogan_torch.data.datasets import SplitData
    from melogan_torch.train import ed_loop

    cfg = EDConfig()
    gpu = ed_loop.init_state(cfg, seed=0, device="cuda")
    cpu = ed_loop.init_state(cfg, model=copy.deepcopy(gpu.model).cpu(), device="cpu")
    f64 = ed_loop.init_state(cfg, model=copy.deepcopy(gpu.model).cpu().double(), device="cpu")
    x = rng.uniform(-1, 1, size=(64, 512, 4)).astype(np.float32)
    y = rng.integers(0, 4, size=64)
    masks = [rng.uniform(size=(64, h)) < 0.8 for h in cfg.mlp_hidden]

    def step(state, dtype=torch.float32):
        dev = state.device
        return ed_loop.train_step(state, torch.from_numpy(x).to(dev, dtype), torch.from_numpy(y).to(dev),
                                  masks=[torch.from_numpy(m).to(dev) for m in masks]).cpu()

    launches = (conv1d_cuda.launches, convt1d_cuda.launches)
    rows = [step(gpu), step(cpu)]
    assert (conv1d_cuda.launches - launches[0], convt1d_cuda.launches - launches[1]) == (4, 3)
    step(f64, torch.float64)
    torch.testing.assert_close(rows[0][0], rows[1][0], atol=1e-4 * float(rows[1][0].abs()), rtol=0)
    assert float(rows[0][1]) == float(rows[1][1])
    mu_g, mu_c = gpu.opt.state_dict()["mu"], cpu.opt.state_dict()["mu"]
    mu_ref = f64.opt.state_dict()["mu"]
    gmax = max(float(v.abs().max()) for v in mu_ref.values())
    lr = cfg.optimizer.lr
    for (name, pg), (_, pc) in zip(gpu.model.named_parameters(), cpu.model.named_parameters()):
        err_g = float((mu_g[name].cpu().double() - mu_ref[name]).abs().max())
        err_c = float((mu_c[name].double() - mu_ref[name]).abs().max())
        assert err_g <= 3 * err_c + 1e-5 * gmax, (name, err_g, err_c)
        assert float((pg.detach().cpu() - pc.detach()).abs().max()) <= 2 * lr * (1 + 1e-3), name
    sd_g, sd_c = gpu.model.state_dict(), cpu.model.state_dict()
    for k in sd_c:
        if "running" in k:
            torch.testing.assert_close(sd_g[k].cpu(), sd_c[k], atol=1e-4 * float(sd_c[k].abs().max()), rtol=0)

    n = 70
    raw = np.stack([rng.integers(36, 97, (n, 512)), np.cumsum(rng.uniform(0, 1, (n, 512)), 1),
                    rng.uniform(0.1, 2, (n, 512)), rng.integers(40, 111, (n, 512))], -1).astype(np.float32)
    data = SplitData(raw, np.array(["happy", "sad", "angry", "calm"] * 18)[:n],
                     rng.normal(size=(n, 6)).astype(np.float32), [])
    cpu.model.load_state_dict({k: v.cpu() for k, v in gpu.model.state_dict().items()})
    before = conv1d_cuda.launches
    a, b = ed_loop.evaluate(cfg, gpu, data), ed_loop.evaluate(cfg, cpu, data)
    assert conv1d_cuda.launches == before + 4
    assert abs(a["loss"] - b["loss"]) <= 1e-4 * abs(b["loss"])
    assert (a["confusion"], a["n"]) == (b["confusion"], n) and gpu.model.training


# ---------------------------------------------------------------------------
# The population sweep on the card
# ---------------------------------------------------------------------------

SWEEP_KW = dict(max_notes=64, batch_size=8, noise_dim=16, latent_dim=8, gen_hidden=32, save_freq=1)
SWEEP_ED = dict(max_notes=64, notes_blocks=2, notes_hidden=32, mlp_hidden=(16,))


def _sweep_corpus(rng, n=8 * 7 + 3):
    """A SplitData at the small width above: at batch 8, one group of 5 and
    a 2-batch tail an epoch."""
    from melogan_torch.data.datasets import SplitData

    pitch = rng.uniform(20, 110, (n, 64))
    raw = np.stack([pitch, np.cumsum(rng.uniform(0, 1, (n, 64)), 1), rng.uniform(0, 3, (n, 64)),
                    rng.uniform(0, 127, (n, 64))], -1).astype(np.float32)
    emotions = np.array(["happy", "sad", "angry", "calm"])[rng.integers(0, 4, n)]
    return SplitData(raw, emotions, rng.normal(size=(n, 6)).astype(np.float32), [])


def _sweep(tmp_path, data, seeds, **kw):
    from melogan_torch.config import EDConfig
    from melogan_torch.train.sweep import sweep_gan

    return sweep_gan(GANConfig(**SWEEP_KW), EDConfig(**SWEEP_ED), data, seeds, workdir=str(tmp_path),
                     verbose=False, samples_per_emotion=1, device="cuda", **kw)


def _state_file(workdir):
    return workdir / "experiments" / "gan" / "sweep" / "sweep_state.ckpt"


def _same_state(a, b, what):
    for name in ("generator", "feature_encoder", "critic", "ed"):
        for (k, v), (_, w) in zip(getattr(a, name).state_dict().items(), getattr(b, name).state_dict().items()):
            assert torch.equal(v, w), f"{what}: {name}.{k}"
    for opt in ("opt_g", "opt_d"):
        oa, ob = getattr(a, opt), getattr(b, opt)
        for pa, pb in zip(oa.param_groups[0]["params"], ob.param_groups[0]["params"]):
            for k in ("exp_avg", "exp_avg_sq", "step"):
                assert torch.equal(oa.state[pa][k], ob.state[pb][k]), f"{what}: {opt} {k}"
    assert a.step == b.step and torch.equal(a.rng.get_state(), b.rng.get_state()), what


def test_sweep_members_on_card_are_solo_card_runs(cuda, rng, tmp_path):
    """K = 2 on the card, with a grid: each member, read back from the
    sweep's ``sweep_state.ckpt`` into fresh card states, equals a solo
    ``train()`` on the card with its seed and overrides, bit for bit (the
    training state turns ``cudnn.deterministic`` on), and both conv kernels
    and the decoder tail (the gates) launched."""
    import dataclasses

    from melogan_torch.config import EDConfig
    from melogan_torch.train import gan_loop, gan_step
    from melogan_torch.utils.checkpoint import load_checkpoint
    from melogan_torch.utils.weights import load_sweep_state

    data = _sweep_corpus(rng)
    grid = [{}, {"lr_g": 1e-4, "lambda_emotion": 0.5}]
    before = (conv1d_cuda.launches, convt1d_cuda.launches, decoder_tail_cuda.launches)
    report = _sweep(tmp_path / "sweep", data, [5, 5], epochs=2, hyper_grid=grid)
    assert conv1d_cuda.launches > before[0] and convt1d_cuda.launches > before[1]
    assert decoder_tail_cuda.launches == before[2] + 2  # one gate a member
    cfg = GANConfig(**SWEEP_KW)
    members = [gan_step.init_state(cfg, gan_step.build_models(cfg, EDConfig(**SWEEP_ED)), seed=5, device="cuda")
               for _ in grid]
    assert load_sweep_state(members, load_checkpoint(str(_state_file(tmp_path / "sweep")))) is None
    for k, over in enumerate(grid):
        solo, hist = gan_loop.train(dataclasses.replace(cfg, seed=5, **over), EDConfig(**SWEEP_ED), data,
                                    workdir=str(tmp_path / f"solo{k}"), epochs=2, verbose=False, device="cuda")
        _same_state(solo, members[k], f"member {k}")
        row = report["results"][k]["final"]
        assert all(row[key] == hist[key] for key in row if key != "epoch"), (row, hist)


def test_sweep_resume_on_card_is_bit_identical(cuda, rng, tmp_path):
    """2 epochs in one go against 1 epoch, then a resume to 2, on the card:
    the same curves, member finals and ``sweep_state.ckpt``, byte for byte."""
    data = _sweep_corpus(rng)
    straight = _sweep(tmp_path / "a", data, [3, 4], epochs=2)
    _sweep(tmp_path / "b", data, [3, 4], epochs=1)
    resumed = _sweep(tmp_path / "b", data, [3, 4], epochs=2, resume=True)
    for rs, rr in zip(straight["results"], resumed["results"]):
        assert rs["curve"] == rr["curve"]
        with open(rs["checkpoint"], "rb") as f, open(rr["checkpoint"], "rb") as g:
            assert f.read() == g.read()
    assert _state_file(tmp_path / "a").read_bytes() == _state_file(tmp_path / "b").read_bytes()


def test_sweep_halving_on_card(cuda, rng, tmp_path):
    """K = 4, rungs of 1 epoch, 3 epochs on the card: populations 4 → 2 → 1,
    the winner's curve over all 3 epochs, 4 + 2 + 1 gates (one
    ``decoder_tail`` launch each)."""
    data = _sweep_corpus(rng)
    before = decoder_tail_cuda.launches
    report = _sweep(tmp_path, data, [1, 2, 3, 4], epochs=3, halving=True, rung_epochs=1)
    assert decoder_tail_cuda.launches == before + 7
    assert [len(r["members"]) for r in report["rungs"]] == [4, 2]
    assert [sum(m["survived"] for m in r["members"]) for r in report["rungs"]] == [2, 1]
    (winner,) = report["results"]
    assert [row["epoch"] for row in winner["curve"]] == [1, 2, 3]
    assert all(np.isfinite(v) for row in winner["curve"] for v in row.values())


_FIRST_AND_LATER_STEP = """
import numpy as np, torch
from melogan_torch.config import EDConfig, GANConfig
from melogan_torch.train import gan_step
cfg = GANConfig(noise_dim=16, latent_dim=4, gen_hidden=32, batch_size=4, critic_iters=2)
ed = EDConfig(notes_hidden=32, mlp_hidden=(32, 16))
def run():
    state = gan_step.init_state(cfg, gan_step.build_models(cfg, ed), seed=42, device="cuda")
    rng = np.random.default_rng(0)
    k, b = cfg.critic_iters, cfg.batch_size
    batch = tuple(torch.as_tensor(a, device="cuda") for a in (
        rng.normal(size=(k, b, cfg.max_notes, 4)).astype(np.float32), rng.integers(0, 4, size=(k, b)),
        rng.normal(size=(k, b, cfg.latent_dim)).astype(np.float32), rng.normal(size=(k, b, 6)).astype(np.float32)))
    gan_step.make_train_steps(cfg).group(state, batch)
    return [p.detach().cpu() for m in (state.critic, state.generator, state.feature_encoder) for p in m.parameters()]
first, later = run(), run()
print("differ", [i for i, (a, b) in enumerate(zip(first, later)) if not torch.equal(a, b)])
"""


def test_first_group_step_of_a_process_is_a_later_ones(cuda):
    """ROADMAP C.10: in a fresh process, the first group step from a state
    and batches equals the same step taken later in that process, bit for
    bit. Before ``gan_step.number_forward_above_backward``, the first critic
    updates added the conv weights' gradient contributions in another order
    (the autograd node counters of the card's thread and the caller's
    overlapped), so a run resumed in a fresh process was not the run done in
    one go."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=repo + os.pathsep + os.environ.get("PYTHONPATH", ""))
    r = subprocess.run([sys.executable, "-c", _FIRST_AND_LATER_STEP], cwd=repo, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.strip().splitlines()[-1] == "differ []", r.stdout
