"""The port's kernel modules against the JAX package.

On the CPU the port's wrappers run each kernel's plain PyTorch version; the
JAX side runs its XLA reference and its Pallas kernel in interpret mode.
Inputs come from a seeded numpy generator and cross as numpy arrays.

Tolerances: both sides accumulate in IEEE f32 (JAX at Precision.HIGHEST,
torch CPU matmuls in f32) over at most 5·Cin products in a different order,
so they agree to a few f32 ulps of the output scale; 2e-5 absolute on O(1)
outputs leaves a 10× margin and is 10× tighter than the JAX package's own
Pallas-vs-XLA tests (2e-4).

The CUDA kernels themselves are held against these plain versions on the
card by ``tests/test_torch_cuda.py``.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from melogan_tpu.ops.conv import _xla_conv_transpose1d
from melogan_tpu.ops.pallas.conv1d import pallas_conv_transpose1d
from melogan_tpu.ops.pallas import decoder as jax_decoder

from melogan_torch.ops import _build
from melogan_torch.ops.conv import conv_transpose1d
from melogan_torch.ops.convt import convt1d_cuda, convt1d_plain, convt_flops, convt_taps
from melogan_torch.ops.decoder import (
    decoder_tail_cuda,
    decoder_tail_flops,
    decoder_tail_plain,
    fold_bn_affine,
    fused_decoder_tail,
    taps,
)

HI = jax.lax.Precision.HIGHEST
ATOL = 2e-5

CONVT_SHAPES = [
    # (b, l, cin, cout, k, s, p, op): tests/test_ops.py's shapes ...
    (2, 16, 32, 16, 5, 2, 2, 1),
    (2, 32, 16, 8, 5, 2, 2, 1),
    (2, 20, 8, 4, 3, 2, 1, 1),
    (2, 20, 8, 4, 3, 1, 1, 0),
    # ... and the decoder's k5 s2 p2 op1 at narrow widths
    (3, 8, 24, 12, 5, 2, 2, 1),
]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32))


@pytest.mark.parametrize("b,l,cin,cout,k,s,p,op", CONVT_SHAPES)
def test_convt_plain_matches_jax_xla_and_pallas(rng, b, l, cin, cout, k, s, p, op):
    x = rng.normal(size=(b, l, cin)).astype(np.float32)
    w = (rng.normal(size=(k, cin, cout)) * 0.1).astype(np.float32)
    bias = (rng.normal(size=(cout,)) * 0.1).astype(np.float32)
    ours = convt1d_plain(_t(x), _t(w), _t(bias), s, p, op).numpy()
    xla = np.asarray(_xla_conv_transpose1d(jnp.asarray(x), jnp.asarray(w), s, p, op, precision=HI))
    pallas = np.asarray(pallas_conv_transpose1d(jnp.asarray(x), jnp.asarray(w), s, p, op))
    assert ours.shape == xla.shape == pallas.shape
    np.testing.assert_allclose(ours, xla + bias, atol=ATOL, rtol=0)
    np.testing.assert_allclose(ours, pallas + bias, atol=ATOL, rtol=0)


def test_convt_taps_match_jax():
    from melogan_tpu.ops.pallas.conv1d import _convt_taps

    for k, s, p in [(5, 2, 2), (3, 2, 1), (3, 1, 1), (4, 3, 0)]:
        for r in range(s):
            assert convt_taps(k, s, p, r) == _convt_taps(k, s, p, r)
    for r in range(2):
        assert taps(r) == jax_decoder._taps(r)


@pytest.mark.parametrize("b,l,cin,cout,k,s,p,op", CONVT_SHAPES)
def test_conv_front_end_takes_plain_path_on_cpu(rng, b, l, cin, cout, k, s, p, op):
    x = _t(rng.normal(size=(b, l, cin)))
    w = _t(rng.normal(size=(k, cin, cout)) * 0.1)
    before = convt1d_cuda.launches
    out = conv_transpose1d(x, w, s, p, op)
    torch.testing.assert_close(out, convt1d_plain(x, w, None, s, p, op), atol=0, rtol=0)
    assert convt1d_cuda.launches == before  # the CPU never counts a launch


def test_convt_plain_is_differentiable_like_native(rng):
    """The plain version is torch autograd all the way; its gradients match
    the native conv's (the reference for the training slice's backward)."""
    x = _t(rng.normal(size=(2, 16, 8))).requires_grad_()
    w = _t(rng.normal(size=(5, 8, 4)) * 0.1).requires_grad_()
    (convt1d_plain(x, w, None, 2, 2, 1).sin().sum()).backward()
    gx, gw = x.grad.clone(), w.grad.clone()
    x.grad = w.grad = None
    native = torch.nn.functional.conv_transpose1d(
        x.transpose(1, 2), w.permute(1, 2, 0), stride=2, padding=2, output_padding=1)
    native.transpose(1, 2).sin().sum().backward()
    torch.testing.assert_close(gx, x.grad, atol=ATOL, rtol=0)
    torch.testing.assert_close(gw, w.grad, atol=ATOL, rtol=0)


def test_wrappers_refuse_other_devices(rng):
    """No silent fallback: a device that is neither CUDA nor the CPU raises,
    and the CUDA wrappers refuse CPU tensors."""
    x = torch.zeros((1, 4, 8), device="meta")
    w = torch.zeros((5, 8, 4), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        conv_transpose1d(x, w, 2, 2, 1)
    with pytest.raises(ValueError, match="unsupported device"):
        fused_decoder_tail(x, [(w, torch.zeros(4, device="meta"))] * 3)
    xc = _t(rng.normal(size=(1, 4, 8)))
    with pytest.raises(ValueError, match="CUDA tensors"):
        convt1d_cuda(xc, _t(rng.normal(size=(5, 8, 4))))
    with pytest.raises(ValueError, match="CUDA tensors"):
        decoder_tail_cuda(xc, [])


def _stages(rng, widths, scale=0.1):
    out = []
    for cin, cout in zip(widths[:-1], widths[1:]):
        w = (rng.normal(size=(5, cin, cout)) * scale).astype(np.float32)
        b = (rng.normal(size=(cout,)) * scale).astype(np.float32)
        out.append((w, b))
    return out


@pytest.mark.parametrize("b,m,widths", [(2, 16, (24, 16, 8, 4)), (3, 5, (8, 12, 8, 4))])
def test_decoder_tail_plain_matches_jax_fused(rng, b, m, widths):
    x = rng.normal(size=(b, m, widths[0])).astype(np.float32)
    stages = _stages(rng, widths)
    ours = decoder_tail_plain(_t(x), [(_t(w), _t(bb)) for w, bb in stages]).numpy()
    theirs = np.asarray(jax_decoder.fused_decoder_tail(
        jnp.asarray(x), [(jnp.asarray(w), jnp.asarray(bb)) for w, bb in stages]))
    assert ours.shape == theirs.shape == (b, 8 * m, widths[-1])
    np.testing.assert_allclose(ours, theirs, atol=ATOL, rtol=0)


def test_decoder_tail_plain_matches_layered_plain_convs(rng):
    x = _t(rng.normal(size=(2, 8, 16)))
    stages = [(_t(w), _t(b)) for w, b in _stages(rng, (16, 12, 8, 4))]
    y = x
    for i, (w, b) in enumerate(stages):
        y = convt1d_plain(y, w, b, 2, 2, 1)
        if i < 2:
            y = torch.relu(y)
    torch.testing.assert_close(decoder_tail_plain(x, stages), y, atol=ATOL, rtol=0)


def test_fold_bn_affine_matches_jax(rng):
    cin, cout = 8, 6
    w = rng.normal(size=(5, cin, cout)).astype(np.float32)
    b = rng.normal(size=(cout,)).astype(np.float32)
    mean = rng.normal(size=(cout,)).astype(np.float32)
    var = rng.uniform(0.5, 2.0, size=(cout,)).astype(np.float32)
    scale = rng.normal(size=(cout,)).astype(np.float32)
    bias = rng.normal(size=(cout,)).astype(np.float32)
    wf, bf = fold_bn_affine(*map(_t, (w, b, mean, var, scale, bias)))
    jw, jb = jax_decoder.fold_bn_affine(*map(jnp.asarray, (w, b, mean, var, scale, bias)))
    # elementwise: one rsqrt and two roundings each side
    np.testing.assert_allclose(wf.numpy(), np.asarray(jw), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(bf.numpy(), np.asarray(jb), rtol=1e-6, atol=1e-6)


def test_flop_counts():
    """Valid taps only: 5 per input row, less the three boundary taps that
    fall outside the signal (x[-1] once, x[L] twice); the fused tail counts
    what the three layered convs count."""
    widths = (256, 128, 64, 4)
    want = 2 * ((5 * 64 - 3) * 256 * 128 + (5 * 128 - 3) * 128 * 64 + (5 * 256 - 3) * 64 * 4)
    assert decoder_tail_flops(1, 64, widths) == want
    layered = sum(convt_flops(3, l, cin, cout, 5, 2, 2, 1)
                  for l, cin, cout in [(64, 256, 128), (128, 128, 64), (256, 64, 4)])
    assert layered == decoder_tail_flops(3, 64, widths)


def test_build_command_targets_hopper(tmp_path):
    cmd = _build.nvcc_command("nvcc", "convt1d", tmp_path / "lib.so")
    joined = " ".join(cmd)
    assert "-gencode arch=compute_90a,code=sm_90a" in joined
    assert "-shared" in cmd and "-O3" in cmd and "-fPIC" in cmd
    assert cmd[-1].endswith("csrc/convt1d.cu")
    assert _build.kernel_names() == ["conv1d", "convt1d", "decoder_tail"]


def test_build_rebuilds_when_source_is_newer(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    assert _build.is_stale("convt1d")  # no library yet
    lib = _build.library_path("convt1d")
    lib.write_bytes(b"")
    src_mtime = max(p.stat().st_mtime for p in _build.sources("convt1d"))  # .cu and headers
    import os

    os.utime(lib, (src_mtime + 10, src_mtime + 10))
    assert not _build.is_stale("convt1d")
    os.utime(lib, (src_mtime - 10, src_mtime - 10))
    assert _build.is_stale("convt1d")


def test_build_without_nvcc_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "find_nvcc", lambda: (_ for _ in ()).throw(RuntimeError("nvcc not found")))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build_all(["convt1d"])
