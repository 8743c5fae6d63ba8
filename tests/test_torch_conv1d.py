"""The port's conv1d and both differentiable conv Functions against the JAX
package (CPU).

On the CPU ``ops.conv.conv1d`` / ``conv_transpose1d`` run the kernels'
plain PyTorch versions forward, and each backward runs the other conv's
plain version for dx and a matmul per tap for dw; the JAX side runs
``pallas_conv1d`` / ``pallas_conv_transpose1d`` in interpret mode (their
``custom_vjp`` backward is XLA's conv VJP) and XLA's own conv. The CUDA
kernel is held against ``conv1d_plain`` on the card by
``tests/test_torch_cuda.py``.

Tolerance: both sides accumulate in IEEE f32 over at most K·C products per
output in different orders, a few f32 ulps of O(1) outputs; 2e-5 absolute
on O(1) values (1e-5 relative to the scale for gradients, which sum over
B·L more terms) is 10× tighter than the JAX package's own Pallas-vs-XLA
tests.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from melogan_tpu.ops.conv import _xla_conv1d
from melogan_tpu.ops.pallas.conv1d import pallas_conv1d, pallas_conv_transpose1d

from melogan_torch.ops import conv as conv_ops
from melogan_torch.ops.conv1d import conv1d_cuda, conv1d_flops, conv1d_plain, conv_out_len
from melogan_torch.ops.convt import convt1d_cuda

HI = jax.lax.Precision.HIGHEST
ATOL = 2e-5
GRAD_REL = 1e-5

CONV1D_SHAPES = [
    # (b, l, cin, cout, k, s, p): the ED's layers at narrow widths (k5 p2
    # from the 4 note channels, then k3 p1), the VAE encoder's k5 s2 p2, and
    # odd lengths, stride 3 and no padding
    (2, 64, 4, 16, 5, 1, 2),
    (2, 64, 16, 32, 3, 1, 1),
    (3, 33, 32, 32, 3, 1, 1),
    (2, 64, 4, 16, 5, 2, 2),
    (2, 37, 8, 12, 5, 2, 2),
    (2, 20, 6, 5, 4, 3, 0),
]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32))


@pytest.mark.parametrize("b,l,cin,cout,k,s,p", CONV1D_SHAPES)
def test_conv1d_plain_matches_jax_xla_and_pallas(rng, b, l, cin, cout, k, s, p):
    x = rng.normal(size=(b, l, cin)).astype(np.float32)
    w = (rng.normal(size=(k, cin, cout)) / np.sqrt(k * cin)).astype(np.float32)
    bias = (rng.normal(size=(cout,)) * 0.1).astype(np.float32)
    ours = conv1d_plain(_t(x), _t(w), _t(bias), s, p).numpy()
    xla = np.asarray(_xla_conv1d(jnp.asarray(x), jnp.asarray(w), s, p, precision=HI))
    pallas = np.asarray(pallas_conv1d(jnp.asarray(x), jnp.asarray(w), s, p))
    assert ours.shape == xla.shape == pallas.shape == (b, conv_out_len(l, k, s, p), cout)
    np.testing.assert_allclose(ours, xla + bias, atol=ATOL, rtol=0)
    np.testing.assert_allclose(ours, pallas + bias, atol=ATOL, rtol=0)


def _close(ours, theirs, what):
    theirs = np.asarray(theirs)
    scale = float(np.abs(theirs).max())
    err = float(np.abs(ours.detach().numpy() - theirs).max())
    assert err <= GRAD_REL * scale, f"{what}: {err:.3e} > {GRAD_REL} x {scale:.3e}"


GRAD_SHAPES = [
    # (b, l, cin, cout, k, s, p, op, transposed)
    (2, 64, 4, 16, 5, 1, 2, 0, False),  # ED first layer: dx is a convT to 4 channels
    (2, 64, 16, 32, 3, 1, 1, 0, False),
    (2, 64, 4, 16, 5, 2, 2, 0, False),  # VAE geometry
    (2, 63, 8, 12, 5, 2, 2, 0, False),  # (L + 2p − K) odd: dx needs output_padding 1
    (2, 16, 32, 16, 5, 2, 2, 1, True),  # the generator's k5 s2 p2 op1 convTs
    (2, 32, 16, 4, 5, 2, 2, 1, True),
    (2, 20, 8, 4, 3, 1, 1, 0, True),
]


@pytest.mark.parametrize("b,l,cin,cout,k,s,p,op,transposed", GRAD_SHAPES)
def test_conv_functions_match_jax_vjp(rng, b, l, cin, cout, k, s, p, op, transposed):
    """dx and dw of ``ops.conv`` against ``jax.vjp`` of the Pallas ops, and
    db against the cotangent's sum."""
    x = rng.normal(size=(b, l, cin)).astype(np.float32)
    w = (rng.normal(size=(k, cin, cout)) / np.sqrt(k * cin)).astype(np.float32)
    bias = (rng.normal(size=(cout,)) * 0.1).astype(np.float32)
    if transposed:
        def jfn(x_, w_):
            return pallas_conv_transpose1d(x_, w_, s, p, op)

        def tfn(x_, w_, b_):
            return conv_ops.conv_transpose1d(x_, w_, s, p, op, bias=b_)
    else:
        def jfn(x_, w_):
            return pallas_conv1d(x_, w_, s, p)

        def tfn(x_, w_, b_):
            return conv_ops.conv1d(x_, w_, s, p, bias=b_)
    jy, vjp = jax.vjp(jfn, jnp.asarray(x), jnp.asarray(w))
    g = rng.normal(size=jy.shape).astype(np.float32)
    jdx, jdw = vjp(jnp.asarray(g))

    tx, tw, tb = (_t(a).requires_grad_() for a in (x, w, bias))
    y = tfn(tx, tw, tb)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy) + bias, atol=ATOL, rtol=0)
    before = (conv1d_cuda.launches, convt1d_cuda.launches)
    (y * _t(g)).sum().backward()
    assert (conv1d_cuda.launches, convt1d_cuda.launches) == before  # the CPU counts none
    _close(tx.grad, jdx, "dx")
    _close(tw.grad, jdw, "dw")
    np.testing.assert_allclose(tb.grad.numpy(), g.sum(axis=(0, 1)), rtol=1e-5, atol=1e-5)


def test_backward_computes_only_what_is_needed(rng):
    """A frozen weight (the ED inside the G loss) gets no dw, and an input
    that needs no gradient gets no dx."""
    x = _t(rng.normal(size=(2, 16, 4))).requires_grad_()
    w = _t(rng.normal(size=(3, 4, 8)))
    conv_ops.conv1d(x, w, 1, 1).sum().backward()
    assert x.grad is not None and w.grad is None
    x2 = _t(rng.normal(size=(2, 16, 4)))
    w2 = _t(rng.normal(size=(3, 4, 8))).requires_grad_()
    conv_ops.conv_transpose1d(x2, w2, 2, 1, 1).sum().backward()
    assert w2.grad is not None and x2.grad is None


def test_gradients_of_non_contiguous_views(rng):
    """Operands that are permuted views (the modules' torch-layout weights)
    and gradients that arrive non-contiguous give the contiguous results."""
    x = _t(rng.normal(size=(2, 24, 6)))
    w_oik = _t(rng.normal(size=(8, 6, 3)) * 0.3).requires_grad_()
    y = conv_ops.conv1d(x, w_oik.permute(2, 1, 0), 1, 1)
    (y.transpose(0, 1) * 2).sum().backward()
    w_ref = w_oik.detach().clone().requires_grad_()
    torch.nn.functional.conv1d(x.transpose(1, 2), w_ref, padding=1).mul(2).sum().backward()
    torch.testing.assert_close(w_oik.grad, w_ref.grad, atol=1e-4, rtol=1e-5)


def test_conv1d_flops_count_valid_taps():
    # k3 p1 over L rows: 3 taps per row less the two that fall on the padding
    assert conv1d_flops(2, 512, 64, 128, 3, 1, 1) == 2 * 2 * (3 * 512 - 2) * 64 * 128
    # k5 p2 s1: 5 per row less 2 + 1 at each end
    assert conv1d_flops(1, 512, 4, 64, 5, 1, 2) == 2 * (5 * 512 - 6) * 4 * 64


def test_conv1d_wrappers_refuse_other_devices(rng):
    x = torch.zeros((1, 8, 4), device="meta")
    w = torch.zeros((3, 4, 8), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        conv_ops.conv1d(x, w, 1, 1)
    with pytest.raises(ValueError, match="CUDA tensors"):
        conv1d_cuda(_t(rng.normal(size=(1, 8, 4))), _t(rng.normal(size=(3, 4, 8))))
