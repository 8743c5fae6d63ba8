"""The CUDA kernels of melogan_torch against their plain PyTorch versions.

Needs an NVIDIA GPU (sm_90a) and nvcc: the kernels have no interpret mode,
so every test here is marked ``cuda`` and skips without a card. This file
imports neither JAX nor the JAX package, so that it runs where JAX is not
installed:

    python -m pytest tests/test_torch_cuda.py --noconftest -q

Tolerance: kernel and plain version both sum in IEEE f32 (TF32 off), in
different orders, over at most 5·Cin products per output; 1e-4 absolute and
relative on O(1) outputs is about 100× that rounding.
"""
import numpy as np
import pytest
import torch

from melogan_torch.config import GANConfig
from melogan_torch.ops.convt import convt1d_cuda, convt1d_plain
from melogan_torch.ops.decoder import decoder_tail_cuda, decoder_tail_plain, fused_decoder_tail
from melogan_torch.sampling import Sampler

pytestmark = pytest.mark.cuda

CONVT_SHAPES = [
    (2, 16, 32, 16, 5, 2, 2, 1),
    (2, 32, 16, 8, 5, 2, 2, 1),
    (2, 20, 8, 4, 3, 2, 1, 1),
    (2, 20, 8, 4, 3, 1, 1, 0),
    (3, 8, 24, 12, 5, 2, 2, 1),
    (4, 64, 256, 128, 5, 2, 2, 1),
    # large enough for the tiled kernel (4 waves of blocks, Cout >= 64),
    # with float4 weights, scalar weights (Cout % 4 != 0) and stride 3
    (288, 64, 256, 128, 5, 2, 2, 1),
    (2048, 16, 32, 66, 5, 2, 2, 1),
    (1200, 20, 16, 64, 4, 3, 1, 2),
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


@pytest.mark.parametrize("b,m,widths", [
    (2, 16, (24, 16, 8, 4)),
    (3, 5, (8, 12, 8, 4)),  # M not a multiple of the 4-row tile
    (4, 64, (256, 128, 64, 4)),  # the main path's widths
])
def test_decoder_tail_kernel_matches_plain(cuda, rng, b, m, widths):
    x = _t(rng.normal(size=(b, m, widths[0])), cuda)
    stages = []
    for cin, cout in zip(widths[:-1], widths[1:]):
        stages.append((_t(rng.normal(size=(5, cin, cout)) / np.sqrt(5 * cin), cuda),
                       _t(rng.normal(size=(cout,)) * 0.1, cuda)))
    before = decoder_tail_cuda.launches
    out = fused_decoder_tail(x, stages)
    torch.cuda.synchronize()
    assert decoder_tail_cuda.launches == before + 1
    torch.testing.assert_close(out, decoder_tail_plain(x, stages), atol=1e-4, rtol=1e-4)


def test_kernels_refuse_what_they_do_not_take(cuda):
    x = torch.zeros((2, 8, 6), device=cuda)
    stages = [(torch.zeros((5, 6, 8), device=cuda), torch.zeros(8, device=cuda))] * 3
    with pytest.raises(ValueError, match="multiples of 4"):
        decoder_tail_cuda(x, stages)
    with pytest.raises(ValueError, match="float32"):
        convt1d_cuda(x.double(), torch.zeros((5, 6, 4), device=cuda, dtype=torch.float64))
    with pytest.raises(ValueError, match="contiguous"):
        convt1d_cuda(x.transpose(1, 2).contiguous().transpose(1, 2),
                     torch.zeros((5, 6, 4), device=cuda))
    w = torch.zeros((5, 6, 4), device=cuda, requires_grad=True)
    with pytest.raises(NotImplementedError):
        convt1d_cuda(x, w)


def test_sampler_on_card_matches_cpu(cuda, rng):
    """The whole slice on the card (kernels) against the port's CPU path
    (plain versions), same weights and inputs, both decoder paths."""
    for cfg in (GANConfig(), GANConfig(max_notes=500)):
        gpu = Sampler(cfg, seed=0, device="cuda")
        cpu = Sampler(cfg, gen_variables=gpu.generator.state_dict(),
                      fe_variables=gpu.feature_encoder.state_dict(), device="cpu")
        feats = rng.normal(size=(4, 6)).astype(np.float32)
        noise = rng.normal(size=(4, cfg.noise_dim)).astype(np.float32)
        a, b = gpu.sample_from(feats, noise), cpu.sample_from(feats, noise)
        assert np.abs(a - b).max() <= 1e-4 * np.abs(b).max()
