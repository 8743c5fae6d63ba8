"""Building blocks of the port's models, in PyTorch idiom.

Ports of ``melogan_tpu/models/layers.py`` where the port needs its own code:
the GAN init, the torch-default init drawn from a ``torch.Generator``,
``Linear`` and ``SpectralNormLinear``, ``Conv1d`` and ``ConvTranspose1d``
over channels-last inputs, ``Dropout`` with explicit randomness,
``trim_or_pad_length``, ``adaptive_avg_pool_1`` and the precision switch
(``melogan_torch/precision.py``, re-exported here). Under the ``"fast"``
precision every layer's products take bf16-rounded operands, forward and
backward, and sum in f32.
BatchNorm, LayerNorm, exact-erf GELU and LeakyReLU(0.2) are native
``nn.BatchNorm1d``, ``nn.LayerNorm``, ``nn.GELU()`` and ``nn.LeakyReLU``:
the JAX layers copy their semantics. Layout at the model's convolutions is
(B, L, C), channels last, as in the JAX package.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn
import torch.nn.functional as F

from melogan_torch.ops.conv import conv1d, conv_transpose1d
from melogan_torch.parallel.mesh import active_mesh, all_reduce
from melogan_torch.precision import (  # noqa: F401  (the JAX module's names)
    bf16_products,
    default_precision,
    round_bf16,
    set_default_precision,
)


class _RoundOperand(torch.autograd.Function):
    """R: forward rounds to bf16; backward passes the gradient through as
    ``_RoundGrad``, so that a derivative of that gradient is rounded in turn.
    Each is the other's backward: differentiable to any order (the WGAN-GP
    penalty differentiates the critic's input gradient again)."""

    @staticmethod
    def forward(ctx, x):
        return round_bf16(x)

    @staticmethod
    def backward(ctx, g):
        return _RoundGrad.apply(g)


class _RoundGrad(torch.autograd.Function):
    """G: the identity forward; backward rounds the incoming gradient to bf16
    (as ``_RoundOperand``), so a product's cotangent enters the backward
    products rounded, as JAX's transposed dots and convs at DEFAULT take it."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _RoundOperand.apply(g)


def bf16_product(fn, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """G(fn(R(x), R(w))): the product ``fn`` (a matmul or a conv, no bias)
    on bf16-rounded operands, summed in f32, whose input and weight
    gradients are the products r(g)·r(w) and r(g)ᵀ·r(x)."""
    return _RoundGrad.apply(fn(_RoundOperand.apply(x), _RoundOperand.apply(w)))


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
    running stats updated in train mode exactly as over (B, C, L). In train
    mode inside a data-parallel step (``parallel.mesh.data_parallel``) the
    statistics are those of the global batch (``_CrossRankBatchNorm``);
    otherwise this is ``nn.BatchNorm1d`` itself."""
    b, l, c = x.shape
    mesh = active_mesh()
    if bn.training and mesh is not None:
        return _cross_rank_batch_norm(bn, x.reshape(b * l, c), mesh).reshape(b, l, c)
    return bn(x.reshape(b * l, c)).reshape(b, l, c)


def _cross_rank_batch_norm(bn: nn.BatchNorm1d, x: torch.Tensor, mesh) -> torch.Tensor:
    """Train-mode ``bn`` (affine) over rows ``x`` (M, C) with the
    statistics of the rows of every rank, as JAX's ``TorchBatchNorm`` under
    GSPMD (``melogan_tpu/models/layers.py:302-313``): one ``all_reduce`` of
    the per-channel count, sum and sum of squares in float64 gives the
    global mean and biased variance; the running stats take the global
    unbiased variance and ``num_batches_tracked`` advances (the folded-BN
    cache of ``models/gan.py`` keys on it). Also under ``no_grad``."""
    bn.num_batches_tracked.add_(1)
    momentum = bn.momentum if bn.momentum is not None else 1.0 / float(bn.num_batches_tracked)
    y, mean, var, n = _CrossRankBatchNorm.apply(x, bn.weight, bn.bias, bn.eps, mesh)
    with torch.no_grad():
        bn.running_mean.mul_(1.0 - momentum).add_(mean * momentum)
        bn.running_var.mul_(1.0 - momentum).add_(var * (n / (n - 1.0)) * momentum)
    return y


class _CrossRankBatchNorm(torch.autograd.Function):
    """(x (M, C), weight, bias) → (y, global mean, global biased variance,
    global row count as a 0-d float64 tensor). Backward, once
    differentiable: one ``all_reduce`` of the two per-channel sums Σdy and
    Σdy·x̂, then dx = γ·invstd·(dy − Σdy/n − x̂·Σdy·x̂/n); dγ and dβ are this
    rank's own sums, which the optimizer's gradient mean over the ranks
    completes."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps, mesh):
        c = x.shape[1]
        xd = x.detach().to(torch.float64)
        stats = torch.cat([xd.new_full((1,), float(x.shape[0])), xd.sum(0), xd.square().sum(0)])
        all_reduce(stats, mesh.data_group)
        n = stats[0]
        mean64 = stats[1:1 + c] / n
        var64 = torch.clamp(stats[1 + c:] / n - mean64.square(), min=0.0)
        mean, var = mean64.to(x.dtype), var64.to(x.dtype)
        invstd = torch.rsqrt(var + eps)
        xhat = (x - mean) * invstd
        ctx.save_for_backward(xhat, invstd, weight, n)
        ctx.mesh = mesh
        ctx.mark_non_differentiable(mean, var, n)
        return xhat * weight + bias, mean, var, n

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dy, _dmean, _dvar, _dn):
        xhat, invstd, weight, n = ctx.saved_tensors
        c = dy.shape[1]
        local = torch.cat([dy.sum(0), (dy * xhat).sum(0)])
        sums = local.clone()
        all_reduce(sums, ctx.mesh.data_group)
        n = n.to(dy.dtype)
        dx = invstd * weight * (dy - sums[:c] / n - xhat * (sums[c:] / n))
        return dx, local[c:], local[:c], None, None


def trim_or_pad_length(x: torch.Tensor, target_len: int) -> torch.Tensor:
    """Trim or zero-pad the length axis of (B, L, C) to ``target_len``."""
    cur = x.shape[-2]
    if cur > target_len:
        return x[..., :target_len, :]
    if cur < target_len:
        return F.pad(x, (0, 0, 0, target_len - cur))
    return x


class Linear(nn.Linear):
    """``nn.Linear`` (names ``weight`` (out, in) and ``bias``, so state dicts
    load strictly) that follows the precision switch: under ``"fast"`` it
    computes G(R(x)·R(W)ᵀ) + b (``bf16_product``), the TPU's one bf16 pass
    of the JAX ``TorchLinear`` at DEFAULT, in f32 otherwise. ``tp``: the
    tensor-parallel role that ``parallel.tensor.place_state`` gives it (its
    weight then this rank's block), None otherwise."""

    tp = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.tp(x, self._product, self.bias) if self.tp is not None else self._product(x, self.bias)

    def _product(self, x: torch.Tensor, bias: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self.linear(x, self.weight, bias)

    def linear(self, x: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor]) -> torch.Tensor:
        """x·wᵀ + bias at this thread's precision."""
        if bf16_products():
            y = bf16_product(F.linear, x, w)
            return y if bias is None else y + bias
        return F.linear(x, w, bias)


class SpectralNormLinear(Linear):
    """Linear with spectral normalization: the JAX ``SpectralNormLinear``
    (reference ed_model.py:28-33, feature_encoder.py:22-29).

    ``weight`` (out, in), ``bias`` and the buffer ``u`` (out,), the left
    singular vector estimate. Every forward, in eval mode too, takes one
    power-iteration step in f32, v = Wᵀu/(‖Wᵀu‖ + eps), u' = Wv/(‖Wv‖ + eps),
    σ = v·(Wᵀu'), and computes x·(W/max(σ, eps))ᵀ + b with σ a constant
    (no gradient), through ``Linear`` (so under ``"fast"`` the product is
    bf16). ``u`` takes u' in train mode only. Not
    ``torch.nn.utils.spectral_norm``: that one skips the iteration in eval
    mode and lets σ carry a gradient. ``u`` starts as a standard normal draw
    from a generator seeded 0, as the JAX layer draws it from
    ``PRNGKey(0)`` (another stream: the weight bridge carries ``u`` across)."""

    def __init__(self, in_features: int, out_features: int, eps: float = 1e-12):
        super().__init__(in_features, out_features)
        self.eps = float(eps)
        self.register_buffer(
            "u", torch.randn((out_features,), generator=torch.Generator().manual_seed(0)))

    def sigma(self, update: bool = False) -> torch.Tensor:
        """One power-iteration step: σ, and with ``update`` u ← u'."""
        with torch.no_grad():
            w = self.weight
            v = w.t() @ self.u
            v = v / (torch.linalg.vector_norm(v) + self.eps)
            u_new = w @ v
            u_new = u_new / (torch.linalg.vector_norm(u_new) + self.eps)
            sigma = v @ (w.t() @ u_new)
            if update:
                self.u.copy_(u_new)
        return sigma

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.linear(x, self.weight / torch.clamp(self.sigma(update=self.training), min=self.eps),
                           self.bias)


class Conv1d(nn.Conv1d):
    """1-D convolution over (B, L, C) with torch Conv1d geometry and the
    torch ``(Cout, Cin, K)`` weight, so reference state dicts load strictly.

    By default it computes through ``ops.conv.conv1d`` (the hand-written
    kernel on the card, its plain version on the CPU, both differentiable
    once). ``native=True`` pins it to ``F.conv1d`` with cuDNN in IEEE f32
    (TF32 off): the counterpart of the JAX layer's ``pallas=False``, for the
    WGAN-GP critic, whose gradient penalty needs a second derivative. Under
    the ``"fast"`` precision the pinned conv is ``bf16_product`` around
    ``F.conv1d``, then the bias: bf16 operands at every derivative order, as
    XLA's conv at DEFAULT. ``tp``: the tensor-parallel role, as
    ``Linear``'s; either route then runs on this rank's channel block.
    """

    tp = None

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, padding: int = 0, bias: bool = True, native: bool = False):
        super().__init__(in_channels, out_channels, kernel_size, stride=stride,
                         padding=padding, bias=bias)
        self.native = native

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.tp(x, self._product, self.bias) if self.tp is not None else self._product(x, self.bias)

    def _product(self, x: torch.Tensor, bias: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The conv plus ``bias`` (None: none), on this layer's route."""
        s, p = self.stride[0], self.padding[0]
        if self.native:
            with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
                if bf16_products():
                    y = bf16_product(lambda x_, w_: F.conv1d(x_, w_, None, s, p),
                                     x.transpose(1, 2), self.weight)
                    if bias is not None:
                        y = y + bias[:, None]
                else:
                    y = F.conv1d(x.transpose(1, 2), self.weight, bias, s, p)
            return y.transpose(1, 2)
        return conv1d(x, self.weight.permute(2, 1, 0), s, p, bias=bias)


class ConvTranspose1d(nn.ConvTranspose1d):
    """Transposed 1-D convolution over (B, L, C) with torch ConvTranspose1d
    geometry and the torch ``(Cin, Cout, K)`` weight, so reference state
    dicts load strictly. It always computes through
    ``ops.conv.conv_transpose1d``: the hand-written kernel on the card, its
    plain version on the CPU, both differentiable once. ``tp``: the
    tensor-parallel role, as ``Linear``'s."""

    tp = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.tp(x, self._product, self.bias) if self.tp is not None else self._product(x, self.bias)

    def _product(self, x: torch.Tensor, bias: Optional[torch.Tensor] = None) -> torch.Tensor:
        return conv_transpose1d(x, self.weight.permute(2, 0, 1), self.stride[0], self.padding[0],
                                self.output_padding[0], bias=bias)


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
