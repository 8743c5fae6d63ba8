"""Tensor parallelism of the port: a WGAN-GP state split over a mesh's
model axis, and the collectives inside its layers.

The JAX package places each parameter with ``partition_params`` and lets
GSPMD insert the collectives (``melogan_tpu/parallel/mesh.py:111-162``).
The port makes them itself, with ``all_reduce`` alone (the one reduction
gloo offers for CUDA tensors besides ``broadcast``), over the model axis
of a ``make_mesh(model_parallel=k)`` mesh:

- ``plan``: JAX's rule (``mesh.partition_params``) on the flax layout. A
  parameter with at least two dimensions, one of them ≥ ``min_dim``,
  splits its widest flax dimension (the first of a tie); a split that does
  not divide the model axis replicates. The bridge's ``flax_axes`` turns
  that flax dimension into the torch one, so a (256, 256) Linear splits
  its input, as JAX's kernel (in, out) does, though torch's weight is
  (out, in).
- ``place_layer``: keeps this rank's block of a layer's weight and gives
  the layer its role; ``place_state`` does so for every weight the plan
  splits, and keeps the block of its Adam moments and EMA stream.
- ``gather_state``: the whole state dicts on every rank.
- Four conjugate ``torch.autograd.Function``s, each of whose backward is
  its conjugate's ``apply``, so any derivative order works (the critic's
  gradient penalty differentiates its input gradient again): ``copy``
  (identity; backward an all-reduce), ``reduce`` (all-reduce sum; backward
  the identity), ``split`` (this rank's block of the last dimension;
  backward a gather) and ``gather`` (the blocks joined along the last
  dimension, as an all-reduce of a zero-padded buffer; backward the block).
- ``Split``: a layer's role. Column-parallel (the output channels split):
  ``copy``, the local product without bias, ``gather``, then the bias.
  Row-parallel (the input channels split): ``split``, the local product
  without bias, ``reduce``, then the bias, added once after the sum.

Every collective runs inside a ``tp.all_reduce`` profiler span, the twin of
``dp.all_reduce``. The data axis is the step's own (``parallel/mesh.py``):
gradients and metrics are averaged over the ranks that share this rank's
model index, and draws are sliced by the data index, so model ranks that
share a data index draw alike.
"""
from __future__ import annotations

from dataclasses import dataclass
from types import SimpleNamespace
from typing import Any, Dict, Mapping, NamedTuple, Optional

import torch
import torch.distributed as dist
from torch import nn

from melogan_torch.parallel.mesh import Mesh, partition_params
from melogan_torch.utils.profiling import span
from melogan_torch.utils.weights import flax_axes

MODULES = ("generator", "feature_encoder", "critic", "ed")


def all_reduce(t: torch.Tensor, group) -> None:
    """``dist.all_reduce`` (sum, in place) inside a ``tp.all_reduce`` span
    (``utils/profiling.py``)."""
    with span("tp.all_reduce"):
        dist.all_reduce(t, group=group)


def _summed(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    out = x.detach().clone(memory_format=torch.contiguous_format)
    all_reduce(out, mesh.model_group)
    return out


def _block(x: torch.Tensor, dim: int, mesh: Mesh) -> torch.Tensor:
    """This rank's contiguous block of ``x`` along ``dim``."""
    c = x.shape[dim] // mesh.model
    return x.narrow(dim, mesh.model_rank * c, c).contiguous()


def _joined(x: torch.Tensor, dim: int, mesh: Mesh) -> torch.Tensor:
    """Every rank's block of ``dim`` joined: the block in its place in a
    zero buffer, summed over the model axis (exact: each element is one
    rank's value plus zeros)."""
    dim = dim % x.dim()
    c = x.shape[dim]
    shape = list(x.shape)
    shape[dim] = c * mesh.model
    buf = x.new_zeros(shape)
    buf.narrow(dim, mesh.model_rank * c, c).copy_(x)
    all_reduce(buf, mesh.model_group)
    return buf


class _Copy(torch.autograd.Function):
    """Forward the identity; backward the sum over the model axis."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _Reduce.apply(g, ctx.mesh), None


class _Reduce(torch.autograd.Function):
    """Forward the sum over the model axis; backward the identity."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return _summed(x, mesh)

    @staticmethod
    def backward(ctx, g):
        return _Copy.apply(g, ctx.mesh), None


class _Split(torch.autograd.Function):
    """Forward this rank's block of the last dimension (contiguous);
    backward the blocks gathered."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return _block(x, -1, mesh)

    @staticmethod
    def backward(ctx, g):
        return _Gather.apply(g, ctx.mesh), None


class _Gather(torch.autograd.Function):
    """Forward the blocks joined along the last dimension; backward this
    rank's block."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return _joined(x.detach(), -1, mesh)

    @staticmethod
    def backward(ctx, g):
        return _Split.apply(g, ctx.mesh), None


def copy(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    return _Copy.apply(x, mesh)


def reduce(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    return _Reduce.apply(x, mesh)


def split(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    return _Split.apply(x, mesh)


def gather(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    return _Gather.apply(x, mesh)


@dataclass(frozen=True, eq=False)
class Split:
    """A layer's tensor-parallel role over ``mesh``'s model axis:
    ``"column"`` (its output channels split) or ``"row"`` (its input
    channels split). Calling it runs the layer on a channels-last input
    whose channels are the last dimension."""

    role: str
    mesh: Mesh

    def __call__(self, x: torch.Tensor, product, bias: Optional[torch.Tensor]) -> torch.Tensor:
        """``product``: the layer's product with its weight block, without
        the bias."""
        if self.role == "column":
            y = gather(product(copy(x, self.mesh)), self.mesh)
        else:
            y = reduce(product(split(x, self.mesh)), self.mesh)
        return y if bias is None else y + bias


def _channel_dims(layer: nn.Module):
    """(output, input) channel dimensions of a layer's torch weight."""
    return (1, 0) if isinstance(layer, nn.ConvTranspose1d) else (0, 1)


def plan(modules: Mapping[str, nn.Module], model: int, min_dim: int = 256) -> Dict[str, Optional[int]]:
    """For each parameter of ``modules`` (named ``<key>.<parameter name>``),
    the torch dimension that a model axis of ``model`` ranks splits, or None
    (replicated): ``mesh.partition_params`` (JAX's rule) on each weight's
    flax shape, mapped back through ``flax_axes``."""
    shapes, axes = {}, {}
    for key, module in modules.items():
        layers = {f"{key}.{n}.weight": m for n, m in module.named_modules() if flax_axes(m) is not None}
        for name, p in module.named_parameters():
            full = f"{key}.{name}"
            axes[full] = flax_axes(layers[full]) if full in layers else tuple(range(p.dim()))
            shapes[full] = SimpleNamespace(shape=tuple(p.shape[a] for a in axes[full]))
    flax_dims = partition_params(shapes, Mesh(data=1, model=model), min_dim)
    return {n: None if d is None else axes[n][d] for n, d in flax_dims.items()}


class Placement(NamedTuple):
    """A placed state's mesh and ``plan``."""

    mesh: Mesh
    dims: Dict[str, Optional[int]]


def place_layer(layer: nn.Module, dim: int, mesh: Mesh) -> Split:
    """Split ``layer`` (the port's ``Linear``, ``Conv1d`` or
    ``ConvTranspose1d``) along torch weight dimension ``dim``: keep this
    rank's block of its weight and give it the role, column where ``dim``
    holds the output channels, row where it holds the input ones. Raises
    for another layer, a spectral-norm one, or ``dim`` the kernel's taps."""
    if flax_axes(layer) is None or not hasattr(layer, "tp"):
        raise ValueError(f"{type(layer).__name__}: only the port's Linear, Conv1d and "
                         f"ConvTranspose1d split")
    if hasattr(layer, "sigma"):
        raise ValueError("a spectral-norm layer does not split (its power iteration reads "
                         "the whole weight)")
    out_dim, in_dim = _channel_dims(layer)
    if dim not in (out_dim, in_dim):
        raise ValueError(f"{type(layer).__name__}: dimension {dim} holds the kernel's taps")
    layer.tp = Split("column" if dim == out_dim else "row", mesh)
    with torch.no_grad():
        layer.weight.data = _block(layer.weight.data, dim, mesh)
    return layer.tp


def place_state(state, mesh: Mesh, min_dim: int = 256) -> Dict[str, Optional[int]]:
    """Split ``state`` (a ``gan_step.GANTrainState``) over ``mesh``'s model
    axis, in place: for each parameter of the generator, feature encoder,
    critic and ED that ``plan`` splits, ``place_layer`` its layer and keep
    this rank's block of Adam's ``exp_avg`` and ``exp_avg_sq`` and of the
    EMA stream. Returns the plan, which the state keeps as
    ``state.placement``. A mesh without a model axis places nothing."""
    modules = {k: getattr(state, k) for k in MODULES}
    dims = plan(modules, mesh.model, min_dim)
    if mesh.model > 1 and mesh.model_group is None:
        raise ValueError("tensor parallelism needs a mesh over a process group "
                         "(make_mesh(model_parallel=k) inside the ranks)")
    for full, dim in dims.items():
        if dim is None:
            continue
        key, name = full.split(".", 1)
        owner, leaf = name.rsplit(".", 1)
        if leaf != "weight":
            raise ValueError(f"{full}: only a layer's weight splits")
        layer = modules[key].get_submodule(owner)
        place_layer(layer, dim, mesh)
        for opt in (state.opt_g, state.opt_d):
            st = opt.state.get(layer.weight, {})
            for k in ("exp_avg", "exp_avg_sq"):
                if k in st:
                    st[k] = _block(st[k], dim, mesh)
        if key == "generator" and state.ema_params is not None:
            state.ema_params[name] = _block(state.ema_params[name], dim, mesh)
    state.placement = Placement(mesh, dims)
    return dims


def _full(t: torch.Tensor, dim: Optional[int], mesh: Optional[Mesh]) -> torch.Tensor:
    if dim is None or mesh is None:
        return t.detach().clone()
    return _joined(t.detach(), dim, mesh)


def gather_state(state) -> Dict[str, Any]:
    """The whole of a placed (or unplaced) state on every rank: the state
    dicts of the generator, feature encoder, critic and ED, Adam's
    ``exp_avg`` and ``exp_avg_sq`` and the EMA stream (None when off), each
    by ``<module>.<parameter name>`` as ``plan`` names them. One
    ``all_reduce`` over the model axis a split tensor."""
    placement = getattr(state, "placement", None)
    mesh = None if placement is None else placement.mesh
    dims = {} if placement is None else placement.dims
    out: Dict[str, Any] = {"exp_avg": {}, "exp_avg_sq": {}}
    for key in MODULES:
        module = getattr(state, key)
        out[key] = {n: _full(t, dims.get(f"{key}.{n}"), mesh) for n, t in module.state_dict().items()}
        opt = state.opt_d if key == "critic" else state.opt_g
        for n, p in module.named_parameters():
            for k, t in opt.state.get(p, {}).items():
                if k in out:
                    out[k][f"{key}.{n}"] = _full(t, dims.get(f"{key}.{n}"), mesh)
    ema = state.ema_params
    out["ema"] = None if ema is None else {n: _full(e, dims.get(f"generator.{n}"), mesh)
                                           for n, e in ema.items()}
    return out


def check_replicas(state) -> None:
    """Raise unless a placed state's ranks agree bit for bit: every
    parameter and buffer over the data axis, and every replicated one
    (all but the split weights) over the model axis as well."""
    placement = getattr(state, "placement", None)
    if placement is None:
        return
    mesh, dims = placement
    local, replicated = [], []
    for key in MODULES:
        for n, t in getattr(state, key).state_dict().items():
            local.append(t)
            if dims.get(f"{key}.{n}") is None:
                replicated.append(t)
    mesh.check_replicas(local, "GAN weights", axis="data")
    mesh.check_replicas(replicated, "replicated GAN weights", axis="model")
