"""Device meshes of the port, and what a data-parallel step reduces over them.

Port of ``melogan_tpu/parallel/mesh.py``. A JAX mesh runs one program over
many devices and GSPMD inserts the collectives. The port trains with one
process a device (the ranks of a ``torch.distributed`` group) and samples
with one process over several local devices, and makes its few collectives
itself:

- ``Mesh``: the ``data`` and ``model`` sizes, this process's rank on the
  data axis, its devices and its process group (None for a local mesh).
- ``make_mesh``: under an initialised process group, the mesh over its
  ranks, one device each; else a local mesh over the first N devices.
- ``batch_sharding`` / ``shard_pytree_batch``: this rank's rows of each
  leaf of a global batch whose batch axis divides ``data``, every other
  leaf whole (JAX leaves such a leaf replicated, ``mesh.py:84-96``), on the
  rank's device; ``replicated_sharding`` / ``put_replicated``: the whole
  tree on the rank's device; ``microbatch_constrainer``:
  ``shard_pytree_batch`` inside a step, the identity where nothing splits.
  The trainers place their corpus and cut their batches with these.
- ``data_parallel(mesh)``: inside the block, on this thread, a train-mode
  BatchNorm (``models/layers.py::batch_norm_lc``) and ``cross_rank_mean``
  reduce over the mesh's ranks, as GSPMD's global batch statistics do.
- ``partition_params``: the dimension a ``model`` axis would split.

The collectives are ``all_reduce`` and ``broadcast`` only: the two that
gloo offers for CUDA tensors, so the same code runs under NCCL on cards and
under gloo on the CPU and on one card. A mesh with ``model`` > 1 (tensor
parallelism) is not ported (ROADMAP A.9b).
"""
from __future__ import annotations

import contextlib
import os
import threading
from dataclasses import dataclass
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist


def all_reduce(t: torch.Tensor, group) -> None:
    """``dist.all_reduce`` (sum, in place) inside a ``dp.all_reduce``
    profiler span, so a ``torch.profiler`` trace shows each collective's
    host time, its wait included (the operator's own event covers only the
    enqueue)."""
    with torch.profiler.record_function("dp.all_reduce"):
        dist.all_reduce(t, group=group)


@dataclass(frozen=True)
class Mesh:
    """A (data, model) mesh. ``group`` is the process group of a mesh whose
    data axis spans processes (one device each, ``devices`` holds this
    rank's); None for a local mesh, whose ``devices`` are the data axis."""

    data: int
    model: int = 1
    rank: int = 0
    devices: Tuple[torch.device, ...] = (torch.device("cpu"),)
    group: Any = None

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": self.data, "model": self.model}

    @property
    def device(self) -> torch.device:
        """This process's (first) device."""
        return self.devices[0]

    @property
    def is_main(self) -> bool:
        """Whether this process writes the run's files (rank 0)."""
        return self.rank == 0

    def splits(self, n: int) -> bool:
        """Whether a batch of ``n`` rows is split over the ranks: the mesh
        spans processes, ``data`` > 1 and divides ``n``."""
        return self.group is not None and self.data > 1 and n % self.data == 0

    def rows(self, x, axis: int = 0):
        """This rank's block of ``x`` along ``axis`` when ``splits`` its
        length there, else ``x`` itself (also for a 0-d ``x``)."""
        if x.ndim == 0 or not self.splits(x.shape[axis]):
            return x
        k = x.shape[axis] // self.data
        return x.narrow(axis, self.rank * k, k)

    # -- collectives (no-ops at data 1 and on a local mesh) -----------------
    def _collective(self) -> bool:
        return self.group is not None and self.data > 1

    def _comm_device(self) -> torch.device:
        """Where host-side values travel: the card under NCCL, else the CPU."""
        return self.device if dist.get_backend(self.group) == "nccl" else torch.device("cpu")

    def all_reduce_mean_(self, tensors: Sequence[torch.Tensor]) -> Sequence[torch.Tensor]:
        """Replace each tensor by its mean over the ranks, in one
        ``all_reduce`` of one flat float32 buffer."""
        if not self._collective() or not tensors:
            return tensors
        flat = torch.cat([t.detach().reshape(-1).to(torch.float32) for t in tensors])
        all_reduce(flat, self.group)
        flat.div_(self.data)
        off = 0
        with torch.no_grad():
            for t in tensors:
                t.copy_(flat[off:off + t.numel()].view_as(t))
                off += t.numel()
        return tensors

    def mean_dict(self, values: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """0-d tensors (a step's metrics) as their means over the ranks, in
        one ``all_reduce``."""
        if not self._collective() or not values:
            return values
        stacked = torch.stack([v.detach().to(torch.float32) for v in values.values()])
        self.all_reduce_mean_([stacked])
        return dict(zip(values, stacked.unbind()))

    def broadcast_(self, tensors: Sequence[torch.Tensor], src: int = 0) -> None:
        """Every rank's ``tensors`` set to rank ``src``'s, in place."""
        if self._collective():
            for t in tensors:
                dist.broadcast(t, src, group=self.group)

    def broadcast_object(self, obj, src: int = 0):
        """Rank ``src``'s picklable ``obj`` on every rank."""
        if not self._collective():
            return obj
        box = [obj]
        dist.broadcast_object_list(box, src, group=self.group, device=self._comm_device())
        return box[0]

    def barrier(self) -> None:
        """Wait for every rank (an ``all_reduce`` of one element)."""
        if self._collective():
            all_reduce(torch.zeros(1, device=self._comm_device()), self.group)

    def check_replicas(self, tensors: Sequence[torch.Tensor], what: str) -> None:
        """Raise unless ``tensors`` are equal on every rank: a float64 sum
        and sum of squares of them all, broadcast from rank 0 and compared
        exactly (the ranks apply the same reduced gradients to the same
        parameters, so they must agree bit for bit)."""
        if not self._collective():
            return
        acc = torch.zeros(2, dtype=torch.float64, device=self.device)
        for t in tensors:
            d = t.detach().to(torch.float64)
            acc += torch.stack([d.sum(), d.square().sum()])
        mine = acc.clone()
        self.broadcast_([acc])
        if not torch.equal(acc, mine):
            raise RuntimeError(f"data-parallel ranks diverged: rank {self.rank}'s {what} checksum "
                               f"{mine.tolist()} != rank 0's {acc.tolist()}")


def local_device(device="cuda") -> torch.device:
    """This process's device: on the card ``LOCAL_RANK``'s, or else the
    group rank modulo the local device count (0 outside a group); the CPU
    for ``device="cpu"``."""
    if torch.device(device).type == "cpu":
        return torch.device("cpu")
    if "LOCAL_RANK" in os.environ:
        index = int(os.environ["LOCAL_RANK"])
    else:
        rank = dist.get_rank() if dist.is_available() and dist.is_initialized() else 0
        index = rank % max(torch.cuda.device_count(), 1)
    return torch.device("cuda", index)


def make_mesh(
    n_devices: Optional[int] = None,
    model_parallel: int = 1,
    device="cuda",
) -> Mesh:
    """A (data, model) mesh of ``n_devices`` (default: all there are).

    Under an initialised process group the devices are its ranks, one a
    process, and the mesh spans all of them; otherwise they are this
    process's CUDA devices, or, for ``device="cpu"``, as many CPU shards as
    there are cores. Raises as JAX's ``make_mesh`` does when there are too
    few devices or ``model_parallel`` does not divide ``n_devices``, and
    NotImplementedError for ``model_parallel`` > 1 (ROADMAP A.9b)."""
    in_group = dist.is_available() and dist.is_initialized()
    if in_group:
        have = dist.get_world_size()
    elif torch.device(device).type == "cuda":
        have = torch.cuda.device_count()
    else:
        have = os.cpu_count() or 1
    if n_devices is None:
        n_devices = have
    if n_devices > have:
        raise ValueError(f"asked for {n_devices} devices, have {have}")
    if n_devices % model_parallel != 0:
        raise ValueError("n_devices must be divisible by model_parallel")
    if model_parallel > 1:
        raise NotImplementedError(
            f"model_parallel={model_parallel}: tensor parallelism (a mesh with a model axis "
            "above 1) is not ported yet (ROADMAP A.9b)")
    if in_group:
        if n_devices != have:
            raise ValueError(f"a mesh under a process group spans all of its {have} ranks; "
                             f"asked for {n_devices}")
        return Mesh(data=have, rank=dist.get_rank(), devices=(local_device(device),),
                    group=dist.group.WORLD)
    if torch.device(device).type == "cuda":
        devices = tuple(torch.device("cuda", i) for i in range(n_devices))
    else:
        devices = (torch.device("cpu"),) * n_devices
    return Mesh(data=n_devices, devices=devices)


# ---------------------------------------------------------------------------
# Placement
# ---------------------------------------------------------------------------


def tree_map(fn, tree):
    """``fn`` over the leaves of nested dicts, lists, tuples and
    NamedTuples; None stays None."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def _tensor(x, device) -> torch.Tensor:
    return torch.as_tensor(x if torch.is_tensor(x) else np.asarray(x), device=device)


def batch_sharding(mesh: Mesh, batch_axis: int = 0):
    """``f(x)``: this rank's block of ``x`` along ``batch_axis``
    (``Mesh.rows``: the whole of ``x`` where its batch does not divide the
    data axis, as JAX replicates such a leaf) on the rank's device."""
    return lambda x: mesh.rows(_tensor(x, mesh.device), batch_axis)


def shard_pytree_batch(tree, mesh: Mesh, batch_axis: int = 0):
    """``batch_sharding`` over each leaf of ``tree``."""
    return tree_map(batch_sharding(mesh, batch_axis), tree)


def replicated_sharding(mesh: Mesh):
    """``f(x)``: the whole of ``x`` on the rank's device."""
    return lambda x: _tensor(x, mesh.device)


def put_replicated(tree, mesh: Optional[Mesh], device=None):
    """The whole tree as tensors on the rank's device, or on ``device``
    without a mesh: each rank holds the epoch corpus, about 7 MB at
    reference scale, and gathers its microbatches from it."""
    if mesh is None:
        return tree_map(lambda x: _tensor(x, device), tree)
    return tree_map(replicated_sharding(mesh), tree)


def microbatch_constrainer(mesh: Optional[Mesh]):
    """``f(tree)``: ``shard_pytree_batch`` over ``mesh`` inside a step; the
    identity without a mesh, at ``data`` 1 and on a local mesh."""
    if mesh is None or not mesh._collective():
        return lambda tree: tree
    return lambda tree: shard_pytree_batch(tree, mesh)


# ---------------------------------------------------------------------------
# Cross-rank reductions inside a data-parallel step
# ---------------------------------------------------------------------------

_TLS = threading.local()


@contextlib.contextmanager
def data_parallel(mesh: Optional[Mesh]):
    """Inside the block, on this thread, train-mode BatchNorm and
    ``cross_rank_mean`` reduce over ``mesh``'s ranks; a mesh of one rank,
    a local mesh or None turns them off. The previous setting is restored
    after the block, also when it raises. Autograd's backward reads the
    mesh its forward saw, whatever thread runs it."""
    prev = active_mesh()
    _TLS.mesh = mesh if mesh is not None and mesh._collective() else None
    try:
        yield
    finally:
        _TLS.mesh = prev


def active_mesh() -> Optional[Mesh]:
    return getattr(_TLS, "mesh", None)


class _CrossRankMean(torch.autograd.Function):
    """Forward: the mean over the ranks. Backward: the incoming gradient
    unchanged. Each rank's loss then reads the global value, and the mean
    over ranks of the rank gradients (``Mesh.all_reduce_mean_``) is the
    gradient of the global loss."""

    @staticmethod
    def forward(ctx, t, mesh):
        out = t.detach().clone()
        mesh.all_reduce_mean_([out])
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


def cross_rank_mean(t: torch.Tensor) -> torch.Tensor:
    """``t``'s mean over the active mesh's ranks (``data_parallel``): with
    equal shards, a local batch mean becomes the global batch mean. ``t``
    itself outside a data-parallel block."""
    mesh = active_mesh()
    return t if mesh is None else _CrossRankMean.apply(t, mesh)


# ---------------------------------------------------------------------------
# Tensor-parallel parameter partitioning
# ---------------------------------------------------------------------------


def _named_leaves(params: Dict[str, Any], prefix: str = "") -> Dict[str, Any]:
    out = {}
    for k, v in params.items():
        out.update(_named_leaves(v, f"{prefix}{k}.") if isinstance(v, dict) else {f"{prefix}{k}": v})
    return out


def partition_params(params, mesh: Mesh, min_dim: int = 2048,
                     rules: Optional[Dict[str, Optional[int]]] = None) -> Dict[str, Optional[int]]:
    """For each named parameter of ``params`` (a state dict, or nested
    dicts of arrays named with dots), the dimension that the mesh's
    ``model`` axis would split, or None (replicated): JAX's
    ``partition_params`` rules with a dimension index for a PartitionSpec.
    ``rules`` maps name substrings to a dimension (or None); any other
    matrix with a dimension ≥ ``min_dim`` splits its widest. A split that
    does not divide, or a mesh without a model axis, replicates."""
    out = {}
    for name, leaf in _named_leaves(params).items():
        shape = tuple(leaf.shape) if hasattr(leaf, "shape") else np.shape(leaf)
        matched = [d for frag, d in (rules or {}).items() if frag in name]
        if matched:
            dim = matched[0]
        elif len(shape) >= 2 and max(shape) >= min_dim:
            dim = int(np.argmax(shape))
        else:
            dim = None
        if mesh.model <= 1 or (dim is not None and shape[dim] % mesh.model != 0):
            dim = None
        out[name] = dim
    return out
