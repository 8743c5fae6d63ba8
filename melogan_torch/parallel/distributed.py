"""Multi-process and multi-host meshes of the port.

Port of ``melogan_tpu/parallel/distributed.py``. JAX joins processes with
``jax.distributed.initialize`` and assembles global arrays from each
process's rows; the port joins them in a ``torch.distributed`` process
group (NCCL on the card, gloo on the CPU) whose ranks are the data axis,
one device a process, and each rank keeps its own rows of every batch.

- ``initialize``: ``init_process_group`` over ``tcp://`` from arguments
  or the ``MELOGAN_COORDINATOR`` (host:port), ``MELOGAN_NUM_PROCESSES`` and
  ``MELOGAN_PROCESS_ID`` environment variables, then the rank's device
  (``mesh.local_device``: ``LOCAL_RANK``, or the rank modulo the local
  device count). ``join_torchrun``: the same from the variables that
  ``torchrun`` sets (``init_method="env://"``); the command line calls it
  for ``--dp`` and then joins that group instead of starting ranks.
- ``make_multihost_mesh``: the mesh over the world group; one process
  gives the one-device mesh.
- ``global_batch_from_local``: this process's rows as its shard, with the
  global row count.
- ``process_count``: the world size.

See ``README.md`` for ``--dp N``, ``torchrun`` and the variables above.
"""
from __future__ import annotations

import datetime
import os
from typing import Any, NamedTuple, Optional

import torch
import torch.distributed as dist

from melogan_torch.parallel.mesh import Mesh, local_device, make_mesh

# a collective that waits longer than this raises instead of hanging a rank
DEFAULT_TIMEOUT = datetime.timedelta(minutes=30)


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device="cuda",
) -> None:
    """Join this process to the group: ``init_process_group`` with
    ``init_method="tcp://<coordinator_address>"``, NCCL on the card and gloo
    for ``device="cpu"``. Arguments left None come from
    ``MELOGAN_COORDINATOR``, ``MELOGAN_NUM_PROCESSES`` and
    ``MELOGAN_PROCESS_ID``. A collective waits at most
    ``DEFAULT_TIMEOUT``. On the card the rank's device becomes the current
    one."""
    coordinator_address = coordinator_address or os.environ.get("MELOGAN_COORDINATOR")
    if num_processes is None and os.environ.get("MELOGAN_NUM_PROCESSES"):
        num_processes = int(os.environ["MELOGAN_NUM_PROCESSES"])
    if process_id is None and os.environ.get("MELOGAN_PROCESS_ID"):
        process_id = int(os.environ["MELOGAN_PROCESS_ID"])
    if not coordinator_address or num_processes is None or process_id is None:
        raise ValueError("initialize needs the coordinator address, the process count and this "
                         "process's id (arguments, or MELOGAN_COORDINATOR, "
                         "MELOGAN_NUM_PROCESSES and MELOGAN_PROCESS_ID)")
    cuda = torch.device(device).type == "cuda"
    dist.init_process_group(
        backend="nccl" if cuda else "gloo",
        init_method=f"tcp://{coordinator_address}",
        world_size=num_processes,
        rank=process_id,
        timeout=DEFAULT_TIMEOUT,
    )
    if cuda:
        torch.cuda.set_device(local_device(device))


def join_torchrun(device="cuda") -> bool:
    """Under a launcher that set ``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``
    and ``MASTER_PORT`` (``torchrun``), join its group
    (``init_method="env://"``, NCCL on the card, gloo for ``device="cpu"``)
    and take the rank's device; True when this process is then in a group.
    Without those variables, or in a group already, it does nothing."""
    if dist.is_initialized():
        return True
    if not all(k in os.environ for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")):
        return False
    cuda = torch.device(device).type == "cuda"
    dist.init_process_group(backend="nccl" if cuda else "gloo", init_method="env://", timeout=DEFAULT_TIMEOUT)
    if cuda:
        torch.cuda.set_device(local_device(device))
    return True


def process_count() -> int:
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def make_multihost_mesh(model_parallel: int = 1, device="cuda") -> Mesh:
    """The (data, model) mesh over every process of the group, one device
    each; a single process (no group, or a group of one) gives the
    one-device mesh. ``model_parallel`` > 1 raises as ``make_mesh`` does."""
    if not (dist.is_available() and dist.is_initialized()):
        return make_mesh(1, model_parallel=model_parallel, device=device)
    return make_mesh(model_parallel=model_parallel, device=device)


class GlobalBatch(NamedTuple):
    """A data-parallel batch as the port holds it: this process's rows
    (``local``, a tree of tensors on its device) and the row count of the
    batch over every process (``global_rows``)."""

    local: Any
    global_rows: int


def global_batch_from_local(mesh: Mesh, local_batch, batch_axis: int = 0) -> GlobalBatch:
    """Each process's own rows of a batch as its shard: the tree on this
    rank's device, and the global row count summed over the ranks (one
    ``all_reduce``; the local count alone without a group)."""
    from melogan_torch.parallel.mesh import put_replicated, tree_map

    local = put_replicated(local_batch, mesh)
    counts = set()
    tree_map(lambda x: counts.add(int(x.shape[batch_axis])), local)
    if len(counts) != 1:
        raise ValueError(f"the leaves of a batch must share their row count, got {sorted(counts)}")
    rows = torch.tensor([float(counts.pop())], dtype=torch.float64)
    if mesh.group is not None and mesh.data > 1:
        rows = rows.to(mesh._comm_device())
        dist.all_reduce(rows, group=mesh.group)
    return GlobalBatch(local=local, global_rows=int(rows.item()))
