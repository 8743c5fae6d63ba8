"""Data parallelism of the port: device meshes, placements and the ranks.

Port of ``melogan_tpu/parallel``: ``mesh.py`` (``make_mesh`` and the
placements, the cross-rank reductions of a data-parallel step,
``partition_params``), ``distributed.py`` (joining processes, the
multi-host mesh) and ``launch.py`` (starting the ranks of a run on one
machine). Training runs one process a device; sampling one process over
several local devices.
"""

from melogan_torch.parallel.mesh import (
    batch_sharding,
    make_mesh,
    partition_params,
    replicated_sharding,
    shard_pytree_batch,
)

__all__ = [
    "make_mesh",
    "batch_sharding",
    "replicated_sharding",
    "partition_params",
    "shard_pytree_batch",
]
