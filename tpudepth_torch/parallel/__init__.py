"""Parallelism utilities: the (data, model) mesh and process start-up.

Counterpart of ``tpudepth/parallel/__init__.py``: the batch is sharded over
the data axis of a grid of processes, one device each, and the image rows
over its model axis (``spatial_sharding``; ``core/mesh.py``).
"""

from tpudepth_torch.core.mesh import (
    DataMesh,
    Mesh,
    batch_sharding,
    create_mesh,
    replicated,
    shard_batch,
    shard_spatial,
    spatial_sharding,
)
from tpudepth_torch.parallel.launch import host_shard_info, initialize

__all__ = [
    "DataMesh",
    "Mesh",
    "batch_sharding",
    "create_mesh",
    "host_shard_info",
    "initialize",
    "replicated",
    "shard_batch",
    "shard_spatial",
    "spatial_sharding",
]
