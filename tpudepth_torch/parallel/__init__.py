"""Parallelism utilities: the data axis and process start-up.

Counterpart of ``tpudepth/parallel/__init__.py``: the batch is sharded over
the ranks of a process group (``core/mesh.py``), one device each. The
spatial axis (``spatial_sharding``) is not ported yet.
"""

from tpudepth_torch.core.mesh import (
    DataMesh,
    create_mesh,
    replicated,
    shard_batch,
)
from tpudepth_torch.parallel.launch import host_shard_info, initialize

__all__ = [
    "DataMesh",
    "create_mesh",
    "host_shard_info",
    "initialize",
    "replicated",
    "shard_batch",
]
