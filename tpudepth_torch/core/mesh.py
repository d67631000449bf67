"""The data axis of the JAX package's mesh, over ``torch.distributed``.

Counterpart of the data half of ``tpudepth/core/mesh.py`` (``create_mesh``,
``batch_sharding``, ``replicated``, ``shard_batch``, :67-101). There the
batch is sharded over the mesh's ``data`` axis and XLA makes every batch
reduction global inside one jitted step. Here each rank of a process group
is one device and runs the step on its rows; what JAX makes global is
reduced explicitly with the helpers below:

- :func:`all_reduce_sum`: a SUM all-reduce that carries autograd (its
  backward is the SUM all-reduce of the cotangent), for the BatchNorm
  statistics (``models/layers.py::BatchNorm``) and the fused GUB kernels'
  per-channel sums;
- :func:`all_reduce_min` / :func:`all_reduce_max`, without autograd, for
  the root recipe's min-max target (``losses/losses.py``);
- :func:`average_gradients`, the mean of the ranks' gradients;
- :func:`all_reduce_mean`, :func:`min_of_host_ints` and :func:`gather_rows`,
  for the step's loss, the epoch's length and the validation
  (``train/trainer.py``).

Every helper is the identity without a process group. Under a group they
run their collective on every rank, a world of 1 included, where it is the
identity bit for bit. Only all-reduces are used (``gather_rows`` sums
zero-padded rows), because gloo takes CUDA tensors for all-reduce and
broadcast only.

The model's BatchNorms find the axis through :func:`data_axis`, which the
train step enters around its forward and backward; a module-level slot and
not a context variable, because the autograd engine runs a rematerialized
forward again on its own thread.

The spatial half (``spatial_sharding``, ``min_spatial_height``,
``validate_spatial_input``, ``despatialize`` / ``mesh_context``) is not
ported yet.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Optional

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class DataMesh:
    """The ``data`` axis: this process's ``rank`` of ``world``, its process
    ``group`` (None without one) and its ``device``."""

    rank: int = 0
    world: int = 1
    group: Any = None
    device: torch.device = torch.device("cpu")

    @property
    def collective(self) -> bool:
        """Whether the helpers run collectives: under a process group."""
        return self.group is not None


def create_mesh(num_data: int = 0, device=None) -> DataMesh:
    """The data axis over every rank of the default process group, as
    ``create_mesh(num_data=0)`` takes every device in JAX. A non-zero
    ``num_data`` must equal the world size: a rank is a device here, and
    a smaller axis would leave ranks idle."""
    if dist.is_available() and dist.is_initialized():
        rank, world, group = dist.get_rank(), dist.get_world_size(), \
            dist.group.WORLD
    else:
        rank, world, group = 0, 1, None
    if num_data and num_data != world:
        raise ValueError(f"a data axis of {num_data} needs {num_data} "
                         f"processes, the group has {world}")
    return DataMesh(rank, world, group, torch.device(device or "cpu"))


_CURRENT: list = [None]


@contextlib.contextmanager
def data_axis(mesh: Optional[DataMesh]):
    """Make ``mesh`` the axis that train-mode reductions read
    (:func:`current_axis`) for the block."""
    before = _CURRENT[0]
    _CURRENT[0] = mesh
    try:
        yield
    finally:
        _CURRENT[0] = before


def current_axis() -> Optional[DataMesh]:
    """The axis of the enclosing :func:`data_axis` when it runs
    collectives, else None."""
    mesh = _CURRENT[0]
    return mesh if mesh is not None and mesh.collective else None


def batch_rows(mesh: DataMesh, n_global: int) -> slice:
    """This rank's rows of a global batch of ``n_global`` (equal shards)."""
    if n_global % mesh.world:
        raise ValueError(f"a global batch of {n_global} does not split into "
                         f"{mesh.world} equal shards")
    b = n_global // mesh.world
    return slice(mesh.rank * b, (mesh.rank + 1) * b)


def shard_batch(mesh: DataMesh, batch):
    """This rank's rows of every ``[B, ...]`` array of a dict (or of one
    array): the port's ``shard_batch``, which in JAX device-puts the rows
    of each device."""
    if isinstance(batch, dict):
        return {k: shard_batch(mesh, v) for k, v in batch.items()}
    return batch[batch_rows(mesh, batch.shape[0])]


def replicated(mesh: DataMesh, module: torch.nn.Module) -> torch.nn.Module:
    """Every parameter and buffer of ``module`` set to rank 0's, in place
    (JAX's replicated sharding puts one state on every device)."""
    if mesh.collective:
        with torch.no_grad():
            for t in list(module.parameters()) + list(module.buffers()):
                dist.broadcast(t.data, 0, group=mesh.group)
    return module


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.contiguous().clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, op=dist.ReduceOp.SUM, group=ctx.group)
        return grad, None


def all_reduce_sum(x: torch.Tensor,
                   mesh: Optional[DataMesh]) -> torch.Tensor:
    """The sum of ``x`` over the ranks, with autograd: the backward sums
    the cotangent over the ranks, so each rank's inputs get the gradient
    of every rank's loss through the sum."""
    if mesh is None or not mesh.collective:
        return x
    return _AllReduceSum.apply(x, mesh.group)


def _reduced(x: torch.Tensor, mesh: Optional[DataMesh], op) -> torch.Tensor:
    if mesh is None or not mesh.collective:
        return x
    out = x.detach().contiguous().clone()
    dist.all_reduce(out, op=op, group=mesh.group)
    return out


def all_reduce_min(x: torch.Tensor,
                   mesh: Optional[DataMesh]) -> torch.Tensor:
    """The elementwise minimum of ``x`` over the ranks (no autograd)."""
    return _reduced(x, mesh, dist.ReduceOp.MIN)


def all_reduce_max(x: torch.Tensor,
                   mesh: Optional[DataMesh]) -> torch.Tensor:
    """The elementwise maximum of ``x`` over the ranks (no autograd)."""
    return _reduced(x, mesh, dist.ReduceOp.MAX)


def all_reduce_mean(x: torch.Tensor,
                    mesh: Optional[DataMesh]) -> torch.Tensor:
    """The mean of ``x`` over the ranks (no autograd)."""
    if mesh is None or not mesh.collective:
        return x
    return _reduced(x, mesh, dist.ReduceOp.SUM) / mesh.world


def min_of_host_ints(value: int, mesh: Optional[DataMesh]) -> int:
    """The least over the ranks of a host integer."""
    if mesh is None or not mesh.collective:
        return int(value)
    t = torch.tensor([int(value)], dtype=torch.int64, device=mesh.device)
    return int(all_reduce_min(t, mesh))


def gather_rows(x: torch.Tensor, mesh: Optional[DataMesh]) -> torch.Tensor:
    """Every rank's ``x`` ``[b, ...]`` (the same ``b`` on each) concatenated
    in rank order, on every rank: a SUM all-reduce of zero-padded rows,
    exact because each entry adds zeros only."""
    if mesh is None or not mesh.collective:
        return x
    b = x.shape[0]
    out = x.new_zeros((mesh.world * b, *x.shape[1:]))
    out[mesh.rank * b:(mesh.rank + 1) * b] = x.detach()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=mesh.group)
    return out


def barrier(mesh: Optional[DataMesh]):
    """Wait for every rank (an all-reduce on the mesh's device, which both
    backends take)."""
    if mesh is not None and mesh.collective:
        _reduced(torch.zeros(1, device=mesh.device), mesh,
                 dist.ReduceOp.SUM).cpu()


def average_gradients(params, mesh: Optional[DataMesh]):
    """Every ``.grad`` of ``params`` replaced by its mean over the ranks, one
    flat SUM all-reduce per dtype; the result is the same bits on every
    rank."""
    if mesh is None or not mesh.collective:
        return
    by_dtype = {}
    for p in params:
        if p.grad is not None:
            by_dtype.setdefault(p.grad.dtype, []).append(p.grad)
    for grads in by_dtype.values():
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=mesh.group)
        flat /= mesh.world
        offset = 0
        for g in grads:
            g.copy_(flat[offset:offset + g.numel()].view_as(g))
            offset += g.numel()
