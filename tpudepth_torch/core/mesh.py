"""The JAX package's (data, model) mesh, over ``torch.distributed``.

Counterpart of ``tpudepth/core/mesh.py``. There a batch is sharded over the
mesh's ``data`` axis and, with ``P("data", "model")``, its image rows over
the ``model`` axis; XLA makes every batch reduction global and inserts the
convolutions' halo exchanges inside one jitted step. Here each rank of a
process group is one device of a ``num_data x num_model`` grid, rank ``d *
num_model + m`` at data index ``d`` and model index ``m`` (JAX's
``reshape(num_data, num_model)``), and what JAX makes global is reduced or
exchanged explicitly.

The data axis (:class:`Mesh` ``rank`` / ``world`` / ``group``):

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

Each takes the data group by default; ``axis="model"`` or ``axis="grid"``
(data x model) picks another. A helper is the identity where its group is
None: without a process group, or on an axis of one rank. With
``num_model == 1`` the data group is the world, as before the model axis
existed, so every helper runs the same collective on the same tensors.

The model axis (``spatial_sharding``, :func:`despatialize`): the model
ranks split the rows of an ``h``-row map by one rule, :func:`row_bounds`,
for any ``h``: rank ``m`` holds rows ``[b[m], b[m + 1])``, the first ``h %
M`` ranks one row more than the others (``torch.tensor_split``'s rule). The
split is balanced rather than GSPMD's ``ceil(h / M)`` rows a rank: at the
heights JAX takes (the input's ``H % M == 0``, deeper maps anything) GSPMD
leaves the last ranks short or empty (72 rows over 4 ranks leave 5 at 1/16:
2, 2, 1, 0), the balanced split no rank empty while ``h >= M`` (2, 1, 1, 1)
and the same shards as before where ``M`` divides ``h``. The input keeps
JAX's condition: :func:`image_rows` / :func:`shard_spatial` raise unless
``M`` divides ``H``. Every activation is either "rows" (split over the model
axis) or "whole" (replicated over it); a module runs on rows where the model
marks it (:func:`run_on_rows`, a static mark per module instance), and only
two autograd functions cross between the two: :func:`despatialize` (rows to
whole: the rows gathered; its backward takes this rank's rows of the
cotangent) and :func:`take_rows` (whole to rows: a slice; its backward
SUM-all-reduces the rows' cotangents put into a zero map over the model
group, so the whole region's cotangent is whole on every rank). A parameter
used on rows therefore gets a share of its gradient on each rank and one
used on the whole map gets all of it: :func:`average_gradients` sums the
shares over the model ranks, takes the first model rank's whole gradients
and averages over the data ranks, in one all-reduce over the grid.
Convolutions and resizes on rows read the rows they need beyond their own
from their neighbours through :func:`fetch_rows`. Every exchange is a SUM
all-reduce of zero-padded slots (exact: each entry adds zeros only),
because gloo takes CUDA tensors for all-reduce and broadcast only, and gloo
is the only backend that runs two ranks on one card; every rank enters it,
one that holds no rows of the map too. Means over rows (BatchNorm's
moments, the SE squeezes) add each rank's sums and its count of elements
(:func:`sum_with_count`), so unequal shards weigh by their rows.

The global height of a map on rows is not its local height times ``M``
once shards differ, so it travels with the forward in the mesh's row plan
(``Mesh.plan``; :func:`input_rows`, :func:`global_rows`,
:func:`record_rows`): the plan maps a map's width, which rows do not
split, to its global height. A model's entry starts it anew from its input
(whose shards are equal, or whose height a train step that resized its
batch pinned: :func:`pin_input_rows`), and every step that makes a map on
rows records
the height it planned: a conv's output rows, a resize's size,
:func:`take_rows` of a whole map. Two maps on rows of one width and
different heights would make the plan ambiguous: recording the second
raises, and :func:`global_rows` checks that this rank's rows are the
rule's share of the height it returns.

The model's modules find the mesh through :func:`mesh_context` (alias
:func:`data_axis`), which the train step enters around its forward and
backward and a caller enters around a sharded forward; a module-level slot
and not a context variable, because the autograd engine runs a
rematerialized forward again on its own thread.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import Any, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist


class RowPlan:
    """The global heights of the maps on rows of a mesh's current forward,
    by width, and the models' input height where a step pinned it
    (module docstring)."""

    def __init__(self):
        self.heights = {}
        self.input = None

    def start(self, h: int, w: int):
        """A new forward, from an input of ``h`` global rows and width
        ``w``."""
        self.heights = {w: h}

    def record(self, h: int, w: int):
        known = self.heights.setdefault(w, h)
        if known != h:
            raise ValueError(
                f"two maps on rows of width {w} have {known} and {h} rows: "
                f"the row plan cannot tell their heights apart")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This process's place in a ``world x num_model`` grid: its data index
    ``rank`` of ``world`` data ranks and the data ``group``; its
    ``model_rank`` of ``num_model`` and the ``model_group``; the
    ``grid_group`` of every rank; its ``device``. A group is None where its
    axis has one rank or there is no process group. ``plan`` is the row
    plan of its current forward on rows (:func:`input_rows`)."""

    rank: int = 0
    world: int = 1
    group: Any = None
    device: torch.device = torch.device("cpu")
    model_rank: int = 0
    num_model: int = 1
    model_group: Any = None
    grid_group: Any = None
    plan: RowPlan = dataclasses.field(default_factory=RowPlan,
                                      compare=False, repr=False)

    @property
    def collective(self) -> bool:
        """Whether the helpers run collectives: under a process group."""
        return self.group is not None or self.model_group is not None

    @property
    def spatial(self) -> bool:
        """Whether image rows are split over a model axis of several
        ranks."""
        return self.model_group is not None


#: the name of the mesh when it had a data axis only
DataMesh = Mesh


def _group_of(ranks: Sequence[int]):
    if len(ranks) == dist.get_world_size():
        return dist.group.WORLD
    return dist.new_group(list(ranks))


def create_mesh(num_data: int = 0, num_model: int = 1,
                device=None) -> Mesh:
    """The (data, model) grid over every rank of the default process group,
    as ``create_mesh(num_data, num_model)`` takes the devices in JAX.
    ``num_data=0`` takes every rank the model axis leaves; otherwise
    ``num_data * num_model`` must equal the world size (a rank is a device
    here, and a smaller grid would leave ranks idle). Every rank creates
    every group, in one order, as ``dist.new_group`` requires."""
    device = torch.device(device or "cpu")
    if dist.is_available() and dist.is_initialized():
        rank, world = dist.get_rank(), dist.get_world_size()
    else:
        rank, world = 0, 1
    if num_model < 1 or world % num_model:
        raise ValueError(f"a model axis of {num_model} does not divide the "
                         f"{world} processes of the group")
    if num_data and num_data * num_model != world:
        if num_model == 1:
            raise ValueError(f"a data axis of {num_data} needs {num_data} "
                             f"processes, the group has {world}")
        raise ValueError(f"a ({num_data} x {num_model}) mesh needs "
                         f"{num_data * num_model} processes, the group has "
                         f"{world}")
    num_data = world // num_model
    if not (dist.is_available() and dist.is_initialized()):
        return Mesh(device=device)
    if num_model == 1:
        return Mesh(rank, world, dist.group.WORLD, device,
                    grid_group=dist.group.WORLD)
    d, m = divmod(rank, num_model)
    data_group = model_group = None
    for mm in range(num_model):
        if num_data > 1:
            g = _group_of([dd * num_model + mm for dd in range(num_data)])
            if mm == m:
                data_group = g
    for dd in range(num_data):
        g = _group_of([dd * num_model + mm for mm in range(num_model)])
        if dd == d:
            model_group = g
    return Mesh(d, num_data, data_group, device, m, num_model, model_group,
                dist.group.WORLD)


_CURRENT: list = [None]


@contextlib.contextmanager
def mesh_context(mesh: Optional[Mesh]):
    """Make ``mesh`` the one that train-mode reductions (:func:`current_axis`)
    and modules on rows (:func:`rows_mesh`) read, for the block."""
    before = _CURRENT[0]
    _CURRENT[0] = mesh
    try:
        yield
    finally:
        _CURRENT[0] = before


#: the name the train step of the data axis used
data_axis = mesh_context


def current_axis() -> Optional[Mesh]:
    """The mesh of the enclosing :func:`mesh_context` when it runs
    collectives, else None."""
    mesh = _CURRENT[0]
    return mesh if mesh is not None and mesh.collective else None


def spatial_mesh() -> Optional[Mesh]:
    """The mesh of the enclosing :func:`mesh_context` when its model axis
    splits image rows, else None."""
    mesh = _CURRENT[0]
    return mesh if mesh is not None and mesh.spatial else None


def _group(mesh: Optional[Mesh], axis: str):
    if mesh is None:
        return None
    if axis == "data":
        return mesh.group
    if axis == "model":
        return mesh.model_group
    if axis == "grid":
        return mesh.grid_group if mesh.collective else None
    raise ValueError(f"axis must be 'data', 'model' or 'grid', not {axis!r}")


def batch_rows(mesh: Mesh, n_global: int) -> slice:
    """This rank's rows of a global batch of ``n_global`` (equal shards over
    the data axis)."""
    if n_global % mesh.world:
        raise ValueError(f"a global batch of {n_global} does not split into "
                         f"{mesh.world} equal shards")
    b = n_global // mesh.world
    return slice(mesh.rank * b, (mesh.rank + 1) * b)


def shard_batch(mesh: Mesh, batch):
    """This rank's rows of every ``[B, ...]`` array of a dict (or of one
    array): the port's ``shard_batch``, which in JAX device-puts the rows
    of each device."""
    if isinstance(batch, dict):
        return {k: shard_batch(mesh, v) for k, v in batch.items()}
    return batch[batch_rows(mesh, batch.shape[0])]


def replicated(mesh: Mesh, module: torch.nn.Module) -> torch.nn.Module:
    """Every parameter and buffer of ``module`` set to rank 0's, in place
    (JAX's replicated sharding puts one state on every device)."""
    group = _group(mesh, "grid")
    if group is not None:
        with torch.no_grad():
            for t in list(module.parameters()) + list(module.buffers()):
                dist.broadcast(t.data, 0, group=group)
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


def all_reduce_sum(x: torch.Tensor, mesh: Optional[Mesh],
                   axis: str = "data") -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``axis``, with autograd: the
    backward sums the cotangent over those ranks, so each rank's inputs get
    the gradient of every rank's loss through the sum."""
    group = _group(mesh, axis)
    if group is None:
        return x
    return _AllReduceSum.apply(x, group)


def _reduced(x: torch.Tensor, mesh: Optional[Mesh], op,
             axis: str = "data") -> torch.Tensor:
    group = _group(mesh, axis)
    if group is None:
        return x
    out = x.detach().contiguous().clone()
    dist.all_reduce(out, op=op, group=group)
    return out


def all_reduce_min(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """The elementwise minimum of ``x`` over the data ranks (no
    autograd)."""
    return _reduced(x, mesh, dist.ReduceOp.MIN)


def all_reduce_max(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """The elementwise maximum of ``x`` over the data ranks (no
    autograd)."""
    return _reduced(x, mesh, dist.ReduceOp.MAX)


def all_reduce_mean(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """The mean of ``x`` over the data ranks (no autograd)."""
    if _group(mesh, "data") is None:
        return x
    return _reduced(x, mesh, dist.ReduceOp.SUM) / mesh.world


def min_of_host_ints(value: int, mesh: Optional[Mesh]) -> int:
    """The least over the data ranks of a host integer."""
    if _group(mesh, "data") is None:
        return int(value)
    t = torch.tensor([int(value)], dtype=torch.int64, device=mesh.device)
    return int(all_reduce_min(t, mesh))


def gather_rows(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """Every data rank's ``x`` ``[b, ...]`` (the same ``b`` on each)
    concatenated in rank order, on every rank: a SUM all-reduce of
    zero-padded rows, exact because each entry adds zeros only."""
    if _group(mesh, "data") is None:
        return x
    b = x.shape[0]
    out = x.new_zeros((mesh.world * b, *x.shape[1:]))
    out[mesh.rank * b:(mesh.rank + 1) * b] = x.detach()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=mesh.group)
    return out


def barrier(mesh: Optional[Mesh]):
    """Wait for every rank of the grid (an all-reduce on the mesh's device,
    which both backends take)."""
    if _group(mesh, "grid") is not None:
        _reduced(torch.zeros(1, device=mesh.device), mesh,
                 dist.ReduceOp.SUM, "grid").cpu()


def _flat_all_reduce(grads: List[torch.Tensor], group, divide: int = 1):
    """Each tensor of ``grads`` replaced by its SUM over ``group`` (divided
    by ``divide``), one flat all-reduce per dtype."""
    by_dtype = {}
    for g in grads:
        by_dtype.setdefault(g.dtype, []).append(g)
    for same in by_dtype.values():
        flat = torch.cat([g.reshape(-1) for g in same])
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
        if divide != 1:
            flat /= divide
        offset = 0
        for g in same:
            g.copy_(flat[offset:offset + g.numel()].view_as(g))
            offset += g.numel()


def average_gradients(params, mesh: Optional[Mesh], shares=()):
    """Every ``.grad`` of ``params`` replaced by the global batch's: the
    mean over the data ranks; under a model axis, of the sum over the model
    ranks of the parameters in ``shares`` (those used on rows,
    :func:`rows_parameters`) and of the others (used whole, their gradient
    whole on every model rank) as the model group's first rank holds them:
    one SUM all-reduce over the grid, the other ranks' whole gradients
    zeroed first. The result is the same bits on every rank, though
    replicas of a whole computation may differ in their last bits (the
    fused GUB kernels' statistics add in f64 atomics on the card)."""
    if mesh is None or not mesh.collective:
        return
    params = [p for p in params if p.grad is not None]
    if mesh.model_group is None:
        _flat_all_reduce([p.grad for p in params], mesh.group, mesh.world)
        return
    if mesh.model_rank:
        ids = {id(p) for p in shares}
        for p in params:
            if id(p) not in ids:
                p.grad.zero_()
    _flat_all_reduce([p.grad for p in params], mesh.grid_group, mesh.world)


def replicate_whole_buffers(model: torch.nn.Module, mesh: Optional[Mesh]):
    """The floating buffers (BatchNorm running statistics) of ``model``'s
    modules that run on the whole map set to the model group's first
    rank's, so the replicas stay the same bits (those on rows reduce over
    the grid and move alike already)."""
    if mesh is None or mesh.model_group is None:
        return
    with torch.no_grad():
        buffers = [b for m in model.modules()
                   if not getattr(m, "on_rows", False)
                   for b in m.buffers(recurse=False) if b.is_floating_point()]
        if mesh.model_rank:
            for b in buffers:
                b.zero_()
        _flat_all_reduce(buffers, mesh.model_group)


# -- the model axis ----------------------------------------------------------


def batch_sharding(mesh: Mesh):
    """JAX's ``batch_sharding(mesh)`` (``P("data")``): a function that gives
    this rank's batch rows of a batch (:func:`shard_batch`)."""
    return functools.partial(shard_batch, mesh)


def spatial_sharding(mesh: Mesh):
    """JAX's ``spatial_sharding(mesh)`` (``P("data", "model")``): a function
    that gives this rank's batch rows and image rows of a batch
    (:func:`shard_spatial`)."""
    return functools.partial(shard_spatial, mesh)


def row_bounds(h: int, num_model: int) -> List[int]:
    """The rule for which rows of an ``h``-row map each of ``num_model``
    ranks holds: rank ``m`` holds ``[b[m], b[m + 1])`` of the ``num_model +
    1`` bounds ``b``, the first ``h % num_model`` ranks one row more than
    the others (module docstring)."""
    per, extra = divmod(h, num_model)
    return [q * per + min(q, extra) for q in range(num_model + 1)]


def rows_of(mesh: Mesh, h: int) -> slice:
    """The rows of an ``h``-row map that this rank holds
    (:func:`row_bounds`), for any ``h``."""
    b = row_bounds(h, mesh.num_model)
    return slice(b[mesh.model_rank], b[mesh.model_rank + 1])


def image_rows(mesh: Mesh, h: int) -> slice:
    """The rows of an ``h``-row input that this rank holds; ``h`` must
    divide by the model axis, as JAX's ``device_put`` of ``P("data",
    "model")`` requires."""
    if h % mesh.num_model:
        raise ValueError(f"an image of {h} rows does not split into "
                         f"{mesh.num_model} equal shards over the model axis")
    return rows_of(mesh, h)


def shard_spatial(mesh: Mesh, batch, layout: str = "NHWC"):
    """This rank's batch rows (data axis) and image rows (model axis) of
    every array of a dict (or of one array), ``NHWC`` (a loader's batch) or
    ``NCHW`` (a model's input)."""
    if isinstance(batch, dict):
        return {k: shard_spatial(mesh, v, layout) for k, v in batch.items()}
    dim = {"NHWC": 1, "NCHW": 2}[layout]
    index = [batch_rows(mesh, batch.shape[0])] + [slice(None)] * (dim - 1)
    return batch[tuple(index + [image_rows(mesh, batch.shape[dim])])]


def input_rows(x: torch.Tensor, mesh: Mesh) -> int:
    """The global height of a model's input ``x`` ``[B, C, h, W]`` on rows:
    the height :func:`pin_input_rows` pinned, else ``h`` times the model
    ranks (an input's shards are equal, :func:`image_rows`). Starts the row
    plan of a new forward from it (a model and then its backbone or encoder
    each start it, before either records a map)."""
    h = mesh.plan.input or x.shape[2] * mesh.num_model
    mesh.plan.start(h, x.shape[3])
    return h


def pin_input_rows(mesh: Optional[Mesh], hw: Optional[Tuple[int, int]]):
    """Pin the global size ``hw`` of the models' inputs on ``mesh``'s rows
    (:func:`input_rows`) and start the row plan from it, or unpin it
    (``hw`` None): a train step's batch resized on the whole map and then
    split by :func:`row_bounds`, whose shards need not be equal (JAX
    resizes inside its step, to any height). A no-op for ``mesh`` None."""
    if mesh is None:
        return
    mesh.plan.input = None if hw is None else int(hw[0])
    if hw is not None:
        mesh.plan.start(int(hw[0]), int(hw[1]))


def record_rows(mesh: Mesh, h: int, w: int):
    """Record in ``mesh``'s row plan that the maps on rows of width ``w``
    have ``h`` global rows."""
    mesh.plan.record(int(h), int(w))


def global_rows(x: torch.Tensor, mesh: Mesh) -> int:
    """The global height of the map of which ``x`` ``[B, C, h, W]`` is this
    rank's rows, from the row plan; raises where the plan has no map of its
    width or where ``h`` is not this rank's share of that height."""
    w = x.shape[3]
    if w not in mesh.plan.heights:
        raise ValueError(f"no map on rows of width {w} in the row plan: a "
                         f"model on rows starts it with input_rows")
    h = mesh.plan.heights[w]
    rows = rows_of(mesh, h)
    if x.shape[2] != rows.stop - rows.start:
        raise ValueError(f"{x.shape[2]} rows of width {w} on model rank "
                         f"{mesh.model_rank} are not its share of the "
                         f"{h} rows the row plan records")
    return h


def sum_with_count(sums: torch.Tensor, count: float, mesh: Optional[Mesh],
                   axis: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """``sums`` and ``count`` (how many elements they add) each summed over
    the ranks of ``axis``, in one SUM all-reduce with autograd: the means
    of unequal shards as ``sums / count``."""
    flat = torch.cat([sums.reshape(-1), sums.new_full((1,), float(count))])
    flat = all_reduce_sum(flat, mesh, axis)
    return flat[:-1].view_as(sums), flat[-1]


def run_on_rows(*modules: torch.nn.Module):
    """Mark ``modules`` and every module inside them to run on this rank's
    rows under a model axis (``on_rows``)."""
    for module in modules:
        for m in module.modules():
            m.on_rows = True


def run_whole_on_rows(module: torch.nn.Module):
    """Mark ``module`` alone to take rows and give rows under a model axis
    while it computes on the whole map (``gathers_rows``): its inputs are
    despatialized and its output is :func:`take_rows` of what it computes."""
    module.gathers_rows = True


def rows_mesh(module: torch.nn.Module) -> Optional[Mesh]:
    """The mesh whose model axis splits ``module``'s rows: the current
    :func:`spatial_mesh` where ``module`` is marked by :func:`run_on_rows`,
    else None."""
    return spatial_mesh() if getattr(module, "on_rows", False) else None


def gathering_mesh(module: torch.nn.Module) -> Optional[Mesh]:
    """The current :func:`spatial_mesh` where ``module`` is marked by
    :func:`run_whole_on_rows`, else None."""
    return spatial_mesh() if getattr(module, "gathers_rows", False) else None


def rows_parameters(model: torch.nn.Module) -> List[torch.nn.Parameter]:
    """The parameters of the modules marked to run on rows: the ones whose
    gradient each model rank holds a share of."""
    return [p for m in model.modules() if getattr(m, "on_rows", False)
            for p in m.parameters(recurse=False)]


#: ``despatialize`` / ``take_rows``'s default: the mesh of the context
CONTEXT = "context"


def _resolve(mesh) -> Optional[Mesh]:
    mesh = spatial_mesh() if mesh is CONTEXT else mesh
    return mesh if mesh is not None and mesh.spatial else None


class _Despatialize(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, h):
        rows = rows_of(mesh, h)
        ctx.rows = rows
        out = x.new_zeros((x.shape[0], x.shape[1], h, x.shape[3]))
        out[:, :, rows] = x
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=mesh.model_group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad[:, :, ctx.rows], None, None


class _TakeRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        rows = rows_of(mesh, x.shape[2])
        ctx.mesh, ctx.rows, ctx.h = mesh, rows, x.shape[2]
        return x[:, :, rows]

    @staticmethod
    def backward(ctx, grad):
        out = grad.new_zeros((*grad.shape[:2], ctx.h, grad.shape[3]))
        out[:, :, ctx.rows] = grad
        dist.all_reduce(out, op=dist.ReduceOp.SUM,
                        group=ctx.mesh.model_group)
        return out, None


def despatialize(x: torch.Tensor, mesh=CONTEXT) -> torch.Tensor:
    """Rows to whole: this rank's rows ``[B, C, h, W]`` of every model rank
    joined into the whole ``[B, C, H, W]`` map (``H`` from the row plan,
    :func:`global_rows`), on every rank (JAX's ``despatialize``,
    ``P("data")``): one SUM all-reduce of the whole map, into which each
    rank puts only its own rows (each rank's slot is its rows of the map).
    The identity off a model axis and for ``mesh`` None; by default the
    mesh is :func:`spatial_mesh`'s."""
    mesh = _resolve(mesh)
    if mesh is None:
        return x
    return _Despatialize.apply(x, mesh, global_rows(x, mesh))


def take_rows(x: torch.Tensor, mesh=CONTEXT) -> torch.Tensor:
    """Whole to rows: this rank's rows (:func:`row_bounds`) of a whole
    ``[B, C, H, W]`` map, ``H`` recorded in the row plan. The identity off
    a model axis and for ``mesh`` None; by default the mesh is
    :func:`spatial_mesh`'s."""
    mesh = _resolve(mesh)
    if mesh is None:
        return x
    record_rows(mesh, x.shape[2], x.shape[3])
    return _TakeRows.apply(x, mesh)


def halo_segments(bounds: Sequence[int], needs: Sequence[Tuple[int, int]]):
    """Where the rows each model rank needs beyond its own lie in one
    exchange buffer: ``(rank, first, end, offset)`` per run of rows that
    rank ``rank`` needs and does not hold, and the buffer's rows. Rank
    ``q`` holds the global rows ``[bounds[q], bounds[q + 1])`` and needs
    ``needs[q]``, ``[lo, hi)``."""
    segments, total = [], 0
    for q, (lo, hi) in enumerate(needs):
        own0, own1 = bounds[q], bounds[q + 1]
        for a, b in ((lo, min(hi, own0)), (max(lo, own1), hi)):
            if b > a:
                segments.append((q, a, b, total))
                total += b - a
    return segments, total


class _FetchRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, needs, mesh, bounds):
        m = mesh.model_rank
        own0, own1 = bounds[m], bounds[m + 1]
        segments, total = halo_segments(bounds, needs)
        ctx.mesh, ctx.needs, ctx.segments, ctx.total, ctx.own = (
            mesh, needs, segments, total, (own0, own1))
        lo, hi = needs[m]
        mid = x[:, :, max(lo, own0) - own0:max(min(hi, own1) - own0, 0)]
        buf = x.new_zeros((x.shape[0], x.shape[1], total, x.shape[3]))
        for _, a, b, off in segments:
            i0, i1 = max(a, own0), min(b, own1)
            if i1 > i0:
                buf[:, :, off + i0 - a:off + i1 - a] = x[:, :, i0 - own0:
                                                         i1 - own0]
        dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=mesh.model_group)
        top = [buf[:, :, off:off + b - a] for q, a, b, off in segments
               if q == m and b <= own0]
        bottom = [buf[:, :, off:off + b - a] for q, a, b, off in segments
                  if q == m and a >= own1]
        return torch.cat(top + [mid] + bottom, dim=2)

    @staticmethod
    def backward(ctx, grad):
        mesh, segments, total = ctx.mesh, ctx.segments, ctx.total
        m = mesh.model_rank
        lo, hi = ctx.needs[m]
        own0, own1 = ctx.own
        out = grad.new_zeros((grad.shape[0], grad.shape[1], own1 - own0,
                              grad.shape[3]))
        i0, i1 = max(lo, own0), min(hi, own1)
        if i1 > i0:
            out[:, :, i0 - own0:i1 - own0] = grad[:, :, i0 - lo:i1 - lo]
        # the borrowed rows' cotangents go back to their owners
        buf = grad.new_zeros((grad.shape[0], grad.shape[1], total,
                              grad.shape[3]))
        for q, a, b, off in segments:
            if q == m:
                buf[:, :, off:off + b - a] = grad[:, :, a - lo:b - lo]
        dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=mesh.model_group)
        for _, a, b, off in segments:
            j0, j1 = max(a, own0), min(b, own1)
            if j1 > j0:
                out[:, :, j0 - own0:j1 - own0] += buf[
                    :, :, off + j0 - a:off + j1 - a]
        return out, None, None, None


def fetch_rows(x: torch.Tensor, needs: Sequence[Tuple[int, int]],
               mesh: Mesh, h: int) -> torch.Tensor:
    """The global rows ``needs[model_rank]`` of an ``h``-row map of which
    every model rank holds its rows (:func:`row_bounds`; this rank's are
    ``x`` ``[B, C, rows, W]``): its own rows and those of other ranks, in
    order. ``needs`` lists the rows of every rank (each within ``[0, h)``),
    so each rank knows what to send; the rows that ranks need beyond their
    own travel in one SUM all-reduce of a buffer that holds only them, which
    every rank enters (none when every need lies within its rank's own
    rows, on every rank alike). The backward sends each borrowed row's
    cotangent back to its owner the same way."""
    needs = tuple((int(a), int(b)) for a, b in needs)
    bounds = tuple(row_bounds(int(h), mesh.num_model))
    if not halo_segments(bounds, needs)[1]:
        lo, hi = needs[mesh.model_rank]
        own0 = bounds[mesh.model_rank]
        return x[:, :, lo - own0:hi - own0]
    return _FetchRows.apply(x, needs, mesh, bounds)


def min_spatial_height(num_model: int, max_stride: int = 32) -> int:
    """JAX's minimum input height for gradient-safe spatial sharding
    (``tpudepth/core/mesh.py:116-129``): ``2 * num_model * max_stride``.
    There XLA's SPMD partitioner mis-scales backward passes once a fused
    stage's shard reaches one row a device; the port's own exchange has no
    partitioner to miscompile and refuses no height beyond the input's split
    (:func:`image_rows`). Kept as the JAX package's API."""
    return 2 * num_model * max_stride


def validate_spatial_input(h: int, mesh: Mesh, max_stride: int = 32) -> None:
    """JAX's guard (``tpudepth/core/mesh.py:132-143``), its numbers and
    message: raise when ``h`` lies under :func:`min_spatial_height` on a
    model axis of more than one rank."""
    num_model = mesh.num_model
    if num_model > 1 and h < min_spatial_height(num_model, max_stride):
        raise ValueError(
            f"input height {h} is unsafe for spatial sharding over "
            f"{num_model} devices: gradients miscompile when the deepest "
            f"stage drops below 2 rows/device (need H >= "
            f"{min_spatial_height(num_model, max_stride)}; see "
            f"core/mesh.py:min_spatial_height)"
        )
