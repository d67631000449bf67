"""Single-device trainer of the port: the alhashim recipe on GuideDepth and
the root recipe on every other model.

Counterpart of ``tpudepth/train/trainer.py`` (``src/GuideDepth/training.py``,
``src/train.py``):

- GuideDepth and GuideDepth-S: target = inverse depth normalization
  ``max_depth / clamp(d, max_depth/100, max_depth)`` with zero masking, loss
  = ``DepthLoss(0.1, 1, 1)``, or the masked L1 ``DepthLoss(1, 0, 0)`` when
  ``eval_mode != 'alhashim'``; on a CUDA device the alhashim loss is the
  fused CUDA kernel pair (``ops/kernels/fused_loss.py``), on the CPU the
  plain ``DepthLoss``, as the JAX package picks its Pallas kernel by
  backend;
- every other model (``sam``, ``newcrf``, by their canonical names): the
  root recipe, target = the batch's min-max normalization, loss = ``1.0 *
  ssim + 0.1 * l1`` (+ ``silog_weight * silog``); on a CUDA device without
  SILog the fused CUDA kernel pair (``ops/kernels/fused_root_loss.py``),
  else the plain composition, as the JAX package picks its Pallas kernel by
  backend; ``sam`` trains with its MobileNetV3 encoder frozen by the
  optimizer alone (its BatchNorm statistics still move);
- one train step on the device: /255 of raw uint8 input, down-resize,
  augmentation, target, forward in the compute dtype, loss in f32, backward,
  Adam with StepLR(step_size epochs, gamma) as a schedule over steps.

Batches come from the loader as the JAX package's loaders deliver them:
dicts of NHWC arrays, ``image`` ``[B,H,W,3]`` and ``depth`` ``[B,H,W,1]``
(float, or raw uint8 / uint16). The step views them as NCHW.

Data parallel (``core/mesh.py``, ``parallel/launch.py``): under a process
group each rank takes its equal share of the global batch
(``TrainConfig.batch_size``) and the step is the global batch's step, as
under JAX's data-sharded ``jit``. The augmentation draws the global batch's
decisions from the same seed on every rank; the BatchNorm statistics (the
fused GUB kernels' sums too), the min-max target and the masked losses' sums
are all-reduced inside the forward; the gradients are averaged over the
ranks after the backward. Why that is the global gradient:
each rank's loss is its share (their mean is the global loss), and the SUM
all-reduces' backward hands every rank the sum of all ranks' cotangents, so
the sum of the ranks' gradients is the gradient of the sum of the shares.
Parameters, statistics and Adam moments stay the same bits on every rank.

Spatial (``make_train_step(mesh=...)`` with a model axis, ``core/mesh.py``):
``image`` and ``depth`` are this rank's batch rows and image rows, as JAX's
``P("data", "model")`` places them. The model runs its modules on rows or
whole as it marks them; the depth and the prediction are despatialized
(one channel each) before the target and the loss, so the losses, the fused
loss kernels among them, see whole images and reduce over the data ranks;
the gradients of the parameters used on rows are summed over the model
ranks before the data average, those used whole (and the whole modules'
running statistics) taken from the model group's first rank. ``Trainer``
keeps a data axis only, as the JAX package's ``Trainer`` shards its
batches over ``data`` only.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from tpudepth_torch.core import mesh as mesh_lib
from tpudepth_torch.core.config import TrainConfig
from tpudepth_torch.core.mesh import Mesh
from tpudepth_torch.core.precision import Precision
from tpudepth_torch.core.runtime import DeviceLike
from tpudepth_torch.data.augment import augment_batch, draw_decisions
from tpudepth_torch.losses import losses as losses_lib
from tpudepth_torch.losses.losses import (
    DepthLoss,
    depth_norm_minmax,
    l1_loss,
    silog_loss_variance,
    ssim,
)
from tpudepth_torch.models.layers import rematerialize
from tpudepth_torch.ops.image import resize_bilinear
from tpudepth_torch.ops.kernels.fused_loss import fused_depth_loss
from tpudepth_torch.ops.kernels.fused_root_loss import fused_root_loss
from tpudepth_torch.parallel.launch import default_device
from tpudepth_torch.train.checkpoint import (
    load_checkpoint,
    save_checkpoint,
    wait_for_checkpoints,
)


@dataclasses.dataclass
class TrainState:
    """What a step updates in place: the model (parameters and BatchNorm
    statistics), the optimizer, and the count of steps taken (a host
    integer; the StepLR schedule reads it)."""

    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0


def step_lr(base_lr: float, step_size_epochs: int, gamma: float,
            steps_per_epoch: int) -> Callable[[int], float]:
    """torch StepLR as a schedule over steps
    (``src/GuideDepth/training.py:59-61``)."""

    def schedule(step: int) -> float:
        epoch = step // max(1, steps_per_epoch)
        return base_lr * gamma ** (epoch // step_size_epochs)

    return schedule


def make_optimizer(config: TrainConfig, params) -> torch.optim.Adam:
    """Adam (betas 0.9 / 0.999, eps 1e-8, as ``optax.adam``). The train step
    sets its learning rate from :func:`step_lr` before every update."""
    return torch.optim.Adam(params, lr=config.learning_rate)


#: prefix of the encoder's parameters in the attention models' reference
#: layout (``Unet.0.original_model.features.*``)
ENCODER_PREFIX = "Unet.0."


def freezes_encoder(model_name: str) -> bool:
    """Whether ``model_name`` (any name or alias of ``build_model``) trains
    with its encoder frozen: the reference freezes the MobileNetV3 encoder
    of the SAM model only (``src/model_mobileV3_large_SAM.py:168-169``)."""
    from tpudepth_torch.models.registry import canonical_model_name

    return canonical_model_name(model_name, strict=False) == "sam"


def trainable_parameters(model: torch.nn.Module, freeze_encoder: bool):
    """The parameters the optimizer updates: all, or all but the encoder's
    (``tpudepth/train/trainer.py::freeze_encoder_mask``, where
    ``optax.set_to_zero`` keeps them as they are). Freezing is the
    optimizer's alone: the encoder still runs in train mode and gets its
    gradients, and its BatchNorm statistics still move."""
    return [p for n, p in model.named_parameters()
            if not (freeze_encoder and n.startswith(ENCODER_PREFIX))]


def optimizer_state_by_name(saved: dict, file_keys, model: torch.nn.Module,
                            freeze_encoder: bool,
                            optimizer: torch.optim.Optimizer) -> dict:
    """A ``torch.optim.Adam`` ``state_dict`` saved beside a model whose
    ``state_dict`` keys are ``file_keys`` (a port file, a converted JAX
    checkpoint or a reference ``.pth``), as the ``state_dict`` of
    ``optimizer``, the port's Adam over ``trainable_parameters(model,
    freeze_encoder)``, paired by parameter name and not by position.

    The saved list of parameters follows the file's keys in order, buffers
    skipped (the port's buffers and the reference's
    ``relative_position_index``), as ``train/jax_state.py`` maps optax by
    name: either all of them (the reference's Adam over ``model.
    parameters()``, SAM's unused ``proj`` included) or the trainable ones.
    Another count raises, naming both. Saved parameters the port has no
    place for (SAM's ``proj``, a frozen encoder's) are dropped; the param
    group's hyperparameters are the saved first group's."""
    buffers = {n for n, _ in model.named_buffers()}
    names = [k for k in file_keys
             if k not in buffers and not k.endswith("relative_position_index")]
    trainable = [n for n in names
                 if not (freeze_encoder and n.startswith(ENCODER_PREFIX))]
    ids = [i for group in saved.get("param_groups", [])
           for i in group["params"]]
    if len(ids) == len(names):
        order = names
    elif len(ids) == len(trainable):
        order = trainable
    else:
        raise ValueError(
            f"the optimizer state holds {len(ids)} parameters; the file's "
            f"model has {len(names)} parameters, {len(trainable)} of them "
            "trainable")
    own = [n for n, _ in model.named_parameters()
           if not (freeze_encoder and n.startswith(ENCODER_PREFIX))]
    index = {n: i for i, n in enumerate(own)}
    state = {index[name]: saved["state"][i] for i, name in zip(ids, order)
             if name in index and i in saved["state"]}
    groups = optimizer.state_dict()["param_groups"]
    for key, value in saved["param_groups"][0].items():
        if key != "params":
            groups[0][key] = value
    return {"state": state, "param_groups": groups}


def inverse_depth_norm(depth: torch.Tensor, max_depth: float) -> torch.Tensor:
    """``Trainer.inverse_depth_norm`` (``src/GuideDepth/training.py:191-196``):
    divide first, then clamp; zeros stay zero."""
    zero = depth == 0.0
    safe = torch.where(zero, torch.ones_like(depth), depth)
    out = torch.clamp(max_depth / safe, max_depth / 100.0, max_depth)
    return torch.where(zero, torch.zeros_like(out), out)


def depth_norm(depth: torch.Tensor, max_depth: float) -> torch.Tensor:
    """``Trainer.depth_norm`` (``src/GuideDepth/training.py:199-204``):
    clamp first, then divide; zeros stay zero."""
    zero = depth == 0.0
    out = max_depth / torch.clamp(depth, max_depth / 100.0, max_depth)
    return torch.where(zero, torch.zeros_like(out), out)


@dataclasses.dataclass(frozen=True)
class LossRecipe:
    """Target transform and loss: ``kind`` is ``'root'`` (min-max target,
    ``1.0 * ssim + 0.1 * l1`` plus ``silog_weight * silog``), ``'alhashim'``
    (``DepthLoss(0.1, 1, 1)``) or ``'l1'`` (masked L1)."""

    kind: str = "alhashim"
    max_depth: float = 10.0
    depth_scale: float = 1.0  # loader units -> meters (8-bit maps: max_depth)
    silog_weight: float = 0.0

    def __post_init__(self):
        if self.kind not in ("root", "alhashim", "l1"):
            raise ValueError(f"unknown loss recipe {self.kind!r}")

    def target(self, depth: torch.Tensor) -> torch.Tensor:
        if self.kind == "root":
            return depth_norm_minmax(depth)
        return depth_norm(depth * self.depth_scale, self.max_depth)

    def loss(self, pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        if self.kind == "root":
            if pred.is_cuda and not self.silog_weight:
                return fused_root_loss(pred, target, 1.0, 0.1)
            total = 1.0 * ssim(pred, target) + 0.1 * l1_loss(pred, target)
            if self.silog_weight:
                total = total + self.silog_weight * silog_loss_variance(
                    pred, target)
            return total
        if self.kind == "alhashim":
            if pred.is_cuda:
                return fused_depth_loss(pred, target, 0.1, 1.0, 1.0,
                                        self.max_depth)
            return DepthLoss(0.1, 1.0, 1.0, self.max_depth)(pred, target)
        return DepthLoss(1.0, 0.0, 0.0, self.max_depth)(pred, target)


def _nchw(x: torch.Tensor) -> torch.Tensor:
    """NCHW view of a loader batch ``[B,H,W,C]``."""
    return x.permute(0, 3, 1, 2)


def make_train_step(
    model: torch.nn.Module,
    recipe: LossRecipe,
    schedule: Callable[[int], float],
    compute_dtype: torch.dtype = torch.bfloat16,
    augment: bool = True,
    check_grads: bool = False,
    depth_post_scale: float = 1.0,
    train_hw: Optional[Tuple[int, int]] = None,
    remat: bool = False,
    mesh: Optional[Mesh] = None,
):
    """Build the train step ``(state, image, depth, generator) -> loss``. It
    updates ``state`` in place and returns the loss as a detached device
    tensor: nothing in it waits for the device.

    ``mesh``: the (data, model) grid (``core/mesh.py``). Under a process
    group ``image`` and ``depth`` are this rank's rows of the global batch
    (and, with a model axis, its image rows), and the step is the global
    batch's: its loss is the global loss on every rank.

    ``remat``: the forward is rematerialized (``layers.rematerialize``, the
    counterpart of ``jax.checkpoint`` around the whole apply,
    ``tpudepth/train/trainer.py:194-205``): the backward runs it again, and
    the BatchNorm running statistics move once.

    ``image`` and ``depth`` are NHWC tensors on the model's device. Raw
    integer pixels (uint8 rgb, uint8 / uint16 depth) are normalized here;
    ``depth_post_scale`` converts raw 16-bit depth to meters (KITTI: 1/256)
    and applies to integer depth only. ``train_hw`` is the configured
    training resolution: only a DOWN-resize is applied (a loader larger than
    the configuration). ``generator`` draws the augmentation.
    """

    mesh = mesh if mesh is not None else Mesh()
    spatial = mesh if mesh.spatial else None
    shares = mesh_lib.rows_parameters(model) if spatial is not None else ()

    def step(state: TrainState, image: torch.Tensor, depth: torch.Tensor,
             generator: Optional[torch.Generator] = None) -> torch.Tensor:
        try:
            return run(state, image, depth, generator)
        finally:
            mesh_lib.pin_input_rows(spatial, None)

    def run(state, image, depth, generator):
        image, depth = _nchw(image), _nchw(depth)
        if image.dtype == torch.uint8:
            image = image.float() * (1.0 / 255.0)
        if depth.dtype == torch.uint8:
            depth = depth.float() * (depth_post_scale / 255.0)
        elif depth.dtype == torch.uint16:
            depth = depth.float() * depth_post_scale
        h = (image.shape[2] if spatial is None
             else mesh_lib.input_rows(image, spatial))
        if train_hw is not None and (h > train_hw[0]
                                     or image.shape[3] > train_hw[1]):
            # on the whole images, then this rank's rows of them, which
            # need not split equally: the model's input height is pinned
            image, depth = [resize_bilinear(mesh_lib.despatialize(t, spatial),
                                            train_hw) for t in (image, depth)]
            mesh_lib.pin_input_rows(spatial, train_hw)
            image, depth = (mesh_lib.take_rows(t, spatial)
                            for t in (image, depth))
        if augment:
            # the global batch's decisions, drawn alike on every rank, and
            # this rank's rows of them
            b = image.shape[0]
            rows = mesh_lib.batch_rows(mesh, b * mesh.world)
            flip, swap, perm = draw_decisions(generator, b * mesh.world,
                                              image.device)
            image, depth = augment_batch(None, image, depth,
                                         do_flip=flip[rows],
                                         do_swap=swap[rows],
                                         perm_idx=perm[rows])

        model.train()
        x = image.to(compute_dtype).contiguous(
            memory_format=torch.channels_last)
        with mesh_lib.mesh_context(mesh):
            target = recipe.target(mesh_lib.despatialize(depth.float(),
                                                         spatial))
            pred = rematerialize(model, x) if remat else model(x)
            pred = losses_lib.widen(mesh_lib.despatialize(pred, spatial))
            if pred.shape[2:] != target.shape[2:]:
                # a decoder may answer at half resolution: align the target
                target = resize_bilinear(target, pred.shape[2:])
            loss = recipe.loss(pred, target)
            # every gradient of the model, frozen parameters' too, so that
            # none piles up across steps and check_grads sees this step's
            # alone
            model.zero_grad(set_to_none=True)
            loss.backward()
        # the optimizer's parameters only: a frozen encoder's gradients are
        # never applied
        mesh_lib.average_gradients(
            [p for g in state.optimizer.param_groups for p in g["params"]],
            mesh, shares)
        mesh_lib.replicate_whole_buffers(model, spatial)
        loss = mesh_lib.all_reduce_mean(loss.detach(), mesh)
        if check_grads:
            # fold the finiteness of the gradient norm into the reported
            # loss, on the device; summed over the ranks, so a frozen
            # parameter's gradient that is not finite on one rank poisons
            # every rank's loss
            gsq = mesh_lib.all_reduce_sum(sum(
                p.grad.float().square().sum()
                for p in model.parameters() if p.grad is not None), mesh)
            loss = torch.where(torch.isfinite(gsq), loss,
                               torch.full_like(loss, float("nan")))
        for group in state.optimizer.param_groups:
            group["lr"] = schedule(state.step)
        state.optimizer.step()
        state.step += 1
        return loss

    return step


def make_eval_step(model: torch.nn.Module,
                   compute_dtype: torch.dtype = torch.bfloat16):
    """``image`` NCHW float -> prediction in f32, in eval mode."""

    @torch.no_grad()
    def fwd(image: torch.Tensor) -> torch.Tensor:
        model.eval()
        return model(image.to(compute_dtype).contiguous(
            memory_format=torch.channels_last)).float()

    return fwd


def _step_seed(seed: int, step: int) -> int:
    """One augmentation stream per (seed, step), so a resumed run draws what
    the uninterrupted run drew."""
    return (seed * 1_000_003 + step) % (2 ** 63)


class Trainer:
    """Training loop (capability parity with ``src/GuideDepth/training.py``
    Trainer and ``src/train.py``) on one device, or data-parallel over the
    ranks of a process group (``parallel/launch.py::initialize``).

    ``device=None`` means the CUDA card (``cuda:LOCAL_RANK`` under a
    group). A ``model`` passed in keeps its parameters (rank 0's, under a
    group); one built here is initialized from ``config.seed`` by
    :meth:`init_state`.

    Under a group of ``world`` ranks ``config.batch_size`` is the global
    batch: the train loader of each rank gives its ``batch_size // world``
    rows (its shard of the dataset), the validation loader the global
    batches, whose rows the ranks split and gather again. Losses, metrics
    and the model are the same on every rank; ``log_fn`` and
    ``image_log_fn`` run on rank 0, which alone writes files.

    Loaders are any object with ``__len__``, ``set_epoch(epoch)`` and
    iteration over ``{"image", "depth"}`` dicts of NHWC arrays (numpy, or
    tensors already on the device, which are used as they are). ``writer``
    is the command line's TensorBoard ``SummaryWriter`` (or None), kept for
    its hooks as the JAX ``Trainer`` keeps it."""

    def __init__(self, config: TrainConfig, model=None,
                 device: DeviceLike = None, train_loader=None,
                 val_loader=None, writer=None):
        from tpudepth_torch.models.registry import (
            build_model,
            canonical_model_name,
        )

        self.config = config
        self.device = default_device(device)
        self.mesh = mesh_lib.create_mesh(config.num_data_shards,
                                         device=self.device)
        if config.batch_size % self.mesh.world:
            raise ValueError(f"batch_size {config.batch_size} does not split "
                             f"into {self.mesh.world} equal shards")
        self._own_model = model is None
        # every switch keyed on the model's name (loss recipe, frozen
        # encoder) reads the canonical name, so aliases cannot dodge it
        self.model_name = canonical_model_name(config.model,
                                               strict=model is None)
        options = {}
        if config.remat_stages and self.model_name in ("GuideDepth",
                                                       "GuideDepth-S"):
            options["remat_stages"] = True
        self.model = (model if model is not None
                      else build_model(self.model_name, **options))
        self.train_loader = train_loader
        self.val_loader = val_loader
        self.writer = writer
        self.epoch = 0
        self.val_losses = []
        # per train epoch: {"epoch", "images", "seconds"}, host clock from
        # the first batch's request to the epoch's loss on the host
        self.epoch_times = []
        self.steps_per_epoch = (self._global_len(train_loader)
                                if train_loader is not None else 1)

        recipe_kind = "alhashim" if config.eval_mode == "alhashim" else "l1"
        if self.model_name not in ("GuideDepth", "GuideDepth-S"):
            # root-stack models train with the root recipe (src/train.py:94-100)
            recipe_kind = "root"
        self.freeze_encoder = freezes_encoder(self.model_name)
        # 8-bit NYU depth arrives in [0,1] -> scale by max_depth to meters;
        # the kitti reader already yields meters (16-bit png / 256).
        depth_scale = 1.0 if config.dataset == "kitti" else config.max_depth
        self.recipe = LossRecipe(kind=recipe_kind, max_depth=config.max_depth,
                                 depth_scale=depth_scale)
        self.compute_dtype = Precision.from_str(config.compute_dtype).compute_dtype
        self.state: Optional[TrainState] = None
        self._train_step = None
        self._generator = None

    @property
    def is_main(self) -> bool:
        """Whether this process logs and writes files: rank 0."""
        return self.mesh.rank == 0

    def _global_len(self, loader) -> int:
        """The steps every rank can take: the least of the ranks' loader
        lengths (shards may differ by a sample)."""
        return mesh_lib.min_of_host_ints(len(loader), self.mesh)

    # -- state ---------------------------------------------------------------

    def init_state(self) -> TrainState:
        cfg = self.config
        if self._own_model:
            with torch.random.fork_rng(devices=[]):
                torch.manual_seed(cfg.seed)
                for m in self.model.modules():
                    if hasattr(m, "reset_parameters"):
                        m.reset_parameters()
        self.model.to(self.device, memory_format=torch.channels_last)
        mesh_lib.replicated(self.mesh, self.model)
        self.state = TrainState(self.model, make_optimizer(
            cfg, trainable_parameters(self.model, self.freeze_encoder)))
        raw_depth_scale = 1.0
        if self.train_loader is not None:
            ds = getattr(self.train_loader, "dataset", None)
            raw_depth_scale = float(getattr(ds, "depth_post_scale", 1.0))
        schedule = step_lr(cfg.learning_rate, cfg.scheduler_step_size,
                           cfg.scheduler_gamma, self.steps_per_epoch)
        self._train_step = make_train_step(
            self.model, self.recipe, schedule,
            compute_dtype=self.compute_dtype,
            check_grads=cfg.check_grads, depth_post_scale=raw_depth_scale,
            train_hw=cfg.image_size, remat=cfg.remat, mesh=self.mesh)
        self._generator = torch.Generator(device=self.device)
        return self.state

    def _to_device(self, array) -> torch.Tensor:
        return torch.as_tensor(array).to(self.device, non_blocking=True)

    # -- loops ---------------------------------------------------------------

    def train_step(self, batch, generator: Optional[torch.Generator] = None):
        """One optimizer step on a host batch dict; returns the loss as a
        device tensor."""
        if generator is None:
            generator = self._generator
            generator.manual_seed(_step_seed(self.config.seed, self.state.step))
        return self._train_step(self.state, self._to_device(batch["image"]),
                                self._to_device(batch["depth"]), generator)

    def train_epoch(self, log_fn=None, steps_cap: int = 0,
                    image_log_fn=None) -> float:
        """One epoch; returns the exact sample-weighted mean of every step's
        (global) loss. The running sum is a device scalar, fetched once at
        the end of the epoch; host floats are pulled only on ``log_every``
        steps when a ``log_fn`` is given (rank 0)."""
        cfg = self.config
        steps_total = self._global_len(self.train_loader)
        if not self.is_main:
            log_fn = image_log_fn = None
        # every rank stops at the same step
        steps_cap = min(steps_cap or steps_total, steps_total)
        total_dev, count = None, 0
        start = t_epoch = time.perf_counter()
        for i, batch in enumerate(self.train_loader):
            if i >= steps_cap:
                break
            loss = self.train_step(batch)
            bs = batch["image"].shape[0] * self.mesh.world
            contrib = loss.float() * bs
            total_dev = contrib if total_dev is None else total_dev + contrib
            count += bs
            niter = self.epoch * steps_total + i
            if i % cfg.log_every == 0 and log_fn:
                log_fn(self.epoch, i, steps_total, float(loss),
                       time.perf_counter() - start, niter)
                start = time.perf_counter()
            if image_log_fn and i % cfg.image_log_every == 0:
                image_log_fn(niter)
        avg = 0.0 if total_dev is None else float(total_dev) / max(count, 1)
        self.epoch_times.append({"epoch": self.epoch, "images": count,
                                 "seconds": time.perf_counter() - t_epoch})
        return avg

    def val_epoch(self, max_batches: int = 0):
        """Validation loop (``src/GuideDepth/training.py:110-154``): the loss
        on normalized targets and the FastDepth metrics on inverse-normalized
        predictions against meters."""
        from tpudepth_torch.eval.metrics import AverageMeter, Result
        from tpudepth_torch.utils.profiling import StepTimer

        if self.val_loader is None:
            return None
        cfg = self.config
        eval_step = make_eval_step(self.model, self.compute_dtype)
        meter = AverageMeter()
        timer = StepTimer()
        acc_loss, seen = 0.0, 0
        for i, batch in enumerate(self.val_loader):
            if max_batches and i >= max_batches:
                break
            image = _nchw(self._to_device(batch["image"]))
            depth_np = np.asarray(batch["depth"], np.float32)
            depth = _nchw(self._to_device(depth_np))
            if image.dtype == torch.uint8:
                image = image.float() / 255.0
            hw = cfg.image_size
            if image.shape[2] > hw[0] or image.shape[3] > hw[1]:
                # validate at the configured model resolution
                image = resize_bilinear(image, hw)
            timer.data_done()
            inv_pred = self._split_forward(eval_step, image)
            pred_m = inverse_depth_norm(inv_pred, cfg.max_depth)
            timer.step_done(sync_on=pred_m)
            with torch.no_grad():
                target = self.recipe.target(depth)
                if inv_pred.shape[2:] != target.shape[2:]:
                    target = resize_bilinear(target, inv_pred.shape[2:])
                acc_loss += float(self.recipe.loss(inv_pred, target))
            seen += 1
            gt_m = depth_np * self.recipe.depth_scale
            if pred_m.shape[2:] != gt_m.shape[1:3]:
                pred_m = resize_bilinear(pred_m, gt_m.shape[1:3])
            pred_np = pred_m.permute(0, 2, 3, 1).cpu().numpy()
            valid = gt_m > 0
            r = Result()
            r.evaluate(np.clip(pred_np[valid], 1e-3, None), gt_m[valid])
            t = timer.summary()
            meter.update(r, t["compute_time_per_step"], t["data_time_per_step"],
                         image.shape[0])
        avg = meter.average()
        self.val_losses.append(acc_loss / max(seen, 1))
        return avg

    def _split_forward(self, eval_step, image: torch.Tensor) -> torch.Tensor:
        """``eval_step`` of a global batch: under a group each rank runs
        its rows (the last ranks' padded with copies of the last row) and
        gathers every rank's predictions. Eval-mode forwards are per
        image."""
        b, world = image.shape[0], self.mesh.world
        per = -(-b // world)
        rows = image[self.mesh.rank * per:(self.mesh.rank + 1) * per]
        if rows.shape[0] < per:
            fill = image[-1:].expand(per - rows.shape[0], *image.shape[1:])
            rows = torch.cat([rows, fill])
        return mesh_lib.gather_rows(eval_step(rows), self.mesh)[:b]

    # -- checkpointing -------------------------------------------------------

    def _state_payload(self):
        return {"model": self.model.state_dict(),
                "optimizer": self.state.optimizer.state_dict()}

    def _checkpoint_path(self, name: str) -> str:
        return os.path.join(os.path.abspath(self.config.checkpoint_dir), name)

    def _save(self, path: str, payload: dict) -> str:
        """``payload`` saved to ``path`` by rank 0, in the background
        (``train/checkpoint.py``); :meth:`fit` waits for it."""
        if self.is_main:
            save_checkpoint(path, payload)
        return os.path.abspath(path)

    def save_epoch_checkpoint(self, epoch: int) -> str:
        """GuideDepth schema: per-epoch ``checkpoint_{e}`` carrying epoch+1
        and the ``val_losses`` history."""
        payload = {"epoch": epoch + 1, "val_losses": list(self.val_losses)}
        payload.update(self._state_payload())
        return self._save(self._checkpoint_path(f"checkpoint_{epoch}"),
                          payload)

    def save_rolling_checkpoint(self, epoch: int, loss: float) -> str:
        """Root schema: one rolling ``global_checkpoint``."""
        payload = {"epoch": epoch, "loss": float(loss)}
        payload.update(self._state_payload())
        return self._save(self._checkpoint_path("global_checkpoint"), payload)

    def restore(self, path: str):
        """Resume mid-training: model, optimizer, epoch counter and
        ``val_losses`` history, from a port checkpoint or from the JAX
        package's orbax checkpoint directory of the same model
        (``train/checkpoint.py::load_checkpoint``; Adam moments and counts
        carried over, ``optax.multi_transform``'s frozen encoder too). The
        GuideDepth schema stores the epoch to resume at; the root schema
        stores the completed epoch, whose resume point is epoch+1: callers
        adjust with :meth:`set_resume_epoch`."""
        return self.restore_payload(load_checkpoint(
            path, map_location=self.device, model_name=self.model_name,
            model=self.model, freeze_encoder=self.freeze_encoder))

    def restore_payload(self, restored: dict):
        """:meth:`restore` from a checkpoint already loaded into the port's
        schema (``jax_state.trainer_checkpoint_from_jax`` of a restored
        JAX payload, say)."""
        from tpudepth_torch.models.torch_import import (
            load_reference_state_dict,
        )

        load_reference_state_dict(self.model, restored)
        self.state.optimizer.load_state_dict(optimizer_state_by_name(
            restored["optimizer"], list(restored["model"]), self.model,
            self.freeze_encoder, self.state.optimizer))
        self.set_resume_epoch(int(restored.get("epoch", 0)))
        self.val_losses = [float(v) for v in restored.get("val_losses", [])]
        return restored

    def set_resume_epoch(self, epoch: int):
        """Set the epoch training resumes at and the matching step count, so
        the step-based StepLR schedule and the per-step augmentation stream
        stay aligned."""
        self.epoch = int(epoch)
        self.state.step = self.epoch * self.steps_per_epoch

    def export_best_model(self, out_dir: Optional[str] = None) -> str:
        """Export the model of the epoch with the lowest validation loss as
        ``best_model`` (the current model when there is no validation history
        or checkpoint)."""
        out_dir = os.path.abspath(out_dir or self.config.results_dir)
        payload = None
        best_epoch = self.epoch
        if self.val_losses:
            best_epoch = int(np.argmin(self.val_losses))
            path = self._checkpoint_path(f"checkpoint_{best_epoch}")
            if os.path.exists(path):
                payload = {"model": load_checkpoint(path)["model"],
                           "best_epoch": best_epoch,
                           "val_loss": float(self.val_losses[best_epoch])}
        if payload is None:
            payload = {"model": self.model.state_dict(),
                       "best_epoch": best_epoch}
        # the final export blocks, as the JAX package's does
        # (tpudepth/train/trainer.py:602); every rank returns once it is on
        # disk
        path = os.path.join(out_dir, "best_model")
        if self.is_main:
            save_checkpoint(path, payload, blocking=True)
        mesh_lib.barrier(self.mesh)
        return os.path.abspath(path)

    # -- fit -----------------------------------------------------------------

    def fit(self, epochs: Optional[int] = None, steps_per_epoch: int = 0,
            val_max_batches: int = 0, log_fn=None, image_log_fn=None,
            on_epoch_end=None, checkpoint_style: Optional[str] = None,
            export_best: bool = False):
        """Epoch loop with validation and checkpointing.
        ``checkpoint_style`` is ``None``, ``'per_epoch'`` or ``'rolling'``.
        ``on_epoch_end(epoch, train_avg, val_result, trainer)`` fires after
        validation, before the checkpoint is saved."""
        epochs = epochs or self.config.epochs
        if self.state is None:
            self.init_state()
        # the saves run in the background; they land before fit returns, on
        # the exception path too (tpudepth/train/trainer.py:628-653), and
        # every rank returns once they are on disk
        try:
            for epoch in range(self.epoch, epochs):
                self.epoch = epoch
                self.train_loader.set_epoch(epoch)
                train_avg = self.train_epoch(log_fn,
                                             steps_cap=steps_per_epoch,
                                             image_log_fn=image_log_fn)
                val_avg = None
                if self.val_loader is not None:
                    val_avg = self.val_epoch(max_batches=val_max_batches)
                if on_epoch_end:
                    on_epoch_end(epoch, train_avg, val_avg, self)
                if checkpoint_style == "per_epoch":
                    self.save_epoch_checkpoint(epoch)
                elif checkpoint_style == "rolling":
                    self.save_rolling_checkpoint(epoch, train_avg)
            self.epoch = epochs
        finally:
            wait_for_checkpoints()
        mesh_lib.barrier(self.mesh)
        if export_best:
            return self.export_best_model()
        return self.state
