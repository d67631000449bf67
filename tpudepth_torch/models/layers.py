"""Building blocks: float32 parameters cast to the input's dtype at use.

Counterpart of ``tpudepth/models/layers.py``. A module's compute dtype is
its input's dtype; parameters and BatchNorm statistics stay float32, as
``dtype=bf16, param_dtype=f32`` does in the JAX modules. BatchNorm uses
torch momentum 0.1 and eps 1e-5 by default (DDRNet and GUB); MobileNetV3
passes 0.01 and 1e-3.

``Conv`` and ``BatchNorm`` also run in space-to-depth packed layout
(``block=`` at call time, ``ops/packed.py``) with the same parameters and
buffers, as ``Conv(packed=...)`` and ``BatchNorm(packed=...)`` do in JAX.
:func:`rematerialize` is ``torch.utils.checkpoint`` with the BatchNorm
running statistics moved once, by the forward and not by its recomputation.

Under a model axis (``core/mesh.py``) a module marked to run on rows
(``run_on_rows``) takes and gives this rank's image rows, which need not be
as many as another rank's: a ``Conv`` reads the rows its window needs
beyond its own from its neighbours (:func:`conv_rows`), a
``ConvTranspose`` the rows that add into its output rows
(:func:`conv_transpose_rows`), a ``BatchNorm`` adds its sums and counts
over the data and model ranks, a ``SqueezeExcitation`` its means' sums and
counts over the model ranks. The global height of a map comes from the
forward's row plan (``core/mesh.py::global_rows``).
"""

from __future__ import annotations

import contextlib
import threading
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from tpudepth_torch.core.mesh import (
    Mesh,
    all_reduce_sum,
    current_axis,
    fetch_rows,
    global_rows,
    record_rows,
    row_bounds,
    rows_mesh,
    sum_with_count,
)
from tpudepth_torch.ops.image import global_avg_pool
from tpudepth_torch.ops.kernels.mlp_infer import mlp_infer
from tpudepth_torch.ops.kernels.mlp_train import mlp_train
from tpudepth_torch.ops.packed import (
    BlockSpec,
    block_total,
    pack_conv_kernel,
    tile_channel,
)

BN_MOMENTUM = 0.1
BN_EPS = 1e-5


def relu(x: torch.Tensor) -> torch.Tensor:
    return F.relu(x)


def leaky_relu_02(x: torch.Tensor) -> torch.Tensor:
    """LeakyReLU(0.2) of the DenseDepth and U-Net conv blocks
    (``src/models/model_mobileV3.py:13-15``)."""
    return F.leaky_relu(x, negative_slope=0.2)


def hardswish(x: torch.Tensor) -> torch.Tensor:
    """``x * relu6(x + 3) / 6`` in the JAX package's operation order."""
    return x * torch.clamp(x + 3.0, 0.0, 6.0) / 6.0


def hardsigmoid(x: torch.Tensor) -> torch.Tensor:
    """``relu6(x + 3) / 6``."""
    return torch.clamp(x + 3.0, 0.0, 6.0) / 6.0


def make_divisible(v: float, divisor: int = 8) -> int:
    """Channel rounding of the MobileNetV3 paper and torchvision."""
    new_v = max(divisor, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


_RECOMPUTE = threading.local()


@contextlib.contextmanager
def _recomputing():
    before = getattr(_RECOMPUTE, "on", False)
    _RECOMPUTE.on = True
    try:
        yield
    finally:
        _RECOMPUTE.on = before


def rematerialize(fn: Callable, *args):
    """``fn(*args)`` under ``torch.utils.checkpoint`` (non-reentrant): only
    the inputs are saved for the backward, which runs ``fn`` again. The
    recomputation runs in a context in which :class:`BatchNorm` leaves its
    running statistics alone, so a rematerialized train step moves them
    once, as the plain step does (JAX returns the mutated ``batch_stats``
    from its one forward; ``tpudepth/train/trainer.py:194-205``)."""
    from torch.utils.checkpoint import checkpoint

    return checkpoint(fn, *args, use_reentrant=False,
                      context_fn=lambda: (contextlib.nullcontext(),
                                          _recomputing()))


def conv_plan(h_in: int, kernel: int, stride: int, padding: int,
              dilation: int, num_model: int
              ) -> List[Tuple[int, int, int, int, int, int]]:
    """How a conv (along H: ``kernel``, ``stride``, ``padding``,
    ``dilation``) of an ``h_in``-row map splits over ``num_model`` row
    shards: per rank ``(o0, o1, lo, hi, top, bottom)``, its output rows
    ``[o0, o1)`` (``core/mesh.py::row_bounds``), the input rows ``[lo, hi)``
    they read and the rows of zero padding above and below them. Output row
    ``j`` reads input rows ``s j - p`` to ``s j - p + d (k - 1)``; rows
    outside ``[0, h_in)`` are the padding. A rank with no output rows reads
    none."""
    h_out = (h_in + 2 * padding - dilation * (kernel - 1) - 1) // stride + 1
    bounds = row_bounds(h_out, num_model)
    plan = []
    for o0, o1 in zip(bounds, bounds[1:]):
        a = stride * o0 - padding
        if o1 == o0:
            lo = min(max(a, 0), h_in)
            plan.append((o0, o1, lo, lo, 0, 0))
            continue
        b = stride * (o1 - 1) - padding + dilation * (kernel - 1) + 1
        lo, hi = max(a, 0), min(b, h_in)
        plan.append((o0, o1, lo, hi, lo - a, b - hi))
    return plan


def conv_strip(strip: torch.Tensor, weight: torch.Tensor,
               bias: Optional[torch.Tensor], rows, stride, padding,
               dilation, groups: int) -> torch.Tensor:
    """A conv's output rows ``rows`` (an entry of :func:`conv_plan`) from the
    input rows ``[lo, hi)`` they read (``strip``): the strip padded with
    its rows of zeros, the conv without H padding. No output rows: the
    conv of one window of zeros, none of its rows kept, so the weight
    still gets a (zero) gradient on this rank."""
    top, bottom = rows[4], rows[5]
    if rows[0] == rows[1]:
        top, bottom = 0, dilation[0] * (weight.shape[2] - 1) + 1
    if top or bottom:
        strip = F.pad(strip, (0, 0, top, bottom))
    out = F.conv2d(strip, weight, bias, stride, (0, padding[1]), dilation,
                   groups)
    return out[:, :, :rows[1] - rows[0]]


def conv_rows(x: torch.Tensor, weight: torch.Tensor,
              bias: Optional[torch.Tensor], stride, padding, dilation,
              groups: int, mesh: Mesh) -> torch.Tensor:
    """``F.conv2d`` of a map of which this rank holds the rows ``x``: the
    rows of its output, from its own input rows and the halo rows its
    neighbours send (``core/mesh.py::fetch_rows``); the output's global
    height goes into the row plan. A conv of one row at stride 1 without
    H padding reads each row alone: it runs on this rank's rows as they
    are (the SE's 1x1 convs run so on its ``[B, C, 1, 1]`` means)."""
    if weight.shape[2] == 1 and stride[0] == 1 and padding[0] == 0:
        return F.conv2d(x, weight, bias, stride, padding, dilation, groups)
    h_in = global_rows(x, mesh)
    plan = conv_plan(h_in, weight.shape[2], stride[0], padding[0],
                     dilation[0], mesh.num_model)
    strip = fetch_rows(x, [(lo, hi) for _, _, lo, hi, _, _ in plan], mesh,
                       h_in)
    out = conv_strip(strip, weight, bias, plan[mesh.model_rank], stride,
                     padding, dilation, groups)
    record_rows(mesh, plan[-1][1], out.shape[3])
    return out


def transpose_plan(h_in: int, kernel: int, stride: int, num_model: int
                   ) -> List[Tuple[int, int, int, int]]:
    """How a transposed conv (along H: ``kernel``, ``stride``, no padding,
    ``kernel >= stride``) of an ``h_in``-row map splits over ``num_model``
    row shards: per rank ``(o0, o1, lo, hi)``, its output rows ``[o0, o1)``
    (``core/mesh.py::row_bounds``) and the input rows ``[lo, hi)`` that add
    into them. Input row ``i`` adds into output rows ``s i`` to ``s i + k -
    1`` (k = s = 2: output rows ``2i`` and ``2i + 1`` read input row ``i``
    alone), so output row ``j`` reads input rows ``ceil((j - k + 1) / s)``
    to ``floor(j / s)``."""
    h_out = (h_in - 1) * stride + kernel
    bounds = row_bounds(h_out, num_model)
    plan = []
    for o0, o1 in zip(bounds, bounds[1:]):
        lo = min(max(-((kernel - 1 - o0) // stride), 0), h_in)
        hi = lo if o1 == o0 else max(min((o1 - 1) // stride + 1, h_in), lo)
        plan.append((o0, o1, lo, hi))
    return plan


def transpose_strip(strip: torch.Tensor, weight: torch.Tensor,
                    bias: Optional[torch.Tensor], rows,
                    stride) -> torch.Tensor:
    """A transposed conv's output rows ``rows`` (an entry of
    :func:`transpose_plan`) from the input rows ``[lo, hi)`` that add into
    them (``strip``): the strip's transposed conv, whose first row is
    output row ``s lo``, cut to ``[o0, o1)``. No input rows: one row of
    zeros, none of its outputs kept (the weight's gradient stays
    connected)."""
    o0, o1, lo, hi = rows
    if hi == lo:
        strip = F.pad(strip, (0, 0, 0, 1))
    out = F.conv_transpose2d(strip, weight, bias, stride)
    first = stride[0] * lo
    return out[:, :, o0 - first:o1 - first]


def conv_transpose_rows(x: torch.Tensor, weight: torch.Tensor,
                        bias: Optional[torch.Tensor], stride,
                        mesh: Mesh) -> torch.Tensor:
    """``F.conv_transpose2d`` (no padding) of a map of which this rank holds
    the rows ``x``: the rows of its output (:func:`transpose_plan`), from
    the input rows that add into them, its neighbours' too when the output's
    shards do not line up with twice the input's."""
    h_in = global_rows(x, mesh)
    plan = transpose_plan(h_in, weight.shape[2], stride[0], mesh.num_model)
    strip = fetch_rows(x, [(lo, hi) for _, _, lo, hi in plan], mesh, h_in)
    out = transpose_strip(strip, weight, bias, plan[mesh.model_rank], stride)
    record_rows(mesh, plan[-1][1], out.shape[3])
    return out


class Conv(nn.Conv2d):
    """``nn.Conv2d`` whose f32 weight and bias are cast to the input dtype.

    With ``block`` the input and output are packed (``ops/packed.py``): the
    conv runs with the packed kernel gathered from the same ``weight``
    (stride 1, groups 1, padding ``k//2`` only), and ``input_splits`` says
    the input is a plain concat of packed parts with these original channel
    counts (``tpudepth/models/layers.py:65-170``). Marked to run on rows
    under a model axis, it runs :func:`conv_rows`."""

    def forward(self, x: torch.Tensor, block: Optional[BlockSpec] = None,
                input_splits: Optional[Sequence[int]] = None) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        if block is None:
            mesh = rows_mesh(self)
            if mesh is not None:
                return conv_rows(x, self.weight.to(x.dtype), bias,
                                 self.stride, self.padding, self.dilation,
                                 self.groups, mesh)
            return self._conv_forward(x, self.weight.to(x.dtype), bias)
        k = self.kernel_size[0]
        if (self.stride != (1, 1) or self.groups != 1
                or self.padding != ((k - 1) // 2,) * 2):
            raise ValueError("a packed conv takes stride 1, groups 1 and "
                             "padding k//2")
        wp, pads = pack_conv_kernel(self.weight, block, input_splits)
        if bias is not None:
            bias = tile_channel(bias, block)
        return F.conv2d(x, wp.to(x.dtype), bias, padding=pads)


class ConvTranspose(nn.ConvTranspose2d):
    """``nn.ConvTranspose2d(k=2, s=2)`` (the U-Net's ``Up``,
    ``src/models/model_mobileV3_Unet.py:58``; ``tpudepth/models/layers.py
    ::ConvTranspose``) whose f32 weight ``[in, out, k, k]`` and bias are cast
    to the input dtype. Its weight is flax's kernel transposed and flipped in
    space (``jax_weights``). Marked to run on rows under a model axis, it
    runs :func:`conv_transpose_rows`."""

    def __init__(self, cin: int, cout: int, kernel_size: int = 2,
                 stride: int = 2):
        super().__init__(cin, cout, kernel_size, stride)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        mesh = rows_mesh(self)
        if mesh is not None:
            return conv_transpose_rows(x, self.weight.to(x.dtype), bias,
                                       self.stride, mesh)
        return F.conv_transpose2d(x, self.weight.to(x.dtype), bias,
                                  self.stride)


class Linear(nn.Linear):
    """``nn.Linear`` whose f32 parameters are cast to the input dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.linear(x, self.weight.to(x.dtype), bias)


class BatchNorm(nn.BatchNorm2d):
    """BatchNorm (torch momentum and eps, 0.1 and 1e-5 unless given) with f32
    parameters and statistics,
    computing what ``tpudepth/models/layers.py::BatchNorm`` (flax
    ``nn.BatchNorm``) computes.

    In train mode the batch mean and the BIASED variance
    (``max(E[x^2] - E[x]^2, 0)``) are reduced in f32 over the compute-dtype
    tensor, the running statistics move by the momentum towards them (the
    running variance takes the biased variance, where ``nn.BatchNorm2d``
    would take the unbiased one), and the normalization runs in the compute
    dtype in flax's operation order,
    ``(x - mean) * (rsqrt(var + eps) * scale) + bias``. The
    ``num_batches_tracked`` buffer stays in the ``state_dict`` for the
    reference key layout and is not counted up (nothing reads it).

    In eval it applies the per-channel affine of :meth:`eval_affine`
    (``x * A + C``, the form the fused GUB kernels take as their prelude).
    :meth:`train_affine` gives the same form from batch statistics, for the
    fused GUB stages in train mode.

    With ``block`` the input is packed: the statistics reduce per ORIGINAL
    channel over the ``by*bx`` packed copies, the running statistics keep
    their ``[C]`` shapes and the affine is tiled to the packed channels
    (``_PackedBatchNormInner``, ``tpudepth/models/layers.py:242-300``).
    The running statistics do not move while :func:`rematerialize`
    recomputes a forward.

    Under a data axis (``core/mesh.py::data_axis``, entered by the train
    step of a process group) every batch statistic is the global batch's,
    as under JAX's data-sharded ``jit``: the moments, or a fused kernel's
    sums, are SUM-all-reduced with autograd, so the running statistics move
    alike on every rank. ``nn.SyncBatchNorm`` is not used: it moves the
    running variance by the unbiased variance. Marked to run on rows under
    a model axis, it adds the sums and element counts of every rank's rows
    over the data and model ranks instead (:meth:`_batch_moments`: shards
    of unequal rows weigh by their rows); a BatchNorm on the whole map
    reduces over the data ranks only."""

    def __init__(self, num_features: int, eps: float = BN_EPS,
                 momentum: float = BN_MOMENTUM):
        super().__init__(num_features, eps=eps, momentum=momentum)

    def eval_affine(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """f32 ``(A, C)`` with ``normalize(x) == x * A + C`` from the running
        statistics (``tpudepth/models/layers.py:289-291``)."""
        a = torch.rsqrt(self.running_var + self.eps) * self.weight
        return a, self.bias - self.running_mean * a

    def _move_running(self, mean: torch.Tensor, var: torch.Tensor):
        if getattr(_RECOMPUTE, "on", False):
            return
        with torch.no_grad():
            self.running_mean.mul_(1.0 - self.momentum).add_(
                mean, alpha=self.momentum)
            self.running_var.mul_(1.0 - self.momentum).add_(
                var, alpha=self.momentum)

    def train_affine(self, y: Optional[torch.Tensor] = None,
                     sums: Optional[Tuple[torch.Tensor, torch.Tensor, float]]
                     = None, block: Optional[BlockSpec] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(A, C)`` with ``normalize(y) == y * A + C`` from BATCH
        statistics, and the running statistics moved towards them: the
        counterpart of ``_PackedBatchNormInner(stats_in=, as_vectors=True)``
        (``tpudepth/models/layers.py:254-291``).

        The statistics come from ``sums = (sum, sum_sq, n)`` per channel (a
        fused conv kernel's epilogue) or are reduced from ``y`` ``[B,C,H,W]``
        itself: ``mean = s/n``, ``var = max(q/n - mean^2, 0)``, ``A =
        rsqrt(var + eps) * weight``, ``C = bias - mean * A``. With ``block``,
        ``y`` and the sums are per packed channel and fold to the original
        channels (``n`` counts every pixel of an original channel); ``A``
        and ``C`` stay ``[C]``. The vectors are in the parameters' dtype and
        carry autograd through ``s`` and ``q`` (or ``y``): the BatchNorm
        chain rule is this tensor math's."""
        if sums is not None:
            s, q, n = sums
            if block is not None:
                b2 = block_total(block)
                s, q = s.reshape(b2, -1).sum(0), q.reshape(b2, -1).sum(0)
            rows, mesh = rows_mesh(self), current_axis()
            if rows is not None:
                # the sums and counts of every rank's rows, once
                (s, q), n = sum_with_count(torch.stack([s, q]), n, rows,
                                           "grid")
            elif mesh is not None:
                # the global batch's sums, once, after the packed fold
                s, q = all_reduce_sum(torch.stack([s, q]), mesh)
                n = n * mesh.world
            mean, mean2 = s / n, q / n
        else:
            mean, mean2 = self._batch_moments(y.to(self.weight.dtype), block)
        var = torch.clamp(mean2 - mean * mean, min=0.0)
        self._move_running(mean.detach(), var.detach())
        a = torch.rsqrt(var + self.eps) * self.weight
        return a, self.bias - mean * a

    def _batch_moments(self, xf: torch.Tensor, block: Optional[BlockSpec]):
        """The batch's ``E[x]`` and ``E[x^2]`` per (original) channel
        (:meth:`_moments`); on rows under a model axis from the sums and
        element counts of every rank's rows, added over the data and model
        ranks (``sum_with_count``, with autograd): row shards need not be
        equal."""
        rows = rows_mesh(self)
        if rows is None:
            return self._moments(xf, block)
        xf, dims = self._by_channel(xf, block)
        s = torch.stack([xf.sum(dim=dims), (xf * xf).sum(dim=dims)])
        (s, q), n = sum_with_count(s, xf.numel() // s.shape[1], rows, "grid")
        return s / n, q / n

    @staticmethod
    def _by_channel(xf: torch.Tensor, block: Optional[BlockSpec]):
        """``xf`` viewed so that the dims returned reduce each (original)
        channel."""
        if block is None:
            return xf, (0, 2, 3)
        b2 = block_total(block)
        return (xf.reshape(xf.shape[0], b2, xf.shape[1] // b2, *xf.shape[2:]),
                (0, 1, 3, 4))

    @staticmethod
    def _moments(xf: torch.Tensor, block: Optional[BlockSpec]):
        """``E[x]`` and ``E[x^2]`` per (original) channel; under a data axis
        (``core/mesh.py::data_axis``) those of the global batch: the SUM
        all-reduce of the rank's moments over the world size (the shards
        are equal), with autograd."""
        xf, dims = BatchNorm._by_channel(xf, block)
        mean, mean2 = xf.mean(dim=dims), (xf * xf).mean(dim=dims)
        mesh = current_axis()
        if mesh is not None:
            mean, mean2 = all_reduce_sum(torch.stack([mean, mean2]),
                                         mesh) / mesh.world
        return mean, mean2

    def forward(self, x: torch.Tensor,
                block: Optional[BlockSpec] = None) -> torch.Tensor:
        dt = x.dtype

        def per_channel(v: torch.Tensor) -> torch.Tensor:
            v = v.to(dt)
            if block is not None:
                v = tile_channel(v, block)
            return v[None, :, None, None]

        if not self.training:
            a, c = self.eval_affine()
            return x * per_channel(a) + per_channel(c)
        xf = x if x.dtype == torch.float64 else x.float()
        mean, mean2 = self._batch_moments(xf, block)
        var = torch.clamp(mean2 - mean * mean, min=0.0)
        self._move_running(mean.detach(), var.detach())
        mul = torch.rsqrt(var.to(dt) + self.eps) * self.weight.to(dt)
        return ((x - per_channel(mean)) * per_channel(mul)
                + per_channel(self.bias))


class Hardswish(nn.Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return hardswish(x)


class ConvBNAct(nn.Sequential):
    """conv (no bias) -> BatchNorm -> activation (``tpudepth/models/layers.py
    ::ConvBNAct``), laid out as torchvision's ``Conv2dNormActivation``
    (``0`` conv, ``1`` BatchNorm, ``2`` activation), so its ``state_dict``
    keys are torchvision's."""

    def __init__(self, cin: int, cout: int, kernel_size: int = 3,
                 stride: int = 1, groups: int = 1, act: Optional[str] = "relu",
                 bn_eps: float = BN_EPS, bn_momentum: float = BN_MOMENTUM):
        layers = [Conv(cin, cout, kernel_size, stride, (kernel_size - 1) // 2,
                       groups=groups, bias=False),
                  BatchNorm(cout, eps=bn_eps, momentum=bn_momentum)]
        if act == "relu":
            layers.append(nn.ReLU())
        elif act == "hardswish":
            layers.append(Hardswish())
        elif act is not None:
            raise ValueError(f"unknown activation {act!r}")
        super().__init__(*layers)


class SqueezeExcitation(nn.Module):
    """torchvision's MobileNetV3 SE: spatial mean, 1x1 conv ``fc1``, ReLU,
    1x1 conv ``fc2``, hardsigmoid scale. On rows the mean is the whole
    image's (``ops/image.py::global_avg_pool``)."""

    def __init__(self, channels: int, squeeze_channels: int):
        super().__init__()
        self.fc1 = Conv(channels, squeeze_channels, 1)
        self.fc2 = Conv(squeeze_channels, channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = global_avg_pool(x, keepdims=True, rows=rows_mesh(self))
        s = self.fc2(relu(self.fc1(s)))
        return x * hardsigmoid(s)


class LayerNorm(nn.Module):
    """LayerNorm over the last dim with flax's formula
    (``tpudepth/models/layers.py::LayerNorm``, ``nn.LayerNorm(epsilon=1e-5)``):
    ``mean`` and the fast variance ``max(E[x^2] - mean^2, 0)`` in f32,
    ``(x - mean) * (rsqrt(var + eps) * weight) + bias`` in f32, rounded to
    the input dtype. Parameters ``weight`` / ``bias`` as ``nn.LayerNorm``."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        mean = xf.mean(dim=-1, keepdim=True)
        var = torch.clamp((xf * xf).mean(dim=-1, keepdim=True) - mean * mean,
                          min=0.0)
        mul = torch.rsqrt(var + self.eps) * self.weight
        return ((xf - mean) * mul + self.bias).to(x.dtype)


class Mlp(nn.Module):
    """Transformer FFN ``fc2(gelu(fc1(x)))`` with the exact (erf) GELU
    (``tpudepth/models/layers.py::Mlp``). With ``kernel=True`` it runs
    through the FFN kernels, the hidden activation held on the chip: in
    eval the ``mlp_infer`` kernel (``ops/kernels/mlp_infer.py``), in train
    mode the ``mlp_train`` pair with its analytic backward
    (``ops/kernels/mlp_train.py``), as the JAX package on its chip; on CPU
    tensors their plain versions. ``kernel=False`` is the plain composition,
    which the JAX package computes on the CPU."""

    def __init__(self, dim: int, hidden: int, kernel: bool = False):
        super().__init__()
        self.fc1 = Linear(dim, hidden)
        self.fc2 = Linear(hidden, dim)
        self.kernel = kernel

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.kernel:
            return self.fc2(F.gelu(self.fc1(x)))
        ffn = mlp_train if self.training else mlp_infer
        y = ffn(x.reshape(-1, x.shape[-1]), self.fc1.weight.t(),
                self.fc1.bias, self.fc2.weight.t(), self.fc2.bias)
        return y.reshape(*x.shape[:-1], y.shape[-1])


@torch.no_grad()
def init_random_(model: nn.Module, seed: int) -> nn.Module:
    """Fill every parameter and BatchNorm statistic from a seeded numpy
    generator, so the same seed gives the same model on any device.

    Conv and Linear weights are lecun-normal (std 1/sqrt(fan_in)), biases
    N(0, 0.05); a transposed conv's fan-in is the terms each output sums,
    ``in * k * k / stride^2``; BatchNorm weight U(0.5, 1.5), bias N(0, 0.1), running mean
    N(0, 0.1) and running var U(0.5, 1.5), so every BN affine differs from
    the identity; LayerNorm weight U(0.5, 1.5), bias N(0, 0.1); a
    relative-position bias table N(0, 0.02) truncated at 2 standard
    deviations (``tpudepth/models/sam.py:51-56``)."""
    rng = np.random.default_rng(seed)

    def fill(t: torch.Tensor, arr: np.ndarray):
        t.copy_(torch.from_numpy(arr.astype(np.float32)))

    for m in model.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear, nn.ConvTranspose2d)):
            fan_in = m.weight[0].numel()
            if isinstance(m, nn.ConvTranspose2d):
                fan_in = (m.weight.shape[0] * m.weight[0, 0].numel()
                          // (m.stride[0] * m.stride[1]))
            fill(m.weight, rng.standard_normal(m.weight.shape) / np.sqrt(fan_in))
            if m.bias is not None:
                fill(m.bias, 0.05 * rng.standard_normal(m.bias.shape))
        elif isinstance(m, nn.BatchNorm2d):
            c = m.num_features
            fill(m.weight, rng.uniform(0.5, 1.5, c))
            fill(m.bias, 0.1 * rng.standard_normal(c))
            fill(m.running_mean, 0.1 * rng.standard_normal(c))
            fill(m.running_var, rng.uniform(0.5, 1.5, c))
        elif isinstance(m, LayerNorm):
            fill(m.weight, rng.uniform(0.5, 1.5, m.weight.shape))
            fill(m.bias, 0.1 * rng.standard_normal(m.bias.shape))
        table = m._parameters.get("relative_position_bias_table")
        if table is not None:
            fill(table, 0.02 * np.clip(rng.standard_normal(table.shape),
                                       -2.0, 2.0))
    return model
