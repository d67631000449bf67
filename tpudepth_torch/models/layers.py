"""Building blocks: float32 parameters cast to the input's dtype at use.

Counterpart of ``tpudepth/models/layers.py`` (unpacked only). A module's
compute dtype is its input's dtype; parameters and BatchNorm statistics stay
float32, as ``dtype=bf16, param_dtype=f32`` does in the JAX modules. BatchNorm
uses torch momentum 0.1 and eps 1e-5 by default (DDRNet and GUB); MobileNetV3
passes 0.01 and 1e-3.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from tpudepth_torch.ops.kernels.mlp_infer import mlp_infer
from tpudepth_torch.ops.kernels.mlp_train import mlp_train

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


class Conv(nn.Conv2d):
    """``nn.Conv2d`` whose f32 weight and bias are cast to the input dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return self._conv_forward(x, self.weight.to(x.dtype), bias)


class ConvTranspose(nn.ConvTranspose2d):
    """``nn.ConvTranspose2d(k=2, s=2)`` (the U-Net's ``Up``,
    ``src/models/model_mobileV3_Unet.py:58``; ``tpudepth/models/layers.py
    ::ConvTranspose``) whose f32 weight ``[in, out, k, k]`` and bias are cast
    to the input dtype. Its weight is flax's kernel transposed and flipped in
    space (``jax_weights``)."""

    def __init__(self, cin: int, cout: int, kernel_size: int = 2,
                 stride: int = 2):
        super().__init__(cin, cout, kernel_size, stride)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
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
    fused GUB stages in train mode."""

    def __init__(self, num_features: int, eps: float = BN_EPS,
                 momentum: float = BN_MOMENTUM):
        super().__init__(num_features, eps=eps, momentum=momentum)

    def eval_affine(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """f32 ``(A, C)`` with ``normalize(x) == x * A + C`` from the running
        statistics (``tpudepth/models/layers.py:289-291``)."""
        a = torch.rsqrt(self.running_var + self.eps) * self.weight
        return a, self.bias - self.running_mean * a

    def _move_running(self, mean: torch.Tensor, var: torch.Tensor):
        with torch.no_grad():
            self.running_mean.mul_(1.0 - self.momentum).add_(
                mean, alpha=self.momentum)
            self.running_var.mul_(1.0 - self.momentum).add_(
                var, alpha=self.momentum)

    def train_affine(self, y: Optional[torch.Tensor] = None,
                     sums: Optional[Tuple[torch.Tensor, torch.Tensor, float]]
                     = None) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(A, C)`` with ``normalize(y) == y * A + C`` from BATCH
        statistics, and the running statistics moved towards them: the
        counterpart of ``_PackedBatchNormInner(stats_in=, as_vectors=True)``
        (``tpudepth/models/layers.py:254-291``), unpacked.

        The statistics come from ``sums = (sum, sum_sq, n)`` per channel (a
        fused conv kernel's epilogue) or are reduced from ``y`` ``[B,C,H,W]``
        itself: ``mean = s/n``, ``var = max(q/n - mean^2, 0)``, ``A =
        rsqrt(var + eps) * weight``, ``C = bias - mean * A``. The vectors are
        in the parameters' dtype and carry autograd through ``s`` and ``q``
        (or ``y``): the BatchNorm chain rule is this tensor math's."""
        if sums is not None:
            s, q, n = sums
            mean, mean2 = s / n, q / n
        else:
            yf = y.to(self.weight.dtype)
            mean = yf.mean(dim=(0, 2, 3))
            mean2 = (yf * yf).mean(dim=(0, 2, 3))
        var = torch.clamp(mean2 - mean * mean, min=0.0)
        self._move_running(mean.detach(), var.detach())
        a = torch.rsqrt(var + self.eps) * self.weight
        return a, self.bias - mean * a

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = x.dtype

        def per_channel(v: torch.Tensor) -> torch.Tensor:
            return v.to(dt)[None, :, None, None]

        if not self.training:
            a, c = self.eval_affine()
            return x * per_channel(a) + per_channel(c)
        xf = x if x.dtype == torch.float64 else x.float()
        mean = xf.mean(dim=(0, 2, 3))
        var = torch.clamp((xf * xf).mean(dim=(0, 2, 3)) - mean * mean, min=0.0)
        self._move_running(mean.detach(), var.detach())
        mul = torch.rsqrt(var.to(dt) + self.eps) * self.weight.to(dt)
        return ((x - per_channel(mean)) * mul[None, :, None, None]
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
    1x1 conv ``fc2``, hardsigmoid scale."""

    def __init__(self, channels: int, squeeze_channels: int):
        super().__init__()
        self.fc1 = Conv(channels, squeeze_channels, 1)
        self.fc2 = Conv(squeeze_channels, channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = x.mean(dim=(2, 3), keepdim=True)
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
