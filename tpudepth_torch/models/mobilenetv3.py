"""MobileNetV3 Large / Small feature encoders (NCHW).

Counterpart of ``tpudepth/models/mobilenetv3.py``: torchvision's channel and
SE conventions and its ``state_dict`` layout (``features.0.0``,
``features.{i}.block.{j}.0``, ``.fc1``, ``.fc2``), BatchNorm eps 1e-3 and
torch momentum 0.01. :class:`MobileNetV3Features` returns the input and the
output of every ``features`` module: 18 tensors for Large, 14 for Small,
the reference's feature list (``src/model_mobileV3_large_SAM.py:178-182``).

Under a model axis (``core/mesh.py``) the input is this rank's image rows
and the features down to 1/16 of the image run on rows; the first module
that reaches 1/32 (``first_whole``: ``features[13]`` of Large,
``features[9]`` of Small) takes its input despatialized, so the taps
``feats[:first_whole + 1]`` are rows and the deeper ones whole maps. The
1/32 maps are not split: at JAX's test shape (64 rows over 4 ranks) they
hold 2 rows for 4 ranks. The maps on rows need not split equally
(``core/mesh.py::row_bounds``): any input height the model axis divides
runs.
"""

from __future__ import annotations

from typing import List

import torch
import torch.nn as nn

from tpudepth_torch.core.mesh import (
    despatialize,
    input_rows,
    run_on_rows,
    spatial_mesh,
)
from tpudepth_torch.models.layers import (
    ConvBNAct,
    SqueezeExcitation,
    make_divisible,
)

# (kernel, exp_channels, out_channels, use_se, activation, stride): the
# torchvision mobilenet_v3_large / _small inverted-residual tables
LARGE_SPEC = [
    (3, 16, 16, False, "relu", 1),
    (3, 64, 24, False, "relu", 2),
    (3, 72, 24, False, "relu", 1),
    (5, 72, 40, True, "relu", 2),
    (5, 120, 40, True, "relu", 1),
    (5, 120, 40, True, "relu", 1),
    (3, 240, 80, False, "hardswish", 2),
    (3, 200, 80, False, "hardswish", 1),
    (3, 184, 80, False, "hardswish", 1),
    (3, 184, 80, False, "hardswish", 1),
    (3, 480, 112, True, "hardswish", 1),
    (3, 672, 112, True, "hardswish", 1),
    (5, 672, 160, True, "hardswish", 2),
    (5, 960, 160, True, "hardswish", 1),
    (5, 960, 160, True, "hardswish", 1),
]
LARGE_LAST = 960

SMALL_SPEC = [
    (3, 16, 16, True, "relu", 2),
    (3, 72, 24, False, "relu", 2),
    (3, 88, 24, False, "relu", 1),
    (5, 96, 40, True, "hardswish", 2),
    (5, 240, 40, True, "hardswish", 1),
    (5, 240, 40, True, "hardswish", 1),
    (5, 120, 48, True, "hardswish", 1),
    (5, 144, 48, True, "hardswish", 1),
    (5, 288, 96, True, "hardswish", 2),
    (5, 576, 96, True, "hardswish", 1),
    (5, 576, 96, True, "hardswish", 1),
]
SMALL_LAST = 576

BN_EPS = 1e-3       # torchvision MobileNetV3 BatchNorm
BN_MOMENTUM = 0.01  # torch momentum


def _cba(cin, cout, k=1, stride=1, groups=1, act=None) -> ConvBNAct:
    return ConvBNAct(cin, cout, k, stride, groups=groups, act=act,
                     bn_eps=BN_EPS, bn_momentum=BN_MOMENTUM)


class InvertedResidual(nn.Module):
    """expand 1x1 (left out when exp == in) -> depthwise k x k -> SE ->
    linear 1x1 project, plus the input when the shape is kept."""

    def __init__(self, cin: int, kernel: int, exp: int, cout: int,
                 use_se: bool, act: str, stride: int):
        super().__init__()
        self.use_residual = stride == 1 and cin == cout
        layers: List[nn.Module] = []
        if exp != cin:
            layers.append(_cba(cin, exp, 1, act=act))
        layers.append(_cba(exp, exp, kernel, stride, groups=exp, act=act))
        if use_se:
            layers.append(SqueezeExcitation(exp, make_divisible(exp // 4, 8)))
        layers.append(_cba(exp, cout, 1, act=None))
        self.block = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.block(x)
        return h + x if self.use_residual else h


class MobileNetV3Features(nn.Module):
    """``features`` of torchvision's MobileNetV3 (``arch`` 'large' or
    'small'); ``forward`` returns ``[x] + [output of every features
    module]``."""

    def __init__(self, arch: str = "large"):
        super().__init__()
        if arch not in ("large", "small"):
            raise ValueError(f"arch must be 'large' or 'small', not {arch!r}")
        spec = LARGE_SPEC if arch == "large" else SMALL_SPEC
        last = LARGE_LAST if arch == "large" else SMALL_LAST
        mods: List[nn.Module] = [_cba(3, 16, 3, 2, act="hardswish")]
        cin, stride = 16, 2
        self.first_whole = None
        for k, exp, out, se, act, s in spec:
            stride *= s
            if stride == 32 and self.first_whole is None:
                self.first_whole = len(mods)
            mods.append(InvertedResidual(cin, k, exp, out, se, act, s))
            cin = out
        mods.append(_cba(cin, last, 1, act="hardswish"))
        self.features = nn.Sequential(*mods)
        run_on_rows(*mods[:self.first_whole])

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        mesh = spatial_mesh()
        if mesh is not None:
            input_rows(x, mesh)
        feats = [x]
        for i, m in enumerate(self.features):
            h = feats[-1]
            if i == self.first_whole:
                h = despatialize(h, mesh)
            feats.append(m(h))
        return feats
