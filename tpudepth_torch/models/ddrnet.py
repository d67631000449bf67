"""DDRNet-23-slim dual-resolution backbone (NCHW).

Counterpart of ``tpudepth/models/ddrnet.py``. Module names follow the
reference PyTorch ``state_dict`` keys (``src/GuideDepth/model/DDRNet_23_slim.py``,
as ``tpudepth/models/torch_import.py::_ddrnet`` documents them), e.g.
``conv1.0`` (stem conv, with bias), ``layer3_.1.bn2``, ``down4.3``,
``spp.scale1.1``.

Under a model axis (``core/mesh.py``) the input and the output are this
rank's image rows. The high-resolution branch runs on rows (``conv1``,
``layer1``, ``layer2``, ``layer3_``, ``layer4_``, ``layer5_``,
``final_layer``), and the context branch on the whole map, gathered by
``despatialize`` where the JAX package places its calls
(``tpudepth/models/ddrnet.py:226-263``): after ``layer3`` and ``down3``,
which run on rows, and before ``layer4``, ``layer5`` and ``spp``. One
point lies earlier than JAX's: ``down4``'s second stride-2 conv runs whole
(JAX gathers after it), so that no map on rows lies below 1/16 of the
image (JAX's own test shape, 64 rows over 4 ranks, leaves 2 rows at 1/32
for 4 ranks). Any input height that the model axis divides runs: the maps
below it split by ``core/mesh.py::row_bounds`` (NYU's 480 rows over 4
ranks leave 30 rows at 1/16, 8, 8, 7 and 7 a rank). Whole maps join the
branch on rows resized to the global size, then ``take_rows``.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from tpudepth_torch.core.mesh import (
    despatialize,
    input_rows,
    run_on_rows,
    spatial_mesh,
    take_rows,
)
from tpudepth_torch.models.layers import BatchNorm, Conv, relu
from tpudepth_torch.ops.image import avg_pool, global_avg_pool, resize_bilinear


class BasicBlock(nn.Module):
    def __init__(self, in_planes: int, planes: int, stride: int = 1,
                 has_downsample: bool = False, no_relu: bool = False):
        super().__init__()
        self.conv1 = Conv(in_planes, planes, 3, stride, padding=1, bias=False)
        self.bn1 = BatchNorm(planes)
        self.conv2 = Conv(planes, planes, 3, 1, padding=1, bias=False)
        self.bn2 = BatchNorm(planes)
        self.downsample = None
        if has_downsample:
            self.downsample = nn.Sequential(
                Conv(in_planes, planes, 1, stride, bias=False),
                BatchNorm(planes))
        self.no_relu = no_relu

    def forward(self, x):
        out = relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        residual = x if self.downsample is None else self.downsample(x)
        out = out + residual
        return out if self.no_relu else relu(out)


class Bottleneck(nn.Module):
    expansion = 2

    def __init__(self, in_planes: int, planes: int, stride: int = 1,
                 has_downsample: bool = False, no_relu: bool = True):
        super().__init__()
        out_planes = planes * self.expansion
        self.conv1 = Conv(in_planes, planes, 1, bias=False)
        self.bn1 = BatchNorm(planes)
        self.conv2 = Conv(planes, planes, 3, stride, padding=1, bias=False)
        self.bn2 = BatchNorm(planes)
        self.conv3 = Conv(planes, out_planes, 1, bias=False)
        self.bn3 = BatchNorm(out_planes)
        self.downsample = None
        if has_downsample:
            self.downsample = nn.Sequential(
                Conv(in_planes, out_planes, 1, stride, bias=False),
                BatchNorm(out_planes))
        self.no_relu = no_relu

    def forward(self, x):
        out = relu(self.bn1(self.conv1(x)))
        out = relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        residual = x if self.downsample is None else self.downsample(x)
        out = out + residual
        return out if self.no_relu else relu(out)


class _Stage(nn.Sequential):
    """``_make_layer`` (``DDRNet_23_slim.py:291-309``): the first block may
    downsample; the last block of a multi-block stage has no relu."""

    def __init__(self, in_planes: int, planes: int, blocks: int,
                 stride: int = 1, bottleneck: bool = False):
        cls = Bottleneck if bottleneck else BasicBlock
        expansion = 2 if bottleneck else 1
        need_ds = stride != 1 or in_planes != planes * expansion
        mods = [cls(in_planes, planes, stride, has_downsample=need_ds)]
        for i in range(1, blocks):
            mods.append(cls(planes * expansion, planes, 1,
                            no_relu=(i == blocks - 1)))
        super().__init__(*mods)


class _Pool(nn.Module):
    """DAPPM pooling front of a scale branch: ``nn.AvgPool2d`` with
    count_include_pad, or the global average (``window=0``)."""

    def __init__(self, window: int = 0, stride: int = 1, padding: int = 0):
        super().__init__()
        self.window, self.stride, self.padding = window, stride, padding

    def forward(self, x):
        if self.window == 0:
            return global_avg_pool(x, keepdims=True)
        return avg_pool(x, self.window, self.stride, self.padding)


def _bn_relu_conv(cin: int, cout: int, k: int = 1):
    """BN -> ReLU -> Conv, the DAPPM branch unit (``DDRNet_23_slim.py:138-142``)."""
    return [BatchNorm(cin), nn.ReLU(),
            Conv(cin, cout, k, padding=(k - 1) // 2, bias=False)]


class DAPPM(nn.Module):
    """Deep Aggregation Pyramid Pooling (``DDRNet_23_slim.py:115-195``)."""

    def __init__(self, in_planes: int, branch_planes: int, out_planes: int):
        super().__init__()
        bp = branch_planes
        self.scale0 = nn.Sequential(*_bn_relu_conv(in_planes, bp))
        pools = [(5, 2, 2), (9, 4, 4), (17, 8, 8), (0, 1, 0)]
        for i, (win, st, pad) in enumerate(pools, start=1):
            setattr(self, f"scale{i}", nn.Sequential(
                _Pool(win, st, pad), *_bn_relu_conv(in_planes, bp)))
            setattr(self, f"process{i}", nn.Sequential(
                *_bn_relu_conv(bp, bp, 3)))
        self.compression = nn.Sequential(*_bn_relu_conv(bp * 5, out_planes))
        self.shortcut = nn.Sequential(*_bn_relu_conv(in_planes, out_planes))

    def forward(self, x):
        size = x.shape[2:]
        outs = [self.scale0(x)]
        for i in range(1, 5):
            s = getattr(self, f"scale{i}")(x)
            outs.append(getattr(self, f"process{i}")(
                resize_bilinear(s, size) + outs[-1]))
        return (self.compression(torch.cat(outs, dim=1))
                + self.shortcut(x))


class SegmentHead(nn.Module):
    """BN-ReLU-conv3 -> BN-ReLU-conv1 head (``DDRNet_23_slim.py:198-219``)."""

    def __init__(self, in_planes: int, inter_planes: int, out_planes: int):
        super().__init__()
        self.bn1 = BatchNorm(in_planes)
        self.conv1 = Conv(in_planes, inter_planes, 3, padding=1, bias=False)
        self.bn2 = BatchNorm(inter_planes)
        self.conv2 = Conv(inter_planes, out_planes, 1, bias=True)

    def forward(self, x):
        x = self.conv1(relu(self.bn1(x)))
        return self.conv2(relu(self.bn2(x)))


def _conv_bn(cin: int, cout: int, k: int = 1, stride: int = 1):
    return [Conv(cin, cout, k, stride, padding=(k - 1) // 2, bias=False),
            BatchNorm(cout)]


class DualResNetBackbone(nn.Module):
    """DDRNet-23-slim: planes 32, layers [2,2,2,2], spp 128, head 64
    (``DDRNet_23_slim.py:357-365``). Returns a ``features``-channel map at
    1/8 of the input resolution."""

    def __init__(self, features: int = 64, planes: int = 32,
                 spp_planes: int = 128, head_planes: int = 64):
        super().__init__()
        p = planes
        hp = p * 2
        self.conv1 = nn.Sequential(
            Conv(3, p, 3, 2, padding=1, bias=True), BatchNorm(p), nn.ReLU(),
            Conv(p, p, 3, 2, padding=1, bias=True), BatchNorm(p), nn.ReLU())
        self.layer1 = _Stage(p, p, 2)
        self.layer2 = _Stage(p, p * 2, 2, stride=2)
        self.layer3 = _Stage(p * 2, p * 4, 2, stride=2)
        self.layer4 = _Stage(p * 4, p * 8, 2, stride=2)
        self.layer3_ = _Stage(p * 2, hp, 2)
        self.layer4_ = _Stage(hp, hp, 2)
        self.layer5_ = _Stage(hp, hp, 1, bottleneck=True)
        self.layer5 = _Stage(p * 8, p * 8, 1, stride=2, bottleneck=True)
        self.compression3 = nn.Sequential(*_conv_bn(p * 4, hp))
        self.compression4 = nn.Sequential(*_conv_bn(p * 8, hp))
        self.down3 = nn.Sequential(*_conv_bn(hp, p * 4, 3, 2))
        self.down4 = nn.Sequential(*_conv_bn(hp, p * 4, 3, 2), nn.ReLU(),
                                   *_conv_bn(p * 4, p * 8, 3, 2))
        self.spp = DAPPM(p * 16, spp_planes, p * 4)
        self.final_layer = SegmentHead(p * 4, head_planes, features)
        run_on_rows(self.conv1, self.layer1, self.layer2, self.layer3,
                    self.layer3_, self.down3, self.layer4_, self.down4[0],
                    self.down4[1], self.layer5_, self.final_layer)

    def forward(self, x):
        mesh = spatial_mesh()
        rows = x.shape[2] if mesh is None else input_rows(x, mesh)
        size = (rows // 8, x.shape[3] // 8)
        h = self.conv1(x)
        l1 = self.layer1(h)
        l2 = self.layer2(relu(l1))
        l3 = despatialize(self.layer3(relu(l2)), mesh)
        x_ = self.layer3_(relu(l2))

        xm = l3 + despatialize(self.down3(relu(x_)), mesh)
        x_ = x_ + take_rows(
            resize_bilinear(self.compression3(relu(l3)), size), mesh)

        l4 = self.layer4(relu(xm))
        x_ = self.layer4_(relu(x_))
        # down4 = conv-BN on rows, ReLU, then conv-BN on the whole map
        xm = l4 + self.down4[3:](despatialize(self.down4[:3](relu(x_)), mesh))
        x_ = x_ + take_rows(
            resize_bilinear(self.compression4(relu(l4)), size), mesh)

        x_ = self.layer5_(relu(x_))
        l5 = self.layer5(relu(xm))
        xm = take_rows(resize_bilinear(self.spp(l5), size), mesh)
        return self.final_layer(xm + x_)
