"""GuideDepth: DDRNet-23-slim plus three Guided Upsampling Blocks (NCHW).

Counterpart of ``tpudepth/models/guidedepth.py`` (``src/GuideDepth/model/
GuideDepth.py`` and ``modules.py``). Module names follow the reference
PyTorch ``state_dict`` keys (``up_1.feature_conv.3``, ``up_1.SE_block.fc.0``,
``up_2.reduce``, ...).

A GUB runs one of two ways, with the same parameters and the same
arithmetic:

- plain: conv -> BN -> ReLU modules, SE scale, residual, reduce;
- fused (``fused_stages=True``): every k=3 conv is the ``gub_conv_fwd`` CUDA
  kernel (``ops/kernels/gub_conv.py``) with the previous BatchNorm's affine,
  the ReLU and the SE scale applied as it loads its input, so the normalized
  tensors feeding the k=3 convs are never written. In train mode the kernel
  also emits the per-channel sums its BatchNorm needs, the BatchNorm affine
  is f32 vector math on them (``BatchNorm.train_affine``), and the backward
  runs the ``gub_conv_dw`` and ``gub_conv_dx`` kernels. The k=1 convs take
  their prelude as plain tensor code, as the JAX package keeps them out of
  Pallas. The JAX package fuses only its space-to-depth packed stages; the
  port fuses all three stages unpacked, which is the same arithmetic.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.nn as nn

from tpudepth_torch.models.ddrnet import DualResNetBackbone
from tpudepth_torch.models.layers import BatchNorm, Conv, Linear
from tpudepth_torch.ops.image import resize_bilinear, resize_nearest
from tpudepth_torch.ops.kernels.gub_conv import conv_bn_act

Affine = Tuple[torch.Tensor, torch.Tensor]


def _conv_bn_relu(cin: int, cout: int, k: int) -> List[nn.Module]:
    """``_ConvBNRelu``: conv (with bias) -> BN -> ReLU."""
    return [Conv(cin, cout, k, padding=(k - 1) // 2, bias=True),
            BatchNorm(cout), nn.ReLU()]


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    """Contiguous NHWC view of an NCHW tensor (free when channels_last)."""
    return x.contiguous(memory_format=torch.channels_last).permute(0, 2, 3, 1)


def _nchw(y: torch.Tensor) -> torch.Tensor:
    """NCHW view (channels_last memory) of a contiguous NHWC tensor."""
    return y.permute(0, 3, 1, 2)


def _activate(y: torch.Tensor, pre: Affine, skip=None) -> torch.Tensor:
    """``relu(y*A + C) [+ skip]`` in f32 (f64 for f64 input), rounded to
    ``y``'s dtype, with ``A`` and ``C`` of shape ``[C]``: the prelude of a
    k=1 conv."""
    ct = torch.promote_types(y.dtype, torch.float32)
    a, c = (t.view(-1, 1, 1) for t in pre)
    z = torch.relu(y.to(ct) * a + c)
    if skip is not None:
        z = z + skip.to(ct)
    return z.to(y.dtype)


class SELayer(nn.Module):
    """Channel SE with a spatial-mean squeeze and bias-free linears
    (``modules.py:5-25``); reduction 1 in the GUB."""

    def __init__(self, channel: int, reduction: int):
        super().__init__()
        self.fc = nn.Sequential(
            Linear(channel, channel // reduction, bias=False), nn.ReLU(),
            Linear(channel // reduction, channel, bias=False), nn.Sigmoid())

    def excite(self, squeezed: torch.Tensor) -> torch.Tensor:
        """The excitation ``[B, C]`` (in (0, 1)) of the squeeze ``[B, C]``."""
        return self.fc(squeezed)

    def forward(self, x):
        return x * self.excite(x.mean(dim=(2, 3)))[:, :, None, None]


class GuidedUpsamplingBlock(nn.Module):
    """GUB (``modules.py:29-100``), guidance 'full', kernel size 3, RGB
    guide: feature branch and guide branch (conv3-BN-ReLU, conv1-BN-ReLU to
    expand//2 each) -> concat -> SE(reduction 1) -> comb conv back to
    in_features -> +depth -> 1x1 reduce."""

    def __init__(self, in_features: int, expand_features: int,
                 out_features: int, fused: bool = False):
        super().__init__()
        ef = expand_features
        self.feature_conv = nn.Sequential(
            *_conv_bn_relu(in_features, ef, 3), *_conv_bn_relu(ef, ef // 2, 1))
        self.guide_conv = nn.Sequential(
            *_conv_bn_relu(3, ef, 3), *_conv_bn_relu(ef, ef // 2, 1))
        self.comb_conv = nn.Sequential(
            *_conv_bn_relu(ef, ef, 3), *_conv_bn_relu(ef, in_features, 1))
        self.SE_block = SELayer(ef, reduction=1)
        self.reduce = Conv(in_features, out_features, 1, bias=True)
        self.fused = fused

    def forward(self, guide, depth):
        if self.fused:
            return self._fused(guide, depth)
        x = self.feature_conv(depth)
        y = self.guide_conv(guide)
        xy = self.SE_block(torch.cat([x, y], dim=1))
        r = self.comb_conv(xy)
        return self.reduce(r + depth)

    def _fused(self, guide, depth):
        """Fused execution (``tpudepth/models/guidedepth.py:161-184,
        243-293``); the normalized inputs of the k=3 convs exist only inside
        the kernel. In train mode every BatchNorm affine comes from batch
        statistics: a k=3 conv's from the sums its kernel emits, a k=1
        conv's reduced from its output."""
        train = self.training

        def conv3(parts: Sequence[torch.Tensor], conv: Conv, bn: BatchNorm,
                  preludes=None):
            out = conv_bn_act([_nhwc(p) for p in parts],
                              conv.weight.permute(2, 3, 1, 0), conv.bias,
                              preludes=preludes, stats=train)
            if not train:
                return _nchw(out), bn.eval_affine()
            y, s, q = out
            n = float(y.shape[0] * y.shape[1] * y.shape[2])
            return _nchw(y), bn.train_affine(sums=(s, q, n))

        def conv1(x: torch.Tensor, conv: Conv, bn: BatchNorm):
            y = conv(x)
            return y, bn.train_affine(y) if train else bn.eval_affine()

        fc, gc, cc = self.feature_conv, self.guide_conv, self.comb_conv
        y1, p1 = conv3([depth], fc[0], fc[1])
        y2, p2 = conv1(_activate(y1, p1), fc[3], fc[4])
        g1, q1 = conv3([guide], gc[0], gc[1])
        g2, q2 = conv1(_activate(g1, q1), gc[3], gc[4])

        # SE squeeze of the normalized branches, excitation folded into the
        # comb conv's preludes: relu(x*A + C) * e == relu(x*(A*e) + C*e)
        # because e = sigmoid(.) > 0.
        mx = _activate(y2, p2).mean(dim=(2, 3))
        mg = _activate(g2, q2).mean(dim=(2, 3))
        exc = self.SE_block.excite(torch.cat([mx, mg], dim=1)).to(p2[0].dtype)
        half = exc.shape[1] // 2
        pre_x = tuple((t[None] * exc[:, :half]).contiguous() for t in p2)
        pre_g = tuple((t[None] * exc[:, half:]).contiguous() for t in q2)

        y5, p5 = conv3([y2, g2], cc[0], cc[1], preludes=(pre_x, pre_g))
        y6, p6 = conv1(_activate(y5, p5), cc[3], cc[4])
        return self.reduce(_activate(y6, p6, skip=depth))


class GuideDepth(nn.Module):
    """``GuideDepth.py:9-57``: ``up_features=(64,32,16)`` or ``(32,8,4)`` for
    GuideDepth-S (``loader.py:19``). Input ``[B,3,H,W]``, output
    ``[B,1,H,W]``; the compute dtype is the input's."""

    def __init__(self, up_features: Sequence[int] = (64, 32, 16),
                 inner_features: Sequence[int] = (64, 32, 16),
                 fused_stages: bool = False):
        super().__init__()
        up, inner = list(up_features), list(inner_features)
        self.feature_extractor = DualResNetBackbone(features=up[0])
        outs = (up[1], up[2], 1)
        for i in range(3):
            setattr(self, f"up_{i + 1}", GuidedUpsamplingBlock(
                up[i], inner[i], outs[i], fused=fused_stages))

    def forward(self, x):
        y = self.feature_extractor(x)
        h, w = x.shape[2:]
        x_half = resize_nearest(x, (h // 2, w // 2))
        x_quarter = resize_nearest(x, (h // 4, w // 4))
        for i, guide in enumerate((x_quarter, x_half, x)):
            y = resize_bilinear(y, (y.shape[2] * 2, y.shape[3] * 2))
            y = getattr(self, f"up_{i + 1}")(guide, y)
        return y
