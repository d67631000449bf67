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
  Pallas.

Either way a stage may run packed (``packed=True``): in space-to-depth
layout (``ops/packed.py``), the upsampled depth made packed by
``upsample2x_pack``, the RGB guide folded by ``space_to_depth``, every conv
with the packed kernel gathered from its own weight and the output unfolded
by ``depth_to_space`` (``tpudepth/models/guidedepth.py:216-293, 372-386``).
The parameters are the same. Where the port differs: the JAX package fuses
only packed stages (``if packed and self.fused``), the port's fused mode
fuses every stage, an unpacked one (``up_1`` at GuideDepth's widths) too:
the same arithmetic, rounded in other places in bf16. The JAX package
packs by default; the port runs unpacked unless asked, until measurements
on the card decide.

Under a model axis (``core/mesh.py``) the input and the output are this
rank's image rows. The backbone runs its high-resolution branch on rows
(``models/ddrnet.py``); the guide images are taken on rows; a plain
unpacked GUB stage runs on rows (halo convs, BatchNorm over data x model,
the SE squeeze added over the model ranks). A fused or a packed stage needs
whole images (the kernels' per-channel sums would count halo rows and their
H padding would be wrong at a rank's edge): the stages then run on the
despatialized map and guides, and the output goes back to rows
(``take_rows``). Their BatchNorm sums go over the data ranks only.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn as nn

from tpudepth_torch.core.mesh import (
    despatialize,
    global_rows,
    input_rows,
    rows_mesh,
    run_on_rows,
    spatial_mesh,
    sum_with_count,
    take_rows,
)
from tpudepth_torch.models.ddrnet import DualResNetBackbone
from tpudepth_torch.models.layers import BatchNorm, Conv, Linear, rematerialize
from tpudepth_torch.ops.image import nhwc, resize_bilinear, resize_nearest
from tpudepth_torch.ops.kernels.gub_conv import conv_bn_act
from tpudepth_torch.ops.packed import (
    block_total,
    depth_to_space,
    pack_conv_kernel,
    packed_channel_mean,
    space_to_depth,
    tile_channel,
    upsample2x_pack,
)

Affine = Tuple[torch.Tensor, torch.Tensor]
Block = Optional[Tuple[int, int]]


def _conv_bn_relu(cin: int, cout: int, k: int) -> List[nn.Module]:
    """``_ConvBNRelu``: conv (with bias) -> BN -> ReLU."""
    return [Conv(cin, cout, k, padding=(k - 1) // 2, bias=True),
            BatchNorm(cout), nn.ReLU()]


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


def _run(layers: nn.Sequential, x: torch.Tensor, block: Block,
         input_splits: Optional[Sequence[int]] = None) -> torch.Tensor:
    """A branch's conv -> BN -> ReLU modules, packed with ``block``;
    ``input_splits`` go to its first conv."""
    for m in layers:
        if isinstance(m, Conv):
            x = m(x, block, input_splits)
            input_splits = None
        elif isinstance(m, BatchNorm):
            x = m(x, block)
        else:
            x = m(x)
    return x


class SELayer(nn.Module):
    """Channel SE with a spatial-mean squeeze and bias-free linears
    (``modules.py:5-25``); reduction 1 in the GUB.

    Packed (``block``): the squeeze averages the packed copies back to the
    original channels and the excitation is tiled back; ``splits``: the
    input is a plain concat of packed parts with these original channel
    counts, squeezed and scaled part by part (``guidedepth.py:78-147``). On
    rows the squeeze is the whole image's mean."""

    def __init__(self, channel: int, reduction: int):
        super().__init__()
        self.fc = nn.Sequential(
            Linear(channel, channel // reduction, bias=False), nn.ReLU(),
            Linear(channel // reduction, channel, bias=False), nn.Sigmoid())

    def excite(self, squeezed: torch.Tensor) -> torch.Tensor:
        """The excitation ``[B, C]`` (in (0, 1)) of the squeeze ``[B, C]``."""
        return self.fc(squeezed)

    @staticmethod
    def squeeze(x: torch.Tensor, block: Block = None,
                splits: Optional[Sequence[int]] = None,
                rows=None) -> torch.Tensor:
        """Per-original-channel spatial means ``[B, C]``; with ``rows`` (a
        mesh) ``x`` is this rank's rows and the means the whole image's
        (the rows' sums and counts added over the model ranks)."""
        if rows is not None:
            s, n = sum_with_count(x.sum(dim=(2, 3)), x.shape[2] * x.shape[3],
                                  rows, "model")
            return s / n
        if block is None:
            return x.mean(dim=(2, 3))
        if splits is None:
            return packed_channel_mean(x, block)
        parts = x.split([block_total(block) * c for c in splits], dim=1)
        return torch.cat([packed_channel_mean(p, block) for p in parts], 1)

    @staticmethod
    def tile(e: torch.Tensor, block: Block = None,
             splits: Optional[Sequence[int]] = None) -> torch.Tensor:
        """A per-original-channel ``[B, C]`` laid out as the (packed) input's
        channels."""
        if block is None:
            return e
        if splits is None:
            return tile_channel(e, block)
        return torch.cat([tile_channel(p, block)
                          for p in e.split(list(splits), dim=1)], 1)

    def forward(self, x, block: Block = None, splits=None):
        e = self.excite(self.squeeze(x, block, splits, rows_mesh(self)))
        return x * self.tile(e, block, splits)[:, :, None, None]


class GuidedUpsamplingBlock(nn.Module):
    """GUB (``modules.py:29-100``), guidance 'full', kernel size 3, RGB
    guide: feature branch and guide branch (conv3-BN-ReLU, conv1-BN-ReLU to
    expand//2 each) -> concat -> SE(reduction 1) -> comb conv back to
    in_features -> +depth -> 1x1 reduce. With ``block`` the guide, the depth
    and the output are packed; the concat stays a plain channel concat of
    the packed branches and the comb conv's weight is re-indexed for it."""

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
        self.splits = (ef // 2, ef // 2)

    def forward(self, guide, depth, block: Block = None):
        if self.fused:
            return self._fused(guide, depth, block)
        splits = None if block is None else self.splits
        x = _run(self.feature_conv, depth, block)
        y = _run(self.guide_conv, guide, block)
        xy = self.SE_block(torch.cat([x, y], dim=1), block, splits)
        r = _run(self.comb_conv, xy, block, splits)
        return self.reduce(r + depth, block)

    def _fused(self, guide, depth, block: Block):
        """Fused execution (``tpudepth/models/guidedepth.py:161-184,
        243-293``); the normalized inputs of the k=3 convs exist only inside
        the kernel. In train mode every BatchNorm affine comes from batch
        statistics: a k=3 conv's from the sums its kernel emits, a k=1
        conv's reduced from its output. Packed, the kernels take the packed
        weights and the affines tiled to the packed channels
        (``_packed_prelude``, ``_se_prelude``, ``_norm_mean``)."""
        train = self.training
        b2 = 1 if block is None else block_total(block)

        def tile(v: torch.Tensor) -> torch.Tensor:
            return v if block is None else tile_channel(v, block)

        def conv3(parts: Sequence[torch.Tensor], conv: Conv, bn: BatchNorm,
                  preludes=None, splits=None):
            w, b = conv.weight, conv.bias
            if block is not None:
                w, b = pack_conv_kernel(w, block, splits)[0], tile(b)
            out = conv_bn_act([nhwc(p) for p in parts], w.permute(2, 3, 1, 0),
                              b, preludes=preludes, stats=train)
            if not train:
                return _nchw(out), bn.eval_affine()
            y, s, q = out
            n = float(y.shape[0] * y.shape[1] * y.shape[2] * b2)
            return _nchw(y), bn.train_affine(sums=(s, q, n), block=block)

        def conv1(x: torch.Tensor, conv: Conv, bn: BatchNorm):
            y = conv(x, block)
            return y, (bn.train_affine(y, block=block) if train
                       else bn.eval_affine())

        def act(y: torch.Tensor, pre: Affine, skip=None) -> torch.Tensor:
            return _activate(y, (tile(pre[0]), tile(pre[1])), skip)

        fc, gc, cc = self.feature_conv, self.guide_conv, self.comb_conv
        y1, p1 = conv3([depth], fc[0], fc[1])
        y2, p2 = conv1(act(y1, p1), fc[3], fc[4])
        g1, q1 = conv3([guide], gc[0], gc[1])
        g2, q2 = conv1(act(g1, q1), gc[3], gc[4])

        # SE squeeze of the normalized branches, excitation folded into the
        # comb conv's preludes: relu(x*A + C) * e == relu(x*(A*e) + C*e)
        # because e = sigmoid(.) > 0.
        se = self.SE_block
        mx = se.squeeze(act(y2, p2), block)
        mg = se.squeeze(act(g2, q2), block)
        exc = se.excite(torch.cat([mx, mg], dim=1)).to(p2[0].dtype)
        half = exc.shape[1] // 2
        pre_x = tuple(tile(t[None] * exc[:, :half]).contiguous() for t in p2)
        pre_g = tuple(tile(t[None] * exc[:, half:]).contiguous() for t in q2)

        y5, p5 = conv3([y2, g2], cc[0], cc[1], preludes=(pre_x, pre_g),
                       splits=None if block is None else self.splits)
        y6, p6 = conv1(act(y5, p5), cc[3], cc[4])
        return self.reduce(act(y6, p6, skip=depth), block)


class GuideDepth(nn.Module):
    """``GuideDepth.py:9-57``: ``up_features=(64,32,16)`` or ``(32,8,4)`` for
    GuideDepth-S (``loader.py:19``). Input ``[B,3,H,W]``, output
    ``[B,1,H,W]``; the compute dtype is the input's.

    ``packed``: a stage runs in space-to-depth layout with the block
    :meth:`stage_blocks` chooses, by ``tpudepth/models/guidedepth.py:
    372-386``'s rules (``packed_max_channels``, ``packed_block4_max_channels``
    and the per-stage override ``packed_blocks``). The JAX package's default
    is ``packed=True``; the port's is ``False``. ``remat_stages``: in train
    mode each GUB stage is rematerialized (:func:`~tpudepth_torch.models.
    layers.rematerialize`): only its inputs are kept for the backward, which
    runs the stage again (the fused stages launch ``gub_conv_fwd`` twice)."""

    def __init__(self, up_features: Sequence[int] = (64, 32, 16),
                 inner_features: Sequence[int] = (64, 32, 16),
                 fused_stages: bool = False, packed: bool = False,
                 packed_max_channels: int = 128,
                 packed_block4_max_channels: int = 256,
                 packed_blocks: Optional[Sequence[Optional[Sequence[int]]]]
                 = None, remat_stages: bool = False):
        super().__init__()
        up, inner = list(up_features), list(inner_features)
        self.feature_extractor = DualResNetBackbone(features=up[0])
        outs = (up[1], up[2], 1)
        for i in range(3):
            setattr(self, f"up_{i + 1}", GuidedUpsamplingBlock(
                up[i], inner[i], outs[i], fused=fused_stages))
        self.inner_features = tuple(inner)
        self.packed = packed
        self.packed_max_channels = packed_max_channels
        self.packed_block4_max_channels = packed_block4_max_channels
        self.packed_blocks = (None if packed_blocks is None else tuple(
            None if b is None else tuple(b) for b in packed_blocks))
        self.remat_stages = remat_stages
        if not (fused_stages or packed):
            run_on_rows(self.up_1, self.up_2, self.up_3)

    def stage_blocks(self, h: int, w: int) -> List[Block]:
        """The block of each stage for an ``h x w`` input (None: unpacked).
        Stage i's guide is ``h/4``, ``h/2``, ``h`` high. An override packs
        only where the guide divides by it; else ``(4, 4)`` where
        ``16 * inner <= packed_block4_max_channels`` and the guide divides
        by 4; else ``(2, 2)`` where ``4 * inner <= packed_max_channels``
        and it divides by 2."""
        blocks: List[Block] = []
        guides = ((h // 4, w // 4), (h // 2, w // 2), (h, w))
        for i, (gh, gw) in enumerate(guides):
            blk = None
            if self.packed:
                inner = self.inner_features[i]
                override = (self.packed_blocks[i]
                            if self.packed_blocks is not None else None)
                if override is not None:
                    by, bx = override
                    if gh % by == 0 and gw % bx == 0:
                        blk = (by, bx)
                elif (16 * inner <= self.packed_block4_max_channels
                      and gh % 4 == 0 and gw % 4 == 0):
                    blk = (4, 4)
                elif (4 * inner <= self.packed_max_channels
                      and gh % 2 == 0 and gw % 2 == 0):
                    blk = (2, 2)
            blocks.append(blk)
        return blocks

    def forward(self, x):
        mesh = spatial_mesh()
        h, w = x.shape[2:]
        rows = None
        if mesh is not None:
            h = input_rows(x, mesh)
        y = self.feature_extractor(x)
        if mesh is not None:
            # the stages run on rows, or (fused, packed) all on the whole map
            rows = rows_mesh(self.up_1)
            if rows is None:
                x, y = despatialize(x, mesh), despatialize(y, mesh)
        x_half = resize_nearest(x, (h // 2, w // 2), rows=rows)
        x_quarter = resize_nearest(x, (h // 4, w // 4), rows=rows)
        blocks = self.stage_blocks(h, w)
        for i, guide in enumerate((x_quarter, x_half, x)):
            gub, blk = getattr(self, f"up_{i + 1}"), blocks[i]
            if blk is not None:
                y, guide = upsample2x_pack(y, blk), space_to_depth(guide, blk)
            else:
                hy = y.shape[2] if rows is None else global_rows(y, rows)
                y = resize_bilinear(y, (hy * 2, y.shape[3] * 2), rows=rows)
            if self.remat_stages and self.training:
                y = rematerialize(gub, guide, y, blk)
            else:
                y = gub(guide, y, blk)
            if blk is not None:
                y = depth_to_space(y, blk)
        return take_rows(y, mesh) if mesh is not None and rows is None else y
