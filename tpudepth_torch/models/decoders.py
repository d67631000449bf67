"""MobileNetV3 encoder-decoder depth models with attention decoders (NCHW).

Counterpart of ``tpudepth/models/decoders.py``; so far ``MobileV3SAMDepth``
(``src/model_mobileV3_large_SAM.py``) and ``MobileV3NewCRFDepth``
(``src/model_mobileV3_large_newCRFs.py``). Module names follow the reference
``state_dict``: ``Unet.0.original_model.features.*`` (the encoder),
``Unet.1.conv0``, ``Unet.1.crf{i}.*`` and ``Unet.1.conv1`` (the decoder).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn

from tpudepth_torch.models.layers import Conv
from tpudepth_torch.models.mobilenetv3 import MobileNetV3Features
from tpudepth_torch.models.newcrf import NewCRF
from tpudepth_torch.models.sam import SAM
from tpudepth_torch.ops.image import pixel_shuffle, upsample

ATTN_HEADS = (4, 8, 16, 32)
ATTN_EMBED = (128, 256, 512, 1024)  # crf_dims (src/model_mobileV3_large_SAM.py:69)
ATTN_VDIM = (64, 128, 256, 512)     # v_dims (:70)
ATTN_INCH = (24, 40, 112, 160, 960)  # encoder taps (:71)


class Encoder(nn.Module):
    """The reference's ``Encoder``: ``original_model`` is MobileNetV3-Large's
    feature stack; returns its 18 taps."""

    def __init__(self):
        super().__init__()
        self.original_model = MobileNetV3Features("large")

    def forward(self, x):
        return self.original_model(x)


class AttentionDecoder(nn.Module):
    """The SAM or NewCRF decoder (``src/model_mobileV3_large_SAM.py:60-124``
    and the NewCRF model of the same topology): 1x1 bridge 960 -> 512 on
    feats[17]; stages crf3..crf0 on feats[16], [13], [7], [4] with
    PixelShuffle(2) between; 3x3 conv -> sigmoid in f32; x4 bilinear
    upsample (align_corners=False). ``variant`` is ``'sam'`` or
    ``'newcrf'``, ``attn`` the mode of its blocks."""

    def __init__(self, variant: str = "sam", attn: str = "fused"):
        super().__init__()
        stage = {"sam": SAM, "newcrf": NewCRF}[variant]
        self.conv0 = Conv(ATTN_INCH[4], ATTN_VDIM[3], 1)
        for i in range(4):
            setattr(self, f"crf{i}", stage(
                input_dim=ATTN_INCH[i], embed_dim=ATTN_EMBED[i],
                v_dim=ATTN_VDIM[i], num_heads=ATTN_HEADS[i], mode=attn))
        self.conv1 = Conv(ATTN_EMBED[0], 1, 3, padding=1)

    def forward(self, feats: Sequence[torch.Tensor]) -> torch.Tensor:
        e3 = self.crf3(feats[16], self.conv0(feats[17]))
        e2 = self.crf2(feats[13], pixel_shuffle(e3, 2))
        e1 = self.crf1(feats[7], pixel_shuffle(e2, 2))
        e0 = self.crf0(feats[4], pixel_shuffle(e1, 2))
        depth = torch.sigmoid(self.conv1(e0).float())
        return upsample(depth, 4, align_corners=False)


class _AttentionDepth(nn.Module):
    """Encoder + attention decoder: input ``[B,3,H,W]`` (H, W multiples of
    32), output ``[B,1,H,W]`` float32; the compute dtype is the input's."""

    def __init__(self, variant: str, attn: str):
        super().__init__()
        self.Unet = nn.Sequential(Encoder(), AttentionDecoder(variant, attn))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        encoder, decoder = self.Unet
        return decoder(encoder(x))


class MobileV3SAMDepth(_AttentionDepth):
    """``PTModel`` of ``src/model_mobileV3_large_SAM.py``. ``attn`` is the
    SAM blocks' mode (``models/sam.py``)."""

    def __init__(self, attn: str = "fused"):
        super().__init__("sam", attn)


class MobileV3NewCRFDepth(_AttentionDepth):
    """``PTModel`` of ``src/model_mobileV3_large_newCRFs.py``: the same
    topology with NewCRF stages (two blocks each, the second shifted).
    ``attn`` is the NewCRF blocks' mode (``models/newcrf.py``)."""

    def __init__(self, attn: str = "row"):
        super().__init__("newcrf", attn)
