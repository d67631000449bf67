"""MobileNetV3 encoder-decoder depth models (NCHW).

Counterpart of ``tpudepth/models/decoders.py``, all five of its models:

- ``MobileV3SAMDepth`` (``src/model_mobileV3_large_SAM.py``) and
  ``MobileV3NewCRFDepth`` (``src/model_mobileV3_large_newCRFs.py``), whose
  module names follow the reference ``state_dict``:
  ``Unet.0.original_model.features.*`` (the encoder), ``Unet.1.conv0``,
  ``Unet.1.crf{i}.*`` and ``Unet.1.conv1`` (the decoder);
- ``MobileV3DenseDepth``, ``MobileV3UNet`` and ``MobileV3UNetInterp``
  (large and small), whose reference ``state_dict`` layouts are not in the
  repo: their module names follow the flax names (``encoder``, ``conv2``,
  ``up0``..., ``bridge``, ``bridge_conv``, ``upa``, ``convBlock``,
  ``conv1`` / ``conv2``, ``conv3``). They answer ``[B,1,H/2,W/2]`` in the
  input's dtype, with no sigmoid in the head.

Under a model axis (``core/mesh.py``) a model takes and gives this rank's
image rows. The encoder runs on rows down to 1/16 (``models/
mobilenetv3.py``). The attention decoder runs on the whole map: its taps on
rows are despatialized (windows of 7, padding to multiples of 7 and
NewCRF's shift of 3 cross the ranks' edges) and its output goes back to
rows. The DenseDepth and interpolated U-Net decoders run on rows from the
first stage whose tap is on rows: that stage resizes the whole map to the
tap's global size and takes its rows; later stages resize on rows; the
head conv runs on rows. The transposed-conv U-Net keeps its MaxPool, its
bridge and its first up on the whole map; the first up whose tap is on
rows transposes the whole map and takes its rows, and later ups transpose
on rows (``layers.conv_transpose_rows``). The row shards of a map need not
be equal (``core/mesh.py::row_bounds``).
"""

from __future__ import annotations

from typing import List, Sequence

import torch
import torch.nn as nn

from tpudepth_torch.core.mesh import (
    despatialize,
    global_rows,
    input_rows,
    rows_mesh,
    run_on_rows,
    spatial_mesh,
    take_rows,
)
from tpudepth_torch.models.layers import Conv, ConvTranspose, leaky_relu_02
from tpudepth_torch.models.mobilenetv3 import (
    LARGE_LAST,
    LARGE_SPEC,
    SMALL_LAST,
    SMALL_SPEC,
    MobileNetV3Features,
)
from tpudepth_torch.models.newcrf import NewCRF
from tpudepth_torch.models.sam import SAM
from tpudepth_torch.ops.image import (
    max_pool,
    pixel_shuffle,
    resize_bilinear,
    upsample,
)

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
        feats = encoder(x)
        mesh = spatial_mesh()
        if mesh is None:
            return decoder(feats)
        last_rows = encoder.original_model.first_whole
        feats = [despatialize(f, mesh) if k in (4, 7, 13) and k <= last_rows
                 else f for k, f in enumerate(feats)]
        return take_rows(decoder(feats), mesh)


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


# ---------------------------------------------------------------------------
# DenseDepth and U-Net decoders
# ---------------------------------------------------------------------------


def _tap_channels(arch: str) -> List[int]:
    """Channels of each of MobileNetV3Features' taps (the input's 3 first)."""
    spec, last = ((LARGE_SPEC, LARGE_LAST) if arch == "large"
                  else (SMALL_SPEC, SMALL_LAST))
    return [3, 16] + [row[2] for row in spec] + [last]


class ConvBlock(nn.Module):
    """3x3 conv + LeakyReLU(0.2), twice (``src/models/model_mobileV3.py
    :6-21``)."""

    def __init__(self, cin: int, features: int):
        super().__init__()
        self.conv1 = Conv(cin, features, 3, padding=1)
        self.conv2 = Conv(features, features, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return leaky_relu_02(self.conv2(leaky_relu_02(self.conv1(x))))


class UpSampleConcat(nn.Module):
    """Bilinear (align_corners=True) to the skip's size, concat, ConvBlock
    (DenseDepth's ``UpSample``, the interpolated U-Net's ``Up``). On rows
    the skip is rows; ``x`` is rows too, or the whole map where
    ``joins_whole`` is set (resized whole, then its rows taken)."""

    def __init__(self, cin: int, skip: int, features: int):
        super().__init__()
        self.convBlock = ConvBlock(cin + skip, features)
        self.joins_whole = False

    def forward(self, x: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        mesh = rows_mesh(self)
        if mesh is None:
            x = resize_bilinear(x, skip.shape[2:], align_corners=True)
        else:
            size = (global_rows(skip, mesh), skip.shape[3])
            if self.joins_whole:
                x = take_rows(resize_bilinear(x, size, align_corners=True),
                              mesh)
            else:
                x = resize_bilinear(x, size, align_corners=True, rows=mesh)
        return self.convBlock(torch.cat([x, skip], dim=1))


class UpTransposed(nn.Module):
    """ConvTranspose(k2, s2) up + concat + ConvBlock
    (``src/models/model_mobileV3_Unet.py:52-67``). On rows the skip is
    rows; ``x`` is rows too, or the whole map where ``joins_whole`` is set
    (transposed whole, then its rows taken)."""

    def __init__(self, cin: int, skip: int, features: int):
        super().__init__()
        self.up = ConvTranspose(cin, features)
        self.convBlock = ConvBlock(features + skip, features)
        self.joins_whole = False

    def forward(self, x: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        x = self.up(x)
        if self.joins_whole:
            x = take_rows(x, rows_mesh(self))
        return self.convBlock(torch.cat([x, skip], dim=1))


def _decode_on_rows(ups: Sequence[nn.Module], taps: Sequence[int],
                    last_rows: int):
    """Mark the stages of a decoder whose tap is on rows (``tap <=
    last_rows``, the encoder's ``first_whole``) to run on rows, the first
    of them to join the whole map (a transposed up's ``up`` then runs on
    the whole map)."""
    whole = True
    for up, tap in zip(ups, taps):
        if tap <= last_rows:
            run_on_rows(up)
            if whole and isinstance(up, UpTransposed):
                up.up.on_rows = False
            up.joins_whole, whole = whole, False


class MobileV3DenseDepth(nn.Module):
    """DenseDepth-style decoder (``src/models/model_mobileV3.py:24-70``): a
    1x1 bridge 960 -> 960 without the reference's ``padding=1`` (as the JAX
    package, ``tpudepth/models/decoders.py:153-157``), six UpSample stages
    over taps feats[16, 13, 10, 7, 4, 2], 3x3 head; output at half the
    input's size. Under a model axis the bridge and the first stage run on
    the whole 1/32 map, the stages from tap 13 and the head on rows."""

    TAPS = (16, 13, 10, 7, 4, 2)

    def __init__(self):
        super().__init__()
        f = LARGE_LAST
        ch = _tap_channels("large")
        self.encoder = MobileNetV3Features("large")
        self.conv2 = Conv(f, f, 1)
        widths = (f // 2, f // 2, f // 4, f // 8, f // 8, f // 16)
        cin = f
        for i, (tap, width) in enumerate(zip(self.TAPS, widths)):
            setattr(self, f"up{i}", UpSampleConcat(cin, ch[tap], width))
            cin = width
        self.conv3 = Conv(cin, 1, 3, padding=1)
        _decode_on_rows([getattr(self, f"up{i}") for i in range(6)],
                        self.TAPS, self.encoder.first_whole)
        run_on_rows(self.conv3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        feats = self.encoder(x)
        h = self.conv2(feats[17])
        for i, tap in enumerate(self.TAPS):
            h = getattr(self, f"up{i}")(h, feats[tap])
        return self.conv3(h)


class MobileV3UNet(nn.Module):
    """Transposed-conv U-Net (``src/models/model_mobileV3_Unet.py``):
    MaxPool(2) and a 1x1 bridge 960 -> 1280 at H/64, then five transposed-
    conv ups over taps feats[17, 13, 7, 4, 2], 3x3 head at half the input's
    size. Each up doubles its map exactly, so H and W must be multiples of
    64 (a JAX model fails elsewhere at its concat). Under a model axis the
    MaxPool, the bridge and ``upa`` run on the whole map, the ups from tap
    13 and the head on rows."""

    UPS = (("upa", 17, 960), ("up0", 13, 112), ("up1", 7, 40),
           ("up2", 4, 24), ("up3", 2, 16))

    def __init__(self):
        super().__init__()
        ch = _tap_channels("large")
        self.encoder = MobileNetV3Features("large")
        self.bridge_conv = Conv(LARGE_LAST, 1280, 1)
        cin = 1280
        for name, tap, width in self.UPS:
            setattr(self, name, UpTransposed(cin, ch[tap], width))
            cin = width
        self.conv3 = Conv(cin, 1, 3, padding=1)
        _decode_on_rows([getattr(self, name) for name, _, _ in self.UPS],
                        [tap for _, tap, _ in self.UPS],
                        self.encoder.first_whole)
        run_on_rows(self.conv3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mesh = spatial_mesh()
        h = x.shape[2] if mesh is None else input_rows(x, mesh)
        w = x.shape[3]
        if h % 64 or w % 64:
            raise ValueError(f"the U-Net takes H and W that are multiples of "
                             f"64, not {h}x{w}")
        feats = self.encoder(x)
        y = self.bridge_conv(max_pool(feats[17], 2, 2))
        for name, tap, _ in self.UPS:
            y = getattr(self, name)(y, feats[tap])
        return self.conv3(y)


class MobileV3UNetInterp(nn.Module):
    """Interpolated U-Net (``src/models/model_mobileV3_Unet_interpolado.py``
    large, ``..._small.py`` small): a 1x1 bridge on the first tap, then an
    UpSample stage a tap, head 8 -> 1 at half the input's size. Large:
    bridge 960, taps feats[17, 16, 13, 11, 7, 4, 2]. Small (MobileNetV3-
    Small): bridge 576, the six taps feats[13, 10, 8, 5, 3, 1] that the JAX
    code uses (``tpudepth/models/decoders.py:236-240``)."""

    ARCHS = {"large": (LARGE_LAST, (17, 16, 13, 11, 7, 4, 2),
                       (160, 112, 80, 40, 24, 16, 8)),
             "small": (SMALL_LAST, (13, 10, 8, 5, 3, 1),
                       (96, 48, 40, 24, 16, 8))}

    def __init__(self, arch: str = "large"):
        super().__init__()
        if arch not in self.ARCHS:
            raise ValueError(f"arch must be 'large' or 'small', not {arch!r}")
        bridge, self.taps, widths = self.ARCHS[arch]
        ch = _tap_channels(arch)
        self.encoder = MobileNetV3Features(arch)
        self.bridge = Conv(ch[self.taps[0]], bridge, 1)
        cin = bridge
        for i, (tap, width) in enumerate(zip(self.taps, widths)):
            setattr(self, f"up{i}", UpSampleConcat(cin, ch[tap], width))
            cin = width
        self.conv3 = Conv(cin, 1, 3, padding=1)
        _decode_on_rows([getattr(self, f"up{i}")
                         for i in range(len(self.taps))],
                        self.taps, self.encoder.first_whole)
        run_on_rows(self.conv3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        feats = self.encoder(x)
        h = self.bridge(feats[self.taps[0]])
        for i, tap in enumerate(self.taps):
            h = getattr(self, f"up{i}")(h, feats[tap])
        return self.conv3(h)
