"""Model registry of the port (``tpudepth/models/registry.py``): the
GuideDepth family and MobileV3SAMDepth so far."""

from __future__ import annotations

import torch.nn as nn

from tpudepth_torch.models.decoders import MobileV3SAMDepth
from tpudepth_torch.models.guidedepth import GuideDepth
from tpudepth_torch.models.sam import ATTN_MODES

_ALIASES = {
    "guidedepth": "GuideDepth",
    "guidedepth-s": "GuideDepth-S",
    "guidedepth_s": "GuideDepth-S",
    "sam": "sam",
    "mobilev3_sam": "sam",
    "mobilev3_large_sam": "sam",
}

MODEL_NAMES = ["GuideDepth", "GuideDepth-S", "sam"]

GUB_MODES = ("plain", "fused")


def build_model(name: str, gub: str = "plain", attn: str = "fused") -> nn.Module:
    """``gub='fused'`` runs every GUB's k=3 convs of a GuideDepth model
    through the fused GUB conv kernels (``ops/kernels/gub_conv.py``:
    ``gub_conv_fwd`` in eval and train mode, ``gub_conv_dw`` and
    ``gub_conv_dx`` in the backward); ``'plain'`` through conv, BatchNorm and
    ReLU modules. ``attn`` is the mode of the SAM blocks of ``'sam'``
    (``models/sam.py``): ``'fused'`` (attention and block-epilogue kernels),
    ``'pair'`` (attention and FFN kernels) or ``'plain'``. Each model has one
    parameter tree whatever its modes."""
    if gub not in GUB_MODES:
        raise ValueError(f"gub must be one of {GUB_MODES}, not {gub!r}")
    if attn not in ATTN_MODES:
        raise ValueError(f"attn must be one of {ATTN_MODES}, not {attn!r}")
    canon = _ALIASES.get(str(name).lower())
    if canon is None:
        raise NotImplementedError(
            f"model {name!r} is not ported yet (ported: {MODEL_NAMES}); "
            "see ROADMAP.md Queue A")
    if canon == "sam":
        return MobileV3SAMDepth(attn=attn)
    fused = gub == "fused"
    if canon == "GuideDepth":
        return GuideDepth(fused_stages=fused)
    return GuideDepth(up_features=(32, 8, 4), inner_features=(32, 8, 4),
                      fused_stages=fused)
