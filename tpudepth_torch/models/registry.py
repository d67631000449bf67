"""Model registry of the port (``tpudepth/models/registry.py``): the
GuideDepth family, MobileV3SAMDepth and MobileV3NewCRFDepth so far."""

from __future__ import annotations

from typing import Optional

import torch.nn as nn

from tpudepth_torch.models import newcrf, sam
from tpudepth_torch.models.decoders import MobileV3NewCRFDepth, MobileV3SAMDepth
from tpudepth_torch.models.guidedepth import GuideDepth

# alias (lowercased) -> canonical name; every switch keyed on a model name
# (loss recipe, frozen encoder) goes through canonical_model_name
_ALIASES = {
    "guidedepth": "GuideDepth",
    "guidedepth-s": "GuideDepth-S",
    "guidedepth_s": "GuideDepth-S",
    "sam": "sam",
    "mobilev3_sam": "sam",
    "mobilev3_large_sam": "sam",
    "newcrf": "newcrf",
    "newcrfs": "newcrf",
    "mobilev3_newcrf": "newcrf",
    "mobilev3_large_newcrfs": "newcrf",
}

MODEL_NAMES = ["GuideDepth", "GuideDepth-S", "sam", "newcrf"]

GUB_MODES = ("plain", "fused")

_ATTN_MODELS = {"sam": MobileV3SAMDepth, "newcrf": MobileV3NewCRFDepth}

# every block mode of any attention model; each model checks its own
ATTN_MODES = tuple(dict.fromkeys(sam.ATTN_MODES + newcrf.ATTN_MODES))


def canonical_model_name(name: str, strict: bool = True) -> str:
    """The canonical name of any accepted alias (``tpudepth/models/
    registry.py::canonical_model_name``). ``strict=False`` passes an unknown
    name through, lowercased (a ``Trainer`` handed its own ``model``)."""
    canon = _ALIASES.get(str(name).lower())
    if canon is None:
        if strict:
            raise ValueError(f"unknown model {name!r}; available: {MODEL_NAMES}")
        return str(name).lower()
    return canon


def build_model(name: str, gub: str = "plain",
                attn: Optional[str] = None) -> nn.Module:
    """``gub='fused'`` runs every GUB's k=3 convs of a GuideDepth model
    through the fused GUB conv kernels (``ops/kernels/gub_conv.py``:
    ``gub_conv_fwd`` in eval and train mode, ``gub_conv_dw`` and
    ``gub_conv_dx`` in the backward); ``'plain'`` through conv, BatchNorm and
    ReLU modules. ``attn`` is the mode of the attention blocks of ``'sam'``
    (``models/sam.py``: ``'fused'``, the default, ``'pair'``, ``'row'`` or
    ``'plain'``) and ``'newcrf'`` (``models/newcrf.py``: ``'row'``, the
    default, ``'fused'``, ``'pair'`` or ``'plain'``); None takes the model's
    default, and a mode the model lacks raises ``ValueError``. Each model has
    one parameter tree whatever its modes."""
    if gub not in GUB_MODES:
        raise ValueError(f"gub must be one of {GUB_MODES}, not {gub!r}")
    canon = _ALIASES.get(str(name).lower())
    if canon is None:
        raise NotImplementedError(
            f"model {name!r} is not ported yet (ported: {MODEL_NAMES}); "
            "see ROADMAP.md Queue A")
    if canon in _ATTN_MODELS:
        # the model's own default mode (the JAX package's eval default on its
        # chip) unless one is named; the blocks check it
        model = _ATTN_MODELS[canon]
        return model() if attn is None else model(attn=attn)
    if attn is not None:
        raise ValueError(f"attn is a mode of the attention models "
                         f"{sorted(_ATTN_MODELS)}, not of {canon!r}")
    fused = gub == "fused"
    if canon == "GuideDepth":
        return GuideDepth(fused_stages=fused)
    return GuideDepth(up_features=(32, 8, 4), inner_features=(32, 8, 4),
                      fused_stages=fused)
