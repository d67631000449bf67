"""Model registry of the port (``tpudepth/models/registry.py``): all eight
of the JAX package's models under its 22 aliases: the GuideDepth family,
MobileV3SAMDepth, MobileV3NewCRFDepth, MobileV3DenseDepth, MobileV3UNet and
MobileV3UNetInterp (large and small)."""

from __future__ import annotations

from typing import Optional

import torch.nn as nn

from tpudepth_torch.models import newcrf, sam
from tpudepth_torch.models.decoders import (
    MobileV3DenseDepth,
    MobileV3NewCRFDepth,
    MobileV3SAMDepth,
    MobileV3UNet,
    MobileV3UNetInterp,
)
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
    "densedepth": "densedepth",
    "mobilev3": "densedepth",
    "mobilev2": "densedepth",
    "mobilev3_densedepth": "densedepth",
    "unet": "unet",
    "mobilev3_unet": "unet",
    "unet_interp": "unet_interp",
    "mobilev3_unet_interpolado": "unet_interp",
    "unet_interpolado": "unet_interp",
    "unet_interp_small": "unet_interp_small",
    "mobilev3_unet_interpolado_small": "unet_interp_small",
    "unet_interpolado_small": "unet_interp_small",
}

MODEL_NAMES = ["GuideDepth", "GuideDepth-S", "sam", "newcrf", "densedepth",
               "unet", "unet_interp", "unet_interp_small"]

GUB_MODES = ("plain", "fused")

_ATTN_MODELS = {"sam": MobileV3SAMDepth, "newcrf": MobileV3NewCRFDepth}

# the DenseDepth and U-Net models: no attention blocks, no GUB
_ZOO = {"densedepth": MobileV3DenseDepth, "unet": MobileV3UNet,
        "unet_interp": lambda: MobileV3UNetInterp("large"),
        "unet_interp_small": lambda: MobileV3UNetInterp("small")}

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


#: the GuideDepth family's options of :func:`build_model`
#: (``tpudepth/models/registry.py:66-75`` forwards them as ``**kwargs``)
GUIDEDEPTH_OPTIONS = ("packed", "packed_blocks", "packed_max_channels",
                      "packed_block4_max_channels", "remat_stages")


def build_model(name: str, gub: str = "plain",
                attn: Optional[str] = None, **options) -> nn.Module:
    """``gub='fused'`` runs every GUB's k=3 convs of a GuideDepth model
    through the fused GUB conv kernels (``ops/kernels/gub_conv.py``:
    ``gub_conv_fwd`` in eval and train mode, ``gub_conv_dw`` and
    ``gub_conv_dx`` in the backward); ``'plain'`` through conv, BatchNorm and
    ReLU modules. ``attn`` is the mode of the attention blocks of ``'sam'``
    (``models/sam.py``: ``'fused'``, the default, ``'pair'``, ``'row'``,
    ``'block'`` or ``'plain'``) and ``'newcrf'`` (``models/newcrf.py``:
    ``'row'``, the default, ``'fused'``, ``'pair'``, ``'block'`` or
    ``'plain'``); None takes the model's
    default, and a mode the model lacks raises ``ValueError``. Each model has
    one parameter tree whatever its modes.

    ``options`` (:data:`GUIDEDEPTH_OPTIONS`) go to the GuideDepth family's
    :class:`~tpudepth_torch.models.guidedepth.GuideDepth`: ``packed``
    (space-to-depth stages; False here, where the JAX package's default is
    True), ``packed_blocks``, ``packed_max_channels``,
    ``packed_block4_max_channels`` and ``remat_stages``. ``gub`` other than
    ``'plain'`` or any option outside the GuideDepth family, ``attn``
    outside the attention models and an unknown name raise ``ValueError``;
    an unknown option raises ``TypeError``."""
    if gub not in GUB_MODES:
        raise ValueError(f"gub must be one of {GUB_MODES}, not {gub!r}")
    unknown = sorted(set(options) - set(GUIDEDEPTH_OPTIONS))
    if unknown:
        raise TypeError(f"unknown build_model options {unknown}")
    canon = canonical_model_name(name)
    guidedepth = canon in ("GuideDepth", "GuideDepth-S")
    if gub != "plain" and not guidedepth:
        raise ValueError(f"gub={gub!r} is a mode of the GuideDepth family, "
                         f"not of {canon!r}")
    if options and not guidedepth:
        raise ValueError(f"{sorted(options)} are options of the GuideDepth "
                         f"family, not of {canon!r}")
    if canon in _ATTN_MODELS:
        # the model's own default mode (the JAX package's eval default on its
        # chip) unless one is named; the blocks check it
        model = _ATTN_MODELS[canon]
        return model() if attn is None else model(attn=attn)
    if attn is not None:
        raise ValueError(f"attn is a mode of the attention models "
                         f"{sorted(_ATTN_MODELS)}, not of {canon!r}")
    if canon in _ZOO:
        return _ZOO[canon]()
    fused = gub == "fused"
    if canon == "GuideDepth":
        return GuideDepth(fused_stages=fused, **options)
    return GuideDepth(up_features=(32, 8, 4), inner_features=(32, 8, 4),
                      fused_stages=fused, **options)
