"""Model registry of the port (``tpudepth/models/registry.py``): the
GuideDepth family so far."""

from __future__ import annotations

from tpudepth_torch.models.guidedepth import GuideDepth

_ALIASES = {
    "guidedepth": "GuideDepth",
    "guidedepth-s": "GuideDepth-S",
    "guidedepth_s": "GuideDepth-S",
}

MODEL_NAMES = ["GuideDepth", "GuideDepth-S"]

GUB_MODES = ("plain", "fused")


def build_model(name: str, gub: str = "plain") -> GuideDepth:
    """``gub='fused'`` runs every GUB's k=3 convs through the fused GUB conv
    kernels (``ops/kernels/gub_conv.py``: ``gub_conv_fwd`` in eval and train
    mode, ``gub_conv_dw`` and ``gub_conv_dx`` in the backward); ``'plain'``
    through conv, BatchNorm and ReLU modules. Both have one parameter tree."""
    if gub not in GUB_MODES:
        raise ValueError(f"gub must be one of {GUB_MODES}, not {gub!r}")
    canon = _ALIASES.get(str(name).lower())
    if canon is None:
        raise NotImplementedError(
            f"model {name!r} is not ported yet (ported: {MODEL_NAMES}); "
            "see ROADMAP.md Queue A")
    fused = gub == "fused"
    if canon == "GuideDepth":
        return GuideDepth(fused_stages=fused)
    return GuideDepth(up_features=(32, 8, 4), inner_features=(32, 8, 4),
                      fused_stages=fused)
