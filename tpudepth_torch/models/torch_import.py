"""Reference PyTorch weights into the port: the counterpart of
``tpudepth/models/torch_import.py``.

The port's modules keep the reference ``state_dict`` key layout, so a
reference file loads by its keys; what is left here is unwrapping the
checkpoint schemas, the few keys the reference has and the port does not,
and the partial loads of a pretrained backbone:

- :func:`unwrap_state_dict`: ``model`` (GuideDepth releases and per-epoch
  checkpoints, ``src/GuideDepth/training.py:166-178``), ``model_state_dict``
  (the root ``global_checkpoint``, ``src/train.py:147-153``),
  ``state_dict``, or a bare mapping;
- :func:`load_reference_state_dict`: a whole model, dropping exactly what
  ``convert_guidedepth`` / ``convert_attention_model`` skip (the
  ``relative_position_index`` buffers, rebuilt from the window; SAM's unused
  3x3 ``proj`` conv, ``src/SAM.py:271``) and filling a BatchNorm's missing
  ``num_batches_tracked`` with 0, as those converters read none;
- :func:`load_ddrnet_imagenet`: the DDRNet-23-slim ImageNet checkpoint into
  GuideDepth's ``feature_extractor``, dropping its classifier head
  (``down5``, ``last_layer``, ``linear``), which ``convert_ddrnet`` skips;
- :func:`load_mobilenetv3_features`: torchvision MobileNetV3 ``features``
  (or any ``torch_prefix``, as ``convert_mobilenetv3``'s) into the
  attention models' or the zoo's encoder;
- :func:`state_dict_to_numpy`, as in the JAX module.

Loading stays strict: a key missing, left over or of another shape raises,
naming it. The JAX converters read the keys they know and skip every other;
the port skips only the keys named above.
"""

from __future__ import annotations

import re
from collections import OrderedDict
from typing import Dict, Mapping

import numpy as np
import torch

#: checkpoint keys that wrap a ``state_dict``, in the order they are tried
SCHEMA_KEYS = ("model", "model_state_dict", "state_dict")

#: reference keys with no port counterpart (``torch_import.py:313, 341,
#: 373-375`` add them to the converter's ``used`` set unread)
REFERENCE_ONLY = (re.compile(r"\.attn\.relative_position_index$"),
                  re.compile(r"^Unet\.1\.crf\d\.proj\.(weight|bias)$"))

#: the DDRNet-23-slim ImageNet classifier's head, not in the backbone
DDRNET_IMAGENET_HEAD = ("down5.", "last_layer.", "linear.")

#: where the encoder's ``features`` sit: the attention models (reference
#: layout) and the DenseDepth / U-Net zoo
FEATURES_MODULES = ("Unet.0.original_model.features", "encoder.features")


def state_dict_to_numpy(state_dict: Mapping) -> Dict[str, np.ndarray]:
    """``{name: np.ndarray}`` copies of a ``state_dict``'s tensors."""
    return {k: np.array(v.detach().cpu().numpy() if hasattr(v, "detach")
                        else v) for k, v in state_dict.items()}


def unwrap_state_dict(checkpoint: Mapping) -> Mapping:
    """The ``state_dict`` inside a reference or port checkpoint: under
    ``model``, ``model_state_dict`` or ``state_dict``, or the mapping
    itself."""
    for key in SCHEMA_KEYS:
        if isinstance(checkpoint.get(key), Mapping):
            return checkpoint[key]
    return checkpoint


def _load_strict(module: torch.nn.Module, sd: Mapping, what: str):
    """``load_state_dict`` with tensors of any float dtype, strict; the
    error names the keys."""
    own = module.state_dict()
    missing = [k for k in own if k not in sd]
    extra = [k for k in sd if k not in own]
    shapes = [f"{k} {tuple(sd[k].shape)} (the port's {tuple(own[k].shape)})"
              for k in own if k in sd
              and tuple(torch.as_tensor(sd[k]).shape) != tuple(own[k].shape)]
    if missing or extra or shapes:
        raise ValueError(f"{what}: missing {missing[:5]}, unexpected "
                         f"{extra[:5]}, of another shape {shapes[:5]}")
    module.load_state_dict(OrderedDict(
        (k, torch.as_tensor(v)) for k, v in sd.items()))


def reference_state_dict(model: torch.nn.Module,
                         sd: Mapping) -> "OrderedDict[str, torch.Tensor]":
    """A reference ``state_dict`` of ``model``'s architecture in the port's
    keys: :data:`REFERENCE_ONLY` keys dropped, a missing BatchNorm
    ``num_batches_tracked`` filled with 0."""
    own = model.state_dict()
    out = OrderedDict((k, torch.as_tensor(v)) for k, v in sd.items()
                      if k in own or not any(p.search(k)
                                             for p in REFERENCE_ONLY))
    for k in own:
        if k.endswith(".num_batches_tracked") and k not in out:
            out[k] = torch.tensor(0, dtype=torch.long)
    return out


def load_reference_state_dict(model: torch.nn.Module,
                              checkpoint: Mapping) -> torch.nn.Module:
    """A whole reference (or port) checkpoint of ``model``'s architecture
    into ``model``, strictly."""
    _load_strict(model, reference_state_dict(
        model, unwrap_state_dict(checkpoint)), type(model).__name__)
    return model


def load_ddrnet_imagenet(model: torch.nn.Module,
                         checkpoint: Mapping) -> torch.nn.Module:
    """The DDRNet-23-slim ImageNet checkpoint into ``model.feature_extractor``
    (GuideDepth, GuideDepth-S), its classifier head dropped; every backbone
    key must be there, of its shape, and no other."""
    sd = unwrap_state_dict(checkpoint)
    backbone = model.feature_extractor
    own = backbone.state_dict()
    kept = {k: v for k, v in sd.items()
            if k in own or not k.startswith(DDRNET_IMAGENET_HEAD)}
    _load_strict(backbone, reference_state_dict(backbone, kept),
                 "DDRNet-23-slim ImageNet backbone")
    return model


def load_mobilenetv3_features(model: torch.nn.Module, checkpoint: Mapping,
                              torch_prefix: str = "features"
                              ) -> torch.nn.Module:
    """The MobileNetV3 features under ``torch_prefix`` of a checkpoint
    (torchvision's ``features``, or ``Unet.0.original_model.features`` of a
    reference model) into ``model``'s encoder; keys outside the prefix are
    not read, every key under it must fit."""
    sd = unwrap_state_dict(checkpoint)
    target = None
    for path in FEATURES_MODULES:
        try:
            target = model.get_submodule(path)
            break
        except AttributeError:
            continue
    if target is None:
        raise ValueError(f"{type(model).__name__} has no MobileNetV3 encoder "
                         f"({' or '.join(FEATURES_MODULES)})")
    head = f"{torch_prefix}." if torch_prefix else ""
    features = {k[len(head):]: v for k, v in sd.items() if k.startswith(head)}
    if not features:
        raise ValueError(f"no key under {torch_prefix!r}")
    _load_strict(target, reference_state_dict(target, features),
                 f"MobileNetV3 features under {torch_prefix!r}")
    return model
