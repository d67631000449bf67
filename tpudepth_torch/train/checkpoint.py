"""Checkpoint save / load with both reference schemas, as ``torch.save``
files; loads also read the JAX package's orbax checkpoints and the
reference's ``.pth`` files.

Counterpart of ``tpudepth/train/checkpoint.py``. GuideDepth stack: per-epoch
``checkpoint_{e}`` holding ``epoch`` (the epoch to resume at) and
``val_losses`` (``src/GuideDepth/training.py:166-178``). Root stack: one
rolling ``global_checkpoint`` holding ``epoch`` (the completed epoch) and
``loss`` (``src/train.py:147-153``). Both carry ``model`` (the
``state_dict``: parameters and BatchNorm statistics) and ``optimizer``.
Saves are synchronous and atomic (written beside the target, then renamed).

What :func:`load_checkpoint` reads:

- a port file, as saved here;
- an orbax checkpoint directory of the JAX package's trainer
  (``train/orbax_io.py``, which needs ``tensorstore``), converted to the
  schema above by ``train/jax_state.py::trainer_checkpoint_from_jax``
  for the model ``model_name`` names;
- a reference ``.pth``: the root schema's ``model_state_dict`` /
  ``optimizer_state_dict`` become ``model`` / ``optimizer``, and a bare
  ``state_dict`` becomes ``{'model': ...}``.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

import torch


def save_checkpoint(path: str, payload: Dict[str, Any]) -> str:
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)
    return path


def load_checkpoint(path: str, map_location="cpu",
                    model_name: Optional[str] = None, *,
                    model: Optional[torch.nn.Module] = None,
                    freeze_encoder: Optional[bool] = None
                    ) -> Dict[str, Any]:
    """The checkpoint at ``path`` in the port's schema. An orbax directory
    needs ``model_name`` (any name or alias of ``build_model``); ``model``,
    a module of that architecture, and ``freeze_encoder`` fix the
    optimizer's parameters (by default ``build_model(model_name)`` and the
    trainer's rule, ``trainer.freezes_encoder``)."""
    from tpudepth_torch.models.torch_import import SCHEMA_KEYS
    from tpudepth_torch.train.orbax_io import is_orbax_checkpoint, read_orbax

    path = os.path.abspath(path)
    if is_orbax_checkpoint(path):
        if model_name is None:
            raise ValueError(f"{path} is a JAX (orbax) checkpoint: pass "
                             "model_name to convert it")
        from tpudepth_torch.models.registry import build_model
        from tpudepth_torch.train.jax_state import trainer_checkpoint_from_jax
        from tpudepth_torch.train.trainer import freezes_encoder

        tree = read_orbax(path)
        if model is None:
            model = build_model(model_name)
        if freeze_encoder is None:
            freeze_encoder = freezes_encoder(model_name)
        return trainer_checkpoint_from_jax(model_name, tree, model,
                                           freeze_encoder)
    restored = torch.load(path, map_location=map_location, weights_only=True)
    if not any(isinstance(restored.get(k), dict) for k in SCHEMA_KEYS):
        return {"model": restored}
    if "model" not in restored:
        # the root reference schema (src/train.py:147-153)
        restored = dict(restored)
        key = next(k for k in SCHEMA_KEYS if isinstance(restored.get(k), dict))
        restored["model"] = restored.pop(key)
        if "optimizer_state_dict" in restored:
            restored["optimizer"] = restored.pop("optimizer_state_dict")
    return restored


def load_model_weights(model: torch.nn.Module, path: str,
                       model_name: Optional[str] = None) -> Dict[str, Any]:
    """Load into ``model`` the weights of a checkpoint of either schema, of
    an exported ``best_model``, of a bare ``state_dict``, of a JAX orbax
    checkpoint (``model_name`` required) or of a reference ``.pth``
    (``models/torch_import.py::load_reference_state_dict``), strictly;
    returns what the file holds, in the port's schema."""
    from tpudepth_torch.models.torch_import import load_reference_state_dict

    restored = load_checkpoint(path, model_name=model_name, model=model)
    load_reference_state_dict(model, restored)
    return restored
