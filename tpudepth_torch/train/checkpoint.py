"""Checkpoint save / load with both reference schemas, as ``torch.save``
files.

Counterpart of ``tpudepth/train/checkpoint.py``. GuideDepth stack: per-epoch
``checkpoint_{e}`` holding ``epoch`` (the epoch to resume at) and
``val_losses`` (``src/GuideDepth/training.py:166-178``). Root stack: one
rolling ``global_checkpoint`` holding ``epoch`` (the completed epoch) and
``loss`` (``src/train.py:147-153``). Both carry ``model`` (the
``state_dict``: parameters and BatchNorm statistics) and ``optimizer``.
Saves are synchronous and atomic (written beside the target, then renamed).
"""

from __future__ import annotations

import os
from typing import Any, Dict

import torch


def save_checkpoint(path: str, payload: Dict[str, Any]) -> str:
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)
    return path


def load_checkpoint(path: str, map_location="cpu") -> Dict[str, Any]:
    return torch.load(os.path.abspath(path), map_location=map_location,
                      weights_only=True)


def load_model_weights(model: torch.nn.Module, path: str) -> Dict[str, Any]:
    """Load into ``model`` the weights of a checkpoint of either schema, of
    an exported ``best_model`` (all carry ``model``) or of a bare
    ``state_dict``; returns what the file holds."""
    restored = load_checkpoint(path)
    model.load_state_dict(restored.get("model", restored))
    return restored
