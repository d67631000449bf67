"""Checkpoint save / load with both reference schemas, as ``torch.save``
files; loads also read the JAX package's orbax checkpoints and the
reference's ``.pth`` files.

Counterpart of ``tpudepth/train/checkpoint.py``. GuideDepth stack: per-epoch
``checkpoint_{e}`` holding ``epoch`` (the epoch to resume at) and
``val_losses`` (``src/GuideDepth/training.py:166-178``). Root stack: one
rolling ``global_checkpoint`` holding ``epoch`` (the completed epoch) and
``loss`` (``src/train.py:147-153``). Both carry ``model`` (the
``state_dict``: parameters and BatchNorm statistics) and ``optimizer``.

Saves are asynchronous by default, as the JAX package's orbax saves
(``tpudepth/train/checkpoint.py:29-59``): :func:`save_checkpoint` copies the
payload on the caller's thread (tensors to the CPU, CPU tensors cloned, so
the file holds the state at the call however the step moves it after) and
hands the write to one background thread, which writes beside the target
and renames (atomic; saves land in the order they were made).
:func:`wait_for_checkpoints` blocks until every save has landed and raises
a failed save's exception; :func:`load_checkpoint`, ``Trainer.fit`` and the
process's exit wait for them. ``blocking=True`` returns once the file is
on disk.

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

import atexit
import concurrent.futures
import itertools
import os
import threading
from typing import Any, Dict, List, Optional

import torch

_LOCK = threading.Lock()
_WRITER: List[concurrent.futures.ThreadPoolExecutor] = []
_PENDING: List[concurrent.futures.Future] = []
_SERIAL = itertools.count()


def _snapshot(obj):
    """``obj`` with every tensor copied to the CPU (a CPU tensor cloned) and
    every dict, list and tuple rebuilt, so nothing the caller changes after
    the call reaches the file."""
    if isinstance(obj, torch.Tensor):
        t = obj.detach()
        return t.clone() if t.device.type == "cpu" else t.cpu()
    if isinstance(obj, dict):
        return type(obj)((k, _snapshot(v)) for k, v in obj.items())
    if isinstance(obj, (list, tuple)):
        return type(obj)(_snapshot(v) for v in obj)
    return obj


def _write(path: str, payload: Dict[str, Any]):
    tmp = f"{path}.{os.getpid()}.{next(_SERIAL)}.tmp"
    try:
        torch.save(payload, tmp)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def wait_for_checkpoints():
    """Block until every save has landed; raise the first failed save's
    exception (every failed save is reported once)."""
    with _LOCK:
        pending, _PENDING[:] = list(_PENDING), []
    errors = [f.exception() for f in pending]
    errors = [e for e in errors if e is not None]
    if errors:
        raise errors[0]


def save_checkpoint(path: str, payload: Dict[str, Any],
                    blocking: bool = False) -> str:
    """Save ``payload`` to ``path`` (returned absolute): snapshotted now,
    written by the background thread, or before returning with
    ``blocking``."""
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    payload = _snapshot(payload)
    with _LOCK:
        if not _WRITER:
            _WRITER.append(concurrent.futures.ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="checkpoint"))
            atexit.register(wait_for_checkpoints)
        _PENDING.append(_WRITER[0].submit(_write, path, payload))
    if blocking:
        wait_for_checkpoints()
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
    wait_for_checkpoints()  # a save of this path in flight lands first
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
