"""Keras ``.h5`` weights into the port: the counterpart of
``tpudepth/models/keras_import.py`` (``src/load_weight_from_keras.py``).

- :func:`load_keras_h5`: every weight of an ``.h5`` as ``{layer: {weight:
  array}}`` (``h5py``, imported when a file is read);
- :func:`keras_conv_kernel` / :func:`keras_dense_kernel`: Keras HWIO conv
  kernels -> the port's OIHW (``(3, 2, 0, 1)``, the reference's transpose),
  Dense ``(in, out)`` -> ``Linear`` ``(out, in)``;
- :func:`keras_bn`, :func:`my_depth_norm`, :func:`clip_predictions`;
- :func:`import_keras_sequential`: the reference's positional walk.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict

import numpy as np
import torch


def load_keras_h5(path: str) -> Dict[str, Dict[str, np.ndarray]]:
    """Flatten a Keras-format ``.h5`` (a file with a ``model_weights``
    group, or a bare weights hierarchy) into ``{layer: {weight: array}}``.
    Raises ``ImportError`` without ``h5py``."""
    try:
        import h5py
    except ImportError as err:
        raise ImportError("reading a Keras .h5 file needs the h5py package, "
                          "which is not installed here") from err

    out: Dict[str, Dict[str, np.ndarray]] = {}
    with h5py.File(path, "r") as f:
        root = f["model_weights"] if "model_weights" in f else f

        def visit(name, obj):
            if isinstance(obj, h5py.Dataset):
                parts = name.split("/")
                layer = "/".join(parts[:-1]) or parts[0]
                out.setdefault(layer, {})[parts[-1]] = np.asarray(obj)

        root.visititems(visit)
    return out


def keras_conv_kernel(k: np.ndarray) -> np.ndarray:
    """Keras conv kernel HWIO -> torch OIHW (depthwise ``(kh, kw, 1, C)``
    -> ``(C, 1, kh, kw)`` by the same transpose)."""
    return np.ascontiguousarray(np.transpose(np.asarray(k), (3, 2, 0, 1)))


def keras_dense_kernel(k: np.ndarray) -> np.ndarray:
    """Keras Dense kernel ``(in, out)`` -> torch ``Linear`` ``(out, in)``."""
    return np.ascontiguousarray(np.asarray(k).T)


def keras_bn(layer: Dict[str, np.ndarray]):
    """(scale, bias, mean, var) from a Keras BatchNormalization layer dict."""
    return (
        layer.get("gamma:0", layer.get("gamma")),
        layer.get("beta:0", layer.get("beta")),
        layer.get("moving_mean:0", layer.get("moving_mean")),
        layer.get("moving_variance:0", layer.get("moving_variance")),
    )


def my_depth_norm(x, max_depth: float = 1000.0):
    """``my_DepthNorm`` (``src/load_weight_from_keras.py:90-91``)."""
    return max_depth / x


def clip_predictions(pred, min_depth: float = 10.0, max_depth: float = 1000.0):
    """Reference prediction post-processing
    (``src/load_weight_from_keras.py:92-100``)."""
    return np.clip(my_depth_norm(pred, max_depth), min_depth,
                   max_depth) / max_depth


def _keras_shape(shape: torch.Size) -> tuple:
    """The Keras shape of a port parameter: OIHW -> HWIO, (out, in) ->
    (in, out), vectors as they are."""
    if len(shape) == 4:
        return (shape[2], shape[3], shape[1], shape[0])
    if len(shape) == 2:
        return (shape[1], shape[0])
    return tuple(shape)


def import_keras_sequential(weights, model: torch.nn.Module
                            ) -> "OrderedDict[str, torch.Tensor]":
    """The reference's positional import walk
    (``src/load_weight_from_keras.py:47-83``): the port's parameters in
    ``named_parameters()`` order consume the Keras ``model.get_weights()``
    list one array each, conv kernels transposed HWIO -> OIHW and Dense
    kernels ``(in, out)`` -> ``(out, in)``; a BatchNorm's bias also consumes
    the next two arrays as its running mean and variance.

    ``named_parameters`` walks the modules in definition order, which is
    the network order of the reference's models and of the port's, and a
    module's ``weight`` before its ``bias``: the walk needs no
    ``layer_order`` (the JAX walk does, because flax trees iterate
    alphabetically).

    Returns a new ``state_dict`` of ``model`` (``model`` is left as it is);
    raises ``ValueError`` on a shape mismatch, an early end of the list or
    arrays left over, as ``load_state_dict`` would."""
    it = iter(list(weights))

    def take(shape):
        try:
            w = np.asarray(next(it))
        except StopIteration:
            raise ValueError("keras weight list exhausted early") from None
        if tuple(w.shape) != tuple(shape):
            raise ValueError(f"shape mismatch: keras {w.shape} vs "
                             f"{tuple(shape)}")
        return w

    out = OrderedDict((k, v.detach().clone())
                      for k, v in model.state_dict().items())
    modules = dict(model.named_modules())
    for name, p in model.named_parameters():
        w = take(_keras_shape(p.shape))
        if p.dim() == 4:
            w = keras_conv_kernel(w)
        elif p.dim() == 2:
            w = keras_dense_kernel(w)
        out[name] = torch.from_numpy(np.array(w, np.float32))
        owner, _, leaf = name.rpartition(".")
        norm = modules.get(owner)
        if leaf == "bias" and isinstance(norm, torch.nn.modules.batchnorm
                                         ._BatchNorm):
            for stat in ("running_mean", "running_var"):
                buf = getattr(norm, stat)
                out[f"{owner}.{stat}"] = torch.from_numpy(
                    np.array(take(buf.shape), np.float32))
    leftover = sum(1 for _ in it)
    if leftover:
        raise ValueError(f"{leftover} keras weights left unconsumed")
    return out
