"""Weight bridge: a JAX GuideDepth ``{'params', 'batch_stats'}`` tree (nested
dicts of numpy arrays) -> the port's ``state_dict``, and a gradient tree of
the same ``params`` structure -> gradients by parameter name.

The inverse of ``tpudepth/models/torch_import.py::convert_guidedepth``, with
its own copy of the name table (``_ddrnet``, ``_gub`` there):

- conv kernels HWIO -> OIHW;
- flax ``Dense`` kernels ``[in, out]`` -> ``Linear.weight`` ``[out, in]``;
- BatchNorm ``scale``/``bias``/``mean``/``var`` -> ``weight``/``bias``/
  ``running_mean``/``running_var``, with ``num_batches_tracked`` = 0.

Every leaf of the tree must be consumed; a leaf left over raises.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, Iterator, Mapping, Optional, Tuple

import numpy as np
import torch

Entry = Tuple[str, str, str]  # (kind, flax path, torch prefix)


def _basic_block(fp: str, tp: str, has_downsample: bool) -> Iterator[Entry]:
    for i in (1, 2):
        yield "conv", f"{fp}/conv{i}", f"{tp}.conv{i}"
        yield "bn", f"{fp}/bn{i}", f"{tp}.bn{i}"
    if has_downsample:
        yield "conv", f"{fp}/downsample_conv", f"{tp}.downsample.0"
        yield "bn", f"{fp}/downsample_bn", f"{tp}.downsample.1"


def _bottleneck(fp: str, tp: str) -> Iterator[Entry]:
    for i in (1, 2, 3):
        yield "conv", f"{fp}/conv{i}", f"{tp}.conv{i}"
        yield "bn", f"{fp}/bn{i}", f"{tp}.bn{i}"
    yield "conv", f"{fp}/downsample_conv", f"{tp}.downsample.0"
    yield "bn", f"{fp}/downsample_bn", f"{tp}.downsample.1"


def _ddrnet(fp: str, tp: str) -> Iterator[Entry]:
    def f(p):
        return f"{fp}/{p}"

    def t(p):
        return f"{tp}.{p}"

    yield "conv", f("stem_conv1"), t("conv1.0")
    yield "bn", f("stem_bn1"), t("conv1.1")
    yield "conv", f("stem_conv2"), t("conv1.3")
    yield "bn", f("stem_bn2"), t("conv1.4")
    # (name, blocks, first block downsamples)
    for name, ds in (("layer1", False), ("layer2", True), ("layer3", True),
                     ("layer4", True), ("layer3_", False),
                     ("layer4_", False)):
        for i in range(2):
            yield from _basic_block(f(f"{name}/block{i}"), t(f"{name}.{i}"),
                                    ds and i == 0)
    yield from _bottleneck(f("layer5_/block0"), t("layer5_.0"))
    yield from _bottleneck(f("layer5/block0"), t("layer5.0"))
    for fname, tconv, tbn in (
            ("compression3", "compression3.0", "compression3.1"),
            ("compression4", "compression4.0", "compression4.1"),
            ("down3", "down3.0", "down3.1"),
            ("down4_a", "down4.0", "down4.1"),
            ("down4_b", "down4.3", "down4.4")):
        yield "conv", f(f"{fname}/conv"), t(tconv)
        yield "bn", f(f"{fname}/bn"), t(tbn)
    yield "bn", f("spp/scale0/bn"), t("spp.scale0.0")
    yield "conv", f("spp/scale0/conv"), t("spp.scale0.2")
    for i in (1, 2, 3, 4):
        yield "bn", f(f"spp/scale{i}/bn"), t(f"spp.scale{i}.1")
        yield "conv", f(f"spp/scale{i}/conv"), t(f"spp.scale{i}.3")
        yield "bn", f(f"spp/process{i}/bn"), t(f"spp.process{i}.0")
        yield "conv", f(f"spp/process{i}/conv"), t(f"spp.process{i}.2")
    for name in ("compression", "shortcut"):
        yield "bn", f(f"spp/{name}/bn"), t(f"spp.{name}.0")
        yield "conv", f(f"spp/{name}/conv"), t(f"spp.{name}.2")
    yield "bn", f("final_layer/bn1"), t("final_layer.bn1")
    yield "conv", f("final_layer/conv1"), t("final_layer.conv1")
    yield "bn", f("final_layer/bn2"), t("final_layer.bn2")
    yield "conv", f("final_layer/conv2"), t("final_layer.conv2")


def _gub(fp: str, tp: str) -> Iterator[Entry]:
    for branch, seq in (("feature_conv", "feature_conv"),
                        ("guide_conv", "guide_conv"),
                        ("comb_conv", "comb_conv")):
        for sub, idx in (("a", 0), ("b", 3)):
            yield "conv", f"{fp}/{branch}_{sub}/conv", f"{tp}.{seq}.{idx}"
            yield "bn", f"{fp}/{branch}_{sub}/bn", f"{tp}.{seq}.{idx + 1}"
    yield "dense", f"{fp}/SE_block/fc1", f"{tp}.SE_block.fc.0"
    yield "dense", f"{fp}/SE_block/fc2", f"{tp}.SE_block.fc.2"
    yield "conv", f"{fp}/reduce", f"{tp}.reduce"


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            out.update(_flatten(v, path))
        else:
            out[path] = np.asarray(v, dtype=np.float32)
    return out


def _convert(params: Dict[str, np.ndarray],
             stats: Optional[Dict[str, np.ndarray]]) -> "OrderedDict[str, torch.Tensor]":
    """Map flattened flax leaves to port names. ``stats=None`` maps a
    params-only tree (gradients): no BatchNorm statistics are expected or
    written."""
    tables = [params] + ([stats] if stats is not None else [])
    used = set()

    def take(table, key):
        used.add((id(table), key))
        return table[key]

    out: "OrderedDict[str, torch.Tensor]" = OrderedDict()

    def put(name, arr):
        out[name] = torch.from_numpy(np.array(arr, np.float32))

    entries = list(_ddrnet("feature_extractor", "feature_extractor"))
    for i in (1, 2, 3):
        entries += list(_gub(f"up_{i}", f"up_{i}"))
    for kind, fp, tp in entries:
        if kind == "conv":
            put(f"{tp}.weight",
                np.transpose(take(params, f"{fp}/Conv_0/kernel"), (3, 2, 0, 1)))
            if f"{fp}/Conv_0/bias" in params:
                put(f"{tp}.bias", take(params, f"{fp}/Conv_0/bias"))
        elif kind == "bn":
            put(f"{tp}.weight", take(params, f"{fp}/BatchNorm_0/scale"))
            put(f"{tp}.bias", take(params, f"{fp}/BatchNorm_0/bias"))
            if stats is not None:
                put(f"{tp}.running_mean", take(stats, f"{fp}/BatchNorm_0/mean"))
                put(f"{tp}.running_var", take(stats, f"{fp}/BatchNorm_0/var"))
                out[f"{tp}.num_batches_tracked"] = torch.tensor(
                    0, dtype=torch.long)
        else:
            put(f"{tp}.weight", take(params, f"{fp}/kernel").T)

    left = [k for table in tables for k in table
            if (id(table), k) not in used]
    if left:
        raise ValueError(f"flax leaves not consumed by the bridge: {left}")
    return out


def guidedepth_state_dict_from_flax(variables: Mapping) -> "OrderedDict[str, torch.Tensor]":
    """JAX GuideDepth variables -> the port's ``state_dict`` (GuideDepth or
    GuideDepth-S; the widths come from the arrays)."""
    return _convert(_flatten(variables["params"]),
                    _flatten(variables.get("batch_stats", {})))


def guidedepth_grads_from_flax(grads: Mapping) -> "OrderedDict[str, torch.Tensor]":
    """A flax gradient tree (the structure of ``variables['params']``) ->
    ``{parameter name: gradient}`` under the same key table and layout
    changes, to hold against ``dict(model.named_parameters())``' ``.grad``."""
    return _convert(_flatten(grads), None)
