"""Weight bridge: a JAX ``{'params', 'batch_stats'}`` tree (nested dicts of
numpy arrays) of any of the JAX package's eight models -> the port's
``state_dict``, and a gradient tree of the same ``params`` structure ->
gradients by parameter name.

For GuideDepth, MobileV3SAMDepth and MobileV3NewCRFDepth this is the inverse
of ``tpudepth/models/torch_import.py::convert_guidedepth`` and
``::convert_attention_model`` (``variant='sam'`` and ``'newcrf'``), with its
own copy of their name tables (``_ddrnet``, ``_gub``, ``_mnv3_encoder``,
``_sam_stage``, ``_newcrf_stage`` there). No converter covers
MobileV3DenseDepth, MobileV3UNet and MobileV3UNetInterp (their reference
files are not in the repo); their tables here map the flax names onto the
port's modules of the same names:

- conv kernels HWIO -> OIHW (depthwise ``(kh, kw, 1, C)`` -> ``(C, 1, kh,
  kw)`` by the same transpose);
- transposed-conv kernels ``(kh, kw, in, out)`` -> ``(in, out, kh, kw)``,
  flipped in H and W: flax's ``ConvTranspose`` slides its kernel unflipped
  over the dilated input, torch's ``ConvTranspose2d`` is the gradient of a
  conv and so flips it (``torch_import.py:75-82`` flips the other way);
- flax ``Dense`` kernels ``[in, out]`` -> ``Linear.weight`` ``[out, in]``;
- BatchNorm ``scale``/``bias``/``mean``/``var`` -> ``weight``/``bias``/
  ``running_mean``/``running_var``, with ``num_batches_tracked`` = 0;
- LayerNorm ``scale``/``bias`` -> ``weight``/``bias``; the relative-position
  bias table as it is.

Every leaf of the tree must be consumed; a leaf left over raises.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, Iterator, List, Mapping, Optional, Tuple

import numpy as np
import torch

Entry = Tuple[str, str, str]  # (kind, flax path, torch prefix)

# the MobileNetV3 block tables: (has expand, has SE) per inverted residual,
# the port's own copy of the exp != in and use_se columns of LARGE_SPEC and
# SMALL_SPEC
_MNV3_LARGE = ((False, False),) + ((True, False),) * 2 + ((True, True),) * 3 \
    + ((True, False),) * 4 + ((True, True),) * 5
_MNV3_SMALL = ((False, True),) + ((True, False),) * 2 + ((True, True),) * 8


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


def _mnv3(fp: str, tp: str, table=_MNV3_LARGE) -> Iterator[Entry]:
    """MobileNetV3's features, Large by default, ``table=_MNV3_SMALL`` for
    Small."""
    def cna(f, t):
        yield "conv", f"{f}/conv", f"{t}.0"
        yield "bn", f"{f}/bn", f"{t}.1"

    yield from cna(f"{fp}/stem", f"{tp}.0")
    for i, (expand, se) in enumerate(table):
        fb, tb = f"{fp}/block{i + 1}", f"{tp}.{i + 1}.block"
        j = 0
        if expand:
            yield from cna(f"{fb}/expand", f"{tb}.{j}")
            j += 1
        yield from cna(f"{fb}/depthwise", f"{tb}.{j}")
        j += 1
        if se:
            yield "conv", f"{fb}/se/fc1", f"{tb}.{j}.fc1"
            yield "conv", f"{fb}/se/fc2", f"{tb}.{j}.fc2"
            j += 1
        yield from cna(f"{fb}/project", f"{tb}.{j}")
    yield from cna(f"{fp}/head", f"{tp}.{len(table) + 1}")


def _sam_stage(fp: str, tp: str) -> Iterator[Entry]:
    yield "conv", f"{fp}/proj_e", f"{tp}.proj_e"
    yield "conv", f"{fp}/proj_q", f"{tp}.proj_q"
    fb, tb = f"{fp}/sam_block", f"{tp}.sam_block"
    yield "ln", f"{fb}/norm1", f"{tb}.norm1"
    yield "ln", f"{fb}/normv", f"{tb}.normv"
    yield "raw", f"{fb}/attn/relative_position_bias_table", \
        f"{tb}.attn.relative_position_bias_table"
    for name in ("q", "kv", "proj"):
        yield "dense", f"{fb}/attn/{name}", f"{tb}.attn.{name}"
    yield "ln", f"{fb}/norm2", f"{tb}.norm2"
    yield "dense", f"{fb}/mlp/fc1", f"{tb}.mlp.fc1"
    yield "dense", f"{fb}/mlp/fc2", f"{tb}.mlp.fc2"
    yield "ln", f"{fp}/norm_sam", f"{tp}.norm_sam"


def _newcrf_stage(fp: str, tp: str, depth: int = 2) -> Iterator[Entry]:
    yield "conv", f"{fp}/proj_x", f"{tp}.proj_x"
    yield "conv", f"{fp}/proj_v", f"{tp}.proj_v"
    for i in range(depth):
        fb, tb = f"{fp}/block{i}", f"{tp}.crf_layer.blocks.{i}"
        yield "ln", f"{fb}/norm1", f"{tb}.norm1"
        yield "raw", f"{fb}/attn/relative_position_bias_table", \
            f"{tb}.attn.relative_position_bias_table"
        for name in ("qk", "proj"):
            yield "dense", f"{fb}/attn/{name}", f"{tb}.attn.{name}"
        yield "ln", f"{fb}/norm2", f"{tb}.norm2"
        yield "dense", f"{fb}/mlp/fc1", f"{tb}.mlp.fc1"
        yield "dense", f"{fb}/mlp/fc2", f"{tb}.mlp.fc2"
    yield "ln", f"{fp}/norm_crf", f"{tp}.norm_crf"


def _guidedepth_entries() -> List[Entry]:
    entries = list(_ddrnet("feature_extractor", "feature_extractor"))
    for i in (1, 2, 3):
        entries += list(_gub(f"up_{i}", f"up_{i}"))
    return entries


def _attention_entries(stage) -> List[Entry]:
    """MobileNetV3-Large, the bridge, four stages of ``stage`` and the
    head."""
    entries = list(_mnv3("encoder", "Unet.0.original_model.features"))
    entries.append(("conv", "decoder/conv0", "Unet.1.conv0"))
    for i in range(4):
        entries += list(stage(f"decoder/crf{i}", f"Unet.1.crf{i}"))
    entries.append(("conv", "decoder/conv1", "Unet.1.conv1"))
    return entries


def _conv_block(fp: str, tp: str) -> Iterator[Entry]:
    for i in (1, 2):
        yield "conv", f"{fp}/conv{i}", f"{tp}.conv{i}"


def _zoo_entries(name: str) -> List[Entry]:
    """MobileV3DenseDepth (``'densedepth'``), MobileV3UNet (``'unet'``) and
    MobileV3UNetInterp (``'unet_interp'``, ``'unet_interp_small'``): the
    encoder, the bridge, the up stages and the head, under the flax names
    (an up stage's unnamed ``ConvBlock_0`` is the port's ``convBlock``)."""
    table = _MNV3_SMALL if name == "unet_interp_small" else _MNV3_LARGE
    entries = list(_mnv3("encoder", "encoder.features", table))
    if name == "densedepth":
        entries.append(("conv", "conv2", "conv2"))
        ups = [f"up{i}" for i in range(6)]
    elif name == "unet":
        entries.append(("conv", "bridge_conv", "bridge_conv"))
        ups = ["upa", "up0", "up1", "up2", "up3"]
    else:
        entries.append(("conv", "bridge", "bridge"))
        ups = [f"up{i}" for i in range(6 if table is _MNV3_SMALL else 7)]
    for up in ups:
        if name == "unet":
            entries.append(("tconv", f"{up}/up", f"{up}.up"))
            entries += list(_conv_block(f"{up}/convBlock", f"{up}.convBlock"))
        else:
            entries += list(_conv_block(f"{up}/ConvBlock_0",
                                        f"{up}.convBlock"))
    entries.append(("conv", "conv3", "conv3"))
    return entries


#: the models of :func:`_zoo_entries`
ZOO_MODELS = ("densedepth", "unet", "unet_interp", "unet_interp_small")


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
             stats: Optional[Dict[str, np.ndarray]],
             entries: List[Entry]) -> "OrderedDict[str, torch.Tensor]":
    """Map flattened flax leaves to port names by ``entries``.
    ``stats=None`` maps a params-only tree (gradients): no BatchNorm
    statistics are expected or written."""
    tables = [params] + ([stats] if stats is not None else [])
    used = set()

    def take(table, key):
        used.add((id(table), key))
        return table[key]

    out: "OrderedDict[str, torch.Tensor]" = OrderedDict()

    def put(name, arr):
        out[name] = torch.from_numpy(np.array(arr, np.float32))

    for kind, fp, tp in entries:
        if kind == "conv":
            put(f"{tp}.weight",
                np.transpose(take(params, f"{fp}/Conv_0/kernel"), (3, 2, 0, 1)))
            if f"{fp}/Conv_0/bias" in params:
                put(f"{tp}.bias", take(params, f"{fp}/Conv_0/bias"))
        elif kind == "tconv":
            kernel = take(params, f"{fp}/ConvTranspose_0/kernel")
            put(f"{tp}.weight",
                np.transpose(kernel, (2, 3, 0, 1))[:, :, ::-1, ::-1])
            put(f"{tp}.bias", take(params, f"{fp}/ConvTranspose_0/bias"))
        elif kind == "bn":
            put(f"{tp}.weight", take(params, f"{fp}/BatchNorm_0/scale"))
            put(f"{tp}.bias", take(params, f"{fp}/BatchNorm_0/bias"))
            if stats is not None:
                put(f"{tp}.running_mean", take(stats, f"{fp}/BatchNorm_0/mean"))
                put(f"{tp}.running_var", take(stats, f"{fp}/BatchNorm_0/var"))
                out[f"{tp}.num_batches_tracked"] = torch.tensor(
                    0, dtype=torch.long)
        elif kind == "ln":
            put(f"{tp}.weight", take(params, f"{fp}/LayerNorm_0/scale"))
            put(f"{tp}.bias", take(params, f"{fp}/LayerNorm_0/bias"))
        elif kind == "raw":
            put(tp, take(params, fp))
        else:
            put(f"{tp}.weight", take(params, f"{fp}/kernel").T)
            if f"{fp}/bias" in params:
                put(f"{tp}.bias", take(params, f"{fp}/bias"))

    left = [k for table in tables for k in table
            if (id(table), k) not in used]
    if left:
        raise ValueError(f"flax leaves not consumed by the bridge: {left}")
    return out


def guidedepth_state_dict_from_flax(variables: Mapping) -> "OrderedDict[str, torch.Tensor]":
    """JAX GuideDepth variables -> the port's ``state_dict`` (GuideDepth or
    GuideDepth-S; the widths come from the arrays)."""
    return _convert(_flatten(variables["params"]),
                    _flatten(variables.get("batch_stats", {})),
                    _guidedepth_entries())


def sam_state_dict_from_flax(variables: Mapping) -> "OrderedDict[str, torch.Tensor]":
    """JAX ``MobileV3SAMDepth`` variables -> the port's ``state_dict`` of
    ``build_model("sam")`` (the inverse of ``convert_attention_model``)."""
    return _convert(_flatten(variables["params"]),
                    _flatten(variables.get("batch_stats", {})),
                    _attention_entries(_sam_stage))


def newcrf_state_dict_from_flax(variables: Mapping) -> "OrderedDict[str, torch.Tensor]":
    """JAX ``MobileV3NewCRFDepth`` variables -> the port's ``state_dict`` of
    ``build_model("newcrf")`` (the inverse of ``convert_attention_model``
    with ``variant='newcrf'``)."""
    return _convert(_flatten(variables["params"]),
                    _flatten(variables.get("batch_stats", {})),
                    _attention_entries(_newcrf_stage))


def guidedepth_grads_from_flax(grads: Mapping) -> "OrderedDict[str, torch.Tensor]":
    """A flax gradient tree (the structure of ``variables['params']``) ->
    ``{parameter name: gradient}`` under the same key table and layout
    changes, to hold against ``dict(model.named_parameters())``' ``.grad``."""
    return _convert(_flatten(grads), None, _guidedepth_entries())


def sam_grads_from_flax(grads: Mapping) -> "OrderedDict[str, torch.Tensor]":
    """A ``MobileV3SAMDepth`` gradient tree -> ``{parameter name:
    gradient}`` of ``build_model("sam")``."""
    return _convert(_flatten(grads), None, _attention_entries(_sam_stage))


def newcrf_grads_from_flax(grads: Mapping) -> "OrderedDict[str, torch.Tensor]":
    """A ``MobileV3NewCRFDepth`` gradient tree -> ``{parameter name:
    gradient}`` of ``build_model("newcrf")``."""
    return _convert(_flatten(grads), None, _attention_entries(_newcrf_stage))


def zoo_state_dict_from_flax(name: str, variables: Mapping
                             ) -> "OrderedDict[str, torch.Tensor]":
    """JAX variables of ``build_model(name)``, ``name`` one of
    :data:`ZOO_MODELS` -> the port's ``state_dict`` of the same model."""
    return _convert(_flatten(variables["params"]),
                    _flatten(variables.get("batch_stats", {})),
                    _zoo_entries(name))


def zoo_grads_from_flax(name: str, grads: Mapping
                        ) -> "OrderedDict[str, torch.Tensor]":
    """A gradient tree of ``build_model(name)``, ``name`` one of
    :data:`ZOO_MODELS` -> ``{parameter name: gradient}``."""
    return _convert(_flatten(grads), None, _zoo_entries(name))


def densedepth_state_dict_from_flax(variables):
    """JAX ``MobileV3DenseDepth`` variables -> the port's ``state_dict``."""
    return zoo_state_dict_from_flax("densedepth", variables)


def unet_state_dict_from_flax(variables):
    """JAX ``MobileV3UNet`` variables -> the port's ``state_dict``."""
    return zoo_state_dict_from_flax("unet", variables)


def unet_interp_state_dict_from_flax(variables):
    """JAX ``MobileV3UNetInterp('large')`` variables -> the port's
    ``state_dict``."""
    return zoo_state_dict_from_flax("unet_interp", variables)


def unet_interp_small_state_dict_from_flax(variables):
    """JAX ``MobileV3UNetInterp('small')`` variables -> the port's
    ``state_dict``."""
    return zoo_state_dict_from_flax("unet_interp_small", variables)


def densedepth_grads_from_flax(grads):
    """A ``MobileV3DenseDepth`` gradient tree -> gradients by name."""
    return zoo_grads_from_flax("densedepth", grads)


def unet_grads_from_flax(grads):
    """A ``MobileV3UNet`` gradient tree -> gradients by name."""
    return zoo_grads_from_flax("unet", grads)


def unet_interp_grads_from_flax(grads):
    """A ``MobileV3UNetInterp('large')`` gradient tree -> gradients by
    name."""
    return zoo_grads_from_flax("unet_interp", grads)


def unet_interp_small_grads_from_flax(grads):
    """A ``MobileV3UNetInterp('small')`` gradient tree -> gradients by
    name."""
    return zoo_grads_from_flax("unet_interp_small", grads)
