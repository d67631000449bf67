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

By model name (any alias of ``registry.build_model``):
:func:`state_dict_from_flax`, and its inverse :func:`flax_from_torch`. The
trainer's state (the optax Adam state, a whole JAX trainer payload) goes
through ``train/jax_state.py`` on top of these tables.
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


def _flatten(tree: Mapping, prefix: str = "", keep_none: bool = False,
             dtype=np.float32) -> Dict[str, Optional[np.ndarray]]:
    """``{"a/b/kernel": array}`` of a nested tree, in ``dtype``.
    ``keep_none``: a ``None`` leaf (optax's masked node, as an orbax file
    restores it) stays None."""
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            out.update(_flatten(v, path, keep_none, dtype))
        elif keep_none and v is None:
            out[path] = None
        else:
            out[path] = np.asarray(v, dtype=dtype)
    return out


# (flax -> port, port -> flax) layout changes of a kind's kernel
_CONV = (lambda k: np.transpose(k, (3, 2, 0, 1)),
         lambda w: np.transpose(w, (2, 3, 1, 0)))
_TCONV = (lambda k: np.transpose(k, (2, 3, 0, 1))[:, :, ::-1, ::-1],
          lambda w: np.transpose(w[:, :, ::-1, ::-1], (2, 3, 0, 1)))
_DENSE = (lambda k: k.T, lambda w: w.T)


def _leaf_map(entries: List[Entry]):
    """Every leaf of ``entries``: (port name, flax leaf path, ``'params'`` or
    ``'stats'``, layout pair or None, optional)."""
    for kind, fp, tp in entries:
        if kind == "conv":
            yield f"{tp}.weight", f"{fp}/Conv_0/kernel", "params", _CONV, False
            yield f"{tp}.bias", f"{fp}/Conv_0/bias", "params", None, True
        elif kind == "tconv":
            yield (f"{tp}.weight", f"{fp}/ConvTranspose_0/kernel", "params",
                   _TCONV, False)
            yield (f"{tp}.bias", f"{fp}/ConvTranspose_0/bias", "params", None,
                   False)
        elif kind in ("bn", "ln"):
            mod = "BatchNorm_0" if kind == "bn" else "LayerNorm_0"
            yield f"{tp}.weight", f"{fp}/{mod}/scale", "params", None, False
            yield f"{tp}.bias", f"{fp}/{mod}/bias", "params", None, False
            if kind == "bn":
                yield (f"{tp}.running_mean", f"{fp}/{mod}/mean", "stats", None,
                       False)
                yield (f"{tp}.running_var", f"{fp}/{mod}/var", "stats", None,
                       False)
        elif kind == "raw":
            yield tp, fp, "params", None, False
        else:
            yield f"{tp}.weight", f"{fp}/kernel", "params", _DENSE, False
            yield f"{tp}.bias", f"{fp}/bias", "params", None, True


def _convert(params: Dict[str, Optional[np.ndarray]],
             stats: Optional[Dict[str, np.ndarray]],
             entries: List[Entry],
             sources: Optional[Dict[str, str]] = None, dtype=np.float32
             ) -> "OrderedDict[str, Optional[torch.Tensor]]":
    """Map flattened flax leaves to port names by ``entries``.
    ``stats=None`` maps a params-only tree (gradients, Adam moments): no
    BatchNorm statistics are expected or written. A None leaf maps to None.
    ``sources``, when given, receives each port name's flax leaf path.
    Tensors are ``dtype`` (float32 unless asked otherwise). A
    missing leaf raises ``KeyError`` and a leaf left over ``ValueError``,
    each naming the leaf."""
    tables = {"params": params, "stats": stats}
    used = set()
    out: "OrderedDict[str, Optional[torch.Tensor]]" = OrderedDict()
    for name, key, table, layout, optional in _leaf_map(entries):
        src = tables[table]
        if src is None:
            continue
        if key not in src:
            if optional:
                continue
            raise KeyError(f"flax leaf {table}/{key} is missing (the port's "
                           f"{name})")
        used.add((table, key))
        if sources is not None:
            sources[name] = key
        arr = src[key]
        out[name] = None if arr is None else torch.from_numpy(
            np.array(layout[0](arr) if layout else arr, dtype))
        if name.endswith(".running_var"):
            out[name[:-len("running_var")] + "num_batches_tracked"] = \
                torch.tensor(0, dtype=torch.long)

    left = [k for table, t in tables.items() if t is not None for k in t
            if (table, k) not in used]
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


# ---------------------------------------------------------------------------
# one entry point by model name, and the tables' inverse
# ---------------------------------------------------------------------------


def _entries(name: str) -> List[Entry]:
    """The key table of any name or alias of ``registry.build_model``
    (packed and unpacked GuideDepth share one parameter tree)."""
    from tpudepth_torch.models.registry import canonical_model_name

    canon = canonical_model_name(name)
    if canon in ("GuideDepth", "GuideDepth-S"):
        return _guidedepth_entries()
    if canon == "sam":
        return _attention_entries(_sam_stage)
    if canon == "newcrf":
        return _attention_entries(_newcrf_stage)
    return _zoo_entries(canon)


def state_dict_from_flax(name: str, variables: Mapping
                         ) -> "OrderedDict[str, torch.Tensor]":
    """JAX ``{'params', 'batch_stats'}`` of ``build_model(name)`` -> the
    port's ``state_dict`` of the same model (the family functions above,
    chosen by ``registry.canonical_model_name(name)``)."""
    return _convert(_flatten(variables["params"]),
                    _flatten(variables.get("batch_stats", {})),
                    _entries(name))


def _nest(tree: Dict, path: str, value) -> None:
    *parents, leaf = path.split("/")
    for p in parents:
        tree = tree.setdefault(p, {})
    tree[leaf] = value


def flax_from_torch(name: str, named: Mapping, stats: bool = True) -> Dict:
    """The inverse of :func:`state_dict_from_flax`: port tensors by name
    (a ``state_dict``, or parameters only with ``stats=False``; a None value
    becomes a None leaf) -> ``{'params': ..., 'batch_stats': ...}`` of
    float32 numpy arrays in the flax layout (``batch_stats`` only with
    ``stats``)."""
    params: Dict = {}
    batch_stats: Dict = {}
    for pname, key, table, layout, optional in _leaf_map(_entries(name)):
        if table == "stats" and not stats:
            continue
        if pname not in named:
            if optional:
                continue
            raise KeyError(f"the port's {pname} is missing (flax leaf {key})")
        value = named[pname]
        if value is not None:
            value = np.asarray(torch.as_tensor(value).detach().cpu().float())
            value = np.ascontiguousarray(layout[1](value) if layout else value)
        _nest(params if table == "params" else batch_stats, key, value)
    return {"params": params, "batch_stats": batch_stats} if stats \
        else {"params": params}
