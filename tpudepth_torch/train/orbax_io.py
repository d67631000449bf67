"""Reading the JAX package's orbax checkpoints without orbax or JAX: the read
side of ``tpudepth/train/checkpoint.py``.

An orbax ``PyTreeCheckpointHandler`` directory holds ``_METADATA``, a JSON
file whose ``tree_metadata`` maps every leaf's key path to its keys (each
with a ``key_type``: 1 a sequence index, 2 a dict key) and its value type,
and the arrays themselves as zarr arrays (zarr v2, or v3 where
``use_zarr3`` is true) named by the dotted key path, inside one OCDBT
key-value store (``use_ocdbt``) or as one directory each. ``tensorstore``
opens them directly.

:func:`read_orbax` returns what ``load_checkpoint(path)`` of the JAX package
returns without a target, leaf for leaf: dicts and lists of numpy arrays
(``jax.Array`` and ``np.ndarray`` leaves), Python scalars (``scalar``
leaves), ``None`` for optax's masked and empty nodes, and ``{}`` / ``[]``
for empty containers. ``tensorstore`` is imported when a file is read,
never at import, and its absence raises ``ImportError``: a checkpoint is
read whole or not at all. Converting the tree into the port's state is
``models/jax_weights.py::trainer_checkpoint_from_jax`` and needs only numpy
and torch.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Tuple

METADATA = "_METADATA"

# value types of _METADATA's leaves
_ARRAYS = ("jax.Array", "np.ndarray")
_EMPTY = {"None": lambda: None, "Dict": dict, "List": list}


def is_orbax_checkpoint(path: str) -> bool:
    """A directory that holds an orbax ``_METADATA`` file."""
    return os.path.isdir(path) and os.path.isfile(os.path.join(path, METADATA))


def _tensorstore():
    try:
        import tensorstore
    except ImportError as err:
        raise ImportError(
            "reading an orbax checkpoint needs the tensorstore package, which "
            "is not installed here; convert the checkpoint where it is "
            "(tpudepth_torch.train.checkpoint.load_checkpoint, then "
            "save_checkpoint) and load the port's file") from err
    return tensorstore


def _leaves(meta: Dict[str, Any]) -> List[Tuple[list, str]]:
    """(keys, value type) of every leaf, keys as (key, key_type) pairs."""
    out = []
    for entry in meta["tree_metadata"].values():
        keys = [(k["key"], int(k["key_type"])) for k in entry["key_metadata"]]
        out.append((keys, entry["value_metadata"]["value_type"]))
    return out


def _spec(path: str, name: str, meta: Dict[str, Any]) -> Dict[str, Any]:
    """The tensorstore spec of the array ``name`` (its dotted key path)."""
    base = "file://" + os.path.abspath(path)
    if meta.get("use_ocdbt", False):
        kvstore = {"driver": "ocdbt", "base": base}
        spec = {"kvstore": kvstore, "path": name}
    else:
        spec = {"kvstore": {"driver": "file",
                            "path": os.path.join(os.path.abspath(path), name)}}
    spec["driver"] = "zarr3" if meta.get("use_zarr3", False) else "zarr"
    return spec


def _build(leaves: List[Tuple[list, Any]], where: str) -> Dict[str, Any]:
    """Nest (keys, value) pairs: a node whose children are sequence indices
    becomes a list in index order."""
    root: Dict[Any, Any] = {}
    kinds: Dict[int, int] = {}   # id(node) -> key_type of its children

    for keys, value in leaves:
        node = root
        for depth, (key, kind) in enumerate(keys):
            seen = kinds.setdefault(id(node), kind)
            if seen != kind:
                raise ValueError(f"{where}: {'/'.join(k for k, _ in keys)} "
                                 "mixes sequence and dict keys")
            if depth == len(keys) - 1:
                node[key] = value
            else:
                node = node.setdefault(key, {})

    def fix(node):
        if not isinstance(node, dict) or not node and id(node) not in kinds:
            return node
        if kinds.get(id(node)) == 1:
            order = sorted(node, key=int)
            if [int(k) for k in order] != list(range(len(order))):
                raise ValueError(f"{where}: sequence indices {order} are not "
                                 "0..n-1")
            return [fix(node[k]) for k in order]
        return {k: fix(v) for k, v in node.items()}

    return fix(root)


def read_orbax(path: str) -> Dict[str, Any]:
    """The tree of the orbax checkpoint directory ``path``, as the JAX
    package's ``load_checkpoint(path)`` restores it, with numpy arrays in
    place of ``jax.Array``. Raises ``ImportError`` without ``tensorstore``
    and ``ValueError`` on a leaf type it does not know, naming the leaf."""
    if not is_orbax_checkpoint(path):
        raise ValueError(f"{path} is not an orbax checkpoint directory (no "
                         f"{METADATA})")
    with open(os.path.join(path, METADATA)) as f:
        meta = json.load(f)
    ts = _tensorstore()
    leaves = _leaves(meta)
    opened = []
    for keys, kind in leaves:
        name = ".".join(k for k, _ in keys)
        if kind in _EMPTY:
            opened.append(None)
        elif kind in _ARRAYS or kind == "scalar":
            opened.append(ts.open(_spec(path, name, meta), open=True))
        else:
            raise ValueError(f"{path}: leaf {name} has value type {kind!r}, "
                             "which the port does not read")
    # every open, then every read, in flight together
    reads = [None if f is None else f.result().read() for f in opened]
    values = []
    for (keys, kind), read in zip(leaves, reads):
        if read is None:
            values.append((keys, _EMPTY[kind]()))
            continue
        arr = read.result()
        values.append((keys, arr.item() if kind == "scalar" else arr))
    return _build(values, path)
