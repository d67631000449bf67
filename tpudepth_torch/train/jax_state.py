"""The JAX trainer's state in the port's terms: a restored ``optax.adam``
state <-> ``torch.optim.Adam``'s ``state_dict``, and a whole restored JAX
trainer payload -> the port's checkpoint schema (``train/checkpoint.py``).

The parameters go through the weight bridge's name tables
(``models/jax_weights.py``); reading the orbax directory is
``train/orbax_io.py``. Functions:

- :func:`optimizer_state_from_optax`: an ``optax.adam(schedule)`` state,
  plain (``[{count, mu, nu}, {count}]``) or under ``optax.multi_transform``
  with the encoder frozen (None at every encoder leaf), -> the port's Adam
  over ``trainable_parameters(model, freeze_encoder)``;
- :func:`optax_state_from_torch`: its inverse;
- :func:`trainer_checkpoint_from_jax`: ``params``, ``batch_stats``,
  ``opt_state`` and the epoch keys -> ``model``, ``optimizer`` and the
  epoch keys as they are.
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np
import torch

from tpudepth_torch.core.config import TrainConfig
from tpudepth_torch.models.jax_weights import (
    _convert,
    _entries,
    _flatten,
    flax_from_torch,
    state_dict_from_flax,
)
from tpudepth_torch.train.trainer import ENCODER_PREFIX, make_optimizer


def _adam_state(opt_state) -> Tuple[Mapping, str]:
    """``(count, mu, nu)`` node of an ``optax.adam(schedule)`` state, plain
    (``[adam, schedule]``) or under ``optax.multi_transform`` with a
    ``'frozen'`` ``set_to_zero`` partition, and its path."""
    state, prefix = opt_state, "opt_state"
    if isinstance(state, Mapping) and "inner_states" in state:
        inner = state["inner_states"]
        if sorted(inner) != ["frozen", "train"]:
            raise ValueError(f"opt_state/inner_states: partitions "
                             f"{sorted(inner)}, expected 'train' and 'frozen'")
        if inner["frozen"].get("inner_state") is not None:
            raise ValueError("opt_state/inner_states/frozen/inner_state "
                             "holds state; set_to_zero holds none")
        state = inner["train"]["inner_state"]
        prefix = "opt_state/inner_states/train/inner_state"
    if not (isinstance(state, (list, tuple)) and len(state) == 2):
        raise ValueError(f"{prefix}: not the [scale_by_adam, schedule] chain "
                         "of optax.adam")
    adam = state[0]
    if not (isinstance(adam, Mapping) and {"count", "mu", "nu"} <= set(adam)):
        raise ValueError(f"{prefix}/0: no count, mu and nu")
    return adam, f"{prefix}/0"


def optimizer_state_from_optax(name: str, opt_state, model: torch.nn.Module,
                               freeze_encoder: bool) -> Dict:
    """A restored ``optax.adam`` state of ``build_model(name)`` (plain, or
    under ``multi_transform`` with the encoder frozen) -> the
    ``torch.optim.Adam`` ``state_dict`` of the port's optimizer over
    ``trainable_parameters(model, freeze_encoder)``: ``mu`` -> ``exp_avg``,
    ``nu`` -> ``exp_avg_sq`` through the key tables, ``count`` -> every
    parameter's ``step``, the param group ``make_optimizer``'s (its ``lr``
    ``TrainConfig``'s default; the train step sets it from the schedule
    before every update). A None (masked) leaf must stand exactly where
    a frozen parameter does and an array exactly where a trainable one
    does, of its shape; anything else raises, naming the leaf."""
    adam, prefix = _adam_state(opt_state)
    entries = _entries(name)
    moments = {}
    for field in ("mu", "nu"):
        sources: Dict[str, str] = {}
        try:
            conv = _convert(_flatten(adam[field], keep_none=True), None,
                            entries, sources)
        except KeyError as err:
            raise KeyError(f"{prefix}/{field}: {err.args[0]}") from None
        except ValueError as err:
            raise ValueError(f"{prefix}/{field}: {err}") from None
        moments[field] = (conv, sources)
    named = dict(model.named_parameters())
    extra = sorted(set(moments["mu"][0]) - set(named))
    if extra:
        raise ValueError(f"{prefix}/mu holds {extra[:3]}..., which "
                         f"{type(model).__name__} does not have")
    count = int(np.asarray(adam["count"]))
    state, trainable = {}, []
    for pname, p in named.items():
        frozen = freeze_encoder and pname.startswith(ENCODER_PREFIX)
        found = {}
        for field, (conv, sources) in moments.items():
            if pname not in conv:
                raise KeyError(f"{prefix}/{field} has no leaf for the port's "
                               f"{pname}")
            leaf = f"{prefix}/{field}/{sources[pname]}"
            value = conv[pname]
            if frozen and value is not None:
                raise ValueError(f"{leaf} holds an array where the frozen "
                                 f"{pname} takes a masked (None) leaf")
            if not frozen and value is None:
                raise ValueError(f"{leaf} is masked (None) where the "
                                 f"trainable {pname} takes its moment")
            if value is not None and value.shape != p.shape:
                raise ValueError(f"{leaf} has shape {tuple(value.shape)}, the "
                                 f"port's {pname} {tuple(p.shape)}")
            found[field] = value
        if not frozen:
            state[len(trainable)] = {
                "step": torch.tensor(float(count)),
                "exp_avg": found["mu"], "exp_avg_sq": found["nu"]}
            trainable.append(p)
    out = make_optimizer(TrainConfig(), trainable).state_dict()
    out["state"] = state
    return out


def optax_state_from_torch(name: str, optimizer_state: Mapping,
                           model: torch.nn.Module,
                           freeze_encoder: bool) -> object:
    """The inverse of :func:`optimizer_state_from_optax`: the port's Adam
    ``state_dict`` -> the tree an orbax restore of the JAX trainer's
    ``opt_state`` gives: ``[{count, mu, nu}, {count}]``, or under
    ``{'inner_states': {'frozen': {'inner_state': None}, 'train':
    {'inner_state': [...]}}}`` with None at every encoder leaf when
    ``freeze_encoder``. Counts are int32 0-d arrays, moments float32."""
    params = dict(model.named_parameters())
    names = [n for n in params
             if not (freeze_encoder and n.startswith(ENCODER_PREFIX))]
    states = optimizer_state["state"]
    steps = {float(torch.as_tensor(s["step"])) for s in states.values()}
    if len(steps) > 1:
        raise ValueError(f"parameters at different Adam steps {sorted(steps)}")
    count = np.asarray(int(steps.pop()) if steps else 0, np.int32)
    moments = {}
    for field, key in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
        named = dict.fromkeys(params)
        for i, n in enumerate(names):
            named[n] = (states[i][key] if i in states
                        else torch.zeros_like(params[n], device="cpu"))
        moments[field] = flax_from_torch(name, named, stats=False)["params"]
    chain = [{"count": count, "mu": moments["mu"], "nu": moments["nu"]},
             {"count": count.copy()}]
    if not freeze_encoder:
        return chain
    return {"inner_states": {"frozen": {"inner_state": None},
                             "train": {"inner_state": chain}}}


#: the keys of a JAX trainer payload (``tpudepth/train/trainer.py:496-602``)
_PAYLOAD_KEYS = ("params", "batch_stats", "opt_state", "epoch", "val_losses",
                 "loss", "best_epoch", "val_loss")


def trainer_checkpoint_from_jax(name: str, tree: Mapping,
                                model: torch.nn.Module,
                                freeze_encoder: bool) -> Dict:
    """A restored JAX trainer payload of ``build_model(name)`` -> the port's
    checkpoint schema (``train/checkpoint.py``): ``model`` (parameters and
    BatchNorm statistics), ``optimizer`` where the payload has
    ``opt_state``, and ``epoch`` with ``val_losses`` (GuideDepth schema: the
    epoch to resume at) or ``loss`` (root schema: the completed epoch), or
    ``best_epoch`` / ``val_loss`` (``best_model``), passed through as they
    are. An unknown key raises, naming it."""
    unknown = sorted(set(tree) - set(_PAYLOAD_KEYS))
    if unknown or "params" not in tree:
        raise ValueError(f"not a JAX trainer payload: unknown keys {unknown}"
                         if unknown else "not a JAX trainer payload: no params")
    converted = state_dict_from_flax(name, tree)
    # the port's key order, which the optimizer state's parameter list
    # follows (``trainer.optimizer_state_by_name`` pairs them by it)
    order = [k for k in model.state_dict() if k in converted]
    out = {"model": {k: converted[k] for k in
                     order + [k for k in converted if k not in order]}}
    if "opt_state" in tree:
        out["optimizer"] = optimizer_state_from_optax(
            name, tree["opt_state"], model, freeze_encoder)
    for key in _PAYLOAD_KEYS[3:]:
        if key in tree:
            out[key] = tree[key]
    return out
