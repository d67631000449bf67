"""``Trainer.restore`` of a reference ``.pth`` with an Adam state: the saved
moments are paired with the port's parameters by name, not by position
(``train/trainer.py::optimizer_state_by_name``).

The reference's Adam runs over every parameter of its model in
``state_dict`` order; the reference SAM has 8 ``Unet.1.crf{i}.proj``
parameters the port drops, and the port's Adam holds the trainable
parameters only (SAM's encoder is frozen), so positions do not line up.
"""

import pytest
import torch

from torch_port_helpers import torch_one_thread  # noqa: F401
from tpudepth_torch.core.config import TrainConfig
from tpudepth_torch.models.layers import init_random_
from tpudepth_torch.models.registry import build_model
from tpudepth_torch.train import trainer as ttr


def _reference_state_dict(name):
    """A port model's ``state_dict`` in the reference's layout: SAM's 3x3
    ``proj`` convs and ``relative_position_index`` buffers inserted at the
    head of each ``Unet.1.crf{i}``."""
    sd = init_random_(build_model(name), seed=3).state_dict()
    if name != "sam":
        return dict(sd)
    out = {}
    for k, v in sd.items():
        for i, c in enumerate((128, 256, 512, 1024)):
            if k.startswith(f"Unet.1.crf{i}.") and \
                    f"Unet.1.crf{i}.proj.weight" not in out:
                out[f"Unet.1.crf{i}.proj.weight"] = torch.randn(c, c, 3, 3)
                out[f"Unet.1.crf{i}.proj.bias"] = torch.randn(c)
                out[f"Unet.1.crf{i}.sam_block.attn.relative_position_index"] \
                    = torch.zeros(49, 49, dtype=torch.long)
        out[k] = v
    return out


def _adam_state(sd, names):
    """A torch Adam ``state_dict`` over ``names`` (in order), each moment
    filled from its name, so a test can tell which one landed where."""
    state = {}
    for i, n in enumerate(names):
        g = torch.Generator().manual_seed(hash(n) % 2**31)
        state[i] = {"step": torch.tensor(3.0),
                    "exp_avg": torch.randn(sd[n].shape, generator=g),
                    "exp_avg_sq": torch.rand(sd[n].shape, generator=g)}
    group = {"lr": 1e-4, "betas": (0.9, 0.999), "eps": 1e-8,
             "weight_decay": 0, "amsgrad": False,
             "params": list(range(len(names)))}
    return {"state": state, "param_groups": [group]}


def _parameter_names(sd, model):
    buffers = {n for n, _ in model.named_buffers()}
    return [k for k in sd if k not in buffers
            and not k.endswith("relative_position_index")]


@pytest.mark.parametrize("name,which", [("sam", "all"), ("sam", "trainable"),
                                        ("GuideDepth", "all")])
def test_reference_adam_state_restores_by_name(tmp_path, name, which):
    sd = _reference_state_dict(name)
    trainer = ttr.Trainer(TrainConfig(model=name), device="cpu")
    trainer.init_state()
    names = _parameter_names(sd, trainer.model)
    if which == "trainable":
        names = [n for n in names if not n.startswith(ttr.ENCODER_PREFIX)]
    opt = _adam_state(sd, names)
    path = tmp_path / "global_checkpoint"
    if name == "sam":
        # the root schema (src/train.py:147-153)
        torch.save({"epoch": 3, "model_state_dict": sd, "loss": 0.5,
                    "optimizer_state_dict": opt}, path)
    else:
        # the GuideDepth schema (src/GuideDepth/training.py:166-178)
        torch.save({"epoch": 2, "val_losses": [0.5, 0.4], "model": sd,
                    "optimizer": opt, "lr_scheduler": {}}, path)
    trainer.restore(str(path))
    written = {n: opt["state"][i] for i, n in enumerate(names)}
    own = dict(trainer.model.named_parameters())
    trainable = ttr.trainable_parameters(trainer.model,
                                         trainer.freeze_encoder)
    assert len(trainable) == (96 if name == "sam" else len(own))
    state = trainer.state.optimizer.state
    for n, p in own.items():
        if not any(p is q for q in trainable):
            assert p not in state, n
            continue
        for key in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(state[p][key], written[n][key]), (n, key)
        assert float(state[p]["step"]) == 3.0
    for n in written:
        assert n in own or ".proj." in n


def test_a_mismatched_adam_state_raises_naming_the_counts(tmp_path):
    sd = _reference_state_dict("sam")
    trainer = ttr.Trainer(TrainConfig(model="sam"), device="cpu")
    trainer.init_state()
    names = _parameter_names(sd, trainer.model)[:-5]
    path = tmp_path / "global_checkpoint"
    torch.save({"epoch": 3, "model_state_dict": sd, "loss": 0.5,
                "optimizer_state_dict": _adam_state(sd, names)}, path)
    with pytest.raises(ValueError, match=(
            f"holds {len(names)} parameters; the file's model has "
            f"{len(names) + 5} parameters, 104 of them trainable")):
        trainer.restore(str(path))
