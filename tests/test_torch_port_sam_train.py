"""One train step of the port's MobileV3SAMDepth against the JAX package's,
the frozen encoder, and the trainer's name-keyed switches, on the CPU.

The step: 2x64x96 from the same weights (JAX's tree filled from a numpy
seed, carried over by ``sam_state_dict_from_flax``) and the same batch,
augmentation off, the root recipe (min-max target, 3x3 box SSIM + 0.1 L1).
The JAX model runs its training trace on the CPU (the f32 attention and FFN
compositions); the port runs its default block mode in train mode, which on
CPU tensors takes the plain versions of the training kernels
(``window_attention``, ``mlp_train``). As in
``tests/test_torch_port_train_step.py`` both models run in float64 (the JAX
one under ``jax.enable_x64``; the attention's softmax, the SSIM and the L1
stay float32 in both packages), since train-mode parity in float32 is
ill-conditioned at test sizes. Tolerances: forward and mutated
``batch_stats`` rtol 1e-3 / atol 1e-4 (what ``tests/test_models.py`` holds
the JAX model to against the reference PyTorch model); loss rtol 1e-5; each
parameter gradient to 1e-3 of its tensor's largest (floor 1e-6: biases in
front of a BatchNorm hold only noise).

``Trainer``: the recipe and the frozen encoder are keyed on the canonical
name, for every name and alias; one ``val_epoch`` loss of each against the
JAX trainer's (f32 eval, rtol 1e-4: two implementations of the eval forward,
each within f32 rounding of the other).
"""

import jax
import numpy as np
import pytest
import torch

from tpudepth.train import trainer as jtr
from torch_port_helpers import torch_one_thread  # noqa: F401 (autouse)
from torch_port_jax_steps import (
    BRIDGE,
    Loader,
    aliases,
    batch,
    check_step64,
    check_trainer_switches,
    jax_step64,
    jax_val_loss,
    random_variables,
)
from tpudepth_torch.core.config import TrainConfig
from tpudepth_torch.models import registry
from tpudepth_torch.models.registry import build_model
from tpudepth_torch.train import trainer as ttr

NAME = "sam"
LR = 1e-4


@pytest.fixture(scope="module")
def both():
    """JAX's float64 step, its variables and the batch; the JAX trainer's
    validation of the same variables, per canonical name (made on first
    use)."""
    variables = random_variables(NAME, 3)
    image, depth = batch(11)
    want = jax_step64(NAME, variables, image, depth)
    return variables, want, (image, depth), {}


def _val_reference(both, canon):
    variables, _, _, cache = both
    if canon not in cache:
        v = variables if canon == NAME else random_variables(canon, 4)
        loader = Loader(12)
        cache[canon] = (v, loader, jax_val_loss(canon, v, loader))
    return cache[canon]


def test_float64_step_matches_jax(both):
    variables, want, (image, depth), _ = both
    check_step64(NAME, variables, want, image, depth)


def test_the_encoder_is_frozen_by_the_optimizer_alone(both):
    """A float32 ``Trainer`` step on the CPU: Adam leaves every encoder
    parameter as it was, while the encoder ran in train mode (its BatchNorm
    statistics moved) and got its gradients; the decoder moved. The frozen
    set is the JAX package's ``freeze_encoder_mask``, carried over by the
    gradient bridge."""
    variables, _, (image, depth), _ = both
    mask = jtr.freeze_encoder_mask(variables["params"])
    ones = jax.tree_util.tree_map(
        lambda label, a: np.full(a.shape, label == "frozen", np.float32),
        mask, variables["params"])
    frozen = {n for n, t in BRIDGE[NAME][1](ones).items() if t.all()}
    port = build_model(NAME)
    port.load_state_dict(BRIDGE[NAME][0](variables))
    names = dict(port.named_parameters())
    assert frozen == {n for n in names if n.startswith(ttr.ENCODER_PREFIX)}
    assert 0 < len(frozen) < len(names)

    loader = Loader(13)
    trainer = ttr.Trainer(TrainConfig(model="mobilev3_sam",
                                      compute_dtype="float32",
                                      learning_rate=LR),
                          model=port, device="cpu", train_loader=loader)
    before = {k: v.clone() for k, v in port.state_dict().items()}
    state = trainer.init_state()
    opt_params = {id(p) for g in state.optimizer.param_groups
                  for p in g["params"]}
    assert opt_params == {id(p) for n, p in names.items() if n not in frozen}
    for _ in range(2):
        loss = trainer.train_step({"image": image, "depth": depth})
        assert np.isfinite(float(loss))
    after = port.state_dict()
    for n in frozen:
        assert torch.equal(after[n], before[n]), n
        assert names[n].grad is not None, n
    moved = [n for n in names if n not in frozen
             and not torch.equal(after[n], before[n])]
    assert len(moved) == len(names) - len(frozen)
    stats = [k for k in after if k.startswith(ttr.ENCODER_PREFIX)
             and k.endswith("running_mean")]
    assert stats and all(not torch.equal(after[k], before[k]) for k in stats)


@pytest.mark.parametrize("alias", aliases("GuideDepth") + aliases("GuideDepth-S")
                         + aliases(NAME))
def test_trainer_recipe_frozen_encoder_and_val_loss_match_jax(both, alias):
    canon = registry.canonical_model_name(alias)
    variables, loader, want = _val_reference(both, canon)
    check_trainer_switches(alias, canon, variables, loader, want)


def test_canonical_model_name():
    assert registry.canonical_model_name("MobileV3_Large_SAM") == "sam"
    assert registry.canonical_model_name("NewCRFs") == "newcrf"
    assert registry.canonical_model_name("guidedepth_s") == "GuideDepth-S"
    with pytest.raises(ValueError, match="unknown model"):
        registry.canonical_model_name("resnet")
    assert registry.canonical_model_name("Custom", strict=False) == "custom"
