"""One train step of the port's MobileV3NewCRFDepth against the JAX
package's, and the trainer's name-keyed switches for its names, on the CPU.

As ``tests/test_torch_port_sam_train.py`` (with the helpers of
``tests/torch_port_jax_steps.py``):
2x64x96, the same weights through ``newcrf_state_dict_from_flax``, the same
batch, augmentation off, the root recipe, both models in float64, the port
in its default block mode (``row``), which in train mode takes the unfused
block through the training kernels' plain versions, both blocks of every
stage, the second with the shift mask. Every stage pads (2x3 .. 16x24
maps), so pad tokens take part in the softmax. Tolerances as there: forward
and mutated ``batch_stats`` rtol 1e-3 / atol 1e-4; loss rtol 1e-5; each
parameter gradient to 1e-3 of its tensor's largest (floor 1e-6). NewCRF
trains its encoder: the optimizer gets every parameter.
"""

import pytest

from torch_port_helpers import torch_one_thread  # noqa: F401 (autouse)
from torch_port_jax_steps import (
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
from tpudepth_torch.models.registry import build_model
from tpudepth_torch.train import trainer as ttr

NAME = "newcrf"


@pytest.fixture(scope="module")
def both():
    """JAX's float64 step on seeded variables and a batch, and the JAX
    trainer's validation of the same variables."""
    variables = random_variables(NAME, 7)
    image, depth = batch(17)
    want = jax_step64(NAME, variables, image, depth)
    loader = Loader(18)
    return variables, want, (image, depth), loader, jax_val_loss(
        NAME, variables, loader)


def test_float64_step_matches_jax(both):
    variables, want, (image, depth), _, _ = both
    check_step64(NAME, variables, want, image, depth)


def test_the_encoder_trains():
    trainer = ttr.Trainer(TrainConfig(model="mobilev3_large_newcrfs"),
                          device="cpu")
    state = trainer.init_state()
    assert not trainer.freeze_encoder
    n_opt = sum(len(g["params"]) for g in state.optimizer.param_groups)
    assert n_opt == len(list(build_model(NAME).parameters()))


@pytest.mark.parametrize("alias", aliases(NAME))
def test_trainer_recipe_frozen_encoder_and_val_loss_match_jax(both, alias):
    variables, _, _, loader, want = both
    check_trainer_switches(alias, NAME, variables, loader, want)
