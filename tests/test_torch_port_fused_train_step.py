"""One train step of GuideDepth with fused GUB stages (``gub="fused"``)
against the port's own plain step (``gub="plain"``) on the same weights and
batch: loss, every gradient, the BatchNorm running statistics and the
parameters after Adam. The plain step is held against the JAX package by
``tests/test_torch_port_train_step.py``; on the CPU the fused stages run the
plain versions of their kernels under the same ``autograd.Function``.

At 2x96x128 the DAPPM's BatchNorms over 2 values make a float32 step
ill-conditioned (rounding differences grow 50-fold), so both models run in
float64: the kernels' plain versions carry float64 through, and only the loss
is float32, as in both trainers. What is left between the two steps is the
float32 rounding of a prediction that differs in its last float64 digits.
Tolerances: loss rel 1e-6; gradients 1e-6 of the GLOBAL gradient scale (conv
biases in front of a BatchNorm have a zero gradient and hold noise); running
statistics atol 1e-9; parameters after one Adam step (``-lr * g/(|g| +
eps)``): 1e-3 of ``lr`` where ``|g|`` is above twice the gradient tolerance,
``2 * lr`` below it, where the sign of a gradient that is noise may differ.
"""

import copy

import numpy as np
import pytest
import torch

from tpudepth_torch.core.config import TrainConfig
from tpudepth_torch.models.layers import init_random_
from tpudepth_torch.models.registry import build_model
from tpudepth_torch.train import trainer as ttr
from torch_port_helpers import torch_one_thread  # noqa: F401

LR = 1e-4
HW = (96, 128)


def _step(model, image, depth):
    model = model.double()
    cfg = TrainConfig(compute_dtype="float32", learning_rate=LR)
    state = ttr.TrainState(model, ttr.make_optimizer(cfg, model.parameters()))
    recipe = ttr.LossRecipe(kind="alhashim", max_depth=10.0, depth_scale=10.0)
    step = ttr.make_train_step(model, recipe, ttr.step_lr(LR, 15, 0.1, 10),
                               compute_dtype=torch.float64, augment=False)
    loss = step(state, torch.from_numpy(image), torch.from_numpy(depth))
    return {"loss": loss.item(),
            "grads": {n: p.grad.clone() for n, p in model.named_parameters()},
            "after": {k: v.clone() for k, v in model.state_dict().items()}}


@pytest.fixture(scope="module", params=["GuideDepth", "GuideDepth-S"])
def steps(request):
    rng = np.random.default_rng(5)
    image = rng.random((2, *HW, 3), dtype=np.float32)
    depth = rng.random((2, *HW, 1), dtype=np.float32) * 0.9 + 0.05
    depth[rng.random(depth.shape) < 0.05] = 0.0
    plain = init_random_(build_model(request.param, gub="plain"), seed=0)
    fused = build_model(request.param, gub="fused")
    fused.load_state_dict(plain.state_dict())
    before = copy.deepcopy(plain.state_dict())
    return _step(plain, image, depth), _step(fused, image, depth), before


def test_fused_step_loss_matches_the_plain_step(steps):
    plain, fused, _ = steps
    assert np.isfinite(plain["loss"])
    assert fused["loss"] == pytest.approx(plain["loss"], rel=1e-6)


def test_fused_step_gradients_match_the_plain_step(steps):
    plain, fused, _ = steps
    assert set(plain["grads"]) == set(fused["grads"])
    gscale = max(float(g.abs().max()) for g in plain["grads"].values())
    n_gub = 0
    for name, g in plain["grads"].items():
        d = float((fused["grads"][name] - g).abs().max()) / gscale
        assert d < 1e-6, (name, d)
        if name.startswith("up_") and float(g.abs().max()) > 1e-3 * gscale:
            n_gub += 1
    assert n_gub >= 20   # the GUB parameters carry real gradients


def test_fused_step_running_statistics_match_the_plain_step(steps):
    plain, fused, before = steps
    keys = [k for k in before if k.endswith(("running_mean", "running_var"))]
    moved = 0
    for k in keys:
        torch.testing.assert_close(fused["after"][k], plain["after"][k],
                                   atol=1e-9, rtol=0, msg=k)
        moved += int(not torch.equal(plain["after"][k].float(), before[k]))
    assert moved == len(keys)


def test_fused_step_parameters_after_adam_match_the_plain_step(steps):
    plain, fused, before = steps
    gscale = max(float(g.abs().max()) for g in plain["grads"].values())
    for name, g in plain["grads"].items():
        small = g.abs() <= 2e-6 * gscale
        diff = (fused["after"][name] - plain["after"][name]).abs()
        assert float(torch.where(small, 0.0, diff).max()) <= 1e-3 * LR, name
        assert float(diff.max()) <= 2 * LR * 1.001, name
        if float(g.abs().max()) > 1e-6 * gscale:
            moved = (plain["after"][name].float() - before[name]).abs().max()
            assert float(moved) > 0.5 * LR, name
