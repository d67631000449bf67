"""GuideDepth's float64 train step against the JAX package's at batch 8
(``test_torch_port_train_step.py`` holds a batch of 2), alhashim recipe,
JAX unpacked, at ``torch_port_jax_steps.check_recorded64``'s tolerances.

- 96x128: the height is ragged at the DAPPM's 1/64 (1.5 rows), as NYU's
  480 rows are (7.5). The step agrees.
- 64x96: the forward, the moved statistics and the loss agree, but the
  gradients of the DAPPM's tensors (``feature_extractor.spp.*``) and of
  ``up_1`` differ from JAX's by up to 14 times the gradient tolerance. The
  step sits on a ReLU kink: moving the batch mean of one BatchNorm
  (``KINK_BN``) by 1e-8 of itself takes the port across it, and its
  gradients then equal JAX's at the tolerances; moving it the other way
  changes nothing. The JAX package's float64 step keeps float32 pieces
  (its BatchNorm moments, ``tpudepth/models/layers.py:337-338``, among
  them), whose rounding puts it on the other side. One kink can move
  them that much because the train-mode BatchNorms make the DAPPM's
  gradients small sums of large per-pixel terms. The data-parallel tests
  hold GuideDepth at 64x128 for this reason.
"""

import numpy as np
import pytest
import torch

from torch_port_helpers import torch_one_thread  # noqa: F401
from torch_port_jax_steps import (
    BRIDGE,
    MAX_DEPTH,
    batch,
    check_recorded64,
    jax_step64,
    random_variables,
)

from tpudepth_torch.models import layers
from tpudepth_torch.models.registry import build_model
from tpudepth_torch.train import trainer as ttr

BSZ = 8
KINK_HW = (64, 96)
RAGGED_HW = (96, 128)
# the BatchNorm whose batch mean, moved by KINK_SHIFT of itself, takes the
# 64x96 step across the ReLU kink
KINK_BN = "feature_extractor.layer3_.1.bn1"
KINK_SHIFT = 1e-8


def _case(hw):
    variables = random_variables("GuideDepth", 4, hw)
    image, depth = batch(31, bsz=BSZ, hw=hw)
    want = jax_step64("GuideDepth", variables, image, depth, kind="alhashim",
                      packed=False)
    return variables, image, depth, want


def _port_step(variables, image, depth, monkeypatch=None, shift=0.0):
    """The port's float64 step: NCHW prediction, moved statistics, loss and
    gradients; ``shift`` moves ``KINK_BN``'s batch mean by that much of
    itself."""
    model = build_model("GuideDepth")
    model.load_state_dict(BRIDGE["GuideDepth"][0](variables))
    model = model.double().train()
    if shift:
        moments = layers.BatchNorm._moments
        armed = []
        dict(model.named_modules())[KINK_BN].register_forward_pre_hook(
            lambda *_: armed.append(True))

        def shifted(xf, block):
            mean, mean2 = moments(xf, block)
            if armed:
                armed.clear()
                mean = mean * (1.0 + shift)
            return mean, mean2

        monkeypatch.setattr(layers.BatchNorm, "_moments",
                            staticmethod(shifted))
    recipe = ttr.LossRecipe(kind="alhashim", max_depth=MAX_DEPTH,
                            depth_scale=MAX_DEPTH)
    pred = model(torch.from_numpy(image).permute(0, 3, 1, 2).double())
    target = recipe.target(torch.from_numpy(depth).permute(0, 3, 1, 2))
    loss = recipe.loss(pred, target)
    loss.backward()
    if shift:
        monkeypatch.undo()
    stats = {k: v for k, v in model.state_dict().items()
             if k.endswith(("running_mean", "running_var"))}
    grads = {n: p.grad for n, p in model.named_parameters()}
    return pred.detach(), stats, loss.item(), grads


def _grad_gap(grads, want):
    """Per tensor, ``max |g - g_jax|`` over check_recorded64's tolerance."""
    gap = {}
    for n, g in grads.items():
        gw = want["grads"][n].numpy()
        gap[n] = (np.abs(g.numpy() - gw).max()
                  / max(1e-3 * np.abs(gw).max(), 1e-6))
    return gap


def test_guidedepth_step_with_a_ragged_dappm_height_matches_jax_at_batch_8():
    variables, image, depth, want = _case(RAGGED_HW)
    check_recorded64(want, *_port_step(variables, image, depth))


def test_guidedepth_step_at_64x96_batch_8_sits_on_a_relu_kink(monkeypatch):
    variables, image, depth, want = _case(KINK_HW)
    pred, stats, loss, grads = _port_step(variables, image, depth)
    # everything but the gradients agrees
    np.testing.assert_allclose(pred.permute(0, 2, 3, 1).numpy(), want["pred"],
                               rtol=1e-3, atol=1e-4)
    for k, v in stats.items():
        np.testing.assert_allclose(v.numpy(), want["stats"][k].numpy(),
                                   rtol=1e-3, atol=1e-4, err_msg=k)
    assert loss == pytest.approx(want["loss"], rel=1e-5)
    gap = _grad_gap(grads, want)
    worst = max(gap, key=gap.get)
    assert gap[worst] > 5.0 and worst.startswith(
        ("feature_extractor.spp.", "up_1.")), (worst, gap[worst])
    # across the kink the step is JAX's
    check_recorded64(want, *_port_step(variables, image, depth, monkeypatch,
                                       shift=-KINK_SHIFT))
    # the other way it stays where it was
    away = _grad_gap(_port_step(variables, image, depth, monkeypatch,
                                shift=KINK_SHIFT)[3], want)
    assert max(away.values()) > 5.0
